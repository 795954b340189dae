// The decode step's attention block in ONE launch:
//
//   out = [x +] Wo[layer] @ attend(rope(clip(Wqkv[layer] @ rmsnorm(x) * s + b)))
//
// Replaces yalm_tpu/ops/pallas/block.py:attn_block_l (:554; e5m2, int8, bf16
// or f32 weights with optional per-row scales) and :attn_block4_l (:365;
// packed int4 weights with group scales), both one Pallas kernel
// (_attn_block_kernel). The K/V row of the step is written into ring slot
// kv_pos of a bf16 or e5m2 cache IN PLACE, the first kv_sink rows are read
// through the lazy sink view in the ring regime, and the TP form
// (add_residual=False) returns Wo @ mix alone. The arithmetic is that of
// csrc/gemv.cu's gemv_kernel (both projections) and csrc/attention.cu's
// one-lane split (the attention): see their file comments.
//
// Bound on this card: bytes -- wqkv and wo once (41.9 MB at Mistral-7B's
// shapes in e5m2, 21.0 MB packed int4) and the K/V rows attended (4.1 MB at
// 1000 slots, bf16). Run as four launches (the wqkv GEMV, the split's two
// passes, the wo GEMV), each paid a launch's fixed cost and the host three
// wrapper calls, each split GEMV a last-block sum, and while the attention
// ran nothing streamed wo. What is left is latency: every phase is a chain
// of dependent L2 and HBM round trips (PERF.md section 6 has the timeline).
//
// The design: one cooperative, persistent grid of 256-thread blocks (as
// many as are co-resident, 2 per SM on the H100) walks the work items of
// four phases in order; an item waits for the items it reads, not for a
// grid-wide barrier:
//   A. the wqkv GEMV's (row block, K slice) items of
//      ops/cuda/gemv.py:gemv_plan, gemv_kernel's body at one row of x (the
//      weight loads issued before the rmsnorm prologue, mma.sync), each
//      slice's f32 partials to scratch; the last slice of each row block to
//      arrive (a counter) sums the slices in slice order, applies the
//      epilogue (scale, bias, clip) -- gemv_kernel's last block -- writes
//      the block's rows of qkv and releases them (a flag per row block).
//      A block that is done asks L2 for its share of the layer's wo rows
//      (prefetch.global.L2), the counterpart of the TPU kernel's wo prefetch
//      behind the last wqkv tile (block.py:111-115), and issues the first K
//      tiles of its pass-1 item.
//   B1. the (chunk, kv head) items of ops/cuda/attention.py:split_plan,
//      split_scores_kernel's body, each once its head's q rows (and, for the
//      chunk holding kv_pos, the new k and v rows) are released: the new
//      rows written first, then the chunk's scores and its max and sum; each
//      item counts itself done on its head (a counter per head). The block
//      then issues the first V tiles of its pass-2 item.
//   B2. the same items, split_values_kernel's body, each once every pass-1
//      item of its head is done; the last block of each kv head to arrive
//      sums the chunks' partial outputs in chunk order into `mix` (q_dim
//      f32) and releases the head.
//   C. the wo GEMV's items on x = mix, each once the heads whose columns it
//      reads are released -- at Mistral's shapes wo's 8 K slices (e5m2: 4
//      iterations of 128 columns; int4: one group of 512) are exactly the 8
//      kv heads' columns (qpk 4 x D 128), so slice h starts when head h is
//      summed; the last K slice of each row block to arrive sums the slices
//      in slice order and adds the residual.
// With the plans of the four launches, the items, their sums and the order
// of the sums are theirs, so the one launch gives the same bits: the output
// and the written cache row. A release is the writer's __threadfence(),
// __syncthreads() and one atomic; a wait is thread 0's ld.acquire loop and
// __syncthreads(); what another SM wrote in this launch (partials, qkv,
// maxima and sums, scores, mix) is read through L2 (ld.global.cg). Arrival
// counters wrap to 0 (atomicInc); the last block to finish puts the flags
// back to 0, so every call leaves them at 0 and a captured launch replays.
//
// No wait can deadlock: the cooperative launch is refused unless every
// block is co-resident, a block takes its items phase by phase, and an
// item waits only for items of earlier phases, which wait for nothing
// later. An item's body returns to its loop, never from the kernel, and
// the scalars are the host's, checked there (no device-side verdict to
// reach). A launch the card refuses is reported; nothing falls back to the
// four launches.
#include <algorithm>

#include "attention.cuh"
#include "gemv.cuh"

using namespace yt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(gemv::THREADS == THREADS && attn::THREADS == THREADS, "one block shape");

struct BlockArgs {
  const void* wqkv;        // (L, Nqkv, dim) of the weight type (int4: dim / 2 bytes)
  const void* wo;          // (L, dim, q_dim) (int4: q_dim / 2 bytes)
  const float* x;          // (dim,) the residual stream
  const float* norm_w;     // (L, dim)
  const float* scale_qkv;  // (L, Nqkv) per-row scales, or null
  const float* gs_qkv;     // (L, dim / group_qkv, Nqkv) int4 group scales, or null
  const float* bias;       // (L, Nqkv) or null
  const float* scale_o;    // (L, dim) per-row scales, or null
  const float* gs_o;       // (L, q_dim / group_o, dim) int4 group scales, or null
  void* k_all;             // (L, S, Hk, D) of the cache type T, updated in place
  void* v_all;
  const float* freq;       // (D / 2,) rope pair frequencies
  float* out;              // (dim,)
  float* qkv_part;         // (wqkv row blocks, split_a, 256) float4: its slices' partials
  float* qkv;              // (Nqkv,) rope's input: the slices' sum and the epilogue
  float* scores;           // (Hk, kv_len, qpk)
  float* ml;               // (Hk, nsplit, qpk, 2): each chunk's max and sum
  float* att_part;         // (Hk, nsplit, qpk, D): each chunk's partial output
  float* mix;              // (q_dim,) = (Hk, qpk, D): the attention's output
  float* wo_part;          // (wo row blocks, split_c, 256) float4
  unsigned* head_ctr;      // (Hk,) pass-2 arrivals, 0 between calls
  unsigned* row_ctr;       // (wo row blocks,) wo slice arrivals, 0 between calls
  unsigned* qkv_ctr;       // (wqkv row blocks,) wqkv slice arrivals, 0 between calls
  unsigned* qkv_done;      // (wqkv row blocks,) 1: the block's rows of qkv are written
  unsigned* pass1_done;    // (Hk,) pass-1 items of the head done
  unsigned* mix_done;      // (Hk,) 1: the head's columns of mix are written
  unsigned* exits;         // blocks done; the last resets the three flags above to 0
  unsigned long long* stamps;  // (grid, 8) %globaltimer at the phase bounds, or null
  float eps, clip;         // clip <= 0: none
  float mscale, inv_sqrt_d;
  int residual;            // 1: out = x + Wo @ mix
  int layer, dim, Nqkv, q_dim, S, Hk, qpk, D, kv_pos, kv_len, kv_sink, pos;
  int group_qkv, group_o;  // int4 group widths (0 for other weights)
  int kchunk_a, split_a;   // wqkv's gemv_plan
  int kchunk_c, split_c;   // wo's gemv_plan
  int chunk, nsplit;       // the attention's split_plan (from slot 0, no window)
};

// One (row block, K slice) item of a GEMV over layer `layer` of an (L, N,
// K) stack: gemv_kernel's body at one row of x without GLU -- the same loads,
// the same fragments, the same mma sequence -- its f32 partials stored to
// `part` (256 float4 in the threads' order). kNorm: the rmsnorm prologue
// against nw; kL2: x was written in this launch and is read through L2.
template <int WT, bool kNorm, bool kL2>
__device__ __forceinline__ void gemv_slice(const void* wall, const float* gsall, int layer, int N,
                                           int K, int group, const float* x, const float* nw,
                                           float eps, int kchunk, int blk, int z,
                                           __nv_bfloat16* xs, float4* part) {
  using LY = gemv::Layout<WT>;
  using gemv::DEPTH;
  using gemv::WIN;
  constexpr bool I4 = LY::I4;
  constexpr int COLS = LY::COLS;
  __shared__ float red[WARPS];
  __shared__ float rs;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  const size_t rb = LY::row_bytes(K);
  const int nit = (int)((rb + WIN - 1) / WIN), it0 = z * kchunk;
  const int n = min(nit, it0 + kchunk) - it0;  // this slice's iterations (>= 1)

  // the weight stream starts first: DEPTH iterations in flight before the prologue
  bool ok0, ok1;
  const int r0 = gemv::tile_row<false>(blk, w, g, 0, N, &ok0);
  const int r1 = gemv::tile_row<false>(blk, w, g, 1, N, &ok1);
  const uint8_t* wl = static_cast<const uint8_t*>(wall) + (size_t)layer * N * rb;
  const uint8_t* w0 = wl + (size_t)(ok0 ? r0 : 0) * rb + 16 * t;
  const uint8_t* w1 = wl + (size_t)(ok1 ? r1 : 0) * rb + 16 * t;
  const long long lim = (long long)rb - 16 * t;
  const float* gs = I4 ? gsall + (size_t)layer * (K / group) * N : nullptr;
  const float* gs0 = I4 ? gs + (ok0 ? r0 : 0) : nullptr;
  const float* gs1 = I4 ? gs + (ok1 ? r1 : 0) : nullptr;
  uint4 ring[DEPTH][4];
  float sring[DEPTH][2];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (d < n)
      gemv::load_iter<WT>(ring[d], sring[d], w0, w1, ok0, ok1, lim, it0 + d, gs0, gs1, N, group);

  // prologue: the rmsnorm's sum of squares over all of K, then this slice's
  // columns of x, normalised and rounded to bf16 (zeros past K)
  const float4* x4 = reinterpret_cast<const float4*>(x);
  if (kNorm) {
    float ss = 0.f;
    for (int k = tid; k < K / 4; k += THREADS) {
      const float4 v = x4[k];
      ss = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, ss))));
    }
    ss = warp_sum(ss);
    if (lane == 0) red[w] = ss;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) tot += red[i];
      rs = 1.0f / sqrtf(tot / (float)K + eps);
    }
    __syncthreads();
  }
  {
    const int c0 = it0 * COLS, q4 = n * COLS / 4;
    const float4* nw4 = reinterpret_cast<const float4*>(nw);
    for (int j = tid; j < q4; j += THREADS) {
      const int c = c0 + 4 * j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < K) {
        v = kL2 ? __ldcg(x4 + c / 4) : x4[c / 4];
        if (kNorm) {
          const float s = rs;
          const float4 m = nw4[c / 4];
          v = make_float4(v.x * s * m.x, v.y * s * m.y, v.z * s * m.z, v.w * s * m.w);
        }
      }
      *reinterpret_cast<uint2*>(xs + 4 * j) =
          make_uint2(gemv::pack_bf16(v.x, v.y), gemv::pack_bf16(v.z, v.w));
    }
  }
  __syncthreads();

  // the stream: each iteration's fragments, mma, then the load DEPTH ahead
  const bool live = g == 0;  // column g of the mma is x row g: one row here
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float gacc[4] = {0.f, 0.f, 0.f, 0.f};
  const int ipg = I4 ? group / (2 * WIN) : 1;
  for (int i0 = 0; i0 < n; i0 += DEPTH) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int i = i0 + d;
      if (i >= n) break;
      if constexpr (I4) {
        const int lg = i / ipg, gb = (i - lg * ipg) * WIN;
        if (gb == 0) gacc[0] = gacc[1] = gacc[2] = gacc[3] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = lg * group + gb + 64 * h + 16 * t;
          uint32_t xlo[8], xhi[8], lo0[8], hi0[8], lo1[8], hi1[8];
          gemv::load_x<16>(xs + col, live, xlo);
          gemv::load_x<16>(xs + col + group / 2, live, xhi);
          const uint32_t u0[4] = {ring[d][h].x, ring[d][h].y, ring[d][h].z, ring[d][h].w};
          const uint32_t u1[4] = {ring[d][2 + h].x, ring[d][2 + h].y, ring[d][2 + h].z,
                                  ring[d][2 + h].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            gemv::i4_quad(u0[q], lo0 + 2 * q, hi0 + 2 * q);
            gemv::i4_quad(u1[q], lo1 + 2 * q, hi1 + 2 * q);
          }
#pragma unroll
          for (int s = 0; s < 8; ++s)
            gemv::mma16816(gacc, lo0[s], lo1[s], hi0[s], hi1[s], xlo[s], xhi[s]);
        }
        if (gb + WIN == group / 2) {
          acc[0] = fmaf(gacc[0], sring[d][0], acc[0]);
          acc[1] = fmaf(gacc[1], sring[d][0], acc[1]);
          acc[2] = fmaf(gacc[2], sring[d][1], acc[2]);
          acc[3] = fmaf(gacc[3], sring[d][1], acc[3]);
        }
      } else {
        constexpr int PER = gemv::Widen<WT>::PER;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t p0[PER / 2], p1[PER / 2], xb[PER / 2];
          gemv::Widen<WT>::pairs(ring[d][h], p0);
          gemv::Widen<WT>::pairs(ring[d][2 + h], p1);
          gemv::load_x<PER>(xs + i * COLS + h * (COLS / 2) + t * PER, live, xb);
#pragma unroll
          for (int s = 0; s < PER / 4; ++s)
            gemv::mma16816(acc, p0[2 * s], p1[2 * s], p0[2 * s + 1], p1[2 * s + 1], xb[2 * s],
                           xb[2 * s + 1]);
        }
      }
      if (i + DEPTH < n)
        gemv::load_iter<WT>(ring[d], sring[d], w0, w1, ok0, ok1, lim, it0 + i + DEPTH, gs0, gs1,
                            N, group);
    }
  }
  __stcg(part + tid, make_float4(acc[0], acc[1], acc[2], acc[3]));
}

// The wqkv item (blk, z) after its partials are stored: the last slice of
// the row block to arrive sums the slices in slice order, writes rope's
// input rows with the epilogue (gemv_kernel's last block: scale, bias,
// clip), so the attention reads each row once, and releases them.
__device__ __forceinline__ void qkv_finish(const BlockArgs& a, int blk) {
  __shared__ int last;
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicInc(a.qkv_ctr + blk, a.split_a - 1) == (unsigned)(a.split_a - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float4* part =
      reinterpret_cast<const float4*>(a.qkv_part) + (size_t)blk * a.split_a * THREADS;
  float4 v = __ldcg(part + tid);
  for (int z = 1; z < a.split_a; ++z) {
    const float4 u = __ldcg(part + (size_t)z * THREADS + tid);
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  if (t == 0) {  // column 2t of the mma is x's one row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bool ok;
      const int r = gemv::tile_row<false>(blk, w, g, h, a.Nqkv, &ok);
      if (!ok) continue;
      const size_t row = (size_t)a.layer * a.Nqkv + r;
      float y = h ? v.z : v.x;
      if (a.scale_qkv) y = __fmul_rn(y, a.scale_qkv[row]);
      if (a.bias) y = __fadd_rn(y, a.bias[row]);
      if (a.clip > 0.f) y = fminf(fmaxf(y, -a.clip), a.clip);
      a.qkv[r] = y;
    }
  }
  release(a.qkv_done + blk);
}

__device__ __forceinline__ float qkv_row(const BlockArgs& a, int n) { return __ldcg(a.qkv + n); }

// The shared-memory tiles of the split's two passes (their layouts below).
template <typename T>
__device__ __forceinline__ T* k_tiles(const BlockArgs& a, unsigned char* smem) {
  using namespace attn;
  const int RS = a.D + KPAD;
  return reinterpret_cast<T*>(smem + align16((size_t)a.qpk * RS * 2) +
                              align16((size_t)a.kv_sink * RS * 2));
}
template <typename T>
__device__ __forceinline__ T* v_tiles(const BlockArgs& a, unsigned char* smem) {
  using namespace attn;
  return reinterpret_cast<T*>(smem + align16(2 * a.qpk * 4) +
                              align16((size_t)TILE * a.qpk * 4) + THREADS * 8 * 4);
}

// The first two K (kV = false) or V tiles of chunk ci of kv head h, the
// loads a pass issues first (issued here before the pass's inputs are ready).
template <typename T, bool kV>
__device__ __forceinline__ void first_tiles(const BlockArgs& a, int ci, int h,
                                            unsigned char* smem) {
  using namespace attn;
  const int D = a.D, c0 = ci * a.chunk, c1 = min(c0 + a.chunk, a.kv_len);
  const size_t stride = (size_t)a.Hk * D, head = ((size_t)a.layer * a.S * a.Hk + h) * D;
  const T* all = static_cast<const T*>(kV ? a.v_all : a.k_all) + head;
  T* tiles = kV ? v_tiles<T>(a, smem) : k_tiles<T>(a, smem);
  const int tile_elems = (int)(align16((size_t)TILE * (D + KPAD) * sizeof(T)) / sizeof(T));
  load_tile(tiles, all, stride, c0, min(TILE, c1 - c0), D);
  if (c1 - c0 > TILE)
    load_tile(tiles + tile_elems, all, stride, c0 + TILE, min(TILE, c1 - c0 - TILE), D);
}

// Pass 1 of chunk ci of kv head h: split_scores_kernel's body (no window,
// no cap), q, k_new and v_new from qkv_row. pre: the first K tiles are in
// flight already (first_tiles).
template <typename T>
__device__ __forceinline__ void scores_item(const BlockArgs& a, int ci, int h,
                                            unsigned char* smem, bool pre) {
  using namespace attn;
  const int D = a.D, qpk = a.qpk, half = D / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, RS = D + KPAD;
  const int n = a.kv_len, S = a.S;
  const int c0 = ci * a.chunk, c1 = min(c0 + a.chunk, n);
  const size_t stride = (size_t)a.Hk * D;
  T* k_all = static_cast<T*>(a.k_all);
  T* v_all = static_cast<T*>(a.v_all);
  const size_t head = ((size_t)a.layer * S * a.Hk + h) * D;
  const float posf = (float)a.pos;

  const int writer = a.kv_pos < n ? a.kv_pos / a.chunk : 0;
  if (ci == writer) {  // the new rows, before this block reads its chunk
    const size_t new_row = head + (size_t)a.kv_pos * stride;
    const int kn = a.q_dim + h * D, vn = a.q_dim + (a.Hk + h) * D;
    for (int p = tid; p < half; p += THREADS) {
      const float ang = posf * a.freq[p];
      const float c = a.mscale * cosf(ang), s = a.mscale * sinf(ang);
      const float x0 = qkv_row(a, kn + 2 * p), x1 = qkv_row(a, kn + 2 * p + 1);
      k_all[new_row + 2 * p] = KV<T>::from_float(rot_re(x0, x1, c, s));
      k_all[new_row + 2 * p + 1] = KV<T>::from_float(rot_im(x0, x1, c, s));
    }
    for (int d = tid; d < D; d += THREADS)
      v_all[new_row + d] = KV<T>::from_float(qkv_row(a, vn + d));
    __syncthreads();
  }

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // (qpk, RS)
  const int nsink = c0 == 0 ? a.kv_sink : 0;
  __nv_bfloat16* sinks = reinterpret_cast<__nv_bfloat16*>(smem + align16((size_t)qpk * RS * 2));
  T* tiles = k_tiles<T>(a, smem);
  const int tile_elems = (int)(align16((size_t)TILE * RS * sizeof(T)) / sizeof(T));
  const int ntiles = (c1 - c0 + TILE - 1) / TILE;
  if (!pre) first_tiles<T, false>(a, ci, h, smem);

  // q, roped and scaled, rounded to bf16
  const int q0 = h * qpk * D;
  for (int i = tid; i < qpk * half; i += THREADS) {
    const int j = i / half, p = i - j * half;
    const float ang = posf * a.freq[p];
    const float c = a.mscale * cosf(ang), s = a.mscale * sinf(ang);
    const float x0 = qkv_row(a, q0 + j * D + 2 * p), x1 = qkv_row(a, q0 + j * D + 2 * p + 1);
    qs[j * RS + 2 * p] = __float2bfloat16_rn(__fmul_rn(rot_re(x0, x1, c, s), a.inv_sqrt_d));
    qs[j * RS + 2 * p + 1] = __float2bfloat16_rn(__fmul_rn(rot_im(x0, x1, c, s), a.inv_sqrt_d));
  }
  // the lazy sink view, from the cache (no sink row is the one written)
  const float rot = (float)max(0, a.pos - S + 1);
  for (int i = tid; i < nsink * half; i += THREADS) {
    const int r = i / half, p = i - r * half;
    const float ang = rot * a.freq[p];
    const float c = cosf(ang), s = sinf(ang);
    const T* kr = k_all + head + (size_t)r * stride;
    const float x0 = KV<T>::widen1(kr[2 * p]), x1 = KV<T>::widen1(kr[2 * p + 1]);
    sinks[r * RS + 2 * p] = __float2bfloat16_rn(rot_re(x0, x1, c, s));
    sinks[r * RS + 2 * p + 1] = __float2bfloat16_rn(rot_im(x0, x1, c, s));
  }

  // the chunk's scores, one (slot, query) dot per thread
  float* sc = a.scores + (size_t)h * n * qpk;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int t0 = c0 + t * TILE, nt = min(TILE, c1 - t0);
    const T* tile = tiles + (t & 1) * tile_elems;
    for (int i = tid; i < nt * qpk; i += THREADS) {
      const int r = i / qpk, j = i - r * qpk, s = t0 + r;
      sc[(size_t)s * qpk + j] = s < nsink ? dot_row(sinks + s * RS, qs + j * RS, D)
                                          : dot_row(tile + r * RS, qs + j * RS, D);
    }
    __syncthreads();
    if (t + 2 < ntiles)
      load_tile(tiles + (t & 1) * tile_elems, k_all + head, stride, t0 + 2 * TILE,
                min(TILE, c1 - t0 - 2 * TILE), D);
  }

  // m_c and l_c per query, one warp each (this block wrote these scores)
  float* ml = a.ml + ((size_t)h * a.nsplit + ci) * qpk * 2;
  for (int j = warp; j < qpk; j += WARPS) {
    float m = -INFINITY;
    for (int r = c0 + lane; r < c1; r += 32) m = fmaxf(m, sc[(size_t)r * qpk + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = c0 + lane; r < c1; r += 32) l += expf(sc[(size_t)r * qpk + j] - m);
    l = warp_sum(l);
    if (lane == 0) {
      ml[2 * j] = m;
      ml[2 * j + 1] = l;
    }
  }
}

// Pass 2 of chunk ci of kv head h: split_values_kernel's body; the head's
// last block to arrive sums the partials in chunk order into mix.
template <typename T>
__device__ __forceinline__ void values_item(const BlockArgs& a, int ci, int h,
                                            unsigned char* smem, bool pre) {
  using namespace attn;
  __shared__ int last;
  const int D = a.D, qpk = a.qpk, nsplit = a.nsplit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, RS = D + KPAD;
  const int n = a.kv_len, nout = qpk * D;
  const int c0 = ci * a.chunk, c1 = min(c0 + a.chunk, n);
  const size_t stride = (size_t)a.Hk * D;
  const T* v_all = static_cast<const T*>(a.v_all);
  const size_t head = ((size_t)a.layer * a.S * a.Hk + h) * D;
  const float* mlh = a.ml + (size_t)h * nsplit * qpk * 2;
  float* part = a.att_part + ((size_t)h * nsplit + ci) * nout;
  const int G = nout / 8, R = THREADS / G, g = tid % G, sl = tid / G;
  const int j = 8 * g / D, d0 = 8 * g - j * D;
  float* ms = reinterpret_cast<float*>(smem);
  float* ps = reinterpret_cast<float*>(smem + align16(2 * qpk * 4));
  float* red = ps + align16((size_t)TILE * qpk * 4) / 4;
  T* tiles = v_tiles<T>(a, smem);
  const int tile_elems = (int)(align16((size_t)TILE * RS * sizeof(T)) / sizeof(T));

  const int ntiles = (c1 - c0 + TILE - 1) / TILE;
  if (!pre) first_tiles<T, true>(a, ci, h, smem);
  // m and l over the head's chunks, the same order in every block
  for (int jj = warp; jj < qpk; jj += WARPS) {
    float m = -INFINITY;
    for (int c = lane; c < nsplit; c += 32) m = fmaxf(m, __ldcg(mlh + (c * qpk + jj) * 2));
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < nsplit; c += 32) {
      const float* e = mlh + (c * qpk + jj) * 2;
      l = fmaf(__ldcg(e + 1), expf(__ldcg(e) - m), l);
    }
    l = warp_sum(l);
    if (lane == 0) {
      ms[jj] = m;
      ms[qpk + jj] = l;
    }
  }
  const float* sc = a.scores + (size_t)h * n * qpk;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = c0 + t * TILE, nt = min(TILE, c1 - t0);
    __syncthreads();  // m and l are in; the last tile's p is no longer read
    const float* st = sc + (size_t)t0 * qpk;
    for (int i = tid; i < nt * qpk; i += THREADS) {
      const int jj = i % qpk;
      ps[i] = bf16_round(__fdiv_rn(expf(__ldcg(st + i) - ms[jj]), ms[qpk + jj]));
    }
    if (t + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const T* tile = tiles + (t & 1) * tile_elems;
    if (sl < R) {
      for (int r = sl; r < nt; r += R) {
        float vf[8];
        KV<T>::widen8(tile + r * RS + d0, vf);
        const float p = ps[r * qpk + j];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(p, vf[k], acc[k]);
      }
    }
    __syncthreads();
    if (t + 2 < ntiles)
      load_tile(tiles + (t & 1) * tile_elems, v_all + head, stride, t0 + 2 * TILE,
                min(TILE, c1 - t0 - 2 * TILE), D);
  }
  if (sl < R)
#pragma unroll
    for (int k = 0; k < 8; ++k) red[(sl * G + g) * 8 + k] = acc[k];
  __syncthreads();
  for (int i = tid; i < nout; i += THREADS) {  // the row slices, in order
    const int gi = i / 8, k = i - gi * 8;
    float o = 0.f;
    for (int s = 0; s < R; ++s) o += red[(s * G + gi) * 8 + k];
    part[i] = o;
  }

  // the head's last block to arrive sums the partials in chunk order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicInc(a.head_ctr + h, nsplit - 1u) == nsplit - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* parts = a.att_part + (size_t)h * nsplit * nout;
  float* out = a.mix + (size_t)h * nout;
  for (int i = 4 * tid; i < nout; i += 4 * THREADS) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < nsplit; ++c) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(parts + (size_t)c * nout + i));
      o.x += p.x;
      o.y += p.y;
      o.z += p.z;
      o.w += p.w;
    }
    *reinterpret_cast<float4*>(out + i) = o;
  }
  release(a.mix_done + h);
}

// The wo slice item (blk, z) after its partials are stored: the last slice
// of the row block to arrive sums the slices in slice order and writes the
// rows (gemv_kernel's last block and epilogue: the scale, then the residual).
__device__ __forceinline__ void wo_finish(const BlockArgs& a, int blk) {
  __shared__ int last;
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicInc(a.row_ctr + blk, a.split_c - 1) == (unsigned)(a.split_c - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float4* part =
      reinterpret_cast<const float4*>(a.wo_part) + (size_t)blk * a.split_c * THREADS;
  float4 v = __ldcg(part + tid);
  for (int z = 1; z < a.split_c; ++z) {
    const float4 u = __ldcg(part + (size_t)z * THREADS + tid);
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  if (t != 0) return;  // column 2t of the mma is x's one row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bool ok;
    const int r = gemv::tile_row<false>(blk, w, g, h, a.dim, &ok);
    if (!ok) continue;
    float y = h ? v.z : v.x;
    if (a.scale_o) y = __fmul_rn(y, a.scale_o[(size_t)a.layer * a.dim + r]);
    if (a.residual) y = __fadd_rn(y, a.x[r]);
    a.out[r] = y;
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Stamp k of this block (ns, the card's global timer), when asked for:
// 0 entry, 1 phase A's items done, 2 its first B1 item's inputs ready, 3
// its B1 items done, 4 its first B2 item's inputs ready, 5 B2 done, 6 its
// first C item's inputs ready, 7 C done.
__device__ __forceinline__ void stamp(const BlockArgs& a, int k) {
  if (a.stamps && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[blockIdx.x * 8 + k] = t;
  }
}

// Thread 0 waits for the wqkv row blocks that hold rows [lo, lo + n).
__device__ __forceinline__ void wait_rows(const BlockArgs& a, int lo, int n) {
  for (int rb = lo / gemv::ROWS; rb <= (lo + n - 1) / gemv::ROWS; ++rb)
    wait_flag(a.qkv_done + rb, 1);
}

template <int WT, typename T>
__global__ void __launch_bounds__(THREADS, 2) attn_block_kernel(BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  using LY = gemv::Layout<WT>;
  const int rows_a = (a.Nqkv + gemv::ROWS - 1) / gemv::ROWS;
  const int rows_c = (a.dim + gemv::ROWS - 1) / gemv::ROWS;
  const int items_b = a.nsplit * a.Hk, qd = a.qpk * a.D;
  // block b's one item of each attention pass (the same b for both), whose
  // first tiles it may load before that pass's inputs are ready
  const bool one_b = items_b <= (int)gridDim.x && (int)blockIdx.x < items_b;
  const int writer = a.kv_pos < a.kv_len ? a.kv_pos / a.chunk : 0;
  const bool pre_k = one_b && (int)blockIdx.x % a.nsplit != writer;
  stamp(a, 0);

  // A: the wqkv GEMV's slices; the last slice of each row block to arrive
  // writes the block's rows of qkv and releases them
  for (int it = blockIdx.x; it < rows_a * a.split_a; it += gridDim.x) {
    const int blk = it / a.split_a, z = it - blk * a.split_a;
    gemv_slice<WT, true, false>(a.wqkv, a.gs_qkv, a.layer, a.Nqkv, a.dim, a.group_qkv, a.x,
                                a.norm_w + (size_t)a.layer * a.dim, a.eps, a.kchunk_a, blk, z, xs,
                                reinterpret_cast<float4*>(a.qkv_part) + (size_t)it * THREADS);
    qkv_finish(a, blk);
    __syncthreads();
  }
  stamp(a, 1);
  // wo's stream starts: this block's share of the layer's wo rows into L2
  // (under phase A's tail and the attention: the counterpart of the TPU
  // kernel's wo prefetch behind the last wqkv tile)
  {
    const size_t bytes = (size_t)a.dim * LY::row_bytes(a.q_dim);
    const uint8_t* wo = static_cast<const uint8_t*>(a.wo) + (size_t)a.layer * bytes;
    const size_t per = ((bytes + gridDim.x - 1) / gridDim.x + 127) & ~(size_t)127;
    const size_t stop = (size_t)(blockIdx.x + 1) * per, end = stop < bytes ? stop : bytes;
    for (size_t o = blockIdx.x * per + (size_t)threadIdx.x * 128; o < end; o += THREADS * 128)
      prefetch_l2(wo + o);
  }
  // pass 1's first K tiles, unless this chunk holds the row to be written
  if (pre_k) first_tiles<T, false>(a, blockIdx.x % a.nsplit, blockIdx.x / a.nsplit, smem);

  // B1: pass 1 of (chunk, kv head) items, each once the rows of qkv it
  // reads are written: q's, and the new k and v rows for the chunk that
  // writes them
  for (int it = blockIdx.x; it < items_b; it += gridDim.x) {
    const int ci = it % a.nsplit, h = it / a.nsplit;
    if (threadIdx.x == 0) {
      wait_rows(a, h * qd, qd);
      if (ci == writer) {
        wait_rows(a, a.q_dim + h * a.D, a.D);
        wait_rows(a, a.q_dim + (a.Hk + h) * a.D, a.D);
      }
    }
    __syncthreads();
    if (it == (int)blockIdx.x) stamp(a, 2);
    scores_item<T>(a, ci, h, smem, pre_k && it == (int)blockIdx.x);
    release(a.pass1_done + h);
  }
  stamp(a, 3);
  // pass 2's first V tiles (this block wrote any new row they hold)
  if (one_b) first_tiles<T, true>(a, blockIdx.x % a.nsplit, blockIdx.x / a.nsplit, smem);

  // B2: pass 2, each item once every pass-1 item of its head is done; the
  // head's last item writes its columns of mix and releases them
  for (int it = blockIdx.x; it < items_b; it += gridDim.x) {
    const int ci = it % a.nsplit, h = it / a.nsplit;
    wait_flag(a.pass1_done + h, a.nsplit);
    __syncthreads();
    if (it == (int)blockIdx.x) stamp(a, 4);
    values_item<T>(a, ci, h, smem, one_b && it == (int)blockIdx.x);
    __syncthreads();
  }
  stamp(a, 5);

  // C: the wo GEMV's slices, each once the heads whose columns of mix it
  // reads are written (at Mistral's shapes slice z is head z's); the last of
  // each row block to arrive sums them
  const int cols = a.kchunk_c * LY::COLS;
  for (int it = blockIdx.x; it < rows_c * a.split_c; it += gridDim.x) {
    const int blk = it / a.split_c, z = it - blk * a.split_c;
    const int c0 = z * cols, c1 = min(a.q_dim, c0 + cols);
    if (threadIdx.x == 0)
      for (int hh = c0 / qd; hh <= (c1 - 1) / qd; ++hh) wait_flag(a.mix_done + hh, 1);
    __syncthreads();
    if (it == (int)blockIdx.x) stamp(a, 6);
    gemv_slice<WT, false, true>(a.wo, a.gs_o, a.layer, a.dim, a.q_dim, a.group_o, a.mix, nullptr,
                                0.f, a.kchunk_c, blk, z, xs,
                                reinterpret_cast<float4*>(a.wo_part) + (size_t)it * THREADS);
    wo_finish(a, blk);
    __syncthreads();
  }
  stamp(a, 7);

  // the last block out: every block is past every wait, so the flags go
  // back to 0 for the next call (a graph's replay included)
  if (threadIdx.x == 0 && atomicInc(a.exits, gridDim.x - 1) == gridDim.x - 1) {
    for (int i = 0; i < rows_a; ++i) a.qkv_done[i] = 0;
    for (int i = 0; i < a.Hk; ++i) a.pass1_done[i] = a.mix_done[i] = 0;
    __threadfence();
  }
}

// Dynamic shared memory: the larger phase's (a GEMV slice's staged x, pass
// 1's q, sink view and K tiles, pass 2's p, sums and V tiles).
template <int WT>
size_t block_smem(const BlockArgs& a, int kv_sinks, size_t elem) {
  constexpr int COLS = gemv::Layout<WT>::COLS;
  const size_t xa = (size_t)(a.kchunk_a * COLS + gemv::XPAD) * 2;
  const size_t xc = (size_t)(a.kchunk_c * COLS + gemv::XPAD) * 2;
  return std::max(std::max(xa, xc), std::max(attn::scores_smem(a.qpk, a.D, kv_sinks, elem),
                                             attn::values_smem(a.qpk, a.D, elem)));
}

template <int WT, typename T>
int launch_block(const BlockArgs& a, int kv_sinks, int grid, cudaStream_t st) {
  const size_t smem = block_smem<WT>(a, kv_sinks, sizeof(T));
  if (smem > attn::SMEM_MAX) return ERR_ARGS;
  return launch_cooperative<attn_block_kernel<WT, T>>(a, smem, grid, THREADS, st);
}

template <int WT>
int launch_wt(int kv_type, const BlockArgs& a, int kv_sinks, int grid, cudaStream_t st) {
  if (kv_type == W_BF16) return launch_block<WT, __nv_bfloat16>(a, kv_sinks, grid, st);
  if (kv_type == W_E5M2) return launch_block<WT, uint8_t>(a, kv_sinks, grid, st);
  return ERR_ARGS;
}

}  // namespace

// attn_block_l / attn_block4_l in one cooperative launch (the file
// comment). The wrapper (ops/cuda/block.py) checks types, shapes,
// contiguity and alignment, and lays out the scratch (block_plan): the
// region pointers below in block.py's REGIONS order, each 16-byte aligned,
// and counters (arrivals: Hk, wo's row blocks, wqkv's row blocks; flags:
// wqkv's row blocks, Hk, Hk; one exit count) uint32 zeros, left at 0
// again. wtype: the weight type of both projections (W_I4: gs_* are
// the group scales, scale_* null); kv_type: W_BF16 or W_E5M2. The plans:
// wqkv's and wo's gemv_plan (kchunk, split), the attention's split_plan
// (chunk, nsplit; from slot 0, no skip). grid: the blocks asked for (no
// more than fit on the card are launched). stamps: null, or (grid, 8)
// uint64 for the phase bounds' times (stamp()). Returns 0, a cudaError_t
// (cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident),
// or ERR_ARGS.
extern "C" int yt_attn_block(int wtype, int kv_type, const void* wqkv, const void* wo,
                             const float* x, const float* norm_w, float eps,
                             const float* scale_qkv, const float* gs_qkv, int group_qkv,
                             const float* bias, float clip, const float* scale_o,
                             const float* gs_o, int group_o, void* k_all, void* v_all,
                             const float* freq, float mscale, float inv_sqrt_d, float* out,
                             int residual, float* qkv_part, float* qkv, float* wo_part,
                             float* mix, float* att_part, float* ml, float* scores,
                             unsigned* counters,
                             unsigned long long* stamps,
                             int L, int layer, int dim, int S, int Hk, int qpk, int D,
                             int kv_pos, int kv_len, int kv_sink, int pos, int kv_sinks,
                             int kchunk_a, int split_a, int kchunk_c, int split_c, int chunk,
                             int nsplit, int grid, void* stream) {
  const int q_dim = Hk * qpk * D, Nqkv = q_dim + 2 * Hk * D;
  const bool i4 = wtype == W_I4;
  if (wtype < W_F32 || wtype > W_I4 || D < 8 || D % 8 || qpk < 1 ||
      qpk * D > THREADS * attn::MAX_OUT || Hk < 1 || L < 1 || layer < 0 || layer >= L || S < 1 ||
      kv_sinks < 0 || kv_sinks > attn::TILE || kv_len < 1 || kv_len > S || kv_pos < 0 ||
      kv_pos >= S || kv_sink < 0 || kv_sink > kv_sinks || dim < 4 || dim % 4 || grid < 1 ||
      (residual != 0 && residual != 1) || !(clip >= 0.f))
    return ERR_ARGS;
  if (!wqkv || !wo || !x || !norm_w || !k_all || !v_all || !freq || !out || !qkv_part || !qkv ||
      !scores || !ml || !att_part || !mix || !wo_part || !counters ||
      (i4 && (!gs_qkv || !gs_o || scale_qkv || scale_o)) || (!i4 && (gs_qkv || gs_o)))
    return ERR_ARGS;
  if (!gemv::plan_ok(wtype, dim, group_qkv, kchunk_a, split_a) ||
      !gemv::plan_ok(wtype, q_dim, group_o, kchunk_c, split_c) || chunk < attn::TILE ||
      chunk % attn::TILE || nsplit < 1 || nsplit > attn::MAX_SPLIT ||
      (long long)(nsplit - 1) * chunk >= kv_len || (long long)nsplit * chunk < kv_len)
    return ERR_ARGS;
  BlockArgs a{};
  a.wqkv = wqkv;
  a.wo = wo;
  a.x = x;
  a.norm_w = norm_w;
  a.scale_qkv = scale_qkv;
  a.gs_qkv = gs_qkv;
  a.bias = bias;
  a.scale_o = scale_o;
  a.gs_o = gs_o;
  a.k_all = k_all;
  a.v_all = v_all;
  a.freq = freq;
  a.out = out;
  a.qkv_part = qkv_part;
  a.qkv = qkv;
  a.scores = scores;
  a.ml = ml;
  a.att_part = att_part;
  a.mix = mix;
  a.wo_part = wo_part;
  a.head_ctr = counters;
  a.row_ctr = counters + Hk;
  const int rows_a = (Nqkv + gemv::ROWS - 1) / gemv::ROWS;
  a.qkv_ctr = counters + Hk + (dim + gemv::ROWS - 1) / gemv::ROWS;
  a.qkv_done = a.qkv_ctr + rows_a;
  a.pass1_done = a.qkv_done + rows_a;
  a.mix_done = a.pass1_done + Hk;
  a.exits = a.mix_done + Hk;
  a.stamps = stamps;
  a.eps = eps;
  a.clip = clip;
  a.mscale = mscale;
  a.inv_sqrt_d = inv_sqrt_d;
  a.residual = residual;
  a.layer = layer;
  a.dim = dim;
  a.Nqkv = Nqkv;
  a.q_dim = q_dim;
  a.S = S;
  a.Hk = Hk;
  a.qpk = qpk;
  a.D = D;
  a.kv_pos = kv_pos;
  a.kv_len = kv_len;
  a.kv_sink = kv_sink;
  a.pos = pos;
  a.group_qkv = group_qkv;
  a.group_o = group_o;
  a.kchunk_a = kchunk_a;
  a.split_a = split_a;
  a.kchunk_c = kchunk_c;
  a.split_c = split_c;
  a.chunk = chunk;
  a.nsplit = nsplit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wtype) {
    case W_F32: return launch_wt<W_F32>(kv_type, a, kv_sinks, grid, st);
    case W_BF16: return launch_wt<W_BF16>(kv_type, a, kv_sinks, grid, st);
    case W_E5M2: return launch_wt<W_E5M2>(kv_type, a, kv_sinks, grid, st);
    case W_I8: return launch_wt<W_I8>(kv_type, a, kv_sinks, grid, st);
    default: return launch_wt<W_I4>(kv_type, a, kv_sinks, grid, st);
  }
}
