// Fused decode attention step over the layer-stacked KV ring buffer, a bf16
// or an fp8-e5m2 cache (template parameter T), for one sequence, for B
// lanes of a continuous batch in one launch, or for B lanes over a page pool.
//
// Replaces yalm_tpu/ops/pallas/attention.py:attend_step_l (body
// _fused_attn_body, _flash_heads, _lazy_sink_rotate; numerics reference
// _attn_step_ref) and is the middle of ops/pallas/block.py:attn_block_l.
// The batched entry replaces :attend_step_batched_l (kernel
// _attn_step_batched_kernel; numerics reference its emulation branch,
// per-lane _attn_step_ref, and for write-masked lanes _attend_ref over the
// unwritten cache with the sink view). The paged entry replaces
// :attend_step_paged_l (kernel _attn_step_paged_kernel; numerics reference
// its emulation branch :1119-1159, the batched step on each lane's
// gathered view): the same kernel, with lane b's logical slot s at pool row
// (tables[b, s / page], layer, s % page) of a (n_pages, L, page, Hk, D)
// pool. The addressing is a template parameter (kPaged), so the dense
// instances keep their code; the page is resolved per row (any page size
// that divides the window), with 64-bit pool offsets (a bf16 pool of 257
// pages at 7B shapes holds 2.16e9 elements). Before anything else a block
// checks every page id its lane reads or writes (blocks below
// ceil(max(kv_len, kv_pos + 1) / page)); one outside [0, n_pages) gives the
// lane a NaN output and no write, as a bad lane scalar does.
// One launch, one block per (kv head h, lane b):
//   1. RoPE on q (then * 1/sqrt(D), rounded to bf16) and on k_new at `pos`,
//      from a (D/2,) f32 pair-frequency table computed on the host (so every
//      rope scaling kind lives in ops/core.py) and `mscale`; accurate
//      sinf/cosf, since angles reach pos * freq ~ 4e3 rad.
//   2. The rounded k/v rows go into ring slot kv_pos of head h, IN PLACE:
//      rounded from f32 to the cache type in one step (for e5m2 not through
//      bf16, which would round twice; _attn_step_ref :790-793). Only this
//      block reads head h of lane b, so after __syncthreads() the block's
//      own reads see the row (no other block races it). A lane whose
//      `write` is 0 writes nothing and attends the cache as it is.
//   3. Pass 1 streams the K rows of slots < kv_len in tiles of 64 through
//      shared memory, widened to bf16 there (exact from e5m2): bf16 q .
//      bf16 k summed in f32, every score kept --
//      in shared memory while its kv_len * qpk floats fit (64 KB at 4096 x
//      4; up to 13310 slots at qpk 4 and 6590 at qpk 8, D 128), else in a
//      global (B, Hk, slots, qpk) f32 scratch the caller passes as `scores`
//      (16 B per slot at qpk 4 beside the 512 B of its K/V rows, mostly
//      L2 hits), so the window has no limit of its own. The batched launch
//      sizes both from the window S (its kv_len lives on the device).
//   4. Ring regime (kv_sink > 0): the first kv_sink rows of tile 0 are
//      rotated by max(0, pos - S + 1) positions (mscale 1) and rounded to
//      bf16 in shared memory only -- the lazy StreamingLLM sink view, in the
//      working type bf16 for both caches (_sink_view_ref :706-721); the
//      cache keeps the sink keys as written.
//   5. The softmax over all scores in f32 (max, exp, sum, divide), each
//      normalised p rounded to bf16; pass 2 streams the V rows and sums
//      bf16(p) . bf16(v) in f32 (with global scores, each tile's p is first
//      staged in shared memory, where the scores region then holds one tile).
// The Gemma forms (attend_step_l's softcap, win and alt arguments):
//   - softcap > 0: each scaled score s becomes cap * tanhf(s / cap), IEEE
//     division and the accurate tanhf, BEFORE the validity mask (a masked
//     slot stays at the mask value, not at -cap), as _flash_heads and
//     _attend_ref do;
//   - win > 0 (a sliding layer): slot s is attended iff s < kv_len and its
//     age < win, the age as _slot_age (:197-205) computes it -- a sink slot
//     S-1-s, any other (kv_pos - s) mod (S - kv_sink), over the lane's
//     logical slots (so in the ring regime the sinks, older than any window
//     shorter than S, drop out). In the linear regime (kv_sink 0, the lane's
//     own slot its newest) the tile loops start at max(kv_len - win, 0)
//     rounded down to a tile, as the TPU kernel skips the blocks below the
//     window (:295-306): a sliding layer reads ~win rows, not kv_len;
//   - alt (Gemma3's local rope): the host passes the local-theta table as
//     `freq`, for q, k_new and the sink view alike.
// kOne (K12, attend_one_l :85): q is taken as it is (no RoPE), divided by
// sqrt(D) as the emulation branch does (:98-102), nothing is written and
// there are no sinks: GQA attention of one query over slots < kv_len.
//
// This is the JAX emulation's numerics exactly (_attend_ref: normalise,
// then cast p to bf16), not the Pallas kernel's online softmax, which
// normalises after the cast: across a 32-layer model the two differ by
// ~1% of the logits, the emulation's way is the reference, and the stored
// scores cost no extra device-memory traffic.
//
// Rotations are written as separate f32 products and a difference
// (__fmul_rn, __fsub_rn), never contracted into an fma, so they round as
// torch's and XLA's elementwise ops do and the written rows match theirs.
//
// The batched launch reads each lane's (kv_pos, kv_len, kv_sink, pos,
// write) from a (5, B) int32 device array uploaded once per tick, so no
// layer waits for the host. Lane offsets are 64-bit: a (16, 32, 4096, 8,
// 128) cache holds 2^31 elements.
//
// Bound on this card: bytes (the K/V rows of slots < kv_len, 16 MB per layer
// at 4096 slots x 8 heads x 128 x bf16 x 2, half that for e5m2; the paged
// launch adds its tables). One lane runs only Hk = 8 blocks, so a handful of
// SMs stream its cache: split-K over the sequence (flash-decoding) is the
// known next step; a batch of B lanes runs 8 B blocks.
#include "common.cuh"

using namespace yt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;
constexpr int KPAD = 8;      // bf16 padding per shared K row (bank spread)
constexpr int MAX_OUT = 8;   // output elements per thread: qpk * D <= 2048
constexpr float NEG_BIG = -1e30f;  // a masked score (the reference's _NEG_INF)

// The cache element types: the row write from f32, and 8 elements widened
// to 8 bf16 (16 bytes of shared memory).
template <typename T> struct KV;

template <> struct KV<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ __forceinline__ static void load8(const __nv_bfloat16* p, __nv_bfloat16* dst) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
  }
};

template <> struct KV<uint8_t> {  // fp8 e5m2
  __device__ __forceinline__ static uint8_t from_float(float x) { return float_to_e5m2(x); }
  __device__ __forceinline__ static void load8(const uint8_t* p, __nv_bfloat16* dst) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {u.x, u.y};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(e5m2_to_float(w[i] >> (16 * j)),
                                                       e5m2_to_float(w[i] >> (16 * j + 8)));
        o[2 * i + j] = *reinterpret_cast<const uint32_t*>(&b);
      }
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  }
};

// x0 * c - x1 * s and x0 * s + x1 * c, each product rounded (no fma)
__device__ __forceinline__ float rot_re(float x0, float x1, float c, float s) {
  return __fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s));
}
__device__ __forceinline__ float rot_im(float x0, float x1, float c, float s) {
  return __fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c));
}

struct AttnArgs {
  const float* q;        // (B, Hk, qpk, D) unrotated, unscaled
  const float* k_new;    // (B, Hk, D) unrotated
  const float* v_new;    // (B, Hk, D)
  void* k_all;           // (B, L, S, Hk, D), or a pool (n_pages, L, page, Hk, D);
  void* v_all;           // of the cache type T, updated in place
  const float* freq;     // (D/2,) rope pair frequencies
  float* out;            // (B, Hk, qpk, D)
  float* scores;         // (B, Hk, slots, qpk) scratch, or null: scores in smem
  const int* lanes;      // (5, B) kv_pos, kv_len, kv_sink, pos, write; or null:
                         // one lane (B = 1) with the scalars below, writing
  const int* tables;     // (B, S / page) page ids of the paged launch, else null
  size_t lane_stride;    // elements of one lane's dense cache, L * S * Hk * D
  float mscale, inv_sqrt_d;
  float sqrt_d;          // kOne: q is divided by this (f32 sqrt(D))
  float softcap;         // > 0: Gemma2's score cap
  int win;               // > 0: the layer's sliding window (age < win)
  int layer, S, Hk, qpk, D, kv_pos, kv_len, kv_sink, pos, kv_sinks;
  int B, slots;          // slots: score capacity per (lane, head), >= kv_len
  int L, page, n_pages;  // the paged launch's pool: layers, slots per page, pages
};

// shared memory: q (qpk, D + 2) f32 | scores (slots, qpk) f32, or with
// global scores one tile's p (TILE, qpk) | one K or V tile (TILE, D + KPAD)
// bf16, 16-byte aligned
__host__ __device__ inline size_t float_words(int qpk, int D, int slots) {
  const size_t n = (size_t)qpk * (D + 2) + (size_t)slots * qpk;
  return (n + 3) & ~(size_t)3;
}

__host__ __device__ inline size_t smem_bytes(int qpk, int D, int slots) {
  return float_words(qpk, D, slots) * sizeof(float) +
         (size_t)TILE * (D + KPAD) * sizeof(__nv_bfloat16);
}

// kGlobalScores: the scores are in a.scores. A template parameter, not a
// runtime choice, so the shared-memory instance keeps shared-memory loads
// (a pointer that may be either is read through slower generic loads).
// kPaged: rows are addressed through a.tables in a pool (see the top).
// kOne: attend_one_l (see the top).
template <typename T, bool kGlobalScores, bool kPaged, bool kOne>
__global__ void __launch_bounds__(THREADS) attend_step_kernel(AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, qpk = a.qpk, h = blockIdx.x, b = blockIdx.y, half = D / 2;
  const int QS = D + 2, KS = D + KPAD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, vpr = D / 8;
  int kv_pos = a.kv_pos, n = a.kv_len, kv_sink = a.kv_sink, pos = a.pos;
  bool write = !kOne;
  if (a.lanes) {
    kv_pos = a.lanes[b];
    n = a.lanes[a.B + b];
    kv_sink = a.lanes[2 * a.B + b];
    pos = a.lanes[3 * a.B + b];
    write = a.lanes[4 * a.B + b] != 0;
  }
  const float* q = a.q + (size_t)b * a.Hk * qpk * D;
  float* out = a.out + ((size_t)b * a.Hk + h) * qpk * D;
  T* k_all = static_cast<T*>(a.k_all) + (kPaged ? 0 : (size_t)b * a.lane_stride);
  T* v_all = static_cast<T*>(a.v_all) + (kPaged ? 0 : (size_t)b * a.lane_stride);
  const int* tab = kPaged ? a.tables + (size_t)b * (a.S / a.page) : nullptr;
  bool bad = n < 1 || n > a.slots || kv_pos < 0 || kv_pos >= a.S || kv_sink < 0 ||
             kv_sink > a.kv_sinks;
  if (kPaged && !bad) {  // every page the lane reads or writes lies in the pool
    const int nb = (max(n, write ? kv_pos + 1 : 0) + a.page - 1) / a.page;
    int out_of_pool = 0;
    for (int i = tid; i < nb; i += THREADS)
      out_of_pool |= (unsigned)tab[i] >= (unsigned)a.n_pages;
    bad = __syncthreads_or(out_of_pool) != 0;
  }
  if (bad) {
    // lane scalars or page ids the kernel does not take (the host checks the
    // ones it uploads): touch no cache row, give the lane a NaN output
    for (int i = tid; i < qpk * D; i += THREADS) out[i] = __int_as_float(0x7fc00000);
    return;
  }
  // element offset of head h's row at logical slot s
  const int layer = a.layer, S = a.S, Hk = a.Hk, L = a.L, page = a.page;
  const auto row = [layer, S, Hk, L, page, tab, h, D](int s) -> size_t {
    if constexpr (kPaged)
      return ((((size_t)tab[s / page] * L + layer) * page + s % page) * Hk + h) * D;
    else
      return (((size_t)layer * S + s) * Hk + h) * D;
  };
  float* qs = reinterpret_cast<float*>(smem);  // (qpk, QS)
  // (slots, qpk): scores, then bf16(p). Only this block touches its part of
  // the global scratch, so __syncthreads() orders it as it does shared memory.
  float* ps = qs + qpk * QS;  // shared: every score, or one tile's p
  float* sc = kGlobalScores ? a.scores + ((size_t)b * a.Hk + h) * a.slots * qpk : ps;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<float*>(smem) + float_words(qpk, D, kGlobalScores ? TILE : a.slots));
  const float posf = (float)pos;

  // 1-2: rope, scale, and the in-place row write
  if (kOne) {
    for (int i = tid; i < qpk * D; i += THREADS) {
      const int j = i / D, d = i - j * D;
      qs[j * QS + d] = bf16_round(__fdiv_rn(q[((size_t)h * qpk + j) * D + d], a.sqrt_d));
    }
  } else {
    for (int i = tid; i < qpk * half; i += THREADS) {
      const int j = i / half, p = i - j * half;
      const float ang = posf * a.freq[p];
      const float c = a.mscale * cosf(ang), s = a.mscale * sinf(ang);
      const float* qr = q + ((size_t)h * qpk + j) * D;
      const float x0 = qr[2 * p], x1 = qr[2 * p + 1];
      qs[j * QS + 2 * p] = bf16_round(__fmul_rn(rot_re(x0, x1, c, s), a.inv_sqrt_d));
      qs[j * QS + 2 * p + 1] = bf16_round(__fmul_rn(rot_im(x0, x1, c, s), a.inv_sqrt_d));
    }
  }
  if (write) {
    const size_t new_row = row(kv_pos);
    const float* kn = a.k_new + ((size_t)b * a.Hk + h) * D;
    const float* vn = a.v_new + ((size_t)b * a.Hk + h) * D;
    for (int p = tid; p < half; p += THREADS) {
      const float ang = posf * a.freq[p];
      const float c = a.mscale * cosf(ang), s = a.mscale * sinf(ang);
      const float x0 = kn[2 * p], x1 = kn[2 * p + 1];
      k_all[new_row + 2 * p] = KV<T>::from_float(rot_re(x0, x1, c, s));
      k_all[new_row + 2 * p + 1] = KV<T>::from_float(rot_im(x0, x1, c, s));
    }
    for (int d = tid; d < D; d += THREADS) v_all[new_row + d] = KV<T>::from_float(vn[d]);
  }
  __syncthreads();

  // 3-4: pass 1, every score of slots < kv_len (from lo on a sliding layer
  // in the linear regime: the slots below it are older than the window)
  const float rot = (float)max(0, pos - a.S + 1);
  const int win = a.win, ring = max(S - kv_sink, 1);
  const int lo = (win > 0 && kv_sink == 0 && kv_pos + 1 >= n) ? max(n - win, 0) / TILE * TILE : 0;
  for (int t0 = lo; t0 < n; t0 += TILE) {
    const int nt = min(TILE, n - t0);
    for (int i = tid; i < nt * vpr; i += THREADS) {
      const int r = i / vpr, c = i - r * vpr;
      KV<T>::load8(k_all + row(t0 + r) + 8 * c, tile + r * KS + 8 * c);
    }
    __syncthreads();
    if (t0 == 0 && kv_sink > 0) {  // the lazy sink view (tile 0 holds the sinks)
      const int nsink = min(kv_sink, nt);
      for (int i = tid; i < nsink * half; i += THREADS) {
        const int r = i / half, p = i - r * half;
        const float ang = rot * a.freq[p];
        const float c = cosf(ang), s = sinf(ang);
        const float x0 = __bfloat162float(tile[r * KS + 2 * p]);
        const float x1 = __bfloat162float(tile[r * KS + 2 * p + 1]);
        tile[r * KS + 2 * p] = __float2bfloat16_rn(rot_re(x0, x1, c, s));
        tile[r * KS + 2 * p + 1] = __float2bfloat16_rn(rot_im(x0, x1, c, s));
      }
      __syncthreads();
    }
    for (int i = tid; i < nt * qpk; i += THREADS) {  // one (slot, query) dot per thread
      const int r = i / qpk, j = i - r * qpk;
      const float2* qj = reinterpret_cast<const float2*>(qs + j * QS);
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(tile + r * KS);
      float dot = 0.f;
      for (int p = 0; p < half; ++p) {
        const float2 kf = __bfloat1622float2(kr[p]);
        const float2 qf = qj[p];
        dot = fmaf(qf.x, kf.x, dot);
        dot = fmaf(qf.y, kf.y, dot);
      }
      if (a.softcap > 0.f) dot = __fmul_rn(a.softcap, tanhf(__fdiv_rn(dot, a.softcap)));
      if (win > 0) {  // the age mask (_slot_age)
        const int s = t0 + r;
        const int age = s < kv_sink ? S - 1 - s : ((kv_pos - s) % ring + ring) % ring;
        if (age >= win) dot = NEG_BIG;
      }
      sc[(t0 + r) * qpk + j] = dot;
    }
    __syncthreads();
  }

  // 5: softmax per query row, one warp each: p = bf16(exp(s - max) / sum)
  for (int j = warp; j < qpk; j += WARPS) {
    float m = -INFINITY;
    for (int r = lo + lane; r < n; r += 32) m = fmaxf(m, sc[r * qpk + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = lo + lane; r < n; r += 32) {
      const float e = expf(sc[r * qpk + j] - m);
      sc[r * qpk + j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int r = lo + lane; r < n; r += 32) sc[r * qpk + j] = bf16_round(sc[r * qpk + j] / l);
  }
  __syncthreads();

  // pass 2: out = sum over slots of bf16(p) * bf16(v), f32
  float acc[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) acc[i] = 0.f;
  const int nout = qpk * D;
  for (int t0 = lo; t0 < n; t0 += TILE) {
    const int nt = min(TILE, n - t0);
    for (int i = tid; i < nt * vpr; i += THREADS) {
      const int r = i / vpr, c = i - r * vpr;
      KV<T>::load8(v_all + row(t0 + r) + 8 * c, tile + r * D + 8 * c);
    }
    if (kGlobalScores)
      for (int i = tid; i < nt * qpk; i += THREADS) ps[i] = sc[(size_t)t0 * qpk + i];
    const float* pt = kGlobalScores ? ps : sc + t0 * qpk;  // (nt, qpk) p of this tile
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAX_OUT; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < nout) {
        const int j = idx / D, d = idx - j * D;
        float o = acc[i];
        for (int r = 0; r < nt; ++r)
          o = fmaf(pt[r * qpk + j], __bfloat162float(tile[r * D + d]), o);
        acc[i] = o;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    const int idx = tid + i * THREADS;
    if (idx < nout) out[idx] = acc[i];
  }
}

template <typename T, bool kPaged, bool kOne>
int launch_as(const AttnArgs& a, size_t smem, cudaStream_t st) {
  const auto kern = a.scores ? attend_step_kernel<T, true, kPaged, kOne>
                             : attend_step_kernel<T, false, kPaged, kOne>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(a.Hk, a.B), THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kind(const AttnArgs& a, bool one, size_t smem, cudaStream_t st) {
  if (one) return launch_as<T, false, true>(a, smem, st);
  return a.tables ? launch_as<T, true, false>(a, smem, st) : launch_as<T, false, false>(a, smem, st);
}

// kv_type W_BF16 or W_E5M2 (common.cuh), the type of the cache or pool; the
// paged instance when a.tables is set, attend_one_l's when `one`
int launch(int kv_type, const AttnArgs& a, cudaStream_t st, bool one = false) {
  const size_t smem = smem_bytes(a.qpk, a.D, a.scores ? TILE : a.slots);
  if (smem > 227 * 1024 || !(a.softcap >= 0.f)) return ERR_ARGS;
  if (kv_type == W_BF16) return launch_kind<__nv_bfloat16>(a, one, smem, st);
  if (kv_type == W_E5M2) return launch_kind<uint8_t>(a, one, smem, st);
  return ERR_ARGS;
}

// the fields every entry point sets; the rest stay 0 / null
AttnArgs common_args(const float* q, const float* k_new, const float* v_new, void* k_all,
                     void* v_all, const float* freq, float mscale, float inv_sqrt_d,
                     float* out, float* scores, int layer, int S, int Hk, int qpk, int D,
                     int kv_sinks) {
  AttnArgs a{};
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_all = k_all;
  a.v_all = v_all;
  a.freq = freq;
  a.mscale = mscale;
  a.inv_sqrt_d = inv_sqrt_d;
  a.out = out;
  a.scores = scores;
  a.layer = layer;
  a.S = S;
  a.Hk = Hk;
  a.qpk = qpk;
  a.D = D;
  a.kv_sinks = kv_sinks;
  return a;
}

bool shape_ok(int S, int Hk, int qpk, int D, int layer, int kv_sinks) {
  return D >= 8 && D % 8 == 0 && qpk >= 1 && qpk * D <= THREADS * MAX_OUT && Hk >= 1 &&
         layer >= 0 && S >= 1 && kv_sinks >= 0 && kv_sinks <= TILE;
}

}  // namespace

// One lane: k_all and v_all (L, S, Hk, D) of kv_type; the scalars come by
// value and the row is written.
extern "C" int yt_attend_step(int kv_type, const float* q, const float* k_new,
                              const float* v_new, void* k_all, void* v_all,
                              const float* freq, float mscale, float inv_sqrt_d,
                              float* out, float* scores, int layer, int S, int Hk,
                              int qpk, int D, int kv_pos, int kv_len, int kv_sink,
                              int pos, int kv_sinks, float softcap, int win, void* stream) {
  if (!shape_ok(S, Hk, qpk, D, layer, kv_sinks) || kv_len < 1 || kv_len > S || kv_pos < 0 ||
      kv_pos >= S || kv_sink < 0 || kv_sink > kv_sinks)
    return ERR_ARGS;
  AttnArgs a = common_args(q, k_new, v_new, k_all, v_all, freq, mscale, inv_sqrt_d, out,
                           scores, layer, S, Hk, qpk, D, kv_sinks);
  a.kv_pos = kv_pos;
  a.kv_len = kv_len;
  a.kv_sink = kv_sink;
  a.pos = pos;
  a.B = 1;
  a.slots = kv_len;
  a.softcap = softcap;
  a.win = win;
  return launch(kv_type, a, static_cast<cudaStream_t>(stream));
}

// attend_one_l: q (Hk, qpk, D) f32 as it is (divided by sqrt_d), k_all and
// v_all (L, S, Hk, D) of kv_type, read only; slots < kv_len attended.
extern "C" int yt_attend_one(int kv_type, const float* q, const void* k_all, const void* v_all,
                             float sqrt_d, float* out, float* scores, int layer, int S, int Hk,
                             int qpk, int D, int kv_len, void* stream) {
  if (!shape_ok(S, Hk, qpk, D, layer, 0) || kv_len < 1 || kv_len > S || !(sqrt_d > 0.f))
    return ERR_ARGS;
  AttnArgs a = common_args(q, nullptr, nullptr, const_cast<void*>(k_all),
                           const_cast<void*>(v_all), nullptr, 1.f, 1.f, out, scores, layer, S,
                           Hk, qpk, D, 0);
  a.kv_len = kv_len;
  a.B = 1;
  a.slots = kv_len;
  a.sqrt_d = sqrt_d;
  return launch(kv_type, a, static_cast<cudaStream_t>(stream), true);
}

// B lanes: caches (B, L, S, Hk, D); lanes (5, B) int32 on the device. The
// score space is sized from the window: shared memory if S slots fit, else
// `scores` (B, Hk, S, qpk).
extern "C" int yt_attend_step_batched(int kv_type, const float* q, const float* k_new,
                                      const float* v_new, void* k_all, void* v_all,
                                      const float* freq, float mscale, float inv_sqrt_d,
                                      float* out, float* scores, const int* lanes, int B,
                                      int L, int layer, int S, int Hk, int qpk, int D,
                                      int kv_sinks, float softcap, int win, void* stream) {
  if (!shape_ok(S, Hk, qpk, D, layer, kv_sinks) || layer >= L || B < 1 || B > 65535 || !lanes)
    return ERR_ARGS;
  AttnArgs a = common_args(q, k_new, v_new, k_all, v_all, freq, mscale, inv_sqrt_d, out,
                           scores, layer, S, Hk, qpk, D, kv_sinks);
  a.lanes = lanes;
  a.lane_stride = (size_t)L * S * Hk * D;
  a.B = B;
  a.slots = S;
  a.softcap = softcap;
  a.win = win;
  return launch(kv_type, a, static_cast<cudaStream_t>(stream));
}

// B lanes over a page pool: k_pool and v_pool (n_pages, L, page, Hk, D);
// tables (B, nblk) int32 page ids and lanes (5, B) int32 on the device; the
// window is S = nblk * page, and the score space is sized from it as above.
extern "C" int yt_attend_step_paged(int kv_type, const float* q, const float* k_new,
                                    const float* v_new, void* k_pool, void* v_pool,
                                    const float* freq, float mscale, float inv_sqrt_d,
                                    float* out, float* scores, const int* lanes,
                                    const int* tables, int B, int n_pages, int L, int layer,
                                    int page, int nblk, int Hk, int qpk, int D, int kv_sinks,
                                    float softcap, int win, void* stream) {
  if (page < 1 || nblk < 1 || (long long)page * nblk > (1 << 30))
    return ERR_ARGS;
  const int S = page * nblk;
  if (!shape_ok(S, Hk, qpk, D, layer, kv_sinks) || layer >= L || B < 1 || B > 65535 ||
      n_pages < 1 || !lanes || !tables)
    return ERR_ARGS;
  AttnArgs a = common_args(q, k_new, v_new, k_pool, v_pool, freq, mscale, inv_sqrt_d, out,
                           scores, layer, S, Hk, qpk, D, kv_sinks);
  a.lanes = lanes;
  a.tables = tables;
  a.B = B;
  a.slots = S;
  a.L = L;
  a.page = page;
  a.n_pages = n_pages;
  a.softcap = softcap;
  a.win = win;
  return launch(kv_type, a, static_cast<cudaStream_t>(stream));
}
