// The dense FFN of one layer for 1-16 rows of x in ONE launch:
//
//   out = [x +] W2[layer] @ bf16(act(h1) * h3),  [h1; h3] = W13[layer] @ rmsnorm(x)
//
// Replaces yalm_tpu/ops/pallas/ffn.py:ffn_l (:332; e5m2, int8, bf16 or f32
// weights with optional per-row scales) and :ffn4_l (:227; packed int4
// weights with group scales), both one Pallas kernel that starts w2's first
// tile while the last w13 tiles are in flight and keeps the GLU output in
// VMEM (ffn.py:1-11, :81-85). The arithmetic is that of csrc/gemv.cu's
// gemv_kernel for both projections (its file comment), with x's rows on one
// n8 tile of mma.sync up to 8 rows and on two past 8.
//
// Bound on this card: bytes -- w13 and w2 once (176 MB at Mistral-7B's
// shapes in e5m2, 88 MB packed int4); 16 rows do 32 flops a weight byte,
// far under the card's ~295. Run as two GEMV launches (w13 with the GLU,
// then w2), the w2 stream started from nothing after the w13 stream had
// drained and the launch boundary had passed; run as five launches past 8
// rows (the row norm, the rounding and the GEMM, twice), the normed rows
// and the GLU rows went through device memory between four boundaries.
//
// The design (csrc/block.cu's): one cooperative, persistent grid of
// 256-thread blocks (as many as are co-resident, 2 per SM on the H100)
// walks the work items of three phases in order; an item waits for the
// items it reads, never for a grid-wide barrier:
//   N. past 8 rows, one item per row of x, on the blocks at the grid's far
//      end: the rmsnorm in gemv_kernel's order, the row normalised and
//      rounded to bf16 into scratch (gemv_kernel's staged values), one
//      arrival on a counter. A w13 item's own norm reads all of x (256 KB of
//      L2 a slice at 16 rows); with the norm items it stages its slice's
//      bf16 columns. Up to 8 rows each w13 item runs gemv_kernel's rmsnorm
//      prologue itself (the norm items put every item behind one block).
//   A. the w13 GEMV's (row block, K slice) items of ops/cuda/gemv.py:
//      gemv_plan(nb, 2H, K, glu=True), gemv_kernel's body (the weight loads
//      issued before the norm, mma.sync bf16 with f32 sums, int4 groups
//      scaled on their f32 partials); the last slice of each row
//      block to arrive (a counter) sums the slices in slice order, writes the
//      block's 64 GLU columns as bf16 rows to scratch (nb x H, in L2) and
//      releases them (a flag per row block).
//   B. the w2 GEMV's items of gemv_plan(nb, dim, H), slice-major, the first
//      taken by the blocks that ran out of A items first (the grid's far
//      end). An item issues its weight loads BEFORE it waits (an L2
//      prefetch of 4 or 12 more iterations measured no faster, PERF.md
//      section 6): the weights do not depend on the GLU, only the columns of x do, so
//      it waits for the flags of the A row blocks its K slice reads (warp
//      0, a lane per flag: 28 flags polled one after another cost up to 8
//      us), stages them, and streams on. The last slice of each row block to arrive sums
//      the slices in slice order, scales and adds the residual.
// With the two launches' plans (nb <= 8) the items, their sums and the
// order of the sums are theirs, so the one launch gives the same bits. An
// arrival counter wraps to 0 (atomicInc); the last block to finish puts
// the flags back to 0, so every call leaves its scratch as it found it and
// a captured launch replays. No wait can deadlock: the cooperative launch
// is refused unless every block is co-resident, a block takes its items
// phase by phase, and an item waits only for items of earlier phases. A launch the
// card refuses is reported; nothing falls back to the two or five launches.
#include <algorithm>

#include "gemv.cuh"

using namespace yt;
using namespace yt::gemv;

namespace {

struct FfnArgs {
  const void* w13;          // (L, 2H, K) of the weight type (int4: K / 2 bytes)
  const void* w2;           // (L, K, H) (int4: H / 2 bytes)
  const float* x;           // (nb, K) the residual stream
  const float* norm_w;      // (L, K)
  const float* scale13;     // (L, 2H) per-row scales, or null
  const float* scale2;      // (L, K) per-row scales, or null
  const float* gs13;        // (L, K / g13, 2H) int4 group scales, or null
  const float* gs2;         // (L, H / g2, K) int4 group scales, or null
  const float* residual;    // (nb, K) or null
  float* out;               // (nb, K)
  __nv_bfloat16* xn;        // (nb, K): bf16(rmsnorm(x) * norm_w[layer])
  float4* a_part;           // (w13 row blocks, split_a, NT * 256): the slices' partials
  __nv_bfloat16* glu;       // (nb, H): bf16(act(h1) * h3)
  float4* b_part;           // (w2 row blocks, split_b, NT * 256)
  unsigned* a_ctr;          // (w13 row blocks,) slice arrivals, 0 between calls
  unsigned* glu_done;       // (w13 row blocks,) 1: the block's GLU columns are written
  unsigned* b_ctr;          // (w2 row blocks,) slice arrivals, 0 between calls
  unsigned* norm_done;      // rows of xn written
  unsigned* exits;          // blocks done; the last resets norm_done and glu_done to 0
  unsigned long long* stamps;  // (grid, 4) %globaltimer at the phase bounds, or null
  float eps;
  int act;                  // 0 silu, 1 gelu
  int layer, K, H, nb;
  int g13, g2;              // int4 group widths of w13 (over K) and w2 (over H); 0 otherwise
  int kchunk_a, split_a;    // w13's gemv_plan
  int kchunk_b, split_b;    // w2's gemv_plan
};

// Stamp k of this block (ns, the card's global timer), when asked for: 0
// entry, 1 its A items done, 2 its first B item's columns of x ready, 3 its
// B items done.
__device__ __forceinline__ void stamp(const FfnArgs& a, int k) {
  if (a.stamps && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[blockIdx.x * 4 + k] = t;
  }
}

// Warp 0 waits until flags[lo..hi] are all >= n, a lane per flag (one L2
// round trip for up to 32 flags, not one per flag); the block waits for it
// at the next __syncthreads().
__device__ __forceinline__ void wait_flags(const unsigned* flags, int lo, int hi, unsigned n) {
  if (threadIdx.x < 32)
    for (int i = lo + (int)threadIdx.x; i <= hi; i += 32)
      while (ld_acquire(flags + i) < n) {
      }
}

// The norm item of row b: the rmsnorm's sum of squares over all of K in
// gemv_kernel's order (each thread's strided float4s, the warps' sums, the
// 8 warps in order), then the row normalised and rounded to bf16 into xn
// -- the values gemv_kernel stages -- and one arrival on norm_done.
__device__ __forceinline__ void norm_row(const FfnArgs& a, int b) {
  __shared__ float red[WARPS];
  __shared__ float rs;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, K4 = a.K / 4;
  const float4* x4 = reinterpret_cast<const float4*>(a.x) + (size_t)b * K4;
  const float4* nw4 = reinterpret_cast<const float4*>(a.norm_w + (size_t)a.layer * a.K);
  float ss = 0.f;
  for (int k = tid; k < K4; k += THREADS) {
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
    rs = 1.0f / sqrtf(tot / (float)a.K + a.eps);
  }
  __syncthreads();
  const float s = rs;
  for (int k = tid; k < K4; k += THREADS) {
    float4 v = x4[k];
    const float4 m = nw4[k];
    v = make_float4(v.x * s * m.x, v.y * s * m.y, v.z * s * m.z, v.w * s * m.w);
    *reinterpret_cast<uint2*>(a.xn + (size_t)b * a.K + 4 * k) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
  release(a.norm_done);
}

// Columns [c0, c0 + n * COLS) of nb bf16 rows of width K written in this
// launch (through L2), zeros past K, into the staged rows xs (stride XS).
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* src, int nb, int K, int c0,
                                           int q4, __nv_bfloat16* xs, int XS) {
  for (int i = threadIdx.x; i < nb * q4; i += THREADS) {
    const int b = i / q4, j = i - b * q4, c = c0 + 4 * j;
    uint2 v = make_uint2(0u, 0u);
    if (c < K) v = __ldcg(reinterpret_cast<const uint2*>(src + (size_t)b * K + c));
    *reinterpret_cast<uint2*>(xs + (size_t)b * XS + 4 * j) = v;
  }
}

// Iterations of weight loads in flight per thread: 3 up to 8 rows, where
// with gemv_kernel's 2 the packed int4 items' widening left the stream
// short of bytes in flight (K7 measured slower than the two launches with 2,
// faster with 3; PERF.md section 6); 2 on two n8 tiles, where 3 gained
// nothing and the registers are at the cap.
template <int NT>
__host__ __device__ constexpr int ring_depth() {
  return NT == 1 ? 3 : DEPTH;
}

// One (row block, K slice) item: phase A (kA, the w13 GEMV with the rmsnorm
// prologue and the GLU pair) or phase B (the w2 GEMV on the GLU rows, scale
// and residual), gemv_kernel's body over NT n8 tiles of x's rows. A slice
// that is not its row block's last returns after storing its partials.
template <int WT, int NT, bool kA>
__device__ __forceinline__ void ffn_item(const FfnArgs& a, int blk, int z, bool first,
                                         unsigned char* smem) {
  using LY = Layout<WT>;
  constexpr bool I4 = LY::I4;
  constexpr int D = ring_depth<NT>();
  constexpr int COLS = LY::COLS;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  const int N = kA ? 2 * a.H : a.K, K = kA ? a.K : a.H, nb = a.nb;
  const int group = kA ? a.g13 : a.g2;
  const int kchunk = kA ? a.kchunk_a : a.kchunk_b, S = kA ? a.split_a : a.split_b;
  const size_t rb = LY::row_bytes(K);
  const int nit = (int)((rb + WIN - 1) / WIN), it0 = z * kchunk;
  const int n = min(nit, it0 + kchunk) - it0;  // this slice's iterations (>= 1)
  const int XS = kchunk * COLS + XPAD;

  // the weight stream starts first: D iterations in flight before the
  // prologue (and, in phase B, before the wait)
  bool ok0, ok1;
  const int r0 = tile_row<kA>(blk, w, g, 0, N, &ok0), r1 = tile_row<kA>(blk, w, g, 1, N, &ok1);
  const uint8_t* wl = static_cast<const uint8_t*>(kA ? a.w13 : a.w2) + (size_t)a.layer * N * rb;
  const uint8_t* w0 = wl + (size_t)(ok0 ? r0 : 0) * rb + 16 * t;
  const uint8_t* w1 = wl + (size_t)(ok1 ? r1 : 0) * rb + 16 * t;
  const long long lim = (long long)rb - 16 * t;
  const float* gs = I4 ? (kA ? a.gs13 : a.gs2) + (size_t)a.layer * (K / group) * N : nullptr;
  const float* gs0 = I4 ? gs + (ok0 ? r0 : 0) : nullptr;
  const float* gs1 = I4 ? gs + (ok1 ? r1 : 0) : nullptr;
  uint4 ring[D][4];
  float sring[D][2];
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < n) load_iter<WT>(ring[d], sring[d], w0, w1, ok0, ok1, lim, it0 + d, gs0, gs1, N, group);

  // under those loads: the wait for the columns of x this slice reads (A:
  // the normed rows; B: the GLU columns [c0, c1), 64 pairs an A row
  // block), then those columns staged in shared memory
  const int c0 = it0 * COLS, q4 = n * COLS / 4;  // this slice's first column, its quads
  if (kA && NT > 1) {
    wait_flags(a.norm_done, 0, 0, nb);
    __syncthreads();
    stage_rows(a.xn, nb, K, c0, q4, xs, XS);
  } else if (kA) {
    // up to 8 rows, gemv_kernel's own prologue: the rmsnorm's sums of
    // squares over all of K (x from L2), then this slice's columns of x,
    // normalised and rounded to bf16 (behind norm items, phase A ended ~4
    // us later at one row)
    __shared__ float red[WARPS][8];
    __shared__ float rs[8];
    const float4* x4 = reinterpret_cast<const float4*>(a.x);
    const float4* nw4 = reinterpret_cast<const float4*>(a.norm_w + (size_t)a.layer * K);
    const int K4 = K / 4;
    float ss[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) ss[b] = 0.f;
    for (int k = tid; k < K4; k += THREADS)
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (b < nb) {
          const float4 v = x4[(size_t)b * K4 + k];
          ss[b] = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, ss[b]))));
        }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float v = warp_sum(ss[b]);
      if (lane == 0) red[w][b] = v;
    }
    __syncthreads();
    if (tid < nb) {
      float tot = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) tot += red[i][tid];
      rs[tid] = 1.0f / sqrtf(tot / (float)K + a.eps);
    }
    __syncthreads();
    for (int i = tid; i < nb * q4; i += THREADS) {
      const int b = i / q4, j = i - b * q4, c = c0 + 4 * j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < K) {  // K % 4 == 0: a float4 is all in or all out
        v = x4[(size_t)b * K4 + c / 4];
        const float s = rs[b];
        const float4 m = nw4[c / 4];
        v = make_float4(v.x * s * m.x, v.y * s * m.y, v.z * s * m.z, v.w * s * m.w);
      }
      *reinterpret_cast<uint2*>(xs + (size_t)b * XS + 4 * j) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  } else {
    const int c1 = min(K, c0 + kchunk * COLS);
    wait_flags(a.glu_done, c0 / (ROWS / 2), (c1 - 1) / (ROWS / 2), 1);
    __syncthreads();
    if (first) stamp(a, 2);
    stage_rows(a.glu, nb, K, c0, q4, xs, XS);
  }
  __syncthreads();

  // the stream: each iteration's fragments, mma, then the load D ahead
  const __nv_bfloat16* xg[NT];
  bool live[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    live[j] = 8 * j + g < nb;  // column g of tile j is x row 8j + g
    xg[j] = xs + (size_t)(live[j] ? 8 * j + g : 0) * XS;
  }
  float acc[NT][4], gacc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = gacc[j][c] = 0.f;
  for (int i0 = 0; i0 < n; i0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int i = i0 + d;
      if (i >= n) break;  // uniform across the block
      mma_iter<WT, NT>(acc, gacc, ring[d], sring[d], xg, live, i, t, group);
      if (i + D < n)
        load_iter<WT>(ring[d], sring[d], w0, w1, ok0, ok1, lim, it0 + i + D, gs0, gs1, N,
                      group);
    }
  }

  if (S > 1) {
    // this slice's partials to scratch in the threads' own order; the last
    // slice to arrive (the counter wraps to 0) sums them in slice order
    float4* part = (kA ? a.a_part : a.b_part) + (size_t)blk * S * NT * THREADS;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      __stcg(part + ((size_t)z * NT + j) * THREADS + tid,
             make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last = atomicInc((kA ? a.a_ctr : a.b_ctr) + blk, S - 1) == (unsigned)(S - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float4 v = __ldcg(part + (size_t)j * THREADS + tid);
      for (int zz = 1; zz < S; ++zz) {
        const float4 u = __ldcg(part + ((size_t)zz * NT + j) * THREADS + tid);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      acc[j][0] = v.x;
      acc[j][1] = v.y;
      acc[j][2] = v.z;
      acc[j][3] = v.w;
    }
  }

  // epilogue on the full sums: thread (g, t) holds rows g, g + 8 of its
  // tile for x rows 8j + 2t, 8j + 2t + 1 of tile j
  const size_t row0 = (size_t)a.layer * N;
  if (kA) {
    if (ok0) {  // the GLU pair r0 (rows r0 and H + r0 of W13)
      const int p = r0;
      const float s1 = a.scale13 ? a.scale13[row0 + p] : 1.f;
      const float s3 = a.scale13 ? a.scale13[row0 + a.H + p] : 1.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int b = 8 * j + 2 * t + c;
          if (b >= nb) continue;
          float h1 = acc[j][c], h3 = acc[j][2 + c];
          if (a.scale13) {
            h1 *= s1;
            h3 *= s3;
          }
          const float y = bf16_round(glu_act(h1, a.act) * h3);
          a.glu[(size_t)b * a.H + p] = __float2bfloat16_rn(y);
        }
    }
    release(a.glu_done + blk);
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    if (!(h ? ok1 : ok0)) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int b = 8 * j + 2 * t + c;
        if (b >= nb) continue;
        float y = acc[j][2 * h + c];
        if (a.scale2) y = __fmul_rn(y, a.scale2[row0 + r]);
        if (a.residual) y = __fadd_rn(y, a.residual[(size_t)b * N + r]);
        a.out[(size_t)b * N + r] = y;
      }
  }
}

template <int WT, int NT>
__global__ void __launch_bounds__(THREADS, 2) ffn_kernel(FfnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows_a = (a.H + ROWS / 2 - 1) / (ROWS / 2), rows_b = (a.K + ROWS - 1) / ROWS;
  const int items_a = rows_a * a.split_a, items_b = rows_b * a.split_b;
  stamp(a, 0);

  // past 8 rows the norm items, one per row of x, on the blocks at the
  // grid's far end (they hold the fewest A items); every A item waits for them
  for (int b = gridDim.x - 1 - blockIdx.x; NT > 1 && b < a.nb; b += gridDim.x) {
    norm_row(a, b);
    __syncthreads();
  }

  // A: the w13 GEMV's slices; the last slice of each row block to arrive
  // writes the block's GLU columns and releases them
  for (int it = blockIdx.x; it < items_a; it += gridDim.x) {
    const int blk = it / a.split_a, z = it - blk * a.split_a;
    ffn_item<WT, NT, true>(a, blk, z, false, smem);
    __syncthreads();
  }
  stamp(a, 1);

  // B: the w2 GEMV's slices, slice-major (slice z reads GLU columns whose
  // row blocks the A items of the first wave finish first), from the far
  // end of the grid (its blocks hold the fewest A items); each item waits
  // for the A row blocks its columns lie in; the last slice of each row
  // block to arrive sums them
  bool first = true;
  for (int it = gridDim.x - 1 - blockIdx.x; it < items_b; it += gridDim.x) {
    const int z = it / rows_b, blk = it - z * rows_b;
    ffn_item<WT, NT, false>(a, blk, z, first, smem);
    first = false;
    __syncthreads();
  }
  stamp(a, 3);

  // the last block out: every block is past every wait, so the flags go
  // back to 0 for the next call (a graph's replay included), a thread each
  __shared__ int out_last;
  if (threadIdx.x == 0) out_last = atomicInc(a.exits, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (out_last) {
    for (int i = threadIdx.x; i < rows_a; i += THREADS) a.glu_done[i] = 0;
    if (threadIdx.x == 0) *a.norm_done = 0;
  }
}

template <int WT, int NT>
int launch_ffn(const FfnArgs& a, int grid, cudaStream_t st) {
  constexpr int COLS = Layout<WT>::COLS;
  const size_t smem =
      (size_t)a.nb * (std::max(a.kchunk_a, a.kchunk_b) * COLS + XPAD) * sizeof(__nv_bfloat16);
  if (smem > 227 * 1024 - 1024) return ERR_ARGS;
  return launch_cooperative<ffn_kernel<WT, NT>>(a, smem, grid, THREADS, st);
}

template <int WT>
int launch_wt(const FfnArgs& a, int grid, cudaStream_t st) {
  return a.nb <= 8 ? launch_ffn<WT, 1>(a, grid, st) : launch_ffn<WT, 2>(a, grid, st);
}

}  // namespace

// ffn_l / ffn4_l in one cooperative launch (the file comment). The wrapper
// (ops/cuda/ffn.py) checks types, shapes, contiguity and alignment and lays
// out the scratch (ffn_plan): the normed rows (nb x K bf16), a_part and
// b_part (unused where the phase's split is 1), the GLU rows (nb x H
// bf16), each 16-byte aligned, and counters (w13 row blocks of arrivals, as
// many flags, w2 row blocks of arrivals, the normed rows, one exit count)
// uint32 zeros, left at 0 again. wtype: the
// weight type of both matrices; for W_I4 scale13/scale2 are the group
// scales ((L, K / group13, 2H), (L, H / group2, K)), else per-row scales
// or null. The plans: w13's and w2's gemv_plan (kchunk, split). grid: the blocks asked for (no more than fit on the card are launched).
// stamps: null, or (grid, 4) uint64 for the phase bounds' times (stamp()).
// Returns 0, a cudaError_t (cudaErrorCooperativeLaunchTooLarge when the
// grid cannot be co-resident), or ERR_ARGS.
extern "C" int yt_ffn(int wtype, const void* w13, const void* w2, const float* x, int nb,
                      const float* norm_w, float eps, const float* scale13, const float* scale2,
                      int group13, int group2, int act, const float* residual, float* out,
                      void* xn, float* a_part, void* glu, float* b_part, unsigned* counters,
                      unsigned long long* stamps, int L, int layer, int K, int H, int kchunk_a,
                      int split_a, int kchunk_b, int split_b, int grid, void* stream) {
  const bool i4 = wtype == W_I4;
  if (wtype < W_F32 || wtype > W_I4 || nb < 1 || nb > 16 || K < 4 || K % 4 || H < 4 || H % 4 ||
      L < 1 || layer < 0 || layer >= L || (act != 0 && act != 1) || grid < 1)
    return ERR_ARGS;
  if (!w13 || !w2 || !x || !norm_w || !out || !xn || !glu || !counters ||
      (split_a > 1 && !a_part) || (split_b > 1 && !b_part) ||
      (i4 && (!scale13 || !scale2)))
    return ERR_ARGS;
  if (!gemv::plan_ok(wtype, K, group13, kchunk_a, split_a) ||
      !gemv::plan_ok(wtype, H, group2, kchunk_b, split_b))
    return ERR_ARGS;
  FfnArgs a{};
  a.w13 = w13;
  a.w2 = w2;
  a.x = x;
  a.norm_w = norm_w;
  a.scale13 = i4 ? nullptr : scale13;
  a.scale2 = i4 ? nullptr : scale2;
  a.gs13 = i4 ? scale13 : nullptr;
  a.gs2 = i4 ? scale2 : nullptr;
  a.residual = residual;
  a.out = out;
  a.xn = static_cast<__nv_bfloat16*>(xn);
  a.a_part = reinterpret_cast<float4*>(a_part);
  a.glu = static_cast<__nv_bfloat16*>(glu);
  a.b_part = reinterpret_cast<float4*>(b_part);
  const int rows_a = (H + ROWS / 2 - 1) / (ROWS / 2), rows_b = (K + ROWS - 1) / ROWS;
  a.a_ctr = counters;
  a.glu_done = counters + rows_a;
  a.b_ctr = counters + 2 * rows_a;
  a.norm_done = counters + 2 * rows_a + rows_b;
  a.exits = a.norm_done + 1;
  a.stamps = stamps;
  a.eps = eps;
  a.act = act;
  a.layer = layer;
  a.K = K;
  a.H = H;
  a.nb = nb;
  a.g13 = group13;
  a.g2 = group2;
  a.kchunk_a = kchunk_a;
  a.split_a = split_a;
  a.kchunk_b = kchunk_b;
  a.split_b = split_b;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wtype) {
    case W_F32: return launch_wt<W_F32>(a, grid, st);
    case W_BF16: return launch_wt<W_BF16>(a, grid, st);
    case W_E5M2: return launch_wt<W_E5M2>(a, grid, st);
    case W_I8: return launch_wt<W_I8>(a, grid, st);
    default: return launch_wt<W_I4>(a, grid, st);
  }
}
