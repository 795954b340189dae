// Dequant GEMM over layer-stacked weights:
//   Y[m, n] = sum_k bf16(X[m, k]) * bf16(W[layer, expert, n, k])  (f32 accumulate)
//             (* scale[layer, expert, n]) (+ residual[m, n])
//   or, for the GLU pair:  Y[m, p] = bf16(act(h1[m, p]) * h3[m, p])
//
// gemm_kernel replaces yalm_tpu/ops/pallas/gemv.py:gemm_l (:426, its
// pallas_call :493; and :gemm, its 2-D form) and the MoE gemm_le (:344,
// pallas_call :407): the prefill chunk projections (M = 16/64/256 rows
// against one weight stream), the batched tick's projections at M = batch
// rows, and the all-expert sweep. Every tile is addressed at (layer,
// expert), so only that expert's bytes are read and no copy of it is made
// (a dense stack is E = 1, expert 0). The expert comes from the host or a
// device int64; an id outside [0, E) reads nothing and gives NaN.
// The same kernel replaces :gemm4_l (:600, pallas_call :670; and :gemm4)
// and :gemm4_le (:688, pallas_call :750) for packed int4 weights (W_I4,
// below). Weight types f32, bf16, e5m2 and int8 with per-row scales on the
// f32 result, K % 32 == 0; packed int4 with group scales on each group's
// f32 partial, K % 256 == 0; any M >= 1, any N >= 1 (the MoE router has
// N = 8).
//
// Epilogues: + residual[m, n]; or the GLU pair, which makes the kernel the
// two weight sweeps of ops/pallas/ffn.py:ffn_l for any number of rows (the
// GEMV route takes <= 8): rows p and H + p of W13 give h1, h3 (each * its
// scale) and Y[m, p] = bf16(act(h1) * h3), (M, H). rmsnorm_rows_kernel is
// that route's prologue (ffn.py:46-50), round_rows_kernel every gemm_l's:
// it rounds X to bf16 once (gemv.py:476 rounds each tile as it reads it).
//
// Bound on this card: the weight bytes at M <= ~128 (a Mistral-7B w2 is 59
// MB of e5m2, 0.0176 ms at 3.35 TB/s); the bf16 tensor cores at M = 256 for
// w13 (60 GFLOP, 0.061 ms at 989 TFLOP/s, against 0.035 ms of bytes).
//
// The design (Hopper, sm_90a). The product is computed transposed,
// Y^T = W . X^T, so the weights are wgmma's A operand and the tokens its N:
// - A block owns 128 weight rows, two warpgroups of 64 (wgmma's M), and Mt
//   tokens (wgmma's N): 16, 32, 64, 128 or 256, the smallest that holds M
//   (128 where N is narrow and 256 would starve the grid;
//   ops/cuda/gemv.py:gemm_plan). Each warpgroup runs
//   wgmma.mma_async.m64n{Mt}k16.f32.bf16.bf16 with A FROM REGISTERS: each
//   thread widens its fragment (rows g and g+8 of its warp's 16-row slab,
//   k pairs 2t and 2t+8, mma.sync's m16n8k16 A layout) straight from the
//   raw weight bytes in shared memory -- e5m2 as the high byte of an f16
//   (exact in bf16), int8 exact, bf16 as it is, f32 rounded to nearest
//   even -- so no widened weight tile is ever written back in a wgmma
//   layout. X, already bf16, is the B operand in shared memory, K-major:
//   a stage holds 64 K, so a token's row is 128 bytes, and 16-byte cp.async
//   writes it straight into wgmma's 128-byte swizzle (chunk c of token r at
//   r*128 + (c ^ r%8)*16; SBO 1024 between groups of 8 tokens; a k16 step
//   starts 32 bytes on), so the tensor cores' reads of B spread over the
//   banks.
// - Loads go through a ring of 3-6 stages of 64 K: 128 weight rows of raw
//   bytes (rows padded by 16 bytes, so the fragment reads hit 8 distinct
//   banks) and Mt rows of X; at up to 64 tokens two blocks share an SM.
//   Every warp both loads and computes: a stage's copies land, a barrier,
//   the fragments are widened, the four wgmmas issued, and while they run
//   the stage STAGES - 1 ahead is requested; then the wgmmas retire (ptxas
//   serializes register-A wgmmas whose fragments are written while one is
//   in flight, so no later stage's widening overlaps them). Ragged K (a
//   multiple of 32, not of 64), ragged rows and ragged tokens zero-fill in
//   the copy; stores are masked.
// - GLU blocks own 64 pairs: within warp w's slab, rows 0-7 hold h1 of
//   pairs p0+8w..p0+8w+7 (W13 rows p) and rows 8-15 their h3 (W13 rows
//   H+p), so a thread's accumulator rows g and g+8 are h1 and h3 of pair
//   p0+8w+g for the same tokens (ops/cuda/gemv.py:glu_rows mirrors it).
// - Split K where the grid would starve (fewer than ~132 blocks, e.g. w2,
//   wo and wqkv at M 16): blockIdx.z takes `kchunk` stages of K; each slice
//   writes its f32 tile to scratch, and the last slice to arrive (a
//   per-tile counter that atomicInc wraps back to 0) sums the slices in
//   slice order and runs the epilogue: the same bits on every call, no f32
//   atomics on the output.
// - Packed int4 (W_I4; byte t of a group of `group` columns holds column t
//   in its low nibble and t + group/2 in its high one, offset 8): a stage
//   holds P packed bytes of each weight row (bytes P*kt.., P = 128 up to
//   32 tokens, else 64) and the 2P X columns they multiply, in a
//   "virtual" order: the P low nibbles' columns g*group + b0 + j, then the
//   high nibbles' g*group + group/2 + b0 + j (b0 the stage's byte offset
//   in its group), in 128-byte swizzled atoms of 64 columns; a dot product
//   does not care about the order of its terms, so every weight byte is
//   read once (ops/cuda/gemv.py:gemm4_stage_cols mirrors it). One 2-byte
//   fragment read gives a k16 step's low nibbles and, four steps on, its
//   high ones; a nibble ORed into 0x4300 is the bf16 of 128 + q, and one
//   bf16x2 subtraction of 136 gives q - 8 exactly. A group sums into a
//   fresh accumulator (wgmma's scale-d is 0 on its first k16 step); once
//   its last stage retires, the group's scale multiplies that f32 partial
//   into the thread's sum, as gemv.py:583-596 does (folded into the bf16
//   weights, it would be rounded with them). Two accumulators of Mt/2
//   floats cap the token tile at 128; K splits at group boundaries only,
//   for two blocks per SM where the grid starves (the short stages are
//   latency-bound, not byte-bound: PERF.md §6).
// Against what held the mma.sync designs (gemm_kernel_v1, gemm4_kernel_v1)
// back: the loads were synchronous (now a cp.async ring), X was f32 and
// rounded again in every block of every N tile (now bf16, rounded once),
// the grid starved at small M and narrow N (now 16-token tiles and split
// K), and mma.sync is not the card's full tensor-core rate (now wgmma).
// Not yet: TMA, a producer warp, setmaxnreg, a persistent grid, clusters.
#include "common.cuh"

using namespace yt;

namespace {

constexpr int BM = 64, BN = 128, BK = 32, PAD = 8, THREADS = 256;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// gemm_kernel_v1 / gemm4_kernel_v1: the W row staged at row r (0..BN-1) of
// the tile that starts at n0, and whether it exists. Plain tiles: rows
// n0..n0+BN-1 of N. GLU tiles (n0 a pair index, H = N/2 pairs): warp column
// w holds W13 rows n0+16w..n0+16w+15 (h1) in its first 16 tile rows and the
// matching H + n rows (h3) in its last 16, so each thread's mma fragments
// hold both halves of its pairs.
template <bool GLU>
__device__ __forceinline__ int tile_row(int n0, int r, int N, bool* ok) {
  if (!GLU) {
    *ok = n0 + r < N;
    return n0 + r;
  }
  const int H = N / 2, w = r >> 5, j = r & 31, p = n0 + 16 * w + (j & 15);
  *ok = p < H;
  return j < 16 ? p : H + p;
}

struct GemmArgs {
  const void* w;          // (L, E, N, K) of the weight type; int4: (L, E, N, K/2) packed
  const float* x;         // (M, K) (gemm_kernel_v1, gemm4_kernel_v1)
  const float* scale;     // (L, E, N) per-row scales, or null
  const float* gscale;    // (L, E, K / group, N) int4 group scales
  const float* residual;  // (M, N) or null (not with the GLU pair)
  float* y;               // (M, N), or (M, N/2) for the GLU pair
  const long long* expert_id;  // device expert id, or null: `expert` is used
  int layer, E, expert, M, N, K, group, act;
  const __nv_bfloat16* xh;  // (M, K) bf16 (gemm_kernel)
};

// The (layer, expert) matrix index of this launch, or false for an expert
// id outside [0, E) (a dense stack is E = 1, expert 0).
__device__ __forceinline__ bool routed(const GemmArgs& a, size_t* le) {
  const long long e = a.expert_id ? *a.expert_id : a.expert;
  *le = (size_t)a.layer * a.E + (size_t)e;
  return e >= 0 && e < a.E;
}

// NaN over this block's output tile (n0: first column, or pair for GLU).
template <bool GLU>
__device__ void nan_tile(const GemmArgs& a, int m0, int n0) {
  constexpr int cols = GLU ? BN / 2 : BN;
  const int n_out = GLU ? a.N / 2 : a.N;
  for (int i = threadIdx.x; i < BM * cols; i += THREADS) {
    const int r = m0 + i / cols, c = n0 + i % cols;
    if (r < a.M && c < n_out) a.y[(size_t)r * n_out + c] = __int_as_float(0x7fc00000);
  }
}

// The epilogue of one thread's 2 x 4 fragments (acc[mi][ni][e]: row
// wm*32 + mi*16 + g + 8*(e>>1), tile column wn*32 + ni*8 + 2t + (e&1)).
template <bool GLU>
__device__ __forceinline__ void store(const GemmArgs& a, float (&acc)[2][4][4], size_t le,
                                      int m0, int n0, int wm, int wn, int g, int t) {
  const size_t srow = le * a.N;
  if (GLU) {
    const int H = a.N / 2;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + wm * 32 + mi * 16 + g + 8 * (e >> 1);
          const int p = n0 + 16 * wn + ni * 8 + 2 * t + (e & 1);
          if (r < a.M && p < H) {
            float h1 = acc[mi][ni][e], h3 = acc[mi][ni + 2][e];
            if (a.scale) {
              h1 *= a.scale[srow + p];
              h3 *= a.scale[srow + H + p];
            }
            a.y[(size_t)r * H + p] = bf16_round(glu_act(h1, a.act) * h3);
          }
        }
    return;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * 32 + mi * 16 + g + 8 * (e >> 1);
        const int c = n0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (r < a.M && c < a.N) {
          float v = acc[mi][ni][e];
          if (a.scale) v *= a.scale[srow + c];
          if (a.residual) v += a.residual[(size_t)r * a.N + c];
          a.y[(size_t)r * a.N + c] = v;
        }
      }
}

// first output column (or pair) of this block's tile
template <bool GLU>
__device__ __forceinline__ int tile_n0() {
  return blockIdx.y * (GLU ? BN / 2 : BN);
}

// The design gemm_kernel replaced, kept only as chip_smoke.py's same-run
// yardstick (yt_gemm_v1): 64 x 128 output tiles (M x N), 8 warps each
// owning 32 x 32 through mma.sync.m16n8k16 bf16; each 32-wide K step stages
// X (rounded to bf16 from f32) and W (widened to bf16) in padded shared
// memory with plain loads, then computes. The M tiles of one N tile are
// neighbours in the grid so they share the weight tile through L2.
template <int WT, bool GLU>
__global__ void __launch_bounds__(THREADS) gemm_kernel_v1(GemmArgs a) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM][BK + PAD];
  __shared__ __align__(16) __nv_bfloat16 ws[BN][BK + PAD];
  using C = WChunk<WT>;
  constexpr int PER = C::PER16;
  constexpr int CPR = BK / PER;  // 16-byte weight chunks per tile row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  const int g = lane >> 2, t = lane & 3;
  const int M = a.M, N = a.N, K = a.K;
  const int m0 = blockIdx.x * BM, n0 = tile_n0<GLU>();
  size_t le;
  if (!routed(a, &le)) {
    nan_tile<GLU>(a, m0, n0);
    return;
  }
  const size_t row_chunks = (size_t)K / PER;
  const uint4* wl = reinterpret_cast<const uint4*>(a.w) + le * N * row_chunks;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK / 4; i += THREADS) {
      const int r = i / (BK / 4), c4 = i % (BK / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M)
        v = *reinterpret_cast<const float4*>(a.x + (size_t)(m0 + r) * K + k0 + 4 * c4);
      *reinterpret_cast<__nv_bfloat162*>(&xs[r][4 * c4]) = __floats2bfloat162_rn(v.x, v.y);
      *reinterpret_cast<__nv_bfloat162*>(&xs[r][4 * c4 + 2]) = __floats2bfloat162_rn(v.z, v.w);
    }
    for (int i = tid; i < BN * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      bool ok;
      const int wr = tile_row<GLU>(n0, r, N, &ok);
      float f[PER];
      if (ok) {
        C::unpack(__ldg(wl + (size_t)wr * row_chunks + k0 / PER + c), f);
      } else {
#pragma unroll
        for (int j = 0; j < PER; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < PER; j += 2)
        *reinterpret_cast<__nv_bfloat162*>(&ws[r][c * PER + j]) = __floats2bfloat162_rn(f[j], f[j + 1]);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        af[mi][0] = ld32(&xs[r][kk + 2 * t]);
        af[mi][1] = ld32(&xs[r + 8][kk + 2 * t]);
        af[mi][2] = ld32(&xs[r][kk + 2 * t + 8]);
        af[mi][3] = ld32(&xs[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + g;
        bfr[ni][0] = ld32(&ws[c][kk + 2 * t]);
        bfr[ni][1] = ld32(&ws[c][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }
  store<GLU>(a, acc, le, m0, n0, wm, wn, g, t);
}

// The int4 design gemm_kernel replaced, kept only as chip_smoke.py's
// same-run yardstick (yt_gemm4_v1). Packed int4 weights (L, N, K/2) with
// group scales (L, G, N):
//   Y[m, n] = sum_g gscale[layer, g, n] * sum_{k in g} bf16(X[m, k]) * (q[n, k] - 8)
// Same tiles and mma.sync as gemm_kernel_v1. Each K step takes 32 packed bytes
// of every row of the tile -- 64 columns, 32 low nibbles and the 32 high
// nibbles group/2 columns further on -- and stages them, with the matching
// 64 columns of X, in one "virtual" 64-wide order (a dot product does not
// care about the order of its terms), so every weight byte is read once.
// Each group sums into a fresh fragment `part`; at the group's end
// acc += part * gscale[g, n] (the scale multiplies the f32 partial).
constexpr int BK4 = 64;

template <bool GLU>
__global__ void __launch_bounds__(THREADS) gemm4_kernel_v1(GemmArgs a) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM][BK4 + PAD];
  __shared__ __align__(16) __nv_bfloat16 ws[BN][BK4 + PAD];
  using C = WChunk<W_I4>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g8 = lane >> 2, t = lane & 3;
  const int M = a.M, N = a.N, K = a.K, group = a.group;
  const int m0 = blockIdx.x * BM, n0 = tile_n0<GLU>();
  size_t le;
  if (!routed(a, &le)) {
    nan_tile<GLU>(a, m0, n0);
    return;
  }
  const int G = K / group, half = group / 2;  // half: packed bytes of a group row
  const size_t row_bytes = (size_t)K / 2;
  const uint8_t* wl = static_cast<const uint8_t*>(a.w) + le * N * row_bytes;
  const float* gl = a.gscale + le * G * N;

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;

    for (int b0 = 0; b0 < half; b0 += BK4 / 2) {
      // virtual column v = 32 * c + j: c picks the 16-byte chunk at byte
      // b0 + 16c of the group, j < 16 its low nibbles (column b0 + 16c + j
      // of the group), j >= 16 its high nibbles (column half + b0 + 16c + j - 16)
      for (int i = tid; i < BM * BK4 / 4; i += THREADS) {
        const int r = i / (BK4 / 4), v = 4 * (i % (BK4 / 4));
        const int c = v >> 5, j = v & 31;
        const int col = g * group + b0 + 16 * c + (j < 16 ? j : half + j - 16);
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + r < M) val = *reinterpret_cast<const float4*>(a.x + (size_t)(m0 + r) * K + col);
        *reinterpret_cast<__nv_bfloat162*>(&xs[r][v]) = __floats2bfloat162_rn(val.x, val.y);
        *reinterpret_cast<__nv_bfloat162*>(&xs[r][v + 2]) = __floats2bfloat162_rn(val.z, val.w);
      }
      for (int i = tid; i < BN * 2; i += THREADS) {
        const int r = i >> 1, c = i & 1;
        bool ok;
        const int wr = tile_row<GLU>(n0, r, N, &ok);
        float f[C::PER16];
        if (ok) {
          C::unpack(__ldg(reinterpret_cast<const uint4*>(
                        wl + (size_t)wr * row_bytes + (size_t)g * half + b0 + 16 * c)), f);
        } else {
#pragma unroll
          for (int j = 0; j < C::PER16; ++j) f[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < C::PER16; j += 2)
          *reinterpret_cast<__nv_bfloat162*>(&ws[r][32 * c + j]) =
              __floats2bfloat162_rn(f[j], f[j + 1]);
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < BK4; kk += 16) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + g8;
          af[mi][0] = ld32(&xs[r][kk + 2 * t]);
          af[mi][1] = ld32(&xs[r + 8][kk + 2 * t]);
          af[mi][2] = ld32(&xs[r][kk + 2 * t + 8]);
          af[mi][3] = ld32(&xs[r + 8][kk + 2 * t + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = wn * 32 + ni * 8 + g8;
          bfr[ni][0] = ld32(&ws[c][kk + 2 * t]);
          bfr[ni][1] = ld32(&ws[c][kk + 2 * t + 8]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(part[mi][ni], af[mi], bfr[ni]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        bool ok;
        const int wr = tile_row<GLU>(n0, wn * 32 + ni * 8 + 2 * t + e1, N, &ok);
        const float s = ok ? __ldg(gl + (size_t)g * N + wr) : 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[mi][ni][e1] = fmaf(part[mi][ni][e1], s, acc[mi][ni][e1]);
          acc[mi][ni][2 + e1] = fmaf(part[mi][ni][2 + e1], s, acc[mi][ni][2 + e1]);
        }
      }
  }
  store<GLU>(a, acc, le, m0, n0, wm, wn, g8, t);
}

// The FFN route's prologue: one block per row,
//   out[m, k] = bf16(x[m, k] * rsqrt(mean(x[m]^2) + eps) * norm_w[layer, k])
// as f32 (ffn.py:46-50), the sum of squares in f32 as csrc/gemv.cu's norm.
__global__ void __launch_bounds__(THREADS)
rmsnorm_rows_kernel(const float* __restrict__ x, const float* __restrict__ norm_w,
                    float* __restrict__ out, int K, float eps) {
  __shared__ float part[THREADS / 32];
  const float* xr = x + (size_t)blockIdx.x * K;
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += THREADS) ss = fmaf(xr[k], xr[k], ss);
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) tot += part[i];
  const float rs = 1.0f / sqrtf(tot / (float)K + eps);
  float* orow = out + (size_t)blockIdx.x * K;
  for (int k = threadIdx.x; k < K; k += THREADS) orow[k] = bf16_round(xr[k] * rs * norm_w[k]);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// gemm_kernel's X, rounded to bf16 once per launch (to nearest even, as
// torch's cast does): n4 float4s in, n4 x 4 bf16 out.

__global__ void __launch_bounds__(THREADS)
round_rows_kernel(const float4* __restrict__ x, uint2* __restrict__ out, long long n4) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    const float4 v = x[i];
    out[i] = make_uint2(bits(__floats2bfloat162_rn(v.x, v.y)), bits(__floats2bfloat162_rn(v.z, v.w)));
  }
}

// ---------------------------------------------------------------------------
// gemm_kernel: wgmma with the widened weights in registers (file comment)
// ---------------------------------------------------------------------------

constexpr int KT = 64;    // K per ring stage: four k16 steps
constexpr int WR = 128;   // weight rows per block: two warpgroups of 64
constexpr int SMEM_CAP = 226 * 1024;   // of 227 KB: the rest static

// int4 ring stages hold 128 packed bytes of a weight row up to 32 tokens
// (whole 128-byte lines, half as many stages: faster on the card, PERF.md
// §6), else 64 (ops/cuda/gemv.py:gemm4_stage_bytes).
constexpr int i4_stage_bytes(int mt) { return mt <= 32 ? 2 * KT : KT; }

// A weight row's bytes per stage column (int4: per packed byte, two weights).
template <int WT> constexpr int col_bytes() {
  if constexpr (WT == W_I4)
    return 1;
  else
    return WChunk<WT>::BYTES;
}

// A stage: X's Mt rows of 128 bytes (128-byte swizzled; int4: 2 * KB / 64
// such atoms, the low nibbles' columns, then the high ones'), then the
// weight rows of KB bytes (padded by 16 bytes). Up to 64 tokens two blocks
// share an SM, when three stages each fit; past that one block takes the
// SM.
template <int WT, int MT> struct Ring {
  static constexpr bool I4 = WT == W_I4;
  static constexpr int BYTES = col_bytes<WT>();
  static constexpr int KB = I4 ? i4_stage_bytes(MT) : KT * BYTES;
  static constexpr int WROW = KB + 16;
  static constexpr int XATOM = MT * KT * 2;
  static constexpr int XST = (I4 ? KB / 32 : 1) * XATOM;
  static constexpr int STAGE = XST + WR * WROW;
  static constexpr int FIT2 = (SMEM_CAP / 2 - 2048) / STAGE;
  static constexpr int BLOCKS = MT <= 64 && FIT2 >= 3 ? 2 : 1;
  static constexpr int FIT = BLOCKS == 2 ? FIT2 : SMEM_CAP / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + the 1024-byte alignment
  static_assert(STAGE % 1024 == 0 && STAGES >= 3, "a ring of 1024-aligned stages, three at least");
};

// src-size 0 reads nothing and fills the 16 bytes with zeros. L2::128B:
// a stage reads 64 bytes of an e5m2 row, and the next stage's 64 come from
// DRAM in the same 128-byte request.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the copies' shared-memory writes, before wgmma reads them (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching an accumulator across wgmma_wait.
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The B descriptor of a K-major operand in 128-byte swizzled rows at
// shared address `saddr` (a k16 step: + 32 bytes from the 1024-aligned
// stage): SBO 1024 bytes (8 tokens to the next 8), LBO unused (1),
// layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x N, f32) = a (64 x 16 bf16, this thread's fragment in 4
// registers) * b (16 x N bf16 in shared memory, K-major) + d, or + 0 where
// sd (wgmma's scale-d) is 0: one wgmma.mma_async per warpgroup.
template <int N> struct Wgmma;

template <> struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};

template <> struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};

template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};

template <> struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};

template <> struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                             int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};

// Two consecutive weights of a staged row as one bf16x2 fragment register
// (the lower k in the low half).
template <int WT> __device__ __forceinline__ uint32_t a_pair(const uint8_t* p);

template <> __device__ __forceinline__ uint32_t a_pair<W_E5M2>(const uint8_t* p) {
  const uint32_t b = *reinterpret_cast<const uint16_t*>(p);
  uint32_t h = __byte_perm(b, 0u, 0x1404);   // each byte the high byte of an f16
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return bits(__floats2bfloat162_rn(f.x, f.y));
}

template <> __device__ __forceinline__ uint32_t a_pair<W_I8>(const uint8_t* p) {
  const uint32_t b = *reinterpret_cast<const uint16_t*>(p);
  return bits(__floats2bfloat162_rn((float)(int8_t)(b & 0xffu), (float)(int8_t)(b >> 8)));
}

template <> __device__ __forceinline__ uint32_t a_pair<W_BF16>(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <> __device__ __forceinline__ uint32_t a_pair<W_F32>(const uint8_t* p) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  return bits(__floats2bfloat162_rn(f.x, f.y));
}

__device__ __forceinline__ __nv_bfloat162 bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// Two consecutive packed int4 bytes of a staged row as two fragment
// registers: *lo their low nibbles (a k16 step's pair), *hi their high ones
// (the same pair of the step four on). A nibble q ORed into 0x4300 is the
// bf16 bits of 128 + q; minus 136 that is q - 8, exact in bf16 (no
// int-to-float convert).
__device__ __forceinline__ void i4_pairs(const uint8_t* p, uint32_t* lo, uint32_t* hi) {
  // byte j of the pair at bit 16j
  const uint32_t b = __byte_perm(*reinterpret_cast<const uint16_t*>(p), 0u, 0x4140);
  const __nv_bfloat162 off = bf162(0x43084308u);   // 136, 136
  *lo = bits(__hsub2(bf162((b & 0x000f000fu) | 0x43004300u), off));
  *hi = bits(__hsub2(bf162(((b >> 4) & 0x000f000fu) | 0x43004300u), off));
}

// The weight row staged at row r (0..WR-1) of the block whose first row
// (GLU: first pair) is n0, and whether it exists; GLU: the file comment's map.
template <bool GLU>
__device__ __forceinline__ int wrow(int n0, int r, int N, bool* ok) {
  if (!GLU) {
    *ok = n0 + r < N;
    return n0 + r;
  }
  const int H = N / 2, j = r & 15, p = n0 + 8 * (r >> 4) + (j & 7);
  *ok = p < H;
  return j < 8 ? p : H + p;
}

// Stage `kt` (K columns 64kt..64kt+63; int4: packed bytes KB*kt.. of each
// row and their 2 * KB X columns, the file comment's virtual order) of X and
// of the block's weight rows into the ring slot at shared address dst.
template <int WT, int MT, bool GLU>
__device__ __forceinline__ void load_stage(const GemmArgs& a, const uint8_t* wl, uint32_t dst,
                                           int m0, int n0, int kt) {
  using R = Ring<WT, MT>;
  constexpr int CPR = R::KB / 16;   // 16-byte chunks of a weight row
  if constexpr (R::I4) {
    // Chunk c of a token's row: X columns c0 + 8c (c < KB/8, the low
    // nibbles'), or c0 + group/2 + 8(c - KB/8) (the high ones'); atom c / 8.
    // The copy loops stay rolled where two blocks share an SM (128
    // registers: unrolled, their 64-bit addresses spill) and unroll where
    // one block has it (both faster on the card, PERF.md §6).
    constexpr int XC = R::KB / 4;   // 16-byte chunks of a token's row
    constexpr int NX = MT * XC / THREADS, NW = WR * CPR / THREADS;
    static_assert(NX * THREADS == MT * XC && NW * THREADS == WR * CPR, "whole copy rounds");
    const int spg = a.group / (2 * R::KB), c0 = kt / spg * a.group + kt % spg * R::KB;
#pragma unroll(R::BLOCKS == 2 ? 1 : NX)
    for (int j = 0; j < NX; ++j) {
      const int i = threadIdx.x + j * THREADS, r = i / XC, c = i % XC;
      const bool ok = m0 + r < a.M;
      const int col = c0 + 8 * c + (c < XC / 2 ? 0 : a.group / 2 - R::KB);
      cp_async16(dst + (c >> 3) * R::XATOM + r * 128 + (((c & 7) ^ (r & 7)) << 4),
                 ok ? a.xh + (size_t)(m0 + r) * a.K + col : a.xh, ok);
    }
#pragma unroll(R::BLOCKS == 2 ? 1 : NW)
    for (int j = 0; j < NW; ++j) {
      const int i = threadIdx.x + j * THREADS, r = i / CPR, c = i % CPR;
      bool ok;
      const int wr = wrow<GLU>(n0, r, a.N, &ok);
      cp_async16(dst + R::XST + r * R::WROW + 16 * c,
                 ok ? wl + (size_t)wr * (a.K / 2) + (size_t)kt * R::KB + 16 * c : wl, ok);
    }
  } else {
    constexpr int PER = 16 / R::BYTES;   // weights per chunk
    const int k0 = kt * KT;
    for (int i = threadIdx.x; i < MT * 8; i += THREADS) {
      const int r = i >> 3, c = i & 7;
      const bool ok = m0 + r < a.M && k0 + 8 * c < a.K;
      cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),   // the 128-byte swizzle
                 ok ? a.xh + (size_t)(m0 + r) * a.K + k0 + 8 * c : a.xh, ok);
    }
    for (int i = threadIdx.x; i < WR * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      bool ok;
      const int wr = wrow<GLU>(n0, r, a.N, &ok);
      ok = ok && k0 + PER * c < a.K;   // K % 32 == 0: a chunk is all in or all out
      cp_async16(dst + R::XST + r * R::WROW + 16 * c,
                 ok ? wl + ((size_t)wr * a.K + k0 + PER * c) * R::BYTES : wl, ok);
    }
  }
}

// Stage i of the slice (its copies in flight): wait for it, widen this
// thread's A fragments from the raw weights, issue the stage's k16 wgmmas
// into d, and while they run refill the slot of stage i - 1 (retired before
// the barrier) with stage i + STAGES - 1. The wgmmas retire before the
// return: fragments written by other instructions while a wgmma is in
// flight make ptxas serialize them anyway. int4: each 64 packed bytes of a
// row give eight k16 steps (low nibbles, then high), widened and issued in
// turn; the first wgmma of a group's first stage (`fresh`) has scale-d 0.
template <int WT, int MT, bool GLU>
__device__ __forceinline__ void ring_step(const GemmArgs& a, const uint8_t* wl, uint32_t sb,
                                          const uint8_t* frag, int m0, int n0, int kt0, int n,
                                          int i, float (&d)[MT / 2], bool fresh) {
  using R = Ring<WT, MT>;
  cp_async_wait<R::STAGES - 2>();   // stage i has landed (this thread's copies)
  fence_proxy_async();
  __syncthreads();                  // ... every thread's; stage i - 1's slot is free
  const int st = i % R::STAGES;
  const uint8_t* p = frag + st * R::STAGE;
  if constexpr (R::I4) {
#pragma unroll
    for (int hb = 0; hb < R::KB / 64; ++hb) {
      uint32_t af[8][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint8_t* q = p + 64 * hb + 16 * s;
        i4_pairs(q, &af[s][0], &af[s + 4][0]);                          // row g, k 2t
        i4_pairs(q + 8 * R::WROW, &af[s][1], &af[s + 4][1]);            // row g + 8
        i4_pairs(q + 8, &af[s][2], &af[s + 4][2]);                      // row g, k 2t + 8
        i4_pairs(q + 8 * R::WROW + 8, &af[s][3], &af[s + 4][3]);        // row g + 8, k 2t + 8
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int atom = s < 4 ? hb : R::KB / 64 + hb;   // low nibbles' X, or high
        Wgmma<MT>::mma(d, af[s], b_desc(sb + st * R::STAGE + atom * R::XATOM + 32 * (s & 3)),
                       s > 0 || hb > 0 || !fresh);
      }
      wgmma_commit();
      if (hb == 0) {
        const int next = i + R::STAGES - 1;
        if (next < n)
          load_stage<WT, MT, GLU>(a, wl, sb + (next % R::STAGES) * R::STAGE, m0, n0, kt0 + next);
        cp_async_commit();
      }
      wgmma_wait<0>();
    }
  } else {
    uint32_t af[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint8_t* q = p + 16 * s * R::BYTES;
      af[s][0] = a_pair<WT>(q);                                  // row g, k 2t
      af[s][1] = a_pair<WT>(q + 8 * R::WROW);                    // row g + 8
      af[s][2] = a_pair<WT>(q + 8 * R::BYTES);                   // row g, k 2t + 8
      af[s][3] = a_pair<WT>(q + 8 * R::WROW + 8 * R::BYTES);     // row g + 8, k 2t + 8
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) Wgmma<MT>::mma(d, af[s], b_desc(sb + st * R::STAGE + 32 * s));
    wgmma_commit();
    const int next = i + R::STAGES - 1;
    if (next < n)
      load_stage<WT, MT, GLU>(a, wl, sb + (next % R::STAGES) * R::STAGE, m0, n0, kt0 + next);
    cp_async_commit();
    wgmma_wait<0>();
  }
}

// NaN over this block's output tile (n0: first row, or pair for GLU).
template <int MT, bool GLU>
__device__ void nan_tile_h(const GemmArgs& a, int m0, int n0) {
  constexpr int cols = GLU ? WR / 2 : WR;
  const int n_out = GLU ? a.N / 2 : a.N;
  for (int i = threadIdx.x; i < MT * cols; i += THREADS) {
    const int m = m0 + i / cols, c = n0 + i % cols;
    if (m < a.M && c < n_out) a.y[(size_t)m * n_out + c] = __int_as_float(0x7fc00000);
  }
}

// The epilogue of one thread's accumulators: acc[4j + 2h + e] is weight
// row 16w + g + 8h of the block, token m0 + 8j + 2t + e.
template <int MT, bool GLU>
__device__ __forceinline__ void store_h(const GemmArgs& a, const float (&acc)[MT / 2], size_t le,
                                        int m0, int n0, int w, int g, int t) {
  const size_t srow = le * a.N;
  if constexpr (GLU) {
    const int H = a.N / 2, p = n0 + 8 * w + g;
    if (p >= H) return;
    const float s1 = a.scale ? a.scale[srow + p] : 1.f, s3 = a.scale ? a.scale[srow + H + p] : 1.f;
#pragma unroll
    for (int j = 0; j < MT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m < a.M)
          a.y[(size_t)m * H + p] =
              bf16_round(glu_act(acc[4 * j + e] * s1, a.act) * (acc[4 * j + 2 + e] * s3));
      }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 16 * w + g + 8 * h;
      if (n >= a.N) continue;
      const float s = a.scale ? a.scale[srow + n] : 1.f;
#pragma unroll
      for (int j = 0; j < MT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * j + 2 * t + e;
          if (m < a.M) {
            float v = acc[4 * j + 2 * h + e] * s;
            if (a.residual) v += a.residual[(size_t)m * a.N + n];
            a.y[(size_t)m * a.N + n] = v;
          }
        }
    }
  }
}

// grid (ceil(M / MT), row tiles, slices); 256 threads, two warpgroups.
template <int WT, int MT, bool GLU>
__global__ void __launch_bounds__(THREADS, (Ring<WT, MT>::BLOCKS))
gemm_kernel(GemmArgs a, int kchunk, float* __restrict__ scratch, unsigned* __restrict__ counter) {
  using R = Ring<WT, MT>;
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int last;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * (GLU ? WR / 2 : WR);
  const int S = gridDim.z, z = blockIdx.z;
  size_t le;
  if (!routed(a, &le)) {
    if (z == 0) nan_tile_h<MT, GLU>(a, m0, n0);
    return;
  }
  const int nk = R::I4 ? a.K / (2 * R::KB) : (a.K + KT - 1) / KT, kt0 = z * kchunk;
  const int n = min(nk, kt0 + kchunk) - kt0;   // this slice's stages (>= 1)
  const uint8_t* wl = static_cast<const uint8_t*>(a.w) +
                      le * (size_t)a.N * (R::I4 ? a.K / 2 : (size_t)a.K * R::BYTES);
  const uint32_t sb0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sb = (sb0 + 1023) & ~1023u;   // the swizzle's atoms sit at 1024-byte offsets

  float acc[MT / 2];
#pragma unroll
  for (int i = 0; i < MT / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < n) load_stage<WT, MT, GLU>(a, wl, sb + s * R::STAGE, m0, n0, kt0 + s);
    cp_async_commit();
  }
  // this thread's fragment row g of its warp's slab, at k 2t
  const uint8_t* frag = smem + (sb - sb0) + R::XST + (16 * w + g) * R::WROW + 2 * t * R::BYTES;
  if constexpr (R::I4) {
    // each group sums into gsum (cleared by its first wgmma); once the
    // group's last stage has retired, acc += gsum * the group's scale of
    // the thread's rows g and g + 8 (a slice starts on a group boundary)
    const int spg = a.group / (2 * R::KB);   // stages per group
    bool ok0, ok1;
    const int r0 = wrow<GLU>(n0, 16 * w + g, a.N, &ok0);
    const int r1 = wrow<GLU>(n0, 16 * w + g + 8, a.N, &ok1);
    const float* gs = a.gscale + le * (size_t)(a.K / a.group) * a.N;
    float gsum[MT / 2];
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) gsum[i] = 0.f;
    for (int i = 0; i < n; ++i) {
      const int kt = kt0 + i;
      const bool end = kt % spg == spg - 1;
      float s0 = 0.f, s1 = 0.f;
      if (end) {   // in flight under the stage's wgmmas
        if (ok0) s0 = __ldg(gs + (size_t)(kt / spg) * a.N + r0);
        if (ok1) s1 = __ldg(gs + (size_t)(kt / spg) * a.N + r1);
      }
      ring_step<WT, MT, GLU>(a, wl, sb, frag, m0, n0, kt0, n, i, gsum, kt % spg == 0);
      if (end) {
        fence_acc(gsum);
#pragma unroll
        for (int j = 0; j < MT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            acc[4 * j + e] = fmaf(gsum[4 * j + e], s0, acc[4 * j + e]);
            acc[4 * j + 2 + e] = fmaf(gsum[4 * j + 2 + e], s1, acc[4 * j + 2 + e]);
          }
      }
    }
  } else {
    for (int i = 0; i < n; ++i)
      ring_step<WT, MT, GLU>(a, wl, sb, frag, m0, n0, kt0, n, i, acc, false);
    fence_acc(acc);
  }

  if (S > 1) {
    // this slice's tile to scratch, in the threads' own order; the last
    // slice to arrive sums them all in slice order
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float4* part = reinterpret_cast<float4*>(scratch) + (size_t)tile * S * (THREADS * MT / 8);
#pragma unroll
    for (int q = 0; q < MT / 8; ++q)
      __stcg(part + ((size_t)z * (MT / 8) + q) * THREADS + tid,
             make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]));
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicInc(counter + tile, S - 1) == (unsigned)(S - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int q = 0; q < MT / 8; ++q) {
      float4 v = __ldcg(part + (size_t)q * THREADS + tid);
      for (int zz = 1; zz < S; ++zz) {
        const float4 u = __ldcg(part + ((size_t)zz * (MT / 8) + q) * THREADS + tid);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      acc[4 * q] = v.x;
      acc[4 * q + 1] = v.y;
      acc[4 * q + 2] = v.z;
      acc[4 * q + 3] = v.w;
    }
  }
  store_h<MT, GLU>(a, acc, le, m0, n0, w, g, t);
}

dim3 grid_of(int M, int N, bool glu) {
  return dim3((M + BM - 1) / BM, glu ? (N / 2 + BN / 2 - 1) / (BN / 2) : (N + BN - 1) / BN);
}

template <int WT>
int launch_v1(const GemmArgs& a, bool glu, cudaStream_t st) {
  if (glu)
    gemm_kernel_v1<WT, true><<<grid_of(a.M, a.N, true), THREADS, 0, st>>>(a);
  else
    gemm_kernel_v1<WT, false><<<grid_of(a.M, a.N, false), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int WT, int MT, bool GLU>
int launch_h(const GemmArgs& a, int kchunk, float* scratch, unsigned* counter, cudaStream_t st) {
  using R = Ring<WT, MT>;
  static unsigned ready = 0;   // devices whose shared-memory limit is raised, a bit each
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(ready & bit)) {
    // above 48 KB a launch is refused unless the kernel opts in first
    err = cudaFuncSetAttribute(gemm_kernel<WT, MT, GLU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
    if (err != cudaSuccess) return (int)err;
    ready |= bit;
  }
  const int nk = R::I4 ? a.K / (2 * R::KB) : (a.K + KT - 1) / KT;
  const dim3 grid((a.M + MT - 1) / MT,
                  GLU ? (a.N / 2 + WR / 2 - 1) / (WR / 2) : (a.N + WR - 1) / WR,
                  (nk + kchunk - 1) / kchunk);
  gemm_kernel<WT, MT, GLU><<<grid, THREADS, R::SMEM, st>>>(a, kchunk, scratch, counter);
  return (int)cudaGetLastError();
}

template <int WT>
int launch(const GemmArgs& a, bool glu, int mt, int kchunk, float* scratch, unsigned* counter,
           cudaStream_t st) {
#define YT_MT(N)                                                              \
  case N:                                                                     \
    return glu ? launch_h<WT, N, true>(a, kchunk, scratch, counter, st)       \
               : launch_h<WT, N, false>(a, kchunk, scratch, counter, st);
  switch (mt) {
    YT_MT(16)
    YT_MT(32)
    YT_MT(64)
    YT_MT(128)
    case 256:   // not for int4: its two accumulators of Mt/2 floats would not fit
      if constexpr (WT != W_I4)
        return glu ? launch_h<WT, 256, true>(a, kchunk, scratch, counter, st)
                   : launch_h<WT, 256, false>(a, kchunk, scratch, counter, st);
      return ERR_ARGS;
    default: return ERR_ARGS;
  }
#undef YT_MT
}

bool args_ok(int M, int N, int layer, int E, bool glu, const float* residual) {
  return M >= 1 && M <= 65535 * BM && N >= 1 && layer >= 0 && E >= 1 &&
         (!glu || (N % 2 == 0 && !residual)) && grid_of(M, N, glu).y <= 65535;
}

}  // namespace

// gemm_kernel. x: (M, K) bf16 (yt_round_rows_bf16's output). glu: 1 for
// the GLU-pair epilogue (act 0 silu, 1 gelu; y is (M, N/2)). E, expert,
// expert_id: the expert axis (E = 1, expert 0, null for a dense stack); a
// non-null expert_id is read on the device in place of expert. mt: tokens
// per block (16, 32, 64, 128, 256); kchunk: 64-wide K stages per slice.
// With ceil(ceil(K / 64) / kchunk) > 1 slices, scratch holds (row tiles x
// token tiles x slices x 128 x mt) floats and counter (row tiles x token
// tiles) uint32 zeros, left at 0 again (ops/cuda/gemv.py:gemm_plan).
extern "C" int yt_gemm(int wtype, const void* w, int layer, int E, int expert,
                       const long long* expert_id, int N, int K, const void* x, int M,
                       const float* scale, const float* residual, float* y, int glu, int act,
                       int mt, int kchunk, float* scratch, unsigned* counter, void* stream) {
  if (M < 1 || N < 1 || layer < 0 || E < 1 || K < BK || K % BK || kchunk < 1 ||
      (glu && (N % 2 || residual)))
    return ERR_ARGS;
  const int nk = (K + KT - 1) / KT, split = (nk + kchunk - 1) / kchunk;
  const int rows = glu ? (N / 2 + WR / 2 - 1) / (WR / 2) : (N + WR - 1) / WR;
  if (rows > 65535 || split > 65535 || (split > 1 && (!scratch || !counter))) return ERR_ARGS;
  const GemmArgs a{w, nullptr, scale, nullptr, residual, y, expert_id, layer, E, expert, M, N, K,
                   0, act, static_cast<const __nv_bfloat16*>(x)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g = glu != 0;
  switch (wtype) {
    case W_F32: return launch<W_F32>(a, g, mt, kchunk, scratch, counter, st);
    case W_BF16: return launch<W_BF16>(a, g, mt, kchunk, scratch, counter, st);
    case W_E5M2: return launch<W_E5M2>(a, g, mt, kchunk, scratch, counter, st);
    case W_I8: return launch<W_I8>(a, g, mt, kchunk, scratch, counter, st);
    default: return ERR_ARGS;
  }
}

// gemm_kernel_v1, the design gemm_kernel replaced, for chip_smoke.py's
// same-run timing alone: x (M, K) f32, the arguments otherwise yt_gemm's
// before the plan.
extern "C" int yt_gemm_v1(int wtype, const void* w, int layer, int E, int expert,
                          const long long* expert_id, int N, int K, const float* x, int M,
                          const float* scale, const float* residual, float* y, int glu, int act,
                          void* stream) {
  if (!args_ok(M, N, layer, E, glu, residual) || K < BK || K % BK) return ERR_ARGS;
  const GemmArgs a{w, x, scale, nullptr, residual, y, expert_id, layer, E, expert, M, N, K, 0, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wtype) {
    case W_F32: return launch_v1<W_F32>(a, glu != 0, st);
    case W_BF16: return launch_v1<W_BF16>(a, glu != 0, st);
    case W_E5M2: return launch_v1<W_E5M2>(a, glu != 0, st);
    case W_I8: return launch_v1<W_I8>(a, glu != 0, st);
    default: return ERR_ARGS;
  }
}

// gemm_kernel on packed int4 weights (L, E, N, K/2) with group scales
// gscale (L, E, K / group, N): x (M, K) bf16; mt 16-128; kchunk stages of
// i4_stage_bytes(mt) packed bytes, a whole number of groups; otherwise as
// yt_gemm (ops/cuda/gemv.py checks types, shapes and 16-byte alignment).
extern "C" int yt_gemm4(const void* w, int layer, int E, int expert, const long long* expert_id,
                        int N, int K, int group, const void* x, int M, const float* gscale,
                        const float* residual, float* y, int glu, int act, int mt, int kchunk,
                        float* scratch, unsigned* counter, void* stream) {
  if (M < 1 || N < 1 || layer < 0 || E < 1 || (group != 256 && group != 512) || K < group ||
      K % group || !gscale || kchunk < 1 || kchunk % (group / (2 * i4_stage_bytes(mt))) ||
      (glu && (N % 2 || residual)))
    return ERR_ARGS;
  const int nk = K / (2 * i4_stage_bytes(mt)), split = (nk + kchunk - 1) / kchunk;
  const int rows = glu ? (N / 2 + WR / 2 - 1) / (WR / 2) : (N + WR - 1) / WR;
  if (rows > 65535 || split > 65535 || (split > 1 && (!scratch || !counter))) return ERR_ARGS;
  const GemmArgs a{w, nullptr, nullptr, gscale, residual, y, expert_id, layer, E, expert, M, N, K,
                   group, act, static_cast<const __nv_bfloat16*>(x)};
  return launch<W_I4>(a, glu != 0, mt, kchunk, scratch, counter, static_cast<cudaStream_t>(stream));
}

// gemm4_kernel_v1, the int4 design gemm_kernel replaced, for chip_smoke.py's
// same-run timing alone: x (M, K) f32, the arguments otherwise yt_gemm4's
// before the plan.
extern "C" int yt_gemm4_v1(const void* w, int layer, int E, int expert,
                           const long long* expert_id, int N, int K, int group, const float* x,
                           int M, const float* gscale, const float* residual, float* y, int glu,
                           int act, void* stream) {
  if (!args_ok(M, N, layer, E, glu, residual) || (group != 256 && group != 512) || K < group ||
      K % group || !gscale)
    return ERR_ARGS;
  const GemmArgs a{w, x, nullptr, gscale, residual, y, expert_id, layer, E, expert, M, N, K,
                   group, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (glu)
    gemm4_kernel_v1<true><<<grid_of(M, N, true), THREADS, 0, st>>>(a);
  else
    gemm4_kernel_v1<false><<<grid_of(M, N, false), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// norm_w: the layer's (K,) row of the stacked norm weights.
extern "C" int yt_rmsnorm_rows(const float* x, int M, int K, const float* norm_w, float eps,
                               float* out, void* stream) {
  if (M < 1 || K < 1) return ERR_ARGS;
  rmsnorm_rows_kernel<<<M, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, norm_w, out,
                                                                          K, eps);
  return (int)cudaGetLastError();
}

// x (n floats, n % 4 == 0, 16-byte aligned) -> out (n bf16).
extern "C" int yt_round_rows_bf16(const float* x, long long n, void* out, void* stream) {
  if (n < 4 || n % 4) return ERR_ARGS;
  const long long n4 = n / 4, blocks = (n4 + THREADS - 1) / THREADS;
  round_rows_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), static_cast<uint2*>(out), n4);
  return (int)cudaGetLastError();
}
