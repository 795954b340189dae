// Dequant GEMM over layer-stacked weights:
//   Y[m, n] = sum_k bf16(X[m, k]) * bf16(W[layer, n, k])  (* scale[layer, n])
//
// Replaces yalm_tpu/ops/pallas/gemv.py:gemm_l (and :gemm, its 2-D form):
// the prefill chunk projections, M = 16/64/256 rows against one weight
// stream, and the batched tick's projections at M = batch rows.
// gemm4_kernel below replaces :gemm4_l (and :gemm4) for packed int4 weights.
// With an expert axis, weights (L, E, N, K), both replace the MoE gemm_le
// (:344) and gemm4_le (:688): every tile is addressed at (layer, expert),
// so only that expert's bytes are read and no copy of it is made. The
// expert comes from the host (the batched sweep's loop over every expert)
// or a device int64; an id outside [0, E) reads nothing and gives NaN.
//
// Epilogues (both kernels): + residual[m, n]; or the GLU pair, which makes
// them the two weight sweeps of ops/pallas/ffn.py:ffn_l and :ffn4_l for any
// number of rows (the GEMV route takes <= 8): rows n and H + n of W13 give
// h1, h3 (each * its scale) and Y[m, n] = bf16(act(h1) * h3), (M, H). A GLU
// tile stages 64 pairs: warp column w holds W13 rows n0+16w..n0+16w+15 (h1)
// in its first 16 tile rows and the matching H + n rows (h3) in its last
// 16, so each thread's mma fragments hold both halves of its pairs.
// rmsnorm_rows_kernel is the route's prologue (ffn.py:46-50).
//
// Bound on this card: at M = 256 the flops (2*M*N*K, e.g. 60 GFLOP for a
// Mistral-7B w13) outweigh the fp8 weight bytes (117 MB) by ~500 flops/byte,
// so the bf16 tensor cores bind; at M = 16 the weight bytes do. Design:
// 64 x 128 output tiles, 8 warps each owning 32 x 32 through
// mma.sync.m16n8k16 bf16 (f32 accumulate); each 32-wide K step stages X
// (rounded to bf16) and W (dequantized to bf16 -- exact for e5m2/int8/bf16)
// in padded shared memory, conflict-free for the fragment loads. The M
// tiles of one N tile are neighbours in the grid so they share the weight
// tile through L2. No cp.async/TMA pipelining and no wgmma yet.
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

// The W row staged at row r (0..BN-1) of the tile that starts at n0, and
// whether it exists. Plain tiles: rows n0..n0+BN-1 of N. GLU tiles (n0 a
// pair index, H = N/2 pairs): see the file comment.
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
  const float* x;         // (M, K)
  const float* scale;     // (L, E, N) per-row scales, or null
  const float* gscale;    // (L, E, K / group, N) int4 group scales
  const float* residual;  // (M, N) or null (not with the GLU pair)
  float* y;               // (M, N), or (M, N/2) for the GLU pair
  const long long* expert_id;  // device expert id, or null: `expert` is used
  int layer, E, expert, M, N, K, group, act;
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

template <int WT, bool GLU>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmArgs a) {
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

// Packed int4 weights (L, N, K/2) with group scales (L, G, N):
//   Y[m, n] = sum_g gscale[layer, g, n] * sum_{k in g} bf16(X[m, k]) * (q[n, k] - 8)
// Same tiles and mma.sync as gemm_kernel. Each K step takes 32 packed bytes
// of every row of the tile -- 64 columns, 32 low nibbles and the 32 high
// nibbles group/2 columns further on -- and stages them, with the matching
// 64 columns of X, in one "virtual" 64-wide order (a dot product does not
// care about the order of its terms), so every weight byte is read once.
// Each group sums into a fresh fragment `part`; at the group's end
// acc += part * gscale[g, n] (the scale multiplies the f32 partial).
constexpr int BK4 = 64;

template <bool GLU>
__global__ void __launch_bounds__(THREADS) gemm4_kernel(GemmArgs a) {
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

dim3 grid_of(int M, int N, bool glu) {
  return dim3((M + BM - 1) / BM, glu ? (N / 2 + BN / 2 - 1) / (BN / 2) : (N + BN - 1) / BN);
}

template <int WT>
int launch(const GemmArgs& a, bool glu, cudaStream_t st) {
  if (glu)
    gemm_kernel<WT, true><<<grid_of(a.M, a.N, true), THREADS, 0, st>>>(a);
  else
    gemm_kernel<WT, false><<<grid_of(a.M, a.N, false), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

bool args_ok(int M, int N, int layer, int E, bool glu, const float* residual) {
  return M >= 1 && M <= 65535 * BM && N >= 1 && layer >= 0 && E >= 1 &&
         (!glu || (N % 2 == 0 && !residual)) && grid_of(M, N, glu).y <= 65535;
}

}  // namespace

// glu: 1 for the GLU-pair epilogue (act 0 silu, 1 gelu; y is (M, N/2)).
// E, expert, expert_id: the expert axis (E = 1, expert 0, null for a dense
// stack); a non-null expert_id is read on the device in place of expert.
extern "C" int yt_gemm(int wtype, const void* w, int layer, int E, int expert,
                       const long long* expert_id, int N, int K, const float* x,
                       int M, const float* scale, const float* residual, float* y, int glu,
                       int act, void* stream) {
  if (!args_ok(M, N, layer, E, glu, residual) || K < BK || K % BK) return ERR_ARGS;
  const GemmArgs a{w, x, scale, nullptr, residual, y, expert_id, layer, E, expert, M, N, K, 0, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wtype) {
    case W_F32: return launch<W_F32>(a, glu != 0, st);
    case W_BF16: return launch<W_BF16>(a, glu != 0, st);
    case W_E5M2: return launch<W_E5M2>(a, glu != 0, st);
    case W_I8: return launch<W_I8>(a, glu != 0, st);
    default: return ERR_ARGS;
  }
}

// Packed int4 (ops/cuda/gemv.py checks types, shapes and 16-byte alignment).
extern "C" int yt_gemm4(const void* w, int layer, int E, int expert, const long long* expert_id,
                        int N, int K, int group, const float* x, int M, const float* gscale,
                        const float* residual, float* y, int glu, int act, void* stream) {
  if (!args_ok(M, N, layer, E, glu, residual) || (group != 256 && group != 512) || K < group ||
      K % group || !gscale)
    return ERR_ARGS;
  const GemmArgs a{w, x, nullptr, gscale, residual, y, expert_id, layer, E, expert, M, N, K,
                   group, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (glu)
    gemm4_kernel<true><<<grid_of(M, N, true), THREADS, 0, st>>>(a);
  else
    gemm4_kernel<false><<<grid_of(M, N, false), THREADS, 0, st>>>(a);
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
