// Dequant GEMM over layer-stacked weights:
//   Y[m, n] = sum_k bf16(X[m, k]) * bf16(W[layer, n, k])  (* scale[layer, n])
//
// Replaces yalm_tpu/ops/pallas/gemv.py:gemm_l (and :gemm, its 2-D form):
// the prefill chunk projections, M = 16/64/256 rows against one weight
// stream. gemm4_kernel below replaces :gemm4_l (and :gemm4) for packed int4
// weights.
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

template <int WT>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const void* __restrict__ w, const float* __restrict__ x,
            const float* __restrict__ scale, float* __restrict__ y,
            int layer, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM][BK + PAD];
  __shared__ __align__(16) __nv_bfloat16 ws[BN][BK + PAD];
  using C = WChunk<WT>;
  constexpr int PER = C::PER16;
  constexpr int CPR = BK / PER;  // 16-byte weight chunks per tile row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const size_t row_chunks = (size_t)K / PER;
  const uint4* wl = reinterpret_cast<const uint4*>(w) + (size_t)layer * N * row_chunks;

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
        v = *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * K + k0 + 4 * c4);
      *reinterpret_cast<__nv_bfloat162*>(&xs[r][4 * c4]) = __floats2bfloat162_rn(v.x, v.y);
      *reinterpret_cast<__nv_bfloat162*>(&xs[r][4 * c4 + 2]) = __floats2bfloat162_rn(v.z, v.w);
    }
    for (int i = tid; i < BN * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      float f[PER];
      if (n0 + r < N) {
        C::unpack(__ldg(wl + (size_t)(n0 + r) * row_chunks + k0 / PER + c), f);
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

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * 32 + mi * 16 + g + 8 * (e >> 1);
        const int c = n0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (r < M && c < N) {
          float v = acc[mi][ni][e];
          if (scale) v *= scale[(size_t)layer * N + c];
          y[(size_t)r * N + c] = v;
        }
      }
}

template <int WT>
int launch(const void* w, const float* x, const float* scale, float* y,
           int layer, int M, int N, int K, cudaStream_t st) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_kernel<WT><<<grid, THREADS, 0, st>>>(w, x, scale, y, layer, M, N, K);
  return (int)cudaGetLastError();
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

__global__ void __launch_bounds__(THREADS)
gemm4_kernel(const uint8_t* __restrict__ w, const float* __restrict__ x,
             const float* __restrict__ gscale, float* __restrict__ y,
             int layer, int M, int N, int K, int group) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM][BK4 + PAD];
  __shared__ __align__(16) __nv_bfloat16 ws[BN][BK4 + PAD];
  using C = WChunk<W_I4>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g8 = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int G = K / group, half = group / 2;  // half: packed bytes of a group row
  const size_t row_bytes = (size_t)K / 2;
  const uint8_t* wl = w + (size_t)layer * N * row_bytes;
  const float* gl = gscale + (size_t)layer * G * N;

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
        if (m0 + r < M) val = *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * K + col);
        *reinterpret_cast<__nv_bfloat162*>(&xs[r][v]) = __floats2bfloat162_rn(val.x, val.y);
        *reinterpret_cast<__nv_bfloat162*>(&xs[r][v + 2]) = __floats2bfloat162_rn(val.z, val.w);
      }
      for (int i = tid; i < BN * 2; i += THREADS) {
        const int r = i >> 1, c = i & 1;
        float f[C::PER16];
        if (n0 + r < N) {
          C::unpack(__ldg(reinterpret_cast<const uint4*>(
                        wl + (size_t)(n0 + r) * row_bytes + (size_t)g * half + b0 + 16 * c)), f);
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
        const int c = n0 + wn * 32 + ni * 8 + 2 * t + e1;
        const float s = c < N ? __ldg(gl + (size_t)g * N + c) : 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[mi][ni][e1] = fmaf(part[mi][ni][e1], s, acc[mi][ni][e1]);
          acc[mi][ni][2 + e1] = fmaf(part[mi][ni][2 + e1], s, acc[mi][ni][2 + e1]);
        }
      }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * 32 + mi * 16 + g8 + 8 * (e >> 1);
        const int c = n0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (r < M && c < N) y[(size_t)r * N + c] = acc[mi][ni][e];
      }
}

}  // namespace

extern "C" int yt_gemm(int wtype, const void* w, int layer, int N, int K,
                       const float* x, int M, const float* scale, float* y,
                       void* stream) {
  if (M < 1 || N < 1 || K < BK || K % BK || layer < 0 || (N + BN - 1) / BN > 65535)
    return ERR_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wtype) {
    case W_F32: return launch<W_F32>(w, x, scale, y, layer, M, N, K, st);
    case W_BF16: return launch<W_BF16>(w, x, scale, y, layer, M, N, K, st);
    case W_E5M2: return launch<W_E5M2>(w, x, scale, y, layer, M, N, K, st);
    case W_I8: return launch<W_I8>(w, x, scale, y, layer, M, N, K, st);
    default: return ERR_ARGS;
  }
}

// Packed int4 (ops/cuda/gemv.py checks types, shapes and 16-byte alignment).
extern "C" int yt_gemm4(const void* w, int layer, int N, int K, int group,
                        const float* x, int M, const float* gscale, float* y,
                        void* stream) {
  if (M < 1 || N < 1 || layer < 0 || (group != 256 && group != 512) || K < group ||
      K % group || (N + BN - 1) / BN > 65535 || !gscale)
    return ERR_ARGS;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm4_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(w), x, gscale, y, layer, M, N, K, group);
  return (int)cudaGetLastError();
}
