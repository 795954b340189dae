// Dequant GEMV over layer-stacked weights, with fused prologue/epilogues.
//
// Replaces yalm_tpu/ops/pallas/gemv.py:gemv_l and :gemv, and the packed
// int4 gemv4_l/gemv4 (:776, :791; body dot4_tile :797), and serves both
// projections of ops/pallas/block.py:attn_block_l and :attn_block4_l and of
// ops/pallas/ffn.py:ffn_l and :ffn4_l. With an expert axis it replaces the
// MoE gemv_le (:265) and gemv4_le (:768, through gemm4_le :688): the
// weights are (L, E, N, K) and only the routed expert's rows are read.
//
//   out[b, n] = epi( sum_k bf16(W[layer, e, n, k]) * bf16(pro(x[b])[k]) )
//
// The expert e comes from the host or from a device int64 (the decode
// step's top-k ids, which never reach the host: the counterpart of the TPU
// kernel's scalar-prefetch channel). A dense stack is E = 1, e = 0. An id
// outside [0, E) reads no weight and gives NaN outputs (the host cannot
// check a device id without a sync).
//
// int4 weights (W_I4, planar nibbles, WChunk<W_I4>): each 16-byte chunk
// lies in one group g and pairs with two 16-column slices of x, group/2
// apart; its f32 partial is multiplied by gscale[layer, g, n] before it
// joins the row sum (gemv.py:583-596: the scale multiplies an f32 partial,
// never the weight). The per-row scale is then absent.
//
// pro: optional rmsnorm against norm_w[layer] (x * rsqrt(mean(x^2) + eps)
//      * w, in f32, then rounded to bf16 -- gemv.py:229-235).
// epi: * scale[layer, n], + bias[layer, n], clip(+-clip), + residual[b, n];
//      or the GLU pair: rows n and N/2 + n give h1, h3 (each * its scale)
//      and out = bf16(act(h1) * h3) (ffn.py:95-101).
//
// Bound on this card: bytes. Decode reads every weight byte once (one
// Mistral-7B layer's w13 is 117 MB at fp8) and does 2 flops per weight, far
// below the ~295 flops/byte where bf16 tensor cores would bind. Design:
// one warp per output row (two rows for the GLU pair), lanes stride over K
// with 16-byte loads, 4 loads in flight per lane; x is staged once per
// block in shared memory as bf16; the row sum is a warp shuffle reduction.
// Layer and row offsets are 64-bit (L*N*K reaches 3.8e9 for w13, and
// L*E*N*K 3.0e10 for a Mixtral-8x7B w13).
#include "common.cuh"

using namespace yt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;

struct GemvArgs {
  const void* w;         // (L, E, N, K) of the weight type
  const float* x;        // (nb, K)
  const float* norm_w;   // (L, K) or null
  const float* scale;    // (L, E, N) or null
  const float* gscale;   // (L, E, K / group, N): int4 group scales, or null
  const float* bias;     // (L, N) or null (E = 1)
  const float* residual; // (nb, n_out) or null
  float* out;            // (nb, n_out); n_out = N, or N/2 for the GLU pair
  const long long* expert_id;  // device expert id, or null: `expert` is used
  int layer, E, expert, N, K, nb;
  int group;             // int4 group width (256 or 512)
  float eps, clip;       // clip <= 0: no clip
  int act;               // GLU activation: 0 silu, 1 gelu
};

// PER bf16 values of shared memory, widened to f32.
template <int PER>
__device__ __forceinline__ void load_xs(const __nv_bfloat16* p, float* o) {
  if constexpr (PER == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    o[0] = bf16_lo(u.x); o[1] = bf16_hi(u.x);
    o[2] = bf16_lo(u.y); o[3] = bf16_hi(u.y);
  } else {
#pragma unroll
    for (int i = 0; i < PER / 8; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[8 * i + 2 * j] = bf16_lo(w[j]);
        o[8 * i + 2 * j + 1] = bf16_hi(w[j]);
      }
    }
  }
}

template <int WT, int MAXB, bool GLU>
__global__ void __launch_bounds__(THREADS) gemv_kernel(GemvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (nb, K)
  __shared__ float rs[MAXB];
  using C = WChunk<WT>;
  constexpr int PER = C::PER16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, nb = a.nb;
  const int n_out = GLU ? a.N / 2 : a.N;

  const long long e = a.expert_id ? *a.expert_id : a.expert;
  if (e < 0 || e >= a.E) {  // uniform across the block: nothing is read
    for (int i = tid; i < ROWS_PER_BLOCK * nb; i += THREADS) {
      const int n = blockIdx.x * ROWS_PER_BLOCK + i % ROWS_PER_BLOCK;
      if (n < n_out) a.out[(size_t)(i / ROWS_PER_BLOCK) * n_out + n] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const size_t le = (size_t)a.layer * a.E + (size_t)e;  // the (layer, expert) matrix

  // prologue: x (RMS-normalized when norm_w is given) as bf16 in smem
  const float* nw = a.norm_w ? a.norm_w + (size_t)a.layer * K : nullptr;
  if (nw) {
    for (int b = warp; b < nb; b += WARPS) {
      float ss = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float v = a.x[(size_t)b * K + k];
        ss = fmaf(v, v, ss);
      }
      ss = warp_sum(ss);
      if (lane == 0) rs[b] = 1.0f / sqrtf(ss / (float)K + a.eps);
    }
    __syncthreads();
  }
  for (int i = tid; i < nb * K; i += THREADS) {
    float v = a.x[i];
    if (nw) {
      const int b = i / K;
      v = v * rs[b] * nw[i - b * K];
    }
    xs[i] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  const int nchunks = K / PER;
  const size_t row0 = le * a.N;  // first row of this (layer, expert)
  const uint4* wb = reinterpret_cast<const uint4*>(a.w);

  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int n = blockIdx.x * ROWS_PER_BLOCK + r * WARPS + warp;
    if (n >= n_out) break;  // uniform across the warp
    const uint4* w1 = wb + (row0 + n) * (size_t)nchunks;
    const uint4* w3 = wb + (row0 + n + (GLU ? n_out : 0)) * (size_t)nchunks;
    float acc1[MAXB], acc3[MAXB];
#pragma unroll
    for (int b = 0; b < MAXB; ++b) acc1[b] = acc3[b] = 0.f;

    if constexpr (WT == W_I4) {
      const int cpg = a.group / PER;  // chunks per group
      const int half = a.group / 2;
      const float* gs1 = a.gscale + le * (K / a.group) * a.N + n;
      const float* gs3 = gs1 + n_out;
#pragma unroll 2
      for (int c = lane; c < nchunks; c += 32) {
        const int g = c / cpg;
        const int k0 = g * a.group + (c - g * cpg) * 16;  // column of o[0]
        float f1[PER], f3[PER];
        C::unpack(__ldg(w1 + c), f1);
        if (GLU) C::unpack(__ldg(w3 + c), f3);
        const float s1 = __ldg(gs1 + (size_t)g * a.N);
        const float s3 = GLU ? __ldg(gs3 + (size_t)g * a.N) : 0.f;
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          if (b < nb) {
            float xl[16], xh[16];
            load_xs<16>(xs + (size_t)b * K + k0, xl);
            load_xs<16>(xs + (size_t)b * K + k0 + half, xh);
            float p1 = 0.f, p3 = 0.f;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              p1 = fmaf(f1[j], xl[j], p1);
              p1 = fmaf(f1[16 + j], xh[j], p1);
              if (GLU) {
                p3 = fmaf(f3[j], xl[j], p3);
                p3 = fmaf(f3[16 + j], xh[j], p3);
              }
            }
            acc1[b] = fmaf(p1, s1, acc1[b]);
            if (GLU) acc3[b] = fmaf(p3, s3, acc3[b]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < nchunks; c += 32) {
        float f1[PER], f3[PER];
        C::unpack(__ldg(w1 + c), f1);
        if (GLU) C::unpack(__ldg(w3 + c), f3);
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          if (b < nb) {
            float xv[PER];
            load_xs<PER>(xs + (size_t)b * K + (size_t)c * PER, xv);
#pragma unroll
            for (int j = 0; j < PER; ++j) {
              acc1[b] = fmaf(f1[j], xv[j], acc1[b]);
              if (GLU) acc3[b] = fmaf(f3[j], xv[j], acc3[b]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b >= nb) break;
      const float s1 = warp_sum(acc1[b]);
      const float s3 = GLU ? warp_sum(acc3[b]) : 0.f;
      if (lane != 0) continue;
      float y;
      if (GLU) {
        float h1 = s1, h3 = s3;
        if (a.scale) {
          h1 *= a.scale[row0 + n];
          h3 *= a.scale[row0 + n + n_out];
        }
        y = bf16_round(glu_act(h1, a.act) * h3);
      } else {
        y = s1;
        if (a.scale) y *= a.scale[row0 + n];
        if (a.bias) y += a.bias[row0 + n];
        if (a.clip > 0.f) y = fminf(fmaxf(y, -a.clip), a.clip);
      }
      if (a.residual) y += a.residual[(size_t)b * n_out + n];
      a.out[(size_t)b * n_out + n] = y;
    }
  }
}

template <int WT, int MAXB, bool GLU>
int launch(const GemvArgs& a, cudaStream_t st) {
  const int n_out = GLU ? a.N / 2 : a.N;
  const size_t smem = (size_t)a.nb * a.K * sizeof(__nv_bfloat16);
  auto kern = gemv_kernel<WT, MAXB, GLU>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n_out + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  kern<<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int WT>
int launch_wt(const GemvArgs& a, bool glu, cudaStream_t st) {
  if (a.nb == 1) return glu ? launch<WT, 1, true>(a, st) : launch<WT, 1, false>(a, st);
  if (a.nb <= 4) return glu ? launch<WT, 4, true>(a, st) : launch<WT, 4, false>(a, st);
  return glu ? launch<WT, 8, true>(a, st) : launch<WT, 8, false>(a, st);
}

}  // namespace

// Returns 0, a cudaError_t, or ERR_ARGS. The wrapper (ops/cuda/gemv.py)
// checks types, shapes, contiguity and 16-byte alignment before the call.
// E, expert, expert_id: the expert axis (E = 1, expert 0, null for a dense
// stack); a non-null expert_id is read on the device in place of expert.
extern "C" int yt_gemv(int wtype, const void* w, int layer, int E, int expert,
                       const long long* expert_id, int N, int K,
                       const float* x, int nb, const float* norm_w, float eps,
                       const float* scale, const float* gscale, int group,
                       const float* bias, float clip,
                       const float* residual, float* out, int glu, int act,
                       void* stream) {
  if (nb < 1 || nb > 8 || N < 1 || K < 1 || layer < 0 || E < 1 || (glu && N % 2) ||
      (bias && E != 1))
    return ERR_ARGS;
  if ((size_t)nb * K * sizeof(__nv_bfloat16) > 227 * 1024) return ERR_ARGS;
  if (wtype == W_I4 && (!gscale || scale || (group != 256 && group != 512) || K % group))
    return ERR_ARGS;
  const GemvArgs a{w, x, norm_w, scale, gscale, bias, residual, out, expert_id,
                   layer, E, expert, N, K, nb, group, eps, clip, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wtype) {
    case W_F32: return launch_wt<W_F32>(a, glu != 0, st);
    case W_BF16: return launch_wt<W_BF16>(a, glu != 0, st);
    case W_E5M2: return launch_wt<W_E5M2>(a, glu != 0, st);
    case W_I8: return launch_wt<W_I8>(a, glu != 0, st);
    case W_I4: return launch_wt<W_I4>(a, glu != 0, st);
    default: return ERR_ARGS;
  }
}

extern "C" const char* yt_error_string(int code) {
  if (code == ERR_ARGS) return "arguments the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
