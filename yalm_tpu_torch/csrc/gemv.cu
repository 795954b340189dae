// Dequant GEMV over layer-stacked weights, with fused prologue/epilogues.
//
// Replaces yalm_tpu/ops/pallas/gemv.py:gemv_l and :gemv, and the packed
// int4 gemv4_l/gemv4 (:776, :791; body dot4_tile :797), and serves both
// projections of ops/pallas/block.py:attn_block_l and :attn_block4_l and of
// ops/pallas/ffn.py:ffn_l and :ffn4_l. With an expert axis it replaces the
// MoE gemv_le (:265) and gemv4_le (:768, through gemm4_le :688): the
// weights are (L, E, N, K) and only the routed expert's rows are read.
//
//   out[b, n] = epi( sum_k bf16(W[layer, e, n, k]) * bf16(pro(x[b])[k]) ),  b < nb <= 8
//
// The expert e comes from the host or from a device int64 (the decode
// step's top-k ids, which never reach the host: the counterpart of the TPU
// kernel's scalar-prefetch channel). A dense stack is E = 1, e = 0. An id
// outside [0, E) reads no weight: gemv_kernel writes zeros for -1 (on a
// mesh, an expert another rank holds) and NaN for any other (the host
// cannot check a device id without a sync); gemv_kernel_v1 NaN for all.
//
// int4 weights (W_I4, planar nibbles, ops/int4.py): each group's f32
// partial is multiplied by gscale[layer, e, g, n] before it joins the row
// sum (gemv.py:583-596: the scale multiplies an f32 partial, never the
// weight). The per-row scale is then absent.
//
// pro: optional rmsnorm against norm_w[layer] (x * rsqrt(mean(x^2) + eps)
//      * w, in f32, then rounded to bf16 -- gemv.py:229-235).
// epi: * scale[layer, n], + bias[layer, n], clip(+-clip), + residual[b, n];
//      or the GLU pair: rows n and N/2 + n give h1, h3 (each * its scale)
//      and out = bf16(act(h1) * h3) (ffn.py:95-101).
//
// Bound on this card: bytes. Decode reads every weight byte once (one
// Mistral-7B layer's w13 is 117 MB at fp8) and does 2 flops per weight per
// row of x. Layer and row offsets are 64-bit (L*E*N*K reaches 3.0e10 for a
// Mixtral-8x7B w13).
//
// gemv_kernel, the design (Hopper, sm_90a):
// - A block owns 128 weight rows, a 16-row mma tile per warp (GLU: 64
//   pairs, warp w's tile rows 0-7 the h1 rows of pairs p0+8w.., rows 8-15
//   their h3 rows, so each thread's accumulators hold both halves of a
//   pair). Where that grid leaves the SMs short of bytes in flight (N 4096
//   -6144: 32-48 blocks on 132 SMs), K is split over gridDim.y
//   (ops/cuda/gemv.py:gemv_plan; int4 at group boundaries); each slice
//   writes its f32 partials to scratch, and the last to arrive (a per-block
//   counter that atomicInc wraps back to 0) sums them in slice order and
//   runs the epilogue once on the full sum: the same bits on every call,
//   replayable from a CUDA graph.
// - The weight stream starts before the prologue: each thread issues the
//   loads of its first DEPTH iterations, then the block reads x from L2 for
//   the rmsnorm's sums of squares over all of K and stages this slice's
//   columns of pro(x) as bf16 in shared memory. In the loop each iteration's
//   loads are reissued DEPTH (2) iterations ahead, so 2 x 64 bytes per
//   thread stay in flight across row and group boundaries, and each miss
//   asks L2 for 256 bytes of the row (the next iteration's too). A DEPTH
//   of 3 or 4, and L2 prefetches 2-8 iterations ahead, measured slower
//   (PERF.md section 6).
// - The products run on tensor cores: mma.sync.m16n8k16 bf16 with f32
//   accumulation, the warp's 16 weight rows as A and the nb rows of x as
//   B's n of 8 (columns past nb are zeros). An iteration reads 128 bytes
//   (one line) of each row: thread (g, t) = (lane / 4, lane % 4) loads bytes
//   16t.. and 64 + 16t.. of its rows g and g + 8, each warp-wide load 64
//   contiguous bytes of 8 rows. A dot product does not depend on the order
//   of its terms, so an mma's k16 need not be 16 adjacent columns: thread t
//   builds its A fragment from its OWN bytes, and its B fragment holds x at
//   the same columns. For 16 bytes holding weights of columns c.. (PER of
//   them), mma step s takes a0/a1 = columns c+4s, c+4s+1 (rows g, g+8) and
//   a2/a3 = c+4s+2, c+4s+3, with b0/b1 = x at those columns; packed int4
//   (byte j: column c+j low, c+j+group/2 high) takes a0/a1 = the low
//   nibbles of bytes 2s, 2s+1 and a2/a3 their high nibbles, b0 = x at
//   c+2s, c+2s+1 and b1 at those + group/2 (ops/cuda/gemv.py:gemv_step_cols
//   mirrors the map). The weights widen to bf16 pairs without
//   int-to-float conversions: e5m2 as the high byte of an f16, int8 under an
//   f32's exponent byte, int4 nibbles under 0x43 and one bf16x2 subtraction
//   of 136 (csrc/gemm.cu's trick). Each int4 group sums into a fresh
//   fragment, scaled into the row's sum at the group's end.
// Against what held gemv_kernel_v1 back: 32 rows a block left 128 blocks
// at N 4096 (one per SM, <= 16 KB in flight on each), every block staged all
// of x before its first weight load, and every weight took a scalar widening
// and an FMA per row of x (int4: ~12 instructions per weight byte).
#include "gemv.cuh"

using namespace yt;
using namespace yt::gemv;

namespace {

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

// ---------------------------------------------------------------------------
// gemv_kernel_v1: the design gemv_kernel replaced, kept unchanged as
// chip_smoke.py's same-run yardstick alone (yt_gemv_v1): one warp per
// output row, lanes over K with 16-byte loads, x staged whole in shared
// memory as bf16, a scalar widening and FMA per weight.
// ---------------------------------------------------------------------------
namespace v1 {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;

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
__global__ void __launch_bounds__(THREADS) gemv_kernel_v1(GemvArgs a) {
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
  auto kern = gemv_kernel_v1<WT, MAXB, GLU>;
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

}  // namespace v1

// ---------------------------------------------------------------------------
// gemv_kernel (the file comment's design)
// ---------------------------------------------------------------------------

// grid (row blocks, K slices); 256 threads; dynamic shared memory nb rows of
// kchunk * COLS + XPAD bf16 (this slice's columns of the prologue's x).
template <int WT, bool GLU>
__global__ void __launch_bounds__(THREADS, 2)
gemv_kernel(GemvArgs a, int kchunk, float* __restrict__ scratch, unsigned* __restrict__ counter) {
  using LY = Layout<WT>;
  constexpr bool I4 = LY::I4;
  constexpr int COLS = LY::COLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float red[WARPS][8];
  __shared__ float rs[8];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  const int K = a.K, nb = a.nb, N = a.N, n_out = GLU ? a.N / 2 : a.N;
  const int S = gridDim.y, z = blockIdx.y, blk = blockIdx.x;
  const size_t rb = LY::row_bytes(K);
  const int nit = (int)((rb + WIN - 1) / WIN), it0 = z * kchunk;
  const int n = min(nit, it0 + kchunk) - it0;  // this slice's iterations (>= 1)
  const int XS = kchunk * COLS + XPAD;

  const long long e = a.expert_id ? *a.expert_id : a.expert;
  if (e < 0 || e >= a.E) {  // the same verdict in every block: none loads or counts
    // -1: another rank's expert on a mesh, whose gated share is zero; any
    // other id outside [0, E) is a fault and reads as NaN
    const float fill = e == -1 ? 0.f : __int_as_float(0x7fc00000);
    constexpr int OUT = GLU ? ROWS / 2 : ROWS;
    if (z == 0)
      for (int i = tid; i < OUT * nb; i += THREADS) {
        const int o = blk * OUT + i % OUT;
        if (o < n_out) a.out[(size_t)(i / OUT) * n_out + o] = fill;
      }
    return;
  }
  const size_t le = (size_t)a.layer * a.E + (size_t)e;  // the (layer, expert) matrix

  // the weight stream starts first: DEPTH iterations in flight before the prologue
  bool ok0, ok1;
  const int r0 = tile_row<GLU>(blk, w, g, 0, N, &ok0), r1 = tile_row<GLU>(blk, w, g, 1, N, &ok1);
  const uint8_t* wl = static_cast<const uint8_t*>(a.w) + le * (size_t)N * rb;
  const uint8_t* w0 = wl + (size_t)(ok0 ? r0 : 0) * rb + 16 * t;
  const uint8_t* w1 = wl + (size_t)(ok1 ? r1 : 0) * rb + 16 * t;
  const long long lim = (long long)rb - 16 * t;  // this thread's chunk of an iteration lies below it
  const float* gs = I4 ? a.gscale + le * (size_t)(K / a.group) * N : nullptr;
  const float* gs0 = I4 ? gs + (ok0 ? r0 : 0) : nullptr;
  const float* gs1 = I4 ? gs + (ok1 ? r1 : 0) : nullptr;
  uint4 ring[DEPTH][4];
  float sring[DEPTH][2];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (d < n) load_iter<WT>(ring[d], sring[d], w0, w1, ok0, ok1, lim, it0 + d, gs0, gs1, N,
                    a.group);

  // prologue, under those loads: the rmsnorm's sums of squares over all of
  // K (x from L2), then this slice's columns of x, normalised and rounded
  // to bf16 (zeros past K), into shared memory
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const float* nw = a.norm_w ? a.norm_w + (size_t)a.layer * K : nullptr;
  const int K4 = K / 4;
  if (nw) {
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
  }
  {
    const int c0 = it0 * COLS, q4 = n * COLS / 4;  // this slice's first column, its float4s
    const float4* nw4 = reinterpret_cast<const float4*>(nw);
    for (int i = tid; i < nb * q4; i += THREADS) {
      const int b = i / q4, j = i - b * q4, c = c0 + 4 * j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < K) {  // K % 4 == 0: a float4 is all in or all out
        v = x4[(size_t)b * K4 + c / 4];
        if (nw) {
          const float s = rs[b];
          const float4 m = nw4[c / 4];
          v = make_float4(v.x * s * m.x, v.y * s * m.y, v.z * s * m.z, v.w * s * m.w);
        }
      }
      *reinterpret_cast<uint2*>(xs + (size_t)b * XS + 4 * j) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  }
  __syncthreads();

  // the stream: each iteration's fragments, mma, then the load DEPTH ahead
  const bool live = g < nb;  // column g of the mma is x row g
  const __nv_bfloat16* xg = xs + (size_t)(live ? g : 0) * XS;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float gacc[4] = {0.f, 0.f, 0.f, 0.f};
  const int ipg = I4 ? a.group / (2 * WIN) : 1;  // int4: iterations per group (1 or 2)
  for (int i0 = 0; i0 < n; i0 += DEPTH) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int i = i0 + d;
      if (i >= n) break;  // uniform across the block
      if constexpr (I4) {
        // the slice starts on a group boundary; each group sums into a
        // fresh gacc, scaled into acc at the group's last iteration
        const int lg = i / ipg, gb = (i - lg * ipg) * WIN;
        if (gb == 0) gacc[0] = gacc[1] = gacc[2] = gacc[3] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = lg * a.group + gb + 64 * h + 16 * t;  // x column of the low nibbles
          uint32_t xlo[8], xhi[8], lo0[8], hi0[8], lo1[8], hi1[8];
          load_x<16>(xg + col, live, xlo);
          load_x<16>(xg + col + a.group / 2, live, xhi);
          const uint32_t u0[4] = {ring[d][h].x, ring[d][h].y, ring[d][h].z, ring[d][h].w};
          const uint32_t u1[4] = {ring[d][2 + h].x, ring[d][2 + h].y, ring[d][2 + h].z,
                                  ring[d][2 + h].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            i4_quad(u0[q], lo0 + 2 * q, hi0 + 2 * q);
            i4_quad(u1[q], lo1 + 2 * q, hi1 + 2 * q);
          }
#pragma unroll
          for (int s = 0; s < 8; ++s) mma16816(gacc, lo0[s], lo1[s], hi0[s], hi1[s], xlo[s], xhi[s]);
        }
        if (gb + WIN == a.group / 2) {
          acc[0] = fmaf(gacc[0], sring[d][0], acc[0]);
          acc[1] = fmaf(gacc[1], sring[d][0], acc[1]);
          acc[2] = fmaf(gacc[2], sring[d][1], acc[2]);
          acc[3] = fmaf(gacc[3], sring[d][1], acc[3]);
        }
      } else {
        constexpr int PER = Widen<WT>::PER;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t p0[PER / 2], p1[PER / 2], xb[PER / 2];
          Widen<WT>::pairs(ring[d][h], p0);
          Widen<WT>::pairs(ring[d][2 + h], p1);
          load_x<PER>(xg + i * COLS + h * (COLS / 2) + t * PER, live, xb);
#pragma unroll
          for (int s = 0; s < PER / 4; ++s)
            mma16816(acc, p0[2 * s], p1[2 * s], p0[2 * s + 1], p1[2 * s + 1], xb[2 * s],
                     xb[2 * s + 1]);
        }
      }
      if (i + DEPTH < n)
        load_iter<WT>(ring[d], sring[d], w0, w1, ok0, ok1, lim, it0 + i + DEPTH, gs0, gs1, N,
                      a.group);
    }
  }

  if (S > 1) {
    // this slice's partials to scratch in the threads' own order; the last
    // slice to arrive (the counter wraps to 0) sums them in slice order
    float4* part = reinterpret_cast<float4*>(scratch) + (size_t)blk * S * THREADS;
    __stcg(part + (size_t)z * THREADS + tid, make_float4(acc[0], acc[1], acc[2], acc[3]));
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicInc(counter + blk, S - 1) == (unsigned)(S - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    float4 v = __ldcg(part + tid);
    for (int zz = 1; zz < S; ++zz) {
      const float4 u = __ldcg(part + (size_t)zz * THREADS + tid);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    acc[0] = v.x;
    acc[1] = v.y;
    acc[2] = v.z;
    acc[3] = v.w;
  }

  // epilogue on the full sums: thread (g, t) holds rows g, g + 8 of its
  // tile for x rows 2t, 2t + 1
  const size_t row0 = le * N;
  if (GLU) {
    if (!ok0) return;
    const int p = r0;
    const float s1 = a.scale ? a.scale[row0 + p] : 1.f;
    const float s3 = a.scale ? a.scale[row0 + n_out + p] : 1.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int b = 2 * t + c;
      if (b >= nb) continue;
      float h1 = acc[c], h3 = acc[2 + c];
      if (a.scale) {
        h1 *= s1;
        h3 *= s3;
      }
      float y = bf16_round(glu_act(h1, a.act) * h3);
      if (a.residual) y += a.residual[(size_t)b * n_out + p];
      a.out[(size_t)b * n_out + p] = y;
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    if (!(h ? ok1 : ok0)) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int b = 2 * t + c;
      if (b >= nb) continue;
      float y = acc[2 * h + c];
      if (a.scale) y *= a.scale[row0 + r];
      if (a.bias) y += a.bias[row0 + r];
      if (a.clip > 0.f) y = fminf(fmaxf(y, -a.clip), a.clip);
      if (a.residual) y += a.residual[(size_t)b * n_out + r];
      a.out[(size_t)b * n_out + r] = y;
    }
  }
}

template <int WT, bool GLU>
int launch(const GemvArgs& a, int kchunk, float* scratch, unsigned* counter, cudaStream_t st) {
  constexpr int COLS = Layout<WT>::COLS;
  const size_t smem = (size_t)a.nb * (kchunk * COLS + XPAD) * sizeof(__nv_bfloat16);
  if (smem > 227 * 1024 - 1024) return ERR_ARGS;
  static int raised[32] = {};  // per device: the dynamic shared memory opted in so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 32 || raised[dev] < (int)smem)) {
    err = cudaFuncSetAttribute(gemv_kernel<WT, GLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) raised[dev] = (int)smem;
  }
  const size_t rb = Layout<WT>::row_bytes(a.K);
  const int nit = (int)((rb + WIN - 1) / WIN);
  const int rows = GLU ? (a.N / 2 + ROWS / 2 - 1) / (ROWS / 2) : (a.N + ROWS - 1) / ROWS;
  const int split = (nit + kchunk - 1) / kchunk;
  if (split > 65535 || (split > 1 && (!scratch || !counter))) return ERR_ARGS;
  gemv_kernel<WT, GLU><<<dim3(rows, split), THREADS, smem, st>>>(a, kchunk, scratch, counter);
  return (int)cudaGetLastError();
}

template <int WT>
int launch_wt(const GemvArgs& a, bool glu, int kchunk, float* scratch, unsigned* counter,
              cudaStream_t st) {
  return glu ? launch<WT, true>(a, kchunk, scratch, counter, st)
             : launch<WT, false>(a, kchunk, scratch, counter, st);
}

}  // namespace

// gemv_kernel. Returns 0, a cudaError_t, or ERR_ARGS. The wrapper
// (ops/cuda/gemv.py) checks types, shapes, contiguity and 16-byte alignment
// before the call. E, expert, expert_id: the expert axis (E = 1, expert 0,
// null for a dense stack); a non-null expert_id is read on the device in
// place of expert. kchunk: iterations (128 bytes of each weight row) a K
// slice takes, for int4 a whole number of groups (gemv.py:gemv_plan); with
// more than one slice, scratch holds (row blocks x slices x 1024) floats and
// counter (row blocks) uint32 zeros, left at 0 again.
extern "C" int yt_gemv(int wtype, const void* w, int layer, int E, int expert,
                       const long long* expert_id, int N, int K,
                       const float* x, int nb, const float* norm_w, float eps,
                       const float* scale, const float* gscale, int group,
                       const float* bias, float clip,
                       const float* residual, float* out, int glu, int act,
                       int kchunk, float* scratch, unsigned* counter, void* stream) {
  if (nb < 1 || nb > 8 || N < 1 || K < 1 || K % 4 || layer < 0 || E < 1 || (glu && N % 2) ||
      (bias && E != 1) || kchunk < 1)
    return ERR_ARGS;
  if ((size_t)nb * K * sizeof(__nv_bfloat16) > 227 * 1024) return ERR_ARGS;
  if (wtype == W_I4 && (!gscale || scale || (group != 256 && group != 512) || K % group ||
                        kchunk % (group / (2 * WIN))))
    return ERR_ARGS;
  const GemvArgs a{w, x, norm_w, scale, gscale, bias, residual, out, expert_id,
                   layer, E, expert, N, K, nb, group, eps, clip, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wtype) {
    case W_F32: return launch_wt<W_F32>(a, glu != 0, kchunk, scratch, counter, st);
    case W_BF16: return launch_wt<W_BF16>(a, glu != 0, kchunk, scratch, counter, st);
    case W_E5M2: return launch_wt<W_E5M2>(a, glu != 0, kchunk, scratch, counter, st);
    case W_I8: return launch_wt<W_I8>(a, glu != 0, kchunk, scratch, counter, st);
    case W_I4: return launch_wt<W_I4>(a, glu != 0, kchunk, scratch, counter, st);
    default: return ERR_ARGS;
  }
}

// gemv_kernel_v1, the design gemv_kernel replaced, for chip_smoke.py's
// same-run timing alone: the arguments are yt_gemv's before the plan.
extern "C" int yt_gemv_v1(int wtype, const void* w, int layer, int E, int expert,
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
    case W_F32: return v1::launch_wt<W_F32>(a, glu != 0, st);
    case W_BF16: return v1::launch_wt<W_BF16>(a, glu != 0, st);
    case W_E5M2: return v1::launch_wt<W_E5M2>(a, glu != 0, st);
    case W_I8: return v1::launch_wt<W_I8>(a, glu != 0, st);
    case W_I4: return v1::launch_wt<W_I4>(a, glu != 0, st);
    default: return ERR_ARGS;
  }
}

extern "C" const char* yt_error_string(int code) {
  if (code == ERR_ARGS) return "arguments the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
