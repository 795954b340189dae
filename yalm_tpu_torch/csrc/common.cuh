// Shared helpers of the port's Hopper kernels (sm_90a).
//
// Numerics contract of every kernel here, the same as the JAX package's
// (yalm_tpu/ops/pallas/gemv.py:69-77): operands are rounded to bf16, the
// products are summed in f32, and dequant scales multiply the f32 result.
// A bf16 x bf16 product is exact in f32, so only the order of the f32 sum
// differs from the reference.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace yt {

// Weight type codes; yalm_tpu_torch/ops/cuda/_build.py holds the same table.
// W_I4: planar-packed int4 (uint8 storage, see WChunk<W_I4>) with per-group
// scales. The KV-cache type codes are W_BF16 and W_E5M2.
enum WType { W_F32 = 0, W_BF16 = 1, W_E5M2 = 2, W_I8 = 3, W_I4 = 4 };

// Error codes returned for arguments the kernels do not take (positive
// codes are cudaError_t values).
constexpr int ERR_ARGS = -1;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// e5m2 is the high byte of an f16 with the same exponent: widening is
// exact, and so is the value in bf16 (2 mantissa bits, 5 exponent bits).
__device__ __forceinline__ float e5m2_to_float(uint32_t b) {
  return __half2float(__ushort_as_half((unsigned short)((b & 0xffu) << 8)));
}

// f32 -> e5m2 in ONE rounding (nearest even, overflow to inf), as torch's
// and JAX's casts do; through bf16 it would round twice.
__device__ __forceinline__ uint8_t float_to_e5m2(float x) {
  return (uint8_t)__nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E5M2);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// One 16-byte chunk of weights widened to floats that are exact bf16
// values. PER16 weights per chunk.
template <int WT> struct WChunk;

template <> struct WChunk<W_F32> {
  static constexpr int PER16 = 4;
  static constexpr int BYTES = 4;
  __device__ __forceinline__ static void unpack(uint4 v, float* o) {
    o[0] = bf16_round(__uint_as_float(v.x));
    o[1] = bf16_round(__uint_as_float(v.y));
    o[2] = bf16_round(__uint_as_float(v.z));
    o[3] = bf16_round(__uint_as_float(v.w));
  }
};

template <> struct WChunk<W_BF16> {
  static constexpr int PER16 = 8;
  static constexpr int BYTES = 2;
  __device__ __forceinline__ static void unpack(uint4 v, float* o) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = bf16_lo(w[i]);
      o[2 * i + 1] = bf16_hi(w[i]);
    }
  }
};

template <> struct WChunk<W_E5M2> {
  static constexpr int PER16 = 16;
  static constexpr int BYTES = 1;
  __device__ __forceinline__ static void unpack(uint4 v, float* o) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[4 * i + j] = e5m2_to_float(w[i] >> (8 * j));
  }
};

template <> struct WChunk<W_I8> {
  static constexpr int PER16 = 16;
  static constexpr int BYTES = 1;
  __device__ __forceinline__ static void unpack(uint4 v, float* o) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[4 * i + j] = (float)(int8_t)((w[i] >> (8 * j)) & 0xffu);
  }
};

// Packed int4 (yalm_tpu_torch/ops/int4.py): within a group of `group`
// columns, byte t holds column t in its low nibble and column t + group/2 in
// its high nibble, offset 8. One 16-byte chunk of bytes t0..t0+15 gives
// o[j] = column t0 + j and o[16 + j] = column t0 + group/2 + j, as exact
// bf16 values q - 8 in -8..7. The group scale multiplies the f32 partial
// sum of the products, never the weight.
template <> struct WChunk<W_I4> {
  static constexpr int PER16 = 32;
  __device__ __forceinline__ static void unpack(uint4 v, float* o) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[4 * i + j] = (float)((int)((w[i] >> (8 * j)) & 0xfu) - 8);
        o[16 + 4 * i + j] = (float)((int)((w[i] >> (8 * j + 4)) & 0xfu) - 8);
      }
  }
};

// The GLU activation of the fused FFN epilogues (ffn.py:95-101): 0 silu,
// 1 tanh-approximated gelu with the reference's constants.
__device__ __forceinline__ float glu_act(float h, int act) {
  if (act == 0) return h * (1.0f / (1.0f + expf(-h)));
  return 0.5f * h * (1.0f + tanhf(0.797885f * (h + 0.044715f * h * h * h)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace yt
