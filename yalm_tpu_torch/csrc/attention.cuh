// Device helpers of csrc/attention.cu's decode attention (the split over
// the slots) that csrc/block.cu's fused attention block runs too: the
// cache element types, the cp.async tile loads, RoPE's rounded products,
// slot ages, the ring window's chunk rule and the split's shared memory.
// attention.cu's file comment has the design and the numerics.
#pragma once

#include "common.cuh"

namespace yt {
namespace attn {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;
constexpr int KPAD = 8;      // padding elements per shared K/V row (bank spread)
constexpr int MAX_OUT = 8;   // output elements per thread: qpk * D <= 2048
constexpr int MAX_SPLIT = 1024;            // chunks per head of a split launch
constexpr size_t SMEM_MAX = 227 * 1024;    // dynamic shared memory a block may take
constexpr float NEG_BIG = -1e30f;  // a masked score (the reference's _NEG_INF)

// The cache element types: the row write from f32; 8 elements widened to 8
// bf16 (the batched kernel's staging); 8 elements in shared memory widened
// to f32 (exact); one element to f32; 8 elements copied global -> shared
// without the registers (cp.async: 16 bytes of bf16, 8 of e5m2).
template <typename T> struct KV;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <> struct KV<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ __forceinline__ static void load8(const __nv_bfloat16* p, __nv_bfloat16* dst) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void widen8(const __nv_bfloat16* p, float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = bf16_lo(w[i]);
      o[2 * i + 1] = bf16_hi(w[i]);
    }
  }
  __device__ __forceinline__ static float widen1(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ __forceinline__ static void copy8_async(__nv_bfloat16* dst, const __nv_bfloat16* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
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
  __device__ __forceinline__ static void widen8(const uint8_t* p, float* o) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = e5m2_to_float(u.x >> (8 * j));
      o[4 + j] = e5m2_to_float(u.y >> (8 * j));
    }
  }
  __device__ __forceinline__ static float widen1(uint8_t x) { return e5m2_to_float(x); }
  __device__ __forceinline__ static void copy8_async(uint8_t* dst, const uint8_t* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  }
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x0 * c - x1 * s and x0 * s + x1 * c, each product rounded (no fma)
__device__ __forceinline__ float rot_re(float x0, float x1, float c, float s) {
  return __fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s));
}
__device__ __forceinline__ float rot_im(float x0, float x1, float c, float s) {
  return __fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c));
}

// _slot_age: a sink slot S-1-s, any other (kv_pos - s) mod ring
__device__ __forceinline__ int slot_age(int s, int kv_pos, int kv_sink, int S, int ring) {
  return s < kv_sink ? S - 1 - s : ((kv_pos - s) % ring + ring) % ring;
}

// Whether slots [c0, c1) hold one a sliding layer attends (age < win), in
// O(1): the sinks' ages S-1-s fall as s rises; going back from c1 - 1 the
// other slots' ages rise by one per slot and wrap to 0 at most once.
// ops/cuda/attention.py:chunk_live is the same rule.
__host__ __device__ inline bool chunk_live(int c0, int c1, int kv_pos, int kv_sink, int S,
                                           int win) {
  if (win <= 0) return true;
  if (c0 < kv_sink && S - min(c1, kv_sink) < win) return true;
  const int a = max(c0, kv_sink);
  if (a >= c1) return false;
  const int ring = max(S - kv_sink, 1);
  const int d_end = ((kv_pos - (c1 - 1)) % ring + ring) % ring;
  return d_end < win || ring - d_end < c1 - a;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// the split's shared memory. Pass 1: q (qpk, D + KPAD) bf16 | the sink view
// (kv_sink, D + KPAD) bf16 | two K tiles (TILE, D + KPAD) of T. Pass 2: m
// and l (2 qpk) f32 | one tile's p (TILE, qpk) f32 | the row slices' sums
// (THREADS x 8) f32 | two V tiles.
__host__ __device__ inline size_t tiles_bytes(int D, size_t elem) {
  return 2 * align16((size_t)TILE * (D + KPAD) * elem);
}
__host__ __device__ inline size_t scores_smem(int qpk, int D, int kv_sink, size_t elem) {
  return align16((size_t)qpk * (D + KPAD) * 2) + align16((size_t)kv_sink * (D + KPAD) * 2) +
         tiles_bytes(D, elem);
}
__host__ __device__ inline size_t values_smem(int qpk, int D, size_t elem) {
  return align16(2 * qpk * 4) + align16((size_t)TILE * qpk * 4) + (size_t)THREADS * 8 * 4 +
         tiles_bytes(D, elem);
}

// Rows [t0, t0 + nt) of one head into a shared tile (stride D + KPAD), 8
// elements per cp.async; every thread commits one group per call.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* head_rows, size_t row_stride, int t0,
                                          int nt, int D) {
  const int vpr = D / 8;
  for (int i = threadIdx.x; i < nt * vpr; i += THREADS) {
    const int r = i / vpr, c = i - r * vpr;
    KV<T>::copy8_async(dst + r * (D + KPAD) + 8 * c,
                       head_rows + (size_t)(t0 + r) * row_stride + 8 * c);
  }
  cp_async_commit();
}

// bf16 q row . one shared row of E (bf16 or e5m2), summed in f32 in order
template <typename E>
__device__ __forceinline__ float dot_row(const E* k, const __nv_bfloat16* q, int D) {
  float dot = 0.f;
  for (int d = 0; d < D; d += 8) {
    float kf[8], qf[8];
    KV<E>::widen8(k + d, kf);
    KV<__nv_bfloat16>::widen8(q + d, qf);
#pragma unroll
    for (int i = 0; i < 8; ++i) dot = fmaf(qf[i], kf[i], dot);
  }
  return dot;
}

}  // namespace attn
}  // namespace yt
