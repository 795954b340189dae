// Device helpers of csrc/gemv.cu's gemv_kernel that csrc/block.cu's fused
// attention block and csrc/ffn.cu's fused FFN run too: the streamed weight
// loads, the widening of weight bytes to bf16 pairs, the mma.sync tile, a
// block's tile rows, an iteration's loads and its products over one or two
// n8 tiles of x, a GEMV plan's check; and the flags between the blocks of a
// cooperative launch. gemv.cu's file comment has the design.
#pragma once

#include "common.cuh"

namespace yt {
namespace gemv {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 16 * WARPS;  // weight rows of a block: a warp's mma tile of 16 each
constexpr int WIN = 128;          // bytes of each weight row one iteration reads
constexpr int DEPTH = 2;          // iterations of weight loads in flight per thread
constexpr int XPAD = 8;           // bf16 after each staged x row (rows 16 bytes off the banks)

// 16 streamed weight bytes: read once, kept out of L1; a miss brings the
// row's 256 bytes around them into L2 (the next iteration's too). asm
// volatile: issued where written, so the first go out before the prologue.
__device__ __forceinline__ uint4 ld_stream(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 weight bytes as bf16 pairs, the lower k in the low half: PER weights,
// PER / 2 pairs, exact (f32 rounded to nearest even, as torch's cast).
template <int WT> struct Widen;

template <> struct Widen<W_F32> {
  static constexpr int PER = 4;
  __device__ __forceinline__ static void pairs(uint4 v, uint32_t* p) {
    p[0] = pack_bf16(__uint_as_float(v.x), __uint_as_float(v.y));
    p[1] = pack_bf16(__uint_as_float(v.z), __uint_as_float(v.w));
  }
};

template <> struct Widen<W_BF16> {
  static constexpr int PER = 8;
  __device__ __forceinline__ static void pairs(uint4 v, uint32_t* p) {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
};

// e5m2: each byte the high byte of an f16 (selectors 0x1404 and 0x3424 put
// bytes 0, 1 and 2, 3 of a word there), widened to f32 and packed; every
// step is exact, infinities and NaNs included.
template <> struct Widen<W_E5M2> {
  static constexpr int PER = 16;
  __device__ __forceinline__ static uint32_t two(uint32_t w, uint32_t sel) {
    const uint32_t h = __byte_perm(w, 0u, sel);
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
    return pack_bf16(f.x, f.y);
  }
  __device__ __forceinline__ static void pairs(uint4 v, uint32_t* p) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[2 * i] = two(w[i], 0x1404);
      p[2 * i + 1] = two(w[i], 0x3424);
    }
  }
};

// int8: b ^ 0x80 is b + 128; under the exponent byte 0x4B it is the f32
// 2^23 + b + 128, and one subtraction gives b exactly (no int-to-float
// conversion).
template <> struct Widen<W_I8> {
  static constexpr int PER = 16;
  __device__ __forceinline__ static float one(uint32_t u, uint32_t sel) {
    return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
  }
  __device__ __forceinline__ static void pairs(uint4 v, uint32_t* p) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
      p[2 * i] = pack_bf16(one(u, 0x7440), one(u, 0x7441));
      p[2 * i + 1] = pack_bf16(one(u, 0x7442), one(u, 0x7443));
    }
  }
};

// Four packed int4 bytes (byte j: column c + j in its low nibble, c +
// group/2 + j in its high one): lo[0] the bf16 pair of bytes 0, 1's low
// nibbles, lo[1] of bytes 2, 3's; hi[] their high nibbles. The byte permute
// that spreads the nibbles puts 0x43 above each, so a 16-bit half is the
// bf16 of 128 + q (csrc/gemm.cu's i4_pairs ORs 0x4300); one bf16x2
// subtraction of 136 leaves q - 8, exact.
__device__ __forceinline__ void i4_quad(uint32_t w, uint32_t* lo, uint32_t* hi) {
  const uint32_t l = w & 0x0f0f0f0fu, h = (w >> 4) & 0x0f0f0f0fu;
  const __nv_bfloat162 off = as_bf162(0x43084308u);  // 136, 136
  lo[0] = bf162_bits(__hsub2(as_bf162(__byte_perm(l, 0x43u, 0x4140)), off));
  lo[1] = bf162_bits(__hsub2(as_bf162(__byte_perm(l, 0x43u, 0x4342)), off));
  hi[0] = bf162_bits(__hsub2(as_bf162(__byte_perm(h, 0x43u, 0x4140)), off));
  hi[1] = bf162_bits(__hsub2(as_bf162(__byte_perm(h, 0x43u, 0x4342)), off));
}

// c += A . B, mma.sync.m16n8k16 bf16 -> f32: a0 (row g, k 2t..2t+1), a1
// (row g+8, same k), a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..); b0 (k
// 2t.., column g), b1 (k 2t+8.., column g); c0, c1 (row g, columns 2t, 2t+1),
// c2, c3 (row g+8, the same columns).
__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// P consecutive bf16 of a staged x row as P / 2 pairs (16-byte aligned; 8
// bytes for P = 4); zeros for a column of the mma past nb.
template <int P>
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, bool live, uint32_t* o) {
  if constexpr (P == 4) {
    const uint2 u = live ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
    o[0] = u.x;
    o[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < P / 8; ++i) {
      const uint4 u = live ? reinterpret_cast<const uint4*>(p)[i] : make_uint4(0u, 0u, 0u, 0u);
      o[4 * i] = u.x;
      o[4 * i + 1] = u.y;
      o[4 * i + 2] = u.z;
      o[4 * i + 3] = u.w;
    }
  }
}

// Bytes of a weight row and K columns of one iteration, by weight type.
template <int WT> struct Layout {
  static constexpr bool I4 = WT == W_I4;
  static constexpr int COLS = I4 ? 2 * WIN : WIN / (16 / Widen<I4 ? W_E5M2 : WT>::PER);
  __host__ __device__ __forceinline__ static size_t row_bytes(int K) {
    return I4 ? (size_t)K / 2 : (size_t)K * (16 / Widen<I4 ? W_E5M2 : WT>::PER);
  }
};

// The block's weight row held at tile row g (h = 0) or g + 8 (h = 1) of
// warp w, and whether it exists. Plain: rows n0 + 16w + g (+ 8). GLU (n0 a
// pair): tile row g is h1 of pair n0 + 8w + g (W13 row p), row g + 8 its h3
// (row N/2 + p), so a thread's c0/c1 and c2/c3 are one pair's two halves.
template <bool GLU>
__device__ __forceinline__ int tile_row(int blk, int w, int g, int h, int N, bool* ok) {
  if (GLU) {
    const int H = N / 2, p = blk * (ROWS / 2) + 8 * w + g;
    *ok = p < H;
    return h ? H + p : p;
  }
  const int n = blk * ROWS + 16 * w + g + 8 * h;
  *ok = n < N;
  return n;
}

// One iteration's loads into a ring slot: for rows g and g + 8 of the
// thread's tile, bytes 16t.. and 64 + 16t.. of the iteration's 128 (each
// load instruction of the warp reads 64 contiguous bytes of 8 rows); zeros
// past the row's end or for a row past N. int4: also the group scales of
// both rows for the iteration's group.
template <int WT>
__device__ __forceinline__ void load_iter(uint4 (&v)[4], float (&sc)[2], const uint8_t* w0,
                                          const uint8_t* w1, bool ok0, bool ok1, long long lim,
                                          int it, const float* gs0, const float* gs1, int N,
                                          int group) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long o = (long long)it * WIN + 64 * h;
    const bool in = o < lim;  // rows are whole 16-byte chunks: a chunk is all in or all out
    v[h] = ok0 && in ? ld_stream(w0 + o) : make_uint4(0u, 0u, 0u, 0u);
    v[2 + h] = ok1 && in ? ld_stream(w1 + o) : make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (WT == W_I4) {
    const size_t gi = (size_t)it * (2 * WIN) / group;
    sc[0] = ok0 ? __ldg(gs0 + gi * N) : 0.f;
    sc[1] = ok1 ? __ldg(gs1 + gi * N) : 0.f;
  }
}

// The products of slice iteration i (a ring slot's loads v, its int4 group
// scales sc) over NT n8 tiles of x: tile j holds x rows 8j..8j+7, row 8j + g
// staged at xg[j] (live[j]: a row below nb; zeros past it). The weights'
// fragments are built once and shared by the tiles; each tile's mma
// sequence is gemv_kernel's (NT = 1 is its loop body). int4: each group
// sums into a fresh gacc, scaled into acc at the group's last iteration
// (the slice starts on a group boundary).
template <int WT, int NT>
__device__ __forceinline__ void mma_iter(float (&acc)[NT][4], float (&gacc)[NT][4],
                                         const uint4 (&v)[4], const float (&sc)[2],
                                         const __nv_bfloat16* const (&xg)[NT],
                                         const bool (&live)[NT], int i, int t, int group) {
  using LY = Layout<WT>;
  if constexpr (LY::I4) {
    const int ipg = group / (2 * WIN);  // iterations per group (1 or 2)
    const int lg = i / ipg, gb = (i - lg * ipg) * WIN;
    if (gb == 0)
#pragma unroll
      for (int j = 0; j < NT; ++j) gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = lg * group + gb + 64 * h + 16 * t;  // x column of the low nibbles
      uint32_t lo0[8], hi0[8], lo1[8], hi1[8];
      const uint32_t u0[4] = {v[h].x, v[h].y, v[h].z, v[h].w};
      const uint32_t u1[4] = {v[2 + h].x, v[2 + h].y, v[2 + h].z, v[2 + h].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        i4_quad(u0[q], lo0 + 2 * q, hi0 + 2 * q);
        i4_quad(u1[q], lo1 + 2 * q, hi1 + 2 * q);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t xlo[8], xhi[8];
        load_x<16>(xg[j] + col, live[j], xlo);
        load_x<16>(xg[j] + col + group / 2, live[j], xhi);
#pragma unroll
        for (int s = 0; s < 8; ++s)
          mma16816(gacc[j], lo0[s], lo1[s], hi0[s], hi1[s], xlo[s], xhi[s]);
      }
    }
    if (gb + WIN == group / 2)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] = fmaf(gacc[j][0], sc[0], acc[j][0]);
        acc[j][1] = fmaf(gacc[j][1], sc[0], acc[j][1]);
        acc[j][2] = fmaf(gacc[j][2], sc[1], acc[j][2]);
        acc[j][3] = fmaf(gacc[j][3], sc[1], acc[j][3]);
      }
  } else {
    constexpr int PER = Widen<WT>::PER, COLS = LY::COLS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t p0[PER / 2], p1[PER / 2];
      Widen<WT>::pairs(v[h], p0);
      Widen<WT>::pairs(v[2 + h], p1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t xb[PER / 2];
        load_x<PER>(xg[j] + i * COLS + h * (COLS / 2) + t * PER, live[j], xb);
#pragma unroll
        for (int s = 0; s < PER / 4; ++s)
          mma16816(acc[j], p0[2 * s], p1[2 * s], p0[2 * s + 1], p1[2 * s + 1], xb[2 * s],
                   xb[2 * s + 1]);
      }
    }
  }
}

// A GEMV plan's slices cover the row's iterations exactly (ops/cuda/gemv.py:
// gemv_plan): kchunk iterations a slice, `split` slices; int4 (group > 0)
// slices of whole groups.
inline bool plan_ok(int wtype, int K, int group, int kchunk, int split) {
  const size_t rb = wtype == W_I4 ? (size_t)K / 2
                                  : (size_t)K * (wtype == W_F32 ? 4 : wtype == W_BF16 ? 2 : 1);
  const long long nit = (long long)((rb + WIN - 1) / WIN);
  if (kchunk < 1 || split < 1 || (long long)(split - 1) * kchunk >= nit ||
      (long long)split * kchunk < nit || rb % 16)
    return false;
  if (wtype == W_I4)
    return (group == 256 || group == 512) && K % group == 0 && kchunk % (group / (2 * WIN)) == 0;
  return group == 0;
}

}  // namespace gemv

// Flags between the blocks of one cooperative launch (csrc/block.cu,
// csrc/ffn.cu). A release is the writer's __threadfence(), __syncthreads()
// and one atomic; a wait is thread 0's ld.acquire loop, then the block's
// next __syncthreads(); what another SM wrote in the launch is read through
// L2 (ld.global.cg).
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Thread 0 waits until *flag >= n (another block's release); the block
// waits for thread 0 at the next __syncthreads(). (A __nanosleep between
// polls measured ~1% slower in csrc/block.cu.)
__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned n) {
  if (threadIdx.x == 0)
    while (ld_acquire(flag) < n) {
    }
}

// This block's writes, then one arrival on flag.
__device__ __forceinline__ void release(unsigned* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(flag, 1u);
}

// One cooperative launch of KERN(a) on `grid` blocks of `threads`, at most
// as many as are co-resident: the card launches it only if every block is,
// which the waits between the phases need. The SM count and the co-resident
// blocks per SM at the size last asked are kept per kernel and device (the
// occupancy query costs host time). Returns a cudaError_t, or ERR_ARGS.
template <auto KERN, typename Args>
int launch_cooperative(const Args& a, size_t smem, int grid, int threads, cudaStream_t st) {
  static int sms[32] = {}, asked[32] = {}, per_sm[32] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return ERR_ARGS;
  if (asked[dev] != (int)smem) {
    if ((err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (smem > 48 * 1024 &&
         (err = cudaFuncSetAttribute(KERN, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem)) != cudaSuccess) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], KERN, threads,
                                                             smem)) != cudaSuccess)
      return (int)err;
    asked[dev] = (int)smem;
  }
  if (per_sm[dev] < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid < per_sm[dev] * sms[dev] ? grid : per_sm[dev] * sms[dev]);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, KERN, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace yt
