// Fused decode attention step over the layer-stacked KV ring buffer, a bf16
// or an fp8-e5m2 cache (template parameter T): for one sequence split over
// its slots (flash-decoding), for B lanes of a continuous batch in one
// launch, or for B lanes over a page pool.
//
// Replaces yalm_tpu/ops/pallas/attention.py:attend_step_l (body
// _fused_attn_body, _flash_heads, _lazy_sink_rotate; numerics reference
// _attn_step_ref :775-802) and is the middle of ops/pallas/block.py:attn_block_l;
// :attend_one_l (:85; numerics reference its emulation branch :98-102) is
// the one-lane split with no RoPE, no write and no sinks. The batched entry
// replaces :attend_step_batched_l (kernel _attn_step_batched_kernel;
// numerics reference its emulation branch, per-lane _attn_step_ref, and for
// write-masked lanes _attend_ref over the unwritten cache with the sink
// view). The paged entry replaces :attend_step_paged_l (kernel
// _attn_step_paged_kernel; numerics reference its emulation branch
// :1119-1159, the batched step on each lane's gathered view): the batched
// kernel, with lane b's logical slot s at pool row (tables[b, s / page],
// layer, s % page) of a (n_pages, L, page, Hk, D) pool. The addressing is a
// template parameter (kPaged), so the dense instance keeps its code; the
// page is resolved per row (any page size that divides the window), with
// 64-bit pool offsets (a bf16 pool of 257 pages at 7B shapes holds 2.16e9
// elements). Before anything else a block checks every page id its lane
// reads or writes (blocks below ceil(max(kv_len, kv_pos + 1) / page)); one
// outside [0, n_pages) gives the lane a NaN output and no write, as a bad
// lane scalar does.
//
// The numerics, every entry alike (the JAX emulation's exactly, _attend_ref:
// normalise, then cast p to bf16 -- not the Pallas kernel's online softmax,
// which normalises after the cast: across a 32-layer model the two differ
// by ~1% of the logits, and the emulation's way is the reference):
//   1. RoPE on q (then * 1/sqrt(D), rounded to bf16) and on k_new at `pos`,
//      from a (D/2,) f32 pair-frequency table computed on the host (so every
//      rope scaling kind lives in ops/core.py) and `mscale`; accurate
//      sinf/cosf, since angles reach pos * freq ~ 4e3 rad. Rotations are
//      separate f32 products and a difference (__fmul_rn, __fsub_rn), never
//      contracted into an fma, so they round as torch's and XLA's
//      elementwise ops do and the written rows match theirs.
//   2. The rounded k/v rows go into ring slot kv_pos of head h, IN PLACE:
//      rounded from f32 to the cache type in one step (for e5m2 not through
//      bf16, which would round twice; _attn_step_ref :790-793). A lane whose
//      `write` is 0 (batched entries) writes nothing and attends the cache
//      as it is.
//   3. Scores of the slots < kv_len: bf16 q . bf16 k (the cache widened to
//      bf16, exact from e5m2) summed in f32. In the ring regime (kv_sink >
//      0) the first kv_sink rows are read through the lazy StreamingLLM sink
//      view: rotated by max(0, pos - S + 1) positions (mscale 1) and rounded
//      to bf16, the working type for both caches (_sink_view_ref :706-721);
//      the cache keeps the sink keys as written.
//   4. The Gemma forms (attend_step_l's softcap, win and alt arguments):
//      softcap > 0: each scaled score s becomes cap * tanhf(s / cap), IEEE
//      division and the accurate tanhf, BEFORE the validity mask (a masked
//      slot stays at the mask value, -1e30, not at -cap); win > 0 (a sliding
//      layer): slot s is attended iff s < kv_len and its age < win, the age
//      as _slot_age (:197-205) computes it -- a sink slot S-1-s, any other
//      (kv_pos - s) mod (S - kv_sink), over the lane's logical slots (so in
//      the ring regime the sinks, older than any window shorter than S, drop
//      out); in the linear regime (kv_sink 0, the lane's own slot its
//      newest) reading starts at lo = max(kv_len - win, 0) rounded down to
//      a tile, as the TPU kernel skips the blocks below the window
//      (:295-306); alt (Gemma3's local rope): the host passes the
//      local-theta table as `freq`, for q, k_new and the sink view alike.
//   5. An f32 softmax over the scores (max, exp, sum, divide), each
//      normalised p rounded to bf16; out = sum over slots of bf16(p) .
//      bf16(v) in f32.
//
// ONE LANE (yt_attend_step, K2; yt_attend_one, K12): split over its slots.
//   Bound on this card: bytes, the K/V rows attended (16 MB per layer at
//   4096 slots x 8 heads x 128 x bf16 x 2, half that for e5m2; a sliding
//   layer only its window's). Per slot and kv head the step reads 2 D cache
//   elements and does 4 qpk D flops: 4 flops per byte on bf16, 8 on e5m2,
//   against the ~295 at which the tensor cores would bind. So q . k and p .
//   v run on the CUDA cores (no mma.sync: an m16n8k16 tile would waste half
//   its rows at qpk <= 8 and save nothing the memory is not already
//   waiting for), and what the design buys is many blocks and loads in
//   flight. The one-block-per-kv-head kernel of PR 1-6 (the batched one
//   below, with B = 1) ran 8 blocks on 132 SMs, each streaming its head's
//   rows one synchronous tile at a time: ~49 GB/s for the card.
//   The host (ops/cuda/attention.py:split_plan) cuts [lo, kv_len) into
//   nsplit chunks of `chunk` slots, a multiple of the 64-row tile, sized so
//   that Hk x the live chunks is about two waves of 132 SMs (32 chunks of
//   128 slots x 8 heads = 256 blocks at 4096 slots). Two launches on a
//   (nsplit, Hk) grid, on one stream:
//   Pass 1 (split_scores_kernel), block (c, h): the block whose chunk holds
//     kv_pos writes head h's new k/v rows first, then __syncthreads(): only
//     that block reads that row in pass 1 (pass 2, a later launch, reads the
//     v row). If kv_pos lies outside every chunk (kv_pos >= kv_len or below
//     lo), block (0, h) writes it and no block reads it. Each block ropes
//     and scales q itself; the chunk holding slot 0 applies the sink view
//     (rows read from the cache into a bf16 buffer). K rows stream through
//     a double-buffered cp.async pipeline of 64-row tiles: the next tile is
//     in flight while this one is scored. The f32 scores go to an
//     L2-resident global scratch (Hk, kv_len - lo, qpk), and the chunk's
//     m_c = max and l_c = sum exp(s - m_c) per query to (Hk, nsplit, qpk, 2).
//   Pass 2 (split_values_kernel), block (c, h): reads the nsplit pairs of
//     its head in a fixed order (lane-strided, then a butterfly) and forms m
//     = max m_c, l = sum l_c exp(m_c - m) -- every block the same bits; p =
//     bf16(exp(s - m) / l), the reference's normalise-then-cast (only the
//     order of the f32 sum differs); streams its V rows through the same
//     pipeline and writes a partial (qpk, D) f32 sum. The last block of the
//     head to arrive (__threadfence() and atomicInc on a per-head counter
//     that the wrapper holds; atomicInc wraps it back to 0, so every call
//     leaves it at 0) sums the partials in chunk order: the result is
//     deterministic, two calls give the same bits.
//   A sliding layer in the ring regime reads only its window: a chunk in
//   which no slot has age < win (chunk_live, O(1)) reads no K/V row and
//   contributes m_c = -inf, l_c = 0 and a zero partial. That is exact: a
//   masked slot's p is bf16(exp(-1e30 - m) / l) = 0. The host turns the
//   skip off unless kv_pos is a live slot (kv_sink <= kv_pos < kv_len), so
//   some chunk is always live.
//
// B LANES (yt_attend_step_batched, K8; yt_attend_step_paged, K9): the same
//   two passes on a (Hk, B, nsplit) grid, split over the window's slots.
//   Bound: bytes, the K/V rows every lane attends (126 MB per layer for 16
//   lanes of 1..4096 slots at Mistral's shapes, bf16). Each lane's (kv_pos,
//   kv_len, kv_sink, pos, write) comes from a (5, B) int32 device array
//   uploaded once per tick, so no layer waits for the host, and every block
//   reads its lane's scalars itself. The host's plan
//   (ops/cuda/attention.py:lanes_split_plan) is a function of the window S
//   and the head count alone: chunk c of every lane holds slots [c chunk,
//   (c + 1) chunk), so the grid, the scratch and a lane's bits do not depend
//   on B or on any lane's scalars (a lane alone and among 16 gives the same
//   bits; a tick's launches can be captured in a CUDA graph). Dead chunks
//   are decided on the device: the blocks of a chunk past kv_len return at
//   once and take no part in the lane's sums (pass 2 counts its
//   ceil(kv_len / chunk) chunks), so a short lane costs little more than
//   one block per head; on a sliding layer a chunk with no slot of age <
//   win (chunk_live, applied only while kv_pos is a slot the lane attends,
//   kv_sink <= kv_pos < kv_len, so some chunk is always live) reads no row
//   and gives m_c = -inf, l_c = 0 and a zero partial. A lane whose kv_len
//   fits one chunk is finished by its pass-1 block: its m and l are that
//   chunk's, which is what pass 2's combine gives for one chunk, bit for
//   bit, so the block goes on to p . v and writes the output, and pass 2's
//   blocks of the lane return at once. The block whose chunk holds kv_pos
//   writes the lane's new rows (write != 0) before it reads, live or not.
//   The grid is chunk-major, so every lane's chunk 0 is dispatched first,
//   and pass 2 is a programmatic dependent launch: its blocks with nothing
//   to do exit while pass 1's tail runs. Offsets are 64-bit (a (16, 32,
//   4096, 8, 128) cache holds 2^31 elements). The arithmetic is the
//   one-lane split's, so the dense and the paged instance give the same
//   bits on the same rows.
//   Paged (kPaged): lane b's logical slot s at pool row (tables[b, s /
//   page], layer, s % page); a tile of 64 rows is one copy base when the
//   page is a multiple of the tile, else each row is resolved (pages of 16
//   or 48). Every block checks every page id its lane reads or writes
//   (blocks below ceil(max(kv_len, kv_pos + 1) / page)), so all blocks of a
//   lane reach one verdict; a bad id or lane scalar gives the lane a NaN
//   output, no write and no counter arrival.
//
// B LANES, THE EARLIER DESIGN (yt_attend_step_batched_v1,
// yt_attend_step_paged_v1; only chip_smoke.py calls them, for the same-run
// time of the design the split replaced): one launch, one block per (kv
// head h, lane b), each streaming its lane's rows in tiles of 64 through
// shared memory: every score kept in shared memory while its kv_len * qpk
// floats fit, else in a global (B, Hk, S, qpk) scratch the caller passes as
// `scores`. Only block (h, b) reads head h of lane b, so after
// __syncthreads() its reads see the row it wrote. A batch of 16 lanes runs
// 128 blocks, each loading its tiles synchronously through registers. This
// kernel's text is PR 6's, unlaunched one-lane branches included (see
// attend_step_kernel).
#include "attention.cuh"

using namespace yt;
using namespace yt::attn;

namespace {

// ---------------------------------------------------------------------------
// One lane, split over its slots (K2, K12)
// ---------------------------------------------------------------------------

struct SplitArgs {
  const float* q;        // (Hk, qpk, D) unrotated, unscaled (K12: as it is)
  const float* k_new;    // (Hk, D) unrotated
  const float* v_new;    // (Hk, D)
  void* k_all;           // (L, S, Hk, D) of the cache type T, updated in place
  void* v_all;
  const float* freq;     // (D/2,) rope pair frequencies
  float* out;            // (Hk, qpk, D)
  float* scores;         // (Hk, kv_len - lo, qpk)
  float* ml;             // (Hk, nsplit, qpk, 2): each chunk's max and sum
  float* part;           // (Hk, nsplit, qpk, D): each chunk's partial output
  unsigned* counter;     // (Hk,) pass-2 arrivals, 0 between calls
  float mscale, inv_sqrt_d;
  float sqrt_d;          // K12: q is divided by this (f32 sqrt(D))
  float softcap;         // > 0: Gemma2's score cap
  int win;               // > 0: the layer's sliding window (age < win)
  int layer, S, Hk, qpk, D, kv_pos, kv_len, kv_sink, pos;
  int lo, chunk, nsplit; // the split: chunk c holds slots [lo + c chunk, ...) < kv_len
  int skip;              // 1: a chunk with no slot of age < win reads nothing
};

template <typename T, bool kOne>
__global__ void __launch_bounds__(THREADS) split_scores_kernel(SplitArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, qpk = a.qpk, half = D / 2, ci = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, RS = D + KPAD;
  const int n = a.kv_len, lo = a.lo, S = a.S;
  const int c0 = lo + ci * a.chunk, c1 = min(c0 + a.chunk, n);
  const size_t stride = (size_t)a.Hk * D;  // elements from one slot's row to the next
  T* k_all = static_cast<T*>(a.k_all);
  T* v_all = static_cast<T*>(a.v_all);
  const size_t head = ((size_t)a.layer * S * a.Hk + h) * D;  // slot 0 of head h
  const float posf = (float)a.pos;

  if (!kOne) {
    const int writer = (a.kv_pos >= lo && a.kv_pos < n) ? (a.kv_pos - lo) / a.chunk : 0;
    if (ci == writer) {  // 2: the new rows, before this block reads its chunk
      const size_t new_row = head + (size_t)a.kv_pos * stride;
      const float* kn = a.k_new + (size_t)h * D;
      const float* vn = a.v_new + (size_t)h * D;
      for (int p = tid; p < half; p += THREADS) {
        const float ang = posf * a.freq[p];
        const float c = a.mscale * cosf(ang), s = a.mscale * sinf(ang);
        const float x0 = kn[2 * p], x1 = kn[2 * p + 1];
        k_all[new_row + 2 * p] = KV<T>::from_float(rot_re(x0, x1, c, s));
        k_all[new_row + 2 * p + 1] = KV<T>::from_float(rot_im(x0, x1, c, s));
      }
      for (int d = tid; d < D; d += THREADS) v_all[new_row + d] = KV<T>::from_float(vn[d]);
      __syncthreads();
    }
  }
  float* ml = a.ml + ((size_t)h * a.nsplit + ci) * qpk * 2;
  if (a.skip && !chunk_live(c0, c1, a.kv_pos, a.kv_sink, S, a.win)) {
    for (int j = tid; j < qpk; j += THREADS) {
      ml[2 * j] = -INFINITY;
      ml[2 * j + 1] = 0.f;
    }
    return;
  }

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // (qpk, RS)
  const int nsink = (!kOne && c0 == 0) ? a.kv_sink : 0;        // the sink view's rows here
  __nv_bfloat16* sinks = reinterpret_cast<__nv_bfloat16*>(smem + align16((size_t)qpk * RS * 2));
  T* tiles = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sinks) +
                                  align16((size_t)(kOne ? 0 : a.kv_sink) * RS * 2));
  const int tile_elems = (int)(align16((size_t)TILE * RS * sizeof(T)) / sizeof(T));
  const int ntiles = (c1 - c0 + TILE - 1) / TILE;
  load_tile(tiles, k_all + head, stride, c0, min(TILE, c1 - c0), D);
  if (ntiles > 1) load_tile(tiles + tile_elems, k_all + head, stride, c0 + TILE,
                            min(TILE, c1 - c0 - TILE), D);

  // 1: q, roped and scaled (K12: divided by sqrt(D)), rounded to bf16
  const float* q = a.q + (size_t)h * qpk * D;
  if (kOne) {
    for (int i = tid; i < qpk * D; i += THREADS) {
      const int j = i / D, d = i - j * D;
      qs[j * RS + d] = __float2bfloat16_rn(__fdiv_rn(q[i], a.sqrt_d));
    }
  } else {
    for (int i = tid; i < qpk * half; i += THREADS) {
      const int j = i / half, p = i - j * half;
      const float ang = posf * a.freq[p];
      const float c = a.mscale * cosf(ang), s = a.mscale * sinf(ang);
      const float x0 = q[j * D + 2 * p], x1 = q[j * D + 2 * p + 1];
      qs[j * RS + 2 * p] = __float2bfloat16_rn(__fmul_rn(rot_re(x0, x1, c, s), a.inv_sqrt_d));
      qs[j * RS + 2 * p + 1] = __float2bfloat16_rn(__fmul_rn(rot_im(x0, x1, c, s), a.inv_sqrt_d));
    }
    // 3: the lazy sink view, from the cache (this block wrote any sink row
    // it holds before the barrier above)
    const float rot = (float)max(0, a.pos - S + 1);
    for (int i = tid; i < nsink * half; i += THREADS) {
      const int r = i / half, p = i - r * half;
      const float ang = rot * a.freq[p];
      const float c = cosf(ang), s = sinf(ang);
      const T* kr = k_all + head + (size_t)r * stride;
      const float x0 = KV<T>::widen1(kr[2 * p]), x1 = KV<T>::widen1(kr[2 * p + 1]);
      sinks[r * RS + 2 * p] = __float2bfloat16_rn(rot_re(x0, x1, c, s));
      sinks[r * RS + 2 * p + 1] = __float2bfloat16_rn(rot_im(x0, x1, c, s));
    }
  }

  // 3-4: the chunk's scores, one (slot, query) dot per thread
  float* sc = a.scores + (size_t)h * (n - lo) * qpk;  // slot s at (s - lo) * qpk
  const int ring = max(S - a.kv_sink, 1);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int t0 = c0 + t * TILE, nt = min(TILE, c1 - t0);
    const T* tile = tiles + (t & 1) * tile_elems;
    for (int i = tid; i < nt * qpk; i += THREADS) {
      const int r = i / qpk, j = i - r * qpk, s = t0 + r;
      float dot = s < nsink ? dot_row(sinks + s * RS, qs + j * RS, D)
                            : dot_row(tile + r * RS, qs + j * RS, D);
      if (a.softcap > 0.f) dot = __fmul_rn(a.softcap, tanhf(__fdiv_rn(dot, a.softcap)));
      if (a.win > 0 && slot_age(s, a.kv_pos, a.kv_sink, S, ring) >= a.win) dot = NEG_BIG;
      sc[(size_t)(s - lo) * qpk + j] = dot;
    }
    __syncthreads();
    if (t + 2 < ntiles) load_tile(tiles + (t & 1) * tile_elems, k_all + head, stride,
                                  t0 + 2 * TILE, min(TILE, c1 - t0 - 2 * TILE), D);
  }

  // 5 (this chunk's share): m_c and l_c per query, one warp each. Only this
  // block wrote these scores, so __syncthreads() ordered them.
  for (int j = warp; j < qpk; j += WARPS) {
    float m = -INFINITY;
    for (int r = c0 - lo + lane; r < c1 - lo; r += 32) m = fmaxf(m, sc[(size_t)r * qpk + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = c0 - lo + lane; r < c1 - lo; r += 32) l += expf(sc[(size_t)r * qpk + j] - m);
    l = warp_sum(l);
    if (lane == 0) {
      ml[2 * j] = m;
      ml[2 * j + 1] = l;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) split_values_kernel(SplitArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int D = a.D, qpk = a.qpk, ci = blockIdx.x, h = blockIdx.y, nsplit = a.nsplit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, RS = D + KPAD;
  const int n = a.kv_len, lo = a.lo, nout = qpk * D;
  const int c0 = lo + ci * a.chunk, c1 = min(c0 + a.chunk, n);
  const size_t stride = (size_t)a.Hk * D;
  const T* v_all = static_cast<const T*>(a.v_all);
  const size_t head = ((size_t)a.layer * a.S * a.Hk + h) * D;
  const float* mlh = a.ml + (size_t)h * nsplit * qpk * 2;
  float* part = a.part + ((size_t)h * nsplit + ci) * nout;
  // p . v: thread (slice sl, group g) sums the rows r = sl mod R of output
  // columns 8g..8g+7 (query j = 8g / D) in registers
  const int G = nout / 8, R = THREADS / G, g = tid % G, sl = tid / G;
  const int j = 8 * g / D, d0 = 8 * g - j * D;
  float* ms = reinterpret_cast<float*>(smem);             // (qpk) m, then (qpk) l
  float* ps = reinterpret_cast<float*>(smem + align16(2 * qpk * 4));     // (TILE, qpk)
  float* red = ps + align16((size_t)TILE * qpk * 4) / 4;                 // (R, G, 8)
  T* tiles = reinterpret_cast<T*>(red + THREADS * 8);
  const int tile_elems = (int)(align16((size_t)TILE * RS * sizeof(T)) / sizeof(T));

  if (a.skip && !chunk_live(c0, c1, a.kv_pos, a.kv_sink, a.S, a.win)) {
    for (int i = tid; i < nout; i += THREADS) part[i] = 0.f;
  } else {
    const int ntiles = (c1 - c0 + TILE - 1) / TILE;
    load_tile(tiles, v_all + head, stride, c0, min(TILE, c1 - c0), D);
    if (ntiles > 1) load_tile(tiles + tile_elems, v_all + head, stride, c0 + TILE,
                              min(TILE, c1 - c0 - TILE), D);
    // m and l over the head's chunks, the same order in every block
    for (int jj = warp; jj < qpk; jj += WARPS) {
      float m = -INFINITY;
      for (int c = lane; c < nsplit; c += 32) m = fmaxf(m, mlh[(c * qpk + jj) * 2]);
      m = warp_max(m);
      float l = 0.f;
      for (int c = lane; c < nsplit; c += 32) {
        const float* e = mlh + (c * qpk + jj) * 2;
        l = fmaf(e[1], expf(e[0] - m), l);
      }
      l = warp_sum(l);
      if (lane == 0) {
        ms[jj] = m;
        ms[qpk + jj] = l;
      }
    }
    const float* sc = a.scores + (size_t)h * (n - lo) * qpk;
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      const int t0 = c0 + t * TILE, nt = min(TILE, c1 - t0);
      __syncthreads();   // m and l are in; the last tile's p is no longer read
      const float* st = sc + (size_t)(t0 - lo) * qpk;
      for (int i = tid; i < nt * qpk; i += THREADS) {
        const int jj = i % qpk;
        ps[i] = bf16_round(__fdiv_rn(expf(st[i] - ms[jj]), ms[qpk + jj]));
      }
      if (t + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      const T* tile = tiles + (t & 1) * tile_elems;
      if (sl < R) {
        for (int r = sl; r < nt; r += R) {
          float vf[8];
          KV<T>::widen8(tile + r * RS + d0, vf);
          const float p = ps[r * qpk + j];
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = fmaf(p, vf[k], acc[k]);
        }
      }
      __syncthreads();
      if (t + 2 < ntiles) load_tile(tiles + (t & 1) * tile_elems, v_all + head, stride,
                                    t0 + 2 * TILE, min(TILE, c1 - t0 - 2 * TILE), D);
    }
    if (sl < R)
#pragma unroll
      for (int k = 0; k < 8; ++k) red[(sl * G + g) * 8 + k] = acc[k];
    __syncthreads();
    for (int i = tid; i < nout; i += THREADS) {  // the row slices, in order
      const int gi = i / 8, k = i - gi * 8;
      float o = 0.f;
      for (int s = 0; s < R; ++s) o += red[(s * G + gi) * 8 + k];
      part[i] = o;
    }
  }

  // the head's last block to arrive sums the partials in chunk order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicInc(a.counter + h, nsplit - 1u) == nsplit - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* parts = a.part + (size_t)h * nsplit * nout;
  float* out = a.out + (size_t)h * nout;
  for (int i = 4 * tid; i < nout; i += 4 * THREADS) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < nsplit; ++c) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(parts + (size_t)c * nout + i));
      o.x += p.x;
      o.y += p.y;
      o.z += p.z;
      o.w += p.w;
    }
    *reinterpret_cast<float4*>(out + i) = o;
  }
}

template <typename T, bool kOne>
int launch_split(const SplitArgs& a, cudaStream_t st) {
  const size_t s1 = scores_smem(a.qpk, a.D, kOne ? 0 : a.kv_sink, sizeof(T));
  const size_t s2 = values_smem(a.qpk, a.D, sizeof(T));
  if (s1 > SMEM_MAX || s2 > SMEM_MAX) return ERR_ARGS;
  const auto k1 = split_scores_kernel<T, kOne>;
  const auto k2 = split_values_kernel<T>;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e;
  if (s1 > 48 * 1024 && (e = cudaFuncSetAttribute(k1, attr, (int)s1)) != cudaSuccess) return (int)e;
  if (s2 > 48 * 1024 && (e = cudaFuncSetAttribute(k2, attr, (int)s2)) != cudaSuccess) return (int)e;
  const dim3 grid(a.nsplit, a.Hk);
  k1<<<grid, THREADS, s1, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  k2<<<grid, THREADS, s2, st>>>(a);
  return (int)cudaGetLastError();
}

// the split's checks and scratch layout (ops/cuda/attention.py:split_scratch
// lays it out the same): scores | ml, padded to 4 floats | partials
int split(int kv_type, SplitArgs& a, float* scratch, unsigned* counter, bool one,
          cudaStream_t st) {
  const long long rows = (long long)a.kv_len - a.lo;
  if (!scratch || !counter || a.chunk < TILE || a.chunk % TILE || a.nsplit < 1 ||
      a.nsplit > MAX_SPLIT || a.lo < 0 || rows < 1 || a.lo % TILE ||
      (long long)(a.nsplit - 1) * a.chunk >= rows || (long long)a.nsplit * a.chunk < rows ||
      (a.skip != 0 && a.skip != 1) || (a.skip && a.win <= 0) || !(a.softcap >= 0.f))
    return ERR_ARGS;
  const size_t head = (size_t)a.Hk * rows * a.qpk + (size_t)a.Hk * a.nsplit * a.qpk * 2;
  a.scores = scratch;
  a.ml = scratch + (size_t)a.Hk * rows * a.qpk;
  a.part = scratch + ((head + 3) & ~(size_t)3);
  a.counter = counter;
  using BF = __nv_bfloat16;
  if (kv_type == W_BF16)
    return one ? launch_split<BF, true>(a, st) : launch_split<BF, false>(a, st);
  if (kv_type == W_E5M2)
    return one ? launch_split<uint8_t, true>(a, st) : launch_split<uint8_t, false>(a, st);
  return ERR_ARGS;
}

// ---------------------------------------------------------------------------
// B lanes, split over the window's slots (K8, K9)
// ---------------------------------------------------------------------------

struct LanesArgs {
  const float* q;        // (B, Hk, qpk, D) unrotated, unscaled
  const float* k_new;    // (B, Hk, D) unrotated
  const float* v_new;    // (B, Hk, D)
  void* k_all;           // (B, L, S, Hk, D), or a pool (n_pages, L, page, Hk, D);
  void* v_all;           // of the cache type T, updated in place
  const float* freq;     // (D/2,) rope pair frequencies
  float* out;            // (B, Hk, qpk, D)
  float* scores;         // (B, Hk, S, qpk)
  float* ml;             // (B, Hk, nsplit, qpk, 2): each chunk's max and sum
  float* part;           // (B, Hk, nsplit, qpk, D): each chunk's partial output
  unsigned* counter;     // (B, Hk) pass-2 arrivals, 0 between calls
  const int* lanes;      // (5, B) kv_pos, kv_len, kv_sink, pos, write
  const int* tables;     // (B, S / page) page ids of the paged launch, else null
  size_t lane_stride;    // elements of one lane's dense cache, L * S * Hk * D
  float mscale, inv_sqrt_d;
  float softcap;         // > 0: Gemma2's score cap
  int win;               // > 0: the layer's sliding window (age < win)
  int layer, S, Hk, qpk, D, kv_sinks, B;
  int L, page, n_pages;  // the paged launch's pool: layers, slots per page, pages
  int chunk, nsplit;     // chunk c holds slots [c chunk, (c + 1) chunk) of the window
};

// One lane's scalars as every block of the lane reads them; bad: a scalar
// the kernel does not take (the host checks the ones it uploads).
struct Lane {
  int kv_pos, n, kv_sink, pos;
  bool write, bad;
};

__device__ __forceinline__ Lane read_lane(const LanesArgs& a, int b) {
  Lane l;
  l.kv_pos = a.lanes[b];
  l.n = a.lanes[a.B + b];
  l.kv_sink = a.lanes[2 * a.B + b];
  l.pos = a.lanes[3 * a.B + b];
  l.write = a.lanes[4 * a.B + b] != 0;
  l.bad = l.n < 1 || l.n > a.S || l.kv_pos < 0 || l.kv_pos >= a.S || l.kv_sink < 0 ||
          l.kv_sink > a.kv_sinks;
  return l;
}

// Whether every page id a good lane reads or writes lies in the pool: a
// block vote, so every thread of the block calls it, and every block of the
// lane that does reaches the same verdict.
__device__ __forceinline__ bool pages_ok(const LanesArgs& a, const int* tab, const Lane& l) {
  const int nb = (max(l.n, l.write ? l.kv_pos + 1 : 0) + a.page - 1) / a.page;
  int out_of_pool = 0;
  for (int i = threadIdx.x; i < nb; i += THREADS)
    out_of_pool |= (unsigned)tab[i] >= (unsigned)a.n_pages;
  return __syncthreads_or(out_of_pool) == 0;
}

// Element offsets of head h's rows of one lane: dense from the lane's layer
// base, paged through the lane's table. A tile of 64 rows is contiguous at
// `stride` when it lies in one page: always dense, and paged when the page
// is a multiple of the tile (tiles start at multiples of 64).
template <bool kPaged>
struct LaneRows {
  const int* tab;
  size_t head;    // dense: slot 0 of head h in the lane's layer; paged: h * D
  size_t stride;  // Hk * D, from one slot's row to the next
  int page, L, layer;
  __device__ __forceinline__ size_t at(int s) const {
    if constexpr (kPaged)
      return (((size_t)tab[s / page] * L + layer) * page + s % page) * stride + head;
    else
      return head + (size_t)s * stride;
  }
  __device__ __forceinline__ bool tile_in_page() const { return !kPaged || page % TILE == 0; }
};

template <bool kPaged>
__device__ __forceinline__ LaneRows<kPaged> lane_rows(const LanesArgs& a, const int* tab, int h) {
  const size_t stride = (size_t)a.Hk * a.D;
  return LaneRows<kPaged>{tab, kPaged ? (size_t)h * a.D : (size_t)a.layer * a.S * stride +
                                                              (size_t)h * a.D,
                          stride, a.page, a.L, a.layer};
}

// load_tile through a lane's rows: rows [t0, t0 + nt) into a shared tile
// (stride D + KPAD), 8 elements per cp.async; one group per call.
template <typename T, bool kPaged>
__device__ __forceinline__ void load_lane_tile(T* dst, const T* all, const LaneRows<kPaged>& rows,
                                               int t0, int nt, int D) {
  const int vpr = D / 8;
  const bool one_page = rows.tile_in_page();
  const size_t base = one_page ? rows.at(t0) : 0;
  for (int i = threadIdx.x; i < nt * vpr; i += THREADS) {
    const int r = i / vpr, c = i - r * vpr;
    const size_t off = one_page ? base + (size_t)r * rows.stride : rows.at(t0 + r);
    KV<T>::copy8_async(dst + r * (D + KPAD) + 8 * c, all + off + 8 * c);
  }
  cp_async_commit();
}

// Whether chunk [c0, c1) of a lane reads rows: below kv_len and, on a
// sliding layer whose kv_pos the lane attends, holding a slot of age < win.
// ops/cuda/attention.py:lane_chunk_live is the same rule. A chunk past
// kv_len takes no part at all: its blocks return at once (the writer's
// after its write), and pass 2 counts the lane's ceil(kv_len / chunk)
// chunks alone; a chunk below kv_len that reads nothing gives m_c = -inf,
// l_c = 0 and a zero partial.
__device__ __forceinline__ bool lane_chunk_reads(int c0, int c1, const Lane& ln, int S, int win) {
  if (c0 >= ln.n) return false;
  const bool skip = win > 0 && ln.kv_sink <= ln.kv_pos && ln.kv_pos < ln.n;
  return !skip || chunk_live(c0, c1, ln.kv_pos, ln.kv_sink, S, win);
}

// Pass 1 keeps q as f32 (its bf16 values) in shared memory, a row of D +
// QPAD floats, so that the dot widens only the cache row (the rows of q a
// warp reads lie in other banks): q (qpk, D + QPAD) f32 | the sink view
// (kv_sinks, D + KPAD) bf16 | two K tiles; a block that finishes its lane
// reuses the room for chunk_values' layout.
constexpr int QPAD = 4;

__host__ __device__ inline size_t lanes_scores_smem(int qpk, int D, int kv_sinks, size_t elem) {
  return align16((size_t)qpk * (D + QPAD) * 4) + align16((size_t)kv_sinks * (D + KPAD) * 2) +
         tiles_bytes(D, elem);
}
// chunk_values: m and l (2 qpk) f32 | one tile's p (TILE, qpk) f32 | two
// V tiles, whose room the row slices' sums (THREADS x 8 f32) take after the
// last tile
__host__ __device__ inline size_t lanes_values_smem(int qpk, int D, size_t elem) {
  return align16(2 * qpk * 4) + align16((size_t)TILE * qpk * 4) +
         max(tiles_bytes(D, elem), (size_t)THREADS * 8 * 4);
}

// f32 q (bf16 values) . one shared row of E, summed in f32 in d order (the
// same sum as dot_row's)
template <typename E>
__device__ __forceinline__ float dot_row_f32(const E* k, const float* q, int D) {
  float dot = 0.f;
  for (int d = 0; d < D; d += 8) {
    float kf[8];
    KV<E>::widen8(k + d, kf);
    const float4 q0 = *reinterpret_cast<const float4*>(q + d);
    const float4 q1 = *reinterpret_cast<const float4*>(q + d + 4);
    const float qf[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) dot = fmaf(qf[i], kf[i], dot);
  }
  return dot;
}

// One live chunk's p . v as split_values_kernel does it, into dst (qpk, D):
// the V tiles of [c0, c1) stream through smem (lanes_values_smem) while
// fill_ml(ms) puts each query's m into ms[0, qpk) and l into ms[qpk, 2 qpk);
// p = bf16(exp(s - m) / l) from the scores sc of the (lane, head); thread
// (slice sl, group g) sums the rows r = sl mod R of output columns
// 8g..8g+7 (query j = 8g / D) in registers, then the slices in order.
template <typename T, bool kPaged, typename MlFn>
__device__ __forceinline__ void chunk_values(const LanesArgs& a, const T* v_all,
                                             const LaneRows<kPaged>& rows, const float* sc,
                                             int c0, int c1, unsigned char* smem, MlFn fill_ml,
                                             float* dst) {
  const int D = a.D, qpk = a.qpk, nout = qpk * D, tid = threadIdx.x, RS = D + KPAD;
  const int G = nout / 8, R = THREADS / G, g = tid % G, sl = tid / G;
  const int j = 8 * g / D, d0 = 8 * g - j * D;
  float* ms = reinterpret_cast<float*>(smem);             // (qpk) m, then (qpk) l
  float* ps = reinterpret_cast<float*>(smem + align16(2 * qpk * 4));     // (TILE, qpk)
  T* tiles = reinterpret_cast<T*>(ps + align16((size_t)TILE * qpk * 4) / 4);
  float* red = reinterpret_cast<float*>(tiles);                          // (R, G, 8), last
  const int tile_elems = (int)(align16((size_t)TILE * RS * sizeof(T)) / sizeof(T));
  const int ntiles = (c1 - c0 + TILE - 1) / TILE;
  load_lane_tile(tiles, v_all, rows, c0, min(TILE, c1 - c0), D);
  if (ntiles > 1) load_lane_tile(tiles + tile_elems, v_all, rows, c0 + TILE,
                                 min(TILE, c1 - c0 - TILE), D);
  fill_ml(ms);
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = c0 + t * TILE, nt = min(TILE, c1 - t0);
    __syncthreads();   // m and l are in; the last tile's p is no longer read
    const float* st = sc + (size_t)t0 * qpk;
    for (int i = tid; i < nt * qpk; i += THREADS) {
      const int jj = i % qpk;
      ps[i] = bf16_round(__fdiv_rn(expf(st[i] - ms[jj]), ms[qpk + jj]));
    }
    if (t + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const T* tile = tiles + (t & 1) * tile_elems;
    if (sl < R) {
      for (int r = sl; r < nt; r += R) {
        float vf[8];
        KV<T>::widen8(tile + r * RS + d0, vf);
        const float p = ps[r * qpk + j];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(p, vf[k], acc[k]);
      }
    }
    __syncthreads();
    if (t + 2 < ntiles) load_lane_tile(tiles + (t & 1) * tile_elems, v_all, rows, t0 + 2 * TILE,
                                       min(TILE, c1 - t0 - 2 * TILE), D);
  }
  // every tile is read (the loop's last barrier) and no copy is in flight
  if (sl < R)
#pragma unroll
    for (int k = 0; k < 8; ++k) red[(sl * G + g) * 8 + k] = acc[k];
  __syncthreads();
  for (int i = tid; i < nout; i += THREADS) {  // the row slices, in order
    const int gi = i / 8, k = i - gi * 8;
    float o = 0.f;
    for (int s = 0; s < R; ++s) o += red[(s * G + gi) * 8 + k];
    dst[i] = o;
  }
}

// Pass 2 is a programmatic dependent launch: once every pass-1 block has
// started, pass 2's blocks may be scheduled, and those with nothing to do
// (a chunk past kv_len, a lane pass 1 finished) exit under pass 1's tail;
// the others wait for pass 1 to complete, its writes visible, before they
// read what it wrote (griddepcontrol.wait; a no-op in an ordinary launch).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_pass1() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename T, bool kPaged>
__global__ void __launch_bounds__(THREADS) lanes_scores_kernel(LanesArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  launch_dependents();
  const int D = a.D, qpk = a.qpk, half = D / 2, S = a.S;
  const int h = blockIdx.x, b = blockIdx.y, ci = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, RS = D + KPAD;
  const int* tab = kPaged ? a.tables + (size_t)b * (S / a.page) : nullptr;
  const Lane ln = read_lane(a, b);
  const int n = ln.n, c0 = ci * a.chunk, c1 = min(c0 + a.chunk, n);
  const bool writer = ln.write && ln.kv_pos / a.chunk == ci;
  const size_t bh = (size_t)b * a.Hk + h;
  if (!ln.bad && c0 >= n && !writer) return;  // past kv_len: nothing to read or write
  if (ln.bad || (kPaged && !pages_ok(a, tab, ln))) {
    // lane scalars or page ids the kernel does not take: no block of the
    // lane touches a row; the lane's output is NaN
    if (ci == 0)
      for (int i = tid; i < qpk * D; i += THREADS)
        a.out[bh * qpk * D + i] = __int_as_float(0x7fc00000);
    return;
  }
  T* k_all = static_cast<T*>(a.k_all) + (kPaged ? 0 : (size_t)b * a.lane_stride);
  T* v_all = static_cast<T*>(a.v_all) + (kPaged ? 0 : (size_t)b * a.lane_stride);
  const LaneRows<kPaged> rows = lane_rows<kPaged>(a, tab, h);
  const float posf = (float)ln.pos;

  if (writer) {  // 2: the new rows, before any read
    const size_t new_row = rows.at(ln.kv_pos);
    const float* kn = a.k_new + bh * D;
    const float* vn = a.v_new + bh * D;
    for (int p = tid; p < half; p += THREADS) {
      const float ang = posf * a.freq[p];
      const float c = a.mscale * cosf(ang), s = a.mscale * sinf(ang);
      const float x0 = kn[2 * p], x1 = kn[2 * p + 1];
      k_all[new_row + 2 * p] = KV<T>::from_float(rot_re(x0, x1, c, s));
      k_all[new_row + 2 * p + 1] = KV<T>::from_float(rot_im(x0, x1, c, s));
    }
    for (int d = tid; d < D; d += THREADS) v_all[new_row + d] = KV<T>::from_float(vn[d]);
    __syncthreads();
    if (c0 >= n) return;
  }
  float* ml = a.ml + (bh * a.nsplit + ci) * qpk * 2;
  if (!lane_chunk_reads(c0, c1, ln, S, a.win)) {
    for (int j = tid; j < qpk; j += THREADS) {
      ml[2 * j] = -INFINITY;
      ml[2 * j + 1] = 0.f;
    }
    return;
  }

  const int QS = D + QPAD;
  float* qs = reinterpret_cast<float*>(smem);                  // (qpk, QS)
  const int nsink = c0 == 0 ? min(ln.kv_sink, c1) : 0;         // the sink view's rows here
  __nv_bfloat16* sinks = reinterpret_cast<__nv_bfloat16*>(smem + align16((size_t)qpk * QS * 4));
  T* tiles = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sinks) +
                                  align16((size_t)a.kv_sinks * RS * 2));
  const int tile_elems = (int)(align16((size_t)TILE * RS * sizeof(T)) / sizeof(T));
  const int ntiles = (c1 - c0 + TILE - 1) / TILE;
  load_lane_tile(tiles, k_all, rows, c0, min(TILE, c1 - c0), D);
  if (ntiles > 1) load_lane_tile(tiles + tile_elems, k_all, rows, c0 + TILE,
                                 min(TILE, c1 - c0 - TILE), D);

  // 1: q, roped and scaled, rounded to bf16
  const float* q = a.q + bh * qpk * D;
  for (int i = tid; i < qpk * half; i += THREADS) {
    const int j = i / half, p = i - j * half;
    const float ang = posf * a.freq[p];
    const float c = a.mscale * cosf(ang), s = a.mscale * sinf(ang);
    const float x0 = q[j * D + 2 * p], x1 = q[j * D + 2 * p + 1];
    qs[j * QS + 2 * p] = bf16_round(__fmul_rn(rot_re(x0, x1, c, s), a.inv_sqrt_d));
    qs[j * QS + 2 * p + 1] = bf16_round(__fmul_rn(rot_im(x0, x1, c, s), a.inv_sqrt_d));
  }
  // 3: the lazy sink view, from the cache (this block wrote any sink row it
  // holds before the barrier above: kv_sink <= 64 <= chunk)
  const float rot = (float)max(0, ln.pos - S + 1);
  for (int i = tid; i < nsink * half; i += THREADS) {
    const int r = i / half, p = i - r * half;
    const float ang = rot * a.freq[p];
    const float c = cosf(ang), s = sinf(ang);
    const T* kr = k_all + rows.at(r);
    const float x0 = KV<T>::widen1(kr[2 * p]), x1 = KV<T>::widen1(kr[2 * p + 1]);
    sinks[r * RS + 2 * p] = __float2bfloat16_rn(rot_re(x0, x1, c, s));
    sinks[r * RS + 2 * p + 1] = __float2bfloat16_rn(rot_im(x0, x1, c, s));
  }

  // 3-4: the chunk's scores, one (slot, query) dot per thread
  float* sc = a.scores + bh * S * qpk;  // slot s at s * qpk
  const int ring = max(S - ln.kv_sink, 1);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int t0 = c0 + t * TILE, nt = min(TILE, c1 - t0);
    const T* tile = tiles + (t & 1) * tile_elems;
    for (int i = tid; i < nt * qpk; i += THREADS) {
      const int r = i / qpk, j = i - r * qpk, s = t0 + r;
      float dot = s < nsink ? dot_row_f32(sinks + s * RS, qs + j * QS, D)
                            : dot_row_f32(tile + r * RS, qs + j * QS, D);
      if (a.softcap > 0.f) dot = __fmul_rn(a.softcap, tanhf(__fdiv_rn(dot, a.softcap)));
      if (a.win > 0 && slot_age(s, ln.kv_pos, ln.kv_sink, S, ring) >= a.win) dot = NEG_BIG;
      sc[(size_t)s * qpk + j] = dot;
    }
    __syncthreads();
    if (t + 2 < ntiles) load_lane_tile(tiles + (t & 1) * tile_elems, k_all, rows, t0 + 2 * TILE,
                                       min(TILE, c1 - t0 - 2 * TILE), D);
  }

  // 5 (this chunk's share): m_c and l_c per query, one warp each
  for (int j = warp; j < qpk; j += WARPS) {
    float m = -INFINITY;
    for (int r = c0 + lane; r < c1; r += 32) m = fmaxf(m, sc[(size_t)r * qpk + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = c0 + lane; r < c1; r += 32) l += expf(sc[(size_t)r * qpk + j] - m);
    l = warp_sum(l);
    if (lane == 0) {
      ml[2 * j] = m;
      ml[2 * j + 1] = l;
    }
  }
  if (n > a.chunk) return;  // more chunks: pass 2 combines them
  // A lane of one chunk: its m and l are this chunk's m_c and l_c (what
  // pass 2's combine gives for one chunk, bit for bit), so this block
  // finishes the lane itself, writing the output its partial would give.
  __syncthreads();
  chunk_values<T, kPaged>(a, v_all, rows, sc, c0, c1, smem, [&](float* ms) {
    for (int jj = tid; jj < qpk; jj += THREADS) {
      ms[jj] = ml[2 * jj];
      ms[qpk + jj] = ml[2 * jj + 1];
    }
  }, a.out + bh * qpk * D);
}

template <typename T, bool kPaged>
__global__ void __launch_bounds__(THREADS) lanes_values_kernel(LanesArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int D = a.D, qpk = a.qpk, S = a.S, nsplit = a.nsplit, nout = qpk * D;
  const int h = blockIdx.x, b = blockIdx.y, ci = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* tab = kPaged ? a.tables + (size_t)b * (S / a.page) : nullptr;
  const Lane ln = read_lane(a, b);
  const size_t bh = (size_t)b * a.Hk + h;
  const int nc = (ln.n + a.chunk - 1) / a.chunk;  // the lane's chunks below kv_len
  const int c0 = ci * a.chunk, c1 = min(c0 + a.chunk, ln.n);
  // a bad lane (pass 1 gave it its NaN output), a chunk past kv_len, or a
  // lane of one chunk (pass 1 finished it): no part in the lane's sums
  if (ln.bad || ci >= nc || nc == 1 || (kPaged && !pages_ok(a, tab, ln))) return;
  wait_for_pass1();
  const T* v_all = static_cast<const T*>(a.v_all) + (kPaged ? 0 : (size_t)b * a.lane_stride);
  const LaneRows<kPaged> rows = lane_rows<kPaged>(a, tab, h);
  const float* mlh = a.ml + bh * nsplit * qpk * 2;
  float* part = a.part + (bh * nsplit + ci) * nout;
  if (!lane_chunk_reads(c0, c1, ln, S, a.win)) {
    for (int i = tid; i < nout; i += THREADS) part[i] = 0.f;
  } else {
    // m and l over the lane's chunks, the same order in every block
    chunk_values<T, kPaged>(a, v_all, rows, a.scores + bh * S * qpk, c0, c1, smem,
                            [&](float* ms) {
      for (int jj = warp; jj < qpk; jj += WARPS) {
        float m = -INFINITY;
        for (int c = lane; c < nc; c += 32) m = fmaxf(m, mlh[(c * qpk + jj) * 2]);
        m = warp_max(m);
        float l = 0.f;
        for (int c = lane; c < nc; c += 32) {
          const float* e = mlh + (c * qpk + jj) * 2;
          l = fmaf(e[1], expf(e[0] - m), l);
        }
        l = warp_sum(l);
        if (lane == 0) {
          ms[jj] = m;
          ms[qpk + jj] = l;
        }
      }
    }, part);
  }

  // the (lane, head)'s last block to arrive sums the partials in chunk order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicInc(a.counter + bh, nc - 1u) == nc - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* parts = a.part + bh * nsplit * nout;
  float* out = a.out + bh * nout;
  for (int i = 4 * tid; i < nout; i += 4 * THREADS) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(parts + (size_t)c * nout + i));
      o.x += p.x;
      o.y += p.y;
      o.z += p.z;
      o.w += p.w;
    }
    *reinterpret_cast<float4*>(out + i) = o;
  }
}

template <typename T, bool kPaged>
int launch_lanes(const LanesArgs& a, cudaStream_t st) {
  const size_t s2 = lanes_values_smem(a.qpk, a.D, sizeof(T));
  const size_t s1 = max(lanes_scores_smem(a.qpk, a.D, a.kv_sinks, sizeof(T)), s2);
  if (s1 > SMEM_MAX || s2 > SMEM_MAX) return ERR_ARGS;
  const auto k1 = lanes_scores_kernel<T, kPaged>;
  const auto k2 = lanes_values_kernel<T, kPaged>;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e;
  if (s1 > 48 * 1024 && (e = cudaFuncSetAttribute(k1, attr, (int)s1)) != cudaSuccess) return (int)e;
  if (s2 > 48 * 1024 && (e = cudaFuncSetAttribute(k2, attr, (int)s2)) != cudaSuccess) return (int)e;
  // chunk-major: every (head, lane)'s chunk 0 is dispatched first, so the
  // short lanes' live blocks run before the blocks past their kv_len
  const dim3 grid(a.Hk, a.B, a.nsplit);
  k1<<<grid, THREADS, s1, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = s2;
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, k2, a)) != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the lanes split's checks and scratch layout (ops/cuda/attention.py:
// lanes_scratch lays it out the same): scores (B, Hk, S, qpk) | ml, padded
// to 4 floats | partials; the paged instance when a.tables is set
int lanes_split(int kv_type, LanesArgs& a, float* scratch, unsigned* counter, cudaStream_t st) {
  if (!scratch || !counter || a.chunk < TILE || a.chunk % TILE || a.nsplit < 1 ||
      a.nsplit > MAX_SPLIT || (long long)(a.nsplit - 1) * a.chunk >= a.S ||
      (long long)a.nsplit * a.chunk < a.S || a.win < 0 || !(a.softcap >= 0.f))
    return ERR_ARGS;
  const size_t heads = (size_t)a.B * a.Hk, sc = heads * a.S * a.qpk;
  const size_t head = sc + heads * a.nsplit * a.qpk * 2;
  a.scores = scratch;
  a.ml = scratch + sc;
  a.part = scratch + ((head + 3) & ~(size_t)3);
  a.counter = counter;
  using BF = __nv_bfloat16;
  if (kv_type == W_BF16)
    return a.tables ? launch_lanes<BF, true>(a, st) : launch_lanes<BF, false>(a, st);
  if (kv_type == W_E5M2)
    return a.tables ? launch_lanes<uint8_t, true>(a, st) : launch_lanes<uint8_t, false>(a, st);
  return ERR_ARGS;
}

// ---------------------------------------------------------------------------
// B lanes, one block per (kv head, lane): the earlier design (v1)
// ---------------------------------------------------------------------------

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
// kOne, and a null a.lanes (one lane, its scalars by value): the branches
// of K12 and K2 before the split, launched by nothing now. The text stays
// as it was so that K8 and K9 compile to the same code: taking the
// branches out moved their bf16 times by +-15% on the card (PERF.md,
// PR 7). The redesign of K8/K9 removes them.
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

template <typename T, bool kPaged>
int launch_as(const AttnArgs& a, size_t smem, cudaStream_t st) {
  const auto kern = a.scores ? attend_step_kernel<T, true, kPaged, false>
                             : attend_step_kernel<T, false, kPaged, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(a.Hk, a.B), THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// kv_type W_BF16 or W_E5M2 (common.cuh), the type of the cache or pool; the
// paged instance when a.tables is set
int launch(int kv_type, const AttnArgs& a, cudaStream_t st) {
  const size_t smem = smem_bytes(a.qpk, a.D, a.scores ? TILE : a.slots);
  if (smem > SMEM_MAX || !(a.softcap >= 0.f)) return ERR_ARGS;
  if (kv_type == W_BF16)
    return a.tables ? launch_as<__nv_bfloat16, true>(a, smem, st)
                    : launch_as<__nv_bfloat16, false>(a, smem, st);
  if (kv_type == W_E5M2)
    return a.tables ? launch_as<uint8_t, true>(a, smem, st)
                    : launch_as<uint8_t, false>(a, smem, st);
  return ERR_ARGS;
}

// the fields every v1 entry point sets; the rest stay 0 / null
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

// the fields every lanes-split entry sets; the rest stay 0 / null
LanesArgs lanes_args(const float* q, const float* k_new, const float* v_new, void* k_all,
                     void* v_all, const float* freq, float mscale, float inv_sqrt_d, float* out,
                     const int* lanes, int B, int L, int layer, int S, int Hk, int qpk, int D,
                     int kv_sinks, float softcap, int win, int chunk, int nsplit) {
  LanesArgs a{};
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_all = k_all;
  a.v_all = v_all;
  a.freq = freq;
  a.mscale = mscale;
  a.inv_sqrt_d = inv_sqrt_d;
  a.out = out;
  a.lanes = lanes;
  a.B = B;
  a.L = L;
  a.layer = layer;
  a.S = S;
  a.Hk = Hk;
  a.qpk = qpk;
  a.D = D;
  a.kv_sinks = kv_sinks;
  a.softcap = softcap;
  a.win = win;
  a.chunk = chunk;
  a.nsplit = nsplit;
  return a;
}

}  // namespace

// One lane: k_all and v_all (L, S, Hk, D) of kv_type; the scalars come by
// value and the row is written. The split (lo, chunk, nsplit, skip) comes
// from ops/cuda/attention.py:split_plan; scratch holds split_scratch floats
// and counter Hk uint32 zeros. Two launches on `stream`.
extern "C" int yt_attend_step(int kv_type, const float* q, const float* k_new,
                              const float* v_new, void* k_all, void* v_all,
                              const float* freq, float mscale, float inv_sqrt_d,
                              float* out, float* scratch, unsigned* counter, int layer, int S,
                              int Hk, int qpk, int D, int kv_pos, int kv_len, int kv_sink,
                              int pos, int kv_sinks, float softcap, int win, int lo, int chunk,
                              int nsplit, int skip, void* stream) {
  if (!shape_ok(S, Hk, qpk, D, layer, kv_sinks) || Hk > 65535 || kv_len < 1 || kv_len > S ||
      kv_pos < 0 || kv_pos >= S || kv_sink < 0 || kv_sink > kv_sinks || win < 0)
    return ERR_ARGS;
  SplitArgs a{};
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_all = k_all;
  a.v_all = v_all;
  a.freq = freq;
  a.out = out;
  a.mscale = mscale;
  a.inv_sqrt_d = inv_sqrt_d;
  a.softcap = softcap;
  a.win = win;
  a.layer = layer;
  a.S = S;
  a.Hk = Hk;
  a.qpk = qpk;
  a.D = D;
  a.kv_pos = kv_pos;
  a.kv_len = kv_len;
  a.kv_sink = kv_sink;
  a.pos = pos;
  a.lo = lo;
  a.chunk = chunk;
  a.nsplit = nsplit;
  a.skip = skip;
  return split(kv_type, a, scratch, counter, false, static_cast<cudaStream_t>(stream));
}

// attend_one_l: q (Hk, qpk, D) f32 as it is (divided by sqrt_d), k_all and
// v_all (L, S, Hk, D) of kv_type, read only; slots < kv_len attended. The
// split (chunk, nsplit) and the scratch as yt_attend_step's.
extern "C" int yt_attend_one(int kv_type, const float* q, const void* k_all, const void* v_all,
                             float sqrt_d, float* out, float* scratch, unsigned* counter,
                             int layer, int S, int Hk, int qpk, int D, int kv_len, int chunk,
                             int nsplit, void* stream) {
  if (!shape_ok(S, Hk, qpk, D, layer, 0) || Hk > 65535 || kv_len < 1 || kv_len > S ||
      !(sqrt_d > 0.f))
    return ERR_ARGS;
  SplitArgs a{};
  a.q = q;
  a.k_all = const_cast<void*>(k_all);
  a.v_all = const_cast<void*>(v_all);
  a.out = out;
  a.sqrt_d = sqrt_d;
  a.layer = layer;
  a.S = S;
  a.Hk = Hk;
  a.qpk = qpk;
  a.D = D;
  a.kv_len = kv_len;
  a.chunk = chunk;
  a.nsplit = nsplit;
  return split(kv_type, a, scratch, counter, true, static_cast<cudaStream_t>(stream));
}

// B lanes: caches (B, L, S, Hk, D); lanes (5, B) int32 on the device. The
// split (chunk, nsplit) comes from ops/cuda/attention.py:lanes_split_plan;
// scratch holds lanes_scratch floats and counter B * Hk uint32 zeros. Two
// launches on `stream`.
extern "C" int yt_attend_step_batched(int kv_type, const float* q, const float* k_new,
                                      const float* v_new, void* k_all, void* v_all,
                                      const float* freq, float mscale, float inv_sqrt_d,
                                      float* out, float* scratch, unsigned* counter,
                                      const int* lanes, int B, int L, int layer, int S, int Hk,
                                      int qpk, int D, int kv_sinks, float softcap, int win,
                                      int chunk, int nsplit, void* stream) {
  if (!shape_ok(S, Hk, qpk, D, layer, kv_sinks) || layer >= L || B < 1 || B > 65535 ||
      Hk > 65535 || !lanes)
    return ERR_ARGS;
  LanesArgs a = lanes_args(q, k_new, v_new, k_all, v_all, freq, mscale, inv_sqrt_d, out, lanes,
                           B, L, layer, S, Hk, qpk, D, kv_sinks, softcap, win, chunk, nsplit);
  a.lane_stride = (size_t)L * S * Hk * D;
  return lanes_split(kv_type, a, scratch, counter, static_cast<cudaStream_t>(stream));
}

// B lanes over a page pool: k_pool and v_pool (n_pages, L, page, Hk, D);
// tables (B, nblk) int32 page ids and lanes (5, B) int32 on the device; the
// window is S = nblk * page. The split and the scratch as
// yt_attend_step_batched's.
extern "C" int yt_attend_step_paged(int kv_type, const float* q, const float* k_new,
                                    const float* v_new, void* k_pool, void* v_pool,
                                    const float* freq, float mscale, float inv_sqrt_d,
                                    float* out, float* scratch, unsigned* counter,
                                    const int* lanes, const int* tables, int B, int n_pages, int L,
                                    int layer, int page, int nblk, int Hk, int qpk, int D,
                                    int kv_sinks, float softcap, int win, int chunk, int nsplit,
                                    void* stream) {
  if (page < 1 || nblk < 1 || (long long)page * nblk > (1 << 30))
    return ERR_ARGS;
  const int S = page * nblk;
  if (!shape_ok(S, Hk, qpk, D, layer, kv_sinks) || layer >= L || B < 1 || B > 65535 ||
      Hk > 65535 || n_pages < 1 || !lanes || !tables)
    return ERR_ARGS;
  LanesArgs a = lanes_args(q, k_new, v_new, k_pool, v_pool, freq, mscale, inv_sqrt_d, out, lanes,
                           B, L, layer, S, Hk, qpk, D, kv_sinks, softcap, win, chunk, nsplit);
  a.tables = tables;
  a.page = page;
  a.n_pages = n_pages;
  return lanes_split(kv_type, a, scratch, counter, static_cast<cudaStream_t>(stream));
}

// The earlier design (attend_step_kernel), for chip_smoke.py's same-run
// time alone. B lanes: caches (B, L, S, Hk, D); lanes (5, B) int32 on the
// device. The score space is sized from the window: shared memory if S
// slots fit, else `scores` (B, Hk, S, qpk).
extern "C" int yt_attend_step_batched_v1(int kv_type, const float* q, const float* k_new,
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

// The earlier design over a page pool, as yt_attend_step_batched_v1:
// k_pool and v_pool (n_pages, L, page, Hk, D); tables (B, nblk) int32 page
// ids and lanes (5, B) int32 on the device; the window is S = nblk * page,
// and the score space is sized from it as above.
extern "C" int yt_attend_step_paged_v1(int kv_type, const float* q, const float* k_new,
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
