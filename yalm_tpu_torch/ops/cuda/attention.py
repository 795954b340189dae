"""Fused decode attention step (port of `attend_step_l`, its
continuous-batching form `attend_step_batched_l` and its paged form
`attend_step_paged_l`, `yalm_tpu/ops/pallas/attention.py`), and the
read-only attention of one query (`attend_one_l`).

One step: RoPE on q and k_new at `pos`, write the k/v row into ring slot
`kv_pos` IN PLACE (the port mutates the cache tensors where the JAX package
aliased its buffers), the lazy StreamingLLM sink view in the ring regime,
then GQA attention over slots < kv_len. The batched form does this for B
lanes of a (B, L, S, Hk, D) cache in one call, each lane with its own
scalars; a lane whose `write` is 0 changes nothing and attends the cache as
it is (lanes mid-admission). The paged form does it over a page pool
(n_pages, L, page, Hk, D), lane b's slot s at (tables[b, s // page], layer,
s % page). Kernels: `csrc/attention.cu`. The
cache is bf16 or fp8 e5m2 (`-C fp8`): the new row is rounded from f32 to
the cache type in one step, attention reads the cache widened to bf16
(exact), and the sink view is rounded to bf16, the working type, for
both. The Gemma forms ride along: `softcap` (Gemma2's score cap, before
the mask), `win` (a sliding layer's window, by slot age) and `alt`
(Gemma3's local-theta rope). `attend_one_l` is the one-lane step with no
RoPE, no write and no sinks. Every plain version runs `attend_ref`, the
port's one plain attention core.

Every form is bound by the bytes of the rows it attends and runs split
over the slots (flash-decoding) in two launches -- chunk scores with each
chunk's max and sum, then each chunk's p . v with the partials summed in
chunk order by the last block of each (lane, kv head) (`csrc/attention.cu`'s
note). The one-lane step and `attend_one_l`: `split_plan` cuts [lo, kv_len)
into chunks of a multiple of 64 slots, so that about two waves of the
H100's 132 SMs stream the cache at once. The batched and paged forms:
`lanes_split_plan` cuts the window into chunks from S and the head count
alone (the lanes' scalars stay on the device), on a (chunk, kv head, lane)
grid whose blocks past a lane's kv_len, or outside its sliding window
(`lane_chunk_live`), read nothing. A sliding layer in the ring regime reads
only the chunks that hold a slot of its window (`chunk_live`).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..core import (NEG_INF, int_view, rope_freq_table, rope_mscale, rope_rotation_param,
                    rotate_pairs)
from . import _build as B
from .gemv import SMS, bf16f


KV_DTYPES = (torch.bfloat16, torch.float8_e5m2)
TILE = 64                 # the kernels' tile of slots
SPLIT_BLOCKS = 2 * SMS    # the one-lane split's target blocks: two waves
LANE_BLOCKS = SMS         # the lanes split's target blocks for one lane of S slots
MAX_SPLIT = 1024          # chunks per kv head a split launch takes


class SplitPlan(NamedTuple):
    """How a one-lane launch cuts its slots: chunk c holds [lo + c * chunk,
    lo + (c + 1) * chunk) below kv_len; skip: a chunk with no slot of the
    sliding window (`chunk_live`) reads nothing."""
    lo: int
    chunk: int
    nsplit: int
    skip: bool


def split_plan(kv_len: int, Hk: int, *, kv_pos: int = 0, kv_sink: int = 0,
               win: int = 0) -> SplitPlan:
    """The one-lane split of [lo, kv_len) for Hk kv heads. win: the
    kernel's window argument (0 for none). A sliding layer in the linear
    regime (kv_sink 0, kv_pos its newest slot) starts at lo, the window's
    start rounded down to a tile, as the TPU kernel skips the blocks below
    it; in the ring regime its chunks that hold no window slot are skipped
    (only while kv_pos is a slot it attends, so some chunk always is). The
    chunk is a multiple of the tile, the smallest that gives each head
    about SPLIT_BLOCKS / Hk chunks of the rows it attends, and no more than
    MAX_SPLIT chunks in all; every kv_len, down to 1, takes this path."""
    linear = win > 0 and kv_sink == 0 and kv_pos + 1 >= kv_len
    lo = max(kv_len - win, 0) // TILE * TILE if linear else 0
    rows = kv_len - lo
    skip = win > 0 and kv_sink <= kv_pos < kv_len
    attended = min(rows, win) if skip else rows
    chunk = max(-(-attended // max(1, SPLIT_BLOCKS // Hk)), -(-rows // MAX_SPLIT), 1)
    chunk = -(-chunk // TILE) * TILE
    return SplitPlan(lo, chunk, -(-rows // chunk), skip)


def chunk_live(c0: int, c1: int, kv_pos: int, kv_sink: int, S: int, win: int) -> bool:
    """Whether slots [c0, c1) hold one that a sliding layer attends (age <
    win, `slot_age`), in O(1) -- csrc/attention.cu's rule for skipping a
    chunk: the sinks' ages S-1-s fall as s rises; going back from c1 - 1
    the other slots' ages rise by one per slot and wrap to 0 at most once."""
    if win <= 0:
        return True
    if c0 < kv_sink and S - min(c1, kv_sink) < win:
        return True
    a = max(c0, kv_sink)
    if a >= c1:
        return False
    ring = max(S - kv_sink, 1)
    d_end = (kv_pos - (c1 - 1)) % ring
    return d_end < win or ring - d_end < c1 - a


def split_scratch(plan: SplitPlan, kv_len: int, Hk: int, qpk: int, D: int, device) -> torch.Tensor:
    """The f32 scratch of a one-lane launch, laid out as csrc/attention.cu's
    `split` reads it: the scores (Hk, kv_len - lo, qpk) | each chunk's max
    and sum (Hk, nsplit, qpk, 2), padded to 4 floats | the partial outputs
    (Hk, nsplit, qpk, D)."""
    head = Hk * (kv_len - plan.lo) * qpk + Hk * plan.nsplit * qpk * 2
    return torch.empty((head + 3) // 4 * 4 + Hk * plan.nsplit * qpk * D, dtype=torch.float32,
                       device=device)


class LanesPlan(NamedTuple):
    """How a B-lane launch cuts the window: chunk c of every lane holds
    slots [c * chunk, (c + 1) * chunk), on a (Hk, B, nsplit) grid."""
    chunk: int
    nsplit: int


def lanes_split_plan(S: int, Hk: int) -> LanesPlan:
    """The B-lane split of a window of S slots for Hk kv heads: the chunk
    is a multiple of the tile, the smallest that gives a lane of S slots
    about LANE_BLOCKS / Hk chunks per head (16 of 256 slots at 8 heads and
    4096 slots), and no more than MAX_SPLIT chunks. It depends on the window
    and the head count alone, never on B or on a lane's scalars (which live
    on the device): a lane's bits do not depend on the lanes beside it, the
    wrapper reads no device value, and a tick's grid is fixed, as a CUDA
    graph of the tick needs."""
    chunk = max(-(-S // max(1, LANE_BLOCKS // Hk)), -(-S // MAX_SPLIT), 1)
    chunk = -(-chunk // TILE) * TILE
    return LanesPlan(chunk, -(-S // chunk))


def lane_chunk_live(c: int, chunk: int, S: int, kv_pos: int, kv_len: int, kv_sink: int,
                    win: int) -> bool:
    """Whether chunk c of a lane reads rows in the lanes split -- the
    kernel's rule, decided on the device: below kv_len, and on a sliding
    layer (win > 0) whose kv_pos the lane attends (kv_sink <= kv_pos <
    kv_len) holding a slot of age < win (`chunk_live`). A dead chunk reads
    nothing (one below kv_len contributes m = -inf, l = 0 and a zero
    partial; one past it takes no part); the block whose chunk holds kv_pos
    writes the lane's new rows all the same."""
    c0 = c * chunk
    if c0 >= kv_len:
        return False
    skip = win > 0 and kv_sink <= kv_pos < kv_len
    return not skip or chunk_live(c0, min(c0 + chunk, kv_len), kv_pos, kv_sink, S, win)


def lanes_scratch(plan: LanesPlan, Bn: int, S: int, Hk: int, qpk: int, D: int,
                  device) -> torch.Tensor:
    """The f32 scratch of a B-lane launch, laid out as csrc/attention.cu's
    `lanes_split` reads it: the scores (B, Hk, S, qpk) | each chunk's max
    and sum (B, Hk, nsplit, qpk, 2), padded to 4 floats | the partial
    outputs (B, Hk, nsplit, qpk, D). Sized from the window, not from the
    lanes' kv_len."""
    heads = Bn * Hk
    head = heads * S * qpk + heads * plan.nsplit * qpk * 2
    return torch.empty((head + 3) // 4 * 4 + heads * plan.nsplit * qpk * D, dtype=torch.float32,
                       device=device)


_COUNTERS: dict = {}


def _counter(device: torch.device, n: int) -> torch.Tensor:
    """The arrival counters of a split's second launch, one per kv head
    (one lane) or per (lane, kv head): one zeroed int32 buffer per (device,
    stream), held across calls (the kernel's last block of each head leaves
    its counter at 0 again), sized for 128 lanes of 8 heads at first use."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    ctr = _COUNTERS.get(key)
    if ctr is None or ctr.numel() < n:
        ctr = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return ctr


@functools.lru_cache(maxsize=64)
def _freq_table(theta, D: int, rotary_dim: int, device: str, alt: bool = False) -> torch.Tensor:
    # one (D/2,) table per model, device and rope (Gemma3's local theta when
    # alt); the kernel reads it every step
    return rope_freq_table(theta, D, rotary_dim, 1 if alt else None, device=torch.device(device))


def _rot(rows: torch.Tensor, theta, rotary_dim: int, pos, alt=None) -> torch.Tensor:
    """RoPE rows[..., D] forward by `pos` positions (f32)."""
    freq = _freq_table(theta, rows.shape[-1], rotary_dim, str(rows.device), bool(alt))
    ang = freq * float(pos)   # f32 product, as pos_f32 * freq
    return rotate_pairs(rows.float(), ang, rope_mscale(theta))


def sink_view(k: torch.Tensor, kv_sink: int, pos: int, *, theta,
              rotary_dim: int, alt=None) -> torch.Tensor:
    """What attention reads of one layer's keys k (S, Hk, D), as f32: the
    lazy StreamingLLM sink view (`_sink_view_ref`, attention.py:706-721).
    The first kv_sink rows are rotated forward by max(0, pos - S + 1) and
    rounded to the working type: the cache type, or bf16 for a 1-byte
    cache (an e5m2 cache is staged as bf16). The cache keeps them as
    written."""
    kf = k.float()
    if kv_sink == 0:
        return kf
    rot = max(0, int(pos) - k.shape[0] + 1)
    rows = _rot(kf[:kv_sink], rope_rotation_param(theta), rotary_dim, rot, alt)
    wd = k.dtype if k.element_size() >= 2 else torch.bfloat16
    kf = kf.clone()
    kf[:kv_sink] = rows.to(wd).float()
    return kf


def slot_age(S: int, kv_pos: int, kv_sink: int, device) -> torch.Tensor:
    """(S,) age of every slot of a lane (`_slot_age`, attention.py:197-205):
    a sink slot S-1-s, any other (kv_pos - s) mod (S - kv_sink). A sliding
    layer attends slots younger than its window."""
    s = torch.arange(S, device=device)
    return torch.where(s < kv_sink, S - 1 - s, torch.remainder(kv_pos - s, max(S - kv_sink, 1)))


def attend_ref(q2, k, v, kv_len, softcap: float = 0.0, extra_valid=None) -> torch.Tensor:
    """The plain attention core (`_attend_ref`, attention.py:36-59): q2
    (rows, D) pre-scaled f32, k/v (S, Hk, D) one layer of any type, rows =
    Hk * P. bf16 dot operands and f32 scores; Gemma2's softcap before the
    mask; slots >= kv_len, and those extra_valid ((S,) bool, the sliding
    window) excludes, at -1e30; an f32 softmax normalised before the bf16
    cast of p; f32 out (rows, D)."""
    S, Hk, D = k.shape
    P = q2.shape[0] // Hk
    q3 = bf16f(q2.float()).reshape(Hk, P, D)
    scores = torch.einsum("gpd,sgd->gps", q3, bf16f(k.float()))
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    valid = torch.arange(S, device=k.device) < kv_len
    if extra_valid is not None:
        valid = valid & extra_valid
    scores = torch.where(valid[None, None], scores, torch.full_like(scores, NEG_INF))
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum("gps,sgd->gpd", bf16f(att), bf16f(v.float()))
    return out.reshape(Hk * P, D)


def attend_step_plain(q, k_new, v_new, k_all, v_all, layer, kv_pos, kv_len,
                      kv_sink, pos, *, kv_sinks, theta, rotary_dim, write=True,
                      softcap=0.0, win=None, alt=None):
    """The JAX emulation `_attn_step_ref` (attention.py:775-802): mutates
    k_all/v_all in place, returns mix (Hk, qpk, D) f32. The new rows are
    rounded from f32 to the cache type in one step. Normalises the softmax
    before the bf16 cast of p, as the emulation and the CUDA kernel do (the
    Pallas kernel's online softmax normalises after). write=False changes
    nothing and attends the cache as it is (attention.py:571-588)."""
    L, S, Hk, D = k_all.shape
    _, qpk, _ = q.shape
    q2 = _rot(q.float().reshape(Hk * qpk, D), theta, rotary_dim, pos, alt) * (1.0 / math.sqrt(D))
    if write:
        k_all[layer, kv_pos] = _rot(k_new.float(), theta, rotary_dim, pos, alt).to(k_all.dtype)
        v_all[layer, kv_pos] = v_new.float().to(v_all.dtype)
    k = sink_view(k_all[layer], kv_sink, pos, theta=theta, rotary_dim=rotary_dim, alt=alt)
    extra = None if win is None else slot_age(S, kv_pos, kv_sink, k.device) < win
    return attend_ref(q2, k, v_all[layer], kv_len, softcap, extra).reshape(Hk, qpk, D)


def attend_step_split_plain(q, k_new, v_new, k_all, v_all, layer, kv_pos, kv_len, kv_sink,
                            pos, *, kv_sinks, theta, rotary_dim):
    """The one-lane split's arithmetic (csrc/attention.cu's two passes, no
    window or cap), plainly: the new rows written as attend_step_plain
    writes them, the scores as attend_ref forms them, then over
    split_plan's chunks each chunk's max m_c and sum l_c, m = max m_c and l
    = sum l_c exp(m_c - m) in chunk order, p = bf16(exp(s - m) / l), and the
    chunks' partial sums of p . v added in chunk order. Mutates the cache;
    returns mix (Hk, qpk, D) f32."""
    L, S, Hk, D = k_all.shape
    qpk = q.shape[1]
    q2 = _rot(q.float().reshape(Hk * qpk, D), theta, rotary_dim, pos) * (1.0 / math.sqrt(D))
    k_all[layer, kv_pos] = _rot(k_new.float(), theta, rotary_dim, pos).to(k_all.dtype)
    v_all[layer, kv_pos] = v_new.float().to(v_all.dtype)
    k = sink_view(k_all[layer], kv_sink, pos, theta=theta, rotary_dim=rotary_dim)
    v = bf16f(v_all[layer].float())
    scores = torch.einsum("gpd,sgd->gps", bf16f(q2).reshape(Hk, qpk, D), bf16f(k))
    plan = split_plan(kv_len, Hk, kv_pos=kv_pos, kv_sink=kv_sink)
    spans = [(c * plan.chunk, min((c + 1) * plan.chunk, kv_len)) for c in range(plan.nsplit)]
    ms = [scores[..., c0:c1].amax(-1) for c0, c1 in spans]
    ls = [torch.exp(scores[..., c0:c1] - m[..., None]).sum(-1) for (c0, c1), m in zip(spans, ms)]
    m = torch.stack(ms).amax(0)
    l = torch.zeros_like(m)
    for m_c, l_c in zip(ms, ls):
        l = l + l_c * torch.exp(m_c - m)
    out = torch.zeros(Hk, qpk, D, dtype=torch.float32, device=q.device)
    for c0, c1 in spans:
        p = bf16f(torch.exp(scores[..., c0:c1] - m[..., None]) / l[..., None])
        out = out + torch.einsum("gps,sgd->gpd", p, v[c0:c1])
    return out


def _win_arg(win, S: int, what: str) -> int:
    """The kernels' window argument: 0 for none (a window >= S masks nothing)."""
    B.require(win is None or int(win) >= 1, f"{what}: a window of at least 1 slot")
    return 0 if win is None or int(win) >= S else int(win)


def launch_attend_step(q, k_new, v_new, k_all, v_all, layer, kv_pos, kv_len,
                       kv_sink, pos, *, kv_sinks, theta, rotary_dim, softcap=0.0, win=None,
                       alt=None):
    """csrc/attention.cu's one-lane split on CUDA tensors: two launches on
    the current stream (adds one to LAUNCHES["attend_step_l"])."""
    L, S, Hk, D = k_all.shape
    _, qpk, _ = q.shape
    B.require(k_all.dtype in KV_DTYPES and v_all.dtype == k_all.dtype,
              f"attend_step_l: the kernel takes a bf16 or e5m2 cache, got {k_all.dtype}")
    B.require(k_all.is_contiguous() and v_all.is_contiguous() and v_all.shape == k_all.shape,
              "attend_step_l: k_all/v_all must be contiguous (L, S, Hk, D)")
    B.require(D % 8 == 0 and qpk * D <= 2048,
              f"attend_step_l: head_dim {D} x qpk {qpk} unsupported")
    B.require(0 <= layer < L and 0 <= kv_pos < S and 1 <= kv_len <= S
              and 0 <= kv_sink <= kv_sinks, "attend_step_l: position scalars out of range")
    B.require(B.aligned16(k_all, v_all), "attend_step_l: cache must be 16-byte aligned")
    qc = q.float().contiguous()
    kn = k_new.float().contiguous()
    vn = v_new.float().contiguous()
    freq = _freq_table(theta, D, rotary_dim, str(q.device), bool(alt))
    out = torch.empty((Hk, qpk, D), dtype=torch.float32, device=q.device)
    w = _win_arg(win, S, "attend_step_l")
    plan = split_plan(kv_len, Hk, kv_pos=kv_pos, kv_sink=kv_sink, win=w)
    scratch = split_scratch(plan, kv_len, Hk, qpk, D, q.device)
    code = B.lib().yt_attend_step(
        B.WTYPE[k_all.dtype], B.ptr(qc), B.ptr(kn), B.ptr(vn), B.ptr(k_all), B.ptr(v_all), B.ptr(freq),
        rope_mscale(theta), 1.0 / math.sqrt(D), B.ptr(out), B.ptr(scratch),
        B.ptr(_counter(q.device, Hk)), layer, S, Hk, qpk, D, kv_pos, kv_len, kv_sink, int(pos),
        kv_sinks, float(softcap), w, plan.lo, plan.chunk, plan.nsplit, int(plan.skip),
        B.stream_ptr())
    B.check(code, "attend_step_l")
    B.LAUNCHES["attend_step_l"] += 1
    return out


def attend_step_l(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                  k_all: torch.Tensor, v_all: torch.Tensor, layer: int,
                  kv_pos: int, kv_len: int, kv_sink: int, pos: int,
                  win=None, alt=None, *, kv_sinks: int, theta, rotary_dim: int,
                  softcap: float = 0.0) -> torch.Tensor:
    """Fused decode-attention step against layer `layer` of the cache.

    q: (Hk, qpk, D) f32 unrotated, unscaled; k_new/v_new: (Hk, D) f32.
    k_all/v_all: (L, S, Hk, D), updated IN PLACE at slot kv_pos.
    win: this layer's sliding window (Gemma2/3; None: every slot < kv_len);
    alt != 0: Gemma3's local-theta rope; softcap: Gemma2's score cap.
    Returns mix (Hk, qpk, D) f32. (The JAX function also returns the
    caches, which are the same tensors here.)"""
    args = (q, k_new, v_new, k_all, v_all, layer, kv_pos, kv_len, kv_sink, pos)
    kw = dict(kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim, softcap=softcap, win=win,
              alt=alt)
    if B.device_kind(q, k_new, v_new, k_all, v_all) == "cpu":
        return attend_step_plain(*args, **kw)
    return launch_attend_step(*args, **kw)


# ---------------------------------------------------------------------------
# attend_one_l: one query, read only
# ---------------------------------------------------------------------------

def attend_one_plain(q, k_all, v_all, layer, kv_len):
    """The JAX emulation branch (attention.py:98-102): q / sqrt(D), then
    `attend_ref` on layer `layer`. Returns (Hk, qpk, D) f32."""
    L, S, Hk, D = k_all.shape
    qpk = q.shape[1]
    q2 = (q.float() / math.sqrt(D)).reshape(Hk * qpk, D)
    return attend_ref(q2, k_all[layer], v_all[layer], kv_len).reshape(Hk, qpk, D)


def launch_attend_one(q, k_all, v_all, layer, kv_len):
    """csrc/attention.cu's one-lane split in its attend_one_l form (no RoPE,
    no write, no sinks) on CUDA tensors: two launches on the current stream
    (adds one to LAUNCHES["attend_one_l"])."""
    L, S, Hk, D = k_all.shape
    qpk = q.shape[1]
    B.require(k_all.dtype in KV_DTYPES and v_all.dtype == k_all.dtype,
              f"attend_one_l: the kernel takes a bf16 or e5m2 cache, got {k_all.dtype} "
              f"and {v_all.dtype}")
    B.require(k_all.is_contiguous() and v_all.is_contiguous() and v_all.shape == k_all.shape,
              "attend_one_l: k_all/v_all must be contiguous (L, S, Hk, D)")
    B.require(D % 8 == 0 and qpk * D <= 2048, f"attend_one_l: head_dim {D} x qpk {qpk} unsupported")
    B.require(0 <= layer < L and 1 <= kv_len <= S, "attend_one_l: layer or kv_len out of range")
    B.require(B.aligned16(k_all, v_all), "attend_one_l: cache must be 16-byte aligned")
    qc = q.float().contiguous()
    out = torch.empty((Hk, qpk, D), dtype=torch.float32, device=q.device)
    plan = split_plan(kv_len, Hk)
    scratch = split_scratch(plan, kv_len, Hk, qpk, D, q.device)
    code = B.lib().yt_attend_one(
        B.WTYPE[k_all.dtype], B.ptr(qc), B.ptr(k_all), B.ptr(v_all), math.sqrt(D), B.ptr(out),
        B.ptr(scratch), B.ptr(_counter(q.device, Hk)), layer, S, Hk, qpk, D, kv_len,
        plan.chunk, plan.nsplit, B.stream_ptr())
    B.check(code, "attend_one_l")
    B.LAUNCHES["attend_one_l"] += 1
    return out


def attend_one_l(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor, layer: int,
                 kv_len: int) -> torch.Tensor:
    """Single-position GQA attention against layer `layer` of the cache.

    q: (Hk, qpk, D) f32, unscaled (1/sqrt(D) is applied here); k_all/v_all:
    (L, S, Hk, D), bf16 or e5m2 on the card (any type on the CPU); slots <
    kv_len are attended and nothing is written. Returns (Hk, qpk, D) f32."""
    L, S, Hk, D = k_all.shape
    if q.dim() != 3 or (q.shape[0], q.shape[2]) != (Hk, D) or v_all.shape != k_all.shape:
        raise ValueError(f"attend_one_l: q {tuple(q.shape)} vs cache {tuple(k_all.shape)}, "
                         f"{tuple(v_all.shape)}")
    layer, kv_len = int(layer), int(kv_len)
    if B.device_kind(q, k_all, v_all) == "cpu":
        return attend_one_plain(q, k_all, v_all, layer, kv_len)
    return launch_attend_one(q, k_all, v_all, layer, kv_len)


# ---------------------------------------------------------------------------
# continuous batching: B lanes in one launch
# ---------------------------------------------------------------------------

LANE_FIELDS = ("kv_pos", "kv_len", "kv_sink", "pos", "write")


def lane_scalars(kv_pos, kv_len, kv_sink, pos, write=None, *, S: int, kv_sinks: int,
                 device) -> torch.Tensor:
    """The (5, B) int32 lane scalars (kv_pos, kv_len, kv_sink, pos, write)
    on `device`, uploaded once: the batched step reads them on the device,
    so no layer waits for the host. Values given on the host are checked
    here (1 <= kv_len <= S, 0 <= kv_pos < S, 0 <= kv_sink <= kv_sinks);
    the kernel gives a lane it cannot take a NaN output and writes nothing."""
    cols = [kv_pos, kv_len, kv_sink, pos,
            torch.ones(len(pos), dtype=torch.int32) if write is None else write]
    if all(isinstance(c, torch.Tensor) and c.device.type != "cpu" for c in cols):
        return torch.stack([c.to(torch.int32) for c in cols])
    host = torch.stack([torch.as_tensor(c).cpu().to(torch.int32).reshape(-1) for c in cols])
    kp, kl, ks = host[0], host[1], host[2]
    if not (bool(((kl >= 1) & (kl <= S)).all()) and bool(((kp >= 0) & (kp < S)).all())
            and bool(((ks >= 0) & (ks <= kv_sinks)).all())):
        raise ValueError(f"lane scalars out of range for a window of {S}: "
                         f"{dict(zip(LANE_FIELDS, host.tolist()))}")
    return host.to(device)


def attend_step_batched_plain(q, k_new, v_new, k_all, v_all, layer, lanes, *,
                              kv_sinks, theta, rotary_dim, softcap=0.0, win=None, alt=None):
    """The JAX emulation branch (attention.py:564-590): `attend_step_plain`
    per lane on views of the lane's cache, which it mutates in place unless
    the lane's write is 0. Returns mix (B, Hk, qpk, D) f32."""
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for b, (kp, kl, ks, p, wr) in enumerate(lanes.T.tolist()):
        out[b] = attend_step_plain(q[b], k_new[b], v_new[b], k_all[b], v_all[b], layer,
                                   kp, kl, ks, p, kv_sinks=kv_sinks, theta=theta,
                                   rotary_dim=rotary_dim, write=wr != 0, softcap=softcap,
                                   win=win, alt=alt)
    return out


def launch_attend_step_batched(q, k_new, v_new, k_all, v_all, layer, lanes, *,
                               kv_sinks, theta, rotary_dim, softcap=0.0, win=None, alt=None):
    """csrc/attention.cu's lanes split over B lanes on CUDA tensors: two
    launches on the current stream, no device value read (adds one to
    LAUNCHES["attend_step_batched_l"])."""
    Bn, L, S, Hk, D = k_all.shape
    qpk = q.shape[2]
    B.require(k_all.dtype in KV_DTYPES and v_all.dtype == k_all.dtype,
              f"attend_step_batched_l: the kernel takes a bf16 or e5m2 cache, got {k_all.dtype}")
    B.require(k_all.is_contiguous() and v_all.is_contiguous() and v_all.shape == k_all.shape,
              "attend_step_batched_l: k_all/v_all must be contiguous (B, L, S, Hk, D)")
    B.require(tuple(q.shape) == (Bn, Hk, qpk, D) and D % 8 == 0 and qpk * D <= 2048,
              f"attend_step_batched_l: q {tuple(q.shape)} vs cache {tuple(k_all.shape)}")
    B.require(tuple(k_new.shape) == (Bn, Hk, D) and tuple(v_new.shape) == (Bn, Hk, D),
              "attend_step_batched_l: k_new/v_new must be (B, Hk, D)")
    B.require(lanes.dtype == torch.int32 and tuple(lanes.shape) == (5, Bn)
              and lanes.is_contiguous(), "attend_step_batched_l: lanes must be (5, B) int32")
    B.require(0 <= layer < L, "attend_step_batched_l: layer out of range")
    B.require(B.aligned16(k_all, v_all), "attend_step_batched_l: cache must be 16-byte aligned")
    qc = q.float().contiguous()
    kn = k_new.float().contiguous()
    vn = v_new.float().contiguous()
    freq = _freq_table(theta, D, rotary_dim, str(q.device), bool(alt))
    out = torch.empty((Bn, Hk, qpk, D), dtype=torch.float32, device=q.device)
    # a lane's kv_len lives on the device: the plan and the scratch hold the window
    plan = lanes_split_plan(S, Hk)
    scratch = lanes_scratch(plan, Bn, S, Hk, qpk, D, q.device)
    code = B.lib().yt_attend_step_batched(
        B.WTYPE[k_all.dtype], B.ptr(qc), B.ptr(kn), B.ptr(vn), B.ptr(k_all), B.ptr(v_all),
        B.ptr(freq), rope_mscale(theta), 1.0 / math.sqrt(D), B.ptr(out), B.ptr(scratch),
        B.ptr(_counter(q.device, Bn * Hk)), B.ptr(lanes), Bn, L, layer, S, Hk, qpk, D,
        kv_sinks, float(softcap), _win_arg(win, S, "attend_step_batched_l"), plan.chunk,
        plan.nsplit, B.stream_ptr())
    B.check(code, "attend_step_batched_l")
    B.LAUNCHES["attend_step_batched_l"] += 1
    return out


def attend_step_batched(q, k_new, v_new, k_all, v_all, layer, lanes, *, kv_sinks,
                        theta, rotary_dim, softcap=0.0, win=None, alt=None):
    """The batched step with the lane scalars already packed by
    `lane_scalars` (the tick packs them once for every layer)."""
    kw = dict(kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim, softcap=softcap, win=win,
              alt=alt)
    args = (q, k_new, v_new, k_all, v_all, layer, lanes)
    if B.device_kind(q, k_new, v_new, k_all, v_all, lanes) == "cpu":
        return attend_step_batched_plain(*args, **kw)
    return launch_attend_step_batched(*args, **kw)


def attend_step_batched_l(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                          k_all: torch.Tensor, v_all: torch.Tensor, layer: int,
                          kv_pos, kv_len, kv_sink, pos, write=None, win=None, alt=None, *,
                          kv_sinks: int, theta, rotary_dim: int,
                          softcap: float = 0.0) -> torch.Tensor:
    """Batched attend_step_l for the continuous-batching tick.

    q: (B, Hk, qpk, D) f32 unrotated, unscaled; k_new/v_new: (B, Hk, D) f32.
    k_all/v_all: (B, L, S, Hk, D), updated IN PLACE at each writing lane's
    slot kv_pos. kv_pos/kv_len/kv_sink/pos/write: (B,) ints per lane (write
    0 = read-only lane; default: every lane writes). Returns mix (B, Hk,
    qpk, D) f32; win, alt and softcap as attend_step_l's (a read-only lane's
    slot ages count from the kv_pos it was given). (The JAX function also
    returns the caches, which are the same tensors here.)"""
    lanes = lane_scalars(kv_pos, kv_len, kv_sink, pos, write, S=k_all.shape[2],
                         kv_sinks=kv_sinks, device=k_all.device)
    return attend_step_batched(q, k_new, v_new, k_all, v_all, layer, lanes,
                               kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim,
                               softcap=softcap, win=win, alt=alt)


# ---------------------------------------------------------------------------
# paged KV: B lanes over a page pool through per-lane page tables
# ---------------------------------------------------------------------------

def page_tables(tables, *, n_pages: int, nblk: int, device) -> torch.Tensor:
    """The (B, nblk) int32 page tables on `device`, uploaded once per tick.
    Tables given on the host are checked here (every id in [0, n_pages));
    the kernel gives a lane whose ids it cannot take a NaN output and
    writes nothing."""
    if isinstance(tables, torch.Tensor) and tables.device.type != "cpu":
        out = tables.to(torch.int32).contiguous()
    else:
        out = torch.as_tensor(tables).to(torch.int32).contiguous()
        if out.numel() and not bool(((out >= 0) & (out < n_pages)).all()):
            raise ValueError(f"page ids out of range for a pool of {n_pages} pages: "
                             f"{out.tolist()}")
        out = out.to(device)
    if out.dim() != 2 or out.shape[1] != nblk:
        raise ValueError(f"page tables must be (B, {nblk}), got {tuple(out.shape)}")
    return out


def gather_pages(pool_layer: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Lanes' views of one pool layer (n_pages, page, Hk, D) through their
    (..., nblk) tables: (..., nblk * page, Hk, D), gathered through integer
    views (`_gather_lane`, attention.py:1074)."""
    idx = tables.to(device=pool_layer.device, dtype=torch.long)
    rows = int_view(pool_layer).index_select(0, idx.reshape(-1)).view(pool_layer.dtype)
    return rows.reshape(*idx.shape[:-1], -1, *pool_layer.shape[2:])


def attend_step_paged_plain(q, k_new, v_new, k_pool, v_pool, tables, layer, lanes, *,
                            kv_sinks, theta, rotary_dim, softcap=0.0, win=None, alt=None):
    """The JAX emulation branch (attention.py:1119-1159) for one layer: per
    lane in order, gather the lane's view of layer `layer` through its
    table, run `attend_step_plain` on it (write 0: attend it as it is),
    and write the one new row back to its page. Returns mix (B, Hk, qpk, D)
    f32. (The emulation scatters the whole view back; only the new row
    differs from what was gathered, except on page 0, where unmapped blocks
    of several lanes collide.)"""
    page = k_pool.shape[2]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    tab = tables.cpu()
    for b, (kp, kl, ks, p, wr) in enumerate(lanes.T.tolist()):
        views = [gather_pages(pool[:, layer], tab[b])[None] for pool in (k_pool, v_pool)]
        out[b] = attend_step_plain(q[b], k_new[b], v_new[b], *views, 0, kp, kl, ks, p,
                                   kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim,
                                   write=wr != 0, softcap=softcap, win=win, alt=alt)
        if wr:
            pg = int(tab[b, kp // page])
            for pool, view in zip((k_pool, v_pool), views):
                int_view(pool[pg, layer, kp % page]).copy_(int_view(view[0, kp]))
    return out


def launch_attend_step_paged(q, k_new, v_new, k_pool, v_pool, tables, layer, lanes, *,
                             kv_sinks, theta, rotary_dim, softcap=0.0, win=None, alt=None):
    """csrc/attention.cu's lanes split over B lanes of a page pool on CUDA
    tensors: two launches on the current stream, no device value read (adds
    one to LAUNCHES["attend_step_paged_l"])."""
    n_pages, L, page, Hk, D = k_pool.shape
    Bn, nblk = tables.shape
    qpk = q.shape[2]
    S = nblk * page
    B.require(k_pool.dtype in KV_DTYPES and v_pool.dtype == k_pool.dtype,
              f"attend_step_paged_l: the kernel takes a bf16 or e5m2 pool, got {k_pool.dtype}")
    B.require(k_pool.is_contiguous() and v_pool.is_contiguous()
              and v_pool.shape == k_pool.shape,
              "attend_step_paged_l: k_pool/v_pool must be contiguous (n_pages, L, page, Hk, D)")
    B.require(tuple(q.shape) == (Bn, Hk, qpk, D) and D % 8 == 0 and qpk * D <= 2048,
              f"attend_step_paged_l: q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}")
    B.require(tuple(k_new.shape) == (Bn, Hk, D) and tuple(v_new.shape) == (Bn, Hk, D),
              "attend_step_paged_l: k_new/v_new must be (B, Hk, D)")
    B.require(lanes.dtype == torch.int32 and tuple(lanes.shape) == (5, Bn)
              and lanes.is_contiguous(), "attend_step_paged_l: lanes must be (5, B) int32")
    B.require(tables.dtype == torch.int32 and tables.is_contiguous(),
              "attend_step_paged_l: tables must be (B, nblk) int32")
    B.require(0 <= layer < L, "attend_step_paged_l: layer out of range")
    B.require(B.aligned16(k_pool, v_pool), "attend_step_paged_l: pool must be 16-byte aligned")
    qc = q.float().contiguous()
    kn = k_new.float().contiguous()
    vn = v_new.float().contiguous()
    freq = _freq_table(theta, D, rotary_dim, str(q.device), bool(alt))
    out = torch.empty((Bn, Hk, qpk, D), dtype=torch.float32, device=q.device)
    plan = lanes_split_plan(S, Hk)
    scratch = lanes_scratch(plan, Bn, S, Hk, qpk, D, q.device)
    code = B.lib().yt_attend_step_paged(
        B.WTYPE[k_pool.dtype], B.ptr(qc), B.ptr(kn), B.ptr(vn), B.ptr(k_pool), B.ptr(v_pool),
        B.ptr(freq), rope_mscale(theta), 1.0 / math.sqrt(D), B.ptr(out), B.ptr(scratch),
        B.ptr(_counter(q.device, Bn * Hk)), B.ptr(lanes), B.ptr(tables), Bn, n_pages, L, layer,
        page, nblk, Hk, qpk, D, kv_sinks, float(softcap),
        _win_arg(win, S, "attend_step_paged_l"), plan.chunk, plan.nsplit, B.stream_ptr())
    B.check(code, "attend_step_paged_l")
    B.LAUNCHES["attend_step_paged_l"] += 1
    return out


def attend_step_paged(q, k_new, v_new, k_pool, v_pool, tables, layer, lanes, *, kv_sinks,
                      theta, rotary_dim, softcap=0.0, win=None, alt=None):
    """The paged step with the lane scalars and the tables already on the
    device (`lane_scalars`, `page_tables`: the tick uploads them once for
    every layer)."""
    kw = dict(kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim, softcap=softcap, win=win,
              alt=alt)
    args = (q, k_new, v_new, k_pool, v_pool, tables, layer, lanes)
    if B.device_kind(q, k_new, v_new, k_pool, v_pool, tables, lanes) == "cpu":
        return attend_step_paged_plain(*args, **kw)
    return launch_attend_step_paged(*args, **kw)


def attend_step_paged_l(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                        k_pool: torch.Tensor, v_pool: torch.Tensor, tables, layer: int,
                        kv_pos, kv_len, kv_sink, pos, write=None, win=None, alt=None, *,
                        kv_sinks: int, theta, rotary_dim: int, window: int,
                        softcap: float = 0.0) -> torch.Tensor:
    """Paged attend_step_batched_l.

    k_pool/v_pool: (n_pages, L, page, Hk, D), updated IN PLACE at each
    writing lane's row (tables[b, kv_pos // page], layer, kv_pos % page);
    tables: (B, window // page) page ids (unmapped blocks may point at any
    page in the pool: slots >= kv_len are never read). Other arguments as
    attend_step_batched_l (a sliding window counts ages over the lane's
    logical slots). Returns mix (B, Hk, qpk, D) f32. (The JAX function also
    returns the pools, which are the same tensors here.)"""
    n_pages, _, page, _, _ = k_pool.shape
    if window % page:
        raise ValueError(f"attend_step_paged_l: page {page} does not divide window {window}")
    tab = page_tables(tables, n_pages=n_pages, nblk=window // page, device=k_pool.device)
    lanes = lane_scalars(kv_pos, kv_len, kv_sink, pos, write, S=window, kv_sinks=kv_sinks,
                         device=k_pool.device)
    return attend_step_paged(q, k_new, v_new, k_pool, v_pool, tab, layer, lanes,
                             kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim,
                             softcap=softcap, win=win, alt=alt)
