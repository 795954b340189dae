"""Fused decode attention step (port of `attend_step_l`, its
continuous-batching form `attend_step_batched_l` and its paged form
`attend_step_paged_l`, `yalm_tpu/ops/pallas/attention.py`).

One step: RoPE on q and k_new at `pos`, write the k/v row into ring slot
`kv_pos` IN PLACE (the port mutates the cache tensors where the JAX package
aliased its buffers), the lazy StreamingLLM sink view in the ring regime,
then GQA attention over slots < kv_len. The batched form does this for B
lanes of a (B, L, S, Hk, D) cache in one launch, each lane with its own
scalars; a lane whose `write` is 0 changes nothing and attends the cache as
it is (lanes mid-admission). The paged form does it over a page pool
(n_pages, L, page, Hk, D), lane b's slot s at (tables[b, s // page], layer,
s % page). Kernel: `csrc/attention.cu`. The
cache is bf16 or fp8 e5m2 (`-C fp8`): the new row is rounded from f32 to
the cache type in one step, attention reads the cache widened to bf16
(exact), and the sink view is rounded to bf16, the working type, for
both. Softcap, sliding window and Gemma3's alternate rope are later slices
and raise here.
"""

from __future__ import annotations

import functools
import math

import torch

from ..core import (NEG_INF, int_view, rope_freq_table, rope_mscale, rope_rotation_param,
                    rotate_pairs)
from . import _build as B
from .gemv import bf16f


SMEM_MAX = 227 * 1024
KV_DTYPES = (torch.bfloat16, torch.float8_e5m2)


def smem_bytes(qpk: int, D: int, kv_len: int) -> int:
    """Shared memory of csrc/attention.cu: q, every score (one tile's, 64,
    when the scores go to global scratch), one K/V tile."""
    words = qpk * (D + 2) + kv_len * qpk
    return (words + 3) // 4 * 16 + 64 * (D + 8) * 2


@functools.lru_cache(maxsize=64)
def _freq_table(theta, D: int, rotary_dim: int, device: str) -> torch.Tensor:
    # one (D/2,) table per model and device; the kernel reads it every step
    return rope_freq_table(theta, D, rotary_dim, device=torch.device(device))


def _rot(rows: torch.Tensor, theta, rotary_dim: int, pos) -> torch.Tensor:
    """RoPE rows[..., D] forward by `pos` positions (f32)."""
    freq = _freq_table(theta, rows.shape[-1], rotary_dim, str(rows.device))
    ang = freq * float(pos)   # f32 product, as pos_f32 * freq
    return rotate_pairs(rows.float(), ang, rope_mscale(theta))


def sink_view(k: torch.Tensor, kv_sink: int, pos: int, *, theta,
              rotary_dim: int) -> torch.Tensor:
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
    rows = _rot(kf[:kv_sink], rope_rotation_param(theta), rotary_dim, rot)
    wd = k.dtype if k.element_size() >= 2 else torch.bfloat16
    kf = kf.clone()
    kf[:kv_sink] = rows.to(wd).float()
    return kf


def attend_step_plain(q, k_new, v_new, k_all, v_all, layer, kv_pos, kv_len,
                      kv_sink, pos, *, kv_sinks, theta, rotary_dim, write=True):
    """The JAX emulation `_attn_step_ref` (attention.py:775-802): mutates
    k_all/v_all in place, returns mix (Hk, qpk, D) f32. The new rows are
    rounded from f32 to the cache type in one step. Normalises the softmax
    before the bf16 cast of p, as the emulation and the CUDA kernel do (the
    Pallas kernel's online softmax normalises after). write=False changes
    nothing and attends the cache as it is (attention.py:571-588)."""
    L, S, Hk, D = k_all.shape
    _, qpk, _ = q.shape
    q2 = _rot(q.float().reshape(Hk * qpk, D), theta, rotary_dim, pos) * (1.0 / math.sqrt(D))
    if write:
        k_all[layer, kv_pos] = _rot(k_new.float(), theta, rotary_dim, pos).to(k_all.dtype)
        v_all[layer, kv_pos] = v_new.float().to(v_all.dtype)
    k = sink_view(k_all[layer], kv_sink, pos, theta=theta, rotary_dim=rotary_dim)
    q3 = bf16f(q2).reshape(Hk, qpk, D)
    scores = torch.einsum("gpd,sgd->gps", q3, bf16f(k))
    valid = torch.arange(S, device=k.device) < kv_len
    scores = torch.where(valid[None, None], scores, torch.full_like(scores, NEG_INF))
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum("gps,sgd->gpd", bf16f(att), bf16f(v_all[layer].float()))
    return out


def launch_attend_step(q, k_new, v_new, k_all, v_all, layer, kv_pos, kv_len,
                       kv_sink, pos, *, kv_sinks, theta, rotary_dim):
    """One launch of csrc/attention.cu on CUDA tensors (adds one to
    LAUNCHES["attend_step_l"])."""
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
    freq = _freq_table(theta, D, rotary_dim, str(q.device))
    out = torch.empty((Hk, qpk, D), dtype=torch.float32, device=q.device)
    # the scores of a window too long for shared memory go to global scratch
    scores = (None if smem_bytes(qpk, D, kv_len) <= SMEM_MAX else
              torch.empty((Hk, kv_len, qpk), dtype=torch.float32, device=q.device))
    code = B.lib().yt_attend_step(
        B.WTYPE[k_all.dtype], B.ptr(qc), B.ptr(kn), B.ptr(vn), B.ptr(k_all), B.ptr(v_all), B.ptr(freq),
        rope_mscale(theta), 1.0 / math.sqrt(D), B.ptr(out), B.ptr(scores),
        layer, S, Hk, qpk, D, kv_pos, kv_len, kv_sink, int(pos), kv_sinks,
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
    Returns mix (Hk, qpk, D) f32. (The JAX function also returns the
    caches, which are the same tensors here.)"""
    if win is not None or alt is not None or softcap:
        raise NotImplementedError(
            "attend_step_l: sliding window, alternate rope and softcap are a later slice")
    args = (q, k_new, v_new, k_all, v_all, layer, kv_pos, kv_len, kv_sink, pos)
    kw = dict(kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim)
    if B.device_kind(q, k_new, v_new, k_all, v_all) == "cpu":
        return attend_step_plain(*args, **kw)
    return launch_attend_step(*args, **kw)


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
                              kv_sinks, theta, rotary_dim):
    """The JAX emulation branch (attention.py:564-590): `attend_step_plain`
    per lane on views of the lane's cache, which it mutates in place unless
    the lane's write is 0. Returns mix (B, Hk, qpk, D) f32."""
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for b, (kp, kl, ks, p, wr) in enumerate(lanes.T.tolist()):
        out[b] = attend_step_plain(q[b], k_new[b], v_new[b], k_all[b], v_all[b], layer,
                                   kp, kl, ks, p, kv_sinks=kv_sinks, theta=theta,
                                   rotary_dim=rotary_dim, write=wr != 0)
    return out


def launch_attend_step_batched(q, k_new, v_new, k_all, v_all, layer, lanes, *,
                               kv_sinks, theta, rotary_dim):
    """One launch of csrc/attention.cu over B lanes on CUDA tensors (adds
    one to LAUNCHES["attend_step_batched_l"])."""
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
    freq = _freq_table(theta, D, rotary_dim, str(q.device))
    out = torch.empty((Bn, Hk, qpk, D), dtype=torch.float32, device=q.device)
    # a lane's kv_len lives on the device: the score space holds the window
    scores = (None if smem_bytes(qpk, D, S) <= SMEM_MAX else
              torch.empty((Bn, Hk, S, qpk), dtype=torch.float32, device=q.device))
    code = B.lib().yt_attend_step_batched(
        B.WTYPE[k_all.dtype], B.ptr(qc), B.ptr(kn), B.ptr(vn), B.ptr(k_all), B.ptr(v_all),
        B.ptr(freq), rope_mscale(theta), 1.0 / math.sqrt(D), B.ptr(out), B.ptr(scores),
        B.ptr(lanes), Bn, L, layer, S, Hk, qpk, D, kv_sinks, B.stream_ptr())
    B.check(code, "attend_step_batched_l")
    B.LAUNCHES["attend_step_batched_l"] += 1
    return out


def attend_step_batched(q, k_new, v_new, k_all, v_all, layer, lanes, *, kv_sinks,
                        theta, rotary_dim):
    """The batched step with the lane scalars already packed by
    `lane_scalars` (the tick packs them once for every layer)."""
    kw = dict(kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim)
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
    qpk, D) f32. (The JAX function also returns the caches, which are the
    same tensors here.)"""
    if win is not None or alt is not None or softcap:
        raise NotImplementedError(
            "attend_step_batched_l: sliding window, alternate rope and softcap are a later "
            "slice (see ROADMAP.md)")
    lanes = lane_scalars(kv_pos, kv_len, kv_sink, pos, write, S=k_all.shape[2],
                         kv_sinks=kv_sinks, device=k_all.device)
    return attend_step_batched(q, k_new, v_new, k_all, v_all, layer, lanes,
                               kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim)


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
                            kv_sinks, theta, rotary_dim):
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
                                   write=wr != 0)
        if wr:
            pg = int(tab[b, kp // page])
            for pool, view in zip((k_pool, v_pool), views):
                int_view(pool[pg, layer, kp % page]).copy_(int_view(view[0, kp]))
    return out


def launch_attend_step_paged(q, k_new, v_new, k_pool, v_pool, tables, layer, lanes, *,
                             kv_sinks, theta, rotary_dim):
    """One launch of csrc/attention.cu over B lanes of a page pool on CUDA
    tensors (adds one to LAUNCHES["attend_step_paged_l"])."""
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
    freq = _freq_table(theta, D, rotary_dim, str(q.device))
    out = torch.empty((Bn, Hk, qpk, D), dtype=torch.float32, device=q.device)
    scores = (None if smem_bytes(qpk, D, S) <= SMEM_MAX else
              torch.empty((Bn, Hk, S, qpk), dtype=torch.float32, device=q.device))
    code = B.lib().yt_attend_step_paged(
        B.WTYPE[k_pool.dtype], B.ptr(qc), B.ptr(kn), B.ptr(vn), B.ptr(k_pool), B.ptr(v_pool),
        B.ptr(freq), rope_mscale(theta), 1.0 / math.sqrt(D), B.ptr(out), B.ptr(scores),
        B.ptr(lanes), B.ptr(tables), Bn, n_pages, L, layer, page, nblk, Hk, qpk, D, kv_sinks,
        B.stream_ptr())
    B.check(code, "attend_step_paged_l")
    B.LAUNCHES["attend_step_paged_l"] += 1
    return out


def attend_step_paged(q, k_new, v_new, k_pool, v_pool, tables, layer, lanes, *, kv_sinks,
                      theta, rotary_dim):
    """The paged step with the lane scalars and the tables already on the
    device (`lane_scalars`, `page_tables`: the tick uploads them once for
    every layer)."""
    kw = dict(kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim)
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
    attend_step_batched_l. Returns mix (B, Hk, qpk, D) f32. (The JAX
    function also returns the pools, which are the same tensors here.)"""
    if win is not None or alt is not None or softcap:
        raise NotImplementedError(
            "attend_step_paged_l: sliding window, alternate rope and softcap are a later "
            "slice (see ROADMAP.md)")
    n_pages, _, page, _, _ = k_pool.shape
    if window % page:
        raise ValueError(f"attend_step_paged_l: page {page} does not divide window {window}")
    tab = page_tables(tables, n_pages=n_pages, nblk=window // page, device=k_pool.device)
    lanes = lane_scalars(kv_pos, kv_len, kv_sink, pos, write, S=window, kv_sinks=kv_sinks,
                         device=k_pool.device)
    return attend_step_paged(q, k_new, v_new, k_pool, v_pool, tab, layer, lanes,
                             kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim)
