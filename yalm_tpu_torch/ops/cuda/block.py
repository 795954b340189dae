"""Attention block of one decode step (port of `attn_block_l` and its
packed-int4 twin `attn_block4_l`, `yalm_tpu/ops/pallas/block.py`):

    x + Wo[layer] @ attend(rope(clip(Wqkv[layer] @ rmsnorm(x) * s + b)))

The TPU runs this as ONE Pallas kernel; so does the port on CUDA:
`csrc/block.cu`'s `attn_block_kernel`, one cooperative launch whose
co-resident blocks walk four phases -- the wqkv GEMV's K slices, the
attention split's two passes, the wo GEMV's slices -- each item waiting
only for the items it reads (per row block of qkv, per kv head), while the
layer's wo rows are prefetched into L2 under the attention (the file
comment has the design). `block_plan` cuts the
launch with the plans of the kernels it fuses (`gemv_plan` for each
projection, `split_plan` for the attention), so it gives their bits. The
same kernel takes dense, int8 and fp8 weights with per-row scales (L, N)
and packed int4 (uint8) weights with group scales (L, G, N), a bf16 or an
e5m2 cache. On the CPU the plain version runs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..core import rope_mscale
from ..int4 import int4_group
from . import _build as B
from .attention import (KV_DTYPES, SplitPlan, _freq_table, attend_step_l,
                        attend_step_split_plain, split_plan)
from .gemv import (GEMV_PART, SMS, GemvPlan, _split_buffers, gemv_l_plain, gemv_plan,
                   gemv_row_blocks, gemv_split_plain, is_int4)


def _split_qkv(qkv, n_heads, Hk, D):
    q_dim = n_heads * D
    q = qkv[:q_dim].reshape(Hk, n_heads // Hk, D)
    k = qkv[q_dim:q_dim + Hk * D].reshape(Hk, D)
    v = qkv[q_dim + Hk * D:].reshape(Hk, D)
    return q, k, v


def attn_block_plain(x, norm_w, wqkv_all, wo_all, k_all, v_all, layer, kv_pos,
                     kv_len, kv_sink, pos, *, n_heads, kv_sinks, theta,
                     rotary_dim, norm_eps, qkv_clip=math.inf, bqkv_all=None,
                     add_residual=True, scale_qkv=None, scale_o=None):
    """The JAX emulation branches (block.py:586-612, and :400-428 for int4
    weights with group scales); mutates the cache."""
    _, S, Hk, D = k_all.shape
    qkv = gemv_l_plain(x, wqkv_all, layer, norm_w=norm_w, norm_eps=norm_eps,
                       scale=scale_qkv)
    if bqkv_all is not None:
        qkv = qkv + bqkv_all[layer].float()
    if not math.isinf(qkv_clip):
        qkv = torch.clamp(qkv, -qkv_clip, qkv_clip)
    q, k, v = _split_qkv(qkv, n_heads, Hk, D)
    mix = attend_step_l(q, k, v, k_all, v_all, layer, kv_pos, kv_len, kv_sink,
                        pos, kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim)
    out = gemv_l_plain(mix.reshape(-1), wo_all, layer, scale=scale_o)
    return x + out if add_residual else out


def attn_block_split_plain(x, norm_w, wqkv_all, wo_all, k_all, v_all, layer, kv_pos,
                           kv_len, kv_sink, pos, *, n_heads, kv_sinks, theta,
                           rotary_dim, norm_eps, qkv_clip=math.inf, bqkv_all=None,
                           add_residual=True, scale_qkv=None, scale_o=None):
    """The one launch's arithmetic, plainly (block_plan's items): the wqkv
    GEMV's K slices summed in slice order, then the scale, bias and clip
    (`gemv_split_plain`); the attention in split_plan's chunks, each chunk's
    max and sum, p normalised then cast to bf16, the chunks' partial
    outputs summed in chunk order (`attend_step_split_plain`, which writes
    the cache row); the wo GEMV's slices in slice order, then the
    residual. Takes attn_block_plain's arguments."""
    _, S, Hk, D = k_all.shape
    qkv = gemv_split_plain(x[None], wqkv_all, layer, scale_qkv, norm_w=norm_w,
                           norm_eps=norm_eps, bias=bqkv_all, clip=qkv_clip)[0]
    q, k, v = _split_qkv(qkv, n_heads, Hk, D)
    mix = attend_step_split_plain(q, k, v, k_all, v_all, layer, kv_pos, kv_len, kv_sink, pos,
                                  kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim)
    return gemv_split_plain(mix.reshape(1, -1), wo_all, layer, scale_o,
                            residual=x[None] if add_residual else None)[0]


# ---------------------------------------------------------------------------
# csrc/block.cu's attn_block_kernel: its plan
# ---------------------------------------------------------------------------

BLOCK_GRID = 2 * SMS   # co-resident blocks asked for: 2 per SM (__launch_bounds__(256, 2))
# the scratch regions, in their order: the wqkv slices' partials, rope's
# input rows (their sum and epilogue), the wo slices' partials, mix, the
# attention's partial outputs, its maxima and sums, its scores
REGIONS = ("qkv_part", "qkv", "wo_part", "mix", "att_part", "ml", "scores")


class BlockPlan(NamedTuple):
    """How attn_block_kernel cuts one call. Its phases' work items: A the
    wqkv GEMV's (row block, K slice) pairs of `qkv` (item blk * split + z),
    B the attention's (chunk, kv head) pairs of `att` (item h * nsplit + c,
    both passes), C the wo GEMV's pairs of `wo`. `offsets`: where each of
    REGIONS starts in the f32 scratch (16-byte aligned), `floats` in all;
    `counters`: the int32 arrival counters and flags (csrc/block.cu's
    yt_attn_block: per kv head, wo row block and wqkv row block; then the
    flags per wqkv row block, kv head and kv head; one exit count), all 0
    between calls; `grid`: the blocks asked for."""
    qkv: GemvPlan
    wo: GemvPlan
    att: SplitPlan
    items: tuple
    offsets: tuple
    floats: int
    counters: int
    grid: int


def _quad(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=4096)   # every decode layer asks: a few shapes, host time
def block_plan(dim: int, n_heads: int, Hk: int, D: int, kv_len: int, kv_pos: int = 0,
               kv_sink: int = 0, itemsize: int = 1, int4: bool = False) -> BlockPlan:
    """The plan of one attn_block launch at model width dim, n_heads query
    and Hk kv heads of D, on weights of `itemsize` bytes (packed int4:
    int4=True, group widths int4_group of each K): the GEMV plans of the
    four-launch sequence's wqkv (dim -> Nqkv, the rmsnorm prologue) and wo
    (q_dim -> dim) launches at one row of x, and its attention split, so
    that the one launch takes the same sums in the same order."""
    q_dim, qpk = n_heads * D, n_heads // Hk
    Nqkv = q_dim + 2 * Hk * D
    isz = 1 if int4 else itemsize
    qkv = gemv_plan(1, Nqkv, dim, False, int4_group(dim) if int4 else 0, isz)
    wo = gemv_plan(1, dim, q_dim, False, int4_group(q_dim) if int4 else 0, isz)
    att = split_plan(kv_len, Hk, kv_pos=kv_pos, kv_sink=kv_sink)
    rows_a, rows_c = gemv_row_blocks(Nqkv, False), gemv_row_blocks(dim, False)
    items = (rows_a * qkv.split, att.nsplit * Hk, rows_c * wo.split)
    sizes = (rows_a * qkv.split * GEMV_PART, Nqkv, rows_c * wo.split * GEMV_PART, q_dim,
             Hk * att.nsplit * qpk * D, Hk * att.nsplit * qpk * 2, Hk * kv_len * qpk)
    offsets, at = [], 0
    for n in sizes:
        offsets.append(at)
        at += _quad(n)
    return BlockPlan(qkv, wo, att, items, tuple(offsets), at, 3 * Hk + rows_c + 2 * rows_a + 1,
                     min(BLOCK_GRID, max(items)))


def _f32(t, what, shape):
    if t is None:
        return None
    B.require(t.dtype == torch.float32 and t.is_contiguous() and tuple(t.shape) == shape,
              f"{what}: contiguous float32 {shape} expected, got {t.dtype} {tuple(t.shape)}")
    return t


def launch_attn_block(name, x, norm_w, wqkv_all, wo_all, k_all, v_all, layer, kv_pos, kv_len,
                      kv_sink, pos, *, n_heads, kv_sinks, theta, rotary_dim, norm_eps,
                      qkv_clip=math.inf, bqkv_all=None, add_residual=True, scale_qkv=None,
                      scale_o=None, stamps=None):
    """One launch of csrc/block.cu's attn_block_kernel on CUDA tensors, cut
    by block_plan (adds one to LAUNCHES[name]); the scratch and counters are
    gemv.py's held per (device, stream). A launch the card refuses raises.
    stamps: None, or a (block_plan(...).grid, 8) int64 tensor that receives
    each block's phase bounds on the card's ns timer (block.cu's stamp())."""
    from .gemv import _split_buffers
    L, S, Hk, D = k_all.shape
    int4 = is_int4(wqkv_all)
    dim, Nqkv = x.shape[0], wqkv_all.shape[1]
    q_dim, qpk = n_heads * D, n_heads // Hk
    B.require(wqkv_all.dtype in B.WTYPE and wo_all.dtype == wqkv_all.dtype
              and wqkv_all.is_contiguous() and wo_all.is_contiguous(),
              f"{name}: contiguous wqkv and wo of one weight type, got {wqkv_all.dtype} "
              f"and {wo_all.dtype}")
    B.require(tuple(wo_all.shape) == (L, dim, q_dim // 2 if int4 else q_dim)
              and wqkv_all.shape[0] == L,
              f"{name}: wo {tuple(wo_all.shape)} vs {L} layers, dim {dim}, q_dim {q_dim}")
    B.require(k_all.dtype in KV_DTYPES and v_all.dtype == k_all.dtype
              and k_all.is_contiguous() and v_all.is_contiguous() and v_all.shape == k_all.shape,
              f"{name}: contiguous bf16 or e5m2 k_all/v_all (L, S, Hk, D), got {k_all.dtype}")
    B.require(n_heads % Hk == 0 and D % 8 == 0 and qpk * D <= 2048 and 0 <= kv_sinks <= 64,
              f"{name}: {n_heads} heads over {Hk} kv heads of {D} unsupported")
    B.require(0 <= layer < L and 0 <= kv_pos < S and 1 <= kv_len <= S
              and 0 <= kv_sink <= kv_sinks, f"{name}: layer or position scalars out of range")
    if int4:
        B.require(dim % 256 == 0 and q_dim % 256 == 0, f"{name}: int4 weights need K % 256 == 0")
        gq, go = int4_group(dim), int4_group(q_dim)
        _f32(scale_qkv, f"{name} scale_qkv", (L, dim // gq, Nqkv))
        _f32(scale_o, f"{name} scale_o", (L, q_dim // go, dim))
        B.require(scale_qkv is not None and scale_o is not None,
                  f"{name}: int4 weights need their group scales")
        gs_qkv, gs_o, scale_qkv, scale_o = scale_qkv, scale_o, None, None
    else:
        gq = go = 0
        gs_qkv = gs_o = None
        isz = wqkv_all.element_size()
        B.require(dim * isz % 16 == 0 and q_dim * isz % 16 == 0,
                  f"{name}: K * itemsize must be a multiple of 16 bytes")
        _f32(scale_qkv, f"{name} scale_qkv", (L, Nqkv))
        _f32(scale_o, f"{name} scale_o", (L, dim))
    _f32(x, f"{name} x", (dim,))
    _f32(norm_w, f"{name} norm_w", (L, dim))
    _f32(bqkv_all, f"{name} bqkv", (L, Nqkv))
    B.require(B.aligned16(wqkv_all, wo_all, x, k_all, v_all),
              f"{name}: weights, x and the cache must be 16-byte aligned")
    plan = block_plan(dim, n_heads, Hk, D, kv_len, kv_pos, kv_sink,
                      1 if int4 else wqkv_all.element_size(), int4)
    B.require(stamps is None or (stamps.dtype == torch.int64 and stamps.is_contiguous()
                                 and stamps.numel() >= 8 * plan.grid),
              f"{name}: stamps must be {plan.grid} x 8 int64")
    scratch, ctr = _split_buffers(x.device, plan.floats, plan.counters)
    base = scratch.data_ptr()
    regions = [ctypes.c_void_p(base + 4 * o) for o in plan.offsets]
    out = torch.empty(dim, dtype=torch.float32, device=x.device)
    code = B.lib().yt_attn_block(
        B.WTYPE[wqkv_all.dtype], B.WTYPE[k_all.dtype], B.ptr(wqkv_all), B.ptr(wo_all), B.ptr(x),
        B.ptr(norm_w), norm_eps, B.ptr(scale_qkv), B.ptr(gs_qkv), gq, B.ptr(bqkv_all),
        qkv_clip if math.isfinite(qkv_clip) else 0.0, B.ptr(scale_o), B.ptr(gs_o), go,
        B.ptr(k_all), B.ptr(v_all), B.ptr(_freq_table(theta, D, rotary_dim, str(x.device))),
        rope_mscale(theta), 1.0 / math.sqrt(D), B.ptr(out), 1 if add_residual else 0, *regions,
        B.ptr(ctr), B.ptr(stamps), L, layer, dim, S, Hk, qpk, D, kv_pos, kv_len, kv_sink, int(pos), kv_sinks,
        plan.qkv.kchunk, plan.qkv.split, plan.wo.kchunk, plan.wo.split, plan.att.chunk,
        plan.att.nsplit, plan.grid, B.stream_ptr())
    B.check(code, name)
    B.LAUNCHES[name] += 1
    return out


def attn_block(x, norm_w, wqkv_all, wo_all, k_all, v_all, layer, kv_pos,
               kv_len, kv_sink, pos, *, n_heads, kv_sinks, theta, rotary_dim,
               norm_eps, qkv_clip=math.inf, bqkv_all=None, add_residual=True,
               scale_qkv=None, scale_o=None):
    """attn_block_l or attn_block4_l, as the weight type says (the decode
    path's one route): per-row scales (L, N) for dense/int8 weights, group
    scales (L, G, N) for packed int4 (uint8) ones. Launches are counted
    under the JAX name of the twin that matches the weights."""
    L, S, Hk, D = k_all.shape
    int4 = is_int4(wqkv_all)
    name = "attn_block4_l" if int4 else "attn_block_l"
    K = wqkv_all.shape[2] * (2 if int4 else 1)
    if (tuple(x.shape) != (K,) or wqkv_all.shape[1] != (n_heads + 2 * Hk) * D
            or is_int4(wo_all) != int4):
        raise ValueError(f"{name}: x {tuple(x.shape)}, wqkv {tuple(wqkv_all.shape)} "
                         f"{wqkv_all.dtype}, wo {tuple(wo_all.shape)} {wo_all.dtype}")
    kind = B.device_kind(x, norm_w, wqkv_all, wo_all, k_all, v_all, bqkv_all,
                         scale_qkv, scale_o)
    fn = attn_block_plain if kind == "cpu" else functools.partial(launch_attn_block, name)
    return fn(x, norm_w, wqkv_all, wo_all, k_all, v_all, layer, kv_pos, kv_len, kv_sink, pos,
              n_heads=n_heads, kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim,
              norm_eps=norm_eps, qkv_clip=qkv_clip, bqkv_all=bqkv_all,
              add_residual=add_residual, scale_qkv=scale_qkv, scale_o=scale_o)


def attn_block_l(x: torch.Tensor, norm_w: torch.Tensor, wqkv_all: torch.Tensor,
                 wo_all: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 layer: int, kv_pos: int, kv_len: int, kv_sink: int, pos: int, *,
                 n_heads: int, kv_sinks: int, theta, rotary_dim: int,
                 norm_eps: float, qkv_clip: float = math.inf,
                 bqkv_all: torch.Tensor | None = None, add_residual: bool = True,
                 scale_qkv: torch.Tensor | None = None,
                 scale_o: torch.Tensor | None = None) -> torch.Tensor:
    """Returns the updated residual stream (dim,) f32 (or only Wo @ mix when
    add_residual=False); k_all/v_all are updated IN PLACE at slot kv_pos."""
    if is_int4(wqkv_all):
        raise ValueError("attn_block_l: packed int4 weights go to attn_block4_l")
    return attn_block(x, norm_w, wqkv_all, wo_all, k_all, v_all, layer, kv_pos,
                      kv_len, kv_sink, pos, n_heads=n_heads, kv_sinks=kv_sinks,
                      theta=theta, rotary_dim=rotary_dim, norm_eps=norm_eps,
                      qkv_clip=qkv_clip, bqkv_all=bqkv_all,
                      add_residual=add_residual, scale_qkv=scale_qkv, scale_o=scale_o)


def attn_block4_l(x: torch.Tensor, norm_w: torch.Tensor, wqkv_all: torch.Tensor,
                  wo_all: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                  layer: int, kv_pos: int, kv_len: int, kv_sink: int, pos: int, *,
                  scale_qkv: torch.Tensor, scale_o: torch.Tensor,
                  n_heads: int, kv_sinks: int, theta, rotary_dim: int,
                  norm_eps: float, qkv_clip: float = math.inf,
                  bqkv_all: torch.Tensor | None = None,
                  add_residual: bool = True) -> torch.Tensor:
    """attn_block_l over packed int4 weights: wqkv_all (L, Nqkv, dim/2) and
    wo_all (L, dim, q_dim/2) uint8, with group scales scale_qkv (L,
    dim/group, Nqkv) and scale_o (L, q_dim/group, dim) f32."""
    if not is_int4(wqkv_all):
        raise ValueError(f"attn_block4_l: packed int4 (uint8) weights expected, "
                         f"got {wqkv_all.dtype}")
    return attn_block(x, norm_w, wqkv_all, wo_all, k_all, v_all, layer, kv_pos,
                      kv_len, kv_sink, pos, n_heads=n_heads, kv_sinks=kv_sinks,
                      theta=theta, rotary_dim=rotary_dim, norm_eps=norm_eps,
                      qkv_clip=qkv_clip, bqkv_all=bqkv_all,
                      add_residual=add_residual, scale_qkv=scale_qkv, scale_o=scale_o)
