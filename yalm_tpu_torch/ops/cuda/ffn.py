"""Dense FFN of one layer (port of `ffn_l` and its packed-int4 twin
`ffn4_l`, `yalm_tpu/ops/pallas/ffn.py`):

    x + W2[layer] @ bf16(act(h1) * h3),  [h1; h3] = W13[layer] @ rmsnorm(x)

The TPU runs this as ONE Pallas kernel with both weight streams inside; so
does the port on CUDA for 1 to FFN_ROWS (16) rows -- the decode step, the
batched tick, a pipeline stage -- `csrc/ffn.cu`'s `ffn_kernel`, one
cooperative launch whose co-resident blocks walk the rows' rmsnorm (a bf16
scratch row each), the w13 GEMV's K slices (GLU-pair epilogue into a bf16
scratch row per x row) and then the w2 GEMV's slices (scale, residual),
each w2 item streaming its weights before it waits for the GLU columns it
reads (per-row-block flags; the file comment has the design). `ffn_plan`
cuts the launch with the plans of the GEMV launches it fuses (`gemv_plan`
for each matrix), so up to 8 rows it gives their bits. More rows (the prefill chunks, the verify and tree
sweeps) take the GEMM route, csrc/gemm.cu five times: the row norm, then
for the w13 GEMM with the GLU-pair epilogue and the w2 GEMM with scale +
residual each the rounding of its X to bf16 and the wgmma gemm_kernel. The
route depends on the row count alone, so two paths that run the same rows
take the same one. Both routes round the same operands (ffn.py:47, :188),
so they agree to the f32 summation order. For int4 weights every launch
takes the kernels' int4 path, with the group scales of w1 and w3
concatenated along N ((L, G, 2H)).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core import gelu, silu
from ..int4 import int4_group
from . import _build as B
from .gemv import (GEMV_PART, SMS, GemvPlan, _split_buffers, bf16f, gemv_plan,
                   gemv_row_blocks, is_int4, launch_gemm, launch_rmsnorm_rows, proj_plain)


def ffn_plain(x, norm_w, w13_all, w2_all, layer, scale13=None, scale2=None, *,
              norm_eps, act, add_residual=True):
    """The JAX emulation branches (ffn.py:356-382, and :255-273 for int4
    weights with group scales)."""
    H = w13_all.shape[1] // 2
    x2 = x.reshape(-1, w2_all.shape[1]).float()
    ms = torch.mean(x2 * x2, dim=-1, keepdim=True)
    xb = x2 * torch.rsqrt(ms + norm_eps) * norm_w[layer].float()
    h13 = proj_plain(xb, w13_all, layer, scale13)
    h1, h3 = h13[:, :H], h13[:, H:]
    g = silu(h1) if act == "silu" else gelu(h1)
    out = proj_plain(bf16f(g * h3), w2_all, layer, scale2)
    if add_residual:
        out = x2 + out
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# csrc/ffn.cu's ffn_kernel: its plan
# ---------------------------------------------------------------------------

FFN_ROWS = 16          # rows the one launch takes (x's rows on one or two n8 mma tiles)
FFN_GRID = 2 * SMS     # co-resident blocks asked for: 2 per SM (__launch_bounds__(256, 2))
# the scratch regions, in their order: the normed rows of x (bf16), the w13
# slices' partials, the GLU rows (bf16), the w2 slices' partials
REGIONS = ("xn", "a_part", "glu", "b_part")


class FfnPlan(NamedTuple):
    """How ffn_kernel cuts one call of nb rows. Its phases' work items: N
    one per row of x (the norm), A the w13 GEMV's (row block, K slice)
    pairs of `w13` (item blk * split + z), B the w2 GEMV's pairs of `w2`
    (slice-major: item z * row blocks + blk); `nt`: x's rows on one n8 mma
    tile (nb <= 8) or two. `offsets`: where each of REGIONS starts in the
    f32 scratch (16-byte aligned), `floats` in all; `counters`: the int32
    arrival counters and flags (csrc/ffn.cu's yt_ffn: per w13 row block,
    then the flags per w13 row block, per w2 row block; the normed rows;
    one exit count), all 0 between calls; `grid`: the blocks asked for,
    two per SM even where a phase has fewer items (a block without an A
    item starts its first B item's weight stream at once)."""
    w13: GemvPlan
    w2: GemvPlan
    nt: int
    items: tuple
    offsets: tuple
    floats: int
    counters: int
    grid: int


def _quad(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=None)   # every layer of every step asks: a few shapes, host time
def ffn_plan(nb: int, K: int, H: int, itemsize: int = 1, int4: bool = False) -> FfnPlan:
    """The plan of one ffn launch on nb rows of width K (the model's dim)
    and hidden width H, on weights of `itemsize` bytes (packed int4:
    int4=True; w13's groups are int4_group(K), w2's int4_group(H)): the
    GEMV plans of the two-launch sequence at nb rows, w13 (K -> 2H, the GLU
    pairs) and w2 (H -> K), so that the one launch takes the same sums in
    the same order. Past 8 rows x's columns still stay under GEMV_XS_MAX of
    shared memory, so gemv_plan splits K more finely."""
    isz = 1 if int4 else itemsize
    a = gemv_plan(nb, 2 * H, K, True, int4_group(K) if int4 else 0, isz)
    b = gemv_plan(nb, K, H, False, int4_group(H) if int4 else 0, isz)
    nt = 1 if nb <= 8 else 2
    rows_a, rows_b = gemv_row_blocks(2 * H, True), gemv_row_blocks(K, False)
    items = (rows_a * a.split, rows_b * b.split)
    sizes = (-(-nb * K // 2), items[0] * nt * GEMV_PART if a.split > 1 else 0,
             -(-nb * H // 2), items[1] * nt * GEMV_PART if b.split > 1 else 0)
    offsets, at = [], 0
    for n in sizes:
        offsets.append(at)
        at += _quad(n)
    return FfnPlan(a, b, nt, items, tuple(offsets), at, 2 * rows_a + rows_b + 2, FFN_GRID)


def _f32(t, what, shape):
    if t is None:
        return None
    B.require(t.dtype == torch.float32 and t.is_contiguous() and tuple(t.shape) == shape,
              f"{what}: contiguous float32 {shape} expected, got {t.dtype} {tuple(t.shape)}")
    return t


def launch_ffn(name, x2, norm_w, w13_all, w2_all, layer, scale13=None, scale2=None, *,
               norm_eps, act, residual=None, stamps=None):
    """One launch of csrc/ffn.cu's ffn_kernel on CUDA tensors, cut by
    ffn_plan (adds one to LAUNCHES[name]): x2 (nb, K) f32, nb <= FFN_ROWS;
    returns (nb, K) f32, + residual (nb, K) if given. The scratch and
    counters are gemv.py's held per (device, stream). A launch the card
    refuses raises. stamps: None, or a (ffn_plan(...).grid, 4) int64 tensor
    that receives each block's phase bounds on the card's ns timer
    (ffn.cu's stamp())."""
    L, H2, Kw = w13_all.shape
    int4 = is_int4(w13_all)
    K, H = (2 * Kw if int4 else Kw), H2 // 2
    nb = x2.shape[0]
    B.require(w13_all.dtype in B.WTYPE and w2_all.dtype == w13_all.dtype
              and w13_all.is_contiguous() and w2_all.is_contiguous(),
              f"{name}: contiguous w13 and w2 of one weight type, got {w13_all.dtype} and "
              f"{w2_all.dtype}")
    B.require(tuple(w2_all.shape) == (L, K, H // 2 if int4 else H),
              f"{name}: w2 {tuple(w2_all.shape)} vs {L} layers, K {K}, H {H}")
    B.require(1 <= nb <= FFN_ROWS and 0 <= layer < L, f"{name}: {nb} rows, layer {layer}")
    if int4:
        B.require(K % 256 == 0 and H % 256 == 0, f"{name}: int4 weights need K, H % 256 == 0")
        B.require(scale13 is not None and scale2 is not None,
                  f"{name}: int4 weights need their group scales")
        _f32(scale13, f"{name} gs13", (L, K // int4_group(K), 2 * H))
        _f32(scale2, f"{name} gs2", (L, H // int4_group(H), K))
    else:
        isz = w13_all.element_size()
        B.require(K * isz % 16 == 0 and H * isz % 16 == 0,
                  f"{name}: K and H * itemsize must be multiples of 16 bytes")
        _f32(scale13, f"{name} scale13", (L, 2 * H))
        _f32(scale2, f"{name} scale2", (L, K))
    _f32(x2, f"{name} x", (nb, K))
    _f32(norm_w, f"{name} norm_w", (L, K))
    _f32(residual, f"{name} residual", (nb, K))
    B.require(B.aligned16(w13_all, w2_all, x2), f"{name}: weights and x must be 16-byte aligned")
    plan = ffn_plan(nb, K, H, 1 if int4 else w13_all.element_size(), int4)
    B.require(stamps is None or (stamps.dtype == torch.int64 and stamps.is_contiguous()
                                 and stamps.numel() >= 4 * plan.grid),
              f"{name}: stamps must be {plan.grid} x 4 int64")
    scratch, ctr = _split_buffers(x2.device, plan.floats, plan.counters)
    base = scratch.data_ptr()
    xn, a_part, glu, b_part = (ctypes.c_void_p(base + 4 * o) for o in plan.offsets)
    out = torch.empty((nb, K), dtype=torch.float32, device=x2.device)
    code = B.lib().yt_ffn(
        B.WTYPE[w13_all.dtype], B.ptr(w13_all), B.ptr(w2_all), B.ptr(x2), nb, B.ptr(norm_w),
        norm_eps, B.ptr(scale13), B.ptr(scale2), int4_group(K) if int4 else 0,
        int4_group(H) if int4 else 0, 1 if act == "gelu" else 0, B.ptr(residual), B.ptr(out),
        xn, a_part, glu, b_part, B.ptr(ctr), B.ptr(stamps), L, layer, K, H, plan.w13.kchunk,
        plan.w13.split, plan.w2.kchunk, plan.w2.split, plan.grid, B.stream_ptr())
    B.check(code, name)
    B.LAUNCHES[name] += 1
    return out


def launch_ffn_gemm(x2, norm_w, w13_all, w2_all, layer, scale13=None, scale2=None, *,
                    norm_eps, act, residual=None):
    """The GEMM route (five launches): the row norm, then the w13 GEMM with
    the GLU-pair epilogue and the w2 GEMM with scale + residual, each after
    the rounding of its X to bf16."""
    gemm_name = "gemm4_l" if is_int4(w13_all) else "gemm_l"
    xb = launch_rmsnorm_rows(x2, norm_w, layer, norm_eps)
    h = launch_gemm(gemm_name, xb, w13_all, layer, scale13, glu_act=act)
    return launch_gemm(gemm_name, h, w2_all, layer, scale2, residual=residual)


def ffn(x, norm_w, w13_all, w2_all, layer, scale13=None, scale2=None, *,
        norm_eps, act, add_residual=True):
    """ffn_l or ffn4_l, as the weight type says: per-row scales (L, N) for
    dense/int8 weights, group scales (L, G, N) for packed int4 (uint8) ones.
    Launches are counted under the JAX name of the twin that matches the
    weights, with "_gemm" for the many-row route."""
    L, H2, K = w13_all.shape
    int4 = is_int4(w13_all)
    name = "ffn4_l" if int4 else "ffn_l"
    if int4:
        K *= 2
    if (x.shape[-1] != K or w2_all.shape[1] != K or is_int4(w2_all) != int4
            or w2_all.shape[2] * (2 if int4 else 1) != H2 // 2):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w13 {tuple(w13_all.shape)}, "
                         f"w2 {tuple(w2_all.shape)} {w2_all.dtype}")
    if act not in ("silu", "gelu"):
        raise ValueError(f"{name}: unknown activation {act!r}")
    if B.device_kind(x, norm_w, w13_all, w2_all, scale13, scale2) == "cpu":
        return ffn_plain(x, norm_w, w13_all, w2_all, layer, scale13, scale2,
                         norm_eps=norm_eps, act=act, add_residual=add_residual)
    x2 = x.float().reshape(-1, K).contiguous()
    res = x2 if add_residual else None
    kw = dict(norm_eps=norm_eps, act=act, residual=res)
    if x2.shape[0] <= FFN_ROWS:
        out = launch_ffn(name, x2, norm_w, w13_all, w2_all, layer, scale13, scale2, **kw)
    else:
        out = launch_ffn_gemm(x2, norm_w, w13_all, w2_all, layer, scale13, scale2, **kw)
        B.LAUNCHES[name + "_gemm"] += 1
    return out.reshape(x.shape)


def ffn_l(x: torch.Tensor, norm_w: torch.Tensor, w13_all: torch.Tensor,
          w2_all: torch.Tensor, layer: int,
          scale13: torch.Tensor | None = None,
          scale2: torch.Tensor | None = None, *,
          norm_eps: float, act: str, add_residual: bool = True) -> torch.Tensor:
    """x: (dim,) or (B, dim) f32 residual stream(s), any B; returns the
    same shape."""
    if is_int4(w13_all):
        raise ValueError("ffn_l: packed int4 weights go to ffn4_l")
    return ffn(x, norm_w, w13_all, w2_all, layer, scale13, scale2,
               norm_eps=norm_eps, act=act, add_residual=add_residual)


def ffn4_l(x: torch.Tensor, norm_w: torch.Tensor, w13_all: torch.Tensor,
           w2_all: torch.Tensor, layer: int, gs13: torch.Tensor,
           gs2: torch.Tensor, *, norm_eps: float, act: str,
           add_residual: bool = True) -> torch.Tensor:
    """ffn_l over packed int4 weights: w13_all (L, 2H, dim/2) and w2_all
    (L, dim, H/2) uint8 with group scales gs13 (L, dim/group, 2H) and gs2
    (L, H/group, dim) f32. The GLU output is rounded to bf16 before w2."""
    if not is_int4(w13_all):
        raise ValueError(f"ffn4_l: packed int4 (uint8) weights expected, got {w13_all.dtype}")
    return ffn(x, norm_w, w13_all, w2_all, layer, gs13, gs2,
               norm_eps=norm_eps, act=act, add_residual=add_residual)
