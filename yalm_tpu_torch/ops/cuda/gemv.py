"""Dequant GEMV / GEMM over layer-stacked weights (port of
`yalm_tpu/ops/pallas/gemv.py`: gemv, gemv_l, gemm_l, gemm, the packed int4
gemm4_l, gemv4_l, gemm4, gemv4, and the MoE routed-expert gemv_le, gemm_le,
gemm4_le, gemv4_le over (L, E, N, K) expert stacks).

Kernels: `csrc/gemv.cu` (`gemv_kernel`: 128 weight rows a block on
mma.sync tensor cores, x's nb <= 8 rows as the mma's n; the weight stream
started before the fused rmsnorm prologue, K split where the grid would
starve (`gemv_plan`); scale/bias/clip/residual or GLU-pair epilogue; int4
weights with their group scales too) and `csrc/gemm.cu` (for the prefill
chunks and the batched tick: `gemm_kernel`, wgmma with the widened weights
in registers over a cp.async ring, X rounded to bf16 once by
`round_rows_kernel`, split K where the grid would starve (`gemm_plan`);
packed int4 on the same kernel, its nibbles widened in registers and each
group's f32 partial scaled, K split at group boundaries; a residual or
GLU-pair epilogue and a row-norm kernel for the many-row FFN). The
routed-expert functions launch the same kernels addressed at (layer,
expert); the expert is a host int or a one-element integer tensor on the
card, read there (the decode step's top-k ids never reach the host). Each
public function chooses by its tensors' device: on the CPU it runs the
plain version beside it, on CUDA it launches the kernel or raises.

Numerics contract (gemv.py:69-77): bf16 operands, f32 accumulation, the
dequant scale applied to the f32 result -- for int4 (`ops/int4.py`) the
group scale multiplies each group's f32 partial (gemv.py:583-596). fp16
weights never reach here: the loader turns them into bf16 on the host.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..core import gelu, silu
from ..int4 import int4_group
from . import _build as B


def bf16f(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and widen back to f32: the kernels' operand rounding."""
    return t.to(torch.bfloat16).to(torch.float32)


def is_int4(w: torch.Tensor) -> bool:
    """Packed int4 weights are uint8 with a halved last dimension; their
    scales are per group, (L, G, N), not per row."""
    return w.dtype == torch.uint8


# ---------------------------------------------------------------------------
# plain versions (the JAX emulation branches, gemv.py:172-182, :442-450 and
# _gemm4_ref :583-596)
# ---------------------------------------------------------------------------

def _bf16_weights(w: torch.Tensor) -> torch.Tensor:
    """f32 weights holding their bf16 values: e5m2, int8 and bf16 widen
    exactly (and a direct widening is several times faster on the CPU than
    through bf16); f32 weights are rounded."""
    if w.dtype in (torch.float8_e5m2, torch.int8, torch.bfloat16):
        return w.float()
    return bf16f(w)


PLAIN_ROWS = 1 << 16   # weight rows widened at a time (a 256k-row LM head: 4 blocks)


def gemm_l_plain(x, w_all, layer, scale=None):
    w = w_all[layer]
    xb = bf16f(x)
    out = torch.cat([xb @ _bf16_weights(w[i:i + PLAIN_ROWS]).T
                     for i in range(0, w.shape[0], PLAIN_ROWS)], dim=-1)
    if scale is not None:
        out = out * scale[layer].float()[None]
    return out


def int4_values(p, group: int) -> torch.Tensor:
    """Packed int4 weights p (N, K/2) as f32 values (N, G, group): each
    group's low nibbles then its high nibbles, less 8."""
    N = p.shape[0]
    p = p.reshape(N, -1, group // 2)
    q = torch.empty((N, p.shape[1], group), dtype=torch.float32, device=p.device)
    q[..., : group // 2] = p & 0xF
    q[..., group // 2:] = p >> 4
    q -= 8.0
    return q


def gemm4_l_plain(x, w4_all, layer, gscale):
    """x (B, K) against packed int4 W4_all[layer] (N, K/2) with group scales
    gscale[layer] (G, N): per-group bf16 x bf16 products summed in f32, the
    group scale on each group's f32 partial, the groups added in order."""
    Bn, K = x.shape
    group = int4_group(K)
    G = K // group
    q = int4_values(w4_all[layer], group)
    xg = bf16f(x).reshape(Bn, G, group)
    s = gscale[layer].float()
    out = torch.zeros((Bn, q.shape[0]), dtype=torch.float32, device=x.device)
    for g in range(G):
        out += (xg[:, g] @ q[:, g].T) * s[g]
    return out


def proj_plain(x, w_all, layer, scale=None):
    """x (B, K) @ dequant(W_all[layer])^T: per-row scales (L, N) or, for
    packed int4 weights, group scales (L, G, N)."""
    if is_int4(w_all):
        return gemm4_l_plain(x, w_all, layer, scale)
    return gemm_l_plain(x, w_all, layer, scale)


def gemv_l_plain(x, w_all, layer, *, norm_w=None, norm_eps=1e-5,
                 residual=None, scale=None):
    xv = x.float()
    if norm_w is not None:
        ms = torch.mean(xv * xv)
        xv = xv * torch.rsqrt(ms + norm_eps) * norm_w[layer].float()
    out = proj_plain(xv[None], w_all, layer, scale)[0]
    return out + residual if residual is not None else out


def glu_plain(h13, act: str):
    """The GLU-pair epilogue: bf16(act(h1) * h3) of [h1, h3] along the last
    axis (the next projection rounds its input to bf16 all the same)."""
    H = h13.shape[-1] // 2
    h1 = h13[..., :H]
    return bf16f((silu(h1) if act == "silu" else gelu(h1)) * h13[..., H:])


def _expert(w_all, scale, layer, expert):
    """W_all[layer, expert] and its scales as a one-layer stack (the JAX
    emulation branches index the same slice: gemv.py:278-280, :356-363,
    :702-705)."""
    return w_all[layer][expert][None], None if scale is None else scale[layer][expert][None]


def gemm_le_plain(x, w_all, layer, expert, scale=None, *, glu_act=None):
    """x (B, K) @ dequant(W_all[layer, expert])^T, per-row scales (L, E, N)
    or, for packed int4 experts, group scales (L, E, G, N)."""
    w, s = _expert(w_all, scale, layer, expert)
    y = proj_plain(x, w, 0, s)
    return glu_plain(y, glu_act) if glu_act else y


def gemv_le_plain(x, w_all, layer, expert, scale=None, *, norm_w=None, norm_eps=1e-5,
                  glu_act=None):
    w, s = _expert(w_all, scale, layer, expert)
    y = gemv_l_plain(x, w, 0, norm_w=None if norm_w is None else norm_w[layer][None],
                     norm_eps=norm_eps, scale=s)
    return glu_plain(y, glu_act) if glu_act else y


# ---------------------------------------------------------------------------
# csrc/gemm.cu's gemm_kernel: its plan and its arithmetic, in Python
# ---------------------------------------------------------------------------

GEMM_ROWS = 128                       # weight rows per block: two warpgroups of 64
GEMM_KT = 64                          # K per ring stage
GEMM_MT = (16, 32, 64, 128, 256)      # tokens per block: wgmma's N (int4: up to 128)
SMS = 132                             # streaming multiprocessors of an H100 SXM
MAX_SPLIT = 16                        # K slices a launch takes at most


class GemmPlan(NamedTuple):
    """How gemm_kernel cuts a launch: mt tokens per block; K in slices of
    kchunk ring stages (the last may be shorter), `split` of them."""
    mt: int
    kchunk: int
    split: int


def gemm_row_tiles(N: int, glu: bool) -> int:
    """Blocks along the weight rows: 128 rows, or 64 GLU pairs (128 rows of
    W13, `glu_rows`)."""
    return -(-N // 2 // (GEMM_ROWS // 2)) if glu else -(-N // GEMM_ROWS)


def gemm4_stage_bytes(mt: int) -> int:
    """Packed bytes of each int4 weight row a ring stage holds (2x as many K):
    128 up to 32 tokens, else 64 (csrc/gemm.cu's i4_stage_bytes)."""
    return 2 * GEMM_KT if mt <= 32 else GEMM_KT


def gemm_plan(M: int, N: int, K: int, glu: bool = False, group: int = 0) -> GemmPlan:
    """The plan of an (M, K) x (N, K)^T launch: the smallest token tile that
    holds M (256 past it, or 128 where 256-token tiles leave the card's
    SMs short of blocks); K split only where one slice gives fewer blocks
    than the card has SMs, into enough slices to fill them (at most
    MAX_SPLIT, at least one stage each). The slices cover the ring stages
    (ceil(K / 64)) exactly once. Packed int4 weights (`group`: their group
    width): at most 128 tokens (the kernel's two accumulators), stages of
    2 * gemm4_stage_bytes(mt) K, slices of whole groups, and a starved grid
    split for two blocks per SM (its short stages are latency-bound; see
    PERF.md §6)."""
    tiles = GEMM_MT[:-1] if group else GEMM_MT
    mt = next((m for m in tiles if m >= M), tiles[-1])
    rows = gemm_row_tiles(N, glu)
    if mt == GEMM_MT[-1] and rows * -(-M // mt) < SMS:
        mt = GEMM_MT[-2]   # narrow N: more token tiles before K is split
    blocks = rows * -(-M // mt)
    unit = group // (2 * gemm4_stage_bytes(mt)) if group else 1   # stages a slice is made of
    units = K // group if group else -(-K // GEMM_KT)
    fill = 2 * SMS if group else SMS
    split = 1 if blocks >= SMS else min(units, MAX_SPLIT, -(-fill // blocks))
    chunk = -(-units // split)
    return GemmPlan(mt, chunk * unit, -(-units // chunk))


def gemm4_stage_cols(kt: int, group: int, mt: int) -> list[int]:
    """The X columns of int4 stage kt in the kernel's virtual order
    (csrc/gemm.cu's load_stage), P = gemm4_stage_bytes(mt): the stage holds
    packed bytes P*kt..P*kt+P-1 of each weight row, byte offset b0 of group
    g; its columns are the low nibbles' g*group + b0 + j, then the high
    nibbles' g*group + group/2 + b0 + j, j = 0..P-1."""
    P = gemm4_stage_bytes(mt)
    spg = group // (2 * P)
    c0 = kt // spg * group + kt % spg * P
    return [c0 + h * (group // 2) + j for h in (0, 1) for j in range(P)]


def glu_rows(p0: int, H: int) -> list[int]:
    """The W13 row each of a GLU block's 128 rows holds, -1 past the pairs
    (csrc/gemm.cu's `wrow`): in warp w's 16-row slab, rows 0-7 hold h1 of
    pairs p0+8w..p0+8w+7 and rows 8-15 their h3 (row H + p), so a thread's
    accumulator rows g and g+8 are one pair's two halves."""
    rows = []
    for r in range(GEMM_ROWS):
        j = r % 16
        p = p0 + 8 * (r // 16) + j % 8
        rows.append(-1 if p >= H else (p if j < 8 else H + p))
    return rows


def gemm_split_plain(x, w_all, layer, scale=None, *, expert=None, residual=None, glu_act=None):
    """gemm_kernel's arithmetic, plainly: bf16 operands, each K slice of
    gemm_plan summed in f32, the slices' partials added in slice order, then
    the scale, the residual or the GLU pair on the full sum."""
    w = w_all[layer] if expert is None else w_all[layer][expert]
    s = None if scale is None else (scale[layer] if expert is None else scale[layer][expert])
    M, K = x.shape
    plan = gemm_plan(M, w.shape[0], K, glu_act is not None)
    xb, wb = bf16f(x), _bf16_weights(w)
    step = plan.kchunk * GEMM_KT
    out = None
    for k0 in range(0, K, step):
        part = xb[:, k0:k0 + step] @ wb[:, k0:k0 + step].T
        out = part if out is None else out + part
    if s is not None:
        out = out * s.float()[None]
    if glu_act:
        return glu_plain(out, glu_act)
    return out if residual is None else out + residual


def gemm4_split_plain(x, w4_all, layer, gscale, *, expert=None, residual=None, glu_act=None):
    """gemm_kernel's arithmetic on packed int4 weights, plainly: bf16
    operands; each group's products summed in f32 and its scale on that
    partial, the groups of a slice of gemm_plan added in order, the slices'
    partials added in slice order, then the residual or the GLU pair."""
    w = w4_all[layer] if expert is None else w4_all[layer][expert]
    s = (gscale[layer] if expert is None else gscale[layer][expert]).float()
    M, K = x.shape
    N, group = w.shape[0], int4_group(K)
    plan = gemm_plan(M, N, K, glu_act is not None, group)
    p = w.reshape(N, K // group, group // 2)
    q = torch.cat([p & 0xF, p >> 4], dim=-1).float() - 8.0      # (N, G, group)
    xg = bf16f(x).reshape(M, K // group, group)
    per = plan.kchunk * 2 * gemm4_stage_bytes(plan.mt) // group   # groups per slice
    out = None
    for g0 in range(0, K // group, per):
        part = torch.zeros((M, N), dtype=torch.float32, device=x.device)
        for g in range(g0, min(g0 + per, K // group)):
            part = part + (xg[:, g] @ q[:, g].T) * s[g]
        out = part if out is None else out + part
    if glu_act:
        return glu_plain(out, glu_act)
    return out if residual is None else out + residual


# ---------------------------------------------------------------------------
# csrc/gemv.cu's gemv_kernel: its plan, its fragment map and its arithmetic
# ---------------------------------------------------------------------------

GEMV_ROWS = 128              # weight rows per block: 8 warps' mma tiles of 16 (GLU: 64 pairs)
GEMV_WIN = 128               # bytes of each weight row per iteration
GEMV_FILL = 2                # blocks per SM a split grid aims at
GEMV_XS_MAX = 64 * 1024      # bytes of x a block stages (its slice's columns, bf16)
GEMV_PART = 4 * 256          # floats of one slice's partials (4 per thread)


class GemvPlan(NamedTuple):
    """How gemv_kernel cuts K (its blocks always hold GEMV_ROWS rows): in
    slices of kchunk iterations (128 bytes of each weight row; the last may
    be shorter), `split` of them."""
    kchunk: int
    split: int


def gemv_cols(itemsize: int, group: int = 0) -> int:
    """K columns of one iteration: 128 bytes of a weight row (packed int4,
    `group` > 0: 256 columns)."""
    return 2 * GEMV_WIN if group else GEMV_WIN // itemsize


def gemv_row_blocks(N: int, glu: bool) -> int:
    """Blocks along the weight rows: 128 rows, or 64 GLU pairs."""
    return -(-N // 2 // (GEMV_ROWS // 2)) if glu else -(-N // GEMV_ROWS)


@functools.lru_cache(maxsize=None)   # every decode launch asks: a few shapes, host time
def gemv_plan(nb: int, N: int, K: int, glu: bool = False, group: int = 0,
              itemsize: int = 1) -> GemvPlan:
    """The plan of an (nb, K) x (N, K)^T GEMV on weights of `itemsize` bytes
    (packed int4: `group`, their group width). K is split only where the
    row blocks are fewer than the card's SMs (N 4096-6144 at 128 rows a
    block: 32-48), into as many slices as fill GEMV_FILL blocks per SM (at
    most MAX_SPLIT, each at least one iteration; int4: whole groups), or
    where nb rows of a slice's columns would pass GEMV_XS_MAX of shared
    memory. The slices cover the iterations (ceil(K * itemsize / 128))
    exactly once."""
    rows = gemv_row_blocks(N, glu)
    unit = group // (2 * GEMV_WIN) if group else 1   # iterations a slice is made of
    units = K // group if group else -(-K * itemsize // GEMV_WIN)
    split = 1 if rows >= SMS else min(units, MAX_SPLIT, max(1, GEMV_FILL * SMS // rows))
    widest = max(1, GEMV_XS_MAX // (2 * nb * unit * gemv_cols(itemsize, group)))
    chunk = min(-(-units // split), widest)
    return GemvPlan(chunk * unit, -(-units // chunk))


def gemv_step_cols(t: int, h: int, itemsize: int = 1, group: int = 0, gb: int = 0) -> list:
    """The K columns thread t (lane % 4) of a warp multiplies in each mma
    step of its load h (bytes 64h + 16t.. of an iteration's 128 of each of
    its rows): per step, a0's two columns and a2's two (a1, a3: the same
    columns of the tile's row g + 8); its B registers b0, b1 hold x at the
    same columns. Relative to the iteration's first column; for packed
    int4 (`group` > 0) to its group's, gb the iteration's byte offset in
    the group (csrc/gemv.cu's file comment)."""
    if group:
        c, half = gb + 64 * h + 16 * t, group // 2
        return [((c + 2 * s, c + 2 * s + 1), (c + 2 * s + half, c + 2 * s + 1 + half))
                for s in range(8)]
    c = (64 * h + 16 * t) // itemsize
    return [((c + 4 * s, c + 4 * s + 1), (c + 4 * s + 2, c + 4 * s + 3))
            for s in range(16 // itemsize // 4)]


def gemv_split_plain(x, w_all, layer, scale=None, *, expert=None, norm_w=None, norm_eps=1e-5,
                     bias=None, clip=math.inf, residual=None, glu_act=None):
    """gemv_kernel's arithmetic, plainly: x (nb, K); the rmsnorm prologue
    (sums of squares over all of K) and bf16 operands; each K slice of
    gemv_plan summed in f32 (packed int4: each group's partial times its
    scale, the groups of a slice in order), the slices added in slice
    order; then the scale, bias, clip, residual or the GLU pair (+
    residual) on the full sum. `scale`: per row (L, [E,] N), or the group
    scales (L, [E,] G, N) of packed int4 weights."""
    w = w_all[layer] if expert is None else w_all[layer][expert]
    s = None if scale is None else (scale[layer] if expert is None else scale[layer][expert])
    xv = x.float()
    if norm_w is not None:
        xv = xv * torch.rsqrt(torch.mean(xv * xv, dim=-1, keepdim=True) + norm_eps)
        xv = xv * norm_w[layer].float()
    xb = bf16f(xv)
    nb, K = xb.shape
    N = w.shape[0]
    int4 = is_int4(w_all)
    group = int4_group(K) if int4 else 0
    plan = gemv_plan(nb, N, K, glu_act is not None, group, 1 if int4 else w.element_size())
    step = plan.kchunk * gemv_cols(w.element_size(), group)
    if int4:
        G = K // group
        p = w.reshape(N, G, group // 2)
        q = torch.cat([p & 0xF, p >> 4], dim=-1).float() - 8.0      # (N, G, group)
        sf = s.float()
    else:
        wb = _bf16_weights(w)
    out = None
    for k0 in range(0, K, step):
        if int4:
            part = torch.zeros((nb, N), dtype=torch.float32, device=x.device)
            for g in range(k0 // group, min(K, k0 + step) // group):
                part = part + (xb[:, g * group:(g + 1) * group] @ q[:, g].T) * sf[g]
        else:
            part = xb[:, k0:k0 + step] @ wb[:, k0:k0 + step].T
        out = part if out is None else out + part
    if not int4 and s is not None:
        out = out * s.float()[None]
    if glu_act:
        out = glu_plain(out, glu_act)
    else:
        if bias is not None:
            out = out + bias[layer].float()[None]
        if math.isfinite(clip):
            out = torch.clamp(out, -clip, clip)
    return out if residual is None else out + residual


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------

def _check_weights(w_all: torch.Tensor, K: int, what: str) -> None:
    B.require(w_all.dtype in B.WTYPE, f"{what}: no kernel for {w_all.dtype} weights")
    B.require(w_all.is_contiguous(), f"{what}: weights must be contiguous")
    if is_int4(w_all):
        B.require(K % 256 == 0, f"{what}: int4 weights need K % 256 == 0 (K={K})")
    else:
        B.require(K * w_all.element_size() % 16 == 0,
                  f"{what}: K * itemsize must be a multiple of 16 bytes (K={K})")


def _f32(t, what):
    if t is None:
        return None
    B.require(t.dtype == torch.float32 and t.is_contiguous(),
              f"{what}: contiguous float32 expected, got {t.dtype}")
    return t


def _gscale(w_all, gscale, K: int, what: str):
    """The int4 group scales' check: ([L, E,] K // group, N) f32."""
    shape = tuple(w_all.shape[:-2]) + (K // int4_group(K), w_all.shape[-2])
    B.require(gscale is not None, f"{what}: int4 weights need their group scales")
    _f32(gscale, f"{what} gscale")
    B.require(tuple(gscale.shape) == shape,
              f"{what}: gscale shape {tuple(gscale.shape)} != {shape}")
    return gscale


def _addressing(w_all, layer: int, expert, what: str):
    """(L, N, Kw, E, host expert, device expert id or None) of a launch on a
    layer stack (L, N, Kw) (expert None: E = 1) or an expert stack (L, E,
    N, Kw). A host expert is checked here; a device id is read by the
    kernel, which gives NaN for one outside [0, E)."""
    # (no message here formats `expert`: a device id's repr copies it to the host)
    B.require(w_all.dim() == (3 if expert is None else 4),
              f"{what}: weights {tuple(w_all.shape)} with{'out' if expert is None else ''} "
              "an expert id")
    L, N, Kw = w_all.shape[0], w_all.shape[-2], w_all.shape[-1]
    B.require(0 <= layer < L, f"{what}: layer {layer} out of range")
    if expert is None:
        return L, N, Kw, 1, 0, None
    E = w_all.shape[1]
    if isinstance(expert, torch.Tensor):
        B.require(expert.numel() == 1 and not expert.is_floating_point()
                  and expert.device == w_all.device,
                  f"{what}: the expert id must be one integer on {w_all.device}")
        return L, N, Kw, E, 0, expert.reshape(()).to(torch.int64)
    B.require(0 <= int(expert) < E, f"{what}: expert {expert} out of range (E={E})")
    return L, N, Kw, E, int(expert), None


def launch_gemv(count: str, x, w_all, layer: int, *, expert=None, norm_w=None,
                norm_eps: float = 1e-5, scale=None, bias=None,
                clip: float = math.inf, residual=None, glu_act: str | None = None):
    """One launch of csrc/gemv.cu's gemv_kernel on CUDA tensors, cut by
    gemv_plan (adds one to LAUNCHES[count]). x: (K,) or (nb, K); returns
    float32 of shape
    (..., N) or, for the GLU pair, (..., N // 2) holding bf16 values.
    `scale` is per row (L, [E,] N), or for packed int4 weights (uint8,
    (L, [E,] N, K/2)) the group scales (L, [E,] G, N). With `expert` the
    weights are an expert stack (L, E, N, K) (a host int, or a one-element
    integer tensor on the card)."""
    L, N, Kw, E, e_host, e_dev = _addressing(w_all, layer, expert, count)
    int4 = is_int4(w_all)
    K = 2 * Kw if int4 else Kw
    _check_weights(w_all, K, count)
    x2 = _f32(x.reshape(-1, K), count)
    nb = x2.shape[0]
    B.require(1 <= nb <= 8, f"{count}: 1..8 rows of x, got {nb}")
    B.require(nb * K * 2 <= 227 * 1024, f"{count}: {nb} rows of K={K} exceed shared memory")
    B.require(bias is None or expert is None, f"{count}: no bias on an expert stack")
    n_out = N // 2 if glu_act else N
    gscale = _gscale(w_all, scale, K, count) if int4 else None
    if int4:
        scale = None
    for t, shape, nm in ((norm_w, (L, K), "norm_w"), (scale, tuple(w_all.shape[:-1]), "scale"),
                         (bias, (L, N), "bias")):
        if t is not None:
            _f32(t, f"{count} {nm}")
            B.require(tuple(t.shape) == shape, f"{count}: {nm} shape {tuple(t.shape)} != {shape}")
    if residual is not None:
        residual = _f32(residual.reshape(nb, n_out), f"{count} residual")
    B.require(B.aligned16(w_all, x2), f"{count}: weights and x must be 16-byte aligned")
    out = torch.empty((nb, n_out), dtype=torch.float32, device=x.device)
    group = int4_group(K) if int4 else 0
    plan = gemv_plan(nb, N, K, bool(glu_act), group, 1 if int4 else w_all.element_size())
    scratch = ctr = None
    if plan.split > 1:
        blocks = gemv_row_blocks(N, bool(glu_act))
        scratch, ctr = _split_buffers(x.device, blocks * plan.split * GEMV_PART, blocks)
    code = B.lib().yt_gemv(
        B.WTYPE[w_all.dtype], B.ptr(w_all), layer, E, e_host, B.ptr(e_dev), N, K,
        B.ptr(x2), nb, B.ptr(norm_w), norm_eps, B.ptr(scale), B.ptr(gscale), group,
        B.ptr(bias), clip if math.isfinite(clip) else 0.0, B.ptr(residual), B.ptr(out),
        1 if glu_act else 0, 1 if glu_act == "gelu" else 0, plan.kchunk, B.ptr(scratch),
        B.ptr(ctr), B.stream_ptr())
    B.check(code, count)
    B.LAUNCHES[count] += 1
    return out.reshape(*x.shape[:-1], n_out)


_SPLIT_BUFFERS: dict = {}


def _split_buffers(device: torch.device, floats: int, tiles: int):
    """The split-K scratch (f32) and per-tile arrival counters (int32
    zeros; the kernel's last slice leaves each at 0 again) of gemm_kernel
    and gemv_kernel, one pair per (device, stream), grown as needed and
    held across calls."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    scratch, ctr = _SPLIT_BUFFERS.get(key, (None, None))
    if scratch is None or scratch.numel() < floats:
        scratch = torch.empty(floats, dtype=torch.float32, device=device)
    if ctr is None or ctr.numel() < tiles:
        ctr = torch.zeros(max(tiles, 256), dtype=torch.int32, device=device)
    _SPLIT_BUFFERS[key] = (scratch, ctr)
    return scratch, ctr


def launch_round_rows(x):
    """One launch of csrc/gemm.cu's round_rows_kernel (adds one to
    LAUNCHES["round_rows_bf16"]): contiguous f32 -> bf16 of the same shape,
    rounded to nearest even (bf16f's bits)."""
    x = _f32(x, "round_rows_bf16 x")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    B.require(x.numel() % 4 == 0 and B.aligned16(x), "round_rows_bf16: n % 4 == 0, 16-byte aligned")
    B.check(B.lib().yt_round_rows_bf16(B.ptr(x), x.numel(), B.ptr(out), B.stream_ptr()),
            "round_rows_bf16")
    B.LAUNCHES["round_rows_bf16"] += 1
    return out


def launch_gemm(count: str, x, w_all, layer: int, scale=None, *, expert=None, residual=None,
                glu_act: str | None = None):
    """One launch of csrc/gemm.cu's gemm_kernel, after round_rows_kernel,
    on CUDA tensors (adds one to LAUNCHES[count]). x: (M, K) f32; returns
    (M, N) f32, + residual (M, N) if given, or for the GLU pair (M, N // 2)
    holding bf16 values. `scale` is per row (L, [E,] N), or the group
    scales (L, [E,] G, N) of packed int4 weights; `expert` as
    launch_gemv's."""
    L, N, Kw, E, e_host, e_dev = _addressing(w_all, layer, expert, count)
    int4 = is_int4(w_all)
    K = 2 * Kw if int4 else Kw
    _check_weights(w_all, K, count)
    B.require(int4 or K % 32 == 0, f"{count}: K must be a multiple of 32 (K={K})")
    x = _f32(x, f"{count} x")
    B.require(x.dim() == 2 and x.shape[1] == K, f"{count}: x {tuple(x.shape)} vs K={K}")
    M = x.shape[0]
    n_out = N // 2 if glu_act else N
    if int4:
        _gscale(w_all, scale, K, count)
    elif scale is not None:
        _f32(scale, f"{count} scale")
        B.require(tuple(scale.shape) == tuple(w_all.shape[:-1]),
                  f"{count}: scale must be {tuple(w_all.shape[:-1])}")
    B.require(not (glu_act and residual is not None), f"{count}: GLU output takes no residual")
    if residual is not None:
        residual = _f32(residual, f"{count} residual")
        B.require(tuple(residual.shape) == (M, N), f"{count}: residual must be (M, N)")
    B.require(B.aligned16(w_all, x), f"{count}: weights and x must be 16-byte aligned")
    y = torch.empty((M, n_out), dtype=torch.float32, device=x.device)
    glu, act = (1, 1 if glu_act == "gelu" else 0) if glu_act else (0, 0)
    xb = launch_round_rows(x)
    group = int4_group(K) if int4 else 0
    plan = gemm_plan(M, N, K, bool(glu_act), group)
    scratch = ctr = None
    if plan.split > 1:
        tiles = gemm_row_tiles(N, bool(glu_act)) * -(-M // plan.mt)
        scratch, ctr = _split_buffers(x.device, tiles * plan.split * GEMM_ROWS * plan.mt, tiles)
    if int4:
        code = B.lib().yt_gemm4(B.ptr(w_all), layer, E, e_host, B.ptr(e_dev), N, K, group,
                                B.ptr(xb), M, B.ptr(scale), B.ptr(residual), B.ptr(y), glu, act,
                                plan.mt, plan.kchunk, B.ptr(scratch), B.ptr(ctr), B.stream_ptr())
    else:
        code = B.lib().yt_gemm(B.WTYPE[w_all.dtype], B.ptr(w_all), layer, E, e_host,
                               B.ptr(e_dev), N, K, B.ptr(xb), M, B.ptr(scale),
                               B.ptr(residual), B.ptr(y), glu, act, plan.mt, plan.kchunk,
                               B.ptr(scratch), B.ptr(ctr), B.stream_ptr())
    B.check(code, count)
    B.LAUNCHES[count] += 1
    return y


def launch_rmsnorm_rows(x, norm_w, layer: int, eps: float):
    """One launch of csrc/gemm.cu's rmsnorm_rows_kernel (adds one to
    LAUNCHES["rmsnorm_rows"]): x (M, K) f32 -> (M, K) f32 holding the
    bf16-rounded normalised rows against norm_w[layer]."""
    x = _f32(x, "rmsnorm_rows x")
    M, K = x.shape
    nw = _f32(norm_w[layer], "rmsnorm_rows norm_w")
    B.require(nw.shape == (K,), f"rmsnorm_rows: norm_w row {tuple(nw.shape)} vs K={K}")
    out = torch.empty_like(x)
    B.check(B.lib().yt_rmsnorm_rows(B.ptr(x), M, K, B.ptr(nw), eps, B.ptr(out),
                                    B.stream_ptr()), "rmsnorm_rows")
    B.LAUNCHES["rmsnorm_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# public functions (signatures of the JAX package's)
# ---------------------------------------------------------------------------

def gemv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """y[N] = (W[N, K] @ x[K]) [* scale[N]], f32 out (the LM head)."""
    N, K = w.shape
    if tuple(x.shape) != (K,):
        raise ValueError(f"gemv: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    sc = scale[None] if scale is not None else None
    if B.device_kind(x, w, scale) == "cpu":
        return gemv_l_plain(x, w[None], 0, scale=sc)
    return launch_gemv("gemv", x, w[None], 0, scale=sc)


def gemv_l(x: torch.Tensor, w_all: torch.Tensor, layer: int, *,
           norm_w: torch.Tensor | None = None, norm_eps: float = 1e-5,
           residual: torch.Tensor | None = None,
           scale: torch.Tensor | None = None) -> torch.Tensor:
    """y[N] = W_all[layer] @ maybe_rmsnorm(x) [* scale[layer]] (+ residual)."""
    L, N, K = w_all.shape
    if tuple(x.shape) != (K,) or is_int4(w_all):
        raise ValueError(f"gemv_l: x {tuple(x.shape)} vs w_all {tuple(w_all.shape)} "
                         f"{w_all.dtype} (packed int4 goes to gemv4_l)")
    if B.device_kind(x, w_all, norm_w, residual, scale) == "cpu":
        return gemv_l_plain(x, w_all, layer, norm_w=norm_w, norm_eps=norm_eps,
                            residual=residual, scale=scale)
    return launch_gemv("gemv_l", x, w_all, layer, norm_w=norm_w,
                       norm_eps=norm_eps, scale=scale, residual=residual)


def gemm_l(x: torch.Tensor, w_all: torch.Tensor, layer: int,
           scale: torch.Tensor | None = None) -> torch.Tensor:
    """y[B, N] = x[B, K] @ W_all[layer]^T [* scale[layer]]."""
    if x.dim() != 2 or x.shape[1] != w_all.shape[2] or is_int4(w_all):
        raise ValueError(f"gemm_l: x {tuple(x.shape)} vs w_all {tuple(w_all.shape)} "
                         f"{w_all.dtype} (packed int4 goes to gemm4_l)")
    if B.device_kind(x, w_all, scale) == "cpu":
        return gemm_l_plain(x, w_all, layer, scale)
    return launch_gemm("gemm_l", x, w_all, layer, scale)


def gemm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """y[B, N] = x[B, K] @ W[N, K]^T [* scale] (2-D weights, e.g. the LM head)."""
    return gemm_l(x, w[None], 0, scale[None] if scale is not None else None)


def gemm4_l(x: torch.Tensor, w4_all: torch.Tensor, layer: int,
            gscale: torch.Tensor) -> torch.Tensor:
    """y[B, N] = x[B, K] @ dequant4(W4_all[layer])^T over packed int4
    weights (L, N, K/2) uint8 with group scales (L, G, N), any B."""
    if (x.dim() != 2 or not is_int4(w4_all) or x.shape[1] != 2 * w4_all.shape[2]
            or x.shape[1] % 256):
        raise ValueError(f"gemm4_l: x {tuple(x.shape)} vs packed w4_all "
                         f"{tuple(w4_all.shape)} {w4_all.dtype} (K % 256 == 0)")
    if B.device_kind(x, w4_all, gscale) == "cpu":
        return gemm4_l_plain(x, w4_all, layer, gscale)
    return launch_gemm("gemm4_l", x, w4_all, layer, gscale)


def gemv4_l(x: torch.Tensor, w4_all: torch.Tensor, layer: int,
            gscale: torch.Tensor) -> torch.Tensor:
    """Single-token int4 GEMV (x (K,) -> y (N,)), on csrc/gemv.cu."""
    K = 2 * w4_all.shape[2]
    if tuple(x.shape) != (K,) or not is_int4(w4_all) or K % 256:
        raise ValueError(f"gemv4_l: x {tuple(x.shape)} vs packed w4_all "
                         f"{tuple(w4_all.shape)} {w4_all.dtype} (K % 256 == 0)")
    if B.device_kind(x, w4_all, gscale) == "cpu":
        return gemm4_l_plain(x[None], w4_all, layer, gscale)[0]
    return launch_gemv("gemv4_l", x, w4_all, layer, scale=gscale)


def gemm4(x: torch.Tensor, w4: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """2-D packed weights (N, K/2), scales (G, N)."""
    return gemm4_l(x, w4[None], 0, gscale[None])


def gemv4(x: torch.Tensor, w4: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    return gemv4_l(x, w4[None], 0, gscale[None])


# ---------------------------------------------------------------------------
# the MoE routed-expert functions (gemv.py:265 gemv_le, :344 gemm_le, :688
# gemm4_le, :768 gemv4_le): W_all (L, E, N, K[/2]), scales (L, E, N) per
# row or (L, E, G, N) per int4 group; only the routed expert's bytes are
# read. `expert`: a host int, or a one-element integer tensor on the
# weights' device. The keywords beyond the JAX signatures are the
# kernels' prologue and epilogue: the rmsnorm against norm_w[layer] (L, K)
# and the GLU pair (-> (..., N // 2) holding bf16 values).
# ---------------------------------------------------------------------------

def _routed(name: str, x, w_all, expert, int4: bool, rows: int):
    """Check an x of `rows` dims against an expert stack of the right kind;
    the device kind of the call."""
    K = w_all.shape[-1] * (2 if int4 else 1) if w_all.dim() == 4 else -1
    if (w_all.dim() != 4 or is_int4(w_all) != int4 or x.dim() != rows
            or x.shape[-1] != K or (int4 and K % 256)):
        raise ValueError(f"{name}: x {tuple(x.shape)} vs expert stack {tuple(w_all.shape)} "
                         f"{w_all.dtype}" + (" (packed int4, K % 256 == 0)" if int4 else ""))
    return expert if isinstance(expert, torch.Tensor) else None


def gemv_le(x: torch.Tensor, w_all: torch.Tensor, layer: int, expert,
            scale: torch.Tensor | None = None, *, norm_w: torch.Tensor | None = None,
            norm_eps: float = 1e-5, glu_act: str | None = None) -> torch.Tensor:
    """y[N] = W_all[layer, expert] @ maybe_rmsnorm(x) [* scale[layer, expert]]."""
    e = _routed("gemv_le", x, w_all, expert, False, 1)
    if B.device_kind(x, w_all, scale, norm_w, e) == "cpu":
        return gemv_le_plain(x, w_all, layer, expert, scale, norm_w=norm_w, norm_eps=norm_eps,
                             glu_act=glu_act)
    return launch_gemv("gemv_le", x, w_all, layer, expert=expert, norm_w=norm_w,
                       norm_eps=norm_eps, scale=scale, glu_act=glu_act)


def gemm_le(x: torch.Tensor, w_all: torch.Tensor, layer: int, expert,
            scale: torch.Tensor | None = None, *, glu_act: str | None = None) -> torch.Tensor:
    """y[B, N] = x[B, K] @ W_all[layer, expert]^T [* scale[layer, expert]]."""
    e = _routed("gemm_le", x, w_all, expert, False, 2)
    if B.device_kind(x, w_all, scale, e) == "cpu":
        return gemm_le_plain(x, w_all, layer, expert, scale, glu_act=glu_act)
    return launch_gemm("gemm_le", x.contiguous(), w_all, layer, scale, expert=expert,
                       glu_act=glu_act)


def gemm4_le(x: torch.Tensor, w4_all: torch.Tensor, layer: int, expert,
             gscale: torch.Tensor, *, glu_act: str | None = None) -> torch.Tensor:
    """y[B, N] = x[B, K] @ dequant4(W4_all[layer, expert])^T over packed int4
    experts (L, E, N, K/2) with group scales (L, E, G, N)."""
    e = _routed("gemm4_le", x, w4_all, expert, True, 2)
    if B.device_kind(x, w4_all, gscale, e) == "cpu":
        return gemm_le_plain(x, w4_all, layer, expert, gscale, glu_act=glu_act)
    return launch_gemm("gemm4_le", x.contiguous(), w4_all, layer, gscale, expert=expert,
                       glu_act=glu_act)


def gemv4_le(x: torch.Tensor, w4_all: torch.Tensor, layer: int, expert,
             gscale: torch.Tensor, *, norm_w: torch.Tensor | None = None,
             norm_eps: float = 1e-5, glu_act: str | None = None) -> torch.Tensor:
    """Single-token routed-expert int4 GEMV (x (K,) -> y (N,)), on
    csrc/gemv.cu (JAX runs it as gemm4_le with one row)."""
    e = _routed("gemv4_le", x, w4_all, expert, True, 1)
    if B.device_kind(x, w4_all, gscale, norm_w, e) == "cpu":
        return gemv_le_plain(x, w4_all, layer, expert, gscale, norm_w=norm_w,
                             norm_eps=norm_eps, glu_act=glu_act)
    return launch_gemv("gemv4_le", x, w4_all, layer, expert=expert, norm_w=norm_w,
                       norm_eps=norm_eps, scale=gscale, glu_act=glu_act)
