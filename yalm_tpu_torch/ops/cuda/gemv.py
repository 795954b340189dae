"""Dequant GEMV / GEMM over layer-stacked weights (port of
`yalm_tpu/ops/pallas/gemv.py`: gemv, gemv_l, gemm_l, gemm, the packed int4
gemm4_l, gemv4_l, gemm4, gemv4, and the MoE routed-expert gemv_le, gemm_le,
gemm4_le, gemv4_le over (L, E, N, K) expert stacks).

Kernels: `csrc/gemv.cu` (one warp per output row, fused rmsnorm prologue,
scale/bias/clip/residual or GLU-pair epilogue; int4 weights with their
group scales too) and `csrc/gemm.cu` (mma.sync bf16 tiles for the prefill
chunks and the batched tick; `gemm4_kernel` for int4; a residual or
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

import math

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


def gemm_l_plain(x, w_all, layer, scale=None):
    out = bf16f(x) @ _bf16_weights(w_all[layer]).T
    if scale is not None:
        out = out * scale[layer].float()[None]
    return out


def gemm4_l_plain(x, w4_all, layer, gscale):
    """x (B, K) against packed int4 W4_all[layer] (N, K/2) with group scales
    gscale[layer] (G, N): per-group bf16 x bf16 products summed in f32, the
    group scale on each group's f32 partial, the groups added in order."""
    Bn, K = x.shape
    p = w4_all[layer]
    N = p.shape[0]
    group = int4_group(K)
    G = K // group
    p = p.reshape(N, G, group // 2)
    q = torch.empty((N, G, group), dtype=torch.float32, device=p.device)
    q[..., : group // 2] = p & 0xF
    q[..., group // 2:] = p >> 4
    q -= 8.0
    xg = bf16f(x).reshape(Bn, G, group)
    s = gscale[layer].float()
    out = torch.zeros((Bn, N), dtype=torch.float32, device=x.device)
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
    """One launch of csrc/gemv.cu on CUDA tensors (adds one to
    LAUNCHES[count]). x: (K,) or (nb, K); returns float32 of shape
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
    code = B.lib().yt_gemv(
        B.WTYPE[w_all.dtype], B.ptr(w_all), layer, E, e_host, B.ptr(e_dev), N, K,
        B.ptr(x2), nb, B.ptr(norm_w), norm_eps, B.ptr(scale), B.ptr(gscale),
        int4_group(K) if int4 else 0, B.ptr(bias),
        clip if math.isfinite(clip) else 0.0, B.ptr(residual), B.ptr(out),
        1 if glu_act else 0, 1 if glu_act == "gelu" else 0, B.stream_ptr())
    B.check(code, count)
    B.LAUNCHES[count] += 1
    return out.reshape(*x.shape[:-1], n_out)


def launch_gemm(count: str, x, w_all, layer: int, scale=None, *, expert=None, residual=None,
                glu_act: str | None = None):
    """One launch of csrc/gemm.cu (gemm_kernel, or gemm4_kernel for packed
    int4 weights) on CUDA tensors (adds one to LAUNCHES[count]). x: (M, K)
    f32; returns (M, N) f32, + residual (M, N) if given, or for the GLU
    pair (M, N // 2) holding bf16 values. `scale` is per row (L, [E,] N),
    or the group scales (L, [E,] G, N) of packed int4 weights; `expert` as
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
    if int4:
        code = B.lib().yt_gemm4(B.ptr(w_all), layer, E, e_host, B.ptr(e_dev), N, K,
                                int4_group(K), B.ptr(x), M, B.ptr(scale), B.ptr(residual),
                                B.ptr(y), glu, act, B.stream_ptr())
    else:
        code = B.lib().yt_gemm(B.WTYPE[w_all.dtype], B.ptr(w_all), layer, E, e_host,
                               B.ptr(e_dev), N, K, B.ptr(x), M, B.ptr(scale),
                               B.ptr(residual), B.ptr(y), glu, act, B.stream_ptr())
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
    weights (L, N, K/2) uint8 with group scales (L, G, N); any B on the
    CPU, B rows in 64-row tiles on CUDA."""
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
