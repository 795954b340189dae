"""Dequant GEMV / GEMM over layer-stacked weights (port of
`yalm_tpu/ops/pallas/gemv.py`: gemv, gemv_l, gemm_l, gemm).

Kernels: `csrc/gemv.cu` (one warp per output row, fused rmsnorm prologue,
scale/bias/clip/residual or GLU-pair epilogue) and `csrc/gemm.cu`
(mma.sync bf16 tiles for the prefill chunks). Each public function chooses
by its tensors' device: on the CPU it runs the plain version beside it, on
CUDA it launches the kernel or raises.

Numerics contract (gemv.py:69-77): bf16 operands, f32 accumulation, the
dequant scale applied to the f32 result. fp16 weights never reach here:
the loader turns them into bf16 on the host.
"""

from __future__ import annotations

import math

import torch

from . import _build as B


def bf16f(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and widen back to f32: the kernels' operand rounding."""
    return t.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# plain versions (the JAX emulation branches, gemv.py:172-182 and :442-450)
# ---------------------------------------------------------------------------

def gemv_l_plain(x, w_all, layer, *, norm_w=None, norm_eps=1e-5,
                 residual=None, scale=None):
    xv = x.float()
    if norm_w is not None:
        ms = torch.mean(xv * xv)
        xv = xv * torch.rsqrt(ms + norm_eps) * norm_w[layer].float()
    out = bf16f(w_all[layer]) @ bf16f(xv)
    if scale is not None:
        out = out * scale[layer].float()
    return out + residual if residual is not None else out


def gemm_l_plain(x, w_all, layer, scale=None):
    out = bf16f(x) @ bf16f(w_all[layer]).T
    if scale is not None:
        out = out * scale[layer].float()[None]
    return out


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------

def _check_weights(w_all: torch.Tensor, K: int, what: str) -> None:
    B.require(w_all.dtype in B.WTYPE, f"{what}: no kernel for {w_all.dtype} weights")
    B.require(w_all.is_contiguous(), f"{what}: weights must be contiguous")
    B.require(K * w_all.element_size() % 16 == 0,
              f"{what}: K * itemsize must be a multiple of 16 bytes (K={K})")


def _f32(t, what):
    if t is None:
        return None
    B.require(t.dtype == torch.float32 and t.is_contiguous(),
              f"{what}: contiguous float32 expected, got {t.dtype}")
    return t


def launch_gemv(count: str, x, w_all, layer: int, *, norm_w=None,
                norm_eps: float = 1e-5, scale=None, bias=None,
                clip: float = math.inf, residual=None, glu_act: str | None = None):
    """One launch of csrc/gemv.cu on CUDA tensors (adds one to
    LAUNCHES[count]). x: (K,) or (nb, K); returns float32 of shape
    (..., N) or, for the GLU pair, (..., N // 2) holding bf16 values."""
    L, N, K = w_all.shape
    _check_weights(w_all, K, count)
    x2 = _f32(x.reshape(-1, K), count)
    nb = x2.shape[0]
    B.require(1 <= nb <= 8, f"{count}: 1..8 rows of x, got {nb}")
    B.require(nb * K * 2 <= 227 * 1024, f"{count}: {nb} rows of K={K} exceed shared memory")
    B.require(0 <= layer < L, f"{count}: layer {layer} out of range")
    n_out = N // 2 if glu_act else N
    for t, shape, nm in ((norm_w, (L, K), "norm_w"), (scale, (L, N), "scale"),
                         (bias, (L, N), "bias")):
        if t is not None:
            _f32(t, f"{count} {nm}")
            B.require(tuple(t.shape) == shape, f"{count}: {nm} shape {tuple(t.shape)} != {shape}")
    if residual is not None:
        residual = _f32(residual.reshape(nb, n_out), f"{count} residual")
    B.require(B.aligned16(w_all, x2), f"{count}: weights and x must be 16-byte aligned")
    out = torch.empty((nb, n_out), dtype=torch.float32, device=x.device)
    code = B.lib().yt_gemv(
        B.WTYPE[w_all.dtype], B.ptr(w_all), layer, N, K, B.ptr(x2), nb,
        B.ptr(norm_w), norm_eps, B.ptr(scale), B.ptr(bias),
        clip if math.isfinite(clip) else 0.0, B.ptr(residual), B.ptr(out),
        1 if glu_act else 0, 1 if glu_act == "gelu" else 0, B.stream_ptr())
    B.check(code, count)
    B.LAUNCHES[count] += 1
    return out.reshape(*x.shape[:-1], n_out)


def _launch_gemm(x, w_all, layer: int, scale=None):
    L, N, K = w_all.shape
    _check_weights(w_all, K, "gemm_l")
    B.require(K % 32 == 0, f"gemm_l: K must be a multiple of 32 (K={K})")
    x = _f32(x, "gemm_l x")
    B.require(0 <= layer < L, f"gemm_l: layer {layer} out of range")
    if scale is not None:
        _f32(scale, "gemm_l scale")
        B.require(tuple(scale.shape) == (L, N), "gemm_l: scale must be (L, N)")
    B.require(B.aligned16(w_all, x), "gemm_l: weights and x must be 16-byte aligned")
    M = x.shape[0]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    code = B.lib().yt_gemm(B.WTYPE[w_all.dtype], B.ptr(w_all), layer, N, K,
                           B.ptr(x), M, B.ptr(scale), B.ptr(y), B.stream_ptr())
    B.check(code, "gemm_l")
    B.LAUNCHES["gemm_l"] += 1
    return y


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
    if tuple(x.shape) != (K,):
        raise ValueError(f"gemv_l: x {tuple(x.shape)} vs w_all {tuple(w_all.shape)}")
    if B.device_kind(x, w_all, norm_w, residual, scale) == "cpu":
        return gemv_l_plain(x, w_all, layer, norm_w=norm_w, norm_eps=norm_eps,
                            residual=residual, scale=scale)
    return launch_gemv("gemv_l", x, w_all, layer, norm_w=norm_w,
                       norm_eps=norm_eps, scale=scale, residual=residual)


def gemm_l(x: torch.Tensor, w_all: torch.Tensor, layer: int,
           scale: torch.Tensor | None = None) -> torch.Tensor:
    """y[B, N] = x[B, K] @ W_all[layer]^T [* scale[layer]]."""
    if x.dim() != 2 or x.shape[1] != w_all.shape[2]:
        raise ValueError(f"gemm_l: x {tuple(x.shape)} vs w_all {tuple(w_all.shape)}")
    if B.device_kind(x, w_all, scale) == "cpu":
        return gemm_l_plain(x, w_all, layer, scale)
    return _launch_gemm(x, w_all, layer, scale)


def gemm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """y[B, N] = x[B, K] @ W[N, K]^T [* scale] (2-D weights, e.g. the LM head)."""
    return gemm_l(x, w[None], 0, scale[None] if scale is not None else None)
