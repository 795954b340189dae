"""Dense FFN of one layer (port of `ffn_l`, `yalm_tpu/ops/pallas/ffn.py`):

    x + W2[layer] @ bf16(act(h1) * h3),  [h1; h3] = W13[layer] @ rmsnorm(x)

The TPU runs this as ONE Pallas kernel with both weight streams inside; on
Hopper that would need a grid-wide barrier between the w13 and the w2 sweep,
so on CUDA this wrapper launches two hand-written kernels in a row
(csrc/gemv.cu twice): norm + w13 GEMV with the GLU-pair epilogue, which
writes the bf16 GLU output, then the w2 GEMV with scale + residual. One
persistent launch is later work.
"""

from __future__ import annotations

import torch

from ..core import gelu, silu
from . import _build as B
from .gemv import bf16f, launch_gemv


def ffn_plain(x, norm_w, w13_all, w2_all, layer, scale13=None, scale2=None, *,
              norm_eps, act, add_residual=True):
    """The JAX emulation branch (ffn.py:356-382)."""
    H = w13_all.shape[1] // 2
    x2 = x.reshape(-1, w13_all.shape[2]).float()
    ms = torch.mean(x2 * x2, dim=-1, keepdim=True)
    xb = x2 * torch.rsqrt(ms + norm_eps) * norm_w[layer].float()
    h13 = bf16f(xb) @ bf16f(w13_all[layer]).T
    if scale13 is not None:
        h13 = h13 * scale13[layer].float()[None]
    h1, h3 = h13[:, :H], h13[:, H:]
    g = silu(h1) if act == "silu" else gelu(h1)
    out = bf16f(g * h3) @ bf16f(w2_all[layer]).T
    if scale2 is not None:
        out = out * scale2[layer].float()[None]
    if add_residual:
        out = x2 + out
    return out.reshape(x.shape)


def ffn_l(x: torch.Tensor, norm_w: torch.Tensor, w13_all: torch.Tensor,
          w2_all: torch.Tensor, layer: int,
          scale13: torch.Tensor | None = None,
          scale2: torch.Tensor | None = None, *,
          norm_eps: float, act: str, add_residual: bool = True) -> torch.Tensor:
    """x: (dim,) or (B, dim) f32 residual stream(s); returns the same shape.
    On CUDA, B <= 8 rows (the decode path has 1)."""
    L, H2, K = w13_all.shape
    if x.shape[-1] != K or w2_all.shape[1:] != (K, H2 // 2):
        raise ValueError(f"ffn_l: x {tuple(x.shape)}, w13 {tuple(w13_all.shape)}, "
                         f"w2 {tuple(w2_all.shape)}")
    if act not in ("silu", "gelu"):
        raise ValueError(f"ffn_l: unknown activation {act!r}")
    if B.device_kind(x, norm_w, w13_all, w2_all, scale13, scale2) == "cpu":
        return ffn_plain(x, norm_w, w13_all, w2_all, layer, scale13, scale2,
                         norm_eps=norm_eps, act=act, add_residual=add_residual)
    h = launch_gemv("gemv_l", x.float(), w13_all, layer, norm_w=norm_w,
                    norm_eps=norm_eps, scale=scale13, glu_act=act)
    out = launch_gemv("gemv_l", h, w2_all, layer, scale=scale2,
                      residual=x.float() if add_residual else None)
    B.LAUNCHES["ffn_l"] += 1
    return out.reshape(x.shape)
