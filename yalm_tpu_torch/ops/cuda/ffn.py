"""Dense FFN of one layer (port of `ffn_l` and its packed-int4 twin
`ffn4_l`, `yalm_tpu/ops/pallas/ffn.py`):

    x + W2[layer] @ bf16(act(h1) * h3),  [h1; h3] = W13[layer] @ rmsnorm(x)

The TPU runs this as ONE Pallas kernel with both weight streams inside; on
Hopper that would need a grid-wide barrier between the w13 and the w2 sweep,
so on CUDA this wrapper launches hand-written kernels in a row, by row count:

- up to 8 rows whose bf16 copies fit shared memory (decode, 1 row): the
  GEMV route, csrc/gemv.cu twice -- norm + w13 GEMV with the GLU-pair
  epilogue, which writes the bf16 GLU output, then the w2 GEMV with scale +
  residual;
- more rows (the batched tick, chunks): the GEMM route, csrc/gemm.cu five
  times -- the row norm, then for the w13 GEMM with the GLU-pair epilogue
  and the w2 GEMM with scale + residual each the rounding of its X to bf16
  and the wgmma gemm_kernel.

Both routes round the same operands (ffn.py:47, :188), so they agree to the
f32 summation order. For int4 weights every launch takes the kernels'
int4 path, with the group scales of w1 and w3 concatenated along N ((L, G,
2H)). One persistent launch is later work.
"""

from __future__ import annotations

import torch

from ..core import gelu, silu
from . import _build as B
from .gemv import bf16f, is_int4, launch_gemm, launch_gemv, launch_rmsnorm_rows, proj_plain

SMEM_MAX = 227 * 1024


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


def gemv_route(rows: int, K: int, H: int) -> bool:
    """Whether csrc/gemv.cu takes these rows: <= 8, staged in shared memory
    as bf16 (x for w13, the GLU output for w2)."""
    return rows <= 8 and rows * max(K, H) * 2 <= SMEM_MAX


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
    if gemv_route(x2.shape[0], K, H2 // 2):
        gemv_name = "gemv4_l" if int4 else "gemv_l"
        h = launch_gemv(gemv_name, x2, w13_all, layer, norm_w=norm_w,
                        norm_eps=norm_eps, scale=scale13, glu_act=act)
        out = launch_gemv(gemv_name, h, w2_all, layer, scale=scale2, residual=res)
    else:
        gemm_name = "gemm4_l" if int4 else "gemm_l"
        xb = launch_rmsnorm_rows(x2, norm_w, layer, norm_eps)
        h = launch_gemm(gemm_name, xb, w13_all, layer, scale13, glu_act=act)
        out = launch_gemm(gemm_name, h, w2_all, layer, scale2, residual=res)
        name += "_gemm"
    B.LAUNCHES[name] += 1
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
