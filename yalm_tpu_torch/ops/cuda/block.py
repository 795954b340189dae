"""Attention block of one decode step (port of `attn_block_l`,
`yalm_tpu/ops/pallas/block.py`):

    x + Wo[layer] @ attend(rope(clip(Wqkv[layer] @ rmsnorm(x) * s + b)))

The TPU runs this as ONE Pallas kernel because its grid runs in order; on
Hopper one launch would need a grid-wide barrier between the two weight
sweeps and the attention. So on CUDA this wrapper launches three
hand-written kernels in a row on the current stream: norm + wqkv GEMV with
scale/bias/clip epilogue (csrc/gemv.cu), the attention step
(csrc/attention.cu), and the wo GEMV with scale + residual (csrc/gemv.cu).
The intermediates are scratch tensors of this wrapper. Fusing them into
one persistent launch is later work.
"""

from __future__ import annotations

import math

import torch

from . import _build as B
from .attention import attend_step_l, launch_attend_step
from .gemv import gemv_l_plain, launch_gemv


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
    """The JAX emulation branch (block.py:586-612); mutates the cache."""
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
    L, S, Hk, D = k_all.shape
    if tuple(x.shape) != (wqkv_all.shape[2],) or wqkv_all.shape[1] != (n_heads + 2 * Hk) * D:
        raise ValueError(f"attn_block_l: x {tuple(x.shape)}, wqkv {tuple(wqkv_all.shape)}")
    kw = dict(n_heads=n_heads, kv_sinks=kv_sinks, theta=theta,
              rotary_dim=rotary_dim, norm_eps=norm_eps, qkv_clip=qkv_clip,
              bqkv_all=bqkv_all, add_residual=add_residual,
              scale_qkv=scale_qkv, scale_o=scale_o)
    kind = B.device_kind(x, norm_w, wqkv_all, wo_all, k_all, v_all, bqkv_all,
                         scale_qkv, scale_o)
    if kind == "cpu":
        return attn_block_plain(x, norm_w, wqkv_all, wo_all, k_all, v_all, layer,
                                kv_pos, kv_len, kv_sink, pos, **kw)
    qkv = launch_gemv("gemv_l", x, wqkv_all, layer, norm_w=norm_w,
                      norm_eps=norm_eps, scale=scale_qkv, bias=bqkv_all,
                      clip=qkv_clip)
    q, k, v = _split_qkv(qkv, n_heads, Hk, D)
    mix = launch_attend_step(q, k, v, k_all, v_all, layer, kv_pos, kv_len,
                             kv_sink, pos, kv_sinks=kv_sinks, theta=theta,
                             rotary_dim=rotary_dim)
    out = launch_gemv("gemv_l", mix.reshape(-1), wo_all, layer, scale=scale_o,
                      residual=x if add_residual else None)
    B.LAUNCHES["attn_block_l"] += 1
    return out
