"""Attention block of one decode step (port of `attn_block_l` and its
packed-int4 twin `attn_block4_l`, `yalm_tpu/ops/pallas/block.py`):

    x + Wo[layer] @ attend(rope(clip(Wqkv[layer] @ rmsnorm(x) * s + b)))

The TPU runs this as ONE Pallas kernel because its grid runs in order; on
Hopper one launch would need a grid-wide barrier between the two weight
sweeps and the attention. So on CUDA this wrapper launches three
hand-written kernels in a row on the current stream: norm + wqkv GEMV with
scale/bias/clip epilogue (csrc/gemv.cu), the attention step
(csrc/attention.cu), and the wo GEMV with scale + residual (csrc/gemv.cu).
For int4 weights the same three launches run csrc/gemv.cu's int4 path,
with group scales in place of the per-row ones. The intermediates are
scratch tensors of this wrapper. Fusing them into one persistent launch is
later work.
"""

from __future__ import annotations

import math

import torch

from . import _build as B
from .attention import attend_step_l, launch_attend_step
from .gemv import gemv_l_plain, is_int4, launch_gemv


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
    if kind == "cpu":
        return attn_block_plain(x, norm_w, wqkv_all, wo_all, k_all, v_all, layer,
                                kv_pos, kv_len, kv_sink, pos, n_heads=n_heads,
                                kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim,
                                norm_eps=norm_eps, qkv_clip=qkv_clip, bqkv_all=bqkv_all,
                                add_residual=add_residual, scale_qkv=scale_qkv,
                                scale_o=scale_o)
    gemv_name = "gemv4_l" if int4 else "gemv_l"
    qkv = launch_gemv(gemv_name, x, wqkv_all, layer, norm_w=norm_w,
                      norm_eps=norm_eps, scale=scale_qkv, bias=bqkv_all,
                      clip=qkv_clip)
    q, k, v = _split_qkv(qkv, n_heads, Hk, D)
    mix = launch_attend_step(q, k, v, k_all, v_all, layer, kv_pos, kv_len,
                             kv_sink, pos, kv_sinks=kv_sinks, theta=theta,
                             rotary_dim=rotary_dim)
    out = launch_gemv(gemv_name, mix.reshape(-1), wo_all, layer, scale=scale_o,
                      residual=x if add_residual else None)
    B.LAUNCHES[name] += 1
    return out


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
