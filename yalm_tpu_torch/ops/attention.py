"""GQA attention over the KV ring buffer in plain f32 torch (port of
`yalm_tpu/ops/attention.py`): the parity oracle's decode attention (one
query position against the whole window) and its prefill attention (a
chunk of query positions). f32 scores scaled by 1/sqrt(head_dim), Gemma2's
softcap before the mask, a softmax over exactly the valid slots, an f32 V
mix, TF32 off. These run on any device; the kernels' own attention lives
in `ops/cuda/attention.py`.
"""

from __future__ import annotations

import math

import torch

from .core import f32_matmul, masked_softmax


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2's logit soft-capping cap * tanh(scores / cap) (cap 0: off),
    after the 1/sqrt(head_dim) scale and before the mask."""
    if not cap:
        return scores
    return cap * torch.tanh(scores / cap)


def attend_one(q: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, slot_valid: torch.Tensor,
               softcap: float = 0.0) -> torch.Tensor:
    """Single-position GQA attention. q (n_kv_heads, q_per_kv, head_dim),
    kb/vb (L, n_kv_heads, head_dim) of any type, slot_valid (L,) bool;
    returns (n_kv_heads, q_per_kv, head_dim) f32."""
    head_dim = q.shape[-1]
    with f32_matmul():
        scores = torch.einsum("gqd,lgd->gql", q.float(), kb.float()) / math.sqrt(head_dim)
        att = masked_softmax(_softcap(scores, softcap), slot_valid)
        return torch.einsum("gql,lgd->gqd", att, vb.float())


def attend_chunk(q: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, att_mask: torch.Tensor,
                 softcap: float = 0.0) -> torch.Tensor:
    """Chunked GQA attention for prefill. q (T, n_kv_heads, q_per_kv,
    head_dim), kb/vb (L, n_kv_heads, head_dim), att_mask (T, L) bool (chunk
    row t sees cache slot l); returns (T, n_kv_heads, q_per_kv, head_dim)
    f32."""
    head_dim = q.shape[-1]
    with f32_matmul():
        scores = torch.einsum("tgqd,lgd->gqtl", q.float(), kb.float()) / math.sqrt(head_dim)
        att = masked_softmax(_softcap(scores, softcap), att_mask[None, None])
        return torch.einsum("gqtl,lgd->tgqd", att, vb.float())
