"""The parity oracle's weights and their loader (port of
`yalm_tpu/models/weights.py`).

Every layer's tensors are stacked along a leading n_layers axis, one field
per checkpoint tensor (wq, wk and wv apart, w1 and w3 apart), in the
checkpoint's own type: fp32, f16, bf16 and fp8 weights stay as stored and
the oracle widens them at use. int8 weights are dequantized at load to
q * scale in f32 (the golden semantics the kernels' in-kernel dequant must
match); packed int4 weights to nibble * group scale in f32 (`ops/int4.py`).
The decode layout of the kernels is `models/fast.py:FastWeights`
(`FastWeights.from_weights` concatenates these fields).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.core import int_view
from ..ops.int4 import unpack_int4


class LayerWeights(NamedTuple):
    """One transformer block's weights; every field stacked over n_layers."""

    rms_att: torch.Tensor   # (n_layers, dim) f32
    rms_ffn: torch.Tensor   # (n_layers, dim) f32
    wq: torch.Tensor        # (n_layers, q_dim, dim)
    wk: torch.Tensor        # (n_layers, kv_dim, dim)
    wv: torch.Tensor        # (n_layers, kv_dim, dim)
    wo: torch.Tensor        # (n_layers, dim, q_dim)
    w1: torch.Tensor        # (n_layers, [n_experts,] hidden_dim, dim)
    w2: torch.Tensor        # (n_layers, [n_experts,] dim, hidden_dim)
    w3: torch.Tensor        # (n_layers, [n_experts,] hidden_dim, dim)
    moegate: Optional[torch.Tensor]   # (n_layers, n_experts, dim) or None
    bq: Optional[torch.Tensor] = None  # (n_layers, q_dim) f32, Qwen2-style biases
    bk: Optional[torch.Tensor] = None  # (n_layers, kv_dim) f32
    bv: Optional[torch.Tensor] = None  # (n_layers, kv_dim) f32
    qn: Optional[torch.Tensor] = None  # (n_layers, head_dim) f32, Qwen3 qk-norm
    kn: Optional[torch.Tensor] = None  # (n_layers, head_dim) f32
    pa: Optional[torch.Tensor] = None  # (n_layers, dim) f32, Gemma2 post-attention norm
    pf: Optional[torch.Tensor] = None  # (n_layers, dim) f32, post-feedforward norm


class Weights(NamedTuple):
    embed: torch.Tensor        # (vocab_size, dim)
    layers: LayerWeights
    final_norm: torch.Tensor   # (dim,) f32
    lm_head: torch.Tensor      # (vocab_size, dim); embed itself when tied


def load_weights(yf, cfg: ModelConfig, device="cuda") -> Weights:
    """Shape-check and stack every tensor of a checkpoint on `device`
    (weights.py:104-182). The tensors are copied out of the mapping, so the
    checkpoint may be closed afterwards."""
    device = torch.device(device)
    t = yf.tensors

    def get(name: str, shape: tuple[int, ...]) -> torch.Tensor:
        if name not in t:
            raise KeyError(f"missing tensor: {name}")
        gs = t.get(name + ".gscale")
        if gs is not None:
            arr = unpack_int4(t[name], gs)
        elif name + ".scale" in t:
            arr = t[name].astype(np.float32) * np.asarray(t[name + ".scale"], np.float32)[..., None]
        else:
            arr = None
        if arr is not None:
            got = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        else:
            got = yf.torch(name)   # a copy in the stored type
        if tuple(got.shape) != shape:
            raise ValueError(f"tensor {name}: expected shape {shape}, got {tuple(got.shape)}")
        return got

    d, h, kd, q = cfg.dim, cfg.hidden_dim, cfg.kv_dim, cfg.q_dim
    ffn1 = (cfg.n_experts, h, d) if cfg.is_moe else (h, d)
    ffn2 = (cfg.n_experts, d, h) if cfg.is_moe else (d, h)

    def stacked(fmt: str, shape: tuple[int, ...], on: bool = True) -> Optional[torch.Tensor]:
        if not on:
            return None
        first = get(fmt.format(0), shape)
        out = torch.empty((cfg.n_layers,) + shape, dtype=first.dtype, device=device)
        for l in range(cfg.n_layers):
            # through integer views: not every backend copies fp8
            int_view(out[l]).copy_(int_view(first if l == 0 else get(fmt.format(l), shape)))
        return out

    pre = "model.layers.{}."
    layers = LayerWeights(
        rms_att=stacked(pre + "attn.norm.weight", (d,)),
        rms_ffn=stacked(pre + "mlp.norm.weight", (d,)),
        wq=stacked(pre + "attn.wq.weight", (q, d)),
        wk=stacked(pre + "attn.wk.weight", (kd, d)),
        wv=stacked(pre + "attn.wv.weight", (kd, d)),
        wo=stacked(pre + "attn.wo.weight", (d, q)),
        w1=stacked(pre + "mlp.w1.weight", ffn1),
        w2=stacked(pre + "mlp.w2.weight", ffn2),
        w3=stacked(pre + "mlp.w3.weight", ffn1),
        moegate=stacked(pre + "moegate.weight", (cfg.n_experts, d), cfg.is_moe),
        bq=stacked(pre + "attn.wq.bias", (q,), cfg.has_qkv_bias),
        bk=stacked(pre + "attn.wk.bias", (kd,), cfg.has_qkv_bias),
        bv=stacked(pre + "attn.wv.bias", (kd,), cfg.has_qkv_bias),
        qn=stacked(pre + "attn.q_norm.weight", (cfg.head_dim,), cfg.has_qk_norm),
        kn=stacked(pre + "attn.k_norm.weight", (cfg.head_dim,), cfg.has_qk_norm),
        pa=stacked(pre + "attn.post_norm.weight", (d,), cfg.has_post_norms),
        pf=stacked(pre + "mlp.post_norm.weight", (d,), cfg.has_post_norms),
    )
    embed = get("model.embed.weight", (cfg.vocab_size, d)).to(device)
    # tied embeddings: the classifier reuses the embedding matrix
    lm_head = (get("model.output.weight", (cfg.vocab_size, d)).to(device)
               if "model.output.weight" in t else embed)
    return Weights(embed=embed, layers=layers,
                   final_norm=get("model.norm.weight", (d,)).to(device), lm_head=lm_head)
