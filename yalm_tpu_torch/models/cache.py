"""KV cache: one stacked K and one V tensor of shape
(n_layers, max_seq_len, n_kv_heads, head_dim) on a given device, of type
bf16 or fp8 e5m2 (`-C fp8`: half the bytes; rows are rounded to it from
f32, and attention reads them widened to bf16, which is exact).

The decode and prefill paths update these tensors IN PLACE (slot writes
into the ring buffer), where the JAX package donated and aliased its
buffers; a KVCache is therefore owned by one engine at a time.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import ModelConfig


@dataclass
class KVCache:
    k: torch.Tensor  # (n_layers, max_seq_len, n_kv_heads, head_dim)
    v: torch.Tensor  # (n_layers, max_seq_len, n_kv_heads, head_dim)

    @classmethod
    def init(cls, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
             device: torch.device | str = "cuda") -> "KVCache":
        shape = (cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
