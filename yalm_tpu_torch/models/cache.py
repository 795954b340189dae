"""KV cache: one stacked K and one V tensor of shape
(n_layers, max_seq_len, n_kv_heads, head_dim) on a given device, or with a
leading batch axis (B, n_layers, ...) for the continuous-batching
scheduler (yalm_tpu/models/cache.py:26-30), of type bf16 or fp8 e5m2
(`-C fp8`: half the bytes; rows are rounded to it from f32, and attention
reads them widened to bf16, which is exact).

The decode and prefill paths update these tensors IN PLACE (slot writes
into the ring buffer), where the JAX package donated and aliased its
buffers; a KVCache is therefore owned by one engine at a time. A lane of a
batched cache (`lane(b)`) is a view that the single-sequence paths update
in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codec.format import numpy_to_torch, tag_for_numpy
from ..config import ModelConfig


@dataclass
class KVCache:
    k: torch.Tensor  # ([B,] n_layers, max_seq_len, n_kv_heads, head_dim)
    v: torch.Tensor  # ([B,] n_layers, max_seq_len, n_kv_heads, head_dim)

    @classmethod
    def init(cls, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
             device: torch.device | str = "cuda", batch: int | None = None) -> "KVCache":
        shape = (cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
        if batch is not None:
            shape = (batch,) + shape
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @classmethod
    def from_numpy(cls, k: np.ndarray, v: np.ndarray, device="cpu") -> "KVCache":
        """The port's cache from the JAX package's KVCache arrays as numpy
        (bf16/fp8 arrays of ml_dtypes' types are recognised by dtype name)."""
        def conv(a):
            return numpy_to_torch(a, tag_for_numpy(a)).to(device)
        return cls(k=conv(k), v=conv(v))

    def lane(self, b: int) -> "KVCache":
        """Lane b of a batched cache, as views (writes go to this cache)."""
        return KVCache(k=self.k[b], v=self.v[b])
