"""Medusa self-drafting heads (port of `yalm_tpu/medusa.py`; Cai et al.,
arXiv:2401.10774, Medusa-1).

H small heads read the target's own post-final-norm hidden state; head h
predicts the token h+1 positions past the next one:

    z_h = hidden + silu(W1_h @ hidden + b1_h)      (dim -> dim residual)
    proposal_h = argmax(Head_h @ z_h)              (dim -> vocab)

Proposals are argmax point masses, so verification is the point-mass
rejection of prompt lookup (spec.py): the emitted stream is the target's
greedy stream at T=0 and its temperature distribution at T>0 whatever the
heads propose; head quality only buys speed.

The heads live in the checkpoint as `medusa.{h}.w1.weight`,
`medusa.{h}.w1.bias`, `medusa.{h}.head.weight` with metadata
`medusa_heads = H`. The JAX package multiplies bf16 operands with f32
results; here the operands are rounded to bf16 once, when the heads are
made, and multiplied in f32 with TF32 off (a bf16 matmul would round the
logits to bf16, whose argmax can tie differently). Plain torch on every
device: the heads are einsums in the JAX package too, not a kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Mapping

import numpy as np
import torch

from .codec.format import numpy_to_torch, tag_for_numpy
from .config import ModelConfig
from .ops.core import f32_matmul, silu
from .ops.cuda.gemv import bf16f


@dataclass
class MedusaWeights:
    w1: torch.Tensor     # (H, dim, dim)
    b1: torch.Tensor     # (H, dim) f32
    head: torch.Tensor   # (H, vocab, dim)
    # the bf16-rounded operands in f32, made once
    w1_op: torch.Tensor = field(init=False, repr=False)
    head_op: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.w1_op = bf16f(self.w1)
        self.head_op = bf16f(self.head)

    @property
    def n_heads(self) -> int:
        return int(self.w1.shape[0])


def load_medusa_weights(yf, cfg: ModelConfig, device="cuda") -> MedusaWeights:
    """The checkpoint's heads (metadata `medusa_heads`), stacked on `device`."""
    H = int(yf.metadata["medusa_heads"])
    d, v = cfg.dim, cfg.vocab_size

    def stack(fmt, shape):
        out = []
        for h in range(H):
            name = fmt.format(h)
            if tuple(yf.tensors[name].shape) != shape:
                raise ValueError(f"{name}: want {shape}, got {yf.tensors[name].shape}")
            out.append(yf.torch(name))   # a copy: never aliases the mapping
        return torch.stack(out).to(device)

    return MedusaWeights(w1=stack("medusa.{}.w1.weight", (d, d)),
                         b1=stack("medusa.{}.w1.bias", (d,)).float(),
                         head=stack("medusa.{}.head.weight", (v, d)))


def medusa_weights_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> MedusaWeights:
    """The port's MedusaWeights from the JAX package's MedusaWeights fields
    given as numpy arrays (w1, b1, head)."""
    conv = {f.name: numpy_to_torch(np.asarray(arrays[f.name]),
                                   tag_for_numpy(np.asarray(arrays[f.name]))).to(device)
            for f in fields(MedusaWeights) if f.init}
    conv["b1"] = conv["b1"].float()
    return MedusaWeights(**conv)


def medusa_logits_rows(mw: MedusaWeights, hidden: torch.Tensor) -> torch.Tensor:
    """Every head's logits from per-lane hidden rows (B, dim) -> (B, H, vocab)
    f32 (medusa.py:101-112)."""
    h = hidden.float()
    with f32_matmul():
        z = torch.einsum("hij,bj->bhi", mw.w1_op, bf16f(h)) + mw.b1[None].float()
        z = h[:, None] + silu(z)
        return torch.einsum("hvi,bhi->bhv", mw.head_op, bf16f(z))


def medusa_propose_rows(mw: MedusaWeights, hidden: torch.Tensor) -> torch.Tensor:
    """Greedy proposals of every head from per-lane hidden rows (B, dim) ->
    (B, H) int64 (the scheduler's per-round source)."""
    return torch.argmax(medusa_logits_rows(mw, hidden), dim=-1)


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties by the
    lower index first, as jax.lax.top_k orders them (torch.topk promises
    no order among ties): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def medusa_propose_topk_rows(mw: MedusaWeights, hidden: torch.Tensor, kmax: int) -> torch.Tensor:
    """Every head's kmax best candidates from per-lane hidden rows (B, dim)
    -> (B, H, kmax) int64 (medusa.py:82-97): head h's candidates for the
    position h+1 ahead, the per-depth candidate sets of tree verification
    (models/fast.py:verify_tree_fast_batched). Column 0 is each head's
    argmax, medusa_propose_rows' proposal."""
    return topk_stable(medusa_logits_rows(mw, hidden), kmax)[1]


def medusa_propose(mw: MedusaWeights, hidden: torch.Tensor) -> torch.Tensor:
    """Greedy proposals for the positions +2..+H+1 from one hidden row (dim,)
    -> (H,) int64 (the engine's source)."""
    return medusa_propose_rows(mw, hidden.reshape(1, -1))[0]
