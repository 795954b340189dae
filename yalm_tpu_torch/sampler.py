"""Sampling on the logits' device (port of `yalm_tpu/sampler.py`).

Random draws come from an explicit `torch.Generator` on the logits'
device (Gumbel-max: argmax(logits/T + Gumbel noise) is a draw from
softmax(logits/T)), so a sampled token stays on the device until the caller
reads it. The JAX package draws from its own key stream: the two give the
same distribution, not the same bits.
"""

from __future__ import annotations

import torch


def sample_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy pick."""
    return torch.argmax(logits, dim=-1)


def logprob_of(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """log p(token | logits) for each row (the perplexity primitive)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, token.long()[..., None])[..., 0]


def sample_ext(logits: torch.Tensor, generator: torch.Generator | None,
               temperature: float, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Temperature sampling restricted to top-k and/or nucleus top-p.

    top_k <= 0 disables the k cut; top_p >= 1 disables the nucleus cut;
    temperature <= 0 is exact argmax (no draw). Same thresholds as the JAX
    function: a logit survives if it is >= both the k-th largest and the
    logit at which the sorted cumulative probability first reaches top_p."""
    logits = logits.float()
    if temperature <= 0:
        return sample_argmax(logits)
    V = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    k = V if top_k <= 0 else min(max(int(top_k), 1), V)
    kth = desc[..., k - 1]
    temp = max(float(temperature), 1e-6)
    if top_p >= 1.0:
        pth = desc[..., -1]
    else:
        probs = torch.softmax(desc / temp, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        cut = torch.sum(csum < max(float(top_p), 0.0), dim=-1).clamp(0, V - 1)
        pth = torch.gather(desc, -1, cut[..., None])[..., 0]
    thresh = torch.maximum(kth, pth)
    masked = torch.where(logits >= thresh[..., None], logits,
                         torch.full_like(logits, float("-inf")))
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(masked / temp + gumbel, dim=-1)
