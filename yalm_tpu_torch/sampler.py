"""Sampling on the logits' device (port of `yalm_tpu/sampler.py`).

Random draws are Gumbel-max (argmax(logits/T + Gumbel noise) is a draw
from softmax(logits/T)), so a sampled token stays on the device until the
caller reads it. The engine draws its noise from an explicit
`torch.Generator`; the scheduler's batched `sample_rows` from a
counter-based hash of (request seed, absolute position, vocabulary index),
the role of JAX's fold_in(PRNGKey(seed), pos) (`yalm_tpu/scheduler.py:69`):
a lane's draw depends on nothing else, not its lane or its batch-mates, and
is the same on the CPU and on the card. The JAX package draws from its own
key stream: the two give the same distribution, not the same bits.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def sample_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy pick."""
    return torch.argmax(logits, dim=-1)


def logprob_of(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """log p(token | logits) for each row (the perplexity primitive)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, token.long()[..., None])[..., 0]


def _envelope(logits: torch.Tensor, temp: torch.Tensor, top_k: torch.Tensor,
              top_p: torch.Tensor) -> torch.Tensor:
    """The logits that survive top-k and nucleus top-p, -inf elsewhere, with
    per-row (or broadcast scalar) temp (> 0), top_k and top_p: the JAX
    function's thresholds (sampler.py:65-85). A logit survives if it is >=
    both the k-th largest and the logit at which the sorted cumulative
    probability first reaches top_p."""
    V = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k <= 0, torch.full_like(top_k, V), top_k.clamp(1, V))
    kth = torch.gather(desc, -1, (k - 1)[..., None].expand(*desc.shape[:-1], 1))[..., 0]
    probs = torch.softmax(desc / temp[..., None], dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    cut = torch.sum(csum < top_p.clamp(0.0, 1.0)[..., None], dim=-1).clamp(0, V - 1)
    pth = torch.gather(desc, -1, cut[..., None])[..., 0]
    pth = torch.where(top_p >= 1.0, desc[..., -1], pth)
    thresh = torch.maximum(kth, pth)
    return torch.where(logits >= thresh[..., None], logits,
                       torch.full_like(logits, float("-inf")))


def sample_ext(logits: torch.Tensor, generator: torch.Generator | None,
               temperature: float, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Temperature sampling restricted to top-k and/or nucleus top-p.

    top_k <= 0 disables the k cut; top_p >= 1 disables the nucleus cut;
    temperature <= 0 is exact argmax (no draw)."""
    logits = logits.float()
    if temperature <= 0:
        return sample_argmax(logits)
    dev = logits.device
    temp = torch.tensor(max(float(temperature), 1e-6), device=dev)
    masked = _envelope(logits, temp, torch.tensor(int(top_k), device=dev),
                       torch.tensor(float(top_p), device=dev))
    u = torch.rand(logits.shape, generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(masked / temp + gumbel, dim=-1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32), every product below 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer: a bijection that mixes every bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_rows(seeds: torch.Tensor, positions: torch.Tensor, V: int,
                 purpose: int = 0) -> torch.Tensor:
    """(B, V) f32 uniforms in (0, 1), each a function of (seed, position,
    purpose, vocabulary index) alone: 24 hashed bits per value. Purpose 0 is
    the plain tick's draw; speculation's verify draws its accept uniform,
    residual and bonus from purposes 1, 2 and 3 (independent streams, as
    the JAX scheduler folds 1/2/3 into its key, scheduler.py:178-186)."""
    dev = seeds.device
    key = _fmix32(_fmix32(seeds.long() & _M32) ^ (positions.long() & _M32))
    if purpose:
        key = _fmix32((key + purpose * 0x9E3779B9) & _M32)
    idx = _fmix32(torch.arange(V, dtype=torch.int64, device=dev) * 2 + 1)
    bits = _fmix32(key[:, None] ^ idx[None, :]) >> 8
    return (bits.float() + 0.5) * (1.0 / (1 << 24))


def sample_rows(logits: torch.Tensor, seeds: torch.Tensor, positions: torch.Tensor,
                temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """The batched sample_ext of the scheduler's tick: logits (B, V), every
    other argument a (B,) tensor on the logits' device. Row b draws from its
    own (seed, position) stream; rows with temperature <= 0 take the exact
    argmax."""
    logits = logits.float()
    temp = temperature.float().clamp_min(1e-6)
    masked = _envelope(logits, temp, top_k.long(), top_p.float())
    u = uniform_rows(seeds, positions, logits.shape[-1])
    sampled = torch.argmax(masked / temp[:, None] - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temperature > 0, sampled, torch.argmax(logits, dim=-1))
