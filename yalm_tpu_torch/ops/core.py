"""Core numeric ops in plain PyTorch (port of `yalm_tpu/ops/core.py`).

RMSNorm, interleaved-pair RoPE with every packed `rope_param` scaling kind,
the activations and the MoE router's top-k gate. Everything computes in
float32, with the same order of operations as the JAX functions, so the
two packages agree to float32 rounding on the same inputs.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # the masking constant of every attention path (not -inf)


def int_view(t: torch.Tensor) -> torch.Tensor:
    """A same-width integer view: copies, gathers and scatters of fp8
    tensors go through it (not every backend indexes fp8)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last axis: x * rsqrt(mean(x^2) + eps) * weight
    (eps inside the root, as the reference does)."""
    x = x.float()
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * weight.float()


def decode_rope_param(theta) -> tuple[float, tuple]:
    """`theta` at every rope site is a plain float (no scaling) or the packed
    tuple ModelConfig.rope_param = (kind, theta, *scaling_params)."""
    if isinstance(theta, tuple):
        return float(theta[1]), (theta[0],) + tuple(theta[2:])
    return float(theta), ()


def rope_mscale(theta) -> float:
    """YaRN's attention-scaling factor (multiplies cos/sin); 1.0 otherwise."""
    _, scale = decode_rope_param(theta)
    if scale and scale[0] == "yarn":
        return float(scale[4])
    return 1.0


def rope_rotation_param(theta):
    """The same packed theta with YaRN's mscale forced to 1: for rotating
    already-written cache keys (sink view), where the mscale was applied at
    write time and must not compound."""
    if isinstance(theta, tuple) and theta[0] == "yarn":
        return theta[:5] + (1.0,)
    return theta


def scale_inv_freq(freq: torch.Tensor, rope_scale: tuple,
                   j: torch.Tensor | None = None) -> torch.Tensor:
    """Apply a RoPE frequency-scaling scheme elementwise: linear, the
    Llama-3.1 piecewise remap, or YaRN's ramp over the pair index."""
    if not rope_scale:
        return freq
    kind = rope_scale[0]
    if kind == "linear":
        return freq / rope_scale[1]
    if kind == "llama3":
        _, factor, lo_f, hi_f, orig = rope_scale
        two_pi = 2.0 * math.pi
        wavelen = two_pi / torch.clamp(freq, min=1e-30)
        low_wl = orig / lo_f
        high_wl = orig / hi_f
        smooth = torch.clamp((orig / wavelen - lo_f) / (hi_f - lo_f), 0.0, 1.0)
        scaled = (1.0 - smooth) * freq / factor + smooth * freq
        out = torch.where(wavelen > low_wl, freq / factor,
                          torch.where(wavelen < high_wl, freq, scaled))
        return torch.where(freq == 0.0, torch.zeros_like(out), out)
    if kind == "yarn":
        _, factor, low, high, _ms = rope_scale
        if j is None:
            raise ValueError("yarn scaling needs the pair index array")
        i = j.float() / 2.0
        ramp = torch.clamp((i - low) / max(high - low, 1e-3), 0.0, 1.0)
        return freq * (1.0 - ramp) + (freq / factor) * ramp
    raise ValueError(f"unknown rope scaling {kind!r}")


def _pair_base(th: float, rotary_dim: int, j: torch.Tensor) -> torch.Tensor:
    log_th = torch.log(torch.tensor(th, dtype=torch.float32, device=j.device))
    return torch.where(j >= rotary_dim, torch.zeros_like(j),
                       torch.exp(-log_th * j / rotary_dim))


def rope_pair_freqs(theta, rotary_dim: int, j: torch.Tensor,
                    alt=None) -> torch.Tensor:
    """Inverse frequencies for pair-start indices j (0, 2, 4, ...); pairs at
    j >= rotary_dim get frequency 0 (partial rotary). Applies any packed
    scaling. For the "gemma3" kind, `alt` != 0 selects the local theta."""
    th, scale = decode_rope_param(theta)
    freq = _pair_base(th, rotary_dim, j)
    if scale and scale[0] == "gemma3":
        _, factor, th_local = scale
        f_global = freq / factor
        if alt is None or int(alt) == 0:
            return f_global
        return _pair_base(th_local, rotary_dim, j)
    return scale_inv_freq(freq, scale, j)


def rope_freq_table(theta, head_dim: int, rotary_dim: int, alt=None,
                    device=None) -> torch.Tensor:
    """(head_dim // 2,) f32 pair frequencies: what the attention kernel
    takes, so the scaling kinds live here only."""
    j = 2.0 * torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    return rope_pair_freqs(theta, rotary_dim, j, alt)


def rotate_pairs(x: torch.Tensor, ang: torch.Tensor, mscale: float) -> torch.Tensor:
    """Rotate interleaved pairs (2p, 2p+1) of x[..., D] by angles
    ang[..., D/2] (broadcast), with cos/sin scaled by mscale."""
    cos, sin = mscale * torch.cos(ang), mscale * torch.sin(ang)
    xr = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(x.shape)


def apply_rope(x: torch.Tensor, positions, theta, rotary_dim: int,
               alt=None) -> torch.Tensor:
    """Interleaved RoPE on x[..., n_heads, head_dim] at positions[...].

    positions broadcasts against x's leading axes (a scalar for one decode
    token, a vector for a prefill chunk). Not HF's half split: pair p is
    elements (2p, 2p+1)."""
    orig_dtype = x.dtype
    x = x.float()
    freq = rope_freq_table(theta, x.shape[-1], rotary_dim, alt, x.device)
    pos = torch.as_tensor(positions, dtype=torch.float32, device=x.device)
    ang = (pos[..., None] * freq)[..., None, :]  # broadcast over heads
    return rotate_pairs(x, ang, rope_mscale(theta)).to(orig_dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approx GELU with the reference's constants."""
    return 0.5 * x * (1.0 + torch.tanh(0.797885 * (x + 0.044715 * x * x * x)))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def act_fn(name: str):
    return {"gelu": gelu, "silu": silu}[name]


def moe_gate(router_logits: torch.Tensor, n_active: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing with a softmax over the chosen experts only (the
    reference's normalise-over-top-k, src/infer.cpp:100-132).

    Returns (weights[..., n_active], indices[..., n_active]) ranked highest
    first, as jax.lax.top_k ranks them: single-stream decode adds the
    experts to the residual in that order. exp(top - global max) keeps it
    stable."""
    top_vals, top_idx = torch.topk(router_logits, n_active, dim=-1, sorted=True)
    m = torch.amax(router_logits, dim=-1, keepdim=True)
    e = torch.exp(top_vals - m)
    return e / torch.sum(e, dim=-1, keepdim=True), top_idx
