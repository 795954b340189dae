"""The parity oracle: the transformer's forward pass in plain torch (port of
`yalm_tpu/models/transformer.py`), on any device.

GQA attention with interleaved partial RoPE, qkv clipping, the
sliding-window KV ring buffer with StreamingLLM attention sinks (rotated
lazily in a view), RMSNorm, SwiGLU/GeGLU and MoE FFNs, Qwen2 biases, Qwen3
qk-norm, Gemma2's sandwich norms and softcaps, sliding layers masked by slot
age and Gemma3's dual rope. Weights (`models/weights.py:Weights`) are
widened to `compute_dtype` at use (f32 by default; bf16 rounds the
operands as the kernels do) and every product sums in f32. The cache, of
any floating type (f32, f16, bf16, e5m2), is updated IN PLACE, as on the
kernel path.

`decode_step(capture=True)` also returns the per-layer activation map that
`utils/debug.py:diff_captures` compares with the kernel path's
(`models/fast.py:decode_step_fast(capture=True)`).

On a mesh, `shard` (parallel/oracle.OracleShard) is one rank's hook: the
weights and the cache are the rank's cut, and the hook adds the sums GSPMD
inserts in JAX's sharded oracle (the embedding over tp, the wo and w2
partials over tp, an MoE layer's expert deltas over ep and tp, the logits'
vocab slices gathered over tp).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import KV_SINKS, ModelConfig
from ..ops.attention import attend_chunk, attend_one
from ..ops.core import (act_fn, apply_rope, f32_matmul, int_view, moe_gate, rmsnorm,
                        rope_rotate_cached)
from .cache import KVCache
from .weights import LayerWeights, Weights


def _dq(w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Weight-only dequantization: the stored type -> the compute type,
    held in f32 for the product."""
    return w.to(compute_dtype).float()


def _proj(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x[..., in] @ w[out, in]^T -> [..., out] f32, both operands in the
    compute type."""
    with f32_matmul():
        return torch.matmul(x.to(compute_dtype).float(), _dq(w, compute_dtype).T)


def _clip(x: torch.Tensor, limit: float) -> torch.Tensor:
    if math.isinf(limit):
        return x
    return torch.clamp(x, -limit, limit)


def _layer(lw: LayerWeights, i: int) -> LayerWeights:
    """Layer i's slice of every stacked field."""
    return LayerWeights(*(None if a is None else a[i] for a in lw))


def _qkv(xb: torch.Tensor, lw: LayerWeights, cfg: ModelConfig, compute_dtype):
    """Q/K/V projections with the optional Qwen2 biases (before the clip)
    and Qwen3 qk-norm (after it, before RoPE)."""
    q = _proj(xb, lw.wq, compute_dtype)
    k = _proj(xb, lw.wk, compute_dtype)
    v = _proj(xb, lw.wv, compute_dtype)
    if lw.bq is not None:
        q, k, v = q + lw.bq, k + lw.bk, v + lw.bv
    q, k, v = (_clip(a, cfg.qkv_clip) for a in (q, k, v))
    if lw.qn is not None:
        D = cfg.head_dim
        q = rmsnorm(q.reshape(*q.shape[:-1], cfg.n_heads, D), lw.qn, cfg.norm_eps).reshape(q.shape)
        k = rmsnorm(k.reshape(*k.shape[:-1], cfg.n_kv_heads, D), lw.kn,
                    cfg.norm_eps).reshape(k.shape)
    return q, k, v


def _ffn(xb: torch.Tensor, w1, w2, w3, act: str, compute_dtype) -> torch.Tensor:
    """GLU feed-forward w2(act(w1 x) * w3 x)."""
    h1 = _proj(xb, w1, compute_dtype)
    h3 = _proj(xb, w3, compute_dtype)
    return _proj(act_fn(act)(h1) * h3, w2, compute_dtype)


def _moe_ffn(cfg: ModelConfig, xb: torch.Tensor, lw: LayerWeights, compute_dtype,
             shard=None) -> torch.Tensor:
    """The top-k expert mixture of rows xb[..., dim]: the router, the gate
    over the chosen experts, each chosen expert's FFN on its rows, and the
    gated deltas summed in rank order. On a mesh the rank runs its experts
    (global ids e0..) on its hidden slice, and the deltas are summed over ep
    and tp before the gates weigh them."""
    rows = xb.reshape(-1, xb.shape[-1])
    router = _proj(rows, lw.moegate, compute_dtype)            # (R, n_experts)
    gates, idx = moe_gate(router, cfg.n_experts_active)        # (R, k)
    deltas = torch.zeros(rows.shape[0], cfg.n_experts_active, rows.shape[1],
                         dtype=torch.float32, device=rows.device)
    e0 = shard.e0 if shard is not None else 0
    for e in range(lw.w1.shape[0]):
        r, j = torch.nonzero(idx == e0 + e, as_tuple=True)
        if len(r):
            deltas[r, j] = _ffn(rows[r], lw.w1[e], lw.w2[e], lw.w3[e], cfg.act_type,
                                compute_dtype)
    if shard is not None:
        deltas = shard.reduce_experts(deltas)
    return torch.sum(gates[..., None] * deltas, dim=1).reshape(xb.shape)


def _ffn_delta(cfg: ModelConfig, xb: torch.Tensor, lw: LayerWeights, compute_dtype,
               shard=None) -> torch.Tensor:
    """The FFN's delta (before the sandwich norm): on a mesh summed over the
    ranks' hidden slices (and experts)."""
    if cfg.is_moe:
        return _moe_ffn(cfg, xb, lw, compute_dtype, shard)
    out = _ffn(xb, lw.w1, lw.w2, lw.w3, cfg.act_type, compute_dtype)
    return out if shard is None else shard.reduce(out)


def _wo_delta(mixed: torch.Tensor, lw: LayerWeights, compute_dtype, shard=None):
    """The attention's delta (before the sandwich norm): on a mesh the
    rank's q columns through its wo columns, summed over tp."""
    if shard is None:
        return _proj(mixed, lw.wo, compute_dtype)
    return shard.reduce(_proj(mixed[..., shard.q_cols], lw.wo, compute_dtype))


def _embed(cfg: ModelConfig, weights: Weights, tokens, shard=None) -> torch.Tensor:
    """(..., dim) f32 embedding rows (the gather through an integer view:
    not every backend indexes fp8); on a mesh the rank's vocab rows, zero
    elsewhere, summed over tp (exact: one rank holds each row)."""
    idx = _ids(tokens, weights.embed.device)
    if shard is not None:
        idx, mine = shard.vocab_rows(idx)
    x = int_view(weights.embed)[idx].view(weights.embed.dtype).float()
    x = x * cfg.embed_scale if cfg.embed_scale != 1.0 else x
    if shard is not None:
        x = shard.reduce(torch.where(mine[..., None], x, torch.zeros_like(x)))
    return x


def _ids(tokens, device) -> torch.Tensor:
    """Token ids (host values or a tensor on the weights' device) as int64."""
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=device)


def _alt(cfg: ModelConfig, i: int) -> Optional[int]:
    """Gemma3's dual rope: the sliding flag selects the local theta."""
    g3 = bool(cfg.rope_scale) and cfg.rope_scale[0] == "gemma3"
    return int(bool(cfg.layer_sliding) and cfg.layer_sliding[i]) if g3 else None


def _sliding(cfg: ModelConfig, i: int) -> bool:
    return bool(cfg.layer_sliding) and bool(cfg.layer_sliding[i])


def _head(cfg: ModelConfig, weights: Weights, xn: torch.Tensor, compute_dtype,
          shard=None) -> torch.Tensor:
    """The capped logits; on a mesh the rank's vocab slice, capped, then
    gathered into the full row."""
    logits = _proj(xn, weights.lm_head, compute_dtype)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits if shard is None else shard.gather(logits)


def _write_rows(c: torch.Tensor, at, rows: torch.Tensor) -> None:
    """Rows rounded to the cache type, written in place through integer
    views."""
    int_view(c)[at] = int_view(rows.to(c.dtype))


# ---------------------------------------------------------------------------
# single-token decode step
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, weights: Weights, token, pos: int, cache: KVCache, *,
                output_logits: bool = True, compute_dtype=torch.float32, capture: bool = False,
                shard=None):
    """One decode step at absolute position `pos` (transformer.py:121-241);
    updates `cache` ((n_layers, L, Hk, D), any floating type) in place and
    returns (logits (vocab,) f32 or None, cache), or with capture=True
    (logits, cache, capture map): per layer (stacked over the layers)
    att_in, post-rope q and k, v, att_mix, ffn_in and block_out, plus
    final_norm and logits when output_logits.

    The ring buffer and attention sinks: once pos reaches the window the
    first KV_SINKS slots freeze and the rest is replaced in ring order;
    attention reads the sink keys rotated forward by max(0, pos - L + 1) in
    an f32 view. Sliding layers mask by slot age.

    shard: one rank's hook on a mesh (parallel/oracle.OracleShard; not
    with capture): the weights and cache are the rank's cut, the logits
    full rows on every rank."""
    if shard is not None:
        if capture:
            raise ValueError("capture runs on one device")
        cfg = shard.cfg
    L = cfg.max_seq_len
    pos = int(pos)
    dev = weights.embed.device
    x = _embed(cfg, weights, token, shard).reshape(cfg.dim)
    kv_sink = KV_SINKS if pos >= L else 0
    kv_pos = kv_sink + (pos - kv_sink) % (L - kv_sink)
    kv_len = min(pos + 1, L)
    s_idx = torch.arange(L, device=dev)
    slot_valid = s_idx < kv_len
    if any(cfg.layer_sliding):
        age = torch.where(s_idx < kv_sink, L - 1 - s_idx,
                          torch.remainder(kv_pos - s_idx, max(L - kv_sink, 1)))
        sliding_valid = slot_valid & (age < cfg.sliding_window)
    else:
        sliding_valid = slot_valid
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rot = max(pos - L + 1, 0)
    recs: list[dict] = []

    for i in range(cfg.n_layers):
        lw = _layer(weights.layers, i)
        alt = _alt(cfg, i)
        xb = rmsnorm(x, lw.rms_att, cfg.norm_eps)
        q, k, v = _qkv(xb, lw, cfg, compute_dtype)
        q = apply_rope(q.reshape(Hq, D), pos, cfg.rope_param, cfg.rotary_dim, alt)
        k = apply_rope(k.reshape(Hk, D), pos, cfg.rope_param, cfg.rotary_dim, alt)
        v = v.reshape(Hk, D)
        kc, vc = cache.k[i], cache.v[i]
        _write_rows(kc, kv_pos, k)
        _write_rows(vc, kv_pos, v)
        k_view = kc.to(torch.float32, copy=True)   # a view: the cache keeps the sinks as written
        if kv_sink:
            k_view[:kv_sink] = rope_rotate_cached(k_view[:kv_sink], cfg.rope_param,
                                                  cfg.rotary_dim, rot, alt)
        valid = sliding_valid if _sliding(cfg, i) else slot_valid
        mixed = attend_one(q.reshape(Hk, Hq // Hk, D), k_view, vc, valid,
                           softcap=cfg.attn_softcap).reshape(cfg.q_dim)
        delta = _wo_delta(mixed, lw, compute_dtype, shard)
        if lw.pa is not None:   # Gemma2's sandwich norm on the attention delta
            delta = rmsnorm(delta, lw.pa, cfg.norm_eps)
        x = x + delta
        xb2 = rmsnorm(x, lw.rms_ffn, cfg.norm_eps)
        delta = _ffn_delta(cfg, xb2, lw, compute_dtype, shard)
        if lw.pf is not None:
            delta = rmsnorm(delta, lw.pf, cfg.norm_eps)
        x = x + delta
        if capture:
            recs.append({"att_in": xb, "q": q, "k": k, "v": v, "att_mix": mixed,
                         "ffn_in": xb2, "block_out": x})

    cap = {name: torch.stack([r[name] for r in recs]) for name in recs[0]} if capture else None
    if not output_logits:
        return (None, cache, cap) if capture else (None, cache)
    xn = rmsnorm(x, weights.final_norm, cfg.norm_eps)
    logits = _head(cfg, weights, xn, compute_dtype, shard)
    if capture:
        cap["final_norm"] = xn
        cap["logits"] = logits
        return logits, cache, cap
    return logits, cache


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, weights: Weights, tokens, pos0: int, valid_len: int,
            cache: KVCache, *, logits_mode: str = "last", compute_dtype=torch.float32,
            shard=None):
    """A chunk of T tokens (padded; the first valid_len real) at absolute
    positions pos0.. (transformer.py:247-368), inside the window (pos0 + T
    <= L: no ring wraparound and no sink rotation within a chunk). The
    valid rows' k/v are written into the cache in place; attention reads
    the whole window under the causal mask (and the sliding window on
    sliding layers, where the slot index is the position).

    logits_mode: "none" -> (None, cache); "last" -> (vocab,) logits of the
    last valid token; "all" -> (T, vocab); "all_h" -> ((T, vocab), (T, dim)
    post-final-norm rows). shard: one rank's hook on a mesh, as
    decode_step's."""
    if logits_mode not in ("none", "last", "all", "all_h"):
        raise ValueError(f"bad logits_mode {logits_mode!r}")
    if shard is not None:
        cfg = shard.cfg
    L = cfg.max_seq_len
    dev = weights.embed.device
    tok = _ids(tokens, dev).reshape(-1)
    T = tok.shape[0]
    pos0, valid_len = int(pos0), int(valid_len)
    if pos0 < 0 or pos0 + T > L or not 0 < valid_len <= T:
        raise ValueError(f"prefill: chunk {pos0}+{T} (valid {valid_len}) vs window {L}")
    positions = pos0 + torch.arange(T, device=dev)
    x = _embed(cfg, weights, tok, shard)                        # (T, dim)
    att_mask = torch.arange(L, device=dev)[None, :] <= positions[:, None]   # (T, L)
    sliding_mask = att_mask
    if any(cfg.layer_sliding):
        sliding_mask = att_mask & (positions[:, None] - torch.arange(L, device=dev)[None, :]
                                   < cfg.sliding_window)
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = slice(pos0, pos0 + valid_len)

    for i in range(cfg.n_layers):
        lw = _layer(weights.layers, i)
        alt = _alt(cfg, i)
        xb = rmsnorm(x, lw.rms_att, cfg.norm_eps)
        q, k, v = _qkv(xb, lw, cfg, compute_dtype)
        q = apply_rope(q.reshape(T, Hq, D), positions, cfg.rope_param, cfg.rotary_dim, alt)
        k = apply_rope(k.reshape(T, Hk, D), positions, cfg.rope_param, cfg.rotary_dim, alt)
        v = v.reshape(T, Hk, D)
        kc, vc = cache.k[i], cache.v[i]
        _write_rows(kc, rows, k[:valid_len])
        _write_rows(vc, rows, v[:valid_len])
        mask = sliding_mask if _sliding(cfg, i) else att_mask
        mixed = attend_chunk(q.reshape(T, Hk, Hq // Hk, D), kc, vc, mask,
                             softcap=cfg.attn_softcap).reshape(T, cfg.q_dim)
        delta = _wo_delta(mixed, lw, compute_dtype, shard)
        if lw.pa is not None:
            delta = rmsnorm(delta, lw.pa, cfg.norm_eps)
        x = x + delta
        xb2 = rmsnorm(x, lw.rms_ffn, cfg.norm_eps)
        delta = _ffn_delta(cfg, xb2, lw, compute_dtype, shard)
        if lw.pf is not None:
            delta = rmsnorm(delta, lw.pf, cfg.norm_eps)
        x = x + delta

    if logits_mode == "none":
        return None, cache
    if logits_mode == "last":
        xn = rmsnorm(x[valid_len - 1], weights.final_norm, cfg.norm_eps)
        return _head(cfg, weights, xn, compute_dtype, shard), cache
    xn = rmsnorm(x, weights.final_norm, cfg.norm_eps)
    logits = _head(cfg, weights, xn, compute_dtype, shard)
    return ((logits, xn) if logits_mode == "all_h" else logits), cache
