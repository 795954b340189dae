"""Sequence-parallel (ring-attention) prefill (port of
`yalm_tpu/parallel/ring.py`).

A long prompt's prefill shards its SEQUENCE over an `sp` mesh axis and runs
blockwise ring attention (Liu et al., arXiv:2310.01889): each rank keeps
its T/sp query rows, the key/value blocks rotate around the ring
(`Mesh.shift`, JAX's ppermute) and the softmax is accumulated online, so
the prefill's operations and activations scale 1/sp while every rank holds
the weights. It composes with tensor parallelism: on an ('sp', 'tp') mesh
each sequence shard splits its heads, hidden width and vocab over tp as
the decode step does (parallel/fast_tp.TPShard: the shard-major
FastWeights of the rank's tp coordinate, replicated over sp; the wo and w2
partials summed over tp). Dense models, the whole prompt at position 0,
T <= the window.

The body follows JAX's step by step, so its numerics are JAX's ring, not
the port's chunk attention: scores of bf16 operands summed in f32, times
1/sqrt(D), the Gemma2 softcap, the causal mask on GLOBAL positions (and on
sliding layers q - k < the window); the running max and sum with guards for
a block a row sees nothing of; p rounded to bf16 unnormalised and o / l
once at the end. The projections run the kernels (`_proj_l`: K1 gemm_l, or
K5 gemm4_l on packed int4) and the LM head K1 gemv on the rank's vocab
slice; the attention's einsums are plain torch, as JAX leaves them to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import ModelConfig
from ..models.cache import KVCache
from ..models.fast import (FastWeights, _cap_logits, _clip, _embed, _layer_alt, _post_norm,
                           _proj_l, _qk_norm, _softcap_scores)
from ..ops.core import act_fn, apply_rope, f32_matmul, int_view, rmsnorm
from ..ops.cuda.gemv import bf16f, gemv
from .fast_tp import TPShard, fast_tp_supported, mesh_weights
from .mesh import Mesh


def ring_supported(cfg: ModelConfig, sp: int, tp: int = 1) -> bool:
    """Dense models whose tp shards fit the kernels (ring.py:46); every
    weight type, packed int4 included."""
    return (sp >= 1 and not cfg.is_moe and fast_tp_supported(cfg, tp)
            and cfg.n_kv_heads % tp == 0)


def _ring_mesh(mesh: Mesh) -> tuple[int, int]:
    if set(mesh.shape) != {"sp", "tp"}:
        raise ValueError(f"the ring prefill runs on an ('sp', 'tp') mesh, got {mesh.shape}")
    return mesh.shape["sp"], mesh.shape["tp"]


def _ring_attn(cfg: ModelConfig, mesh: Mesh, q, k, v, offset: int, sliding: bool):
    """Blockwise causal ring attention (ring.py:75-117): q (T_l, Hk_l, qpk,
    D) stays; the bf16 (k, v) blocks (T_l, Hk_l, D) rotate sp hops (the
    last hop's shift, which only brings them home, is skipped on every
    rank). Returns (T_l, Hk_l, qpk, D) f32."""
    sp, my = mesh.shape["sp"], mesh.coords["sp"]
    T_l, Hk_l, qpk, D = q.shape
    dev = q.device
    qpos = offset + torch.arange(T_l, device=dev)
    scale = 1.0 / math.sqrt(D)
    qb = bf16f(q)
    o = torch.zeros((Hk_l, qpk, T_l, D), dtype=torch.float32, device=dev)
    m = torch.full((Hk_l, qpk, T_l), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((Hk_l, qpk, T_l), dtype=torch.float32, device=dev)
    kc, vc = k, v
    for s in range(sp):
        src = (my - s) % sp                 # whose block this hop holds
        kpos = src * T_l + torch.arange(T_l, device=dev)
        mask = qpos[:, None] >= kpos[None, :]
        if sliding:
            mask &= qpos[:, None] - kpos[None, :] < cfg.sliding_window
        with f32_matmul():
            sc = torch.einsum("tgqd,lgd->gqtl", qb, kc.float()) * scale
        sc = _softcap_scores(cfg, sc)
        sc = torch.where(mask[None, None], sc, torch.full_like(sc, -math.inf))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # exp(-inf - -inf) guards: rows that see nothing of this block
        alpha = torch.exp(torch.where(torch.isfinite(m), m - m_new, torch.full_like(m, -math.inf)))
        p = torch.exp(torch.where(torch.isfinite(sc), sc - m_new[..., None],
                                  torch.full_like(sc, -math.inf)))
        l = l * alpha + p.sum(dim=-1)
        with f32_matmul():
            pv = torch.einsum("gqtl,lgd->gqtd", bf16f(p), vc.float())
        o = o * alpha[..., None] + pv
        m = m_new
        if s + 1 < sp:
            kc, vc = mesh.shift(kc, "sp"), mesh.shift(vc, "sp")
    # the causal self-block guarantees every row saw at least itself
    return (o / l[..., None]).permute(2, 0, 1, 3)


def make_prefill_ring(cfg: ModelConfig, mesh: Mesh):
    """ring_prefill(fw, tokens (T,)) -> (last_logits (V,), chunk_k, chunk_v)
    on this rank of an ('sp', 'tp') mesh (ring.py:53). tokens: the whole
    prompt (host ints or a tensor), T % sp == 0 and T <= the window; the
    rank runs its T/sp rows. fw: the rank's tp shard (shard_ring_weights).
    The last token's logits (the last sequence shard's, gathered over tp)
    reach every rank; chunk_k/chunk_v are the rank's bf16 K/V rows of
    positions [c T/sp, (c+1) T/sp) at its kv heads, (n_layers, T/sp,
    Hk/tp, D): place them with ring_prefill_cache."""
    sp, tp = _ring_mesh(mesh)
    if not ring_supported(cfg, sp, tp):
        raise ValueError(f"the ring prefill does not take this model at sp={sp}, tp={tp} "
                         "(dense models whose tp shards fit the kernels)")
    shard = TPShard(cfg, mesh)
    lc = shard.cfg
    Hq_l, Hk_l, D = lc.n_heads, lc.n_kv_heads, cfg.head_dim
    q_l, kv_l, h_l = lc.q_dim, lc.kv_dim, lc.hidden_dim
    qpk = Hq_l // Hk_l
    act = act_fn(cfg.act_type)
    my = mesh.coords["sp"]

    def reduce_tp(t):
        return shard.reduce(t) if tp > 1 else t

    def ring_prefill(fw: FastWeights, tokens):
        dev = fw.wqkv.device
        tok = torch.as_tensor(tokens if isinstance(tokens, torch.Tensor)
                              else np.asarray(tokens), dtype=torch.long).reshape(-1)
        T = tok.shape[0]
        if T % sp or not 0 < T <= cfg.max_seq_len:
            raise ValueError(f"ring prefill: T={T} must split {sp} ways and fit the window "
                             f"{cfg.max_seq_len}")
        T_l = T // sp
        offset = my * T_l
        positions = offset + torch.arange(T_l, device=dev)
        sc = fw.scales
        x = _embed(cfg, fw, tok[offset:offset + T_l].to(dev), shard)     # (T_l, dim)
        k_out = torch.empty((cfg.n_layers, T_l, Hk_l, D), dtype=torch.bfloat16, device=dev)
        v_out = torch.empty_like(k_out)
        for i in range(cfg.n_layers):
            xb = rmsnorm(x, fw.rms_att[i], cfg.norm_eps)
            qkv = _proj_l(xb, fw.wqkv, i, sc.wqkv if sc else None)
            if fw.bqkv is not None:
                qkv = qkv + fw.bqkv[i]
            qkv = _clip(cfg, qkv)
            qf, kf = _qk_norm(qkv[:, :q_l], qkv[:, q_l:q_l + kv_l], fw, i, cfg)
            alt = _layer_alt(cfg, i)
            q = apply_rope(qf.reshape(T_l, Hq_l, D), positions, cfg.rope_param,
                           cfg.rotary_dim, alt)
            k_out[i] = apply_rope(kf.reshape(T_l, Hk_l, D), positions, cfg.rope_param,
                                  cfg.rotary_dim, alt)
            v_out[i] = qkv[:, q_l + kv_l:].reshape(T_l, Hk_l, D)
            sliding = bool(cfg.layer_sliding) and bool(cfg.layer_sliding[i])
            mixed = _ring_attn(cfg, mesh, q.reshape(T_l, Hk_l, qpk, D), k_out[i], v_out[i],
                               offset, sliding)
            x = x + _post_norm(reduce_tp(_proj_l(mixed.reshape(T_l, q_l), fw.wo, i,
                                                 sc.wo if sc else None)),
                               fw.pa, i, cfg.norm_eps)
            xb2 = rmsnorm(x, fw.rms_ffn[i], cfg.norm_eps)
            h13 = _proj_l(xb2, fw.w13, i, sc.w13 if sc else None)
            h = act(h13[:, :h_l]) * h13[:, h_l:]
            x = x + _post_norm(reduce_tp(_proj_l(h, fw.w2, i, sc.w2 if sc else None)),
                               fw.pf, i, cfg.norm_eps)
        # the last token's logits live on the last sequence shard: its tp
        # ranks gather their vocab slices, then a masked sum over sp
        # reaches every rank (ring.py:176-183)
        x_last = rmsnorm(x[-1], fw.final_norm, cfg.norm_eps)
        logits = _cap_logits(cfg, gemv(x_last, fw.lm_head, sc.lm_head if sc else None))
        if tp > 1:
            logits = shard.gather(logits)
        if my != sp - 1:
            logits = torch.zeros_like(logits)
        return mesh.all_reduce(logits, "sp"), k_out, v_out

    return ring_prefill


def shard_ring_weights(weights, cfg: ModelConfig, mesh: Mesh) -> FastWeights:
    """This rank's ring weights (ring.py:194): the tp-shard-major
    FastWeights of its tp coordinate (fast_tp.mesh_weights), the same on
    every sp rank."""
    _ring_mesh(mesh)
    return mesh_weights(cfg, weights, mesh)


def ring_prefill_cache(cfg: ModelConfig, chunk_k, chunk_v, kv_dtype,
                       window_cache: KVCache | None = None, mesh: Mesh | None = None) -> KVCache:
    """The ring prefill's K/V rows placed at slots [0, T) of a window-sized
    single-stream KVCache of kv_dtype (bf16 or e5m2; ring.py:207), on the
    rows' device. With `mesh`, chunk_k/chunk_v are this rank's blocks and
    are first gathered over sp (positions) and tp (kv heads), bit for bit,
    so every rank holds the whole cache; the decode that follows runs on
    one device, as JAX's host hop hands it to one."""
    if mesh is not None:
        chunk_k, chunk_v = (mesh.all_gather(mesh.all_gather(c, "sp", 1), "tp", 2)
                            for c in (chunk_k, chunk_v))
    if chunk_k.shape[1] > cfg.max_seq_len:
        raise ValueError("ring prefill: T must fit the window")
    if window_cache is None:
        window_cache = KVCache.init(cfg, kv_dtype, chunk_k.device)
    T = chunk_k.shape[1]
    for c, rows in ((window_cache.k, chunk_k), (window_cache.v, chunk_v)):
        int_view(c)[:, :T] = int_view(rows.to(c.dtype))
    return window_cache
