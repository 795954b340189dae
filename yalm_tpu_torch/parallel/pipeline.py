"""Pipeline parallelism: the layer-sharded, microbatch-pipelined decode tick
(port of `yalm_tpu/parallel/pipeline.py`).

The stacked-layer layout (every per-layer tensor is (n_layers, ...)) makes
pipeline sharding a split of the LAYER axis over a 'pp' mesh axis: each rank
holds n_layers/pp contiguous layers and the cache slots of exactly those
layers, with no weight collective at all; only (B/pp, dim) activation
blocks move between neighbours (`Mesh.shift`, JAX's ppermute).

The tick pipelines GPipe-style: B lanes split into pp microbatches; over
2 pp - 1 rotations stage p runs microbatch t - p through its layers and
passes the residual stream on to stage p + 1. A step outside 0 <= t - p < pp
is a bubble: it writes nothing, and since a bubble only ever feeds a bubble
a rank skips its compute and sends zeros, while every rank still meets each
shift. The last stage banks its rows; one sum over pp hands them to every
rank, which unembeds all B lanes once. Dense models, one host.

Each layer runs the single-device tick's kernels at B/pp rows: the wqkv and
wo projections (`_proj_l`: K1 gemm_l, K5 gemm4_l on packed int4), K8
attend_step_batched_l over the stage's cache slice with the layer's Gemma
forms indexed by its GLOBAL id, and K4 ffn_l (without sandwich norms and
int4; else w13, the GLU and w2 through `_proj_l`, as JAX's); the LM head is
K1 gemm over the B rows.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import KV_SINKS, ModelConfig
from ..models.cache import KVCache
from ..models.fast import (FastScales, FastWeights, _attn_kw, _cap_logits, _clip, _embed,
                           _host_ints, _post_norm, _proj_l, _qk_norm, _tick_lanes)
from ..models.weights import Weights
from ..ops.core import act_fn, rmsnorm
from ..ops.cuda.attention import attend_step_batched
from ..ops.cuda.ffn import ffn
from ..ops.cuda.gemv import gemm, is_int4
from .mesh import Mesh
from .sharding import take_shard


def pp_supported(cfg: ModelConfig, pp: int, batch: int) -> bool:
    """Dense models whose layers and lanes split pp ways (pipeline.py:45);
    the layer split leaves every (N, K) whole, so every weight type the
    single-device tick runs, packed int4 included."""
    return not cfg.is_moe and pp >= 1 and cfg.n_layers % pp == 0 and batch % pp == 0


_LAYERS = ("rms_att", "rms_ffn", "wqkv", "wo", "w13", "w2", "bqkv", "qnorm", "knorm",
           "pa", "pf")


def pp_weight_splits(cfg: ModelConfig, with_scales: bool = False) -> dict:
    """The pipeline's FastWeights table (pipeline.py:52 pp_weight_pspecs):
    every layer stack splits its LAYER axis over pp; the embedding, the
    final norm and the LM head are replicated (stage 0 embeds, every rank
    unembeds). The int4 group scales (L, G, N) stay layer-major, so the same
    split applies."""
    lay = ((0, "pp"),)
    table = {f.name: (lay if f.name in _LAYERS else ()) for f in dataclasses.fields(FastWeights)
             if f.name != "scales"}
    if with_scales:
        table["scales"] = {f.name: (lay if f.name in ("wqkv", "wo", "w13", "w2") else ())
                           for f in dataclasses.fields(FastScales)}
    return table


def shard_pp_weights(weights, cfg: ModelConfig, mesh: Mesh) -> FastWeights:
    """This rank's stage (pipeline.py:91): its n_layers/pp layers of the
    whole model's FastWeights (or oracle Weights, concatenated first) and
    the replicated embedding, norm and head, on the rank's device (a tied
    head stays shared with the embedding)."""
    if isinstance(weights, Weights):
        weights = FastWeights.from_weights(weights, cfg)
    table = pp_weight_splits(cfg, with_scales=weights.scales is not None)

    def cut(x, splits):
        return take_shard(x, splits, mesh.shape, mesh.coords).contiguous().to(mesh.device)
    kw = {f.name: cut(getattr(weights, f.name), table[f.name])
          for f in dataclasses.fields(FastWeights)
          if f.name != "scales" and getattr(weights, f.name) is not None}
    if weights.lm_head is weights.embed:
        kw["lm_head"] = kw["embed"]
    sc = weights.scales
    if sc is not None:
        kw["scales"] = FastScales(**{
            g.name: cut(getattr(sc, g.name), table["scales"][g.name])
            for g in dataclasses.fields(FastScales) if getattr(sc, g.name) is not None})
        if sc.lm_head is sc.embed:
            kw["scales"].lm_head = kw["scales"].embed
    return FastWeights(**kw)


def pp_cache_splits() -> tuple:
    """The batched cache (B, n_layers, S, Hk, D): the layer axis on pp
    (pipeline.py:102 pp_cache_pspecs)."""
    return ((1, "pp"),)


def shard_pp_cache(cache: KVCache, mesh: Mesh) -> KVCache:
    """This rank's layers of a whole batched cache, on its device
    (pipeline.py:108)."""
    return KVCache(*(take_shard(c, pp_cache_splits(), mesh.shape, mesh.coords)
                     .contiguous().to(mesh.device) for c in (cache.k, cache.v)))


def make_tick_pp(cfg: ModelConfig, mesh: Mesh, batch: int):
    """tick(fw, tokens (B,), positions (B,), cache, write_mask (B,)) ->
    (logits (B, V) on every rank, cache) pipelined over the mesh's 'pp'
    axis (pipeline.py:114). fw and cache are this rank's stage
    (shard_pp_weights, shard_pp_cache: (B, n_layers/pp, S, Hk, D), updated
    IN PLACE); positions and the write mask are host values."""
    if set(mesh.shape) != {"pp"}:
        raise ValueError(f"the pipelined tick runs on a ('pp',) mesh, got {mesh.shape}")
    pp, p = mesh.shape["pp"], mesh.coords["pp"]
    if not pp_supported(cfg, pp, batch):
        raise ValueError(f"the pipelined tick does not take this model at pp={pp}, batch "
                         f"{batch} (dense models, n_layers and the batch divisible by pp)")
    B, Bm = batch, batch // pp
    nl_l = cfg.n_layers // pp
    Hk, D = cfg.n_kv_heads, cfg.head_dim
    qpk = cfg.n_heads // Hk
    q_dim, kv_dim, H = cfg.q_dim, cfg.kv_dim, cfg.hidden_dim
    act = act_fn(cfg.act_type)
    rope = dict(kv_sinks=KV_SINKS, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)

    def stage(fw: FastWeights, x, kc, vc, lanes):
        """This rank's nl_l layers on one (Bm, dim) microbatch; the weights
        index by the LOCAL layer, the Gemma forms by the GLOBAL one."""
        sc = fw.scales
        for i in range(nl_l):
            xb = rmsnorm(x, fw.rms_att[i], cfg.norm_eps)
            qkv = _proj_l(xb, fw.wqkv, i, sc.wqkv if sc else None)
            if fw.bqkv is not None:
                qkv = qkv + fw.bqkv[i]
            qkv = _clip(cfg, qkv)
            q, k = _qk_norm(qkv[:, :q_dim], qkv[:, q_dim:q_dim + kv_dim], fw, i, cfg)
            mixed = attend_step_batched(
                q.reshape(Bm, Hk, qpk, D), k.reshape(Bm, Hk, D),
                qkv[:, q_dim + kv_dim:].reshape(Bm, Hk, D), kc, vc, i, lanes, **rope,
                **_attn_kw(cfg, p * nl_l + i))
            x = x + _post_norm(_proj_l(mixed.reshape(Bm, q_dim), fw.wo, i,
                                       sc.wo if sc else None), fw.pa, i, cfg.norm_eps)
            if fw.pf is None and not is_int4(fw.wqkv):
                x = ffn(x, fw.rms_ffn, fw.w13, fw.w2, i, sc.w13 if sc else None,
                        sc.w2 if sc else None, norm_eps=cfg.norm_eps, act=cfg.act_type)
            else:
                xb2 = rmsnorm(x, fw.rms_ffn[i], cfg.norm_eps)
                h13 = _proj_l(xb2, fw.w13, i, sc.w13 if sc else None)
                h = act(h13[:, :H]) * h13[:, H:]
                x = x + _post_norm(_proj_l(h, fw.w2, i, sc.w2 if sc else None), fw.pf, i,
                                   cfg.norm_eps)
        return x

    def tick(fw: FastWeights, tokens, positions, cache: KVCache, write_mask=None):
        dev = fw.wqkv.device
        pos = _host_ints(positions, B)
        wr = None if write_mask is None else _host_ints(write_mask, B)
        if cache.k.dim() != 5 or tuple(cache.k.shape[:2]) != (B, nl_l):
            raise ValueError(f"pipelined tick: cache {tuple(cache.k.shape)} vs {B} lanes of "
                             f"{nl_l} layers")
        tok = tokens if isinstance(tokens, torch.Tensor) else _host_ints(tokens, B)
        xbuf = torch.zeros((Bm, cfg.dim), dtype=torch.float32, device=dev)
        xdrain = torch.zeros((B, cfg.dim), dtype=torch.float32, device=dev)
        for t in range(2 * pp - 1):
            mb = t - p
            if 0 <= mb < pp:
                sl = slice(mb * Bm, (mb + 1) * Bm)
                x_in = _embed(cfg, fw, tok[sl]) if p == 0 else xbuf
                lanes = _tick_lanes(cfg, pos[sl], None if wr is None else wr[sl], dev)
                x_out = stage(fw, x_in, cache.k[sl], cache.v[sl], lanes)
                if p == pp - 1:
                    xdrain[sl] = x_out
            else:   # a bubble: nothing to compute, nothing written
                x_out = torch.zeros_like(xbuf)
            if t + 1 < 2 * pp - 1:   # the last rotation's send would go unread
                xbuf = mesh.shift(x_out, "pp")
        # only the last stage banked rows: the (B, dim) sum hands them to
        # every rank, which unembeds once
        xn = rmsnorm(mesh.all_reduce(xdrain, "pp"), fw.final_norm, cfg.norm_eps)
        sc = fw.scales
        return _cap_logits(cfg, gemm(xn, fw.lm_head, sc.lm_head if sc else None)), cache

    return tick
