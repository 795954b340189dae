"""The sharded parity oracle: `models/transformer.py` on one rank of a
('dp', 'ep', 'tp') mesh (the port of JAX's GSPMD path, `Engine(mesh=,
fast=False)`: yalm_tpu/engine.py:145-190 over parallel/sharding.py's
weight_pspecs and cache_pspecs).

Each rank holds its Megatron cut of the oracle's Weights (sharding.
weight_splits, take_shard): its q heads and kv heads of wq/wk/wv, its wo
columns, its slice of the FFN hidden width, its experts, its vocab rows of
the embedding and the LM head; and its kv heads of the cache. `OracleShard`
is the hook that adds what GSPMD inserts: the embedding rows masked and
summed over tp, the wo and w2 partial sums over tp before the sandwich
norm, an MoE layer's expert deltas summed over ep and tp, and the vocab
slices of the capped logits gathered over tp. Every sum is in f32, so the
logits are the single-device oracle's to the order of f32 summation.

Where tp exceeds n_kv_heads (tp % n_kv_heads == 0), each rank computes the
one kv head its q heads read, and a rank whose q columns cut a head in two
computes the whole heads it touches and keeps its columns for wo: the
numbers are those of GSPMD's result, whatever the cut.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ModelConfig
from ..models.cache import KVCache
from ..models.weights import LayerWeights, Weights
from .fast_tp import TPShard
from .mesh import Mesh, MeshConfig, validate_divisibility
from .sharding import take_shard, weight_splits


class OracleShard(TPShard):
    """The collectives hook of models/transformer.py's decode_step and
    prefill for one rank of a mesh: TPShard's collectives (reduce,
    reduce_experts, vocab_rows, gather), with the rank's head ranges and
    the local config the oracle's reshapes read (`cfg`: its q heads and kv
    heads)."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh):
        tp, ep = mesh.shape["tp"], mesh.shape.get("ep", 1)
        validate_divisibility(cfg, MeshConfig(dp=mesh.shape.get("dp", 1), ep=ep, tp=tp))
        for name, n in (("vocab_size", cfg.vocab_size), ("q_dim", cfg.q_dim),
                        ("kv_dim", cfg.kv_dim)):
            if n % tp:
                raise ValueError(f"tp={tp} does not divide {name}={n}")
        t, D = mesh.coords["tp"], cfg.head_dim
        qpk = cfg.n_heads // cfg.n_kv_heads
        c0, c1 = t * cfg.q_dim // tp, (t + 1) * cfg.q_dim // tp      # this rank's wo columns
        self.h0, self.h1 = c0 // D, -(-c1 // D)                      # the q heads they touch
        self.k0, self.k1 = self.h0 // qpk, (self.h1 - 1) // qpk + 1  # the kv heads those read
        self.q_cols = slice(c0 - self.h0 * D, c1 - self.h0 * D)
        self._place(cfg, mesh)
        self.cfg = dataclasses.replace(cfg, n_heads=self.h1 - self.h0,
                                       n_kv_heads=self.k1 - self.k0)


def shard_oracle_weights(weights: Weights, cfg: ModelConfig, mesh: Mesh) -> Weights:
    """This rank's cut of the whole model's oracle Weights, on its device:
    weight_splits' table, with wq/bq cut to the q heads and wk/wv/bk/bv to
    the kv heads OracleShard names (the table's tp chunks wherever the
    heads divide over tp). A tied head stays shared with the embedding."""
    if not isinstance(weights, Weights):
        raise ValueError("the sharded oracle takes the Weights of models/weights.py:load_weights")
    sh = OracleShard(cfg, mesh)
    table = weight_splits(cfg)
    D = cfg.head_dim
    heads = {"wq": (sh.h0, sh.h1), "bq": (sh.h0, sh.h1), "wk": (sh.k0, sh.k1),
             "wv": (sh.k0, sh.k1), "bk": (sh.k0, sh.k1), "bv": (sh.k0, sh.k1)}

    def cut(name, x):
        if x is None:
            return None
        if name in heads:
            a, b = heads[name]
            x = x[:, a * D:b * D]
        else:
            x = take_shard(x, table[name], mesh.shape, mesh.coords, name)
        return x.contiguous().to(mesh.device)
    layers = LayerWeights(**{f: cut(f, getattr(weights.layers, f))
                             for f in LayerWeights._fields})
    embed = cut("embed", weights.embed)
    lm_head = embed if weights.lm_head is weights.embed else cut("lm_head", weights.lm_head)
    return Weights(embed=embed, layers=layers, final_norm=cut("final_norm", weights.final_norm),
                   lm_head=lm_head)


def oracle_cache(cfg: ModelConfig, mesh: Mesh, kv_dtype=torch.float32) -> KVCache:
    """This rank's cache for the sharded oracle: the kv heads it computes
    (sharding.cache_splits' tp chunk, or the one head a rank reads where tp
    exceeds n_kv_heads)."""
    sh = OracleShard(cfg, mesh)
    return KVCache.init(cfg, kv_dtype, mesh.device, n_kv_heads=sh.k1 - sh.k0)
