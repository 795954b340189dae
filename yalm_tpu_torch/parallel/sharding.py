"""Where every tensor splits on a mesh (port of
`yalm_tpu/parallel/sharding.py`, whose PartitionSpecs become tables).

A split table maps each field to the (dimension, mesh axis) pairs it is
cut along; a field with no pairs is replicated. Rank (dp, ep, tp) holds
chunk `coords[axis]` of `shape[axis]` equal chunks along each pair's
dimension. The tensor-parallel layout is the Megatron split:

- wq/wk/wv (the fast layout's wqkv, shard-major): output rows on `tp`
- wo: input columns on `tp` -> partial sums, summed over tp
- w1/w3 (w13, shard-major): hidden rows on `tp`; w2: hidden columns on `tp`
- the KV cache: kv heads on `tp` (attention is local to a rank), lanes on `dp`
- embed / lm_head: vocab rows on `tp`
- MoE experts on `ep`, their inner dimensions on `tp` as above

int8 scales follow their weights' output rows; int4 group scales (L, [E,]
G, N) split N for the column-parallel wqkv/w13 and G for the row-parallel
wo/w2 (the local input keeps the global group size: fast_tp_supported).
"""

from __future__ import annotations

import torch

from ..config import ModelConfig


def fast_weight_splits(cfg: ModelConfig, with_scales: bool = False) -> dict:
    """The shard-major FastWeights layout's table (fast_tp.py:95-161):
    field -> ((dim, axis), ...); "scales" -> the FastScales fields' table."""
    e = ((1, "ep"),) if cfg.is_moe else ()
    x = 1 if cfg.is_moe else 0   # the expert axis shifts the inner dims
    table = {
        "embed": ((0, "tp"),), "rms_att": (), "rms_ffn": (),
        "wqkv": ((1, "tp"),), "wo": ((2, "tp"),),
        "w13": e + ((1 + x, "tp"),), "w2": e + ((2 + x, "tp"),),
        "final_norm": (), "lm_head": ((0, "tp"),), "moegate": (),
        "bqkv": ((1, "tp"),), "qnorm": (), "knorm": (), "pa": (), "pf": (),
    }
    if with_scales and cfg.weight_dtype == "int4":
        table["scales"] = {"embed": ((0, "tp"),), "wqkv": ((2, "tp"),), "wo": ((1, "tp"),),
                           "w13": e + ((2 + x, "tp"),), "w2": e + ((1 + x, "tp"),),
                           "lm_head": ((0, "tp"),), "moegate": ()}
    elif with_scales:
        table["scales"] = {"embed": ((0, "tp"),), "wqkv": ((1, "tp"),), "wo": (),
                           "w13": e + ((1 + x, "tp"),), "w2": e,
                           "lm_head": ((0, "tp"),), "moegate": ()}
    return table


def weight_splits(cfg: ModelConfig) -> dict:
    """The oracle Weights layout's table (sharding.py:29-62; leading axis =
    layers): the sharded oracle that reads it is a later slice."""
    e = ((1, "ep"),) if cfg.is_moe else ()
    x = 1 if cfg.is_moe else 0
    return {"embed": ((0, "tp"),), "rms_att": (), "rms_ffn": (),
            "wq": ((1, "tp"),), "wk": ((1, "tp"),), "wv": ((1, "tp"),), "wo": ((2, "tp"),),
            "w1": e + ((1 + x, "tp"),), "w2": e + ((2 + x, "tp"),), "w3": e + ((1 + x, "tp"),),
            "moegate": (), "bq": ((1, "tp"),), "bk": ((1, "tp"),), "bv": ((1, "tp"),),
            "qn": (), "kn": (), "pa": (), "pf": (), "final_norm": (), "lm_head": ((0, "tp"),)}


def cache_splits(batched: bool = False) -> tuple:
    """The KV cache ([B,] L, S, Hk, D): kv heads on tp, lanes on dp."""
    return ((0, "dp"), (3, "tp")) if batched else ((2, "tp"),)


def take_shard(t, splits, shape: dict, coords: dict, what: str = "tensor"):
    """This rank's chunk of t, a torch tensor or a numpy array (a view, so
    a checkpoint mmap's rows are not copied), under a table entry; raises
    where a dimension does not divide."""
    for dim, axis in splits:
        n = shape[axis]
        if t.shape[dim] % n:
            raise ValueError(f"{what}: dimension {dim} of {tuple(t.shape)} does not split "
                             f"{n} ways over {axis}")
        c = t.shape[dim] // n
        t = t[(slice(None),) * dim + (slice(coords[axis] * c, (coords[axis] + 1) * c),)]
    return t


def local_cache_shape(cfg: ModelConfig, shape: dict, batch: int | None = None) -> tuple:
    """The ([B/dp,] L, S, Hk/tp, D) cache a rank holds."""
    full = ((batch,) if batch is not None else ()) + (
        cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    out = list(full)
    for dim, axis in cache_splits(batch is not None):
        if full[dim] % shape[axis]:
            raise ValueError(f"cache dimension {dim} ({full[dim]}) does not split "
                             f"{shape[axis]} ways over {axis}")
        out[dim] = full[dim] // shape[axis]
    return tuple(out)
