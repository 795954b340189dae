"""Tensor, expert and data parallelism on the kernels (port of
`yalm_tpu/parallel/fast_tp.py`: decode, chunked prefill, the batched
tick, the paged pool's tick and prefill, and the speculative verify sweep,
dense and paged).

Each rank runs the SAME step bodies as one device (`models/fast.py`) on its
Megatron shard -- its heads' q/k/v, its slice of the FFN hidden width and of
the vocab, its kv heads of the cache, its experts -- with `TPShard` as the
hook that adds the collectives (fast_tp.py:1-33):

  - one f32 all-reduce over tp of the attention delta after wo, the
    sandwich norm applied after the sum (fast_tp.py:337-338)
  - one after w2 (over tp), or after the MoE sum (over ep and tp)
  - one to assemble the embedding rows (vocab-sharded table, rows masked)
  - one to gather the vocab-sharded logits, capped before the gather: an
    all-reduce of a full row that is zero outside the rank's slice (exact,
    and it runs on gloo, which has no all_gather of CUDA tensors)

so the single-device path and the mesh path cannot drift, and a mesh whose
tp groups are one rank launches exactly what one device launches. The
weights are the single-device FastWeights in SHARD-MAJOR row order (wqkv
rows [wq_0; wk_0; wv_0; wq_1; ...], w13 rows [w1_0; w3_0; ...]), so a
rank's contiguous chunk is its own [q; k; v] stack and the fused kernels
run unchanged at the shard's shapes: attn_block (K3/K6) without its
residual, the GEMVs and GEMMs (K1/K5), ffn (K4/K7), the batched attention
(K8) and the routed experts (K10/K11) of the rank's ep slice.

MoE decode streams only the routed LOCAL experts without reading an id on
the host: a routed id another rank holds becomes -1, which the routed
GEMVs answer with zeros without loading (JAX's lax.cond skip,
fast_tp.py:345-364); the tick and prefill sweep every local expert, as
JAX's do (fast_tp.py:653-662).

Seven factories mirror JAX's (each returns a function over this rank's
weights and cache): make_decode_step_fast_tp, make_prefill_fast_tp and
make_tick_fast_tp (lanes on dp: a rank computes its dp group's lanes and
the logits of all lanes are summed over dp); over a paged pool whose pages
split over dp (each group's page ids local to its shard, page 0 its sink)
and kv heads over tp, make_tick_paged_fast_tp and
make_prefill_paged_fast_tp (only the lane's group runs it); and the
verify sweeps of speculation, make_verify_chunk_fast_tp and
make_verify_chunk_paged_fast_tp (dense models, ep=1, as JAX's), which
return the hidden rows Medusa's heads read when asked. `MeshLanes` is the
scheduler's device side on a mesh: the leader rank broadcasts each
operation's host inputs, the other ranks follow; a draft model on the
same mesh is a second MeshLanes on the same wire.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.cache import KVCache
from ..models.fast import (FastScales, FastWeights, decode_step_fast, decode_step_fast_batched,
                           decode_step_fast_batched_paged, fast_unsupported, prefill_fast,
                           prefill_fast_paged, verify_chunk_fast_batched,
                           verify_chunk_fast_batched_paged)
from ..models.paged import PagedKVPool
from ..models.weights import Weights
from ..ops.core import int_view
from ..ops.int4 import int4_group
from .mesh import Mesh
from .sharding import fast_weight_splits, local_cache_shape, local_pool_shape, take_shard


# ---------------------------------------------------------------------------
# the shard's shapes and the collectives hook
# ---------------------------------------------------------------------------

def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The model as one tp rank's kernels see it: its heads, kv heads, FFN
    hidden slice and vocab slice (the router keeps every expert)."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                               hidden_dim=cfg.hidden_dim // tp,
                               vocab_size=cfg.vocab_size // tp)


class TPShard:
    """The collectives hook of models/fast.py's step bodies for one rank of
    a mesh, with the shard's shapes (`cfg`, local) and offsets."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh):
        why = fast_tp_unsupported(cfg, mesh.shape["tp"], mesh.shape.get("ep", 1))
        if why:
            raise ValueError(f"the mesh's shards do not fit the port's kernels: {why}")
        self._place(cfg, mesh)
        self.cfg = local_config(cfg, self.tp)

    def _place(self, cfg: ModelConfig, mesh: Mesh) -> None:
        """The rank's vocab and expert slices (a mesh of named axes without
        ep, the ring's ('sp', 'tp'), has one expert shard)."""
        tp, ep = mesh.shape["tp"], mesh.shape.get("ep", 1)
        self.mesh = mesh
        self.tp, self.ep = tp, ep
        self.full = cfg
        self.V_l = cfg.vocab_size // tp
        self.v0 = mesh.coords["tp"] * self.V_l
        self.E_l = cfg.n_experts // ep if cfg.is_moe else 0
        self.e0 = mesh.coords.get("ep", 0) * self.E_l
        self.moe_split = cfg.is_moe and tp * ep > 1

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """A row-parallel partial (the attention delta after wo, the FFN's
        after w2) summed over the tp ranks, in f32."""
        return self.mesh.all_reduce(t.contiguous(), "tp")

    def reduce_experts(self, t: torch.Tensor) -> torch.Tensor:
        """An MoE FFN delta summed over experts (ep) and hidden slices (tp)."""
        return self.mesh.all_reduce(t.contiguous(), "ep_tp")

    def vocab_rows(self, idx: torch.Tensor):
        """(local row of each token id, whether this rank holds it)."""
        loc = idx - self.v0
        mine = (loc >= 0) & (loc < self.V_l)
        return loc.clamp(0, self.V_l - 1), mine

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """(..., V/tp) logits of this rank's vocab slice -> (..., V) on every
        rank: a full row, zero outside the slice, summed over tp."""
        full = torch.zeros(local.shape[:-1] + (self.full.vocab_size,), dtype=local.dtype,
                           device=local.device)
        full[..., self.v0:self.v0 + self.V_l] = local
        return self.mesh.all_reduce(full, "tp")

    def local_experts(self, idx: torch.Tensor) -> torch.Tensor:
        """Routed global expert ids -> this rank's local ids, -1 for an
        expert another rank holds; computed on the device."""
        loc = idx - self.e0
        return torch.where((loc >= 0) & (loc < self.E_l), loc, torch.full_like(loc, -1))


# ---------------------------------------------------------------------------
# what fits, and the weights
# ---------------------------------------------------------------------------

def fast_tp_unsupported(cfg: ModelConfig, tp: int, ep: int = 1) -> Optional[str]:
    """Why the LOCAL shard shapes do not fit the port's kernels, or None.
    JAX's divisibility and int4-group rules (fast_tp.py:163-200); where
    JAX's answer comes from a TPU tiling limit (its gemv_supported,
    attention_supported and int4_supported), the port's kernel limits
    (models/fast.py:fast_unsupported on the shard's shapes) decide."""
    if tp < 1 or ep < 1:
        return f"tp={tp}, ep={ep}"
    if cfg.is_moe:
        if cfg.n_experts % ep:
            return f"ep={ep} does not divide n_experts={cfg.n_experts}"
    elif ep != 1:
        return "ep > 1 requires an MoE model"
    for name, n in (("n_kv_heads", cfg.n_kv_heads), ("n_heads", cfg.n_heads),
                    ("hidden_dim", cfg.hidden_dim), ("vocab_size", cfg.vocab_size)):
        if n % tp:
            return f"tp={tp} does not divide {name}={n}"
    if cfg.weight_dtype == "int4":
        # row-parallel wo/w2 cut their packed INPUT columns: the local input
        # keeps the global group size (groups never straddle ranks)
        for name, k_global in (("q_dim", cfg.q_dim), ("hidden_dim", cfg.hidden_dim)):
            if (k_global // tp) % int4_group(k_global):
                return (f"{name}={k_global} over tp={tp}: the local input is not a "
                        f"whole number of {int4_group(k_global)}-column int4 groups")
    return fast_unsupported(local_config(cfg, tp))


def fast_tp_supported(cfg: ModelConfig, tp: int, ep: int = 1) -> bool:
    """Models whose LOCAL shard shapes fit the kernels (fast_tp.py:163)."""
    return fast_tp_unsupported(cfg, tp, ep) is None


def mesh_route(cfg: ModelConfig, fast, mesh: Mesh) -> bool:
    """The route of an entry point on a mesh (engine.py:145-158): the
    kernels on the rank's shard where fast_tp_supported ("auto" or True);
    True on shards the kernels refuse raises with the limit; False, and
    "auto" on such shards, take the sharded parity oracle
    (parallel/oracle.py, JAX's GSPMD path)."""
    if fast not in ("auto", True, False):
        raise ValueError(f"fast must be 'auto', True or False, got {fast!r}")
    why = fast_tp_unsupported(cfg, mesh.shape["tp"], mesh.shape["ep"])
    if fast is True and why:
        raise ValueError(f"fast TP path unavailable for this config/mesh: {why}")
    return fast is not False and why is None


def shard_major_rows(sizes, tp: int) -> list[int]:
    """The row permutation that turns a plain concatenation of parts of
    `sizes` rows into the shard-major order [a_0; b_0; ...; a_1; b_1; ...]
    (yalm_tpu/models/fast.py:53 shard_major)."""
    offs = np.cumsum((0,) + tuple(sizes))
    out: list[int] = []
    for t in range(tp):
        for o, n in zip(offs, sizes):
            c = n // tp
            out += range(o + t * c, o + (t + 1) * c)
    return out


def _rows(t: torch.Tensor, order, dim: int) -> torch.Tensor:
    idx = torch.as_tensor(order, dtype=torch.long, device=t.device)
    return int_view(t).index_select(dim, idx).view(t.dtype)


def _major_rows(cfg: ModelConfig, tp: int) -> dict:
    """field -> (dimension, shard-major row permutation) of the fields a
    plain concatenation orders differently: wqkv, w13, the qkv biases and
    their scales (int4 group scales carry the rows on their N axis)."""
    x = 1 if cfg.is_moe else 0
    qkv = shard_major_rows((cfg.q_dim, cfg.kv_dim, cfg.kv_dim), tp)
    h = shard_major_rows((cfg.hidden_dim, cfg.hidden_dim), tp)
    g = 1 if cfg.weight_dtype == "int4" else 0   # the group axis before N
    return {"wqkv": (1, qkv), "w13": (1 + x, h), "bqkv": (1, qkv),
            "scales.wqkv": (1 + g, qkv), "scales.w13": (1 + x + g, h)}


def fast_tp_weights(w: Weights, cfg: ModelConfig, tp: int) -> FastWeights:
    """The shard-major FastWeights of the oracle's Weights
    (fast_tp.py:67-92): FastWeights.from_weights with the rows of wqkv, w13
    and the qkv biases reordered; with tp=1 exactly from_weights. Each
    rank's contiguous chunk of it is its shard (fast_weights_from_numpy
    cuts one from such arrays)."""
    fw = FastWeights.from_weights(w, cfg)
    if tp == 1:
        return fw
    for name, (dim, order) in _major_rows(cfg, tp).items():
        if not name.startswith("scales.") and getattr(fw, name) is not None:
            setattr(fw, name, _rows(getattr(fw, name), order, dim))
    return fw


def shard_fast_tp_weights(weights, cfg: ModelConfig, mesh: Mesh) -> FastWeights:
    """This rank's shard on its device (fast_tp.py:164 shard_fast_tp_weights)
    from the whole model: the oracle's Weights or the single-device
    FastWeights (FastWeights.from_weights, load_fast_weights at tp=1, a
    plain concatenation: JAX's takes its shard-major order instead). The
    rank's rows of wqkv, w13 and the biases are picked out of the
    concatenation in shard-major order, and only the shard is copied. A
    tied head stays shared with the embedding."""
    if isinstance(weights, Weights):
        weights = FastWeights.from_weights(weights, cfg)
    table = fast_weight_splits(cfg, with_scales=weights.scales is not None)
    tp, t = mesh.shape["tp"], mesh.coords["tp"]
    major = _major_rows(cfg, tp) if tp > 1 else {}

    def cut(name, x, splits):
        if name in major:   # the tp split of a concatenation: a row gather
            dim, order = major[name]
            c = len(order) // tp
            x = take_shard(x, tuple(sp for sp in splits if sp[1] != "tp"), mesh.shape,
                           mesh.coords)
            return _rows(x, order[t * c:(t + 1) * c], dim).contiguous().to(mesh.device)
        return take_shard(x, splits, mesh.shape, mesh.coords).contiguous().to(mesh.device)

    kw = {}
    for f in dataclasses.fields(FastWeights):
        x = getattr(weights, f.name)
        if f.name == "scales" or x is None:
            continue
        kw[f.name] = cut(f.name, x, table[f.name])
    if weights.lm_head is weights.embed:
        kw["lm_head"] = kw["embed"]
    if weights.scales is not None:
        sc = weights.scales
        kw["scales"] = FastScales(**{
            g.name: cut("scales." + g.name, getattr(sc, g.name), table["scales"][g.name])
            for g in dataclasses.fields(FastScales) if getattr(sc, g.name) is not None})
        if sc.lm_head is sc.embed:
            kw["scales"].lm_head = kw["scales"].embed
    return FastWeights(**kw)


def is_local_shard(fw: FastWeights, cfg: ModelConfig, mesh: Mesh) -> bool:
    """Whether FastWeights hold one rank's shard (not the whole model)."""
    tp, ep = mesh.shape["tp"], mesh.shape.get("ep", 1)
    rows = (cfg.q_dim + 2 * cfg.kv_dim) // tp
    experts = cfg.n_experts // ep if cfg.is_moe else None
    return fw.wqkv.shape[1] == rows and (experts is None or fw.w13.shape[1] == experts)


def mesh_weights(cfg: ModelConfig, weights, mesh: Mesh) -> FastWeights:
    """A mesh entry point's weights as this rank's shard on its device:
    the whole model (oracle Weights, single-device FastWeights) is cut; a
    rank's shard (load_fast_weights(tp=, ep=, rank=)) must already be on
    the rank's device."""
    if isinstance(weights, FastWeights) and is_local_shard(weights, cfg, mesh):
        if weights.wqkv.device != mesh.device:
            raise ValueError(f"weights on {weights.wqkv.device}, mesh rank on {mesh.device}")
        return weights
    return shard_fast_tp_weights(weights, cfg, mesh)


# ---------------------------------------------------------------------------
# the three factories (JAX's shard_map'd functions)
# ---------------------------------------------------------------------------

def local_cache(cfg: ModelConfig, mesh: Mesh, kv_dtype=torch.bfloat16,
                batch: int | None = None) -> KVCache:
    """This rank's cache: its kv heads (Hk/tp) and, batched, its dp
    group's lanes (B/dp) (parallel/sharding.py:cache_splits)."""
    shape = local_cache_shape(cfg, mesh.shape, batch)
    return KVCache.init(cfg, kv_dtype, mesh.device, batch=shape[0] if batch is not None else None,
                        n_kv_heads=shape[-2])


def make_decode_step_fast_tp(cfg: ModelConfig, mesh: Mesh, output_logits: bool = True):
    """(fw, token, pos, cache) -> (logits (V,) or None, cache): one decode
    step on this rank's shard (fast_tp.py:255), the full logits on every
    rank; the cache (this rank's kv heads) is updated in place."""
    shard = TPShard(cfg, mesh)

    def step(fw, token, pos, cache):
        return decode_step_fast(cfg, fw, token, pos, cache, output_logits=output_logits,
                                shard=shard)
    return step


def make_prefill_fast_tp(cfg: ModelConfig, mesh: Mesh):
    """prefill(fw, tokens, pos0, valid_len, cache, logits_mode="last",
    attend_len=0) on this rank's shard (fast_tp.py:410): prefill_fast's
    chunk semantics with the decode step's collectives."""
    shard = TPShard(cfg, mesh)

    def prefill(fw, tokens, pos0, valid_len, cache, logits_mode="last", attend_len=0):
        return prefill_fast(cfg, fw, tokens, pos0, valid_len, cache, logits_mode=logits_mode,
                            attend_len=attend_len, shard=shard)
    return prefill


def make_tick_fast_tp(cfg: ModelConfig, mesh: Mesh):
    """tick(fw, tokens, positions, cache, write_mask=None) -> (logits (B, V),
    cache) over dp x ep x tp (fast_tp.py:572): tokens, positions and the
    write mask are the B lanes' host values (the tokens may be a device
    tensor); this rank's cache holds its dp group's B/dp lanes, which it
    decodes; the logits of all B lanes reach every rank (a sum over dp of
    rows zero outside each group's)."""
    shard = TPShard(cfg, mesh)

    def tick(fw, tokens, positions, cache, write_mask=None):
        tok = _per_lane(tokens)
        B = tok.shape[0]
        sl = dp_slice(mesh, B)
        pos = _per_lane(positions, host=True)
        wr = None if write_mask is None else _per_lane(write_mask, host=True)[sl]
        logits, cache = decode_step_fast_batched(cfg, fw, tok[sl], pos[sl], cache, wr,
                                                 shard=shard)
        return dp_rows(mesh, logits, sl, B), cache
    return tick


def _per_lane(a, host: bool = False):
    """Per-lane values as a flat int64 numpy array, or a flat device tensor
    as given (a draft tick's argmax stays on the card) unless `host`."""
    if isinstance(a, torch.Tensor) and not host:
        return a.reshape(-1)
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, np.int64).reshape(-1)


def dp_slice(mesh: Mesh, B: int) -> slice:
    """The lanes of this rank's dp group among B: lane b belongs to group
    b // (B/dp)."""
    dp, g = mesh.shape["dp"], mesh.coords["dp"]
    if B % dp:
        raise ValueError(f"{B} lanes do not split over dp={dp}")
    Bl = B // dp
    return slice(g * Bl, (g + 1) * Bl)


def dp_rows(mesh: Mesh, rows: torch.Tensor, sl: slice, B: int) -> torch.Tensor:
    """(B, ...) on every rank from each dp group's rows `sl`: zero outside
    them, summed over dp (exact)."""
    if mesh.shape["dp"] == 1:
        return rows
    full = torch.zeros((B,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    full[sl] = rows
    return mesh.all_reduce(full, "dp")


def from_group(mesh: Mesh, out: Optional[torch.Tensor], group: int, shape) -> torch.Tensor:
    """A tensor that dp group `group` computed (`out`, None elsewhere), on
    every rank: zeros elsewhere, summed over dp (exact)."""
    if mesh.shape["dp"] == 1:
        return out
    buf = out if group == mesh.coords["dp"] else torch.zeros(shape, dtype=torch.float32,
                                                             device=mesh.device)
    return mesh.all_reduce(buf.contiguous(), "dp")


# ---------------------------------------------------------------------------
# the paged pool and the verify sweeps (dense models, ep=1)
# ---------------------------------------------------------------------------

def _dense_shard(cfg: ModelConfig, mesh: Mesh, what: str) -> TPShard:
    """The hook of a path JAX runs only for dense models with ep=1
    (fast_tp.py:720, :852, :1004)."""
    if cfg.is_moe or mesh.shape["ep"] != 1:
        raise ValueError(f"{what} on a mesh: dense models, ep=1")
    return TPShard(cfg, mesh)


def local_pool(cfg: ModelConfig, mesh: Mesh, n_pages: int, page_size: int,
               kv_dtype=torch.bfloat16) -> PagedKVPool:
    """This rank's shard of a pool of n_pages: n_pages/dp pages of Hk/tp
    heads (fast_tp.py:984 shard_paged_pool); page 0 of every shard is its
    group's sink."""
    shape = local_pool_shape(cfg, mesh.shape, n_pages, page_size)
    return PagedKVPool(k=torch.zeros(shape, dtype=kv_dtype, device=mesh.device),
                       v=torch.zeros(shape, dtype=kv_dtype, device=mesh.device))


def _group_tables(tables, B: int, sl: slice) -> np.ndarray:
    """This group's rows of the (B, blocks) tables of group-local page ids."""
    t = tables.cpu().numpy() if isinstance(tables, torch.Tensor) else np.asarray(tables)
    return np.asarray(t, np.int64).reshape(B, -1)[sl]


def make_tick_paged_fast_tp(cfg: ModelConfig, mesh: Mesh, page_size: int):
    """tick(fw, tokens, positions, pool, tables, write_mask=None) ->
    (logits (B, V), pool) over a paged pool on dp x tp (fast_tp.py:990):
    tables (B, window // page_size) hold each lane's page ids local to its
    dp group; this rank runs its group's lanes over its pool shard (K9 at
    Hk/tp heads), and every lane's logits reach every rank."""
    shard = _dense_shard(cfg, mesh, "the paged tick")

    def tick(fw, tokens, positions, pool, tables, write_mask=None):
        tok = _per_lane(tokens)
        B = tok.shape[0]
        sl = dp_slice(mesh, B)
        pos = _per_lane(positions, host=True)
        wr = None if write_mask is None else _per_lane(write_mask, host=True)[sl]
        logits, pool = decode_step_fast_batched_paged(
            cfg, fw, tok[sl], pos[sl], pool, _group_tables(tables, B, sl), wr,
            page_size=page_size, shard=shard)
        return dp_rows(mesh, logits, sl, B), pool
    return tick


def make_prefill_paged_fast_tp(cfg: ModelConfig, mesh: Mesh, page_size: int):
    """prefill(fw, tokens, pos0, valid_len, pool, table_b, page, row0, group,
    logits_mode="last", attend_len=0) -> (logits (V,) or None, pool): one
    lane's prefill chunk over the paged mesh (fast_tp.py:1087). `group` is
    the dp group that owns the lane; table_b and page are local to its pool
    shard. Only that group's ranks run the chunk (JAX runs it everywhere
    with the other groups' writes masked: the pools come out the same),
    and the "last" logits reach every rank."""
    shard = _dense_shard(cfg, mesh, "the paged prefill")

    def prefill(fw, tokens, pos0, valid_len, pool, table_b, page, row0, group,
                logits_mode="last", attend_len=0):
        if logits_mode not in ("none", "last"):
            raise ValueError(f"bad logits_mode {logits_mode!r}")
        out = None
        if int(group) == mesh.coords["dp"]:
            out, pool = prefill_fast_paged(cfg, fw, tokens, pos0, valid_len, pool, table_b,
                                           page, row0, logits_mode=logits_mode,
                                           page_size=page_size, attend_len=attend_len,
                                           shard=shard)
        if logits_mode == "none":
            return None, pool
        return from_group(mesh, out, int(group), (cfg.vocab_size,)), pool
    return prefill


def _verify_rows(mesh: Mesh, out, sl: slice, B: int, with_hidden: bool):
    if with_hidden:
        return dp_rows(mesh, out[0], sl, B), dp_rows(mesh, out[1], sl, B)
    return dp_rows(mesh, out, sl, B)


def make_verify_chunk_fast_tp(cfg: ModelConfig, mesh: Mesh, with_hidden: bool = False):
    """verify(fw, tokens (B, T), pos0 (B,), enable (B,), cache, attend_len=0)
    -> (logits (B, T, V), cache), or ((logits, hidden (B, T, dim)), cache)
    with_hidden: the speculative verify sweep (verify_chunk_fast_batched)
    with lanes on dp and heads, hidden and vocab on tp (fast_tp.py:703).
    Every lane's rows reach every rank; the hidden rows after the final
    norm are the same on every tp rank."""
    shard = _dense_shard(cfg, mesh, "the verify sweep")

    def verify(fw, tokens, pos0, enable, cache, attend_len=0):
        tok = np.asarray(tokens, np.int64)
        B = tok.shape[0]
        sl = dp_slice(mesh, B)
        out, cache = verify_chunk_fast_batched(
            cfg, fw, tok[sl], _per_lane(pos0, host=True)[sl], _per_lane(enable, host=True)[sl],
            cache, with_hidden=with_hidden, attend_len=attend_len, shard=shard)
        return _verify_rows(mesh, out, sl, B, with_hidden), cache
    return verify


def make_verify_chunk_paged_fast_tp(cfg: ModelConfig, mesh: Mesh, page_size: int,
                                    with_hidden: bool = False):
    """verify(fw, tokens, pos0, enable, pool, tables, attend_len=0): the
    verify sweep over the paged mesh (fast_tp.py:837), the chunk rows
    scattered through each dp group's tables of group-local page ids;
    returns as make_verify_chunk_fast_tp's."""
    shard = _dense_shard(cfg, mesh, "the paged verify sweep")

    def verify(fw, tokens, pos0, enable, pool, tables, attend_len=0):
        tok = np.asarray(tokens, np.int64)
        B = tok.shape[0]
        sl = dp_slice(mesh, B)
        out, pool = verify_chunk_fast_batched_paged(
            cfg, fw, tok[sl], _per_lane(pos0, host=True)[sl], _per_lane(enable, host=True)[sl],
            pool, _group_tables(tables, B, sl), page_size=page_size, with_hidden=with_hidden,
            attend_len=attend_len, shard=shard)
        return _verify_rows(mesh, out, sl, B, with_hidden), pool
    return verify


def draft_unsupported(dcfg: ModelConfig, mesh: Mesh) -> Optional[str]:
    """Why a draft model cannot shard over the mesh (scheduler.py:958-960),
    or None."""
    tp = mesh.shape["tp"]
    if fast_tp_unsupported(dcfg, tp, 1):
        return f"draft x mesh: draft shapes must shard over tp={tp}"
    return None




# ---------------------------------------------------------------------------
# the scheduler's device side on a mesh
# ---------------------------------------------------------------------------

_STOP, _TICK, _PREFILL, _STEP, _RESET, _VERIFY, _PROPOSE = range(7)
_MODES = ("none", "last")


class MeshLanes:
    """The scheduler's device work on a mesh for one model: its cache split
    as B/dp lanes x Hk/tp heads per rank, or (paged_pages > 0) a pool split
    as n_pages/dp pages x Hk/tp heads with each dp group's page ids local
    to its shard; the tick, one lane's prefill chunk, one lane's decode
    step (dense), the verify sweep and a draft's greedy proposal ticks.

    The leader rank (the scheduler's and the HTTP server's owner) calls
    them; each first broadcasts the operation, the model's tag and its host
    inputs (tokens, positions, the write mask, the page tables, a chunk's
    lane, start, length and logits mode) to every rank, whose `follow()`
    loop runs the same operation until `stop()`. Lane b belongs to dp group
    b // (B/dp); every lane's logits reach every rank. A draft model on the
    same mesh is another MeshLanes with tag 1, added to the target's with
    `add_peer`: both issue their collectives on the same process groups, in
    the one order the leader broadcast them (scheduler.py:947-1000)."""

    def __init__(self, cfg: ModelConfig, fw: FastWeights, mesh: Mesh, batch: int,
                 kv_dtype=torch.bfloat16, *, paged_pages: int = 0, page_size: int = 256,
                 tag: int = 0):
        self.cfg, self.fw, self.mesh = cfg, fw, mesh
        self.B, self.kv_dtype = batch, kv_dtype
        self.B_l = batch // mesh.shape["dp"]
        self.g = mesh.coords["dp"]
        self.shard = TPShard(cfg, mesh)
        self.paged = paged_pages > 0
        self.n_pages, self.page_size = paged_pages, page_size
        self.nblk = cfg.max_seq_len // page_size
        self.tag = tag
        self.peers = {tag: self}
        if self.paged:
            self._tick = make_tick_paged_fast_tp(cfg, mesh, page_size)
            self._prefill_paged = make_prefill_paged_fast_tp(cfg, mesh, page_size)
        else:
            self._tick = make_tick_fast_tp(cfg, mesh)
        self._verify = {}   # with_hidden -> the sweep, built at first use
        self.cache = self._fresh()

    def add_peer(self, other: "MeshLanes") -> None:
        """Put another model's lanes (a draft) on this wire: this object's
        follow() runs their operations too."""
        if other.tag in self.peers:
            raise ValueError(f"tag {other.tag} is taken")
        self.peers[other.tag] = other
        other.peers = self.peers

    def _fresh(self):
        if self.paged:
            return local_pool(self.cfg, self.mesh, self.n_pages, self.page_size, self.kv_dtype)
        return local_cache(self.cfg, self.mesh, self.kv_dtype, self.B)

    # -- the wire: an int64 header (op, payload length, tag), then the payload
    def _send(self, op: int, payload=()) -> np.ndarray:
        p = np.asarray(payload, np.int64).reshape(-1)
        self.mesh.broadcast(torch.tensor([op, p.size, self.tag], dtype=torch.int64,
                                         device=self.mesh.device))
        if p.size:
            self.mesh.broadcast(torch.as_tensor(p, device=self.mesh.device))
        return p

    def _recv(self):
        head = self.mesh.broadcast(torch.zeros(3, dtype=torch.int64, device=self.mesh.device))
        op, n, tag = (int(v) for v in head.tolist())
        p = torch.zeros(n, dtype=torch.int64, device=self.mesh.device)
        if n:
            self.mesh.broadcast(p)
        return op, p.cpu().numpy(), tag

    def _lane(self, b: int):
        """(owner dp group, this rank's view of lane b or None)."""
        owner = b // self.B_l
        return owner, (self.cache.lane(b - owner * self.B_l) if owner == self.g else None)

    def _from_owner(self, out, owner: int):
        """One lane's logits from its dp group to every rank."""
        return from_group(self.mesh, out, owner, (self.cfg.vocab_size,))

    def _tables(self, p: np.ndarray) -> Optional[np.ndarray]:
        return p.reshape(self.B, self.nblk) if self.paged else None

    # -- the operations (leader: broadcast, then run; followers: run)
    def _tick_args(self, tokens, positions, write, tables=None) -> np.ndarray:
        arrs = [tokens, positions, write] + ([tables] if self.paged else [])
        return np.concatenate([np.asarray(a, np.int64).reshape(-1) for a in arrs])

    def _run_tick(self, p: np.ndarray, tokens=None) -> torch.Tensor:
        B = self.B
        tok = p[:B] if tokens is None else tokens
        if self.paged:
            logits, _ = self._tick(self.fw, tok, p[B:2 * B], self.cache,
                                   self._tables(p[3 * B:]), p[2 * B:3 * B])
        else:
            logits, _ = self._tick(self.fw, tok, p[B:2 * B], self.cache, p[2 * B:3 * B])
        return logits

    def _run_prefill(self, p: np.ndarray):
        b, pos0, take, mode, attend = (int(v) for v in p[:5])
        owner = b // self.B_l
        if self.paged:
            page, row0 = int(p[5]), int(p[6])
            table_b, padded = p[7:7 + self.nblk], p[7 + self.nblk:]
            out, _ = self._prefill_paged(self.fw, padded, pos0, take, self.cache, table_b, page,
                                         row0, owner, logits_mode=_MODES[mode],
                                         attend_len=attend)
            return out
        _, lane = self._lane(b)
        out = None
        if lane is not None:
            out, _ = prefill_fast(self.cfg, self.fw, p[5:], pos0, take, lane,
                                  logits_mode=_MODES[mode], attend_len=attend, shard=self.shard)
        return None if mode == 0 else self._from_owner(out, owner)

    def _run_step(self, p: np.ndarray):
        b, token, pos, want = (int(v) for v in p[:4])
        owner, lane = self._lane(b)
        out = None
        if lane is not None:
            out, _ = decode_step_fast(self.cfg, self.fw, token, pos, lane,
                                      output_logits=bool(want), shard=self.shard)
        return self._from_owner(out, owner) if want else None

    def _run_verify(self, p: np.ndarray):
        B = self.B
        T, wh, attend = (int(v) for v in p[:3])
        o = 3 + B * T
        tokens, pos0, enable = p[3:o].reshape(B, T), p[o:o + B], p[o + B:o + 2 * B]
        if wh not in self._verify:
            self._verify[wh] = (
                make_verify_chunk_paged_fast_tp(self.cfg, self.mesh, self.page_size, bool(wh))
                if self.paged else make_verify_chunk_fast_tp(self.cfg, self.mesh, bool(wh)))
        if self.paged:
            out, _ = self._verify[wh](self.fw, tokens, pos0, enable, self.cache,
                                      self._tables(p[o + 2 * B:]), attend_len=attend)
        else:
            out, _ = self._verify[wh](self.fw, tokens, pos0, enable, self.cache,
                                      attend_len=attend)
        return out

    def _run_propose(self, p: np.ndarray) -> torch.Tensor:
        """K+1 greedy ticks (every lane's argmax feeds its next tick on the
        card; the logits are the same bits on every rank, so is the argmax)."""
        K, B = int(p[0]), self.B
        q = p[1:].copy()
        out = torch.empty((B, K + 1), dtype=torch.long, device=self.mesh.device)
        toks = None
        for i in range(K + 1):
            toks = torch.argmax(self._run_tick(q, toks), dim=-1)
            out[:, i] = toks
            q[B:2 * B] += 1
        return out

    def tick(self, tokens, positions, write, tables=None) -> torch.Tensor:
        """(B, V) logits of one batched tick (every rank runs its group's
        lanes); paged: tables (B, blocks) of group-local page ids."""
        return self._run_tick(self._send(_TICK, self._tick_args(tokens, positions, write,
                                                                tables)))

    def prefill(self, b: int, padded, pos0: int, take: int, mode: str, attend: int,
                table_b=None, page: int = 0, row0: int = 0):
        """Lane b's prefill chunk; (V,) logits for mode "last", else None.
        Paged: lane b's table row, the chunk's page (group-local) and its
        first row in the page."""
        head = [b, pos0, take, _MODES.index(mode), attend]
        if self.paged:
            head += [page, row0] + [int(t) for t in np.asarray(table_b).reshape(-1)]
        p = np.concatenate([head, np.asarray(padded, np.int64).reshape(-1)])
        return self._run_prefill(self._send(_PREFILL, p))

    def step(self, b: int, token: int, pos: int, output_logits: bool = True):
        """One decode step of lane b alone (dense ring-regime hydration)."""
        return self._run_step(self._send(_STEP, [b, token, pos, int(output_logits)]))

    def verify(self, tokens, pos0, enable, with_hidden: bool, attend: int, tables=None):
        """The verify sweep of tokens (B, T) at pos0 for the enabled lanes:
        (B, T, V) logits, or (logits, (B, T, dim) hidden rows) with_hidden."""
        tok = np.asarray(tokens, np.int64)
        p = np.concatenate([[tok.shape[1], int(with_hidden), attend], tok.reshape(-1),
                            np.asarray(pos0, np.int64), np.asarray(enable, np.int64)]
                           + ([np.asarray(tables, np.int64).reshape(-1)] if self.paged else []))
        return self._run_verify(self._send(_VERIFY, p))

    def propose(self, tokens, positions, write, K: int) -> np.ndarray:
        """A draft's K+1 greedy batched ticks from tokens at positions
        (write-masked lanes attend read-only): (B, K+1) ids, read once."""
        p = np.concatenate([[K], self._tick_args(tokens, positions, write)])
        return self._run_propose(self._send(_PROPOSE, p)).cpu().numpy()

    def reset(self) -> None:
        """A zeroed cache or pool on every rank (the scheduler's recovery)."""
        self._send(_RESET)
        self._run_reset()

    def _run_reset(self) -> None:
        self.cache = None
        if self.mesh.device.type == "cuda":
            torch.cuda.empty_cache()
        self.cache = self._fresh()

    def stop(self) -> None:
        """End every follower's loop."""
        self._send(_STOP)

    def follow(self) -> None:
        """A follower rank's loop: run what the leader broadcasts, for this
        model or a peer, until it stops."""
        while True:
            op, p, tag = self._recv()
            if op == _STOP:
                return
            lanes = self.peers[tag]
            {_TICK: lanes._run_tick, _PREFILL: lanes._run_prefill, _STEP: lanes._run_step,
             _VERIFY: lanes._run_verify, _PROPOSE: lanes._run_propose,
             _RESET: lambda p: lanes._run_reset()}[op](p)
