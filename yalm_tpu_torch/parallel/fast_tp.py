"""Tensor, expert and data parallelism on the kernels (port of
`yalm_tpu/parallel/fast_tp.py`: decode, chunked prefill and the batched
tick; speculation and the paged pool on a mesh are a later slice).

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

Three factories mirror JAX's (each returns a function over this rank's
weights and cache): make_decode_step_fast_tp, make_prefill_fast_tp and
make_tick_fast_tp (lanes on dp: a rank computes its dp group's lanes and
the logits of all lanes are summed over dp). `MeshLanes` is the
scheduler's device side on a mesh: the leader rank broadcasts each
operation's host inputs, the other ranks follow.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.cache import KVCache
from ..models.fast import (FastScales, FastWeights, decode_step_fast, decode_step_fast_batched,
                           fast_unsupported, prefill_fast)
from ..models.weights import Weights
from ..ops.core import int_view
from ..ops.int4 import int4_group
from .mesh import Mesh
from .sharding import fast_weight_splits, local_cache_shape, take_shard


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
        tp, ep = mesh.shape["tp"], mesh.shape["ep"]
        why = fast_tp_unsupported(cfg, tp, ep)
        if why:
            raise ValueError(f"the mesh's shards do not fit the port's kernels: {why}")
        self.mesh = mesh
        self.tp, self.ep = tp, ep
        self.full = cfg
        self.cfg = local_config(cfg, tp)
        self.V_l = cfg.vocab_size // tp
        self.v0 = mesh.coords["tp"] * self.V_l
        self.E_l = cfg.n_experts // ep if cfg.is_moe else 0
        self.e0 = mesh.coords["ep"] * self.E_l
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
    kernels on the rank's shard where fast_tp_supported; True on shards the
    kernels refuse raises with the limit. The sharded parity oracle (JAX's
    GSPMD path: fast=False, or "auto" on such shards) is a later slice of
    the port and raises NotImplementedError."""
    if fast not in ("auto", True, False):
        raise ValueError(f"fast must be 'auto', True or False, got {fast!r}")
    why = fast_tp_unsupported(cfg, mesh.shape["tp"], mesh.shape["ep"])
    if fast is True and why:
        raise ValueError(f"fast TP path unavailable for this config/mesh: {why}")
    if fast is False or why:
        raise NotImplementedError(
            "the sharded parity oracle (fast=False on a mesh" + (f"; {why}" if why else "")
            + ") is a later slice of the PyTorch port (ROADMAP.md item 13)")
    return True


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
    tp, ep = mesh.shape["tp"], mesh.shape["ep"]
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
    write mask are the B lanes' host values; this rank's cache holds its
    dp group's B/dp lanes, which it decodes; the logits of all B lanes
    reach every rank (a sum over dp of rows zero outside each group's)."""
    shard = TPShard(cfg, mesh)
    dp, g = mesh.shape["dp"], mesh.coords["dp"]

    def tick(fw, tokens, positions, cache, write_mask=None):
        tok = np.asarray(tokens, np.int64).reshape(-1)
        B = tok.shape[0]
        if B % dp:
            raise ValueError(f"{B} lanes do not split over dp={dp}")
        Bl = B // dp
        sl = slice(g * Bl, (g + 1) * Bl)
        pos = np.asarray(positions, np.int64).reshape(-1)
        wr = None if write_mask is None else np.asarray(write_mask, np.int64).reshape(-1)[sl]
        logits, cache = decode_step_fast_batched(cfg, fw, tok[sl], pos[sl], cache, wr,
                                                 shard=shard)
        return dp_rows(mesh, logits, sl, B), cache
    return tick


def dp_rows(mesh: Mesh, rows: torch.Tensor, sl: slice, B: int) -> torch.Tensor:
    """(B, ...) on every rank from each dp group's rows `sl`: zero outside
    them, summed over dp (exact)."""
    if mesh.shape["dp"] == 1:
        return rows
    full = torch.zeros((B,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    full[sl] = rows
    return mesh.all_reduce(full, "dp")


# ---------------------------------------------------------------------------
# the scheduler's device side on a mesh
# ---------------------------------------------------------------------------

_STOP, _TICK, _PREFILL, _STEP, _RESET = range(5)
_MODES = ("none", "last")


class MeshLanes:
    """The dense scheduler's device work on a mesh: the batched cache split
    as B/dp lanes x Hk/tp heads per rank, the tick, one lane's prefill
    chunk and one lane's decode step. The leader rank (the scheduler's and
    the HTTP server's owner) calls them; each first broadcasts the
    operation and its host inputs (tokens, positions, the write mask, a
    chunk's lane, start, length and logits mode) to every rank, whose
    `follow()` loop runs the same operation until `stop()`. Lane b belongs
    to dp group b // (B/dp); the logits of every lane reach the leader."""

    def __init__(self, cfg: ModelConfig, fw: FastWeights, mesh: Mesh, batch: int,
                 kv_dtype=torch.bfloat16):
        self.cfg, self.fw, self.mesh = cfg, fw, mesh
        self.B, self.kv_dtype = batch, kv_dtype
        self.B_l = batch // mesh.shape["dp"]
        self.g = mesh.coords["dp"]
        self.shard = TPShard(cfg, mesh)
        self._tick = make_tick_fast_tp(cfg, mesh)
        self.cache = local_cache(cfg, mesh, kv_dtype, batch)

    # -- the wire: an int64 header (op, payload length), then the payload
    def _send(self, op: int, payload=()) -> torch.Tensor:
        p = torch.as_tensor(np.asarray(payload, np.int64).reshape(-1), device=self.mesh.device)
        self.mesh.broadcast(torch.tensor([op, p.numel()], dtype=torch.int64,
                                         device=self.mesh.device))
        if p.numel():
            self.mesh.broadcast(p)
        return p

    def _recv(self):
        head = self.mesh.broadcast(torch.zeros(2, dtype=torch.int64, device=self.mesh.device))
        op, n = (int(v) for v in head.tolist())
        p = torch.zeros(n, dtype=torch.int64, device=self.mesh.device)
        if n:
            self.mesh.broadcast(p)
        return op, p.cpu().numpy()

    def _lane(self, b: int):
        """(owner dp group, this rank's view of lane b or None)."""
        owner = b // self.B_l
        return owner, (self.cache.lane(b - owner * self.B_l) if owner == self.g else None)

    def _from_owner(self, out, owner: int):
        """One lane's logits from its dp group to every rank."""
        if self.mesh.shape["dp"] == 1:
            return out
        buf = out if owner == self.g else torch.zeros(self.cfg.vocab_size, dtype=torch.float32,
                                                      device=self.mesh.device)
        return self.mesh.all_reduce(buf.contiguous(), "dp")

    # -- the operations (leader: broadcast, then run; followers: run)
    def _run_tick(self, p: np.ndarray) -> torch.Tensor:
        B = self.B
        logits, _ = self._tick(self.fw, p[:B], p[B:2 * B], self.cache, p[2 * B:3 * B])
        return logits

    def _run_prefill(self, p: np.ndarray):
        b, pos0, take, mode, attend = (int(v) for v in p[:5])
        owner, lane = self._lane(b)
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

    def tick(self, tokens, positions, write) -> torch.Tensor:
        """(B, V) logits of one batched tick (every rank runs its lanes)."""
        p = np.concatenate([np.asarray(a, np.int64).reshape(-1)
                            for a in (tokens, positions, write)])
        self._send(_TICK, p)
        return self._run_tick(p)

    def prefill(self, b: int, padded, pos0: int, take: int, mode: str, attend: int):
        """Lane b's prefill chunk; (V,) logits for mode "last", else None."""
        p = np.concatenate([[b, pos0, take, _MODES.index(mode), attend],
                            np.asarray(padded, np.int64).reshape(-1)])
        self._send(_PREFILL, p)
        return self._run_prefill(p)

    def step(self, b: int, token: int, pos: int, output_logits: bool = True):
        """One decode step of lane b alone (ring-regime hydration)."""
        p = np.asarray([b, token, pos, int(output_logits)], np.int64)
        self._send(_STEP, p)
        return self._run_step(p)

    def reset(self) -> None:
        """A zeroed cache on every rank (the scheduler's recovery)."""
        self._send(_RESET)
        self._run_reset()

    def _run_reset(self) -> None:
        self.cache = None
        if self.mesh.device.type == "cuda":
            torch.cuda.empty_cache()
        self.cache = local_cache(self.cfg, self.mesh, self.kv_dtype, self.B)

    def stop(self) -> None:
        """End every follower's loop."""
        self._send(_STOP)

    def follow(self) -> None:
        """A follower rank's loop: run what the leader broadcasts until it
        stops."""
        while True:
            op, p = self._recv()
            if op == _STOP:
                return
            {_TICK: self._run_tick, _PREFILL: self._run_prefill, _STEP: self._run_step,
             _RESET: lambda p: self._run_reset()}[op](p)
