"""Continuous-batching scheduler (port of the dense, single-device subset of
`yalm_tpu/scheduler.py`).

- A fixed pool of B slots, each owning one lane of a batched KV cache
  (B, n_layers, L, kv_heads, head_dim). Slot occupancy is data, not shape.
- Every tick runs ONE batched decode step for all slots
  (`decode_step_fast_batched`) and samples every lane on the device; the
  tick costs one device->host read, of the packed (2 + 2N, B) sample array.
  Free lanes and lanes still admitting their prompt attend read-only
  (write 0) and their rows are discarded.
- Admission: free slots take queued requests; a prompt hydrates in bounded
  chunks INTERLEAVED with decode ticks -- per slot (`prefill_fast` on the
  lane's view of the cache) or, with batched admission, every admitting
  lane's chunk in one weight sweep (`prefill_chunk_fast_batched`); past
  the window, token by token (`decode_step_fast` on the lane view).
- Optional dense prefix cache: a finished admission registers its prompt;
  a later one copies the best-matching lane's rows and skips the common
  prefix.
- Paged KV (`paged_pages`): the cache is a pool of pages (models/paged.py)
  mapped through per-lane tables, so its memory scales with the tokens in
  flight. Pages are mapped lazily (the first chunk's at admission, then
  chunk by chunk and at block boundaries); new requests wait for free
  pages, and a lane that must grow in an exhausted pool preempts the
  newest lane, which is requeued with an exact resume point. Full prompt
  pages are shared read-only between identical prefixes (automatic prefix
  caching, LRU eviction of unreferenced pages).
- Completion: EOS/stop/max-tokens frees the slot at the tick boundary.
- MoE models run every chunk path (the tick, per-slot and batched
  admission, dense and paged) through one all-expert FFN
  (`models/fast.py:_moe_ffn_batched`), so their streams agree; ring
  hydration of a dense lane routes its token's experts alone.
- Speculation (chain forms, scheduler.py:1636-1826): each round a proposal
  source -- a draft model's K+1 batched greedy ticks on its own dense
  batched cache (`spec_draft`), per-lane prompt lookup (`spec_lookup`) or
  the target's Medusa heads (`spec_medusa`) -- gives every eligible lane a
  chunk [cur, d0..d_{K-1}], ONE batched target sweep verifies them all
  (`verify_chunk_fast_batched[_paged]`), and `_verify_pack` accepts on the
  device (argmax agreement at T 0, exact point-mass rejection sampling at
  T > 0 within the request's top-k/top-p envelope) into one small read per
  round. Lanes near the window edge, and lookup lanes with no match, take a
  plain subtick. Composes with the paged pool and MoE targets.

- Tree-attention Medusa (`spec_tree`, scheduler.py:1828-1930): greedy
  lanes verify the cartesian tree of their heads' top candidates in one
  sweep that reads the dense cache only (`verify_tree_fast_batched`), the
  walk and the next candidates come back in one read, and the accepted
  path's rows are scattered into the ring.
- `fast=False` (or "auto" on a config the kernels refuse) runs the parity
  oracle (`models/transformer.py`): a per-lane decode step for every
  writing lane of a tick, per-slot prefill; no paged pool, no batched
  admission, no prefix cache, no speculation.

- A mesh (`mesh`, parallel/mesh.Mesh; scheduler.py:527-680, 832-858,
  947-1000): lanes split over dp, heads and the FFN hidden width over tp,
  experts over ep. Every rank builds the Scheduler; the leader (rank 0)
  owns the requests, and each tick, prefill chunk, ring-hydration step,
  verify sweep and draft proposal it runs is broadcast with its host
  inputs (tokens, positions, the write mask, the page tables) to the other
  ranks, which `follow()` until `stop_followers()`
  (parallel/fast_tp.MeshLanes); the logits (and Medusa's hidden rows) of
  every lane reach the leader, which samples and accepts. As in JAX's, a
  mesh takes per-slot admission (no batched admission, no dense prefix
  registry). The paged pool splits its pages over dp (GroupedPageAllocator:
  one allocator per group, page ids local to the group's pool shard,
  preemption inside the lane's group) and its kv heads over tp; all three
  proposal sources speculate on a dense model with ep=1, a draft model
  sharded over the same mesh with its own cache. As JAX's, a scheduler on
  a mesh runs the kernels: the oracle there (fast=False, or "auto" on
  shards the kernels refuse) raises JAX's ValueError; the Engine runs the
  sharded oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .config import ModelConfig
from .engine import (PREFILL_BUCKETS, _bucket_for, attend_bucket, chunk_schedule,
                     resolve_device, resolve_fast, route_kv_dtype, route_weights)
from .medusa import MedusaWeights, medusa_propose_rows, medusa_propose_topk_rows, topk_stable
from .models.cache import KVCache
from .models.fast import (cartesian_tree, decode_step_fast, decode_step_fast_batched,
                          decode_step_fast_batched_paged, fast_unsupported,
                          prefill_chunk_fast_batched, prefill_chunk_fast_batched_paged,
                          prefill_fast, prefill_fast_paged,
                          scatter_tree_rows, tree_depths, verify_chunk_fast_batched,
                          verify_chunk_fast_batched_paged, verify_tree_fast_batched)
from .models.paged import GroupedPageAllocator, PageAllocator, PagedKVPool
from .models.transformer import decode_step, prefill
from .sampler import _envelope, sample_rows, uniform_rows
from .spec import NgramHistory

_NBIAS = 16  # static per-request logit_bias capacity (OpenAI logit_bias)


def _apply_bias(lg: torch.Tensor, bias_ids: torch.Tensor, bias_vals: torch.Tensor):
    """OpenAI logit_bias: per-lane sparse (token id, value) pairs added to
    the logits before sampling, so the sample, the reported logprob and the
    top-N all see the distribution actually sampled. bias_ids (B, _NBIAS)
    with -1 marking empty entries; out-of-vocab ids are inert."""
    V = lg.shape[-1]
    ok = (bias_ids >= 0) & (bias_ids < V)
    return lg.scatter_add(1, bias_ids.clamp(0, V - 1).long(),
                          torch.where(ok, bias_vals, torch.zeros_like(bias_vals)))


def _sample_pack(logits, seeds, positions, temps, topks, topps, bias_ids, bias_vals,
                 topn: int = 0) -> torch.Tensor:
    """Batched sample + OpenAI logprob packed into ONE (2 [+ 2*topn], B) f32
    tensor, so the host reads a single small buffer per tick (ids are exact
    in f32: vocab < 2^24). Row 0: sampled ids; row 1: the log-prob of the
    sampled token under the full (temperature-independent) biased
    distribution; rows 2..2+topn: the top-topn ids, then their log-probs."""
    lg = _apply_bias(logits.float(), bias_ids, bias_vals)
    nxt = sample_rows(lg, seeds, positions, temps, topks, topps)
    lse = torch.logsumexp(lg, dim=-1)
    lp = torch.gather(lg, 1, nxt[:, None])[:, 0] - lse
    rows = [nxt.float(), lp]
    if topn:
        tv, ti = torch.topk(lg, topn, dim=-1)          # (B, topn)
        rows += list(ti.float().T) + list((tv - lse[:, None]).T)
    return torch.stack(rows)


def _unpack_sample(packed: torch.Tensor, topn: int = 0):
    arr = packed.cpu().numpy()   # the one device -> host read of the tick
    nxt, lps = arr[0].astype(np.int32), arr[1]
    if not topn:
        return nxt, lps, None
    # per-lane list of (id, lp) pairs, best first
    per_lane = [[(int(arr[2 + k, b]), float(arr[2 + topn + k, b])) for k in range(topn)]
                for b in range(arr.shape[1])]
    return nxt, lps, per_lane


def _verify_pack(logits, chunk, seeds, positions, temps, topks, topps, topn: int = 0,
                 envelope: bool = True) -> torch.Tensor:
    """A verify sweep's acceptance on the device (scheduler.py:115-209), so
    the host reads (B, K+1, 6 + 2*topn) f32 instead of the (B, K+1, vocab)
    logits. Every proposal is a point mass (greedy draft ticks, n-grams,
    Medusa's argmax), so exact rejection sampling (Leviathan et al.) accepts
    proposal x = chunk[:, i+1] w.p. p_T(x); a rejection draws from p_T with
    x masked out; if every proposal lands, the bonus draws from p_T at the
    last verified row. p_T is the request's temperature distribution within
    its top-k/top-p envelope (sampler._envelope; `envelope` False skips the
    sort where no lane has one). Temperature-0 lanes accept on argmax
    agreement and take the argmax. The accept uniform, the residual and
    the bonus come from the request's own (seed, row position) streams of
    purposes 1, 2 and 3 (sampler.uniform_rows), never the plain tick's.

    Columns: [0] accept flag, [1] logprob of the proposed token, [2]
    residual id, [3] its logprob, [4] bonus id, [5] its logprob, then topn
    top ids and topn top logprobs of each row; logprobs under the full,
    temperature-independent distribution (as _sample_pack's row 1)."""
    B, K1, V = logits.shape
    dev = logits.device
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)                                  # (B, K+1)
    prop = torch.cat([chunk[:, 1:], chunk[:, :1]], dim=1).long()       # (B, K+1)
    lp_c = torch.gather(lg, -1, prop[..., None])[..., 0] - lse
    greedy_t = torch.argmax(lg, dim=-1)
    temp = temps.float().clamp_min(1e-6)[:, None].expand(B, K1)
    if envelope:
        cut = _envelope(lg, temp, topks.long()[:, None].expand(B, K1),
                        topps.float()[:, None].expand(B, K1))
        scaled = cut / temp[..., None]
    else:
        scaled = lg / temp[..., None]
    lse_T = torch.logsumexp(scaled, dim=-1)
    lp_T_x = torch.gather(scaled, -1, prop[..., None])[..., 0] - lse_T
    rowpos = (positions.long()[:, None] + torch.arange(K1, device=dev)[None]).reshape(-1)
    rseeds = seeds.long()[:, None].expand(B, K1).reshape(-1)

    def gumbel(purpose):
        return -torch.log(-torch.log(uniform_rows(rseeds, rowpos, V, purpose))).reshape(B, K1, V)
    u = uniform_rows(rseeds, rowpos, 1, 1).reshape(B, K1)
    sampled = (temps > 0)[:, None]
    acc = torch.where(sampled, u < torch.exp(lp_T_x), prop == greedy_t)
    masked = scaled.scatter(-1, prop[..., None], float("-inf"))
    res = torch.argmax(masked + gumbel(2), dim=-1)
    # if the mask emptied the support, acceptance fired w.p. ~1 anyway
    res = torch.where(torch.isfinite(masked.amax(-1)), res, greedy_t)
    bon = torch.argmax(scaled + gumbel(3), dim=-1)
    res = torch.where(sampled, res, greedy_t)
    bon = torch.where(sampled, bon, greedy_t)
    res_lp = torch.gather(lg, -1, res[..., None])[..., 0] - lse
    bon_lp = torch.gather(lg, -1, bon[..., None])[..., 0] - lse
    cols = [acc.float(), lp_c, res.float(), res_lp, bon.float(), bon_lp]
    if topn:
        tv, ti = torch.topk(lg, topn, dim=-1)                          # (B, K+1, n)
        cols += [ti[..., k].float() for k in range(topn)] + [tv[..., k] - lse
                                                              for k in range(topn)]
    return torch.stack(cols, dim=-1)


def _verify_pack_medusa(logits, chunk, seeds, positions, temps, topks, topps, kd, hidden,
                        mw: MedusaWeights, topn: int = 0, envelope: bool = True
                        ) -> torch.Tensor:
    """_verify_pack plus the next round's Medusa proposals in the same read
    (scheduler.py:213-237): the accept walk again on the device (leading
    accepts clipped to each lane's proposal count kd), the heads on the
    hidden row at the correction index, the proposals as one extra trailing
    column (rows 0..H-1)."""
    vp = _verify_pack(logits, chunk, seeds, positions, temps, topks, topps, topn, envelope)
    B, K1 = chunk.shape
    idx = torch.arange(K1, device=chunk.device)[None]
    rej = (vp[..., 0] <= 0.5) & (idx < kd[:, None])
    a = torch.where(rej.any(dim=1), torch.argmax(rej.int(), dim=1), kd.long())   # (B,)
    h_a = hidden[torch.arange(B, device=chunk.device), a]
    props = medusa_propose_rows(mw, h_a)                               # (B, H)
    Hc = min(int(props.shape[1]), K1 - 1)   # the next chunk holds at most K
    col = torch.zeros((B, K1, 1), dtype=torch.float32, device=chunk.device)
    col[:, :Hc, 0] = props[:, :Hc].float()
    return torch.cat([vp, col], dim=-1)


def _verify_pack_tree(logits, chunk, live, hidden, mw: MedusaWeights, *,
                      parents: tuple[int, ...], kmax: int, topn: int = 0) -> torch.Tensor:
    """A tree verify sweep's post-processing on the device, greedy lanes
    only (scheduler.py:241-290): one (B, Tn, C) f32 read carrying per node
    row [argmax id, its logprob, the node's own token's logprob under its
    parent's row, topn ids, topn logprobs, the walked final node
    (broadcast), the next round's head candidates (broadcast, H * kmax)].
    The accept walk (descend to the child whose token is the parent row's
    argmax; lanes with live 0 stay at the root) runs here, so the heads read
    only the final node's hidden row; the host rebuilds the path from the
    final node's ancestors. Ties order by the lower index first, as the
    JAX package's argmax and top_k do."""
    B, Tn, V = logits.shape
    dev = logits.device
    depths = tree_depths(parents)
    par = torch.as_tensor([max(p, 0) for p in parents], device=dev)
    dep = torch.as_tensor(depths, device=dev)
    chunk = chunk.long()
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)                                   # (B, Tn)
    arg = torch.argmax(lg, dim=-1)                                      # (B, Tn)
    arg_lp = torch.gather(lg, -1, arg[..., None])[..., 0] - lse
    own_lp = torch.gather(lg[:, par], -1, chunk[..., None])[..., 0] - lse[:, par]
    node = torch.zeros(B, dtype=torch.long, device=dev)
    alive = live != 0
    for d in range(max(depths)):
        want = torch.gather(arg, 1, node[:, None])                      # (B, 1)
        mask = (par[None] == node[:, None]) & (chunk == want) & (dep[None] == d + 1)
        found = mask.any(dim=1)
        node = torch.where(found & alive, torch.argmax(mask.int(), dim=1), node)
        alive = alive & found
    props = medusa_propose_topk_rows(mw, hidden[torch.arange(B, device=dev), node], kmax)
    cols = [arg.float(), arg_lp, own_lp]
    if topn:
        tv, ti = topk_stable(lg, topn)
        cols += [ti[..., k].float() for k in range(topn)] + [tv[..., k] - lse for k in range(topn)]
    cols.append(node[:, None].float().expand(B, Tn))
    flat = props.reshape(B, -1).float()
    cols += [flat[:, j:j + 1].expand(B, Tn) for j in range(flat.shape[1])]
    return torch.stack(cols, dim=-1)


class _DensePrefixRegistry:
    """Token-granular prompt-prefix reuse for the dense batched cache
    (scheduler.py:297-346). A lane OWNS its rows, so reuse is a lane-to-lane
    copy: a finished admission registers (prompt tokens, lane), and a later
    admission copies the registered lane's rows and skips prefilling the
    common prefix. Entries stay valid while the source lane's rows [0, len)
    are intact: they survive the request finishing and die when a new
    request starts hydrating that lane (invalidate_lane); a registering
    request can never enter the ring regime (Scheduler._prefix_cacheable).
    Causal attention makes identical token prefixes yield identical rows."""

    def __init__(self, cap: int = 64):
        self.cap = cap
        self.entries: list[tuple[tuple, int]] = []   # (tokens, lane)
        self.stats = {"hits": 0, "hit_tokens": 0, "registered": 0, "evicted": 0}

    def register(self, lane: int, tokens) -> None:
        t = tuple(tokens)
        self.entries = [(tk, ln) for tk, ln in self.entries if tk != t]
        self.entries.append((t, lane))
        self.stats["registered"] += 1
        while len(self.entries) > self.cap:
            self.entries.pop(0)
            self.stats["evicted"] += 1

    def invalidate_lane(self, lane: int) -> None:
        """A new request is about to overwrite this lane's rows."""
        self.entries = [(t, ln) for t, ln in self.entries if ln != lane]

    def match(self, tokens, limit: int) -> tuple[int, int]:
        """Longest common prefix (capped at `limit`) against every live
        entry: (src_lane, n_tokens), or (-1, 0) when nothing helps."""
        new = np.asarray(tokens, np.int64)
        best_lane, best = -1, 0
        for t, ln in self.entries:
            m = min(len(t), len(new), limit)
            if m <= best:
                continue
            neq = np.nonzero(np.asarray(t[:m], np.int64) != new[:m])[0]
            p = int(neq[0]) if len(neq) else m
            if p > best:
                best, best_lane = p, ln
        return best_lane, best


@dataclasses.dataclass
class Request:
    prompt_tokens: list[int]
    max_new_tokens: int = 128
    temperature: float = 1.0
    stop_tokens: frozenset[int] = frozenset()
    seed: int = 0
    top_k: int = 0        # 0 = full-vocab sampling
    top_p: float = 1.0    # 1.0 = no nucleus cut
    # OpenAI logit_bias: {token_id: additive bias}; applied to the logits
    # before sampling AND before the reported logprobs/top-N. At most
    # _NBIAS (16) entries per request.
    logit_bias: Optional[dict] = None
    # control: set by the owner (e.g. server stream close / stop-string
    # hit); the slot frees at the next tick edge
    cancelled: bool = False
    # outputs
    generated: list[int] = dataclasses.field(default_factory=list)
    # natural log-prob of each generated token under the model's FULL
    # (temperature-independent) distribution: OpenAI `logprobs` semantics
    logprobs: list[float] = dataclasses.field(default_factory=list)
    # per-token top-N alternatives [(token_id, logprob), ...] when the
    # scheduler was built with top_logprobs=N
    top_logprobs: list[list] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None   # set when the request failed (isolation)
    on_token: Optional[Callable[[int], None]] = None
    # paged-preemption resume point: (prefix_tokens, last_token) -- the lane
    # re-hydrates prefix_tokens WITHOUT re-emitting, then resumes decoding
    # from last_token (Scheduler._preempt / _advance_admission)
    _resume: Optional[tuple[list[int], int]] = None

    def _emit(self, tok: int, lp: float | None = None, top=None) -> None:
        self.generated.append(tok)
        self.logprobs.append(float(lp) if lp is not None else float("nan"))
        self.top_logprobs.append(top if top is not None else [])
        if self.on_token:
            self.on_token(tok)


@dataclasses.dataclass(eq=False)  # identity semantics: slots.index() matches by object
class _Slot:
    request: Optional[Request] = None
    pos: int = 0             # next absolute position for this sequence
    last_token: int = 0      # token to feed next tick
    admitting: bool = False  # prompt still hydrating (chunked, interleaved)
    admit_i: int = 0         # prompt tokens consumed so far
    admit_tokens: list[int] = dataclasses.field(default_factory=list)
    resuming: bool = False   # admission is a preemption-resume re-hydration
    seq: int = 0             # admission order (paged preemption picks the newest)
    spec_ok: bool = False    # on the speculation path (set when the prompt lands)
    hist: Optional[NgramHistory] = None     # prompt lookup's n-gram index
    med_props: Optional[list] = None        # Medusa proposals banked for the next round

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def decoding(self) -> bool:
        return self.request is not None and not self.admitting


class Scheduler:
    """Continuous batching on one device (default the card; "cpu" runs the
    kernels' plain versions), over the kernels (FastWeights) or the parity
    oracle (Weights), by `fast`."""

    # how many ring-regime prompt tokens hydrate per tick for ONE admitting
    # slot (each is a full per-token decode step, so this bounds the stall
    # a beyond-window prompt can impose between decode ticks)
    RING_HYDRATE_PER_TICK = 16

    def __init__(self, cfg: ModelConfig, weights, *, batch: int = 8,
                 kv_dtype: torch.dtype = torch.bfloat16, batched_admission: bool = False,
                 prefix_cache: bool = False, top_logprobs: int = 0, device="cuda",
                 paged_pages: int = 0, page_size: int = 256, mesh=None, spec_draft=None,
                 spec_k: int = 4, spec_lookup: bool = False, spec_ngram: int = 3,
                 spec_medusa: Optional[MedusaWeights] = None, spec_tree=None, fast="auto",
                 compute_dtype: torch.dtype = torch.float32):
        """batched_admission: all admitting lanes' chunks hydrate in ONE
        weight sweep (the chunk pads to the group's bucket, so a lane's
        prefill rounding depends on its co-admitted traffic; the per-slot
        path keeps streams identical to a solo run). prefix_cache: dense
        prompt reuse by lane copy (copied rows carry the source's chunking).
        The server turns both on. paged_pages > 0: the cache is a pool of
        that many pages of page_size slots (page_size must divide the
        window); the pool shares prompt pages natively, so the dense
        registry stays off.

        Speculation (one proposal source at most): spec_draft=(draft_cfg,
        draft FastWeights) proposes spec_k greedy tokens per lane by K+1
        batched draft ticks on a dense batched draft cache (also when the
        target is paged); spec_lookup proposes by per-lane prompt lookup
        (n-grams up to spec_ngram); spec_medusa (MedusaWeights) proposes by
        the target's own heads on the verify sweep's hidden rows (spec_k
        clamped to the head count). Temperature-0 streams equal plain greedy
        decode; sampled ones are distributed as plain sampling. spec_tree
        (per-depth branching factors, with spec_medusa, dense cache): each
        greedy lane verifies the cartesian tree of its heads' top candidates
        in one sweep (`verify_tree_fast_batched`); sampled lanes ride the
        plain tick.

        fast: "auto" runs the kernels wherever the config fits them
        (`fast_batched_supported`: any batch), else the oracle's per-lane
        tick (`models/transformer.py:decode_step` for each writing lane,
        scheduler.py:696-715) and per-slot prefill, in compute_dtype; True
        on a config the kernels refuse raises. The paged pool, batched
        admission, the prefix cache and speculation are the kernels'."""
        if spec_tree is not None:
            # scheduler.py:884-936
            if spec_medusa is None:
                raise ValueError("spec_tree requires spec_medusa heads")
            if paged_pages > 0 or mesh is not None:
                raise ValueError("tree verify: dense single-device cache "
                                 "(chain medusa composes with paged/mesh)")
        self.mesh = mesh
        if mesh is not None:
            from .parallel.fast_tp import mesh_route, mesh_weights
            # JAX's refusals first (scheduler.py:507-538), then this slice's
            spec = spec_draft is not None or spec_lookup or spec_medusa is not None
            moe_ep = cfg.is_moe or mesh.shape["ep"] != 1
            if spec and moe_ep:
                raise ValueError("spec x mesh needs ep=1 and a dense model (the sharded "
                                 "verify sweep has no expert axis); single-device spec x "
                                 "MoE works")
            if paged_pages > 0 and moe_ep:
                raise ValueError("paged cache + mesh needs ep=1 and a dense model; "
                                 "single-device paged x MoE works")
            self.fast = mesh_route(cfg, fast, mesh)
            if not self.fast or batch % mesh.shape["dp"]:
                raise ValueError(f"mesh scheduler requires the fast TP path and batch % dp "
                                 f"== 0 (got batch={batch}, mesh={mesh.shape})")
            self.device = resolve_device(mesh.device)
            kv_dtype = route_kv_dtype(kv_dtype, True)
            weights = mesh_weights(cfg, weights, mesh)
        else:
            self.device = resolve_device(device)
            self.fast = resolve_fast(cfg, fast)
            kv_dtype = route_kv_dtype(kv_dtype, self.fast)
            weights = route_weights(cfg, weights, self.fast, self.device)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.paged = paged_pages > 0
        self.page_size = page_size
        if self.paged and (page_size < 1 or cfg.max_seq_len % page_size):
            raise ValueError(f"page_size {page_size} must divide the window {cfg.max_seq_len}")
        if self.paged and not self.fast:
            raise ValueError("paged cache requires the fast path")
        self.cfg = cfg
        self.weights = weights
        self.compute_dtype = compute_dtype
        self.B = batch
        self.kv_dtype = kv_dtype
        self.topn = int(top_logprobs)
        self.n_pages = paged_pages
        self._new_cache()
        self.slots = [_Slot() for _ in range(batch)]
        self.queue: list[Request] = []
        self._admit_seq = 0
        self.preemptions = self.resumes = 0  # paged preemptions and resumes (stats)
        # on a mesh, per-slot admission and no prefix cache (scheduler.py:734, :773)
        self.batched_admission = bool(batched_admission) and self.fast and mesh is None
        self.admit_sweeps = 0  # batched-admission weight sweeps (stats)
        self.dense_prefix = (_DensePrefixRegistry()
                             if prefix_cache and not self.paged and self.fast and mesh is None
                             else None)
        self._init_spec(spec_draft, spec_k, spec_lookup, spec_ngram, spec_medusa)
        if self.spec and not self.fast:
            raise ValueError("speculative scheduler needs the fast path")
        self._init_tree(spec_tree)

    def _init_spec(self, spec_draft, spec_k: int, spec_lookup: bool, spec_ngram: int,
                   spec_medusa) -> None:
        """The proposal source (scheduler.py:493-505, 938-1030)."""
        if sum([bool(spec_lookup), spec_draft is not None, spec_medusa is not None]) > 1:
            raise ValueError("spec_lookup, spec_draft and spec_medusa are mutually exclusive "
                             "proposal sources")
        self.spec_lookup = bool(spec_lookup)
        self.spec_ngram = int(spec_ngram)
        self.spec_medusa = spec_medusa
        self.spec = spec_draft is not None or self.spec_lookup or spec_medusa is not None
        self.spec_k = int(spec_k)
        if self.spec and self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if spec_medusa is not None:
            # one proposal per head per round
            self.spec_k = min(self.spec_k, spec_medusa.n_heads)
        self.spec_stats = {"rounds": 0, "accepted": 0, "proposed": 0}
        self.spec_edge = self.cfg.max_seq_len
        self.draft_cfg = self.draft_weights = self.draft_cache = self.draft_lanes = None
        if spec_draft is None:
            return
        dcfg, dweights = spec_draft
        if dcfg.vocab_size != self.cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        # the draft's window binds too: its ring cannot roll back a rejection
        self.spec_edge = min(self.cfg.max_seq_len, dcfg.max_seq_len)
        if self.mesh is not None:
            # the draft shards over the SAME mesh with its own cache; its
            # ticks and prefill ride the target's wire (scheduler.py:947-1000)
            from .parallel.fast_tp import MeshLanes, draft_unsupported, mesh_weights
            why = draft_unsupported(dcfg, self.mesh)
            if why:
                raise ValueError(why)
            self.draft_cfg = dcfg
            self.draft_weights = mesh_weights(dcfg, dweights, self.mesh)
            self.draft_lanes = MeshLanes(dcfg, self.draft_weights, self.mesh, self.B,
                                         self.kv_dtype, tag=1)
            self.lanes.add_peer(self.draft_lanes)
            return
        why = fast_unsupported(dcfg)
        if why:
            raise ValueError(f"the draft's shapes do not fit the port's kernels: {why}")
        if dweights.wqkv.device.type != self.device.type:
            raise ValueError(f"draft weights on {dweights.wqkv.device}, scheduler on "
                             f"{self.device}")
        self.draft_cfg, self.draft_weights = dcfg, dweights
        # a dense batched draft cache, also under a paged target
        self.draft_cache = KVCache.init(dcfg, self.kv_dtype, self.device, batch=self.B)

    def _init_tree(self, spec_tree) -> None:
        """Tree-attention Medusa's static tree (scheduler.py:884-936): the
        cartesian tree of the branching factors, each node's depth and its
        rank among its siblings (which head candidate it holds)."""
        self.spec_tree = None
        if spec_tree is None:
            return
        self.spec_tree = tuple(int(k) for k in spec_tree)
        H = self.spec_medusa.n_heads
        if len(self.spec_tree) > H:
            raise ValueError(f"tree depth {len(self.spec_tree)} > {H} medusa heads")
        if any(k < 1 for k in self.spec_tree):
            raise ValueError("tree branching factors must be >= 1")
        parents = cartesian_tree(self.spec_tree)
        self._tree_parents = parents
        self._tree_depths = tree_depths(parents)
        self._tree_kmax = max(self.spec_tree)
        self._tree_H = len(self.spec_tree)
        siblings_before = [0] * len(parents)   # children of each node seen so far
        self._tree_branch = [0] * len(parents)
        for i, p in enumerate(parents):
            if p >= 0:
                self._tree_branch[i] = siblings_before[p]
                siblings_before[p] += 1

    def _new_cache(self) -> None:
        """A zeroed cache (a pool and its allocator when paged; on a mesh
        every rank's share, through MeshLanes)."""
        if self.mesh is not None:
            from .parallel.fast_tp import MeshLanes
            self.cache = None
            if self.paged:
                self.alloc = GroupedPageAllocator(self.cfg, self.n_pages, self.B, self.page_size,
                                                  groups=self.mesh.shape["dp"])
            if getattr(self, "lanes", None) is None:
                self.lanes = MeshLanes(self.cfg, self.weights, self.mesh, self.B, self.kv_dtype,
                                       paged_pages=self.n_pages, page_size=self.page_size)
            else:
                self.lanes.reset()
            return
        if self.paged:
            self.cache = PagedKVPool.init(self.cfg, self.kv_dtype, self.n_pages,
                                          self.page_size, self.device)
            self.alloc = PageAllocator(self.cfg, self.n_pages, self.B, self.page_size)
        else:
            self.cache = KVCache.init(self.cfg, self.kv_dtype, self.device, batch=self.B)

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> Request:
        if not request.prompt_tokens:
            raise ValueError("prompt_tokens must be non-empty (include BOS)")
        if request.logit_bias and len(request.logit_bias) > _NBIAS:
            raise ValueError(f"logit_bias supports at most {_NBIAS} entries "
                             f"(got {len(request.logit_bias)})")
        if request.logit_bias and self.spec:
            raise ValueError("logit_bias is not supported in speculative scheduler modes")
        self.queue.append(request)
        return request

    @property
    def n_active(self) -> int:
        return sum(not s.free for s in self.slots)

    @property
    def prefix_stats(self) -> Optional[dict]:
        """Prompt-reuse counters: the paged pool's shared pages, or the
        dense lane-copy registry, if on."""
        if self.paged:
            return self.alloc.prefix_stats
        return self.dense_prefix.stats if self.dense_prefix is not None else None

    def _admit(self) -> None:
        """Assign queued requests to free slots; their prompts hydrate in
        bounded chunks interleaved with decode ticks (_advance_admission).

        Paged mode maps only the first chunk's page here (after the prefix
        match, whose shared pages draw nothing from the free list); when the
        pool is exhausted new requests wait in the queue (admission never
        preempts), and a request whose worst case exceeds a lane's capacity
        fails at once instead of preempting itself forever."""
        window = self.cfg.max_seq_len
        for b, slot in enumerate(self.slots):
            if not self.queue or not slot.free:
                continue
            req = self.queue[0]
            if self.paged:
                worst = self.alloc.pages_for(min(
                    window, len(req.prompt_tokens) + req.max_new_tokens + 1))
                if worst > self.alloc.lane_capacity:
                    self.queue.pop(0)
                    req.error = (f"request needs {worst} pages; a lane's "
                                 f"pool holds {self.alloc.lane_capacity}")
                    req.done = True
                    continue
                if not self.alloc.can_grow(b, min(window, self.page_size)):
                    continue
            self.queue.pop(0)
            slot.request = req
            slot.admitting = True
            slot.pos = 0
            slot.admit_i = 0
            slot.spec_ok = False   # set by _spec_hydrate when the prompt lands
            slot.hist = slot.med_props = None
            self._admit_seq += 1
            slot.seq = self._admit_seq
            if req._resume is not None:
                slot.admit_tokens, slot.last_token = req._resume
                slot.resuming = True
            else:
                slot.admit_tokens = req.prompt_tokens
                slot.resuming = False
            if self.paged:
                matched = 0
                if not slot.resuming and self._prefix_cacheable(slot):
                    # automatic prefix caching: a cached full-page prefix maps
                    # read-only shared pages and skips their prefill
                    matched = self.alloc.match_prefix(b, slot.admit_tokens)
                    slot.pos = slot.admit_i = matched
                # the earlier can_grow may have counted evictable cached pages
                # that the match itself just re-referenced: un-admit cleanly
                if not self.alloc.can_grow(b, min(window, matched + 1)):
                    self.alloc.release(b)   # drops the matched references
                    slot.request = None
                    slot.admitting = False
                    self.queue.insert(0, req)
                    continue
                self.alloc.grow(b, min(window, matched + 1))
                continue
            if self.dense_prefix is None:
                continue
            if not slot.resuming and self._prefix_cacheable(slot):
                # copy the best-matching lane's cache and skip prefilling the
                # common prefix (always leaving >= 1 token for the logits)
                limit = min(len(slot.admit_tokens) - 1, self.cfg.max_seq_len - 1)
                src, matched = self.dense_prefix.match(slot.admit_tokens, limit)
                if matched:
                    if src != b:
                        # rows past the prefix are src garbage that causal
                        # masking never exposes and admission overwrites
                        self.cache.k[b].copy_(self.cache.k[src])
                        self.cache.v[b].copy_(self.cache.v[src])
                    slot.pos = matched
                    slot.admit_i = matched
                    self.dense_prefix.stats["hits"] += 1
                    self.dense_prefix.stats["hit_tokens"] += matched
            # either way this lane's rows are about to be overwritten
            self.dense_prefix.invalidate_lane(b)

    def _prefix_cacheable(self, slot: _Slot) -> bool:
        """Only lanes that can never enter the ring regime (which rewrites
        early rows in place) may reuse or publish a prefix."""
        req = slot.request
        return (req is not None
                and len(slot.admit_tokens) + req.max_new_tokens + 1 <= self.cfg.max_seq_len)

    @staticmethod
    def _bias_row(req) -> tuple[np.ndarray, np.ndarray]:
        ids = np.full((_NBIAS,), -1, np.int64)
        vals = np.zeros((_NBIAS,), np.float32)
        if req is not None and req.logit_bias:
            for j, (t, v) in enumerate(list(req.logit_bias.items())[:_NBIAS]):
                ids[j] = int(t)
                vals[j] = float(v)
        return ids, vals

    def _bias_arrays(self, lanes) -> tuple[np.ndarray, np.ndarray]:
        """(B, _NBIAS) logit-bias ids/values of the tick's lanes; other lanes
        get empty rows."""
        ids = np.full((self.B, _NBIAS), -1, np.int64)
        vals = np.zeros((self.B, _NBIAS), np.float32)
        for b, s in enumerate(self.slots):
            if b in lanes and s.request.logit_bias:
                ids[b], vals[b] = self._bias_row(s.request)
        return ids, vals

    def _pack(self, logits, rows: list[tuple], bias) -> torch.Tensor:
        """_sample_pack over `rows` of (seed, position, temperature, top_k,
        top_p), uploaded as one small host array."""
        cols = np.asarray(rows, np.float64).T
        dev = logits.device
        ints = torch.as_tensor(cols[[0, 1, 3]].astype(np.int64), device=dev)
        flts = torch.as_tensor(cols[[2, 4]].astype(np.float32), device=dev)
        return _sample_pack(logits, ints[0], ints[1], flts[0], ints[2], flts[1],
                            torch.as_tensor(bias[0], device=dev),
                            torch.as_tensor(bias[1], device=dev), self.topn)

    @staticmethod
    def _sampling_row(req, pos: int) -> tuple:
        return (req.seed & 0xFFFFFFFF, pos, req.temperature, req.top_k, req.top_p)

    def _finish_admission(self, slot: _Slot, logits: torch.Tensor) -> None:
        """Sample the first generated token, keyed by (seed, position)."""
        req = slot.request
        ids, vals = self._bias_row(req)
        packed = self._pack(logits.reshape(1, -1), [self._sampling_row(req, slot.pos)],
                            (ids[None], vals[None]))
        nxt, lps, tops = _unpack_sample(packed, self.topn)
        self._finish_admission_token(slot, int(nxt[0]), float(lps[0]),
                                     tops[0] if tops else None)

    def _finish_admission_token(self, slot: _Slot, first: int, lp: float | None = None,
                                top=None) -> None:
        slot.admitting = False
        slot.last_token = first
        if not slot.resuming and self._prefix_cacheable(slot):
            # the prompt's rows are all written now: publish them (the
            # pool's full pages, or the dense lane)
            if self.paged:
                self.alloc.register_prefix(self.slots.index(slot), slot.admit_tokens)
            elif self.dense_prefix is not None:
                self.dense_prefix.register(self.slots.index(slot), slot.admit_tokens)
        if self.spec:
            self._spec_hydrate(slot)
        if self._emit_checked(slot, first, lp, top):
            self._maybe_finish(slot, first)

    def _spec_hydrate(self, slot: _Slot) -> None:
        """Hydrate the proposal source with the finished prompt
        (scheduler.py:1269-1303): the draft's cache lane, or the lane's
        n-gram index (with the first sampled token, which the next proposal
        continues); Medusa lanes get their hidden row from their first
        verify sweep. Lanes whose prompt already reaches the speculation
        edge stay on plain ticks."""
        toks = slot.admit_tokens
        b = self.slots.index(slot)
        if slot.pos != len(toks) or slot.pos + self.spec_k + 1 >= self.spec_edge:
            slot.spec_ok = False
            return
        slot.spec_ok = True
        if self.spec_lookup:
            slot.hist = NgramHistory(list(toks) + [slot.last_token], max_ngram=self.spec_ngram)
            return
        if self.spec_medusa is not None:
            slot.med_props = None
            return
        dcfg = self.draft_cfg
        for i0, take, bucket in chunk_schedule(len(toks), 0, dcfg.max_seq_len):
            padded = np.zeros(bucket, np.int64)
            padded[:take] = toks[i0: i0 + take]
            attend = attend_bucket(i0 + bucket, dcfg.max_seq_len)
            if self.draft_lanes is not None:
                self.draft_lanes.prefill(b, padded, i0, take, "none", attend)
            else:
                prefill_fast(dcfg, self.draft_weights, padded, i0, take, self.draft_cache.lane(b),
                             logits_mode="none", attend_len=attend)

    def _finish_resume(self, slot: _Slot) -> None:
        """End a preemption-resume re-hydration: the stream's tokens were all
        emitted before the preemption, so nothing is emitted here; the lane
        rejoins the batched decode at its old position (admit_tokens is
        prompt + generated[:-1], last_token generated[-1])."""
        slot.admitting = False
        slot.resuming = False
        slot.request._resume = None
        self.resumes += 1
        if self.spec:
            # admit_tokens is prompt + generated[:-1] and last_token
            # generated[-1]: the rebuilt source equals the uninterrupted one
            self._spec_hydrate(slot)
        self._maybe_finish(slot, slot.last_token)

    def _finish_chunk(self, slot: _Slot, logits) -> None:
        """The last prompt chunk landed: sample the first token, or, for a
        resumed lane, rejoin the decode silently."""
        if slot.resuming:
            self._finish_resume(slot)
        else:
            self._finish_admission(slot, logits)

    # -- paged lazy growth / preemption --------------------------------
    def _preempt(self, b: int) -> None:
        """Release lane b's pages and requeue its request at the FRONT with a
        resume point, so its stream continues without re-emitting: the lane
        re-hydrates prompt + generated[:-1] silently, then decodes from
        generated[-1]. Sampling keys derive from (seed, position), so the
        resumed stream equals the uninterrupted one."""
        slot = self.slots[b]
        req = slot.request
        if not slot.admitting and req.generated:
            req._resume = (list(req.prompt_tokens) + req.generated[:-1], req.generated[-1])
        # an admitting lane restarts its (possibly resumed) hydration: its
        # partial pass emitted nothing, so a plain retry is safe
        self.alloc.release(b)
        slot.request = None
        slot.admitting = False
        slot.spec_ok = False
        slot.hist = slot.med_props = None
        self.queue.insert(0, req)
        self.preemptions += 1

    def _ensure_pages(self, b: int, target_len: int) -> bool:
        """Grow lane b's table to hold target_len tokens, preempting the
        newest busy lane(s) while the pool is exhausted. Returns False if
        lane b itself was the newest and got preempted (callers skip it)."""
        while not self.alloc.can_grow(b, target_len):
            victim, vseq = None, -1
            for i, s in enumerate(self.slots):
                if s.request is not None and s.seq > vseq and self.alloc.same_pool(b, i):
                    victim, vseq = i, s.seq
            if victim is None:
                raise RuntimeError("page pool exhausted with no lane to preempt")
            self._preempt(victim)
            if victim == b:
                return False
        self.alloc.grow(b, target_len)
        return True

    def _hydrate_paged_lane(self, b: int, token: int, pos: int) -> torch.Tensor:
        """Ring-regime hydration of ONE paged lane: one masked tick in which
        only lane b writes. Returns the lane's logits row."""
        tokens = np.zeros(self.B, np.int64)
        tokens[b] = token
        positions = np.array([s.pos for s in self.slots], np.int64)
        positions[b] = pos
        write = np.zeros(self.B, np.int64)
        write[b] = 1
        if self.mesh is not None:
            return self.lanes.tick(tokens, positions, write, self.alloc.table_array())[b]
        logits, _ = decode_step_fast_batched_paged(
            self.cfg, self.weights, tokens, positions, self.cache, self.alloc.table_array(),
            write, page_size=self.page_size)
        return logits[b]

    def _advance_admission(self) -> None:
        """Advance every admitting slot by at most ONE prefill chunk (or a
        bounded number of ring-regime tokens), while decode lanes keep
        producing a token every tick. Paged chunks stop at the page
        boundary, and their page is mapped first (which may preempt)."""
        window = self.cfg.max_seq_len
        ps = self.page_size
        handled = (self._advance_admission_batched(window)
                   if self.batched_admission else set())
        for b, slot in enumerate(self.slots):
            if b in handled or not slot.admitting:
                continue
            toks = slot.admit_tokens
            n = len(toks)
            if slot.pos < window and slot.admit_i < n:
                room = window - slot.pos
                take = min(n - slot.admit_i, PREFILL_BUCKETS[-1], room)
                if self.paged:
                    take = min(take, ps - slot.pos % ps)
                    if not self._ensure_pages(b, min(window, slot.pos + take)):
                        continue  # this lane was the preemption victim
                bucket = _bucket_for(take)
                if bucket > room or (self.paged and slot.pos % ps + bucket > ps):
                    bucket = take
                padded = np.zeros(bucket, np.int64)
                padded[:take] = toks[slot.admit_i: slot.admit_i + take]
                last = slot.admit_i + take >= n
                mode = "last" if last and not slot.resuming else "none"
                attend = attend_bucket(slot.pos + bucket, window)
                if self.paged:
                    table_b = self.alloc.tables[b]
                    page, row0 = int(table_b[slot.pos // ps]), slot.pos % ps
                    if self.mesh is not None:   # page ids local to lane b's dp group
                        out = self.lanes.prefill(b, padded, slot.pos, take, mode, attend,
                                                 table_b, page, row0)
                    else:
                        out, _ = prefill_fast_paged(
                            self.cfg, self.weights, padded, slot.pos, take, self.cache,
                            table_b, page, row0, logits_mode=mode, page_size=ps,
                            attend_len=attend)
                elif self.mesh is not None:
                    out = self.lanes.prefill(b, padded, slot.pos, take, mode, attend)
                elif self.fast:
                    out, _ = prefill_fast(self.cfg, self.weights, padded, slot.pos, take,
                                          self.cache.lane(b), logits_mode=mode,
                                          attend_len=attend)
                else:
                    out, _ = prefill(self.cfg, self.weights, padded, slot.pos, take,
                                     self.cache.lane(b), logits_mode=mode,
                                     compute_dtype=self.compute_dtype)
                slot.pos += take
                slot.admit_i += take
                if last:
                    self._finish_chunk(slot, out)
                continue
            # ring-buffer regime: bounded per-token hydration
            budget = self.RING_HYDRATE_PER_TICK
            while budget > 0 and slot.admit_i < n:
                last = slot.admit_i + 1 >= n
                if self.paged:
                    out = self._hydrate_paged_lane(b, toks[slot.admit_i], slot.pos)
                else:
                    out = self._lane_step(b, toks[slot.admit_i], slot.pos,
                                          last and not slot.resuming)
                slot.pos += 1
                slot.admit_i += 1
                budget -= 1
                if last:
                    self._finish_chunk(slot, out)

    def _lane_step(self, b: int, token: int, pos: int, output_logits: bool = True):
        """One decode step of lane b alone on its view of the dense cache
        (the kernels' decode_step_fast, or the oracle's decode_step; on a
        mesh, broadcast to every rank)."""
        if self.mesh is not None:
            return self.lanes.step(b, token, pos, output_logits)
        lane = self.cache.lane(b)
        if self.fast:
            return decode_step_fast(self.cfg, self.weights, token, pos, lane,
                                    output_logits=output_logits)[0]
        return decode_step(self.cfg, self.weights, token, pos, lane, output_logits=output_logits,
                           compute_dtype=self.compute_dtype)[0]

    def _advance_admission_batched(self, window: int) -> set[int]:
        """Advance every groupable admitting slot by one chunk in ONE batched
        weight sweep (prefill_chunk_fast_batched[_paged]). Returns the slots
        handled; lanes whose shared padded bucket would cross the window
        edge, and a lone admission (the per-slot program is cheaper), stay
        per slot. Paged: every lane's chunk pages are mapped before the
        sweep; that may preempt the newest lane, possibly one of the work
        list, which is then re-validated."""
        work: list[tuple[int, _Slot, int]] = []
        bucket = 0
        for b, slot in enumerate(self.slots):
            if slot.request is None or not slot.admitting:
                continue
            if slot.pos >= window or slot.admit_i >= len(slot.admit_tokens):
                continue
            take = min(len(slot.admit_tokens) - slot.admit_i, PREFILL_BUCKETS[-1],
                       window - slot.pos)
            work.append((b, slot, take))
            bucket = max(bucket, _bucket_for(take))
        work = [(b, s, t) for b, s, t in work if s.pos + bucket <= window]
        if len(work) < 2:
            return set()
        if self.paged:
            for b, slot, take in work:
                # skip a lane an earlier growth preempted: growing its free
                # slot would map pages nobody releases (the JAX scheduler's
                # loop, scheduler.py:1460-1461, grows it all the same)
                if slot.admitting:
                    self._ensure_pages(b, min(window, slot.pos + take))
            work = [(b, s, t) for b, s, t in work
                    if s.request is not None and s.admitting
                    and self.alloc.mapped_through(b, min(window, s.pos + t))]
            if not work:
                return set()
        tokens = np.zeros((self.B, bucket), np.int64)
        pos0 = np.zeros(self.B, np.int64)
        vlen = np.zeros(self.B, np.int64)
        enable = np.zeros(self.B, np.int64)
        attend = 0
        for b, slot, take in work:
            tokens[b, :take] = slot.admit_tokens[slot.admit_i: slot.admit_i + take]
            pos0[b], vlen[b], enable[b] = slot.pos, take, 1
            attend = max(attend, attend_bucket(slot.pos + bucket, window))
        self.admit_sweeps += 1
        if self.paged:
            out, _ = prefill_chunk_fast_batched_paged(
                self.cfg, self.weights, tokens, pos0, vlen, enable, self.cache,
                self.alloc.table_array(), page_size=self.page_size, attend_len=attend)
        else:
            out, _ = prefill_chunk_fast_batched(self.cfg, self.weights, tokens, pos0, vlen,
                                                enable, self.cache, attend_len=attend)
        for b, slot, take in work:
            slot.pos += take
            slot.admit_i += take
            if slot.admit_i >= len(slot.admit_tokens):
                self._finish_chunk(slot, out[b])
        return {b for b, _, _ in work}

    def _free_slot(self, slot: _Slot) -> None:
        slot.request = None
        slot.admitting = False
        if self.paged:
            self.alloc.release(self.slots.index(slot))

    def _maybe_finish(self, slot: _Slot, tok: int) -> None:
        req = slot.request
        if req is None:
            return
        if req.cancelled or tok in req.stop_tokens or len(req.generated) >= req.max_new_tokens:
            req.done = True
            self._free_slot(slot)

    def _fail_slot(self, slot: _Slot, err: Exception) -> None:
        """Fail ONE request (e.g. its on_token callback raised) without
        touching any other lane."""
        req = slot.request
        if req is not None:
            req.error = f"{type(err).__name__}: {err}"
            req.done = True
        self._free_slot(slot)

    def _emit_checked(self, slot: _Slot, tok: int, lp: float | None = None, top=None) -> bool:
        """Emit a token to a request, failing only that request if its
        callback raises. Returns False when the slot was failed."""
        try:
            slot.request._emit(tok, lp, top)
            return True
        except Exception as e:  # noqa: BLE001 -- isolate the poisoned request
            self._fail_slot(slot, e)
            return False

    def recover(self, err: Exception | None = None) -> None:
        """Recover from a failed tick: fail every ACTIVE request (its cache
        lane may hold a half-written step), free the cache (the pool and its
        allocator when paged) before a new one is allocated, and keep all
        QUEUED requests, which never touched the device."""
        msg = f"{type(err).__name__}: {err}" if err is not None else "tick failed"
        for slot in self.slots:
            if slot.request is not None:
                slot.request.error = msg
                slot.request.done = True
            slot.request = None
            slot.admitting = False
        if self.dense_prefix is not None:
            self.dense_prefix.entries.clear()
        self.cache = None
        if self.draft_cache is not None:
            self.draft_cache.k.zero_()
            self.draft_cache.v.zero_()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._new_cache()
        if self.draft_lanes is not None:
            self.draft_lanes.reset()

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Admit, advance in-flight admissions by one bounded chunk, then run
        one batched decode tick for the decoding lanes. Returns the number of
        busy slots (decoding or admitting)."""
        self._admit()
        self._advance_admission()
        window = self.cfg.max_seq_len
        if self.paged:
            # lazy growth at block boundaries: map the page the next write
            # lands in (a lane in the ring regime is fully mapped already); a
            # speculating lane needs the verify chunk's rows pos..pos+K
            for b, slot in enumerate(self.slots):
                if slot.decoding and slot.pos < window:
                    ahead = self.spec_k + 1 if self.spec and slot.spec_ok else 1
                    self._ensure_pages(b, min(window, slot.pos + ahead))
        if self.spec:
            self._spec_round()
        else:
            self._plain_tick([b for b, s in enumerate(self.slots) if s.decoding])
        return sum(not s.free for s in self.slots)

    def _plain_tick(self, lanes: list[int]) -> None:
        """One batched decode tick in which the given decoding lanes write
        and sample with their own parameters; every other lane is masked."""
        if not lanes:
            return
        on = set(lanes)
        rows = [self._sampling_row(s.request, s.pos) if b in on else (0, s.pos, 0.0, 0, 1.0)
                for b, s in enumerate(self.slots)]
        args = (self.cfg, self.weights, [s.last_token for s in self.slots],
                [s.pos for s in self.slots], self.cache)
        write = [int(b in on) for b in range(self.B)]
        if self.mesh is not None:
            logits = self.lanes.tick(args[2], args[3], write,
                                     self.alloc.table_array() if self.paged else None)
        elif self.paged:
            logits, _ = decode_step_fast_batched_paged(
                *args, self.alloc.table_array(), write, page_size=self.page_size)
        elif self.fast:
            logits, _ = decode_step_fast_batched(*args, write)
        else:
            # the oracle's tick: each writing lane's decode_step on its view
            # (the vmapped step with write_mask; masked lanes' rows are unread)
            logits = torch.zeros((self.B, self.cfg.vocab_size), dtype=torch.float32,
                                 device=self.device)
            for b in lanes:
                logits[b] = self._lane_step(b, self.slots[b].last_token, self.slots[b].pos)
        packed = self._pack(logits, rows, self._bias_arrays(on))
        nxt, lps, tops = _unpack_sample(packed, self.topn)
        for b in lanes:
            slot = self.slots[b]
            tok = int(nxt[b])
            slot.pos += 1
            slot.last_token = tok
            if self.spec_lookup and slot.spec_ok and slot.hist is not None:
                slot.hist.extend([tok])   # stays eligible next round
            if self._emit_checked(slot, tok, float(lps[b]), tops[b] if tops else None):
                self._maybe_finish(slot, tok)

    # -- speculation ------------------------------------------------------
    def _draft_propose(self, tokens: np.ndarray, positions: np.ndarray,
                       write: np.ndarray) -> np.ndarray:
        """K+1 greedy ticks of the draft over its batched cache (the lanes
        with write 1 write); the (K+1)-th hydrates the draft's row for
        d[K-1], which full acceptance keeps visible. Returns (B, K+1) ids,
        read back once."""
        K = self.spec_k
        if self.draft_lanes is not None:
            return self.draft_lanes.propose(tokens, positions, write, K)
        out = torch.empty((self.B, K + 1), dtype=torch.long, device=self.device)
        toks = torch.as_tensor(tokens, device=self.device)
        for i in range(K + 1):
            logits, _ = decode_step_fast_batched(self.draft_cfg, self.draft_weights, toks,
                                                 positions + i, self.draft_cache, write)
            toks = torch.argmax(logits, dim=-1)
            out[:, i] = toks
        return out.cpu().numpy()

    def _spec_round(self) -> None:
        """One speculative round (scheduler.py:1636-1781): the proposal
        source gives each eligible lane a chunk [cur, d0..], ONE batched
        sweep verifies all of them, and each lane emits its longest accepted
        prefix plus a correction (up to spec_k+1 tokens). Lanes at the
        speculation edge leave the spec path for good; lookup lanes with no
        match ride this round's plain subtick and stay eligible."""
        if self.spec_tree is not None:
            return self._spec_round_tree()
        K = self.spec_k
        elig, props = [], {}
        for b, s in enumerate(self.slots):
            if not s.decoding:
                continue
            if s.spec_ok and s.pos + K + 1 < self.spec_edge:
                if self.spec_lookup:
                    d = s.hist.propose(K)
                    if d:
                        elig.append(b)
                        props[b] = d
                else:
                    elig.append(b)
            else:
                s.spec_ok = False   # once off the spec path, stay off
        on = set(elig)
        plain = [b for b, s in enumerate(self.slots) if s.decoding and b not in on]
        if elig:
            self._verify_round(elig, props)
        self._plain_tick(plain)

    def _verify_round(self, elig: list[int], props: dict) -> None:
        K = self.spec_k
        B = self.B
        positions = np.zeros(B, np.int64)
        write = np.zeros(B, np.int64)
        chunk = np.zeros((B, K + 1), np.int64)
        for b in elig:
            positions[b] = self.slots[b].pos
            write[b] = 1
            chunk[b, 0] = self.slots[b].last_token
        if self.spec_lookup:
            # per-lane proposal lengths; rows past 1+kd are padding that the
            # causal verify never lets rows <= kd see
            kd = {b: len(props[b]) for b in elig}
            for b in elig:
                chunk[b, 1: 1 + kd[b]] = props[b]
        elif self.spec_medusa is not None:
            # proposals banked by the previous round's sweep (a fresh lane
            # has none and rides the sweep for its hidden row and one token)
            kd = {}
            for b in elig:
                p = (self.slots[b].med_props or [])[:K]
                kd[b] = len(p)
                chunk[b, 1: 1 + len(p)] = p
        else:
            d = self._draft_propose(chunk[:, 0].copy(), positions, write)
            kd = {b: K for b in elig}
            for b in elig:
                chunk[b, 1:] = d[b, :K]
        window = self.cfg.max_seq_len
        attend = max(attend_bucket(int(positions[b]) + K + 1, window) for b in elig)
        wh = self.spec_medusa is not None
        if self.mesh is not None:
            out = self.lanes.verify(chunk, positions, write, wh, attend,
                                    self.alloc.table_array() if self.paged else None)
        elif self.paged:
            out, _ = verify_chunk_fast_batched_paged(
                self.cfg, self.weights, chunk, positions, write, self.cache,
                self.alloc.table_array(), page_size=self.page_size, with_hidden=wh,
                attend_len=attend)
        else:
            out, _ = verify_chunk_fast_batched(self.cfg, self.weights, chunk, positions, write,
                                               self.cache, with_hidden=wh, attend_len=attend)
        reqs = {b: self.slots[b].request for b in elig}
        ints = np.zeros((3, B), np.int64)      # seeds, top_k, kd
        flts = np.stack([np.zeros(B, np.float32), np.ones(B, np.float32)])   # temp, top_p
        for b in elig:
            r = reqs[b]
            ints[:, b] = (r.seed & 0xFFFFFFFF, r.top_k, kd[b])
            flts[:, b] = (r.temperature, r.top_p)
        envelope = any(r.temperature > 0 and (r.top_k > 0 or r.top_p < 1.0)
                       for r in reqs.values())
        dev = self.device
        it, ft = torch.as_tensor(ints, device=dev), torch.as_tensor(flts, device=dev)
        args = (torch.as_tensor(chunk, device=dev), it[0], torch.as_tensor(positions, device=dev),
                ft[0], it[1], ft[1])
        if wh:
            logits, hidden = out
            vp = _verify_pack_medusa(logits, *args, it[2], hidden, self.spec_medusa,
                                     topn=self.topn, envelope=envelope)
        else:
            vp = _verify_pack(out, *args, topn=self.topn, envelope=envelope)
        vp = vp.cpu().numpy()                  # the one device -> host read of the round
        acc = vp[..., 0] > 0.5                 # (B, K+1)
        self.spec_stats["rounds"] += 1
        for b in elig:
            s = self.slots[b]
            a = 0
            while a < kd[b] and acc[b, a]:
                a += 1
            # the first rejection -> the residual correction; all kd
            # accepted -> the bonus drawn at the last verified row
            corr_col = 2 if a < kd[b] else 4
            emitted = [int(x) for x in chunk[b, 1: a + 1]] + [int(vp[b, a, corr_col])]
            self.spec_stats["accepted"] += a
            self.spec_stats["proposed"] += kd[b]
            s.pos = int(positions[b]) + a + 1
            s.last_token = emitted[-1]
            if self.spec_lookup:
                s.hist.extend(emitted)
            if wh:
                H = min(self.spec_medusa.n_heads, K)
                s.med_props = [int(vp[b, h, -1]) for h in range(H)]
            for i, tok in enumerate(emitted):
                if s.request is None:
                    break   # finished mid-round: the tail is discarded
                # i < a: the accepted proposal chunk[b, i+1]; i == a: the correction
                lp = float(vp[b, i, 1] if i < a else vp[b, i, corr_col + 1])
                top = None
                if self.topn:
                    top = [(int(vp[b, i, 6 + k]), float(vp[b, i, 6 + self.topn + k]))
                           for k in range(self.topn)]
                if self._emit_checked(s, tok, lp, top):
                    self._maybe_finish(s, tok)
                else:
                    break

    def _spec_round_tree(self) -> None:
        """One tree-attention Medusa round (scheduler.py:1828-1930): each
        greedy lane's banked per-depth head candidates form its cartesian
        tree, ONE sweep scores every chain (verify_tree_fast_batched), the
        walk on the device descends to the child matching each row's argmax
        and the final node's hidden row banks the next round's candidates,
        all in one read; the accepted path's K/V rows are scattered into
        the ring after the walk. A lane with no banked candidates runs a
        root-only round. Lanes with T > 0 ride the plain tick (the tree's
        accept rule is argmax matching) and stay eligible; greedy lanes at
        the speculation edge leave the spec path."""
        Dmax = max(self._tree_depths)
        elig, fresh = [], set()
        for b, s in enumerate(self.slots):
            if not s.decoding:
                continue
            if s.spec_ok and s.request.temperature == 0.0 and s.pos + Dmax + 1 < self.spec_edge:
                elig.append(b)
                if not s.med_props:
                    fresh.add(b)
            elif s.request.temperature == 0.0:
                s.spec_ok = False
        on = set(elig)
        plain = [b for b, s in enumerate(self.slots) if s.decoding and b not in on]
        if elig:
            self._tree_round(elig, fresh)
        self._plain_tick(plain)

    def _tree_round(self, elig: list[int], fresh: set) -> None:
        parents, depths = self._tree_parents, self._tree_depths
        Tn, Dmax = len(parents), max(depths)
        H, kmax, topn = self._tree_H, self._tree_kmax, self.topn
        B = self.B
        chunk = np.zeros((B, Tn), np.int64)
        positions = np.zeros(B, np.int64)
        live = np.zeros(B, np.int64)
        enable = np.zeros(B, np.int64)
        for b in elig:
            s = self.slots[b]
            positions[b], enable[b], chunk[b, 0] = s.pos, 1, s.last_token
            if b not in fresh:
                live[b] = 1
                for i in range(1, Tn):   # node i holds its depth's head's candidate of its rank
                    chunk[b, i] = s.med_props[depths[i] - 1][self._tree_branch[i]]
        window = self.cfg.max_seq_len
        attend = max(attend_bucket(int(positions[b]) + Dmax + 1, window) for b in elig)
        (logits, hidden), (ktree, vtree) = verify_tree_fast_batched(
            self.cfg, self.weights, chunk, positions, enable, self.cache, parents=parents,
            with_hidden=True, attend_len=attend)
        dev = self.device
        vp = _verify_pack_tree(logits, torch.as_tensor(chunk, device=dev),
                               torch.as_tensor(live, device=dev), hidden, self.spec_medusa,
                               parents=parents, kmax=kmax, topn=topn)
        vp = vp.cpu().numpy()                  # the one device -> host read of the round
        self.spec_stats["rounds"] += 1
        fin_col = 3 + 2 * topn
        rows = np.zeros((B, Dmax + 1), np.int64)
        nrows = np.zeros(B, np.int64)
        for b in elig:
            s = self.slots[b]
            fin = int(vp[b, 0, fin_col])
            path = [fin]
            while parents[path[-1]] >= 0:
                path.append(parents[path[-1]])
            path.reverse()                     # root .. fin
            a = len(path) - 1                  # accepted proposals
            rows[b, :a + 1] = path
            nrows[b] = a + 1
            emitted = [int(chunk[b, p]) for p in path[1:]] + [int(vp[b, fin, 0])]
            self.spec_stats["accepted"] += a
            # proposed: the candidate chain's length, the chain scheduler's K
            self.spec_stats["proposed"] += 0 if b in fresh else Dmax
            s.pos = int(positions[b]) + a + 1
            s.last_token = emitted[-1]
            s.med_props = [[int(vp[b, 0, fin_col + 1 + h * kmax + k]) for k in range(kmax)]
                           for h in range(H)]
            for i, tok in enumerate(emitted):
                if s.request is None:
                    break   # finished mid-round: the tail is discarded
                # i < a: path[i+1]'s token, scored by its parent row path[i];
                # i == a: the correction at the final row
                lp = float(vp[b, path[i + 1], 2] if i < a else vp[b, fin, 1])
                top = None
                if topn:
                    top = [(int(vp[b, path[i], 3 + k]), float(vp[b, path[i], 3 + topn + k]))
                           for k in range(topn)]
                if self._emit_checked(s, tok, lp, top):
                    self._maybe_finish(s, tok)
                else:
                    break
        scatter_tree_rows(self.cache, ktree, vtree, positions, rows, nrows)

    def follow(self) -> None:
        """A follower rank of a mesh: run the leader's device work until it
        stops the followers (parallel/fast_tp.MeshLanes.follow)."""
        if self.mesh is None or self.mesh.leader:
            raise ValueError("follow() runs on the follower ranks of a mesh")
        self.lanes.follow()

    def stop_followers(self) -> None:
        """The leader of a mesh: end the followers' loops (a no-op
        elsewhere)."""
        if self.mesh is not None and self.mesh.leader:
            self.lanes.stop()

    def run(self, max_ticks: int = 100000) -> None:
        """Drive until every queued and active request completes."""
        for _ in range(max_ticks):
            if not self.queue and self.n_active == 0:
                return
            self.step()
        raise RuntimeError("scheduler did not converge within max_ticks")
