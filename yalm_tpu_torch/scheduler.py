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

Speculation (`spec_*`) and meshes come in later slices of the port
(ROADMAP.md) and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .config import ModelConfig
from .engine import PREFILL_BUCKETS, _bucket_for, attend_bucket, resolve_device
from .models.cache import KVCache
from .models.fast import (FastWeights, decode_step_fast, decode_step_fast_batched,
                          decode_step_fast_batched_paged, fast_unsupported,
                          prefill_chunk_fast_batched, prefill_chunk_fast_batched_paged,
                          prefill_fast, prefill_fast_paged)
from .models.paged import PageAllocator, PagedKVPool
from .sampler import sample_rows

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

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def decoding(self) -> bool:
        return self.request is not None and not self.admitting


class Scheduler:
    """Continuous batching over FastWeights on one device (default the
    card; "cpu" runs the kernels' plain versions)."""

    # how many ring-regime prompt tokens hydrate per tick for ONE admitting
    # slot (each is a full per-token decode step, so this bounds the stall
    # a beyond-window prompt can impose between decode ticks)
    RING_HYDRATE_PER_TICK = 16

    def __init__(self, cfg: ModelConfig, weights: FastWeights, *, batch: int = 8,
                 kv_dtype: torch.dtype = torch.bfloat16, batched_admission: bool = False,
                 prefix_cache: bool = False, top_logprobs: int = 0, device="cuda",
                 paged_pages: int = 0, page_size: int = 256, mesh=None, spec_draft=None,
                 spec_lookup: bool = False, spec_medusa=None, spec_tree=None):
        """batched_admission: all admitting lanes' chunks hydrate in ONE
        weight sweep (the chunk pads to the group's bucket, so a lane's
        prefill rounding depends on its co-admitted traffic; the per-slot
        path keeps streams identical to a solo run). prefix_cache: dense
        prompt reuse by lane copy (copied rows carry the source's chunking).
        The server turns both on. paged_pages > 0: the cache is a pool of
        that many pages of page_size slots (page_size must divide the
        window); the pool shares prompt pages natively, so the dense
        registry stays off."""
        later = [name for name, on in (
            ("a device mesh", mesh is not None),
            ("scheduler speculation (spec_*)",
             any(a is not None for a in (spec_draft, spec_medusa, spec_tree)) or spec_lookup),
        ) if on]
        if later:
            raise NotImplementedError(f"{', '.join(later)}: not in this slice of the PyTorch "
                                      "port (see ROADMAP.md, Queue 1)")
        self.device = resolve_device(device)
        why = fast_unsupported(cfg)
        if why:
            raise ValueError(f"this model's shapes do not fit the port's kernels: {why}")
        if kv_dtype == torch.float16:
            kv_dtype = torch.bfloat16   # the fast path's cache is bf16 or e5m2
        if kv_dtype not in (torch.bfloat16, torch.float8_e5m2):
            raise NotImplementedError(
                f"KV cache {kv_dtype}: the port's caches are bf16 and float8_e5m2")
        if weights.wqkv.device.type != self.device.type:
            raise ValueError(f"weights on {weights.wqkv.device}, scheduler on {self.device}")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.paged = paged_pages > 0
        self.page_size = page_size
        if self.paged and (page_size < 1 or cfg.max_seq_len % page_size):
            raise ValueError(f"page_size {page_size} must divide the window {cfg.max_seq_len}")
        self.cfg = cfg
        self.weights = weights
        self.B = batch
        self.kv_dtype = kv_dtype
        self.topn = int(top_logprobs)
        self.n_pages = paged_pages
        self._new_cache()
        self.slots = [_Slot() for _ in range(batch)]
        self.queue: list[Request] = []
        self._admit_seq = 0
        self.preemptions = self.resumes = 0  # paged preemptions and resumes (stats)
        self.batched_admission = bool(batched_admission)
        self.admit_sweeps = 0  # batched-admission weight sweeps (stats)
        self.dense_prefix = (_DensePrefixRegistry() if prefix_cache and not self.paged
                             else None)

    def _new_cache(self) -> None:
        """A zeroed cache (a pool and its allocator when paged)."""
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

    def _bias_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(B, _NBIAS) logit-bias ids/values of the decoding lanes for the
        tick; other lanes get empty rows."""
        ids = np.full((self.B, _NBIAS), -1, np.int64)
        vals = np.zeros((self.B, _NBIAS), np.float32)
        for b, s in enumerate(self.slots):
            if s.decoding and s.request.logit_bias:
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
        if self._emit_checked(slot, first, lp, top):
            self._maybe_finish(slot, first)

    def _finish_resume(self, slot: _Slot) -> None:
        """End a preemption-resume re-hydration: the stream's tokens were all
        emitted before the preemption, so nothing is emitted here; the lane
        rejoins the batched decode at its old position (admit_tokens is
        prompt + generated[:-1], last_token generated[-1])."""
        slot.admitting = False
        slot.resuming = False
        slot.request._resume = None
        self.resumes += 1
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
                    out, _ = prefill_fast_paged(
                        self.cfg, self.weights, padded, slot.pos, take, self.cache,
                        self.alloc.tables[b], int(self.alloc.tables[b, slot.pos // ps]),
                        slot.pos % ps, logits_mode=mode, page_size=ps, attend_len=attend)
                else:
                    out, _ = prefill_fast(self.cfg, self.weights, padded, slot.pos, take,
                                          self.cache.lane(b), logits_mode=mode,
                                          attend_len=attend)
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
                    out, _ = decode_step_fast(self.cfg, self.weights, toks[slot.admit_i],
                                              slot.pos, self.cache.lane(b),
                                              output_logits=last and not slot.resuming)
                slot.pos += 1
                slot.admit_i += 1
                budget -= 1
                if last:
                    self._finish_chunk(slot, out)

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
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._new_cache()

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
            # lands in (a lane in the ring regime is fully mapped already)
            for b, slot in enumerate(self.slots):
                if slot.decoding and slot.pos < window:
                    self._ensure_pages(b, slot.pos + 1)
        decoding = [s.decoding for s in self.slots]
        if any(decoding):
            rows = [self._sampling_row(s.request, s.pos) if s.decoding else (0, s.pos, 0.0, 0, 1.0)
                    for s in self.slots]
            args = (self.cfg, self.weights, [s.last_token for s in self.slots],
                    [s.pos for s in self.slots], self.cache)
            write = [int(d) for d in decoding]
            if self.paged:
                logits, _ = decode_step_fast_batched_paged(
                    *args, self.alloc.table_array(), write, page_size=self.page_size)
            else:
                logits, _ = decode_step_fast_batched(*args, write)
            packed = self._pack(logits, rows, self._bias_arrays())
            nxt, lps, tops = _unpack_sample(packed, self.topn)
            for b, slot in enumerate(self.slots):
                if not slot.decoding:
                    continue
                tok = int(nxt[b])
                slot.pos += 1
                slot.last_token = tok
                if self._emit_checked(slot, tok, float(lps[b]), tops[b] if tops else None):
                    self._maybe_finish(slot, tok)
        return sum(not s.free for s in self.slots)

    def run(self, max_ticks: int = 100000) -> None:
        """Drive until every queued and active request completes."""
        for _ in range(max_ticks):
            if not self.queue and self.n_active == 0:
                return
            self.step()
        raise RuntimeError("scheduler did not converge within max_ticks")
