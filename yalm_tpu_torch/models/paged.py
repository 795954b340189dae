"""Paged KV cache: block-granular slot sharing for the batching scheduler
(port of `yalm_tpu/models/paged.py`; on a mesh, one allocator per dp
group: GroupedPageAllocator).

The dense batched cache gives every lane a full (n_layers, window, Hk, D)
allocation whether it holds 10 tokens or 4096: at batch 16 and a 4k window
that is more memory than the 7B weights themselves. Here the cache is a
POOL of pages, each holding ALL layers' k/v for one `page_size`-token block
of one lane:

    pool.k, pool.v : (n_pages, n_layers, page_size, Hk, D)

and a per-lane page table maps block index -> page id. Lanes allocate pages
lazily as their position crosses block boundaries and return them when the
request completes, so the cache's memory scales with TOKENS IN FLIGHT, not
lanes x window. A lane's logical slot s lives at (table[s // page_size],
s % page_size); the paged attention step (`ops/cuda/attention.py`
`attend_step_paged_l`) resolves every row it reads or writes through the
table. The pool is updated IN PLACE, like the dense cache.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codec.format import numpy_to_torch, tag_for_numpy
from ..config import ModelConfig


@dataclass
class PagedKVPool:
    k: torch.Tensor   # (n_pages, n_layers, page_size, n_kv_heads, head_dim)
    v: torch.Tensor   # same

    @classmethod
    def init(cls, cfg: ModelConfig, dtype: torch.dtype, n_pages: int, page_size: int = 256,
             device: torch.device | str = "cuda") -> "PagedKVPool":
        shape = (n_pages, cfg.n_layers, page_size, cfg.n_kv_heads, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @classmethod
    def from_numpy(cls, k: np.ndarray, v: np.ndarray, device="cpu") -> "PagedKVPool":
        """The port's pool from the JAX package's PagedKVPool arrays as numpy
        (bf16/fp8 arrays of ml_dtypes' types are recognised by dtype name)."""
        def conv(a):
            return numpy_to_torch(a, tag_for_numpy(a)).to(device)
        return cls(k=conv(k), v=conv(v))

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


class PageAllocator:
    """Host-side free-list of pool pages + per-lane tables.

    Page 0 is reserved as the sink page: unmapped blocks point at it (never
    attended: kv_len masks them out); real allocations start at 1.
    """

    def __init__(self, cfg: ModelConfig, n_pages: int, batch: int,
                 page_size: int = 256):
        if cfg.max_seq_len % page_size:
            raise ValueError(f"page_size {page_size} must divide window "
                             f"{cfg.max_seq_len}")
        self.page_size = page_size
        self.blocks_per_lane = cfg.max_seq_len // page_size
        self.n_pages = n_pages
        self.free: list[int] = list(range(n_pages - 1, 0, -1))  # 0 reserved
        # 0 = unmapped; table[b, blk] = page id
        self.tables = np.zeros((batch, self.blocks_per_lane), np.int32)
        # ---- automatic prefix caching (vLLM-style) ----------------------
        # Full pages of COMPLETED prompt prefixes register under a chained
        # per-block content key; later identical prompts map the same pages
        # read-only (admission skips their prefill entirely). Pages whose
        # lane references drop to zero stay cached and are evicted LRU only
        # under free-list pressure. shared[b, blk] marks blocks a lane must
        # UNREF (not free) on release.
        self.shared = np.zeros((batch, self.blocks_per_lane), bool)
        self.cached: dict[tuple, int] = {}     # chained key -> page id
        self.page_key: dict[int, tuple] = {}
        self.ref: dict[int, int] = {}          # page -> lane references
        self.lru: dict[int, int] = {}          # ref-0 cached page -> clock
        self._clock = 0
        self.prefix_stats = {"hits": 0, "hit_tokens": 0, "registered": 0,
                             "evicted": 0}

    @property
    def n_free(self) -> int:
        """Pages obtainable for new mappings (free list + evictable
        ref-0 cached pages)."""
        return len(self.free) + len(self.lru)

    def pages_for(self, kv_len: int) -> int:
        return -(-max(kv_len, 0) // self.page_size)

    def can_grow(self, lane: int, target_len: int) -> bool:
        have = self._mapped(lane)
        return (self.pages_for(target_len) - have
                <= len(self.free) + len(self.lru))

    def _mapped(self, lane: int) -> int:
        return int((self.tables[lane] != 0).sum())

    def mapped_through(self, lane: int, target_len: int) -> bool:
        """Whether the lane's table covers positions [0, target_len)
        (grow maps blocks contiguously from 0)."""
        return self._mapped(lane) >= self.pages_for(target_len)

    def grow(self, lane: int, target_len: int) -> None:
        """Map pages so the lane can hold target_len tokens. Raises if the
        pool is exhausted -- callers must check can_grow first. Unreferenced
        prefix-cached pages are evicted (LRU) before giving up."""
        need = self.pages_for(target_len)
        have = self._mapped(lane)
        for blk in range(have, need):
            if not self.free and self.lru:
                self._evict_one()
            if not self.free:
                raise RuntimeError("page pool exhausted")
            self.tables[lane, blk] = self.free.pop()

    def _evict_one(self) -> None:
        page = min(self.lru, key=self.lru.get)
        del self.lru[page]
        key = self.page_key.pop(page)
        del self.cached[key]
        self.ref.pop(page, None)
        self.free.append(page)
        self.prefix_stats["evicted"] += 1

    def match_prefix(self, lane: int, tokens) -> int:
        """Map the longest cached full-page prefix of `tokens` into the
        lane's table (read-only shared pages) and return the matched token
        count. Always leaves >= 1 token for prefill (the finishing chunk
        must produce first-token logits)."""
        ps = self.page_size
        key: tuple = ()
        matched = 0
        for blk in range(self.blocks_per_lane):
            if (blk + 1) * ps >= len(tokens):  # strict: keep >= 1 token
                break
            key = (key, tuple(int(t) for t in tokens[blk * ps:(blk + 1) * ps]))
            page = self.cached.get(key)
            if page is None:
                break
            self.tables[lane, blk] = page
            self.shared[lane, blk] = True
            if self.ref.get(page, 0) == 0:
                self.lru.pop(page, None)
            self.ref[page] = self.ref.get(page, 0) + 1
            matched += ps
        if matched:
            self.prefix_stats["hits"] += 1
            self.prefix_stats["hit_tokens"] += matched
        return matched

    def register_prefix(self, lane: int, tokens) -> None:
        """Publish the lane's full-page prompt prefix into the cache (the
        pages are fully written once admission completes; the caller gates
        out lanes that could enter the ring regime and rewrite them)."""
        ps = self.page_size
        key: tuple = ()
        for blk in range(min(len(tokens) // ps, self.blocks_per_lane)):
            key = (key, tuple(int(t) for t in tokens[blk * ps:(blk + 1) * ps]))
            page = int(self.tables[lane, blk])
            if page == 0:
                break
            if self.shared[lane, blk]:
                continue    # already a cached page (matched at admission)
            if key in self.cached:
                continue    # registered concurrently: keep this copy private
            self.cached[key] = page
            self.page_key[page] = key
            self.ref[page] = self.ref.get(page, 0) + 1
            self.shared[lane, blk] = True
            self.prefix_stats["registered"] += 1

    def release(self, lane: int) -> None:
        for blk in range(self.blocks_per_lane):
            pid = int(self.tables[lane, blk])
            if pid != 0:
                if self.shared[lane, blk]:
                    # cached page: drop the lane's reference; the page stays
                    # in the prefix cache until evicted under pressure
                    self.ref[pid] -= 1
                    if self.ref[pid] == 0:
                        self._clock += 1
                        self.lru[pid] = self._clock
                else:
                    self.free.append(pid)
                self.tables[lane, blk] = 0
                self.shared[lane, blk] = False

    def table_array(self) -> np.ndarray:
        """(batch, blocks_per_lane) int32 -- unmapped blocks point at the
        reserved page 0 (never attended: kv_len masks them out)."""
        return self.tables.copy()

    @property
    def lane_capacity(self) -> int:
        """Max pages one lane can ever hold (pool minus the reserved 0)."""
        return self.n_pages - 1

    def same_pool(self, a: int, b: int) -> bool:
        """Whether preempting lane b frees pages lane a can use (always, on
        one device; on a mesh see GroupedPageAllocator)."""
        return True


class GroupedPageAllocator:
    """Per-dp-group allocators for the mesh's paged scheduler (paged.py:
    206-282): the pool's page axis splits over dp, so each group of
    batch/dp lanes allocates GROUP-LOCAL page ids out of its own pool shard
    (parallel/fast_tp.py's paged factories), page 0 of each shard its sink.
    Same interface as PageAllocator; lanes are global indices, routed to
    (group, local lane)."""

    def __init__(self, cfg: ModelConfig, n_pages: int, batch: int,
                 page_size: int = 256, groups: int = 1):
        if n_pages % groups or batch % groups:
            raise ValueError(f"pages {n_pages} and batch {batch} must "
                             f"divide over {groups} dp groups")
        self.page_size = page_size
        self.n_pages = n_pages
        self.groups = [PageAllocator(cfg, n_pages // groups, batch // groups,
                                     page_size) for _ in range(groups)]
        self.lanes_per_group = batch // groups
        self.blocks_per_lane = self.groups[0].blocks_per_lane

    def _route(self, lane: int):
        return (self.groups[lane // self.lanes_per_group],
                lane % self.lanes_per_group)

    @property
    def n_free(self) -> int:
        return sum(g.n_free for g in self.groups)

    @property
    def lane_capacity(self) -> int:
        return self.groups[0].n_pages - 1

    @property
    def tables(self) -> np.ndarray:
        return np.concatenate([g.tables for g in self.groups])

    def pages_for(self, kv_len: int) -> int:
        return self.groups[0].pages_for(kv_len)

    def can_grow(self, lane: int, target_len: int) -> bool:
        g, ll = self._route(lane)
        return g.can_grow(ll, target_len)

    def grow(self, lane: int, target_len: int) -> None:
        g, ll = self._route(lane)
        g.grow(ll, target_len)

    def mapped_through(self, lane: int, target_len: int) -> bool:
        g, ll = self._route(lane)
        return g.mapped_through(ll, target_len)

    def release(self, lane: int) -> None:
        g, ll = self._route(lane)
        g.release(ll)

    def match_prefix(self, lane: int, tokens) -> int:
        g, ll = self._route(lane)
        return g.match_prefix(ll, tokens)

    def register_prefix(self, lane: int, tokens) -> None:
        g, ll = self._route(lane)
        g.register_prefix(ll, tokens)

    @property
    def prefix_stats(self):
        out = {"hits": 0, "hit_tokens": 0, "registered": 0, "evicted": 0}
        for g in self.groups:
            for k in out:
                out[k] += g.prefix_stats[k]
        return out

    def same_pool(self, a: int, b: int) -> bool:
        """Preemption only helps when the victim's pages come from the SAME
        group's pool shard."""
        return a // self.lanes_per_group == b // self.lanes_per_group

    def table_array(self) -> np.ndarray:
        return self.tables
