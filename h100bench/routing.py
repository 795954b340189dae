"""The experts the program routed each prompt and decoded token to, in an
MoE cell: an output of the timed path, kept for the check.

A router that rounds its input to bf16, as the configuration states,
chooses other experts than a float32 router wherever two experts' logits
lie within that rounding of each other; with random weights that happens
at a share of every stream's positions, and each such position changes the
rest of the stream. The reference therefore follows the program's routing
and judges it: the share of (position, layer) pairs given other experts
than its own float32 top k is `route_differ_share` (how far below its k-th
best they lie, at worst, `route_margin_max`, is printed by `calibrate.py`),
and with the program's experts it computes the logits whose gap to the
served tokens is `gap_max`.

While installed, every forward of the scheduler's chunk paths and tick
(`prefill_chunk_fast_batched`, `prefill_fast`, `decode_step_fast_batched`,
as the scheduler calls them) notes which request and positions its rows
hold, and every call of the top-k gate (`moe_gate`) inside it keeps its
expert ids on the card; nothing is read back until the window has closed.
"""

from __future__ import annotations

import torch


class RouteLog:
    def __init__(self, sched):
        self.sched = sched
        # per forward: [(request, row0, pos0, n)] and the expert ids of each layer
        self.forwards: list[tuple[list, list]] = []
        self._cur: list | None = None
        self._saved: list = []

    def _lane_of(self, lane_cache) -> int:
        k = self.sched.cache.k
        return (lane_cache.k.data_ptr() - k.data_ptr()) // (k.stride(0) * k.element_size())

    def _run(self, segments, orig, *a, **kw):
        layers: list = []
        self._cur = layers
        try:
            return orig(*a, **kw)
        finally:
            self._cur = None
            self.forwards.append((segments, layers))

    def install(self) -> None:
        from yalm_tpu_torch import scheduler as S
        from yalm_tpu_torch.models import fast as F
        log, slots = self, self.sched.slots

        def sweep(orig):
            def run(cfg, fw, tokens, pos0, valid_len, enable, *a, **k):
                T = len(tokens[0])
                seg = [(slots[b].request, b * T, int(pos0[b]), int(valid_len[b]))
                       for b in range(len(tokens)) if enable[b]]
                return log._run(seg, orig, cfg, fw, tokens, pos0, valid_len, enable, *a, **k)
            return run

        def chunk(orig):
            def run(cfg, fw, tokens, pos0, valid_len, cache, *a, **k):
                seg = [(slots[log._lane_of(cache)].request, 0, int(pos0), int(valid_len))]
                return log._run(seg, orig, cfg, fw, tokens, pos0, valid_len, cache, *a, **k)
            return run

        def tick(orig):
            def run(cfg, fw, tokens, positions, cache, write=None, *a, **k):
                seg = [(slots[b].request, b, int(p), 1) for b, p in enumerate(positions)
                       if write is None or write[b]]
                return log._run(seg, orig, cfg, fw, tokens, positions, cache, write, *a, **k)
            return run

        def gate(orig):
            def run(router, n_active):
                gates, idx = orig(router, n_active)
                if log._cur is not None:
                    log._cur.append(idx)
                return gates, idx
            return run

        for owner, name, make in ((S, "prefill_chunk_fast_batched", sweep),
                                  (S, "prefill_fast", chunk),
                                  (S, "decode_step_fast_batched", tick), (F, "moe_gate", gate)):
            orig = getattr(owner, name)
            self._saved.append((owner, name, orig))
            setattr(owner, name, make(orig))

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()

    def routes(self, request, length: int, n_layers: int, k: int) -> torch.Tensor:
        """(length, n_layers, k) expert ids the program chose for the
        request's positions 0..length-1 (-1 where no forward of this request
        computed the position, as the BOS row a prefix copy brought)."""
        out = torch.full((length, n_layers, k), -1, dtype=torch.long)
        for segments, layers in self.forwards:
            for req, row0, pos0, n in segments:
                if req is not request or pos0 >= length or len(layers) != n_layers:
                    continue
                m = min(n, length - pos0)
                out[pos0:pos0 + m] = torch.stack(
                    [idx[row0:row0 + m].cpu() for idx in layers], dim=1)
        return out
