"""Closed loop: `clients` clients, each with one request in flight and no
think time; a client sends its next request as soon as its last one has
delivered its last token. Client c's j-th request is entry c of block j
(`block_specs`), so what each client sends does not depend on timing.

The first requests start together, so their ends would come together too
and the window would open on a stretch of decoding with no admission. The
first block's outputs are therefore cut to what is left of a request met
at a random point of its life: client c's first request keeps the share
(i + 0.5) / n of its drawn output, i taken in an order of (block 0, seed),
at least one token. Their ends then spread over one request's length, as
in the steady state. The window opens once every client's first request
has its first token, i.e. every lane has admitted a request, and lasts
`seconds`.
"""

from __future__ import annotations

import math

from . import block_specs, order, stratified

RAMP_LIMIT_S = 300.0   # a ramp that takes longer than this is a fault


def staggered(specs: list, seed: int, span: int) -> list:
    """The first block with its outputs cut to stratified shares."""
    n = len(specs)
    share = stratified(n)[order(n, 0, seed, span, 3)]
    for s, f in zip(specs, share):
        s.max_new_tokens = max(1, math.ceil(s.max_new_tokens * float(f)))
    return specs


def drive(mix: dict, seed: int, server, seconds: float) -> None:
    n = int(mix["clients"])
    blocks: dict[int, list] = {}
    sent = [0] * n

    def send(c: int):
        j = sent[c]
        if j not in blocks:
            blocks[j] = block_specs(mix, seed, j, n, server.vocab, server.bos)
            if j == 0:
                staggered(blocks[0], seed, int(mix["reorder_span"]))
        sent[c] += 1
        return server.submit(blocks[j][c], server.now(), client=c)

    first = [send(c) for c in range(n)]
    if not server.wait_until(lambda: all(r.first is not None or r.failed for r in first),
                             RAMP_LIMIT_S):
        raise RuntimeError(f"closed loop: the {n} first requests were not all admitted "
                           f"within {RAMP_LIMIT_S} s")
    w0 = server.now()
    server.open_window(w0)
    w1 = w0 + seconds
    while True:
        left = w1 - server.now()
        if left <= 0:
            break
        rec = server.next_finished(left)
        if rec is not None:
            send(rec.client)
    server.close_window(w1)
