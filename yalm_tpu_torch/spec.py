"""Draft sources for speculative decoding (the port's own copy of
`yalm_tpu/spec.py`, numpy only).

Prompt-lookup (n-gram) drafting proposes the continuation of the most
recent earlier occurrence of the context's trailing n-gram: no draft model,
no draft cache, no device work. The target verifies the proposals with the
same chunked forward as model-drafted speculation
(`Engine.generate_speculative`, `Scheduler._spec_round`). On novel text it
degrades to plain decoding (no match, no proposal, a plain step).

`pointmass_rejection_verify` is rejection sampling against a draft that
proposes one token with certainty (prompt lookup, Medusa argmax heads):
the emitted stream is distributed as target-only sampling. With the same
`np.random.default_rng` seed it draws exactly what the JAX package's does.
"""

from __future__ import annotations

import numpy as np


def ngram_propose(context: list[int], k: int, *, max_ngram: int = 3,
                  min_ngram: int = 1) -> list[int]:
    """Propose up to k tokens continuing `context` by prompt lookup.

    Scans n-gram sizes from max_ngram down to min_ngram; for the first size
    whose trailing n-gram has an earlier occurrence, returns the tokens that
    followed its MOST RECENT earlier occurrence (up to k, truncated at the
    match itself so proposals never include the trailing n-gram's own
    continuation loop). Returns [] when nothing matches.
    """
    n = len(context)
    if n < min_ngram + 1 or k <= 0:
        return []
    for size in range(min(max_ngram, n - 1), min_ngram - 1, -1):
        tail = context[n - size:]
        # most recent earlier occurrence: scan right-to-left, excluding the
        # trailing n-gram itself
        for start in range(n - size - 1, -1, -1):
            if context[start:start + size] == tail:
                cont = context[start + size: start + size + k]
                if cont:
                    return list(cont)
    return []


class NgramHistory:
    """Incremental prompt-lookup index: for each n-gram (as a tuple) keep
    its latest AND second-latest start offsets, so proposing is O(max_ngram)
    per call instead of an O(n) scan. Used by the scheduler, where every
    lane re-proposes every round over a growing history."""

    def __init__(self, tokens: list[int], *, max_ngram: int = 3,
                 min_ngram: int = 1):
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.tokens: list[int] = []
        self.latest: dict[tuple[int, ...], int] = {}
        self.prev: dict[tuple[int, ...], int] = {}
        self.extend(tokens)

    def extend(self, tokens: list[int]) -> None:
        for t in tokens:
            self.tokens.append(int(t))
            n = len(self.tokens)
            for size in range(self.min_ngram, self.max_ngram + 1):
                if n >= size:
                    g = tuple(self.tokens[n - size:])
                    old = self.latest.get(g)
                    if old is not None:
                        self.prev[g] = old
                    self.latest[g] = n - size

    def propose(self, k: int) -> list[int]:
        n = len(self.tokens)
        for size in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            tail = tuple(self.tokens[n - size:])
            # latest[tail] is the tail itself; the most recent EARLIER
            # occurrence lives in prev
            start = self.prev.get(tail)
            if start is None:
                continue
            cont = self.tokens[start + size: start + size + k]
            if cont:
                return list(cont)
        return []


def pointmass_rejection_verify(rng, T: float, t_lg: np.ndarray,
                               d: list[int]):
    """Rejection-sampling verification against a POINT-MASS draft (prompt
    lookup proposes deterministically, q_i = delta at d[i]).

    Accept d[i] w.p. p_i(d[i]); on rejection sample from the residual
    p_i with d[i] removed, renormalized; after full acceptance sample the
    bonus token from p_K. Exactly the Leviathan et al. construction with
    q = delta: the emitted stream is distributed identically to target-only
    temperature sampling. Returns (emitted, accepted)."""
    K = len(d)
    emitted: list[int] = []
    a = 0
    for i in range(K):
        z = t_lg[i].astype(np.float64) / max(T, 1e-8)
        z -= z.max()
        e = np.exp(z)
        p = e / e.sum()
        x = int(d[i])
        if rng.random() < p[x]:
            emitted.append(x)
            a += 1
            continue
        res = p.copy()
        res[x] = 0.0
        zr = res.sum()
        tok = int(rng.choice(len(res), p=res / zr)) if zr > 0 else x
        emitted.append(tok)
        break
    else:
        z = t_lg[K].astype(np.float64) / max(T, 1e-8)
        z -= z.max()
        e = np.exp(z)
        pK = e / e.sum()
        emitted.append(int(rng.choice(len(pK), p=pK)))
    return emitted, a
