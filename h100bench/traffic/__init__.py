"""Traffic: a mix is a data file `traffic/<mix>.json`; its `kind` names the
generator module `traffic/<kind>.py`, found by name, whose
`drive(mix, seed, server, seconds)` offers the load to the server and opens
and closes the measured window.

The helpers here turn a mix's parameters into requests. Lengths are drawn
stratified: a block of n requests takes the n quantiles (i + 0.5) / n of the
stated distribution, in a base order that is the same for every seed, and
the seed reorders them within runs of `reorder_span` consecutive requests
(`order`). Every seed then offers the same sizes in nearly the same order,
so the work of a window hardly changes with its seed, while the seed still
moves every request among its neighbours and draws the token ids, the
greedy/sampled split, the sampling seeds and the weights.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from statistics import NormalDist

import numpy as np

_UNIT = NormalDist()


@dataclasses.dataclass
class Spec:
    """One request as the generator draws it."""

    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def quantile(dist: dict, u: float) -> int:
    """The length at quantile u of a length distribution:
    {"dist": "lognormal", "median", "sigma", "min", "max"} or
    {"dist": "uniform", "min", "max"} (whole numbers, both ends included)."""
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "lognormal":
        v = float(dist["median"]) * math.exp(float(dist["sigma"]) * _UNIT.inv_cdf(u))
        return min(hi, max(lo, int(round(v))))
    if dist["dist"] == "uniform":
        return min(hi, lo + int(u * (hi - lo + 1)))
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def stratified(n: int) -> np.ndarray:
    """The n midpoint quantiles (i + 0.5) / n."""
    return (np.arange(n) + 0.5) / n


def order(n: int, block: int, seed: int, span: int, salt: int) -> np.ndarray:
    """A permutation of range(n): the base order of (block, salt), the same
    for every seed, with each run of `span` consecutive places shuffled by
    the seed."""
    base = np.random.default_rng([salt, block]).permutation(n)
    rng = np.random.default_rng([seed, salt, block])
    idx = np.arange(n)
    for g in range(0, n, span):
        idx[g:g + span] = g + rng.permutation(len(idx[g:g + span]))
    return base[idx]


def block_specs(mix: dict, seed: int, block: int, n: int, vocab: int, bos: int) -> list[Spec]:
    """Block number `block` of a mix: n requests whose prompt lengths and
    output lengths are each a stratified set of n (`order`), and whose
    greedy/sampled split is drawn from the seed. Prompts are BOS, then
    random ids in [3, vocab): no two share more than BOS."""
    span = int(mix["reorder_span"])
    rng = np.random.default_rng([seed, 11, block])
    u = stratified(n)
    plens = [quantile(mix["prompt_tokens"], x) for x in u[order(n, block, seed, span, 1)]]
    outs = [quantile(mix["output_tokens"], x) for x in u[order(n, block, seed, span, 2)]]
    n_greedy = int(round(float(mix.get("greedy_share", 0.5)) * n))
    greedy = np.zeros(n, bool)
    greedy[rng.permutation(n)[:n_greedy]] = True
    samp = mix.get("sampled", {})
    out = []
    for i in range(n):
        ids = rng.integers(3, vocab, plens[i] - 1).tolist()
        s = Spec(prompt=[bos] + ids, max_new_tokens=int(outs[i]),
                 seed=int(rng.integers(0, 2**31 - 1)))
        if not greedy[i]:
            s.temperature = float(samp.get("temperature", 1.0))
            s.top_p = float(samp.get("top_p", 1.0))
            s.top_k = int(samp.get("top_k", 0))
        out.append(s)
    return out


def generator(kind: str):
    """The generator module of a loop kind, found by name."""
    return importlib.import_module(f"h100bench.traffic.{kind}")
