"""How `correct` is decided for a served model: once the window has closed,
a sample of the greedy requests the window finished, drawn from the seed
(`choose`: the longest whole, and a prefix of one request of each of many
other clients), is run through the reference once, each prompt followed by
the tokens the server produced. The number compared is
`gap_max`: the widest gap by which a served token's reference logit lies
below the reference's best logit at that position. A greedy token is the
program's argmax, so a sound program serves tokens whose gap is rounding
at most; a token altered where it is produced reads the full spread of the
logits.

In an MoE cell the reference follows the experts the program chose
(`h100bench/routing.py`) and judges that choice by itself: the share of
(position, layer) pairs routed to other experts than its own top k
(`route_differ_share`), and how far a chosen expert's float32 router logit
lies below its own k-th best, at worst (`route_margin_max`).

The control (`control_gaps`) is the reference itself put in the program's
place and computed in the next precision below the configuration's bf16:
float8-e4m3 operands, routing by itself. At each position of the same
prompts and tokens it reads, as for the program, the gap of the token the
fp8 reference puts first and how far its experts lie below the float32
reference's. It is run by `h100bench/calibrate.py` and the tests, never by
a benchmark run; its gaps go through the same `checks` and `correct` as
the program's, in the program's place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import Reference

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to float8-e4m3 and back (the control)."""
    return t.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.float32)


def choose(served: list[tuple[int, int]], seed: int, tokens: int, requests: int,
           prefix: int) -> list[tuple[int, int]]:
    """The sample, as (index, served tokens taken) pairs. `served` holds
    (client, served tokens) of each finished greedy request. First the
    request with the most served tokens, whole; then, in an order drawn from
    the seed, one request of each other client, its first `prefix` served
    tokens at most, until the sample holds at least `requests` requests and
    `tokens` served tokens, or a request of every client."""
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: (served[i][1], -i))
    out, n, clients = [(longest, served[longest][1])], served[longest][1], {served[longest][0]}
    for i in np.random.default_rng([seed, 21]).permutation(len(served)).tolist():
        if len(out) >= requests and n >= tokens:
            break
        client, m = served[i]
        if client not in clients:
            clients.add(client)
            out.append((i, min(prefix, m)))
            n += out[-1][1]
    return out


def checks(gaps: list[float], readings: dict, tokens: int, failed: int, limit: dict,
           moe: bool) -> dict:
    """Each number compared for `correct`, beside its limit (the cell's
    `check`): the widest gap, in an MoE cell the share of routes that differ,
    the served tokens checked (at least), and the failed requests."""
    out = {"gap_max": {"value": max(gaps) if gaps else math.inf, "limit": limit["gap_max"]}}
    if moe:
        out["route_differ_share"] = {"value": readings.get("route_differ_share", math.inf),
                                     "limit": limit["route_differ_share"]}
    out["tokens_checked"] = {"value": tokens, "limit": limit["tokens_min"]}
    out["failed_requests"] = {"value": failed, "limit": 0}
    return out


def correct(checked: dict) -> bool:
    """Every number within its limit: `tokens_checked` at least its limit,
    every other at most its own."""
    return all(c["value"] >= c["limit"] if name == "tokens_checked" else c["value"] <= c["limit"]
               for name, c in checked.items())


def _inputs(sample):
    seqs = [list(p) + list(s[:-1]) for p, s in sample]
    rows = [list(range(len(p) - 1, len(p) - 1 + len(s))) for p, s in sample]
    return seqs, rows


def _gaps(ref_logits, picks) -> list[float]:
    out = []
    for lg, pick in zip(ref_logits, picks):
        pick = torch.as_tensor(pick, dtype=torch.long, device=lg.device)
        out += (lg.max(dim=-1).values - lg.gather(1, pick[:, None])[:, 0]).tolist()
    return out


def served_gaps(cfg: dict, weights: dict, sample, routes=None) -> tuple[list[float], dict]:
    """The gap of every served token of `sample` ((prompt, served tokens)
    pairs) against the float32 reference, and (MoE, given the program's
    routes) the reference's readings of them (`Reference.route_readings`)."""
    seqs, rows = _inputs(sample)
    ref = Reference(cfg, weights)
    lg = ref.logits(seqs, rows, routes)
    return _gaps(lg, [s for _, s in sample]), ref.route_readings if ref.experts else {}


def control_gaps(cfg: dict, weights: dict, sample) -> tuple[list[float], dict]:
    """The control, the reference in the program's place at fp8: at the
    same positions, the gap of the token it ranks first, and (MoE) the
    routing readings of the experts it routes to, judged as the program's
    are, by the float32 reference on the control's routes."""
    seqs, rows = _inputs(sample)
    low = Reference(cfg, weights, act=fp8)
    picks = [x.argmax(dim=-1) for x in low.logits(seqs, rows)]
    ref = Reference(cfg, weights)
    lg = ref.logits(seqs, rows, low.chosen if ref.experts else None)
    return _gaps(lg, picks), ref.route_readings if ref.experts else {}
