"""A run with the timed path broken underneath must come out not correct,
and the lower-precision control must read above the limit that sound runs
stay under. The tiny configuration runs the port's plain versions on the
CPU; the run is the harness's own (`harness.execute`) past its look for a
card. The `cuda` test repeats the control at a cell's own size on the card.
"""

import time

import pytest
import torch

from h100bench import harness

from .conftest import TINY_ROUTE_LIMIT, tiny_files

TINY_LIMIT = 0.01    # sound tiny runs read 0 to 1.2e-3, the fp8 control 0.02 to 0.04


def _run(f, seed=2**31 + 11, control=False):
    return harness.execute("mistral7b-fp8.sharegpt", seed, 4.0, False, time.perf_counter(),
                           device="cpu", given=f, control=control, log=lambda m: None)


@pytest.mark.parametrize("moe", [False, True])
def test_a_sound_run_is_correct(moe):
    res = _run(tiny_files(moe=moe, gap_max=TINY_LIMIT))
    assert res["correct"], res["checks"]


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from yalm_tpu_torch import scheduler as S
    orig = S._unpack_sample

    def altered(packed, topn=0):
        nxt, lps, tops = orig(packed, topn)
        return (nxt + 1) % 512, lps, tops
    monkeypatch.setattr(S, "_unpack_sample", altered)
    res = _run(tiny_files(gap_max=TINY_LIMIT))
    assert not res["correct"]
    assert res["checks"]["gap_max"]["value"] > TINY_LIMIT


def test_a_tick_that_leaves_the_cache_unchanged(monkeypatch):
    from yalm_tpu_torch.models import fast as F
    orig = F.attend_step_batched

    def unwritten(q, k, v, k_all, v_all, *a, **kw):
        return orig(q, k, v, k_all.clone(), v_all.clone(), *a, **kw)
    monkeypatch.setattr(F, "attend_step_batched", unwritten)
    res = _run(tiny_files(gap_max=TINY_LIMIT))
    assert not res["correct"]


def test_the_control_fails_through_the_harness_checks():
    res = _run(tiny_files(gap_max=TINY_LIMIT), control=True)
    assert res["correct"], res["checks"]
    assert not res["extra"]["control_correct"], res["extra"]["control_checks"]


@pytest.mark.parametrize("seed", [5, 2**31 + 29, 3_000_000_041])
def test_the_control_reads_above_the_limit(seed):
    # 4 prompts, each followed by 50 tokens of the float32 reference's own
    # greedy stream: the sample a sound program at this size would serve
    from h100bench.reference.judge import control_gaps, served_gaps
    from h100bench.reference.model import Reference
    from h100bench.weights import synth
    cfg = tiny_files()["cfg"]
    w = synth(cfg, "cpu", seed)
    ref = Reference(cfg, w)
    g = torch.Generator().manual_seed(seed)
    sample = []
    for n in (20, 45, 70, 95):
        seq = [1] + torch.randint(3, cfg["vocab_size"], (n,), generator=g).tolist()
        for _ in range(50):
            seq.append(int(ref.logits([seq], [[len(seq) - 1]])[0][0].argmax()))
        sample.append((seq[:n + 1], seq[n + 1:]))
    assert max(served_gaps(cfg, w, sample)[0]) <= TINY_LIMIT
    assert max(control_gaps(cfg, w, sample)[0]) > TINY_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mistral7b-fp8.sharegpt"])
def test_the_control_fails_a_cell_on_the_card(cuda_card, workload):
    f = harness.files(workload)
    res = harness.execute(workload, 2**31 + 101, float(f["bench"]["run_seconds"]), False,
                          time.perf_counter(), given=f, control=True, log=lambda m: None)
    assert res["correct"], res["checks"]
    # the control's gaps, judged by the harness's own checks in the program's place
    assert not res["extra"]["control_correct"], res["extra"]["control_checks"]
    torch.cuda.empty_cache()


def test_experts_altered_where_they_are_chosen(monkeypatch):
    from yalm_tpu_torch.models import fast as F
    orig = F.moe_gate

    def worst(router, k):
        gates, _ = orig(router, k)
        return gates, torch.topk(-router, k, dim=-1).indices
    monkeypatch.setattr(F, "moe_gate", worst)
    res = _run(tiny_files(moe=True, gap_max=TINY_LIMIT))
    assert not res["correct"]
    assert res["checks"]["route_differ_share"]["value"] > TINY_ROUTE_LIMIT
