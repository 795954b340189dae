"""chip_smoke.py's routing rule for the tree serving run on MoE weights, on
the CPU at a tiny Mixtral-shaped config: a reference fed a run's routing
(gate_calls(force=...)) computes the run's own routing bit for bit, a
forced row moves the reference's logits from that row on while its own
router choice is still what gate_calls returns, and routing_check takes a
parting row only at a near-tie of the reference or where the f32 oracle
takes a side or lies at a near-tie, and only while the two paths lie as
near the oracle as each other."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs


@pytest.fixture(scope="module")
def moe():
    """A 2-layer, 8-expert (2 active) config at tiny widths, its random fp8
    weights, and 3 greedy lanes of 20-token prompts with 6-token streams."""
    cfg = dataclasses.replace(cs.mixtral8x7b(2), dim=128, hidden_dim=256, head_dim=32,
                              n_heads=4, n_kv_heads=2, vocab_size=512, max_seq_len=512,
                              rotary_dim=32)
    fw = cs.synth_fast_weights(cfg, torch.device("cpu"), seed=2)
    rng = np.random.default_rng(3)
    mix = [([cfg.bos_token_id] + rng.integers(3, cfg.vocab_size, 19).tolist(), False)
           for _ in range(3)]
    streams = [rng.integers(3, cfg.vocab_size, 6).tolist() for _ in mix]
    return cfg, fw, mix, streams


def _rows(moe, run=None):
    cfg, fw, mix, streams = moe
    return cs.chunk_rows(cfg, fw, torch.device("cpu"), torch.bfloat16, mix, streams, run)


def test_forcing_a_run_routing_its_own_changes_nothing(moe):
    rows, own = _rows(moe)
    forced, again = _rows(moe, own)
    assert torch.equal(rows, forced)
    assert own.keys() == again.keys()
    for g in own:
        for pos, (ex, lg) in own[g].items():
            assert np.array_equal(ex, again[g][pos][0]) and np.array_equal(lg, again[g][pos][1])


def test_a_forced_row_moves_the_stream_from_its_position_on(moe):
    _, _, mix, _ = moe
    rows, own = _rows(moe)
    g, pos = 1, len(mix[1][0]) + 1             # the row that predicts stream token 2
    ex, lg = own[g][pos]
    other = np.argsort(-lg[0])[2:4]            # layer 0's 3rd and 4th experts
    run = {b: dict(d) for b, d in own.items()}
    run[g][pos] = (np.stack([np.sort(other), ex[1]]), lg)
    forced, got = _rows(moe, run)
    j = pos - (len(mix[g][0]) - 1)
    assert torch.equal(forced[:j], rows[:j]) and torch.equal(forced[:, [0, 2]], rows[:, [0, 2]])
    assert not torch.equal(forced[j, g], rows[j, g])
    assert np.array_equal(got[g][pos][0][0], ex[0])   # its own choice, not the forced one
    from yalm_tpu_torch.models import fast as M
    with cs.gate_calls(run) as took:                  # one gate call: layer 0 of that row
        took(False, [(g, pos)])
        gates, idx = M.moe_gate(torch.as_tensor(lg[0:1]), 2)
        assert np.array_equal(took()[0][0, 0], ex[0])
    assert idx[0].tolist() == other.tolist()          # ranked by the row's own logits
    assert torch.allclose(gates.sum(-1), torch.ones(1)) and bool((gates[0, 0] >= gates[0, 1]))


def _rec(experts, logits):
    return np.array(experts)[None], np.array(logits, np.float32)[None]


PARTED = [5.0, 3.62, 3.50, 3.45]   # experts (0, 1), 2.4 tolerances (of 0.05) clear


@pytest.mark.parametrize("ref_logits, oracle, outcome", [
    ([5.0, 3.53, 3.50, 3.40], None, "near"),                            # gap 0.6 tol
    (PARTED, None, "raises"),                                           # no oracle
    (PARTED, ((0, 2), [5.0, 3.55, 3.58, 3.40]), "run"),                 # the oracle as the run
    (PARTED, ((0, 1), [5.0, 3.58, 3.52, 3.40]), "reference"),           # ... as the reference
    (PARTED, ((0, 3), [5.0, 3.52, 3.53, 3.54]), "near-tie"),            # neither, at a tie
    (PARTED, ((0, 3), [5.0, 3.40, 3.42, 3.60]), "raises"),              # neither side
    ([5.0, 3.80, 3.50, 3.40], ((0, 2), [5.0, 3.50, 3.53, 3.40]), "raises"),  # reference far
])
def test_routing_check_rule(ref_logits, oracle, outcome):
    """One row of one layer, which the run routes to experts (0, 2) and
    the reference, past a near-tie, to (0, 1): taken where the reference
    lies at a near-tie, or the f32 oracle takes a side or lies at one
    itself; a row where the oracle takes neither side, or a reference whose
    router logits lie more than one tolerance farther from the oracle's
    than the run's, raises."""
    mix = [([1, 2, 3], False)]
    run = {0: {2: _rec((0, 2), [5.0, 3.50, 3.52, 3.40])}}
    ref = {0: {2: _rec((0, 1), ref_logits)}}
    orc = {0: {2: _rec(*oracle)}} if oracle else {}
    if outcome == "raises":
        with pytest.raises(AssertionError, match="takes neither side"):
            cs.routing_check("t", mix, run, ref, orc)
        return
    res = cs.routing_check("t", mix, run, ref, orc)
    assert res["rows"] == 1
    assert len(res["near_ties"]) == (outcome == "near")
    assert [r[-1] for r in res["past_a_near_tie"]] == ([] if outcome == "near" else [outcome])
