"""The port's single-stream speculative decoding on the CPU (plain versions)
against the JAX package: the numpy draft sources and acceptance rules
(`spec.py`, `rejection_sample_verify`) draw exactly what the JAX functions
draw from the same numpy Generator and are exact in distribution; the
engine's greedy speculative streams (draft model and prompt lookup: an
identical draft, an unrelated draft, the window edge, a stop token, a draft
with a smaller window, a clamped n_draft) equal the JAX engine's and the
port's own plain greedy stream token for token; sampled streams run to
full length; the CLI's -D and -L completions equal the JAX CLI's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from yalm_tpu import cli as jax_cli
from yalm_tpu import spec as jax_spec
from yalm_tpu.engine import Engine as JaxEngine
from yalm_tpu.engine import rejection_sample_verify as jax_rsv
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch import cli, spec
from yalm_tpu_torch.engine import Engine, _softmax_T, rejection_sample_verify

from test_torch_fast import fast_kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# checkpoint name -> (window, seed, layers)
CKPTS = {"t": (64, 1, 2), "bad": (64, 77, 2), "t32": (32, 3, 2), "t96": (96, 6, 2),
         "d32": (32, 6, 2), "d1": (64, 93, 1)}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
    out = {}
    for name, (window, seed, layers) in CKPTS.items():
        out[name] = str(d / f"{name}.yalm")
        jax_synth(out[name], jax_tiny(**fast_kw(max_seq_len=window, n_layers=layers)), seed=seed)
    return out


@pytest.fixture(scope="module")
def jax_engines(ckpts):
    """One JAX engine per checkpoint and role, reused (reset) across cases so
    its jitted programs compile once."""
    cache = {}

    def get(name, role="target"):
        if (name, role) not in cache:
            cache[name, role] = JaxEngine.from_checkpoint(ckpts[name], kv_dtype=jnp.bfloat16)
        eng = cache[name, role]
        eng.reset()
        return eng
    return get


def port(ckpts, name):
    return Engine.from_checkpoint(ckpts[name], device="cpu")


# ---------------------------------------------------------------------------
# the numpy draft sources and acceptance rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_ngram_propose_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, 4 + seed % 3, 24 + 3 * seed).tolist()
    for n in range(len(ctx) + 1):
        for k in (1, 3, 5):
            for max_ngram in (1, 2, 3, 4):
                want = jax_spec.ngram_propose(ctx[:n], k, max_ngram=max_ngram)
                assert spec.ngram_propose(ctx[:n], k, max_ngram=max_ngram) == want


@pytest.mark.parametrize("seed", range(6))
def test_ngram_history_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    toks = rng.integers(0, 5, 60).tolist()
    ngram = 1 + seed % 4
    mine = spec.NgramHistory(toks[:5], max_ngram=ngram)
    ref = jax_spec.NgramHistory(toks[:5], max_ngram=ngram)
    i = 5
    while i < len(toks):
        step = int(rng.integers(1, 4))
        mine.extend(toks[i:i + step])
        ref.extend(toks[i:i + step])
        i += step
        for k in (1, 4):
            assert mine.propose(k) == ref.propose(k)
    assert mine.latest == ref.latest and mine.prev == ref.prev


def _logits(seed, rows, V=12, scale=2.0):
    return np.random.default_rng(seed).standard_normal((rows, V)) * scale


@pytest.mark.parametrize("seed", range(6))
def test_pointmass_rejection_verify_matches_jax(seed):
    """Same Generator seed, same draws: equal outputs and equal states after."""
    K, T = 4, 0.5 + 0.2 * seed
    t_lg = _logits(seed, K + 1)
    for trial in range(40):
        d = np.random.default_rng(trial).integers(0, 12, K).tolist()
        a, b = np.random.default_rng(trial), np.random.default_rng(trial)
        assert spec.pointmass_rejection_verify(a, T, t_lg, d) == \
            jax_spec.pointmass_rejection_verify(b, T, t_lg, d)
        assert a.random() == b.random()


@pytest.mark.parametrize("seed", range(6))
def test_rejection_sample_verify_matches_jax(seed):
    K, T = 3, 0.6 + 0.15 * seed
    t_lg, d_lg = _logits(seed, K + 1), _logits(seed + 50, K)
    for trial in range(40):
        d = np.random.default_rng(trial).integers(0, 12, K).tolist()
        a, b = np.random.default_rng(trial), np.random.default_rng(trial)
        assert rejection_sample_verify(a, T, t_lg, d, d_lg) == jax_rsv(b, T, t_lg, d, d_lg)
        assert a.random() == b.random()


@pytest.mark.parametrize("pointmass", [False, True])
def test_rejection_verify_exact_distribution(pointmass):
    """One verify round's first emitted token is distributed exactly as the
    target distribution p (the Leviathan et al. guarantee), for proposals
    drawn from a different q (or a fixed point mass): 20000 rounds, a
    chi-square test of the counts against p (p-value > 1e-3) and a total
    variation below 0.02."""
    rng = np.random.default_rng(0)
    V, K, T, n = 8, 3, 0.9, 20000
    t_lg, d_lg = rng.standard_normal((K + 1, V)) * 2.0, rng.standard_normal((K, V)) * 2.0
    p0 = _softmax_T(t_lg[0], T)
    counts = np.zeros(V)
    for _ in range(n):
        if pointmass:
            emitted, _ = spec.pointmass_rejection_verify(rng, T, t_lg, [int(p0.argmax()), 1, 2])
        else:
            d = [int(rng.choice(V, p=_softmax_T(d_lg[i], T))) for i in range(K)]
            emitted, _ = rejection_sample_verify(rng, T, t_lg, d, d_lg)
        counts[emitted[0]] += 1
    assert chisquare(counts, p0 * n).pvalue > 1e-3
    assert 0.5 * np.abs(counts / n - p0).sum() < 0.02
    if not pointmass:   # p and q differ, so acceptance is partial
        assert 0.5 * np.abs(p0 - _softmax_T(d_lg[0], T)).sum() > 0.1


# ---------------------------------------------------------------------------
# the engine's speculative streams
# ---------------------------------------------------------------------------

# (target, draft or None for prompt lookup, prompt, max_steps, n_draft, stop index)
ENGINE_CASES = {
    "self K1": ("t", "t", [1, 5, 9], 20, 1, None),
    "self K3": ("t", "t", [1, 5, 9], 20, 3, None),
    "self K4": ("t", "t", [1, 5, 9], 20, 4, None),
    "bad draft": ("t", "bad", [1, 7], 16, 4, None),
    "window edge": ("t32", "t32", [1, 2, 3, 4], 40, 4, None),
    "stop token": ("t", "t", [1, 3], 30, 3, 5),
    "smaller draft window": ("t96", "d32", [1, 2, 3], 40, 4, None),
    "clamped n_draft": ("t", "t", [1, 4], 10, 10_000, None),
    "lookup": ("t", None, [1, 5, 9, 5, 9, 5, 9, 5], 24, 4, None),
    "lookup window edge": ("t32", None, [1, 2, 3, 2, 3, 2], 40, 4, None),
    "lookup stop token": ("t", None, [1, 5, 9, 5, 9], 30, 3, 6),
    "lookup clamped n_draft": ("t", None, [1, 4, 4], 10, 10_000, None),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_greedy_streams_match_jax_and_plain(ckpts, jax_engines, case):
    target, draft, prompt, n, K, stop_at = ENGINE_CASES[case]
    plain = list(port(ckpts, target).generate(prompt, max_steps=n, temperature=0.0))
    stop = [plain[stop_at]] if stop_at is not None else []
    if stop:
        plain = plain[: plain.index(stop[0]) + 1]
    je = jax_engines(target)
    jd = jax_engines(draft, "draft") if draft else None
    want = list(je.generate_speculative(prompt, draft=jd, n_draft=K, max_steps=n,
                                        stop_tokens=stop))
    te = port(ckpts, target)
    got = list(te.generate_speculative(prompt, draft=port(ckpts, draft) if draft else None,
                                       n_draft=K, max_steps=n, stop_tokens=stop))
    assert got == want == plain
    assert te._spec_stats == je._spec_stats
    if case.startswith("self") and K > 1:   # an identical draft is (nearly) always accepted
        st = te._spec_stats
        assert st["rounds"] > 0 and st["accepted"] / st["rounds"] > 0.8 * (K - 1)


@pytest.mark.parametrize("draft,T,n,seed", [("t", 0.8, 24, 5), ("d1", 1.0, 12, 6)])
def test_engine_sampled_streams(ckpts, draft, T, n, seed):
    """Rejection-sampled speculation runs to full length with in-vocabulary
    ids; an identical draft's q equals p up to the step-vs-chunk numerics,
    so acceptance is near total (the distribution is held exactly above)."""
    te = port(ckpts, "t")
    toks = list(te.generate_speculative([1, 7, 3], draft=port(ckpts, draft), n_draft=4,
                                        max_steps=n, temperature=T, seed=seed))
    assert len(toks) == n and all(0 <= t < 512 for t in toks)
    st = te._spec_stats
    assert st["rounds"] >= 1
    if draft == "t":
        assert st["accepted"] / (4 * st["rounds"]) > 0.7, st
    te2 = port(ckpts, "t")   # the same seed draws the same stream
    assert list(te2.generate_speculative([1, 7, 3], draft=port(ckpts, draft), n_draft=4,
                                         max_steps=n, temperature=T, seed=seed)) == toks


def _completion(out: bytes) -> tuple[bytes, bytes]:
    """The streamed completion and the speculation line of a CLI run."""
    body = out.split(b"Encoding stats")[1].split(b"\n", 1)[1].split(b"Generation stats")[0]
    stats = [ln for ln in out.splitlines() if ln.startswith(b"Speculative stats")]
    return body, stats[0] if stats else b""


@pytest.mark.parametrize("flags", [["-D", "draft"], ["-L"]])
def test_cli_speculation_matches_jax_cli(ckpts, capsysbinary, flags):
    flags = [ckpts["t"] if f == "draft" else f for f in flags]
    args = [ckpts["t"], "-d", "cpu", "-m", "completion", "-i", "hello world hello world",
            "-n", "24", "-t", "0", "-K", "3", *flags]
    jax_cli.main(args)
    want = _completion(capsysbinary.readouterr().out)
    cli.main(args)
    got = _completion(capsysbinary.readouterr().out)
    assert got == want and got[1].startswith(b"Speculative stats: ")
