"""The port's continuous-batching scheduler on the CPU (plain versions):
greedy streams equal the JAX package's fast Scheduler and the port's own
Engine on the same checkpoint; logprobs and top-N agree with the JAX
scheduler's within 1e-2 (the logits agree to 1e-2 of max(1, max|logit|),
tests/test_torch_fast.py); admission (per slot, ring, batched), the dense
prefix cache, logit_bias, sampling keyed by (seed, position), failure
isolation and recover.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.scheduler import Request as JaxRequest
from yalm_tpu.scheduler import Scheduler as JaxScheduler
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch.engine import Engine
from yalm_tpu_torch.medusa import MedusaWeights
from yalm_tpu_torch.scheduler import Request, Scheduler
from yalm_tpu_torch.utils.testing import tiny_config

from test_torch_fast import both_weights, fast_kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

LP_TOL = 1e-2
RNG = np.random.default_rng(11)
# (prompt, max_new_tokens, logit_bias): short, two chunks, past the 32-slot
# window (ring admission), and a biased request
CASES = [([1] + RNG.integers(3, 512, 4).tolist(), 8, None),
         ([1] + RNG.integers(3, 512, 19).tolist(), 8, None),
         ([1] + RNG.integers(3, 512, 39).tolist(), 6, None),
         ([1] + RNG.integers(3, 512, 11).tolist(), 6, {7: 4.0, 300: -100.0, 9999: 5.0})]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sched") / "m.yalm")
    jax_synth(path, jax_tiny(**fast_kw()), seed=0)
    jw, tw = both_weights(path, jax_tiny(**fast_kw()))
    return path, jw, tw, tiny_config(**fast_kw())


@pytest.fixture(scope="module")
def jax_run(model):
    """The JAX fast scheduler (batch 8, top-3 logprobs) on CASES."""
    path, jw, _, _ = model
    sched = JaxScheduler(jax_tiny(**fast_kw()), jw, batch=8, fast=True,
                         kv_dtype=jnp.bfloat16, top_logprobs=3)
    reqs = [sched.submit(JaxRequest(prompt_tokens=p, max_new_tokens=n, temperature=0.0,
                                    logit_bias=bias)) for p, n, bias in CASES]
    sched.run()
    return reqs


def run(tw, cfg, requests, **kw):
    sched = Scheduler(cfg, tw, device="cpu", **{"batch": 8, **kw})
    for r in requests:
        sched.submit(r)
    sched.run()
    return sched


def greedy(p, n, **kw):
    return Request(prompt_tokens=list(p), max_new_tokens=n, temperature=0.0, **kw)


def test_greedy_streams_logprobs_and_bias_match_jax(model, jax_run):
    _, _, tw, cfg = model
    reqs = [greedy(p, n, logit_bias=bias) for p, n, bias in CASES]
    run(tw, cfg, reqs, top_logprobs=3)
    for got, want in zip(reqs, jax_run):
        assert got.done and got.error is None
        assert got.generated == want.generated
        np.testing.assert_allclose(got.logprobs, want.logprobs, atol=LP_TOL)
        for g, w in zip(got.top_logprobs, want.top_logprobs):
            assert [t for t, _ in g] == [t for t, _ in w]
            np.testing.assert_allclose([l for _, l in g], [l for _, l in w], atol=LP_TOL)
    # the -100 bias keeps its token out; the +4 bias shows in the logprob rows
    assert 300 not in reqs[3].generated


def test_greedy_streams_match_the_engine(model):
    path, _, tw, cfg = model
    eng = Engine(cfg, tw, device="cpu")
    reqs = [greedy(p, n) for p, n, _ in CASES[:3]]
    run(tw, cfg, reqs, batch=2)             # 2 slots, 3 requests: a slot is reused
    for r in reqs:
        eng.reset()
        assert r.generated == list(eng.generate(r.prompt_tokens, max_steps=r.max_new_tokens,
                                                temperature=0.0))


def test_stop_tokens_and_interleaved_admission(model):
    _, _, tw, cfg = model
    ref_stream = greedy(CASES[0][0], 8)
    ref = run(tw, cfg, [ref_stream], batch=2)
    stop = ref_stream.generated[2]
    sched = Scheduler(cfg, tw, batch=2, device="cpu")
    a = sched.submit(greedy(CASES[0][0], 8, stop_tokens=frozenset({stop})))
    sched.step()
    sched.step()
    b = sched.submit(greedy(CASES[1][0], 8))   # joins mid-flight
    sched.run()
    assert a.generated == ref_stream.generated[:ref_stream.generated.index(stop) + 1]
    solo = greedy(CASES[1][0], 8)
    run(tw, cfg, [solo], batch=1)
    assert b.generated == solo.generated
    assert ref.n_active == 0


def test_batched_admission_sweeps_and_streams(model):
    _, _, tw, cfg = model
    prompts = [[1] + [3 + i] * (9 + i) for i in range(4)]   # one 16-row bucket each
    base = [greedy(p, 5) for p in prompts]
    s0 = run(tw, cfg, base)
    batched = [greedy(p, 5) for p in prompts]
    s1 = run(tw, cfg, batched, batched_admission=True)
    # four admissions, one weight sweep
    assert s0.admit_sweeps == 0 and s1.admit_sweeps == 1
    assert [r.generated for r in batched] == [r.generated for r in base]


def test_dense_prefix_cache(model):
    _, _, tw, cfg = model
    sched = Scheduler(cfg, tw, batch=2, prefix_cache=True, device="cpu")
    prompt = [1] + [7, 9, 11] * 6                        # 19 tokens
    r1 = sched.submit(greedy(prompt, 6))
    sched.run()
    r2 = sched.submit(greedy(prompt, 6))                 # hit: the whole prefix but one
    sched.run()
    st = sched.prefix_stats
    assert st["registered"] >= 1 and st["hits"] == 1 and st["hit_tokens"] == len(prompt) - 1
    assert r2.generated == r1.generated
    fork = prompt[:12] + [20] * 6                        # partial match: 12 tokens
    r3 = sched.submit(greedy(fork, 6))
    sched.run()
    assert sched.prefix_stats["hit_tokens"] == len(prompt) - 1 + 12
    cold = greedy(fork, 6)
    run(tw, cfg, [cold], batch=1)
    assert r3.generated == cold.generated
    # invalidation: both lanes are overwritten by other prompts
    for i in range(2):
        sched.submit(greedy([1] + [40 + i] * 8, 3))
    sched.run()
    before = sched.prefix_stats["hit_tokens"]
    r4 = sched.submit(greedy(prompt, 6))
    sched.run()
    assert r4.generated == r1.generated and sched.prefix_stats["hit_tokens"] - before <= 1
    # ring opt-out: a request that could wrap the window never registers
    ring = Scheduler(cfg, tw, batch=2, prefix_cache=True, device="cpu")
    long_prompt = [1] + [5] * 25
    for _ in range(2):
        ring.submit(greedy(long_prompt, 10))             # 26 + 10 + 1 > 32
        ring.run()
    assert ring.prefix_stats["registered"] == 0 and ring.prefix_stats["hits"] == 0


def test_sampled_stream_is_independent_of_lane_and_batch_mates(model):
    _, _, tw, cfg = model

    def sampled():
        return Request(prompt_tokens=list(CASES[1][0]), max_new_tokens=10, temperature=0.8,
                       top_k=40, top_p=0.9, seed=1234)

    alone = sampled()
    run(tw, cfg, [alone], batch=1)
    crowded = sampled()
    mates = [Request(prompt_tokens=[1] + [20 + i] * (3 + i), max_new_tokens=12,
                     temperature=1.0, seed=i) for i in range(5)]
    sched = run(tw, cfg, mates + [crowded], batch=8)    # lane 5, among other traffic
    assert sched.n_active == 0
    assert crowded.generated == alone.generated
    other_seed = sampled()
    other_seed.seed = 99
    run(tw, cfg, [other_seed], batch=1)
    assert other_seed.generated != alone.generated


def test_poisoned_request_isolation_and_recover(model):
    _, _, tw, cfg = model
    solo = greedy(CASES[0][0], 6)
    run(tw, cfg, [solo], batch=1)

    def boom(tok):
        raise RuntimeError("poisoned callback")

    bad = greedy([1, 7, 2], 6, on_token=boom)
    good = greedy(CASES[0][0], 6)
    run(tw, cfg, [bad, good], batch=2)
    assert bad.done and "poisoned" in bad.error
    assert good.done and good.error is None and good.generated == solo.generated

    sched = Scheduler(cfg, tw, batch=2, device="cpu")
    active = [sched.submit(greedy([1, 5 + i], 64)) for i in range(2)]
    queued = sched.submit(greedy(CASES[0][0], 6))
    sched.step()
    assert sched.n_active == 2 and sched.queue == [queued]
    sched.recover(RuntimeError("simulated device error"))
    assert all(r.done and "device error" in r.error for r in active)
    assert not queued.done and sched.queue == [queued]
    sched.run()
    assert queued.error is None and queued.generated == solo.generated


@pytest.mark.parametrize("kw", [dict(paged_pages=8, page_size=16), dict(spec_tree=(2,)),
                                dict(mesh="tp2", fast=False)])
def test_later_slices_raise(model, kw):
    """The sharded oracle on a mesh is a later slice and raises (the
    scheduler on a mesh runs the kernels: tests/test_torch_scheduler_mesh.py);
    paged KV came with its slice and
    serves (tests/test_torch_paged.py holds its streams to the JAX paged
    scheduler's; tests/test_torch_spec_scheduler.py the chain
    speculation's), and so does tree-attention Medusa on the dense cache
    (tests/test_torch_medusa_tree.py holds it to JAX's), whose paged form
    raises JAX's ValueError."""
    _, _, tw, cfg = model
    if "paged_pages" in kw:
        sched = Scheduler(cfg, tw, device="cpu", **kw)
        req = greedy(CASES[1][0], 6)
        run(tw, cfg, [req], paged_pages=8, page_size=16)
        dense = greedy(CASES[1][0], 6)
        run(tw, cfg, [dense])
        assert sched.paged and sched.alloc.n_free == 7 and req.generated == dense.generated
    elif "spec_tree" in kw:
        gen = torch.Generator().manual_seed(3)
        heads = MedusaWeights(
            w1=(torch.randn(2, cfg.dim, cfg.dim, generator=gen) * 0.02).to(torch.bfloat16),
            b1=torch.zeros(2, cfg.dim),
            head=(torch.randn(2, cfg.vocab_size, cfg.dim, generator=gen) * 0.02).to(torch.bfloat16))
        req = greedy(CASES[1][0], 6)
        sched = run(tw, cfg, [req], spec_medusa=heads, **kw)
        assert sched.spec_tree == (2,) and sched.spec_stats["rounds"] >= 1
        assert len(req.generated) == 6 and req.error is None
        with pytest.raises(ValueError, match="dense single-device"):
            Scheduler(cfg, tw, device="cpu", spec_medusa=heads, paged_pages=8, page_size=16,
                      **kw)
    else:
        from yalm_tpu_torch.parallel.mesh import MeshConfig, grid_mesh
        kw["mesh"] = grid_mesh(MeshConfig(tp=2), 0)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Scheduler(cfg, tw, device="cpu", **kw)
    with pytest.raises(ValueError, match="at most 16"):
        Scheduler(cfg, tw, device="cpu").submit(
            greedy([1], 2, logit_bias={i: 1.0 for i in range(17)}))
