"""The port's MoE slice on the CPU (plain versions) against the JAX package's
(emulation branches; `gemv_le` also in Pallas interpret mode) on the same
seed-made inputs, at a tiny Mixtral-style config (dim 256, hidden 512, 4
experts with 2 active, 2 layers, window 32): the top-k gate, the
routed-expert GEMV/GEMM (K10, K11), the checkpoint fixture and loader,
single-stream decode and prefill, the batched and paged chunk sweeps and
ticks (the all-expert sweep), and the schedulers' greedy streams, dense,
paged and under pool pressure.

Tolerances: the gate within f32 rounding (1e-6); the routed-expert
functions within 2e-3 of max(1, max|ref|) (the same bf16-operand, f32-sum
arithmetic: summation order only); whole-model logits and caches within
1e-2 of max(1, max|logit|) (tests/test_torch_fast.py says why); greedy
streams exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.engine import Engine as JaxEngine
from yalm_tpu.models.cache import KVCache as JaxCache
from yalm_tpu.models.fast import decode_step_fast as jax_decode
from yalm_tpu.models.fast import decode_step_fast_batched as jax_tick
from yalm_tpu.models.fast import decode_step_fast_batched_paged as jax_tick_paged
from yalm_tpu.models.fast import prefill_chunk_fast_batched as jax_chunk
from yalm_tpu.models.fast import prefill_chunk_fast_batched_paged as jax_chunk_paged
from yalm_tpu.models.fast import prefill_fast as jax_prefill
from yalm_tpu.models.paged import PagedKVPool as JaxPool
from yalm_tpu.ops import core as jcore
from yalm_tpu.ops.pallas import gemv as jgemv
from yalm_tpu.scheduler import Request as JaxRequest
from yalm_tpu.scheduler import Scheduler as JaxScheduler
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch import cli
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.engine import Engine
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import (decode_step_fast, decode_step_fast_batched,
                                        decode_step_fast_batched_paged, load_fast_weights,
                                        prefill_chunk_fast_batched,
                                        prefill_chunk_fast_batched_paged, prefill_fast)
from yalm_tpu_torch.models.paged import PagedKVPool
from yalm_tpu_torch.ops.core import moe_gate
from yalm_tpu_torch.ops.cuda.gemv import gemm4_le, gemm_le, gemv4_le, gemv_le
from yalm_tpu_torch.ops.int4 import pack_int4
from yalm_tpu_torch.scheduler import Request, Scheduler
from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config

from test_torch_fast import both_weights, close, fast_kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}
PAGE = 16


def moe_kw(**overrides):
    return fast_kw(**{"n_experts": 4, "n_experts_active": 2, **overrides})


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.element_size() == 1 else t


# ---------------------------------------------------------------- (a) the gate

@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shape", [(8,), (6, 8)])
def test_moe_gate_matches_jax(k, shape):
    logits = (np.random.default_rng(k).standard_normal(shape) * 2).astype(np.float32)
    jg, ji = jcore.moe_gate(jnp.asarray(logits), k)
    tg, ti = moe_gate(torch.from_numpy(logits), k)
    assert ti.tolist() == np.asarray(ji).tolist()     # ranked highest first, as top_k
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------- (b) K10, K11: plain versions

L, E, N, K = 2, 3, 96, 512


def expert_stack(wt: str, rng):
    """(JAX weights, port weights, JAX scales, port scales) of an (L, E, N, K)
    stack: e5m2 and bf16 without scales, int8 with per-row (L, E, N) scales,
    packed int4 with (L, E, G, N) group scales."""
    f = rng.standard_normal((L, E, N, K)).astype(np.float32) / np.sqrt(K)
    if wt == "int4":
        p, gs = pack_int4(f)
        return jnp.asarray(p), torch.from_numpy(p), jnp.asarray(gs), torch.from_numpy(gs)
    if wt == "int8":
        q = rng.integers(-127, 128, (L, E, N, K)).astype(np.int8)
        s = (rng.random((L, E, N)) * 1e-2 + 1e-3).astype(np.float32)
        return jnp.asarray(q), torch.from_numpy(q), jnp.asarray(s), torch.from_numpy(s)
    jdt, tdt = {"e5m2": (jnp.float8_e5m2, torch.float8_e5m2),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[wt]
    return jnp.asarray(f).astype(jdt), torch.from_numpy(f).to(tdt), None, None


@pytest.mark.parametrize("wt,rows", [("e5m2", 0), ("bf16", 0), ("int8", 0), ("e5m2", 5),
                                     ("int8", 5), ("int4", 0), ("int4", 5)])
def test_routed_expert_plain_versions_match_jax(wt, rows):
    """gemv_le/gemm_le (rows 0: the GEMV) and gemv4_le/gemm4_le against the
    JAX emulation at every (layer, expert), the expert a host int and a
    one-element tensor; the GEMV's rmsnorm prologue and GLU epilogue against
    the same composition in JAX (rmsnorm, then act(h1) * h3)."""
    rng = np.random.default_rng(len(wt) + rows)
    jw, tw, js, ts = expert_stack(wt, rng)
    x = rng.standard_normal((rows, K) if rows else (K,)).astype(np.float32)
    int4 = wt == "int4"
    jfn = {(False, 0): jgemv.gemv_le, (False, 1): jgemv.gemm_le,
           (True, 0): jgemv.gemv4_le, (True, 1): jgemv.gemm4_le}[int4, rows > 0]
    tfn = {(False, 0): gemv_le, (False, 1): gemm_le,
           (True, 0): gemv4_le, (True, 1): gemm4_le}[int4, rows > 0]
    for layer in range(L):
        for e in range(E):
            want = np.asarray(jfn(jnp.asarray(x), jw, jnp.int32(layer), jnp.int32(e), js))
            for expert in (e, torch.tensor(e)):
                close(tfn(torch.from_numpy(x), tw, layer, expert, ts), want, 2e-3)
    if rows == 0:
        nw = (1 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
        xb = jcore.rmsnorm(jnp.asarray(x), jnp.asarray(nw[1]), 1e-5)
        h13 = jfn(xb, jw, jnp.int32(1), jnp.int32(2), js)
        # the GLU epilogue writes bf16 values, as the next projection reads them
        want = (jcore.silu(h13[: N // 2]) * h13[N // 2:]).astype(jnp.bfloat16)
        got = tfn(torch.from_numpy(x), tw, 1, 2, ts, norm_w=torch.from_numpy(nw),
                  norm_eps=1e-5, glu_act="silu")
        close(got, want, 2e-3)


@pytest.mark.parametrize("wt", ["e5m2", "int8"])
def test_gemv_le_matches_jax_interpret(wt):
    """The TPU kernel itself, run by the Pallas interpreter (as
    tests/test_fast_path.py:222-233 runs it), at every (layer, expert)."""
    rng = np.random.default_rng(3)
    jw, tw, js, ts = expert_stack(wt, rng)
    x = rng.standard_normal(K).astype(np.float32)
    for layer in range(L):
        for e in range(E):
            want = jgemv.gemv_le(jnp.asarray(x), jw, jnp.int32(layer), jnp.int32(e), js,
                                 interpret=True)
            close(gemv_le(torch.from_numpy(x), tw, layer, e, ts), np.asarray(want), 2e-3)


def test_routed_expert_wrappers_refuse_bad_arguments():
    w = torch.zeros(2, 3, 32, 64)
    with pytest.raises(ValueError, match="expert stack"):
        gemv_le(torch.zeros(64), torch.zeros(2, 32, 64), 0, 0)       # a layer stack
    with pytest.raises(ValueError, match="expert stack"):
        gemm4_le(torch.zeros(4, 128), torch.zeros(2, 3, 32, 64, dtype=torch.uint8), 0, 0,
                 torch.zeros(2, 3, 1, 32))                             # K % 256
    with pytest.raises(ValueError, match="different devices"):
        gemm_le(torch.zeros(4, 64), w, 0, torch.tensor(1, device="meta"))


# ------------------------------------------- (c) the checkpoint and the loader

@pytest.mark.parametrize("wdt", ["fp8", "int8", "int4"])
def test_synth_checkpoint_moe_bytes_match_jax(tmp_path, wdt):
    """The router and every expert in the JAX fixture's RNG order: int8 and
    int4 write the router int8 with per-row scales, int4 packs the experts
    over their leading axis."""
    p_port, p_jax = str(tmp_path / "port.yalm"), str(tmp_path / "jax.yalm")
    synth_checkpoint(p_port, tiny_config(**moe_kw(weight_dtype=wdt)), seed=4)
    jax_synth(p_jax, jax_tiny(**moe_kw(weight_dtype=wdt)), seed=4)
    with open(p_port, "rb") as a, open(p_jax, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("wdt", ["fp8", "int8", "int4"])
def test_load_fast_weights_moe_matches_jax(tmp_path, wdt):
    kw = moe_kw(weight_dtype=wdt)
    path = str(tmp_path / "m.yalm")
    jax_synth(path, jax_tiny(**kw), seed=5)
    _, want = both_weights(path, jax_tiny(**kw))
    yf = read_yalm(path)
    got = load_fast_weights(yf, tiny_config(**kw), "cpu")
    yf.close()
    assert got.w13.shape[:2] == (2, 4) and got.moegate.shape == (2, 4, 256)
    assert got.moegate.dtype == (torch.int8 if wdt in ("int8", "int4") else torch.float8_e5m2)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "scales":
            assert (a is None) == (wdt == "fp8") == (b is None)
            for g in dataclasses.fields(a) if a is not None else ():
                assert torch.equal(getattr(a, g.name), getattr(b, g.name)), g.name
        elif a is None:
            assert b is None, f.name
        else:
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), f.name


# --------------------------------------------------- (d) single stream, prefill

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """weights -> (path, JAX cfg, JAX FastWeights, port cfg, port FastWeights)."""
    out = {}
    for wdt in ("fp8", "int4"):
        kw = moe_kw(weight_dtype=wdt)
        path = str(tmp_path_factory.mktemp("moe") / f"{wdt}.yalm")
        jax_synth(path, jax_tiny(**kw), seed=6)
        jw, tw = both_weights(path, jax_tiny(**kw))
        out[wdt] = (path, jax_tiny(**kw), jw, tiny_config(**kw), tw)
    return out


PATHS = [("fp8", "bf16"), ("int4", "e5m2")]


@pytest.mark.parametrize("wdt,kv", PATHS)
def test_decode_step_fast_moe_matches_jax(models, wdt, kv):
    """40 greedy steps from an empty cache: past the 32-slot window, ring +
    sinks; the routed experts added in rank order."""
    _, jcfg, jw, cfg, tw = models[wdt]
    jdt, tdt = KV[kv]
    jc, tc = JaxCache.init(jcfg, jdt), KVCache.init(cfg, tdt, "cpu")
    tok = 5
    for pos in range(cfg.max_seq_len + 8):
        want, jc = jax_decode(jcfg, jw, jnp.int32(tok), jnp.int32(pos), jc)
        got, tc = decode_step_fast(cfg, tw, tok, pos, tc)
        close(got, want)
        tok = int(np.argmax(np.asarray(want)))
    close(tc.k.float(), np.asarray(jc.k, np.float32))
    close(tc.v.float(), np.asarray(jc.v, np.float32))


@pytest.mark.parametrize("wdt,kv", PATHS)
@pytest.mark.parametrize("mode", ["last", "all"])
def test_prefill_fast_moe_matches_jax(models, wdt, kv, mode):
    """Two chunks (13 of 16 valid at 0, attend 16; 10 of 16 at 13, attend
    32) through the all-expert sweep."""
    _, jcfg, jw, cfg, tw = models[wdt]
    jdt, tdt = KV[kv]
    jc, tc = JaxCache.init(jcfg, jdt), KVCache.init(cfg, tdt, "cpu")
    rng = np.random.default_rng(3)
    for pos0, valid, attend, m in ((0, 13, 16, "none"), (13, 10, 32, mode)):
        toks = rng.integers(3, cfg.vocab_size, 16).astype(np.int32)
        want, jc = jax_prefill(jcfg, jw, jnp.asarray(toks), jnp.int32(pos0), jnp.int32(valid),
                               jc, logits_mode=m, attend_len=attend)
        got, tc = prefill_fast(cfg, tw, toks, pos0, valid, tc, logits_mode=m, attend_len=attend)
        assert (got is None) == (want is None)
        if got is not None:
            assert tuple(got.shape) == want.shape
            close(got, want)
    close(tc.k.float(), np.asarray(jc.k, np.float32))


def test_engine_moe_greedy_stream_and_perplexity(models):
    path = models["fp8"][0]
    je = JaxEngine.from_checkpoint(path)
    te = Engine.from_checkpoint(path, device="cpu")
    prompt = list(range(3, 43))   # 40 tokens: 32 chunked, 8 hydrated in the ring
    want = list(je.generate(prompt, max_steps=10, temperature=0.0))
    assert list(te.generate(prompt, max_steps=10, temperature=0.0)) == want
    je.reset()
    te.reset()
    toks = [1] + list(range(40, 70))
    jp, _, jn = je.perplexity(toks)
    tp, _, tn = te.perplexity(toks)
    assert tn == jn and abs(tp - jp) <= 1e-3 * jp


# ------------------------------------- (e) the batched and paged chunk paths

@pytest.mark.parametrize("wdt,kv", PATHS)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_batched_moe_chunk_and_ticks_match_jax(models, wdt, kv, paged):
    """One chunk sweep (three lanes at different offsets, one disabled;
    paged: a chunk straddling pages, through shuffled tables), then ticks
    with a write-masked lane and a lane that crosses into the ring, on
    caches that start random. Paged pools are compared on every page but
    the reserved page 0, where the JAX emulation scatters padding rows."""
    _, jcfg, jw, cfg, tw = models[wdt]
    jdt, _ = KV[kv]
    rng = np.random.default_rng(9)
    B, T = 4, 16
    tables = np.asarray([[3, 7], [5, 1], [8, 2], [4, 6]], np.int32)
    shape = ((9, cfg.n_layers, PAGE) if paged else (B, cfg.n_layers, cfg.max_seq_len)) + (
        cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = (np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.5, jdt)) for _ in range(2))
    if paged:
        jc, tc = JaxPool(k=jnp.asarray(k0), v=jnp.asarray(v0)), PagedKVPool.from_numpy(k0, v0)
        pg = dict(page_size=PAGE)
        jchunk = lambda *a, **k: jax_chunk_paged(*a, jnp.asarray(tables), **pg, **k)  # noqa: E731
        tchunk = lambda *a, **k: prefill_chunk_fast_batched_paged(*a, tables, **pg, **k)  # noqa
        jstep = lambda *a: jax_tick_paged(*a[:5], jnp.asarray(tables), a[5], **pg)  # noqa: E731
        tstep = lambda *a: decode_step_fast_batched_paged(*a[:5], tables, a[5], **pg)  # noqa
        pos0, valid = [0, 5, 16, 0], [16, 14, 9, 0]
    else:
        jc, tc = JaxCache(k=jnp.asarray(k0), v=jnp.asarray(v0)), KVCache.from_numpy(k0, v0)
        jchunk = lambda *a, **k: jax_chunk(*a, attend_len=32, **k)  # noqa: E731
        tchunk = lambda *a, **k: prefill_chunk_fast_batched(*a, attend_len=32, **k)  # noqa
        jstep, tstep = jax_tick, decode_step_fast_batched
        pos0, valid = [0, 8, 16, 0], [16, 5, 11, 0]
    enable = [1, 1, 1, 0]
    toks = rng.integers(3, cfg.vocab_size, (B, T)).astype(np.int32)
    want, jc = jchunk(jcfg, jw, jnp.asarray(toks), jnp.asarray(pos0, jnp.int32),
                      jnp.asarray(valid, jnp.int32), jnp.asarray(enable, jnp.int32), jc,
                      logits_mode="lastv")
    got, tc = tchunk(cfg, tw, toks, pos0, valid, enable, tc, logits_mode="lastv")
    assert got.shape == want.shape == (B, cfg.vocab_size)
    close(got[:3], np.asarray(want)[:3])

    positions = np.array([16, 19, 29, 6])
    write = np.array([1, 1, 1, 0])               # lane 3 attends read-only
    for _ in range(4):                            # lane 2 goes 29 -> 32: ring + sinks
        tok = rng.integers(3, cfg.vocab_size, B).astype(np.int32)
        want, jc = jstep(jcfg, jw, jnp.asarray(tok), jnp.asarray(positions, jnp.int32), jc,
                         jnp.asarray(write, jnp.int32))
        got, tc = tstep(cfg, tw, tok, positions, tc, write)
        close(got, want)
        positions = positions + write
    first = 1 if paged else 0
    for t, w in ((tc.k, jc.k), (tc.v, jc.v)):
        close(t[first:].float(), np.asarray(w, np.float32)[first:])


# ------------------------------------------------------- (f) scheduler streams

def _reqs(R, n, max_new, seed0=0):
    return [R(prompt_tokens=[1, 5 + i, 9], max_new_tokens=max_new, temperature=0.0,
              seed=seed0 + i) for i in range(n)]


def _run(sched, reqs):
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [list(r.generated) for r in reqs]


@pytest.fixture(scope="module")
def sched_models(tmp_path_factory):
    """(E, k, window, seed) -> (JAX cfg, JAX FastWeights, port cfg, port
    FastWeights): tests/test_paged.py's MoE models (2 experts, 1 active) and
    tests/test_scheduler.py's (4 experts, 2 active, window 64), fp8."""
    out = {}
    for key in ((2, 1, 32, 42), (2, 1, 32, 43), (4, 2, 64, 0)):
        E, k, window, seed = key
        kw = fast_kw(n_experts=E, n_experts_active=k, max_seq_len=window)
        path = str(tmp_path_factory.mktemp("sched") / f"m{seed}.yalm")
        jax_synth(path, jax_tiny(**kw), seed=seed)
        out[key] = (jax_tiny(**kw), *both_weights(path, jax_tiny(**kw)), tiny_config(**kw))
    return out


# (model, requests, max_new, seed0, port paged pages and page size): the
# counterparts of test_paged_moe_matches_dense, test_paged_moe_pool_pressure
# and test_scheduler_moe_fast_tick
SCHED_CASES = {"paged_moe_matches_dense": ((2, 1, 32, 42), 6, 8, 0, 1 + 8 * 2, PAGE),
               "paged_moe_pool_pressure": ((2, 1, 32, 43), 6, 16, 3, 7, 8),
               "scheduler_moe_fast_tick": ((4, 2, 64, 0), 4, 5, 0, 1 + 8 * 4, PAGE)}


@pytest.mark.parametrize("name", list(SCHED_CASES))
def test_moe_scheduler_streams_dense_paged_and_jax(sched_models, name):
    """Greedy MoE streams of the port's scheduler, dense and paged, equal the
    JAX fast scheduler's; under pool pressure the paged run preempts and
    resumes, and every stream still completes identically."""
    key, n, max_new, seed0, pages, page = SCHED_CASES[name]
    jcfg, jw, tw, cfg = sched_models[key]
    want = _run(JaxScheduler(jcfg, jw, batch=8, fast=True, kv_dtype=jnp.bfloat16),
                _reqs(JaxRequest, n, max_new, seed0))
    dense = _run(Scheduler(cfg, tw, batch=8, device="cpu"), _reqs(Request, n, max_new, seed0))
    paged = Scheduler(cfg, tw, batch=8, device="cpu", paged_pages=pages, page_size=page)
    got = _run(paged, _reqs(Request, n, max_new, seed0))
    assert all(len(s) == max_new for s in want)
    assert dense == want and got == want
    assert paged.alloc.n_free == pages - 1
    if name == "paged_moe_pool_pressure":
        assert paged.preemptions >= 1 and paged.resumes >= 1


# ----------------------------------------------------------------- (g) the CLI

def test_cli_moe_completion(models, capsysbinary):
    cli.main([models["fp8"][0], "-d", "cpu", "-m", "completion", "-i", "hello world", "-n", "6",
              "-t", "0"])
    assert b"Generation stats" in capsysbinary.readouterr().out

