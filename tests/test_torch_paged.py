"""The port's paged KV path on the CPU (plain versions) against the JAX
package's (emulation branches) on the same seed-made inputs: the page
allocator, the paged attention step (K9), the paged tick, the per-slot
paged prefill and the batched paged chunk, and the paged scheduler's
greedy streams against the JAX paged scheduler's and the port's own dense
scheduler's, in the cases of tests/test_paged.py (pages of 16).

Tolerances: the attention output within 2e-3 of max(1, max|ref|) and the
pools byte for byte (the written rows are one f32 -> cache-type rounding of
the same values), on every page but the reserved page 0, where the JAX
emulation scatters unmapped blocks and padding rows; whole-model logits and
pools within 1e-2 of max(1, max|ref|) (tests/test_torch_fast.py says why),
pools again on every page but page 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.models.fast import decode_step_fast_batched_paged as jax_tick
from yalm_tpu.models.fast import prefill_chunk_fast_batched_paged as jax_chunk
from yalm_tpu.models.fast import prefill_fast_paged as jax_prefill
from yalm_tpu.models.paged import PageAllocator as JaxAllocator
from yalm_tpu.models.paged import PagedKVPool as JaxPool
from yalm_tpu.ops.pallas.attention import attend_step_paged_l as jax_attend
from yalm_tpu.scheduler import Request as JaxRequest
from yalm_tpu.scheduler import Scheduler as JaxScheduler
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch.models.fast import (decode_step_fast_batched_paged,
                                        prefill_chunk_fast_batched_paged, prefill_fast_paged)
from yalm_tpu_torch.models.paged import PageAllocator, PagedKVPool
from yalm_tpu_torch.ops.cuda.attention import attend_step_paged_l
from yalm_tpu_torch.scheduler import Request, Scheduler
from yalm_tpu_torch.utils.testing import tiny_config

from test_torch_fast import both_weights, close, fast_kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PAGE = 16
KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16).numpy()


def _pool_pages(t: torch.Tensor) -> torch.Tensor:
    return t[1:]   # every page but the reserved page 0


# ---------------------------------------------------------------- (a) allocator

def _allocator_run(al) -> list:
    """One grow / release / match / register / evict sequence; a snapshot
    of the tables, free list, LRU and counters after every call."""
    out = []

    def snap(*extra):
        out.append((al.table_array().tolist(), list(al.free), sorted(al.lru.items()),
                    sorted(al.ref.items()), dict(al.prefix_stats), al.n_free, *extra))

    p = [1] + list(range(3, 43))               # 41 tokens: 2 full pages + 9
    q = [1] + list(range(50, 90))              # another 41
    al.grow(0, 17)
    al.grow(1, 16)
    snap(al.can_grow(2, 100 * PAGE), al.mapped_through(0, 32), al.mapped_through(0, 33))
    al.release(0)
    snap()
    al.grow(0, len(p))
    al.register_prefix(0, p)
    al.release(0)
    snap()
    snap(al.match_prefix(2, p), al.match_prefix(3, p[:20]), al.match_prefix(0, q))
    al.grow(2, len(p))
    al.grow(0, len(q))
    al.register_prefix(0, q)
    al.register_prefix(2, p)                   # already shared: nothing new
    al.release(2)
    al.release(3)
    al.release(0)
    snap()
    al.grow(1, 64)                             # takes the free list
    snap(al.can_grow(3, 64), al.can_grow(3, 80))
    al.grow(3, 48)                             # evicts LRU cached pages
    snap()
    al.release(1)
    al.release(3)
    snap(al.lane_capacity, al.same_pool(0, 1), al.pages_for(0), al.pages_for(33))
    return out


def test_allocator_matches_jax():
    kw = fast_kw(max_seq_len=64)
    got = _allocator_run(PageAllocator(tiny_config(**kw), 9, 4, PAGE))
    want = _allocator_run(JaxAllocator(jax_tiny(**kw), 9, 4, PAGE))
    assert got == want
    assert got[-2][4]["evicted"] == 3 and got[3][-3:] == (2 * PAGE, PAGE, 0)
    with pytest.raises(ValueError):
        PageAllocator(tiny_config(**kw), 4, 2, page_size=7)   # doesn't divide the window


# ---------------------------------------------------------------- (b) K9, plain

# (tables, kv_pos, kv_len, kv_sink, pos, write) per lane: the two cases of
# tests/test_paged.py:241-246, and lanes 0 and 1 sharing page 1 (a prefix)
# beside a ring lane with sinks whose second block is unmapped (page 0)
ATT_CASES = [
    dict(tables=[[1, 2], [3, 4]], kv_pos=[0, 5], kv_len=[1, 6], kv_sink=[0, 0],
         pos=[0, 5], write=[1, 1]),
    dict(tables=[[1, 2], [3, 4]], kv_pos=[9, 2], kv_len=[10, 16], kv_sink=[0, 2],
         pos=[9, 21], write=[1, 0]),
    dict(tables=[[1, 2], [1, 3], [4, 5]], kv_pos=[12, 8, 2], kv_len=[13, 9, 16],
         kv_sink=[0, 0, 2], pos=[12, 8, 30], write=[1, 1, 1]),
]


@pytest.mark.parametrize("kv", ["bf16", "e5m2"])
@pytest.mark.parametrize("case", range(len(ATT_CASES)))
def test_attend_step_paged_plain_matches_jax(kv, case):
    jdt, _ = KV[kv]
    c = ATT_CASES[case]
    tables = np.asarray(c["tables"], np.int32)
    B, nblk = tables.shape
    L, Hk, qpk, D, n_pages = 3, 2, 2, 128, int(tables.max()) + 1
    rng = np.random.default_rng(3 + case)
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hk, qpk, D), (B, Hk, D), (B, Hk, D)))
    k0, v0 = (np.asarray(jnp.asarray(rng.standard_normal((n_pages, L, PAGE, Hk, D)) * 0.3, jdt))
              for _ in range(2))
    scal = [c[k] for k in ("kv_pos", "kv_len", "kv_sink", "pos", "write")]
    kw = dict(kv_sinks=2, theta=1e4, rotary_dim=D, window=nblk * PAGE)
    want, jk, jv = jax_attend(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k0),
                              jnp.asarray(v0), jnp.asarray(tables), jnp.int32(1),
                              *[jnp.asarray(s, jnp.int32) for s in scal], **kw)
    pool = PagedKVPool.from_numpy(k0, v0)
    got = attend_step_paged_l(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
                              pool.k, pool.v, tables, 1, *scal, **kw)
    close(got, want, 2e-3)
    want_p = PagedKVPool.from_numpy(np.asarray(jk), np.asarray(jv))
    for t, w in ((pool.k, want_p.k), (pool.v, want_p.v)):
        np.testing.assert_array_equal(_bits(_pool_pages(t)), _bits(_pool_pages(w)))
    # page 0 is never written by the port
    assert torch.equal(pool.k[0], PagedKVPool.from_numpy(k0, v0).k[0])


def test_attend_step_paged_refuses_bad_tables():
    z = torch.zeros
    pool = z(5, 2, PAGE, 2, 128, dtype=torch.bfloat16)
    args = (z(2, 2, 2, 128), z(2, 2, 128), z(2, 2, 128), pool, pool.clone())
    sc = ([0, 3], [1, 4], [0, 0], [0, 3])
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=128)
    with pytest.raises(ValueError, match="page ids out of range"):
        attend_step_paged_l(*args, [[1, 2], [3, 5]], 0, *sc, window=32, **rope)
    with pytest.raises(ValueError, match="must be"):
        attend_step_paged_l(*args, [[1, 2, 3], [3, 4, 1]], 0, *sc, window=32, **rope)
    with pytest.raises(ValueError, match="does not divide"):
        attend_step_paged_l(*args, [[1, 2], [3, 4]], 0, *sc, window=40, **rope)
    # the softcap form runs and equals the JAX emulation's (tolerance 2e-3 of
    # max(1, max|ref|)), and the cap changes the output
    rng = np.random.default_rng(14)
    q = rng.standard_normal((2, 2, 2, 128), np.float32) * 4
    kn = rng.standard_normal((2, 2, 128), np.float32) * 4
    vn = rng.standard_normal((2, 2, 128), np.float32)
    p0 = rng.standard_normal((5, 2, PAGE, 2, 128), np.float32) * 4
    tab = [[1, 2], [3, 4]]
    outs = {}
    for cap in (0.0, 30.0):
        pools = [torch.from_numpy(p0).to(torch.bfloat16) for _ in range(2)]
        outs[cap] = attend_step_paged_l(torch.from_numpy(q), torch.from_numpy(kn),
                                        torch.from_numpy(vn), *pools, tab, 0, *sc, window=32,
                                        softcap=cap, **rope)
    want, _, _ = jax_attend(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                            jnp.asarray(p0, jnp.bfloat16), jnp.asarray(p0, jnp.bfloat16),
                            jnp.asarray(tab, jnp.int32), 0,
                            *(jnp.asarray(a, jnp.int32) for a in sc), window=32, softcap=30.0,
                            **rope)
    close(outs[30.0], want, 2e-3)
    assert not torch.allclose(outs[30.0], outs[0.0], atol=1e-2)


# ---------------------------------------------------------------- (c) the model

# (weights, pool, per-slot prefill logits mode, batched chunk logits modes)
MODEL_CASES = [("fp8", "bf16", "last", ("lastv", "none")), ("int4", "e5m2", "none", ("all",))]


@pytest.mark.parametrize("wdt,kv,prefill_mode,chunk_modes", MODEL_CASES)
def test_paged_prefill_chunk_and_ticks_match_jax(tmp_path, wdt, kv, prefill_mode, chunk_modes):
    """On pools that start random, through shuffled tables: a per-slot paged
    prefill chunk, batched paged chunk sweeps (a chunk straddling pages, a
    disabled lane), then ticks with a write-masked lane and a lane that
    crosses into the ring (window 32, pages of 16)."""
    kw = fast_kw(weight_dtype=wdt)
    jcfg, cfg = jax_tiny(**kw), tiny_config(**kw)
    path = str(tmp_path / "m.yalm")
    jax_synth(path, jcfg, seed=3)
    jw, tw = both_weights(path, jcfg)
    jdt, _ = KV[kv]
    rng = np.random.default_rng(9)
    B, T = 4, 16
    tables = np.asarray([[3, 7], [5, 1], [8, 2], [4, 6]], np.int32)
    shape = (9, cfg.n_layers, PAGE, cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = (np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.5, jdt)) for _ in range(2))
    jp = JaxPool(k=jnp.asarray(k0), v=jnp.asarray(v0))
    tp = PagedKVPool.from_numpy(k0, v0)

    # the per-slot chunk: lane 1's second page, 11 valid rows of 16
    toks = rng.integers(3, cfg.vocab_size, T).astype(np.int32)
    want, jp = jax_prefill(jcfg, jw, jnp.asarray(toks), jnp.int32(16), jnp.int32(11), jp,
                           jnp.asarray(tables[1]), jnp.int32(1), jnp.int32(0),
                           logits_mode=prefill_mode, page_size=PAGE)
    got, tp = prefill_fast_paged(cfg, tw, toks, 16, 11, tp, tables[1], 1, 0,
                                 logits_mode=prefill_mode, page_size=PAGE)
    assert (got is None) == (want is None)
    if got is not None:
        close(got, want)

    for mode in chunk_modes:
        toks = rng.integers(3, cfg.vocab_size, (B, T)).astype(np.int32)
        pos0, valid, enable = [0, 5, 16, 0], [16, 14, 9, 0], [1, 1, 1, 0]
        want, jp = jax_chunk(jcfg, jw, jnp.asarray(toks), jnp.asarray(pos0, jnp.int32),
                             jnp.asarray(valid, jnp.int32), jnp.asarray(enable, jnp.int32), jp,
                             jnp.asarray(tables), page_size=PAGE, logits_mode=mode)
        got, tp = prefill_chunk_fast_batched_paged(cfg, tw, toks, pos0, valid, enable, tp,
                                                   tables, page_size=PAGE, logits_mode=mode)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.shape == want.shape
            close(got[:3], np.asarray(want)[:3])

    positions = np.array([16, 19, 29, 6])
    write = np.array([1, 1, 1, 0])              # lane 3 attends read-only
    for _ in range(4):                           # lane 2 goes 29 -> 32: ring + sinks
        tok = rng.integers(3, cfg.vocab_size, B).astype(np.int32)
        want, jp = jax_tick(jcfg, jw, jnp.asarray(tok), jnp.asarray(positions, jnp.int32), jp,
                            jnp.asarray(tables), jnp.asarray(write, jnp.int32), page_size=PAGE)
        got, tp = decode_step_fast_batched_paged(cfg, tw, tok, positions, tp, tables, write,
                                                 page_size=PAGE)
        close(got, want)
        positions = positions + write
    wp = PagedKVPool.from_numpy(np.asarray(jp.k), np.asarray(jp.v))
    close(_pool_pages(tp.k).float(), _pool_pages(wp.k).float().numpy())
    close(_pool_pages(tp.v).float(), _pool_pages(wp.v).float().numpy())
    # lane 3 was disabled and read-only throughout: its pages are untouched
    start = PagedKVPool.from_numpy(k0, v0)
    assert torch.equal(tp.k[[4, 6]], start.k[[4, 6]]) and torch.equal(tp.v[[4, 6]], start.v[[4, 6]])


def test_paged_paths_refuse_bad_arguments():
    cfg = tiny_config(**fast_kw())
    from yalm_tpu_torch.models.fast import FastWeights
    fw = FastWeights(*(torch.zeros(1),) * 9)
    pool = PagedKVPool.init(cfg, torch.bfloat16, 5, PAGE, "cpu")
    with pytest.raises(ValueError, match="page_size"):
        decode_step_fast_batched_paged(cfg, fw, [1, 2], [0, 1], pool, [[1, 2], [3, 4]],
                                       page_size=8)
    with pytest.raises(ValueError, match="do not fit"):
        prefill_fast_paged(cfg, fw, np.zeros(16, np.int64), 8, 10, pool, [1, 2], 1, 8,
                           page_size=PAGE)
    with pytest.raises(ValueError, match="page ids out of range"):
        prefill_chunk_fast_batched_paged(cfg, fw, np.zeros((2, 16), np.int64), [0, 0], [1, 1],
                                         [1, 1], pool, [[1, 9], [3, 4]], page_size=PAGE)


# ---------------------------------------------------------------- (d) scheduler

def _reqs(R, n, max_new=6, seed0=0):
    return [R(prompt_tokens=[1, 5 + i, 9], max_new_tokens=max_new, temperature=0.0,
              seed=seed0 + i) for i in range(n)]


def _run(sched, reqs):
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [list(r.generated) for r in reqs]


RING_PROMPT = [1] + [5] * (32 + 9)
PREFIX = ([1] + [5, 9, 11] * 13)[: 2 * PAGE + 8]         # 2 full pages + a tail
_RNG = np.random.default_rng(0)
EVICT_PROMPTS = [[1] + _RNG.integers(3, 512, PAGE + 3).tolist() for _ in range(4)]


def sc_matches_dense(mk, R):
    """10 requests on 8 lanes with room for all; then a beyond-window prompt
    hydrated through the ring (masked-tick path)."""
    s = mk(32, 1 + 8 * 2)
    out = {"ten": _run(s, _reqs(R, 10))}
    out["ring"] = _run(s, [R(prompt_tokens=RING_PROMPT, max_new_tokens=5, temperature=0.0,
                             seed=3)])
    return out


def sc_pressure(mk, R):
    """3 usable pages for 8 lanes: requests wait and complete in waves;
    then two requests of 2 pages each run concurrently by lazy growth, and
    the newest is preempted and resumed when the pool runs dry."""
    s = mk(32, 4)
    reqs = _reqs(R, 8)
    for r in reqs:
        s.submit(r)
    s.step()
    out = {"after_step": (s.alloc.n_free, len(s.queue))}
    s.run()
    out.update(waves=[list(r.generated) for r in reqs], free_waves=s.alloc.n_free)
    reqs = _reqs(R, 2, max_new=20)
    for r in reqs:
        s.submit(r)
    s.step()
    out["concurrent"] = s.n_active
    preempted = False
    for _ in range(200):
        if not s.queue and s.n_active == 0:
            break
        s.step()
        preempted |= any(r._resume is not None or any(r is x for x in s.queue) for r in reqs)
    out.update(lazy=[list(r.generated) for r in reqs], preempted=preempted,
               free_end=s.alloc.n_free)
    return out


def sc_too_large(mk, R):
    """One usable page: a request whose worst case needs two fails at
    admission; the next one completes."""
    s = mk(32, 2)
    bad = R(prompt_tokens=[1] * 3, max_new_tokens=20, temperature=0.0)
    ok = R(prompt_tokens=[1, 5, 9], max_new_tokens=6, temperature=0.0)
    _run(s, [bad, ok])
    return {"bad": (bad.done, "pages" in (bad.error or ""), len(bad.generated)),
            "ok": (ok.done, ok.error, list(ok.generated))}


def sc_prefix(mk, R):
    """Prefix caching on a 64-slot window: the same prompt again maps the
    first's pages (bit-exact stream); two prompts sharing its pages with
    different tails; a request that may enter the ring (33 + 32 + 1 > 64
    slots) neither maps nor publishes pages."""
    s = mk(64, 1 + 8 * 4)
    out = {"r1": _run(s, [R(prompt_tokens=PREFIX, max_new_tokens=6, temperature=0.0, seed=3)])}
    out["st1"] = dict(s.prefix_stats)
    out["r2"] = _run(s, [R(prompt_tokens=PREFIX, max_new_tokens=6, temperature=0.0, seed=3)])
    out["st2"] = dict(s.prefix_stats)
    out["tails"] = _run(s, [R(prompt_tokens=PREFIX + t, max_new_tokens=4, temperature=0.0)
                            for t in ([7, 7, 7], [9, 2])])
    out["st3"] = dict(s.prefix_stats)
    out["ring"] = _run(s, [R(prompt_tokens=[1] + [5, 9] * PAGE, max_new_tokens=32,
                             temperature=0.0, seed=1)])
    out["st4"] = dict(s.prefix_stats)
    return out


def sc_evict(mk, R):
    """4 usable pages, prompts of 2 pages one after another: unreferenced
    cached pages are evicted (LRU) and the accounting stays exact."""
    s = mk(64, 1 + 4)
    out = {"streams": [_run(s, [R(prompt_tokens=p, max_new_tokens=4, temperature=0.0,
                                  seed=i)])[0] for i, p in enumerate(EVICT_PROMPTS)]}
    out.update(stats=dict(s.prefix_stats), n_free=s.alloc.n_free,
               refs=sorted(s.alloc.ref.values()))
    return out


def sc_rollback(mk, R):
    """The prefix match re-references the evictable page that admission's
    precheck counted: admission rolls back to the queue, and the request
    completes once pages free up."""
    s = mk(64, 1 + 3)
    p1 = [1] + [5, 9] * 9
    out = {"r1": _run(s, [R(prompt_tokens=p1, max_new_tokens=3, temperature=0.0)])}
    out["pages"] = (len(s.alloc.lru), len(s.alloc.free))
    r3 = s.submit(R(prompt_tokens=[1] + [7, 11] * 9, max_new_tokens=20, temperature=0.0,
                    seed=1))
    for _ in range(10):
        s.step()
        if s.n_active == 1 and not any(sl.admitting for sl in s.slots):
            break
    out["admitted"] = (len(s.queue), s.n_active, len(s.alloc.free))
    r1b = s.submit(R(prompt_tokens=p1, max_new_tokens=3, temperature=0.0))
    s.step()
    s.step()
    out["rolled_back"] = (r1b.done, r1b.error)
    s.run()
    out.update(r1b=list(r1b.generated), r3=list(r3.generated),
               refs=sorted(s.alloc.ref.values()))
    return out


SCENARIOS = {f.__name__[3:]: f for f in (sc_matches_dense, sc_pressure, sc_too_large,
                                         sc_prefix, sc_evict, sc_rollback)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """window -> (JAX cfg, JAX FastWeights, the port's cfg, the port's
    FastWeights): the window-32 and window-64 checkpoints of test_paged.py."""
    out = {}
    for window, seed in ((32, 41), (64, 121)):
        kw = fast_kw(max_seq_len=window)
        path = str(tmp_path_factory.mktemp("paged") / f"m{window}.yalm")
        jax_synth(path, jax_tiny(**kw), seed=seed)
        out[window] = (jax_tiny(**kw), *both_weights(path, jax_tiny(**kw)), tiny_config(**kw))
    return out


@pytest.fixture(scope="module")
def jax_results(models):
    """Every scenario on the JAX paged scheduler, once for the module."""
    def mk(window, pages):
        jcfg, jw, _, _ = models[window]
        return JaxScheduler(jcfg, jw, batch=8, fast=True, kv_dtype=jnp.bfloat16,
                            paged_pages=pages, page_size=PAGE)
    return {name: fn(mk, JaxRequest) for name, fn in SCENARIOS.items()}


def port_mk(models, **kw):
    def mk(window, pages):
        _, _, tw, cfg = models[window]
        return Scheduler(cfg, tw, batch=8, device="cpu", paged_pages=pages, page_size=PAGE,
                         **kw)
    return mk


def dense_streams(models, window, reqs):
    _, _, tw, cfg = models[window]
    return _run(Scheduler(cfg, tw, batch=8, device="cpu"), reqs)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_paged_scheduler_matches_jax(models, jax_results, name):
    got = SCENARIOS[name](port_mk(models), Request)
    assert got == jax_results[name]


def test_paged_streams_match_the_dense_scheduler(models):
    """Paged and dense schedulers give the same greedy streams: room for
    every lane, pool pressure with preemption, the ring regime, a request
    beside one that fails."""
    mk = port_mk(models)
    got = sc_matches_dense(mk, Request)
    assert got["ten"] == dense_streams(models, 32, _reqs(Request, 10))
    assert got["ring"] == dense_streams(models, 32, [Request(
        prompt_tokens=RING_PROMPT, max_new_tokens=5, temperature=0.0, seed=3)])
    pressure = sc_pressure(mk, Request)
    assert pressure["after_step"] == (0, 5) and pressure["free_waves"] == 3
    assert pressure["waves"] == got["ten"][:8]
    assert pressure["concurrent"] == 2 and pressure["preempted"] and pressure["free_end"] == 3
    assert pressure["lazy"] == dense_streams(models, 32, _reqs(Request, 2, max_new=20))
    too = sc_too_large(mk, Request)
    assert too["bad"] == (True, True, 0)
    assert too["ok"] == (True, None, dense_streams(models, 32, [Request(
        prompt_tokens=[1, 5, 9], max_new_tokens=6, temperature=0.0)])[0])


def test_paged_prefix_cache_behaviour(models):
    """The prefix cases' own rules: reuse is bit-exact and counted, shared
    tails equal a scheduler without a cache, the ring opt-out publishes
    nothing, eviction and rollback keep every count exact; preemption
    counts resumes."""
    mk = port_mk(models)
    pre = sc_prefix(mk, Request)
    assert pre["r2"] == pre["r1"]
    assert pre["st1"]["registered"] >= 2 and pre["st1"]["hits"] == 0
    assert pre["st2"]["hits"] == 1 and pre["st2"]["hit_tokens"] >= 2 * PAGE
    assert pre["st3"]["hits"] == 3
    assert pre["tails"] == _run(mk(64, 1 + 8 * 4), [
        Request(prompt_tokens=PREFIX + t, max_new_tokens=4, temperature=0.0)
        for t in ([7, 7, 7], [9, 2])])
    assert len(pre["ring"][0]) == 32
    assert {k: pre["st4"][k] - pre["st3"][k] for k in ("registered", "hits")} == \
        {"registered": 0, "hits": 0}
    ev = sc_evict(mk, Request)
    assert ev["stats"]["evicted"] >= 1 and ev["n_free"] == 4 and not any(ev["refs"])
    rb = sc_rollback(mk, Request)
    assert rb["pages"] == (1, 2) and rb["admitted"] == (0, 1, 0)
    assert rb["rolled_back"] == (False, None) and rb["r1b"] == rb["r1"][0]
    assert not any(rb["refs"])
    s = mk(32, 4)
    _run(s, _reqs(Request, 2, max_new=20))
    assert s.preemptions >= 1 and s.resumes == s.preemptions


def test_batched_admission_under_pressure_leaks_no_page(models):
    """Batched admission on a pool too small for its sweep: growing one
    lane's chunk preempts others in the same sweep, which must not be
    grown afterwards. Every request completes, and every page comes back
    (none stays mapped in a free slot's table)."""
    _, _, tw, cfg = models[64]
    s = Scheduler(cfg, tw, batch=8, device="cpu", paged_pages=5, page_size=PAGE,
                  batched_admission=True)
    rng = np.random.default_rng(7)
    reqs = [Request(prompt_tokens=[1] + rng.integers(3, 512, int(n)).tolist(), max_new_tokens=4,
                    temperature=0.0) for n in rng.integers(18, 40, 8)]
    _run(s, reqs)
    assert all(r.error is None and len(r.generated) == 4 for r in reqs)
    assert s.preemptions >= 1 and s.admit_sweeps >= 1
    assert s.alloc.n_free == 4 and not s.alloc.tables.any()


def test_paged_scheduler_rejects_bad_configs(models):
    _, _, tw, cfg = models[32]
    with pytest.raises(ValueError, match="divide"):
        Scheduler(cfg, tw, batch=8, device="cpu", paged_pages=8, page_size=7)


# ---------------------------------------------------------------- (e) recover

def test_paged_recover_keeps_the_queue(models):
    _, _, tw, cfg = models[32]
    solo = Request(prompt_tokens=[1, 5, 9], max_new_tokens=6, temperature=0.0)
    _run(Scheduler(cfg, tw, batch=1, device="cpu"), [solo])
    sched = Scheduler(cfg, tw, batch=2, device="cpu", paged_pages=5, page_size=PAGE)
    active = [sched.submit(Request(prompt_tokens=[1, 5 + i], max_new_tokens=64,
                                   temperature=0.0)) for i in range(2)]
    queued = sched.submit(Request(prompt_tokens=[1, 5, 9], max_new_tokens=6, temperature=0.0))
    sched.step()
    assert sched.n_active == 2 and sched.queue == [queued] and sched.alloc.n_free == 2
    old_pool = sched.cache
    sched.recover(RuntimeError("simulated device error"))
    assert all(r.done and "device error" in r.error for r in active)
    assert not queued.done and sched.queue == [queued]
    assert sched.cache is not old_pool and sched.alloc.n_free == 4
    assert not sched.alloc.tables.any()
    sched.run()
    assert queued.error is None and queued.generated == solo.generated
    assert sched.alloc.n_free == 4
