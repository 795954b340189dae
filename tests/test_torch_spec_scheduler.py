"""The port's scheduler speculation on the CPU (plain versions) against the
JAX package: the verify sweep (`verify_chunk_fast_batched[_paged]`) gives
JAX's logits, hidden rows and cache rows within 1e-2 of max(1, max|.|) and
a per-lane prefill's; `_verify_pack` keeps the JAX pack's greedy semantics
bit for bit and is exact in distribution (a chi-square test), with and
without a top-k/top-p envelope, its draws keyed by the request alone; the
draft, prompt-lookup and Medusa chains' greedy streams, dense and paged:
every token is the argmax of the port's plain decode path and of JAX's
chunked forward fed the same prefix, or a near-tie of it (its logit within
twice the 1e-2 tolerance of the row's maximum: two computations within the
tolerance of each other may part there; the verify rows come from the
chunk path, the plain ones from the step, tests/test_spec_scheduler.py:
83-92), and the free-running streams agree with the JAX speculative
scheduler's and the port's plain scheduler's on more than 80% of their
tokens before the first difference (JAX's own bar, tests/
test_spec_scheduler.py:112-123); a paged run that preempts inside spec
rounds equals the unpressured run exactly; top logprobs within 1e-2 of
JAX's; MoE self-draft and lookup on the paged cache.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.medusa import load_medusa_weights as jax_load_heads
from yalm_tpu.models.cache import KVCache as JaxCache
from yalm_tpu.models.fast import prefill_fast as jax_prefill
from yalm_tpu.models.fast import verify_chunk_fast_batched as jax_verify
from yalm_tpu.scheduler import Request as JaxRequest
from yalm_tpu.scheduler import Scheduler as JaxScheduler
from yalm_tpu.scheduler import _verify_pack as jax_verify_pack
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.engine import Engine
from yalm_tpu_torch.medusa import load_medusa_weights
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import (prefill_fast, verify_chunk_fast_batched,
                                        verify_chunk_fast_batched_paged)
from yalm_tpu_torch.models.paged import PagedKVPool
from yalm_tpu_torch.sampler import uniform_rows
from yalm_tpu_torch.scheduler import Request, Scheduler, _verify_pack
from yalm_tpu_torch.utils.testing import tiny_config

from test_torch_fast import _expected, both_weights, close, fast_kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PAGE = 16
MOE = dict(n_experts=4, n_experts_active=2)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Target (identity Medusa heads, which leave the model as it is), a
    1-layer draft and an MoE target, each as (JAX cfg, JAX weights, port
    cfg, port weights); the heads of both packages."""
    d = tmp_path_factory.mktemp("spec_sched")
    out = {}
    for name, kw, seed, heads in (("t", {}, 56, -4), ("d", dict(n_layers=1), 57, 0),
                                  ("moe", MOE, 58, 0)):
        path = str(d / f"{name}.yalm")
        jcfg = jax_tiny(**fast_kw(max_seq_len=64, **kw))
        jax_synth(path, jcfg, seed=seed, medusa_heads=heads)
        jw, tw = both_weights(path, jcfg)
        out[name] = (jcfg, jw, tiny_config(**fast_kw(max_seq_len=64, **kw)), tw)
        if heads:
            yf = jax_read(path, native=False)
            out["jax_heads"] = jax_load_heads(yf, jcfg)
            yf.close()
            yf = read_yalm(path)
            out["heads"] = load_medusa_weights(yf, out[name][2], "cpu")
            yf.close()
    return out


def reqs(R, n=10, **kw):
    return [R(prompt_tokens=[1, 5 + i, 9], max_new_tokens=n, temperature=0.0, **kw)
            for i in range(10)]


MODES = ("draft", "lookup", "medusa")


def spec_kw(models, mode, jax=False):
    m = 1 if jax else 3   # (cfg, weights) of the package
    if mode == "draft":
        return dict(spec_draft=(models["d"][m - 1], models["d"][m]))
    if mode == "lookup":
        return dict(spec_lookup=True)
    return dict(spec_medusa=models["jax_heads" if jax else "heads"])


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX speculative scheduler's greedy streams of reqs() per mode
    (batch 8, dense cache), top-3 logprobs."""
    jcfg, jw = models["t"][:2]
    out = {}
    for mode in MODES:
        s = JaxScheduler(jcfg, jw, batch=8, fast=True, kv_dtype=jnp.bfloat16, top_logprobs=3,
                         **spec_kw(models, mode, jax=True))
        rs = [s.submit(r) for r in reqs(JaxRequest)]
        s.run()
        out[mode] = rs
    return out


def run(cfg, w, requests, **kw):
    sched = Scheduler(cfg, w, device="cpu", **{"batch": 8, **kw})
    for r in requests:
        sched.submit(r)
    sched.run()
    return sched


@pytest.fixture(scope="module")
def plain(models):
    """The port's plain scheduler's greedy streams of reqs()."""
    _, _, cfg, tw = models["t"]
    rs = reqs(Request)
    run(cfg, tw, rs)
    return rs


def forced_hold(gen, rows) -> int:
    """Every token of a greedy stream against the logits rows that follow
    the same prefix: the token is the row's argmax, or its logit lies within
    twice the 1e-2 tolerance of the row's maximum (the logits here lie
    below 1). Returns the near-ties at which it is not the argmax."""
    rows = np.asarray(rows, np.float32)
    assert rows.shape[0] == len(gen)
    flips = 0
    for i, t in enumerate(gen):
        if int(rows[i].argmax()) != t:
            gap = float(rows[i].max() - rows[i][t])
            assert gap <= 2e-2 * max(1.0, float(np.abs(rows[i]).max())), (i, gen, gap)
            flips += 1
    return flips


def plain_rows(cfg, tw, prompt, gen):
    """The port's plain greedy path (Engine: the prompt's prefill, then one
    decode step a token) fed prompt + gen: the rows gen's tokens follow."""
    eng = Engine(cfg, tw, device="cpu")
    eng.prefill_tokens(prompt)
    rows = [eng._last_logits]
    for t in gen[:-1]:
        rows.append(eng._step(t))
    return torch.stack(rows).float().numpy()


def jax_rows(jcfg, jw, prompt, gen):
    """JAX's chunked forward (the verify sweep's formulation) over prompt +
    gen, from an empty cache: the rows gen's tokens follow."""
    seq = list(prompt) + list(gen[:-1])
    toks = np.zeros(16 * -(-len(seq) // 16), np.int32)
    toks[:len(seq)] = seq
    lg, _ = jax_prefill(jcfg, jw, jnp.asarray(toks), jnp.int32(0), jnp.int32(len(seq)),
                        JaxCache.init(jcfg, jnp.bfloat16), logits_mode="all")
    return np.asarray(lg, np.float32)[len(prompt) - 1: len(seq)]


def prefix_agreement(got, ref) -> int:
    """The tokens equal before the first difference."""
    assert len(got) == len(ref)
    n = 0
    while n < len(got) and got[n] == ref[n]:
        n += 1
    return n


def hold_streams(models, key, rs, jax_ref, plain_ref) -> dict:
    """forced_hold of every stream in rs against the port's plain path and
    JAX's chunked forward, and the free-running agreement with the JAX
    speculative scheduler's streams and the port's plain scheduler's (JAX's
    bar: more than 80% of the tokens before each stream's first
    difference). Returns the counts."""
    jcfg, jw, cfg, tw = models[key]
    c = dict(tokens=0, flips_plain=0, flips_jax=0, agree_jax=0, agree_plain=0)
    for r, j, p in zip(rs, jax_ref, plain_ref):
        c["tokens"] += len(r.generated)
        c["flips_plain"] += forced_hold(r.generated,
                                        plain_rows(cfg, tw, r.prompt_tokens, r.generated))
        c["flips_jax"] += forced_hold(r.generated,
                                      jax_rows(jcfg, jw, r.prompt_tokens, r.generated))
        c["agree_jax"] += prefix_agreement(r.generated, j.generated)
        c["agree_plain"] += prefix_agreement(r.generated, p.generated)
    assert c["agree_jax"] > 0.8 * c["tokens"] and c["agree_plain"] > 0.8 * c["tokens"], c
    return c


# ---------------------------------------------------------------------------
# the verify sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged,with_hidden", [(False, False), (False, True), (True, False),
                                               (True, True)])
def test_verify_chunk_matches_jax_and_per_lane_prefill(models, paged, with_hidden):
    """Lanes at pos0 (0, 5, 17, 30; the third disabled) after arbitrary
    histories: the sweep's rows equal JAX's and each lane's own
    prefill_fast(logits_mode="all"), the written cache rows likewise, and a
    disabled lane's cache is untouched. Paged: the same histories in a pool
    through shuffled tables."""
    jcfg, jw, cfg, tw = models["t"]
    B, T, L = 4, 5, cfg.max_seq_len
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, cfg.vocab_size, (B, T))
    pos0 = np.array([0, 5, 17, 30])
    enable = np.array([1, 1, 0, 1])
    hist = rng.integers(3, cfg.vocab_size, 32)
    dense = KVCache.init(cfg, torch.bfloat16, "cpu", batch=B)
    jlanes = []
    for b in range(B):
        jl = JaxCache.init(jcfg, jnp.bfloat16)
        if pos0[b]:
            prefill_fast(cfg, tw, hist, 0, int(pos0[b]), dense.lane(b), logits_mode="none")
            _, jl = jax_prefill(jcfg, jw, jnp.asarray(hist), jnp.int32(0), jnp.int32(pos0[b]),
                                jl, logits_mode="none")
        jlanes.append(jl)
    jcache = JaxCache(k=jnp.stack([x.k for x in jlanes]), v=jnp.stack([x.v for x in jlanes]))
    before = KVCache(k=dense.k.clone(), v=dense.v.clone())
    if paged:
        nblk = L // PAGE
        tables = (1 + np.random.default_rng(3).permutation(B * nblk)).reshape(B, nblk)
        pool = PagedKVPool.init(cfg, torch.bfloat16, 1 + B * nblk, PAGE, "cpu")
        for b in range(B):
            for j in range(nblk):
                pool.k[tables[b, j]] = dense.k[b, :, j * PAGE:(j + 1) * PAGE]
                pool.v[tables[b, j]] = dense.v[b, :, j * PAGE:(j + 1) * PAGE]
        out, _ = verify_chunk_fast_batched_paged(cfg, tw, tokens, pos0, enable, pool, tables,
                                                 page_size=PAGE, with_hidden=with_hidden)
        # the pool read back as each lane's window
        got_k = torch.stack([torch.cat([pool.k[tables[b, j]] for j in range(nblk)], dim=1)
                             for b in range(B)])
    else:
        out, _ = verify_chunk_fast_batched(cfg, tw, tokens, pos0, enable, dense,
                                           with_hidden=with_hidden)
        got_k = dense.k
    jout, jc2 = jax_verify(jcfg, jw, jnp.asarray(tokens, jnp.int32), jnp.asarray(pos0, jnp.int32),
                           jnp.asarray(enable, jnp.int32), jcache, with_hidden=with_hidden)
    logits, hidden = out if with_hidden else (out, None)
    jl, jh = jout if with_hidden else (jout, None)
    assert logits.shape == (B, T, cfg.vocab_size)
    for b in range(B):
        if not enable[b]:
            assert torch.equal(got_k[b], before.k[b])
            continue
        close(logits[b], np.asarray(jl)[b])
        if with_hidden:
            assert hidden.shape == (B, T, cfg.dim)
            close(hidden[b], np.asarray(jh)[b])
        lane = KVCache(k=before.k[b].clone(), v=before.v[b].clone())
        want, _ = prefill_fast(cfg, tw, tokens[b], int(pos0[b]), T, lane, logits_mode="all")
        close(logits[b], want.numpy())
        assert torch.equal(logits[b].argmax(-1), want.argmax(-1))
        rows = slice(int(pos0[b]), int(pos0[b]) + T)
        close(got_k[b][:, rows].float(), np.asarray(jc2.k[b][:, rows], np.float32))
        close(got_k[b][:, rows].float(), lane.k[:, rows].float().numpy())


# ---------------------------------------------------------------------------
# the verify pack
# ---------------------------------------------------------------------------

def _pack_args(B, K1, T, topk=0, topp=1.0, seeds=None):
    return (torch.as_tensor(np.arange(B) if seeds is None else seeds), torch.zeros(B, dtype=torch.long),
            torch.full((B,), T), torch.full((B,), topk), torch.full((B,), topp))


def test_verify_pack_greedy_lanes_match_jax():
    """Temperature-0 lanes: accept on argmax agreement, correction and bonus
    the argmax, bit for bit the JAX pack's; the logprob columns within
    1e-5."""
    rng = np.random.default_rng(3)
    B, K, V = 4, 4, 64
    lg = rng.standard_normal((B, K + 1, V)).astype(np.float32) * 3
    t = lg.argmax(-1)
    chunk = np.zeros((B, K + 1), np.int64)
    chunk[0, 1:] = t[0, :K]                 # every proposal agrees
    chunk[1, 1:] = (t[1, :K] + 1) % V       # none does
    chunk[2, 1:] = t[2, :K]
    chunk[2, 3] = (t[2, 2] + 5) % V         # the third does not
    chunk[3, 1:] = rng.integers(0, V, K)
    seeds, pos, temps, tk, tp = _pack_args(B, K + 1, 0.0)
    got = _verify_pack(torch.from_numpy(lg), torch.from_numpy(chunk), seeds, pos, temps, tk, tp,
                       topn=2).numpy()
    want = np.asarray(jax_verify_pack(jnp.asarray(lg), jnp.asarray(chunk, jnp.int32),
                                      jnp.asarray(seeds.numpy(), jnp.int32),
                                      jnp.asarray(pos.numpy(), jnp.int32),
                                      jnp.asarray(temps.numpy(), jnp.float32),
                                      jnp.asarray(tk.numpy(), jnp.int32),
                                      jnp.asarray(tp.numpy(), jnp.float32), topn=2))
    assert got.shape == want.shape == (B, K + 1, 10)
    for col in (0, 2, 4, 6, 7):             # flags and ids
        np.testing.assert_array_equal(got[..., col], want[..., col])
    np.testing.assert_allclose(got[..., [1, 3, 5, 8, 9]], want[..., [1, 3, 5, 8, 9]], atol=1e-5)
    assert (got[0, :K, 0] > 0.5).all() and (got[1, :K, 0] < 0.5).all()
    assert list(got[2, :K, 0] > 0.5) == [True, True, False, True]


@pytest.mark.parametrize("topk,topp,adversarial", [(0, 1.0, False), (0, 1.0, True),
                                                   (3, 1.0, False), (0, 0.8, False),
                                                   (4, 0.9, True)])
def test_verify_pack_exact_distribution(topk, topp, adversarial):
    """Sampled lanes: the first emitted token (the proposal if accepted, else
    the residual draw) is distributed as p_T within the request's envelope,
    whatever the point-mass proposal (here a likely token, or p's least
    likely one): 20000 lanes with the same logits and their own seeds, a
    chi-square test over the envelope (p-value > 1e-3), total variation
    below 0.02 and nothing outside the envelope."""
    rng = np.random.default_rng(7)
    V, K, T, n = 16, 2, 0.9, 20000
    row = rng.standard_normal(V).astype(np.float32) * 2
    p = _expected(row.astype(np.float64), T, topk, topp)
    lg = torch.from_numpy(np.broadcast_to(np.tile(row, (K + 1, 1)), (n, K + 1, V)).copy())
    prop = int(np.argmin(_expected(row.astype(np.float64), T, 0, 1.0))) if adversarial \
        else int(np.argsort(row)[-2])
    chunk = torch.full((n, K + 1), 3, dtype=torch.long)
    chunk[:, 1] = prop
    vp = _verify_pack(lg, chunk, *_pack_args(n, K + 1, T, topk, topp, seeds=np.arange(n) * 7 + 1))
    first = torch.where(vp[:, 0, 0] > 0.5, chunk[:, 1], vp[:, 0, 2].long()).numpy()
    counts = np.bincount(first, minlength=V)
    assert counts[p == 0].sum() == 0
    on = p > 0
    if on.sum() > 1:
        assert chisquare(counts[on], p[on] * n).pvalue > 1e-3
    assert 0.5 * np.abs(counts / n - p).sum() < 0.02


def test_verify_pack_draws_keyed_by_request():
    """A lane's accept flags and draws depend on its (seed, position) and
    logits alone: the same lane alone or among other lanes (at another
    index) gives the same columns; and the verify's three purposes never
    share the plain tick's stream at a position."""
    rng = np.random.default_rng(5)
    V, K1 = 32, 5
    lg = torch.from_numpy(rng.standard_normal((6, K1, V)).astype(np.float32))
    chunk = torch.from_numpy(rng.integers(0, V, (6, K1)))
    args = dict(seeds=torch.tensor([11, 3, 99, 7, 11, 5]), positions=torch.tensor([4, 9, 0, 4, 4, 2]),
                temps=torch.tensor([0.8, 1.0, 0.7, 0.8, 0.9, 0.0]),
                topks=torch.tensor([0, 5, 0, 0, 0, 0]), topps=torch.tensor([1.0, 1.0, 0.9, 1.0, 1.0, 1.0]))
    full = _verify_pack(lg, chunk, **args)
    alone = _verify_pack(lg[3:4], chunk[3:4], **{k: v[3:4] for k, v in args.items()})
    assert torch.equal(full[3], alone[0])
    plain = uniform_rows(torch.tensor([11]), torch.tensor([4]), V)
    for purpose in (1, 2, 3):
        u = uniform_rows(torch.tensor([11]), torch.tensor([4]), V, purpose)
        assert not torch.equal(u, plain)
        assert abs(float(np.corrcoef(u[0].numpy(), plain[0].numpy())[0, 1])) < 0.6


# ---------------------------------------------------------------------------
# the scheduler's streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_spec_streams_match_jax_and_plain(models, jax_streams, plain, mode, paged):
    _, _, cfg, tw = models["t"]
    rs = reqs(Request)
    kw = dict(paged_pages=1 + 8 * 4, page_size=PAGE) if paged else {}
    sched = run(cfg, tw, rs, top_logprobs=3, **spec_kw(models, mode), **kw)
    assert sched.spec_stats["rounds"] >= 1 and not sched.preemptions
    hold_streams(models, "t", rs, jax_streams[mode], plain)
    for r, j in zip(rs, jax_streams[mode]):
        # logprobs and top logprobs within 1e-2 of the JAX scheduler's
        # while the two streams share their prefix
        n = prefix_agreement(r.generated, j.generated)
        np.testing.assert_allclose(r.logprobs[:n], j.logprobs[:n], atol=1e-2)
        for mine, ref in zip(r.top_logprobs[:n], j.top_logprobs[:n]):
            np.testing.assert_allclose([lp for _, lp in mine], [lp for _, lp in ref], atol=1e-2)
            assert mine[0][0] == ref[0][0]
    if mode == "draft" and not paged:
        # scheduler and engine speculation verify on the same chunk path
        te = Engine(cfg, tw, device="cpu")
        d = Engine(*models["d"][2:], device="cpu")
        assert list(te.generate_speculative([1, 5, 9], draft=d, n_draft=4,
                                            max_steps=10)) == rs[0].generated


@pytest.mark.parametrize("mode", MODES)
def test_paged_spec_preempts_and_resumes_exactly(models, mode):
    """A pool of 9 pages of 16 (8 usable) for 8 lanes: growing a lane by the
    K+1 verify rows preempts the newest lane, which resumes its stream
    exactly (the proposal source re-hydrated): every stream equals the
    unpressured paged run's and the dense run's."""
    _, _, cfg, tw = models["t"]
    roomy, dense, rs = reqs(Request, n=16), reqs(Request, n=16), reqs(Request, n=16)
    run(cfg, tw, roomy, paged_pages=1 + 8 * 4, page_size=PAGE, **spec_kw(models, mode))
    run(cfg, tw, dense, **spec_kw(models, mode))
    sched = run(cfg, tw, rs, paged_pages=9, page_size=PAGE, **spec_kw(models, mode))
    assert sched.preemptions >= 1 and sched.resumes >= 1
    want = [r.generated for r in roomy]
    assert [r.generated for r in rs] == want == [r.generated for r in dense]
    assert sched.alloc.n_free == 8


@pytest.mark.parametrize("mode", ["draft", "lookup"])
def test_moe_spec_on_the_paged_cache(models, mode):
    """MoE target (the verify sweep on the all-expert FFN): self-draft and
    lookup on the paged cache held token by token to the port's plain path
    and JAX's chunked forward, and agreeing with the JAX speculative
    scheduler's streams on the dense cache and the port's plain MoE
    streams; the self-draft accepts nearly every proposal."""
    jcfg, jw, cfg, tw = models["moe"]
    kw = dict(spec_draft=(cfg, tw)) if mode == "draft" else dict(spec_lookup=True)
    jkw = dict(spec_draft=(jcfg, jw)) if mode == "draft" else dict(spec_lookup=True)
    rs = reqs(Request)[:4]
    sched = run(cfg, tw, rs, paged_pages=1 + 8 * 4, page_size=PAGE, **kw)
    js = JaxScheduler(jcfg, jw, batch=8, fast=True, kv_dtype=jnp.bfloat16, top_logprobs=2,
                      **jkw)
    want = [js.submit(r) for r in reqs(JaxRequest)[:4]]
    js.run()
    pl = reqs(Request)[:4]
    run(cfg, tw, pl)
    hold_streams(models, "moe", rs, want, pl)
    st = sched.spec_stats
    assert st["rounds"] >= 1
    if mode == "draft":
        assert st["accepted"] / st["proposed"] > 0.8, st


def test_sampled_spec_streams_keyed_by_request(models):
    """Sampled lookup and Medusa streams (T 0.8, top-p 0.9) run to full
    length, repeat for a seed, and a request's stream does not depend on
    its lane or its batch mates."""
    _, _, cfg, tw = models["t"]
    for kw in (dict(spec_lookup=True), dict(spec_medusa=models["heads"])):
        def one(n_mates, seed=4):
            mates = [Request(prompt_tokens=[1, 8 + i, 9, 8 + i], max_new_tokens=12,
                             temperature=0.8, top_p=0.9, seed=50 + i) for i in range(n_mates)]
            r = Request(prompt_tokens=[1, 5, 9, 5, 9], max_new_tokens=12, temperature=0.8,
                        top_p=0.9, seed=seed)
            sched = run(cfg, tw, mates + [r], **kw)
            assert all(len(m.generated) == 12 for m in mates) and len(r.generated) == 12
            assert all(np.isfinite(r.logprobs))
            return r.generated, sched
        alone, sched = one(0)
        assert sched.spec_stats["rounds"] >= 1
        assert one(0)[0] == alone and one(5)[0] == alone
        assert one(0, seed=5)[0] != alone


def test_spec_refusals(models):
    _, _, cfg, tw = models["t"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        Scheduler(cfg, tw, device="cpu", spec_lookup=True, spec_medusa=models["heads"])
    sched = Scheduler(cfg, tw, device="cpu", spec_lookup=True)
    with pytest.raises(ValueError, match="logit_bias"):
        sched.submit(Request(prompt_tokens=[1, 2], logit_bias={3: 1.0}))
    assert Scheduler(cfg, tw, device="cpu", spec_medusa=models["heads"], spec_k=9).spec_k == 4
    # tree-attention Medusa came with its slice: it starts, and a tree
    # deeper than the heads raises JAX's ValueError
    assert Scheduler(cfg, tw, device="cpu", spec_medusa=models["heads"],
                     spec_tree=(2, 2)).spec_tree == (2, 2)
    with pytest.raises(ValueError, match="medusa heads"):
        Scheduler(cfg, tw, device="cpu", spec_medusa=models["heads"], spec_tree=(2,) * 5)


@pytest.mark.parametrize("mode", MODES)
def test_server_over_spec_scheduler(models, mode):
    """The HTTP server on a speculative scheduler: a greedy completion runs
    its 8 tokens, a sampled one runs, and /metrics counts at least the
    rounds the scheduler alone takes for the greedy prompt."""
    import json
    import threading
    import urllib.request

    from yalm_tpu_torch import server as srv
    from yalm_tpu_torch.tokenizer import Tokenizer
    from yalm_tpu_torch.utils.testing import synth_vocab
    _, _, cfg, tw = models["t"]
    tok = Tokenizer(synth_vocab(cfg.vocab_size), cfg.bos_token_id, cfg.eos_token_id)
    engine = srv.ServingEngine(cfg, tw, tok, batch=4, device="cpu", **spec_kw(models, mode))
    httpd = srv.serve(engine, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(body):
        req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())
    try:
        out = post({"prompt": "hello world hello world", "max_tokens": 8, "temperature": 0.0})
        sampled = post({"prompt": "hello", "max_tokens": 6, "temperature": 0.8, "seed": 3})
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = dict(line.rsplit(" ", 1) for line in r.read().decode().splitlines()
                           if line and not line.startswith("#"))
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
    prompt = tok.encode("hello world hello world", bos=True)
    want = run(cfg, tw, [Request(prompt_tokens=prompt, max_new_tokens=8, temperature=0.0)],
               batch=4, **spec_kw(models, mode)).spec_stats
    # the sampled one may draw the end-of-stream token before its 6th
    assert out["usage"]["completion_tokens"] == 8
    assert 1 <= sampled["usage"]["completion_tokens"] <= 6
    assert float(metrics["yalm_spec_rounds_total"]) >= want["rounds"] >= 1
    assert {"yalm_spec_accepted_total", "yalm_spec_proposed_total"} <= set(metrics)
