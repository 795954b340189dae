"""Tree-attention Medusa in the port on the CPU (plain versions) against the
JAX package: `cartesian_tree` and `tree_depths` equal JAX's; the heads'
top-k candidates equal JAX's `medusa_propose_topk_rows` (ties by the lower
index first, as `lax.top_k`), column 0 the chain's proposal; the tree sweep
(`verify_tree_fast_batched`) gives JAX's logits, hidden rows and tree K/V
within 1e-2 of max(1, max|.|) (the whole-model tolerance of
tests/test_torch_fast.py) on dense, int4, MoE and Gemma2-form (sliding +
softcaps, e5m2 cache) checkpoints, and on the chain tree the chain sweep's
logits, with layer 0's rows bit for bit what the chain sweep writes;
`scatter_tree_rows` and the tree pack's greedy columns and walk equal
JAX's bit for bit; the scheduler scenarios of tests/test_medusa.py:268-407
(head independence, agreement with plain decode, a rank-2 candidate
advancing where the chain cannot, the refusals); the tree scheduler's
greedy streams held to the port's plain decode path token by token (the
argmax or a near-tie, tests/test_torch_spec_scheduler.py's rule) and to
JAX's tree scheduler on more than 80% of their tokens, its sampled streams
equal to the plain scheduler's; and HTTP through `--medusa-tree`.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.medusa import load_medusa_weights as jax_load_heads
from yalm_tpu.medusa import medusa_propose_topk_rows as jax_topk_rows
from yalm_tpu.models.cache import KVCache as JaxCache
from yalm_tpu.models.fast import cartesian_tree as jax_cartesian_tree
from yalm_tpu.models.fast import prefill_fast as jax_prefill
from yalm_tpu.models.fast import scatter_tree_rows as jax_scatter
from yalm_tpu.models.fast import tree_depths as jax_tree_depths
from yalm_tpu.models.fast import verify_tree_fast_batched as jax_verify_tree
from yalm_tpu.scheduler import Request as JaxRequest
from yalm_tpu.scheduler import Scheduler as JaxScheduler
from yalm_tpu.scheduler import _verify_pack_tree as jax_pack_tree
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch import server as srv
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.config import ModelConfig
from yalm_tpu_torch.medusa import (load_medusa_weights, medusa_propose_rows,
                                   medusa_propose_topk_rows, topk_stable)
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import (cartesian_tree, prefill_fast, scatter_tree_rows,
                                        tree_depths, verify_chunk_fast_batched,
                                        verify_tree_fast_batched)
from yalm_tpu_torch.scheduler import Request, Scheduler, _verify_pack_tree
from yalm_tpu_torch.utils.testing import tiny_config

from test_torch_fast import both_weights, close, fast_kw
from test_torch_spec_scheduler import forced_hold, plain_rows, prefix_agreement


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}
# the tree sweep's families: (config overrides, cache type)
FAMILIES = {
    "dense": ({}, "bf16"),
    "int4": (dict(weight_dtype="int4"), "bf16"),
    "moe": (dict(n_experts=4, n_experts_active=2), "bf16"),
    "gemma2": (dict(has_post_norms=True, attn_softcap=50.0, final_softcap=30.0,
                    sliding_window=16, layer_sliding=(1, 0), act_type="gelu"), "e5m2"),
}


def _kw(**over):
    return fast_kw(**{"max_seq_len": 64, **over})


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """Per family: (JAX cfg, JAX FastWeights, port cfg, port FastWeights)."""
    d = tmp_path_factory.mktemp("tree_families")
    out = {}
    for name, (over, _) in FAMILIES.items():
        path = str(d / f"{name}.yalm")
        jcfg = jax_tiny(**_kw(**over))
        jax_synth(path, jcfg, seed=61)
        jw, tw = both_weights(path, jcfg)
        out[name] = (jcfg, jw, tiny_config(**_kw(**over)), tw)
    return out


def _heads(path):
    """(JAX heads, port heads) of a checkpoint."""
    yf = jax_read(path, native=False)
    jmw = jax_load_heads(yf, jax_tiny(**_kw()))
    yf.close()
    yf = read_yalm(path)
    cfg = ModelConfig.from_metadata(yf.metadata)
    mw = load_medusa_weights(yf, cfg, "cpu")
    yf.close()
    return jmw, mw


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Checkpoints of tests/test_medusa.py's scenarios (seed 70, whose greedy
    stream repeats tokens, so identity heads get proposals accepted): random
    heads, identity heads; each as (path, JAX cfg, JAX weights, port cfg,
    port weights, JAX heads, port heads)."""
    d = tmp_path_factory.mktemp("tree_ckpts")
    out = {}
    for name, heads in (("rand", 4), ("ident", -4)):
        path = str(d / f"{name}.yalm")
        jcfg = jax_tiny(**fast_kw(max_seq_len=128))
        jax_synth(path, jcfg, seed=70, medusa_heads=heads)
        jw, tw = both_weights(path, jcfg)
        out[name] = (path, jcfg, jw, tiny_config(**fast_kw(max_seq_len=128)), tw) + _heads(path)
    return out


# ---------------------------------------------------------------------------
# the static tree and the candidates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branching", [(1,), (2,), (4, 2), (3, 2, 1), (1, 1, 1, 1), (2, 3)])
def test_cartesian_tree_and_depths_match_jax(branching):
    parents = cartesian_tree(branching)
    assert parents == jax_cartesian_tree(branching)
    assert tree_depths(parents) == jax_tree_depths(parents)
    assert len(parents) == 1 + sum(int(np.prod(branching[:i + 1])) for i in range(len(branching)))
    assert all(p < i for i, p in enumerate(parents))


@pytest.mark.parametrize("seed", range(3))
def test_topk_candidates_match_jax(ckpts, seed):
    """Every head's 3 best candidates equal JAX's, column 0 the chain's
    proposal (medusa_propose_rows)."""
    _, _, _, cfg, _, jmw, mw = ckpts["rand"]
    hidden = np.random.default_rng(seed).standard_normal((5, cfg.dim)).astype(np.float32) * 2
    got = medusa_propose_topk_rows(mw, torch.from_numpy(hidden), 3)
    want = np.asarray(jax_topk_rows(jmw, jnp.asarray(hidden), 3))
    assert got.shape == (5, 4, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got[..., 0], medusa_propose_rows(mw, torch.from_numpy(hidden)))


def test_topk_ties_order_like_lax_top_k():
    """Tied values: the lower index first, as jax.lax.top_k orders them."""
    x = np.random.default_rng(2).integers(0, 4, (6, 40)).astype(np.float32)
    vals, idx = topk_stable(torch.from_numpy(x), 7)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the tree sweep and the scatter
# ---------------------------------------------------------------------------

def _histories(fam, kv, B, pos0, seed=0):
    """The port's and JAX's batched caches with each lane's random history
    prefilled up to pos0[b] (fast prefill of both packages)."""
    jcfg, jw, cfg, tw = fam
    jdt, tdt = KV[kv]
    rng = np.random.default_rng(seed)
    hist = rng.integers(3, cfg.vocab_size, 48)
    dense = KVCache.init(cfg, tdt, "cpu", batch=B)
    jl = []
    for b in range(B):
        lane = JaxCache.init(jcfg, jdt)
        if pos0[b]:
            prefill_fast(cfg, tw, hist, 0, int(pos0[b]), dense.lane(b), logits_mode="none")
            _, lane = jax_prefill(jcfg, jw, jnp.asarray(hist), jnp.int32(0), jnp.int32(pos0[b]),
                                  lane, logits_mode="none")
        jl.append(lane)
    return dense, JaxCache(k=jnp.stack([x.k for x in jl]), v=jnp.stack([x.v for x in jl]))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_verify_tree_matches_jax(family, name):
    """A (2, 2) tree over 4 lanes at roots 0, 5, 17 and 30 (the third
    disabled): logits, hidden rows and tree K/V within the tolerance of
    JAX's, and the cache untouched (the sweep reads it only)."""
    jcfg, jw, cfg, tw = family[name]
    parents = cartesian_tree((2, 2))
    B, Tn = 4, len(parents)
    pos0 = np.array([0, 5, 17, 30])
    enable = np.array([1, 1, 0, 1])
    dense, jcache = _histories(family[name], FAMILIES[name][1], B, pos0)
    before = (dense.k.clone(), dense.v.clone())
    tokens = np.random.default_rng(1).integers(3, cfg.vocab_size, (B, Tn))
    (lg, hid), (kt, vt) = verify_tree_fast_batched(cfg, tw, tokens, pos0, enable, dense,
                                                   parents=parents, with_hidden=True)
    (jlg, jhid), (jkt, jvt) = jax_verify_tree(jcfg, jw, jnp.asarray(tokens, jnp.int32),
                                              jnp.asarray(pos0, jnp.int32),
                                              jnp.asarray(enable, jnp.int32), jcache,
                                              parents=parents, with_hidden=True)
    assert lg.shape == (B, Tn, cfg.vocab_size) and hid.shape == (B, Tn, cfg.dim)
    assert kt.shape == (B, cfg.n_layers, Tn, cfg.n_kv_heads, cfg.head_dim)
    assert kt.dtype == vt.dtype == dense.k.dtype
    assert torch.equal(dense.k, before[0]) and torch.equal(dense.v, before[1])
    for b in np.nonzero(enable)[0]:
        close(lg[b], np.asarray(jlg)[b])
        close(hid[b], np.asarray(jhid)[b])
        close(kt[b].float(), np.asarray(jkt[b], np.float32))
        close(vt[b].float(), np.asarray(jvt[b], np.float32))


@pytest.mark.parametrize("name", ["dense", "gemma2"])
def test_chain_tree_is_the_chain_sweep(family, name):
    """On the chain tree (1, 1, 1) the tree sweep is the verify chunk: its
    logits within the tolerance of verify_chunk_fast_batched's on the same
    tokens, and after scatter_tree_rows of the whole path layer 0's rows
    bit for bit what the chain sweep writes (later layers' rows, which
    regroup the f32 softmax, within the tolerance)."""
    _, _, cfg, tw = family[name]
    parents = cartesian_tree((1, 1, 1))
    B, T = 3, len(parents)
    pos0 = np.array([4, 11, 26])
    enable = np.ones(B, np.int64)
    tree_cache, _ = _histories(family[name], FAMILIES[name][1], B, pos0, seed=5)
    chain_cache = KVCache(k=tree_cache.k.clone(), v=tree_cache.v.clone())
    tokens = np.random.default_rng(6).integers(3, cfg.vocab_size, (B, T))
    lg, (kt, vt) = verify_tree_fast_batched(cfg, tw, tokens, pos0, enable, tree_cache,
                                            parents=parents)
    want, _ = verify_chunk_fast_batched(cfg, tw, tokens, pos0, enable, chain_cache)
    close(lg, want.numpy())
    scatter_tree_rows(tree_cache, kt, vt, pos0, np.tile(np.arange(T), (B, 1)), np.full(B, T))
    for b in range(B):
        rows = slice(int(pos0[b]), int(pos0[b]) + T)
        for got, ref in ((tree_cache.k, chain_cache.k), (tree_cache.v, chain_cache.v)):
            assert torch.equal(got[b, 0, rows], ref[b, 0, rows])
            close(got[b, :, rows].float(), ref[b, :, rows].float().numpy())
    assert torch.equal(tree_cache.k[:, :, :4], chain_cache.k[:, :, :4])


def test_scatter_tree_rows_matches_jax_bit_for_bit():
    """Random tree rows into a random bf16 cache: lanes of 3, 1 and 0 rows
    (a lane with n 0 changes nothing), equal to JAX's scatter bit for bit."""
    rng = np.random.default_rng(9)
    B, L, S, Tn, Hk, D = 3, 2, 24, 7, 2, 16
    cache = rng.standard_normal((B, L, S, Hk, D)).astype(np.float32)
    tree = rng.standard_normal((2, B, L, Tn, Hk, D)).astype(np.float32)
    pos0, rows, n = np.array([3, 10, 20]), np.array([[0, 2, 5], [0, 1, 3], [0, 2, 6]]), \
        np.array([3, 1, 0])
    tc = KVCache(k=torch.from_numpy(cache).bfloat16(), v=torch.from_numpy(-cache).bfloat16())
    kt, vt = (torch.from_numpy(t).bfloat16() for t in tree)
    before = tc.k.clone()
    scatter_tree_rows(tc, kt, vt, pos0, rows, n)
    jc = jax_scatter(JaxCache(k=jnp.asarray(cache, jnp.bfloat16),
                              v=jnp.asarray(-cache, jnp.bfloat16)),
                     jnp.asarray(tree[0], jnp.bfloat16), jnp.asarray(tree[1], jnp.bfloat16),
                     jnp.asarray(pos0, jnp.int32), jnp.asarray(rows, jnp.int32),
                     jnp.asarray(n, jnp.int32), n_rows=3)
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    assert torch.equal(tc.k[2], before[2])
    assert torch.equal(tc.k[0, :, 4], kt[0, :, 2])


def test_verify_pack_tree_matches_jax(ckpts):
    """The tree pack on a (2, 2) tree over 4 lanes: a lane whose candidates
    follow the argmax chain to full depth (through second-ranked children),
    one that matches at the first level only, one that matches nowhere and
    one not live (a root-only round). The argmax ids, the walk's final node
    and the next round's candidates equal JAX's bit for bit, the logprob
    columns within 1e-5."""
    _, _, _, cfg, _, jmw, mw = ckpts["rand"]
    parents = cartesian_tree((2, 2))
    B, Tn, V = 4, len(parents), cfg.vocab_size
    rng = np.random.default_rng(4)
    lg = rng.standard_normal((B, Tn, V)).astype(np.float32) * 3
    arg = lg.argmax(-1)
    chunk = rng.integers(3, V, (B, Tn))
    # node order: 0 root, 1-2 depth 1, 3-4 children of 1, 5-6 children of 2
    chunk[0, 2] = arg[0, 0]          # the root's argmax at the second child
    chunk[0, 6] = arg[0, 2]          # and its argmax at that child's second child
    chunk[1, 1] = arg[1, 0]          # level 1 only
    chunk[1, 3:5] = (arg[1, 1] + 1) % V
    for b in (2, 3):
        chunk[b, 1:3] = (arg[b, 0] + 1 + np.arange(2)) % V
    live = np.array([1, 1, 1, 0])
    hidden = rng.standard_normal((B, Tn, cfg.dim)).astype(np.float32)
    got = _verify_pack_tree(torch.from_numpy(lg), torch.from_numpy(chunk),
                            torch.from_numpy(live), torch.from_numpy(hidden), mw,
                            parents=parents, kmax=2, topn=2).numpy()
    want = np.asarray(jax_pack_tree(jnp.asarray(lg), jnp.asarray(chunk, jnp.int32),
                                    jnp.asarray(live, jnp.int32), jnp.asarray(hidden), jmw,
                                    parents=parents, kmax=2, topn=2))
    assert got.shape == want.shape == (B, Tn, 3 + 4 + 1 + 4 * 2)
    exact = [0, 3, 4, 7] + list(range(8, got.shape[-1]))
    np.testing.assert_array_equal(got[..., exact], want[..., exact])
    np.testing.assert_allclose(got[..., [1, 2, 5, 6]], want[..., [1, 2, 5, 6]], atol=1e-5)
    assert list(got[:, 0, 7]) == [6, 1, 0, 0]


# ---------------------------------------------------------------------------
# the scheduler (tests/test_medusa.py:268-407) and the server
# ---------------------------------------------------------------------------

def _sched(ck, **kw):
    _, _, _, cfg, tw, _, mw = ck
    return Scheduler(cfg, tw, device="cpu", batch=8, spec_medusa=mw, **kw)


def _run(sched, reqs):
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [list(r.generated) for r in reqs]


def _reqs(R, n, k=3, **kw):
    return [R(prompt_tokens=[1, 7, 42], max_new_tokens=n, temperature=0.0, seed=i, **kw)
            for i in range(k)]


def test_tree_head_independence(ckpts):
    """Random heads and identity heads give the target's greedy stream up to
    path near-ties: the streams agree on more than 70% of their tokens
    before the first difference (JAX's bar), both complete, and the
    identity heads get candidates accepted."""
    streams, stats = {}, {}
    for name in ("rand", "ident"):
        sched = _sched(ckpts[name], spec_tree=(3, 2))
        assert sched.spec_tree == (3, 2)
        streams[name] = _run(sched, _reqs(Request, 24))
        stats[name] = dict(sched.spec_stats)
    agree = sum(prefix_agreement(a, b) for a, b in zip(streams["rand"], streams["ident"]))
    assert all(len(s) == 24 for s in streams["rand"] + streams["ident"])
    assert agree > 0.7 * 72, (agree, streams)
    assert stats["rand"]["rounds"] >= 1 and stats["ident"]["accepted"] >= 1, stats


@pytest.fixture(scope="module")
def tree_streams(ckpts):
    """The port's and JAX's tree schedulers (identity heads, tree (3, 2),
    top-2 logprobs) on three greedy requests of 20 tokens and two sampled
    ones at T 0.8; and the port's plain scheduler on the same requests."""
    path, jcfg, jw, cfg, tw, jmw, mw = ckpts["ident"]

    def mix(R):
        return _reqs(R, 20) + [R(prompt_tokens=[1, 9, 40], max_new_tokens=20, temperature=0.8,
                                 top_p=0.9, seed=30 + i) for i in range(2)]
    port = _sched(ckpts["ident"], spec_tree=(3, 2), top_logprobs=2)
    js = JaxScheduler(jcfg, jw, batch=8, fast=True, kv_dtype=jnp.bfloat16, top_logprobs=2,
                      spec_medusa=jmw, spec_tree=(3, 2))
    plain = Scheduler(cfg, tw, device="cpu", batch=8, top_logprobs=2)
    out = {}
    for name, s, R in (("port", port, Request), ("jax", js, JaxRequest),
                       ("plain", plain, Request)):
        rs = mix(R)
        _run(s, rs)
        out[name] = (rs, dict(s.spec_stats) if name != "plain" else None)
    return out


def test_tree_streams_hold_to_plain_decode_and_jax(ckpts, tree_streams):
    """Every greedy token of the tree scheduler is the port's plain decode
    path's argmax fed the same prefix, or a near-tie of it; the streams
    agree with JAX's tree scheduler's and the plain scheduler's on more
    than 80% and 70% of their tokens before the first difference, the
    logprobs and top-2 within 1e-2 of JAX's while the prefixes agree; every
    request completes with finite logprobs; the sampled streams, which ride
    the plain tick, equal the plain scheduler's exactly."""
    _, _, _, cfg, tw, _, _ = ckpts["ident"]
    rs, st = tree_streams["port"]
    js, jst = tree_streams["jax"]
    ps, _ = tree_streams["plain"]
    assert st["rounds"] >= 1 and st["accepted"] >= 1 and jst["rounds"] >= 1
    greedy = [i for i, r in enumerate(rs) if r.temperature == 0.0]
    total = 20 * len(greedy)
    agree_jax = agree_plain = 0
    for i in greedy:
        r = rs[i]
        assert len(r.generated) == 20 and np.isfinite(r.logprobs).all()
        assert all(len(t) == 2 for t in r.top_logprobs)
        forced_hold(r.generated, plain_rows(cfg, tw, r.prompt_tokens, r.generated))
        n = prefix_agreement(r.generated, js[i].generated)
        agree_jax += n
        agree_plain += prefix_agreement(r.generated, ps[i].generated)
        np.testing.assert_allclose(r.logprobs[:n], js[i].logprobs[:n], atol=1e-2)
        for mine, ref in zip(r.top_logprobs[:n], js[i].top_logprobs[:n]):
            assert mine[0][0] == ref[0][0]
            np.testing.assert_allclose([lp for _, lp in mine], [lp for _, lp in ref], atol=1e-2)
    assert agree_jax > 0.8 * total and agree_plain > 0.7 * total, (agree_jax, agree_plain)
    for i, r in enumerate(rs):
        if r.temperature > 0:
            assert r.generated == ps[i].generated and len(r.generated) == 20


def test_tree_beats_chain_on_rank2_candidates(ckpts):
    """When the right token is the heads' SECOND choice, a k=2 tree still
    advances while the linear chain rejects every round: candidates are
    injected after each round, rank 1 wrong and rank 2 the next token of
    the reference stream. Both emit that stream exactly; the tree accepts
    more in fewer rounds."""
    ck = ckpts["ident"]
    V = ck[3].vocab_size
    r0 = Request(prompt_tokens=[1, 7, 42], max_new_tokens=16, temperature=0.0)
    stream = _run(_sched(ck, spec_tree=(2,)), [r0])[0]

    def drive(sched, bank):
        r = sched.submit(Request(prompt_tokens=[1, 7, 42], max_new_tokens=16, temperature=0.0))
        while sched.queue or sched.n_active:
            sched.step()
            for s in sched.slots:
                if s.request is r and s.med_props:
                    n = len(r.generated)
                    if 0 < n < len(stream):
                        s.med_props = bank(stream[n])
        return list(r.generated), dict(sched.spec_stats)

    got_t, st_t = drive(_sched(ck, spec_tree=(2,)), lambda right: [[(right + 1) % V, right]])
    got_c, st_c = drive(_sched(ck, spec_k=1), lambda right: [(right + 1) % V])
    assert got_t == stream and got_c == stream
    assert st_t["accepted"] > st_c["accepted"] and st_t["rounds"] < st_c["rounds"], (st_t, st_c)


def test_tree_refusals_are_jax_s(ckpts):
    _, _, _, cfg, tw, _, mw = ckpts["rand"]
    with pytest.raises(ValueError, match="spec_medusa"):
        Scheduler(cfg, tw, device="cpu", spec_tree=(2, 2))
    with pytest.raises(ValueError, match="heads"):
        Scheduler(cfg, tw, device="cpu", spec_medusa=mw, spec_tree=(2, 2, 2, 2, 2))
    with pytest.raises(ValueError, match="dense single-device"):
        Scheduler(cfg, tw, device="cpu", spec_medusa=mw, spec_tree=(2,), paged_pages=16,
                  page_size=16)
    with pytest.raises(ValueError, match="dense single-device"):
        Scheduler(cfg, tw, device="cpu", spec_medusa=mw, spec_tree=(2,), mesh=object())
    with pytest.raises(ValueError, match=">= 1"):
        Scheduler(cfg, tw, device="cpu", spec_medusa=mw, spec_tree=(2, 0))


def test_http_through_medusa_tree(ckpts, monkeypatch, capsys):
    """`python -m yalm_tpu_torch.server ... --medusa-tree 2,2` serves over
    HTTP: a greedy completion runs its 8 tokens, a sampled one runs, and
    /metrics counts the tree's rounds."""
    path = ckpts["ident"][0]
    results = {}

    def serve(engine, host, port):
        httpd = srv.ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(engine))
        real = httpd.serve_forever

        def drive():
            threading.Thread(target=real, daemon=True).start()
            base = f"http://127.0.0.1:{httpd.server_address[1]}"

            def post(body):
                req = urllib.request.Request(base + "/v1/completions",
                                             data=json.dumps(body).encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    return json.loads(r.read())
            try:
                results["greedy"] = post({"prompt": "hello world hello world", "max_tokens": 8,
                                          "temperature": 0.0})
                results["sampled"] = post({"prompt": "hello", "max_tokens": 6,
                                           "temperature": 0.8, "seed": 3})
                with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                    results["metrics"] = dict(
                        line.rsplit(" ", 1) for line in r.read().decode().splitlines()
                        if line and not line.startswith("#"))
                results["sched"] = engine.sched
            finally:
                httpd.shutdown()
            raise KeyboardInterrupt
        httpd.serve_forever = drive
        return httpd
    monkeypatch.setattr(srv, "serve", serve)
    srv.main([path, "--device", "cpu", "--port", "0", "--batch", "4", "--medusa-tree", "2,2"])
    assert "spec=medusa tree (2, 2)" in capsys.readouterr().out
    sched = results["sched"]
    assert sched.spec_tree == (2, 2) and sched.fast
    assert results["greedy"]["usage"]["completion_tokens"] == 8
    assert 1 <= results["sampled"]["usage"]["completion_tokens"] <= 6
    assert float(results["metrics"]["yalm_spec_rounds_total"]) >= 1
