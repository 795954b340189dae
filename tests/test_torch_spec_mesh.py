"""Scheduler speculation on a mesh, in spawned gloo ranks on the CPU: the
port's make_verify_chunk_fast_tp and make_verify_chunk_paged_fast_tp
(with the hidden rows Medusa's heads read) against the JAX package's on
the virtual mesh (conftest), fp8 weights over a bf16 cache and int4
weights over an e5m2 cache, at tp=2 and at dp=2 x tp=2 (every row's
argmax equal and its logits within 1e-2 of max(1, max|logit|), the rule
of tests/test_torch_fast_tp.py; the hidden rows within the same
tolerance; the rows written into every rank's cache or pool shard by
the rule tests/test_torch_spec_scheduler.py holds the single-device
sweep's rows to, rows_held); the scheduler's
streams as JAX's tests hold JAX's: a draft on the mesh gives the plain
mesh's streams (tests/test_scheduler_mesh.py:173), a self-draft accepts
more than 0.7 of what it proposes (:202), lookup x paged x dp2 x tp2 and
lookup on a dp2 x tp2 mesh give the single device's streams
(tests/test_spec_paged.py:176, :203), chain Medusa at tp=2 gives the plain
mesh's; the server with --mesh 1,1,2 and --spec-lookup or --draft answers
as the single-device server does; a draft whose shards do not fit is
refused with JAX's ValueError.

One world of 2 ranks and one of 4 serve the whole module, started before
the JAX references are computed so the two overlap."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paged_mesh import (B, CONFIGS, NBLK, PAGE, _held, _joined, _shard, _spawn, kw,
                                   n_pages_for, tables_for)
from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.models import KVCache as JaxCache
from yalm_tpu.models.fast import load_fast_weights as jax_load_fast
from yalm_tpu.models.paged import PagedKVPool as JaxPool
from yalm_tpu.parallel.fast_tp import (make_verify_chunk_fast_tp, make_verify_chunk_paged_fast_tp,
                                       shard_fast_tp_weights, shard_paged_pool)
from yalm_tpu.parallel.mesh import MeshConfig, make_mesh
from yalm_tpu.parallel.sharding import shard_cache
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.config import ModelConfig
from yalm_tpu_torch.models.fast import load_fast_weights
from yalm_tpu_torch.parallel.mesh import MeshConfig as PortMeshConfig
from yalm_tpu_torch.parallel.mesh import grid_mesh
from yalm_tpu_torch.scheduler import Request, Scheduler
from yalm_tpu_torch.server import ServingEngine, load_draft
from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config

T = 4
SWEEPS = 7


def sweeps():
    """(tokens (B, T), pos0, enable) of each sweep: a lane is disabled when
    (lane + sweep) % 5 == 0, and an enabled lane moves on by 1..T rows as if
    that many were accepted, so later sweeps overwrite rejected rows and
    chunks straddle pages."""
    out = []
    length = np.zeros(B, np.int64)
    for s in range(SWEEPS):
        toks = ((np.arange(B * T).reshape(B, T) * 13 + s * 7) % 500 + 3)
        en = ((np.arange(B) + s) % 5 != 0).astype(np.int64)
        out.append((toks.tolist(), length.tolist(), en.tolist()))
        length = length + en * ((np.arange(B) + s) % T + 1)
    return out


def verify_case(path, mesh, kv, paged):
    case = dict(op="verify", path=path, mesh=mesh, kv=kv, sweeps=sweeps())
    if paged:
        case.update(tables=tables_for(mesh[0]).tolist(), n_pages=n_pages_for(mesh[0]),
                    page_size=PAGE)
    return case


def _jax_verify(path, mesh_shape, cfg, kv, paged):
    dp, _, tp = mesh_shape
    mesh = make_mesh(MeshConfig(dp=dp, tp=tp), devices=jax.devices()[:dp * tp])
    sw = shard_fast_tp_weights(jax_load_fast(jax_read(path, native=False), cfg, tp=tp), cfg,
                               mesh)
    ws = getattr(sw, "scales", None) is not None
    kvd = {"bf16": jnp.bfloat16, "fp8": jnp.float8_e5m2}[kv]
    if paged:
        cache = shard_paged_pool(JaxPool.init(cfg, kvd, n_pages_for(dp), PAGE), mesh)
        fn = jax.jit(make_verify_chunk_paged_fast_tp(cfg, mesh, PAGE, with_scales=ws,
                                                     with_hidden=True))
        tables = jnp.asarray(tables_for(dp), jnp.int32)
    else:
        cache = shard_cache(JaxCache.init(cfg, kvd, batch=B), cfg, mesh, batched=True)
        fn = jax.jit(make_verify_chunk_fast_tp(cfg, mesh, with_scales=ws, with_hidden=True))
    logits, hidden = [], []
    for toks, pos0, en in sweeps():
        args = (sw, jnp.asarray(toks, jnp.int32), jnp.asarray(pos0, jnp.int32),
                jnp.asarray(en, jnp.int32), cache) + ((tables,) if paged else ())
        (lg, h), cache = fn(*args)
        logits.append(np.asarray(lg))
        hidden.append(np.asarray(h))
    return {"logits": np.stack(logits), "hidden": np.stack(hidden), "k": np.asarray(cache.k),
            "v": np.asarray(cache.v)}


def _reqs(n, seed0=0):
    """tests/test_scheduler_mesh.py:26's requests."""
    return [dict(prompt_tokens=[1, 5 + i, 9], max_new_tokens=6, temperature=0.0, seed=seed0 + i)
            for i in range(n)]


def _lookup_reqs(n):
    """tests/test_spec_paged.py:95's: repeating prompts lookup can match."""
    return [dict(prompt_tokens=[1, 5 + i, 9, 5 + i, 9], max_new_tokens=10, temperature=0.0,
                 seed=i) for i in range(n)]


SELF_REQS = [dict(prompt_tokens=[1, 5 + i, 9], max_new_tokens=12, temperature=0.0, seed=i)
             for i in range(4)]
PROMPT = "hello world"


def single_report(path, reqs, batch=8, **kw2):
    """The port's single-device scheduler: streams and speculation counts."""
    yf = read_yalm(path)
    cfg = ModelConfig.from_metadata(yf.metadata)
    sched = Scheduler(cfg, load_fast_weights(yf, cfg, "cpu"), batch=batch, device="cpu", **kw2)
    yf.close()
    rs = [Request(**r) for r in reqs]
    for r in rs:
        sched.submit(r)
    sched.run()
    return [r.generated for r in rs], sched.spec_stats


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec_mesh")
    p = {name: str(d / f"{name}.yalm") for name in CONFIGS}
    for name, (over, _) in CONFIGS.items():
        synth_checkpoint(p[name], tiny_config(**over), seed=61)
    cfg = tiny_config(**kw())
    for name, seed, c, heads in (("t31", 31, cfg, 0), ("d32", 32, dataclasses.replace(
            cfg, n_layers=1), 0), ("t33", 33, cfg, 0), ("t86", 86, cfg, 0),
            ("t87", 87, cfg, 0), ("med", 41, cfg, -3)):
        p[name] = str(d / f"{name}.yalm")
        synth_checkpoint(p[name], c, seed=seed, medusa_heads=heads)
    paged = dict(paged_pages=2 * (1 + 4 * NBLK), page_size=PAGE)
    sched = dict(op="scheduler", batch=8, report=True)
    two = [verify_case(p[n], (1, 1, 2), kv, pg) for n, (_, kv) in CONFIGS.items()
           for pg in (False, True)]
    two += [dict(sched, path=p["med"], mesh=(1, 1, 2), requests=_lookup_reqs(8)),
            dict(sched, path=p["med"], mesh=(1, 1, 2), requests=_lookup_reqs(8), medusa=True,
                 spec_k=3),
            dict(op="server", path=p["t87"], mesh=(1, 1, 2), prompt=PROMPT, max_tokens=8,
                 engine=dict(spec_lookup=True, spec_k=3)),
            dict(op="server", path=p["t31"], mesh=(1, 1, 2), prompt=PROMPT, max_tokens=8,
                 engine=dict(draft=p["d32"], spec_k=3))]
    four = [verify_case(p[n], (2, 1, 2), kv, pg) for n, (_, kv) in CONFIGS.items()
            for pg in (False, True)]
    four += [dict(sched, path=p["t31"], mesh=(2, 1, 2), requests=_reqs(6)),
             dict(sched, path=p["t31"], mesh=(2, 1, 2), requests=_reqs(6), draft=p["d32"],
                  spec_k=3),
             dict(sched, path=p["t33"], mesh=(2, 1, 2), requests=SELF_REQS, draft=p["t33"],
                  spec_k=3),
             dict(sched, path=p["t86"], mesh=(2, 1, 2), requests=_lookup_reqs(10),
                  spec_lookup=True, spec_k=3, **paged),
             dict(sched, path=p["t87"], mesh=(2, 1, 2), requests=_lookup_reqs(10),
                  spec_lookup=True, spec_k=3)]
    b2, b4 = {}, {}
    t2 = _spawn(2, two, d / "w2", b2)
    t4 = _spawn(4, four, d / "w4", b4)
    ref = {}
    for name, (over, kv) in CONFIGS.items():
        jcfg = jax_tiny(**over)
        for world, shape in ((2, (1, 1, 2)), (4, (2, 1, 2))):
            for pg in (False, True):
                ref[name, world, pg] = _jax_verify(p[name], shape, jcfg, kv, pg)
    return {"paths": p, 2: _joined(t2, b2), 4: _joined(t4, b4), "ref": ref}


def rows_held(got: np.ndarray, want: np.ndarray, kv: str, what) -> None:
    """Every written (lane or page, layer, slot) row of a cache shard within
    1e-2 of max(1, max|row|) of JAX's: the rule the single-device verify
    sweep's rows are held to (tests/test_torch_spec_scheduler.py). The
    bytes are not held: on one device already the port's and JAX's sweeps
    part by a bf16 rounding of the chunk attention at a few rows (on this
    test's checkpoint 46 k and 55 v elements of 3 rows of the bf16 cache,
    none on e5m2), which the mesh inherits unchanged."""
    dt = torch.bfloat16 if kv == "bf16" else torch.float8_e5m2
    a = torch.from_numpy(got.copy()).view(dt).float().numpy()
    b = torch.from_numpy(want.view(got.dtype).copy()).view(dt).float().numpy()
    a, b = a.reshape(-1, a.shape[-2] * a.shape[-1]), b.reshape(-1, b.shape[-2] * b.shape[-1])
    tol = 1e-2 * np.maximum(1.0, np.abs(b).max(axis=1))
    assert (np.abs(a - b).max(axis=1) <= tol).all(), what


def _hidden_held(got, want, what):
    """The hidden rows: within 1e-2 of max(1, max|row|) (the logits' rule
    without an argmax)."""
    got = np.asarray(got, np.float32).reshape(-1, want.shape[-1])
    want = np.asarray(want, np.float32).reshape(-1, want.shape[-1])
    for i in range(want.shape[0]):
        tol = 1e-2 * max(1.0, float(np.abs(want[i]).max()))
        assert float(np.abs(got[i] - want[i]).max()) <= tol, (what, i)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("world", [2, 4], ids=["tp2", "dp2xtp2"])
@pytest.mark.parametrize("name", ["fp8", "int4"], ids=["fp8_bf16", "int4_e5m2"])
def test_verify_factories_match_jax(runs, name, world, paged):
    """Seven verify sweeps of 4 rows over 8 lanes (disabled lanes, rows
    overwritten after a rejection, chunks across a page boundary): every
    row's logits and hidden rows, and every rank's cache or pool shard."""
    k = 2 * list(CONFIGS).index(name) + int(paged)
    ref = runs["ref"][name, world, paged]
    res = runs[world]
    shape = (1, 1, 2) if world == 2 else (2, 1, 2)
    kv = CONFIGS[name][1]
    for r in res:
        got = r[k]
        for s in range(SWEEPS):
            _held(got["logits"][s].reshape(-1, ref["logits"].shape[-1]),
                  ref["logits"][s].reshape(-1, ref["logits"].shape[-1]), f"{name} sweep {s}")
            _hidden_held(got["hidden"][s], ref["hidden"][s], f"{name} hidden {s}")
        assert np.array_equal(got["logits"], res[0][k]["logits"])   # every rank the same bits
        assert np.array_equal(got["hidden"], res[0][k]["hidden"])
    for pos, r in enumerate(res):
        for c in ("k", "v"):
            if paged:   # JAX's disabled lanes write their group's sink page 0, the port's none
                want = _shard(ref[c], shape, pos, n_pages_for(shape[0]))[1:]
                rows_held(r[k][c][1:], want, kv, (name, world, pos, c))
            else:
                dp, _, tp = shape
                g, t = divmod(pos, tp)
                hk = ref[c].shape[3] // tp
                want = ref[c][g * B // dp:(g + 1) * B // dp, :, :, t * hk:(t + 1) * hk]
                rows_held(r[k][c], want, kv, (name, world, pos, c))


def test_draft_on_mesh_gives_plain_mesh_streams(runs):
    """tests/test_scheduler_mesh.py:173 for the port: a 1-layer draft sharded
    over the same dp=2 x tp=2 mesh (its own cache, its ticks and prefill on
    the target's wire): the plain mesh scheduler's streams."""
    plain, spec = runs[4][0][4], runs[4][0][5]
    assert runs[4][1][5] is None
    assert spec["streams"] == plain["streams"]
    assert spec["spec"]["rounds"] >= 1


def test_self_draft_on_mesh_accepts(runs):
    """tests/test_scheduler_mesh.py:202 for the port: draft == target on the
    mesh, every request completes and more than 0.7 of the proposals land."""
    got = runs[4][0][6]
    assert all(len(s) == 12 for s in got["streams"])
    st = got["spec"]
    assert st["accepted"] / max(st["proposed"], 1) > 0.7, st


def test_lookup_paged_dp2xtp2_matches_single_device(runs):
    """tests/test_spec_paged.py:176 for the port: lookup speculation over a
    paged pool on dp=2 x tp=2, the single-device lookup scheduler's
    streams, proposals accepted, every group's pages free at the end."""
    got = runs[4][0][7]
    want, _ = single_report(runs["paths"]["t86"], _lookup_reqs(10), spec_lookup=True, spec_k=3)
    assert got["streams"] == want
    assert got["spec"]["rounds"] >= 1 and got["spec"]["accepted"] >= 1, got["spec"]
    assert got["free"] == got["capacity"] == [4 * NBLK, 4 * NBLK]


def test_lookup_on_mesh_matches_single_device(runs):
    """tests/test_spec_paged.py:203 for the port (dp=2 x tp=2 for JAX's
    dp=4 x tp=2): the single-device lookup scheduler's streams."""
    got = runs[4][0][8]
    want, _ = single_report(runs["paths"]["t87"], _lookup_reqs(10), spec_lookup=True, spec_k=3)
    assert got["streams"] == want
    assert got["spec"]["rounds"] >= 1 and got["spec"]["accepted"] >= 1, got["spec"]


def test_chain_medusa_on_mesh_gives_plain_streams(runs):
    """Chain Medusa at tp=2, its heads on the verify sweep's hidden rows
    (gathered over the mesh with the logits): the plain mesh scheduler's
    greedy streams, with proposals accepted (identity heads)."""
    plain, med = runs[2][0][4], runs[2][0][5]
    assert med["streams"] == plain["streams"]
    assert med["spec"]["rounds"] >= 1 and med["spec"]["accepted"] >= 1, med["spec"]


@pytest.mark.parametrize("k,path,engine", [(6, "t87", dict(spec_lookup=True, spec_k=3)),
                                           (7, "t31", dict(draft="d32", spec_k=3))],
                         ids=["lookup", "draft"])
def test_spec_server_on_mesh_answers_as_one_device(runs, k, path, engine):
    """--mesh 1,1,2 with --spec-lookup, and with --draft (each rank loads
    the draft's shard): the single-device server's completion."""
    p = runs["paths"]
    if "draft" in engine:
        engine = dict(engine, draft=p[engine["draft"]])
    eng = ServingEngine.from_checkpoint(p[path], batch=4, device="cpu", **engine)
    try:
        want = eng.complete(PROMPT, max_tokens=8, temperature=0.0)
    finally:
        eng.close()
    assert runs[2][0][k] == want and runs[2][1][k] is None


def test_draft_that_does_not_shard_is_refused(tmp_path):
    """A draft whose kv heads do not split over tp: JAX's ValueError
    (scheduler.py:958-960), from the Scheduler and the server's loader."""
    cfg = tiny_config(**kw())
    dcfg = tiny_config(**kw(n_heads=2, n_kv_heads=1, n_layers=1))
    path, dpath = str(tmp_path / "m.yalm"), str(tmp_path / "d.yalm")
    synth_checkpoint(path, cfg, seed=1)
    synth_checkpoint(dpath, dcfg, seed=2)
    mesh = grid_mesh(PortMeshConfig(tp=2), 0)
    fw = load_fast_weights(read_yalm(path), cfg, "cpu", tp=2, rank=0)
    dfw = load_fast_weights(read_yalm(dpath), dcfg, "cpu")
    with pytest.raises(ValueError, match="draft shapes must shard over tp=2"):
        Scheduler(cfg, fw, batch=4, device="cpu", mesh=mesh, spec_draft=(dcfg, dfw))
    with pytest.raises(ValueError, match="draft shapes must shard over tp=2"):
        load_draft(dpath, 0, "cpu", mesh)
