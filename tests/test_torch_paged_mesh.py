"""The paged pool on a mesh, in spawned gloo ranks on the CPU: the port's
make_tick_paged_fast_tp and make_prefill_paged_fast_tp against the JAX
package's on the virtual mesh (conftest), fp8 weights over a bf16 pool and
int4 weights over an e5m2 pool, at tp=2 and at dp=2 x tp=2 (every step's
argmax equal and its logits within 1e-2 of max(1, max|logit|), the rule of
tests/test_torch_fast_tp.py; every rank's pool shard byte for byte JAX's
on bf16 and e5m2 but a few near-zero keys one step apart, pool_holds); the paged
scheduler on the mesh against the single-device scheduler, as JAX's
tests/test_scheduler_mesh.py:119 and :144 hold JAX's (the streams equal,
preemption only inside the growing lane's dp group, every group's pages
free at the end); the server with --mesh 1,1,2 --paged-pages against the
single-device server; GroupedPageAllocator against JAX's on one random
sequence of operations; and a table naming a page outside the group's
shard refused as on one device.

JAX's weights are loaded in its shard-major layout (`load_fast_weights(tp=)`),
so its int4 factories run packed int4 as the port's do (its shards of oracle
Weights would carry dequantized weights). One world of 2 ranks and one of 4
serve the whole module, started before the JAX references are computed so
the two overlap."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.models.fast import load_fast_weights as jax_load_fast
from yalm_tpu.models.paged import GroupedPageAllocator as JaxGrouped
from yalm_tpu.models.paged import PagedKVPool as JaxPool
from yalm_tpu.parallel.fast_tp import (make_prefill_paged_fast_tp, make_tick_paged_fast_tp,
                                       shard_fast_tp_weights, shard_paged_pool)
from yalm_tpu.parallel.mesh import MeshConfig, make_mesh
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.config import ModelConfig
from yalm_tpu_torch.models.fast import load_fast_weights
from yalm_tpu_torch.models.paged import GroupedPageAllocator
from yalm_tpu_torch.parallel.fast_tp import local_pool, make_tick_paged_fast_tp as port_tick
from yalm_tpu_torch.parallel.mesh import MeshConfig as PortMeshConfig
from yalm_tpu_torch.parallel.mesh import grid_mesh
from yalm_tpu_torch.scheduler import Request, Scheduler
from yalm_tpu_torch.server import ServingEngine
from yalm_tpu_torch.utils.testing import run_ranks, synth_checkpoint, tiny_config

LOGIT_TOL = 1e-2
WORKER = "yalm_tpu_torch.utils.testing:mesh_cases"
PAGE = 16
B = 8


def kw(**overrides):
    base = dict(dim=256, hidden_dim=512, head_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                vocab_size=512, max_seq_len=64, rotary_dim=128, qkv_clip=30.0,
                weight_dtype="fp8")
    base.update(overrides)
    return base


# fp8 weights over a bf16 pool; int4 (each rank's wo/w2 input whole
# groups at tp 2) over an e5m2 pool
CONFIGS = {"fp8": (kw(), "bf16"), "int4": (kw(weight_dtype="int4", hidden_dim=1024, n_heads=8),
                                           "fp8")}
NBLK = 64 // PAGE


def tables_for(dp):
    """(B, blocks) group-local page ids: local lane l of each group owns
    pages 1 + 2l and 2 + 2l (its first 32 slots); page 0 is the sink."""
    t = np.zeros((B, NBLK), np.int64)
    for b in range(B):
        loc = b % (B // dp)
        t[b, :2] = (1 + 2 * loc, 2 + 2 * loc)
    return t


def n_pages_for(dp):
    return dp * (1 + 2 * (B // dp))


def _toks(n, off):
    return [(off + 7 * i) % 500 + 3 for i in range(n)]


def _pad(t, n):
    return t + [0] * (n - len(t))


# (lane, padded chunk, pos0, valid rows, logits mode): lanes of both dp
# groups, a padded chunk, a chunk without logits, a lane's second page
PREFILLS = [(0, _toks(16, 1), 0, 16, "last"), (5, _pad(_toks(10, 2), 16), 0, 10, "last"),
            (3, _toks(8, 3), 0, 8, "none"), (6, _toks(16, 4), 0, 16, "none"),
            (0, _pad(_toks(12, 5), 16), 16, 12, "last")]
LENGTHS = np.asarray([28, 0, 0, 8, 0, 10, 16, 0])
WRITE = np.asarray([1, 1, 0, 1, 1, 1, 1, 1])               # lane 2 attends read-only
TICKS = 4


def tick_inputs():
    toks, poss, wrs = [], [], []
    pos = LENGTHS.copy()
    for t in range(TICKS):
        toks.append(((np.arange(B) * 11 + t * 3) % 500 + 3).tolist())
        poss.append(pos.tolist())
        wrs.append(WRITE.tolist())
        pos = pos + WRITE
    return toks, poss, wrs


def paged_case(path, mesh, kv):
    dp = mesh[0]
    toks, poss, wrs = tick_inputs()
    return dict(op="paged", path=path, mesh=mesh, kv=kv, page_size=PAGE, n_pages=n_pages_for(dp),
                tables=tables_for(dp).tolist(), prefills=PREFILLS,
                ticks=list(zip(toks, poss, wrs)))


def _reqs(n, seed0=0):
    """tests/test_scheduler_mesh.py:26's requests."""
    return [dict(prompt_tokens=[1, 5 + i, 9], max_new_tokens=6, temperature=0.0, seed=seed0 + i)
            for i in range(n)]


def _pressure_reqs():
    """tests/test_scheduler_mesh.py:153's: a 2-page worst case each."""
    return [dict(prompt_tokens=[1, 8 + i, 9], max_new_tokens=20, temperature=0.0, seed=3 + i)
            for i in range(6)]


def _spawn(world, cases, tmp, box):
    def go():
        try:
            box["res"] = run_ranks(WORKER, world, {"cases": cases}, str(tmp), timeout=300)
        except Exception as e:  # noqa: BLE001 -- re-raised in the test thread
            box["err"] = e
    th = threading.Thread(target=go)
    th.start()
    return th


def _joined(th, box):
    th.join(timeout=360)
    if "err" in box:
        raise box["err"]
    assert "res" in box, "the ranks did not finish"
    return box["res"]


def _jax_paged(path, mesh_shape, cfg, kv):
    """JAX's paged prefill chunks then ticks on the virtual mesh: logits and
    the global pool."""
    dp, _, tp = mesh_shape
    mesh = make_mesh(MeshConfig(dp=dp, tp=tp), devices=jax.devices()[:dp * tp])
    sw = shard_fast_tp_weights(jax_load_fast(jax_read(path, native=False), cfg, tp=tp), cfg,
                               mesh)
    ws = getattr(sw, "scales", None) is not None
    kvd = {"bf16": jnp.bfloat16, "fp8": jnp.float8_e5m2}[kv]
    pool = shard_paged_pool(JaxPool.init(cfg, kvd, n_pages_for(dp), PAGE), mesh)
    prefill = jax.jit(make_prefill_paged_fast_tp(cfg, mesh, PAGE, with_scales=ws),
                      static_argnames=("logits_mode",))
    tick = jax.jit(make_tick_paged_fast_tp(cfg, mesh, PAGE, with_scales=ws))
    tables = tables_for(dp)
    pre, ticks = [], []
    for b, toks, pos0, valid, mode in PREFILLS:
        lg, pool = prefill(sw, jnp.asarray(toks, jnp.int32), jnp.int32(pos0), jnp.int32(valid),
                           pool, jnp.asarray(tables[b], jnp.int32),
                           jnp.int32(tables[b, pos0 // PAGE]), jnp.int32(pos0 % PAGE),
                           b // (B // dp), logits_mode=mode)
        pre.append(None if lg is None else np.asarray(lg))
    for toks, pos, wr in zip(*tick_inputs()):
        lg, pool = tick(sw, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32), pool,
                        jnp.asarray(tables, jnp.int32), jnp.asarray(wr, jnp.int32))
        ticks.append(np.asarray(lg))
    return {"prefill": pre, "ticks": np.stack(ticks), "k": np.asarray(pool.k),
            "v": np.asarray(pool.v)}


def single_streams(path, reqs, batch=8):
    """The port's dense single-device scheduler."""
    yf = read_yalm(path)
    cfg = ModelConfig.from_metadata(yf.metadata)
    sched = Scheduler(cfg, load_fast_weights(yf, cfg, "cpu"), batch=batch, device="cpu")
    yf.close()
    rs = [Request(**r) for r in reqs]
    for r in rs:
        sched.submit(r)
    sched.run()
    return [r.generated for r in rs]


PROMPT = "hello world"
SERVER = dict(paged_pages=33, page_size=PAGE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("paged_mesh")
    paths = {}
    for name, (over, _) in CONFIGS.items():
        paths[name] = str(d / f"{name}.yalm")
        synth_checkpoint(paths[name], tiny_config(**over), seed=51)
    s119, s144 = str(d / "s119.yalm"), str(d / "s144.yalm")
    synth_checkpoint(s119, tiny_config(**kw()), seed=23)
    synth_checkpoint(s144, tiny_config(**kw()), seed=24)
    two = [paged_case(paths[n], (1, 1, 2), kv) for n, (_, kv) in CONFIGS.items()]
    two.append(dict(op="server", path=s119, mesh=(1, 1, 2), prompt=PROMPT, max_tokens=8,
                    engine=SERVER))
    four = [paged_case(paths[n], (2, 1, 2), kv) for n, (_, kv) in CONFIGS.items()]
    four += [dict(op="scheduler", path=s119, mesh=(2, 1, 2), batch=8, requests=_reqs(10),
                  paged_pages=2 * (1 + 4 * NBLK), page_size=PAGE, report=True),
             dict(op="scheduler", path=s144, mesh=(2, 1, 2), batch=8, requests=_pressure_reqs(),
                  paged_pages=8, page_size=PAGE, report=True)]
    b2, b4 = {}, {}
    t2 = _spawn(2, two, d / "w2", b2)
    t4 = _spawn(4, four, d / "w4", b4)
    ref = {}
    for name, (over, kv) in CONFIGS.items():
        cfg = jax_tiny(**over)
        ref[name, 2] = _jax_paged(paths[name], (1, 1, 2), cfg, kv)
        ref[name, 4] = _jax_paged(paths[name], (2, 1, 2), cfg, kv)
    return {"paths": paths, "s119": s119, "s144": s144, 2: _joined(t2, b2),
            4: _joined(t4, b4), "ref": ref}


def _held(got, want, what):
    """Each row: the argmax equal, the logits within the tolerance."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    for i in range(got.shape[0]):
        tol = LOGIT_TOL * max(1.0, float(np.abs(want[i]).max()))
        err = float(np.abs(got[i] - want[i]).max())
        assert err <= tol, (what, i, err, tol)
        assert (got[i].argmax(-1) == want[i].argmax(-1)).all(), (what, i)


def _shard(a, mesh_shape, position, n_pages):
    """Rank `position`'s shard of JAX's global pool (pages on dp, kv heads
    on tp)."""
    dp, _, tp = mesh_shape
    g, t = divmod(position, tp)
    npl, hk = n_pages // dp, a.shape[3] // tp
    return a[g * npl:(g + 1) * npl, :, :, t * hk:(t + 1) * hk]


def pool_holds(got: np.ndarray, want: np.ndarray, kv: str, what) -> None:
    """v byte for byte; k byte for byte but where an element is one step of
    the cache type from JAX's, at the larger of its magnitude and 2^-16,
    and at most 4 such elements (tests/test_torch_gemma.py's same_rows rule
    with the e5m2 rule's floor). Both apply to bf16 and e5m2: the rotated
    keys of the second layer hold near-zero elements (1e-4 and below) that
    the two packages' f32 sums and RoPE round to neighbouring values."""
    want = want.view(got.dtype)
    if what[-1] == "v":
        assert np.array_equal(got, want), (what, int((got != want).sum()))
        return
    dt = torch.bfloat16 if kv == "bf16" else torch.float8_e5m2
    a = torch.from_numpy(got.copy()).view(dt).float()
    b = torch.from_numpy(want.copy()).view(dt).float()
    mag = torch.clamp(b.abs(), min=2.0 ** -16)
    step = torch.ldexp(torch.ones_like(b),
                       torch.frexp(mag).exponent - (8 if kv == "bf16" else 3))
    assert bool(((a == b) | ((a - b).abs() <= step)).all()), what
    assert int((a != b).sum()) <= 4, (what, int((a != b).sum()))


@pytest.mark.parametrize("world", [2, 4], ids=["tp2", "dp2xtp2"])
@pytest.mark.parametrize("k,name", [(0, "fp8"), (1, "int4")], ids=["fp8_bf16", "int4_e5m2"])
def test_paged_factories_match_jax(runs, world, k, name):
    """The paged prefill chunks (the lane's group alone runs them) and the
    paged ticks (K9 over each group's pool shard at Hk/tp heads): logits
    and every rank's pool shard against JAX's."""
    ref = runs["ref"][name, world]
    res = runs[world]
    mesh_shape = (1, 1, 2) if world == 2 else (2, 1, 2)
    kv = CONFIGS[name][1]
    for r in res:
        got = r[k]
        for i, (g, w) in enumerate(zip(got["prefill"], ref["prefill"])):
            if w is None:
                assert g is None
            else:
                _held(np.asarray(g).reshape(1, -1), np.asarray(w).reshape(1, -1),
                      f"{name} prefill {i}")
        for t in range(TICKS):
            _held(got["ticks"][t], ref["ticks"][t], f"{name} tick {t}")
        assert np.array_equal(got["ticks"], res[0][k]["ticks"])   # every rank the same bits
    for pos, r in enumerate(res):
        for c in ("k", "v"):
            pool_holds(r[k][c], _shard(ref[c], mesh_shape, pos, n_pages_for(mesh_shape[0])), kv,
                       (name, world, pos, c))


def test_paged_scheduler_on_mesh_matches_single_device(runs):
    """tests/test_scheduler_mesh.py:119 for the port: dp=2 x tp=2 over a
    pool of 2 x (1 + 4 x 4) pages of 16; the streams of the dense
    single-device scheduler, every group's pages free at the end."""
    got = runs[4][0][2]
    assert runs[4][1][2] is None
    assert got["streams"] == single_streams(runs["s119"], _reqs(10))
    assert got["free"] == got["capacity"] == [16, 16]


def test_paged_mesh_pool_pressure_preempts_inside_groups(runs):
    """tests/test_scheduler_mesh.py:144 for the port: 3 usable pages per
    group with 4 lanes each and a 2-page worst case: lazy growth and
    preemption fire, every preempted lane is in the growing lane's dp
    group, the streams are the dense single-device run's and every page
    is free at the end."""
    got = runs[4][0][3]
    assert got["streams"] == single_streams(runs["s144"], _pressure_reqs())
    assert got["preemptions"] >= 1 and got["resumes"] >= 1, got
    assert got["preempted"] and all(b // 4 == v // 4 for b, v in got["preempted"]), got
    assert got["free"] == got["capacity"] == [3, 3]


def test_paged_server_on_mesh_answers_as_one_device(runs):
    """--mesh 1,1,2 --paged-pages 33 --page-size 16: the completion the
    single-device paged server gives."""
    eng = ServingEngine.from_checkpoint(runs["s119"], batch=4, device="cpu", **SERVER)
    try:
        want = eng.complete(PROMPT, max_tokens=8, temperature=0.0)
    finally:
        eng.close()
    assert runs[2][0][2] == want and runs[2][1][2] is None


def test_grouped_allocator_matches_jax():
    """One random sequence of grow / release / prefix match and register
    over 2 groups of 4 lanes: every answer, every table and the free counts
    equal JAX's GroupedPageAllocator's."""
    cfg, jcfg = tiny_config(**kw()), jax_tiny(**kw())
    port = GroupedPageAllocator(cfg, 18, 8, PAGE, groups=2)
    jx = JaxGrouped(jcfg, 18, 8, PAGE, groups=2)
    rng = np.random.default_rng(5)
    prompts = [[1] + [int(t) for t in rng.integers(2, 9, 40)] for _ in range(3)]
    for step in range(300):
        lane = int(rng.integers(0, 8))
        op = int(rng.integers(0, 5))
        if op == 0:
            target = int(rng.integers(1, 65))
            ok = port.can_grow(lane, target)
            assert ok == jx.can_grow(lane, target), step
            if ok:
                port.grow(lane, target)
                jx.grow(lane, target)
        elif op == 1:
            port.release(lane)
            jx.release(lane)
        elif op == 2:   # an admission: the lane starts empty
            p = prompts[int(rng.integers(0, 3))]
            port.release(lane)
            jx.release(lane)
            assert port.match_prefix(lane, p) == jx.match_prefix(lane, p), step
        elif op == 3:
            p = prompts[int(rng.integers(0, 3))]
            port.register_prefix(lane, p)
            jx.register_prefix(lane, p)
        else:
            other = int(rng.integers(0, 8))
            assert port.same_pool(lane, other) == jx.same_pool(lane, other)
            assert port.same_pool(lane, other) == (lane // 4 == other // 4)
        assert np.array_equal(port.table_array(), np.asarray(jx.table_array())), step
        assert port.n_free == jx.n_free and port.prefix_stats == jx.prefix_stats, step
    assert port.lane_capacity == jx.lane_capacity == 8
    assert port.pages_for(33) == jx.pages_for(33) == 3


def test_table_outside_the_group_shard_is_refused(tmp_path):
    """Page ids are local to a group's shard of n_pages/dp pages: a table
    naming page 9 of a 2-group pool of 18 is refused before any device work,
    as a table outside the pool is on one device."""
    cfg = tiny_config(**kw())
    mesh = grid_mesh(PortMeshConfig(dp=2, tp=1), 0)
    synth_checkpoint(str(tmp_path / "m.yalm"), cfg, seed=3)
    fw = load_fast_weights(read_yalm(str(tmp_path / "m.yalm")), cfg, "cpu")
    pool = local_pool(cfg, mesh, 18, PAGE)
    assert tuple(pool.k.shape) == (9, 2, PAGE, 2, 128)
    tick = port_tick(cfg, mesh, PAGE)
    tables = tables_for(2)
    tables[1, 0] = 9
    with pytest.raises(ValueError, match="page ids out of range"):
        tick(fw, [3] * B, [0] * B, pool, tables, [1] * B)
    assert not pool.k.any()

