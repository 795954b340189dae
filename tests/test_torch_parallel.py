"""The port's parallel/ package in one process, against the JAX package's
on the virtual 8-device CPU mesh (conftest): what fits a mesh
(fast_tp_supported), every rank's weight shard byte for byte against
JAX's shard_fast_tp_weights addressable shard (read by the port's loader
out of the checkpoint, cut from JAX's numpy arrays and cut from the
single-device layout), the split tables, the multi-node layout
(make_hybrid_mesh, local_batch_slice) on synthetic nodes as
tests/test_distributed.py drives JAX's, start-up, the MoE sentinel and the
mesh entry points' refusals. The collectives themselves run in spawned
ranks: tests/test_torch_fast_tp.py, tests/test_torch_scheduler_mesh.py."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.models.fast import load_fast_weights as jax_load
from yalm_tpu.parallel import fast_tp as jax_fast_tp
from yalm_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from yalm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from yalm_tpu.parallel.mesh import validate_divisibility as jax_validate
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.models.fast import fast_weights_from_numpy, load_fast_weights
from yalm_tpu_torch.models.weights import load_weights
from yalm_tpu_torch.ops.cuda import gemv as G
from yalm_tpu_torch.parallel import distributed
from yalm_tpu_torch.parallel.fast_tp import (fast_tp_supported, fast_tp_weights, local_cache,
                                             mesh_route, shard_fast_tp_weights)
from yalm_tpu_torch.parallel.mesh import MeshConfig, grid_mesh, validate_divisibility
from yalm_tpu_torch.parallel.sharding import (cache_splits, fast_weight_splits,
                                              local_cache_shape, weight_splits)
from yalm_tpu_torch.scheduler import Scheduler
from yalm_tpu_torch.utils.testing import _fast_weights_numpy, synth_checkpoint, tiny_config


def grid(dp=1, ep=1, tp=1, position=0):
    """Rank `position` of a (dp, ep, tp) grid, without process groups."""
    return grid_mesh(MeshConfig(dp, ep, tp), position)


def kw(**overrides):
    """The kernels' smallest shapes (tests/test_fast_path.py:28), fp8; int4
    needs each rank's wo/w2 input to hold whole 512-column groups, so its
    cases widen q_dim and hidden_dim to 1024."""
    base = dict(dim=256, hidden_dim=512, head_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                vocab_size=512, max_seq_len=32, rotary_dim=128, qkv_clip=30.0,
                weight_dtype="fp8")
    base.update(overrides)
    return base


WIDE = dict(hidden_dim=1024, n_heads=8)
MOE = dict(n_experts=4, n_experts_active=2)


# ---------------------------------------------------------------------------
# what fits a mesh
# ---------------------------------------------------------------------------

# (config, tp, ep) where the port's answer differs from JAX's, and why:
# JAX's answers there come from TPU tiling -- its attention_supported takes
# head_dim % 128 == 0 ("head_dim 64"), its gemv_supported K % 128 == 0
# ("dim 96"); the port's kernels take head_dim % 8 and K % 32 (16-byte
# rows). The int4 group rule (the local wo/w2 input a whole number of
# groups: "int4 narrow" at tp 2) is JAX's and holds in both.
DIFFER = {("head_dim 64", 1, 1), ("head_dim 64", 2, 1), ("head_dim 64", 4, 1),
          ("dim 96", 1, 1), ("dim 96", 2, 1)}

GRID = {"dense": kw(), "moe": kw(**MOE), "int4": kw(weight_dtype="int4", **WIDE),
        "int4 moe": kw(weight_dtype="int4", **WIDE, **MOE),
        "int4 narrow": kw(weight_dtype="int4"), "int8 bias": kw(weight_dtype="int8",
                                                               has_qkv_bias=True),
        "head_dim 64": kw(head_dim=64, rotary_dim=64, n_heads=8, n_kv_heads=4),
        "dim 96": kw(dim=96), "vocab 510": kw(vocab_size=510)}


@pytest.mark.parametrize("name", list(GRID))
def test_fast_tp_supported_on_jax_grid(name):
    """Every (tp, ep) of JAX's grid (tests/test_fast_tp.py:24) gets JAX's
    answer, except the cases DIFFER names."""
    from yalm_tpu.utils.testing import tiny_config as jax_tiny
    pcfg, jcfg = tiny_config(**GRID[name]), jax_tiny(**GRID[name])
    for tp in (1, 2, 4):
        for ep in (1, 2, 4):
            want = jax_fast_tp.fast_tp_supported(jcfg, tp, ep)
            got = fast_tp_supported(pcfg, tp, ep)
            if (name, tp, ep) in DIFFER:
                assert got and not want, (name, tp, ep)
            else:
                assert got == want, (name, tp, ep, got, want)


def test_fast_tp_supported_gates():
    """JAX's gates (tests/test_fast_tp.py:24-33) on the port's function."""
    cfg = tiny_config(**kw())
    assert fast_tp_supported(cfg, 1) and fast_tp_supported(cfg, 2)
    assert not fast_tp_supported(cfg, 4)   # tp > n_kv_heads
    moe = tiny_config(**kw(n_experts=2, n_experts_active=1))
    assert fast_tp_supported(moe, 2, ep=1) and fast_tp_supported(moe, 2, ep=2)
    assert not fast_tp_supported(moe, 2, ep=4)
    assert not fast_tp_supported(cfg, 2, ep=2)


@pytest.mark.parametrize("case", [dict(tp=2), dict(tp=3), dict(ep=2), dict(tp=8)])
def test_validate_divisibility_as_jax(case):
    """validate_divisibility raises where JAX's does, with its message."""
    from yalm_tpu.utils.testing import tiny_config as jax_tiny
    for over in ({}, MOE):
        pcfg, jcfg = tiny_config(**kw(**over)), jax_tiny(**kw(**over))
        try:
            jax_validate(jcfg, JaxMeshConfig(**case))
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            validate_divisibility(pcfg, MeshConfig(**case))
        else:
            with pytest.raises(ValueError) as e:
                validate_divisibility(pcfg, MeshConfig(**case))
            assert str(e.value) == want


# ---------------------------------------------------------------------------
# every rank's shard against JAX's addressable shard
# ---------------------------------------------------------------------------

SHARDS = {"tp2 fp8": (kw(), 1, 2), "ep2 moe fp8": (kw(**MOE), 2, 1),
          "ep2 tp2 moe fp8": (kw(**MOE), 2, 2),
          "tp2 int8 bias": (kw(weight_dtype="int8", has_qkv_bias=True), 1, 2),
          "tp2 int4": (kw(weight_dtype="int4", **WIDE), 1, 2),
          "ep2 moe int4": (kw(weight_dtype="int4", **WIDE, **MOE), 2, 1)}


def _bytes(a) -> tuple:
    a = np.ascontiguousarray(np.asarray(a))
    return a.shape, a.view(np.uint8).tobytes()


def _jax_arrays(fw) -> dict:
    out = {k: np.asarray(v) for k, v in fw._asdict().items() if v is not None and k != "scales"}
    if fw.scales is not None:
        out["scales"] = {k: np.asarray(v) for k, v in fw.scales._asdict().items()
                         if v is not None}
    return out


def _jax_rank(tree, dev) -> dict:
    """A placed JAX FastWeights' arrays as device `dev` holds them."""
    def pick(a):
        return next(np.asarray(s.data) for s in a.addressable_shards if s.device == dev)
    out = {k: pick(v) for k, v in tree._asdict().items() if v is not None and k != "scales"}
    if tree.scales is not None:
        out["scales"] = {k: pick(v) for k, v in tree.scales._asdict().items() if v is not None}
    return out


def _same(got: dict, want: dict, where: str) -> None:
    assert set(got) == set(want), (where, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _same(got[k], want[k], f"{where}.{k}")
        else:
            assert _bytes(got[k]) == _bytes(want[k]), f"{where}.{k}"


@pytest.mark.parametrize("name", list(SHARDS))
def test_rank_shards_equal_jax(tmp_path, name):
    """Each rank's shard is byte-equal to the addressable shard JAX's
    shard_fast_tp_weights places on that rank's device: read by the port's
    loader out of the checkpoint mmap (load_fast_weights(tp=, ep=, rank=)),
    cut from JAX's shard-major numpy arrays (fast_weights_from_numpy) and
    cut from the port's single-device FastWeights (shard_fast_tp_weights)."""
    over, ep, tp = SHARDS[name]
    cfg = tiny_config(**over)
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, cfg, seed=11)
    jyf = jax_read(path, native=False)
    jw = jax_load(jyf, cfg, tp=tp)
    arrays = _jax_arrays(jw)
    jmesh = jax_make_mesh(JaxMeshConfig(ep=ep, tp=tp), devices=jax.devices()[:ep * tp])
    placed = jax_fast_tp.shard_fast_tp_weights(jw, cfg, jmesh)
    jyf.close()
    yf = read_yalm(path, native=False)
    whole = load_fast_weights(yf, cfg, "cpu")
    for r in range(ep * tp):
        e, t = (r // tp) % ep, r % tp
        want = _jax_rank(placed, jmesh.devices[0, e, t])
        _same(_fast_weights_numpy(load_fast_weights(yf, cfg, "cpu", tp=tp, ep=ep, rank=r)),
              want, f"{name} rank {r} loader")
        _same(_fast_weights_numpy(fast_weights_from_numpy(arrays, cfg, tp=tp, ep=ep, rank=r)),
              want, f"{name} rank {r} from numpy")
        _same(_fast_weights_numpy(shard_fast_tp_weights(whole, cfg, grid(1, ep, tp, r))),
              want, f"{name} rank {r} from the single-device layout")
    yf.close()


def test_fast_tp_weights_order_as_jax(tmp_path):
    """fast_tp_weights (oracle Weights -> shard-major) against JAX's on the
    same checkpoint, byte for byte; each rank's chunk of it
    (fast_weights_from_numpy) equals the shard cut from the Weights
    directly."""
    from yalm_tpu.models.weights import load_weights as jax_load_weights
    cfg = tiny_config(**kw(has_qkv_bias=True, weight_dtype="bf16"))
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, cfg, seed=12)
    jyf = jax_read(path, native=False)
    want = _jax_arrays(jax_fast_tp.fast_tp_weights(jax_load_weights(jyf, cfg), cfg, 2))
    jyf.close()
    w = load_weights(read_yalm(path, native=False), cfg, "cpu")
    _same(_fast_weights_numpy(fast_tp_weights(w, cfg, 2)), want, "fast_tp_weights")
    for r in range(2):
        _same(_fast_weights_numpy(fast_weights_from_numpy(want, cfg, tp=2, rank=r)),
              _fast_weights_numpy(shard_fast_tp_weights(w, cfg, grid(tp=2, position=r))),
              f"rank {r}")


def test_split_tables_are_jax_pspecs():
    """The split tables say what JAX's PartitionSpecs say: for each field,
    the dimensions named by an axis."""
    from yalm_tpu.parallel.sharding import cache_pspecs, weight_pspecs
    from yalm_tpu.utils.testing import tiny_config as jax_tiny

    def dims(spec) -> tuple:
        return tuple((i, a) for i, a in enumerate(spec) if a is not None)

    for over in ({}, MOE, dict(has_qkv_bias=True, has_qk_norm=True, has_post_norms=True)):
        jcfg, pcfg = jax_tiny(**kw(**over)), tiny_config(**kw(**over))
        for ws in (False, True):
            for wdt in ("int8", "int4"):
                jc = dataclasses.replace(jcfg, weight_dtype=wdt)
                pc = dataclasses.replace(pcfg, weight_dtype=wdt)
                spec = jax_fast_tp.fast_weight_pspecs(jc, with_scales=ws)
                table = fast_weight_splits(pc, with_scales=ws)
                for k, v in spec._asdict().items():
                    if k == "scales":
                        assert (v is None) == ("scales" not in table)
                        if v is not None:
                            for g, sv in v._asdict().items():
                                if sv is not None:
                                    assert tuple(table["scales"][g]) == dims(sv), (k, g)
                    elif v is not None:
                        assert tuple(table[k]) == dims(v), k
        jw = weight_pspecs(jcfg)
        table = weight_splits(pcfg)
        for k, v in jw.layers._asdict().items():
            if v is not None:
                assert tuple(table[k]) == dims(v), k
        for k in ("embed", "final_norm", "lm_head"):
            assert tuple(table[k]) == dims(getattr(jw, k)), k
    for batched in (False, True):
        assert cache_splits(batched) == dims(cache_pspecs(None, batched).k)


def test_local_cache_holds_the_ranks_heads_and_lanes():
    cfg = tiny_config(**kw())
    mesh = grid(dp=2, tp=2, position=3)
    c = local_cache(cfg, mesh, torch.bfloat16, batch=8)
    assert tuple(c.k.shape) == local_cache_shape(cfg, mesh.shape, 8) == (4, 2, 32, 1, 128)
    assert tuple(local_cache(cfg, mesh).k.shape) == (2, 32, 1, 128)
    with pytest.raises(ValueError, match="split 2 ways over dp"):
        local_cache(cfg, mesh, batch=5)


# ---------------------------------------------------------------------------
# the multi-node layout on synthetic nodes (tests/test_distributed.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh_stub(monkeypatch):
    """Capture the grid order make_mesh would be built from."""
    built = {}

    def fake(mcfg, device=None, order=None, nodes=None):
        built["arr"] = np.asarray(order).reshape(mcfg.dp, mcfg.ep, mcfg.tp)
        built["nodes"] = nodes
        return built
    monkeypatch.setattr(distributed, "make_mesh", fake)
    return built


def test_hybrid_mesh_single_node(mesh_stub):
    distributed.make_hybrid_mesh(MeshConfig(dp=2, ep=2, tp=2), nodes=[0] * 8)
    assert mesh_stub["arr"].shape == (2, 2, 2)
    assert mesh_stub["arr"].reshape(-1).tolist() == list(range(8))


def test_hybrid_mesh_tp_inside_nodes(mesh_stub):
    """2 nodes x 4 ranks, tp=4: each tp group is one node, dp spans nodes."""
    nodes = [r // 4 for r in range(8)]
    distributed.make_hybrid_mesh(MeshConfig(dp=2, ep=1, tp=4), nodes=nodes)
    arr = mesh_stub["arr"]
    for d in range(2):
        assert len({nodes[r] for r in arr[d, 0]}) == 1
    assert nodes[arr[0, 0, 0]] != nodes[arr[1, 0, 0]]


def test_hybrid_mesh_orders_by_node(mesh_stub):
    """Ranks whose nodes interleave are sorted so tp stays on a node."""
    nodes = [r % 2 for r in range(8)]
    distributed.make_hybrid_mesh(MeshConfig(dp=2, ep=1, tp=4), nodes=nodes)
    for d in range(2):
        assert len({nodes[r] for r in mesh_stub["arr"][d, 0]}) == 1


def test_hybrid_mesh_rejects_straddling_tp():
    with pytest.raises(ValueError, match="straddle"):
        distributed.make_hybrid_mesh(MeshConfig(dp=4, ep=1, tp=3),
                                     nodes=[r // 4 for r in range(12)])


def test_hybrid_mesh_tp_spanning_whole_nodes_ok(mesh_stub):
    nodes = [r // 2 for r in range(8)]
    distributed.make_hybrid_mesh(MeshConfig(dp=2, ep=1, tp=4), nodes=nodes)
    for d in range(2):
        ns = [nodes[r] for r in mesh_stub["arr"][d, 0]]
        assert ns == sorted(ns) and len(set(ns)) == 2


def test_hybrid_mesh_wrong_device_count():
    with pytest.raises(ValueError, match="wants"):
        distributed.make_hybrid_mesh(MeshConfig(tp=4), nodes=[0] * 8)


def _node_mesh(n_nodes, per_node):
    return types.SimpleNamespace(ranks=np.arange(n_nodes * per_node).reshape(n_nodes, 1, -1),
                                 nodes={r: r // per_node for r in range(n_nodes * per_node)})


def test_local_batch_slice(monkeypatch):
    mesh = _node_mesh(4, 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    assert distributed.local_batch_slice(16, mesh) == slice(8, 12)
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    assert distributed.local_batch_slice(16, mesh) == slice(0, 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    with pytest.raises(ValueError, match="divisible"):
        distributed.local_batch_slice(10, mesh)
    monkeypatch.setattr(distributed, "process_index", lambda: 7)
    with pytest.raises(RuntimeError, match="owns no devices"):
        distributed.local_batch_slice(8, _node_mesh(2, 4))


# ---------------------------------------------------------------------------
# start-up
# ---------------------------------------------------------------------------

def test_initialize_world_of_one_and_explicit_failures(monkeypatch, tmp_path):
    """num_processes <= 1 (and no cluster outside torchrun) is a world of
    one; an explicit cluster that fails to start raises; the backend is
    the device's (gloo on the CPU) and is never retried with another."""
    for n in (1, 0):
        distributed.initialize(num_processes=n, device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        distributed.initialize(num_processes=n, device="cpu")   # a second call: a no-op
        dist.destroy_process_group()
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize(device="cpu")
    assert dist.get_world_size() == 1
    dist.destroy_process_group()
    monkeypatch.setenv("YALM_REQUIRE_DISTRIBUTED", "1")
    with pytest.raises(RuntimeError, match="YALM_REQUIRE_DISTRIBUTED"):
        distributed.initialize(device="cpu")
    monkeypatch.delenv("YALM_REQUIRE_DISTRIBUTED")
    with pytest.raises(ValueError, match="process_id"):
        distributed.initialize("localhost:1", 2, device="cpu")
    tried = []

    def refuse(backend, **kw):
        tried.append(backend)
        raise RuntimeError("refused")
    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="init_process_group failed"):
        distributed.initialize(f"file://{tmp_path}/pg", 2, 0, device="cpu")
    assert tried == ["gloo"]
    assert distributed.default_backend("cpu") == "gloo"
    assert distributed.default_backend() == distributed.default_backend("cuda:1") == "nccl"


# ---------------------------------------------------------------------------
# the MoE sentinel and the entry points' refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int4", [False, True])
def test_routed_expert_sentinel_plain(int4):
    """The routed experts' plain versions answer the id -1 (another rank's
    expert) with zeros, as the kernels do, and an id outside [-1, E) with
    NaN; an id in range as before."""
    g = torch.Generator().manual_seed(5)
    if int4:
        w = torch.randint(0, 256, (2, 3, 32, 128), generator=g, dtype=torch.uint8)
        s = torch.rand(2, 3, 1, 32, generator=g)
        x, fv, fm = torch.randn(256, generator=g), G.gemv4_le, G.gemm4_le
    else:
        w = torch.randn(2, 3, 32, 64, generator=g)
        s = torch.rand(2, 3, 32, generator=g)
        x, fv, fm = torch.randn(64, generator=g), G.gemv_le, G.gemm_le
    for e, want in ((-1, "zero"), (3, "nan"), (-2, "nan"), (1, "value")):
        for out in (fv(x, w, 1, torch.tensor(e), s),
                    fm(x[None].repeat(2, 1), w, 1, torch.tensor(e), s)):
            if want == "zero":
                assert bool((out == 0).all())
            elif want == "nan":
                assert bool(out.isnan().all())
            else:
                assert bool(out.isfinite().all()) and bool((out != 0).any())
    ref = G.gemv_le_plain(x, w, 1, 1, s)
    assert torch.equal(fv(x, w, 1, torch.tensor(1), s), ref)


def test_mesh_routes_and_scheduler_refusals():
    """The sharded oracle is a later slice (fast=False raises
    NotImplementedError naming ROADMAP.md); fast=True on shards the
    kernels refuse raises JAX's ValueError; the scheduler refuses the paged
    pool and speculation on a mesh after JAX's own ValueErrors
    (scheduler.py:507-538)."""
    cfg, moe = tiny_config(**kw()), tiny_config(**kw(**MOE))
    assert mesh_route(cfg, "auto", grid(tp=2)) is True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mesh_route(cfg, False, grid(tp=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mesh_route(cfg, "auto", grid(tp=4))
    with pytest.raises(ValueError, match="fast TP path unavailable"):
        mesh_route(cfg, True, grid(tp=4))
    m = grid(tp=2)
    with pytest.raises(ValueError, match="paged cache \\+ mesh"):
        Scheduler(moe, None, device="cpu", mesh=grid(ep=2), paged_pages=8, page_size=16)
    with pytest.raises(ValueError, match="spec x mesh"):
        Scheduler(moe, None, device="cpu", mesh=grid(ep=2), spec_lookup=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Scheduler(cfg, None, device="cpu", mesh=m, paged_pages=8, page_size=16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Scheduler(cfg, None, device="cpu", mesh=m, spec_lookup=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Scheduler(cfg, None, device="cpu", mesh=m, fast=False)
    with pytest.raises(ValueError, match="batch % dp"):
        Scheduler(cfg, None, device="cpu", mesh=grid(dp=2, position=1), batch=5)
