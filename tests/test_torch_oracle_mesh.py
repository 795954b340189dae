"""The port's sharded parity oracle (yalm_tpu_torch/parallel/oracle.py:
models/transformer.py's decode_step and prefill on one rank's cut of the
oracle Weights, with OracleShard's collectives) in spawned gloo ranks on
the CPU, against the JAX package's sharded oracle (GSPMD over
parallel/sharding.py's NamedShardings) on the virtual 8-device mesh
(conftest), on the same checkpoints and JAX's own cases
(tests/test_sharding.py:39-95): decode at tp=2 and tp=4, prefill then
decode at tp=4 with the cache, tp=4 over 2 kv heads (each rank computes
the one kv head its q heads read, and its q columns cut a head in two;
JAX's cache_pspecs cannot split 2 heads 4 ways, so its cache is
replicated there),
MoE decode at ep=2 and at ep=2 x tp=2; Engine.from_checkpoint(mesh=) on a
config the kernels refuse (dim 48) against JAX's mesh engine with
fast=False; the CLI with -M 1,1,2 under torch.distributed.run against the
single process; the scheduler's and the server's ValueError (JAX's
scheduler.py:535-538).

Bounds: logits within rtol 1e-4, atol 1e-4 of JAX's (tests/test_sharding.py:
60: the oracle computes in f32, so only the order of its f32 sums differs),
every rank the same logits bits; each rank's f32 cache within 1e-3 of
JAX's at its kv heads (tests/test_sharding.py:79); the engine's and the
CLI's greedy tokens equal.

The ranks run `yalm_tpu_torch.utils.testing.mesh_cases` ("oracle",
"engine") in fresh processes that import no JAX (run_ranks), one world of
2 and one of 4 for the whole module, started before the JAX references are
computed."""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.engine import Engine as JaxEngine
from yalm_tpu.models import KVCache as JaxCache
from yalm_tpu.models import decode_step as jax_decode_step
from yalm_tpu.models import load_weights as jax_load_weights
from yalm_tpu.models import prefill as jax_prefill
from yalm_tpu.parallel import MeshConfig, make_mesh, shard_cache, shard_weights
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch import cli
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.config import ModelConfig
from yalm_tpu_torch.models.fast import fast_supported
from yalm_tpu_torch.parallel.fast_tp import mesh_route
from yalm_tpu_torch.parallel.mesh import MeshConfig as PortMeshConfig
from yalm_tpu_torch.parallel.mesh import grid_mesh
from yalm_tpu_torch.parallel.oracle import OracleShard
from yalm_tpu_torch.scheduler import Scheduler
from yalm_tpu_torch.server import ServingEngine
from yalm_tpu_torch.utils.testing import run_ranks, synth_checkpoint, tiny_config

WORKER = "yalm_tpu_torch.utils.testing:mesh_cases"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_sharding.py's configs: decode (8 kv heads), prefill (4), MoE;
# and 6 q heads over 2 kv heads, whose q_dim 48 splits 4 ways mid-head
CONFIGS = {"dense": dict(n_heads=8, n_kv_heads=8, head_dim=8, dim=64, hidden_dim=128,
                         max_seq_len=32, vocab_size=128),
           "gqa4": dict(n_heads=8, n_kv_heads=4, head_dim=8, dim=64, hidden_dim=128,
                        max_seq_len=32, vocab_size=128),
           "split": dict(n_heads=6, n_kv_heads=2, head_dim=8, dim=64, hidden_dim=128,
                         max_seq_len=32, vocab_size=128),
           "moe": dict(n_heads=4, n_kv_heads=2, head_dim=8, dim=32, hidden_dim=64,
                       max_seq_len=16, vocab_size=64, n_experts=4, n_experts_active=2),
           # dim 48: no K a multiple of 32 for the port's GEMMs, so the kernels refuse it
           "refused": dict(n_heads=8, n_kv_heads=8, head_dim=8, dim=48, hidden_dim=128,
                           max_seq_len=32, vocab_size=128)}
TOKS = [3, 17, 42, 9]
CHUNK = ([5, 9, 2, 6, 5, 3, 0, 0], 0, 6, "last")
PROMPT, N_GEN = [1, 7, 42, 5, 9], 10
# (name, config, mesh (dp, ep, tp), prefill chunk or None)
TWO = [("dense_tp2", "dense", (1, 1, 2), None), ("dense_tp2_prefill", "dense", (1, 1, 2), CHUNK),
       ("moe_ep2", "moe", (1, 2, 1), CHUNK)]
FOUR = [("dense_tp4", "dense", (1, 1, 4), None), ("gqa4_tp4_prefill", "gqa4", (1, 1, 4), CHUNK),
        ("split_tp4_prefill", "split", (1, 1, 4), CHUNK), ("moe_ep2_tp2", "moe", (1, 2, 2), CHUNK)]


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


def _jax_oracle(path, cfg, mesh_shape, chunk):
    """JAX's sharded oracle (GSPMD): the prefill chunk's logits, then the
    decode steps' and the global f32 cache. Where tp exceeds n_kv_heads
    JAX's cache_pspecs do not divide the cache, so it is replicated and
    GSPMD places the sharded weights' products."""
    dp, ep, tp = mesh_shape
    mesh = make_mesh(MeshConfig(dp=dp, ep=ep, tp=tp), devices=jax.devices()[:dp * ep * tp])
    sw = shard_weights(jax_load_weights(jax_read(path, native=False), cfg), cfg, mesh)
    sc = JaxCache.init(cfg, jnp.float32)
    sc = (shard_cache(sc, cfg, mesh) if cfg.n_kv_heads % tp == 0
          else jax.device_put(sc, NamedSharding(mesh, P())))
    pre, pos = [], 0
    if chunk is not None:
        toks, pos0, valid, mode = chunk
        lg, sc = jax_prefill(cfg, sw, jnp.asarray(toks, jnp.int32), jnp.int32(pos0),
                             jnp.int32(valid), sc, logits_mode=mode)
        pre.append(np.asarray(lg))
        pos = pos0 + valid
    steps = []
    for t in TOKS:
        lg, sc = jax_decode_step(cfg, sw, jnp.int32(t), jnp.int32(pos), sc)
        steps.append(np.asarray(lg))
        pos += 1
    return {"prefill": pre, "steps": np.stack(steps), "k": np.asarray(sc.k, np.float32),
            "v": np.asarray(sc.v, np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("oracle_mesh")
    paths = {}
    for name, over in CONFIGS.items():
        paths[name] = str(d / f"{name}.yalm")
        synth_checkpoint(paths[name], tiny_config(**over), seed=7)

    def cases(table):
        return [dict(op="oracle", path=paths[c], mesh=m, kv="f32", tokens=TOKS,
                     chunks=[] if chunk is None else [chunk]) for _, c, m, chunk in table]
    engine = dict(op="engine", path=paths["refused"], mesh=(1, 1, 2), kv="f32", prompt=PROMPT,
                  steps=N_GEN, seed=0)
    b2, b4 = {}, {}
    t2 = _spawn(2, cases(TWO) + [engine], d / "w2", b2)
    t4 = _spawn(4, cases(FOUR), d / "w4", b4)
    ref = {name: _jax_oracle(paths[c], jax_tiny(**CONFIGS[c]), m, chunk)
           for name, c, m, chunk in TWO + FOUR}
    mesh = make_mesh(MeshConfig(tp=2), devices=jax.devices()[:2])
    eng = JaxEngine.from_checkpoint(paths["refused"], mesh=mesh, fast=False,
                                    kv_dtype=jnp.float32)
    ref["engine"] = list(eng.generate(PROMPT, max_steps=N_GEN, temperature=0.0, seed=0))
    res = {}
    for table, (th, box) in ((TWO + [("engine",)], (t2, b2)), (FOUR, (t4, b4))):
        ranks = _joined(th, box)
        for k, row in enumerate(table):
            res[row[0]] = [r[k] for r in ranks]
    return res, ref, paths


@pytest.mark.parametrize("name,cfg_name,mesh,chunk", TWO + FOUR, ids=[t[0] for t in TWO + FOUR])
def test_sharded_oracle_matches_jax(runs, name, cfg_name, mesh, chunk):
    """The prefill chunk's last logits and every decode step's on every
    rank, and each rank's cache at its kv heads, against JAX's GSPMD
    oracle."""
    res, ref, _ = runs
    ranks, want = res[name], ref[name]
    for r in ranks[1:]:
        assert np.array_equal(r["steps"], ranks[0]["steps"]), name
    for g, w in zip(ranks[0]["prefill"], want["prefill"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"{name} prefill")
    np.testing.assert_allclose(ranks[0]["steps"], want["steps"], rtol=1e-4, atol=1e-4,
                               err_msg=name)
    cfg = tiny_config(**CONFIGS[cfg_name])
    for pos, r in enumerate(ranks):
        sh = OracleShard(cfg, grid_mesh(PortMeshConfig(*mesh), pos))
        for c in ("k", "v"):
            np.testing.assert_allclose(r[c], want[c][:, :, sh.k0:sh.k1], rtol=1e-3, atol=1e-3,
                                       err_msg=f"{name} rank {pos} {c}")


def test_engine_on_mesh_takes_the_sharded_oracle(runs):
    """Engine.from_checkpoint(mesh=) on a config the kernels refuse (dim 48)
    runs the sharded oracle under fast="auto": JAX's mesh engine's greedy
    tokens (fast=False, f32 cache), the same on both ranks."""
    res, ref, _ = runs
    assert not fast_supported(tiny_config(**CONFIGS["refused"]))
    assert all(r == res["engine"][0] for r in res["engine"])
    assert res["engine"][0] == ref["engine"]


def test_cli_on_mesh_runs_the_sharded_oracle(runs, capsysbinary):
    """python -m torch.distributed.run --nproc-per-node 2 runs -M 1,1,2 -d cpu
    on the refused config: rank 0 prints the single process's completion
    (the oracle on one device)."""
    path = runs[2]["refused"]
    args = [path, "-d", "cpu", "-m", "completion", "-i", "hello world", "-n", "8", "-t", "0"]
    two = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", "2", "-m", "yalm_tpu_torch.cli", *args,
                            "-M", "1,1,2"], cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, env=dict(os.environ, OMP_NUM_THREADS="1"))
    cli.main(args)   # the single process, while the two ranks run
    one = capsysbinary.readouterr().out
    out, err = two.communicate(timeout=180)
    assert two.returncode == 0, err.decode()[-3000:]

    def text(out):   # the generation: after the encoding's stats line, before its own
        return out.split(b"Generation stats")[0].split(b"Encoding stats")[1].split(b"\n", 1)[1]
    assert text(out) == text(one)
    assert out.count(b"Generation stats") == 1


def test_routes_and_the_schedulers_refusal(runs):
    """mesh_route: the kernels where the shards fit them, the sharded
    oracle for fast=False and for "auto" on shards they refuse, True there
    raising; the scheduler and the server on a mesh refuse the oracle with
    JAX's ValueError (scheduler.py:535-538), the server before loading."""
    paths = runs[2]
    refused = tiny_config(**CONFIGS["refused"])
    fits = tiny_config(dim=256, hidden_dim=512, head_dim=128, n_heads=4, n_kv_heads=2,
                       vocab_size=512, rotary_dim=128, weight_dtype="fp8")
    m = grid_mesh(PortMeshConfig(tp=2), 0)
    assert mesh_route(fits, "auto", m) is True and mesh_route(fits, True, m) is True
    assert mesh_route(fits, False, m) is False and mesh_route(refused, "auto", m) is False
    with pytest.raises(ValueError, match="fast TP path unavailable"):
        mesh_route(refused, True, m)
    for cfg, fast in ((fits, False), (refused, "auto")):
        with pytest.raises(ValueError, match="mesh scheduler requires the fast TP path"):
            Scheduler(cfg, None, device="cpu", mesh=m, fast=fast)
    with pytest.raises(ValueError, match="mesh scheduler requires the fast TP path"):
        ServingEngine.from_checkpoint(paths["refused"], device="cpu", mesh=m)
    yf = read_yalm(paths["split"])
    cfg = ModelConfig.from_metadata(yf.metadata)
    yf.close()
    # q_dim 48 over tp=4: rank 1's 12 columns are heads 1-2's halves, both on kv head 0
    sh = OracleShard(cfg, grid_mesh(PortMeshConfig(tp=4), 1))
    assert (sh.h0, sh.h1, sh.k0, sh.k1, sh.q_cols) == (1, 3, 0, 1, slice(4, 16))
    with pytest.raises(ValueError, match="tp=3"):
        OracleShard(cfg, grid_mesh(PortMeshConfig(tp=3), 0))
