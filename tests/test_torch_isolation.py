"""The port stands alone: it imports no JAX, no ml_dtypes and nothing of
the JAX package; its kernel wrappers choose by device and refuse devices
they have no path for; its entry points never fall back to the CPU."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from yalm_tpu_torch.ops.cuda.attention import (attend_one_l, attend_step_batched_l,
                                               attend_step_l, attend_step_paged_l)
from yalm_tpu_torch.ops.cuda.block import attn_block, attn_block4_l, attn_block_l
from yalm_tpu_torch.ops.cuda.ffn import ffn, ffn4_l, ffn_l
from yalm_tpu_torch.ops.cuda.gemv import (gemm4, gemm4_l, gemm4_le, gemm_l, gemm_le, gemv,
                                          gemv4, gemv4_l, gemv4_le, gemv_l, gemv_le)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import yalm_tpu_torch
for m in pkgutil.walk_packages(yalm_tpu_torch.__path__, "yalm_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "yalm_tpu"))
print("BAD", bad)
"""


@pytest.mark.parametrize("module", ["scheduler", "server", "chat", "models.paged",
                                    "models.transformer", "models.weights", "ops.attention",
                                    "utils.debug", "convert", "native", "parallel.mesh",
                                    "parallel.sharding", "parallel.distributed",
                                    "parallel.fast_tp", "parallel.ring", "parallel.pipeline",
                                    "parallel.oracle"])
def test_serving_modules_import_no_jax(module):
    code = (f"import sys, yalm_tpu_torch.{module}\n"
            "print('BAD', sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'yalm_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_port_and_chip_smoke_import_no_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def _calls(dev):
    t = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
    cache = lambda dt=torch.bfloat16: t(2, 16, 2, 128, dt=dt)  # noqa: E731
    u8 = torch.uint8   # packed int4 weights, (L, G, N) group scales
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=128)
    return {
        "gemv": lambda: gemv(t(64), t(32, 64)),
        "gemv_l": lambda: gemv_l(t(64), t(2, 32, 64), 0),
        "gemm_l": lambda: gemm_l(t(4, 64), t(2, 32, 64), 0),
        "attend_step_l": lambda: attend_step_l(t(2, 2, 128), t(2, 128), t(2, 128),
                                               cache(), cache(), 0, 0, 1, 0, 0, **rope),
        "attn_block_l": lambda: attn_block_l(t(64), t(2, 64), t(2, 1024, 64), t(2, 64, 512),
                                             cache(), cache(), 0, 0, 1, 0, 0, n_heads=4,
                                             norm_eps=1e-5, **rope),
        "ffn_l": lambda: ffn_l(t(64), t(2, 64), t(2, 96, 64), t(2, 64, 48), 0,
                               norm_eps=1e-5, act="silu"),
        "attend_step_l e5m2": lambda: attend_step_l(
            t(2, 2, 128), t(2, 128), t(2, 128), cache(torch.float8_e5m2),
            cache(torch.float8_e5m2), 0, 0, 1, 0, 0, **rope),
        "gemv4_l": lambda: gemv4_l(t(256), t(2, 32, 128, dt=u8), 0, t(2, 1, 32)),
        "gemm4_l": lambda: gemm4_l(t(4, 256), t(2, 32, 128, dt=u8), 0, t(2, 1, 32)),
        "gemv4": lambda: gemv4(t(768), t(32, 384, dt=u8), t(3, 32)),
        "gemm4": lambda: gemm4(t(4, 768), t(32, 384, dt=u8), t(3, 32)),
        "attn_block4_l": lambda: attn_block4_l(
            t(256), t(2, 256), t(2, 1024, 128, dt=u8), t(2, 256, 256, dt=u8),
            cache(torch.float8_e5m2), cache(torch.float8_e5m2), 0, 0, 1, 0, 0,
            scale_qkv=t(2, 1, 1024), scale_o=t(2, 1, 256), n_heads=4, norm_eps=1e-5, **rope),
        "ffn4_l": lambda: ffn4_l(t(256), t(2, 256), t(2, 1024, 128, dt=u8),
                                 t(2, 256, 256, dt=u8), 0, t(2, 1, 1024), t(2, 2, 256),
                                 norm_eps=1e-5, act="silu"),
        # the decode path's route, which picks the twin by weight type
        "attn_block int4": lambda: attn_block(
            t(256), t(2, 256), t(2, 1024, 128, dt=u8), t(2, 256, 256, dt=u8),
            cache(torch.float8_e5m2), cache(torch.float8_e5m2), 0, 0, 1, 0, 0,
            scale_qkv=t(2, 1, 1024), scale_o=t(2, 1, 256), n_heads=4, norm_eps=1e-5, **rope),
        "ffn int4": lambda: ffn(t(256), t(2, 256), t(2, 1024, 128, dt=u8),
                                t(2, 256, 256, dt=u8), 0, t(2, 1, 1024), t(2, 2, 256),
                                norm_eps=1e-5, act="silu"),
        # the batched tick's kernels: K8 and the many-row FFN (GEMM route)
        "attend_step_batched_l": lambda: attend_step_batched_l(
            t(3, 2, 2, 128), t(3, 2, 128), t(3, 2, 128), t(3, 2, 16, 2, 128, dt=torch.bfloat16),
            t(3, 2, 16, 2, 128, dt=torch.bfloat16), 1, [0, 3, 15], [1, 4, 16], [0, 0, 0],
            [0, 3, 15], [1, 0, 1], **rope),
        # the paged tick's attention: K9 over a pool, through page tables
        "attend_step_paged_l": lambda: attend_step_paged_l(
            t(3, 2, 2, 128), t(3, 2, 128), t(3, 2, 128), t(5, 2, 8, 2, 128, dt=torch.bfloat16),
            t(5, 2, 8, 2, 128, dt=torch.bfloat16), [[1, 2], [3, 4], [0, 0]], 1, [0, 3, 15],
            [1, 4, 16], [0, 0, 0], [0, 3, 15], [1, 0, 1], window=16, **rope),
        "ffn_l 9 rows": lambda: ffn_l(t(9, 64), t(2, 64), t(2, 96, 64), t(2, 64, 48), 0,
                                      norm_eps=1e-5, act="silu"),
        "ffn4_l 16 rows": lambda: ffn4_l(t(16, 256), t(2, 256), t(2, 1024, 128, dt=u8),
                                         t(2, 256, 256, dt=u8), 0, t(2, 1, 1024), t(2, 2, 256),
                                         norm_eps=1e-5, act="silu"),
        # the MoE routed-expert kernels (K10, K11) over (L, E, N, K) expert
        # stacks; the expert a host int or an id on the weights' device
        "gemv_le": lambda: gemv_le(t(64), t(2, 3, 32, 64), 1, t(1, dt=torch.int64)[0],
                                   t(2, 3, 32), norm_w=t(2, 64), glu_act="silu"),
        "gemm_le": lambda: gemm_le(t(4, 64), t(2, 3, 32, 64), 0, 2, t(2, 3, 32)),
        "gemm4_le": lambda: gemm4_le(t(4, 256), t(2, 3, 32, 128, dt=u8), 1, 0, t(2, 3, 1, 32),
                                     glu_act="gelu"),
        "gemv4_le": lambda: gemv4_le(t(256), t(2, 3, 32, 128, dt=u8), 0,
                                     t(1, dt=torch.int64)[0], t(2, 3, 1, 32)),
        # K12: one query, read only; and K2 in its Gemma forms
        "attend_one_l": lambda: attend_one_l(t(2, 2, 128), cache(), cache(), 1, 9),
        "attend_step_l gemma forms": lambda: attend_step_l(
            t(2, 2, 128), t(2, 128), t(2, 128), cache(), cache(), 0, 5, 6, 0, 5, 4, 1,
            kv_sinks=2, theta=("gemma3", 1e6, 8.0, 1e4), rotary_dim=128, softcap=30.0),
    }


@pytest.mark.parametrize("name", list(_calls("cpu")))
def test_wrappers_dispatch_by_device(name):
    # CPU tensors run the plain version
    assert torch.isfinite(_calls("cpu")[name]()).all()
    # a device with neither a kernel nor a plain version raises
    with pytest.raises(ValueError, match="no kernel or plain version"):
        _calls("meta")[name]()


class _DeviceOnly(torch.Tensor):
    """An expert id that fails if its value is read on the host: its repr,
    str, int, index, bool or item would copy a CUDA tensor back and
    synchronize every routed launch of the decode step."""

    def _read(self, *a, **k):
        raise AssertionError("the expert id was read on the host")

    __repr__ = __str__ = __int__ = __index__ = __bool__ = __float__ = item = tolist = _read


def test_routed_expert_ids_are_not_read_on_the_host():
    from yalm_tpu_torch.ops.cuda.gemv import _addressing
    e = torch.tensor([2]).as_subclass(_DeviceOnly)
    for w in (torch.zeros(2, 3, 32, 64), torch.zeros(2, 3, 32, 128, dtype=torch.uint8)):
        L, N, Kw, E, e_host, e_dev = _addressing(w, 1, e, "gemv_le")
        assert (L, N, Kw, E, e_host) == (2, 32, w.shape[-1], 3, 0) and e_dev.dtype == torch.int64
    with pytest.raises(ValueError, match="out of range"):
        _addressing(torch.zeros(2, 3, 32, 64), 0, 3, "gemm_le")    # a host id is checked


def test_routed_expert_ids_on_a_mesh_are_not_read_on_the_host():
    """On a mesh (ep=2, the rank holding experts 2 and 3) the routed ids map
    to local ids, -1 for another rank's expert, by tensor ops alone; the
    launch takes the mapped id, -1 included, without reading it."""
    from yalm_tpu_torch.ops.cuda.gemv import _addressing
    from yalm_tpu_torch.parallel.fast_tp import TPShard
    from yalm_tpu_torch.parallel.mesh import MeshConfig, grid_mesh
    from yalm_tpu_torch.utils.testing import tiny_config
    cfg = tiny_config(dim=256, hidden_dim=512, head_dim=128, n_heads=4, n_kv_heads=2,
                      vocab_size=512, max_seq_len=32, rotary_dim=128, weight_dtype="fp8",
                      n_experts=4, n_experts_active=2)
    mesh = grid_mesh(MeshConfig(ep=2), 1)
    ids = torch.tensor([3, 0]).as_subclass(_DeviceOnly)
    local = TPShard(cfg, mesh).local_experts(ids)
    for j in range(2):
        L, N, Kw, E, e_host, e_dev = _addressing(torch.zeros(2, 2, 32, 64), 1, local[j], "gemv_le")
        assert (E, e_host) == (2, 0) and e_dev.dtype == torch.int64
    assert local.as_subclass(torch.Tensor).tolist() == [1, -1]


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="different devices"):
        gemv_l(torch.zeros(64), torch.zeros(2, 32, 64, device="meta"), 0)


def test_entry_points_do_not_fall_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from yalm_tpu_torch.engine import Engine
    from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, tiny_config(dim=256, hidden_dim=512, head_dim=128,
                                       n_heads=4, n_kv_heads=2, vocab_size=512,
                                       max_seq_len=32, rotary_dim=128))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Engine.from_checkpoint(path)   # device="cuda" by default


def test_int4_entry_points_do_not_fall_back_to_cpu(tmp_path):
    """An int4 checkpoint with the e5m2 cache on the default device."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from yalm_tpu_torch import cli
    from yalm_tpu_torch.engine import Engine
    from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config
    path = str(tmp_path / "m4.yalm")
    synth_checkpoint(path, tiny_config(dim=256, hidden_dim=512, head_dim=128,
                                       n_heads=4, n_kv_heads=2, vocab_size=512,
                                       max_seq_len=32, rotary_dim=128, weight_dtype="int4"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Engine.from_checkpoint(path, kv_dtype=torch.float8_e5m2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main([path, "-C", "fp8", "-i", "hello"])


def test_moe_entry_points_do_not_fall_back_to_cpu(tmp_path):
    """An MoE checkpoint on the default device: the engine, the CLI and the
    serving engine raise rather than run the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from yalm_tpu_torch import cli
    from yalm_tpu_torch.engine import Engine
    from yalm_tpu_torch.server import ServingEngine
    from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config
    path = str(tmp_path / "moe.yalm")
    synth_checkpoint(path, tiny_config(dim=256, hidden_dim=512, head_dim=128, n_heads=4,
                                       n_kv_heads=2, vocab_size=512, max_seq_len=32,
                                       rotary_dim=128, weight_dtype="fp8", n_experts=4,
                                       n_experts_active=2))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Engine.from_checkpoint(path)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main([path, "-i", "hello"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServingEngine.from_checkpoint(path, paged_pages=9, page_size=16)


def test_serving_entry_points_do_not_fall_back_to_cpu(tmp_path):
    """Scheduler and ServingEngine default to the card."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from yalm_tpu_torch.models.fast import FastWeights
    from yalm_tpu_torch.scheduler import Scheduler
    from yalm_tpu_torch.server import ServingEngine
    from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config
    cfg = tiny_config(dim=256, hidden_dim=512, head_dim=128, n_heads=4, n_kv_heads=2,
                      vocab_size=512, max_seq_len=32, rotary_dim=128)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Scheduler(cfg, FastWeights(*(torch.zeros(1),) * 9))
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServingEngine.from_checkpoint(path)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServingEngine(cfg, FastWeights(*(torch.zeros(1),) * 9), None)


def test_oracle_entry_points_do_not_fall_back_to_cpu(tmp_path):
    """The parity oracle's routes default to the card as well: fast=False,
    and a config the kernels refuse under "auto"."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from yalm_tpu_torch.engine import Engine
    from yalm_tpu_torch.server import ServingEngine
    from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config
    path = str(tmp_path / "mqa.yalm")
    synth_checkpoint(path, tiny_config(dim=64, hidden_dim=128, head_dim=512, n_heads=8,
                                       n_kv_heads=1, rotary_dim=512, vocab_size=128,
                                       max_seq_len=16))
    for call in (lambda: Engine.from_checkpoint(path), lambda: Engine.from_checkpoint(
            path, fast=False), lambda: ServingEngine.from_checkpoint(path)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok": true' not in res.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok": true' not in res.stdout


def test_mesh_entry_points_do_not_fall_back_to_cpu(tmp_path, monkeypatch):
    """A mesh defaults to the card and to nccl: without a GPU, start-up, the
    mesh, the CLI's -M and the server's --mesh raise rather than run the
    plain versions or take gloo; a backend is never chosen by trying one and
    catching its failure."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    import torch.distributed as dist

    from yalm_tpu_torch import cli
    from yalm_tpu_torch import server as srv
    from yalm_tpu_torch.parallel import distributed
    from yalm_tpu_torch.parallel.mesh import make_mesh
    from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, tiny_config(dim=256, hidden_dim=512, head_dim=128, n_heads=4,
                                       n_kv_heads=2, vocab_size=512, max_seq_len=32,
                                       rotary_dim=128, weight_dtype="fp8"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        distributed.initialize()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main([path, "-M", "1,1,1", "-i", "hello"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        srv.main([path, "--mesh", "1,1,1", "--port", "0"])
    assert not dist.is_initialized()
    distributed.initialize(num_processes=1, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make_mesh()
    finally:
        dist.destroy_process_group()
    tried = []

    def refuse(backend, **kw):
        tried.append(backend)
        raise RuntimeError("no such backend here")
    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        distributed.initialize(f"file://{tmp_path}/pg", 2, 0, backend="nccl")
    assert tried == []   # nccl needs the card: nothing is tried, gloo least of all
    with pytest.raises(RuntimeError, match="init_process_group failed"):
        distributed.initialize(f"file://{tmp_path}/pg", 2, 0, device="cpu")
    assert tried == ["gloo"]   # the CPU's backend, once


def test_ring_and_pipeline_entry_points_do_not_fall_back_to_cpu(tmp_path):
    """The ring prefill's and the pipelined tick's meshes default to the
    card: without a GPU their named-axis meshes raise; given the CPU (a
    world of one, gloo) both run the plain versions and leave their outputs
    on the CPU, and a shift over an axis of one is the identity."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    import numpy as np
    import torch.distributed as dist

    from yalm_tpu_torch.codec.format import read_yalm
    from yalm_tpu_torch.config import ModelConfig
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.fast import load_fast_weights
    from yalm_tpu_torch.parallel import distributed
    from yalm_tpu_torch.parallel.mesh import make_mesh
    from yalm_tpu_torch.parallel.pipeline import make_tick_pp, shard_pp_cache, shard_pp_weights
    from yalm_tpu_torch.parallel.ring import (make_prefill_ring, ring_prefill_cache,
                                              shard_ring_weights)
    from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, tiny_config(dim=256, hidden_dim=512, head_dim=128, n_heads=4,
                                       n_kv_heads=2, vocab_size=512, max_seq_len=32,
                                       rotary_dim=128, weight_dtype="fp8"))
    yf = read_yalm(path)
    cfg = ModelConfig.from_metadata(yf.metadata)
    fw = load_fast_weights(yf, cfg, "cpu")
    yf.close()
    distributed.initialize(num_processes=1, device="cpu")
    try:
        for axes in ({"sp": 1, "tp": 1}, {"pp": 1}):
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                make_mesh(axes)
        ring = make_mesh({"sp": 1, "tp": 1}, device="cpu")
        t = torch.arange(6.0)
        assert ring.shift(t, "sp") is t
        logits, ck, cv = make_prefill_ring(cfg, ring)(shard_ring_weights(fw, cfg, ring),
                                                      np.arange(3, 19))
        cache = ring_prefill_cache(cfg, ck, cv, torch.bfloat16, mesh=ring)
        pp = make_mesh({"pp": 1}, device="cpu")
        lg, pc = make_tick_pp(cfg, pp, 4)(shard_pp_weights(fw, cfg, pp), [3, 4, 5, 6],
                                          [0, 1, 2, 3],
                                          shard_pp_cache(KVCache.init(cfg, batch=4,
                                                                      device="cpu"), pp),
                                          [1, 1, 1, 1])
    finally:
        dist.destroy_process_group()
    assert {logits.device.type, cache.k.device.type, lg.device.type, pc.k.device.type} == {"cpu"}
    assert logits.shape == (512,) and lg.shape == (4, 512)
