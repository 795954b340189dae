"""The port's sequence-parallel ring prefill (yalm_tpu_torch/parallel/ring.py)
in spawned gloo ranks on the CPU, against the JAX package's
(yalm_tpu/parallel/ring.py) on the virtual 8-device mesh (conftest), on the
same checkpoints: JAX's own cases (tests/test_ring.py:47-55, tests/
test_int4.py:292, tests/test_qwen3.py:129) at (sp, tp) = (2, 1), (2, 2) and
(4, 1): a dense model, embed_scale 8, Gemma2 (softcaps, sandwich norms, a
sliding layer of window 16 at T 32), Gemma3 (qk-norm, dual rope, sliding),
packed int4 at tp 2; the greedy decode that continues from the placed
window cache; MoE refused.

Bounds: the last-token logits within 1e-2 of max(1, max|logit|) of JAX's
ring's, the argmax equal (tests/test_torch_fast_tp.py's rule); every rank
the same logits bits; each rank's K/V rows within JAX's own bound for ring
rows (rtol 3e-2, atol 4e-2: tests/test_ring.py:78-84) of JAX's ring's rows
at the rank's positions and kv heads; the stream decoded from the
ring-placed cache equal to the one decoded from the port's single-device
prefill_fast cache and to JAX's from its prefill_fast cache.

The ranks run `yalm_tpu_torch.utils.testing.mesh_cases` ("ring") in fresh
processes that import no JAX (run_ranks), one world of 2 and one of 4 for
the whole module, started before the JAX references are computed."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.models import load_weights as jax_load_weights
from yalm_tpu.models.cache import KVCache as JaxCache
from yalm_tpu.models.fast import decode_step_fast as jax_decode_one
from yalm_tpu.models.fast import load_fast_weights as jax_load_fast
from yalm_tpu.models.fast import prefill_fast as jax_prefill_fast
from yalm_tpu.parallel.ring import make_prefill_ring as jax_make_ring
from yalm_tpu.parallel.ring import shard_ring_weights as jax_shard_ring
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.config import ModelConfig
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import decode_step_fast, load_fast_weights, prefill_fast
from yalm_tpu_torch.parallel.mesh import grid_mesh
from yalm_tpu_torch.parallel.ring import make_prefill_ring, ring_prefill_cache, ring_supported
from yalm_tpu_torch.utils.testing import run_ranks, synth_checkpoint, tiny_config

LOGIT_TOL = 1e-2
WORKER = "yalm_tpu_torch.utils.testing:mesh_cases"
T = 32
STEPS = 8


def fast_kw(**over):
    """tests/test_fast_path.py:28's fast_config at tests/test_ring.py's window."""
    base = dict(dim=256, hidden_dim=512, head_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                vocab_size=512, max_seq_len=64, rotary_dim=128, qkv_clip=30.0)
    base.update(over)
    return base


GEMMA2 = dict(embed_scale=16.0, has_post_norms=True, attn_softcap=50.0, final_softcap=30.0,
              sliding_window=16, layer_sliding=(1, 0), act_type="gelu")
GEMMA3 = dict(embed_scale=16.0, has_post_norms=True, has_qk_norm=True, sliding_window=16,
              layer_sliding=(1, 0), act_type="gelu", rope_theta=1e6,
              rope_scale=("gemma3", 2.0, 1e4))
# tests/test_int4.py:251's _i4big: each tp=2 shard's inputs whole int4 groups
INT4 = dict(hidden_dim=1024, n_heads=8, n_kv_heads=4, weight_dtype="int4")
CONFIGS = {"dense": fast_kw(), "scaled": fast_kw(embed_scale=8.0), "gemma2": fast_kw(**GEMMA2),
           "gemma3": fast_kw(**GEMMA3), "int4": fast_kw(**INT4)}
# (name, config, (sp, tp), decode steps after the prefill)
TWO = [("dense_sp2", "dense", (2, 1), STEPS), ("gemma2_sp2", "gemma2", (2, 1), 0)]
FOUR = [("dense_sp2_tp2", "dense", (2, 2), STEPS), ("dense_sp4", "dense", (4, 1), 0),
        ("scaled_sp2_tp2", "scaled", (2, 2), 0), ("gemma2_sp2_tp2", "gemma2", (2, 2), 0),
        ("gemma3_sp2_tp2", "gemma3", (2, 2), 0), ("int4_sp2_tp2", "int4", (2, 2), STEPS)]


def prompt(cfg_name):
    rng = np.random.default_rng(3 + len(cfg_name))
    return rng.integers(3, 512, T).tolist()


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


def _jax_ring(path, cfg, sp, tp, toks, steps):
    """JAX's ring on the virtual (sp, tp) mesh: logits and the global K/V
    rows; and the greedy stream from JAX's single-device prefill_fast
    cache."""
    mesh = jax.make_mesh((sp, tp), ("sp", "tp"), devices=jax.devices()[:sp * tp])
    int4 = cfg.weight_dtype == "int4"
    if int4:   # packed int4 in JAX's shard-major layout (tests/test_int4.py:319)
        rw = jax_shard_ring(jax_load_fast(jax_read(path, native=False), cfg, tp=tp), cfg, mesh)
    else:
        rw = jax_shard_ring(jax_load_weights(jax_read(path, native=False), cfg), cfg, mesh)
    logits, ck, cv = jax.jit(jax_make_ring(cfg, mesh, with_scales=int4))(
        rw, jnp.asarray(toks, jnp.int32))
    out = {"logits": np.asarray(logits), "k": np.asarray(ck, np.float32),
           "v": np.asarray(cv, np.float32)}
    if steps:
        fw = jax_load_fast(jax_read(path, native=False), cfg)
        lane = JaxCache.init(cfg, jnp.bfloat16)
        lg, lane = jax_prefill_fast(cfg, fw, jnp.asarray(toks, jnp.int32), jnp.int32(0),
                                    jnp.int32(T), lane, logits_mode="last")
        stream = []
        for s in range(steps):
            stream.append(int(jnp.argmax(lg)))
            lg, lane = jax_decode_one(cfg, fw, jnp.int32(stream[-1]), jnp.int32(T + s), lane)
        out["stream"] = stream
    return out


def _port_stream(path, toks, steps):
    """The greedy stream from the port's single-device prefill_fast cache."""
    yf = read_yalm(path)
    cfg = ModelConfig.from_metadata(yf.metadata)
    fw = load_fast_weights(yf, cfg, "cpu")
    yf.close()
    cache = KVCache.init(cfg, torch.bfloat16, "cpu")
    lg, cache = prefill_fast(cfg, fw, np.asarray(toks), 0, T, cache)
    stream = []
    for s in range(steps):
        stream.append(int(torch.argmax(lg)))
        lg, cache = decode_step_fast(cfg, fw, stream[-1], T + s, cache)
    return stream


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    paths = {}
    for name, over in CONFIGS.items():
        paths[name] = str(d / f"{name}.yalm")
        synth_checkpoint(paths[name], tiny_config(**over), seed=91)

    def cases(table):
        return [dict(op="ring", path=paths[c], axes={"sp": sp, "tp": tp}, tokens=prompt(c),
                     steps=n) for _, c, (sp, tp), n in table]
    b2, b4 = {}, {}
    t2 = _spawn(2, cases(TWO), d / "w2", b2)
    t4 = _spawn(4, cases(FOUR), d / "w4", b4)
    ref = {}
    for name, c, (sp, tp), n in TWO + FOUR:
        ref[name] = _jax_ring(paths[c], jax_tiny(**CONFIGS[c]), sp, tp, prompt(c), n)
        if n:
            ref[name]["port_stream"] = _port_stream(paths[c], prompt(c), n)
    res = {}
    for table, (th, box) in ((TWO, (t2, b2)), (FOUR, (t4, b4))):
        ranks = _joined(th, box)
        for k, (name, *_rest) in enumerate(table):
            res[name] = [r[k] for r in ranks]
    return res, ref


def _held(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = LOGIT_TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)
    assert int(got.argmax()) == int(want.argmax()), what


@pytest.mark.parametrize("name,cfg_name,mesh,steps", TWO + FOUR,
                         ids=[t[0] for t in TWO + FOUR])
def test_ring_prefill_matches_jax(runs, name, cfg_name, mesh, steps):
    """The last-token logits on every rank and each rank's K/V rows against
    JAX's ring on the same (sp, tp) mesh."""
    res, ref = runs
    sp, tp = mesh
    ranks, want = res[name], ref[name]
    for r in ranks[1:]:
        assert np.array_equal(r["logits"], ranks[0]["logits"]), name
    _held(ranks[0]["logits"], want["logits"], name)
    T_l, Hk_l = T // sp, want["k"].shape[2] // tp
    for pos, r in enumerate(ranks):   # rank = sp coordinate * tp + tp coordinate
        s, t = divmod(pos, tp)
        for kv in ("k", "v"):
            w = want[kv][:, s * T_l:(s + 1) * T_l, t * Hk_l:(t + 1) * Hk_l]
            np.testing.assert_allclose(r[kv], w, rtol=3e-2, atol=4e-2, err_msg=f"{name} {kv}")


@pytest.mark.parametrize("name", [t[0] for t in TWO + FOUR if t[3]])
def test_ring_cache_decodes_as_prefill_fast(runs, name):
    """The greedy stream decoded on one device from the ring-placed window
    cache (every rank gathers the same cache) is the port's from its
    single-device prefill_fast cache and JAX's from its own."""
    res, ref = runs
    streams = [r["stream"] for r in res[name]]
    assert all(s == streams[0] for s in streams), name
    assert streams[0] == ref[name]["port_stream"] == ref[name]["stream"], name


def test_ring_cache_placement_and_refusals():
    """ring_prefill_cache places (n_layers, T, Hk, D) rows at slots [0, T)
    of a window cache of the requested type (e5m2 rounded from the bf16
    rows, the rest zero); ring_supported refuses MoE (tests/test_ring.py:
    112) and shards the kernels refuse; the ring wants an ('sp', 'tp')
    mesh."""
    cfg = tiny_config(**fast_kw())
    g = torch.Generator().manual_seed(0)
    k = torch.randn(cfg.n_layers, 8, cfg.n_kv_heads, cfg.head_dim, generator=g).bfloat16()
    v = torch.randn(k.shape, generator=g).bfloat16()
    for dt in (torch.bfloat16, torch.float8_e5m2):
        c = ring_prefill_cache(cfg, k, v, dt)
        assert c.k.dtype == dt and c.k.shape == (cfg.n_layers, 64, 2, 128)
        assert torch.equal(c.k[:, :8].float(), k.to(dt).float())
        assert torch.equal(c.v[:, :8].float(), v.to(dt).float())
        assert not c.k[:, 8:].float().any() and not c.v[:, 8:].float().any()
    moe = dataclasses.replace(cfg, n_experts=4, n_experts_active=2)
    assert ring_supported(cfg, 4, 1) and ring_supported(cfg, 2, 2)
    assert not ring_supported(moe, 4, 1)
    assert not ring_supported(cfg, 2, 4)      # 2 kv heads do not split 4 ways
    with pytest.raises(ValueError, match="does not take"):
        make_prefill_ring(moe, grid_mesh({"sp": 2, "tp": 1}, 0))
    with pytest.raises(ValueError, match="'sp', 'tp'"):
        make_prefill_ring(cfg, grid_mesh({"sp": 2}, 0))
