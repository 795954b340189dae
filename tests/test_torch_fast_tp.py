"""The port's tensor, expert and data parallelism in spawned gloo ranks on
the CPU, against the JAX package's fast_tp functions on the virtual
8-device mesh (conftest), on the same checkpoints: the decode step with
tp=2 over max_seq_len + 6 steps (the ring and its sinks; embed_scale 1 and
8), chunked prefill with tp=2 (the last, all and none modes), MoE decode
with ep=2, int4 decode with tp=2, Engine(mesh=) greedy tokens, and (four
ranks) the batched tick over dp=2 x tp=2, dense, and over ep=2 x tp=2 for
MoE. Every step: the argmax equal and the logits within 1e-2 of max(1,
max|logit|) (tests/test_torch_fast.py's rule); every rank's logits the
same bits.

int4 with tp=2: the port's step keeps the single-device route (the fused
K6 attn_block4_l and K7 ffn4_l on the shard), where JAX's tensor-parallel
int4 step takes its unfused route (fast_tp.py:289) and lands up to 1.08x
the tolerance from JAX's own single-device int4 step on this checkpoint.
The port's tp=2 logits and argmax are held to JAX's single-device step by
the rule (they agree to f32 rounding), and each of its argmaxes is JAX's
tensor-parallel step's or within twice the tolerance of its maximum (the
port's near-tie rule, chip_smoke.teacher_forced_hold).

The ranks run `yalm_tpu_torch.utils.testing.mesh_cases` in fresh
processes that import no JAX (run_ranks), one world of 2 and one of 4 for
the whole module, started before the JAX references are computed so the
two overlap."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.engine import Engine as JaxEngine
from yalm_tpu.models import KVCache as JaxCache
from yalm_tpu.models import load_weights as jax_load_weights
from yalm_tpu.models.fast import decode_step_fast as jax_decode_one
from yalm_tpu.models.fast import load_fast_weights as jax_load_fast
from yalm_tpu.parallel.fast_tp import (make_decode_step_fast_tp, make_prefill_fast_tp,
                                       make_tick_fast_tp, shard_fast_tp_weights)
from yalm_tpu.parallel.mesh import MeshConfig, make_mesh
from yalm_tpu.parallel.sharding import shard_cache
from yalm_tpu_torch.utils.testing import run_ranks, synth_checkpoint, tiny_config

LOGIT_TOL = 1e-2
WORKER = "yalm_tpu_torch.utils.testing:mesh_cases"


def kw(**overrides):
    base = dict(dim=256, hidden_dim=512, head_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                vocab_size=512, max_seq_len=32, rotary_dim=128, qkv_clip=30.0,
                weight_dtype="fp8")
    base.update(overrides)
    return base


CONFIGS = {"dense": kw(), "scaled": kw(embed_scale=8.0),
           "moe": kw(n_experts=4, n_experts_active=2),
           "int4": kw(weight_dtype="int4", hidden_dim=1024, n_heads=8)}
STEPS = [5 + (7 * i) % 300 for i in range(32 + 6)]       # max_seq_len + 6 decode steps
CHUNKS = [(list(range(40, 56)), 0, 12, "last"), (list(range(60, 76)), 12, 16, "all"),
          ([9, 8, 7, 6], 28, 4, "none")]
PROMPT, N_GEN = [1, 7, 42, 5, 9], 12
B = 8
TICKS = 6
POS0 = np.asarray([0, 3, 30, 31, 5, 12, 40, 1])            # two lanes pass the window
WRITE = np.asarray([1, 1, 1, 1, 0, 1, 1, 1])


def tick_inputs():
    """(tokens, positions, write) of each tick: every writing lane moves on."""
    toks, poss, wrs = [], [], []
    pos = POS0.copy()
    for t in range(TICKS):
        toks.append(((np.arange(B) * 13 + t * 5) % 500 + 3).tolist())
        poss.append(pos.tolist())
        wrs.append(WRITE.tolist())
        pos = pos + WRITE
    return toks, poss, wrs


def _cases(paths):
    two = [dict(op="decode", path=paths["dense"], mesh=(1, 1, 2), tokens=STEPS),
           dict(op="decode", path=paths["scaled"], mesh=(1, 1, 2), tokens=STEPS),
           dict(op="prefill", path=paths["dense"], mesh=(1, 1, 2), chunks=CHUNKS),
           dict(op="decode", path=paths["moe"], mesh=(1, 2, 1), tokens=STEPS),
           dict(op="decode", path=paths["int4"], mesh=(1, 1, 2), tokens=STEPS),
           dict(op="engine", path=paths["dense"], mesh=(1, 1, 2), prompt=PROMPT, steps=N_GEN)]
    toks, poss, wrs = tick_inputs()
    four = [dict(op="tick", path=paths["dense"], mesh=(2, 1, 2), tokens=toks, positions=poss,
                 write=wrs),
            dict(op="tick", path=paths["moe"], mesh=(1, 2, 2), tokens=toks, positions=poss,
                 write=wrs)]
    return two, four


def _spawn(world, cases, tmp, box):
    def go():
        try:
            box["res"] = run_ranks(WORKER, world, {"cases": cases}, str(tmp), timeout=240)
        except Exception as e:  # noqa: BLE001 -- re-raised in the test thread
            box["err"] = e
    th = threading.Thread(target=go)
    th.start()
    return th


def _joined(th, box):
    th.join(timeout=300)
    if "err" in box:
        raise box["err"]
    assert "res" in box, "the ranks did not finish"
    return box["res"]


def _jax_decode(path, mesh_shape, cfg):
    w = jax_load_weights(jax_read(path, native=False), cfg)
    dp, ep, tp = mesh_shape
    mesh = make_mesh(MeshConfig(dp=dp, ep=ep, tp=tp), devices=jax.devices()[:dp * ep * tp])
    sw = shard_fast_tp_weights(w, cfg, mesh)
    cache = shard_cache(JaxCache.init(cfg, jnp.bfloat16), cfg, mesh)
    step = jax.jit(make_decode_step_fast_tp(cfg, mesh), donate_argnums=(3,))
    rows = []
    for pos, tok in enumerate(STEPS):
        lg, cache = step(sw, jnp.int32(tok), jnp.int32(pos), cache)
        rows.append(np.asarray(lg))
    return np.stack(rows)


def _jax_decode_single(path, cfg):
    """JAX's single-device fast decode over STEPS."""
    fw = jax_load_fast(jax_read(path, native=False), cfg)
    cache = JaxCache.init(cfg, jnp.bfloat16)
    rows = []
    for pos, tok in enumerate(STEPS):
        lg, cache = jax_decode_one(cfg, fw, jnp.int32(tok), jnp.int32(pos), cache)
        rows.append(np.asarray(lg))
    return np.stack(rows)


def _jax_prefill(path, cfg):
    w = jax_load_weights(jax_read(path, native=False), cfg)
    mesh = make_mesh(MeshConfig(tp=2), devices=jax.devices()[:2])
    sw = shard_fast_tp_weights(w, cfg, mesh)
    cache = shard_cache(JaxCache.init(cfg, jnp.bfloat16), cfg, mesh)
    prefill = make_prefill_fast_tp(cfg, mesh)
    out = []
    for toks, pos0, valid, mode in CHUNKS:
        lg, cache = prefill(sw, jnp.asarray(toks, jnp.int32), jnp.int32(pos0),
                            jnp.int32(valid), cache, logits_mode=mode)
        out.append(None if lg is None else np.asarray(lg))
    return out


def _jax_tick(path, mesh_shape, cfg):
    w = jax_load_weights(jax_read(path, native=False), cfg)
    dp, ep, tp = mesh_shape
    mesh = make_mesh(MeshConfig(dp=dp, ep=ep, tp=tp), devices=jax.devices()[:dp * ep * tp])
    sw = shard_fast_tp_weights(w, cfg, mesh)
    cache = shard_cache(JaxCache.init(cfg, jnp.bfloat16, batch=B), cfg, mesh, batched=True)
    tick = jax.jit(make_tick_fast_tp(cfg, mesh))
    rows = []
    for toks, pos, wr in zip(*tick_inputs()):
        lg, cache = tick(sw, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32), cache,
                         jnp.asarray(wr, jnp.int32))
        rows.append(np.asarray(lg))
    return np.stack(rows)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results (rank by rank) and JAX's references."""
    from yalm_tpu.utils.testing import tiny_config as jax_tiny
    d = tmp_path_factory.mktemp("fast_tp")
    paths = {}
    for name, over in CONFIGS.items():
        paths[name] = str(d / f"{name}.yalm")
        synth_checkpoint(paths[name], tiny_config(**over), seed=21)
    two, four = _cases(paths)
    b2, b4 = {}, {}
    t2 = _spawn(2, two, d / "w2", b2)
    t4 = _spawn(4, four, d / "w4", b4)
    cfgs = {n: jax_tiny(**over) for n, over in CONFIGS.items()}
    ref = {"decode dense": _jax_decode(paths["dense"], (1, 1, 2), cfgs["dense"]),
           "decode scaled": _jax_decode(paths["scaled"], (1, 1, 2), cfgs["scaled"]),
           "prefill": _jax_prefill(paths["dense"], cfgs["dense"]),
           "decode moe": _jax_decode(paths["moe"], (1, 2, 1), cfgs["moe"]),
           "decode int4": _jax_decode(paths["int4"], (1, 1, 2), cfgs["int4"]),
           "decode int4 single": _jax_decode_single(paths["int4"], cfgs["int4"])}
    mesh = make_mesh(MeshConfig(tp=2), devices=jax.devices()[:2])
    eng = JaxEngine.from_checkpoint(paths["dense"], mesh=mesh, kv_dtype=jnp.bfloat16)
    ref["engine"] = list(eng.generate(PROMPT, max_steps=N_GEN, temperature=0.0, seed=0))
    ref["tick dense"] = _jax_tick(paths["dense"], (2, 1, 2), cfgs["dense"])
    ref["tick moe"] = _jax_tick(paths["moe"], (1, 2, 2), cfgs["moe"])
    return _joined(t2, b2), _joined(t4, b4), ref


def _held(got, want, what):
    """Each row: the argmax equal, the logits within the tolerance."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    for i in range(got.shape[0]):
        tol = LOGIT_TOL * max(1.0, float(np.abs(want[i]).max()))
        err = float(np.abs(got[i] - want[i]).max())
        assert err <= tol, (what, i, err, tol)
        assert (got[i].argmax(-1) == want[i].argmax(-1)).all(), (what, i)


def _near_tie_held(got, want, what):
    """Each row's argmax is want's, or within twice the tolerance of want's
    maximum."""
    for i, (g, w) in enumerate(zip(np.asarray(got), np.asarray(want))):
        tol = LOGIT_TOL * max(1.0, float(np.abs(w).max()))
        assert float(w.max() - w[int(g.argmax())]) <= 2 * tol, (what, i)


def _ranks_agree(res, k):
    for r in res[1:]:
        a, b = res[0][k], r[k]
        if isinstance(a, list):
            assert all((x is None and y is None) or np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("k,name", [(0, "decode dense"), (1, "decode scaled"),
                                    (3, "decode moe"), (4, "decode int4")])
def test_decode_matches_jax(runs, k, name):
    """tp=2 (ep=2 for MoE) decode over the ring and its sinks."""
    two, _, ref = runs
    _ranks_agree(two, k)
    if name == "decode int4":   # the single-device route: see the module docstring
        _held(two[0][k], ref["decode int4 single"], name)
        _near_tie_held(two[0][k], ref[name], name)
    else:
        _held(two[0][k], ref[name], name)


def test_prefill_matches_jax(runs):
    """tp=2 chunked prefill: the last row, every row, and a chunk without
    logits, each continuing the cache the last one wrote."""
    two, _, ref = runs
    _ranks_agree(two, 2)
    got = two[0][2]
    for i, (g, w) in enumerate(zip(got, ref["prefill"])):
        if w is None:
            assert g is None
        else:
            _held(np.asarray(g).reshape(-1, w.shape[-1]), w.reshape(-1, w.shape[-1]),
                  f"prefill chunk {i}")


def test_engine_on_mesh_matches_jax(runs):
    """Engine(mesh=) greedy tokens: JAX's mesh engine's, the same on both
    ranks."""
    two, _, ref = runs
    _ranks_agree(two, 5)
    assert two[0][5] == ref["engine"]


@pytest.mark.parametrize("k,name", [(0, "tick dense"), (1, "tick moe")])
def test_tick_matches_jax(runs, k, name):
    """The batched tick over dp=2 x tp=2 (dense) and ep=2 x tp=2 (MoE, every
    local expert swept), lanes past the window and a write-masked lane."""
    _, four, ref = runs
    _ranks_agree(four, k)
    got = np.asarray(four[0][k])
    for t in range(TICKS):
        _held(got[t], ref[name][t], f"{name} tick {t}")
