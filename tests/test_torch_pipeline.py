"""The port's pipeline-parallel tick (yalm_tpu_torch/parallel/pipeline.py)
in spawned gloo ranks on the CPU, against the JAX package's
(yalm_tpu/parallel/pipeline.py) on the virtual 8-device mesh (conftest),
on the same checkpoints: JAX's own cases (tests/test_pipeline.py:47-55,
:83, tests/test_int4.py:333, tests/test_qwen3.py:152) -- pp=2 at B=16 and
pp=4 at B=32 after a hydrating tick (the port's single-device tick, whose
cache both packages start from), embed_scale 8, Gemma2 and Gemma3 over
four layers (per-layer windows and dual rope indexed by the GLOBAL layer),
packed int4 over an e5m2 cache, the 6-tick greedy stream with 2 idle lanes
at pp=4 -- and bad shapes refused.

Bounds: every tick's logits within 1e-2 of max(1, max|logit|) of JAX's
pipelined tick's, the argmax equal (tests/test_torch_fast_tp.py's rule),
every rank the same logits bits; the greedy stream equal to JAX's; each
stage's cache rows against JAX's at its layers by JAX's own bound for rows
written on a mesh (rtol 3e-2, atol 4e-2: tests/test_ring.py:78-84), and on
an e5m2 cache one e5m2 step of the element's magnitude beyond it (values
inside the bf16 bound round to neighbouring e5m2 bytes). Byte equality
(tests/test_torch_paged_mesh.py's pool_holds, two layers) does not hold
here: the CPU's f32 matmul sums in an order that depends on the row count
(a microbatch of B/pp rows against JAX's), the bf16 roundings of the
activations flip, and over four layers the later layers' rows part by
bf16 steps of their elements (PR 16's item 15: rounding grown over depth).

The ranks run `yalm_tpu_torch.utils.testing.mesh_cases` ("pp") in fresh
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
from yalm_tpu.models.cache import KVCache as JaxCache
from yalm_tpu.models.fast import load_fast_weights as jax_load_fast
from yalm_tpu.parallel.pipeline import make_tick_pp as jax_make_tick
from yalm_tpu.parallel.pipeline import shard_pp_cache as jax_shard_cache
from yalm_tpu.parallel.pipeline import shard_pp_weights as jax_shard_weights
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.config import ModelConfig
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import decode_step_fast_batched, load_fast_weights
from yalm_tpu_torch.ops.core import int_view
from yalm_tpu_torch.parallel.mesh import grid_mesh
from yalm_tpu_torch.parallel.pipeline import make_tick_pp, pp_supported, pp_weight_splits
from yalm_tpu_torch.utils.testing import run_ranks, synth_checkpoint, tiny_config

LOGIT_TOL = 1e-2
WORKER = "yalm_tpu_torch.utils.testing:mesh_cases"


def fast_kw(**over):
    """tests/test_pipeline.py:25's: fast_config at a window of 64, four layers."""
    base = dict(dim=256, hidden_dim=512, head_dim=128, n_layers=4, n_heads=4, n_kv_heads=2,
                vocab_size=512, max_seq_len=64, rotary_dim=128, qkv_clip=30.0)
    base.update(over)
    return base


GEMMA2 = dict(embed_scale=16.0, has_post_norms=True, attn_softcap=50.0, final_softcap=30.0,
              sliding_window=16, layer_sliding=(1, 0, 1, 0), act_type="gelu")
GEMMA3 = dict(embed_scale=16.0, has_post_norms=True, has_qk_norm=True, sliding_window=16,
              layer_sliding=(1, 0, 1, 0), act_type="gelu", rope_theta=1e6,
              rope_scale=("gemma3", 2.0, 1e4))
INT4 = dict(hidden_dim=1024, n_heads=8, n_kv_heads=4, weight_dtype="int4")
CONFIGS = {"dense": fast_kw(), "scaled": fast_kw(embed_scale=8.0), "gemma2": fast_kw(**GEMMA2),
           "gemma3": fast_kw(**GEMMA3), "int4": fast_kw(**INT4)}
STREAM_TICKS = 6


def one_tick(B, seed):
    """tests/test_pipeline.py:58's inputs: tokens, positions < 20, a
    hydrating tick's tokens; every lane writes."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, 512, B).tolist()
    pos = rng.integers(0, 20, B).tolist()
    return dict(tokens=toks, hydrate=rng.integers(3, 512, B).tolist(),
                ticks=[(pos, [1] * B)])


def stream(B):
    """tests/test_pipeline.py:89's: 6 greedy ticks from position 0, the last
    two lanes idle (read-only)."""
    write = [1] * (B - 2) + [0, 0]
    return dict(tokens=[1 + (i % 5) for i in range(B)], greedy=True,
                ticks=[([s] * B, write) for s in range(STREAM_TICKS)])


# (name, config, pp, B, cache, inputs)
TWO = [("dense_pp2", "dense", 2, 16, "bf16", one_tick(16, 0)),
       ("scaled_pp2", "scaled", 2, 16, "bf16", one_tick(16, 1)),
       ("gemma2_pp2", "gemma2", 2, 16, "bf16", one_tick(16, 2)),
       ("gemma3_pp2", "gemma3", 2, 16, "bf16", one_tick(16, 3)),
       ("int4_e5m2_pp2", "int4", 2, 16, "fp8", one_tick(16, 4))]
FOUR = [("dense_pp4", "dense", 4, 32, "bf16", one_tick(32, 5)),
        ("stream_pp4", "dense", 4, 16, "bf16", stream(16))]
JAX_KV = {"bf16": jnp.bfloat16, "fp8": jnp.float8_e5m2}


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


def hydrated(path, B, kv, tokens):
    """The (k, v) bytes of a whole batched cache after one single-device
    tick of `tokens` at position 0 (the port's decode_step_fast_batched):
    the history the compared tick attends to, the same bytes for both
    packages, so that the cache rows compared are the pipelined tick's
    own."""
    yf = read_yalm(path)
    cfg = ModelConfig.from_metadata(yf.metadata)
    fw = load_fast_weights(yf, cfg, "cpu")
    yf.close()
    cache = KVCache.init(cfg, {"bf16": torch.bfloat16, "fp8": torch.float8_e5m2}[kv], "cpu",
                         batch=B)
    decode_step_fast_batched(cfg, fw, tokens, [0] * B, cache, [1] * B)
    return int_view(cache.k).numpy(), int_view(cache.v).numpy()


def _jax_pp(path, cfg, pp, B, kv, inp):
    """JAX's pipelined tick on the virtual ('pp',) mesh over the same
    inputs from the same starting cache: every tick's logits and the final
    global cache."""
    fw = jax_load_fast(jax_read(path, native=False), cfg)
    cache = JaxCache.init(cfg, JAX_KV[kv], batch=B)
    if inp.get("cache") is not None:
        cache = JaxCache(*(jnp.asarray(a).view(JAX_KV[kv]) for a in inp["cache"]))
    mesh = jax.make_mesh((pp,), ("pp",), devices=jax.devices()[:pp])
    pw = jax_shard_weights(fw, cfg, mesh)
    pc = jax_shard_cache(cache, mesh)
    tick = jax.jit(jax_make_tick(cfg, mesh, B, with_scales=fw.scales is not None))
    toks, rows = jnp.asarray(inp["tokens"], jnp.int32), []
    for pos, wr in inp["ticks"]:
        lg, pc = tick(pw, toks, jnp.asarray(pos, jnp.int32), pc, jnp.asarray(wr, jnp.int32))
        rows.append(np.asarray(lg))
        if inp.get("greedy"):
            toks = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    return {"logits": np.stack(rows), "k": np.asarray(jax.device_get(pc.k)),
            "v": np.asarray(jax.device_get(pc.v))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    paths = {}
    for name, over in CONFIGS.items():
        paths[name] = str(d / f"{name}.yalm")
        synth_checkpoint(paths[name], tiny_config(**over), seed=101)
    inputs = {name: dict(inp, cache=hydrated(paths[c], B, kv, inp["hydrate"])
                         if "hydrate" in inp else None)
              for name, c, pp, B, kv, inp in TWO + FOUR}

    def cases(table):
        return [dict(op="pp", path=paths[c], axes={"pp": pp}, B=B, kv=kv, **inputs[name])
                for name, c, pp, B, kv, _ in table]
    b2, b4 = {}, {}
    t2 = _spawn(2, cases(TWO), d / "w2", b2)
    t4 = _spawn(4, cases(FOUR), d / "w4", b4)
    ref = {name: _jax_pp(paths[c], jax_tiny(**CONFIGS[c]), pp, B, kv, inputs[name])
           for name, c, pp, B, kv, _ in TWO + FOUR}
    res = {}
    for table, (th, box) in ((TWO, (t2, b2)), (FOUR, (t4, b4))):
        ranks = _joined(th, box)
        for k, row in enumerate(table):
            res[row[0]] = [r[k] for r in ranks]
    return res, ref


def rows_hold(got: np.ndarray, want: np.ndarray, kv: str, what) -> None:
    """Cache bytes (integer views) within rtol 3e-2, atol 4e-2 of JAX's
    (tests/test_ring.py:78-84), plus one step of the cache type on e5m2."""
    dt = torch.bfloat16 if kv == "bf16" else torch.float8_e5m2
    a = torch.from_numpy(got.copy()).view(dt).float()
    b = torch.from_numpy(want.view(got.dtype).copy()).view(dt).float()
    bound = 3e-2 * b.abs() + 4e-2
    if kv == "fp8":
        bound = bound + torch.ldexp(torch.ones_like(b), torch.frexp(b.abs()).exponent - 3)
    excess = float(((a - b).abs() - bound).max())
    assert excess <= 0, (what, excess)


def _held(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    for i in range(got.shape[0]):
        tol = LOGIT_TOL * max(1.0, float(np.abs(want[i]).max()))
        err = float(np.abs(got[i] - want[i]).max())
        assert err <= tol, (what, i, err, tol)
        assert int(got[i].argmax()) == int(want[i].argmax()), (what, i)


@pytest.mark.parametrize("name,cfg_name,pp,B,kv,inp", TWO + FOUR,
                         ids=[t[0] for t in TWO + FOUR])
def test_pp_tick_matches_jax(runs, name, cfg_name, pp, B, kv, inp):
    """Every tick's logits on every rank, each stage's cache rows at its
    layers, and (the stream) the greedy tokens, against JAX's pipelined
    tick."""
    res, ref = runs
    ranks, want = res[name], ref[name]
    for r in ranks[1:]:
        assert np.array_equal(r["logits"], ranks[0]["logits"]), name
    for t, (g, w) in enumerate(zip(ranks[0]["logits"], want["logits"])):
        _held(g, w, f"{name} tick {t}")
    if inp.get("greedy"):
        assert np.array_equal(ranks[0]["logits"].argmax(-1), want["logits"].argmax(-1)), name
    nl_l = CONFIGS[cfg_name]["n_layers"] // pp
    for p, r in enumerate(ranks):
        for c in ("k", "v"):
            rows_hold(r[c], np.ascontiguousarray(want[c][:, p * nl_l:(p + 1) * nl_l]), kv,
                      f"{name} stage {p} {c}")


def test_pp_rejects_bad_shapes():
    """tests/test_pipeline.py:113: layers or lanes that do not split pp
    ways, and MoE, are refused (pp_supported, make_tick_pp); the tick wants
    a ('pp',) mesh; the int4 group scales split on their layer axis."""
    cfg3 = tiny_config(**fast_kw(n_layers=3))
    assert not pp_supported(cfg3, 2, 16)
    cfg = tiny_config(**fast_kw())
    assert pp_supported(cfg, 4, 32) and not pp_supported(cfg, 4, 30)
    moe = dataclasses.replace(cfg, n_experts=4, n_experts_active=2)
    assert not pp_supported(moe, 2, 16)
    with pytest.raises(ValueError, match="does not take"):
        make_tick_pp(cfg, grid_mesh({"pp": 4}, 0), 30)
    with pytest.raises(ValueError, match="'pp',"):
        make_tick_pp(cfg, grid_mesh({"sp": 2}, 0), 16)
    table = pp_weight_splits(tiny_config(**fast_kw(**INT4)), with_scales=True)
    assert table["scales"]["wqkv"] == ((0, "pp"),) and table["scales"]["embed"] == ()
    assert table["embed"] == table["lm_head"] == table["final_norm"] == ()
