"""The port's continuous-batching forward passes on the CPU (plain versions)
against the JAX package's (emulation branches) on the same inputs: the
batched attention step (K8), the many-row FFN (K4/K7), the batched tick
and the batched chunk admission.

Tolerances: the batched attention's written rows are exact (one f32 ->
cache-type rounding of the same f32 values), its output within 2e-3 of
max(1, max|ref|); the FFN within 2e-3 (summation
order, rare bf16 flips of a GLU output); whole-model logits and caches
within 1e-2 of max(1, max|ref|) (tests/test_torch_fast.py says why).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.models.cache import KVCache as JaxCache
from yalm_tpu.models.fast import decode_step_fast_batched as jax_tick
from yalm_tpu.models.fast import prefill_chunk_fast_batched as jax_chunk
from yalm_tpu.ops.pallas.attention import attend_step_batched_l as jax_attend
from yalm_tpu.ops.pallas.ffn import ffn4_l as jax_ffn4_l
from yalm_tpu.ops.pallas.ffn import ffn_l as jax_ffn_l
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import decode_step_fast_batched, prefill_chunk_fast_batched
from yalm_tpu_torch.ops.cuda.attention import attend_step_batched_l
from yalm_tpu_torch.ops.cuda.ffn import ffn_plain
from yalm_tpu_torch.utils.testing import tiny_config

from test_torch_fast import both_weights, close, fast_kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}

# per-lane (kv_pos, kv_len, kv_sink, pos, write): tests/test_batched_attn_kernel.py's
# mixed regimes (ring + sinks, write-masked lanes, several tiles per lane)
CASES = [
    dict(kv_pos=[0, 5, 31, 2], kv_len=[1, 6, 32, 32], kv_sink=[0, 0, 0, 2],
         pos=[0, 5, 31, 40], write=[1, 1, 1, 1]),
    dict(kv_pos=[9, 2, 17, 25], kv_len=[10, 32, 18, 26],
         kv_sink=[0, 2, 0, 0], pos=[9, 35, 17, 25], write=[1, 0, 1, 0]),
    dict(kv_pos=[15, 7, 23, 31], kv_len=[16, 8, 24, 32],
         kv_sink=[0, 0, 0, 0], pos=[15, 7, 23, 31], write=[1, 1, 0, 1]),
]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16).numpy()


@pytest.mark.parametrize("kv,case", [("bf16", 0), ("bf16", 1), ("bf16", 2), ("e5m2", 1)])
def test_attend_step_batched_plain_matches_jax(kv, case):
    jdt, tdt = KV[kv]
    rng = np.random.default_rng(5)
    B, L, S, Hk, qpk, D = 4, 3, 32, 2, 2, 128
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hk, qpk, D), (B, Hk, D), (B, Hk, D)))
    k0, v0 = (np.asarray(jnp.asarray(rng.standard_normal((B, L, S, Hk, D)) * 0.3, jdt))
              for _ in range(2))
    scal = [CASES[case][k] for k in ("kv_pos", "kv_len", "kv_sink", "pos", "write")]
    kw = dict(kv_sinks=2, theta=1e4, rotary_dim=D)
    want, jk, jv = jax_attend(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                              jnp.asarray(k0), jnp.asarray(v0), jnp.int32(1),
                              *[jnp.asarray(s, jnp.int32) for s in scal], **kw)
    tc = KVCache.from_numpy(k0, v0)
    got = attend_step_batched_l(torch.from_numpy(q), torch.from_numpy(kn),
                                torch.from_numpy(vn), tc.k, tc.v, 1, *scal, **kw)
    close(got, want, 2e-3)
    want_c = KVCache.from_numpy(np.asarray(jk), np.asarray(jv))
    for t, w in ((tc.k, want_c.k), (tc.v, want_c.v)):
        np.testing.assert_array_equal(_bits(t), _bits(w))
    # write-masked lanes change nothing, anywhere
    for b in np.flatnonzero(np.asarray(scal[4]) == 0):
        assert torch.equal(tc.k[b], KVCache.from_numpy(k0, v0).k[b])


@pytest.mark.parametrize("wdt", ["fp8", "int4"])
def test_ffn_sixteen_rows_matches_jax(tmp_path, wdt):
    kw = fast_kw(weight_dtype=wdt)
    path = str(tmp_path / "m.yalm")
    jax_synth(path, jax_tiny(**kw), seed=2)
    jw, tw = both_weights(path, jax_tiny(**kw))
    x = np.random.default_rng(4).standard_normal((16, kw["dim"])).astype(np.float32) * 3
    fk = dict(norm_eps=1e-5, act="silu")
    if wdt == "int4":
        want = jax_ffn4_l(jnp.asarray(x), jw.rms_ffn, jw.w13, jw.w2, 1, jw.scales.w13,
                          jw.scales.w2, **fk)
    else:
        want = jax_ffn_l(jnp.asarray(x), jw.rms_ffn, jw.w13, jw.w2, 1, **fk)
    sc = tw.scales
    got = ffn_plain(torch.from_numpy(x), tw.rms_ffn, tw.w13, tw.w2, 1,
                    sc.w13 if sc else None, sc.w2 if sc else None, **fk)
    close(got, want, 2e-3)


# (weights, qkv bias, cache): every weight type of the slice on both caches
MODELS = [("fp8", False, "bf16"), ("fp8", False, "e5m2"), ("int8", True, "bf16"),
          ("int4", False, "e5m2")]


@pytest.mark.parametrize("wdt,bias,kv", MODELS)
def test_batched_chunk_and_ticks_match_jax(tmp_path, wdt, bias, kv):
    """One batched chunk sweep (three lanes at different offsets, one
    disabled), then teacher-forced ticks with a write-masked lane and a
    lane that crosses the ring (window 32), on caches that start random."""
    kw = fast_kw(weight_dtype=wdt, has_qkv_bias=bias)
    jcfg, cfg = jax_tiny(**kw), tiny_config(**kw)
    path = str(tmp_path / "m.yalm")
    jax_synth(path, jcfg, seed=3)
    jw, tw = both_weights(path, jcfg)
    jdt, tdt = KV[kv]
    rng = np.random.default_rng(9)
    B, T = 4, 16
    shape = (B, cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = (np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.5, jdt)) for _ in range(2))
    jc = JaxCache(k=jnp.asarray(k0), v=jnp.asarray(v0))
    tc = KVCache.from_numpy(k0, v0)

    toks = rng.integers(3, cfg.vocab_size, (B, T)).astype(np.int32)
    pos0, valid, enable = [0, 8, 16, 0], [16, 5, 11, 0], [1, 1, 1, 0]
    want, jc = jax_chunk(jcfg, jw, jnp.asarray(toks), jnp.asarray(pos0, jnp.int32),
                         jnp.asarray(valid, jnp.int32), jnp.asarray(enable, jnp.int32), jc,
                         attend_len=32, logits_mode="lastv")
    got, tc = prefill_chunk_fast_batched(cfg, tw, toks, pos0, valid, enable, tc,
                                         attend_len=32, logits_mode="lastv")
    assert got.shape == want.shape == (B, cfg.vocab_size)
    close(got[:3], np.asarray(want)[:3])

    positions = np.array([16, 13, 29, 6])
    write = np.array([1, 1, 1, 0])              # lane 3 attends read-only
    for step in range(5):                        # lane 2 goes 29 -> 33: ring + sinks
        tok = rng.integers(3, cfg.vocab_size, B).astype(np.int32)
        want, jc = jax_tick(jcfg, jw, jnp.asarray(tok), jnp.asarray(positions, jnp.int32),
                            jc, jnp.asarray(write, jnp.int32))
        got, tc = decode_step_fast_batched(cfg, tw, tok, positions, tc, write)
        close(got, want)
        positions = positions + write
    wc = KVCache.from_numpy(np.asarray(jc.k), np.asarray(jc.v))
    close(tc.k.float(), wc.k.float().numpy())
    close(tc.v.float(), wc.v.float().numpy())
    assert torch.equal(tc.k[3], KVCache.from_numpy(k0, v0).k[3])   # disabled + read-only


def test_batched_paths_refuse_bad_lanes():
    cfg = tiny_config(**fast_kw())
    from yalm_tpu_torch.models.fast import FastWeights
    fw = FastWeights(*(torch.zeros(1),) * 9)
    cache = KVCache.init(cfg, torch.bfloat16, "cpu", batch=2)
    with pytest.raises(ValueError, match="chunks at"):
        prefill_chunk_fast_batched(cfg, fw, np.zeros((2, 16), np.int64), [0, 20], [1, 1],
                                   [1, 1], cache)
    with pytest.raises(ValueError, match="lanes"):
        decode_step_fast_batched(cfg, fw, [1, 2, 3], [0, 1, 2], cache)
    with pytest.raises(ValueError, match="out of range"):
        attend_step_batched_l(torch.zeros(2, 2, 2, 128), torch.zeros(2, 2, 128),
                              torch.zeros(2, 2, 128), cache.k, cache.v, 0, [0, 0], [0, 1],
                              [0, 0], [0, 0], kv_sinks=2, theta=1e4, rotary_dim=128)
    cfg2 = dataclasses.replace(cfg, attn_softcap=30.0)
    with pytest.raises(NotImplementedError):
        decode_step_fast_batched(cfg2, fw, [1, 2], [0, 1], cache)
