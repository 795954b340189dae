"""The port's packed-int4 path on the CPU (plain versions) against the JAX
package: the packing helpers and the checkpoint fixture byte for byte,
each int4 kernel wrapper against the JAX function on the same numpy
inputs, and the whole slice (int4 weights, e5m2 cache) against the JAX
fast path on the same checkpoint.

Tolerances, relative to max(1, the largest reference magnitude):
- EXACT_TOL (2e-5): the same bf16 operands and f32 sums, in another order
  (plus, after a fused rmsnorm or the GLU, a rare one-ulp bf16 flip).
- INTERPRET_TOL (1e-4): the Pallas kernel in interpret mode, which sums
  unsigned nibbles and subtracts 8*sum(x) (dot4_tile), as tests/test_int4.py.
- LOGIT_TOL (1e-2): whole-model logits (see tests/test_torch_fast.py).
- An e5m2 cache written by the whole model holds activations: an f32
  last-bit difference upstream flips the e5m2 rounding of a rare element by
  one e5m2 ulp (a quarter of its value at most), and attention carries that
  into later rows at the logits' ~1e-2. So those caches agree element for
  element except in under 1% of the elements, each within one e5m2 ulp or
  LOGIT_TOL of the largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.engine import Engine as JaxEngine
from yalm_tpu.models.cache import KVCache as JaxCache
from yalm_tpu.models.fast import decode_step_fast as jax_decode
from yalm_tpu.models.fast import prefill_fast as jax_prefill
from yalm_tpu.ops.pallas import block as jblock
from yalm_tpu.ops.pallas import ffn as jffn
from yalm_tpu.ops.pallas import gemv as jgemv
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch import cli
from yalm_tpu_torch.codec.format import numpy_to_torch, tag_for_numpy
from yalm_tpu_torch.engine import Engine
from yalm_tpu_torch.models import fast
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import decode_step_fast, prefill_fast
from yalm_tpu_torch.ops import int4
from yalm_tpu_torch.ops.cuda.block import attn_block4_l
from yalm_tpu_torch.ops.cuda.ffn import ffn4_l
from yalm_tpu_torch.ops.cuda.gemv import gemm4, gemm4_l, gemv4, gemv4_l
from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config

from test_torch_fast import both_weights, cache_close, close

EXACT_TOL = 2e-5
INTERPRET_TOL = 1e-4
LOGIT_TOL = 1e-2
E5M2 = {"bf16": (jnp.bfloat16, torch.bfloat16), "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


def i4kw(**overrides):
    """tests/test_int4.py:_i4cfg: dim 256, head_dim 128, window 64."""
    kw = dict(dim=256, hidden_dim=512, head_dim=128, n_layers=2, n_heads=4,
              n_kv_heads=2, vocab_size=512, max_seq_len=64, rotary_dim=128,
              qkv_clip=30.0, weight_dtype="int4")
    kw.update(overrides)
    return kw


def tt(a):
    a = np.asarray(a)
    return numpy_to_torch(a, tag_for_numpy(a))


def rel_close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def kv_cache_close(got, want):
    """A model-written cache: bf16 by test_torch_fast's rule, e5m2 up to
    rare one-ulp flips (see the module docstring)."""
    if got.dtype != torch.float8_e5m2:
        return cache_close(got, want)
    g, r = got.float().numpy(), np.asarray(want, np.float32)
    flips = g != r
    assert flips.mean() < 0.01, flips.mean()
    bound = np.maximum(0.25 * np.abs(r), LOGIT_TOL * max(1.0, float(np.abs(r).max())))
    assert (np.abs(g - r) <= bound).all(), float(np.abs(g - r).max())


def packed(rng, *shape):
    """(packed uint8 (..., N, K/2), group scales (..., G, N)) of random weights."""
    return jgemv.pack_int4(rng.standard_normal(shape).astype(np.float32) * 0.05)


# ---------------------------------------------------------------------------
# helpers and the checkpoint fixture, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 256, 512), (2, 128, 768), (64, 14336 // 8 * 8)])
def test_pack_and_unpack_match_jax(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 0.05
    K = shape[-1]
    assert int4.int4_group(K) == jgemv.int4_group(K)
    assert int4.int4_supported(shape[-2], K) == jgemv.int4_supported(shape[-2], K)
    p, s = int4.pack_int4(w)
    jp, js = jgemv.pack_int4(w)
    assert p.dtype == np.uint8 and p.tobytes() == jp.tobytes()
    assert s.dtype == np.float32 and s.tobytes() == js.tobytes()
    np.testing.assert_array_equal(int4.unpack_int4(p, s), jgemv.unpack_int4(jp, js))


@pytest.mark.parametrize("overrides", [dict(has_qkv_bias=True), dict(dim=768, hidden_dim=512)])
def test_synth_checkpoint_int4_bytes_match_jax(tmp_path, overrides):
    """The K = 768 case has groups of 256, G = 3."""
    p_port, p_jax = str(tmp_path / "port.yalm"), str(tmp_path / "jax.yalm")
    synth_checkpoint(p_port, tiny_config(**i4kw(**overrides)), seed=4)
    jax_synth(p_jax, jax_tiny(**i4kw(**overrides)), seed=4)
    with open(p_port, "rb") as a, open(p_jax, "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# K5: gemm4_l / gemv4_l / gemm4 / gemv4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N,K,interpret", [(1, 384, 256, None), (5, 384, 768, None),
                                             (16, 512, 1024, None), (4, 256, 512, True)])
def test_gemm4_l(B, N, K, interpret):
    rng = np.random.default_rng(K + B)
    w, s = packed(rng, 3, N, K)
    x = rng.standard_normal((B, K)).astype(np.float32) * 2
    for layer in (0, 2):
        want = jgemv.gemm4_l(jnp.asarray(x), jnp.asarray(w), jnp.int32(layer), jnp.asarray(s),
                             interpret=interpret)
        got = gemm4_l(torch.from_numpy(x), tt(w), layer, tt(s))
        rel_close(got, want, INTERPRET_TOL if interpret else EXACT_TOL)


@pytest.mark.parametrize("K", [256, 768])
def test_gemv4_and_2d_forms(K):
    rng = np.random.default_rng(K)
    w, s = packed(rng, 2, 384, K)
    x = rng.standard_normal(K).astype(np.float32)
    want = jgemv.gemv4_l(jnp.asarray(x), jnp.asarray(w), jnp.int32(1), jnp.asarray(s))
    rel_close(gemv4_l(torch.from_numpy(x), tt(w), 1, tt(s)), want, EXACT_TOL)
    want = jgemv.gemv4(jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(s[0]))
    rel_close(gemv4(torch.from_numpy(x), tt(w[0]), tt(s[0])), want, EXACT_TOL)
    x3 = np.stack([x, -x, 2 * x])
    want = jgemv.gemm4(jnp.asarray(x3), jnp.asarray(w[1]), jnp.asarray(s[1]))
    rel_close(gemm4(torch.from_numpy(x3), tt(w[1]), tt(s[1])), want, EXACT_TOL)


def test_int4_wrappers_refuse_other_weights():
    x, w = torch.zeros(4, 256), torch.zeros(2, 32, 256)
    with pytest.raises(ValueError, match="packed"):
        gemm4_l(x, w, 0, torch.zeros(2, 1, 32))
    with pytest.raises(ValueError, match="K % 256"):
        gemm4_l(torch.zeros(4, 200), torch.zeros(2, 32, 100, dtype=torch.uint8), 0,
                torch.zeros(2, 1, 32))


# ---------------------------------------------------------------------------
# K6: attn_block4_l, K7: ffn4_l
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos,bias,kv,dim", [(0, False, "e5m2", 256), (11, True, "bf16", 256),
                                             (21, False, "e5m2", 768), (70, True, "e5m2", 256)])
def test_attn_block4_l(pos, bias, kv, dim):
    L, S, Hk, qpk, D = 3, 16, 2, 2, 128
    Hq = Hk * qpk
    Nqkv = (Hq + 2 * Hk) * D
    rng = np.random.default_rng(4 + pos)
    x = rng.standard_normal(dim).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal((L, dim))).astype(np.float32)
    wqkv, sqkv = packed(rng, L, Nqkv, dim)
    wo, so = packed(rng, L, dim, Hq * D)
    b = (rng.standard_normal((L, Nqkv)) * 0.2).astype(np.float32) if bias else None
    jdt, _ = E5M2[kv]
    k_all = jnp.asarray(rng.standard_normal((L, S, Hk, D)).astype(np.float32)).astype(jdt)
    v_all = jnp.asarray(rng.standard_normal((L, S, Hk, D)).astype(np.float32)).astype(jdt)
    kv_sink, kv_pos, kv_len = fast.ring_slots(pos, S)
    kw = dict(n_heads=Hq, kv_sinks=2, theta=1e4, rotary_dim=D, norm_eps=1e-5, qkv_clip=4.0)
    want, wk, wv = jblock.attn_block4_l(
        jnp.asarray(x), jnp.asarray(nw), jnp.asarray(wqkv), jnp.asarray(wo), k_all, v_all,
        jnp.int32(2), jnp.int32(kv_pos), jnp.int32(kv_len), jnp.int32(kv_sink), jnp.int32(pos),
        scale_qkv=jnp.asarray(sqkv), scale_o=jnp.asarray(so),
        bqkv_all=None if b is None else jnp.asarray(b), **kw)
    tk, tv = tt(k_all), tt(v_all)
    got = attn_block4_l(torch.from_numpy(x), torch.from_numpy(nw), tt(wqkv), tt(wo), tk, tv,
                        2, kv_pos, kv_len, kv_sink, pos, scale_qkv=tt(sqkv), scale_o=tt(so),
                        bqkv_all=None if b is None else torch.from_numpy(b), **kw)
    rel_close(got, want, EXACT_TOL)
    # the written rows: e5m2 byte for byte; bf16 within one ulp (RoPE's f32)
    for t, w in ((tk, wk), (tv, wv)):
        g, r = t.float().numpy(), np.asarray(w, np.float32)
        if kv == "e5m2":
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("act,B,K,H", [("silu", 1, 256, 512), ("gelu", 3, 256, 768),
                                       ("silu", 1, 768, 512), ("silu", 4, 512, 1536)])
def test_ffn4_l(act, B, K, H):
    L = 2
    rng = np.random.default_rng(5 + B)
    x = rng.standard_normal((B, K) if B > 1 else (K,)).astype(np.float32) * 2
    nw = (1.0 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    w13, s13 = packed(rng, L, 2 * H, K)
    w2, s2 = packed(rng, L, K, H)
    want = jffn.ffn4_l(jnp.asarray(x), jnp.asarray(nw), jnp.asarray(w13), jnp.asarray(w2),
                       jnp.int32(1), jnp.asarray(s13), jnp.asarray(s2), norm_eps=1e-5, act=act)
    got = ffn4_l(torch.from_numpy(x), torch.from_numpy(nw), tt(w13), tt(w2), 1, tt(s13),
                 tt(s2), norm_eps=1e-5, act=act)
    rel_close(got, want, EXACT_TOL)


# ---------------------------------------------------------------------------
# the slice: int4 weights and the e5m2 cache through decode, prefill, Engine, CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt4(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt4") / "m4.yalm")
    synth_checkpoint(path, tiny_config(**i4kw()), seed=0)
    return path


def test_load_fast_weights_int4(ckpt4):
    """The port's loader gives the JAX loader's arrays: packed uint8 rows,
    group scales concatenated along N, int8 embedding and head."""
    from yalm_tpu_torch.codec.format import read_yalm
    cfg = tiny_config(**i4kw())
    jw, tw_np = both_weights(ckpt4, jax_tiny(**i4kw()))
    yf = read_yalm(ckpt4)
    tw = fast.load_fast_weights(yf, cfg, "cpu")
    yf.close()
    assert tw.wqkv.dtype == torch.uint8 and tuple(tw.wqkv.shape) == (2, 1024, 128)
    assert tuple(tw.scales.w13.shape) == (2, 1, 1024) and tw.embed.dtype == torch.int8
    for name in ("embed", "rms_att", "wqkv", "wo", "w13", "w2", "lm_head"):
        assert torch.equal(getattr(tw, name), getattr(tw_np, name)), name
    for name in ("embed", "wqkv", "wo", "w13", "w2", "lm_head"):
        assert torch.equal(getattr(tw.scales, name), getattr(tw_np.scales, name)), name


@pytest.mark.parametrize("wdt,kv,bias", [("int4", "e5m2", False), ("int4", "bf16", True),
                                         ("fp8", "e5m2", False)])
def test_decode_step_fast_across_the_ring(tmp_path, wdt, kv, bias):
    kw = i4kw(weight_dtype=wdt, has_qkv_bias=bias, max_seq_len=32)
    path = str(tmp_path / "m.yalm")
    jax_synth(path, jax_tiny(**kw), seed=1)
    cfg = tiny_config(**kw)
    jw, tw = both_weights(path, jax_tiny(**kw))
    jdt, tdt = E5M2[kv]
    jc = JaxCache.init(jax_tiny(**kw), jdt)
    tc = KVCache.init(cfg, tdt, "cpu")
    tok = 5
    for pos in range(cfg.max_seq_len + 8):   # past the window: ring + sinks
        want, jc = jax_decode(jax_tiny(**kw), jw, jnp.int32(tok), jnp.int32(pos), jc)
        got, tc = decode_step_fast(cfg, tw, tok, pos, tc)
        close(got, want)
        tok = int(np.argmax(np.asarray(want)))
    assert tc.k.dtype == tdt
    kv_cache_close(tc.k, jc.k)
    kv_cache_close(tc.v, jc.v)


@pytest.mark.parametrize("mode", ["last", "all"])
def test_prefill_fast_int4_e5m2(ckpt4, mode):
    jcfg, cfg = jax_tiny(**i4kw()), tiny_config(**i4kw())
    jw, tw = both_weights(ckpt4, jcfg)
    jc = JaxCache.init(jcfg, jnp.float8_e5m2)
    tc = KVCache.init(cfg, torch.float8_e5m2, "cpu")
    rng = np.random.default_rng(3)
    # chunk 1: 13 valid of 16 at 0 (width 16); chunk 2: 40 of 64 at 13 (64)
    for pos0, valid, T, attend, m in ((0, 13, 16, 16, "none"), (13, 40, 64, 64, mode)):
        toks = rng.integers(3, cfg.vocab_size, T).astype(np.int32)
        if pos0 + T > attend:
            toks, T = toks[:attend - pos0], attend - pos0
        want, jc = jax_prefill(jcfg, jw, jnp.asarray(toks), jnp.int32(pos0),
                               jnp.int32(valid), jc, logits_mode=m, attend_len=attend)
        got, tc = prefill_fast(cfg, tw, toks, pos0, valid, tc, logits_mode=m,
                               attend_len=attend)
        if m == "none":
            assert got is None and want is None
        else:
            assert tuple(got.shape) == want.shape
            close(got, want)
    kv_cache_close(tc.k, jc.k)
    kv_cache_close(tc.v, jc.v)


def test_engine_int4_e5m2_greedy_stream_and_perplexity(ckpt4):
    je = JaxEngine.from_checkpoint(ckpt4, kv_dtype=jnp.float8_e5m2)
    te = Engine.from_checkpoint(ckpt4, device="cpu", kv_dtype=torch.float8_e5m2)
    assert te.cache.k.dtype == torch.float8_e5m2
    prompt = list(range(3, 73))   # 70 tokens: 64 chunked, 6 hydrated in the ring
    want = list(je.generate(prompt, max_steps=10, temperature=0.0))
    got = list(te.generate(prompt, max_steps=10, temperature=0.0))
    assert got == want
    je.reset()
    te.reset()
    toks = [1] + list(range(40, 100))
    jp, je_err, jn = je.perplexity(toks)
    tp, te_err, tn = te.perplexity(toks)
    assert tn == jn
    assert abs(tp - jp) <= 1e-3 * jp and abs(te_err - je_err) <= 1e-3 * je_err


def test_cli_int4_with_fp8_cache(ckpt4, capsysbinary):
    cli.main([ckpt4, "-d", "cpu", "-C", "fp8", "-m", "completion", "-i", "hello world",
              "-n", "6", "-t", "0"])
    assert b"Generation stats" in capsysbinary.readouterr().out
    cli.main([ckpt4, "-d", "cpu", "-C", "fp8", "-m", "perplexity", "-i", "hello world the key"])
    assert b"perplexity:" in capsysbinary.readouterr().out
    with pytest.raises(SystemExit) as e:
        cli.main([ckpt4, "-d", "cpu", "-C", "e4m3"])
    assert e.value.code == 1


@pytest.mark.parametrize("overrides,reason", [
    (dict(), None),
    (dict(dim=384, n_heads=3, n_kv_heads=1), "wqkv (640x384, packed int4)"),
    (dict(hidden_dim=640), "w2 (256x640, packed int4)"),
])
def test_int4_limits_are_named(overrides, reason):
    cfg = tiny_config(**i4kw(**overrides))
    why = fast.fast_unsupported(cfg)
    assert why is None if reason is None else reason in why
