"""The port's whole slice on the CPU (plain versions) against the JAX
package's fast path (its emulation branches) on the same checkpoint.

Tolerances: the two compute the same bf16-operand / f32-sum arithmetic,
so logits agree to f32 summation order -- until a last-bit difference
(sum order, or torch's and XLA's f32 cos/sin in RoPE) flips the bf16
rounding of one k element, which attention then spreads to every later
row at ~2e-3 of the logits. Whole-model logits: 1e-2 of max(1, max|logit|).
The caches, later layers' rows being such activations too, by the same rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.engine import Engine as JaxEngine
from yalm_tpu.models.cache import KVCache as JaxCache
from yalm_tpu.models.fast import decode_step_fast as jax_decode
from yalm_tpu.models.fast import load_fast_weights as jax_load
from yalm_tpu.models.fast import prefill_fast as jax_prefill
from yalm_tpu.sampler import sample_ext as jax_sample_ext
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch import cli
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.engine import Engine
from yalm_tpu_torch.models import fast
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import (decode_step_fast, fast_weights_from_numpy,
                                        load_fast_weights, prefill_fast)
from yalm_tpu_torch.sampler import sample_ext
from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config

LOGIT_TOL = 1e-2


def fast_kw(**overrides):
    kw = dict(dim=256, hidden_dim=512, head_dim=128, n_layers=2, n_heads=4,
              n_kv_heads=2, vocab_size=512, max_seq_len=32, rotary_dim=128,
              qkv_clip=30.0, weight_dtype="fp8")
    kw.update(overrides)
    return kw


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "m.yalm")
    synth_checkpoint(path, tiny_config(**fast_kw()), seed=0)
    return path


def both_weights(path, cfg):
    """(JAX FastWeights, the port's FastWeights made from its numpy arrays)."""
    yf = jax_read(path, native=False)
    jw = jax_load(yf, cfg)
    yf.close()
    arrays = {k: np.asarray(v) for k, v in jw._asdict().items()
              if v is not None and k != "scales"}
    if jw.scales is not None:
        arrays["scales"] = {k: np.asarray(v) for k, v in jw.scales._asdict().items()
                            if v is not None}
    return jw, fast_weights_from_numpy(arrays, cfg, "cpu")


def close(got, want, tol=LOGIT_TOL):
    got, want = got.numpy(), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def cache_close(got, want):
    close(got.float(), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype,bias", [("fp8", False), ("int8", True)])
def test_decode_step_fast_across_the_ring(tmp_path, dtype, bias):
    kw = fast_kw(weight_dtype=dtype, has_qkv_bias=bias)
    path = str(tmp_path / "m.yalm")
    jax_synth(path, jax_tiny(**kw), seed=1)
    cfg = tiny_config(**kw)
    jw, tw = both_weights(path, jax_tiny(**kw))
    jc = JaxCache.init(jax_tiny(**kw), jnp.bfloat16)
    tc = KVCache.init(cfg, torch.bfloat16, "cpu")
    tok = 5
    for pos in range(cfg.max_seq_len + 8):   # past the window: ring + sinks
        want, jc = jax_decode(jax_tiny(**kw), jw, jnp.int32(tok), jnp.int32(pos), jc)
        got, tc = decode_step_fast(cfg, tw, tok, pos, tc)
        close(got, want)
        tok = int(np.argmax(np.asarray(want)))
    cache_close(tc.k, jc.k)
    cache_close(tc.v, jc.v)


@pytest.mark.parametrize("overrides,reason", [
    (dict(max_seq_len=131072), None),   # any window: scores overflow to global scratch
    (dict(dim=240), "wqkv (1024x240"),
    (dict(n_heads=64, n_kv_heads=2), "head_dim 128 x 32 queries per kv head"),
])
def test_engine_names_the_kernel_limit(overrides, reason):
    cfg = tiny_config(**fast_kw(**overrides))
    why = fast.fast_unsupported(cfg)
    assert why is None if reason is None else reason in why
    if reason is not None:
        with pytest.raises(ValueError, match=reason.replace("(", r"\(")):
            Engine(cfg, None, device="cpu")


@pytest.mark.parametrize("mode", ["last", "all"])
def test_prefill_fast_with_attend_len(ckpt, mode):
    jcfg, cfg = jax_tiny(**fast_kw()), tiny_config(**fast_kw())
    jw, tw = both_weights(ckpt, jcfg)
    jc = JaxCache.init(jcfg, jnp.bfloat16)
    tc = KVCache.init(cfg, torch.bfloat16, "cpu")
    rng = np.random.default_rng(3)
    # chunk 1: 13 valid of 16 at 0 (width 16); chunk 2: 10 of 16 at 13 (32)
    for pos0, valid, attend, m in ((0, 13, 16, "none"), (13, 10, 32, mode)):
        toks = rng.integers(3, cfg.vocab_size, 16).astype(np.int32)
        want, jc = jax_prefill(jcfg, jw, jnp.asarray(toks), jnp.int32(pos0),
                               jnp.int32(valid), jc, logits_mode=m, attend_len=attend)
        got, tc = prefill_fast(cfg, tw, toks, pos0, valid, tc, logits_mode=m,
                               attend_len=attend)
        if m == "none":
            assert got is None and want is None
        else:
            assert tuple(got.shape) == want.shape
            close(got, want)
    cache_close(tc.k, jc.k)
    cache_close(tc.v, jc.v)


def test_engine_greedy_stream_and_perplexity(ckpt):
    je = JaxEngine.from_checkpoint(ckpt)
    te = Engine.from_checkpoint(ckpt, device="cpu")
    prompt = list(range(3, 43))   # 40 tokens: 32 chunked, 8 hydrated in the ring
    want = list(je.generate(prompt, max_steps=12, temperature=0.0))
    got = list(te.generate(prompt, max_steps=12, temperature=0.0))
    assert got == want
    # the device-side block decode gives the same greedy stream
    te.reset()
    assert list(te.generate(prompt, max_steps=12, temperature=0.0, block_size=4)) == want
    je.reset()
    te.reset()
    toks = [1] + list(range(40, 90))
    jp, je_err, jn = je.perplexity(toks)
    tp, te_err, tn = te.perplexity(toks)
    assert tn == jn
    assert abs(tp - jp) <= 1e-3 * jp and abs(te_err - je_err) <= 1e-3 * je_err


def test_cli_modes_run(ckpt, capsysbinary):
    cli.main([ckpt, "-d", "cpu", "-m", "completion", "-i", "hello world", "-n", "6",
              "-t", "0"])
    assert b"Generation stats" in capsysbinary.readouterr().out
    cli.main([ckpt, "-d", "cpu", "-m", "perplexity", "-i", "hello world the key is"])
    assert b"perplexity:" in capsysbinary.readouterr().out
    with pytest.raises(SystemExit) as e:
        cli.main([ckpt, "-d", "cpu", "-M", "1,1,1"])
    assert e.value.code == 1


SAMPLING = [(0, 1.0), (5, 1.0), (0, 0.8), (10, 0.9)]


def _expected(logits, T, k, p):
    """The sampling rule both packages implement, in float64 numpy."""
    desc = np.sort(logits)[::-1]
    kth = desc[(k if k > 0 else len(desc)) - 1]
    if p < 1.0:
        probs = np.exp((desc - desc[0]) / T)
        probs /= probs.sum()
        cut = min(int(np.sum(np.cumsum(probs) < p)), len(desc) - 1)
        pth = desc[cut]
    else:
        pth = desc[-1]
    keep = logits >= max(kth, pth)
    q = np.where(keep, np.exp((logits - logits.max()) / T), 0.0)
    return q / q.sum()


@pytest.mark.parametrize("top_k,top_p", SAMPLING)
def test_sample_ext_distribution(top_k, top_p):
    """Compare distributions, not draws: the two generators differ. With
    N = 20000 draws over <= 48 outcomes the total-variation distance of an
    empirical distribution is ~0.02 on average; 0.05 bounds it."""
    V, T, N = 48, 0.7, 20000
    logits = np.random.default_rng(top_k).standard_normal(V).astype(np.float32) * 2
    want = _expected(logits.astype(np.float64), T, top_k, top_p)
    gen = torch.Generator().manual_seed(0)
    got = sample_ext(torch.from_numpy(np.tile(logits, (N, 1))), gen, T, top_k, top_p).numpy()
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    ref = np.asarray(jax.vmap(jax_sample_ext, in_axes=(None, 0, None, None, None))(
        jnp.asarray(logits), keys, jnp.float32(T), jnp.int32(top_k), jnp.float32(top_p)))
    for draws in (got, ref):
        emp = np.bincount(draws, minlength=V) / N
        assert set(np.flatnonzero(emp)) <= set(np.flatnonzero(want))
        assert 0.5 * np.abs(emp - want).sum() < 0.05
    assert int(sample_ext(torch.from_numpy(logits), gen, 0.0)) == int(np.argmax(logits))


@pytest.mark.parametrize("feature", [dict(has_qk_norm=True), dict(has_post_norms=True),
                                     dict(attn_softcap=50.0),
                                     dict(n_experts=4, n_experts_active=2)])
def test_later_slices_raise(tmp_path, feature):
    """Features of later slices raise; MoE came with its slice: the JAX
    fixture's MoE checkpoint loads and decodes (tests/test_torch_moe.py
    holds it to the JAX package)."""
    path = str(tmp_path / "m.yalm")
    jax_synth(path, jax_tiny(**fast_kw(**feature)), seed=0)
    yf = read_yalm(path)
    cfg = dataclasses.replace(tiny_config(**fast_kw()), **feature)
    if cfg.is_moe:
        fw = load_fast_weights(yf, cfg, "cpu")
        logits, _ = decode_step_fast(cfg, fw, 5, 0, KVCache.init(cfg, torch.bfloat16, "cpu"))
        assert fw.w13.shape == (2, 4, 1024, 256) and fw.moegate.shape == (2, 4, 256)
        assert logits.shape == (cfg.vocab_size,) and bool(torch.isfinite(logits).all())
    else:
        with pytest.raises(NotImplementedError):
            load_fast_weights(yf, cfg, "cpu")
    yf.close()
