"""The port's debug capture on the CPU (mirrors tests/test_debug.py):
BinaryDumper, max_err and diff_captures (yalm_tpu_torch/utils/debug.py),
the oracle's capture map (models/transformer.py:decode_step(capture=True))
and the kernel path's (models/fast.py:decode_step_fast(capture=True), on
the plain versions here).

Bounds: the kernel path's capture against the oracle's (bf16 compute, bf16
cache) under 6e-2 relative per tensor, the bound of tests/test_debug.py:57;
the port's captures against JAX's: the oracle's (f32) within 1e-4
relative, the kernel path's within 1e-2 (the whole-model tolerance of
tests/test_torch_fast.py). Packed int4 raises JAX's ValueError.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.models import KVCache as JaxCache
from yalm_tpu.models import decode_step as jax_decode
from yalm_tpu.models import load_weights as jax_load_weights
from yalm_tpu.models.fast import FastWeights as JaxFastWeights
from yalm_tpu.models.fast import decode_step_fast as jax_decode_fast
from yalm_tpu.utils.debug import diff_captures as jax_diff
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import FastWeights, decode_step_fast, load_fast_weights
from yalm_tpu_torch.models.transformer import decode_step
from yalm_tpu_torch.models.weights import load_weights
from yalm_tpu_torch.utils.debug import BinaryDumper, diff_captures, max_err
from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config

from test_torch_fast import fast_kw

NAMES = {"att_in", "q", "k", "v", "att_mix", "ffn_in", "block_out", "final_norm", "logits"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_binary_dumper_roundtrip(tmp_path):
    arr = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    p = str(tmp_path / "dump" / "x.npy")
    BinaryDumper.save(p, arr)
    np.testing.assert_array_equal(BinaryDumper.load(p), arr)
    BinaryDumper.save(p, torch.from_numpy(arr).bfloat16())   # tensors too, as f32
    np.testing.assert_array_equal(BinaryDumper.load(p),
                                  torch.from_numpy(arr).bfloat16().float().numpy())


def test_max_err_relative_and_absolute():
    a = np.array([1.0, 2.0])
    b = np.array([1.0, 2.2])
    assert abs(max_err(a, b, relative=False) - 0.2) < 1e-9
    assert abs(max_err(a, b, relative=True) - 0.2 / 2.2) < 1e-9
    assert abs(max_err(torch.tensor(a), b) - 0.2 / 2.2) < 1e-7
    assert max_err({"x": a, "y": b}, {"x": b, "y": b}) == max_err(a, b)


def test_capture_shapes_and_determinism(tmp_path):
    """The oracle's capture: per-layer stacks of the JAX shapes; the capture
    does not perturb the step's logits; identical runs diff to 0; a
    perturbed final norm shows in the logits and not upstream of it."""
    cfg = tiny_config()
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, cfg)
    yf = read_yalm(path)
    w = load_weights(yf, cfg, "cpu")
    yf.close()

    def cap_of(weights):
        return decode_step(cfg, weights, 3, 0, KVCache.init(cfg, torch.float16, "cpu"),
                           capture=True)
    logits, _, cap = cap_of(w)
    assert set(cap) == NAMES
    assert cap["q"].shape == (cfg.n_layers, cfg.n_heads, cfg.head_dim)
    assert cap["k"].shape == (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    assert cap["block_out"].shape == (cfg.n_layers, cfg.dim)
    assert cap["logits"].shape == (cfg.vocab_size,)
    plain, _ = decode_step(cfg, w, 3, 0, KVCache.init(cfg, torch.float16, "cpu"))
    np.testing.assert_allclose(logits.numpy(), plain.numpy(), rtol=1e-6)
    assert max(diff_captures(cap, cap_of(w)[2]).values()) == 0.0
    errs = diff_captures(cap, cap_of(w._replace(final_norm=w.final_norm * 1.01))[2])
    assert errs["logits"] > 0 and errs["block_out"] == 0.0
    assert list(errs) == sorted(errs, key=lambda k: -errs[k])
    none = decode_step(cfg, w, 3, 0, KVCache.init(cfg, torch.float16, "cpu"),
                       output_logits=False, capture=True)
    assert none[0] is None and set(none[2]) == NAMES - {"final_norm", "logits"}


CAPTURE_CASES = {
    "fp8": {}, "int8 bias": dict(weight_dtype="int8", has_qkv_bias=True),
    "moe": dict(n_experts=4, n_experts_active=2),
    "gemma2": dict(has_post_norms=True, attn_softcap=50.0, final_softcap=30.0,
                   sliding_window=4, layer_sliding=(1, 0), act_type="gelu"),
    "qwen3": dict(has_qk_norm=True),
}


def _both(tmp_path, kw):
    """The port's oracle Weights and FastWeights of one checkpoint, JAX's
    Weights and the cfgs."""
    path = str(tmp_path / "m.yalm")
    jcfg = jax_tiny(**kw)
    jax_synth(path, jcfg, seed=13)
    yf = jax_read(path, native=False)
    jw = jax_load_weights(yf, jcfg)
    yf.close()
    cfg = tiny_config(**kw)
    yf = read_yalm(path)
    w, fw = load_weights(yf, cfg, "cpu"), load_fast_weights(yf, cfg, "cpu")
    yf.close()
    return jcfg, jw, cfg, w, fw


@pytest.mark.parametrize("name", list(CAPTURE_CASES))
def test_fast_path_capture_matches_oracle(tmp_path, name):
    """decode_step_fast(capture=True) exposes the oracle's activation map
    at the kernel boundaries: over a little history (3 steps, then past the
    sliding window for Gemma2) every tensor within 6e-2 of the oracle's
    (bf16 compute, bf16 cache), per layer; FastWeights.from_weights of the
    oracle's Weights captures the same; the capture's logits are the
    non-capture step's (the fused block) within 1e-2 of max(1, max|.|)."""
    jcfg, jw, cfg, w, fw = _both(tmp_path, fast_kw(**CAPTURE_CASES[name]))
    co = KVCache.init(cfg, torch.bfloat16, "cpu")
    cf = KVCache.init(cfg, torch.bfloat16, "cpu")
    cn = KVCache.init(cfg, torch.bfloat16, "cpu")
    tok = 5
    for pos in range(6 if "sliding_window" in CAPTURE_CASES[name] else 3):
        _, co, cap_o = decode_step(cfg, w, tok, pos, co, compute_dtype=torch.bfloat16,
                                   capture=True)
        lf, cf, cap_f = decode_step_fast(cfg, fw, tok, pos, cf, capture=True)
        ln, cn = decode_step_fast(cfg, fw, tok, pos, cn)
        tok = 3 + pos
    assert set(cap_f) == set(cap_o) == NAMES
    errs = diff_captures(cap_o, cap_f)
    for k, e in errs.items():
        assert e < 6e-2, (k, errs)
    assert cap_f["block_out"].shape[0] == cfg.n_layers
    err = float((lf - ln).abs().max())
    assert err <= 1e-2 * max(1.0, float(ln.abs().max())), err
    if name == "fp8":
        # the decode layout made from the oracle's Weights captures the same
        c2 = KVCache.init(cfg, torch.bfloat16, "cpu")
        fw2 = FastWeights.from_weights(w, cfg)
        tok = 5
        for pos in range(3):
            _, c2, cap2 = decode_step_fast(cfg, fw2, tok, pos, c2, capture=True)
            tok = 3 + pos
        assert max(diff_captures(cap_f, cap2).values()) < 1e-5


@pytest.mark.parametrize("name", ["fp8", "gemma2"])
def test_captures_match_jax(tmp_path, name):
    """The port's oracle capture against JAX's oracle capture (f32, f32
    cache) within 1e-4 relative per tensor; the port's kernel-path capture
    against JAX's decode_step_fast capture (its emulation, on the JAX
    FastWeights of the same Weights) within 1e-2."""
    jcfg, jw, cfg, w, fw = _both(tmp_path, fast_kw(**CAPTURE_CASES[name]))
    jc, tc = JaxCache.init(jcfg, jnp.float32), KVCache.init(cfg, torch.float32, "cpu")
    jfc, tfc = JaxCache.init(jcfg, jnp.bfloat16), KVCache.init(cfg, torch.bfloat16, "cpu")
    jfw = JaxFastWeights.from_weights(jw, jcfg)
    fw2 = FastWeights.from_weights(w, cfg)
    tok = 5
    for pos in range(3):
        _, jc, jcap = jax_decode(jcfg, jw, jnp.int32(tok), jnp.int32(pos), jc, capture=True)
        _, tc, tcap = decode_step(cfg, w, tok, pos, tc, capture=True)
        _, jfc, jfcap = jax_decode_fast(jcfg, jfw, jnp.int32(tok), jnp.int32(pos), jfc,
                                        capture=True)
        _, tfc, tfcap = decode_step_fast(cfg, fw2, tok, pos, tfc, capture=True)
        tok = 3 + pos
    jnp_caps = ({k: np.asarray(v) for k, v in jcap.items()},
                {k: np.asarray(v) for k, v in jfcap.items()})
    errs = diff_captures(tcap, jnp_caps[0])
    assert set(errs) == NAMES and max(errs.values()) < 1e-4, errs
    errs = diff_captures(tfcap, jnp_caps[1])
    assert set(errs) == NAMES and max(errs.values()) < 1e-2, errs
    # JAX's diff of the same maps agrees with the port's
    assert abs(jax_diff({k: v.numpy() for k, v in tcap.items()}, jnp_caps[0])["logits"]
               - diff_captures(tcap, jnp_caps[0])["logits"]) < 1e-9


def test_int4_capture_raises(tmp_path):
    _, _, cfg, _, fw = _both(tmp_path, fast_kw(weight_dtype="int4"))
    with pytest.raises(ValueError, match="packed int4"):
        decode_step_fast(cfg, fw, 5, 0, KVCache.init(cfg, torch.bfloat16, "cpu"), capture=True)
