"""The port's core ops (rmsnorm, RoPE with every packed rope_param kind,
activations) against `yalm_tpu/ops/core.py` on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.ops import core as jcore
from yalm_tpu_torch.ops import core

THETA = 10000.0
ROPE_PARAMS = {
    "plain": THETA,
    "linear": ("linear", THETA, 4.0),
    "llama3": ("llama3", 500000.0, 8.0, 1.0, 4.0, 8192),
    "yarn": ("yarn", THETA, 4.0, 10.0, 40.0, 1.2),
    "gemma3": ("gemma3", 1e6, 8.0, 10000.0),
}


def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 256), dtype=np.float32) * 3
    w = rng.standard_normal(256, dtype=np.float32)
    want = np.asarray(jcore.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = core.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    # same f32 operations; only the order of the mean's sum may differ
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# (kind, alt): alt != 0 selects gemma3's local theta
@pytest.mark.parametrize("kind,alt", [(k, None) for k in ROPE_PARAMS] + [("gemma3", 1)])
def test_rope_matches(kind, alt):
    theta = ROPE_PARAMS[kind]
    D, rot = 128, 96   # partial rotary: pairs past rot keep frequency 0
    j = 2.0 * np.arange(D // 2, dtype=np.float32)
    fw = np.asarray(jcore.rope_pair_freqs(theta, rot, jnp.asarray(j), alt))
    fp = core.rope_pair_freqs(theta, rot, torch.from_numpy(j), alt).numpy()
    # f32 exp/log of the same arguments: within an ulp or two
    np.testing.assert_allclose(fp, fw, rtol=1e-6, atol=0)
    assert np.all(fp[rot // 2:] == 0)

    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 3, D), dtype=np.float32)
    pos = np.array([0, 1, 7, 1000, 4095], np.int32)
    want = np.asarray(jcore.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, rot, alt))
    got = core.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, rot, alt).numpy()
    # angles reach pos * freq ~ 4e3 rad, where one ulp of the frequency
    # moves the angle by ~2e-4 rad; the values are O(1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=1e-5)


def test_mscale_and_rotation_param():
    yarn = ROPE_PARAMS["yarn"]
    assert core.rope_mscale(yarn) == jcore.rope_mscale(yarn) == 1.2
    assert core.rope_rotation_param(yarn) == jcore.rope_rotation_param(yarn)
    assert core.rope_mscale(core.rope_rotation_param(yarn)) == 1.0
    assert core.rope_mscale(THETA) == 1.0


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activations_match(act):
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    want = np.asarray(jcore.act_fn(act)(jnp.asarray(x)))
    got = core.act_fn(act)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
