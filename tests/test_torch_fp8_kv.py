"""The port's fp8-e5m2 KV cache (`-C fp8`) on the CPU against the JAX
package's emulation (`_attn_step_ref`, `_sink_view_ref`).

The new k/v rows are rounded from f32 to e5m2 in one step on both sides,
so the cache bytes after the write must be equal; the mix is the same
bf16-operand / f32-sum arithmetic, EXACT_TOL (2e-5) of its largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.ops.pallas import attention as jatt
from yalm_tpu_torch.codec.format import numpy_to_torch, tag_for_numpy
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.ops.cuda.attention import attend_step_l, sink_view
from yalm_tpu_torch.utils.testing import tiny_config

EXACT_TOL = 2e-5
E5M2 = jnp.float8_e5m2


def tt(a):
    a = np.asarray(a)
    return numpy_to_torch(a, tag_for_numpy(a))


def _bytes(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _cache(rng, L, S, Hk, D):
    k = jnp.asarray(rng.standard_normal((L, S, Hk, D)).astype(np.float32) * 0.5).astype(E5M2)
    v = jnp.asarray(rng.standard_normal((L, S, Hk, D)).astype(np.float32) * 0.5).astype(E5M2)
    return k, v


# (kv_pos, kv_len, kv_sink, pos) in a window of 32: as tests/test_fp8_kv.py,
# plus the last slot of the window and a ring position far past it
CASES = [(5, 6, 0, 5), (3, 32, 2, 40), (0, 1, 0, 0), (31, 32, 0, 31), (13, 32, 2, 1011)]


@pytest.mark.parametrize("kv_pos,kv_len,kv_sink,pos", CASES)
def test_attend_step_l_e5m2_cache(kv_pos, kv_len, kv_sink, pos):
    L, S, Hk, D, qpk = 2, 32, 2, 128, 2
    rng = np.random.default_rng(11 + pos)
    k_all, v_all = _cache(rng, L, S, Hk, D)
    q = rng.standard_normal((Hk, qpk, D)).astype(np.float32)
    kn = rng.standard_normal((Hk, D)).astype(np.float32)
    vn = rng.standard_normal((Hk, D)).astype(np.float32)
    want, wk, wv = jatt.attend_step_l(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), k_all, v_all, jnp.int32(1),
        jnp.int32(kv_pos), jnp.int32(kv_len), jnp.int32(kv_sink), jnp.int32(pos),
        kv_sinks=2, theta=1e4, rotary_dim=D)
    tk, tv = tt(k_all), tt(v_all)
    assert tk.dtype == torch.float8_e5m2
    got = attend_step_l(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
                        tk, tv, 1, kv_pos, kv_len, kv_sink, pos, kv_sinks=2, theta=1e4,
                        rotary_dim=D)
    np.testing.assert_array_equal(_bytes(tk), _bytes(wk))
    np.testing.assert_array_equal(_bytes(tv), _bytes(wv))
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= EXACT_TOL * max(1.0, np.abs(want).max())


def test_new_row_rounds_once_from_f32():
    """f32 -> e5m2 directly, as JAX's astype: through bf16 the same values
    would round twice and land elsewhere (and 61440 overflows to inf)."""
    rng = np.random.default_rng(0)
    f = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 3,
                        np.float32([61440.0, 57344.0, 1.125, 2.0 ** -17])])
    direct = torch.from_numpy(f).to(torch.float8_e5m2)
    np.testing.assert_array_equal(direct.view(torch.uint8).numpy(),
                                  np.asarray(jnp.asarray(f).astype(E5M2)).view(np.uint8))
    twice = torch.from_numpy(f).to(torch.bfloat16).to(torch.float8_e5m2)
    assert (twice.view(torch.uint8) != direct.view(torch.uint8)).any()


def test_sink_view_rounds_through_bf16_not_e5m2():
    """The rotated sink keys of an e5m2 cache are rounded to bf16, the
    working type (_sink_view_ref), not back to e5m2."""
    S, Hk, D, pos = 32, 2, 128, 1011
    rng = np.random.default_rng(5)
    k = jnp.asarray(rng.standard_normal((S, Hk, D)).astype(np.float32)).astype(E5M2)
    want = np.asarray(jatt._sink_view_ref(k, jnp.int32(2), jnp.int32(pos), kv_sinks=2,
                                          theta=1e4, rotary_dim=D), np.float32)
    got = sink_view(tt(k), 2, pos, theta=1e4, rotary_dim=D)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    as_e5m2 = got[:2].to(torch.float8_e5m2).float()
    assert (as_e5m2 != got[:2]).float().mean() > 0.5   # bf16 values, mostly not e5m2 ones
    np.testing.assert_array_equal(got[2:].numpy(), np.asarray(k[2:], np.float32))


def test_kv_cache_init_e5m2():
    cfg = tiny_config()
    c = KVCache.init(cfg, torch.float8_e5m2, "cpu")
    assert c.k.dtype == c.v.dtype == torch.float8_e5m2
    assert tuple(c.k.shape) == (cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    assert not c.k.float().any()
