"""Each kernel wrapper of the port, on the CPU (its plain version), against
the JAX function on the same numpy inputs: the jnp emulation branch, and
for one case per kernel the Pallas kernel itself in interpret mode.

Tolerances, relative to the largest reference magnitude:
- EXACT_TOL (2e-5): the operands are the same bf16 values and every sum is
  f32, so only the summation order differs (plus, after a fused rmsnorm,
  a rare one-ulp bf16 rounding flip of one input).
- BF16_TOL (1e-2): against the Pallas kernels' attention, which normalises
  the softmax after the bf16 cast of p where the emulation (and the port's
  plain version) normalises before.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.ops.pallas import attention as jatt
from yalm_tpu.ops.pallas import block as jblock
from yalm_tpu.ops.pallas import ffn as jffn
from yalm_tpu.ops.pallas import gemv as jgemv
from yalm_tpu_torch.codec.format import numpy_to_torch, tag_for_numpy
from yalm_tpu_torch.models.fast import ring_slots
from yalm_tpu_torch.ops.cuda.attention import attend_step_l
from yalm_tpu_torch.ops.cuda.block import attn_block_l
from yalm_tpu_torch.ops.cuda.ffn import ffn_l
from yalm_tpu_torch.ops.cuda.gemv import gemm_l, gemv, gemv_l

EXACT_TOL = 2e-5
BF16_TOL = 1e-2
WTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "e5m2": jnp.float8_e5m2,
          "int8": jnp.int8}


def tt(a):
    """The same bits as a torch tensor (bf16/fp8 through integer views)."""
    a = np.asarray(a)
    return numpy_to_torch(a, tag_for_numpy(a))


def close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def weights(rng, wt, *shape):
    """(jax weights, jax per-row scale or None) of type wt."""
    if wt == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
        s = (rng.random(shape[:-1]) * 0.01 + 1e-3).astype(np.float32)
        return jnp.asarray(q), jnp.asarray(s)
    f = rng.standard_normal(shape, dtype=np.float32) / np.sqrt(shape[-1])
    return jnp.asarray(f).astype(WTYPES[wt]), None


# ---------------------------------------------------------------------------
# K1: gemv / gemv_l / gemm_l
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wt", list(WTYPES))
def test_gemv(wt):
    rng = np.random.default_rng(0)
    w, s = weights(rng, wt, 384, 256)
    x = rng.standard_normal(256, dtype=np.float32)
    want = jgemv.gemv(jnp.asarray(x), w, s)
    got = gemv(torch.from_numpy(x), tt(w), None if s is None else tt(s))
    close(got, want, EXACT_TOL)


GEMV_L_CASES = [  # (weight type, norm, residual, interpret)
    ("f32", False, False, None), ("bf16", True, False, None),
    ("e5m2", True, True, None), ("e5m2", False, True, None),
    ("int8", True, True, None), ("e5m2", True, True, True)]


@pytest.mark.parametrize("wt,norm,res,interpret", GEMV_L_CASES)
def test_gemv_l(wt, norm, res, interpret):
    rng = np.random.default_rng(1)
    L, N, K = 3, 384, 256
    w, s = weights(rng, wt, L, N, K)
    x = rng.standard_normal(K, dtype=np.float32) * 2
    nw = (1.0 + 0.1 * rng.standard_normal((L, K))).astype(np.float32) if norm else None
    r = rng.standard_normal(N, dtype=np.float32) if res else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else tt(a)  # noqa: E731
    for layer in range(L):
        want = jgemv.gemv_l(jnp.asarray(x), w, jnp.int32(layer), norm_w=j(nw),
                            residual=j(r), scale=s, interpret=interpret)
        got = gemv_l(torch.from_numpy(x), tt(w), layer, norm_w=t(nw),
                     residual=t(r), scale=t(s))
        close(got, want, EXACT_TOL)


@pytest.mark.parametrize("wt,B,interpret", [("f32", 1, None), ("bf16", 5, None),
                                             ("e5m2", 16, None), ("int8", 16, None),
                                             ("e5m2", 8, True)])
def test_gemm_l(wt, B, interpret):
    rng = np.random.default_rng(2)
    L, N, K = 2, 384, 256
    w, s = weights(rng, wt, L, N, K)
    x = rng.standard_normal((B, K), dtype=np.float32)
    want = jgemv.gemm_l(jnp.asarray(x), w, jnp.int32(1), s, interpret=interpret)
    got = gemm_l(torch.from_numpy(x), tt(w), 1, None if s is None else tt(s))
    close(got, want, EXACT_TOL)


# ---------------------------------------------------------------------------
# K2: attend_step_l
# ---------------------------------------------------------------------------

def _cache(rng, L, S, Hk, D):
    k = jnp.asarray(rng.standard_normal((L, S, Hk, D), dtype=np.float32)).astype(jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((L, S, Hk, D), dtype=np.float32)).astype(jnp.bfloat16)
    return k, v


def _check_cache(got, want, layer, kv_pos):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    # the new row: the rotation's f32 rounding may flip one bf16 ulp
    np.testing.assert_allclose(got[layer, kv_pos], want[layer, kv_pos], rtol=2 ** -7, atol=1e-6)
    got[layer, kv_pos] = want[layer, kv_pos]
    np.testing.assert_array_equal(got, want)  # nothing else moved


ATT_CASES = [  # (pos, rope param, interpret); window S = 32
    (0, 1e4, None), (5, 1e4, None), (31, 1e4, None), (35, 1e4, None),
    (62, 1e4, None), (1000, 1e4, None),
    (40, ("yarn", 1e4, 4.0, 10.0, 40.0, 1.2), None),
    (47, ("llama3", 5e5, 8.0, 1.0, 4.0, 64), None),
    (35, 1e4, True)]


@pytest.mark.parametrize("pos,theta,interpret", ATT_CASES)
def test_attend_step_l(pos, theta, interpret):
    L, S, Hk, qpk, D = 2, 32, 2, 2, 128
    rng = np.random.default_rng(3 + pos)
    k_all, v_all = _cache(rng, L, S, Hk, D)
    q = rng.standard_normal((Hk, qpk, D), dtype=np.float32)
    kn = rng.standard_normal((Hk, D), dtype=np.float32)
    vn = rng.standard_normal((Hk, D), dtype=np.float32)
    kv_sink, kv_pos, kv_len = ring_slots(pos, S)
    want, wk, wv = jatt.attend_step_l(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), k_all, v_all,
        jnp.int32(1), jnp.int32(kv_pos), jnp.int32(kv_len), jnp.int32(kv_sink),
        jnp.int32(pos), kv_sinks=2, theta=theta, rotary_dim=D, interpret=interpret)
    tk, tv = tt(k_all), tt(v_all)
    got = attend_step_l(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
                        tk, tv, 1, kv_pos, kv_len, kv_sink, pos, kv_sinks=2,
                        theta=theta, rotary_dim=D)
    close(got, want, BF16_TOL if interpret else EXACT_TOL)
    _check_cache(tk, wk, 1, kv_pos)
    _check_cache(tv, wv, 1, kv_pos)


# ---------------------------------------------------------------------------
# K3: attn_block_l
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos,wt,bias,interpret", [
    (0, "f32", False, None), (11, "e5m2", True, None), (21, "int8", False, None),
    (70, "bf16", True, None), (21, "e5m2", False, True)])
def test_attn_block_l(pos, wt, bias, interpret):
    L, S, Hk, qpk, D, dim = 3, 16, 2, 2, 128, 256
    Hq = Hk * qpk
    Nqkv = (Hq + 2 * Hk) * D
    rng = np.random.default_rng(4 + pos)
    x = rng.standard_normal(dim, dtype=np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal((L, dim))).astype(np.float32)
    wqkv, sq = weights(rng, wt, L, Nqkv, dim)
    wo, so = weights(rng, wt, L, dim, Hq * D)
    b = (rng.standard_normal((L, Nqkv)) * 0.2).astype(np.float32) if bias else None
    k_all, v_all = _cache(rng, L, S, Hk, D)
    kv_sink, kv_pos, kv_len = ring_slots(pos, S)
    kw = dict(n_heads=Hq, kv_sinks=2, theta=1e4, rotary_dim=D, norm_eps=1e-5,
              qkv_clip=4.0)
    want, wk, wv = jblock.attn_block_l(
        jnp.asarray(x), jnp.asarray(nw), wqkv, wo, k_all, v_all, jnp.int32(2),
        jnp.int32(kv_pos), jnp.int32(kv_len), jnp.int32(kv_sink), jnp.int32(pos),
        bqkv_all=None if b is None else jnp.asarray(b), scale_qkv=sq, scale_o=so,
        interpret=interpret, **kw)
    tk, tv = tt(k_all), tt(v_all)
    got = attn_block_l(torch.from_numpy(x), torch.from_numpy(nw), tt(wqkv), tt(wo),
                       tk, tv, 2, kv_pos, kv_len, kv_sink, pos,
                       bqkv_all=None if b is None else torch.from_numpy(b),
                       scale_qkv=None if sq is None else tt(sq),
                       scale_o=None if so is None else tt(so), **kw)
    close(got, want, BF16_TOL if interpret else EXACT_TOL)
    _check_cache(tk, wk, 2, kv_pos)
    _check_cache(tv, wv, 2, kv_pos)


# ---------------------------------------------------------------------------
# K4: ffn_l
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act,B,wt,interpret", [
    ("silu", 1, "e5m2", None), ("silu", 3, "bf16", None), ("gelu", 1, "int8", None),
    ("gelu", 3, "e5m2", None), ("silu", 1, "e5m2", True)])
def test_ffn_l(act, B, wt, interpret):
    L, dim, H = 2, 256, 384
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, dim) if B > 1 else (dim,), dtype=np.float32) * 2
    nw = (1.0 + 0.1 * rng.standard_normal((L, dim))).astype(np.float32)
    w13, s13 = weights(rng, wt, L, 2 * H, dim)
    w2, s2 = weights(rng, wt, L, dim, H)
    want = jffn.ffn_l(jnp.asarray(x), jnp.asarray(nw), w13, w2, jnp.int32(1), s13, s2,
                      norm_eps=1e-5, act=act, interpret=interpret)
    got = ffn_l(torch.from_numpy(x), torch.from_numpy(nw), tt(w13), tt(w2), 1,
                None if s13 is None else tt(s13), None if s2 is None else tt(s2),
                norm_eps=1e-5, act=act)
    assert got.shape == want.shape
    # the GLU output is rounded to bf16 before w2: an ulp flip there moves
    # the result by ~2^-8 of one term
    close(got, want, EXACT_TOL if interpret is None else 1e-4)
