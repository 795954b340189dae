"""csrc/gemm.cu's gemm_kernel (K1 gemm_l, K10 gemm_le) on the CPU, where the
kernel cannot run: its plan (`gemm_plan`: the token tile and the K split),
its GLU row map (`glu_rows`), and a plain emulation of its split arithmetic
(`gemm_split_plain`: each K slice summed in f32, the slices added in slice
order, then the scale, residual or GLU pair) against the port's plain
versions and the JAX package's gemm_l / gemm_le on the same numpy inputs.

Tolerances, relative to max(1, max|ref|):
- SUM_TOL (1e-5) for f32 outputs: the operands are the same bf16 values
  and every product is exact in f32, so only the order of the f32 sums
  differs (slices, then the blocks of a matmul);
- GLU outputs are bf16 values: each within SUM_TOL of the reference or one
  bf16 ulp of it, where the two f32 sums straddle a rounding boundary;
  the flips are counted and must stay rare.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.ops import core as jcore
from yalm_tpu.ops.pallas import gemv as jgemv
from yalm_tpu_torch.codec.format import numpy_to_torch, tag_for_numpy
from yalm_tpu_torch.ops.cuda.gemv import (GEMM_KT, GEMM_MT, GEMM_ROWS, MAX_SPLIT, SMS,
                                          bf16f, gemm_l, gemm_l_plain, gemm_le, gemm_le_plain,
                                          gemm_plan, gemm_row_tiles, gemm_split_plain,
                                          glu_plain, glu_rows)

torch.set_num_threads(1)

SUM_TOL = 1e-5
WTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "e5m2": jnp.float8_e5m2, "int8": jnp.int8}

# Mistral-7B's projections: (name, N, K, GLU)
MISTRAL = [("wqkv", 6144, 4096, False), ("wo", 4096, 4096, False),
           ("w13", 28672, 4096, True), ("w2", 4096, 14336, False)]


def tt(a):
    a = np.asarray(a)
    return numpy_to_torch(a, tag_for_numpy(a))


def weights(rng, wt, *shape):
    """(jax weights, jax per-row scale or None) of type wt."""
    if wt == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
        s = (rng.random(shape[:-1]) * 0.01 + 1e-3).astype(np.float32)
        return jnp.asarray(q), jnp.asarray(s)
    f = rng.standard_normal(shape, dtype=np.float32) / np.sqrt(shape[-1])
    return jnp.asarray(f).astype(WTYPES[wt]), None


def close(got, want, tol=SUM_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def close_glu(got, want) -> int:
    """GLU outputs: bf16 values, each within SUM_TOL or one bf16 ulp of the
    reference; returns the count of one-ulp flips past SUM_TOL."""
    got = torch.from_numpy(np.array(got, np.float32))
    want = torch.from_numpy(np.array(want, np.float32))
    assert torch.equal(got, bf16f(got))
    tol = SUM_TOL * max(1.0, float(want.abs().max()))
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want.abs()).exponent - 8)
    diff = (got - want).abs()
    assert bool((diff <= torch.maximum(ulp, torch.full_like(ulp, tol))).all())
    return int((diff > tol).sum())


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

PLAN_CASES = [(M, N, K, glu) for M in (1, 8, 16, 17, 64, 100, 255, 256, 257, 1000)
              for _, N, K, glu in MISTRAL + [("router", 8, 4096, False), ("tiny", 100, 96, False),
                                             ("glu", 200, 1024, True)]]


@pytest.mark.parametrize("M,N,K,glu", PLAN_CASES)
def test_gemm_plan_covers_k_once(M, N, K, glu):
    """The slices cover the ceil(K / 64) stages exactly once, each slice a
    whole number of stages and none empty; the token tile is a wgmma N the
    kernel has, the smallest that holds M (past 128 tokens: 256, or 128
    where 256-token tiles would leave the SMs short of blocks)."""
    mt, kchunk, split = gemm_plan(M, N, K, glu)
    assert mt in GEMM_MT and (mt == GEMM_MT[0] or mt // 2 < M)
    if M <= 128:
        assert mt >= M
    else:
        rows_256 = gemm_row_tiles(N, glu) * -(-M // 256)
        assert mt == (256 if rows_256 >= SMS else 128)
    nk = -(-K // GEMM_KT)
    assert 1 <= split <= min(MAX_SPLIT, nk) and kchunk >= 1
    seen = np.zeros(nk, np.int64)
    for z in range(split):
        lo, hi = z * kchunk, min(nk, (z + 1) * kchunk)
        assert lo < hi                                  # no empty slice
        seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("M,N,K,glu", PLAN_CASES)
def test_gemm_plan_splits_only_a_starved_grid(M, N, K, glu):
    """s = 1 whenever one slice already gives the card's 132 blocks; else
    the split asks for enough slices to give them (at most MAX_SPLIT), and
    equal whole slices keep at least half of that."""
    mt, _, split = gemm_plan(M, N, K, glu)
    blocks = gemm_row_tiles(N, glu) * -(-M // mt)
    if blocks >= SMS:
        assert split == 1
    else:
        want = min(-(-K // GEMM_KT), MAX_SPLIT, -(-SMS // blocks))
        assert want >= split >= want / 2


@pytest.mark.parametrize("M,name,plan", [
    (16, "wqkv", (16, 22, 3)), (16, "wo", (16, 13, 5)), (16, "w13", (16, 64, 1)),
    (16, "w2", (16, 45, 5)), (256, "wqkv", (128, 32, 2)), (256, "wo", (128, 22, 3)),
    (256, "w13", (256, 64, 1)), (256, "w2", (128, 75, 3))])
def test_gemm_plan_mistral(M, name, plan):
    """The plans of Mistral-7B's projections at the tick's M 16 and a
    chunk's M 256: w13 (224 row tiles of GLU pairs) never splits; at M 16
    w2 and wo (32 row tiles) split 5 ways, wqkv (48) 3 ways; at M 256 the
    narrow ones take two 128-token tiles and split 3 or 2 ways."""
    _, N, K, glu = next(c for c in MISTRAL if c[0] == name)
    assert tuple(gemm_plan(M, N, K, glu)) == plan


# ---------------------------------------------------------------------------
# the GLU row map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [1, 7, 64, 100, 14336])
def test_glu_rows_pair_halves_on_g_and_g8(H):
    """Over a GLU launch's row tiles every pair appears once; its h1 (row p
    of W13) and h3 (row H + p) sit on rows g and g + 8 of one 16-row slab,
    so one thread's two accumulator rows are one pair's halves."""
    seen = np.zeros(H, np.int64)
    for tile in range(gemm_row_tiles(2 * H, True)):
        p0 = tile * (GEMM_ROWS // 2)
        rows = glu_rows(p0, H)
        assert len(rows) == GEMM_ROWS
        for slab in range(GEMM_ROWS // 16):
            for g in range(8):
                h1, h3 = rows[16 * slab + g], rows[16 * slab + g + 8]
                if h1 < 0:
                    assert h3 < 0
                    continue
                assert h3 == H + h1 and h1 == p0 + 8 * slab + g
                seen[h1] += 1
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# the split arithmetic
# ---------------------------------------------------------------------------

SPLIT_CASES = [  # (weight type, M, N, K): splits 4-16 ways (few row tiles)
    ("f32", 1, 384, 256), ("bf16", 5, 384, 1024), ("e5m2", 16, 384, 256),
    ("int8", 17, 384, 2048), ("e5m2", 64, 384, 4096), ("bf16", 257, 384, 96)]


@pytest.mark.parametrize("wt,M,N,K", SPLIT_CASES)
def test_split_emulation_matches_plain_and_jax(wt, M, N, K):
    """gemm_split_plain (per-slice f32 partials in slice order, then the
    scale) against gemm_l_plain and the JAX gemm_l's emulation; the JAX
    kernel itself in interpret mode where its blocks tile the shape."""
    rng = np.random.default_rng(M + K)
    L = 2
    w, s = weights(rng, wt, L, N, K)
    x = rng.standard_normal((M, K), dtype=np.float32)
    assert gemm_plan(M, N, K).split > 1
    tx, tw, ts = torch.from_numpy(x), tt(w), None if s is None else tt(s)
    got = gemm_split_plain(tx, tw, 1, ts)
    close(got, gemm_l_plain(tx, tw, 1, ts))
    close(got, gemm_l(tx, tw, 1, ts))
    close(got, jgemv.gemm_l(jnp.asarray(x), w, jnp.int32(1), s))
    if K % 256 == 0:
        close(got, jgemv.gemm_l(jnp.asarray(x), w, jnp.int32(1), s, interpret=True))


@pytest.mark.parametrize("wt", ["e5m2", "int8", "bf16"])
def test_split_emulation_residual(wt):
    """The residual is added to the full sum, after the scale."""
    rng = np.random.default_rng(7)
    w, s = weights(rng, wt, 1, 256, 1024)
    x = rng.standard_normal((9, 1024), dtype=np.float32)
    r = rng.standard_normal((9, 256), dtype=np.float32)
    tx, tw, ts, tr = (torch.from_numpy(x), tt(w), None if s is None else tt(s),
                      torch.from_numpy(r))
    got = gemm_split_plain(tx, tw, 0, ts, residual=tr)
    close(got, gemm_l_plain(tx, tw, 0, ts) + tr)
    close(got, np.asarray(jgemv.gemm_l(jnp.asarray(x), w, jnp.int32(0), s)) + r)


@pytest.mark.parametrize("wt,M,act", [("e5m2", 16, "silu"), ("int8", 33, "gelu"),
                                      ("bf16", 1, "silu"), ("f32", 100, "gelu")])
def test_split_emulation_routed_glu(wt, M, act):
    """gemm_le's form: the expert's slice of an (L, E, N, K) stack, its scale,
    the split sums, then the GLU pair; against gemm_le_plain and the JAX
    gemm_le (emulation, and the kernel in interpret mode) composed with the
    JAX activation, one bf16 ulp allowed per element, the flips counted."""
    rng = np.random.default_rng(M)
    L, E, H, K = 2, 3, 96, 512
    w, s = weights(rng, wt, L, E, 2 * H, K)
    x = rng.standard_normal((M, K), dtype=np.float32)
    assert gemm_plan(M, 2 * H, K, True).split > 1
    tx, tw, ts = torch.from_numpy(x), tt(w), None if s is None else tt(s)
    got = gemm_split_plain(tx, tw, 1, ts, expert=2, glu_act=act)
    flips = close_glu(got, gemm_le_plain(tx, tw, 1, 2, ts, glu_act=act))
    flips += close_glu(got, gemm_le(tx, tw, 1, torch.tensor(2), ts, glu_act=act))
    jact = jcore.silu if act == "silu" else jcore.gelu
    for interpret in (None, True):
        h13 = jgemv.gemm_le(jnp.asarray(x), w, jnp.int32(1), jnp.int32(2), s,
                            interpret=interpret)
        want = (jact(h13[:, :H]) * h13[:, H:]).astype(jnp.bfloat16).astype(jnp.float32)
        flips += close_glu(got, want)
    assert flips <= max(2, got.numel() // 500)


def test_split_emulation_glu_matches_unsplit():
    """With the GLU pair on the full sum, the split changes only the f32 sum
    order: against glu_plain of the unsplit product."""
    rng = np.random.default_rng(11)
    w, _ = weights(rng, "e5m2", 1, 2 * 64, 14336)
    x = rng.standard_normal((16, 14336), dtype=np.float32)
    tx, tw = torch.from_numpy(x), tt(w)
    assert gemm_plan(16, 128, 14336, True).split == MAX_SPLIT
    got = gemm_split_plain(tx, tw, 0, glu_act="silu")
    assert close_glu(got, glu_plain(gemm_l_plain(tx, tw, 0), "silu")) <= 4
