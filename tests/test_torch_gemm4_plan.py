"""csrc/gemm.cu's gemm_kernel on packed int4 weights (K5 gemm4_l, K11
gemm4_le) on the CPU, where the kernel cannot run: its plan (`gemm_plan`
with the group width: at most 128 tokens, K split at group boundaries), the
columns of X a stage holds (`gemm4_stage_cols`, the kernel's virtual order),
a numpy emulation of the kernel's nibble -> bf16 widening, and a plain
emulation of its arithmetic (`gemm4_split_plain`: each group's f32 partial
times its scale, the groups of a K slice in order, the slices in slice
order) against the port's plain versions and the JAX package's gemm4_l /
gemm4_le on the same numpy inputs.

Tolerances, relative to max(1, max|ref|):
- SUM_TOL (1e-5) for f32 outputs: the operands are the same bf16 values
  and every product is exact in f32, so only the order of the f32 sums
  (and where the scale is rounded in) differs -- also against the Pallas
  kernel in interpret mode, which sums the unsigned nibbles and subtracts
  8 * sum(x) (dot4_tile; ~2e-7 apart here);
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
from yalm_tpu_torch.ops.cuda.gemv import (GEMM_MT, MAX_SPLIT, SMS, bf16f, gemm4_l,
                                          gemm4_l_plain, gemm4_le, gemm4_split_plain,
                                          gemm4_stage_bytes, gemm4_stage_cols, gemm_le_plain,
                                          gemm_plan, gemm_row_tiles)
from yalm_tpu_torch.ops.int4 import int4_group

torch.set_num_threads(1)

SUM_TOL = 1e-5

# Mistral-7B's projections and a Mixtral-8x7B expert's: (name, N, K, GLU)
PROJ = [("wqkv", 6144, 4096, False), ("wo", 4096, 4096, False),
        ("w13", 28672, 4096, True), ("w2", 4096, 14336, False),
        ("moe w13", 28672, 4096, True), ("moe w2", 4096, 14336, False)]


def packed(rng, *shape):
    """(packed int4 uint8 (..., N, K/2), group scales f32 (..., G, N)) of
    random float weights, by the JAX package's pack_int4."""
    w = rng.standard_normal(shape, dtype=np.float32) / np.sqrt(shape[-1])
    return jgemv.pack_int4(w)


def close(got, want, tol=SUM_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
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

PLAN_CASES = [(M, N, K, glu) for M in (1, 8, 16, 17, 64, 100, 128, 129, 255, 256, 257, 1000)
              for _, N, K, glu in PROJ[:4] + [("tiny", 100, 256, False), ("g256", 384, 768, False),
                                              ("glu", 200, 1024, True)]]


@pytest.mark.parametrize("M,N,K,glu", PLAN_CASES)
def test_int4_plan_covers_every_group_once(M, N, K, glu):
    """The slices cover the stages (2 * gemm4_stage_bytes K each: 256 up to
    32 tokens, else 128) exactly once, each a whole number of groups, so
    every slice starts and ends on a group boundary; the token tile is the
    smallest of 16-128 that holds M, and never above 128 (the kernel's two
    accumulators)."""
    group = int4_group(K)
    mt, kchunk, split = gemm_plan(M, N, K, glu, group)
    assert mt in GEMM_MT[:-1] and (mt >= M or mt == 128)
    assert mt == GEMM_MT[0] or mt // 2 < M
    P = gemm4_stage_bytes(mt)
    assert P == (128 if mt <= 32 else 64)
    spg = group // (2 * P)
    assert kchunk % spg == 0 and 1 <= split <= MAX_SPLIT
    nk = K // (2 * P)
    seen = np.zeros(K // group, np.int64)
    for z in range(split):
        lo, hi = z * kchunk, min(nk, (z + 1) * kchunk)
        assert lo < hi and lo % spg == 0 and hi % spg == 0
        seen[lo // spg:hi // spg] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("M,N,K,glu", PLAN_CASES)
def test_int4_plan_splits_only_a_starved_grid(M, N, K, glu):
    """No split where one slice already gives the card's 132 blocks; else
    enough whole-group slices for two blocks per SM (at most MAX_SPLIT and
    G), and equal whole slices keep at least half of that."""
    group = int4_group(K)
    mt, _, split = gemm_plan(M, N, K, glu, group)
    blocks = gemm_row_tiles(N, glu) * -(-M // mt)
    if blocks >= SMS:
        assert split == 1
    else:
        want = min(K // group, MAX_SPLIT, -(-2 * SMS // blocks))
        assert want >= split >= want / 2


@pytest.mark.parametrize("M,name,plan", [
    (16, "wqkv", (16, 4, 4)), (16, "wo", (16, 2, 8)), (16, "w13", (16, 16, 1)),
    (16, "w2", (16, 8, 7)), (256, "wqkv", (128, 12, 3)), (256, "wo", (128, 8, 4)),
    (256, "w13", (128, 32, 1)), (256, "w2", (128, 24, 5)),
    (16, "moe w13", (16, 16, 1)), (16, "moe w2", (16, 8, 7)),
    (256, "moe w13", (128, 32, 1)), (256, "moe w2", (128, 24, 5))])
def test_int4_plan_mistral_and_mixtral(M, name, plan):
    """The plans at the tick's M 16 and a chunk's M 256: w13 (224 row tiles
    of GLU pairs; 448 blocks of 128 tokens at M 256) never splits; at M 16
    (stages of 128 packed bytes, two a group of 512) w2 (32 row tiles, 28
    groups) splits into 7 slices of 4 groups, wo into 8 of 1, wqkv (48 row
    tiles) into 4 of 2; at M 256 (stages of 64 bytes, four a group) the
    tile is 128 tokens, not the e5m2 plan's 256, and w2 splits into 5
    slices of 6 groups, wo into 4 of 2, wqkv into 3 of 3."""
    _, N, K, glu = next(c for c in PROJ if c[0] == name)
    assert tuple(gemm_plan(M, N, K, glu, int4_group(K))) == plan


def test_int4_plan_leaves_the_other_weight_types_alone():
    """group 0 is the plan of every other weight type: 256-token tiles."""
    assert tuple(gemm_plan(256, 28672, 4096, True)) == (256, 64, 1)
    assert tuple(gemm_plan(256, 28672, 4096, True, 0)) == (256, 64, 1)


# ---------------------------------------------------------------------------
# the stage-column map and the nibbles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mt", [16, 32, 64, 128])
@pytest.mark.parametrize("K", [256, 768, 1024, 14336])
def test_stage_cols_cover_k_once(K, mt):
    """Over the stages every column of X appears once; a stage's first P
    columns and its last P (P = gemm4_stage_bytes(mt)) lie in one group,
    group / 2 apart."""
    group, P = int4_group(K), gemm4_stage_bytes(mt)
    seen = np.zeros(K, np.int64)
    for kt in range(K // (2 * P)):
        cols = gemm4_stage_cols(kt, group, mt)
        assert len(cols) == 2 * P
        assert len({c // group for c in cols}) == 1
        assert [c + group // 2 for c in cols[:P]] == cols[P:]
        seen[cols] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("mt", [16, 128])
@pytest.mark.parametrize("K", [256, 768, 4096])
def test_stage_cols_match_pack_int4(K, mt):
    """Stage kt holds packed bytes P*kt..P*kt+P-1 of each row: their low
    nibbles, then their high nibbles, times the group scale, are the JAX
    package's unpack_int4 at the stage's columns (its pack_int4's order)."""
    rng = np.random.default_rng(K)
    N = 24
    p, s = packed(rng, N, K)
    p, s = np.asarray(p), np.asarray(s)
    deq = np.asarray(jgemv.unpack_int4(p, s))
    group, P = int4_group(K), gemm4_stage_bytes(mt)
    for kt in range(K // (2 * P)):
        b = p[:, P * kt:P * (kt + 1)].astype(np.int32)
        q = np.concatenate([(b & 0xF) - 8, (b >> 4) - 8], axis=1).astype(np.float32)
        cols = gemm4_stage_cols(kt, group, mt)
        np.testing.assert_array_equal(q * s[cols[0] // group][:, None], deq[:, cols])


def bf16_bits_of(v):
    """The bf16 bits of float32 values that bf16 holds exactly."""
    v = np.asarray(v, np.float32)
    bits = v.view(np.uint32)
    assert ((bits & 0xFFFF) == 0).all()
    return (bits >> 16).astype(np.uint16)


def test_nibble_widening_is_exact():
    """csrc/gemm.cu's i4_pairs for every pair of bytes (b0 at k, b1 at
    k + 1): __byte_perm(b0 | b1 << 8, 0, 0x4140) puts byte j at bit 16j; a
    nibble ORed into 0x4300 is the bf16 bits of 128 + q, and the bf16x2
    subtraction of 136 (exact, any rounding) gives q - 8 -- bit for bit the
    bf16 of (nibble - 8), low half for k, high half for k + 1."""
    b0, b1 = (a.ravel().astype(np.uint32) for a in np.meshgrid(np.arange(256), np.arange(256)))
    x = b0 | (b1 << 16)
    for word, shift in (((x & 0x000F000F) | 0x43004300, 0),
                        ((((x >> 4) & 0x000F000F) | 0x43004300), 4)):
        for half, byte in ((word & 0xFFFF, b0), (word >> 16, b1)):
            f = (half.astype(np.uint32) << 16).view(np.float32)
            assert (f == 128 + ((byte >> shift) & 0xF)).all()        # the bf16 of 128 + q
            got = bf16_bits_of(f - np.float32(136))
            want = bf16_bits_of(((byte >> shift) & 0xF).astype(np.float32) - 8)
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------

SPLIT_CASES = [  # (M, N, K): 2 to 14 slices of 1 or 2 groups, both group widths
    (1, 384, 1024), (5, 384, 768), (16, 256, 14336), (17, 384, 2048), (130, 128, 4096)]


@pytest.mark.parametrize("M,N,K", SPLIT_CASES)
def test_split_emulation_matches_plain_and_jax(M, N, K):
    """gemm4_split_plain against gemm4_l_plain, gemm4_l on the CPU, and the
    JAX gemm4_l's emulation; its kernel in interpret mode where its blocks
    tile the shape (N a multiple of 128)."""
    rng = np.random.default_rng(M + K)
    p, s = packed(rng, 2, N, K)
    x = rng.standard_normal((M, K), dtype=np.float32) * 2
    assert gemm_plan(M, N, K, False, int4_group(K)).split > 1
    tx, tp, ts = (torch.from_numpy(np.asarray(a)) for a in (x, p, s))
    got = gemm4_split_plain(tx, tp, 1, ts)
    close(got, gemm4_l_plain(tx, tp, 1, ts))
    close(got, gemm4_l(tx, tp, 1, ts))
    close(got, jgemv.gemm4_l(jnp.asarray(x), jnp.asarray(p), jnp.int32(1), jnp.asarray(s)))
    if N % 128 == 0:
        close(got, jgemv.gemm4_l(jnp.asarray(x), jnp.asarray(p), jnp.int32(1), jnp.asarray(s),
                                 interpret=True))


def test_split_emulation_residual():
    """The residual is added to the full sum of the scaled groups."""
    rng = np.random.default_rng(7)
    p, s = packed(rng, 1, 256, 2048)
    x = rng.standard_normal((9, 2048), dtype=np.float32)
    r = rng.standard_normal((9, 256), dtype=np.float32)
    tp, ts = torch.from_numpy(np.asarray(p)), torch.from_numpy(np.asarray(s))
    got = gemm4_split_plain(torch.from_numpy(x), tp, 0, ts, residual=torch.from_numpy(r))
    close(got, gemm4_l_plain(torch.from_numpy(x), tp, 0, ts) + torch.from_numpy(r))
    close(got, np.asarray(jgemv.gemm4_l(jnp.asarray(x), jnp.asarray(p), jnp.int32(0),
                                        jnp.asarray(s))) + r)


@pytest.mark.parametrize("M,K,act", [(16, 1024, "silu"), (33, 768, "gelu"), (1, 14336, "silu"),
                                     (100, 2048, "gelu")])
def test_split_emulation_routed_glu(M, K, act):
    """gemm4_le's form: the expert's slice of an (L, E, N, K/2) stack, its
    group scales, the split sums, then the GLU pair; against gemm_le_plain,
    gemm4_le on the CPU and the JAX gemm4_le (emulation, and the kernel in
    interpret mode) composed with the JAX activation, one bf16 ulp allowed
    per element, the flips counted."""
    rng = np.random.default_rng(M + K)
    L, E, H = 2, 3, 128
    p, s = packed(rng, L, E, 2 * H, K)
    x = rng.standard_normal((M, K), dtype=np.float32)
    assert gemm_plan(M, 2 * H, K, True, int4_group(K)).split > 1
    tx, tp, ts = (torch.from_numpy(np.asarray(a)) for a in (x, p, s))
    got = gemm4_split_plain(tx, tp, 1, ts, expert=2, glu_act=act)
    flips = close_glu(got, gemm_le_plain(tx, tp, 1, 2, ts, glu_act=act))
    flips += close_glu(got, gemm4_le(tx, tp, 1, torch.tensor(2), ts, glu_act=act))
    jact = jcore.silu if act == "silu" else jcore.gelu
    for interpret in (None, True):
        h13 = jgemv.gemm4_le(jnp.asarray(x), jnp.asarray(p), jnp.int32(1), jnp.int32(2),
                             jnp.asarray(s), interpret=interpret)
        flips += close_glu(got, (jact(h13[:, :H]) * h13[:, H:]).astype(jnp.bfloat16)
                           .astype(jnp.float32))
    assert flips <= max(2, got.numel() // 500)
