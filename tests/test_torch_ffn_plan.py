"""csrc/ffn.cu's ffn_kernel (K4 ffn_l and K7 ffn4_l in one cooperative launch
for 1-16 rows) on the CPU, where the kernel cannot run: its plan
(`ffn_plan`: the work items of its two phases, up to 8 rows the plans of
the two GEMV launches it replaces, `gemv_plan` for each matrix; past 8
rows the finer K split that keeps x's staged columns under GEMV_XS_MAX; the
items each block of the grid walks, the GLU columns each w2 item waits for,
the scratch layout, the counters and the grid), and its arithmetic in
plain torch (the w13 GEMV's slices at the plan's split summed in slice
order, the scales and the GLU pair rounded to bf16, then the w2 GEMV's:
`gemv_split_plain` twice) against the port's `ffn_plain` and the JAX
package's ffn_l / ffn4_l (their emulation branches) on the same numpy
inputs, for f32, bf16, int8, e5m2 and packed int4 weights, silu and gelu,
with and without the residual, at 1, 8, 9 and 16 rows.

Tolerances, relative to max(1, max|ref|):
- SUM_TOL (1e-5) for the GLU rows, each a bf16 value, within SUM_TOL of
  the plain GLU or one bf16 ulp of it where the two f32 sums straddle a
  rounding boundary (the flips are counted and must stay rare);
- OUT_TOL (2e-3, the card's tolerance) for the output: the operands are
  the same bf16 values and every sum is f32, but a GLU value one bf16 ulp
  apart moves the w2 product by that ulp times its weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.ops.pallas import ffn as jffn
from yalm_tpu.ops.pallas import gemv as jgemv
from yalm_tpu_torch.codec.format import numpy_to_torch, tag_for_numpy
from yalm_tpu_torch.ops.cuda.ffn import FFN_GRID, REGIONS, ffn_plain, ffn_plan
from yalm_tpu_torch.ops.cuda.gemv import (GEMV_PART, GEMV_ROWS, GEMV_WIN, GEMV_XS_MAX, SMS,
                                          bf16f, gemv_cols, gemv_plan, gemv_row_blocks,
                                          gemv_split_plain, glu_plain, proj_plain)
from yalm_tpu_torch.ops.int4 import int4_group

torch.set_num_threads(1)

SUM_TOL = 1e-5
OUT_TOL = 2e-3
WTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "e5m2": jnp.float8_e5m2, "int8": jnp.int8}
ITEMSIZE = {"f32": 4, "bf16": 2, "e5m2": 1, "int8": 1, "int4": 1}

# (name, dim, hidden): Mistral-7B (and Mixtral's widths), Gemma3-12B,
# Gemma2-9B, Mistral-7B's tp=2 shard, a tiny model, ragged widths
SHAPES = [("mistral", 4096, 14336), ("gemma3", 3840, 15360), ("gemma2", 3584, 14336),
          ("tp2", 4096, 7168), ("tiny", 256, 512), ("ragged", 800, 1008)]
ROWS = [1, 8, 9, 16]   # one tile's ends, the two tiles' ends


def _cases(wts):
    return [(name, K, H, wt) for name, K, H in SHAPES for wt in wts
            if wt != "int4" or (K % 256 == 0 and H % 256 == 0)]


PLAN_CASES = _cases(["e5m2", "bf16", "f32", "int4"])


def _plan(K, H, wt, nb):
    return ffn_plan(nb, K, H, ITEMSIZE[wt], wt == "int4")


def _groups(K, H, wt):
    return (int4_group(K), int4_group(H)) if wt == "int4" else (0, 0)


@pytest.mark.parametrize("name,K,H,wt", PLAN_CASES)
@pytest.mark.parametrize("nb", ROWS)
def test_ffn_plan_halves_are_the_gemv_plans(name, K, H, wt, nb):
    """Phase A's items are the w13 GEMV's (nb rows, 2H GLU rows, K columns,
    the GLU pair) and phase B's the w2 GEMV's (H -> K) gemv_plan at nb rows:
    up to 8 rows the plans of the two launches the one launch replaces, on
    one n8 tile; past 8 on two, with x's staged columns of each slice still
    under GEMV_XS_MAX (so K splits more finely). The grid is two blocks per
    SM, whatever the items."""
    plan = _plan(K, H, wt, nb)
    g13, g2 = _groups(K, H, wt)
    isz = ITEMSIZE[wt]
    assert plan.w13 == gemv_plan(nb, 2 * H, K, True, g13, isz)
    assert plan.w2 == gemv_plan(nb, K, H, False, g2, isz)
    assert plan.nt == (1 if nb <= 8 else 2)
    rows_a, rows_b = gemv_row_blocks(2 * H, True), gemv_row_blocks(K, False)
    assert plan.items == (rows_a * plan.w13.split, rows_b * plan.w2.split)
    assert plan.grid == FFN_GRID == 2 * SMS
    assert plan.counters == 2 * rows_a + rows_b + 2
    for gp, g in ((plan.w13, g13), (plan.w2, g2)):
        unit = g // (2 * GEMV_WIN) if g else 1
        assert nb * gp.kchunk * gemv_cols(isz, g) * 2 <= max(GEMV_XS_MAX,
                                                               nb * unit * gemv_cols(isz, g) * 2)
        if g:
            assert gp.kchunk % unit == 0


@pytest.mark.parametrize("name,K,H,wt", PLAN_CASES)
@pytest.mark.parametrize("nb", ROWS)
def test_ffn_plan_items_cover_both_matrices_once(name, K, H, wt, nb):
    """Block b of the grid takes A items b, b + grid, ... (item blk * split
    + z) and B items grid - 1 - b, 2 grid - 1 - b, ... (slice-major: item
    z * row blocks + blk) -- the kernel's loops: every (row block, K slice)
    of w13 and of w2 exactly once, each slice holding iterations of its
    rows, the slices together every iteration once; every block takes all
    its A items before any B item."""
    plan = _plan(K, H, wt, nb)
    isz = ITEMSIZE[wt]
    for phase, gp, N, Kp, glu in ((0, plan.w13, 2 * H, K, True), (1, plan.w2, K, H, False)):
        rows = gemv_row_blocks(N, glu)
        seen = np.zeros((rows, gp.split), np.int64)
        for b in range(plan.grid):
            start = b if phase == 0 else plan.grid - 1 - b
            for it in range(start, plan.items[phase], plan.grid):
                if phase == 0:
                    blk, z = divmod(it, gp.split)
                else:
                    z, blk = divmod(it, rows)
                seen[blk, z] += 1
        assert (seen == 1).all()
        nit = Kp // 2 // GEMV_WIN if wt == "int4" else -(-Kp * isz // GEMV_WIN)
        assert (gp.split - 1) * gp.kchunk < nit <= gp.split * gp.kchunk


def b_item_waits(plan, H, wt, z):
    """The A row blocks a w2 item of slice z waits for, as csrc/ffn.cu's
    phase B computes them: those holding GLU columns [c0, c1) of its slice,
    64 pairs a row block."""
    cols = plan.w2.kchunk * gemv_cols(ITEMSIZE[wt], int4_group(H) if wt == "int4" else 0)
    c0, c1 = z * cols, min(H, (z + 1) * cols)
    pairs = GEMV_ROWS // 2
    return set(range(c0 // pairs, (c1 - 1) // pairs + 1))


@pytest.mark.parametrize("name,K,H,wt", PLAN_CASES)
@pytest.mark.parametrize("nb", [1, 16])
def test_ffn_plan_waits_are_the_glu_columns_read(name, K, H, wt, nb):
    """Each w2 item waits for exactly the A row blocks whose GLU columns its
    K slice reads (the row blocks' pair ranges that meet the slice's
    columns), all of them A items, an earlier phase; the slices together
    wait on every A row block, and a slice's columns lie inside H."""
    plan = _plan(K, H, wt, nb)
    rows_a = gemv_row_blocks(2 * H, True)
    cols = plan.w2.kchunk * gemv_cols(ITEMSIZE[wt], int4_group(H) if wt == "int4" else 0)
    union = set()
    for z in range(plan.w2.split):
        c0, c1 = z * cols, min(H, (z + 1) * cols)
        assert 0 <= c0 < c1 <= H
        read = {p for p in range(rows_a) if 64 * p < c1 and 64 * p + 64 > c0}
        waits = b_item_waits(plan, H, wt, z)
        assert waits == read and max(waits) < rows_a
        union |= waits
    assert union == set(range(rows_a))


@pytest.mark.parametrize("name,K,H,wt", PLAN_CASES)
@pytest.mark.parametrize("nb", [1, 5, 8, 9, 16])
def test_ffn_plan_scratch_layout(name, K, H, wt, nb):
    """The regions in REGIONS' order, each 16-byte aligned and as large as
    what the kernel writes there: the normed rows (nb x K bf16), each split
    phase's item partials (256 float4 per n8 tile per item; nothing for an
    unsplit phase) and the GLU rows (nb x H bf16); none overlapping,
    `floats` their end."""
    plan = _plan(K, H, wt, nb)
    part = GEMV_PART * plan.nt
    need = dict(xn=-(-nb * K // 2), a_part=plan.items[0] * part if plan.w13.split > 1 else 0,
                glu=-(-nb * H // 2), b_part=plan.items[1] * part if plan.w2.split > 1 else 0)
    assert len(plan.offsets) == len(REGIONS) and plan.offsets[0] == 0
    ends = list(plan.offsets[1:]) + [plan.floats]
    for name_, start, end in zip(REGIONS, plan.offsets, ends):
        assert start % 4 == 0 and end - start >= need[name_] and end - start < need[name_] + 4


def test_mistral_decode_plan():
    """At Mistral-7B's widths in e5m2 the decode step's one launch is the
    two launches' 224 unsplit w13 row blocks and w2's 32 row blocks in 8
    slices of 14 iterations (1792 GLU columns, 28 A row blocks each); at 16
    rows w13 splits in 2 slices of 16 iterations."""
    p1, p16 = ffn_plan(1, 4096, 14336), ffn_plan(16, 4096, 14336)
    assert p1.items == (224, 256) and p1.w13.split == 1 and tuple(p1.w2) == (14, 8)
    assert len(b_item_waits(p1, 14336, "e5m2", 3)) == 28
    assert tuple(p16.w13) == (16, 2) and p16.nt == 2 and p16.items == (448, 256)


def tt(a):
    a = np.asarray(a)
    return numpy_to_torch(a, tag_for_numpy(a))


def weights(rng, wt, *shape):
    """(jax weights, jax scales or None): per-row scales for int8, packed
    int4 with group scales for int4."""
    if wt == "int4":
        p, s = jgemv.pack_int4(rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[-1]))
        return jnp.asarray(p), jnp.asarray(s)
    if wt == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
        s = ((rng.random(shape[:-1]) + 0.5) * 5e-4).astype(np.float32)
        return jnp.asarray(q), jnp.asarray(s)
    f = rng.standard_normal(shape, dtype=np.float32) / np.sqrt(shape[-1])
    return jnp.asarray(f).astype(WTYPES[wt]), None


def close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def glu_flips(got, want) -> int:
    """GLU rows: bf16 values, each within SUM_TOL or one bf16 ulp of the
    reference; returns the count of one-ulp flips past SUM_TOL."""
    assert torch.equal(got, bf16f(got))
    tol = SUM_TOL * max(1.0, float(want.abs().max()))
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want.abs()).exponent - 8)
    diff = (got - want).abs()
    assert bool((diff <= torch.maximum(ulp, torch.full_like(ulp, tol))).all())
    return int((diff > tol).sum())


@pytest.mark.parametrize("wt", ["f32", "bf16", "int8", "e5m2", "int4"])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("act,residual", [("silu", True), ("gelu", False)])
def test_split_arithmetic_matches_plain_and_jax(wt, rows, act, residual):
    """The one launch's sums at 2 layers, dim 256 and hidden 512 (int4: dim
    1024, hidden 1536, two and three groups of 512), where both GEMVs split
    in K at ffn_plan's splits: the w13 GEMV's GLU rows within one bf16 ulp
    of the plain GLU (rare flips); the output after the w2 GEMV within
    OUT_TOL of ffn_plain and of JAX's ffn_l / ffn4_l."""
    L, layer = 2, 1
    K, H = (1024, 1536) if wt == "int4" else (256, 512)
    rng = np.random.default_rng(rows + 7 * len(wt))
    x = (rng.standard_normal((rows, K)) * 3).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    w13, s13 = weights(rng, wt, L, 2 * H, K)
    w2, s2 = weights(rng, wt, L, K, H)
    plan = _plan(K, H, wt, rows)
    assert plan.w13.split > 1 and plan.w2.split > 1
    kw = dict(norm_eps=1e-5, act=act, add_residual=residual)
    tx, tnw = torch.from_numpy(x), torch.from_numpy(nw)
    targs = (tt(w13), tt(w2), layer, None if s13 is None else tt(s13),
             None if s2 is None else tt(s2))

    # gemv_split_plain cuts K by gemv_plan at these rows: ffn_plan's halves
    h = gemv_split_plain(tx, targs[0], layer, targs[3], norm_w=tnw, norm_eps=1e-5, glu_act=act)
    got = gemv_split_plain(h, targs[1], layer, targs[4], residual=tx if residual else None)
    xb = tx * torch.rsqrt((tx * tx).mean(-1, keepdim=True) + 1e-5) * tnw[layer]
    flips = glu_flips(h, glu_plain(proj_plain(xb, targs[0], layer, targs[3]), act))
    assert flips <= max(2, h.numel() // 100)

    close(got, ffn_plain(tx, tnw, *targs, **kw), OUT_TOL)
    if wt == "int4":
        want = jffn.ffn4_l(jnp.asarray(x), jnp.asarray(nw), w13, w2, jnp.int32(layer), s13, s2,
                           **kw)
    else:
        want = jffn.ffn_l(jnp.asarray(x), jnp.asarray(nw), w13, w2, jnp.int32(layer), s13, s2,
                          **kw)
    close(got, want, OUT_TOL)
