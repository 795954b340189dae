"""csrc/block.cu's attn_block_kernel (K3 attn_block_l and K6 attn_block4_l
in one cooperative launch) on the CPU, where the kernel cannot run: its
plan (`block_plan`: the work items of its phases against the plans of the
four launches it replaces, `gemv_plan` for each projection and
`split_plan` for the attention; its scratch layout, its counters and the
grid it asks for), and a plain emulation of its arithmetic
(`attn_block_split_plain`: the wqkv slices summed in slice order and the
epilogue after the sum, the attention in chunks, the wo slices in slice
order) against the port's `attn_block_plain` and the JAX package's
attn_block_l / attn_block4_l (their emulation branches) on the same numpy
inputs, for f32, bf16, int8, e5m2 and packed int4 weights, with and without
bias, clip and residual, in the linear and the ring regime, on bf16 and
e5m2 caches.

Tolerances, relative to max(1, max|ref|):
- SUM_TOL (2e-5) for the output: the operands are the same bf16 values and
  every sum is f32, so only the order of the sums differs, plus the rare
  bf16 rounding (of a normalised x, a softmax weight p or a mix element)
  that the two orders put on the two sides of a boundary;
- the written cache row: each element equal to the reference's or one step
  of the cache type away (2^-7 relative for bf16, 2^-2 for e5m2) where the
  f32 k/v values straddle a rounding boundary, in no more than 2% of the
  row; the rest of the cache unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.ops.pallas import block as jblock
from yalm_tpu.ops.pallas import gemv as jgemv
from yalm_tpu_torch.codec.format import numpy_to_torch, tag_for_numpy
from yalm_tpu_torch.models.fast import ring_slots
from yalm_tpu_torch.ops.cuda.attention import split_plan
from yalm_tpu_torch.ops.cuda.block import (BLOCK_GRID, REGIONS, attn_block_plain,
                                           attn_block_split_plain, block_plan)
from yalm_tpu_torch.ops.cuda.gemv import (GEMV_PART, GEMV_WIN, SMS, gemv_cols, gemv_plan,
                                          gemv_row_blocks)
from yalm_tpu_torch.ops.int4 import int4_group

torch.set_num_threads(1)

SUM_TOL = 2e-5
WTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "e5m2": jnp.float8_e5m2, "int8": jnp.int8}
ITEMSIZE = {"f32": 4, "bf16": 2, "e5m2": 1, "int8": 1, "int4": 1}
KV = {"bf16": jnp.bfloat16, "e5m2": jnp.float8_e5m2}

# (name, dim, n_heads, Hk, D): Mistral-7B's and Mixtral-8x7B's attention
# (the same widths), a tiny model, one query per kv head, head_dim 256
SHAPES = [("mistral", 4096, 32, 8, 128), ("mixtral", 4096, 32, 8, 128), ("tiny", 256, 4, 2, 64),
          ("qpk1", 512, 4, 4, 128), ("d256", 2048, 8, 4, 256)]
# (S, pos): slot 0, mid-window, one past a chunk boundary, the window's
# last slot, the ring with sinks
POSITIONS = [(4096, 0), (4096, 999), (4096, 3968), (4096, 4095), (4096, 6000), (300, 100)]


def _plan(dim, Hq, Hk, D, wt, S, pos):
    kv_sink, kv_pos, kv_len = ring_slots(pos, S)
    return (kv_sink, kv_pos, kv_len,
            block_plan(dim, Hq, Hk, D, kv_len, kv_pos, kv_sink, ITEMSIZE[wt], wt == "int4"))


@pytest.mark.parametrize("name,dim,Hq,Hk,D", SHAPES)
@pytest.mark.parametrize("wt", ["e5m2", "bf16", "f32", "int4"])
@pytest.mark.parametrize("S,pos", POSITIONS)
def test_block_plan_is_the_four_launches_plans(name, dim, Hq, Hk, D, wt, S, pos):
    """The phases' items are the four launches' blocks: the wqkv and wo
    GEMVs' gemv_plan at one row of x (int4: at their group widths) and the
    attention's split_plan from slot 0 with no skip; the grid is two
    blocks per SM, no more than the largest phase's items."""
    kv_sink, kv_pos, kv_len, plan = _plan(dim, Hq, Hk, D, wt, S, pos)
    q_dim, Nqkv = Hq * D, (Hq + 2 * Hk) * D
    i4 = wt == "int4"
    assert plan.qkv == gemv_plan(1, Nqkv, dim, False, int4_group(dim) if i4 else 0, ITEMSIZE[wt])
    assert plan.wo == gemv_plan(1, dim, q_dim, False, int4_group(q_dim) if i4 else 0,
                                ITEMSIZE[wt])
    assert plan.att == split_plan(kv_len, Hk, kv_pos=kv_pos, kv_sink=kv_sink)
    assert plan.att.lo == 0 and not plan.att.skip
    rows_a, rows_c = gemv_row_blocks(Nqkv, False), gemv_row_blocks(dim, False)
    assert plan.items == (rows_a * plan.qkv.split, Hk * plan.att.nsplit, rows_c * plan.wo.split)
    assert plan.grid == min(BLOCK_GRID, max(plan.items)) and BLOCK_GRID == 2 * SMS
    assert plan.counters == 3 * Hk + rows_c + 2 * rows_a + 1


@pytest.mark.parametrize("name,dim,Hq,Hk,D", SHAPES)
@pytest.mark.parametrize("wt", ["e5m2", "int4"])
@pytest.mark.parametrize("S,pos", POSITIONS[1:3] + POSITIONS[4:5])
def test_block_plan_items_cover_each_slice_and_chunk_once(name, dim, Hq, Hk, D, wt, S, pos):
    """Block b of the grid takes items b, b + grid, ... of each phase (the
    kernel's loops): every (row block, K slice) of each GEMV and every
    (chunk, kv head) of the attention exactly once; each slice holds
    iterations of its row, each chunk slots below kv_len."""
    kv_sink, kv_pos, kv_len, plan = _plan(dim, Hq, Hk, D, wt, S, pos)
    nA, nB, nC = plan.items
    for n, gp, N, K in ((nA, plan.qkv, (Hq + 2 * Hk) * D, dim), (nC, plan.wo, dim, Hq * D)):
        seen = np.zeros((gemv_row_blocks(N, False), gp.split), np.int64)
        for b in range(plan.grid):
            for it in range(b, n, plan.grid):
                blk, z = divmod(it, gp.split)
                seen[blk, z] += 1
        assert (seen == 1).all()
        nit = -(-K * ITEMSIZE[wt] // GEMV_WIN) if wt != "int4" else K // 2 // GEMV_WIN
        assert (gp.split - 1) * gp.kchunk < nit <= gp.split * gp.kchunk
    seen = np.zeros((Hk, plan.att.nsplit), np.int64)
    for b in range(plan.grid):
        for it in range(b, nB, plan.grid):
            h, c = divmod(it, plan.att.nsplit)
            assert c * plan.att.chunk < kv_len
            seen[h, c] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("name,dim,Hq,Hk,D", SHAPES)
@pytest.mark.parametrize("wt", ["e5m2", "bf16", "int4"])
@pytest.mark.parametrize("S,pos", POSITIONS)
def test_block_plan_scratch_layout(name, dim, Hq, Hk, D, wt, S, pos):
    """The regions in REGIONS' order, each 16-byte aligned and as large as
    what the kernel writes there (a GEMV slice's 256 float4 partials per
    item; rope's input rows; mix; the attention's partial outputs, maxima
    and sums, and scores over kv_len), none overlapping, `floats` their
    end."""
    kv_sink, kv_pos, kv_len, plan = _plan(dim, Hq, Hk, D, wt, S, pos)
    qpk, ns = Hq // Hk, plan.att.nsplit
    need = dict(qkv_part=plan.items[0] * GEMV_PART, qkv=(Hq + 2 * Hk) * D,
                wo_part=plan.items[2] * GEMV_PART,
                mix=Hq * D, att_part=Hk * ns * qpk * D, ml=Hk * ns * qpk * 2,
                scores=Hk * kv_len * qpk)
    assert len(plan.offsets) == len(REGIONS) and plan.offsets[0] == 0
    ends = list(plan.offsets[1:]) + [plan.floats]
    for name_, start, end in zip(REGIONS, plan.offsets, ends):
        assert start % 4 == 0 and end - start >= need[name_] and end - start < need[name_] + 4


@pytest.mark.parametrize("wt", ["e5m2", "int8", "bf16", "int4"])
def test_mistral_wo_slices_are_the_kv_heads(wt):
    """At Mistral's shapes the wo GEMV's K slices are exactly the kv heads'
    columns of mix (e5m2/int8: 4 iterations of 128 columns; bf16: 8 of 64;
    int4: one group of 512), the alignment a per-head dataflow would use."""
    plan = block_plan(4096, 32, 8, 128, 1000, 999, 0, ITEMSIZE[wt], wt == "int4")
    cols = gemv_cols(ITEMSIZE[wt], int4_group(4096) if wt == "int4" else 0)
    assert plan.wo.split == 8 and plan.wo.kchunk * cols == 4 * 128


def tt(a):
    a = np.asarray(a)
    return numpy_to_torch(a, tag_for_numpy(a))


def weights(rng, wt, *shape):
    """(jax weights, jax scales or None): per-row scales for int8, packed
    int4 with group scales for int4."""
    if wt == "int4":
        p, s = jgemv.pack_int4(rng.standard_normal(shape).astype(np.float32) * 0.05)
        return jnp.asarray(p), jnp.asarray(s)
    if wt == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
        return jnp.asarray(q), jnp.asarray((rng.random(shape[:-1]) * 0.01 + 1e-3).astype(np.float32))
    f = rng.standard_normal(shape, dtype=np.float32) / np.sqrt(shape[-1])
    return jnp.asarray(f).astype(WTYPES[wt]), None


def close(got, want):
    got, want = got.numpy(), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= SUM_TOL * max(1.0, float(np.abs(want).max())), err


def cache_holds(got, want, layer, kv_pos):
    """The written row equal or one step of the cache type apart (rare);
    nothing else moved."""
    g, r = got.float().numpy(), np.asarray(want, np.float32)
    step = 2.0 ** (-2 if got.dtype == torch.float8_e5m2 else -7)
    row_g, row_r = g[layer, kv_pos], r[layer, kv_pos]
    flips = row_g != row_r
    assert flips.mean() <= 0.02, flips.mean()
    assert (np.abs(row_g - row_r) <= step * np.abs(row_r) + 1e-6).all()
    g[layer, kv_pos] = row_r
    np.testing.assert_array_equal(g, r)


# (pos, bias, clip, residual, cache): the linear regime from slot 0 and
# over several chunks, the ring with sinks, the ring wrapped twice; S 300
EMU_CASES = [(0, False, None, True, "bf16"), (250, True, 4.0, False, "e5m2"),
             (500, True, 4.0, True, "bf16"), (1000, False, 4.0, False, "e5m2")]


@pytest.mark.parametrize("wt", ["f32", "bf16", "int8", "e5m2", "int4"])
@pytest.mark.parametrize("pos,bias,clip,residual,kv", EMU_CASES)
def test_split_emulation_matches_plain_and_jax(wt, pos, bias, clip, residual, kv):
    """attn_block_split_plain against attn_block_plain and JAX's
    attn_block_l / attn_block4_l at 2 layers, dim 256, 4 query and 2 kv
    heads of 64 (int4: dim 1024, 8 and 2 heads of 128, so that both
    projections hold two groups of 512), a 300-slot window (1-5 chunks of
    64 slots, wqkv and wo split in K), output and cache."""
    L, S, Hk, qpk, D, dim = (2, 300, 2, 4, 128, 1024) if wt == "int4" else (2, 300, 2, 2, 64, 256)
    Hq, layer = Hk * qpk, 1
    Nqkv = (Hq + 2 * Hk) * D
    rng = np.random.default_rng(pos + len(wt))
    x = (rng.standard_normal(dim) * 3).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal((L, dim))).astype(np.float32)
    wqkv, sq = weights(rng, wt, L, Nqkv, dim)
    wo, so = weights(rng, wt, L, dim, Hq * D)
    b = (rng.standard_normal((L, Nqkv)) * 0.2).astype(np.float32) if bias else None
    k_all = jnp.asarray(rng.standard_normal((L, S, Hk, D)).astype(np.float32)).astype(KV[kv])
    v_all = jnp.asarray(rng.standard_normal((L, S, Hk, D)).astype(np.float32)).astype(KV[kv])
    kv_sink, kv_pos, kv_len = ring_slots(pos, S)
    plan = block_plan(dim, Hq, Hk, D, kv_len, kv_pos, kv_sink, ITEMSIZE[wt], wt == "int4")
    assert plan.qkv.split > 1 and plan.wo.split > 1 and (pos == 0 or plan.att.nsplit > 1)
    kw = dict(n_heads=Hq, kv_sinks=2, theta=1e4, rotary_dim=D, norm_eps=1e-5,
              qkv_clip=np.inf if clip is None else clip, add_residual=residual)
    sl = (layer, kv_pos, kv_len, kv_sink, pos)
    targs = lambda: (torch.from_numpy(x), torch.from_numpy(nw), tt(wqkv), tt(wo))  # noqa: E731
    tkw = dict(kw, bqkv_all=None if b is None else torch.from_numpy(b),
               scale_qkv=None if sq is None else tt(sq), scale_o=None if so is None else tt(so))
    tk, tv = tt(k_all), tt(v_all)
    got = attn_block_split_plain(*targs(), tk, tv, *sl, **tkw)
    pk, pv = tt(k_all), tt(v_all)
    want = attn_block_plain(*targs(), pk, pv, *sl, **tkw)
    close(got, want)
    cache_holds(tk, pk.float().numpy(), layer, kv_pos)
    cache_holds(tv, pv.float().numpy(), layer, kv_pos)

    fn = jblock.attn_block4_l if wt == "int4" else jblock.attn_block_l
    jwant, jk, jv = fn(jnp.asarray(x), jnp.asarray(nw), wqkv, wo, k_all, v_all,
                       *(jnp.int32(s) for s in sl), scale_qkv=sq, scale_o=so,
                       bqkv_all=None if b is None else jnp.asarray(b), **kw)
    close(got, jwant)
    cache_holds(tk, jk, layer, kv_pos)
    cache_holds(tv, jv, layer, kv_pos)
