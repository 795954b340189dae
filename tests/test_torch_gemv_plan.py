"""csrc/gemv.cu's gemv_kernel (K1 gemv/gemv_l, K5 gemv4_l, K10 gemv_le, K11
gemv4_le) on the CPU, where the kernel cannot run: its plan (`gemv_plan`:
128 weight rows a block, K split only where the grid starves or the staged
x would not fit), the columns each thread's mma fragments hold
(`gemv_step_cols`, against the bytes the thread loads, packed int4 from
pack_int4 included), numpy emulations of its widening of e5m2, int8 and
int4 bytes to bf16 pairs for every byte value, and a plain emulation of its
arithmetic (`gemv_split_plain`: the rmsnorm prologue, each K slice summed
in f32 with int4 group partials scaled, the slices added in slice order,
then the epilogues) against the port's plain versions and the JAX
package's gemv_l, gemv_le, gemv4_l and gemv4_le on the same numpy inputs.

Tolerances, relative to max(1, max|ref|):
- SUM_TOL (1e-5) for f32 outputs: the operands are the same bf16 values
  and every product is exact in f32, so only the order of the f32 sums
  differs (and, for the rmsnorm, the order of the sum of squares);
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
from yalm_tpu_torch.ops.cuda.gemv import (GEMV_XS_MAX, MAX_SPLIT, SMS, bf16f,
                                          gemm4_l_plain, gemv_cols, gemv_l_plain, gemv_le_plain,
                                          gemv_plan, gemv_row_blocks, gemv_split_plain,
                                          gemv_step_cols, glu_plain)
from yalm_tpu_torch.ops.int4 import int4_group, pack_int4

torch.set_num_threads(1)

SUM_TOL = 1e-5
WTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "e5m2": jnp.float8_e5m2, "int8": jnp.int8}
ITEMSIZE = {"f32": 4, "bf16": 2, "e5m2": 1, "int8": 1}


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


def packed(rng, *shape):
    """(packed int4 uint8 (..., N, K/2), group scales f32 (..., G, N))."""
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

# Mistral-7B's and Mixtral-8x7B's decode projections, their routers, both
# LM heads and the tied Gemma3 head: (name, N, K, GLU)
DECODE = [("wqkv", 6144, 4096, False), ("wo", 4096, 4096, False), ("w13", 28672, 4096, True),
          ("w2", 4096, 14336, False), ("lm_head", 32000, 4096, False),
          ("router", 8, 4096, False), ("gemma3 head", 262144, 3840, False)]
PLAN_CASES = ([(nb, N, K, glu, isz, 0) for nb in (1, 3, 8) for _, N, K, glu in DECODE
               for isz in (1, 2, 4)]
              + [(nb, N, K, glu, 1, int4_group(K)) for nb in (1, 8)
                 for _, N, K, glu in DECODE[:4] + [("g256", 300, 768, False),
                                                   ("glu", 200, 1024, True)]]
              + [(nb, N, K, glu, isz, 0) for nb in (1, 5, 8)
                 for N, K, glu in ((100, 64, False), (37, 160, False), (200, 96, True),
                                   (64, 2048, True), (300, 14336, False), (20000, 14336, False))
                 for isz in (1, 2, 4)])


def units_of(K, isz, group):
    """(slice units, iterations a unit takes): whole int4 groups, else single
    128-byte iterations of each weight row."""
    if group:
        return K // group, group // 256
    return -(-K * isz // 128), 1


@pytest.mark.parametrize("nb,N,K,glu,isz,group", PLAN_CASES)
def test_gemv_plan_covers_k_once(nb, N, K, glu, isz, group):
    """The slices cover K's iterations (ceil(K * itemsize / 128); int4: K / 256
    in whole groups) exactly once, none empty, and the staged x of a slice
    fits: nb rows of its columns as bf16 within GEMV_XS_MAX (one unit at
    least), which the kernel's shared memory takes."""
    plan = gemv_plan(nb, N, K, glu, group, isz)
    units, unit = units_of(K, isz, group)
    assert plan.kchunk % unit == 0 and plan.kchunk >= unit
    chunk = plan.kchunk // unit
    assert (plan.split - 1) * chunk < units <= plan.split * chunk
    staged = nb * plan.kchunk * gemv_cols(isz, group) * 2
    assert staged <= GEMV_XS_MAX or chunk == 1
    assert staged + nb * 16 <= 227 * 1024 - 1024


@pytest.mark.parametrize("nb,N,K,glu,isz,group", PLAN_CASES)
def test_gemv_plan_splits_only_a_starved_grid(nb, N, K, glu, isz, group):
    """K is split where the row blocks are fewer than the SMs, into at most
    MAX_SPLIT slices and no more blocks than two per SM, or where the
    staged x would not fit; a grid of SMS row blocks or more whose x fits is
    never split."""
    plan = gemv_plan(nb, N, K, glu, group, isz)
    rows = gemv_row_blocks(N, glu)
    units, unit = units_of(K, isz, group)
    fits = nb * units * unit * gemv_cols(isz, group) * 2 <= GEMV_XS_MAX
    if rows >= SMS and fits:
        assert plan.split == 1
    if plan.split > 1 and fits:
        assert rows < SMS and plan.split <= MAX_SPLIT and rows * plan.split <= 2 * SMS
    if rows < SMS and units > 1:
        assert plan.split > 1


@pytest.mark.parametrize("name,nb,N,K,glu,isz,group,plan", [
    ("wqkv e5m2", 1, 6144, 4096, False, 1, 0, (7, 5)),
    ("wo e5m2", 1, 4096, 4096, False, 1, 0, (4, 8)),
    ("w2 e5m2", 1, 4096, 14336, False, 1, 0, (14, 8)),
    ("w13 e5m2 + GLU", 1, 28672, 4096, True, 1, 0, (32, 1)),
    ("w13 e5m2 + GLU, 8 rows", 8, 28672, 4096, True, 1, 0, (32, 1)),
    ("w2 e5m2, 8 rows", 8, 4096, 14336, False, 1, 0, (14, 8)),
    ("lm_head e5m2 / int8", 1, 32000, 4096, False, 1, 0, (32, 1)),
    ("router int8", 1, 8, 4096, False, 1, 0, (2, 16)),
    ("gemma3 head", 1, 262144, 3840, False, 1, 0, (30, 1)),
    ("wqkv int4", 1, 6144, 4096, False, 1, 512, (4, 4)),
    ("wo int4", 1, 4096, 4096, False, 1, 512, (2, 8)),
    ("w2 int4", 1, 4096, 14336, False, 1, 512, (8, 7)),
    ("w13 int4 + GLU", 1, 28672, 4096, True, 1, 512, (16, 1))])
def test_gemv_plan_mistral_and_mixtral(name, nb, N, K, glu, isz, group, plan):
    """The plans at the decode shapes (a Mixtral expert's w13 and w2 are
    Mistral's): wqkv, wo and w2 split into 5-8 slices (240-256 blocks),
    w13 and the heads unsplit (224-2048 blocks)."""
    assert tuple(gemv_plan(nb, N, K, glu, group, isz)) == plan


# ---------------------------------------------------------------------------
# the fragments: which columns a thread's mma registers hold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wt", ["f32", "bf16", "e5m2", "int8"])
def test_fragments_hold_the_threads_own_bytes(wt):
    """For 16 weight rows of one iteration (128 bytes of each): thread t's
    load h (bytes 64h + 16t..) widened into pairs as the kernel does (p[2s]
    = weights 4s, 4s+1 of the chunk, p[2s+1] = 4s+2, 4s+3), its A registers
    of step s hold the columns gemv_step_cols names for its B registers;
    over the 4 threads and both loads every column of the iteration comes
    once, and the fragments' products sum to the rows' dot products."""
    isz = ITEMSIZE[wt]
    cols = gemv_cols(isz)
    rng = np.random.default_rng(isz)
    w, _ = weights(rng, wt, 16, cols)
    wv = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    x = np.asarray(jnp.asarray(rng.standard_normal(cols, dtype=np.float32))
                   .astype(jnp.bfloat16).astype(jnp.float32))
    seen = np.zeros(cols, int)
    acc = np.zeros(16, np.float64)
    for t in range(4):
        for h in range(2):
            c0 = (64 * h + 16 * t) // isz   # the chunk's first weight, by its byte offset
            steps = gemv_step_cols(t, h, isz)
            assert len(steps) * 4 == 16 // isz
            for s, (a0, a2) in enumerate(steps):
                assert a0 == (c0 + 4 * s, c0 + 4 * s + 1) and a2 == (c0 + 4 * s + 2, c0 + 4 * s + 3)
                for c in a0 + a2:
                    seen[c] += 1
                    acc += wv[:, c].astype(np.float64) * x[c]
    assert (seen == 1).all()
    np.testing.assert_allclose(acc, wv.astype(np.float64) @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("K", [768, 1024, 4096])
def test_int4_fragments_follow_pack_int4(K):
    """Packed int4 from pack_int4 (group 256 at K 768, 512 otherwise): for
    every iteration of a row (128 packed bytes, byte offset gb in its group
    g), thread t's load h holds bytes gb + 64h + 16t.. of the group; the low
    nibbles of bytes 2s, 2s+1 (a0) and their high nibbles (a2) are the
    weights pack_int4 put at the columns gemv_step_cols names (g * group +
    its columns); every column of the row comes once, and the fragments'
    scaled group partials sum to the row's dot product."""
    rng = np.random.default_rng(K)
    group = int4_group(K)
    f = rng.standard_normal((4, K), dtype=np.float32)
    p, s = pack_int4(f)                           # (4, K/2), (G, 4)
    q = np.concatenate([(p.reshape(4, -1, group // 2) & 0xF),
                        (p.reshape(4, -1, group // 2) >> 4)], -1).astype(np.float32) - 8
    q = q.reshape(4, K)                           # q - 8 at each column
    x = rng.standard_normal(K)
    seen = np.zeros(K, int)
    acc = np.zeros(4, np.float64)
    part = np.zeros(4, np.float64)
    for it in range(K // 256):
        g, gb = it * 256 // group, it * 128 % (group // 2)
        for t in range(4):
            for h in range(2):
                base = g * group // 2 + gb + 64 * h + 16 * t   # packed byte of the chunk
                chunk = p[:, base:base + 16]
                for st, (a0, a2) in enumerate(gemv_step_cols(t, h, group=group, gb=gb)):
                    lo = (chunk[:, 2 * st:2 * st + 2] & 0xF).astype(np.float32) - 8
                    hi = (chunk[:, 2 * st:2 * st + 2] >> 4).astype(np.float32) - 8
                    for j, (c_lo, c_hi) in enumerate(zip(a0, a2)):
                        c_lo, c_hi = g * group + c_lo, g * group + c_hi
                        np.testing.assert_array_equal(lo[:, j], q[:, c_lo])
                        np.testing.assert_array_equal(hi[:, j], q[:, c_hi])
                        seen[c_lo] += 1
                        seen[c_hi] += 1
                        part += lo[:, j] * x[c_lo] + hi[:, j] * x[c_hi]
        if gb + 128 == group // 2:   # the group's last iteration: its scale
            acc += part * s[g]
            part[:] = 0
    assert (seen == 1).all()
    want = sum((q[:, gg * group:(gg + 1) * group].astype(np.float64)
                @ x[gg * group:(gg + 1) * group]) * s[gg] for gg in range(K // group))
    np.testing.assert_allclose(acc, want, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# the widening, byte by byte (numpy emulations of the kernel's instructions)
# ---------------------------------------------------------------------------

def byte_perm(x, y, sel: int):
    """CUDA's __byte_perm(x, y, sel): byte i of the result is byte
    (sel >> 4i) & 7 of the eight bytes y:x."""
    v = np.asarray(x, np.uint64) | (np.asarray(y, np.uint64) << np.uint64(32))
    out = np.zeros(np.shape(v), np.uint64)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((v >> np.uint64(8 * b)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def halves(word):
    """The two bf16 halves of uint32 words as f32 values (low, high)."""
    word = np.asarray(word, np.uint32)
    return ((word << np.uint32(16)).view(np.float32), (word & np.uint32(0xFFFF0000)).view(np.float32))


def words_of_every_byte():
    """Words whose byte j runs through all 256 values (j = 0..3, rotated)."""
    b = np.arange(256, dtype=np.uint32)
    return b | ((b + 1) % 256 << 8) | ((b + 2) % 256 << 16) | ((b + 3) % 256 << 24)


def byte(w, j):
    return (w >> np.uint32(8 * j)) & np.uint32(0xFF)


def test_e5m2_widening_is_exact():
    """Widen<W_E5M2>: __byte_perm(w, 0, 0x1404 / 0x3424) puts bytes 0, 1 /
    2, 3 as the high bytes of two f16s, whose values widen exactly to f32
    and pack exactly to bf16: torch's e5m2 -> bf16 for all 256 codes
    (infinities and NaNs included)."""
    w = words_of_every_byte()
    for sel, (j0, j1) in ((0x1404, (0, 1)), (0x3424, (2, 3))):
        hv = byte_perm(w, 0, sel)
        lo = (hv & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
        hi = (hv >> 16).astype(np.uint16).view(np.float16).astype(np.float32)
        for got, j in ((lo, j0), (hi, j1)):
            codes = torch.from_numpy(byte(w, j).astype(np.uint8)).view(torch.float8_e5m2)
            want = codes.to(torch.bfloat16).float().numpy()
            packed_bf16 = bf16f(torch.from_numpy(got)).numpy()   # the pack to bf16
            for v in (got, packed_bf16):
                assert ((v == want) | (np.isnan(v) & np.isnan(want))).all()


def test_int8_widening_is_exact():
    """Widen<W_I8>: u = w ^ 0x80808080; __byte_perm(u, 0x4B000000, 0x744j)
    is the f32 2^23 + b + 128 for byte j, and minus 8388736 that is the
    signed byte b exactly, for all 256 values."""
    w = words_of_every_byte()
    u = w ^ np.uint32(0x80808080)
    for j in range(4):
        f = byte_perm(u, 0x4B000000, 0x7440 | j).view(np.float32) - np.float32(8388736)
        want = byte(w, j).astype(np.uint8).view(np.int8).astype(np.float32)
        np.testing.assert_array_equal(f, want)


def test_int4_nibble_widening_is_exact():
    """i4_quad: the low (w & 0x0f0f0f0f) and high ((w >> 4) & 0x0f0f0f0f)
    nibbles of bytes 0, 1 / 2, 3 spread by __byte_perm(., 0x43, 0x4140 /
    0x4342) under the byte 0x43 are the bf16 of 128 + q, and one bf16x2
    subtraction of 136 gives q - 8 exactly, for every byte value."""
    w = words_of_every_byte()
    for nib, shift in (((w & np.uint32(0x0F0F0F0F)), 0), (((w >> np.uint32(4)) & np.uint32(0x0F0F0F0F)), 4)):
        for sel, (j0, j1) in ((0x4140, (0, 1)), (0x4342, (2, 3))):
            lo, hi = halves(byte_perm(nib, 0x43, sel))
            for got, j in ((lo, j0), (hi, j1)):
                q = ((byte(w, j) >> np.uint32(shift)) & np.uint32(0xF)).astype(np.float32)
                np.testing.assert_array_equal(got, 128 + q)
                diff = bf16f(torch.from_numpy(got - np.float32(136))).numpy()
                np.testing.assert_array_equal(diff, q - 8)


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------

SPLIT_CASES = [  # (weight type, nb, N, K): split 2-16 ways; ragged last slices
    ("f32", 1, 200, 512), ("bf16", 3, 300, 1024), ("e5m2", 1, 384, 4096),
    ("int8", 5, 130, 2048), ("e5m2", 8, 256, 1408), ("bf16", 2, 37, 96)]


@pytest.mark.parametrize("wt,nb,N,K", SPLIT_CASES)
def test_split_emulation_matches_plain_and_jax(wt, nb, N, K):
    """gemv_split_plain with the rmsnorm prologue, the scale (int8) and a
    residual, row by row against gemv_l_plain and the JAX gemv_l's
    emulation; the JAX kernel in interpret mode where its blocks tile."""
    rng = np.random.default_rng(nb * K + N)
    L = 2
    w, s = weights(rng, wt, L, N, K)
    x = rng.standard_normal((nb, K), dtype=np.float32) * 2
    nw = (1 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    r = rng.standard_normal((nb, N), dtype=np.float32)
    plan = gemv_plan(nb, N, K, False, 0, ITEMSIZE[wt])
    assert plan.split > 1
    tw, ts, tnw = tt(w), None if s is None else tt(s), torch.from_numpy(nw)
    got = gemv_split_plain(torch.from_numpy(x), tw, 1, ts, norm_w=tnw,
                           residual=torch.from_numpy(r))
    for b in range(nb):
        close(got[b], gemv_l_plain(torch.from_numpy(x[b]), tw, 1, norm_w=tnw, scale=ts,
                                   residual=torch.from_numpy(r[b])))
        close(got[b], jgemv.gemv_l(jnp.asarray(x[b]), w, jnp.int32(1), norm_w=jnp.asarray(nw),
                                   scale=s, residual=jnp.asarray(r[b])))
    if K % 128 == 0 and N % 8 == 0 and nb == 1:
        close(got[0], jgemv.gemv_l(jnp.asarray(x[0]), w, jnp.int32(1), norm_w=jnp.asarray(nw),
                                   scale=s, residual=jnp.asarray(r[0]), interpret=True))


@pytest.mark.parametrize("wt", ["e5m2", "int8", "f32"])
def test_split_emulation_bias_and_clip(wt):
    """The bias and the clip (the QKV epilogue) act on the full sum, after
    the scale: against clamp(gemv_l_plain + bias)."""
    rng = np.random.default_rng(5)
    w, s = weights(rng, wt, 2, 192, 1024)
    x = rng.standard_normal((3, 1024), dtype=np.float32)
    b = rng.standard_normal((2, 192), dtype=np.float32)
    tw, ts = tt(w), None if s is None else tt(s)
    got = gemv_split_plain(torch.from_numpy(x), tw, 1, ts, bias=torch.from_numpy(b), clip=0.5)
    for i in range(3):
        want = torch.clamp(gemv_l_plain(torch.from_numpy(x[i]), tw, 1, scale=ts)
                           + torch.from_numpy(b[1]), -0.5, 0.5)
        close(got[i], want)


@pytest.mark.parametrize("wt,nb,act", [("e5m2", 1, "silu"), ("int8", 4, "gelu"),
                                       ("bf16", 8, "silu"), ("f32", 2, "gelu")])
def test_split_emulation_routed_glu(wt, nb, act):
    """gemv_le's form: the expert's slice of an (L, E, N, K) stack, its scale,
    the split sums, then the GLU pair; against gemv_le_plain and the JAX
    gemv_le (emulation, and the kernel in interpret mode at one row)
    composed with the JAX activation, one bf16 ulp allowed per element, the
    flips counted; with the rmsnorm prologue against gemv_le_plain."""
    rng = np.random.default_rng(nb + ITEMSIZE[wt])
    L, E, H, K = 2, 3, 96, 2048
    w, s = weights(rng, wt, L, E, 2 * H, K)
    x = rng.standard_normal((nb, K), dtype=np.float32)
    nw = (1 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    assert gemv_plan(nb, 2 * H, K, True, 0, ITEMSIZE[wt]).split > 1
    tw, ts = tt(w), None if s is None else tt(s)
    got = gemv_split_plain(torch.from_numpy(x), tw, 1, ts, expert=2, glu_act=act)
    normed = gemv_split_plain(torch.from_numpy(x), tw, 1, ts, expert=2, glu_act=act,
                              norm_w=torch.from_numpy(nw))
    jact = jcore.silu if act == "silu" else jcore.gelu
    flips = 0
    for b in range(nb):
        flips += close_glu(got[b], gemv_le_plain(torch.from_numpy(x[b]), tw, 1, 2, ts,
                                                 glu_act=act))
        flips += close_glu(normed[b], gemv_le_plain(torch.from_numpy(x[b]), tw, 1, 2, ts,
                                                    glu_act=act, norm_w=torch.from_numpy(nw)))
        for interpret in (None, True) if b == 0 else (None,):
            h13 = jgemv.gemv_le(jnp.asarray(x[b]), w, jnp.int32(1), jnp.int32(2), s,
                                interpret=interpret)
            want = (jact(h13[:H]) * h13[H:]).astype(jnp.bfloat16).astype(jnp.float32)
            flips += close_glu(got[b], want)
    assert flips <= max(2, got.numel() // 200)


@pytest.mark.parametrize("nb,N,K", [(1, 384, 1024), (3, 256, 768), (8, 128, 14336),
                                    (2, 300, 4096)])
def test_split_emulation_int4_matches_plain_and_jax(nb, N, K):
    """Packed int4 (group 256 at K 768, 512 otherwise): each group's f32
    partial times its scale, the groups of a slice in order, the slices in
    order; against gemm4_l_plain and the JAX gemv4_l row by row (emulation;
    the kernel in interpret mode where its blocks tile), with the rmsnorm
    prologue against gemv_l_plain."""
    rng = np.random.default_rng(nb + K)
    p, s = packed(rng, 2, N, K)
    x = rng.standard_normal((nb, K), dtype=np.float32) * 2
    nw = (1 + 0.1 * rng.standard_normal((2, K))).astype(np.float32)
    assert gemv_plan(nb, N, K, False, int4_group(K)).split > 1
    tx, tp, ts = torch.from_numpy(x), tt(p), tt(s)
    got = gemv_split_plain(tx, tp, 1, ts)
    close(got, gemm4_l_plain(tx, tp, 1, ts))
    normed = gemv_split_plain(tx, tp, 1, ts, norm_w=torch.from_numpy(nw))
    for b in range(nb):
        close(got[b], jgemv.gemv4_l(jnp.asarray(x[b]), jnp.asarray(p), jnp.int32(1),
                                    jnp.asarray(s)))
        close(normed[b], gemv_l_plain(tx[b], tp, 1, norm_w=torch.from_numpy(nw), scale=ts))
    if N % 128 == 0:
        close(got[0], jgemv.gemv4_l(jnp.asarray(x[0]), jnp.asarray(p), jnp.int32(1),
                                    jnp.asarray(s), interpret=True))


@pytest.mark.parametrize("nb,K,act", [(1, 4096, "silu"), (5, 768, "gelu"), (8, 1024, "silu")])
def test_split_emulation_int4_routed_glu(nb, K, act):
    """gemv4_le's form: an expert of an (L, E, N, K/2) stack with group
    scales (L, E, G, N), then the GLU pair; against gemv_le_plain and the
    JAX gemv4_le composed with the JAX activation (emulation; interpret
    mode at one row), one bf16 ulp allowed, the flips counted."""
    rng = np.random.default_rng(nb * K)
    L, E, H = 2, 3, 128
    p, s = packed(rng, L, E, 2 * H, K)
    x = rng.standard_normal((nb, K), dtype=np.float32)
    tx, tp, ts = torch.from_numpy(x), tt(p), tt(s)
    got = gemv_split_plain(tx, tp, 1, ts, expert=2, glu_act=act)
    jact = jcore.silu if act == "silu" else jcore.gelu
    flips = 0
    for b in range(nb):
        flips += close_glu(got[b], gemv_le_plain(tx[b], tp, 1, 2, ts, glu_act=act))
        for interpret in (None, True) if b == 0 else (None,):
            h13 = jgemv.gemv4_le(jnp.asarray(x[b]), jnp.asarray(p), jnp.int32(1), jnp.int32(2),
                                 jnp.asarray(s), interpret=interpret)
            want = (jact(h13[:H]) * h13[H:]).astype(jnp.bfloat16).astype(jnp.float32)
            flips += close_glu(got[b], want)
    assert flips <= max(2, got.numel() // 200)


def test_split_emulation_glu_matches_unsplit():
    """With the GLU pair on the full sum, the split changes only the f32 sum
    order: against glu_plain of the unsplit product (8 rows, K 14336)."""
    rng = np.random.default_rng(11)
    w, _ = weights(rng, "e5m2", 1, 2 * 64, 14336)
    x = rng.standard_normal((8, 14336), dtype=np.float32)
    tw = tt(w)
    assert gemv_plan(8, 128, 14336, True).split == MAX_SPLIT
    got = gemv_split_plain(torch.from_numpy(x), tw, 0, glu_act="silu")
    want = glu_plain(torch.stack([gemv_l_plain(torch.from_numpy(x[b]), tw, 0) for b in range(8)]),
                     "silu")
    assert close_glu(got, want) <= 4
