"""The port's CUDA kernels against their plain versions ON THE CARD, at
small and ragged shapes the Mistral-7B main path never gives them (odd row
counts, N not a multiple of the tile, head_dim 64, qpk 1 and 3, windows
that are not a multiple of the attention tile, a window whose scores
overflow shared memory; int4 weights with 1, 3 and 28 groups; an e5m2
cache, whose written rows must equal the plain version's byte for byte;
the batched attention over 3 lanes with their own positions, write masks
and a window whose scores live in global scratch; the paged attention over
shuffled page tables of pages of 16, 48, 64 and 256, a shared page, a page id
outside the pool, and bit for bit against the batched kernel on the
gathered cache; the FFN's many-row GEMM route at 9, 33 and 64 rows on every
weight type; the MoE routed-expert kernels over 2, 4 and 8 experts at 1 to
300 rows, the expert from the host and from a device tensor, the GLU
epilogue, an expert id outside the stack, and bit for bit against the
dense kernels on the copied expert); the Gemma forms of K2, K8 and K9
(Gemma2's score softcap, a sliding window by slot age, Gemma3's local-theta
rope, alone and together) at head_dim 128 and 256 in the linear and the
ring regime; K12 (attend_one_l) on bf16 and e5m2 caches, and equal to K2's
output on the rotated view K2 attends; K2 and K12 split over the slots
(split_plan's chunks) at kv_len 1, 63, 64, 65, a slot before, at and past
a chunk boundary and the whole window, kv_pos in the first, a middle and
the last chunk, ring windows whose chunks are skipped, two calls giving the
same bits, the per-head counters back at 0 after calls at other head
counts and splits, and a 32768-slot window; K8 and K9 split over the
window's slots (lanes_split_plan) at 1, 16 and 64 lanes, a ring window
whose chunks are mostly dead, every lane alone and in the batch bit for
bit, two calls giving the same bits, a page id outside the pool or a lane
scalar out of range on the device, and the Gemma forms on pages of 48; the
e5m2 cache of a depth-2
Mixtral-shape int4 prefill of 64 tokens, card against CPU, whose differing
bytes must all come from f32 inputs on the two sides of an e5m2 rounding
boundary; and the wgmma GEMM (gemm_kernel) on every weight type, packed
int4 included (every token tile and its ragged edges, ragged row tiles,
both int4 group widths, the GLU pair and the residual with the K split
forced off and on, two calls giving the same bits with the arrival
counters back at 0, the routed form bit for bit as the dense one on the
copied expert and NaN for an expert id outside the stack), against its
plain version and the mma.sync design it replaced; and the Hopper GEMV
(gemv_kernel) at 1 to 8 rows of x on every weight type, K split by
gemv_plan with a ragged last slice, N past a block's 128 rows, two calls
giving the same bits, an expert id outside the stack read on the device
giving NaN with every split counter left at 0, and a CUDA-graph replay on
rewritten inputs equal to the eager call; and K3/K6 as one cooperative
launch (csrc/block.cu) on e5m2, int8, bf16 and int4 weights and both cache
types, in the linear and the ring regime, with and without bias and
residual: bit for bit the four launches it replaced (output and cache) and
within TOL of the plain version, every arrival counter back at 0 after
calls at other shapes, a CUDA-graph replay equal to the uncaptured call,
and a bad layer or position refused on the host with nothing written.

These tests need a CUDA GPU and skip without one. The machine with the card
has no JAX, which tests/conftest.py imports, so run them there with
    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: 2e-3 of the largest reference magnitude -- kernel and plain
version round the same operands to bf16 and sum in f32; they differ by the
summation order and rare one-ulp bf16 flips.
"""

import math

import pytest
import torch

from yalm_tpu_torch.ops.cuda import _build
from yalm_tpu_torch.ops.cuda.attention import (_rot, attend_one_l, attend_one_plain,
                                               attend_step_batched, attend_step_batched_l,
                                               attend_step_batched_plain, attend_step_l,
                                               attend_step_paged, attend_step_paged_l,
                                               attend_step_paged_plain, attend_step_plain,
                                               lane_scalars, sink_view)
from yalm_tpu_torch.ops.cuda.block import attn_block4_l, attn_block_l, attn_block_plain
from yalm_tpu_torch.ops.cuda.ffn import ffn, ffn4_l, ffn_l, ffn_plain
from yalm_tpu_torch.ops.cuda.gemv import (bf16f, gemm4, gemm4_l, gemm4_l_plain, gemm4_le,
                                          gemm_l, gemm_l_plain, gemm_le, gemm_le_plain, gemv4,
                                          gemv4_l, gemv4_le, gemv_l_plain, gemv_le,
                                          gemv_le_plain, gemv_plan, launch_gemm, launch_gemv,
                                          proj_plain)
from yalm_tpu_torch.ops.core import silu
from yalm_tpu_torch.ops.int4 import int4_group

pytestmark = pytest.mark.cuda
TOL = 2e-3
WTYPES = [torch.float32, torch.bfloat16, torch.float8_e5m2, torch.int8]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def close(got, want):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), err


def close_bf16(got, want):
    """close() for bf16 outputs (the GLU epilogue's): an element may also
    differ by one bf16 ulp, where the two f32 values straddle a rounding
    boundary."""
    torch.cuda.synchronize()
    assert torch.equal(got, bf16f(got))
    tol = TOL * max(1.0, float(want.abs().max()))
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want.abs()).exponent - 8)
    assert bool(((got - want).abs() <= torch.clamp(ulp, min=tol)).all())


def weights(shape, wt, dev, gen):
    if wt == torch.uint8:   # packed int4: random bytes are random nibbles
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
    if wt == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    return (torch.randn(shape, generator=gen, device=dev) / math.sqrt(shape[-1])).to(wt)


# (nb, N, K, epilogue): nb 1..8; N past a 128-row block's edge; K 2176 and
# 1408 split by gemv_plan with a ragged last slice (e5m2/int8 17 or 11
# iterations of 128 bytes, bf16 34, f32 68)
GEMV_CASES = [(1, 100, 64, "norm+res"), (3, 37, 160, "scale+bias+clip"), (5, 200, 96, "glu"),
              (8, 64, 2048, "norm+glu"), (2, 300, 2176, "norm+res"),
              (4, 129, 2176, "scale+bias+clip"), (6, 258, 1408, "norm+glu"),
              (7, 1000, 512, "scale+res")]


@pytest.mark.parametrize("wt", WTYPES)
@pytest.mark.parametrize("nb,N,K,epi", GEMV_CASES)
def test_gemv_kernel(dev, wt, nb, N, K, epi):
    """gemv_kernel against the plain version, every epilogue, split K with a
    ragged last slice; a second call gives the same bits."""
    gen = torch.Generator(device=dev).manual_seed(nb * N)
    L = 3
    w = weights((L, N, K), wt, dev, gen)
    x = torch.randn(nb, K, generator=gen, device=dev) * 2
    nw = 1 + 0.1 * torch.randn(L, K, generator=gen, device=dev) if "norm" in epi else None
    sc = torch.rand(L, N, generator=gen, device=dev) + 0.5 if "scale" in epi else None
    b = torch.randn(L, N, generator=gen, device=dev) if "bias" in epi else None
    glu = "silu" if "glu" in epi else None
    n_out = N // 2 if glu else N
    res = torch.randn(nb, n_out, generator=gen, device=dev) if "res" in epi else None
    clip = 0.7 if "clip" in epi else math.inf
    got = launch_gemv("test", x, w, 2, norm_w=nw, scale=sc, bias=b, clip=clip,
                      residual=res, glu_act=glu)
    again = launch_gemv("test", x, w, 2, norm_w=nw, scale=sc, bias=b, clip=clip,
                        residual=res, glu_act=glu)
    want = torch.stack([gemv_l_plain(x[i], w, 2, norm_w=nw, scale=sc) for i in range(nb)])
    if b is not None:
        want = torch.clamp(want + b[2], -clip, clip)
    if glu:
        want = bf16f(silu(want[:, :n_out]) * want[:, n_out:])
    if res is not None:
        want = want + res
    close(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("wt", WTYPES)
@pytest.mark.parametrize("M,N,K", [(1, 100, 64), (5, 300, 96), (70, 129, 256)])
def test_gemm_kernel(dev, wt, M, N, K):
    gen = torch.Generator(device=dev).manual_seed(M + N)
    w = weights((2, N, K), wt, dev, gen)
    x = torch.randn(M, K, generator=gen, device=dev)
    sc = torch.rand(2, N, generator=gen, device=dev) + 0.5
    close(gemm_l(x, w, 1, sc), gemm_l_plain(x, w, 1, sc))
    assert _build.LAUNCHES["gemm_l"] > 0


ROPE = [1e4, ("yarn", 1e4, 4.0, 10.0, 40.0, 1.2)]


@pytest.mark.parametrize("theta", ROPE, ids=["plain", "yarn"])
@pytest.mark.parametrize("qpk,D,S,pos", [(1, 64, 100, 0), (3, 64, 100, 70),
                                         (4, 128, 100, 99), (3, 128, 100, 250),
                                         (8, 128, 200, 1000),
                                         # a long ring window: 7000 slots
                                         (8, 128, 7000, 7100)])
def test_attention_kernel(dev, theta, qpk, D, S, pos):
    gen = torch.Generator(device=dev).manual_seed(pos + qpk)
    L, Hk = 2, 3
    k_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(torch.bfloat16)
    v_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn(Hk, qpk, D, generator=gen, device=dev) * 2
    kn, vn = torch.randn(Hk, D, generator=gen, device=dev), torch.randn(Hk, D, generator=gen, device=dev)
    kv_sink = 2 if pos >= S else 0
    kv_pos = kv_sink + (pos - kv_sink) % (S - kv_sink)
    kv_len = min(pos + 1, S)
    rope = dict(kv_sinks=2, theta=theta, rotary_dim=D)
    k2, v2 = k_all.clone(), v_all.clone()
    want = attend_step_plain(q, kn, vn, k2, v2, 1, kv_pos, kv_len, kv_sink, pos, **rope)
    got = attend_step_l(q, kn, vn, k_all, v_all, 1, kv_pos, kv_len, kv_sink, pos, **rope)
    close(got, want)
    close(k_all.float(), k2.float())   # only the written row may differ (one ulp)
    assert torch.equal(v_all, v2)


@pytest.mark.parametrize("pos,bias", [(0, False), (40, True)])
def test_attn_block_kernels(dev, pos, bias):
    gen = torch.Generator(device=dev).manual_seed(pos)
    L, S, Hk, qpk, D, dim = 2, 32, 2, 2, 64, 192
    Nqkv = (Hk * qpk + 2 * Hk) * D
    x = torch.randn(dim, generator=gen, device=dev)
    nw = 1 + 0.1 * torch.randn(L, dim, generator=gen, device=dev)
    wqkv = weights((L, Nqkv, dim), torch.float8_e5m2, dev, gen)
    wo = weights((L, dim, Hk * qpk * D), torch.float8_e5m2, dev, gen)
    b = torch.randn(L, Nqkv, generator=gen, device=dev) * 0.2 if bias else None
    k_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(torch.bfloat16)
    v_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(torch.bfloat16)
    kv_sink = 2 if pos >= S else 0
    kv_pos = kv_sink + (pos - kv_sink) % (S - kv_sink)
    kw = dict(n_heads=Hk * qpk, kv_sinks=2, theta=1e4, rotary_dim=D, norm_eps=1e-5,
              qkv_clip=3.0, bqkv_all=b)
    args = (x, nw, wqkv, wo)
    want = attn_block_plain(*args, k_all.clone(), v_all.clone(), 1, kv_pos,
                            min(pos + 1, S), kv_sink, pos, **kw)
    close(attn_block_l(*args, k_all, v_all, 1, kv_pos, min(pos + 1, S), kv_sink, pos, **kw),
          want)


@pytest.mark.parametrize("B,act", [(1, "gelu"), (3, "silu")])
def test_ffn_kernels(dev, B, act):
    gen = torch.Generator(device=dev).manual_seed(B)
    L, dim, H = 2, 192, 320
    x = torch.randn(B, dim, generator=gen, device=dev) if B > 1 else torch.randn(dim, generator=gen, device=dev)
    nw = 1 + 0.1 * torch.randn(L, dim, generator=gen, device=dev)
    w13 = weights((L, 2 * H, dim), torch.int8, dev, gen)
    w2 = weights((L, dim, H), torch.int8, dev, gen)
    s13 = torch.rand(L, 2 * H, generator=gen, device=dev) * 0.01
    s2 = torch.rand(L, dim, generator=gen, device=dev) * 0.01
    kw = dict(norm_eps=1e-5, act=act)
    close(ffn_l(x, nw, w13, w2, 1, s13, s2, **kw), ffn_plain(x, nw, w13, w2, 1, s13, s2, **kw))


def gscales(L, K, N, dev, gen):
    """(L, K // group, N) int4 group scales around 0.02 / 4.6 (std of q - 8)."""
    G = K // int4_group(K)
    return (torch.rand(L, G, N, generator=gen, device=dev) + 0.5) * 4e-3


@pytest.mark.parametrize("nb,N,K,epi", [(1, 100, 256, "norm+res"), (3, 37, 768, "bias+clip"),
                                        (5, 200, 512, "glu"), (8, 64, 14336, "norm+glu"),
                                        (2, 300, 768, "norm+res"), (4, 129, 4352, "norm+res"),
                                        (6, 258, 9216, "glu"), (7, 300, 14336, "bias+clip")])
def test_gemv4_kernel(dev, nb, N, K, epi):
    """csrc/gemv.cu on packed int4: G = 1 (K 256, 512), 3 (K 768, group
    256), 17 (K 4352, group 256: split with a ragged last slice), 18 (K
    9216) and 28 (K 14336, group 512); nb 1..8; a second call gives the
    same bits."""
    gen = torch.Generator(device=dev).manual_seed(nb * N + K)
    L = 3
    w = weights((L, N, K // 2), torch.uint8, dev, gen)
    gs = gscales(L, K, N, dev, gen)
    x = torch.randn(nb, K, generator=gen, device=dev) * 2
    nw = 1 + 0.1 * torch.randn(L, K, generator=gen, device=dev) if "norm" in epi else None
    b = torch.randn(L, N, generator=gen, device=dev) if "bias" in epi else None
    glu = "silu" if "glu" in epi else None
    n_out = N // 2 if glu else N
    res = torch.randn(nb, n_out, generator=gen, device=dev) if "res" in epi else None
    clip = 0.7 if "clip" in epi else math.inf
    got = launch_gemv("test", x, w, 2, norm_w=nw, scale=gs, bias=b, clip=clip,
                      residual=res, glu_act=glu)
    assert torch.equal(got, launch_gemv("test", x, w, 2, norm_w=nw, scale=gs, bias=b,
                                        clip=clip, residual=res, glu_act=glu))
    want = torch.stack([gemv_l_plain(x[i], w, 2, norm_w=nw, scale=gs) for i in range(nb)])
    if b is not None:
        want = torch.clamp(want + b[2], -clip, clip)
    if glu:
        want = bf16f(silu(want[:, :n_out]) * want[:, n_out:])
        assert torch.equal(got, bf16f(got))   # the GLU output is rounded to bf16
    if res is not None:
        want = want + res
    close(got, want)


@pytest.mark.parametrize("M,N,K", [(1, 100, 256), (17, 300, 768), (64, 129, 512),
                                   (256, 200, 14336)])
def test_gemm4_kernel(dev, M, N, K):
    gen = torch.Generator(device=dev).manual_seed(M + N)
    w = weights((2, N, K // 2), torch.uint8, dev, gen)
    gs = gscales(2, K, N, dev, gen)
    x = torch.randn(M, K, generator=gen, device=dev)
    close(gemm4_l(x, w, 1, gs), gemm4_l_plain(x, w, 1, gs))
    assert _build.LAUNCHES["gemm4_l"] > 0


@pytest.mark.parametrize("N,K", [(100, 256), (300, 768), (64, 14336)])
def test_int4_public_wrappers(dev, N, K):
    """gemv4_l, gemv4 and gemm4 launch their kernels on CUDA tensors (and
    count them) and agree with the plain version."""
    gen = torch.Generator(device=dev).manual_seed(N + K)
    w = weights((2, N, K // 2), torch.uint8, dev, gen)
    gs = gscales(2, K, N, dev, gen)
    x = torch.randn(K, generator=gen, device=dev)
    x3 = torch.randn(3, K, generator=gen, device=dev)
    _build.LAUNCHES.clear()
    close(gemv4_l(x, w, 1, gs), gemm4_l_plain(x[None], w, 1, gs)[0])
    close(gemv4(x, w[0], gs[0]), gemm4_l_plain(x[None], w, 0, gs)[0])
    close(gemm4(x3, w[1], gs[1]), gemm4_l_plain(x3, w, 1, gs))
    assert _build.LAUNCHES["gemv4_l"] == 2 and _build.LAUNCHES["gemm4_l"] == 1


# f32 values whose e5m2 rounding is delicate: ties, the largest finite
# value, the overflow threshold (61440 rounds to inf), subnormals, zeros
E5M2_EDGES = [0.0, -0.0, 1.0, 1.125, 1.375, -1.625, 57344.0, 61439.0, 61440.0, -61440.0,
              1e6, 2.0 ** -16, 2.0 ** -17, 3 * 2.0 ** -18, 1.5e-5, -2.0 ** -15]


@pytest.mark.parametrize("qpk,D,S,pos", [(4, 128, 100, 70), (3, 64, 100, 250),
                                         (8, 128, 7000, 7100)])
def test_attention_kernel_e5m2(dev, qpk, D, S, pos):
    """The e5m2 cache: the written k/v rows equal the plain version's byte
    for byte (one f32 -> e5m2 rounding, edge values included), the rest of
    the cache is untouched, and the mix agrees (at 100 and 7000 slots)."""
    gen = torch.Generator(device=dev).manual_seed(pos + qpk)
    L, Hk = 2, 3
    e5 = torch.float8_e5m2
    k_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(e5)
    v_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(e5)
    q = torch.randn(Hk, qpk, D, generator=gen, device=dev) * 2
    kn = torch.randn(Hk, D, generator=gen, device=dev)
    vn = torch.randn(Hk, D, generator=gen, device=dev)
    edges = torch.tensor(E5M2_EDGES, device=dev)
    vn.view(-1)[:len(edges)] = edges
    vn.view(-1)[len(edges):2 * len(edges)] = edges * 1.0000001
    kv_sink = 2 if pos >= S else 0
    kv_pos = kv_sink + (pos - kv_sink) % (S - kv_sink)
    kv_len = min(pos + 1, S)
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=D)
    k2, v2 = k_all.clone(), v_all.clone()
    want = attend_step_plain(q, kn, vn, k2, v2, 1, kv_pos, kv_len, kv_sink, pos, **rope)
    got = attend_step_l(q, kn, vn, k_all, v_all, 1, kv_pos, kv_len, kv_sink, pos, **rope)
    torch.cuda.synchronize()
    assert torch.equal(k_all.view(torch.uint8), k2.view(torch.uint8))
    assert torch.equal(v_all.view(torch.uint8), v2.view(torch.uint8))
    assert got.shape == want.shape
    vn.view(-1)[:2 * len(edges)] = 0.0   # the edge values' inf makes that mix inf
    k2, v2 = k_all.clone(), v_all.clone()
    close(attend_step_l(q, kn, vn, k_all, v_all, 1, kv_pos, kv_len, kv_sink, pos, **rope),
          attend_step_plain(q, kn, vn, k2, v2, 1, kv_pos, kv_len, kv_sink, pos, **rope))


@pytest.mark.parametrize("pos", [5, 40])
def test_int4_block_and_ffn_kernels(dev, pos):
    """attn_block4_l (e5m2 cache) and ffn4_l: the int4 launch sequences."""
    gen = torch.Generator(device=dev).manual_seed(pos)
    L, S, Hk, qpk, D, dim, H = 2, 32, 2, 2, 128, 256, 768
    Nqkv, q_dim = (Hk * qpk + 2 * Hk) * D, Hk * qpk * D
    x = torch.randn(dim, generator=gen, device=dev)
    nw = 1 + 0.1 * torch.randn(L, dim, generator=gen, device=dev)
    u8 = torch.uint8
    wqkv, wo = weights((L, Nqkv, dim // 2), u8, dev, gen), weights((L, dim, q_dim // 2), u8, dev, gen)
    sqkv, so = gscales(L, dim, Nqkv, dev, gen), gscales(L, q_dim, dim, dev, gen)
    k_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(torch.float8_e5m2)
    v_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(torch.float8_e5m2)
    kv_sink = 2 if pos >= S else 0
    kv_pos = kv_sink + (pos - kv_sink) % (S - kv_sink)
    kw = dict(n_heads=Hk * qpk, kv_sinks=2, theta=1e4, rotary_dim=D, norm_eps=1e-5,
              qkv_clip=3.0, add_residual=False)
    sl = (1, kv_pos, min(pos + 1, S), kv_sink, pos)
    want = attn_block_plain(x, nw, wqkv, wo, k_all.clone(), v_all.clone(), *sl,
                            scale_qkv=sqkv, scale_o=so, **kw)
    close(attn_block4_l(x, nw, wqkv, wo, k_all, v_all, *sl, scale_qkv=sqkv, scale_o=so, **kw),
          want)
    w13, w2 = weights((L, 2 * H, dim // 2), u8, dev, gen), weights((L, dim, H // 2), u8, dev, gen)
    s13, s2 = gscales(L, dim, 2 * H, dev, gen), gscales(L, H, dim, dev, gen)
    fk = dict(norm_eps=1e-5, act="silu", add_residual=False)
    close(ffn4_l(x, nw, w13, w2, 1, s13, s2, **fk), ffn_plain(x, nw, w13, w2, 1, s13, s2, **fk))


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
@pytest.mark.parametrize("qpk,D,S", [(1, 64, 100), (2, 128, 200), (8, 128, 7000)])
def test_batched_attention_kernel(dev, kv, qpk, D, S):
    """K8 over 3 lanes: random kv_len (one ring lane with sinks), one
    write-masked lane; at S 7000 x qpk 8 the scores of every lane live in
    global scratch. The written rows equal the plain version's byte for
    byte and the masked lane's cache is untouched."""
    gen = torch.Generator(device=dev).manual_seed(S + qpk)
    B, L, Hk = 3, 2, 3
    k_all = torch.randn(B, L, S, Hk, D, generator=gen, device=dev).to(kv)
    v_all = torch.randn(B, L, S, Hk, D, generator=gen, device=dev).to(kv)
    q = torch.randn(B, Hk, qpk, D, generator=gen, device=dev) * 2
    kn = torch.randn(B, Hk, D, generator=gen, device=dev)
    vn = torch.randn(B, Hk, D, generator=gen, device=dev)
    pos = [int(torch.randint(0, S, (1,), generator=gen, device=dev)), S + 37, S // 3]
    sink = [2 if p >= S else 0 for p in pos]
    kv_pos = [s + (p - s) % (S - s) for p, s in zip(pos, sink)]
    kv_len = [min(p + 1, S) for p in pos]
    write = [1, 1, 0]
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=D)
    k2, v2 = k_all.clone(), v_all.clone()
    lanes = lane_scalars(kv_pos, kv_len, sink, pos, write, S=S, kv_sinks=2, device=dev)
    want = attend_step_batched_plain(q, kn, vn, k2, v2, 1, lanes, **rope)
    _build.LAUNCHES.clear()
    got = attend_step_batched_l(q, kn, vn, k_all, v_all, 1, kv_pos, kv_len, sink, pos, write,
                                **rope)
    close(got, want)
    bits = torch.uint8 if kv == torch.float8_e5m2 else torch.int16
    assert torch.equal(k_all.view(bits), k2.view(bits))
    assert torch.equal(v_all.view(bits), v2.view(bits))
    assert _build.LAUNCHES["attend_step_batched_l"] == 1


@pytest.mark.parametrize("wt", WTYPES[1:] + [torch.uint8], ids=["bf16", "e5m2", "int8", "int4"])
@pytest.mark.parametrize("rows", [9, 33, 64])
def test_ffn_many_rows(dev, wt, rows):
    """The FFN's GEMM route (row norm, w13 GEMM with the GLU-pair epilogue,
    w2 GEMM with the residual), past the GEMV route's 8 rows; the GLU
    output is rounded to bf16 bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(rows)
    L, dim, H = 2, 256, 768
    int4 = wt == torch.uint8
    x = torch.randn(rows, dim, generator=gen, device=dev) * 3
    nw = 1 + 0.1 * torch.randn(L, dim, generator=gen, device=dev)
    w13 = weights((L, 2 * H, dim // 2 if int4 else dim), wt, dev, gen)
    w2 = weights((L, dim, H // 2 if int4 else H), wt, dev, gen)
    if int4:
        s13, s2 = gscales(L, dim, 2 * H, dev, gen), gscales(L, H, dim, dev, gen)
    elif wt == torch.int8:
        s13 = torch.rand(L, 2 * H, generator=gen, device=dev) * 0.01
        s2 = torch.rand(L, dim, generator=gen, device=dev) * 0.01
    else:
        s13 = s2 = None
    kw = dict(norm_eps=1e-5, act="silu")
    _build.LAUNCHES.clear()
    close(ffn(x, nw, w13, w2, 1, s13, s2, **kw), ffn_plain(x, nw, w13, w2, 1, s13, s2, **kw))
    assert _build.LAUNCHES["ffn4_l_gemm" if int4 else "ffn_l_gemm"] == 1
    xb = bf16f(x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * nw[1])
    h = launch_gemm("test", xb, w13, 1, s13, glu_act="gelu")
    assert torch.equal(h, bf16f(h))
    h13 = proj_plain(xb, w13, 1, s13)
    from yalm_tpu_torch.ops.core import gelu
    close(h, bf16f(gelu(h13[:, :H]) * h13[:, H:]))


def paged_case(dev, kv, qpk, D, page, nblk, seed):
    """3 lanes over a pool of 1 + 3 * nblk pages through a random
    permutation of its pages (no lane's pages contiguous, page 0 unmapped):
    lane 0 writes past its first block, which it shares with lane 1 (a
    prefix page); lane 1 is write-masked; lane 2 is in the ring regime with
    sinks."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, L, Hk = 3, 2, 3
    S = page * nblk
    n_pages = 1 + B * nblk
    k_pool = torch.randn(n_pages, L, page, Hk, D, generator=gen, device=dev).to(kv)
    v_pool = torch.randn(n_pages, L, page, Hk, D, generator=gen, device=dev).to(kv)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    tables = perm.reshape(B, nblk).to(torch.int32)
    tables[1, 0] = tables[0, 0]
    pos = [int(torch.randint(page, S, (1,), generator=gen, device=dev)), S // 3, S + 37]
    sink = [2 if p >= S else 0 for p in pos]
    kv_pos = [s + (p - s) % (S - s) for p, s in zip(pos, sink)]
    kv_len = [min(p + 1, S) for p in pos]
    lanes = lane_scalars(kv_pos, kv_len, sink, pos, [1, 0, 1], S=S, kv_sinks=2, device=dev)
    q = torch.randn(B, Hk, qpk, D, generator=gen, device=dev) * 2
    kn = torch.randn(B, Hk, D, generator=gen, device=dev)
    vn = torch.randn(B, Hk, D, generator=gen, device=dev)
    return q, kn, vn, k_pool, v_pool, tables.to(dev), lanes


PAGED_SHAPES = [(1, 64, 16, 7), (4, 128, 64, 4), (8, 128, 256, 2),
                # a page that is not a power of two: the block index by division
                (4, 128, 48, 5),
                # 7168 slots at qpk 8: the scores past shared memory, in global scratch
                (8, 128, 256, 28)]


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
@pytest.mark.parametrize("qpk,D,page,nblk", PAGED_SHAPES)
def test_paged_attention_kernel(dev, kv, qpk, D, page, nblk):
    """K9 against its plain version: the output within the tolerance, the
    pool byte for byte (written rows, the masked lane, untouched pages)."""
    q, kn, vn, k_pool, v_pool, tables, lanes = paged_case(dev, kv, qpk, D, page, nblk,
                                                          seed=page + nblk + qpk)
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=D)
    k2, v2 = k_pool.clone(), v_pool.clone()
    want = attend_step_paged_plain(q, kn, vn, k2, v2, tables, 1, lanes.cpu(), **rope)
    _build.LAUNCHES.clear()
    sc = lanes.cpu().tolist()
    got = attend_step_paged_l(q, kn, vn, k_pool, v_pool, tables.cpu().numpy(), 1, *sc,
                              window=page * nblk, **rope)
    close(got, want)
    bits = torch.uint8 if kv == torch.float8_e5m2 else torch.int16
    assert torch.equal(k_pool.view(bits), k2.view(bits))
    assert torch.equal(v_pool.view(bits), v2.view(bits))
    assert _build.LAUNCHES["attend_step_paged_l"] == 1


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
def test_paged_attention_equals_batched_on_the_gathered_cache(dev, kv):
    """The same arithmetic over two layouts: K9 on the pool and K8 on each
    lane's pages gathered into a dense (B, L, S, Hk, D) cache give the same
    output bit for bit and write the same rows."""
    qpk, D, page, nblk = 4, 128, 64, 6
    q, kn, vn, k_pool, v_pool, tables, lanes = paged_case(dev, kv, qpk, D, page, nblk, seed=5)
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=D)

    def gathered(pool):   # (B, L, S, Hk, D)
        g = pool[tables.long()]                   # (B, nblk, L, page, Hk, D)
        return g.transpose(1, 2).reshape(g.shape[0], g.shape[2], -1, *g.shape[4:]).contiguous()
    k_all, v_all = gathered(k_pool), gathered(v_pool)
    paged = attend_step_paged(q, kn, vn, k_pool, v_pool, tables, 1, lanes, **rope)
    dense = attend_step_batched(q, kn, vn, k_all, v_all, 1, lanes, **rope)
    torch.cuda.synchronize()
    assert torch.equal(paged, dense)
    bits = torch.uint8 if kv == torch.float8_e5m2 else torch.int16
    assert torch.equal(gathered(k_pool).view(bits), k_all.view(bits))
    assert torch.equal(gathered(v_pool).view(bits), v_all.view(bits))


def test_paged_attention_page_outside_the_pool(dev):
    """A page id outside [0, n_pages) in a block the lane reads gives that
    lane a NaN output and no write; the other lanes are unaffected."""
    qpk, D, page, nblk = 4, 128, 16, 4
    q, kn, vn, k_pool, v_pool, tables, lanes = paged_case(dev, torch.bfloat16, qpk, D, page,
                                                          nblk, seed=9)
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=D)
    bad = tables.clone()
    bad[2, 1] = k_pool.shape[0]           # the ring lane reads every block
    k2, v2 = k_pool.clone(), v_pool.clone()
    want = attend_step_paged_plain(q[:2], kn[:2], vn[:2], k2, v2, tables[:2], 0,
                                   lanes.cpu()[:, :2].contiguous(), **rope)
    got = attend_step_paged(q, kn, vn, k_pool, v_pool, bad, 0, lanes, **rope)
    close(got[:2], want)
    assert bool(torch.isnan(got[2]).all())
    assert torch.equal(k_pool.view(torch.int16), k2.view(torch.int16))
    assert torch.equal(v_pool.view(torch.int16), v2.view(torch.int16))
    with pytest.raises(ValueError, match="page ids out of range"):
        attend_step_paged_l(q, kn, vn, k_pool, v_pool, bad.cpu().numpy(), 0,
                            *lanes.cpu().tolist(), window=page * nblk, **rope)


# (E, M, N, K): M 1 also runs the GEMV kernel; N not a tile multiple; int4
# groups of 256 (K 256, 768: G 1 and 3) and 512 (K 512)
ROUTED_SHAPES = [(2, 1, 100, 256), (4, 3, 37, 512), (8, 16, 129, 768), (4, 65, 300, 512),
                 (2, 300, 64, 256)]


@pytest.mark.parametrize("wt", WTYPES[1:] + [torch.uint8], ids=["bf16", "e5m2", "int8", "int4"])
@pytest.mark.parametrize("E,M,N,K", ROUTED_SHAPES)
def test_routed_expert_kernels(dev, wt, E, M, N, K):
    """K10/K11 at every (layer, expert) of an (L, E, N, K) stack with its
    per-row or group scales: against the plain version; bit for bit against
    the dense kernel on the copied expert stack (the same arithmetic, so a
    difference is an addressing fault); the id from the host and from a
    device tensor alike; the GLU epilogue (2N rows; with the rmsnorm
    prologue on the GEMV); NaN for an id outside the stack, but zeros from
    the GEMV for -1 (another rank's expert on a mesh, nothing loaded)."""
    gen = torch.Generator(device=dev).manual_seed(E * M + N)
    L, int4 = 2, wt == torch.uint8
    w = weights((L, E, 2 * N, K // 2 if int4 else K), wt, dev, gen)
    if int4:
        G = K // int4_group(K)
        sc = (torch.rand(L, E, G, 2 * N, generator=gen, device=dev) + 0.5) * 4e-3
        le, dense = gemm4_le, gemm4_l
    else:
        sc = torch.rand(L, E, 2 * N, generator=gen, device=dev) + 0.5
        le, dense = gemm_le, gemm_l
    w_e = lambda e: w[:, e].contiguous()  # noqa: E731  (the copied expert stack)
    s_e = lambda e: sc[:, e].contiguous()  # noqa: E731
    # the plain (N) projection: the first N rows (and their scales) of the stack
    wn = w[:, :, :N].contiguous()
    sn = sc[..., :N].contiguous()
    x = torch.randn(M, K, generator=gen, device=dev)
    nw = 1 + 0.1 * torch.randn(L, K, generator=gen, device=dev)
    for layer in range(L):
        for e in range(E):
            got = le(x, wn, layer, e, sn)
            close(got, gemm_le_plain(x, wn, layer, e, sn))
            e_dev = torch.tensor([e], device=dev)
            assert torch.equal(le(x, wn, layer, e_dev[0], sn), got)
            assert torch.equal(got, dense(x, wn[:, e].contiguous(), layer, sn[:, e].contiguous()))
            glu = le(x, w, layer, e_dev, sc, glu_act="silu")
            close_bf16(glu, gemm_le_plain(x, w, layer, e, sc, glu_act="silu"))
            assert torch.equal(glu, launch_gemm("check", x, w_e(e), layer, s_e(e),
                                                glu_act="silu"))
            if M == 1:
                gv = (gemv4_le if int4 else gemv_le)
                got1 = gv(x[0], wn, layer, e_dev[0], sn)
                close(got1, gemv_le_plain(x[0], wn, layer, e, sn))
                assert torch.equal(got1, launch_gemv("check", x[0], wn[:, e].contiguous(), layer,
                                                     scale=sn[:, e].contiguous()))
                g1 = gv(x[0], w, layer, e_dev[0], sc, norm_w=nw, glu_act="gelu")
                close_bf16(g1, gemv_le_plain(x[0], w, layer, e, sc, norm_w=nw, glu_act="gelu"))
                assert torch.equal(g1, launch_gemv("check", x[0], w_e(e), layer, norm_w=nw,
                                                   scale=s_e(e), glu_act="gelu"))
    for bad in (E, -1, -2):
        e_bad = torch.tensor(bad, device=dev)
        assert bool(torch.isnan(le(x, wn, 1, e_bad, sn)).all())
        assert bool(torch.isnan(le(x, w, 0, e_bad, sc, glu_act="silu")).all())
        if M == 1:
            gv = gemv4_le if int4 else gemv_le
            got = gv(x[0], wn, 1, e_bad, sn)
            assert bool((got == 0).all()) if bad == -1 else bool(torch.isnan(got).all())
            got = gv(x[0], w, 0, e_bad, sc, norm_w=nw, glu_act="silu")
            assert bool((got == 0).all()) if bad == -1 else bool(torch.isnan(got).all())
    with pytest.raises(ValueError, match="out of range"):
        le(x, wn, 0, E, sn)                      # a host id is checked on the host


# ---------------------------------------------------------------------------
# the Gemma forms of K2, K8 and K9; K12
# ---------------------------------------------------------------------------

GEMMA3_ROPE = ("gemma3", 1e6, 8.0, 1e4)
# (softcap, win, alt): Gemma2's cap, a sliding window, Gemma3's local rope, all three
FORMS = [(50.0, None, None), (0.0, 24, None), (0.0, None, 1), (30.0, 40, 1)]
FORM_IDS = ["softcap", "win", "alt", "all"]
KV_IDS = ["bf16", "e5m2"]
KVS = [torch.bfloat16, torch.float8_e5m2]


def _bits(t):
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16)


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("qpk,D,S,pos", [(2, 256, 100, 70),      # linear, window below 64
                                         (2, 256, 300, 250),     # linear, loop from a tile
                                         (2, 256, 300, 500),     # ring: sinks older than win
                                         (4, 128, 300, 299),
                                         # a long ring window: 7000 slots
                                         (8, 128, 7000, 7100)])
def test_attention_kernel_gemma_forms(dev, kv, form, qpk, D, S, pos):
    """K2 with softcap, win and alt against its plain version: the mix
    within the tolerance, the written rows byte for byte."""
    softcap, win, alt = form
    gen = torch.Generator(device=dev).manual_seed(pos + qpk + D)
    L, Hk = 2, 3
    k_all = (torch.randn(L, S, Hk, D, generator=gen, device=dev) * 3).to(kv)
    v_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(kv)
    q = torch.randn(Hk, qpk, D, generator=gen, device=dev) * 4
    kn, vn = torch.randn(Hk, D, generator=gen, device=dev) * 3, torch.randn(Hk, D, generator=gen, device=dev)
    kv_sink = 2 if pos >= S else 0
    kv_pos = kv_sink + (pos - kv_sink) % (S - kv_sink)
    kv_len = min(pos + 1, S)
    kw = dict(kv_sinks=2, theta=GEMMA3_ROPE, rotary_dim=D, softcap=softcap)
    sl = (1, kv_pos, kv_len, kv_sink, pos)
    k2, v2 = k_all.clone(), v_all.clone()
    want = attend_step_plain(q, kn, vn, k2, v2, *sl, win=win, alt=alt, **kw)
    _build.LAUNCHES.clear()
    got = attend_step_l(q, kn, vn, k_all, v_all, *sl, win, alt, **kw)
    close(got, want)
    assert torch.equal(_bits(k_all), _bits(k2)) and torch.equal(_bits(v_all), _bits(v2))
    assert _build.LAUNCHES["attend_step_l"] == 1
    if win is not None:   # the window changes the mix
        plain_all = attend_step_plain(q, kn, vn, k2.clone(), v2.clone(), *sl, alt=alt, **kw)
        assert float((plain_all - want).abs().max()) > 1e-2


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("qpk,D,S", [(2, 256, 200), (4, 128, 300)])
def test_batched_attention_kernel_gemma_forms(dev, kv, form, qpk, D, S):
    """K8 with softcap, win and alt over 4 lanes: linear past the window,
    linear inside it, a ring lane, a write-masked lane."""
    softcap, win, alt = form
    gen = torch.Generator(device=dev).manual_seed(S + qpk + D)
    B, L, Hk = 4, 2, 3
    k_all = (torch.randn(B, L, S, Hk, D, generator=gen, device=dev) * 3).to(kv)
    v_all = torch.randn(B, L, S, Hk, D, generator=gen, device=dev).to(kv)
    q = torch.randn(B, Hk, qpk, D, generator=gen, device=dev) * 4
    kn = torch.randn(B, Hk, D, generator=gen, device=dev) * 3
    vn = torch.randn(B, Hk, D, generator=gen, device=dev)
    pos = [S - 20, 10, S + 37, S // 2]
    sink = [2 if p >= S else 0 for p in pos]
    kv_pos = [s + (p - s) % (S - s) for p, s in zip(pos, sink)]
    kv_len = [min(p + 1, S) for p in pos]
    write = [1, 1, 1, 0]
    kw = dict(kv_sinks=2, theta=GEMMA3_ROPE, rotary_dim=D, softcap=softcap, win=win, alt=alt)
    k2, v2 = k_all.clone(), v_all.clone()
    lanes = lane_scalars(kv_pos, kv_len, sink, pos, write, S=S, kv_sinks=2, device=dev)
    want = attend_step_batched_plain(q, kn, vn, k2, v2, 1, lanes, **kw)
    got = attend_step_batched_l(q, kn, vn, k_all, v_all, 1, kv_pos, kv_len, sink, pos, write,
                                **kw)
    close(got, want)
    assert torch.equal(_bits(k_all), _bits(k2)) and torch.equal(_bits(v_all), _bits(v2))


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("qpk,D,page,nblk", [(2, 256, 16, 12), (4, 128, 64, 5)])
def test_paged_attention_kernel_gemma_forms(dev, kv, form, qpk, D, page, nblk):
    """K9 with softcap, win and alt through shuffled tables (ages over each
    lane's logical slots); bit for bit as K8 on the gathered cache."""
    softcap, win, alt = form
    q, kn, vn, k_pool, v_pool, tables, lanes = paged_case(dev, kv, qpk, D, page, nblk,
                                                          seed=page + qpk)
    kw = dict(kv_sinks=2, theta=GEMMA3_ROPE, rotary_dim=D, softcap=softcap, win=win, alt=alt)
    k2, v2 = k_pool.clone(), v_pool.clone()
    want = attend_step_paged_plain(q, kn, vn, k2, v2, tables, 1, lanes.cpu(), **kw)

    def gathered(pool):
        g = pool[tables.long()]
        return g.transpose(1, 2).reshape(g.shape[0], g.shape[2], -1, *g.shape[4:]).contiguous()
    k_all, v_all = gathered(k_pool), gathered(v_pool)
    got = attend_step_paged_l(q, kn, vn, k_pool, v_pool, tables.cpu().numpy(), 1,
                              *lanes.cpu().tolist(), window=page * nblk, **kw)
    close(got, want)
    assert torch.equal(_bits(k_pool), _bits(k2)) and torch.equal(_bits(v_pool), _bits(v2))
    assert torch.equal(got, attend_step_batched(q, kn, vn, k_all, v_all, 1, lanes, **kw))


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("qpk,D,S,kv_len", [(1, 64, 100, 1), (3, 64, 100, 37),
                                            (2, 256, 300, 299), (4, 128, 4096, 4096),
                                            (8, 128, 7000, 6999)])
def test_attend_one_kernel(dev, kv, qpk, D, S, kv_len):
    """K12 against its plain version; it writes nothing and takes only bf16
    and e5m2 caches."""
    gen = torch.Generator(device=dev).manual_seed(kv_len + qpk)
    L, Hk = 3, 2
    k_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(kv)
    v_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(kv)
    k0, v0 = k_all.clone(), v_all.clone()
    q = torch.randn(Hk, qpk, D, generator=gen, device=dev) * 3
    _build.LAUNCHES.clear()
    for layer in range(L):
        close(attend_one_l(q, k_all, v_all, layer, kv_len),
              attend_one_plain(q, k_all, v_all, layer, kv_len))
    assert _build.LAUNCHES["attend_one_l"] == L
    assert torch.equal(_bits(k_all), _bits(k0)) and torch.equal(_bits(v_all), _bits(v0))
    with pytest.raises(ValueError, match="float32"):
        attend_one_l(q, k_all.float(), v_all.float(), 0, kv_len)


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("kv_pos,kv_len,kv_sink,pos", [(5, 6, 0, 5), (3, 64, 2, 67),
                                                       (0, 1, 0, 0)])
def test_attend_one_equals_attend_step_on_the_rotated_view(dev, kv, kv_pos, kv_len, kv_sink,
                                                           pos):
    """The composition of tests/test_fast_path.py:123-160 on the card: K2's
    output equals K12's on the view K2 attends -- q rotated, the cache with
    K2's new row, its sink rows rotated forward by max(0, pos - S + 1) and
    rounded to bf16 -- within the tolerance (q is scaled by a product in K2
    and by a quotient in K12, and rotated by two cos/sin implementations)."""
    L, S, Hk, D, qpk, theta = 2, 64, 2, 128, 2, 1e4
    gen = torch.Generator(device=dev).manual_seed(pos)
    k_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(kv)
    v_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(kv)
    q = torch.randn(Hk, qpk, D, generator=gen, device=dev)
    kn, vn = torch.randn(Hk, D, generator=gen, device=dev), torch.randn(Hk, D, generator=gen, device=dev)
    rope = dict(kv_sinks=2, theta=theta, rotary_dim=D)
    got = attend_step_l(q, kn, vn, k_all, v_all, 0, kv_pos, kv_len, kv_sink, pos, **rope)
    view = sink_view(k_all[0], kv_sink, pos, theta=theta, rotary_dim=D).to(torch.bfloat16)
    q_rot = _rot(q.reshape(Hk * qpk, D), theta, D, pos).reshape(Hk, qpk, D)
    want = attend_one_l(q_rot, view[None].contiguous(),
                        v_all[0:1].to(torch.bfloat16).contiguous(), 0, kv_len)
    close(got, want)


def test_e5m2_cache_bytes_differ_only_across_rounding_boundaries(dev):
    """The Mixtral int4 + e5m2 depth-2 parity of chip_smoke.py (phase 4,
    the same seed-made weights and tokens) at a 64-token prefill: the card
    and the CPU compute the pre-rounding f32 k/v rows of every layer with
    different f32 summation orders (and bf16 roundings of intermediates
    that these move across a boundary). Each side's cache bytes must be its
    own f32 rows rounded to e5m2, so every byte that differs comes from f32
    inputs on the two sides of at least one e5m2 rounding boundary. In
    causal order (slot, then layer) the first row that differs must agree
    in f32 within 2e-3 of max(1, max|row|), each of its bytes within that
    and one rounding step of the other side's. A step is 25% of the
    element, and every later position attends to that row, so what differs
    after it differs by more (chip_smoke.py's phase 4 holds the outputs such
    a byte reaches)."""
    import numpy as np

    import chip_smoke as cs
    from yalm_tpu_torch.models import fast as M
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.core import apply_rope

    cfg32 = cs.mixtral8x7b(weight_dtype="int4")
    fw = cs.first_layers(cs.synth_moe_weights(cfg32, dev, seed=3), 2)
    cfg = cs.dataclasses.replace(cfg32, n_layers=2)
    prompt = 64
    toks = np.random.default_rng(5).integers(3, cfg.vocab_size, prompt + 8)[:prompt]
    e5 = torch.float8_e5m2
    q_dim, kv_dim, Hk, D = cfg.q_dim, cfg.kv_dim, cfg.n_kv_heads, cfg.head_dim
    proj = M._proj_l
    rows, caches = {}, {}
    try:
        for side, w, d in (("cuda", fw, dev), ("cpu", fw.to("cpu"), torch.device("cpu"))):
            seen = []

            def recording(x2d, w_all, layer, *a, _w=w, _seen=seen, **k):
                out = proj(x2d, w_all, layer, *a, **k)
                if w_all is _w.wqkv:
                    _seen.append(out)
                return out
            M._proj_l = recording
            cache = KVCache.init(cfg, e5, d)
            M.prefill_fast(cfg, w, toks, 0, prompt, cache, logits_mode="none")
            pos = torch.arange(prompt, device=d)
            rows[side] = [(apply_rope(qkv[:, q_dim:q_dim + kv_dim].reshape(prompt, Hk, D), pos,
                                      cfg.rope_param, cfg.rotary_dim).cpu(),
                           qkv[:, q_dim + kv_dim:].reshape(prompt, Hk, D).cpu()) for qkv in seen]
            caches[side] = (cache.k[:, :prompt].cpu(), cache.v[:, :prompt].cpu())
    finally:
        M._proj_l = proj
    diff_rows = torch.zeros(2, prompt, dtype=torch.bool)       # (layer, slot)
    for layer in range(2):
        for j, kind in enumerate("kv"):
            a_f32, b_f32 = rows["cuda"][layer][j], rows["cpu"][layer][j]
            a, b = caches["cuda"][j][layer], caches["cpu"][j][layer]
            assert torch.equal(a_f32.to(e5).view(torch.uint8), a.view(torch.uint8)), (layer, kind)
            assert torch.equal(b_f32.to(e5).view(torch.uint8), b.view(torch.uint8)), (layer, kind)
            diff = a.view(torch.uint8) != b.view(torch.uint8)
            diff_rows[layer] |= diff.flatten(1).any(-1)
            rel = float((a_f32 - b_f32).abs().max()) / max(1.0, float(b_f32.abs().max()))
            print(f"layer {layer} {kind}: {int(diff.sum())} of {diff.numel()} e5m2 bytes differ "
                  f"in {int(diff.flatten(1).any(-1).sum())} slots; f32 rows differ by {rel:.3e} "
                  "of max(1, max|row|)")
    if not bool(diff_rows.any()):
        return
    slot, layer = min((int(s_), int(l_)) for l_, s_ in diff_rows.nonzero().tolist())
    for j, kind in enumerate("kv"):
        a_f32, b_f32 = rows["cuda"][layer][j][slot], rows["cpu"][layer][j][slot]
        tol = 2e-3 * max(1.0, float(b_f32.abs().max()))
        assert float((a_f32 - b_f32).abs().max()) <= tol, (slot, layer, kind)
        a, b = a_f32.to(e5).float(), b_f32.to(e5).float()
        assert bool(((a - b).abs() <= tol + cs.e5m2_step(b)).all()), (slot, layer, kind)
        print(f"first differing row: slot {slot}, layer {layer}, {kind}: "
              f"{int((a != b).sum())} bytes, each within the tolerance and one rounding step")


# ---------------------------------------------------------------------------
# the one-lane split of K2 and K12 (split_plan's chunks, the ring window's
# skipped chunks, the per-head counters of the second launch)
# ---------------------------------------------------------------------------

NOFORM = (0.0, None, None)
# (qpk, D, Hk, S, pos, (softcap, win, alt)): kv_len 1, 63, 64 and 65 (one or
# two chunks of 64); at 4096 slots x 8 heads the chunk is 128, so kv_len
# 3967 / 3968 / 3969 lie a slot before, at and past a chunk boundary; S;
# kv_pos in the last (4095), a middle (pos 5095: slot 905) and the first
# chunk (pos 4146: slot 52) with sinks; linear and ring sliding windows
# (5999: most chunks skipped; 4100: the window wraps around the ring);
# softcap and the local rope
SPLIT_CASES = [(1, 64, 3, 300, 0, NOFORM), (8, 128, 3, 300, 62, NOFORM),
               (1, 256, 2, 300, 63, NOFORM), (8, 64, 3, 300, 64, NOFORM),
               (4, 128, 8, 4096, 3966, NOFORM), (4, 128, 8, 4096, 3967, NOFORM),
               (4, 128, 8, 4096, 3968, NOFORM), (2, 256, 8, 4096, 4095, NOFORM),
               (4, 128, 8, 4096, 5095, NOFORM), (4, 128, 8, 4096, 4146, NOFORM),
               (2, 256, 8, 4096, 3995, (0.0, 1024, 1)), (2, 256, 8, 4096, 5999, (0.0, 1024, 1)),
               (4, 128, 8, 4096, 4100, (50.0, 1024, None)), (8, 128, 3, 1000, 1700, (30.0, 100, 1)),
               (1, 64, 8, 8192, 12000, (50.0, 4096, None)), (8, 64, 3, 300, 250, (50.0, None, 1))]
SPLIT_IDS = [f"qpk{c[0]}-D{c[1]}-Hk{c[2]}-S{c[3]}-pos{c[4]}" + ("-form" if c[5] != NOFORM else "")
             for c in SPLIT_CASES]


def split_inputs(dev, kv, qpk, D, Hk, S, seed, L=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    k_all = (torch.randn(L, S, Hk, D, generator=gen, device=dev) * 2).to(kv)
    v_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(kv)
    q = torch.randn(Hk, qpk, D, generator=gen, device=dev) * 3
    kn = torch.randn(Hk, D, generator=gen, device=dev) * 2
    vn = torch.randn(Hk, D, generator=gen, device=dev)
    return q, kn, vn, k_all, v_all


def split_slots(S, pos):
    kv_sink = 2 if pos >= S else 0
    return kv_sink + (pos - kv_sink) % (S - kv_sink), min(pos + 1, S), kv_sink


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("qpk,D,Hk,S,pos,form", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_attention_kernel(dev, kv, qpk, D, Hk, S, pos, form):
    """K2's split against its plain version at ragged shapes: the output
    within the tolerance, every cache byte as the plain version leaves it,
    one counted call; a ring window's plan skips chunks."""
    from yalm_tpu_torch.ops.cuda.attention import chunk_live, split_plan
    softcap, win, alt = form
    q, kn, vn, k_all, v_all = split_inputs(dev, kv, qpk, D, Hk, S, seed=pos + D + Hk)
    kv_pos, kv_len, kv_sink = split_slots(S, pos)
    kw = dict(kv_sinks=2, theta=GEMMA3_ROPE if alt else 1e4, rotary_dim=D, softcap=softcap)
    sl = (1, kv_pos, kv_len, kv_sink, pos)
    k2, v2 = k_all.clone(), v_all.clone()
    want = attend_step_plain(q, kn, vn, k2, v2, *sl, win=win, alt=alt, **kw)
    _build.LAUNCHES.clear()
    got = attend_step_l(q, kn, vn, k_all, v_all, *sl, win, alt, **kw)
    close(got, want)
    assert torch.equal(_bits(k_all), _bits(k2)) and torch.equal(_bits(v_all), _bits(v2))
    assert _build.LAUNCHES["attend_step_l"] == 1
    plan = split_plan(kv_len, Hk, kv_pos=kv_pos, kv_sink=kv_sink, win=win or 0)
    if win and kv_sink:
        live = [chunk_live(c * plan.chunk, min((c + 1) * plan.chunk, kv_len), kv_pos, kv_sink,
                           S, win) for c in range(plan.nsplit)]
        assert not all(live)


# (qpk, D, Hk, S, kv_len): 1, 63, 64, 65, past a chunk boundary (3969 at
# 8 heads: chunks of 128), the whole window
ONE_SPLIT_CASES = [(1, 64, 3, 300, 1), (8, 128, 3, 300, 63), (1, 256, 2, 300, 64),
                   (8, 64, 3, 300, 65), (4, 128, 8, 4096, 3969), (8, 256, 8, 4096, 4096),
                   (1, 64, 8, 4096, 4096)]


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("qpk,D,Hk,S,kv_len", ONE_SPLIT_CASES)
def test_split_attend_one_kernel(dev, kv, qpk, D, Hk, S, kv_len):
    """K12's split against its plain version; the cache unwritten."""
    q, _, _, k_all, v_all = split_inputs(dev, kv, qpk, D, Hk, S, seed=kv_len + D)
    k0, v0 = k_all.clone(), v_all.clone()
    _build.LAUNCHES.clear()
    close(attend_one_l(q, k_all, v_all, 1, kv_len), attend_one_plain(q, k_all, v_all, 1, kv_len))
    assert _build.LAUNCHES["attend_one_l"] == 1
    assert torch.equal(_bits(k_all), _bits(k0)) and torch.equal(_bits(v_all), _bits(v0))


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
def test_split_attention_is_deterministic(dev, kv):
    """Two calls on the same inputs give the same bits (the second writes
    the same row again): the partials are summed in chunk order, whichever
    block of the head arrives last; K2 with a ring window, and K12."""
    q, kn, vn, k_all, v_all = split_inputs(dev, kv, 4, 128, 8, 4096, seed=3)
    kv_pos, kv_len, kv_sink = split_slots(4096, 7000)
    args = (q, kn, vn, k_all, v_all, 1, kv_pos, kv_len, kv_sink, 7000)
    kw = dict(kv_sinks=2, theta=1e4, rotary_dim=128, softcap=50.0)
    for win in (None, 1024):
        outs = [attend_step_l(*args, win, **kw) for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, outs[0]) for o in outs[1:])
    ones = [attend_one_l(q, k_all, v_all, 0, 4000) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, ones[0]) for o in ones[1:])


def test_split_counters_return_to_zero(dev):
    """A call after calls at other head counts and splits (8 heads x 32
    chunks, 3 heads x 1 chunk, 8 heads x 5 chunks, K12 at 2 heads) is still
    right: each head's last block left its counter at 0."""
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=128)
    runs = [(8, 4096, 4095), (3, 100, 40), (8, 4096, 600), (2, 300, 299), (8, 4096, 4095)]
    for i, (Hk, S, pos) in enumerate(runs):
        q, kn, vn, k_all, v_all = split_inputs(dev, torch.bfloat16, 4, 128, Hk, S, seed=i)
        if i == 3:
            close(attend_one_l(q, k_all, v_all, 0, pos + 1),
                  attend_one_plain(q, k_all, v_all, 0, pos + 1))
            continue
        kv_pos, kv_len, kv_sink = split_slots(S, pos)
        k2, v2 = k_all.clone(), v_all.clone()
        want = attend_step_plain(q, kn, vn, k2, v2, 0, kv_pos, kv_len, kv_sink, pos, **rope)
        close(attend_step_l(q, kn, vn, k_all, v_all, 0, kv_pos, kv_len, kv_sink, pos, **rope),
              want)
    from yalm_tpu_torch.ops.cuda.attention import _counter
    assert int(_counter(dev, 8).abs().sum()) == 0


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
def test_split_attention_32768_slot_window(dev, kv):
    """Mistral-7B v0.2's 32768-slot window in the ring regime at 8 heads:
    chunks of 1024 slots, the scores in the L2-resident scratch."""
    S, pos = 32768, 40000
    q, kn, vn, k_all, v_all = split_inputs(dev, kv, 4, 128, 8, S, seed=11, L=1)
    kv_pos, kv_len, kv_sink = split_slots(S, pos)
    rope = dict(kv_sinks=2, theta=1e6, rotary_dim=128)
    k2, v2 = k_all.clone(), v_all.clone()
    want = attend_step_plain(q, kn, vn, k2, v2, 0, kv_pos, kv_len, kv_sink, pos, **rope)
    close(attend_step_l(q, kn, vn, k_all, v_all, 0, kv_pos, kv_len, kv_sink, pos, **rope), want)
    assert torch.equal(_bits(k_all), _bits(k2)) and torch.equal(_bits(v_all), _bits(v2))


# ---------------------------------------------------------------------------
# K8 / K9 split over the window's slots (lanes_split_plan)
# ---------------------------------------------------------------------------

def lanes_inputs(dev, kv, B, qpk, D, Hk, S, seed, L=2, pos=None, write=None):
    """B lanes of a dense (B, L, S, Hk, D) cache: by default kv_len 1, S
    and random lengths between, one ring lane with sinks and one
    write-masked lane."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    k_all = (torch.randn(B, L, S, Hk, D, generator=gen, device=dev) * 2).to(kv)
    v_all = torch.randn(B, L, S, Hk, D, generator=gen, device=dev).to(kv)
    q = torch.randn(B, Hk, qpk, D, generator=gen, device=dev) * 3
    kn = torch.randn(B, Hk, D, generator=gen, device=dev) * 2
    vn = torch.randn(B, Hk, D, generator=gen, device=dev)
    if pos is None:
        pos = torch.randint(0, S, (B,), generator=torch.Generator().manual_seed(seed)).tolist()
        pos[0] = 0
        if B > 1:
            pos[1] = S - 1
        if B > 2:
            pos[2] = S + 37
    sink = [2 if p >= S else 0 for p in pos]
    kv_pos = [s + (p - s) % (S - s) for p, s in zip(pos, sink)]
    kv_len = [min(p + 1, S) for p in pos]
    if write is None:
        write = [1] * B
        write[-1] = 0 if B > 1 else 1
    lanes = lane_scalars(kv_pos, kv_len, sink, pos, write, S=S, kv_sinks=2, device=dev)
    return q, kn, vn, k_all, v_all, lanes


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("B", [1, 16, 64])
def test_lanes_split_batch_sizes(dev, kv, B):
    """K8 over 1, 16 and 64 lanes of kv_len 1, S and between (a ring lane, a
    write-masked lane) on a window of 16 chunks: the output within the
    tolerance, the cache byte for byte, one counted call, the counters back
    at 0."""
    from yalm_tpu_torch.ops.cuda.attention import _counter, lanes_split_plan
    qpk, D, Hk, S = 4, 128, 3, 1000
    assert lanes_split_plan(S, Hk).nsplit == 16
    q, kn, vn, k_all, v_all, lanes = lanes_inputs(dev, kv, B, qpk, D, Hk, S, seed=B)
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=D)
    k2, v2 = k_all.clone(), v_all.clone()
    want = attend_step_batched_plain(q, kn, vn, k2, v2, 1, lanes.cpu(), **rope)
    _build.LAUNCHES.clear()
    close(attend_step_batched(q, kn, vn, k_all, v_all, 1, lanes, **rope), want)
    assert torch.equal(_bits(k_all), _bits(k2)) and torch.equal(_bits(v_all), _bits(v2))
    assert _build.LAUNCHES["attend_step_batched_l"] == 1
    assert int(_counter(q.device, B * Hk).abs().sum()) == 0


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("form", [(0.0, 1024, 1), (50.0, 1024, None)], ids=["win-alt", "win-cap"])
def test_lanes_split_ring_window_mostly_dead(dev, kv, form):
    """A sliding layer over 4 lanes at 4096 slots x 8 heads (16 chunks of
    256): a ring lane whose window reads 5 of its 16 chunks, a linear lane
    past the window, a short lane and a write-masked ring lane; against the
    plain version, the cache byte for byte."""
    from yalm_tpu_torch.ops.cuda.attention import lane_chunk_live, lanes_split_plan
    softcap, win, alt = form
    qpk, D, Hk, S = 2, 128, 8, 4096
    q, kn, vn, k_all, v_all, lanes = lanes_inputs(dev, kv, 4, qpk, D, Hk, S, seed=7, L=1,
                                                  pos=[5999, 3000, 10, 4500], write=[1, 1, 1, 0])
    chunk, nsplit = lanes_split_plan(S, Hk)
    kp, kl, ks = lanes.cpu()[:3, 0].tolist()
    live = sum(lane_chunk_live(c, chunk, S, kp, kl, ks, win) for c in range(nsplit))
    assert nsplit == 16 and live == 5
    kw = dict(kv_sinks=2, theta=GEMMA3_ROPE, rotary_dim=D, softcap=softcap, win=win, alt=alt)
    k2, v2 = k_all.clone(), v_all.clone()
    want = attend_step_batched_plain(q, kn, vn, k2, v2, 0, lanes.cpu(), **kw)
    close(attend_step_batched(q, kn, vn, k_all, v_all, 0, lanes, **kw), want)
    assert torch.equal(_bits(k_all), _bits(k2)) and torch.equal(_bits(v_all), _bits(v2))


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_lanes_split_lane_alone_equals_lane_in_batch(dev, kv, paged):
    """Every lane's output has the same bits alone (B = 1) as among 16:
    the plan depends on the window alone. Paged through shuffled pages of
    48 slots (a page that is not a multiple of the tile)."""
    qpk, D, Hk, B = 4, 128, 3, 16
    page, nblk = 48, 20
    S = page * nblk
    q, kn, vn, k_all, v_all, lanes = lanes_inputs(dev, kv, B, qpk, D, Hk, S, seed=21)
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=D)
    if paged:
        perm = torch.randperm(B * nblk, generator=torch.Generator().manual_seed(21)) + 1
        tables = perm.reshape(B, nblk).to(torch.int32).to(dev)
        k_pool = torch.zeros((1 + B * nblk, 2, page, Hk, D), dtype=kv, device=dev)
        v_pool = torch.zeros_like(k_pool)
        for pool, dense in ((k_pool, k_all), (v_pool, v_all)):   # lane b's slots in its pages
            _bits(pool)[tables.long()] = _bits(dense).reshape(B, 2, nblk, page, Hk,
                                                              D).transpose(1, 2)
        step = lambda b0, b1: attend_step_paged(  # noqa: E731
            q[b0:b1], kn[b0:b1], vn[b0:b1], k_pool, v_pool, tables[b0:b1], 1,
            lanes[:, b0:b1].contiguous(), **rope)
    else:
        step = lambda b0, b1: attend_step_batched(  # noqa: E731
            q[b0:b1], kn[b0:b1], vn[b0:b1], k_all[b0:b1], v_all[b0:b1], 1,
            lanes[:, b0:b1].contiguous(), **rope)
    batch = step(0, B)
    for b in range(B):
        assert torch.equal(step(b, b + 1)[0], batch[b]), b


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
def test_lanes_split_is_deterministic(dev, kv):
    """Three calls give the same bits, dense and paged (the partials are
    summed in chunk order whichever block of a (lane, head) arrives last),
    and leave every arrival counter at 0."""
    from yalm_tpu_torch.ops.cuda.attention import _counter
    qpk, D, page, nblk = 4, 128, 64, 6
    q, kn, vn, k_pool, v_pool, tables, lanes = paged_case(dev, kv, qpk, D, page, nblk, seed=31)
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=D, softcap=30.0, win=200)
    outs = [attend_step_paged(q, kn, vn, k_pool, v_pool, tables, 1, lanes, **rope)
            for _ in range(3)]
    dense = lanes_inputs(dev, kv, 16, qpk, D, 8, 4096, seed=32, L=1)
    outs_d = [attend_step_batched(*dense[:5], 0, dense[5], **rope) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert all(torch.equal(o, outs_d[0]) for o in outs_d[1:])
    assert int(_counter(q.device, 16 * 8).abs().sum()) == 0


@pytest.mark.parametrize("page", [16, 48])
def test_lanes_split_bad_page_or_scalar(dev, page):
    """A page id outside the pool in the last block a lane reads (a block
    only the lane's last chunk reads), or a lane scalar out of range on the
    device: that lane's output is NaN and it writes nothing; the other
    lanes are unaffected, and the counters are back at 0."""
    from yalm_tpu_torch.ops.cuda.attention import _counter
    qpk, D, nblk = 4, 128, 240 // page
    q, kn, vn, k_pool, v_pool, tables, lanes = paged_case(dev, torch.bfloat16, qpk, D, page, nblk,
                                                          seed=page)
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=D)
    bad = tables.clone()
    bad[2, nblk - 1] = k_pool.shape[0]    # the ring lane reads every block
    k2, v2 = k_pool.clone(), v_pool.clone()
    want = attend_step_paged_plain(q[:2], kn[:2], vn[:2], k2, v2, tables[:2], 0,
                                   lanes.cpu()[:, :2].contiguous(), **rope)
    got = attend_step_paged(q, kn, vn, k_pool, v_pool, bad, 0, lanes, **rope)
    close(got[:2], want)
    assert bool(torch.isnan(got[2]).all())
    assert torch.equal(k_pool.view(torch.int16), k2.view(torch.int16))
    assert torch.equal(v_pool.view(torch.int16), v2.view(torch.int16))
    wrong = lanes.clone()
    wrong[1, 0] = page * nblk + 1          # lane 0's kv_len past the window
    got = attend_step_paged(q, 3 * kn, 3 * vn, k_pool, v_pool, tables, 0, wrong, **rope)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[0]).all()) and not bool(torch.isnan(got[1:]).any())
    assert torch.equal(k_pool.view(torch.int16)[tables[0].long(), 0],
                       k2.view(torch.int16)[tables[0].long(), 0])
    assert int(_counter(q.device, 3 * 3).abs().sum()) == 0


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_lanes_split_gemma_forms_page_48(dev, kv, form):
    """K9 in the Gemma forms through shuffled pages of 48 slots at head_dim
    256: against its plain version, the pool byte for byte, and bit for bit
    as K8 on the gathered cache."""
    softcap, win, alt = form
    qpk, D, page, nblk = 2, 256, 48, 5
    q, kn, vn, k_pool, v_pool, tables, lanes = paged_case(dev, kv, qpk, D, page, nblk, seed=48)
    kw = dict(kv_sinks=2, theta=GEMMA3_ROPE, rotary_dim=D, softcap=softcap, win=win, alt=alt)
    k2, v2 = k_pool.clone(), v_pool.clone()
    want = attend_step_paged_plain(q, kn, vn, k2, v2, tables, 1, lanes.cpu(), **kw)
    g = lambda pool: pool[tables.long()].transpose(1, 2).reshape(  # noqa: E731
        3, 2, page * nblk, *pool.shape[3:]).contiguous()
    k_all, v_all = g(k_pool), g(v_pool)
    got = attend_step_paged(q, kn, vn, k_pool, v_pool, tables, 1, lanes, **kw)
    close(got, want)
    assert torch.equal(_bits(k_pool), _bits(k2)) and torch.equal(_bits(v_pool), _bits(v2))
    assert torch.equal(got, attend_step_batched(q, kn, vn, k_all, v_all, 1, lanes, **kw))


# ---------------------------------------------------------------------------
# gemm_kernel (K1 gemm_l / K10 gemm_le): wgmma over a cp.async ring, split K
# ---------------------------------------------------------------------------

def gemm_v1(*args, **kw):
    """The same launch on gemm_kernel_v1, the design gemm_kernel replaced
    (chip_smoke.py's same-run yardstick)."""
    import chip_smoke
    return chip_smoke.gemm_v1(*args, **kw)


GEMM_NK = [(8, 64), (100, 96), (129, 1024), (1000, 64), (1000, 1024), (129, 14336)]


def forced_split(monkeypatch, split: bool | None):
    """gemm_plan with its K split forced on (as many one-stage slices, or
    for int4 one-group slices, as MAX_SPLIT allows) or off; None keeps the
    plan's own choice."""
    from yalm_tpu_torch.ops.cuda import gemv as G
    plan = G.gemm_plan
    if split is not None:
        def forced(M, N, K, glu=False, group=0):
            p = plan(M, N, K, glu, group)
            unit = group // (2 * G.gemm4_stage_bytes(p.mt)) if group else 1   # stages a unit
            units = K // group if group else -(-K // G.GEMM_KT)
            kchunk = (-(-units // min(units, G.MAX_SPLIT)) if split else units) * unit
            return G.GemmPlan(p.mt, kchunk, -(-units * unit // kchunk))
        monkeypatch.setattr(G, "gemm_plan", forced)


@pytest.mark.parametrize("wt", WTYPES)
@pytest.mark.parametrize("M", [1, 8, 15, 16, 17, 64, 255, 256, 257])
def test_gemm_hopper_shapes(dev, wt, M):
    """gemm_kernel against its plain version at every token tile and its
    ragged edges, N from the router's 8 to 1000 (ragged row tiles), K a
    multiple of 32 and not of 64 (96) and one of 14336 (16 slices), the
    plan's split, with scale and residual; and against gemm_kernel_v1."""
    gen = torch.Generator(device=dev).manual_seed(M)
    for N, K in GEMM_NK:
        w = weights((2, N, K), wt, dev, gen)
        x = torch.randn(M, K, generator=gen, device=dev)
        sc = torch.rand(2, N, generator=gen, device=dev) + 0.5
        res = torch.randn(M, N, generator=gen, device=dev)
        got = launch_gemm("test", x, w, 1, sc, residual=res)
        close(got, gemm_l_plain(x, w, 1, sc) + res)
        close(got, gemm_v1(x, w, 1, sc, residual=res))   # the same sums, another order


@pytest.mark.parametrize("wt", WTYPES)
@pytest.mark.parametrize("split", [False, True], ids=["split-off", "split-on"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gemm_hopper_glu(dev, monkeypatch, wt, split, act):
    """The GLU-pair epilogue (the row map of glu_rows) with the split
    forced off and on: bf16 outputs within the tolerance or one ulp."""
    forced_split(monkeypatch, split)
    gen = torch.Generator(device=dev).manual_seed(len(act) + split)
    for M, H, K in [(1, 64, 64), (17, 100, 96), (64, 200, 1024), (257, 1000, 256)]:
        w = weights((2, 2 * H, K), wt, dev, gen)
        x = torch.randn(M, K, generator=gen, device=dev)
        sc = torch.rand(2, 2 * H, generator=gen, device=dev) + 0.5
        got = launch_gemm("test", x, w, 0, sc, glu_act=act)
        from yalm_tpu_torch.ops.cuda.gemv import glu_plain
        close_bf16(got, glu_plain(gemm_l_plain(x, w, 0, sc), act))
        close_bf16(got, gemm_v1(x, w, 0, sc, glu_act=act))


@pytest.mark.parametrize("split", [False, True], ids=["split-off", "split-on"])
def test_gemm_hopper_split_residual(dev, monkeypatch, split):
    """Split forced off and on, with the residual epilogue, every type."""
    forced_split(monkeypatch, split)
    gen = torch.Generator(device=dev).manual_seed(3)
    for wt in WTYPES:
        for M, N, K in [(16, 4100, 1024), (100, 300, 2048)]:
            w = weights((1, N, K), wt, dev, gen)
            x = torch.randn(M, K, generator=gen, device=dev)
            res = torch.randn(M, N, generator=gen, device=dev)
            close(launch_gemm("test", x, w, 0, residual=res), gemm_l_plain(x, w, 0) + res)


@pytest.mark.parametrize("split", [False, True], ids=["split-off", "split-on"])
def test_gemm_hopper_deterministic(dev, monkeypatch, split):
    """Two launches on the same inputs give the same bits, split K too (the
    slices are summed in slice order), and the arrival counters are back at
    0 after each."""
    forced_split(monkeypatch, split)
    from yalm_tpu_torch.ops.cuda import gemv as G
    gen = torch.Generator(device=dev).manual_seed(4)
    w = weights((1, 4096, 14336), torch.float8_e5m2, dev, gen)
    for M in (16, 256):
        x = torch.randn(M, 14336, generator=gen, device=dev)
        a, b = launch_gemm("test", x, w, 0), launch_gemm("test", x, w, 0)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        close(a, gemm_l_plain(x, w, 0))
    for _, ctr in G._SPLIT_BUFFERS.values():
        assert int(ctr.abs().sum()) == 0


@pytest.mark.parametrize("wt", WTYPES[1:])
def test_gemm_le_hopper(dev, wt):
    """gemm_le on gemm_kernel: the expert a host int and a device int64, bit
    for bit as gemm_l on the copied expert stack (split or not, GLU or not),
    and NaN over the output for an id outside [0, E)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    L, E = 2, 4
    for M, N, K, glu in [(16, 256, 1024, None), (16, 512, 512, "silu"), (256, 4096, 512, None),
                         (33, 1000, 96, "gelu")]:
        w = weights((L, E, N, K), wt, dev, gen)
        sc = torch.rand(L, E, N, generator=gen, device=dev) + 0.5
        x = torch.randn(M, K, generator=gen, device=dev)
        we, se = w[:, 3].contiguous(), sc[:, 3].contiguous()
        got = gemm_le(x, w, 1, torch.tensor(3, device=dev), sc, glu_act=glu)
        assert torch.equal(got, gemm_le(x, w, 1, 3, sc, glu_act=glu))
        assert torch.equal(got, launch_gemm("test", x, we, 1, se, glu_act=glu))
        want = gemm_le_plain(x, w, 1, 3, sc, glu_act=glu)
        (close_bf16 if glu else close)(got, want)
        for bad in (E, -1):
            out = gemm_le(x, w, 1, torch.tensor(bad, device=dev), sc, glu_act=glu)
            torch.cuda.synchronize()
            assert bool(torch.isnan(out).all())


def test_round_rows_bf16(dev):
    """round_rows_kernel gives bf16f's bits, ties and specials included."""
    from yalm_tpu_torch.ops.cuda.gemv import launch_round_rows
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(257, 96, generator=gen, device=dev) * 100
    x[0, :8] = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0, -0.0, 1e-40,
                             1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8], device=dev)
    _build.LAUNCHES.clear()
    got = launch_round_rows(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and _build.LAUNCHES["round_rows_bf16"] == 1
    assert torch.equal(got.view(torch.int16), x.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(got.float()[1:], bf16f(x)[1:])


# ---------------------------------------------------------------------------
# gemm_kernel on packed int4 (K5 gemm4_l / K11 gemm4_le): the nibbles
# widened in registers, group scales on each group's f32 partial
# ---------------------------------------------------------------------------

GEMM4_NK = [(100, 256), (300, 768), (1000, 1024), (100, 14336)]   # group 256, 256, 512, 512


@pytest.mark.parametrize("M", [1, 15, 16, 17, 64, 127, 128, 129, 257])
def test_gemm4_hopper_shapes(dev, M):
    """gemm_kernel's int4 instances against gemm4_l_plain at every token
    tile and its ragged edges, ragged row tiles (N 100, 300, 1000), K 256,
    768 (group 256), 1024 and 14336 (group 512; 14 slices at small M),
    the plan's split, with the residual; and against gemm4_kernel_v1."""
    gen = torch.Generator(device=dev).manual_seed(M)
    for N, K in GEMM4_NK:
        w = weights((2, N, K // 2), torch.uint8, dev, gen)
        gs = gscales(2, K, N, dev, gen)
        x = torch.randn(M, K, generator=gen, device=dev)
        res = torch.randn(M, N, generator=gen, device=dev)
        got = launch_gemm("test", x, w, 1, gs, residual=res)
        close(got, gemm4_l_plain(x, w, 1, gs) + res)
        close(got, gemm_v1(x, w, 1, gs, residual=res))   # the same sums, another order


@pytest.mark.parametrize("split", [False, True], ids=["split-off", "split-on"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gemm4_hopper_glu(dev, monkeypatch, split, act):
    """The GLU-pair epilogue on int4 (each half's group scales by glu_rows'
    row map) with the split forced off and on: bf16 outputs within the
    tolerance or one ulp."""
    forced_split(monkeypatch, split)
    gen = torch.Generator(device=dev).manual_seed(len(act) + split)
    for M, H, K in [(1, 64, 256), (17, 100, 768), (64, 200, 1024), (129, 1000, 512),
                    (16, 300, 14336)]:
        w = weights((2, 2 * H, K // 2), torch.uint8, dev, gen)
        gs = gscales(2, K, 2 * H, dev, gen)
        x = torch.randn(M, K, generator=gen, device=dev)
        got = launch_gemm("test", x, w, 0, gs, glu_act=act)
        from yalm_tpu_torch.ops.cuda.gemv import glu_plain
        close_bf16(got, glu_plain(gemm4_l_plain(x, w, 0, gs), act))
        close_bf16(got, gemm_v1(x, w, 0, gs, glu_act=act))


@pytest.mark.parametrize("split", [False, True], ids=["split-off", "split-on"])
def test_gemm4_hopper_split_residual(dev, monkeypatch, split):
    """int4 with the split forced off and on, with the residual epilogue."""
    forced_split(monkeypatch, split)
    gen = torch.Generator(device=dev).manual_seed(3)
    for M, N, K in [(16, 4100, 1024), (100, 300, 2048), (128, 256, 768)]:
        w = weights((1, N, K // 2), torch.uint8, dev, gen)
        gs = gscales(1, K, N, dev, gen)
        x = torch.randn(M, K, generator=gen, device=dev)
        res = torch.randn(M, N, generator=gen, device=dev)
        close(launch_gemm("test", x, w, 0, gs, residual=res), gemm4_l_plain(x, w, 0, gs) + res)


@pytest.mark.parametrize("split", [False, True], ids=["split-off", "split-on"])
def test_gemm4_hopper_deterministic(dev, monkeypatch, split):
    """Two int4 launches on the same inputs give the same bits, split K too,
    and the arrival counters are back at 0 after each."""
    forced_split(monkeypatch, split)
    from yalm_tpu_torch.ops.cuda import gemv as G
    gen = torch.Generator(device=dev).manual_seed(4)
    w = weights((1, 4096, 14336 // 2), torch.uint8, dev, gen)
    gs = gscales(1, 14336, 4096, dev, gen)
    for M in (16, 256):
        x = torch.randn(M, 14336, generator=gen, device=dev)
        a, b = launch_gemm("test", x, w, 0, gs), launch_gemm("test", x, w, 0, gs)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        close(a, gemm4_l_plain(x, w, 0, gs))
    for _, ctr in G._SPLIT_BUFFERS.values():
        assert int(ctr.abs().sum()) == 0


def test_gemm4_le_hopper(dev):
    """gemm4_le on gemm_kernel: the expert a host int and a device int64, bit
    for bit as gemm4_l on the copied expert stack (split or not, GLU or
    not), and NaN over the output for an id outside [0, E)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    L, E = 2, 4
    for M, N, K, glu in [(16, 256, 1024, None), (16, 512, 512, "silu"), (256, 4096, 512, None),
                         (33, 1000, 768, "gelu"), (16, 256, 14336, None)]:
        w = weights((L, E, N, K // 2), torch.uint8, dev, gen)
        gs = (torch.rand(L, E, K // int4_group(K), N, generator=gen, device=dev) + 0.5) * 4e-3
        x = torch.randn(M, K, generator=gen, device=dev)
        we, ge = w[:, 3].contiguous(), gs[:, 3].contiguous()
        got = gemm4_le(x, w, 1, torch.tensor(3, device=dev), gs, glu_act=glu)
        assert torch.equal(got, gemm4_le(x, w, 1, 3, gs, glu_act=glu))
        assert torch.equal(got, launch_gemm("test", x, we, 1, ge, glu_act=glu))
        if glu is None:
            assert torch.equal(got, gemm4_l(x, we, 1, ge))
        (close_bf16 if glu else close)(got, gemm_le_plain(x, w, 1, 3, gs, glu_act=glu))
        for bad in (E, -1):
            out = gemm4_le(x, w, 1, torch.tensor(bad, device=dev), gs, glu_act=glu)
            torch.cuda.synchronize()
            assert bool(torch.isnan(out).all())


# ---------------------------------------------------------------------------
# gemv_kernel: the split's counters, a bad device expert id, a graph replay
# ---------------------------------------------------------------------------

def gemv_stack(wt, L, E, N, K, dev, gen):
    """An expert stack (L, E, N, K) of weight type wt (uint8: packed int4,
    (L, E, N, K/2)) and its scales: per row, or per int4 group."""
    if wt == torch.uint8:
        w = weights((L, E, N, K // 2), wt, dev, gen)
        return w, (torch.rand(L, E, K // int4_group(K), N, generator=gen, device=dev) + 0.5) * 4e-3
    return weights((L, E, N, K), wt, dev, gen), torch.rand(L, E, N, generator=gen, device=dev) + 0.5


@pytest.mark.parametrize("wt", [torch.float8_e5m2, torch.uint8], ids=["e5m2", "int4"])
@pytest.mark.parametrize("nb,glu", [(1, None), (8, "silu")])
def test_gemv_bad_device_expert_leaves_counters_at_zero(dev, wt, nb, glu):
    """On a split shape (N 300, K 4096: 3 row blocks, 16 or 8 slices) an
    expert id outside [0, E) read on the device gives NaN over the whole
    output -- zeros for -1, another rank's expert on a mesh -- and leaves
    every arrival counter at 0 (each block reaches the verdict before it
    counts); a good id after it gives the plain result, and the counters
    are back at 0."""
    from yalm_tpu_torch.ops.cuda import gemv as G
    gen = torch.Generator(device=dev).manual_seed(nb)
    L, E, N, K = 2, 4, 300, 4096
    w, sc = gemv_stack(wt, L, E, N, K, dev, gen)
    x = torch.randn(nb, K, generator=gen, device=dev)
    assert gemv_plan(nb, N, K, bool(glu), int4_group(K) if wt == torch.uint8 else 0).split > 1
    for bad in (E, -1, -2, 1 << 40):
        out = launch_gemv("test", x, w, 1, expert=torch.tensor(bad, device=dev), scale=sc,
                          glu_act=glu)
        torch.cuda.synchronize()
        assert bool((out == 0).all()) if bad == -1 else bool(torch.isnan(out).all())
        for _, ctr in G._SPLIT_BUFFERS.values():
            assert int(ctr.abs().sum()) == 0
    got = launch_gemv("test", x, w, 1, expert=torch.tensor(2, device=dev), scale=sc, glu_act=glu)
    want = torch.stack([gemv_le_plain(x[i], w, 1, 2, sc, glu_act=glu) for i in range(nb)])
    (close_bf16 if glu else close)(got, want)
    for _, ctr in G._SPLIT_BUFFERS.values():
        assert int(ctr.abs().sum()) == 0


@pytest.mark.parametrize("wt", [torch.float8_e5m2, torch.int8, torch.uint8],
                         ids=["e5m2", "int8", "int4"])
def test_gemv_graph_replay_equals_eager(dev, wt):
    """A split launch (wo's shape, 4096 x 4096: 8 slices) with the rmsnorm
    prologue and the residual epilogue, captured in a CUDA graph, replayed
    after x and the residual are rewritten in place: bit for bit the eager
    call on the new inputs (the counters wrap to 0, so the graph replays)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    L, N, K = 2, 4096, 4096
    w, sc = gemv_stack(wt, L, 1, N, K, dev, gen)
    w, sc = w[:, 0].contiguous(), sc[:, 0].contiguous()
    x = torch.randn(1, K, generator=gen, device=dev)
    res = torch.randn(1, N, generator=gen, device=dev)
    nw = 1 + 0.1 * torch.randn(L, K, generator=gen, device=dev)
    kw = dict(norm_w=nw, scale=sc, residual=res)
    launch_gemv("test", x, w, 1, **kw)   # buffers sized before the capture
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        launch_gemv("test", x, w, 1, **kw)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch_gemv("test", x, w, 1, **kw)
    x.copy_(torch.randn(1, K, generator=gen, device=dev))
    res.copy_(torch.randn(1, N, generator=gen, device=dev))
    graph.replay()
    torch.cuda.synchronize()
    eager = launch_gemv("test", x, w, 1, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    close(eager, gemv_l_plain(x[0], w, 1, norm_w=nw, scale=sc, residual=res[0])[None])


# ---------------------------------------------------------------------------
# K3/K6 as one cooperative launch (csrc/block.cu)
# ---------------------------------------------------------------------------

def four_launches(*args, **kw):
    """attn_block_l's function as four launches (the wqkv GEMV, the
    attention split's two passes, the wo GEMV), the sequence the one launch
    replaced and must equal bit for bit (chip_smoke.py's same-run
    yardstick)."""
    import chip_smoke
    return chip_smoke.four_launches(*args, **kw)


def block_case(dev, wt, kv, seed, bias=False, L=2, S=300, Hk=2, qpk=4, D=128, dim=1024):
    """(x, norm_w, wqkv, wo, k_all, v_all, keywords) of a block whose wqkv
    and wo GEMVs split in K (dim 1024: 8 slices of e5m2, two int4 groups)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    Hq = Hk * qpk
    Nqkv = (Hq + 2 * Hk) * D
    i4 = wt == torch.uint8
    x = torch.randn(dim, generator=gen, device=dev) * 3
    nw = 1 + 0.1 * torch.randn(L, dim, generator=gen, device=dev)
    wqkv = weights((L, Nqkv, dim // 2 if i4 else dim), wt, dev, gen)
    wo = weights((L, dim, Hq * D // 2 if i4 else Hq * D), wt, dev, gen)
    if i4:
        sq, so = gscales(L, dim, Nqkv, dev, gen), gscales(L, Hq * D, dim, dev, gen)
    elif wt == torch.int8:   # a quantized checkpoint's row scales: absmax / 127 of ~1/sqrt(K)
        sq = (torch.rand(L, Nqkv, generator=gen, device=dev) + 0.5) * 5e-4
        so = (torch.rand(L, dim, generator=gen, device=dev) + 0.5) * 5e-4
    else:
        sq = so = None
    b = torch.randn(L, Nqkv, generator=gen, device=dev) * 0.2 if bias else None
    k_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(kv)
    v_all = torch.randn(L, S, Hk, D, generator=gen, device=dev).to(kv)
    kw = dict(n_heads=Hq, kv_sinks=2, theta=1e4, rotary_dim=D, norm_eps=1e-5, qkv_clip=4.0,
              bqkv_all=b, scale_qkv=sq, scale_o=so)
    return x, nw, wqkv, wo, k_all, v_all, kw


def block_fn(wt):
    return attn_block4_l if wt == torch.uint8 else attn_block_l


BLOCK_WTS = [torch.float8_e5m2, torch.int8, torch.bfloat16, torch.uint8]
BLOCK_WT_IDS = ["e5m2", "int8", "bf16", "int4"]


@pytest.mark.parametrize("wt", BLOCK_WTS, ids=BLOCK_WT_IDS)
@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("pos,bias,residual", [(0, False, True), (100, True, False),
                                               (299, False, False), (700, True, True)])
def test_attn_block_one_launch_equals_four_launches(dev, wt, kv, pos, bias, residual):
    """The one launch gives the four-launch sequence's bits (output and the
    whole cache, the written row included) and is within TOL of the plain
    version, in the linear regime (slot 0, over 2 and 5 chunks) and the
    ring with sinks, with and without bias and residual."""
    x, nw, wqkv, wo, k_all, v_all, kw = block_case(dev, wt, kv, pos, bias)
    kw["add_residual"] = residual
    S = k_all.shape[1]
    kv_sink = 2 if pos >= S else 0
    sl = (1, kv_sink + (pos - kv_sink) % (S - kv_sink), min(pos + 1, S), kv_sink, pos)
    k4, v4, kp, vp = k_all.clone(), v_all.clone(), k_all.clone(), v_all.clone()
    want = four_launches(x, nw, wqkv, wo, k4, v4, *sl, **kw)
    got = block_fn(wt)(x, nw, wqkv, wo, k_all, v_all, *sl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(_bits(k_all), _bits(k4)) and torch.equal(_bits(v_all), _bits(v4))
    close(got, attn_block_plain(x, nw, wqkv, wo, kp, vp, *sl, **kw))


@pytest.mark.parametrize("wt", [torch.float8_e5m2, torch.uint8], ids=["e5m2", "int4"])
def test_attn_block_counters_return_to_zero(dev, wt):
    """After calls at other head counts, windows and splits (and a GEMV
    split between them on the same buffers), every arrival counter is back
    at 0 and a later call is still the four launches' bits."""
    from yalm_tpu_torch.ops.cuda import gemv as G
    for i, (Hk, qpk, S, pos) in enumerate([(2, 4, 300, 250), (4, 2, 600, 599), (1, 8, 64, 63),
                                           (2, 4, 300, 700)]):
        x, nw, wqkv, wo, k_all, v_all, kw = block_case(dev, wt, torch.bfloat16, i, Hk=Hk,
                                                       qpk=qpk, S=S)
        kv_sink = 2 if pos >= S else 0
        sl = (0, kv_sink + (pos - kv_sink) % (S - kv_sink), min(pos + 1, S), kv_sink, pos)
        k4, v4 = k_all.clone(), v_all.clone()
        got = block_fn(wt)(x, nw, wqkv, wo, k_all, v_all, *sl, **kw)
        assert torch.equal(got, four_launches(x, nw, wqkv, wo, k4, v4, *sl, **kw))
        torch.cuda.synchronize()
        for _, ctr in G._SPLIT_BUFFERS.values():
            assert int(ctr.abs().sum()) == 0


@pytest.mark.parametrize("wt", [torch.float8_e5m2, torch.uint8], ids=["e5m2", "int4"])
def test_attn_block_graph_replay_equals_eager(dev, wt):
    """The cooperative launch captured in a CUDA graph and replayed after x
    is rewritten in place: bit for bit the uncaptured call on the new x,
    the written cache row included."""
    x, nw, wqkv, wo, k_all, v_all, kw = block_case(dev, wt, torch.float8_e5m2, 5)
    sl = (1, 150, 151, 0, 150)
    fn = block_fn(wt)
    fn(x, nw, wqkv, wo, k_all, v_all, *sl, **kw)   # buffers sized before the capture
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn(x, nw, wqkv, wo, k_all, v_all, *sl, **kw)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x, nw, wqkv, wo, k_all, v_all, *sl, **kw)
    x.copy_(torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(9),
                        device=dev))
    graph.replay()
    torch.cuda.synchronize()
    replayed, k_rep, v_rep = out.clone(), k_all.clone(), v_all.clone()
    eager = fn(x, nw, wqkv, wo, k_all, v_all, *sl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    assert torch.equal(_bits(k_rep), _bits(k_all)) and torch.equal(_bits(v_rep), _bits(v_all))


def test_attn_block_bad_scalars_raise_and_write_nothing(dev):
    """A layer or a position the kernel cannot take is refused on the host
    before any launch: ValueError, the cache untouched."""
    x, nw, wqkv, wo, k_all, v_all, kw = block_case(dev, torch.float8_e5m2, torch.bfloat16, 3)
    k0, v0 = k_all.clone(), v_all.clone()
    for sl in ((2, 5, 6, 0, 5), (-1, 5, 6, 0, 5), (0, 300, 300, 2, 400), (0, 5, 0, 0, 5),
               (0, 5, 301, 0, 5), (0, 5, 6, 3, 5)):
        with pytest.raises(ValueError):
            attn_block_l(x, nw, wqkv, wo, k_all, v_all, *sl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k_all, k0) and torch.equal(v_all, v0)
