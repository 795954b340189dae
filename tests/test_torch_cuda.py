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
dense kernels on the copied expert).

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
from yalm_tpu_torch.ops.cuda.attention import (attend_step_batched, attend_step_batched_l,
                                               attend_step_batched_plain, attend_step_l,
                                               attend_step_paged, attend_step_paged_l,
                                               attend_step_paged_plain, attend_step_plain,
                                               lane_scalars)
from yalm_tpu_torch.ops.cuda.block import attn_block4_l, attn_block_l, attn_block_plain
from yalm_tpu_torch.ops.cuda.ffn import ffn, ffn4_l, ffn_l, ffn_plain
from yalm_tpu_torch.ops.cuda.gemv import (bf16f, gemm4, gemm4_l, gemm4_l_plain, gemm4_le,
                                          gemm_l, gemm_l_plain, gemm_le, gemm_le_plain, gemv4,
                                          gemv4_l, gemv4_le, gemv_l_plain, gemv_le,
                                          gemv_le_plain, launch_gemm, launch_gemv, proj_plain)
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


@pytest.mark.parametrize("wt", WTYPES)
@pytest.mark.parametrize("nb,N,K,epi", [(1, 100, 64, "norm+res"), (3, 37, 160, "scale+bias+clip"),
                                        (5, 200, 96, "glu"), (8, 64, 2048, "norm+glu")])
def test_gemv_kernel(dev, wt, nb, N, K, epi):
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
    want = torch.stack([gemv_l_plain(x[i], w, 2, norm_w=nw, scale=sc) for i in range(nb)])
    if b is not None:
        want = torch.clamp(want + b[2], -clip, clip)
    if glu:
        want = bf16f(silu(want[:, :n_out]) * want[:, n_out:])
    if res is not None:
        want = want + res
    close(got, want)


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
                                         # scores past shared memory, in global scratch
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
                                        (2, 300, 768, "norm+res")])
def test_gemv4_kernel(dev, nb, N, K, epi):
    """csrc/gemv.cu on packed int4: G = 1 (K 256, 512), 3 (K 768, group
    256) and 28 (K 14336, group 512)."""
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
    the cache is untouched, and the mix agrees (scores in shared memory,
    and past it in global scratch)."""
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
    prologue on the GEMV); NaN for an id outside the stack."""
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
    for bad in (E, -1):
        e_bad = torch.tensor(bad, device=dev)
        assert bool(torch.isnan(le(x, wn, 1, e_bad, sn)).all())
        assert bool(torch.isnan(le(x, w, 0, e_bad, sc, glu_act="silu")).all())
        if M == 1:
            gv = gemv4_le if int4 else gemv_le
            assert bool(torch.isnan(gv(x[0], wn, 1, e_bad, sn)).all())
    with pytest.raises(ValueError, match="out of range"):
        le(x, wn, 0, E, sn)                      # a host id is checked on the host
