"""The port's CUDA kernels against their plain versions ON THE CARD, at
small and ragged shapes the Mistral-7B main path never gives them (odd row
counts, N not a multiple of the tile, head_dim 64, qpk 1 and 3, windows
that are not a multiple of the attention tile, a window whose scores
overflow shared memory).

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
from yalm_tpu_torch.ops.cuda.attention import attend_step_l, attend_step_plain
from yalm_tpu_torch.ops.cuda.block import attn_block_l, attn_block_plain
from yalm_tpu_torch.ops.cuda.ffn import ffn_l, ffn_plain
from yalm_tpu_torch.ops.cuda.gemv import bf16f, gemm_l, gemm_l_plain, gemv_l_plain, launch_gemv
from yalm_tpu_torch.ops.core import silu

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


def weights(shape, wt, dev, gen):
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
