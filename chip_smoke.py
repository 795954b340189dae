#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (yalm_tpu_torch) on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py`. It builds the
kernels from `yalm_tpu_torch/csrc/` with nvcc, then:

1. preflight: card name and power limit, build time, and the card's
   streaming ceiling from a 2 GiB device-to-device copy;
2. each kernel against its plain PyTorch version on the card, at
   Mistral-7B shapes with fp8-e5m2 weights (bf16 and int8+scale as well on
   gemv_l), with its time, its plain version's time, its bound and, where
   one PyTorch call computes the same function, that call's time; the
   paged attention also bit for bit against the batched one on the cache
   gathered from its pool;
3. the slice end to end at full width (Mistral-7B shapes, random fp8
   weights made on the card from a seed, bf16 cache): three requests
   through Engine.generate at depth 32 -- 200 tokens + 64 greedy, 1500 + 64
   sampled (T 0.8, top-p 0.9), 4090 + 16 across the 4096 window, then an
   8-token follow-up hydrated token by token in the ring regime -- with
   every kernel's launch count over that run;
   then continuous-batching serving through ServingEngine at depth 8 (PERF.md
   keeps the 32-layer runs; the Mixtral phases need the time) (batch 16,
   the server's defaults: batched admission, the dense prefix cache, top-5
   logprobs): 24 requests of 64-2048 prompt tokens, greedy and sampled,
   two sharing a 512-token prefix, one past the window, plus four over
   HTTP on 127.0.0.1, with the batched kernels' launch counts, TTFT and
   aggregate decode rate, and a torch.profiler window of 16 ticks with 16
   busy lanes; then the same mix through a paged pool of 65 pages of 256
   slots, which must preempt and resume at least one lane with every
   stream exactly max_new_tokens long, the paged attention launched once
   per layer per tick and the dense one never;
4. the same model at depth 2 on the card against the plain versions on the
   CPU: a 64-token prefill and 8 teacher-forced decode steps; then the
   batched path: one batched chunk sweep and 8 teacher-forced ticks over 16
   lanes at mixed positions (ring lanes, write-masked lanes), the argmax
   held on every lane whose top two logits lie more than twice the
   tolerance apart; and the same over a paged pool through shuffled tables;
then phases 2-4 again for the int4 path (packed int4 layer weights with
group scales, int8 embedding and LM head, fp8-e5m2 KV cache: the
configuration of `bench.py`'s defaults), after the fp8 weights are freed,
with a lighter serving run (20 requests, no HTTP);
then phases 2-4 for Mixtral-8x7B shapes at depth 32 (8 experts, 2 active),
fp8 (bf16 cache) and then int4 (int8 router, e5m2 cache): the routed-expert
kernels (K10 gemv_le/gemm_le, K11 gemv4_le/gemm4_le) against their plain
versions and bit for bit against the dense kernels on the copied expert
stack; single stream (200+64 greedy, 1500+32 sampled; on fp8 also 4090+16
and the ring follow-up) with the routed GEMV launched 128 times per decode
token and the routed GEMM 512 times per prefill chunk, and one decode step
free of host synchronization (the routed ids stay on the card); serving, fp8 on the
dense cache (17 requests of 64-1024 tokens and 2 over HTTP) and int4 on a
paged pool of 65 pages of 256 (17 requests of 256-1536 tokens, which must
preempt), the routed GEMM 512 times per tick; depth-2 parity as above with
a 32-token prefill, the batched one over 8 lanes of 8-row chunks (the CPU's
plain experts set the pace); a row may route differently on the card only
where the CPU's router logits near-tie, and the outputs such a row or a
near-tie reaches are held to nothing and counted;
5. the CLI's completion, perplexity and passkey modes on a small fp8
   checkpoint and on a small int4 checkpoint with `-C fp8`, and a
   completion on a small fp8 MoE checkpoint, as subprocesses.

Any failure raises, so the script exits non-zero before its last line,
which is {"ok": true, "device": {...}}. Without a CUDA GPU, or outside the
repository, it exits non-zero at once. It takes no arguments: every run
drives every phase of every path.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor cores, published
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Log a phase's name, then its seconds."""
    t0 = time.perf_counter()
    log(name)
    yield
    log(f"  ({time.perf_counter() - t0:.1f} s)")


def mistral7b(n_layers: int = 32, weight_dtype: str = "fp8"):
    from yalm_tpu_torch.config import ModelConfig
    return ModelConfig(dim=4096, hidden_dim=14336, head_dim=128, n_layers=n_layers,
                       n_heads=32, n_kv_heads=8, vocab_size=32000, max_seq_len=4096,
                       bos_token_id=1, eos_token_id=2, rope_theta=1e6,
                       rotary_dim=128, norm_eps=1e-5, act_type="silu",
                       weight_dtype=weight_dtype)


def mixtral8x7b(n_layers: int = 32, weight_dtype: str = "fp8"):
    """Mixtral-8x7B-v0.1's shapes (bench.py:145-159's per-layer configuration
    at the public model's 32 layers): Mistral-7B's attention and widths, 8
    experts of which 2 run per token."""
    return dataclasses.replace(mistral7b(n_layers, weight_dtype), n_experts=8,
                               n_experts_active=2)


def synth_moe_weights(cfg, device, seed: int):
    """Random weights of an MoE cfg on the card: synth_fast_weights (fp8) or
    synth_int4_weights (int4, an int8 router with per-row scales)."""
    return (synth_int4_weights if cfg.weight_dtype == "int4" else synth_fast_weights)(
        cfg, device, seed)


def synth_fast_weights(cfg, device, seed: int):
    """Random fp8-e5m2 weights (std 0.02) made on the card in the decode
    layout, chunk by chunk so no full-size bf16 temporary exists; an MoE cfg
    gets its expert stacks (L, E, ...) and the router (L, E, dim)."""
    import torch
    from yalm_tpu_torch.models.fast import FastWeights
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fp8 = torch.float8_e5m2

    def mk(*shape, scale=0.02):
        out = torch.empty(shape, dtype=fp8, device=device)
        flat = out.view(-1, shape[-1])
        step = max(1, (64 << 20) // shape[-1])
        for i in range(0, flat.shape[0], step):
            rows = flat[i:i + step]
            rows.copy_((torch.randn(rows.shape, generator=gen, device=device,
                                    dtype=torch.bfloat16) * scale).to(fp8))
        return out

    L, d, h = cfg.n_layers, cfg.dim, cfg.hidden_dim
    E = (cfg.n_experts,) if cfg.is_moe else ()
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)  # noqa: E731
    return FastWeights(
        embed=mk(cfg.vocab_size, d), rms_att=ones(L, d), rms_ffn=ones(L, d),
        wqkv=mk(L, cfg.q_dim + 2 * cfg.kv_dim, d), wo=mk(L, d, cfg.q_dim),
        w13=mk(L, *E, 2 * h, d), w2=mk(L, *E, d, h), final_norm=ones(d),
        lm_head=mk(cfg.vocab_size, d), moegate=mk(L, *E, d) if E else None)


def synth_int4_weights(cfg, device, seed: int):
    """Random packed int4 weights made on the card in the decode layout:
    both nibbles of each byte uniform over 1..15, i.e. q - 8 over -7..7
    with mean 0 (uniform bytes, as bench.py:216-220 makes them, give every
    weight a mean of -0.5 * scale, and the shared component drives a
    32-layer stack to one repeated token), with group scales around
    0.02 / 4.32 (4.32 = the std of q - 8), so the dequantized weights have
    a std of about 0.02; the embedding and LM head are random int8 with
    per-row scales around 0.02 / 73.6, as is an MoE cfg's router (L, E,
    dim); MoE experts are stacks (L, E, ...) with scales (L, E, G, N)."""
    import torch
    from yalm_tpu_torch.models.fast import FastScales, FastWeights
    from yalm_tpu_torch.ops.int4 import int4_group
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def nibbles(*shape):
        out = torch.empty(shape, dtype=torch.uint8, device=device)
        flat = out.view(-1, shape[-1])
        step = max(1, (256 << 20) // shape[-1])
        for i in range(0, flat.shape[0], step):
            lo, hi = (torch.randint(1, 16, flat[i:i + step].shape, generator=gen,
                                    device=device, dtype=torch.uint8) for _ in range(2))
            flat[i:i + step] = lo | (hi << 4)
        return out

    def scales(*shape, base):
        return (torch.rand(shape, generator=gen, device=device) + 0.5) * base

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)

    L, d, h, q = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.q_dim
    nqkv = q + 2 * cfg.kv_dim
    E = (cfg.n_experts,) if cfg.is_moe else ()
    G = lambda k: k // int4_group(k)  # noqa: E731
    s4 = 0.02 / 4.32
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)  # noqa: E731
    return FastWeights(
        embed=int8(cfg.vocab_size, d), rms_att=ones(L, d), rms_ffn=ones(L, d),
        wqkv=nibbles(L, nqkv, d // 2), wo=nibbles(L, d, q // 2),
        w13=nibbles(L, *E, 2 * h, d // 2), w2=nibbles(L, *E, d, h // 2), final_norm=ones(d),
        lm_head=int8(cfg.vocab_size, d),
        scales=FastScales(embed=scales(cfg.vocab_size, base=0.02 / 73.6),
                          wqkv=scales(L, G(d), nqkv, base=s4), wo=scales(L, G(q), d, base=s4),
                          w13=scales(L, *E, G(d), 2 * h, base=s4),
                          w2=scales(L, *E, G(h), d, base=s4),
                          lm_head=scales(cfg.vocab_size, base=0.02 / 73.6),
                          moegate=scales(L, *E, base=0.02 / 73.6) if E else None),
        moegate=int8(L, *E, d) if E else None)


def dequant4(w4, gs):
    """bf16 copies of packed int4 layers (L, N, K/2) with scales (L, G, N):
    the weights the library call (F.linear) is timed on."""
    import torch
    L, N, Kp = w4.shape
    G = gs.shape[1]
    p = w4.reshape(L, N, G, -1)
    q = torch.cat([(p & 0xF).to(torch.bfloat16) - 8, (p >> 4).to(torch.bfloat16) - 8], -1)
    return (q.float() * gs.transpose(1, 2)[..., None]).reshape(L, N, 2 * Kp).to(torch.bfloat16)


class Bench:
    """Kernel-vs-plain checks and timings; collects one row per case.

    Tolerance of every case: 2e-3 of the largest reference magnitude (at
    least 1). Kernel and plain version round the same operands to bf16 and
    sum in f32, so they differ by the summation order, plus a rare one-ulp
    bf16 flip (of a normalised input, a GLU output or a softmax weight)
    where the two f32 values straddle a rounding boundary. No case adds the
    model's residual stream (x ~ 3 here) to what it compares: the
    attn_block and ffn cases run with add_residual=False (attn_block_l's
    Wo @ attention is ~0.1 typical, ~0.5 at most, so its tolerance is the
    floor, 2e-3), and the wo GEMV cases test the residual epilogue with a
    unit-scale vector."""

    def __init__(self, ceiling: float):
        self.ceiling = ceiling
        self.rows: list[dict] = []
        self.footprint: list[dict] = []   # routed GEMV vs the dense one on a copied expert
        self.path = "fp8"   # the path whose kernels the next cases hold

    @staticmethod
    def time_ms(fn, reps: int = 25) -> float:
        """Median device time of fn(rep) over `reps` calls. A sleep kernel
        keeps the card busy while the host enqueues them, so host overhead
        between launches does not count."""
        import torch
        for r in range(3):
            fn(r)
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
        torch.cuda._sleep(100_000_000)
        for r, (s, e) in enumerate(ev):
            s.record()
            fn(r)
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)

    def case(self, name, label, got, want, tol_rel, *, kernel, plain,
             library=None, bytes_=0, flops=0, json_row=False, run="serve", bf16_out=False):
        """One case; `run` names the main-path run whose launch counts the
        kernels line reports for it ("serve": phase 3's Engine requests,
        "batched": the serving run). bf16_out: the outputs are bf16 values
        (the GLU epilogue's), and an element may also differ by one bf16 ulp
        of the reference, where the two f32 values straddle a rounding
        boundary (at M 256 x 14336 outputs some always do, and one ulp of
        the largest is 2^-8..2^-7 of it, above 2e-3)."""
        import torch
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        tol = tol_rel * max(1.0, float(want.float().abs().max()))
        finite = bool(torch.isfinite(got).all())
        flips = 0
        if bf16_out:
            w = want.float()
            ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs()).exponent - 8)
            flips = int((diff > tol).sum())
            if not (torch.equal(got, got.to(torch.bfloat16).float())
                    and bool((diff <= torch.maximum(ulp, torch.full_like(ulp, tol))).all())):
                raise AssertionError(f"{name} {label}: a bf16 output differs from the plain "
                                     f"version's by more than one bf16 ulp and the tolerance")
            err_ok = True
        else:
            err_ok = err <= tol
        row = dict(name=name, path=self.path, case=label, max_abs_err=err, tol=tol,
                   bf16_ulp_flips=flips,
                   ms=self.time_ms(kernel), plain_ms=self.time_ms(plain),
                   library_ms=self.time_ms(library) if library else None,
                   bytes=bytes_, flops=flops, json=json_row, run=run)
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        row["ceiling_ms"] = bytes_ / self.ceiling * 1e3
        self.rows.append(row)
        lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        log(f"  {name:14s} {label:34s} err {err:.3e} tol {tol:.3e}"
            + (f" ({flips} one-ulp bf16 flips past it)" if flips else "")
            + f"  ms {row['ms']:.4f} plain {row['plain_ms']:.4f} lib {lib} "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
        if not (finite and err_ok):
            raise AssertionError(f"{name} {label}: kernel disagrees with its plain "
                                 f"version (max |err| {err:.3e} > tol {tol:.3e}, finite={finite})")


def phase_kernels(bench: Bench, cfg, fw, dev) -> None:
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.cuda import attention as A
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.cuda.block import attn_block_l, attn_block_plain
    from yalm_tpu_torch.ops.cuda.ffn import ffn_l, ffn_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=dev) * scale

    L, d, h, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size
    Nqkv, q_dim = cfg.q_dim + 2 * cfg.kv_dim, cfg.q_dim
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lay = lambda r: r % L  # noqa: E731  (cycle layers: each call streams cold weights)
    # the library calls cycle 4 layers of pre-dequantized copies (> the 50 MB L2)

    # the kernels' e5m2 -> bf16 widening is exact: all 256 codes through the
    # GEMV kernel (row n = [code n, 0, ...], x = e_0) against torch's cast
    codes = torch.zeros(1, 256, 16, dtype=torch.uint8, device=dev)
    codes[0, :, 0] = torch.arange(256, device=dev, dtype=torch.uint8)
    e0 = torch.zeros(16, device=dev)
    e0[0] = 1.0
    got = G.gemv_l(e0, codes.view(torch.float8_e5m2), 0)
    want = codes[0, :, 0].view(torch.float8_e5m2).to(torch.bfloat16).float()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not bool(same.all()):
        raise AssertionError("the kernel's e5m2 -> bf16 widening is not exact")
    log("  e5m2 -> bf16 widening in the GEMV kernel: bit-exact for all 256 codes")

    # K1: gemv (LM head)
    x = randn(d)
    lm_bf16 = fw.lm_head.to(torch.bfloat16)
    bench.case("gemv", "lm_head e5m2 (32000x4096)", G.gemv(x, fw.lm_head),
               G.gemv_l_plain(x, fw.lm_head[None], 0), 2e-3,
               kernel=lambda r: G.gemv(x, fw.lm_head),
               plain=lambda r: G.gemv_l_plain(x, fw.lm_head[None], 0),
               library=lambda r: F.linear(x.to(torch.bfloat16), lm_bf16),
               bytes_=V * d + 4 * d + 4 * V, flops=2 * V * d, json_row=True)
    del lm_bf16

    # K1: gemv_l with the norm prologue, and with the residual epilogue
    x = randn(d, scale=3.0)
    wqkv_bf16 = fw.wqkv[:4].to(torch.bfloat16)
    bench.case("gemv_l", "wqkv e5m2 + rmsnorm (6144x4096)",
               G.gemv_l(x, fw.wqkv, 0, norm_w=fw.rms_att),
               G.gemv_l_plain(x, fw.wqkv, 0, norm_w=fw.rms_att), 2e-3,
               kernel=lambda r: G.gemv_l(x, fw.wqkv, lay(r), norm_w=fw.rms_att),
               plain=lambda r: G.gemv_l_plain(x, fw.wqkv, lay(r), norm_w=fw.rms_att),
               library=lambda r: F.linear(x.to(torch.bfloat16), wqkv_bf16[r % 4]),
               bytes_=Nqkv * d + 8 * d + 4 * Nqkv, flops=2 * Nqkv * d, json_row=True)
    del wqkv_bf16
    xm, res = randn(q_dim), randn(d)
    bench.case("gemv_l", "wo e5m2 + residual (4096x4096)",
               G.gemv_l(xm, fw.wo, 1, residual=res),
               G.gemv_l_plain(xm, fw.wo, 1, residual=res), 2e-3,
               kernel=lambda r: G.gemv_l(xm, fw.wo, lay(r), residual=res),
               plain=lambda r: G.gemv_l_plain(xm, fw.wo, lay(r), residual=res),
               bytes_=d * q_dim + 4 * q_dim + 8 * d, flops=2 * d * q_dim)
    w_bf16 = randn(2, Nqkv, d, scale=0.02).to(torch.bfloat16)
    bench.case("gemv_l", "wqkv bf16 + rmsnorm (6144x4096)",
               G.gemv_l(x, w_bf16, 1, norm_w=fw.rms_att[:2].contiguous()),
               G.gemv_l_plain(x, w_bf16, 1, norm_w=fw.rms_att[:2]), 2e-3,
               kernel=lambda r: G.gemv_l(x, w_bf16, r % 2, norm_w=fw.rms_att[:2].contiguous()),
               plain=lambda r: G.gemv_l_plain(x, w_bf16, r % 2, norm_w=fw.rms_att[:2]),
               bytes_=2 * Nqkv * d + 8 * d + 4 * Nqkv, flops=2 * Nqkv * d)
    del w_bf16
    w_i8 = torch.randint(-127, 128, (2, Nqkv, d), generator=gen, device=dev,
                         dtype=torch.int8)
    s_i8 = torch.rand(2, Nqkv, generator=gen, device=dev) * 1e-3 + 1e-4
    bench.case("gemv_l", "wqkv int8 + scale (6144x4096)",
               G.gemv_l(x, w_i8, 1, scale=s_i8), G.gemv_l_plain(x, w_i8, 1, scale=s_i8),
               2e-3,
               kernel=lambda r: G.gemv_l(x, w_i8, r % 2, scale=s_i8),
               plain=lambda r: G.gemv_l_plain(x, w_i8, r % 2, scale=s_i8),
               bytes_=Nqkv * d + 4 * d + 8 * Nqkv, flops=2 * Nqkv * d)
    del w_i8, s_i8

    # K1: gemm_l, the prefill chunks
    for B, nm, w, N, K in ((16, "wqkv", fw.wqkv, Nqkv, d), (16, "w13", fw.w13, 2 * h, d),
                           (64, "wqkv", fw.wqkv, Nqkv, d),
                           (256, "wqkv", fw.wqkv, Nqkv, d), (256, "wo", fw.wo, d, q_dim),
                           (256, "w2", fw.w2, d, h), (256, "w13", fw.w13, 2 * h, d)):
        xb = randn(B, K)
        wl = w[:4].to(torch.bfloat16)
        bench.case("gemm_l", f"B={B} {nm} e5m2 ({N}x{K})", G.gemm_l(xb, w, 0),
                   G.gemm_l_plain(xb, w, 0), 2e-3,
                   kernel=lambda r, xb=xb, w=w: G.gemm_l(xb, w, lay(r)),
                   plain=lambda r, xb=xb, w=w: G.gemm_l_plain(xb, w, lay(r)),
                   library=lambda r, xb=xb, wl=wl: F.linear(xb.to(torch.bfloat16), wl[r % 4]),
                   bytes_=N * K + 4 * B * (K + N), flops=2 * B * N * K,
                   json_row=nm == "w13" and B in (16, 256), run="batched" if B == 16 else "serve")
        del wl

    # K2: attend_step_l against a random full-size bf16 cache
    cache = KVCache.init(cfg, torch.bfloat16, dev)
    cache.k.copy_(torch.randn(cache.k.shape, generator=gen, device=dev, dtype=torch.bfloat16))
    cache.v.copy_(torch.randn(cache.v.shape, generator=gen, device=dev, dtype=torch.bfloat16))
    rope = dict(kv_sinks=2, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    S = cfg.max_seq_len
    for pos in (0, 999, 4095, 6000):
        kv_sink = 2 if pos >= S else 0
        kv_pos = kv_sink + (pos - kv_sink) % (S - kv_sink)
        kv_len = min(pos + 1, S)
        q, kn, vn = randn(Hk, Hq // Hk, D, scale=2.0), randn(Hk, D, scale=2.0), randn(Hk, D)
        sl = (3, kv_len, kv_sink, pos)
        want = A.attend_step_plain(q, kn, vn, cache.k, cache.v, 3, kv_pos, *sl[1:], **rope)
        row_plain = cache.k[3, kv_pos].clone()
        got = A.attend_step_l(q, kn, vn, cache.k, cache.v, 3, kv_pos, *sl[1:], **rope)
        row_err = float((cache.k[3, kv_pos].float() - row_plain.float()).abs().max())
        if row_err > 2 ** -7 * float(row_plain.float().abs().max()):
            raise AssertionError(f"attend_step_l pos {pos}: written k row differs by {row_err}")
        kk = cache.k[:4, :kv_len].transpose(1, 2).contiguous()   # (4, Hk, kv_len, D)
        vv = cache.v[:4, :kv_len].transpose(1, 2).contiguous()
        qq = q.reshape(1, Hq, 1, D).to(torch.bfloat16)
        att_bytes = 2 * kv_len * Hk * D * 2 + 4 * (2 * Hq * D + 2 * Hk * D)
        bench.case("attend_step_l",
                   f"kv_len={kv_len} pos={pos}" + (" ring+sinks" if kv_sink else ""),
                   got, want, 2e-3,
                   kernel=lambda r, a=(q, kn, vn), kp=kv_pos, s=sl[1:]: A.attend_step_l(
                       *a, cache.k, cache.v, lay(r), kp, *s, **rope),
                   plain=lambda r, a=(q, kn, vn), kp=kv_pos, s=sl[1:]: A.attend_step_plain(
                       *a, cache.k, cache.v, lay(r), kp, *s, **rope),
                   library=lambda r, qq=qq, kk=kk, vv=vv: F.scaled_dot_product_attention(
                       qq, kk[r % 4][None], vv[r % 4][None], enable_gqa=True),
                   bytes_=att_bytes, flops=4 * kv_len * Hq * D,
                   json_row=(pos == 6000))
        del kk, vv

    # K2 past shared memory: a 32768-slot window (Mistral-7B v0.2's) keeps
    # its scores in global scratch
    big = KVCache.init(dataclasses.replace(cfg, n_layers=1, max_seq_len=32768),
                       torch.bfloat16, dev)
    big.k.copy_(torch.randn(big.k.shape, generator=gen, device=dev, dtype=torch.bfloat16))
    big.v.copy_(torch.randn(big.v.shape, generator=gen, device=dev, dtype=torch.bfloat16))
    pos, Sb = 40000, 32768
    kv_pos = 2 + (pos - 2) % (Sb - 2)
    q, kn, vn = randn(Hk, Hq // Hk, D, scale=2.0), randn(Hk, D, scale=2.0), randn(Hk, D)
    sl = (kv_pos, Sb, 2, pos)
    want = A.attend_step_plain(q, kn, vn, big.k, big.v, 0, *sl, **rope)
    got = A.attend_step_l(q, kn, vn, big.k, big.v, 0, *sl, **rope)
    bench.case("attend_step_l", f"kv_len={Sb} pos={pos} scores in global", got, want, 2e-3,
               kernel=lambda r: A.attend_step_l(q, kn, vn, big.k, big.v, 0, *sl, **rope),
               plain=lambda r: A.attend_step_plain(q, kn, vn, big.k, big.v, 0, *sl, **rope),
               bytes_=2 * Sb * Hk * D * 2 + 4 * (2 * Hq * D + 2 * Hk * D),
               flops=4 * Sb * Hq * D)
    del big

    # K3: attn_block_l, mid-window; without the residual, so the check
    # holds what the three launches compute
    x = randn(d, scale=3.0)
    pos = 999
    blk = dict(n_heads=Hq, norm_eps=cfg.norm_eps, add_residual=False, **rope)
    args = lambda l: (x, fw.rms_att, fw.wqkv, fw.wo, cache.k, cache.v, l,  # noqa: E731
                      pos, pos + 1, 0, pos)
    want = attn_block_plain(*args(5), **blk)
    got = attn_block_l(*args(5), **blk)
    bench.case("attn_block_l", "kv_len=1000 e5m2", got, want, 2e-3,
               kernel=lambda r: attn_block_l(*args(lay(r)), **blk),
               plain=lambda r: attn_block_plain(*args(lay(r)), **blk),
               bytes_=Nqkv * d + d * q_dim + 2 * (pos + 1) * Hk * D * 2 + 12 * d,
               flops=2 * (Nqkv * d + d * q_dim) + 4 * (pos + 1) * Hq * D, json_row=True)
    del cache

    # K4: ffn_l, one row (decode) and four rows, without the residual
    for B in (1, 4):
        xf = randn(d, scale=3.0) if B == 1 else randn(B, d, scale=3.0)
        kw = dict(norm_eps=cfg.norm_eps, act="silu", add_residual=False)
        bench.case("ffn_l", f"B={B} e5m2", ffn_l(xf, fw.rms_ffn, fw.w13, fw.w2, 2, **kw),
                   ffn_plain(xf, fw.rms_ffn, fw.w13, fw.w2, 2, **kw), 2e-3,
                   kernel=lambda r, xf=xf: ffn_l(xf, fw.rms_ffn, fw.w13, fw.w2, lay(r), **kw),
                   plain=lambda r, xf=xf: ffn_plain(xf, fw.rms_ffn, fw.w13, fw.w2, lay(r), **kw),
                   bytes_=3 * h * d + 8 * B * d + 4 * d, flops=B * 6 * h * d,
                   json_row=(B == 1))
    phase_ffn_rows(bench, cfg, fw, dev, (16, 64))
    phase_batched_attention(bench, cfg, dev, torch.bfloat16)
    phase_paged_attention(bench, cfg, dev, torch.bfloat16)


def phase_kernels4(bench: Bench, cfg, fw, dev) -> None:
    """Phase 2 of the int4 path: the int4 kernels and the e5m2 cache
    against their plain versions at main-path shapes."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.core import silu
    from yalm_tpu_torch.ops.cuda import attention as A
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.cuda.block import attn_block4_l, attn_block_plain
    from yalm_tpu_torch.ops.cuda.ffn import ffn4_l, ffn_plain

    bench.path = "int4"
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=dev) * scale

    L, d, h, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size
    Nqkv, q_dim = cfg.q_dim + 2 * cfg.kv_dim, cfg.q_dim
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sc = fw.scales
    lay = lambda r: r % L  # noqa: E731

    def w4_bytes(N, K):   # packed weights and their group scales
        return N * K // 2 + 4 * (K // (512 if K % 512 == 0 else 256)) * N

    # K1: the int8 LM head of this path
    x = randn(d)
    lm_bf16 = (fw.lm_head.float() * sc.lm_head[:, None]).to(torch.bfloat16)
    bench.case("gemv", "lm_head int8 + scale (32000x4096)", G.gemv(x, fw.lm_head, sc.lm_head),
               G.gemv_l_plain(x, fw.lm_head[None], 0, scale=sc.lm_head[None]), 2e-3,
               kernel=lambda r: G.gemv(x, fw.lm_head, sc.lm_head),
               plain=lambda r: G.gemv_l_plain(x, fw.lm_head[None], 0, scale=sc.lm_head[None]),
               library=lambda r: F.linear(x.to(torch.bfloat16), lm_bf16),
               bytes_=V * d + 4 * d + 8 * V, flops=2 * V * d, json_row=True)
    del lm_bf16

    # K5: the int4 GEMV as the decode path launches it (csrc/gemv.cu)
    x, xm, xh, res = randn(d, scale=3.0), randn(q_dim), randn(h), randn(d)
    for nm, w, s, N, K, kw, lib_x in (
            ("wqkv + rmsnorm", fw.wqkv, sc.wqkv, Nqkv, d, dict(norm_w=fw.rms_att), x),
            ("wo + residual", fw.wo, sc.wo, d, q_dim, dict(residual=res), xm),
            ("w13 + rmsnorm + GLU", fw.w13, sc.w13, 2 * h, d, dict(norm_w=fw.rms_att), x),
            ("w2", fw.w2, sc.w2, d, h, {}, xh)):
        glu = "GLU" in nm
        wl = dequant4(w[:4], s[:4])

        def kern(r, w=w, s=s, kw=kw, xx=lib_x, glu=glu):
            if not (kw or glu):   # no prologue or epilogue: the public wrapper
                return G.gemv4_l(xx, w, lay(r), s)
            return G.launch_gemv("gemv4_l", xx, w, lay(r), scale=s,
                                 glu_act="silu" if glu else None, **kw)

        def plain(r, w=w, s=s, kw=kw, xx=lib_x, glu=glu, N=N):
            y = G.gemv_l_plain(xx, w, lay(r), scale=s, **kw)
            return G.bf16f(silu(y[:N // 2]) * y[N // 2:]) if glu else y
        got = kern(0)
        # the GLU output goes to w2 rounded to bf16 (ffn.py:188): every value
        # the kernel writes must be a bf16 value, whatever the tolerance
        if glu and not torch.equal(got, G.bf16f(got)):
            raise AssertionError("gemv4_l GLU: the kernel's output is not rounded to bf16")
        bench.case("gemv4_l", f"{nm} ({N}x{K})", got, plain(0), 2e-3, kernel=kern,
                   plain=plain,
                   library=lambda r, xx=lib_x, wl=wl: F.linear(xx.to(torch.bfloat16), wl[r % 4]),
                   bytes_=w4_bytes(N, K) + 4 * (K + N) + (4 * K if "norm" in nm else 0)
                   + (4 * N if "residual" in nm else 0) - (2 * N if glu else 0),
                   flops=2 * N * K, json_row=nm == "wqkv + rmsnorm")
        del wl

    # K5: gemm4_l, the prefill chunks (csrc/gemm.cu)
    for nm, w, s, N, K in (("wqkv", fw.wqkv, sc.wqkv, Nqkv, d), ("w13", fw.w13, sc.w13, 2 * h, d),
                           ("w2", fw.w2, sc.w2, d, h)):
        wl = dequant4(w[:4], s[:4])
        for B in (16, 64, 256):
            xb = randn(B, K)
            bench.case("gemm4_l", f"B={B} {nm} ({N}x{K})", G.gemm4_l(xb, w, 0, s),
                       G.gemm4_l_plain(xb, w, 0, s), 2e-3,
                       kernel=lambda r, xb=xb, w=w, s=s: G.gemm4_l(xb, w, lay(r), s),
                       plain=lambda r, xb=xb, w=w, s=s: G.gemm4_l_plain(xb, w, lay(r), s),
                       library=lambda r, xb=xb, wl=wl: F.linear(xb.to(torch.bfloat16), wl[r % 4]),
                       bytes_=w4_bytes(N, K) + 4 * B * (K + N), flops=2 * B * N * K,
                       json_row=(B == 256 and nm == "w13"))
        del wl

    # K2 with the e5m2 cache: the f32 -> e5m2 row write rounds once, as
    # torch's cast does, at edge values (ties, 57344, 61440 -> inf,
    # subnormals) and random ones: the v row holds v_new as written
    e5 = torch.float8_e5m2
    rope = dict(kv_sinks=2, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    small = KVCache.init(dataclasses.replace(cfg, n_layers=1, max_seq_len=64), e5, dev)
    vn = randn(Hk, D, scale=4.0)
    edges = torch.tensor([0.0, -0.0, 1.125, 1.375, -1.625, 57344.0, 61439.0, 61440.0,
                          -61440.0, 1e6, 2.0 ** -16, 2.0 ** -17, 3 * 2.0 ** -18, 1.5e-5],
                         device=dev)
    vn.view(-1)[:len(edges)] = edges
    A.attend_step_l(randn(Hk, Hq // Hk, D), randn(Hk, D), vn, small.k, small.v, 0, 5, 6, 0, 5,
                    **rope)
    if not torch.equal(small.v[0, 5].view(torch.uint8), vn.to(e5).view(torch.uint8)):
        raise AssertionError("the attention kernel's f32 -> e5m2 row write differs from torch's")
    log(f"  f32 -> e5m2 row write in the attention kernel: bit-exact for {Hk * D} values "
        f"({len(edges)} edge values among them)")
    del small

    cache = KVCache.init(cfg, e5, dev)
    cache.k.copy_(torch.randn(cache.k.shape, generator=gen, device=dev).to(e5))
    cache.v.copy_(torch.randn(cache.v.shape, generator=gen, device=dev).to(e5))
    S = cfg.max_seq_len
    for pos in (999, 6000):
        kv_sink = 2 if pos >= S else 0
        kv_pos = kv_sink + (pos - kv_sink) % (S - kv_sink)
        kv_len = min(pos + 1, S)
        q, kn, vn = randn(Hk, Hq // Hk, D, scale=2.0), randn(Hk, D, scale=2.0), randn(Hk, D)
        sl = (kv_len, kv_sink, pos)
        want = A.attend_step_plain(q, kn, vn, cache.k, cache.v, 3, kv_pos, *sl, **rope)
        rows = cache.k[3, kv_pos].clone(), cache.v[3, kv_pos].clone()
        got = A.attend_step_l(q, kn, vn, cache.k, cache.v, 3, kv_pos, *sl, **rope)
        for t, row in zip((cache.k, cache.v), rows):
            if not torch.equal(t[3, kv_pos].view(torch.uint8), row.view(torch.uint8)):
                raise AssertionError(f"attend_step_l e5m2 pos {pos}: the kernel's written row "
                                     "differs from the plain version's")
        kk = cache.k[:4, :kv_len].transpose(1, 2).to(torch.bfloat16)   # (4, Hk, kv_len, D)
        vv = cache.v[:4, :kv_len].transpose(1, 2).to(torch.bfloat16)
        qq = q.reshape(1, Hq, 1, D).to(torch.bfloat16)
        bench.case("attend_step_l",
                   f"e5m2 kv_len={kv_len} pos={pos}" + (" ring+sinks" if kv_sink else ""),
                   got, want, 2e-3,
                   kernel=lambda r, a=(q, kn, vn), kp=kv_pos, s=sl: A.attend_step_l(
                       *a, cache.k, cache.v, lay(r), kp, *s, **rope),
                   plain=lambda r, a=(q, kn, vn), kp=kv_pos, s=sl: A.attend_step_plain(
                       *a, cache.k, cache.v, lay(r), kp, *s, **rope),
                   library=lambda r, qq=qq, kk=kk, vv=vv: F.scaled_dot_product_attention(
                       qq, kk[r % 4][None], vv[r % 4][None], enable_gqa=True),
                   bytes_=2 * kv_len * Hk * D + 4 * (2 * Hq * D + 2 * Hk * D),
                   flops=4 * kv_len * Hq * D, json_row=(pos == 6000))
        del kk, vv
    log("  e5m2 rows written by the kernel equal the plain version's byte for byte")

    big = KVCache.init(dataclasses.replace(cfg, n_layers=1, max_seq_len=32768), e5, dev)
    big.k.copy_(torch.randn(big.k.shape, generator=gen, device=dev).to(e5))
    big.v.copy_(torch.randn(big.v.shape, generator=gen, device=dev).to(e5))
    pos, Sb = 40000, 32768
    q, kn, vn = randn(Hk, Hq // Hk, D, scale=2.0), randn(Hk, D, scale=2.0), randn(Hk, D)
    sl = (2 + (pos - 2) % (Sb - 2), Sb, 2, pos)
    want = A.attend_step_plain(q, kn, vn, big.k, big.v, 0, *sl, **rope)
    got = A.attend_step_l(q, kn, vn, big.k, big.v, 0, *sl, **rope)
    bench.case("attend_step_l", f"e5m2 kv_len={Sb} pos={pos} scores in global", got, want, 2e-3,
               kernel=lambda r: A.attend_step_l(q, kn, vn, big.k, big.v, 0, *sl, **rope),
               plain=lambda r: A.attend_step_plain(q, kn, vn, big.k, big.v, 0, *sl, **rope),
               bytes_=2 * Sb * Hk * D + 4 * (2 * Hq * D + 2 * Hk * D), flops=4 * Sb * Hq * D)
    del big

    # K6: attn_block4_l, mid-window, without the residual
    x = randn(d, scale=3.0)
    pos = 999
    blk = dict(n_heads=Hq, norm_eps=cfg.norm_eps, add_residual=False, **rope)
    args = lambda l: (x, fw.rms_att, fw.wqkv, fw.wo, cache.k, cache.v, l,  # noqa: E731
                      pos, pos + 1, 0, pos)
    sc4 = dict(scale_qkv=sc.wqkv, scale_o=sc.wo)
    bench.case("attn_block4_l", "kv_len=1000 e5m2 cache",
               attn_block4_l(*args(5), **sc4, **blk), attn_block_plain(*args(5), **sc4, **blk),
               2e-3,
               kernel=lambda r: attn_block4_l(*args(lay(r)), **sc4, **blk),
               plain=lambda r: attn_block_plain(*args(lay(r)), **sc4, **blk),
               bytes_=w4_bytes(Nqkv, d) + w4_bytes(d, q_dim) + 2 * (pos + 1) * Hk * D + 12 * d,
               flops=2 * (Nqkv * d + d * q_dim) + 4 * (pos + 1) * Hq * D, json_row=True)
    del cache

    # K7: ffn4_l, one row (decode), without the residual
    xf = randn(d, scale=3.0)
    kw = dict(norm_eps=cfg.norm_eps, act="silu", add_residual=False)
    bench.case("ffn4_l", "B=1", ffn4_l(xf, fw.rms_ffn, fw.w13, fw.w2, 2, sc.w13, sc.w2, **kw),
               ffn_plain(xf, fw.rms_ffn, fw.w13, fw.w2, 2, sc.w13, sc.w2, **kw), 2e-3,
               kernel=lambda r: ffn4_l(xf, fw.rms_ffn, fw.w13, fw.w2, lay(r), sc.w13, sc.w2, **kw),
               plain=lambda r: ffn_plain(xf, fw.rms_ffn, fw.w13, fw.w2, lay(r), sc.w13, sc.w2,
                                         **kw),
               bytes_=w4_bytes(2 * h, d) + w4_bytes(d, h) + 12 * d, flops=6 * h * d,
               json_row=True)
    phase_ffn_rows(bench, cfg, fw, dev, (16,))
    phase_batched_attention(bench, cfg, dev, torch.float8_e5m2)
    phase_paged_attention(bench, cfg, dev, torch.float8_e5m2)


def phase_moe_kernels(bench: Bench, cfg, fw, dev) -> None:
    """Phase 2 of a Mixtral path: K10 (e5m2 experts) or K11 (packed int4)
    against the plain versions at full Mixtral shapes: the decode step's
    GEMV pair (w13 with the rmsnorm prologue and the GLU epilogue, then w2)
    with the expert ids read from a device tensor, and the GEMM at the
    tick's M 16 and a chunk's M 256 (w13 with the GLU epilogue, w2); then
    each launch bit for bit against the dense kernel on the copied expert
    stack (layer 31, expert 7: the highest offsets; the same arithmetic, so
    any difference is an addressing fault), the routed GEMV's time over the
    32 layers of one expert beside the dense kernel's on that copy, and NaN
    for an expert id outside the stack. The library yardstick is F.linear on
    a bf16 copy of one expert (dequantized for int4)."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.int4 import int4_group

    int4 = G.is_int4(fw.w13)
    bench.path = "moe_int4" if int4 else "moe_fp8"
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=dev) * scale

    L, E, d, h = cfg.n_layers, cfg.n_experts, cfg.dim, cfg.hidden_dim
    sc = fw.scales
    s13, s2 = (sc.w13, sc.w2) if sc else (None, None)
    gv, gm = ("gemv4_le", "gemm4_le") if int4 else ("gemv_le", "gemm_le")
    gemv_fn, gemm_fn = (G.gemv4_le, G.gemm4_le) if int4 else (G.gemv_le, G.gemm_le)
    ids = torch.randint(0, E, (64,), generator=gen, device=dev)   # as the decode step's top-k
    ids_host = ids.tolist()
    lay = lambda r: r % L  # noqa: E731
    norm = dict(norm_w=fw.rms_ffn, norm_eps=cfg.norm_eps)
    glu = dict(glu_act="silu")

    def wbytes(N, K):   # one expert's weight bytes (int4: packed, with its group scales)
        return N * K // 2 + 4 * (K // int4_group(K)) * N if int4 else N * K

    def lib_copies(w, s):   # bf16 copies of 4 (layer, expert) matrices, > the 50 MB L2
        if int4:
            return [dequant4(w[r, ids_host[r]][None], s[r, ids_host[r]][None])[0] for r in range(4)]
        return [w[r, ids_host[r]].to(torch.bfloat16) for r in range(4)]

    x, xh = randn(d, scale=3.0), randn(h)
    for nm, w, s, N, K, kw, xx in (("w13 + rmsnorm + GLU", fw.w13, s13, 2 * h, d,
                                    {**norm, **glu}, x), ("w2", fw.w2, s2, d, h, {}, xh)):
        wl = lib_copies(w, s)
        bench.case(gv, f"{nm}, id on the card ({N}x{K})",
                   gemv_fn(xx, w, 0, ids[0], s, **kw),
                   G.gemv_le_plain(xx, w, 0, ids_host[0], s, **kw), 2e-3,
                   kernel=lambda r, w=w, s=s, kw=kw, xx=xx: gemv_fn(xx, w, lay(r), ids[r % 64], s,
                                                                    **kw),
                   plain=lambda r, w=w, s=s, kw=kw, xx=xx: G.gemv_le_plain(
                       xx, w, lay(r), ids_host[r % 64], s, **kw),
                   library=lambda r, wl=wl, xx=xx: F.linear(xx.to(torch.bfloat16), wl[r % 4]),
                   bytes_=wbytes(N, K) + 4 * K + (4 * K if kw else 0) + 4 * (N // 2 if kw else N)
                   + 8, flops=2 * N * K, json_row=bool(kw), bf16_out=bool(kw))
        del wl
    for M in (16, 256):
        for nm, w, s, N, K, kw in (("w13 + GLU", fw.w13, s13, 2 * h, d, glu),
                                   ("w2", fw.w2, s2, d, h, {})):
            xm = randn(M, K)
            wl = lib_copies(w, s)
            bench.case(gm, f"M={M} {nm} ({N}x{K})", gemm_fn(xm, w, 0, 1, s, **kw),
                       G.gemm_le_plain(xm, w, 0, 1, s, **kw), 2e-3,
                       kernel=lambda r, xm=xm, w=w, s=s, kw=kw: gemm_fn(xm, w, lay(r), r % E, s,
                                                                        **kw),
                       plain=lambda r, xm=xm, w=w, s=s, kw=kw: G.gemm_le_plain(
                           xm, w, lay(r), r % E, s, **kw),
                       library=lambda r, xm=xm, wl=wl: F.linear(xm.to(torch.bfloat16), wl[r % 4]),
                       bytes_=wbytes(N, K) + 4 * M * (K + (N // 2 if kw else N)),
                       flops=2 * M * N * K, json_row=bool(kw), bf16_out=bool(kw),
                       run="serve" if M == 256 else ("paged" if int4 else "batched"))
            del wl

    # the addressing, bit for bit, at the highest (layer, expert) offsets
    top = torch.tensor(E - 1, device=dev)
    w13e, w2e = fw.w13[:, E - 1].contiguous(), fw.w2[:, E - 1].contiguous()
    s13e, s2e = ((s13[:, E - 1].contiguous(), s2[:, E - 1].contiguous()) if int4
                 else (None, None))
    xm16, xm256, hm = randn(16, d), randn(256, d), randn(256, h)
    pairs = [("GEMV w13 + rmsnorm + GLU", gemv_fn(x, fw.w13, L - 1, top, s13, **norm, **glu),
              G.launch_gemv("check", x, w13e, L - 1, scale=s13e, **norm, **glu)),
             ("GEMV w2", gemv_fn(xh, fw.w2, L - 1, top, s2),
              G.launch_gemv("check", xh, w2e, L - 1, scale=s2e)),
             ("GEMM M=16 w13 + GLU", gemm_fn(xm16, fw.w13, L - 1, E - 1, s13, **glu),
              G.launch_gemm("check", xm16, w13e, L - 1, s13e, **glu)),
             ("GEMM M=256 w13 + GLU", gemm_fn(xm256, fw.w13, L - 1, top, s13, **glu),
              G.launch_gemm("check", xm256, w13e, L - 1, s13e, **glu)),
             ("GEMM M=256 w2", gemm_fn(hm, fw.w2, L - 1, E - 1, s2),
              G.launch_gemm("check", hm, w2e, L - 1, s2e))]
    torch.cuda.synchronize()
    for what, got, want in pairs:
        if not torch.equal(got, want):
            raise AssertionError(f"{gv}/{gm} {what}: differs from the dense kernel on the "
                                 f"copied expert stack (max |diff| {(got - want).abs().max()})")
    # the same GEMV over all 32 layers of one expert, on the whole stack and
    # on the copied one (a tenth of the footprint): what the footprint costs
    for what, xx, w, we, s, se, kw in (("w13 + rmsnorm + GLU", x, fw.w13, w13e, s13, s13e,
                                        {**norm, **glu}), ("w2", xh, fw.w2, w2e, s2, s2e, {})):
        t_le = bench.time_ms(lambda r: gemv_fn(xx, w, lay(r), top, s, **kw), reps=32)
        t_l = bench.time_ms(lambda r: G.launch_gemv("check", xx, we, lay(r), scale=se, **kw),
                            reps=32)
        log(f"  {gv} {what}: {t_le:.4f} ms on the {weight_gb(fw):.1f} GB model, the dense "
            f"kernel on the copied expert stack ({we.numel() * we.element_size() / 1e9:.2f} GB) "
            f"{t_l:.4f} ms")
        bench.footprint.append(dict(path=bench.path, case=what, routed_ms=t_le, copied_ms=t_l))
    del w13e, w2e, s13e, s2e, pairs
    bad = torch.tensor([E, -1], device=dev)
    outs = [gemv_fn(x, fw.w13, 3, bad[0], s13, **norm, **glu), gemv_fn(xh, fw.w2, 3, bad[1], s2),
            gemm_fn(xm16, fw.w13, 3, bad[0], s13, **glu), gemm_fn(hm, fw.w2, 3, bad[1], s2)]
    torch.cuda.synchronize()
    if not all(bool(torch.isnan(o).all()) for o in outs):
        raise AssertionError(f"{gv}/{gm}: an expert id outside [0, {E}) did not give NaN")
    log(f"  {gv}/{gm}: bit for bit as {gv[:-1]}/{gm[:-1]} on the copied stack of layer "
        f"{L - 1}, expert {E - 1} (GEMV w13 + norm + GLU, w2; GEMM M 16 and 256), "
        f"ids from the card; NaN for ids {E} and -1")


def phase_ffn_rows(bench: Bench, cfg, fw, dev, rows_list) -> None:
    """K4/K7 past 8 rows, the batched tick's FFN: the GEMM route (row norm,
    w13 GEMM with the GLU-pair epilogue, w2 GEMM), without the residual.
    The GLU output, an intermediate, is checked bit for bit: every value
    the w13 GEMM writes is a bf16 value, and within 2e-3 of the plain GLU."""
    import torch
    from yalm_tpu_torch.ops.core import silu
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.cuda.ffn import ffn, ffn_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    L, d, h = cfg.n_layers, cfg.dim, cfg.hidden_dim
    sc = fw.scales
    s13, s2 = (sc.w13, sc.w2) if sc else (None, None)
    int4 = G.is_int4(fw.w13)
    name = "ffn4_l" if int4 else "ffn_l"
    wbytes = (fw.w13[0].numel() + fw.w2[0].numel()
              + (4 * (s13[0].numel() + s2[0].numel()) if int4 else 0))
    lay = lambda r: r % L  # noqa: E731
    kw = dict(norm_eps=cfg.norm_eps, act="silu", add_residual=False)
    for B in rows_list:
        x = torch.randn(B, d, generator=gen, device=dev) * 3.0
        xb = G.bf16f(x * torch.rsqrt((x * x).mean(-1, keepdim=True) + cfg.norm_eps)
                     * fw.rms_ffn[2])
        glu = G.launch_gemm("check", xb, fw.w13, 2, s13, glu_act="silu")
        h13 = G.proj_plain(xb, fw.w13, 2, s13)
        torch.cuda.synchronize()
        if not torch.equal(glu, G.bf16f(glu)):
            raise AssertionError(f"{name} B={B}: the w13 GEMM's GLU output is not bf16-rounded")
        ref = G.bf16f(silu(h13[:, :h]) * h13[:, h:])
        gerr = float((glu - ref).abs().max())
        if gerr > 2e-3 * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"{name} B={B}: GLU output differs from the plain GLU by {gerr}")
        log(f"  {name} B={B}: GLU output bf16-rounded bit for bit, max |err| {gerr:.3e}")
        bench.case(f"{name}_gemm", f"B={B} (GEMM route)" + ("" if int4 else " e5m2"),
                   ffn(x, fw.rms_ffn, fw.w13, fw.w2, 2, s13, s2, **kw),
                   ffn_plain(x, fw.rms_ffn, fw.w13, fw.w2, 2, s13, s2, **kw), 2e-3,
                   kernel=lambda r, x=x: ffn(x, fw.rms_ffn, fw.w13, fw.w2, lay(r), s13, s2, **kw),
                   plain=lambda r, x=x: ffn_plain(x, fw.rms_ffn, fw.w13, fw.w2, lay(r), s13, s2,
                                                  **kw),
                   bytes_=wbytes + 8 * B * d + 4 * d, flops=B * 6 * h * d,
                   json_row=B == 16, run="batched")


def batched_lanes(S: int):
    """16 lanes of a batched tick: kv_len from 1 to the window, one lane in
    the ring regime (sinks), two write-masked lanes."""
    pos = [0, 1, 63, 64, 199, 511, 998, 1499, 2047, 2600, 3071, 3500, 3999, 4094, S - 1,
           S + 1903]
    sink = [2 if p >= S else 0 for p in pos]
    kv_pos = [s + (p - s) % (S - s) for p, s in zip(pos, sink)]
    kv_len = [min(p + 1, S) for p in pos]
    write = [1] * 16
    write[3] = write[11] = 0
    return kv_pos, kv_len, sink, pos, write


def shuffled_tables(B: int, nblk: int, seed: int):
    """(B, nblk) int32 page tables over a pool of 1 + B * nblk pages: a
    random permutation of pages 1.., so no lane's pages are contiguous and
    page 0 stays unmapped."""
    import torch
    perm = torch.randperm(B * nblk, generator=torch.Generator().manual_seed(seed)) + 1
    return perm.reshape(B, nblk).to(torch.int32)


def gathered(pool, tables):
    """Each lane's pages of a pool (n_pages, L, page, Hk, D) in the dense
    batched layout (B, L, S, Hk, D)."""
    g = pool[tables.long()]                          # (B, nblk, L, page, Hk, D)
    return g.transpose(1, 2).reshape(g.shape[0], g.shape[2], -1, *g.shape[4:]).contiguous()


def phase_paged_attention(bench: Bench, cfg, dev, kv_dtype) -> None:
    """K9 at B 16 over pools of 257 pages of 256 slots through shuffled
    tables, at the lanes of batched_lanes: the output against the plain
    version, the pool byte for byte (written rows, untouched pages, the
    masked lanes), and K9 equal to K8 bit for bit on the same cache gathered
    into the dense layout. First at the model's depth (a bf16 pool of
    2.16e9 elements: offsets past 2^31), then on 4 layers, the footprint of
    K8's case, whose row the kernels line reports; the library yardstick is
    SDPA over the gathered padded batch."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.ops.cuda import attention as A

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    Hq, Hk, D, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len
    B, page = 16, 256
    nblk = S // page
    tables_cpu = shuffled_tables(B, nblk, seed=13)
    tables = tables_cpu.to(dev)
    kv_pos, kv_len, sink, pos, write = batched_lanes(S)
    lanes = A.lane_scalars(kv_pos, kv_len, sink, pos, write, S=S, kv_sinks=2, device=dev)
    lanes_cpu = lanes.cpu()
    q = torch.randn(B, Hk, Hq // Hk, D, generator=gen, device=dev) * 2
    kn = torch.randn(B, Hk, D, generator=gen, device=dev) * 2
    vn = torch.randn(B, Hk, D, generator=gen, device=dev)
    rope = dict(kv_sinks=2, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    wd = "e5m2" if kv_dtype.itemsize == 1 else "bf16"
    bits = torch.uint8 if kv_dtype.itemsize == 1 else torch.int16
    mask = (torch.arange(S, device=dev)[None, :] < torch.tensor(kv_len, device=dev)[:, None])
    qq = q.reshape(B, Hq, 1, D).to(torch.bfloat16)
    L4 = 4
    for L in (cfg.n_layers, L4):
        shape = (1 + B * nblk, L, page, Hk, D)
        k_pool = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16).to(kv_dtype)
        v_pool = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16).to(kv_dtype)
        top = L - 1   # the last layer: the highest pool offsets
        k2, v2 = k_pool.clone(), v_pool.clone()
        want = A.attend_step_paged_plain(q, kn, vn, k2, v2, tables_cpu, top, lanes_cpu, **rope)
        got = A.attend_step_paged(q, kn, vn, k_pool, v_pool, tables, top, lanes, **rope)
        torch.cuda.synchronize()
        for t, ref in ((k_pool, k2), (v_pool, v2)):
            if not torch.equal(t.view(bits), ref.view(bits)):
                raise AssertionError(f"attend_step_paged_l {wd}: the pool differs from the plain "
                                     "version's (written rows, untouched pages or a masked lane)")
        del k2, v2
        # K8 on the gathered cache: the same arithmetic, so any difference is
        # an addressing fault (the rows K9 wrote are written again, the same)
        k_all, v_all = gathered(k_pool, tables), gathered(v_pool, tables)
        again = A.attend_step_paged(q, kn, vn, k_pool, v_pool, tables, top, lanes, **rope)
        dense = A.attend_step_batched(q, kn, vn, k_all, v_all, top, lanes, **rope)
        torch.cuda.synchronize()
        if not (torch.equal(again, dense) and torch.equal(again, got)):
            raise AssertionError(f"attend_step_paged_l {wd}: differs from attend_step_batched_l "
                                 "on the gathered cache")
        for pool, dense_c in ((k_pool, k_all), (v_pool, v_all)):
            if not torch.equal(gathered(pool, tables).view(bits), dense_c.view(bits)):
                raise AssertionError(f"attend_step_paged_l {wd}: written rows differ from "
                                     "attend_step_batched_l's")
        del k_all, v_all
        log(f"  attend_step_paged_l {wd}, {L} layers ({k_pool.numel() / 1e9:.2f}e9 elements): "
            "pool byte for byte as the plain version's (14 written rows, 2 write-masked "
            "lanes), outputs and rows bit for bit as attend_step_batched_l's on the gathered "
            "cache")
        kk = [gathered(k_pool[:, top - l: top - l + 1], tables)[:, 0].transpose(1, 2)
              .to(torch.bfloat16) for l in range(L4)]
        vv = [gathered(v_pool[:, top - l: top - l + 1], tables)[:, 0].transpose(1, 2)
              .to(torch.bfloat16) for l in range(L4)]
        item = kv_dtype.itemsize
        bench.case("attend_step_paged_l", f"B=16 {wd} {L} layers, pages of 256 shuffled, kv_len "
                   f"1..{S}, ring + 2 read-only lanes", got, want, 2e-3,
                   kernel=lambda r: A.attend_step_paged(q, kn, vn, k_pool, v_pool, tables,
                                                        top - r % L4, lanes, **rope),
                   plain=lambda r: A.attend_step_paged_plain(q, kn, vn, k_pool, v_pool,
                                                             tables_cpu, top - r % L4,
                                                             lanes_cpu, **rope),
                   library=lambda r: F.scaled_dot_product_attention(
                       qq, kk[r % L4], vv[r % L4], attn_mask=mask[:, None, None, :],
                       enable_gqa=True),
                   bytes_=2 * sum(kv_len) * Hk * D * item + 4 * B * (2 * Hq * D + 2 * Hk * D)
                   + 4 * 5 * B + 4 * B * nblk,
                   flops=4 * sum(kv_len) * Hq * D, json_row=L == L4, run="paged")
        del kk, vv, k_pool, v_pool
        torch.cuda.empty_cache()


def phase_batched_attention(bench: Bench, cfg, dev, kv_dtype) -> None:
    """K8 at B 16 on a 4-layer cache of the model's window: every lane's
    written rows equal the plain version's byte for byte, write-masked
    lanes change nothing; the library yardstick is SDPA over the padded
    batch (a mask per lane)."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.cuda import attention as A

    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    Hq, Hk, D, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len
    B, L4 = 16, 4
    cache = KVCache.init(dataclasses.replace(cfg, n_layers=L4), kv_dtype, dev, batch=B)
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev, dtype=torch.bfloat16).to(kv_dtype))
    kv_pos, kv_len, sink, pos, write = batched_lanes(S)
    lanes = A.lane_scalars(kv_pos, kv_len, sink, pos, write, S=S, kv_sinks=2, device=dev)
    lanes_cpu = lanes.cpu()
    q = torch.randn(B, Hk, Hq // Hk, D, generator=gen, device=dev) * 2
    kn = torch.randn(B, Hk, D, generator=gen, device=dev) * 2
    vn = torch.randn(B, Hk, D, generator=gen, device=dev)
    rope = dict(kv_sinks=2, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    k2, v2 = cache.k.clone(), cache.v.clone()
    want = A.attend_step_batched_plain(q, kn, vn, k2, v2, 1, lanes_cpu, **rope)
    got = A.attend_step_batched(q, kn, vn, cache.k, cache.v, 1, lanes, **rope)
    torch.cuda.synchronize()
    bits = torch.uint8 if kv_dtype.itemsize == 1 else torch.int16
    for t, ref in ((cache.k, k2), (cache.v, v2)):
        if not torch.equal(t.view(bits), ref.view(bits)):
            raise AssertionError(f"attend_step_batched_l {kv_dtype}: the cache differs from the "
                                 "plain version's (written rows or a masked lane)")
    del k2, v2
    wd = "e5m2" if kv_dtype.itemsize == 1 else "bf16"
    log(f"  attend_step_batched_l {wd}: 14 written rows and 2 write-masked lanes equal the "
        "plain version's cache byte for byte")
    # SDPA over the padded batch: (B, Hk, S, D) bf16 copies of 4 layers and
    # a mask of each lane's kv_len (no sink view: a yardstick of speed)
    kk = [cache.k[:, l].transpose(1, 2).to(torch.bfloat16) for l in range(L4)]
    vv = [cache.v[:, l].transpose(1, 2).to(torch.bfloat16) for l in range(L4)]
    mask = (torch.arange(S, device=dev)[None, :] < torch.tensor(kv_len, device=dev)[:, None])
    qq = q.reshape(B, Hq, 1, D).to(torch.bfloat16)
    item = kv_dtype.itemsize
    bench.case("attend_step_batched_l", f"B=16 {wd} kv_len 1..{S}, ring + 2 read-only lanes",
               got, want, 2e-3,
               kernel=lambda r: A.attend_step_batched(q, kn, vn, cache.k, cache.v, r % L4,
                                                      lanes, **rope),
               plain=lambda r: A.attend_step_batched_plain(q, kn, vn, cache.k, cache.v, r % L4,
                                                           lanes_cpu, **rope),
               library=lambda r: F.scaled_dot_product_attention(
                   qq, kk[r % L4], vv[r % L4], attn_mask=mask[:, None, None, :],
                   enable_gqa=True),
               bytes_=2 * sum(kv_len) * Hk * D * item + 4 * B * (2 * Hq * D + 2 * Hk * D)
               + 4 * 5 * B,
               flops=4 * sum(kv_len) * Hq * D, json_row=True, run="batched")
    del kk, vv, cache


# the kernels each path must launch in its phase-3 run (the Mixtral paths'
# router is gemv_l/gemm_l on every weight type), and those it must not
PATH_KERNELS = {"fp8": ("gemv", "gemv_l", "gemm_l", "attend_step_l", "attn_block_l", "ffn_l"),
                "int4": ("gemv", "gemv4_l", "gemm4_l", "attend_step_l", "attn_block4_l",
                         "ffn4_l"),
                "moe_fp8": ("gemv", "gemv_l", "gemm_l", "attend_step_l", "attn_block_l",
                            "gemv_le", "gemm_le"),
                "moe_int4": ("gemv", "gemv_l", "gemm_l", "gemv4_l", "gemm4_l", "attend_step_l",
                             "attn_block4_l", "gemv4_le", "gemm4_le")}
PATH_ABSENT = {"moe_fp8": ("ffn_l", "ffn_l_gemm"), "moe_int4": ("ffn4_l", "ffn4_l_gemm")}
# (name, prompt tokens, new tokens, sampled); a "ring" request continues the
# one before it past the window
SERVE_REQUESTS = (("greedy 200+64", 200, 64, False), ("sampled 1500+64", 1500, 64, True),
                  ("window 4090+16", 4090, 16, False), ("ring follow-up 8+8", 8, 8, False))
MOE_SERVE_REQUESTS = {"moe_fp8": (("greedy 200+64", 200, 64, False),
                                  ("sampled 1500+32", 1500, 32, True),
                                  ("window 4090+16", 4090, 16, False),
                                  ("ring follow-up 8+8", 8, 8, False)),
                      "moe_int4": (("greedy 200+64", 200, 64, False),
                                   ("sampled 1500+32", 1500, 32, True))}


def routed_names(fw):
    """The launch counts of an MoE path's routed-expert GEMV and GEMM."""
    from yalm_tpu_torch.ops.cuda.gemv import is_int4
    return ("gemv4_le", "gemm4_le") if is_int4(fw.w13) else ("gemv_le", "gemm_le")


def phase_serve(cfg, fw, dev, kv_dtype, path: str, requests=SERVE_REQUESTS) -> dict:
    """Phase 3: the requests (a ring follow-up continues the one before it)
    through Engine.generate at full size, with the path's launch counts; on
    an MoE path the routed-expert GEMV launched 2 x k x n_layers times per
    decode step and the GEMM 2 x E x n_layers times per prefill chunk."""
    import collections

    import numpy as np
    import torch
    from yalm_tpu_torch.engine import Engine
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.tokenizer import Tokenizer
    from yalm_tpu_torch.utils.testing import synth_vocab

    tok = Tokenizer(synth_vocab(cfg.vocab_size), cfg.bos_token_id, cfg.eos_token_id)
    eng = Engine(cfg, fw, tok, kv_dtype=kv_dtype, device=dev)
    rng = np.random.default_rng(0)

    def prompt(n):
        return [cfg.bos_token_id] + rng.integers(3, cfg.vocab_size, n - 1).tolist()

    def serve(name, toks, n, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, t_first = [], None
        for t in eng.generate(toks, max_steps=n, **kw):
            if t_first is None:
                t_first = time.perf_counter()
            out.append(t)
        t_end = time.perf_counter()
        logits = eng._last_logits
        if len(out) != n or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"{name}: bad token stream {out[:8]}... ({len(out)})")
        if not bool(torch.isfinite(logits).all()) or logits.shape != (cfg.vocab_size,):
            raise AssertionError(f"{name}: non-finite or misshapen logits")
        r = dict(request=name, prompt_tokens=len(toks), new_tokens=n,
                 ttft_s=t_first - t0, prefill_tok_s=len(toks) / (t_first - t0),
                 decode_tok_s=(n - 1) / (t_end - t_first) if n > 1 else None,
                 end_pos=eng.pos)
        log(f"  {name}: prompt {len(toks)}, {n} new: TTFT {r['ttft_s']:.4f} s, "
            f"prefill {r['prefill_tok_s']:.1f} tok/s, decode {r['decode_tok_s']:.2f} tok/s, "
            f"first tokens {out[:6]}")
        return r

    eng.warmup()
    calls: collections.Counter = collections.Counter()   # decode steps, prefill chunks
    for nm in ("_step", "_prefill"):
        def counted(*a, _fn=getattr(eng, nm), _nm=nm, **k):
            calls[_nm] += 1
            return _fn(*a, **k)
        setattr(eng, nm, counted)
    _build.LAUNCHES.clear()
    reqs = []
    profile = None
    for name, n_prompt, n_new, sampled in requests:
        # a follow-up turn starts past the window: per-token hydration in the
        # ring regime, sinks active
        if not name.startswith("ring"):
            eng.reset()
        kw = dict(temperature=0.8, top_p=0.9, seed=1234) if sampled else dict(temperature=0.0)
        reqs.append(serve(name, prompt(n_prompt), n_new, **kw))
        if profile is None:
            profile = profile_decode(eng, 16)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"  launches over the {path} path's requests ({calls['_step']} decode steps, "
        f"{calls['_prefill']} prefill chunks): {launches}")
    missing = [k for k in PATH_KERNELS[path] if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing}")
    present = [k for k in PATH_ABSENT.get(path, ()) if launches.get(k, 0)]
    if present:
        raise AssertionError(f"dense-FFN kernels launched on the {path} path: {present}")
    out = dict(requests=reqs, launches=launches, decode_profile=profile,
               decode_steps=calls["_step"], prefill_chunks=calls["_prefill"])
    if cfg.is_moe:
        gv, gm = routed_names(fw)
        per_step = launches[gv] / calls["_step"]
        per_chunk = launches[gm] / calls["_prefill"]
        want = (2 * cfg.n_experts_active * cfg.n_layers, 2 * cfg.n_experts * cfg.n_layers)
        if (per_step, per_chunk) != want:
            raise AssertionError(f"{path}: {gv} {per_step} per decode step, {gm} {per_chunk} "
                                 f"per prefill chunk; expected {want}")
        log(f"  {gv}: {per_step:.0f} launches per decode step; {gm}: {per_chunk:.0f} per "
            "prefill chunk")
        out.update({f"{gv}_per_step": per_step, f"{gm}_per_chunk": per_chunk,
                    "decode_host_syncs": decode_syncs(cfg, fw, eng)})
    return out


def decode_syncs(cfg, fw, eng) -> int:
    """The synchronizing operations of one decode step with the token on the
    card (torch.cuda's sync debug mode): none may occur, so no routed expert
    id is read back to the host. Raises otherwise; returns the count."""
    import warnings

    import torch
    from yalm_tpu_torch.models.fast import decode_step_fast
    eng.reset()
    tok = torch.ones(1, dtype=torch.long, device=eng.device)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            decode_step_fast(cfg, fw, tok, 0, eng.cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:120] for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    if syncs:
        raise AssertionError(f"a decode step synchronized with the host: {syncs}")
    log("  one decode step with the token on the card: no synchronizing operation "
        "(the routed expert ids stay on the card)")
    return len(syncs)


# the kernels each (path, paged) serving run must launch: the tick's
# attention is K8 on the dense cache and K9 on a paged pool (the other
# never runs); the dense ring admission hydrates through the single-lane
# step (attn_block_l), the paged one through masked ticks
SERVING_KERNELS = {
    ("fp8", False): ("gemm_l", "ffn_l_gemm", "rmsnorm_rows", "attn_block_l", "gemv"),
    ("int4", False): ("gemm4_l", "ffn4_l_gemm", "rmsnorm_rows"),
    ("fp8", True): ("gemm_l", "ffn_l_gemm", "rmsnorm_rows", "gemv"),
    ("int4", True): ("gemm4_l", "ffn4_l_gemm", "rmsnorm_rows"),
    # MoE: the router on gemm_l, every expert of every row on the routed GEMM
    # (the single-token gemv_le/gemv4_le and the dense FFN never run)
    ("moe_fp8", False): ("gemm_l", "gemm_le"),
    ("moe_int4", True): ("gemm_l", "gemm4_l", "gemm4_le")}
SERVING_ABSENT = {"moe_fp8": ("gemv_le", "ffn_l_gemm"), "moe_int4": ("gemv4_le", "ffn4_l_gemm")}
TICK_ATTENTION = {False: "attend_step_batched_l", True: "attend_step_paged_l"}
MISTRAL_SERVING_LAYERS = 8
PAGE = 256
PAGED_PAGES = 65   # page 0 reserved: 64 usable pages, 16384 slots for 16 lanes


def http_requests(base: str, n: int = 4) -> list[dict]:
    """The first n of four requests over HTTP, as clients send them: a
    completion with top-5 logprobs, a chat turn, an SSE stream and a sampled
    completion."""
    import urllib.request
    text = "hello world the key is 12345. " * 40
    bodies = [("/v1/completions", {"prompt": text, "max_tokens": 32, "temperature": 0.0,
                                   "logprobs": 5}),
              ("/v1/chat/completions", {"messages": [{"role": "user", "content": text}],
                                        "max_tokens": 32, "temperature": 0.0,
                                        "logprobs": True, "top_logprobs": 3}),
              ("/v1/completions", {"prompt": text[:600], "max_tokens": 32,
                                   "temperature": 0.0, "stream": True}),
              ("/v1/completions", {"prompt": text[:900], "max_tokens": 48, "temperature": 0.8,
                                   "top_p": 0.9, "top_k": 40, "seed": 7})]
    out = []
    for path, body in bodies[:n]:
        t0 = time.perf_counter()
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            raw = r.read().decode()
            status = r.status
        if body.get("stream"):
            events = [line for line in raw.splitlines() if line.startswith("data: ")]
            ok = status == 200 and events[-1] == "data: [DONE]" and len(events) >= 2
            n = len(events) - 1
        else:
            choice = json.loads(raw)["choices"][0]
            ok = status == 200 and isinstance(choice.get("text", choice.get("message")),
                                              (str, dict))
            if "logprobs" in body:
                lp = choice["logprobs"]
                ok = ok and bool(lp.get("token_logprobs") or lp.get("content"))
            n = json.loads(raw)["usage"]["completion_tokens"]
        if not ok:
            raise AssertionError(f"HTTP {path}: bad response {raw[:300]}")
        out.append(dict(path=path, stream=bool(body.get("stream")), tokens=n,
                        wall_s=time.perf_counter() - t0))
    return out


def phase_serving(cfg, fw, dev, kv_dtype, path: str, n_requests: int, http: int,
                  paged_pages: int = 0, prompts=(64, 2048), new=(32, 128),
                  past_window: bool = True) -> dict:
    """Continuous batching through ServingEngine at batch 16 with the
    server's defaults: n_requests tokenized requests (prompts and new tokens
    drawn from the `prompts` and `new` ranges, greedy and sampled at T 0.8
    top-p 0.9 top-k 40; two share a 512-token prefix, the second admitted
    after the first 16; with past_window one runs past the window), and
    `http` more over HTTP on 127.0.0.1; then 16 ticks with 16 busy lanes
    under torch.profiler. With paged_pages, from a pool of that many pages
    of 256 slots: the mix must preempt at least one lane, and every
    request, preempted ones included, gets exactly max_new_tokens tokens
    (no stop tokens), each delivered once."""
    import threading

    import numpy as np
    import torch
    from yalm_tpu_torch import server as srv
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.scheduler import Request
    from yalm_tpu_torch.tokenizer import Tokenizer
    from yalm_tpu_torch.utils.testing import synth_vocab

    tok = Tokenizer(synth_vocab(cfg.vocab_size), cfg.bos_token_id, cfg.eos_token_id)
    rng = np.random.default_rng(1)

    def rand_tokens(n):
        return rng.integers(3, cfg.vocab_size, n).tolist()

    S = cfg.max_seq_len
    prefix = [cfg.bos_token_id] + rand_tokens(min(512, S // 8) - 1)
    specs = []   # (prompt, max_new, sampled)
    for i in range(n_requests):
        n = int(rng.integers(prompts[0], min(prompts[1], S // 2) + 1))
        specs.append(([cfg.bos_token_id] + rand_tokens(n - 1),
                      int(rng.integers(new[0], new[1] + 1)), i % 2 == 1))
    specs[0] = (prefix + rand_tokens(100), new[1], False)       # registers the prefix
    specs[16] = (prefix + rand_tokens(300), 64, True)           # admitted later: a hit
    if past_window:
        specs[5] = ([cfg.bos_token_id] + rand_tokens(S + 103), 32, False)

    engine = srv.ServingEngine(cfg, fw, tok, batch=16, kv_dtype=kv_dtype, device=dev,
                               paged_pages=paged_pages, page_size=PAGE)
    sched = engine.sched
    preempted = set()   # ids of the requests a lane preemption requeued
    if paged_pages:
        preempt = sched._preempt

        def watch(b):
            preempted.add(id(sched.slots[b].request))
            preempt(b)
        sched._preempt = watch
    httpd = srv.serve(engine, host="127.0.0.1", port=0) if http else None
    if httpd:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    reqs, first, last, delivered = [], {}, {}, {}
    t0 = time.perf_counter()
    for i, (prompt, n, sampled) in enumerate(specs):
        r = Request(prompt_tokens=prompt, max_new_tokens=n,
                    temperature=0.8 if sampled else 0.0, top_p=0.9 if sampled else 1.0,
                    top_k=40 if sampled else 0, seed=100 + i)
        r.on_token = lambda t, i=i: (first.setdefault(i, time.perf_counter()),
                                     last.__setitem__(i, time.perf_counter()),
                                     delivered.__setitem__(i, delivered.get(i, 0) + 1))
        reqs.append(r)
        engine.submit(r)
    web = http_requests(f"http://127.0.0.1:{httpd.server_address[1]}", http) if httpd else []
    while not all(r.done for r in reqs):
        time.sleep(0.01)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if httpd:
        httpd.shutdown()
        httpd.server_close()
    engine.close()
    # no request has a stop token: each gets exactly its max_new_tokens
    bad = [(i, r.error, len(r.generated), delivered.get(i)) for i, r in enumerate(reqs)
           if r.error or len(r.generated) != r.max_new_tokens
           or delivered.get(i) != len(r.generated)
           or not all(0 <= t < cfg.vocab_size for t in r.generated)]
    if bad:
        raise AssertionError(f"serving ({path}): failed requests {bad}")
    stats = sched.prefix_stats
    if stats["hits"] < 1:
        raise AssertionError(f"serving ({path}): the shared 512-token prefix was never reused")
    if paged_pages and not (sched.preemptions >= 1 and sched.resumes >= 1 and preempted):
        raise AssertionError(f"serving ({path}, {paged_pages} pages): the mix preempted no "
                             f"lane ({sched.preemptions} preemptions, {sched.resumes} resumes)")
    gen = sum(len(r.generated) for r in reqs) + sum(w["tokens"] for w in web)
    ttft = sorted(first[i] - t0 for i in range(len(reqs)))
    # decode: every token after a request's first, over the span from the
    # first first token to the last token of the tokenized requests
    decode_tok_s = (sum(len(r.generated) - 1 for r in reqs)
                    / (max(last.values()) - min(first.values())))
    r = dict(requests=len(reqs) + len(web), layers=cfg.n_layers,
             prompt_tokens=sum(len(p) for p, _, _ in specs),
             generated_tokens=gen, wall_s=wall, aggregate_tok_s=gen / wall,
             aggregate_decode_tok_s=decode_tok_s,
             ttft_p50_s=float(np.median(ttft)), ttft_max_s=ttft[-1],
             ticks=engine.metrics["ticks_total"], admit_sweeps=sched.admit_sweeps,
             prefix=dict(stats), http=web, launches=launches)
    if paged_pages:
        r.update(pages=paged_pages, page_size=PAGE, preemptions=sched.preemptions,
                 resumes=sched.resumes, preempted_requests=len(preempted),
                 pages_free_end=sched.alloc.n_free,
                 pool_bytes=2 * sched.cache.k.numel() * sched.cache.k.element_size())
    log(f"  served {r['requests']} requests ({len(web)} over HTTP) in {wall:.2f} s: "
        f"{r['prompt_tokens']} prompt tokens, {gen} generated ({r['aggregate_tok_s']:.1f} "
        f"tok/s over the run), aggregate decode {decode_tok_s:.1f} tok/s; "
        f"TTFT p50 {r['ttft_p50_s']:.3f} s, max "
        f"{r['ttft_max_s']:.3f} s; {r['ticks']} ticks, {r['admit_sweeps']} batched admission "
        f"sweeps, prefix hits {stats['hits']} ({stats['hit_tokens']} tokens)")
    if paged_pages:
        log(f"  paged: {paged_pages} pages of {PAGE} ({r['pool_bytes'] / 1e9:.3f} GB of K/V), "
            f"{sched.preemptions} preemptions of {len(preempted)} requests, {sched.resumes} "
            f"resumes, every preempted stream exactly max_new_tokens long; "
            f"{r['pages_free_end']} pages free at the end")
    for w in web:
        log(f"    HTTP {w['path']}{' (SSE)' if w['stream'] else ''}: {w['tokens']} tokens "
            f"in {w['wall_s']:.2f} s")
    log(f"  launches over the {path} serving run: {launches}")
    attention = TICK_ATTENTION[bool(paged_pages)]
    missing = [k for k in SERVING_KERNELS[path, bool(paged_pages)] + (attention,)
               if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the {path} serving run: {missing}")
    for k in (TICK_ATTENTION[not paged_pages],) + SERVING_ABSENT.get(path, ()):
        if launches.get(k, 0):
            raise AssertionError(f"{k} launched in the {path} "
                                 f"{'paged' if paged_pages else 'dense'} serving run")
    per_tick = {attention: cfg.n_layers}
    if cfg.is_moe:
        per_tick[routed_names(fw)[1]] = 2 * cfg.n_experts * cfg.n_layers
    r["tick_profile"] = profile_ticks(sched, cfg, 16, per_tick)
    del engine, sched
    torch.cuda.empty_cache()
    return r


@contextlib.contextmanager
def moe_ffn_spans(cfg):
    """For an MoE cfg, CUDA events around every call of the chunk paths'
    MoE FFN (`_moe_ffn_batched`) while active: yields the list of (start,
    end) pairs; for a dense cfg an empty list."""
    import torch
    from yalm_tpu_torch.models import fast as M
    spans: list = []
    if not cfg.is_moe:
        yield spans
        return
    ffn = M._moe_ffn_batched

    def timed(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = ffn(*a, **k)
        ev[1].record()
        spans.append(ev)
        return out
    M._moe_ffn_batched = timed
    try:
        yield spans
    finally:
        M._moe_ffn_batched = ffn


@contextlib.contextmanager
def routing_log(cfg):
    """While active (a parity phase's card and CPU runs of an MoE cfg):
    every call of the top-k gate records each row's chosen experts and, on
    the CPU, whether the row's k-th and (k+1)-th router logits lie within
    twice the logit tolerance (1e-2 of max(1, max|router logit|) of the
    row), a near-tie that an error inside the tolerance may route
    differently on the card. Yields take(), which returns, and forgets, the
    (experts, near) pairs of the layers since its last call."""
    import numpy as np
    import torch
    from yalm_tpu_torch.models import fast as M
    calls: list = []
    gate = M.moe_gate

    def recording(logits, k):
        gates, idx = gate(logits, k)
        E = logits.shape[-1]
        experts = torch.sort(idx.reshape(-1, k), dim=-1).values.cpu().numpy()
        near = None
        if logits.device.type == "cpu":
            lf = logits.float().reshape(-1, E)
            near = np.zeros(lf.shape[0], bool)
            if E > k:
                top = lf.topk(k + 1, dim=-1).values
                tol = 1e-2 * lf.abs().amax(-1).clamp(min=1.0)
                near = (top[:, k - 1] - top[:, k] <= 2 * tol).numpy()
        calls.append((experts, near))
        return gates, idx

    def take() -> list:
        out = list(calls)
        calls.clear()
        return out
    M.moe_gate = recording
    try:
        yield take
    finally:
        M.moe_gate = gate


def routing_holds(card: list, cpu: list, lanes: list, tainted):
    """Which lanes' outputs of one forward pass to hold to nothing: lanes[b]
    = (the lane's rows, its output row); `tainted` (updated in place) marks
    lanes whose cache holds a row that routed differently on the card. A
    lane is held when its output row routed near a tie on the CPU (in any
    layer), when its output row routed differently on the card, when a row
    before it in the pass did so in a layer whose output the next layer
    attends to, or when it is tainted. A row that routed differently with no
    near-tie on the CPU is an error past the tolerance, and raises. Returns
    (near-tie lanes, held lanes) as bool arrays; all False for a dense cfg."""
    import numpy as np
    B = len(lanes)
    if not cpu:
        return np.zeros(B, bool), tainted.copy()
    differ = np.stack([(a != b).any(-1) for (a, _), (b, _) in zip(card, cpu)])  # (layers, rows)
    near = np.logical_or.reduce([n for _, n in cpu])
    wrong = differ.any(0) & ~near
    if wrong.any():
        raise AssertionError(f"rows {np.flatnonzero(wrong).tolist()} routed differently on the "
                             "card with no near-tie on the CPU")
    spread = differ[:-1].any(0)      # a layer's output that the next layer attends to
    near_out = np.array([near[out] for _, out in lanes])
    held = np.array([near[out] or differ[:, out].any() or spread[rows][: out - rows.start + 1].any()
                     or t for (rows, out), t in zip(lanes, tainted)])
    tainted |= np.array([spread[rows].any() for rows, _ in lanes])
    return near_out, held


def profile_ticks(sched, cfg, n: int, per_tick: dict) -> dict:
    """torch.profiler over n ticks of the scheduler with every lane busy
    decoding (prompts of 64 tokens admitted first); each kernel of
    `per_tick` must launch that many times per tick."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.scheduler import Request

    rng = np.random.default_rng(2)
    for i in range(sched.B):
        sched.submit(Request(prompt_tokens=[cfg.bos_token_id]
                             + rng.integers(3, cfg.vocab_size, 63).tolist(),
                             max_new_tokens=n + 8, temperature=0.0,
                             stop_tokens=frozenset()))
    while not all(s.decoding for s in sched.slots):
        sched.step()
    torch.cuda.synchronize()
    before = {k: _build.LAUNCHES[k] for k in per_tick}
    with moe_ffn_spans(cfg) as spans, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            if sched.step() != sched.B:
                raise AssertionError("a lane went idle inside the profiled ticks")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: (_build.LAUNCHES[k] - before[k]) / n for k in per_tick}
    if counts != per_tick:
        raise AssertionError(f"launches per tick {counts}, expected {per_tick}")
    dev_us = device_us(prof)
    busy = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    r = dict(ticks=n, lanes=sched.B, wall_ms_per_tick=wall / n * 1e3,
             device_ms_per_tick=busy / n * 1e3, idle_share=(1 - busy / wall) if busy else None,
             tok_s=sched.B * n / wall, top=[(k[:60], v / n / 1e3) for k, v in top],
             launches_per_tick=counts)
    if spans:
        r["moe_ffn_ms_per_tick"] = sum(a.elapsed_time(b) for a, b in spans) / n
    log(f"  tick profile, {sched.B} busy lanes, launches per tick {counts}: "
        f"{r['wall_ms_per_tick']:.3f} ms/tick wall, "
        f"{r['device_ms_per_tick']:.3f} ms/tick on the device, idle share {r['idle_share']}, "
        f"{r['tok_s']:.1f} tok/s"
        + (f"; the MoE FFN (router, gate, the all-expert sweep) spans "
           f"{r['moe_ffn_ms_per_tick']:.3f} ms/tick on the card" if spans else ""))
    for k, ms in r["top"]:
        log(f"    {ms:8.4f} ms/tick  {k}")
    for s in sched.slots:
        if s.request is not None:
            s.request.cancelled = True
    sched.run()
    return r


def first_layers(fw, n: int):
    """The first n layers of FastWeights (views)."""
    from yalm_tpu_torch.models.fast import FastScales, FastWeights
    sc = fw.scales
    cut = lambda t: None if t is None else t[:n]  # noqa: E731
    return FastWeights(embed=fw.embed, rms_att=fw.rms_att[:n], rms_ffn=fw.rms_ffn[:n],
                       wqkv=fw.wqkv[:n], wo=fw.wo[:n], w13=fw.w13[:n], w2=fw.w2[:n],
                       final_norm=fw.final_norm, lm_head=fw.lm_head, moegate=cut(fw.moegate),
                       scales=None if sc is None else FastScales(
                           embed=sc.embed, wqkv=sc.wqkv[:n], wo=sc.wo[:n], w13=sc.w13[:n],
                           w2=sc.w2[:n], lm_head=sc.lm_head, moegate=cut(sc.moegate)))


def phase_batched_parity(cfg, fw, dev, kv_dtype, paged: bool = False, B: int = 16,
                         T: int = 16, ticks: int = 8) -> dict:
    """Phase 4, batched: the depth-2 model over B lanes, card (kernels) vs
    CPU (plain versions), on caches that start random and equal: one
    prefill_chunk_fast_batched sweep of T-row chunks (3/4 of the lanes at
    offsets up to the window's end, the rest disabled), then `ticks`
    teacher-forced ticks at mixed positions (lanes in the ring regime, two
    write-masked). Logits within 1e-2 of max(1, max|logit|), argmax equal on
    every lane that is not a near-tie; MoE lanes that routing_holds names
    are held to nothing and counted.
    `paged`: the same over a pool of 1 + B x 16 pages of 256 slots through
    shuffled tables (prefill_chunk_fast_batched_paged, then
    decode_step_fast_batched_paged)."""
    import numpy as np
    import torch
    from yalm_tpu_torch.models import fast as M
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.paged import PagedKVPool

    cfg = dataclasses.replace(cfg, n_layers=2)
    fw2 = first_layers(fw, 2)
    fw_cpu = fw2.to("cpu")
    S = cfg.max_seq_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    if paged:
        tables = shuffled_tables(B, S // PAGE, seed=11).numpy()
        card = PagedKVPool.init(cfg, kv_dtype, 1 + B * (S // PAGE), PAGE, dev)
        Cache = PagedKVPool
    else:
        card = KVCache.init(cfg, kv_dtype, dev, batch=B)
        Cache = KVCache
    for t in (card.k, card.v):
        t.copy_((torch.randn(t.shape, generator=gen, device=dev, dtype=torch.bfloat16)
                 * 0.5).to(kv_dtype))
    cpu = Cache(k=card.k.to("cpu", copy=True), v=card.v.to("cpu", copy=True))
    rng = np.random.default_rng(6)
    toks = rng.integers(3, cfg.vocab_size, (B, T))
    frac = np.array([0, .004, .025, .08, .25, .37, .5, .61, .73, .85, .98, 1.0])
    n_on = B - B // 4                       # enabled lanes: 12 of 16, 6 of 8
    frac = frac[np.linspace(0, len(frac) - 1, n_on).round().astype(np.int64)]
    pos0 = np.concatenate([(frac * (S - T)).astype(np.int64), np.zeros(B - n_on, np.int64)])
    valid = rng.integers(1, T + 1, B)
    enable = np.array([1] * n_on + [0] * (B - n_on))
    positions = np.concatenate([(frac * (S - 8)).astype(np.int64) + 5,
                                [S + 10, S + S // 2, S // 6, 50][:B - n_on]])
    write = np.ones(B, np.int64)
    write[[B * 7 // 16, B * 14 // 16]] = 0
    # each lane's rows of the chunk sweep and its logits row, then of a tick
    chunk_lanes = [(slice(b * T, (b + 1) * T), b * T + max(int(valid[b]), 1) - 1)
                   for b in range(B)]
    tick_lanes = [(slice(b, b + 1), b) for b in range(B)]
    runs = {}
    with routing_log(cfg) as take:
        for name, w, c in (("cuda", fw2, card), ("cpu", fw_cpu, cpu)):
            if paged:
                out, _ = M.prefill_chunk_fast_batched_paged(cfg, w, toks, pos0, valid, enable, c,
                                                            tables, page_size=PAGE, attend_len=S)
            else:
                out, _ = M.prefill_chunk_fast_batched(cfg, w, toks, pos0, valid, enable, c,
                                                      attend_len=S, logits_mode="lastv")
            outs, routes = [out], [take()]
            p = positions.copy()
            for i in range(ticks):
                tk = rng.integers(3, cfg.vocab_size, B) if name == "cuda" else runs["ticks"][i]
                if name == "cuda":
                    runs.setdefault("ticks", []).append(tk)
                if paged:
                    outs.append(M.decode_step_fast_batched_paged(cfg, w, tk, p, c, tables, write,
                                                                 page_size=PAGE)[0])
                else:
                    outs.append(M.decode_step_fast_batched(cfg, w, tk, p, c, write)[0])
                routes.append(take())
                p = p + write
            runs[name] = [o.float().cpu() for o in outs]
            runs["routes " + name] = routes
    tainted = np.zeros(B, bool)
    worst, ties, routed_ties, routed_held = 0.0, 0, 0, 0
    for step, (g, c, rc, rp) in enumerate(zip(runs["cuda"], runs["cpu"], runs["routes cuda"],
                                               runs["routes cpu"])):
        near, held = routing_holds(rc, rp, chunk_lanes if step == 0 else tick_lanes, tainted)
        routed_ties += int(near.sum())
        routed_held += int(held.sum())
        keep = torch.from_numpy(~held)
        err = float((g - c)[keep].abs().max()) if bool(keep.any()) else 0.0
        tol = 1e-2 * max(1.0, float(c.abs().max()))
        worst = max(worst, err / tol)
        # argmax on every lane whose top two CPU logits are more than 2 tol
        # apart; closer pairs are near-ties that an error inside the
        # tolerance may flip (lanes x steps of 32000 random logits)
        top2 = c.topk(2, dim=-1).values
        decided = ((top2[:, 0] - top2[:, 1]) > 2 * tol) & keep
        ties += int((~decided & keep).sum())
        flips = g.argmax(-1) != c.argmax(-1)
        if err > tol or bool((flips & decided).any()):
            raise AssertionError(f"batched depth-2 parity step {step}: max |err| {err:.3e} "
                                 f"(tol {tol:.3e}), argmax {g.argmax(-1).tolist()} vs "
                                 f"{c.argmax(-1).tolist()}")
    kerr = float((card.k.cpu().float() - cpu.k.float()).abs().max())
    n = (ticks + 1) * B
    log(f"  {'paged' if paged else 'batched'} depth-2 logits, card vs CPU plain: 1 chunk sweep "
        f"of {T} rows + {ticks} ticks x {B} lanes agree; argmax equal on all "
        f"{n - ties - routed_held} decided lanes ({ties} near-ties within 2 tol"
        + (f"; {routed_held} held for routing: {routed_ties} output rows routed near a tie, "
           "the rest reached by a row that routed differently" if cfg.is_moe else "")
        + f"); worst err/tol {worst:.3f}; cache max |err| {kerr:.3e}")
    return dict(steps=ticks + 1, lanes=B, chunk=T, worst_err_over_tol=worst, near_ties=ties,
                routing_near_ties=routed_ties, routing_held=routed_held, cache_max_err=kerr)


def device_us(prof) -> dict:
    """Device time (us) by name from a torch.profiler run, of the device's
    own events only: the row of an aten op repeats the time of the kernels
    it launched, and summing both counted that time twice."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = out.get(e.key, 0) + us
    return out


def profile_decode(eng, n: int) -> dict:
    """torch.profiler over n greedy decode steps (continuing the engine's
    sequence): wall time, device time by kernel, and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tok = int(torch.argmax(eng._last_logits))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tok = int(torch.argmax(eng._step(tok)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = device_us(prof)
    busy = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    r = dict(steps=n, context=eng.pos, wall_ms_per_step=wall / n * 1e3,
             device_ms_per_step=busy / n * 1e3,
             idle_share=(1 - busy / wall) if busy else None,
             top=[(k[:60], v / n / 1e3) for k, v in top])
    if not busy:
        log("  profiler saw no device time: only the wall time is reported")
    log(f"  decode profile at context {eng.pos}: {r['wall_ms_per_step']:.3f} ms/step wall, "
        f"{r['device_ms_per_step']:.3f} ms/step on the device, idle share {r['idle_share']}")
    for k, ms in r["top"]:
        log(f"    {ms:8.4f} ms/step  {k}")
    return r


def phase_parity(cfg, fw, dev, kv_dtype, prompt: int = 64, steps: int = 8) -> dict:
    """Phase 4: depth-2 model, card (kernels) vs CPU (plain versions): a
    prompt-token prefill chunk and `steps` teacher-forced decode steps; MoE
    steps that routing_holds names are held to nothing and counted."""
    import numpy as np
    import torch
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.fast import decode_step_fast, prefill_fast

    cfg = dataclasses.replace(cfg, n_layers=2)
    fw2 = first_layers(fw, 2)
    fw_cpu = fw2.to("cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(3, cfg.vocab_size, prompt + steps)
    worst = 0.0
    runs = {}
    with routing_log(cfg) as take:
        for name, w, d in (("cuda", fw2, dev), ("cpu", fw_cpu, torch.device("cpu"))):
            cache = KVCache.init(cfg, kv_dtype, d)
            out = [prefill_fast(cfg, w, toks[:prompt], 0, prompt, cache, logits_mode="last")[0]]
            routes = [take()]
            for i in range(steps):  # teacher-forced decode
                out.append(decode_step_fast(cfg, w, int(toks[prompt + i]), prompt + i, cache)[0])
                routes.append(take())
            runs[name] = [o.float().cpu() for o in out]
            runs["routes " + name] = routes
    tainted = np.zeros(1, bool)
    ties = held_n = 0
    for step, (g, c, rc, rp) in enumerate(zip(runs["cuda"], runs["cpu"], runs["routes cuda"],
                                               runs["routes cpu"])):
        lanes = [(slice(0, prompt), prompt - 1)] if step == 0 else [(slice(0, 1), 0)]
        near, held = routing_holds(rc, rp, lanes, tainted)
        ties += int(near[0])
        held_n += int(held[0])
        if held[0]:
            continue
        err = float((g - c).abs().max())
        tol = 1e-2 * max(1.0, float(c.abs().max()))
        worst = max(worst, err / tol)
        if err > tol or int(g.argmax()) != int(c.argmax()):
            raise AssertionError(f"depth-2 parity step {step}: max |err| {err:.3e} "
                                 f"(tol {tol:.3e}), argmax {int(g.argmax())} vs {int(c.argmax())}")
    log(f"  depth-2 logits, card vs CPU plain: {steps + 1} steps ({prompt}-token prefill) agree"
        + (f" ({held_n} held for routing: {ties} output rows routed near a tie, the rest "
           "reached by a row that routed differently)" if cfg.is_moe else "")
        + f"; worst err/tol {worst:.3f}")
    return dict(steps=steps + 1, prompt=prompt, routing_near_ties=ties, routing_held=held_n,
                worst_err_over_tol=worst)


def phase_cli(dev) -> None:
    """Phase 5: the CLI modes as subprocesses on a small fp8 checkpoint
    (bf16 cache) and a small int4 one (e5m2 cache, `-C fp8`); a completion
    on a small fp8 MoE checkpoint (4 experts, 2 active)."""
    from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config
    out_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    completion = ["-m", "completion", "-i", "hello world", "-n", "16", "-t", "0"]
    modes = (completion, ["-m", "perplexity", "-i", "hello world this is a test of the key"],
             ["-m", "passkey", "-n", "4", "-s", "1"])
    for wdt, moe, extra, runs in (("fp8", {}, [], modes), ("int4", {}, ["-C", "fp8"], modes),
                                  ("fp8", dict(n_experts=4, n_experts_active=2), [],
                                   (completion,))):
        path = os.path.join(out_dir, f"tiny_{wdt}{'_moe' if moe else ''}.yalm")
        synth_checkpoint(path, tiny_config(dim=256, hidden_dim=512, head_dim=128,
                                           n_heads=4, n_kv_heads=2, vocab_size=512,
                                           max_seq_len=512, rotary_dim=128,
                                           weight_dtype=wdt, **moe), seed=3)
        cli = [sys.executable, "-m", "yalm_tpu_torch.cli", path, *extra]
        if moe:
            wdt += " MoE"
        for args in runs:
            t0 = time.perf_counter()
            res = subprocess.run(cli + args, cwd=ROOT, capture_output=True, timeout=600)
            # random weights emit arbitrary bytes (byte-fallback tokens)
            out, err = (res.stdout.decode(errors="replace"), res.stderr.decode(errors="replace"))
            tail = (out + err).strip().splitlines()[-3:]
            log(f"  cli {wdt} {' '.join(extra)} {args[1]}: rc {res.returncode} in "
                f"{time.perf_counter() - t0:.1f} s: " + " | ".join(tail))
            if res.returncode != 0:
                raise AssertionError(f"cli {wdt} {args[1]} failed:\n{out}\n{err}")


def weight_gb(fw) -> float:
    return sum(t.numel() * t.element_size() for t in (
        fw.embed, fw.wqkv, fw.wo, fw.w13, fw.w2, fw.lm_head, fw.moegate) if t is not None) / 1e9


def log_token_bytes(cfg, fw, ceiling: float) -> None:
    """The weight bytes one decode token streams, and their bound (an MoE
    token reads k of its E experts and the router)."""
    sc = fw.scales
    frac = cfg.n_experts_active / cfg.n_experts if cfg.is_moe else 1.0
    nbytes = lambda t: 0 if t is None else t.numel() * t.element_size()  # noqa: E731
    wbytes = (sum(nbytes(t) for t in (fw.wqkv, fw.wo, fw.lm_head, fw.moegate))
              + frac * (nbytes(fw.w13) + nbytes(fw.w2)) + 4 * cfg.dim * (2 * cfg.n_layers + 1)
              + (sum(nbytes(getattr(sc, f)) for f in ("wqkv", "wo", "lm_head", "moegate"))
                 + frac * (nbytes(sc.w13) + nbytes(sc.w2)) if sc is not None else 0))
    log(f"decode-token weight bytes ({cfg.weight_dtype}) {wbytes / 1e9:.3f} GB: bound "
        f"{wbytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s, "
        f"{wbytes / ceiling * 1e3:.3f} ms at the measured ceiling")


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    try:
        from yalm_tpu_torch.ops.cuda import _build
    except ImportError:
        print("chip_smoke: run from the root of the repository", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    # streaming ceiling: a 2 GiB device-to-device copy (read + write)
    src = torch.empty(1 << 31, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ceiling = 2 * src.numel() / (Bench.time_ms(lambda r: dst.copy_(src), reps=10) * 1e-3)
    del src, dst
    log(f"streaming ceiling (2 GiB D2D copy): {ceiling / 1e9:.1f} GB/s")

    cfg = mistral7b()
    t0 = time.perf_counter()
    fw = synth_fast_weights(cfg, dev, seed=0)
    torch.cuda.synchronize()
    log(f"Mistral-7B-shape fp8 weights made on the card in {time.perf_counter() - t0:.1f} s "
        f"({weight_gb(fw):.2f} GB)")
    log_token_bytes(cfg, fw, ceiling)

    bench = Bench(ceiling)
    summary: dict = {"fp8": {}, "int4": {}, "moe_fp8": {}, "moe_int4": {}}
    # the Mistral-7B serving runs at depth 8 (PERF.md keeps their 32-layer
    # numbers), so the Mixtral phases fit the time limit
    lay_s = MISTRAL_SERVING_LAYERS
    with phase("phase 2 (fp8 path): kernels vs plain versions on the card"):
        phase_kernels(bench, cfg, fw, dev)
    with phase("phase 3 (fp8 path, bf16 cache): the slice end to end (32 layers)"):
        summary["fp8"]["serve"] = phase_serve(cfg, fw, dev, torch.bfloat16, "fp8")
    cfg_s, fw_s = dataclasses.replace(cfg, n_layers=lay_s), first_layers(fw, lay_s)
    with phase(f"phase 3 (fp8 path, bf16 cache): continuous-batching serving, batch 16 "
               f"({lay_s} layers)"):
        summary["fp8"]["batched"] = phase_serving(cfg_s, fw_s, dev, torch.bfloat16, "fp8",
                                                  n_requests=24, http=4)
    with phase(f"phase 3 (fp8 path, bf16 pool): paged serving, batch 16, {PAGED_PAGES} pages "
               f"of 256 ({lay_s} layers)"):
        summary["fp8"]["paged"] = phase_serving(cfg_s, fw_s, dev, torch.bfloat16, "fp8",
                                                n_requests=24, http=4,
                                                paged_pages=PAGED_PAGES)
    with phase("phase 4 (fp8 path): depth-2 parity, card vs CPU"):
        summary["fp8"]["parity"] = phase_parity(cfg, fw, dev, torch.bfloat16)
        summary["fp8"]["batched_parity"] = phase_batched_parity(cfg, fw, dev, torch.bfloat16)
        summary["fp8"]["paged_parity"] = phase_batched_parity(cfg, fw, dev, torch.bfloat16,
                                                              paged=True)
    del fw, fw_s
    torch.cuda.empty_cache()

    cfg4 = mistral7b(weight_dtype="int4")
    t0 = time.perf_counter()
    fw4 = synth_int4_weights(cfg4, dev, seed=1)
    torch.cuda.synchronize()
    log(f"Mistral-7B-shape int4 weights made on the card in {time.perf_counter() - t0:.1f} s")
    log_token_bytes(cfg4, fw4, ceiling)
    e5 = torch.float8_e5m2
    with phase("phase 2 (int4 path): int4 kernels and the e5m2 cache vs plain versions"):
        phase_kernels4(bench, cfg4, fw4, dev)
    with phase("phase 3 (int4 path, e5m2 cache): the slice end to end (32 layers)"):
        summary["int4"]["serve"] = phase_serve(cfg4, fw4, dev, e5, "int4")
    cfg_s, fw_s = dataclasses.replace(cfg4, n_layers=lay_s), first_layers(fw4, lay_s)
    with phase("phase 3 (int4 path, e5m2 cache): continuous-batching serving, batch 16 "
               f"({lay_s} layers)"):
        summary["int4"]["batched"] = phase_serving(cfg_s, fw_s, dev, e5, "int4",
                                                   n_requests=20, http=0)
    with phase(f"phase 3 (int4 path, e5m2 pool): paged serving, batch 16, {PAGED_PAGES} pages "
               f"of 256 ({lay_s} layers)"):
        summary["int4"]["paged"] = phase_serving(cfg_s, fw_s, dev, e5, "int4", n_requests=20,
                                                 http=0, paged_pages=PAGED_PAGES)
    with phase("phase 4 (int4 path, e5m2 cache): depth-2 parity, card vs CPU"):
        summary["int4"]["parity"] = phase_parity(cfg4, fw4, dev, e5)
        summary["int4"]["batched_parity"] = phase_batched_parity(cfg4, fw4, dev, e5)
        summary["int4"]["paged_parity"] = phase_batched_parity(cfg4, fw4, dev, e5, paged=True)
    del fw4, fw_s
    torch.cuda.empty_cache()

    # Mixtral-8x7B shapes at full depth: the routed experts (K10, K11)
    for path, wdt, kv, seed in (("moe_fp8", "fp8", torch.bfloat16, 2),
                                ("moe_int4", "int4", e5, 3)):
        cfgm = mixtral8x7b(weight_dtype=wdt)
        t0 = time.perf_counter()
        fwm = synth_moe_weights(cfgm, dev, seed=seed)
        torch.cuda.synchronize()
        log(f"Mixtral-8x7B-shape {wdt} weights made on the card in "
            f"{time.perf_counter() - t0:.1f} s ({weight_gb(fwm):.2f} GB)")
        log_token_bytes(cfgm, fwm, ceiling)
        cache = "bf16 cache" if kv == torch.bfloat16 else "e5m2 cache"
        with phase(f"phase 2 ({path} path): {routed_names(fwm)} vs plain versions"):
            phase_moe_kernels(bench, cfgm, fwm, dev)
        with phase(f"phase 3 ({path} path, {cache}): single stream (32 layers)"):
            summary[path]["serve"] = phase_serve(cfgm, fwm, dev, kv, path,
                                                 MOE_SERVE_REQUESTS[path])
        if path == "moe_fp8":
            with phase(f"phase 3 ({path} path, {cache}): continuous-batching serving, "
                       "batch 16 (32 layers)"):
                summary[path]["batched"] = phase_serving(
                    cfgm, fwm, dev, kv, path, n_requests=17, http=2, prompts=(64, 1024),
                    new=(32, 64), past_window=False)
        else:
            with phase(f"phase 3 ({path} path, e5m2 pool): paged serving, batch 16, "
                       f"{PAGED_PAGES} pages of 256 (32 layers)"):
                summary[path]["paged"] = phase_serving(
                    cfgm, fwm, dev, kv, path, n_requests=17, http=0,
                    paged_pages=PAGED_PAGES, prompts=(256, 1536), new=(32, 64),
                    past_window=False)
        with phase(f"phase 4 ({path} path, {cache}): depth-2 parity, card vs CPU"):
            # a 32-token prefill and 8 lanes of 8-row chunks: the CPU's plain
            # experts set the pace (PERF.md: at 64 tokens the int4 path stands
            # at 1.11x the tolerance, from its e5m2 cache's rounding)
            summary[path]["parity"] = phase_parity(cfgm, fwm, dev, kv, prompt=32)
            key = "batched_parity" if path == "moe_fp8" else "paged_parity"
            summary[path][key] = phase_batched_parity(cfgm, fwm, dev, kv,
                                                      paged=path == "moe_int4", B=8, T=8)
        del fwm
        torch.cuda.empty_cache()
    with phase("phase 5: CLI modes"):
        phase_cli(dev)

    # name -> (source, the TPU function of the same name it replaces); the
    # composite wrappers launch csrc/gemv.cu and csrc/attention.cu
    sources = {"gemv": ("csrc/gemv.cu", "yalm_tpu/ops/pallas/gemv.py:81"),
               "gemv_l": ("csrc/gemv.cu", "yalm_tpu/ops/pallas/gemv.py:148"),
               "gemm_l": ("csrc/gemm.cu", "yalm_tpu/ops/pallas/gemv.py:426"),
               "attend_step_l": ("csrc/attention.cu", "yalm_tpu/ops/pallas/attention.py:808"),
               "attn_block_l": ("ops/cuda/block.py", "yalm_tpu/ops/pallas/block.py:554"),
               "ffn_l": ("ops/cuda/ffn.py", "yalm_tpu/ops/pallas/ffn.py:332"),
               "gemv4_l": ("csrc/gemv.cu", "yalm_tpu/ops/pallas/gemv.py:776"),
               "gemm4_l": ("csrc/gemm.cu", "yalm_tpu/ops/pallas/gemv.py:600"),
               "attn_block4_l": ("ops/cuda/block.py", "yalm_tpu/ops/pallas/block.py:365"),
               "ffn4_l": ("ops/cuda/ffn.py", "yalm_tpu/ops/pallas/ffn.py:227"),
               "attend_step_batched_l": ("csrc/attention.cu",
                                         "yalm_tpu/ops/pallas/attention.py:538"),
               "attend_step_paged_l": ("csrc/attention.cu",
                                       "yalm_tpu/ops/pallas/attention.py:1093"),
               "ffn_l_gemm": ("ops/cuda/ffn.py", "yalm_tpu/ops/pallas/ffn.py:332"),
               "ffn4_l_gemm": ("ops/cuda/ffn.py", "yalm_tpu/ops/pallas/ffn.py:227"),
               "gemv_le": ("csrc/gemv.cu", "yalm_tpu/ops/pallas/gemv.py:265"),
               "gemm_le": ("csrc/gemm.cu", "yalm_tpu/ops/pallas/gemv.py:344"),
               "gemm4_le": ("csrc/gemm.cu", "yalm_tpu/ops/pallas/gemv.py:688"),
               "gemv4_le": ("csrc/gemv.cu", "yalm_tpu/ops/pallas/gemv.py:768")}
    kernels = []
    for r in bench.rows:
        if not r["json"]:
            continue
        src, rep = sources[r["name"]]
        kernels.append(dict(
            name=r["name"], route="cuda", source="yalm_tpu_torch/" + src, replaces=rep,
            path=r["path"], case=r["case"], run=r["run"],
            launches=summary[r["path"]][r["run"]]["launches"][r["name"]],
            max_abs_err=r["max_abs_err"], max_err=r["max_abs_err"], tol=r["tol"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            ceiling_ms=r["ceiling_ms"]))
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"cases": bench.rows, "footprint": bench.footprint, **summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
