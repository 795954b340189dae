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
   every kernel's launch count over that run, and a torch.profiler window
   of 16 decode steps after the first request (context 280) and after the
   window request (the full window: the attention's share at long context);
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
   then speculation (`phase_spec`, depth 8 (PERF.md keeps the 32-layer
   runs; phase 7 needs the time), K 4, 200-token prompts, 64
   new tokens): plain greedy decode beside a self-draft (a second Engine
   over the same weights), a 2-layer draft from another seed (greedy and
   T 0.8), prompt lookup on a 50-token pattern repeated 4 times and 4
   Medusa heads from a seed (greedy and T 0.8), every token of a greedy
   stream the argmax of the plain step fed the same prefix or within twice
   the tolerance of its maximum (a near-tie, counted), every self-draft
   rejection at a near-tie, with
   rounds, acceptances, decode rates, the device time of one verify sweep
   and of the draft's K+1 steps, and launch counts; and speculation
   through ServingEngine at depth 8 (`phase_spec_serving`: 16 requests of
   64-512 prompt tokens and 48 new, half sampled, through the plain
   scheduler, prompt lookup, a self-draft over a paged pool of 65 pages of
   256, and Medusa heads; greedy tokens held to the plain tick fed the
   same prefix by the same rule, K8's launches in the draft ticks, K9's in
   paged subticks); then tree-attention Medusa (`phase_tree`, 32 layers):
   the chain tree (1, 1, 1, 1) through verify_tree_fast_batched beside the
   chain sweep on a copy of a random cache (logits to the tolerance; after
   scatter_tree_rows layer 0's K/V rows bit for bit the chain sweep's), a
   Scheduler at batch 8 with 4 random heads and the tree (4, 2): 8 requests
   of 200 + 48 tokens, two at T 0.8, every greedy token held to the plain
   tick fed the same prefix; one lane whose rank-2 candidates are the plain
   stream's next tokens on the tree (2, 2, 2, 2), which must accept to the
   full depth; and one tree sweep's device and wall time and launches;
4. the parity oracle (`phase_oracle`, Mistral-7B widths, 2 layers): the
   oracle (bf16 compute) against the kernels on the same weights, a
   64-token prefill and 8 decode steps to the tolerance; a config the
   attention kernel refuses (`phase_oracle_mqa`: one kv head) takes the oracle under
   fast="auto" and completes a request through the Engine and the
   Scheduler; debug capture (`phase_capture`): the kernel path's capture
   map against the oracle's under diff_captures' 6e-2, and (int4 path)
   capture refusing packed int4; then
   the same model at depth 2 on the card against the plain versions on the
   CPU: a 64-token prefill and 8 teacher-forced decode steps; then the
   batched path: one batched chunk sweep and 8 teacher-forced ticks over 16
   lanes at mixed positions (ring lanes, write-masked lanes), the argmax
   held on every lane whose top two logits lie more than twice the
   tolerance apart; and the same over a paged pool through shuffled tables;
   on the fp8 path also one speculative verify sweep (with_hidden) over 16
   lanes of K+1 rows at mixed positions, dense and paged (logits and
   hidden rows to the tolerance); the CPU's side widens each weight once
   (`widened_once`: the plain versions' f32 weights kept across steps);
then phases 2-4 again for the int4 path (packed int4 layer weights with
group scales, int8 embedding and LM head, fp8-e5m2 KV cache: the
configuration of `bench.py`'s defaults), after the fp8 weights are freed,
with a lighter serving run (20 requests, no HTTP);
then phases 2-4 for Mixtral-8x7B shapes at depth 32 (8 experts, 2 active),
fp8 (bf16 cache) and then int4 (int8 router, e5m2 cache): the routed-expert
kernels (K10 gemv_le/gemm_le, K11 gemv4_le/gemm4_le) against their plain
versions and bit for bit against the dense kernels on the copied expert
stack; single stream (200+64 greedy, 1500+32 sampled, 4090+16; on fp8 also the ring
follow-up) with the routed GEMV launched 128 times per decode
token and the routed GEMM 512 times per prefill chunk, and one decode step
free of host synchronization (the routed ids stay on the card); serving at
depth 8 (PERF.md keeps the 32-layer runs), fp8 on the dense cache (17
requests of 64-1024 tokens and 2 over HTTP) and int4 on a paged pool of 65
pages of 256 (17 requests of 256-1536 tokens, which must preempt), the
routed GEMM 2 x 8 x depth times per tick; depth-2 parity as above, the
batched one over 8 lanes of 8-row chunks (the CPU's plain experts set the
pace); a row may route differently on the card only where the CPU's router
logits near-tie, and the outputs such a row or a near-tie reaches are held
to nothing and counted; on an e5m2 cache, the outputs past the tolerance
that a cache byte rounded across a boundary reaches are held and counted
(phase_parity);
then phases 2-4 for Gemma3-12B (bf16 cache) and Gemma2-9B (window 8192,
e5m2 cache) at full width, fp8 weights (phase 3 at depth 8, which holds
both layer kinds; PERF.md keeps the full-depth runs of 48 and 42): the
tied 256k-row LM-head GEMV, the gelu GLU on the GEMV and the GEMM route,
and K2, K8 and K9 in the path's form (sliding window 1024 + Gemma3's local
rope; sliding window 4096 + Gemma2's softcap 50) in the linear and the ring
regime; single stream (Gemma3 200+64, 1500+64 sampled, 4090+16 and the ring
follow-up; Gemma2 200+64, 6000+32 sampled, 8190+16 and the ring follow-up)
on the unfused decode route, with the attention launches counted by form;
serving (Gemma3 dense, 17 requests of 64-2048 tokens and 2 over HTTP;
Gemma2 paged from 65 pages of 256, 17 requests of 256-1536 tokens, which
must preempt); depth-2 parity with layer_sliding (1, 0) and a window of 48;
K12 (attend_one_l, which no model path runs) at Mistral-7B shapes on each
cache type in phase 2 of the fp8 and the int4 path. K2 and K12 run split
over the slots (two launches per call); every K2 case in phase 2 also
times the same function on the one-block-per-kv-head design they replaced
(`attend_step_v1` with one lane), in the same run, and the fp8 path
adds a lane one slot past a chunk boundary and one whose kv_pos lies in a
middle chunk. K3 attn_block_l and K6 attn_block4_l run as one cooperative
launch each (csrc/block.cu); phase 2 (`phase_block`) holds each at kv_len
1000 and at the full window against its plain version and bit for bit
against the four launches it replaced (`four_launches`: the wqkv GEMV, the
split's two passes, the wo GEMV), whose time is the row's old design,
counts the kernels of 20 calls in a torch.profiler trace and the nodes of
one call's CUDA graph (one kernel per call), replays that graph, and times
the host's work per call of both designs; `split_sass` holds attention.cu's and gemv.cu's SASS against
another checkout's. K1 gemm_l, K10 gemm_le and, on packed int4 weights, K5
gemm4_l and K11 gemm4_le run on the wgmma gemm_kernel (round_rows_bf16
first; `gemm_plan`); every case of theirs in phase 2 (K1 and K5 also at
the tick's M 16 for w2 and wo, with F.linear beside it) also times the
mma.sync design it replaced (gemm_kernel_v1 or gemm4_kernel_v1, through
`gemm_v1`) in the same run, as do K4's and K7's GEMM-route rows (64
rows), and phase 2 checks `cuobjdump -sass` for HGMMA in every gemm_kernel instance,
the int4 ones among them. K8 attend_step_batched_l and K9
attend_step_paged_l run split over the window's slots (`lanes_split_plan`,
two launches per call); every K8/K9 case in phase 2 also times the
one-block-per-(kv head, lane) design it replaced (attend_step_kernel through
`attend_step_v1`) in the same run, and the fp8 and int4 paths' phase 2
each run one K8 and one K9 call under torch's sync debug mode (no host
sync) and replay each captured in a CUDA graph after rewriting its lanes
tensor in place; phase
3's tick profiles report K8/K9's device time per tick. K4 ffn_l and K7
ffn4_l run as one cooperative launch each for 1-16 rows (csrc/ffn.cu: the
w13 GEMV's slices, then the w2 GEMV's, each w2 item waiting for the GLU
columns it reads); phase 2 (`phase_ffn_rows`) holds it at 1, 4, 8 and 16
rows (and Gemma's gelu, the tp=2 shard's hidden slice, a pipeline stage's
8 rows) against its plain version, bit for bit against the two GEMV
launches it replaced up to 8 rows (`ffn_old`; past 8 the GEMM route's five
launches), whose time is the row's old design, reads its GLU rows back
from the scratch, and at 1 and 16 rows prints its timeline and the host's
time per call and replays it from a CUDA graph (one kernel node); phase 3
reruns each dense path's first greedy request on the launches it replaced
(the same tokens and logits, bit for bit); phase 3's tick profiles require
one ffn launch a layer and none on the GEMM route. Every GEMV (K1
gemv/gemv_l, K5 gemv4_l, K10 gemv_le, K11 gemv4_le, and K3/K6's and
K4/K7's GEMV phases) runs on gemv_kernel's body: mma.sync with x's rows as the n of 8,
the weight stream started before the rmsnorm prologue, K split by
`gemv_plan` where the grid starves; phase 2 times it at every shape a
decode step launches (`phase_gemv`: one row, and eight on w13 and w2)
beside the design it replaced (gemv_kernel_v1 through `gemv_v1`, same
run) and F.linear, and checks `cuobjdump -sass` for HMMA in every
gemv_kernel instance; phase 3's decode profiles split the step's device
time into the GEMV without and with the GLU pair;
5. the CLI's completion, perplexity and passkey modes on a small fp8
   checkpoint and on a small int4 checkpoint with `-C fp8`, and a
   completion on a small fp8 MoE checkpoint, as seven subprocesses started
   together;
6. converted checkpoints from disk (`phase_checkpoint`): the native library
   (`yalm_tpu_torch/native`) built with g++; HF-layout directories of
   random BF16 weights in two safetensors shards with the llama_style
   fixture tokenizer, Mistral-7B widths at depth 2 converted to fp8 (in
   process) and int4 (`python -m yalm_tpu_torch.convert`), Mixtral-8x7B
   widths at depth 1 to fp8; each file read by the native and the
   pure-Python reader (the same bytes; each one's open + load onto the
   card timed), served by Engine.from_checkpoint with the native tokenizer
   (golden HF ids, a 4 KB text equal to the Python BPE's), a 64-token
   prompt + 32 greedy tokens (TTFT, decode rate, the path's launches), the
   32 held to the CPU plain path of the same file; a CLI completion on the
   fp8 file;
7. meshes (`yalm_tpu_torch/parallel`): (a) a world of one NCCL rank --
   an all-reduce, then Mistral-7B fp8 at 32 layers through Engine(mesh=),
   200 + 64 greedy tokens held to the single-device engine on the same
   weights (tokens by the near-tie rule, logits within 1e-2 of max(1,
   max|logit|)), the per-step wall and device time of both
   (profile_decode), and the CLI with -M 1,1,1 under torch.distributed.run;
   (b) two gloo ranks spawned on the one card (`mesh_rank`, a timeout on
   the world): Mistral-7B fp8 and int4 with tp=2 at depth 4, Mixtral-8x7B
   fp8 with ep=2 at depth 4 and int4 at depth 2, each
   200 + 64 greedy tokens, both ranks' the same; then at depth 4 the dense
   scheduler at batch 16 on dp=2 and on tp=2 (20 requests of 64-512 prompt
   tokens and 16-32 new, half sampled at top-k 40), and the paged
   scheduler (13 pages of 256 a dp group: each group must preempt) on
   dp=2 and tp=2 (fp8, bf16 pool) and int4 on an e5m2 pool at tp=2,
   prompt lookup on a paged pool, a 2-layer draft (the target's first two
   layers) and chain Medusa (4 random heads), each at tp=2 with K 4
   (every group's pages free at the
   end; the rounds, accepted proposals, preemptions and resumes logged),
   every logits row a token was drawn from recorded on the leader
   (`recorded_rows`: a verify sweep's rows 0..a of a lane); each run held to
   the single-device engine fed the same tokens (`mesh_rows_hold`): every
   token its own row's argmax or within its top k, the logits within 1e-2
   of max(1, max|logit|) of the single device's or, where a dense run's
   summation orders part further, no further from the f32 parity oracle
   (same cache type) than 1.25 x the single device's own distance to it;
   (c) the kernels at those runs' shard shapes against their plain
   versions, timed, in the kernels line with path "mesh" (K9 over 4 kv
   heads of a bf16 and an e5m2 pool, the wqkv GEMM at a verify sweep's 80
   rows among them);
8. the rest of `parallel/` on two gloo ranks sharing the card
   (`mesh8_rank`, a world of its own): (a) the ring prefill at sp=2 on
   Mistral-7B widths, 4 layers, fp8 over T 4096 (the whole window) and
   int4 with an e5m2 cache over T 1024, timed beside one device's
   prefill_fast of the same prompt in one call, the window cache placed
   from both ranks' rows and 16 greedy decode steps from it, the logits
   held to one device's (its own rows placed the same way, fed the same
   tokens) by phase 7's near-tie rule, and the placed rows, layer by
   layer, no further from the f32 oracle's than 1.25x one device's; (b)
   the pipelined tick at pp=2, 16 lanes (random history, the ring regime
   among them, two idle lanes), fp8 on bf16 and int4 on e5m2, 8 ticks each
   held to the single-device tick fed the same tokens by the same rule
   (the oracle lane by lane for the writing lanes), and the stages' caches
   likewise; (c) the sharded parity
   oracle (Engine(mesh=, fast=False), f32) at tp=2 on Mistral widths, 2
   layers, and ep=2 on Mixtral widths, 1 layer, 64 + 8 greedy tokens held
   to the single-device oracle within 1e-4; (d) the kernels at the ring's
   and the pipeline's shapes (the wqkv GEMM at T/sp rows, K5 at 512, K8
   over B/pp lanes, K4 at B/pp rows, the LM head GEMM at 16) in the
   kernels line with path "mesh", each launched in its run.
The int4 path (e5m2 cache) and the Mixtral fp8 path also run
the tree phase at depths 2 and 8 (`phase_tree_path`); debug capture also
runs on Mixtral fp8 (K10's gemv_le), Gemma3 (bf16 cache) and Gemma2 (e5m2
cache), and the oracle on Gemma2's e5m2 cache; at 32 layers, and on
Mixtral, the tree serving run's greedy tokens are put to the f32 oracle
fed the same tokens (`oracle_rows`, `oracle_compare`): over every token,
and at each token past a near-tie of the plain tick or after a routing
difference past a near-tie, with each lane's last token as a control;
on Mixtral the chunk path, the tick and the oracle are routed as the run
(`gate_calls(force=...)`, `routing_check`).

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
import math
import os
import shutil
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


def gemma3_12b(n_layers: int = 48):
    """Gemma3-12B's text shapes, bench.py:129-145's configuration exactly:
    a 5:1 sliding pattern with a 1024 window, dual per-layer rope (global
    theta 1e6 / 8, local 1e4), qk-norm, sandwich norms, gelu, a tied head,
    window 4096; fp8-e5m2 weights."""
    from yalm_tpu_torch.config import ModelConfig
    return ModelConfig(dim=3840, hidden_dim=15360, head_dim=256, n_layers=n_layers, n_heads=16,
                       n_kv_heads=8, vocab_size=262144, max_seq_len=4096, bos_token_id=2,
                       eos_token_id=1, rope_theta=1e6, rotary_dim=256, norm_eps=1e-6,
                       act_type="gelu", weight_dtype="fp8", embed_scale=3840.0 ** 0.5,
                       tie_word_embeddings=True, has_post_norms=True, has_qk_norm=True,
                       sliding_window=1024,
                       layer_sliding=tuple(0 if (i + 1) % 6 == 0 else 1 for i in range(n_layers)),
                       rope_scale=("gemma3", 8.0, 10000.0))


def gemma2_9b(n_layers: int = 42):
    """Gemma2-9B's shapes, bench.py:114-128's configuration at the public
    model's 8192-token window (at bench.py's 4096 the 4096-slot sliding
    window would never be live, bench.py:410): 1:1 sliding layers, the
    attention softcap 50 and the final softcap 30, sandwich norms, gelu, a
    tied head; fp8-e5m2 weights."""
    from yalm_tpu_torch.config import ModelConfig
    return ModelConfig(dim=3584, hidden_dim=14336, head_dim=256, n_layers=n_layers, n_heads=16,
                       n_kv_heads=8, vocab_size=256128, max_seq_len=8192, bos_token_id=2,
                       eos_token_id=1, rope_theta=10000.0, rotary_dim=256, norm_eps=1e-6,
                       act_type="gelu", weight_dtype="fp8", embed_scale=3584.0 ** 0.5,
                       has_post_norms=True, attn_softcap=50.0, final_softcap=30.0,
                       sliding_window=4096, tie_word_embeddings=True,
                       layer_sliding=tuple(1 if i % 2 == 0 else 0 for i in range(n_layers)))


def with_layers(cfg, n: int, **kw):
    """cfg at depth n (its first n layers' sliding flags), other fields as kw."""
    return dataclasses.replace(cfg, n_layers=n, layer_sliding=cfg.layer_sliding[:n], **kw)


def synth_moe_weights(cfg, device, seed: int):
    """Random weights of an MoE cfg on the card: synth_fast_weights (fp8) or
    synth_int4_weights (int4, an int8 router with per-row scales)."""
    return (synth_int4_weights if cfg.weight_dtype == "int4" else synth_fast_weights)(
        cfg, device, seed)


def synth_fast_weights(cfg, device, seed: int):
    """Random fp8-e5m2 weights (std 0.02) made on the card in the decode
    layout, chunk by chunk so no full-size bf16 temporary exists; an MoE cfg
    gets its expert stacks (L, E, ...) and the router (L, E, dim); a tied
    cfg shares the embedding as its head; qk-norm and sandwich-norm cfgs get
    their norms, 1 + 0.1 * N(0, 1), drawn last."""
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
    fw = FastWeights(
        embed=mk(cfg.vocab_size, d), rms_att=ones(L, d), rms_ffn=ones(L, d),
        wqkv=mk(L, cfg.q_dim + 2 * cfg.kv_dim, d), wo=mk(L, d, cfg.q_dim),
        w13=mk(L, *E, 2 * h, d), w2=mk(L, *E, d, h), final_norm=ones(d),
        lm_head=None, moegate=None)
    fw.lm_head = fw.embed if cfg.tie_word_embeddings else mk(cfg.vocab_size, d)
    fw.moegate = mk(L, *E, d) if E else None

    def norm(n):
        return 1 + 0.1 * torch.randn(L, n, generator=gen, device=device)
    if cfg.has_qk_norm:
        fw.qnorm, fw.knorm = norm(cfg.head_dim), norm(cfg.head_dim)
    if cfg.has_post_norms:
        fw.pa, fw.pf = norm(d), norm(d)
    return fw


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


def dequant4(w4, gs, dtype=None):
    """bf16 (or `dtype`) copies of packed int4 layers (L, N, K/2) with
    scales (L, G, N): the weights the library call (F.linear) is timed on,
    and in f32 the parity oracle's."""
    import torch
    L, N, Kp = w4.shape
    G = gs.shape[1]
    p = w4.reshape(L, N, G, -1)
    q = torch.cat([(p & 0xF).to(torch.bfloat16) - 8, (p >> 4).to(torch.bfloat16) - 8], -1)
    return (q.float() * gs.transpose(1, 2)[..., None]).reshape(L, N, 2 * Kp).to(
        dtype or torch.bfloat16)


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
             library=None, bytes_=0, flops=0, json_row=False, run="serve", bf16_out=False,
             old=None):
        """One case; `run` names the main-path run whose launch counts the
        kernels line reports for it ("serve": phase 3's Engine requests,
        "batched": the serving run). old: the same function on the design
        it replaced, timed in the same run (K2: the one-block-per-kv-head
        kernel, attend_step_v1 with one lane; K8/K9: the same kernel over
        the lanes). bf16_out: the outputs are bf16 values
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
                   old_ms=self.time_ms(old) if old else None,
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
            f"bound {row['bound_ms']:.4f} ({row['bound_by']})"
            + (f" old design {row['old_ms']:.4f}" if old else ""))
        if not (finite and err_ok):
            raise AssertionError(f"{name} {label}: kernel disagrees with its plain "
                                 f"version (max |err| {err:.3e} > tol {tol:.3e}, finite={finite})")


def gemm_v1(x, w_all, layer, scale=None, *, expert=None, residual=None, glu_act=None):
    """K1/K10's function on gemm_kernel_v1, or for packed int4 weights
    K5/K11's on gemm4_kernel_v1: the mma.sync designs gemm_kernel replaced
    (synchronous loads, f32 X rounded in every block, no split), for the
    same-run timing: csrc/gemm.cu's yt_gemm_v1 / yt_gemm4_v1, which no
    wrapper of the port reaches. Arguments as launch_gemm's."""
    import ctypes
    import torch
    from yalm_tpu_torch.ops.cuda import _build as B
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.int4 import int4_group
    P, I = ctypes.c_void_p, ctypes.c_int
    L, N, Kw, E, e_host, e_dev = G._addressing(w_all, layer, expert, "gemm_v1")
    M = x.shape[0]
    y = torch.empty((M, N // 2 if glu_act else N), dtype=torch.float32, device=x.device)
    glu, act = 1 if glu_act else 0, 1 if glu_act == "gelu" else 0
    if G.is_int4(w_all):
        fn = B.lib().yt_gemm4_v1
        fn.argtypes = [P, I, I, I, P, I, I, I, P, I, P, P, P, I, I, P]
        lead = (B.ptr(w_all), layer, E, e_host, B.ptr(e_dev), N, 2 * Kw, int4_group(2 * Kw))
    else:
        fn = B.lib().yt_gemm_v1
        fn.argtypes = [I, P, I, I, I, P, I, I, P, I, P, P, P, I, I, P]
        lead = (B.WTYPE[w_all.dtype], B.ptr(w_all), layer, E, e_host, B.ptr(e_dev), N, Kw)
    fn.restype = I
    B.check(fn(*lead, B.ptr(x), M, B.ptr(scale), B.ptr(residual), B.ptr(y), glu, act,
               B.stream_ptr()), "gemm_v1")
    return y


def gemv_v1(x, w_all, layer, *, expert=None, norm_w=None, norm_eps=1e-5, scale=None,
            residual=None, glu_act=None):
    """The GEMV's function on gemv_kernel_v1, the design gemv_kernel
    replaced (one warp per row, x staged whole before the first weight
    load, a scalar widening and FMA per weight), for the same-run timing:
    csrc/gemv.cu's yt_gemv_v1, which no wrapper of the port reaches.
    Arguments as launch_gemv's."""
    import ctypes
    import torch
    from yalm_tpu_torch.ops.cuda import _build as B
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.int4 import int4_group
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _, N, Kw, E, e_host, e_dev = G._addressing(w_all, layer, expert, "gemv_v1")
    int4 = G.is_int4(w_all)
    K = 2 * Kw if int4 else Kw
    x2 = x.reshape(-1, K)
    y = torch.empty((x2.shape[0], N // 2 if glu_act else N), dtype=torch.float32,
                    device=x.device)
    fn = B.lib().yt_gemv_v1
    fn.argtypes = [I, P, I, I, I, P, I, I, P, I, P, Fl, P, P, I, P, Fl, P, P, I, I, P]
    fn.restype = I
    B.check(fn(B.WTYPE[w_all.dtype], B.ptr(w_all), layer, E, e_host, B.ptr(e_dev), N, K,
               B.ptr(x2), x2.shape[0], B.ptr(norm_w), norm_eps, None if int4 else B.ptr(scale),
               B.ptr(scale) if int4 else None, int4_group(K) if int4 else 0, None, 0.0,
               B.ptr(residual), B.ptr(y), 1 if glu_act else 0, 1 if glu_act == "gelu" else 0,
               B.stream_ptr()), "gemv_v1")
    return y.reshape(*x.shape[:-1], y.shape[-1])


def on_old_gemm(fn):
    """fn() with the FFN's GEMM route on gemm_v1 (K4's or K7's many-row route
    on the design gemm_kernel replaced), for the same-run time."""
    from yalm_tpu_torch.ops.cuda import ffn
    saved = ffn.launch_gemm
    ffn.launch_gemm = lambda count, x, w_all, layer, scale=None, **kw: gemm_v1(
        x, w_all, layer, scale, **kw)
    try:
        return fn()
    finally:
        ffn.launch_gemm = saved


def check_hgmma() -> None:
    """cuobjdump -sass of the built library: every instance of the new
    gemm_kernel (the 8 of packed int4 among them) issues HGMMA (wgmma), and
    gemm_kernel_v1 and gemm4_kernel_v1 none."""
    from yalm_tpu_torch.ops.cuda import _build as B
    tool = os.path.join(os.path.dirname(B.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(B.build())], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts.setdefault(fn, 0)
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    new = {f: c for f, c in counts.items() if "11gemm_kernelI" in f}
    int4 = {f: c for f, c in new.items() if "11gemm_kernelILi4E" in f}
    old = {f: c for f, c in counts.items() if "14gemm_kernel_v1I" in f or "15gemm4_kernel_v1I" in f}
    if (len(new) != 48 or len(int4) != 8 or min(new.values()) < 1 or len(old) != 10
            or any(old.values())):
        raise AssertionError(f"cuobjdump: HGMMA in the gemm_kernel instances {new}, "
                             f"in gemm_kernel_v1 and gemm4_kernel_v1 {old}")
    log(f"  cuobjdump -sass: HGMMA in all {len(new)} gemm_kernel instances "
        f"({min(new.values())}-{max(new.values())} each; the {len(int4)} int4 ones "
        f"{min(int4.values())}-{max(int4.values())}), none in the {len(old)} of "
        f"gemm_kernel_v1 and gemm4_kernel_v1")


def check_hmma() -> None:
    """cuobjdump -sass of the built library: every instance of the new
    gemv_kernel (the 2 of packed int4 among them) issues HMMA (mma.sync on
    the tensor cores), and none of gemv_kernel_v1's does."""
    from yalm_tpu_torch.ops.cuda import _build as B
    tool = os.path.join(os.path.dirname(B.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(B.build())], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts.setdefault(fn, 0)
        elif fn and "HMMA" in line:
            counts[fn] += 1
    new = {f: c for f, c in counts.items() if "11gemv_kernelI" in f}
    int4 = {f: c for f, c in new.items() if "11gemv_kernelILi4E" in f}
    old = {f: c for f, c in counts.items() if "14gemv_kernel_v1I" in f}
    if len(new) != 10 or len(int4) != 2 or min(new.values()) < 1 or len(old) != 30 or any(
            old.values()):
        raise AssertionError(f"cuobjdump: HMMA in the gemv_kernel instances {new}, in "
                             f"gemv_kernel_v1 {old}")
    log(f"  cuobjdump -sass: HMMA in all {len(new)} gemv_kernel instances "
        f"({min(new.values())}-{max(new.values())} each; the {len(int4)} int4 ones "
        f"{min(int4.values())}-{max(int4.values())}), none in the {len(old)} of gemv_kernel_v1")


def gemv_rows_plain(x, w_all, layer, scale=None, *, norm_w=None, norm_eps=1e-5, residual=None,
                    glu_act=None):
    """The plain version of a GEMV launch on nb rows of x (ops/cuda/ffn.py's
    GEMV route at nb 8): each row's rmsnorm, the projection, then the
    residual or the GLU pair."""
    import torch
    from yalm_tpu_torch.ops.cuda import gemv as G
    xv = x.float()
    if norm_w is not None:
        xv = xv * torch.rsqrt(torch.mean(xv * xv, dim=-1, keepdim=True) + norm_eps)
        xv = xv * norm_w[layer].float()
    y = G.proj_plain(xv, w_all, layer, scale)
    if glu_act:
        return G.glu_plain(y, glu_act)
    return y if residual is None else y + residual


def phase_gemv(bench: Bench, cfg, fw, dev) -> None:
    """Phase 2's GEMV rows (csrc/gemv.cu's gemv_kernel), at every shape a
    decode step launches on bench.path, each with the design it replaced
    (gemv_kernel_v1 through gemv_v1) timed in the same run, the plain
    version, the bound and F.linear on bf16 (int4: dequantized bf16) copies
    of 4 layers: fp8 and int4 -- wqkv + rmsnorm, wo + residual, w13 +
    rmsnorm + GLU, w2 + residual (1 row, and 8 rows for w13 and w2: the
    GEMV phases of csrc/block.cu's and csrc/ffn.cu's one launch, which no
    path launches as a separate GEMV any more, so their rows stay out of
    the kernels line) and the LM head (e5m2; int8 + scale), on fp8 also
    wqkv on bf16 and int8 + scale weights; Mixtral -- the routed w13 +
    rmsnorm + GLU and w2 with the expert id on the card; the Gemmas -- the
    tied LM head and gemv_l's wqkv + rmsnorm and wo, which their unfused
    attention launches each layer. The dense rows also check that two calls give the same
    bits (split K sums its slices in a fixed order)."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.int4 import int4_group

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=dev) * scale

    L, d, h, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size
    sc = fw.scales
    int4 = G.is_int4(fw.w13)
    lay = lambda r: r % L  # noqa: E731  (cycle layers: each call streams cold weights)

    def wbytes(w, s):   # one matrix's weight bytes and its scales (per row or per group)
        return w.numel() * w.element_size() + (0 if s is None else 4 * s.numel())

    def bf16_copies(w, s):   # 4 layers (> the 50 MB L2): the library call's weights
        if G.is_int4(w):
            return dequant4(w[:4], s[:4])
        ww = w[:4].float() * s[:4, :, None] if s is not None else w[:4]
        return ww.to(torch.bfloat16)

    if bench.path in ("moe_fp8", "moe_int4"):
        E = cfg.n_experts
        ids = torch.randint(0, E, (64,), generator=gen, device=dev)
        ids_host = ids.tolist()
        gv, gemv_fn = ("gemv4_le", G.gemv4_le) if int4 else ("gemv_le", G.gemv_le)
        s13, s2 = (sc.w13, sc.w2) if sc else (None, None)
        x, xh = randn(d, scale=3.0), randn(h)
        norm = dict(norm_w=fw.rms_ffn, norm_eps=cfg.norm_eps)
        for nm, w, s, N, K, kw, xx in (("w13 + rmsnorm + GLU", fw.w13, s13, 2 * h, d,
                                        {**norm, "glu_act": "silu"}, x),
                                       ("w2", fw.w2, s2, d, h, {}, xh)):
            if int4:
                wl = [dequant4(w[r, ids_host[r]][None], s[r, ids_host[r]][None])[0]
                      for r in range(min(4, L))]
            else:
                wl = [w[r, ids_host[r]].to(torch.bfloat16) for r in range(min(4, L))]
            bench.case(gv, f"{nm}, id on the card ({N}x{K})",
                       gemv_fn(xx, w, 0, ids[0], s, **kw),
                       G.gemv_le_plain(xx, w, 0, ids_host[0], s, **kw), 2e-3,
                       kernel=lambda r, w=w, s=s, kw=kw, xx=xx: gemv_fn(xx, w, lay(r),
                                                                        ids[r % 64], s, **kw),
                       plain=lambda r, w=w, s=s, kw=kw, xx=xx: G.gemv_le_plain(
                           xx, w, lay(r), ids_host[r % 64], s, **kw),
                       library=lambda r, wl=wl, xx=xx: F.linear(xx.to(torch.bfloat16), wl[r % len(wl)]),
                       old=lambda r, w=w, s=s, kw=kw, xx=xx: gemv_v1(
                           xx, w, lay(r), expert=ids[r % 64], scale=s, **kw),
                       bytes_=wbytes(w[0, 0], None if s is None else s[0, 0]) + 4 * K
                       + (4 * K if kw else 0)
                       + 4 * (N // 2 if kw else N) + 8, flops=2 * N * K, json_row=bool(kw),
                       bf16_out=bool(kw))
            del wl
        return

    if bench.path in ("gemma3", "gemma2"):
        x = randn(d)
        lm_bf16 = fw.lm_head.to(torch.bfloat16)
        bench.case("gemv", f"lm_head e5m2 ({V}x{d}, tied)", G.gemv(x, fw.lm_head),
                   G.gemv_l_plain(x, fw.lm_head[None], 0), 2e-3,
                   kernel=lambda r: G.gemv(x, fw.lm_head),
                   plain=lambda r: G.gemv_l_plain(x, fw.lm_head[None], 0),
                   library=lambda r: F.linear(x.to(torch.bfloat16), lm_bf16),
                   old=lambda r: gemv_v1(x, fw.lm_head[None], 0),
                   bytes_=V * d + 4 * d + 4 * V, flops=2 * V * d, json_row=True)
        del lm_bf16
        # the unfused attention's GEMVs, as the decode step launches them
        # (gemv_l: wqkv with the rmsnorm prologue; wo without the residual,
        # which follows the post-norm)
        Nqkv, q_dim = cfg.q_dim + 2 * cfg.kv_dim, cfg.q_dim
        norm_att = dict(norm_w=fw.rms_att, norm_eps=cfg.norm_eps)
        for nm, w, N, K, kw, xx in (("wqkv + rmsnorm", fw.wqkv, Nqkv, d, norm_att,
                                     randn(d, scale=3.0)),
                                    ("wo", fw.wo, d, q_dim, {}, randn(q_dim))):
            wl = bf16_copies(w, None)
            plan = G.gemv_plan(1, N, K, False, 0, w.element_size())
            bench.case("gemv_l", f"{nm} e5m2 ({N}x{K}), split {plan.split}",
                       G.gemv_l(xx, w, 0, **kw), G.gemv_l_plain(xx, w, 0, **kw), 2e-3,
                       kernel=lambda r, w=w, kw=kw, xx=xx: G.gemv_l(xx, w, lay(r), **kw),
                       plain=lambda r, w=w, kw=kw, xx=xx: G.gemv_l_plain(xx, w, lay(r), **kw),
                       library=lambda r, xx=xx, wl=wl: F.linear(xx.to(torch.bfloat16),
                                                                wl[r % len(wl)]),
                       old=lambda r, w=w, kw=kw, xx=xx: gemv_v1(xx, w, lay(r), **kw),
                       bytes_=wbytes(w[0], None) + 4 * K + (4 * K if kw else 0) + 4 * N,
                       flops=2 * N * K, json_row=bool(kw))
            del wl
        return

    # the dense paths: Mistral-7B fp8 (e5m2) or int4 (packed, int8 head)
    Nqkv, q_dim = cfg.q_dim + 2 * cfg.kv_dim, cfg.q_dim
    x = randn(d)
    hs = sc.lm_head if int4 else None
    lm_bf16 = bf16_copies(fw.lm_head[None], None if hs is None else hs[None])[0]
    wt = "int8 + scale" if int4 else "e5m2"
    bench.case("gemv", f"lm_head {wt} ({V}x{d})", G.gemv(x, fw.lm_head, hs),
               G.gemv_l_plain(x, fw.lm_head[None], 0, scale=None if hs is None else hs[None]),
               2e-3,
               kernel=lambda r: G.gemv(x, fw.lm_head, hs),
               plain=lambda r: G.gemv_l_plain(x, fw.lm_head[None], 0,
                                              scale=None if hs is None else hs[None]),
               library=lambda r: F.linear(x.to(torch.bfloat16), lm_bf16),
               old=lambda r: gemv_v1(x, fw.lm_head[None], 0,
                                     scale=None if hs is None else hs[None]),
               bytes_=V * d + 4 * d + 4 * V + (4 * V if int4 else 0), flops=2 * V * d,
               json_row=True)
    del lm_bf16
    name = "gemv4_l" if int4 else "gemv_l"
    s = (lambda f: getattr(sc, f)) if int4 else (lambda f: None)
    norm_att = dict(norm_w=fw.rms_att, norm_eps=cfg.norm_eps)
    norm_ffn = dict(norm_w=fw.rms_ffn, norm_eps=cfg.norm_eps)
    cases = [(1, "wqkv + rmsnorm", fw.wqkv, "wqkv", Nqkv, d, norm_att),
             (1, "wo + residual", fw.wo, "wo", d, q_dim, {"residual": True}),
             (1, "w13 + rmsnorm + GLU", fw.w13, "w13", 2 * h, d, {**norm_ffn, "glu_act": "silu"}),
             (1, "w2 + residual", fw.w2, "w2", d, h, {"residual": True}),
             (8, "w13 + rmsnorm + GLU", fw.w13, "w13", 2 * h, d, {**norm_ffn, "glu_act": "silu"}),
             (8, "w2 + residual", fw.w2, "w2", d, h, {"residual": True})]
    for nb, nm, w, field, N, K, kw in cases:
        glu = "glu_act" in kw
        n_out = N // 2 if glu else N
        xx = randn(nb, K, scale=3.0) if "norm_w" in kw else randn(nb, K)
        kw = dict(kw)
        if kw.pop("residual", False):
            kw["residual"] = randn(nb, n_out)
        wl = bf16_copies(w, s(field))
        plan = G.gemv_plan(nb, N, K, glu, int4_group(K) if int4 else 0, 1)

        def kern(r, w=w, field=field, kw=kw, xx=xx):
            return G.launch_gemv(name, xx, w, lay(r), scale=s(field), **kw)

        def plain(r, w=w, field=field, kw=kw, xx=xx):
            return gemv_rows_plain(xx, w, lay(r), s(field), **kw)
        got = kern(0)
        if not torch.equal(got, kern(0)):   # the split's fixed-order sum
            raise AssertionError(f"{name} nb={nb} {nm}: two calls differ in their bits")
        bench.case(name, f"nb={nb} {nm} ({N}x{K}), split {plan.split}", got, plain(0), 2e-3,
                   kernel=kern, plain=plain,
                   library=lambda r, xx=xx, wl=wl: F.linear(xx.to(torch.bfloat16), wl[r % len(wl)]),
                   old=lambda r, w=w, field=field, kw=kw, xx=xx: gemv_v1(
                       xx, w, lay(r), scale=s(field), **kw),
                   bytes_=wbytes(w[0], None if s(field) is None else s(field)[0]) + 4 * nb * K
                   + (4 * K if "norm_w" in kw else 0)
                   + 4 * nb * n_out * (2 if "residual" in kw else 1),
                   flops=2 * nb * N * K, bf16_out=glu)
        del wl
    if int4:
        return
    # wqkv on the other weight types the kernel takes (the GEMV's prologue)
    x = randn(d, scale=3.0)
    w_bf16 = randn(2, Nqkv, d, scale=0.02).to(torch.bfloat16)
    nw2 = fw.rms_att[:2].contiguous()
    bench.case("gemv_l", f"wqkv bf16 + rmsnorm ({Nqkv}x{d})",
               G.gemv_l(x, w_bf16, 1, norm_w=nw2), G.gemv_l_plain(x, w_bf16, 1, norm_w=nw2),
               2e-3,
               kernel=lambda r: G.gemv_l(x, w_bf16, r % 2, norm_w=nw2),
               plain=lambda r: G.gemv_l_plain(x, w_bf16, r % 2, norm_w=nw2),
               old=lambda r: gemv_v1(x, w_bf16, r % 2, norm_w=nw2),
               bytes_=2 * Nqkv * d + 8 * d + 4 * Nqkv, flops=2 * Nqkv * d)
    del w_bf16
    w_i8 = torch.randint(-127, 128, (2, Nqkv, d), generator=gen, device=dev, dtype=torch.int8)
    s_i8 = torch.rand(2, Nqkv, generator=gen, device=dev) * 1e-3 + 1e-4
    bench.case("gemv_l", f"wqkv int8 + scale ({Nqkv}x{d})",
               G.gemv_l(x, w_i8, 1, scale=s_i8), G.gemv_l_plain(x, w_i8, 1, scale=s_i8), 2e-3,
               kernel=lambda r: G.gemv_l(x, w_i8, r % 2, scale=s_i8),
               plain=lambda r: G.gemv_l_plain(x, w_i8, r % 2, scale=s_i8),
               old=lambda r: gemv_v1(x, w_i8, r % 2, scale=s_i8),
               bytes_=Nqkv * d + 4 * d + 8 * Nqkv, flops=2 * Nqkv * d)
    del w_i8, s_i8


def v1_smem_bytes(qpk: int, D: int, S: int) -> int:
    """Shared memory of csrc/attention.cu's attend_step_kernel (the v1
    design) for a window of S slots: q, every score (one tile's, 64, when
    the scores go to global scratch), one K/V tile."""
    words = qpk * (D + 2) + S * qpk
    return (words + 3) // 4 * 16 + 64 * (D + 8) * 2


def attend_step_v1(q, k_new, v_new, k_all, v_all, layer, lanes, tables=None, *, kv_sinks, theta,
                   rotary_dim, softcap=0.0, win=None, alt=None):
    """K8's function, or with `tables` K9's (k_all/v_all a page pool), on
    the design the lanes split replaced (one block per (kv head, lane)),
    for the same-run timing: csrc/attention.cu's
    yt_attend_step_batched_v1 / yt_attend_step_paged_v1, which no wrapper
    of the port reaches. Arguments as attend_step_batched's /
    attend_step_paged's."""
    import ctypes
    import math
    import torch
    from yalm_tpu_torch.ops.core import rope_mscale
    from yalm_tpu_torch.ops.cuda import _build as B
    from yalm_tpu_torch.ops.cuda import attention as A
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    Bn, Hk, qpk, D = q.shape
    L, S = k_all.shape[1], k_all.shape[2]
    if tables is not None:
        n_pages, L, page = k_all.shape[:3]
        nblk = tables.shape[1]
        S = page * nblk
    qc, kn, vn = (t.float().contiguous() for t in (q, k_new, v_new))
    freq = A._freq_table(theta, D, rotary_dim, str(q.device), bool(alt))
    out = torch.empty((Bn, Hk, qpk, D), dtype=torch.float32, device=q.device)
    scores = (None if v1_smem_bytes(qpk, D, S) <= 227 * 1024 else
              torch.empty((Bn, Hk, S, qpk), dtype=torch.float32, device=q.device))
    w = A._win_arg(win, S, "attend_step_v1")
    lead = (B.WTYPE[k_all.dtype], B.ptr(qc), B.ptr(kn), B.ptr(vn), B.ptr(k_all), B.ptr(v_all),
            B.ptr(freq), rope_mscale(theta), 1.0 / math.sqrt(D), B.ptr(out), B.ptr(scores),
            B.ptr(lanes))
    if tables is None:
        fn = B.lib().yt_attend_step_batched_v1
        fn.argtypes = [I, P, P, P, P, P, P, F, F, P, P, P, I, I, I, I, I, I, I, I, F, I, P]
        rest = (Bn, L, layer, S, Hk, qpk, D)
    else:
        fn = B.lib().yt_attend_step_paged_v1
        fn.argtypes = [I, P, P, P, P, P, P, F, F, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, I, P]
        rest = (B.ptr(tables), Bn, n_pages, L, layer, page, nblk, Hk, qpk, D)
    fn.restype = I
    B.check(fn(*lead, *rest, kv_sinks, float(softcap), w, B.stream_ptr()), "attend_step_v1")
    return out


def one_block_per_head(k_all, v_all, kv_pos, kv_len, kv_sink, pos, rope):
    """K2's function on the design it replaced (one block per kv head), for
    the same-run timing: attend_step_v1 with one lane over a (1, L, S, Hk,
    D) view of the cache. Returns fn(q, kn, vn, layer)."""
    from yalm_tpu_torch.ops.cuda import attention as A
    lanes = A.lane_scalars([kv_pos], [kv_len], [kv_sink], [pos], [1], S=k_all.shape[1],
                           kv_sinks=rope["kv_sinks"], device=k_all.device)
    return lambda q, kn, vn, layer: attend_step_v1(
        q[None], kn[None], vn[None], k_all[None], v_all[None], layer, lanes, **rope)


def four_launches(x, norm_w, wqkv_all, wo_all, k_all, v_all, layer, kv_pos, kv_len, kv_sink,
                  pos, *, n_heads, kv_sinks, theta, rotary_dim, norm_eps, qkv_clip=math.inf,
                  bqkv_all=None, add_residual=True, scale_qkv=None, scale_o=None):
    """K3/K6's function as PR 7-12 ran it (the design csrc/block.cu's one
    launch replaced), for the same-run time and the bit-for-bit check: the
    wqkv GEMV, the attention split's two launches and the wo GEMV, through
    their wrappers (launch_gemv + launch_attend_step + launch_gemv)."""
    from yalm_tpu_torch.ops.cuda import attention as A
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.cuda.block import _split_qkv
    Hk, D = k_all.shape[2], k_all.shape[3]
    name = "gemv4_l" if G.is_int4(wqkv_all) else "gemv_l"
    qkv = G.launch_gemv(name, x, wqkv_all, layer, norm_w=norm_w, norm_eps=norm_eps,
                        scale=scale_qkv, bias=bqkv_all, clip=qkv_clip)
    q, k, v = _split_qkv(qkv, n_heads, Hk, D)
    mix = A.launch_attend_step(q, k, v, k_all, v_all, layer, kv_pos, kv_len, kv_sink, pos,
                               kv_sinks=kv_sinks, theta=theta, rotary_dim=rotary_dim)
    return G.launch_gemv(name, mix.reshape(-1), wo_all, layer, scale=scale_o,
                         residual=x if add_residual else None)


def ffn_old(x, norm_w, w13_all, w2_all, layer, scale13=None, scale2=None, *, norm_eps, act,
            add_residual=True):
    """K4/K7's function for 1-16 rows on the design csrc/ffn.cu's one
    launch replaced, for the same-run time and the
    bit-for-bit check: up to 8 rows two GEMV launches (the w13 GEMV with the
    rmsnorm prologue and the GLU pair, then the w2 GEMV with scale +
    residual, launch_gemv twice), past 8 the GEMM route's five launches
    (launch_ffn_gemm)."""
    from yalm_tpu_torch.ops.cuda import ffn as FF
    from yalm_tpu_torch.ops.cuda import gemv as G
    x2 = x.float().reshape(-1, x.shape[-1]).contiguous()
    res = x2 if add_residual else None
    if x2.shape[0] > 8:
        out = FF.launch_ffn_gemm(x2, norm_w, w13_all, w2_all, layer, scale13, scale2,
                                 norm_eps=norm_eps, act=act, residual=res)
        return out.reshape(x.shape)
    name = "gemv4_l" if G.is_int4(w13_all) else "gemv_l"
    h = G.launch_gemv(name, x2, w13_all, layer, norm_w=norm_w, norm_eps=norm_eps,
                      scale=scale13, glu_act=act)
    return G.launch_gemv(name, h, w2_all, layer, scale=scale2, residual=res).reshape(x.shape)


def kernels_per_call(fn, calls: int = 20) -> list:
    """The names of the device kernels `calls` calls of fn launch, from a
    torch.profiler trace of those calls alone (CUDA activity only), taken
    after a pause inside the trace: after phase 3's long traces, the
    tracer missed the first kernels of a new trace (all of one call's, and
    6 of 20 calls', in two runs). A trace that holds fewer than `calls`
    kernels is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names: list = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.5)   # the tracer up before the first call
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= calls:
            break
    return names


def host_us_per_call(fn, n: int = 1000) -> float:
    """The host's time per call of fn over n calls with no sync between
    them (the wrapper's checks, plan, buffers and launches), in us."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def graph_node_types(graph) -> list | None:
    """The driver's node types of a captured torch.cuda.CUDAGraph (made
    with keep_graph=True; 0 is a kernel node), or None where torch does
    not keep the graph."""
    import ctypes
    try:
        handle = ctypes.c_void_p(graph.raw_cuda_graph())
    except (AttributeError, RuntimeError):
        return None
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        return None
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        types.append(t.value)
    return types


def block_capture(fn, x) -> tuple:
    """One call of fn (an attn_block or an ffn on x) captured in a CUDA graph and
    replayed after x is rewritten in place, against the uncaptured call on
    the new x: ("replays bit for bit" or the error of a refused capture,
    the graph's node types: [0] is one kernel node). A replay that
    differs raises."""
    import torch
    fn()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        graph = torch.cuda.CUDAGraph()
    try:   # on the warmed stream: its scratch and counters exist, none is made in the graph
        with torch.cuda.graph(graph, stream=s):
            out = fn()
    except RuntimeError as e:
        torch.cuda.synchronize()
        return f"capture refused: {e}", None
    types = graph_node_types(graph)
    x.mul_(-0.5)
    graph.replay()
    torch.cuda.synchronize()
    replayed = out.clone()
    if not torch.equal(replayed, fn()):
        raise AssertionError("the graph's replay differs from the uncaptured call")
    return "replays bit for bit", types


BLOCK_MARKS = ("A done", "B1 ready", "B1 done", "B2 ready", "B2 done", "C ready", "end")


def block_timeline(name, args, blk, reps: int = 9) -> dict:
    """Where one call of csrc/block.cu's kernel spends its time, from its
    blocks' stamps (the card's ns timer, block.cu's stamp()): for each mark
    of BLOCK_MARKS, the us from the first block's entry to the last block
    reaching it (phase A's items done; its first pass-1 item's inputs
    ready; its pass-1 items done; and so on to the end of phase C), the
    median over `reps` calls on args(layer) for cycling layers."""
    import torch
    from yalm_tpu_torch.ops.cuda.block import BLOCK_GRID, launch_attn_block
    marks = []
    for r in range(reps):
        st = torch.zeros(BLOCK_GRID, 8, dtype=torch.int64, device=args(0)[0].device)
        launch_attn_block(name, *args(r), stamps=st, **blk)
        torch.cuda.synchronize()
        st = st[st[:, 0] != 0].double() / 1e3   # us, the launched blocks
        marks.append([float(st[:, k].max() - st[:, 0].min()) for k in range(1, 8)])
    return {m: statistics.median(x[k] for x in marks) for k, m in enumerate(BLOCK_MARKS)}


def phase_block(bench: Bench, cfg, fw, dev, cache, sc=None) -> None:
    """K3 attn_block_l (fp8 path) or K6 attn_block4_l (int4 path, sc: the
    group scales): csrc/block.cu's one cooperative launch at kv_len 1000 and
    at the full window (the ring with sinks), without the residual, against
    its plain version (2e-3) and bit for bit against the four-launch
    sequence it replaced (output and the written K and V rows), whose time
    is the row's old design, and its timeline (block_timeline); then the
    kernels of 20 calls from a profiler trace and one call's CUDA graph
    (one kernel per call), its replay, and the host time per call of both
    designs (1000 calls, no sync)."""
    import torch
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.cuda.block import attn_block4_l, attn_block_l, attn_block_plain
    from yalm_tpu_torch.ops.int4 import int4_group

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    L, d, S = cfg.n_layers, cfg.dim, cfg.max_seq_len
    Nqkv, q_dim = cfg.q_dim + 2 * cfg.kv_dim, cfg.q_dim
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    int4 = G.is_int4(fw.wqkv)
    name, fn = ("attn_block4_l", attn_block4_l) if int4 else ("attn_block_l", attn_block_l)
    lay = lambda r: r % L  # noqa: E731
    blk = dict(n_heads=Hq, norm_eps=cfg.norm_eps, add_residual=False, kv_sinks=2,
               theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    if int4:
        blk.update(scale_qkv=sc.wqkv, scale_o=sc.wo)

    def wbytes(N, K):   # one layer's weights (packed int4: with their group scales)
        return N * K // 2 + 4 * (K // int4_group(K)) * N if int4 else N * K * fw.wqkv.element_size()
    cache_elem = cache.k.element_size()
    for pos in (999, 6000):
        kv_sink = 2 if pos >= S else 0
        kv_pos = kv_sink + (pos - kv_sink) % (S - kv_sink)
        kv_len = min(pos + 1, S)
        x = torch.randn(d, generator=gen, device=dev) * 3.0
        args = lambda l, x=x, kp=kv_pos, kl=kv_len, ks=kv_sink, p=pos: (  # noqa: E731
            x, fw.rms_att, fw.wqkv, fw.wo, cache.k, cache.v, l, kp, kl, ks, p)
        old = four_launches(*args(5), **blk)
        rows_old = [c[5, kv_pos].clone() for c in (cache.k, cache.v)]
        got = fn(*args(5), **blk)
        torch.cuda.synchronize()
        rows = [c[5, kv_pos] for c in (cache.k, cache.v)]
        if not (torch.equal(got, old) and all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                                              for a, b in zip(rows, rows_old))):
            raise AssertionError(f"{name} pos {pos}: the one launch differs from the four "
                                 f"launches (max |out diff| {float((got - old).abs().max())})")
        want = attn_block_plain(*args(5), **blk)
        bench.case(name, f"kv_len={kv_len}" + (" ring+sinks" if kv_sink else "")
                   + f" {cache.k.dtype}".replace("torch.", "") + " cache, one launch",
                   got, want, 2e-3,
                   kernel=lambda r, a=args: fn(*a(lay(r)), **blk),
                   plain=lambda r, a=args: attn_block_plain(*a(lay(r)), **blk),
                   old=lambda r, a=args: four_launches(*a(lay(r)), **blk),
                   bytes_=wbytes(Nqkv, d) + wbytes(d, q_dim) + 2 * kv_len * Hk * D * cache_elem
                   + 12 * d,
                   flops=2 * (Nqkv * d + d * q_dim) + 4 * kv_len * Hq * D, json_row=pos == 999)
        bench.rows[-1]["timeline_us"] = tl = block_timeline(
            name, lambda r, a=args: a(lay(r)), blk)
        log(f"  {name} pos {pos}: the one launch equals the four launches bit for bit "
            f"(output and the written K and V rows); timeline (us): "
            + ", ".join(f"{k} {v:.2f}" for k, v in tl.items()))
    row = bench.rows[-1]
    # one kernel per call: a captured call's graph holds one kernel node,
    # and every kernel in a profiler trace of 20 calls is attn_block_kernel,
    # 20 of them. A trace with no device event at all is the profiler's
    # failure (twice in the int4 path after phase 3's traces), not a count:
    # the graph's node count decides then, and the log says so.
    ks = kernels_per_call(lambda: fn(*args(5), **blk))
    row["graph"], nodes = block_capture(lambda: fn(*args(5), **blk), x)
    row["profiler_kernels"], row["graph_nodes"] = len(ks), nodes
    if (any("attn_block_kernel" not in k for k in ks) or len(ks) > 20
            or (nodes is not None and nodes != [0]) or (nodes is None and len(ks) != 20)):
        raise AssertionError(f"{name}: 20 calls launched {len(ks)} kernels "
                             f"{sorted(set(ks))}; one call's graph nodes {nodes}")
    if not ks:
        log(f"  {name}: the profiler recorded no device event in three traces; one call's "
            f"CUDA graph holds node types {nodes} (0: a kernel)")
    row["host_us"] = host_us_per_call(lambda: fn(*args(5), **blk))
    row["old_host_us"] = host_us_per_call(lambda: four_launches(*args(5), **blk))
    log(f"  {name}: a profiler trace of 20 calls holds {len(ks)} kernels, each "
        f"{ks[0] if ks else '-'}; "
        f"one call's CUDA graph: node types {nodes} (0: a kernel), {row['graph']}; host "
        f"time per call {row['host_us']:.1f} us (four launches: {row['old_host_us']:.1f} us)")


def split_label(Hk, S, kv_pos, kv_len, kv_sink, win=0) -> str:
    """Where the one-lane split puts a K2 case (win: a window shorter than
    the cache's): its chunks, how many it reads, the chunk holding kv_pos."""
    from yalm_tpu_torch.ops.cuda.attention import chunk_live, split_plan
    lo, chunk, nsplit, skip = split_plan(kv_len, Hk, kv_pos=kv_pos, kv_sink=kv_sink, win=win)
    live = sum(not skip or chunk_live(lo + c * chunk, min(lo + (c + 1) * chunk, kv_len), kv_pos,
                                      kv_sink, S, win) for c in range(nsplit))
    return (f", {nsplit}x{chunk} from {lo} ({live} read), kv_pos in chunk "
            f"{(kv_pos - lo) // chunk}")


def phase_kernels(bench: Bench, cfg, fw, dev) -> None:
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.cuda import attention as A
    from yalm_tpu_torch.ops.cuda import gemv as G

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=dev) * scale

    L, d, h = cfg.n_layers, cfg.dim, cfg.hidden_dim
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

    # K1: gemv (LM head) and gemv_l at every decode shape, beside the old design
    phase_gemv(bench, cfg, fw, dev)

    # K1: gemm_l, the batched tick (M 16) and the prefill chunks; each case
    # also on gemm_kernel_v1, the design it replaced (old design)
    for B, nm, w, N, K in ((16, "wqkv", fw.wqkv, Nqkv, d), (16, "w13", fw.w13, 2 * h, d),
                           (16, "wo", fw.wo, d, q_dim), (16, "w2", fw.w2, d, h),
                           (64, "wqkv", fw.wqkv, Nqkv, d),
                           (256, "wqkv", fw.wqkv, Nqkv, d), (256, "wo", fw.wo, d, q_dim),
                           (256, "w2", fw.w2, d, h), (256, "w13", fw.w13, 2 * h, d)):
        xb = randn(B, K)
        wl = w[:4].to(torch.bfloat16)
        plan = G.gemm_plan(B, N, K)
        bench.case("gemm_l", f"B={B} {nm} e5m2 ({N}x{K}), mt {plan.mt} split {plan.split}",
                   G.gemm_l(xb, w, 0), G.gemm_l_plain(xb, w, 0), 2e-3,
                   kernel=lambda r, xb=xb, w=w: G.gemm_l(xb, w, lay(r)),
                   plain=lambda r, xb=xb, w=w: G.gemm_l_plain(xb, w, lay(r)),
                   library=lambda r, xb=xb, wl=wl: F.linear(xb.to(torch.bfloat16), wl[r % 4]),
                   old=lambda r, xb=xb, w=w: gemm_v1(xb, w, lay(r)),
                   bytes_=N * K + 4 * B * (K + N), flops=2 * B * N * K,
                   json_row=True, run="batched" if B == 16 else "serve")
        del wl
    # the rounding of X that every gemm_l launch begins with (w2's at M 256)
    xr = randn(256, h)
    got = G.launch_round_rows(xr)
    torch.cuda.synchronize()
    if not torch.equal(got.float(), G.bf16f(xr)):
        raise AssertionError("round_rows_bf16: not bf16f's bits")
    bench.case("round_rows_bf16", f"M=256 K={h}", got.float(), G.bf16f(xr), 2e-3,
               kernel=lambda r: G.launch_round_rows(xr), plain=lambda r: G.bf16f(xr),
               library=lambda r: xr.to(torch.bfloat16),
               bytes_=6 * 256 * h, json_row=True)
    check_hgmma()
    check_hmma()

    # K2: attend_step_l against a random full-size bf16 cache
    cache = KVCache.init(cfg, torch.bfloat16, dev)
    cache.k.copy_(torch.randn(cache.k.shape, generator=gen, device=dev, dtype=torch.bfloat16))
    cache.v.copy_(torch.randn(cache.v.shape, generator=gen, device=dev, dtype=torch.bfloat16))
    rope = dict(kv_sinks=2, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    S = cfg.max_seq_len
    # 3968: kv_len 3969, one slot past a chunk boundary (32 chunks of 128);
    # 5095 and 6000: the ring regime, kv_pos in a middle chunk
    for pos in (0, 999, 3968, 4095, 5095, 6000):
        kv_sink = 2 if pos >= S else 0
        kv_pos = kv_sink + (pos - kv_sink) % (S - kv_sink)
        kv_len = min(pos + 1, S)
        q, kn, vn = randn(Hk, Hq // Hk, D, scale=2.0), randn(Hk, D, scale=2.0), randn(Hk, D)
        sl = (3, kv_len, kv_sink, pos)
        plan = A.split_plan(kv_len, Hk, kv_pos=kv_pos, kv_sink=kv_sink)
        if pos == 3968 and (kv_len - plan.lo) % plan.chunk != 1:
            raise AssertionError(f"kv_len {kv_len} is not one slot past a chunk boundary: {plan}")
        old = one_block_per_head(cache.k, cache.v, kv_pos, kv_len, kv_sink, pos, rope)
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
                   f"kv_len={kv_len} pos={pos}" + (" ring+sinks" if kv_sink else "")
                   + split_label(Hk, S, kv_pos, kv_len, kv_sink),
                   got, want, 2e-3,
                   kernel=lambda r, a=(q, kn, vn), kp=kv_pos, s=sl[1:]: A.attend_step_l(
                       *a, cache.k, cache.v, lay(r), kp, *s, **rope),
                   plain=lambda r, a=(q, kn, vn), kp=kv_pos, s=sl[1:]: A.attend_step_plain(
                       *a, cache.k, cache.v, lay(r), kp, *s, **rope),
                   library=lambda r, qq=qq, kk=kk, vv=vv: F.scaled_dot_product_attention(
                       qq, kk[r % 4][None], vv[r % 4][None], enable_gqa=True),
                   old=lambda r, a=(q, kn, vn), o=old: o(*a, lay(r)),
                   bytes_=att_bytes, flops=4 * kv_len * Hq * D)
        del kk, vv

    # K2 at a 32768-slot window (Mistral-7B v0.2's): chunks of 1024 slots
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
    old = one_block_per_head(big.k, big.v, *sl, rope)
    bench.case("attend_step_l", f"kv_len={Sb} pos={pos}" + split_label(Hk, Sb, *sl[:3]), got,
               want, 2e-3,
               kernel=lambda r: A.attend_step_l(q, kn, vn, big.k, big.v, 0, *sl, **rope),
               plain=lambda r: A.attend_step_plain(q, kn, vn, big.k, big.v, 0, *sl, **rope),
               old=lambda r: old(q, kn, vn, 0),
               bytes_=2 * Sb * Hk * D * 2 + 4 * (2 * Hq * D + 2 * Hk * D),
               flops=4 * Sb * Hq * D)
    del big

    # K3: attn_block_l, one cooperative launch, beside the four launches
    phase_block(bench, cfg, fw, dev, cache)
    del cache

    # K4: ffn_l in one launch at 1, 4, 8 and 16 rows (the decode step, a
    # pipeline stage, the tick) beside the launches it replaced; at 64 rows
    # (a prefill chunk) the GEMM route
    phase_ffn_rows(bench, cfg, fw, dev, (1, 4, 8, 16, 64), {1: "serve", 16: "batched", 64: "batched"})
    phase_batched_attention(bench, cfg, dev, torch.bfloat16)
    phase_paged_attention(bench, cfg, dev, torch.bfloat16)
    phase_lanes_capture(cfg, dev, torch.bfloat16)
    phase_attend_one(bench, cfg, dev, torch.bfloat16)


def phase_kernels4(bench: Bench, cfg, fw, dev) -> None:
    """Phase 2 of the int4 path: the int4 kernels and the e5m2 cache
    against their plain versions at main-path shapes."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.cuda import attention as A
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.int4 import int4_group

    bench.path = "int4"
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=dev) * scale

    L, d, h = cfg.n_layers, cfg.dim, cfg.hidden_dim
    Nqkv, q_dim = cfg.q_dim + 2 * cfg.kv_dim, cfg.q_dim
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sc = fw.scales
    lay = lambda r: r % L  # noqa: E731

    def w4_bytes(N, K):   # packed weights and their group scales
        return N * K // 2 + 4 * (K // (512 if K % 512 == 0 else 256)) * N

    # K1: the int8 LM head of this path; K5: the int4 GEMV at every decode
    # shape, beside the old design
    phase_gemv(bench, cfg, fw, dev)

    # K5: gemm4_l on gemm_kernel (round_rows_bf16 first), the batched tick
    # (M 16) and the prefill chunks; each case also on gemm4_kernel_v1, the
    # design it replaced (old design)
    for nm, w, s, N, K in (("wqkv", fw.wqkv, sc.wqkv, Nqkv, d), ("w13", fw.w13, sc.w13, 2 * h, d),
                           ("w2", fw.w2, sc.w2, d, h), ("wo", fw.wo, sc.wo, d, q_dim)):
        wl = dequant4(w[:4], s[:4])
        for B in (16,) if nm == "wo" else (16, 64, 256):
            xb = randn(B, K)
            plan = G.gemm_plan(B, N, K, group=int4_group(K))
            bench.case("gemm4_l", f"B={B} {nm} ({N}x{K}), mt {plan.mt} split {plan.split}",
                       G.gemm4_l(xb, w, 0, s), G.gemm4_l_plain(xb, w, 0, s), 2e-3,
                       kernel=lambda r, xb=xb, w=w, s=s: G.gemm4_l(xb, w, lay(r), s),
                       plain=lambda r, xb=xb, w=w, s=s: G.gemm4_l_plain(xb, w, lay(r), s),
                       library=lambda r, xb=xb, wl=wl: F.linear(xb.to(torch.bfloat16), wl[r % 4]),
                       old=lambda r, xb=xb, w=w, s=s: gemm_v1(xb, w, lay(r), s),
                       bytes_=w4_bytes(N, K) + 4 * B * (K + N), flops=2 * B * N * K,
                       json_row=(B, nm) in ((256, "w13"), (16, "w2")),
                       run="batched" if B == 16 else "serve")
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
        old = one_block_per_head(cache.k, cache.v, kv_pos, kv_len, kv_sink, pos, rope)
        bench.case("attend_step_l",
                   f"e5m2 kv_len={kv_len} pos={pos}" + (" ring+sinks" if kv_sink else "")
                   + split_label(Hk, S, kv_pos, kv_len, kv_sink),
                   got, want, 2e-3,
                   kernel=lambda r, a=(q, kn, vn), kp=kv_pos, s=sl: A.attend_step_l(
                       *a, cache.k, cache.v, lay(r), kp, *s, **rope),
                   plain=lambda r, a=(q, kn, vn), kp=kv_pos, s=sl: A.attend_step_plain(
                       *a, cache.k, cache.v, lay(r), kp, *s, **rope),
                   library=lambda r, qq=qq, kk=kk, vv=vv: F.scaled_dot_product_attention(
                       qq, kk[r % 4][None], vv[r % 4][None], enable_gqa=True),
                   old=lambda r, a=(q, kn, vn), o=old: o(*a, lay(r)),
                   bytes_=2 * kv_len * Hk * D + 4 * (2 * Hq * D + 2 * Hk * D),
                   flops=4 * kv_len * Hq * D)
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
    old = one_block_per_head(big.k, big.v, *sl, rope)
    bench.case("attend_step_l", f"e5m2 kv_len={Sb} pos={pos}" + split_label(Hk, Sb, *sl[:3]), got,
               want, 2e-3,
               kernel=lambda r: A.attend_step_l(q, kn, vn, big.k, big.v, 0, *sl, **rope),
               plain=lambda r: A.attend_step_plain(q, kn, vn, big.k, big.v, 0, *sl, **rope),
               old=lambda r: old(q, kn, vn, 0),
               bytes_=2 * Sb * Hk * D + 4 * (2 * Hq * D + 2 * Hk * D), flops=4 * Sb * Hq * D)
    del big

    # K6: attn_block4_l, one cooperative launch, beside the four launches
    phase_block(bench, cfg, fw, dev, cache, sc)
    del cache

    # K7: ffn4_l in one launch at 1, 4, 8 and 16 rows, beside the launches
    # it replaced; at 64 rows the GEMM route
    phase_ffn_rows(bench, cfg, fw, dev, (1, 4, 8, 16, 64), {1: "serve", 16: "batched", 64: "batched"})
    phase_batched_attention(bench, cfg, dev, torch.float8_e5m2)
    phase_paged_attention(bench, cfg, dev, torch.float8_e5m2)
    phase_lanes_capture(cfg, dev, torch.float8_e5m2)
    phase_attend_one(bench, cfg, dev, torch.float8_e5m2)


def phase_attend_one(bench: Bench, cfg, dev, kv_dtype) -> None:
    """K12 (attend_one_l; no model path runs it, in the JAX package
    neither) at the model's shapes over a 4-layer cache of its window, every
    slot attended: against its plain version, the cache unwritten; the
    kernels line reports its launches in this phase; the library yardstick
    is SDPA."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.ops.cuda import attention as A

    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    Hq, Hk, D, S, L4 = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len, 4
    cache = KVCache.init(with_layers(cfg, L4), kv_dtype, dev)
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev, dtype=torch.bfloat16).to(kv_dtype))
    k0 = cache.k.clone()
    q = torch.randn(Hk, Hq // Hk, D, generator=gen, device=dev) * 2
    n0 = _build.LAUNCHES["attend_one_l"]
    want = A.attend_one_plain(q, cache.k, cache.v, 1, S)
    got = A.attend_one_l(q, cache.k, cache.v, 1, S)
    kk = [cache.k[l].transpose(0, 1).to(torch.bfloat16) for l in range(L4)]   # (Hk, S, D)
    vv = [cache.v[l].transpose(0, 1).to(torch.bfloat16) for l in range(L4)]
    qq = q.reshape(1, Hq, 1, D).to(torch.bfloat16)
    wd = "e5m2" if kv_dtype.itemsize == 1 else "bf16"
    bench.case("attend_one_l", f"{wd} kv_len={S}, {Hk}x{Hq // Hk} heads, D {D}", got, want,
               2e-3,
               kernel=lambda r: A.attend_one_l(q, cache.k, cache.v, r % L4, S),
               plain=lambda r: A.attend_one_plain(q, cache.k, cache.v, r % L4, S),
               library=lambda r: F.scaled_dot_product_attention(
                   qq, kk[r % L4][None], vv[r % L4][None], enable_gqa=True),
               bytes_=2 * S * Hk * D * kv_dtype.itemsize + 4 * 2 * Hq * D,
               flops=4 * S * Hq * D, json_row=True, run="phase2")
    torch.cuda.synchronize()
    bench.rows[-1]["phase2_launches"] = _build.LAUNCHES["attend_one_l"] - n0
    if not torch.equal(cache.k.view(torch.uint8), k0.view(torch.uint8)):
        raise AssertionError("attend_one_l wrote to the cache")
    log(f"  attend_one_l {wd}: {bench.rows[-1]['phase2_launches']} launches, the cache unwritten")


def phase_sliding_step(bench: Bench, cfg, dev, kv_dtype, form: dict) -> None:
    """K2 in the path's Gemma form on a 4-layer cache of its window: a lane
    past the sliding window in the linear regime (the kernel's tile loop
    starts at the window) and one in the ring regime (the sinks fall out of
    the window), against the plain version, the written rows byte for byte;
    the bound and SDPA's mask take the slots inside the window."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.cuda import attention as A

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    Hq, Hk, D, S, L4 = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len, 4
    cache = KVCache.init(with_layers(cfg, L4), kv_dtype, dev)
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev, dtype=torch.bfloat16).to(kv_dtype))
    rope = dict(kv_sinks=2, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim, **form)
    wd = "e5m2" if kv_dtype.itemsize == 1 else "bf16"
    bits = torch.uint8 if kv_dtype.itemsize == 1 else torch.int16
    for pos in (S - 100, S + 1903):
        kv_sink = 2 if pos >= S else 0
        kv_pos = kv_sink + (pos - kv_sink) % (S - kv_sink)
        kv_len = min(pos + 1, S)
        q = torch.randn(Hk, Hq // Hk, D, generator=gen, device=dev) * 2
        kn = torch.randn(Hk, D, generator=gen, device=dev) * 2
        vn = torch.randn(Hk, D, generator=gen, device=dev)
        sl = (kv_pos, kv_len, kv_sink, pos)
        k2, v2 = cache.k.clone(), cache.v.clone()
        want = A.attend_step_plain(q, kn, vn, k2, v2, 3, *sl, **rope)
        got = A.attend_step_l(q, kn, vn, cache.k, cache.v, 3, *sl, **rope)
        torch.cuda.synchronize()
        if not (torch.equal(cache.k.view(bits), k2.view(bits))
                and torch.equal(cache.v.view(bits), v2.view(bits))):
            raise AssertionError(f"attend_step_l {wd} pos {pos}: the written rows differ from "
                                 "the plain version's")
        del k2, v2
        mask, rows = window_rows(S, [kv_pos], [kv_len], [kv_sink], form.get("win"))
        mask = mask.to(dev)[:, None, None, :]
        kk = [cache.k[l].transpose(0, 1).to(torch.bfloat16) for l in range(L4)]
        vv = [cache.v[l].transpose(0, 1).to(torch.bfloat16) for l in range(L4)]
        qq = q.reshape(1, Hq, 1, D).to(torch.bfloat16)
        old = one_block_per_head(cache.k, cache.v, *sl, rope)
        bench.case("attend_step_l", f"{wd} kv_len={kv_len} pos={pos}"
                   + (" ring+sinks" if kv_sink else "") + form_label(form)
                   + split_label(Hk, S, kv_pos, kv_len, kv_sink, form.get("win") or 0), got,
                   want, 2e-3,
                   kernel=lambda r, a=(q, kn, vn), s=sl: A.attend_step_l(
                       *a, cache.k, cache.v, r % L4, *s, **rope),
                   plain=lambda r, a=(q, kn, vn), s=sl: A.attend_step_plain(
                       *a, cache.k, cache.v, r % L4, *s, **rope),
                   library=lambda r, qq=qq, kk=kk, vv=vv, m=mask: F.scaled_dot_product_attention(
                       qq, kk[r % L4][None], vv[r % L4][None], attn_mask=m, enable_gqa=True),
                   old=lambda r, a=(q, kn, vn), o=old: o(*a, r % L4),
                   bytes_=2 * rows * Hk * D * kv_dtype.itemsize + 4 * (2 * Hq * D + 2 * Hk * D),
                   flops=4 * rows * Hq * D, json_row=kv_sink > 0)
        del kk, vv
    log(f"  attend_step_l {wd}{form_label(form)}: written rows equal the plain version's byte "
        "for byte")


def phase_gemma_kernels(bench: Bench, cfg, fw, dev, kv_dtype, form: dict) -> None:
    """Phase 2 of a Gemma path at its shapes: the LM-head GEMV over the
    tied 256k-row embedding and the unfused attention's wqkv and wo GEMVs
    (phase_gemv); the gelu GLU in the one-launch FFN at one row
    and at 16 (phase_ffn_rows), its GLU rows against ops/core.gelu's to one
    bf16 ulp; K2, K8 (B 16) and K9 (B 16, shuffled pages of 256) in the
    path's Gemma form, linear and ring lanes, on the path's cache type."""
    phase_gemv(bench, cfg, fw, dev)   # the tied LM head, wqkv and wo, beside the old design
    # the gelu GLU in the one-launch FFN at one row and at the tick's 16;
    # the kernels line reports the serving run the path has (dense or paged)
    dense = bench.path == "gemma3"
    phase_ffn_rows(bench, cfg, fw, dev, (1, 16), {1: "serve", 16: "batched" if dense else "paged"})
    phase_sliding_step(bench, cfg, dev, kv_dtype, form)
    phase_batched_attention(bench, cfg, dev, kv_dtype, form, json=dense)
    phase_paged_attention(bench, cfg, dev, kv_dtype, form, depths=(4,), json=not dense)


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

    # the decode step's GEMV pair, ids on the card, beside the old design
    phase_gemv(bench, cfg, fw, dev)
    x, xh = randn(d, scale=3.0), randn(h)
    for M in (16, 256):
        for nm, w, s, N, K, kw in (("w13 + GLU", fw.w13, s13, 2 * h, d, glu),
                                   ("w2", fw.w2, s2, d, h, {})):
            xm = randn(M, K)
            wl = lib_copies(w, s)
            # also on gemm_kernel_v1 / gemm4_kernel_v1, the design it replaced
            old = (lambda r, xm=xm, w=w, s=s, kw=kw: gemm_v1(xm, w, lay(r), s, expert=r % E,
                                                              **kw))
            plan = G.gemm_plan(M, N, K, bool(kw), int4_group(K) if int4 else 0)
            bench.case(gm, f"M={M} {nm} ({N}x{K}), mt {plan.mt} split {plan.split}",
                       gemm_fn(xm, w, 0, 1, s, **kw), G.gemm_le_plain(xm, w, 0, 1, s, **kw), 2e-3,
                       kernel=lambda r, xm=xm, w=w, s=s, kw=kw: gemm_fn(xm, w, lay(r), r % E, s,
                                                                        **kw),
                       plain=lambda r, xm=xm, w=w, s=s, kw=kw: G.gemm_le_plain(
                           xm, w, lay(r), r % E, s, **kw),
                       library=lambda r, xm=xm, wl=wl: F.linear(xm.to(torch.bfloat16), wl[r % 4]),
                       old=old, bytes_=wbytes(N, K) + 4 * M * (K + (N // 2 if kw else N)),
                       flops=2 * M * N * K, json_row=bool(kw) or not int4 or M == 16,
                       bf16_out=bool(kw),
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
    bad = torch.tensor([E, -1, -2], device=dev)
    outs = [gemv_fn(x, fw.w13, 3, bad[0], s13, **norm, **glu), gemv_fn(xh, fw.w2, 3, bad[2], s2),
            gemm_fn(xm16, fw.w13, 3, bad[0], s13, **glu), gemm_fn(hm, fw.w2, 3, bad[1], s2)]
    skip = gemv_fn(xh, fw.w2, 3, bad[1], s2)   # -1: another rank's expert on a mesh
    torch.cuda.synchronize()
    if not (all(bool(torch.isnan(o).all()) for o in outs) and bool((skip == 0).all())):
        raise AssertionError(f"{gv}/{gm}: an expert id outside [0, {E}) did not give NaN "
                             "(the GEMV: zeros for -1)")
    log(f"  {gv}/{gm}: bit for bit as {gv[:-1]}/{gm[:-1]} on the copied stack of layer "
        f"{L - 1}, expert {E - 1} (GEMV w13 + norm + GLU, w2; GEMM M 16 and 256), "
        f"ids from the card; NaN for ids {E}, -2 (GEMV) and -1 (GEMM), the GEMV's zeros "
        "for -1")


def glu_holds(name: str, glu, ref) -> float:
    """A GLU epilogue's output against the plain GLU: every value a bf16
    value, each within 2e-3 of max(1, max|ref|) or one bf16 ulp of its
    reference (where the f32 values straddle a rounding boundary). Raises
    otherwise; returns the max |err|."""
    import torch
    from yalm_tpu_torch.ops.cuda import gemv as G
    torch.cuda.synchronize()
    if not torch.equal(glu, G.bf16f(glu)):
        raise AssertionError(f"{name}: the GLU output is not bf16-rounded")
    diff = (glu - ref).abs()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref.abs()).exponent - 8)
    tol = 2e-3 * max(1.0, float(ref.abs().max()))
    if not bool((diff <= torch.clamp(ulp, min=tol)).all()):
        raise AssertionError(f"{name}: GLU output differs from the plain GLU by more than one "
                             f"bf16 ulp and the tolerance (max {float(diff.max())})")
    return float(diff.max())


FFN_MARKS = ("A done", "first B ready", "last B ready", "end")


def ffn_timeline(args, kw, reps: int = 9) -> dict:
    """Where one call of csrc/ffn.cu's kernel spends its time, from its
    blocks' stamps (the card's ns timer, ffn.cu's stamp()): the us from the
    first block's entry to the last block's A items done, to the first and
    the last block's first w2 item having its GLU columns (its weights
    were streaming before), and to the last block's end; the median over
    `reps` calls on args(rep) = (x2, norm_w, w13, w2, layer, s13, s2)."""
    import torch
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.cuda.ffn import ffn_plan, launch_ffn
    marks = []
    for r in range(reps):
        x2, nw, w13, w2, layer, s13, s2 = args(r)
        int4 = G.is_int4(w13)
        plan = ffn_plan(x2.shape[0], x2.shape[1], w13.shape[1] // 2,
                        1 if int4 else w13.element_size(), int4)
        st = torch.zeros(plan.grid, 4, dtype=torch.int64, device=x2.device)
        launch_ffn("timeline", x2, nw, w13, w2, layer, s13, s2, stamps=st, **kw)
        torch.cuda.synchronize()
        st = st[st[:, 0] != 0].double() / 1e3   # us, the launched blocks
        t0, b = st[:, 0].min(), st[st[:, 2] != 0, 2]
        marks.append([float(st[:, 1].max() - t0), float(b.min() - t0), float(b.max() - t0),
                      float(st[:, 3].max() - t0)])
    return {m: statistics.median(x[k] for x in marks) for k, m in enumerate(FFN_MARKS)}


def ffn_glu_rows(x2, H: int, int4: bool, itemsize: int):
    """The GLU rows (nb, H) the last one-launch FFN call on x2's device and
    the current stream wrote: bf16 in the scratch (ffn_plan's glu region),
    widened to f32."""
    import torch
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.cuda.ffn import ffn_plan
    nb, K = x2.shape
    scratch, _ = G._SPLIT_BUFFERS[(x2.device, torch.cuda.current_stream(x2.device).cuda_stream)]
    off = ffn_plan(nb, K, H, itemsize, int4).offsets[2]
    return scratch[off:off + -(-nb * H // 2)].view(torch.bfloat16)[:nb * H].float().view(nb, H)


def phase_ffn_rows(bench: Bench, cfg, fw, dev, rows_list, runs=None, probes=False) -> None:
    """K4/K7 at each row count of rows_list, without the residual, with the
    model's activation. 1-16 rows (the decode step, a pipeline stage, the
    batched tick) run ONE launch of csrc/ffn.cu, timed beside the sequence
    it replaced (`ffn_old`, same run: two GEMV launches up to 8 rows, which
    it must equal bit for bit; the GEMM route's five launches past 8), its
    GLU rows read back from the scratch, and at 1 and 16 rows its timeline
    (ffn_timeline), the host's time per call of both designs and a
    CUDA-graph replay whose graph holds one kernel node; with `probes`
    (ffn_phases) also one kernel in a profiler trace of each of 20 calls.
    Past 16 rows
    the GEMM route (row norm, w13 GEMM with the GLU-pair epilogue, w2 GEMM)
    beside the mma.sync design it replaced. The GLU output, an
    intermediate, is checked in both: every value a bf16 value, within 2e-3
    of the plain GLU or one bf16 ulp of it (glu_holds). `runs`: row count
    -> the run whose launches the kernels line reports for that case (a
    row count not in it gets no row in the line)."""
    import torch
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.cuda.ffn import FFN_ROWS, ffn, ffn_plain

    runs = runs or {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    L, d, h = cfg.n_layers, cfg.dim, cfg.hidden_dim
    sc = fw.scales
    s13, s2 = (sc.w13, sc.w2) if sc else (None, None)
    int4 = G.is_int4(fw.w13)
    isz = 1 if int4 else fw.w13.element_size()
    name = "ffn4_l" if int4 else "ffn_l"
    wbytes = (fw.w13[0].numel() + fw.w2[0].numel()
              + (4 * (s13[0].numel() + s2[0].numel()) if int4 else 0))
    lay = lambda r: r % L  # noqa: E731
    act = cfg.act_type
    kw = dict(norm_eps=cfg.norm_eps, act=act, add_residual=False)
    wt = ("int4" if int4 else str(fw.w13.dtype).replace("torch.float8_", "")) + (
        f" {act}" if act != "silu" else "")
    for B in rows_list:
        x = torch.randn(B, d, generator=gen, device=dev) * 3.0
        if B == 1:
            x = x[0]   # the decode step's (dim,) stream
        x2 = x.reshape(-1, d)
        xb = G.bf16f(x2 * torch.rsqrt((x2 * x2).mean(-1, keepdim=True) + cfg.norm_eps)
                     * fw.rms_ffn[2])
        ref_glu = G.glu_plain(G.proj_plain(xb, fw.w13, 2, s13), act)
        args = lambda r, x=x: (x, fw.rms_ffn, fw.w13, fw.w2, lay(r), s13, s2)  # noqa: E731
        if B > FFN_ROWS:
            glu = G.launch_gemm("check", xb, fw.w13, 2, s13, glu_act=act)
            gerr = glu_holds(f"{name} B={B}", glu, ref_glu)
            log(f"  {name} B={B}: {act} GLU output bf16-rounded bit for bit, max |err| "
                f"{gerr:.3e}")
            bench.case(f"{name}_gemm", f"B={B} (GEMM route) {wt}",
                       ffn(*args(2), **kw), ffn_plain(*args(2), **kw), 2e-3,
                       kernel=lambda r, a=args: ffn(*a(r), **kw),
                       plain=lambda r, a=args: ffn_plain(*a(r), **kw),
                       old=lambda r, a=args: on_old_gemm(lambda: ffn(*a(r), **kw)),
                       bytes_=wbytes + 8 * B * d + 4 * d, flops=B * 6 * h * d,
                       json_row=B in runs, run=runs.get(B, "serve"))
            continue
        got = ffn(*args(2), **kw)
        glu = ffn_glu_rows(x2, h, int4, isz)
        old = ffn_old(*args(2), **kw)
        torch.cuda.synchronize()
        if B <= 8 and not torch.equal(got, old):
            raise AssertionError(f"{name} B={B}: the one launch differs from the two launches "
                                 f"(max |diff| {float((got - old).abs().max())})")
        gerr = glu_holds(f"{name} B={B}", glu, ref_glu)
        flips = int(((glu - ref_glu).abs() > 2e-3 * max(1.0, float(ref_glu.abs().max()))).sum())
        log(f"  {name} B={B}: one launch" + (" equal to the two launches bit for bit"
                                            if B <= 8 else "")
            + f"; its {act} GLU rows bf16 values, max |err| {gerr:.3e} ({flips} one-ulp flips)")
        bench.case(name, f"B={B} {wt}, one launch", got, ffn_plain(*args(2), **kw), 2e-3,
                   kernel=lambda r, a=args: ffn(*a(r), **kw),
                   plain=lambda r, a=args: ffn_plain(*a(r), **kw),
                   old=lambda r, a=args: ffn_old(*a(r), **kw),
                   bytes_=wbytes + 8 * B * d + 4 * d, flops=B * 6 * h * d,
                   json_row=B in runs, run=runs.get(B, "serve"))
        row = bench.rows[-1]
        row["glu_flips"] = flips
        if B not in (1, 16):
            continue
        lk = dict(norm_eps=cfg.norm_eps, act=act)
        a2 = lambda r, x2=x2: (x2,) + args(r)[1:]  # noqa: E731
        row["timeline_us"] = tl = ffn_timeline(a2, lk)
        row["host_us"] = host_us_per_call(lambda: ffn(*args(5), **kw))
        row["old_host_us"] = host_us_per_call(lambda: ffn_old(*args(5), **kw))
        xg = x.clone()
        row["graph"], nodes = block_capture(lambda: ffn(xg, *args(5)[1:], **kw), xg)
        ks = kernels_per_call(lambda: ffn(*args(5), **kw)) if probes else None
        if (nodes is not None and nodes != [0]) or (nodes is None and ks is None) or (
                ks is not None and (any("ffn_kernel" not in k for k in ks) or len(ks) > 20
                                    or (nodes is None and len(ks) != 20))):
            raise AssertionError(f"{name} B={B}: one call's graph nodes {nodes}; 20 calls "
                                 f"launched {ks}")
        msg = (f"  {name} B={B}: timeline (us) " + ", ".join(f"{k} {v:.2f}" for k, v in tl.items())
               + f"; one call's CUDA graph: node types {nodes} (0: a kernel), {row['graph']}; "
               f"host time per call {row['host_us']:.1f} us (the launches it replaced: "
               f"{row['old_host_us']:.1f} us)")
        if probes:
            msg += f"; 20 calls: {len(ks)} kernels ({ks[0] if ks else '-'})"
        log(msg)


def batched_lanes(S: int):
    """16 lanes of a batched tick: kv_len from 1 to the window (positions
    of a 4096-slot window, scaled to S), one lane in the ring regime
    (sinks), two write-masked lanes."""
    pos = [p * S // 4096 for p in (0, 1, 63, 64, 199, 511, 998, 1499, 2047, 2600, 3071, 3500,
                                   3999, 4094)] + [S - 1, S + 1903]
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


def window_rows(S: int, kv_pos, kv_len, kv_sink, win) -> tuple:
    """Per lane, the (S,) bool mask of the slots attention reads (slot <
    kv_len, and on a sliding layer age < win) and their count: what a
    sliding row's bound and its SDPA yardstick take."""
    import torch
    from yalm_tpu_torch.ops.cuda.attention import slot_age
    masks = []
    for kp, kl, ks in zip(kv_pos, kv_len, kv_sink):
        m = torch.arange(S) < kl
        if win is not None:
            m &= slot_age(S, kp, ks, "cpu") < win
        masks.append(m)
    masks = torch.stack(masks)
    return masks, int(masks.sum())


def form_label(form: dict) -> str:
    """The Gemma forms of an attention case, as its label says them."""
    parts = ([f"softcap {form['softcap']:g}"] if form.get("softcap") else []) + \
        ([f"win {form['win']}"] if form.get("win") is not None else []) + \
        (["local rope"] if form.get("alt") else [])
    return (", " + " + ".join(parts)) if parts else ""


def short_lanes(B: int = 16):
    """16 lanes at the contexts of the profiled ticks (prompts of 64 tokens
    admitted, then decoding): kv_len 65 to 95, every lane writing."""
    pos = [64 + 2 * i for i in range(B)]
    return pos, [p + 1 for p in pos], [0] * B, pos, [1] * B


def lanes_label(S: int, Hk: int, lanes, win) -> str:
    """Where the lanes split puts a K8/K9 case: its chunks, and how many of
    the B x nsplit (lane, chunk) pairs read rows (`lane_chunk_live`)."""
    from yalm_tpu_torch.ops.cuda.attention import lane_chunk_live, lanes_split_plan
    chunk, nsplit = lanes_split_plan(S, Hk)
    live = sum(lane_chunk_live(c, chunk, S, kp, kl, ks, win or 0)
               for kp, kl, ks in zip(*lanes[:3]) for c in range(nsplit))
    return f", {nsplit}x{chunk} ({live} of {len(lanes[0]) * nsplit} read)"


def phase_paged_attention(bench: Bench, cfg, dev, kv_dtype, form=None, depths=None,
                          json: bool = True, run: str = "paged") -> None:
    """K9 at B 16 over pools of 257 pages of 256 slots through shuffled
    tables, at the lanes of batched_lanes: the output against the plain
    version, the pool byte for byte (written rows, untouched pages, the
    masked lanes), and K9 equal to K8 bit for bit on the same cache gathered
    into the dense layout. First at the model's depth (a bf16 pool of
    2.16e9 elements: offsets past 2^31), then on 4 layers, the footprint of
    K8's case, whose row the kernels line reports; the library yardstick is
    SDPA over the gathered padded batch. `form`: the Gemma forms (softcap,
    win, alt), with the bound and SDPA's mask over the slots inside the
    window; `depths`: the pool depths run (default the model's and 4);
    `json`: whether the kernels line reports the 4-layer row (a path whose
    serving runs K8 has no K9 launches to report); `run`: the main-path run
    whose K9 launches the row reports."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.ops.cuda import attention as A

    form = form or {}
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
    rope = dict(kv_sinks=2, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim, **form)
    wd = "e5m2" if kv_dtype.itemsize == 1 else "bf16"
    bits = torch.uint8 if kv_dtype.itemsize == 1 else torch.int16
    mask, rows = window_rows(S, kv_pos, kv_len, sink, form.get("win"))
    mask = mask.to(dev)
    qq = q.reshape(B, Hq, 1, D).to(torch.bfloat16)
    L4 = 4
    for L in depths or (cfg.n_layers, L4):
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
                   f"1..{S}, ring + 2 read-only lanes{form_label(form)}"
                   + lanes_label(S, Hk, (kv_pos, kv_len, sink), form.get("win")), got, want, 2e-3,
                   kernel=lambda r: A.attend_step_paged(q, kn, vn, k_pool, v_pool, tables,
                                                        top - r % L4, lanes, **rope),
                   plain=lambda r: A.attend_step_paged_plain(q, kn, vn, k_pool, v_pool,
                                                             tables_cpu, top - r % L4,
                                                             lanes_cpu, **rope),
                   library=lambda r: F.scaled_dot_product_attention(
                       qq, kk[r % L4], vv[r % L4], attn_mask=mask[:, None, None, :],
                       enable_gqa=True),
                   old=lambda r: attend_step_v1(q, kn, vn, k_pool, v_pool, top - r % L4, lanes,
                                                tables, **rope),
                   bytes_=2 * rows * Hk * D * item + 4 * B * (2 * Hq * D + 2 * Hk * D)
                   + 4 * 5 * B + 4 * B * nblk,
                   flops=4 * rows * Hq * D, json_row=json and L == L4, run=run)
        if L == L4:   # the profiled ticks' short lanes, where a call's fixed cost shows
            sh = short_lanes(B)
            sl = A.lane_scalars(*sh, S=S, kv_sinks=2, device=dev)
            sl_cpu = sl.cpu()
            smask, srows = window_rows(S, *sh[:3], form.get("win"))
            smask = smask.to(dev)
            swant = A.attend_step_paged_plain(q, kn, vn, k_pool.clone(), v_pool.clone(),
                                              tables_cpu, top, sl_cpu, **rope)
            bench.case("attend_step_paged_l", f"B=16 {wd} {L} layers, pages of 256 shuffled, "
                       f"kv_len 65..95 (the profiled ticks'){form_label(form)}"
                       + lanes_label(S, Hk, sh, form.get("win")),
                       A.attend_step_paged(q, kn, vn, k_pool, v_pool, tables, top, sl, **rope),
                       swant, 2e-3,
                       kernel=lambda r: A.attend_step_paged(q, kn, vn, k_pool, v_pool, tables,
                                                            top - r % L4, sl, **rope),
                       plain=lambda r: A.attend_step_paged_plain(q, kn, vn, k_pool, v_pool,
                                                                 tables_cpu, top - r % L4,
                                                                 sl_cpu, **rope),
                       library=lambda r: F.scaled_dot_product_attention(
                           qq, kk[r % L4][:, :, :128], vv[r % L4][:, :, :128],
                           attn_mask=smask[:, None, None, :128], enable_gqa=True),
                       old=lambda r: attend_step_v1(q, kn, vn, k_pool, v_pool, top - r % L4,
                                                    sl, tables, **rope),
                       bytes_=2 * srows * Hk * D * item + 4 * B * (2 * Hq * D + 2 * Hk * D)
                       + 4 * 5 * B + 4 * B * nblk,
                       flops=4 * srows * Hq * D, run=run)
        del kk, vv, k_pool, v_pool
        torch.cuda.empty_cache()


def phase_batched_attention(bench: Bench, cfg, dev, kv_dtype, form=None,
                            json: bool = True) -> None:
    """K8 at B 16 on a 4-layer cache of the model's window: every lane's
    written rows equal the plain version's byte for byte, write-masked
    lanes change nothing; the library yardstick is SDPA over the padded
    batch (a mask per lane). `form`, `json`: as phase_paged_attention's."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.cuda import attention as A

    form = form or {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    Hq, Hk, D, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len
    B, L4 = 16, 4
    cache = KVCache.init(with_layers(cfg, L4), kv_dtype, dev, batch=B)
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev, dtype=torch.bfloat16).to(kv_dtype))
    kv_pos, kv_len, sink, pos, write = batched_lanes(S)
    lanes = A.lane_scalars(kv_pos, kv_len, sink, pos, write, S=S, kv_sinks=2, device=dev)
    lanes_cpu = lanes.cpu()
    q = torch.randn(B, Hk, Hq // Hk, D, generator=gen, device=dev) * 2
    kn = torch.randn(B, Hk, D, generator=gen, device=dev) * 2
    vn = torch.randn(B, Hk, D, generator=gen, device=dev)
    rope = dict(kv_sinks=2, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim, **form)
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
    mask, rows = window_rows(S, kv_pos, kv_len, sink, form.get("win"))
    mask = mask.to(dev)
    qq = q.reshape(B, Hq, 1, D).to(torch.bfloat16)
    item = kv_dtype.itemsize
    bench.case("attend_step_batched_l", f"B=16 {wd} kv_len 1..{S}, ring + 2 read-only lanes"
               f"{form_label(form)}" + lanes_label(S, Hk, (kv_pos, kv_len, sink), form.get("win")),
               got, want, 2e-3,
               kernel=lambda r: A.attend_step_batched(q, kn, vn, cache.k, cache.v, r % L4,
                                                      lanes, **rope),
               plain=lambda r: A.attend_step_batched_plain(q, kn, vn, cache.k, cache.v, r % L4,
                                                           lanes_cpu, **rope),
               library=lambda r: F.scaled_dot_product_attention(
                   qq, kk[r % L4], vv[r % L4], attn_mask=mask[:, None, None, :],
                   enable_gqa=True),
               old=lambda r: attend_step_v1(q, kn, vn, cache.k, cache.v, r % L4, lanes, **rope),
               bytes_=2 * rows * Hk * D * item + 4 * B * (2 * Hq * D + 2 * Hk * D)
               + 4 * 5 * B,
               flops=4 * rows * Hq * D, json_row=json, run="batched")
    # the profiled ticks' short lanes, where a call's fixed cost shows
    sh = short_lanes(B)
    sl = A.lane_scalars(*sh, S=S, kv_sinks=2, device=dev)
    sl_cpu = sl.cpu()
    mask, rows = window_rows(S, *sh[:3], form.get("win"))
    mask = mask.to(dev)
    want = A.attend_step_batched_plain(q, kn, vn, cache.k.clone(), cache.v.clone(), 1, sl_cpu,
                                       **rope)
    bench.case("attend_step_batched_l", f"B=16 {wd} kv_len 65..95 (the profiled ticks')"
               f"{form_label(form)}" + lanes_label(S, Hk, sh, form.get("win")),
               A.attend_step_batched(q, kn, vn, cache.k, cache.v, 1, sl, **rope), want, 2e-3,
               kernel=lambda r: A.attend_step_batched(q, kn, vn, cache.k, cache.v, r % L4, sl,
                                                      **rope),
               plain=lambda r: A.attend_step_batched_plain(q, kn, vn, cache.k, cache.v, r % L4,
                                                           sl_cpu, **rope),
               library=lambda r: F.scaled_dot_product_attention(
                   qq, kk[r % L4][:, :, :128], vv[r % L4][:, :, :128],
                   attn_mask=mask[:, None, None, :128], enable_gqa=True),
               old=lambda r: attend_step_v1(q, kn, vn, cache.k, cache.v, r % L4, sl, **rope),
               bytes_=2 * rows * Hk * D * item + 4 * B * (2 * Hq * D + 2 * Hk * D)
               + 4 * 5 * B,
               flops=4 * rows * Hq * D, run="batched")
    del kk, vv, cache


def phase_lanes_capture(cfg, dev, kv_dtype) -> None:
    """K8 and K9 (the lanes split) over 16 lanes of the model's window on a
    2-layer cache and a pool of shuffled pages of 256: a call under
    torch.cuda.set_sync_debug_mode("error") (the wrapper reads no device
    value, so no host sync), then a call captured in a CUDA graph: with the
    lanes tensor rewritten in place (every lane one position on, the
    write-masked lanes writing) and the graph replayed, the output equals an
    uncaptured call with the new lanes bit for bit, and differs from the
    old lanes' output. Raises otherwise."""
    import torch
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.cuda import attention as A

    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    Hq, Hk, D, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len
    B, L, page = 16, 2, 256
    nblk = S // page
    cache = KVCache.init(with_layers(cfg, L), kv_dtype, dev, batch=B)
    shape = (1 + B * nblk, L, page, Hk, D)
    k_pool, v_pool = (torch.empty(shape, dtype=kv_dtype, device=dev) for _ in range(2))
    for t in (cache.k, cache.v, k_pool, v_pool):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev, dtype=torch.bfloat16).to(kv_dtype))
    tables = shuffled_tables(B, nblk, seed=18).to(dev)
    q = torch.randn(B, Hk, Hq // Hk, D, generator=gen, device=dev) * 2
    kn = torch.randn(B, Hk, D, generator=gen, device=dev) * 2
    vn = torch.randn(B, Hk, D, generator=gen, device=dev)
    rope = dict(kv_sinks=2, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)

    def lanes_at(step: int):
        _, _, _, pos, write = batched_lanes(S)
        pos = [p + step for p in pos]
        sink = [2 if p >= S else 0 for p in pos]
        kv_pos = [s + (p - s) % (S - s) for p, s in zip(pos, sink)]
        return A.lane_scalars(kv_pos, [min(p + 1, S) for p in pos], sink, pos,
                              [1] * B if step else write, S=S, kv_sinks=2, device=dev)

    calls = {"attend_step_batched_l": lambda ln: A.attend_step_batched(
                 q, kn, vn, cache.k, cache.v, 1, ln, **rope),
             "attend_step_paged_l": lambda ln: A.attend_step_paged(
                 q, kn, vn, k_pool, v_pool, tables, 1, ln, **rope)}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    wd = "e5m2" if kv_dtype.itemsize == 1 else "bf16"
    for name, call in calls.items():
        lanes = lanes_at(0)
        with torch.cuda.stream(side):
            before = call(lanes)   # warm: this stream's counters, the rope table
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                call(lanes)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = call(lanes)
            lanes.copy_(lanes_at(1))
            graph.replay()
            want = call(lanes)
        torch.cuda.synchronize()
        if not torch.equal(out, want) or torch.equal(out, before):
            raise AssertionError(f"{name} {wd}: the CUDA graph replayed with rewritten lanes "
                                 "differs from an uncaptured call on them")
        log(f"  {name} {wd}: no host sync under sync_debug_mode('error'); a CUDA graph "
            "replayed after the lanes tensor was rewritten equals an uncaptured call on the "
            "new lanes bit for bit")
    del cache, k_pool, v_pool
    torch.cuda.empty_cache()


# the kernels each path must launch in its phase-3 run (the Mixtral paths'
# router is gemv_l/gemm_l on every weight type), and those it must not
PATH_KERNELS = {"fp8": ("gemv", "gemm_l", "round_rows_bf16", "attn_block_l", "ffn_l"),
                "int4": ("gemv", "gemm4_l", "round_rows_bf16", "attn_block4_l", "ffn4_l"),
                "moe_fp8": ("gemv", "gemv_l", "gemm_l", "round_rows_bf16", "attn_block_l",
                            "gemv_le", "gemm_le"),
                "moe_int4": ("gemv", "gemv_l", "gemm_l", "round_rows_bf16", "gemm4_l",
                             "attn_block4_l", "gemv4_le", "gemm4_le")}
PATH_KERNELS.update({g: ("gemv", "gemv_l", "gemm_l", "round_rows_bf16", "attend_step_l",
                         "ffn_l") for g in ("gemma3", "gemma2")})
# the fused block is one launch (csrc/block.cu): no attend_step_l on its
# paths, and with the FFN in one launch (csrc/ffn.cu) no layer GEMV either
# (the head is `gemv`); the Gemma paths take the unfused route: no fused
# attention block
PATH_ABSENT = {"fp8": ("attend_step_l", "gemv_l"), "int4": ("attend_step_l", "gemv4_l"),
               "moe_fp8": ("ffn_l", "ffn_l_gemm", "attend_step_l"),
               "moe_int4": ("ffn4_l", "ffn4_l_gemm", "attend_step_l"),
               "gemma3": ("attn_block_l",), "gemma2": ("attn_block_l",)}
# (name, prompt tokens, new tokens, sampled); a "ring" request continues the
# one before it past the window
SERVE_REQUESTS = (("greedy 200+64", 200, 64, False), ("sampled 1500+64", 1500, 64, True),
                  ("window 4090+16", 4090, 16, False), ("ring follow-up 8+8", 8, 8, False))
MOE_SERVE_REQUESTS = {"moe_fp8": (("greedy 200+64", 200, 64, False),
                                  ("sampled 1500+32", 1500, 32, True),
                                  ("window 4090+16", 4090, 16, False),
                                  ("ring follow-up 8+8", 8, 8, False)),
                      "moe_int4": (("greedy 200+64", 200, 64, False),
                                   ("sampled 1500+32", 1500, 32, True),
                                   ("window 4090+16", 4090, 16, False))}
# past each sliding window (1024 / 4096), then across the model's window
GEMMA_SERVE_REQUESTS = {"gemma3": (("greedy 200+64", 200, 64, False),
                                   ("sampled 1500+64", 1500, 64, True),
                                   ("window 4090+16", 4090, 16, False),
                                   ("ring follow-up 8+8", 8, 8, False)),
                        "gemma2": (("greedy 200+64", 200, 64, False),
                                   ("sampled 6000+32", 6000, 32, True),
                                   ("window 8190+16", 8190, 16, False),
                                   ("ring follow-up 8+8", 8, 8, False))}


@contextlib.contextmanager
def attention_forms():
    """While active: every attention launch (K2, K8, K9) counted by its
    Gemma form, (launcher, softcap, win, alt) -- the wrappers' launch
    counts do not say which form ran."""
    import collections
    from yalm_tpu_torch.ops.cuda import attention as A
    tally: collections.Counter = collections.Counter()
    saved = {n: getattr(A, n) for n in ("launch_attend_step", "launch_attend_step_batched",
                                        "launch_attend_step_paged")}

    def counting(name, fn):
        def launch(*a, softcap=0.0, win=None, alt=None, **k):
            tally[(name, float(softcap), None if win is None else int(win), int(alt or 0))] += 1
            return fn(*a, softcap=softcap, win=win, alt=alt, **k)
        return launch
    for name, fn in saved.items():
        setattr(A, name, counting(name, fn))
    try:
        yield tally
    finally:
        for name, fn in saved.items():
            setattr(A, name, fn)


def forms_hold(cfg, tally, what: str) -> None:
    """A Gemma run's attention launches took the model's forms: its
    sliding window on the sliding layers (with the local rope on Gemma3),
    the whole window on the others, its softcap on all. Raises otherwise."""
    alt = int(bool(cfg.rope_scale) and cfg.rope_scale[0] == "gemma3")
    want = {(float(cfg.attn_softcap), cfg.sliding_window, alt),
            (float(cfg.attn_softcap), cfg.max_seq_len, 0)}
    seen = {k[1:] for k in tally}
    log(f"  attention launches by form (launcher, softcap, win, alt) over the {what}: "
        f"{dict(tally)}")
    if seen != want:
        raise AssertionError(f"{what}: attention forms {sorted(seen, key=str)}, expected "
                             f"{sorted(want, key=str)}")


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
    if not eng.fast:
        raise AssertionError(f"{path}: the engine is not on the kernels")
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
        if not first and not kw.get("temperature"):
            first.update(name=name, toks=list(toks), out=out, logits=logits.clone())
        r = dict(request=name, prompt_tokens=len(toks), new_tokens=n,
                 ttft_s=t_first - t0, prefill_tok_s=len(toks) / (t_first - t0),
                 decode_tok_s=(n - 1) / (t_end - t_first) if n > 1 else None,
                 end_pos=eng.pos)
        log(f"  {name}: prompt {len(toks)}, {n} new: TTFT {r['ttft_s']:.4f} s, "
            f"prefill {r['prefill_tok_s']:.1f} tok/s, decode {r['decode_tok_s']:.2f} tok/s, "
            f"first tokens {out[:6]}")
        return r

    first: dict = {}   # the first greedy request's prompt, tokens and last logits
    eng.warmup()
    calls: collections.Counter = collections.Counter()   # decode steps, prefill chunks
    for nm in ("_step", "_prefill"):
        def counted(*a, _fn=getattr(eng, nm), _nm=nm, **k):
            calls[_nm] += 1
            return _fn(*a, **k)
        setattr(eng, nm, counted)
    _build.LAUNCHES.clear()
    reqs = []
    profile = window_profile = None
    with attention_forms() as forms:
        for name, n_prompt, n_new, sampled in requests:
            # a follow-up turn starts past the window: per-token hydration in
            # the ring regime, sinks active
            if not name.startswith("ring"):
                eng.reset()
            kw = dict(temperature=0.8, top_p=0.9, seed=1234) if sampled else dict(temperature=0.0)
            reqs.append(serve(name, prompt(n_prompt), n_new, **kw))
            # decode profiled after the first request (context 280) and at
            # the full window (the follow-up continues past it)
            if profile is None:
                profile = profile_decode(eng, 16)
            elif name.startswith("window"):
                window_profile = profile_decode(eng, 16)
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if any(cfg.layer_sliding):
        forms_hold(cfg, forms, f"{path} path's requests")
    log(f"  launches over the {path} path's requests ({calls['_step']} decode steps, "
        f"{calls['_prefill']} prefill chunks): {launches}")
    missing = [k for k in PATH_KERNELS[path] if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing}")
    present = [k for k in PATH_ABSENT.get(path, ()) if launches.get(k, 0)]
    if present:
        raise AssertionError(f"kernels launched on the {path} path that it must not "
                             f"launch: {present}")
    out = dict(requests=reqs, launches=launches, decode_profile=profile,
               window_decode_profile=window_profile, decode_steps=calls["_step"],
               prefill_chunks=calls["_prefill"])
    if not cfg.is_moe:
        out["old_ffn_stream"] = old_ffn_stream(eng, first)
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


def old_ffn_stream(eng, first: dict) -> dict:
    """The first greedy request again with the FFN's 1-8 rows on the two
    GEMV launches the one launch replaced (`ffn_old`; more rows as the
    path runs them): raises unless its tokens and last logits are the one
    launch's bit for bit. Then the decode step's device time on each, in
    this run: 16 profiled steps each on the one launch, the two, the two,
    the one (continuing the sequence, so the two designs see the same mean
    context)."""
    import torch
    from yalm_tpu_torch.models import fast as M
    one = M.ffn

    def two(x, *a, **k):
        return (ffn_old if x.reshape(-1, x.shape[-1]).shape[0] <= 8 else one)(x, *a, **k)
    M.ffn = two
    try:
        eng.reset()
        toks = list(eng.generate(first["toks"], max_steps=len(first["out"]), temperature=0.0))
        logits = eng._last_logits.clone()
    finally:
        M.ffn = one
    if toks != first["out"] or not torch.equal(logits, first["logits"]):
        raise AssertionError(f"{first['name']}: the stream on the two FFN launches differs from "
                             f"the one launch's (tokens equal: {toks == first['out']}, max "
                             f"|logit diff| {float((logits - first['logits']).abs().max())})")
    msg = (f"{first['name']} again on the two FFN launches: the same {len(toks)} tokens and "
           "last logits, bit for bit")
    log(f"  {msg}")
    steps = {"one": [], "two": []}
    for design in ("one", "two", "two", "one"):
        M.ffn = two if design == "two" else one
        try:
            steps[design].append(profile_decode(eng, 16, quiet=True)["device_ms_per_step"])
        finally:
            M.ffn = one
    ms = {k: statistics.mean(v) for k, v in steps.items()}
    log(f"  decode step on the device, same run (one, two, two, one; 16 steps each, context "
        f"to {eng.pos}): one FFN launch {ms['one']:.4f} ms, the two launches it replaced "
        f"{ms['two']:.4f} ms ({steps})")
    return dict(check=msg, device_ms_per_step=ms, runs=steps)


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
# (round_rows_bf16: the rounding of X before every gemm_kernel launch); a
# dense model's tick runs the FFN in one launch (ffn_l / ffn4_l, csrc/ffn.cu),
# a prefill chunk of more than 16 rows on the GEMM route (_gemm)
SERVING_KERNELS = {
    ("fp8", False): ("gemm_l", "round_rows_bf16", "ffn_l", "ffn_l_gemm", "rmsnorm_rows",
                     "attn_block_l", "gemv"),
    ("int4", False): ("gemm4_l", "round_rows_bf16", "ffn4_l", "ffn4_l_gemm", "rmsnorm_rows"),
    ("fp8", True): ("gemm_l", "round_rows_bf16", "ffn_l", "ffn_l_gemm", "rmsnorm_rows", "gemv"),
    ("int4", True): ("gemm4_l", "round_rows_bf16", "ffn4_l", "ffn4_l_gemm", "rmsnorm_rows"),
    # MoE: the router on gemm_l, every expert of every row on the routed GEMM
    # (the single-token gemv_le/gemv4_le and the dense FFN never run)
    ("moe_fp8", False): ("gemm_l", "round_rows_bf16", "gemm_le"),
    ("moe_int4", True): ("gemm_l", "round_rows_bf16", "gemm4_l", "gemm4_le"),
    # Gemma: the tick's FFN without its residual, then the post-norm
    ("gemma3", False): ("gemm_l", "round_rows_bf16", "ffn_l", "ffn_l_gemm", "rmsnorm_rows"),
    ("gemma2", True): ("gemm_l", "round_rows_bf16", "ffn_l", "ffn_l_gemm", "rmsnorm_rows")}
SERVING_ABSENT = {"moe_fp8": ("gemv_le", "ffn_l_gemm"), "moe_int4": ("gemv4_le", "ffn4_l_gemm"),
                  "gemma3": ("attn_block_l",), "gemma2": ("attn_block_l",)}
TICK_ATTENTION = {False: "attend_step_batched_l", True: "attend_step_paged_l"}
MISTRAL_SERVING_LAYERS = 8
MIXTRAL_SERVING_LAYERS = 8
GEMMA_SERVING_LAYERS = 8
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
    if not sched.fast:
        raise AssertionError(f"{path}: the scheduler is not on the kernels")
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
    with attention_forms() as forms:
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
    if any(cfg.layer_sliding):
        forms_hold(cfg, forms, f"{path} serving run")
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
    else:   # the 16-lane tick's FFN: one launch a layer, none on the GEMM route
        ffn = "ffn4_l" if fw.w13.dtype == torch.uint8 else "ffn_l"
        per_tick.update({ffn: cfg.n_layers, ffn + "_gemm": 0})
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
def gate_calls(force=None):
    """While active: every top-k gate call, the fast path's and the
    oracle's, keeps its rows' own experts (sorted) and router logits on the
    device. Yields took(keep=True, rows=None): the calls since its last call
    as (experts (rows, layers, k), router logits (rows, layers, E) f32)
    numpy arrays, or None (keep False drops them); rows names the rows of
    the forward pass that follows as (greedy lane, position) pairs (None for
    a padding row), one gate call a layer. With force (greedy lane ->
    position -> (experts (layers, k), ...), a run's routing) each named row
    that force holds goes to force's experts in every layer, ranked and
    gated by the call's own router logits as moe_gate ranks and gates its
    own choice; took returns the own choice."""
    import numpy as np
    import torch
    from yalm_tpu_torch.models import fast as M
    from yalm_tpu_torch.models import transformer as T
    calls: list = []
    forced: list = [None]   # (experts (layers, rows, k), named (rows,)) of the next pass
    gate = M.moe_gate

    def recording(logits, k):
        gates, idx = gate(logits, k)
        lg = logits.float().reshape(-1, logits.shape[-1])
        own = idx.reshape(-1, k)
        calls.append((torch.sort(own, dim=-1).values, lg))
        if forced[0] is None:
            return gates, idx
        ex, named = (torch.as_tensor(a, device=lg.device) for a in
                     (forced[0][0][len(calls) - 1], forced[0][1]))
        pick = torch.where(named[:, None], ex, own)
        vals, order = torch.sort(lg.gather(1, pick), dim=-1, descending=True)
        e = torch.exp(vals - lg.amax(-1, keepdim=True))
        return ((e / e.sum(-1, keepdim=True)).to(gates.dtype).reshape(gates.shape),
                pick.gather(1, order).to(idx.dtype).reshape(idx.shape))

    def took(keep: bool = True, rows=None):
        got = None
        if calls and keep:
            got = (torch.stack([c[0] for c in calls], 1).cpu().numpy(),
                   torch.stack([c[1] for c in calls], 1).cpu().numpy())
        calls.clear()
        forced[0] = None
        named = [r is not None and r[1] in force.get(r[0], {}) for r in rows or ()] if force else []
        if any(named):
            g, pos = rows[named.index(True)]
            none = np.zeros_like(force[g][pos][0])
            forced[0] = (np.stack([force[r[0]][r[1]][0] if n else none
                                   for r, n in zip(rows, named)], 1), np.array(named))
        return got
    M.moe_gate = T.moe_gate = recording
    try:
        yield took
    finally:
        M.moe_gate = T.moe_gate = gate


def router_gap(lg, k: int):
    """The gap between the k-th and the (k+1)-th largest router logits of
    each row of lg (..., E), in units of the logit tolerance (1e-2 of max(1,
    max|router logit|) of the row): a near-tie, which an error inside the
    tolerance may route differently, where it is at most 2."""
    import numpy as np
    top = -np.sort(-lg, axis=-1)
    return (top[..., k - 1] - top[..., k]) / (1e-2 * np.maximum(1.0, np.abs(lg).max(-1)))


@contextlib.contextmanager
def routing_log(cfg):
    """While active (a parity phase's card and CPU runs of an MoE cfg):
    every call of the top-k gate records each row's chosen experts and
    whether the row's router logits lie at a near-tie (router_gap). Yields
    take(), which returns, and forgets, the (experts, near) pairs of the
    layers since its last call (gate_calls)."""
    import numpy as np
    with gate_calls() as took:
        def take() -> list:
            got = took()
            if got is None:
                return []
            ex, lg = got                                      # (rows, layers, k / E)
            k = ex.shape[-1]
            near = np.zeros(ex.shape[:2], bool)
            if lg.shape[-1] > k:
                near = router_gap(lg, k) <= 2
            return [(ex[:, i], near[:, i]) for i in range(ex.shape[1])]
        yield take


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
    busy = device_busy_us(prof) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    # K8/K9 (the tick's attention): the span of the lanes split's two kernels
    lanes_us = device_busy_us(prof, ("lanes_scores_kernel", "lanes_values_kernel"))
    r = dict(ticks=n, lanes=sched.B, wall_ms_per_tick=wall / n * 1e3,
             device_ms_per_tick=busy / n * 1e3, idle_share=(1 - busy / wall) if busy else None,
             tok_s=sched.B * n / wall, top=[(k[:60], v / n / 1e3) for k, v in top],
             launches_per_tick=counts, attention_ms_per_tick=lanes_us / n / 1e3)
    if spans:
        r["moe_ffn_ms_per_tick"] = sum(a.elapsed_time(b) for a, b in spans) / n
    log(f"  tick profile, {sched.B} busy lanes, launches per tick {counts}: "
        f"{r['wall_ms_per_tick']:.3f} ms/tick wall, "
        f"{r['device_ms_per_tick']:.3f} ms/tick on the device, idle share {r['idle_share']}, "
        f"{r['tok_s']:.1f} tok/s; K8/K9 (lanes_scores_kernel + lanes_values_kernel) "
        f"{r['attention_ms_per_tick']:.4f} ms/tick on the device"
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
                       bqkv=cut(fw.bqkv), qnorm=cut(fw.qnorm), knorm=cut(fw.knorm),
                       pa=cut(fw.pa), pf=cut(fw.pf),
                       scales=None if sc is None else FastScales(
                           embed=sc.embed, wqkv=sc.wqkv[:n], wo=sc.wo[:n], w13=sc.w13[:n],
                           w2=sc.w2[:n], lm_head=sc.lm_head, moegate=cut(sc.moegate)))


@contextlib.contextmanager
def widened_once():
    """While active, the CPU's plain versions widen each weight once: the f32
    values of gemv._bf16_weights and gemv.int4_values for a CPU tensor are
    kept and returned again for the same tensor (its address, shape,
    strides and dtype), instead of being made anew at every step, which is
    most of the CPU's time at full width. The same values, so the same
    bits. Only weights that outlive the context may pass through it."""
    from yalm_tpu_torch.ops.cuda import gemv
    saved = {n: getattr(gemv, n) for n in ("_bf16_weights", "int4_values")}
    memo: dict = {}

    def keep(name, fn):
        def widened(w, *a):
            if w.device.type != "cpu":
                return fn(w, *a)
            key = (name, w.data_ptr(), tuple(w.shape), tuple(w.stride()), w.dtype, a)
            if key not in memo:
                memo[key] = fn(w, *a)
            return memo[key]
        return widened
    for n, fn in saved.items():
        setattr(gemv, n, keep(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(gemv, n, fn)
        memo.clear()


def depth2(cfg):
    """The parity phases' depth-2 model: the first two layers; a model with
    sliding layers takes them as (sliding, global) with a window of 48, so
    a 64-token prompt and its steps cross the window on the card (the one
    change to a configuration, which the log states)."""
    if not any(cfg.layer_sliding):
        return with_layers(cfg, min(2, cfg.n_layers))
    log("  depth 2: layer_sliding (1, 0) and sliding_window 48 (the one change to the "
        "configuration)")
    return dataclasses.replace(cfg, n_layers=2, layer_sliding=(1, 0), sliding_window=48)


def argmax_holds(g, c, tol: float, capped: bool) -> bool:
    """The card's argmax against the CPU's: equal; under a final softcap,
    which flattens the top of the logits, within the tolerance of the CPU's
    maximum (CLAUDE.md:170-172)."""
    if capped:
        return float(c[int(g.argmax())]) >= float(c.max()) - tol
    return int(g.argmax()) == int(c.argmax())


def e5m2_step(x):
    """The e5m2 rounding step at each value's magnitude (2 mantissa bits;
    2^-16 below the normal range)."""
    import torch
    return torch.clamp(torch.ldexp(torch.ones_like(x), torch.frexp(x.abs()).exponent - 3),
                       min=2.0 ** -16)


def e5m2_divergence(card, cpu):
    """The first slot at which a depth-2 run's e5m2 caches differ between
    the card and the CPU, or None, and the number of differing bytes. In
    causal order (slot, then layer) the first row that differs has inputs
    that the two sides compute with different f32 summation orders (and
    bf16 roundings of intermediates that these move across a boundary), so
    each of its bytes must be within 2e-3 of max(1, max|row|) plus one
    e5m2 step of the other side's: f32 values within the tolerance that
    round across a boundary (tests/test_torch_cuda.py::test_e5m2_cache_
    bytes_differ_only_across_rounding_boundaries proves it for the rows of
    a prefill, each side's byte its own f32 row rounded); more raises. A
    step is 25% of the element, and every later position attends to that
    row."""
    import torch
    pairs = [(a.cpu(), b) for a, b in ((card.k, cpu.k), (card.v, cpu.v))]
    diffs = [a.view(torch.uint8) != b.view(torch.uint8) for a, b in pairs]   # (L, S, Hk, D)
    rows = torch.stack([d.flatten(2).any(-1) for d in diffs]).any(0)        # (L, S)
    if not bool(rows.any()):
        return None, 0
    slot, layer = min((int(s_), int(l_)) for l_, s_ in rows.nonzero().tolist())
    for a, b in pairs:
        a, b = a[layer, slot].float(), b[layer, slot].float()
        tol = 2e-3 * max(1.0, float(b.abs().max()))
        if bool(((a - b).abs() > tol + e5m2_step(b)).any()):
            raise AssertionError(f"the first e5m2 cache row that differs from the CPU's (slot "
                                 f"{slot}, layer {layer}) is further from it than the tolerance "
                                 "and one rounding step")
    return slot, int(sum(int(d.sum()) for d in diffs))


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

    cfg = depth2(cfg)
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
    with routing_log(cfg) as take, widened_once():
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


# ---------------------------------------------------------------------------
# speculation (the chain forms: draft model, prompt lookup, Medusa heads)
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_NEW = 64          # single stream: 200-token prompts, 64 new tokens
SPEC_SERVE_NEW = 48    # serving: 16 requests of 64-512 prompt tokens, 48 new


def synth_medusa(cfg, device, seed: int, heads: int = 4):
    """Random Medusa heads made on the card: w1 and the heads' vocab
    projections bf16 with std 0.02 (as the test fixture's), b1 f32 zeros."""
    import torch
    from yalm_tpu_torch.medusa import MedusaWeights
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16) * 0.02
    return MedusaWeights(w1=mk(heads, cfg.dim, cfg.dim),
                         b1=torch.zeros(heads, cfg.dim, device=device),
                         head=mk(heads, cfg.vocab_size, cfg.dim))


def _fast(x):
    """An engine or scheduler, checked to be on the kernels' path."""
    if not x.fast:
        raise AssertionError(f"{type(x).__name__}: not on the kernels' path")
    return x


def plain_greedy(eng, prompt, n: int) -> float:
    """Engine.generate at T 0 from a reset engine: its decode rate."""
    import torch
    eng.reset()
    torch.cuda.synchronize()
    t_first = None
    for _ in eng.generate(prompt, max_steps=n, temperature=0.0):
        if t_first is None:
            t_first = time.perf_counter()
    torch.cuda.synchronize()
    return (n - 1) / (time.perf_counter() - t_first)


def profiled_call(fn, reps: int = 2) -> dict:
    """One call of fn, the mean of reps under torch.profiler: the device's
    busy time (None when the profiler saw no device event), the wall time,
    the five costliest kernels and the five host operations with the most
    self time (name, ms per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    busy = device_busy_us(prof)
    dev = sorted(device_us(prof).items(), key=lambda kv: -kv[1])[:5]
    host = sorted(((e.key, e.self_cpu_time_total) for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda kv: -kv[1])[:5]
    per = lambda top: [(k[:60], v / reps / 1e3) for k, v in top]  # noqa: E731
    return dict(device_ms=busy / reps / 1e3 if busy else None, wall_ms=wall,
                top_device=per(dev), top_host=per(host))


def teacher_forced_hold(name: str, eng, prompt, tokens) -> int:
    """Every token of a greedy spec stream against the plain decode path
    (Engine._step) fed the same tokens: the token is the plain row's argmax,
    or lies within twice the tolerance of its maximum (a near-tie, counted).
    Raises otherwise; returns the near-ties at which the stream differs."""
    import torch
    eng.reset()
    eng.prefill_tokens(prompt, want_logits=True)
    rows, lg = [], eng._last_logits
    for t in tokens:
        lf = lg.float()
        rows.append(torch.stack([lf.max(), lf[t], lf.abs().max(),
                                 (lf.argmax() == t).float()]))
        lg = eng._step(t)
    r = torch.stack(rows).cpu()
    gap_ok = r[:, 0] - r[:, 1] <= 2 * 1e-2 * r[:, 2].clamp(min=1.0)
    bad = [i for i in range(len(tokens)) if not (r[i, 3] > 0 or gap_ok[i])]
    if bad:
        raise AssertionError(f"{name}: tokens {bad} are neither the plain step's argmax nor "
                             "a near-tie of it")
    return int(((r[:, 3] == 0) & gap_ok).sum())


SPEC_COUNTED = ("gemm_l", "round_rows_bf16", "attn_block_l", "ffn_l", "gemv",
                "attend_step_batched_l", "attend_step_paged_l", "ffn_l_gemm")
# the kernels each single-stream mode must launch: the verify sweep's
# gemm_l (with its X rounding) always; a draft's steps the decode kernels
SPEC_MODE_KERNELS = {"draft": ("gemm_l", "round_rows_bf16", "attn_block_l", "ffn_l", "gemv"),
                     "lookup": ("gemm_l", "round_rows_bf16"),
                     "medusa": ("gemm_l", "round_rows_bf16")}


def phase_spec(cfg, fw, dev, kv_dtype) -> dict:
    """Speculation at full width (Mistral-7B shapes), single stream: plain
    greedy decode beside (a) a self-draft (a second Engine over the same
    weights), (b) a 2-layer draft of the same widths from another seed,
    greedy and at T 0.8, (c) prompt lookup on a 50-token pattern repeated 4
    times and (d) 4 Medusa heads from a seed, greedy and at T 0.8; 200-token
    prompts, 64 new tokens, K 4. Every token of a greedy stream is the plain
    step's argmax fed the same prefix, or a near-tie of it
    (teacher_forced_hold); every self-draft rejection falls at a row where
    the draft's token lies within twice the tolerance of the verify row's
    maximum; sampled streams give 64 valid ids. Per mode: rounds,
    proposals, acceptances, plain rounds, the decode rate, the device time
    of one verify sweep and of the draft's K+1 steps (torch.profiler), and
    the launch counts."""
    import numpy as np
    import torch
    from yalm_tpu_torch.engine import Engine, _bucket_for
    from yalm_tpu_torch.medusa import medusa_propose
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.tokenizer import Tokenizer
    from yalm_tpu_torch.utils.testing import synth_vocab

    tok = Tokenizer(synth_vocab(cfg.vocab_size), cfg.bos_token_id, cfg.eos_token_id)
    mk = lambda c, w: _fast(Engine(c, w, tok, kv_dtype=kv_dtype, device=dev))  # noqa: E731
    eng = mk(cfg, fw)
    rng = np.random.default_rng(8)
    prompts = {"random": [cfg.bos_token_id] + rng.integers(3, cfg.vocab_size, 199).tolist()}
    prompts["pattern"] = [cfg.bos_token_id] + rng.integers(3, cfg.vocab_size, 50).tolist() * 4
    K, N = SPEC_K, SPEC_NEW
    plain = {k: plain_greedy(eng, p, N) for k, p in prompts.items()}
    for k, rate in plain.items():
        log(f"  plain greedy ({k} prompt of {len(prompts[k])}): {rate:.2f} tok/s")
    cfg_d = with_layers(cfg, 2)
    draft2 = mk(cfg_d, synth_fast_weights(cfg_d, dev, seed=7))
    self_draft = mk(cfg, fw)
    mw = synth_medusa(cfg, dev, seed=9)
    eng.medusa = mw
    # (name, kind, prompt, draft, temperature)
    modes = (("self-draft", "draft", "random", self_draft, 0.0),
             ("2-layer draft", "draft", "random", draft2, 0.0),
             ("2-layer draft T 0.8", "draft", "random", draft2, 0.8),
             ("lookup", "lookup", "pattern", None, 0.0),
             ("medusa", "medusa", "random", None, 0.0),
             ("medusa T 0.8", "medusa", "random", None, 0.8))
    rejections: list = []
    accept = type(eng)._greedy_accept

    def recording(t_lg, d):
        emitted, a = accept(t_lg, d)
        if a < len(d):
            row = t_lg[a].float()
            tol = 1e-2 * max(1.0, float(row.abs().max()))
            rejections.append((float(row.max() - row[d[a]]), tol))
        return emitted, a
    eng._greedy_accept = recording
    out = dict(k=K, new_tokens=N, plain={k: dict(decode_tok_s=rate)
                                         for k, rate in plain.items()}, modes={})
    for name, kind, pk, draft, T in modes:
        eng.reset()
        if draft is not None:
            draft.reset()
        rejections.clear()
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        kw = dict(max_steps=N, temperature=T, seed=1234)
        stream = (eng.generate_medusa(prompts[pk], **kw) if kind == "medusa" else
                  eng.generate_speculative(prompts[pk], draft=draft, n_draft=K, **kw))
        got, t_first = [], None
        for t in stream:
            if t_first is None:
                t_first = time.perf_counter()
            got.append(t)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = {k: _build.LAUNCHES[k] for k in SPEC_COUNTED if _build.LAUNCHES[k]}
        st = dict(eng._spec_stats)
        st.setdefault("proposed", K * st["rounds"])
        st.setdefault("plain", 0)
        if len(got) != N or not all(0 <= t < cfg.vocab_size for t in got):
            raise AssertionError(f"spec {name}: bad stream {got[:8]}... ({len(got)})")
        missing = [k for k in SPEC_MODE_KERNELS[kind] if not launches.get(k)]
        if missing:
            raise AssertionError(f"spec {name}: kernels never launched: {missing}")
        r = dict(prompt=len(prompts[pk]), temperature=T, stats=st, launches=launches,
                 decode_tok_s=(N - 1) / (t_end - t_first), wall_s=t_end - t0,
                 accepted_per_round=st["accepted"] / st["rounds"] if st["rounds"] else None)
        if T == 0.0:
            r["forced_near_tie_flips"] = teacher_forced_hold(f"spec {name}", eng,
                                                             prompts[pk], got)
        if name == "self-draft":
            far = [(g, tol) for g, tol in rejections if g > 2 * tol]
            if far:
                raise AssertionError(f"self-draft rejections at rows that are no near-tie "
                                     f"(gap, tol): {far}")
            r["rejections"] = len(rejections)
        # one verify sweep (and the draft's K+1 steps) at the run's end position
        cur, bucket = got[-1], _bucket_for(K + 1)
        d = rng.integers(3, cfg.vocab_size, K).tolist()
        pos = eng.pos
        if pos + bucket < cfg.max_seq_len and T == 0.0:
            def sweep(mode="all_h" if kind == "medusa" else "all"):
                eng._verify(cur, d, bucket, mode)
                eng.pos = pos
            r["verify"] = profiled_call(sweep)
            r["verify_ms"] = r["verify"]["device_ms"]
            if draft is not None:
                dpos = draft.pos

                def steps():
                    draft._decode_block(cur, K + 1)
                    draft.pos = dpos
                r["draft_steps"] = profiled_call(steps)
                r["draft_steps_ms"] = r["draft_steps"]["device_ms"]
            if kind == "medusa":
                h = torch.randn(cfg.dim, device=dev)
                r["heads_ms"] = profiled_call(lambda: medusa_propose(mw, h))["device_ms"]
        out["modes"][name] = r
        log(f"  spec {name} ({r['prompt']}-token {pk} prompt, T {T}): {st['rounds']} rounds, "
            f"{st['proposed']} proposed, {st['accepted']} accepted "
            f"({r['accepted_per_round']} per round), {st['plain']} plain rounds; "
            f"{r['decode_tok_s']:.2f} tok/s (plain {plain[pk]:.2f})"
            + (f"; every token the plain step's argmax given the same prefix but "
               f"{r['forced_near_tie_flips']} near-ties" if T == 0.0 else "")
            + (f"; {r['rejections']} rejections, all at near-ties" if "rejections" in r else "")
            + (f"; one verify sweep {r['verify_ms']} ms on the device, "
               f"{r['verify']['wall_ms']:.3f} ms wall" if "verify_ms" in r else "")
            + (f", the draft's K+1 steps {r['draft_steps_ms']} ms on the device, "
               f"{r['draft_steps']['wall_ms']:.3f} ms wall" if "draft_steps_ms" in r else "")
            + (f", the heads {r['heads_ms']} ms" if "heads_ms" in r else "")
            + f"; launches {launches}")
        if name in ("self-draft", "medusa"):
            for where in ("top_device", "top_host"):
                for k, ms in r["verify"][where]:
                    log(f"    verify sweep, {where[4:]}: {ms:8.4f} ms  {k}")
    del eng, self_draft, draft2, mw
    torch.cuda.empty_cache()
    return out


def spec_serving_mix(cfg, n: int = 16):
    """16 requests of 64-512 prompt tokens and SPEC_SERVE_NEW new tokens:
    even ones greedy, odd ones at T 0.8 / top-p 0.9; every prompt a random
    block followed by a repeat of its last 40 tokens (prompt lookup has
    something to find); then a 17th, greedy, whose prompt of the window
    less 36 tokens (4060) runs its lane into the speculation edge (pos + K
    + 1 >= the window), so it leaves the spec path for plain subticks and
    crosses the window."""
    import numpy as np
    rng = np.random.default_rng(12)
    mix = []
    for i in range(n):
        m = int(rng.integers(24, 473))
        body = rng.integers(3, cfg.vocab_size, m).tolist()
        mix.append(([cfg.bos_token_id] + body + body[-40:], i % 2 == 1))
    mix.append(([cfg.bos_token_id] + rng.integers(3, cfg.vocab_size, cfg.max_seq_len - 37).tolist(),
                False))
    return mix


def near_tie_hold(name: str, ref: str, gap_tol, is_arg) -> int:
    """Every token is the reference row's argmax or lies within twice the
    tolerance (1e-2 of max(1, max|logit|)) of its maximum: gap_tol and
    is_arg (tokens, lanes). Returns the near-ties at which a stream differs
    from the reference argmax; raises where a token is neither."""
    bad = ((~is_arg) & (gap_tol > 2)).nonzero().tolist()
    if bad:
        raise AssertionError(f"{name}: (token, lane, gap/tol) "
                             f"{[(t, b, round(float(gap_tol[t, b]), 3)) for t, b in bad[:8]]} "
                             f"neither the {ref}'s argmax nor a near-tie of it")
    return int(((~is_arg) & (gap_tol <= 2)).sum())


def stream_gaps(rows, mix, streams):
    """(gap/tol, is argmax) of every greedy token (tokens, lanes) in the
    logits rows (tokens, lanes, vocab) that predict it."""
    import torch
    toks = torch.as_tensor([s for (_, sampled), s in zip(mix, streams) if not sampled],
                           device=rows.device).T
    tol = 1e-2 * rows.abs().amax(-1).clamp(min=1.0)
    gap = rows.amax(-1) - rows.gather(-1, toks[..., None])[..., 0]
    return (gap / tol).cpu(), (rows.argmax(-1) == toks).cpu()


def _route_rows(routes: dict, lane: int, positions, got) -> None:
    """routes[lane][position] = (experts (layers, k), router logits (layers,
    E)) of the rows of one call (got from gate_calls' took)."""
    if got is None:
        return
    d = routes.setdefault(lane, {})
    for r, pos in enumerate(positions):
        d[int(pos)] = (got[0][r], got[1][r])


@contextlib.contextmanager
def scheduler_routes(sched, raw: list):
    """While active: each admission chunk (per slot or batched) and tree
    sweep of the Scheduler sched appends, for every row it computes for a
    lane, (slot, the (position, token) pairs of the row and of its
    ancestors up to the tree's root, the experts it routed to (layers, k)
    and its router logits (layers, E)) to raw."""
    import numpy as np
    from yalm_tpu_torch import scheduler as S
    from yalm_tpu_torch.models.fast import tree_depths
    saved = {n: getattr(S, n) for n in ("prefill_fast", "prefill_chunk_fast_batched",
                                         "verify_tree_fast_batched")}
    with gate_calls() as took:
        def lane_chunk(cfg, w, tokens, pos0, valid_len, cache, *a, **kw):
            took(False)
            out = saved["prefill_fast"](cfg, w, tokens, pos0, valid_len, cache, *a, **kw)
            got = took()
            slot = next((b for b in range(sched.B)
                         if sched.cache.k[b].data_ptr() == cache.k.data_ptr()), None)
            for n in range(int(valid_len)) if got and slot is not None else ():
                raw.append((slot, [(int(pos0) + n, int(tokens[n]))], (got[0][n], got[1][n])))
            return out

        def chunk(cfg, w, tokens, pos0, vlen, enable, *a, **kw):
            took(False)
            out = saved["prefill_chunk_fast_batched"](cfg, w, tokens, pos0, vlen, enable, *a,
                                                      **kw)
            got = took()
            T = tokens.shape[1]
            for b in np.flatnonzero(enable) if got else ():
                for n in range(int(vlen[b])):
                    raw.append((int(b), [(int(pos0[b]) + n, int(tokens[b, n]))],
                                (got[0][b * T + n], got[1][b * T + n])))
            return out

        def tree(cfg, w, tokens, pos0, enable, cache, *, parents, **kw):
            took(False)
            out = saved["verify_tree_fast_batched"](cfg, w, tokens, pos0, enable, cache,
                                                    parents=parents, **kw)
            got = took()
            depth, Tn = tree_depths(parents), len(parents)
            for b in np.flatnonzero(enable) if got else ():
                for n in range(Tn):
                    path, m = [], n
                    while m >= 0:
                        path.append((int(pos0[b]) + depth[m], int(tokens[b, m])))
                        m = parents[m]
                    raw.append((int(b), path, (got[0][b * Tn + n], got[1][b * Tn + n])))
            return out
        S.prefill_fast, S.prefill_chunk_fast_batched, S.verify_tree_fast_batched = (
            lane_chunk, chunk, tree)
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(S, n, fn)


def stream_routes(raw: list, mix, streams) -> dict:
    """scheduler_routes' records resolved to the greedy requests: greedy lane
    -> position -> (experts (layers, k), router logits (layers, E)) of the
    row that computed the stream there (a row whose path's tokens are the
    stream's own); a slot is the lane whose prompt its admission rows
    carry."""
    greedy = [list(p) + list(s) for (p, sampled), s in zip(mix, streams) if not sampled]
    by_slot: dict = {}
    for b, path, ex in raw:
        by_slot.setdefault(b, []).append((path, ex))
    out: dict = {}
    for recs in by_slot.values():
        rows = [path[0] for path, _ in recs if len(path) == 1]   # prompt rows and roots
        lane = next((g for g, seq in enumerate(greedy)
                     if rows and all(p < len(seq) and seq[p] == t for p, t in rows)), None)
        if lane is None:
            continue   # a sampled request's slot
        seq, d = greedy[lane], out.setdefault(lane, {})
        for path, ex in recs:
            if all(p < len(seq) and seq[p] == t for p, t in path):
                d[path[0][0]] = ex
    return out


def routing_check(name: str, mix, run: dict, ref: dict, oracle: dict) -> dict:
    """The routing of a reference fed a run's tokens and routing
    (gate_calls(force=run)); run, ref and oracle map greedy lane ->
    position -> (experts (layers, k), router logits (layers, E)), the
    oracle the f32 one fed the same tokens and routing. Every reference row
    goes where the run's went, so each row whose own router logits choose
    other experts than the run did is a first difference, and every token
    after it stays held. Such a row must lie at a near-tie of the reference
    (router_gap), or the oracle must choose one side's experts or lie at a
    near-tie itself: a row where the oracle takes neither side raises. Over
    the stream's rows the two paths' median router distances to the oracle
    must lie within one tolerance of each other (the nearness rule of
    tests/test_torch_depth32.py): a path far from the oracle raises.
    Returns the rows compared, the (lane, position, layer) parting at a
    near-tie, the others (with the reference's gap, its router distance to
    the oracle and the run's in tolerances of the oracle's row, and the
    side the oracle takes), and the router distances of the reference to
    the run and of each to the oracle over the stream's rows: median and
    worst, in tolerances of the second's rows."""
    import numpy as np
    prompts = [len(p) for p, sampled in mix if not sampled]

    def dist(a, b):
        return np.abs(a - b).max(-1) / (1e-2 * np.maximum(1.0, np.abs(b).max(-1)))
    d: dict = {"reference to run": [], "reference to oracle": [], "run to oracle": []}
    near, settled, wrong, n = [], [], [], 0
    for g in sorted(run):
        for pos in sorted(set(run[g]) & set(ref.get(g, {}))):
            (ex_r, lg_r), (ex_c, lg_c) = run[g][pos], ref[g][pos]
            o = oracle.get(g, {}).get(pos)
            n += 1
            if pos >= prompts[g] - 1:
                d["reference to run"].append(dist(lg_c, lg_r))
                if o is not None:
                    d["reference to oracle"].append(dist(lg_c, o[1]))
                    d["run to oracle"].append(dist(lg_r, o[1]))
            k = ex_r.shape[-1]
            for lay in np.flatnonzero((ex_r != ex_c).any(-1)):
                gap = float(router_gap(lg_c[lay], k))
                if gap <= 2:
                    near.append((g, pos, int(lay)))
                    continue
                rec = (g, pos, int(lay), round(gap, 3))
                side = None
                if o is not None:
                    rec += (round(float(dist(lg_c[lay], o[1][lay])), 3),
                            round(float(dist(lg_r[lay], o[1][lay])), 3))
                    side = ("run" if (o[0][lay] == ex_r[lay]).all() else "reference"
                            if (o[0][lay] == ex_c[lay]).all() else "near-tie"
                            if router_gap(o[1][lay], k) <= 2 else None)
                (settled if side else wrong).append(rec + (side,))
    res = dict(rows=n, near_ties=near, past_a_near_tie=settled,
               router_distance={k: dict(median=float(np.median(v)), worst=float(np.max(v)))
                                for k, v in d.items() if v})
    far = (oracle and abs(res["router_distance"]["reference to oracle"]["median"]
                          - res["router_distance"]["run to oracle"]["median"]) > 1)
    if wrong or far:
        raise AssertionError(f"{name}: rows routed differently past a near-tie of the "
                             "reference where the f32 oracle takes neither side: (lane, "
                             "position, layer, the reference's gap/tol, the reference's and "
                             f"the run's router distance to the oracle/tol) {wrong}; or one "
                             f"path far from the oracle: {res}")
    return res


def tick_rows(cfg, fw, dev, kv_dtype, mix, streams, run=None):
    """The plain tick (decode_step_fast_batched) fed the greedy requests'
    own tokens after a per-lane prefill of each prompt, routed as run on an
    MoE cfg (gate_calls): the logits rows (tokens, lanes, vocab) f32 on the
    card, and the rows' own routing (greedy lane -> position -> (experts,
    router logits))."""
    import numpy as np
    import torch
    from yalm_tpu_torch.engine import attend_bucket, chunk_schedule
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.fast import decode_step_fast, decode_step_fast_batched, prefill_fast
    lanes = [(p, s) for (p, sampled), s in zip(mix, streams) if not sampled]
    B, L = len(lanes), cfg.max_seq_len
    routes: dict = {}
    cache = KVCache.init(cfg, kv_dtype, dev, batch=B)
    first = []
    with gate_calls(run) as took:
        for b, (p, _) in enumerate(lanes):
            lane, out, i = cache.lane(b), None, 0
            for i0, take, bucket in chunk_schedule(len(p), 0, L):
                padded = np.zeros(bucket, np.int64)
                padded[:take] = p[i0:i0 + take]
                took(False, [(b, i0 + n) if n < take else None for n in range(bucket)])
                out, _ = prefill_fast(cfg, fw, padded, i0, take, lane, logits_mode="last",
                                      attend_len=attend_bucket(i0 + bucket, L))
                _route_rows(routes, b, range(i0, i0 + take), took())
                i = i0 + take
            for j in range(i, len(p)):   # the ring regime: token by token
                took(False, [(b, j)])
                out, _ = decode_step_fast(cfg, fw, p[j], j, lane)
                _route_rows(routes, b, [j], took())
            first.append(out)
        rows = [torch.stack(first).float()]
        for j in range(len(lanes[0][1]) - 1):
            toks = torch.as_tensor([s[j] for _, s in lanes], device=dev)
            took(False, [(b, len(p) + j) for b, (p, _) in enumerate(lanes)])
            lg, _ = decode_step_fast_batched(cfg, fw, toks, [len(p) + j for p, _ in lanes],
                                             cache)
            got = took()
            for b, (p, _) in enumerate(lanes):
                if got is not None:
                    _route_rows(routes, b, [len(p) + j], (got[0][b:b + 1], got[1][b:b + 1]))
            rows.append(lg.float())
    return torch.stack(rows), routes


def chunk_rows(cfg, fw, dev, kv_dtype, mix, streams, run=None):
    """The chunk path (prefill_fast, logits "all", the verify sweeps'
    formulation) fed each greedy request's prompt and tokens, routed as run
    on an MoE cfg (gate_calls): the logits rows (tokens, lanes, vocab) f32
    on the card, and the rows' own routing (greedy lane -> position ->
    (experts, router logits)). Streams inside the window."""
    import numpy as np
    import torch
    from yalm_tpu_torch.engine import attend_bucket, chunk_schedule
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.fast import prefill_fast
    L = cfg.max_seq_len
    kept, routes = [], {}
    greedy = [(p, s) for (p, sampled), s in zip(mix, streams) if not sampled]
    with gate_calls(run) as took:
        for g, (p, s) in enumerate(greedy):
            seq = list(p) + list(s[:-1])
            lane, rows = KVCache.init(cfg, kv_dtype, dev), []
            for i0, take, bucket in chunk_schedule(len(seq), 0, L):
                padded = np.zeros(bucket, np.int64)
                padded[:take] = seq[i0:i0 + take]
                took(False, [(g, i0 + n) if n < take else None for n in range(bucket)])
                out, _ = prefill_fast(cfg, fw, padded, i0, take, lane, logits_mode="all",
                                      attend_len=attend_bucket(i0 + bucket, L))
                _route_rows(routes, g, range(i0, i0 + take), took())
                rows.append(out[:take])
            kept.append(torch.cat(rows)[len(p) - 1:].float())
    return torch.stack(kept, dim=1), routes


def teacher_forced_hold_batched(name: str, cfg, fw, dev, kv_dtype, mix, streams) -> int:
    """teacher_forced_hold for the greedy requests of a serving mix at once:
    the plain tick (tick_rows) fed each stream's own tokens after a
    per-lane prefill of its prompt. Returns the near-ties at which a stream
    differs from the plain argmax; raises where a token is neither."""
    rows, _ = tick_rows(cfg, fw, dev, kv_dtype, mix, streams)
    return near_tie_hold(name, "plain tick", *stream_gaps(rows, mix, streams))


def phase_spec_serving(cfg, fw, dev, kv_dtype) -> dict:
    """Speculation through ServingEngine at batch 16 (the server's defaults,
    top-5 logprobs): the spec_serving_mix through the plain scheduler, then
    prompt lookup (dense cache), a self-draft with a paged target (65 pages
    of 256; the draft's cache stays dense) and 4 Medusa heads (dense).
    Every greedy token is the plain tick's argmax fed the same tokens, or a
    near-tie of it (teacher_forced_hold_batched); every stream is exactly
    max_new_tokens long; two greedy ones carry their top-5 lists. Per run: spec_stats, the wall, K8's
    launches in the draft's ticks and K9's in the paged plain subticks
    (the 17th request's lane runs plain subticks past the edge)."""
    import torch
    from yalm_tpu_torch import server as srv
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.scheduler import Request
    from yalm_tpu_torch.tokenizer import Tokenizer
    from yalm_tpu_torch.utils.testing import synth_vocab

    tok = Tokenizer(synth_vocab(cfg.vocab_size), cfg.bos_token_id, cfg.eos_token_id)
    mix = spec_serving_mix(cfg)
    mw = synth_medusa(cfg, dev, seed=9)
    runs = (("plain", {}), ("lookup", dict(spec_lookup=True)),
            ("self-draft, paged", dict(spec_draft=(cfg, fw), paged_pages=PAGED_PAGES,
                                       page_size=PAGE)),
            ("medusa", dict(spec_medusa=mw)))
    out = {}
    for name, kw in runs:
        engine = srv.ServingEngine(cfg, fw, tok, batch=16, kv_dtype=kv_dtype, device=dev,
                                   spec_k=SPEC_K, **kw)
        sched = _fast(engine.sched)
        k8 = {"draft ticks": 0}
        if sched.draft_cfg is not None:
            propose = sched._draft_propose

            def counted(*a, **k):
                before = _build.LAUNCHES["attend_step_batched_l"]
                res = propose(*a, **k)
                k8["draft ticks"] += _build.LAUNCHES["attend_step_batched_l"] - before
                return res
            sched._draft_propose = counted
        k9 = {"plain subticks": 0}
        tick = sched._plain_tick

        def counted_tick(lanes):
            before = _build.LAUNCHES["attend_step_paged_l"]
            tick(lanes)
            k9["plain subticks"] += _build.LAUNCHES["attend_step_paged_l"] - before
        sched._plain_tick = counted_tick
        reqs = [Request(prompt_tokens=p, max_new_tokens=SPEC_SERVE_NEW,
                        temperature=0.8 if sampled else 0.0, top_p=0.9 if sampled else 1.0,
                        seed=300 + i) for i, (p, sampled) in enumerate(mix)]
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        while not all(r.done for r in reqs):
            time.sleep(0.005)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        engine.close()
        launches = {k: _build.LAUNCHES[k] for k in SPEC_COUNTED if _build.LAUNCHES[k]}
        bad = [(i, r.error, len(r.generated)) for i, r in enumerate(reqs)
               if r.error or len(r.generated) != SPEC_SERVE_NEW
               or not all(0 <= t < cfg.vocab_size for t in r.generated)]
        if bad:
            raise AssertionError(f"spec serving ({name}): failed requests {bad}")
        tops = [r for r, (_, sampled) in zip(reqs, mix) if not sampled][:2]
        if not all(len(r.top_logprobs) == SPEC_SERVE_NEW and all(len(t) == 5 for t in
                                                                  r.top_logprobs)
                   for r in tops):
            raise AssertionError(f"spec serving ({name}): top-5 logprobs missing")
        gen = sum(len(r.generated) for r in reqs)
        res = dict(wall_s=wall, generated=gen, tok_s=gen / wall, launches=launches,
                   ticks=engine.metrics["ticks_total"])
        if name != "plain":
            res.update(spec_stats=dict(sched.spec_stats),
                       k8_in_draft_ticks=k8["draft ticks"],
                       k9_in_plain_subticks=k9["plain subticks"],
                       forced_near_tie_flips=teacher_forced_hold_batched(
                           f"spec serving {name}", cfg, fw, dev, kv_dtype, mix,
                           [r.generated for r in reqs]))
            if sched.paged and not k9["plain subticks"]:
                raise AssertionError(f"spec serving ({name}): K9 never ran in a plain subtick")
            if sched.paged:
                res.update(preemptions=sched.preemptions, resumes=sched.resumes)
            if sched.spec_stats["rounds"] < 1:
                raise AssertionError(f"spec serving ({name}): no verify round")
            if sched.draft_cfg is not None and not k8["draft ticks"]:
                raise AssertionError(f"spec serving ({name}): K8 never ran in the draft ticks")
        out[name] = res
        log(f"  spec serving {name}: {len(reqs)} requests, {gen} tokens in {wall:.2f} s "
            f"({res['tok_s']:.1f} tok/s), {res['ticks']} ticks"
            + (f"; spec_stats {res['spec_stats']}, every greedy token "
               f"the plain tick's argmax given the same prefix but "
               f"{res['forced_near_tie_flips']} near-ties; K8 in the "
               f"draft ticks {res['k8_in_draft_ticks']}, K9 in paged plain subticks "
               f"{res['k9_in_plain_subticks']}" if name != "plain" else "")
            + (f"; {res['preemptions']} preemptions" if "preemptions" in res else "")
            + f"; launches {launches}")
        del engine, sched
        torch.cuda.empty_cache()
    return out


def phase_verify_parity(cfg, fw, dev, kv_dtype, paged: bool = False, B: int = 16) -> dict:
    """Phase 4, speculation: one verify sweep (with_hidden) of the depth-2
    model over B lanes of K+1 rows at mixed positions (3/4 enabled), card
    (kernels) vs CPU (plain versions) on caches that start random and
    equal, dense or through shuffled page tables: logits and hidden rows
    within 1e-2 of max(1, max|.|), the argmax equal on every decided lane
    row (top two more than twice the tolerance apart)."""
    import numpy as np
    import torch
    from yalm_tpu_torch.models import fast as M
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.paged import PagedKVPool

    cfg = depth2(cfg)
    fw2 = first_layers(fw, 2)
    fw_cpu = fw2.to("cpu")
    S, T = cfg.max_seq_len, SPEC_K + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    if paged:
        tables = shuffled_tables(B, S // PAGE, seed=13).numpy()
        card = PagedKVPool.init(cfg, kv_dtype, 1 + B * (S // PAGE), PAGE, dev)
        Cache = PagedKVPool
    else:
        card = KVCache.init(cfg, kv_dtype, dev, batch=B)
        Cache = KVCache
    for t in (card.k, card.v):
        t.copy_((torch.randn(t.shape, generator=gen, device=dev, dtype=torch.bfloat16)
                 * 0.5).to(kv_dtype))
    cpu = Cache(k=card.k.to("cpu", copy=True), v=card.v.to("cpu", copy=True))
    rng = np.random.default_rng(14)
    toks = rng.integers(3, cfg.vocab_size, (B, T))
    n_on = B - B // 4
    frac = np.linspace(0.0, 1.0, n_on)
    pos0 = np.concatenate([(frac * (S - T)).astype(np.int64), np.zeros(B - n_on, np.int64)])
    enable = np.array([1] * n_on + [0] * (B - n_on))
    outs = {}
    for name, w, c in (("cuda", fw2, card), ("cpu", fw_cpu, cpu)):
        if paged:
            (lg, hid), _ = M.verify_chunk_fast_batched_paged(cfg, w, toks, pos0, enable, c,
                                                             tables, page_size=PAGE,
                                                             with_hidden=True)
        else:
            (lg, hid), _ = M.verify_chunk_fast_batched(cfg, w, toks, pos0, enable, c,
                                                       with_hidden=True)
        outs[name] = (lg.float().cpu()[:n_on], hid.float().cpu()[:n_on])
    (g, gh), (c, ch) = outs["cuda"], outs["cpu"]
    worst = 0.0
    for what, a, b in (("logits", g, c), ("hidden", gh, ch)):
        err = float((a - b).abs().max())
        tol = 1e-2 * max(1.0, float(b.abs().max()))
        worst = max(worst, err / tol)
        if err > tol:
            raise AssertionError(f"verify sweep parity ({'paged' if paged else 'dense'}): "
                                 f"{what} max |err| {err:.3e} > tol {tol:.3e}")
    tol = 1e-2 * max(1.0, float(c.abs().max()))
    top2 = c.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
    flips = g.argmax(-1) != c.argmax(-1)
    if bool((flips & decided).any()):
        raise AssertionError("verify sweep parity: the argmax differs on a decided row")
    ties = int((~decided).sum())
    log(f"  {'paged' if paged else 'dense'} verify sweep (with_hidden), depth 2, {n_on} of {B} "
        f"lanes x {T} rows, card vs CPU plain: logits and hidden rows agree (worst err/tol "
        f"{worst:.3f}); argmax equal on all {decided.numel() - ties} decided rows ({ties} "
        "near-ties)")
    return dict(lanes=B, enabled=n_on, rows=T, worst_err_over_tol=worst, near_ties=ties)


TREE = (4, 2)          # the tree phase's branching: 13 nodes per lane
TREE_NEW = 48          # serving: 8 requests of 200 prompt tokens, 48 new
DEEP_TREE = (2, 2, 2, 2)
DEEP_NEW = 24          # deep accept: one lane, 200 prompt tokens, 24 new


def counted(fn):
    """(fn(), the kernel launches of that call): the counts are zeroed just
    before it and read just after."""
    from yalm_tpu_torch.ops.cuda import _build
    _build.LAUNCHES.clear()
    res = fn()
    return res, {k: v for k, v in _build.LAUNCHES.items() if v}


CHAIN_DEPTHS = (2, 8, 32)


def chain_tree_check(cfg, fw, dev, kv_dtype, rng) -> dict:
    """The chain tree (1, 1, 1, 1) through verify_tree_fast_batched beside
    verify_chunk_fast_batched on the same tokens and a copy of a random
    cache, 2 lanes with 200 and 3000 slots of history. The two are one
    computation up to the order of one f32 sum (the tree's softmax runs
    over the history and the tree's own rows apart), so after
    scatter_tree_rows of the whole path layer 0's K/V rows equal the chain
    sweep's bit for bit at every depth; the logits per row lie within 1e-2
    of max(1, max|logit|) at depth 2, and at every depth each row's argmax
    is the chain's or within twice that of its maximum (a near-tie): a
    regrouped sum moves a bf16 rounding of the next layer's input, and
    random layers amplify that with depth (the err/tol per depth is
    logged)."""
    import numpy as np
    import torch
    from yalm_tpu_torch.engine import attend_bucket
    from yalm_tpu_torch.models import fast as M
    from yalm_tpu_torch.models.cache import KVCache

    B, T = 2, 5
    chain = M.cartesian_tree((1,) * (T - 1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    tree_c = KVCache.init(cfg, kv_dtype, dev, batch=B)
    for t in (tree_c.k, tree_c.v):
        t.copy_((torch.randn(t.shape, generator=gen, device=dev, dtype=torch.bfloat16)
                 * 0.5).to(kv_dtype))
    chain_c = KVCache(k=tree_c.k.clone(), v=tree_c.v.clone())
    toks = rng.integers(3, cfg.vocab_size, (B, T))
    pos0, en = np.array([200, 3000]), np.ones(B, np.int64)
    attend = attend_bucket(int(pos0.max()) + T, cfg.max_seq_len)
    lt, (kt, vt) = M.verify_tree_fast_batched(cfg, fw, toks, pos0, en, tree_c, parents=chain,
                                              attend_len=attend)
    lc, _ = M.verify_chunk_fast_batched(cfg, fw, toks, pos0, en, chain_c, attend_len=attend)
    lt, lc = lt.float(), lc.float()
    tol = 1e-2 * lc.abs().amax(-1).clamp(min=1.0)
    ratio = (lt - lc).abs().amax(-1) / tol                         # (B, T)
    gap = lc.amax(-1) - lc.gather(-1, lt.argmax(-1, keepdim=True))[..., 0]
    if bool((gap > 2 * tol).any()) or (cfg.n_layers <= 2 and bool((ratio > 1).any())):
        raise AssertionError(f"chain tree vs chain sweep at depth {cfg.n_layers}: logits err/tol "
                             f"{ratio.tolist()}, argmax gaps {gap.tolist()}")
    M.scatter_tree_rows(tree_c, kt, vt, pos0, np.tile(np.arange(T), (B, 1)), np.full(B, T))
    for b in range(B):
        rows = slice(int(pos0[b]), int(pos0[b]) + T)
        for got, ref in ((tree_c.k, chain_c.k), (tree_c.v, chain_c.v)):
            if not torch.equal(got[b, 0, rows].view(torch.int16),
                               ref[b, 0, rows].view(torch.int16)):
                raise AssertionError("chain tree: layer 0's scattered rows differ from the "
                                     "chain sweep's")
    ties = int((lt.argmax(-1) != lc.argmax(-1)).sum())
    res = dict(lanes=B, rows=T, history=pos0.tolist(),
               worst_err_over_tol=[float(r) for r in ratio.amax(-1)], argmax_near_ties=ties)
    worst = [f"{r:.3f}" for r in res["worst_err_over_tol"]]
    log(f"  chain tree (1, 1, 1, 1) vs the chain sweep, depth {cfg.n_layers}, 2 lanes at "
        f"{pos0.tolist()}: worst logits err/tol per lane {worst}, argmax equal but {ties} "
        "near-ties; layer 0's scattered K/V rows equal bit for bit")
    return res


TREE_SERVE_DEPTHS = (32, 8)
# the chunk path's GEMMs on each weight path, which a tree serving run must launch
TREE_KERNELS = {"fp8": ("gemm_l", "round_rows_bf16"), "int4": ("gemm4_l", "round_rows_bf16"),
                "moe_fp8": ("gemm_l", "gemm_le", "round_rows_bf16")}


def oracle_rows(cfg, fw, dev, mix, streams, run=None):
    """The f32 oracle (models/transformer.py: f32 compute and attention, the
    weights widened per layer) fed each greedy request's prompt and tokens
    in one prefill, routed as run on an MoE cfg (gate_calls): the logits
    rows (tokens, lanes, vocab) f32 and the rows' own routing (greedy lane
    -> position -> (experts, router logits))."""
    import numpy as np
    import torch
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.transformer import prefill
    w = oracle_weights(cfg, fw)
    kept, routes = [], {}
    with gate_calls(run) as took:
        for g, (p, s) in enumerate((p, s) for (p, sampled), s in zip(mix, streams)
                                   if not sampled):
            seq = np.asarray(list(p) + list(s[:-1]))
            took(False, [(g, i) for i in range(len(seq))])
            o, _ = prefill(cfg, w, seq, 0, len(seq), KVCache.init(cfg, torch.float32, dev),
                           logits_mode="all")
            _route_rows(routes, g, range(len(seq)), took())
            kept.append(o[len(p) - 1:].float())
    del w
    torch.cuda.empty_cache()
    return torch.stack(kept, dim=1), routes


def oracle_compare(mix, streams, oracle, rows: dict, points) -> dict:
    """Each path's logits rows (rows: name -> (tokens, lanes, vocab)) against
    the f32 oracle's (oracle_rows) fed the same tokens: over every greedy
    token, the median and worst max |row - oracle| in units of the 1e-2
    tolerance of the oracle's row; at each (token, greedy lane) of points
    that distance, each path's argmax, the oracle's, and the stream token's
    gap below the oracle's maximum in the same units."""
    tol = 1e-2 * oracle.abs().amax(-1).clamp(min=1.0)                 # (tokens, lanes)
    err = {k: ((r - oracle).abs().amax(-1) / tol).cpu() for k, r in rows.items()}
    gap, _ = stream_gaps(oracle, mix, streams)
    out = dict(all={k: dict(median=float(e.median()), worst=float(e.max()))
                    for k, e in err.items()}, points=[])
    for j, b in points:
        rec = dict(token=j, lane=b, oracle_argmax=int(oracle[j, b].argmax()),
                   oracle_gap_of_token=float(gap[j, b]))
        for k, r in rows.items():
            rec[k] = dict(err_over_tol=float(err[k][j, b]), argmax=int(r[j, b].argmax()))
        out["points"].append(rec)
    return out


def tree_serving_run(cfg, fw, dev, kv_dtype, mw, mix, need=TREE_KERNELS["fp8"], **kw) -> dict:
    """The mix through a Scheduler at batch 8 with Medusa heads mw (tree
    Medusa with spec_tree in kw, else chain Medusa, K 4): every stream
    TREE_NEW valid ids, the kernels of need launched; every greedy token
    held to the chunk path fed the same prefix (chunk_rows: the formulation
    the verify and tree sweeps compute) by the near-tie rule, and to the
    plain tick (tick_rows) as well below 32 layers; at 32 layers the plain
    tick's gaps are recorded: there bf16 rounding, grown over 32 random
    layers, parts the chunk path and the tick past a near-tie in either
    mode (PERF.md §6). On MoE weights the run's routing is recorded
    (scheduler_routes) and every reference (the chunk path, the tick and
    the f32 oracle) is routed as the run was, so every token stays held;
    a reference's row whose own router logits choose other experts must lie
    at a near-tie, or the oracle must take one side or lie at a near-tie,
    and the two paths' router logits must lie as near the oracle as each
    other (routing_check). At 32 layers, and on MoE weights, the f32 oracle
    (oracle_rows) is fed the same tokens: each path's distance to it over
    every token, and at each token past a near-tie of the tick, each token
    after a row routed differently past a near-tie, and each lane's last
    token, says which path parted (oracle_compare)."""
    import torch
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.scheduler import Request, Scheduler
    sched = _fast(Scheduler(cfg, fw, batch=8, kv_dtype=kv_dtype, device=dev, spec_medusa=mw,
                            **kw))
    reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=TREE_NEW,
                                 temperature=0.8 if s else 0.0, top_p=0.9 if s else 1.0,
                                 seed=400 + i)) for i, (p, s) in enumerate(mix)]
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    raw: list = []
    t0 = time.perf_counter()
    with scheduler_routes(sched, raw) if cfg.is_moe else contextlib.nullcontext():
        sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    name = f"{'tree' if kw else 'chain'} serving at {cfg.n_layers} layers"
    bad = [(i, r.error, len(r.generated)) for i, r in enumerate(reqs)
           if r.error or len(r.generated) != TREE_NEW
           or not all(0 <= t < cfg.vocab_size for t in r.generated)]
    if bad:
        raise AssertionError(f"{name}: failed requests {bad}")
    if sched.spec_stats["rounds"] < 1:
        raise AssertionError(f"{name}: no verify round")
    # the tree's sampled lanes ride the plain tick (K8); chain Medusa verifies them
    missing = [k for k in need + (("attend_step_batched_l",) if kw else ())
               if not launches.get(k)]
    if missing:
        raise AssertionError(f"{name}: {missing} never launched")
    streams = [r.generated for r in reqs]
    tokens = sum(len(s) for s in streams)
    res = dict(requests=len(reqs), tokens=tokens, wall_s=wall, tok_s=tokens / wall,
               spec_stats=dict(sched.spec_stats), launches=launches)
    del sched
    deep = cfg.n_layers >= 32
    run = stream_routes(raw, mix, streams) if cfg.is_moe else None
    orows, oroutes = (oracle_rows(cfg, fw, dev, mix, streams, run) if deep or cfg.is_moe
                      else (None, {}))
    crows, croutes = chunk_rows(cfg, fw, dev, kv_dtype, mix, streams, run)
    trows, troutes = tick_rows(cfg, fw, dev, kv_dtype, mix, streams, run)
    if cfg.is_moe:
        for key, ref, routes in (("chunk", "chunk path", croutes), ("tick", "plain tick", troutes)):
            res[f"{key}_routing"] = routing_check(f"{name} vs the {ref}", mix, run, routes,
                                                  oroutes)
    gap, arg = stream_gaps(crows, mix, streams)
    res.update(greedy_tokens=gap.numel(),
               chunk_near_ties=near_tie_hold(name, "chunk path", gap, arg),
               chunk_worst_gap_over_tol=float(gap.max()))
    gap, arg = stream_gaps(trows, mix, streams)
    if not deep:
        res["tick_near_ties"] = near_tie_hold(name, "plain tick", gap, arg)
    beyond = ((~arg) & (gap > 2)).nonzero().tolist()
    res.update(tick_beyond=len(beyond), tick_worst_gap_over_tol=float(gap.max()))
    if orows is None:
        return res
    prompts = [len(p) for p, sampled in mix if not sampled]
    parted = sorted({(r[1] - prompts[r[0]] + 1, r[0]) for v in res.values()
                     if isinstance(v, dict) for r in v.get("past_a_near_tie", ())
                     if 0 <= r[1] - prompts[r[0]] + 1 < TREE_NEW})
    points = [tuple(p) for p in beyond] + [p for p in parted if list(p) not in beyond]
    points += [(TREE_NEW - 1, b) for b in range(gap.shape[1]) if (TREE_NEW - 1, b) not in points]
    res["oracle"] = oracle_compare(mix, streams, orows, {"chunk": crows, "tick": trows}, points)
    why = {**{tuple(p): "past a near-tie of the tick" for p in beyond},
           **{p: "after a row routed differently past a near-tie" for p in parted}}
    control = "control: the lane's last token"
    a = res["oracle"]["all"]
    log(f"    f32 oracle over all {gap.numel()} greedy tokens: chunk path median "
        f"{a['chunk']['median']:.3f} tol from it (worst {a['chunk']['worst']:.3f}), tick "
        f"{a['tick']['median']:.3f} (worst {a['tick']['worst']:.3f})")
    for rec in res["oracle"]["points"]:
        log(f"    f32 oracle at token {rec['token']} of greedy lane {rec['lane']} "
            f"({why.get((rec['token'], rec['lane']), control)}): "
            f"chunk path {rec['chunk']['err_over_tol']:.3f} tol from it, tick "
            f"{rec['tick']['err_over_tol']:.3f}; argmax oracle {rec['oracle_argmax']}, "
            f"chunk {rec['chunk']['argmax']}, tick {rec['tick']['argmax']}; the stream's "
            f"token {rec['oracle_gap_of_token']:.3f} tol below the oracle's maximum")
    return res


def tree_mix(cfg, rng) -> list:
    """The tree phases' requests: 8 prompts of 200 tokens, the 4th and 7th
    sampled."""
    return [([cfg.bos_token_id] + rng.integers(3, cfg.vocab_size, 199).tolist(), i in (3, 6))
            for i in range(8)]


def log_tree_serving(mode: str, depth: int, res: dict, kw: dict) -> None:
    form = f"tree {TREE}" if kw else "K 4"
    log(f"  {mode} Medusa serving ({form}), {depth} layers, batch 8, 4 random heads: "
        f"{res['requests']} requests (2 at T 0.8), {res['tokens']} tokens in "
        f"{res['wall_s']:.2f} s ({res['tok_s']:.1f} tok/s); spec_stats {res['spec_stats']}; "
        f"every one of the {res['greedy_tokens']} greedy tokens the chunk path's argmax "
        "given the same prefix but "
        f"{res['chunk_near_ties']} near-ties (worst gap/tol "
        f"{res['chunk_worst_gap_over_tol']:.3f}); "
        "against the plain tick "
        + (f"the same but {res['tick_near_ties']} near-ties" if "tick_near_ties" in res
           else f"{res['tick_beyond']} tokens past a near-tie (worst gap/tol "
                f"{res['tick_worst_gap_over_tol']:.3f}; not held at this depth)")
        + "".join(f"; routed as the run, the {k[:-8]} reference's own routing over "
                  f"{v['rows']} rows parts from the run's at {len(v['near_ties'])} near-ties "
                  f"and past a near-tie at {v['past_a_near_tie']} (lane, position, layer, "
                  "gap/tol, the reference's and the run's router distance to the f32 "
                  "oracle/tol, the side the oracle takes); router distances "
                  f"{v['router_distance']}"
                  for k, v in res.items() if k.endswith("_routing"))
        + f"; launches {res['launches']}")


TREE_PATH_DEPTHS = (2, 8)


def phase_tree_path(cfg, fw, dev, kv_dtype, path: str) -> dict:
    """Tree-attention Medusa on another weight path at its widths (packed
    int4: K5 gemm4_l and K7's GEMM route; MoE: K10 gemm_le at B x Tn rows):
    the chain tree against the chain sweep at depths 2 and 8
    (chain_tree_check) and the tree (4, 2) serving run at depth 8
    (tree_serving_run: every greedy token held to the chunk path and to the
    plain tick by the near-tie rule; on MoE weights both routed as the run,
    each routing difference at a near-tie or settled by the f32 oracle), as
    phase_tree runs them on fp8."""
    import numpy as np
    import torch
    rng = np.random.default_rng(22)
    out = {"chain": {n: chain_tree_check(with_layers(cfg, n), first_layers(fw, n), dev,
                                         kv_dtype, rng) for n in TREE_PATH_DEPTHS}}
    mw = synth_medusa(cfg, dev, seed=23)
    d = TREE_PATH_DEPTHS[-1]
    out["serving"] = tree_serving_run(with_layers(cfg, d), first_layers(fw, d), dev, kv_dtype,
                                      mw, tree_mix(cfg, rng), need=TREE_KERNELS[path],
                                      spec_tree=TREE)
    log_tree_serving("tree", d, out["serving"], dict(spec_tree=TREE))
    del mw
    torch.cuda.empty_cache()
    return out


def phase_tree(cfg, fw, dev, kv_dtype) -> dict:
    """Tree-attention Medusa at full width (Mistral-7B shapes, 32 layers):
    (a) the chain tree against the chain sweep at depths 2, 8 and 32
    (chain_tree_check); (b) a Scheduler at batch 8 with 4 random Medusa
    heads and the tree (4, 2) (13 nodes), at 32 layers and at 8: 8 requests
    of 200 tokens + 48, two at T 0.8, through tree_serving_run (every
    greedy token held to the chunk path, and at 8 layers to the plain tick,
    by the near-tie rule; at 32 layers chain Medusa beside it, the plain
    tick's gaps of both recorded); (c) one greedy lane on the tree (2, 2,
    2, 2) whose rank-2 candidates are the next tokens of its uninjected run
    (rank 1 wrong): the walk accepts to full depth and scatters 5 rows a
    round, every token held to the chunk path; (d) one tree sweep of (b)'s
    shape, its device and wall time (torch.profiler) and its launches."""
    import numpy as np
    import torch
    from yalm_tpu_torch.engine import attend_bucket
    from yalm_tpu_torch.models import fast as M
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.scheduler import Request, Scheduler

    out: dict = {}
    # (a) the chain tree is the chain sweep
    rng = np.random.default_rng(22)
    out["chain"] = {n: chain_tree_check(with_layers(cfg, n), first_layers(fw, n), dev,
                                        kv_dtype, rng) for n in CHAIN_DEPTHS}

    # (b) serving through the tree scheduler, at 32 layers and at 8
    mw = synth_medusa(cfg, dev, seed=23)
    mix = tree_mix(cfg, rng)
    out["serving"] = {}
    for depth in TREE_SERVE_DEPTHS:
        cfg_d, fw_d = with_layers(cfg, depth), first_layers(fw, depth)
        runs = [("tree", dict(spec_tree=TREE))]
        if depth == cfg.n_layers:   # chain Medusa beside it: the plain tick's gaps
            runs.append(("chain", {}))
        for mode, kw in runs:
            res = tree_serving_run(cfg_d, fw_d, dev, kv_dtype, mw, mix, **kw)
            out["serving"][f"{mode} {depth}"] = res
            log_tree_serving(mode, depth, res, kw)

    # (d) one tree sweep of the serving shape: its time and launches
    parents = M.cartesian_tree(TREE)
    Tn = len(parents)
    toks8 = rng.integers(3, cfg.vocab_size, (8, Tn))
    p8 = np.full(8, 248)
    en8 = np.ones(8, np.int64)
    att8 = attend_bucket(int(p8.max()) + 3, cfg.max_seq_len)

    cache8 = KVCache.init(cfg, kv_dtype, dev, batch=8)   # read only: its contents do not matter

    def sweep():
        M.verify_tree_fast_batched(cfg, fw, toks8, p8, en8, cache8, parents=parents,
                                   with_hidden=True, attend_len=att8)
    out["sweep_launches"] = counted(sweep)[1]
    out["sweep"] = profiled_call(sweep)
    out["sweep_ms"] = out["sweep"]["device_ms"]
    log(f"  one tree sweep (8 lanes x {Tn} nodes, {cfg.n_layers} layers, history {att8} slots): "
        f"{out['sweep_ms']} ms on the device, {out['sweep']['wall_ms']:.3f} ms wall; launches "
        f"{out['sweep_launches']}")
    for where in ("top_device", "top_host"):
        for k, ms in out["sweep"][where]:
            log(f"    tree sweep, {where[4:]}: {ms:8.4f} ms  {k}")
    del cache8

    # (c) deep accept: rank-2 candidates are the next tokens of the same
    # tree scheduler's own stream (an uninjected run, as tests/test_medusa.py
    # makes its reference), rank 1 wrong
    V, H = cfg.vocab_size, len(DEEP_TREE)
    prompt = mix[0][0]

    def deep_run(inject):
        sched = _fast(Scheduler(cfg, fw, batch=1, kv_dtype=kv_dtype, device=dev,
                                spec_medusa=mw, spec_tree=DEEP_TREE))
        r = sched.submit(Request(prompt_tokens=prompt, max_new_tokens=DEEP_NEW,
                                 temperature=0.0))
        per_round = []   # accepted a round: a + 1 rows are scattered into the ring
        while sched.queue or sched.n_active:
            before = sched.spec_stats["accepted"]
            sched.step()
            per_round.append(sched.spec_stats["accepted"] - before)
            s = sched.slots[0]
            n = len(r.generated)
            if inject and s.request is r and s.med_props and 0 < n and n + H <= len(stream):
                s.med_props = [[(stream[n + h] + 1) % V, stream[n + h]] for h in range(H)]
        return list(r.generated), per_round, dict(sched.spec_stats)
    stream, _, _ = deep_run(False)
    got, per_round, deep_stats = deep_run(True)
    full = sum(a == H for a in per_round)
    one = [(prompt, False)], [got]
    deep_flips = near_tie_hold("tree deep accept", "chunk path",
                               *stream_gaps(chunk_rows(cfg, fw, dev, kv_dtype, *one)[0], *one))
    if not full:
        raise AssertionError(f"tree deep accept: no round accepted the full depth {H} "
                             f"(accepted per round {per_round})")
    out["deep"] = dict(tree=DEEP_TREE, new_tokens=DEEP_NEW, rounds=deep_stats["rounds"],
                       accepted=deep_stats["accepted"], full_depth_rounds=full,
                       max_rows_scattered=max(per_round) + 1, equal_to_reference=got == stream,
                       forced_near_tie_flips=deep_flips)
    log(f"  deep accept, tree {DEEP_TREE}, one lane, {DEEP_NEW} tokens, rank-2 candidates the "
        f"uninjected run's next tokens: {deep_stats['rounds']} rounds, "
        f"{deep_stats['accepted']} accepted, {full} rounds at the full depth {H} ({H + 1} rows "
        f"scattered each); stream {'equals' if got == stream else 'differs from'} the "
        f"uninjected run's, every token the chunk path's argmax but {deep_flips} near-ties")
    del mw
    torch.cuda.empty_cache()
    return out


def oracle_weights(cfg, fw):
    """The parity oracle's Weights (models/weights.py) over the same
    FastWeights tensors (unscaled; dense, or MoE expert stacks (L, E, ...)
    and the router): wq/wk/wv and w1/w3 the views of the concatenated
    rows."""
    from yalm_tpu_torch.models.weights import LayerWeights, Weights
    q, kd, h = cfg.q_dim, cfg.kv_dim, cfg.hidden_dim
    lw = LayerWeights(rms_att=fw.rms_att, rms_ffn=fw.rms_ffn, wq=fw.wqkv[:, :q],
                      wk=fw.wqkv[:, q:q + kd], wv=fw.wqkv[:, q + kd:], wo=fw.wo,
                      w1=fw.w13[..., :h, :], w2=fw.w2, w3=fw.w13[..., h:, :],
                      moegate=fw.moegate, qn=fw.qnorm, kn=fw.knorm, pa=fw.pa, pf=fw.pf)
    return Weights(embed=fw.embed, layers=lw, final_norm=fw.final_norm, lm_head=fw.lm_head)


def phase_oracle(cfg, fw, dev, kv_dtype) -> dict:
    """The parity oracle on the card (the path's widths, 2 layers): the
    oracle (bf16 compute, the server's) and the kernels on the same weights,
    a 64-token prefill and 8 teacher-forced decode steps: the oracle's
    attention runs in f32 and the kernels' on bf16 operands, so every
    step's logits are held to the JAX package's oracle-vs-kernels bound
    (under 6e-2 of max(1, max|logit|), tests/test_debug.py:57) and the
    argmax to the oracle's or a near-tie of it, and the error over 1e-2 of
    max(1, max|logit|) is logged per step."""
    import numpy as np
    import torch
    from yalm_tpu_torch.engine import Engine

    cfg2 = with_layers(cfg, 2)
    fw2 = first_layers(fw, 2)
    fast_e = Engine(cfg2, fw2, kv_dtype=kv_dtype, device=dev)
    orc = Engine(cfg2, oracle_weights(cfg2, fw2), kv_dtype=kv_dtype, device=dev, fast=False,
                 compute_dtype=torch.bfloat16)
    if not fast_e.fast or orc.fast:
        raise AssertionError("oracle phase: the routes are not as asked")
    rng = np.random.default_rng(31)
    toks = rng.integers(3, cfg.vocab_size, 72).tolist()
    times, rows = {}, {}
    for name, e in (("kernels", fast_e), ("oracle", orc)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.prefill_tokens(toks[:64])
        out_rows = [e._last_logits]
        for t in toks[64:]:
            out_rows.append(e._step(t))
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        rows[name] = torch.stack(out_rows).float()
    ratios = []
    for i, (g, o) in enumerate(zip(rows["kernels"], rows["oracle"])):
        scale = max(1.0, float(o.abs().max()))
        err = float((g - o).abs().max())
        ratios.append(err / (1e-2 * scale))
        # the oracle's attention is f32 and the kernels' bf16 operands, so
        # the two are held by the JAX package's oracle-vs-kernels bound
        # (tests/test_debug.py:57) and the argmax or a near-tie
        if err >= 6e-2 * scale or not argmax_holds(g, o, 2e-2 * scale, True):
            raise AssertionError(f"oracle vs kernels, step {i}: max |err| {err:.3e} "
                                 f"(scale {scale:.3e}), argmax {int(g.argmax())} vs "
                                 f"{int(o.argmax())}")
    worst = max(ratios)
    log(f"  oracle (bf16 compute) vs kernels, 2 layers, {str(kv_dtype)[6:]} cache: 64-token "
        f"prefill and 8 decode steps: "
        f"logits err / (1e-2 of max(1, max|logit|)) per step {[f'{r:.3f}' for r in ratios]}, "
        f"under the 6e-2 bound, the argmax held; wall {times['kernels']:.3f} s on the kernels, "
        f"{times['oracle']:.3f} s on the oracle")
    del fast_e, orc
    return dict(steps=9, err_over_1e2_per_step=ratios, worst_err_over_tol=worst, wall_s=times)


def phase_oracle_mqa(cfg, dev, kv_dtype) -> dict:
    """A config the attention kernel refuses (cfg at 2 layers with one kv
    head: 32 queries x 128 = 4096 > 2048, MQA as in Falcon-7B, random fp8
    weights from a seed) takes the oracle under fast="auto" (fast=True
    names the limit) and completes a request through the Engine and one
    through the Scheduler."""
    import numpy as np
    import torch
    from yalm_tpu_torch.engine import Engine
    from yalm_tpu_torch.models.fast import fast_unsupported
    from yalm_tpu_torch.scheduler import Request, Scheduler
    rng = np.random.default_rng(32)
    mqa = dataclasses.replace(with_layers(cfg, 2), n_kv_heads=1)
    why = fast_unsupported(mqa)
    if not why or "2048" not in why:
        raise AssertionError(f"MQA: the kernels should refuse it, got {why!r}")
    w = oracle_weights(mqa, synth_fast_weights(mqa, dev, seed=33))
    try:
        Engine(mqa, w, kv_dtype=kv_dtype, device=dev, fast=True)
        raise AssertionError("MQA: fast=True did not raise")
    except ValueError as e:
        if "2048" not in str(e):
            raise
    eng = Engine(mqa, w, kv_dtype=kv_dtype, device=dev)
    prompt = [mqa.bos_token_id] + rng.integers(3, mqa.vocab_size, 63).tolist()
    got = list(eng.generate(prompt, max_steps=16, temperature=0.0))
    sched = Scheduler(mqa, w, batch=2, kv_dtype=kv_dtype, device=dev,
                      compute_dtype=torch.bfloat16)
    r = sched.submit(Request(prompt_tokens=prompt, max_new_tokens=16, temperature=0.0))
    sched.run()
    ok = (not eng.fast and not sched.fast and len(got) == 16 and len(r.generated) == 16
          and all(0 <= t < mqa.vocab_size for t in got + r.generated))
    if not ok:
        raise AssertionError(f"MQA oracle: fast {eng.fast}/{sched.fast}, {got}, {r.generated}")
    log(f"  one kv head ({why}): fast=\"auto\" takes the oracle; Engine and Scheduler each "
        f"complete a 64+16 greedy request ({sum(a == b for a, b in zip(got, r.generated))} of "
        "16 tokens equal between the f32 engine and the bf16 scheduler)")
    del eng, sched, w
    torch.cuda.empty_cache()
    return dict(reason=why, engine_tokens=len(got), scheduler_tokens=len(r.generated))


def phase_capture(cfg, fw, dev, kv_dtype) -> dict:
    """Debug capture on the card (the path's widths, 2 layers): the kernel
    path's capture (decode_step_fast(capture=True): gemv_l, attend_step_l in
    the path's form, gemv_le for each routed expert of an MoE path, gemv)
    against the oracle's (bf16 compute) over 3 steps, every tensor's
    diff_captures error under 6e-2 (tests/test_debug.py:57's bound; on an
    e5m2 cache whose bytes the two paths round one step apart, att_mix's
    against the oracle's attention over the kernels' cache bytes); the
    capture step's launches."""
    import torch
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.fast import decode_step_fast
    from yalm_tpu_torch.models.transformer import decode_step
    from yalm_tpu_torch.ops.attention import attend_one
    from yalm_tpu_torch.utils.debug import diff_captures

    cfg2 = with_layers(cfg, 2)
    fw2 = first_layers(fw, 2)
    w = oracle_weights(cfg2, fw2)
    co, cf = KVCache.init(cfg2, kv_dtype, dev), KVCache.init(cfg2, kv_dtype, dev)
    tok = 5
    for pos in range(3):
        _, co, cap_o = decode_step(cfg2, w, tok, pos, co, compute_dtype=torch.bfloat16,
                                   capture=True)
        (_, cf, cap_f), launches = counted(
            lambda: decode_step_fast(cfg2, fw2, tok, pos, cf, capture=True))
        tok = 3 + pos
    errs = diff_captures(cap_o, cap_f)
    flips: dict = {}
    if kv_dtype.itemsize == 1:
        # an e5m2 cache: a K/V value that the two paths compute on either
        # side of a rounding boundary is a byte one step (25%) apart
        # (e5m2_divergence checks that). att_mix is held to the bound
        # against the oracle's attention (attend_one, f32, its own q) over
        # the kernels' cache bytes, which the flipped bytes' own effect
        # parts from the oracle's att_mix; every other tensor as above.
        slot, n_flip = e5m2_divergence(cf, KVCache(k=co.k.cpu(), v=co.v.cpu()))
        if slot is not None:
            a, b = cap_o["att_mix"].float(), cap_f["att_mix"].float()
            scale = max(float(a.abs().max()), float(b.abs().max()), 1e-30)
            valid = torch.arange(cfg2.max_seq_len, device=dev) < 3   # the last step's slots
            qs = cap_o["q"].reshape(2, cfg2.n_kv_heads, -1, cfg2.head_dim)
            ref = torch.stack([attend_one(qs[i], cf.k[i], cf.v[i], valid, cfg2.attn_softcap)
                               .reshape(-1) for i in range(2)])
            errs["att_mix"] = float((b - ref).abs().max()) / scale
            flips = dict(bytes=n_flip, att_mix_per_layer=((a - b).abs().amax(-1) / scale).tolist(),
                         flips_own_per_layer=((a - ref).abs().amax(-1) / scale).tolist())
    bad = {k: e for k, e in errs.items() if not e < 6e-2}
    if bad or set(cap_f) != set(cap_o) or cap_f["block_out"].shape[0] != 2:
        raise AssertionError(f"capture: kernels vs oracle {errs}")
    need = ("gemv_l", "attend_step_l", "gemv") + (("gemv_le",) if cfg.is_moe else ())
    missing = [k for k in need if not launches.get(k)]
    if missing or launches.get("attn_block_l"):
        raise AssertionError(f"capture step: launches {launches}")
    worst = max(errs, key=errs.get)
    log(f"  capture, kernels vs oracle (bf16 compute), 2 layers, {str(kv_dtype)[6:]} cache, "
        f"3 steps: every tensor under 6e-2 (worst {worst} {errs[worst]:.3e})"
        + (f"; {flips['bytes']} cache bytes lie one e5m2 step apart: att_mix's error per "
           f"layer {[f'{e:.3e}' for e in flips['att_mix_per_layer']]}, the flipped bytes' "
           f"own effect {[f'{e:.3e}' for e in flips['flips_own_per_layer']]}; att_mix held "
           "against the oracle's attention over the kernels' bytes" if flips else "")
        + f"; one capture step's launches {launches}")
    return dict(errors=errs, e5m2_flips=flips, launches=launches)


def capture_refuses_int4(cfg4, fw4, dev, kv_dtype) -> None:
    """decode_step_fast(capture=True) on packed int4 weights raises."""
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.fast import decode_step_fast
    cfg2 = with_layers(cfg4, 2)
    try:
        decode_step_fast(cfg2, first_layers(fw4, 2), 5, 0, KVCache.init(cfg2, kv_dtype, dev),
                         capture=True)
    except ValueError as e:
        if "packed int4" not in str(e):
            raise
        log("  capture on packed int4 weights raises, as the JAX package's does")
        return
    raise AssertionError("capture on packed int4 weights did not raise")


def tree_phases() -> int:
    """The tree-attention Medusa, oracle and capture phases alone, for a
    short card call: the fp8 path's Mistral-7B weights (32 layers), then
    phase_tree, phase_oracle and phase_capture, and the int4 capture
    refusal on a 2-layer int4 model; then the other paths' calls of
    main(), on weights made at the depth they need: the tree phase on int4
    (e5m2 cache) and Mixtral fp8 (8 layers), capture on Mixtral fp8,
    Gemma3 (bf16 cache) and Gemma2 (e5m2 cache), the oracle on Gemma2's
    e5m2 cache (2 layers)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from yalm_tpu_torch.ops.cuda import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    cfg = mistral7b()
    fw = synth_fast_weights(cfg, dev, seed=0)
    out = {}
    with phase("phase 3 (fp8 path, bf16 cache): tree-attention Medusa (32 layers)"):
        out["tree"] = phase_tree(cfg, fw, dev, torch.bfloat16)
    with phase("phase 4 (fp8 path): the parity oracle on the card (2 layers)"):
        out["oracle"] = phase_oracle(cfg, fw, dev, torch.bfloat16)
        out["oracle_mqa"] = phase_oracle_mqa(cfg, dev, torch.bfloat16)
    with phase("phase 4 (fp8 path): debug capture, kernels vs oracle (2 layers)"):
        out["capture"] = phase_capture(cfg, fw, dev, torch.bfloat16)
    del fw
    e5 = torch.float8_e5m2
    cfg4 = mistral7b(n_layers=8, weight_dtype="int4")
    fw4 = synth_int4_weights(cfg4, dev, seed=1)
    with phase("phase 4 (int4 path): debug capture refuses packed int4"):
        capture_refuses_int4(cfg4, fw4, dev, e5)
    with phase("phase 3 (int4 path, e5m2 cache): tree-attention Medusa (depths 2 and 8)"):
        out["int4 tree"] = phase_tree_path(cfg4, fw4, dev, e5, "int4")
    del fw4
    cfgm = mixtral8x7b(n_layers=8)
    fwm = synth_moe_weights(cfgm, dev, seed=2)
    with phase("phase 3 (moe_fp8 path, bf16 cache): tree-attention Medusa (depths 2 and 8)"):
        out["moe_fp8 tree"] = phase_tree_path(cfgm, fwm, dev, torch.bfloat16, "moe_fp8")
    with phase("phase 4 (moe_fp8 path): debug capture, kernels vs oracle (2 layers)"):
        out["moe_fp8 capture"] = phase_capture(cfgm, fwm, dev, torch.bfloat16)
    del fwm
    for path, cfgg, kv, seed in (("gemma3", gemma3_12b(2), torch.bfloat16, 4),
                                 ("gemma2", gemma2_9b(2), e5, 5)):
        fwg = synth_fast_weights(cfgg, dev, seed=seed)
        if path == "gemma2":
            with phase(f"phase 4 ({path} path, e5m2 cache): the parity oracle (2 layers)"):
                out[f"{path} oracle"] = phase_oracle(cfgg, fwg, dev, kv)
        with phase(f"phase 4 ({path} path): debug capture, kernels vs oracle (2 layers)"):
            out[f"{path} capture"] = phase_capture(cfgg, fwg, dev, kv)
        del fwg
    torch.cuda.empty_cache()
    print(json.dumps(out, default=str), flush=True)
    return 0


def checkpoint_phases() -> int:
    """Phase 6 alone, for a short card call: the kernels and the native
    library built, then phase_checkpoint. Run from the repository root:
        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.checkpoint_phases())"
    """
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from yalm_tpu_torch.ops.cuda import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    with phase("phase 6: converted checkpoints from disk (native reader and tokenizer)"):
        out = phase_checkpoint(torch.device("cuda"))
    print(json.dumps(out), flush=True)
    return 0


def spec_phases() -> int:
    """The speculation phases alone, for a short card call: the fp8 path's
    Mistral-7B weights, then phase_spec (32 layers), phase_spec_serving (8
    layers) and the verify sweep's depth-2 parity (dense and paged)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from yalm_tpu_torch.ops.cuda import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    cfg = mistral7b()
    fw = synth_fast_weights(cfg, dev, seed=0)
    out = {}
    with phase("phase 3 (fp8 path, bf16 cache): speculation, single stream (32 layers)"):
        out["spec"] = phase_spec(cfg, fw, dev, torch.bfloat16)
    lay_s = MISTRAL_SERVING_LAYERS
    with phase(f"phase 3 (fp8 path, bf16 cache): speculation, serving at batch 16 "
               f"({lay_s} layers)"):
        out["spec_serving"] = phase_spec_serving(with_layers(cfg, lay_s),
                                                 first_layers(fw, lay_s), dev, torch.bfloat16)
    with phase("phase 4 (fp8 path): the verify sweep's depth-2 parity, card vs CPU"):
        out["verify_parity"] = phase_verify_parity(cfg, fw, dev, torch.bfloat16)
        out["verify_paged_parity"] = phase_verify_parity(cfg, fw, dev, torch.bfloat16,
                                                         paged=True)
    print(json.dumps(out), flush=True)
    return 0


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


def device_busy_us(prof, match=()) -> float:
    """The device's busy time (us) in a torch.profiler run: the union of its
    events' intervals (only those whose name contains a string of `match`,
    if given), so work that overlaps counts once -- K8/K9's second pass is
    a programmatic dependent launch, which starts before the first ends."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type != DeviceType.CPU
                   and (not match or any(m in e.name for m in match)))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def gemv_us(dev_us: dict) -> dict:
    """The device time (us) of csrc/gemv.cu's gemv_kernel in a profile, by
    its GLU template argument: {False: without the GLU pair, True: with}."""
    import re
    out = {False: 0.0, True: 0.0}
    for k, us in dev_us.items():
        m = re.search(r"gemv_kernel<([^<>]*)>", k)
        if m:
            out[m.group(1).split(",")[-1].strip() in ("true", "1", "(bool)1")] += us
    return out


def profile_decode(eng, n: int, quiet: bool = False) -> dict:
    """torch.profiler over n greedy decode steps (continuing the engine's
    sequence): wall time, device time by kernel, and the device's idle share
    (logged unless quiet)."""
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
    busy = device_busy_us(prof) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    gemv = gemv_us(dev_us)
    ffn_ms = sum(us for k, us in dev_us.items() if "ffn_kernel" in k) / n / 1e3
    r = dict(steps=n, context=eng.pos, wall_ms_per_step=wall / n * 1e3,
             device_ms_per_step=busy / n * 1e3,
             idle_share=(1 - busy / wall) if busy else None,
             gemv_ms_per_step=gemv[False] / n / 1e3, gemv_glu_ms_per_step=gemv[True] / n / 1e3,
             gemv_share=(gemv[False] + gemv[True]) / 1e6 / busy if busy else None,
             ffn_ms_per_step=ffn_ms, top=[(k[:60], v / n / 1e3) for k, v in top])
    if not busy:
        log("  profiler saw no device time: only the wall time is reported")
    if quiet:
        return r
    log(f"  decode profile at context {eng.pos}: {r['wall_ms_per_step']:.3f} ms/step wall, "
        f"{r['device_ms_per_step']:.3f} ms/step on the device, idle share {r['idle_share']}; "
        f"gemv_kernel {r['gemv_ms_per_step']:.3f} ms/step without GLU, "
        f"{r['gemv_glu_ms_per_step']:.3f} with, {r['gemv_share']} of the device time; "
        f"ffn_kernel (K4/K7, csrc/ffn.cu) {ffn_ms:.3f} ms/step")
    for k, ms in r["top"]:
        log(f"    {ms:8.4f} ms/step  {k}")
    return r


def phase_parity(cfg, fw, dev, kv_dtype, prompt: int = 64, steps: int = 8, toks=None,
                 fw_cpu=None) -> dict:
    """Phase 4: depth-2 model, card (kernels) vs CPU (plain versions): a
    prompt-token prefill chunk and `steps` teacher-forced decode steps
    (random tokens, or toks; the CPU's weights fw moved there, or fw_cpu),
    logits within 1e-2 of max(1, max|logit|) and the argmax held
    (argmax_holds). MoE steps that routing_holds names are held to nothing
    and counted. On an e5m2 cache a byte may differ between the two sides
    where the f32 rows straddle a rounding boundary (e5m2_divergence; a
    step is 25% of the element): an output outside the tolerance that such
    a byte reaches (its position at or past the first slot that differs)
    is held and counted; any other output outside it raises. The tolerance
    is the same for every output."""
    import numpy as np
    import torch
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.fast import decode_step_fast, prefill_fast

    cfg = depth2(cfg)
    fw2 = first_layers(fw, 2)
    fw_cpu = fw2.to("cpu") if fw_cpu is None else first_layers(fw_cpu, 2)
    if toks is None:
        toks = np.random.default_rng(5).integers(3, cfg.vocab_size, prompt + steps)
    worst = worst_flip = 0.0
    runs, caches = {}, {}
    with routing_log(cfg) as take, widened_once():
        for name, w, d in (("cuda", fw2, dev), ("cpu", fw_cpu, torch.device("cpu"))):
            cache = caches[name] = KVCache.init(cfg, kv_dtype, d)
            out = [prefill_fast(cfg, w, toks[:prompt], 0, prompt, cache, logits_mode="last")[0]]
            routes = [take()]
            for i in range(steps):  # teacher-forced decode
                out.append(decode_step_fast(cfg, w, int(toks[prompt + i]), prompt + i, cache)[0])
                routes.append(take())
            runs[name] = [o.float().cpu() for o in out]
            runs["routes " + name] = routes
    first, n_flip = (e5m2_divergence(caches["cuda"], caches["cpu"]) if kv_dtype.itemsize == 1
                     else (None, 0))
    tainted = np.zeros(1, bool)
    ties = held_n = flip_held = 0
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
        ok = err <= tol and argmax_holds(g, c, tol, bool(cfg.final_softcap))
        if not ok and first is not None and first <= prompt - 1 + step:
            flip_held += 1
            worst_flip = max(worst_flip, err / tol)
            continue
        worst = max(worst, err / tol)
        if not ok:
            raise AssertionError(f"depth-2 parity step {step}: max |err| {err:.3e} "
                                 f"(tol {tol:.3e}), argmax {int(g.argmax())} vs {int(c.argmax())}")
    log(f"  depth-{cfg.n_layers} logits, card vs CPU plain: {steps + 1} steps ({prompt}-token "
        "prefill) agree"
        + (f" ({held_n} held for routing: {ties} output rows routed near a tie, the rest "
           "reached by a row that routed differently)" if cfg.is_moe else "")
        + (f"; {n_flip} e5m2 cache bytes differ, the first at slot {first}, "
           f"{flip_held} outputs past the tolerance held for them (worst err/tol "
           f"{worst_flip:.3f})" if kv_dtype.itemsize == 1 else "")
        + f"; worst err/tol {worst:.3f}")
    return dict(steps=steps + 1, prompt=prompt, routing_near_ties=ties, routing_held=held_n,
                e5m2_first_flip=first, e5m2_bytes_differ=n_flip, e5m2_flip_held=flip_held,
                e5m2_flip_worst_err_over_tol=worst_flip, worst_err_over_tol=worst)


def phase_cli(dev) -> None:
    """Phase 5: the CLI modes as subprocesses on a small fp8 checkpoint
    (bf16 cache) and a small int4 one (e5m2 cache, `-C fp8`); a completion
    on a small fp8 MoE checkpoint (4 experts, 2 active). The seven runs
    start together (each spends most of its time starting Python and
    torch) and each is timed from the start to its own end."""
    from concurrent.futures import ThreadPoolExecutor
    from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config
    out_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    completion = ["-m", "completion", "-i", "hello world", "-n", "16", "-t", "0"]
    modes = (completion, ["-m", "perplexity", "-i", "hello world this is a test of the key"],
             ["-m", "passkey", "-n", "4", "-s", "1"])
    runs = []
    for wdt, moe, extra, args in (("fp8", {}, [], modes), ("int4", {}, ["-C", "fp8"], modes),
                                  ("fp8", dict(n_experts=4, n_experts_active=2), [],
                                   (completion,))):
        path = os.path.join(out_dir, f"tiny_{wdt}{'_moe' if moe else ''}.yalm")
        synth_checkpoint(path, tiny_config(dim=256, hidden_dim=512, head_dim=128,
                                           n_heads=4, n_kv_heads=2, vocab_size=512,
                                           max_seq_len=512, rotary_dim=128,
                                           weight_dtype=wdt, **moe), seed=3)
        cli = [sys.executable, "-m", "yalm_tpu_torch.cli", path, *extra]
        runs += [(wdt + (" MoE" if moe else ""), extra, cli + a) for a in args]

    def run(cmd):
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, timeout=600)
        return res, time.perf_counter() - t0
    with ThreadPoolExecutor(len(runs)) as pool:
        done = list(pool.map(run, [cmd for _, _, cmd in runs]))
    for (wdt, extra, cmd), (res, wall) in zip(runs, done):
        mode = cmd[cmd.index("-m", 3) + 1]
        # random weights emit arbitrary bytes (byte-fallback tokens)
        out, err = (res.stdout.decode(errors="replace"), res.stderr.decode(errors="replace"))
        tail = (out + err).strip().splitlines()[-3:]
        log(f"  cli {wdt} {' '.join(extra)} {mode}: rc {res.returncode} in {wall:.1f} s: "
            + " | ".join(tail))
        if res.returncode != 0:
            raise AssertionError(f"cli {wdt} {mode} failed:\n{out}\n{err}")


CKPT_TOKENIZER = os.path.join(ROOT, "tests", "fixtures", "llama_style_tokenizer.json")
CKPT_GOLDEN = os.path.join(ROOT, "tests", "fixtures", "tokenizer_golden.json")
CKPT_PROMPT, CKPT_NEW = 64, 32


def ckpt_text(golden: dict, nbytes: int = 4096) -> str:
    """A text of nbytes from the golden cases' strings and plain English."""
    text = ""
    while len(text.encode()) < nbytes:
        text += " ".join(c["text"] for c in golden["cases"]) + " The quick brown fox jumps. "
    return text.encode()[:nbytes].decode(errors="ignore")


def checkpoint_run(path: str, dev, key: str, kv_dtype) -> dict:
    """One converted checkpoint from disk: the native reader's tensors equal
    the pure reader's byte for byte; each reader's open plus
    load_fast_weights onto the card, timed; Engine.from_checkpoint on the
    card with the native tokenizer, which encodes the golden llama_style
    cases to HF's ids and a 4 KB text to the pure-Python BPE's ids; a
    CKPT_PROMPT-token prompt and CKPT_NEW greedy tokens through
    Engine.generate (TTFT, decode rate, the path's kernels launched), the
    stream's tokens teacher-forced on the card and on the CPU plain path of
    the same file (phase_parity's rule and tolerance)."""
    import numpy as np
    import torch
    from yalm_tpu_torch.codec.format import read_yalm
    from yalm_tpu_torch.config import ModelConfig
    from yalm_tpu_torch.engine import Engine
    from yalm_tpu_torch.models.fast import load_fast_weights
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.tokenizer import Tokenizer

    gb = os.path.getsize(path) / 1e9
    res: dict = dict(file_gb=gb)
    nat, py = read_yalm(path, native=True), read_yalm(path, native=False)
    if (nat._native is None or nat.metadata != py.metadata or nat.dtypes != py.dtypes
            or list(nat.tensors) != list(py.tensors)):
        raise AssertionError(f"{path}: the native reader's header differs from the pure one's")
    for k, a in py.tensors.items():
        b = nat.tensors[k]
        if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(
                a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)):
            raise AssertionError(f"{path}: tensor {k} differs between the readers")
    cfg = ModelConfig.from_metadata(py.metadata)
    n_tensors = len(py.tensors)
    nat.close()
    py.close()
    del nat, py
    log(f"  {os.path.basename(path)} ({gb:.3f} GB, {n_tensors} tensors): the native reader's "
        "tensors, dtypes tags and metadata equal the pure-Python reader's byte for byte")

    for mode, flag in (("native", True), ("python", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yf = read_yalm(path, native=flag)
        t_open = time.perf_counter() - t0
        fw = load_fast_weights(yf, cfg, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        yf.close()
        del fw, yf
        torch.cuda.empty_cache()
        res[f"load_{mode}"] = dict(open_s=t_open, open_and_load_s=wall, gb_per_s=gb / wall)
        log(f"  {mode} reader: open {t_open * 1e3:.1f} ms, open + load_fast_weights onto the "
            f"card {wall:.3f} s ({gb / wall:.2f} GB/s of file, page cache warm)")

    t0 = time.perf_counter()
    eng = _fast(Engine.from_checkpoint(path, device=dev, kv_dtype=kv_dtype))
    res["engine_load_s"] = time.perf_counter() - t0
    tok = eng.tokenizer
    if not tok.native:
        raise AssertionError("Engine.from_checkpoint: the tokenizer is not on the native path")
    with open(CKPT_GOLDEN) as f:
        golden = json.load(f)["llama_style"]
    bad = [c["text"] for c in golden["cases"] if tok.encode(c["text"]) != c["hf_ids"]]
    if bad:
        raise AssertionError(f"native BPE: golden cases off HF's ids: {bad}")
    text = ckpt_text(golden)
    yf = read_yalm(path)
    pure = Tokenizer.from_yalm(yf, native=False)
    yf.close()
    t0 = time.perf_counter()
    ids = tok.encode(text)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids_py = pure.encode(text)
    t_py = time.perf_counter() - t0
    if ids != ids_py:
        raise AssertionError("native BPE and pure-Python BPE differ on the 4 KB text")
    res["tokenizer"] = dict(golden_cases=len(golden["cases"]), text_bytes=len(text.encode()),
                            text_tokens=len(ids), native_ms=t_nat * 1e3, python_ms=t_py * 1e3)
    log(f"  Engine.from_checkpoint on the card in {res['engine_load_s']:.3f} s; native "
        f"tokenizer: {len(golden['cases'])} golden llama_style cases encode to HF's ids; a "
        f"{len(text.encode())}-byte text to the pure-Python BPE's {len(ids)} ids "
        f"({t_nat * 1e3:.2f} ms native, {t_py * 1e3:.2f} ms Python)")

    prompt = tok.encode(text, bos=True)[:CKPT_PROMPT]
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    stream, t_first = [], None
    for t in eng.generate(prompt, max_steps=CKPT_NEW, temperature=0.0):
        if t_first is None:
            t_first = time.perf_counter()
        stream.append(t)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    missing = [k for k in PATH_KERNELS[key] if not launches.get(k)]
    present = [k for k in PATH_ABSENT[key] if launches.get(k)]
    if (missing or present or len(stream) != CKPT_NEW
            or not all(0 <= t < cfg.vocab_size for t in stream)):
        raise AssertionError(f"generate: {len(stream)} tokens, launches {launches} (missing "
                             f"{missing}, unexpected {present})")
    res.update(ttft_s=t_first - t0, decode_tok_s=(CKPT_NEW - 1) / (t_end - t_first),
               launches=launches, stream=stream)
    log(f"  {CKPT_PROMPT}-token prompt + {CKPT_NEW} greedy tokens: TTFT "
        f"{res['ttft_s'] * 1e3:.1f} ms, decode {res['decode_tok_s']:.1f} tok/s; launches "
        f"{launches}")

    t0 = time.perf_counter()
    yf = read_yalm(path)
    fw_cpu = load_fast_weights(yf, cfg, "cpu")
    yf.close()
    res["parity"] = phase_parity(cfg, eng.weights, dev, kv_dtype, prompt=CKPT_PROMPT,
                                 steps=CKPT_NEW, toks=np.asarray(prompt + stream), fw_cpu=fw_cpu)
    res["parity_s"] = time.perf_counter() - t0
    log(f"  (the CPU's side: {res['parity_s']:.1f} s)")
    del eng, fw_cpu
    torch.cuda.empty_cache()
    return res


def phase_checkpoint(dev) -> dict:
    """Phase 6: a converted checkpoint from disk. The native library built
    from yalm_tpu_torch/native (build seconds logged); an HF-layout
    directory of random BF16 weights in two safetensors shards with
    tests/fixtures/llama_style_tokenizer.json (padded to the model's
    vocab): Mistral-7B widths at depth 2, converted to fp8 in process and
    to int4 through `python -m yalm_tpu_torch.convert`, then Mixtral-8x7B
    widths at depth 1 converted to fp8 (the expert stacking); each file
    through checkpoint_run (fp8: bf16 cache; int4: e5m2 cache; every greedy
    token held to the CPU); one CLI completion on the Mistral fp8 file. Every file is deleted at the
    end."""
    import torch
    from yalm_tpu_torch import native
    from yalm_tpu_torch.convert import convert
    from yalm_tpu_torch.utils.testing import synth_hf_dir

    t0 = time.perf_counter()
    lib = native.build()
    out: dict = dict(native_build_s=time.perf_counter() - t0)
    if not native.loaded():
        raise AssertionError(f"the native library {lib} did not load")
    log(f"  native library built and loaded in {out['native_build_s']:.1f} s ({lib})")
    work = os.path.join(ROOT, "build", "ckpt")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    e5 = torch.float8_e5m2
    models = (("mistral", mistral7b(2), "MistralForCausalLM", 60,
               (("fp8", "fp8", torch.bfloat16, "in process"),
                ("int4", "int4", e5, "cli"))),
              ("mixtral", mixtral8x7b(1), "MixtralForCausalLM", 61,
               (("fp8", "moe_fp8", torch.bfloat16, "in process"),)))
    try:
        for name, cfg, arch, seed, convs in models:
            hf = os.path.join(work, f"{name}-hf")
            t0 = time.perf_counter()
            synth_hf_dir(hf, cfg, seed=seed, arch=arch, dtype="bf16", shards=2,
                         tokenizer=CKPT_TOKENIZER, device=dev)
            hf_gb = sum(os.path.getsize(os.path.join(hf, f)) for f in os.listdir(hf)
                        if f.endswith(".safetensors")) / 1e9
            out[name] = dict(hf_gb=hf_gb, hf_write_s=time.perf_counter() - t0)
            log(f"  {name}: HF directory ({cfg.n_layers} layer(s) at full width, BF16, 2 shards, "
                f"{hf_gb:.3f} GB) written in {out[name]['hf_write_s']:.1f} s")
            for wdt, key, kv, how in convs:
                path = os.path.join(work, f"{name}-{wdt}.yalm")
                t0 = time.perf_counter()
                if how == "cli":
                    res = subprocess.run([sys.executable, "-m", "yalm_tpu_torch.convert",
                                          "--dtype", wdt, path, hf], cwd=ROOT,
                                         capture_output=True, text=True, timeout=600)
                    if res.returncode != 0:
                        raise AssertionError(f"convert CLI failed:\n{res.stdout}\n{res.stderr}")
                else:
                    convert(hf, path, wdt)
                conv_s = time.perf_counter() - t0
                gb = os.path.getsize(path) / 1e9
                log(f"  {name} -> {wdt} ({how}): {conv_s:.1f} s, {gb:.3f} GB written "
                    f"({hf_gb / conv_s:.2f} GB/s of input)")
                run = checkpoint_run(path, dev, key, kv)
                run.update(convert_s=conv_s, convert_how=how)
                out[name][wdt] = run
                if name == "mistral" and wdt == "fp8":
                    t0 = time.perf_counter()
                    res = subprocess.run([sys.executable, "-m", "yalm_tpu_torch.cli", path,
                                          "-m", "completion", "-i", "hello world", "-n", "16",
                                          "-t", "0"], cwd=ROOT, capture_output=True,
                                         timeout=600)
                    text = (res.stdout + res.stderr).decode(errors="replace")
                    if res.returncode != 0:
                        raise AssertionError(f"cli on the converted checkpoint failed:\n{text}")
                    log(f"  cli completion on {os.path.basename(path)}: rc 0 in "
                        f"{time.perf_counter() - t0:.1f} s: "
                        + " | ".join(text.strip().splitlines()[-2:]))
                os.remove(path)
            shutil.rmtree(hf)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def weight_gb(fw) -> float:
    """The weights' GB (a tied head counted once)."""
    ts = {id(t): t for t in (fw.embed, fw.wqkv, fw.wo, fw.w13, fw.w2, fw.lm_head, fw.moegate)
          if t is not None}
    return sum(t.numel() * t.element_size() for t in ts.values()) / 1e9


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


def gemm_phases() -> int:
    """The GEMM phases alone, for a short card call: phase 2 of the fp8
    path (every K1 gemm_l case and K4's GEMM route beside the design
    gemm_kernel replaced, with the other fp8 kernels), of the int4 path
    (every K5 gemm4_l case and K7's GEMM route beside gemm4_kernel_v1, with
    the other int4 kernels) and of the Mixtral fp8 and int4 paths (K10
    gemm_le, K11 gemm4_le), at full width. Run from the repository root:
        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.gemm_phases())"
    Prints the cases as one JSON line, then the card's name and power
    limit."""
    import torch
    from yalm_tpu_torch.ops.cuda import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    bench = Bench(HBM_BYTES_PER_S)
    for path, cfg, synth, phase_fn in (
            ("fp8", mistral7b(), synth_fast_weights, phase_kernels),
            ("int4", mistral7b(weight_dtype="int4"), synth_int4_weights, phase_kernels4),
            ("moe_fp8", mixtral8x7b(weight_dtype="fp8"), synth_moe_weights, phase_moe_kernels),
            ("moe_int4", mixtral8x7b(weight_dtype="int4"), synth_moe_weights,
             phase_moe_kernels)):
        fw = synth(cfg, dev, seed={"fp8": 0, "int4": 1, "moe_fp8": 2, "moe_int4": 3}[path])
        with phase(f"phase 2 ({path} path): kernels vs plain versions on the card"):
            phase_fn(bench, cfg, fw, dev)
        del fw
        torch.cuda.empty_cache()
    print(json.dumps({"cases": bench.rows}), flush=True)
    print(smi, flush=True)
    return 0


def gemv_phases() -> int:
    """The GEMV rows alone, for a short card call: phase 2's phase_gemv on
    the fp8, int4, Mixtral fp8, Mixtral int4 and Gemma3 paths at full width
    (every decode shape beside gemv_kernel_v1, the plain version and
    F.linear), the HMMA check of the SASS, and a profiler window that
    finds gemv_kernel by name and tells its GLU instances apart (phase 3's
    decode profiles split the GEMV time so). Run from the repository root:
        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.gemv_phases())"
    Prints the cases as one JSON line, then the card's name and power
    limit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.ops.cuda import gemv as G
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    check_hmma()
    x = torch.randn(2, 512, device=dev)
    w = torch.randn(1, 256, 512, device=dev).to(torch.float8_e5m2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        G.launch_gemv("check", x, w, 0)
        G.launch_gemv("check", x, w, 0, glu_act="silu")
        G.launch_gemv("check", x, w, 0, glu_act="silu")
        torch.cuda.synchronize()
    us = gemv_us(device_us(prof))
    if not (us[False] > 0 and us[True] > us[False] / 4):
        raise AssertionError(f"the profiler's gemv_kernel names were not told apart: "
                             f"{list(device_us(prof))}")
    log(f"  profiler: gemv_kernel found by name, {us[False]:.1f} us without GLU, "
        f"{us[True]:.1f} us with")
    bench = Bench(HBM_BYTES_PER_S)
    for path, cfg, synth in (("fp8", mistral7b(), synth_fast_weights),
                             ("int4", mistral7b(weight_dtype="int4"), synth_int4_weights),
                             ("moe_fp8", mixtral8x7b(weight_dtype="fp8"), synth_moe_weights),
                             ("moe_int4", mixtral8x7b(weight_dtype="int4"), synth_moe_weights),
                             ("gemma3", gemma3_12b(), synth_fast_weights)):
        fw = synth(cfg, dev, seed={"fp8": 0, "int4": 1, "moe_fp8": 2, "moe_int4": 3,
                                   "gemma3": 4}[path])
        bench.path = path
        with phase(f"{path} path: the GEMV at its decode shapes beside the old design"):
            phase_gemv(bench, cfg, fw, dev)
        del fw
        torch.cuda.empty_cache()
    print(json.dumps({"cases": bench.rows}), flush=True)
    print(smi, flush=True)
    return 0


def block_phases() -> int:
    """K3 and K6 alone, for a short card call: phase 2's phase_block on the
    fp8 path (bf16 cache) and the int4 path (e5m2 cache) at full width and
    depth -- the one launch at kv_len 1000 and at the full window against
    its plain version and bit for bit against the four launches it
    replaced, their times, its timeline, one kernel per call, the host time
    per call and a CUDA-graph replay. Run from the repository root:
        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.block_phases())"
    Prints the cases as one JSON line, then the card's name and power
    limit."""
    import torch
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.cuda import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    bench = Bench(HBM_BYTES_PER_S)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    for path, cfg, synth, kv in (
            ("fp8", mistral7b(), synth_fast_weights, torch.bfloat16),
            ("int4", mistral7b(weight_dtype="int4"), synth_int4_weights, torch.float8_e5m2)):
        fw = synth(cfg, dev, seed={"fp8": 0, "int4": 1}[path])
        cache = KVCache.init(cfg, kv, dev)
        for c in (cache.k, cache.v):
            c.copy_(torch.randn(c.shape, generator=gen, device=dev, dtype=torch.bfloat16))
        bench.path = path
        with phase(f"{path} path: the attention block as one launch beside the four launches"):
            phase_block(bench, cfg, fw, dev, cache, fw.scales if path == "int4" else None)
        del fw, cache
        torch.cuda.empty_cache()
    print(json.dumps({"cases": bench.rows}), flush=True)
    print(smi, flush=True)
    return 0


def ffn_phases() -> int:
    """K4 and K7 alone, for a short card call: phase 2's phase_ffn_rows at
    Mistral-7B widths (4 layers: each call still streams a cold layer of
    117 + 59 MB), fp8 and int4 at 1, 4, 8, 16 and 64 rows, Gemma3-12B's
    gelu at 1 and 16, and the tp=2 shard's hidden slice of 7168 at 1 and 16
    (fp8 and int4) -- the one launch against its plain version, bit for bit
    against the two GEMV launches up to 8 rows, beside the launches it
    replaced, its GLU rows, timeline, one kernel per call and a CUDA-graph
    replay; first the launches' floor at a width whose bytes take no time. Run from the repository root:
        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.ffn_phases())"
    Prints the cases as one JSON line, then the card's name and power
    limit."""
    import torch
    from yalm_tpu_torch.ops.cuda import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s (nvcc, all sources "
        "started together: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                         sorted(_build.BUILD_SECONDS.items())) + ")")
    bench = Bench(HBM_BYTES_PER_S)
    # the launches' floor: the one launch, one GEMV launch and the two at a
    # width whose bytes take no time (dim 256, hidden 256, one row, e5m2)
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.cuda.ffn import ffn
    tiny = with_layers(mistral7b(), 2, dim=256, hidden_dim=256)
    fw = synth_fast_weights(tiny, dev, seed=3)
    x = torch.randn(256, device=dev)
    kw = dict(norm_eps=tiny.norm_eps, act="silu")
    floor = dict(one=Bench.time_ms(lambda r: ffn(x, fw.rms_ffn, fw.w13, fw.w2, r % 2, **kw)),
                 gemv=Bench.time_ms(lambda r: G.launch_gemv("floor", x, fw.w2, r % 2)),
                 two=Bench.time_ms(lambda r: ffn_old(x, fw.rms_ffn, fw.w13, fw.w2, r % 2, **kw)))
    log("launch floor (dim 256, hidden 256, one row, e5m2): " +
        ", ".join(f"{k} {v:.4f} ms" for k, v in floor.items()))
    del fw
    tp2 = dict(hidden_dim=mistral7b().hidden_dim // 2)
    for path, cfg, synth, rows in (
            ("fp8", with_layers(mistral7b(), 4), synth_fast_weights, (1, 4, 8, 16, 64)),
            ("int4", with_layers(mistral7b(weight_dtype="int4"), 4), synth_int4_weights,
             (1, 4, 8, 16, 64)),
            ("gemma3", with_layers(gemma3_12b(), 4), synth_fast_weights, (1, 16)),
            ("mesh", with_layers(mistral7b(), 4, **tp2), synth_fast_weights, (1, 16)),
            ("mesh", with_layers(mistral7b(weight_dtype="int4"), 4, **tp2), synth_int4_weights,
             (1, 16))):
        fw = synth(cfg, dev, seed=3)
        bench.path = path
        with phase(f"{path} path: K4/K7 at hidden {cfg.hidden_dim}, {cfg.act_type}, one launch "
                   "beside the launches it replaced"):
            phase_ffn_rows(bench, cfg, fw, dev, rows, probes=True)
        del fw
        torch.cuda.empty_cache()
    print(json.dumps({"cases": bench.rows, "launch_floor_ms": floor}), flush=True)
    print(smi, flush=True)
    return 0


def mesh_cards() -> int:
    """Phase 7(b)'s holds on four cards, one NCCL rank each (a card call
    with four chips; not part of main(), which needs one card): Mistral-7B
    fp8 and int4 with tp=4 at 32 layers, Mixtral-8x7B fp8 with ep=4 at
    depth 4, the dense scheduler on dp=2 x tp=2 and on dp=4, and phase
    7(b)'s paged and speculative tp=2 runs on dp=2 x tp=2, each held to
    the single-device port on rank 0's card as in phase 7(b); then phase 8
    on the four cards (mesh8_cards). Correctness, as phases 7 and 8; the
    walls it logs are not a scaling measurement. Run from the repository
    root:
        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.mesh_cards())"
    Prints the runs as one JSON line, then the cards' names and power
    limits."""
    return _on_cards(lambda: {**phase_mesh_ranks(None, 4, "nccl", MESH_CARD_RUNS,
                                                 MESH_CARD_SCHED),
                              **phase_mesh8_ranks(None, 4, "nccl", CARD_RING_RUNS,
                                                  CARD_PP_RUNS, CARD_ORACLE_RUNS)})


def mesh8_cards() -> int:
    """Phase 8 on four cards, one NCCL rank each (the only place the ring's
    and the pipeline's shifts run on NCCL's send and receive): the ring
    prefill at sp=2 x tp=2 (Mistral-7B fp8, T 4096), the pipelined tick at
    pp=4 (16 lanes) and the sharded oracle at tp=4, each held to one device
    on rank 0's card as in phase 8. Run from the repository root:
        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.mesh8_cards())"
    """
    return _on_cards(lambda: phase_mesh8_ranks(None, 4, "nccl", CARD_RING_RUNS, CARD_PP_RUNS,
                                               CARD_ORACLE_RUNS))


def _on_cards(runs_of) -> int:
    """Build the kernels, run `runs_of()` on four cards, print its runs as
    one JSON line, then the cards' names and power limits."""
    import torch
    from yalm_tpu_torch.ops.cuda import _build
    if torch.cuda.device_count() < 4:
        print("chip_smoke: four CUDA GPUs needed", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    log(f"devices: {smi}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    with phase("four NCCL ranks, one per card"):
        runs = runs_of()
    print(json.dumps({"mesh_cards": runs}), flush=True)
    print("\n".join(smi), flush=True)
    return 0


def mesh_phases() -> int:
    """Phase 7 alone, for a short card call: (a) a world of one NCCL rank,
    (b) two gloo ranks sharing the card, (c) the kernels at shard shapes.
    Run from the repository root:
        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.mesh_phases())"
    Prints the cases and the runs as one JSON line, then the card's name
    and power limit."""
    import torch
    from yalm_tpu_torch.ops.cuda import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    bench = Bench(HBM_BYTES_PER_S)
    runs: dict = {}
    with phase("(a) a world of one NCCL rank"):
        runs["one"] = phase_mesh_one(dev)
    with phase("(b) two gloo ranks sharing the card"):
        runs.update(phase_mesh_ranks(torch.device("cuda", 0)))
    with phase("(c) the kernels at shard shapes"):
        phase_mesh_kernels(bench, dev)
    print(json.dumps({"cases": bench.rows, "mesh": runs}), flush=True)
    print(smi, flush=True)
    return 0


def attention_phases(lane_blocks=None) -> int:
    """K8 and K9 alone, for a short card call: phase 2's cases of the fp8
    path (bf16 cache), the int4 path (e5m2 cache) and the Gemma3 and Gemma2
    forms, each beside the design the lanes split replaced, and the
    sync-debug and CUDA-graph checks. lane_blocks: values of
    ops/cuda/attention.py's LANE_BLOCKS (the plan's chunk) to time the
    16-lane cases at, in turn. Run from the repository root:
        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.attention_phases())"
    Prints the cases as one JSON line, then the card's name and power
    limit."""
    import torch
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.ops.cuda import attention as A
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    bench = Bench(HBM_BYTES_PER_S)
    e5 = torch.float8_e5m2
    paths = (("fp8", mistral7b(), torch.bfloat16, {}), ("int4", mistral7b(), e5, {}),
             ("gemma3", gemma3_12b(), torch.bfloat16, dict(win=1024, alt=1)),
             ("gemma2", gemma2_9b(), e5, dict(win=4096, softcap=50.0)))
    saved = A.LANE_BLOCKS
    try:
        for blocks in lane_blocks or (saved,):
            A.LANE_BLOCKS = blocks
            for path, cfg, kv, form in paths:
                bench.path = f"{path} LANE_BLOCKS {blocks}"
                with phase(f"{path}: K8/K9 at LANE_BLOCKS {blocks}"):
                    phase_batched_attention(bench, cfg, dev, kv, form)
                    phase_paged_attention(bench, cfg, dev, kv, form,
                                          depths=None if path in ("fp8", "int4") else (4,))
        A.LANE_BLOCKS = saved
        for path, cfg, kv, _ in paths[:2]:
            phase_lanes_capture(cfg, dev, kv)
    finally:
        A.LANE_BLOCKS = saved
    print(json.dumps({"cases": bench.rows}), flush=True)
    print(smi, flush=True)
    return 0


def sass_functions(path: str) -> dict:
    """cuobjdump -sass of a library or cubin: each function's instructions
    (their text, without addresses and encodings), by its name without the
    anonymous namespace's hash, which changes with the source text."""
    import re
    from yalm_tpu_torch.ops.cuda import _build as B
    tool = os.path.join(os.path.dirname(B.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", line.split("Function :")[1].strip())
            out[fn] = []
        elif fn and line.strip().startswith("/*") and "*/" in line:
            ins = line.split("*/", 1)[1].split(";")[0].strip()
            if ins:
                out[fn].append(ins)
    return out


def split_sass(other_root: str) -> int:
    """Whether csrc/attention.cu's and csrc/gemv.cu's kernels (K2's and
    K12's split_scores_kernel / split_values_kernel, K8/K9's lanes kernels,
    the v1 attention design attend_step_kernel; gemv_kernel and
    gemv_kernel_v1) compile to the same SASS here as in another checkout of
    the repository (e.g. the parent commit unpacked into build/): each
    checkout's sources compiled to cubins with the build's nvcc flags, then
    compared function by function. Run from the repository root:
        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.split_sass('build/parent'))"
    Returns 0 when every such function is the same, 1 otherwise."""
    import tempfile
    from yalm_tpu_torch.ops.cuda import _build as B
    flags = [f for f in B.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    differ, same, n_ins = [], 0, 0
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for src in ("attention.cu", "gemv.cu"):
            sass = []
            for i, root in enumerate((ROOT, other_root)):
                cubin = os.path.join(tmp, f"{i}-{src}.cubin")
                subprocess.run([B.nvcc_path(), *flags, "-cubin",
                                os.path.join(root, "yalm_tpu_torch", "csrc", src), "-o", cubin],
                               check=True, timeout=600)
                sass.append(sass_functions(cubin))
            mine, theirs = sass
            for f in sorted(set(mine) | set(theirs)):
                if mine.get(f) is not None and mine.get(f) == theirs.get(f):
                    same += 1
                    n_ins += len(mine[f])
                else:
                    differ.append(f)
                    if f in mine and f in theirs:   # what changed, in instructions
                        import difflib
                        ops = difflib.SequenceMatcher(None, theirs[f], mine[f],
                                                      autojunk=False).get_opcodes()
                        log(f"  {f[:90]}: {len(theirs[f])} -> {len(mine[f])} instructions, "
                            + ", ".join(f"{tag} {i2 - i1}->{j2 - j1}"
                                        for tag, i1, i2, j1, j2 in ops if tag != "equal"))
    log(f"SASS: {same} functions the same ({n_ins} instructions), {len(differ)} differ or exist "
        f"on one side only: {differ}")
    return 0 if not differ and same else 1


# ---------------------------------------------------------------------------
# phase 7: meshes (parallel/): one NCCL rank, two gloo ranks on the card,
# the kernels at shard shapes
# ---------------------------------------------------------------------------

MESH_LAYERS = 4            # the two-rank runs' Mistral depth
MESH_MOE_LAYERS = 4        # and Mixtral's
MESH_PROMPT, MESH_NEW = 200, 64
MESH_TIMEOUT = 720         # seconds the two-rank world may take
# the two-rank engine runs; the scheduler runs follow on the fp8 weights
# (run, model, weights, mesh (dp, ep, tp), cache, seed, depth); Mixtral int4
# at depth 2 brings K11's launches, its logits held to the single device
MESH_RUNS = (("tp2_fp8", "mistral", "fp8", (1, 1, 2), "bf16", 40, MESH_LAYERS),
             ("tp2_int4", "mistral", "int4", (1, 1, 2), "fp8", 41, MESH_LAYERS),
             ("ep2_moe_fp8", "mixtral", "fp8", (1, 2, 1), "bf16", 42, MESH_MOE_LAYERS),
             ("ep2_moe_int4", "mixtral", "int4", (1, 2, 1), "fp8", 43, 2))
MESH_ORACLE_SLACK = 1.25   # how much further from the f32 oracle a mesh may be
MESH_GROUP_PAGES = 13      # pages of 256 per dp group: 12 usable for its 8 or 16 lanes
# the scheduler runs at batch 16, at MESH_LAYERS: (run, mesh (dp, ep, tp),
# weights, cache, options: paged, MESH_GROUP_PAGES a dp group, which must
# preempt; lookup, a draft of the target's first that many layers or that
# many random Medusa heads, K = SPEC_K)
MESH_SCHED = (("sched_dp2", (2, 1, 1), "fp8", "bf16", {}),
              ("sched_tp2", (1, 1, 2), "fp8", "bf16", {}),
              ("paged_dp2", (2, 1, 1), "fp8", "bf16", {"paged": True}),
              ("paged_tp2", (1, 1, 2), "fp8", "bf16", {"paged": True}),
              ("paged_int4_tp2", (1, 1, 2), "int4", "fp8", {"paged": True}),
              ("lookup_paged_tp2", (1, 1, 2), "fp8", "bf16", {"paged": True, "lookup": True}),
              ("draft_tp2", (1, 1, 2), "fp8", "bf16", {"draft": 2}),
              ("medusa_tp2", (1, 1, 2), "fp8", "bf16", {"medusa": 4}))
# the four-card runs of mesh_cards: one NCCL rank per card
MESH_CARD_RUNS = (("tp4_fp8", "mistral", "fp8", (1, 1, 4), "bf16", 40, 32),
                  ("tp4_int4", "mistral", "int4", (1, 1, 4), "fp8", 41, 32),
                  ("ep4_moe_fp8", "mixtral", "fp8", (1, 4, 1), "bf16", 42, MESH_MOE_LAYERS))
MESH_CARD_SCHED = (("sched_dp2_tp2", (2, 1, 2), "fp8", "bf16", {}),
                   ("sched_dp4", (4, 1, 1), "fp8", "bf16", {})) + tuple(
    (run.replace("tp2", "dp2_tp2"), (2, 1, 2), w, kv, o)
    for run, mc, w, kv, o in MESH_SCHED if o and mc == (1, 1, 2))


def greedy_rows(eng, prompt, n: int):
    """n greedy tokens from a reset engine after `prompt`, and the logits
    row each was picked from (n, vocab) on the host."""
    import torch
    eng.reset()
    eng.prefill_tokens(prompt, want_logits=True)
    lg, toks, rows = eng._last_logits, [], []
    for _ in range(n):
        toks.append(int(torch.argmax(lg)))
        rows.append(lg.float())
        lg = eng._step(toks[-1])
    return toks, torch.stack(rows).cpu()


def forced_rows(eng, prompt, toks):
    """The logits rows of `eng` fed prompt + toks (teacher forcing), on the
    host."""
    import torch
    eng.reset()
    eng.prefill_tokens(prompt, want_logits=True)
    lg, rows = eng._last_logits, []
    for t in toks:
        rows.append(lg.float())
        lg = eng._step(t)
    return torch.stack(rows).cpu()


def over_tol(a, b) -> float:
    """The largest |a - b| over 1e-2 of max(1, max|b|), row by row."""
    return float(((a - b).abs().amax(-1) / (1e-2 * b.abs().amax(-1).clamp(min=1.0))).max())


def oracle_of(cfg, fw):
    """The parity oracle's Weights of dense FastWeights: views of fp8 ones
    (oracle_weights); packed int4 ones dequantized to f32 (the int8
    embedding and head with their row scales)."""
    import torch
    from yalm_tpu_torch.models.fast import FastWeights
    from yalm_tpu_torch.ops.cuda import gemv as G
    if not G.is_int4(fw.wqkv):
        return oracle_weights(cfg, fw)
    sc = fw.scales
    f32 = lambda w, s: dequant4(w, s, torch.float32)  # noqa: E731
    return oracle_weights(cfg, FastWeights(
        embed=fw.embed.float() * sc.embed[:, None], rms_att=fw.rms_att, rms_ffn=fw.rms_ffn,
        wqkv=f32(fw.wqkv, sc.wqkv), wo=f32(fw.wo, sc.wo), w13=f32(fw.w13, sc.w13),
        w2=f32(fw.w2, sc.w2), final_norm=fw.final_norm,
        lm_head=fw.lm_head.float() * sc.lm_head[:, None]))


def mesh_rows_hold(name: str, cfg, fw, dev, kv, items, oracle: bool) -> dict:
    """A mesh run's streams against the single-device engine on the same
    weights fed the same tokens. items: (prompt, tokens, the mesh's logits
    row each token was drawn from (n, vocab), top_k or None for greedy).
    Each token is its own row's argmax (greedy) or among its k largest
    (the sampler's envelope); the logits are within 1e-2 of max(1,
    max|logit|) of the single device's rows (over_tol); where they are not
    and `oracle` allows (dense models: at full width and depth two correct
    summation orders part past 1e-2, as the single device parts from the
    oracle), no further from the f32 parity oracle fed the same tokens, on
    a cache of the same type, than MESH_ORACLE_SLACK times the single
    device's own distance to it. near_ties counts the greedy tokens that
    are not the single device's argmax."""
    import torch
    from yalm_tpu_torch.engine import Engine
    ref_eng = _fast(Engine(cfg, fw, device=dev, kv_dtype=kv))
    refs, ties = [], 0
    for prompt, toks, rows, k in items:
        t = torch.as_tensor(toks)
        own = (rows.argmax(-1) == t) if k is None else (
            rows.gather(1, t[:, None])[:, 0] >= rows.topk(k, dim=-1).values[:, -1])
        if not bool(own.all()):
            raise AssertionError(f"{name}: a token outside its own logits row's "
                                 + ("argmax" if k is None else f"top {k}"))
        refs.append(forced_rows(ref_eng, prompt, toks))
        if k is None:
            ties += int((refs[-1].argmax(-1) != t).sum())
    del ref_eng
    r = dict(near_ties=ties, mesh_vs_single=max(over_tol(it[2], ref)
                                                for it, ref in zip(items, refs)))
    if r["mesh_vs_single"] <= 1:
        return r
    if not oracle:
        raise AssertionError(f"{name}: logits {r['mesh_vs_single']:.2f} x the tolerance from "
                             "the single-device engine's")
    orc_eng = Engine(cfg, oracle_of(cfg, fw), device=dev, fast=False, kv_dtype=kv)
    orcs = [forced_rows(orc_eng, prompt, toks) for prompt, toks, _, _ in items]
    r.update(mesh_vs_oracle=max(over_tol(it[2], o) for it, o in zip(items, orcs)),
             single_vs_oracle=max(over_tol(ref, o) for ref, o in zip(refs, orcs)))
    bar = max(1.0, MESH_ORACLE_SLACK * r["single_vs_oracle"])
    if r["mesh_vs_oracle"] > bar:
        raise AssertionError(f"{name}: {r['mesh_vs_oracle']:.2f} x the tolerance from the f32 "
                             f"oracle, past {bar:.2f} (the single device: "
                             f"{r['single_vs_oracle']:.2f})")
    return r


def recorded_rows(sched) -> dict:
    """On a mesh scheduler's leader: every request's logits rows, in order,
    as the scheduler draws its tokens from them (the first from its last
    prefill chunk, the rest from the ticks it writes in, and in a
    speculative round from the verify sweep's rows 0..a of its lane, a
    proposal accepted at row i and the correction at row a), on the host."""
    import torch
    rows: dict = {}
    lanes = sched.lanes
    tick, prefill, verify, round_ = lanes.tick, lanes.prefill, lanes.verify, None
    swept: dict = {}

    def on_tick(tokens, positions, write, tables=None):
        lg = tick(tokens, positions, write, tables)
        on = [b for b, w in enumerate(write) if w]
        for b, row in zip(on, lg[torch.as_tensor(on, device=lg.device)].float().cpu()):
            rows.setdefault(id(sched.slots[b].request), []).append(row)
        return lg

    def on_prefill(b, padded, pos0, take, mode, attend, *paged):
        out = prefill(b, padded, pos0, take, mode, attend, *paged)
        if out is not None:
            rows.setdefault(id(sched.slots[b].request), []).append(out.float().cpu())
        return out

    def on_verify(tokens, pos0, enable, with_hidden, attend, tables=None):
        out = verify(tokens, pos0, enable, with_hidden, attend, tables)
        swept["rows"] = (out[0] if with_hidden else out).float().cpu()
        return out

    def on_round(elig, props):
        reqs = {b: sched.slots[b].request for b in elig}
        before = {b: len(r.generated) for b, r in reqs.items()}
        round_(elig, props)
        for b, r in reqs.items():
            rows.setdefault(id(r), []).extend(swept["rows"][b, :len(r.generated) - before[b]])
    lanes.tick, lanes.prefill, lanes.verify = on_tick, on_prefill, on_verify
    if sched.spec:
        round_, sched._verify_round = sched._verify_round, on_round
    return rows


def mesh_prompt(cfg, n: int, seed: int) -> list:
    import numpy as np
    rng = np.random.default_rng(seed)
    return [cfg.bos_token_id] + rng.integers(3, cfg.vocab_size, n - 1).tolist()


def phase_mesh_one(dev) -> dict:
    """7(a): a world of one NCCL rank (the multi-GPU code path with one
    card): an all-reduce on the world, then Mistral-7B fp8 at 32 layers
    through Engine(mesh=): 200 + 64 greedy tokens held to the
    single-device engine on the same weights (mesh_rows_hold, strict: the
    same launches, so the same logits are expected) and the per-step
    wall and device time of both (profile_decode, 16 steps at the same
    context, three of each alternating, the medians), with the mesh
    run's launches; then the CLI with -M 1,1,1
    under torch.distributed.run with one process."""
    import torch
    import torch.distributed as dist
    from yalm_tpu_torch.engine import Engine
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.parallel.distributed import initialize
    from yalm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config

    initialize(num_processes=1)   # nccl: the card's backend
    try:
        mesh = make_mesh(MeshConfig(), device=dev)
        t = torch.ones(4, device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        if mesh.backend != "nccl" or not bool((t == 1).all()):
            raise AssertionError(f"the world of one: backend {mesh.backend}, all-reduce {t}")
        cfg = mistral7b()
        fw = synth_fast_weights(cfg, dev, seed=0)
        prompt = mesh_prompt(cfg, MESH_PROMPT, 7)
        meng = _fast(Engine(cfg, fw, mesh=mesh))
        ref = _fast(Engine(cfg, fw, device=dev))
        _build.LAUNCHES.clear()
        toks, rows = greedy_rows(meng, prompt, MESH_NEW)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        for k in ("attn_block_l", "ffn_l", "gemv", "gemm_l"):
            if not launches.get(k):
                raise AssertionError(f"the mesh engine launched no {k}: {launches}")
        hold = mesh_rows_hold("mesh 1,1,1 fp8", cfg, fw, dev, torch.bfloat16,
                              [(prompt, toks, rows, None)], oracle=False)
        # three profiles of each, alternating: the host's noise is larger
        # than what the hook could cost
        prof: dict = {"single": [], "mesh": []}
        for _ in range(3):
            for name, eng in (("single", ref), ("mesh", meng)):
                eng.reset()
                eng.prefill_tokens(prompt, want_logits=True)
                prof[name].append(profile_decode(eng, 16))
        med = {n: {k: statistics.median(p[k] for p in ps)
                   for k in ("wall_ms_per_step", "device_ms_per_step")}
               for n, ps in prof.items()}
        prof["median"] = med
        log(f"  mesh 1,1,1 (nccl, 32 layers): {MESH_NEW} greedy tokens held to the single "
            f"device (logits {hold['mesh_vs_single']:.3f} of the tolerance, "
            f"{hold['near_ties']} near-ties); per step, the median of 3 alternating profiles: "
            f"wall {med['mesh']['wall_ms_per_step']:.3f} ms (single device "
            f"{med['single']['wall_ms_per_step']:.3f}), device "
            f"{med['mesh']['device_ms_per_step']:.3f} ms (single device "
            f"{med['single']['device_ms_per_step']:.3f})")
        del meng, ref, fw, rows
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "tiny_fp8_mesh.yalm")
    synth_checkpoint(path, tiny_config(dim=256, hidden_dim=512, head_dim=128, n_heads=4,
                                       n_kv_heads=2, vocab_size=512, max_seq_len=512,
                                       rotary_dim=128, weight_dtype="fp8"), seed=3)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "1", "-m", "yalm_tpu_torch.cli", path, "-M",
                          "1,1,1", "-i", "hello world", "-n", "16", "-t", "0"],
                         cwd=ROOT, capture_output=True, timeout=300)
    out = res.stdout.decode(errors="replace") + res.stderr.decode(errors="replace")
    if res.returncode != 0 or "Generation stats" not in out:
        raise AssertionError(f"cli -M 1,1,1 under torch.distributed.run failed:\n{out}")
    log(f"  cli -M 1,1,1 under torch.distributed.run (1 process): rc 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, hold=hold, profile=prof)


def mesh_weights_of(model: str, wdt: str, dev, seed: int, depth: int):
    """(cfg, whole single-device FastWeights) of a two-rank run, made on
    the card from a seed (the same bytes on both ranks)."""
    cfg = with_layers((mistral7b if model == "mistral" else mixtral8x7b)(weight_dtype=wdt),
                      depth)
    return cfg, (synth_moe_weights if cfg.is_moe else
                 synth_int4_weights if wdt == "int4" else synth_fast_weights)(cfg, dev, seed)


def mesh_sched_mix(cfg, seed: int = 5) -> list:
    """Phase 3's serving mix cut to fit: 20 requests of 64-512 prompt tokens
    and 16-32 new, half sampled (T 0.8, top-p 0.9, top-k 40), two sharing
    a 256-token prefix."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = mesh_prompt(cfg, 256, seed + 1)
    mix = []
    for i in range(20):
        n = int(rng.integers(64, 513))
        p = (prefix + mesh_prompt(cfg, 64, i)[1:]) if i in (0, 17) else mesh_prompt(cfg, n, i)
        s = i % 2 == 1
        mix.append(dict(prompt_tokens=p, max_new_tokens=int(rng.integers(16, 33)),
                        temperature=0.8 if s else 0.0, top_p=0.9 if s else 1.0,
                        top_k=40 if s else 0, seed=100 + i))
    return mix


def mesh_rank(args: dict) -> dict:
    """7(b), one of two gloo ranks sharing the card (run_ranks; or, through
    mesh_cards, one NCCL rank per card): each engine run of args["runs"]
    (MESH_RUNS) and each scheduler run of args["sched"] (MESH_SCHED) on a
    mesh of the world, the launch counts of each (rank 0's from the mesh
    run alone),
    and on rank 0 the holds against the single-device port on the same
    weights by mesh_rows_hold: an engine run's 200 + 64 greedy tokens and
    the logits rows they came from; a scheduler run's every stream with
    the rows the leader drew it from (recorded_rows), and the share of its
    tokens equal to the single-device scheduler's."""
    import torch
    import torch.distributed as dist
    from yalm_tpu_torch.engine import Engine
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.parallel.fast_tp import shard_fast_tp_weights
    from yalm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from yalm_tpu_torch.scheduler import Request, Scheduler

    from yalm_tpu_torch.parallel.mesh import mesh_device
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh_device(args.get("device"))   # None: cuda:LOCAL_RANK
    _build.lib()
    lead = dist.get_rank() == 0
    kvs = {"bf16": torch.bfloat16, "fp8": torch.float8_e5m2}
    out: dict = {}
    for run, model, wdt, mc, kv, seed, depth in args.get("runs", MESH_RUNS):
        t0 = time.perf_counter()
        cfg, fw = mesh_weights_of(model, wdt, dev, seed, depth)
        mesh = make_mesh(MeshConfig(*mc), device=dev)
        local = shard_fast_tp_weights(fw, cfg, mesh)
        if not lead:
            del fw
        meng = _fast(Engine(cfg, local, mesh=mesh, kv_dtype=kvs[kv]))
        prompt = mesh_prompt(cfg, MESH_PROMPT, seed)
        dist.barrier()
        _build.LAUNCHES.clear()
        t1 = time.perf_counter()
        toks, rows = greedy_rows(meng, prompt, MESH_NEW)
        torch.cuda.synchronize()
        r = dict(tokens=toks, launches=dict(_build.LAUNCHES),
                 wall_ms_per_token=(time.perf_counter() - t1) / MESH_NEW * 1e3)
        del meng, local
        if lead:
            r["hold"] = mesh_rows_hold(run, cfg, fw, dev, kvs[kv], [(prompt, toks, rows, None)],
                                       oracle=not cfg.is_moe)
            del fw
        torch.cuda.empty_cache()
        dist.barrier()
        r["seconds"] = time.perf_counter() - t0
        out[run] = r
    models: dict = {}

    def model(wdt, kv):
        """(cfg, whole weights, the single-device scheduler's streams on
        the same cache type, on the leader) of a scheduler run, made once."""
        if wdt not in models:
            models[wdt] = mesh_weights_of("mistral", wdt, dev, 40 + (wdt == "int4"), MESH_LAYERS)
        cfg, fw = models[wdt]
        if lead and (wdt, kv) not in models:
            ref_s = _fast(Scheduler(cfg, fw, batch=16, device=dev, kv_dtype=kvs[kv]))
            reqs = [Request(**m) for m in mesh_sched_mix(cfg)]
            for q in reqs:
                ref_s.submit(q)
            ref_s.run()
            models[wdt, kv] = [q.generated for q in reqs]
            del ref_s
        return cfg, fw, models.get((wdt, kv))

    for run, mc, wdt, kv, opts in args.get("sched", MESH_SCHED):
        t0 = time.perf_counter()
        cfg, fw, ref_streams = model(wdt, kv)
        mix = mesh_sched_mix(cfg)
        mesh = make_mesh(MeshConfig(*mc), device=dev)
        local = shard_fast_tp_weights(fw, cfg, mesh)
        kw: dict = {}
        if opts.get("paged"):
            kw.update(paged_pages=mc[0] * MESH_GROUP_PAGES, page_size=PAGE)
        if opts.get("lookup"):
            kw.update(spec_lookup=True, spec_k=SPEC_K)
        if opts.get("draft"):   # the target's first layers (the scheduler cuts its shard)
            kw.update(spec_draft=(with_layers(cfg, opts["draft"]),
                                  first_layers(fw, opts["draft"])), spec_k=SPEC_K)
        if opts.get("medusa"):
            kw.update(spec_medusa=synth_medusa(cfg, dev, 9, opts["medusa"]), spec_k=SPEC_K)
        sched = _fast(Scheduler(cfg, local, batch=16, device=dev, mesh=mesh, kv_dtype=kvs[kv],
                                **kw))
        dist.barrier()
        _build.LAUNCHES.clear()
        r: dict = {}
        if lead:
            rows = recorded_rows(sched)
            reqs = [Request(**m) for m in mix]
            for q in reqs:
                sched.submit(q)
            try:
                sched.run()
            finally:
                sched.stop_followers()
            streams = [q.generated for q in reqs]
            rows = [torch.stack(rows[id(q)]) for q in reqs]
            r.update(preemptions=sched.preemptions, resumes=sched.resumes)
            if sched.spec:
                r["spec"] = dict(sched.spec_stats)
            if sched.paged:
                r["pages_free"] = [g.n_free for g in sched.alloc.groups]
        else:
            sched.follow()
        torch.cuda.synchronize()
        r["launches"] = dict(_build.LAUNCHES)
        del sched, local, kw
        torch.cuda.empty_cache()
        if lead:
            for m, s, rw in zip(mix, streams, rows):
                if len(s) != m["max_new_tokens"] or len(rw) != len(s):
                    raise AssertionError(f"{run}: a stream of {len(s)} tokens and {len(rw)} "
                                         f"rows, {m['max_new_tokens']} asked")
            if opts.get("paged"):
                if r["pages_free"] != [MESH_GROUP_PAGES - 1] * mc[0]:
                    raise AssertionError(f"{run}: pages free at the end {r['pages_free']}")
                if not opts.get("lookup") and not r["preemptions"]:
                    raise AssertionError(f"{run}: no dp group preempted")
            if "spec" in r and r["spec"]["rounds"] < 1:
                raise AssertionError(f"{run}: no verify round")
            r["hold"] = mesh_rows_hold(run, cfg, fw, dev, kvs[kv], [
                (m["prompt_tokens"], s, rw, None if m["temperature"] == 0.0 else m["top_k"])
                for m, s, rw in zip(mix, streams, rows)], oracle=True)
            same = [sum(a == b for a, b in zip(s, q)) for s, q in zip(streams, ref_streams)]
            r.update(greedy_equal_to_single=sum(s == q for m, s, q in zip(mix, streams, ref_streams)
                                                if m["temperature"] == 0.0),
                     tokens_equal_to_single=sum(same) / sum(map(len, streams)))
        dist.barrier()
        r["seconds"] = time.perf_counter() - t0
        out[run] = r
    del models
    return out


def phase_mesh_ranks(dev, world: int = 2, backend: str = "gloo", runs=MESH_RUNS,
                     sched=MESH_SCHED) -> dict:
    """7(b): two gloo ranks spawned on the one card (run_ranks, each on
    `dev`, cuda:0; a rank that fails or hangs past MESH_TIMEOUT ends the
    phase): mesh_rank's runs, every rank's greedy tokens equal. mesh_cards
    gives it one NCCL rank per card (dev None: cuda:LOCAL_RANK)."""
    from yalm_tpu_torch.utils.testing import run_ranks
    work = os.path.join(ROOT, "build", "mesh_world")
    shutil.rmtree(work, ignore_errors=True)
    res = run_ranks("chip_smoke:mesh_rank", world,
                    {"device": None if dev is None else str(dev), "runs": runs, "sched": sched},
                    work, backend=backend, timeout=MESH_TIMEOUT, cwd=ROOT)
    shutil.rmtree(work, ignore_errors=True)
    lead = res[0]
    where = "two ranks sharing the card" if world == 2 else f"{world} {backend} ranks"
    for run, *_, depth in runs:
        if any(other[run]["tokens"] != lead[run]["tokens"] for other in res[1:]):
            raise AssertionError(f"{run}: the ranks drew different tokens")
        r, h = lead[run], lead[run]["hold"]
        log(f"  {run} ({depth} layers): {MESH_NEW} greedy tokens held to the single device "
            f"({h['near_ties']} near-ties); logits {h['mesh_vs_single']:.3f} x the tolerance "
            "from the single device's"
            + (f", {h['mesh_vs_oracle']:.3f} from the f32 oracle's (the single device: "
               f"{h['single_vs_oracle']:.3f})" if "mesh_vs_oracle" in h else "")
            + f"; {r['wall_ms_per_token']:.2f} ms/token on {where}; {r['seconds']:.1f} s")
    for run, _, wdt, kv, opts in sched:
        r, h = lead[run], lead[run]["hold"]
        extra = ""
        if opts.get("paged"):
            extra += (f"; {r['preemptions']} preemptions, {r['resumes']} resumes, pages free "
                      f"at the end {r['pages_free']}")
        if "spec" in r:
            st = r["spec"]
            extra += (f"; {st['rounds']} verify rounds, {st['accepted']} of {st['proposed']} "
                      "proposals accepted")
        log(f"  {run} ({wdt}, {kv} cache, {MESH_LAYERS} layers): "
            f"20 requests at batch 16, every token drawn from its own row; logits "
            f"{h['mesh_vs_single']:.3f} x the tolerance from the single device's"
            + (f", {h['mesh_vs_oracle']:.3f} from the f32 oracle's (the single device: "
               f"{h['single_vs_oracle']:.3f})" if "mesh_vs_oracle" in h else "")
            + f"; {h['near_ties']} greedy tokens not the single device's argmax, "
            f"{r['greedy_equal_to_single']} of 10 greedy streams and "
            f"{r['tokens_equal_to_single']:.3f} of all tokens equal to the single-device "
            f"scheduler's{extra}; {r['seconds']:.1f} s")
    return lead


def phase_mesh_kernels(bench: Bench, dev) -> None:
    """7(c): the kernels at the shard shapes of the two-rank runs, each
    against its plain version (2e-3, as phase 2) and timed: Mistral-7B at
    tp=2 (the LM head's 16000 rows, the block's 16 q and 4 kv heads without
    the residual, the FFN's 7168-wide hidden slice on one row and the
    tick's 16, the tick's and a verify sweep's 80-row wqkv GEMM, K8 and K9
    (bf16 pool) over 4 kv heads; int4: the block K6, the FFN K7, the
    prefill's wqkv GEMM and K9 over an e5m2 pool) and Mixtral-8x7B at ep=2
    (the 4 local experts' routed GEMV and GEMM, fp8 and int4, and the
    routed GEMV on the id -1 of another rank's expert: zeros, nothing
    loaded)."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.cuda import attention as A
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.cuda.block import attn_block, attn_block_plain
    from yalm_tpu_torch.ops.cuda.ffn import ffn, ffn_plain
    from yalm_tpu_torch.ops.int4 import int4_group
    from yalm_tpu_torch.parallel.fast_tp import local_config, shard_fast_tp_weights
    from yalm_tpu_torch.parallel.mesh import MeshConfig, grid_mesh

    bench.path = "mesh"
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa: E731
    L = 2
    lay = lambda r: r % L  # noqa: E731
    for wdt in ("fp8", "int4"):
        cfg = with_layers(mistral7b(weight_dtype=wdt), L)
        fw = (synth_int4_weights if wdt == "int4" else synth_fast_weights)(cfg, dev, 50)
        fl = shard_fast_tp_weights(fw, cfg, grid_mesh(MeshConfig(tp=2), 0, dev))
        del fw
        cl = local_config(cfg, 2)
        d, h, V = cl.dim, cl.hidden_dim, cl.vocab_size
        Nqkv, q_dim, Hq, Hk, D = cl.q_dim + 2 * cl.kv_dim, cl.q_dim, cl.n_heads, cl.n_kv_heads, 128
        sc = fl.scales
        int4 = wdt == "int4"
        run = "tp2_int4" if int4 else "tp2_fp8"

        def wb(w, s=None):   # one layer's weight bytes, with its scales
            return w[0].numel() * w.element_size() + (0 if s is None else 4 * s[0].numel())
        # K3 / K6: the block at the shard's heads, kv_len 1000, no residual
        kvd = torch.float8_e5m2 if int4 else torch.bfloat16
        cache = KVCache.init(cl, kvd, dev)
        for c in (cache.k, cache.v):
            c.copy_(randn(*c.shape).to(kvd))
        blk = dict(n_heads=Hq, norm_eps=cl.norm_eps, add_residual=False, kv_sinks=2,
                   theta=cl.rope_param, rotary_dim=cl.rotary_dim,
                   scale_qkv=sc.wqkv if int4 else None, scale_o=sc.wo if int4 else None)
        x = randn(d, scale=3.0)
        args = lambda l: (x, fl.rms_att, fl.wqkv, fl.wo, cache.k, cache.v, l, 999, 1000, 0,  # noqa: E731
                          999)
        name = "attn_block4_l" if int4 else "attn_block_l"
        bench.case(name, f"tp=2 shard: {Hq} q / {Hk} kv heads, kv_len=1000, no residual",
                   attn_block(*args(1), **blk), attn_block_plain(*args(1), **blk), 2e-3,
                   kernel=lambda r: attn_block(*args(lay(r)), **blk),
                   plain=lambda r: attn_block_plain(*args(lay(r)), **blk),
                   bytes_=wb(fl.wqkv, sc.wqkv if int4 else None) + wb(fl.wo, sc.wo if int4 else None)
                   + 2 * 1000 * Hk * D * cache.k.element_size() + 12 * d,
                   flops=2 * (Nqkv * d + d * q_dim) + 4 * 1000 * Hq * D, json_row=True, run=run)
        del cache
        # K4 / K7: the FFN's hidden slice in one launch, one row (decode) and
        # 16 (the tick), beside the launches it replaced (ffn_old)
        s13, s2 = (sc.w13, sc.w2) if sc else (None, None)
        kw = dict(norm_eps=cl.norm_eps, act="silu", add_residual=False)
        wbytes = wb(fl.w13, s13 if int4 else None) + wb(fl.w2, s2 if int4 else None)
        for B in (1, 16):
            xx = randn(B, d, scale=3.0) if B > 1 else randn(d, scale=3.0)
            args = lambda r, xx=xx: (xx, fl.rms_ffn, fl.w13, fl.w2, lay(r), s13, s2)  # noqa: E731
            bench.case("ffn4_l" if int4 else "ffn_l",
                       f"tp=2 shard: hidden {h}, {B} row{'s' if B > 1 else ''}, no residual, "
                       "one launch", ffn(*args(1), **kw), ffn_plain(*args(1), **kw), 2e-3,
                       kernel=lambda r, a=args: ffn(*a(r), **kw),
                       plain=lambda r, a=args: ffn_plain(*a(r), **kw),
                       old=lambda r, a=args: ffn_old(*a(r), **kw),
                       bytes_=wbytes + 8 * B * d + 4 * d, flops=B * 6 * h * d,
                       json_row=True, run=run if B == 1 else
                       "paged_int4_tp2" if int4 else "sched_tp2")
        # K1 / K5: the wqkv shard's GEMM (the tick's 16 rows; int4: a 64-row prefill chunk)
        M = 64 if int4 else 16
        xm = randn(M, d)
        sq = sc.wqkv if sc else None
        nm = "gemm4_l" if int4 else "gemm_l"
        fn = G.gemm4_l if int4 else G.gemm_l
        wl = (dequant4(fl.wqkv, sq) if int4 else fl.wqkv.to(torch.bfloat16))
        bench.case(nm, f"tp=2 shard: wqkv {Nqkv}x{d}, M={M}", fn(xm, fl.wqkv, 1, sq),
                   G.proj_plain(xm, fl.wqkv, 1, sq), 2e-3,
                   kernel=lambda r: fn(xm, fl.wqkv, lay(r), sq),
                   plain=lambda r: G.proj_plain(xm, fl.wqkv, lay(r), sq),
                   library=lambda r: F.linear(xm.to(torch.bfloat16), wl[lay(r)]),
                   bytes_=wb(fl.wqkv, sq if int4 else None) + 4 * M * (d + Nqkv),
                   flops=2 * M * Nqkv * d, json_row=True,
                   run="tp2_int4" if int4 else "sched_tp2")
        if not int4:   # K1: a verify sweep's 16 x (K + 1) rows on the wqkv shard
            Mv = 16 * (SPEC_K + 1)
            xv = randn(Mv, d)
            bench.case("gemm_l", f"tp=2 shard: wqkv {Nqkv}x{d}, M={Mv} (a verify sweep)",
                       G.gemm_l(xv, fl.wqkv, 1, None), G.proj_plain(xv, fl.wqkv, 1, None), 2e-3,
                       kernel=lambda r: G.gemm_l(xv, fl.wqkv, lay(r), None),
                       plain=lambda r: G.proj_plain(xv, fl.wqkv, lay(r), None),
                       library=lambda r: F.linear(xv.to(torch.bfloat16), wl[lay(r)]),
                       bytes_=wb(fl.wqkv) + 4 * Mv * (d + Nqkv), flops=2 * Mv * Nqkv * d,
                       json_row=True, run="medusa_tp2")
        del wl
        # K9: the paged tick's attention over the shard's 4 kv heads, B 16, a
        # pool of 4 layers in pages of 256 (bf16 for fp8, e5m2 for int4)
        phase_paged_attention(bench, cl, dev, kvd, depths=(4,),
                              run="paged_int4_tp2" if int4 else "paged_tp2")
        if not int4:
            # K1: the LM head's vocab slice
            lm_bf16 = fl.lm_head.to(torch.bfloat16)
            bench.case("gemv", f"tp=2 shard: lm_head {V}x{d}", G.gemv(x, fl.lm_head),
                       G.gemv_l_plain(x, fl.lm_head[None], 0), 2e-3,
                       kernel=lambda r: G.gemv(x, fl.lm_head),
                       plain=lambda r: G.gemv_l_plain(x, fl.lm_head[None], 0),
                       library=lambda r: F.linear(x.to(torch.bfloat16), lm_bf16),
                       bytes_=V * d + 4 * d + 4 * V, flops=2 * V * d, json_row=True, run=run)
            del lm_bf16
            # K8: the tick's attention over the shard's 4 kv heads, 16 lanes
            Bt, L4, S = 16, 2, cl.max_seq_len
            cb = KVCache.init(with_layers(cl, L4), torch.bfloat16, dev, batch=Bt)
            for c in (cb.k, cb.v):
                c.copy_(randn(*c.shape).to(torch.bfloat16))
            lanes_h = batched_lanes(S)
            lanes = A.lane_scalars(*lanes_h, S=S, kv_sinks=2, device=dev)
            lanes_cpu = lanes.cpu()
            q = randn(Bt, Hk, Hq // Hk, D, scale=2.0)
            kn, vn = randn(Bt, Hk, D, scale=2.0), randn(Bt, Hk, D)
            rope = dict(kv_sinks=2, theta=cl.rope_param, rotary_dim=cl.rotary_dim)
            want = A.attend_step_batched_plain(q, kn, vn, cb.k.clone(), cb.v.clone(), 1,
                                               lanes_cpu, **rope)
            mask, rows = window_rows(S, *lanes_h[:3], None)
            mask = mask.to(dev)
            # SDPA over the padded batch, as phase_batched_attention's yardstick
            kk = [cb.k[:, l].transpose(1, 2).contiguous() for l in range(L4)]
            vv = [cb.v[:, l].transpose(1, 2).contiguous() for l in range(L4)]
            qq = q.reshape(Bt, Hq, 1, D).to(torch.bfloat16)
            bench.case("attend_step_batched_l", f"tp=2 shard: {Hk} kv heads, B=16, kv_len 1..{S}",
                       A.attend_step_batched(q, kn, vn, cb.k, cb.v, 1, lanes, **rope), want, 2e-3,
                       kernel=lambda r: A.attend_step_batched(q, kn, vn, cb.k, cb.v, r % L4,
                                                              lanes, **rope),
                       plain=lambda r: A.attend_step_batched_plain(q, kn, vn, cb.k, cb.v, r % L4,
                                                                   lanes_cpu, **rope),
                       library=lambda r: F.scaled_dot_product_attention(
                           qq, kk[r % L4], vv[r % L4], attn_mask=mask[:, None, None, :],
                           enable_gqa=True),
                       bytes_=2 * rows * Hk * D * 2 + 4 * Bt * (2 * Hq * D + 2 * Hk * D)
                       + 4 * 5 * Bt, flops=4 * rows * Hq * D, json_row=True, run="sched_tp2")
            del cb, kk, vv
        del fl
        torch.cuda.empty_cache()
    # K10 / K11: Mixtral's 4 local experts at ep=2 (one layer)
    for wdt in ("fp8", "int4"):
        cfg = with_layers(mixtral8x7b(weight_dtype=wdt), 1)
        fw = synth_moe_weights(cfg, dev, 60)
        fl = shard_fast_tp_weights(fw, cfg, grid_mesh(MeshConfig(ep=2), 0, dev))
        del fw
        int4 = wdt == "int4"
        run = "ep2_moe_int4" if int4 else "ep2_moe_fp8"
        d, h, E_l = cfg.dim, cfg.hidden_dim, fl.w13.shape[1]
        s13 = fl.scales.w13 if int4 else None
        gv, gemv_fn = ("gemv4_le", G.gemv4_le) if int4 else ("gemv_le", G.gemv_le)
        gm, gemm_fn = ("gemm4_le", G.gemm4_le) if int4 else ("gemm_le", G.gemm_le)
        norm = dict(norm_w=fl.rms_ffn, norm_eps=cfg.norm_eps, glu_act="silu")
        x = randn(d, scale=3.0)
        ids = torch.arange(E_l, device=dev)
        w13b = (fl.w13[0].numel() // E_l) * fl.w13.element_size() + (
            4 * s13[0, 0].numel() if int4 else 0)
        # F.linear on bf16 (int4: dequantized) copies of the local experts
        wl = (dequant4(fl.w13[0], s13[0]) if int4 else fl.w13[0].to(torch.bfloat16))
        bench.case(gv, f"ep=2 shard: w13 + rmsnorm + GLU of local expert, id on the card "
                   f"({2 * h}x{d}, {E_l} local)",
                   gemv_fn(x, fl.w13, 0, ids[1], s13, **norm),
                   G.gemv_le_plain(x, fl.w13, 0, 1, s13, **norm), 2e-3,
                   kernel=lambda r: gemv_fn(x, fl.w13, 0, ids[r % E_l], s13, **norm),
                   plain=lambda r: G.gemv_le_plain(x, fl.w13, 0, r % E_l, s13, **norm),
                   library=lambda r: F.linear(x.to(torch.bfloat16), wl[r % E_l]),
                   bytes_=w13b + 12 * d + 4 * h + 8, flops=4 * h * d, json_row=True, run=run,
                   bf16_out=True)
        skip = torch.full((1,), -1, dtype=torch.long, device=dev)
        got = gemv_fn(x, fl.w13, 0, skip[0], s13, **norm)
        if not (bool((got == 0).all()) and bool((G.gemv_le_plain(x, fl.w13, 0, skip[0].cpu(),
                                                                   s13, **norm) == 0).all())):
            raise AssertionError(f"{gv}: the id -1 of another rank's expert gave non-zeros")
        bench.case(gv, "ep=2: id -1 (another rank's expert): zeros, nothing loaded",
                   got, torch.zeros_like(got), 2e-3,
                   kernel=lambda r: gemv_fn(x, fl.w13, 0, skip[0], s13, **norm),
                   plain=lambda r: G.gemv_le_plain(x, fl.w13, 0, skip[0], s13, **norm),
                   bytes_=4 * h + 8, flops=0, run=run)
        xm = randn(64, d)
        xb = G.bf16f(xm)
        bench.case(gm, f"ep=2 shard: w13 + GLU of local expert 1, M=64 ({2 * h}x{d})",
                   gemm_fn(xb, fl.w13, 0, 1, s13, glu_act="silu"),
                   G.gemm_le_plain(xb, fl.w13, 0, 1, s13, glu_act="silu"), 2e-3,
                   kernel=lambda r: gemm_fn(xb, fl.w13, 0, r % E_l, s13, glu_act="silu"),
                   plain=lambda r: G.gemm_le_plain(xb, fl.w13, 0, r % E_l, s13, glu_act="silu"),
                   library=lambda r: F.linear(xb.to(torch.bfloat16), wl[r % E_l]),
                   bytes_=w13b + 4 * 64 * (d + h), flops=2 * 64 * 2 * h * d, json_row=True,
                   run=run, bf16_out=True)
        del fl, wl
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the ring prefill, the pipelined tick and the sharded oracle
# ---------------------------------------------------------------------------

MESH8_LAYERS = 4           # the ring's and the pipeline's Mistral depth
MESH8_TIMEOUT = 600        # seconds the phase's world may take
RING_NEW = 16              # greedy decode steps from the ring-placed cache
PP_TICKS = 8
ORACLE_PROMPT, ORACLE_NEW = 64, 8
ORACLE_TOL = 1e-4          # the f32 oracle's bound on a mesh (tests/test_sharding.py:60)
# (run, weights, cache, axes, prompt tokens, seed): the whole window on
# fp8, a quarter of it on int4 over an e5m2 cache
RING_RUNS = (("ring_fp8", "fp8", "bf16", {"sp": 2, "tp": 1}, 4096, 60),
             ("ring_int4", "int4", "fp8", {"sp": 2, "tp": 1}, 1024, 61))
# (run, weights, cache, pp, lanes, seed)
PP_RUNS = (("pp_fp8", "fp8", "bf16", 2, 16, 62), ("pp_int4", "int4", "fp8", 2, 16, 63))
# (run, model, mesh (dp, ep, tp), depth, seed)
ORACLE_RUNS = (("oracle_tp2", "mistral", (1, 1, 2), 2, 64),
               ("oracle_ep2", "mixtral", (1, 2, 1), 1, 65))
# the four-card runs of mesh_cards
CARD_RING_RUNS = (("ring_sp2_tp2", "fp8", "bf16", {"sp": 2, "tp": 2}, 4096, 60),)
CARD_PP_RUNS = (("pp4_fp8", "fp8", "bf16", 4, 16, 62),)
CARD_ORACLE_RUNS = (("oracle_tp4", "mistral", (1, 1, 4), 2, 64),)
# the pipelined tick's 16 lanes: short and long histories, the window's
# edge, the ring regime past it (sinks); the last two lanes idle
PP_POS = (0, 1, 63, 64, 511, 999, 2047, 2048, 3000, 4000, 4094, 4095, 4200, 6000, 20, 100)


def _kv_type(kv: str):
    import torch
    return {"bf16": torch.bfloat16, "fp8": torch.float8_e5m2}[kv]


def ring_run(dev, run: str, wdt: str, kv: str, axes: dict, T: int, seed: int) -> dict:
    """8(a) on this rank: the ring prefill of a T-token prompt at Mistral-7B
    widths (MESH8_LAYERS layers), timed after a first call; the window cache
    of type kv placed from every rank's rows (each rank gathers the whole
    cache); RING_NEW greedy decode steps on one device from it. On rank 0,
    the references, each fed the same prompt and tokens with its rows placed
    the same way: one device's prefill_fast of the whole prompt in one call
    (timed after a first call) over a bf16 cache -- the ring's attention
    reads bf16 rows whatever the cache type, as JAX's (ring.py:151-153,
    219-223) -- and the f32 parity oracle's prefill over an f32 cache. The
    logits and the decode steps are held by mesh_rows_hold's rule
    (mesh_near_tie_hold), the placed K/V rows by rows_vs_oracle."""
    import torch
    import torch.distributed as dist
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.fast import decode_step_fast, prefill_fast
    from yalm_tpu_torch.models.transformer import decode_step, prefill
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.parallel.mesh import make_mesh
    from yalm_tpu_torch.parallel.ring import (make_prefill_ring, ring_prefill_cache,
                                              shard_ring_weights)
    t0 = time.perf_counter()
    lead = dist.get_rank() == 0
    kvd = _kv_type(kv)
    cfg, fw = mesh_weights_of("mistral", wdt, dev, seed, MESH8_LAYERS)
    mesh = make_mesh(axes, device=dev)
    rw = shard_ring_weights(fw, cfg, mesh)
    ring = make_prefill_ring(cfg, mesh)
    prompt = mesh_prompt(cfg, T, seed)
    ring(rw, prompt)
    torch.cuda.synchronize()
    dist.barrier()
    _build.LAUNCHES.clear()
    t1 = time.perf_counter()
    logits, ck, cv = ring(rw, prompt)
    torch.cuda.synchronize()
    r = dict(ttft_s=time.perf_counter() - t1, launches=dict(_build.LAUNCHES), T=T)
    del rw
    cache = ring_prefill_cache(cfg, ck, cv, kvd, mesh=mesh)
    del ck, cv
    # the placed rows, before the decode steps' ring regime overwrites them
    placed = {c: getattr(cache, c)[:, :T].clone() for c in ("k", "v")} if lead else None
    lg, toks, rows = logits, [], []
    for s in range(RING_NEW):
        toks.append(int(torch.argmax(lg)))
        rows.append(lg.float().cpu())
        lg, cache = decode_step_fast(cfg, fw, toks[-1], T + s, cache)
    r["tokens"] = toks
    del cache
    if lead:
        for rep in range(2):   # the second call is timed
            one = KVCache.init(cfg, torch.bfloat16, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lg, one = prefill_fast(cfg, fw, prompt, 0, T, one)
            torch.cuda.synchronize()
        r["single_ttft_s"] = time.perf_counter() - t1
        ref = ring_prefill_cache(cfg, one.k[:, :T], one.v[:, :T], kvd)
        del one
        want = []
        single = {c: getattr(ref, c)[:, :T].clone() for c in ("k", "v")}
        for s, t in enumerate(toks):
            want.append(lg.float().cpu())
            lg, ref = decode_step_fast(cfg, fw, t, T + s, ref)
        del ref
        w = oracle_of(cfg, fw)
        exact = KVCache.init(cfg, torch.float32, dev)
        lg, exact = prefill(cfg, w, prompt, 0, T, exact)
        orc = ring_prefill_cache(cfg, exact.k[:, :T], exact.v[:, :T], kvd)
        del exact
        r["rows"] = {c: rows_vs_oracle(f"{run} {c}", placed[c], single[c],
                                       getattr(orc, c)[:, :T]) for c in ("k", "v")}
        del placed, single
        oracle = []
        for s, t in enumerate(toks):
            oracle.append(lg.float().cpu())
            lg, orc = decode_step(cfg, w, t, T + s, orc)
        del orc, w
        r["hold"] = mesh_near_tie_hold(run, torch.stack(rows), torch.stack(want), toks,
                                       torch.stack(oracle))
    del fw
    torch.cuda.empty_cache()
    dist.barrier()
    r["seconds"] = time.perf_counter() - t0
    return r


def mesh_near_tie_hold(name: str, rows, want, toks, oracle=None) -> dict:
    """Greedy tokens drawn from a mesh run's logits `rows` against one
    device's rows `want` fed the same tokens, by mesh_rows_hold's rule:
    each token its own row's argmax (one device's argmax elsewhere is a
    near-tie, counted); the rows within 1e-2 of max(1, max|logit|) of one
    device's, or, where they are not, no further from the f32 parity
    oracle's rows `oracle` than MESH_ORACLE_SLACK times one device's own
    distance to them."""
    import torch
    t = torch.as_tensor(toks)
    if not bool((rows.argmax(-1) == t).all()):
        raise AssertionError(f"{name}: a token outside its own logits row's argmax")
    r = dict(near_ties=int((want.argmax(-1) != t).sum()), mesh_vs_single=over_tol(rows, want))
    if oracle is not None:
        r.update(mesh_vs_oracle=over_tol(rows, oracle), single_vs_oracle=over_tol(want, oracle))
    if r["mesh_vs_single"] > 1:
        if oracle is None:
            raise AssertionError(f"{name}: logits {r['mesh_vs_single']:.2f} x the tolerance "
                                 "from one device's")
        bar = max(1.0, MESH_ORACLE_SLACK * r["single_vs_oracle"])
        if r["mesh_vs_oracle"] > bar:
            raise AssertionError(f"{name}: {r['mesh_vs_oracle']:.2f} x the tolerance from the "
                                 f"f32 oracle, past {bar:.2f} (one device: "
                                 f"{r['single_vs_oracle']:.2f})")
    return r


def rows_vs_oracle(name: str, got, single, orc) -> dict:
    """Placed K/V rows (n_layers, T, Hk, D) of a mesh run against one
    device's, both held to the f32 parity oracle's placed the same way:
    layer by layer, the mesh run's RMS distance to the oracle's rows no
    more than MESH_ORACLE_SLACK times one device's (the rows of two correct
    bf16 formulations part by rounding that grows over depth; neither may
    be the far one). Returns both distances per layer and how many
    elements differ from one device's."""
    import torch
    per = []
    for layer in range(got.shape[0]):
        o = orc[layer].float()
        dm = float((got[layer].float() - o).pow(2).mean().sqrt())
        ds = float((single[layer].float() - o).pow(2).mean().sqrt())
        per.append((dm, ds))
        if dm > MESH_ORACLE_SLACK * ds:
            raise AssertionError(f"{name}: layer {layer}'s rows {dm:.3e} RMS from the f32 "
                                 f"oracle's, one device's {ds:.3e}")
    return dict(rms_vs_oracle=per, differ=int((got != single).sum()), of=got.numel())


def pp_run(dev, run: str, wdt: str, kv: str, pp: int, B: int, seed: int) -> dict:
    """8(b) on this rank: PP_TICKS pipelined ticks at Mistral-7B widths
    (MESH8_LAYERS layers) over a B-lane cache of random history (the same
    bytes on every rank, cut per stage) at PP_POS, the last two lanes idle,
    each tick's argmax the next tick's tokens, each tick timed. On rank 0,
    fed the same tokens from the same cache: the single-device tick
    (decode_step_fast_batched) and, for the writing lanes, the f32 parity
    oracle lane by lane (decode_step on each lane's cache); each tick held
    by mesh_near_tie_hold, the idle lanes to one device alone (a read-only
    lane attends the cache as it is, without its own row: no oracle step
    computes that); the stages' caches (gathered over pp) by
    rows_vs_oracle."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.fast import decode_step_fast_batched
    from yalm_tpu_torch.models.transformer import decode_step
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.parallel.mesh import make_mesh
    from yalm_tpu_torch.parallel.pipeline import make_tick_pp, shard_pp_cache, shard_pp_weights
    t0 = time.perf_counter()
    lead = dist.get_rank() == 0
    kvd = _kv_type(kv)
    cfg, fw = mesh_weights_of("mistral", wdt, dev, seed, MESH8_LAYERS)
    mesh = make_mesh({"pp": pp}, device=dev)
    whole = KVCache.init(cfg, kvd, dev, batch=B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for c in (whole.k, whole.v):
        c.copy_(torch.randn(c.shape, generator=gen, device=dev).to(kvd))
    pc, pw = shard_pp_cache(whole, mesh), shard_pp_weights(fw, cfg, mesh)
    if not lead:
        del whole
    tick = make_tick_pp(cfg, mesh, B)
    write = np.asarray([1] * (B - 2) + [0, 0])
    pos = np.asarray(PP_POS[:B])
    toks = np.asarray(mesh_prompt(cfg, B, seed))
    fed, rows, walls = [], [], []
    dist.barrier()
    _build.LAUNCHES.clear()
    for _ in range(PP_TICKS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, pc = tick(pw, toks, pos, pc, write)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        fed.append((toks, pos))
        rows.append(lg.float().cpu())
        toks, pos = lg.argmax(-1).cpu().numpy(), pos + write
    r = dict(launches=dict(_build.LAUNCHES), ms_per_tick=statistics.median(walls) * 1e3,
             tokens=[t.tolist() for t, _ in fed[1:]] + [toks.tolist()])
    got = {c: mesh.all_gather(getattr(pc, c), "pp", 1) for c in ("k", "v")}
    del pc, pw
    if lead:
        w = oracle_of(cfg, fw)
        exact = KVCache(k=whole.k.clone(), v=whole.v.clone())
        live = [b for b in range(B) if write[b]]
        idle = [b for b in range(B) if not write[b]]
        swalls, holds, idles = [], [], []
        for t, ((tk, ps), row) in enumerate(zip(fed, rows)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want, whole = decode_step_fast_batched(cfg, fw, tk, ps, whole, write)
            torch.cuda.synchronize()
            swalls.append(time.perf_counter() - t1)
            want, pick = want.float().cpu(), row.argmax(-1)
            orc = torch.stack([decode_step(cfg, w, int(tk[b]), int(ps[b]), exact.lane(b))[0]
                               .float().cpu() for b in live])
            holds.append(mesh_near_tie_hold(f"{run} tick {t}", row[live], want[live],
                                            pick[live].tolist(), orc))
            idles.append(mesh_near_tie_hold(f"{run} tick {t}, idle lanes", row[idle],
                                            want[idle], pick[idle].tolist()))
        r.update(single_ms_per_tick=statistics.median(swalls) * 1e3,
                 logits_vs_single=max(h["mesh_vs_single"] for h in holds + idles),
                 logits_vs_oracle=max(h["mesh_vs_oracle"] for h in holds),
                 single_vs_oracle=max(h["single_vs_oracle"] for h in holds),
                 near_ties=sum(h["near_ties"] for h in holds + idles),
                 rows={c: rows_vs_oracle(f"{run} {c}", got[c].transpose(0, 1),
                                         getattr(whole, c).transpose(0, 1),
                                         getattr(exact, c).transpose(0, 1))
                       for c in ("k", "v")})
        del whole, exact, w
    del got, fw
    torch.cuda.empty_cache()
    dist.barrier()
    r["seconds"] = time.perf_counter() - t0
    return r


def oracle_run(dev, run: str, model: str, mc, depth: int, seed: int) -> dict:
    """8(c) on this rank: Engine(mesh=, fast=False), the sharded parity
    oracle in f32 on an f32 cache, at the model's widths and `depth`: an
    ORACLE_PROMPT-token prefill and ORACLE_NEW greedy steps. On rank 0 the
    single-device oracle fed the same tokens: every logits row within rtol
    and atol ORACLE_TOL of its rows, each token its argmax."""
    import torch
    import torch.distributed as dist
    from yalm_tpu_torch.engine import Engine
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    t0 = time.perf_counter()
    lead = dist.get_rank() == 0
    cfg, fw = mesh_weights_of(model, "fp8", dev, seed, depth)
    w = oracle_of(cfg, fw)
    mesh = make_mesh(MeshConfig(*mc), device=dev)
    eng = Engine(cfg, w, mesh=mesh, fast=False, kv_dtype=torch.float32)
    if eng.fast:
        raise AssertionError(f"{run}: the engine took the kernels")
    prompt = mesh_prompt(cfg, ORACLE_PROMPT, seed)
    dist.barrier()
    _build.LAUNCHES.clear()
    t1 = time.perf_counter()
    toks, rows = greedy_rows(eng, prompt, ORACLE_NEW)
    torch.cuda.synchronize()
    r = dict(tokens=toks, launches=dict(_build.LAUNCHES), wall_s=time.perf_counter() - t1)
    del eng
    if lead:
        ref = Engine(cfg, w, device=dev, fast=False, kv_dtype=torch.float32)
        want = forced_rows(ref, prompt, toks)
        excess = float(((rows - want).abs() - ORACLE_TOL * (1 + want.abs())).max())
        if excess > 0 or not bool((want.argmax(-1) == torch.as_tensor(toks)).all()):
            raise AssertionError(f"{run}: the sharded oracle parts from one device's "
                                 f"(excess {excess:.3e} past rtol/atol {ORACLE_TOL})")
        r["max_abs_err"] = float((rows - want).abs().max())
        del ref
    del w, fw
    torch.cuda.empty_cache()
    dist.barrier()
    r["seconds"] = time.perf_counter() - t0
    return r


def mesh8_rank(args: dict) -> dict:
    """Phase 8, one of the world's ranks (run_ranks; two gloo ranks sharing
    the card, or through mesh_cards one NCCL rank per card): each run of
    args["ring"] (ring_run), args["pp"] (pp_run) and args["oracle"]
    (oracle_run), in order."""
    import torch
    from yalm_tpu_torch.ops.cuda import _build
    from yalm_tpu_torch.parallel.mesh import mesh_device
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh_device(args.get("device"))   # None: cuda:LOCAL_RANK
    _build.lib()
    out: dict = {}
    for row in args.get("ring", RING_RUNS):
        out[row[0]] = ring_run(dev, *row)
    for row in args.get("pp", PP_RUNS):
        out[row[0]] = pp_run(dev, *row)
    for row in args.get("oracle", ORACLE_RUNS):
        out[row[0]] = oracle_run(dev, *row)
    return out


def phase_mesh8_ranks(dev, world: int = 2, backend: str = "gloo", ring=RING_RUNS, pp=PP_RUNS,
                      oracle=ORACLE_RUNS) -> dict:
    """8(a)-(c): mesh8_rank's runs in a world of `world` ranks spawned on
    `dev` (cuda:0 for two gloo ranks sharing the card; None: one NCCL rank
    per card); every rank's tokens equal. Two ranks sharing one card
    measure correctness, not scaling."""
    from yalm_tpu_torch.utils.testing import run_ranks
    work = os.path.join(ROOT, "build", "mesh8_world")
    shutil.rmtree(work, ignore_errors=True)
    res = run_ranks("chip_smoke:mesh8_rank", world,
                    {"device": None if dev is None else str(dev), "ring": ring, "pp": pp,
                     "oracle": oracle}, work, backend=backend, timeout=MESH8_TIMEOUT, cwd=ROOT)
    shutil.rmtree(work, ignore_errors=True)
    lead = res[0]
    for run, *_ in ring + pp + oracle:
        if any(other[run]["tokens"] != lead[run]["tokens"] for other in res[1:]):
            raise AssertionError(f"{run}: the ranks drew different tokens")
    where = "two ranks sharing the card" if world == 2 else f"{world} {backend} ranks"
    for run, wdt, kv, axes, T, _ in ring:
        r, h = lead[run], lead[run]["hold"]
        last = {c: r["rows"][c]["rms_vs_oracle"][-1] for c in ("k", "v")}
        log(f"  {run} ({wdt}, {kv} cache, {MESH8_LAYERS} layers, {axes}): ring prefill of {T} "
            f"tokens {r['ttft_s']:.3f} s on {where} (one device's prefill_fast "
            f"{r['single_ttft_s']:.3f} s); K/V rows of the last layer {last['k'][0]:.3e} / "
            f"{last['v'][0]:.3e} RMS from the f32 oracle's (one device {last['k'][1]:.3e} / "
            f"{last['v'][1]:.3e}; {r['rows']['k']['differ']} / {r['rows']['v']['differ']} "
            f"elements differ from one device's); the prefill's logits and {RING_NEW - 1} "
            f"greedy steps from the placed cache held to one device ({h['near_ties']} "
            f"near-ties, logits {h['mesh_vs_single']:.3f} x the tolerance, "
            f"{h['mesh_vs_oracle']:.3f} from the f32 oracle's, one device "
            f"{h['single_vs_oracle']:.3f}); {r['seconds']:.1f} s")
    for run, wdt, kv, p, B, _ in pp:
        r = lead[run]
        last = {c: r["rows"][c]["rms_vs_oracle"][-1] for c in ("k", "v")}
        log(f"  {run} ({wdt}, {kv} cache, {MESH8_LAYERS} layers, pp={p}, B={B}): {PP_TICKS} "
            f"ticks at {r['ms_per_tick']:.2f} ms a tick on {where} (one device "
            f"{r['single_ms_per_tick']:.2f}); logits {r['logits_vs_single']:.3f} x the "
            f"tolerance from one device's, {r['logits_vs_oracle']:.3f} from the f32 oracle's "
            f"(one device {r['single_vs_oracle']:.3f}), {r['near_ties']} near-ties; the last "
            f"layer's rows {last['k'][0]:.3e} / {last['v'][0]:.3e} RMS from the oracle's (one "
            f"device {last['k'][1]:.3e} / {last['v'][1]:.3e}; {r['rows']['k']['differ']} / "
            f"{r['rows']['v']['differ']} elements differ from one device's); "
            f"{r['seconds']:.1f} s")
    for run, model, mc, depth, _ in oracle:
        r = lead[run]
        log(f"  {run} ({model}, mesh {mc}, {depth} layers, f32): {ORACLE_PROMPT} + "
            f"{ORACLE_NEW} greedy tokens held to the single-device oracle (max |err| "
            f"{r['max_abs_err']:.3e}, bound {ORACLE_TOL} + {ORACLE_TOL} x |logit|); "
            f"{r['wall_s']:.2f} s of generation, {r['seconds']:.1f} s")
    return lead


def phase_mesh8_kernels(bench: Bench, dev) -> None:
    """8(d): the kernels at the shapes the ring and the pipeline give them,
    each against its plain version (2e-3, as phase 2) and timed: K1 gemm_l
    on the wqkv GEMM at the ring's T/sp = 2048 rows, K5 gemm4_l at its int4
    run's 512, K8 attend_step_batched_l over a stage's B/pp = 8 lanes (8 kv
    heads, bf16 cache), K4 ffn_l at 8 rows (one launch, beside the two it
    replaced) and K1 gemm_l on the LM head at the tick's 16 rows."""
    import torch
    import torch.nn.functional as F
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.ops.cuda import attention as A
    from yalm_tpu_torch.ops.cuda import gemv as G
    from yalm_tpu_torch.ops.cuda.ffn import ffn, ffn_plain

    bench.path = "mesh"
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa: E731
    L = 2
    lay = lambda r: r % L  # noqa: E731
    for wdt, M, run in (("fp8", 2048, "ring_fp8"), ("int4", 512, "ring_int4")):
        cfg = with_layers(mistral7b(weight_dtype=wdt), L)
        fw = (synth_int4_weights if wdt == "int4" else synth_fast_weights)(cfg, dev, 70)
        d, Nqkv = cfg.dim, cfg.q_dim + 2 * cfg.kv_dim
        int4 = wdt == "int4"
        sq = fw.scales.wqkv if int4 else None
        fn, nm = (G.gemm4_l, "gemm4_l") if int4 else (G.gemm_l, "gemm_l")
        wl = dequant4(fw.wqkv, sq) if int4 else fw.wqkv.to(torch.bfloat16)
        wbytes = fw.wqkv[0].numel() * fw.wqkv.element_size() + (4 * sq[0].numel() if int4 else 0)
        xm = randn(M, d)
        bench.case(nm, f"ring sp=2: wqkv {Nqkv}x{d}, M={M} (T/sp)", fn(xm, fw.wqkv, 1, sq),
                   G.proj_plain(xm, fw.wqkv, 1, sq), 2e-3,
                   kernel=lambda r: fn(xm, fw.wqkv, lay(r), sq),
                   plain=lambda r: G.proj_plain(xm, fw.wqkv, lay(r), sq),
                   library=lambda r: F.linear(xm.to(torch.bfloat16), wl[lay(r)]),
                   bytes_=wbytes + 4 * M * (d + Nqkv), flops=2 * M * Nqkv * d, json_row=True,
                   run=run)
        del wl
        if not int4:
            # K4: a stage's FFN at B/pp = 8 rows in one launch, no residual,
            # beside the two GEMV launches it replaced
            Bm, h = 8, cfg.hidden_dim
            kw = dict(norm_eps=cfg.norm_eps, act="silu", add_residual=False)
            xx = randn(Bm, d, scale=3.0)
            bench.case("ffn_l", f"pp=2 stage: {Bm} rows (B/pp), hidden {h}, no residual, "
                       "one launch", ffn(xx, fw.rms_ffn, fw.w13, fw.w2, 1, **kw),
                       ffn_plain(xx, fw.rms_ffn, fw.w13, fw.w2, 1, **kw), 2e-3,
                       kernel=lambda r: ffn(xx, fw.rms_ffn, fw.w13, fw.w2, lay(r), **kw),
                       plain=lambda r: ffn_plain(xx, fw.rms_ffn, fw.w13, fw.w2, lay(r), **kw),
                       old=lambda r: ffn_old(xx, fw.rms_ffn, fw.w13, fw.w2, lay(r), **kw),
                       bytes_=(fw.w13[0].numel() + fw.w2[0].numel()) * fw.w13.element_size()
                       + 8 * Bm * d + 4 * d, flops=Bm * 6 * h * d, json_row=True, run="pp_fp8")
            # K1: the unembedding's GEMM over the tick's 16 rows
            xn = randn(16, d)
            lm = fw.lm_head.to(torch.bfloat16)
            V = cfg.vocab_size
            bench.case("gemm_l", f"pp: LM head {V}x{d}, M=16 (the tick's unembedding)",
                       G.gemm(xn, fw.lm_head), G.proj_plain(xn, fw.lm_head[None], 0), 2e-3,
                       kernel=lambda r: G.gemm(xn, fw.lm_head),
                       plain=lambda r: G.proj_plain(xn, fw.lm_head[None], 0),
                       library=lambda r: F.linear(xn.to(torch.bfloat16), lm),
                       bytes_=V * d + 4 * 16 * (d + V), flops=2 * 16 * V * d, json_row=True,
                       run="pp_fp8")
            del lm
        del fw
        torch.cuda.empty_cache()
    # K8: a stage's attention over B/pp = 8 lanes, all 8 kv heads, bf16 cache
    cfg = mistral7b()
    Hq, Hk, D, S, Bm, L4 = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len, 8, 2
    cb = KVCache.init(with_layers(cfg, L4), torch.bfloat16, dev, batch=Bm)
    for c in (cb.k, cb.v):
        c.copy_(randn(*c.shape).to(torch.bfloat16))
    lanes_h = tuple(x[::2] for x in batched_lanes(S))   # 8 of the 16 lanes: 1..S+1904 slots
    lanes = A.lane_scalars(*lanes_h, S=S, kv_sinks=2, device=dev)
    lanes_cpu = lanes.cpu()
    q = randn(Bm, Hk, Hq // Hk, D, scale=2.0)
    kn, vn = randn(Bm, Hk, D, scale=2.0), randn(Bm, Hk, D)
    rope = dict(kv_sinks=2, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    want = A.attend_step_batched_plain(q, kn, vn, cb.k.clone(), cb.v.clone(), 1, lanes_cpu,
                                       **rope)
    mask, rows = window_rows(S, *lanes_h[:3], None)
    mask = mask.to(dev)
    kk = [cb.k[:, l].transpose(1, 2).contiguous() for l in range(L4)]
    vv = [cb.v[:, l].transpose(1, 2).contiguous() for l in range(L4)]
    qq = q.reshape(Bm, Hq, 1, D).to(torch.bfloat16)
    bench.case("attend_step_batched_l", f"pp=2 stage: {Hk} kv heads, B/pp={Bm}, kv_len 1..{S}",
               A.attend_step_batched(q, kn, vn, cb.k, cb.v, 1, lanes, **rope), want, 2e-3,
               kernel=lambda r: A.attend_step_batched(q, kn, vn, cb.k, cb.v, r % L4, lanes,
                                                      **rope),
               plain=lambda r: A.attend_step_batched_plain(q, kn, vn, cb.k, cb.v, r % L4,
                                                           lanes_cpu, **rope),
               library=lambda r: F.scaled_dot_product_attention(
                   qq, kk[r % L4], vv[r % L4], attn_mask=mask[:, None, None, :], enable_gqa=True),
               bytes_=2 * rows * Hk * D * 2 + 4 * Bm * (2 * Hq * D + 2 * Hk * D) + 4 * 5 * Bm,
               flops=4 * rows * Hq * D, json_row=True, run="pp_fp8")
    del cb, kk, vv
    torch.cuda.empty_cache()


def mesh8_phases() -> int:
    """Phase 8 alone, for a short card call: (a)-(c) two gloo ranks sharing
    the card (the ring prefill, the pipelined tick, the sharded oracle),
    (d) the kernels at their shapes. Run from the repository root:
        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.mesh8_phases())"
    Prints the cases and the runs as one JSON line, then the card's name
    and power limit."""
    import torch
    from yalm_tpu_torch.ops.cuda import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    bench = Bench(HBM_BYTES_PER_S)
    with phase("(a)-(c) the ring prefill, the pipelined tick, the sharded oracle"):
        runs = phase_mesh8_ranks(torch.device("cuda", 0))
    with phase("(d) the kernels at the ring's and the pipeline's shapes"):
        phase_mesh8_kernels(bench, dev)
    for r in bench.rows:
        if r["json"] and not runs[r["run"]]["launches"].get(r["name"]):
            raise AssertionError(f"{r['name']}: no launch in the mesh run {r['run']}")
    print(json.dumps({"cases": bench.rows, "mesh": runs}), flush=True)
    print(smi, flush=True)
    return 0


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
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s (nvcc, all sources "
        "started together: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                         sorted(_build.BUILD_SECONDS.items())) + ")")

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
    summary: dict = {p: {} for p in ("fp8", "int4", "moe_fp8", "moe_int4", "gemma3", "gemma2",
                                     "mesh")}
    # the Mistral-7B serving runs at depth 8 (PERF.md keeps their 32-layer
    # numbers), so the Mixtral phases fit the time limit
    lay_s = MISTRAL_SERVING_LAYERS
    with phase("phase 2 (fp8 path): kernels vs plain versions on the card"):
        phase_kernels(bench, cfg, fw, dev)
    with phase("phase 3 (fp8 path, bf16 cache): the slice end to end (32 layers)"):
        summary["fp8"]["serve"] = phase_serve(cfg, fw, dev, torch.bfloat16, "fp8")
    cfg_s, fw_s = with_layers(cfg, lay_s), first_layers(fw, lay_s)
    with phase(f"phase 3 (fp8 path, bf16 cache): continuous-batching serving, batch 16 "
               f"({lay_s} layers)"):
        summary["fp8"]["batched"] = phase_serving(cfg_s, fw_s, dev, torch.bfloat16, "fp8",
                                                  n_requests=24, http=4)
    with phase(f"phase 3 (fp8 path, bf16 pool): paged serving, batch 16, {PAGED_PAGES} pages "
               f"of 256 ({lay_s} layers)"):
        summary["fp8"]["paged"] = phase_serving(cfg_s, fw_s, dev, torch.bfloat16, "fp8",
                                                n_requests=24, http=4,
                                                paged_pages=PAGED_PAGES)
    with phase(f"phase 3 (fp8 path, bf16 cache): speculation, single stream ({lay_s} layers)"):
        summary["fp8"]["spec"] = phase_spec(cfg_s, fw_s, dev, torch.bfloat16)
    with phase(f"phase 3 (fp8 path, bf16 cache): speculation, serving at batch 16 "
               f"({lay_s} layers)"):
        summary["fp8"]["spec_serving"] = phase_spec_serving(cfg_s, fw_s, dev, torch.bfloat16)
    with phase("phase 3 (fp8 path, bf16 cache): tree-attention Medusa (32 layers)"):
        summary["fp8"]["tree"] = phase_tree(cfg, fw, dev, torch.bfloat16)
    with phase("phase 4 (fp8 path): the parity oracle on the card (2 layers)"):
        summary["fp8"]["oracle"] = phase_oracle(cfg, fw, dev, torch.bfloat16)
        summary["fp8"]["oracle_mqa"] = phase_oracle_mqa(cfg, dev, torch.bfloat16)
    with phase("phase 4 (fp8 path): debug capture, kernels vs oracle (2 layers)"):
        summary["fp8"]["capture"] = phase_capture(cfg, fw, dev, torch.bfloat16)
    with phase("phase 4 (fp8 path): depth-2 parity, card vs CPU"):
        summary["fp8"]["parity"] = phase_parity(cfg, fw, dev, torch.bfloat16)
        summary["fp8"]["batched_parity"] = phase_batched_parity(cfg, fw, dev, torch.bfloat16)
        summary["fp8"]["paged_parity"] = phase_batched_parity(cfg, fw, dev, torch.bfloat16,
                                                              paged=True)
        summary["fp8"]["verify_parity"] = phase_verify_parity(cfg, fw, dev, torch.bfloat16)
        summary["fp8"]["verify_paged_parity"] = phase_verify_parity(cfg, fw, dev,
                                                                    torch.bfloat16, paged=True)
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
    cfg_s, fw_s = with_layers(cfg4, lay_s), first_layers(fw4, lay_s)
    with phase("phase 3 (int4 path, e5m2 cache): continuous-batching serving, batch 16 "
               f"({lay_s} layers)"):
        summary["int4"]["batched"] = phase_serving(cfg_s, fw_s, dev, e5, "int4",
                                                   n_requests=20, http=0)
    with phase(f"phase 3 (int4 path, e5m2 pool): paged serving, batch 16, {PAGED_PAGES} pages "
               f"of 256 ({lay_s} layers)"):
        summary["int4"]["paged"] = phase_serving(cfg_s, fw_s, dev, e5, "int4", n_requests=20,
                                                 http=0, paged_pages=PAGED_PAGES)
    with phase("phase 3 (int4 path, e5m2 cache): tree-attention Medusa (depths 2 and 8)"):
        summary["int4"]["tree"] = phase_tree_path(cfg4, fw4, dev, e5, "int4")
    with phase("phase 4 (int4 path, e5m2 cache): depth-2 parity, card vs CPU"):
        capture_refuses_int4(cfg4, fw4, dev, e5)
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
        # the serving runs at depth 8 (PERF.md keeps the 32-layer runs), so
        # the Gemma paths fit the time limit
        lay_m = MIXTRAL_SERVING_LAYERS
        cfg_s, fw_s = with_layers(cfgm, lay_m), first_layers(fwm, lay_m)
        if path == "moe_fp8":
            with phase(f"phase 3 ({path} path, {cache}): continuous-batching serving, "
                       f"batch 16 ({lay_m} layers)"):
                summary[path]["batched"] = phase_serving(
                    cfg_s, fw_s, dev, kv, path, n_requests=17, http=2, prompts=(64, 1024),
                    new=(32, 64), past_window=False)
        else:
            with phase(f"phase 3 ({path} path, e5m2 pool): paged serving, batch 16, "
                       f"{PAGED_PAGES} pages of 256 ({lay_m} layers)"):
                summary[path]["paged"] = phase_serving(
                    cfg_s, fw_s, dev, kv, path, n_requests=17, http=0,
                    paged_pages=PAGED_PAGES, prompts=(256, 1536), new=(32, 64),
                    past_window=False)
        if path == "moe_fp8":
            with phase(f"phase 3 ({path} path, {cache}): tree-attention Medusa (depths 2 and "
                       "8)"):
                summary[path]["tree"] = phase_tree_path(cfgm, fwm, dev, kv, path)
            with phase(f"phase 4 ({path} path): debug capture, kernels vs oracle (2 layers)"):
                summary[path]["capture"] = phase_capture(cfgm, fwm, dev, kv)
        with phase(f"phase 4 ({path} path, {cache}): depth-2 parity, card vs CPU"):
            # 8 lanes of 8-row chunks: the CPU's plain experts set the pace
            summary[path]["parity"] = phase_parity(cfgm, fwm, dev, kv)
            key = "batched_parity" if path == "moe_fp8" else "paged_parity"
            summary[path][key] = phase_batched_parity(cfgm, fwm, dev, kv,
                                                      paged=path == "moe_int4", B=8, T=8)
        del fwm, fw_s
        torch.cuda.empty_cache()

    # Gemma3-12B (bf16 cache) and Gemma2-9B (e5m2 cache): the Gemma forms of
    # K2, K8 and K9 on the unfused decode route
    for path, cfgg, kv, seed, form in (
            ("gemma3", gemma3_12b(), torch.bfloat16, 4, dict(win=1024, alt=1)),
            ("gemma2", gemma2_9b(), e5, 5, dict(win=4096, softcap=50.0))):
        t0 = time.perf_counter()
        fwg = synth_fast_weights(cfgg, dev, seed=seed)
        torch.cuda.synchronize()
        log(f"{path} fp8 weights made on the card in {time.perf_counter() - t0:.1f} s "
            f"({weight_gb(fwg):.2f} GB)")
        log_token_bytes(cfgg, fwg, ceiling)
        cache = "bf16 cache" if kv == torch.bfloat16 else "e5m2 cache"
        bench.path = path
        with phase(f"phase 2 ({path} path): the LM head, the gelu GLU and the attention "
                   f"steps in the Gemma form{form_label(form)} vs plain versions"):
            phase_gemma_kernels(bench, cfgg, fwg, dev, kv, form)
        # phase 3 at depth 8, which holds both layer kinds (PERF.md keeps the
        # full-depth runs), so the whole script fits the time limit
        lay_g = GEMMA_SERVING_LAYERS
        cfg_s, fw_s = with_layers(cfgg, lay_g), first_layers(fwg, lay_g)
        with phase(f"phase 3 ({path} path, {cache}): single stream ({lay_g} layers)"):
            summary[path]["serve"] = phase_serve(cfg_s, fw_s, dev, kv, path,
                                                 GEMMA_SERVE_REQUESTS[path])
        if path == "gemma3":
            with phase(f"phase 3 ({path} path, {cache}): continuous-batching serving, batch 16 "
                       f"({lay_g} layers)"):
                summary[path]["batched"] = phase_serving(
                    cfg_s, fw_s, dev, kv, path, n_requests=17, http=2, prompts=(64, 2048),
                    new=(32, 64), past_window=False)
        else:
            with phase(f"phase 3 ({path} path, e5m2 pool): paged serving, batch 16, "
                       f"{PAGED_PAGES} pages of 256 ({lay_g} layers)"):
                summary[path]["paged"] = phase_serving(
                    cfg_s, fw_s, dev, kv, path, n_requests=17, http=0, paged_pages=PAGED_PAGES,
                    prompts=(256, 1536), new=(32, 64), past_window=False)
        if path == "gemma2":
            with phase(f"phase 4 ({path} path, {cache}): the parity oracle on the card "
                       "(2 layers)"):
                summary[path]["oracle"] = phase_oracle(cfgg, fwg, dev, kv)
        with phase(f"phase 4 ({path} path, {cache}): debug capture, kernels vs oracle "
                   "(2 layers)"):
            summary[path]["capture"] = phase_capture(cfgg, fwg, dev, kv)
        with phase(f"phase 4 ({path} path, {cache}): depth-2 parity, card vs CPU"):
            summary[path]["parity"] = phase_parity(cfgg, fwg, dev, kv)
            key = "batched_parity" if path == "gemma3" else "paged_parity"
            summary[path][key] = phase_batched_parity(cfgg, fwg, dev, kv,
                                                      paged=path == "gemma2", B=8, T=8)
        del fwg, fw_s
        torch.cuda.empty_cache()
    with phase("phase 5: CLI modes"):
        phase_cli(dev)
    with phase("phase 6: converted checkpoints from disk (native reader and tokenizer)"):
        summary["checkpoint"] = phase_checkpoint(dev)
    with phase("phase 7 (mesh): (a) a world of one NCCL rank, Mistral-7B fp8 (32 layers)"):
        summary["mesh"] = {"one": phase_mesh_one(dev)}
    with phase("phase 7 (mesh): (b) two gloo ranks sharing the card (tp=2, ep=2, dp=2)"):
        summary["mesh"].update(phase_mesh_ranks(torch.device("cuda", 0)))
    with phase("phase 7 (mesh): (c) the kernels at shard shapes"):
        phase_mesh_kernels(bench, dev)
    with phase("phase 8 (mesh): (a)-(c) the ring prefill (sp=2), the pipelined tick (pp=2) "
               "and the sharded oracle (tp=2, ep=2) on two gloo ranks sharing the card"):
        summary["mesh"].update(phase_mesh8_ranks(torch.device("cuda", 0)))
    with phase("phase 8 (mesh): (d) the kernels at the ring's and the pipeline's shapes"):
        phase_mesh8_kernels(bench, dev)
    for r in bench.rows:
        if r["path"] == "mesh" and r["json"] and not summary["mesh"][r["run"]][
                "launches"].get(r["name"]):
            raise AssertionError(f"{r['name']}: no launch in the mesh run {r['run']}")

    # name -> (source, the TPU function of the same name it replaces); the
    # FFN's GEMM route (_gemm) launches csrc/gemm.cu
    sources = {"gemv": ("csrc/gemv.cu", "yalm_tpu/ops/pallas/gemv.py:81"),
               "gemv_l": ("csrc/gemv.cu", "yalm_tpu/ops/pallas/gemv.py:148"),
               "gemm_l": ("csrc/gemm.cu", "yalm_tpu/ops/pallas/gemv.py:426"),
               # gemm_l's kernel rounds each X tile to bf16 as it reads it
               "round_rows_bf16": ("csrc/gemm.cu", "yalm_tpu/ops/pallas/gemv.py:476"),
               "attend_step_l": ("csrc/attention.cu", "yalm_tpu/ops/pallas/attention.py:808"),
               "attn_block_l": ("csrc/block.cu", "yalm_tpu/ops/pallas/block.py:554"),
               "ffn_l": ("csrc/ffn.cu", "yalm_tpu/ops/pallas/ffn.py:332"),
               "gemv4_l": ("csrc/gemv.cu", "yalm_tpu/ops/pallas/gemv.py:776"),
               "gemm4_l": ("csrc/gemm.cu", "yalm_tpu/ops/pallas/gemv.py:600"),
               "attn_block4_l": ("csrc/block.cu", "yalm_tpu/ops/pallas/block.py:365"),
               "ffn4_l": ("csrc/ffn.cu", "yalm_tpu/ops/pallas/ffn.py:227"),
               "attend_step_batched_l": ("csrc/attention.cu",
                                         "yalm_tpu/ops/pallas/attention.py:538"),
               "attend_step_paged_l": ("csrc/attention.cu",
                                       "yalm_tpu/ops/pallas/attention.py:1093"),
               "ffn_l_gemm": ("ops/cuda/ffn.py", "yalm_tpu/ops/pallas/ffn.py:332"),
               "ffn4_l_gemm": ("ops/cuda/ffn.py", "yalm_tpu/ops/pallas/ffn.py:227"),
               "gemv_le": ("csrc/gemv.cu", "yalm_tpu/ops/pallas/gemv.py:265"),
               "gemm_le": ("csrc/gemm.cu", "yalm_tpu/ops/pallas/gemv.py:344"),
               "gemm4_le": ("csrc/gemm.cu", "yalm_tpu/ops/pallas/gemv.py:688"),
               "gemv4_le": ("csrc/gemv.cu", "yalm_tpu/ops/pallas/gemv.py:768"),
               "attend_one_l": ("csrc/attention.cu", "yalm_tpu/ops/pallas/attention.py:85")}
    kernels = []
    for r in bench.rows:
        if not r["json"]:
            continue
        src, rep = sources[r["name"]]
        # K12 runs on no model path (in the JAX package neither): its phase-2 launches
        launches = (r["phase2_launches"] if r["run"] == "phase2"
                    else summary[r["path"]][r["run"]]["launches"][r["name"]])
        kernels.append(dict(
            name=r["name"], route="cuda", source="yalm_tpu_torch/" + src, replaces=rep,
            path=r["path"], case=r["case"], run=r["run"],
            launches=launches,
            max_abs_err=r["max_abs_err"], max_err=r["max_abs_err"], tol=r["tol"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            ceiling_ms=r["ceiling_ms"], old_design_ms=r["old_ms"]))
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
