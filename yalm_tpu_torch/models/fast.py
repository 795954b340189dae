"""Fast decode and chunked prefill on the hand-written kernels (port of
`yalm_tpu/models/fast.py`, dense and MoE models on one device), single-sequence and
for the continuous-batching scheduler (`decode_step_fast_batched`: one tick
for B lanes of a batched cache; `prefill_chunk_fast_batched`: every
admitting lane's next prompt chunk in one weight sweep), and the same over a
paged KV pool (`decode_step_fast_batched_paged`, `prefill_fast_paged`,
`prefill_chunk_fast_batched_paged`; models/paged.py).

One decode step per token: embedding gather, then per layer the attention
block (`attn_block_l`: norm + wqkv GEMV, attention step, wo GEMV +
residual) and the FFN (`ffn_l`: norm + w13 GEMV with GLU, w2 GEMV +
residual), then the final norm and the LM-head `gemv`. Prefill runs the
layer-indexed `gemm_l` for every projection of a chunk and leaves the chunk
attention to plain torch (as the JAX package leaves it to XLA). int4
checkpoints (packed uint8 layer weights with group scales; int8 embedding
and LM head) take `attn_block4_l`, `ffn4_l` and `gemm4_l` on the same
route. The batched paths run `gemm_l`/`gemm4_l` over the B (or B*T) rows,
`attend_step_batched_l` (`attend_step_paged_l` over a pool) and the
many-row `ffn`. The KV cache or pool (bf16 or e5m2) is updated IN PLACE.

MoE models (Mixtral-style: a router and E experts of which k run per
token) replace the FFN: single-stream decode runs the router GEMV, the
top-k gate on the device and, per routed expert in rank order, the
(layer, expert)-addressed `gemv_le`/`gemv4_le` pair with the ids read on
the card (none reaches the host); every chunk path (prefill, the tick, the
chunk sweep, dense and paged) shares `_moe_ffn_batched`, the masked
all-expert sweep on `gemm_le`/`gemm4_le`. Models outside this slice
(qk-norm, sandwich norms, softcaps, sliding layers) raise
NotImplementedError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Mapping, Optional

import numpy as np
import torch

from ..codec.format import numpy_to_torch, tag_for_numpy
from ..config import KV_SINKS, ModelConfig
from ..ops.core import NEG_INF, apply_rope, gelu, int_view, moe_gate, rmsnorm, silu
from ..ops.cuda import _build
from ..ops.cuda.attention import (attend_step_batched, attend_step_paged, gather_pages,
                                  lane_scalars, page_tables)
from ..ops.cuda.block import attn_block
from ..ops.cuda.ffn import ffn
from ..ops.cuda.gemv import (bf16f, gemm, gemm4_le, gemm_le, gemv, gemv4_le, gemv_l, gemv_le,
                             is_int4, launch_gemm, proj_plain)
from ..ops.int4 import int4_group
from .cache import KVCache
from .paged import PagedKVPool


@dataclass
class FastScales:
    """Per-output-channel dequant scales of int8 checkpoints, in the row
    order of FastWeights' concatenated projections (y = (W_q @ x) * s). For
    int4 checkpoints the layer fields hold group scales (n_layers, G, N),
    concatenated along N as the packed rows are; embed, lm_head and the MoE
    router stay per-row (int8). MoE experts carry an expert axis after the
    layer axis."""

    embed: torch.Tensor    # (vocab,) f32
    wqkv: torch.Tensor     # (n_layers, [G,] q_dim + 2*kv_dim) f32
    wo: torch.Tensor       # (n_layers, [G,] dim) f32
    w13: torch.Tensor      # (n_layers, [n_experts,] [G,] 2*hidden_dim) f32
    w2: torch.Tensor       # (n_layers, [n_experts,] [G,] dim) f32
    lm_head: torch.Tensor  # (vocab,) f32
    moegate: Optional[torch.Tensor] = None  # (n_layers, n_experts) f32, MoE only


@dataclass
class FastWeights:
    """Decode layout: per-layer stacks, [wq;wk;wv] and [w1;w3] concatenated
    (per expert, for MoE models, whose w13/w2 carry an expert axis and whose
    router is `moegate`; dense models have moegate None)."""

    embed: torch.Tensor       # (vocab, dim)
    rms_att: torch.Tensor     # (n_layers, dim) f32
    rms_ffn: torch.Tensor     # (n_layers, dim) f32
    # layer weights; packed int4 checkpoints hold uint8 with the last
    # dimension halved (ops/int4.py)
    wqkv: torch.Tensor        # (n_layers, q_dim + 2*kv_dim, dim)
    wo: torch.Tensor          # (n_layers, dim, q_dim)
    w13: torch.Tensor         # (n_layers, [n_experts,] 2*hidden_dim, dim)
    w2: torch.Tensor          # (n_layers, [n_experts,] dim, hidden_dim)
    final_norm: torch.Tensor  # (dim,) f32
    lm_head: torch.Tensor     # (vocab, dim)
    bqkv: Optional[torch.Tensor] = None    # (n_layers, q_dim + 2*kv_dim) f32
    scales: Optional[FastScales] = None    # int8 and int4 checkpoints only
    moegate: Optional[torch.Tensor] = None  # (n_layers, n_experts, dim), MoE only

    def to(self, device) -> "FastWeights":
        """A copy on `device` (the lm_head stays shared with embed when tied)."""
        moved: dict = {}
        out = {}
        for f in fields(self):
            t = getattr(self, f.name)
            if isinstance(t, FastScales):
                out[f.name] = FastScales(**{
                    g.name: None if getattr(t, g.name) is None else getattr(t, g.name).to(device)
                    for g in fields(t)})
            elif t is not None:
                if id(t) not in moved:
                    moved[id(t)] = t.to(device)
                out[f.name] = moved[id(t)]
            else:
                out[f.name] = None
        return FastWeights(**out)


def _check_slice(cfg: ModelConfig) -> None:
    """Raise for model features that later slices of the port bring."""
    missing = [name for name, on in (
        ("qk-norm", cfg.has_qk_norm),
        ("sandwich norms", cfg.has_post_norms),
        ("attention softcap", bool(cfg.attn_softcap)),
        ("final softcap", bool(cfg.final_softcap)),
        ("sliding-window layers", any(cfg.layer_sliding)),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)}: not in this slice of the PyTorch port "
            "(see ROADMAP.md, Queue 1)")


def _itemsize(cfg: ModelConfig) -> int:
    # fp16 checkpoints load as bf16; int4 layer weights are packed (K % 256
    # is their rule) and the int8 LM head takes 1-byte rows
    return {"fp32": 4, "fp16": 2, "bf16": 2, "fp8": 1, "int8": 1}.get(cfg.weight_dtype, 1)


def gemv_supported(N: int, K: int, itemsize: int) -> bool:
    """csrc/gemv.cu: rows of 16-byte chunks, x staged in shared memory."""
    return K * itemsize % 16 == 0 and K * 2 <= 227 * 1024


def gemm_supported(K: int, itemsize: int) -> bool:
    """csrc/gemm.cu: 32-wide K steps of 16-byte chunks."""
    return K % 32 == 0 and K * itemsize % 16 == 0


def attention_supported(cfg: ModelConfig) -> bool:
    """csrc/attention.cu: 16-byte row chunks and <= 8 outputs per thread
    (any window: scores that overflow shared memory go to global scratch)."""
    qpk = cfg.n_heads // cfg.n_kv_heads
    return cfg.head_dim % 8 == 0 and qpk * cfg.head_dim <= 2048


def int4_kernels_supported(K: int) -> bool:
    """csrc/gemv.cu and csrc/gemm.cu on packed int4: whole groups of 256 or
    512 columns, x staged in shared memory as bf16."""
    return K % 256 == 0 and K * 2 <= 227 * 1024


def fast_unsupported(cfg: ModelConfig) -> Optional[str]:
    """Why this model's shapes do not fit the port's Hopper kernels, or None."""
    isz = _itemsize(cfg)
    int4 = cfg.weight_dtype == "int4"
    if cfg.is_moe and not 1 <= cfg.n_experts_active <= cfg.n_experts:
        return f"{cfg.n_experts_active} active of {cfg.n_experts} experts"
    # the MoE router stays int8 (per-row scales) on int4 checkpoints, as the LM head
    for name, n, k in (("wqkv", cfg.q_dim + 2 * cfg.kv_dim, cfg.dim),
                       ("wo", cfg.dim, cfg.q_dim), ("w13", 2 * cfg.hidden_dim, cfg.dim),
                       ("w2", cfg.dim, cfg.hidden_dim), ("lm_head", cfg.vocab_size, cfg.dim),
                       *((("moegate", cfg.n_experts, cfg.dim),) if cfg.is_moe else ())):
        if int4 and name not in ("lm_head", "moegate"):
            if not int4_kernels_supported(k):
                return (f"{name} ({n}x{k}, packed int4): the int4 GEMV/GEMM kernels take "
                        "K a multiple of 256, K <= 116224")
        elif not (gemv_supported(n, k, isz) and gemm_supported(k, isz)):
            return (f"{name} ({n}x{k}, {isz}-byte weights): the GEMV/GEMM kernels take "
                    "K a multiple of 32 whose rows are 16-byte chunks, K <= 116224")
    if not attention_supported(cfg):
        return (f"head_dim {cfg.head_dim} x {cfg.n_heads // cfg.n_kv_heads} queries per "
                "kv head: the attention kernel takes head_dim % 8 == 0 and qpk*head_dim <= 2048")
    return None


def fast_supported(cfg: ModelConfig) -> bool:
    """Whether this model's shapes fit the port's Hopper kernels."""
    return fast_unsupported(cfg) is None


def fast_batched_supported(cfg: ModelConfig) -> bool:
    """Batched tick support: the same kernels with more rows (the batched
    attention takes any window, its scores past shared memory in global
    scratch, and the FFN's GEMM route any row count)."""
    return fast_supported(cfg)


# ---------------------------------------------------------------------------
# weight loading
# ---------------------------------------------------------------------------

def _host(t: torch.Tensor) -> torch.Tensor:
    # f16 -> bf16 on the host: not exact, and the kernels compute in bf16
    return t.to(torch.bfloat16) if t.dtype == torch.float16 else t


def load_fast_weights(yf, cfg: ModelConfig, device="cuda") -> FastWeights:
    """Load a dense checkpoint straight into the decode layout on `device`.

    Each layer's tensors are copied out of the checkpoint mmap, concatenated
    on the host and written into a preallocated device stack, so neither the
    host nor the device holds a second copy of the whole model. int8
    checkpoints bring per-row `.scale`s, concatenated as their rows are.
    int4 checkpoints (yalm_tpu/models/fast.py:174-256 without TP) bring
    packed uint8 layer weights (rows half as wide) with (G, N) `.gscale`s,
    concatenated along N, and an int8 embedding and LM head. MoE checkpoints
    (:179-219, :242-254, :261-288) bring per-expert w1/w2/w3 ((E, N, K),
    stacked to (L, E, 2H, dim) and (L, E, dim, H) with the scales' N axes
    concatenated the same way) and the router (L, E, dim), int8 with
    per-row scales on int8 and int4 checkpoints."""
    _check_slice(cfg)
    device = torch.device(device)
    t = yf.tensors
    d, h, q, kd = cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim
    int4 = "model.layers.0.attn.wq.weight.gscale" in t
    scaled = "model.embed.weight.scale" in t   # int8 and int4 checkpoints
    row = (lambda k: k // 2) if int4 else (lambda k: k)   # stored row width
    experts = (cfg.n_experts,) if cfg.is_moe else ()

    def get(name, shape):
        if tuple(t[name].shape) != shape:
            raise ValueError(f"tensor {name}: expected {shape}, got {t[name].shape}")
        return _host(yf.torch(name))

    def stack(parts_of_layer):
        first = parts_of_layer(0)
        out = torch.empty((cfg.n_layers,) + tuple(first.shape), dtype=first.dtype,
                          device=device)
        for l in range(cfg.n_layers):
            int_view(out[l]).copy_(int_view(first if l == 0 else parts_of_layer(l)))
        return out

    def layer_cat(specs, dim=0):
        return lambda l: torch.cat([get(f.format(l), s) for f, s in specs], dim=dim)

    def put(x):
        return int_view(torch.empty_like(x, device=device)).copy_(int_view(x)).view(x.dtype)

    def proj(names, n_rows, k, lead=()):
        """One projection's layer stack: the named tensors' rows concatenated
        (n_rows each, after the `lead` axes: the experts), then their scales
        the same way, or None."""
        def specs(suffix, shape):
            return [(f"model.layers.{{}}.{nm}.weight{suffix}", lead + shape(n))
                    for nm, n in zip(names, n_rows)]
        ax = len(lead)
        w = stack(layer_cat(specs("", lambda n: (n, row(k))), dim=ax))
        if int4:
            G = k // int4_group(k)
            return w, stack(layer_cat(specs(".gscale", lambda n: (G, n)), dim=ax + 1))
        if scaled:
            return w, stack(layer_cat(specs(".scale", lambda n: (n,)), dim=ax))
        return w, None

    embed = put(get("model.embed.weight", (cfg.vocab_size, d)))
    lm = (put(get("model.output.weight", (cfg.vocab_size, d)))
          if "model.output.weight" in t else embed)
    bqkv = None
    if cfg.has_qkv_bias:
        bqkv = stack(layer_cat([("model.layers.{}.attn.wq.bias", (q,)),
                                ("model.layers.{}.attn.wk.bias", (kd,)),
                                ("model.layers.{}.attn.wv.bias", (kd,))])).float()
    wqkv, sqkv = proj(("attn.wq", "attn.wk", "attn.wv"), (q, kd, kd), d)
    wo, so = proj(("attn.wo",), (d,), q)
    w13, s13 = proj(("mlp.w1", "mlp.w3"), (h, h), d, experts)
    w2, s2 = proj(("mlp.w2",), (d,), h, experts)
    moegate = smoe = None
    if cfg.is_moe:   # the router: never packed, int8 + scale on int8/int4 checkpoints
        moegate = stack(layer_cat([("model.layers.{}.moegate.weight", (cfg.n_experts, d))]))
        if scaled:
            smoe = stack(layer_cat([("model.layers.{}.moegate.weight.scale",
                                     (cfg.n_experts,))]))
    scales = None
    if scaled:
        semb = put(get("model.embed.weight.scale", (cfg.vocab_size,)))
        scales = FastScales(
            embed=semb, wqkv=sqkv, wo=so, w13=s13, w2=s2,
            lm_head=(put(get("model.output.weight.scale", (cfg.vocab_size,)))
                     if "model.output.weight.scale" in t else semb),
            moegate=smoe)
    return FastWeights(
        embed=embed,
        rms_att=stack(layer_cat([("model.layers.{}.attn.norm.weight", (d,))])),
        rms_ffn=stack(layer_cat([("model.layers.{}.mlp.norm.weight", (d,))])),
        wqkv=wqkv, wo=wo, w13=w13, w2=w2,
        final_norm=put(get("model.norm.weight", (d,))),
        lm_head=lm, bqkv=bqkv, scales=scales, moegate=moegate)


def fast_weights_from_numpy(arrays: Mapping[str, np.ndarray], cfg: ModelConfig,
                            device="cpu") -> FastWeights:
    """The port's FastWeights from the JAX package's FastWeights fields given
    as numpy arrays (`arrays["scales"]`, if present, a mapping of the
    FastScales fields). bf16/fp8 arrays of ml_dtypes' types are recognised
    by dtype name and reinterpreted through same-width integer views;
    packed int4 weights are uint8 with (L, [E,] G, N) group scales; MoE
    models bring the expert stacks (L, E, N, K) and the router `moegate`."""
    _check_slice(cfg)

    def conv(a):
        return _host(numpy_to_torch(a, tag_for_numpy(a))).to(device)

    scales = arrays.get("scales")
    kw = {f.name: conv(arrays[f.name]) for f in fields(FastWeights)
          if f.name != "scales" and arrays.get(f.name) is not None}
    if scales is not None:
        kw["scales"] = FastScales(**{f.name: conv(scales[f.name])
                                     for f in fields(FastScales)
                                     if scales.get(f.name) is not None})
    return FastWeights(**kw)


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, fw: FastWeights, tokens) -> torch.Tensor:
    """(T, dim) f32 embedding rows, gathered through an integer view of the
    table (not every backend indexes fp8 tensors)."""
    idx = torch.as_tensor(tokens, dtype=torch.long, device=fw.embed.device).reshape(-1)
    x = int_view(fw.embed).index_select(0, idx).view(fw.embed.dtype).float()
    if cfg.embed_scale != 1.0:
        x = x * cfg.embed_scale
    if fw.scales is not None:
        x = x * fw.scales.embed.index_select(0, idx)[:, None]
    return x


def _clip(cfg: ModelConfig, a: torch.Tensor) -> torch.Tensor:
    if math.isinf(cfg.qkv_clip):
        return a
    return torch.clamp(a, -cfg.qkv_clip, cfg.qkv_clip)


def ring_slots(pos: int, window: int) -> tuple[int, int, int]:
    """(kv_sink, kv_pos, kv_len) of absolute position pos in the ring buffer
    (fast.py:587-589): KV_SINKS sink slots once pos >= window."""
    kv_sink = KV_SINKS if pos >= window else 0
    kv_pos = kv_sink + (pos - kv_sink) % (window - kv_sink)
    return kv_sink, kv_pos, min(pos + 1, window)


def decode_step_fast(cfg: ModelConfig, fw: FastWeights, token, pos: int,
                     cache: KVCache, *, output_logits: bool = True
                     ) -> tuple[Optional[torch.Tensor], KVCache]:
    """One decode step at absolute position `pos`; updates `cache` in place
    and returns (logits (vocab,) f32 or None, cache). `token` is an int or a
    one-element tensor on the weights' device. MoE layers run the routed
    experts only (`_moe_ffn_one`)."""
    _check_slice(cfg)
    sc = fw.scales
    pos = int(pos)
    x = _embed(cfg, fw, token)[0]
    kv_sink, kv_pos, kv_len = ring_slots(pos, cfg.max_seq_len)
    rope = dict(kv_sinks=KV_SINKS, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    # one route for every weight type: attn_block/ffn run the int4 twins of
    # the same launch sequences for packed int4 weights (the JAX package's
    # unfused int4 fork exists for Mosaic's tiling rules only)

    for i in range(cfg.n_layers):
        x = attn_block(
            x, fw.rms_att, fw.wqkv, fw.wo, cache.k, cache.v, i,
            kv_pos, kv_len, kv_sink, pos, n_heads=cfg.n_heads,
            norm_eps=cfg.norm_eps, qkv_clip=cfg.qkv_clip, bqkv_all=fw.bqkv,
            scale_qkv=sc.wqkv if sc else None,
            scale_o=sc.wo if sc else None, **rope)
        if cfg.is_moe:
            x = _moe_ffn_one(cfg, fw, x, i)
        else:
            x = ffn(x, fw.rms_ffn, fw.w13, fw.w2, i,
                    sc.w13 if sc else None, sc.w2 if sc else None,
                    norm_eps=cfg.norm_eps, act=cfg.act_type)

    if not output_logits:
        return None, cache
    x = rmsnorm(x, fw.final_norm, cfg.norm_eps)
    return gemv(x, fw.lm_head, sc.lm_head if sc else None), cache


def _proj1_le(x1d, w_all, layer, expert, scale, **kw):
    """Routed-expert GEMV of one token (gemv_le, or gemv4_le for packed int4
    experts; fast.py:366-369); kw: the rmsnorm prologue, the GLU epilogue."""
    return (gemv4_le if is_int4(w_all) else gemv_le)(x1d, w_all, layer, expert, scale, **kw)


def _moe_ffn_one(cfg: ModelConfig, fw: FastWeights, x: torch.Tensor, layer: int) -> torch.Tensor:
    """One token's MoE FFN (fast.py:765-778): the router GEMV on rmsnorm(x),
    the top-k gate, then per routed expert j in rank order x += gates[j] *
    W2_e @ bf16(act(h1) * h3), [h1; h3] = W13_e @ rmsnorm(x) (the norm in
    each GEMV's prologue, the GLU in the w13 GEMV's epilogue). The expert
    ids stay on the device: the kernels read them there."""
    sc = fw.scales
    s13, s2 = (sc.w13, sc.w2) if sc else (None, None)
    norm = dict(norm_w=fw.rms_ffn, norm_eps=cfg.norm_eps)
    router = gemv_l(x, fw.moegate, layer, scale=sc.moegate if sc else None, **norm)
    gates, idx = moe_gate(router, cfg.n_experts_active)
    out = x
    for j in range(cfg.n_experts_active):
        h = _proj1_le(x, fw.w13, layer, idx[j], s13, glu_act=cfg.act_type, **norm)
        out = out + gates[j] * _proj1_le(h, fw.w2, layer, idx[j], s2)
    return out


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def _attend_chunk_bf16(q4, kc, vc, mask, D):
    """Chunk attention with bf16 operands, f32 sums and an f32 softmax
    (fast.py:943-955); plain torch on every device."""
    scores = torch.einsum("tgqd,lgd->gqtl", bf16f(q4), bf16f(kc)) / math.sqrt(D)
    scores = torch.where(mask[None, None], scores, torch.full_like(scores, NEG_INF))
    att = torch.softmax(scores, dim=-1)
    return torch.einsum("gqtl,lgd->tgqd", bf16f(att), bf16f(vc))


def _proj_l(x2d, w_all, layer, scale, residual=None):
    """Layer-indexed projection of a chunk (gemm_l, or gemm4_l for packed
    int4 weights), + residual in the kernel's epilogue."""
    if _build.device_kind(x2d, w_all, scale, residual) == "cpu":
        out = proj_plain(x2d, w_all, layer, scale)
        return out if residual is None else residual + out
    return launch_gemm("gemm4_l" if is_int4(w_all) else "gemm_l", x2d.contiguous(), w_all,
                       layer, scale,
                       residual=None if residual is None else residual.contiguous())


def _proj_le(x2d, w_all, layer, expert, scale, glu_act=None):
    """Routed-expert projection of a chunk's rows (gemm_le, or gemm4_le for
    packed int4 experts; fast.py:359-363), with the GLU-pair epilogue."""
    return (gemm4_le if is_int4(w_all) else gemm_le)(x2d, w_all, layer, expert, scale,
                                                      glu_act=glu_act)


def _moe_ffn_batched(cfg: ModelConfig, fw: FastWeights, x2d: torch.Tensor,
                     layer: int) -> torch.Tensor:
    """The MoE FFN of a block of rows (fast.py:478-500), shared by every
    chunk path (prefill, the tick, the chunk sweep; dense and paged), so
    their streams agree: rmsnorm, the router GEMM, the top-k gate per row,
    then EVERY expert streamed once over all rows with each row's gate for
    it (0 where the expert is not routed), summed from zero in expert order;
    x2d + delta last. (Single-stream decode adds its experts to x in rank
    order instead, as JAX's does.)"""
    sc = fw.scales
    s13, s2 = (sc.w13, sc.w2) if sc else (None, None)
    xb2 = rmsnorm(x2d, fw.rms_ffn[layer], cfg.norm_eps)
    router = _proj_l(xb2, fw.moegate, layer, sc.moegate if sc else None)
    gates, idx = moe_gate(router, cfg.n_experts_active)        # (rows, k) each
    delta = torch.zeros_like(x2d)
    for e in range(cfg.n_experts):
        gate_e = torch.sum(torch.where(idx == e, gates, torch.zeros_like(gates)), dim=-1)
        h = _proj_le(xb2, fw.w13, layer, e, s13, glu_act=cfg.act_type)
        delta = delta + gate_e[:, None] * _proj_le(h, fw.w2, layer, e, s2)
    return x2d + delta


def _ffn_rows(cfg: ModelConfig, fw: FastWeights, x: torch.Tensor, layer: int) -> torch.Tensor:
    """x + FFN(x) of a tick's or a chunk sweep's rows: the all-expert sweep
    for MoE models, else the many-row `ffn`."""
    if cfg.is_moe:
        return _moe_ffn_batched(cfg, fw, x, layer)
    sc = fw.scales
    return ffn(x, fw.rms_ffn, fw.w13, fw.w2, layer, sc.w13 if sc else None,
               sc.w2 if sc else None, norm_eps=cfg.norm_eps, act=cfg.act_type)


def _prefill_forward(cfg: ModelConfig, fw: FastWeights, tokens, pos0: int, valid_len: int,
                     attend_len: int, layers, rows_at, view_of, logits_mode: str, what: str):
    """One lane's chunked prefill (fast.py:884-1000, 1511-1621): per layer
    the projections on gemm_l, RoPE, the valid rows' k/v written IN PLACE
    at `rows_at` of the layer's cache view `layers(i)` = (k, v), chunk
    attention over `view_of(view)` (the lane's slots < S, (S, Hk, D)), wo and
    the FFN. Returns the logits of `logits_mode`."""
    _check_slice(cfg)
    dev = fw.wqkv.device
    tok = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev).reshape(-1)
    T = tok.shape[0]
    L = cfg.max_seq_len
    S = attend_len or L
    if S % 8 or S > L or pos0 + T > S or not 0 < valid_len <= T:
        raise ValueError(f"{what}: chunk {pos0}+{T} (valid {valid_len}) "
                         f"vs attend_len {S}, window {L}")
    if logits_mode not in ("none", "last", "all"):
        raise ValueError(f"bad logits_mode {logits_mode!r}")
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qpk = Hq // Hk
    H = cfg.hidden_dim
    act = silu if cfg.act_type == "silu" else gelu
    sc = fw.scales

    positions = pos0 + torch.arange(T, device=dev)
    att_mask = torch.arange(S, device=dev)[None, :] <= positions[:, None]
    x = _embed(cfg, fw, tok)                           # (T, dim)

    for i in range(cfg.n_layers):
        xb = rmsnorm(x, fw.rms_att[i], cfg.norm_eps)
        qkv = _proj_l(xb, fw.wqkv, i, sc.wqkv if sc else None)
        if fw.bqkv is not None:
            qkv = qkv + fw.bqkv[i]
        qkv = _clip(cfg, qkv)
        q = apply_rope(qkv[:, : cfg.q_dim].reshape(T, Hq, D), positions,
                       cfg.rope_param, cfg.rotary_dim)
        k = apply_rope(qkv[:, cfg.q_dim: cfg.q_dim + cfg.kv_dim].reshape(T, Hk, D),
                       positions, cfg.rope_param, cfg.rotary_dim)
        v = qkv[:, cfg.q_dim + cfg.kv_dim:].reshape(T, Hk, D)
        kl, vl = layers(i)
        for c, rows in ((kl, k), (vl, v)):
            int_view(c)[rows_at] = int_view(rows[:valid_len].to(c.dtype))
        mixed = _attend_chunk_bf16(q.reshape(T, Hk, qpk, D), view_of(kl), view_of(vl),
                                   att_mask, D)
        x = x + _proj_l(mixed.reshape(T, cfg.q_dim), fw.wo, i, sc.wo if sc else None)
        if cfg.is_moe:
            x = _moe_ffn_batched(cfg, fw, x, i)
        else:
            xb2 = rmsnorm(x, fw.rms_ffn[i], cfg.norm_eps)
            h13 = _proj_l(xb2, fw.w13, i, sc.w13 if sc else None)
            h = act(h13[:, :H]) * h13[:, H:]
            x = x + _proj_l(h, fw.w2, i, sc.w2 if sc else None)

    if logits_mode == "none":
        return None
    if logits_mode == "last":
        xl = rmsnorm(x[valid_len - 1], fw.final_norm, cfg.norm_eps)
        return gemv(xl, fw.lm_head, sc.lm_head if sc else None)
    xn = rmsnorm(x, fw.final_norm, cfg.norm_eps)
    return gemm(xn, fw.lm_head, sc.lm_head if sc else None)


def prefill_fast(cfg: ModelConfig, fw: FastWeights, tokens, pos0: int,
                 valid_len: int, cache: KVCache, *, logits_mode: str = "last",
                 attend_len: int = 0) -> tuple[Optional[torch.Tensor], KVCache]:
    """Chunked prefill of `tokens` (a padded chunk of T ids; the first
    valid_len are real) at positions pos0.., inside the window. Writes the
    valid rows' k/v into the cache in place. attend_len (0 = the window)
    bounds the attention width; it must cover pos0 + T.

    logits_mode: "none" -> None; "last" -> (vocab,) logits of the last valid
    token; "all" -> (T, vocab)."""
    S = attend_len or cfg.max_seq_len
    out = _prefill_forward(cfg, fw, tokens, pos0, valid_len, attend_len,
                           lambda i: (cache.k[i], cache.v[i]),
                           slice(pos0, pos0 + valid_len), lambda c: c[:S], logits_mode,
                           "prefill_fast")
    return out, cache


def prefill_fast_paged(cfg: ModelConfig, fw: FastWeights, tokens, pos0: int, valid_len: int,
                       pool: PagedKVPool, table_b, page: int, row0: int, *,
                       logits_mode: str = "last", page_size: int = 256, attend_len: int = 0
                       ) -> tuple[Optional[torch.Tensor], PagedKVPool]:
    """Chunked prefill of ONE lane through its page table (fast.py:1511-1621):
    the chunk's valid rows land in one page, rows row0.. of (page, layer),
    IN PLACE; attention gathers the lane's pages (`table_b`, (window //
    page_size,) ids) covering attend_len (0 = the window; slots past a
    lane's history are masked causally). Other arguments as prefill_fast."""
    nblk = cfg.max_seq_len // page_size
    if pool.page_size != page_size or cfg.max_seq_len % page_size:
        raise ValueError(f"prefill_fast_paged: pool pages of {pool.page_size} vs page_size "
                         f"{page_size}, window {cfg.max_seq_len}")
    if not (0 <= row0 and row0 + valid_len <= page_size and pos0 % page_size == row0):
        raise ValueError(f"prefill_fast_paged: rows {row0}+{valid_len} at {pos0} do not fit "
                         f"one page of {page_size}")
    tab = page_tables(torch.as_tensor(table_b).reshape(1, -1), n_pages=pool.k.shape[0],
                      nblk=nblk, device=pool.k.device)[0]
    if not 0 <= page < pool.k.shape[0]:
        raise ValueError(f"prefill_fast_paged: page {page} outside the pool")
    S = attend_len or cfg.max_seq_len
    nb = -(-S // page_size)
    out = _prefill_forward(cfg, fw, tokens, pos0, valid_len, attend_len,
                           lambda i: (pool.k[:, i], pool.v[:, i]),
                           (page, slice(row0, row0 + valid_len)),
                           lambda c: gather_pages(c, tab[:nb])[:S], logits_mode,
                           "prefill_fast_paged")
    return out, pool


# ---------------------------------------------------------------------------
# continuous batching: the batched tick and batched chunk admission
# ---------------------------------------------------------------------------

def _host_ints(a, n: int | None = None) -> np.ndarray:
    """Per-lane host integers (the scheduler's positions live on the host,
    so no device value is read back)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    out = np.asarray(a, np.int64).reshape(-1)
    if n is not None and out.shape != (n,):
        raise ValueError(f"expected {n} per-lane values, got {out.shape}")
    return out


def _tick_lanes(cfg: ModelConfig, positions, write_mask, device) -> torch.Tensor:
    """The tick's (5, B) lane scalars from host positions (fast.py:823-826):
    ring slot, length and sinks of every lane, uploaded once."""
    pos = _host_ints(positions)
    L = cfg.max_seq_len
    kv_sink = np.where(pos >= L, KV_SINKS, 0)
    kv_pos = kv_sink + (pos - kv_sink) % (L - kv_sink)
    kv_len = np.minimum(pos + 1, L)
    write = None if write_mask is None else _host_ints(write_mask, pos.shape[0])
    return lane_scalars(kv_pos, kv_len, kv_sink, pos, write, S=L, kv_sinks=KV_SINKS,
                        device=device)


def _tick_forward(cfg: ModelConfig, fw: FastWeights, tokens, attend) -> torch.Tensor:
    """The tick's body (fast.py:802-876, 1434-1507): per layer rmsnorm, the
    wqkv GEMM over the B rows, bias and clip, `attend(i, q, k, v)` (the
    batched or paged attention step), the wo GEMM + residual, the many-row
    FFN (the all-expert sweep for MoE); then the final norm and the LM-head
    GEMM. Returns (B, vocab)."""
    _check_slice(cfg)
    sc = fw.scales
    Hk, D = cfg.n_kv_heads, cfg.head_dim
    qpk = cfg.n_heads // Hk
    x = _embed(cfg, fw, tokens)                        # (B, dim)
    Bn = x.shape[0]
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim

    for i in range(cfg.n_layers):
        xb = rmsnorm(x, fw.rms_att[i], cfg.norm_eps)
        qkv = _proj_l(xb, fw.wqkv, i, sc.wqkv if sc else None)
        if fw.bqkv is not None:
            qkv = qkv + fw.bqkv[i]
        qkv = _clip(cfg, qkv)
        mixed = attend(i, qkv[:, :q_dim].reshape(Bn, Hk, qpk, D),
                       qkv[:, q_dim:q_dim + kv_dim].reshape(Bn, Hk, D),
                       qkv[:, q_dim + kv_dim:].reshape(Bn, Hk, D))
        x = _proj_l(mixed.reshape(Bn, q_dim), fw.wo, i, sc.wo if sc else None, residual=x)
        x = _ffn_rows(cfg, fw, x, i)

    x = rmsnorm(x, fw.final_norm, cfg.norm_eps)
    return gemm(x, fw.lm_head, sc.lm_head if sc else None)


def decode_step_fast_batched(cfg: ModelConfig, fw: FastWeights, tokens, positions,
                             cache: KVCache, write_mask=None
                             ) -> tuple[torch.Tensor, KVCache]:
    """One decode tick for B independent sequences sharing the weights
    (fast.py:802-876). tokens (B,) ids; positions (B,) absolute positions
    and write_mask (B,) (0 = read-only lane; default every lane writes) on
    the host; cache batched (B, L, S, Hk, D), updated IN PLACE. Per layer:
    rmsnorm, the wqkv GEMM over the B rows, bias and clip, the batched
    attention step, the wo GEMM + residual, the many-row FFN; then the
    final norm and the LM-head GEMM. Returns (logits (B, vocab) f32, cache)."""
    Bn = _host_ints(positions).shape[0]
    if cache.k.dim() != 5 or cache.k.shape[0] != Bn:
        raise ValueError(f"decode_step_fast_batched: cache {tuple(cache.k.shape)} vs {Bn} lanes")
    lanes = _tick_lanes(cfg, positions, write_mask, fw.wqkv.device)
    rope = dict(kv_sinks=KV_SINKS, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    logits = _tick_forward(cfg, fw, tokens, lambda i, q, k, v: attend_step_batched(
        q, k, v, cache.k, cache.v, i, lanes, **rope))
    return logits, cache


def decode_step_fast_batched_paged(cfg: ModelConfig, fw: FastWeights, tokens, positions,
                                   pool: PagedKVPool, tables, write_mask=None, *,
                                   page_size: int = 256) -> tuple[torch.Tensor, PagedKVPool]:
    """decode_step_fast_batched over a PAGED pool (fast.py:1434-1507): lane
    b's logical slots resolve through tables[b] ((B, window // page_size)
    page ids) into the shared pool, updated IN PLACE. The lane scalars and
    the tables are uploaded once per tick; each layer runs the paged
    attention step. Returns (logits (B, vocab) f32, pool)."""
    if pool.page_size != page_size or cfg.max_seq_len % page_size:
        raise ValueError(f"decode_step_fast_batched_paged: pool pages of {pool.page_size} vs "
                         f"page_size {page_size}, window {cfg.max_seq_len}")
    dev = fw.wqkv.device
    lanes = _tick_lanes(cfg, positions, write_mask, dev)
    tab = page_tables(tables, n_pages=pool.k.shape[0], nblk=cfg.max_seq_len // page_size,
                      device=dev)
    if tab.shape[0] != lanes.shape[1]:
        raise ValueError(f"decode_step_fast_batched_paged: tables {tuple(tab.shape)} vs "
                         f"{lanes.shape[1]} lanes")
    rope = dict(kv_sinks=KV_SINKS, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    logits = _tick_forward(cfg, fw, tokens, lambda i, q, k, v: attend_step_paged(
        q, k, v, pool.k, pool.v, tab, i, lanes, **rope))
    return logits, pool


def _attend_chunk_batched(q5, kc, vc, mask, D):
    """Batched chunk attention (fast.py:1332-1342): q5 (B, T, Hk, qpk, D),
    kc/vc (B, S, Hk, D), mask (B, T, S); bf16 operands, f32 sums and an f32
    softmax; plain torch on every device."""
    scores = torch.einsum("btgqd,bsgd->bgqts", bf16f(q5), bf16f(kc)) / math.sqrt(D)
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    att = torch.softmax(scores, dim=-1)
    return torch.einsum("bgqts,bsgd->btgqd", bf16f(att), bf16f(vc))


def _chunk_forward(cfg: ModelConfig, fw: FastWeights, tokens, pos0, valid_len, enable,
                   attend_len: int, layers, dest, view_of, logits_mode: str, what: str):
    """Batched chunked admission's body (fast.py:1307-1426, 1680-1787):
    every enabled lane's next prompt chunk in ONE weight sweep. Per layer
    the valid rows of enabled lanes are written IN PLACE into the layer's
    cache view `layers(i)` = (k, v) at `dest(lane ids, slots)` (an index
    tuple), and chunk attention reads `view_of(view)` ((B, S, Hk, D), the
    lanes' slots < S); other lanes change nothing."""
    _check_slice(cfg)
    sc = fw.scales
    dev = fw.wqkv.device
    tok = np.asarray(tokens, np.int64)
    if tok.ndim != 2:
        raise ValueError(f"{what}: tokens must be (B, T), got {tok.shape}")
    Bn, T = tok.shape
    p0, vlen = _host_ints(pos0, Bn), _host_ints(valid_len, Bn)
    en = _host_ints(enable, Bn) != 0
    L = cfg.max_seq_len
    S = attend_len or L
    if S % 8 or S > L:
        raise ValueError(f"{what}: attend_len {S} vs window {L}")
    if en.any() and ((p0[en] < 0).any() or (p0[en] + T > S).any()
                     or (vlen[en] < 0).any() or (vlen[en] > T).any()):
        raise ValueError(f"{what}: chunks at {p0[en].tolist()} of {T} rows "
                         f"(valid {vlen[en].tolist()}) vs attend_len {S}")
    if logits_mode not in ("none", "lastv", "all"):
        raise ValueError(f"bad logits_mode {logits_mode!r}")
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qpk = Hq // Hk
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim

    p0 = np.where(en, p0, 0)   # disabled lanes compute from slot 0 and write nothing
    positions = torch.as_tensor(p0[:, None] + np.arange(T)[None, :], device=dev)  # (B, T)
    att_mask = torch.arange(S, device=dev)[None, None, :] <= positions[:, :, None]
    # the rows to write: (lane, chunk row) of every valid row of an enabled lane
    li, ti = np.nonzero(en[:, None] & (np.arange(T)[None, :] < vlen[:, None]))
    li_t, ti_t = torch.as_tensor(li, device=dev), torch.as_tensor(ti, device=dev)
    at = dest(li, p0[li] + ti)
    x = _embed(cfg, fw, tok.reshape(-1))               # (B*T, dim)

    for i in range(cfg.n_layers):
        xb = rmsnorm(x, fw.rms_att[i], cfg.norm_eps)
        qkv = _proj_l(xb, fw.wqkv, i, sc.wqkv if sc else None)
        if fw.bqkv is not None:
            qkv = qkv + fw.bqkv[i]
        qkv = _clip(cfg, qkv).reshape(Bn, T, -1)
        q = apply_rope(qkv[..., :q_dim].reshape(Bn, T, Hq, D), positions,
                       cfg.rope_param, cfg.rotary_dim)
        k = apply_rope(qkv[..., q_dim:q_dim + kv_dim].reshape(Bn, T, Hk, D), positions,
                       cfg.rope_param, cfg.rotary_dim)
        v = qkv[..., q_dim + kv_dim:].reshape(Bn, T, Hk, D)
        kl, vl = layers(i)
        if len(li):
            for c, rows in ((kl, k), (vl, v)):
                int_view(c)[at] = int_view(rows[li_t, ti_t].to(c.dtype))
        mixed = _attend_chunk_batched(q.reshape(Bn, T, Hk, qpk, D), view_of(kl), view_of(vl),
                                      att_mask, D)
        x = _proj_l(mixed.reshape(Bn * T, q_dim), fw.wo, i, sc.wo if sc else None,
                    residual=x)
        x = _ffn_rows(cfg, fw, x, i)

    if logits_mode == "none":
        return None
    if logits_mode == "lastv":
        last = torch.as_tensor(np.maximum(vlen, 1) - 1, device=dev)
        x = x.reshape(Bn, T, -1)[torch.arange(Bn, device=dev), last]
        xn = rmsnorm(x, fw.final_norm, cfg.norm_eps)
        return gemm(xn, fw.lm_head, sc.lm_head if sc else None)
    xn = rmsnorm(x, fw.final_norm, cfg.norm_eps)
    return gemm(xn, fw.lm_head, sc.lm_head if sc else None).reshape(Bn, T, -1)


def prefill_chunk_fast_batched(cfg: ModelConfig, fw: FastWeights, tokens, pos0, valid_len,
                               enable, cache: KVCache, *, attend_len: int = 0,
                               logits_mode: str = "lastv"
                               ) -> tuple[Optional[torch.Tensor], KVCache]:
    """Batched chunked admission (fast.py:1283, 1307-1426): every enabled
    lane's next prompt chunk -- tokens (B, T) padded, its first valid_len[b]
    rows real, at positions pos0[b].. -- hydrates in ONE weight sweep. The
    valid rows of enabled lanes are written into the batched cache IN PLACE;
    other lanes change nothing. pos0/valid_len/enable are host values.
    attend_len (0 = the window) bounds the attention width; it must cover
    every enabled lane's pos0 + T.

    logits_mode: "lastv" -> (B, vocab) logits of each lane's last valid
    row; "none" -> None; "all" -> (B, T, vocab). ("all_h", Medusa's, comes
    with speculation.)"""
    Bn = np.asarray(tokens).shape[0]
    if cache.k.dim() != 5 or cache.k.shape[0] != Bn:
        raise ValueError(f"prefill_chunk_fast_batched: cache {tuple(cache.k.shape)} vs {Bn} lanes")
    dev = cache.k.device
    S = attend_len or cfg.max_seq_len
    out = _chunk_forward(cfg, fw, tokens, pos0, valid_len, enable, attend_len,
                         lambda i: (cache.k[:, i], cache.v[:, i]),
                         lambda li, slots: (torch.as_tensor(li, device=dev),
                                            torch.as_tensor(slots, device=dev)),
                         lambda c: c[:, :S], logits_mode, "prefill_chunk_fast_batched")
    return out, cache


def prefill_chunk_fast_batched_paged(cfg: ModelConfig, fw: FastWeights, tokens, pos0,
                                     valid_len, enable, pool: PagedKVPool, tables, *,
                                     page_size: int = 256, logits_mode: str = "lastv",
                                     attend_len: int = 0
                                     ) -> tuple[Optional[torch.Tensor], PagedKVPool]:
    """prefill_chunk_fast_batched over a PAGED pool (fast.py:1653,
    1680-1787): each enabled lane's valid chunk rows scatter through its
    page table (a chunk may straddle pages) into the pool IN PLACE, and
    chunk attention gathers each lane's pages covering attend_len (0 = the
    window). Enabled lanes must have their pages mapped through pos0 +
    valid_len (the scheduler's _ensure_pages). tables: (B, window //
    page_size) page ids on the host. Other arguments as
    prefill_chunk_fast_batched."""
    nblk = cfg.max_seq_len // page_size
    if pool.page_size != page_size or cfg.max_seq_len % page_size:
        raise ValueError(f"prefill_chunk_fast_batched_paged: pool pages of {pool.page_size} "
                         f"vs page_size {page_size}, window {cfg.max_seq_len}")
    tab_host = np.asarray(tables.cpu() if isinstance(tables, torch.Tensor) else tables)
    tab = page_tables(tab_host, n_pages=pool.k.shape[0], nblk=nblk, device=pool.k.device)
    if tab.shape[0] != np.asarray(tokens).shape[0]:
        raise ValueError(f"prefill_chunk_fast_batched_paged: tables {tuple(tab.shape)} vs "
                         f"tokens {np.asarray(tokens).shape}")
    dev = pool.k.device
    S = attend_len or cfg.max_seq_len
    nb = -(-S // page_size)
    out = _chunk_forward(cfg, fw, tokens, pos0, valid_len, enable, attend_len,
                         lambda i: (pool.k[:, i], pool.v[:, i]),
                         lambda li, slots: (torch.as_tensor(tab_host[li, slots // page_size],
                                                            dtype=torch.long, device=dev),
                                            torch.as_tensor(slots % page_size, device=dev)),
                         lambda c: gather_pages(c, tab[:, :nb])[:, :S], logits_mode,
                         "prefill_chunk_fast_batched_paged")
    return out, pool
