"""Fast decode and chunked prefill on the hand-written kernels (port of
`yalm_tpu/models/fast.py`, dense and MoE models on one device), single-sequence and
for the continuous-batching scheduler (`decode_step_fast_batched`: one tick
for B lanes of a batched cache; `prefill_chunk_fast_batched`: every
admitting lane's next prompt chunk in one weight sweep), and the same over a
paged KV pool (`decode_step_fast_batched_paged`, `prefill_fast_paged`,
`prefill_chunk_fast_batched_paged`; models/paged.py), and the verify
sweep of scheduler speculation (`verify_chunk_fast_batched[_paged]`: every
lane's K+1-row chunk in one weight sweep), tree-attention Medusa's
(`verify_tree_fast_batched`: a whole candidate tree per lane in one sweep,
the cache read only, then `scatter_tree_rows` for the accepted path), and
the debug capture of one decode step (`decode_step_fast(capture=True)`).

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
all-expert sweep on `gemm_le`/`gemm4_le`.

Gemma2, Gemma3 and Qwen3 (qk-norm, sandwich norms, the attention and final
softcaps, sliding-window layers, Gemma3's per-layer local rope) take the
JAX package's forms on every path: a decode step the fused block cannot
take (qk-norm, sandwich norms, a softcap or a sliding layer) runs the
unfused route -- the wqkv GEMV with the norm prologue, qk-norm, the
attention step with the layer's window, rope and cap, the wo GEMV, the
post-norm and the add; the FFN without its residual, then its post-norm --
and the chunk paths apply the same forms around their projections, the
softcap and the sliding mask in the chunk attention. Qwen3-MoE is qk-norm
over the MoE FFN.
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
from ..ops.cuda.attention import (attend_step_batched, attend_step_l, attend_step_paged,
                                  gather_pages, lane_scalars, page_tables)
from ..ops.cuda.block import attn_block
from ..ops.cuda.ffn import ffn
from ..ops.cuda.gemv import (bf16f, gemm, gemm4_le, gemm_le, gemv, gemv4_l, gemv4_le, gemv_l,
                             gemv_le, is_int4, launch_gemm, proj_plain)
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
    qnorm: Optional[torch.Tensor] = None    # (n_layers, head_dim) f32, qk-norm only
    knorm: Optional[torch.Tensor] = None    # (n_layers, head_dim) f32, qk-norm only
    pa: Optional[torch.Tensor] = None       # (n_layers, dim) f32, sandwich norms only
    pf: Optional[torch.Tensor] = None       # (n_layers, dim) f32, sandwich norms only

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

    @classmethod
    def from_weights(cls, w, cfg: ModelConfig) -> "FastWeights":
        """The decode layout of the oracle's Weights (models/weights.py),
        on their device: [wq; wk; wv] and [w1; w3] concatenated (per
        expert), f16 as bf16 (the kernels have no f16 type); int8 and int4
        checkpoints arrive dequantized to f32, so no scales. A tied LM head
        stays shared with the embedding."""
        lw = w.layers
        ax = 2 if cfg.is_moe else 1
        embed = _host(w.embed)
        return cls(
            embed=embed, rms_att=lw.rms_att.float(), rms_ffn=lw.rms_ffn.float(),
            wqkv=_host(torch.cat([lw.wq, lw.wk, lw.wv], dim=1)), wo=_host(lw.wo),
            w13=_host(torch.cat([lw.w1, lw.w3], dim=ax)), w2=_host(lw.w2),
            final_norm=w.final_norm.float(),
            lm_head=embed if w.lm_head is w.embed else _host(w.lm_head),
            bqkv=(torch.cat([lw.bq, lw.bk, lw.bv], dim=1).float()
                  if lw.bq is not None else None),
            moegate=None if lw.moegate is None else _host(lw.moegate),
            qnorm=lw.qn, knorm=lw.kn, pa=lw.pa, pf=lw.pf)


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


def mesh_coords(tp: int, ep: int, rank: int) -> dict:
    """The (ep, tp) coordinates of grid position `rank` in the ('dp', 'ep',
    'tp') grid, tp fastest (parallel/mesh.py)."""
    if tp < 1 or ep < 1 or rank < 0:
        raise ValueError(f"tp={tp}, ep={ep}, rank={rank}")
    return {"tp": rank % tp, "ep": (rank // tp) % ep}


def load_fast_weights(yf, cfg: ModelConfig, device="cuda", *, tp: int = 1, ep: int = 1,
                      rank: int = 0) -> FastWeights:
    """Load a dense checkpoint straight into the decode layout on `device`.

    Each layer's tensors are copied out of the checkpoint mmap, concatenated
    on the host and written into a preallocated device stack, so neither the
    host nor the device holds a second copy of the whole model. int8
    checkpoints bring per-row `.scale`s, concatenated as their rows are.
    int4 checkpoints (yalm_tpu/models/fast.py:174-256) bring
    packed uint8 layer weights (rows half as wide) with (G, N) `.gscale`s,
    concatenated along N, and an int8 embedding and LM head. MoE checkpoints
    (:179-219, :242-254, :261-288) bring per-expert w1/w2/w3 ((E, N, K),
    stacked to (L, E, 2H, dim) and (L, E, dim, H) with the scales' N axes
    concatenated the same way) and the router (L, E, dim), int8 with
    per-row scales on int8 and int4 checkpoints. qk-norm and sandwich-norm
    models bring (L, head_dim) q/k norms and (L, dim) post-norms.

    tp, ep, rank: rank `rank` of a ('dp', 'ep', 'tp') mesh (parallel/mesh.py)
    reads only its shard out of the mmap, in the shard-major order of
    yalm_tpu/models/fast.py:53 (shard_major): its tp slice of the rows of
    wq, wk and wv ([wq_t; wk_t; wv_t]), of w1 and w3 ([w1_t; w3_t]), of
    the qkv biases and of the embedding and LM head (with their scales); its
    tp slice of the columns of wo and w2 (packed int4: whole groups, their
    group scales' rows; int8 row scales whole); its ep slice of the experts;
    norms and the router whole. The split is parallel/sharding.py's table."""
    from ..parallel.sharding import take_shard
    device = torch.device(device)
    t = yf.tensors
    me = mesh_coords(tp, ep, rank)
    d, h, q, kd = cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim
    int4 = "model.layers.0.attn.wq.weight.gscale" in t
    scaled = "model.embed.weight.scale" in t   # int8 and int4 checkpoints
    row = (lambda k: k // 2) if int4 else (lambda k: k)   # stored row width
    experts = (cfg.n_experts,) if cfg.is_moe else ()

    def get(name, shape, cuts=()):
        """The tensor's shard: cuts of (dim, tp or ep) take this rank's
        chunk of the mmap view before anything is copied."""
        if tuple(t[name].shape) != shape:
            raise ValueError(f"tensor {name}: expected {shape}, got {t[name].shape}")
        view = take_shard(t[name], cuts, {"tp": tp, "ep": ep}, me, f"tensor {name}")
        return _host(numpy_to_torch(view, yf.dtypes[name]))

    def stack(parts_of_layer):
        first = parts_of_layer(0)
        out = torch.empty((cfg.n_layers,) + tuple(first.shape), dtype=first.dtype,
                          device=device)
        for l in range(cfg.n_layers):
            int_view(out[l]).copy_(int_view(first if l == 0 else parts_of_layer(l)))
        return out

    def layer_cat(specs, dim=0):
        return lambda l: torch.cat([get(f.format(l), s, c) for f, s, c in specs], dim=dim)

    def put(x):
        return int_view(torch.empty_like(x, device=device)).copy_(int_view(x)).view(x.dtype)

    def proj(names, n_rows, k, lead=(), cols=False):
        """One projection's layer stack: the named tensors' rows concatenated
        (n_rows each, after the `lead` axes: the experts), then their scales
        the same way, or None. cols: a row-parallel projection (wo, w2),
        whose input columns split over tp; else its rows do."""
        ax = len(lead)
        e = ((0, "ep"),) if lead else ()
        def specs(suffix, shape, cut):
            return [(f"model.layers.{{}}.{nm}.weight{suffix}", lead + shape(n), e + cut)
                    for nm, n in zip(names, n_rows)]
        w = stack(layer_cat(specs("", lambda n: (n, row(k)), ((ax + (1 if cols else 0), "tp"),)),
                            dim=ax))
        if int4:   # (G, N): a row-parallel split cuts whole groups, a column one N
            G = k // int4_group(k)
            return w, stack(layer_cat(specs(".gscale", lambda n: (G, n),
                                            ((ax + (0 if cols else 1), "tp"),)), dim=ax + 1))
        if scaled:   # per output row: whole for a row-parallel split
            return w, stack(layer_cat(specs(".scale", lambda n: (n,),
                                            () if cols else ((ax, "tp"),)), dim=ax))
        return w, None

    rows_tp = ((0, "tp"),)   # the tp slice of a tensor's rows: the vocab, the biases
    embed = put(get("model.embed.weight", (cfg.vocab_size, d), rows_tp))
    lm = (put(get("model.output.weight", (cfg.vocab_size, d), rows_tp))
          if "model.output.weight" in t else embed)
    bqkv = None
    if cfg.has_qkv_bias:
        bqkv = stack(layer_cat([("model.layers.{}.attn.wq.bias", (q,), rows_tp),
                                ("model.layers.{}.attn.wk.bias", (kd,), rows_tp),
                                ("model.layers.{}.attn.wv.bias", (kd,), rows_tp)])).float()
    wqkv, sqkv = proj(("attn.wq", "attn.wk", "attn.wv"), (q, kd, kd), d)
    wo, so = proj(("attn.wo",), (d,), q, cols=True)
    w13, s13 = proj(("mlp.w1", "mlp.w3"), (h, h), d, experts)
    w2, s2 = proj(("mlp.w2",), (d,), h, experts, cols=True)
    moegate = smoe = None
    if cfg.is_moe:   # the router: never packed, int8 + scale on int8/int4 checkpoints
        moegate = stack(layer_cat([("model.layers.{}.moegate.weight", (cfg.n_experts, d), ())]))
        if scaled:
            smoe = stack(layer_cat([("model.layers.{}.moegate.weight.scale",
                                     (cfg.n_experts,), ())]))
    scales = None
    if scaled:
        semb = put(get("model.embed.weight.scale", (cfg.vocab_size,), rows_tp))
        scales = FastScales(
            embed=semb, wqkv=sqkv, wo=so, w13=s13, w2=s2,
            lm_head=(put(get("model.output.weight.scale", (cfg.vocab_size,), rows_tp))
                     if "model.output.weight.scale" in t else semb),
            moegate=smoe)
    def norms(name, n, on):
        return (stack(layer_cat([(f"model.layers.{{}}.{name}.weight", (n,), ())]))
                if on else None)

    return FastWeights(
        embed=embed, rms_att=norms("attn.norm", d, True), rms_ffn=norms("mlp.norm", d, True),
        wqkv=wqkv, wo=wo, w13=w13, w2=w2,
        final_norm=put(get("model.norm.weight", (d,))),
        lm_head=lm, bqkv=bqkv, scales=scales, moegate=moegate,
        qnorm=norms("attn.q_norm", cfg.head_dim, cfg.has_qk_norm),
        knorm=norms("attn.k_norm", cfg.head_dim, cfg.has_qk_norm),
        pa=norms("attn.post_norm", d, cfg.has_post_norms),
        pf=norms("mlp.post_norm", d, cfg.has_post_norms))


def fast_weights_from_numpy(arrays: Mapping[str, np.ndarray], cfg: ModelConfig,
                            device="cpu", *, tp: int = 1, ep: int = 1,
                            rank: int = 0) -> FastWeights:
    """The port's FastWeights from the JAX package's FastWeights fields given
    as numpy arrays (`arrays["scales"]`, if present, a mapping of the
    FastScales fields). bf16/fp8 arrays of ml_dtypes' types are recognised
    by dtype name and reinterpreted through same-width integer views;
    packed int4 weights are uint8 with (L, [E,] G, N) group scales; MoE
    models bring the expert stacks (L, E, N, K) and the router `moegate`;
    qk-norm and sandwich-norm models their norms.

    tp, ep, rank: the arrays are the shard-major layout for tp
    (yalm_tpu/parallel/fast_tp.py:67 fast_tp_weights, or the JAX loader's
    load_fast_weights(tp=)), and rank `rank` of the mesh takes its chunk of
    each under parallel/sharding.py's table, copying only that."""
    from ..parallel.sharding import fast_weight_splits, take_shard
    me, shape = mesh_coords(tp, ep, rank), {"tp": tp, "ep": ep}
    table = fast_weight_splits(cfg, with_scales=arrays.get("scales") is not None)

    def conv(a, splits):
        a = take_shard(a, splits, shape, me)
        return _host(numpy_to_torch(a, tag_for_numpy(a))).to(device)

    scales = arrays.get("scales")
    kw = {f.name: conv(arrays[f.name], table[f.name]) for f in fields(FastWeights)
          if f.name != "scales" and arrays.get(f.name) is not None}
    if arrays.get("lm_head") is not None and arrays["lm_head"] is arrays["embed"]:
        kw["lm_head"] = kw["embed"]   # a tied head stays shared
    if scales is not None:
        kw["scales"] = FastScales(**{f.name: conv(scales[f.name], table["scales"][f.name])
                                     for f in fields(FastScales)
                                     if scales.get(f.name) is not None})
    return FastWeights(**kw)


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _reduces(shard) -> bool:
    """Whether a step on a mesh sums its row-parallel deltas over tp ranks
    (parallel/fast_tp.TPShard with tp > 1). Otherwise (one device, or a
    mesh whose tp groups are one rank) the kernels' residual epilogues add
    them, as on one device: at tp 1 the hook launches nothing."""
    return shard is not None and shard.tp > 1


def _embed(cfg: ModelConfig, fw: FastWeights, tokens, shard=None) -> torch.Tensor:
    """(T, dim) f32 embedding rows, gathered through an integer view of the
    table (not every backend indexes fp8 tensors). On a tp mesh the table
    is the rank's vocab slice: rows outside it are zeroed and the ranks'
    rows summed (fast_tp.py:210 _embed_psum; exact, one rank holds each)."""
    idx = torch.as_tensor(tokens, dtype=torch.long, device=fw.embed.device).reshape(-1)
    if _reduces(shard):
        idx, mine = shard.vocab_rows(idx)
    x = int_view(fw.embed).index_select(0, idx).view(fw.embed.dtype).float()
    if cfg.embed_scale != 1.0:
        x = x * cfg.embed_scale
    if fw.scales is not None:
        x = x * fw.scales.embed.index_select(0, idx)[:, None]
    if _reduces(shard):
        x = shard.reduce(torch.where(mine[:, None], x, torch.zeros_like(x)))
    return x


def _head(cfg: ModelConfig, fw: FastWeights, xn, shard=None) -> torch.Tensor:
    """The capped logits of final-normed rows: the LM-head GEMV for one row
    (dim,), the GEMM for (T, dim); on a tp mesh the rank's vocab slice,
    capped, then gathered into the full row (fast_tp.py:392-394)."""
    sc = fw.scales
    logits = _cap_logits(cfg, (gemv if xn.dim() == 1 else gemm)(
        xn, fw.lm_head, sc.lm_head if sc else None))
    return shard.gather(logits) if _reduces(shard) else logits


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


def _layer_win(cfg: ModelConfig, i: int) -> Optional[int]:
    """Layer i's sliding window for the attention kernels (fast.py:372-381):
    cfg.sliding_window on sliding layers, the full window on the others, or
    None when no layer slides."""
    if not any(cfg.layer_sliding):
        return None
    return cfg.sliding_window if cfg.layer_sliding[i] else cfg.max_seq_len


def _layer_alt(cfg: ModelConfig, i: int) -> Optional[int]:
    """Gemma3's dual rope (fast.py:384-393): the sliding flag selects the
    local theta; None unless the packed rope kind is "gemma3" and a layer
    slides."""
    if not (cfg.rope_scale and cfg.rope_scale[0] == "gemma3") or not any(cfg.layer_sliding):
        return None
    return int(cfg.layer_sliding[i])


def _attn_kw(cfg: ModelConfig, i: int) -> dict:
    """Layer i's Gemma forms of the attention steps."""
    return dict(win=_layer_win(cfg, i), alt=_layer_alt(cfg, i), softcap=cfg.attn_softcap)


def _sliding_mask_fn(cfg: ModelConfig, positions, att_mask, S: int):
    """mask_of(i) for the chunk paths (fast.py:396-407): att_mask on global
    layers, bounded by the sliding window on sliding ones. positions (T,)
    or (B, T); att_mask broadcasts with them."""
    if not any(cfg.layer_sliding):
        return lambda i: att_mask
    slide = att_mask & (positions[..., None] - torch.arange(S, device=att_mask.device)
                        < cfg.sliding_window)
    return lambda i: slide if cfg.layer_sliding[i] else att_mask


def _post_norm(delta, w_all, i: int, eps: float):
    """Gemma2's sandwich norm on a residual delta (w_all None: identity)."""
    return delta if w_all is None else rmsnorm(delta, w_all[i], eps)


def _cap_logits(cfg: ModelConfig, logits):
    if cfg.final_softcap:
        return cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _softcap_scores(cfg: ModelConfig, scores):
    """Gemma2's score cap, after the 1/sqrt(D) scale and before the mask."""
    if cfg.attn_softcap:
        return cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    return scores


def _qk_norm(q, k, fw: FastWeights, layer: int, cfg: ModelConfig):
    """Qwen3's per-head RMSNorm on flat q (..., q_dim) and k (..., kv_dim),
    between the projection and RoPE (fast.py:503-516); the query scale is
    folded into the q-norm weight. No-op without qk-norm weights."""
    if fw.qnorm is None:
        return q, k
    D = cfg.head_dim
    q = rmsnorm(q.reshape(*q.shape[:-1], -1, D), fw.qnorm[layer], cfg.norm_eps).reshape(q.shape)
    k = rmsnorm(k.reshape(*k.shape[:-1], -1, D), fw.knorm[layer], cfg.norm_eps).reshape(k.shape)
    return q, k


def _block_ok(cfg: ModelConfig, fw: FastWeights) -> bool:
    """Whether the fused attention block takes this model (fast.py:686-688)."""
    return (fw.qnorm is None and fw.pa is None and not cfg.attn_softcap
            and not any(cfg.layer_sliding))


def _attn_unfused(cfg: ModelConfig, fw: FastWeights, x, i: int, kv_pos: int, kv_len: int,
                  kv_sink: int, pos: int, cache: KVCache, shard=None):
    """One token's attention on the unfused route (fast.py:714-751): the
    wqkv GEMV with the norm prologue (packed int4: rmsnorm, then gemv4_l),
    bias, clip and qk-norm, the attention step with the layer's window,
    rope and cap, the wo GEMV, the post-norm and the residual add (on a tp
    mesh: the wo GEMV's partial sum over the ranks first, then the post-norm,
    fast_tp.py:337-338)."""
    sc = fw.scales
    Hk, D = cfg.n_kv_heads, cfg.head_dim
    if is_int4(fw.wqkv):
        qkv = gemv4_l(rmsnorm(x, fw.rms_att[i], cfg.norm_eps), fw.wqkv, i, sc.wqkv)
    else:
        qkv = gemv_l(x, fw.wqkv, i, norm_w=fw.rms_att, norm_eps=cfg.norm_eps,
                     scale=sc.wqkv if sc else None)
    if fw.bqkv is not None:
        qkv = qkv + fw.bqkv[i]
    qkv = _clip(cfg, qkv)
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim
    q, k = _qk_norm(qkv[:q_dim], qkv[q_dim:q_dim + kv_dim], fw, i, cfg)
    mixed = attend_step_l(q.reshape(Hk, -1, D), k.reshape(Hk, D),
                          qkv[q_dim + kv_dim:].reshape(Hk, D), cache.k, cache.v, i, kv_pos,
                          kv_len, kv_sink, pos, kv_sinks=KV_SINKS, theta=cfg.rope_param,
                          rotary_dim=cfg.rotary_dim, **_attn_kw(cfg, i)).reshape(q_dim)
    if is_int4(fw.wo) or fw.pa is not None or _reduces(shard):
        wo = (gemv4_l(mixed, fw.wo, i, sc.wo) if is_int4(fw.wo)
              else gemv_l(mixed, fw.wo, i, scale=sc.wo if sc else None))
        if _reduces(shard):
            wo = shard.reduce(wo)
        return x + _post_norm(wo, fw.pa, i, cfg.norm_eps)
    return gemv_l(mixed, fw.wo, i, residual=x, scale=sc.wo if sc else None)


def decode_step_fast(cfg: ModelConfig, fw: FastWeights, token, pos: int,
                     cache: KVCache, *, output_logits: bool = True, capture: bool = False,
                     shard=None):
    """One decode step at absolute position `pos`; updates `cache` in place
    and returns (logits (vocab,) f32 or None, cache). `token` is an int or a
    one-element tensor on the weights' device. MoE layers run the routed
    experts only (`_moe_ffn_one`); models the fused block cannot take run
    the unfused route (`_attn_unfused`).

    capture=True (fast.py:596-673) returns (logits, cache, capture map):
    the step on the unfused route with every kernel boundary exposed (the
    wqkv, wo, w13 and w2 GEMVs, the attention step, the routed experts'
    GEMVs, the LM-head GEMV), recording per layer att_in, post-rope q and
    k, v, att_mix, ffn_in and block_out, plus final_norm and logits: the
    oracle's capture map (models/transformer.py), for
    utils/debug.py:diff_captures. Packed int4 weights raise.

    shard (parallel/fast_tp.TPShard): the step of one rank of a mesh
    (fast_tp.py:255 make_decode_step_fast_tp) on its shard of the weights
    and its kv heads of the cache, with the collectives of the Megatron
    split; the logits are the full row on every rank."""
    if shard is not None:
        if capture:
            raise ValueError("capture mode runs on one device, not on a mesh")
        cfg = shard.cfg
    sc = fw.scales
    pos = int(pos)
    x = _embed(cfg, fw, token, shard)[0]
    kv_sink, kv_pos, kv_len = ring_slots(pos, cfg.max_seq_len)
    if capture:
        return _decode_capture(cfg, fw, x, pos, (kv_sink, kv_pos, kv_len), cache,
                               output_logits)
    rope = dict(kv_sinks=KV_SINKS, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    # one route for every weight type: attn_block/ffn run the int4 twins of
    # the same launch sequences for packed int4 weights (the JAX package's
    # unfused int4 fork exists for Mosaic's tiling rules only)
    fused = _block_ok(cfg, fw)

    split = _reduces(shard)
    for i in range(cfg.n_layers):
        if fused:
            # on a tp mesh the block's Wo @ attention is a partial sum: the
            # ranks' sum, then the residual (fast_tp.py:320-338)
            out = attn_block(
                x, fw.rms_att, fw.wqkv, fw.wo, cache.k, cache.v, i,
                kv_pos, kv_len, kv_sink, pos, n_heads=cfg.n_heads,
                norm_eps=cfg.norm_eps, qkv_clip=cfg.qkv_clip, bqkv_all=fw.bqkv,
                add_residual=not split, scale_qkv=sc.wqkv if sc else None,
                scale_o=sc.wo if sc else None, **rope)
            x = x + shard.reduce(out) if split else out
        else:
            x = _attn_unfused(cfg, fw, x, i, kv_pos, kv_len, kv_sink, pos, cache, shard)
        if cfg.is_moe:
            x = _moe_ffn_one(cfg, fw, x, i, shard)
        else:
            x = _ffn_rows(cfg, fw, x, i, shard)

    if not output_logits:
        return None, cache
    return _head(cfg, fw, rmsnorm(x, fw.final_norm, cfg.norm_eps), shard), cache


def _decode_capture(cfg: ModelConfig, fw: FastWeights, x, pos: int, slots, cache: KVCache,
                    output_logits: bool):
    """decode_step_fast(capture=True)'s body (fast.py:596-673)."""
    if is_int4(fw.wqkv):
        raise ValueError(
            "capture mode does not support packed int4 weights (the unfused capture "
            "sequence dispatches per-channel kernels); debug kernel boundaries with "
            "int8/fp8 checkpoints")
    sc = fw.scales
    kv_sink, kv_pos, kv_len = slots
    Hq, Hk, D, H = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.hidden_dim
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim
    act = silu if cfg.act_type == "silu" else gelu
    recs: list[dict] = []
    for i in range(cfg.n_layers):
        xb = rmsnorm(x, fw.rms_att[i], cfg.norm_eps)
        qkv = gemv_l(xb, fw.wqkv, i, scale=sc.wqkv if sc else None)
        if fw.bqkv is not None:
            qkv = qkv + fw.bqkv[i]
        qkv = _clip(cfg, qkv)
        q, k = _qk_norm(qkv[:q_dim], qkv[q_dim:q_dim + kv_dim], fw, i, cfg)
        v = qkv[q_dim + kv_dim:]
        alt = _layer_alt(cfg, i)
        rec = {"att_in": xb,   # the kernels rope internally: q and k post-rope, as the oracle's
               "q": apply_rope(q.reshape(Hq, D), pos, cfg.rope_param, cfg.rotary_dim, alt),
               "k": apply_rope(k.reshape(Hk, D), pos, cfg.rope_param, cfg.rotary_dim, alt),
               "v": v.reshape(Hk, D)}
        mixed = attend_step_l(q.reshape(Hk, -1, D), k.reshape(Hk, D), v.reshape(Hk, D),
                              cache.k, cache.v, i, kv_pos, kv_len, kv_sink, pos,
                              kv_sinks=KV_SINKS, theta=cfg.rope_param,
                              rotary_dim=cfg.rotary_dim, **_attn_kw(cfg, i))
        rec["att_mix"] = mixed.reshape(q_dim)
        if fw.pa is None:
            x = gemv_l(rec["att_mix"], fw.wo, i, residual=x, scale=sc.wo if sc else None)
        else:
            x = x + _post_norm(gemv_l(rec["att_mix"], fw.wo, i, scale=sc.wo if sc else None),
                               fw.pa, i, cfg.norm_eps)
        xb2 = rmsnorm(x, fw.rms_ffn[i], cfg.norm_eps)
        rec["ffn_in"] = xb2
        if cfg.is_moe:
            router = gemv_l(xb2, fw.moegate, i, scale=sc.moegate if sc else None)
            gates, idx = moe_gate(router, cfg.n_experts_active)
            for j in range(cfg.n_experts_active):
                h13 = _proj1_le(xb2, fw.w13, i, idx[j], sc.w13 if sc else None)
                h = act(h13[:H]) * h13[H:]
                x = x + gates[j] * _proj1_le(h, fw.w2, i, idx[j], sc.w2 if sc else None)
        else:
            h13 = gemv_l(xb2, fw.w13, i, scale=sc.w13 if sc else None)
            h = act(h13[:H]) * h13[H:]
            x = x + _post_norm(gemv_l(h, fw.w2, i, scale=sc.w2 if sc else None), fw.pf, i,
                               cfg.norm_eps)
        rec["block_out"] = x
        recs.append(rec)
    cap = {name: torch.stack([r[name] for r in recs]) for name in recs[0]}
    if not output_logits:
        return None, cache, cap
    xn = rmsnorm(x, fw.final_norm, cfg.norm_eps)
    cap["final_norm"] = xn
    cap["logits"] = _cap_logits(cfg, gemv(xn, fw.lm_head, sc.lm_head if sc else None))
    return cap["logits"], cache, cap


def _proj1_le(x1d, w_all, layer, expert, scale, **kw):
    """Routed-expert GEMV of one token (gemv_le, or gemv4_le for packed int4
    experts; fast.py:366-369); kw: the rmsnorm prologue, the GLU epilogue."""
    return (gemv4_le if is_int4(w_all) else gemv_le)(x1d, w_all, layer, expert, scale, **kw)


def _moe_ffn_one(cfg: ModelConfig, fw: FastWeights, x: torch.Tensor, layer: int,
                 shard=None) -> torch.Tensor:
    """One token's MoE FFN (fast.py:765-778): the router GEMV on rmsnorm(x),
    the top-k gate, then per routed expert j in rank order x += gates[j] *
    W2_e @ bf16(act(h1) * h3), [h1; h3] = W13_e @ rmsnorm(x) (the norm in
    each GEMV's prologue, the GLU in the w13 GEMV's epilogue). The expert
    ids stay on the device: the kernels read them there.

    On a mesh (fast_tp.py:345-364) the router is replicated and each rank
    holds its ep slice of the experts: a routed id maps to the rank's local
    expert, or to -1 where another rank holds it, which the routed GEMVs
    answer with zeros without loading a byte (JAX's lax.cond skip); the
    ranks' gated sums are summed over (ep, tp), then added to x."""
    sc = fw.scales
    s13, s2 = (sc.w13, sc.w2) if sc else (None, None)
    norm = dict(norm_w=fw.rms_ffn, norm_eps=cfg.norm_eps)
    router = gemv_l(x, fw.moegate, layer, scale=sc.moegate if sc else None, **norm)
    gates, idx = moe_gate(router, cfg.n_experts_active)
    if shard is not None and shard.moe_split:
        idx = shard.local_experts(idx)
        delta = torch.zeros_like(x)
        for j in range(cfg.n_experts_active):
            h = _proj1_le(x, fw.w13, layer, idx[j], s13, glu_act=cfg.act_type, **norm)
            delta = delta + gates[j] * _proj1_le(h, fw.w2, layer, idx[j], s2)
        return x + shard.reduce_experts(delta)
    out = x
    for j in range(cfg.n_experts_active):
        h = _proj1_le(x, fw.w13, layer, idx[j], s13, glu_act=cfg.act_type, **norm)
        out = out + gates[j] * _proj1_le(h, fw.w2, layer, idx[j], s2)
    return out


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def _attend_chunk_bf16(cfg, q4, kc, vc, mask, D):
    """Chunk attention with bf16 operands, f32 sums and an f32 softmax
    (fast.py:943-955), the softcap before the mask; plain torch on every
    device."""
    scores = torch.einsum("tgqd,lgd->gqtl", bf16f(q4), bf16f(kc)) / math.sqrt(D)
    scores = _softcap_scores(cfg, scores)
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
                     layer: int, shard=None) -> torch.Tensor:
    """The MoE FFN of a block of rows (fast.py:478-500), shared by every
    chunk path (prefill, the tick, the chunk sweep; dense and paged), so
    their streams agree: rmsnorm, the router GEMM, the top-k gate per row,
    then EVERY expert streamed once over all rows with each row's gate for
    it (0 where the expert is not routed), summed from zero in expert order;
    x2d + delta last. (Single-stream decode adds its experts to x in rank
    order instead, as JAX's does.) On a mesh each rank sweeps its local
    experts and the ranks' deltas are summed over (ep, tp) (fast_tp.py:
    477-500)."""
    sc = fw.scales
    s13, s2 = (sc.w13, sc.w2) if sc else (None, None)
    xb2 = rmsnorm(x2d, fw.rms_ffn[layer], cfg.norm_eps)
    router = _proj_l(xb2, fw.moegate, layer, sc.moegate if sc else None)
    gates, idx = moe_gate(router, cfg.n_experts_active)        # (rows, k) each
    split = shard is not None and shard.moe_split
    e0, n_local = (shard.e0, shard.E_l) if split else (0, cfg.n_experts)
    delta = torch.zeros_like(x2d)
    for e in range(n_local):
        gate_e = torch.sum(torch.where(idx == e0 + e, gates, torch.zeros_like(gates)), dim=-1)
        h = _proj_le(xb2, fw.w13, layer, e, s13, glu_act=cfg.act_type)
        delta = delta + gate_e[:, None] * _proj_le(h, fw.w2, layer, e, s2)
    return x2d + (shard.reduce_experts(delta) if split else delta)


def _ffn_rows(cfg: ModelConfig, fw: FastWeights, x: torch.Tensor, layer: int,
              shard=None) -> torch.Tensor:
    """x + FFN(x) of a token or of a tick's or a chunk's rows: the
    all-expert sweep for MoE models, else `ffn`; with sandwich norms the FFN
    without its residual, then the post-norm and the add (`_ffn2_l`,
    fast.py:448-475). On a tp mesh the FFN's w2 partial sums are summed over
    the ranks before the post-norm and the add (fast_tp.py:366-380)."""
    if cfg.is_moe:
        return _moe_ffn_batched(cfg, fw, x, layer, shard)
    sc = fw.scales
    fused = fw.pf is None and not _reduces(shard)
    out = ffn(x, fw.rms_ffn, fw.w13, fw.w2, layer, sc.w13 if sc else None,
              sc.w2 if sc else None, norm_eps=cfg.norm_eps, act=cfg.act_type,
              add_residual=fused)
    if fused:
        return out
    if _reduces(shard):
        out = shard.reduce(out)
    return x + _post_norm(out, fw.pf, layer, cfg.norm_eps)


def _wo_rows(cfg: ModelConfig, fw: FastWeights, mixed, x, layer: int, shard=None):
    """x + Wo @ mixed of a chunk's or a tick's rows: the residual in the
    GEMM's epilogue, or with sandwich norms the post-norm before the add;
    on a tp mesh the ranks' partial sums are summed first."""
    sc = fw.scales
    s = sc.wo if sc else None
    if fw.pa is None and not _reduces(shard):
        return _proj_l(mixed, fw.wo, layer, s, residual=x)
    out = _proj_l(mixed, fw.wo, layer, s)
    if _reduces(shard):
        out = shard.reduce(out)
    return x + _post_norm(out, fw.pa, layer, cfg.norm_eps)


def _prefill_forward(cfg: ModelConfig, fw: FastWeights, tokens, pos0: int, valid_len: int,
                     attend_len: int, layers, rows_at, view_of, logits_mode: str, what: str,
                     shard=None):
    """One lane's chunked prefill (fast.py:884-1000, 1511-1621): per layer
    the projections on gemm_l, RoPE, the valid rows' k/v written IN PLACE
    at `rows_at` of the layer's cache view `layers(i)` = (k, v), chunk
    attention over `view_of(view)` (the lane's slots < S, (S, Hk, D)), wo and
    the FFN. Returns the logits of `logits_mode`."""
    dev = fw.wqkv.device
    tok = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev).reshape(-1)
    T = tok.shape[0]
    L = cfg.max_seq_len
    S = attend_len or L
    if S % 8 or S > L or pos0 + T > S or not 0 < valid_len <= T:
        raise ValueError(f"{what}: chunk {pos0}+{T} (valid {valid_len}) "
                         f"vs attend_len {S}, window {L}")
    if logits_mode not in ("none", "last", "all", "all_h"):
        raise ValueError(f"bad logits_mode {logits_mode!r}")
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qpk = Hq // Hk
    H = cfg.hidden_dim
    act = silu if cfg.act_type == "silu" else gelu
    sc = fw.scales

    positions = pos0 + torch.arange(T, device=dev)
    att_mask = torch.arange(S, device=dev)[None, :] <= positions[:, None]
    # sliding layers: no ring during prefill, the slot index is the position
    mask_of = _sliding_mask_fn(cfg, positions, att_mask, S)
    x = _embed(cfg, fw, tok, shard)                    # (T, dim)

    for i in range(cfg.n_layers):
        xb = rmsnorm(x, fw.rms_att[i], cfg.norm_eps)
        qkv = _proj_l(xb, fw.wqkv, i, sc.wqkv if sc else None)
        if fw.bqkv is not None:
            qkv = qkv + fw.bqkv[i]
        qkv = _clip(cfg, qkv)
        qf, kf = _qk_norm(qkv[:, :cfg.q_dim], qkv[:, cfg.q_dim: cfg.q_dim + cfg.kv_dim],
                          fw, i, cfg)
        alt = _layer_alt(cfg, i)
        q = apply_rope(qf.reshape(T, Hq, D), positions, cfg.rope_param, cfg.rotary_dim, alt)
        k = apply_rope(kf.reshape(T, Hk, D), positions, cfg.rope_param, cfg.rotary_dim, alt)
        v = qkv[:, cfg.q_dim + cfg.kv_dim:].reshape(T, Hk, D)
        kl, vl = layers(i)
        for c, rows in ((kl, k), (vl, v)):
            int_view(c)[rows_at] = int_view(rows[:valid_len].to(c.dtype))
        mixed = _attend_chunk_bf16(cfg, q.reshape(T, Hk, qpk, D), view_of(kl), view_of(vl),
                                   mask_of(i), D)
        x = _wo_rows(cfg, fw, mixed.reshape(T, cfg.q_dim), x, i, shard)
        if cfg.is_moe:
            x = _moe_ffn_batched(cfg, fw, x, i, shard)
        else:
            xb2 = rmsnorm(x, fw.rms_ffn[i], cfg.norm_eps)
            h13 = _proj_l(xb2, fw.w13, i, sc.w13 if sc else None)
            h = act(h13[:, :H]) * h13[:, H:]
            out = _proj_l(h, fw.w2, i, sc.w2 if sc else None)
            x = x + _post_norm(shard.reduce(out) if _reduces(shard) else out, fw.pf, i,
                               cfg.norm_eps)

    if logits_mode == "none":
        return None
    if logits_mode == "last":
        return _head(cfg, fw, rmsnorm(x[valid_len - 1], fw.final_norm, cfg.norm_eps), shard)
    xn = rmsnorm(x, fw.final_norm, cfg.norm_eps)
    logits = _head(cfg, fw, xn, shard)
    # "all_h": the post-final-norm rows beside the logits (Medusa's heads read them)
    return (logits, xn) if logits_mode == "all_h" else logits


def prefill_fast(cfg: ModelConfig, fw: FastWeights, tokens, pos0: int,
                 valid_len: int, cache: KVCache, *, logits_mode: str = "last",
                 attend_len: int = 0, shard=None) -> tuple[Optional[torch.Tensor], KVCache]:
    """Chunked prefill of `tokens` (a padded chunk of T ids; the first
    valid_len are real) at positions pos0.., inside the window. Writes the
    valid rows' k/v into the cache in place. attend_len (0 = the window)
    bounds the attention width; it must cover pos0 + T.

    logits_mode: "none" -> None; "last" -> (vocab,) logits of the last valid
    token; "all" -> (T, vocab); "all_h" -> ((T, vocab) logits, (T, dim)
    post-final-norm hidden rows), the rows Medusa's heads read.

    shard: one rank's chunk of a mesh (fast_tp.py:410 make_prefill_fast_tp):
    its heads, hidden slice and experts, the step's collectives; the logits
    are full rows on every rank."""
    S = attend_len or cfg.max_seq_len
    out = _prefill_forward(shard.cfg if shard is not None else cfg, fw, tokens, pos0,
                           valid_len, attend_len, lambda i: (cache.k[i], cache.v[i]),
                           slice(pos0, pos0 + valid_len), lambda c: c[:S], logits_mode,
                           "prefill_fast", shard)
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


def _tick_forward(cfg: ModelConfig, fw: FastWeights, tokens, attend, shard=None) -> torch.Tensor:
    """The tick's body (fast.py:802-876, 1434-1507): per layer rmsnorm, the
    wqkv GEMM over the B rows, bias and clip, `attend(i, q, k, v)` (the
    batched or paged attention step), the wo GEMM + residual, the many-row
    FFN (the all-expert sweep for MoE); then the final norm and the LM-head
    GEMM. `attend` takes layer i's Gemma forms as keywords. Returns (B,
    vocab). shard: one rank's lanes of a mesh (fast_tp.py:572-696)."""
    sc = fw.scales
    Hk, D = cfg.n_kv_heads, cfg.head_dim
    qpk = cfg.n_heads // Hk
    x = _embed(cfg, fw, tokens, shard)                 # (B, dim)
    Bn = x.shape[0]
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim

    for i in range(cfg.n_layers):
        xb = rmsnorm(x, fw.rms_att[i], cfg.norm_eps)
        qkv = _proj_l(xb, fw.wqkv, i, sc.wqkv if sc else None)
        if fw.bqkv is not None:
            qkv = qkv + fw.bqkv[i]
        qkv = _clip(cfg, qkv)
        q, k = _qk_norm(qkv[:, :q_dim], qkv[:, q_dim:q_dim + kv_dim], fw, i, cfg)
        mixed = attend(i, q.reshape(Bn, Hk, qpk, D), k.reshape(Bn, Hk, D),
                       qkv[:, q_dim + kv_dim:].reshape(Bn, Hk, D), **_attn_kw(cfg, i))
        x = _wo_rows(cfg, fw, mixed.reshape(Bn, q_dim), x, i, shard)
        x = _ffn_rows(cfg, fw, x, i, shard)

    return _head(cfg, fw, rmsnorm(x, fw.final_norm, cfg.norm_eps), shard)


def decode_step_fast_batched(cfg: ModelConfig, fw: FastWeights, tokens, positions,
                             cache: KVCache, write_mask=None, *, shard=None
                             ) -> tuple[torch.Tensor, KVCache]:
    """One decode tick for B independent sequences sharing the weights
    (fast.py:802-876). tokens (B,) ids; positions (B,) absolute positions
    and write_mask (B,) (0 = read-only lane; default every lane writes) on
    the host; cache batched (B, L, S, Hk, D), updated IN PLACE. Per layer:
    rmsnorm, the wqkv GEMM over the B rows, bias and clip, the batched
    attention step, the wo GEMM + residual, the many-row FFN; then the
    final norm and the LM-head GEMM. Returns (logits (B, vocab) f32, cache).
    shard: one rank's tick on a mesh, over its lanes and kv heads of the
    cache (fast_tp.py:572 make_tick_fast_tp)."""
    if shard is not None:
        cfg = shard.cfg
    Bn = _host_ints(positions).shape[0]
    if cache.k.dim() != 5 or cache.k.shape[0] != Bn:
        raise ValueError(f"decode_step_fast_batched: cache {tuple(cache.k.shape)} vs {Bn} lanes")
    lanes = _tick_lanes(cfg, positions, write_mask, fw.wqkv.device)
    rope = dict(kv_sinks=KV_SINKS, theta=cfg.rope_param, rotary_dim=cfg.rotary_dim)
    logits = _tick_forward(cfg, fw, tokens, lambda i, q, k, v, **kw: attend_step_batched(
        q, k, v, cache.k, cache.v, i, lanes, **rope, **kw), shard)
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
    logits = _tick_forward(cfg, fw, tokens, lambda i, q, k, v, **kw: attend_step_paged(
        q, k, v, pool.k, pool.v, tab, i, lanes, **rope, **kw))
    return logits, pool


def _attend_chunk_batched(cfg, q5, kc, vc, mask, D):
    """Batched chunk attention (fast.py:1332-1342): q5 (B, T, Hk, qpk, D),
    kc/vc (B, S, Hk, D), mask (B, T, S); bf16 operands, f32 sums, the
    softcap before the mask and an f32 softmax; plain torch on every
    device."""
    scores = torch.einsum("btgqd,bsgd->bgqts", bf16f(q5), bf16f(kc)) / math.sqrt(D)
    scores = _softcap_scores(cfg, scores)
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
    if logits_mode not in ("none", "lastv", "all", "all_h"):
        raise ValueError(f"bad logits_mode {logits_mode!r}")
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qpk = Hq // Hk
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim

    p0 = np.where(en, p0, 0)   # disabled lanes compute from slot 0 and write nothing
    positions = torch.as_tensor(p0[:, None] + np.arange(T)[None, :], device=dev)  # (B, T)
    att_mask = torch.arange(S, device=dev)[None, None, :] <= positions[:, :, None]
    mask_of = _sliding_mask_fn(cfg, positions, att_mask, S)
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
        qf, kf = _qk_norm(qkv[..., :q_dim], qkv[..., q_dim:q_dim + kv_dim], fw, i, cfg)
        alt = _layer_alt(cfg, i)
        q = apply_rope(qf.reshape(Bn, T, Hq, D), positions, cfg.rope_param, cfg.rotary_dim, alt)
        k = apply_rope(kf.reshape(Bn, T, Hk, D), positions, cfg.rope_param, cfg.rotary_dim, alt)
        v = qkv[..., q_dim + kv_dim:].reshape(Bn, T, Hk, D)
        kl, vl = layers(i)
        if len(li):
            for c, rows in ((kl, k), (vl, v)):
                int_view(c)[at] = int_view(rows[li_t, ti_t].to(c.dtype))
        mixed = _attend_chunk_batched(cfg, q.reshape(Bn, T, Hk, qpk, D), view_of(kl),
                                      view_of(vl), mask_of(i), D)
        x = _wo_rows(cfg, fw, mixed.reshape(Bn * T, q_dim), x, i)
        x = _ffn_rows(cfg, fw, x, i)

    if logits_mode == "none":
        return None
    if logits_mode == "lastv":
        last = torch.as_tensor(np.maximum(vlen, 1) - 1, device=dev)
        x = x.reshape(Bn, T, -1)[torch.arange(Bn, device=dev), last]
        xn = rmsnorm(x, fw.final_norm, cfg.norm_eps)
        return _cap_logits(cfg, gemm(xn, fw.lm_head, sc.lm_head if sc else None))
    xn = rmsnorm(x, fw.final_norm, cfg.norm_eps)
    logits = _cap_logits(cfg, gemm(xn, fw.lm_head, sc.lm_head if sc else None)).reshape(Bn, T, -1)
    if logits_mode == "all_h":   # plus the post-final-norm rows (fast.py:1422-1425)
        return logits, xn.reshape(Bn, T, -1)
    return logits


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
    row; "none" -> None; "all" -> (B, T, vocab); "all_h" -> ((B, T, vocab)
    logits, (B, T, dim) post-final-norm hidden rows)."""
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


def verify_chunk_fast_batched(cfg: ModelConfig, fw: FastWeights, tokens, pos0, enable,
                              cache: KVCache, *, with_hidden: bool = False, attend_len: int = 0
                              ) -> tuple:
    """The verify sweep of scheduler speculation (fast.py:1041-1066): ONE
    weight sweep scores every enabled lane's T-row chunk [cur, d0..d_{T-2}]
    at its own pos0 (host values) and writes all T rows of the lane into
    the batched cache IN PLACE; disabled lanes compute from slot 0 and write
    nothing. Row (b, i) of the logits (B, T, vocab) answers "what follows
    tokens[b, :i+1]". Enabled lanes need pos0 + T <= the window (the
    scheduler's speculation edge). with_hidden: ((logits, hidden (B, T,
    dim)), cache), the post-final-norm rows Medusa's heads read.
    attend_len (0 = the window, as the JAX package) bounds the attention
    width; it must cover every enabled lane's pos0 + T."""
    T = np.asarray(tokens).shape[1]
    out, cache = prefill_chunk_fast_batched(
        cfg, fw, tokens, pos0, np.full(np.asarray(tokens).shape[0], T), enable, cache,
        attend_len=attend_len, logits_mode="all_h" if with_hidden else "all")
    return out, cache


# ---------------------------------------------------------------------------
# tree-attention verification (Medusa candidate trees)
# ---------------------------------------------------------------------------

def tree_depths(parents: tuple[int, ...]) -> tuple[int, ...]:
    """Node depths of a static candidate tree (parents[0] == -1, nodes in
    topological order: parents[i] < i)."""
    d: list[int] = []
    for p in parents:
        d.append(0 if p < 0 else d[p] + 1)
    return tuple(d)


def cartesian_tree(branching: tuple[int, ...]) -> tuple[int, ...]:
    """The parent array of the full cartesian candidate tree for per-depth
    branching factors, e.g. (4, 2) -> the root, 4 children and 8
    grandchildren (13 nodes), in BFS order (every depth-d node before any of
    depth d+1)."""
    parents = [-1]
    prev = [0]
    for k in branching:
        nxt = []
        for p in prev:
            for _ in range(k):
                parents.append(p)
                nxt.append(len(parents) - 1)
        prev = nxt
    return tuple(parents)


def _ancestors(parents: tuple[int, ...]) -> np.ndarray:
    """(Tn, Tn) bool: anc[i, j] iff j is i or one of its ancestors."""
    anc = np.zeros((len(parents), len(parents)), bool)
    for i, p in enumerate(parents):
        anc[i, i] = True
        while p >= 0:
            anc[i, p] = True
            p = parents[p]
    return anc


def _attend_tree(cfg, q5, kc, vc, kt, vt, hmask, anc, D):
    """Tree attention (fast.py:1160-1182): each node's scores over the
    cache's history (hmask (B, 1|Tn, S)) and over the tree's own rows (its
    ancestor chain, anc (Tn, Tn)), one f32 softmax over both; bf16
    operands, f32 sums, the softcap before the masks. q5 (B, Tn, Hk, qpk,
    D), kc/vc (B, S, Hk, D), kt/vt (B, Tn, Hk, D)."""
    S = kc.shape[1]
    qb = bf16f(q5)
    sh = _softcap_scores(cfg, torch.einsum("btgqd,bsgd->bgqts", qb, bf16f(kc)) / math.sqrt(D))
    st = _softcap_scores(cfg, torch.einsum("btgqd,bngd->bgqtn", qb, bf16f(kt)) / math.sqrt(D))
    sh = torch.where(hmask[:, None, None], sh, torch.full_like(sh, NEG_INF))
    st = torch.where(anc[None, None, None], st, torch.full_like(st, NEG_INF))
    att = torch.softmax(torch.cat([sh, st], dim=-1), dim=-1)
    return (torch.einsum("bgqts,bsgd->btgqd", bf16f(att[..., :S]), bf16f(vc))
            + torch.einsum("bgqtn,bngd->btgqd", bf16f(att[..., S:]), bf16f(vt)))


def verify_tree_fast_batched(cfg: ModelConfig, fw: FastWeights, tokens, pos0, enable,
                             cache: KVCache, *, parents: tuple[int, ...],
                             with_hidden: bool = False, attend_len: int = 0) -> tuple:
    """Tree-attention verification (fast.py:1095-1249): ONE weight sweep
    scores a whole candidate tree per lane. tokens (B, Tn) node ids (row 0
    the root), pos0 (B,) the root's position and enable (B,) on the host;
    node i sits at pos0 + depth(i) and attends the lane's cache slots
    before the root (each sliding layer's window applied by the node's
    position) plus its own ancestor chain under the static (Tn, Tn) mask.
    Row i's logits answer "what follows the root .. i chain". Disabled
    lanes compute from slot 0; their rows mean nothing.

    The cache is READ ONLY (siblings would collide on one ring slot): each
    layer's tree K/V is cast to the cache type before it is attended, so an
    accepted row sees exactly what a cache round trip gives, and returned
    as (B, n_layers, Tn, Hk, D) ktree and vtree; scatter_tree_rows writes
    the accepted path's rows after the walk. Enabled lanes need pos0 +
    max depth + 1 <= the window. attend_len (0 = the window) bounds the
    history read; it must cover every enabled lane's pos0 + max depth + 1.

    The projections run on the chunk paths' kernels: gemm_l (gemm4_l on
    packed int4) for wqkv and wo, the FFN's GEMM route (the all-expert
    gemm_le/gemm4_le sweep for MoE) and the LM head on gemm; the tree
    attention is plain torch, as the JAX package leaves it to XLA.

    Returns ((logits (B, Tn, vocab) f32[, hidden (B, Tn, dim)]), (ktree,
    vtree)), hidden the post-final-norm rows Medusa's heads read."""
    sc = fw.scales
    dev = fw.wqkv.device
    tok = np.asarray(tokens, np.int64)
    if tok.ndim != 2 or tok.shape[1] != len(parents):
        raise ValueError(f"verify_tree_fast_batched: tokens {tok.shape} vs a tree of "
                         f"{len(parents)} nodes")
    Bn, Tn = tok.shape
    if cache.k.dim() != 5 or cache.k.shape[0] != Bn:
        raise ValueError(f"verify_tree_fast_batched: cache {tuple(cache.k.shape)} vs {Bn} lanes")
    depths = np.asarray(tree_depths(parents), np.int64)
    en = _host_ints(enable, Bn) != 0
    p0 = np.where(en, _host_ints(pos0, Bn), 0)
    L = cfg.max_seq_len
    S = attend_len or L
    if S > L or (en.any() and ((p0[en] < 0).any() or (p0[en] + depths.max() + 1 > S).any())):
        raise ValueError(f"verify_tree_fast_batched: roots at {p0[en].tolist()} with depth "
                         f"{int(depths.max())} vs attend_len {S}, window {L}")
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qpk = Hq // Hk
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim
    anc = torch.as_tensor(_ancestors(parents), device=dev)
    positions = torch.as_tensor(p0[:, None] + depths[None, :], device=dev)        # (B, Tn)
    # the history: strictly the slots before the root (the tree's own rows
    # come through the ancestor mask)
    hist = torch.arange(S, device=dev)[None, None, :] < torch.as_tensor(p0, device=dev)[:, None,
                                                                                        None]
    if any(cfg.layer_sliding):
        slide = hist & (positions[..., None] - torch.arange(S, device=dev) < cfg.sliding_window)
    ktree = torch.empty((Bn, cfg.n_layers, Tn, Hk, D), dtype=cache.k.dtype, device=dev)
    vtree = torch.empty_like(ktree)
    x = _embed(cfg, fw, tok.reshape(-1))               # (B*Tn, dim)

    for i in range(cfg.n_layers):
        xb = rmsnorm(x, fw.rms_att[i], cfg.norm_eps)
        qkv = _proj_l(xb, fw.wqkv, i, sc.wqkv if sc else None)
        if fw.bqkv is not None:
            qkv = qkv + fw.bqkv[i]
        qkv = _clip(cfg, qkv).reshape(Bn, Tn, -1)
        qf, kf = _qk_norm(qkv[..., :q_dim], qkv[..., q_dim:q_dim + kv_dim], fw, i, cfg)
        alt = _layer_alt(cfg, i)
        q = apply_rope(qf.reshape(Bn, Tn, Hq, D), positions, cfg.rope_param, cfg.rotary_dim, alt)
        k = apply_rope(kf.reshape(Bn, Tn, Hk, D), positions, cfg.rope_param, cfg.rotary_dim, alt)
        v = qkv[..., q_dim + kv_dim:].reshape(Bn, Tn, Hk, D)
        for tree, rows in ((ktree, k), (vtree, v)):
            int_view(tree[:, i]).copy_(int_view(rows.to(tree.dtype)))
        hmask = slide if any(cfg.layer_sliding) and cfg.layer_sliding[i] else hist
        mixed = _attend_tree(cfg, q.reshape(Bn, Tn, Hk, qpk, D), cache.k[:, i, :S],
                             cache.v[:, i, :S], ktree[:, i], vtree[:, i], hmask, anc, D)
        x = _wo_rows(cfg, fw, mixed.reshape(Bn * Tn, q_dim), x, i)
        x = _ffn_rows(cfg, fw, x, i)

    xn = rmsnorm(x, fw.final_norm, cfg.norm_eps)
    logits = _cap_logits(cfg, gemm(xn, fw.lm_head, sc.lm_head if sc else None)).reshape(Bn, Tn, -1)
    out = (logits, xn.reshape(Bn, Tn, -1)) if with_hidden else logits
    return out, (ktree, vtree)


def scatter_tree_rows(cache: KVCache, ktree, vtree, pos0, rows, n) -> KVCache:
    """Write the accepted tree path's K/V rows into the ring cache IN PLACE
    (fast.py:1252-1281): for d < n[b], cache[b, :, pos0[b] + d] =
    tree[b, :, rows[b, d]]. rows (B, R) node indices (the walked path, root
    first), pos0 (B,) and n (B,) on the host; a lane with n 0 changes
    nothing."""
    n = _host_ints(n)
    rows = np.asarray(rows, np.int64).reshape(len(n), -1)
    p0 = _host_ints(pos0, len(n))
    lane, d = np.nonzero(np.arange(rows.shape[1])[None, :] < n[:, None])
    if len(lane):
        dev = cache.k.device
        li = torch.as_tensor(lane, device=dev)
        slot = torch.as_tensor(p0[lane] + d, device=dev)
        node = torch.as_tensor(rows[lane, d], device=dev)
        for c, tree in ((cache.k, ktree), (cache.v, vtree)):
            # (rows, n_layers, Hk, D) into the (rows, n_layers) slots
            int_view(c)[li, :, slot] = int_view(tree)[li, :, node]
    return cache


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


def verify_chunk_fast_batched_paged(cfg: ModelConfig, fw: FastWeights, tokens, pos0, enable,
                                    pool: PagedKVPool, tables, *, page_size: int = 256,
                                    with_hidden: bool = False, attend_len: int = 0) -> tuple:
    """verify_chunk_fast_batched over a PAGED pool (fast.py:1625-1650): the
    chunk rows scatter through the lanes' page tables (a chunk may straddle
    pages). Enabled lanes need their pages mapped through pos0 + T (the
    scheduler's _ensure_pages)."""
    T = np.asarray(tokens).shape[1]
    return prefill_chunk_fast_batched_paged(
        cfg, fw, tokens, pos0, np.full(np.asarray(tokens).shape[0], T), enable, pool, tables,
        page_size=page_size, attend_len=attend_len,
        logits_mode="all_h" if with_hidden else "all")
