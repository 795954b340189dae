"""Model configuration (the port's own copy of `yalm_tpu/config.py`).

The config travels as stringly-typed metadata inside the `.yalm`
checkpoint and is normalized here into a typed, hashable dataclass. The
module is framework-free; the PyTorch port keeps this copy so that it never
imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

# Number of StreamingLLM attention-sink slots kept at the front of the KV ring
# buffer once generation passes the context window (reference: src/model.h:12).
KV_SINKS = 2

# The reference clamps max_seq_len to 4096 to avoid KV-cache OOM for models
# whose config advertises a huge max_position_embeddings (src/model.cpp:31-36).
MAX_SEQ_LEN_CLAMP = 4096

SUPPORTED_DTYPES = ("fp32", "fp16", "bf16", "fp8", "int8", "int4")


def _parse_rope_scale(md) -> tuple:
    kind = md.get("rope_scaling", "")
    if not kind:
        return ()
    if kind == "linear":
        return ("linear", float(md["rope_factor"]))
    if kind == "llama3":
        return ("llama3", float(md["rope_factor"]),
                float(md["rope_low_freq_factor"]),
                float(md["rope_high_freq_factor"]),
                int(md["rope_orig_ctx"]))
    if kind == "yarn":
        return ("yarn", float(md["rope_factor"]),
                float(md["rope_yarn_low"]), float(md["rope_yarn_high"]),
                float(md["rope_mscale"]))
    if kind == "gemma3":
        # per-layer dual rope: global layers theta/factor, sliding layers
        # the unscaled local theta (ops/core.rope_pair_freqs)
        return ("gemma3", float(md.get("rope_factor", "1")),
                float(md["rope_local_theta"]))
    raise ValueError(f"unsupported rope_scaling {kind!r}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Typed model configuration (reference: src/model.h:41-68)."""

    dim: int                      # transformer residual width
    hidden_dim: int               # FFN hidden width
    head_dim: int                 # per-head width
    n_layers: int
    n_heads: int                  # query heads
    n_kv_heads: int               # KV heads (GQA when < n_heads)
    vocab_size: int
    max_seq_len: int              # KV ring-buffer window length
    bos_token_id: int
    eos_token_id: int
    rope_theta: float = 10000.0
    rotary_dim: int = 0           # dims per head that get rotated (rest pass through)
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"
    act_type: str = "silu"        # "silu" | "gelu"
    qkv_clip: float = math.inf    # clip q/k/v to [-clip, clip] post-projection
    n_experts: int = 0            # MoE expert count (0 = dense)
    n_experts_active: int = 0     # top-k active experts
    weight_dtype: str = "fp16"    # "fp32" | "fp16" | "bf16" | "fp8" | "int8"
    tie_word_embeddings: bool = False
    has_qkv_bias: bool = False    # Qwen2-style attention projection biases
    has_qk_norm: bool = False     # Qwen3-style per-head-dim RMSNorm on q/k
    # RoPE frequency scaling, as a HASHABLE static tuple threaded to every
    # rope site (jit/kernel static arg): () = none; ("linear", factor);
    # ("llama3", factor, low_freq_factor, high_freq_factor, orig_ctx) — the
    # Llama-3.1 remap (ops/core.scale_inv_freq). The reference has no
    # rope_scaling handling at all, so Llama-3.1+ mis-rotates there.
    rope_scale: tuple = ()
    # Gemma multiplies the embedding row by sqrt(dim) before the first block
    # (NOT foldable into the table: the tied LM head reads it unscaled, and
    # rmsnorm's scale-invariance stops the factor from commuting through the
    # residual stream). Static, applied at every embedding-gather site.
    embed_scale: float = 1.0
    # Gemma2-style "sandwich" norms: rmsnorm the attention/FFN DELTA before
    # its residual add (post_attention/post_feedforward_layernorm; rms_ffn
    # maps to pre_feedforward_layernorm). Weights in LayerWeights.pa/pf.
    has_post_norms: bool = False
    # Gemma2 logit soft-capping: x -> cap * tanh(x / cap); 0.0 = off.
    # attn_softcap applies to attention scores AFTER the 1/sqrt(head_dim)
    # scale (the query_pre_attn_scalar rescale is folded into wq by the
    # converter), final_softcap to the LM-head logits.
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # Alternating local attention (Gemma2/3): sliding layers see only the
    # last `sliding_window` positions. layer_sliding is a per-layer 0/1
    # tuple ((): none). The KV ring window itself stays max_seq_len; the
    # narrower visibility is a pure attention mask.
    sliding_window: int = 0
    layer_sliding: tuple = ()

    def __post_init__(self):
        if self.rotary_dim == 0:
            object.__setattr__(self, "rotary_dim", self.head_dim)
        if self.weight_dtype not in SUPPORTED_DTYPES:
            raise ValueError(f"unsupported weight dtype {self.weight_dtype!r}")
        if self.act_type not in ("silu", "gelu"):
            raise ValueError(f"unsupported act_type {self.act_type!r}")
        if self.norm_type != "rmsnorm":
            raise ValueError(f"unsupported norm_type {self.norm_type!r}")
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.layer_sliding:
            if len(self.layer_sliding) != self.n_layers:
                raise ValueError("layer_sliding must have one entry per layer")
            if self.sliding_window <= 0 and any(self.layer_sliding):
                raise ValueError("layer_sliding set but sliding_window is 0")

    @property
    def rope_param(self):
        """What every rope site passes as its static `theta`: the plain
        float when unscaled, or the packed (kind, theta, *scaling) tuple —
        ops/core.decode_rope_param unpacks it, rope_pair_freqs applies it."""
        if not self.rope_scale:
            return self.rope_theta
        return (self.rope_scale[0], self.rope_theta) + self.rope_scale[1:]

    # -- derived sizes -----------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    # -- codec interop -----------------------------------------------------
    @classmethod
    def from_metadata(cls, md: Mapping[str, str], context: int = 0) -> "ModelConfig":
        """Build from `.yalm` metadata strings (reference: src/model.cpp:17-75).

        If `context` is nonzero, the sliding window is limited to it; otherwise
        max_seq_len is clamped to MAX_SEQ_LEN_CLAMP like the reference.
        """
        max_seq_len = min(int(md["max_seq_len"]), MAX_SEQ_LEN_CLAMP)
        if context:
            max_seq_len = context
        return cls(
            dim=int(md["dim"]),
            hidden_dim=int(md["hidden_dim"]),
            head_dim=int(md["head_dim"]),
            n_layers=int(md["n_layers"]),
            n_heads=int(md["n_heads"]),
            n_kv_heads=int(md["n_kv_heads"]),
            vocab_size=int(md["vocab_size"]),
            max_seq_len=max_seq_len,
            bos_token_id=int(md["bos_token_id"]),
            eos_token_id=int(md["eos_token_id"]),
            rope_theta=float(md["rope_theta"]),
            rotary_dim=int(md["rotary_dim"]),
            norm_eps=float(md.get("norm_eps", "1e-5")),
            norm_type=md.get("norm_type", "rmsnorm"),
            act_type=md.get("act_type", "gelu"),
            qkv_clip=float(md["qkv_clip"]) if "qkv_clip" in md else math.inf,
            n_experts=int(md.get("n_experts", "0")),
            n_experts_active=int(md.get("n_experts_active", "0")),
            weight_dtype=md["dtype"],
            tie_word_embeddings=md.get("tie_word_embeddings", "0") in ("1", "true", "True"),
            has_qkv_bias=md.get("has_qkv_bias", "0") in ("1", "true", "True"),
            has_qk_norm=md.get("has_qk_norm", "0") in ("1", "true", "True"),
            rope_scale=_parse_rope_scale(md),
            embed_scale=float(md.get("embed_scale", "1")),
            has_post_norms=md.get("has_post_norms", "0") in ("1", "true", "True"),
            attn_softcap=float(md.get("attn_softcap", "0")),
            final_softcap=float(md.get("final_softcap", "0")),
            sliding_window=(min(int(md["sliding_window"]), max_seq_len)
                            if "sliding_window" in md else 0),
            layer_sliding=tuple(int(c) for c in md.get("layer_sliding", "")),
        )

    def to_metadata(self) -> dict[str, str]:
        md = {
            "dtype": self.weight_dtype,
            "dim": str(self.dim),
            "hidden_dim": str(self.hidden_dim),
            "head_dim": str(self.head_dim),
            "n_layers": str(self.n_layers),
            "n_heads": str(self.n_heads),
            "n_kv_heads": str(self.n_kv_heads),
            "vocab_size": str(self.vocab_size),
            "max_seq_len": str(self.max_seq_len),
            "bos_token_id": str(self.bos_token_id),
            "eos_token_id": str(self.eos_token_id),
            "rope_theta": str(self.rope_theta),
            "rotary_dim": str(self.rotary_dim),
            "norm_eps": str(self.norm_eps),
            "norm_type": self.norm_type,
            "act_type": self.act_type,
        }
        if math.isfinite(self.qkv_clip):
            md["qkv_clip"] = str(self.qkv_clip)
        if self.n_experts:
            md["n_experts"] = str(self.n_experts)
            md["n_experts_active"] = str(self.n_experts_active)
        if self.tie_word_embeddings:
            md["tie_word_embeddings"] = "1"
        if self.has_qkv_bias:
            md["has_qkv_bias"] = "1"
        if self.has_qk_norm:
            md["has_qk_norm"] = "1"
        if self.embed_scale != 1.0:
            md["embed_scale"] = str(self.embed_scale)
        if self.has_post_norms:
            md["has_post_norms"] = "1"
        if self.attn_softcap:
            md["attn_softcap"] = str(self.attn_softcap)
        if self.final_softcap:
            md["final_softcap"] = str(self.final_softcap)
        if self.sliding_window:
            md["sliding_window"] = str(self.sliding_window)
        if self.layer_sliding:
            md["layer_sliding"] = "".join(str(int(b)) for b in self.layer_sliding)
        if self.rope_scale:
            md["rope_scaling"] = str(self.rope_scale[0])
            md["rope_factor"] = str(self.rope_scale[1])
            if self.rope_scale[0] == "llama3":
                md["rope_low_freq_factor"] = str(self.rope_scale[2])
                md["rope_high_freq_factor"] = str(self.rope_scale[3])
                md["rope_orig_ctx"] = str(self.rope_scale[4])
            elif self.rope_scale[0] == "yarn":
                md["rope_yarn_low"] = str(self.rope_scale[2])
                md["rope_yarn_high"] = str(self.rope_scale[3])
                md["rope_mscale"] = str(self.rope_scale[4])
            elif self.rope_scale[0] == "gemma3":
                md["rope_local_theta"] = str(self.rope_scale[2])
        return md

    # -- analytic bandwidth model -----------------------------------------
    def weight_byte_size(self) -> int:
        # int4 reports 1 here (embed/lm_head stay int8); active_bytes
        # accounts the packed layer weights at 0.5 byte + group scales
        return {"fp32": 4, "fp16": 2, "bf16": 2, "fp8": 1, "int8": 1,
                "int4": 1}[self.weight_dtype]

    def active_bytes(self, pos: int, kv_bytes: int = 2) -> int:
        """Bytes a single decode step must touch at position `pos`.

        Mirrors the analytic roofline model of reference src/model.cpp:77-102:
        every weight byte once, plus the live KV entries. The CLI derives its
        GB/s stat from this.
        """
        ws = self.weight_byte_size()
        if self.weight_dtype == "int4":
            # packed nibbles (0.5 B/weight) + one f32 scale per group of
            # input columns — group size depends on K (512 when K % 512
            # == 0, else 256; ops/pallas/gemv.int4_group)
            def lw(params: int, k: int) -> int:
                group = 512 if k % 512 == 0 else 256
                return params // 2 + (params // group) * 4
        else:
            def lw(params: int, k: int) -> int:
                return params * ws
        per_block = 0
        per_block += 2 * self.dim * 4                      # the two f32 norms
        per_block += lw(self.q_dim * self.dim, self.dim)   # wq
        per_block += lw(2 * self.kv_dim * self.dim, self.dim)  # wk, wv
        per_block += lw(self.q_dim * self.dim, self.q_dim)  # wo (K = q_dim)
        if self.n_experts > 0:
            per_block += self.n_experts * self.dim * ws    # router (int8)
            per_block += lw(2 * self.n_experts_active * self.dim
                            * self.hidden_dim, self.dim)   # w1, w3
            per_block += lw(self.n_experts_active * self.dim
                            * self.hidden_dim, self.hidden_dim)  # w2
        else:
            per_block += lw(2 * self.dim * self.hidden_dim, self.dim)
            per_block += lw(self.dim * self.hidden_dim, self.hidden_dim)
        kv_len = min(self.max_seq_len, pos + 1)
        kv_read = 2 * kv_len * self.kv_dim * kv_bytes      # K and V cache reads

        total = self.dim * ws                              # one embedding row
        total += self.n_layers * per_block
        # sliding layers only STREAM the window's live blocks in the linear
        # regime (the fused kernels start their fetch loop at the window's
        # first block); in the ring regime the live window wraps around the
        # buffer, so the stream covers every block and only the mask narrows
        n_sliding = sum(self.layer_sliding)
        if pos + 1 <= self.max_seq_len:
            sl_len = min(kv_len, self.sliding_window or kv_len)
        else:
            sl_len = kv_len
        kv_read_sl = 2 * sl_len * self.kv_dim * kv_bytes
        total += (self.n_layers - n_sliding) * kv_read + n_sliding * kv_read_sl
        total += self.dim * 4                              # final norm
        total += self.vocab_size * self.dim * ws           # LM head
        return total
