"""HF checkpoint -> `.yalm` converter (the port's copy of `yalm_tpu/convert.py`).

Normalizes a HuggingFace model directory (config.json + tokenizer.json +
*.safetensors shards) into the single-file `.yalm` format the runtime reads,
byte for byte what the JAX package's converter writes for every dtype:

- normalizes the config into flat string metadata
- merges safetensors shards (read through the port's `read_yalm`: BF16 and
  fp8 shard tensors arrive as raw bits and are widened through torch)
- un-permutes HF's Q/K projection layout back to interleaved-pair RoPE order
- keeps all norm weights in fp32, casts everything else to the target dtype
  (fp32 / fp16 / bf16 / fp8-e5m2 / int8 / int4). int8 is symmetric
  per-OUTPUT-channel quantization with an f32 "<name>.scale" per row; int4
  packs the layer matrices with `ops/int4.pack_int4` (a "<name>.gscale"
  beside each) and keeps the embedding, LM head and MoE router int8
- stacks MoE per-expert FFN weights into (n_experts, ...) tensors
- packs the token vocabulary into a single NUL-delimited U8 tensor
  "tokenizer.tokens", and the BPE merges and added tokens beside it

It runs on the CPU with numpy and torch. Casts to bf16 and e5m2 go through
torch from f32 (round to nearest even, as ml_dtypes rounds); a NaN is
written as the canonical quiet NaN with its sign (bf16 0x7FC0, e5m2 0x7E),
the bytes ml_dtypes writes, where torch would write 0xFFFF / 0x7F.

Usage: python -m yalm_tpu_torch.convert --dtype {fp32,fp16,bf16,fp8,int8,int4} out.yalm <hf_dir>
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .codec.format import (DTYPE_STR_TO_TAG, numpy_to_torch, read_yalm, torch_dtype_for,
                           write_yalm)
from .ops.int4 import pack_int4

SUPPORTED_ARCHITECTURES = [
    "LlamaForCausalLM",
    "MistralForCausalLM",
    "MixtralForCausalLM",
    "Qwen2ForCausalLM",
    "Qwen3ForCausalLM",
    "Qwen3MoeForCausalLM",
    "GemmaForCausalLM",
    "Gemma2ForCausalLM",
    "Gemma3ForCausalLM",
]


def normalize_config(config: dict, dtype: str) -> dict[str, str]:
    """Flatten an HF config.json into `.yalm` metadata strings."""
    arch = config["architectures"][0]
    if arch not in SUPPORTED_ARCHITECTURES:
        raise ValueError(f"architecture {arch} not supported; must be one of {SUPPORTED_ARCHITECTURES}")
    if dtype not in DTYPE_STR_TO_TAG and dtype != "int4":
        raise ValueError(f"dtype {dtype} not supported; must be one of "
                         f"{list(DTYPE_STR_TO_TAG) + ['int4']}")

    head_dim = config.get("head_dim") or config["hidden_size"] // config["num_attention_heads"]
    # Gemma declares its act as `hidden_activation` (gelu_pytorch_tanh);
    # this repo's `gelu` IS the tanh approximation (reference
    # src/infer.cpp:187-189 uses the same constants), so both map to "gelu".
    act = config.get("hidden_activation") or config.get("hidden_act")
    if act == "gelu_pytorch_tanh":
        act = "gelu"
    if act not in ("gelu", "silu"):
        raise ValueError(f"unsupported hidden_act {act}")
    # Qwen2 uses QKV biases without declaring attention_bias in its config;
    # their presence is detected from the safetensors in load_weights.
    if config.get("mlp_bias", False):
        raise ValueError("mlp bias not supported")

    def eos_id(v):
        # Some configs carry a list of EOS ids; keep the first like HF does.
        return v[0] if isinstance(v, list) else v

    md = {
        "arch": arch,
        "dtype": dtype,
        "dim": str(config["hidden_size"]),
        "hidden_dim": str(config["intermediate_size"]),
        "head_dim": str(head_dim),
        "n_layers": str(config["num_hidden_layers"]),
        "n_heads": str(config["num_attention_heads"]),
        "n_kv_heads": str(config.get("num_key_value_heads", config["num_attention_heads"])),
        "vocab_size": str(config["vocab_size"]),
        "max_seq_len": str(config["max_position_embeddings"]),
        "bos_token_id": str(config["bos_token_id"]),
        "eos_token_id": str(eos_id(config["eos_token_id"])),
        "rope_theta": str(config.get("rope_theta", 10000.0)),
        "rotary_dim": str(int(head_dim * config.get("partial_rotary_factor", 1))),
        "norm_eps": str(config["rms_norm_eps"]),
        "norm_type": "rmsnorm",
        "act_type": act,
    }
    if arch.startswith("Gemma"):
        # sqrt(dim) embedding normalizer (HF GemmaModel.forward); the (1+w)
        # norm offset is folded into the norm tensors by load_weights
        md["embed_scale"] = str(float(config["hidden_size"]) ** 0.5)
    if arch == "Gemma2ForCausalLM":
        md["has_post_norms"] = "1"
        if config.get("attn_logit_softcapping"):
            md["attn_softcap"] = str(float(config["attn_logit_softcapping"]))
        if config.get("final_logit_softcapping"):
            md["final_softcap"] = str(float(config["final_logit_softcapping"]))
        # Gemma2 scales scores by query_pre_attn_scalar**-0.5 instead of
        # head_dim**-0.5; the runtime always divides by sqrt(head_dim), so
        # load_weights folds sqrt(head_dim/scalar) into wq (exact: RoPE is
        # a rotation and there is no q bias/norm to interfere)
        scalar = float(config.get("query_pre_attn_scalar", head_dim))
        if scalar != float(head_dim):
            md["query_scale_fold"] = str((float(head_dim) / scalar) ** 0.5)
        # alternating local attention: every even layer is sliding unless
        # the config carries an explicit layer_types list
        lt = config.get("layer_types")
        if lt is not None:
            sliding = ["1" if t == "sliding_attention" else "0" for t in lt]
        else:
            sliding = ["1" if i % 2 == 0 else "0"
                       for i in range(int(md["n_layers"]))]
        if config.get("sliding_window") and any(c == "1" for c in sliding):
            md["sliding_window"] = str(int(config["sliding_window"]))
            md["layer_sliding"] = "".join(sliding)
    if arch == "Gemma3ForCausalLM":
        md["has_post_norms"] = "1"
        scalar = float(config.get("query_pre_attn_scalar", head_dim))
        if scalar != float(head_dim):
            md["query_scale_fold"] = str((float(head_dim) / scalar) ** 0.5)
        lt = config.get("layer_types")
        if lt is not None:
            sliding = ["1" if t == "sliding_attention" else "0" for t in lt]
        else:
            # HF default: every sliding_window_pattern-th layer is global
            pat = int(config.get("sliding_window_pattern", 6))
            sliding = ["1" if (i + 1) % pat else "0"
                       for i in range(int(md["n_layers"]))]
        if config.get("sliding_window") and any(c == "1" for c in sliding):
            md["sliding_window"] = str(int(config["sliding_window"]))
            md["layer_sliding"] = "".join(sliding)
        # dual rope: global layers rope_theta (+ optional linear factor),
        # sliding layers the unscaled local theta — packed as ONE static
        # rope kind so every rope site selects per layer (ops/core)
        md["rope_scaling"] = "gemma3"
        md["rope_local_theta"] = str(
            float(config.get("rope_local_base_freq", 10000.0)))
        g3rs = config.get("rope_scaling") or {}
        if g3rs.get("rope_type", g3rs.get("type", "linear")) != "linear":
            raise ValueError("Gemma3 global-layer rope_scaling must be "
                             f"linear, got {g3rs}")
        md["rope_factor"] = str(float(g3rs.get("factor", 1.0)))
    if arch == "MixtralForCausalLM":
        md["n_experts"] = str(config["num_local_experts"])
        md["n_experts_active"] = str(config["num_experts_per_tok"])
    if arch == "Qwen3MoeForCausalLM":
        # experts are moe_intermediate_size wide (intermediate_size is the
        # dense-MLP width, unused when every layer is sparse)
        if config.get("mlp_only_layers") or \
                int(config.get("decoder_sparse_step", 1)) != 1:
            raise ValueError("Qwen3-MoE: mixed dense/MoE layer patterns "
                             "not supported (every layer must be sparse)")
        if not config.get("norm_topk_prob", False):
            raise ValueError("Qwen3-MoE without norm_topk_prob: the runtime "
                             "normalizes gates over the selected experts")
        md["hidden_dim"] = str(config["moe_intermediate_size"])
        md["n_experts"] = str(config["num_experts"])
        md["n_experts_active"] = str(config["num_experts_per_tok"])
    rs = config.get("rope_scaling") or {}
    if arch == "Gemma3ForCausalLM":
        rs = {}  # consumed by the gemma3 packed kind above
    if rs:
        # Llama-3.1+ / long-context checkpoints declare a RoPE frequency
        # remap; converting without it silently mis-rotates every position
        # (the reference has no rope_scaling handling at all). Fail loudly
        # on schemes we don't implement.
        kind = rs.get("rope_type", rs.get("type", ""))
        if kind == "llama3":
            md["rope_scaling"] = "llama3"
            md["rope_factor"] = str(rs["factor"])
            md["rope_low_freq_factor"] = str(rs["low_freq_factor"])
            md["rope_high_freq_factor"] = str(rs["high_freq_factor"])
            md["rope_orig_ctx"] = str(rs["original_max_position_embeddings"])
        elif kind == "linear":
            md["rope_scaling"] = "linear"
            md["rope_factor"] = str(rs["factor"])
        elif kind == "yarn":
            # precompute the pair-index correction band + attention factor
            # (HF transformers _compute_yarn_parameters) so the runtime's
            # static rope param is a plain float tuple
            import math as _m
            factor = float(rs["factor"])
            beta_fast = float(rs.get("beta_fast", 32.0))
            beta_slow = float(rs.get("beta_slow", 1.0))
            orig = int(rs.get("original_max_position_embeddings",
                              config["max_position_embeddings"]))
            rdim = int(md["rotary_dim"])
            base = float(md["rope_theta"])

            def corr(beta):
                return (rdim * _m.log(orig / (beta * 2 * _m.pi))) \
                    / (2 * _m.log(base))

            low = max(_m.floor(corr(beta_fast)), 0)
            high = min(_m.ceil(corr(beta_slow)), rdim - 1)
            att = rs.get("attention_factor")
            if att is None:
                att = 0.1 * _m.log(factor) + 1.0
            md["rope_scaling"] = "yarn"
            md["rope_factor"] = str(factor)
            md["rope_yarn_low"] = str(float(low))
            md["rope_yarn_high"] = str(float(high))
            md["rope_mscale"] = str(float(att))
        elif kind in ("default", ""):
            pass
        else:
            raise ValueError(f"unsupported rope_scaling type {kind!r} "
                             f"(supported: llama3, linear, yarn)")
    return md


def gpt2_bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 byte<->unicode table used by HF ByteLevel tokenizers.

    (Same table the reference reproduces at convert.py:86-96; needed to undo
    the bytes-as-unicode encoding baked into ByteLevel vocabularies.)
    """
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def load_tokens(tokenizer_path: str, vocab_size: int) -> list[bytes]:
    """Decode the HF vocab into raw UTF-8 byte strings (reference convert.py:98-125)."""
    with open(tokenizer_path, "r") as f:
        tokenizer = json.load(f)
    use_gpt2_bytes = not tokenizer["model"].get("byte_fallback", False)

    tokens: list = [""] * vocab_size
    vocab = tokenizer["model"]["vocab"]
    if len(vocab) > vocab_size:
        raise ValueError(f"vocab has {len(vocab)} entries > vocab_size {vocab_size}")
    for t, i in vocab.items():
        tokens[i] = t
    for added in tokenizer.get("added_tokens", []):
        tokens[added["id"]] = added["content"]

    gpt2_decode = {v: k for k, v in gpt2_bytes_to_unicode().items()}
    out: list[bytes] = []
    for t in tokens:
        if use_gpt2_bytes:
            b = bytes(gpt2_decode.get(c, 0) for c in t)
        else:
            b = t.replace("▁", " ").encode("utf-8")
        b = b.replace(b"\0", b"\7")  # NUL -> BEL: strings are NUL-delimited in the pack
        out.append(b)
    return out


def pack_tokens(tokens: list[bytes]) -> np.ndarray:
    """Concatenate all token byte strings, NUL-terminated, into one U8 tensor."""
    blob = b"".join(b + b"\0" for b in tokens)
    return np.frombuffer(blob, dtype=np.uint8).copy()


# Meta's Llama-3 pre-tokenizer regex (public, tiktoken lineage); the
# runtime implements exactly this scanner (tokenizer._llama3_pretok).
LLAMA3_SPLIT_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
    r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def load_merges(tokenizer_path: str, vocab: list[bytes]):
    """Extract BPE merge ranks + added-token ids + the pre-tokenizer kind.

    Returns (merges (M, 2) int32 | None, added (A,) int32, pretok str).
    Merge pairs are mapped into VOCAB IDS through the same byte decoding as
    load_tokens (gpt2 byte table or sentencepiece ▁->space, NUL->BEL), so
    the runtime tokenizer can run EXACT rank-based BPE — matching HF
    everywhere, not just where greedy longest-match agrees (the reference's
    tokenizer is greedy-only, src/tokenizer.cpp:57-94; this surpasses it).
    pretok: "metaspace:<scheme>" | "bytelevel" | "" (unknown -> the runtime
    stays greedy)."""
    with open(tokenizer_path, "r") as f:
        tokenizer = json.load(f)
    model = tokenizer["model"]
    use_gpt2_bytes = not model.get("byte_fallback", False)
    gpt2_decode = {v: k for k, v in gpt2_bytes_to_unicode().items()}

    def to_bytes(t: str) -> bytes:
        if use_gpt2_bytes:
            b = bytes(gpt2_decode.get(c, 0) for c in t)
        else:
            b = t.replace("▁", " ").encode("utf-8")
        return b.replace(b"\0", b"\7")

    # lowest id wins on byte-string collisions (merge sides refer to the
    # trained model vocab, which sits at the low ids)
    piece_id: dict[bytes, int] = {}
    for i, b in enumerate(vocab):
        piece_id.setdefault(b, i)

    merges = None
    raw = model.get("merges")
    if raw:
        rows = []
        for m in raw:
            left, right = m if isinstance(m, (list, tuple)) else m.split(" ", 1)
            li = piece_id.get(to_bytes(left))
            ri = piece_id.get(to_bytes(right))
            if li is None or ri is None \
                    or piece_id.get(to_bytes(left) + to_bytes(right)) is None:
                continue  # unrepresentable after byte mapping: skip the rank
            rows.append((li, ri))
        if rows:
            merges = np.asarray(rows, np.int32)

    added = np.asarray(
        sorted(a["id"] for a in tokenizer.get("added_tokens", [])
               if a["id"] < len(vocab)), np.int32)

    pre = tokenizer.get("pre_tokenizer") or {}
    kind = pre.get("type", "")
    if kind == "Metaspace":
        pretok = f"metaspace:{pre.get('prepend_scheme', 'always')}"
    elif kind == "ByteLevel":
        pretok = "bytelevel" + (":prefix" if pre.get("add_prefix_space")
                                else "")
    elif kind == "Sequence":
        # Llama-3's pipeline: Split(tiktoken-style regex) then
        # ByteLevel(use_regex=False). Recognize the exact public pattern;
        # any other Sequence falls back to greedy encoding.
        subs = pre.get("pretokenizers", [])
        pat = ""
        if subs and subs[0].get("type") == "Split":
            p = subs[0].get("pattern", {})
            pat = p.get("Regex", p.get("String", ""))
        is_bytelevel_tail = (len(subs) == 2
                             and subs[1].get("type") == "ByteLevel"
                             and not subs[1].get("use_regex", True))
        pretok = "llama3" if (is_bytelevel_tail
                              and pat == LLAMA3_SPLIT_PATTERN) else ""
    else:
        pretok = ""
    return merges, added, pretok


def permute_reverse(w: np.ndarray, heads: int, rotary_dim: int) -> np.ndarray:
    """Undo HF's rotary half-split Q/K layout back to interleaved pairs.

    HF stores the rotary dims of each head as [first-halves..., second-halves...];
    the runtime's RoPE rotates adjacent pairs (2i, 2i+1), so re-interleave
    (reference convert.py:145-158, themselves from calm's converter).
    """
    head_dim = w.shape[0] // heads
    assert rotary_dim <= head_dim
    w = w.reshape(heads, head_dim, *w.shape[1:])
    wr = w[:, :rotary_dim]  # rotary part
    wk = w[:, rotary_dim:]  # untouched part
    wr = wr.reshape(heads, 2, rotary_dim // 2, *w.shape[2:])
    wr = wr.swapaxes(1, 2).reshape(heads, rotary_dim, *w.shape[2:])
    out = np.concatenate([wr, wk], axis=1)
    return out.reshape(heads * head_dim, *w.shape[2:])


# the canonical quiet NaN that ml_dtypes writes, by tag: (bits type, bits
# of +NaN, the sign bit)
_NAN_BITS = {"BF16": (torch.int16, 0x7FC0, -0x8000), "F8_E5M2": (torch.uint8, 0x7E, 0x80)}


def cast_f32(f: np.ndarray, tag: str):
    """An f32 array cast to the tag's type, rounded to nearest even: a
    numpy array for F32 / F16 (numpy's casts), a torch tensor for BF16 /
    F8_E5M2 (torch's casts, NaNs rewritten to ml_dtypes' bytes)."""
    f = np.ascontiguousarray(f, np.float32)
    if tag == "F32":
        return np.array(f, copy=True)
    if tag == "F16":
        with np.errstate(over="ignore"):   # past 65504 is inf, as numpy casts
            return f.astype(np.float16)
    t = torch.from_numpy(f).to(torch_dtype_for(tag))
    nan = np.isnan(f)
    if nan.any():
        bits_dt, pos, sign = _NAN_BITS[tag]
        bits = t.view(bits_dt)
        neg = torch.from_numpy(np.signbit(f) & nan)
        bits[torch.from_numpy(nan & ~np.signbit(f))] = pos
        bits[neg] = pos | sign
    return t


class _Shard:
    """A tensor of an input shard: its numpy view (raw bits for BF16 and
    the fp8 types) and its safetensors tag."""

    def __init__(self, yf, name: str):
        self.arr, self.tag = yf.tensors[name], yf.dtypes[name]

    def f32(self) -> np.ndarray:
        if self.tag == "F32":
            return np.array(self.arr, np.float32)
        return numpy_to_torch(self.arr, self.tag).float().numpy()


def f32(t) -> np.ndarray:
    """A shard tensor or an array as a new f32 array."""
    return t.f32() if isinstance(t, _Shard) else np.asarray(t).astype(np.float32)


def load_weights(model_files: list[str], dtype_str: str, md: dict[str, str],
                 tie_word_embeddings: bool) -> dict:
    """Merge shards, normalize layouts, and cast. Values are numpy arrays,
    or torch tensors where the type is bf16 or fp8."""
    weights: dict[str, _Shard] = {}
    for path in sorted(model_files):
        yf = read_yalm(path)  # HF shards are plain safetensors; views keep them mapped
        for k in yf.tensors:
            assert k not in weights, f"duplicate tensor {k}"
            weights[k] = _Shard(yf, k)

    int8 = dtype_str == "int8"
    int4 = dtype_str == "int4"
    target = None if int4 else DTYPE_STR_TO_TAG[dtype_str]
    n_layers = int(md["n_layers"])
    rotary_dim = int(md["rotary_dim"])
    n_heads = int(md["n_heads"])
    n_kv_heads = int(md["n_kv_heads"])
    is_moe = "n_experts" in md

    def quant8(t) -> tuple[np.ndarray, np.ndarray]:
        '''Symmetric per-output-channel int8: rows are output channels.'''
        t = f32(t)
        s = np.abs(t).max(axis=-1) / 127.0           # (N,) or (E, N)
        s = np.where(s == 0.0, 1.0, s).astype(np.float32)
        q = np.clip(np.rint(t / s[..., None]), -127, 127).astype(np.int8)
        return q, s

    def conv(t):
        # two-step cast through fp32, as the JAX converter casts; a shard
        # tensor of the target type is copied (its view dies with the shard)
        if isinstance(t, _Shard) and t.tag == target:
            return numpy_to_torch(t.arr, t.tag)
        return cast_f32(f32(t), target)

    gemma = md["arch"].startswith("Gemma")

    def norm(t) -> np.ndarray:
        # Gemma's RMSNorm multiplies by (1 + w); folding the offset into the
        # stored tensor keeps every runtime norm the standard rmsnorm
        return f32(t) + 1.0 if gemma else f32(t)

    tensors: dict = {}

    def put(name: str, t) -> None:
        """Layer projection weights: int4 = planar-packed nibbles +
        per-group scales; int8 = per-channel scales; else the target type."""
        if int4:
            q, gs = pack_int4(f32(t))
            tensors[name] = q
            tensors[name + ".gscale"] = gs
        elif int8:
            q, sc = quant8(t)
            tensors[name] = q
            tensors[name + ".scale"] = sc
        else:
            tensors[name] = conv(t)

    def put_head(name: str, t) -> None:
        """Embedding / LM head: int4 checkpoints keep these int8
        per-channel (row gathers can't address packed nibbles)."""
        if int8 or int4:
            q, sc = quant8(t)
            tensors[name] = q
            tensors[name + ".scale"] = sc
        else:
            tensors[name] = conv(t)

    put_head("model.embed.weight", weights["model.embed_tokens.weight"])

    post_norms = md.get("has_post_norms") == "1"
    q_fold = float(md.get("query_scale_fold", "1"))
    # with a post-projection q-norm (Gemma3), rmsnorm's scale-invariance
    # would ERASE a factor folded into wq: fold it into the q-norm WEIGHT
    # instead (the norm's output multiply), which is equally exact
    has_qn = "model.layers.0.self_attn.q_norm.weight" in weights
    wq_fold, qn_fold = (1.0, q_fold) if has_qn else (q_fold, 1.0)

    for l in range(n_layers):
        p = f"model.layers.{l}"
        tensors[f"{p}.attn.norm.weight"] = norm(weights[f"{p}.input_layernorm.weight"])
        put(f"{p}.attn.wq.weight",
            wq_fold * permute_reverse(
                f32(weights[f"{p}.self_attn.q_proj.weight"]), n_heads, rotary_dim))
        put(f"{p}.attn.wk.weight",
            permute_reverse(f32(weights[f"{p}.self_attn.k_proj.weight"]), n_kv_heads, rotary_dim))
        put(f"{p}.attn.wv.weight", weights[f"{p}.self_attn.v_proj.weight"])
        put(f"{p}.attn.wo.weight", weights[f"{p}.self_attn.o_proj.weight"])
        for unsupported in (f"{p}.self_attn.o_proj.bias",
                            f"{p}.mlp.gate_proj.bias",
                            f"{p}.mlp.up_proj.bias",
                            f"{p}.mlp.down_proj.bias"):
            if unsupported in weights:
                raise ValueError(f"{unsupported}: o_proj/mlp biases are not "
                                 "supported (only Qwen2-style q/k/v biases)")
        if f"{p}.self_attn.q_proj.bias" in weights:
            # Qwen2-style attention biases; q/k get the same un-permutation
            # as their weight rows (a bias is a 1-column weight), kept f32
            md["has_qkv_bias"] = "1"
            tensors[f"{p}.attn.wq.bias"] = permute_reverse(
                f32(weights[f"{p}.self_attn.q_proj.bias"])[:, None],
                n_heads, rotary_dim)[:, 0]
            tensors[f"{p}.attn.wk.bias"] = permute_reverse(
                f32(weights[f"{p}.self_attn.k_proj.bias"])[:, None],
                n_kv_heads, rotary_dim)[:, 0]
            tensors[f"{p}.attn.wv.bias"] = f32(weights[f"{p}.self_attn.v_proj.bias"])
        if f"{p}.self_attn.q_norm.weight" in weights:
            # Qwen3-style per-head-dim q/k RMSNorm: the weight rides the
            # SAME RoPE un-permutation as the q/k rows (one "head" of
            # head_dim rows)
            md["has_qk_norm"] = "1"
            tensors[f"{p}.attn.q_norm.weight"] = qn_fold * permute_reverse(
                norm(weights[f"{p}.self_attn.q_norm.weight"])[:, None],
                1, rotary_dim)[:, 0]
            tensors[f"{p}.attn.k_norm.weight"] = permute_reverse(
                norm(weights[f"{p}.self_attn.k_norm.weight"])[:, None],
                1, rotary_dim)[:, 0]
        if post_norms:
            # Gemma2 sandwich: post_attention_layernorm norms the attention
            # DELTA; the pre-FFN norm is pre_feedforward_layernorm
            tensors[f"{p}.attn.post_norm.weight"] = norm(
                weights[f"{p}.post_attention_layernorm.weight"])
            tensors[f"{p}.mlp.norm.weight"] = norm(
                weights[f"{p}.pre_feedforward_layernorm.weight"])
            tensors[f"{p}.mlp.post_norm.weight"] = norm(
                weights[f"{p}.post_feedforward_layernorm.weight"])
        else:
            tensors[f"{p}.mlp.norm.weight"] = norm(weights[f"{p}.post_attention_layernorm.weight"])

        if is_moe:
            # Mixtral names experts block_sparse_moe.experts.{e}.w1/w2/w3;
            # Qwen3-MoE uses mlp.experts.{e}.gate/down/up_proj: same roles
            qwen_moe = md["arch"] == "Qwen3MoeForCausalLM"
            gate = (f"{p}.mlp.gate.weight" if qwen_moe
                    else f"{p}.block_sparse_moe.gate.weight")
            names = ({"w1": "gate_proj", "w2": "down_proj", "w3": "up_proj"}
                     if qwen_moe else {"w1": "w1", "w2": "w2", "w3": "w3"})
            base = f"{p}.mlp.experts" if qwen_moe \
                else f"{p}.block_sparse_moe.experts"
            # the router stays per-channel int8 in int4 mode
            put_head(f"{p}.moegate.weight", weights[gate])
            for wi in ("w1", "w2", "w3"):
                stacked = np.stack([f32(weights[f"{base}.{e}.{names[wi]}.weight"])
                                    for e in range(int(md["n_experts"]))])
                put(f"{p}.mlp.{wi}.weight", stacked)
        else:
            put(f"{p}.mlp.w1.weight", weights[f"{p}.mlp.gate_proj.weight"])
            put(f"{p}.mlp.w2.weight", weights[f"{p}.mlp.down_proj.weight"])
            put(f"{p}.mlp.w3.weight", weights[f"{p}.mlp.up_proj.weight"])

    tensors["model.norm.weight"] = norm(weights["model.norm.weight"])
    # Tied checkpoints may omit the flag (HF's base default is True; Gemma
    # relies on it): tensor absence then means tied. A config that says
    # untied with no lm_head tensor is a broken checkpoint.
    if tie_word_embeddings is False and "lm_head.weight" not in weights:
        raise ValueError("config says tie_word_embeddings=false but "
                         "lm_head.weight is missing from the shards")
    if not tie_word_embeddings and "lm_head.weight" in weights:
        put_head("model.output.weight", weights["lm_head.weight"])
    # (tied embeddings: the loader falls back to model.embed.weight)
    return tensors


def convert(hf_dir: str, output: str, dtype: str = "fp16") -> None:
    config_path = os.path.join(hf_dir, "config.json")
    tokenizer_path = os.path.join(hf_dir, "tokenizer.json")
    model_files = [
        os.path.join(hf_dir, f) for f in os.listdir(hf_dir) if f.endswith(".safetensors")
    ]
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"config.json not found in {hf_dir}")
    if not os.path.exists(tokenizer_path):
        raise FileNotFoundError(f"tokenizer.json not found in {hf_dir}")
    if not model_files:
        raise FileNotFoundError(f"no .safetensors files found in {hf_dir}")

    with open(config_path) as f:
        config = json.load(f)
    md = normalize_config(config, dtype)
    tokens = load_tokens(tokenizer_path, int(md["vocab_size"]))
    merges, added, pretok = load_merges(tokenizer_path, tokens)
    tensors = load_weights(model_files, dtype, md,
                           config.get("tie_word_embeddings"))
    # Tokenizer tensors go last to keep model tensors aligned at the front.
    tensors["tokenizer.tokens"] = pack_tokens(tokens)
    if merges is not None:
        tensors["tokenizer.merges"] = merges
        md["tokenizer_pretok"] = pretok
    if added.size:
        tensors["tokenizer.added"] = added
    print(f"Saving {len(tensors)} tensors to {output} ...")
    write_yalm(output, tensors, md)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output", type=str)
    ap.add_argument("input", type=str, help="HuggingFace model directory")
    ap.add_argument("--dtype", type=str, default="fp16", choices=list(DTYPE_STR_TO_TAG) + ["int4"])
    args = ap.parse_args()
    convert(args.input, args.output, args.dtype)


if __name__ == "__main__":
    main()
