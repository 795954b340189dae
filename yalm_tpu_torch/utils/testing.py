"""Test fixtures: synthesize tiny configs and random `.yalm` checkpoints.

The port's copy of `yalm_tpu/utils/testing.py` (dense and MoE checkpoints,
Medusa heads), without ml_dtypes: bf16 and fp8 tensors are rounded from f32 by torch, which
rounds to nearest-even like ml_dtypes, so the same seed writes the same
checkpoint bytes as the JAX package's `synth_checkpoint`; `synth_hf_dir`
writes the same HuggingFace-layout directory as the JAX package's.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..codec.format import DTYPE_STR_TO_TAG, torch_dtype_for, write_yalm
from ..config import ModelConfig
from ..ops.int4 import pack_int4


def tiny_config(**overrides) -> ModelConfig:
    defaults = dict(
        dim=64,
        hidden_dim=128,
        head_dim=16,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        vocab_size=128,
        max_seq_len=64,
        bos_token_id=1,
        eos_token_id=2,
        rope_theta=10000.0,
        rotary_dim=16,
        norm_eps=1e-5,
        act_type="silu",
        weight_dtype="fp32",
    )
    defaults.update(overrides)
    return ModelConfig(**defaults)


def synth_vocab(vocab_size: int) -> list[bytes]:
    """A deterministic toy vocab: specials, byte-fallback, then short words."""
    tokens: list[bytes] = [b"<unk>", b"<s>", b"</s>"]
    # byte fallback tokens, like sentencepiece vocabularies
    tokens += [f"<0x{i:02X}>".encode() for i in range(256)]
    words = [b" the", b" a", b"he", b"llo", b" world", b"hello", b"ab", b"abc",
             b" pass", b" key", b"1", b"2", b"3", b"4", b"5", b".", b",", b" is"]
    tokens += words
    while len(tokens) < vocab_size:
        tokens.append(b"tok%d" % len(tokens))
    return tokens[:vocab_size]


def synth_checkpoint(path: str, cfg: ModelConfig, seed: int = 0,
                     vocab: list[bytes] | None = None, medusa_heads: int = 0) -> None:
    """Write a random-but-deterministic `.yalm` checkpoint for `cfg` (weight
    dtypes fp32/fp16/bf16/fp8/int8/int4, dense or MoE). int4 packs the layer
    matrices (`ops.int4.pack_int4`, `.gscale` beside each; MoE experts pack
    over their leading expert axis) and keeps the embedding, LM head and
    MoE router int8 with a `.scale`. medusa_heads > 0 adds that many f32
    Medusa heads (medusa.py's format); -1..-H writes IDENTITY heads (w1 = 0,
    head = the dequantized LM head), whose proposals repeat the model's own
    next-token argmax. The RNG draws in the JAX fixture's order, so the same
    seed writes the same bytes."""
    rng = np.random.default_rng(seed)
    int4 = cfg.weight_dtype == "int4"
    int8 = cfg.weight_dtype == "int8"
    tdt = None if int4 else torch_dtype_for(DTYPE_STR_TO_TAG[cfg.weight_dtype])
    scales: dict[str, np.ndarray] = {}

    def w(name, *shape, scale=None, head=False):
        if scale is None:
            scale = 1.0 / np.sqrt(shape[-1])
        f = rng.standard_normal(shape, dtype=np.float32) * scale
        if int4 and len(shape) > 1 and not head:
            q, scales[name + ".gscale"] = pack_int4(f)
            return q
        if (int8 or int4) and len(shape) > 1:
            s = np.abs(f).max(axis=-1) / 127.0
            s = np.where(s == 0.0, 1.0, s).astype(np.float32)
            scales[name + ".scale"] = s
            return np.clip(np.rint(f / s[..., None]), -127, 127).astype(np.int8)
        if tdt in (torch.float32, torch.float16):
            return f.astype(np.float16 if tdt == torch.float16 else np.float32)
        return torch.from_numpy(f).to(tdt)

    tensors: dict = {}

    def put(name, *shape, scale=None, head=False):
        tensors[name] = w(name, *shape, scale=scale, head=head)
        for suffix in (".scale", ".gscale"):
            if name + suffix in scales:
                tensors[name + suffix] = scales.pop(name + suffix)

    put("model.embed.weight", cfg.vocab_size, cfg.dim, scale=0.02, head=True)
    for l in range(cfg.n_layers):
        p = f"model.layers.{l}"
        tensors[f"{p}.attn.norm.weight"] = np.ones(cfg.dim, np.float32)
        put(f"{p}.attn.wq.weight", cfg.q_dim, cfg.dim)
        put(f"{p}.attn.wk.weight", cfg.kv_dim, cfg.dim)
        put(f"{p}.attn.wv.weight", cfg.kv_dim, cfg.dim)
        put(f"{p}.attn.wo.weight", cfg.dim, cfg.q_dim)
        if cfg.has_qkv_bias:
            # biases pass through the weight type and back to f32 (int8 and
            # int4 checkpoints truncate them), exactly as the JAX fixture does
            for nm, n in (("wq", cfg.q_dim), ("wk", cfg.kv_dim), ("wv", cfg.kv_dim)):
                b = rng.standard_normal((n,), dtype=np.float32) * 0.05
                tensors[f"{p}.attn.{nm}.bias"] = (
                    b.astype(np.int8).astype(np.float32) if int8 or int4
                    else b.astype(np.float16).astype(np.float32)
                    if tdt == torch.float16
                    else torch.from_numpy(b).to(tdt).float().numpy())
        if cfg.has_qk_norm:
            tensors[f"{p}.attn.q_norm.weight"] = \
                1.0 + 0.1 * rng.standard_normal(cfg.head_dim).astype(np.float32)
            tensors[f"{p}.attn.k_norm.weight"] = \
                1.0 + 0.1 * rng.standard_normal(cfg.head_dim).astype(np.float32)
        tensors[f"{p}.mlp.norm.weight"] = np.ones(cfg.dim, np.float32)
        if cfg.has_post_norms:
            tensors[f"{p}.attn.post_norm.weight"] = \
                1.0 + 0.1 * rng.standard_normal(cfg.dim).astype(np.float32)
            tensors[f"{p}.mlp.post_norm.weight"] = \
                1.0 + 0.1 * rng.standard_normal(cfg.dim).astype(np.float32)
        E = (cfg.n_experts,) if cfg.is_moe else ()
        if cfg.is_moe:
            put(f"{p}.moegate.weight", cfg.n_experts, cfg.dim, head=True)
        put(f"{p}.mlp.w1.weight", *E, cfg.hidden_dim, cfg.dim)
        put(f"{p}.mlp.w2.weight", *E, cfg.dim, cfg.hidden_dim)
        put(f"{p}.mlp.w3.weight", *E, cfg.hidden_dim, cfg.dim)
    tensors["model.norm.weight"] = np.ones(cfg.dim, np.float32)
    if not cfg.tie_word_embeddings:
        put("model.output.weight", cfg.vocab_size, cfg.dim, scale=0.02, head=True)

    if medusa_heads:
        lm = tensors.get("model.output.weight", tensors["model.embed.weight"])
        lm32 = lm.float().numpy() if isinstance(lm, torch.Tensor) else np.asarray(lm, np.float32)
        sname = ("model.output.weight.scale" if "model.output.weight" in tensors
                 else "model.embed.weight.scale")
        if sname in tensors:
            lm32 = lm32 * np.asarray(tensors[sname], np.float32)[:, None]
        for h in range(abs(medusa_heads)):
            if medusa_heads < 0:   # identity heads
                tensors[f"medusa.{h}.w1.weight"] = np.zeros((cfg.dim, cfg.dim), np.float32)
                tensors[f"medusa.{h}.head.weight"] = lm32.copy()
            else:
                tensors[f"medusa.{h}.w1.weight"] = \
                    rng.standard_normal((cfg.dim, cfg.dim)).astype(np.float32) * 0.02
                tensors[f"medusa.{h}.head.weight"] = \
                    rng.standard_normal((cfg.vocab_size, cfg.dim)).astype(np.float32) * 0.02
            tensors[f"medusa.{h}.w1.bias"] = np.zeros(cfg.dim, np.float32)

    vocab = vocab if vocab is not None else synth_vocab(cfg.vocab_size)
    blob = b"".join(t.replace(b"\0", b"\7") + b"\0" for t in vocab)
    tensors["tokenizer.tokens"] = np.frombuffer(blob, dtype=np.uint8).copy()
    md = cfg.to_metadata()
    if medusa_heads:
        md["medusa_heads"] = str(abs(medusa_heads))
    write_yalm(path, tensors, md)


def synth_hf_dir(path: str, cfg: ModelConfig, seed: int = 0, *, arch: str | None = None,
                 dtype: str = "fp32", shards: int = 1, tokenizer: str | None = None,
                 device=None) -> None:
    """Write a HuggingFace-layout model dir (config.json, tokenizer.json,
    safetensors shards) of random weights for converter round trips. With
    the defaults it writes the same bytes as the JAX package's synth_hf_dir
    for the same seed: one f32 `model.safetensors` and a sentencepiece-style
    tokenizer over synth_vocab. arch names the architecture (else Llama,
    Qwen2, Qwen3 or Mixtral by cfg's flags); dtype "bf16" rounds every
    tensor to bf16 (as Mistral and Llama ship); shards > 1 splits the
    tensors, in order, over that many files of about equal bytes; tokenizer
    is a tokenizer.json to copy in place of the synthetic one; device draws
    the weight matrices with torch's generator there (seeded by seed: other
    bytes than numpy's, and seconds for a full-width model on a card)."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)

    arch = arch or ("MixtralForCausalLM" if cfg.is_moe
                    else "Qwen3ForCausalLM" if cfg.has_qk_norm
                    else "Qwen2ForCausalLM" if cfg.has_qkv_bias
                    else "LlamaForCausalLM")
    config = {
        "architectures": [arch],
        "hidden_size": cfg.dim,
        "intermediate_size": cfg.hidden_dim,
        "head_dim": cfg.head_dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "vocab_size": cfg.vocab_size,
        "max_position_embeddings": cfg.max_seq_len,
        "bos_token_id": cfg.bos_token_id,
        "eos_token_id": cfg.eos_token_id,
        "rope_theta": cfg.rope_theta,
        "partial_rotary_factor": cfg.rotary_dim / cfg.head_dim,
        "rms_norm_eps": cfg.norm_eps,
        "hidden_act": cfg.act_type,
        "tie_word_embeddings": cfg.tie_word_embeddings,
    }
    if cfg.is_moe:
        config["num_local_experts"] = cfg.n_experts
        config["num_experts_per_tok"] = cfg.n_experts_active
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)

    if tokenizer is not None:
        shutil.copyfile(tokenizer, os.path.join(path, "tokenizer.json"))
    else:
        # sentencepiece-style tokenizer.json (byte_fallback on)
        vocab = {}
        for i, t in enumerate(synth_vocab(cfg.vocab_size)):
            vocab[t.decode("utf-8", errors="replace").replace(" ", "▁")] = i
        tok = {"model": {"type": "BPE", "byte_fallback": True, "vocab": vocab, "merges": []},
               "added_tokens": []}
        with open(os.path.join(path, "tokenizer.json"), "w") as f:
            json.dump(tok, f)

    if dtype not in ("fp32", "bf16"):
        raise ValueError(f"shard dtype {dtype!r}: fp32 or bf16")

    def w_cast(f):
        return torch.from_numpy(f).to(torch.bfloat16) if dtype == "bf16" else f

    gen = None
    if device is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

    def w(*shape):
        if gen is None:
            return w_cast(rng.standard_normal(shape, dtype=np.float32) / np.sqrt(shape[-1]))
        t = torch.randn(shape, generator=gen, device=device) / float(np.sqrt(shape[-1]))
        return (t.to(torch.bfloat16) if dtype == "bf16" else t).cpu()

    def ones(n):
        return w_cast(np.ones(n, np.float32))

    tensors: dict = {}
    tensors["model.embed_tokens.weight"] = w(cfg.vocab_size, cfg.dim)
    for l in range(cfg.n_layers):
        p = f"model.layers.{l}"
        tensors[f"{p}.input_layernorm.weight"] = ones(cfg.dim)
        tensors[f"{p}.self_attn.q_proj.weight"] = w(cfg.q_dim, cfg.dim)
        tensors[f"{p}.self_attn.k_proj.weight"] = w(cfg.kv_dim, cfg.dim)
        tensors[f"{p}.self_attn.v_proj.weight"] = w(cfg.kv_dim, cfg.dim)
        tensors[f"{p}.self_attn.o_proj.weight"] = w(cfg.dim, cfg.q_dim)
        if cfg.has_qk_norm:
            tensors[f"{p}.self_attn.q_norm.weight"] = w_cast(
                (1.0 + 0.1 * rng.standard_normal(cfg.head_dim)).astype(np.float32))
            tensors[f"{p}.self_attn.k_norm.weight"] = w_cast(
                (1.0 + 0.1 * rng.standard_normal(cfg.head_dim)).astype(np.float32))
        if cfg.has_qkv_bias:
            tensors[f"{p}.self_attn.q_proj.bias"] = w(cfg.q_dim)
            tensors[f"{p}.self_attn.k_proj.bias"] = w(cfg.kv_dim)
            tensors[f"{p}.self_attn.v_proj.bias"] = w(cfg.kv_dim)
        tensors[f"{p}.post_attention_layernorm.weight"] = ones(cfg.dim)
        if cfg.is_moe:
            tensors[f"{p}.block_sparse_moe.gate.weight"] = w(cfg.n_experts, cfg.dim)
            for e in range(cfg.n_experts):
                ex = f"{p}.block_sparse_moe.experts.{e}"
                tensors[f"{ex}.w1.weight"] = w(cfg.hidden_dim, cfg.dim)
                tensors[f"{ex}.w2.weight"] = w(cfg.dim, cfg.hidden_dim)
                tensors[f"{ex}.w3.weight"] = w(cfg.hidden_dim, cfg.dim)
        else:
            tensors[f"{p}.mlp.gate_proj.weight"] = w(cfg.hidden_dim, cfg.dim)
            tensors[f"{p}.mlp.down_proj.weight"] = w(cfg.dim, cfg.hidden_dim)
            tensors[f"{p}.mlp.up_proj.weight"] = w(cfg.hidden_dim, cfg.dim)
    tensors["model.norm.weight"] = ones(cfg.dim)
    if not cfg.tie_word_embeddings:
        tensors["lm_head.weight"] = w(cfg.vocab_size, cfg.dim)

    if shards == 1:
        write_yalm(os.path.join(path, "model.safetensors"), tensors, {"format": "pt"})
        return
    sizes = {n: t.numel() * t.element_size() if isinstance(t, torch.Tensor) else t.nbytes
             for n, t in tensors.items()}
    total, acc, k, part = sum(sizes.values()), 0, 1, {}
    for name in list(tensors):
        part[name] = tensors.pop(name)
        acc += sizes[name]
        if acc >= total * k / shards or not tensors:
            write_yalm(os.path.join(path, f"model-{k:05d}-of-{shards:05d}.safetensors"),
                       part, {"format": "pt"})
            k, part = k + 1, {}
