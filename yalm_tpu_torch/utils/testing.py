"""Test fixtures: synthesize tiny configs and random `.yalm` checkpoints.

The port's copy of `yalm_tpu/utils/testing.py` (dense and MoE checkpoints,
no Medusa heads), without ml_dtypes: bf16 and fp8 tensors are rounded from f32 by torch, which
rounds to nearest-even like ml_dtypes, so the same seed writes the same
checkpoint bytes as the JAX package's `synth_checkpoint`.
"""

from __future__ import annotations

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
                     vocab: list[bytes] | None = None) -> None:
    """Write a random-but-deterministic `.yalm` checkpoint for `cfg` (weight
    dtypes fp32/fp16/bf16/fp8/int8/int4, dense or MoE). int4 packs the layer
    matrices (`ops.int4.pack_int4`, `.gscale` beside each; MoE experts pack
    over their leading expert axis) and keeps the embedding, LM head and
    MoE router int8 with a `.scale`. The RNG draws in the JAX fixture's
    order, so the same seed writes the same bytes."""
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

    vocab = vocab if vocab is not None else synth_vocab(cfg.vocab_size)
    blob = b"".join(t.replace(b"\0", b"\7") + b"\0" for t in vocab)
    tensors["tokenizer.tokens"] = np.frombuffer(blob, dtype=np.uint8).copy()
    write_yalm(path, tensors, cfg.to_metadata())
