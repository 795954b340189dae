"""Test fixtures: synthesize tiny configs and random `.yalm` checkpoints.

The port's copy of `yalm_tpu/utils/testing.py` (dense and MoE checkpoints,
Medusa heads), without ml_dtypes: bf16 and fp8 tensors are rounded from f32 by torch, which
rounds to nearest-even like ml_dtypes, so the same seed writes the same
checkpoint bytes as the JAX package's `synth_checkpoint`; `synth_hf_dir`
writes the same HuggingFace-layout directory as the JAX package's.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import time

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


# ---------------------------------------------------------------------------
# ranks of a torch.distributed world in fresh processes
# ---------------------------------------------------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(target: str, world: int, args, workdir: str, *, backend: str = "gloo",
              timeout: float = 180.0, env: dict | None = None, cwd: str | None = None) -> list:
    """Run `target` ("module:function") as every rank of a world of `world`
    fresh processes and return the ranks' results in rank order.

    Each rank starts python from the repository root (`cwd`), brings the
    process group up through parallel/distributed.initialize on a file
    store in `workdir` (no port: concurrent worlds cannot collide), calls
    function(args) and saves what it returns. `target`'s module must not
    import JAX (a child that imports a test module would). A rank that
    fails ends the world: the others are killed and the error carries the
    failing rank's stderr; so does a world still running after `timeout`
    seconds."""
    os.makedirs(workdir, exist_ok=True)
    torch.save(args, os.path.join(workdir, "args.pt"))
    code = ("import sys; from yalm_tpu_torch.utils.testing import _rank_main; "
            "_rank_main(sys.argv[1:])")
    procs, logs = [], []
    for r in range(world):
        e = dict(os.environ, LOCAL_RANK=str(r), OMP_NUM_THREADS="1", **(env or {}))
        log = open(os.path.join(workdir, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, workdir, str(r), str(world), target, backend],
            cwd=cwd or _ROOT, env=e, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = (bad[0], f"exit code {procs[bad[0]].returncode}")
                break
            if time.monotonic() > deadline:
                failed = (next(r for r, p in enumerate(procs) if p.poll() is None),
                          f"still running after {timeout:.0f} s")
                break
            time.sleep(0.05)
        else:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = (bad[0], f"exit code {procs[bad[0]].returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        r, why = failed
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            raise RuntimeError(f"rank {r} of {world} ({target}): {why}\n{f.read()[-6000:]}")
    return [torch.load(os.path.join(workdir, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_main(argv: list[str]) -> None:
    """One rank of run_ranks: initialize, run the target, save its result."""
    import torch.distributed as dist

    from ..parallel.distributed import initialize
    workdir, rank, world, target, backend = argv
    torch.set_num_threads(1)
    args = torch.load(os.path.join(workdir, "args.pt"), weights_only=False)
    initialize(f"file://{os.path.join(workdir, 'pg')}", int(world), int(rank), backend=backend,
               timeout=600)
    mod, name = target.split(":")
    out = getattr(importlib.import_module(mod), name)(args)
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    dist.destroy_process_group()


def mesh_cases(args: dict) -> list:
    """A rank's side of the mesh tests: run each case of args["cases"] on
    a mesh of this world, in order, and return each case's result (every
    rank runs every case; the tests read rank 0's and check the others').

    Case keys: "op" (decode | prefill | tick | paged | verify | engine |
    weights | scheduler | server | ring | pp | oracle), "path" (a
    checkpoint), "mesh" ((dp, ep, tp)) or "axes" (named axes in grid order,
    {"sp": 2, "tp": 1}), "kv" ("bf16" | "fp8"; the oracle also "f32"), and
    the op's inputs (ring_case's, pp_case's and oracle_case's too): "tokens" and
    "positions" (decode: one token per step; tick: (steps, B) arrays and
    "write"), "chunks" (prefill: (tokens, pos0, valid_len, logits_mode)
    tuples), paged_case's and verify_case's, "prompt", "steps",
    "temperature", "seed" (engine), "requests" and "batch" (scheduler),
    "prompt" and "max_tokens" (server)."""
    import numpy as np

    from ..codec.format import read_yalm
    from ..config import ModelConfig
    from ..models.fast import load_fast_weights
    from ..parallel.fast_tp import (local_cache, make_decode_step_fast_tp, make_prefill_fast_tp,
                                    make_tick_fast_tp)
    from ..parallel.mesh import MeshConfig, make_mesh
    kvs = {"bf16": torch.bfloat16, "fp8": torch.float8_e5m2, "f32": torch.float32}
    out = []
    for case in args["cases"]:
        mesh = make_mesh(MeshConfig(*case["mesh"]) if "mesh" in case else case["axes"],
                         device=args.get("device", "cpu"))
        kv = kvs[case.get("kv", "bf16")]
        yf = read_yalm(case["path"])
        cfg = ModelConfig.from_metadata(yf.metadata)
        op = case["op"]
        if op in ("decode", "prefill", "tick", "weights", "paged", "verify"):
            fw = load_fast_weights(yf, cfg, mesh.device, tp=mesh.shape["tp"],
                                   ep=mesh.shape["ep"], rank=mesh.position)
        elif op in ("ring", "pp"):   # the whole model: the case cuts the rank's part
            fw = load_fast_weights(yf, cfg, mesh.device)
        yf.close()
        if op == "weights":
            out.append(_fast_weights_numpy(fw))
        elif op == "decode":
            step = make_decode_step_fast_tp(cfg, mesh)
            cache = local_cache(cfg, mesh, kv)
            rows = []
            for pos, tok in enumerate(case["tokens"]):
                logits, cache = step(fw, int(tok), pos, cache)
                rows.append(logits.float().cpu().numpy())
            out.append(np.stack(rows))
        elif op == "prefill":
            prefill = make_prefill_fast_tp(cfg, mesh)
            cache = local_cache(cfg, mesh, kv)
            rows = []
            for toks, pos0, valid, mode in case["chunks"]:
                logits, cache = prefill(fw, np.asarray(toks), pos0, valid, cache,
                                        logits_mode=mode)
                rows.append(None if logits is None else logits.float().cpu().numpy())
            out.append(rows)
        elif op == "tick":
            tick = make_tick_fast_tp(cfg, mesh)
            B = len(case["tokens"][0])
            cache = local_cache(cfg, mesh, kv, batch=B)
            rows = []
            for toks, pos, wr in zip(case["tokens"], case["positions"], case["write"]):
                logits, cache = tick(fw, toks, pos, cache, wr)
                rows.append(logits.float().cpu().numpy())
            out.append(np.stack(rows))
        elif op == "paged":
            out.append(paged_case(case, cfg, fw, mesh, kv))
        elif op == "verify":
            out.append(verify_case(case, cfg, fw, mesh, kv))
        elif op == "engine":
            from ..engine import Engine
            eng = Engine.from_checkpoint(case["path"], mesh=mesh, kv_dtype=kv,
                                         fast=case.get("fast", "auto"))
            out.append(list(eng.generate(case["prompt"], max_steps=case["steps"],
                                         temperature=case.get("temperature", 0.0),
                                         seed=case.get("seed"))))
        elif op == "ring":
            out.append(ring_case(case, cfg, fw, mesh, kv))
        elif op == "pp":
            out.append(pp_case(case, cfg, fw, mesh, kv))
        elif op == "oracle":
            out.append(oracle_case(case, cfg, mesh, kv))
        elif op == "scheduler":
            out.append(_mesh_scheduler_case(case, mesh, kv))
        elif op == "server":
            out.append(_mesh_server_case(case, mesh, kv))
        else:
            raise ValueError(f"unknown mesh case {op!r}")
    return out


def _pool_bytes(cache) -> dict:
    from ..ops.core import int_view
    return {"k": int_view(cache.k).cpu().numpy(), "v": int_view(cache.v).cpu().numpy()}


def paged_case(case: dict, cfg, fw, mesh, kv) -> dict:
    """The paged factories on this rank's pool shard: case["prefills"]
    ((lane, padded tokens, pos0, valid_len, logits_mode) chunks through
    make_prefill_paged_fast_tp, the lane's page and row from its table),
    then case["ticks"] ((tokens, positions, write) through
    make_tick_paged_fast_tp); "tables" (B, blocks) of group-local page
    ids, "n_pages" and "page_size". Returns the logits and the pool's bytes."""
    from ..parallel.fast_tp import local_pool, make_prefill_paged_fast_tp, make_tick_paged_fast_tp
    ps = case["page_size"]
    tables = np.asarray(case["tables"], np.int64)
    B_l = tables.shape[0] // mesh.shape["dp"]
    pool = local_pool(cfg, mesh, case["n_pages"], ps, kv)
    prefill = make_prefill_paged_fast_tp(cfg, mesh, ps)
    tick = make_tick_paged_fast_tp(cfg, mesh, ps)
    pre, ticks = [], []
    for b, toks, pos0, valid, mode in case["prefills"]:
        lg, pool = prefill(fw, np.asarray(toks), pos0, valid, pool, tables[b],
                           int(tables[b, pos0 // ps]), pos0 % ps, b // B_l, logits_mode=mode)
        pre.append(None if lg is None else lg.float().cpu().numpy())
    for toks, pos, wr in case["ticks"]:
        lg, pool = tick(fw, toks, pos, pool, tables, wr)
        ticks.append(lg.float().cpu().numpy())
    return {"prefill": pre, "ticks": np.stack(ticks), **_pool_bytes(pool)}


def ring_case(case: dict, cfg, fw, mesh, kv) -> dict:
    """The ring prefill of case["tokens"] on this rank of an ('sp', 'tp')
    mesh (fw: the whole model, cut by shard_ring_weights), then
    case["steps"] greedy decode steps on one device from the placed
    window cache of type kv. Returns the last-token logits, this rank's K/V
    rows (f32), the greedy stream and its steps' logits."""
    from ..models.fast import decode_step_fast
    from ..parallel.ring import make_prefill_ring, ring_prefill_cache, shard_ring_weights
    tokens = case["tokens"]
    logits, ck, cv = make_prefill_ring(cfg, mesh)(shard_ring_weights(fw, cfg, mesh), tokens)
    cache = ring_prefill_cache(cfg, ck, cv, kv, mesh=mesh)
    cur, stream, rows = int(torch.argmax(logits)), [], []
    for s in range(case.get("steps", 0)):
        stream.append(cur)
        lg, cache = decode_step_fast(cfg, fw, cur, len(tokens) + s, cache)
        rows.append(lg.float().cpu().numpy())
        cur = int(torch.argmax(lg))
    return {"logits": logits.float().cpu().numpy(), "k": ck.float().cpu().numpy(),
            "v": cv.float().cpu().numpy(), "stream": stream, "rows": rows}


def pp_case(case: dict, cfg, fw, mesh, kv) -> dict:
    """The pipelined tick on this rank of a ('pp',) mesh (fw: the whole
    model, cut by shard_pp_weights) over case["ticks"] ((positions, write)
    each) of case["B"] lanes from case["tokens"]; with case["greedy"] each
    tick's argmax feeds the next, else case["tokens"] every tick. The whole
    batched cache starts zeroed, or as case["cache"] ((k, v) integer views
    of its bytes), and is cut per stage. Returns each tick's logits and the
    stage's cache bytes."""
    from ..models.cache import KVCache
    from ..ops.core import int_view
    from ..parallel.pipeline import make_tick_pp, shard_pp_cache, shard_pp_weights
    B = case["B"]
    cache = KVCache.init(cfg, kv, fw.wqkv.device, batch=B)
    if case.get("cache") is not None:
        for c, a in zip((cache.k, cache.v), case["cache"]):
            int_view(c).copy_(torch.from_numpy(np.ascontiguousarray(a)))
    pc = shard_pp_cache(cache, mesh)
    pw = shard_pp_weights(fw, cfg, mesh)
    tick = make_tick_pp(cfg, mesh, B)
    toks, rows = case["tokens"], []
    for pos, wr in case["ticks"]:
        lg, pc = tick(pw, toks, pos, pc, wr)
        rows.append(lg.float().cpu().numpy())
        if case.get("greedy"):
            toks = torch.argmax(lg, dim=-1).cpu().numpy()
    return {"logits": np.stack(rows), **_pool_bytes(pc)}


def oracle_case(case: dict, cfg, mesh, kv) -> dict:
    """The sharded oracle on this rank (parallel/oracle.py): case["chunks"]
    ((tokens, pos0, valid_len, logits_mode) through transformer.prefill),
    then case["tokens"] through transformer.decode_step from the next
    position, on the rank's cut of the whole Weights and its cache of type
    kv. Returns the logits and the cache (f32)."""
    from ..codec.format import read_yalm
    from ..models.transformer import decode_step, prefill
    from ..models.weights import load_weights
    from ..parallel.oracle import OracleShard, oracle_cache, shard_oracle_weights
    yf = read_yalm(case["path"])
    try:
        w = shard_oracle_weights(load_weights(yf, cfg, "cpu"), cfg, mesh)
    finally:
        yf.close()
    shard = OracleShard(cfg, mesh)
    cache = oracle_cache(cfg, mesh, kv)
    pre, steps, pos = [], [], 0
    for toks, pos0, valid, mode in case.get("chunks", ()):
        lg, cache = prefill(cfg, w, np.asarray(toks), pos0, valid, cache, logits_mode=mode,
                            shard=shard)
        pre.append(None if lg is None else lg.float().cpu().numpy())
        pos = pos0 + valid
    for t in case.get("tokens", ()):
        lg, cache = decode_step(cfg, w, int(t), pos, cache, shard=shard)
        steps.append(lg.float().cpu().numpy())
        pos += 1
    return {"prefill": pre, "steps": np.stack(steps) if steps else None,
            "k": cache.k.float().cpu().numpy(), "v": cache.v.float().cpu().numpy()}


def verify_case(case: dict, cfg, fw, mesh, kv) -> dict:
    """The verify sweeps with their hidden rows on this rank's cache (or
    pool shard, with "tables" (B, blocks) of group-local ids, "n_pages"
    and "page_size"): case["sweeps"] of (tokens (B, T), pos0, enable).
    Returns the logits, the hidden rows and the cache's bytes."""
    from ..parallel.fast_tp import (local_cache, local_pool, make_verify_chunk_fast_tp,
                                    make_verify_chunk_paged_fast_tp)
    B = len(case["sweeps"][0][0])
    if "tables" in case:
        cache = local_pool(cfg, mesh, case["n_pages"], case["page_size"], kv)
        vp = make_verify_chunk_paged_fast_tp(cfg, mesh, case["page_size"], with_hidden=True)

        def verify(t, p, e, c):
            return vp(fw, t, p, e, c, case["tables"])
    else:
        cache = local_cache(cfg, mesh, kv, batch=B)
        vd = make_verify_chunk_fast_tp(cfg, mesh, with_hidden=True)

        def verify(t, p, e, c):
            return vd(fw, t, p, e, c)
    logits, hidden = [], []
    for toks, pos0, en in case["sweeps"]:
        (lg, h), cache = verify(toks, pos0, en, cache)
        logits.append(lg.float().cpu().numpy())
        hidden.append(h.float().cpu().numpy())
    return {"logits": np.stack(logits), "hidden": np.stack(hidden), **_pool_bytes(cache)}


def _fast_weights_numpy(fw) -> dict:
    """FastWeights' fields as numpy arrays of their bytes (integer views)."""
    from dataclasses import fields

    from ..ops.core import int_view

    def arr(t):
        return int_view(t).cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
    out = {f.name: arr(getattr(fw, f.name)) for f in fields(fw)
           if f.name != "scales" and getattr(fw, f.name) is not None}
    if fw.scales is not None:
        out["scales"] = {f.name: arr(getattr(fw.scales, f.name)) for f in fields(fw.scales)
                         if getattr(fw.scales, f.name) is not None}
    return out


def load_shard(path: str, mesh):
    """(cfg, this rank's FastWeights shard on its device, Medusa heads or
    None) of a checkpoint."""
    from ..codec.format import read_yalm
    from ..config import ModelConfig
    from ..medusa import load_medusa_weights
    from ..models.fast import load_fast_weights
    yf = read_yalm(path)
    try:
        cfg = ModelConfig.from_metadata(yf.metadata)
        fw = load_fast_weights(yf, cfg, mesh.device, tp=mesh.shape["tp"], ep=mesh.shape["ep"],
                               rank=mesh.position)
        heads = (load_medusa_weights(yf, cfg, mesh.device)
                 if "medusa_heads" in yf.metadata else None)
    finally:
        yf.close()
    return cfg, fw, heads


def _record_preemptions(sched) -> None:
    """Keep (growing lane, victim) of every paged preemption in
    sched.preempted (the grower -1 where no lane was growing)."""
    sched.preempted = []
    grow, preempt = sched._ensure_pages, sched._preempt
    who = [-1]

    def ensure(b, target_len):
        who[0] = b
        try:
            return grow(b, target_len)
        finally:
            who[0] = -1

    def record(b):
        sched.preempted.append((who[0], b))
        preempt(b)
    sched._ensure_pages, sched._preempt = ensure, record


def scheduler_report(sched, reqs) -> dict:
    """The streams and counters of a finished scheduler run."""
    out = {"streams": [r.generated for r in reqs], "errors": [r.error for r in reqs],
           "preemptions": sched.preemptions, "resumes": sched.resumes,
           "preempted": list(getattr(sched, "preempted", [])),
           "spec": dict(sched.spec_stats)}
    if sched.paged:
        groups = getattr(sched.alloc, "groups", [sched.alloc])
        out["free"] = [g.n_free for g in groups]
        out["capacity"] = [g.n_pages - 1 for g in groups]
    return out


def _mesh_scheduler_case(case: dict, mesh, kv):
    """The scheduler on a mesh: the leader submits the requests and runs to
    the end, then stops the followers; returns the streams (the leader's;
    None on followers), or with "report" scheduler_report's dict. Options:
    "paged_pages", "page_size", "spec_lookup", "spec_k", "draft" (a
    checkpoint, loaded as this rank's shard) and "medusa" (the checkpoint's
    heads)."""
    from ..scheduler import Request, Scheduler
    cfg, fw, heads = load_shard(case["path"], mesh)
    kw = {k: case[k] for k in ("paged_pages", "page_size", "spec_lookup", "spec_k")
          if k in case}
    if case.get("draft"):
        dcfg, dfw, _ = load_shard(case["draft"], mesh)
        kw["spec_draft"] = (dcfg, dfw)
    if case.get("medusa"):
        kw["spec_medusa"] = heads
    sched = Scheduler(cfg, fw, batch=case["batch"], kv_dtype=kv, device=mesh.device,
                      mesh=mesh, **kw)
    if not mesh.leader:
        sched.follow()
        return None
    _record_preemptions(sched)
    reqs = [Request(**r) for r in case["requests"]]
    for r in reqs:
        sched.submit(r)
    try:
        sched.run()
    finally:
        sched.stop_followers()
    return scheduler_report(sched, reqs) if case.get("report") else [r.generated for r in reqs]


def _mesh_server_case(case: dict, mesh, kv):
    """The HTTP server on a mesh: the leader serves on 127.0.0.1 (a free
    port), posts one completion and returns its text; the followers follow
    until the leader closes the engine."""
    import urllib.request

    from ..server import ServingEngine, serve
    eng = ServingEngine.from_checkpoint(case["path"], batch=case.get("batch", 4),
                                       device=mesh.device, kv_dtype=kv, mesh=mesh,
                                       **case.get("engine", {}))
    if not mesh.leader:
        eng.follow()
        return None
    httpd = serve(eng, "127.0.0.1", 0)
    import threading
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        body = json.dumps({"prompt": case["prompt"], "max_tokens": case["max_tokens"],
                           "temperature": 0.0}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["choices"][0]["text"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()
