"""CLI harness: completion, perplexity and passkey workloads on the port.

Usage: python -m yalm_tpu_torch.cli <checkpoint.yalm> [options]
  -d cuda|cpu    device (default: cuda; cpu runs the kernels' plain versions)
  -m completion|passkey|perplexity   (prefix-matched)
  -T <int>       sliding-window context length (0 = model max, clamped 4096)
  -i <str> / -f <path>   prompt / prompt file
  -t <float>     temperature (default 1.0)
  -n <int>       completion steps (0 = max_seq_len, -1 = infinite) /
                 passkey junk lines (default 250)
  -l <int>       passkey position (-1 = random)
  -s <int>       RNG seed
  -k <int>       top-k sampling cut (0 = full vocab)
  -p <float>     nucleus (top-p) sampling cut (1.0 = off)
  -D <path>      DRAFT checkpoint: speculative completion (the draft
                 proposes, this model verifies; greedy at -t 0, the target's
                 exact distribution by rejection sampling at -t > 0)
  -K <int>       speculative draft/lookup length (default 4)
  -u             Medusa self-drafting speculation (checkpoint needs heads)
  -L             prompt-LOOKUP speculative completion (no draft model:
                 proposals continue the most recent earlier occurrence of
                 the trailing n-gram)
  -C f16|bf16|fp8   KV-cache dtype (the kernels run f16 as bf16; fp8 is the
                 e5m2 cache, half the cache bytes)
  -M 1,EP,TP     run over a ('dp','ep','tp') mesh of processes (dp must be 1
                 for the single-stream CLI): launch one process per device,
                   python -m torch.distributed.run --nproc-per-node N \
                       -m yalm_tpu_torch.cli model.yalm -M 1,EP,TP ...
                 every rank runs the same loop in lockstep and rank 0 prints
                 (nccl on the cards, gloo with -d cpu)
A model whose shapes the kernels refuse runs on the parity oracle
(models/transformer.py), as the JAX CLI's does (on one device: the sharded
oracle is a later slice).
"""

from __future__ import annotations

import random
import sys
import time


def error_usage(msg: str = "") -> None:
    if msg:
        sys.stderr.write(f"Error: {msg}\n")
    sys.stderr.write(__doc__ or "")
    raise SystemExit(1)


def _parse_args(argv: list[str]) -> dict:
    if len(argv) < 1 or argv[0].startswith("-"):
        error_usage()
    opts = {
        "checkpoint": argv[0], "device": "cuda", "mode": "completion",
        "prompt": None, "prompt_path": None, "context": 0, "num_steps": 256,
        "temperature": 1.0, "n_junk": 250, "passkey_pos": -1, "seed": None,
        "top_k": 0, "top_p": 1.0, "kv": "bf16", "draft": None, "n_draft": 4,
        "lookup": False, "medusa": False, "mesh": None,
    }
    i = 1

    def need(i):
        if i + 1 >= len(argv):
            error_usage()
        return argv[i + 1]

    while i < len(argv):
        flag = argv[i]
        if not flag.startswith("-") or len(flag) != 2:
            error_usage()
        c = flag[1]
        if c == "h":
            error_usage()
        elif c == "m":
            m = need(i)
            for full in ("completion", "passkey", "perplexity"):
                if full.startswith(m):
                    opts["mode"] = full
                    break
            else:
                error_usage()
        elif c == "d":
            d = need(i)
            if "cpu".startswith(d):
                opts["device"] = "cpu"
            elif "cuda".startswith(d) or "gpu".startswith(d):
                opts["device"] = "cuda"
            else:
                error_usage()
        elif c == "i":
            opts["prompt"] = need(i)
        elif c == "f":
            opts["prompt_path"] = need(i)
        elif c == "t":
            opts["temperature"] = float(need(i))
        elif c == "T":
            opts["context"] = int(need(i))
        elif c == "n":
            v = int(need(i))
            opts["num_steps"] = v
            opts["n_junk"] = v
        elif c == "l":
            opts["passkey_pos"] = int(need(i))
        elif c == "s":
            opts["seed"] = int(need(i))
        elif c == "k":
            opts["top_k"] = int(need(i))
        elif c == "p":
            opts["top_p"] = float(need(i))
        elif c == "D":
            opts["draft"] = need(i)
        elif c == "K":
            opts["n_draft"] = int(need(i))
        elif c in "Lu":
            opts["lookup" if c == "L" else "medusa"] = True
            i -= 1   # the flag takes no value
        elif c == "C":
            v = need(i)
            if v not in ("f16", "bf16", "fp8"):
                error_usage()
            opts["kv"] = v
        elif c == "M":
            opts["mesh"] = need(i)
        else:
            error_usage()
        i += 2
    return opts


def _make_mesh(opts):
    """The -M mesh (cli.py:155-170): the process group from torchrun's
    environment (a world of one outside it), gloo with -d cpu, nccl on the
    cards; dp must be 1 for the single-stream CLI."""
    from .parallel.distributed import initialize, make_hybrid_mesh
    from .parallel.mesh import MeshConfig
    try:
        dp, ep, tp = (int(x) for x in opts["mesh"].split(","))
    except ValueError:
        error_usage(f"-M takes DP,EP,TP, got {opts['mesh']!r}")
    if dp != 1:
        raise SystemExit("single-stream CLI needs dp=1 (use the server "
                         "for data-parallel serving)")
    dev = "cpu" if opts["device"] == "cpu" else None   # cuda:LOCAL_RANK
    initialize(device=dev)
    return make_hybrid_mesh(MeshConfig(dp=dp, ep=ep, tp=tp), device=dev)


def _build_engine(opts, path=None):
    import torch

    from .engine import Engine
    # the kernels run f16 as bf16; the oracle (a config the kernels refuse) keeps f16
    kv = {"fp8": torch.float8_e5m2, "bf16": torch.bfloat16, "f16": torch.float16}[opts["kv"]]
    return Engine.from_checkpoint(path or opts["checkpoint"], context=opts["context"],
                                  device=opts["device"], kv_dtype=kv, mesh=opts.get("_mesh"))


def _encode_prompt(eng, prompt: str):
    t0 = time.perf_counter()
    encoding = eng.tokenizer.encode(prompt, bos=True)
    dt = max(time.perf_counter() - t0, 1e-9)
    print(eng.tokenizer.encoding_to_debug_string(encoding))
    print(f"Encoding stats: ({len(encoding)} tokens, throughput: {len(encoding)/dt:.5}tok/s, "
          f"latency: {dt/max(len(encoding),1):.5}s/tok, total: {dt:.5}s)\n")
    return encoding


def _sync(eng) -> None:
    if eng.device.type == "cuda":
        import torch
        torch.cuda.synchronize()


def run_completion(opts) -> None:
    eng = _build_engine(opts)
    cfg = eng.cfg
    print(f"Model active bytes with full context window: {cfg.active_bytes(cfg.max_seq_len)}")
    num_steps = opts["num_steps"]
    if num_steps == 0:
        num_steps = cfg.max_seq_len
    eng.warmup()

    encoding = _encode_prompt(eng, opts["prompt"])

    out = sys.stdout.buffer
    start = time.perf_counter()
    read_bytes = 0
    eng.prefill_tokens(encoding, want_logits=True)
    _sync(eng)
    for pos in range(len(encoding)):
        read_bytes += cfg.active_bytes(pos)
    hydrate_s = time.perf_counter() - start

    prev = encoding[-1]
    n_generated = 0
    stop = {eng.tokenizer.eos_id, eng.tokenizer.eot_id}
    spec = dict(max_steps=num_steps, stop_tokens=stop, temperature=opts["temperature"],
                seed=opts["seed"])
    if opts["draft"]:
        # greedy at -t 0, rejection-sampled (the target's distribution) at -t > 0
        draft = _build_engine(opts, opts["draft"])
        draft.prefill_tokens(encoding, want_logits=False)
        stream = eng.generate_speculative([], draft=draft, n_draft=opts["n_draft"], **spec)
    elif opts["lookup"]:
        # the hydrated prompt seeds the n-gram history
        stream = eng.generate_speculative([], draft=None, n_draft=opts["n_draft"],
                                          hist_tokens=encoding, **spec)
    elif opts["medusa"]:
        stream = eng.generate_medusa([], **spec)
    else:
        stream = eng.generate([], max_steps=num_steps, temperature=opts["temperature"],
                              seed=opts["seed"], stop_tokens=stop,
                              top_k=opts["top_k"], top_p=opts["top_p"])
    for token in stream:
        out.write(eng.tokenizer.decode_one(prev, token))
        out.flush()
        prev = token
        n_generated += 1
        read_bytes += cfg.active_bytes(len(encoding) + n_generated - 1)
    print("\n")
    elapsed = max(time.perf_counter() - start, 1e-9)
    total = len(encoding) + n_generated
    print(f"Generation stats:\n"
          f"  {total} tokens\n"
          f"  throughput: {total/elapsed:.5}tok/s\n"
          f"  latency: {elapsed/total:.5}s/tok\n"
          f"  hydrate: {hydrate_s:.5}s\n"
          f"  bandwidth: {read_bytes/1e9/elapsed:.5}GB/s\n"
          f"  total: {elapsed:.5}s\n")
    st = eng._spec_stats
    if (opts["draft"] or opts["lookup"] or opts["medusa"]) and st and st["rounds"]:
        print(f"Speculative stats: {st['rounds']} verify rounds, "
              f"{st['accepted'] / st['rounds']:.2f} draft tokens "
              f"accepted/round (of {opts['n_draft']})"
              + (f", {st['plain']} plain steps (no n-gram match)" if "plain" in st else "")
              + "\n")


def run_perplexity(opts) -> None:
    eng = _build_engine(opts)
    cfg = eng.cfg
    print(f"Model active bytes with full context window: {cfg.active_bytes(cfg.max_seq_len)}")
    eng.warmup()
    encoding = _encode_prompt(eng, opts["prompt"])

    start = time.perf_counter()
    ppl, err, N = eng.perplexity(encoding)
    elapsed = max(time.perf_counter() - start, 1e-9)
    read_bytes = sum(cfg.active_bytes(p) for p in range(N))
    print(f"Stats:\n"
          f"  {N} tokens\n"
          f"  perplexity: {ppl:.5} ± {err:.5}\n"
          f"  throughput: {N/elapsed:.5}tok/s\n"
          f"  latency: {elapsed/N:.5}s/tok\n"
          f"  bandwidth: {read_bytes/1e9/elapsed:.5}GB/s\n"
          f"  total: {elapsed:.5}s\n")


def run_passkey(opts) -> None:
    eng = _build_engine(opts)
    cfg = eng.cfg
    print(f"Model active bytes with full context window: {cfg.active_bytes(cfg.max_seq_len)}")
    eng.warmup()

    n_junk = opts["n_junk"]
    rng = random.Random(opts["seed"])
    passkey = rng.randrange(50000) + 1
    pos = opts["passkey_pos"] if opts["passkey_pos"] != -1 else rng.randrange(n_junk)
    if not (0 <= pos < n_junk):
        sys.stderr.write(f"Error: passkey position must be between 0 and {n_junk - 1}\n")
        raise SystemExit(1)

    prefix = ("There is an important info hidden inside a lot of irrelevant text. "
              "Find it and memorize them. I will quiz you about the important information there.")
    suffix = " What is the pass key? The pass key is"
    junk = " The grass is green. The sky is blue. The sun is yellow. Here we go. There and back again."
    parts = [prefix]
    for i in range(n_junk):
        if i == pos:
            parts.append(f" The pass key is {passkey}. Remember it. {passkey} is the pass key.")
        parts.append(junk)
    parts.append(suffix)
    prompt = "".join(parts)

    encoding = _encode_prompt(eng, prompt)
    print(f"Passkey test:\n  prompt: {len(encoding)} tokens\n  passkey: {passkey}\n"
          f"  passkey token index: ~{int(pos / n_junk * len(encoding))}\n")

    eng.prefill_tokens(encoding, want_logits=True)
    sys.stdout.write(suffix)
    sys.stdout.flush()
    out = sys.stdout.buffer
    prev = encoding[-1]
    stop = {eng.tokenizer.eos_id, eng.tokenizer.eot_id}
    for token in eng.generate([], max_steps=16, temperature=0.0,
                              seed=0, stop_tokens=stop):
        out.write(eng.tokenizer.decode_one(prev, token))
        out.flush()
        prev = token
    print()


def main(argv: list[str] | None = None) -> None:
    opts = _parse_args(sys.argv[1:] if argv is None else argv)
    if opts["mode"] in ("completion", "perplexity"):
        has_p, has_f = opts["prompt"] is not None, opts["prompt_path"] is not None
        if has_p == has_f:  # exactly one source required
            error_usage()
        if has_f:
            with open(opts["prompt_path"]) as f:
                opts["prompt"] = f.read()
    mesh = None
    if opts["mesh"]:
        import os
        mesh = opts["_mesh"] = _make_mesh(opts)
        if opts["seed"] is None:   # every rank samples alike: the leader's seed
            opts["seed"] = mesh.broadcast_int(random.randrange(1 << 31))
        if not mesh.leader:        # rank 0 prints
            sys.stdout = open(os.devnull, "w")
    try:
        {"completion": run_completion,
         "perplexity": run_perplexity,
         "passkey": run_passkey}[opts["mode"]](opts)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            sys.stdout.flush()
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
