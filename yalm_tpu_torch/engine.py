"""Inference engine over the fast path (port of `Engine` in
`yalm_tpu/engine.py`).

The prompt is hydrated in bucketed chunks of batched GEMMs while it fits
the context window and token by token in the ring-buffer regime beyond it;
decode runs one `decode_step_fast` per token and samples on the device.
PyTorch runs eagerly, so there is no compilation: each step launches the
kernels directly, and the KV cache is updated in place.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from .codec.format import read_yalm
from .config import ModelConfig
from .models.cache import KVCache
from .models.fast import (FastWeights, decode_step_fast, fast_unsupported,
                          load_fast_weights, prefill_fast)
from .sampler import logprob_of, sample_ext
from .tokenizer import Tokenizer

# Prefill chunk buckets: prompts are processed in full chunks of the largest
# bucket, with the tail padded up to the smallest fitting bucket.
PREFILL_BUCKETS = (16, 64, 256)


def _bucket_for(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return PREFILL_BUCKETS[-1]


def attend_bucket(pos_end: int, window: int) -> int:
    """Attention width for a prefill chunk whose last visible slot is
    pos_end-1: the next power of two >= pos_end (min 256), clamped to the
    window, so early chunks of long prompts skip the empty tail."""
    n = 256
    while n < pos_end:
        n *= 2
    return min(n, window)


def chunk_schedule(n_tokens: int, pos: int, window: int):
    """Yield (i, take, bucket) chunked-prefill steps while inside the window:
    `take` tokens from offset i, padded up to `bucket` (shrunk to the exact
    fit where a padded chunk would cross the window edge). Stops once the
    ring regime begins; callers hydrate the rest token by token."""
    i = 0
    while i < n_tokens:
        room = window - pos
        if room <= 0:
            return
        take = min(n_tokens - i, PREFILL_BUCKETS[-1], room)
        bucket = _bucket_for(take)
        if bucket > room:
            bucket = take
        yield i, take, bucket
        pos += take
        i += take


def resolve_device(device) -> torch.device:
    """The engine's device; "cuda" without a GPU raises instead of falling
    back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is available "
                           "(pass device='cpu' to run the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Engine:
    """Single-sequence inference engine over FastWeights on one device."""

    def __init__(self, cfg: ModelConfig, weights: FastWeights,
                 tokenizer: Optional[Tokenizer] = None, *,
                 kv_dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        why = fast_unsupported(cfg)
        if why:
            raise ValueError(f"this model's shapes do not fit the port's kernels: {why}")
        if kv_dtype == torch.float16:
            kv_dtype = torch.bfloat16   # the fast path's cache is bf16 or e5m2
        if kv_dtype not in (torch.bfloat16, torch.float8_e5m2):
            raise NotImplementedError(
                f"KV cache {kv_dtype}: the port's caches are bf16 and float8_e5m2")
        if weights.wqkv.device.type != self.device.type:
            raise ValueError(f"weights on {weights.wqkv.device}, engine on {self.device}")
        self.cfg = cfg
        self.weights = weights
        self.tokenizer = tokenizer
        self.kv_dtype = kv_dtype
        self.cache = KVCache.init(cfg, kv_dtype, self.device)
        self.pos = 0          # next absolute position to be written
        self._last_logits: Optional[torch.Tensor] = None

    @classmethod
    def from_checkpoint(cls, path: str, *, context: int = 0, device="cuda",
                        **kw) -> "Engine":
        dev = resolve_device(device)
        yf = read_yalm(path)
        try:
            cfg = ModelConfig.from_metadata(yf.metadata, context=context)
            weights = load_fast_weights(yf, cfg, dev)
            tok = Tokenizer.from_yalm(yf)
        finally:
            yf.close()  # the weights were copied out of the mapping
        return cls(cfg, weights, tok, device=dev, **kw)

    # ------------------------------------------------------------------
    def reset(self) -> None:
        self.cache = KVCache.init(self.cfg, self.kv_dtype, self.device)
        self.pos = 0
        self._last_logits = None

    def warmup(self) -> None:
        """Build and load the CUDA kernels before the first timed step (a
        no-op on the CPU)."""
        if self.device.type == "cuda":
            from .ops.cuda import _build
            _build.lib()

    def _step(self, token, output_logits: bool = True):
        logits, self.cache = decode_step_fast(self.cfg, self.weights, token,
                                              self.pos, self.cache,
                                              output_logits=output_logits)
        self.pos += 1
        return logits

    def _prefill(self, toks, take: int, bucket: int, mode: str):
        padded = np.zeros(bucket, np.int64)
        padded[:take] = toks
        out, self.cache = prefill_fast(
            self.cfg, self.weights, padded, self.pos, take, self.cache,
            logits_mode=mode,
            attend_len=attend_bucket(self.pos + bucket, self.cfg.max_seq_len))
        self.pos += take
        return out

    def prefill_tokens(self, tokens: Sequence[int], *, want_logits: bool = True) -> None:
        """Hydrate the KV cache with `tokens` starting at self.pos: chunked
        while inside the context window, token by token in the ring regime
        beyond it. Afterwards `_last_logits` holds the logits of the final
        token if want_logits."""
        toks = [int(t) for t in tokens]
        n = len(toks)
        i = 0
        for i0, take, bucket in chunk_schedule(n, self.pos, self.cfg.max_seq_len):
            last_chunk = i0 + take >= n
            mode = "last" if (want_logits and last_chunk) else "none"
            out = self._prefill(toks[i0: i0 + take], take, bucket, mode)
            if mode == "last":
                self._last_logits = out
            i = i0 + take
        while i < n:   # ring-buffer regime: per-token hydration
            last = i + 1 >= n
            out = self._step(toks[i], output_logits=want_logits and last)
            if out is not None:
                self._last_logits = out
            i += 1

    # ------------------------------------------------------------------
    def generate(self, prompt_tokens: Sequence[int], *, max_steps: int = 256,
                 temperature: float = 1.0, seed: int | None = None,
                 stop_tokens: Sequence[int] = (), block_size: int = 1,
                 top_k: int = 0, top_p: float = 1.0) -> Iterator[int]:
        """Prefill, then stream sampled token ids.

        block_size > 1 keeps the sampled tokens on the device for a block of
        that many steps and reads them back once per block; tokens past a
        stop token inside a block are discarded."""
        self.prefill_tokens(prompt_tokens, want_logits=True)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else time.time_ns() & 0x7FFFFFFF)
        stop = set(int(s) for s in stop_tokens)
        if self._last_logits is None:
            raise RuntimeError("generate needs a prompt or a hydrated cache with logits")

        def sample(logits):
            return sample_ext(logits, gen, temperature, top_k, top_p)

        token = int(sample(self._last_logits))
        steps = 0
        if block_size <= 1:
            while max_steps == -1 or steps < max_steps:
                yield token
                steps += 1
                if token in stop:
                    return
                self._last_logits = self._step(token)
                token = int(sample(self._last_logits))
            return

        yield token
        steps += 1
        if token in stop or (max_steps != -1 and steps >= max_steps):
            return
        tok_dev = torch.tensor([token], device=self.device)
        while max_steps == -1 or steps < max_steps:
            out = torch.empty(block_size, dtype=torch.long, device=self.device)
            for j in range(block_size):
                self._last_logits = self._step(tok_dev)
                tok_dev = sample(self._last_logits).reshape(1)
                out[j] = tok_dev[0]
            for t in out.tolist():   # one read-back per block
                yield t
                steps += 1
                if t in stop or (max_steps != -1 and steps >= max_steps):
                    return

    # ------------------------------------------------------------------
    def perplexity(self, tokens: Sequence[int]) -> tuple[float, float, int]:
        """Perplexity of tokens[1:] given the running context. Returns
        (ppl, standard_error, N)."""
        toks = np.asarray(tokens, np.int64)
        n = len(toks)
        if n < 2:
            raise ValueError("need at least 2 tokens for perplexity")
        logprobs: list[np.ndarray] = []
        i = 0
        # feed positions [0, n-2]; predictions for [1, n-1]
        for i0, take, bucket in chunk_schedule(n - 1, self.pos, self.cfg.max_seq_len):
            all_logits = self._prefill(toks[i0: i0 + take], take, bucket, "all")
            targets = torch.as_tensor(toks[i0 + 1: i0 + 1 + take], device=self.device)
            logprobs.append(logprob_of(all_logits[:take], targets).cpu().numpy())
            i = i0 + take
        while i < n - 1:  # ring-buffer regime: per-token
            logits = self._step(int(toks[i]))
            target = torch.as_tensor(toks[i + 1], device=self.device)
            logprobs.append(np.array([float(logprob_of(logits, target))]))
            i += 1

        lp = np.concatenate(logprobs).astype(np.float64)
        N = len(lp)
        ppl = float(np.exp(-lp.mean()))
        err = ppl * float(np.sqrt((np.sum(lp * lp) - lp.sum() ** 2 / N) / N / N))
        return ppl, err, N
