"""Inference engine over the fast path or the parity oracle (port of
`Engine` in `yalm_tpu/engine.py`; `fast="auto"` takes the kernels wherever
the config fits them, as the JAX engine does).

The prompt is hydrated in bucketed chunks of batched GEMMs while it fits
the context window and token by token in the ring-buffer regime beyond it;
decode runs one `decode_step_fast` per token and samples on the device.
PyTorch runs eagerly, so there is no compilation: each step launches the
kernels directly, and the KV cache is updated in place.

Speculative decoding (engine.py:506-904): a draft engine's K+1 decode
steps, prompt lookup (spec.py) or the checkpoint's Medusa heads (medusa.py)
propose K tokens, and one chunked forward of [cur, d0..d_{K-1}] verifies
them; greedy streams are the target's greedy stream, sampled ones its
temperature distribution (rejection sampling).
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from .codec.format import read_yalm
from .config import ModelConfig
from .models.cache import KVCache
from .medusa import MedusaWeights, load_medusa_weights, medusa_propose
from .models.fast import (FastWeights, decode_step_fast, fast_supported, fast_unsupported,
                          load_fast_weights, prefill_fast)
from .models.transformer import decode_step, prefill
from .models.weights import Weights, load_weights
from .ops.cuda.attention import KV_DTYPES
from .sampler import logprob_of, sample_ext
from .spec import NgramHistory, pointmass_rejection_verify
from .tokenizer import Tokenizer

# Prefill chunk buckets: prompts are processed in full chunks of the largest
# bucket, with the tail padded up to the smallest fitting bucket.
PREFILL_BUCKETS = (16, 64, 256)


def _bucket_for(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return PREFILL_BUCKETS[-1]


def _softmax_T(logits: np.ndarray, T: float) -> np.ndarray:
    z = logits.astype(np.float64) / max(T, 1e-8)
    z -= z.max()
    e = np.exp(z)
    return e / e.sum()


def rejection_sample_verify(rng, T: float, t_lg: np.ndarray, d: list[int], d_lg: np.ndarray):
    """Speculative rejection-sampling acceptance (Leviathan et al.,
    arXiv:2211.17192; engine.py:59-86). t_lg: target logits rows 0..K (row
    i scores the token after the i-length accepted prefix); d: the K draft
    proposals; d_lg: the draft's logits for each proposal. Returns (emitted,
    accepted): emitted has accepted+1 tokens whose joint distribution equals
    target-only temperature sampling. Draws exactly what the JAX function
    draws from the same numpy Generator."""
    K = len(d)
    a = 0
    emitted: list[int] = []
    for i in range(K):
        p = _softmax_T(t_lg[i], T)
        q = _softmax_T(d_lg[i], T)
        x = d[i]
        if rng.random() < min(1.0, p[x] / max(q[x], 1e-300)):
            emitted.append(x)
            a += 1
            continue
        res = np.clip(p - q, 0.0, None)
        z = res.sum()
        tok = int(rng.choice(len(res), p=res / z)) if z > 0 else int(p.argmax())
        emitted.append(tok)
        break
    else:
        pK = _softmax_T(t_lg[K], T)
        emitted.append(int(rng.choice(len(pK), p=pK)))
    return emitted, a


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


def resolve_fast(cfg: ModelConfig, fast) -> bool:
    """The route of an engine or scheduler (engine.py:145-159): "auto" takes
    the kernels wherever the config fits them (fast_supported, which is
    also fast_batched_supported: any batch, the port's kernels have no
    sublane rule), else the oracle; True on a config the kernels refuse
    raises with the kernel limit it breaks. Decided from the config alone,
    before any launch."""
    if fast == "auto":
        return fast_supported(cfg)
    if fast not in (True, False):
        raise ValueError(f"fast must be 'auto', True or False, got {fast!r}")
    why = fast_unsupported(cfg) if fast else None
    if why:
        raise ValueError(f"this model's shapes do not fit the port's kernels: {why}")
    return bool(fast)


def route_weights(cfg: ModelConfig, weights, fast: bool, device: torch.device):
    """The weights in the route's layout: FastWeights for the kernels (an
    oracle Weights is concatenated, as FastWeights.from_weights does), the
    oracle's Weights otherwise; on `device`."""
    if fast and isinstance(weights, Weights):
        weights = FastWeights.from_weights(weights, cfg)
    if not fast and not isinstance(weights, Weights):
        raise ValueError("the oracle route (fast=False) takes the Weights of "
                         "models/weights.py:load_weights")
    on = weights.wqkv.device if fast else weights.embed.device
    if on.type != device.type:
        raise ValueError(f"weights on {on}, engine on {device}")
    return weights


def route_kv_dtype(kv_dtype: torch.dtype, fast: bool) -> torch.dtype:
    """The cache type of the route: the kernels' caches are bf16 (an f16
    request runs as bf16) and e5m2; the oracle takes f32, f16, bf16 and
    e5m2."""
    if fast and kv_dtype == torch.float16:
        kv_dtype = torch.bfloat16
    allowed = KV_DTYPES if fast else KV_DTYPES + (torch.float16, torch.float32)
    if kv_dtype not in allowed:
        raise NotImplementedError(f"KV cache {kv_dtype}: the {'kernels' if fast else 'oracle'} "
                                  f"take {', '.join(str(d) for d in allowed)}")
    return kv_dtype


class Engine:
    """Single-sequence inference engine on one device: on the kernels
    (FastWeights) or on the parity oracle (Weights, models/transformer.py),
    by `fast` ("auto": the kernels wherever the config fits them); or on
    one rank of a mesh (engine.py:136-206)."""

    def __init__(self, cfg: ModelConfig, weights, tokenizer: Optional[Tokenizer] = None, *,
                 kv_dtype: torch.dtype = torch.bfloat16, device="cuda", fast="auto",
                 compute_dtype: torch.dtype = torch.float32, mesh=None):
        """compute_dtype: the oracle's weight and activation type in its
        products (sums in f32); the kernels ignore it.

        mesh (parallel/mesh.Mesh): this process is one rank of a mesh, on
        the mesh's device, and every rank runs the same calls in lockstep
        (the CLI's SPMD loop): the kernels on the rank's shard with the
        collectives of parallel/fast_tp.py, or (fast=False, or "auto" on
        shards the kernels refuse) the oracle on the rank's cut with those
        of parallel/oracle.py; the logits, and so the sampled tokens, are
        the same on every rank (a generator seeded alike; a seed left to
        the clock is the leader's). weights: oracle Weights or a whole
        shard-major FastWeights (cut to the rank's shard), or the rank's
        shard (load_fast_weights(tp=, ep=, rank=)); the oracle takes the
        whole model's Weights."""
        self.mesh = mesh
        self.shard = None
        if mesh is not None:
            from .parallel.fast_tp import TPShard, mesh_route, mesh_weights
            from .parallel.oracle import OracleShard, shard_oracle_weights
            self.device = resolve_device(mesh.device)
            self.fast = mesh_route(cfg, fast, mesh)
            kv_dtype = route_kv_dtype(kv_dtype, self.fast)
            if self.fast:
                weights = mesh_weights(cfg, weights, mesh)
                self.shard = TPShard(cfg, mesh)
            else:
                weights = shard_oracle_weights(weights, cfg, mesh)
                self.shard = OracleShard(cfg, mesh)
        else:
            self.device = resolve_device(device)
            self.fast = resolve_fast(cfg, fast)
            kv_dtype = route_kv_dtype(kv_dtype, self.fast)
            weights = route_weights(cfg, weights, self.fast, self.device)
        self.compute_dtype = compute_dtype
        self.cfg = cfg
        self.weights = weights
        self.tokenizer = tokenizer
        self.kv_dtype = kv_dtype
        self.cache = self._new_cache()
        self.pos = 0          # next absolute position to be written
        self._last_logits: Optional[torch.Tensor] = None
        self.medusa: Optional[MedusaWeights] = None   # the checkpoint's heads, if any
        self._spec_stats: Optional[dict] = None

    @classmethod
    def from_checkpoint(cls, path: str, *, context: int = 0, device="cuda", fast="auto",
                        mesh=None, **kw) -> "Engine":
        """Load a checkpoint straight into the route's layout
        (engine.py:312-345): load_fast_weights for the kernels,
        load_weights for the oracle; on a mesh each rank reads only its
        shard (load_fast_weights(tp=, ep=, rank=)), or for the sharded
        oracle the whole Weights on the host, which it cuts."""
        yf = read_yalm(path)
        try:
            cfg = ModelConfig.from_metadata(yf.metadata, context=context)
            if mesh is not None:
                from .parallel.fast_tp import mesh_route
                dev = resolve_device(mesh.device)
                fast = mesh_route(cfg, fast, mesh)
                weights = (load_fast_weights(yf, cfg, dev, tp=mesh.shape["tp"],
                                             ep=mesh.shape["ep"], rank=mesh.position)
                           if fast else load_weights(yf, cfg, "cpu"))
            else:
                dev = resolve_device(device)
                fast = resolve_fast(cfg, fast)
                weights = (load_fast_weights if fast else load_weights)(yf, cfg, dev)
            tok = Tokenizer.from_yalm(yf)
            eng = cls(cfg, weights, tok, device=dev, fast=fast, mesh=mesh, **kw)
            if "medusa_heads" in yf.metadata:
                # self-drafting heads ride the checkpoint; small beside the model
                eng.medusa = load_medusa_weights(yf, cfg, dev)
        finally:
            yf.close()  # the weights were copied out of the mapping
        return eng

    # ------------------------------------------------------------------
    def _new_cache(self) -> KVCache:
        """A zeroed cache: on a mesh the rank's kv heads."""
        if self.mesh is not None:
            from .parallel.fast_tp import local_cache
            from .parallel.oracle import oracle_cache
            return (local_cache if self.fast else oracle_cache)(self.cfg, self.mesh,
                                                                self.kv_dtype)
        return KVCache.init(self.cfg, self.kv_dtype, self.device)

    def reset(self) -> None:
        self.cache = self._new_cache()
        self.pos = 0
        self._last_logits = None

    def warmup(self) -> None:
        """Build and load the CUDA kernels before the first timed step (a
        no-op on the CPU)."""
        if self.device.type == "cuda" and self.fast:
            from .ops.cuda import _build
            _build.lib()

    def _step(self, token, output_logits: bool = True):
        if self.fast:
            logits, self.cache = decode_step_fast(self.cfg, self.weights, token, self.pos,
                                                  self.cache, output_logits=output_logits,
                                                  shard=self.shard)
        else:
            logits, self.cache = decode_step(self.cfg, self.weights, token, self.pos, self.cache,
                                             output_logits=output_logits,
                                             compute_dtype=self.compute_dtype, shard=self.shard)
        self.pos += 1
        return logits

    def _prefill(self, toks, take: int, bucket: int, mode: str):
        padded = np.zeros(bucket, np.int64)
        padded[:take] = toks
        if self.fast:
            out, self.cache = prefill_fast(
                self.cfg, self.weights, padded, self.pos, take, self.cache, logits_mode=mode,
                attend_len=attend_bucket(self.pos + bucket, self.cfg.max_seq_len),
                shard=self.shard)
        else:
            out, self.cache = prefill(self.cfg, self.weights, padded, self.pos, take, self.cache,
                                      logits_mode=mode, compute_dtype=self.compute_dtype,
                                      shard=self.shard)
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
        if seed is None:
            seed = time.time_ns() & 0x7FFFFFFF
            if self.mesh is not None:   # every rank draws the same tokens
                seed = self.mesh.broadcast_int(seed)
        gen.manual_seed(seed)
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
    # speculative decoding (engine.py:506-904)
    def _decode_block(self, token, n: int, temperature: float = 0.0,
                      gen: Optional[torch.Generator] = None, want_logits: bool = False):
        """n decode steps from `token` at self.pos, each token picked on the
        device (argmax at temperature 0, else drawn at the temperature with
        no top-k/top-p cut) and read back once at the end; with want_logits
        also every step's logits (n, vocab). The draft's side of
        speculation (JAX's _decode_block / _decode_block_logits)."""
        out = torch.empty(n, dtype=torch.long, device=self.device)
        lgs = []
        tok = token
        for i in range(n):
            logits = self._step(tok)
            tok = sample_ext(logits, gen, temperature).reshape(1)
            out[i:i + 1] = tok
            if want_logits:
                lgs.append(logits)
        return out.tolist(), (torch.stack(lgs) if want_logits else None)

    def _spec_start(self, prompt_tokens, temperature: float, seed, stats: dict):
        """A speculative stream's start: prefill the prompt, seed the numpy
        Generator of the acceptance rules and the device generator of the
        draws, and pick the first token from the prompt's logits (argmax at
        T 0, else drawn from the numpy Generator as the JAX engine draws
        it). Returns (T, rng, gen, first token)."""
        self._spec_stats = stats
        self.prefill_tokens(prompt_tokens, want_logits=True)
        if self._last_logits is None:
            raise RuntimeError("speculation needs a prompt or a hydrated cache with logits")
        T = float(temperature)
        rng = np.random.default_rng(seed if seed is not None else 0)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else 0)
        if T == 0.0:
            return T, rng, gen, int(torch.argmax(self._last_logits))
        p0 = _softmax_T(self._last_logits.float().cpu().numpy(), T)
        return T, rng, gen, int(rng.choice(len(p0), p=p0))

    def _plain_tail(self, cur: int, T: float, gen, steps: int, max_steps: int, stop,
                    draft: Optional["Engine"] = None) -> Iterator[int]:
        """Plain decode from the speculation edge on: the ring regime cannot
        roll back a rejection."""
        while max_steps == -1 or steps < max_steps:
            self._last_logits = self._step(cur)
            if draft is not None:
                draft.pos += 1   # kept in step; the draft is not used past here
            cur = int(sample_ext(self._last_logits, gen, T))
            yield cur
            steps += 1
            if cur in stop:
                return

    def _verify(self, cur: int, d: list[int], bucket: int, mode: str = "all"):
        """The target's verify chunk [cur] + d at self.pos in ONE chunked
        forward (rows 0..len(d) score the token after each accepted prefix).
        Returns (logits (bucket, vocab), hidden rows or None, pos0); the
        caller rewinds self.pos past the accepted prefix."""
        pos0 = self.pos
        out = self._prefill([cur] + list(d), len(d) + 1, bucket, mode)
        logits, hidden = out if mode == "all_h" else (out, None)
        return logits, hidden, pos0

    @staticmethod
    def _greedy_accept(t_lg: torch.Tensor, d: list[int]) -> tuple[list[int], int]:
        """The longest prefix of d that agrees with the target's argmax rows,
        then the target's own next token."""
        t = torch.argmax(t_lg[:len(d) + 1], dim=-1).tolist()
        a = 0
        while a < len(d) and d[a] == t[a]:
            a += 1
        return [int(x) for x in d[:a]] + [int(t[a])], a

    def _spec_loop(self, cur: int, T: float, rng, gen, K: int, propose, *, max_steps: int,
                   stop_tokens: Sequence[int], draft: Optional["Engine"] = None,
                   mode: str = "all", emitted_to=None) -> Iterator[int]:
        """The speculation rounds shared by the three proposal sources, from
        the first token `cur` on. propose(cur, hidden) gives (d, d_lg): the
        K proposals (a draft's, with its logits when sampling; [] runs a
        1-token chunk; None one plain step) from the token after the
        accepted prefix and, in mode "all_h", that row's post-final-norm
        hidden row. ONE chunked forward verifies [cur] + d; at T 0 the
        stream is the target's greedy one, else rejection sampling against
        the draft's logits or the point mass. Rows past the accepted prefix
        are abandoned, not cleared (pos is rewound, the draft's too); at the
        window edge (the target's or the draft's, whichever is smaller) it
        falls back to plain steps. emitted_to(tokens) sees every token
        emitted after cur."""
        stats = self._spec_stats
        stop = set(int(s) for s in stop_tokens)
        steps = 1
        yield cur
        if cur in stop:
            return
        # the verify chunk holds K+1 tokens: [cur] + the K proposals
        bucket = _bucket_for(K + 1)
        # a draft's window binds too: its ring regime rotates sink keys,
        # which a rejection cannot undo
        edge = min(self.cfg.max_seq_len, draft.cfg.max_seq_len if draft else self.cfg.max_seq_len)
        hidden = None
        while max_steps == -1 or steps < max_steps:
            if self.pos + bucket >= edge:
                yield from self._plain_tail(cur, T, gen, steps, max_steps, stop, draft)
                return
            d, d_lg = propose(cur, hidden)
            if d is None:   # nothing to propose: one plain step
                stats["plain"] += 1
                self._last_logits = self._step(cur)
                emitted = [int(sample_ext(self._last_logits, gen, T))]
            else:
                all_logits, all_h, pos0 = self._verify(cur, d, bucket, mode)
                if T == 0.0:
                    emitted, a = self._greedy_accept(all_logits, d)
                elif d_lg is not None:
                    emitted, a = rejection_sample_verify(
                        rng, T, all_logits[:K + 1].float().cpu().numpy(), d,
                        d_lg[:K].float().cpu().numpy())
                else:
                    emitted, a = pointmass_rejection_verify(
                        rng, T, all_logits[:len(d) + 1].float().cpu().numpy(), d)
                if d:
                    for k, n in (("rounds", 1), ("proposed", len(d)), ("accepted", a)):
                        if k in stats:
                            stats[k] += n
                else:
                    stats["plain"] += 1
                # rows pos0..pos0+a hold [cur, d0..d_{a-1}]; the next round's
                # forwards write the row of emitted[-1]
                self.pos = pos0 + a + 1
                if draft is not None:
                    draft.pos = self.pos
                self._last_logits = all_logits[a]
                hidden = None if all_h is None else all_h[a]
            if emitted_to is not None:
                emitted_to(emitted)
            for tok in emitted:
                yield int(tok)
                steps += 1
                if tok in stop or (max_steps != -1 and steps >= max_steps):
                    return
            cur = emitted[-1]

    def generate_speculative(self, prompt_tokens: Sequence[int], *,
                             draft: Optional["Engine"] = None, n_draft: int = 4,
                             max_steps: int = 256, stop_tokens: Sequence[int] = (),
                             temperature: float = 0.0, seed: int | None = None,
                             ngram_max: int = 3,
                             hist_tokens: Sequence[int] | None = None) -> Iterator[int]:
        """Speculative decoding: the DRAFT engine proposes n_draft tokens per
        round (K+1 decode steps) and this engine verifies them in ONE chunked
        forward, so one target weight sweep yields up to n_draft+1 tokens.
        draft=None proposes by prompt lookup instead (_generate_prompt_lookup;
        hist_tokens seeds its n-gram history with context already in the
        cache).

        temperature 0: the target's greedy stream exactly (acceptance is
        argmax agreement). temperature > 0: rejection sampling (Leviathan et
        al.): the draft samples x_i ~ q_i, the target accepts w.p.
        min(1, p_i(x_i)/q_i(x_i)) and on rejection draws the normalised
        residual max(p_i - q_i, 0), so the stream is distributed as the
        target's own temperature sampling (no top-k/top-p)."""
        if draft is None:
            yield from self._generate_prompt_lookup(
                prompt_tokens, n_draft=n_draft, max_steps=max_steps, stop_tokens=stop_tokens,
                temperature=temperature, seed=seed, ngram_max=ngram_max,
                hist_tokens=hist_tokens)
            return
        T, rng, gen, cur = self._spec_start(prompt_tokens, temperature, seed,
                                            {"rounds": 0, "accepted": 0})
        draft.prefill_tokens(prompt_tokens, want_logits=False)
        K = min(max(1, int(n_draft)), PREFILL_BUCKETS[-1] - 1)

        def propose(cur, _):
            # the draft's (K+1)-th step writes the row for d[K-1], which
            # full acceptance keeps visible
            d_all, d_lg = draft._decode_block(cur, K + 1, T, gen, want_logits=T > 0)
            return d_all[:K], d_lg
        yield from self._spec_loop(cur, T, rng, gen, K, propose, max_steps=max_steps,
                                   stop_tokens=stop_tokens, draft=draft)

    def _generate_prompt_lookup(self, prompt_tokens: Sequence[int], *, n_draft: int = 4,
                                max_steps: int = 256, stop_tokens: Sequence[int] = (),
                                temperature: float = 0.0, seed: int | None = None,
                                ngram_max: int = 3,
                                hist_tokens: Sequence[int] | None = None) -> Iterator[int]:
        """Prompt-lookup speculation (engine.py:678-794): proposals continue
        the most recent earlier occurrence of the history's trailing n-gram
        (spec.NgramHistory), verified by the same chunked forward; a round
        with no match runs one plain step. T=0 emits the greedy stream, T>0
        uses point-mass rejection sampling (spec.pointmass_rejection_verify)."""
        T, rng, gen, cur = self._spec_start(
            prompt_tokens, temperature, seed,
            {"rounds": 0, "accepted": 0, "proposed": 0, "plain": 0})
        hist = NgramHistory([int(t) for t in (hist_tokens or [])]
                            + [int(t) for t in prompt_tokens] + [cur], max_ngram=ngram_max)
        K = min(max(1, int(n_draft)), PREFILL_BUCKETS[-1] - 1)
        yield from self._spec_loop(cur, T, rng, gen, K, lambda cur, _: (hist.propose(K) or None,
                                                                        None),
                                   max_steps=max_steps, stop_tokens=stop_tokens,
                                   emitted_to=hist.extend)

    def generate_medusa(self, prompt_tokens: Sequence[int], *, max_steps: int = 256,
                        stop_tokens: Sequence[int] = (), temperature: float = 0.0,
                        seed: int | None = None) -> Iterator[int]:
        """Medusa self-drafting speculation (engine.py:796-904): the
        checkpoint's H heads read the post-final-norm hidden row of the last
        accepted position, which the previous verify forward returned (the
        first round runs a 1-token chunk to get it), and propose the next H
        tokens; the chunked forward verifies them. Point-mass proposals: the
        greedy stream at T=0, the target's temperature distribution at T>0."""
        mw = self.medusa
        if mw is None:
            raise ValueError("checkpoint has no medusa heads (metadata medusa_heads)")
        if self.mesh is not None:
            raise ValueError("medusa speculation on a mesh engine is not supported yet "
                             "(engine.py:820)")
        T, rng, gen, cur = self._spec_start(
            prompt_tokens, temperature, seed,
            {"rounds": 0, "accepted": 0, "proposed": 0, "plain": 0})
        K = min(mw.n_heads, PREFILL_BUCKETS[-1] - 1)
        yield from self._spec_loop(
            cur, T, rng, gen, K,
            lambda cur, h: ([] if h is None else medusa_propose(mw, h)[:K].tolist(), None),
            max_steps=max_steps, stop_tokens=stop_tokens, mode="all_h")

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
