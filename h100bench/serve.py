"""The system under test: the port's continuous-batching server,
`yalm_tpu_torch.server.ServingEngine`, with its scheduler thread, driven
through `ServingEngine.submit` with tokenized requests (no tokenizer, no
HTTP). `Server` is what a traffic generator sees: it submits requests,
stamps every delivered token with the host clock, and hands back the
requests that finished."""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Optional

import torch

from .traffic import Spec

POLL_S = 0.01


@dataclasses.dataclass
class Record:
    """One request as the harness saw it: host times in seconds."""

    spec: Spec
    client: Optional[int]
    due: float
    submit: float = 0.0
    times: list = dataclasses.field(default_factory=list)   # one per delivered token
    req: object = None
    reported: bool = False

    @property
    def first(self) -> Optional[float]:
        return self.times[0] if self.times else None

    @property
    def failed(self) -> bool:
        return self.req is not None and self.req.error is not None

    @property
    def finished(self) -> Optional[float]:
        """When its last token was delivered (None until then)."""
        return self.times[-1] if len(self.times) >= self.spec.max_new_tokens else None


def port_config(cfg: dict):
    """The port's ModelConfig of a configuration file."""
    from yalm_tpu_torch.config import ModelConfig
    hq = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // hq
    return ModelConfig(
        dim=cfg["hidden_size"], hidden_dim=cfg["intermediate_size"], head_dim=hd,
        n_layers=cfg["num_hidden_layers"], n_heads=hq, n_kv_heads=cfg["num_key_value_heads"],
        vocab_size=cfg["vocab_size"], max_seq_len=cfg["max_position_embeddings"],
        bos_token_id=cfg["bos_token_id"], eos_token_id=cfg["eos_token_id"],
        rope_theta=float(cfg["rope_theta"]), rotary_dim=hd, norm_eps=float(cfg["rms_norm_eps"]),
        act_type=cfg["hidden_act"], weight_dtype="fp8",
        n_experts=int(cfg.get("num_local_experts", 0)),
        n_experts_active=int(cfg.get("num_experts_per_tok", 0)))


def fast_weights(w: dict):
    """The port's FastWeights over the benchmark's tensors (no copy)."""
    from yalm_tpu_torch.models.fast import FastWeights
    return FastWeights(embed=w["embed"], rms_att=w["rms_att"], rms_ffn=w["rms_ffn"],
                       wqkv=w["wqkv"], wo=w["wo"], w13=w["w13"], w2=w["w2"],
                       final_norm=w["final_norm"], lm_head=w["lm_head"], moegate=w["moegate"])


class Server:
    def __init__(self, cfg: dict, weights: dict, batch: int, device="cuda"):
        from yalm_tpu_torch.server import ServingEngine
        self.mcfg = port_config(cfg)
        self.cuda = torch.device(device).type == "cuda"
        self.vocab, self.bos = self.mcfg.vocab_size, self.mcfg.bos_token_id
        self.engine = ServingEngine(self.mcfg, fast_weights(weights), None, batch=batch,
                                    kv_dtype=torch.bfloat16, device=device, fast=True)
        self.records: list[Record] = []
        self._finished: "queue.Queue[Record]" = queue.Queue()
        self.w0: Optional[float] = None
        self.w1: Optional[float] = None
        self.on_open = None     # called with the window's start, once it is known

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def submit(self, spec: Spec, due: float, client: Optional[int] = None) -> Record:
        from yalm_tpu_torch.scheduler import Request
        rec = Record(spec, client, due)
        req = Request(prompt_tokens=list(spec.prompt), max_new_tokens=spec.max_new_tokens,
                      temperature=spec.temperature, top_k=spec.top_k, top_p=spec.top_p,
                      seed=spec.seed, stop_tokens=frozenset())
        times, last, fin = rec.times, spec.max_new_tokens, self._finished

        def on_token(_tok):   # on the scheduler thread: a stamp, and a put at the end
            times.append(time.perf_counter())
            if len(times) == last:
                fin.put(rec)
        req.on_token = on_token
        rec.req = req
        self.records.append(rec)
        rec.submit = time.perf_counter()
        self.engine.submit(req)
        return rec

    def next_finished(self, timeout: float) -> Optional[Record]:
        """The next request that delivered its last token or failed, waiting
        at most `timeout` seconds."""
        end = time.perf_counter() + timeout
        while True:
            left = end - time.perf_counter()
            if left <= 0:
                return None
            try:
                rec = self._finished.get(timeout=min(left, 0.05))
                rec.reported = True
                return rec
            except queue.Empty:
                for rec in self.records:
                    if rec.failed and not rec.reported:
                        rec.reported = True
                        return rec

    def wait_until(self, pred, timeout: float) -> bool:
        end = time.perf_counter() + timeout
        while not pred():
            if time.perf_counter() > end:
                return False
            time.sleep(POLL_S)
        return True

    def open_window(self, t: float) -> None:
        self.w0 = t
        if self.on_open is not None:
            self.on_open(t)

    def close_window(self, t: float) -> None:
        self.w1 = t

    def warm(self, greedy_sampled: tuple) -> None:
        """Run each shape the serving path takes once before the load: a lone
        admission's chunks of 256 and 64 rows, then one of 16, and batched
        sweeps of 256, 64 and 16 rows, with a few ticks after each, one
        request of each pair sampled as the mix samples."""
        temp, top_p, top_k = greedy_sampled
        plan = [[306], [10], [306, 266], [10, 12]]
        for group in plan:
            recs = []
            for i, n in enumerate(group):
                spec = Spec(prompt=[self.bos] + [3 + (7 * j) % (self.vocab - 3)
                                                 for j in range(n - 1)],
                            max_new_tokens=4, seed=i)
                if i:
                    spec.temperature, spec.top_p, spec.top_k = temp, top_p, top_k
                recs.append(self.submit(spec, self.now()))
            if not self.wait_until(lambda: all(r.finished or r.failed for r in recs), 600):
                raise RuntimeError("warm-up requests did not finish")
            if any(r.failed for r in recs):
                raise RuntimeError(f"warm-up request failed: {recs[0].req.error}")
        if self.cuda:
            torch.cuda.synchronize()
        self.records.clear()
        self._finished = queue.Queue()

    def close(self) -> None:
        self.engine.close()
