"""HTTP serving layer over the continuous-batching scheduler (port of
`yalm_tpu/server.py` on the port's `Scheduler`).

- OpenAI-style REST surface: POST /v1/completions and
  POST /v1/chat/completions (optionally streamed as server-sent events),
  GET /v1/models, GET /health, GET /metrics. Per-request temperature,
  top_k, top_p, seed, stop, n, logprobs/top_logprobs and logit_bias.
- One scheduler thread owns the Scheduler and ticks it continuously; HTTP
  handler threads only enqueue requests and wait on queues, so all device
  work stays on that thread.
- Pure stdlib (http.server + json + threading).

Run: python -m yalm_tpu_torch.server model.yalm --port 8080 --batch 8
(`--device cpu` runs the kernels' plain versions; `--paged-pages N` serves
from a pool of N pages of `--page-size` slots, with automatic prefix
caching). Speculation and meshes come in later slices of the port: their
flags are refused.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from .codec.format import read_yalm
from .config import ModelConfig
from .engine import resolve_device
from .models.fast import load_fast_weights
from .scheduler import Request, Scheduler
from .tokenizer import Tokenizer

_SENTINEL = object()


class ServingEngine:
    """Owns the scheduler and the thread that ticks it; thread-safe
    submission. Serving defaults: batched admission, prefix caching (the
    dense registry, or the paged pool's shared pages with paged_pages > 0),
    top-5 logprobs."""

    def __init__(self, cfg: ModelConfig, weights, tokenizer: Tokenizer, *,
                 batch: int = 8, kv_dtype: torch.dtype = torch.bfloat16,
                 max_prompt_tokens: int | None = None, chat_template: str = "chatml",
                 top_logprobs: int = 5, paged_pages: int = 0, page_size: int = 256,
                 device="cuda"):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.chat_template = chat_template
        # prompt admission is chunked and interleaved with decode ticks, so
        # the cap is a pure policy knob, off by default (0/None = unlimited)
        self.max_prompt_tokens = max_prompt_tokens or 0
        self.sched = Scheduler(cfg, weights, batch=batch, kv_dtype=kv_dtype,
                               # serving optimizes TTFT under load: all
                               # admitting lanes hydrate in one weight sweep
                               batched_admission=True,
                               # prompt reuse for dense deployments too (a
                               # paged pool shares pages natively)
                               prefix_cache=True,
                               paged_pages=paged_pages, page_size=page_size,
                               # OpenAI top-N logprobs ride the tick's one
                               # packed read
                               top_logprobs=top_logprobs, device=device)
        self._inbox: "queue.Queue[tuple[Request, queue.Queue]]" = queue.Queue()
        self._watch: list[tuple[Request, "queue.Queue"]] = []
        # serving counters for /metrics
        self.metrics = {"requests_total": 0, "requests_failed_total": 0,
                        "tokens_generated_total": 0, "ticks_total": 0,
                        "recoveries_total": 0}
        self._start_time = time.time()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._drive, daemon=True,
                                        name="yalm-scheduler")
        self._thread.start()

    @classmethod
    def from_checkpoint(cls, path: str, *, context: int = 0, batch: int = 8,
                        device="cuda", **kw) -> "ServingEngine":
        dev = resolve_device(device)
        yf = read_yalm(path)
        try:
            cfg = ModelConfig.from_metadata(yf.metadata, context=context)
            weights = load_fast_weights(yf, cfg, dev)
            tok = Tokenizer.from_yalm(yf)
        finally:
            yf.close()  # the weights were copied out of the mapping
        return cls(cfg, weights, tok, batch=batch, device=dev, **kw)

    # -- scheduler thread -----------------------------------------------
    def _drive(self) -> None:
        while not self._stop.is_set():
            moved = False
            try:
                while True:
                    req, out_q = self._inbox.get_nowait()
                    try:
                        self.sched.submit(req)
                        self._watch.append((req, out_q))
                    except ValueError as e:
                        # invalid for this scheduler: fail only this request
                        req.error = str(e)
                        req.done = True
                        self.metrics["requests_total"] += 1
                        self.metrics["requests_failed_total"] += 1
                        out_q.put(_SENTINEL)
                    moved = True
            except queue.Empty:
                pass
            try:
                if self.sched.queue or self.sched.n_active:
                    self.sched.step()
                    self.metrics["ticks_total"] += 1
                elif not moved:
                    time.sleep(0.005)  # idle
            except Exception as e:  # noqa: BLE001 -- this thread must survive
                # recover() fails only the ACTIVE requests and renews the
                # cache; QUEUED requests are served on the next tick
                traceback.print_exc(file=sys.stderr)
                self.sched.recover(e)
                self.metrics["recoveries_total"] += 1
            # completion sentinels (done is set by the scheduler after the
            # final token's on_token fired, so ordering here is safe)
            still = []
            for req, out_q in self._watch:
                if req.done:
                    self.metrics["requests_total"] += 1
                    self.metrics["tokens_generated_total"] += len(req.generated)
                    if req.error:
                        self.metrics["requests_failed_total"] += 1
                    out_q.put(_SENTINEL)
                else:
                    still.append((req, out_q))
            self._watch = still

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    # -- request API ----------------------------------------------------
    def submit(self, req: Request) -> "queue.Queue":
        """Queue a tokenized request; its tokens arrive on the returned
        queue, then _SENTINEL (req.on_token, if set, is called first)."""
        out_q: "queue.Queue" = queue.Queue()
        user = req.on_token

        def on_token(tok, user=user):
            if user is not None:
                user(tok)
            out_q.put(tok)
        req.on_token = on_token
        self._inbox.put((req, out_q))
        return out_q

    def submit_prompt(self, prompt: str, *, max_tokens: int = 128,
                      temperature: float = 1.0, seed: int | None = None,
                      top_k: int = 0, top_p: float = 1.0,
                      logit_bias: dict | None = None,
                      stop_at_eos: bool = True) -> tuple[Request, "queue.Queue"]:
        if not isinstance(prompt, str):
            raise ValueError(f"prompt must be a string, got {type(prompt).__name__}")
        toks = self.tokenizer.encode(prompt, bos=True)
        if self.max_prompt_tokens and len(toks) > self.max_prompt_tokens:
            raise ValueError(
                f"prompt is {len(toks)} tokens; this server caps prompts at "
                f"{self.max_prompt_tokens} (--max-prompt-tokens)")
        stops = set()
        if stop_at_eos:
            stops.add(self.cfg.eos_token_id)
            eot = getattr(self.tokenizer, "eot_id", -1)
            if eot is not None and eot >= 0:
                stops.add(eot)
        if seed is None:
            # per-request entropy by default; an explicit seed is deterministic
            seed = int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF
        req = Request(prompt_tokens=toks, max_new_tokens=max_tokens,
                      temperature=temperature, stop_tokens=frozenset(stops),
                      seed=int(seed), top_k=int(top_k), top_p=float(top_p),
                      logit_bias=logit_bias)
        return req, self.submit(req)

    def complete(self, prompt: str, **kw) -> str:
        req, out_q = self.submit_prompt(prompt, **kw)
        parts = []
        prev = req.prompt_tokens[-1] if req.prompt_tokens else self.cfg.bos_token_id
        while True:
            item = out_q.get()
            if item is _SENTINEL:
                break
            if item not in req.stop_tokens:
                parts.append(self.tokenizer.decode_one(prev, int(item)))
            prev = int(item)
        return b"".join(parts).decode("utf-8", errors="replace")


def make_handler(engine: ServingEngine):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok",
                                 "active": engine.sched.n_active,
                                 "queued": len(engine.sched.queue)})
            elif self.path == "/metrics":
                # Prometheus text exposition: serving counters + gauges +
                # prefix-cache counters
                m = engine.metrics
                lines = []
                for k, v in m.items():
                    lines.append(f"# TYPE yalm_{k} counter")
                    lines.append(f"yalm_{k} {v}")
                for k, v in (("active_requests", engine.sched.n_active),
                             ("queued_requests", len(engine.sched.queue)),
                             ("batch_slots", engine.sched.B),
                             ("uptime_seconds",
                              round(time.time() - engine._start_time, 3))):
                    lines.append(f"# TYPE yalm_{k} gauge")
                    lines.append(f"yalm_{k} {v}")
                if engine.sched.paged:
                    lines.append("# TYPE yalm_pages_free gauge")
                    lines.append(f"yalm_pages_free {engine.sched.alloc.n_free}")
                ps = engine.sched.prefix_stats
                if ps:
                    for k, v in ps.items():
                        lines.append(
                            f"# TYPE yalm_prefix_cache_{k}_total counter")
                        lines.append(f"yalm_prefix_cache_{k}_total {v}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": "yalm-tpu", "object": "model",
                    "meta": {"dim": engine.cfg.dim,
                             "n_layers": engine.cfg.n_layers,
                             "dtype": engine.cfg.weight_dtype,
                             "context": engine.cfg.max_seq_len}}]})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/v1/completions", "/v1/chat/completions"):
                self._json(404, {"error": "not found"})
                return
            chat = self.path.endswith("chat/completions")
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                if chat:
                    from .chat import STOP_STRINGS, render
                    template = str(body.get("chat_template",
                                            engine.chat_template))
                    prompt = render(body["messages"], template)
                    stop_strings = STOP_STRINGS.get(template, ())
                else:
                    prompt = body["prompt"]
                    stop_strings = ()
                # OpenAI `stop`: string or list of up to 4 stop sequences;
                # rides the same early-cancel + trim machinery as the chat
                # templates' markers (streaming holds a tail buffer so a
                # sequence split across tokens still matches)
                user_stop = body.get("stop")
                if user_stop is not None:
                    if isinstance(user_stop, str):
                        user_stop = [user_stop]
                    if not isinstance(user_stop, list) or len(user_stop) > 4 \
                            or not all(isinstance(s, str) and s
                                       for s in user_stop):
                        raise ValueError(
                            "stop must be a non-empty string or a list of "
                            "up to 4 non-empty strings")
                    stop_strings = tuple(stop_strings) + tuple(user_stop)
                max_tokens = int(body.get("max_tokens", 128))
                temperature = float(body.get("temperature", 1.0))
                stream = bool(body.get("stream", False))
                top_k = int(body.get("top_k", 0))
                top_p = float(body.get("top_p", 1.0))
                # OpenAI logit_bias: {"token_id": bias in [-100, 100]}
                logit_bias = None
                if body.get("logit_bias"):
                    logit_bias = {
                        int(t): max(-100.0, min(100.0, float(v)))
                        for t, v in dict(body["logit_bias"]).items()}
                seed = body.get("seed")
                if seed is not None:
                    seed = int(seed)
                # OpenAI `n`: independent choices decode as CONCURRENT
                # scheduler lanes (they share every weight sweep, so n
                # choices cost ~one at the batched-tick roofline).
                n_choices = int(body.get("n", 1))
                lgp = body.get("logprobs")
                want_logprobs = bool(lgp)
                if chat:
                    n_top = int(body.get("top_logprobs", 0) or 0)
                else:
                    # completions API: `logprobs` IS the top-N count
                    n_top = (int(lgp) if isinstance(lgp, int)
                             and not isinstance(lgp, bool) else 0)
                n_top = max(0, min(n_top, engine.sched.topn))
                if not 1 <= n_choices <= 8:
                    raise ValueError("n must be between 1 and 8")
                if stream and n_choices != 1:
                    raise ValueError("n > 1 is not supported with stream")
                subs = []
                for c in range(n_choices):
                    sd = None if seed is None else seed + c
                    subs.append(engine.submit_prompt(
                        prompt, max_tokens=max_tokens,
                        temperature=temperature, seed=sd, top_k=top_k,
                        top_p=top_p, logit_bias=logit_bias))
                req, out_q = subs[0]
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return

            if not stream:
                choices = []
                total_gen = 0
                for idx, (req, out_q) in enumerate(subs):
                    text = []
                    prev = req.prompt_tokens[-1] if req.prompt_tokens \
                        else engine.cfg.bos_token_id
                    while True:
                        item = out_q.get()
                        if item is _SENTINEL:
                            break
                        if item not in req.stop_tokens:
                            text.append(engine.tokenizer.decode_one(
                                prev, int(item)))
                            if stop_strings and not req.cancelled:
                                # free the lane as soon as a stop marker
                                # lands instead of burning max_tokens
                                tail = b"".join(text[-8:]).decode(
                                    "utf-8", errors="replace")
                                if any(ss in tail for ss in stop_strings):
                                    req.cancelled = True
                        prev = int(item)
                    out = b"".join(text).decode("utf-8", errors="replace")
                    if req.error:
                        # failed request (rejected submission, poisoned
                        # callback, device error): an honest error beats an
                        # empty 200 "stop" completion
                        self._json(400 if not req.generated else 500,
                                   {"error": req.error})
                        return
                    for ss in stop_strings:  # trim stop markers
                        cut = out.find(ss)
                        if cut >= 0:
                            out = out[:cut]
                    hit_stop = (req.cancelled
                                or (req.generated
                                    and req.generated[-1]
                                    in req.stop_tokens))
                    finish = "stop" if hit_stop or len(req.generated) \
                        < max_tokens else "length"
                    total_gen += len(req.generated)
                    if chat:
                        choice = {"index": idx,
                                  "message": {"role": "assistant",
                                              "content": out},
                                  "finish_reason": finish}
                    else:
                        choice = {"index": idx, "text": out,
                                  "finish_reason": finish}
                    if want_logprobs:
                        # natural log-probs of each emitted token under the
                        # model's full distribution (scheduler-computed)
                        pv = req.prompt_tokens[-1] if req.prompt_tokens \
                            else engine.cfg.bos_token_id
                        pieces = []
                        for tk in req.generated:
                            pieces.append(engine.tokenizer.decode_one(
                                pv, tk).decode("utf-8", errors="replace"))
                            pv = tk
                        lps = [round(x, 6) for x in req.logprobs]

                        def top_at(i, prev_tok):
                            # decode each alternative with the SAME left
                            # context as the emitted token
                            return [
                                (engine.tokenizer.decode_one(prev_tok, t)
                                 .decode("utf-8", errors="replace"),
                                 round(l, 6))
                                for t, l in (req.top_logprobs[i][:n_top]
                                             if i < len(req.top_logprobs)
                                             else [])]

                        prevs = [req.prompt_tokens[-1] if req.prompt_tokens
                                 else engine.cfg.bos_token_id] \
                            + list(req.generated[:-1])
                        if chat:
                            # chat API shape: {content: [{token, logprob,
                            # bytes, top_logprobs}]}
                            choice["logprobs"] = {"content": [
                                {"token": s, "logprob": l,
                                 "bytes": list(s.encode("utf-8")),
                                 "top_logprobs": [
                                     {"token": ts, "logprob": tl,
                                      "bytes": list(ts.encode("utf-8"))}
                                     for ts, tl in top_at(i, prevs[i])]
                                 if n_top else []}
                                for i, (s, l) in enumerate(zip(pieces, lps))]}
                        else:
                            choice["logprobs"] = {
                                "tokens": pieces,
                                "token_logprobs": lps,
                                "top_logprobs": ([dict(top_at(i, prevs[i]))
                                                  for i in range(len(pieces))]
                                                 if n_top else None),
                                "text_offset": None,
                            }
                    choices.append(choice)
                self._json(200, {
                    "object": "chat.completion" if chat
                    else "text_completion",
                    "model": "yalm-tpu",
                    "choices": choices,
                    "usage": {"prompt_tokens": len(subs[0][0].prompt_tokens),
                              "completion_tokens": total_gen},
                })
                return

            # server-sent events, one data: line per token. Chat streams
            # use delta-shaped chunks, honor the template's stop strings
            # (held back via a tail buffer so a marker split across tokens
            # still matches), and CANCEL the request once a stop string
            # lands — the lane frees at the next tick instead of burning
            # the rest of max_tokens.
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes) -> None:
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

            def emit(piece: str, lp: float | None = None) -> None:
                if not piece:
                    return
                if lp is not None and lp != lp:  # NaN is not valid JSON
                    lp = None
                if chat:
                    ch = {"index": 0, "delta": {"content": piece}}
                    if want_logprobs:
                        ch["logprobs"] = {"content": [
                            {"token": piece,
                             "logprob": None if lp is None else round(lp, 6),
                             "bytes": list(piece.encode("utf-8")),
                             "top_logprobs": []}]}
                    payload = {"object": "chat.completion.chunk",
                               "choices": [ch]}
                else:
                    ch = {"index": 0, "text": piece}
                    if want_logprobs:
                        ch["logprobs"] = {
                            "tokens": [piece],
                            "token_logprobs": [None if lp is None
                                               else round(lp, 6)],
                            "top_logprobs": None,
                            "text_offset": None,
                        }
                    payload = {"choices": [ch]}
                chunk(b"data: " + json.dumps(payload).encode() + b"\n\n")

            hold = max((len(ss) for ss in stop_strings), default=0)
            # decoded-but-unflushed (piece, logprob) per token: WHOLE tokens
            # flush (one chunk each, so streamed logprobs stay per-token)
            # once the unflushed tail is long enough that a stop marker
            # split across tokens can still match inside it
            toks: list[tuple[str, float | None]] = []
            stopped = False
            item_i = 0
            prev = req.prompt_tokens[-1] if req.prompt_tokens else engine.cfg.bos_token_id

            def flush(keep_chars: int) -> None:
                while toks:
                    tail = sum(len(p) for p, _ in toks) - len(toks[0][0])
                    if tail < keep_chars:
                        return
                    piece, lp = toks.pop(0)
                    emit(piece, lp)

            while True:
                item = out_q.get()
                if item is _SENTINEL:
                    break
                lp = (req.logprobs[item_i] if want_logprobs
                      and item_i < len(req.logprobs) else None)
                item_i += 1
                if stopped:
                    continue  # drain until the scheduler frees the lane
                if item in req.stop_tokens:
                    prev = int(item)
                    continue
                toks.append((engine.tokenizer.decode_one(
                    prev, int(item)).decode("utf-8", errors="replace"), lp))
                prev = int(item)
                text = "".join(p for p, _ in toks)
                cut = min((i for i in (text.find(ss) for ss in stop_strings)
                           if i >= 0), default=-1)
                if cut >= 0:
                    # flush whole tokens before the marker, then the final
                    # partial piece (its logprob still applies to the token
                    # the fragment came from)
                    for piece, plp in toks:
                        if cut <= 0:
                            break
                        emit(piece[:cut], plp)
                        cut -= len(piece)
                    req.cancelled = True
                    stopped = True
                    toks = []
                    continue
                flush(hold)
            if not stopped:
                flush(0)
            if req.error:
                chunk(b"data: " + json.dumps({"error": req.error}).encode()
                      + b"\n\n")
            chunk(b"data: [DONE]\n\n")
            chunk(b"")  # terminal chunk

    return Handler


def serve(engine: ServingEngine, host: str = "0.0.0.0", port: int = 8080
          ) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(engine))


# flags of the JAX server that later slices of the port bring
_LATER_FLAGS = {"draft": "--draft",
                "spec_lookup": "--spec-lookup", "spec_k": "--spec-k",
                "spec_ngram": "--spec-ngram", "medusa": "--medusa",
                "medusa_tree": "--medusa-tree", "mesh": "--mesh",
                "distributed": "--distributed"}


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description="yalm_tpu_torch HTTP server")
    ap.add_argument("checkpoint")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("-T", "--context", type=int, default=0)
    ap.add_argument("--max-prompt-tokens", type=int, default=None,
                    help="reject prompts longer than this (policy knob; default/0 disables)")
    ap.add_argument("--chat-template", default="chatml",
                    help="template for /v1/chat/completions (chatml | inst | llama3 | gemma)")
    ap.add_argument("--kv", default="bf16", choices=["bf16", "fp8"],
                    help="KV-cache type (fp8 = the e5m2 cache: half the bytes)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the kernels (and fails without a GPU); cpu their "
                         "plain versions")
    ap.add_argument("--paged-pages", type=int, default=0,
                    help="paged KV: a pool of this many pages (page 0 reserved) instead "
                         "of a full window per lane, with automatic prefix caching")
    ap.add_argument("--page-size", type=int, default=256,
                    help="slots per page (must divide the context window)")
    for dest, flag in _LATER_FLAGS.items():
        store = "store_true" if dest in ("spec_lookup", "medusa", "distributed") else "store"
        ap.add_argument(flag, dest=dest, action=store, default=None,
                        help="refused: a later slice of the port (ROADMAP.md)")
    args = ap.parse_args(argv)
    given = [flag for dest, flag in _LATER_FLAGS.items() if getattr(args, dest)]
    if given:
        ap.error(f"{', '.join(given)}: not in this slice of the PyTorch port "
                 "(speculation and meshes come later; see ROADMAP.md)")

    kv_dtype = {"bf16": torch.bfloat16, "fp8": torch.float8_e5m2}[args.kv]
    engine = ServingEngine.from_checkpoint(
        args.checkpoint, context=args.context, batch=args.batch, device=args.device,
        kv_dtype=kv_dtype, max_prompt_tokens=args.max_prompt_tokens,
        chat_template=args.chat_template, paged_pages=args.paged_pages,
        page_size=args.page_size)
    httpd = serve(engine, args.host, args.port)
    paged = f", {args.paged_pages} pages of {args.page_size}" if args.paged_pages else ""
    print(f"serving on http://{args.host}:{args.port} (batch={args.batch}{paged}, "
          f"device={engine.sched.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.close()


if __name__ == "__main__":
    main()
