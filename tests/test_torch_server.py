"""The port's HTTP server on the CPU (`--device cpu`: the kernels' plain
versions) on an ephemeral port: the REST surface, a greedy completion equal
to the scheduler's own stream, SSE, chat, logprobs and top_logprobs, stop
strings, a bad request, and the flags of later slices refused."""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from yalm_tpu_torch import server as srv
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.config import ModelConfig
from yalm_tpu_torch.models.fast import load_fast_weights
from yalm_tpu_torch.scheduler import Request, Scheduler
from yalm_tpu_torch.tokenizer import Tokenizer
from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config

from test_torch_fast import fast_kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srv") / "m.yalm")
    synth_checkpoint(path, tiny_config(**fast_kw(max_seq_len=128)), seed=4)
    return path


@pytest.fixture(scope="module")
def server(ckpt):
    engine = srv.ServingEngine.from_checkpoint(ckpt, batch=4, device="cpu")
    httpd = srv.serve(engine, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", engine
    httpd.shutdown()
    httpd.server_close()
    engine.close()


def post(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.headers["Content-Type"], r.read()


def test_health_models_and_metrics(server):
    base, engine = server
    assert json.loads(get(base + "/health")[1])["status"] == "ok"
    meta = json.loads(get(base + "/v1/models")[1])["data"][0]["meta"]
    assert meta["context"] == 128 and meta["dtype"] == "fp8"
    post(base + "/v1/completions", {"prompt": "metrics probe", "max_tokens": 3,
                                    "temperature": 0.0})
    ctype, body = get(base + "/metrics")
    assert "text/plain" in ctype
    vals = dict(line.rsplit(" ", 1) for line in body.decode().splitlines()
                if line and not line.startswith("#"))
    assert float(vals["yalm_requests_total"]) >= 1
    assert float(vals["yalm_tokens_generated_total"]) >= 3
    assert float(vals["yalm_requests_failed_total"]) == 0
    assert float(vals["yalm_batch_slots"]) == engine.sched.B
    assert "yalm_prefix_cache_registered_total" in vals


def test_greedy_completion_equals_the_scheduler(server, ckpt):
    base, engine = server
    _, body = post(base + "/v1/completions", {"prompt": "hello world", "max_tokens": 8,
                                              "temperature": 0.0, "logprobs": 2})
    choice = json.loads(body)["choices"][0]
    yf = read_yalm(ckpt)
    cfg = ModelConfig.from_metadata(yf.metadata)
    tok = Tokenizer.from_yalm(yf)
    sched = Scheduler(cfg, load_fast_weights(yf, cfg, "cpu"), batch=1, device="cpu",
                      top_logprobs=2)
    yf.close()
    prompt = tok.encode("hello world", bos=True)
    req = sched.submit(Request(prompt_tokens=prompt, max_new_tokens=8, temperature=0.0,
                               stop_tokens=frozenset({cfg.eos_token_id})))
    sched.run()
    text = tok.decode([t for t in req.generated if t != cfg.eos_token_id],
                      prev=prompt[-1]).decode("utf-8", errors="replace")
    assert choice["text"] == text
    lp = choice["logprobs"]
    assert lp["token_logprobs"] == pytest.approx(req.logprobs, abs=1e-5)
    # top-N keyed by decoded text: two ids may decode alike
    assert all(1 <= len(top) <= 2 for top in lp["top_logprobs"])


def test_streaming_chat_and_stop_strings(server):
    base, _ = server
    req = urllib.request.Request(
        base + "/v1/completions",
        data=json.dumps({"prompt": "hello", "max_tokens": 6, "temperature": 0.0,
                         "stream": True, "logprobs": 1}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        raw = r.read().decode()
    events = [line for line in raw.splitlines() if line.startswith("data: ")]
    assert events[-1] == "data: [DONE]" and len(events) >= 2
    streamed = "".join(json.loads(e[6:])["choices"][0]["text"] for e in events[:-1])
    _, body = post(base + "/v1/completions", {"prompt": "hello", "max_tokens": 6,
                                              "temperature": 0.0})
    full = json.loads(body)["choices"][0]
    assert streamed == full["text"] and full["finish_reason"] == "length"
    # a stop string trims the text and ends the request
    stop = full["text"][2:5]
    _, body = post(base + "/v1/completions", {"prompt": "hello", "max_tokens": 6,
                                              "temperature": 0.0, "stop": stop})
    out = json.loads(body)["choices"][0]
    assert out["text"] == full["text"][:full["text"].find(stop)]
    assert out["finish_reason"] == "stop"
    _, body = post(base + "/v1/chat/completions",
                   {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
                    "temperature": 0.0, "logprobs": True, "top_logprobs": 3})
    ch = json.loads(body)
    assert ch["object"] == "chat.completion"
    content = ch["choices"][0]["logprobs"]["content"]
    assert content and all(len(e["top_logprobs"]) == 3 and e["logprob"] <= 0 for e in content)


def test_sampled_requests_and_bad_requests(server):
    base, _ = server
    body = {"prompt": "hello", "max_tokens": 6, "temperature": 0.8, "top_k": 40,
            "top_p": 0.9, "seed": 5, "n": 2}
    out = [c["text"] for c in json.loads(post(base + "/v1/completions", body)[1])["choices"]]
    again = [c["text"] for c in json.loads(post(base + "/v1/completions", body)[1])["choices"]]
    assert out == again   # seeded: the same draws, whatever the lanes
    for bad in ({"nope": 1}, {"prompt": "x", "n": 9}, {"prompt": "x", "stop": ["a"] * 5},
                {"prompt": "x", "logit_bias": {str(i): 1 for i in range(17)}}):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(base + "/v1/completions", bad)
        assert e.value.code == 400


def test_server_paged(ckpt):
    """The port's counterpart of tests/test_paged.py's HTTP test: a paged
    server (pages of 16) completes, a repeated prompt maps the first's
    pages and streams the same, and /metrics shows the free pages (all of
    them once the requests are done) and the prefix-cache counters."""
    engine = srv.ServingEngine.from_checkpoint(ckpt, batch=4, device="cpu", paged_pages=33,
                                               page_size=16)
    httpd = srv.serve(engine, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    prompt = "hello world, the key is 12345. " * 3
    try:
        assert engine.sched.paged
        texts = [json.loads(post(base + "/v1/completions", {
            "prompt": prompt, "max_tokens": 5, "temperature": 0.0})[1])["choices"][0]["text"]
            for _ in range(2)]
        vals = dict(line.rsplit(" ", 1) for line in get(base + "/metrics")[1].decode()
                    .splitlines() if line and not line.startswith("#"))
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
    assert texts[0] == texts[1]          # the second maps the first's pages
    assert float(vals["yalm_pages_free"]) == 32
    assert float(vals["yalm_prefix_cache_hits_total"]) >= 1
    assert float(vals["yalm_prefix_cache_registered_total"]) >= 1


@pytest.mark.parametrize("flag", [["--paged-pages", "9", "--page-size", "16"],
                                  ["--draft", "d.yalm"],
                                  ["--spec-lookup"], ["--spec-k", "4"], ["--medusa"],
                                  ["--medusa-tree", "4,2"], ["--mesh", "1,1,2"],
                                  ["--distributed"]])
def test_later_slice_flags_are_refused(ckpt, flag, capsys, monkeypatch, tmp_path):
    """The flags of later slices are refused (--mesh, --distributed);
    --paged-pages, the chain speculation flags (--draft, here the
    checkpoint drafting for itself, --spec-lookup, --spec-k, --medusa on a
    checkpoint with heads) and --medusa-tree (tree-attention Medusa on the
    same checkpoint) came with their slices and start a server (stopped
    here at once) whose scheduler is in that mode."""
    if flag[0] in ("--medusa", "--medusa-tree"):
        med = str(tmp_path / "med.yalm")
        synth_checkpoint(med, tiny_config(**fast_kw(max_seq_len=128)), seed=4, medusa_heads=3)
        ckpt = med
    flag = [ckpt if a == "d.yalm" else a for a in flag]
    if flag[0] in ("--paged-pages", "--draft", "--spec-lookup", "--spec-k", "--medusa",
                   "--medusa-tree"):
        started = []

        def serve(engine, host, port):
            httpd = srv.ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(engine))
            started.append(engine)

            def stop():
                raise KeyboardInterrupt
            httpd.serve_forever = stop
            return httpd
        monkeypatch.setattr(srv, "serve", serve)
        srv.main([ckpt, "--device", "cpu", "--port", "0", *flag])
        sched = started[0].sched
        out = capsys.readouterr().out
        if flag[0] == "--paged-pages":
            assert sched.paged and sched.alloc.n_pages == 9 and sched.page_size == 16
            assert "9 pages of 16" in out and not sched.spec
        elif flag[0] == "--spec-k":   # no proposal source: plain serving, K kept
            assert not sched.spec and sched.spec_k == 4
        elif flag[0] == "--medusa-tree":
            assert sched.spec_medusa is not None and sched.spec_tree == (4, 2)
            assert "spec=medusa tree (4, 2) k=3" in out and not sched.paged
        else:
            mode = {"--draft": "draft", "--spec-lookup": "lookup", "--medusa": "medusa"}[flag[0]]
            assert sched.spec and f"spec={mode} k=" in out
            assert (sched.draft_cfg is not None, sched.spec_lookup,
                    sched.spec_medusa is not None) == tuple(m == mode for m in
                                                            ("draft", "lookup", "medusa"))
            if mode == "medusa":
                assert sched.spec_k == 3   # clamped to the head count
        return
    with pytest.raises(SystemExit) as e:
        srv.main([ckpt, "--device", "cpu", *flag])
    assert e.value.code == 2
    assert "not in this slice" in capsys.readouterr().err
