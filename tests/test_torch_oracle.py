"""The port's parity oracle (models/weights.py, models/transformer.py,
ops/attention.py) and its routes on the CPU against the JAX package.

- load_weights gives JAX's arrays bit for bit (fp32, f16, bf16, fp8; int8
  and int4 dequantized to f32; MoE; Gemma's norms), and
  FastWeights.from_weights JAX's decode layout.
- decode_step and prefill: tests/test_model.py's cases against JAX's
  oracle on the same checkpoint (f32 compute: logits within 1e-4, 1e-3
  on an f16 cache, where one element rounded a step apart shows; cache
  rows within 1e-3; bf16 compute, whose activation
  rounding may part at a last bit: 1e-2 of max(1, max|logit|)), and
  against the numpy simulator of tests/numpy_sim.py with JAX's own
  tolerances.
- the routes: Engine, Scheduler and ServingEngine take fast="auto" |
  True | False; "auto" is the kernels wherever the config fits them (a
  batch of 4 included, which JAX's TPU rule would send to the oracle),
  the oracle where it does not; True on a refused config names the kernel
  limit; the oracle refuses the paged pool and speculation as JAX's does.
- the oracle scheduler's greedy streams and logprobs against JAX's
  fast=False scheduler, and the oracle engine's against JAX's.
- each family of tests/test_hf_parity.py: a random HF model converted by
  the JAX package's converter, the port's oracle against JAX's (1e-4) and
  HF's forward (JAX's 2e-3, the argmax equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.engine import Engine as JaxEngine
from yalm_tpu.models import KVCache as JaxCache
from yalm_tpu.models import decode_step as jax_decode
from yalm_tpu.models import load_weights as jax_load_weights
from yalm_tpu.models import prefill as jax_prefill
from yalm_tpu.models.fast import FastWeights as JaxFastWeights
from yalm_tpu.scheduler import Request as JaxRequest
from yalm_tpu.scheduler import Scheduler as JaxScheduler
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch import scheduler as sched_mod
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.config import ModelConfig
from yalm_tpu_torch.engine import Engine
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import FastWeights
from yalm_tpu_torch.models.transformer import decode_step, prefill
from yalm_tpu_torch.models.weights import LayerWeights, Weights, load_weights
from yalm_tpu_torch.ops.attention import attend_one
from yalm_tpu_torch.scheduler import Request, Scheduler
from yalm_tpu_torch.server import ServingEngine
from yalm_tpu_torch.utils.testing import tiny_config

from numpy_sim import NumpySim
from test_torch_fast import fast_kw

TOL = 1e-4          # f32 compute against f32 compute
LOGIT_TOL = 1e-2    # bf16 compute: of max(1, max|logit|)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(tmp_path, seed=0, **kw):
    """A checkpoint written by the JAX package; (JAX cfg, JAX Weights, port
    cfg, port Weights, JAX tensors for the numpy simulator)."""
    path = str(tmp_path / "m.yalm")
    jcfg = jax_tiny(**kw)
    jax_synth(path, jcfg, seed=seed)
    yf = jax_read(path, native=False)
    jw = jax_load_weights(yf, jcfg)
    tensors = {k: np.array(v) for k, v in yf.tensors.items()}
    yf.close()
    yf = read_yalm(path)
    tw = load_weights(yf, tiny_config(**kw), "cpu")
    yf.close()
    return jcfg, jw, tiny_config(**kw), tw, tensors, path


def bits(a) -> np.ndarray:
    """Raw bits of a torch tensor or a JAX/numpy array, for exact compares."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float16):
            return a.view(torch.int16).numpy()
        if a.dtype in (torch.float8_e5m2, torch.float8_e4m3fn):
            return a.view(torch.uint8).numpy()
        return a.numpy().view({4: np.int32, 1: np.uint8}.get(a.element_size(), np.int64))
    a = np.asarray(a)
    return a.view({2: np.int16, 1: np.uint8, 4: np.int32}.get(a.dtype.itemsize, np.int64))


def close(got, want, tol=TOL):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def logits_close(got, want, tol=LOGIT_TOL):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------

LOAD_CASES = {
    "fp32": dict(weight_dtype="fp32"), "f16": dict(weight_dtype="fp16"),
    "bf16": dict(weight_dtype="bf16", tie_word_embeddings=False),
    "fp8": dict(weight_dtype="fp8"), "int8": dict(weight_dtype="int8", has_qkv_bias=True),
    "int4": dict(weight_dtype="int4"), "moe": dict(weight_dtype="fp8", n_experts=4,
                                                    n_experts_active=2),
    "gemma": dict(weight_dtype="bf16", has_post_norms=True, has_qk_norm=True,
                  embed_scale=16.0, act_type="gelu"),
}


@pytest.mark.parametrize("name", list(LOAD_CASES))
def test_load_weights_gives_jax_arrays(tmp_path, name):
    """Every field of the oracle's Weights bit for bit JAX's (types kept:
    f16, bf16 and fp8 as stored; int8 and int4 dequantized to f32), a tied
    head shared with the embedding; FastWeights.from_weights JAX's decode
    layout (f16 as bf16: the kernels have no f16 type)."""
    _, jw, cfg, tw, _, _ = both(tmp_path, **fast_kw(max_seq_len=32, **LOAD_CASES[name]))
    for f in LayerWeights._fields:
        a, b = getattr(tw.layers, f), getattr(jw.layers, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape), f
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=f)
    for f in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(bits(getattr(tw, f)), bits(getattr(jw, f)), err_msg=f)
    assert (tw.lm_head is tw.embed) == cfg.tie_word_embeddings
    if name in ("int8", "int4"):
        assert tw.layers.wq.dtype == torch.float32
    fw = FastWeights.from_weights(tw, cfg)
    jfw = JaxFastWeights.from_weights(jw, cfg)
    for f in ("embed", "wqkv", "wo", "w13", "w2", "lm_head", "moegate", "bqkv", "qnorm", "pa"):
        a, b = getattr(fw, f), getattr(jfw, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        if b.dtype == jnp.float16:
            b = b.astype(jnp.bfloat16)
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f)
    assert (fw.lm_head is fw.embed) == cfg.tie_word_embeddings


# ---------------------------------------------------------------------------
# decode_step and prefill (tests/test_model.py's cases)
# ---------------------------------------------------------------------------

def test_attn_reference_fixture():
    """One-hot q/k/v with a 1e4 spike: the softmax saturates on the spiked
    key (tests/test_model.py:33)."""
    q = torch.tensor([[0.0, 1e4, 0.0], [0.0, 0.0, 1e4]])
    kb = torch.tensor([[1.0, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0]],
                      dtype=torch.float16).reshape(4, 1, 3)
    out = attend_one(q.reshape(1, 2, 3), kb, kb, torch.ones(4, dtype=torch.bool)).reshape(2, 3)
    np.testing.assert_allclose(out[0].numpy(), [0.0, 1.0, 0.0], atol=1e-4)
    np.testing.assert_allclose(out[1].numpy(), [0.0, 0.0, 1.0], atol=1e-4)


DECODE_CASES = {
    "dense": (dict(max_seq_len=16), 10, torch.float16, 2e-3),
    "moe": (dict(max_seq_len=16, n_experts=4, n_experts_active=2), 10, torch.float16, 2e-3),
    # 20 > 8: the ring wraps twice, the sinks rotate
    "ring": (dict(max_seq_len=8, dim=32, hidden_dim=64, head_dim=8, rotary_dim=8,
                  vocab_size=64), 20, torch.float16, 5e-3),
    "clip": (dict(qkv_clip=0.05), 3, torch.float16, 2e-3),
    "fp16 weights": (dict(weight_dtype="fp16"), 3, torch.float16, None),
    "fp8 weights": (dict(weight_dtype="fp8"), 3, torch.float16, None),
    "e5m2 cache": (dict(max_seq_len=8, dim=32, hidden_dim=64, head_dim=8, rotary_dim=8,
                        vocab_size=64), 12, torch.float8_e5m2, None),
    "gemma2 forms": (dict(max_seq_len=16, has_post_norms=True, attn_softcap=50.0,
                          final_softcap=30.0, sliding_window=6, layer_sliding=(1, 0),
                          act_type="gelu"), 22, torch.float32, None),
    "gemma3 forms": (dict(max_seq_len=16, has_post_norms=True, has_qk_norm=True,
                          sliding_window=6, layer_sliding=(1, 0), act_type="gelu",
                          embed_scale=8.0, rope_scale=("gemma3", 2.0, 1e4)), 22,
                     torch.float32, None),
}
JAX_KV = {torch.float16: jnp.float16, torch.float8_e5m2: jnp.float8_e5m2,
          torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_matches_jax_and_numpy_sim(tmp_path, name):
    """Token by token (through the ring and its sinks where the window is
    short): logits and the cache within 1e-4 of JAX's oracle, and, on the
    f16 caches of tests/test_model.py, the numpy simulator's logits within
    its tolerance there."""
    kw, n, kv, sim_tol = DECODE_CASES[name]
    jcfg, jw, cfg, tw, tensors, _ = both(tmp_path, n_layers=2, **kw)
    sim = NumpySim(jcfg, tensors) if sim_tol else None
    jc, tc = JaxCache.init(jcfg, JAX_KV[kv]), KVCache.init(cfg, kv, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, n)
    for pos, tok in enumerate(toks):
        want, jc = jax_decode(jcfg, jw, jnp.int32(tok), jnp.int32(pos), jc)
        got, tc = decode_step(cfg, tw, int(tok), pos, tc)
        # an f16 cache: a cache element the two round one f16 step apart
        # (2^-11 relative) reaches the logits
        close(got, want, tol=TOL if kv != torch.float16 else 1e-3)
        if sim is not None:
            np.testing.assert_allclose(got.numpy(), sim.forward(int(tok), pos), rtol=sim_tol,
                                       atol=sim_tol)
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        close(got.float(), np.asarray(want, np.float32), tol=1e-3)


def test_decode_bf16_compute_matches_jax(tmp_path):
    """compute_dtype bf16 (the server's oracle): within 1e-2 of max(1,
    max|logit|) of JAX's at every step, on a bf16 cache."""
    jcfg, jw, cfg, tw, _, _ = both(tmp_path, max_seq_len=16)
    jc, tc = JaxCache.init(jcfg, jnp.bfloat16), KVCache.init(cfg, torch.bfloat16, "cpu")
    tok = 5
    for pos in range(20):
        want, jc = jax_decode(jcfg, jw, jnp.int32(tok), jnp.int32(pos), jc,
                              compute_dtype=jnp.bfloat16)
        got, tc = decode_step(cfg, tw, tok, pos, tc, compute_dtype=torch.bfloat16)
        logits_close(got, want)
        tok = int(np.argmax(np.asarray(want)))


@pytest.mark.parametrize("mode", ["last", "all", "all_h", "none"])
def test_prefill_matches_jax_and_sequential_decode(tmp_path, mode):
    """A padded chunk (9 valid of 16) against JAX's prefill (every logits
    mode) and the port's own sequential decode (tests/test_model.py:130,
    1e-4); the padding rows of the cache stay zero."""
    jcfg, jw, cfg, tw, _, _ = both(tmp_path, max_seq_len=32)
    toks = np.zeros(16, np.int32)
    toks[:9] = np.random.default_rng(3).integers(0, cfg.vocab_size, 9)
    jc = JaxCache.init(jcfg, jnp.float32)
    tc = KVCache.init(cfg, torch.float32, "cpu")
    want, jc = jax_prefill(jcfg, jw, jnp.asarray(toks), jnp.int32(0), jnp.int32(9), jc,
                           logits_mode=mode)
    got, tc = prefill(cfg, tw, toks, 0, 9, tc, logits_mode=mode)
    if mode == "none":
        assert got is None and want is None
    elif mode == "all_h":
        close(got[0][:9], np.asarray(want[0])[:9])
        close(got[1][:9], np.asarray(want[1])[:9])
    else:
        close(got if mode == "last" else got[:9], np.asarray(want) if mode == "last"
              else np.asarray(want)[:9])
    close(tc.k, jc.k)
    assert not tc.k[:, 9:].any()
    seq = KVCache.init(cfg, torch.float32, "cpu")
    for pos in range(9):
        step, seq = decode_step(cfg, tw, int(toks[pos]), pos, seq)
        if mode == "all":
            close(got[pos], step.numpy())
    if mode == "last":
        close(got, step.numpy())
    close(tc.k, seq.k.numpy())


def test_prefill_chunked_matches_single_chunk(tmp_path):
    """Two chunks (8 + 4) give the one chunk's logits (tests/test_model.py:154)."""
    _, _, cfg, tw, _, _ = both(tmp_path, max_seq_len=32)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, 12)
    one, _ = prefill(cfg, tw, toks, 0, 12, KVCache.init(cfg, torch.float32, "cpu"))
    c = KVCache.init(cfg, torch.float32, "cpu")
    assert prefill(cfg, tw, toks[:8], 0, 8, c, logits_mode="none")[0] is None
    two, _ = prefill(cfg, tw, toks[8:], 8, 4, c)
    close(two, one.numpy())
    with pytest.raises(ValueError, match="window"):
        prefill(cfg, tw, toks, 24, 12, c)


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------

def test_engine_routes(tmp_path):
    """Engine.from_checkpoint: "auto" loads FastWeights on a supported
    config, fast=False the oracle's Weights (f16 cache kept; the kernels run
    it as bf16); an oracle Weights given with fast=True is laid out by
    FastWeights.from_weights; FastWeights on the oracle route raise; the
    oracle engine's greedy stream is JAX's oracle engine's."""
    jcfg, jw, cfg, tw, _, path = both(tmp_path, **fast_kw(max_seq_len=64))
    auto = Engine.from_checkpoint(path, device="cpu", kv_dtype=torch.float16)
    assert auto.fast and isinstance(auto.weights, FastWeights)
    assert auto.kv_dtype == torch.bfloat16
    orc = Engine.from_checkpoint(path, device="cpu", fast=False, kv_dtype=torch.float16)
    assert not orc.fast and isinstance(orc.weights, Weights)
    assert orc.kv_dtype == orc.cache.k.dtype == torch.float16
    assert Engine(cfg, tw, device="cpu", fast=True).fast
    with pytest.raises(ValueError, match="Weights"):
        Engine(cfg, auto.weights, device="cpu", fast=False)
    with pytest.raises(ValueError, match="'auto', True or False"):
        Engine(cfg, tw, device="cpu", fast="yes")
    got = list(orc.generate([1, 7, 42], max_steps=12, temperature=0.0))
    je = JaxEngine(jcfg, jw, fast=False, kv_dtype=jnp.float16)
    want = list(je.generate([1, 7, 42], max_steps=12, temperature=0.0))
    assert got == want
    orc.reset()
    je.reset()
    ppl, _, n = orc.perplexity(list(range(3, 40)))
    jppl, _, jn = je.perplexity(list(range(3, 40)))
    assert n == jn and abs(ppl - jppl) <= 1e-4 * jppl


def test_batch4_stays_on_the_kernels(tmp_path, monkeypatch):
    """A supported config at batch 4 (JAX's TPU sublane rule would send it
    to the oracle): the Scheduler and the ServingEngine take the kernels'
    path, and the oracle never runs."""
    _, _, cfg, _, _, path = both(tmp_path, **fast_kw(max_seq_len=32))

    def never(*a, **k):
        raise AssertionError("the oracle ran")
    monkeypatch.setattr(sched_mod, "decode_step", never)
    monkeypatch.setattr(sched_mod, "prefill", never)
    eng = ServingEngine.from_checkpoint(path, device="cpu", batch=4)
    try:
        assert eng.sched.fast and isinstance(eng.sched.weights, FastWeights)
        assert len(eng.complete("hello", max_tokens=4, temperature=0.0)) >= 0
    finally:
        eng.close()
    yf = read_yalm(path)
    from yalm_tpu_torch.models.fast import load_fast_weights
    fw = load_fast_weights(yf, cfg, "cpu")
    yf.close()
    s = Scheduler(cfg, fw, batch=4, device="cpu")
    r = s.submit(Request(prompt_tokens=[1, 5, 9], max_new_tokens=5, temperature=0.0))
    s.run()
    assert s.fast and len(r.generated) == 5


def test_oracle_refusals_and_auto(tmp_path):
    """The oracle's scheduler refuses the paged pool and speculation
    (scheduler.py:538, :825); a config the attention kernel refuses (one kv
    head of 8 queries x 512) takes the oracle under "auto" and names the
    limit under fast=True."""
    _, _, cfg, tw, _, _ = both(tmp_path, max_seq_len=32)
    with pytest.raises(ValueError, match="paged cache requires the fast path"):
        Scheduler(cfg, tw, device="cpu", fast=False, paged_pages=9, page_size=16)
    with pytest.raises(ValueError, match="needs the fast path"):
        Scheduler(cfg, tw, device="cpu", fast=False, spec_lookup=True)
    wide = dict(dim=64, hidden_dim=128, head_dim=512, n_heads=8, n_kv_heads=1,
                rotary_dim=512, vocab_size=128, max_seq_len=16)
    _, _, wcfg, ww, _, wpath = both(tmp_path, **wide)
    with pytest.raises(ValueError, match="qpk\\*head_dim <= 2048"):
        Scheduler(wcfg, ww, device="cpu", fast=True)
    s = Scheduler(wcfg, ww, device="cpu")
    assert not s.fast and s.dense_prefix is None and not s.batched_admission
    r = s.submit(Request(prompt_tokens=[1, 5, 9, 4], max_new_tokens=6, temperature=0.0))
    s.run()
    assert len(r.generated) == 6
    eng = ServingEngine.from_checkpoint(wpath, device="cpu", batch=2)
    try:
        assert not eng.sched.fast and isinstance(eng.sched.weights, Weights)
        assert eng.sched.compute_dtype == torch.bfloat16
        eng.complete("hello", max_tokens=3, temperature=0.0)
    finally:
        eng.close()


@pytest.mark.parametrize("kv", [torch.float32, torch.float16])
def test_oracle_scheduler_streams_match_jax(tmp_path, kv):
    """The oracle scheduler (fast=False: per-lane decode steps, per-slot
    prefill) against JAX's fast=False scheduler on the same checkpoint and
    cache type: the greedy streams equal, the logprobs and top-3 within
    1e-4; a short prompt, a two-chunk one, one past the 32-slot window (the
    ring regime) and one more than the batch holds at once."""
    jcfg, jw, cfg, tw, _, _ = both(tmp_path, max_seq_len=32)
    rng = np.random.default_rng(11)
    prompts = [[1] + rng.integers(3, 128, n).tolist() for n in (4, 19, 39, 7, 11)]
    js = JaxScheduler(jcfg, jw, batch=4, fast=False, kv_dtype=JAX_KV[kv], top_logprobs=3)
    ts = Scheduler(cfg, tw, batch=4, fast=False, kv_dtype=kv, top_logprobs=3, device="cpu")
    assert not ts.fast and not js.fast
    jr = [js.submit(JaxRequest(prompt_tokens=p, max_new_tokens=6, temperature=0.0))
          for p in prompts]
    tr = [ts.submit(Request(prompt_tokens=p, max_new_tokens=6, temperature=0.0))
          for p in prompts]
    js.run()
    ts.run()
    for got, want in zip(tr, jr):
        assert got.generated == want.generated and len(got.generated) == 6
        np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4)
        for mine, ref in zip(got.top_logprobs, want.top_logprobs):
            assert [t for t, _ in mine] == [t for t, _ in ref]
            np.testing.assert_allclose([lp for _, lp in mine], [lp for _, lp in ref], atol=1e-4)


# ---------------------------------------------------------------------------
# the families of tests/test_hf_parity.py
# ---------------------------------------------------------------------------

try:   # the families need transformers (tests/test_hf_parity.py skips without it too)
    import test_hf_parity as hf
    HF_CASES = hf.test_converted_logits_match_transformers.pytestmark[0].args[1]
except pytest.skip.Exception:
    hf, HF_CASES = None, []


@pytest.mark.parametrize("arch,extra", HF_CASES,
                         ids=[f"{a}-{i}" for i, (a, _) in enumerate(HF_CASES)])
def test_hf_family_oracle_matches_jax_and_transformers(tmp_path, arch, extra):
    """A random HF model of the family, converted by the port's converter
    (fp32), whose bytes equal the JAX package's converter's: the port's
    oracle prefill logits within 1e-4 of JAX's oracle and within JAX's 2e-3
    of HF's forward, the argmax equal; for Gemma2 also token-by-token
    decode (the age-based sliding mask)."""
    from yalm_tpu.config import ModelConfig as JaxConfig
    from yalm_tpu.convert import convert as jax_convert
    from yalm_tpu_torch.convert import convert
    model, d = hf._mk_hf(tmp_path, arch, **extra)
    out = str(tmp_path / f"{arch}.yalm")
    convert(d, out, "fp32")
    jax_convert(d, str(tmp_path / "jax.yalm"), "fp32")
    with open(out, "rb") as f, open(tmp_path / "jax.yalm", "rb") as g:
        assert f.read() == g.read()
    yf = jax_read(out, native=False)
    jcfg = JaxConfig.from_metadata(yf.metadata)
    jw = jax_load_weights(yf, jcfg)
    yf.close()
    yf = read_yalm(out)
    cfg = ModelConfig.from_metadata(yf.metadata)
    tw = load_weights(yf, cfg, "cpu")
    yf.close()
    ids = np.array([1, 5, 9, 13, 42, 7, 99, 3, 64, 120, 17, 2])
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids[None])).logits[0].float().numpy()
    got, _ = prefill(cfg, tw, ids, 0, len(ids), KVCache.init(cfg, torch.float32, "cpu"),
                     logits_mode="all")
    want, _ = jax_prefill(jcfg, jw, jnp.asarray(ids, jnp.int32), jnp.int32(0),
                          jnp.int32(len(ids)), JaxCache.init(jcfg, jnp.float32),
                          logits_mode="all")
    close(got, np.asarray(want))
    np.testing.assert_allclose(got.numpy(), hf_logits, rtol=2e-3, atol=2e-3)
    assert (got.numpy().argmax(-1) == hf_logits.argmax(-1)).all()
    if arch == "gemma2":
        c = KVCache.init(cfg, torch.float32, "cpu")
        for t in range(len(ids)):
            step, c = decode_step(cfg, tw, int(ids[t]), t, c)
            np.testing.assert_allclose(step.numpy(), hf_logits[t], rtol=2e-3, atol=2e-3)
