"""The port's Medusa heads and Medusa speculation on the CPU (plain
versions) against the JAX package: the heads load to the JAX arrays (and
carry across from them), their proposals take the JAX argmax with logits
within 1e-2 of max(1, max|logit|), `prefill_fast(logits_mode="all_h")`
gives JAX's logits and post-final-norm rows within the same tolerance, and
`generate_medusa`'s greedy stream equals the JAX engine's and the port's
plain greedy stream token for token, whatever the heads propose, also
across the window edge; sampled streams run to full length and repeat for
a seed; the CLI's -u completion equals the JAX CLI's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu import cli as jax_cli
from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.engine import Engine as JaxEngine
from yalm_tpu.medusa import load_medusa_weights as jax_load_heads
from yalm_tpu.medusa import medusa_propose as jax_propose
from yalm_tpu.medusa import medusa_propose_rows as jax_propose_rows
from yalm_tpu.models.cache import KVCache as JaxCache
from yalm_tpu.models.fast import prefill_fast as jax_prefill
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch import cli
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.config import ModelConfig
from yalm_tpu_torch.engine import Engine
from yalm_tpu_torch.medusa import (load_medusa_weights, medusa_logits_rows, medusa_propose,
                                   medusa_propose_rows, medusa_weights_from_numpy)
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import prefill_fast

from test_torch_fast import both_weights, close, fast_kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(d, name, heads, seed=70, **over):
    # seed 70's greedy stream repeats tokens, so identity heads get accepted
    over.setdefault("max_seq_len", 128)
    path = str(d / f"{name}.yalm")
    jax_synth(path, jax_tiny(**fast_kw(**over)), seed=seed, medusa_heads=heads)
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("medusa")
    return {"rand": _mk(d, "rand", 4), "ident": _mk(d, "ident", -4),
            "edge": _mk(d, "edge", 3, seed=71, max_seq_len=32),
            "plain": _mk(d, "plain", 0)}


def _jax_heads(path, cfg_kw):
    yf = jax_read(path, native=False)
    mw = jax_load_heads(yf, jax_tiny(**fast_kw(**cfg_kw)))
    yf.close()
    return mw


def _port_heads(path):
    yf = read_yalm(path)
    mw = load_medusa_weights(yf, ModelConfig.from_metadata(yf.metadata), "cpu")
    yf.close()
    return mw


@pytest.mark.parametrize("wdt,heads,extra", [
    ("fp8", 3, {}), ("int8", -2, {}), ("bf16", 2, dict(tie_word_embeddings=False)),
    ("int4", -3, {})])
def test_heads_load_to_the_jax_arrays(tmp_path, wdt, heads, extra):
    kw = dict(weight_dtype=wdt, max_seq_len=32, **extra)
    path = str(tmp_path / "m.yalm")
    jax_synth(path, jax_tiny(**fast_kw(**kw)), seed=5, medusa_heads=heads)
    want, got = _jax_heads(path, kw), _port_heads(path)
    assert got.n_heads == abs(heads)
    for f in ("w1", "b1", "head"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    carried = medusa_weights_from_numpy({f: np.asarray(getattr(want, f))
                                         for f in ("w1", "b1", "head")})
    for f in ("w1", "b1", "head", "w1_op", "head_op"):
        assert torch.equal(getattr(carried, f), getattr(got, f))


def _jax_logits(mw, hidden):
    """The JAX heads' logits (medusa.py:101-112's arithmetic)."""
    z = jnp.einsum("hij,bj->bhi", mw.w1.astype(jnp.bfloat16), hidden.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32) + mw.b1[None]
    z = hidden[:, None].astype(jnp.float32) + jax.nn.silu(z)
    return jnp.einsum("hvi,bhi->bhv", mw.head.astype(jnp.bfloat16), z.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("seed", range(4))
def test_proposals_match_jax(ckpts, seed):
    want_mw, mw = _jax_heads(ckpts["rand"], dict(max_seq_len=128)), _port_heads(ckpts["rand"])
    hidden = np.random.default_rng(seed).standard_normal((5, 256)).astype(np.float32) * 2
    ref = np.asarray(_jax_logits(want_mw, jnp.asarray(hidden)))
    got = medusa_logits_rows(mw, torch.from_numpy(hidden))
    close(got, ref)
    props = medusa_propose_rows(mw, torch.from_numpy(hidden)).numpy()
    np.testing.assert_array_equal(props, np.asarray(jax_propose_rows(want_mw,
                                                                     jnp.asarray(hidden))))
    np.testing.assert_array_equal(props, ref.argmax(-1))
    np.testing.assert_array_equal(medusa_propose(mw, torch.from_numpy(hidden[2])).numpy(),
                                  np.asarray(jax_propose(want_mw, jnp.asarray(hidden[2]))))


@pytest.mark.parametrize("wdt,pos0,valid", [("fp8", 0, 16), ("int8", 5, 11), ("int4", 9, 16)])
def test_prefill_all_h_matches_jax(tmp_path, wdt, pos0, valid):
    kw = fast_kw(weight_dtype=wdt, max_seq_len=64)
    path = str(tmp_path / "m.yalm")
    jax_synth(path, jax_tiny(**kw), seed=8)
    jw, tw = both_weights(path, jax_tiny(**kw))
    cfg_t = ModelConfig.from_metadata(read_yalm(path).metadata)
    toks = np.random.default_rng(1).integers(3, 512, 16)
    hist = np.random.default_rng(2).integers(3, 512, 16)
    jc, tc = JaxCache.init(jax_tiny(**kw), jnp.bfloat16), KVCache.init(cfg_t, torch.bfloat16,
                                                                       "cpu")
    if pos0:
        _, jc = jax_prefill(jax_tiny(**kw), jw, jnp.asarray(hist), jnp.int32(0),
                            jnp.int32(pos0), jc, logits_mode="none")
        prefill_fast(cfg_t, tw, hist, 0, pos0, tc, logits_mode="none")
    (jl, jh), _ = jax_prefill(jax_tiny(**kw), jw, jnp.asarray(toks), jnp.int32(pos0),
                              jnp.int32(valid), jc, logits_mode="all_h")
    (tl, th), _ = prefill_fast(cfg_t, tw, toks, pos0, valid, tc, logits_mode="all_h")
    assert tl.shape == (16, 512) and th.shape == (16, 256)
    close(tl[:valid], np.asarray(jl)[:valid])
    close(th[:valid], np.asarray(jh)[:valid])
    # "all" gives the same logits
    tc2 = KVCache.init(cfg_t, torch.bfloat16, "cpu")
    if pos0:
        prefill_fast(cfg_t, tw, hist, 0, pos0, tc2, logits_mode="none")
    assert torch.equal(prefill_fast(cfg_t, tw, toks, pos0, valid, tc2, logits_mode="all")[0], tl)


def plain_with_gaps(eng, prompt, n):
    """The plain greedy stream and, per token, whether the logits that chose
    it had their top two within twice the logit tolerance (a near-tie that
    the chunk-vs-step numerics may flip)."""
    out, near = [], []
    for t in eng.generate(prompt, max_steps=n, temperature=0.0):
        lg = eng._last_logits.float()
        top = torch.topk(lg, 2).values
        near.append(bool(top[0] - top[1] <= 2 * 1e-2 * max(1.0, float(lg.abs().max()))))
        out.append(t)
    return out, near


def agree_until_near_tie(got, plain, near) -> int:
    """The number of tokens compared before the first near-tie of the plain
    stream; raises on a difference before it."""
    assert len(got) == len(plain)
    for i, (g, p) in enumerate(zip(got, plain)):
        if near[i]:
            return i
        assert g == p, (i, got, plain)
    return len(got)


@pytest.mark.parametrize("heads", ["rand", "ident"])
def test_generate_medusa_matches_jax(ckpts, heads):
    prompt = [1, 7, 42]
    je = JaxEngine.from_checkpoint(ckpts[heads], kv_dtype=jnp.bfloat16)
    want = list(je.generate_medusa(prompt, max_steps=24, temperature=0.0))
    te = Engine.from_checkpoint(ckpts[heads], device="cpu")
    got = list(te.generate_medusa(prompt, max_steps=24, temperature=0.0))
    assert got == want and te._spec_stats == je._spec_stats
    assert te._spec_stats["rounds"] >= 1
    if heads == "ident":   # the model's own argmax repeated: some proposals land
        assert te._spec_stats["accepted"] >= 1, te._spec_stats
    # the heads' checkpoint without them: the same model
    plain = Engine.from_checkpoint(ckpts["plain"], device="cpu")
    assert got == list(plain.generate(prompt, max_steps=24, temperature=0.0))


def test_generate_medusa_head_independence_and_window_edge(ckpts):
    """Random and identity heads emit the same stream (proposals are only
    verified), and past the window edge the stream falls back to plain
    steps: equal to the JAX engine's across the ring, and to the port's
    plain stream up to the first near-tie (tests/test_medusa.py:66-76
    holds JAX's to head independence alone there)."""
    rand = list(Engine.from_checkpoint(ckpts["rand"], device="cpu").generate_medusa(
        [1, 7, 42], max_steps=24, temperature=0.0))
    ident = list(Engine.from_checkpoint(ckpts["ident"], device="cpu").generate_medusa(
        [1, 7, 42], max_steps=24, temperature=0.0))
    assert rand == ident
    je = JaxEngine.from_checkpoint(ckpts["edge"], kv_dtype=jnp.bfloat16)
    want = list(je.generate_medusa([1, 2, 3], max_steps=40, temperature=0.0))
    te = Engine.from_checkpoint(ckpts["edge"], device="cpu")
    got = list(te.generate_medusa([1, 2, 3], max_steps=40, temperature=0.0))
    assert got == want and len(got) == 40 and te.pos > 32
    plain, near = plain_with_gaps(Engine.from_checkpoint(ckpts["edge"], device="cpu"),
                                  [1, 2, 3], 40)
    agree_until_near_tie(got, plain, near)


def test_generate_medusa_sampled_and_no_heads(ckpts):
    te = Engine.from_checkpoint(ckpts["ident"], device="cpu")
    toks = list(te.generate_medusa([1, 7], max_steps=16, temperature=0.9, seed=3))
    assert len(toks) == 16 and all(0 <= t < 512 for t in toks)
    again = list(Engine.from_checkpoint(ckpts["ident"], device="cpu").generate_medusa(
        [1, 7], max_steps=16, temperature=0.9, seed=3))
    assert again == toks
    with pytest.raises(ValueError, match="no medusa heads"):
        next(Engine.from_checkpoint(ckpts["plain"], device="cpu").generate_medusa([1, 7]))


def test_cli_medusa_matches_jax_cli(ckpts, capsysbinary):
    from test_torch_spec import _completion
    args = [ckpts["ident"], "-d", "cpu", "-m", "completion", "-i", "hello world",
            "-n", "20", "-t", "0", "-u"]
    jax_cli.main(args)
    want = _completion(capsysbinary.readouterr().out)
    cli.main(args)
    got = _completion(capsysbinary.readouterr().out)
    assert got == want and got[1].startswith(b"Speculative stats: ")
