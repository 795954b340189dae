"""The chunk path and the batched tick at 32 layers, held against the JAX
package's same functions and the f32 oracle (models/transformer.py) on one
seed: 4 lanes of 5 tokens at pos0 (0, 5, 17, 40) on a random bf16 cache,
through the port's and JAX's `verify_chunk_fast_batched` (the formulation
of the verify and tree sweeps) and `decode_step_fast_batched` (the plain
tick, one token a step), and through the oracle in f32 on the same prefix.

At 32 random layers bf16 rounding grows past the batched tests' 1e-2 of
max(1, max|logit|) between any two formulations: on this seed the port's
chunk path parts from JAX's by 1.316 of that tolerance and its tick by
1.714, while JAX's own chunk path and tick part by 5.103 on the same
prefix, and every path lies 0.6-3.8 tolerances from the oracle. So the
tolerance is the unit here, and a fault in either path is what the tests
look for: a path whose rows lie farther from the oracle than JAX's same
path by more than one tolerance, a port path farther from JAX's than JAX's
two paths lie from each other, or an argmax that is neither JAX's nor
within twice the tolerance of its maximum (the near-tie rule of
tests/test_torch_spec_scheduler.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.models.cache import KVCache as JaxCache
from yalm_tpu.models.fast import decode_step_fast_batched as jax_tick
from yalm_tpu.models.fast import verify_chunk_fast_batched as jax_verify
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import decode_step_fast_batched, verify_chunk_fast_batched
from yalm_tpu_torch.models.transformer import prefill
from yalm_tpu_torch.models.weights import load_weights
from yalm_tpu_torch.utils.testing import tiny_config

from test_torch_fast import LOGIT_TOL, both_weights, fast_kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """Logits rows (4 lanes, 5 tokens, vocab) of every path on one prefix:
    port and JAX chunk path, port and JAX tick, the f32 oracle."""
    kw = fast_kw(n_layers=32, max_seq_len=64)
    jcfg, cfg = jax_tiny(**kw), tiny_config(**kw)
    path = str(tmp_path_factory.mktemp("deep") / "m.yalm")
    jax_synth(path, jcfg, seed=32)
    jw, tw = both_weights(path, jcfg)
    rng = np.random.default_rng(33)
    B, T = 4, 5
    shape = (B, cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = (np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.5, jnp.bfloat16))
              for _ in range(2))
    toks = rng.integers(3, cfg.vocab_size, (B, T))
    pos0, en = np.array([0, 5, 17, 40]), np.ones(B, np.int64)
    jt = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    out = {}
    jc = JaxCache(k=jnp.asarray(k0), v=jnp.asarray(v0))
    out["jax chunk"] = np.asarray(jax_verify(jcfg, jw, jt(toks), jt(pos0), jt(en), jc)[0],
                                  np.float32)
    tc = KVCache.from_numpy(k0, v0)
    out["port chunk"] = verify_chunk_fast_batched(cfg, tw, toks, pos0, en, tc)[0].float().numpy()
    jc, tc = JaxCache(k=jnp.asarray(k0), v=jnp.asarray(v0)), KVCache.from_numpy(k0, v0)
    jrows, trows = [], []
    for t in range(T):
        want, jc = jax_tick(jcfg, jw, jt(toks[:, t]), jt(pos0 + t), jc, jt(en))
        got, tc = decode_step_fast_batched(cfg, tw, toks[:, t], pos0 + t, tc, en)
        jrows.append(np.asarray(want, np.float32))
        trows.append(got.float().numpy())
    out["jax tick"], out["port tick"] = np.stack(jrows, 1), np.stack(trows, 1)
    ow = load_weights(read_yalm(path), cfg, "cpu")
    cache = KVCache.from_numpy(k0, v0)
    out["oracle"] = np.stack([
        prefill(cfg, ow, toks[b], int(pos0[b]), T,
                KVCache(k=cache.k[b].float(), v=cache.v[b].float()), logits_mode="all")[0].numpy()
        for b in range(B)])
    return out


def gap(a: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per row, max |a - ref| in units of the tolerance of ref's row."""
    return np.abs(a - ref).max(-1) / (LOGIT_TOL * np.maximum(1.0, np.abs(ref).max(-1)))


@pytest.mark.parametrize("path", ["chunk", "tick"])
def test_as_near_the_oracle_as_jax(rows, path):
    mine, ref = gap(rows[f"port {path}"], rows["oracle"]), gap(rows[f"jax {path}"], rows["oracle"])
    assert (mine <= ref + 1.0).all(), (mine.round(3).tolist(), ref.round(3).tolist())


@pytest.mark.parametrize("path", ["chunk", "tick"])
def test_nearer_jax_than_jax_paths_to_each_other(rows, path):
    mine = gap(rows[f"port {path}"], rows[f"jax {path}"]).max()
    assert mine < gap(rows["jax chunk"], rows["jax tick"]).max()


@pytest.mark.parametrize("path", ["chunk", "tick"])
def test_argmax_jax_or_near_tie(rows, path):
    got, ref = rows[f"port {path}"], rows[f"jax {path}"]
    pick = np.take_along_axis(ref, got.argmax(-1)[..., None], -1)[..., 0]
    tol = LOGIT_TOL * np.maximum(1.0, np.abs(ref).max(-1))
    assert ((got.argmax(-1) == ref.argmax(-1)) | (ref.max(-1) - pick <= 2 * tol)).all()
