"""Gemma2, Gemma3, Qwen3 and Qwen3-MoE in the port on the CPU (plain
versions) against the JAX package (emulation branches) on the same
seed-made inputs: the Gemma forms of the attention steps K2, K8 and K9
(Gemma2's score softcap, the sliding window by slot age, Gemma3's
local-theta rope, alone and together, in the linear and the ring regime, on
bf16 and e5m2 caches), K12 (attend_one_l), the checkpoints and their
loading, every model path, the engine, the CLI and the scheduler.

The configurations are tests/test_gemma2.py's, tests/test_gemma3.py's and
tests/test_qwen3.py's (fast_config: 2 layers, dim 256, head_dim 128), with
fp8 weights (and one int4 Gemma2).

Tolerances: the attention steps within 2e-3 of max(1, max|ref|), their
written v rows byte for byte and their k rows too, but where an element is
one step of the cache type away (the two packages' f32 RoPE differs in the
last bit for some pairs of Gemma3's rope); whole-model logits and caches within 1e-2 of
max(1, max|logit|) (tests/test_torch_fast.py says why), and on Gemma2, whose
final softcap flattens the top of the logits, the argmax within that noise
of the reference's maximum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.engine import Engine as JaxEngine
from yalm_tpu.models.cache import KVCache as JaxCache
from yalm_tpu.models.fast import decode_step_fast as jax_decode
from yalm_tpu.models.fast import decode_step_fast_batched as jax_tick
from yalm_tpu.models.fast import decode_step_fast_batched_paged as jax_tick_paged
from yalm_tpu.models.fast import prefill_chunk_fast_batched as jax_chunk
from yalm_tpu.models.fast import prefill_chunk_fast_batched_paged as jax_chunk_paged
from yalm_tpu.models.fast import prefill_fast as jax_prefill
from yalm_tpu.models.paged import PagedKVPool as JaxPool
from yalm_tpu.ops.attention import attend_one as jax_oracle_attend_one
from yalm_tpu.ops.pallas.attention import attend_one_l as jax_attend_one_l
from yalm_tpu.ops.pallas.attention import attend_step_batched_l as jax_attend_batched
from yalm_tpu.ops.pallas.attention import attend_step_l as jax_attend_step
from yalm_tpu.ops.pallas.attention import attend_step_paged_l as jax_attend_paged
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch import cli
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.engine import Engine
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.fast import (decode_step_fast, decode_step_fast_batched,
                                        decode_step_fast_batched_paged, load_fast_weights,
                                        prefill_chunk_fast_batched,
                                        prefill_chunk_fast_batched_paged, prefill_fast)
from yalm_tpu_torch.models.paged import PagedKVPool
from yalm_tpu_torch.ops.cuda.attention import (attend_one_l, attend_step_batched_l,
                                               attend_step_l, attend_step_paged_l)
from yalm_tpu_torch.scheduler import Request, Scheduler
from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config

from test_torch_fast import both_weights, close, fast_kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}
PAGE = 16
GEMMA3_ROPE = ("gemma3", 1e6, 2.0, 1e4)

# the families: tests/test_gemma2.py's g2_config, tests/test_gemma3.py's
# g3_config, tests/test_qwen3.py's config and its MoE form, and Gemma2 on
# packed int4 weights
FAMILIES = {
    "gemma2": dict(embed_scale=16.0, has_post_norms=True, attn_softcap=50.0, final_softcap=30.0,
                   sliding_window=16, layer_sliding=(1, 0), act_type="gelu"),
    "gemma3": dict(embed_scale=16.0, has_post_norms=True, has_qk_norm=True, sliding_window=16,
                   layer_sliding=(1, 0), act_type="gelu", rope_theta=1e6,
                   rope_scale=("gemma3", 2.0, 1e4)),
    "qwen3": dict(max_seq_len=64, has_qk_norm=True),
    "qwen3_moe": dict(has_qk_norm=True, n_experts=4, n_experts_active=2),
    "gemma2_int4": dict(embed_scale=16.0, has_post_norms=True, attn_softcap=50.0,
                        final_softcap=30.0, sliding_window=16, layer_sliding=(1, 0),
                        act_type="gelu", weight_dtype="int4"),
}
SEEDS = {"gemma2": 33, "gemma3": 44, "qwen3": 142, "qwen3_moe": 143, "gemma2_int4": 34}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.element_size() == 1 else t.view(torch.int16)


def same_rows(t: torch.Tensor, w, keys: bool) -> None:
    """A cache or pool against the JAX one: v byte for byte; k byte for byte
    but where an element is one step of the cache type from the reference's
    (torch's and XLA's f32 exp and cos/sin differ in the last bit for some
    RoPE pairs, and the rotated value may round either way)."""
    ref = torch.from_numpy(np.asarray(w.astype(jnp.float32))).to(t.dtype)
    if not keys:
        assert torch.equal(_bits(t), _bits(ref))
        return
    a, b = t.float(), ref.float()
    step = torch.ldexp(torch.ones_like(b), torch.frexp(b.abs()).exponent
                       - (3 if t.element_size() == 1 else 8))
    step = torch.clamp(step, min=2.0 ** -16 if t.element_size() == 1 else 0.0)
    assert bool(((a == b) | ((a - b).abs() <= step)).all())
    assert int((a != b).sum()) <= 4


def logits_close(got, want, family):
    """1e-2 of max(1, max|logit|); on Gemma2 also the argmax within that
    noise of the reference's maximum (the final softcap flattens the top)."""
    close(got, want)
    if family.startswith("gemma2"):
        g = got.numpy().reshape(-1, got.shape[-1])
        w = np.asarray(want).reshape(g.shape)
        tol = 1e-2 * max(1.0, float(np.abs(w).max()))
        assert (w[np.arange(len(w)), g.argmax(-1)] >= w.max(-1) - tol).all()


# ------------------------------------------------------- (a) the attention forms

# (softcap, win, alt)
FORMS = {"softcap": (50.0, None, None), "win": (0.0, 12, None), "alt": (0.0, None, 1),
         "all": (30.0, 20, 1)}


def _step_inputs(rng, B=None, S=32, L=2, Hk=2, qpk=2, D=128):
    lead = () if B is None else (B,)
    f = lambda *s, sc=1.0: (rng.standard_normal(lead + s, np.float32) * sc)  # noqa: E731
    return (f(Hk, qpk, D, sc=4.0), f(Hk, D, sc=3.0), f(Hk, D), f(L, S, Hk, D, sc=3.0),
            f(L, S, Hk, D))


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("regime", ["linear", "ring"])
def test_attend_step_forms_match_jax(kv, form, regime):
    """K2's plain version against the JAX emulation: mix within 2e-3, the
    cache byte for byte; linear at pos 27 (a window of 12 or 20 masks the
    oldest slots), ring at pos 45 (the sinks are older than any window)."""
    softcap, win, alt = FORMS[form]
    jdt, tdt = KV[kv]
    q, kn, vn, k0, v0 = _step_inputs(np.random.default_rng(len(form) + len(regime)))
    S = k0.shape[1]
    pos = 27 if regime == "linear" else 45
    kv_sink = 2 if pos >= S else 0
    kv_pos, kv_len = kv_sink + (pos - kv_sink) % (S - kv_sink), min(pos + 1, S)
    rope = dict(kv_sinks=2, theta=GEMMA3_ROPE, rotary_dim=128)
    jk, jv = jnp.asarray(k0, jdt), jnp.asarray(v0, jdt)
    want, jk, jv = jax_attend_step(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jk, jv, jnp.int32(1),
        jnp.int32(kv_pos), jnp.int32(kv_len), jnp.int32(kv_sink), jnp.int32(pos),
        None if win is None else jnp.int32(win), None if alt is None else jnp.int32(alt),
        softcap=softcap, **rope)
    tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tdt)
              for a in (jnp.asarray(k0, jdt), jnp.asarray(v0, jdt)))
    got = attend_step_l(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk, tv,
                        1, kv_pos, kv_len, kv_sink, pos, win, alt, softcap=softcap, **rope)
    close(got, want, 2e-3)
    same_rows(tk, jk, keys=True)
    same_rows(tv, jv, keys=False)


def _lanes(S):
    """4 lanes: linear past a window, linear inside it, ring, read-only."""
    pos = [S - 5, 6, S + 13, 20]
    sink = [2 if p >= S else 0 for p in pos]
    kv_pos = [s + (p - s) % (S - s) for p, s in zip(pos, sink)]
    return kv_pos, [min(p + 1, S) for p in pos], sink, pos, [1, 1, 1, 0]


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("paged", [False, True], ids=["batched", "paged"])
def test_attend_step_batched_and_paged_forms_match_jax(kv, form, paged):
    """K8's and K9's plain versions against the JAX emulation (the per-lane
    vmap, :563-589, and its paged loop) over 4 lanes, a read-only one among
    them: mix within 2e-3, caches byte for byte (pools on every page but
    the reserved page 0, where the JAX emulation scatters unmapped blocks)."""
    softcap, win, alt = FORMS[form]
    jdt, tdt = KV[kv]
    rng = np.random.default_rng(len(form) + 10 * paged)
    B, S = 4, 32
    q, kn, vn, k0, v0 = _step_inputs(rng, B=B, S=S)
    scal = _lanes(S)
    rope = dict(kv_sinks=2, theta=GEMMA3_ROPE, rotary_dim=128, softcap=softcap)
    jwin = None if win is None else jnp.int32(win)
    jalt = None if alt is None else jnp.int32(alt)
    jsc = [jnp.asarray(a, jnp.int32) for a in scal]
    if paged:   # a pool of 9 pages of 16 slots, each lane's 2 pages shuffled
        tables = np.asarray([[3, 7], [5, 1], [8, 2], [4, 6]], np.int32)
        k0 = rng.standard_normal((9, 2, PAGE, 2, 128), np.float32) * 3
        v0 = rng.standard_normal((9, 2, PAGE, 2, 128), np.float32)
    jk, jv = jnp.asarray(k0, jdt), jnp.asarray(v0, jdt)
    tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tdt) for a in (jk, jv))
    args = (torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk, tv)
    jargs = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jk, jv)
    if paged:
        want, jk, jv = jax_attend_paged(*jargs, jnp.asarray(tables), jnp.int32(1), *jsc, jwin,
                                        jalt, window=S, **rope)
        got = attend_step_paged_l(*args, tables, 1, *scal, win, alt, window=S, **rope)
    else:
        want, jk, jv = jax_attend_batched(*jargs, jnp.int32(1), *jsc, jwin, jalt, **rope)
        got = attend_step_batched_l(*args, 1, *scal, win, alt, **rope)
    close(got, want, 2e-3)
    first = 1 if paged else 0
    same_rows(tk[first:], jk[first:], keys=True)
    same_rows(tv[first:], jv[first:], keys=False)


@pytest.mark.parametrize("kv_len", [1, 7, 32])
@pytest.mark.parametrize("qpk", [1, 2])
def test_attend_one_l_matches_jax(kv_len, qpk):
    """K12's plain version against JAX attend_one_l (its emulation branch,
    within 2e-3 of max(1, max|ref|)) and against the oracle attend_one (f32
    throughout, the kernels' bf16 operands: 3e-2, as
    tests/test_fast_path.py:99-112 holds the kernel), on both layers of a
    bf16 cache and of an e5m2 one."""
    L, S, Hk, D = 2, 32, 2, 128
    rng = np.random.default_rng(3)
    k0 = rng.standard_normal((L, S, Hk, D), np.float32)
    v0 = rng.standard_normal((L, S, Hk, D), np.float32)
    q = rng.standard_normal((Hk, qpk, D), np.float32)
    for jdt, tdt in KV.values():
        jk, jv = jnp.asarray(k0, jdt), jnp.asarray(v0, jdt)
        tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tdt) for a in (jk, jv))
        for layer in range(L):
            got = attend_one_l(torch.from_numpy(q), tk, tv, layer, kv_len)
            close(got, jax_attend_one_l(jnp.asarray(q), jk, jv, jnp.int32(layer),
                                        jnp.int32(kv_len)), 2e-3)
            oracle = jax_oracle_attend_one(jnp.asarray(q), jk[layer], jv[layer],
                                           jnp.arange(S) < kv_len)
            np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=3e-2, atol=3e-2)


# --------------------------------------------------- (b) checkpoints and loading

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """family -> (path, JAX cfg, JAX FastWeights, port cfg, port FastWeights)."""
    out = {}
    for fam, over in FAMILIES.items():
        kw = fast_kw(**over)
        path = str(tmp_path_factory.mktemp(fam) / "m.yalm")
        jax_synth(path, jax_tiny(**kw), seed=SEEDS[fam])
        jw, tw = both_weights(path, jax_tiny(**kw))
        out[fam] = (path, jax_tiny(**kw), jw, tiny_config(**kw), tw)
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_checkpoint_bytes_and_loader_match_jax(models, tmp_path, family):
    """The port's synth_checkpoint writes the JAX fixture's bytes (qk-norm
    and post-norm tensors included), and load_fast_weights gives the JAX
    loader's FastWeights, the norms included, bit for bit."""
    path, _, _, cfg, tw = models[family]
    mine = str(tmp_path / "mine.yalm")
    synth_checkpoint(mine, cfg, seed=SEEDS[family])
    with open(path, "rb") as a, open(mine, "rb") as b:
        assert a.read() == b.read()
    yf = read_yalm(mine)
    fw = load_fast_weights(yf, cfg, "cpu")
    for name in ("qnorm", "knorm", "pa", "pf", "wqkv", "w2", "rms_att"):
        a, b = getattr(fw, name), getattr(tw, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(_bits(a) if a.element_size() < 4 else a,
                               _bits(b) if b.element_size() < 4 else b), name
    assert (fw.qnorm is not None) == cfg.has_qk_norm and (fw.pf is not None) == cfg.has_post_norms
    yf.close()
    jyf = jax_read(mine, native=False)
    assert sorted(jyf.tensors) == sorted(read_yalm(mine).tensors)
    jyf.close()


# ------------------------------------------------ (c) single stream, prefill

@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_step_fast_matches_jax(models, family):
    """Greedy steps from an empty cache (the JAX argmax fed to both) through
    the window's edge into the ring, 8 steps past it: the unfused route
    (qk-norm, the layer's window, rope and cap, the post-norms), bf16
    cache; the e5m2 cache on Gemma2."""
    _, jcfg, jw, cfg, tw = models[family]
    jdt, tdt = KV["e5m2" if family == "gemma2" else "bf16"]
    jc, tc = JaxCache.init(jcfg, jdt), KVCache.init(cfg, tdt, "cpu")
    tok = 5
    for pos in range(cfg.max_seq_len + 8):
        want, jc = jax_decode(jcfg, jw, jnp.int32(tok), jnp.int32(pos), jc)
        got, tc = decode_step_fast(cfg, tw, tok, pos, tc)
        logits_close(got, want, family)
        tok = int(np.argmax(np.asarray(want)))
    for t, w in ((tc.k, jc.k), (tc.v, jc.v)):
        if t.element_size() == 1:
            # e5m2 keeps 2 mantissa bits: an f32 row within the tolerance may
            # round a step apart (25% of the element); every element is
            # within the tolerance or one step away, and such flips are rare
            a, b = t.float(), torch.from_numpy(np.asarray(w, np.float32))
            step = torch.ldexp(torch.ones_like(b), torch.frexp(b.abs()).exponent - 3)
            tol = 1e-2 * max(1.0, float(b.abs().max()))
            bad = (a - b).abs() > torch.clamp(step, min=tol)
            assert not bool(bad.any()), (a[bad], b[bad])
            assert int(((a - b).abs() > tol).sum()) <= 1e-3 * a.numel()
        else:
            close(t.float(), np.asarray(w, np.float32))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_fast_matches_jax(models, family):
    """Two chunks (13 of 16 valid at 0, attend 16; 10 of 16 at 13, attend
    32; the sliding layer's mask bites in the second), logits "last" then
    "all", then decode steps that continue the prefilled cache."""
    _, jcfg, jw, cfg, tw = models[family]
    jc, tc = JaxCache.init(jcfg, jnp.bfloat16), KVCache.init(cfg, torch.bfloat16, "cpu")
    rng = np.random.default_rng(3)
    for pos0, valid, attend, m in ((0, 13, 16, "last"), (13, 10, 32, "all")):
        toks = rng.integers(3, cfg.vocab_size, 16).astype(np.int32)
        want, jc = jax_prefill(jcfg, jw, jnp.asarray(toks), jnp.int32(pos0), jnp.int32(valid),
                               jc, logits_mode=m, attend_len=attend)
        got, tc = prefill_fast(cfg, tw, toks, pos0, valid, tc, logits_mode=m, attend_len=attend)
        assert tuple(got.shape) == want.shape
        logits_close(got if m == "last" else got[:valid], np.asarray(want)[:valid]
                     if m == "all" else want, family)
    for pos in range(23, 27):
        want, jc = jax_decode(jcfg, jw, jnp.int32(pos), jnp.int32(pos), jc)
        got, tc = decode_step_fast(cfg, tw, pos, pos, tc)
        logits_close(got, want, family)
    close(tc.k.float(), np.asarray(jc.k, np.float32))


# ------------------------------------- (d) the batched and paged chunk paths

@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_batched_chunk_and_ticks_match_jax(models, family, paged):
    """One chunk sweep (three lanes at different offsets, one disabled;
    paged: a chunk straddling pages, through shuffled tables), then ticks
    with a write-masked lane and a lane that crosses into the ring, on
    caches that start random; logits "lastv", then "all" on a second sweep.
    Paged pools are compared on every page but the reserved page 0."""
    _, jcfg, jw, cfg, tw = models[family]
    S = cfg.max_seq_len
    rng = np.random.default_rng(9)
    B, T = 4, 16
    nblk = S // PAGE
    tables = (np.random.default_rng(2).permutation(B * nblk) + 1).reshape(B, nblk).astype(np.int32)
    shape = ((1 + B * nblk, cfg.n_layers, PAGE) if paged else (B, cfg.n_layers, S)) + (
        cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = (np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.5, jnp.bfloat16))
              for _ in range(2))
    if paged:
        jc, tc = JaxPool(k=jnp.asarray(k0), v=jnp.asarray(v0)), PagedKVPool.from_numpy(k0, v0)
        pg = dict(page_size=PAGE)
        jchunk = lambda *a, **k: jax_chunk_paged(*a, jnp.asarray(tables), **pg, **k)  # noqa: E731
        tchunk = lambda *a, **k: prefill_chunk_fast_batched_paged(*a, tables, **pg, **k)  # noqa
        jstep = lambda *a: jax_tick_paged(*a[:5], jnp.asarray(tables), a[5], **pg)  # noqa: E731
        tstep = lambda *a: decode_step_fast_batched_paged(*a[:5], tables, a[5], **pg)  # noqa
    else:
        jc, tc = JaxCache(k=jnp.asarray(k0), v=jnp.asarray(v0)), KVCache.from_numpy(k0, v0)
        jchunk = lambda *a, **k: jax_chunk(*a, attend_len=S, **k)  # noqa: E731
        tchunk = lambda *a, **k: prefill_chunk_fast_batched(*a, attend_len=S, **k)  # noqa
        jstep, tstep = jax_tick, decode_step_fast_batched
    pos0, valid, enable = [0, 5, 16, 0], [16, 14, 9, 0], [1, 1, 1, 0]
    for mode in ("lastv", "all"):
        toks = rng.integers(3, cfg.vocab_size, (B, T)).astype(np.int32)
        want, jc = jchunk(jcfg, jw, jnp.asarray(toks), jnp.asarray(pos0, jnp.int32),
                          jnp.asarray(valid, jnp.int32), jnp.asarray(enable, jnp.int32), jc,
                          logits_mode=mode)
        got, tc = tchunk(cfg, tw, toks, pos0, valid, enable, tc, logits_mode=mode)
        assert got.shape == want.shape
        if mode == "lastv":
            logits_close(got[:3], np.asarray(want)[:3], family)
        else:
            for b in range(3):
                logits_close(got[b, :valid[b]], np.asarray(want)[b, :valid[b]], family)
    positions = np.array([16, 19, S - 3, 6])
    write = np.array([1, 1, 1, 0])               # lane 3 attends read-only
    for _ in range(5):                            # lane 2 crosses into the ring
        tok = rng.integers(3, cfg.vocab_size, B).astype(np.int32)
        want, jc = jstep(jcfg, jw, jnp.asarray(tok), jnp.asarray(positions, jnp.int32), jc,
                         jnp.asarray(write, jnp.int32))
        got, tc = tstep(cfg, tw, tok, positions, tc, write)
        logits_close(got, want, family)
        positions = positions + write
    first = 1 if paged else 0
    for t, w in ((tc.k, jc.k), (tc.v, jc.v)):
        close(t[first:].float(), np.asarray(w, np.float32)[first:])


# ------------------------------------ (e) engine, CLI, scheduler (on the CPU)

@pytest.mark.parametrize("family", ["gemma2", "gemma3", "qwen3", "qwen3_moe"])
def test_engine_and_cli_run_the_family(models, family, capsysbinary):
    """The engine's greedy stream equals the JAX engine's over a prompt that
    runs past the window (chunked, then hydrated in the ring), and the CLI
    completes on the checkpoint."""
    path, _, _, cfg, _ = models[family]
    prompt = list(range(3, 3 + cfg.max_seq_len + 6))
    want = list(JaxEngine.from_checkpoint(path).generate(prompt, max_steps=6, temperature=0.0))
    assert list(Engine.from_checkpoint(path, device="cpu").generate(
        prompt, max_steps=6, temperature=0.0)) == want
    cli.main([path, "-d", "cpu", "-m", "completion", "-i", "hello world", "-n", "6", "-t", "0"])
    assert b"Generation stats" in capsysbinary.readouterr().out


def _requests(n, max_new):
    return [Request(prompt_tokens=[1] + list(range(5 + 3 * i, 12 + 5 * i)),
                    max_new_tokens=max_new, temperature=0.0) for i in range(n)]


@pytest.mark.parametrize("family", ["gemma3", "gemma2", "qwen3", "qwen3_moe"])
def test_scheduler_dense_and_paged_streams_equal_single_stream(models, family):
    """The port's Scheduler, dense and paged (pages of 16), serves greedy
    streams equal to each other and to the engine's single-stream greedy
    decode of each prompt; the longest runs past the sliding window."""
    path, _, _, cfg, tw = models[family]
    n, max_new = 5, 12
    streams = {}
    for name, kw in (("dense", {}), ("paged", dict(paged_pages=1 + 4 * 2, page_size=PAGE))):
        sched = Scheduler(cfg, tw, batch=4, device="cpu", **kw)
        reqs = _requests(n, max_new)
        for r in reqs:
            sched.submit(r)
        sched.run()
        streams[name] = [list(r.generated) for r in reqs]
    eng = Engine.from_checkpoint(path, device="cpu")
    single = []
    for r in _requests(n, max_new):
        eng.reset()
        single.append(list(eng.generate(r.prompt_tokens, max_steps=max_new, temperature=0.0)))
    assert streams["dense"] == streams["paged"] == single
