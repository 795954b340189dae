"""The one-lane split of csrc/attention.cu (K2 attend_step_l, K12
attend_one_l) on the CPU, where the kernel cannot run: the plan of chunks
(`split_plan`), the ring window's chunk skip (`chunk_live`), and a plain
emulation of the two passes' arithmetic -- each chunk's max and sum, the
sum rescaled in chunk order, p normalised and then cast to bf16, the
chunks' partial outputs summed in chunk order -- against the port's
`attend_ref` and the JAX package's `_attend_ref` on the same inputs.

Tolerance of the emulation: 1e-5 of max(1, max|ref|) for the f32 sums taken
in another order, plus, for each p that the two round to bf16 on the two
sides of a rounding boundary (the sum l differs in its last bits), that
one bf16 ulp times |v| -- each such p is checked to differ by at most one
ulp, and they are rare.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.ops.pallas import attention as jatt
from yalm_tpu_torch.models.fast import ring_slots
from yalm_tpu_torch.ops.core import NEG_INF
from yalm_tpu_torch.ops.cuda.attention import (MAX_SPLIT, SPLIT_BLOCKS, TILE, attend_ref,
                                               chunk_live, sink_view, slot_age, split_plan)
from yalm_tpu_torch.ops.cuda.gemv import bf16f

torch.set_num_threads(1)

TOL = 1e-5

# (S, pos, win, Hk): linear lanes inside and past a window, ring lanes
# whose window wraps around the ring or not, Mistral's and Gemma's shapes
PLAN_CASES = [(4096, 0, 0, 8), (4096, 62, 0, 8), (4096, 63, 0, 8), (4096, 64, 0, 8),
              (4096, 3968, 0, 8), (4096, 4095, 0, 8), (4096, 6000, 0, 8),
              (4096, 3995, 1024, 8), (4096, 5999, 1024, 8), (4096, 4100, 1024, 8),
              (8192, 6000, 4096, 8), (8192, 8205, 4096, 8), (8192, 12000, 4096, 8),
              (32768, 40000, 0, 8), (100, 70, 24, 3), (300, 500, 40, 3), (7000, 7100, 0, 3),
              (300, 299, 0, 1), (1 << 20, (1 << 20) + 5, 0, 1)]


def _plan_for(S, pos, win, Hk):
    kv_sink, kv_pos, kv_len = ring_slots(pos, S)
    return kv_sink, kv_pos, kv_len, split_plan(kv_len, Hk, kv_pos=kv_pos, kv_sink=kv_sink, win=win)


@pytest.mark.parametrize("S,pos,win,Hk", PLAN_CASES)
def test_split_plan_covers_the_slots_once(S, pos, win, Hk):
    """[lo, kv_len) exactly once, in chunks of a multiple of the tile, no
    more than MAX_SPLIT of them; the live blocks within two waves (plus the
    two chunks a window's ends may cut); no slot below lo attended."""
    kv_sink, kv_pos, kv_len, plan = _plan_for(S, pos, win, Hk)
    lo, chunk, nsplit, skip = plan
    assert chunk >= TILE and chunk % TILE == 0 and lo % TILE == 0
    assert 1 <= nsplit <= MAX_SPLIT
    seen = np.zeros(kv_len, np.int64)
    for c in range(nsplit):
        c0 = lo + c * chunk
        assert c0 < kv_len                      # no empty chunk
        seen[c0:min(c0 + chunk, kv_len)] += 1
    assert (seen[lo:] == 1).all() and (seen[:lo] == 0).all()
    age = slot_age(S, kv_pos, kv_sink, "cpu")[:kv_len]
    assert win > 0 or lo == 0
    if lo:
        assert bool((age[:lo] >= win).all())
    live = sum(chunk_live(lo + c * chunk, min(lo + (c + 1) * chunk, kv_len), kv_pos, kv_sink, S,
                          win) or not skip for c in range(nsplit))
    assert Hk * live <= SPLIT_BLOCKS + 2 * Hk or nsplit == MAX_SPLIT
    assert skip == (win > 0)                    # the engine's slots: kv_pos is attended


@pytest.mark.parametrize("kv_len", [1, 2, 63, 64, 65, 127, 128, 129, 4096])
@pytest.mark.parametrize("Hk", [1, 8])
def test_split_plan_has_one_path_for_every_kv_len(kv_len, Hk):
    """K12's plan (no window): from slot 0, one chunk for a short lane,
    about SPLIT_BLOCKS / Hk for a long one."""
    lo, chunk, nsplit, skip = split_plan(kv_len, Hk)
    assert lo == 0 and not skip and (nsplit - 1) * chunk < kv_len <= nsplit * chunk
    assert nsplit == 1 if kv_len <= TILE else nsplit <= -(-SPLIT_BLOCKS // Hk)


@pytest.mark.parametrize("seed", range(6))
def test_chunk_live_is_exact(seed):
    """chunk_live (the kernel's O(1) rule) against the ages slot by slot:
    a chunk it skips holds no slot of age < win, and one it keeps holds at
    least one -- over random windows, sinks, positions and chunks."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        S = int(rng.integers(2, 400))
        kv_sink = int(rng.integers(0, min(S, 65)))
        kv_pos = int(rng.integers(0, S))
        win = int(rng.integers(1, S + 1))
        c0 = int(rng.integers(0, S))
        c1 = int(rng.integers(c0 + 1, S + 1))
        age = slot_age(S, kv_pos, kv_sink, "cpu")
        want = bool((age[c0:c1] < win).any())
        assert chunk_live(c0, c1, kv_pos, kv_sink, S, win) == want, (S, kv_sink, kv_pos, win,
                                                                      c0, c1)


@pytest.mark.parametrize("S,pos,win", [(8192, 12000, 4096), (4096, 5999, 1024), (600, 1500, 100),
                                       (300, 500, 40)])
def test_ring_window_skip_leaves_out_only_unattended_chunks(S, pos, win):
    """The plan of a sliding layer in the ring regime: every chunk it skips
    holds no slot with slot_age < win; those it keeps cover the window."""
    kv_sink, kv_pos, kv_len, plan = _plan_for(S, pos, win, 8)
    assert kv_sink > 0 and plan.skip and plan.lo == 0
    age = slot_age(S, kv_pos, kv_sink, "cpu")
    covered = torch.zeros(S, dtype=torch.bool)
    skipped = 0
    for c in range(plan.nsplit):
        c0, c1 = c * plan.chunk, min((c + 1) * plan.chunk, kv_len)
        if chunk_live(c0, c1, kv_pos, kv_sink, S, win):
            covered[c0:c1] = True
        else:
            skipped += 1
            assert not bool((age[c0:c1] < win).any())
    assert skipped > 0 and bool(covered[age < win].all())


def two_pass(q2, k, v, kv_len, plan, softcap, extra, kv_pos, kv_sink, win):
    """csrc/attention.cu's one-lane arithmetic in plain torch: the scores
    as attend_ref forms them; pass 1, each chunk's max m_c and sum l_c
    (a skipped chunk: -inf and 0); pass 2, m = max m_c and l = sum l_c
    exp(m_c - m) in chunk order, p = bf16(exp(s - m) / l), each chunk's
    partial sum of p . v, and the partials summed in chunk order. Returns
    (out (rows, D), p (Hk, P, S), 0 where no chunk reads)."""
    S, Hk, D = k.shape
    P = q2.shape[0] // Hk
    scores = torch.einsum("gpd,sgd->gps", bf16f(q2.float()).reshape(Hk, P, D), bf16f(k.float()))
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    valid = torch.arange(S) < kv_len
    if extra is not None:
        valid = valid & extra
    scores = torch.where(valid[None, None], scores, torch.full_like(scores, NEG_INF))
    spans, ms, ls = [], [], []
    for c in range(plan.nsplit):
        c0 = plan.lo + c * plan.chunk
        c1 = min(c0 + plan.chunk, kv_len)
        if plan.skip and not chunk_live(c0, c1, kv_pos, kv_sink, S, win):
            ms.append(torch.full((Hk, P), -torch.inf))
            ls.append(torch.zeros(Hk, P))
            continue
        s = scores[..., c0:c1]
        m_c = s.amax(-1)
        ms.append(m_c)
        ls.append(torch.exp(s - m_c[..., None]).sum(-1))
        spans.append((c0, c1))
    m = torch.stack(ms).amax(0)
    l = torch.zeros(Hk, P)
    for m_c, l_c in zip(ms, ls):
        l = l + l_c * torch.exp(m_c - m)
    out = torch.zeros(Hk, P, D)
    p_all = torch.zeros(Hk, P, S)
    for c0, c1 in spans:
        p = bf16f(torch.exp(scores[..., c0:c1] - m[..., None]) / l[..., None])
        p_all[..., c0:c1] = p
        out = out + torch.einsum("gps,sgd->gpd", p, bf16f(v[c0:c1].float()))
    return out.reshape(Hk * P, D), p_all


def _ulp(p):
    return torch.ldexp(torch.ones_like(p), torch.frexp(p).exponent - 8)


def holds(got, p_got, want, p_want, v):
    """got within TOL of want, plus one bf16 ulp . |v| for each p rounded
    across a boundary; every p that differs differs by one ulp at most."""
    Hk, P, S = p_want.shape
    dp = (p_got - p_want).abs()
    flips = dp > 0
    assert bool((dp[flips] <= torch.maximum(_ulp(p_want), _ulp(p_got))[flips]).all())
    assert int(flips.sum()) <= max(2, p_want.numel() // 100)
    allow = torch.einsum("gps,sgd->gpd", dp, v.float().abs()).reshape(Hk * P, -1)
    tol = TOL * max(1.0, float(want.abs().max()))
    assert bool(((got - want).abs() <= tol + allow).all()), float((got - want).abs().max())


# (S, pos, win, qpk, kv dtype): linear, linear past a window (lo > 0),
# ring + sinks, a ring window whose chunks are mostly skipped, kv_len 1
EMU_CASES = [(300, 250, None, 2, torch.bfloat16), (300, 250, 100, 1, torch.bfloat16),
             (300, 500, None, 4, torch.float8_e5m2), (600, 1500, 100, 2, torch.bfloat16),
             (300, 0, None, 2, torch.float8_e5m2), (257, 256, 64, 3, torch.float8_e5m2)]


@pytest.mark.parametrize("S,pos,win,qpk,kv", EMU_CASES)
@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["nocap", "softcap"])
@pytest.mark.parametrize("Hk", [2, 96], ids=["chunks-of-64", "long-chunks"])
def test_two_pass_emulation_matches_attend_ref_and_jax(S, pos, win, qpk, kv, softcap, Hk):
    """Over the chunk sizes the plan gives 2 heads (64 slots) and 96 heads
    (two or three chunks per head), softcap, windows and sinks."""
    D, theta = 64, 1e4
    rng = np.random.default_rng(S + pos + qpk)
    kv_sink, kv_pos, kv_len = ring_slots(pos, S)
    k = torch.from_numpy(rng.standard_normal((S, Hk, D), dtype=np.float32) * 2).to(kv)
    v = torch.from_numpy(rng.standard_normal((S, Hk, D), dtype=np.float32)).to(kv)
    q2 = torch.from_numpy(rng.standard_normal((Hk * qpk, D), dtype=np.float32) * 0.3)
    view = sink_view(k, kv_sink, pos, theta=theta, rotary_dim=D)   # f32, the sinks rounded
    extra = None if win is None else slot_age(S, kv_pos, kv_sink, "cpu") < win
    plan = split_plan(kv_len, Hk, kv_pos=kv_pos, kv_sink=kv_sink, win=win or 0)
    got, p_got = two_pass(q2, view, v, kv_len, plan, softcap, extra, kv_pos, kv_sink, win or 0)
    assert plan.nsplit > 1 or kv_len <= plan.chunk

    # the port's plain core, and its p
    want = attend_ref(q2, view, v, kv_len, softcap, extra)
    scores = torch.einsum("gpd,sgd->gps", bf16f(q2).reshape(Hk, qpk, D), bf16f(view))
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    valid = torch.arange(S) < kv_len
    if extra is not None:
        valid = valid & extra
    scores = torch.where(valid[None, None], scores, torch.full_like(scores, NEG_INF))
    holds(got, p_got, want, bf16f(torch.softmax(scores, -1)), v)

    # the JAX package's, on the same values (the e5m2 cache widened: exact)
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q2, view, v))
    jextra = None if extra is None else jnp.asarray(extra.numpy())
    jwant = torch.from_numpy(np.array(jatt._attend_ref(jq, jk, jv, kv_len, softcap, jextra)))
    jscores = jnp.einsum("gpd,sgd->gps", jq.reshape(Hk, qpk, D).astype(jnp.bfloat16),
                         jk.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    if softcap:
        jscores = softcap * jnp.tanh(jscores / softcap)
    jscores = jnp.where(jnp.asarray(valid.numpy())[None, None], jscores, jatt._NEG_INF)
    jp = np.array(jax.nn.softmax(jscores, axis=-1).astype(jnp.bfloat16).astype(jnp.float32))
    holds(got, p_got, jwant, torch.from_numpy(jp), v)
