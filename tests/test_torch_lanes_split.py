"""The B-lane split of csrc/attention.cu (K8 attend_step_batched_l, K9
attend_step_paged_l) on the CPU, where the kernel cannot run: the plan
(`lanes_split_plan`), a function of the window and the head count alone;
the device's rule for the chunks a lane reads (`lane_chunk_live`); and a
plain emulation of the two passes over B lanes -- each lane's new rows
written, each chunk's max and sum (a dead chunk -inf and 0), the sum
rescaled in chunk order, p normalised and then cast to bf16, the chunks'
partial outputs summed in chunk order -- against the port's plain versions
and the JAX package's `attend_step_batched_l` / `attend_step_paged_l` (their
emulation branches, as the JAX package's own tests run them on the CPU) on
the same inputs.

Tolerance of the emulation: 2e-3 of max(1, max|ref|), the kernels'
contract (f32 sums in another order, and a p rounded to bf16 on the other
side of a boundary where the sum differs in its last bits); the written
rows byte for byte.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalm_tpu.ops.pallas.attention import attend_step_batched_l as jax_batched
from yalm_tpu.ops.pallas.attention import attend_step_paged_l as jax_paged
from yalm_tpu_torch.ops.core import NEG_INF
from yalm_tpu_torch.ops.cuda.attention import (MAX_SPLIT, TILE, _rot, _win_arg,
                                               attend_step_batched_plain, attend_step_paged_plain,
                                               gather_pages, lane_chunk_live, lane_scalars,
                                               lanes_scratch, lanes_split_plan, sink_view,
                                               slot_age)
from yalm_tpu_torch.ops.cuda.gemv import bf16f

torch.set_num_threads(1)

TOL = 2e-3
KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}
GEMMA3_ROPE = ("gemma3", 1e6, 8.0, 1e4)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16)


@pytest.mark.parametrize("S", [64, 65, 240, 300, 1000, 4096, 7000, 8192])
@pytest.mark.parametrize("Hk", [1, 2, 3, 8])
def test_lanes_plan_covers_the_window_once_for_every_batch(S, Hk):
    """Chunks of a multiple of the tile cover [0, S) once, no more than
    MAX_SPLIT of them; the plan takes no batch size and no lane scalar, and
    the scratch of B lanes is B times one lane's."""
    assert list(inspect.signature(lanes_split_plan).parameters) == ["S", "Hk"]
    chunk, nsplit = lanes_split_plan(S, Hk)
    assert chunk >= TILE and chunk % TILE == 0 and 1 <= nsplit <= MAX_SPLIT
    seen = np.zeros(S, np.int64)
    for c in range(nsplit):
        assert c * chunk < S                     # no empty chunk
        seen[c * chunk:(c + 1) * chunk] += 1
    assert (seen == 1).all()
    qpk, D = 4, 128
    one = lanes_split_plan(S, Hk)
    for B in (1, 3, 16, 64):
        assert lanes_split_plan(S, Hk) == one
        want = B * Hk * (S * qpk + nsplit * qpk * 2)
        want = (want + 3) // 4 * 4 + B * Hk * nsplit * qpk * D
        assert lanes_scratch(one, B, S, Hk, qpk, D, "cpu").numel() == want


def test_lanes_plan_fills_the_card_at_the_served_shapes():
    """Mistral's and Gemma3's 4096-slot window at 8 kv heads: 16 chunks of
    256 slots, so 16 full-window lanes make 2048 blocks; Gemma2's 8192
    slots: 16 of 512."""
    assert lanes_split_plan(4096, 8) == (256, 16)
    assert lanes_split_plan(8192, 8) == (512, 16)


def _attended(S, kv_pos, kv_len, kv_sink, win):
    """(S,) bool: the slots a lane's attention gives weight to when some
    slot is unmasked (the reference's mask, slot < kv_len and age < win)."""
    m = torch.arange(S) < kv_len
    if win:
        m &= slot_age(S, kv_pos, kv_sink, "cpu") < win
    return m


@pytest.mark.parametrize("seed", range(6))
def test_lane_liveness_kills_no_attended_chunk(seed):
    """lane_chunk_live (the kernel's rule, decided on the device) over
    random windows and lanes -- linear and ring regimes, sliding windows
    that wrap around the ring, write-masked lanes whose kv_pos lies past
    their kv_len, kv_len 1: no dead chunk holds an attended slot, every
    chunk below kv_len of a lane whose kv_pos is not attended is read, and
    every lane reads at least one chunk."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        S = int(rng.integers(1, 600))
        Hk = int(rng.integers(1, 9))
        chunk, nsplit = lanes_split_plan(S, Hk)
        pos = int(rng.integers(0, 3 * S))
        kv_sink = min(2, S - 1) if pos >= S and S > 2 else 0
        kv_pos = kv_sink + (pos - kv_sink) % max(S - kv_sink, 1)
        kv_len = min(pos + 1, S)
        if rng.random() < 0.25:                  # a write-masked lane mid-admission
            kv_len = int(rng.integers(1, S + 1))
        if rng.random() < 0.1:
            kv_len = 1
        win = _win_arg(None if rng.random() < 0.3 else int(rng.integers(1, S + 1)), S, "test")
        att = _attended(S, kv_pos, kv_len, kv_sink, win)
        live = [lane_chunk_live(c, chunk, S, kv_pos, kv_len, kv_sink, win)
                for c in range(nsplit)]
        assert any(live), (S, kv_pos, kv_len, kv_sink, win)
        for c, lv in enumerate(live):
            c0, c1 = c * chunk, min((c + 1) * chunk, kv_len)
            assert lv or not bool(att[c0:max(c0, c1)].any()), (S, kv_pos, kv_len, kv_sink, win, c)
            if not (win and kv_sink <= kv_pos < kv_len):
                assert lv == (c0 < kv_len)


def test_ring_window_lane_reads_few_chunks():
    """Gemma2's sliding layer (window 4096 of an 8192-slot ring, 16 chunks
    of 512) reads 9 chunks of a ring lane, 16 without the window; a
    1-slot lane reads one."""
    S, win = 8192, 4096
    chunk, nsplit = lanes_split_plan(S, 8)
    kv_pos = 2 + (12000 - 2) % (S - 2)
    live = [lane_chunk_live(c, chunk, S, kv_pos, S, 2, win) for c in range(nsplit)]
    assert sum(live) == 9
    assert sum(lane_chunk_live(c, chunk, S, kv_pos, S, 2, 0) for c in range(nsplit)) == 16
    assert [lane_chunk_live(c, chunk, S, 0, 1, 0, win) for c in range(nsplit)] == \
        [True] + [False] * 15


def test_one_chunk_combine_is_the_chunks_own():
    """A lane whose kv_len fits one chunk is finished by its pass-1 block
    with that chunk's m_c and l_c: pass 2's combine of one chunk (m = max
    m_c, l = l_c exp(m_c - m) added to 0, the other lanes of the warp adding
    -inf and 0) gives them back bit for bit, for any m_c and l_c."""
    rng = np.random.default_rng(1)
    m_c = torch.from_numpy(rng.standard_normal(1000, np.float32) * 30)
    l_c = torch.from_numpy(rng.uniform(1, 4096, 1000).astype(np.float32))
    m = torch.maximum(m_c, torch.full_like(m_c, -torch.inf))
    l = torch.zeros_like(l_c) + l_c * torch.exp(m_c - m) + torch.zeros_like(l_c)
    assert torch.equal(m, m_c) and torch.equal(l, l_c)


def lane_two_pass(q2, k, v, kv_len, chunk, live, softcap, extra):
    """One lane's head-batched two passes in plain torch: q2 (Hk * P, D)
    pre-scaled, k (S, Hk, D) the lane's view (f32, sinks rounded), v (S,
    Hk, D); pass 1, each live chunk's max m_c and sum l_c, a dead chunk's
    -inf and 0; pass 2, m = max m_c and l = sum l_c exp(m_c - m) in chunk
    order, p = bf16(exp(s - m) / l), each live chunk's partial sum of p .
    v, the partials summed in chunk order (a dead chunk's partial is 0)."""
    S, Hk, D = k.shape
    P = q2.shape[0] // Hk
    scores = torch.einsum("gpd,sgd->gps", bf16f(q2.float()).reshape(Hk, P, D), bf16f(k.float()))
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    valid = torch.arange(S) < kv_len
    if extra is not None:
        valid = valid & extra
    scores = torch.where(valid[None, None], scores, torch.full_like(scores, NEG_INF))
    ms, ls = [], []
    for c, lv in enumerate(live):
        c0, c1 = c * chunk, min((c + 1) * chunk, kv_len)
        if not lv:
            ms.append(torch.full((Hk, P), -torch.inf))
            ls.append(torch.zeros(Hk, P))
            continue
        m_c = scores[..., c0:c1].amax(-1)
        ms.append(m_c)
        ls.append(torch.exp(scores[..., c0:c1] - m_c[..., None]).sum(-1))
    m = torch.stack(ms).amax(0)
    l = torch.zeros(Hk, P)
    for m_c, l_c in zip(ms, ls):
        l = l + l_c * torch.exp(m_c - m)
    out = torch.zeros(Hk, P, D)
    for c, lv in enumerate(live):
        if lv:
            c0, c1 = c * chunk, min((c + 1) * chunk, kv_len)
            p = bf16f(torch.exp(scores[..., c0:c1] - m[..., None]) / l[..., None])
            out = out + torch.einsum("gps,sgd->gpd", p, bf16f(v[c0:c1].float()))
    return out


def lanes_emulation(q, k_new, v_new, k_lanes, v_lanes, layer, lanes, *, kv_sinks, theta,
                    rotary_dim, softcap=0.0, win=None, alt=None, write_back=None):
    """csrc/attention.cu's lanes split in plain torch over B lanes' views
    (B, L, S, Hk, D), mutated in place: per lane, the block holding kv_pos
    writes the new rows (write != 0), then lane_two_pass over the chunks of
    lanes_split_plan(S, Hk) that lane_chunk_live reads. write_back(b,
    kv_pos) is called after a lane's write (the paged form's row copy).
    Returns (B, Hk, qpk, D) f32."""
    Bn, L, S, Hk, D = k_lanes.shape
    qpk = q.shape[2]
    chunk, nsplit = lanes_split_plan(S, Hk)
    w = _win_arg(win, S, "emulation")
    out = torch.empty(q.shape, dtype=torch.float32)
    for b, (kp, kl, ks, p, wr) in enumerate(lanes.T.tolist()):
        if wr:
            k_row = _rot(k_new[b].float(), theta, rotary_dim, p, alt)
            k_lanes[b, layer, kp] = k_row.to(k_lanes.dtype)
            v_lanes[b, layer, kp] = v_new[b].float().to(v_lanes.dtype)
            if write_back:
                write_back(b, kp)
        q2 = _rot(q[b].float().reshape(Hk * qpk, D), theta, rotary_dim, p, alt)
        q2 = q2 * (1.0 / math.sqrt(D))
        k = sink_view(k_lanes[b, layer], ks, p, theta=theta, rotary_dim=rotary_dim, alt=alt)
        extra = None if win is None else slot_age(S, kp, ks, "cpu") < win
        live = [lane_chunk_live(c, chunk, S, kp, kl, ks, w) for c in range(nsplit)]
        out[b] = lane_two_pass(q2, k, v_lanes[b, layer], kl, chunk, live, softcap, extra)
    return out


# (softcap, win, alt): none (sinks in the ring lanes), Gemma2's cap, a
# sliding window, all three with Gemma3's local rope
FORMS = {"plain": (0.0, None, None), "softcap": (50.0, None, None), "win": (0.0, 100, None),
         "all": (50.0, 70, 1)}
S_EMU, PAGE = 320, 16


def _lanes(S):
    """5 lanes: kv_len 1, linear past the window, the whole window, a ring
    lane with sinks whose window wraps, a write-masked ring lane."""
    pos = [0, S - 7, S - 1, 2 * S + 13, S + 150]
    sink = [2 if p >= S else 0 for p in pos]
    kv_pos = [s + (p - s) % (S - s) for p, s in zip(pos, sink)]
    return kv_pos, [min(p + 1, S) for p in pos], sink, pos, [1, 1, 1, 1, 0]


def _inputs(rng, kv, B=5, L=2, Hk=2, qpk=2, D=64, S=S_EMU):
    jdt, tdt = KV[kv]
    f = lambda *s, sc=1.0: rng.standard_normal(s, np.float32) * sc  # noqa: E731
    q, kn, vn = f(B, Hk, qpk, D, sc=3.0), f(B, Hk, D, sc=2.0), f(B, Hk, D)
    k0 = np.asarray(jnp.asarray(f(B, L, S, Hk, D, sc=2.0), jdt))
    v0 = np.asarray(jnp.asarray(f(B, L, S, Hk, D), jdt))
    return q, kn, vn, k0, v0


def _torch_cache(a, kv):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(KV[kv][1])


def _close(got, want):
    want = torch.as_tensor(np.asarray(want))
    err = float((got - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), err


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("form", list(FORMS))
def test_lanes_emulation_matches_batched_plain_and_jax(kv, form):
    """K8's two passes over 5 lanes on a window of 5 chunks of 64 (2 kv
    heads): within 2e-3 of the port's attend_step_batched_plain and of JAX's
    attend_step_batched_l; the written rows byte for byte as the plain
    version's, the write-masked lane's cache untouched."""
    softcap, win, alt = FORMS[form]
    rng = np.random.default_rng(len(form) + 7 * len(kv))
    q, kn, vn, k0, v0 = _inputs(rng, kv)
    scal = _lanes(S_EMU)
    theta = GEMMA3_ROPE if alt else 1e4
    rope = dict(kv_sinks=2, theta=theta, rotary_dim=64, softcap=softcap, win=win, alt=alt)
    lanes = lane_scalars(*scal, S=S_EMU, kv_sinks=2, device="cpu")
    assert lanes_split_plan(S_EMU, 2) == (64, 5)
    tq, tkn, tvn = (torch.from_numpy(a) for a in (q, kn, vn))
    ek, ev = _torch_cache(k0, kv), _torch_cache(v0, kv)
    got = lanes_emulation(tq, tkn, tvn, ek, ev, 1, lanes, **rope)
    pk, pv = _torch_cache(k0, kv), _torch_cache(v0, kv)
    _close(got, attend_step_batched_plain(tq, tkn, tvn, pk, pv, 1, lanes, **rope))
    assert torch.equal(_bits(ek), _bits(pk)) and torch.equal(_bits(ev), _bits(pv))
    assert torch.equal(_bits(ek[4]), _bits(_torch_cache(k0, kv)[4]))
    want, _, _ = jax_batched(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k0),
                             jnp.asarray(v0), jnp.int32(1),
                             *[jnp.asarray(s, jnp.int32) for s in scal],
                             None if win is None else jnp.int32(win),
                             None if alt is None else jnp.int32(alt), kv_sinks=2, theta=theta,
                             rotary_dim=64, softcap=softcap)
    _close(got, want)


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("form", ["plain", "all"])
def test_lanes_emulation_matches_paged_plain_and_jax(kv, form):
    """K9's two passes over 5 lanes through shuffled pages of 16 slots:
    the emulation on each lane's gathered view, its new row copied back to
    its page, within 2e-3 of attend_step_paged_plain and of JAX's
    attend_step_paged_l; the pool byte for byte as the plain version's."""
    softcap, win, alt = FORMS[form]
    rng = np.random.default_rng(3 + len(form) + len(kv))
    jdt, tdt = KV[kv]
    B, L, Hk, D, nblk = 5, 2, 2, 64, S_EMU // PAGE
    q, kn, vn, _, _ = _inputs(rng, kv, B=B, S=S_EMU)
    n_pages = 1 + B * nblk
    tables = (rng.permutation(B * nblk) + 1).reshape(B, nblk).astype(np.int32)
    shape = (n_pages, L, PAGE, Hk, D)
    k0 = np.asarray(jnp.asarray(rng.standard_normal(shape, np.float32) * 2, jdt))
    v0 = np.asarray(jnp.asarray(rng.standard_normal(shape, np.float32), jdt))
    scal = _lanes(S_EMU)
    theta = GEMMA3_ROPE if alt else 1e4
    rope = dict(kv_sinks=2, theta=theta, rotary_dim=D, softcap=softcap, win=win, alt=alt)
    lanes = lane_scalars(*scal, S=S_EMU, kv_sinks=2, device="cpu")
    tab = torch.from_numpy(tables)
    tq, tkn, tvn = (torch.from_numpy(a) for a in (q, kn, vn))
    ek, ev = _torch_cache(k0, kv), _torch_cache(v0, kv)
    views = [torch.stack([torch.stack([gather_pages(pool[:, l], tab[b]) for l in range(L)])
                          for b in range(B)]) for pool in (ek, ev)]

    def write_back(b, kp):
        for pool, view in zip((ek, ev), views):
            _bits(pool[int(tab[b, kp // PAGE]), 1, kp % PAGE]).copy_(_bits(view[b, 1, kp]))
    got = lanes_emulation(tq, tkn, tvn, *views, 1, lanes, write_back=write_back, **rope)
    pk, pv = _torch_cache(k0, kv), _torch_cache(v0, kv)
    _close(got, attend_step_paged_plain(tq, tkn, tvn, pk, pv, tab, 1, lanes, **rope))
    assert torch.equal(_bits(ek), _bits(pk)) and torch.equal(_bits(ev), _bits(pv))
    want, _, _ = jax_paged(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k0),
                           jnp.asarray(v0), jnp.asarray(tables), jnp.int32(1),
                           *[jnp.asarray(s, jnp.int32) for s in scal],
                           None if win is None else jnp.int32(win),
                           None if alt is None else jnp.int32(alt), kv_sinks=2, theta=theta,
                           rotary_dim=D, window=S_EMU, softcap=softcap)
    _close(got, want)


def test_lane_alone_has_the_bits_it_has_among_sixteen():
    """The emulation of 16 lanes (kv_len 1 to the window, ring lanes, a
    sliding window and softcap) and of each lane alone give every lane the
    same bits: the plan and the chunks a lane reads depend on the window
    and on the lane alone."""
    rng = np.random.default_rng(16)
    B, S = 16, S_EMU
    q, kn, vn, k0, v0 = _inputs(rng, "bf16", B=B, S=S)
    pos = [0, 1, 63, 64, 65, 100, 199, 250, 300, 318, 319, S + 5, S + 100, 2 * S, S + 300, 50]
    sink = [2 if p >= S else 0 for p in pos]
    kv_pos = [s + (p - s) % (S - s) for p, s in zip(pos, sink)]
    kv_len = [min(p + 1, S) for p in pos]
    write = [1] * B
    write[7] = write[13] = 0
    lanes = lane_scalars(kv_pos, kv_len, sink, pos, write, S=S, kv_sinks=2, device="cpu")
    rope = dict(kv_sinks=2, theta=1e4, rotary_dim=64, softcap=50.0, win=90)
    tq, tkn, tvn = (torch.from_numpy(a) for a in (q, kn, vn))
    batch = lanes_emulation(tq, tkn, tvn, _torch_cache(k0, "bf16"), _torch_cache(v0, "bf16"), 1,
                            lanes, **rope)
    for b in range(B):
        one = slice(b, b + 1)
        alone = lanes_emulation(tq[one], tkn[one], tvn[one], _torch_cache(k0[one], "bf16"),
                                _torch_cache(v0[one], "bf16"), 1, lanes[:, one], **rope)
        assert torch.equal(alone[0], batch[b]), b
