"""The traffic generator: the same seed gives the same requests, and every
seed offers the same multiset of sizes, in another order."""

from collections import Counter

from h100bench import harness
from h100bench.traffic import block_specs, order, quantile, stratified
from h100bench.traffic.closed import staggered

SEEDS = (1, 2**31 + 7, 3_000_000_019)


def _mix(name):
    return harness.load(harness.HERE / "traffic" / f"{name}.json")


def test_block_specs_repeat_for_a_seed():
    mix = _mix("sharegpt")
    for seed in SEEDS:
        a = block_specs(mix, seed, 3, 32, 32000, 1)
        b = block_specs(mix, seed, 3, 32, 32000, 1)
        assert a == b


def test_seeds_change_order_not_sizes():
    mix = _mix("sharegpt")
    runs = [block_specs(mix, s, 0, 32, 32000, 1) for s in SEEDS]
    sizes = [Counter((len(x.prompt), x.max_new_tokens > 0) for x in r) for r in runs]
    outs = [sorted(x.max_new_tokens for x in r) for r in runs]
    greedy = [sum(x.greedy for x in r) for r in runs]
    assert sizes[0] == sizes[1] == sizes[2]
    assert outs[0] == outs[1] == outs[2]
    assert greedy == [16, 16, 16]
    assert [x.prompt for x in runs[0]] != [x.prompt for x in runs[1]]


def test_lengths_follow_the_mix():
    mix = dict(kind="closed", clients=64, reorder_span=2,
               prompt_tokens=dict(dist="lognormal", median=1024, sigma=0.5, min=256, max=3584),
               output_tokens=dict(dist="uniform", min=16, max=64), greedy_share=0.5,
               sampled=dict(temperature=0.8, top_p=0.9, top_k=40))
    specs = block_specs(mix, 5, 0, 64, 32000, 1)
    plens = sorted(len(s.prompt) for s in specs)
    assert plens[0] >= 256 and plens[-1] <= 3584
    assert abs(plens[31] - 1024) < 40          # the median
    assert all(16 <= s.max_new_tokens <= 64 for s in specs)
    assert all(s.prompt[0] == 1 and all(3 <= t < 32000 for t in s.prompt[1:]) for s in specs)
    sampled = [s for s in specs if not s.greedy]
    assert sampled and all((s.temperature, s.top_p, s.top_k) == (0.8, 0.9, 40) for s in sampled)


def test_quantiles():
    uni = dict(dist="uniform", min=16, max=64)
    vals = [quantile(uni, u) for u in stratified(49)]
    assert vals == list(range(16, 65))
    logn = dict(dist="lognormal", median=384, sigma=0.6, min=64, max=1536)
    assert quantile(logn, 0.5) == 384
    assert quantile(logn, 1e-9) == 64 and quantile(logn, 1 - 1e-12) == 1536


def test_first_requests_are_cut_to_stratified_shares():
    mix = _mix("sharegpt")
    n = 64
    full = block_specs(mix, 7, 0, n, 32000, 1)
    cut = staggered(block_specs(mix, 7, 0, n, 32000, 1), 7, 2)
    assert [x.prompt for x in cut] == [x.prompt for x in full]
    assert all(1 <= c.max_new_tokens <= f.max_new_tokens for c, f in zip(cut, full))
    shares = [c.max_new_tokens / f.max_new_tokens for c, f in zip(cut, full)]
    assert abs(sum(shares) / n - 0.5) < 0.02
    # ends spread: no quarter of the shares holds more than a third of them
    assert all(sum(q / 4 <= x < (q + 1) / 4 for x in shares) <= n / 3 for q in range(4))
    again = staggered(block_specs(mix, 7, 0, n, 32000, 1), 7, 2)
    assert [x.max_new_tokens for x in again] == [x.max_new_tokens for x in cut]


def test_the_sample_takes_the_longest_whole_and_many_clients():
    from h100bench.reference.judge import choose
    served = [(c % 40, 50 + (7 * c) % 900) for c in range(120)]   # (client, served tokens)
    picked = choose(served, 2**31 + 3, 1536, 12, 64)
    longest = max(range(120), key=lambda i: served[i][1])
    assert picked[0] == (longest, served[longest][1])
    assert all(k == min(64, served[i][1]) for i, k in picked[1:])
    assert len({served[i][0] for i, _ in picked}) == len(picked) >= 12
    assert sum(k for _, k in picked) >= 1536 or len(picked) == 40
    assert picked == choose(served, 2**31 + 3, 1536, 12, 64)
    assert picked != choose(served, 2**31 + 4, 1536, 12, 64)


def test_seeds_reorder_only_among_neighbours():
    a, b = order(64, 3, 1, 4, 1), order(64, 3, 2**31 + 7, 4, 1)
    assert sorted(a) == list(range(64)) and not (a == b).all()
    for g in range(0, 64, 4):
        assert sorted(a[g:g + 4]) == sorted(b[g:g + 4])
