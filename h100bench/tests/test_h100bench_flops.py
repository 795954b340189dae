"""flops.py against PERF.md's per-token FLOPs and the kernel table's bounds
(H100 SXM peaks)."""

import pytest

from h100bench import flops, harness


def _cfg(name):
    return harness.load(harness.HERE / "configs" / f"{name}.json")


def test_mistral_token_is_14_2_gflop():
    cfg = _cfg("mistral7b-fp8")
    assert 2 * flops.matmul_params_per_token(cfg) / 1e9 == pytest.approx(14.22, abs=0.01)
    # attention over 1000 positions adds 4 * 1000 * 4096 per layer
    assert flops.token_flops(cfg, 1000) - flops.token_flops(cfg, 0) == 4 * 1000 * 4096 * 32


def test_mixtral_counts_routed_experts_only():
    cfg = _cfg("mixtral8x7b-fp8")
    routed = 2 * flops.matmul_params_per_token(cfg) / 1e9
    assert routed == pytest.approx(25.5, abs=0.1)           # 2 of 8 experts
    all_experts = routed + 2 * 32 * 6 * 3 * 4096 * 14336 / 1e9
    assert all_experts == pytest.approx(92.9, abs=0.3)      # PERF.md's masked sweep


def test_prompt_flops_sum_token_flops():
    cfg = _cfg("mistral7b-fp8")
    n = 37
    assert flops.prompt_flops(cfg, n) == pytest.approx(
        sum(flops.token_flops(cfg, i + 1) for i in range(n)))


def test_gemm_bounds_match_the_kernel_table():
    # B=256 w13 e5m2 28672x4096: 0.0608 ms (operations)
    b = flops.bound_s(*flops.gemm_counts(256, 28672, 4096, 1, glu=True))
    assert b * 1e3 == pytest.approx(0.0608, rel=0.01)
    # M=16 w2 e5m2 4096x14336: 0.0179 ms (bytes; the table counts x in f32)
    b = flops.bound_s(*flops.gemm_counts(16, 4096, 14336, 1))
    assert b * 1e3 == pytest.approx(0.0179, rel=0.02)


def test_attention_bound_matches_the_kernel_table():
    # K8, B=16, kv_len 1..4096 (chip_smoke.batched_lanes), bf16: 0.0379 ms
    pos = [0, 1, 63, 64, 199, 511, 998, 1499, 2047, 2600, 3071, 3500, 3999, 4094, 4095, 5999]
    kv = [min(p + 1, 4096) for p in pos]
    b = flops.bound_s(*flops.attn_counts(kv, 32, 8, 128, 2))
    assert b * 1e3 == pytest.approx(0.0379, rel=0.01)
