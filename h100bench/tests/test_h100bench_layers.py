"""The per-layer arithmetic on a synthetic run: rows swept, the window's
model FLOPs, and the profiled slice's busy time, idle share, rooflines and
idle gaps by host phase."""

import types

import pytest

from h100bench import flops, harness, layers
from h100bench.device import Slice


class _Ev:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _run(**tracer):
    cfg = harness.load(harness.HERE / "configs" / "mistral7b-fp8.json")
    run = harness.Run(cfg, {}, {}, 10.0, 0.0)
    run.w0, run.w1 = 1.0, 11.0
    base = dict(chunks=[], ticks=[], admits=[], moe=[], gemms=[], lanes=[],
                slice_s=(9.0, 11.0))
    base.update(tracer)
    run.tracer = types.SimpleNamespace(**base)
    run.tracer.outside_slice = lambda t: not (9.0 <= t < 11.0)
    return run


def test_rows_swept_and_hydrated():
    run = _run(chunks=[(0.5, 4096, [(0, 256)]), (2.0, 8192, [(1, 256), (1, 100)]),
                       (3.0, 256, [(256, 50)])])
    assert layers.sweep_row_use(run) == pytest.approx(100 * 406 / 8448)


def test_spans_outside_the_slice():
    run = _run(ticks=[(2.0, 2.03), (3.0, 3.05), (9.5, 9.9)],
               admits=[(2.0, _Ev(0), _Ev(0.2)), (10.0, _Ev(0), _Ev(5.0))],
               moe=[(2.0, _Ev(0), _Ev(0.01)), (3.0, _Ev(0), _Ev(0.03))])
    assert layers.tick_ms(run) == pytest.approx(40.0)
    assert layers.admit_ms(run) == pytest.approx(200.0)
    assert layers.moe_ffn_ms_per_tick(run) == pytest.approx(20.0)


def test_window_flops():
    rec = types.SimpleNamespace(spec=types.SimpleNamespace(prompt=[1] * 100),
                                times=[0.5, 1.5, 2.5, 12.0])
    run = _run(chunks=[(2.0, 256, [(0, 100)])])
    run.records = [rec]
    want = (flops.prompt_flops(run.cfg, 100) + flops.token_flops(run.cfg, 101)
            + flops.token_flops(run.cfg, 102))
    assert layers.mfu_window(run) == pytest.approx(100 * want / (10.0 * flops.PEAK_BF16_FLOPS))


def test_slice_busy_idle_and_rooflines():
    ms = 1_000_000
    ev = [("void gemm_kernel<1>(...)", 0, 2 * ms), ("round_rows_kernel", 2 * ms, 3 * ms),
          ("lanes_scores_kernel", 5 * ms, 7 * ms), ("lanes_values_kernel", 6 * ms, 8 * ms)]
    phases = [("step", 0, 10 * ms), ("tick", 1 * ms, 8 * ms + ms // 2), ("sample.read", 3 * ms, 5 * ms)]
    # correlation ids 1-4, launched on the host at 10, 5, 40 and 41 us
    sl = Slice(ev * 1, 0, 10 * ms, phases, [1, 2, 3, 4], {1: 10_000, 2: 5_000, 3: 40_000,
                                                          4: 41_000})
    assert sl.busy_s() == pytest.approx(6e-3)
    assert sl.window_s == pytest.approx(10e-3)
    assert dict(sl.idle_by_phase()) == pytest.approx({"sample.read": 2e-3, "step": 2e-3})

    run = _run(gemms=[(8_000, 12_000, (256, 28672, 4096, 28672 * 4096, True, False))],
               lanes=[(30_000, [1000, 3000])])
    run.cfg = dict(run.cfg, num_hidden_layers=1)
    run.slice = sl
    b = flops.bound_s(*flops.gemm_counts(256, 28672, 4096, 1, glu=True))
    assert layers.gemm_roofline(run) == pytest.approx(100 * b / 2e-3)
    a = flops.bound_s(*flops.attn_counts([1000, 3000], 32, 8, 128, 2))
    assert layers.attn_roofline(run) == pytest.approx(100 * a / 3e-3)
    assert layers.idle_share(run) == pytest.approx(40.0)


def test_a_kernel_the_trace_lost_counts_on_neither_side():
    ms = 1_000_000
    shape = (16, 4096, 4096, 4096 * 4096, False, True)
    # three launches; the trace holds the kernels of the first and the third
    run = _run(gemms=[(0, 100, shape), (200, 300, shape), (400, 500, shape)],
               lanes=[(1_000, [100]), (2_000, [200])])
    run.cfg = dict(run.cfg, num_hidden_layers=1)
    ev = [("gemm_kernel<2>", 0, 1 * ms), ("gemm_kernel<2>", 2 * ms, 5 * ms),
          ("lanes_scores_kernel", 6 * ms, 7 * ms), ("lanes_values_kernel", 7 * ms, 8 * ms),
          ("lanes_scores_kernel", 8 * ms, 9 * ms)]
    run.slice = Slice(ev, 0, 10 * ms, [], [1, 2, 3, 4, 5],
                      {1: 50, 2: 450, 3: 1_100, 4: 1_200, 5: 2_100})
    b = flops.bound_s(*flops.gemm_counts(16, 4096, 4096, 1, residual=True))
    assert layers.gemm_roofline(run) == pytest.approx(100 * 2 * b / 4e-3)
    # the second tick lost one of its two kernels: only the first counts
    a = flops.bound_s(*flops.attn_counts([100], 32, 8, 128, 2))
    assert layers.attn_roofline(run) == pytest.approx(100 * a / 2e-3)
    # a kernel whose launch the trace does not hold is tied to no call
    run.slice.launched = {}
    assert layers.gemm_roofline(run) is None


def test_gap_tail_leaves_out_the_slice_and_the_edges():
    run = _run()
    run.records = [types.SimpleNamespace(times=[0.9, 1.0 + 0.01 * i, 9.5, 9.6])
                   for i in range(1, 101)]
    run.records.append(types.SimpleNamespace(times=[2.0 + 0.05 * i for i in range(100)]))
    itl = harness.reader("itl_p99_ms.chat")
    # the first 100 requests' gaps start before the window or touch the slice
    # [9, 11); only the last request's 99 gaps of 50 ms count
    assert itl(run) == pytest.approx(50.0)
