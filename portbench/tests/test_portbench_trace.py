"""Busy and idle shares, launches inside a range, and named idle gaps from
a synthetic trace."""

import pytest

from portbench import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def timeline():
    # window 0..1000 us; host ranges on thread 1; kernels on stream 7
    return [
        ev("user_annotation", trace.WINDOW, 0, 1000),
        ev("user_annotation", "model_step", 100, 300),
        ev("user_annotation", "beam_decode_stack", 120, 50),
        ev("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 140, 5, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 300, 5, corr=3),
        ev("kernel", "gemm", 150, 100, tid=7, corr=1),
        ev("kernel", "attn", 200, 100, tid=7, corr=2),     # overlaps gemm
        ev("kernel", "lm_head", 600, 100, tid=7, corr=3),
        ev("gpu_memcpy", "HtoD", 950, 100, tid=8),         # clipped at 1000
        ev("kernel", "before", -50, 30, tid=7),            # outside
    ]


def test_busy_is_the_union_of_device_intervals():
    t = trace.read(timeline())
    # 150..300 (gemm and attn overlap), 600..700, 950..1000
    assert t["busy_s"] == pytest.approx((150 + 100 + 50) / 1e6)
    assert t["trace_window_s"] == pytest.approx(1000 / 1e6)
    assert t["kernels"] == 3
    idle = 100.0 * (1 - t["busy_s"] / t["trace_window_s"])
    assert idle == pytest.approx(70.0)


def test_device_time_launched_inside_a_range():
    events = timeline()
    # gemm and attn were launched inside beam_decode_stack; lm_head not
    assert trace.device_time_in(events, "beam_decode_stack", 0, 1000) == \
        pytest.approx(200 / 1e6)
    assert trace.device_time_in(events, "model_step", 0, 1000) == \
        pytest.approx(300 / 1e6)
    assert trace.device_time_in(events, "absent", 0, 1000) == 0.0


def test_idle_gaps_named_by_the_innermost_range():
    t = trace.read(timeline())
    gaps = t["idle_by_range"]
    # gaps 0..150 and 700..950 begin outside every range; 300..600
    # begins inside model_step (100..400)
    assert gaps["outside_the_harness_ranges"] == pytest.approx(
        (150 + 250) / 1e6)
    assert gaps["model_step"] == pytest.approx(300 / 1e6)
    b = trace.breakdown(t)
    assert b["device_ops"][0][0] in ("gemm", "attn", "lm_head")
    assert len(b["idle_gaps"]) <= 10
