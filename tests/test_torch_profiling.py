"""The port's utils/profiling.py: ``trace`` writes a Chrome trace of what
ran inside, ``device_memory_stats`` is ``{}`` without a CUDA device (per
device MB in use and at peak with one); the span recorder keeps nested
spans with their parents, names an explicit parent across threads, keeps
each thread's records apart in a ring that keeps the newest and counts
the overwritten, records nothing while off (one shared no-op context),
marks its spans as profiler ranges while on, and ``count`` keeps a
record of each increment while on, and nothing while off."""

import json
import os
import threading

import pytest
import torch

from image_captioning_ml_project_tpu_torch.utils import profiling
from image_captioning_ml_project_tpu_torch.utils.profiling import (
    count, device_memory_stats, span, trace)


@pytest.fixture
def recorder():
    """The recorder on, drained before and after; off afterwards."""
    profiling.records()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.records()


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "tr")
    with trace(log_dir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())


def test_device_memory_stats_without_a_card():
    out = device_memory_stats()
    if not torch.cuda.is_available():
        assert out == {}
    for v in out.values():
        assert set(v) == {"bytes_in_use_mb", "peak_bytes_mb"}


def test_spans_nest_and_name_their_parents(recorder):
    with span("t.outer", rows=3) as outer:
        with span("t.inner") as inner:
            pass
        with span("t.second") as second:
            second.attrs["bucket"] = 4
    recs = {r.name: r for r in recorder.records()}
    assert set(recs) == {"t.outer", "t.inner", "t.second"}
    o, i, s = recs["t.outer"], recs["t.inner"], recs["t.second"]
    assert (o.id, i.id, s.id) == (outer.id, inner.id, second.id)
    assert o.parent == 0 and i.parent == o.id and s.parent == o.id
    assert o.attrs == {"rows": 3} and s.attrs == {"bucket": 4}
    assert o.start_ns <= i.start_ns <= i.end_ns <= s.start_ns \
        <= s.end_ns <= o.end_ns
    assert o.thread == threading.get_native_id()
    assert 0 <= i.enter_ns <= i.end_ns - i.start_ns
    assert recorder.records() == []      # drained


def test_an_explicit_parent_crosses_threads(recorder):
    done = threading.Event()

    def completer(parent):
        with span("t.handed", parent):
            with span("t.child"):
                pass
        with span("t.own"):
            pass
        done.set()

    with span("t.batch") as batch:
        t = threading.Thread(target=completer, args=(batch.id,))
        t.start()
        assert done.wait(30)
    t.join(timeout=30)
    assert not t.is_alive()
    recs = {r.name: r for r in recorder.records()}
    assert recs["t.handed"].parent == batch.id
    assert recs["t.child"].parent == recs["t.handed"].id
    assert recs["t.own"].parent == 0   # the batch is open on another thread
    assert recs["t.handed"].thread != recs["t.batch"].thread


def test_each_thread_keeps_its_own_ring(recorder):
    go = threading.Barrier(4)

    def work(k):
        go.wait(timeout=30)
        for _ in range(50):
            with span(f"t.w{k}"):
                with span(f"t.w{k}.in"):
                    pass

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    recs = recorder.records()
    by_id = {r.id: r for r in recs}
    assert len(recs) == 4 * 100 and len(by_id) == len(recs)
    for r in recs:
        if r.name.endswith(".in"):
            parent = by_id[r.parent]
            assert parent.name == r.name[:-3] and parent.thread == r.thread
    assert len({r.thread for r in recs}) == 4
    assert [r.start_ns for r in recs] == sorted(r.start_ns for r in recs)


def test_the_ring_keeps_the_newest_and_counts_the_overwritten(
        recorder, monkeypatch):
    # a thread's ring is made at its first record: a fresh thread's
    monkeypatch.setattr(recorder, "RING", 4)
    before = recorder.overwritten()

    def work():
        for k in range(10):
            with span(f"t.s{k}"):
                pass

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert [r.name for r in recorder.records()] == [
        "t.s6", "t.s7", "t.s8", "t.s9"]
    assert recorder.overwritten() - before == 6


def test_a_disabled_span_records_nothing(recorder):
    recorder.disable()
    assert not recorder.enabled()
    a, b = span("t.off"), span("t.off2", parent=5, rows=1)
    assert a is b
    with a as s:
        assert s.id is None and s.attrs is None
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with span("t.off3"):
            torch.ones(4).sum()
    assert recorder.records() == []
    assert not any(e.key == "t.off3" for e in prof.key_averages())


def test_enabled_spans_are_profiler_ranges(recorder, tmp_path):
    log_dir = str(tmp_path / "tr")
    with trace(log_dir):
        with span("t.range"):
            torch.ones(8).sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert [e["cat"] for e in events if e.get("name") == "t.range"] == [
        "user_annotation"]
    assert [r.name for r in recorder.records()] == ["t.range"]


def test_count_is_cumulative_and_recorded_while_on(recorder):
    recorder.disable()
    count("t.count")
    count("t.count", 3)
    assert recorder.records() == []
    recorder.enable()
    with span("t.around") as around:
        count("t.count", 2)
    count("t.count", 5)
    recs = [r for r in recorder.records() if r.name == "t.count"]
    assert [r.attrs for r in recs] == [{"n": 2}, {"n": 5}]
    assert sum(r.attrs["n"] for r in recs) == 7
    assert all(r.start_ns == r.end_ns for r in recs)
    assert [r.parent for r in recs] == [around.id, 0]
