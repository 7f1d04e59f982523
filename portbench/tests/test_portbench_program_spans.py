"""The program's spans on the trace's clock (``program_spans``) and the
metrics that read them: under a CPU ``torch.profiler`` the recorder's
spans are the trace's ranges and the two clocks align within 1 ms, spans
of an unprofiled thread landing inside the window; each new reader's
value from a synthetic span list and trace; the gaps named by the
program's ranges with ``trace.read`` as it is; each value taken over the
window before the profiler started, the traced window's logged beside
it; the new entries of ``BENCHMARK.json``, found by name; and nothing
read, nothing raised, against a program without the recorder."""

import json
import os
import threading
import time

import pytest

from conftest import ROOT
from portbench import program_spans, run, trace
from portbench.loadgen import percentile

NEW = {
    "serve.queue_wait_p95_ms.poisson": ("ms", "program_span", "batcher",
                                        "serve_p95_ms",
                                        "flagship-serve-poisson"),
    "serve.between_batches_ms": ("ms/batch", "program_span", "batcher",
                                 "serve_images_per_s",
                                 "flagship-serve-saturated"),
    "serve.between_batches_ms.transformer": (
        "ms/batch", "program_span", "batcher",
        "serve_images_per_s.transformer", "transformer-serve-saturated"),
    "decode.enqueue_ms_per_step": ("ms/step", "program_span",
                                   "decode engine", "serve_images_per_s",
                                   "flagship-serve-saturated"),
    "decode.enqueue_ms_per_step.transformer": (
        "ms/step", "program_span", "decode engine",
        "serve_images_per_s.transformer", "transformer-serve-saturated"),
    "decode.host_syncs_per_step": ("syncs/step", "program_counter",
                                   "decode engine", "serve_images_per_s",
                                   "flagship-serve-saturated"),
    "train.host_ms_per_step": ("ms/step", "program_span", "trainer",
                               "train_images_per_s", "flagship-train-ce"),
    "serve.completer_ms_per_batch": ("ms/batch", "program_span",
                                     "completer", "serve_images_per_s",
                                     "flagship-serve-saturated"),
    "data.upload_ms_per_step": ("ms/step", "program_span", "data",
                                "train_images_per_s", "flagship-train-ce"),
}


@pytest.fixture
def profiling():
    from image_captioning_ml_project_tpu_torch.utils import profiling

    was = profiling.enabled()
    profiling.records()
    profiling.enable()
    try:
        yield profiling
    finally:
        if not was:
            profiling.disable()
        profiling.records()


def test_spans_align_with_a_cpu_trace(profiling):
    import torch

    from image_captioning_ml_project_tpu_torch.utils.profiling import span

    stop = threading.Event()

    def side():
        while not stop.is_set():
            with span("side.work"):
                time.sleep(0.002)

    prof = trace.Profile()
    prof.start()
    t = threading.Thread(target=side)
    t.start()
    for _ in range(40):
        with span("main.step"):
            with span("main.inner"):
                torch.ones(256, 256).sum()
            time.sleep(0.001)
    stop.set()
    t.join(timeout=30)
    assert not t.is_alive()
    events, _ = prof.stop()
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation"]
    assert names.count("main.step") == 40 and "side.work" not in names
    ctx = {"events": events, "trace": trace.read(events)}
    got = program_spans.collect(ctx)
    assert got is program_spans.collect(ctx)      # drained once, kept
    assert got["pairs"] >= 1 and got["ranges"] == 80
    assert got["residual_us"] < 1000.0
    lo, hi = ctx["trace"]["lo"], ctx["trace"]["hi"]
    side_spans = [s for s in got["spans"] if s.name == "side.work"]
    assert side_spans and all(lo <= s.ts < hi for s in side_spans)
    ranges = [e["ts"] for e in events if e.get("name") == "main.step"]
    placed = [s for s in got["spans"] if s.name == "main.step"]
    assert len(placed) == 40
    # a span whose entry into its range waited for the interpreter lock
    # starts that much before its range
    near = [s for s in placed if min(abs(s.ts - ts) for ts in ranges) < 1e3]
    assert len(near) >= 0.9 * len(placed)


# -- a synthetic serving run: the recorder's records, the trace's ranges --

OFF = 5_000_000_000          # trace us x 1000 = monotonic ns + OFF
WINDOW = (100.0, 400.0)      # monotonic ms
BATCHER, COMPLETER = 11, 12


class _Recs:
    def __init__(self):
        from image_captioning_ml_project_tpu_torch.utils.profiling import \
            Record

        self.Record, self.out, self.next = Record, [], 1

    def add(self, name, a, b, parent=0, thread=BATCHER, **attrs):
        rid = self.next
        self.next += 1
        self.out.append(self.Record(name, int(a * 1e6), int(b * 1e6), thread,
                                    rid, parent, attrs, 1000))
        return rid


def _serving():
    """Batch b of 99 ms from 100 b ms: wait 0.5 ms, fill 10 + b ms (from
    1 ms in), stack 2, upload 3, decode 70 (encode 5, then 8 steps of 8
    ms each ending in a 3-ms stop check and its sync), handoff 13 - b;
    then a wait that timed out; the completer's fetch and detokenize
    after the handoff. Row k of a batch was enqueued 20 + 5 k ms before
    its decode."""
    r = _Recs()
    for b in range(5):
        t0 = b * 100.0
        dec = t0 + 16 + b
        batch = r.add("serve.batch", t0, t0 + 99, rows=3, bucket=4,
                      t_enqueue=[(dec - 20 - 5 * k) / 1e3 for k in range(3)])
        r.add("serve.wait", t0 + 0.5, t0 + 1, batch)
        r.add("serve.fill", t0 + 1, t0 + 11 + b, batch)
        r.add("serve.stack", t0 + 11 + b, t0 + 13 + b, batch)
        r.add("serve.upload", t0 + 13 + b, dec, batch)
        d = r.add("serve.decode", dec, dec + 70, batch)
        r.add("decode.encode", dec + 1, dec + 6, d)
        for k in range(8):
            a = dec + 6 + 8 * k
            step = r.add("decode.step", a, a + 8, d)
            check = r.add("decode.stop_check", a + 5, a + 8, step)
            r.add("decode.host_syncs", a + 6, a + 6, check, n=1)
        r.add("serve.handoff", dec + 70, t0 + 99, batch)
        # then a wait that timed out: a batch span with no rows
        r.add("serve.wait", t0 + 99.3, t0 + 99.7,
              r.add("serve.batch", t0 + 99.2, t0 + 99.8))
        r.add("serve.fetch_tokens", t0 + 100, t0 + 104, batch, COMPLETER)
        r.add("serve.detokenize", t0 + 104, t0 + 106, batch, COMPLETER)
    return r.out


def _trace_of(records, lo_ms, hi_ms, kernels=()):
    """The profiler's view: the window, and a range for each span of the
    batcher that began and ended inside it (on trace thread 7)."""
    us = lambda ns: (ns + OFF) / 1e3  # noqa: E731
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
               "ts": us(lo_ms * 1e6), "dur": (hi_ms - lo_ms) * 1e3,
               "tid": 7, "pid": 0}]
    for r in records:
        if (r.thread == BATCHER and r.end_ns > r.start_ns
                and lo_ms * 1e6 <= r.start_ns and r.end_ns <= hi_ms * 1e6):
            events.append({"ph": "X", "cat": "user_annotation",
                           "name": r.name, "ts": us(r.start_ns),
                           "dur": (r.end_ns - r.start_ns) / 1e3, "tid": 7,
                           "pid": 0})
    for a, b in kernels:
        events.append({"ph": "X", "cat": "kernel", "name": "k",
                       "ts": us(a * 1e6), "dur": (b - a) * 1e3, "tid": 70,
                       "pid": 0})
    return events


class _Counters:
    """The serving counters' marks: the window from 0 ms, the profiler
    from ``traced_ms`` (``time.perf_counter`` seconds, the records'
    clock)."""

    def __init__(self, steps, traced_ms=100.0):
        self.steps = steps
        self.marks = {"start": {"t": 0.0}, "trace_start":
                      {"t": traced_ms / 1e3}}

    def delta(self, a, b):
        assert (a, b) == ("trace_start", "trace_end")
        return {"decode_steps": self.steps}


class _Program:
    """A stand-in for the program's recorder holding given records."""

    def __init__(self, records):
        self._records = records

    def records(self):
        out, self._records = self._records, []
        return out

    def overwritten(self):
        return 0

    def enabled(self):
        return True


def _ctx(monkeypatch, records, kind="serve", steps=0, kernels=(),
         window=WINDOW, traced_ms=100.0):
    monkeypatch.setattr(program_spans, "_profiling",
                        lambda: _Program(list(records)))
    events = _trace_of(records, *window, kernels=kernels)
    return {"kind": kind, "events": events, "trace": trace.read(events),
            "counters": _Counters(steps, traced_ms)}


def test_synthetic_spans_are_placed_exactly(monkeypatch):
    ctx = _ctx(monkeypatch, _serving())
    got = program_spans.collect(ctx)
    assert got["offset_ns"] == OFF and got["residual_us"] == 0.0
    assert got["pairs"] == got["ranges"] > 0
    fetch = [s for s in got["spans"] if s.name == "serve.fetch_tokens"]
    # placed on the trace's clock: batches 0..2's, at 100, 200, 300 ms
    assert [round(s.ts - OFF / 1e3) for s in fetch] == [100000, 200000,
                                                        300000]


def test_between_batches(monkeypatch, capsys):
    ctx = _ctx(monkeypatch, _serving())
    # every batch: 10 + 2 + 3 + 13 ms (fill b ms longer, handoff b ms
    # shorter); the timed-out waits no batch. Before the profiler, in
    # [0, 100) ms: batch 0; logged beside it, the traced window's [100,
    # 400) ms: batches 1, 2 and 3
    assert run.reader("serve.between_batches_ms")(ctx) == pytest.approx(28.0)
    assert run.reader("serve.between_batches_ms.transformer")(ctx) == \
        pytest.approx(28.0)
    err = capsys.readouterr().err
    assert ("serve.between_batches_ms: (28.0, 1) before the profiler "
            "started (0.1 s), (28.0, 3) in the traced window") in err


def test_the_window_before_the_profiler(monkeypatch, capsys):
    ctx = _ctx(monkeypatch, _serving(), traced_ms=300.0)
    part = program_spans.untraced(ctx)
    assert (part["lo"], part["hi"]) == (OFF / 1e3, OFF / 1e3 + 300e3)
    assert part["seconds"] == pytest.approx(0.3)
    assert {s.name for s in part["spans"]} >= {"serve.batch",
                                               "serve.fetch_tokens"}
    assert all(part["lo"] <= s.ts < part["hi"] for s in part["spans"])
    # batches 0, 1 and 2 ended before 300 ms
    assert run.reader("decode.enqueue_ms_per_step")(ctx) == \
        pytest.approx(5.0)
    assert "(5.0, 24) before the profiler started" in capsys.readouterr().err
    # without the marks, the traced window's value
    del ctx["counters"].marks["trace_start"]
    assert program_spans.untraced(ctx) is None
    assert run.reader("serve.between_batches_ms")(ctx) == pytest.approx(28.0)
    assert "None before the profiler started (0.0 s), (28.0, 3)" in \
        capsys.readouterr().err


def test_completer_per_batch(monkeypatch):
    ctx = _ctx(monkeypatch, _serving())
    # batch 0's fetch (4 ms) and detokenize (2 ms), though they ran after
    # the profiler started
    assert run.reader("serve.completer_ms_per_batch")(ctx) == \
        pytest.approx(6.0)


def test_enqueue_per_step(monkeypatch):
    ctx = _ctx(monkeypatch, _serving())
    # every step: 8 ms less its 3-ms stop check
    assert run.reader("decode.enqueue_ms_per_step")(ctx) == \
        pytest.approx(5.0)


def test_host_syncs_per_step(monkeypatch):
    # batches 1, 2, 3 sync inside [100, 400) ms: 24 syncs over 24 steps;
    # the counters' marks say 32 steps ran
    ctx = _ctx(monkeypatch, _serving(), steps=24)
    assert run.reader("decode.host_syncs_per_step")(ctx) == \
        pytest.approx(1.0)
    ctx = _ctx(monkeypatch, _serving(), steps=32)
    assert run.reader("decode.host_syncs_per_step")(ctx) == \
        pytest.approx(0.75)


def test_queue_wait_p95(monkeypatch):
    ctx = _ctx(monkeypatch, _serving())
    # batches 1, 2, 3 began in the window; their rows waited 20, 25, 30 ms
    want = percentile([20.0, 25.0, 30.0] * 3, 95)
    assert run.reader("serve.queue_wait_p95_ms.poisson")(ctx) == \
        pytest.approx(want, abs=1e-6)


def test_train_host_ms(monkeypatch, capsys):
    r = _Recs()
    for k in range(8):
        t0 = 60.0 * k
        step = r.add("train.step", t0, t0 + 50 + k)
        r.add("train.inputs", t0 + 0.5, t0 + 5, step)
        r.add("train.forward", t0 + 5, t0 + 20, step)
        r.add("data.upload", t0 + 1, t0 + 9 + k, thread=COMPLETER)
    # the window's 8 steps, the last 4 traced, from 240 ms: 54..57 ms
    ctx = _ctx(monkeypatch, r.out, kind="train", window=(240.0, 480.0))
    ctx.update(steps=8, steps_traced=4)
    # steps 0..3, before the profiler: 50..53 ms
    assert run.reader("train.host_ms_per_step")(ctx) == pytest.approx(51.5)
    assert "(51.5, 4) before the profiler started (0.24 s), (55.5, 4) in " \
        "the traced window" in capsys.readouterr().err
    # their uploads, 8..11 ms
    assert run.reader("data.upload_ms_per_step")(ctx) == pytest.approx(9.5)
    assert run.reader("decode.enqueue_ms_per_step")(ctx) is None
    assert run.reader("serve.completer_ms_per_batch")(ctx) is None


def test_idle_gaps_are_named_by_the_programs_ranges(monkeypatch):
    # the device busy inside each decode step before its stop check, and
    # once more from 84 ms into a batch to 1 ms into its handoff
    kernels = [(b * 101 + 22 + 8 * k, b * 101 + 27 + 8 * k)
               for b in range(5) for k in range(8)]
    kernels += [(b * 101 + 84, b * 101 + 87) for b in range(5)]
    ctx = _ctx(monkeypatch, _serving(), kernels=kernels)
    gaps = ctx["trace"]["idle_by_range"]
    for name in ("serve.handoff", "decode.stop_check"):
        assert gaps.get(name, 0) > 0
    named = sum(v for k, v in gaps.items()
                if k != "outside_the_harness_ranges")
    assert gaps.get("outside_the_harness_ranges", 0) < 0.1 * named


def test_without_the_programs_recorder_nothing_is_read(monkeypatch):
    monkeypatch.setattr(program_spans, "_profiling", lambda: None)
    program_spans.enable()
    events = _trace_of(_serving(), *WINDOW)
    ctx = {"kind": "serve", "events": events, "trace": trace.read(events),
           "counters": _Counters(24)}
    for name in NEW:
        assert run.reader(name)(ctx) is None
    assert run.reader("train.host_ms_per_step")(
        {"kind": "train"}) is None


def test_the_new_entries_and_their_readers():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    got = {m["name"]: m for m in bench["per_layer"]}
    for name, (unit, source, layer, moves, cell) in NEW.items():
        m = got[name]
        assert (m["unit"], m["source"], m["layer"], m["moves"],
                m["workloads"], m["better"]) == (unit, source, layer, moves,
                                                 [cell], "lower")
        assert name in {x["name"] for x in run.cell_of(bench, cell)
                        ["per_layer"]}
        assert callable(run.reader(name))
    assert [m["name"] for m in bench["per_layer"][-len(NEW):]] == list(NEW)
    assert run.reader_module("serve.between_batches_ms.transformer"
                             ).__file__ == run.reader_module(
        "serve.between_batches_ms").__file__
    assert run.reader_module("serve.queue_wait_p95_ms.poisson").__file__ \
        .endswith("serve.queue_wait_p95_ms.py")
