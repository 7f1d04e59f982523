"""The traced run: ``torch.profiler`` over a part of the window, and what is
read from its trace.

The harness marks the host's work with ranges of its own
(:class:`Spans`: ``record_function`` around calls into the program's
layers); the profiler records them beside every kernel. From the trace
come the device's busy seconds (the union of the intervals in which a
kernel, copy or set ran), the kernels launched, the device time of the
kernels launched inside a named range, and the idle gaps, each named by
the innermost range the host was in when the device went idle.
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench_window"


class Spans:
    """Wrap program functions in named ``record_function`` ranges for the
    traced run, and undo it afterwards. ``shapes(*args, **kwargs)``, if
    given, records what each call was asked (the shapes a roofline
    counts) under ``calls[name]``."""

    def __init__(self):
        self._undo: List[Tuple[object, str, object]] = []
        self.calls: Dict[str, List] = defaultdict(list)
        self.active = False      # record shapes only while profiling

    def wrap(self, owner, attr: str, name: str, shapes=None):
        import torch

        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if shapes is not None and self.active:
                self.calls[name].append(shapes(*args, **kwargs))
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


class Profile:
    """``torch.profiler`` from :meth:`start` to :meth:`stop`, the window
    marked by a range of its own; :meth:`stop` returns the trace's events
    (read back from a Chrome trace written under ``tmpdir`` and deleted)
    and the host seconds between the two calls."""

    def __init__(self, tmpdir: Optional[str] = None):
        import torch

        self._torch = torch
        self._tmpdir = tmpdir
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._range = None

    def start(self):
        self._prof.start()
        self._t0 = time.perf_counter()
        self._range = self._torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def stop(self) -> Tuple[list, float]:
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        window_s = time.perf_counter() - self._t0
        self._prof.stop()
        with tempfile.TemporaryDirectory(dir=self._tmpdir) as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return events, window_s


def _window(events) -> Tuple[float, float]:
    for e in events:
        if e.get("name") == WINDOW and e.get("cat") == "user_annotation":
            return e["ts"], e["ts"] + e["dur"]
    raise ValueError("the trace holds no window range")


def device_intervals(events, lo: float, hi: float):
    """Device operations inside [lo, hi] (microseconds), clipped."""
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if b > a:
                out.append((a, b, e))
    return out


def union(intervals) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted((a, b) for a, b, *_ in intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_gaps(busy, lo: float, hi: float) -> List[Tuple[float, float]]:
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _ranges(events):
    """The harness's ranges (not the window's): (start, end, name)."""
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("name") != WINDOW]


def name_gaps(gaps, ranges, outside: str,
              reach_us: float = 5e6) -> Dict[str, float]:
    """Seconds of idle device by the innermost range the host was in when
    each gap began (ranges that began within ``reach_us`` before it)."""
    ranges = sorted(ranges)
    starts = [s for s, _, _ in ranges]
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        inner = None
        i = bisect.bisect_right(starts, a) - 1
        while i >= 0 and a - ranges[i][0] <= reach_us:
            s, e, n = ranges[i]
            if a < e and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, n)
            i -= 1
        out[inner[2] if inner else outside] += (b - a) / 1e6
    return out


def device_time_in(events, name: str, lo: float, hi: float) -> float:
    """Seconds of device operations launched inside a ``name`` range on
    the launching thread (the launch call's time and correlation id),
    within [lo, hi]. Ranges of one name on one thread do not nest."""
    spans: Dict[object, List[Tuple[float, float]]] = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == name:
            spans[e.get("tid")].append((e["ts"], e["ts"] + e["dur"]))
    for v in spans.values():
        v.sort()
    starts = {t: [s for s, _ in v] for t, v in spans.items()}
    launched = set()
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        tid = e.get("tid")
        if tid not in spans:
            continue
        i = bisect.bisect_right(starts[tid], e["ts"]) - 1
        if i >= 0 and e["ts"] <= spans[tid][i][1]:
            launched.add(e.get("args", {}).get("correlation"))
    launched.discard(None)
    return sum(b - a for a, b, e in device_intervals(events, lo, hi)
               if e.get("args", {}).get("correlation") in launched) / 1e6


def read(events) -> dict:
    """Everything the per-layer readers take from a trace."""
    lo, hi = _window(events)
    dev = device_intervals(events, lo, hi)
    busy = union(dev)
    kernels = [e for _, _, e in dev if e.get("cat") == "kernel"]
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, e in dev:
        by_name[e["name"]] += (b - a) / 1e6
    gaps = name_gaps(idle_gaps(busy, lo, hi), _ranges(events),
                     "outside_the_harness_ranges")
    return {"lo": lo, "hi": hi, "trace_window_s": (hi - lo) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernels": len(kernels), "device_by_name": dict(by_name),
            "idle_by_range": dict(gaps)}


def breakdown(summary: dict) -> dict:
    top = sorted(summary["device_by_name"].items(), key=lambda kv: -kv[1])
    gaps = sorted(summary["idle_by_range"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:96], s] for n, s in top[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
