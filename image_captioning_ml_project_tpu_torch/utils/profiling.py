"""Profiling: traces, spans and counters, and device memory.

Counterpart of ``image_captioning_ml_project_tpu.utils.profiling``:

* :func:`trace` -- context manager around ``torch.profiler`` writing a
  Chrome trace (host ops and, on a CUDA device, its kernels);
* :func:`span` -- a named interval of host work at a layer boundary
  (``<layer>.<what>``: ``serve.upload``, ``decode.step``, ...), kept in
  memory while the recorder is on (:func:`enable`), and then also a
  ``torch.profiler`` range of the same name, so that on the thread a
  profiler runs on it lands in the trace beside the kernels it launched;
  :func:`records` drains what was kept;
* :func:`count` -- an increment of an integer counter
  (``decode.host_syncs``), kept as a record while the recorder is on;
* :func:`device_memory_stats` -- per-device memory in use and at peak.

A span's record holds its name, its start and end on
``time.monotonic_ns()`` (the clock of the server's request times), the
recording thread's native id, an integer id, its parent's id (by default
the innermost span open on the thread; work handed to another thread
names its parent explicitly; 0 for none), small attributes, and the time
entering its profiler range took (the range begins within it after the
span's start, so a pairing of the two clocks is as close as it is
short). Each thread keeps its newest records in a ring of its own, so a
long run keeps its end; older records are overwritten and counted
(:func:`overwritten`). A :func:`count` is kept as a record (start = end,
``attrs["n"]`` the increment), so a counter is read over an interval of
time. Off, :func:`span` checks one flag and returns a shared no-op
context, and :func:`count` checks it and returns.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

RING = 1 << 16  # records kept per thread


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``with trace("traces"): step()`` writes ``log_dir/trace.json``, a
    Chrome trace of what ran inside (``chrome://tracing`` or Perfetto
    loads it); CUDA activity is recorded where a CUDA device is present.
    Yields the profiler, whose ``key_averages()`` can be read after."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int      # threading.get_native_id() of the recording thread
    id: int
    parent: int      # 0: none
    attrs: dict
    enter_ns: int    # the time entering the profiler's range took


class _Ring:
    """One thread's records, the ids of its open spans (innermost last)
    and the number of records its ring overwrote."""

    __slots__ = ("records", "open", "overwritten", "thread", "native")

    def __init__(self):
        self.records: collections.deque = collections.deque(maxlen=RING)
        self.open: List[int] = []
        self.overwritten = 0
        self.thread = threading.current_thread()
        self.native = threading.get_native_id()

    def add(self, record: Record):
        if len(self.records) == self.records.maxlen:
            self.overwritten += 1
        self.records.append(record)


_enabled = False
_ids = itertools.count(1)
_local = threading.local()
_rings: List[_Ring] = []
_rings_lock = threading.Lock()
_overwritten_gone = 0      # overwritten in rings of threads that ended


def _ring() -> _Ring:
    ring = getattr(_local, "ring", None)
    if ring is None:
        ring = _local.ring = _Ring()
        with _rings_lock:
            _rings.append(ring)
    return ring


class _Off:
    """The span while the recorder is off: enters nothing, keeps
    nothing. ``id`` and ``attrs`` are None, as a caller that hands the
    span's id on or adds attributes reads them."""

    __slots__ = ()
    id = None
    attrs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "attrs", "id", "start_ns", "_entered_ns",
                 "_range", "_ring")

    def __init__(self, name: str, parent: Optional[int], attrs: dict):
        self.name, self.parent, self.attrs = name, parent, attrs

    # the profiler's range is entered first and left last: between two
    # ranges a thread that loses the GIL is outside every range
    def __enter__(self):
        self.start_ns = time.monotonic_ns()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._entered_ns = time.monotonic_ns()
        ring = self._ring = _ring()
        if self.parent is None:
            self.parent = ring.open[-1] if ring.open else 0
        self.id = next(_ids)
        ring.open.append(self.id)
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        ring = self._ring
        ring.open.remove(self.id)
        ring.add(Record(self.name, self.start_ns, end, ring.native, self.id,
                        self.parent, self.attrs,
                        self._entered_ns - self.start_ns))
        self._range.__exit__(*exc)
        return False


def span(name: str, parent: Optional[int] = None, **attrs):
    """``with span("serve.upload"): ...`` records the block as a span
    while the recorder is on. ``parent``: the id of the span this work
    belongs to, where it runs on another thread than that span (by
    default the innermost span open on this thread). The context's value
    has the span's ``id`` and its ``attrs`` dict, to which the block may
    add; both are None while the recorder is off."""
    if not _enabled:
        return _OFF
    return _Span(name, parent, attrs)


def count(name: str, n: int = 1):
    """While the recorder is on, keep an increment of ``n`` to the
    counter ``name`` as a record at this time, under the innermost span
    open on the thread."""
    if not _enabled:
        return
    ring = _ring()
    now = time.monotonic_ns()
    ring.add(Record(name, now, now, ring.native, next(_ids),
                    ring.open[-1] if ring.open else 0, {"n": n}, 0))


def enable():
    """Turn the recorder on; each thread keeps its newest ``RING``
    records."""
    global _enabled
    _enabled = True


def disable():
    """Turn the recorder off; spans open now are still kept when they
    end."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def records() -> List[Record]:
    """Drain every thread's ring: the records kept since the last call,
    in the order they began. Rings of threads that ended go."""
    global _overwritten_gone
    out: List[Record] = []
    with _rings_lock:
        for r in _rings:
            while r.records:
                out.append(r.records.popleft())
        for r in [r for r in _rings if not r.thread.is_alive()]:
            _overwritten_gone += r.overwritten
            _rings.remove(r)
    out.sort(key=lambda r: r.start_ns)
    return out


def overwritten() -> int:
    """Records the rings overwrote before they were drained, since the
    process began."""
    with _rings_lock:
        return _overwritten_gone + sum(r.overwritten for r in _rings)


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per CUDA device, the memory its caching allocator has in use and
    at peak, in MB (``torch.cuda.memory_stats``); ``{}`` without one."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0)
            / 2**20,
            "peak_bytes_mb": stats.get("allocated_bytes.all.peak", 0)
            / 2**20,
        }
    return out
