"""The program's own spans and counters (``utils/profiling.py`` of the
port: ``span``, ``count``) on the traced run's timeline.

A reader of a metric that reads them calls :func:`enable` when its module
is loaded. ``run.py`` loads the per-layer readers of a cell only for a
``--trace 1`` run, before the cell runs, so the recorder is on in traced
runs and off in every other. After the run :func:`collect` drains the
recorder and places every record on the trace's clock:

* on the thread the profiler records (the batcher, or the training loop)
  each span is also a ``user_annotation`` range of the same name in the
  trace. Pairing the two gives the offset from ``time.monotonic_ns()``
  to the trace's microseconds (the median over the pairs) and the
  alignment residual (the widest deviation of a pair from that median);
* with that offset the spans of threads the profiler does not record
  (the completer, the prefetch producer) go on the same timeline.

The recorder is on from set-up on, so the measured window's records
before the profiler started are kept too (:func:`untraced`): the times
the profiler does not slow. A reader gives its value over that part of
the window (:func:`reading`), and logs it beside the traced window's.

Against a program without the recorder :func:`enable` does nothing and
:func:`collect` returns None, and so does every reader of these metrics.
"""

from __future__ import annotations

import bisect
import statistics
import sys
from collections import Counter, defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

PREFIX = 64        # ranges matched in order to find the first offset
SHORT = 8          # ... else SHORT of them (a window of few ranges)
CLEAN_US = 50.0    # the longest a span's entry into its range may take,
                   # for the pair to count (a longer one lost the GIL)
REACH_US = 1000.0  # the farthest a range may lie from its span, paired


class Span(NamedTuple):
    """A record of the program on the trace's timeline (``ts``, ``end``
    in trace microseconds; a counter's record has ``ts == end`` and its
    increment in ``attrs["n"]``)."""
    name: str
    ts: float
    end: float
    thread: int
    id: int
    parent: int
    attrs: dict
    ms: float          # duration


def _profiling():
    """The program's recorder, or None where the program has none."""
    try:
        from image_captioning_ml_project_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") else None


def enable():
    p = _profiling()
    if p is not None and not p.enabled():
        p.enable()


def clock_offset(records, events) -> Optional[tuple]:
    """(offset, residual, pairs, ranges): trace microseconds x 1000 = a
    record's ``monotonic_ns`` + offset, the median over the paired
    ranges; the widest deviation of a pair from it, in microseconds; the
    number of pairs, and of the program's ranges in the trace. None where
    no range of the trace is one of ``records``.

    The trace's ranges of the program's names on one thread follow, in
    order, that thread's spans from the profiler's start on. The first
    ``PREFIX`` ranges are matched by name against every run of as many
    spans of a thread, and the run whose offsets and durations agree best
    gives the first offset; where no run matches (a span open when the
    profiler stopped has no range), the first ``SHORT`` ranges are.
    Every range is then paired with the span of its name nearest to it
    under that offset (within ``REACH_US``). A range begins while its
    span is entered (within ``Record.enter_ns`` of the span's start):
    only spans entered within ``CLEAN_US`` make pairs, where there are
    any."""
    names = {r.name for r in records}
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X" and e.get("name") in names]
    if not marks:
        return None
    tid = Counter(e.get("tid") for e in marks).most_common(1)[0][0]
    ranges = sorted((e["ts"] * 1e3, e["name"], e["dur"] * 1e3) for e in marks
                    if e.get("tid") == tid)
    marked = {n for _, n, _ in ranges}
    threads: Dict[int, List] = defaultdict(list)
    for r in records:
        if r.name in marked:
            threads[r.thread].append(r)
    for rs in threads.values():
        rs.sort(key=lambda r: r.start_ns)
    best = None
    for length in (PREFIX, SHORT):
        head = ranges[:length]
        m = len(head)
        for thread, rs in threads.items():
            for j in range(len(rs) - m + 1):
                if any(rs[j + i].name != head[i][1] for i in range(m)):
                    continue
                pairs = [(h, r) for h, r in zip(head, rs[j:j + m])
                         if _clean(r)] or list(zip(head, rs[j:j + m]))
                offs = [h[0] - r.start_ns for h, r in pairs]
                # a run one batch or step off can keep the offsets close:
                # the durations tell it apart
                spread = max(offs) - min(offs) + max(
                    abs(h[2] - (r.end_ns - r.start_ns)) for h, r in pairs)
                if best is None or spread < best[0]:
                    best = (spread, statistics.median(offs), thread)
        if best is not None:
            break
    else:
        return None
    _, first, thread = best
    by_name: Dict[str, List] = defaultdict(list)
    for r in threads[thread]:
        by_name[r.name].append(r)
    starts = {n: [r.start_ns for r in rs] for n, rs in by_name.items()}
    paired = []
    for ts, name, _ in ranges:
        want = ts - first
        i = bisect.bisect_left(starts[name], want)
        r = min(by_name[name][max(0, i - 1):i + 1],
                key=lambda r: abs(r.start_ns - want))
        if abs(r.start_ns - want) <= REACH_US * 1e3:
            paired.append((ts - r.start_ns, _clean(r)))
    # where no span was entered cleanly, every pair counts
    diffs = [d for d, clean in paired if clean] or [d for d, _ in paired]
    if not diffs:
        return None
    offset = statistics.median(diffs)
    return (offset, max(abs(d - offset) for d in diffs) / 1e3, len(diffs),
            len(ranges))


def _clean(r) -> bool:
    return r.enter_ns <= CLEAN_US * 1e3


def place(records, events, lo: float, hi: float) -> Optional[dict]:
    """Every record on the trace's timeline (``all``), those that began
    inside the traced window [lo, hi) (``spans``; ``lo``, ``hi`` kept
    beside them), and the alignment (``offset_ns``, ``residual_us``,
    ``pairs``, ``ranges``); None where the trace holds none of the
    program's spans."""
    got = clock_offset(records, events)
    if got is None:
        return None
    offset, residual, pairs, ranges = got
    every = [Span(r.name, (r.start_ns + offset) / 1e3,
                  (r.end_ns + offset) / 1e3, r.thread, r.id, r.parent,
                  r.attrs or {}, (r.end_ns - r.start_ns) / 1e6)
             for r in records]
    return {"all": every, "spans": [s for s in every if lo <= s.ts < hi],
            "lo": lo, "hi": hi, "offset_ns": offset, "residual_us": residual,
            "pairs": pairs, "ranges": ranges}


def collect(ctx: dict) -> Optional[dict]:
    """:func:`place` over the program's records and the traced run's
    trace, once a run (the recorder is drained: kept in ``ctx``), with
    the records the rings overwrote (``overwritten``)."""
    if "program_spans" not in ctx:
        p, t = _profiling(), ctx.get("trace")
        got = None
        if p is not None and t is not None and ctx.get("events"):
            got = place(p.records(), ctx["events"], t["lo"], t["hi"])
            if got is not None:
                got["overwritten"] = p.overwritten()
                print(f"program spans: {len(got['spans'])} records in the "
                      f"window, clock offset {got['offset_ns']!r} ns, "
                      f"alignment residual {got['residual_us']!r} us over "
                      f"{got['pairs']} pairs of {got['ranges']} ranges, "
                      f"{got['overwritten']} overwritten", file=sys.stderr)
        ctx["program_spans"] = got
    return ctx["program_spans"]


def whole(got: dict, name: str) -> List[Span]:
    """The spans named ``name`` that began and ended in the window."""
    return [s for s in got["spans"] if s.name == name and s.end <= got["hi"]]


def untraced(ctx: dict) -> Optional[dict]:
    """The records of the measured window before the profiler started,
    as :func:`collect` gives the traced window's (``spans`` began in
    [``lo``, ``hi``), ``all``, ``offset_ns``; ``seconds`` its length).
    Serving: from the counters' ``start`` mark to their ``trace_start``
    (``time.perf_counter``: on Linux, as ``time.monotonic_ns``,
    ``CLOCK_MONOTONIC``, the records' clock). Training: the window's CE steps
    before the traced ones (``steps``, ``steps_traced``), counted back
    from the last ``train.step``. None where the part holds none."""
    got = collect(ctx)
    if got is None:
        return None
    if ctx.get("kind") == "serve":
        marks = ctx["counters"].marks
        if "start" not in marks or "trace_start" not in marks:
            return None
        lo, hi = ((marks[k]["t"] * 1e9 + got["offset_ns"]) / 1e3
                  for k in ("start", "trace_start"))
    elif ctx.get("kind") == "train":
        steps = sorted((s for s in got["all"] if s.name == "train.step"),
                       key=lambda s: s.ts)[-ctx["steps"]:]
        n = ctx["steps"] - ctx["steps_traced"]
        if n <= 0 or len(steps) < ctx["steps"]:
            return None
        lo = steps[0].ts
        hi = steps[n].ts if n < len(steps) else got["lo"]
    else:
        return None
    spans = [s for s in got["all"] if lo <= s.ts < hi]
    if not spans:
        return None
    return {"all": got["all"], "spans": spans, "lo": lo, "hi": hi,
            "offset_ns": got["offset_ns"], "seconds": (hi - lo) / 1e6}


def reading(ctx: dict, kind: str,
            value: Callable[[dict], Optional[Tuple[float, int]]],
            name: str) -> Optional[float]:
    """A reader's value in a ``kind`` run: ``value`` (the number and how
    many items it averages) over the window before the profiler started
    (:func:`untraced`) or, where that part holds none, over the traced
    window; both go to standard error."""
    got = collect(ctx)
    if got is None or ctx.get("kind") != kind:
        return None
    traced = value(got)
    part = untraced(ctx)
    free = value(part) if part is not None else None
    print(f"{name}: {free!r} before the profiler started "
          f"({part['seconds'] if part else 0.0!r} s), {traced!r} in the "
          f"traced window (value, items)", file=sys.stderr)
    got = free or traced
    return got[0] if got else None
