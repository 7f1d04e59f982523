"""The one load generator: one thread, no thread per client.

A traffic file names its loop. ``closed`` keeps ``outstanding`` requests in
flight and submits a replacement as each completes, waiting on them in
completion (FIFO) order. ``open`` sends Poisson arrivals at
``rate_per_s``, each request timed from when it was due. Every seed gets
the same inter-arrival gaps (the exponential law's quantiles) in another
order, so the seed changes the order of the work and not its amount.

Requests are any objects with an ``event`` (``threading.Event``) that is
set when they are done, and ``caption`` and ``error`` then; ``submit(i)``
sends request ``i``. Timings are on ``time.perf_counter``.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def poisson_offsets(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Arrival times in [0, seconds): gaps at the quantiles
    ``(i + 1/2) / N`` of an exponential law of mean ``1 / rate`` (N the
    arrivals a window holds on average), shuffled by ``seed``."""
    n = max(1, int(round(rate * seconds)))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    np.random.default_rng(seed).shuffle(gaps)
    t = np.cumsum(gaps) - gaps[0]
    return t[t < seconds]


class Log:
    """Every request's times (``due``, ``sent``, ``done``: NaN until it
    came back), its caption and whether it failed, in flat arrays and
    lists: a window's tens of thousands of requests leave nothing behind
    for the garbage collector to walk, so no collection pause stalls the
    generator or the service."""

    def __init__(self, n: int):
        self.due = np.full(n, np.nan)
        self.sent = np.full(n, np.nan)
        self.done = np.full(n, np.nan)
        self.failed = np.zeros(n, dtype=bool)
        self.caption: List[Optional[str]] = [None] * n
        self.n = 0

    def grow(self):
        m = 2 * len(self.due)
        for name in ("due", "sent", "done"):
            a = np.full(m, np.nan)
            a[:self.n] = getattr(self, name)[:self.n]
            setattr(self, name, a)
        f = np.zeros(m, dtype=bool)
        f[:self.n] = self.failed[:self.n]
        self.failed = f
        self.caption.extend([None] * (m - len(self.caption)))


def run(traffic: dict, submit: Callable[[int], object], seed: int,
        window: Tuple[float, float], marks: List[Tuple[float, Callable]],
        drain_s: float = 60.0) -> Dict[str, object]:
    """Drive the load until the window's end, then wait (at most
    ``drain_s``) for what is still in flight. ``window`` is (start, end) on
    the clock; the load begins before it (the ramp, ``traffic["ramp_s"]``)
    so the window sees a steady state. ``marks`` are (time, fn) called once
    the clock passes each time. A request object is dropped once its
    answer is read (``caption``, ``error``). Returns the :class:`Log`."""
    ws, we = window
    marks = sorted(marks, key=lambda m: m[0])
    live: deque = deque()
    log = Log(1 << 16)

    def poll(timeout: float):
        """Wait for the oldest in flight at most ``timeout``, then record
        every request done at the front."""
        if live:
            live[0][1].event.wait(max(0.0, timeout))
        now = time.perf_counter()
        while live and live[0][1].event.is_set():
            i, req = live.popleft()
            log.done[i] = now
            log.caption[i] = req.caption
            log.failed[i] = req.error is not None

    def send(i: int, due: float):
        if i >= len(log.due):
            log.grow()
        log.due[i] = due
        log.sent[i] = time.perf_counter()
        log.n = i + 1
        live.append((i, submit(i)))

    def run_marks(now: float):
        while marks and marks[0][0] <= now:
            marks.pop(0)[1]()

    start = ws - traffic["ramp_s"]
    i = 0
    if traffic["loop"] == "closed":
        while True:
            now = time.perf_counter()
            run_marks(now)
            if now >= we:
                break
            while len(live) < traffic["outstanding"]:
                send(i, time.perf_counter())
                i += 1
            poll(min(0.05, we - now))
    elif traffic["loop"] == "open":
        due = start + poisson_offsets(traffic["rate_per_s"], we - start, seed)
        while True:
            now = time.perf_counter()
            run_marks(now)
            if i >= len(due) and now >= we:
                break
            while i < len(due) and due[i] <= now:
                send(i, float(due[i]))
                i += 1
            nxt = due[i] if i < len(due) else we
            poll(min(0.05, max(0.0, nxt - time.perf_counter())))
            if not live and nxt > time.perf_counter():
                time.sleep(min(0.05, max(0.0, nxt - time.perf_counter())))
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    run_marks(math.inf)
    end = time.perf_counter() + drain_s
    while live and time.perf_counter() < end:
        poll(min(0.5, end - time.perf_counter()))
    return log


def in_window(log: Log, ws: float, we: float, by: str) -> np.ndarray:
    """The indices of the window's requests: those due in it (``by="due"``,
    the open loop's latency population) or done in it (``by="done"``, the
    closed loop's completions)."""
    t = (log.due if by == "due" else log.done)[:log.n]
    with np.errstate(invalid="ignore"):
        return np.flatnonzero((t >= ws) & (t < we))


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100)."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
