"""The load generator, the percentile and the rates over synthetic
requests."""

import threading
import time

import numpy as np

from portbench import loadgen


def test_percentile_nearest_rank():
    values = list(range(1, 101))          # 1 .. 100
    assert loadgen.percentile(values, 95) == 95
    assert loadgen.percentile(values, 50) == 50
    assert loadgen.percentile([7.0], 95) == 7.0
    assert loadgen.percentile([3, 1, 2], 100) == 3


def test_poisson_schedule_same_gaps_other_order():
    a = loadgen.poisson_offsets(100.0, 10.0, seed=1)
    b = loadgen.poisson_offsets(100.0, 10.0, seed=2)
    again = loadgen.poisson_offsets(100.0, 10.0, seed=1)
    assert np.array_equal(a, again)
    assert not np.array_equal(a, b)
    # the same multiset of gaps: equal sums and sorted gaps (up to the
    # arrivals past the window's end)
    ga, gb = np.diff(a), np.diff(b)
    n = min(len(ga), len(gb))
    assert abs(len(a) - 1000) <= 2 and abs(len(b) - 1000) <= 2
    assert np.allclose(np.sort(ga)[: n - 2], np.sort(gb)[: n - 2], atol=0.02)
    assert abs(np.mean(np.diff(a)) - 0.01) < 0.001
    assert a[0] == 0.0 and a[-1] < 10.0


def test_poisson_schedule_large_seed():
    assert len(loadgen.poisson_offsets(50.0, 2.0, seed=2 ** 31 + 12345)) > 90


class FakeService:
    """Answers each request ``delay`` seconds after it was submitted, in
    batches, from a thread of its own."""

    def __init__(self, delay: float):
        self.delay = delay
        self.sent = []
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, i):
        class Req:
            caption = "7 8 9"
            error = None
        req = Req()
        req.event = threading.Event()
        with self.lock:
            self.sent.append((time.perf_counter(), req))
        return req

    def _loop(self):
        while not self.stop.is_set():
            now = time.perf_counter()
            with self.lock:
                due = [r for t, r in self.sent if now - t >= self.delay]
                self.sent = [(t, r) for t, r in self.sent
                             if now - t < self.delay]
            for r in due:
                r.event.set()
            time.sleep(0.001)


def test_closed_loop_keeps_requests_in_flight():
    svc = FakeService(0.02)
    traffic = {"loop": "closed", "outstanding": 8, "ramp_s": 0.1}
    ws = time.perf_counter() + 0.1
    we = ws + 0.5
    log = loadgen.run(traffic, svc.submit, 0, (ws, we), [])
    svc.stop.set()
    svc.thread.join(timeout=5)
    assert not svc.thread.is_alive()
    n = log.n
    assert not np.isnan(log.done[:n]).any() and not log.failed[:n].any()
    assert log.caption[:n] == ["7 8 9"] * n
    done = loadgen.in_window(log, ws, we, "done")
    # 8 in flight, 20 ms each: about 400 a second
    assert 100 < len(done) / 0.5 < 420
    # never more than 8 in flight
    for t in np.linspace(ws, we, 50):
        flying = ((log.sent[:n] <= t) & (t < log.done[:n])).sum()
        assert flying <= 8


def test_open_loop_times_from_due():
    svc = FakeService(0.01)
    traffic = {"loop": "open", "rate_per_s": 200.0, "ramp_s": 0.0}
    ws = time.perf_counter() + 0.05
    we = ws + 0.5
    log = loadgen.run(traffic, svc.submit, 3, (ws, we), [])
    svc.stop.set()
    svc.thread.join(timeout=5)
    window = loadgen.in_window(log, ws, we, "due")
    assert 80 <= len(window) <= 120
    lat = list(log.done[window] - log.due[window])
    assert min(lat) >= 0.01
    assert loadgen.percentile(lat, 95) < 0.2
    assert (log.sent - log.due)[window].max() < 0.1


def test_log_grows_past_its_first_size():
    log = loadgen.Log(2)
    log.n = 2
    log.due[:2] = [1.0, 2.0]
    log.grow()
    assert len(log.due) == 4 and list(log.due[:2]) == [1.0, 2.0]
    assert np.isnan(log.due[2:]).all() and len(log.caption) == 4
