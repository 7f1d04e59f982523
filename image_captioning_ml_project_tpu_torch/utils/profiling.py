"""Profiling and step-time observability.

Counterpart of ``image_captioning_ml_project_tpu.utils.profiling``:

* :func:`trace` -- context manager around ``torch.profiler`` writing a
  Chrome trace (host ops and, on a CUDA device, its kernels);
* :class:`StepTimer` -- wall-clock step timing with summary statistics;
* :func:`device_memory_stats` -- per-device memory in use and at peak.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


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


class StepTimer:
    """Wall-clock step timer with percentile summaries; the first
    ``warmup`` steps are left out."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }


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
