"""The port's utils/profiling.py: ``trace`` writes a Chrome trace of what
ran inside, ``StepTimer`` leaves out its warm-up steps and summarises the
rest with the JAX package's keys, ``device_memory_stats`` is ``{}``
without a CUDA device (per device MB in use and at peak with one)."""

import json
import os
import time

import torch

from image_captioning_ml_project_tpu.utils import profiling as jax_profiling
from image_captioning_ml_project_tpu_torch.utils.profiling import (
    StepTimer, device_memory_stats, trace)


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "tr")
    with trace(log_dir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())


def test_step_timer_warmup_and_summary():
    t = StepTimer(warmup=2)
    for _ in range(5):
        with t:
            time.sleep(0.01)
    s = t.summary()
    assert s["steps"] == 3  # 5 enters - 2 warmup
    assert s["mean_s"] >= 0.009
    assert s["p95_s"] >= s["p50_s"] > 0
    assert s["steps_per_sec"] > 0
    assert StepTimer().summary() == {"steps": 0}
    ref = jax_profiling.StepTimer(warmup=0)
    with ref:
        pass
    assert set(ref.summary()) == set(s)


def test_device_memory_stats_without_a_card():
    out = device_memory_stats()
    if not torch.cuda.is_available():
        assert out == {}
    for v in out.values():
        assert set(v) == {"bytes_in_use_mb", "peak_bytes_mb"}
