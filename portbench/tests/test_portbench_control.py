"""The correctness control, kept as a test: the plain reference with its
dense products in fp8 put in the program's place must come out not
correct under the configuration's limits; so must each fault a training
cell can have. At the cells' own sizes these need the card (marked
``cuda``, run there with ``python3 -m pytest portbench/tests -m cuda``);
at tiny widths the same comparisons run on the CPU."""

import json
import os

import pytest
import torch

from conftest import ROOT
from portbench import check, control, train
from tiny import tiny


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size")
    return torch.device("cuda", 0)


def _cfg(name):
    with open(os.path.join(ROOT, "portbench", "configs",
                           name + ".json")) as f:
        return json.load(f)


def _judged(values, limits):
    """The numbers of ``values`` that have a limit, judged (a fault's
    readings hold the conditioning's numbers only)."""
    return check.judge(values, {k: v for k, v in limits.items()
                                if k in values})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship", "transformer"])
def test_serving_control_and_faults_are_not_correct(name):
    """At the cell's size and batch: the program sound, the fp8 control
    and the conditioning faults (the encoder's output zeroed; each row
    conditioned on the next row's image) under the file's limits."""
    device = _cuda()
    cfg = _cfg(name)
    limits = cfg["correct"]["serve"]
    got = control.readings(cfg, 11, 2048, device)
    judged = check.judge(got["program"], limits)
    assert all(j["ok"] for j in judged.values()), judged
    judged = check.judge(got["fp8"], limits)
    assert not all(j["ok"] for j in judged.values()), judged
    faults = ["encoder_zero"] + (["row_swap"] if name == "transformer"
                                 else [])
    for fault in faults:
        judged = _judged(got[fault], limits)
        assert judged and not all(j["ok"] for j in judged.values()), (
            fault, judged)


@pytest.mark.cuda
def test_training_control_and_faults_are_not_correct():
    device = _cuda()
    cfg = _cfg("flagship")
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "train_ce.json")) as f:
        traffic = json.load(f)
    got = control.train_readings(cfg, traffic, 11, device)
    for side in ("fp8", "half_batch"):
        judged = check.judge(got[side], cfg["correct"]["train"])
        assert not all(j["ok"] for j in judged.values()), (side, judged)


def test_unchanged_state_reads_one():
    ref = {"losses": [1.0, 1.0, 1.0],
           "grads": {"a": torch.ones(4, 4), "b": torch.full((3,), 2.0)},
           "deltas": {"a": torch.full((4, 4), 1e-4),
                      "b": torch.full((3,), 1e-4)}}
    still = {"losses": [1.0, 1.0, 1.0],
             "grad_norms": {"a": 4.0, "b": 12 ** 0.5},
             "deltas": {"a": torch.zeros(4, 4), "b": torch.zeros(3)}}
    assert train.gaps(still, ref)["update_norm_gap"] == pytest.approx(1.0)


def test_fp8_control_reads_higher_at_tiny_widths(monkeypatch):
    from portbench import serve, system

    cfg, c = tiny("transformer", width=256, vocab=4000)
    c.model.dtype = "float32"
    monkeypatch.setattr(system, "port_config", lambda cfg: c)
    state = system.draw_state(c, 3, torch.device("cpu"), torch.float32)
    images = serve.image_pool(32, 64, 3, torch.device("cpu"))
    exact, _ = check.reference(cfg, state).beam(torch.from_numpy(images))
    mine = check.numbers(cfg, state, images, exact.numpy(),
                         torch.device("cpu"))["rank_gap_nats"]
    theirs = check.control(cfg, state, images, exact.numpy(),
                           torch.device("cpu"))["rank_gap_nats"]
    assert mine <= 1e-6 < theirs
