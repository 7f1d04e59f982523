"""The plain references against the program at tiny widths on the CPU,
in float32 on both sides: the same teacher-forced logits, the same beam
search tokens, the same three training steps."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import check, flops, serve, system, train
from portbench.reference.common import Numerics
from tiny import tiny

CPU = torch.device("cpu")


def _f32(name):
    cfg, c = tiny(name)
    c.model.dtype = "float32"
    cfg["dtype"] = "float32"
    return cfg, c


@pytest.mark.parametrize("name", ["flagship", "transformer"])
def test_beam_tokens_and_logits_match_the_program(name):
    from image_captioning_ml_project_tpu_torch.inference.decoding import \
        decode_images
    from image_captioning_ml_project_tpu_torch.models.captioning_model \
        import load_model

    cfg, c = _f32(name)
    state = system.draw_state(c, 5, CPU, torch.float32)
    images = torch.from_numpy(serve.image_pool(6, 64, 5, CPU))
    model = load_model(c, CPU, state_dict=state)
    served = decode_images(model, images, c)
    ref = check.reference(cfg, state)
    best, _ = ref.beam(images)
    assert torch.equal(best, served)
    with torch.no_grad():
        mine = ref.teacher_logits(images, served)
        out = model.decoder.forward(model.encode(images),
                                    served[:, :-1])["logits"]
    # the program's teacher-forced forward hides pad keys; the served rows
    # hold no pad before their EOS, so the positions compared agree
    gaps = check.rank_gaps(mine, served, cfg)
    assert float(gaps.max()) <= 1e-5
    keep = ~torch.isinf(gaps)
    assert torch.allclose(mine[keep], out.float()[keep], atol=1e-4)
    # what the decode reads of each image: the program's init_cache
    # against the reference's condition_kv
    with torch.no_grad():
        cond = flops.config_module(cfg).program_condition(
            model.init_cache(images, cfg["decode"]["max_length"]))
    got = check.condition_gaps(cfg, state, images.numpy(), cond, CPU)
    assert got["condition_gap"] < 1e-5


def test_training_steps_match_the_program(monkeypatch):
    cfg, c = _f32("flagship")
    monkeypatch.setattr(system, "port_config", lambda cfg: c)
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "train_ce.json")) as f:
        traffic = json.load(f)
    traffic.update(batch=6, batches=3, reference_block=4)
    ctx = train.run(cfg, traffic, 9, 0.1, False, CPU, 0.0, print)
    ref = train.reference_steps(ctx, CPU)
    g = train.gaps(ctx["program"], ref)
    assert g["diagnostic"]["first_loss_gap"] < 1e-5
    assert g["diagnostic"]["later_loss_gap"] < 1e-5
    assert g["grad_norm_gap"] < 1e-4
    assert g["update_norm_gap"] < 1e-3
    assert np.allclose(ctx["program"]["losses"], ref["losses"], rtol=1e-5)


def test_fp8_numerics_round_the_products():
    x = torch.randn(4, 8)
    w = torch.randn(3, 8)
    exact = Numerics("f32").mm(x, w)
    low = Numerics("fp8").mm(x, w)
    assert torch.equal(exact, x @ w.t())
    assert 1e-3 < float((low - exact).abs().max()) < 0.5
