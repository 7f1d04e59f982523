"""The rest of a run on the CPU (the look for a card skipped), with the
timed path broken underneath: ``correct`` has to come out false. One case
per fault a cell can have: a served token altered where it is produced,
half of a served batch left undecoded, the encoder's output zeroed, each
row conditioned on another row's image, a training step that leaves the
state unchanged, a training step over half of its batch."""

import json
import os

import pytest
import torch

from conftest import ROOT
from portbench import run, system
from tiny import tiny

CPU = torch.device("cpu")


def _spec(cell, cfg, **traffic):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = run.cell_of(json.load(f), cell)
    spec["cfg"] = cfg
    spec["traffic"].update(traffic)
    return spec


def _f32(name):
    """Tiny and in float32, where a sound run reads no gap at all."""
    cfg, c = tiny(name)
    c.model.dtype = "float32"
    cfg["dtype"] = "float32"
    return cfg, c


# the number each configuration compares (its file's ``correct``)
SERVE_LIMITS = {"flagship": {"rank_gap_nats": 1e-3, "condition_gap": 1e-5},
                "transformer": {"rank_gap_mean_nats": 1e-6,
                                "condition_gap": 1e-5}}


def _serve_spec(name):
    cfg, c = _f32(name)
    cfg["correct"].update(sample=10 ** 6,          # judge every caption
                          serve=SERVE_LIMITS[name])
    spec = _spec(f"{name}-serve-saturated", cfg, outstanding=16, pool=24,
                 ramp_s=0.2, warm_full_batches=1)
    spec["traffic"]["serve"] = dict(spec["traffic"]["serve"], batch_size=8,
                                    bucket_sizes=[1, 8])
    return spec, c


def _run(spec, seconds=1.0):
    ctx = run.measure(spec, 3, seconds, False, CPU, 0.0)
    return run.result(spec, ctx, False, {"platform": "cpu"},
                      run.judge(ctx, CPU))


@pytest.fixture
def program(monkeypatch):
    def use(c):
        monkeypatch.setattr(system, "port_config", lambda cfg: c)
    return use


@pytest.mark.parametrize("name", ["flagship", "transformer"])
def test_sound_serving_run_is_correct(name, program):
    spec, c = _serve_spec(name)
    program(c)
    out = _run(spec)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", ["flagship", "transformer"])
def test_altered_token_is_not_correct(name, program, monkeypatch):
    from image_captioning_ml_project_tpu_torch.inference import decoding

    spec, c = _serve_spec(name)
    program(c)
    real = decoding.beam_search

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        tokens = res.tokens.clone()
        tokens[:, 3] = (tokens[:, 3] + 97) % 300
        tokens[:, 3] = torch.where(tokens[:, 3] < 3, 3, tokens[:, 3])
        return res._replace(tokens=tokens)

    monkeypatch.setattr(decoding, "beam_search", altered)
    out = _run(spec)
    assert not out["correct"]
    tokens, condition = SERVE_LIMITS[name]
    judged = out["compared"][tokens]
    assert judged["value"] > judged["limit"], tokens
    assert out["compared"][condition]["value"] <= 1e-5


def _encoder_zero(model_cls):
    real = model_cls.encode

    def zero(self, images):
        return {k: torch.zeros_like(v) if v.is_floating_point() else v
                for k, v in real(self, images).items()}
    return zero


def _row_swap(model_cls):
    real = model_cls.init_cache

    def swap(self, images, max_length):
        return real(self, images.roll(1, 0), max_length)
    return swap


@pytest.mark.parametrize("fault", ["encoder_zero", "row_swap"])
@pytest.mark.parametrize("name", ["flagship", "transformer"])
def test_conditioning_fault_is_not_correct(name, fault, program,
                                           monkeypatch):
    from image_captioning_ml_project_tpu_torch.models.captioning_model \
        import ImageCaptioningModel

    spec, c = _serve_spec(name)
    program(c)
    if fault == "encoder_zero":
        monkeypatch.setattr(ImageCaptioningModel, "encode",
                            _encoder_zero(ImageCaptioningModel))
    else:
        monkeypatch.setattr(ImageCaptioningModel, "init_cache",
                            _row_swap(ImageCaptioningModel))
    out = _run(spec)
    assert not out["correct"]
    _, condition = SERVE_LIMITS[name]
    judged = out["compared"][condition]
    assert judged["value"] > 10 * judged["limit"], judged


def test_half_batch_left_out_is_not_correct(program, monkeypatch):
    from image_captioning_ml_project_tpu_torch.inference import server

    spec, c = _serve_spec("flagship")
    program(c)
    real = server.decode_images

    def half(model, images, config, *args, **kwargs):
        tokens = real(model, images[: len(images) // 2], config, *args,
                      **kwargs)
        rest = torch.full((len(images) - len(tokens), tokens.shape[1]),
                          config.model.pad_token_id, dtype=tokens.dtype)
        rest[:, 0] = config.model.bos_token_id
        return torch.cat([tokens, rest])

    monkeypatch.setattr(server, "decode_images", half)
    out = _run(spec)
    assert not out["correct"]


def _train_spec():
    cfg, c = _f32("flagship")
    cfg["correct"]["train"].update(grad_norm_gap=1e-3,
                          update_norm_gap=1e-2)
    return _spec("flagship-train-ce", cfg, batch=6, batches=3,
                 reference_block=4), c


def test_sound_training_run_is_correct(program):
    spec, c = _train_spec()
    program(c)
    out = _run(spec, 0.2)
    assert out["correct"], out["compared"]


def test_unchanged_state_is_not_correct(program, monkeypatch):
    from image_captioning_ml_project_tpu_torch.train import optim

    spec, c = _train_spec()
    program(c)
    monkeypatch.setattr(optim.AdamW, "step",
                        lambda self, grads: torch.zeros(()))
    out = _run(spec, 0.2)
    assert not out["correct"]
    assert out["compared"]["update_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_training_batch_is_not_correct(program, monkeypatch):
    from image_captioning_ml_project_tpu_torch.train import trainer

    spec, c = _train_spec()
    program(c)
    real = trainer.CaptioningTrainer.train_step

    def half(self, images, captions, mask):
        n = len(captions) // 2
        return real(self, images[:n], captions[:n], mask[:n])

    monkeypatch.setattr(trainer.CaptioningTrainer, "train_step", half)
    out = _run(spec, 0.2)
    assert not out["correct"]
