"""The port's models in training mode, on the CPU: with dropout 0 the
training forward equals the eval model's (within 1e-5: the eval CLIP runs
the encoder fold's plain version); the dropout helper keeps 0.5 +- 0.05 of
the entries at rate 0.5 and scales the kept ones by 2, its masks drawn
from the given generator; BatchNorm in training mode against flax
``BatchNorm(use_running_average=False, momentum=0.9)`` (output and updated
running statistics within 1e-6); ``freeze`` gives the encoder backbone
zero gradients (and AdamW still decays it) and keeps the ResNet's
BatchNorm on its running statistics; ``remat`` gives the same gradients as
no remat, bit for bit; a training step reaches no kernel wrapper on
any family, use_pallas and the encoder fold included, while validation
reaches them; and the seeded streams (``utils/rng``) repeat from their
seed."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from image_captioning_ml_project_tpu_torch.config import (config_from_dict,
                                                          config_to_dict)
from image_captioning_ml_project_tpu_torch.models import (attention, decoders,
                                                          encoders, gpt2)
from image_captioning_ml_project_tpu_torch.inference import decoding
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    build_train_model, load_model)
from image_captioning_ml_project_tpu_torch.models.layers import (
    dropout, dropout_generator)
from image_captioning_ml_project_tpu_torch.train.trainer import (
    CaptioningTrainer)
from torch_port_helpers import images_uint8, tiny_config

torch.set_num_threads(1)

FAMILIES = [dict(encoder="clip", decoder="gpt2"),
            dict(encoder="vit", decoder="transformer"),
            dict(encoder="vit", decoder="lstm", attention="soft")]


def _port_config(**kw):
    return config_from_dict(config_to_dict(tiny_config(**kw)))


def _captions(seed, B=2, T=7, vocab=1000):
    rs = np.random.RandomState(seed)
    caps = rs.randint(3, vocab, (B, T))
    caps[:, -2:] = 0
    return torch.tensor(caps)


@pytest.mark.parametrize("family", FAMILIES,
                         ids=lambda f: f"{f['encoder']}-{f['decoder']}")
def test_training_forward_without_dropout_equals_eval(family):
    cfg = _port_config(**family)
    images = torch.from_numpy(images_uint8(3))
    caps = _captions(4)
    train_model = build_train_model(cfg, "cpu")
    assert train_model.training
    eval_model = load_model(cfg, "cpu")
    with torch.no_grad():
        got = train_model(images, caps)
        want = eval_model(images, caps)
    for key in ("logits", "pooled_features", "text_features"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_dropout_keeps_half_and_scales_by_two():
    x = torch.ones(100_000)
    g = torch.Generator().manual_seed(0)
    with dropout_generator(g):
        y = dropout(x, 0.5, training=True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) <= 0.05
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    assert torch.equal(dropout(x, 0.5, training=False), x)
    assert dropout(x, 0.0, training=True) is x
    with dropout_generator(torch.Generator().manual_seed(0)):
        assert torch.equal(dropout(x, 0.5, training=True), y)


@pytest.mark.parametrize("family", FAMILIES[:2],
                         ids=lambda f: f"{f['encoder']}-{f['decoder']}")
def test_dropout_in_the_model_follows_the_generator(family):
    cfg = _port_config(**family)
    cfg.model.decoder.dropout = 0.5
    model = build_train_model(cfg, "cpu")
    images = torch.from_numpy(images_uint8(5))
    caps = _captions(6)
    outs = []
    for seed in (1, 1, 2):
        with torch.no_grad(), dropout_generator(
                torch.Generator().manual_seed(seed)):
            outs.append(model(images, caps)["logits"])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with torch.no_grad():
        model.eval()
        model.encoder.backbone.stack = None  # no fold: per-layer eval
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ICT_ENCODER_FOLD", "0")
            det = model(images, caps)["logits"]
    assert not torch.equal(outs[0], det)


def test_batch_norm_training_matches_flax():
    rs = np.random.RandomState(0)
    x = (rs.standard_normal((4, 5, 6, 8)) * 3 + 1).astype(np.float32)
    scale = rs.standard_normal(8).astype(np.float32)
    bias = rs.standard_normal(8).astype(np.float32)
    mean0 = rs.standard_normal(8).astype(np.float32)
    var0 = rs.rand(8).astype(np.float32) + 0.5
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    want, updated = bn.apply(variables, jnp.asarray(x),
                             mutable=["batch_stats"])
    port = encoders.BatchNorm(8)
    with torch.no_grad():
        port.weight.copy_(torch.tensor(scale))
        port.bias.copy_(torch.tensor(bias))
        port.running_mean.copy_(torch.tensor(mean0))
        port.running_var.copy_(torch.tensor(var0))
    port.train()
    got = port(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(updated["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(updated["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)


def _trainer(tmp_path, **kw):
    cfg = _port_config(**kw)
    cfg.output_dir = str(tmp_path / "out")
    cfg.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.training.use_rl = False
    cfg.training.use_amp = False
    cfg.training.warmup_steps = 0
    cfg.training.learning_rate = 1e-3
    cfg.training.batch_size = 2
    return CaptioningTrainer(cfg, [None] * 2, [], None, device="cpu")


@pytest.mark.parametrize("encoder", ["clip", "resnet"])
def test_freeze_gives_zero_encoder_gradients(encoder, tmp_path):
    kw = dict(encoder=encoder, decoder="gpt2")
    trainer = _trainer(tmp_path, **kw)
    trainer.config.model.encoder.freeze = True
    trainer = CaptioningTrainer(trainer.config, [None] * 2, [], None,
                                device="cpu")
    seen = {}
    step = trainer.optimizer.step

    def capture(grads):
        seen.update(grads)
        return step(grads)

    trainer.optimizer.step = capture
    backbone = {f"model.{n}": p.detach().clone() for n, p in
                trainer.model.named_parameters()
                if n.startswith("encoder.backbone.")}
    stats = {n: b.clone() for n, b in trainer.model.named_buffers()}
    trainer.train_step(images_uint8(1), _captions(2),
                       torch.ones(2, 7, dtype=torch.int32))
    assert backbone
    for name, before in backbone.items():
        assert torch.count_nonzero(seen[name]) == 0, name
        after = trainer._named_params()[name].detach()
        if before.ndim > 1:  # decayed: lr * wd * p, no Adam step
            torch.testing.assert_close(after, before * (1 - 1e-3 * 0.01),
                                       rtol=1e-6, atol=0)
    assert any(torch.count_nonzero(g) for n, g in seen.items()
               if n.startswith("model.decoder."))
    for name, before in stats.items():  # BatchNorm on running statistics
        assert torch.equal(dict(trainer.model.named_buffers())[name], before)


@pytest.mark.parametrize("encoder", ["clip", "vit"])
def test_remat_gives_the_same_gradients(encoder):
    grads = []
    for remat in (False, True):
        cfg = _port_config(encoder=encoder, decoder="gpt2")
        cfg.model.encoder.remat = remat
        model = build_train_model(cfg, "cpu")
        out = model(torch.from_numpy(images_uint8(7)), _captions(8))
        out["logits"].float().square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


_WRAPPERS = [(encoders, "encoder_stack"), (gpt2, "beam_decode_stack"),
             (gpt2, "beam_decode_attention"),
             (gpt2, "beam_decode_attention_qkv"),
             (decoders, "beam_decode_attention"),
             (decoders, "beam_decode_attention_qkv"),
             (decoders, "cross_attention"), (attention, "additive_scores"),
             (attention, "sdpa"), (decoding, "lse_and_block_max")]


@contextlib.contextmanager
def _counting_wrappers():
    """Every kernel wrapper the models and the decode call, counted."""
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        for module, name in _WRAPPERS:
            fn = getattr(module, name)

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)

            mp.setattr(module, name, counted)
        yield calls


@pytest.mark.parametrize("family", [
    dict(encoder="clip", decoder="gpt2"),
    dict(encoder="vit", decoder="transformer"),
    dict(encoder="resnet", decoder="lstm", attention="soft",
         use_pallas=True),
    dict(encoder="resnet", decoder="lstm", attention="multi_head",
         use_pallas=True)], ids=lambda f: f"{f['encoder']}-{f['decoder']}-"
                                          f"{f.get('attention', '')}")
def test_training_step_reaches_no_kernel(family, tmp_path):
    # a vocabulary over 4096: beam search's candidate step takes the LSE
    trainer = _trainer(tmp_path, vocab=5000, **family)
    images = images_uint8(9)
    caps = _captions(10)
    mask = torch.ones(2, 7, dtype=torch.int32)
    with _counting_wrappers() as calls:
        trainer.train_step(images, caps, mask)
    assert calls == {}
    model = trainer.eval_state()
    with _counting_wrappers() as calls:
        trainer.eval_loss_step(model, images, caps, mask,
                               torch.ones(2, dtype=torch.bool))
        trainer.val_decode_step(model, images)
    assert calls.get("lse_and_block_max", 0) > 0
    if family["decoder"] == "gpt2":
        assert calls["encoder_stack"] == 2 and calls["beam_decode_stack"] > 0
    if family.get("use_pallas"):
        assert calls.get("additive_scores", 0) + calls.get("sdpa", 0) > 0


def test_remat_model_folds_the_encoder_in_eval():
    """``remat`` is a training memory option: a remat CLIP served from
    ``load_model`` still runs the encoder fold, and encodes as the same
    model without remat does, bit for bit."""
    images = torch.from_numpy(images_uint8(11))
    out = []
    for remat in (True, False):
        cfg = _port_config(encoder="clip", decoder="gpt2")
        cfg.model.encoder.remat = remat
        model = load_model(cfg, "cpu")
        with _counting_wrappers() as calls, torch.inference_mode():
            out.append(model.encoder(images)["features"])
        assert calls == {"encoder_stack": 1}, (remat, calls)
    assert torch.equal(out[0], out[1])


def test_rng_stream_and_fold_in_are_deterministic():
    from image_captioning_ml_project_tpu_torch.utils.rng import (RngStream,
                                                                 fold_in)

    a, b = RngStream(3), RngStream(3)
    seeds = [a.next_seed() for _ in range(4)]
    assert seeds == [b.next_seed() for _ in range(4)]
    assert len(set(seeds)) == 4 and all(0 <= x < 2 ** 63 for x in seeds)
    assert RngStream(4).next_seed() != RngStream(3).next_seed()
    draws = [torch.rand(3, generator=g) for g in RngStream(5).next_n(2)]
    again = [torch.rand(3, generator=g) for g in RngStream(5).next_n(2)]
    assert all(torch.equal(x, y) for x, y in zip(draws, again))
    assert not torch.equal(draws[0], draws[1])
    assert len({fold_in(1, step) for step in range(1000)}) == 1000
    assert fold_in(1, 5) == fold_in(1, 5) != fold_in(2, 5)


def test_lstm_inter_layer_dropout_only_when_asked():
    """``StackedLSTM`` drops between layers in training mode only with
    ``deterministic=False``, which the LSTM decoder, as the JAX one, never
    passes."""
    from image_captioning_ml_project_tpu_torch.models.lstm import StackedLSTM

    torch.manual_seed(0)
    lstm = StackedLSTM(6, 8, 3, rate=0.5).train()
    h, c, x = torch.randn(2, 3, 8), torch.randn(2, 3, 8), torch.randn(2, 6)
    with torch.no_grad():
        plain = lstm(h, c, x)
        with dropout_generator(torch.Generator().manual_seed(1)):
            dropped = lstm(h, c, x, deterministic=False)
        eval_out = lstm.eval()(h, c, x, deterministic=False)
    assert torch.equal(plain[0], eval_out[0])
    assert torch.equal(plain[0][:, 0], dropped[0][:, 0])  # first layer
    assert not torch.equal(plain[0][:, 1:], dropped[0][:, 1:])
