"""ResNet encoder (port: models/encoders.py ``ResNetEncoder``) against the
JAX package's, from the same weights and images made with numpy from a
seed: bottleneck and basic layers, even and odd image sizes (flax pads a
stride-2 convolution k // 2 on both sides, as torch does; a 1x1 stride-2
shortcut takes the same rows), and BatchNorm running statistics, scales and
biases drawn at random (all-0/1 statistics would hide a swapped mean and
variance or a cast statistic).

Tolerances: float32 1e-5 of the largest output magnitude (the
convolutions sum in another order); bfloat16 (JAX's cast-once serving
weights against the port's ``load_model`` cast) one bf16 ulp of it: both
round each convolution's output and each BatchNorm's f32 result to bf16
at the same places (they agree bit for bit on the CPU, where the bf16
encode itself is 0.6-0.8% from the f32 one)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.models.captioning_model import (
    ImageCaptioningModel)
from image_captioning_ml_project_tpu.utils.amp import (
    cast_float_params as jax_cast_float_params)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from image_captioning_ml_project_tpu_torch.models.encoders import (
    BatchNorm, ResNetEncoder)
from torch_port_helpers import bf16_ulp, both_models, jax_images

torch.set_num_threads(1)


def _randomised(variables, seed):
    """``variables`` with every BatchNorm's running mean ~ N(0, 0.5²),
    variance ~ U(0.5, 2), scale ~ 1 + N(0, 0.1²) and bias ~ N(0, 0.1²)."""
    rs = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map(np.array, variables)

    def walk(node, stats):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, stats)
            elif stats:
                node[key] = (rs.randn(*value.shape) * 0.5 if key == "mean"
                             else rs.uniform(0.5, 2.0, value.shape)
                             ).astype(np.float32)

    walk(tree["batch_stats"], True)
    enc = tree["params"]["encoder"]["backbone"]

    def norms(node):
        for key, value in node.items():
            if key == "normalization":
                value["scale"] = (1 + rs.randn(*value["scale"].shape) * 0.1
                                  ).astype(np.float32)
                value["bias"] = (rs.randn(*value["bias"].shape) * 0.1
                                 ).astype(np.float32)
            elif isinstance(value, dict):
                norms(value)

    norms(enc)
    return tree


def _models(layer_type, seed=0):
    cfg, model, variables, _ = both_models(
        seed, encoder="resnet", decoder="lstm", attention="soft",
        attention_heads=1, layer_type=layer_type)
    tree = _randomised(variables, seed + 5)
    return cfg, model, tree, load_model(cfg, "cpu", params=tree)


def _images(size, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (2, size, size, 3)).astype(np.uint8)


@pytest.mark.parametrize("layer_type", ["bottleneck", "basic"])
@pytest.mark.parametrize("size", [32, 33, 29], ids=["even", "odd",
                                                    "odd_small"])
def test_resnet_encoder_matches_jax(layer_type, size):
    cfg, model, tree, port = _models(layer_type)
    images = _images(size, size)
    want = model.apply(tree, jax_images(images), method=model.encode)
    with torch.inference_mode():
        got = port.encode(torch.from_numpy(images))
    side = -(-size // 8)  # stem /2, max-pool /2, one stride-2 stage
    for key in ("features", "pooled_features"):
        w = np.asarray(want[key])
        assert got[key].shape == w.shape
        np.testing.assert_allclose(got[key].numpy(), w,
                                   atol=1e-5 * np.abs(w).max(), rtol=0)
    assert got["features"].shape[1] == side * side
    assert got["attention_mask"].dtype == torch.bool
    assert bool(got["attention_mask"].all())


def test_resnet_encoder_in_bf16_matches_jax():
    cfg, _, tree, _ = _models("bottleneck")
    cfg = copy.deepcopy(cfg)
    cfg.model.dtype = "bfloat16"
    model = ImageCaptioningModel(cfg, dtype=jnp.bfloat16)
    port = load_model(cfg, "cpu", params=tree)
    images = _images(32, 4)
    want = model.apply(jax_cast_float_params(tree), jax_images(images),
                       method=model.encode)
    with torch.inference_mode():
        got = port.encode(torch.from_numpy(images))
    for key in ("features", "pooled_features"):
        w = np.asarray(want[key].astype(jnp.float32))
        assert got[key].dtype == torch.bfloat16
        err = np.abs(got[key].float().numpy() - w).max()
        assert err <= bf16_ulp(w), (key, err)


def test_batch_norm_uses_the_running_statistics_and_flax_arithmetic():
    """In eval mode, (x - mean) * (rsqrt(var + eps) * scale) + bias in
    f32, cast back; swapping the mean and the variance changes the
    output."""
    bn = BatchNorm(3).eval()
    rs = np.random.RandomState(1)
    with torch.no_grad():
        for t, v in ((bn.running_mean, rs.randn(3)),
                     (bn.running_var, rs.uniform(0.5, 2, 3)),
                     (bn.weight, rs.randn(3)), (bn.bias, rs.randn(3))):
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    x = torch.from_numpy(rs.randn(2, 3, 4, 5).astype(np.float32))
    c = (lambda t: t[None, :, None, None])
    want = (x - c(bn.running_mean)) * (
        torch.rsqrt(c(bn.running_var) + 1e-5) * c(bn.weight)) + c(bn.bias)
    torch.testing.assert_close(bn(x), want, atol=0, rtol=0)
    y = bn(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    with torch.no_grad():
        bn.running_mean, bn.running_var = bn.running_var, bn.running_mean
    assert not torch.allclose(bn(x), want)


def test_channels_last_weights_and_encoder_layout():
    """The convolution weights are kept channels_last; the encoder takes
    NHWC uint8 images as the JAX one does and gives B x (H'W') x D."""
    _, _, _, port = _models("bottleneck")
    assert isinstance(port.encoder, ResNetEncoder)
    convs = [m.weight for m in port.encoder.modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert convs and all(
        w.is_contiguous(memory_format=torch.channels_last) for w in convs)
    with torch.inference_mode():
        out = port.encode(torch.zeros((1, 40, 24, 3), dtype=torch.uint8))
    assert out["features"].shape == (1, 5 * 3, 64)
    assert out["pooled_features"].shape == (1, 64)
