"""CLIP vision tower (port: models/encoders.py) against the JAX package's
``model.encode`` on the same weights and images: features and pooled
features to atol 1e-4 at f32, on the port's default encoder fold against
the JAX XLA layer loop and against the JAX whole-stack kernel
(``ICT_ENCODER_FOLD=force``), and on the per-layer modules. Also that
``ICT_ENCODER_FOLD`` routes the port's encode as it routes the JAX
package's."""

import numpy as np
import pytest
import torch

import image_captioning_ml_project_tpu.ops.pallas_encoder as jax_pe
import image_captioning_ml_project_tpu_torch.models.encoders as port_enc
from image_captioning_ml_project_tpu_torch.data.coco import normalize_images
from image_captioning_ml_project_tpu_torch.models.encoders import quick_gelu
from torch_port_helpers import both_models, images_uint8, jax_images

torch.set_num_threads(1)


@pytest.mark.parametrize("fused_qkv,feature_dim", [
    (False, 64), (True, 64), (False, 48)],
    ids=["unfused_qkv", "fused_qkv", "projected"])
@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float"])
def test_encode_matches_jax(fused_qkv, feature_dim, uint8):
    _, model, variables, port = both_models(3, fused_qkv=fused_qkv,
                                            feature_dim=feature_dim)
    imgs = images_uint8(5, n=3)
    jimgs = jax_images(imgs)
    want = model.apply(variables, jimgs, method=model.encode)
    x = torch.from_numpy(imgs) if uint8 else torch.from_numpy(
        np.array(jimgs))
    with torch.inference_mode():
        got = port.encode(x)
    assert got["features"].shape == (3, 4, feature_dim)
    for key in ("features", "pooled_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=0, err_msg=key)
    assert got["attention_mask"].all() and got["attention_mask"].shape == (3, 4)


def test_normalize_and_quick_gelu():
    from image_captioning_ml_project_tpu.data.coco import (
        normalize_images as jax_normalize)

    imgs = images_uint8(0)
    np.testing.assert_allclose(normalize_images(torch.from_numpy(imgs)),
                               np.asarray(jax_normalize(imgs)), rtol=1e-6)
    x = torch.linspace(-6, 6, 101)
    np.testing.assert_allclose(quick_gelu(x), x * torch.sigmoid(1.702 * x))


@pytest.mark.parametrize("port_fold", ["1", "0"])
@pytest.mark.parametrize("fused_qkv", [False, True],
                         ids=["unfused_qkv", "fused_qkv"])
def test_encode_against_jax_encoder_fold(fused_qkv, port_fold, monkeypatch):
    """JAX with its whole-stack encoder kernel forced on (interpret mode)
    against the port with its fold on (plain version) and off (per-layer
    modules)."""
    _, model, variables, port = both_models(3, fused_qkv=fused_qkv)
    imgs = images_uint8(6, n=3)
    monkeypatch.setenv("ICT_ENCODER_FOLD", "force")
    want = model.apply(variables, jax_images(imgs), method=model.encode)
    monkeypatch.setenv("ICT_ENCODER_FOLD", port_fold)
    with torch.inference_mode():
        got = port.encode(torch.from_numpy(imgs))
    for key in ("features", "pooled_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=0, err_msg=key)


@pytest.mark.parametrize("mode,folds", [("force", True), ("1", True),
                                        ("0", False)])
def test_encoder_fold_switch_routes_as_in_jax(mode, folds, monkeypatch):
    """Spy on both packages' encoder kernels: ``force`` and ``0`` route the
    port as they route JAX here; ``1`` (the default) folds in the port as
    it folds in the JAX package on its own device (the JAX package folds
    on the CPU only when forced). Training mode never folds."""
    _, model, variables, port = both_models(3)
    imgs = images_uint8(7)
    calls = []
    for module, name in ((jax_pe, "fused_encoder_stack"),
                         (port_enc, "encoder_stack")):
        real = getattr(module, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)
    monkeypatch.setenv("ICT_ENCODER_FOLD", mode)
    model.apply(variables, jax_images(imgs), method=model.encode)
    with torch.inference_mode():
        port.encode(torch.from_numpy(imgs))
    assert ("encoder_stack" in calls) == folds
    if mode != "1":
        assert ("fused_encoder_stack" in calls) == folds
    calls.clear()
    port.train()
    try:
        with torch.no_grad():
            port.encode(torch.from_numpy(imgs))
    finally:
        port.eval()
    assert calls == []
