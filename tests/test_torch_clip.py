"""CLIP vision tower (port: models/encoders.py) against the JAX package's
``model.encode`` on the same weights and images: features and pooled
features to atol 1e-4 at f32."""

import numpy as np
import pytest
import torch

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
