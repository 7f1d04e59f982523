"""The uint8 patch-embed fold (``fold_normalize``; port:
models/encoders.py ``PatchEmbed``) against the JAX package's on the CPU:
given uint8 pixels the patch embed scales each input channel's weight
columns by 1 / (255 std_c) and adds the folded shift as a token bias, for
ViT's embed (with its bias) and CLIP's (bias-free): f32 within 1e-5
relative of JAX's fold, bf16 (weights cast first, as a served model's
are) within 2 bf16 ulps of its largest output. And the whole path: a ViT
or CLIP captioning model built with ``fold_normalize`` takes uint8 images
to the fold (encode within 1e-5 relative of the JAX model handed uint8
under its fold), one without it normalises them first, and the two agree
at f32 to 1e-5 relative: the fold changes the rounding only."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.models.encoders import (
    PatchEmbed as JaxPatchEmbed)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from image_captioning_ml_project_tpu_torch.models.encoders import PatchEmbed
from torch_port_helpers import (both_models, bf16_ulp, images_uint8,
                                jax_images)

torch.set_num_threads(1)

H, P = 24, 8


def _pair(use_bias):
    jpe = JaxPatchEmbed(H, P, use_bias=use_bias)
    params = jpe.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, 3), jnp.uint8))["params"]
    rs = np.random.RandomState(1)
    kernel = rs.randn(P, P, 3, H).astype(np.float32) * 0.05
    params = dict(params, kernel=jnp.asarray(kernel))
    port = PatchEmbed(H, P, use_bias=use_bias)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.reshape(-1, H).T.copy()))
        if use_bias:
            bias = rs.randn(H).astype(np.float32)
            params["bias"] = jnp.asarray(bias)
            port.bias.copy_(torch.from_numpy(bias))
    return jpe, params, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_bias", [True, False], ids=["vit", "clip"])
def test_patch_embed_fold_matches_jax(use_bias, dtype):
    jpe, params, port = _pair(use_bias)
    images = np.random.RandomState(2).randint(
        0, 256, (2, 20, 17, 3)).astype(np.uint8)   # a VALID remainder
    if dtype == "bfloat16":
        jpe = JaxPatchEmbed(H, P, use_bias=use_bias, dtype=jnp.bfloat16)
        params = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16),
                                        params)
        port = port.to(torch.bfloat16)
    want = np.asarray(jpe.apply({"params": params},
                                jnp.asarray(images)).astype(jnp.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(images)).float().numpy()
    assert got.shape == want.shape == (2, 2, 2, H)
    tol = (1e-5 * np.abs(want).max() if dtype == "float32"
           else 2 * bf16_ulp(want))
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("encoder", ["vit", "clip"])
def test_models_fold_uint8_as_the_jax_trainer_hands_it(encoder):
    cfg, model, variables, plain = both_models(0, encoder=encoder,
                                               decoder="transformer")
    fcfg = copy.deepcopy(cfg)
    fcfg.fold_normalize = True
    folded = load_model(fcfg, "cpu", params=variables)
    assert folded.encoder.fold_normalize and not plain.encoder.fold_normalize
    images = images_uint8(3)
    want = np.asarray(model.apply(variables, jnp.asarray(images),
                                  method=model.encode)["features"])
    with torch.no_grad():
        got = folded.encode(torch.from_numpy(images))["features"].numpy()
        normalised = plain.encode(torch.from_numpy(images))[
            "features"].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    ref = np.asarray(model.apply(variables, jax_images(images),
                                 method=model.encode)["features"])
    assert np.abs(normalised - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(got - normalised).max() <= 1e-5 * np.abs(ref).max()
