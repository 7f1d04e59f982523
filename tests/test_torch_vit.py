"""ViT encoder (port: models/encoders.py) against the JAX package's
``model.encode`` on the same weights and images: features (patch tokens
after the final LayerNorm, CLS dropped) and pooled features (tanh pooler
on CLS), to atol 1e-4 at f32 (the same sums in another order; 2 layers of
width 64). Also the encoder factory's dispatch."""

import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu_torch.config import (EncoderType,
                                                          get_default_config)
from image_captioning_ml_project_tpu_torch.models.encoders import (
    ViTEncoder, build_encoder)
from torch_port_helpers import both_models, images_uint8, jax_images

torch.set_num_threads(1)


@pytest.mark.parametrize("fused_qkv,feature_dim", [
    (False, 64), (True, 64), (False, 48)],
    ids=["unfused_qkv", "fused_qkv", "projected"])
@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float"])
def test_vit_encode_matches_jax(fused_qkv, feature_dim, uint8):
    _, model, variables, port = both_models(
        4, encoder="vit", decoder="transformer", fused_qkv=fused_qkv,
        feature_dim=feature_dim)
    assert isinstance(port.encoder, ViTEncoder)
    imgs = images_uint8(8, n=3)
    jimgs = jax_images(imgs)
    want = model.apply(variables, jimgs, method=model.encode)
    x = torch.from_numpy(imgs) if uint8 else torch.from_numpy(
        np.array(jimgs))
    with torch.inference_mode():
        got = port.encode(x)
    assert got["features"].shape == (3, 4, feature_dim)
    assert got["pooled_features"].shape == (3, feature_dim)
    for key in ("features", "pooled_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=0, err_msg=key)
    assert got["attention_mask"].all() and got["attention_mask"].shape == (3, 4)


def test_vit_backbone_uses_its_patch_bias_and_position_table():
    """The patch embedding's bias reaches every patch token, and the
    position table has one row per patch plus CLS."""
    port = both_models(4, encoder="vit", decoder="transformer")[3]
    bb = port.encoder.backbone
    assert bb.position_embeddings.shape == (1, 5, 64)
    assert bb.patch_embed.bias is not None
    x = torch.zeros((1, 32, 32, 3))
    with torch.inference_mode():
        y = bb.patch_embed(x)
    torch.testing.assert_close(y.reshape(4, 64),
                               bb.patch_embed.bias.expand(4, 64))


@pytest.mark.parametrize("encoder", ["swin", "object_region", "convnext",
                                     "efficientnet"])
def test_other_encoders_name_their_roadmap_item(encoder):
    """Swin and the object-region encoder are built (ROADMAP.md Queue 1
    item 10, done); ConvNeXt and EfficientNet, which the JAX package's
    ``build_encoder`` refuses too, raise its ``ValueError``; and
    ``use_object_features`` picks the object-region encoder whatever the
    encoder type, checked first as the JAX factory checks it."""
    from image_captioning_ml_project_tpu.models.encoders import (
        build_encoder as jax_build_encoder)
    from image_captioning_ml_project_tpu_torch.models.encoders import (
        ObjectRegionEncoder)
    from image_captioning_ml_project_tpu_torch.models.swin import SwinEncoder

    cfg = get_default_config().model.encoder
    cfg.encoder_type = EncoderType(encoder)
    if encoder in ("convnext", "efficientnet"):
        with pytest.raises(ValueError, match="Unsupported encoder type"):
            jax_build_encoder(cfg)
        with pytest.raises(ValueError, match="Unsupported encoder type"):
            build_encoder(cfg, 224)
    else:
        with torch.device("meta"):
            built = build_encoder(cfg, 224)
        assert isinstance(built, SwinEncoder if encoder == "swin"
                          else ObjectRegionEncoder)
    cfg.use_object_features = True
    with torch.device("meta"):
        assert isinstance(build_encoder(cfg, 224), ObjectRegionEncoder)
