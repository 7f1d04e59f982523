"""Swin (port: models/swin.py) against the JAX package's ``models/swin.py``
on the CPU: window partition and reverse round-trip; the relative position
index and the shift mask equal to JAX's; the encoder's features and
pooled features of a two-stage Swin at f32 within 1e-5 relative on a grid
that needs padding (10 x 10 tokens under windows of 3: padded to 12 in the
layers, merged with a pad to 5 x 5, where the second stage's window of 3
still shifts) and on one the windows tile (window 5: the first stage's
blocks shift, the second's 5 x 5 grid is one window, so they do not);
and in bf16, where the relative position bias table stays float32 (the
JAX policy's raw f32 leaf), the features within 4 bf16 ulps of the
largest of the JAX bf16 model's, while a table rounded to bf16 moves one
window attention's output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.models import swin as jax_swin
from image_captioning_ml_project_tpu.models.captioning_model import (
    ImageCaptioningModel)
from image_captioning_ml_project_tpu.utils.amp import (
    cast_float_params as jax_cast)
from image_captioning_ml_project_tpu_torch.models import swin
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from image_captioning_ml_project_tpu_torch.params import init_flax_params
from image_captioning_ml_project_tpu_torch.utils.amp import (
    castable_parameters)
from torch_port_helpers import (bf16_ulp, family_config, family_inputs,
                                jax_inputs, port_config, port_inputs)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,w", [((2, 6, 6, 5), 3), ((1, 14, 14, 4), 7),
                                     ((3, 4, 4, 2), 4)])
def test_window_partition_round_trips(shape, w):
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape)
                         .astype(np.float32))
    parts = swin.window_partition(x, w)
    B, H, W, C = shape
    assert parts.shape == (B * (H // w) * (W // w), w * w, C)
    np.testing.assert_array_equal(
        parts.numpy(), np.asarray(jax_swin.window_partition(
            jnp.asarray(x.numpy()), w)))
    assert torch.equal(swin.window_reverse(parts, w, B, H, W), x)


@pytest.mark.parametrize("H,w,shift", [(12, 3, 1), (14, 7, 3), (8, 4, 2)])
def test_shift_mask_and_index_equal_jax(H, w, shift):
    np.testing.assert_array_equal(swin._shift_attn_mask(H, H, w, shift),
                                  jax_swin._shift_attn_mask(H, H, w, shift))
    np.testing.assert_array_equal(swin._relative_position_index(w),
                                  jax_swin._relative_position_index(w))
    assert set(np.unique(swin._shift_attn_mask(H, H, w, shift))) == {
        0.0, -100.0}


def _models(window, dtype="float32"):
    cfg = family_config("swin")
    cfg.model.encoder.swin_window_size = window
    cfg.model.dtype = dtype
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  init_flax_params(port_config(cfg), 3))
    model = ImageCaptioningModel(
        cfg, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return cfg, model, tree, load_model(cfg, "cpu", params=tree)


def _encode(cfg, model, tree, port, seed):
    x = family_inputs(cfg, seed)
    want = model.apply(tree, jax_inputs(x), method=model.encode)
    with torch.no_grad():
        got = port.encode(port_inputs(x))
    return got, want


@pytest.mark.parametrize("window", [3, 5], ids=["padded", "tiled"])
def test_encoder_matches_jax_at_f32(window):
    cfg, model, tree, port = _models(window)
    # the second stage's layers: shifted or not as JAX decides
    stage = port.encoder.backbone.stages[1]
    assert [layer.shift for layer in stage] == ([0, 1] if window == 3
                                                else [0, 0])
    got, want = _encode(cfg, model, tree, port, 21)
    for key in ("features", "pooled_features"):
        a, b = got[key].numpy(), np.asarray(want[key])
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), key
    assert got["attention_mask"].all() and got["attention_mask"].shape == (
        2, 25)


def test_bf16_keeps_the_bias_table_f32():
    cfg, model, tree, port = _models(3, "bfloat16")
    tables = [n for n, _ in port.named_parameters()
              if n.endswith("relative_position_bias_table")]
    assert len(tables) == 4
    assert not set(tables) & set(castable_parameters(port))
    assert all(port.get_parameter(n).dtype == torch.float32 for n in tables)
    assert port.encoder.backbone.stages[0][0].attention.query.weight.dtype \
        == torch.bfloat16
    got, want = _encode(cfg, model, jax_cast(tree), port, 22)
    ref = np.asarray(want["features"].astype(jnp.float32))
    err = np.abs(got["features"].float().numpy() - ref).max()
    assert err <= 4 * bf16_ulp(ref), (err, bf16_ulp(ref))

    # a bf16 table would give other scores: one window attention moves
    attn = port.encoder.backbone.stages[0][0].attention
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 9, 16)
                         .astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        kept = attn(x)
        table = attn.relative_position_bias_table.data
        attn.relative_position_bias_table.data = (
            table.to(torch.bfloat16).float())
        rounded = attn(x)
        attn.relative_position_bias_table.data = table
    assert not torch.equal(kept, rounded)
