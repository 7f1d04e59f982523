"""Weight bridge (port: params.py) and the bf16 cast policy (port:
utils/amp.py): every flax leaf is mapped, an extra or a missing leaf
raises, the seeded initialisation has the flax layout, and norms stay f32
under the cast."""

import copy

import jax
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.utils.amp import (
    cast_float_params as jax_cast_float_params)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    ImageCaptioningModel, load_model)
from image_captioning_ml_project_tpu_torch.models.layers import LayerNorm
from image_captioning_ml_project_tpu_torch.params import (from_flax,
                                                          init_flax_params)
from image_captioning_ml_project_tpu_torch.utils.amp import cast_float_params
from torch_port_helpers import both_models, tiny_config

torch.set_num_threads(1)


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _flax_leaf_count(variables):
    return len(jax.tree_util.tree_leaves(variables))


@pytest.mark.parametrize("config", [{}, {"fused_qkv": True},
                                    {"feature_dim": 48}],
                         ids=["default", "fused_qkv", "projected"])
def test_every_flax_leaf_maps_to_every_model_tensor(config):
    cfg, _, variables, _ = both_models(0, **config)
    sd = from_flax(variables)
    with torch.device("meta"):
        model = ImageCaptioningModel(cfg)
    assert set(sd) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        assert sd[name].shape == tensor.shape, name
    # every flax leaf lands in the state dict (q/k/v leaves merge into one
    # qkv tensor per layer: 6 flax leaves -> 2 torch tensors)
    merged = 0 if config.get("fused_qkv") else 4 * cfg.model.encoder.num_layers
    assert len(sd) == _flax_leaf_count(variables) - merged


def test_extra_leaf_raises():
    tree = copy.deepcopy(_np_tree(both_models(0)[2]))
    tree["params"]["decoder"]["backbone"]["block_0"]["extra"] = {
        "kernel": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="unmapped flax leaves.*extra"):
        from_flax(tree)


@pytest.mark.parametrize("path", [
    ("encoder", "backbone", "layer_1", "fc2", "bias"),
    ("decoder", "backbone", "block_0", "attn", "c_proj", "kernel"),
    ("decoder", "image_prefix"),
])
def test_missing_leaf_raises(path):
    tree = copy.deepcopy(_np_tree(both_models(0)[2]))
    node = tree["params"]
    for key in path[:-1]:
        node = node[key]
    del node[path[-1]]
    with pytest.raises(KeyError, match=path[-1]):
        from_flax(tree)


@pytest.mark.parametrize("config", [{}, {"feature_dim": 48}],
                         ids=["default", "projected"])
def test_seeded_init_has_the_flax_layout(config):
    cfg, _, variables, _ = both_models(0, **config)
    got = jax.tree_util.tree_map(lambda x: (x.shape, x.dtype),
                                 init_flax_params(cfg, 0))
    want = jax.tree_util.tree_map(lambda x: (x.shape, np.dtype(x.dtype)),
                                  variables)
    assert got == want


def test_seeded_load_is_deterministic_and_seed_dependent():
    cfg = tiny_config()
    a = load_model(cfg, "cpu").state_dict()
    b = load_model(cfg, "cpu").state_dict()
    cfg.seed += 1
    c = load_model(cfg, "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.backbone.wte.weight"],
                           c["decoder.backbone.wte.weight"])


def test_cast_float_params_keeps_norms_f32_like_jax():
    cfg, _, variables, _ = both_models(0)
    cfg = copy.deepcopy(cfg)
    cfg.model.dtype = "bfloat16"
    model = load_model(cfg, "cpu", params=variables)
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            want = (torch.float32 if isinstance(module, LayerNorm)
                    else torch.bfloat16)
            assert p.dtype == want, (module, name)
    # the JAX policy keeps the same leaves f32: LayerNorm scale/bias only
    jax_cast = jax_cast_float_params(variables)
    kept = [p for p, x in jax.tree_util.tree_leaves_with_path(jax_cast)
            if x.dtype == np.float32]
    assert kept and all(jax.tree_util.keystr(p).endswith(("['scale']",
                                                          "['bias']"))
                        for p in kept)
    n_norm = sum(isinstance(m, LayerNorm) for m in model.modules())
    assert len(kept) == 2 * n_norm
    assert cast_float_params(model) is model
