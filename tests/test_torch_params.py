"""Weight bridge (port: params.py) and the bf16 cast policy (port:
utils/amp.py), for every ported family (CLIP, ViT and ResNet encoders,
GPT-2, Transformer and LSTM decoders with each attention variant): every
flax leaf is mapped, the ResNet's ``batch_stats`` included, an extra or a
missing leaf raises, the seeded initialisation has the flax layout, and
norms (and BatchNorm statistics) stay f32 under the cast. The layer-stacked weights of the whole-stack kernels
equal the JAX package's (``_stacked_weights`` and the encoder fold's
stack), and the Transformer decoder's concatenated QKV equals what the JAX
fold hands its kernel; all are the model's parameters, not copies."""

import copy

import jax
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.utils.amp import (
    cast_float_params as jax_cast_float_params)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    ImageCaptioningModel, load_model)
from image_captioning_ml_project_tpu_torch.models.encoders import BatchNorm
from image_captioning_ml_project_tpu_torch.models.layers import LayerNorm
from image_captioning_ml_project_tpu_torch.params import (from_flax,
                                                          init_flax_params)
from image_captioning_ml_project_tpu_torch.utils.amp import cast_float_params
from torch_port_helpers import both_models, images_uint8, jax_images, \
    tiny_config

torch.set_num_threads(1)


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _flax_leaf_count(variables):
    return len(jax.tree_util.tree_leaves(variables))


_VIT_TRANSFORMER = {"encoder": "vit", "decoder": "transformer"}


def _lstm(attention="soft", heads=1, **kw):
    return dict(encoder="resnet", decoder="lstm", attention=attention,
                attention_heads=heads, **kw)


_LSTM_CONFIGS = [_lstm(), _lstm("multi_head", 4), _lstm("adaptive", 1),
                 _lstm("adaptive", 4), _lstm("aoa", 1), _lstm("aoa", 4),
                 _lstm(layer_type="basic")]
_LSTM_IDS = ["resnet_lstm_soft", "resnet_lstm_multi_head",
             "resnet_lstm_adaptive_soft", "resnet_lstm_adaptive_mha",
             "resnet_lstm_aoa_soft", "resnet_lstm_aoa_mha",
             "resnet_basic_lstm"]


@pytest.mark.parametrize("config", [
    {}, {"fused_qkv": True}, {"feature_dim": 48}, _VIT_TRANSFORMER,
    dict(_VIT_TRANSFORMER, fused_qkv=True, feature_dim=48),
    {"encoder": "vit"}] + _LSTM_CONFIGS,
    ids=["default", "fused_qkv", "projected", "vit_transformer",
         "vit_transformer_fused", "vit_gpt2"] + _LSTM_IDS)
def test_every_flax_leaf_maps_to_every_model_tensor(config):
    cfg, _, variables, _ = both_models(0, **config)
    sd = from_flax(variables)
    with torch.device("meta"):
        model = ImageCaptioningModel(cfg)
    assert set(sd) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        assert sd[name].shape == tensor.shape, name
    # every flax leaf lands in the state dict (q/k/v leaves merge into one
    # qkv tensor per layer: 6 flax leaves -> 2 torch tensors; the ResNet
    # has none, and its batch_stats become buffers one for one)
    merged = (0 if config.get("fused_qkv") or config.get("encoder") ==
              "resnet" else 4 * cfg.model.encoder.num_layers)
    assert len(sd) == _flax_leaf_count(variables) - merged


def test_extra_leaf_raises():
    tree = copy.deepcopy(_np_tree(both_models(0)[2]))
    tree["params"]["decoder"]["backbone"]["block_0"]["extra"] = {
        "kernel": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="unmapped flax leaves.*extra"):
        from_flax(tree)


@pytest.mark.parametrize("config,path", [
    ({}, ("encoder", "backbone", "layer_1", "fc2", "bias")),
    ({}, ("decoder", "backbone", "block_0", "attn", "c_proj", "kernel")),
    ({}, ("decoder", "image_prefix")),
    (_VIT_TRANSFORMER, ("encoder", "backbone", "pooler", "kernel")),
    (_VIT_TRANSFORMER, ("encoder", "backbone", "patch_embed", "bias")),
    (_VIT_TRANSFORMER, ("decoder", "layer_1", "cross_attn", "k_proj",
                        "bias")),
    (_VIT_TRANSFORMER, ("decoder", "visual_projection", "kernel")),
    (_lstm(), ("batch_stats", "encoder", "backbone", "stage_1_layer_0",
               "shortcut", "normalization", "var")),
    (_lstm(), ("encoder", "backbone", "embedder", "normalization", "scale")),
    (_lstm(), ("encoder", "backbone", "stage_0_layer_0", "layer_1",
               "convolution", "kernel")),
    (_lstm(), ("decoder", "lstm", "cell_1", "gates", "bias")),
    (_lstm(), ("decoder", "attention", "energy", "kernel")),
    (_lstm(), ("decoder", "init_c", "kernel")),
    (_lstm("adaptive", 4), ("decoder", "attention", "sentinel_proj", "bias")),
    (_lstm("adaptive", 4), ("decoder", "attention", "base_attention",
                            "value_proj", "kernel")),
    (_lstm("aoa", 1), ("decoder", "attention", "info_vector_proj",
                       "kernel")),
])
def test_missing_leaf_raises(config, path):
    tree = copy.deepcopy(_np_tree(both_models(0, **config)[2]))
    node = tree if path[0] == "batch_stats" else tree["params"]
    for key in path[:-1]:
        node = node[key]
    del node[path[-1]]
    with pytest.raises(KeyError, match=path[-1]):
        from_flax(tree)


@pytest.mark.parametrize("config", [
    {}, {"feature_dim": 48}, _VIT_TRANSFORMER,
    dict(_VIT_TRANSFORMER, feature_dim=48), {"encoder": "vit"}]
    + _LSTM_CONFIGS,
    ids=["default", "projected", "vit_transformer",
         "vit_transformer_projected", "vit_gpt2"] + _LSTM_IDS)
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


def test_batch_stats_map_to_running_statistics():
    """Random running means and variances land in the right BatchNorm
    buffers, mean to mean and variance to variance, and a bare params tree
    (no batch_stats) is refused."""
    tree = copy.deepcopy(_np_tree(both_models(0, **_lstm())[2]))
    rs = np.random.RandomState(3)
    stats = tree["batch_stats"]["encoder"]["backbone"]["stage_1_layer_1"][
        "layer_2"]["normalization"]
    stats["mean"] = rs.randn(*stats["mean"].shape).astype(np.float32)
    stats["var"] = rs.uniform(0.5, 2, stats["var"].shape).astype(np.float32)
    sd = from_flax(tree)
    name = "encoder.backbone.stages.1.1.layer_2.normalization"
    np.testing.assert_array_equal(sd[f"{name}.running_mean"].numpy(),
                                  stats["mean"])
    np.testing.assert_array_equal(sd[f"{name}.running_var"].numpy(),
                                  stats["var"])
    conv = tree["params"]["encoder"]["backbone"]["embedder"]["convolution"]
    np.testing.assert_array_equal(
        sd["encoder.backbone.embedder.convolution.weight"].numpy(),
        conv["kernel"].transpose(3, 2, 0, 1))
    with pytest.raises(KeyError, match="batch_stats"):
        from_flax(tree["params"])


def test_cast_keeps_batch_norms_f32_like_jax():
    """In a bf16 ResNet + LSTM model the BatchNorm scales, biases and
    running statistics stay f32 with the tree's values, every other
    parameter is bf16, and the JAX policy keeps the same leaves f32 (norm
    dicts and the batch_stats collection)."""
    cfg, _, variables, _ = both_models(0, **_lstm("aoa", 4))
    cfg = copy.deepcopy(cfg)
    cfg.model.dtype = "bfloat16"
    tree = copy.deepcopy(_np_tree(variables))
    rs = np.random.RandomState(4)
    stats = tree["batch_stats"]["encoder"]["backbone"]["embedder"][
        "normalization"]
    stats["var"] = rs.uniform(0.5, 2, stats["var"].shape).astype(np.float32)
    model = load_model(cfg, "cpu", params=tree)
    bn = model.encoder.backbone.embedder.normalization
    np.testing.assert_array_equal(bn.running_var.numpy(), stats["var"])
    n_bn = 0
    for module in model.modules():
        if isinstance(module, BatchNorm):
            n_bn += 1
            assert {t.dtype for t in (module.weight, module.bias,
                                      module.running_mean,
                                      module.running_var)} == {torch.float32}
        else:
            for p in module.parameters(recurse=False):
                assert p.dtype == torch.bfloat16
    kept = [p for p, x in jax.tree_util.tree_leaves_with_path(
        jax_cast_float_params(variables)) if x.dtype == np.float32]
    assert len(kept) == 4 * n_bn


_MATRICES = ("wqkv", "wo", "wfc", "wpj")


def _assert_stack_equal(port_stack, jax_stack):
    assert set(port_stack) == set(jax_stack)
    for key, want in jax_stack.items():
        want = np.asarray(want)
        if key in _MATRICES:  # flax [L, in, out]; port nn.Linear [L, out, in]
            want = want.transpose(0, 2, 1)
        np.testing.assert_array_equal(port_stack[key].float().numpy(),
                                      want.astype(np.float32), err_msg=key)


@pytest.mark.parametrize("fused_qkv", [False, True],
                         ids=["unfused_qkv", "fused_qkv"])
def test_stacked_weights_equal_jax(fused_qkv, monkeypatch):
    """The decoder stack equals JAX's ``_stacked_weights()``; the encoder
    stack equals what JAX's ``_fold_forward`` hands its kernel (q/k/v
    concatenated); each layer's parameter is a view of its slice."""
    _, model, variables, port = both_models(0, fused_qkv=fused_qkv)
    _assert_stack_equal(port.decoder.stack, model.apply(
        variables, method=lambda m: m.decoder._stacked_weights()))

    import image_captioning_ml_project_tpu.ops.pallas_encoder as pe

    seen = []
    real = pe.fused_encoder_stack
    monkeypatch.setattr(pe, "fused_encoder_stack",
                        lambda x, stack, *a, **k: (seen.append(stack),
                                                   real(x, stack, *a,
                                                        **k))[1])
    monkeypatch.setenv("ICT_ENCODER_FOLD", "force")
    model.apply(variables, jax_images(images_uint8(0)), method=model.encode)
    _assert_stack_equal(port.encoder.backbone.stack, seen[0])

    block = port.decoder.backbone.blocks[1]
    assert block.mlp.c_fc.weight.data_ptr() == \
        port.decoder.stack["wfc"][1].data_ptr()
    layer = port.encoder.backbone.layers[1]
    assert layer.layer_norm2.bias.data_ptr() == \
        port.encoder.backbone.stack["b2"][1].data_ptr()


def test_stacked_weights_follow_the_cast():
    """In a bf16 model the stacked matrices and biases are bf16 and the
    LayerNorm scales and biases stay f32, as JAX's ``_stacked_weights``
    keeps them."""
    cfg, _, variables, _ = both_models(0)
    cfg = copy.deepcopy(cfg)
    cfg.model.dtype = "bfloat16"
    port = load_model(cfg, "cpu", params=variables)
    for stack in (port.decoder.stack, port.encoder.backbone.stack):
        for key, t in stack.items():
            want = (torch.float32 if key in ("g1", "b1", "g2", "b2")
                    else torch.bfloat16)
            assert t.dtype == want and t.is_contiguous(), key
    assert port.decoder.stack["wqkv"].shape == (2, 192, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_qkv_is_one_tensor_of_views(dtype):
    """Each Transformer layer's self-attention q/k/v weights and biases are
    views of one [3H, H] / [3H] tensor in the working dtype, equal to the
    concatenation the JAX fold hands its kernel."""
    cfg, _, variables, _ = both_models(0, **_VIT_TRANSFORMER)
    cfg = copy.deepcopy(cfg)
    cfg.model.dtype = dtype
    port = load_model(cfg, "cpu", params=variables)
    H = cfg.model.decoder.hidden_dim
    tree = variables["params"]["decoder"]
    for i, layer in enumerate(port.decoder.layers):
        sa = layer.self_attn
        assert sa.wqkv.shape == (3 * H, H) and sa.bqkv.shape == (3 * H,)
        assert sa.wqkv.dtype == sa.bqkv.dtype == getattr(torch, dtype)
        item = sa.wqkv.element_size()
        for j, proj in enumerate((sa.q_proj, sa.k_proj, sa.v_proj)):
            assert proj.weight.data_ptr() == \
                sa.wqkv.data_ptr() + j * H * H * item
            assert proj.bias.data_ptr() == sa.bqkv.data_ptr() + j * H * item
        jax_sa = tree[f"layer_{i}"]["self_attn"]
        want = np.concatenate([np.asarray(jax_sa[n]["kernel"])
                               for n in ("q_proj", "k_proj", "v_proj")],
                              axis=1).T
        np.testing.assert_array_equal(
            sa.wqkv.float().numpy(),
            torch.from_numpy(want).to(sa.wqkv.dtype).float().numpy())
