"""The port's HF converters (``image_captioning_ml_project_tpu_torch.
models.hf_port``) held against the JAX package's ``models.hf_port`` and
against HF's own models, on the CPU:

* bridge parity: for each family (CLIP vision, GPT-2, ViT, Swin, ResNet) a
  tiny random HF model, at the JAX tests' sizes, converted by the port
  equals, leaf for leaf and bit for bit, ``params.from_flax`` of a flax
  tree whose backbone is the JAX converter's output (numpy only: no JAX
  compile);
* forward parity: the port's backbone, built through ``load_model`` from
  the converted weights, gives HF's outputs at f32 within 1e-4 absolute
  and relative (Swin also at image size 40: window padding, an odd
  merge);
* full width: the five published configurations (CLIP ViT-B/32, GPT-2
  124M, ViT-B/16, Swin-B, ResNet-101), built by transformers on the
  ``meta`` device: every HF key mapped or dropped by name, the fragment
  loaded ``strict`` into the port's full-width module, also on ``meta``;
  ``chip_smoke.py``'s HF-layout helper has HF's names and shapes;
* strictness: an unknown key, a missing one and an untied GPT-2 head
  raise; the dropped buffers and GPT-2 without ``transformer.`` convert;
* end to end: a tiny flagship (CLIP vision + GPT-2) built from HF weights
  through the port's converters and through the JAX package's decodes
  token-identical at f32.

HF weights are HF's initialisation plus N(0, 0.05²) on every float
tensor (biases and BatchNorm statistics included, running variances
U(0.5, 1.5)), so that a mapping which mixes up two tensors shows."""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
import transformers

from image_captioning_ml_project_tpu.inference.decoding import (
    beam_search as jax_beam_search)
from image_captioning_ml_project_tpu.models import hf_port as jax_hf_port
from image_captioning_ml_project_tpu_torch import main as port_main
from image_captioning_ml_project_tpu_torch.config import EncoderType
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    beam_search)
from image_captioning_ml_project_tpu_torch.models import hf_port
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    ImageCaptioningModel, load_model)
from image_captioning_ml_project_tpu_torch.params import (from_flax,
                                                          init_flax_params)
from torch_port_helpers import (_jax_model, images_uint8, jax_images,
                                port_config, tiny_config)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("clip", "gpt2", "vit", "swin", "resnet")
IMG = 32
V, H = 29, 16  # tests/test_decoders.py's GPT-2


def _randomized(model, seed):
    """``model`` in eval mode with N(0, 0.05²) added to every float tensor
    of its state dict (running variances drawn from U(0.5, 1.5))."""
    g = torch.Generator().manual_seed(seed)
    seen = set()
    with torch.no_grad():
        for name, t in model.state_dict(keep_vars=True).items():
            if id(t) in seen or not t.is_floating_point():
                continue
            seen.add(id(t))
            if name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=g)
            else:
                t.add_(torch.randn(t.shape, generator=g) * 0.05)
    return model.eval()


def _hf(family, seed=0, img=IMG):
    """A tiny random HF model of ``family`` at the JAX tests' sizes
    (tests/test_encoders.py, tests/test_decoders.py)."""
    T = transformers
    torch.manual_seed(seed)
    if family in ("clip", "vit"):
        kw = dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=3,
                  intermediate_size=96, image_size=IMG, patch_size=8)
        model = (T.CLIPVisionModel(T.CLIPVisionConfig(**kw))
                 if family == "clip" else T.ViTModel(T.ViTConfig(**kw)))
    elif family == "swin":
        model = T.SwinModel(T.SwinConfig(
            image_size=img, patch_size=4, embed_dim=8, depths=[2, 2],
            num_heads=[2, 4], window_size=4, drop_path_rate=0.0))
    elif family == "resnet":
        model = T.ResNetModel(T.ResNetConfig(
            embedding_size=8, hidden_sizes=[16, 32], depths=[1, 2],
            layer_type="bottleneck"))
    else:
        model = T.GPT2LMHeadModel(T.GPT2Config(
            vocab_size=V, n_positions=32, n_embd=H, n_layer=2, n_head=4,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))
    return _randomized(model, seed + 100)


# each family's converters: the port's and the JAX package's, at the
# tiny sizes
PORT = {"clip": lambda sd: hf_port.port_clip_vision(sd, 2),
        "gpt2": lambda sd: hf_port.port_gpt2(sd, 2),
        "vit": lambda sd: hf_port.port_vit(sd, 2),
        "swin": lambda sd: hf_port.port_swin(sd, (2, 2)),
        "resnet": lambda sd: hf_port.port_resnet(sd, (1, 2))}
JAX = {"clip": lambda sd: jax_hf_port.port_clip_vision(sd, num_layers=2),
       "gpt2": lambda sd: jax_hf_port.port_gpt2(sd, num_layers=2),
       "vit": lambda sd: jax_hf_port.port_vit(sd, num_layers=2),
       "swin": lambda sd: jax_hf_port.port_swin(sd, depths=[2, 2]),
       "resnet": lambda sd: jax_hf_port.port_resnet(sd, depths=[1, 2])}


def _prefix(family):
    return "decoder.backbone." if family == "gpt2" else "encoder.backbone."


def _config(family, img=IMG):
    """The port's tiny configuration whose backbone has the HF model's
    shapes (a tiny CLIP + GPT-2 around it)."""
    c = tiny_config(vocab=V, width=H, encoder={"gpt2": "clip"}.get(
        family, family))
    e = c.model.encoder
    if family in ("clip", "vit"):
        e.hidden_size, e.num_layers, e.num_heads = 24, 2, 3
        e.mlp_ratio, e.patch_size, e.feature_dim = 4, 8, 16
    elif family == "swin":
        e.swin_embed_dim, e.swin_depths, e.swin_num_heads = 8, (2, 2), (2, 4)
        e.swin_window_size, e.mlp_ratio = 4, 4
        c.image_size = e.image_size = img
    c.model.decoder.gpt2_n_positions = 32
    return port_config(c)


@functools.lru_cache(maxsize=None)
def _seeded_tree():
    """The flax layout of a tiny CLIP + GPT-2, the port's seeded draw."""
    return init_flax_params(_config("clip"), 0)


def _via_flax(family, jax_out):
    """``from_flax`` of a tree whose ``family`` backbone is the JAX
    converter's output: that backbone's entries."""
    params = dict(_seeded_tree()["params"])
    tree = {"params": params}
    if family == "gpt2":
        params["decoder"] = dict(params["decoder"],
                                 backbone=jax_out["params"])
    else:
        params["encoder"] = {"backbone": jax_out["params"]}
        if "batch_stats" in jax_out:
            tree["batch_stats"] = {
                "encoder": {"backbone": jax_out["batch_stats"]}}
    return {k: v for k, v in from_flax(tree).items()
            if k.startswith(_prefix(family))}


@pytest.mark.parametrize("family", FAMILIES)
def test_bridge_matches_jax_port_bit_for_bit(family):
    """Torch tensors and numpy arrays in; every entry f32, contiguous and
    bit-equal to the flax route's."""
    sd = _hf(family).state_dict()
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    want = _via_flax(family, JAX[family](numpy_sd))
    for got in (PORT[family](sd), PORT[family](numpy_sd)):
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == torch.float32, k
            assert got[k].is_contiguous(), k
            assert torch.equal(got[k], w), k


def _port_model(family, fragment, img=IMG):
    """The port's tiny model through ``load_model`` (f32, CPU) from its
    seeded state with ``fragment`` merged in: every backbone entry must
    come from the fragment."""
    cfg = _config(family, img)
    state = from_flax(init_flax_params(cfg, 0))
    backbone = {k for k in state if k.startswith(_prefix(family))}
    assert set(fragment) == backbone
    state.update(fragment)
    return load_model(cfg, "cpu", state_dict=state)


def _close(ours, theirs):
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=1e-4,
                               rtol=1e-4)


# measured gaps on this test's inputs (largest absolute difference, ours
# against HF, on the CPU): hidden states / pooled CLIP 9.5e-7 / 4.8e-7,
# ViT 4.8e-7 / 1.6e-7, Swin 7.2e-7 / 1.8e-7 (at 40: 7.2e-7 / 1.2e-7),
# ResNet 3.3e-6 / 9.5e-7; GPT-2 hidden states / logits 6.0e-7 / 1.5e-7
@pytest.mark.parametrize("family,img", [
    ("clip", IMG), ("vit", IMG), ("swin", IMG), ("swin", 40),
    ("resnet", IMG), ("gpt2", IMG)])
def test_backbone_matches_hf(family, img):
    hf = _hf(family, seed=1, img=img)
    model = _port_model(family, PORT[family](hf.state_dict()), img)
    rs = np.random.RandomState(7)
    with torch.inference_mode():
        if family == "gpt2":
            ids = torch.from_numpy(rs.randint(0, V, (2, 9)))
            bb = model.decoder.backbone
            hidden, _ = bb.full(bb.wte(ids) + bb.wpe.weight[:9][None])
            out = hf(input_ids=ids, output_hidden_states=True)
            _close(hidden, out.hidden_states[-1])
            _close(bb.logits(hidden), out.logits)
            return
        x = torch.from_numpy(rs.randn(2, img, img, 3).astype(np.float32))
        pixels = x.permute(0, 3, 1, 2).contiguous()
        out = hf(pixel_values=pixels)
        bb = model.encoder.backbone
        if family == "resnet":
            y = bb(pixels)
            _close(y, out.last_hidden_state)
            _close(y.mean((2, 3)), out.pooler_output.flatten(1))
        elif family == "swin":
            y = bb(x)
            _close(y, out.last_hidden_state)
            _close(y.mean(1), out.pooler_output)
        else:
            y, pooled = bb(x)
            _close(y, out.last_hidden_state)
            _close(pooled, out.pooler_output)


# the published configurations: HF's model, the port's configuration whose
# backbone it fills, and the converter at full depth
def _swin_config():
    c = port_main.transformer_config()
    c.model.encoder.encoder_type = EncoderType.SWIN
    return c


FULL = {
    "clip": (lambda T: T.CLIPVisionModel(T.CLIPVisionConfig()),
             port_main.flagship_config,
             lambda sd: hf_port.port_clip_vision(sd, 12)),
    "gpt2": (lambda T: T.GPT2LMHeadModel(T.GPT2Config()),
             port_main.flagship_config,
             lambda sd: hf_port.port_gpt2(sd, 12)),
    "vit": (lambda T: T.ViTModel(T.ViTConfig()),
            port_main.transformer_config,
            lambda sd: hf_port.port_vit(sd, 12)),
    "swin": (lambda T: T.SwinModel(T.SwinConfig(
        embed_dim=128, depths=[2, 2, 18, 2], num_heads=[4, 8, 16, 32],
        window_size=7)), _swin_config,
        lambda sd: hf_port.port_swin(sd, (2, 2, 18, 2))),
    "resnet": (lambda T: T.ResNetModel(T.ResNetConfig(depths=[3, 4, 23, 3])),
               port_main.lstm_config,
               lambda sd: hf_port.port_resnet(sd, (3, 4, 23, 3))),
}
# HF's key counts in these configurations (transformers 4.57)
FULL_KEYS = {"clip": 199, "gpt2": 149, "vit": 200, "swin": 447,
             "resnet": 624}
# the legacy buffers chip_smoke.py's layouts carry beyond HF's state dict
LEGACY = {"clip": {"vision_model.embeddings.position_ids"},
          "gpt2": {f"transformer.h.{i}.attn.bias" for i in range(12)}}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _load_strict(family, fragment):
    """``fragment`` loaded ``strict`` into the full-width port module it
    fills, built on ``meta``."""
    with torch.device("meta"):
        model = ImageCaptioningModel(FULL[family][1]())
    module = (model.decoder.backbone if family == "gpt2"
              else model.encoder.backbone)
    n = len(_prefix(family))
    module.load_state_dict({k[n:]: v for k, v in fragment.items()},
                           strict=True, assign=True)


@pytest.mark.parametrize("family", FAMILIES)
def test_full_width_layouts_load_strict(family):
    with torch.device("meta"):
        hf = FULL[family][0](transformers)
    sd = hf.state_dict()
    assert len(sd) == FULL_KEYS[family]
    fragment = FULL[family][2](sd)
    _load_strict(family, fragment)

    # chip_smoke.py draws these layouts on the card, at the widths of the
    # port's configurations: HF's names and shapes, plus the legacy
    # buffers, which the converters drop
    layout = _chip_smoke().hf_layout(family, FULL[family][1]())
    assert set(layout) - set(sd) == LEGACY.get(family, set())
    assert {k: tuple(layout[k][0]) for k in sd} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    drawn = {k: torch.empty(shape, device="meta")
             for k, (shape, _) in layout.items()}
    assert sorted(FULL[family][2](drawn)) == sorted(fragment)


# the buffers older checkpoints carry, which each converter drops by name
EXTRA = {
    "clip": {"vision_model.embeddings.position_ids":
             torch.arange(17)[None]},
    "gpt2": {"transformer.h.0.attn.bias":
             torch.ones(1, 1, 32, 32, dtype=torch.bool).tril(),
             "transformer.h.1.attn.masked_bias": torch.tensor(-1e4)},
    "vit": {},
    "swin": {},  # relative_position_index: HF's state dict has it
    "resnet": {},  # num_batches_tracked: likewise
}


@pytest.mark.parametrize("family", FAMILIES)
def test_strictness(family):
    sd = dict(_hf(family).state_dict())
    want = PORT[family](sd)
    got = PORT[family]({**sd, **EXTRA[family]})
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="neither mapped nor dropped"):
        PORT[family]({**sd, "encoder.extra.weight": torch.zeros(3)})
    needed = sorted(k for k in sd if k.endswith("bias")
                    and not k.endswith("attn.bias"))[0]
    with pytest.raises(KeyError, match="has no"):
        PORT[family]({k: v for k, v in sd.items() if k != needed})
    if family == "gpt2":
        # a GPT2Model's state dict (no ``transformer.``, no head)
        bare = {k[len("transformer."):]: v for k, v in sd.items()
                if k.startswith("transformer.")}
        got = PORT[family](bare)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        untied = dict(sd, **{"lm_head.weight": sd["lm_head.weight"] + 1})
        with pytest.raises(ValueError, match="ties its LM head"):
            PORT[family](untied)
    if family == "swin":
        # a downsample after the last stage is not the port's
        extra = {k.replace("layers.0.", "layers.1."): v for k, v in sd.items()
                 if k.startswith("encoder.layers.0.downsample.")}
        with pytest.raises(ValueError, match="neither mapped nor dropped"):
            PORT[family]({**sd, **extra})


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _jax_decode():
    cfg, model, _ = _jax_model(())
    mc, ic = cfg.model, cfg.inference

    @jax.jit
    def run(variables, images):
        state = model.apply(variables, images, ic.max_length,
                            method=model.init_cache)
        return jax_beam_search(
            lambda s, t: model.apply(variables, s, t, method=model.step),
            state, images.shape[0], ic.beam_size, mc.bos_token_id,
            mc.eos_token_id, mc.pad_token_id, ic.max_length,
            length_penalty=ic.length_penalty, min_length=ic.min_length,
            return_all=True)

    return run


@pytest.mark.parametrize("seed", [0, 1])
def test_flagship_from_hf_decodes_as_jax(seed):
    """A tiny flagship (``tiny_config``: CLIP vision 64 wide, GPT-2 64
    wide, 2 layers each) whose backbones are tiny random HF models, its
    projection and prefix the JAX model's seeded ones: the port's beam
    decode (whole-stack decode, encoder fold) of the port's conversion
    against the JAX package's of its own, f32, tokens identical and
    scores within 1e-4."""
    T = transformers
    torch.manual_seed(seed)
    clip = _randomized(T.CLIPVisionModel(T.CLIPVisionConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=256, image_size=IMG, patch_size=16)), seed)
    gpt2 = _randomized(T.GPT2LMHeadModel(T.GPT2Config(
        vocab_size=1000, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)), seed)
    csd, gsd = clip.state_dict(), gpt2.state_dict()

    cfg, _, init = _jax_model(())
    variables = _plain(jax.device_get(init(jax.random.PRNGKey(seed))))
    state = from_flax(variables)
    fragment = {**hf_port.port_clip_vision(csd, 2),
                **hf_port.port_gpt2(gsd, 2)}
    assert set(fragment) == {k for k in state if k.startswith(
        ("encoder.backbone.", "decoder.backbone."))}
    state.update(fragment)
    port = load_model(port_config(cfg), "cpu", state_dict=state)

    params = variables["params"]
    params["encoder"]["backbone"] = jax_hf_port.port_clip_vision(
        {k: v.numpy() for k, v in csd.items()}, num_layers=2)["params"]
    params["decoder"]["backbone"] = jax_hf_port.port_gpt2(
        {k: v.numpy() for k, v in gsd.items()}, num_layers=2)["params"]

    images = images_uint8(seed + 30, n=3)
    want = _jax_decode()(variables, jax_images(images))
    mc, ic = cfg.model, cfg.inference
    with torch.inference_mode():
        got = beam_search(
            port.step, port.init_cache(torch.from_numpy(images),
                                       ic.max_length),
            3, ic.beam_size, mc.bos_token_id, mc.eos_token_id,
            mc.pad_token_id, ic.max_length,
            length_penalty=ic.length_penalty, min_length=ic.min_length,
            return_all=True)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)
