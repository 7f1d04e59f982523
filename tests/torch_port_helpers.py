"""Shared set-up of the tests/test_torch_*.py files: a tiny CLIP + GPT-2
configuration, and the JAX model and the port's model built from one set
of weights. Inputs are made with numpy from a seed and fed to both."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from image_captioning_ml_project_tpu.config import (DecoderType, EncoderType,
                                                     get_default_config)
from image_captioning_ml_project_tpu.data.coco import normalize_images
from image_captioning_ml_project_tpu.models.captioning_model import (
    ImageCaptioningModel)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)

IMAGE_SIZE = 32


def tiny_config(vocab: int = 1000, decode_kernel: str = "xla",
                fused_qkv: bool = False, feature_dim: int = 64):
    """2 layers, width 64, 4 heads, patch 16 on 32x32 images, 3 prefix
    tokens; f32 weights; beam 5, max length 10, length penalty 0.8,
    min length 2."""
    c = get_default_config()
    e, d = c.model.encoder, c.model.decoder
    e.encoder_type = EncoderType.CLIP
    e.hidden_size, e.num_layers, e.num_heads = 64, 2, 4
    e.patch_size, e.feature_dim, e.fused_qkv = 16, feature_dim, fused_qkv
    e.image_size = IMAGE_SIZE
    d.decoder_type = DecoderType.GPT2
    d.hidden_dim, d.num_layers, d.num_heads = 64, 2, 4
    d.prefix_length, d.dropout, d.gpt2_n_positions = 3, 0.0, 64
    d.decode_kernel = decode_kernel
    c.image_size = IMAGE_SIZE
    c.model.vocab_size = vocab
    c.model.dtype = "float32"
    c.inference.beam_size = 5
    c.inference.max_length = 10
    c.inference.length_penalty = 0.8
    c.inference.min_length = 2
    return c


def images_uint8(seed: int, n: int = 2) -> np.ndarray:
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (n, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_model(config_items):
    """(config, flax model, jitted init) for ``tiny_config(**config)``."""
    cfg = tiny_config(**dict(config_items))
    model = ImageCaptioningModel(cfg)
    imgs = jnp.zeros((2, IMAGE_SIZE, IMAGE_SIZE, 3), jnp.float32)
    caps = jnp.zeros((2, 5), jnp.int32)
    init = jax.jit(lambda rng: model.init(rng, imgs, caps))
    return cfg, model, init


def jax_images(images: np.ndarray):
    """What the JAX trainer hands ``model.encode`` for uint8 images."""
    return normalize_images(jnp.asarray(images))


@functools.lru_cache(maxsize=None)
def _both_models(seed: int, config_items):
    cfg, model, init = _jax_model(config_items)
    variables = init(jax.random.PRNGKey(seed))
    return cfg, model, variables, load_model(cfg, "cpu", params=variables)


def both_models(seed: int, **config):
    """(config, flax model, variables, port model on the CPU) with equal
    weights, for ``tiny_config(**config)``; built once per process and
    shared by the tests, which only read them."""
    return _both_models(seed, tuple(sorted(config.items())))


def bf16_ulp(ref: np.ndarray) -> float:
    """One bf16 ulp at the magnitude of ``ref``'s largest element."""
    mag = float(np.abs(ref).max())
    return 2.0 ** (np.floor(np.log2(mag)) - 7)
