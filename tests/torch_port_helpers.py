"""Shared set-up of the tests/test_torch_*.py files: a tiny configuration
of each ported family (CLIP, ViT or ResNet encoder, GPT-2, Transformer or
LSTM decoder with any attention variant), and the JAX model and the port's
model built from one set of weights; for the trainer tests, a synthetic
COCO fixture, their tiny training configurations and the bridge of a JAX
trainer's state. Inputs are made with numpy from a seed and fed to both."""

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from image_captioning_ml_project_tpu.config import (AttentionType,
                                                     DecoderType, EncoderType,
                                                     config_to_dict,
                                                     get_default_config)
from image_captioning_ml_project_tpu.data.coco import normalize_images
from image_captioning_ml_project_tpu.data.synthetic import make_synthetic_coco
from image_captioning_ml_project_tpu.data.tokenizer import WordVocab
from image_captioning_ml_project_tpu.models.captioning_model import (
    ImageCaptioningModel)
from image_captioning_ml_project_tpu_torch.config import config_from_dict
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from image_captioning_ml_project_tpu_torch.params import (
    train_state_from_flax)

IMAGE_SIZE = 32
LR = 1e-2  # the trainer tests' learning rate


def tiny_config(vocab: int = 1000, decode_kernel: str = "xla",
                fused_qkv: bool = False, feature_dim: int = 64,
                encoder: str = "clip", decoder: str = "gpt2",
                width: int = 64, attention: str = "multi_head",
                attention_heads: int = 4, use_pallas: bool = False,
                layer_type: str = "bottleneck"):
    """2 layers, encoder width 64, decoder width ``width``, 4 heads, patch
    16 on 32x32 images (4 patch tokens), 3 prefix tokens (GPT-2) or 16
    learned positions (Transformer); a ResNet of two stages (depths 1 and 2,
    widths 16 and 32, stem 8, ``layer_type`` layers: 16 feature rows);
    the LSTM's ``attention`` variant of width ``width`` with
    ``attention_heads`` heads and the JAX package's ``use_pallas``; f32
    weights; beam 5, max length 10, length penalty 0.8, min length 2."""
    c = get_default_config()
    e, d = c.model.encoder, c.model.decoder
    e.encoder_type = EncoderType(encoder)
    e.hidden_size, e.num_layers, e.num_heads = 64, 2, 4
    e.patch_size, e.feature_dim, e.fused_qkv = 16, feature_dim, fused_qkv
    e.image_size = IMAGE_SIZE
    e.resnet_depths, e.resnet_hidden_sizes = (1, 2), (16, 32)
    e.resnet_embedding_size, e.resnet_layer_type = 8, layer_type
    d.decoder_type = DecoderType(decoder)
    d.hidden_dim, d.num_layers, d.num_heads = width, 2, 4
    d.prefix_length, d.dropout, d.gpt2_n_positions = 3, 0.0, 64
    d.max_length = 16
    d.decode_kernel = decode_kernel
    a = c.model.attention
    a.attention_type = AttentionType(attention)
    a.hidden_dim, a.num_heads, a.use_pallas = width, attention_heads, \
        use_pallas
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


# the other families at tiny widths: Q-Former (ViT + 8 queries of width
# 48, 2 + 2 layers, 4 heads), BUTD (6 regions of 24 features) and Swin (two
# stages, embed 16, window 3, 40x40 images: a 10x10 grid padded to 12,
# merged with a pad to 5x5), each with the Transformer decoder
FAMILY_IMAGE_SIZE = {"qformer": IMAGE_SIZE, "butd": IMAGE_SIZE, "swin": 40}
FAMILY_REGIONS = 6


def family_config(family: str, width: int = 32, **kw):
    """``tiny_config`` of the Transformer decoder at ``width`` with the
    family's encoder (``qformer``, ``butd``, ``swin``, or ``butd_qformer``:
    the Q-Former over BUTD's masked regions)."""
    encoder = {"qformer": "vit", "butd": "object_region", "swin": "swin",
               "butd_qformer": "object_region"}[family]
    c = tiny_config(encoder=encoder, decoder="transformer", width=width,
                    **kw)
    e = c.model.encoder
    if "qformer" in family:
        c.model.use_q_former = True
        c.model.projection_dim, c.model.q_former_num_queries = 48, 8
        c.model.q_former_num_layers, c.model.q_former_num_heads = 2, 4
    if "butd" in family:
        e.max_objects, e.region_feature_dim = FAMILY_REGIONS, 24
    if family == "swin":
        e.swin_embed_dim, e.swin_depths = 16, (2, 2)
        e.swin_num_heads, e.swin_window_size = (2, 4), 3
        c.image_size = FAMILY_IMAGE_SIZE["swin"]
    return c


def family_inputs(cfg, seed: int, n: int = 2):
    """numpy inputs: uint8 images, or regions with each image's first 2 to
    all of them valid (the first image's fewest)."""
    rs = np.random.RandomState(seed)
    e = cfg.model.encoder
    if e.encoder_type == EncoderType.OBJECT_REGION:
        N = e.max_objects
        counts = np.linspace(2, N, n).round().astype(int)
        return {"region_features": rs.randn(
                    n, N, e.region_feature_dim).astype(np.float32),
                "region_boxes": rs.rand(n, N, 4).astype(np.float32),
                "region_mask": np.arange(N)[None] < counts[:, None]}
    return rs.randint(0, 256, (n, cfg.image_size, cfg.image_size,
                               3)).astype(np.uint8)


def jax_inputs(x):
    """What the JAX trainer hands ``model.encode``: normalised images, or
    the region dict as it is."""
    if isinstance(x, dict):
        return {k: jnp.asarray(v) for k, v in x.items()}
    return jax_images(x)


def port_inputs(x):
    if isinstance(x, dict):
        return {k: torch.from_numpy(v) for k, v in x.items()}
    return torch.from_numpy(x)


@functools.lru_cache(maxsize=None)
def family_models(family: str, seed: int = 0, width: int = 32):
    """(config, flax model, variables, port model on the CPU) of
    :func:`family_config` from the port's seeded draw
    (``init_flax_params``: Swin's bias tables and the Q-Former's queries
    drawn, not zero), the same numbers in both packages."""
    from image_captioning_ml_project_tpu_torch.params import init_flax_params

    cfg = family_config(family, width=width)
    variables = jax.tree_util.tree_map(
        jnp.asarray, init_flax_params(port_config(cfg), seed))
    return (cfg, ImageCaptioningModel(cfg), variables,
            load_model(cfg, "cpu", params=variables))


def bf16_ulp(ref: np.ndarray) -> float:
    """One bf16 ulp at the magnitude of ``ref``'s largest element."""
    mag = float(np.abs(ref).max())
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def coco_fixture(root):
    """A synthetic COCO fixture of 8 + 8 images of 32 x 32, 3 captions
    each, under ``root``, and the JAX package's word vocabulary of every
    train caption word: (root, vocab)."""
    make_synthetic_coco(root, num_images=8, captions_per_image=3,
                        image_size=32)
    with open(os.path.join(root, "annotations/captions_train2014.json")) as f:
        ann = json.load(f)
    vocab = WordVocab.build([a["caption"] for a in ann["annotations"]],
                            threshold=1)
    return root, vocab


def _trainer_fixture_config():
    """tests/test_trainer.py's configuration (ViT + LSTM soft)."""
    cfg = get_default_config()
    cfg.image_size = 32
    e, d = cfg.model.encoder, cfg.model.decoder
    e.encoder_type = EncoderType.VIT
    e.feature_dim = e.hidden_size = 16
    e.num_layers, e.num_heads, e.patch_size, e.image_size = 1, 2, 8, 32
    d.decoder_type = DecoderType.LSTM
    d.hidden_dim, d.num_layers, d.max_length, d.dropout = 16, 1, 16, 0.0
    cfg.model.attention.attention_type = AttentionType.SOFT
    cfg.model.attention.hidden_dim = 16
    cfg.model.projection_dim = 16
    return cfg


def train_config(kind, root, vocab, tmp):
    """The JAX config of one of the trainer tests' tiny configurations
    (``vit_lstm``: tests/test_trainer.py's; ``clip_gpt2`` with the
    contrastive loss; ``resnet_transformer``), f32, dropout 0, batch 4,
    lr :data:`LR` with one warmup step, over the fixture at ``root``."""
    if kind == "vit_lstm":
        cfg = _trainer_fixture_config()
    elif kind == "clip_gpt2":
        cfg = tiny_config(vocab=vocab.vocab_size)
        cfg.training.use_contrastive_loss = True
        cfg.model.projection_dim = 32
    else:
        cfg = tiny_config(vocab=vocab.vocab_size, encoder="resnet",
                          decoder="transformer")
    cfg.data_root = root
    cfg.seed = 0
    cfg.output_dir = str(tmp / "out")
    cfg.checkpoint_dir = str(tmp / "ckpt")
    cfg.log_every = 1
    cfg.num_workers = 0
    cfg.model.vocab_size = vocab.vocab_size
    cfg.model.pad_token_id = vocab.pad_token_id
    cfg.model.bos_token_id = vocab.bos_token_id
    cfg.model.eos_token_id = vocab.eos_token_id
    cfg.model.decoder.dropout = 0.0
    cfg.model.dtype = "float32"
    tc = cfg.training
    tc.batch_size, tc.num_epochs, tc.use_rl, tc.use_amp = 4, 3, False, False
    tc.learning_rate, tc.warmup_steps, tc.weight_decay = LR, 1, 0.01
    cfg.inference.max_length = 8
    cfg.inference.num_candidates = 4
    return cfg


def one_device_mesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def port_config(cfg):
    """The port's Config equal to a JAX one."""
    return config_from_dict(config_to_dict(cfg))


def bridge_state(jt):
    """A JAX trainer's state as the port trainer's."""
    s = jax.device_get(jt.state)
    return train_state_from_flax({"params": s.params,
                                  "batch_stats": s.batch_stats,
                                  "opt_state": s.opt_state, "step": s.step})


# the trainer tests' tolerances (tests/test_torch_trainer.py's docstring)
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
MOMENT_ATOL, MOMENT_RTOL = 1e-7, 1e-3
# below this |gradient| in a step, an entry's AdamW step follows rounding
SMALL_GRADIENT = 1e-7
B1, B2 = 0.9, 0.999


def adam_step_bound(count):
    """The largest |m / sqrt(v)| of bias-corrected Adam moments after
    ``count`` gradients: by Cauchy-Schwarz, sqrt(sum_k a_k^2 / c_k) *
    sqrt(1 - b2^count) / (1 - b1^count) with a_k = (1 - b1) b1^k and
    c_k = (1 - b2) b2^k; 1 at count 1, 1.0014 at 2, 1.0037 at 3."""
    s = sum(((1 - B1) * B1 ** k) ** 2 / ((1 - B2) * B2 ** k)
            for k in range(count))
    return math.sqrt(s) * math.sqrt(1 - B2 ** count) / (1 - B1 ** count)


def jax_gradients(jt, inputs, b, rng):
    """{optimizer name: |gradient|} of the JAX trainer's loss on ``inputs``
    (its ``_batch_inputs`` of batch ``b``) and ``b``'s captions at its
    current state, as its next ``_train_step`` computes it (the same
    dropout stream), mapped onto the port's parameters."""
    from image_captioning_ml_project_tpu_torch.params import _grouped

    state = jt.state

    def loss(params, inputs, captions, mask, key):
        losses, _ = jt._forward_loss(
            params, state.batch_stats, jt._prepare_inputs(inputs), captions,
            jax.random.fold_in(key, state.step), True, caption_mask=mask)
        return losses["total_loss"]

    grads = jax.device_get(jax.jit(jax.grad(loss))(
        state.params, inputs, b["caption_tokens"], b["attention_mask"], rng))
    return {n: g.abs() for n, g in _grouped(
        grads["model"], grads.get("loss", {}), stats=False).items()}


def record_gradients(trainer):
    """[{optimizer name: |gradient|} for each step the trainer takes from
    now on], filled as it takes them."""
    seen = []
    step = trainer.optimizer.step

    def recording(grads):
        seen.append({n: g.detach().abs().clone() for n, g in grads.items()})
        return step(grads)

    trainer.optimizer.step = recording
    return seen


def loose_entries(port_grads, jax_grads):
    """{optimizer name: mask of the entries whose gradient on either
    trainer lies in (0, SMALL_GRADIENT) in some step}."""
    out = {}
    for mine, theirs in zip(port_grads, jax_grads):
        for n, a in mine.items():
            top = torch.maximum(a, theirs[n].to(a.dtype))
            small = (top > 0) & (top < SMALL_GRADIENT)
            out[n] = small if n not in out else out[n] | small
    return out


def assert_state_close(port, ref, before, loose, lrs, weight_decay, what):
    """Every leaf of the port trainer's state against a bridged JAX state
    (flat dicts of tensors by name). The ``loose`` parameter entries
    instead: each trainer's move from ``before`` (the state both started
    the steps from) within the bias-corrected Adam steps at the learning
    rates ``lrs`` plus their decay, and the two within twice the Adam
    steps of each other."""
    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            elif isinstance(v, torch.Tensor):
                out[prefix + k] = v
        return out

    counts = range(before["opt_state"]["count"] + 1,
                   before["opt_state"]["count"] + 1 + len(lrs))
    adam = sum(lr * adam_step_bound(c) for lr, c in zip(lrs, counts))
    mine, theirs, start = flat(port), flat(ref), flat(before)
    assert set(mine) == set(theirs), sorted(set(mine) ^ set(theirs))
    for name, want in theirs.items():
        got, want = mine[name].float().numpy(), want.float().numpy()
        if name.startswith("params/"):
            group, param = name.split("/")[1:]
            small = loose[f"{group}.{param}"].numpy()
            p0 = start[name].float().numpy()[small]
            # the decay of |p| <= |p0| + adam over the steps, and f32
            # rounding of the bound's own terms
            reach = (adam + sum(lrs) * weight_decay
                     * (np.abs(p0) + adam)) * (1 + 1e-5) + 1e-9
            for side, v in (("port", got), ("JAX", want)):
                excess = np.abs(v[small] - p0) - reach
                assert excess.size == 0 or excess.max() <= 0, (
                    f"{what}: leaf {name}: the {side} trainer moved an "
                    f"entry whose gradient is under {SMALL_GRADIENT} "
                    f"{excess.max():.3e} beyond the Adam steps' bound")
            np.testing.assert_allclose(
                got[small], want[small], atol=2 * adam, rtol=0,
                err_msg=f"{what}: leaf {name}, its entries whose gradient "
                        f"lies under {SMALL_GRADIENT}")
            got, want = got[~small], want[~small]
        moment = name.startswith("opt_state/")
        np.testing.assert_allclose(
            got, want, atol=MOMENT_ATOL if moment else PARAM_ATOL,
            rtol=MOMENT_RTOL if moment else PARAM_RTOL,
            err_msg=f"{what}: leaf {name}")
    assert port["opt_state"]["count"] == ref["opt_state"]["count"]
    assert port["step"] == ref["step"]
