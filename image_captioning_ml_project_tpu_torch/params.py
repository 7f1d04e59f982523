"""Weight bridge: the JAX package's flax variables -> this package's torch
state dict, and the seeded initialisation used when no weights are given.

Layouts carried across:

* flax ``Dense`` kernels are ``[in, out]``; ``nn.Linear`` weights are
  ``[out, in]``, so every kernel is transposed;
* the CLIP and ViT attention's unfused ``query``/``key``/``value`` Dense
  params are concatenated into the one ``[h, 3h]`` QKV projection (a flax
  tree saved with ``fused_qkv`` already has ``qkv``);
* the patch-embed conv kernel ``[P, P, C, H]`` is flattened in
  (kh, kw, c) order to ``[P*P*C, H]`` and transposed;
* LayerNorm ``scale``/``bias`` become ``weight``/``bias``; ``Embed``
  ``embedding`` becomes ``weight``;
* the ResNet's conv kernels ``[kh, kw, in, out]`` become ``nn.Conv2d``'s
  ``[out, in, kh, kw]``; each BatchNorm's ``scale``/``bias`` (collection
  ``params``) and running ``mean``/``var`` (collection ``batch_stats``)
  become its weight, bias and running statistics.

Every flax leaf must be consumed: a leaf no rule maps raises, and so does
a leaf a rule expects but the tree lacks.

:func:`stack_layer_weights` builds, once at model load, the layer-stacked
operands the whole-stack kernels read (the JAX package's
``_stacked_weights`` and the encoder fold's stack) and the Transformer
decoder's concatenated ``[3H, H]`` QKV weights of the folded decode: XLA
hoists these out of the decode loop under ``jit``, but in eager PyTorch
each would be a copy per step or per batch.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from .config import AttentionType, DecoderType, EncoderType, reads_regions
from .models import hf_port


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


class _Bridge:
    """Pops flax leaves by path and records torch tensors by name. Without
    ``stats`` (a tree of parameter-shaped leaves, such as an optimizer
    moment) the BatchNorm running statistics are neither read nor
    written."""

    def __init__(self, flat: Dict[str, np.ndarray], stats: bool = True):
        self.flat = dict(flat)
        self.stats = stats
        self.out: Dict[str, torch.Tensor] = {}

    def take(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"flax tree has no leaf {path!r}")
        return self.flat.pop(path)

    def put(self, name: str, array: np.ndarray) -> None:
        self.out[name] = torch.from_numpy(
            np.array(array, dtype=np.float32, order="C"))

    def dense(self, src: str, dst: str) -> None:
        self.put(f"{dst}.weight", self.take(f"{src}/kernel").T)
        self.put(f"{dst}.bias", self.take(f"{src}/bias"))

    def norm(self, src: str, dst: str) -> None:
        self.put(f"{dst}.weight", self.take(f"{src}/scale"))
        self.put(f"{dst}.bias", self.take(f"{src}/bias"))

    def batch_norm(self, src: str, dst: str) -> None:
        self.norm(src, dst)
        if not self.stats:
            return
        self.put(f"{dst}.running_mean", self.take(f"{_STATS}/{src}/mean"))
        self.put(f"{dst}.running_var", self.take(f"{_STATS}/{src}/var"))

    def conv(self, src: str, dst: str) -> None:
        """A bias-free flax ``Conv`` kernel [kh, kw, in, out] -> OIHW."""
        self.put(f"{dst}.weight",
                 self.take(f"{src}/kernel").transpose(3, 2, 0, 1))

    def indices(self, prefix: str, stem: str):
        pat = re.compile(rf"^{re.escape(prefix)}/{stem}_(\d+)/")
        return sorted({int(m.group(1)) for m in map(pat.match, self.flat)
                       if m})


# where from_flax files the ``batch_stats`` collection's leaves
_STATS = "batch_stats"


def _qkv(br: _Bridge, src: str, dst: str) -> None:
    """An encoder attention's QKV projection: the flax module's ``qkv``,
    or its ``query``/``key``/``value`` concatenated."""
    if f"{src}/qkv/kernel" in br.flat:
        br.dense(f"{src}/qkv", f"{dst}.qkv")
        return
    parts = [(br.take(f"{src}/{n}/kernel"), br.take(f"{src}/{n}/bias"))
             for n in ("query", "key", "value")]
    br.put(f"{dst}.qkv.weight", np.concatenate([k for k, _ in parts],
                                               axis=1).T)
    br.put(f"{dst}.qkv.bias", np.concatenate([b for _, b in parts]))


def _patch_embed(br: _Bridge, src: str, dst: str) -> None:
    kernel = br.take(f"{src}/kernel")                       # [P, P, C, H]
    br.put(f"{dst}.weight", kernel.reshape(-1, kernel.shape[-1]).T)


def _clip_layers(br: _Bridge, enc: str, out: str) -> None:
    """The ``CLIPLayer``s ``layer_i`` under ``enc``."""
    for i in br.indices(enc, "layer"):
        src, dst = f"{enc}/layer_{i}", f"{out}.layers.{i}"
        _qkv(br, f"{src}/attention", f"{dst}.attention")
        br.dense(f"{src}/attention/out", f"{dst}.attention.out")
        br.norm(f"{src}/layer_norm1", f"{dst}.layer_norm1")
        br.norm(f"{src}/layer_norm2", f"{dst}.layer_norm2")
        br.dense(f"{src}/fc1", f"{dst}.fc1")
        br.dense(f"{src}/fc2", f"{dst}.fc2")


def _clip_vision(br: _Bridge, enc: str, out: str) -> None:
    _patch_embed(br, f"{enc}/patch_embed", f"{out}.patch_embed")
    br.put(f"{out}.class_embedding", br.take(f"{enc}/class_embedding"))
    br.put(f"{out}.position_embeddings",
           br.take(f"{enc}/position_embeddings"))
    br.norm(f"{enc}/pre_layernorm", f"{out}.pre_layernorm")
    br.norm(f"{enc}/post_layernorm", f"{out}.post_layernorm")
    _clip_layers(br, enc, out)


def _clip_encoder(br: _Bridge) -> None:
    _clip_vision(br, "encoder/backbone", "encoder.backbone")


def _vit_encoder(br: _Bridge) -> None:
    enc, out = "encoder/backbone", "encoder.backbone"
    _patch_embed(br, f"{enc}/patch_embed", f"{out}.patch_embed")
    br.put(f"{out}.patch_embed.bias", br.take(f"{enc}/patch_embed/bias"))
    br.put(f"{out}.cls_token", br.take(f"{enc}/cls_token"))
    br.put(f"{out}.position_embeddings",
           br.take(f"{enc}/position_embeddings"))
    br.norm(f"{enc}/layernorm", f"{out}.layernorm")
    br.dense(f"{enc}/pooler", f"{out}.pooler")
    for i in br.indices(enc, "layer"):
        src, dst = f"{enc}/layer_{i}", f"{out}.layers.{i}"
        _qkv(br, f"{src}/attention", f"{dst}.attention")
        br.dense(f"{src}/attention/out", f"{dst}.attention.out")
        br.norm(f"{src}/layernorm_before", f"{dst}.layernorm_before")
        br.norm(f"{src}/layernorm_after", f"{dst}.layernorm_after")
        br.dense(f"{src}/intermediate", f"{dst}.intermediate")
        br.dense(f"{src}/output", f"{dst}.output")


def _gpt2_decoder(br: _Bridge) -> None:
    dec = "decoder/backbone"
    br.put("decoder.backbone.wte.weight", br.take(f"{dec}/wte/embedding"))
    br.put("decoder.backbone.wpe.weight", br.take(f"{dec}/wpe/embedding"))
    for i in br.indices(dec, "block"):
        src, dst = f"{dec}/block_{i}", f"decoder.backbone.blocks.{i}"
        br.norm(f"{src}/ln_1", f"{dst}.ln_1")
        br.dense(f"{src}/attn/c_attn", f"{dst}.attn.c_attn")
        br.dense(f"{src}/attn/c_proj", f"{dst}.attn.c_proj")
        br.norm(f"{src}/ln_2", f"{dst}.ln_2")
        br.dense(f"{src}/mlp/c_fc", f"{dst}.mlp.c_fc")
        br.dense(f"{src}/mlp/c_proj", f"{dst}.mlp.c_proj")
    br.norm(f"{dec}/ln_f", "decoder.backbone.ln_f")
    br.dense("decoder/image_to_prefix", "decoder.image_to_prefix")
    br.put("decoder.image_prefix", br.take("decoder/image_prefix"))


def _transformer_decoder(br: _Bridge) -> None:
    br.put("decoder.embedding.weight", br.take("decoder/embedding/embedding"))
    br.put("decoder.position_encoding.weight",
           br.take("decoder/position_encoding/embedding"))
    br.dense("decoder/output_layer", "decoder.output_layer")
    br.dense("decoder/visual_projection", "decoder.visual_projection")
    for i in br.indices("decoder", "layer"):
        src, dst = f"decoder/layer_{i}", f"decoder.layers.{i}"
        for att in ("self_attn", "cross_attn"):
            _mha(br, f"{src}/{att}", f"{dst}.{att}")
        br.dense(f"{src}/linear1", f"{dst}.linear1")
        br.dense(f"{src}/linear2", f"{dst}.linear2")
        for n in ("norm1", "norm2", "norm3"):
            br.norm(f"{src}/{n}", f"{dst}.{n}")


def _swin_encoder(br: _Bridge) -> None:
    enc, out = "encoder/backbone", "encoder.backbone"
    _patch_embed(br, f"{enc}/patch_embed", f"{out}.patch_embed")
    br.put(f"{out}.patch_embed.bias", br.take(f"{enc}/patch_embed/bias"))
    br.norm(f"{enc}/embed_norm", f"{out}.embed_norm")
    br.norm(f"{enc}/layernorm", f"{out}.layernorm")
    pat = re.compile(rf"^{enc}/stage_(\d+)_block_(\d+)/")
    blocks = sorted({(int(m.group(1)), int(m.group(2)))
                     for m in map(pat.match, br.flat) if m})
    for stage, i in blocks:
        src = f"{enc}/stage_{stage}_block_{i}"
        dst = f"{out}.stages.{stage}.{i}"
        for n in ("query", "key", "value", "out"):
            br.dense(f"{src}/attention/{n}", f"{dst}.attention.{n}")
        br.put(f"{dst}.attention.relative_position_bias_table",
               br.take(f"{src}/attention/relative_position_bias_table"))
        br.norm(f"{src}/layernorm_before", f"{dst}.layernorm_before")
        br.norm(f"{src}/layernorm_after", f"{dst}.layernorm_after")
        br.dense(f"{src}/intermediate", f"{dst}.intermediate")
        br.dense(f"{src}/output", f"{dst}.output")
    for stage in sorted({s for s, _ in blocks})[:-1]:
        src = f"{enc}/stage_{stage}_downsample"
        dst = f"{out}.downsamples.{stage}"
        br.norm(f"{src}/norm", f"{dst}.norm")
        br.put(f"{dst}.reduction.weight",
               br.take(f"{src}/reduction/kernel").T)


def _object_region_encoder(br: _Bridge) -> None:
    for n in ("geo_proj_0", "geo_proj_1", "combine"):
        br.dense(f"encoder/{n}", f"encoder.{n}")


def _mha(br: _Bridge, src: str, dst: str) -> None:
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        br.dense(f"{src}/{proj}", f"{dst}.{proj}")


def _q_former(br: _Bridge) -> None:
    br.put("q_former.query_tokens", br.take("q_former/query_tokens"))
    if "q_former/vision_proj/kernel" in br.flat:
        br.dense("q_former/vision_proj", "q_former.vision_proj")
    for stack, norms in (("encoder", ("norm1", "norm2")),
                         ("decoder", ("norm1", "norm2", "norm3"))):
        for i in br.indices("q_former", stack):
            src, dst = f"q_former/{stack}_{i}", f"q_former.{stack}.{i}"
            _mha(br, f"{src}/self_attn", f"{dst}.self_attn")
            if stack == "decoder":
                _mha(br, f"{src}/cross_attn", f"{dst}.cross_attn")
            for n in norms:
                br.norm(f"{src}/{n}", f"{dst}.{n}")
            br.dense(f"{src}/linear1", f"{dst}.linear1")
            br.dense(f"{src}/linear2", f"{dst}.linear2")


def _resnet_encoder(br: _Bridge) -> None:
    enc, out = "encoder/backbone", "encoder.backbone"

    def conv_layer(src, dst):
        br.conv(f"{src}/convolution", f"{dst}.convolution")
        br.batch_norm(f"{src}/normalization", f"{dst}.normalization")

    conv_layer(f"{enc}/embedder", f"{out}.embedder")
    pat = re.compile(rf"^{enc}/stage_(\d+)_layer_(\d+)/")
    layers = sorted({(int(m.group(1)), int(m.group(2)))
                     for m in map(pat.match, br.flat) if m})
    for stage, i in layers:
        src = f"{enc}/stage_{stage}_layer_{i}"
        dst = f"{out}.stages.{stage}.{i}"
        for n in br.indices(src, "layer"):
            conv_layer(f"{src}/layer_{n}", f"{dst}.layer_{n}")
        if f"{src}/shortcut/convolution/kernel" in br.flat:
            conv_layer(f"{src}/shortcut", f"{dst}.shortcut")


# each attention variant's Dense layers: the soft and multi-head cores, and
# the adaptive and AoA wrappers' own layers around their ``base_attention``
# (told apart by a layer only they have)
_SOFT = ("query_proj", "key_proj", "energy")
_MULTI_HEAD = ("query_proj", "key_proj", "value_proj", "output_proj")
_WRAPPERS = {"sentinel_gate": ("sentinel_gate", "sentinel_proj",
                               "adaptive_weight"),
             "info_gate_proj": ("query_proj", "info_vector_proj",
                                "info_gate_proj")}


def _attention(br: _Bridge, src: str, dst: str) -> None:
    for key, names in _WRAPPERS.items():
        if f"{src}/{key}/kernel" in br.flat:
            for n in names:
                br.dense(f"{src}/{n}", f"{dst}.{n}")
            src, dst = f"{src}/base_attention", f"{dst}.base_attention"
            break
    core = _SOFT if f"{src}/energy/kernel" in br.flat else _MULTI_HEAD
    for n in core:
        br.dense(f"{src}/{n}", f"{dst}.{n}")


def _lstm_decoder(br: _Bridge) -> None:
    br.put("decoder.embedding.weight", br.take("decoder/embedding/embedding"))
    for n in ("output_layer", "init_h", "init_c"):
        br.dense(f"decoder/{n}", f"decoder.{n}")
    for i in br.indices("decoder/lstm", "cell"):
        br.dense(f"decoder/lstm/cell_{i}/gates",
                 f"decoder.lstm.cells.{i}.gates")
    _attention(br, "decoder/attention", "decoder.attention")


def from_flax(tree: Mapping, stats: bool = True) -> Dict[str, torch.Tensor]:
    """Map the JAX ``ImageCaptioningModel`` variables (CLIP, ViT, ResNet,
    Swin or object-region encoder, GPT-2, Transformer or LSTM decoder, the
    Q-Former where there is one, told apart by their leaves; nested dict
    of arrays, either the collections ``"params"`` and,
    for the ResNet, ``"batch_stats"``, or the params alone) to an f32 state
    dict of :class:`..models.captioning_model.ImageCaptioningModel`. With
    ``stats=False`` the tree is parameter-shaped leaves alone (an optimizer
    moment of the params, say), mapped by the same rules, and the result
    holds the parameters only."""
    flat = {}
    if "params" in tree and isinstance(tree["params"], Mapping):
        flat = {f"{_STATS}/{k}": v
                for k, v in _flatten(tree.get(_STATS, {})).items()}
        tree = tree["params"]
    flat.update(_flatten(tree))
    br = _Bridge(flat, stats=stats)
    if "encoder/backbone/class_embedding" in br.flat:
        _clip_encoder(br)
    elif "encoder/backbone/cls_token" in br.flat:
        _vit_encoder(br)
    elif "encoder/backbone/embedder/convolution/kernel" in br.flat:
        _resnet_encoder(br)
    elif "encoder/backbone/embed_norm/scale" in br.flat:
        _swin_encoder(br)
    elif "encoder/combine/kernel" in br.flat:
        _object_region_encoder(br)
    else:
        raise ValueError("the flax tree holds no CLIP, ViT, ResNet, Swin or "
                         "object-region encoder")
    if "encoder/proj/kernel" in br.flat:
        br.dense("encoder/proj", "encoder.proj")
    if "q_former/query_tokens" in br.flat:
        _q_former(br)
    if "decoder/backbone/wte/embedding" in br.flat:
        _gpt2_decoder(br)
    elif "decoder/lstm/cell_0/gates/kernel" in br.flat:
        _lstm_decoder(br)
    elif "decoder/embedding/embedding" in br.flat:
        _transformer_decoder(br)
    else:
        raise ValueError("the flax tree holds no GPT-2, Transformer or LSTM "
                         "decoder (the decoders ported so far)")
    if br.flat:
        raise ValueError(f"unmapped flax leaves: {sorted(br.flat)}")
    return br.out


# the legacy decoder's Dense layers (its LSTM cell's ``gates`` aside)
_LEGACY_DENSE = ("enc_att", "dec_att", "att", "h_lin", "c_lin", "f_beta",
                 "fc")


def legacy_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Map the JAX legacy ``ShowAttendTell`` variables (``{"params":
    ..., "batch_stats": ...}`` or the params alone) to an f32 state dict
    of :class:`.legacy.model.ShowAttendTell`: the ResNet backbone with its
    BatchNorm statistics, the decoder's attention (``enc_att``,
    ``dec_att``, ``att``), its fused LSTM cell, ``h_lin``, ``c_lin``,
    ``f_beta``, ``fc`` and the word embedding (none with ``use_bert``).
    Every leaf must be consumed."""
    flat = {}
    if "params" in tree and isinstance(tree["params"], Mapping):
        flat = {f"{_STATS}/{k}": v
                for k, v in _flatten(tree.get(_STATS, {})).items()}
        tree = tree["params"]
    flat.update(_flatten(tree))
    br = _Bridge(flat)
    _resnet_encoder(br)
    for n in _LEGACY_DENSE:
        br.dense(f"decoder/{n}", f"decoder.{n}")
    br.dense("decoder/decode_step/gates", "decoder.decode_step.gates")
    if "decoder/embedding/embedding" in br.flat:
        br.put("decoder.embedding.weight",
               br.take("decoder/embedding/embedding"))
    if br.flat:
        raise ValueError(f"unmapped flax leaves: {sorted(br.flat)}")
    return br.out


def init_legacy_flax_params(vocab_size: int, encoder_config, seed: int,
                            use_bert: bool = False, embed_dim: int = 512,
                            attention_dim: int = 512,
                            decoder_dim: int = 512) -> Dict[str, Any]:
    """Seeded weights in the flax layout of the JAX legacy
    ``ShowAttendTell``, drawn from ``numpy.random.RandomState(seed)`` as
    :func:`init_flax_params` draws the captioning model's: the ResNet
    first (conv kernels at ``lecun_normal`` scale, BatchNorm statistics 0
    and 1), then the decoder's Dense kernels and embedding N(0, 0.02²),
    biases 0. With ``use_bert`` the embeddings are BERT's 768."""
    rs = np.random.RandomState(seed)

    def normal(*shape, std=0.02):
        return (rs.standard_normal(shape) * std).astype(np.float32)

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out),
                "bias": np.zeros(n_out, np.float32)}

    def norm(n):
        return {"scale": np.ones(n, np.float32),
                "bias": np.zeros(n, np.float32)}

    encoder, stats = _draw_resnet(encoder_config, normal, norm)
    E, A, D = encoder_config.resnet_hidden_sizes[-1], attention_dim, \
        decoder_dim
    emb = 768 if use_bert else embed_dim
    decoder = {"enc_att": dense(E, A), "dec_att": dense(D, A),
               "att": dense(A, 1),
               "decode_step": {"gates": dense(emb + E + D, 4 * D)},
               "h_lin": dense(E, D), "c_lin": dense(E, D),
               "f_beta": dense(D, E), "fc": dense(D, vocab_size)}
    if not use_bert:
        decoder["embedding"] = {"embedding": normal(vocab_size, emb)}
    return {"params": {"encoder": encoder, "decoder": decoder},
            _STATS: {"encoder": stats}}


def loss_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Map the JAX ``CombinedLoss`` params (with or without the top-level
    ``"params"``; empty without contrastive and ITM losses) to an f32
    state dict of :class:`.train.losses.CombinedLoss`: the ITM head's
    ``Dense_0``/``Dense_1`` and the two feature projections."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    br = _Bridge(_flatten(tree))
    if "itm_head/Dense_0/kernel" in br.flat:
        br.dense("itm_head/Dense_0", "itm_head.dense_0")
        br.dense("itm_head/Dense_1", "itm_head.dense_1")
    if "image_feat_proj/kernel" in br.flat:
        br.dense("image_feat_proj", "image_feat_proj")
        br.dense("text_feat_proj", "text_feat_proj")
    if br.flat:
        raise ValueError(f"unmapped flax leaves: {sorted(br.flat)}")
    return br.out


def resize_token_embeddings(state: Mapping[str, torch.Tensor],
                            new_vocab_size: int,
                            key: str = "decoder.backbone.wte.weight",
                            init_std: float = 0.02, seed: int = 0
                            ) -> Dict[str, torch.Tensor]:
    """A state dict with the embedding table ``key`` [V, H] resized to
    ``new_vocab_size`` rows, HF ``resize_token_embeddings`` semantics as
    the JAX package's ``models.hf_port.resize_token_embeddings``: the
    existing rows kept, new rows N(0, init_std²) drawn from
    ``numpy.random.RandomState(seed)``, extra rows cut. GPT-2's LM head is
    tied to the table, so it follows."""
    table = state[key]
    old, dim = table.shape
    out = dict(state)
    if new_vocab_size < old:
        out[key] = table[:new_vocab_size].clone()
    elif new_vocab_size > old:
        extra = np.random.RandomState(seed).normal(
            0.0, init_std, (new_vocab_size - old, dim))
        out[key] = torch.cat([table, torch.from_numpy(extra).to(
            table.dtype).to(table.device)])
    return out


def _adam_state(node: Any):
    """The optax ``ScaleByAdamState`` (count, mu, nu) inside an optimizer
    state: namedtuples, lists or dicts of them, as the live state or an
    Orbax restore gives it."""
    if hasattr(node, "mu") and hasattr(node, "nu"):
        return node.count, node.mu, node.nu
    if isinstance(node, Mapping):
        if "mu" in node and "nu" in node:
            return node["count"], node["mu"], node["nu"]
        children = list(node.values())
    elif isinstance(node, (list, tuple)):
        children = list(node)
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def _to_mapping(tree: Any) -> Any:
    """A flax FrozenDict or dict tree as plain nested dicts."""
    if isinstance(tree, Mapping):
        return {k: _to_mapping(v) for k, v in tree.items()}
    return tree


def _grouped(model: Mapping, loss: Mapping, stats: bool = True):
    out = {f"model.{k}": v for k, v in from_flax(model, stats=stats).items()}
    out.update({f"loss.{k}": v for k, v in loss_from_flax(loss).items()})
    return out


def train_state_from_flax(tree: Mapping) -> Dict[str, Any]:
    """Map the JAX trainer's state (``{"params": {"model", "loss"},
    "batch_stats", "opt_state", "step"}``, arrays as numpy or jax arrays)
    to the port's trainer state (``CaptioningTrainer._state_tree``'s
    layout): the model's parameters through :func:`from_flax` and its
    BatchNorm statistics as buffers, the loss's through
    :func:`loss_from_flax`, the AdamW ``count`` and the moments ``mu`` and
    ``nu`` mapped leaf for leaf onto the same parameters by the same rules
    (the transposes and concatenations apply to the moments as to the
    weights; a bfloat16 ``mu`` stays bfloat16), and the step."""
    params = _to_mapping(tree["params"])
    stats = _to_mapping(tree.get("batch_stats") or {})
    model = from_flax({"params": params["model"], _STATS: stats})
    buffers = {k: v for k, v in model.items()
               if k.endswith(("running_mean", "running_var"))}
    found = _adam_state(tree["opt_state"])
    if found is None:
        raise ValueError("the optimizer state holds no Adam moments")
    count, mu, nu = found
    mu, nu = _to_mapping(mu), _to_mapping(nu)
    mu_bf16 = any(getattr(np.asarray(v), "dtype", None) is not None
                  and np.asarray(v).dtype.name == "bfloat16"
                  for v in _flatten(mu["model"]).values())
    moments = {}
    for key, tree_m in (("mu", mu), ("nu", nu)):
        moments[key] = _grouped(tree_m["model"], tree_m.get("loss", {}),
                                stats=False)
    if mu_bf16:
        moments["mu"] = {k: v.to(torch.bfloat16)
                         for k, v in moments["mu"].items()}
    return {
        "params": {"model": {k: v for k, v in model.items()
                             if k not in buffers},
                   "loss": loss_from_flax(params.get("loss", {}))},
        "batch_stats": buffers,
        "opt_state": {"count": int(np.asarray(count)), **moments},
        "step": int(np.asarray(tree["step"])),
    }


def scorer_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Map the JAX ``CLIPScorer`` variables (with or without the top-level
    ``"params"``) to an f32 state dict of
    :class:`.models.clip_text.CLIPScorer`: the vision tower as the
    captioning CLIP encoder's, the text tower's token embedding, position
    embeddings, layers and final LayerNorm, the two bias-free projections
    and ``logit_scale``."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    br = _Bridge(_flatten(tree))
    _clip_vision(br, "vision", "vision")
    br.put("text.token_embedding.weight",
           br.take("text/token_embedding/embedding"))
    br.put("text.position_embeddings", br.take("text/position_embeddings"))
    br.norm("text/final_layernorm", "text.final_layernorm")
    _clip_layers(br, "text", "text")
    for name in ("visual_projection", "text_projection"):
        br.put(f"{name}.weight", br.take(f"{name}/kernel").T)
    br.put("logit_scale", br.take("logit_scale"))
    if br.flat:
        raise ValueError(f"unmapped flax leaves: {sorted(br.flat)}")
    return br.out


def scorer_from_hf(sd: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Map an HF ``CLIPModel`` state dict (torch tensors, read as they are:
    both sides keep ``nn.Linear``'s ``[out, in]``) to an f32 state dict of
    :class:`.models.clip_text.CLIPScorer`, the counterpart of the JAX
    package's ``port_clip_model``: both towers' layers through
    :mod:`.models.hf_port`'s CLIP mapping (q/k/v concatenated into the one
    QKV projection, the patch convolution ``[H, C, P, P]`` flattened in
    (kh, kw, c) order), every key consumed but the position ids."""
    st = hf_port.HFState(sd, drop=(hf_port.POSITION_IDS,))

    def layers(src):
        pat = re.compile(rf"^{re.escape(src)}\.encoder\.layers\.(\d+)\.")
        return sorted({int(m.group(1)) for m in map(pat.match, sd) if m})

    v, t = "vision_model", "text_model"
    hf_port.clip_vision(st, v, "vision", layers(v))
    st.put("text.token_embedding.weight",
           st.take(f"{t}.embeddings.token_embedding.weight"))
    st.put("text.position_embeddings",
           st.take(f"{t}.embeddings.position_embedding.weight"))
    st.linear(f"{t}.final_layer_norm", "text.final_layernorm")
    hf_port.clip_layers(st, f"{t}.encoder.layers", "text", layers(t))
    st.linear("visual_projection", "visual_projection", bias=False)
    st.linear("text_projection", "text_projection", bias=False)
    st.put("logit_scale", st.take("logit_scale"))
    return st.done()


def load_scorer(scorer: nn.Module, state_dict: Mapping[str, torch.Tensor],
                device) -> nn.Module:
    """A :class:`.models.clip_text.CLIPScorer` (built on the ``meta``
    device or anywhere) loaded from ``state_dict`` onto ``device`` in
    float32 and inference mode, its vision tower's layer-stacked weights
    built for the encoder kernel (as :func:`stack_layer_weights` builds the
    captioning CLIP encoder's)."""
    scorer.load_state_dict(state_dict, strict=True, assign=True)
    scorer = scorer.to(device).eval().requires_grad_(False)
    scorer.vision.stack = _stack_clip(scorer.vision)
    return scorer


def init_flax_params(config, seed: int) -> Dict[str, Any]:
    """Seeded weights in the flax layout of the JAX ``ImageCaptioningModel``
    (CLIP, ViT, ResNet, Swin or object-region encoder, GPT-2, Transformer
    or LSTM decoder, the Q-Former where configured), drawn from
    ``numpy.random.RandomState(seed)``, encoder first, then the decoder,
    then the Q-Former: dense kernels, embeddings, position embeddings,
    Swin's relative position bias tables and the Q-Former's queries
    N(0, 0.02²) (GPT-2's initialiser), the CLIP class embedding and the
    ViT CLS token N(0, 1/width), the GPT-2 learned image prefix N(0, 1) as
    flax draws it, conv kernels at flax's ``lecun_normal`` scale (std
    ``1/sqrt(kh*kw*in)``), biases 0, norm scales 1; a ResNet's BatchNorm
    running means 0 and variances 1, in the ``batch_stats`` collection."""
    rs = np.random.RandomState(seed)
    mc = config.model
    ec, dc = mc.encoder, mc.decoder

    def normal(*shape, std=0.02):
        return (rs.standard_normal(shape) * std).astype(np.float32)

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out),
                "bias": np.zeros(n_out, np.float32)}

    def norm(n):
        return {"scale": np.ones(n, np.float32),
                "bias": np.zeros(n, np.float32)}

    variables = {"params": {}}
    if reads_regions(ec):
        D = ec.feature_dim
        encoder = {"geo_proj_0": dense(4, 64), "geo_proj_1": dense(64, D),
                   "combine": dense(2 * D, D)}
        width = ec.region_feature_dim
    elif ec.encoder_type == EncoderType.RESNET:
        encoder, stats = _draw_resnet(ec, normal, norm)
        variables[_STATS] = {"encoder": stats}
        width = ec.resnet_hidden_sizes[-1]
    elif ec.encoder_type == EncoderType.SWIN:
        encoder = _draw_swin(ec, normal, dense, norm)
        width = ec.swin_embed_dim * 2 ** (len(ec.swin_depths) - 1)
    else:
        encoder = _draw_transformer_encoder(ec, config.image_size, normal,
                                            dense, norm)
        width = ec.hidden_size
    if width != ec.feature_dim:
        encoder["proj"] = dense(width, ec.feature_dim)
    variables["params"]["encoder"] = encoder
    variables["params"]["decoder"] = _draw_decoder(mc, normal, dense, norm)
    if mc.use_q_former:
        variables["params"]["q_former"] = _draw_q_former(mc, normal, dense,
                                                         norm)
    return variables


def _draw_swin(ec, normal, dense, norm):
    E, p = ec.swin_embed_dim, 4
    w = ec.swin_window_size
    backbone = {"patch_embed": {"kernel": normal(p, p, 3, E),
                                "bias": np.zeros(E, np.float32)},
                "embed_norm": norm(E)}
    dim = E
    for stage, (depth, nh) in enumerate(zip(ec.swin_depths,
                                            ec.swin_num_heads)):
        f = dim * ec.mlp_ratio
        for i in range(depth):
            attention = {n: dense(dim, dim)
                         for n in ("query", "key", "value", "out")}
            attention["relative_position_bias_table"] = normal(
                (2 * w - 1) ** 2, nh)
            backbone[f"stage_{stage}_block_{i}"] = {
                "attention": attention, "layernorm_before": norm(dim),
                "layernorm_after": norm(dim), "intermediate": dense(dim, f),
                "output": dense(f, dim)}
        if stage < len(ec.swin_depths) - 1:
            backbone[f"stage_{stage}_downsample"] = {
                "norm": norm(4 * dim),
                "reduction": {"kernel": normal(4 * dim, 2 * dim)}}
            dim *= 2
    backbone["layernorm"] = norm(dim)
    return {"backbone": backbone}


def _draw_q_former(mc, normal, dense, norm):
    Q = mc.projection_dim

    def mha():
        return {n: dense(Q, Q) for n in ("q_proj", "k_proj", "v_proj",
                                         "out_proj")}

    def ffn():
        return {"linear1": dense(Q, 4 * Q), "linear2": dense(4 * Q, Q)}

    q = {"query_tokens": normal(1, mc.q_former_num_queries, Q)}
    if mc.encoder.feature_dim != Q:
        q["vision_proj"] = dense(mc.encoder.feature_dim, Q)
    for i in range(mc.q_former_num_layers):
        q[f"encoder_{i}"] = {"self_attn": mha(), "norm1": norm(Q),
                             "norm2": norm(Q), **ffn()}
    for i in range(mc.q_former_num_layers):
        q[f"decoder_{i}"] = {"self_attn": mha(), "cross_attn": mha(),
                             "norm1": norm(Q), "norm2": norm(Q),
                             "norm3": norm(Q), **ffn()}
    return q


def _draw_transformer_encoder(ec, image_size, normal, dense, norm):
    def attention(h):
        return {n: dense(h, h) for n in ("query", "key", "value", "out")}

    h, p, f = ec.hidden_size, ec.patch_size, ec.hidden_size * ec.mlp_ratio
    tokens = (image_size // p) ** 2 + 1
    vit = ec.encoder_type == EncoderType.VIT
    if vit:
        backbone = {"patch_embed": {"kernel": normal(p, p, 3, h),
                                    "bias": np.zeros(h, np.float32)},
                    "cls_token": normal(1, 1, h, std=h ** -0.5),
                    "position_embeddings": normal(1, tokens, h),
                    "layernorm": norm(h), "pooler": dense(h, h)}
    else:
        backbone = {"patch_embed": {"kernel": normal(p, p, 3, h)},
                    "class_embedding": normal(h, std=h ** -0.5),
                    "position_embeddings": normal(tokens, h),
                    "pre_layernorm": norm(h), "post_layernorm": norm(h)}
    for i in range(ec.num_layers):
        if vit:
            backbone[f"layer_{i}"] = {
                "attention": attention(h), "layernorm_before": norm(h),
                "layernorm_after": norm(h), "intermediate": dense(h, f),
                "output": dense(f, h)}
        else:
            backbone[f"layer_{i}"] = {
                "attention": attention(h), "layer_norm1": norm(h),
                "layer_norm2": norm(h), "fc1": dense(h, f),
                "fc2": dense(f, h)}
    return {"backbone": backbone}


def _draw_resnet(ec, normal, norm):
    """(params, batch_stats) of the ResNet encoder's backbone."""
    params, stats = {}, {}

    def conv_layer(n_in, n_out, k):
        stat = {"mean": np.zeros(n_out, np.float32),
                "var": np.ones(n_out, np.float32)}
        return ({"convolution": {"kernel": normal(
                    k, k, n_in, n_out, std=(k * k * n_in) ** -0.5)},
                 "normalization": norm(n_out)},
                {"normalization": stat})

    params["embedder"], stats["embedder"] = conv_layer(
        3, ec.resnet_embedding_size, 7)
    in_ch = ec.resnet_embedding_size
    for stage, (size, depth) in enumerate(zip(ec.resnet_hidden_sizes,
                                              ec.resnet_depths)):
        for i in range(depth):
            n_in = in_ch if i == 0 else size
            stride = (1 if stage == 0 else 2) if i == 0 else 1
            if ec.resnet_layer_type == "bottleneck":
                r = size // 4
                shapes = [(n_in, r, 1), (r, r, 3), (r, size, 1)]
            else:
                shapes = [(n_in, size, 3), (size, size, 3)]
            p, st = {}, {}
            for n, shape in enumerate(shapes):
                p[f"layer_{n}"], st[f"layer_{n}"] = conv_layer(*shape)
            if n_in != size or stride != 1:
                p["shortcut"], st["shortcut"] = conv_layer(n_in, size, 1)
            params[f"stage_{stage}_layer_{i}"] = p
            stats[f"stage_{stage}_layer_{i}"] = st
        in_ch = size
    return {"backbone": params}, {"backbone": stats}


def _draw_attention(ac, query_dim, memory_dim, dense):
    h = ac.hidden_dim

    def core(kind):
        if kind == AttentionType.SOFT:
            return {"query_proj": dense(query_dim, h),
                    "key_proj": dense(memory_dim, h),
                    "energy": dense(h, 1)}, memory_dim
        return {"query_proj": dense(query_dim, h),
                "key_proj": dense(memory_dim, h),
                "value_proj": dense(memory_dim, h),
                "output_proj": dense(h, h)}, h

    kind = ac.attention_type
    if kind in (AttentionType.SOFT, AttentionType.MULTI_HEAD):
        return core(kind)[0]
    base, ctx = core(AttentionType.MULTI_HEAD if ac.num_heads > 1
                     else AttentionType.SOFT)
    if kind == AttentionType.ADAPTIVE:
        return {"base_attention": base,
                "sentinel_gate": dense(2 * query_dim, h),
                "sentinel_proj": dense(h, h),
                "adaptive_weight": dense(ctx + h, 1)}
    if kind == AttentionType.AOA:
        return {"base_attention": base, "query_proj": dense(query_dim, h),
                "info_vector_proj": dense(ctx + h, h),
                "info_gate_proj": dense(ctx + h, h)}
    raise ValueError(f"Unsupported attention type: {kind}")


def _draw_decoder(mc, normal, dense, norm):
    # D: the pooled features' width; M: the attended features' (the
    # Q-Former's queries' where it runs)
    dc, D = mc.decoder, mc.encoder.feature_dim
    M = mc.projection_dim if mc.use_q_former else D
    H, V = dc.hidden_dim, mc.vocab_size
    if dc.decoder_type == DecoderType.LSTM:
        L = dc.num_layers
        return {"embedding": {"embedding": normal(V, H)},
                "lstm": {f"cell_{i}": {"gates": dense((2 * H if i == 0
                                                       else H) + H, 4 * H)}
                         for i in range(L)},
                "attention": _draw_attention(mc.attention, H, M, dense),
                "output_layer": dense(H, V),
                "init_h": dense(D, H * L), "init_c": dense(D, H * L)}
    if dc.decoder_type == DecoderType.TRANSFORMER:
        decoder = {"embedding": {"embedding": normal(V, H)},
                   "position_encoding": {"embedding": normal(dc.max_length,
                                                             H)}}
        for i in range(dc.num_layers):
            decoder[f"layer_{i}"] = {
                **{att: {n: dense(H, H) for n in ("q_proj", "k_proj",
                                                  "v_proj", "out_proj")}
                   for att in ("self_attn", "cross_attn")},
                "linear1": dense(H, 4 * H), "linear2": dense(4 * H, H),
                "norm1": norm(H), "norm2": norm(H), "norm3": norm(H)}
        decoder["output_layer"] = dense(H, V)
        decoder["visual_projection"] = dense(M, H)
        return decoder

    P = dc.prefix_length
    gpt = {"wte": {"embedding": normal(V, H)},
           "wpe": {"embedding": normal(dc.gpt2_n_positions, H)},
           "ln_f": norm(H)}
    for i in range(dc.num_layers):
        gpt[f"block_{i}"] = {
            "ln_1": norm(H), "ln_2": norm(H),
            "attn": {"c_attn": dense(H, 3 * H), "c_proj": dense(H, H)},
            "mlp": {"c_fc": dense(H, 4 * H), "c_proj": dense(4 * H, H)}}
    return {"backbone": gpt, "image_to_prefix": dense(D, P * H),
            "image_prefix": normal(1, P, H, std=1.0)}


def _stacked(params: List[nn.Parameter]) -> torch.Tensor:
    """One contiguous [L, ...] tensor of the layers' parameters; each
    parameter becomes a view of its slice, so the weights exist once."""
    stacked = torch.stack([p.detach() for p in params])
    for i, p in enumerate(params):
        p.data = stacked[i]
    return stacked


def _stack(layers, get) -> Dict[str, torch.Tensor]:
    """The STACK_KEYS operands of ``layers``; ``get(layer)`` names each
    layer's (qkv, out, norm1, norm2, fc, proj) modules."""
    mods = [get(layer) for layer in layers]
    out = {}
    for i, (w, b) in enumerate((("wqkv", "bqkv"), ("wo", "bo"),
                                ("g1", "b1"), ("g2", "b2"),
                                ("wfc", "bfc"), ("wpj", "bpj"))):
        out[w] = _stacked([m[i].weight for m in mods])
        out[b] = _stacked([m[i].bias for m in mods])
    return out


def _concatenated(params: List[nn.Parameter]) -> torch.Tensor:
    """One contiguous tensor of the parameters joined on axis 0; each
    parameter becomes a view of its rows, so the weights exist once."""
    joined = torch.cat([p.detach() for p in params])
    row = 0
    for p in params:
        p.data = joined[row:row + p.shape[0]]
        row += p.shape[0]
    return joined


def stack_layer_weights(model) -> None:
    """Build the operands the decode and encode kernels read, once, after
    the dtype cast; every layer's parameters become views of them.

    * GPT-2 decoder: ``model.decoder.stack`` (its blocks) and CLIP encoder:
      ``model.encoder.backbone.stack`` (its layers), the layer-stacked
      weights of the whole-stack kernels, keyed as the JAX package's
      ``STACK_WEIGHT_KEYS``. Matrices keep the ``nn.Linear`` layout
      ``[L, out, in]``; the LayerNorm scales and biases (g1, b1, g2, b2)
      stay in their float32 dtype, as flax keeps them.
    * Transformer decoder: each layer's ``self_attn.wqkv`` [3H, H] and
      ``bqkv`` [3H], the q/k/v projections concatenated in that order, as
      the JAX fold concatenates them for its kernel.

    Other decoders and encoders need no load-time operands.
    """
    # the models import this module: import them when it runs
    from .models.decoders import TransformerDecoder
    from .models.encoders import CLIPVisionBackbone
    from .models.gpt2 import GPT2Decoder

    dec = model.decoder
    backbone = getattr(model.encoder, "backbone", None)
    if isinstance(dec, GPT2Decoder):
        dec.stack = _stack(
            dec.backbone.blocks,
            lambda b: (b.attn.c_attn, b.attn.c_proj, b.ln_1, b.ln_2,
                       b.mlp.c_fc, b.mlp.c_proj))
    elif isinstance(dec, TransformerDecoder):
        for layer in dec.layers:
            sa = layer.self_attn
            projs = (sa.q_proj, sa.k_proj, sa.v_proj)
            sa.wqkv = _concatenated([m.weight for m in projs])
            sa.bqkv = _concatenated([m.bias for m in projs])
    if isinstance(backbone, CLIPVisionBackbone):
        backbone.stack = _stack_clip(backbone)


def _stack_clip(backbone) -> Dict[str, torch.Tensor]:
    """The encoder kernel's stacked weights of a CLIP vision tower."""
    return _stack(backbone.layers,
                  lambda m: (m.attention.qkv, m.attention.out, m.layer_norm1,
                             m.layer_norm2, m.fc1, m.fc2))
