"""HuggingFace torch state dicts -> this package's parameter names: the
counterpart of the JAX package's ``models.hf_port``, from HF torch to
torch with no flax layout in between.

Each converter takes a mapping of name -> torch tensor or numpy array (an
HF model's ``state_dict()``) and returns an f32 state-dict fragment under
this package's model names: ``encoder.backbone.…`` for
:func:`port_clip_vision` (HF ``CLIPVisionModel``), :func:`port_vit`
(``ViTModel``), :func:`port_swin` (``SwinModel``) and :func:`port_resnet`
(``ResNetModel``); ``decoder.backbone.…`` for :func:`port_gpt2`
(``GPT2LMHeadModel`` or ``GPT2Model``). Layouts carried across:

* ``nn.Linear`` weights are ``[out, in]`` on both sides: copied;
* GPT-2's ``Conv1D`` weights are ``[in, out]``: transposed (the JAX
  converter copies them, since flax kernels are ``[in, out]`` too);
* CLIP's and ViT's separate q/k/v projections are concatenated in that
  order into the one QKV projection (:class:`.encoders.
  TransformerSelfAttention`); Swin's stay apart;
* the patch convolution ``[H, C, P, P]`` becomes the patch embed's
  ``[H, P*P*C]`` in (kh, kw, c) order (:class:`.encoders.PatchEmbed`);
* ResNet's convolutions keep ``nn.Conv2d``'s layout; each BatchNorm's
  weight, bias and running statistics go to :class:`.encoders.BatchNorm`.

Every key of the HF state dict is consumed or is one of the converter's
buffers dropped by name (CLIP's ``embeddings.position_ids``; GPT-2's
legacy ``h.{i}.attn.bias`` / ``attn.masked_bias`` and ``lm_head.weight``,
which must equal ``wte``; Swin's ``relative_position_index``, which
:mod:`.swin` rebuilds; ResNet's ``num_batches_tracked``): any other key
raises, where the JAX converters skip it. A key a converter needs and the
state dict lacks raises too.

A fragment holds the backbone only. Merge it into a whole state, for
example ``params.from_flax(params.init_flax_params(config, seed))`` for the
seeded projection and image prefix, and build from that with
:func:`.captioning_model.load_model` (``state_dict=``) or
:func:`.captioning_model.build_train_model`: the dtype cast and the
layer-stacked operands of the kernels (``params.stack_layer_weights``) are
then derived from the HF weights. Never load a fragment into a model that
``load_model`` has built: its parameters are views of operands cast and
stacked once, at its build.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Sequence

import numpy as np
import torch

# the buffers each converter drops by name
POSITION_IDS = r"(^|\.)embeddings\.position_ids$"
_GPT2_DROP = (r"(^|\.)h\.\d+\.attn\.(bias|masked_bias)$", r"^lm_head\.weight$")
_SWIN_DROP = (r"\.relative_position_index$",)
_RESNET_DROP = (r"\.num_batches_tracked$",)


class HFState:
    """An HF state dict read by name, and the fragment written from it:
    :meth:`take` records each name it reads, :meth:`put` stores a float32
    contiguous copy, :meth:`done` returns the fragment after checking that
    every key was read or matches one of the ``drop`` patterns."""

    def __init__(self, sd: Mapping, drop: Sequence[str] = ()):
        self.sd = sd
        self.drop = [re.compile(p) for p in drop]
        self.used = set()
        self.out: Dict[str, torch.Tensor] = {}

    def take(self, name: str) -> torch.Tensor:
        if name not in self.sd:
            raise KeyError(f"the HF state dict has no {name!r}")
        self.used.add(name)
        value = self.sd[name]
        return value if isinstance(value, torch.Tensor) else torch.tensor(
            np.asarray(value))

    def put(self, name: str, t: torch.Tensor) -> None:
        self.out[name] = torch.empty_like(
            t, dtype=torch.float32,
            memory_format=torch.contiguous_format).copy_(t.detach())

    def linear(self, src: str, dst: str, bias: bool = True) -> None:
        """An ``nn.Linear`` or a LayerNorm: weight (and bias) as they are."""
        self.put(f"{dst}.weight", self.take(f"{src}.weight"))
        if bias:
            self.put(f"{dst}.bias", self.take(f"{src}.bias"))

    def conv1d(self, src: str, dst: str) -> None:
        """GPT-2's ``Conv1D`` [in, out] -> ``nn.Linear`` [out, in]."""
        self.put(f"{dst}.weight", self.take(f"{src}.weight").T)
        self.put(f"{dst}.bias", self.take(f"{src}.bias"))

    def qkv(self, srcs: Iterable[str], dst: str) -> None:
        """Three projections joined on the output axis, in order."""
        srcs = list(srcs)
        for n in ("weight", "bias"):
            self.put(f"{dst}.{n}",
                     torch.cat([self.take(f"{s}.{n}") for s in srcs]))

    def patch(self, src: str, dst: str) -> None:
        """A patch convolution [H, C, P, P] -> [H, P*P*C], (kh, kw, c)."""
        w = self.take(src)
        self.put(dst, w.permute(0, 2, 3, 1).reshape(w.shape[0], -1))

    def batch_norm(self, src: str, dst: str) -> None:
        for n in ("weight", "bias", "running_mean", "running_var"):
            self.put(f"{dst}.{n}", self.take(f"{src}.{n}"))

    def done(self) -> Dict[str, torch.Tensor]:
        left = sorted(k for k in self.sd if k not in self.used
                      and not any(p.search(k) for p in self.drop))
        if left:
            raise ValueError(f"HF keys neither mapped nor dropped: {left}")
        return self.out


def clip_layers(st: HFState, src: str, dst: str,
                layers: Iterable[int]) -> None:
    """HF ``CLIPEncoderLayer``s ``{src}.{i}`` -> ``{dst}.layers.{i}``
    (:class:`.encoders.CLIPLayer`), the vision and the text towers'."""
    for i in layers:
        a, b = f"{src}.{i}", f"{dst}.layers.{i}"
        st.qkv([f"{a}.self_attn.{p}_proj" for p in "qkv"],
               f"{b}.attention.qkv")
        st.linear(f"{a}.self_attn.out_proj", f"{b}.attention.out")
        st.linear(f"{a}.layer_norm1", f"{b}.layer_norm1")
        st.linear(f"{a}.layer_norm2", f"{b}.layer_norm2")
        st.linear(f"{a}.mlp.fc1", f"{b}.fc1")
        st.linear(f"{a}.mlp.fc2", f"{b}.fc2")


def clip_vision(st: HFState, src: str, dst: str,
                layers: Iterable[int]) -> None:
    """HF ``CLIPVisionTransformer`` under ``src`` ->
    :class:`.encoders.CLIPVisionBackbone` under ``dst``."""
    st.patch(f"{src}.embeddings.patch_embedding.weight",
             f"{dst}.patch_embed.weight")
    st.put(f"{dst}.class_embedding",
           st.take(f"{src}.embeddings.class_embedding"))
    st.put(f"{dst}.position_embeddings",
           st.take(f"{src}.embeddings.position_embedding.weight"))
    # HF's attribute is spelled "pre_layrnorm"
    st.linear(f"{src}.pre_layrnorm", f"{dst}.pre_layernorm")
    st.linear(f"{src}.post_layernorm", f"{dst}.post_layernorm")
    clip_layers(st, f"{src}.encoder.layers", dst, layers)


def port_clip_vision(sd: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """HF ``CLIPVisionModel`` state dict -> ``encoder.backbone.…``."""
    st = HFState(sd, drop=(POSITION_IDS,))
    clip_vision(st, "vision_model", "encoder.backbone", range(num_layers))
    return st.done()


def port_gpt2(sd: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """HF ``GPT2LMHeadModel`` (keys under ``transformer.``) or
    ``GPT2Model`` state dict -> ``decoder.backbone.…``; the four
    ``Conv1D`` weights of each block transposed."""
    pre = "transformer." if any(k.startswith("transformer.")
                                for k in sd) else ""
    st = HFState(sd, drop=_GPT2_DROP)
    out = "decoder.backbone"
    wte = st.take(f"{pre}wte.weight")
    st.put(f"{out}.wte.weight", wte)
    st.put(f"{out}.wpe.weight", st.take(f"{pre}wpe.weight"))
    for i in range(num_layers):
        src, dst = f"{pre}h.{i}", f"{out}.blocks.{i}"
        st.linear(f"{src}.ln_1", f"{dst}.ln_1")
        st.conv1d(f"{src}.attn.c_attn", f"{dst}.attn.c_attn")
        st.conv1d(f"{src}.attn.c_proj", f"{dst}.attn.c_proj")
        st.linear(f"{src}.ln_2", f"{dst}.ln_2")
        st.conv1d(f"{src}.mlp.c_fc", f"{dst}.mlp.c_fc")
        st.conv1d(f"{src}.mlp.c_proj", f"{dst}.mlp.c_proj")
    st.linear(f"{pre}ln_f", f"{out}.ln_f")
    head = sd.get("lm_head.weight")
    if head is not None:
        head = torch.as_tensor(head)
        if not head.is_meta and not torch.equal(head, wte):
            raise ValueError("lm_head.weight differs from wte.weight: the "
                             "port's GPT-2 ties its LM head to wte")
    return st.done()


def port_vit(sd: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """HF ``ViTModel`` state dict (with its pooler) ->
    ``encoder.backbone.…``."""
    st = HFState(sd)
    out = "encoder.backbone"
    emb = "embeddings.patch_embeddings.projection"
    st.patch(f"{emb}.weight", f"{out}.patch_embed.weight")
    st.put(f"{out}.patch_embed.bias", st.take(f"{emb}.bias"))
    st.put(f"{out}.cls_token", st.take("embeddings.cls_token"))
    st.put(f"{out}.position_embeddings",
           st.take("embeddings.position_embeddings"))
    st.linear("layernorm", f"{out}.layernorm")
    st.linear("pooler.dense", f"{out}.pooler")
    for i in range(num_layers):
        src, dst = f"encoder.layer.{i}", f"{out}.layers.{i}"
        st.qkv([f"{src}.attention.attention.{n}"
                for n in ("query", "key", "value")], f"{dst}.attention.qkv")
        st.linear(f"{src}.attention.output.dense", f"{dst}.attention.out")
        st.linear(f"{src}.layernorm_before", f"{dst}.layernorm_before")
        st.linear(f"{src}.layernorm_after", f"{dst}.layernorm_after")
        st.linear(f"{src}.intermediate.dense", f"{dst}.intermediate")
        st.linear(f"{src}.output.dense", f"{dst}.output")
    return st.done()


def port_swin(sd: Mapping, depths: Sequence[int]) -> Dict[str, torch.Tensor]:
    """HF ``SwinModel`` state dict -> ``encoder.backbone.…``: blocks to
    ``stages.{s}.{b}``, the patch merges to ``downsamples.{s}`` (none
    after the last stage)."""
    st = HFState(sd, drop=_SWIN_DROP)
    out = "encoder.backbone"
    emb = "embeddings.patch_embeddings.projection"
    st.patch(f"{emb}.weight", f"{out}.patch_embed.weight")
    st.put(f"{out}.patch_embed.bias", st.take(f"{emb}.bias"))
    st.linear("embeddings.norm", f"{out}.embed_norm")
    st.linear("layernorm", f"{out}.layernorm")
    for s, depth in enumerate(depths):
        stage = f"encoder.layers.{s}"
        for b in range(depth):
            src, dst = f"{stage}.blocks.{b}", f"{out}.stages.{s}.{b}"
            for n in ("query", "key", "value"):
                st.linear(f"{src}.attention.self.{n}",
                          f"{dst}.attention.{n}")
            st.linear(f"{src}.attention.output.dense", f"{dst}.attention.out")
            st.put(f"{dst}.attention.relative_position_bias_table",
                   st.take(f"{src}.attention.self."
                           f"relative_position_bias_table"))
            st.linear(f"{src}.layernorm_before", f"{dst}.layernorm_before")
            st.linear(f"{src}.layernorm_after", f"{dst}.layernorm_after")
            st.linear(f"{src}.intermediate.dense", f"{dst}.intermediate")
            st.linear(f"{src}.output.dense", f"{dst}.output")
        if s < len(depths) - 1:
            st.linear(f"{stage}.downsample.norm",
                      f"{out}.downsamples.{s}.norm")
            st.linear(f"{stage}.downsample.reduction",
                      f"{out}.downsamples.{s}.reduction", bias=False)
    return st.done()


def port_resnet(sd: Mapping, depths: Sequence[int]
                ) -> Dict[str, torch.Tensor]:
    """HF ``ResNetModel`` state dict -> ``encoder.backbone.…``: the stem
    to ``embedder``, each stage's layers to ``stages.{s}.{l}`` with their
    conv layers ``layer_{n}`` and ``shortcut``."""
    st = HFState(sd, drop=_RESNET_DROP)
    out = "encoder.backbone"

    def conv_layer(src, dst):
        st.put(f"{dst}.convolution.weight",
               st.take(f"{src}.convolution.weight"))
        st.batch_norm(f"{src}.normalization", f"{dst}.normalization")

    conv_layer("embedder.embedder", f"{out}.embedder")
    for s, depth in enumerate(depths):
        for i in range(depth):
            src = f"encoder.stages.{s}.layers.{i}"
            dst = f"{out}.stages.{s}.{i}"
            n = 0
            while f"{src}.layer.{n}.convolution.weight" in sd:
                conv_layer(f"{src}.layer.{n}", f"{dst}.layer_{n}")
                n += 1
            if f"{src}.shortcut.convolution.weight" in sd:
                conv_layer(f"{src}.shortcut", f"{dst}.shortcut")
    return st.done()
