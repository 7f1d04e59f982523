"""Composed captioning model: vision encoder -> caption decoder.

Counterpart of ``image_captioning_ml_project_tpu.models.captioning_model.
ImageCaptioningModel`` for the families ported so far (encoders: CLIP,
ViT, ResNet; decoders: GPT-2, Transformer, LSTM with the four attention
variants): the teacher-forced forward that training differentiates (in
training mode: dropout, BatchNorm on batch statistics), the same uniform
decode interface (``init_cache``/``step``) consumed by every strategy of
:mod:`..inference.decoding` (greedy, nucleus sampling, beam search with or
without diverse groups), and the decoders' own greedy ``generate``. Other
encoder or decoder families, and the Q-Former, raise
``NotImplementedError`` naming their ROADMAP item.

Two builds: :func:`load_model` for decoding (weights cast once and
stacked for the kernels, inference mode) and :func:`build_train_model`
for training (f32 master weights, each parameter its own tensor).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from ..config import Config
from ..params import from_flax, init_flax_params, stack_layer_weights
from ..utils.amp import cast_float_params
from .decoders import build_decoder
from .encoders import build_encoder


class ImageCaptioningModel(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        mc = config.model
        if mc.use_q_former:
            raise NotImplementedError(
                "the Q-Former is not yet ported to PyTorch (ROADMAP.md "
                "Queue 1 item 10: other encoders and the Q-Former)")
        self.config = config
        self.encoder = build_encoder(mc.encoder, config.image_size)
        self.decoder = build_decoder(
            mc.decoder, vocab_size=mc.vocab_size,
            pad_token_id=mc.pad_token_id, bos_token_id=mc.bos_token_id,
            eos_token_id=mc.eos_token_id, feature_dim=mc.encoder.feature_dim,
            attention_config=mc.attention)

    def encode(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3] NHWC (uint8, or already-normalised float) ->
        encoder-feature dict."""
        return self.encoder(images)

    def forward(self, images: torch.Tensor,
                captions: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward: the decoder's outputs (caption logits
        [B, T, V], ``hidden_states`` [B, T, H], the LSTM's
        ``attention_weights``) plus what the training losses read, as the
        JAX model returns it: the encoder's ``pooled_features`` and
        ``text_features``, the mean of the hidden states over the
        caption's non-pad positions."""
        encoder_features = self.encode(images)
        out = self.decoder(encoder_features, captions)
        out["pooled_features"] = encoder_features["pooled_features"]
        if "hidden_states" in out:
            hidden = out["hidden_states"]
            m = (captions != self.config.model.pad_token_id).to(
                hidden.dtype)[..., None]
            out["text_features"] = (hidden * m).sum(1) \
                / m.sum(1).clamp_min(1.0)
        return out

    def generate(self, images: torch.Tensor,
                 max_length: Optional[int] = None):
        """The decoder's greedy ``generate`` on the encoded images
        (``max_length`` defaults to ``config.inference.max_length``):
        (tokens [B, max_length], the decoder's extras)."""
        if max_length is None:
            max_length = self.config.inference.max_length
        return self.decoder.generate(self.encode(images), max_length)

    # -- uniform decode interface (delegates to the decoder) ----------------

    def init_cache(self, images: torch.Tensor, max_length: int):
        return self.decoder.init_cache(self.encode(images), max_length)

    def step(self, state: Dict[str, Any], tokens: torch.Tensor):
        return self.decoder.step(state, tokens)


def _initial_state(config: Config, params: Optional[Any],
                   state_dict: Optional[Mapping[str, torch.Tensor]]):
    """The f32 state dict a build starts from: a copy of the port's own
    (a checkpoint's, or a live model's: the build never shares its
    storage), else the JAX variable tree's through
    :func:`..params.from_flax`, else seeded weights."""
    if state_dict is not None:
        if params is not None:
            raise ValueError("give the weights as params or as state_dict, "
                             "not both")
        return {k: v.detach().to(torch.float32, copy=True)
                for k, v in state_dict.items()}
    if params is None:
        params = init_flax_params(config, config.seed)
    return from_flax(params)


def _build(config: Config, device, params, state_dict
           ) -> ImageCaptioningModel:
    with torch.device("meta"):
        model = ImageCaptioningModel(config)
    model.load_state_dict(_initial_state(config, params, state_dict),
                          strict=True, assign=True)
    return model.to(device, memory_format=torch.channels_last)


def load_model(config: Config, device, params: Optional[Any] = None,
               state_dict: Optional[Mapping[str, torch.Tensor]] = None
               ) -> ImageCaptioningModel:
    """Build the model on ``device`` for decoding, in inference mode.

    The weights are ``state_dict`` (this package's own, e.g. a
    checkpoint's model weights and BatchNorm statistics, any float dtype),
    or ``params``, the JAX package's variable tree (nested dict of arrays,
    with or without the top-level ``"params"``); with neither they are
    drawn from ``numpy.random.RandomState(config.seed)``
    (:func:`..params.init_flax_params`). Convolution weights are kept in
    the ``channels_last`` memory format. The weights are cast once to
    ``config.model.dtype``, norms excepted
    (:func:`..utils.amp.cast_float_params`), and then stacked over layers
    for the whole-stack kernels and concatenated for the folded decode
    (:func:`..params.stack_layer_weights`): the model's parameters become
    views of those operands, so it must not be trained.
    """
    model = _build(config, device, params, state_dict)
    model = model.eval().requires_grad_(False)
    dtype = getattr(torch, config.model.dtype)
    if dtype != torch.float32:
        cast_float_params(model, dtype)
    stack_layer_weights(model)
    return model


def build_train_model(config: Config, device, params: Optional[Any] = None,
                      state_dict: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> ImageCaptioningModel:
    """Build the model on ``device`` for training: the same weights as
    :func:`load_model` would take, kept as f32 master weights (the JAX
    trainer's params), neither cast nor stacked, each parameter its own
    tensor, in training mode with gradients on. A trainer computes in
    ``bfloat16`` by casting them at each step
    (:func:`..utils.amp.cast_for_compute`); decoding goes through a
    :func:`load_model` copy of them."""
    return _build(config, device, params, state_dict).train()
