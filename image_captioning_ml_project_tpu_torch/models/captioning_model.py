"""Composed captioning model: vision encoder -> caption decoder.

Counterpart of ``image_captioning_ml_project_tpu.models.captioning_model.
ImageCaptioningModel`` for the families ported so far (encoders: CLIP,
ViT, ResNet; decoders: GPT-2, Transformer, LSTM with the four attention
variants), with the same uniform decode interface
(``init_cache``/``step``) consumed by every strategy of
:mod:`..inference.decoding` (greedy, nucleus sampling, beam search with or
without diverse groups), and the decoders' own greedy ``generate``. Other
encoder or decoder families, and the Q-Former, raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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
                "Queue 1 item 6: other encoders and the Q-Former)")
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
        """Teacher-forced forward: caption logits [B, T, V]."""
        return self.decoder(self.encode(images), captions)

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


def load_model(config: Config, device,
               params: Optional[Any] = None) -> ImageCaptioningModel:
    """Build the model on ``device`` in inference mode.

    ``params`` is the JAX package's variable tree (nested dict of arrays,
    with or without the top-level ``"params"``); when None, weights are
    drawn from ``numpy.random.RandomState(config.seed)``
    (:func:`..params.init_flax_params`). Convolution weights are kept in
    the ``channels_last`` memory format. The weights are cast once to
    ``config.model.dtype``, norms excepted
    (:func:`..utils.amp.cast_float_params`), and then stacked over layers
    for the whole-stack kernels and concatenated for the folded decode
    (:func:`..params.stack_layer_weights`).
    """
    if params is None:
        params = init_flax_params(config, config.seed)
    with torch.device("meta"):
        model = ImageCaptioningModel(config)
    model.load_state_dict(from_flax(params), strict=True, assign=True)
    model = model.to(device, memory_format=torch.channels_last)
    model = model.eval().requires_grad_(False)
    dtype = getattr(torch, config.model.dtype)
    if dtype != torch.float32:
        cast_float_params(model, dtype)
    stack_layer_weights(model)
    return model
