"""Composed captioning model: CLIP vision tower -> GPT-2 decoder.

Counterpart of ``image_captioning_ml_project_tpu.models.captioning_model.
ImageCaptioningModel`` for the encoder/decoder pair this slice ports, with
the same uniform decode interface (``init_cache``/``step``) consumed by
:mod:`..inference.decoding`. Other encoder or decoder families, and the
Q-Former, raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config import Config, DecoderType, EncoderType
from ..params import from_flax, init_flax_params
from ..utils.amp import cast_float_params
from .encoders import CLIPEncoder
from .gpt2 import GPT2Decoder


class ImageCaptioningModel(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        mc = config.model
        if (mc.encoder.encoder_type != EncoderType.CLIP
                or mc.encoder.use_object_features):
            raise NotImplementedError(
                f"encoder {mc.encoder.encoder_type.value!r} is not yet ported"
                f" to PyTorch (ROADMAP.md Queue 1: other encoders)")
        if mc.decoder.decoder_type != DecoderType.GPT2:
            raise NotImplementedError(
                f"decoder {mc.decoder.decoder_type.value!r} is not yet "
                f"ported to PyTorch (ROADMAP.md Queue 1: Transformer/LSTM "
                f"decoders)")
        if mc.use_q_former:
            raise NotImplementedError(
                "the Q-Former is not yet ported to PyTorch (ROADMAP.md "
                "Queue 1: other encoders and the Q-Former)")
        self.config = config
        self.encoder = CLIPEncoder(mc.encoder, config.image_size)
        self.decoder = GPT2Decoder(
            mc.decoder, vocab_size=mc.vocab_size,
            pad_token_id=mc.pad_token_id, feature_dim=mc.encoder.feature_dim)

    def encode(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3] NHWC (uint8, or already-normalised float) ->
        encoder-feature dict."""
        return self.encoder(images)

    def forward(self, images: torch.Tensor,
                captions: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward: caption logits [B, T, V]."""
        return self.decoder(self.encode(images), captions)

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
    (:func:`..params.init_flax_params`). The weights are cast once to
    ``config.model.dtype``, norms excepted
    (:func:`..utils.amp.cast_float_params`).
    """
    if params is None:
        params = init_flax_params(config, config.seed)
    with torch.device("meta"):
        model = ImageCaptioningModel(config)
    model.load_state_dict(from_flax(params), strict=True, assign=True)
    model = model.to(device).eval().requires_grad_(False)
    dtype = getattr(torch, config.model.dtype)
    if dtype != torch.float32:
        cast_float_params(model, dtype)
    return model
