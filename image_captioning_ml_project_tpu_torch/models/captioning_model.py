"""Composed captioning model: vision encoder -> (Q-Former) -> caption
decoder.

Counterpart of ``image_captioning_ml_project_tpu.models.captioning_model.
ImageCaptioningModel`` (encoders: CLIP, ViT, ResNet, Swin, object regions;
decoders: GPT-2, Transformer, LSTM with the four attention variants; the
optional BLIP-2 style Q-Former): the teacher-forced forward that training
differentiates (in training mode: dropout, BatchNorm on batch statistics),
the same uniform decode interface (``init_cache``/``step``) consumed by
every strategy of :mod:`..inference.decoding` (greedy, nucleus sampling,
beam search with or without diverse groups), and the decoders' own greedy
``generate``. The images argument is an NHWC batch, or for the
object-region encoder a dict of ``region_features``, ``region_boxes`` and
``region_mask``.

Two builds: :func:`load_model` for decoding (weights cast once and
stacked for the kernels, inference mode) and :func:`build_train_model`
for training (f32 master weights, each parameter its own tensor).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..params import from_flax, init_flax_params, stack_layer_weights
from ..utils.amp import cast_float_params
from .decoders import CachedMHA, build_decoder
from .encoders import build_encoder
from .layers import LayerNorm, dropout


class PreLNSelfAttentionLayer(nn.Module):
    """torch ``TransformerEncoderLayer(norm_first=True, gelu)``: pre-LN
    self-attention and exact-GELU FFN, dropout on the residual branches
    and inside the FFN in training mode."""

    def __init__(self, hidden_dim: int, num_heads: int, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.norm1 = LayerNorm(hidden_dim, eps=1e-5)
        self.self_attn = CachedMHA(hidden_dim, num_heads)
        self.norm2 = LayerNorm(hidden_dim, eps=1e-5)
        self.linear1 = nn.Linear(hidden_dim, 4 * hidden_dim)
        self.linear2 = nn.Linear(4 * hidden_dim, hidden_dim)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.training)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self._drop(F.gelu(self.linear1(x))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        x = x + self._drop(self.self_attn.full(y, y))
        return x + self._drop(self._ffn(self.norm2(x)))


class PreLNCrossAttentionLayer(PreLNSelfAttentionLayer):
    """torch ``TransformerDecoderLayer(norm_first=True, gelu)``: pre-LN
    self-attention, cross-attention over the memory (``memory_pad`` [B, S]
    True = masked), exact-GELU FFN, the same dropouts."""

    def __init__(self, hidden_dim: int, num_heads: int, rate: float = 0.0):
        super().__init__(hidden_dim, num_heads, rate)
        self.cross_attn = CachedMHA(hidden_dim, num_heads)
        self.norm3 = LayerNorm(hidden_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                memory_pad: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.norm1(x)
        x = x + self._drop(self.self_attn.full(y, y))
        ca = self.cross_attn
        x = x + self._drop(ca.attend_precomputed(
            self.norm2(x), *ca.project_kv(memory),
            key_padding_mask=memory_pad))
        return x + self._drop(self._ffn(self.norm3(x)))


class QFormer(nn.Module):
    """BLIP-2 style query transformer: ``num_queries`` learned queries
    through a pre-LN self-attention stack, then a pre-LN cross-attention
    stack over the vision features (projected to the query width by
    ``vision_proj`` where the widths differ). Plain PyTorch modules: the
    JAX Q-Former reaches no kernel."""

    def __init__(self, query_dim: int = 768, vision_dim: int = 768,
                 num_queries: int = 32, num_layers: int = 2,
                 num_heads: int = 8, rate: float = 0.0):
        super().__init__()
        self.query_tokens = nn.Parameter(torch.zeros(1, num_queries,
                                                     query_dim))
        self.vision_proj = (nn.Linear(vision_dim, query_dim)
                            if vision_dim != query_dim else None)
        self.encoder = nn.ModuleList(
            PreLNSelfAttentionLayer(query_dim, num_heads, rate)
            for _ in range(num_layers))
        self.decoder = nn.ModuleList(
            PreLNCrossAttentionLayer(query_dim, num_heads, rate)
            for _ in range(num_layers))

    def forward(self, vision_features: torch.Tensor,
                vision_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, S, vision_dim] features (``vision_mask`` [B, S], True =
        valid) -> the queries [B, num_queries, query_dim]."""
        if self.vision_proj is not None:
            vision_features = self.vision_proj(vision_features)
        B = vision_features.shape[0]
        x = self.query_tokens.to(vision_features.dtype).expand(B, -1, -1)
        for layer in self.encoder:
            x = layer(x)
        pad = None if vision_mask is None else ~vision_mask.bool()
        for layer in self.decoder:
            x = layer(x, vision_features, pad)
        return x


class ImageCaptioningModel(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        mc = config.model
        self.config = config
        self.encoder = build_encoder(mc.encoder, config.image_size,
                                     config.fold_normalize)
        self.decoder = build_decoder(
            mc.decoder, vocab_size=mc.vocab_size,
            pad_token_id=mc.pad_token_id, bos_token_id=mc.bos_token_id,
            eos_token_id=mc.eos_token_id, feature_dim=mc.encoder.feature_dim,
            memory_dim=memory_dim(mc), attention_config=mc.attention)
        # the Q-Former's dropout is the decoder's configured rate (the
        # reference's torch layers carry a dropout of their own)
        self.q_former = (QFormer(
            query_dim=mc.projection_dim, vision_dim=mc.encoder.feature_dim,
            num_queries=mc.q_former_num_queries,
            num_layers=mc.q_former_num_layers,
            num_heads=mc.q_former_num_heads, rate=mc.decoder.dropout)
            if mc.use_q_former else None)

    def encode(self, images) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3] NHWC (uint8, or already-normalised float),
        or a region-feature dict -> encoder-feature dict; with the
        Q-Former its queries replace the features, under an all-ones
        mask."""
        features = self.encoder(images)
        if self.q_former is not None:
            q = self.q_former(features["features"],
                              features["attention_mask"])
            features = dict(features, features=q, attention_mask=torch.ones(
                q.shape[:2], dtype=torch.bool, device=q.device))
        return features

    def forward(self, images, captions: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
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

    def generate(self, images, max_length: Optional[int] = None):
        """The decoder's greedy ``generate`` on the encoded images
        (``max_length`` defaults to ``config.inference.max_length``):
        (tokens [B, max_length], the decoder's extras)."""
        if max_length is None:
            max_length = self.config.inference.max_length
        return self.decoder.generate(self.encode(images), max_length)

    # -- uniform decode interface (delegates to the decoder) ----------------

    def init_cache(self, images, max_length: int):
        return self.decoder.init_cache(self.encode(images), max_length)

    def step(self, state: Dict[str, Any], tokens: torch.Tensor):
        return self.decoder.step(state, tokens)


def memory_dim(mc) -> int:
    """The width of the features the decoder attends to: the Q-Former's
    queries' where it runs, else the encoder's."""
    return mc.projection_dim if mc.use_q_former else mc.encoder.feature_dim


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
