"""CLIP text tower and image-text scorer (HF ``CLIPModel``-compatible), in
PyTorch.

Counterpart of ``image_captioning_ml_project_tpu.models.clip_text``: the
scorer behind CLIP reranking (:mod:`..inference.reranking`). The vision
tower is the captioning encoder's :class:`.encoders.CLIPVisionBackbone`,
so on a CUDA device its layers run through the whole-stack encoder kernel
(:func:`..ops.encoder_stack.encoder_stack`, #5) once its stacked weights
are built (:func:`..params.load_scorer` builds them). The text tower is
per-layer PyTorch, causal, as the JAX package's is plain XLA. The scorer
runs in float32; ``logit_scale`` is a float32 scalar.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .encoders import CLIPLayer, CLIPVisionBackbone
from .layers import LayerNorm

_NEG_INF = -1e9


class CLIPTextBackbone(nn.Module):
    """Token and position embeddings, causal pre-LN layers with quick-gelu
    MLPs, a final LayerNorm, and EOT pooling: the hidden state at each
    sequence's first ``eos_token_id``, or, for the legacy ``eos_token_id``
    2 or None of the OpenAI hub configs, at ``argmax(input_ids)`` (CLIP's
    EOT is the largest id of its vocabulary)."""

    def __init__(self, vocab_size: int = 49408, hidden_size: int = 512,
                 num_layers: int = 12, num_heads: int = 8,
                 mlp_ratio: int = 4, max_positions: int = 77,
                 eos_token_id: Optional[int] = 49407):
        super().__init__()
        h = hidden_size
        self.eos_token_id = eos_token_id
        self.token_embedding = nn.Embedding(vocab_size, h)
        self.position_embeddings = nn.Parameter(torch.zeros(max_positions, h))
        self.layers = nn.ModuleList(
            CLIPLayer(h, num_heads, h * mlp_ratio) for _ in range(num_layers))
        self.final_layernorm = LayerNorm(h, eps=1e-5)

    def forward(self, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids [B, T] -> (hidden states [B, T, h], pooled [B, h])."""
        B, T = input_ids.shape
        x = self.token_embedding(input_ids)
        x = x + self.position_embeddings[:T].to(x.dtype)[None]
        causal = torch.ones((T, T), dtype=torch.bool,
                            device=input_ids.device).tril()
        bias = torch.zeros((T, T), device=input_ids.device).masked_fill(
            ~causal, _NEG_INF)[None, None]
        for layer in self.layers:
            x = layer(x, bias)
        x = self.final_layernorm(x)
        if self.eos_token_id is None or self.eos_token_id == 2:
            eot = torch.argmax(input_ids, dim=-1)
        else:
            eot = torch.argmax((input_ids == self.eos_token_id).int(), dim=-1)
        return x, x[torch.arange(B, device=x.device), eot]


class CLIPScorer(nn.Module):
    """Vision tower + text tower + bias-free projections + ``logit_scale``.
    ``encode_image`` / ``encode_text`` give L2-normalised features;
    calling the scorer gives the cosine-similarity logits
    ``exp(logit_scale) * img @ txt.T`` [B_img, B_txt]."""

    def __init__(self, vision_hidden: int = 768, vision_layers: int = 12,
                 vision_heads: int = 12, patch_size: int = 32,
                 image_size: int = 224, text_vocab: int = 49408,
                 text_hidden: int = 512, text_layers: int = 12,
                 text_heads: int = 8,
                 text_eos_token_id: Optional[int] = 49407,
                 text_max_positions: int = 77, projection_dim: int = 512):
        super().__init__()
        self.image_size = image_size
        self.vision = CLIPVisionBackbone(
            hidden_size=vision_hidden, num_layers=vision_layers,
            num_heads=vision_heads, patch_size=patch_size,
            image_size=image_size)
        self.text = CLIPTextBackbone(
            vocab_size=text_vocab, hidden_size=text_hidden,
            num_layers=text_layers, num_heads=text_heads,
            eos_token_id=text_eos_token_id, max_positions=text_max_positions)
        self.visual_projection = nn.Linear(vision_hidden, projection_dim,
                                           bias=False)
        self.text_projection = nn.Linear(text_hidden, projection_dim,
                                         bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(2.6592))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """CLIP-normalised float NHWC images -> unit features [B, P]."""
        _, pooled = self.vision(images)
        feat = self.visual_projection(pooled)
        return feat / torch.linalg.norm(feat, dim=-1, keepdim=True)

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """CLIP token ids [B, T] -> unit features [B, P]."""
        _, pooled = self.text(input_ids)
        feat = self.text_projection(pooled)
        return feat / torch.linalg.norm(feat, dim=-1, keepdim=True)

    def forward(self, images: torch.Tensor,
                input_ids: torch.Tensor) -> torch.Tensor:
        img = self.encode_image(images)
        txt = self.encode_text(input_ids)
        return torch.exp(self.logit_scale) * img @ txt.T
