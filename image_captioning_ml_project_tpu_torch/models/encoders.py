"""CLIP vision tower (HF ``CLIPVisionModel``-compatible), in PyTorch.

Counterpart of the CLIP part of ``image_captioning_ml_project_tpu.models.
encoders`` on its XLA path (the whole-stack Pallas encoder fold is not on
this slice). Images are NHWC, as in the JAX package. A ``uint8`` batch is
normalised on its device with the ImageNet constants (the JAX trainer's
``normalize_images`` before ``model.encode``); a float batch is taken as
already normalised. Every encoder returns the uniform dict
``{"features": [B, S, D], "pooled_features": [B, D], "attention_mask":
[B, S]}``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..data.coco import normalize_images
from .layers import LayerNorm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation (HF 'quick_gelu')."""
    return x * torch.sigmoid(1.702 * x)


class TransformerSelfAttention(nn.Module):
    """Multi-head self-attention with one ``[h, 3h]`` QKV projection (the
    flax module's unfused query/key/value params are concatenated by
    :func:`..params.from_flax`; each output column block is the same dot).
    Scores and softmax in f32, weights cast to the value dtype."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size)
        self.out = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, h = x.shape
        nh = self.num_heads
        hd = h // nh
        q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2)
                   for t in self.qkv(x).split(h, dim=-1))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / (hd ** 0.5)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(B, S, h)
        return self.out(out)


class CLIPLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden_size, eps=1e-5)
        self.attention = TransformerSelfAttention(hidden_size, num_heads)
        self.layer_norm2 = LayerNorm(hidden_size, eps=1e-5)
        self.fc1 = nn.Linear(hidden_size, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layer_norm1(x))
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class PatchEmbed(nn.Module):
    """Stride-P patch embedding as space-to-depth plus one matmul (no bias:
    CLIP's patch conv has none). The patch vector is flattened in
    (kh, kw, c) order, matching the flax conv kernel ``[P, P, C, H]``
    reshaped to ``[P*P*C, H]``; ``weight`` holds its transpose."""

    def __init__(self, hidden_size: int, patch_size: int, channels: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(
            torch.empty(hidden_size, patch_size * patch_size * channels))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, Hi, Wi, C = images.shape
        P = self.patch_size
        gh, gw = Hi // P, Wi // P
        x = images[:, :gh * P, :gw * P]  # conv-VALID drops the remainder
        x = x.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, gh, gw, P * P * C).to(self.weight.dtype)
        return F.linear(x, self.weight)


class CLIPVisionBackbone(nn.Module):
    """Class embedding + patch embedding + learned positions, pre-layernorm,
    pre-LN encoder layers with quick-gelu MLPs, post-layernorm on CLS."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_ratio: int = 4,
                 patch_size: int = 32, image_size: int = 224):
        super().__init__()
        h = hidden_size
        tokens = (image_size // patch_size) ** 2 + 1
        self.patch_embed = PatchEmbed(h, patch_size)
        self.class_embedding = nn.Parameter(torch.zeros(h))
        self.position_embeddings = nn.Parameter(torch.zeros(tokens, h))
        self.pre_layernorm = LayerNorm(h, eps=1e-5)
        self.layers = nn.ModuleList(
            CLIPLayer(h, num_heads, h * mlp_ratio) for _ in range(num_layers))
        self.post_layernorm = LayerNorm(h, eps=1e-5)

    def forward(self, images: torch.Tensor):
        B = images.shape[0]
        x = self.patch_embed(images)
        h = x.shape[-1]
        x = x.reshape(B, -1, h)
        cls = self.class_embedding.to(x.dtype).expand(B, 1, h)
        x = torch.cat([cls, x], dim=1)
        x = x + self.position_embeddings.to(x.dtype)[None]
        x = self.pre_layernorm(x)
        for layer in self.layers:
            x = layer(x)
        return x, self.post_layernorm(x[:, 0])


class CLIPEncoder(nn.Module):
    """features = patch tokens of the last hidden state (not
    post-layernormed), pooled = post-layernormed CLS; both projected to
    ``feature_dim`` when it differs from the tower's width."""

    def __init__(self, config, image_size: int):
        super().__init__()
        self.backbone = CLIPVisionBackbone(
            hidden_size=config.hidden_size, num_layers=config.num_layers,
            num_heads=config.num_heads, mlp_ratio=config.mlp_ratio,
            patch_size=config.patch_size, image_size=image_size)
        self.proj = (nn.Linear(config.hidden_size, config.feature_dim)
                     if config.hidden_size != config.feature_dim else None)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        if images.dtype == torch.uint8:
            images = normalize_images(images)
        x, pooled = self.backbone(images)
        features = x[:, 1:]
        if self.proj is not None:
            features = self.proj(features)
            pooled = self.proj(pooled)
        B, S = features.shape[:2]
        return {"features": features, "pooled_features": pooled,
                "attention_mask": torch.ones((B, S), dtype=torch.bool,
                                             device=features.device)}
