"""Swin Transformer image encoder (HF ``SwinModel``-compatible), the
counterpart of ``image_captioning_ml_project_tpu.models.swin``.

features = the final stage's tokens, projected to ``feature_dim`` when the
final width (``8 x embed``) differs from it; pooled = their mean; the
attention mask is all ones. Window attention partitions the token grid
into static windows by reshapes, adds the relative position bias gathered
from its table by a fixed index, and shifts every second block by half a
window with ``torch.roll`` under the shift mask (-100 across the shifted
regions, as HF). A grid that is not a multiple of the window is
zero-padded right and bottom before partitioning and cropped after (HF's
``maybe_pad``); an odd grid is padded before the patch merge. The index
and the shift mask are numpy, built once per resolution, and copied once
to each device. Scores and the bias are float32 (the table stays float32
under :func:`..utils.amp.cast_float_params`, as the JAX policy keeps it),
the softmax is rounded to the value dtype. Stochastic depth is left out,
as in the JAX package (HF applies it in training only). Plain PyTorch
modules: the JAX package reaches no kernel here.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.coco import normalize_images
from .encoders import PatchEmbed
from .layers import LayerNorm


@functools.lru_cache(maxsize=None)
def _relative_position_index(window_size: int) -> np.ndarray:
    """Swin's relative position index, [w*w, w*w]."""
    coords = np.stack(np.meshgrid(np.arange(window_size),
                                  np.arange(window_size), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window_size - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 0] *= 2 * window_size - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _shift_attn_mask(H: int, W: int, window_size: int,
                     shift: int) -> np.ndarray:
    """The additive mask of shifted windows, [num_windows, w*w, w*w]
    float32: -100 between tokens of different regions, else 0."""
    img_mask = np.zeros((H, W))
    slices = (slice(0, -window_size), slice(-window_size, -shift),
              slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    m = img_mask.reshape(H // window_size, window_size, W // window_size,
                         window_size)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


_ON_DEVICE: Dict[tuple, torch.Tensor] = {}


def _on_device(make, *key, device) -> torch.Tensor:
    """``torch.from_numpy(make(*key))`` on ``device``, copied there once."""
    k = (make.__name__, *key, str(device))
    if k not in _ON_DEVICE:
        # a normal tensor even when first asked for under inference_mode:
        # training's backward saves the index
        with torch.inference_mode(False):
            _ON_DEVICE[k] = torch.from_numpy(np.ascontiguousarray(
                make(*key))).to(device)
    return _ON_DEVICE[k]


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, w*w, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def window_reverse(x: torch.Tensor, w: int, B: int, H: int,
                   W: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    C = x.shape[-1]
    x = x.reshape(B, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class SwinWindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [nW_total, w*w, C]; ``attn_mask`` [nW, w*w, w*w] or None."""
        nWt, N, C = x.shape
        nh = self.num_heads
        hd = C // nh

        def heads(y):
            return y.reshape(nWt, N, nh, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), \
            heads(self.value(x))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / (hd ** 0.5)
        index = _on_device(_relative_position_index, self.window_size,
                           device=x.device).reshape(-1)
        bias = self.relative_position_bias_table[index].reshape(N, N, nh)
        scores = scores + bias.permute(2, 0, 1)[None].float()
        if attn_mask is not None:
            nW = attn_mask.shape[0]
            scores = (scores.reshape(nWt // nW, nW, nh, N, N)
                      + attn_mask[None, :, None]).reshape(nWt, nh, N, N)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(nWt, N, C)
        return self.out(out)


class SwinLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, input_resolution: int, mlp_ratio: int = 4):
        super().__init__()
        self.resolution = input_resolution
        self.window = min(window_size, input_resolution)
        self.shift = 0 if self.window >= input_resolution else shift_size
        self.layernorm_before = LayerNorm(dim, eps=1e-5)
        self.attention = SwinWindowAttention(dim, num_heads, self.window)
        self.layernorm_after = LayerNorm(dim, eps=1e-5)
        self.intermediate = nn.Linear(dim, dim * mlp_ratio)
        self.output = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H*W, C] with H = W = the input resolution."""
        H = W = self.resolution
        w, shift = self.window, self.shift
        B, L, C = x.shape
        res = x
        x = self.layernorm_before(x).reshape(B, H, W, C)
        pad = (-H) % w
        Hp = H + pad
        if pad:
            x = F.pad(x, (0, 0, 0, pad, 0, pad))
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = _on_device(_shift_attn_mask, Hp, Hp, w, shift,
                              device=x.device)
        x = window_reverse(self.attention(window_partition(x, w), mask),
                           w, B, Hp, Hp)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        if pad:
            x = x[:, :H, :W]
        x = res + x.reshape(B, L, C)
        y = self.output(F.gelu(self.intermediate(self.layernorm_after(x))))
        return x + y


class SwinPatchMerging(nn.Module):
    """HF's gather order ``[0::2, 0::2], [1::2, 0::2], [0::2, 1::2],
    [1::2, 1::2]``, LayerNorm, then a bias-free reduction to 2C; an odd
    resolution is padded right and bottom first."""

    def __init__(self, dim: int, input_resolution: int):
        super().__init__()
        self.resolution = input_resolution
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H = W = self.resolution
        B, _, C = x.shape
        x = x.reshape(B, H, W, C)
        if H % 2:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(B, -1, 4 * C)
        return self.reduction(self.norm(x))


class SwinBackbone(nn.Module):
    """Patch embedding (stride 4, with bias), LayerNorm, the stages of
    Swin layers with a patch merge between them, a final LayerNorm:
    [B, tokens, 8 * embed]."""

    def __init__(self, image_size: int = 224, patch_size: int = 4,
                 embed_dim: int = 128, depths=(2, 2, 18, 2),
                 num_heads=(4, 8, 16, 32), window_size: int = 7,
                 mlp_ratio: int = 4):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(embed_dim, patch_size, use_bias=True)
        self.embed_norm = LayerNorm(embed_dim, eps=1e-5)
        res, dim = image_size // patch_size, embed_dim
        self.stages = nn.ModuleList()
        self.downsamples = nn.ModuleList()
        for stage, (depth, nh) in enumerate(zip(depths, num_heads)):
            self.stages.append(nn.ModuleList(
                SwinLayer(dim, nh, window_size,
                          0 if i % 2 == 0 else window_size // 2, res,
                          mlp_ratio) for i in range(depth)))
            if stage < len(depths) - 1:
                self.downsamples.append(SwinPatchMerging(dim, res))
                res, dim = (res + 1) // 2, 2 * dim
        self.layernorm = LayerNorm(dim, eps=1e-5)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B = images.shape[0]
        x = self.patch_embed(images).reshape(B, -1, self.embed_dim)
        x = self.embed_norm(x)
        for stage, layers in enumerate(self.stages):
            for layer in layers:
                x = layer(x)
            if stage < len(self.downsamples):
                x = self.downsamples[stage](x)
        return self.layernorm(x)


class SwinEncoder(nn.Module):
    """features = the final tokens (projected to ``feature_dim`` where the
    final width differs), pooled = their mean, mask all ones. A uint8 batch
    is normalised first: the JAX trainer folds the normalisation into the
    patch embed for ViT and CLIP only."""

    def __init__(self, config, image_size: int):
        super().__init__()
        self.backbone = SwinBackbone(
            image_size=image_size, embed_dim=config.swin_embed_dim,
            depths=tuple(config.swin_depths),
            num_heads=tuple(config.swin_num_heads),
            window_size=config.swin_window_size,
            mlp_ratio=config.mlp_ratio)
        self.freeze = config.freeze
        final = config.swin_embed_dim * 2 ** (len(config.swin_depths) - 1)
        self.proj = (nn.Linear(final, config.feature_dim)
                     if final != config.feature_dim else None)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        if images.dtype == torch.uint8:
            images = normalize_images(images)
        with torch.no_grad() if self.freeze else contextlib.nullcontext():
            features = self.backbone(images)
        if self.proj is not None:
            features = self.proj(features)
        B, S = features.shape[:2]
        return {"features": features, "pooled_features": features.mean(1),
                "attention_mask": torch.ones((B, S), dtype=torch.bool,
                                             device=features.device)}
