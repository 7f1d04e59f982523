"""Vision encoders in PyTorch: the CLIP vision tower (HF
``CLIPVisionModel``-compatible), ViT (HF ``ViTModel``-compatible), ResNet
(HF ``ResNetModel``-compatible, bottleneck or basic layers), the
object-region encoder over detector features, and Swin (:mod:`.swin`).

Counterpart of ``image_captioning_ml_project_tpu.models.encoders``. For CLIP, as there, ``ICT_ENCODER_FOLD`` (default on;
``0`` off; ``force`` means on) chooses, once per forward, between the
whole-stack encoder kernel (:func:`..ops.encoder_stack.encoder_stack`,
inference only: it is skipped in training mode and inside
:func:`.layers.plain_routes`) and the per-layer modules.
ViT and ResNet have no such fold in the JAX package and none here: their
layers are plain PyTorch modules (the ResNet's convolutions, plain XLA in
the JAX package, go to cuDNN, in the ``channels_last`` memory format so
that the NHWC images need no transpose). Images are NHWC, as in the JAX
package. A ``uint8`` batch
is normalised on its device with the ImageNet constants (the JAX trainer's
``normalize_images`` before ``model.encode``), except that under the
config's ``fold_normalize`` a ViT or CLIP encoder hands it to its patch
embed, which folds the affine into its matrix product (:class:`PatchEmbed`,
as the JAX trainer hands those two encoders raw pixels); a float batch is
taken as already normalised. Every encoder returns the uniform dict
``{"features": [B, S, D], "pooled_features": [B, D], "attention_mask":
[B, S]}``. :func:`build_encoder` picks the encoder from the config.

In training mode (``model.train()``), as the JAX encoders under
``train=True``: the ResNet's BatchNorm normalises with the batch's
statistics and updates its running ones; ``remat`` recomputes each CLIP or
ViT layer in the backward (``torch.utils.checkpoint``, as ``nn.remat``);
``freeze`` stops the gradient at the backbone's output (the projection
stays trainable) and keeps the ResNet's BatchNorm on its running
statistics. The encoders have no dropout, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..config import EncoderType, reads_regions
from ..data.coco import IMAGENET_MEAN, IMAGENET_STD, normalize_images
from ..ops.encoder_stack import encoder_stack
from ..parallel.sharding import all_reduce_sum
from .layers import LayerNorm, data_group, kernels_on


def encoder_fold_enabled() -> bool:
    """``ICT_ENCODER_FOLD``: anything but ``"0"`` (the default ``"1"``, or
    ``"force"``) runs the encoder layers through the whole-stack kernel."""
    return os.environ.get("ICT_ENCODER_FOLD", "1") != "0"


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation (HF 'quick_gelu')."""
    return x * torch.sigmoid(1.702 * x)


def run_layers(layers, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """The layers in turn; with ``remat`` in a gradient pass, each one's
    activations are recomputed in the backward instead of kept."""
    for layer in layers:
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(layer, x,
                                                  use_reentrant=False)
        else:
            x = layer(x)
    return x


class TransformerSelfAttention(nn.Module):
    """Multi-head self-attention with one ``[h, 3h]`` QKV projection (the
    flax module's unfused query/key/value params are concatenated by
    :func:`..params.from_flax`; each output column block is the same dot).
    Scores and softmax in f32, weights cast to the value dtype; an optional
    additive ``attn_bias`` (broadcast to [B, heads, S, S], e.g. the CLIP
    text tower's causal mask) joins the scores before the softmax."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size)
        self.out = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S, h = x.shape
        nh = self.num_heads
        hd = h // nh
        q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2)
                   for t in self.qkv(x).split(h, dim=-1))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / (hd ** 0.5)
        if attn_bias is not None:
            scores = scores + attn_bias
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

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attention(self.layer_norm1(x), attn_bias)
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class PatchEmbed(nn.Module):
    """Stride-P patch embedding as space-to-depth plus one matmul, with a
    bias for ViT and Swin and none for CLIP (whose patch conv has none).
    The patch vector is flattened in (kh, kw, c) order, matching the flax
    conv kernel ``[P, P, C, H]`` reshaped to ``[P*P*C, H]``; ``weight``
    holds its transpose.

    Given integer (uint8) pixels it folds the ImageNet affine
    ``(x / 255 - mean) / std`` into the product, as the JAX ``PatchEmbed``
    does: each input channel's columns of the weight are scaled by
    ``1 / (255 * std_c)`` in f32 and then cast, and the constant
    ``sum_pc (-mean_c / std_c) * W[p, c, :]`` (f32, then cast) is added to
    every token before the bias, present for the bias-free CLIP embed too.
    Valid because the patch conv is stride == kernel with no padding."""

    def __init__(self, hidden_size: int, patch_size: int, channels: int = 3,
                 use_bias: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(
            torch.empty(hidden_size, patch_size * patch_size * channels))
        self.bias = (nn.Parameter(torch.zeros(hidden_size)) if use_bias
                     else None)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, Hi, Wi, C = images.shape
        P = self.patch_size
        gh, gw = Hi // P, Wi // P
        x = images[:, :gh * P, :gw * P]  # conv-VALID drops the remainder
        x = x.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5)
        dtype = self.weight.dtype
        x = x.reshape(B, gh, gw, P * P * C).to(dtype)
        if not images.dtype.is_floating_point:
            std = torch.tensor(IMAGENET_STD, device=x.device)
            mean = torch.tensor(IMAGENET_MEAN, device=x.device)
            # the column of (kh, kw, c) belongs to channel c
            scale = (1.0 / (255.0 * std)).repeat(P * P)
            shift = (-(mean / std)).repeat(P * P)
            w = self.weight.float()
            y = F.linear(x, (w * scale).to(dtype)) \
                + torch.matmul(w, shift).to(dtype)
            return y if self.bias is None else y + self.bias
        return F.linear(x, self.weight, self.bias)


class CLIPVisionBackbone(nn.Module):
    """Class embedding + patch embedding + learned positions, pre-layernorm,
    pre-LN encoder layers with quick-gelu MLPs, post-layernorm on CLS."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_ratio: int = 4,
                 patch_size: int = 32, image_size: int = 224,
                 remat: bool = False):
        super().__init__()
        h = hidden_size
        tokens = (image_size // patch_size) ** 2 + 1
        self.num_heads = num_heads
        self.remat = remat
        self.patch_embed = PatchEmbed(h, patch_size)
        self.class_embedding = nn.Parameter(torch.zeros(h))
        self.position_embeddings = nn.Parameter(torch.zeros(tokens, h))
        self.pre_layernorm = LayerNorm(h, eps=1e-5)
        self.layers = nn.ModuleList(
            CLIPLayer(h, num_heads, h * mlp_ratio) for _ in range(num_layers))
        self.post_layernorm = LayerNorm(h, eps=1e-5)
        # the layers' stacked weights, set at model load
        # (params.stack_layer_weights); read by the fold
        self.stack: Optional[Dict[str, torch.Tensor]] = None

    def forward(self, images: torch.Tensor):
        B = images.shape[0]
        x = self.patch_embed(images)
        h = x.shape[-1]
        x = x.reshape(B, -1, h)
        cls = self.class_embedding.to(x.dtype).expand(B, 1, h)
        x = torch.cat([cls, x], dim=1)
        x = x + self.position_embeddings.to(x.dtype)[None]
        x = self.pre_layernorm(x)
        # the encoder kernel has no backward (the LayerNorms' op has one
        # and runs in every mode): never in training or under
        # plain_routes. ``remat`` only matters to a backward, so a remat
        # model folds in eval mode too
        if encoder_fold_enabled() and kernels_on(self):
            if self.stack is None:
                raise RuntimeError("the encoder fold needs the stacked "
                                   "weights: build the model with load_model")
            x = encoder_stack(x, self.stack, num_heads=self.num_heads)
        else:
            x = run_layers(self.layers, x, self.remat)
        return x, self.post_layernorm(x[:, 0])


class ViTLayer(nn.Module):
    """Pre-LN encoder layer (HF ``ViTLayer``): LayerNorm eps 1e-12, exact
    (erf) GELU in the MLP."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.layernorm_before = LayerNorm(hidden_size, eps=1e-12)
        self.attention = TransformerSelfAttention(hidden_size, num_heads)
        self.layernorm_after = LayerNorm(hidden_size, eps=1e-12)
        self.intermediate = nn.Linear(hidden_size, mlp_dim)
        self.output = nn.Linear(mlp_dim, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layernorm_before(x))
        return x + self.output(F.gelu(self.intermediate(
            self.layernorm_after(x))))


class ViTBackbone(nn.Module):
    """Patch embedding with bias + CLS token + learned positions, pre-LN
    layers, a final LayerNorm over all tokens, and the tanh pooler on
    CLS."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_ratio: int = 4,
                 patch_size: int = 16, image_size: int = 224,
                 remat: bool = False):
        super().__init__()
        h = hidden_size
        tokens = (image_size // patch_size) ** 2 + 1
        self.remat = remat
        self.patch_embed = PatchEmbed(h, patch_size, use_bias=True)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h))
        self.position_embeddings = nn.Parameter(torch.zeros(1, tokens, h))
        self.layers = nn.ModuleList(
            ViTLayer(h, num_heads, h * mlp_ratio) for _ in range(num_layers))
        self.layernorm = LayerNorm(h, eps=1e-12)
        self.pooler = nn.Linear(h, h)

    def forward(self, images: torch.Tensor):
        B = images.shape[0]
        x = self.patch_embed(images)
        h = x.shape[-1]
        x = x.reshape(B, -1, h)
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, h), x], dim=1)
        x = x + self.position_embeddings.to(x.dtype)
        x = run_layers(self.layers, x, self.remat)
        x = self.layernorm(x)
        return x, torch.tanh(self.pooler(x[:, 0]))


class ProjectedEncoder(nn.Module):
    """features = the backbone's patch tokens (CLS dropped), pooled = its
    pooled CLS vector; both projected to ``feature_dim`` when it differs
    from the backbone's width."""

    def __init__(self, backbone: nn.Module, config,
                 fold_normalize: bool = False):
        super().__init__()
        self.backbone = backbone
        self.freeze = config.freeze
        self.fold_normalize = fold_normalize
        self.proj = (nn.Linear(config.hidden_size, config.feature_dim)
                     if config.hidden_size != config.feature_dim else None)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        # under fold_normalize uint8 pixels go to the patch embed's fold
        if images.dtype == torch.uint8 and not self.fold_normalize:
            images = normalize_images(images)
        # freeze: no gradient reaches the backbone (its parameters get
        # zero gradients from the trainer, as jax.lax.stop_gradient gives)
        with torch.no_grad() if self.freeze else contextlib.nullcontext():
            x, pooled = self.backbone(images)
        features = x[:, 1:]
        if self.proj is not None:
            features = self.proj(features)
            pooled = self.proj(pooled)
        B, S = features.shape[:2]
        return {"features": features, "pooled_features": pooled,
                "attention_mask": torch.ones((B, S), dtype=torch.bool,
                                             device=features.device)}


class CLIPEncoder(ProjectedEncoder):
    """features = patch tokens of the last hidden state (not
    post-layernormed), pooled = post-layernormed CLS."""

    def __init__(self, config, image_size: int,
                 fold_normalize: bool = False):
        super().__init__(CLIPVisionBackbone(
            hidden_size=config.hidden_size, num_layers=config.num_layers,
            num_heads=config.num_heads, mlp_ratio=config.mlp_ratio,
            patch_size=config.patch_size, image_size=image_size,
            remat=config.remat), config, fold_normalize)


class ViTEncoder(ProjectedEncoder):
    """features = patch tokens after the final LayerNorm, pooled = the tanh
    pooler's CLS vector."""

    def __init__(self, config, image_size: int,
                 fold_normalize: bool = False):
        super().__init__(ViTBackbone(
            hidden_size=config.hidden_size, num_layers=config.num_layers,
            num_heads=config.num_heads, mlp_ratio=config.mlp_ratio,
            patch_size=config.patch_size, image_size=image_size,
            remat=config.remat), config, fold_normalize)


class BatchNorm(nn.Module):
    """BatchNorm with flax's arithmetic (``nn.BatchNorm(momentum=0.9)``),
    channels on axis 1. In eval mode (``use_running_average``) it
    normalises with the running statistics; in training mode with the
    batch's mean and biased variance (``mean(x^2) - mean(x)^2`` clipped at
    0, in f32 over every axis but the channels'), and then updates the
    running statistics to ``0.9 * running + 0.1 * batch``, the biased
    variance included (``F.batch_norm`` would store the unbiased one).
    Inside :func:`.layers.data_parallel` the batch statistics are the
    global batch's: the per-channel sums of x and x^2 all-reduced over the
    data axis (differentiably), so every rank normalises and updates its
    running statistics as one process on the whole batch would.
    Either way ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32,
    cast to the input dtype. The scale and bias stay f32 under
    :func:`..utils.amp.cast_float_params`, as flax keeps them; the
    statistics are buffers, never cast."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def per_channel(t):
            return t.float()[None, :, None, None]

        xf = x.float()
        if self.training:
            axes = (0, 2, 3)
            group = data_group()
            if group is None:
                mean = xf.mean(axes)
                var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
            else:
                # the global batch's moments: every rank's sums, reduced
                # in the forward and, for their gradients, the backward
                sums = all_reduce_sum(torch.stack(
                    [xf.sum(axes), (xf * xf).sum(axes)]), group)
                n = xf.numel() // xf.shape[1] \
                    * torch.distributed.get_world_size(group)
                mean, mean2 = sums[0] / n, sums[1] / n
                var = (mean2 - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(per_channel(var) + self.eps) \
            * per_channel(self.weight)
        y = (xf - per_channel(mean)) * mul + per_channel(self.bias)
        return y.to(x.dtype)


class ResNetConvLayer(nn.Module):
    """Convolution (no bias, padding k // 2 on each side) -> BatchNorm ->
    optional ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 activation: bool = True):
        super().__init__()
        self.convolution = nn.Conv2d(in_channels, out_channels, kernel_size,
                                     stride=stride,
                                     padding=kernel_size // 2, bias=False)
        self.normalization = BatchNorm(out_channels)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.normalization(self.convolution(x))
        return F.relu(x) if self.activation else x


class ResNetShortCut(nn.Module):
    """1x1 strided projection of the residual, then BatchNorm."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2):
        super().__init__()
        self.convolution = nn.Conv2d(in_channels, out_channels, 1,
                                     stride=stride, bias=False)
        self.normalization = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalization(self.convolution(x))


class ResNetBottleNeckLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 reduction: int = 4):
        super().__init__()
        reduces = out_channels // reduction
        self.layer_0 = ResNetConvLayer(in_channels, reduces, kernel_size=1)
        self.layer_1 = ResNetConvLayer(reduces, reduces, stride=stride)
        self.layer_2 = ResNetConvLayer(reduces, out_channels, kernel_size=1,
                                       activation=False)
        self.shortcut = (ResNetShortCut(in_channels, out_channels, stride)
                         if in_channels != out_channels or stride != 1
                         else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.shortcut is None else self.shortcut(x)
        return F.relu(self.layer_2(self.layer_1(self.layer_0(x))) + residual)


class ResNetBasicLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.layer_0 = ResNetConvLayer(in_channels, out_channels,
                                       stride=stride)
        self.layer_1 = ResNetConvLayer(out_channels, out_channels,
                                       activation=False)
        self.shortcut = (ResNetShortCut(in_channels, out_channels, stride)
                         if in_channels != out_channels or stride != 1
                         else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.shortcut is None else self.shortcut(x)
        return F.relu(self.layer_1(self.layer_0(x)) + residual)


class ResNetBackbone(nn.Module):
    """Embedder (7x7/2 conv + BN + ReLU, then a 3x3/2 max-pool over
    -inf padding) and one stage per entry of ``hidden_sizes``: the first
    at stride 1, the rest at stride 2 in their first layer. Takes and
    returns NCHW-shaped tensors, in the ``channels_last`` memory format
    where the caller gives it."""

    def __init__(self, embedding_size: int = 64,
                 hidden_sizes=(256, 512, 1024, 2048), depths=(3, 4, 6, 3),
                 layer_type: str = "bottleneck"):
        super().__init__()
        self.embedder = ResNetConvLayer(3, embedding_size, kernel_size=7,
                                        stride=2)
        layer_cls = (ResNetBottleNeckLayer if layer_type == "bottleneck"
                     else ResNetBasicLayer)
        self.stages = nn.ModuleList()
        in_ch = embedding_size
        for stage, (size, depth) in enumerate(zip(hidden_sizes, depths)):
            self.stages.append(nn.ModuleList(
                layer_cls(in_ch if i == 0 else size, size,
                          stride=(1 if stage == 0 else 2) if i == 0 else 1)
                for i in range(depth)))
            in_ch = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(self.embedder(x), 3, stride=2, padding=1)
        for stage in self.stages:
            for layer in stage:
                x = layer(x)
        return x


class ResNetEncoder(nn.Module):
    """features = the last stage's spatial map as a token sequence,
    pooled = its global average; both projected to ``feature_dim`` when it
    differs from the last stage's width."""

    def __init__(self, config):
        super().__init__()
        self.backbone = ResNetBackbone(
            embedding_size=config.resnet_embedding_size,
            hidden_sizes=tuple(config.resnet_hidden_sizes),
            depths=tuple(config.resnet_depths),
            layer_type=config.resnet_layer_type)
        self.freeze = config.freeze
        width = config.resnet_hidden_sizes[-1]
        self.proj = (nn.Linear(width, config.feature_dim)
                     if width != config.feature_dim else None)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        if images.dtype == torch.uint8:
            images = normalize_images(images)
        dtype = self.backbone.embedder.convolution.weight.dtype
        # NHWC memory read as NCHW: the channels_last layout, no copy
        with torch.no_grad() if self.freeze else contextlib.nullcontext():
            x = self.backbone(images.to(dtype).permute(0, 3, 1, 2))
        B, C = x.shape[:2]
        features = x.permute(0, 2, 3, 1).reshape(B, -1, C)
        pooled = features.mean(dim=1)
        if self.proj is not None:
            features = self.proj(features)
            pooled = self.proj(pooled)
        return {"features": features, "pooled_features": pooled,
                "attention_mask": torch.ones(features.shape[:2],
                                             dtype=torch.bool,
                                             device=features.device)}

    def train(self, mode: bool = True):
        """Under ``freeze`` the backbone stays in eval mode: its BatchNorm
        keeps to the running statistics (``train and not freeze``)."""
        super().train(mode)
        if self.freeze:
            self.backbone.train(False)
        return self


class ObjectRegionEncoder(nn.Module):
    """Pre-extracted detector regions: ``region_features`` [B, N, in]
    projected to ``feature_dim`` (where the widths differ), a geometry MLP
    over ``region_boxes`` [B, N, 4] (64 wide, ReLU) joined to them by
    ``combine``, and the mean over the valid regions of ``region_mask``
    [B, N] (True = valid), divided by ``count + 1e-10``. The features are
    cast to the weights' dtype first, as flax's ``Dense`` casts its
    input."""

    def __init__(self, config):
        super().__init__()
        D = config.feature_dim
        self.proj = (nn.Linear(config.region_feature_dim, D)
                     if config.region_feature_dim != D else None)
        self.geo_proj_0 = nn.Linear(4, 64)
        self.geo_proj_1 = nn.Linear(64, D)
        self.combine = nn.Linear(2 * D, D)

    def forward(self, inputs: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        dtype = self.combine.weight.dtype
        features = inputs["region_features"].to(dtype)
        boxes = inputs.get("region_boxes")
        mask = inputs["region_mask"].bool()
        if self.proj is not None:
            features = self.proj(features)
        if boxes is not None:
            geo = self.geo_proj_1(F.relu(self.geo_proj_0(boxes.to(dtype))))
            features = self.combine(torch.cat([features, geo], dim=-1))
        m = mask.to(features.dtype)[..., None]
        pooled = (features * m).sum(1) / (m.sum(1) + 1e-10)
        return {"features": features, "pooled_features": pooled,
                "attention_mask": mask}


def build_encoder(config, image_size: int,
                  fold_normalize: bool = False) -> nn.Module:
    """The encoder of ``config`` (an ``EncoderConfig``) for square images
    of ``image_size``, checked in the JAX package's order: object-region
    features first, whatever the encoder type. ``fold_normalize`` (the
    top-level config's) reaches the ViT and CLIP encoders only."""
    from .swin import SwinEncoder  # swin.py imports this module

    if reads_regions(config):
        return ObjectRegionEncoder(config)
    if config.encoder_type == EncoderType.CLIP:
        return CLIPEncoder(config, image_size, fold_normalize)
    if config.encoder_type == EncoderType.VIT:
        return ViTEncoder(config, image_size, fold_normalize)
    if config.encoder_type == EncoderType.RESNET:
        return ResNetEncoder(config)
    if config.encoder_type == EncoderType.SWIN:
        return SwinEncoder(config, image_size)
    raise ValueError(f"Unsupported encoder type: {config.encoder_type}")
