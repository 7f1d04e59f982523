"""Cross-attention zoo in PyTorch: soft (additive), multi-head, adaptive
(visual sentinel) and attention-on-attention.

Counterpart of ``image_captioning_ml_project_tpu.models.attention``: the
same projections (``nn.Linear`` in place of flax ``Dense``, bridged by
:func:`..params.from_flax`), the same masking (``key_padding_mask`` True
marks a padding key, whose score becomes -1e9), the same 2-D query squeeze
convention and head-averaged weights, and the JAX package's switch
``AttentionConfig.use_pallas``: False runs the XLA path's arithmetic as
plain PyTorch ops on every device; True runs the attention core through a
kernel wrapper (:func:`..ops.additive_scores.additive_scores` for the soft
variant, :func:`..ops.sdpa.sdpa` for the multi-head one), which takes its
plain version on a CPU tensor and launches the hand-written kernel on a
CUDA tensor. The kernels have no backward: in training mode, and inside
:func:`.layers.plain_routes`, the plain PyTorch ops run whatever the
switch says.

The keys and values may be per image while the queries are per beam row:
where ``query`` has ``beam_size`` rows for each key row (row r belonging
to image r // beam_size), the memory side is never tiled and the kernels
take ``beam_size``. The memory-side projections depend on the image only,
so :meth:`project_memory` computes them once per decode and
:meth:`attend` reads them at every step; ``forward(query, key, value,
...)`` is the JAX modules' signature and does both.

One repair over the JAX soft path: its kernel path's f32 softmax weights
promote the context to float32, which at bf16 changes the LSTM carry's
dtype inside the decode loop (the JAX ``nn.scan`` then refuses to run).
Here the soft context is cast to the value's dtype after its f32 mix, as
the JAX multi-head variant casts its weights; in float32 the cast is the
identity.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..config import AttentionType
from ..ops.additive_scores import additive_scores
from ..ops.sdpa import sdpa
from .layers import kernels_on

_NEG_INF = -1e9

Memory = Dict[str, torch.Tensor]


def _maybe_expand_query(query: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """2-D query squeeze convention: [B, D] runs as [B, 1, D]."""
    if query.dim() == 2:
        return query[:, None, :], True
    return query, False


def _beam_size(query: torch.Tensor, images: int) -> int:
    """How many query rows belong to each memory row."""
    K = query.shape[0] // images
    if images < 1 or K * images != query.shape[0]:
        raise ValueError(f"{query.shape[0]} query rows do not split over "
                         f"{images} images")
    return K


class SoftAttention(nn.Module):
    """Additive (Bahdanau) attention: ``score(q, k) = energy(tanh(W_q q +
    W_k k)) / temperature``; the context is the weights' mix of the
    values."""

    def __init__(self, config, query_dim: int, memory_dim: int):
        super().__init__()
        h = config.hidden_dim
        self.config = config
        self.query_proj = nn.Linear(query_dim, h)
        self.key_proj = nn.Linear(memory_dim, h)
        self.energy = nn.Linear(h, 1)
        self.context_dim = memory_dim

    def project_memory(self, key: torch.Tensor, value: torch.Tensor) -> Memory:
        return {"k_proj": self.key_proj(key), "value": value}

    def attend(self, query, memory: Memory, key_padding_mask=None, **kwargs):
        query, squeeze = _maybe_expand_query(query)
        k_proj, value = memory["k_proj"], memory["value"]
        B, S, _ = k_proj.shape
        Bq, Q, _ = query.shape
        K = _beam_size(query, B)
        q_proj = self.query_proj(query)
        T = self.config.temperature
        if self.config.use_pallas and kernels_on(self):
            scores = additive_scores(
                q_proj, k_proj, self.energy.weight, self.energy.bias,
                key_padding_mask, temperature=T, beam_size=K)
        else:
            # [B, K*Q, 1, h] + [B, 1, S, h] -> [B, K*Q, S, h]
            attn_sum = torch.tanh(q_proj.reshape(B, K * Q, 1, -1)
                                  + k_proj[:, None, :, :])
            scores = self.energy(attn_sum)[..., 0] / T
            if key_padding_mask is not None:
                scores = scores.masked_fill(key_padding_mask[:, None, :],
                                            _NEG_INF)
        weights = torch.softmax(scores, dim=-1).reshape(B, K * Q, S)
        # the mix in the weights' dtype (f32 on the kernel path), cast back
        # to the value's dtype
        context = torch.matmul(weights, value.to(weights.dtype)).to(
            value.dtype).reshape(Bq, Q, -1)
        weights = weights.reshape(Bq, Q, S)
        if squeeze:
            return context[:, 0], weights[:, 0]
        return context, weights

    def forward(self, query, key, value, key_padding_mask=None, **kwargs):
        return self.attend(query, self.project_memory(key, value),
                           key_padding_mask)


class MultiHeadAttention(nn.Module):
    """Scaled dot-product multi-head cross-attention, with head-averaged
    weights."""

    def __init__(self, config, query_dim: int, memory_dim: int):
        super().__init__()
        h, nh = config.hidden_dim, config.num_heads
        if h % nh:
            raise ValueError(f"hidden_dim {h} must be divisible by num_heads "
                             f"{nh}")
        self.config = config
        self.num_heads = nh
        self.query_proj = nn.Linear(query_dim, h)
        self.key_proj = nn.Linear(memory_dim, h)
        self.value_proj = nn.Linear(memory_dim, h)
        self.output_proj = nn.Linear(h, h)
        self.context_dim = h

    def project_memory(self, key: torch.Tensor, value: torch.Tensor) -> Memory:
        return {"k": self.key_proj(key), "v": self.value_proj(value)}

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """[N, T, h] -> the [N, NH, T, hd] view (no copy)."""
        N, T, h = x.shape
        return x.view(N, T, self.num_heads, h // self.num_heads).transpose(
            1, 2)

    def attend(self, query, memory: Memory, key_padding_mask=None, **kwargs):
        query, squeeze = _maybe_expand_query(query)
        Bq, Q, _ = query.shape
        h = self.config.hidden_dim
        q = self._heads(self.query_proj(query))
        k, v = self._heads(memory["k"]), self._heads(memory["v"])
        B, NH, S, hd = k.shape
        K = _beam_size(query, B)
        scale = 1.0 / (self.config.temperature * (hd ** 0.5))
        if self.config.use_pallas and kernels_on(self):
            context4, weights4 = sdpa(q, k, v, key_padding_mask, scale=scale,
                                      beam_size=K)
        else:
            qh = q.reshape(B, K, NH, Q, hd)
            scores = torch.einsum("bknqd,bnsd->bknqs", qh.float(),
                                  k.float()) * scale
            if key_padding_mask is not None:
                scores = scores.masked_fill(
                    key_padding_mask[:, None, None, None, :], _NEG_INF)
            weights5 = torch.softmax(scores, dim=-1)
            context4 = torch.einsum("bknqs,bnsd->bknqd",
                                    weights5.to(v.dtype), v).reshape(
                                        Bq, NH, Q, hd)
            weights4 = weights5.reshape(Bq, NH, Q, S)
        context = context4.transpose(1, 2).reshape(Bq, Q, h)
        context = self.output_proj(context)
        weights = weights4.mean(dim=1).to(context.dtype)  # head average
        if squeeze:
            return context[:, 0], weights[:, 0]
        return context, weights

    def forward(self, query, key, value, key_padding_mask=None, **kwargs):
        return self.attend(query, self.project_memory(key, value),
                           key_padding_mask)


def _base_attention(config, query_dim: int, memory_dim: int) -> nn.Module:
    cls = MultiHeadAttention if config.num_heads > 1 else SoftAttention
    return cls(config, query_dim, memory_dim)


class AdaptiveAttention(nn.Module):
    """Adaptive attention with a visual sentinel (Lu et al., 2017): the
    base attention's context blended with a sentinel formed from the
    LSTM's ``memory_state``/``cell_state`` [B, H]."""

    def __init__(self, config, query_dim: int, memory_dim: int):
        super().__init__()
        h = config.hidden_dim
        self.base_attention = _base_attention(config, query_dim, memory_dim)
        ctx = self.base_attention.context_dim
        self.sentinel_gate = nn.Linear(2 * query_dim, h)
        self.sentinel_proj = nn.Linear(h, h)
        self.adaptive_weight = nn.Linear(ctx + h, 1)
        self.context_dim = ctx

    def project_memory(self, key: torch.Tensor, value: torch.Tensor) -> Memory:
        return self.base_attention.project_memory(key, value)

    def attend(self, query, memory: Memory, key_padding_mask=None,
               memory_state=None, cell_state=None, **kwargs):
        if memory_state is None or cell_state is None:
            raise ValueError("AdaptiveAttention requires memory_state and "
                             "cell_state")
        query, squeeze = _maybe_expand_query(query)
        mem = memory_state[:, None, :].expand(query.shape)
        gate = torch.sigmoid(self.sentinel_gate(torch.cat([query, mem], -1)))
        cell = cell_state[:, None, :].expand(query.shape)
        sentinel = self.sentinel_proj(gate * torch.tanh(cell))
        context, weights = self.base_attention.attend(query, memory,
                                                      key_padding_mask)
        w = torch.sigmoid(self.adaptive_weight(
            torch.cat([context, sentinel], -1)))
        final = w * context + (1.0 - w) * sentinel
        if squeeze:
            return final[:, 0], weights[:, 0]
        return final, weights

    def forward(self, query, key, value, key_padding_mask=None,
                memory_state=None, cell_state=None, **kwargs):
        return self.attend(query, self.project_memory(key, value),
                           key_padding_mask, memory_state=memory_state,
                           cell_state=cell_state)


class AttentionOnAttention(nn.Module):
    """Attention on Attention (Huang et al., 2019): an information vector
    and a gate computed from [context; transformed query], multiplied
    elementwise."""

    def __init__(self, config, query_dim: int, memory_dim: int):
        super().__init__()
        h = config.hidden_dim
        self.base_attention = _base_attention(config, query_dim, memory_dim)
        ctx = self.base_attention.context_dim
        self.query_proj = nn.Linear(query_dim, h)
        self.info_vector_proj = nn.Linear(ctx + h, h)
        self.info_gate_proj = nn.Linear(ctx + h, h)
        self.context_dim = h

    def project_memory(self, key: torch.Tensor, value: torch.Tensor) -> Memory:
        return self.base_attention.project_memory(key, value)

    def attend(self, query, memory: Memory, key_padding_mask=None, **kwargs):
        query, squeeze = _maybe_expand_query(query)
        context, weights = self.base_attention.attend(query, memory,
                                                      key_padding_mask)
        concat = torch.cat([context, self.query_proj(query)], -1)
        info = torch.tanh(self.info_vector_proj(concat))
        gate = torch.sigmoid(self.info_gate_proj(concat))
        filtered = info * gate
        if squeeze:
            return filtered[:, 0], weights[:, 0]
        return filtered, weights

    def forward(self, query, key, value, key_padding_mask=None, **kwargs):
        return self.attend(query, self.project_memory(key, value),
                           key_padding_mask)


def build_attention(config, query_dim: int, memory_dim: int) -> nn.Module:
    """The variant of ``config`` (an ``AttentionConfig``) for queries of
    width ``query_dim`` over keys and values of width ``memory_dim``."""
    classes = {AttentionType.SOFT: SoftAttention,
               AttentionType.MULTI_HEAD: MultiHeadAttention,
               AttentionType.ADAPTIVE: AdaptiveAttention,
               AttentionType.AOA: AttentionOnAttention}
    if config.attention_type not in classes:
        raise ValueError(f"Unsupported attention type: "
                         f"{config.attention_type}")
    return classes[config.attention_type](config, query_dim, memory_dim)
