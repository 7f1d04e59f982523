"""GPT-2 caption decoder with per-layer prefix-KV image conditioning, in
PyTorch.

Counterpart of ``image_captioning_ml_project_tpu.models.gpt2`` on its
split-cache path: the pooled image feature becomes ``prefix_length``
soft-prompt tokens, run through the transformer once per image by
``init_cache`` so every layer holds that image's prefix K/V; generation
then steps over flat ``[Bk, S, H]`` suffix caches that beam search never
permutes (lazy ancestry). Each layer's decode-step attention goes through
:func:`..ops.beam_decode_attention.beam_decode_attention` with the QKV and
output projections as linear layers around it; on a CUDA tensor that is
the hand-written kernel, on a CPU tensor its plain version.

The suffix cache holds exactly ``max_length`` positions; the JAX
package's 8-row alignment exists only for TPU DMA tiling.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.beam_decode_attention import beam_decode_attention
from .layers import LayerNorm

_NEG_INF = -1e9


class GPT2Attention(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.c_attn = nn.Linear(hidden_dim, 3 * hidden_dim)
        self.c_proj = nn.Linear(hidden_dim, hidden_dim)

    def full(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None):
        """Causal self-attention over x [B, T, H] (+ additive bias).
        Returns (out [B, T, H], (k, v) each [B, T, nh, hd])."""
        B, T, H = x.shape
        nh = self.num_heads
        hd = H // nh
        q, k, v = (t.reshape(B, T, nh, hd)
                   for t in self.c_attn(x).split(H, dim=-1))
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) \
            / (hd ** 0.5)
        causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, _NEG_INF)
        if attn_bias is not None:
            scores = scores + attn_bias
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bnqk,bknd->bqnd", w, v).reshape(B, T, H)
        return self.c_proj(out), (k, v)

    def cached_step(self, x: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos: int,
                    prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                    anc_local: Optional[torch.Tensor]) -> torch.Tensor:
        """x [Bk, H] -> attention output [Bk, H]; appends this step's K/V at
        suffix position ``pos`` of the caches in place."""
        H = self.hidden_dim
        q, k_new, v_new = (t.contiguous()
                           for t in self.c_attn(x).split(H, dim=-1))
        out, _, _ = beam_decode_attention(
            q, k_new, v_new, k_cache, v_cache, prefix_k, prefix_v,
            anc_local, pos, num_heads=self.num_heads,
            beam_size=x.shape[0] // prefix_k.shape[0],
            scale=1.0 / (H // self.num_heads) ** 0.5)
        return self.c_proj(out)


class GPT2MLP(nn.Module):
    def __init__(self, hidden_dim: int):
        super().__init__()
        self.c_fc = nn.Linear(hidden_dim, 4 * hidden_dim)
        self.c_proj = nn.Linear(4 * hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class GPT2Block(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(hidden_dim, eps=1e-5)
        self.attn = GPT2Attention(hidden_dim, num_heads)
        self.ln_2 = LayerNorm(hidden_dim, eps=1e-5)
        self.mlp = GPT2MLP(hidden_dim)

    def full(self, x, attn_bias=None):
        y, kv = self.attn.full(self.ln_1(x), attn_bias=attn_bias)
        x = x + y
        return x + self.mlp(self.ln_2(x)), kv

    def cached_step(self, x, k_cache, v_cache, pos, prefix_k, prefix_v,
                    anc_local):
        x = x + self.attn.cached_step(self.ln_1(x), k_cache, v_cache, pos,
                                      prefix_k, prefix_v, anc_local)
        return x + self.mlp(self.ln_2(x))


class GPT2Backbone(nn.Module):
    """HF GPT2LMHeadModel-compatible transformer with tied LM head."""

    def __init__(self, vocab_size: int, hidden_dim: int, num_layers: int,
                 num_heads: int, n_positions: int = 1024):
        super().__init__()
        self.wte = nn.Embedding(vocab_size, hidden_dim)
        self.wpe = nn.Embedding(n_positions, hidden_dim)
        self.blocks = nn.ModuleList(GPT2Block(hidden_dim, num_heads)
                                    for _ in range(num_layers))
        self.ln_f = LayerNorm(hidden_dim, eps=1e-5)

    def full(self, inputs_embeds: torch.Tensor, attn_bias=None):
        """inputs_embeds [B, T, H] (positions added) -> (hidden [B, T, H],
        per-layer (k, v))."""
        x = inputs_embeds
        kvs = []
        for block in self.blocks:
            x, kv = block.full(x, attn_bias=attn_bias)
            kvs.append(kv)
        return self.ln_f(x), kvs

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return F.linear(hidden, self.wte.weight)


class GPT2Decoder(nn.Module):
    def __init__(self, config, vocab_size: int, pad_token_id: int,
                 feature_dim: Optional[int] = None):
        super().__init__()
        h = config.hidden_dim
        self.config = config
        self.pad_token_id = pad_token_id
        self.prefix_length = config.prefix_length
        self.backbone = GPT2Backbone(vocab_size, h, config.num_layers,
                                     config.num_heads,
                                     config.gpt2_n_positions)
        self.image_to_prefix = nn.Linear(feature_dim or h,
                                         self.prefix_length * h)
        self.image_prefix = nn.Parameter(torch.zeros(1, self.prefix_length,
                                                     h))

    def _prefix_embeds(self, pooled: torch.Tensor) -> torch.Tensor:
        """Pooled image features -> [B, P, H] prefix token embeddings, with
        position embeddings for slots 0..P-1."""
        B = pooled.shape[0]
        P = self.prefix_length
        prefix = self.image_to_prefix(pooled).reshape(B, P, -1)
        prefix = prefix + self.image_prefix.to(prefix.dtype)
        return prefix + self.backbone.wpe.weight[:P][None]

    def forward(self, encoder_features: Dict[str, torch.Tensor],
                captions: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward over [prefix; captions]; logits for the
        caption positions [B, T, V]."""
        pooled = encoder_features["pooled_features"]
        B, T = captions.shape
        P = self.prefix_length
        prefix = self._prefix_embeds(pooled)
        tok = self.backbone.wte(captions) \
            + self.backbone.wpe.weight[P:P + T][None]
        x = torch.cat([prefix.to(tok.dtype), tok], dim=1)
        # key padding: prefix always visible, caption pads masked
        key_pad = torch.cat([torch.zeros((B, P), dtype=torch.bool,
                                         device=captions.device),
                             captions == self.pad_token_id], dim=1)
        attn_bias = torch.zeros(key_pad.shape, device=captions.device)
        attn_bias = attn_bias.masked_fill(key_pad, _NEG_INF)[:, None, None]
        hidden, _ = self.backbone.full(x, attn_bias=attn_bias)
        return {"logits": self.backbone.logits(hidden[:, P:]),
                "hidden_states": hidden[:, P:]}

    # -- uniform decode interface -------------------------------------------

    def init_cache(self, encoder_features: Dict[str, torch.Tensor],
                   max_length: int) -> Dict[str, Any]:
        """Split KV cache: each layer's prefix K/V (positions 0..P-1, one per
        image) under ``shared``, which beam search neither tiles nor
        gathers; zeroed ``[B, max_length, H]`` suffix caches under
        ``lazy``, which beam search tiles once and then reads through an
        ancestry map. ``pos`` counts within the suffix."""
        pooled = encoder_features["pooled_features"]
        B = pooled.shape[0]
        P = self.prefix_length
        H = self.config.hidden_dim
        _, kvs = self.backbone.full(self._prefix_embeds(pooled))
        layers = [{"k": k.new_zeros((B, max_length, H)),
                   "v": v.new_zeros((B, max_length, H))} for k, v in kvs]
        shared = {"layers": [{"pk": k.reshape(B, P, H).contiguous(),
                              "pv": v.reshape(B, P, H).contiguous()}
                             for k, v in kvs]}
        return {"lazy": {"layers": layers}, "shared": shared, "pos": 0}

    def step(self, state: Dict[str, Any], tokens: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens [Bk] -> (logits [Bk, V], state at pos + 1). The suffix
        caches are appended in place."""
        pos = state["pos"]
        P = self.prefix_length
        layers = state["lazy"]["layers"]
        shared = state["shared"]["layers"]
        Bk = tokens.shape[0]
        K = Bk // shared[0]["pk"].shape[0]
        S = layers[0]["k"].shape[1]
        ancestry = state["lazy"].get("ancestry")  # set by beam search only
        anc_local = None
        if ancestry is not None:
            own = torch.arange(Bk, device=ancestry.device,
                               dtype=ancestry.dtype)[:, None] // K * K
            anc_local = ancestry - own                 # [Bk, L] in 0..K-1
            if anc_local.shape[1] < S:
                anc_local = F.pad(anc_local, (0, S - anc_local.shape[1]))
            anc_local = anc_local.to(torch.int32).contiguous()
        x = self.backbone.wte(tokens) + self.backbone.wpe.weight[P + pos]
        for block, cache, pre in zip(self.backbone.blocks, layers, shared):
            x = block.cached_step(x, cache["k"], cache["v"], pos, pre["pk"],
                                  pre["pv"], anc_local)
        logits = self.backbone.logits(self.backbone.ln_f(x))
        return logits, dict(state, pos=pos + 1)
