"""GPT-2 caption decoder with per-layer prefix-KV image conditioning, in
PyTorch.

Counterpart of ``image_captioning_ml_project_tpu.models.gpt2`` on its
kernel paths: the pooled image feature becomes ``prefix_length``
soft-prompt tokens, run through the transformer once per image by
``init_cache`` so every layer holds that image's prefix K/V; generation
then steps over suffix caches that beam search never permutes (lazy
ancestry). The JAX package's switches choose the decode path, with the
same names, meanings and defaults, read once per decode at ``init_cache``
(:func:`decode_path`):

* ``stack`` (default): layer-stacked caches ``[L, B, S, H]``; one
  :func:`..ops.beam_decode_stack.beam_decode_stack` call runs all layers
  of a step, and ``ln_f`` and the tied LM head follow as torch ops;
* ``fold`` (``ICT_DECODE_STACK=0``): per-layer ``[B, S, H]`` caches; each
  layer's attention block is one
  :func:`..ops.beam_decode_attention.beam_decode_attention_qkv` call;
* ``split`` (``ICT_DECODE_STACK=0 ICT_DECODE_FOLD=0``): per-layer caches;
  :func:`..ops.beam_decode_attention.beam_decode_attention` with the QKV
  and output projections as linear layers around it.

On a CUDA tensor each is a hand-written kernel, on a CPU tensor its plain
version; the path does not depend on the device. The suffix cache holds
exactly ``max_length`` positions; the JAX package's 8-row alignment exists
only for TPU DMA tiling.

In training mode the teacher-forced forward applies HF's embedding,
attention and residual dropout (``DecoderConfig.dropout``) where the JAX
decoder does under ``deterministic=False``.

Under tensor parallelism (:func:`..parallel.sharding.tensor_parallel`)
the attention and MLP blocks hold this rank's shards and their
``tp_group`` is the mesh's model group: ``c_attn`` holds whole heads of
q, k and v (``num_heads / M`` of them) and ``c_fc`` a slice of the
hidden units, the two ``c_proj`` the matching input columns; the
teacher-forced forward then all-reduces each ``c_proj`` product before
its bias (:func:`..parallel.sharding.reduce_from`) and the backward each
block input's gradient (:func:`..parallel.sharding.copy_to`).

Decoding on shards (the service and the demo under a model axis,
:func:`..parallel.sharding.shard_decode_model`) takes the ``split`` path
whatever the switches say: the mesh's shape chooses it, as the JAX
``"auto"`` decode kernel chooses by mesh. ``init_cache`` builds caches of
the rank's width ``H / M``, each layer's attention runs
:func:`..ops.beam_decode_attention.beam_decode_attention` on the rank's
``num_heads / M`` heads and all-reduces its output projection before the
bias, and the MLP reduces as in training. ``stack`` and ``fold`` cannot
hold a shard: the whole-stack kernel runs all layers in one launch and the
folded kernel adds the output projection's bias inside. Validation, the
SCST rollouts and ``main.evaluate`` decode on gathered weights instead
(:meth:`..train.trainer.CaptioningTrainer.eval_state`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..inference.decoding import greedy_decode
from ..ops.beam_decode_attention import (beam_decode_attention,
                                         beam_decode_attention_qkv)
from ..ops.beam_decode_stack import beam_decode_stack
from ..parallel.sharding import copy_to, reduce_from
from .layers import LayerNorm, dropout

_NEG_INF = -1e9


def decode_fold_enabled() -> bool:
    """``ICT_DECODE_FOLD``: anything but ``"0"`` (the default) runs each
    layer's self-attention step through the folded-QKV kernel; read by
    this decoder and the Transformer decoder alike."""
    return os.environ.get("ICT_DECODE_FOLD", "1") != "0"


def decode_path() -> str:
    """The decode path the JAX package's switches select: ``"stack"``
    unless ``ICT_DECODE_STACK=0``, then ``"fold"`` unless
    ``ICT_DECODE_FOLD=0``, then ``"split"``."""
    if os.environ.get("ICT_DECODE_STACK", "1") != "0":
        return "stack"
    return "fold" if decode_fold_enabled() else "split"


def _row_split_out(linear: nn.Linear, x: torch.Tensor, group
                   ) -> torch.Tensor:
    """``linear(x)`` where ``linear``'s input columns are split over
    ``group``: the partial products all-reduced, then the bias."""
    if group is None:
        return linear(x)
    return reduce_from(F.linear(x, linear.weight), group) + linear.bias


class GPT2Attention(nn.Module):
    # the parameters tensor parallelism splits (parallel.sharding)
    tp_params = ("c_attn.weight", "c_attn.bias", "c_proj.weight")

    def __init__(self, hidden_dim: int, num_heads: int, rate: float = 0.0):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.rate = rate  # HF attn_pdrop and resid_pdrop (training only)
        self.c_attn = nn.Linear(hidden_dim, 3 * hidden_dim)
        self.c_proj = nn.Linear(hidden_dim, hidden_dim)
        self.tp_group = None  # the model axis's group when sharded

    def full(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None):
        """Causal self-attention over x [B, T, H] (+ additive bias).
        Returns (out [B, T, H], (k, v) each [B, T, nh, hd])."""
        B, T, _ = x.shape
        hd = self.hidden_dim // self.num_heads
        if self.tp_group is not None:
            x = copy_to(x, self.tp_group)
        qkv = self.c_attn(x)
        H = qkv.shape[-1] // 3  # this rank's heads' width
        nh = H // hd
        q, k, v = (t.reshape(B, T, nh, hd) for t in qkv.split(H, dim=-1))
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) \
            / (hd ** 0.5)
        causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, _NEG_INF)
        if attn_bias is not None:
            scores = scores + attn_bias
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        w = dropout(w, self.rate, self.training)
        out = torch.einsum("bnqk,bknd->bqnd", w, v).reshape(B, T, H)
        out = _row_split_out(self.c_proj, out, self.tp_group)
        return dropout(out, self.rate, self.training), (k, v)

    def cached_step(self, x: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos: int,
                    prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                    anc_local: Optional[torch.Tensor],
                    fold: bool) -> torch.Tensor:
        """x [Bk, H] -> attention output [Bk, H]; appends this step's K/V at
        suffix position ``pos`` of the caches in place. ``fold`` runs the
        projections inside the folded-QKV kernel (``nn.Dense`` rounding);
        otherwise they are the linear layers around the split kernel, the
        output projection's partial products all-reduced over the model
        group where this rank holds a shard of the heads."""
        hd = self.hidden_dim // self.num_heads
        H = self.c_attn.weight.shape[0] // 3  # this rank's heads' width
        args = dict(num_heads=H // hd,
                    beam_size=x.shape[0] // prefix_k.shape[0],
                    scale=1.0 / hd ** 0.5)
        if fold:
            if self.tp_group is not None:
                raise ValueError("the folded decode cannot run on a shard "
                                 "of the heads: decode on the split path")
            out, _, _ = beam_decode_attention_qkv(
                x, self.c_attn.weight, self.c_attn.bias, self.c_proj.weight,
                self.c_proj.bias, k_cache, v_cache, prefix_k, prefix_v,
                anc_local, pos, **args)
            return out
        q, k_new, v_new = (t.contiguous()
                           for t in self.c_attn(x).split(H, dim=-1))
        out, _, _ = beam_decode_attention(
            q, k_new, v_new, k_cache, v_cache, prefix_k, prefix_v,
            anc_local, pos, **args)
        return _row_split_out(self.c_proj, out, self.tp_group)


class GPT2MLP(nn.Module):
    tp_params = ("c_fc.weight", "c_fc.bias", "c_proj.weight")

    def __init__(self, hidden_dim: int, rate: float = 0.0):
        super().__init__()
        self.rate = rate  # HF resid_pdrop (training only)
        self.c_fc = nn.Linear(hidden_dim, 4 * hidden_dim)
        self.c_proj = nn.Linear(4 * hidden_dim, hidden_dim)
        self.tp_group = None  # the model axis's group when sharded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            x = copy_to(x, self.tp_group)
        h = F.gelu(self.c_fc(x), approximate="tanh")
        return dropout(_row_split_out(self.c_proj, h, self.tp_group),
                       self.rate, self.training)


class GPT2Block(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, rate: float = 0.0):
        super().__init__()
        self.ln_1 = LayerNorm(hidden_dim, eps=1e-5)
        self.attn = GPT2Attention(hidden_dim, num_heads, rate)
        self.ln_2 = LayerNorm(hidden_dim, eps=1e-5)
        self.mlp = GPT2MLP(hidden_dim, rate)

    def full(self, x, attn_bias=None):
        y, kv = self.attn.full(self.ln_1(x), attn_bias=attn_bias)
        x = x + y
        return x + self.mlp(self.ln_2(x)), kv

    def cached_step(self, x, k_cache, v_cache, pos, prefix_k, prefix_v,
                    anc_local, fold):
        x = x + self.attn.cached_step(self.ln_1(x), k_cache, v_cache, pos,
                                      prefix_k, prefix_v, anc_local, fold)
        return x + self.mlp(self.ln_2(x))


class GPT2Backbone(nn.Module):
    """HF GPT2LMHeadModel-compatible transformer with tied LM head."""

    def __init__(self, vocab_size: int, hidden_dim: int, num_layers: int,
                 num_heads: int, n_positions: int = 1024, rate: float = 0.0):
        super().__init__()
        self.rate = rate  # HF embd_pdrop (training only)
        self.wte = nn.Embedding(vocab_size, hidden_dim)
        self.wpe = nn.Embedding(n_positions, hidden_dim)
        self.blocks = nn.ModuleList(GPT2Block(hidden_dim, num_heads, rate)
                                    for _ in range(num_layers))
        self.ln_f = LayerNorm(hidden_dim, eps=1e-5)

    def full(self, inputs_embeds: torch.Tensor, attn_bias=None):
        """inputs_embeds [B, T, H] (positions added) -> (hidden [B, T, H],
        per-layer (k, v))."""
        x = dropout(inputs_embeds, self.rate, self.training)
        kvs = []
        for block in self.blocks:
            x, kv = block.full(x, attn_bias=attn_bias)
            kvs.append(kv)
        return self.ln_f(x), kvs

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return F.linear(hidden, self.wte.weight)


class GPT2Decoder(nn.Module):
    def __init__(self, config, vocab_size: int, pad_token_id: int,
                 bos_token_id: int, eos_token_id: int,
                 feature_dim: Optional[int] = None):
        super().__init__()
        h = config.hidden_dim
        self.config = config
        self.pad_token_id = pad_token_id
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.prefix_length = config.prefix_length
        self.backbone = GPT2Backbone(vocab_size, h, config.num_layers,
                                     config.num_heads,
                                     config.gpt2_n_positions, config.dropout)
        self.image_to_prefix = nn.Linear(feature_dim or h,
                                         self.prefix_length * h)
        self.image_prefix = nn.Parameter(torch.zeros(1, self.prefix_length,
                                                     h))
        # the blocks' layer-stacked weights, set at model load
        # (params.stack_layer_weights); read by the stack path
        self.stack: Optional[Dict[str, torch.Tensor]] = None

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
        """Prefix forward and zeroed suffix caches, in the layout of the
        decode path (:func:`decode_path`, read here once per decode). Each
        layer's prefix K/V (positions 0..P-1, one per image) sits under
        ``shared``, which beam search neither tiles nor gathers; the zeroed
        suffix caches sit under ``lazy``, which beam search tiles once and
        then reads through an ancestry map. The stack path keeps them
        layer-stacked: ``lazy["stacked"]`` k/v ``[L, B, max_length, H]``,
        ``shared`` pk/pv ``[L, B, P, H]`` and the stacked weights. The other
        paths keep per-layer ``lazy["layers"]`` ``[B, max_length, H]`` and
        ``shared["layers"]`` ``[B, P, H]``, with ``shared["fold"]`` naming
        the fold path. ``pos`` counts within the suffix. On shards of the
        heads (a model axis) the path is ``split`` and the caches are the
        rank's width."""
        pooled = encoder_features["pooled_features"]
        B = pooled.shape[0]
        P = self.prefix_length
        sharded = any(b.attn.tp_group is not None
                      for b in self.backbone.blocks)
        path = "split" if sharded else decode_path()
        _, kvs = self.backbone.full(self._prefix_embeds(pooled))
        H = kvs[0][0].shape[-2] * kvs[0][0].shape[-1]  # this rank's width
        if path == "stack":
            if self.stack is None:
                raise RuntimeError("the stack decode path needs the stacked "
                                   "weights: build the model with load_model")
            L = len(kvs)
            k0 = kvs[0][0]
            lazy = {"stacked": {"k": k0.new_zeros((L, B, max_length, H)),
                                "v": k0.new_zeros((L, B, max_length, H))}}
            shared = {"pk": torch.stack([k.reshape(B, P, H) for k, _ in kvs]),
                      "pv": torch.stack([v.reshape(B, P, H) for _, v in kvs]),
                      "stack": self.stack}
            return {"lazy": lazy, "shared": shared, "pos": 0}
        layers = [{"k": k.new_zeros((B, max_length, H)),
                   "v": v.new_zeros((B, max_length, H))} for k, v in kvs]
        shared = {"layers": [{"pk": k.reshape(B, P, H).contiguous(),
                              "pv": v.reshape(B, P, H).contiguous()}
                             for k, v in kvs],
                  "fold": path == "fold"}
        return {"lazy": {"layers": layers}, "shared": shared, "pos": 0}

    def step(self, state: Dict[str, Any], tokens: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens [Bk] -> (logits [Bk, V], state at pos + 1). The suffix
        caches are appended in place."""
        pos = state["pos"]
        P = self.prefix_length
        shared = state["shared"]
        stacked = state["lazy"].get("stacked")
        if stacked is not None:
            B, S = shared["pk"].shape[1], stacked["k"].shape[2]
        else:
            B = shared["layers"][0]["pk"].shape[0]
            S = state["lazy"]["layers"][0]["k"].shape[1]
        Bk = tokens.shape[0]
        K = Bk // B
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
        if stacked is not None:
            nh = self.config.num_heads
            x, _, _ = beam_decode_stack(
                x, shared["stack"], stacked["k"], stacked["v"], shared["pk"],
                shared["pv"], anc_local, pos, num_heads=nh, beam_size=K,
                scale=1.0 / (self.config.hidden_dim // nh) ** 0.5)
        else:
            for block, cache, pre in zip(self.backbone.blocks,
                                         state["lazy"]["layers"],
                                         shared["layers"]):
                x = block.cached_step(x, cache["k"], cache["v"], pos,
                                      pre["pk"], pre["pv"], anc_local,
                                      shared["fold"])
        logits = self.backbone.logits(self.backbone.ln_f(x))
        return logits, dict(state, pos=pos + 1)

    def generate(self, encoder_features: Dict[str, torch.Tensor],
                 max_length: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Greedy KV-cached generation through ``init_cache``/``step``:
        tokens [B, max_length] with BOS at position 0, ``max_length`` steps
        (the JAX scan's), a row emitting pads after its first EOS."""
        B = encoder_features["pooled_features"].shape[0]
        return greedy_decode(self.step,
                             self.init_cache(encoder_features, max_length),
                             B, self.bos_token_id, max_length,
                             eos_token_id=self.eos_token_id,
                             pad_token_id=self.pad_token_id,
                             early_exit=False), {}
