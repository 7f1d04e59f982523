"""Caption decoders in PyTorch: the Transformer decoder with KV-cached
generation, the LSTM decoder with per-step cross-attention, and the
decoder factory.

Counterpart of the Transformer and LSTM parts of
``image_captioning_ml_project_tpu.models.decoders``. Both keep the image
memory per image under the decode state's ``shared`` subtree, never tiled
over beams; the decode step finds each image's ``K`` beam rows by the row
count.

**Transformer.** Post-LN decoder layers (self-attention, cross-attention
over the projected image features, exact-GELU FFN; LayerNorm eps 1e-5)
with learned positions. Generation keeps one self-attention cache per
layer under the decode state's ``lazy`` subtree (tiled once over beams,
then read through beam search's ancestry map) and the cross-attention
memory K/V per image under ``shared``: the keys pre-transposed
``[B, H, Sm]``, as the JAX decoder stores them. Each layer's decode step
runs:

* the self-attention step through the beam-decode kernels in their
  prefix-free mode: by default
  :func:`..ops.beam_decode_attention.beam_decode_attention_qkv` with the
  QKV and output projections inside (the fold), and under
  ``ICT_DECODE_FOLD=0`` :func:`..ops.beam_decode_attention.
  beam_decode_attention` between the projection layers (the split); the
  switch is the JAX package's, read once per decode at ``init_cache``;
* the cross-attention step through :func:`..ops.cross_attention.
  cross_attention`, with ``q_proj`` before it and ``out_proj`` after it.

On a CUDA tensor each is a hand-written kernel, on a CPU tensor its plain
version. The JAX package's TPU paddings are left out: the self-attention
caches hold exactly ``max_length`` positions and the memory keeps its
``Sm`` real rows, masked by the encoder's attention mask only.

**LSTM** (Show-Attend-Tell style). Per step: ``[embed(prev token);
prev_context]`` through the stacked LSTM, then the configured attention
variant (:mod:`.attention`) with the top hidden state as its query over
the image features, then the output layer on the context. The hidden
states start from the pooled features through ``init_h``/``init_c``. The
JAX decoder keeps the features under ``static``, tiled once over beams;
here they stay per image under ``shared``, with their key/value
projections computed once per decode in ``init_cache`` rather than at
every step (the same values: the projection depends on the image only).
h, c and ``prev_context`` follow the beams.

In training mode the teacher-forced forwards apply ``DecoderConfig.
dropout`` where the JAX decoders do under ``deterministic=False``: the
Transformer on its embeddings and on each sublayer's output (and inside
the FFN), the LSTM on its token embeddings and on the context before the
output layer (the carried context is not dropped).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DecoderType
from ..inference.decoding import greedy_decode
from ..ops.beam_decode_attention import (beam_decode_attention,
                                         beam_decode_attention_qkv)
from ..ops.cross_attention import cross_attention
from .attention import build_attention
from .gpt2 import GPT2Decoder, decode_fold_enabled
from .layers import LayerNorm, dropout
from .lstm import StackedLSTM

_NEG_INF = -1e9


class CachedMHA(nn.Module):
    """Multi-head attention with separate q/k/v/out projections. ``wqkv``
    and ``bqkv`` are set at model load (:func:`..params.
    stack_layer_weights`): the q/k/v weights and biases concatenated, with
    the three projections' parameters views of them."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(hidden_dim, hidden_dim)
        self.k_proj = nn.Linear(hidden_dim, hidden_dim)
        self.v_proj = nn.Linear(hidden_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)
        self.wqkv: Optional[torch.Tensor] = None
        self.bqkv: Optional[torch.Tensor] = None

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        return x.reshape(B, T, self.num_heads, -1)

    def _mix(self, scores: torch.Tensor, v: torch.Tensor,
             q_input: torch.Tensor) -> torch.Tensor:
        """f32 scores [B, nh, T, S] -> softmax -> weights in the value
        dtype -> mix of v [B, S, nh, hd] -> out_proj."""
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        B, T = q_input.shape[:2]
        return self.out_proj(torch.einsum("bnqk,bknd->bqnd", w, v)
                             .reshape(B, T, self.hidden_dim))

    def _scores(self, q_input: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """f32 ``q . k`` divided by ``sqrt(hd)``, as the JAX module divides
        (the decode step's kernels multiply by the reciprocal instead)."""
        q = self._heads(self.q_proj(q_input))
        return torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) \
            / (q.shape[-1] ** 0.5)

    def full(self, q_input: torch.Tensor, kv_input: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q_input [B, T, H] over kv_input [B, S, H], with an additive
        bias broadcast to [B, nh, T, S]."""
        k, v = self.project_kv(kv_input)
        scores = self._scores(q_input, k)
        if bias is not None:
            scores = scores + bias
        return self._mix(scores, v, q_input)

    def project_kv(self, kv_input: torch.Tensor):
        """K/V of a memory: [B, S, nh, hd] each."""
        return (self._heads(self.k_proj(kv_input)),
                self._heads(self.v_proj(kv_input)))

    def attend_precomputed(self, q_input: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           key_padding_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """q_input [B, T, H] against precomputed k/v [B, S, nh, hd];
        ``key_padding_mask`` [B, S] True = masked."""
        scores = self._scores(q_input, k)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        _NEG_INF)
        return self._mix(scores, v, q_input)


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer with an exact-GELU FFN (torch
    ``nn.TransformerDecoderLayer`` semantics; dropout in training only)."""

    def __init__(self, hidden_dim: int, num_heads: int, rate: float = 0.0):
        super().__init__()
        h = hidden_dim
        self.hidden_dim = h
        self.num_heads = num_heads
        self.rate = rate
        self.self_attn = CachedMHA(h, num_heads)
        self.cross_attn = CachedMHA(h, num_heads)
        self.linear1 = nn.Linear(h, 4 * h)
        self.linear2 = nn.Linear(4 * h, h)
        self.norm1 = LayerNorm(h, eps=1e-5)
        self.norm2 = LayerNorm(h, eps=1e-5)
        self.norm3 = LayerNorm(h, eps=1e-5)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.training)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self._drop(F.gelu(self.linear1(x))))

    def full(self, x: torch.Tensor, memory: torch.Tensor,
             self_bias: Optional[torch.Tensor] = None,
             memory_key_padding_mask: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        x = self.norm1(x + self._drop(self.self_attn.full(x, x,
                                                          bias=self_bias)))
        x = self.norm2(x + self._drop(self.cross_attn.attend_precomputed(
            x, *self.cross_attn.project_kv(memory),
            key_padding_mask=memory_key_padding_mask)))
        return self.norm3(x + self._drop(self._ffn(x)))

    def init_memory_cache(self, memory: torch.Tensor) -> Dict[str, Any]:
        """The cross-attention K/V of the image memory [B, Sm, H]: keys
        pre-transposed ``mem_k`` [B, H, Sm], values ``mem_v`` [B, Sm, H].
        Per image, not per beam: they live under the state's ``shared``."""
        k, v = self.cross_attn.project_kv(memory)
        B, Sm = memory.shape[:2]
        return {"mem_k": k.reshape(B, Sm, -1).transpose(1, 2).contiguous(),
                "mem_v": v.reshape(B, Sm, -1).contiguous()}

    def _self_attend_step(self, x, cache, pos, anc_local, beam_size, fold):
        """The self-attention step over x [Bk, H] (prefix-free), appending
        this step's K/V at ``pos`` of the caches in place."""
        sa = self.self_attn
        args = dict(num_heads=self.num_heads, beam_size=beam_size,
                    scale=1.0 / (self.hidden_dim // self.num_heads) ** 0.5)
        if fold:
            if sa.wqkv is None:
                raise RuntimeError("the folded decode needs the concatenated "
                                   "QKV weights: build the model with "
                                   "load_model")
            out, _, _ = beam_decode_attention_qkv(
                x, sa.wqkv, sa.bqkv, sa.out_proj.weight, sa.out_proj.bias,
                cache["k"], cache["v"], None, None, anc_local, pos, **args)
            return out
        out, _, _ = beam_decode_attention(
            sa.q_proj(x), sa.k_proj(x), sa.v_proj(x), cache["k"], cache["v"],
            None, None, anc_local, pos, **args)
        return sa.out_proj(out)

    def _cross_attend_step(self, x, mem, mem_pad, beam_size):
        """x [Bk, H] against the image memory, ``q_proj`` and ``out_proj``
        around the kernel; the scale is a reciprocal multiply, as on both
        JAX step paths."""
        ca = self.cross_attn
        out = cross_attention(
            ca.q_proj(x), mem["mem_k"], mem["mem_v"], mem_pad,
            num_heads=self.num_heads, beam_size=beam_size,
            scale=1.0 / (self.hidden_dim // self.num_heads) ** 0.5)
        return ca.out_proj(out)

    def cached_step(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    pos: int, mem: Dict[str, torch.Tensor],
                    mem_pad: Optional[torch.Tensor],
                    anc_local: Optional[torch.Tensor],
                    fold: bool) -> torch.Tensor:
        """x [Bk, H] -> [Bk, H]; the self-attention caches ``cache``
        [Bk, S, H] are appended at ``pos`` in place; ``mem`` holds the
        image memory's K/V and ``mem_pad`` [B, Sm] its mask."""
        K = x.shape[0] // mem["mem_k"].shape[0]
        x = self.norm1(x + self._self_attend_step(x, cache, pos, anc_local,
                                                  K, fold))
        x = self.norm2(x + self._cross_attend_step(x, mem, mem_pad, K))
        return self.norm3(x + self._ffn(x))


class TransformerDecoder(nn.Module):
    """Transformer caption decoder: token embedding + learned positions,
    post-LN decoder layers over the visually projected encoder features,
    an output layer over the vocabulary."""

    def __init__(self, config, vocab_size: int, pad_token_id: int,
                 bos_token_id: int, eos_token_id: int, feature_dim: int):
        super().__init__()
        h = config.hidden_dim
        self.config = config
        self.pad_token_id = pad_token_id
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.embedding = nn.Embedding(vocab_size, h)
        self.position_encoding = nn.Embedding(config.max_length, h)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(h, config.num_heads, config.dropout)
            for _ in range(config.num_layers))
        self.output_layer = nn.Linear(h, vocab_size)
        self.visual_projection = nn.Linear(feature_dim, h)

    def forward(self, encoder_features: Dict[str, torch.Tensor],
                captions: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward: logits [B, T, V] under a causal and
        caption-padding bias."""
        memory = self.visual_projection(encoder_features["features"])
        mem_mask = encoder_features.get("attention_mask")
        mem_pad = None if mem_mask is None else ~mem_mask.bool()
        T = captions.shape[1]
        dev = captions.device
        x = self.embedding(captions) + self.position_encoding.weight[:T][None]
        x = dropout(x, self.config.dropout, self.training)
        causal = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
        zero = torch.zeros((), device=dev)
        neg = torch.full((), _NEG_INF, device=dev)
        bias = (torch.where(causal, zero, neg)[None, None]
                + torch.where(captions == self.pad_token_id, neg,
                              zero)[:, None, None, :])
        for layer in self.layers:
            x = layer.full(x, memory, self_bias=bias,
                           memory_key_padding_mask=mem_pad)
        return {"logits": self.output_layer(x), "hidden_states": x}

    # -- uniform decode interface -------------------------------------------

    def init_cache(self, encoder_features: Dict[str, torch.Tensor],
                   max_length: int) -> Dict[str, Any]:
        """Zeroed self-attention caches ``[B, max_length, H]`` per layer
        under ``lazy``; each layer's memory K/V, the memory mask ``mem_pad``
        [B, Sm] (True = masked) and the decode path (``fold``, from
        :func:`.gpt2.decode_fold_enabled`, read here once per decode) under
        ``shared``. ``pos`` counts generated positions."""
        memory = self.visual_projection(encoder_features["features"])
        B, Sm, H = memory.shape
        mem_mask = encoder_features.get("attention_mask")
        mem_pad = (torch.zeros((B, Sm), dtype=torch.bool,
                               device=memory.device)
                   if mem_mask is None else (~mem_mask.bool()).contiguous())
        caches = [{"k": memory.new_zeros((B, max_length, H)),
                   "v": memory.new_zeros((B, max_length, H))}
                  for _ in self.layers]
        shared = {"layers": [layer.init_memory_cache(memory)
                             for layer in self.layers],
                  "mem_pad": mem_pad, "fold": decode_fold_enabled()}
        return {"lazy": {"layers": caches}, "shared": shared, "pos": 0}

    def step(self, state: Dict[str, Any], tokens: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens [Bk] -> (logits [Bk, V], state at pos + 1). The
        self-attention caches are appended in place."""
        pos = state["pos"]
        shared = state["shared"]
        Bk = tokens.shape[0]
        K = Bk // shared["layers"][0]["mem_k"].shape[0]
        S = state["lazy"]["layers"][0]["k"].shape[1]
        ancestry = state["lazy"].get("ancestry")  # set by beam search only
        anc_local = None
        if ancestry is not None:
            own = torch.arange(Bk, device=ancestry.device,
                               dtype=ancestry.dtype)[:, None] // K * K
            anc_local = ancestry - own                 # [Bk, L] in 0..K-1
            if anc_local.shape[1] < S:
                anc_local = F.pad(anc_local, (0, S - anc_local.shape[1]))
            anc_local = anc_local.to(torch.int32).contiguous()
        x = self.embedding(tokens) + self.position_encoding.weight[pos]
        for layer, cache, mem in zip(self.layers, state["lazy"]["layers"],
                                     shared["layers"]):
            x = layer.cached_step(x, cache, pos, mem, shared["mem_pad"],
                                  anc_local, shared["fold"])
        return self.output_layer(x), dict(state, pos=pos + 1)

    def generate(self, encoder_features: Dict[str, torch.Tensor],
                 max_length: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Greedy KV-cached generation through ``init_cache``/``step``:
        tokens [B, max_length] with BOS at position 0, ``max_length`` steps,
        no EOS handling (as the JAX decoder's)."""
        B = encoder_features["features"].shape[0]
        return greedy_decode(self.step,
                             self.init_cache(encoder_features, max_length),
                             B, self.bos_token_id, max_length), {}


class LSTMDecoder(nn.Module):
    """LSTM decoder with per-step cross-attention over the image features:
    teacher-forced ``forward`` and the uniform decode interface
    (``init_cache``/``step``)."""

    def __init__(self, config, attention_config, vocab_size: int,
                 pad_token_id: int, bos_token_id: int, eos_token_id: int,
                 feature_dim: int, memory_dim: Optional[int] = None):
        super().__init__()
        H, L = config.hidden_dim, config.num_layers
        self.config = config
        self.pad_token_id = pad_token_id
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.embedding = nn.Embedding(vocab_size, H)
        self.attention = build_attention(attention_config, query_dim=H,
                                         memory_dim=memory_dim or feature_dim)
        # the LSTM input is [embedding; previous context]; the JAX decoder
        # starts the context as H zeros, so the two widths must agree
        if self.attention.context_dim != H:
            raise ValueError(
                f"the {attention_config.attention_type.value} attention "
                f"gives contexts of width {self.attention.context_dim}, the "
                f"LSTM's hidden width is {H}: they must agree")
        # the JAX decoder never enables the cells' inter-layer dropout (it
        # calls its StackedLSTM without ``deterministic``): neither does
        # this one
        self.lstm = StackedLSTM(2 * H, H, L, rate=config.dropout)
        self.output_layer = nn.Linear(H, vocab_size)
        self.init_h = nn.Linear(feature_dim, H * L)
        self.init_c = nn.Linear(feature_dim, H * L)

    def _init_states(self, pooled: torch.Tensor):
        """[B, D] -> (h, c) each [B, L, H]."""
        B = pooled.shape[0]
        L, H = self.config.num_layers, self.config.hidden_dim
        return (self.init_h(pooled).reshape(B, L, H),
                self.init_c(pooled).reshape(B, L, H))

    def _step_core(self, h, c, prev_context, token_emb, memory, mem_pad):
        """One step shared by teacher forcing and generation; h, c
        [Bk, L, H]; ``memory`` the attention's per-image projections."""
        h, c, top = self.lstm(h, c, torch.cat([token_emb, prev_context],
                                              dim=-1))
        context, attn_w = self.attention.attend(
            top, memory, mem_pad, memory_state=h[:, -1],
            cell_state=c[:, -1])
        return h, c, context, attn_w

    @staticmethod
    def _mem_pad(encoder_features) -> Optional[torch.Tensor]:
        mask = encoder_features.get("attention_mask")
        return None if mask is None else ~mask.bool()

    def forward(self, encoder_features: Dict[str, torch.Tensor],
                captions: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward: captions [B, T] -> logits [B, T, V],
        attention weights [B, T, S] and the top hidden state of each step
        [B, T, H]."""
        features = encoder_features["features"]
        mem_pad = self._mem_pad(encoder_features)
        memory = self.attention.project_memory(features, features)
        h, c = self._init_states(encoder_features["pooled_features"])
        rate = self.config.dropout
        emb = dropout(self.embedding(captions), rate, self.training)
        context = emb.new_zeros((captions.shape[0], self.config.hidden_dim))
        logits, weights, hidden = [], [], []
        for t in range(captions.shape[1]):
            h, c, context, w = self._step_core(h, c, context, emb[:, t],
                                               memory, mem_pad)
            logits.append(self.output_layer(dropout(context, rate,
                                                     self.training)))
            weights.append(w)
            hidden.append(h[:, -1])
        return {"logits": torch.stack(logits, 1),
                "attention_weights": torch.stack(weights, 1),
                "hidden_states": torch.stack(hidden, 1)}

    def generate(self, encoder_features: Dict[str, torch.Tensor],
                 max_length: int
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Greedy decode over ``_step_core``, the previous context carried
        as in teacher forcing: tokens [B, max_length] with BOS at position
        0, ``max_length`` steps, no EOS handling (as the JAX decoder's), and
        the attention weights of each step ``{"attention_weights": [B,
        max_length, S]}``."""
        features = encoder_features["features"]
        mem_pad = self._mem_pad(encoder_features)
        memory = self.attention.project_memory(features, features)
        h, c = self._init_states(encoder_features["pooled_features"])
        context = features.new_zeros((features.shape[0],
                                      self.config.hidden_dim))
        current = torch.full((features.shape[0],), self.bos_token_id,
                             dtype=torch.long, device=features.device)
        tokens, weights = [], []
        for _ in range(max_length):
            h, c, context, w = self._step_core(h, c, context,
                                               self.embedding(current),
                                               memory, mem_pad)
            tokens.append(current)
            weights.append(w)
            current = torch.argmax(self.output_layer(context), dim=-1)
        return (torch.stack(tokens, dim=1),
                {"attention_weights": torch.stack(weights, dim=1)})

    # -- uniform decode interface -------------------------------------------

    def init_cache(self, encoder_features: Dict[str, torch.Tensor],
                   max_length: int) -> Dict[str, Any]:
        """h, c [B, L, H] and ``prev_context`` [B, H] (zeros in the
        features' dtype) follow the beams; the attention's projections of
        the features (``memory``) and their mask ``mem_pad`` [B, S] (True
        = masked, or None) are per image under ``shared``."""
        features = encoder_features["features"]
        h, c = self._init_states(encoder_features["pooled_features"])
        return {
            "h": h, "c": c,
            "prev_context": features.new_zeros((features.shape[0],
                                                self.config.hidden_dim)),
            "shared": {
                "memory": self.attention.project_memory(features, features),
                "mem_pad": self._mem_pad(encoder_features)},
        }

    def step(self, state: Dict[str, Any], tokens: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens [Bk] -> (logits [Bk, V], the next state)."""
        shared = state["shared"]
        h, c, context, _ = self._step_core(
            state["h"], state["c"], state["prev_context"],
            self.embedding(tokens), shared["memory"], shared["mem_pad"])
        return self.output_layer(context), dict(state, h=h, c=c,
                                                prev_context=context)


def build_decoder(config, vocab_size: int, pad_token_id: int,
                  bos_token_id: int, eos_token_id: int, feature_dim: int,
                  attention_config=None,
                  memory_dim: Optional[int] = None) -> nn.Module:
    """The decoder of ``config`` (a ``DecoderConfig``) over pooled
    features of width ``feature_dim`` and attended features of width
    ``memory_dim`` (the Q-Former's queries' where it runs; by default
    ``feature_dim``); the LSTM's cross-attention is ``attention_config``
    (an ``AttentionConfig``), which the other decoders do not read, as in
    the JAX package."""
    ids = dict(vocab_size=vocab_size, pad_token_id=pad_token_id,
               bos_token_id=bos_token_id, eos_token_id=eos_token_id)
    memory_dim = memory_dim or feature_dim
    if config.decoder_type == DecoderType.GPT2:
        return GPT2Decoder(config, feature_dim=feature_dim, **ids)
    if config.decoder_type == DecoderType.TRANSFORMER:
        return TransformerDecoder(config, feature_dim=memory_dim, **ids)
    if config.decoder_type == DecoderType.LSTM:
        if attention_config is None:
            raise ValueError("the LSTM decoder needs an attention config")
        return LSTMDecoder(config, attention_config, feature_dim=feature_dim,
                           memory_dim=memory_dim, **ids)
    raise ValueError(f"Unsupported decoder type: {config.decoder_type}")
