"""Plain reference of the Transformer family: ViT-B/16
(google/vit-base-patch16-224: pre-LN layers with exact GELU, a final
LayerNorm; its 196 patch tokens are the memory) and a 6-layer post-LN
Transformer decoder (self-attention, cross-attention to the projected
memory, exact-GELU FFN, learned positions, an output layer with a bias),
beam-searched with HF ``generate``'s rules. Float32, no cache.
"""

from __future__ import annotations

from typing import Dict

import torch

from .common import (Numerics, attention, beam_search, causal, gelu_erf,
                     layer_norm, patches)


class Reference:
    def __init__(self, state: Dict[str, torch.Tensor], config: dict,
                 numerics: Numerics):
        self.w = {k: v.float() for k, v in state.items()}
        self.c = config
        self.nx = numerics

    def _lin(self, x, name):
        return self.nx.mm(x, self.w[name + ".weight"],
                          self.w.get(name + ".bias"))

    def _ln(self, x, name, eps):
        return layer_norm(x, self.w[name + ".weight"],
                          self.w[name + ".bias"], eps)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> the patch tokens after the final LayerNorm
        [n, S, H] (CLS dropped)."""
        v = self.c["vision"]
        e = "encoder.backbone"
        x = self._lin(patches(images, v["patch_size"]), e + ".patch_embed")
        cls = self.w[e + ".cls_token"].expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + self.w[e + ".position_embeddings"]
        for i in range(v["num_layers"]):
            p = f"{e}.layers.{i}"
            h = self._ln(x, p + ".layernorm_before", 1e-12)
            q, k, vv = self._lin(h, p + ".attention.qkv").chunk(3, -1)
            x = x + self._lin(attention(q, k, vv, v["num_heads"]),
                              p + ".attention.out")
            h = self._ln(x, p + ".layernorm_after", 1e-12)
            x = x + self._lin(gelu_erf(self._lin(h, p + ".intermediate")),
                              p + ".output")
        return self._ln(x, e + ".layernorm", 1e-12)[:, 1:]

    def condition(self, images: torch.Tensor) -> torch.Tensor:
        """The decoder's memory [n, S, H]."""
        return self._lin(self.encode(images), "decoder.visual_projection")

    def condition_kv(self, images: torch.Tensor) -> torch.Tensor:
        """What a decode reads of each image before its first step: every
        decoder layer's cross-attention K and V of the memory, per image
        [n, L * 2 * S * H] (layer, then K before V)."""
        mem = self.condition(images)
        kv = []
        for i in range(self.c["decoder"]["num_layers"]):
            ca = f"decoder.layers.{i}.cross_attn"
            kv += [self._lin(mem, ca + ".k_proj"),
                   self._lin(mem, ca + ".v_proj")]
        return torch.stack(kv, 1).reshape(mem.shape[0], -1)

    def logits(self, memory: torch.Tensor, tokens: torch.Tensor,
               last_only: bool = False) -> torch.Tensor:
        d = self.c["decoder"]
        T = tokens.shape[1]
        x = (self.w["decoder.embedding.weight"][tokens]
             + self.w["decoder.position_encoding.weight"][:T])
        mask = causal(T, x.device)
        for i in range(d["num_layers"]):
            p = f"decoder.layers.{i}"
            sa, ca = p + ".self_attn", p + ".cross_attn"
            y = attention(self._lin(x, sa + ".q_proj"),
                          self._lin(x, sa + ".k_proj"),
                          self._lin(x, sa + ".v_proj"), d["num_heads"], mask)
            x = self._ln(x + self._lin(y, sa + ".out_proj"), p + ".norm1",
                         1e-5)
            y = attention(self._lin(x, ca + ".q_proj"),
                          self._lin(memory, ca + ".k_proj"),
                          self._lin(memory, ca + ".v_proj"), d["num_heads"])
            x = self._ln(x + self._lin(y, ca + ".out_proj"), p + ".norm2",
                         1e-5)
            y = self._lin(gelu_erf(self._lin(x, p + ".linear1")),
                          p + ".linear2")
            x = self._ln(x + y, p + ".norm3", 1e-5)
        if last_only:
            x = x[:, -1]
        return self._lin(x, "decoder.output_layer")

    def beam(self, images: torch.Tensor):
        dec, ids = self.c["decode"], self.c["ids"]
        K = dec["beam_size"]
        mem = self.condition(images).repeat_interleave(K, 0)
        return beam_search(lambda tok: self.logits(mem, tok, last_only=True),
                           images.shape[0], K, ids["bos"], ids["eos"],
                           ids["pad"], dec["max_length"],
                           dec["length_penalty"], dec["min_length"],
                           images.device)

    def teacher_logits(self, images: torch.Tensor,
                       tokens: torch.Tensor) -> torch.Tensor:
        return self.logits(self.condition(images), tokens[:, :-1])
