"""Plain reference of the flagship: the CLIP ViT-B/32 vision tower
(openai/clip-vit-base-patch32), its post-LN CLS feature projected to a
10-token prefix, and GPT-2 124M (openai-community/gpt2) with its tied LM
head, beam-searched with HF ``generate``'s rules. Float32, no cache: each
decode step runs the whole prefix and caption again.

It reads the weights the benchmark drew, by the program's state-dict
names, and works out everything else itself.
"""

from __future__ import annotations

from typing import Dict

import torch

from .common import (Numerics, attention, beam_search, causal, gelu_tanh,
                     layer_norm, patches, quick_gelu)


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
        """uint8 NHWC -> the pooled (post-LN CLS) feature [n, H]."""
        v = self.c["vision"]
        e = "encoder.backbone"
        x = self.nx.mm(patches(images, v["patch_size"]),
                       self.w[e + ".patch_embed.weight"])
        cls = self.w[e + ".class_embedding"].expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + self.w[e + ".position_embeddings"]
        x = self._ln(x, e + ".pre_layernorm", 1e-5)
        for i in range(v["num_layers"]):
            p = f"{e}.layers.{i}"
            h = self._ln(x, p + ".layer_norm1", 1e-5)
            q, k, vv = self._lin(h, p + ".attention.qkv").chunk(3, -1)
            x = x + self._lin(attention(q, k, vv, v["num_heads"]),
                              p + ".attention.out")
            h = self._ln(x, p + ".layer_norm2", 1e-5)
            x = x + self._lin(quick_gelu(self._lin(h, p + ".fc1")),
                              p + ".fc2")
        return self._ln(x[:, 0], e + ".post_layernorm", 1e-5)

    def prefix(self, pooled: torch.Tensor) -> torch.Tensor:
        """The image's prefix token embeddings [n, P, H], positions
        added."""
        P = self.c["gpt2"]["prefix_length"]
        n = pooled.shape[0]
        pre = self._lin(pooled, "decoder.image_to_prefix").reshape(n, P, -1)
        pre = pre + self.w["decoder.image_prefix"]
        return pre + self.w["decoder.backbone.wpe.weight"][:P]

    def logits(self, prefix: torch.Tensor, tokens: torch.Tensor,
               last_only: bool = False, pad: int = None) -> torch.Tensor:
        """GPT-2 over [prefix; tokens] under a causal mask (and with
        caption tokens equal to ``pad`` hidden as keys): the logits at
        each caption position [n, T, V] (or the last one's [n, V])."""
        g = self.c["gpt2"]
        d = "decoder.backbone"
        P, T = prefix.shape[1], tokens.shape[1]
        wte = self.w[d + ".wte.weight"]
        x = torch.cat([prefix, wte[tokens]
                       + self.w[d + ".wpe.weight"][P:P + T]], 1)
        mask = causal(P + T, x.device)
        if pad is not None:
            keys = torch.cat([torch.ones((tokens.shape[0], P),
                                         dtype=torch.bool, device=x.device),
                              tokens != pad], 1)
            mask = mask[None, None] & keys[:, None, None, :]
        for i in range(g["num_layers"]):
            b = f"{d}.blocks.{i}"
            h = self._ln(x, b + ".ln_1", 1e-5)
            q, k, v = self._lin(h, b + ".attn.c_attn").chunk(3, -1)
            x = x + self._lin(attention(q, k, v, g["num_heads"], mask),
                              b + ".attn.c_proj")
            h = self._ln(x, b + ".ln_2", 1e-5)
            x = x + self._lin(gelu_tanh(self._lin(h, b + ".mlp.c_fc")),
                              b + ".mlp.c_proj")
        x = x[:, -1] if last_only else x[:, P:]
        return self.nx.mm(self._ln(x, d + ".ln_f", 1e-5), wte)

    def condition(self, images: torch.Tensor) -> torch.Tensor:
        return self.prefix(self.encode(images))

    def condition_kv(self, images: torch.Tensor) -> torch.Tensor:
        """What a decode reads of each image before its first step: every
        GPT-2 layer's K and V over the prefix (causal), per image
        [n, L * 2 * P * H] (layer, then K before V)."""
        g = self.c["gpt2"]
        d = "decoder.backbone"
        x = self.condition(images)
        mask = causal(x.shape[1], x.device)
        kv = []
        for i in range(g["num_layers"]):
            b = f"{d}.blocks.{i}"
            h = self._ln(x, b + ".ln_1", 1e-5)
            q, k, v = self._lin(h, b + ".attn.c_attn").chunk(3, -1)
            kv += [k, v]
            x = x + self._lin(attention(q, k, v, g["num_heads"], mask),
                              b + ".attn.c_proj")
            h = self._ln(x, b + ".ln_2", 1e-5)
            x = x + self._lin(gelu_tanh(self._lin(h, b + ".mlp.c_fc")),
                              b + ".mlp.c_proj")
        return torch.stack(kv, 1).reshape(x.shape[0], -1)

    def beam(self, images: torch.Tensor):
        """The beam search's best hypothesis [n, L] and its score [n]."""
        dec, ids = self.c["decode"], self.c["ids"]
        K = dec["beam_size"]
        pre = self.condition(images).repeat_interleave(K, 0)
        return beam_search(lambda tok: self.logits(pre, tok, last_only=True),
                           images.shape[0], K, ids["bos"], ids["eos"],
                           ids["pad"], dec["max_length"],
                           dec["length_penalty"], dec["min_length"],
                           images.device)

    def teacher_logits(self, images: torch.Tensor,
                       tokens: torch.Tensor) -> torch.Tensor:
        """Logits [n, L-1, V] of each served position given the served
        tokens before it (``tokens`` [n, L], BOS first)."""
        return self.logits(self.condition(images), tokens[:, :-1])

    def ce_sum(self, images: torch.Tensor, captions: torch.Tensor,
               mask: torch.Tensor):
        """The teacher-forced CE of captions [n, T] (BOS first, pads after
        EOS; ``mask`` 1 on the supervised tokens): the sum of each
        supervised token's negative log-probability given the tokens
        before it, and their count."""
        logits = self.logits(self.condition(images), captions,
                             pad=self.c["ids"]["pad"])[:, :-1]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(2, captions[:, 1:, None])[:, :, 0]
        m = mask[:, 1:].float()
        return (nll * m).sum(), m.sum()
