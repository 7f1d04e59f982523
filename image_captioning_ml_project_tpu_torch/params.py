"""Weight bridge: the JAX package's flax variables -> this package's torch
state dict, and the seeded initialisation used when no weights are given.

Layouts carried across:

* flax ``Dense`` kernels are ``[in, out]``; ``nn.Linear`` weights are
  ``[out, in]``, so every kernel is transposed;
* the CLIP attention's unfused ``query``/``key``/``value`` Dense params
  are concatenated into the one ``[h, 3h]`` QKV projection (a flax tree
  saved with ``fused_qkv`` already has ``qkv``);
* the patch-embed conv kernel ``[P, P, C, H]`` is flattened in
  (kh, kw, c) order to ``[P*P*C, H]`` and transposed;
* LayerNorm ``scale``/``bias`` become ``weight``/``bias``; ``Embed``
  ``embedding`` becomes ``weight``.

Every flax leaf must be consumed: a leaf no rule maps raises, and so does
a leaf a rule expects but the tree lacks.

:func:`stack_layer_weights` builds, once at model load, the layer-stacked
operands the whole-stack kernels read (the JAX package's
``_stacked_weights`` and the encoder fold's stack, which are free under
``jit`` but would be a copy per batch in eager PyTorch).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


class _Bridge:
    """Pops flax leaves by path and records torch tensors by name."""

    def __init__(self, flat: Dict[str, np.ndarray]):
        self.flat = dict(flat)
        self.out: Dict[str, torch.Tensor] = {}

    def take(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"flax tree has no leaf {path!r}")
        return self.flat.pop(path)

    def put(self, name: str, array: np.ndarray) -> None:
        self.out[name] = torch.from_numpy(
            np.array(array, dtype=np.float32, order="C"))

    def dense(self, src: str, dst: str) -> None:
        self.put(f"{dst}.weight", self.take(f"{src}/kernel").T)
        self.put(f"{dst}.bias", self.take(f"{src}/bias"))

    def norm(self, src: str, dst: str) -> None:
        self.put(f"{dst}.weight", self.take(f"{src}/scale"))
        self.put(f"{dst}.bias", self.take(f"{src}/bias"))

    def indices(self, prefix: str, stem: str):
        pat = re.compile(rf"^{re.escape(prefix)}/{stem}_(\d+)/")
        return sorted({int(m.group(1)) for m in map(pat.match, self.flat)
                       if m})


def from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Map the JAX ``ImageCaptioningModel`` variables (CLIP encoder + GPT-2
    decoder; nested dict of arrays, with or without the top-level
    ``"params"``) to an f32 state dict of
    :class:`..models.captioning_model.ImageCaptioningModel`."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    br = _Bridge(_flatten(tree))

    enc = "encoder/backbone"
    kernel = br.take(f"{enc}/patch_embed/kernel")             # [P, P, C, H]
    br.put("encoder.backbone.patch_embed.weight",
           kernel.reshape(-1, kernel.shape[-1]).T)
    br.put("encoder.backbone.class_embedding",
           br.take(f"{enc}/class_embedding"))
    br.put("encoder.backbone.position_embeddings",
           br.take(f"{enc}/position_embeddings"))
    br.norm(f"{enc}/pre_layernorm", "encoder.backbone.pre_layernorm")
    br.norm(f"{enc}/post_layernorm", "encoder.backbone.post_layernorm")
    for i in br.indices(enc, "layer"):
        src, dst = f"{enc}/layer_{i}", f"encoder.backbone.layers.{i}"
        att = f"{src}/attention"
        if f"{att}/qkv/kernel" in br.flat:
            br.dense(f"{att}/qkv", f"{dst}.attention.qkv")
        else:
            parts = [(br.take(f"{att}/{n}/kernel"), br.take(f"{att}/{n}/bias"))
                     for n in ("query", "key", "value")]
            br.put(f"{dst}.attention.qkv.weight",
                   np.concatenate([k for k, _ in parts], axis=1).T)
            br.put(f"{dst}.attention.qkv.bias",
                   np.concatenate([b for _, b in parts]))
        br.dense(f"{att}/out", f"{dst}.attention.out")
        br.norm(f"{src}/layer_norm1", f"{dst}.layer_norm1")
        br.norm(f"{src}/layer_norm2", f"{dst}.layer_norm2")
        br.dense(f"{src}/fc1", f"{dst}.fc1")
        br.dense(f"{src}/fc2", f"{dst}.fc2")
    if "encoder/proj/kernel" in br.flat:
        br.dense("encoder/proj", "encoder.proj")

    dec = "decoder/backbone"
    br.put("decoder.backbone.wte.weight", br.take(f"{dec}/wte/embedding"))
    br.put("decoder.backbone.wpe.weight", br.take(f"{dec}/wpe/embedding"))
    for i in br.indices(dec, "block"):
        src, dst = f"{dec}/block_{i}", f"decoder.backbone.blocks.{i}"
        br.norm(f"{src}/ln_1", f"{dst}.ln_1")
        br.dense(f"{src}/attn/c_attn", f"{dst}.attn.c_attn")
        br.dense(f"{src}/attn/c_proj", f"{dst}.attn.c_proj")
        br.norm(f"{src}/ln_2", f"{dst}.ln_2")
        br.dense(f"{src}/mlp/c_fc", f"{dst}.mlp.c_fc")
        br.dense(f"{src}/mlp/c_proj", f"{dst}.mlp.c_proj")
    br.norm(f"{dec}/ln_f", "decoder.backbone.ln_f")
    br.dense("decoder/image_to_prefix", "decoder.image_to_prefix")
    br.put("decoder.image_prefix", br.take("decoder/image_prefix"))

    if br.flat:
        raise ValueError(f"unmapped flax leaves: {sorted(br.flat)}")
    return br.out


def init_flax_params(config, seed: int) -> Dict[str, Any]:
    """Seeded weights in the flax layout of the JAX ``ImageCaptioningModel``
    (CLIP + GPT-2), drawn from ``numpy.random.RandomState(seed)``: dense
    kernels and embeddings N(0, 0.02²) (GPT-2's initialiser), the class
    embedding N(0, 1/width), the learned image prefix N(0, 1) as flax draws
    it, biases 0, norm scales 1."""
    rs = np.random.RandomState(seed)
    mc = config.model
    ec, dc = mc.encoder, mc.decoder

    def normal(*shape, std=0.02):
        return (rs.standard_normal(shape) * std).astype(np.float32)

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out),
                "bias": np.zeros(n_out, np.float32)}

    def norm(n):
        return {"scale": np.ones(n, np.float32),
                "bias": np.zeros(n, np.float32)}

    h, p = ec.hidden_size, ec.patch_size
    tokens = (config.image_size // p) ** 2 + 1
    backbone = {"patch_embed": {"kernel": normal(p, p, 3, h)},
                "class_embedding": normal(h, std=h ** -0.5),
                "position_embeddings": normal(tokens, h),
                "pre_layernorm": norm(h), "post_layernorm": norm(h)}
    for i in range(ec.num_layers):
        backbone[f"layer_{i}"] = {
            "attention": {n: dense(h, h)
                          for n in ("query", "key", "value", "out")},
            "layer_norm1": norm(h), "layer_norm2": norm(h),
            "fc1": dense(h, h * ec.mlp_ratio),
            "fc2": dense(h * ec.mlp_ratio, h)}
    encoder = {"backbone": backbone}
    if h != ec.feature_dim:
        encoder["proj"] = dense(h, ec.feature_dim)

    H, P = dc.hidden_dim, dc.prefix_length
    gpt = {"wte": {"embedding": normal(mc.vocab_size, H)},
           "wpe": {"embedding": normal(dc.gpt2_n_positions, H)},
           "ln_f": norm(H)}
    for i in range(dc.num_layers):
        gpt[f"block_{i}"] = {
            "ln_1": norm(H), "ln_2": norm(H),
            "attn": {"c_attn": dense(H, 3 * H), "c_proj": dense(H, H)},
            "mlp": {"c_fc": dense(H, 4 * H), "c_proj": dense(4 * H, H)}}
    decoder = {"backbone": gpt,
               "image_to_prefix": dense(ec.feature_dim, P * H),
               "image_prefix": normal(1, P, H, std=1.0)}
    return {"params": {"encoder": encoder, "decoder": decoder}}


def _stacked(params: List[nn.Parameter]) -> torch.Tensor:
    """One contiguous [L, ...] tensor of the layers' parameters; each
    parameter becomes a view of its slice, so the weights exist once."""
    stacked = torch.stack([p.detach() for p in params])
    for i, p in enumerate(params):
        p.data = stacked[i]
    return stacked


def _stack(layers, get) -> Dict[str, torch.Tensor]:
    """The STACK_KEYS operands of ``layers``; ``get(layer)`` names each
    layer's (qkv, out, norm1, norm2, fc, proj) modules."""
    mods = [get(layer) for layer in layers]
    out = {}
    for i, (w, b) in enumerate((("wqkv", "bqkv"), ("wo", "bo"),
                                ("g1", "b1"), ("g2", "b2"),
                                ("wfc", "bfc"), ("wpj", "bpj"))):
        out[w] = _stacked([m[i].weight for m in mods])
        out[b] = _stacked([m[i].bias for m in mods])
    return out


def stack_layer_weights(model) -> None:
    """Set ``model.decoder.stack`` (GPT-2 blocks) and
    ``model.encoder.backbone.stack`` (CLIP layers): the layer-stacked
    weights of the whole-stack kernels, keyed as the JAX package's
    ``STACK_WEIGHT_KEYS``. Matrices keep the ``nn.Linear`` layout
    ``[L, out, in]``; the LayerNorm scales and biases (g1, b1, g2, b2) stay
    in their float32 dtype, as flax keeps them. Call after the dtype cast:
    every layer's parameters become views of the stacked tensors."""
    model.decoder.stack = _stack(
        model.decoder.backbone.blocks,
        lambda b: (b.attn.c_attn, b.attn.c_proj, b.ln_1, b.ln_2,
                   b.mlp.c_fc, b.mlp.c_proj))
    model.encoder.backbone.stack = _stack(
        model.encoder.backbone.layers,
        lambda m: (m.attention.qkv, m.attention.out, m.layer_norm1,
                   m.layer_norm2, m.fc1, m.fc2))
