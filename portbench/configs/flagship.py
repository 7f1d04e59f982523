"""What the harness needs of the flagship beside its file of sizes
(``flagship.json``): where each size sits in the program's ``Config``, the
work of an image and of a decode step, and where the program's decode
state keeps an image's conditioning (the prefix K/V of every GPT-2
layer), in the order ``reference/flagship.py``'s ``condition_kv`` gives
it."""

from __future__ import annotations

import torch

from portbench.flops import causal_keys, gpt2_layer_ops, vit_ops

# the program's Config attribute -> the file's key
PROGRAM = {
    "model.encoder.num_layers": "vision.num_layers",
    "model.encoder.hidden_size": "vision.hidden_size",
    "model.encoder.num_heads": "vision.num_heads",
    "model.encoder.mlp_ratio": "vision.mlp_ratio",
    "model.encoder.patch_size": "vision.patch_size",
    "model.encoder.encoder_type": "vision.kind",
    "image_size": "vision.image_size",
    "model.decoder.num_layers": "gpt2.num_layers",
    "model.decoder.hidden_dim": "gpt2.hidden_size",
    "model.decoder.num_heads": "gpt2.num_heads",
    "model.vocab_size": "gpt2.vocab_size",
    "model.decoder.prefix_length": "gpt2.prefix_length",
    "model.decoder.gpt2_n_positions": "gpt2.n_positions",
    "inference.beam_size": "decode.beam_size",
    "inference.max_length": "decode.max_length",
    "inference.length_penalty": "decode.length_penalty",
    "inference.min_length": "decode.min_length",
    "inference.decoding_strategy": "decode.strategy",
    "model.pad_token_id": "ids.pad",
    "model.bos_token_id": "ids.bos",
    "model.eos_token_id": "ids.eos",
    "model.dtype": "dtype",
}


def vision_ops(cfg: dict) -> float:
    return vit_ops(cfg["vision"])


def condition_ops(cfg: dict) -> float:
    """Per image, the prefix: the projection of the pooled feature and
    GPT-2's causal forward over the P prefix positions."""
    g = cfg["gpt2"]
    H, P = g["hidden_size"], g["prefix_length"]
    proj = 2 * cfg["vision"]["hidden_size"] * P * H
    return proj + g["num_layers"] * gpt2_layer_ops(H, P, causal_keys(0, P))


def step_ops(cfg: dict, rows: int, pos: int) -> float:
    """One decode step at suffix position ``pos`` (0 at BOS) over ``rows``
    beam rows, the tied LM head included."""
    g = cfg["gpt2"]
    H, P, V = g["hidden_size"], g["prefix_length"], g["vocab_size"]
    keys = rows * (P + pos + 1)
    return g["num_layers"] * gpt2_layer_ops(H, rows, keys) + 2 * rows * H * V


def train_ops(cfg: dict, images: int, caption_len: int) -> float:
    """A CE step over ``images`` captions of ``caption_len`` tokens: the
    teacher-forced forward (encode, prefix, GPT-2 over prefix and
    caption, LM head at the caption positions), times 3 for the backward.
    The optimizer is left out."""
    g = cfg["gpt2"]
    H, P, V = g["hidden_size"], g["prefix_length"], g["vocab_size"]
    T = caption_len
    fwd = (vit_ops(cfg["vision"]) + 2 * cfg["vision"]["hidden_size"] * P * H
           + g["num_layers"] * gpt2_layer_ops(H, P + T, causal_keys(0, P + T))
           + 2 * T * H * V)
    return 3 * images * fwd


def program_condition(state: dict) -> torch.Tensor:
    """The prefix K/V that ``init_cache`` left under ``shared``, per image
    [B, L * 2 * P * H] (layer, then K before V): layer-stacked ``pk``/
    ``pv`` [L, B, P, H] on the stack path, per layer otherwise."""
    shared = state["shared"]
    if "pk" in shared:
        kv = torch.stack([shared["pk"], shared["pv"]], 1)   # [L, 2, B, P, H]
    else:
        kv = torch.stack([torch.stack([s["pk"], s["pv"]])
                          for s in shared["layers"]])
    return kv.permute(2, 0, 1, 3, 4).reshape(kv.shape[2], -1)
