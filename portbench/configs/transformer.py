"""What the harness needs of the Transformer family beside its file of
sizes (``transformer.json``): where each size sits in the program's
``Config``, the work of an image and of a decode step, and where the
program's decode state keeps an image's conditioning (each decoder
layer's cross-attention K/V of the memory), in the order
``reference/transformer.py``'s ``condition_kv`` gives it."""

from __future__ import annotations

import torch

from portbench.flops import vit_ops

# the program's Config attribute -> the file's key
PROGRAM = {
    "model.encoder.num_layers": "vision.num_layers",
    "model.encoder.hidden_size": "vision.hidden_size",
    "model.encoder.num_heads": "vision.num_heads",
    "model.encoder.mlp_ratio": "vision.mlp_ratio",
    "model.encoder.patch_size": "vision.patch_size",
    "model.encoder.encoder_type": "vision.kind",
    "image_size": "vision.image_size",
    "model.decoder.num_layers": "decoder.num_layers",
    "model.decoder.hidden_dim": "decoder.hidden_size",
    "model.decoder.num_heads": "decoder.num_heads",
    "model.vocab_size": "decoder.vocab_size",
    "model.decoder.max_length": "decoder.max_positions",
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


def _memory(cfg: dict) -> int:
    v = cfg["vision"]
    return (v["image_size"] // v["patch_size"]) ** 2


def vision_ops(cfg: dict) -> float:
    return vit_ops(cfg["vision"])


def condition_ops(cfg: dict) -> float:
    """Per image, the memory: its projection and each layer's
    cross-attention K/V over the S patch tokens."""
    d = cfg["decoder"]
    H, S = d["hidden_size"], _memory(cfg)
    return (2 * S * cfg["vision"]["hidden_size"] * H
            + d["num_layers"] * 2 * 2 * S * H * H)


def step_ops(cfg: dict, rows: int, pos: int) -> float:
    """One decode step at position ``pos`` over ``rows`` beam rows: per
    layer the self-attention's four projections, the cross-attention's
    query and output projections, the FFN (4H), attention over the
    ``pos + 1`` cached and the S memory positions; the output layer."""
    d = cfg["decoder"]
    H, V, S = d["hidden_size"], d["vocab_size"], _memory(cfg)
    layer = (2 * rows * (4 * H * H + 2 * H * H + 8 * H * H)
             + 4 * rows * (pos + 1) * H + 4 * rows * S * H)
    return d["num_layers"] * layer + 2 * rows * H * V


def program_condition(state: dict) -> torch.Tensor:
    """Each layer's memory K/V that ``init_cache`` left under
    ``shared["layers"]`` (keys pre-transposed, ``mem_k`` [B, H, S];
    ``mem_v`` [B, S, H]), per image [B, L * 2 * S * H]."""
    kv = torch.stack([torch.stack([s["mem_k"].transpose(1, 2), s["mem_v"]])
                      for s in state["shared"]["layers"]])  # [L, 2, B, S, H]
    return kv.permute(2, 0, 1, 3, 4).reshape(kv.shape[2], -1)
