"""Operations and bytes of the work a cell asks for, counted from the
configuration's shapes, never from the kernels that happen to run: a later
change that replaces a kernel is held to the same work.

What a configuration's model does per image and per decode step is counted
by its own module, ``configs/<config>.py`` (``vision_ops``,
``condition_ops``, ``step_ops``, and ``train_ops`` where a cell trains it);
what one kernel call does, by the reader of its roofline
(``metrics/<kernel>_roofline.py``). Here are the peaks, the bound, and the
arithmetic of the layers they share.

A multiply-add is 2 operations. Attention counts its two products over
the keys each query sees (causal: the positions up to its own). Norms,
activations and softmax are left out of the operations (they are a small
share and belong to no product). Bytes count each input read once and
each output written once: bf16 weights and activations (2 bytes), f32
norm parameters (4).
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def peaks() -> Dict[str, float]:
    with open(PEAKS) as f:
        return json.load(f)


def bound_s(ops: float, nbytes: float, pk: Dict[str, float]) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the memory bandwidth."""
    return max(ops / pk["bf16_flops"], nbytes / pk["hbm_bytes_per_s"])


def config_module(cfg: dict):
    """The module that counts a configuration's work,
    ``portbench/configs/<name>.py``."""
    return importlib.import_module(f"portbench.configs.{cfg['name']}")


def causal_keys(q0: int, n: int) -> int:
    """Keys seen by queries at positions q0 .. q0+n-1 under a causal
    mask (position i sees i + 1 keys)."""
    return n * (q0 + 1) + n * (n - 1) // 2


def vit_ops(v: dict) -> float:
    """One image through a ViT-style tower: the patch embed and the
    layers over its patch tokens plus CLS."""
    H, L, p, size = (v["hidden_size"], v["num_layers"], v["patch_size"],
                     v["image_size"])
    n = (size // p) ** 2
    S = n + 1
    F = v["mlp_ratio"] * H
    embed = 2 * n * (p * p * 3) * H
    layer = 2 * S * (4 * H * H + 2 * H * F) + 4 * S * S * H
    return embed + L * layer


def gpt2_layer_ops(H: int, rows: int, keys: int) -> float:
    """``rows`` query rows through one GPT-2 layer, ``keys`` key positions
    seen in all."""
    return 2 * rows * 12 * H * H + 4 * keys * H


def serve_ops(cfg: dict, images: int, steps: int) -> float:
    """``images`` real images decoded with ``steps`` beam steps each:
    encode, conditioning, and every step over their K beam rows, as the
    configuration's module counts them."""
    m = config_module(cfg)
    K = cfg["decode"]["beam_size"]
    per = m.vision_ops(cfg) + m.condition_ops(cfg)
    return images * per + sum(m.step_ops(cfg, images * K, p)
                              for p in range(steps))


def train_ops(cfg: dict, images: int, caption_len: int) -> float:
    """A CE step over ``images`` captions of ``caption_len`` tokens, as
    the configuration's module counts it."""
    return config_module(cfg).train_ops(cfg, images, caption_len)
