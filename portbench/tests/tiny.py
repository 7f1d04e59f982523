"""Tiny configurations of the benchmark's two families for CPU tests: the
benchmark's configuration files with small widths, and the program's
``Config`` with the same sizes."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def load(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def tiny(name: str, width: int = 32, vocab: int = 300):
    """(benchmark config dict, the program's Config) at tiny widths."""
    from image_captioning_ml_project_tpu_torch.main import CONFIGS

    cfg = copy.deepcopy(load(name))
    c = CONFIGS[cfg["port_config"]]()
    v = cfg["vision"]
    v.update(num_layers=2, hidden_size=width, num_heads=4, image_size=64)
    ec = c.model.encoder
    ec.num_layers, ec.hidden_size, ec.num_heads = 2, width, 4
    ec.feature_dim = width
    c.image_size = 64
    dec = cfg.get("gpt2") or cfg["decoder"]
    dec.update(num_layers=2, hidden_size=width, num_heads=4,
               vocab_size=vocab)
    dc = c.model.decoder
    dc.num_layers, dc.hidden_dim, dc.num_heads = 2, width, 4
    c.model.vocab_size = vocab
    cfg["correct"] = {"sample": 8, "mismatch_sample": 8,
                      "condition_sample": 8, "serve": {"rank_gap_nats": 0.25},
                      "train": {}}
    return cfg, c
