"""What the benchmark takes from the program under test: its configuration
builders, its model's state-dict names, its caption service and its
trainer. Nothing else in the harness imports the program, and the
references import nothing of it.

The weights are drawn here, on the device, from the seed, under the
program's state-dict names, in the dtype they are served in; the
reference reads the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _attr(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return getattr(obj, "value", obj)      # an enum by its value


def _key(cfg: dict, path: str):
    for part in path.split("."):
        cfg = cfg[part]
    return cfg


def file_value(cfg: dict, attr: str):
    """The file's value of the program's ``Config`` attribute ``attr``
    (``model.vocab_size``), where the configuration's module says the
    file keeps it."""
    from .flops import config_module

    return _key(cfg, config_module(cfg).PROGRAM[attr])


def port_config(cfg: dict):
    """The program's ``Config`` for a benchmark configuration file: the
    builder it names (``main.CONFIGS``), checked against every size the
    file states, where the configuration's module
    (``configs/<config>.py``, ``PROGRAM``) says the program keeps it, so
    the file is the configuration as it runs."""
    from image_captioning_ml_project_tpu_torch.main import CONFIGS

    from .flops import config_module

    c = CONFIGS[cfg["port_config"]]()
    wrong = {attr: (_attr(c, attr), _key(cfg, key))
             for attr, key in config_module(cfg).PROGRAM.items()
             if _attr(c, attr) != _key(cfg, key)}
    if wrong:
        raise ValueError(f"{cfg['name']}: the program's configuration "
                         f"differs from the file (program, file): {wrong}")
    return c


def _std(name: str, shape, width: int) -> float:
    """The seeded weights' law, by name: what the program's own seeded
    weights use (GPT-2's N(0, 0.02^2)), with the CLS vectors at 1/width
    and the GPT-2 image prefix at N(0, 1); 0 marks a zero (biases) and
    -1 a one (norm scales, the only one-dimensional ``.weight``)."""
    if name.endswith(".bias"):
        return 0.0
    if name.endswith(".weight") and len(shape) == 1:
        return -1.0
    if name.endswith(("class_embedding", "cls_token")):
        return width ** -0.5
    if name.endswith("image_prefix"):
        return 1.0
    return 0.02


def draw_state(config, seed: int, device, dtype=torch.bfloat16
               ) -> Dict[str, torch.Tensor]:
    """Every tensor of the program's model state dict, drawn on
    ``device`` from ``seed`` in one call of the generator and cut into
    the program's names."""
    from image_captioning_ml_project_tpu_torch.models.captioning_model \
        import ImageCaptioningModel

    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  ImageCaptioningModel(config).state_dict().items()}
    width = config.model.encoder.hidden_size
    total = sum(math.prod(s) for k, s in shapes.items()
                if _std(k, s, width) > 0)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    state, at = {}, 0
    for name, shape in shapes.items():
        std = _std(name, shape, width)
        if std == 0.0:
            state[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif std < 0:
            state[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            n = math.prod(shape)
            state[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
    return state


class IdTokenizer:
    """Token ids as text: each id's word is its decimal string. The BOS
    that starts every row is dropped and the text ends at the first EOS,
    so the served text gives back every served id (a model may emit the
    pad or BOS id as a word; it is kept)."""

    def __init__(self, vocab_size: int, bos: int, eos: int):
        self.words = [str(i) for i in range(vocab_size)]
        self.bos, self.eos = bos, eos

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        words = []
        for j, i in enumerate(ids):
            i = int(i)
            if i == self.eos:
                break
            if j:
                words.append(self.words[i])
        return " ".join(words)

    def ids(self, text: str, length: int, pad: int):
        """The served tokens of a caption: BOS, the words, EOS if the
        caption ended before ``length``, pads after."""
        out = [self.bos] + [int(w) for w in text.split()]
        if len(out) < length:
            out.append(self.eos)
        return out + [pad] * (length - len(out))


def caption_service(config, state, tokenizer, device, serve: dict):
    """The program's ``CaptionService`` on the seeded ``state`` (read in
    place of a checkpoint's weights)."""
    from image_captioning_ml_project_tpu_torch.inference.server import \
        CaptionService
    from image_captioning_ml_project_tpu_torch.models.captioning_model \
        import load_model

    class SeededService(CaptionService):
        def _load_checkpoint(self, name):
            return load_model(self.config, self.device, state_dict=state)

    return SeededService(config, tokenizer, device, checkpoint_path="seeded",
                         batch_size=serve["batch_size"],
                         max_wait_ms=serve["max_wait_ms"],
                         bucket_sizes=serve["bucket_sizes"],
                         pipeline_depth=serve["pipeline_depth"])
