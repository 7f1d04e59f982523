"""``main.train`` resolves the CLIP reranker of validation as the JAX
CLI's ``train`` does: with ``use_clip_reranking`` and an injected reranker
it hands the reranker to the trainer, whose validation then decodes beam
candidates and scores the reranker's picks; without the flag the injected
reranker is dropped and training runs as before."""

import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu_torch import main as port_main
from image_captioning_ml_project_tpu_torch.train import (
    trainer as trainer_mod)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from torch_port_helpers import coco_fixture, port_config, train_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return coco_fixture(str(tmp_path_factory.mktemp("coco")))


class _Reranker:
    """Stands in for a CLIPReranker: keeps the candidates it was given and
    picks each image's last one."""

    def __init__(self):
        self.picks = []
        self.shapes = []

    def __call__(self, images, candidates):
        cands = np.asarray(candidates)
        self.shapes.append(cands.shape)
        self.picks.append(cands[:, -1])
        return cands[:, -1]


def _config(data, tmp_path, rerank):
    root, vocab = data
    cfg = port_config(train_config("vit_lstm", root, vocab, tmp_path))
    cfg.training.num_epochs = 1
    cfg.inference.use_clip_reranking = rerank
    return cfg, PortVocab(dict(vocab.word2idx))


def test_train_passes_the_reranker_to_the_trainer(data, tmp_path,
                                                  monkeypatch):
    """Validation hands the reranker [B, num_candidates, L] candidates,
    and the captions it scores are the reranker's picks."""
    cfg, vocab = _config(data, tmp_path, rerank=True)
    scored = []
    real = trainer_mod.calculate_metrics

    def recording(generated, references, image_ids):
        scored.append(list(generated))
        return real(generated, references, image_ids)

    monkeypatch.setattr(trainer_mod, "calculate_metrics", recording)
    reranker = _Reranker()
    trainer = port_main.train(cfg, tokenizer=vocab, device="cpu",
                              reranker=reranker)
    assert trainer.reranker is reranker and trainer.step == 6
    nc, L = cfg.inference.num_candidates, cfg.inference.max_length
    assert {s[1:] for s in reranker.shapes} == {(nc, L)}
    n = len(trainer.val_dataset)
    picks = np.concatenate(reranker.picks)[:n]  # the padding rows last
    assert scored == [[vocab.decode(t, skip_special_tokens=True)
                       for t in picks]]
    assert trainer.history[0]["val_metrics"]["CIDEr"] >= 0


def test_train_without_the_flag_trains_as_before(data, tmp_path):
    cfg, vocab = _config(data, tmp_path, rerank=False)
    trainer = port_main.train(cfg, tokenizer=vocab, device="cpu",
                              reranker=_Reranker())
    assert trainer.step == 6
    assert [row["scst"] for row in trainer.history] == [False]
    assert trainer.history[0]["val_metrics"]["CIDEr"] > 0
