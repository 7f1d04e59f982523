"""``main.train`` resolves the CLIP reranker of validation as the JAX
CLI's ``train`` does: with ``use_clip_reranking`` and an injected reranker
it hands the reranker to the trainer, which raises its "not yet ported"
error for reranked validation (rather than validating on the plain decode
without a word); without the flag the injected reranker is dropped and
training runs as before."""

import pytest
import torch

from image_captioning_ml_project_tpu_torch import main as port_main
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from torch_port_helpers import coco_fixture, port_config, train_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return coco_fixture(str(tmp_path_factory.mktemp("coco")))


class _Reranker:
    """Stands in for a CLIPReranker: main.train only passes it on."""


def _config(data, tmp_path, rerank):
    root, vocab = data
    cfg = port_config(train_config("vit_lstm", root, vocab, tmp_path))
    cfg.training.num_epochs = 1
    cfg.inference.use_clip_reranking = rerank
    return cfg, PortVocab(dict(vocab.word2idx))


def test_train_passes_the_reranker_to_the_trainer(data, tmp_path):
    cfg, vocab = _config(data, tmp_path, rerank=True)
    with pytest.raises(NotImplementedError, match="CLIP reranking in "
                                                  "validation.*item 12"):
        port_main.train(cfg, tokenizer=vocab, device="cpu",
                        reranker=_Reranker())


def test_train_without_the_flag_trains_as_before(data, tmp_path):
    cfg, vocab = _config(data, tmp_path, rerank=False)
    trainer = port_main.train(cfg, tokenizer=vocab, device="cpu",
                              reranker=_Reranker())
    assert trainer.step == 6
    assert [row["scst"] for row in trainer.history] == [False]
    assert trainer.history[0]["val_metrics"]["CIDEr"] > 0
