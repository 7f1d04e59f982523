"""``main.train`` resolves the CLIP reranker of validation as the JAX
CLI's ``train`` does: with ``use_clip_reranking`` and an injected reranker
it hands the reranker to the trainer, whose validation then decodes beam
candidates and scores the reranker's picks; without the flag the injected
reranker is dropped and training runs as before. And the two CLIs make
the same ``Config`` of one command line, ``--use_rl``,
``--device_resize``, ``--fold_normalize``, ``--native_draft`` and
``--native_threads`` included; in the object-region mode ``main.train``
reads detector features and never resolves a reranker."""

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


@pytest.mark.parametrize("argv", [
    [],
    ["--use_rl", "--device_resize", "--fold_normalize", "--native_draft",
     "--native_threads", "3", "--native_loader"],
    ["--native_threads", "0", "--encoder_type", "swin", "--batch_size", "8",
     "--save_every_steps", "0"]], ids=["none", "five", "others"])
def test_cli_flags_make_the_jax_config(argv):
    from image_captioning_ml_project_tpu import main as jax_main
    from image_captioning_ml_project_tpu.config import (
        config_to_dict, get_default_config)
    from image_captioning_ml_project_tpu_torch.config import (
        config_to_dict as port_to_dict)

    want, got = get_default_config(), port_main.resolve_config(None)
    jax_main._update_config_from_args(
        want, jax_main.build_argparser().parse_args(argv))
    port_main._update_config_from_args(
        got, port_main.build_argparser().parse_args(argv))
    assert port_to_dict(got) == config_to_dict(want)
    if "--use_rl" in argv:
        assert got.training.use_rl and got.device_resize \
            and got.fold_normalize and got.native_draft \
            and got.native_threads == 3


def test_object_mode_trains_on_detector_features(data, tmp_path,
                                                 monkeypatch):
    """``main.train`` in the object-region mode (``use_object_features``
    on a ViT configuration) builds ``build_object_datasets``' sets and,
    as the JAX CLI's ``train``, resolves no reranker: an injected one
    reaches the trainer, whose validation never calls it (no pixels)."""
    from image_captioning_ml_project_tpu_torch.data.synthetic import (
        make_synthetic_object_features)

    root, vocab = data
    for split in ("train", "val"):
        make_synthetic_object_features(
            str(tmp_path / "features"),
            f"{root}/annotations/captions_{split}2014.json", max_objects=4,
            feature_dim=12, seed=1)
    cfg, port_vocab = _config(data, tmp_path, rerank=True)
    cfg.data_root, cfg.features_dir = root, str(tmp_path / "features")
    cfg.model.encoder.use_object_features = True
    cfg.model.encoder.max_objects = 4
    cfg.model.encoder.region_feature_dim = 12
    seen = {}
    real = trainer_mod.CaptioningTrainer.__init__

    def init(self, config, train_ds, val_ds, *args, **kw):
        seen.update(train=train_ds, reranker=kw.get("reranker"))
        real(self, config, train_ds, val_ds, *args, **kw)

    monkeypatch.setattr(trainer_mod.CaptioningTrainer, "__init__", init)
    reranker = _Reranker()
    trainer = port_main.train(cfg, tokenizer=port_vocab, device="cpu",
                              reranker=reranker)
    assert type(seen["train"]).__name__ == "ObjectDetectionFeaturesDataset"
    assert trainer._object_mode and not reranker.picks
    assert trainer.history[0]["val_metrics"]
    assert trainer.step == len(seen["train"]) // cfg.training.batch_size
