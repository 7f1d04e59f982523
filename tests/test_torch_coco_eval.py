"""The port's ``evaluate_model_on_coco`` (``evaluate/coco_eval.py``)
against the JAX package's, on the CPU: an injected ``decode_batch_fn``
gives both packages the same tokens for each image (a seeded function of
its image id, so batching cannot change them), and the two write an
identical ``results.json`` (every validation image once, the padding of
the last batch left out) and return equal metrics. The port's decode
function may return a tensor. With an annotation file but no
pycocotools, both score with the loader's references."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.data.coco import (
    build_coco_datasets as jax_datasets)
from image_captioning_ml_project_tpu.evaluate import coco_eval as jax_eval
from image_captioning_ml_project_tpu_torch.data.coco import (
    build_coco_datasets)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.evaluate import coco_eval
from torch_port_helpers import coco_fixture, port_config, train_config

L = 9


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coco")
    root, vocab = coco_fixture(str(tmp))
    cfg = train_config("vit_lstm", root, vocab, tmp)
    _, jval = jax_datasets(cfg, vocab)
    port_vocab = PortVocab(dict(vocab.word2idx))
    _, pval = build_coco_datasets(port_config(cfg), port_vocab)
    return vocab, port_vocab, jval, pval


def _tokens(batch, vocab):
    """Seeded tokens per image: BOS, words, EOS at a seeded place (or
    none), padding after."""
    out = np.full((len(batch["image_id"]), L), vocab.pad_token_id, np.int32)
    for i, iid in enumerate(np.asarray(batch["image_id"]).tolist()):
        rs = np.random.RandomState(int(iid))
        n = rs.randint(1, L)
        out[i, 0] = vocab.bos_token_id
        out[i, 1:n] = rs.randint(4, len(vocab), n - 1)
        if rs.rand() < 0.8:
            out[i, n] = vocab.eos_token_id
    return out


@pytest.mark.parametrize("batch_size", [1, 3, 8])
def test_results_and_metrics_are_jax(setup, tmp_path, batch_size):
    vocab, port_vocab, jval, pval = setup
    files = {k: str(tmp_path / k / "results.json") for k in ("jax", "port")}
    want = jax_eval.evaluate_model_on_coco(
        lambda b: _tokens(b, vocab), jval, vocab, batch_size=batch_size,
        results_file=files["jax"])
    got = coco_eval.evaluate_model_on_coco(
        lambda b: torch.from_numpy(_tokens(b, port_vocab)), pval,
        port_vocab, batch_size=batch_size, results_file=files["port"])
    assert got == want
    results = {}
    for k, path in files.items():
        with open(path) as f:
            results[k] = json.load(f)
    assert results["port"] == results["jax"]
    assert sorted(r["image_id"] for r in results["port"]) == sorted(
        ex["image_id"] for ex in pval.examples)


def test_annotation_file_without_pycocotools_keeps_loader_refs(setup,
                                                                tmp_path):
    vocab, port_vocab, jval, pval = setup
    ann = os.path.join(pval.root_dir, "annotations/captions_val2014.json")
    want = jax_eval.evaluate_model_on_coco(
        lambda b: _tokens(b, vocab), jval, vocab, batch_size=4,
        results_file=str(tmp_path / "jax.json"), annotation_file=ann)
    got = coco_eval.evaluate_model_on_coco(
        lambda b: _tokens(b, port_vocab), pval, port_vocab, batch_size=4,
        results_file=str(tmp_path / "port.json"), annotation_file=ann)
    assert got == want
    if importlib.util.find_spec("pycocotools") is None:
        assert got == coco_eval.evaluate_model_on_coco(
            lambda b: _tokens(b, port_vocab), pval, port_vocab,
            batch_size=4, results_file=str(tmp_path / "port2.json"))
