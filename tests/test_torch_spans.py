"""The spans the port records at its layer boundaries (utils/profiling.py's
recorder), on the CPU at tiny sizes:

* a ``CaptionService`` (the server tests' tiny CLIP + GPT-2) records each
  batch as ``serve.batch`` with ``serve.wait``, ``serve.fill``,
  ``serve.stack``, ``serve.upload``, ``serve.decode`` and
  ``serve.handoff`` children in that order on the batcher thread, the
  batch's rows, bucket and one enqueue time a real row (a wait that
  timed out: a batch span with no rows, the wait its one child); the completer's ``serve.fetch_tokens`` and
  ``serve.detokenize`` name the batch's span as parent; the decode
  engine's ``decode.encode`` and ``decode.step`` sit under
  ``serve.decode``, one ``decode.stop_check`` under each step; the
  captions are those of a direct decode;
* a CE ``train_step`` fed through ``prefetch`` records ``train.step``
  with ``train.inputs``, ``train.forward``, ``train.backward`` and
  ``train.optimizer`` children, and ``data.wait`` and ``data.upload``
  (the producer's thread), each once a step; its outputs and weights are
  bit-identical with the recorder on and off."""

import threading
from collections import Counter

import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu_torch.data.pipeline import prefetch
from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    beam_search)
from image_captioning_ml_project_tpu_torch.inference.server import (
    CaptionService)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from image_captioning_ml_project_tpu_torch.train.trainer import (
    CaptioningTrainer)
from image_captioning_ml_project_tpu_torch.utils import profiling
from torch_port_helpers import images_uint8, port_config, tiny_config

torch.set_num_threads(1)

VOCAB = 1000
BATCHER = ("serve.wait", "serve.fill", "serve.stack", "serve.upload",
           "serve.decode", "serve.handoff")
TRAIN = ("train.inputs", "train.forward", "train.backward",
         "train.optimizer")


@pytest.fixture
def recorder():
    profiling.records()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.records()


def _vocab():
    words = {w: i for i, w in enumerate(WordVocab.specials)}
    words.update({f"w{i}": i for i in range(len(words), VOCAB)})
    return WordVocab(words)


def _direct_captions(cfg, tok, images):
    model = load_model(cfg, "cpu")
    mc, ic = cfg.model, cfg.inference
    with torch.inference_mode():
        state = model.init_cache(torch.from_numpy(images), ic.max_length)
        tokens = beam_search(model.step, state, len(images), ic.beam_size,
                             mc.bos_token_id, mc.eos_token_id,
                             mc.pad_token_id, ic.max_length,
                             length_penalty=ic.length_penalty,
                             min_length=ic.min_length).tokens
    return [tok.decode(t, skip_special_tokens=True) for t in tokens.numpy()]


def _children(recs, parent):
    return sorted((r for r in recs if r.parent == parent),
                  key=lambda r: r.start_ns)


def test_a_served_batch_is_recorded_on_both_threads(recorder):
    cfg = tiny_config(vocab=VOCAB)
    cfg.seed = 7
    tok = _vocab()
    service = CaptionService(cfg, tok, "cpu", batch_size=4,
                             bucket_sizes=[1, 2], max_wait_ms=30.0)
    images = images_uint8(13, n=5)
    service.start(warmup=False)
    try:
        captions = [service.result(r) for r in
                    [service.submit_async(img) for img in images]]
    finally:
        service.stop()
    assert captions == _direct_captions(cfg, tok, images)
    recs = recorder.records()
    batches = [r for r in recs if r.name == "serve.batch" and r.attrs]
    assert sum(b.attrs["rows"] for b in batches) == len(images)
    for b in batches:
        assert len(b.attrs["t_enqueue"]) == b.attrs["rows"]
        assert b.attrs["bucket"] == min(
            s for s in service.bucket_sizes if s >= b.attrs["rows"])
        mine = [r for r in _children(recs, b.id) if r.thread == b.thread]
        assert [r.name for r in mine] == list(BATCHER)
        assert all(b.start_ns <= r.start_ns <= r.end_ns <= b.end_ns
                   for r in mine)
        decode = mine[4]
        assert max(b.attrs["t_enqueue"]) * 1e9 < decode.start_ns
        done = [r for r in _children(recs, b.id) if r.thread != b.thread]
        assert [r.name for r in done] == ["serve.fetch_tokens",
                                          "serve.detokenize"]
        inside = _children(recs, decode.id)
        assert inside[0].name == "decode.encode"
        steps = inside[1:]
        assert steps and {r.name for r in steps} == {"decode.step"}
        for step in steps:
            (check,) = _children(recs, step.id)
            assert check.name == "decode.stop_check"
            assert [r.name for r in _children(recs, check.id)] == [
                "decode.host_syncs"]
    # the batcher's waits that timed out: a batch span around the wait
    idle = [r for r in recs if r.name == "serve.batch" and not r.attrs]
    for b in idle:
        assert [r.name for r in _children(recs, b.id)] == ["serve.wait"]


def _trainer(tmp_path):
    cfg = port_config(tiny_config(vocab=VOCAB))
    cfg.output_dir = str(tmp_path / "out")
    cfg.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.training.batch_size = 4
    return CaptioningTrainer(cfg, [None] * 8, None, None, device="cpu")


def _batches(n=2, rows=4, length=8):
    rng = np.random.default_rng(5)
    out = []
    for k in range(n):
        caps = rng.integers(4, VOCAB, size=(rows, length))
        caps[:, 0] = 1
        mask = (np.arange(length)[None, :]
                < rng.integers(3, length + 1, size=(rows, 1)))
        out.append({"image": images_uint8(30 + k, n=rows),
                    "caption_tokens": caps.astype(np.int64),
                    "attention_mask": mask.astype(np.int64)})
    return out


def _train(trainer, batches):
    stream = prefetch(iter(batches), "cpu")
    out = []
    for _ in batches:
        b = next(stream)
        out.append({k: v.detach().clone() for k, v in trainer.train_step(
            b["image"], b["caption_tokens"], b["attention_mask"]).items()})
    stream.close()
    return out


def test_train_step_spans_and_bit_identical_outputs(tmp_path):
    batches = _batches()
    off = _trainer(tmp_path / "off")
    profiling.records()
    want = _train(off, batches)
    assert profiling.records() == []
    on = _trainer(tmp_path / "on")
    profiling.enable()
    try:
        got = _train(on, batches)
    finally:
        profiling.disable()
    recs = profiling.records()
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            assert torch.equal(w[k], g[k]), k
    on_params = dict(on.model.named_parameters())
    for name, p in off.model.named_parameters():
        assert torch.equal(p, on_params[name]), name
    names = Counter(r.name for r in recs)
    for name in ("train.step", "data.wait", "data.upload") + TRAIN:
        assert names[name] == len(batches), name
    main = threading.get_native_id()
    for s in (r for r in recs if r.name == "train.step"):
        assert [r.name for r in _children(recs, s.id)] == list(TRAIN)
        assert s.thread == main
    assert {r.thread for r in recs if r.name == "data.wait"} == {main}
    assert main not in {r.thread for r in recs if r.name == "data.upload"}
