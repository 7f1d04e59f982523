"""Serving (port: inference/server.py) and the CLI (port: main.py) on the
CPU: concurrent submits over a bucket ladder give the captions of a direct
``beam_search`` decode, the HTTP front end answers ``/caption`` for a PNG
and its GET routes, and what is not yet ported says so."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu_torch import main as port_main
from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    beam_search)
from image_captioning_ml_project_tpu_torch.inference.server import (
    CaptionService, ServerStats, make_http_server)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from torch_port_helpers import IMAGE_SIZE, images_uint8, tiny_config

torch.set_num_threads(1)

VOCAB = 1000


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


@pytest.fixture(scope="module")
def served():
    cfg = tiny_config(vocab=VOCAB)
    cfg.seed = 7
    tok = _vocab()
    service = CaptionService(cfg, tok, "cpu", batch_size=4,
                             bucket_sizes=[1, 2], max_wait_ms=30.0)
    service.start(warmup=True)
    httpd = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield cfg, tok, service, url
    httpd.shutdown()
    httpd.server_close()
    service.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_concurrent_submits_match_direct_decode(served):
    cfg, tok, service, _ = served
    images = images_uint8(11, n=7)
    want = _direct_captions(cfg, tok, images)
    assert service.bucket_sizes == [1, 2, 4]
    got = [None] * len(images)

    def client(i):
        got[i] = service.submit(images[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert got == want
    # open-loop handles, and every bucket gives the same captions
    reqs = [service.submit_async(img) for img in images[:3]]
    assert [service.result(r) for r in reqs] == want[:3]
    assert service._run_images(list(images[:1])) == want[:1]
    snap = service.stats.snapshot()
    assert snap["completed"] >= 10 and snap["errors"] == 0
    assert snap["decode_steps"] > 0


def test_http_caption_png_and_get_routes(served):
    from PIL import Image

    cfg, tok, service, url = served
    img = images_uint8(12, n=1)[0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    req = urllib.request.Request(f"{url}/caption", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        reply = json.loads(r.read())
    assert reply["caption"] == _direct_captions(cfg, tok, img[None])[0]
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["encoder"] == "clip"
    assert health["decoder"] == "gpt2" and health["device"] == "cpu"
    with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
        assert json.loads(r.read())["completed"] >= 1
    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
        assert "ict_decode_steps_total" in r.read().decode()
    for path, code in (("/reload", 501), ("/nope", 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                f"{url}{path}", data=b"{}", method="POST"), timeout=30)
        assert e.value.code == code


def test_submit_rejects_malformed_images(served):
    service = served[2]
    with pytest.raises(ValueError, match="preprocessed"):
        service.submit_async(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        service.submit_async(np.zeros((IMAGE_SIZE, IMAGE_SIZE, 3),
                                      np.float32))


@pytest.mark.parametrize("change", [
    lambda c: setattr(c.inference, "decoding_strategy", "greedy"),
    lambda c: setattr(c.inference, "use_clip_reranking", True),
    lambda c: setattr(c.inference, "num_beam_groups", 2),
])
def test_unported_service_options_raise(change):
    cfg = tiny_config()
    change(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CaptionService(cfg, _vocab(), "cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        CaptionService(tiny_config(), _vocab(), "cpu",
                       checkpoint_path="best_model")


def test_stats_percentiles_are_nearest_rank():
    stats = ServerStats()
    for ms in (10, 20, 30, 40):
        stats.record_done(ms / 1e3)
    assert stats.snapshot()["latency_ms"]["p50"] == 20.0


def test_cli_serves_only_and_needs_a_device():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port_main.main(["--mode", "train"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            port_main.main(["--mode", "serve"])


def test_cli_tokenizer_and_flagship_config(tmp_path):
    cfg = port_main.flagship_config()
    assert (cfg.model.encoder.hidden_size, cfg.model.encoder.num_layers,
            cfg.model.encoder.patch_size) == (768, 12, 32)
    assert (cfg.model.decoder.hidden_dim, cfg.model.decoder.num_layers,
            cfg.model.decoder.num_heads, cfg.model.vocab_size) == (
                768, 12, 12, 50257)
    assert (cfg.inference.beam_size, cfg.inference.max_length) == (5, 20)
    path = tmp_path / "vocab.json"
    _vocab().save(str(path))
    tok = port_main.setup_tokenizer(cfg, str(path))
    assert cfg.model.vocab_size == len(tok) == VOCAB
    assert (cfg.model.pad_token_id, cfg.model.bos_token_id,
            cfg.model.eos_token_id) == (0, 1, 2)
