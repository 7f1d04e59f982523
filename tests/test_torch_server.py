"""Serving (port: inference/server.py) and the CLI (port: main.py) on the
CPU: concurrent submits over a bucket ladder give the captions of a direct
``beam_search`` decode (CLIP + GPT-2, ViT + Transformer decoder, ViT +
Q-Former and Swin with it, and ResNet + LSTM with soft attention through
its kernel switch); greedy,
nucleus, diverse-beam and CLIP-reranked serving give the captions of a
direct ``decode()`` / ``rerank_candidates``, and two services of one seed
the same nucleus captions; the CLI serves a JSON config's decoding
options; the HTTP front end answers ``/caption`` for a PNG and its GET
routes, the built-in configurations have their widths; a service built
from a trainer checkpoint serves its weights, and ``reload_checkpoint``
(and ``POST /reload``) swaps another checkpoint in under concurrent
requests, every one answered, the captions after it those of a fresh
service on that checkpoint."""

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
from image_captioning_ml_project_tpu_torch.inference import server
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    beam_search, decode)
from image_captioning_ml_project_tpu_torch.inference.reranking import (
    CLIPReranker, rerank_candidates)
from image_captioning_ml_project_tpu_torch.inference.server import (
    CaptionService, ServerStats, make_http_server)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from image_captioning_ml_project_tpu_torch.models.clip_text import CLIPScorer
from image_captioning_ml_project_tpu_torch.params import load_scorer
from torch_port_helpers import (IMAGE_SIZE, family_config, family_inputs,
                                images_uint8, tiny_config)

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
    # a reload that names no checkpoint is refused; the service goes on
    for path, code in (("/reload", 500), ("/nope", 404)):
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


def _write_checkpoint(cfg, directory, seed, name="best_model"):
    """A trainer-format checkpoint of seeded weights under ``directory``
    (params, BatchNorm statistics, an optimizer file that a reload must
    not read, the step)."""
    from image_captioning_ml_project_tpu_torch.models.captioning_model import (
        build_train_model)
    from image_captioning_ml_project_tpu_torch.params import init_flax_params
    from image_captioning_ml_project_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    model = build_train_model(cfg, "cpu", params=init_flax_params(cfg, seed))
    state = {"params": {"model": {n: p.detach() for n, p in
                                  model.named_parameters()}, "loss": {}},
             "batch_stats": {n: b for n, b in model.named_buffers()},
             "opt_state": {"count": 0, "mu": {}, "nu": {}}, "step": 0}
    CheckpointManager(directory).save(name, state)
    return {**state["params"]["model"], **state["batch_stats"]}


def _checkpoint_config(tmp_path, **kw):
    cfg = tiny_config(vocab=VOCAB, **kw)
    cfg.seed = 7
    cfg.checkpoint_dir = str(tmp_path / "ckpt")
    return cfg


@pytest.mark.parametrize("family", [dict(), dict(encoder="resnet",
                                                 decoder="lstm",
                                                 attention="soft")],
                         ids=["clip-gpt2", "resnet-lstm"])
def test_service_serves_a_trainer_checkpoint(family, tmp_path):
    cfg = _checkpoint_config(tmp_path, **family)
    tok = _vocab()
    state = _write_checkpoint(cfg, cfg.checkpoint_dir, seed=11)
    images = images_uint8(21, n=3)
    service = CaptionService(cfg, tok, "cpu", checkpoint_path="best_model",
                             batch_size=4, bucket_sizes=[4])
    for name, t in load_model(cfg, "cpu", state_dict=state).state_dict(
            ).items():
        assert torch.equal(service.model.state_dict()[name], t), name
    service.start(warmup=False)
    try:
        got = [service.submit(img) for img in images]
    finally:
        service.stop()
    seeded = _direct_captions(cfg, tok, images)
    assert got != seeded  # the checkpoint's weights, not the seed's
    with pytest.raises(ValueError, match="not both"):
        CaptionService(cfg, tok, "cpu", checkpoint_path="best_model",
                       params={})


def test_reload_under_concurrent_requests(tmp_path):
    cfg = _checkpoint_config(tmp_path)
    tok = _vocab()
    _write_checkpoint(cfg, cfg.checkpoint_dir, seed=12, name="next")
    images = images_uint8(22, n=6)
    service = CaptionService(cfg, tok, "cpu", batch_size=4,
                             bucket_sizes=[1, 4], max_wait_ms=5.0)
    service.start(warmup=False)
    before = [service.submit(img) for img in images]
    answered, failed = [], []
    stop = threading.Event()

    def client(k):
        while not stop.is_set():
            try:
                service.submit(images[k % len(images)])
                answered.append(k)
            except Exception as e:
                failed.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    try:
        while len(answered) < 8:
            threading.Event().wait(0.01)
        result = service.reload_checkpoint("next")
        n = len(answered)
        while len(answered) < n + 8:
            threading.Event().wait(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    after = [service.submit(img) for img in images]
    service.stop()
    assert not failed and not any(t.is_alive() for t in threads)
    assert set(result) == {"reloaded", "seconds"}
    assert result["reloaded"] == "next" and result["seconds"] >= 0
    fresh = CaptionService(cfg, tok, "cpu", checkpoint_path="next",
                           batch_size=4, bucket_sizes=[1, 4])
    fresh.start(warmup=False)
    try:
        assert after == [fresh.submit(img) for img in images]
    finally:
        fresh.stop()
    assert after != before


def test_http_reload(tmp_path):
    cfg = _checkpoint_config(tmp_path)
    tok = _vocab()
    _write_checkpoint(cfg, cfg.checkpoint_dir, seed=13, name="next")
    service = CaptionService(cfg, tok, "cpu", batch_size=2,
                             bucket_sizes=[2])
    service.start(warmup=False)
    httpd = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/reload"
    try:
        req = urllib.request.Request(
            url, data=json.dumps({"checkpoint": "next"}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            reply = json.loads(r.read())
        assert reply["reloaded"] == "next" and reply["seconds"] >= 0
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                url, data=json.dumps({"checkpoint": "missing"}).encode(),
                method="POST"), timeout=30)
        assert e.value.code == 500
        assert "no checkpoint" in json.loads(e.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()
        thread.join(timeout=10)


def _word_hash_clip_ids(texts):
    """A deterministic CLIP tokenizer for the tests: SOT 98, one id in
    [3, 97] per word, EOT 99, zero padding to 16 positions."""
    out = np.zeros((len(texts), 16), np.int32)
    for r, text in enumerate(texts):
        words = [3 + sum(map(ord, w)) * 7919 % 95 for w in text.split()]
        row = [98] + words[:14] + [99]
        out[r, :len(row)] = row
    return out


def _reranker(tok):
    """A CLIP reranker on seeded random weights (vision width 32 on 24x24
    images, text width 32, vocabulary 100): the served 32x32 images are
    resized to 24."""
    torch.manual_seed(0)
    scorer = CLIPScorer(vision_hidden=32, vision_layers=2, vision_heads=4,
                        patch_size=8, image_size=24, text_vocab=100,
                        text_hidden=32, text_layers=2, text_heads=4,
                        text_eos_token_id=99, text_max_positions=16,
                        projection_dim=16)
    with torch.no_grad():
        for p in scorer.parameters():
            if p.dim():  # logit_scale keeps CLIP's initial value
                p.normal_(0.0, 0.2)
    scorer = load_scorer(scorer, scorer.state_dict(), "cpu")
    return CLIPReranker(scorer, _word_hash_clip_ids,
                        lambda ids: tok.decode(ids, skip_special_tokens=True),
                        image_size=24)


_OPTIONS = {
    "greedy": dict(decoding_strategy="greedy"),
    "nucleus": dict(decoding_strategy="nucleus", top_p=0.9,
                    temperature=0.8),
    "diverse": dict(beam_size=6, num_beam_groups=3, diversity_penalty=0.5),
    "rerank": dict(num_beam_groups=1, num_candidates=3),
}


def _options_config(option):
    cfg = tiny_config(vocab=VOCAB)
    cfg.seed = 9
    for k, v in _OPTIONS[option].items():
        setattr(cfg.inference, k, v)
    return cfg


def _direct(cfg, tok, images, reranker=None):
    """The captions of one direct decode of ``images`` as one batch: the
    configured strategy (nucleus from a generator seeded as the service
    seeds its own), or with ``reranker`` its pick among the beam
    candidates."""
    model = load_model(cfg, "cpu")
    mc, ic = cfg.model, cfg.inference
    ids = (mc.bos_token_id, mc.eos_token_id, mc.pad_token_id)
    x = torch.from_numpy(images)
    with torch.inference_mode():
        state = model.init_cache(x, ic.max_length)
        if reranker is None:
            tokens = decode(model.step, state, len(images), ic, *ids,
                            generator=torch.Generator().manual_seed(
                                cfg.seed)).numpy()
        else:
            cand = beam_search(
                model.step, state, len(images),
                max(ic.beam_size, ic.num_candidates), *ids, ic.max_length,
                length_penalty=ic.length_penalty, min_length=ic.min_length,
                return_all=True).tokens[:, :ic.num_candidates]
            tokens, _ = rerank_candidates(
                cand, x, reranker.decode_fn, reranker.clip_tokenize_fn,
                reranker.scorer, score_fn=reranker.score)
    return [tok.decode(t, skip_special_tokens=True) for t in tokens]


def _serve_one_batch(service, images):
    """Submit ``images`` together so that the batcher runs them as one
    batch (it waits up to 2 s for a batch to fill); their captions."""
    reqs = [service.submit_async(img) for img in images]
    return [service.result(r) for r in reqs]


@pytest.mark.parametrize("option", list(_OPTIONS))
def test_served_decoding_options_match_direct_decode(option):
    """Greedy, nucleus (the service's generator seeded from the config's
    seed, drawn by this first batch), diverse beam (6 beams in 3 groups)
    and an injected CLIP reranker over 3 beam candidates, which runs on the
    completer thread: the served captions are the direct decode's."""
    cfg = _options_config(option)
    tok = _vocab()
    images = images_uint8(15, n=4)
    reranker = _reranker(tok) if option == "rerank" else None
    want = _direct(cfg, tok, images, reranker)
    service = CaptionService(cfg, tok, "cpu", reranker=reranker,
                             batch_size=4, bucket_sizes=[4],
                             max_wait_ms=2000.0)
    service.start(warmup=False)
    try:
        assert service.reranker is reranker
        assert _serve_one_batch(service, images) == want
        snap = service.stats.snapshot()
        assert snap["batches"] == 1 and snap["decode_steps"] > 0
    finally:
        service.stop()


def test_nucleus_service_is_reproducible():
    """Two services of one seed, warmed up alike, caption the same images
    alike; a service of another seed samples other captions."""
    tok = _vocab()
    images = images_uint8(16, n=4)
    got = []
    for seed in (9, 9, 10):
        cfg = _options_config("nucleus")
        cfg.seed = seed
        service = CaptionService(cfg, tok, "cpu", batch_size=4,
                                 bucket_sizes=[4], max_wait_ms=2000.0)
        service.start(warmup=True)
        try:
            got.append(_serve_one_batch(service, images)
                       + _serve_one_batch(service, images))
        finally:
            service.stop()
    assert got[0] == got[1]
    assert got[0] != got[2]


@pytest.mark.parametrize("option", ["greedy", "nucleus", "diverse"])
def test_cli_serves_the_json_configs_decoding_options(option, tmp_path,
                                                      monkeypatch):
    """``main.py --mode serve --config cfg.json --device cpu``: the
    service it builds decodes with the JSON file's ``inference`` options
    (``serve`` stood in for by one synchronous batch)."""
    from image_captioning_ml_project_tpu_torch.config import save_config

    cfg = _options_config(option)
    path = tmp_path / "cfg.json"
    save_config(cfg, str(path))
    vocab = tmp_path / "vocab.json"
    tok = _vocab()
    tok.save(str(vocab))
    images = images_uint8(17, n=2)
    served = {}

    def one_batch(config, tokenizer, device, **kw):
        service = CaptionService(config, tokenizer, device, batch_size=2,
                                 bucket_sizes=[2])
        served["config"] = config
        served["captions"] = service._run_images(list(images))

    monkeypatch.setattr(server, "serve", one_batch)
    port_main.main(["--mode", "serve", "--config", str(path), "--device",
                    "cpu", "--vocab", str(vocab)])
    ic = served["config"].inference
    for k, v in _OPTIONS[option].items():
        assert getattr(ic, k) == v
    assert served["captions"] == _direct(cfg, tok, images)


def test_cli_reranking_without_a_local_checkpoint_serves_beam(
        tmp_path, monkeypatch, caplog):
    """``use_clip_reranking`` with no local CLIP checkpoint: the JAX
    package's warning, then plain beam captions."""
    import logging

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    cfg = _options_config("rerank")
    cfg.inference.use_clip_reranking = True
    tok = _vocab()
    with caplog.at_level(logging.WARNING):
        service = CaptionService(cfg, tok, "cpu", batch_size=2,
                                 bucket_sizes=[2])
    assert service.reranker is None
    assert "continuing without reranking" in caplog.text
    images = images_uint8(18, n=2)
    assert service._run_images(list(images)) == _direct(cfg, tok, images)


def test_stats_percentiles_are_nearest_rank():
    stats = ServerStats()
    for ms in (10, 20, 30, 40):
        stats.record_done(ms / 1e3)
    assert stats.snapshot()["latency_ms"]["p50"] == 20.0


def test_cli_serves_only_and_needs_a_device():
    """Every mode of the CLI (serve, train, eval, demo) runs on the card
    unless asked for the CPU; the demo needs ``--image_path``."""
    if not torch.cuda.is_available():
        for mode in ("serve", "train", "eval", "demo"):
            with pytest.raises(SystemExit, match="--device cpu"):
                port_main.main(["--mode", mode, "--image_path", "x.jpg"])
    with pytest.raises(SystemExit, match="--image_path is required"):
        port_main.main(["--mode", "demo", "--device", "cpu"])


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


def test_transformer_configuration_is_served():
    """ViT + Transformer decoder behind ``CaptionService``: concurrent
    submits give the direct decode's captions."""
    cfg = tiny_config(vocab=VOCAB, encoder="vit", decoder="transformer")
    cfg.seed = 3
    tok = _vocab()
    images = images_uint8(13, n=3)
    want = _direct_captions(cfg, tok, images)
    service = CaptionService(cfg, tok, "cpu", batch_size=2,
                             bucket_sizes=[1, 2], max_wait_ms=30.0)
    service.start(warmup=True)
    try:
        reqs = [service.submit_async(img) for img in images]
        assert [service.result(r) for r in reqs] == want
        assert service.stats.snapshot()["decode_steps"] > 0
    finally:
        service.stop()


@pytest.mark.parametrize("family", ["qformer", "swin"])
def test_other_families_are_served(family):
    """A Q-Former model and a Swin model behind ``CaptionService``, each
    on its bucket ladder (the Q-Former's cache built from its queries):
    concurrent submits give the direct decode's captions."""
    cfg = family_config(family, vocab=VOCAB)
    cfg.seed = 5
    tok = _vocab()
    images = family_inputs(cfg, 17, n=3)
    want = _direct_captions(cfg, tok, images)
    service = CaptionService(cfg, tok, "cpu", batch_size=2,
                             bucket_sizes=[1, 2], max_wait_ms=30.0)
    service.start(warmup=True)
    try:
        reqs = [service.submit_async(img) for img in images]
        assert [service.result(r) for r in reqs] == want
    finally:
        service.stop()


def test_cli_family_configurations():
    """``--config qformer`` and ``butd`` are the JAX package's
    ``scripts/bench_families.py`` widths, and ``--encoder_type swin`` puts
    Swin-B (about 87 M parameters) in the Transformer family."""
    from image_captioning_ml_project_tpu_torch.config import (
        DecoderType, EncoderType)
    from image_captioning_ml_project_tpu_torch.models.captioning_model \
        import ImageCaptioningModel
    from image_captioning_ml_project_tpu_torch.models.encoders import (
        ObjectRegionEncoder)
    from image_captioning_ml_project_tpu_torch.models.swin import SwinEncoder

    q, b = (port_main.resolve_config(n) for n in ("qformer", "butd"))
    for c in (q, b):
        d = c.model.decoder
        assert d.decoder_type == DecoderType.TRANSFORMER
        assert (d.hidden_dim, d.num_layers, d.num_heads, d.max_length,
                c.model.vocab_size, c.inference.beam_size,
                c.inference.max_length) == (768, 6, 12, 24, 30000, 5, 20)
    assert q.model.use_q_former and (
        q.model.q_former_num_queries, q.model.q_former_num_layers,
        q.model.q_former_num_heads, q.model.projection_dim) == (32, 2, 8,
                                                                768)
    e = b.model.encoder
    assert e.encoder_type == EncoderType.OBJECT_REGION
    assert (e.max_objects, e.region_feature_dim, e.feature_dim) == (36, 2048,
                                                                    768)
    swin = port_main.resolve_config("transformer")
    port_main._update_config_from_args(swin, port_main.build_argparser(
        ).parse_args(["--encoder_type", "swin"]))
    with torch.device("meta"):
        models = [ImageCaptioningModel(c) for c in (q, b, swin)]
    assert isinstance(models[1].encoder, ObjectRegionEncoder)
    assert isinstance(models[2].encoder, SwinEncoder)
    backbone = sum(p.numel() for p in models[2].encoder.backbone.parameters())
    assert 86e6 < backbone < 88e6


def test_cli_builtin_configurations():
    """``--config transformer`` is the widths of the JAX package's
    Transformer benchmark; no ``--config`` is the JAX package's default
    (ViT-B/16 + 6-layer GPT-2 with 8 heads), which the port builds."""
    from image_captioning_ml_project_tpu_torch.config import (
        DecoderType, EncoderType)
    from image_captioning_ml_project_tpu_torch.models.captioning_model \
        import ImageCaptioningModel

    cfg = port_main.resolve_config("transformer")
    e, d = cfg.model.encoder, cfg.model.decoder
    assert e.encoder_type == EncoderType.VIT
    assert (e.hidden_size, e.num_layers, e.num_heads, e.patch_size,
            cfg.image_size) == (768, 12, 12, 16, 224)
    assert d.decoder_type == DecoderType.TRANSFORMER
    assert (d.hidden_dim, d.num_layers, d.num_heads, d.max_length,
            cfg.model.vocab_size) == (768, 6, 12, 24, 30000)
    assert (cfg.inference.beam_size, cfg.inference.max_length,
            cfg.model.dtype) == (5, 20, "bfloat16")
    assert port_main.resolve_config("flagship").model.vocab_size == 50257
    default = port_main.resolve_config(None)
    assert default.model.encoder.encoder_type == EncoderType.VIT
    assert default.model.decoder.decoder_type == DecoderType.GPT2
    for c in (cfg, default):
        with torch.device("meta"):
            model = ImageCaptioningModel(c)
        assert sum(p.numel() for p in model.parameters()) > 10 ** 8


@pytest.mark.parametrize("attention", ["soft", "multi_head"])
def test_lstm_configuration_is_served(attention):
    """ResNet + LSTM behind ``CaptionService``, attention through the
    kernel switch: concurrent submits give the direct decode's
    captions."""
    cfg = tiny_config(vocab=VOCAB, encoder="resnet", decoder="lstm",
                      attention=attention, use_pallas=True)
    cfg.seed = 4
    tok = _vocab()
    images = images_uint8(14, n=3)
    want = _direct_captions(cfg, tok, images)
    service = CaptionService(cfg, tok, "cpu", batch_size=2,
                             bucket_sizes=[1, 2], max_wait_ms=30.0)
    service.start(warmup=True)
    try:
        reqs = [service.submit_async(img) for img in images]
        assert [service.result(r) for r in reqs] == want
        assert service.stats.snapshot()["decode_steps"] > 0
    finally:
        service.stop()


def test_cli_lstm_configuration():
    """``--config lstm`` is the widths of the JAX package's LSTM benchmark
    (ResNet-101, 6-layer LSTM of width 512, vocab 10000) with soft
    attention through its kernel; ``--attention_type`` picks another
    variant."""
    from image_captioning_ml_project_tpu_torch.config import (
        AttentionType, DecoderType, EncoderType)
    from image_captioning_ml_project_tpu_torch.models.captioning_model \
        import ImageCaptioningModel

    cfg = port_main.resolve_config("lstm")
    e, d, a = cfg.model.encoder, cfg.model.decoder, cfg.model.attention
    assert e.encoder_type == EncoderType.RESNET
    assert (tuple(e.resnet_depths), tuple(e.resnet_hidden_sizes),
            e.resnet_embedding_size, e.feature_dim) == (
                (3, 4, 23, 3), (256, 512, 1024, 2048), 64, 512)
    assert d.decoder_type == DecoderType.LSTM
    assert (d.hidden_dim, d.num_layers, cfg.model.vocab_size) == (
        512, 6, 10000)
    assert (a.attention_type, a.hidden_dim, a.num_heads, a.use_pallas) == (
        AttentionType.SOFT, 512, 8, True)
    assert (cfg.inference.beam_size, cfg.inference.max_length,
            cfg.inference.length_penalty, cfg.inference.min_length,
            cfg.model.dtype) == (5, 20, 0.8, 5, "bfloat16")
    with torch.device("meta"):
        model = ImageCaptioningModel(cfg)
    n_conv = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    assert n_conv == 104  # ResNet-101: 1 + 3 x 33 + 4 shortcuts
    args = port_main.build_argparser().parse_args(
        ["--config", "lstm", "--attention_type", "aoa"])
    port_main._update_config_from_args(cfg, args)
    assert cfg.model.attention.attention_type == AttentionType.AOA
