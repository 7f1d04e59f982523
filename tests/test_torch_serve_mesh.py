"""Serving under the mesh (port: ``inference/server.py``'s
``CaptionService(mesh=)``, the command stream of ``parallel/mesh.py``, and
``models/gpt2.py``'s decode on head-whole shards) on two gloo ranks on the
CPU, against the JAX ``CaptionService(mesh=)`` on two devices of
``tests/conftest.py``'s eight-device CPU mesh, on the tiny ``clip_gpt2``
configuration of ``tests/test_torch_parallel.py`` (f32, beam 5, max
length 8) with the JAX service's weights:

* the dp-rounded bucket ladder and batch size equal the JAX service's;
* beam captions at dp2 and at tp2 equal the JAX service's on a mesh of the
  same shape, on every bucket: ``_run_images`` of 8 images (two batches
  of the largest bucket) and of 1 (the smallest), and 8 concurrent
  ``submit``s after the warmup that runs every bucket through the command
  stream; greedy at dp2 likewise;
* nucleus at dp2 equals a one-process decode of each data rank's rows
  with the generator seeded ``seed + rank``;
* the tiny ViT + Transformer decoder (the cross-attention route) at dp2
  equals the JAX service on a dp2 mesh with the same weights, and the
  one-process service;
* a ``reload_checkpoint`` at dp2 under concurrent requests answers every
  request, goes on serving while the ranks read the checkpoint, and the
  captions after it equal the JAX dp2 service's on that checkpoint's
  weights and a fresh one-process service's on that checkpoint;
* a decode error injected on rank 1 fails that batch on rank 0 with rank
  1's text, and the next batch is served;
* at tp2 every rank's GPT-2 caches are ``H / 2`` wide, the decode took the
  split path with the beam attention on ``num_heads / 2`` heads, and
  neither the folded nor the whole-stack kernel ran.

The ranks run in subprocesses (``torch_parallel_ranks.py``), all scenarios
in one launch."""

import copy
import threading

import jax
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.config import MeshConfig as JaxMesh
from image_captioning_ml_project_tpu.config import config_to_dict
from image_captioning_ml_project_tpu.inference.server import (
    CaptionService as JaxService)
from image_captioning_ml_project_tpu.parallel import mesh as jax_mesh
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    decode_images)
from image_captioning_ml_project_tpu_torch.inference.server import (
    CaptionService)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    build_train_model, load_model)
from image_captioning_ml_project_tpu_torch.params import init_flax_params
from image_captioning_ml_project_tpu_torch.parallel.mesh import Mesh
from image_captioning_ml_project_tpu_torch.utils.checkpoint import (
    CheckpointManager)
from torch_parallel_ranks import run_ranks
from torch_port_helpers import (coco_fixture, images_uint8, port_config,
                                tiny_config, train_config)

torch.set_num_threads(1)

BATCH, BUCKETS = 4, [1, 4]
# (name, decoding strategy, data axis, model axis) of the JAX services
JAX_RUNS = (("beam dp2", "beam", 2, 1), ("beam tp2", "beam", 1, 2),
            ("greedy dp2", "greedy", 2, 1))
IMAGES = images_uint8(31, n=8)
SINGLE = images_uint8(32, n=1)
RELOAD_SEED = 12     # the reloaded checkpoint's weights
RELOAD_DELAY_S = 1.5  # added to every rank's read of it


def _jax_mesh(dp, mp):
    return jax_mesh.create_mesh(JaxMesh(data_parallel=dp, model_parallel=mp),
                                devices=jax.devices()[:2])


def _port_mesh(dp, rank=0):
    """A data-parallel mesh's view for a service built in this process
    (no process group: nothing but its shape is read)."""
    return Mesh(shape={"data": dp, "model": 1}, data_axis="data",
                model_axis="model", rank=rank,
                coords={"data": rank, "model": 0})


def _checkpoint(cfg, name, seed):
    """A trainer checkpoint ``name`` of weights drawn from ``seed``."""
    model = build_train_model(cfg, "cpu", params=init_flax_params(cfg, seed))
    state = {"params": {"model": {n: p.detach() for n, p in
                                  model.named_parameters()}, "loss": {}},
             "batch_stats": {n: b for n, b in model.named_buffers()},
             "opt_state": {"count": 0, "mu": {}, "nu": {}}, "step": 0}
    CheckpointManager(cfg.checkpoint_dir).save(name, state)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """(JAX config, port config, JAX vocab, port vocab, tmp dir)."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    root, vocab = coco_fixture(str(tmp / "coco"))
    cfg = train_config("clip_gpt2", root, vocab, tmp)
    return cfg, port_config(cfg), vocab, PortVocab(dict(vocab.word2idx)), tmp


def _strategy(cfg, strategy):
    out = copy.deepcopy(cfg)
    out.inference.decoding_strategy = strategy
    return out


def _jax_service(cfg, vocab, strategy, dp, mp):
    return JaxService(_strategy(cfg, strategy), tokenizer=vocab,
                      batch_size=BATCH, bucket_sizes=BUCKETS,
                      mesh=_jax_mesh(dp, mp))


def _model_params(svc):
    """The JAX service's model weights on the host, as the port's
    ``params=`` takes them."""
    return {"params": jax.device_get(svc.trainer.state.params["model"])}


def _with_weights(svc, variables):
    """The JAX service ``svc`` serving the flax tree ``variables``, placed
    as its own weights are (what its ``reload_checkpoint`` does after the
    restore)."""
    st = svc.trainer.state
    model = jax.tree_util.tree_map(
        lambda old, new: jax.device_put(new, old.sharding),
        st.params["model"], variables["params"])
    svc.trainer.state = st.replace(params={**st.params, "model": model})
    svc._estate = svc.trainer.eval_state()
    return svc


@pytest.fixture(scope="module")
def runs(base):
    """One launch of two ranks running every port scenario, on the first
    JAX service's weights, while the JAX services caption the same images
    in this process: {name: (the JAX service's numbers, rank 0's
    result)}."""
    cfg, _, vocab, pvocab, tmp = base
    word2idx = dict(vocab.word2idx)
    services = {JAX_RUNS[0][0]: _jax_service(cfg, vocab, *JAX_RUNS[0][1:])}
    params = _model_params(services[JAX_RUNS[0][0]])
    scenarios, names = [], []
    for name, strategy, dp, mp in JAX_RUNS:
        actions = [("run", IMAGES), ("run", SINGLE)]
        if strategy == "beam":
            actions.append(("submit", IMAGES))
        scenarios.append(dict(kind="serve", mesh=(dp, mp),
                              config=config_to_dict(_strategy(cfg, strategy)),
                              word2idx=word2idx,
                              params=params, batch_size=BATCH,
                              buckets=BUCKETS, warmup=strategy == "beam",
                              actions=actions))
        names.append(name)

    ncfg = _strategy(cfg, "nucleus")
    ncfg.inference.top_p = 0.9
    scenarios.append(dict(kind="serve", mesh=(2, 1),
                          config=config_to_dict(ncfg), word2idx=word2idx,
                          params=params, batch_size=BATCH, buckets=BUCKETS,
                          actions=[("run", IMAGES[:BATCH])]))
    names.append("nucleus dp2")

    tcfg = tiny_config(vocab=vocab.vocab_size, encoder="vit",
                       decoder="transformer")
    for k in ("pad_token_id", "bos_token_id", "eos_token_id"):
        setattr(tcfg.model, k, getattr(vocab, k))
    tcfg.checkpoint_dir = str(tmp / "transformer_ckpt")
    tservice = _jax_service(tcfg, vocab, tcfg.inference.decoding_strategy,
                            2, 1)
    tparams = _model_params(tservice)
    scenarios.append(dict(kind="serve", mesh=(2, 1),
                          config=config_to_dict(tcfg), word2idx=word2idx,
                          params=tparams, batch_size=BATCH, buckets=BUCKETS,
                          actions=[("run", IMAGES)]))
    names.append("transformer dp2")

    rcfg = copy.deepcopy(cfg)
    rcfg.checkpoint_dir = str(tmp / "ckpt")
    _checkpoint(port_config(rcfg), "next", seed=RELOAD_SEED)
    scenarios.append(dict(kind="serve", mesh=(2, 1),
                          config=config_to_dict(rcfg), word2idx=word2idx,
                          params=params, batch_size=BATCH, buckets=BUCKETS,
                          reload_delay_s=RELOAD_DELAY_S,
                          actions=[("run", IMAGES),
                                   ("reload", (IMAGES, "next"))]))
    names.append("reload dp2")

    failing = np.full_like(SINGLE, 255)
    scenarios.append(dict(kind="serve", mesh=(2, 1),
                          config=config_to_dict(cfg), word2idx=word2idx,
                          params=params, batch_size=BATCH, buckets=BUCKETS,
                          fail_rank=1, actions=[("submit_each", np.concatenate(
                              [SINGLE, failing, SINGLE]))]))
    names.append("failing rank dp2")

    (tmp / "ranks").mkdir()
    ranks = {}

    def launch():
        try:
            ranks["results"] = run_ranks(tmp / "ranks", scenarios,
                                         timeout=240)
        except Exception as e:  # raised below, on the test's thread
            ranks["error"] = e

    thread = threading.Thread(target=launch)
    thread.start()
    want = {}
    try:
        for name, strategy, dp, mp in JAX_RUNS:
            if name not in services:
                services[name] = _jax_service(cfg, vocab, strategy, dp, mp)
            svc = services[name]
            same = jax.tree_util.tree_map(
                lambda a, b: bool(np.array_equal(a, b)),
                jax.device_get(svc.trainer.state.params["model"]),
                params["params"])
            want[name] = {"buckets": svc.bucket_sizes,
                          "batch_size": svc.batch_size,
                          "same_weights": all(jax.tree_util.tree_leaves(
                              same)),
                          "results": [svc._run_images(list(IMAGES)),
                                      svc._run_images(list(SINGLE))]}
        want["transformer dp2"] = tservice._run_images(list(IMAGES))
        # the beam dp2 service, done with its own weights, on the
        # reloaded checkpoint's (the configurations differ only in
        # checkpoint_dir)
        rservice = _with_weights(services["beam dp2"], init_flax_params(
            port_config(rcfg), RELOAD_SEED))
        want["reload dp2"] = rservice._run_images(list(IMAGES))
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    out = {name: (want.get(name), res)
           for name, res in zip(names, ranks["results"])}
    out["configs"] = {"nucleus": ncfg, "transformer": tcfg, "reload": rcfg}
    out["vocab"] = pvocab
    out["params"] = params
    out["transformer params"] = tparams
    return out


@pytest.mark.parametrize("batch,buckets", [(4, [1, 4]), (3, [1, 2, 3]),
                                           (8, None), (5, [2, 3, 7])])
def test_bucket_ladder_rounds_to_the_data_axis_as_jax(base, batch, buckets):
    cfg, pcfg, vocab, pvocab, _ = base
    jsvc = JaxService(cfg, tokenizer=vocab, batch_size=batch,
                      bucket_sizes=buckets, mesh=_jax_mesh(2, 1))
    svc = CaptionService(pcfg, pvocab, "cpu", batch_size=batch,
                         bucket_sizes=buckets, mesh=_port_mesh(2))
    assert svc.bucket_sizes == jsvc.bucket_sizes
    assert svc.batch_size == jsvc.batch_size
    assert all(b % 2 == 0 for b in svc.bucket_sizes)


@pytest.mark.parametrize("name", [r[0] for r in JAX_RUNS])
def test_captions_match_the_jax_service_on_the_same_mesh(runs, name):
    want, got = runs[name]
    assert want["same_weights"]
    assert got["buckets"] == want["buckets"]
    assert got["batch_size"] == want["batch_size"]
    run8, run1 = got["results"][:2]
    assert run8 == want["results"][0]
    assert run1 == want["results"][1]
    assert len(set(run8)) > 1  # the captions tell the images apart


@pytest.mark.parametrize("name", ["beam dp2", "beam tp2"])
def test_concurrent_submits_after_warmup_match_jax(runs, name):
    want, got = runs[name]
    assert got["results"][2] == want["results"][0]


def test_tp2_decodes_on_head_whole_shards(runs):
    """Each rank's caches are H / 2 wide, the path split, the beam
    attention on 2 of the 4 heads; no folded or whole-stack launch."""
    cfg = runs["configs"]["reload"]
    H, nh = cfg.model.decoder.hidden_dim, cfg.model.decoder.num_heads
    for seen in runs["beam tp2"][1]["ranks"]:
        assert seen["widths"] == [H // 2]
        assert seen["paths"] == ["split"]
        assert seen["heads"] == [nh // 2]
        assert seen["beam_decode_attention"] > 0
        assert seen["other_kernels"] == 0
    for seen in runs["beam dp2"][1]["ranks"]:
        assert seen["widths"] == [H] and seen["beam_decode_attention"] == 0


def test_nucleus_draws_from_seed_plus_data_rank(runs):
    cfg = port_config(runs["configs"]["nucleus"])
    model = load_model(cfg, "cpu", params=runs["params"])
    vocab = runs["vocab"]
    want = []
    with torch.inference_mode():
        for r in range(2):
            g = torch.Generator().manual_seed(cfg.seed + r)
            rows = torch.from_numpy(IMAGES[2 * r:2 * r + 2])
            tokens = decode_images(model, rows, cfg, g).numpy()
            want += [vocab.decode(t, skip_special_tokens=True)
                     for t in tokens]
    assert runs["nucleus dp2"][1]["results"][0] == want


def _one_process(cfg, vocab, **kw):
    """Captions of :data:`IMAGES` from a one-process service."""
    svc = CaptionService(port_config(cfg), vocab, "cpu", batch_size=BATCH,
                         bucket_sizes=BUCKETS, **kw)
    return svc._run_images(list(IMAGES))


def test_transformer_family_at_dp2_matches_jax_and_one_process(runs):
    want, got = runs["transformer dp2"]
    got = got["results"][0]
    assert got == want
    assert len(set(got)) > 1
    assert got == _one_process(runs["configs"]["transformer"], runs["vocab"],
                               params=runs["transformer params"])


def test_reload_reaches_every_rank(runs):
    """Every request in flight across the reload is answered, and answers
    go on while the ranks read the checkpoint; after it both ranks serve
    the checkpoint (the JAX dp2 service's captions on its weights, and a
    fresh one-process service's on it)."""
    want, got = runs["reload dp2"]
    before, reload = got["results"]
    assert reload["failed"] == [] and reload["answered"] >= 8
    assert reload["reload"]["reloaded"] == "next"
    assert reload["reload_s"] >= RELOAD_DELAY_S
    # answered after the read had begun and before it could have ended:
    # the batches did not wait for it
    assert any(RELOAD_DELAY_S / 4 < t < RELOAD_DELAY_S
               for t in reload["answered_during"])
    assert before == runs["beam dp2"][1]["results"][0]
    assert reload["after"] == want and want != before
    fresh = _one_process(runs["configs"]["reload"], runs["vocab"],
                         checkpoint_path="next")
    assert reload["after"] == fresh


def test_a_failing_rank_fails_its_batch_and_the_service_goes_on(runs):
    first, failed, after = runs["failing rank dp2"][1]["results"][0]
    assert failed.startswith("error: ")
    assert "rank 1: RuntimeError: injected on rank 1" in failed
    assert "rank 0" not in failed
    assert first == after == runs["beam dp2"][1]["results"][1][0]
