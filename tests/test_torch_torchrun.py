"""``main --mode train`` and ``--mode eval`` as ``torchrun`` starts them: two
CPU processes of the CLI with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set (a free port
on localhost) and the config's mesh at dp2 or tp2, against the same
commands in one process (no ``WORLD_SIZE``) on the tiny ``clip_gpt2``
configuration (contrastive loss on, dropout 0).

* train: two epochs of one step each over four training captions (batch
  4, the first step at lr 0), a step checkpoint after every step
  (``save_every_steps`` 1, rank 0's decision broadcast), validation and
  an epoch checkpoint after each epoch. Rank 0 writes the log and the
  checkpoints: the logged losses of one process, the same checkpoint
  names, and the last epoch's state under
  ``tests/test_torch_trainer.py``'s rules
  (:func:`torch_port_helpers.assert_state_close`), each step's gradient
  read back from the Adam first moments of the two epoch checkpoints;
* eval: the one-process run's last checkpoint captioned by two ranks
  writes the one-process ``results.json``;
* serve at dp2 on that checkpoint: rank 0 answers ``/healthz`` with the
  mesh and the dp-rounded buckets, four concurrent PNG ``POST /caption``
  requests get the one-process service's captions, and SIGTERM to both
  ranks (``torch.distributed.run`` forwards it to every worker) drains
  rank 0, whose ``STOP`` ends rank 1: both exit 0 and log a clean end;
* demo at dp2 and tp2 on that checkpoint: rank 0 prints the one-process
  demo's caption and writes ``demo.png``; rank 1 prints nothing.
"""

import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from image_captioning_ml_project_tpu.config import config_to_dict
from image_captioning_ml_project_tpu.data.synthetic import make_synthetic_coco
from image_captioning_ml_project_tpu.data.tokenizer import WordVocab
from image_captioning_ml_project_tpu_torch import main as port_main
from image_captioning_ml_project_tpu_torch.data.coco import (
    build_coco_datasets)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.train.trainer import (
    CaptioningTrainer)
from image_captioning_ml_project_tpu_torch.utils.checkpoint import (
    CheckpointManager)
from torch_parallel_ranks import launch, rank_env
from torch_port_helpers import (assert_state_close, loose_entries,
                                port_config, train_config)

torch.set_num_threads(1)

WORLD = 2
B1 = 0.9


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(args):
    return [sys.executable, "-m", "image_captioning_ml_project_tpu_torch.main",
            *args]


def _torchrun(tmp_path, what, args, timeout=180.0):
    """``args`` of the CLI on two ranks, as ``torchrun --nproc_per_node 2``
    starts them."""
    port = _free_port()
    envs = [rank_env(RANK=r, WORLD_SIZE=WORLD, LOCAL_RANK=r,
                     LOCAL_WORLD_SIZE=WORLD, MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=port) for r in range(WORLD)]
    launch([_cli(args)] * WORLD, envs, str(tmp_path / what), timeout)


def _logged_losses(out):
    """Each epoch's train and validation loss in ``training.log``, in
    order."""
    with open(os.path.join(out, "training.log")) as f:
        return [float(x) for m in re.findall(
            r"Train Loss: ([0-9.]+), Val Loss: ([0-9.]+)", f.read())
            for x in m]


def _gradients(ckpt_dir):
    """Each step's gradient by optimizer name, from the first moments of
    the epoch checkpoints: mu_1 = (1 - b1) g_1, mu_2 = b1 mu_1 +
    (1 - b1) g_2."""
    mgr = CheckpointManager(ckpt_dir)
    mu = [mgr.restore(f"checkpoint_epoch_{e}")[0]["opt_state"]["mu"]
          for e in (1, 2)]
    g1 = {n: m / (1 - B1) for n, m in mu[0].items()}
    g2 = {n: (m - B1 * mu[0][n]) / (1 - B1) for n, m in mu[1].items()}
    return [{n: g.abs() for n, g in g1.items()},
            {n: g.abs() for n, g in g2.items()}]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(config path, vocab path, the one-process run's output directory,
    its config, its seeded state before the steps and the steps' learning
    rates)."""
    tmp = tmp_path_factory.mktemp("torchrun")
    root = make_synthetic_coco(str(tmp / "coco"), num_images=4,
                               captions_per_image=1, image_size=32)
    with open(os.path.join(root, "annotations",
                           "captions_train2014.json")) as f:
        captions = [a["caption"] for a in json.load(f)["annotations"]]
    vocab = WordVocab.build(captions, threshold=1)
    cfg = train_config("clip_gpt2", root, vocab, tmp)
    cfg.training.num_epochs = 2
    cfg.save_every_steps = 1
    vocab_path = str(tmp / "vocab.json")
    PortVocab(dict(vocab.word2idx)).save(vocab_path)
    pcfg = port_config(cfg)
    train_ds, val_ds = build_coco_datasets(pcfg, PortVocab.load(vocab_path))
    assert len(train_ds) == cfg.training.batch_size
    t = CaptioningTrainer(pcfg, train_ds, val_ds, None, device="cpu")
    before = t._state_tree()
    lrs = [float(t.lr_schedule(i)) for i in range(2)]
    assert lrs[0] == 0 < lrs[1]
    del t
    one = str(tmp / "one")
    path = str(tmp / "cfg.json")
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f)
    port_main.main(["--mode", "train", "--config", path, "--device", "cpu",
                    "--output_dir", one, "--vocab", vocab_path])
    return path, vocab_path, one, pcfg, before, lrs


def _mesh_config(tmp_path, path, dp, mp):
    with open(path) as f:
        d = json.load(f)
    d["mesh"].update(data_parallel=dp, model_parallel=mp)
    out = str(tmp_path / "cfg.json")
    with open(out, "w") as f:
        json.dump(d, f)
    return out


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2)])
def test_torchrun_train_matches_one_process(fixture, tmp_path, dp, mp):
    path, vocab_path, one, cfg, before, lrs = fixture
    out = str(tmp_path / "run")
    _torchrun(tmp_path, "train", [
        "--mode", "train", "--config", _mesh_config(tmp_path, path, dp, mp),
        "--device", "cpu", "--output_dir", out, "--vocab", vocab_path])
    losses = _logged_losses(out)
    assert len(losses) == 4
    assert losses == pytest.approx(_logged_losses(one), abs=2e-4)
    mine, theirs = (os.path.join(d, "checkpoints") for d in (out, one))
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    assert {"checkpoint_step_0", "checkpoint_step_1",
            "checkpoint_epoch_2"} <= set(os.listdir(mine))
    got, meta, _ = CheckpointManager(mine).restore("checkpoint_epoch_2")
    want, want_meta, _ = CheckpointManager(theirs).restore(
        "checkpoint_epoch_2")
    assert meta["epoch"] == want_meta["epoch"] == 1
    grads = [_gradients(mine), _gradients(theirs)]
    loose = loose_entries(*grads)
    assert_state_close(got, want, before, loose, lrs,
                       cfg.training.weight_decay,
                       f"torchrun dp{dp} tp{mp}")


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2)])
def test_torchrun_eval_writes_the_one_process_results(fixture, tmp_path, dp,
                                                     mp):
    path, vocab_path, one, _, _, _ = fixture
    ckpt = os.path.join(one, "checkpoints", "checkpoint_epoch_2")
    outs = {}
    for name in ("one", "ranks"):
        out = str(tmp_path / name)
        args = ["--mode", "eval", "--config",
                _mesh_config(tmp_path, path, dp, mp), "--device", "cpu",
                "--output_dir", out, "--vocab", vocab_path,
                "--checkpoint", ckpt]
        if name == "one":
            port_main.main(args)
        else:
            _torchrun(tmp_path, "eval", args)
        with open(os.path.join(out, "results.json")) as f:
            outs[name] = json.load(f)
    assert outs["ranks"] == outs["one"] and len(outs["one"]) == 4


def _start_ranks(tmp_path, what, args):
    """``args`` of the CLI on two ranks started as ``torchrun`` starts
    them, left running: (processes, log paths)."""
    port = _free_port()
    logs, procs = [], []
    for r in range(WORLD):
        logs.append(str(tmp_path / f"{what}.{r}.log"))
        env = rank_env(RANK=r, WORLD_SIZE=WORLD, LOCAL_RANK=r,
                       LOCAL_WORLD_SIZE=WORLD, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=port)
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(_cli(args), env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs, logs


def _read(path):
    with open(path) as f:
        return f.read()


def _wait_for_health(url, procs, logs, timeout=120.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
                return json.loads(r.read())
        except OSError:
            pass
        bad = [p.poll() for p in procs if p.poll() is not None]
        if bad or time.monotonic() > deadline:
            raise AssertionError("the ranks did not come up: " + "\n".join(
                _read(log)[-3000:] for log in logs))
        time.sleep(0.2)


def _png(image):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def test_torchrun_serve_at_dp2_answers_then_drains_on_sigterm(
        fixture, tmp_path):
    from image_captioning_ml_project_tpu_torch.inference.server import (
        CaptionService)
    from torch_port_helpers import images_uint8

    path, vocab_path, one, cfg, _, _ = fixture
    ckpt = os.path.join(one, "checkpoints", "checkpoint_epoch_2")
    pngs = [_png(img) for img in images_uint8(41, n=4)]
    svc = CaptionService(cfg, PortVocab.load(vocab_path), "cpu",
                         checkpoint_path=ckpt, batch_size=4,
                         bucket_sizes=[1, 4])
    svc.start(warmup=False)
    try:
        want = [svc.caption_bytes(png) for png in pngs]
    finally:
        svc.stop()
    port = _free_port()
    procs, logs = _start_ranks(tmp_path, "serve", [
        "--mode", "serve", "--config", _mesh_config(tmp_path, path, 2, 1),
        "--device", "cpu", "--output_dir", str(tmp_path / "out"),
        "--vocab", vocab_path, "--checkpoint", ckpt, "--port", str(port),
        "--serve_batch_size", "3", "--serve_buckets", "1,3",
        "--serve_max_wait_ms", "50"])
    try:
        url = f"http://127.0.0.1:{port}"
        health = _wait_for_health(url, procs, logs)
        assert health["mesh"] == {"data": 2, "model": 1}
        assert health["bucket_sizes"] == [2, 4]
        got = [None] * len(pngs)

        def client(i):
            req = urllib.request.Request(f"{url}/caption", data=pngs[i],
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                got[i] = json.loads(r.read())["caption"]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(pngs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert got == want
        for p in procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = [_read(log) for log in logs]
    assert codes == [0, 0], "\n".join(t[-3000:] for t in text)
    for r in range(WORLD):
        assert f"rank {r} of 2: --mode serve ended cleanly" in text[r]
    assert "waiting for rank 0's STOP" in text[1]


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2)])
def test_torchrun_demo_prints_the_one_process_caption(fixture, tmp_path, dp,
                                                      mp):
    path, vocab_path, one, cfg, _, _ = fixture
    image = os.path.join(cfg.data_root, "val2014",
                         sorted(os.listdir(os.path.join(cfg.data_root,
                                                        "val2014")))[0])
    ckpt = os.path.join(one, "checkpoints", "checkpoint_epoch_2")
    args = ["--mode", "demo", "--config",
            _mesh_config(tmp_path, path, dp, mp), "--device", "cpu",
            "--vocab", vocab_path, "--checkpoint", ckpt,
            "--image_path", image]
    want = port_main.main(args + ["--output_dir", str(tmp_path / "one")])
    out = tmp_path / "ranks"
    _torchrun(tmp_path, "demo", args + ["--output_dir", str(out)])
    logs = [_read(tmp_path / f"demo.{r}.log") for r in range(WORLD)]
    assert want and want in logs[0].splitlines()
    assert want not in logs[1].splitlines()
    assert os.path.exists(out / "demo.png")


def test_torchrun_serve_rank_0_exits_non_zero_when_a_rank_dies(
        fixture, tmp_path):
    """A follower killed while the service is idle: rank 0's next command
    (a heartbeat) fails, and rank 0 fails its pending requests and exits
    non-zero well inside the process group's timeout."""
    path, vocab_path, one, _, _, _ = fixture
    port = _free_port()
    procs, logs = _start_ranks(tmp_path, "serve_dies", [
        "--mode", "serve", "--config", _mesh_config(tmp_path, path, 2, 1),
        "--device", "cpu", "--output_dir", str(tmp_path / "out"),
        "--vocab", vocab_path, "--port", str(port),
        "--serve_batch_size", "2", "--serve_buckets", "2"])
    try:
        _wait_for_health(f"http://127.0.0.1:{port}", procs, logs)
        procs[1].kill()
        t0 = time.monotonic()
        code = procs[0].wait(timeout=60)
        elapsed = time.monotonic() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = _read(logs[0])
    assert code != 0, text[-3000:]
    assert "the caption service's mesh failed" in text
    assert elapsed < 30, elapsed
