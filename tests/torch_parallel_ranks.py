"""Rank bodies of the port's multi-process tests, and their launcher.

Imports torch, numpy and the port only (no JAX): each rank is a process of
its own, started by :func:`run_ranks` with ``python torch_parallel_ranks.py
SPEC RANK`` (:func:`launch` starts any such set of processes, e.g. the
CLI under ``torchrun``'s variables). The ranks meet through a ``file://``
store in the test's directory (no TCP port, so parallel test workers cannot collide), use one
CPU thread each, and give every collective a 60 s deadline; the launcher
kills every rank when one fails or the join deadline passes. Each rank
runs the spec's scenarios in order, and rank 0 pickles their results to
``SPEC.out``.

Scenarios (``kind``):

* ``train``: a :class:`CaptioningTrainer` on the mesh ``(dp, mp)`` loads a
  full training state and takes CE steps on the given global batches
  (each rank its rows); returns the steps' metrics, the full gradients of
  each step and the gathered state; then optionally the validation's
  decoded token rows, ``main.evaluate`` on the seeded weights (rank 0
  writing ``results.json``), a checkpoint saved to a directory, and an
  SCST step with injected rollouts;
* ``gpt2_forward``: the GPT-2 backbone's logits with its blocks sharded
  over the mesh's model axis;
* ``legacy_step``: one :class:`LegacyTrainer` step at ``(dp, 1)``;
* ``serve``: a :class:`CaptionService` on the mesh (rank 0 serves, the
  others ``follow()``) runs the spec's ``actions`` in order: ``run``
  (``_run_images``), ``submit`` (concurrent requests), ``reload`` (under
  concurrent requests), ``submit_each`` (one request at a time, each
  caption or error text kept); rank ``fail_rank`` raises in its decode of
  a batch whose rows of that rank are all 255, and every rank's read of a
  checkpoint takes ``reload_delay_s`` more. Returns rank 0's results,
  the buckets, and every rank's GPT-2 caches' widths and attention
  launches.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def launch(commands, envs, log_prefix: str, timeout: float) -> None:
    """Run one process per ``commands`` entry (an argv, with the matching
    ``envs`` entry as its environment) until all exit 0. Kills every
    process and raises with each one's output when one exits non-zero or
    the deadline passes."""
    logs = [open(f"{log_prefix}.{r}.log", "w+")
            for r in range(len(commands))]
    procs = [subprocess.Popen(cmd, env=env, stdout=log,
                              stderr=subprocess.STDOUT)
             for cmd, env, log in zip(commands, envs, logs)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = "deadline passed"
                break
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            time.sleep(0.05)
        if failed is None and any(p.returncode for p in procs):
            failed = f"exit codes {[p.returncode for p in procs]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed is not None:
        out = []
        for r, log in enumerate(logs):
            log.seek(0)
            out.append(f"--- rank {r}\n{log.read()[-6000:]}")
        raise RuntimeError(f"ranks failed ({failed}):\n" + "\n".join(out))


def rank_env(**extra) -> dict:
    """The environment of a rank process: this one's, the repository and
    this directory on ``PYTHONPATH``, one OpenMP thread, no ``torchrun``
    variables but ``extra``'s."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, HERE, os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_ranks(tmp_path, scenarios, world: int = 2, timeout: float = 240.0):
    """Run ``scenarios`` on ``world`` ranks; returns rank 0's results (one
    per scenario). Raises with every rank's output when one fails or the
    deadline passes."""
    spec = os.path.join(str(tmp_path), "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"world": world, "store": os.path.join(
            str(tmp_path), "store"), "scenarios": scenarios}, f)
    launch([[sys.executable, os.path.abspath(__file__), spec, str(r)]
            for r in range(world)], [rank_env()] * world, spec, timeout)
    with open(f"{spec}.out", "rb") as f:
        return pickle.load(f)


# ----------------------------------------------------------------------
# inside a rank
# ----------------------------------------------------------------------

def _train(sc, mesh):
    import numpy as np
    import torch

    from image_captioning_ml_project_tpu_torch.config import config_from_dict
    from image_captioning_ml_project_tpu_torch.data.coco import (
        build_coco_datasets)
    from image_captioning_ml_project_tpu_torch.data.pipeline import (
        shard_batch)
    from image_captioning_ml_project_tpu_torch.data.tokenizer import (
        WordVocab)
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    cfg = config_from_dict(sc["config"])
    vocab = _RecordingVocab(sc["word2idx"])
    train_ds, val_ds = build_coco_datasets(cfg, WordVocab(sc["word2idx"]))
    t = CaptioningTrainer(cfg, train_ds, val_ds, vocab, mesh=mesh,
                          device="cpu")
    t.load_state(sc["state"])
    grads = []
    step = t.optimizer.step

    def recording(g):
        grads.append({n: v.abs() for n, v in t._gather(
            {n: v.detach().clone() for n, v in g.items()}).items()})
        return step(g)

    t.optimizer.step = recording
    metrics = []
    for b in sc["batches"]:
        lb = shard_batch(b, mesh)
        m = t.train_step(lb["image"], lb["caption_tokens"],
                         lb["attention_mask"])
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "grads": grads,
           "state": copy.deepcopy(t._state_tree())}
    if sc.get("validate"):
        vocab.seen.clear()
        loss, val_metrics = t._validate_epoch(0)
        out["validation"] = (loss, val_metrics, np.stack(vocab.seen))
    if sc.get("evaluate"):
        from image_captioning_ml_project_tpu_torch import main as port_main

        ecfg = copy.deepcopy(cfg)
        ecfg.output_dir = sc["evaluate"]
        out["evaluate"] = port_main.evaluate(
            ecfg, tokenizer=WordVocab(sc["word2idx"]), device="cpu",
            mesh=mesh)
    if sc.get("save_dir"):
        t.ckpt = type(t.ckpt)(sc["save_dir"])
        t.save_checkpoint(0)
        t.ckpt.wait_until_finished()
    if "scst" in sc:
        s = sc["scst"]
        lb = shard_batch(dict(s, image=s["image"]), mesh)
        rows = lambda a: shard_batch({"a": a}, mesh)["a"]  # noqa: E731
        ref_tokens, ref_valid = t.scst_references(
            [int(i) for i in rows(s["image_id"])])
        m = t.scst_fused_step(lb["image"], ref_tokens, ref_valid,
                              rollouts=(rows(s["sampled"]), rows(s["mask"]),
                                        rows(s["greedy"])))
        out["scst"] = {k: float(v) for k, v in m.items()}
        out["scst_state"] = t._state_tree()
    torch.distributed.barrier()
    return out


class _RecordingVocab:
    """A word vocabulary that keeps every token row it decodes."""

    def __init__(self, word2idx):
        from image_captioning_ml_project_tpu_torch.data.tokenizer import (
            WordVocab)

        self._vocab = WordVocab(word2idx)
        self.seen = []

    def __getattr__(self, name):
        return getattr(self._vocab, name)

    def __len__(self):
        return len(self._vocab)

    def decode(self, ids, skip_special_tokens=True):
        import numpy as np

        self.seen.append(np.asarray(ids).copy())
        return self._vocab.decode(ids, skip_special_tokens)


def _gpt2_forward(sc, mesh):
    import torch

    from image_captioning_ml_project_tpu_torch.models.gpt2 import (
        GPT2Backbone)
    from image_captioning_ml_project_tpu_torch.parallel import (
        tensor_parallel)

    a = sc["args"]
    backbone = GPT2Backbone(a["vocab"], a["hidden"], a["layers"],
                            a["heads"], a["positions"])
    backbone.load_state_dict(sc["state"])
    tensor_parallel(backbone, mesh)
    ids = torch.as_tensor(sc["ids"]).long()
    with torch.no_grad():
        x = backbone.wte(ids) + backbone.wpe.weight[:ids.shape[1]][None]
        hidden, _ = backbone.full(x)
        return {"logits": backbone.logits(hidden).numpy(),
                "local_shapes": {n: tuple(p.shape)
                                 for n, p in backbone.named_parameters()}}


def _legacy_step(sc, mesh):
    import torch

    from image_captioning_ml_project_tpu_torch.data.pipeline import (
        shard_batch)
    from image_captioning_ml_project_tpu_torch.legacy.train import (
        LegacyTrainer)

    t = LegacyTrainer(sc["vocab"], None, None, mesh=mesh, device="cpu",
                      checkpoint_dir=sc["ckpt"], **sc["kwargs"])
    lb = shard_batch(sc["batch"], mesh)
    m = t.train_step(lb["image"], lb["caption_tokens"])
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "state": t.state_tree()}
    torch.distributed.barrier()
    return out


def _serve(sc, mesh):
    import threading

    import torch

    from image_captioning_ml_project_tpu_torch.config import config_from_dict
    from image_captioning_ml_project_tpu_torch.data.tokenizer import (
        WordVocab)
    from image_captioning_ml_project_tpu_torch.inference.server import (
        CaptionService)
    from image_captioning_ml_project_tpu_torch.models import gpt2

    cfg = config_from_dict(sc["config"])
    service = CaptionService(cfg, WordVocab(sc["word2idx"]), "cpu",
                             params=sc.get("params"),
                             checkpoint_path=sc.get("checkpoint"),
                             batch_size=sc["batch_size"],
                             bucket_sizes=sc["buckets"], max_wait_ms=20.0,
                             mesh=mesh)
    seen = {"widths": set(), "paths": set(), "heads": set(),
            "beam_decode_attention": 0, "other_kernels": 0}
    decoder = service.model.decoder
    if isinstance(decoder, gpt2.GPT2Decoder):
        def init_cache(features, max_length, _orig=decoder.init_cache):
            state = _orig(features, max_length)
            lazy = state["lazy"]
            k = (lazy["stacked"]["k"] if "stacked" in lazy
                 else lazy["layers"][0]["k"])
            seen["widths"].add(int(k.shape[-1]))
            seen["paths"].add("stack" if "stacked" in lazy else "fold"
                              if state["shared"]["fold"] else "split")
            return state

        def split(*a, _orig=gpt2.beam_decode_attention, **kw):
            seen["beam_decode_attention"] += 1
            seen["heads"].add(kw["num_heads"])
            return _orig(*a, **kw)

        def other(fn):
            def counted(*a, **kw):
                seen["other_kernels"] += 1
                return fn(*a, **kw)
            return counted

        decoder.init_cache = init_cache
        kernels = {"beam_decode_attention": split,
                   "beam_decode_attention_qkv": other(
                       gpt2.beam_decode_attention_qkv),
                   "beam_decode_stack": other(gpt2.beam_decode_stack)}
    else:
        kernels = {}
    originals = {name: getattr(gpt2, name) for name in kernels}
    for name, fn in kernels.items():
        setattr(gpt2, name, fn)
    if mesh.rank == sc.get("fail_rank"):
        def failing(images, _orig=service._decode):
            if bool((images == 255).all()):
                raise RuntimeError(f"injected on rank {mesh.rank}")
            return _orig(images)

        service._decode = failing
    if sc.get("reload_delay_s"):
        def slow(name, _orig=service._load_checkpoint):
            time.sleep(sc["reload_delay_s"])
            return _orig(name)

        service._load_checkpoint = slow
    out = {"buckets": service.bucket_sizes,
           "batch_size": service.batch_size, "results": []}
    try:
        if service.is_front:
            service.start(warmup=sc.get("warmup", False))
            try:
                for kind, arg in sc["actions"]:
                    out["results"].append(_serve_action(service, kind, arg,
                                                        threading))
            finally:
                service.stop()
        else:
            service.follow()
    finally:
        for name, fn in originals.items():
            setattr(gpt2, name, fn)
    seen = {k: sorted(v) if isinstance(v, set) else v
            for k, v in seen.items()}
    per_rank = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(per_rank, seen)
    out["ranks"] = per_rank
    return out


def _serve_action(service, kind, arg, threading):
    if kind == "run":
        return service._run_images(list(arg))
    if kind == "submit_each":
        got = []
        for img in arg:
            try:
                got.append(service.submit(img))
            except RuntimeError as e:
                got.append(f"error: {e}")
        return got
    if kind == "submit":
        got = [None] * len(arg)

        def client(i):
            got[i] = service.submit(arg[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(arg))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        return got
    # reload: while clients keep requests in flight
    images, name = arg
    answered, failed = [], []
    stop = threading.Event()

    def client(k):
        while not stop.is_set():
            try:
                service.submit(images[k % len(images)])
                answered.append(time.monotonic())
            except Exception as e:
                failed.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    try:
        while len(answered) < 4 and not failed:
            threading.Event().wait(0.01)
        t0 = time.monotonic()
        result = service.reload_checkpoint(name)
        t1 = time.monotonic()
        n = len(answered)
        while len(answered) < n + 4 and not failed:
            threading.Event().wait(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    return {"reload": result, "failed": failed, "answered": len(answered),
            "answered_during": [t - t0 for t in answered if t0 < t < t1],
            "reload_s": t1 - t0, "after": service._run_images(list(images))}


SCENARIOS = {"train": _train, "gpt2_forward": _gpt2_forward,
             "legacy_step": _legacy_step, "serve": _serve}


def main(spec_path: str, rank: int) -> None:
    import torch

    from image_captioning_ml_project_tpu_torch.config import MeshConfig
    from image_captioning_ml_project_tpu_torch.parallel.mesh import (
        create_mesh, init_distributed)

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    init_distributed(rank=rank, world_size=spec["world"],
                     init_method=f"file://{spec['store']}", timeout_s=60)
    results = []
    try:
        for sc in spec["scenarios"]:
            dp, mp = sc["mesh"]
            mesh = create_mesh(MeshConfig(data_parallel=dp,
                                          model_parallel=mp))
            torch.manual_seed(0)
            results.append(SCENARIOS[sc["kind"]](sc, mesh))
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        with open(f"{spec_path}.out", "wb") as f:
            pickle.dump(results, f)
    print(json.dumps({"rank": rank, "scenarios": len(results)}))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
