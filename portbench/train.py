"""A training cell: the program's ``CaptioningTrainer.train_step`` fed as
``main.train`` feeds it (host batches through ``data.pipeline.prefetch``),
its first three steps read for the check, then the window's steps timed on
the host's clock with a sync at the window's end.

Set-up builds one trainer from the seeded weights and drives it through
three steps on batches whose rows all differ; the same trainer then runs
the window. After the window the plain reference follows the same three
steps from the same weights (``reference.common.follow_steps``) and the
numbers in :func:`gaps` compare the two.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from . import system, trace
from .reference.common import cosine_lr, follow_steps, no_tf32
from .serve import image_pool

CHECKED_STEPS = 3


def host_batches(cfg: dict, traffic: dict, seed: int, device):
    """``traffic["batches"]`` distinct host batches of ``batch`` rows:
    seeded images and captions of GPT-2 ids (BOS, words drawn from the
    vocabulary past the specials, EOS, pads), their lengths a fixed set
    shuffled by the seed; the mask marks BOS through EOS."""
    B, T, n = traffic["batch"], traffic["caption_len"], traffic["batches"]
    ids = cfg["ids"]
    V = system.file_value(cfg, "model.vocab_size")
    images = image_pool(B * n, cfg["vision"]["image_size"], seed, device)
    rng = np.random.default_rng(seed)
    lo, hi = traffic["caption_words"]
    lengths = np.resize(np.arange(lo, hi + 1), B * n)
    rng.shuffle(lengths)
    words = rng.integers(3, V, size=(B * n, T))
    caps = np.full((B * n, T), ids["pad"], dtype=np.int64)
    mask = np.zeros((B * n, T), dtype=np.int64)
    for r, m in enumerate(lengths):
        caps[r, 0] = ids["bos"]
        caps[r, 1:m + 1] = words[r, :m]
        caps[r, m + 1] = ids["eos"]
        mask[r, :m + 2] = 1
    return [{"image": images[i * B:(i + 1) * B],
             "caption_tokens": caps[i * B:(i + 1) * B],
             "attention_mask": mask[i * B:(i + 1) * B]} for i in range(n)]


def trainer_config(cfg: dict, traffic: dict):
    config = system.port_config(cfg)
    tc = config.training
    tc.batch_size = traffic["batch"]
    tc.num_epochs = 1
    tc.warmup_steps = traffic["warmup_steps"]
    tc.learning_rate = traffic["learning_rate"]
    tc.lr_scheduler = traffic["lr_scheduler"]
    tc.weight_decay = traffic["weight_decay"]
    tc.use_rl = False
    config.model.decoder.dropout = traffic["dropout"]
    return config


class _Data:
    """What the trainer reads of a dataset before its first epoch: the
    number of rows, which fixes the schedule's horizon."""

    def __init__(self, rows: int):
        self.rows = rows

    def __len__(self):
        return self.rows


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
        device, t_process: float, log, probes=()) -> dict:
    from image_captioning_ml_project_tpu_torch.data.pipeline import prefetch
    from image_captioning_ml_project_tpu_torch.train.trainer import \
        CaptioningTrainer

    log(f"set-up: the cell began {time.perf_counter() - t_process:.3f} s "
        f"after the process")
    t0 = time.perf_counter()

    def done(what):
        log(f"set-up: {what} at {time.perf_counter() - t0:.3f} s")

    config = trainer_config(cfg, traffic)
    done("program imported")
    state = system.draw_state(config, seed, device)
    done("weights drawn")
    batches = host_batches(cfg, traffic, seed, device)
    done("batches drawn")
    rows = traffic["batch"] * traffic["schedule_steps"]
    tok = system.IdTokenizer(system.file_value(cfg, "model.vocab_size"),
                             cfg["ids"]["bos"], cfg["ids"]["eos"])
    trainer = CaptioningTrainer(config, _Data(rows), None, tok,
                                device=device, state_dict=state)

    def feed():
        i = 0
        while True:
            yield batches[i % len(batches)]
            i += 1

    stream = prefetch(feed(), device)
    done("trainer built")

    def step():
        b = next(stream)
        return trainer.train_step(b["image"], b["caption_tokens"],
                                  b["attention_mask"])

    # the checked steps: losses, the first gradient from AdamW's first
    # moment after one step, the change of each leaf after three
    b1 = trainer.optimizer.b1
    losses, grads = [], None
    for i in range(CHECKED_STEPS):
        losses.append(float(step()["total_loss"]))
        if i == 0:
            grads = {k[len("model."):]: m.float().norm() / (1 - b1)
                     for k, m in trainer.optimizer.mu.items()
                     if k.startswith("model.")}
    params = dict(trainer.model.named_parameters())
    # the change of every entry, kept on the host through the window
    deltas = {k: (params[k].detach() - state[k].float()).cpu()
              for k in params}
    program = {"losses": losses, "grad_norms":
               {k: float(v) for k, v in grads.items()}, "deltas": deltas}
    done(f"{CHECKED_STEPS} checked steps run")

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    n_steps = n_traced = 0
    prof = {}
    ws = time.perf_counter()
    we = ws + seconds
    trace_from = we - (min(traffic["trace_s"], seconds / 2) if traced else 0)
    profiler = None
    while time.perf_counter() < we:
        if traced and profiler is None and time.perf_counter() >= trace_from:
            profiler = trace.Profile()
            profiler.start()
        step()
        n_steps += 1
        n_traced += profiler is not None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    if profiler is not None:
        prof["events"], prof["window_s"] = profiler.stop()
    peak_window = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    stream.close()
    del trainer, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"kind": "train", "cfg": cfg, "traffic": traffic, "state": state,
            "batches": batches[:CHECKED_STEPS], "program": program,
            "attempted": n_steps, "failed": 0, "steps": n_steps,
            "steps_traced": n_traced, "elapsed_s": t_end - ws,
            "seconds": seconds, "setup_s": ws - t_process,
            "memory_peak_bytes": peak_window, "peak_window_bytes": peak_window,
            "prof": prof, "traced": traced,
            "total_steps": traffic["schedule_steps"]}


def reference_steps(ctx: dict, device, precision: str = "f32",
                    rows: slice = slice(None)) -> dict:
    """The reference's three steps on the checked batches."""
    from .check import reference

    no_tf32()
    tr = ctx["traffic"]
    ref = reference(ctx["cfg"], ctx["state"], precision)
    batches = [(torch.from_numpy(b["image"]).to(device),
                torch.from_numpy(b["caption_tokens"]).to(device),
                torch.from_numpy(b["attention_mask"]).to(device))
               for b in ctx["batches"]]
    return follow_steps(
        ref, batches,
        lambda s: cosine_lr(tr["learning_rate"], ctx["total_steps"], s),
        tr["weight_decay"], tr["reference_block"], rows)


def gaps(side: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of one side's three steps against the
    reference's (``side["deltas"]`` and ``ref["grads"]``/``["deltas"]``
    hold tensors by leaf):

    * ``grad_norm_gap``: by the worst leaf, the gap between the two sides'
      norms of the first gradient, against the reference's norm of that
      leaf or of the median leaf, whichever is larger;
    * ``update_norm_gap``: the same of the change over the three steps.
      Entries whose reference gradient is under a thousandth of the median
      leaf's (its norm over the square root of its size: the typical
      entry) are left out: they move under Adam by round-off alone, as a
      key's bias under softmax does. The program fuses the q, k and v
      biases into one leaf, so the rule goes by entry, not by leaf.

    Read and not compared (``PERF.md`` gives the readings): the first
    step's loss, relative (``first_loss_gap``: the control does not read
    three times the program's), and the widest of the later steps'
    (``later_loss_gap``: under bf16 they move with the round-off of the
    first updates)."""
    rl, sl = ref["losses"], side["losses"]
    g = {k: v.float() for k, v in ref["grads"].items()}
    gn = {k: float(v.norm()) for k, v in g.items()}
    med_g = float(np.median(list(gn.values())))
    grad = max(abs(side["grad_norms"][k] - n) / max(n, med_g)
               for k, n in gn.items())
    typical = float(np.median([gn[k] / v.numel() ** 0.5
                               for k, v in g.items()]))
    dp, dr = {}, {}
    for k, v in g.items():
        keep = v.abs() >= 1e-3 * typical
        if bool(keep.any()):
            dr[k] = float(ref["deltas"][k][keep].norm())
            dp[k] = float(side["deltas"][k].to(v.device)[keep].norm())
    med_d = float(np.median(list(dr.values())))
    delta = max(abs(dp[k] - d) / max(d, med_d) for k, d in dr.items())
    return {"grad_norm_gap": grad, "update_norm_gap": delta,
            "diagnostic": {
                "first_loss_gap": abs(sl[0] - rl[0]) / abs(rl[0]),
                "later_loss_gap": max(abs(a - b) / abs(b)
                                      for a, b in zip(sl[1:], rl[1:]))}}


def side_of(steps: dict) -> dict:
    """A reference's three steps read as one side (a control or a
    fault): its losses, first-gradient norms and changes."""
    return {"losses": steps["losses"], "deltas": steps["deltas"],
            "grad_norms": {k: float(v.norm())
                           for k, v in steps["grads"].items()}}


def compared(ctx: dict, device) -> Dict[str, float]:
    return gaps(ctx["program"], reference_steps(ctx, device))
