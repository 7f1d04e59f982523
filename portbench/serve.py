"""A serving cell: the program's ``CaptionService`` under the traffic file's
load, its window timed on the host's clock, the traced run's part of the
window profiled, and a seeded sample of the window's captions judged
against the plain reference once the service is gone.
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import Dict

import numpy as np
import torch

from . import flops, loadgen, system, trace


def image_pool(n: int, size: int, seed: int, device) -> np.ndarray:
    """``n`` uint8 [size, size, 3] images from ``seed``, drawn on the
    device: a 7 x 7 grid of random colours (each cell a block of pixels)
    with +-16 of noise, so images differ where a patch encoder looks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cell = -(-size // 7)
    grid = torch.randint(0, 256, (n, 7, 7, 3), generator=gen, device=device,
                         dtype=torch.int16)
    img = grid.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    img = img[:, :size, :size]
    img = img + torch.randint(-16, 17, img.shape, generator=gen,
                              device=device, dtype=torch.int16)
    return img.clamp_(0, 255).to(torch.uint8).cpu().numpy()


class _Counters:
    """``ServerStats`` counters read at two marks."""

    KEYS = ("batches", "batched_rows", "decode_steps")

    def __init__(self, stats):
        self.stats = stats
        self.marks: Dict[str, Dict[str, float]] = {}

    def mark(self, name: str):
        self.marks[name] = dict(t=time.perf_counter(), **{
            k: getattr(self.stats, k) for k in self.KEYS})

    def delta(self, a: str, b: str) -> Dict[str, float]:
        return {k: self.marks[b][k] - self.marks[a][k]
                for k in ("t",) + self.KEYS}


def _spans(spans: trace.Spans, probes):
    """Ranges around the program's layers, and around each function a
    roofline reader of the cell wraps (``WRAPS``), recording the shapes
    of its calls (``shapes``)."""
    from image_captioning_ml_project_tpu_torch.inference import decoding
    from image_captioning_ml_project_tpu_torch.models import \
        captioning_model

    spans.wrap(decoding, "beam_search", "beam_search")
    spans.wrap(captioning_model.ImageCaptioningModel, "init_cache",
               "encode_and_condition")
    spans.wrap(captioning_model.ImageCaptioningModel, "step", "model_step")
    for p in probes:
        module, attr = p.WRAPS
        spans.wrap(importlib.import_module(module), attr, attr, p.shapes)


def build(cfg: dict, traffic: dict, seed: int, device, log=None) -> dict:
    """The weights and images drawn from ``seed``, and the program's
    service on them, started and warmed up on the shapes the traffic
    uses. ``log`` hears when each part of the set-up ended."""
    t0 = time.perf_counter()

    def done(what):
        if log is not None:
            log(f"set-up: {what} at {time.perf_counter() - t0:.3f} s")

    config = system.port_config(cfg)
    done("program imported")
    ids = cfg["ids"]
    vocab = system.file_value(cfg, "model.vocab_size")
    state = system.draw_state(config, seed, device)
    done("weights drawn")
    pool = image_pool(traffic["pool"], cfg["vision"]["image_size"], seed,
                      device)
    order = np.random.default_rng(seed).permutation(traffic["pool"])
    done("images drawn")
    tok = system.IdTokenizer(vocab, ids["bos"], ids["eos"])
    service = system.caption_service(config, state, tok, device,
                                     traffic["serve"])
    done("service built")
    service.start(warmup=traffic["warm"] == "buckets")
    done("service started")

    def pool_row(i):
        return order[i % len(order)]

    def image(i):
        return pool[pool_row(i)]

    for _ in range(traffic["warm_full_batches"]):
        for r in [service.submit_async(image(i))
                  for i in range(service.batch_size)]:
            r.event.wait()
    done("warmed up")
    return {"state": state, "tok": tok, "service": service, "image": image,
            "pool_row": pool_row}


def condition(cfg: dict, service, traffic: dict, pool_row, requests,
              image, device) -> dict:
    """The program's conditioning of the first ``condition_sample``
    distinct images of ``requests`` (``check`` module docstring), from its
    ``init_cache`` over a batch of the service's size filled with them
    in turn, as the service uploads a batch; kept on the host."""
    seen, rows = set(), []
    for i in requests:
        if pool_row(i) not in seen:
            seen.add(pool_row(i))
            rows.append(i)
    imgs = np.stack([image(i) for i in
                     rows[:cfg["correct"]["condition_sample"]]])
    batch = np.resize(imgs, (traffic["serve"]["batch_size"],)
                      + imgs.shape[1:])
    with torch.inference_mode():
        state = service.model.init_cache(torch.from_numpy(batch).to(device),
                                         cfg["decode"]["max_length"])
        cond = flops.config_module(cfg).program_condition(state)[
            :len(imgs)].cpu()
    return {"condition_images": imgs, "condition": cond}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
        device, t_process: float, log, probes=()) -> dict:
    """One run of a serving cell. Returns what the readers and the check
    take (``ctx``). ``probes``: the cell's readers that wrap a program
    function in the traced run."""
    dec, ids = cfg["decode"], cfg["ids"]
    log(f"set-up: the cell began {time.perf_counter() - t_process:.3f} s "
        f"after the process")
    sys_ = build(cfg, traffic, seed, device, log)
    service, tok, image = sys_["service"], sys_["tok"], sys_["image"]
    state = sys_["state"]

    # what set-up made is frozen out of the collector's reach, so a full
    # collection in the window walks only the window's own objects
    gc.collect()
    gc.freeze()
    counters = _Counters(service.stats)
    spans = trace.Spans()
    prof = {}
    ws = time.perf_counter() + traffic["ramp_s"]
    we = ws + seconds
    trace_s = min(traffic["trace_s"], seconds / 2) if traced else 0.0
    marks = [(ws, lambda: counters.mark("start")),
             (we - trace_s, lambda: counters.mark("end"))]
    if traced:
        # the profiler records the host ranges of the thread it runs on:
        # it starts and stops on the batcher thread, at a batch boundary
        from image_captioning_ml_project_tpu_torch.inference import server
        real = server.decode_images
        want = {}

        def traced_decode(*args, **kwargs):
            if want.get("stop") and "p" in prof and "events" not in prof:
                spans.active = False
                counters.mark("trace_end")
                prof["events"], prof["window_s"] = prof["p"].stop()
                spans.restore()
            elif want.get("start") and "p" not in prof:
                counters.mark("trace_start")
                prof["p"] = trace.Profile()
                prof["p"].start()
                spans.active = True
            if "p" in prof and "events" not in prof:
                with torch.profiler.record_function("batch_decode"):
                    return real(*args, **kwargs)
            return real(*args, **kwargs)

        server.decode_images = traced_decode

        def begin():
            _spans(spans, probes)
            want["start"] = True

        marks += [(we - trace_s, begin),
                  (we, lambda: want.update(stop=True))]

    def submit(i):
        return service.submit_async(image(i))

    out = loadgen.run(traffic, submit, seed, (ws, we), marks)
    gc.unfreeze()
    drained_at = time.perf_counter()
    if traced:
        server.decode_images = real
        if "p" in prof and "events" not in prof:
            spans.active = False
            counters.mark("trace_end")
            prof["events"], prof["window_s"] = prof["p"].stop()
            spans.restore()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    service.stop()
    d = counters.delta("start", "end")
    if d["batches"]:
        log(f"window: {d['batches']} batches, {d['batched_rows']} rows, "
            f"{d['decode_steps'] / d['batches']:.3f} decode steps a batch")
    by = "due" if traffic["loop"] == "open" else "done"
    window = loadgen.in_window(out, ws, we, by)
    answered = ~np.isnan(out.done[window]) & ~out.failed[window]
    ok = window[answered]
    attempted, failed = len(window), int((~answered).sum())
    if traffic["loop"] == "closed":
        # a request sent before the window closed and never answered fails
        lost = np.isnan(out.done[:out.n]) & (out.sent[:out.n] < we)
        failed += int(lost.sum())
        attempted = len(ok) + failed
    if traffic["loop"] == "closed" and len(ok):
        lat = (out.done[ok] - out.sent[ok]) * 1e3
        log(f"not judged: closed-loop latency p50 "
            f"{loadgen.percentile(list(lat), 50):.3f} ms, p95 "
            f"{loadgen.percentile(list(lat), 95):.3f} ms over {len(ok)}")
    late = (out.sent - out.due)[window]
    if len(late):
        log(f"load generator: {out.n} requests sent; in the window sent "
            f"after due by median {np.median(late) * 1e3:.3f} ms, "
            f"99th percentile {np.percentile(late, 99) * 1e3:.3f} ms, "
            f"at most {late.max() * 1e3:.3f} ms")

    rng = np.random.default_rng(seed)
    n = min(cfg["correct"]["sample"], len(ok))
    words = np.array([len(out.caption[i].split()) for i in ok])
    if len(ok):
        log(f"window: captions of {words.mean():.3f} words on average")
    pick = []
    if n:
        longest = int(np.argmax(words))
        rest = np.delete(np.arange(len(ok)), longest)
        pick = [longest] + list(rng.choice(rest, n - 1, replace=False))
    sample = {"images": np.stack([image(ok[j]) for j in pick])
              if pick else None,
              "served": np.asarray([tok.ids(out.caption[ok[j]],
                                            dec["max_length"], ids["pad"])
                                    for j in pick])}
    if pick:
        sample.update(condition(cfg, service, traffic, sys_["pool_row"],
                                [ok[j] for j in pick], image, device))
    del service, sys_
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"kind": "serve", "cfg": cfg, "traffic": traffic,
            "state": state, "sample": sample, "attempted": attempted,
            "failed": failed, "log": out, "window": window, "ok": ok,
            "ws": ws, "we": we, "drained_at": drained_at,
            "seconds": seconds, "setup_s": ws - t_process,
            "counters": counters, "spans": spans, "prof": prof,
            "memory_peak_bytes": memory_peak, "traced": traced}
