"""Where the served slice's time goes, on one GPU.

Run from the repository root on a machine with a CUDA GPU::

    python -m image_captioning_ml_project_tpu_torch.profile_slice \\
        [--seed N] [--trace PATH]

It decodes synthetic uint8 images through the flagship model
(:func:`.main.flagship_config`: CLIP ViT-B/32 + GPT-2 12 layers, width 768,
vocab 50257, beam 5, max length 20, bf16 weights drawn from ``--seed``)
directly through ``encode``/``init_cache``/``beam_search``, without the
server, and prints:

1. for batches of 1, 8 and 64: the host wall time of the CLIP encode, the
   prefix forward (``init_cache``) and the beam loop, each with the device
   synchronised, as medians of 7 runs after 2 warm-up runs, with the
   total and images/s;
2. one ``model.step`` at batch 64 (320 beam rows): the host time to enqueue
   it, and the time with the device synchronised (median of 20);
3. ``torch.profiler`` over one batch of 64: the device busy time (the sum of
   the kernels' self device times), the number of kernel launches, and the
   kernels ranked by device time; ``--trace`` writes the Chrome trace.

The card's name, power limit and SM clock (``nvidia-smi``) open and close
the output.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .inference.decoding import _tile_state, beam_search
from .main import flagship_config
from .models.captioning_model import load_model


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _decode(model, cfg, images):
    """One batch -> (encode s, init_cache s, beam loop s, decode steps)."""
    mc, ic = cfg.model, cfg.inference
    steps = 0

    def step_fn(state, tokens):
        nonlocal steps
        steps += 1
        return model.step(state, tokens)

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        features = model.encode(images)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = model.decoder.init_cache(features, ic.max_length)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        beam_search(step_fn, state, images.shape[0], ic.beam_size,
                    mc.bos_token_id, mc.eos_token_id, mc.pad_token_id,
                    ic.max_length, length_penalty=ic.length_penalty,
                    min_length=ic.min_length).tokens.cpu()
        t3 = time.perf_counter()
    return t1 - t0, t2 - t1, t3 - t2, steps


def time_batches(model, cfg, images, sizes=(1, 8, 64), runs=7):
    for B in sizes:
        for _ in range(2):
            _decode(model, cfg, images[:B])
        rs = [_decode(model, cfg, images[:B]) for _ in range(runs)]
        enc, pre, loop = (statistics.median(r[i] for r in rs)
                          for i in range(3))
        totals = [sum(r[:3]) for r in rs]
        total = statistics.median(totals)
        steps = rs[0][3]
        print(f"B={B}: encode {enc * 1e3:.2f} ms, prefix/init_cache "
              f"{pre * 1e3:.2f} ms, beam loop {loop * 1e3:.2f} ms ({steps} "
              f"steps, {loop * 1e3 / steps:.3f} ms/step); total median "
              f"{total * 1e3:.2f} ms, runs "
              f"{[round(t * 1e3, 1) for t in totals]} ms; "
              f"{B / total:.1f} images/s", flush=True)


def time_step(model, cfg, images, pos=5, runs=20):
    """One decode step at suffix position ``pos`` over all beam rows, under
    an identity ancestry; the step re-appends at ``pos`` each run."""
    ic = cfg.inference
    Bk = images.shape[0] * ic.beam_size
    with torch.inference_mode():
        state = _tile_state(model.init_cache(images, ic.max_length),
                            ic.beam_size)
        state["lazy"]["ancestry"] = torch.arange(
            Bk, device=images.device, dtype=torch.int32)[:, None].repeat(
                1, ic.max_length)
        state["pos"] = pos
        tokens = torch.full((Bk,), cfg.model.bos_token_id, dtype=torch.long,
                            device=images.device)
        times = []
        for _ in range(3 + runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.step(state, tokens)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times.append((t1 - t0, time.perf_counter() - t0))
    enqueue = statistics.median(t[0] for t in times[3:])
    synced = statistics.median(t[1] for t in times[3:])
    print(f"model.step B={images.shape[0]} ({Bk} rows) pos={pos}: host "
          f"enqueue median {enqueue * 1e3:.3f} ms, with sync "
          f"{synced * 1e3:.3f} ms", flush=True)


def profile_batch(model, cfg, images, trace=None):
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _decode(model, cfg, images)
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    print(f"profiled B={images.shape[0]}: wall {wall * 1e3:.1f} ms "
          f"(profiler on); device busy {busy * 1e3:.2f} ms "
          f"({100 * busy / wall:.1f}% of that wall); kernel launches "
          f"{launches}", flush=True)
    print(events.table(sort_by="self_cuda_time_total", row_limit=25,
                       max_name_column_width=70), flush=True)
    if trace:
        prof.export_chrome_trace(trace)
        print(f"trace written to {trace}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trace", type=str, default=None,
                        help="write the profiled batch's Chrome trace here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_slice: no CUDA device")
    card = _card()
    print(card, flush=True)
    cfg = flagship_config()
    cfg.seed = args.seed
    dev = torch.device("cuda:0")
    model = load_model(cfg, dev)
    g = torch.Generator().manual_seed(args.seed)
    images = torch.randint(0, 256, (64, cfg.image_size, cfg.image_size, 3),
                           generator=g, dtype=torch.uint8).to(dev)
    time_batches(model, cfg, images)
    time_step(model, cfg, images)
    profile_batch(model, cfg, images, args.trace)
    print(card, flush=True)


if __name__ == "__main__":
    main()
