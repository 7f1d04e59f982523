"""The knee sweep of a serving configuration: one service, open-loop
Poisson arrivals at each rate in turn, and for each the captions completed
per second, the median and 95th-percentile latency from when each request
was due, and whether a backlog grew (the requests still in flight when
the rate's window closed, and the mean latency of its last fifth against
its first).

    python3 portbench/knee.py --config flagship --traffic poisson \
        --rates 400 800 1200 --seconds 20 --seed 5

Run once, when a cell's rate is chosen; the rate is then frozen in the
cell's traffic file.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from portbench import loadgen, serve

    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "portbench", "configs",
                           args.config + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "portbench", "traffic",
                           args.traffic + ".json")) as f:
        traffic = json.load(f)
    built = serve.build(cfg, traffic, args.seed, torch.device("cuda", 0))
    service, image = built["service"], built["image"]
    for rate in args.rates:
        gc.collect()
        gc.freeze()
        t = dict(traffic, loop="open", rate_per_s=rate)
        ws = time.perf_counter() + t["ramp_s"]
        we = ws + args.seconds
        out = loadgen.run(t, lambda i: service.submit_async(image(i)),
                          args.seed, (ws, we), [])
        w = loadgen.in_window(out, ws, we, "due")
        lat = (out.done[w] - out.due[w]) * 1e3
        lat = lat[~np.isnan(lat)]
        done_in = loadgen.in_window(out, ws, we, "done")
        fifth = max(1, len(w) // 5)
        late = (out.sent - out.due)[w] * 1e3
        in_flight = int(((out.sent[:out.n] < we)
                         & ~(out.done[:out.n] < we)).sum())
        print(json.dumps({
            "rate_per_s": rate, "due": len(w),
            "completed_per_s": len(done_in) / args.seconds,
            "p50_ms": loadgen.percentile(list(lat), 50),
            "p95_ms": loadgen.percentile(list(lat), 95),
            "in_flight_at_close": in_flight,
            "mean_latency_first_fifth_ms": float(np.nanmean(
                (out.done - out.due)[w[:fifth]]) * 1e3),
            "mean_latency_last_fifth_ms": float(np.nanmean(
                (out.done - out.due)[w[-fifth:]]) * 1e3),
            "late_p99_ms": float(np.percentile(late, 99)),
            "late_max_ms": float(late.max())}), flush=True)
    service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
