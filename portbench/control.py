"""The correctness control of a cell, on the card at the cell's own size:
the plain reference with its dense products in fp8 (the step below the
bf16 the configuration states) put in the program's place, judged by the
same numbers as a run's.

    python3 portbench/control.py --config flagship --seeds 11 12 13
    python3 portbench/control.py --config flagship --traffic train_ce \
        --seeds 11 12 13

Serving: each seed draws the weights and image pool a run of that seed
draws, and a sample of the size a run compares. The program runs on
them at the cell's batch (``--batch``): its captions from
``decode_images`` (the function each of a service's batches goes
through) and its conditioning from ``init_cache``, read as a sound run
reads them (``program``), and its conditioning with a fault planted
(``encoder_zero``: the encoder's output zeroed; ``row_swap``: each row
conditioned on the next row's image). The control (``fp8``) is read on
the same images and the program's served tokens (``check.control``) and
by its conditioning. Training: each seed draws the weights and batches
a run draws; the control's three steps, and the fault of a step over
half of its batch (the reference, on half the rows), are held against
the float32 reference's. One JSON line per seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def program_readings(cfg: dict, state, images, batch: int,
                     device) -> dict:
    """The program's captions of ``images`` and its conditioning of the
    first ``condition_sample`` of them, sound and with each fault, from
    batches of ``batch`` rows filled with the images in turn."""
    import numpy as np
    import torch

    from image_captioning_ml_project_tpu_torch.inference.decoding import \
        decode_images
    from image_captioning_ml_project_tpu_torch.models.captioning_model \
        import ImageCaptioningModel, load_model
    from portbench import check, flops, system

    config = system.port_config(cfg)
    model = load_model(config, device, state_dict=state)
    m = cfg["correct"]["condition_sample"]
    cond = flops.config_module(cfg).program_condition
    L = cfg["decode"]["max_length"]

    def full(imgs):
        return torch.from_numpy(np.resize(imgs, (batch,) + imgs.shape[1:])
                                ).to(device)

    def zero_encode(images):
        f = ImageCaptioningModel.encode(model, images)
        return {k: torch.zeros_like(v) if v.is_floating_point() else v
                for k, v in f.items()}

    with torch.inference_mode():
        served = torch.cat([decode_images(model, full(images[lo:lo + batch]),
                                          config)
                            for lo in range(0, len(images), batch)])
        served = served[:len(images)].cpu().numpy()
        x = full(images[:m])
        sides = {"program": cond(model.init_cache(x, L))[:m].cpu(),
                 "row_swap": cond(model.init_cache(x.roll(1, 0), L))[:m]
                 .cpu()}
        model.encode = zero_encode
        sides["encoder_zero"] = cond(model.init_cache(x, L))[:m].cpu()
    del model, x
    torch.cuda.empty_cache()
    out = {k: check.condition_gaps(cfg, state, images[:m], v, device)
           for k, v in sides.items()}
    out["program"].update(check.numbers(cfg, state, images, served, device))
    return out, served


def readings(cfg: dict, seed: int, pool: int, device,
             batch: int = 512) -> dict:
    """The program's numbers and the faults' (:func:`program_readings`),
    and the control's (``fp8``) on the program's served tokens."""
    import numpy as np

    from portbench import check, serve, system

    state = system.draw_state(system.port_config(cfg), seed, device)
    images = serve.image_pool(pool, cfg["vision"]["image_size"], seed,
                              device)
    pick = np.random.default_rng(seed).choice(
        pool, cfg["correct"]["sample"], replace=False)
    images = images[pick]
    t0 = time.perf_counter()
    out, served = program_readings(cfg, state, images, batch, device)
    fp8 = check.control(cfg, state, images, served, device)
    m = cfg["correct"]["condition_sample"]
    low = check.reference_condition(cfg, state, images[:m], device, "fp8")
    fp8.update(check.condition_gaps(cfg, state, images[:m], low, device))
    out["fp8"] = fp8
    return dict(out, seed=seed, seconds=time.perf_counter() - t0)


def train_readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    from portbench import system, train

    config = train.trainer_config(cfg, traffic)
    ctx = {"cfg": cfg, "traffic": traffic,
           "state": system.draw_state(config, seed, device),
           "batches": train.host_batches(cfg, traffic, seed, device)[
               :train.CHECKED_STEPS],
           "total_steps": traffic["schedule_steps"]}
    t0 = time.perf_counter()
    ref = train.reference_steps(ctx, device)
    low = train.reference_steps(ctx, device, "fp8")
    half = train.reference_steps(ctx, device,
                                 rows=slice(0, traffic["batch"] // 2))
    return {"seed": seed, "fp8": train.gaps(train.side_of(low), ref),
            "half_batch": train.gaps(train.side_of(half), ref),
            "reference_losses": ref["losses"],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--traffic", default=None)
    ap.add_argument("--pool", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=512,
                    help="the program's batch (serving)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "portbench", "configs",
                           args.config + ".json")) as f:
        cfg = json.load(f)
    device = torch.device("cuda", 0)
    traffic = None
    if args.traffic:
        with open(os.path.join(ROOT, "portbench", "traffic",
                               args.traffic + ".json")) as f:
            traffic = json.load(f)
    for seed in args.seeds:
        got = (train_readings(cfg, traffic, seed, device) if traffic
               else readings(cfg, seed, args.pool, device, args.batch))
        print(json.dumps(dict(got, config=args.config, control="fp8")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
