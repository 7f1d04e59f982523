"""Where the served slice's time goes, on one GPU.

Run from the repository root on a machine with a CUDA GPU::

    python -m image_captioning_ml_project_tpu_torch.profile_slice \\
        [--config flagship|transformer|lstm|qformer|butd]
        [--encoder_type resnet|vit|swin|clip] [--attention_type TYPE]
        [--seed N] [--trace PATH] [--train [--scst]]

It decodes synthetic uint8 images through a served model, bf16 weights
drawn from ``--seed``: ``flagship`` (the default;
:func:`.main.flagship_config`: CLIP ViT-B/32 + GPT-2 12 layers, width 768,
vocab 50257), ``transformer`` (:func:`.main.transformer_config`: ViT-B/16
+ 6-layer Transformer decoder, width 768, vocab 30000) or ``lstm``
(:func:`.main.lstm_config`: ResNet-101 + 6-layer LSTM, width 512, vocab
10000, soft attention through its kernel, or the ``--attention_type``
variant), ``qformer`` (:func:`.main.qformer_config`: ViT-B/16 + a
32-query Q-Former + the 6-layer Transformer decoder) or ``butd``
(:func:`.main.butd_config`: 36 random detector regions of 2048-d features,
20 to 36 of them valid an image, + the same decoder); ``--encoder_type``
replaces the configuration's encoder (``--config transformer
--encoder_type swin``: Swin-B), beam 5, max length 20, directly through
``encode``/``init_cache``/``beam_search``, without the server, on the
configuration the JAX package's switches select. For the flagship these
are ``ICT_DECODE_STACK``, ``ICT_DECODE_FOLD`` and ``ICT_ENCODER_FOLD`` (by
default the whole-stack decode and the encoder fold; all three ``0`` give
the split configuration); for the Transformer decoder ``ICT_DECODE_FOLD``
alone (fold by default, split at ``0``); the LSTM reads none. It
prints:

0. the configuration profiled: the switches and the decode path and
   encoder they select;

1. for batches of 1, 8 and 64: the host wall time of the encode, the
   prefix forward or memory projection (``init_cache``) and the beam
   loop, each with the device synchronised, as medians of 7 runs after 2
   warm-up runs, with the total and images/s;
2. one ``model.step`` at batches 1, 8 and 64 (5, 40 and 320 beam rows):
   the host time to enqueue it, and the time with the device synchronised
   (median of 20);
3. ``torch.profiler`` over one batch of 64: the device busy time (the sum of
   the kernels' self device times), the number of kernel launches (in all
   and per decode step), and the kernels ranked by device time; ``--trace``
   writes the Chrome trace.

With ``--train`` it profiles a cross-entropy training step of the
configuration instead (:class:`.train.trainer.CaptioningTrainer`, bf16
compute over f32 masters, batch 64 of random images and caption ids of
the decoder's ``max_length``, dropout as configured): the step's wall
time with the device synchronised and its host enqueue time (median of
10 after 3 warm-up steps), its forward with the loss, backward and AdamW
update timed apart, and ``torch.profiler`` over one step as in 3. With
``--train --scst`` it profiles an SCST step instead (``scst_fused_step``,
bf16, batch 64 of random images, 5 random references an image and their
document frequencies): the step's wall time (median of 5 after 2 warm-up
steps), its rollouts, rewards and update timed apart, the launches of
#5 and #3 a step, and ``torch.profiler`` over one step.

The card's name, power limit and SM clock (``nvidia-smi``) open and close
the output.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .config import AttentionType, DecoderType, EncoderType, reads_regions
from .inference.decoding import _tile_state, batch_size_of, beam_search
from .main import CONFIGS
from .models.captioning_model import load_model
from .models.gpt2 import decode_fold_enabled
from .models.encoders import encoder_fold_enabled
from .models.gpt2 import decode_path


def model_inputs(cfg, batch: int, generator: torch.Generator):
    """Random inputs of ``batch`` images on the CPU: uint8 NHWC pixels, or
    in the object-region mode detector regions (20 to ``max_objects`` of
    them valid an image, as the JAX package's ``bench_families.py``
    draws them)."""
    if reads_regions(cfg.model.encoder):
        e = cfg.model.encoder
        n = e.max_objects
        counts = torch.randint(20, n + 1, (batch, 1), generator=generator)
        return {"region_features": torch.randn(
                    batch, n, e.region_feature_dim, generator=generator),
                "region_boxes": torch.rand(batch, n, 4, generator=generator),
                "region_mask": torch.arange(n)[None] < counts}
    return torch.randint(0, 256, (batch, cfg.image_size, cfg.image_size, 3),
                         generator=generator, dtype=torch.uint8)


def move_inputs(inputs, dev):
    """Model inputs (a tensor or a region dict) on ``dev``."""
    if isinstance(inputs, dict):
        return {k: v.to(dev) for k, v in inputs.items()}
    return inputs.to(dev)


def first_inputs(inputs, B: int):
    """The first ``B`` images of model inputs."""
    if isinstance(inputs, dict):
        return {k: v[:B] for k, v in inputs.items()}
    return inputs[:B]


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
        beam_search(step_fn, state, batch_size_of(images), ic.beam_size,
                    mc.bos_token_id, mc.eos_token_id, mc.pad_token_id,
                    ic.max_length, length_penalty=ic.length_penalty,
                    min_length=ic.min_length).tokens.cpu()
        t3 = time.perf_counter()
    return t1 - t0, t2 - t1, t3 - t2, steps


def time_batches(model, cfg, images, sizes=(1, 8, 64), runs=7):
    for B in sizes:
        for _ in range(2):
            _decode(model, cfg, first_inputs(images, B))
        rs = [_decode(model, cfg, first_inputs(images, B))
              for _ in range(runs)]
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


def _step_state(model, cfg, images, pos):
    """A tiled decode state at suffix position ``pos`` under an identity
    ancestry, and the step's tokens."""
    ic = cfg.inference
    Bk = batch_size_of(images) * ic.beam_size
    dev = model.decoder.output_layer.weight.device
    state = _tile_state(model.init_cache(images, ic.max_length),
                        ic.beam_size)
    if "lazy" in state:  # the LSTM's state has neither
        state["lazy"]["ancestry"] = torch.arange(
            Bk, device=dev, dtype=torch.int32)[:, None].repeat(
                1, ic.max_length)
        state["pos"] = pos
    tokens = torch.full((Bk,), cfg.model.bos_token_id, dtype=torch.long,
                        device=dev)
    return state, tokens


def time_step(model, cfg, images, pos=5, runs=20):
    """One decode step at suffix position ``pos`` over all beam rows, under
    an identity ancestry; the step re-appends at ``pos`` each run."""
    B = batch_size_of(images)
    Bk = B * cfg.inference.beam_size
    with torch.inference_mode():
        state, tokens = _step_state(model, cfg, images, pos)
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
    print(f"model.step B={B} ({Bk} rows) pos={pos}: host "
          f"enqueue median {enqueue * 1e3:.3f} ms, with sync "
          f"{synced * 1e3:.3f} ms", flush=True)


def configuration(cfg) -> str:
    if cfg.model.decoder.decoder_type == DecoderType.LSTM:
        att = cfg.model.attention
        kernel = ("additive_scores" if att.attention_type == AttentionType.SOFT
                  or (att.num_heads == 1
                      and att.attention_type != AttentionType.MULTI_HEAD)
                  else "sdpa")
        return (f"configuration: ResNet encoder (PyTorch modules, cuDNN "
                f"convolutions) -> LSTM, {att.attention_type.value} "
                f"attention, use_pallas={att.use_pallas} -> "
                f"{kernel + ' kernel' if att.use_pallas else 'plain ops'} "
                f"per step")
    if cfg.model.decoder.decoder_type == DecoderType.TRANSFORMER:
        fold = decode_fold_enabled()
        enc = cfg.model.encoder
        encoder = ("object-region encoder" if reads_regions(enc)
                   else f"{enc.encoder_type.value} encoder")
        if cfg.model.use_q_former:
            encoder += (f" + Q-Former of {cfg.model.q_former_num_queries} "
                        f"queries")
        return (f"configuration: ICT_DECODE_FOLD="
                f"{os.environ.get('ICT_DECODE_FOLD', '1')} -> Transformer "
                f"decoder, self-attention "
                f"{'fold' if fold else 'split'} + cross-attention kernel "
                f"per layer; {encoder} (PyTorch modules, no fold)")
    switches = " ".join(f"{k}={os.environ.get(k, '1')}" for k in (
        "ICT_DECODE_STACK", "ICT_DECODE_FOLD", "ICT_ENCODER_FOLD"))
    encoder = ("whole-stack encoder kernel" if encoder_fold_enabled()
               else "per-layer CLIP modules")
    return (f"configuration: {switches} -> decode path {decode_path()}, "
            f"{encoder}")


def profile_batch(model, cfg, images, trace=None):
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps = _decode(model, cfg, images)[3]
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    with torch.inference_mode():
        state, tokens = _step_state(model, cfg, images, pos=5)
        model.step(state, tokens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as step_prof:
            model.step(state, tokens)
            torch.cuda.synchronize()
    per_step = sum(e.count for e in step_prof.key_averages()
                   if e.self_device_time_total > 0)
    print(f"profiled B={batch_size_of(images)}: wall {wall * 1e3:.1f} ms "
          f"(profiler on); device busy {busy * 1e3:.2f} ms "
          f"({100 * busy / wall:.1f}% of that wall); kernel launches "
          f"{launches} over {steps} decode steps ({launches / steps:.0f} "
          f"per step, encode and prefix forward included); one model.step "
          f"alone launches {per_step} kernels", flush=True)
    print(events.table(sort_by="self_cuda_time_total", row_limit=25,
                       max_name_column_width=70), flush=True)
    if trace:
        prof.export_chrome_trace(trace)
        print(f"trace written to {trace}", flush=True)


def _median_ms(fn, runs):
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def profile_train(cfg, dev, seed, batch=64, trace=None):
    """The ``--train`` profile (module docstring)."""
    from .models.layers import dropout_generator
    from .train.trainer import CaptioningTrainer

    cfg.training.use_amp, cfg.training.batch_size = True, batch
    cfg.training.use_rl = False
    cfg.output_dir = cfg.checkpoint_dir = os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "profile_train")
    trainer = CaptioningTrainer(cfg, [None] * batch, [], None, device=dev)
    g = torch.Generator().manual_seed(seed)
    T = cfg.model.decoder.max_length
    images = move_inputs(model_inputs(cfg, batch, g), dev)
    caps = torch.randint(4, cfg.model.vocab_size, (batch, T), generator=g,
                         dtype=torch.int32).to(dev)
    mask = torch.ones((batch, T), dtype=torch.int32, device=dev)

    def step():
        trainer.train_step(images, caps, mask)

    for _ in range(3):
        step()
    wall = _median_ms(step, 10)
    enqueue = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        enqueue.append(time.perf_counter() - t0)
    params = trainer._named_params()
    drop_gen, itm_gen = trainer._step_generators(trainer.step)
    holder = {}

    def forward():
        for p in params.values():
            p.grad = None
        with torch.enable_grad(), dropout_generator(drop_gen):
            holder["loss"] = trainer._forward_loss(
                images, caps, mask, itm_gen)["total_loss"]

    def backward():
        holder["loss"].backward()

    fwd, bwd = [], []
    for _ in range(5):
        fwd.append(_median_ms(forward, 1))
        bwd.append(_median_ms(backward, 1))
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    opt = _median_ms(lambda: trainer.optimizer.step(grads), 5)
    print(f"train step B={batch} (bf16 compute, f32 masters, T={T}): "
          f"{wall:.2f} ms with sync (median of 10), host enqueue "
          f"{statistics.median(enqueue) * 1e3:.2f} ms; forward + loss "
          f"{statistics.median(fwd):.2f} ms, backward "
          f"{statistics.median(bwd):.2f} ms, AdamW "
          f"{opt:.2f} ms (each synchronised); {batch / wall * 1e3:.1f} "
          f"images/s", flush=True)
    _profile_step(step, "train step", trace)


def _profile_step(step, what, trace=None):
    """``torch.profiler`` over one call of ``step``: its wall time, the
    device busy time, the kernel launches and the operations ranked by
    device time; ``trace`` receives the Chrome trace."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"profiled {what}: wall {wall * 1e3:.1f} ms (profiler on); "
          f"device busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% of "
          f"that wall); kernel launches "
          f"{sum(e.count for e in kernels)}", flush=True)
    print(events.table(sort_by="self_cuda_time_total", row_limit=30,
                       max_name_column_width=70), flush=True)
    if trace:
        prof.export_chrome_trace(trace)
        print(f"trace written to {trace}", flush=True)


def profile_scst(cfg, dev, seed, batch=64, trace=None):
    """The ``--train --scst`` profile (module docstring)."""
    from .evaluate.cider_device import build_df_table, encode_references
    from .ops.beam_decode_stack import beam_decode_stack
    from .ops.encoder_stack import encoder_stack
    from .train.trainer import CaptioningTrainer

    cfg.training.use_amp, cfg.training.batch_size = True, batch
    cfg.output_dir = cfg.checkpoint_dir = os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "profile_scst")
    trainer = CaptioningTrainer(cfg, [None] * batch, [], None, device=dev)
    g = torch.Generator().manual_seed(seed)
    mc = cfg.model
    images = move_inputs(model_inputs(cfg, batch, g), dev)
    # 5 references of 8-16 random words an image, their document
    # frequencies over the batch
    refs = [[torch.randint(4, mc.vocab_size, (int(n),), generator=g).tolist()
             for n in torch.randint(8, 17, (5,), generator=g)]
            for _ in range(batch)]
    specials = (mc.pad_token_id, mc.bos_token_id, mc.eos_token_id)
    trainer._cider_df = build_df_table(refs, special_ids=specials,
                                       device=dev)
    ref_tokens, ref_valid = encode_references(refs, 5,
                                              mc.decoder.max_length)
    parts = {"rollouts": [], "rewards": [], "update": []}
    state = {}

    def rollouts():
        state["rollouts"] = trainer.rollout_step(
            trainer.rollout_model(), images,
            trainer._rollout_generator(trainer.step))

    def rewards():
        sampled, _, greedy = state["rollouts"]
        state["adv"] = trainer.scst_rewards(sampled, greedy, ref_tokens,
                                            ref_valid)[2]

    def update():
        sampled, mask, _ = state["rollouts"]
        trainer.rl_update_step(images, sampled, mask, state["adv"])

    def step():
        trainer.scst_fused_step(images, ref_tokens, ref_valid)

    for _ in range(2):
        step()
    wall = _median_ms(step, 5)
    for _ in range(5):
        for name, fn in (("rollouts", rollouts), ("rewards", rewards),
                         ("update", update)):
            parts[name].append(_median_ms(fn, 1))
    ms = {k: statistics.median(v) for k, v in parts.items()}
    before = (encoder_stack.launches, beam_decode_stack.launches)
    step()
    torch.cuda.synchronize()
    print(f"scst step B={batch} (bf16, device CIDEr, max length "
          f"{cfg.inference.max_length}): {wall:.2f} ms with sync (median "
          f"of 5), {batch / wall * 1e3:.1f} images/s; timed apart rollouts "
          f"{ms['rollouts']:.2f} ms, rewards {ms['rewards']:.2f} ms, update "
          f"{ms['update']:.2f} ms (each synchronised); kernels a step: "
          f"encoder_stack {encoder_stack.launches - before[0]}, "
          f"beam_decode_stack {beam_decode_stack.launches - before[1]}",
          flush=True)
    _profile_step(step, "scst step", trace)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", choices=sorted(CONFIGS),
                        default="flagship")
    parser.add_argument("--encoder_type", default=None,
                        choices=["resnet", "vit", "swin", "clip"],
                        help="replace the configuration's encoder (as the "
                             "CLI's --encoder_type does)")
    parser.add_argument("--attention_type", default=None,
                        choices=["soft", "multi_head", "adaptive", "aoa"],
                        help="the LSTM's attention variant (default: the "
                             "configuration's)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trace", type=str, default=None,
                        help="write the profiled batch's Chrome trace here")
    parser.add_argument("--train", action="store_true",
                        help="profile a bf16 cross-entropy training step "
                             "of batch 64 instead of the decode")
    parser.add_argument("--scst", action="store_true",
                        help="with --train: profile a bf16 SCST step "
                             "(rollouts, device CIDEr, update) instead")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_slice: no CUDA device")
    card = _card()
    print(card, flush=True)
    cfg = CONFIGS[args.config]()
    if args.encoder_type:
        cfg.model.encoder.encoder_type = EncoderType(args.encoder_type)
    if args.attention_type:
        cfg.model.attention.attention_type = AttentionType(
            args.attention_type)
    print(f"{args.config}: {configuration(cfg)}", flush=True)
    cfg.seed = args.seed
    dev = torch.device("cuda:0")
    if args.scst and not args.train:
        parser.error("--scst profiles a training step: add --train")
    if args.train:
        (profile_scst if args.scst else profile_train)(
            cfg, dev, args.seed, trace=args.trace)
        print(card, flush=True)
        return
    model = load_model(cfg, dev)
    g = torch.Generator().manual_seed(args.seed)
    images = move_inputs(model_inputs(cfg, 64, g), dev)
    time_batches(model, cfg, images)
    for B in (1, 8, 64):
        time_step(model, cfg, first_inputs(images, B))
    profile_batch(model, cfg, images, args.trace)
    print(card, flush=True)


if __name__ == "__main__":
    main()
