#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``image_captioning_ml_project_tpu_torch``).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N]

Phases, each reported on its own lines; any failure exits non-zero and
prints no result line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 and bf16 reduced-precision GEMM reductions off for the
   comparisons;
2. build: compiles the four ``csrc/*.cu`` libraries with nvcc from the
   checkout, one process each, all started together, and prints ptxas's
   register and spill lines (the Triton kernel compiles at its first
   launch);
3. kernels: each of the five kernels against its plain PyTorch version on
   the card, at the served shapes, in float32 and bfloat16, with its
   tolerance, and both timed (CUDA events, median of 30 runs);
4. reference: the full-width model in float32 decodes two images on the
   card (through the kernels) and on the CPU (plain versions), on each
   decode configuration (stack + encoder fold, fold, split); tokens must be
   identical and scores agree to 1e-4;
5. encode A/B: the bf16 CLIP encode of 64 images with and without the
   encoder fold, timed in turns;
6. serve: ``CaptionService`` at full width on the card — CLIP ViT-B/32 +
   GPT-2 (12 layers, width 768, vocab 50257), bf16 weights from the seed,
   beam 5, max length 20, batch 64, buckets 1/8/64 — behind its HTTP front
   end. On the default configuration three rounds of 64 concurrent
   requests and three single ones; then one round of 64 with
   ``ICT_DECODE_STACK=0`` (fold) and one with all three switches ``0``
   (split). Every request must be captioned, and the launch counters, set
   to 0 before each configuration's rounds, must show that every decode
   step (and layer) and every encoded batch went through the kernels.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

ROOT = os.path.dirname(os.path.realpath(__file__))
PKG = "image_captioning_ml_project_tpu_torch"


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def phase(name):
    print(f"== {name}", flush=True)


def time_ms(torch, fn, runs=30, flush=None):
    """Median device time of ``fn`` in ms over ``runs`` launches (CUDA
    events), after three warm-up calls; ``flush`` is overwritten before
    each run so the kernel finds its inputs outside L2."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(ref):
    """One bf16 ulp at the magnitude of ``ref``'s largest element."""
    import math

    mag = float(ref.abs().max())
    return 2.0 ** (math.floor(math.log2(mag)) - 7) if mag > 0 else 2.0 ** -133


def check_attention(torch, dev, results):
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_attention import (
        beam_decode_attention, beam_decode_attention_plain)

    B, K, S, H, NH, P = 64, 5, 20, 768, 12, 10
    Bk = B * K
    scale = 1.0 / (H // NH) ** 0.5
    g = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    worst_bf16 = 0.0
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        for pos in (0, 7, 19):
            q, kn, vn = randn(Bk, H), randn(Bk, H), randn(Bk, H)
            kc, vc = randn(Bk, S, H), randn(Bk, S, H)
            pk, pv = randn(B, P, H), randn(B, P, H)
            anc = torch.randint(0, K, (Bk, S), generator=g, device=dev,
                                dtype=torch.int32)
            kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            args = dict(num_heads=NH, beam_size=K, scale=scale)
            got, _, _ = beam_decode_attention(q, kn, vn, kc1, vc1, pk, pv,
                                              anc, pos, **args)
            want, _, _ = beam_decode_attention_plain(q, kn, vn, kc2, vc2, pk,
                                                     pv, anc, pos, **args)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if dtype == torch.float32:
                tol = 1e-5 + 1e-5 * float(want.abs().max())
                ok = torch.allclose(got, want, atol=1e-5, rtol=1e-5)
            else:
                tol = 2 * bf16_ulp(want.float())
                ok = err <= tol
                worst_bf16 = max(worst_bf16, err)
            caches_equal = torch.equal(kc1, kc2) and torch.equal(vc1, vc2)
            print(f"attention {str(dtype)[6:]} pos={pos}: max_abs_err={err:.3e}"
                  f" (tol {tol:.3e}), caches bit-identical={caches_equal}",
                  flush=True)
            check(ok, f"attention {dtype} pos={pos}: error {err} > {tol}")
            check(caches_equal, f"attention {dtype} pos={pos}: caches differ")
            if dtype == torch.bfloat16:
                ms = time_ms(torch, lambda: beam_decode_attention(
                    q, kn, vn, kc1, vc1, pk, pv, anc, pos, **args),
                    flush=flush)
                plain_ms = time_ms(torch, lambda: beam_decode_attention_plain(
                    q, kn, vn, kc2, vc2, pk, pv, anc, pos, **args),
                    flush=flush)
                timing[pos] = (ms, plain_ms)
                print(f"attention bf16 pos={pos}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms (L2 flushed before each run)",
                      flush=True)
    ms, plain_ms = timing[19]
    results["beam_decode_attention"] = dict(max_abs_err=worst_bf16, ms=ms,
                                            plain_ms=plain_ms)


def check_lse(torch, dev, results):
    from image_captioning_ml_project_tpu_torch.ops.lse import (
        lse_and_block_max, lse_and_block_max_plain)

    R, V = 320, 50257
    g = torch.Generator(device=dev).manual_seed(4321)
    logits = (torch.randn((R, V), generator=g, device=dev) * 3).to(
        torch.bfloat16)
    lse, bm = lse_and_block_max(logits)
    lse_p, bm_p = lse_and_block_max_plain(logits)
    torch.cuda.synchronize()
    err = float((lse - lse_p).abs().max())
    rel = float(((lse - lse_p).abs() / lse_p.abs()).max())
    bm_exact = bool(torch.equal(bm, bm_p))
    print(f"lse_and_block_max bf16 [{R}, {V}]: lse max_abs_err={err:.3e} "
          f"max_rel_err={rel:.3e} (rtol 1e-5), block maxima exact={bm_exact}",
          flush=True)
    check(rel <= 1e-5, f"lse relative error {rel} > 1e-5")
    check(bm_exact, "block maxima differ from the plain version")
    ms = time_ms(torch, lambda: lse_and_block_max(logits))
    plain_ms = time_ms(torch, lambda: lse_and_block_max_plain(logits))
    print(f"lse_and_block_max bf16 [{R}, {V}]: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (logits L2-warm, as after the LM head)",
          flush=True)
    results["lse_and_block_max"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms)


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def check_close(what, got, want, dtype, f32_rel, bf16_ulps):
    """Kernel output against the plain version's: in float32 within
    ``f32_rel`` of the output's largest magnitude, in bfloat16 within
    ``bf16_ulps`` bf16 ulps of it. Returns the error."""
    err = max_err(got, want)
    mag = float(want.float().abs().max())
    tol = (f32_rel * mag if dtype == "float32"
           else bf16_ulps * bf16_ulp(want.float()))
    print(f"{what}: max_abs_err={err:.3e} (tol {tol:.3e}, max |plain| "
          f"{mag:.3e})", flush=True)
    check(err <= tol, f"{what}: error {err} > {tol}")
    return err


def check_appended(what, got, want, before, pos, dtype, f32_rel, bf16_ulps):
    """Caches [..., S, H] after a step: every position but ``pos`` is
    bit-identical to the caches before the step (the kernel writes nowhere
    else); the rows appended at ``pos`` agree with the plain version's to
    the tolerance of :func:`check_close`, since each is the output of the
    kernel's own QKV GEMM."""
    rest = [t for t in range(got.shape[-2]) if t != pos]
    untouched = (bool((got[..., rest, :] == before[..., rest, :]).all())
                 and bool((want[..., rest, :] == before[..., rest, :]).all()))
    print(f"{what}: positions != pos bit-identical={untouched}", flush=True)
    check(untouched, f"{what}: a position other than pos={pos} changed")
    check_close(f"{what} at pos", got[..., pos, :], want[..., pos, :], dtype,
                f32_rel, bf16_ulps)


def _dense_weights(torch, g, dev, dtype, L, H, F):
    """A layer-stacked weight set at GPT-2's initial scale: matrices and
    biases N(0, 0.02^2), LayerNorm scales 1 + N(0, 0.1^2) and biases
    N(0, 0.1^2) in float32."""
    from image_captioning_ml_project_tpu_torch.ops._checks import (
        LN_KEYS, stack_shapes)

    out = {}
    for name, shape in stack_shapes(L, H, F).items():
        t = torch.randn(shape, generator=g, device=dev)
        if name in LN_KEYS:
            out[name] = t * 0.1 + (1.0 if name[0] == "g" else 0.0)
        else:
            out[name] = (t * 0.02).to(dtype)
    return out


def check_attention_qkv(torch, dev, results):
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_attention import (
        beam_decode_attention_qkv, beam_decode_attention_qkv_plain)

    B, K, S, H, NH, P = 64, 5, 20, 768, 12, 10
    Bk = B * K
    scale = 1.0 / (H // NH) ** 0.5
    g = torch.Generator(device=dev).manual_seed(2345)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        w = _dense_weights(torch, g, dev, dtype, 1, H, 4 * H)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        for pos in (0, 7, 19):
            x = randn(Bk, H)
            kc, vc = randn(Bk, S, H), randn(Bk, S, H)
            pk, pv = randn(B, P, H), randn(B, P, H)
            anc = torch.randint(0, K, (Bk, S), generator=g, device=dev,
                                dtype=torch.int32)
            kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            ws = (w["wqkv"][0], w["bqkv"][0], w["wo"][0], w["bo"][0])
            args = dict(num_heads=NH, beam_size=K, scale=scale)
            got, _, _ = beam_decode_attention_qkv(x, *ws, kc1, vc1, pk, pv,
                                                  anc, pos, **args)
            want, _, _ = beam_decode_attention_qkv_plain(
                x, *ws, kc2, vc2, pk, pv, anc, pos, **args)
            torch.cuda.synchronize()
            what = f"attention_qkv {name} pos={pos}"
            err = check_close(what, got, want, name, 1e-5, 4)
            for c, (a, b, o) in (("k", (kc1, kc2, kc)), ("v", (vc1, vc2, vc))):
                check_appended(f"{what} {c}_cache", a, b, o, pos, name, 1e-5,
                               1)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
                ms = time_ms(torch, lambda: beam_decode_attention_qkv(
                    x, *ws, kc1, vc1, pk, pv, anc, pos, **args), flush=flush)
                plain_ms = time_ms(
                    torch, lambda: beam_decode_attention_qkv_plain(
                        x, *ws, kc2, vc2, pk, pv, anc, pos, **args),
                    flush=flush)
                timing[pos] = (ms, plain_ms)
                print(f"attention_qkv bf16 pos={pos}: kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms (L2 flushed before each run)",
                      flush=True)
    ms, plain_ms = timing[19]
    results["beam_decode_attention_qkv"] = dict(max_abs_err=worst, ms=ms,
                                                plain_ms=plain_ms)


def check_stack(torch, dev, results):
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_stack import (
        beam_decode_stack, beam_decode_stack_plain)

    L, B, K, S, H, NH, P = 12, 64, 5, 20, 768, 12, 10
    Bk = B * K
    scale = 1.0 / (H // NH) ** 0.5
    g = torch.Generator(device=dev).manual_seed(3456)
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        w = _dense_weights(torch, g, dev, dtype, L, H, 4 * H)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        for pos in (0, 7, 19):
            x = randn(Bk, H)
            kc, vc = randn(L, Bk, S, H), randn(L, Bk, S, H)
            pk, pv = randn(L, B, P, H), randn(L, B, P, H)
            anc = torch.randint(0, K, (Bk, S), generator=g, device=dev,
                                dtype=torch.int32)
            kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            args = dict(num_heads=NH, beam_size=K, scale=scale)
            got, _, _ = beam_decode_stack(x, w, kc1, vc1, pk, pv, anc, pos,
                                          **args)
            want, _, _ = beam_decode_stack_plain(x, w, kc2, vc2, pk, pv, anc,
                                                 pos, **args)
            torch.cuda.synchronize()
            what = f"stack {name} pos={pos}"
            err = check_close(what, got, want, name, 1e-4, 8)
            for c, (a, b, o) in (("k", (kc1, kc2, kc)), ("v", (vc1, vc2, vc))):
                check_appended(f"{what} {c}_caches", a, b, o, pos, name,
                               1e-4, 8)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
                ms = time_ms(torch, lambda: beam_decode_stack(
                    x, w, kc1, vc1, pk, pv, anc, pos, **args))
                plain_ms = time_ms(torch, lambda: beam_decode_stack_plain(
                    x, w, kc2, vc2, pk, pv, anc, pos, **args))
                timing[pos] = (ms, plain_ms)
                print(f"stack bf16 pos={pos}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms (170 MB of weights per step: above "
                      f"L2, no flush)", flush=True)
    ms, plain_ms = timing[19]
    results["beam_decode_stack"] = dict(max_abs_err=worst, ms=ms,
                                        plain_ms=plain_ms)


def check_encoder(torch, dev, results):
    from image_captioning_ml_project_tpu_torch.ops.encoder_stack import (
        encoder_stack, encoder_stack_plain)

    L, B, T, H, NH = 12, 64, 50, 768, 12
    g = torch.Generator(device=dev).manual_seed(4567)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        w = _dense_weights(torch, g, dev, dtype, L, H, 4 * H)
        x = torch.randn((B, T, H), generator=g, device=dev).to(dtype)
        with torch.inference_mode():
            got = encoder_stack(x, w, num_heads=NH)
            want = encoder_stack_plain(x, w, num_heads=NH)
            torch.cuda.synchronize()
            err = check_close(f"encoder {name} [{B}, {T}, {H}]", got, want,
                              name, 1e-4, 8)
            if dtype == torch.bfloat16:
                ms = time_ms(torch, lambda: encoder_stack(x, w, num_heads=NH))
                plain_ms = time_ms(torch, lambda: encoder_stack_plain(
                    x, w, num_heads=NH))
        print(f"encoder {name}: output finite={bool(got.isfinite().all())}",
              flush=True)
        check(bool(got.isfinite().all()), "encoder output is not finite")
    print(f"encoder bf16 [{B}, {T}, {H}] x {L} layers: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (170 MB of weights: above L2, no flush)",
          flush=True)
    results["encoder_stack"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


SWITCHES = ("ICT_DECODE_STACK", "ICT_DECODE_FOLD", "ICT_ENCODER_FOLD")
# the decode configurations: (name, the switches' values)
CONFIGS = (("stack + encoder fold", ("1", "1", "1")),
           ("fold", ("0", "1", "1")),
           ("split", ("0", "0", "0")))


def set_switches(values):
    for name, value in zip(SWITCHES, values):
        os.environ[name] = value


def decode(torch, model, cfg, images):
    from image_captioning_ml_project_tpu_torch.inference.decoding import (
        beam_search)

    mc, ic = cfg.model, cfg.inference
    with torch.inference_mode():
        state = model.init_cache(images, ic.max_length)
        return beam_search(model.step, state, images.shape[0], ic.beam_size,
                           mc.bos_token_id, mc.eos_token_id, mc.pad_token_id,
                           ic.max_length, length_penalty=ic.length_penalty,
                           min_length=ic.min_length)


def check_reference(torch, dev, cfg, tree, images):
    """The card's float32 decode through the kernels against the CPU's
    plain-version decode of the same weights and images, on each decode
    configuration."""
    import copy

    from image_captioning_ml_project_tpu_torch.models.captioning_model import (
        load_model)

    cfg32 = copy.deepcopy(cfg)
    cfg32.model.dtype = "float32"
    x = torch.from_numpy(images)
    models = {where.type: load_model(cfg32, where, params=tree)
              for where in (dev, torch.device("cpu"))}
    for name, values in CONFIGS:
        set_switches(values)
        out = {}
        for where, model in models.items():
            t0 = time.perf_counter()
            res = decode(torch, model, cfg32, x.to(where))
            out[where] = (res.tokens.cpu(), res.scores.float().cpu())
            print(f"reference [{name}] decode on {where}: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
        (tok_g, sc_g), (tok_c, sc_c) = out["cuda"], out["cpu"]
        print(f"reference [{name}] tokens gpu={tok_g.tolist()}", flush=True)
        print(f"reference [{name}] tokens cpu={tok_c.tolist()}", flush=True)
        score_err = float((sc_g - sc_c).abs().max())
        print(f"reference [{name}] scores gpu={sc_g.tolist()} "
              f"cpu={sc_c.tolist()} max_abs_err={score_err:.3e}", flush=True)
        check(torch.isfinite(sc_g).all(), "non-finite scores on the card")
        check(torch.equal(tok_g, tok_c),
              f"[{name}] card and CPU decode different tokens")
        check(score_err <= 1e-4,
              f"[{name}] scores differ by {score_err} > 1e-4")
    set_switches(CONFIGS[0][1])


def encode_ab(torch, dev, cfg, tree, smi, runs=20):
    """The bf16 CLIP encode of 64 images with the encoder fold on and off,
    timed in turns (on, off, off, on, ...) with the device synchronised;
    median of ``runs`` each after warm-up."""
    from image_captioning_ml_project_tpu_torch.models.captioning_model import (
        load_model)

    model = load_model(cfg, dev, params=tree)
    g = torch.Generator().manual_seed(cfg.seed + 2)
    images = torch.randint(0, 256, (64, cfg.image_size, cfg.image_size, 3),
                           generator=g, dtype=torch.uint8).to(dev)
    times = {"1": [], "0": []}
    feats = {}
    with torch.inference_mode():
        for rnd in range(runs + 2):
            for value in (("1", "0") if rnd % 2 == 0 else ("0", "1")):
                os.environ["ICT_ENCODER_FOLD"] = value
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                feats[value] = model.encode(images)["pooled_features"]
                torch.cuda.synchronize()
                if rnd >= 2:
                    times[value].append(time.perf_counter() - t0)
    os.environ["ICT_ENCODER_FOLD"] = "1"
    on, off = (statistics.median(times[v]) * 1e3 for v in ("1", "0"))
    err = max_err(feats["1"], feats["0"])
    print(f"encode A/B, 64 images bf16: fold {on:.3f} ms, per-layer modules "
          f"{off:.3f} ms (median of {runs} each, in turns); pooled features "
          f"max_abs_diff={err:.3e} [{smi}]", flush=True)
    check(all(bool(f.isfinite().all()) for f in feats.values()),
          "encode gave non-finite features")
    del model


def serve(torch, dev, cfg, tree, smi):
    from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab
    from image_captioning_ml_project_tpu_torch.inference.server import (
        CaptionService, make_http_server)
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_attention import (
        beam_decode_attention, beam_decode_attention_qkv)
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_stack import (
        beam_decode_stack)
    from image_captioning_ml_project_tpu_torch.ops.encoder_stack import (
        encoder_stack)
    from image_captioning_ml_project_tpu_torch.ops.lse import (
        lse_and_block_max)

    counters = {"beam_decode_stack": beam_decode_stack,
                "beam_decode_attention_qkv": beam_decode_attention_qkv,
                "beam_decode_attention": beam_decode_attention,
                "encoder_stack": encoder_stack,
                "lse_and_block_max": lse_and_block_max}
    # the GPT-2 BPE files are not in the repository: a word vocabulary of
    # the same size stands in for them
    words = {w: i for i, w in enumerate(WordVocab.specials)}
    words.update({f"w{i}": i for i in range(len(words),
                                              cfg.model.vocab_size)})
    tokenizer = WordVocab(words)
    t0 = time.perf_counter()
    service = CaptionService(cfg, tokenizer, dev, params=tree, batch_size=64,
                             bucket_sizes=[1, 8, 64], max_wait_ms=50.0,
                             request_timeout_s=300.0)
    service.start(warmup=True)
    print(f"service built and warmed (buckets {service.bucket_sizes}): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    httpd = make_http_server(service, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    g = torch.Generator().manual_seed(cfg.seed)
    size = cfg.image_size
    images = torch.randint(0, 256, (64 * 5 + 3, size, size, 3),
                           generator=g, dtype=torch.uint8).numpy()
    layers = cfg.model.decoder.num_layers
    served = {}

    def drive(name, rounds, singles):
        """Serve ``rounds`` bursts of 64 and ``singles`` single requests on
        the switches set now; the counters are set to 0 just before and
        read just after."""
        for fn in counters.values():
            fn.launches = 0
        steps0 = service.stats.decode_steps
        batches0 = service.stats.batches
        captions, batch_s, single_s = [], [], []
        lo = sum(len(v["captions"]) for v in served.values())
        for _ in range(rounds):
            t0 = time.perf_counter()
            reqs = [service.submit_async(img) for img in images[lo:lo + 64]]
            captions += [service.result(r) for r in reqs]
            batch_s.append(time.perf_counter() - t0)
            lo += 64
        for img in images[lo:lo + singles]:
            t0 = time.perf_counter()
            captions.append(service.submit(img))
            single_s.append(time.perf_counter() - t0)
        run = {"captions": captions,
               "steps": service.stats.decode_steps - steps0,
               "batches": service.stats.batches - batches0,
               "launches": {k: fn.launches for k, fn in counters.items()}}
        served[name] = run
        print(f"[{name}] served {len(captions)} requests in {run['batches']}"
              f" batches; decode steps {run['steps']}; launches "
              f"{run['launches']}", flush=True)
        check(len(captions) == rounds * 64 + singles,
              f"[{name}] not every request was answered")
        check(all(isinstance(c, str) and c for c in captions),
              f"[{name}] a request came back without a caption")
        check(run["steps"] > 0, f"[{name}] no decode step ran")
        if batch_s:
            med = statistics.median(batch_s)
            print(f"[{name}] batch of 64 (end to end, {rounds} rounds): "
                  f"{[round(t, 4) for t in batch_s]} s, median {med:.4f} s = "
                  f"{64 / med:.1f} images/s; single request: "
                  f"{[round(t, 4) for t in single_s]} s [{smi}]", flush=True)
        return run

    def expect(run, name, want):
        got = run["launches"][name]
        check(got == want, f"{name} launched {got} times, expected {want}")

    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        print(f"/healthz: {health}", flush=True)
        check(health.get("ok") is True, "/healthz is not ok")

        # the main path: the default configuration
        set_switches(CONFIGS[0][1])
        main_run = drive(CONFIGS[0][0], 3, 3)
        set_switches(CONFIGS[1][1])
        fold_run = drive(CONFIGS[1][0], 1, 0)
        set_switches(CONFIGS[2][1])
        split_run = drive(CONFIGS[2][0], 1, 0)
        set_switches(CONFIGS[0][1])
        print(f"captions[0]: {main_run['captions'][0]!r}", flush=True)
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            done = sum(len(v["captions"]) for v in served.values())
            check(json.loads(r.read())["completed"] >= done,
                  "/stats misses completed requests")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()

    steps = main_run["steps"]
    expect(main_run, "beam_decode_stack", steps)
    expect(main_run, "encoder_stack", main_run["batches"])
    expect(main_run, "lse_and_block_max", steps)
    expect(main_run, "beam_decode_attention_qkv", 0)
    expect(main_run, "beam_decode_attention", 0)
    expect(fold_run, "beam_decode_attention_qkv", fold_run["steps"] * layers)
    expect(fold_run, "beam_decode_stack", 0)
    expect(fold_run, "lse_and_block_max", fold_run["steps"])
    expect(split_run, "beam_decode_attention", split_run["steps"] * layers)
    expect(split_run, "lse_and_block_max", split_run["steps"])
    for name in ("beam_decode_stack", "beam_decode_attention_qkv",
                 "encoder_stack"):
        expect(split_run, name, 0)
    # each kernel's count from the run of the path that carries it
    return {"beam_decode_stack": steps,
            "encoder_stack": main_run["launches"]["encoder_stack"],
            "lse_and_block_max": main_run["launches"]["lse_and_block_max"],
            "beam_decode_attention_qkv":
                fold_run["launches"]["beam_decode_attention_qkv"],
            "beam_decode_attention":
                split_run["launches"]["beam_decode_attention"]}


LIBRARIES = ("beam_decode_attention", "beam_decode_attention_qkv",
             "beam_decode_stack", "encoder_stack")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    try:
        import torch
    except ImportError as e:
        sys.exit(f"chip_smoke: torch is not importable: {e}")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false)")
    sys.path.insert(0, ROOT)
    try:
        from image_captioning_ml_project_tpu_torch.main import flagship_config
        from image_captioning_ml_project_tpu_torch.ops import _build
        from image_captioning_ml_project_tpu_torch.params import (
            init_flax_params)
    except ImportError as e:
        sys.exit(f"chip_smoke: the port's package {PKG} is not beside this "
                 f"script: {e}")
    if not os.path.realpath(_build.__file__).startswith(
            os.path.join(ROOT, PKG) + os.sep):
        sys.exit(f"chip_smoke: {PKG} was imported from {_build.__file__}, "
                 f"not from the checkout at {ROOT}")

    try:
        phase("device")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        dev = torch.device("cuda:0")
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{kind} x{count}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # the plain versions' bf16 GEMMs round once, from f32 sums
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False

        phase("build")
        t0 = time.perf_counter()
        _build.build_libraries(LIBRARIES)
        for name in LIBRARIES:
            _build.load_library(name)
        print(f"{len(LIBRARIES)} libraries ({', '.join(LIBRARIES)}) built in "
              f"parallel and loaded in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for name in LIBRARIES:
            log = _build.build_log(name)
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
            spills = sum(int(b) for b in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", log))
            print(f"ptxas {name}: {len(regs)} kernels, registers "
                  f"{sorted(set(regs))}, spill bytes {spills}", flush=True)

        phase("kernels vs plain")
        results = {}
        check_attention(torch, dev, results)
        check_lse(torch, dev, results)
        check_attention_qkv(torch, dev, results)
        check_stack(torch, dev, results)
        check_encoder(torch, dev, results)

        phase("reference")
        cfg = flagship_config()
        cfg.seed = args.seed
        t0 = time.perf_counter()
        tree = init_flax_params(cfg, cfg.seed)
        print(f"weights drawn from seed {cfg.seed}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        g = torch.Generator().manual_seed(cfg.seed + 1)
        ref_images = torch.randint(0, 256, (2, cfg.image_size,
                                            cfg.image_size, 3),
                                   generator=g, dtype=torch.uint8).numpy()
        check_reference(torch, dev, cfg, tree, ref_images)

        phase("encode A/B")
        encode_ab(torch, dev, cfg, tree, smi)

        phase("serve")
        launches = serve(torch, dev, cfg, tree, smi)

        # the port stands alone: nothing of JAX or the JAX package ran
        foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "flax", "image_captioning_ml_project_tpu"))
        check(not foreign, f"modules of JAX or the JAX package were "
                           f"imported: {foreign}")
    except Exception:
        traceback.print_exc()
        sys.exit("chip_smoke: FAILED")

    jax_pkg = "image_captioning_ml_project_tpu/ops"
    sources = {
        "beam_decode_stack": (
            "cuda", f"{PKG}/csrc/beam_decode_stack.cu",
            f"{jax_pkg}/pallas_decode.py:1177"),
        "encoder_stack": (
            "cuda", f"{PKG}/csrc/encoder_stack.cu",
            f"{jax_pkg}/pallas_encoder.py:171"),
        "lse_and_block_max": (
            "triton", f"{PKG}/ops/lse.py", f"{jax_pkg}/pallas_lse.py:64"),
        "beam_decode_attention_qkv": (
            "cuda", f"{PKG}/csrc/beam_decode_attention_qkv.cu",
            f"{jax_pkg}/pallas_decode.py:655"),
        "beam_decode_attention": (
            "cuda", f"{PKG}/csrc/beam_decode_attention.cu",
            f"{jax_pkg}/pallas_decode.py:361"),
    }
    kernels = [{"name": name, "route": route, "source": src,
                "replaces": rep, "launches": launches[name],
                **results[name]}
               for name, (route, src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
