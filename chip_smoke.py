#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``image_captioning_ml_project_tpu_torch``).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N]

Phases, each reported on its own lines; any failure exits non-zero and
prints no result line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 off for the comparisons;
2. build: compiles ``csrc/beam_decode_attention.cu`` with nvcc from the
   checkout (the Triton kernel compiles at its first launch);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the served shapes, with its tolerance, and both timed (CUDA events,
   median of 30 runs);
4. reference: the full-width model in float32 decodes two images on the
   card (through both kernels) and on the CPU (plain versions); tokens
   must be identical and scores agree to 1e-4;
5. serve: ``CaptionService`` at full width on the card — CLIP ViT-B/32 +
   GPT-2 (12 layers, width 768, vocab 50257), bf16 weights from the seed,
   beam 5, max length 20, batch 64, buckets 1/8/64 — behind its HTTP front
   end; three rounds of 64 concurrent requests and three single ones must
   all be captioned, and the kernels' launch counters must show that every
   decode step of every layer went through them.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
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
    plain-version decode of the same weights and images."""
    import copy

    from image_captioning_ml_project_tpu_torch.models.captioning_model import (
        load_model)

    cfg32 = copy.deepcopy(cfg)
    cfg32.model.dtype = "float32"
    x = torch.from_numpy(images)
    out = {}
    for where in (dev, torch.device("cpu")):
        model = load_model(cfg32, where, params=tree)
        t0 = time.perf_counter()
        res = decode(torch, model, cfg32, x.to(where))
        out[where.type] = (res.tokens.cpu(), res.scores.float().cpu())
        print(f"reference decode on {where.type}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        del model
    (tok_g, sc_g), (tok_c, sc_c) = out["cuda"], out["cpu"]
    print(f"reference tokens gpu={tok_g.tolist()}", flush=True)
    print(f"reference tokens cpu={tok_c.tolist()}", flush=True)
    score_err = float((sc_g - sc_c).abs().max())
    print(f"reference scores gpu={sc_g.tolist()} cpu={sc_c.tolist()} "
          f"max_abs_err={score_err:.3e}", flush=True)
    check(torch.isfinite(sc_g).all(), "non-finite scores on the card")
    check(torch.equal(tok_g, tok_c), "card and CPU decode different tokens")
    check(score_err <= 1e-4, f"scores differ by {score_err} > 1e-4")


def serve(torch, dev, cfg, tree, smi):
    from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab
    from image_captioning_ml_project_tpu_torch.inference.server import (
        CaptionService, make_http_server)
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_attention import (
        beam_decode_attention)
    from image_captioning_ml_project_tpu_torch.ops.lse import (
        lse_and_block_max)

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
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        print(f"/healthz: {health}", flush=True)
        check(health.get("ok") is True, "/healthz is not ok")

        g = torch.Generator().manual_seed(cfg.seed)
        size = cfg.image_size
        images = torch.randint(0, 256, (64 * 3 + 3, size, size, 3),
                               generator=g, dtype=torch.uint8).numpy()
        layers = cfg.model.decoder.num_layers
        # counters start at 0 just before the main path runs
        beam_decode_attention.launches = 0
        lse_and_block_max.launches = 0
        steps0 = service.stats.decode_steps
        captions, batch_s = [], []
        for rnd in range(3):
            t0 = time.perf_counter()
            reqs = [service.submit_async(img)
                    for img in images[64 * rnd:64 * (rnd + 1)]]
            captions += [service.result(r) for r in reqs]
            batch_s.append(time.perf_counter() - t0)
        single_s = []
        for img in images[192:]:
            t0 = time.perf_counter()
            captions.append(service.submit(img))
            single_s.append(time.perf_counter() - t0)
        attn = beam_decode_attention.launches
        lse = lse_and_block_max.launches
        steps = service.stats.decode_steps - steps0
        stats = service.stats.snapshot()
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            check(json.loads(r.read())["completed"] >= len(captions),
                  "/stats misses completed requests")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()

    print(f"captions[0]: {captions[0]!r}", flush=True)
    print(f"served {len(captions)} requests in {stats['batches']} batches; "
          f"decode steps {steps}; launches: beam_decode_attention {attn}, "
          f"lse_and_block_max {lse}", flush=True)
    check(len(captions) == len(images), "not every request was answered")
    check(all(isinstance(c, str) and c for c in captions),
          "a request came back without a caption")
    check(steps > 0, "no decode step ran")
    check(attn == steps * layers,
          f"beam_decode_attention launched {attn} times for {steps} steps x "
          f"{layers} layers")
    check(lse == steps, f"lse_and_block_max launched {lse} times for "
                        f"{steps} steps")
    med = statistics.median(batch_s)
    print(f"batch of 64 (end to end, 3 rounds): {[round(s, 4) for s in batch_s]}"
          f" s, median {med:.4f} s = {64 / med:.1f} images/s; single request:"
          f" {[round(s, 4) for s in single_s]} s [{smi}]", flush=True)
    return {"beam_decode_attention": attn, "lse_and_block_max": lse}


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

        phase("build")
        t0 = time.perf_counter()
        _build.load_library("beam_decode_attention")
        print(f"beam_decode_attention.cu built and loaded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for line in _build.build_log("beam_decode_attention").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}", flush=True)

        phase("kernels vs plain")
        results = {}
        check_attention(torch, dev, results)
        check_lse(torch, dev, results)

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

    sources = {
        "beam_decode_attention": (
            "cuda", f"{PKG}/csrc/beam_decode_attention.cu",
            "image_captioning_ml_project_tpu/ops/pallas_decode.py:361"),
        "lse_and_block_max": (
            "triton", f"{PKG}/ops/lse.py",
            "image_captioning_ml_project_tpu/ops/pallas_lse.py:64"),
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
