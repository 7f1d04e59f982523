#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``image_captioning_ml_project_tpu_torch``).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --time-tree DIR   # phase 3's sweeps only, for DIR

Phases, each reported on its own lines; any failure exits non-zero and
prints no result line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 and bf16 reduced-precision GEMM reductions off for the
   comparisons;
2. build: compiles the eight ``csrc/*.cu`` libraries with nvcc from the
   checkout, one process each, all started together, and prints ptxas's
   register and spill lines (``sdpa`` must not spill);
3. kernels: each of the eight kernels against its plain PyTorch version
   on the card, at the served shapes of each family that runs it (the
   CLIP tower at 5 and 64 images; the beam-decode attention kernels
   prefix-free for the Transformer decoder and behind a 10-row prefix for
   GPT-2; the LSE at the candidate step's
   5, 25, 40 and 320 rows over vocabularies of 10000, 30000 and 50257 in
   float32, bfloat16 and float16, on a view whose rows start off 16-byte
   boundaries, and twice bit-identical; SDPA at the LSTM's 64 images x 5
   beams over 49 feature rows, unmasked, masked and with one image's keys
   all masked, bf16 on its tensor-core route and float32 on its CUDA-core
   one, and the additive scores at 1, 5, 8 and 64 images, masked and not,
   and both at its teacher-forced 20 positions),
   in float32 and bfloat16, with its tolerance. Timed in bf16 (CUDA
   events, median of 30 runs; the device time behind a spin kernel),
   beside the least time the card could take for the same work
   (``bound_ms``: the larger of the bytes over 3.35 TB/s and the
   operations over the peak rate of their type) and, where one PyTorch call computes
   the same function, that call's time (``library_ms``). The four
   decode-step kernels (#1 and #2 prefix-free and behind the prefix, #3,
   #6), the two candidate-step kernels (#4 over each vocabulary, #8) and
   the multi-head attention core (#7, with its teacher-forced shape) are
   held against their plain versions again and timed at batch 1, 5, 8
   and 64, the service's buckets and the eval CLI's batch
   (:func:`sweep_decode_kernels`, :func:`sweep_lse`, :func:`sweep_additive`, :func:`sweep_sdpa`;
   the four decode-step kernels again at the other decodes' shapes: one
   beam with no ancestry (greedy and nucleus decoding) and 6 beams (the
   diverse beam's 3 groups of 2); ``--time-tree DIR`` runs
   only those sweeps, on the package of another tree, so that two trees
   compare inside one run); then the beam attention's ancestry error word
   must be clear. Before them, the Dense
   GEMM that the three layer kernels share (``csrc/common.cuh``: ``wgmma``
   fed by TMA) by itself against ``ops/numerics.dense`` and each epilogue,
   at every (M, N, K) the whole-stack kernels give it and at ragged ones,
   two runs on the same inputs bit-identical; per shape at M = 320 and
   3200 its device time, TFLOP/s and bound beside
   ``torch.nn.functional.linear``'s time (timed only);
4. reference: the full-width models in float32 decode two images on the
   card (through the kernels) and on the CPU (plain versions), on each
   decode configuration (ResNet-101 + LSTM: soft, multi-head, adaptive and
   AoA attention through their kernels, and soft without; ViT +
   Transformer decoder: fold, split; CLIP + GPT-2: stack + encoder fold,
   fold, split); tokens must be identical and scores agree to 1e-4; then,
   on each family's default configuration, greedy, diverse beam (6 beams
   in 3 groups, penalty 0.5), nucleus (top-p 0.9, the same noise drawn on
   the CPU fed to both) and the model's ``generate``, tokens identical;
   then the CLIP scorer of the reranker at openai/clip-vit-base-patch32's
   widths (seeded weights, float32, the vision tower through the encoder
   kernel) scores 5 candidate captions per image on the card and on the
   CPU: within 1e-4 of the largest score, the same winners;
5. encode A/B: the bf16 CLIP encode of 64 images with and without the
   encoder fold, timed in turns;
6. serve: ``CaptionService`` at full width on the card, bf16 weights from
   the seed, beam 5, max length 20, batch 64, buckets 1/8/64, behind its
   HTTP front end. Each configuration first serves one untimed round of 64
   on its own switches (a warm-up, before its counters are set to 0), then
   its timed rounds. First the LSTM family — ResNet-101
   + 6-layer LSTM (width 512, vocab 10000): with soft attention through
   its kernel (``--config lstm``) one round of 64 concurrent requests and
   three single ones; then one round of 64 with multi-head attention
   through its kernel, and one with soft attention and ``use_pallas``
   off. Then ViT-B/16 + 6-layer Transformer decoder (width 768, 12 heads,
   vocab 30000): on its default (fold) configuration three rounds of 64 and
   three single requests; then one round of 64 with ``ICT_DECODE_FOLD=0``
   (split). Then CLIP ViT-B/32 + GPT-2 (12 layers, width 768, vocab
   50257): on the default configuration three rounds of 64 and three
   single requests; then one round of 64 with ``ICT_DECODE_STACK=0``
   (fold) and one with all three switches ``0`` (split). Every request
   must be captioned, and the launch counters, set to 0 just before each
   configuration's rounds and read just after, must show that every
   decode step (and layer) and every encoded batch went through the
   kernels, and that no other kernel ran; the ancestry error word is read
   after each configuration and must be clear. Last, the flagship's other
   decoding options, a service each, one round of 64 after a warm-up
   round: greedy, nucleus (top-p 0.9), diverse beam (6 beams in 3 groups,
   penalty 0.5) and beam 5 with CLIP reranking of its 5 candidates (the
   full-width scorer on the completer thread, a word-hash CLIP tokenizer);
   #3 must launch once a step, #5 once an encoded batch plus once a
   reranked one, #4 once a step on the beam paths and never on the
   others;
7. train: the flagship at full width on a synthetic COCO fixture of
   64 + 64 PNG images of 224 x 224 with its word vocabulary padded to
   50257 ids, through ``CaptioningTrainer``; the training batches take
   the training crop and flip on the host: two f32 CE steps of
   batch 2 (dropout 0, no warmup) on the card and on the CPU from the same
   seeded weights, losses within 1e-4 relative, ``grad_norm`` within 1e-3,
   the Adam moments after the first step within the CPU parity tests'
   tolerance (atol 1e-7 + rtol 1e-3: the first moment is then a tenth of
   the gradient, so this holds every entry's gradient) and after the
   second within atol 2e-7 + rtol 1e-3, and every parameter
   within theirs (atol 1e-5 + rtol 1e-4; an entry whose gradient on
   either device lies in (0, 1e-7) in a step, where AdamW's step follows
   the gradient's rounding, moves within the bias-corrected Adam steps'
   bound on each device, about a learning rate a step, and within twice
   it of the other device); 20 bf16 steps at batch 64
   (lr 1e-4, warmup 2, dropout 0.1) on one batch, the loss falling, with
   the median step time, images per second and peak memory; no kernel
   may launch in any training step. Then ``_validate_epoch`` on the 64
   validation images (val loss and CIDEr > 0, and #3, #4 and #5 launched),
   the ``eval_state`` decode token-identical to ``load_model``'s on the
   trainer's current weights, ``save_checkpoint`` restored bit-identical
   by a new trainer, the rolling step checkpoint's two slots; last a
   service on the seeded weights answers requests from 8 threads while
   ``reload_checkpoint("best_model")`` swaps the trained weights in, every
   request answered, the captions after it equal to a fresh service's on
   the checkpoint. Then SCST: in f32 at batch 2 on the card and on the
   CPU from the same seeded weights, the n-gram hashes on the card
   bit-equal to ``ngram_hashes_np``, the device CIDEr rewards of the same
   injected rollouts within 1e-5 relative, and one ``rl_update_step`` on
   the same tokens, mask and advantages (the loss within 1e-5 relative,
   the moments and parameters as the CE check holds them); then bf16 SCST
   at batch 64 through ``scst_fused_step`` on the device CIDEr path, one
   warm-up step and five timed, each split into rollouts, rewards and
   update with the launches read on each side of each part: #5 once and
   #3 two to 2 x 19 times in the rollouts, nothing else, and no kernel in
   the rewards or the update; finite rewards and a non-zero advantage; the
   refreshed rollout model's greedy decode token-identical to a fresh
   ``eval_state()``'s; last an epoch's CE and SCST passes through
   ``_train_epoch``;
8. eval and demo, on phase 7's fixture and ``best_model``: the native
   JPEG loader's build (``native_loader: available``, or the compiler's
   reason); ``main.evaluate`` on 4 validation images of their own fixture
   and ``main.demo`` on one, in float32 on the card and on the CPU, the
   captions and metrics identical, the card's launches counted (#5 once a
   batch, #3 and #4 once a decode step, nothing else); ``--mode eval``
   through ``main.main`` in bf16 over the 64 validation images, every image captioned once in
   ``results.json``, with the launch counters set to 0 just before and
   read just after: #5 once a batch of 5, #3 and #4 once a decode step,
   nothing else, the ancestry error word clear; the same with phase 4's
   full-width CLIP scorer reranking 5 candidates (#5 once more a batch);
   ``--mode demo`` on one image (its printed caption); one CE epoch of
   ``main.train`` with ``use_curriculum`` at batch 64, its step count the
   sampler's; where the native loader built, a JPEG copy of the
   validation images evaluated with it and with PIL (pixels within 3
   levels, differing captions' image ids printed). Each eval's pass
   time, images/s and call time are printed with the card;
9. the other families and the device-resident resize: #6 against its
   plain version (f32 within 1e-5, bf16 within 2 ulps) and timed beside
   SDPA at the new families' memory lengths, 64 images x 5 beams, 12
   heads, width 768: the Q-Former's 32, BUTD's 36 with each image's tail
   past 20 to 36 valid regions masked, Swin-B's 49 (the CUDA-core route
   in bf16) and 48 (the tensor-core route, for comparison). Then each of
   ``--config qformer`` (ViT-B/16 + a 32-query Q-Former), ``--config
   butd`` (36 detector regions of 2048) and ``--config transformer
   --encoder_type swin`` (Swin-B), seeded weights drawn once: the f32
   decode of 4 inputs (Swin: 2) on the card and on the CPU, tokens
   identical and scores within 1e-4; the bf16 decode of 64 after a
   warm-up, its encode timed, with the launches checked (#2 and #6 once
   a layer a step, #4 once a step, nothing else); for the Q-Former and
   Swin a served round of 64 after the service's warm-up round, the same
   launches; for BUTD the bf16 tokens unchanged when the masked
   regions' features and boxes are replaced by noise, and ``--mode
   eval`` over detector features of phase 7's 64 validation images
   (20-36 valid regions, a vocabulary of 30000); for the Q-Former and
   BUTD two bf16 CE steps of 32 (ms, images/s, peak memory; no kernel).
   Last the flagship's device-resident resize on phase 7's
   ``best_model``, over JPEGs of 300 +- 120 pixels: the card's
   ``resize_normalize`` of 16 canvases within 1e-4 of the CPU's;
   ``main.evaluate`` with ``device_resize`` in f32 on 4 images, captions
   identical on the card and the CPU; ``--mode eval --device_resize`` in
   bf16 over 16 images, then with the CLIP reranker scoring the resized
   pixels, then ``--mode eval --fold_normalize`` (uint8 pixels to the
   patch embed's fold; under ``device_resize`` the model is handed
   normalised floats and nothing folds, as in the JAX package), each
   with phase 8's launch checks;
10. parallel and legacy: two ranks of the port's mesh on the one card,
   over gloo (each a process of this script, ``--parallel-rank``, with
   the deadline :data:`PAR_RANK_TIMEOUT`; a rank that fails or hangs
   fails the phase). In f32 on phase 7's fixture, dropout 0, one warmup
   step (as the CPU parity tests), two CE
   steps of global batch 4 of the flagship at data parallelism 2, then at
   tensor parallelism 2 (GPT-2's blocks Megatron-sharded), and of
   ResNet-101 + LSTM (BatchNorm on the global batch) at dp2: losses
   within 1e-5 relative of the one-process trainer's on the card and
   ``grad_norm`` within phase 7's 1e-3, the gathered state (parameters,
   Adam moments, running statistics) by phase 7's rules
   (:func:`hold_train_state`). ResNet-101's gradients over 2 + 2 rows
   are known only to a few percent: a one-process run with the stem
   nudged by one ulp moves them as far. There each step's gradient and
   any moment beyond phase 7's entry rule (tensor by tensor) and the
   parameters' moves (over the model) must lie within four times the
   nudged run's relative L2 distance or 1e-3, and every parameter entry
   of each run within phase 7's atol 1e-5 + rtol 1e-4 of the AdamW steps
   its own recorded moments give. The same two LSTM steps without the warmup
   step are reported beside the nudged run's (each step's loss relative
   to one process); before the flagship's
   dp2 steps ``_validate_epoch`` on the 64 validation images in one batch,
   each rank decoding its 32 rows (#5 twice, for the loss's forward and
   the decode's encode, #3 and #4 once a decode step, nothing else, on
   each rank), the gathered tokens identical to the one-process
   decode's. In bf16 at full width: one warm-up and five timed
   steps of global batch 64 at dp2 and at tp2 (each rank's median step,
   images/s of the global batch, peak memory; no kernel launched; the two
   ranks share the card, so the times say what the code costs, not what
   two cards gain); the tp2 trainer's checkpoint restored in one process
   bit-identical to the ranks' gathered state. One f32 legacy step of
   batch 4 at dp2 against the one-process step, held as ResNet-101's.
   Then the CLI as ``torchrun`` starts it (``python -m
   torch.distributed.run --nproc_per_node 2 -m
   image_captioning_ml_project_tpu_torch.main``, a free localhost port):
   ``--mode train`` of the flagship at dp2 in bf16 for one epoch of five
   steps of 64 (validation and the epoch checkpoint included), then
   ``--mode eval`` of its checkpoint in f32 at dp2 and in one process,
   ``results.json`` identical (:func:`torchrun_cli`). Then the legacy
   Show-Attend-Tell stack in one process at the JAX legacy CLI's defaults
   (ResNet-50, 224 pixels, a 14 x 14 grid, widths 512, a word vocabulary
   of 10000, f32): forward and 20-token ``generate`` of 4 images on the
   card and on the CPU (tokens identical, predictions and alphas within
   1e-4), two steps of batch 2 on both (``ce`` and ``att_reg`` within 1e-5
   relative, the state as ResNet-101's at dp2), 20 steps of batch 16 on one
   batch (the loss falling; ms a step, images/s, peak memory),
   ``validate`` on the 64 validation images, ``generate_captions`` on 4
   JPEGs, the epoch checkpoints restored bit-identical; no kernel
   launched in the legacy stack;
11. serving and the demo under the mesh: first #1 at the flagship's tp2
   shapes, each model rank's 6 heads of 64 (H = 384), 64 images x 5 beams
   behind the 10-row prefix, f32 and bf16 against its plain version and
   timed in bf16. Then ``CaptionService(mesh=)`` on two ranks sharing the
   card over gloo (phase 10's ``--parallel-rank``, deadline
   :data:`SERVE_RANK_TIMEOUT`), the flagship at full width on phase 7's
   ``best_model``, batch 64, buckets 1/8/64 rounded to the data axis. In
   f32 at dp2 and at tp2 (GPT-2 on each rank's head-whole shards): the
   token rows of ``_run_images`` of 64, 8 and 1 seeded images and the
   captions of 64 concurrent requests identical to the one-process f32
   service's (a row that parts prints the step and the one-process top-2
   log-probability gap there, and fails the phase). In bf16 at dp2 and
   tp2: a warm-up round of 64 concurrent requests, three timed rounds (the
   round's seconds, each rank's median decode ms) and three single
   requests on the smallest bucket (:data:`SERVE_MAX_WAIT_MS` of batcher
   wait). Each rank's counters, set to 0 just before its service is built
   and read after it stops: #5 once a batch, #4 once a decode step, and #3
   once a step at dp2 or #1 once a layer a step at tp2, nothing else (no
   #2, no #3 at tp2). Then the CLI under ``python -m
   torch.distributed.run --nproc_per_node 2`` in f32: ``--mode serve`` at
   dp2 answers ``/healthz``, 16 concurrent PNG requests get the
   one-process captions, a ``POST /reload`` with 16 more in flight
   answers and so does each of them, ``/stats`` counts them, and SIGTERM
   to the launcher ends it with both ranks logging a clean end; the same
   at tp2 with 4 requests and no reload; then ``--mode demo`` at dp2 and
   at tp2, the two launches side by side, each logs ``main.demo``'s
   caption in one process, from rank 0 only (:func:`serving_cli`);
12. HF layouts: the flagship built from HF's CLIP and GPT-2 layouts. The
   card has no transformers, so :func:`draw_hf_state` draws from the seed
   state dicts with HF's names and shapes (:func:`hf_layout`): a
   ``CLIPVisionModel`` ViT-B/32 with its ``position_ids`` buffer and a
   ``GPT2LMHeadModel`` 124M under ``transformer.``, ``lm_head.weight``
   tied to ``wte`` and one legacy ``attn.bias`` a block. ``models/
   hf_port.py`` converts them; merged into the flagship's seeded state,
   ``load_model`` builds them on the card in f32 and bf16, and both
   models' whole-stack operands (``encoder.backbone.stack``,
   ``decoder.stack``) must equal the HF tensors transposed and joined by
   hand. The f32 decode of 2 images (beam 5, max length 20, length
   penalty 0.8) on the card and on the CPU: tokens identical, scores
   within 1e-4. The bf16 decode of 64 images after a warm-up, with the
   launch counters set to 0 just before and read just after: #5 once, #3
   and #4 once a decode step, nothing else. Then ViT-B/16, Swin-B (embed
   128, depths 2-2-18-2, window 7) and ResNet-101 (depths 3-4-23-3) drawn
   in HF's layout, converted, loaded strictly into the ``transformer``,
   ``--encoder_type swin`` and ``lstm`` configurations and run for one
   bf16 encode of 64 images (finite features, no kernel launched); the
   conversion and load seconds and the times are printed with the card.

The last seven lines are the train and eval phases' numbers (JSON), phase
9's (JSON), phase 10's (JSON), phase 11's (JSON), phase 12's (JSON), a
JSON summary of the kernels and ``{"ok": true, "device": {...}}`` (the card's ``nvidia-smi``
line is printed first, in phase 1). Each kernel's entry holds its numbers
and launches for the Transformer family where that family runs it, else
for the flagship, else for the LSTM; the other families', where they have
their own shape (the LSE over the LSTM's vocabulary of 10000), are under
``other_shapes``; the decode-step kernels' numbers at one beam with no
ancestry and at 6 beams under ``decode_shapes``, and each kernel's
launches in the flagship's other decoding options' runs under
``decoding_options``, and their launches in the train phase (its
steps, its validation, the service across the reload, the timed SCST
steps) under ``training``, in phase 8's eval, reranked eval and
demo under ``evaluation``, in phase 9's runs under ``families``, and
in phase 10 per rank (the dp2 validation, the bf16 steps at dp2 and
tp2) and in the legacy stack under ``parallel``, in phase 11 per rank
under ``serving_mesh`` and in phase 12's bf16 decode under
``hf_layouts``; #6's numbers at phase 9's memory lengths are under ``family_shapes``.
"""

import argparse
import copy
import itertools
import json
import math
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


def time_ms(torch, fn, runs=30, flush=None, device=False):
    """Median time of ``fn`` in ms over ``runs`` calls between two CUDA
    events, after three warm-up calls; ``flush`` is overwritten before
    each run so the kernel finds its inputs outside L2. The events bracket
    the whole call: where the wrapper's host work outlasts the work queued
    before it, the device waits and the time includes that host work.
    With ``device``, also returns the device time: the median over
    ``runs`` more calls, timed the same way but queued behind a spin
    kernel (``torch.cuda._sleep``) that keeps the device busy while the
    host enqueues them all, so that no host work falls between the
    events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def timed(n):
        events = []
        for _ in range(n):
            if flush is not None:
                flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    times = []
    for _ in range(runs):
        times.append(timed(1))
    if not device:
        return statistics.median(times)
    torch.cuda._sleep(400_000_000)  # about 0.2 s of spinning
    return statistics.median(times), timed(runs)


def bf16_ulp(ref):
    """One bf16 ulp at the magnitude of ``ref``'s largest element."""
    import math

    mag = float(ref.abs().max())
    return 2.0 ** (math.floor(math.log2(mag)) - 7) if mag > 0 else 2.0 ** -133


# the card's published peaks (H100 SXM data sheet, dense): device memory,
# bf16 on the tensor cores, float32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "f32": 67e12}


def bound(nbytes, ops):
    """The least time the card could take: the larger of ``nbytes`` over
    the memory rate and the operations over their type's peak; ``ops``
    maps a peak of :data:`PEAK_OPS_PER_S` to a count. Operations of two
    types run on separate units, so the larger of their times bounds them.
    Returns ``{"bound_ms", "bound_by"}``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_OPS_PER_S[k] * 1e3 for k, n in ops.items())
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cache_rows_read(torch, anc, pos, K):
    """Distinct cache rows (beam row, position) that positions < ``pos``
    read through the ancestry ``anc`` [Bk, S]: the K beams of an image
    often read the same row, which is read once. With no ancestry (None,
    K = 1) each row reads its own positions."""
    if anc is None:
        return 0
    Bk, S = anc.shape
    rows = (torch.arange(Bk, device=anc.device)[:, None] // K * K
            + anc[:, :pos].long())
    return int(torch.unique(rows * S + torch.arange(pos, device=anc.device)
                            ).numel())


def attention_work(torch, anc, pos, B, K, H, P, item, layers=1):
    """Bytes and f32 operations of the beam attention over ``layers``
    layers: the distinct cache rows read, the prefix, the ancestry, the
    step's rows appended; scores and the mix, 4 operations per head dim of
    each (row, position)."""
    Bk = B * K
    if anc is None:
        rows, anc_bytes = Bk * pos, 0
    else:
        rows, anc_bytes = cache_rows_read(torch, anc, pos, K), Bk * pos * 4
    nbytes = layers * (2 * rows * H + 2 * B * P * H + 2 * Bk * H) * item \
        + anc_bytes
    return nbytes, layers * 4 * Bk * H * (pos + P + 1)


# the shapes the beam-decode kernels meet at batch 64, 5 beams, 20 steps,
# width 768, 12 heads: GPT-2 behind its 10-row image prefix, and the
# Transformer decoder, prefix-free
ATTENTION_SHAPES = (("transformer", 0), ("flagship", 10))


def shape_entry(shape, err, ms, plain_ms, bnd, library_ms=None,
                device_ms=None):
    """One shape's numbers for the summary line: ``ms`` the CUDA-event
    time of the kernel's call, ``device_ms`` its kernels' device time
    (:func:`time_ms`)."""
    return dict(shape=shape, max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, **bnd, library_ms=library_ms)


def check_attention(torch, dev):
    """#1 against its plain version at the served shapes, pos 0, 7 and 19,
    f32 and bf16; returns the worst bf16 error per family."""
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_attention import (
        beam_decode_attention, beam_decode_attention_plain)

    B, K, S, H, NH = 64, 5, 20, 768, 12
    Bk = B * K
    scale = 1.0 / (H // NH) ** 0.5
    g = torch.Generator(device=dev).manual_seed(1234)
    worst = {}
    for family, P in ATTENTION_SHAPES:
        worst[family] = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            def randn(*shape):
                return torch.randn(shape, generator=g, device=dev).to(dtype)

            for pos in (0, 7, 19):
                q, kn, vn = randn(Bk, H), randn(Bk, H), randn(Bk, H)
                kc, vc = randn(Bk, S, H), randn(Bk, S, H)
                pk, pv = (randn(B, P, H), randn(B, P, H)) if P else (None,
                                                                     None)
                anc = torch.randint(0, K, (Bk, S), generator=g, device=dev,
                                    dtype=torch.int32)
                kc1, vc1 = kc.clone(), vc.clone()
                kc2, vc2 = kc.clone(), vc.clone()
                args = dict(num_heads=NH, beam_size=K, scale=scale)
                got, _, _ = beam_decode_attention(q, kn, vn, kc1, vc1, pk, pv,
                                                  anc, pos, **args)
                want, _, _ = beam_decode_attention_plain(
                    q, kn, vn, kc2, vc2, pk, pv, anc, pos, **args)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                if dtype == torch.float32:
                    tol = 1e-5 + 1e-5 * float(want.abs().max())
                    ok = torch.allclose(got, want, atol=1e-5, rtol=1e-5)
                else:
                    tol = 2 * bf16_ulp(want.float())
                    ok = err <= tol
                    worst[family] = max(worst[family], err)
                caches_equal = torch.equal(kc1, kc2) and torch.equal(vc1, vc2)
                what = f"attention {str(dtype)[6:]} P={P} pos={pos}"
                print(f"{what}: max_abs_err={err:.3e} (tol {tol:.3e}), "
                      f"caches bit-identical={caches_equal}", flush=True)
                check(ok, f"{what}: error {err} > {tol}")
                check(caches_equal, f"{what}: caches differ")
    return worst


# the candidate step's vocabularies: the LSTM's (19.53 blocks of 512: the
# last one ragged), the Transformer decoder's and GPT-2's
LSE_VOCABS = (("lstm", 10000), ("transformer", 30000), ("flagship", 50257))


def check_lse_once(torch, what, logits):
    """#4 against its plain version on ``logits``: block maxima
    bit-identical, the LSE within rtol 1e-5. Returns the LSE's largest
    absolute error."""
    from image_captioning_ml_project_tpu_torch.ops.lse import (
        lse_and_block_max, lse_and_block_max_plain)

    lse, bm = lse_and_block_max(logits)
    lse_p, bm_p = lse_and_block_max_plain(logits)
    torch.cuda.synchronize()
    err = float((lse - lse_p).abs().max())
    rel = float(((lse - lse_p).abs() / lse_p.abs()).max())
    bm_exact = bool(torch.equal(bm, bm_p))
    print(f"{what}: lse max_abs_err={err:.3e} max_rel_err={rel:.3e} (rtol "
          f"1e-5), block maxima exact={bm_exact}", flush=True)
    check(rel <= 1e-5, f"{what}: relative error {rel} > 1e-5")
    check(bm_exact, f"{what}: block maxima differ from the plain version")
    return err


def check_lse(torch, dev):
    """#4 at the candidate step's rows of batch 1, 5, 8 and 64 (R = 5, 25,
    40, 320) over the three vocabularies, in float32, bfloat16 and float16; a
    bf16 view whose rows start at every offset from a 16-byte boundary; two
    runs bit-identical."""
    from image_captioning_ml_project_tpu_torch.ops.lse import (
        lse_and_block_max)

    g = torch.Generator(device=dev).manual_seed(4321)
    for B in SWEEP_BATCHES:
        R = 5 * B
        for _, V in LSE_VOCABS:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                logits = (torch.randn((R, V), generator=g, device=dev)
                          * 3).to(dtype)
                check_lse_once(torch, f"lse_and_block_max {str(dtype)[6:]} "
                                      f"[{R}, {V}]", logits)
    # row stride 50259 (odd): row r starts 2r mod 16 bytes off a boundary
    wide = (torch.randn((320, 50259), generator=g, device=dev) * 3).to(
        torch.bfloat16)
    view = wide[:, 1:50258]
    check_lse_once(torch, "lse_and_block_max bf16 [320, 50257] view, row "
                          "stride 50259", view)
    first = lse_and_block_max(view)
    again = lse_and_block_max(view)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"lse_and_block_max: two runs bit-identical={same}", flush=True)
    check(same, "lse_and_block_max: two runs on the same input differ")


def lse_bound(R, V, item):
    """One read of the logits, the LSE and block maxima written; a max, a
    subtraction and an add per logit on the CUDA cores."""
    nblk = -(-V // 512)
    return bound(R * V * item + R * 4 * (1 + nblk), {"f32": 3 * R * V})


def sweep_lse(torch, dev, smi):
    """#4 at batch 1, 5, 8 and 64 (R = 5 B) over each family's vocabulary,
    bf16: held against its plain version, then its device time, event time,
    bound and the plain version's time, with the logits L2-warm as the LM
    head leaves them. Uses only the public wrappers (``--time-tree``).
    Returns {family: {batch: shape_entry}}."""
    from image_captioning_ml_project_tpu_torch.ops.lse import (
        lse_and_block_max, lse_and_block_max_plain)

    g = torch.Generator(device=dev).manual_seed(5432)
    out = {}
    for B in SWEEP_BATCHES:
        R = 5 * B
        for family, V in LSE_VOCABS:
            logits = (torch.randn((R, V), generator=g, device=dev) * 3).to(
                torch.bfloat16)
            what = f"sweep lse_and_block_max {family} B={B} [{R}, {V}]"
            err = check_lse_once(torch, what, logits)
            ms, dev_ms = time_ms(torch, lambda: lse_and_block_max(logits),
                                 device=True)
            plain_ms = time_ms(torch, lambda: lse_and_block_max_plain(
                logits))
            bnd = lse_bound(R, V, 2)
            print(f"{what}: device {dev_ms:.4f} ms, event {ms:.4f} ms, bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), plain "
                  f"{plain_ms:.4f} ms (L2-warm) [{smi}]", flush=True)
            # no one PyTorch call gives both outputs (torch.logsumexp gives
            # the LSE only)
            out.setdefault(family, {})[B] = shape_entry(
                f"[{R}, {V}] bf16", err, ms, plain_ms, bnd, device_ms=dev_ms)
    return out


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


def stack_bytes(w):
    return sum(t.numel() * t.element_size() for t in w.values())


# the Dense GEMM's shapes: rows of the encoder (50 tokens) and the decoder
# (5 beams) at the service's buckets 1 / 8 / 64, and the four matrices of a
# layer of width 768 (QKV, output projection, MLP in and out)
DENSE_ROWS = (5, 40, 320, 50, 400, 3200)
DENSE_MATRICES = ((2304, 768), (768, 768), (3072, 768), (768, 3072))
DENSE_RAGGED = ((1, 72, 776), (63, 72, 776), (65, 768, 776), (321, 72, 768),
                (321, 2304, 776))


def check_dense(torch, dev):
    """The Dense GEMM of ``csrc/common.cuh`` by itself (module docstring,
    phase 3): bf16 within 2 ulps of the largest output of the plain
    version, repeats bit-identical (the split over K adds in a fixed
    order). Not a kernel of its own: the layer kernels issue it."""
    from image_captioning_ml_project_tpu_torch.ops.dense_layer import (
        EPILOGUES, dense_layer, dense_layer_plain)

    g = torch.Generator(device=dev).manual_seed(8901)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    shapes = [(M, N, K) for M in DENSE_ROWS for N, K in DENSE_MATRICES]
    worst = 0.0
    for M, N, K in shapes + list(DENSE_RAGGED):
        x, w, b = randn(M, K), randn(N, K, scale=0.02), randn(N, scale=0.02)
        r = randn(M, N)
        for epilogue in EPILOGUES:
            res = r if epilogue == "residual" else None
            got = dense_layer(x, w, b, res, epilogue)
            again = dense_layer(x, w, b, res, epilogue)
            want = dense_layer_plain(x, w, b, res, epilogue)
            torch.cuda.synchronize()
            err, tol = max_err(got, want), 2 * bf16_ulp(want.float())
            what = f"dense bf16 M={M} N={N} K={K} {epilogue}"
            check(err <= tol, f"{what}: error {err} > {tol}")
            check(torch.equal(got, again), f"{what}: two runs differ")
            worst = max(worst, err / tol)
    print(f"dense bf16: {len(shapes) + len(DENSE_RAGGED)} shapes x "
          f"{len(EPILOGUES)} epilogues within 2 ulps of the largest output "
          f"(worst {worst:.2f} of the tolerance), repeats bit-identical",
          flush=True)
    for M in (320, 3200):
        for N, K in DENSE_MATRICES:
            x, w, b = randn(M, K), randn(N, K, scale=0.02), randn(N,
                                                                  scale=0.02)
            _, ms = time_ms(torch, lambda: dense_layer(x, w, b), device=True)
            _, lib = time_ms(torch, lambda: torch.nn.functional.linear(
                x, w, b), device=True)
            bnd = bound((M * K + N * K + N + M * N) * 2,
                        {"bf16_tensor": 2 * M * N * K})
            print(f"dense bf16 M={M} N={N} K={K}: device_ms={ms:.4f} "
                  f"({2 * M * N * K / ms / 1e9:.1f} TFLOP/s), bound_ms="
                  f"{bnd['bound_ms']:.4f} ({bnd['bound_by']}), library_ms="
                  f"{lib:.4f} (F.linear, {2 * M * N * K / lib / 1e9:.1f} "
                  f"TFLOP/s; L2 warm)", flush=True)


def check_attention_qkv(torch, dev):
    """#2 against its plain version, as :func:`check_attention`."""
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_attention import (
        beam_decode_attention_qkv, beam_decode_attention_qkv_plain)

    B, K, S, H, NH = 64, 5, 20, 768, 12
    Bk = B * K
    scale = 1.0 / (H // NH) ** 0.5
    g = torch.Generator(device=dev).manual_seed(2345)
    out = {}
    for family, P in ATTENTION_SHAPES:
        worst = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            w = _dense_weights(torch, g, dev, dtype, 1, H, 4 * H)

            def randn(*shape):
                return torch.randn(shape, generator=g, device=dev).to(dtype)

            for pos in (0, 7, 19):
                x = randn(Bk, H)
                kc, vc = randn(Bk, S, H), randn(Bk, S, H)
                pk, pv = (randn(B, P, H), randn(B, P, H)) if P else (None,
                                                                     None)
                anc = torch.randint(0, K, (Bk, S), generator=g, device=dev,
                                    dtype=torch.int32)
                kc1, vc1 = kc.clone(), vc.clone()
                kc2, vc2 = kc.clone(), vc.clone()
                ws = (w["wqkv"][0], w["bqkv"][0], w["wo"][0], w["bo"][0])
                args = dict(num_heads=NH, beam_size=K, scale=scale)
                got, _, _ = beam_decode_attention_qkv(
                    x, *ws, kc1, vc1, pk, pv, anc, pos, **args)
                want, _, _ = beam_decode_attention_qkv_plain(
                    x, *ws, kc2, vc2, pk, pv, anc, pos, **args)
                torch.cuda.synchronize()
                what = f"attention_qkv {name} P={P} pos={pos}"
                err = check_close(what, got, want, name, 1e-5, 4)
                for c, (a, b, o) in (("k", (kc1, kc2, kc)),
                                     ("v", (vc1, vc2, vc))):
                    check_appended(f"{what} {c}_cache", a, b, o, pos, name,
                                   1e-5, 1)
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
        out[family] = worst
    return out


def check_stack(torch, dev):
    """#3 against its plain version, as :func:`check_attention`; then the
    host's enqueue time of one call."""
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_stack import (
        beam_decode_stack, beam_decode_stack_plain)

    L, B, K, S, H, NH, P = 12, 64, 5, 20, 768, 12, 10
    Bk = B * K
    scale = 1.0 / (H // NH) ** 0.5
    g = torch.Generator(device=dev).manual_seed(3456)
    worst = 0.0
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
    host = []
    for _ in range(10):  # the host's share of one call: the device is idle
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beam_decode_stack(x, w, kc1, vc1, pk, pv, anc, pos, **args)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(f"stack bf16: host enqueue of one call (7 launches x {L} layers) "
          f"{statistics.median(host):.4f} ms", flush=True)
    return {"flagship": worst}


def check_encoder(torch, dev, results):
    from image_captioning_ml_project_tpu_torch.ops.encoder_stack import (
        encoder_stack, encoder_stack_plain)

    L, T, H, NH = 12, 50, 768, 12
    g = torch.Generator(device=dev).manual_seed(4567)
    # the eval CLI's batch of 5 (held only), then the served 64 (timed)
    for B, dtype in itertools.product((EVAL_BATCH, 64),
                                      (torch.float32, torch.bfloat16)):
        name = str(dtype)[6:]
        w = _dense_weights(torch, g, dev, dtype, L, H, 4 * H)
        x = torch.randn((B, T, H), generator=g, device=dev).to(dtype)
        with torch.inference_mode():
            got = encoder_stack(x, w, num_heads=NH)
            want = encoder_stack_plain(x, w, num_heads=NH)
            torch.cuda.synchronize()
            err = check_close(f"encoder {name} [{B}, {T}, {H}]", got, want,
                              name, 1e-4, 8)
            if dtype == torch.bfloat16 and B == 64:
                ms, dev_ms = time_ms(torch, lambda: encoder_stack(
                    x, w, num_heads=NH), device=True)
                plain_ms = time_ms(torch, lambda: encoder_stack_plain(
                    x, w, num_heads=NH))
        print(f"encoder {name} B={B}: output finite="
              f"{bool(got.isfinite().all())}", flush=True)
        check(bool(got.isfinite().all()), "encoder output is not finite")
    print(f"encoder bf16 [{B}, {T}, {H}] x {L} layers: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (170 MB of weights: above L2, no flush)",
          flush=True)
    # GEMMs: 2 * rows * 12 H^2 per layer on the tensor cores; attention: 4
    # operations per head dim of each (token, token) pair, in f32
    results["encoder_stack"] = {"flagship": shape_entry(
        f"L={L} B={B} T={T} H={H} bf16", err, ms, plain_ms,
        bound(stack_bytes(w) + 2 * B * T * H * 2,
              {"bf16_tensor": L * 24 * B * T * H * H,
               "f32": L * 4 * B * T * T * H}), device_ms=dev_ms)}


def check_cross(torch, dev):
    """#6, the Transformer decoder's cross-attention step, at the served
    shapes (64 images x 5 beams, 12 heads, width 768, 196 memory rows),
    masked and unmasked, against its plain version; returns the worst bf16
    error."""
    from image_captioning_ml_project_tpu_torch.ops.cross_attention import (
        cross_attention, cross_attention_plain)

    B, K, NH, H, Sm = 64, 5, 12, 768, 196
    hd = H // NH
    kw = dict(num_heads=NH, beam_size=K, scale=1.0 / hd ** 0.5)
    g = torch.Generator(device=dev).manual_seed(5678)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        q = torch.randn((B * K, H), generator=g, device=dev).to(dtype)
        mkt = torch.randn((B, H, Sm), generator=g, device=dev).to(dtype)
        mv = torch.randn((B, Sm, H), generator=g, device=dev).to(dtype)
        mask = torch.rand((B, Sm), generator=g, device=dev) < 0.25
        mask[:, 0] = False
        for masked in (True, False):
            m = mask if masked else None
            got = cross_attention(q, mkt, mv, m, **kw)
            want = cross_attention_plain(q, mkt, mv, m, **kw)
            torch.cuda.synchronize()
            # f32: the sums in another order; bf16: a weight within an f32
            # rounding of a bf16 boundary rounds the other way
            err = check_close(f"cross_attention {name} masked={masked}",
                              got, want, name, 1e-5, 2)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    return {"transformer": worst}


# the batches the service's buckets give the decode-step kernels, and the
# eval CLI's batch of 5 (inference.num_candidates: phase 8's path)
SWEEP_BATCHES = (1, 5, 8, 64)


def sweep_decode_kernels(torch, dev, smi, K=5, ancestry=True):
    """#1 and #2 (prefix-free and behind GPT-2's 10-row prefix), #3 and #6
    at batch 1, 5, 8 and 64 of ``K`` beams, through a random beam ancestry or
    with none (``ancestry`` False: greedy and nucleus decoding, K = 1),
    bf16, pos 19 of 20: each first held against its
    plain version on the same inputs with the tolerances of the checks
    above (a mismatch fails the run), then the device time, the event
    time, the bound, the plain version's time and, for #6, SDPA's time on
    the same inputs in their layouts (timed only). The inputs of #1, #2 and
    #6 are flushed from L2 before each run, as a decode step finds them
    (#3's 170 MB of weights are above L2). Uses nothing but the kernels'
    public wrappers, so that it can time an earlier tree's kernels too.
    Returns {kernel: {family: {batch: shape_entry}}}."""
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_attention import (
        beam_decode_attention, beam_decode_attention_plain,
        beam_decode_attention_qkv, beam_decode_attention_qkv_plain)
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_stack import (
        beam_decode_stack, beam_decode_stack_plain)
    from image_captioning_ml_project_tpu_torch.ops.cross_attention import (
        cross_attention, cross_attention_plain)

    S, H, NH, L, Sm, pos = 20, 768, 12, 12, 196, 19
    hd = H // NH
    scale = 1.0 / hd ** 0.5
    args = dict(num_heads=NH, beam_size=K, scale=scale)
    g = torch.Generator(device=dev).manual_seed(9012)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    dt = torch.bfloat16
    out = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    def record(kernel, family, B, shape, kern, plain, bnd, ulps, caches=(),
               cache_ulps=None, flushed=True, library=None):
        """Hold ``kern`` against ``plain`` on the same inputs, then time
        both. Each appends to ``caches`` in place: the kernel's output is
        held within ``ulps`` bf16 ulps of the plain version's, its caches
        bit-identical to the plain version's (``cache_ulps`` None) or, where
        the kernel's own QKV GEMM made the appended rows, bit-identical but
        at ``pos`` and within ``cache_ulps`` there."""
        what = f"sweep {kernel} {family} {tag}B={B}"
        before = [c.clone() for c in caches]
        got = kern()
        got_caches = [c.clone() for c in caches]
        for c, b in zip(caches, before):
            c.copy_(b)
        want = plain()
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            got, want = got[0], want[0]
        err = check_close(what, got, want, "bfloat16", None, ulps)
        for name, a, b, o in zip("kv", got_caches, caches, before):
            if cache_ulps is None:
                check(torch.equal(a, b), f"{what}: {name} caches differ from "
                                         f"the plain version's")
            else:
                check_appended(f"{what} {name}_cache", a, b, o, pos,
                               "bfloat16", None, cache_ulps)
        del before, got_caches
        ms, dev_ms = time_ms(torch, kern, flush=flush if flushed else None,
                             device=True)
        plain_ms = time_ms(torch, plain, flush=flush if flushed else None)
        lib_ms = (time_ms(torch, library, flush=flush)
                  if library is not None else None)
        entry = shape_entry(shape, err, ms, plain_ms, bnd, lib_ms, dev_ms)
        out.setdefault(kernel, {}).setdefault(family, {})[B] = entry
        lib = f", SDPA {lib_ms:.4f} ms" if lib_ms is not None else ""
        print(f"{what}: device {dev_ms:.4f} ms, event {ms:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), plain "
              f"{plain_ms:.4f} ms{lib} [{smi}]", flush=True)

    tag = "" if (K, ancestry) == (5, True) else \
        f"K={K}{'' if ancestry else ' no-ancestry'} "
    note = "" if ancestry else " no-ancestry"
    for B in SWEEP_BATCHES:
        Bk = B * K
        anc = (torch.randint(0, K, (Bk, S), generator=g, device=dev,
                             dtype=torch.int32) if ancestry else None)
        w1 = _dense_weights(torch, g, dev, dt, 1, H, 4 * H)
        ws = (w1["wqkv"][0], w1["bqkv"][0], w1["wo"][0], w1["bo"][0])
        for family, P in ATTENTION_SHAPES:
            q, kn, vn, x = (randn(Bk, H) for _ in range(4))
            kc, vc = randn(Bk, S, H), randn(Bk, S, H)
            pk, pv = (randn(B, P, H), randn(B, P, H)) if P else (None, None)
            nbytes, ops = attention_work(torch, anc, pos, B, K, H, P, 2)
            shape = f"B={B} K={K} S={S} H={H} P={P} pos={pos} bf16{note}"
            record("beam_decode_attention", family, B, shape,
                   lambda: beam_decode_attention(q, kn, vn, kc, vc, pk, pv,
                                                 anc, pos, **args),
                   lambda: beam_decode_attention_plain(
                       q, kn, vn, kc, vc, pk, pv, anc, pos, **args),
                   bound(nbytes + 4 * Bk * H * 2, {"f32": ops}), 2,
                   caches=(kc, vc))
            record("beam_decode_attention_qkv", family, B, shape,
                   lambda: beam_decode_attention_qkv(x, *ws, kc, vc, pk, pv,
                                                     anc, pos, **args),
                   lambda: beam_decode_attention_qkv_plain(
                       x, *ws, kc, vc, pk, pv, anc, pos, **args),
                   bound(nbytes + (2 * Bk * H + 4 * H * H + 4 * H) * 2,
                         {"f32": ops, "bf16_tensor": 8 * Bk * H * H}), 4,
                   caches=(kc, vc), cache_ulps=1)
        P = 10
        w = _dense_weights(torch, g, dev, dt, L, H, 4 * H)
        x = randn(Bk, H)
        kc, vc = randn(L, Bk, S, H), randn(L, Bk, S, H)
        pk, pv = randn(L, B, P, H), randn(L, B, P, H)
        nbytes, ops = attention_work(torch, anc, pos, B, K, H, P, 2, layers=L)
        record("beam_decode_stack", "flagship", B,
               f"L={L} B={B} K={K} S={S} H={H} P={P} pos={pos} bf16{note}",
               lambda: beam_decode_stack(x, w, kc, vc, pk, pv, anc, pos,
                                         **args),
               lambda: beam_decode_stack_plain(x, w, kc, vc, pk, pv, anc,
                                               pos, **args),
               bound(nbytes + stack_bytes(w) + 2 * Bk * H * 2,
                     {"f32": ops, "bf16_tensor": L * 24 * Bk * H * H}), 8,
               caches=(kc, vc), cache_ulps=8, flushed=False)
        del w, kc, vc
        q = randn(Bk, H)
        mkt, mv = randn(B, H, Sm), randn(B, Sm, H)
        mask = torch.rand((B, Sm), generator=g, device=dev) < 0.25
        mask[:, 0] = False
        # the one PyTorch call: q [B, NH, K, hd], keys viewed from mem_kt
        # (strided: hd is not the contiguous axis), values viewed from
        # mem_v, the mask as SDPA's (True = attend)
        q4 = q.view(B, K, NH, hd).transpose(1, 2)
        k4 = mkt.view(B, NH, hd, Sm).transpose(2, 3)
        v4 = mv.view(B, Sm, NH, hd).transpose(1, 2)
        attend = ~mask[:, None, None, :]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=attend, scale=scale)

        kw = dict(num_heads=NH, beam_size=K, scale=scale)
        record("cross_attention", "transformer", B,
               f"B={B} K={K} H={H} Sm={Sm} masked bf16",
               lambda: cross_attention(q, mkt, mv, mask, **kw),
               lambda: cross_attention_plain(q, mkt, mv, mask, **kw),
               bound((2 * Bk * H + 2 * B * Sm * H) * 2 + B * Sm,
                     {"f32": 4 * Bk * Sm * H}), 2,
               library=sdpa)
        if B == SWEEP_BATCHES[-1]:
            sdpa_err = max_err(sdpa().transpose(1, 2).reshape(Bk, H),
                               cross_attention_plain(q, mkt, mv, mask, **kw))
            print(f"cross_attention B={B}: SDPA's max_abs_err against the "
                  f"plain version {sdpa_err:.3e}", flush=True)
    return out


# the attention variants' shapes on the LSTM family's served path: 64 images
# x 5 beams, one query per row, 7x7 = 49 ResNet feature rows, width 512 (8
# heads of 64 for SDPA); and the teacher-forced shape, 64 images x 20
# positions
LSTM_ATTENTION_SHAPES = (("served", 64, 5, 1), ("teacher-forced", 64, 1, 20))
LSTM_S, LSTM_H, LSTM_NH = 49, 512, 8


def _attention_memory(torch, g, dev, dtype, B, K, Q):
    """Queries [B*K, Q, H], per-image keys and values [B, S, H] and a
    random mask [B, S] (a quarter of the keys, never the first)."""
    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    mask = torch.rand((B, LSTM_S), generator=g, device=dev) < 0.25
    mask[:, 0] = False
    return (randn(B * K, Q, LSTM_H), randn(B, LSTM_S, LSTM_H),
            randn(B, LSTM_S, LSTM_H), mask)


def _sdpa_heads(x):
    """[N, T, H] -> the [N, NH, T, hd] view, as the multi-head module takes
    it (the heads transposed, no copy)."""
    N, T, _ = x.shape
    return x.view(N, T, LSTM_NH, LSTM_H // LSTM_NH).transpose(1, 2)


def check_sdpa_once(torch, what, q, k, v, mask, dtype, **kw):
    """#7 against its plain version: weights within 1e-5 of the largest;
    the context in f32 within 1e-5 of its largest (another summation
    order), in bf16 within 2 ulps (a weight within an f32 rounding of a
    bf16 boundary rounds the other way). Returns the context's error."""
    from image_captioning_ml_project_tpu_torch.ops.sdpa import (sdpa,
                                                                sdpa_plain)

    ctx, w = sdpa(q, k, v, mask, **kw)
    ctx_p, w_p = sdpa_plain(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    err = check_close(f"{what} context", ctx, ctx_p, dtype, 1e-5, 2)
    check_close(f"{what} weights", w, w_p, "float32", 1e-5, 0)
    return err


def check_sdpa(torch, dev):
    """The multi-head variant's SDPA at the LSTM family's shapes against
    its plain version, in float32 and bfloat16, unmasked, masked, and
    masked with one image's keys all masked (uniform weights 1/S over its
    real keys); bf16 must take the tensor-core route and float32 the
    CUDA-core one. Returns {"lstm": the worst bf16 context error at the
    served shape}."""
    from image_captioning_ml_project_tpu_torch.ops.sdpa import sdpa

    hd = LSTM_H // LSTM_NH
    g = torch.Generator(device=dev).manual_seed(6789)
    worst = 0.0
    for label, B, K, Q in LSTM_ATTENTION_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            q, k, v, mask = _attention_memory(torch, g, dev, dtype, B, K, Q)
            q, k, v = _sdpa_heads(q), _sdpa_heads(k), _sdpa_heads(v)
            dark = mask.clone()
            dark[B // 2] = True
            for masking, m in (("unmasked", None), ("masked", mask),
                               ("one image all masked", dark)):
                what = f"sdpa {name} {label} [{B}x{K}, Q={Q}] {masking}"
                err = check_sdpa_once(torch, what, q, k, v, m, name,
                                      scale=hd ** -0.5, beam_size=K)
                want = "tensor_cores" if dtype == torch.bfloat16 \
                    else "cuda_cores"
                check(sdpa.last_route == want,
                      f"{what}: ran on the {sdpa.last_route} route, "
                      f"expected {want}")
                if dtype == torch.bfloat16 and label == "served":
                    worst = max(worst, err)
    return {"lstm": worst}


def sdpa_bound(B, K, Q):
    """bf16 q read and the context written, the image's keys and values
    read once, the f32 weights written, the mask read; the two products, 4
    operations per (row, key, width), on the tensor cores."""
    rows = B * K * Q
    nbytes = (2 * rows * LSTM_H + 2 * B * LSTM_S * LSTM_H) * 2 \
        + rows * LSTM_NH * LSTM_S * 4 + B * LSTM_S
    return bound(nbytes, {"bf16_tensor": 4 * rows * LSTM_S * LSTM_H})


def sweep_sdpa(torch, dev, smi):
    """#7 at the LSTM's served shape (5 beams, one query, 49 keys, 8 heads
    of 64, masked, bf16) at batch 1, 5, 8 and 64, and at the teacher-forced
    shape (64 images x 20 positions): held against its plain version, then
    the device time, event time, bound, the plain version's time and
    ``scaled_dot_product_attention``'s on the same q/k/v (timed only: SDPA
    gives no weights, and the port never calls it), the inputs flushed from
    L2 before each run. Uses only the public wrappers (``--time-tree``).
    Returns {"lstm": {batch or "teacher-forced": shape_entry}}."""
    from image_captioning_ml_project_tpu_torch.ops.sdpa import (sdpa,
                                                                sdpa_plain)

    NH, hd = LSTM_NH, LSTM_H // LSTM_NH
    g = torch.Generator(device=dev).manual_seed(6790)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {}
    cases = [(B, B, 5, 1) for B in SWEEP_BATCHES] + [
        ("teacher-forced", 64, 1, 20)]
    for key, B, K, Q in cases:
        q, k, v, mask = _attention_memory(torch, g, dev, torch.bfloat16, B,
                                          K, Q)
        q, k, v = _sdpa_heads(q), _sdpa_heads(k), _sdpa_heads(v)
        kw = dict(scale=hd ** -0.5, beam_size=K)
        what = f"sweep sdpa lstm {key if key != B else f'B={B}'}"
        err = check_sdpa_once(torch, what, q, k, v, mask, "bfloat16", **kw)
        ms, dev_ms = time_ms(torch, lambda: sdpa(q, k, v, mask, **kw),
                             flush=flush, device=True)
        plain_ms = time_ms(torch, lambda: sdpa_plain(q, k, v, mask, **kw),
                           flush=flush)
        # SDPA on the same values: q [B, K, NH, Q, hd], the image's keys and
        # values expanded over its beams (views), the mask as SDPA's (True
        # = attend)
        q5 = q.reshape(B, K, NH, Q, hd)
        k5 = k[:, None].expand(B, K, NH, LSTM_S, hd)
        v5 = v[:, None].expand(B, K, NH, LSTM_S, hd)
        attend = ~mask[:, None, None, None, :]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q5, k5, v5, attn_mask=attend, scale=kw["scale"])

        lib_ms = time_ms(torch, library, flush=flush)
        bnd = sdpa_bound(B, K, Q)
        print(f"{what} [{B}x{K}, Q={Q}, S={LSTM_S}, {NH}x{hd}, masked]: "
              f"device {dev_ms:.4f} ms, event {ms:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), plain "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (L2 flushed) "
              f"[{smi}]", flush=True)
        if key == SWEEP_BATCHES[-1]:
            lib_err = max_err(library().reshape(B * K, NH, Q, hd),
                              sdpa_plain(q, k, v, mask, **kw)[0])
            print(f"{what}: SDPA's max_abs_err against the plain context "
                  f"{lib_err:.3e}", flush=True)
        out[key] = shape_entry(
            f"B={B} K={K} Q={Q} S={LSTM_S} NH={NH} hd={hd} masked bf16",
            err, ms, plain_ms, bnd, lib_ms, dev_ms)
    return {"lstm": out}


def additive_inputs(torch, g, dev, dtype, B, K, Q):
    """Projected queries and keys (scaled so that the tanh is not
    saturated), the energy weights and bias, and a random mask."""
    qp, kp, _, mask = _attention_memory(torch, g, dev, dtype, B, K, Q)
    ew = (torch.randn((1, LSTM_H), generator=g, device=dev) * 0.05).to(dtype)
    eb = torch.randn((1,), generator=g, device=dev).to(dtype)
    return qp * 0.5, kp * 0.5, ew, eb, mask


def check_additive_once(torch, what, qp, kp, ew, eb, mask, **kw):
    """#8 against its plain version plus the energy bias: masked scores
    bit-identical, the others within 1e-5 of the largest (the sum and the
    tanh round as the plain version's do; only the f32 sum's order
    differs). Returns the error."""
    from image_captioning_ml_project_tpu_torch.ops.additive_scores import (
        additive_scores, additive_scores_plain)

    got = additive_scores(qp, kp, ew, eb, mask, **kw)
    want = additive_scores_plain(qp, kp, ew, mask, **kw) \
        + eb.reshape(()) / kw["temperature"]
    torch.cuda.synchronize()
    keep = want > -1e8
    check(torch.equal(got[~keep], want[~keep]),
          f"{what}: masked scores differ")
    return check_close(what, got[keep], want[keep], "float32", 1e-5, 0)


def check_additive(torch, dev):
    """The soft variant's additive scores at the LSTM family's served
    shapes at batch 1, 5, 8 and 64 and its teacher-forced shape, masked and
    unmasked, float32 and bfloat16."""
    g = torch.Generator(device=dev).manual_seed(7890)
    shapes = [("served", B, 5, 1) for B in SWEEP_BATCHES] + [
        s for s in LSTM_ATTENTION_SHAPES if s[0] == "teacher-forced"]
    for label, B, K, Q in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            qp, kp, ew, eb, mask = additive_inputs(torch, g, dev, dtype, B,
                                                   K, Q)
            for masked in (True, False):
                check_additive_once(
                    torch, f"additive_scores {str(dtype)[6:]} {label} "
                           f"[{B}x{K}, Q={Q}] masked={masked}",
                    qp, kp, ew, eb, mask if masked else None,
                    temperature=1.0, beam_size=K)


def additive_bound(B, K, Q, item):
    """The inputs read once and the scores written; per (row, key, width)
    an add, a tanh, a multiply and an add, four operations on the CUDA
    cores (a tanh needs no special-function unit: a table of its bf16
    roundings or a polynomial of fused multiply-adds computes it)."""
    n = B * K * Q * LSTM_S * LSTM_H
    nbytes = (B * K * Q * LSTM_H + B * LSTM_S * LSTM_H + LSTM_H + 1) * item \
        + B * K * Q * LSTM_S * 4 + B * LSTM_S
    return bound(nbytes, {"f32": 4 * n})


def sweep_additive(torch, dev, smi):
    """#8 at the LSTM's served shape at batch 1, 5, 8 and 64, masked, bf16:
    held against its plain version plus the bias, then its device time,
    event time, bound and the plain version's time, its inputs flushed
    from L2 before each run. Uses only the public wrappers
    (``--time-tree``). Returns {"lstm": {batch: shape_entry}}."""
    from image_captioning_ml_project_tpu_torch.ops.additive_scores import (
        additive_scores, additive_scores_plain)

    g = torch.Generator(device=dev).manual_seed(8790)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {}
    K, Q = 5, 1
    kw = dict(temperature=1.0, beam_size=K)
    for B in SWEEP_BATCHES:
        qp, kp, ew, eb, mask = additive_inputs(torch, g, dev, torch.bfloat16,
                                               B, K, Q)
        what = f"sweep additive_scores lstm B={B}"
        err = check_additive_once(torch, what, qp, kp, ew, eb, mask, **kw)
        ms, dev_ms = time_ms(torch, lambda: additive_scores(
            qp, kp, ew, eb, mask, **kw), flush=flush, device=True)
        plain_ms = time_ms(torch, lambda: additive_scores_plain(
            qp, kp, ew, mask, **kw) + eb.reshape(()) / kw["temperature"],
            flush=flush)
        bnd = additive_bound(B, K, Q, 2)
        print(f"{what} [{B}x{K}, Q={Q}, S={LSTM_S}, H={LSTM_H}, masked]: "
              f"device {dev_ms:.4f} ms, event {ms:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), plain "
              f"{plain_ms:.4f} ms (L2 flushed) [{smi}]", flush=True)
        # no one PyTorch call computes additive scores
        out[B] = shape_entry(
            f"B={B} K={K} Q={Q} S={LSTM_S} H={LSTM_H} masked bf16", err, ms,
            plain_ms, bnd, device_ms=dev_ms)
    return {"lstm": out}


SWITCHES = ("ICT_DECODE_STACK", "ICT_DECODE_FOLD", "ICT_ENCODER_FOLD")
# the decode configurations: (name, the switches' values); the Transformer
# decoder reads ICT_DECODE_FOLD alone
CONFIGS = (("stack + encoder fold", ("1", "1", "1")),
           ("fold", ("0", "1", "1")),
           ("split", ("0", "0", "0")))
TRANSFORMER_CONFIGS = (("transformer fold", ("1", "1", "1")),
                       ("transformer split", ("1", "0", "1")))


def set_switches(values):
    for name, value in zip(SWITCHES, values):
        os.environ[name] = value


def decode(torch, model, cfg, images):
    """Beam search over ``images`` (or a region dict) on ``model``."""
    from image_captioning_ml_project_tpu_torch.inference.decoding import (
        batch_size_of, beam_search)

    mc, ic = cfg.model, cfg.inference
    with torch.inference_mode():
        state = model.init_cache(images, ic.max_length)
        return beam_search(model.step, state, batch_size_of(images),
                           ic.beam_size,
                           mc.bos_token_id, mc.eos_token_id, mc.pad_token_id,
                           ic.max_length, length_penalty=ic.length_penalty,
                           min_length=ic.min_length)


def check_reference(torch, dev, cfg, tree, images, configs, peaked=False,
                    strategies=False):
    """The card's float32 decode through the kernels against the CPU's
    plain-version decode of the same weights and images, on each decode
    configuration of ``configs``; ``peaked`` first scales an LSTM's output
    layer (:func:`peak_logits`). With ``strategies``, then the other
    decodes on the first configuration (:func:`check_strategies`)."""
    from image_captioning_ml_project_tpu_torch.models.captioning_model import (
        load_model)

    cfg32 = copy.deepcopy(cfg)
    cfg32.model.dtype = "float32"
    x = torch.from_numpy(images)
    models = {where.type: load_model(cfg32, where, params=tree)
              for where in (dev, torch.device("cpu"))}
    if peaked:
        factor = peak_logits(torch, cfg32, models, images)
        print(f"reference: output layer scaled {factor:.4g}x to first-step "
              f"logits of std 3", flush=True)
    for name, values in configs:
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
    if strategies:
        set_switches(configs[0][1])
        check_strategies(torch, models, cfg32, x, configs[0][0])
    set_switches(CONFIGS[0][1])


def check_strategies(torch, models, cfg, x, name):
    """Greedy, diverse beam (6 beams in 3 groups, penalty 0.5), the
    model's ``generate`` and nucleus sampling (top-p 0.9, the same noise
    drawn on the CPU fed to both) on the card and on the CPU: tokens
    identical, diverse scores and nucleus log-probabilities within 1e-4.
    Of the diverse beam the best hypothesis is compared, the caption
    ``decode()`` serves, with its score; the other five and all six scores
    are printed. They need not agree: where two of a group's candidates
    tie within the devices' float32 error (the seeded models' beams repeat
    a token, and the place of a second token in them barely moves their
    score), either device may keep either, and the token counts behind the
    next groups' penalty, so those groups' hypotheses, follow that
    choice."""
    from image_captioning_ml_project_tpu_torch.inference import decoding

    mc, ic = cfg.model, cfg.inference
    ids = (mc.bos_token_id, mc.eos_token_id, mc.pad_token_id)
    B, L = x.shape[0], ic.max_length
    own_noise = decoding.gumbel_noise

    def noise_from_cpu(seed):
        g = torch.Generator().manual_seed(seed)
        return lambda shape, generator, device: own_noise(
            shape, g, torch.device("cpu")).to(device)

    def greedy(model, state):
        return decoding.greedy_decode(
            model.step, state, B, ids[0], L, eos_token_id=ids[1],
            pad_token_id=ids[2], min_length=ic.min_length), None

    def diverse(model, state):
        res = decoding.beam_search(
            model.step, state, B, 6, *ids, L,
            length_penalty=ic.length_penalty, min_length=ic.min_length,
            num_beam_groups=3, diversity_penalty=0.5, return_all=True)
        every.append((res.tokens.cpu(), res.scores.cpu()))
        return res.tokens[:, 0], res.scores[:, 0]

    def nucleus(model, state):
        decoding.gumbel_noise = noise_from_cpu(1234)
        try:
            res = decoding.sample_decode(
                model.step, state, None, B, *ids, L, top_p=0.9,
                min_length=ic.min_length)
        finally:
            decoding.gumbel_noise = own_noise
        return res.tokens, res.logprobs

    every = []  # the diverse beam's hypotheses, card then CPU
    for strategy, run in (("greedy", greedy), ("diverse K=6 G=3", diverse),
                          ("nucleus top-p 0.9", nucleus), ("generate", None)):
        out = {}
        for where, model in models.items():
            t0 = time.perf_counter()
            images = x.to(next(model.parameters()).device)
            with torch.inference_mode():
                if run is None:
                    tokens, extra = model.generate(images)[0], None
                else:
                    state = model.init_cache(images, L)
                    tokens, extra = run(model, state)
            out[where] = (tokens.cpu(),
                          None if extra is None else extra.float().cpu())
            print(f"reference [{name}] {strategy} on {where}: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
        (tok_g, ex_g), (tok_c, ex_c) = out.values()
        print(f"reference [{name}] {strategy} tokens gpu={tok_g.tolist()}",
              flush=True)
        if ex_g is not None:
            err = float((ex_g - ex_c).abs().max())
            print(f"reference [{name}] {strategy} scores/log-probs "
                  f"max_abs_err={err:.3e}", flush=True)
            if run is diverse:
                (all_g, sc_g), (all_c, sc_c) = every
                print(f"reference [{name}] {strategy} all 6 scores gpu="
                      f"{sc_g.tolist()} cpu={sc_c.tolist()}; all 6 "
                      f"hypotheses equal: {torch.equal(all_g, all_c)}",
                      flush=True)
        check(torch.equal(tok_g, tok_c),
              f"[{name}] {strategy}: card and CPU decode different tokens "
              f"(cpu={tok_c.tolist()})")
        if ex_g is not None:
            check(torch.isfinite(ex_g).all() and err <= 1e-4,
                  f"[{name}] {strategy}: scores differ by {err} > 1e-4")


# openai/clip-vit-base-patch32's widths (its HF config): the reranker's
# scorer at full width; the word-hash tokenizer's special ids are CLIP's
CLIP_SOT, CLIP_EOT, CLIP_POSITIONS = 49406, 49407, 77


def clip_tokenize(texts):
    """A deterministic word-hash CLIP tokenizer: SOT, one id in
    [1, 49405] per word, EOT, then EOT as padding to 77 positions (the
    real tokenizer's pad token is its EOT)."""
    import numpy as np

    out = np.full((len(texts), CLIP_POSITIONS), CLIP_EOT, np.int32)
    for r, text in enumerate(texts):
        words = [1 + sum(ord(c) * 131 ** i for i, c in enumerate(w))
                 % (CLIP_SOT - 1) for w in text.split()]
        row = [CLIP_SOT] + words[:CLIP_POSITIONS - 2] + [CLIP_EOT]
        out[r, :len(row)] = row
    return out


def clip_scorer(torch, device, seed):
    """The CLIP scorer at openai/clip-vit-base-patch32's widths (vision
    ViT-B/32 on 224x224, text width 512 x 12 layers, 8 heads, vocabulary
    49408, 77 positions, projection 512) in float32 on ``device``, weights
    drawn from ``seed``: N(0, 0.02^2), LayerNorm scales 1 and biases 0,
    ``logit_scale`` CLIP's initial 2.6592."""
    from image_captioning_ml_project_tpu_torch.models.clip_text import (
        CLIPScorer)
    from image_captioning_ml_project_tpu_torch.params import load_scorer

    with torch.device("meta"):
        scorer = CLIPScorer()
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in scorer.state_dict().items():
        if name == "logit_scale":
            sd[name] = torch.tensor(2.6592)
        elif "norm" in name:
            sd[name] = (torch.ones if name.endswith("weight")
                        else torch.zeros)(p.shape)
        else:
            sd[name] = torch.randn(p.shape, generator=g) * 0.02
    return load_scorer(scorer, sd, device)


def check_scorer(torch, dev, images, seed):
    """The full-width CLIP scorer on the card (vision tower through #5 at
    float32) against the CPU (its plain version), on 5 seeded candidate
    captions for each image: scores within 1e-4 of the largest, the same
    winners. Returns the card's scorer."""
    import numpy as np

    from image_captioning_ml_project_tpu_torch.inference.reranking import (
        CLIPReranker, rerank_candidates)

    rs = np.random.RandomState(seed)
    cand = torch.from_numpy(rs.randint(4, 50257, (images.shape[0], 5, 20)))

    def decode_fn(ids):
        return " ".join(f"w{int(i)}" for i in ids)

    out = []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        scorer = clip_scorer(torch, where, seed)
        reranker = CLIPReranker(scorer, clip_tokenize, decode_fn)
        with torch.inference_mode():
            best, scores = rerank_candidates(
                cand, torch.from_numpy(images).to(where), decode_fn,
                clip_tokenize, scorer, score_fn=reranker.score)
        out.append((best, scores, scorer))
        print(f"reference [CLIP scorer] on {where}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    (best_g, sc_g, scorer), (best_c, sc_c, _) = out
    err = float(np.abs(sc_g - sc_c).max())
    tol = 1e-4 * float(np.abs(sc_c).max())
    print(f"reference [CLIP scorer] scores gpu={sc_g.tolist()} "
          f"cpu={sc_c.tolist()} max_abs_err={err:.3e} (tol {tol:.3e})",
          flush=True)
    check(np.isfinite(sc_g).all() and err <= tol,
          f"CLIP scorer: scores differ by {err} > {tol}")
    check(np.array_equal(best_g, best_c),
          "CLIP scorer: card and CPU pick different captions")
    return scorer


# the LSTM family's configurations: (name, attention variant, use_pallas);
# adaptive and AoA wrap the multi-head core at the served 8 heads
LSTM_VARIANTS = (("lstm soft", "soft", True),
                 ("lstm multi_head", "multi_head", True),
                 ("lstm adaptive", "adaptive", True),
                 ("lstm aoa", "aoa", True),
                 ("lstm soft, use_pallas=False", "soft", False))


def lstm_variant(cfg, attention, use_pallas, seed):
    """``cfg`` with the given attention variant and kernel switch, and its
    weights drawn from ``seed``."""
    from image_captioning_ml_project_tpu_torch.config import AttentionType
    from image_captioning_ml_project_tpu_torch.params import init_flax_params

    cfg = copy.deepcopy(cfg)
    cfg.model.attention.attention_type = AttentionType(attention)
    cfg.model.attention.use_pallas = use_pallas
    return cfg, init_flax_params(cfg, seed)


def peak_logits(torch, cfg, models, images, target_std=3.0):
    """Scale the LSTM's output layer, on every model of ``models``, so that
    the CPU model's first-step logits have a standard deviation of
    ``target_std`` over the vocabulary. The seeded LSTM's logits are either
    nearly flat (the multi-head, adaptive and AoA contexts are small) or
    saturated (the soft context mixes the large ResNet features): its beams
    then sit in near-ties that either device's f32 summation order may
    flip, or agree trivially with every score 0. Peaked as a trained
    model's are, the card-against-CPU check is meaningful. Returns the
    factor."""
    cpu = models["cpu"]
    with torch.inference_mode():
        state = cpu.init_cache(torch.from_numpy(images),
                               cfg.inference.max_length)
        bos = torch.full((images.shape[0],), cfg.model.bos_token_id)
        logits = cpu.step(state, bos)[0].float()
        factor = target_std / float(logits.std(dim=-1).mean())
        for model in models.values():
            model.decoder.output_layer.weight.mul_(factor)
            model.decoder.output_layer.bias.mul_(factor)
    return factor


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


def counters():
    """Each kernel's wrapper by name; its ``launches`` is the kernel's
    count."""
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_attention import (
        beam_decode_attention, beam_decode_attention_qkv)
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_stack import (
        beam_decode_stack)
    from image_captioning_ml_project_tpu_torch.ops.cross_attention import (
        cross_attention)
    from image_captioning_ml_project_tpu_torch.ops.encoder_stack import (
        encoder_stack)
    from image_captioning_ml_project_tpu_torch.ops.additive_scores import (
        additive_scores)
    from image_captioning_ml_project_tpu_torch.ops.lse import (
        lse_and_block_max)
    from image_captioning_ml_project_tpu_torch.ops.sdpa import sdpa

    return {f.__name__: f for f in (
        beam_decode_stack, encoder_stack, lse_and_block_max,
        beam_decode_attention_qkv, beam_decode_attention, cross_attention,
        sdpa, additive_scores)}


def serve(torch, dev, cfg, tree, smi, plan, scorer=None):
    """``CaptionService`` for ``cfg`` behind its HTTP front end; ``plan``
    lists (name, switches, rounds of 64, single requests), each driven with
    the launch counters set to 0 just before and read just after. With a
    CLIP ``scorer`` the service reranks its beam candidates with it (the
    word-hash CLIP tokenizer). Returns {name: run}."""
    from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab
    from image_captioning_ml_project_tpu_torch.inference.reranking import (
        CLIPReranker)
    from image_captioning_ml_project_tpu_torch.inference.server import (
        CaptionService, make_http_server)

    kernels = counters()
    # no tokenizer files are in the repository: a word vocabulary of the
    # model's size stands in for them
    words = {w: i for i, w in enumerate(WordVocab.specials)}
    words.update({f"w{i}": i for i in range(len(words),
                                              cfg.model.vocab_size)})
    tokenizer = WordVocab(words)
    reranker = None if scorer is None else CLIPReranker(
        scorer, clip_tokenize,
        lambda ids: tokenizer.decode(ids, skip_special_tokens=True))
    t0 = time.perf_counter()
    service = CaptionService(cfg, tokenizer, dev, params=tree,
                             reranker=reranker, batch_size=64,
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
    need = sum(64 * (rounds + 1) + singles for _, _, rounds, singles in plan)
    images = torch.randint(0, 256, (need, size, size, 3), generator=g,
                           dtype=torch.uint8).numpy()
    served = {}

    def drive(name, rounds, singles, lo):
        """Serve ``rounds`` bursts of 64 and ``singles`` single requests on
        the switches set now, from image ``lo`` on."""
        for fn in kernels.values():
            fn.launches = 0
        steps0 = service.stats.decode_steps
        batches0 = service.stats.batches
        captions, batch_s, single_s = [], [], []
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
        check_ancestry(dev, name)
        run = {"captions": captions,
               "steps": service.stats.decode_steps - steps0,
               "batches": service.stats.batches - batches0,
               "launches": {k: fn.launches for k, fn in kernels.items()}}
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

    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        print(f"/healthz: {health}", flush=True)
        check(health.get("ok") is True, "/healthz is not ok")
        lo = 0
        for name, switches, rounds, singles in plan:
            set_switches(switches)
            # one untimed round of 64 on these switches first, before the
            # counters are set to 0: the timed rounds find this
            # configuration's kernels loaded and its buffers allocated
            warm = [service.submit_async(img) for img in images[lo:lo + 64]]
            for r in warm:
                service.result(r)
            lo += 64
            served[name] = drive(name, rounds, singles, lo)
            lo += 64 * rounds + singles
        set_switches(CONFIGS[0][1])
        print(f"captions[0]: {served[plan[0][0]]['captions'][0]!r}",
              flush=True)
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            check(json.loads(r.read())["completed"] >= lo,
                  "/stats misses completed requests")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()
    return served


def check_ancestry(dev, what):
    """The beam attention's error word is clear: no launch on ``dev`` met
    an ancestry entry outside [0, K) (read once per phase: a host sync)."""
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_attention import (
        ancestry_fault)

    fault = ancestry_fault(dev)
    print(f"[{what}] ancestry error word clear={not fault}", flush=True)
    check(not fault, f"[{what}] an ancestry entry outside [0, K) reached "
                     f"the beam attention")


def expect(run, want):
    """Every counter of ``run`` equals ``want``'s entry, 0 where absent."""
    for name, got in run["launches"].items():
        check(got == want.get(name, 0),
              f"{name} launched {got} times, expected {want.get(name, 0)}")


def serve_all(torch, dev, smi, trees):
    """The LSTM family, then the Transformer family, then CLIP + GPT-2
    (module docstring, phase 6); checks every counter of every run.
    Returns {kernel: {family: count}}, each family's count from the run of
    its configuration that carries the kernel."""
    cfg, tree = trees["lstm"]
    runs = {}
    # (variant, rounds of 64, single requests): soft with its kernel (the
    # configuration ``--config lstm`` serves), multi-head with its kernel,
    # and soft without either new kernel, in the same run
    for (name, attention, pallas), rounds, singles in (
            (LSTM_VARIANTS[0], 1, 3), (LSTM_VARIANTS[1], 1, 0),
            (LSTM_VARIANTS[4], 1, 0)):
        if attention == cfg.model.attention.attention_type.value:
            vcfg = copy.deepcopy(cfg)
            vcfg.model.attention.use_pallas = pallas
            vtree = tree
        else:
            vcfg, vtree = lstm_variant(cfg, attention, pallas, cfg.seed)
        runs.update(serve(torch, dev, vcfg, vtree, smi,
                          [(name, CONFIGS[0][1], rounds, singles)]))
    soft, mha, xla = (runs[LSTM_VARIANTS[i][0]] for i in (0, 1, 4))
    expect(soft, {"additive_scores": soft["steps"],
                  "lse_and_block_max": soft["steps"]})
    expect(mha, {"sdpa": mha["steps"], "lse_and_block_max": mha["steps"]})
    expect(xla, {"lse_and_block_max": xla["steps"]})

    cfg, tree = trees["transformer"]
    layers = cfg.model.decoder.num_layers
    runs = serve(torch, dev, cfg, tree, smi,
                 [(name, values, rounds, singles) for (name, values), rounds,
                  singles in zip(TRANSFORMER_CONFIGS, (3, 1), (3, 0))])
    tf_fold, tf_split = (runs[name] for name, _ in TRANSFORMER_CONFIGS)
    expect(tf_fold, {"cross_attention": tf_fold["steps"] * layers,
                     "beam_decode_attention_qkv": tf_fold["steps"] * layers,
                     "lse_and_block_max": tf_fold["steps"]})
    expect(tf_split, {"cross_attention": tf_split["steps"] * layers,
                      "beam_decode_attention": tf_split["steps"] * layers,
                      "lse_and_block_max": tf_split["steps"]})

    cfg, tree = trees["flagship"]
    layers = cfg.model.decoder.num_layers
    runs = serve(torch, dev, cfg, tree, smi,
                 [(name, values, rounds, singles) for (name, values), rounds,
                  singles in zip(CONFIGS, (3, 1, 1), (3, 0, 0))])
    main_run, fold_run, split_run = (runs[name] for name, _ in CONFIGS)
    expect(main_run, {"beam_decode_stack": main_run["steps"],
                      "encoder_stack": main_run["batches"],
                      "lse_and_block_max": main_run["steps"]})
    expect(fold_run, {"beam_decode_attention_qkv": fold_run["steps"] * layers,
                      "encoder_stack": fold_run["batches"],
                      "lse_and_block_max": fold_run["steps"]})
    expect(split_run, {"beam_decode_attention": split_run["steps"] * layers,
                       "lse_and_block_max": split_run["steps"]})
    carriers = {
        "sdpa": {"lstm": mha},
        "additive_scores": {"lstm": soft},
        "cross_attention": {"transformer": tf_fold},
        "beam_decode_attention_qkv": {"transformer": tf_fold,
                                      "flagship": fold_run},
        "beam_decode_attention": {"transformer": tf_split,
                                  "flagship": split_run},
        "lse_and_block_max": {"lstm": soft, "transformer": tf_fold,
                              "flagship": main_run},
        "beam_decode_stack": {"flagship": main_run},
        "encoder_stack": {"flagship": main_run}}
    return {name: {family: run["launches"][name]
                   for family, run in by_family.items()}
            for name, by_family in carriers.items()}


# the flagship's other decoding options, one service each: (name, the
# inference settings)
STRATEGIES = (
    ("flagship greedy", dict(decoding_strategy="greedy")),
    ("flagship nucleus top-p 0.9", dict(decoding_strategy="nucleus",
                                        top_p=0.9)),
    ("flagship diverse beam 6 in 3 groups", dict(
        beam_size=6, num_beam_groups=3, diversity_penalty=0.5)),
    ("flagship beam 5 + CLIP reranking", dict(
        beam_size=5, num_candidates=5, use_clip_reranking=True)),
)


def serve_strategies(torch, dev, smi, cfg, tree, scorer):
    """The flagship on its default switches, one round of 64 (after its
    warm-up round) for each of :data:`STRATEGIES`, the reranked one with
    the full-width CLIP ``scorer`` on the completer thread; checks every
    counter: #3 once a step, #5 once an encoded batch plus once a reranked
    one, #4 once a step on the beam paths only. Returns {name: run}."""
    runs = {}
    for name, settings in STRATEGIES:
        scfg = copy.deepcopy(cfg)
        for k, v in settings.items():
            setattr(scfg.inference, k, v)
        rerank = scfg.inference.use_clip_reranking
        runs.update(serve(torch, dev, scfg, tree, smi,
                          [(name, CONFIGS[0][1], 1, 0)],
                          scorer=scorer if rerank else None))
        run = runs[name]
        beam = scfg.inference.decoding_strategy == "beam"
        expect(run, {"beam_decode_stack": run["steps"],
                     "encoder_stack": run["batches"] * (2 if rerank else 1),
                     **({"lse_and_block_max": run["steps"]} if beam else {})})
    return runs


# ---------------------------------------------------------------------------
# train (phase 7)
# ---------------------------------------------------------------------------

TRAIN_IMAGES = 64          # fixture images per split, 5 captions each
TRAIN_BF16_STEPS = 20
TRAIN_RELOAD_THREADS = 8
# the CPU parity tests' tolerances (tests/test_torch_trainer.py): every
# parameter within atol 1e-5 + rtol 1e-4, but where an entry's gradient on
# either device lies in (0, 1e-7) in a step. There AdamW's step
# g / (|g| + 1e-8) follows the rounding of g (an attention key bias's
# gradient is zero but for it; a patch-embedding weight's can cancel to
# 1e-9 in one step), and each device's move of the entry is held to the
# bias-corrected Adam steps' bound (adam_step_bound), the two devices to
# twice it of each other. The Adam moments after the first step are a
# tenth of the gradient and a thousandth of its square: held at the CPU
# tests' atol 1e-7 + rtol 1e-3, they check every entry's gradient. After
# the second step they also carry the first step's differences in those
# rounding-driven entries (up to two learning rates apart on about 2 M
# parameters, which moves every later gradient), and there the tied
# embedding needs atol 2e-7: wte[30, 86] came 3.0e-7 apart at 1.565e-4
# (chip_smoke.py's check at 1e-7 on the card, NVIDIA H100 80GB HBM3).
TRAIN_PARAM_ATOL, TRAIN_PARAM_RTOL = 1e-5, 1e-4
TRAIN_MOMENT_ATOL = (1e-7, 2e-7)   # after the first step, after the second
TRAIN_MOMENT_RTOL = 1e-3
SMALL_GRADIENT = 1e-7
ADAM_B1, ADAM_B2 = 0.9, 0.999


def adam_step_bound(count):
    """The largest |m / sqrt(v)| of bias-corrected Adam moments after
    ``count`` gradients: by Cauchy-Schwarz, sqrt(sum_k a_k^2 / c_k) *
    sqrt(1 - b2^count) / (1 - b1^count) with a_k = (1 - b1) b1^k and
    c_k = (1 - b2) b2^k; 1 at count 1, 1.0014 at 2."""
    b1, b2 = ADAM_B1, ADAM_B2
    s = sum(((1 - b1) * b1 ** k) ** 2 / ((1 - b2) * b2 ** k)
            for k in range(count))
    return math.sqrt(s) * math.sqrt(1 - b2 ** count) / (1 - b1 ** count)


def _train_fixture(torch, cfg, tmp, seed):
    """A synthetic COCO fixture of 224 x 224 PNG images and its word
    vocabulary, padded with filler words to the flagship's 50257 ids.
    Returns (tokenizer, train set, val set)."""
    from image_captioning_ml_project_tpu_torch.data.coco import (
        build_coco_datasets)
    from image_captioning_ml_project_tpu_torch.data.synthetic import (
        make_synthetic_coco)
    from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab

    root = make_synthetic_coco(os.path.join(tmp, "coco"),
                               num_images=TRAIN_IMAGES, captions_per_image=5,
                               image_size=cfg.image_size, seed=seed)
    with open(os.path.join(root, "annotations",
                           "captions_train2014.json")) as f:
        captions = [a["caption"] for a in json.load(f)["annotations"]]
    words = WordVocab.build(captions, threshold=1).word2idx
    words.update({f"w{i}": i for i in range(len(words),
                                            cfg.model.vocab_size)})
    tokenizer = WordVocab(words)
    cfg.data_root = root
    cfg.model.pad_token_id = tokenizer.pad_token_id
    cfg.model.bos_token_id = tokenizer.bos_token_id
    cfg.model.eos_token_id = tokenizer.eos_token_id
    train_ds, val_ds = build_coco_datasets(cfg, tokenizer)
    return tokenizer, train_ds, val_ds


def _fixed_batch(dataset, n):
    """The first batch of ``n`` examples of ``dataset``, as its own
    iteration gives it: shuffled from seed 0 with the training crop and
    flip for a training set, in order with the evaluation transform for
    a validation set."""
    from image_captioning_ml_project_tpu_torch.data.coco import (
        iterate_batches)

    return next(iterate_batches(dataset, n, shuffle=dataset.is_training,
                                seed=0))


def _train_config(base, tmp, use_amp, batch, lr, warmup, dropout):
    cfg = copy.deepcopy(base)
    cfg.model.dtype = "bfloat16" if use_amp else "float32"
    cfg.model.decoder.dropout = dropout
    tc = cfg.training
    tc.use_amp, tc.batch_size, tc.learning_rate = use_amp, batch, lr
    # a horizon of 10 epochs: the cosine schedule stays near lr for the
    # steps taken
    tc.warmup_steps, tc.use_rl, tc.num_epochs = warmup, False, 10
    cfg.output_dir = os.path.join(tmp, "out")
    cfg.checkpoint_dir = os.path.join(tmp, "checkpoints")
    cfg.num_workers = 0
    cfg.log_every = 10 ** 9
    return cfg


def _flat_state(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_state(v, f"{prefix}{k}/"))
        elif hasattr(v, "dtype"):
            out[prefix + k] = v
    return out


def record_steps(torch, trainer, steps, prefix=""):
    """Each step ``trainer`` takes from now on appends, on the CPU, its
    gradients and the Adam moments after it to ``steps`` ({"grads", "mu",
    "nu"}: {optimizer name: tensor}), names prefixed with ``prefix``; a
    trainer that holds shards gathers them to full tensors first (every
    rank of the model axis takes part)."""
    opt = trainer.optimizer
    step = opt.step
    gather = getattr(trainer, "_gather", lambda x: x)

    def full(tensors):
        return {prefix + n: v.detach().float().cpu()
                for n, v in gather(dict(tensors)).items()}

    def recording(grads):
        record = {"grads": full(grads)}
        out = step(grads)
        record["mu"], record["nu"] = full(opt.mu), full(opt.nu)
        steps.append(record)
        return out

    opt.step = recording


def param_start(tree):
    """A state tree's parameters by optimizer name, copied to the CPU: the
    start of the steps :func:`hold_train_state` holds."""
    return {f"{group}.{k}": v.detach().float().cpu().clone()
            for group, params in tree["params"].items()
            for k, v in params.items()}


def _relative_l2(a, b):
    """||a - b|| / ||b|| (0 where both are 0)."""
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _adam_replay(torch, p0, steps, key, lrs, count0, weight_decay):
    """The parameter ``key`` after AdamW's steps from ``p0`` with the
    moments a run recorded (``steps``: its :func:`record_steps` records)
    at the learning rates ``lrs``, in the optimizer's f32 arithmetic
    (``train/optim.AdamW``: bias correction at counts ``count0 + 1``...,
    eps 1e-8 outside the root, decoupled decay on tensors of more than
    one dimension)."""
    p = p0.clone()
    for i, (record, lr) in enumerate(zip(steps, lrs)):
        count = count0 + 1 + i
        bc1 = float(1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** count)
        u = (record["mu"][key] / bc1) / ((record["nu"][key] / bc2).sqrt()
                                         + 1e-8)
        if weight_decay and p.ndim > 1:
            u = u + weight_decay * p
        p = p + float(-torch.tensor(lr, dtype=torch.float32)) * u
    return p


def hold_train_state(torch, got, want, before, steps, lrs, weight_decay,
                     floor=None):
    """``got``'s training state against ``want``'s (state trees, as
    ``_state_tree()`` gives them) after the same steps from the parameters
    ``before`` (:func:`param_start`), ``steps`` the two runs' lists of
    :func:`record_steps` records, ``lrs`` the steps' learning rates, by
    phase 7's rules:

    * every Adam moment after each step within that step's
      :data:`TRAIN_MOMENT_ATOL` + :data:`TRAIN_MOMENT_RTOL`;
    * every BatchNorm running statistic and every parameter within
      :data:`TRAIN_PARAM_ATOL` + :data:`TRAIN_PARAM_RTOL`, but a parameter
      entry whose gradient on either run lies in (0,
      :data:`SMALL_GRADIENT`) in a step: each run's move of it within the
      bias-corrected Adam steps at ``lrs`` plus their decay, the two
      within twice the Adam steps.

    ``floor`` is for a model whose gradients rounding alone moves by
    percents (a deep ResNet with BatchNorm over a few rows): the same run
    as ``want``'s with the stem nudged by one ulp (:func:`_floor_run`'s
    records and state). An Adam step then follows its gradient's rounding
    wherever the steps' gradients of an entry nearly cancel, not only
    where they are small, so the runs are held tensor by tensor against
    that floor: each step's gradient and any moment tensor beyond the
    entry rule, tensor by tensor, and the parameters' moves from
    ``before`` over the whole model (a flipped step is a discrete event,
    too rare in a small tensor to compare there) within four times the
    nudged run's relative L2 distance from ``want``'s or 1e-3, whichever
    is larger; a running statistic within four times the nudged run's
    largest |diff| where that is larger than the entry rule.
    Every parameter entry of each run must still lie within
    :data:`TRAIN_PARAM_ATOL` + :data:`TRAIN_PARAM_RTOL` of the AdamW
    steps its own recorded moments give (:func:`_adam_replay`), so an
    update the optimizer got wrong fails entry by entry. Fails naming the
    worst entries. Returns a line that says how close they came."""
    count0 = int(want["opt_state"]["count"]) - len(lrs)
    adam = sum(lr * adam_step_bound(count0 + 1 + i)
               for i, lr in enumerate(lrs))
    worst = {"param": (0.0, ""), "loose": (0.0, ""), "stats": (0.0, ""),
             "replay": (0.0, "")}
    worst.update({f"moment {i + 1}": (0.0, "") for i in range(len(lrs))})
    for k in ("gradient", "gradient floor", "moment L2"):
        worst[k] = (0.0, "")
    n, n_small, n_apart, n_apart_floor, failures = 0, 0, 0, 0, []
    # the squared distances of the parameters' moves, summed over the
    # model: got's and the nudged run's from want's, and want's moves
    moves = {"got": 0.0, "floor": 0.0, "want": 0.0}

    def fail(key, excess, got, want):
        over = int((excess > 0).sum())
        top = excess.flatten().topk(min(3, over)).indices
        rows = [f"[{int(i)}] {float(got.flatten()[i]):.6e} against "
                f"{float(want.flatten()[i]):.6e}" for i in top]
        failures.append(f"{key}: {over} entries beyond the tolerance, "
                        + "; ".join(rows))

    def note(kind, value, key):
        if value > worst[kind][0]:
            worst[kind] = (value, key)

    def relative_rule(kind, key, got, want, base):
        rel = _relative_l2(got, want)
        note(kind, rel, key)
        if rel > max(4 * base, 1e-3):
            failures.append(f"{key}: relative L2 {rel:.3e}, the nudged "
                            f"run's {base:.3e}")

    def entry_tol(ref):
        return TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL * ref.abs()

    for i, (got_step, want_step) in enumerate(zip(*steps)):
        if floor is not None:
            for name, w in want_step["grads"].items():
                base = _relative_l2(floor["steps"][i]["grads"][name], w)
                note("gradient floor", base, name)
                relative_rule("gradient", f"gradient of {name} at step "
                              f"{i + 1}", got_step["grads"][name], w, base)
        for moment in ("mu", "nu"):
            for name, w in want_step[moment].items():
                g = got_step[moment][name]
                diff = (g - w).abs()
                note(f"moment {i + 1}", float(diff.max()),
                     f"{moment} {name}")
                excess = diff - (TRAIN_MOMENT_ATOL[i]
                                 + TRAIN_MOMENT_RTOL * w.abs())
                if float(excess.max()) <= 0:
                    continue
                key = f"Adam {moment} of {name} after step {i + 1}"
                if floor is None:
                    fail(key, excess, g, w)
                else:
                    relative_rule("moment L2", key, g, w, _relative_l2(
                        floor["steps"][i][moment][name], w))
    for name, w in want["batch_stats"].items():
        w = w.float().cpu()
        g = got["batch_stats"][name].float().cpu()
        d = (g - w).abs()
        note("stats", float(d.max()), name)
        allowed = entry_tol(w)
        if floor is not None:
            allowed = torch.clamp(allowed, min=4 * float(
                (floor["state"]["batch_stats"][name].float() - w)
                .abs().max()))
        excess = d - allowed
        if float(excess.max()) > 0:
            fail(f"running statistic {name}", excess, g, w)
    for group in ("model", "loss"):
        for name, w in want["params"][group].items():
            key = f"{group}.{name}"
            g = got["params"][group][name].float().cpu()
            w = w.float().cpu()
            p0 = before[key]
            diff = (g - w).abs()
            n += diff.numel()
            apart = diff > entry_tol(w)
            n_apart += int(apart.sum())
            if floor is not None:
                for side, run in ((g, steps[0]), (w, steps[1])):
                    replay = _adam_replay(torch, p0, run, key, lrs, count0,
                                          weight_decay)
                    d = (side - replay).abs()
                    note("replay", float(d.max()), key)
                    excess = d - entry_tol(replay)
                    if float(excess.max()) > 0:
                        fail(f"parameter {key} against its run's AdamW "
                             f"steps", excess, side, replay)
                f = floor["state"]["params"][group][name].float()
                moves["got"] += float((g - w).square().sum())
                moves["floor"] += float((f - w).square().sum())
                moves["want"] += float((w - p0).square().sum())
                n_apart_floor += int(((f - w).abs() > entry_tol(w)).sum())
                note("param", float(diff.max()), key)
                continue
            loose = torch.zeros(w.shape, dtype=torch.bool)
            for got_step, want_step in zip(*steps):
                top = torch.maximum(got_step["grads"][key].abs(),
                                    want_step["grads"][key].abs())
                loose |= (top > 0) & (top < SMALL_GRADIENT)
            n_small += int(loose.sum())
            note("param", float(diff[~loose].max()) if (~loose).any()
                 else 0.0, key)
            note("loose", float(diff[loose].max()) if loose.any() else 0.0,
                 key)
            # the decay of |p| <= |p0| + adam over the steps, and f32
            # rounding of the bound's own terms
            reach = (adam + sum(lrs) * weight_decay * (p0.abs() + adam)) \
                * (1 + 1e-5) + 1e-9
            for side in (g, w):
                excess = torch.where(loose, (side - p0).abs() - reach, 0.0)
                if float(excess.max()) > 0:
                    fail(f"the move of parameter {key}", excess, side, p0)
            excess = torch.where(loose, diff - 2 * adam,
                                 diff - entry_tol(w))
            if float(excess.max()) > 0:
                fail(f"parameter {key}", excess, g, w)
    if floor is not None:
        # an entry's step parts the runs by about 2 lr when its sign
        # flips, a discrete event of rounding: the moves are compared over
        # the whole model, where such events are many
        want_l2 = max(math.sqrt(moves["want"]), 1e-30)
        rel = math.sqrt(moves["got"]) / want_l2
        base = math.sqrt(moves["floor"]) / want_l2
        if rel > max(4 * base, 1e-3):
            failures.append(f"the parameters' moves over the model: "
                            f"relative L2 {rel:.3e}, the nudged run's "
                            f"{base:.3e}")
    check(not failures, f"{len(failures)} beyond the tolerance: "
                        + " | ".join(failures[:10]))
    moments = "; ".join(
        f"after step {i + 1} {worst[f'moment {i + 1}'][0]:.3e} "
        f"({worst[f'moment {i + 1}'][1]})" for i in range(len(lrs)))
    line = f"Adam moments, largest |diff|: {moments}; {n} parameter entries"
    if floor is None:
        line += (f": largest |diff| {worst['param'][0]:.3e} "
                 f"({worst['param'][1]}) where every step's |gradient| is 0 "
                 f"or at least {SMALL_GRADIENT:g}; {n_small} entries below "
                 f"it within "
                 f"{2 * adam:.3e} of each other (each moved within "
                 f"{adam:.3e} + decay), largest {worst['loose'][0]:.3e} "
                 f"({worst['loose'][1]})")
    else:
        line += (f", each within {worst['replay'][0]:.3e} of its run's "
                 f"AdamW steps ({worst['replay'][1]}); the moves over the "
                 f"model {rel:.3e} relative L2 apart (the nudged run's "
                 f"{base:.3e}); {n_apart} entries beyond atol "
                 f"{TRAIN_PARAM_ATOL:g} + rtol {TRAIN_PARAM_RTOL:g} between "
                 f"the runs (the nudged run's {n_apart_floor}), largest "
                 f"|diff| {worst['param'][0]:.3e} ({worst['param'][1]})"
                 + "".join(f"; largest {k} relative L2 {worst[k][0]:.3e} "
                           f"({worst[k][1]})" for k in (
                               "gradient", "gradient floor", "moment L2")))
    return (line + f"; running statistics largest |diff| "
            f"{worst['stats'][0]:.3e} ({worst['stats'][1]})")


def _zero_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0
    return kernels


def _launches(kernels):
    return {k: fn.launches for k, fn in kernels.items()}


def train_card_vs_cpu(torch, dev, cfg, tree, train_ds, tmp, kernels):
    """Two f32 CE steps of batch 2 (dropout 0, warmup 0) on the card and
    on the CPU from the same seeded weights and batch: losses within 1e-4
    relative, grad_norm within 1e-3, the Adam moments and the parameters
    as :func:`hold_train_state` holds them; no kernel launched."""
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    c = _train_config(cfg, os.path.join(tmp, "f32"), False, 2, 1e-4, 0, 0.0)
    batch = _fixed_batch(train_ds, 2)
    trainers, metrics, steps = {}, {}, {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        t = CaptioningTrainer(c, train_ds, train_ds, None, device=device,
                              params=tree)
        if name == "cpu":
            before = param_start(t._state_tree())
        steps[name] = []
        record_steps(torch, t, steps[name])
        _zero_launches(kernels)
        metrics[name] = [{k: float(v) for k, v in t.train_step(
            batch["image"], batch["caption_tokens"],
            batch["attention_mask"]).items()} for _ in range(2)]
        launched = _launches(kernels)
        check(not any(launched.values()),
              f"f32 train steps on the {name} launched kernels: {launched}")
        if name == "card":
            torch.cuda.synchronize()
            print(f"train f32 card: memory_allocated "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after "
                  f"2 steps of batch 2", flush=True)
        trainers[name] = t
    worst = {}
    for step, (a, b) in enumerate(zip(metrics["card"], metrics["cpu"])):
        print(f"train f32 step {step + 1}: card {a} cpu {b}", flush=True)
        for key in ("total_loss", "ce_loss"):
            rel = abs(a[key] - b[key]) / abs(b[key])
            worst[key] = max(worst.get(key, 0.0), rel)
            check(rel <= 1e-4, f"train f32 step {step + 1}: {key} card "
                               f"{a[key]} cpu {b[key]} (rel {rel:.2e})")
        rel = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
        worst["grad_norm"] = max(worst.get("grad_norm", 0.0), rel)
        check(rel <= 1e-3, f"train f32 step {step + 1}: grad_norm card "
                           f"{a['grad_norm']} cpu {b['grad_norm']}")
        check(a["learning_rate"] == b["learning_rate"] > 0,
              f"train f32 step {step + 1}: learning rates {a} {b}")
    held = hold_train_state(torch, trainers["card"]._state_tree(),
                            trainers["cpu"]._state_tree(), before,
                            (steps["card"], steps["cpu"]),
                            [m["learning_rate"] for m in metrics["cpu"]],
                            c.training.weight_decay)
    print(f"train f32 card vs CPU: worst relative loss {worst}; "
          f"{held}", flush=True)
    for t in trainers.values():
        # the recording step closes over the optimizer: unwrap it so the
        # card trainer's memory is freed here, not by a later collection
        del t.optimizer.step
    del trainers
    return worst


def train_bf16(torch, dev, cfg, tree, train_ds, val_ds, tmp, smi, kernels):
    """20 bf16 CE steps at batch 64 (lr 1e-4, warmup 2, dropout 0.1) on
    one fixed batch: finite, falling loss; step time, images/s, peak
    memory. Returns (trainer, numbers)."""
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    c = _train_config(cfg, os.path.join(tmp, "bf16"), True,
                      cfg.training.batch_size, 1e-4, 2, 0.1)
    B = c.training.batch_size
    batch = _fixed_batch(train_ds, B)
    images = torch.from_numpy(batch["image"]).to(dev)
    caps = torch.from_numpy(batch["caption_tokens"]).to(dev)
    mask = torch.from_numpy(batch["attention_mask"]).to(dev)
    t = CaptioningTrainer(c, train_ds, val_ds, None, device=dev, params=tree)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches(kernels)
    losses, times = [], []
    for _ in range(TRAIN_BF16_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = t.train_step(images, caps, mask)
        loss = float(m["total_loss"])       # waits for the step
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launched = _launches(kernels)
    check(not any(launched.values()),
          f"bf16 train steps launched kernels: {launched}")
    check(all(map(math.isfinite, losses)), f"bf16 losses {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"bf16 loss did not fall: first five {first:.4f}, "
                        f"last five {last:.4f}: {losses}")
    ms = statistics.median(times[-15:]) * 1e3
    numbers = {"batch": B, "steps": TRAIN_BF16_STEPS, "launches": launched,
               "ms_per_step": ms, "images_per_s": B / ms * 1e3,
               "max_memory_allocated_gib":
                   torch.cuda.max_memory_allocated() / 2 ** 30,
               "loss_first5": first, "loss_last5": last}
    print(f"train bf16 batch {B}: losses {[round(x, 4) for x in losses]}",
          flush=True)
    print(f"train bf16 batch {B}: {ms:.2f} ms/step (median of the last 15),"
          f" {B / ms * 1e3:.1f} images/s, max_memory_allocated "
          f"{numbers['max_memory_allocated_gib']:.2f} GiB [{smi}]",
          flush=True)
    return t, numbers


def train_validate_and_checkpoint(torch, dev, trainer, tree, tokenizer,
                                  val_ds, kernels):
    """_validate_epoch through the kernels; the eval_state decode against
    load_model on the same weights; a checkpoint round trip bit-identical;
    the rolling step checkpoint's two slots."""
    from image_captioning_ml_project_tpu_torch.models.captioning_model import (
        load_model)
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)
    from image_captioning_ml_project_tpu_torch.utils.checkpoint import (
        latest_step_checkpoint)

    trainer.tokenizer = tokenizer
    _zero_launches(kernels)
    t0 = time.perf_counter()
    val_loss, metrics = trainer._validate_epoch(0)
    seconds = time.perf_counter() - t0
    launched = _launches(kernels)
    print(f"train validation of {len(val_ds)} images: val loss "
          f"{val_loss:.4f}, CIDEr {metrics['CIDEr']:.4f}, {seconds:.1f} s; "
          f"launches {launched}", flush=True)
    check(val_loss > 0 and metrics["CIDEr"] > 0,
          f"validation: val loss {val_loss}, CIDEr {metrics['CIDEr']}")
    for name in ("beam_decode_stack", "lse_and_block_max", "encoder_stack"):
        check(launched[name] > 0, f"validation launched no {name}")

    # the eval_state decode is load_model's on the current weights
    images = torch.from_numpy(_fixed_batch(val_ds, 8)
                              ["image"]).to(dev)
    cfg = trainer.config
    mcfg = copy.deepcopy(cfg)
    mcfg.model.dtype = "bfloat16"
    tree_now = trainer._state_tree()
    state = dict(tree_now["params"]["model"])
    state.update(tree_now["batch_stats"])
    tokens = {}
    for name, model in (("eval_state", trainer.eval_state()),
                        ("load_model", load_model(mcfg, dev,
                                                  state_dict=state))):
        tokens[name] = trainer.val_decode_step(model, images).cpu()
        del model
    check(torch.equal(tokens["eval_state"], tokens["load_model"]),
          "eval_state decodes other tokens than load_model on the trainer's "
          "weights")
    print("train: eval_state's tokens equal load_model's on the current "
          "weights (8 images, beam 5)", flush=True)

    # checkpoint round trip
    t0 = time.perf_counter()
    trainer.save_checkpoint(0, is_best=True)
    trainer.ckpt.wait_until_finished()
    save_s = time.perf_counter() - t0
    fresh = CaptioningTrainer(cfg, trainer.train_dataset, val_ds, tokenizer,
                              device=dev, params=tree)
    t0 = time.perf_counter()
    fresh.load_checkpoint("best_model")
    load_s = time.perf_counter() - t0
    a, b = _flat_state(tree_now), _flat_state(fresh._state_tree())
    check(set(a) == set(b), f"restored state keys differ: "
                            f"{sorted(set(a) ^ set(b))}")
    for name, t in a.items():
        check(torch.equal(t, b[name].to(t.device)),
              f"restored {name} is not bit-identical")
    check(fresh.step == trainer.step and fresh.optimizer.count
          == trainer.optimizer.count, "restored step or count differs")
    print(f"train: checkpoint best_model saved in {save_s:.1f} s (epoch 1 "
          f"and best_model) and restored in {load_s:.1f} s: {len(a)} "
          f"tensors, the step and the count bit-identical", flush=True)
    del fresh
    slots = []
    for i in range(2):
        trainer.save_step_checkpoint(0, i + 1, "ce")
        trainer.ckpt.wait_until_finished()
        slots.append(latest_step_checkpoint(trainer.config.checkpoint_dir))
    check(slots == ["checkpoint_step_0", "checkpoint_step_1"],
          f"step checkpoints went to {slots}")
    import shutil

    for name in slots + ["checkpoint_epoch_1"]:  # 2.5 GB each
        shutil.rmtree(os.path.join(trainer.config.checkpoint_dir, name))
    print(f"train: step checkpoints {slots}, latest_step_checkpoint follows "
          f"them", flush=True)
    return {"val_loss": val_loss, "cider": metrics["CIDEr"],
            "validation_s": seconds, "launches": launched}


def train_reload(torch, dev, trainer, tree, tokenizer, val_ds, smi,
                 kernels):
    """A CaptionService on the seeded weights serves requests from 8
    threads while reload_checkpoint("best_model") runs: every request is
    answered; the captions after the swap equal a fresh service's on the
    checkpoint, image for image."""
    from image_captioning_ml_project_tpu_torch.inference.server import (
        CaptionService)

    cfg = copy.deepcopy(trainer.config)
    cfg.model.dtype = "bfloat16"
    images = _fixed_batch(val_ds, 16)["image"]
    service = CaptionService(cfg, tokenizer, dev, params=tree,
                             batch_size=8, bucket_sizes=[1, 8],
                             max_wait_ms=20.0, request_timeout_s=300.0)
    service.start(warmup=True)
    before = [service.submit(img) for img in images]
    _zero_launches(kernels)
    stop = threading.Event()
    answered, failed = [], []

    def client(k):
        i = k
        while not stop.is_set():
            try:
                service.submit(images[i % len(images)])
                answered.append(i)
            except Exception as e:  # every request must be answered
                failed.append(f"{type(e).__name__}: {e}")
            i += TRAIN_RELOAD_THREADS

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(TRAIN_RELOAD_THREADS)]
    for th in threads:
        th.start()
    time.sleep(1.0)
    during = len(answered)
    result = service.reload_checkpoint("best_model")
    time.sleep(1.0)
    stop.set()
    for th in threads:
        th.join(timeout=120)
    launched = _launches(kernels)
    after = [service.submit(img) for img in images]
    service.stop()
    check(not failed, f"requests failed across the reload: {failed[:3]}")
    check(not any(th.is_alive() for th in threads), "a client hung")
    for name in ("beam_decode_stack", "lse_and_block_max", "encoder_stack"):
        check(launched[name] > 0, f"the service launched no {name}")
    fresh = CaptionService(cfg, tokenizer, dev,
                           checkpoint_path="best_model", batch_size=8,
                           bucket_sizes=[1, 8], request_timeout_s=300.0)
    fresh.start(warmup=False)
    want = [fresh.submit(img) for img in images]
    fresh.stop()
    check(after == want, "captions after the reload differ from a fresh "
                         "service's on the checkpoint")
    changed = sum(a != b for a, b in zip(before, after))
    why_not = (" (the 20 bf16 steps at lr 1e-4 did not change a beam-5 "
               "caption)")
    print(f"train reload: {len(answered)} requests from "
          f"{TRAIN_RELOAD_THREADS} threads answered across the swap "
          f"({during} before it), none failed; reload {result}; captions "
          f"after it equal a fresh service's on best_model for all "
          f"{len(images)} images and differ from those before it on "
          f"{changed}{'' if changed else why_not}; "
          f"launches {launched} [{smi}]", flush=True)
    return {"seconds": result["seconds"], "requests": len(answered),
            "changed": changed, "launches": launched}


TRAIN_SCST_STEPS = 6           # one warm-up step, then five timed
SCST_PARTS = ("rollouts", "rewards", "update")


def _scst_rollouts(torch, L, vocab, ref_tokens, g):
    """Injected (sampled, mask, greedy) for a batch of 2, as the decoders
    give them (BOS, words, EOS, pads; the sampler's mask True from position
    1 to the EOS): the sampled rows copy image 0's first reference and draw
    as many random words for image 1, the greedy rows the other way
    round."""
    out = []
    for copies in ((True, False), (False, True)):
        tokens = torch.full((2, L), vocab["pad"], dtype=torch.long)
        mask = torch.zeros((2, L), dtype=torch.bool)
        for i, copy_ref in enumerate(copies):
            words = torch.from_numpy(ref_tokens[i, 0]).long()
            words = words[(words >= 0) & (words != vocab["bos"])
                          & (words != vocab["eos"])]
            if not copy_ref:
                words = torch.randint(4, vocab["size"], (len(words),),
                                      generator=g)
            row = torch.cat([torch.tensor([vocab["bos"]]), words,
                             torch.tensor([vocab["eos"]])])[:L]
            tokens[i, :len(row)] = row
            mask[i, 1:len(row)] = True
        out.append((tokens, mask))
    return out[0][0], out[0][1], out[1][0]


def scst_card_vs_cpu(torch, dev, cfg, tree, tokenizer, train_ds, tmp,
                     kernels):
    """SCST in f32 at batch 2, on the card and on the CPU from the same
    seeded weights: the n-gram hashes on the card bit-equal to
    ``ngram_hashes_np`` (and to the CPU's), the rewards of the same
    injected rollouts within 1e-5 relative, and one ``rl_update_step`` on
    the same tokens, mask and advantages: the loss within 1e-5 relative,
    the Adam moments and the parameters as :func:`hold_train_state` holds
    them; no kernel launched in the rewards or the update."""
    import numpy as np
    from image_captioning_ml_project_tpu_torch.ops.ngram import (
        ngram_hashes, ngram_hashes_np)
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    g = torch.Generator().manual_seed(11)
    V = cfg.model.vocab_size
    toks = torch.randint(-1, V, (2, 5, 50), generator=g)
    toks[0, 0, :10] = -1
    valid = toks >= 0
    for n in range(1, 5):
        h, v = ngram_hashes(toks.to(dev), n, valid.to(dev))
        h_cpu, v_cpu = ngram_hashes(toks, n, valid)
        check(torch.equal(h.cpu(), h_cpu) and torch.equal(v.cpu(), v_cpu),
              f"n-gram hashes (n = {n}) on the card differ from the CPU's")
        for row, hashes in zip(toks.reshape(10, 50).numpy(),
                               h.cpu().reshape(10, 50).numpy()):
            host = ngram_hashes_np(row.astype(np.uint32), n)
            check(np.array_equal(hashes[:len(host)].astype(np.uint32), host),
                  f"n-gram hashes (n = {n}) on the card differ from "
                  f"ngram_hashes_np")
    print("scst: n-gram hashes on the card bit-equal to ngram_hashes_np and "
          "to the CPU's (n = 1..4, [2, 5, 50] ids in [-1, 50256])",
          flush=True)

    c = _train_config(cfg, os.path.join(tmp, "scst_f32"), False, 2, 1e-4, 0,
                      0.0)
    batch = _fixed_batch(train_ds, 2)
    mc = c.model
    vocab = {"bos": mc.bos_token_id, "eos": mc.eos_token_id,
             "pad": mc.pad_token_id, "size": V}
    trainers, rewards, metrics, steps = {}, {}, {}, {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        t = CaptioningTrainer(c, train_ds, train_ds, tokenizer, device=device,
                              params=tree)
        ref_tokens, ref_valid = t.scst_references(batch["image_id"])
        if name == "card":
            sampled, mask, greedy = _scst_rollouts(
                torch, c.inference.max_length, vocab, ref_tokens, g)
            before = param_start(t._state_tree())
        steps[name] = []
        record_steps(torch, t, steps[name])
        _zero_launches(kernels)
        rewards[name] = [r.cpu() for r in t.scst_rewards(
            sampled, greedy, ref_tokens, ref_valid)]
        # the same advantages on both devices: the card's
        metrics[name] = {k: float(v) for k, v in t.rl_update_step(
            batch["image"], sampled, mask, rewards["card"][2]).items()}
        launched = _launches(kernels)
        check(not any(launched.values()),
              f"f32 SCST rewards and update on the {name} launched "
              f"kernels: {launched}")
        trainers[name] = t
    for what, a, b in zip(("reward", "greedy reward", "advantage"),
                          rewards["card"], rewards["cpu"]):
        rel = float(((a - b).abs() / b.abs().clamp_min(1e-12)).max())
        check(rel <= 1e-5, f"scst f32 {what}: card {a.tolist()} cpu "
                           f"{b.tolist()} (rel {rel:.2e})")
    check(float(rewards["cpu"][0][0]) > 0 and float(rewards["cpu"][1][1]) > 0,
          f"the copied references scored no CIDEr: {rewards['cpu']}")
    a, b = metrics["card"], metrics["cpu"]
    rel = abs(a["rl_loss"] - b["rl_loss"]) / abs(b["rl_loss"])
    check(rel <= 1e-5, f"scst f32 rl_loss card {a['rl_loss']} cpu "
                       f"{b['rl_loss']} (rel {rel:.2e})")
    held = hold_train_state(torch, trainers["card"]._state_tree(),
                            trainers["cpu"]._state_tree(), before,
                            (steps["card"], steps["cpu"]),
                            [b["learning_rate"]], c.training.weight_decay)
    print(f"scst f32 card vs CPU: rewards {rewards['cpu'][0].tolist()} / "
          f"greedy {rewards['cpu'][1].tolist()}, card within 1e-5; rl_loss "
          f"card {a['rl_loss']:.8f} cpu {b['rl_loss']:.8f} (rel {rel:.2e}); "
          f"{held}", flush=True)
    for t in trainers.values():
        del t.optimizer.step
    del trainers
    return {"rl_loss_rel": rel}


def scst_bf16(torch, dev, cfg, tree, tokenizer, train_ds, tmp, smi,
              kernels):
    """bf16 SCST at batch 64 on the device CIDEr path through
    ``scst_fused_step``: one warm-up step, then five timed, each split into
    rollouts / rewards / update (the device synchronised at each boundary)
    with the launches of each part: #5 once and #3 at least twice and at
    most twice a decode step in the rollouts, nothing else there, and no
    kernel in the rewards or the update; finite rewards, a non-zero
    advantage; then the refreshed rollout model's greedy decode
    token-identical to a fresh ``eval_state()``'s, and an epoch's CE and
    SCST passes over the fixture through ``_train_epoch``. Returns the
    numbers."""
    from image_captioning_ml_project_tpu_torch.inference.decoding import (
        greedy_decode)
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    c = _train_config(cfg, os.path.join(tmp, "scst_bf16"), True,
                      cfg.training.batch_size, 1e-4, 2, 0.1)
    c.training.use_rl, c.training.rl_start_epoch = True, 0
    B, L = c.training.batch_size, c.inference.max_length
    mc = c.model
    batch = _fixed_batch(train_ds, B)
    images = torch.from_numpy(batch["image"]).to(dev)
    t = CaptioningTrainer(c, train_ds, train_ds, tokenizer, device=dev,
                          params=tree)
    ref_tokens, ref_valid = t.scst_references(batch["image_id"])
    times = {p: [] for p in SCST_PARTS}
    launches = {p: [] for p in SCST_PARTS}

    def timed(part, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            before = _launches(kernels)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[part].append(time.perf_counter() - t0)
            after = _launches(kernels)
            launches[part].append({k: after[k] - before[k] for k in after})
            return out
        return run

    t.rollout_step = timed("rollouts", t.rollout_step)
    t.scst_rewards = timed("rewards", t.scst_rewards)
    t.rl_update_step = timed("update", t.rl_update_step)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches(kernels)
    totals, metrics = [], []
    for _ in range(TRAIN_SCST_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = t.scst_fused_step(images, ref_tokens, ref_valid)
        metrics.append({k: float(v) for k, v in m.items()})
        totals.append(time.perf_counter() - t0)
    launched = _launches(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, parts in enumerate(zip(*(launches[p] for p in SCST_PARTS))):
        roll, rew, upd = parts
        check(roll["encoder_stack"] == 1,
              f"scst step {i + 1}: the rollouts launched #5 "
              f"{roll['encoder_stack']} times, not once")
        check(2 <= roll["beam_decode_stack"] <= 2 * (L - 1),
              f"scst step {i + 1}: the rollouts launched #3 "
              f"{roll['beam_decode_stack']} times")
        others = {k: v for k, v in roll.items()
                  if v and k not in ("encoder_stack", "beam_decode_stack")}
        check(not others, f"scst step {i + 1}: the rollouts launched {others}")
        check(not any(rew.values()) and not any(upd.values()),
              f"scst step {i + 1}: kernels launched in the rewards {rew} or "
              f"the update {upd}")
    for m in metrics:
        check(all(math.isfinite(m[k]) for k in ("rl_loss", "reward",
                                                "greedy_reward", "adv_abs")),
              f"scst metrics not finite: {m}")
    check(any(m["adv_abs"] > 0 for m in metrics),
          f"no SCST step had a non-zero advantage: {metrics}")
    timed_steps = slice(1, None)
    ms = {p: statistics.median(times[p][timed_steps]) * 1e3
          for p in SCST_PARTS}
    ms["step"] = statistics.median(totals[timed_steps]) * 1e3
    mean = {k: statistics.mean(m[k] for m in metrics[timed_steps])
            for k in ("rl_loss", "reward", "greedy_reward", "adv_abs")}
    per_step = [{k: v for k, v in roll.items() if v}
                for roll in launches["rollouts"]]
    numbers = {"batch": B, "steps": TRAIN_SCST_STEPS - 1,
               "launches": launched, "ms_per_step": ms["step"],
               "ms": ms, "images_per_s": B / ms["step"] * 1e3,
               "max_memory_allocated_gib": peak, "means": mean,
               "rollout_launches_per_step": per_step}
    print(f"scst bf16 batch {B}: per step {metrics}", flush=True)
    print(f"scst bf16 batch {B}: {ms['step']:.2f} ms/step (median of "
          f"{TRAIN_SCST_STEPS - 1} after a warm-up): rollouts "
          f"{ms['rollouts']:.2f}, rewards {ms['rewards']:.2f}, update "
          f"{ms['update']:.2f} ms, the rest (the rollout model's refresh "
          f"and host) {ms['step'] - sum(ms[p] for p in SCST_PARTS):.2f} ms; "
          f"{B / ms['step'] * 1e3:.1f} images/s; max_memory_allocated "
          f"{peak:.2f} GiB; means {mean}; rollout launches per step "
          f"{per_step}; no kernel in the rewards or the update [{smi}]",
          flush=True)

    # the refreshed rollout model decodes as a fresh eval_state
    tokens = []
    for model in (t.rollout_model(), t.eval_state()):
        with torch.no_grad():
            state = model.init_cache(images, L)
            tokens.append(greedy_decode(
                model.step, state, B, mc.bos_token_id, L,
                eos_token_id=mc.eos_token_id,
                pad_token_id=mc.pad_token_id).cpu())
    check(torch.equal(tokens[0], tokens[1]),
          "the refreshed rollout model's greedy decode differs from a "
          "fresh eval_state's")
    print(f"scst: after {TRAIN_SCST_STEPS} steps the refreshed rollout "
          f"model's greedy decode of {B} images equals a fresh "
          f"eval_state's, token for token", flush=True)

    # the epoch's passes over the fixture's captions: CE, then SCST
    del t.rollout_step, t.scst_rewards, t.rl_update_step   # untimed
    n = t.steps_per_epoch
    step0 = t.step
    _zero_launches(kernels)
    t0 = time.perf_counter()
    loss = t._train_epoch(0)
    seconds = time.perf_counter() - t0
    epoch_launches = _launches(kernels)
    check(t.step == step0 + 2 * n and math.isfinite(loss),
          f"_train_epoch took {t.step - step0} steps, loss {loss}")
    check(epoch_launches["encoder_stack"] == n
          and 2 * n <= epoch_launches["beam_decode_stack"] <= 2 * n * (L - 1),
          f"_train_epoch's SCST pass launched {epoch_launches}")
    print(f"scst: _train_epoch ({n} CE and {n} SCST steps of {B}, the "
          f"rollout model built at the pass's start) {seconds:.2f} s, CE "
          f"loss {loss:.4f}, launches {epoch_launches}", flush=True)
    numbers["train_epoch_s"] = seconds
    del t
    return numbers


def train_phase(torch, dev, smi, cfg, tree, seed, tmp):
    """Phase 7 (module docstring), its files under ``tmp``. Returns the
    summary line's numbers and, for phase 8, the fixture: the tokenizer,
    the two datasets, the seed and the bf16 trainer's configuration, whose
    ``checkpoint_dir`` holds ``best_model``."""
    kernels = counters()
    cfg = copy.deepcopy(cfg)
    tokenizer, train_ds, val_ds = _train_fixture(torch, cfg, tmp, seed)
    t0 = time.perf_counter()
    worst = train_card_vs_cpu(torch, dev, cfg, tree, train_ds, tmp,
                              kernels)
    print(f"train f32 card vs CPU: {time.perf_counter() - t0:.1f} s",
          flush=True)
    trainer, bf16 = train_bf16(torch, dev, cfg, tree, train_ds, val_ds,
                               tmp, smi, kernels)
    validation = train_validate_and_checkpoint(
        torch, dev, trainer, tree, tokenizer, val_ds, kernels)
    reload = train_reload(torch, dev, trainer, tree, tokenizer, val_ds,
                          smi, kernels)
    fixture = {"tokenizer": tokenizer, "train_ds": train_ds,
               "val_ds": val_ds, "seed": seed,
               "config": copy.deepcopy(trainer.config)}
    del trainer
    t0 = time.perf_counter()
    scst = scst_card_vs_cpu(torch, dev, cfg, tree, tokenizer, train_ds,
                            tmp, kernels)
    scst.update(scst_bf16(torch, dev, cfg, tree, tokenizer, train_ds,
                          tmp, smi, kernels))
    print(f"scst part of the train phase: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"f32_card_vs_cpu": worst, "bf16": bf16,
            "validation": validation, "reload": reload,
            "scst": scst}, fixture


# ---------------------------------------------------------------------------
# eval and demo (phase 8)
# ---------------------------------------------------------------------------

EVAL_F32_IMAGES = 4
EVAL_BATCH = 5            # the eval CLI's batch: inference.num_candidates
# the native decode against PIL on one eval dataset's batches (the JAX
# package's tests/test_native_loader.py: at most 3 levels apart)
NATIVE_MAX_DIFF = 3


class DecodeCounts:
    """Counts the encodes (``init_cache``) and the decode steps of every
    captioning model inside the ``with`` block."""

    def __enter__(self):
        from image_captioning_ml_project_tpu_torch.models.captioning_model \
            import ImageCaptioningModel

        self.cls = ImageCaptioningModel
        self.real = (ImageCaptioningModel.init_cache,
                     ImageCaptioningModel.step)
        self.encodes = self.steps = 0
        counts = self

        def init_cache(model, images, max_length):
            counts.encodes += 1
            return counts.real[0](model, images, max_length)

        def step(model, state, tokens):
            counts.steps += 1
            return counts.real[1](model, state, tokens)

        self.cls.init_cache, self.cls.step = init_cache, step
        return self

    def __exit__(self, *exc):
        self.cls.init_cache, self.cls.step = self.real
        return False


class TimedEvalPass:
    """Inside the ``with`` block, the seconds of each eval pass
    (``coco_eval.evaluate_model_on_coco``: after the decode model is
    built from the checkpoint) go to ``seconds``."""

    def __enter__(self):
        from image_captioning_ml_project_tpu_torch.evaluate import coco_eval

        self.module, self.real = coco_eval, coco_eval.evaluate_model_on_coco
        self.seconds = []

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self.real(*args, **kw)
            finally:
                self.seconds.append(time.perf_counter() - t0)

        coco_eval.evaluate_model_on_coco = timed
        return self

    def __exit__(self, *exc):
        self.module.evaluate_model_on_coco = self.real
        return False


def _results(path):
    with open(path) as f:
        return {r["image_id"]: r["caption"] for r in json.load(f)}


def eval_card_vs_cpu(torch, dev, base, tokenizer, tmp, seed, kernels):
    """main.evaluate (4 validation images of their own fixture) and
    main.demo (one of them) in float32 on the card and on the CPU from
    phase 7's best_model: captions identical per image, metrics equal;
    the card's run with the launch counters set to 0 just before and read
    just after: #5 once a batch, #3 and #4 once a decode step, nothing
    else."""
    from image_captioning_ml_project_tpu_torch import main as port_main
    from image_captioning_ml_project_tpu_torch.data.synthetic import (
        make_synthetic_coco)

    cfg = copy.deepcopy(base)
    cfg.model.dtype = "float32"
    cfg.data_root = make_synthetic_coco(
        os.path.join(tmp, "coco4"), num_images=EVAL_F32_IMAGES,
        captions_per_image=5, image_size=cfg.image_size, seed=seed + 1)
    image_dir = os.path.join(cfg.data_root, cfg.val_image_dir)
    image = os.path.join(image_dir, sorted(os.listdir(image_dir))[0])
    out = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        c = copy.deepcopy(cfg)
        c.output_dir = os.path.join(tmp, f"eval_f32_{name}")
        with DecodeCounts() as counts:
            _zero_launches(kernels)
            t0 = time.perf_counter()
            metrics = port_main.evaluate(c, "best_model",
                                         tokenizer=tokenizer, device=device)
            seconds = time.perf_counter() - t0
            caption = port_main.demo(c, "best_model", image,
                                     tokenizer=tokenizer, device=device)
            launched = _launches(kernels)
        if name == "card":
            # one eval batch and the demo's
            check(counts.encodes == 2, f"f32 eval and demo encoded "
                                       f"{counts.encodes} batches")
            expect({"launches": launched},
                   {"beam_decode_stack": counts.steps,
                    "lse_and_block_max": counts.steps,
                    "encoder_stack": counts.encodes})
            print(f"eval f32 card: launches {launched} over "
                  f"{counts.steps} decode steps", flush=True)
        else:
            check(not any(launched.values()),
                  f"the CPU run launched kernels: {launched}")
        out[name] = (metrics, _results(os.path.join(c.output_dir,
                                                    "results.json")),
                     caption)
        print(f"eval f32 {name}: {EVAL_F32_IMAGES} images in {seconds:.1f} "
              f"s, CIDEr {metrics['CIDEr']:.4f}; demo: {caption!r}",
              flush=True)
    (cm, cr, cc), (pm, pr, pc) = out["card"], out["cpu"]
    check(len(cr) == EVAL_F32_IMAGES, f"f32 eval captioned {len(cr)} images")
    check(cr == pr, f"f32 eval captions differ: card {cr}, CPU {pr}")
    check(cm == pm, f"f32 eval metrics differ: card {cm}, CPU {pm}")
    check(cc == pc, f"f32 demo captions differ: card {cc!r}, CPU {pc!r}")
    print(f"eval f32 card vs CPU: the {EVAL_F32_IMAGES} captions, the "
          f"metrics and the demo's caption identical", flush=True)
    return {"images": EVAL_F32_IMAGES, "cider": cm["CIDEr"]}


def eval_run(torch, name, run, val_ds, out_dir, kernels, smi, rerank=False):
    """``run()``, an eval of ``val_ds`` that writes
    ``out_dir/results.json``, with the launch counters set to 0 just
    before and read just after: every image captioned once; #5 once a
    batch (twice with the CLIP reranker), #3 and #4 once a decode step,
    nothing else; the ancestry error word clear. Also the device memory
    the call allocated at its peak, above what was allocated before it.
    Returns (its numbers, {image id: caption})."""
    results = os.path.join(out_dir, "results.json")
    if os.path.exists(results):
        os.remove(results)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with DecodeCounts() as counts, TimedEvalPass() as passes:
        _zero_launches(kernels)
        t0 = time.perf_counter()
        metrics = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = _launches(kernels)
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    with open(results) as f:
        entries = json.load(f)
    want = sorted(ex["image_id"] for ex in val_ds.examples)
    n = len(want)
    check(len(entries) == n and sorted(r["image_id"] for r in entries)
          == want, f"{name}: results.json does not caption each of the {n} "
                   f"validation images once")
    batches = counts.encodes
    check(batches == -(-n // EVAL_BATCH), f"{name}: {batches} batches")
    expect({"launches": launched},
           {"beam_decode_stack": counts.steps,
            "lse_and_block_max": counts.steps,
            "encoder_stack": batches * (2 if rerank else 1)})
    check_ancestry(torch.device("cuda"), name)
    (pass_s,) = passes.seconds
    numbers = {"images": n, "batches": batches, "steps": counts.steps,
               "seconds": seconds, "pass_seconds": pass_s,
               "images_per_s": n / pass_s, "cider": metrics["CIDEr"],
               "peak_gib": peak_gib, "launches": launched}
    print(f"{name}: {n} images in {batches} batches of {EVAL_BATCH}, "
          f"{counts.steps} decode steps; the pass {pass_s:.3f} s "
          f"({n / pass_s:.1f} images/s), the call {seconds:.1f} s, "
          f"{peak_gib:.3f} GiB at its peak; CIDEr "
          f"{metrics['CIDEr']:.4f}; launches {launched} [{smi}]",
          flush=True)
    return numbers, _results(results)


def _jpeg_copy(root, cfg, tmp):
    """The validation split of ``root`` re-encoded as JPEG (quality 95)
    under a new root, its annotations pointing at the copies."""
    import shutil

    from PIL import Image

    out = os.path.join(tmp, "coco_jpeg")
    os.makedirs(os.path.join(out, cfg.val_image_dir), exist_ok=True)
    os.makedirs(os.path.join(out, "annotations"), exist_ok=True)
    shutil.copy(os.path.join(root, cfg.train_json),
                os.path.join(out, cfg.train_json))
    with open(os.path.join(root, cfg.val_json)) as f:
        ann = json.load(f)
    for img in ann["images"]:
        src = os.path.join(root, cfg.val_image_dir, img["file_name"])
        img["file_name"] = os.path.splitext(img["file_name"])[0] + ".jpg"
        Image.open(src).convert("RGB").save(
            os.path.join(out, cfg.val_image_dir, img["file_name"]),
            "JPEG", quality=95)
    with open(os.path.join(out, cfg.val_json), "w") as f:
        json.dump(ann, f)
    return out


def eval_jpeg(torch, dev, base, tokenizer, tmp, kernels, smi):
    """A JPEG copy of the validation images through main.evaluate with
    the native loader and with PIL: the decoded pixels within
    NATIVE_MAX_DIFF levels of each other (held always), the captions
    compared, the image ids of any that differ printed."""
    import numpy as np

    from image_captioning_ml_project_tpu_torch import main as port_main
    from image_captioning_ml_project_tpu_torch.data.coco import (
        build_coco_datasets, iterate_batches)

    root = _jpeg_copy(base.data_root, base, tmp)
    runs, pixels = {}, {}
    for name, native in (("native", True), ("PIL", False)):
        c = copy.deepcopy(base)
        c.data_root, c.native_loader = root, native
        c.output_dir = os.path.join(tmp, f"eval_jpeg_{name}")
        _, val_ds = build_coco_datasets(c, tokenizer)
        pixels[name] = np.concatenate([b["image"] for b in iterate_batches(
            val_ds, 16, shuffle=False, drop_last=False)])
        runs[name] = eval_run(
            torch, f"eval bf16 of the JPEG copy, {name} decode",
            lambda c=c: port_main.evaluate(c, "best_model",
                                           tokenizer=tokenizer, device=dev),
            val_ds, c.output_dir, kernels, smi)
    diff = np.abs(pixels["native"].astype(int) - pixels["PIL"].astype(int))
    check(diff.max() <= NATIVE_MAX_DIFF,
          f"the native decode is {diff.max()} levels from PIL's")
    a, b = runs["native"][1], runs["PIL"][1]
    differ = sorted(i for i in a if a[i] != b[i])
    print(f"eval of the JPEG copy: native pixels within {diff.max()} levels "
          f"of PIL's (mean {diff.mean():.4f}); captions differ on "
          f"{len(differ)} of {len(a)} images{': ' if differ else ''}"
          f"{differ if differ else ''}", flush=True)
    return {"max_pixel_diff": int(diff.max()),
            "mean_pixel_diff": float(diff.mean()),
            "captions_differ": differ,
            "native_pass_seconds": runs["native"][0]["pass_seconds"],
            "pil_pass_seconds": runs["PIL"][0]["pass_seconds"]}


def eval_phase(torch, dev, smi, fixture, scorer, tmp):
    """Phase 8 (module docstring), on phase 7's fixture and best_model
    checkpoint (``fixture``) and phase 4's CLIP ``scorer``. Returns the
    summary line's numbers."""
    import contextlib
    import io
    import shutil

    from image_captioning_ml_project_tpu_torch import main as port_main
    from image_captioning_ml_project_tpu_torch import native
    from image_captioning_ml_project_tpu_torch.config import save_config
    from image_captioning_ml_project_tpu_torch.inference.reranking import (
        CLIPReranker)
    from image_captioning_ml_project_tpu_torch.train.curriculum import (
        create_curriculum_sampler)

    kernels = counters()
    tokenizer, base = fixture["tokenizer"], fixture["config"]
    val_ds = fixture["val_ds"]
    t0 = time.perf_counter()
    built = native.available()
    print(f"native_loader: available (built and loaded in "
          f"{time.perf_counter() - t0:.1f} s)" if built else
          f"native_loader: unavailable: {native.unavailable_reason()}",
          flush=True)
    numbers = {"native_loader": built,
               "f32_card_vs_cpu": eval_card_vs_cpu(
                   torch, dev, base, tokenizer, tmp, fixture["seed"],
                   kernels)}

    # bf16 through the CLI, on phase 7's best_model and validation set
    cfg_path = os.path.join(tmp, "eval_flagship.json")
    vocab_path = os.path.join(tmp, "eval_vocab.json")
    save_config(base, cfg_path)
    tokenizer.save(vocab_path)
    out_dir = os.path.dirname(base.checkpoint_dir)
    argv = ["--config", cfg_path, "--vocab", vocab_path, "--output_dir",
            out_dir, "--checkpoint", "best_model"]
    numbers["eval"], captions = eval_run(
        torch, "eval bf16 (--mode eval)",
        lambda: port_main.main(["--mode", "eval"] + argv), val_ds, out_dir,
        kernels, smi)

    rcfg = copy.deepcopy(base)
    rcfg.output_dir = out_dir
    rcfg.inference.use_clip_reranking = True
    reranker = CLIPReranker(scorer, clip_tokenize, lambda ids:
                            tokenizer.decode(ids, skip_special_tokens=True))
    numbers["reranked_eval"], reranked = eval_run(
        torch, "eval bf16 + CLIP reranking of 5 candidates",
        lambda: port_main.evaluate(rcfg, "best_model", tokenizer=tokenizer,
                                   reranker=reranker, device=dev),
        val_ds, out_dir, kernels, smi, rerank=True)
    print(f"reranked eval: the CLIP pick differs from the beam's best on "
          f"{sum(captions[i] != reranked[i] for i in captions)} of "
          f"{len(captions)} images", flush=True)

    image = os.path.join(val_ds.image_dir, val_ds.examples[0]["filename"])
    printed = io.StringIO()
    with DecodeCounts() as counts, contextlib.redirect_stdout(printed):
        _zero_launches(kernels)
        t0 = time.perf_counter()
        caption = port_main.main(["--mode", "demo", "--image_path",
                                  image] + argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = _launches(kernels)
    check(caption and printed.getvalue().splitlines()[-1] == caption,
          f"demo printed {printed.getvalue()!r}, returned {caption!r}")
    check(counts.encodes == 1, f"demo encoded {counts.encodes} batches")
    expect({"launches": launched}, {"beam_decode_stack": counts.steps,
                                    "lse_and_block_max": counts.steps,
                                    "encoder_stack": 1})
    numbers["demo"] = {"seconds": seconds, "steps": counts.steps,
                       "caption": caption, "launches": launched}
    print(f"demo bf16 (--mode demo): {caption!r}, {counts.steps} decode "
          f"steps, the call {seconds:.1f} s; launches {launched} [{smi}]",
          flush=True)

    # one CE epoch of main.train in the curriculum's order at batch 64
    ccfg = copy.deepcopy(base)
    ccfg.training.use_curriculum, ccfg.training.num_epochs = True, 1
    ccfg.training.use_rl = False
    ccfg.output_dir = os.path.join(tmp, "curriculum")
    ccfg.checkpoint_dir = os.path.join(ccfg.output_dir, "checkpoints")
    sampler = create_curriculum_sampler(fixture["train_ds"], ccfg)
    want = len(sampler) // ccfg.training.batch_size
    t0 = time.perf_counter()
    trainer = port_main.train(ccfg, tokenizer=tokenizer, device=dev)
    seconds = time.perf_counter() - t0
    check(trainer.step == want == trainer.total_steps,
          f"curriculum epoch: {trainer.step} steps, the sampler's {want}, "
          f"the schedule's {trainer.total_steps}")
    print(f"curriculum: main.train's epoch took {trainer.step} steps of "
          f"{ccfg.training.batch_size} over the sampler's {len(sampler)} "
          f"examples; {seconds:.1f} s with its validation and checkpoint",
          flush=True)
    numbers["curriculum"] = {"steps": trainer.step, "seconds": seconds}
    del trainer
    shutil.rmtree(ccfg.output_dir, ignore_errors=True)

    if built:
        numbers["jpeg"] = eval_jpeg(torch, dev, base, tokenizer, tmp,
                                    kernels, smi)
    return numbers


# ---------------------------------------------------------------------------
# the other families and the device-resident resize (phase 9)
# ---------------------------------------------------------------------------

# #6 at the new families' memory lengths, 64 images x 5 beams, 12 heads,
# width 768: (name, Sm, masked); Sm = 49 takes the CUDA-core route in
# bf16 (not a multiple of 4), 48 the tensor-core one, timed beside it
FAMILY_SHAPES = (("qformer", 32, False), ("butd", 36, True),
                 ("swin", 49, False), ("tensor-core route", 48, False))
# images of the f32 card-vs-CPU decodes, and the bf16 batches
FAMILY_F32_IMAGES = {"qformer": 4, "butd": 4, "swin": 2}
FAMILY_DECODE_BATCH = 64
FAMILY_TRAIN_BATCH = 32
# the device-resize fixture: JPEGs of 300 +- 120 pixels, so that squares
# are upscaled, downscaled and (above the 336-pixel canvas) shrunk on the
# host first
RESIZE_IMAGES, RESIZE_F32_IMAGES = 16, 4


def check_cross_families(torch, dev, smi):
    """#6 against its plain version at :data:`FAMILY_SHAPES` (BUTD's
    memory masked past each image's 20 to 36 valid regions), float32
    within 1e-5 relative and bf16 within 2 ulps, then timed in bf16
    beside its plain version and SDPA; the bound counts the valid rows.
    Returns {name: shape_entry}."""
    from image_captioning_ml_project_tpu_torch.ops.cross_attention import (
        cross_attention, cross_attention_plain)

    B, K, NH, H = FAMILY_DECODE_BATCH, 5, 12, 768
    Bk, hd = B * K, H // NH
    kw = dict(num_heads=NH, beam_size=K, scale=1.0 / hd ** 0.5)
    g = torch.Generator(device=dev).manual_seed(4321)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {}
    for name, Sm, masked in FAMILY_SHAPES:
        mask = None
        if masked:
            counts = torch.randint(20, Sm + 1, (B, 1), generator=g,
                                   device=dev)
            mask = torch.arange(Sm, device=dev)[None] >= counts
        valid = B * Sm if mask is None else int((~mask).sum())
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((Bk, H), generator=g, device=dev).to(dtype)
            mkt = torch.randn((B, H, Sm), generator=g, device=dev).to(dtype)
            mv = torch.randn((B, Sm, H), generator=g, device=dev).to(dtype)
            got = cross_attention(q, mkt, mv, mask, **kw)
            want = cross_attention_plain(q, mkt, mv, mask, **kw)
            torch.cuda.synchronize()
            dname = str(dtype)[6:]
            err = check_close(f"cross_attention {name} Sm={Sm} {dname}", got,
                              want, dname, 1e-5, 2)
        q4 = q.view(B, K, NH, hd).transpose(1, 2)
        k4 = mkt.view(B, NH, hd, Sm).transpose(2, 3)
        v4 = mv.view(B, Sm, NH, hd).transpose(1, 2)
        attend = None if mask is None else ~mask[:, None, None, :]
        ms, dev_ms = time_ms(
            torch, lambda: cross_attention(q, mkt, mv, mask, **kw),
            flush=flush, device=True)
        plain_ms = time_ms(
            torch, lambda: cross_attention_plain(q, mkt, mv, mask, **kw),
            flush=flush)
        lib_ms = time_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=attend, scale=kw["scale"]), flush=flush)
        bnd = bound((2 * Bk * H + 2 * valid * H) * 2
                    + (0 if mask is None else B * Sm),
                    {"f32": 4 * K * valid * H})
        out[name] = shape_entry(
            f"B={B} K={K} H={H} Sm={Sm}{' masked' if masked else ''} bf16",
            err, ms, plain_ms, bnd, lib_ms, dev_ms)
        print(f"cross_attention {name} Sm={Sm} bf16: device {dev_ms:.4f} ms, "
              f"event {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}), plain {plain_ms:.4f} ms, SDPA "
              f"{lib_ms:.4f} ms [{smi}]", flush=True)
    return out


def family_inputs(torch, cfg, n, seed):
    """``n`` random inputs of ``cfg`` on the CPU: uint8 images, or BUTD's
    regions with 20 to 36 of them valid an image."""
    from image_captioning_ml_project_tpu_torch.profile_slice import (
        model_inputs)

    return model_inputs(cfg, n, torch.Generator().manual_seed(seed))


def family_decode(torch, cfg, model, inputs):
    """:func:`decode`'s host tokens and float scores."""
    res = decode(torch, model, cfg, inputs)
    return res.tokens.cpu(), res.scores.float().cpu()


def family_card_vs_cpu(torch, dev, name, cfg, tree, kernels):
    """The f32 decode of :data:`FAMILY_F32_IMAGES` inputs on the card
    (through #2, #6 and #4) and on the CPU (plain versions) from the same
    weights: tokens identical, scores within 1e-4."""
    from image_captioning_ml_project_tpu_torch.models.captioning_model import (
        load_model)
    from image_captioning_ml_project_tpu_torch.profile_slice import (
        move_inputs)

    cfg32 = copy.deepcopy(cfg)
    cfg32.model.dtype = "float32"
    n = FAMILY_F32_IMAGES[name]
    x = family_inputs(torch, cfg32, n, cfg.seed + 3)
    out = {}
    t0 = time.perf_counter()
    for where in (dev, torch.device("cpu")):
        model = load_model(cfg32, where, params=tree)
        out[where.type] = family_decode(torch, cfg32, model,
                                        move_inputs(x, where))
        del model
    (tok_g, sc_g), (tok_c, sc_c) = out["cuda"], out["cpu"]
    err = float((sc_g - sc_c).abs().max())
    print(f"{name} f32 card vs CPU ({n} images): tokens gpu="
          f"{tok_g.tolist()} cpu={tok_c.tolist()}, scores max_abs_err "
          f"{err:.3e}; {time.perf_counter() - t0:.1f} s", flush=True)
    check(torch.isfinite(sc_g).all(), f"{name}: non-finite scores")
    check(torch.equal(tok_g, tok_c),
          f"{name}: card and CPU decode different tokens")
    check(err <= 1e-4, f"{name}: scores differ by {err} > 1e-4")
    return {"images": n, "score_err": err}


def family_launches(cfg, steps):
    """What a Transformer-decoder decode of ``steps`` steps launches: #2
    and #6 once a layer a step, #4 once a step, nothing else."""
    layers = cfg.model.decoder.num_layers
    return {"beam_decode_attention_qkv": steps * layers,
            "cross_attention": steps * layers, "lse_and_block_max": steps}


def family_bf16_decode(torch, dev, name, cfg, model, kernels, smi):
    """The direct bf16 decode of 64 inputs after a warm-up, its encode
    timed apart, with the launch counters set to 0 just before and read
    just after. Returns its numbers and the device inputs."""
    from image_captioning_ml_project_tpu_torch.profile_slice import (
        move_inputs)

    x = move_inputs(family_inputs(torch, cfg, FAMILY_DECODE_BATCH,
                                  cfg.seed + 4), dev)
    family_decode(torch, cfg, model, x)
    with torch.inference_mode():
        encode_ms = time_ms(torch, lambda: model.encode(x), runs=5)
    torch.cuda.synchronize()
    with DecodeCounts() as counts:
        _zero_launches(kernels)
        t0 = time.perf_counter()
        tokens, scores = family_decode(torch, cfg, model, x)
        seconds = time.perf_counter() - t0
        launched = _launches(kernels)
    check(torch.isfinite(scores).all(), f"{name}: non-finite bf16 scores")
    expect({"launches": launched}, family_launches(cfg, counts.steps))
    B = FAMILY_DECODE_BATCH
    print(f"{name} bf16 decode of {B}: encode {encode_ms:.2f} ms, the decode "
          f"{seconds * 1e3:.1f} ms ({B / seconds:.1f} images/s, "
          f"{counts.steps} steps); launches {launched} [{smi}]", flush=True)
    return {"batch": B, "encode_ms": encode_ms, "decode_ms": seconds * 1e3,
            "images_per_s": B / seconds, "steps": counts.steps,
            "launches": launched}, x, tokens


def family_train(torch, dev, name, cfg, tree, kernels, smi, tmp):
    """Two bf16 CE steps of :data:`FAMILY_TRAIN_BATCH` random inputs and
    captions through ``CaptioningTrainer``: finite losses, no kernel
    launched, each step's time, images/s and peak memory."""
    from image_captioning_ml_project_tpu_torch.profile_slice import (
        move_inputs)
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    B = FAMILY_TRAIN_BATCH
    tcfg = copy.deepcopy(cfg)
    tcfg.training.use_amp, tcfg.training.batch_size = True, B
    tcfg.training.use_rl = False
    tcfg.output_dir = tcfg.checkpoint_dir = os.path.join(tmp, f"{name}_train")
    trainer = CaptioningTrainer(tcfg, [None] * B, [], None, device=dev,
                                params=tree)
    g = torch.Generator().manual_seed(cfg.seed + 5)
    x = move_inputs(family_inputs(torch, cfg, B, cfg.seed + 5), dev)
    T = cfg.model.decoder.max_length
    caps = torch.randint(4, cfg.model.vocab_size, (B, T), generator=g).to(dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _zero_launches(kernels)
    step_ms, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(x, caps, mask)["total_loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launched = _launches(kernels)
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    del trainer
    check(all(math.isfinite(v) for v in losses), f"{name}: losses {losses}")
    check(not any(launched.values()),
          f"{name}: a training step launched kernels: {launched}")
    print(f"{name} bf16 CE steps of {B}: losses {losses}, "
          f"{[round(t, 1) for t in step_ms]} ms ({B / step_ms[-1] * 1e3:.1f} "
          f"images/s in the second), {peak:.2f} GiB at the peak [{smi}]",
          flush=True)
    return {"batch": B, "step_ms": step_ms, "losses": losses,
            "images_per_s": B / step_ms[-1] * 1e3, "peak_gib": peak}


def family_serve(torch, dev, name, cfg, tree, smi):
    """One served round of 64 through ``CaptionService`` after its warm-up
    round, the launches checked."""
    runs = serve(torch, dev, cfg, tree, smi,
                 [(f"{name} served", CONFIGS[0][1], 1, 0)])
    run = runs[f"{name} served"]
    expect(run, family_launches(cfg, run["steps"]))
    return {k: run[k] for k in ("steps", "batches", "launches")}


def butd_eval(torch, dev, cfg, fixture, tmp, kernels, smi):
    """``--mode eval`` of the BUTD configuration over detector features of
    phase 7's 64 validation images (36 regions of 2048, 20 to 36 valid),
    seeded weights, a word vocabulary of 30000: every image captioned
    once, #2 and #6 once a layer a step, #4 once a step, nothing else."""
    from image_captioning_ml_project_tpu_torch import main as port_main
    from image_captioning_ml_project_tpu_torch.config import save_config
    from image_captioning_ml_project_tpu_torch.data.synthetic import (
        make_synthetic_object_features)
    from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab

    root = fixture["config"].data_root
    make_synthetic_object_features(
        os.path.join(root, cfg.features_dir),
        os.path.join(root, cfg.val_json), max_objects=36, feature_dim=2048,
        seed=fixture["seed"], min_objects=20)
    vocab = WordVocab({w: i for w, i in fixture["tokenizer"].word2idx.items()
                       if i < cfg.model.vocab_size})
    ecfg = copy.deepcopy(cfg)
    ecfg.data_root = root
    out_dir = os.path.join(tmp, "butd_eval")
    cfg_path, vocab_path = (os.path.join(tmp, f"butd.{x}")
                            for x in ("json", "vocab.json"))
    save_config(ecfg, cfg_path)
    vocab.save(vocab_path)
    n = len(fixture["val_ds"])
    with DecodeCounts() as counts:
        _zero_launches(kernels)
        t0 = time.perf_counter()
        metrics = port_main.main(["--mode", "eval", "--config", cfg_path,
                                  "--vocab", vocab_path, "--output_dir",
                                  out_dir])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = _launches(kernels)
    results = _results(os.path.join(out_dir, "results.json"))
    check(len(results) == n, f"butd eval captioned {len(results)} of {n}")
    check(counts.encodes == -(-n // EVAL_BATCH),
          f"butd eval: {counts.encodes} batches")
    expect({"launches": launched}, family_launches(cfg, counts.steps))
    print(f"butd --mode eval: {n} images in {counts.encodes} batches, "
          f"{counts.steps} decode steps, the call {seconds:.1f} s; CIDEr "
          f"{metrics['CIDEr']:.4f}; launches {launched} [{smi}]", flush=True)
    return {"images": n, "steps": counts.steps, "seconds": seconds,
            "cider": metrics["CIDEr"], "launches": launched}


def butd_leak(torch, model, cfg, x, tokens):
    """Masked regions cannot leak into the decode: the bf16 tokens with
    every masked region's features and boxes replaced by large noise are
    those of the original inputs."""
    mask = x["region_mask"]
    g = torch.Generator(device=mask.device).manual_seed(cfg.seed + 6)
    noisy = dict(x)
    for key in ("region_features", "region_boxes"):
        noise = 100 * torch.randn(x[key].shape, generator=g,
                                  device=mask.device)
        noisy[key] = torch.where(mask[..., None], x[key], noise)
    got, _ = family_decode(torch, cfg, model, noisy)
    check(torch.equal(got, tokens),
          "butd: the features of masked regions changed the tokens")
    print(f"butd: masked regions ({int((~mask).sum())} of {mask.numel()}) "
          f"replaced by noise, the tokens unchanged", flush=True)


def resize_phase(torch, dev, fixture, scorer, tmp, kernels, smi):
    """The flagship's device-resident resize on phase 7's ``best_model``:
    the card's ``resize_normalize`` of a batch of canvases against the
    CPU's (1e-4); ``main.evaluate`` with ``device_resize`` in f32 on the
    card and the CPU, captions identical; ``--mode eval --device_resize``
    in bf16, then with the CLIP reranker on the resized pixels, then
    ``--mode eval --fold_normalize`` (uint8 to the patch embed's fold),
    each with its launches checked."""
    from image_captioning_ml_project_tpu_torch import main as port_main
    from image_captioning_ml_project_tpu_torch.config import save_config
    from image_captioning_ml_project_tpu_torch.data.coco import (
        build_coco_datasets, iterate_batches)
    from image_captioning_ml_project_tpu_torch.data.synthetic import (
        make_synthetic_coco)
    from image_captioning_ml_project_tpu_torch.inference.reranking import (
        CLIPReranker)
    from image_captioning_ml_project_tpu_torch.ops.resize import (
        resize_normalize)

    tokenizer, seed = fixture["tokenizer"], fixture["seed"]
    base = copy.deepcopy(fixture["config"])
    base.device_resize = True
    roots = {n: make_synthetic_coco(
        os.path.join(tmp, f"resize{n}"), num_images=n, captions_per_image=5,
        image_size=300, seed=seed + 7, image_format="jpg", size_jitter=120)
        for n in (RESIZE_F32_IMAGES, RESIZE_IMAGES)}
    base.data_root = roots[RESIZE_IMAGES]
    _, val_ds = build_coco_datasets(base, tokenizer)
    batch = next(iterate_batches(val_ds, RESIZE_IMAGES, shuffle=False))
    canvas, sides = (torch.from_numpy(batch[k]) for k in ("image",
                                                          "image_size"))
    got = resize_normalize(canvas.to(dev), sides.to(dev), base.image_size)
    want = resize_normalize(canvas, sides, base.image_size)
    err = float((got.cpu() - want).abs().max())
    print(f"resize_normalize card vs CPU: {RESIZE_IMAGES} canvases of "
          f"{canvas.shape[1]}, sides {sides.tolist()}: max_abs_err "
          f"{err:.3e}", flush=True)
    check(err <= 1e-4, f"resize_normalize: card and CPU differ by {err}")
    numbers = {"canvas_err": err, "sides": sides.tolist()}

    out = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        c = copy.deepcopy(base)
        c.model.dtype = "float32"
        c.data_root = roots[RESIZE_F32_IMAGES]
        c.output_dir = os.path.join(tmp, f"resize_f32_{where}")
        port_main.evaluate(c, "best_model", tokenizer=tokenizer,
                           device=device)
        out[where] = _results(os.path.join(c.output_dir, "results.json"))
    check(out["card"] == out["cpu"] and len(out["card"]) == RESIZE_F32_IMAGES,
          f"device-resize f32 eval captions differ: {out}")
    print(f"device-resize f32 eval card vs CPU: the {RESIZE_F32_IMAGES} "
          f"captions identical", flush=True)

    out_dir = os.path.dirname(base.checkpoint_dir)
    cfg_path = os.path.join(tmp, "resize_flagship.json")
    vocab_path = os.path.join(tmp, "resize_vocab.json")
    plain = copy.deepcopy(base)
    plain.device_resize = False
    save_config(plain, cfg_path)
    tokenizer.save(vocab_path)
    argv = ["--config", cfg_path, "--vocab", vocab_path, "--output_dir",
            out_dir, "--checkpoint", "best_model"]
    numbers["eval"], captions = eval_run(
        torch, "eval bf16 --device_resize",
        lambda: port_main.main(["--mode", "eval", "--device_resize"]
                               + argv), val_ds, out_dir, kernels, smi)
    rcfg = copy.deepcopy(base)
    rcfg.output_dir = out_dir
    rcfg.inference.use_clip_reranking = True
    reranker = CLIPReranker(scorer, clip_tokenize, lambda ids:
                            tokenizer.decode(ids, skip_special_tokens=True))
    numbers["reranked_eval"], _ = eval_run(
        torch, "eval bf16 --device_resize + CLIP reranking",
        lambda: port_main.evaluate(rcfg, "best_model", tokenizer=tokenizer,
                                   reranker=reranker, device=dev),
        val_ds, out_dir, kernels, smi, rerank=True)
    numbers["fold_eval"], folded = eval_run(
        torch, "eval bf16 --fold_normalize",
        lambda: port_main.main(["--mode", "eval", "--fold_normalize"]
                               + argv), val_ds, out_dir, kernels, smi)
    print(f"--fold_normalize (host resize) against --device_resize: "
          f"{sum(captions[i] != folded[i] for i in captions)} of "
          f"{len(captions)} captions differ", flush=True)
    return numbers


def families_phase(torch, dev, smi, fixture, scorer, tmp):
    """Phase 9 (module docstring). Returns the summary line's numbers and
    #6's entries at the new memory lengths."""
    from image_captioning_ml_project_tpu_torch.main import (
        butd_config, qformer_config, transformer_config)
    from image_captioning_ml_project_tpu_torch.config import EncoderType
    from image_captioning_ml_project_tpu_torch.models.captioning_model import (
        load_model)
    from image_captioning_ml_project_tpu_torch.params import init_flax_params

    kernels = counters()
    t0 = time.perf_counter()
    cross = check_cross_families(torch, dev, smi)
    print(f"#6 at the families' shapes: {time.perf_counter() - t0:.1f} s",
          flush=True)

    def swin_config():
        c = transformer_config()
        c.model.encoder.encoder_type = EncoderType.SWIN
        return c

    numbers = {}
    for name, make in (("qformer", qformer_config), ("butd", butd_config),
                       ("swin", swin_config)):
        t0 = time.perf_counter()
        cfg = make()
        cfg.seed = fixture["seed"]
        tree = init_flax_params(cfg, cfg.seed)
        print(f"{name}: weights drawn from seed {cfg.seed}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        fam = {"f32_card_vs_cpu": family_card_vs_cpu(torch, dev, name, cfg,
                                                     tree, kernels)}
        model = load_model(cfg, dev, params=tree)
        fam["decode"], x, tokens = family_bf16_decode(torch, dev, name, cfg,
                                                      model, kernels, smi)
        if name == "butd":
            butd_leak(torch, model, cfg, x, tokens)
        del model, x
        if name == "butd":
            fam["eval"] = butd_eval(torch, dev, cfg, fixture, tmp, kernels,
                                    smi)
        else:
            fam["served"] = family_serve(torch, dev, name, cfg, tree, smi)
        if name != "swin":
            fam["train"] = family_train(torch, dev, name, cfg, tree, kernels,
                                        smi, tmp)
        del tree
        torch.cuda.empty_cache()
        check_ancestry(dev, name)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
        numbers[name] = fam
    t0 = time.perf_counter()
    numbers["device_resize"] = resize_phase(torch, dev, fixture, scorer, tmp,
                                            kernels, smi)
    print(f"device resize: {time.perf_counter() - t0:.1f} s", flush=True)
    return numbers, cross


# ---------------------------------------------------------------------------
# parallel and legacy (phase 10)
# ---------------------------------------------------------------------------

PAR_RANKS = 2
PAR_F32_BATCH = 4         # global batch of the f32 parity steps
PAR_BF16_BATCH = 64       # global batch of the timed bf16 steps
PAR_BF16_STEPS = 6        # one warm-up step, then five timed
PAR_VAL_BATCH = 64        # validation: 32 rows a rank
PAR_RANK_TIMEOUT = 900    # seconds the ranks may take together
LEGACY_VOCAB = 10000
LEGACY_STEPS = 20
LEGACY_BATCH = 16         # the JAX legacy CLI's
LEGACY_MAX_LENGTH = 20
LEGACY_IMAGES = 4         # card against CPU, and generate_captions


class _RecordingTokenizer:
    """The tokenizer, keeping every token row it decodes."""

    def __init__(self, tokenizer):
        self._tokenizer = tokenizer
        self.rows = []

    def __getattr__(self, name):
        return getattr(self._tokenizer, name)

    def __len__(self):
        return len(self._tokenizer)

    def decode(self, ids, skip_special_tokens=True):
        self.rows.append([int(i) for i in ids])
        return self._tokenizer.decode(ids, skip_special_tokens)


def _cpu_tree(tree):
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        return tree.detach().float().cpu().clone()
    return tree


def _legacy_tree(trainer):
    """A legacy trainer's state as :func:`hold_train_state` reads one (its
    parameters under ``model``)."""
    st = trainer.state_tree()
    return {"params": {"model": st["params"], "loss": {}},
            "batch_stats": st["batch_stats"], "opt_state": st["opt_state"],
            "step": st["step"]}


def _digests(torch, tree):
    """sha256 of every tensor of a state tree, by path."""
    import hashlib

    return {k: hashlib.sha256(v.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()
        for k, v in _flat_state(tree).items()}


# the weight nudged by one or two ulps for a run's rounding floor
FLOOR_WEIGHT = "encoder.backbone.embedder.convolution.weight"


def nudge_weights(torch, model):
    """Scale the ResNet's stem weights by 1 + 2^-22 (one or two ulps): the
    run then differs from the unnudged one by rounding alone."""
    with torch.no_grad():
        model.get_parameter(FLOOR_WEIGHT).mul_(1 + 2.0 ** -22)


def one_warmup_step(schedule):
    """``schedule`` with lr 0 at the first update, as a warmup step."""
    return lambda count: schedule(count) if count else 0.0


def _floor_run(torch, make, step, tree, prefix=""):
    """The rounding floor of a run: a trainer from ``make()`` with
    :func:`nudge_weights` applied takes two steps (``step(trainer)``);
    returns its :func:`record_steps` records (names prefixed with
    ``prefix``) and its state after them (``tree(trainer)`` on the CPU),
    as :func:`hold_train_state`'s ``floor``."""
    t = make()
    nudge_weights(torch, t.model)
    steps = []
    record_steps(torch, t, steps, prefix=prefix)
    step(t)
    step(t)
    out = {"steps": steps, "state": _cpu_tree(tree(t))}
    del t.optimizer.step, t
    return out


def _par_data(spec):
    """(base config, tokenizer, train set, val set) of phase 7's fixture,
    as the parent hands it to the ranks."""
    from image_captioning_ml_project_tpu_torch.config import config_from_dict
    from image_captioning_ml_project_tpu_torch.data.coco import (
        build_coco_datasets)
    from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab

    base = config_from_dict(spec["config"])
    tokenizer = WordVocab.load(spec["vocab"])
    train_ds, val_ds = build_coco_datasets(base, tokenizer)
    return base, tokenizer, train_ds, val_ds


def _par_f32_config(data, family, out, warmup):
    """The f32 parity steps' config of ``family`` (``flagship``, or
    ``lstm``: ResNet-101 + LSTM) on phase 7's fixture: global batch 4,
    dropout 0, lr 1e-4 after ``warmup`` steps, validation in one batch of
    64."""
    from image_captioning_ml_project_tpu_torch.main import lstm_config

    base, tokenizer = data[:2]
    if family == "lstm":
        base = copy.deepcopy(base)
        base.model = copy.deepcopy(lstm_config().model)
        base.model.pad_token_id = tokenizer.pad_token_id
        base.model.bos_token_id = tokenizer.bos_token_id
        base.model.eos_token_id = tokenizer.eos_token_id
    c = _train_config(base, out, False, PAR_F32_BATCH, 1e-4, warmup, 0.0)
    c.inference.num_candidates = PAR_VAL_BATCH
    return c


def _par_lstm_no_warmup(torch, dev, spec, data, mesh, tmp):
    """The LSTM family's two f32 parity steps without the warmup step (the
    first at lr 1e-4): each step's total loss at dp2, and in one process
    with the stem nudged by one ulp (:func:`nudge_weights`), relative to
    the one-process run's. Reported, not held: after a real first update
    the runs part at the entries whose Adam step's sign rounding decides,
    and the nudged run shows how far rounding alone then moves the second
    step's loss (the reason :func:`_par_f32` takes a warmup step).
    Returns rank 0's numbers."""
    from image_captioning_ml_project_tpu_torch.data.pipeline import (
        shard_batch)
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    _, tokenizer, train_ds, val_ds = data
    c = _par_f32_config(data, "lstm", os.path.join(tmp, "f32_lstm_nw"), 0)
    sd = torch.load(spec["weights"]["lstm"], mmap=True, weights_only=True)
    batch = _fixed_batch(train_ds, PAR_F32_BATCH)
    runs = (("one process", None, False), ("nudged", None, True),
            ("dp2", mesh, False))
    losses = {}
    for name, m, nudge in runs:
        if m is None and mesh.rank != 0:
            continue
        t = CaptioningTrainer(c, train_ds, val_ds, tokenizer, device=dev,
                              state_dict=sd, mesh=m)
        if nudge:
            nudge_weights(torch, t.model)
        b = shard_batch(batch, m)
        losses[name] = [float(t.train_step(
            b["image"], b["caption_tokens"], b["attention_mask"])[
                "total_loss"]) for _ in range(2)]
        del t
        torch.cuda.empty_cache()
    if mesh.rank != 0:
        return None
    ref = losses["one process"]
    out = {f"{name} loss_rel": [abs(a - b) / abs(b)
                                for a, b in zip(losses[name], ref)]
           for name in ("dp2", "nudged")}
    print(f"parallel f32 lstm dp2 without the warmup step, each step's "
          f"loss relative to one process: {out}", flush=True)
    return out


def _par_f32(torch, dev, spec, data, mesh, family, refs, kernels, tmp):
    """Two f32 CE steps of global batch 4 (dropout 0, one warmup step) of
    ``family`` on ``mesh``, held on rank 0 to the one-process trainer's
    on the card (built once per family, kept in ``refs``) by phase 7's
    rules; with ``validate`` first the f32 validation of 64 images, each
    rank decoding its rows, its gathered tokens against the one-process
    decode's. Returns this rank's numbers (rank 0's with the
    comparisons)."""
    from image_captioning_ml_project_tpu_torch.data.pipeline import (
        shard_batch)
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    _, tokenizer, train_ds, val_ds = data
    # one warmup step, as the CPU parity tests take: lr 0 at the first
    # step, so both steps run on the same weights and only the second
    # update's Adam signs can part the two runs
    c = _par_f32_config(data, family, os.path.join(tmp, f"f32_{family}"), 1)
    sd = torch.load(spec["weights"][family], mmap=True, weights_only=True)
    rank = mesh.rank
    numbers = {"mesh": dict(mesh.shape)}
    validate = family == "flagship" and mesh.mp == 1
    if rank == 0 and family not in refs:
        ref = CaptioningTrainer(c, train_ds, val_ds, tokenizer, device=dev,
                                state_dict=sd)
        entry = {"before": param_start(ref._state_tree()), "steps": []}
        if validate:
            rec = _RecordingTokenizer(tokenizer)
            ref.tokenizer = rec
            entry["validation"] = (ref._validate_epoch(0), rec.rows)
        record_steps(torch, ref, entry["steps"])
        batch = _fixed_batch(train_ds, PAR_F32_BATCH)
        if family == "lstm":
            entry["floor"] = _floor_run(
                torch, lambda: CaptioningTrainer(
                    c, train_ds, val_ds, tokenizer, device=dev,
                    state_dict=sd),
                lambda t: t.train_step(batch["image"],
                                       batch["caption_tokens"],
                                       batch["attention_mask"]),
                lambda t: t._state_tree())
        entry["metrics"] = [{k: float(v) for k, v in ref.train_step(
            batch["image"], batch["caption_tokens"],
            batch["attention_mask"]).items()} for _ in range(2)]
        entry["state"] = _cpu_tree(ref._state_tree())
        del ref.optimizer.step, ref
        torch.cuda.empty_cache()
        refs[family] = entry
    t = CaptioningTrainer(c, train_ds, val_ds, tokenizer, device=dev,
                          state_dict=sd, mesh=mesh)
    del sd
    if validate:
        rec = _RecordingTokenizer(tokenizer)
        t.tokenizer = rec
        _zero_launches(kernels)
        with DecodeCounts() as counted:
            t0 = time.perf_counter()
            val_loss, metrics = t._validate_epoch(0)
            seconds = time.perf_counter() - t0
        launched = _launches(kernels)
        # #5 twice a batch: the validation loss's forward and the
        # decode's encode
        want = {"encoder_stack": 2 * counted.encodes,
                "beam_decode_stack": counted.steps,
                "lse_and_block_max": counted.steps}
        check(counted.encodes == 1 and counted.steps > 0 and launched == {
            k: want.get(k, 0) for k in launched},
            f"rank {rank} validation: {counted.encodes} encodes, "
            f"{counted.steps} decode steps, launches {launched}")
        numbers["validation"] = {"seconds": seconds, "launches": launched,
                                 "decode_steps": counted.steps,
                                 "rows_per_rank": PAR_VAL_BATCH // mesh.dp}
        if rank == 0:
            (ref_loss, ref_metrics), ref_rows = refs[family]["validation"]
            check(rec.rows == ref_rows,
                  f"dp{mesh.dp} validation tokens differ from the "
                  f"one-process decode's")
            rel = abs(val_loss - ref_loss) / abs(ref_loss)
            check(rel <= 1e-5, f"validation loss {val_loss} one process "
                               f"{ref_loss}")
            numbers["validation"].update(
                val_loss=val_loss, loss_rel=rel, cider=metrics["CIDEr"],
                cider_one_process=ref_metrics["CIDEr"],
                rows=len(rec.rows))
    steps = []
    record_steps(torch, t, steps)
    batch = shard_batch(_fixed_batch(train_ds, PAR_F32_BATCH), mesh)
    _zero_launches(kernels)
    metrics = [{k: float(v) for k, v in t.train_step(
        batch["image"], batch["caption_tokens"],
        batch["attention_mask"]).items()} for _ in range(2)]
    launched = _launches(kernels)
    check(not any(launched.values()),
          f"rank {rank}: f32 steps launched kernels: {launched}")
    state = _cpu_tree(t._state_tree())
    del t.optimizer.step, t
    torch.cuda.empty_cache()
    if rank != 0:
        return numbers
    ref = refs[family]
    worst = {}
    # losses within 1e-5 relative, grad_norm within phase 7's 1e-3 (the
    # ResNet's BatchNorm over 2 + 2 rows amplifies the reduction order)
    for i, (a, b) in enumerate(zip(metrics, ref["metrics"])):
        for key, tol in (("total_loss", 1e-5), ("ce_loss", 1e-5),
                         ("grad_norm", 1e-3)):
            rel = abs(a[key] - b[key]) / abs(b[key])
            worst[key] = max(worst.get(key, 0.0), rel)
            check(rel <= tol, f"{family} {dict(mesh.shape)} step {i + 1}: "
                              f"{key} {a[key]} one process {b[key]}")
        check(a["learning_rate"] == b["learning_rate"],
              f"learning rates {a} {b}")
    held = hold_train_state(
        torch, state, ref["state"], ref["before"], (steps, ref["steps"]),
        [m["learning_rate"] for m in ref["metrics"]],
        c.training.weight_decay, floor=ref.get("floor"))
    print(f"parallel f32 {family} {dict(mesh.shape)}: worst relative "
          f"{worst}; {held}", flush=True)
    numbers.update(worst_rel=worst, losses=[m["total_loss"]
                                            for m in metrics])
    return numbers


def _par_bf16(torch, dev, spec, data, mesh, kernels, tmp):
    """One warm-up and five timed bf16 CE steps of global batch 64 (dropout
    0.1, lr 1e-4, warmup 2) of the flagship on ``mesh``: each rank's median
    step time, images/s and peak memory, no kernel launched; at tp2 the
    checkpoint saved and the gathered state's digests. Returns this rank's
    numbers."""
    from image_captioning_ml_project_tpu_torch.data.pipeline import (
        shard_batch)
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)
    from image_captioning_ml_project_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    base, tokenizer, train_ds, val_ds = data
    c = _train_config(base, os.path.join(tmp, f"bf16_{mesh.mp}"), True,
                      PAR_BF16_BATCH, 1e-4, 2, 0.1)
    sd = torch.load(spec["weights"]["flagship"], mmap=True, weights_only=True)
    t = CaptioningTrainer(c, train_ds, val_ds, tokenizer, device=dev,
                          state_dict=sd, mesh=mesh)
    del sd
    batch = shard_batch(_fixed_batch(train_ds, PAR_BF16_BATCH), mesh)
    images, caps, mask = (torch.from_numpy(batch[k]).to(dev) for k in (
        "image", "caption_tokens", "attention_mask"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches(kernels)
    times, losses = [], []
    for _ in range(PAR_BF16_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(t.train_step(images, caps, mask)["total_loss"]))
        times.append(time.perf_counter() - t0)
    launched = _launches(kernels)
    check(not any(launched.values()),
          f"rank {mesh.rank}: bf16 steps launched kernels: {launched}")
    check(all(map(math.isfinite, losses)), f"bf16 losses {losses}")
    ms = statistics.median(times[1:]) * 1e3
    numbers = {"rank": mesh.rank, "rows": len(caps), "ms_per_step": ms,
               "images_per_s": PAR_BF16_BATCH / ms * 1e3,
               "first_step_ms": times[0] * 1e3, "losses": losses,
               "max_memory_allocated_gib":
                   torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               "launches": launched}
    if mesh.mp > 1:
        t.ckpt = CheckpointManager(spec["tp_checkpoint"])
        t0 = time.perf_counter()
        t.save_checkpoint(0)
        t.ckpt.wait_until_finished()
        numbers["checkpoint_save_s"] = time.perf_counter() - t0
        tree = t._state_tree()
        if mesh.rank == 0:
            numbers["digests"] = _digests(torch, tree)
        del tree
    del t
    torch.cuda.empty_cache()
    return numbers


def _par_legacy(torch, dev, spec, mesh, tmp):
    """Two f32 legacy steps (dropout 0, the first at lr 0) of global batch
    4 at dp2, held on rank 0 to the one-process steps on the card: ``ce``
    and ``att_reg`` within 1e-5 relative, the state by
    :func:`hold_train_state` with the one-process run's rounding floor."""
    from image_captioning_ml_project_tpu_torch.data.pipeline import (
        shard_batch)
    from image_captioning_ml_project_tpu_torch.legacy.train import (
        LegacyTrainer)

    vocab, train_ds, _ = _legacy_data(spec)
    batch = _fixed_batch(train_ds, PAR_F32_BATCH)
    sd = torch.load(spec["weights"]["legacy"], mmap=True, weights_only=True)

    def make(m=None):
        t = LegacyTrainer(vocab, None, mesh=m, device=dev, dropout=0.0,
                          state_dict=sd,
                          checkpoint_dir=os.path.join(tmp, "legacy_ck"))
        t.optimizer.schedule = one_warmup_step(t.optimizer.schedule)
        return t

    def step(t, m=None):
        b = shard_batch(batch, m)
        return {k: float(v) for k, v in t.train_step(
            b["image"], b["caption_tokens"]).items()}

    runs = {}
    for name, m in (("one process", None), ("dp2", mesh)):
        if name == "one process" and mesh.rank != 0:
            continue
        t = make(m)
        before = param_start(_legacy_tree(t))
        steps = []
        record_steps(torch, t, steps, prefix="model.")
        lrs = [float(t.optimizer.schedule(i)) for i in range(2)]
        metrics = [step(t, m) for _ in range(2)]
        runs[name] = (metrics, _cpu_tree(_legacy_tree(t)), steps)
        del t.optimizer.step, t
        torch.cuda.empty_cache()
    if mesh.rank != 0:
        return None
    floor = _floor_run(torch, make, step, _legacy_tree, prefix="model.")
    (got_m, got, got_steps), (want_m, want, want_steps) = (
        runs["dp2"], runs["one process"])
    worst = {}
    for a, b in zip(got_m, want_m):
        for key in ("ce", "att_reg"):
            rel = abs(a[key] - b[key]) / abs(b[key])
            worst[key] = max(worst.get(key, 0.0), rel)
            check(rel <= 1e-5, f"legacy dp2 {key} {a[key]} one process "
                               f"{b[key]}")
    held = hold_train_state(torch, got, want, before,
                            (got_steps, want_steps), lrs, 0.0, floor=floor)
    print(f"parallel legacy dp2, two steps: ce {got_m[-1]['ce']:.6f} (one "
          f"process {want_m[-1]['ce']:.6f}); worst relative {worst}; "
          f"{held}", flush=True)
    return {"worst_rel": worst, "ce": got_m[-1]["ce"],
            "att_reg": got_m[-1]["att_reg"]}


def parallel_rank(spec_path, rank):
    """One rank of phase 10's two (``--parallel-rank``): the process group
    over gloo through a file store (both ranks on card 0), the kernels
    loaded from the parent's build, then each scenario in order; rank 0
    writes every rank's numbers to the spec's ``out``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from image_captioning_ml_project_tpu_torch.config import MeshConfig
    from image_captioning_ml_project_tpu_torch.ops import _build
    from image_captioning_ml_project_tpu_torch.parallel.mesh import (
        create_mesh, init_distributed, rank_device)

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # the f32 comparisons: one algorithm per convolution, run to run
    torch.backends.cudnn.deterministic = True
    init_distributed(rank=rank, world_size=PAR_RANKS,
                     init_method=f"file://{spec['store']}",
                     timeout_s=spec.get("timeout", PAR_RANK_TIMEOUT))
    dev = torch.device(rank_device("cuda", rank))
    for name in LIBRARIES:
        _build.load_library(name)
    kernels = counters()
    if spec.get("phase") == "serving_mesh":
        try:
            out = serving_rank(torch, dev, spec, kernels)
            per_rank = [None] * PAR_RANKS
            dist.all_gather_object(per_rank, out)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            with open(spec["out"], "w") as f:
                json.dump(per_rank, f)
        return
    tmp = os.path.join(spec["tmp"], f"rank{rank}")
    data = _par_data(spec)
    out, refs = {}, {}
    try:
        def mesh_of(dp, mp):
            return create_mesh(MeshConfig(data_parallel=dp,
                                          model_parallel=mp))

        for family, dp, mp in (("flagship", 2, 1), ("flagship", 1, 2),
                               ("lstm", 2, 1)):
            t0 = time.perf_counter()
            key = f"f32 {family} dp{dp} tp{mp}"
            out[key] = _par_f32(torch, dev, spec, data, mesh_of(dp, mp),
                                family, refs, kernels, tmp)
            if rank == 0:
                out[key]["seconds"] = time.perf_counter() - t0
        refs.clear()
        out["f32 lstm dp2 no warmup"] = _par_lstm_no_warmup(
            torch, dev, spec, data, mesh_of(2, 1), tmp)
        for dp, mp in ((2, 1), (1, 2)):
            out[f"bf16 flagship dp{dp} tp{mp}"] = _par_bf16(
                torch, dev, spec, data, mesh_of(dp, mp), kernels, tmp)
        out["f32 legacy dp2"] = _par_legacy(torch, dev, spec,
                                            mesh_of(2, 1), tmp)
        per_rank = [None] * PAR_RANKS
        dist.all_gather_object(per_rank, out)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(spec["out"], "w") as f:
            json.dump(per_rank, f)


def _legacy_data(spec):
    """(the legacy word vocabulary of 10000, train set, val set) over phase
    7's fixture at 224 pixels."""
    from image_captioning_ml_project_tpu_torch.data.coco import (
        COCOCaptionDataset)
    from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab

    vocab = WordVocab.load(spec["legacy_vocab"])
    root = spec["config"]["data_root"]
    sets = [COCOCaptionDataset(root, f"annotations/captions_{s}2014.json",
                               f"{s}2014", vocab, image_size=224,
                               max_length=LEGACY_MAX_LENGTH,
                               is_training=s == "train")
            for s in ("train", "val")]
    return vocab, sets[0], sets[1]


def run_parallel_ranks(torch, spec, tmp):
    """Start the two ranks (this script with ``--parallel-rank``), each
    logging to its own file, and wait for both within the spec's
    ``timeout`` (:data:`PAR_RANK_TIMEOUT` by default); a rank that fails
    or hangs fails the phase and every rank is stopped. Returns the
    ranks' numbers."""
    timeout = spec.get("timeout", PAR_RANK_TIMEOUT)
    spec_path = os.path.join(tmp, f"{spec.get('phase', 'parallel')}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    logs = [open(os.path.join(tmp, f"{spec.get('phase', 'parallel')}_"
                              f"rank{r}.log"), "w+")
            for r in range(PAR_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--parallel-rank", spec_path, str(r)],
                              env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=ROOT)
             for r in range(PAR_RANKS)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks passed {timeout} s"
                break
            time.sleep(0.2)
        if failed is None and any(p.returncode for p in procs):
            failed = f"exit codes {[p.returncode for p in procs]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, log in enumerate(logs):
        log.seek(0)
        text = log.read()
        if failed is not None:
            print(f"--- rank {r}:\n{text[-8000:]}", flush=True)
        else:
            for line in text.splitlines():
                if line.startswith("parallel "):
                    print(f"rank {r}: {line}", flush=True)
    check(failed is None, f"parallel ranks failed: {failed}")
    with open(spec["out"]) as f:
        return json.load(f)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _cli_command(args, ranks=0):
    """(argv, environment) of ``python -m
    image_captioning_ml_project_tpu_torch.main`` with ``args``, in one
    process or, with ``ranks``, under ``python -m torch.distributed.run
    --nproc_per_node ranks`` on a free localhost port."""
    cmd = [sys.executable, "-m"]
    if ranks:
        cmd += ["torch.distributed.run", f"--nproc_per_node={ranks}",
                "--master_addr=127.0.0.1", f"--master_port={_free_port()}",
                "-m"]
    cmd += [f"{PKG}.main", *args]
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return cmd, env


def _run_cli(args, log, timeout, ranks=0):
    """:func:`_cli_command`'s run, its output to ``log``. A run that exits
    non-zero or outlasts ``timeout`` s (its process group is then killed)
    fails the phase. Returns its seconds."""
    return _run_clis([(args, log, ranks)], timeout)[0]


def _run_clis(runs, timeout):
    """:func:`_run_cli` of each (args, log, ranks) of ``runs``, all started
    together; every process group is killed once they end or the first
    fails. Returns each run's seconds."""
    import signal

    t0 = time.perf_counter()
    started = []
    try:
        for args, log, ranks in runs:
            cmd, env = _cli_command(args, ranks)
            f = open(log, "w+")
            started.append((cmd, f, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT, env=env,
                start_new_session=True)))
        seconds = []
        for cmd, f, proc in started:
            try:
                rc = proc.wait(timeout=max(0.0, t0 + timeout
                                           - time.perf_counter()))
            except subprocess.TimeoutExpired:
                rc = f"killed after {timeout} s"
            if rc != 0:
                f.seek(0)
                print(f.read()[-8000:], flush=True)
            check(rc == 0, f"{' '.join(cmd[2:6])} ... exited {rc}")
            seconds.append(time.perf_counter() - t0)
        return seconds
    finally:
        for _, f, proc in started:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            f.close()


def torchrun_cli(torch, smi, base, vocab_path, tmp):
    """The CLI as ``torchrun`` starts it, two ranks on the one card over
    gloo: ``--mode train`` of the flagship at dp2 in bf16 (seeded weights;
    one epoch of phase 7's 320 training captions at global batch 64, five
    steps; validation of the 64 images; the epoch checkpoint from rank 0),
    then ``--mode eval`` of that checkpoint in f32 at dp2 (each rank
    decoding its 32 rows of the one batch of 64) and in one process:
    ``results.json`` identical. Returns the numbers."""
    from image_captioning_ml_project_tpu_torch.config import save_config
    from image_captioning_ml_project_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    paths = {}
    for name, amp in (("train", True), ("eval", False)):
        c = _train_config(base, os.path.join(tmp, f"cli_{name}"), amp,
                          PAR_BF16_BATCH, 1e-4, 2, 0.1)
        c.training.num_epochs = 1
        c.inference.num_candidates = PAR_VAL_BATCH
        c.mesh.data_parallel, c.mesh.model_parallel = 2, 1
        paths[name] = os.path.join(tmp, f"cli_{name}.json")
        save_config(c, paths[name])
    common = ["--vocab", vocab_path, "--device", "cuda"]
    out = os.path.join(tmp, "cli_train")
    numbers = {"card": smi, "ranks_share_the_card": True}
    numbers["train_s"] = _run_cli(
        ["--mode", "train", "--config", paths["train"], "--output_dir", out,
         *common], os.path.join(tmp, "cli_train.log"), 600, ranks=PAR_RANKS)
    with open(os.path.join(out, "training.log")) as f:
        logged = re.findall(r"Epoch 1: Train Loss: ([^,]+), Val Loss: "
                            r"([^,]+),", f.read())
    check(len(logged) == 1 and all(math.isfinite(float(x))
                                   for x in logged[0]),
          f"torchrun train: the epoch's losses in training.log: {logged}")
    ckpt = os.path.join(out, "checkpoints", "checkpoint_epoch_1")
    steps = CheckpointManager(os.path.dirname(ckpt)).restore(
        os.path.basename(ckpt), {"step": None})[0]["step"]
    want_steps = 5 * TRAIN_IMAGES // PAR_BF16_BATCH
    check(steps == want_steps, f"torchrun train: the checkpoint's step "
                               f"{steps}, not {want_steps}")
    numbers.update(train_loss=float(logged[0][0]),
                   val_loss=float(logged[0][1]), steps=steps)
    results = {}
    for name, ranks in (("one process", 0), ("dp2", PAR_RANKS)):
        d = os.path.join(tmp, f"cli_eval_{ranks}")
        numbers[f"eval {name} s"] = _run_cli(
            ["--mode", "eval", "--config", paths["eval"], "--output_dir", d,
             "--checkpoint", ckpt, *common],
            os.path.join(tmp, f"cli_eval_{ranks}.log"), 300, ranks=ranks)
        with open(os.path.join(d, "results.json")) as f:
            results[name] = json.load(f)
    check(results["dp2"] == results["one process"]
          and len(results["dp2"]) == TRAIN_IMAGES,
          f"torchrun eval: results.json of {len(results['dp2'])} captions "
          f"differs from the one-process run's "
          f"{len(results['one process'])}")
    numbers["captions"] = len(results["dp2"])
    print(f"parallel CLI under torch.distributed.run, two ranks on the card: "
          f"--mode train dp2 bf16 ({steps} steps of {PAR_BF16_BATCH}, "
          f"validation, checkpoint) {numbers['train_s']:.1f} s, train loss "
          f"{numbers['train_loss']}, val loss {numbers['val_loss']}; --mode "
          f"eval f32 of its checkpoint: one process "
          f"{numbers['eval one process s']:.1f} s, dp2 "
          f"{numbers['eval dp2 s']:.1f} s, results.json identical "
          f"({numbers['captions']} captions) [{smi}]", flush=True)
    return numbers


def legacy_one_process(torch, dev, smi, spec, tmp, kernels):
    """The legacy stack alone (the JAX legacy CLI's defaults: ResNet-50,
    224 pixels, a 14 x 14 grid, widths 512, the vocabulary of 10000;
    f32): forward and ``generate`` of 4 images on the card and on the CPU;
    two steps of batch 2 (dropout 0) on both; 20 steps of batch 16 on one
    batch, timed; ``validate`` on the 64 validation images;
    ``generate_captions`` on 4 JPEGs; the epoch checkpoints restored bit
    for bit; no kernel launched in any of it."""
    from PIL import Image

    from image_captioning_ml_project_tpu_torch.data.coco import (
        normalize_images)
    from image_captioning_ml_project_tpu_torch.legacy.demo import (
        generate_captions)
    from image_captioning_ml_project_tpu_torch.legacy.model import (
        ShowAttendTell)
    from image_captioning_ml_project_tpu_torch.legacy.train import (
        LegacyTrainer, load_legacy_checkpoints)
    from image_captioning_ml_project_tpu_torch.legacy.validate import validate

    vocab, train_ds, val_ds = _legacy_data(spec)
    sd = torch.load(spec["weights"]["legacy"], mmap=True, weights_only=True)
    numbers = {}
    _zero_launches(kernels)

    # forward and generate, card against CPU
    val = _fixed_batch(val_ds, LEGACY_IMAGES)
    caps = torch.from_numpy(val["caption_tokens"][:, 0]).long()
    outs = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        model = ShowAttendTell(len(vocab)).eval()
        model.load_state_dict(sd)
        model.to(device, memory_format=torch.channels_last)
        with torch.inference_mode():
            images = normalize_images(torch.from_numpy(val["image"]).to(
                device))
            out = model(images, caps.to(device))
            tokens, alphas = model.generate(images, LEGACY_MAX_LENGTH,
                                            start_token_id=vocab.bos_token_id)
        outs[name] = (out["predictions"].cpu(), out["alphas"].cpu(),
                      tokens.cpu(), alphas.cpu())
        del model
    (p, a, tk, ga), (p0, a0, tk0, ga0) = outs["card"], outs["cpu"]
    errs = {"predictions": float((p - p0).abs().max()),
            "alphas": float((a - a0).abs().max()),
            "generate_alphas": float((ga - ga0).abs().max())}
    check(torch.equal(tk, tk0), f"legacy generate: card tokens {tk.tolist()} "
                                f"CPU {tk0.tolist()}")
    check(max(errs.values()) <= 1e-4, f"legacy card against CPU: {errs}")
    numbers["card_vs_cpu"] = dict(errs, tokens_identical=True,
                                  images=LEGACY_IMAGES)
    print(f"legacy forward and generate, card against CPU ({LEGACY_IMAGES} "
          f"images, {LEGACY_MAX_LENGTH} tokens identical): {errs}",
          flush=True)

    # two steps of batch 2 (the first at lr 0), card against CPU
    batch = _fixed_batch(train_ds, 2)

    def make(device):
        t = LegacyTrainer(vocab, train_ds, val_ds, device=device,
                          dropout=0.0, state_dict=sd,
                          checkpoint_dir=os.path.join(tmp, "lg_ck"))
        t.optimizer.schedule = one_warmup_step(t.optimizer.schedule)
        return t

    def step(t):
        return {k: float(v) for k, v in t.train_step(
            batch["image"], batch["caption_tokens"]).items()}

    runs = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        t = make(device)
        before = param_start(_legacy_tree(t))
        steps = []
        record_steps(torch, t, steps, prefix="model.")
        lrs = [float(t.optimizer.schedule(i)) for i in range(2)]
        metrics = [step(t) for _ in range(2)]
        runs[name] = (metrics, _cpu_tree(_legacy_tree(t)), steps)
        del t.optimizer.step, t
    floor = _floor_run(torch, lambda: make("cpu"), step, _legacy_tree,
                       prefix="model.")
    worst = {}
    for i, (a, b) in enumerate(zip(runs["card"][0], runs["cpu"][0])):
        for key in ("ce", "att_reg"):
            rel = abs(a[key] - b[key]) / abs(b[key])
            worst[key] = max(worst.get(key, 0.0), rel)
            check(rel <= 1e-5, f"legacy step {i + 1} {key}: card {a[key]} "
                               f"CPU {b[key]}")
    held = hold_train_state(torch, runs["card"][1], runs["cpu"][1], before,
                            (runs["card"][2], runs["cpu"][2]), lrs, 0.0,
                            floor=floor)
    numbers["steps_card_vs_cpu"] = {"worst_rel": worst, "batch": 2}
    print(f"legacy two steps of batch 2, card against CPU: worst relative "
          f"{worst}; {held}", flush=True)
    del runs

    # twenty steps of batch 16 on one batch
    t = LegacyTrainer(vocab, train_ds, val_ds, device=dev, state_dict=sd,
                      batch_size=LEGACY_BATCH,
                      checkpoint_dir=os.path.join(tmp, "legacy_ckpt"))
    batch = _fixed_batch(train_ds, LEGACY_BATCH)
    images = torch.from_numpy(batch["image"]).to(dev)
    caps = torch.from_numpy(batch["caption_tokens"]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(LEGACY_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(t.train_step(images, caps)["ce"]))
        times.append(time.perf_counter() - t0)
    check(all(map(math.isfinite, losses)), f"legacy losses {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"legacy loss did not fall: {losses}")
    ms = statistics.median(times[5:]) * 1e3
    numbers["train"] = {
        "batch": LEGACY_BATCH, "steps": LEGACY_STEPS, "ms_per_step": ms,
        "images_per_s": LEGACY_BATCH / ms * 1e3, "loss_first5": first,
        "loss_last5": last, "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"legacy train batch {LEGACY_BATCH}: ce {first:.4f} -> "
          f"{last:.4f}, {ms:.2f} ms/step (median of the last 15), "
          f"{numbers['train']['images_per_s']:.1f} images/s, "
          f"max_memory_allocated "
          f"{numbers['train']['max_memory_allocated_gib']:.2f} GiB [{smi}]",
          flush=True)

    # validate on the 64 validation images
    t0 = time.perf_counter()
    val_metrics = validate(t.model, val_ds, vocab, batch_size=LEGACY_BATCH,
                           max_length=LEGACY_MAX_LENGTH)
    seconds = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in val_metrics.values())
          and val_metrics["loss"] > 0, f"legacy validate: {val_metrics}")
    numbers["validate"] = dict(val_metrics, seconds=seconds,
                               images=len(val_ds))
    print(f"legacy validate on {len(val_ds)} images: {val_metrics}, "
          f"{seconds:.1f} s", flush=True)

    # generate_captions on a directory of 4 JPEGs
    jpegs = os.path.join(tmp, "legacy_jpegs")
    os.makedirs(jpegs, exist_ok=True)
    for i in range(LEGACY_IMAGES):
        Image.fromarray(val["image"][i]).save(
            os.path.join(jpegs, f"{i}.jpg"), "JPEG", quality=95)
    t0 = time.perf_counter()
    captions = generate_captions(t.model, vocab, jpegs, image_size=224,
                                 max_length=LEGACY_MAX_LENGTH)
    check(len(captions) == LEGACY_IMAGES, f"captions {captions}")
    numbers["generate_captions"] = {"images": len(captions),
                                    "seconds": time.perf_counter() - t0}
    print(f"legacy generate_captions: {captions}", flush=True)

    # the epoch checkpoints, restored bit for bit
    t._save(0)
    t._save(0, mid=True)
    for suffix in ("", "_mid"):
        fresh = ShowAttendTell(len(vocab))
        load_legacy_checkpoints(fresh, t.ckpt.directory,
                                f"encoder_epoch_0{suffix}",
                                f"decoder_epoch_0{suffix}")
        want = t.model.state_dict()
        for name, v in fresh.state_dict().items():
            check(torch.equal(v, want[name].cpu()),
                  f"legacy checkpoint{suffix}: {name} differs")
    print("legacy: encoder_epoch_0 and decoder_epoch_0 (and _mid) "
          "restored bit-identical", flush=True)
    launched = _launches(kernels)
    check(not any(launched.values()),
          f"the legacy stack launched kernels: {launched}")
    numbers["launches"] = launched
    del t
    torch.cuda.empty_cache()
    return numbers


def parallel_phase(torch, dev, smi, fixture, tree, tmp):
    """Phase 10 (module docstring). Returns the summary line's numbers and
    each kernel's per-rank launches."""
    from image_captioning_ml_project_tpu_torch.config import (
        EncoderConfig, config_to_dict)
    from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab
    from image_captioning_ml_project_tpu_torch.main import lstm_config
    from image_captioning_ml_project_tpu_torch.params import (
        from_flax, init_flax_params, init_legacy_flax_params,
        legacy_from_flax)
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    kernels = counters()
    seed = fixture["seed"]
    base = copy.deepcopy(fixture["config"])
    t0 = time.perf_counter()
    weights = {"flagship": os.path.join(tmp, "flagship.pt"),
               "lstm": os.path.join(tmp, "lstm.pt"),
               "legacy": os.path.join(tmp, "legacy.pt")}
    torch.save(from_flax(tree), weights["flagship"])
    lstm = lstm_config()
    torch.save(from_flax(init_flax_params(lstm, seed)), weights["lstm"])
    vocab_path = os.path.join(tmp, "vocab.json")
    fixture["tokenizer"].save(vocab_path)
    # the legacy vocabulary: the fixture's words, filler words to 10000
    words = WordVocab.build([ex["caption"] for ex in fixture[
        "train_ds"].examples], threshold=1).word2idx
    words.update({f"w{i}": i for i in range(len(words), LEGACY_VOCAB)})
    legacy_vocab = os.path.join(tmp, "legacy_vocab.json")
    WordVocab(words).save(legacy_vocab)
    torch.save(legacy_from_flax(init_legacy_flax_params(
        LEGACY_VOCAB, EncoderConfig(), seed)), weights["legacy"])
    print(f"phase 10 weights (flagship, ResNet-101 + LSTM, legacy) drawn "
          f"from seed {seed} and saved: {time.perf_counter() - t0:.1f} s",
          flush=True)
    spec = {"store": os.path.join(tmp, "parallel_store"),
            "out": os.path.join(tmp, "parallel_out.json"),
            "tmp": tmp, "config": config_to_dict(base), "vocab": vocab_path,
            "legacy_vocab": legacy_vocab, "weights": weights,
            "tp_checkpoint": os.path.join(tmp, "tp_checkpoint")}
    t0 = time.perf_counter()
    ranks = run_parallel_ranks(torch, spec, tmp)
    ranks_s = time.perf_counter() - t0
    zero = ranks[0]
    numbers = {"ranks_s": ranks_s, "ranks": PAR_RANKS,
               "card_shared_by_ranks": True}
    for key, value in zero.items():
        if key.startswith("bf16"):
            numbers[key] = [{k: v for k, v in r[key].items()
                             if k != "digests"} for r in ranks]
            for r in numbers[key]:
                print(f"parallel {key} rank {r['rank']}: {r['rows']} rows, "
                      f"{r['ms_per_step']:.1f} ms/step (median of 5), "
                      f"{r['images_per_s']:.1f} images/s of the global "
                      f"batch, max_memory_allocated "
                      f"{r['max_memory_allocated_gib']:.2f} GiB [{smi}; "
                      f"both ranks on one card]", flush=True)
        else:
            numbers[key] = value
    val = [r["f32 flagship dp2 tp1"]["validation"] for r in ranks]
    numbers["f32 flagship dp2 tp1"]["validation_per_rank"] = [
        {k: v[k] for k in ("launches", "decode_steps", "rows_per_rank",
                           "seconds")} for v in val]
    print(f"parallel validation dp2: {numbers['f32 flagship dp2 tp1']}",
          flush=True)

    # the tp2 checkpoint, restored in one process
    c = _train_config(base, os.path.join(tmp, "tp_restore"), True,
                      PAR_BF16_BATCH, 1e-4, 2, 0.1)
    c.checkpoint_dir = spec["tp_checkpoint"]
    one = CaptioningTrainer(c, fixture["train_ds"], fixture["val_ds"],
                            fixture["tokenizer"], device=dev,
                            state_dict=torch.load(weights["flagship"],
                                                  mmap=True,
                                                  weights_only=True))
    one.load_checkpoint("checkpoint_epoch_1")
    got = _digests(torch, one._state_tree())
    want = zero["bf16 flagship dp1 tp2"]["digests"]
    check(got == want, f"the tp2 checkpoint restored in one process "
                       f"differs in {sorted(k for k in want if got.get(k) != want[k])[:5]}")
    numbers["tp2_checkpoint"] = {"tensors": len(want), "bit_identical": True}
    print(f"parallel: the tp2 checkpoint restored in one process, "
          f"{len(want)} tensors bit-identical to the ranks' gathered state",
          flush=True)
    del one
    torch.cuda.empty_cache()

    numbers["cli"] = torchrun_cli(torch, smi, base, vocab_path, tmp)

    t0 = time.perf_counter()
    numbers["legacy"] = legacy_one_process(torch, dev, smi, spec, tmp,
                                           kernels)
    print(f"legacy one process: {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {}
    for name in kernels:
        per = {}
        for r, out in enumerate(ranks):
            v = out["f32 flagship dp2 tp1"]["validation"]["launches"][name]
            per[f"rank {r} validation dp2"] = v
            for key in ("bf16 flagship dp2 tp1", "bf16 flagship dp1 tp2"):
                per[f"rank {r} {key} steps"] = out[key]["launches"][name]
        per["legacy"] = numbers["legacy"]["launches"][name]
        launches[name] = per
    return numbers, launches


# ---------------------------------------------------------------------------
# serving and the demo under the mesh (phase 11)
# ---------------------------------------------------------------------------

SERVE_IMAGES = 64          # images of the f32 parity runs and of a round
SERVE_BATCH = 64
SERVE_BUCKETS = [1, 8, 64]
SERVE_ROUNDS = 3           # timed bf16 rounds, after one warm-up round
SERVE_SINGLES = 3          # single requests on the smallest bucket
SERVE_MAX_WAIT_MS = 20.0   # the bf16 services' batcher wait
SERVE_CLI_REQUESTS = 16
SERVE_RANK_TIMEOUT = 600   # seconds phase 11's ranks may take together
SERVE_MESHES = ((2, 1), (1, 2))


def check_tp_attention(torch, dev, smi):
    """#1 at the flagship's tp2 shapes, where each model rank runs 6 of the
    12 heads (H = 384, head width 64): 64 images x 5 beams behind the
    10-row prefix, pos 0, 7 and 19, f32 (within 1e-5) and bf16 (within 2
    ulps) against its plain version, the caches bit-identical; then timed
    in bf16 at pos 19 with its inputs flushed from L2, beside its bound
    and the plain version's time. Returns the summary's numbers."""
    from image_captioning_ml_project_tpu_torch.ops.beam_decode_attention import (
        beam_decode_attention, beam_decode_attention_plain)

    B, K, S, H, NH, P = 64, 5, 20, 384, 6, 10
    Bk = B * K
    args = dict(num_heads=NH, beam_size=K, scale=1.0 / (H // NH) ** 0.5)
    g = torch.Generator(device=dev).manual_seed(4321)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        for pos in (0, 7, 19):
            q, kn, vn = randn(Bk, H), randn(Bk, H), randn(Bk, H)
            kc, vc = randn(Bk, S, H), randn(Bk, S, H)
            pk, pv = randn(B, P, H), randn(B, P, H)
            anc = torch.randint(0, K, (Bk, S), generator=g, device=dev,
                                dtype=torch.int32)
            kc2, vc2 = kc.clone(), vc.clone()
            got, _, _ = beam_decode_attention(q, kn, vn, kc, vc, pk, pv, anc,
                                              pos, **args)
            want, _, _ = beam_decode_attention_plain(q, kn, vn, kc2, vc2, pk,
                                                     pv, anc, pos, **args)
            torch.cuda.synchronize()
            what = f"tp2 attention {str(dtype)[6:]} H={H} NH={NH} pos={pos}"
            err = check_close(what, got, want, str(dtype)[6:], 1e-5, 2)
            check(torch.equal(kc, kc2) and torch.equal(vc, vc2),
                  f"{what}: caches differ")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    pos = 19
    nbytes, ops = attention_work(torch, anc, pos, B, K, H, P, 2)
    bnd = bound(nbytes + 4 * Bk * H * 2, {"f32": ops})
    ms, dev_ms = time_ms(torch, lambda: beam_decode_attention(
        q, kn, vn, kc, vc, pk, pv, anc, pos, **args), flush=flush,
        device=True)
    plain_ms = time_ms(torch, lambda: beam_decode_attention_plain(
        q, kn, vn, kc, vc, pk, pv, anc, pos, **args), flush=flush)
    shape = f"B={B} K={K} S={S} H={H} NH={NH} P={P} pos={pos} bf16"
    print(f"tp2 attention {shape}: device {dev_ms:.4f} ms, event {ms:.4f} "
          f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), plain "
          f"{plain_ms:.4f} ms [{smi}]", flush=True)
    return shape_entry(shape, worst, ms, plain_ms, bnd, None, dev_ms)


def _mesh_service_run(torch, dev, cfg, tokenizer, images, mesh, kernels,
                      timing):
    """One rank's service on ``mesh`` over phase 7's ``best_model``: the
    counters set to 0 just before the service is built; rank 0 warms up
    every bucket and drives it (f32: ``_run_images`` of 64, 8 and 1
    images, token rows recorded, then 64 concurrent requests; bf16
    (``timing``): a warm-up round of 64 concurrent requests, three timed
    rounds and three single requests), the others follow. Every rank
    counts its batches and times each decode; the launches are read
    after the service stops. Returns the rank's numbers."""
    from image_captioning_ml_project_tpu_torch.inference.server import (
        CaptionService)

    rec = _RecordingTokenizer(tokenizer)
    _zero_launches(kernels)
    service = CaptionService(cfg, rec, dev, checkpoint_path="best_model",
                             batch_size=SERVE_BATCH,
                             bucket_sizes=SERVE_BUCKETS,
                             max_wait_ms=SERVE_MAX_WAIT_MS,
                             request_timeout_s=300.0, mesh=mesh)
    decode_ms = []
    decode, rank_batch = service._decode, service._rank_batch

    def timed_decode(x):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tokens = decode(x)
        torch.cuda.synchronize(dev)
        decode_ms.append((len(x), (time.perf_counter() - t0) * 1e3))
        return tokens

    service._decode = timed_decode
    batches = [0]

    def counted(batch):
        batches[0] += 1
        return rank_batch(batch)

    service._rank_batch = counted
    out = {"rank": mesh.rank, "buckets": service.bucket_sizes}
    if service.is_front:
        service.start(warmup=True)
        try:
            if not timing:
                rows, captions = {}, {}
                for n in (SERVE_IMAGES, 8, 1):
                    rec.rows.clear()
                    captions[n] = service._run_images(list(images[:n]))
                    rows[n] = list(rec.rows)
                reqs = [service.submit_async(img) for img in images]
                out.update(rows=rows, run_captions=captions[SERVE_IMAGES],
                           captions=[service.result(r) for r in reqs])
            else:
                for r in [service.submit_async(img) for img in images]:
                    service.result(r)
                out["timed_batches"] = [batches[0]]
                round_s = []
                for _ in range(SERVE_ROUNDS):
                    t0 = time.perf_counter()
                    for r in [service.submit_async(img) for img in images]:
                        service.result(r)
                    round_s.append(time.perf_counter() - t0)
                out["timed_batches"].append(batches[0])
                single_s = []
                for img in images[:SERVE_SINGLES]:
                    t0 = time.perf_counter()
                    service.submit(img)
                    single_s.append(time.perf_counter() - t0)
                out.update(round_s=round_s, single_s=single_s,
                           max_wait_ms=SERVE_MAX_WAIT_MS,
                           smallest_bucket=service.bucket_sizes[0])
        finally:
            service.stop()
    else:
        service.follow()
    torch.cuda.synchronize(dev)
    out.update(launches=_launches(kernels),
               steps=service.stats.decode_steps, batches=batches[0],
               decode_ms=decode_ms,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated(
                   dev) / 2 ** 30)
    del service, rec
    torch.cuda.empty_cache()
    return out


def _expect_mesh_launches(out, key, layers):
    """Each rank's counters over its service's run: #5 once a batch and
    #4 once a decode step; at dp2 #3 once a step, at tp2 #1 once a layer a
    step on the rank's heads; nothing else."""
    steps, batches = out["steps"], out["batches"]
    want = {"encoder_stack": batches, "lse_and_block_max": steps}
    if "tp2" in key:
        want["beam_decode_attention"] = layers * steps
    else:
        want["beam_decode_stack"] = steps
    check(steps > 0 and batches > 0,
          f"serving {key} rank {out['rank']}: {batches} batches, {steps} "
          f"steps")
    for name, got in out["launches"].items():
        check(got == want.get(name, 0),
              f"serving {key} rank {out['rank']}: {name} launched {got} "
              f"times, expected {want.get(name, 0)} ({batches} batches, "
              f"{steps} decode steps)")


def serving_rank(torch, dev, spec, kernels):
    """Phase 11's body on one rank (:func:`parallel_rank`): the f32
    services at dp2 and tp2, then the bf16 ones, each on a mesh of its
    own, with the launch checks."""
    import numpy as np

    from image_captioning_ml_project_tpu_torch.config import (
        MeshConfig, config_from_dict)
    from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab
    from image_captioning_ml_project_tpu_torch.parallel.mesh import (
        create_mesh)

    tokenizer = WordVocab.load(spec["vocab"])
    images = np.load(spec["images"])
    out = {}
    for dtype, name in (("float32", "f32"), ("bfloat16", "bf16")):
        for dp, mp in SERVE_MESHES:
            cfg = config_from_dict(spec["config"])
            cfg.model.dtype = dtype
            mesh = create_mesh(MeshConfig(data_parallel=dp,
                                          model_parallel=mp))
            key = f"{name} dp{dp}" if mp == 1 else f"{name} tp{mp}"
            t0 = time.perf_counter()
            out[key] = _mesh_service_run(torch, dev, cfg, tokenizer, images,
                                         mesh, kernels, name == "bf16")
            out[key]["seconds"] = time.perf_counter() - t0
            _expect_mesh_launches(out[key], key,
                                  cfg.model.decoder.num_layers)
            print(f"parallel serving {key} rank {mesh.rank}: "
                  f"{out[key]['batches']} batches, {out[key]['steps']} "
                  f"decode steps, launches {out[key]['launches']}, "
                  f"{out[key]['seconds']:.1f} s", flush=True)
    return out


def _flip(torch, dev, cfg, images, i, want, got):
    """The first step where the token rows ``want`` (one process) and
    ``got`` (the ranks) of image ``i`` part, and the one-process model's
    top-2 log-probability gap there given ``want``'s prefix."""
    from image_captioning_ml_project_tpu_torch.models.captioning_model import (
        load_model)
    from image_captioning_ml_project_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    t = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
    model = load_model(cfg, dev, state_dict=CheckpointManager(
        cfg.checkpoint_dir).model_weights("best_model"))
    with torch.inference_mode():
        x = torch.from_numpy(images[i:i + 1]).to(dev)
        prefix = torch.tensor([want[:t]], device=dev)
        logp = torch.log_softmax(model(x, prefix)["logits"][0, -1].float(),
                                 -1)
        top = torch.topk(logp, 2).values
    return t, float(top[0] - top[1])


def _post(url, data, timeout=300):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _png_bytes(image):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def _serve_cli(smi, cfg_path, vocab_path, ckpt, pngs, want, tmp, name,
               reload):
    """``--mode serve`` under ``python -m torch.distributed.run
    --nproc_per_node 2`` with the config at ``cfg_path`` (its mesh
    ``name``): ``/healthz`` answers with the mesh and the buckets rounded
    to its data axis; the ``pngs`` posted concurrently, half of them
    with ``reload`` while a ``POST /reload`` of ``ckpt`` runs, get the
    captions ``want`` and every one is answered; ``/stats`` counts them;
    SIGTERM to the launcher ends it within 90 s with both ranks logging a
    clean end and none killed. Returns the numbers."""
    import signal

    dp = 2 if name == "dp2" else 1
    port = _free_port()
    log = os.path.join(tmp, f"serving_cli_{name}.log")
    cmd, env = _cli_command(
        ["--mode", "serve", "--config", cfg_path, "--vocab", vocab_path,
         "--device", "cuda", "--output_dir",
         os.path.join(tmp, f"cli_serve_{name}"), "--checkpoint", ckpt,
         "--port", str(port), "--serve_batch_size", str(SERVE_BATCH),
         "--serve_buckets", ",".join(str(b) for b in SERVE_BUCKETS)],
        ranks=PAR_RANKS)
    url = f"http://127.0.0.1:{port}"
    numbers = {}
    t0 = time.perf_counter()
    with open(log, "w+") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=ROOT, env=env, start_new_session=True)
        try:
            while True:
                try:
                    with urllib.request.urlopen(f"{url}/healthz",
                                                timeout=5) as r:
                        health = json.loads(r.read())
                    break
                except OSError:
                    pass
                check(proc.poll() is None,
                      f"serve {name} under torch.distributed.run exited "
                      f"{proc.returncode} before /healthz answered")
                check(time.perf_counter() - t0 < 300,
                      f"serve {name}: /healthz did not answer in 300 s")
                time.sleep(0.5)
            numbers["up_s"] = time.perf_counter() - t0
            buckets = sorted({-(-b // dp) * dp for b in SERVE_BUCKETS})
            check(health.get("mesh") == {"data": dp, "model": 2 // dp}
                  and health.get("bucket_sizes") == buckets,
                  f"serve {name} /healthz: {health}")

            def burst(lo, n, got, when=None):
                def client(i):
                    got[i] = _post(f"{url}/caption", pngs[lo + i])["caption"]
                    if when is not None:
                        when[i] = time.perf_counter()

                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(n)]
                for th in threads:
                    th.start()
                return threads

            half = len(pngs) // 2 if reload else len(pngs)
            got = [None] * half
            for th in burst(0, half, got):
                th.join(timeout=300)
            check(got == want[:half],
                  f"serve {name}: {sum(a != b for a, b in zip(got, want))} "
                  f"of {half} captions differ from the one-process service's")
            if reload:
                under, when = [None] * half, [None] * half
                threads = burst(half, half, under, when)
                t1 = time.perf_counter()
                answer = _post(f"{url}/reload",
                               json.dumps({"checkpoint": ckpt}).encode())
                t2 = time.perf_counter()
                numbers["reload_s"] = t2 - t1
                for th in threads:
                    th.join(timeout=300)
                # the ranks read the checkpoint beside the batches: the
                # requests need not wait for the swap
                numbers["answered_before_reload"] = sum(
                    w is not None and w < t2 for w in when)
                check(answer.get("reloaded") == ckpt,
                      f"serve {name} /reload: {answer}")
                check(under == want[half:2 * half],
                      f"serve {name}: the requests across the reload were "
                      f"not all answered with the checkpoint's captions")
            with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
                stats = json.loads(r.read())
            check(stats["completed"] >= len(pngs) and stats["errors"] == 0,
                  f"serve {name} /stats: {stats}")
            numbers["stats"] = stats
            t1 = time.perf_counter()
            os.kill(proc.pid, signal.SIGTERM)
            try:
                rc = proc.wait(timeout=90)
            except subprocess.TimeoutExpired:
                rc = "still running 90 s after SIGTERM"
            numbers["sigterm_to_exit_s"] = time.perf_counter() - t1
            numbers["launcher_rc"] = rc
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        f.seek(0)
        text = f.read()
    clean = [f"rank {r} of {PAR_RANKS}: --mode serve ended cleanly" in text
             for r in range(PAR_RANKS)]
    if not all(clean) or not isinstance(rc, int):
        print(text[-8000:], flush=True)
    check(isinstance(rc, int), f"serve {name}: the launcher {rc}")
    check(all(clean), f"serve {name}: after SIGTERM the ranks' clean ends "
                      f"{clean}")
    check("SIGKILL" not in text,
          f"serve {name}: the launcher had to SIGKILL a rank")
    print(f"serving CLI {name} under torch.distributed.run, f32, two ranks "
          f"on the card: up in {numbers['up_s']:.1f} s, {len(pngs)} PNG "
          f"requests = the one-process captions"
          + (f", /reload under {half} requests in flight answered in "
             f"{numbers['reload_s']:.1f} s ({numbers['answered_before_reload']}"
             f" of them answered before it)" if reload else "")
          + f", /stats completed {stats['completed']}, SIGTERM to the "
          f"launcher: ended in {numbers['sigterm_to_exit_s']:.1f} s "
          f"(launcher rc {rc}), both ranks ended cleanly [{smi}]",
          flush=True)
    return numbers


def serving_cli(torch, dev, smi, base, tokenizer, vocab_path, images, want,
                tmp):
    """The CLI under ``python -m torch.distributed.run --nproc_per_node
    2``, f32 on phase 7's ``best_model`` (:func:`_serve_cli`): ``--mode
    serve`` at dp2 with 16 concurrent PNG requests, then 16 more across a
    ``POST /reload``, and at tp2 with 4; then ``--mode demo`` at dp2 and
    tp2 against ``main.demo`` in this process, the same caption logged by
    rank 0 only. Returns the numbers."""
    import contextlib
    import io

    from image_captioning_ml_project_tpu_torch import main as port_main
    from image_captioning_ml_project_tpu_torch.config import save_config

    ckpt = os.path.join(base.checkpoint_dir, "best_model")
    pngs = [_png_bytes(img) for img in images[:2 * SERVE_CLI_REQUESTS]]
    numbers = {"card": smi, "ranks_share_the_card": True}
    paths = {}
    for name, (dp, mp) in zip(("dp2", "tp2"), SERVE_MESHES):
        c = copy.deepcopy(base)
        c.model.dtype = "float32"
        c.mesh.data_parallel, c.mesh.model_parallel = dp, mp
        paths[name] = os.path.join(tmp, f"serving_cli_{name}.json")
        save_config(c, paths[name])
    numbers["serve dp2"] = _serve_cli(smi, paths["dp2"], vocab_path, ckpt,
                                      pngs, want, tmp, "dp2", reload=True)
    numbers["serve tp2"] = _serve_cli(smi, paths["tp2"], vocab_path, ckpt,
                                      pngs[:4], want, tmp, "tp2",
                                      reload=False)

    png = os.path.join(tmp, "demo.png")
    with open(png, "wb") as f:
        f.write(pngs[0])
    c32 = copy.deepcopy(base)
    c32.model.dtype = "float32"
    c32.output_dir = os.path.join(tmp, "demo_one")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        one = port_main.demo(c32, ckpt, png, tokenizer=tokenizer,
                             device=dev)
    numbers["demo one process s"] = time.perf_counter() - t0
    # the two launches side by side: four ranks on the card
    logs = {name: os.path.join(tmp, f"cli_demo_{name}.log")
            for name in paths}
    seconds = _run_clis([(
        ["--mode", "demo", "--config", paths[name], "--vocab", vocab_path,
         "--device", "cuda", "--output_dir",
         os.path.join(tmp, f"cli_demo_{name}"), "--checkpoint", ckpt,
         "--image_path", png], logs[name], PAR_RANKS) for name in paths],
        300)
    for name, t in zip(paths, seconds):
        numbers[f"demo {name} s"] = t
        with open(logs[name]) as f:
            logged = re.findall(r"Generated caption: (.*)", f.read())
        check(logged == [one], f"demo {name} under torch.distributed.run "
                               f"logged {logged}, one process {one!r}")
    numbers["demo_caption"] = one
    print(f"demo under torch.distributed.run, f32, dp2 and tp2 side by "
          f"side: done after {numbers['demo dp2 s']:.1f} and "
          f"{numbers['demo tp2 s']:.1f} s, each logged once (rank 0) and "
          f"equal to main.demo in one process ({one!r}, "
          f"{numbers['demo one process s']:.1f} s) [{smi}]", flush=True)
    return numbers


def serving_mesh_phase(torch, dev, smi, fixture, tmp):
    """Phase 11 (module docstring). Returns the summary line's numbers and
    each kernel's per-rank launches."""
    import numpy as np

    from image_captioning_ml_project_tpu_torch.config import config_to_dict
    from image_captioning_ml_project_tpu_torch.inference.server import (
        CaptionService)

    t_phase = time.perf_counter()
    base = copy.deepcopy(fixture["config"])
    c32 = copy.deepcopy(base)
    c32.model.dtype = "float32"
    tokenizer = fixture["tokenizer"]
    vocab_path = os.path.join(tmp, "serving_vocab.json")
    tokenizer.save(vocab_path)
    g = torch.Generator().manual_seed(fixture["seed"] + 11)
    images = torch.randint(0, 256, (SERVE_IMAGES, c32.image_size,
                                    c32.image_size, 3), generator=g,
                           dtype=torch.uint8).numpy()
    images_path = os.path.join(tmp, "serving_images.npy")
    np.save(images_path, images)
    numbers = {"card": smi, "ranks": PAR_RANKS, "card_shared_by_ranks": True,
               "tp2_attention": check_tp_attention(torch, dev, smi)}

    # the one-process f32 service: the captions every mesh must give
    t0 = time.perf_counter()
    rec = _RecordingTokenizer(tokenizer)
    one = CaptionService(c32, rec, dev, checkpoint_path="best_model",
                         batch_size=SERVE_BATCH, bucket_sizes=SERVE_BUCKETS,
                         request_timeout_s=300.0)
    ref_rows, ref = {}, {}
    for n in (SERVE_IMAGES, 8, 1):
        rec.rows.clear()
        ref[n] = one._run_images(list(images[:n]))
        ref_rows[n] = list(rec.rows)
    del one, rec
    torch.cuda.empty_cache()
    numbers["one_process_s"] = time.perf_counter() - t0

    spec = {"phase": "serving_mesh", "timeout": SERVE_RANK_TIMEOUT,
            "store": os.path.join(tmp, "serving_store"),
            "out": os.path.join(tmp, "serving_out.json"), "tmp": tmp,
            "config": config_to_dict(c32), "vocab": vocab_path,
            "images": images_path}
    t0 = time.perf_counter()
    ranks = run_parallel_ranks(torch, spec, tmp)
    numbers["ranks_s"] = time.perf_counter() - t0
    for key in ("f32 dp2", "f32 tp2"):
        zero = ranks[0][key]
        for n in (SERVE_IMAGES, 8, 1):
            got = zero["rows"][str(n)]
            for i, (a, b) in enumerate(zip(ref_rows[n], got)):
                if a != b:
                    t, gap = _flip(torch, dev, c32, images, i, a, b)
                    print(f"serving {key}: image {i} of the run of {n} "
                          f"parts from the one-process decode at step {t}: "
                          f"{b} against {a}; the one-process top-2 "
                          f"log-probability gap there {gap:.3e}", flush=True)
            check(got == ref_rows[n], f"serving {key}: the token rows of "
                                      f"_run_images({n}) differ from one "
                                      f"process's")
        check(zero["captions"] == ref[SERVE_IMAGES]
              and zero["run_captions"] == ref[SERVE_IMAGES],
              f"serving {key}: the captions of the concurrent requests "
              f"differ from the one-process service's")
        numbers[key] = {
            "buckets": zero["buckets"], "identical_rows": True,
            "per_rank": [{k: r[key][k] for k in (
                "batches", "steps", "launches", "seconds",
                "max_memory_allocated_gib")} for r in ranks]}
        print(f"serving {key}: _run_images of {SERVE_IMAGES}, 8 and 1 "
              f"images (buckets {zero['buckets']}) token-identical to the "
              f"one-process f32 service, {SERVE_IMAGES} concurrent "
              f"requests caption-identical; per rank "
              f"{numbers[key]['per_rank']} [{smi}]", flush=True)
    for key in ("bf16 dp2", "bf16 tp2"):
        lo, hi = ranks[0][key]["timed_batches"]
        per = []
        for r in ranks:
            run = r[key]
            ms = [t for _, t in run["decode_ms"][lo:hi]]
            per.append({"rank": run["rank"], "timed_batches": hi - lo,
                        "rows_per_batch": sorted({n for n, _ in
                                                  run["decode_ms"][lo:hi]}),
                        "median_decode_ms": statistics.median(ms),
                        "decode_ms": ms, "batches": run["batches"],
                        "steps": run["steps"], "launches": run["launches"],
                        "max_memory_allocated_gib":
                            run["max_memory_allocated_gib"]})
        zero = ranks[0][key]
        numbers[key] = {"round_s": zero["round_s"],
                        "median_round_s": statistics.median(zero["round_s"]),
                        "single_s": zero["single_s"],
                        "smallest_bucket": zero["smallest_bucket"],
                        "max_wait_ms": zero["max_wait_ms"], "per_rank": per}
        print(f"serving {key}: rounds of {SERVE_IMAGES} concurrent requests "
              f"{[round(t, 4) for t in zero['round_s']]} s (median "
              f"{numbers[key]['median_round_s']:.4f} s = "
              f"{SERVE_IMAGES / numbers[key]['median_round_s']:.1f} "
              f"images/s); single requests on bucket "
              f"{zero['smallest_bucket']} "
              f"{[round(t, 4) for t in zero['single_s']]} s (max_wait_ms "
              f"{zero['max_wait_ms']}); median decode per rank "
              f"{[round(p['median_decode_ms'], 2) for p in per]} ms of "
              f"{per[0]['rows_per_batch']} rows [{smi}; both ranks on one "
              f"card]", flush=True)
    numbers["cli"] = serving_cli(torch, dev, smi, base, tokenizer,
                                 vocab_path, images, ref[SERVE_IMAGES], tmp)
    numbers["seconds"] = time.perf_counter() - t_phase
    launches = {}
    for name in counters():
        launches[name] = {f"rank {r[key]['rank']} {key}":
                          r[key]["launches"][name]
                          for r in ranks for key in ("f32 dp2", "f32 tp2",
                                                     "bf16 dp2", "bf16 tp2")}
    return numbers, launches


# ---------------------------------------------------------------------------
# HF layouts (phase 12)
# ---------------------------------------------------------------------------

HF_DECODE_BATCH = 64
HF_F32_IMAGES = 2


def hf_layout(name, cfg):
    """The HF state dict of ``name`` (``clip``: ``CLIPVisionModel``;
    ``gpt2``: ``GPT2LMHeadModel``; ``vit``: ``ViTModel``; ``swin``:
    ``SwinModel``; ``resnet``: ``ResNetModel`` of bottleneck layers) at the
    widths of ``cfg``'s encoder or decoder, as ``{key: (shape, kind)}``:
    HF's names and shapes, with the buffers older checkpoints carry, CLIP's
    ``position_ids`` and one legacy causal ``attn.bias`` a GPT-2 block. At
    ``main.flagship_config``'s, ``transformer_config``'s (with Swin) and
    ``lstm_config``'s widths these are the published CLIP ViT-B/32, GPT-2
    124M, ViT-B/16, Swin-B and ResNet-101. ``kind`` says how
    :func:`draw_hf_state` fills an entry: ``w`` N(0, 0.02²), ``ln`` 1 +
    N(0, 0.02²), ``conv`` N(0, 1/fan_in), ``var`` U(0.5, 1.5), ``tied``
    wte's tensor, the rest integer or boolean buffers."""
    e, d = cfg.model.encoder, cfg.model.decoder
    out = {}

    def linear(prefix, n_out, n_in, bias=True):
        out[f"{prefix}.weight"] = ((n_out, n_in), "w")
        if bias:
            out[f"{prefix}.bias"] = ((n_out,), "w")

    def conv1d(prefix, n_in, n_out):  # GPT-2's Conv1D: [in, out]
        out[f"{prefix}.weight"] = ((n_in, n_out), "w")
        out[f"{prefix}.bias"] = ((n_out,), "w")

    def norm(prefix, n):
        out[f"{prefix}.weight"] = ((n,), "ln")
        out[f"{prefix}.bias"] = ((n,), "w")

    def patch(prefix, n_out, p):
        out[f"{prefix}.weight"] = ((n_out, 3, p, p), "w")
        out[f"{prefix}.bias"] = ((n_out,), "w")

    if name == "clip":
        H, P, F = e.hidden_size, e.patch_size, e.hidden_size * e.mlp_ratio
        S = (cfg.image_size // P) ** 2 + 1
        v = "vision_model"
        out[f"{v}.embeddings.class_embedding"] = ((H,), "w")
        out[f"{v}.embeddings.patch_embedding.weight"] = ((H, 3, P, P), "w")
        out[f"{v}.embeddings.position_embedding.weight"] = ((S, H), "w")
        out[f"{v}.embeddings.position_ids"] = ((1, S), "ids")
        norm(f"{v}.pre_layrnorm", H)
        for i in range(e.num_layers):
            a = f"{v}.encoder.layers.{i}"
            for p in ("k", "v", "q", "out"):
                linear(f"{a}.self_attn.{p}_proj", H, H)
            norm(f"{a}.layer_norm1", H)
            linear(f"{a}.mlp.fc1", F, H)
            linear(f"{a}.mlp.fc2", H, F)
            norm(f"{a}.layer_norm2", H)
        norm(f"{v}.post_layernorm", H)
    elif name == "gpt2":
        H, N = d.hidden_dim, d.gpt2_n_positions
        out["transformer.wte.weight"] = ((cfg.model.vocab_size, H), "w")
        out["transformer.wpe.weight"] = ((N, H), "w")
        for i in range(d.num_layers):
            h = f"transformer.h.{i}"
            norm(f"{h}.ln_1", H)
            out[f"{h}.attn.bias"] = ((1, 1, N, N), "causal")
            conv1d(f"{h}.attn.c_attn", H, 3 * H)
            conv1d(f"{h}.attn.c_proj", H, H)
            norm(f"{h}.ln_2", H)
            conv1d(f"{h}.mlp.c_fc", H, 4 * H)
            conv1d(f"{h}.mlp.c_proj", 4 * H, H)
        norm("transformer.ln_f", H)
        out["lm_head.weight"] = ((cfg.model.vocab_size, H), "tied")
    elif name == "vit":
        H, P, F = e.hidden_size, e.patch_size, e.hidden_size * e.mlp_ratio
        S = (cfg.image_size // P) ** 2 + 1
        out["embeddings.cls_token"] = ((1, 1, H), "w")
        out["embeddings.position_embeddings"] = ((1, S, H), "w")
        patch("embeddings.patch_embeddings.projection", H, P)
        for i in range(e.num_layers):
            a = f"encoder.layer.{i}"
            for p in ("query", "key", "value"):
                linear(f"{a}.attention.attention.{p}", H, H)
            linear(f"{a}.attention.output.dense", H, H)
            linear(f"{a}.intermediate.dense", F, H)
            linear(f"{a}.output.dense", H, F)
            norm(f"{a}.layernorm_before", H)
            norm(f"{a}.layernorm_after", H)
        norm("layernorm", H)
        linear("pooler.dense", H, H)
    elif name == "swin":
        W, dim, last = e.swin_window_size, e.swin_embed_dim, \
            len(e.swin_depths) - 1
        patch("embeddings.patch_embeddings.projection", dim, 4)
        norm("embeddings.norm", dim)
        for s, (depth, heads) in enumerate(zip(e.swin_depths,
                                                e.swin_num_heads)):
            for b in range(depth):
                a = f"encoder.layers.{s}.blocks.{b}"
                norm(f"{a}.layernorm_before", dim)
                out[f"{a}.attention.self.relative_position_bias_table"] = (
                    ((2 * W - 1) ** 2, heads), "w")
                out[f"{a}.attention.self.relative_position_index"] = (
                    (W * W, W * W), "index")
                for p in ("query", "key", "value"):
                    linear(f"{a}.attention.self.{p}", dim, dim)
                linear(f"{a}.attention.output.dense", dim, dim)
                norm(f"{a}.layernorm_after", dim)
                linear(f"{a}.intermediate.dense", e.mlp_ratio * dim, dim)
                linear(f"{a}.output.dense", dim, e.mlp_ratio * dim)
            if s < last:
                m = f"encoder.layers.{s}.downsample"
                linear(f"{m}.reduction", 2 * dim, 4 * dim, bias=False)
                norm(f"{m}.norm", 4 * dim)
                dim *= 2
        norm("layernorm", dim)
    elif name == "resnet":
        def conv_layer(prefix, n_out, n_in, k):
            out[f"{prefix}.convolution.weight"] = ((n_out, n_in, k, k),
                                                   "conv")
            bn = f"{prefix}.normalization"
            norm(bn, n_out)
            out[f"{bn}.running_mean"] = ((n_out,), "w")
            out[f"{bn}.running_var"] = ((n_out,), "var")
            out[f"{bn}.num_batches_tracked"] = ((), "count")

        n_in = e.resnet_embedding_size
        conv_layer("embedder.embedder", n_in, 3, 7)
        for s, (size, depth) in enumerate(zip(e.resnet_hidden_sizes,
                                              e.resnet_depths)):
            for i in range(depth):
                a = f"encoder.stages.{s}.layers.{i}"
                if i == 0:  # a bottleneck stage widens or strides here
                    conv_layer(f"{a}.shortcut", size, n_in, 1)
                conv_layer(f"{a}.layer.0", size // 4, n_in, 1)
                conv_layer(f"{a}.layer.1", size // 4, size // 4, 3)
                conv_layer(f"{a}.layer.2", size, size // 4, 1)
                n_in = size
    else:
        raise ValueError(f"no HF layout named {name!r}")
    return out


def draw_hf_state(torch, layout, seed):
    """An HF state dict of ``layout`` (:func:`hf_layout`) drawn from
    ``numpy.random.default_rng(seed)``, as CPU tensors."""
    import numpy as np

    rng = np.random.default_rng(seed)
    causal = None
    sd = {}
    for key, (shape, kind) in layout.items():
        if kind in ("w", "ln", "conv"):
            a = rng.standard_normal(shape, dtype=np.float32)
            std = (1.0 / math.sqrt(math.prod(shape[1:])) if kind == "conv"
                   else 0.02)
            a *= np.float32(std)
            if kind == "ln":
                a += np.float32(1.0)
        elif kind == "var":
            a = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif kind == "tied":
            sd[key] = sd["transformer.wte.weight"]
            continue
        elif kind == "ids":
            a = np.arange(shape[-1], dtype=np.int64).reshape(shape)
        elif kind == "causal":
            if causal is None:
                causal = torch.from_numpy(np.tril(np.ones(shape[-2:],
                                                          bool))[None, None])
            sd[key] = causal
            continue
        else:  # "index", "count": integer buffers the converters drop
            a = np.zeros(shape, np.int64)
        sd[key] = torch.from_numpy(a)
    return sd


def _hf_by_hand(torch, clip, gpt2, layers):
    """The whole-stack kernels' operands, built by hand from the HF state
    dicts: the CLIP layers' (q, k, v concatenated) and the GPT-2 blocks'
    (each ``Conv1D`` transposed), stacked over ``layers``."""
    enc, dec = {}, {}
    names = (("wqkv", "bqkv"), ("wo", "bo"), ("g1", "b1"), ("g2", "b2"),
             ("wfc", "bfc"), ("wpj", "bpj"))
    for i in range(layers):
        a = f"vision_model.encoder.layers.{i}"
        for (w, b), parts in zip(names, (
                [f"{a}.self_attn.{p}_proj" for p in "qkv"],
                [f"{a}.self_attn.out_proj"], [f"{a}.layer_norm1"],
                [f"{a}.layer_norm2"], [f"{a}.mlp.fc1"], [f"{a}.mlp.fc2"])):
            enc.setdefault(w, []).append(torch.cat(
                [clip[f"{p}.weight"] for p in parts]))
            enc.setdefault(b, []).append(torch.cat(
                [clip[f"{p}.bias"] for p in parts]))
        h = f"transformer.h.{i}"
        for (w, b), (src, conv) in zip(names, (
                ("attn.c_attn", True), ("attn.c_proj", True),
                ("ln_1", False), ("ln_2", False), ("mlp.c_fc", True),
                ("mlp.c_proj", True))):
            weight = gpt2[f"{h}.{src}.weight"]
            dec.setdefault(w, []).append(weight.T if conv else weight)
            dec.setdefault(b, []).append(gpt2[f"{h}.{src}.bias"])
    return ({k: torch.stack(v) for k, v in enc.items()},
            {k: torch.stack(v) for k, v in dec.items()})


def _hold_operands(torch, what, model, by_hand):
    """The model's stacked operands (``encoder.backbone.stack``,
    ``decoder.stack``) equal the hand-built ones, cast as the model cast
    its weights."""
    for side, stack in (("encoder", model.encoder.backbone.stack),
                        ("decoder", model.decoder.stack)):
        want = by_hand[0 if side == "encoder" else 1]
        check(sorted(stack) == sorted(want),
              f"{what}: the {side} stack holds {sorted(stack)}")
        for k, w in want.items():
            check(torch.equal(stack[k].cpu(), w.to(stack[k].dtype)),
                  f"{what}: the {side} stack's {k} is not the HF weights")


def hf_layouts_phase(torch, dev, smi, trees, seed):
    """Phase 12 (module docstring). Returns the summary line's numbers and
    each kernel's launches in the bf16 decode."""
    from image_captioning_ml_project_tpu_torch.config import EncoderType
    from image_captioning_ml_project_tpu_torch.models import hf_port
    from image_captioning_ml_project_tpu_torch.models.captioning_model import (
        load_model)
    from image_captioning_ml_project_tpu_torch.params import from_flax

    t_phase = time.perf_counter()
    kernels = counters()
    cfg, tree = trees["flagship"]
    cfg32 = copy.deepcopy(cfg)
    cfg32.model.dtype = "float32"
    numbers = {"card": smi}
    t0 = time.perf_counter()
    clip = draw_hf_state(torch, hf_layout("clip", cfg), seed + 20)
    gpt2 = draw_hf_state(torch, hf_layout("gpt2", cfg), seed + 21)
    numbers["draw_s"] = time.perf_counter() - t0

    # HF layouts -> the flagship's state (seeded projection and prefix)
    # -> load_model on the card, f32 and bf16
    t0 = time.perf_counter()
    state = from_flax(tree)
    fragment = {**hf_port.port_clip_vision(
        clip, cfg.model.encoder.num_layers), **hf_port.port_gpt2(
        gpt2, cfg.model.decoder.num_layers)}
    backbones = {k for k in state if k.startswith(("encoder.backbone.",
                                                   "decoder.backbone."))}
    check(set(fragment) == backbones,
          f"hf layouts: the fragment misses "
          f"{sorted(backbones - set(fragment))} and adds "
          f"{sorted(set(fragment) - backbones)}")
    state.update(fragment)
    m32 = load_model(cfg32, dev, state_dict=state)
    m16 = load_model(cfg, dev, state_dict=state)
    torch.cuda.synchronize()
    numbers["convert_and_load_s"] = time.perf_counter() - t0
    by_hand = _hf_by_hand(torch, clip, gpt2, cfg.model.encoder.num_layers)
    for what, model in (("f32", m32), ("bf16", m16)):
        _hold_operands(torch, f"hf layouts {what}", model, by_hand)
    check(torch.equal(m32.decoder.backbone.wte.weight.cpu(),
                      gpt2["transformer.wte.weight"]),
          "hf layouts: wte is not HF's")
    del by_hand
    print(f"hf layouts: CLIP ViT-B/32 and GPT-2 124M drawn in HF's layout "
          f"({len(clip)} + {len(gpt2)} keys) in {numbers['draw_s']:.1f} s; "
          f"converted and loaded on the card in f32 and bf16 in "
          f"{numbers['convert_and_load_s']:.2f} s; both models' stacked "
          f"operands equal the HF weights [{smi}]", flush=True)

    g = torch.Generator().manual_seed(seed + 22)
    images = torch.randint(0, 256, (HF_DECODE_BATCH, cfg.image_size,
                                    cfg.image_size, 3), generator=g,
                           dtype=torch.uint8)
    # f32 on the card (#5, #3, #4) against the CPU's plain versions
    t0 = time.perf_counter()
    cpu = load_model(cfg32, "cpu", state_dict=state)
    n = HF_F32_IMAGES
    want = family_decode(torch, cfg32, cpu, images[:n])
    got = family_decode(torch, cfg32, m32, images[:n].to(dev))
    del cpu, m32, state, fragment
    err = float((got[1] - want[1]).abs().max())
    print(f"hf layouts f32 card vs CPU ({n} images): tokens gpu="
          f"{got[0].tolist()} cpu={want[0].tolist()}, scores max_abs_err "
          f"{err:.3e}; {time.perf_counter() - t0:.1f} s", flush=True)
    check(torch.isfinite(got[1]).all(), "hf layouts: non-finite scores")
    check(torch.equal(got[0], want[0]),
          "hf layouts: card and CPU decode different tokens")
    check(err <= 1e-4, f"hf layouts: scores differ by {err} > 1e-4")
    numbers["f32_card_vs_cpu"] = {"images": n, "score_err": err}

    # bf16 decode of 64 through #5 once, #3 and #4 once a step
    x = images.to(dev)
    family_decode(torch, cfg, m16, x)
    torch.cuda.synchronize()
    with DecodeCounts() as counts:
        _zero_launches(kernels)
        t0 = time.perf_counter()
        _, scores = family_decode(torch, cfg, m16, x)
        seconds = time.perf_counter() - t0
        launched = _launches(kernels)
    check(torch.isfinite(scores).all(), "hf layouts: non-finite bf16 scores")
    expect({"launches": launched},
           {"encoder_stack": counts.encodes,
            "beam_decode_stack": counts.steps,
            "lse_and_block_max": counts.steps})
    check(counts.encodes == 1, f"hf layouts: {counts.encodes} encodes")
    decode_launches = launched
    numbers["bf16_decode"] = {"batch": HF_DECODE_BATCH,
                              "decode_ms": seconds * 1e3,
                              "images_per_s": HF_DECODE_BATCH / seconds,
                              "steps": counts.steps}
    print(f"hf layouts bf16 decode of {HF_DECODE_BATCH} (beam "
          f"{cfg.inference.beam_size}, max length {cfg.inference.max_length},"
          f" length penalty {cfg.inference.length_penalty}): "
          f"{seconds * 1e3:.1f} ms ({HF_DECODE_BATCH / seconds:.1f} "
          f"images/s, {counts.steps} steps); launches {launched} [{smi}]",
          flush=True)
    del m16

    # the other published backbones: converted, loaded strictly into their
    # configurations' encoders, one bf16 encode of 64 images each
    swin = copy.deepcopy(trees["transformer"][0])
    swin.model.encoder.encoder_type = EncoderType.SWIN
    encoders = {}
    for i, (name, cfg_e, base, port) in enumerate((
            ("vit", trees["transformer"][0], trees["transformer"][1],
             lambda sd, e: hf_port.port_vit(sd, e.num_layers)),
            ("swin", swin, trees["transformer"][1],
             lambda sd, e: hf_port.port_swin(sd, e.swin_depths)),
            ("resnet", trees["lstm"][0], trees["lstm"][1],
             lambda sd, e: hf_port.port_resnet(sd, e.resnet_depths)))):
        ec = cfg_e.model.encoder
        sd = draw_hf_state(torch, hf_layout(name, cfg_e), seed + 23 + i)
        t0 = time.perf_counter()
        fragment = port(sd, ec)
        state = from_flax(base)
        if name == "swin":
            # the ViT tree's decoder, Swin's projection to the features
            # drawn here (the last stage is 1024 wide)
            state = {k: v for k, v in state.items()
                     if not k.startswith("encoder.")}
            width = ec.swin_embed_dim * 2 ** (len(ec.swin_depths) - 1)
            state["encoder.proj.weight"] = torch.randn(
                ec.feature_dim, width, generator=g) * 0.02
            state["encoder.proj.bias"] = torch.zeros(ec.feature_dim)
        else:
            backbone = {k for k in state if k.startswith("encoder.backbone.")}
            check(set(fragment) == backbone,
                  f"hf layouts {name}: the fragment misses "
                  f"{sorted(backbone - set(fragment))} and adds "
                  f"{sorted(set(fragment) - backbone)}")
        state.update(fragment)
        model = load_model(cfg_e, dev, state_dict=state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del state, fragment, sd
        x = images.to(dev)
        _zero_launches(kernels)
        with torch.inference_mode():
            out = model.encode(x)["features"]
            torch.cuda.synchronize()
        launched = _launches(kernels)
        check(not any(launched.values()),
              f"hf layouts {name}: the encode launched {launched}")
        check(out.shape[0] == HF_DECODE_BATCH
              and out.shape[-1] == ec.feature_dim
              and bool(torch.isfinite(out).all()),
              f"hf layouts {name}: encode gave {tuple(out.shape)}, finite "
              f"{bool(torch.isfinite(out).all())}")
        with torch.inference_mode():
            encode_ms = time_ms(torch, lambda: model.encode(x), runs=5)
        encoders[name] = {"convert_and_load_s": load_s,
                          "features": list(out.shape),
                          "bf16_encode_ms": encode_ms}
        print(f"hf layouts {name}: converted and loaded strictly into "
              f"--config {'lstm' if name == 'resnet' else 'transformer'}"
              f"{' --encoder_type swin' if name == 'swin' else ''} in "
              f"{load_s:.2f} s; bf16 encode of {HF_DECODE_BATCH}: features "
              f"{tuple(out.shape)}, {encode_ms:.2f} ms [{smi}]", flush=True)
        del model, out
        torch.cuda.empty_cache()
    numbers["encoders"] = encoders
    numbers["seconds"] = time.perf_counter() - t_phase
    return numbers, decode_launches


def kernel_entry(name, route, source, replaces, numbers, launches):
    """The summary line's entry for one kernel: the numbers at the shape
    of the first family that runs it of the Transformer, the flagship and
    the LSTM (the order in which their rows entered the summary), with
    the launches of the same family's run; the other families' shapes,
    where they have their own, under ``other_shapes``."""
    first = next(f for f in ("transformer", "flagship", "lstm")
                 if f in numbers)
    entry = {"name": name, "route": route, "source": source,
             "replaces": replaces, "launches": launches[first],
             **numbers[first]}
    others = [dict(family=f, launches=launches[f], **n)
              for f, n in numbers.items() if f != first]
    if others:
        entry["other_shapes"] = others
    return entry


LIBRARIES = ("beam_decode_attention", "beam_decode_attention_qkv",
             "beam_decode_stack", "encoder_stack", "cross_attention", "sdpa",
             "additive_scores", "lse")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--time-tree", metavar="DIR",
        help="only build the port's package found in DIR (an earlier tree "
             "unpacked beside this one) and time its decode-step, "
             "candidate-step and attention-variant kernels (phase 3's "
             "sweeps), printing the "
             "numbers as one JSON line; for comparisons inside one run on "
             "one card")
    parser.add_argument("--parallel-rank", nargs=2, metavar=("SPEC", "RANK"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    try:
        import torch
    except ImportError as e:
        sys.exit(f"chip_smoke: torch is not importable: {e}")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false)")
    if args.parallel_rank:
        # one of phase 10's ranks, started by the phase itself
        try:
            parallel_rank(args.parallel_rank[0], int(args.parallel_rank[1]))
        except Exception:
            traceback.print_exc()
            sys.exit("chip_smoke: rank FAILED")
        return
    root = os.path.realpath(args.time_tree) if args.time_tree else ROOT
    sys.path.insert(0, root)
    try:
        from image_captioning_ml_project_tpu_torch.main import (
            flagship_config, lstm_config, transformer_config)
        from image_captioning_ml_project_tpu_torch.ops import _build
        from image_captioning_ml_project_tpu_torch.params import (
            init_flax_params)
    except ImportError as e:
        sys.exit(f"chip_smoke: the port's package {PKG} is not beside this "
                 f"script: {e}")
    if not os.path.realpath(_build.__file__).startswith(
            os.path.join(root, PKG) + os.sep):
        sys.exit(f"chip_smoke: {PKG} was imported from {_build.__file__}, "
                 f"not from the checkout at {root}")

    import shutil
    import tempfile

    # phase 7's fixture and checkpoints, which phases 8 and 9 read
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
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
        # an earlier tree (--time-tree) may have fewer of them
        libraries = [n for n in LIBRARIES if os.path.exists(
            os.path.join(_build.CSRC_DIR, f"{n}.cu"))]
        check(args.time_tree or len(libraries) == len(LIBRARIES),
              f"sources missing from {_build.CSRC_DIR}")
        _build.build_libraries(libraries)
        for name in libraries:
            _build.load_library(name)
        print(f"{len(libraries)} libraries ({', '.join(libraries)}) built in "
              f"parallel and loaded in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for name in libraries:
            log = _build.build_log(name)
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
            spills = sum(int(b) for b in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", log))
            print(f"ptxas {name}: {len(regs)} kernels, registers "
                  f"{sorted(set(regs))}, spill bytes {spills}", flush=True)
            # the tensor-core SDPA holds its scores, weights and mix in
            # registers: a spill would put them back in memory
            check(name != "sdpa" or args.time_tree or spills == 0,
                  f"ptxas: {name} spills {spills} bytes")

        if args.time_tree:
            phase(f"decode-step and candidate-step kernels of {root}")
            sweep = sweep_decode_kernels(torch, dev, smi)
            sweep["lse_and_block_max"] = sweep_lse(torch, dev, smi)
            sweep["additive_scores"] = sweep_additive(torch, dev, smi)
            sweep["sdpa"] = sweep_sdpa(torch, dev, smi)
            print(json.dumps({"tree": root, "sweep": sweep}), flush=True)
            return

        phase("kernels vs plain")
        results = {}
        worst = {"beam_decode_attention": check_attention(torch, dev)}
        check_lse(torch, dev)
        check_dense(torch, dev)
        worst["beam_decode_attention_qkv"] = check_attention_qkv(torch, dev)
        worst["beam_decode_stack"] = check_stack(torch, dev)
        check_encoder(torch, dev, results)
        worst["cross_attention"] = check_cross(torch, dev)
        worst["sdpa"] = check_sdpa(torch, dev)
        check_additive(torch, dev)
        # the decode-step and candidate-step kernels' errors and times at
        # each bucket; the summary keeps batch 64's beside the worst bf16
        # error of the checks and of the sweep, the others under "batches"
        sweep = sweep_decode_kernels(torch, dev, smi)
        sweep["lse_and_block_max"] = sweep_lse(torch, dev, smi)
        sweep["additive_scores"] = sweep_additive(torch, dev, smi)
        sweep["sdpa"] = sweep_sdpa(torch, dev, smi)
        # greedy and nucleus decoding's shapes (one beam, no ancestry) and
        # the diverse beam's (6 beams), under "decode_shapes"
        decode_shapes = {
            "K=1 no ancestry": sweep_decode_kernels(torch, dev, smi, K=1,
                                                    ancestry=False),
            "K=6": sweep_decode_kernels(torch, dev, smi, K=6)}
        for kernel, by_family in sweep.items():
            results[kernel] = {}
            for family, by_batch in by_family.items():
                top = by_batch[SWEEP_BATCHES[-1]]
                results[kernel][family] = dict(
                    top, max_abs_err=max(
                        worst.get(kernel, {}).get(family, 0.0),
                        top["max_abs_err"]), batches={
                        B: {k: e[k] for k in ("max_abs_err", "ms",
                                              "device_ms", "plain_ms",
                                              "bound_ms", "library_ms")}
                        for B, e in by_batch.items()
                        if B != SWEEP_BATCHES[-1]})
        for label, shapes in decode_shapes.items():
            for kernel, by_family in shapes.items():
                for family, by_batch in by_family.items():
                    results[kernel][family].setdefault(
                        "decode_shapes", {})[label] = {
                        B: {k: e[k] for k in ("max_abs_err", "ms",
                                              "device_ms", "plain_ms",
                                              "bound_ms", "bound_by")}
                        for B, e in by_batch.items()}
        check_ancestry(dev, "kernels")

        phase("reference")
        trees = {}
        for name, make in (("lstm", lstm_config),
                           ("transformer", transformer_config),
                           ("flagship", flagship_config)):
            cfg = make()
            cfg.seed = args.seed
            t0 = time.perf_counter()
            trees[name] = (cfg, init_flax_params(cfg, cfg.seed))
            print(f"{name}: weights drawn from seed {cfg.seed}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            g = torch.Generator().manual_seed(cfg.seed + 1)
            ref_images = torch.randint(0, 256, (2, cfg.image_size,
                                                cfg.image_size, 3),
                                       generator=g, dtype=torch.uint8).numpy()
            # the other decodes on each family's default configuration
            # (the LSTM's: soft attention through its kernel)
            if name == "lstm":
                for i, (variant, attention, pallas) in enumerate(
                        LSTM_VARIANTS):
                    check_reference(torch, dev, *lstm_variant(
                        cfg, attention, pallas, cfg.seed), ref_images,
                        [(variant, CONFIGS[0][1])], peaked=True,
                        strategies=i == 0)
            else:
                check_reference(torch, dev, cfg, trees[name][1], ref_images,
                                TRANSFORMER_CONFIGS if name == "transformer"
                                else CONFIGS, strategies=True)
        scorer = check_scorer(torch, dev, ref_images, args.seed)

        phase("encode A/B")
        encode_ab(torch, dev, *trees["flagship"], smi)

        phase("serve")
        launches = serve_all(torch, dev, smi, trees)
        strategy_runs = serve_strategies(torch, dev, smi,
                                         *trees["flagship"], scorer)

        phase("train")
        t0 = time.perf_counter()
        training, fixture = train_phase(torch, dev, smi, *trees["flagship"],
                                        args.seed, tmp)
        print(f"train phase: {time.perf_counter() - t0:.1f} s", flush=True)

        phase("eval and demo")
        t0 = time.perf_counter()
        evaluation = eval_phase(torch, dev, smi, fixture, scorer, tmp)
        print(f"eval and demo phase: {time.perf_counter() - t0:.1f} s",
              flush=True)

        phase("other families and the device-resident resize")
        t0 = time.perf_counter()
        families, cross_shapes = families_phase(torch, dev, smi, fixture,
                                                scorer, tmp)
        print(f"families phase: {time.perf_counter() - t0:.1f} s [{smi}]",
              flush=True)

        phase("parallel and legacy")
        t0 = time.perf_counter()
        parallel, par_launches = parallel_phase(
            torch, dev, smi, fixture, trees["flagship"][1], tmp)
        print(f"parallel and legacy phase: {time.perf_counter() - t0:.1f} s "
              f"[{smi}]", flush=True)

        phase("serving and the demo under the mesh")
        serving, serving_launches = serving_mesh_phase(torch, dev, smi,
                                                       fixture, tmp)
        print(f"serving under the mesh phase: {serving['seconds']:.1f} s "
              f"[{smi}]", flush=True)

        phase("HF layouts")
        hf_layouts, hf_launches = hf_layouts_phase(torch, dev, smi, trees,
                                                   args.seed)
        print(f"HF layouts phase: {hf_layouts['seconds']:.1f} s [{smi}]",
              flush=True)

        # the port stands alone: nothing of JAX or the JAX package ran
        foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "flax", "image_captioning_ml_project_tpu"))
        check(not foreign, f"modules of JAX or the JAX package were "
                           f"imported: {foreign}")
    except Exception:
        traceback.print_exc()
        sys.exit("chip_smoke: FAILED")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    jax_pkg = "image_captioning_ml_project_tpu/ops"
    sources = {
        "beam_decode_stack": (
            "cuda", f"{PKG}/csrc/beam_decode_stack.cu",
            f"{jax_pkg}/pallas_decode.py:1177"),
        "encoder_stack": (
            "cuda", f"{PKG}/csrc/encoder_stack.cu",
            f"{jax_pkg}/pallas_encoder.py:171"),
        "lse_and_block_max": (
            "cuda", f"{PKG}/csrc/lse.cu", f"{jax_pkg}/pallas_lse.py:64"),
        "beam_decode_attention_qkv": (
            "cuda", f"{PKG}/csrc/beam_decode_attention_qkv.cu",
            f"{jax_pkg}/pallas_decode.py:655"),
        "beam_decode_attention": (
            "cuda", f"{PKG}/csrc/beam_decode_attention.cu",
            f"{jax_pkg}/pallas_decode.py:361"),
        "cross_attention": (
            "cuda", f"{PKG}/csrc/cross_attention.cu",
            f"{jax_pkg}/pallas_cross.py:99"),
        "sdpa": (
            "cuda", f"{PKG}/csrc/sdpa.cu",
            f"{jax_pkg}/pallas_attention.py:66"),
        "additive_scores": (
            "cuda", f"{PKG}/csrc/additive_scores.cu",
            f"{jax_pkg}/pallas_attention.py:146"),
    }
    kernels = [kernel_entry(name, *where, results[name], launches[name])
               for name, where in sources.items()]
    for entry in kernels:
        entry["decoding_options"] = {
            run_name: run["launches"][entry["name"]]
            for run_name, run in strategy_runs.items()
            if run["launches"][entry["name"]]}
        entry["training"] = {
            "train_steps": training["bf16"]["launches"][entry["name"]],
            "validation": training["validation"]["launches"][entry["name"]],
            "reload": training["reload"]["launches"][entry["name"]],
            "scst": training["scst"]["launches"][entry["name"]]}
        entry["evaluation"] = {
            run: evaluation[run]["launches"][entry["name"]]
            for run in ("eval", "reranked_eval", "demo")}
        entry["families"] = {
            f"{family} {run}": numbers["launches"][entry["name"]]
            for family, runs in families.items() for run, numbers in
            runs.items() if isinstance(numbers, dict)
            and "launches" in numbers and numbers["launches"][entry["name"]]}
        if entry["name"] == "cross_attention":
            entry["family_shapes"] = cross_shapes
        entry["parallel"] = par_launches[entry["name"]]
        entry["serving_mesh"] = serving_launches[entry["name"]]
        entry["hf_layouts"] = hf_launches[entry["name"]]
        if entry["name"] == "beam_decode_attention":
            entry["tp2_shape"] = serving["tp2_attention"]
    print(json.dumps({"training": {
        key: (training[key] if key == "f32_card_vs_cpu" else
              {k: v for k, v in training[key].items() if k != "launches"})
        for key in ("f32_card_vs_cpu", "bf16", "validation", "reload",
                    "scst")}, "evaluation": {
        key: ({k: v for k, v in value.items() if k != "launches"}
              if isinstance(value, dict) else value)
        for key, value in evaluation.items()}}))
    print(json.dumps({"families": {
        family: {run: {k: v for k, v in numbers.items() if k != "launches"}
                 if isinstance(numbers, dict) else numbers
                 for run, numbers in runs.items()}
        for family, runs in families.items()}}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"serving_mesh": serving}))
    print(json.dumps({"hf_layouts": hf_layouts}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
