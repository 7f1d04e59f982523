"""Production serving: HTTP caption service with request micro-batching.

Counterpart of ``image_captioning_ml_project_tpu.inference.server``, built
on this package's model (no trainer). The shape of the service is the
same:

* requests are micro-batched: the batcher drains up to ``batch_size``
  requests (waiting at most ``max_wait_ms`` after the first), pads the
  batch to the smallest bucket of the ladder that holds it by repeating
  the last image, and each request reads only its own output row;
* the weights are cast once at start-up (bf16, norms f32) and stay frozen;
* a completer thread copies batch N's tokens to the host and detokenizes
  them while the batcher runs batch N+1 (``pipeline_depth``); with CLIP
  reranking it first picks each image's caption among the batch's beam
  candidates there.

Each part of a batch's life is a span (:func:`..utils.profiling.span`),
kept while the recorder is on: on the batcher thread ``serve.batch`` (its
rows, bucket and the rows' enqueue times; each opens before the last one
closes) around ``serve.wait`` (for the batch's first request; a batch
span without rows is a wait that timed out), ``serve.fill`` (the rest of the batch, up to ``max_wait_ms``),
``serve.stack``, ``serve.upload``, ``serve.decode`` and ``serve.handoff``
(the bounded put to the completer); on the completer
``serve.fetch_tokens`` and ``serve.detokenize``, whose parent is the
batch's span.

Every decoding option of ``config.inference`` is served: greedy, nucleus
sampling (from one ``torch.Generator`` on the service's device seeded
from ``config.seed``, drawn from batch after batch), beam search with or
without diverse groups, and CLIP reranking of beam candidates.

The weights come from a checkpoint of the port's trainer
(``checkpoint_path``: its params and BatchNorm statistics only, read
memory-mapped, never the optimizer state), from the JAX package's
variable tree, or from ``config.seed``. :meth:`CaptionService.
reload_checkpoint` swaps in another checkpoint's weights under load: the
new model is built off the batcher thread and swapped in with one
attribute assignment, each batch reading the attribute once, so in-flight
batches finish on the old weights and the next dispatch runs the new ones.

The HTTP layer is ``http.server``: POST image bytes to ``/caption`` and
``{"checkpoint": name}`` to ``/reload``; GET ``/healthz``, ``/stats`` and
``/metrics``.

Under a mesh (``mesh=``, :func:`..parallel.mesh.create_mesh`; the JAX
``CaptionService(mesh=)``) every rank is a process holding the model, and
rank 0 is the front: it alone runs the HTTP layer, the batcher and the
completer. ``batch_size`` and every bucket round up to a multiple of the
data axis, as the JAX service rounds them. The other ranks run
:meth:`CaptionService.follow`, a loop over the command stream that rank
0's batcher thread broadcasts over the whole group. A command is a
header (op, argument, real rows, sequence number, checkpoint name), one
object of ``broadcast_object_list``, and for a batch its payload:

* ``BATCH``: the padded host batch. Each data rank uploads only its own
  rows (:func:`..parallel.mesh.batch_rows`, where the JAX service's
  sharded ``device_put`` places them), decodes them, and with a reranker
  picks each row's caption there (the pick is row by row). Model ranks of
  one data row decode the same rows together, on their shards of GPT-2's
  heads (:func:`..parallel.sharding.shard_decode_model`). Then every
  rank's status text comes back to all ranks (``all_gather_object``),
  and the tokens to rank 0 through
  :func:`..parallel.mesh.gather_rows_host` over the data group (only
  model rank 0's rows count);
* ``RELOAD``: a checkpoint name. Every rank starts reading the checkpoint
  itself on a side thread (under a model axis it shards it there too)
  and goes on decoding ``BATCH``es on the old weights; the side thread
  issues no collective;
* ``SWAP``: sent once rank 0's own read has finished. Every rank waits
  for its read, the statuses are exchanged, and each rank swaps in its
  new model (one attribute assignment) only if every rank read it, so
  the ranks never serve different weights. ``POST /reload`` answers
  after the swap;
* ``NOOP``: a heartbeat after a few idle seconds, which keeps the
  followers' waits inside the process group's timeout and finds a dead
  rank while the service is idle;
* ``STOP``: the followers return from ``follow()``.

The order on every rank is: header N, batch N, decode N, statuses N,
gather N; rank 0's completer then detokenizes batch N while its batcher
goes on to header N + 1, so ``pipeline_depth`` keeps its meaning. Every
collective is issued by one thread per rank, in the same order: on rank 0
the batcher thread. Warmup, ``_run_images`` and ``reload_checkpoint`` are
handed to that thread as control items and their callers wait (a
second reload waits for the first one's swap). Nucleus
draws come from a generator seeded with ``config.seed`` plus the data
rank, as ``main.evaluate`` seeds it under a mesh. A decode or reload
error on any rank fails that batch's requests (or that reload) on rank 0
with the rank's text, and the service goes on. A failed collective (a
dead rank) is fatal: rank 0 fails every pending request and stops, and
:func:`serve` raises.
"""

from __future__ import annotations

import io
import json
import logging
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.coco import center_crop_resize
from ..main import _resolve_reranker
from ..models.captioning_model import load_model
from ..parallel.mesh import batch_rows, broadcast_host, gather_rows_host
from ..parallel.sharding import shard_decode_model
from ..utils.checkpoint import CheckpointManager
from ..utils.profiling import span
from .decoding import decode_images

logger = logging.getLogger(__name__)

# the command stream's ops (the header's first field)
BATCH, RELOAD, SWAP, NOOP, STOP = 1, 2, 3, 4, 5
HEARTBEAT_S = 5.0  # idle seconds after which rank 0 sends a NOOP


class RankFailure(RuntimeError):
    """A decode or reload that failed on some rank of the mesh, every rank
    told so: the batch (or reload) fails, the service goes on."""


class ServerStats:
    """Lock-protected serving counters + latency percentiles over the last
    ``window`` requests. ``decode_steps`` counts the model decode steps the
    batches ran (beam search exits early once every hypothesis is done)."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._window = window
        self._latencies_ms: List[float] = []
        self.requests = 0
        self.completed = 0
        self.errors = 0
        self.batches = 0
        self.batched_rows = 0
        self.decode_steps = 0
        self._started = time.monotonic()

    def record_request(self):
        with self._lock:
            self.requests += 1

    def record_batch(self, n_real: int):
        with self._lock:
            self.batches += 1
            self.batched_rows += n_real

    def record_steps(self, n: int):
        with self._lock:
            self.decode_steps += n

    def record_done(self, latency_s: float, error: bool = False):
        with self._lock:
            if error:
                self.errors += 1
            else:
                self.completed += 1
            self._latencies_ms.append(latency_s * 1e3)
            if len(self._latencies_ms) > self._window:
                self._latencies_ms = self._latencies_ms[-self._window:]

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies_ms)
            elapsed = time.monotonic() - self._started

            def pct(p):
                if not lat:
                    return None
                rank = max(0, math.ceil(p / 100.0 * len(lat)) - 1)  # nearest
                return round(lat[min(len(lat) - 1, rank)], 2)

            return {
                "requests": self.requests,
                "completed": self.completed,
                "errors": self.errors,
                "batches": self.batches,
                "decode_steps": self.decode_steps,
                "mean_batch_fill": round(self.batched_rows
                                         / max(1, self.batches), 2),
                "latency_ms": {"p50": pct(50), "p95": pct(95),
                               "p99": pct(99)},
                "uptime_s": round(elapsed, 1),
                "throughput_rps": round(self.completed / max(elapsed, 1e-9),
                                        2),
            }

    def prometheus(self) -> str:
        """The same snapshot in Prometheus text exposition format."""
        s = self.snapshot()
        lines = []

        def metric(name, mtype, value, help_text):
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            lines.append(f"{name} {value}")

        metric("ict_requests_total", "counter", s["requests"],
               "Caption requests received")
        metric("ict_completed_total", "counter", s["completed"],
               "Caption requests completed successfully")
        metric("ict_errors_total", "counter", s["errors"],
               "Caption requests that failed")
        metric("ict_batches_total", "counter", s["batches"],
               "Device batches launched")
        metric("ict_decode_steps_total", "counter", s["decode_steps"],
               "Model decode steps run by all batches")
        metric("ict_batch_fill_mean", "gauge", s["mean_batch_fill"],
               "Mean real rows per launched batch")
        metric("ict_uptime_seconds", "gauge", s["uptime_s"],
               "Seconds since service start")
        lat = s["latency_ms"]
        lines.append("# HELP ict_latency_ms Request latency percentiles "
                     "over the stats window")
        lines.append("# TYPE ict_latency_ms summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            if lat[key] is not None:
                lines.append(f'ict_latency_ms{{quantile="{q}"}} {lat[key]}')
        return "\n".join(lines) + "\n"


class _Request:
    __slots__ = ("image", "caption", "error", "event", "t_enqueue")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.caption: Optional[str] = None
        self.error: Optional[str] = None
        self.event = threading.Event()
        self.t_enqueue = time.monotonic()


class _Call:
    """Work for the batcher thread (the one thread of rank 0 that issues
    collectives): ``kind`` on ``arg``, its result or error handed back to
    the waiting caller."""

    __slots__ = ("kind", "arg", "result", "error", "event")

    def __init__(self, kind: str, arg):
        self.kind, self.arg = kind, arg
        self.result = self.error = None
        self.event = threading.Event()


class CaptionService:
    """Micro-batching caption service around the port's decode engine.

    ``submit(image)`` blocks until the request's batch has run;
    ``submit_async``/``result`` let one caller keep many requests in
    flight. The model is built on ``device`` from the trainer checkpoint
    ``checkpoint_path`` (a name under ``config.checkpoint_dir``, or a
    path), from ``params`` (the JAX package's variable tree), or, when
    neither is given, from ``config.seed``, and cast to
    ``config.model.dtype``. Batches decode with ``config.inference``'s
    strategy (:func:`.decoding.decode_images`). With a ``reranker``
    (given, or built from a local CLIP checkpoint when
    ``use_clip_reranking`` is set) they decode ``max(beam_size,
    num_candidates)`` beams instead, and the reranker picks each image's
    caption among the first ``num_candidates`` on the completer thread.

    With a ``mesh`` this is one rank of a service over it (module
    docstring): rank 0 calls :meth:`start` and serves, every other rank
    calls :meth:`follow`; each reranks its own rows.
    """

    def __init__(self, config, tokenizer, device, params=None,
                 checkpoint_path: Optional[str] = None, reranker=None,
                 batch_size: int = 8, max_wait_ms: float = 10.0,
                 request_timeout_s: float = 60.0, pipeline_depth: int = 2,
                 bucket_sizes=None, mesh=None):
        self.config = config
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.mesh = mesh
        if checkpoint_path:
            if params is not None:
                raise ValueError("give the weights as params or as "
                                 "checkpoint_path, not both")
            self.model = self._load_checkpoint(checkpoint_path)
        else:
            self.model = shard_decode_model(
                load_model(config, self.device, params=params), mesh)
        self.reranker = (reranker if reranker is not None
                         else _resolve_reranker(config, tokenizer, None,
                                                self.device))
        # nucleus draws: one stream of noise, batch after batch (the JAX
        # service splits its key per batch); under a mesh one per data rank
        seed = config.seed + (mesh.data_rank if mesh is not None else 0)
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed)
        # batches and buckets round up to a multiple of the data axis
        dp = mesh.dp if mesh is not None else 1
        self.batch_size = batch_size = -(-batch_size // dp) * dp
        # bucketed batch shapes: a quiet-hour single request should not pay
        # a full batch_size-wide decode; rows are independent, so captions
        # are identical across buckets
        if bucket_sizes is None:
            bucket_sizes = [1, 8, batch_size]
        buckets = sorted({min(-(-int(b) // dp) * dp, batch_size)
                          for b in bucket_sizes if int(b) >= 1})
        if not buckets or buckets[-1] != batch_size:
            buckets.append(batch_size)
        self.bucket_sizes = buckets
        self.max_wait_s = max_wait_ms / 1e3
        self.request_timeout_s = request_timeout_s
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # depth <= 1 completes batches inline on the batcher thread
        self._sync = pipeline_depth <= 1
        self._pending: "queue.Queue" = queue.Queue(
            maxsize=max(1, pipeline_depth - 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self.stats = ServerStats()
        # the mesh's command stream: rank 0's control items for its
        # batcher thread, the reload begun but not yet swapped (its call,
        # on rank 0) and this rank's read of it (thread, result), the
        # sequence number of the last command, the time of the last one
        # sent, and why the mesh failed (if it did)
        self._control: "queue.Queue[_Call]" = queue.Queue()
        self._reload_call: Optional[_Call] = None
        self._loading = None
        self._seq = 0
        self._last_sent = time.monotonic()
        self.fatal: Optional[str] = None
        self.on_fatal = None  # called on the batcher thread when it fails

    @property
    def is_front(self) -> bool:
        """Whether this rank serves requests: rank 0, or no mesh."""
        return self.mesh is None or self.mesh.rank == 0

    # -- lifecycle ---------------------------------------------------------

    def start(self, warmup: bool = True):
        """Start the batcher and run every bucket once (optional: builds
        the kernels, fills the allocator's cache) before any request can
        come. Under a mesh only rank 0 starts, and its warmup runs on the
        batcher thread, every rank decoding its rows of each bucket in
        step."""
        if not self.is_front:
            raise RuntimeError("only rank 0 of the mesh serves; the other "
                               "ranks follow() it")
        self._stop.clear()
        self._thread = threading.Thread(target=self._batch_loop,
                                        name="caption-batcher", daemon=True)
        self._thread.start()
        if not self._sync:
            self._completer = threading.Thread(target=self._complete_loop,
                                               name="caption-completer",
                                               daemon=True)
            self._completer.start()
        if warmup:
            t0 = time.monotonic()
            size = self.config.image_size
            dummy = np.zeros((size, size, 3), dtype=np.uint8)
            for b in self.bucket_sizes:
                self._run_images([dummy] * b)
            logger.info("Serving warmup: %.1fs (buckets %s)",
                        time.monotonic() - t0, self.bucket_sizes)
        return self

    def stop(self):
        """Stop serving; under a mesh the batcher first sends ``STOP``, so
        every follower leaves :meth:`follow`."""
        self._stop.set()
        if self._thread is not None:
            # under a mesh the batcher ends its collective first (bounded
            # by the process group's timeout), then sends STOP
            self._thread.join(timeout=None if self.mesh is not None else 10)
            self._thread = None
        if self._completer is not None:
            self._completer.join(timeout=30)
            self._completer = None
        self._fail_queued("server shutting down")

    def _fail_queued(self, error: str):
        """Fail every request still queued or in flight, and every control
        item still waiting."""
        for q in (self._pending, self._queue):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                reqs = item[0] if isinstance(item, tuple) else [item]
                for req in reqs:
                    req.error = error
                    req.event.set()
        while True:
            try:
                call = self._control.get_nowait()
            except queue.Empty:
                break
            call.error = RuntimeError(error)
            call.event.set()

    # -- request paths -----------------------------------------------------

    def submit(self, image: np.ndarray) -> str:
        """Caption one preprocessed uint8 [size, size, 3] image (blocking)."""
        return self.result(self.submit_async(image))

    def submit_async(self, image: np.ndarray) -> _Request:
        """Enqueue a caption request and return its handle immediately.
        The image must already be the serving shape and dtype: a malformed
        row would otherwise fail its whole micro-batch."""
        if self._stop.is_set() or self._thread is None:
            raise RuntimeError("caption service is not running")
        image = np.asarray(image)
        size = self.config.image_size
        if image.shape != (size, size, 3):
            raise ValueError(
                f"expected a preprocessed [{size}, {size}, 3] image, got "
                f"{image.shape} (encoded bytes go through caption_bytes)")
        if image.dtype != np.uint8:
            raise ValueError(f"expected uint8 pixels, got {image.dtype}")
        self.stats.record_request()
        req = _Request(np.ascontiguousarray(image))
        self._queue.put(req)
        return req

    def result(self, req: _Request, timeout: Optional[float] = None) -> str:
        """Block until a ``submit_async`` request completes; return its
        caption (raises on decode error or timeout)."""
        if not req.event.wait(self.request_timeout_s
                              if timeout is None else timeout):
            self.stats.record_done(time.monotonic() - req.t_enqueue,
                                   error=True)
            raise TimeoutError("caption request timed out")
        self.stats.record_done(time.monotonic() - req.t_enqueue,
                               error=req.error is not None)
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.caption

    def _load_checkpoint(self, name: str):
        """The decode model of a trainer checkpoint's weights: its model
        params and BatchNorm statistics, read memory-mapped without the
        optimizer's files (``CheckpointManager.restore_partial``), on
        this rank's shards under a model axis."""
        state = CheckpointManager(self.config.checkpoint_dir).model_weights(
            name)
        return shard_decode_model(
            load_model(self.config, self.device, state_dict=state),
            self.mesh)

    def reload_checkpoint(self, name: str) -> dict:
        """Hot-swap the serving weights from checkpoint ``name`` without
        downtime: the new model is read, cast and stacked on the calling
        thread while the batcher keeps serving on the old one, then swapped
        in with one attribute assignment (each batch reads the attribute
        once, so no batch mixes the two). Under a mesh the reload goes to
        the batcher thread as a control item: every rank reads the
        checkpoint on a side thread while the batches go on, and the swap
        reaches every rank at the same batch boundary (module docstring);
        this returns once every rank has swapped."""
        t0 = time.monotonic()
        if self.mesh is not None:
            self._mesh_call("reload", name)
        else:
            self.model = self._load_checkpoint(name)
        dt = time.monotonic() - t0
        logger.info("Reloaded checkpoint %r in %.2fs", name, dt)
        return {"reloaded": name, "seconds": round(dt, 2)}

    def caption_bytes(self, data: bytes) -> str:
        """Caption raw encoded image bytes (JPEG/PNG/...): shorter-side
        resize + center crop on the host, as the JAX service does."""
        from PIL import Image

        img = Image.open(io.BytesIO(data)).convert("RGB")
        arr = np.asarray(center_crop_resize(img, self.config.image_size),
                         dtype=np.uint8)
        return self.submit(arr)

    # -- batcher -----------------------------------------------------------

    def _batch_loop(self):
        batch = None
        try:
            while not self._stop.is_set():
                if self.mesh is not None:
                    self._run_control()
                    if self._stop.is_set():
                        break
                # a batch's span (the wait for its first request included)
                # opens before the last one closes: between two spans the
                # batcher may wait for the GIL, the device idle and no span
                # open to name it
                last, batch = batch, span("serve.batch", 0).__enter__()
                if last is not None:
                    last.__exit__(None, None, None)
                reqs = self._gather()
                if reqs:
                    self._serve_batch(reqs, batch)
                elif (self.mesh is not None and time.monotonic()
                        - self._last_sent > HEARTBEAT_S):
                    self._guarded(lambda: self._send(NOOP))
        finally:
            if batch is not None:
                batch.__exit__(None, None, None)
            if self.mesh is not None and self.fatal is None:
                self._guarded(lambda: self._send(STOP))
            if self._reload_call is not None:  # begun, never swapped
                self._reload_call.error = RuntimeError(
                    self.fatal or "server shutting down")
                self._reload_call.event.set()

    def _gather(self) -> List[_Request]:
        """The next micro-batch: its first request within 50 ms
        (``serve.wait``), then up to ``batch_size`` within ``max_wait_s``
        of it (``serve.fill``); [] where none came."""
        try:
            with span("serve.wait"):
                first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        reqs = [first]
        with span("serve.fill"):
            deadline = time.monotonic() + self.max_wait_s
            while len(reqs) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    reqs.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
        return reqs

    def _serve_batch(self, reqs: List[_Request], batch):
        """Decode ``reqs`` and hand them to the completer. ``batch``: the
        batch's span, whose id the completer's spans name as parent."""
        self.stats.record_batch(len(reqs))
        if batch.attrs is not None:  # the recorder is on
            batch.attrs.update(rows=len(reqs), bucket=self._bucket(len(reqs)),
                               t_enqueue=[r.t_enqueue for r in reqs])
        try:
            tokens, images = self._dispatch([r.image for r in reqs])
        except Exception as e:  # surface the failure to every caller
            logger.exception("serving batch dispatch failed")
            for req in reqs:
                req.error = f"{type(e).__name__}: {e}"
                req.event.set()
            if self.mesh is not None and not isinstance(e, RankFailure):
                self._die(e)  # a collective failed: the mesh is gone
            return
        if self._sync:
            self._complete_batch(reqs, tokens, images, batch.id)
            return
        # bounded put = pipeline-depth backpressure; poll _stop so a
        # shutdown with a stalled completer cannot wedge the batcher here
        with span("serve.handoff"):
            while not self._stop.is_set():
                try:
                    self._pending.put((reqs, tokens, images, batch.id),
                                      timeout=0.1)
                    return
                except queue.Full:
                    continue
        for req in reqs:
            req.error = "server shutting down"
            req.event.set()

    def _complete_loop(self):
        while True:
            try:
                item = self._pending.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            self._complete_batch(*item)

    def _finish(self, tokens, images) -> np.ndarray:
        """The batch's host tokens [B, L]: the reranker's pick among the
        candidates, or the decode's tokens (under a mesh, gathered from
        the ranks, which reranked their rows: ``images`` is None).
        Inference mode is per thread, so the completer enters it here for
        the reranker's launches."""
        with torch.inference_mode():
            if self.reranker is not None and images is not None:
                tokens = self.reranker(images, tokens)
            if isinstance(tokens, torch.Tensor):
                tokens = tokens.cpu().numpy()
        return np.asarray(tokens)

    def _complete_batch(self, reqs, tokens, images, parent=None):
        """The captions of a decoded batch; ``parent``: the id of the
        batch's span on the batcher thread."""
        try:
            with span("serve.fetch_tokens", parent):
                tokens = self._finish(tokens, images)
            with span("serve.detokenize", parent):
                for i, req in enumerate(reqs):
                    req.caption = self.tokenizer.decode(
                        tokens[i], skip_special_tokens=True)
        except Exception as e:
            logger.exception("serving batch completion failed")
            for req in reqs:
                req.error = f"{type(e).__name__}: {e}"
        finally:
            for req in reqs:
                req.event.set()

    def _decode(self, images: torch.Tensor) -> torch.Tensor:
        """Captions of a device batch: tokens [B, L] with the configured
        strategy or, with a reranker, its candidates [B, num_candidates,
        L] (:func:`.decoding.decode_images`)."""
        model = self.model  # read once: a reload swaps it between batches
        steps = 0

        def step_fn(state, tokens):
            nonlocal steps
            steps += 1
            return model.step(state, tokens)

        tokens = decode_images(model, images, self.config, self._generator,
                               candidates=self.reranker is not None,
                               step_fn=step_fn)
        self.stats.record_steps(steps)
        return tokens

    def _dispatch(self, images: List[np.ndarray]):
        """Pad to the smallest bucket >= the micro-batch and decode it on the
        device; returns the device tokens and the device images (which the
        reranker reads). Under a mesh the batch goes through the command
        stream and this returns the host tokens gathered from the ranks
        (reranked there) and None."""
        if len(images) > self.batch_size:
            raise ValueError(f"micro-batch of {len(images)} exceeds "
                             f"batch_size {self.batch_size}")
        bucket = self._bucket(len(images))
        with span("serve.stack"):
            batch = np.stack(images + [images[-1]] * (bucket - len(images)))
        if self.mesh is not None:
            self._send(BATCH, bucket, len(images))
            batch = broadcast_host(batch, batch.shape, np.uint8, self.mesh)
            return self._rank_batch(batch), None
        with torch.inference_mode():
            with span("serve.upload"):
                arr = torch.from_numpy(batch).to(self.device)
            with span("serve.decode"):
                return self._decode(arr), arr

    def _bucket(self, rows: int) -> int:
        """The smallest bucket that holds ``rows``."""
        return next(b for b in self.bucket_sizes if b >= rows)

    def _run_images(self, images: List[np.ndarray]) -> List[str]:
        """Synchronous decode of any number of images (warmup /
        programmatic use), in ``batch_size`` chunks; under a mesh on the
        batcher thread once it runs."""
        captions: List[str] = []
        for lo in range(0, len(images), self.batch_size):
            chunk = images[lo:lo + self.batch_size]
            if self.mesh is not None:
                tokens = self._mesh_call("run", chunk)
            else:
                tokens = self._finish(*self._dispatch(chunk))
            captions.extend(
                self.tokenizer.decode(tokens[i], skip_special_tokens=True)
                for i in range(len(chunk)))
        return captions

    # -- the mesh's command stream (module docstring) -----------------------

    def _send(self, op: int, arg: int = 0, rows: int = 0, name: str = ""):
        """Rank 0: broadcast the next command's header."""
        self._seq += 1
        dist.broadcast_object_list([(op, arg, rows, self._seq, name)], src=0)
        self._last_sent = time.monotonic()

    def _receive(self):
        """A follower: the next command's (op, argument, real rows,
        name)."""
        header = [None]
        dist.broadcast_object_list(header, src=0)
        op, arg, rows, seq, name = header[0]
        if seq != self._seq + 1:
            raise RuntimeError(f"rank {self.mesh.rank}: command {seq} after "
                               f"{self._seq}: the ranks are out of step")
        self._seq = seq
        return op, arg, rows, name

    def follow(self):
        """A follower's loop (every rank but 0 of a mesh): run each command
        rank 0 broadcasts until ``STOP``. A decode or reload that fails on
        any rank is told to rank 0 and the loop goes on; a failed
        collective raises."""
        if self.is_front:
            raise RuntimeError("rank 0 serves; only the other ranks follow")
        size = self.config.image_size
        while True:
            op, arg, rows, name = self._receive()
            try:
                if op == STOP:
                    logger.info("rank %d: STOP after %d commands",
                                self.mesh.rank, self._seq)
                    return
                if op == BATCH:
                    batch = broadcast_host(None, (arg, size, size, 3),
                                           np.uint8, self.mesh)
                    self._rank_batch(batch)
                elif op == RELOAD:
                    self._begin_reload(name)
                elif op == SWAP:
                    self._finish_reload()
                elif op != NOOP:
                    raise RuntimeError(f"unknown command {op}")
            except RankFailure as e:
                logger.warning("rank %d: %s", self.mesh.rank, e)

    def _rank_batch(self, batch: np.ndarray) -> np.ndarray:
        """Every rank: decode this data rank's rows of the host ``batch``
        (uploading only them), exchange the statuses and gather the tokens
        [B, L] over the data axis (meaningful on rank 0). Raises
        :class:`RankFailure` on every rank where one failed."""
        rows = batch_rows(len(batch), self.mesh)
        error, tokens = "", None
        try:
            with torch.inference_mode():
                with span("serve.upload"):
                    arr = torch.from_numpy(batch[rows]).to(self.device)
                with span("serve.decode"):
                    tokens = self._decode(arr)
                if self.reranker is not None:
                    tokens = self.reranker(arr, tokens)
                if isinstance(tokens, torch.Tensor):
                    tokens = tokens.cpu().numpy()
                tokens = np.asarray(tokens, dtype=np.int64)
        except Exception as e:
            logger.exception("rank %d: decode failed", self.mesh.rank)
            error = f"{type(e).__name__}: {e}"
        _exchange_statuses(error)
        return gather_rows_host(tokens, self.mesh)

    def _begin_reload(self, name: str):
        """Every rank: start reading checkpoint ``name`` on a side thread,
        which issues no collective; the batches go on meanwhile."""
        result = {}

        def read():
            try:
                result["model"] = self._load_checkpoint(name)
            except Exception as e:
                logger.exception("rank %d: reload of %r failed",
                                 self.mesh.rank, name)
                result["error"] = f"{type(e).__name__}: {e}"

        thread = threading.Thread(target=read, name="caption-reload",
                                  daemon=True)
        thread.start()
        self._loading = (thread, result)

    def _finish_reload(self):
        """Every rank, on ``SWAP``: wait for this rank's read, exchange the
        statuses, and swap the new model in only if every rank read it."""
        thread, result = self._loading
        self._loading = None
        thread.join()
        _exchange_statuses(result.get("error", ""))
        self.model = result["model"]

    def _swap(self):
        """Rank 0: send ``SWAP`` and swap with the other ranks."""
        self._send(SWAP)
        self._finish_reload()

    def _mesh_call(self, kind: str, arg):
        """Run ``kind`` on the batcher thread and wait for its result (on
        the calling thread before :meth:`start`: no other thread issues
        collectives yet)."""
        call = _Call(kind, arg)
        thread = self._thread
        if thread is None:
            result = self._run_call(call)
            if kind == "reload":
                self._swap()
            return result
        self._control.put(call)
        while not call.event.wait(0.1):
            if not thread.is_alive() and not call.event.is_set():
                # stopped before it took the call
                raise RuntimeError("caption service is not running")
        if call.error is not None:
            raise call.error
        return call.result

    def _run_call(self, call: _Call):
        """Rank 0: a control item's work; a reload only begins here."""
        if call.kind == "run":
            return self._finish(*self._dispatch(call.arg))
        self._send(RELOAD, name=call.arg)
        self._begin_reload(call.arg)
        return None

    def _run_control(self):
        """The batcher thread: swap in the reload begun earlier once rank
        0's read of it has finished, then run the waiting control items.
        A reload only begins there, and the items after it wait for its
        swap."""
        call = self._reload_call
        if call is not None:
            if self._loading[0].is_alive():
                return
            self._reload_call = None
            self._settle(call, self._swap)
        while self._reload_call is None and not self._stop.is_set():
            try:
                call = self._control.get_nowait()
            except queue.Empty:
                return
            begins = call.kind == "reload"
            if (self._settle(call, lambda: self._run_call(call),
                             wake=not begins) and begins):
                self._reload_call = call

    def _settle(self, call: _Call, fn, wake: bool = True) -> bool:
        """Run ``fn`` for ``call`` and hand its caller the result (waking
        it if ``wake``) or the error (waking it; a failed collective is
        fatal). Returns whether ``fn`` succeeded."""
        try:
            call.result = fn()
        except Exception as e:
            call.error = e
            call.event.set()
            if not isinstance(e, RankFailure):
                self._die(e)
            return False
        if wake:
            call.event.set()
        return True

    def _guarded(self, fn):
        """Run a command of rank 0's batcher; a failure is fatal."""
        try:
            fn()
        except Exception as e:
            self._die(e)

    def _die(self, e: Exception):
        """The mesh failed under rank 0 (a collective raised): fail every
        pending request and control item, stop, and tell ``on_fatal``."""
        if self.fatal is not None:
            return
        self.fatal = f"{type(e).__name__}: {e}"
        logger.error("the caption service's mesh failed: %s", self.fatal)
        self._stop.set()
        self._fail_queued(f"the mesh failed: {self.fatal}")
        if self.on_fatal is not None:
            self.on_fatal()


def _exchange_statuses(error: str):
    """Give every rank each rank's status (``error``, ``""`` for success)
    and raise :class:`RankFailure` on all of them, naming every rank that
    failed, if any did."""
    statuses = [None] * dist.get_world_size()
    dist.all_gather_object(statuses, error)
    bad = [f"rank {r}: {text}" for r, text in enumerate(statuses) if text]
    if bad:
        raise RankFailure("; ".join(bad))


# -- HTTP layer --------------------------------------------------------------


def _make_handler(service: CaptionService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                mc = service.config.model
                self._reply(200, {
                    "ok": True,
                    "encoder": mc.encoder.encoder_type.value,
                    "decoder": mc.decoder.decoder_type.value,
                    "device": str(service.device),
                    "batch_size": service.batch_size,
                    "bucket_sizes": service.bucket_sizes,
                    "mesh": (service.mesh.shape if service.mesh is not None
                             else None),
                })
            elif self.path == "/stats":
                self._reply(200, service.stats.snapshot())
            elif self.path == "/metrics":
                body = service.stats.prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/reload":
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(length))
                    self._reply(200,
                                service.reload_checkpoint(req["checkpoint"]))
                except Exception as e:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path != "/caption":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                data = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type") or "").lower()
                if ctype.startswith("application/json"):
                    import base64

                    data = base64.b64decode(json.loads(data)["image_b64"])
                t0 = time.monotonic()
                caption = service.caption_bytes(data)
                self._reply(200, {
                    "caption": caption,
                    "latency_ms": round((time.monotonic() - t0) * 1e3, 2),
                })
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # route through logging
            logger.debug("%s - %s", self.address_string(), fmt % args)

    return Handler


def make_http_server(service: CaptionService, host: str = "127.0.0.1",
                     port: int = 8000) -> ThreadingHTTPServer:
    """Bind (but don't run) the HTTP front end; ``port=0`` picks a free one."""
    return ThreadingHTTPServer((host, port), _make_handler(service))


def serve(config, tokenizer, device, host: str = "127.0.0.1",
          port: int = 8000, batch_size: int = 8, max_wait_ms: float = 10.0,
          pipeline_depth: int = 2, bucket_sizes=None,
          checkpoint_path: Optional[str] = None, mesh=None):
    """CLI entry: build the service, warm it up, and serve until SIGTERM.
    Under a ``mesh`` rank 0 binds ``port`` and serves, and every other
    rank follows it (ignoring SIGTERM, which ``torch.distributed.run``
    forwards to every worker: rank 0's ``STOP`` ends it); rank 0 raises
    when the mesh failed under it, so its process exits non-zero."""
    import signal

    service = CaptionService(config, tokenizer, device,
                             checkpoint_path=checkpoint_path,
                             batch_size=batch_size, max_wait_ms=max_wait_ms,
                             pipeline_depth=pipeline_depth,
                             bucket_sizes=bucket_sizes, mesh=mesh)
    if not service.is_front:
        def _wait_for_stop(signum, frame):
            logger.info("rank %d: signal %d; waiting for rank 0's STOP",
                        mesh.rank, signum)

        try:
            signal.signal(signal.SIGTERM, _wait_for_stop)
        except ValueError:  # not the main thread (programmatic use)
            pass
        service.follow()
        return
    service.start(warmup=True)
    try:
        httpd = make_http_server(service, host, port)
    except Exception:  # the port is taken: the followers stop too
        service.stop()
        raise
    logger.info("Serving captions on http://%s:%d (buckets %s, max wait "
                "%.0f ms) — POST image bytes to /caption", host,
                httpd.server_address[1], service.bucket_sizes, max_wait_ms)

    # graceful drain: SIGTERM stops accepting connections; service.stop()
    # then fails still-queued requests instead of hanging their clients
    def _drain(signum, frame):
        logger.info("SIGTERM: draining caption service")
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    service.on_fatal = lambda: threading.Thread(target=httpd.shutdown,
                                                daemon=True).start()
    try:
        signal.signal(signal.SIGTERM, _drain)
    except ValueError:  # not the main thread (programmatic use)
        pass
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()
    if service.fatal is not None:
        raise RuntimeError(f"the caption service's mesh failed: "
                           f"{service.fatal}")
