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
  them while the batcher runs batch N+1 (``pipeline_depth``).

The HTTP layer is ``http.server``: POST image bytes to ``/caption``; GET
``/healthz``, ``/stats`` and ``/metrics``. Checkpoint reload is not yet
ported and answers with an error.
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

from ..data.coco import center_crop_resize
from ..models.captioning_model import load_model
from .decoding import beam_search

logger = logging.getLogger(__name__)

_NOT_PORTED_RELOAD = ("checkpoint restore is not yet ported to PyTorch "
                      "(ROADMAP.md Queue 1: checkpoints and /reload)")


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


class CaptionService:
    """Micro-batching caption service around the port's beam-search decode.

    ``submit(image)`` blocks until the request's batch has run;
    ``submit_async``/``result`` let one caller keep many requests in
    flight. The model is built on ``device`` from ``params`` (the JAX
    package's variable tree) or, when None, from ``config.seed``, and cast
    to ``config.model.dtype``. Only the beam strategy of
    ``config.inference`` is ported.
    """

    def __init__(self, config, tokenizer, device, params=None,
                 checkpoint_path: Optional[str] = None, batch_size: int = 8,
                 max_wait_ms: float = 10.0, request_timeout_s: float = 60.0,
                 pipeline_depth: int = 2, bucket_sizes=None):
        ic = config.inference
        if checkpoint_path:
            raise NotImplementedError(_NOT_PORTED_RELOAD)
        if ic.decoding_strategy != "beam" or ic.num_beam_groups != 1:
            raise NotImplementedError(
                f"decoding strategy {ic.decoding_strategy!r} with "
                f"{ic.num_beam_groups} beam group(s) is not yet ported "
                f"(ROADMAP.md Queue 1: greedy, sampling and diverse decodes)")
        if ic.use_clip_reranking:
            raise NotImplementedError(
                "CLIP reranking is not yet ported (ROADMAP.md Queue 1: "
                "reranking)")
        self.config = config
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.model = load_model(config, self.device, params=params)
        self.batch_size = batch_size
        # bucketed batch shapes: a quiet-hour single request should not pay
        # a full batch_size-wide decode; rows are independent, so captions
        # are identical across buckets
        if bucket_sizes is None:
            bucket_sizes = [1, 8, batch_size]
        buckets = sorted({min(int(b), batch_size)
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

    # -- lifecycle ---------------------------------------------------------

    def start(self, warmup: bool = True):
        """Run every bucket once (optional: builds the kernels, fills the
        allocator's cache) and start the batcher."""
        if warmup:
            t0 = time.monotonic()
            size = self.config.image_size
            dummy = np.zeros((size, size, 3), dtype=np.uint8)
            for b in self.bucket_sizes:
                self._run_images([dummy] * b)
            logger.info("Serving warmup: %.1fs (buckets %s)",
                        time.monotonic() - t0, self.bucket_sizes)
        self._stop.clear()
        self._thread = threading.Thread(target=self._batch_loop,
                                        name="caption-batcher", daemon=True)
        self._thread.start()
        if not self._sync:
            self._completer = threading.Thread(target=self._complete_loop,
                                               name="caption-completer",
                                               daemon=True)
            self._completer.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._completer is not None:
            self._completer.join(timeout=30)
            self._completer = None
        # fail any stragglers still queued or in flight
        for q in (self._pending, self._queue):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                reqs = item[0] if isinstance(item, tuple) else [item]
                for req in reqs:
                    req.error = "server shutting down"
                    req.event.set()

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
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            reqs = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(reqs) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    reqs.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._serve_batch(reqs)

    def _serve_batch(self, reqs: List[_Request]):
        self.stats.record_batch(len(reqs))
        try:
            tokens = self._dispatch([r.image for r in reqs])
        except Exception as e:  # surface the failure to every caller
            logger.exception("serving batch dispatch failed")
            for req in reqs:
                req.error = f"{type(e).__name__}: {e}"
                req.event.set()
            return
        if self._sync:
            self._complete_batch(reqs, tokens)
            return
        # bounded put = pipeline-depth backpressure; poll _stop so a
        # shutdown with a stalled completer cannot wedge the batcher here
        while not self._stop.is_set():
            try:
                self._pending.put((reqs, tokens), timeout=0.1)
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

    def _complete_batch(self, reqs, tokens):
        try:
            tokens = tokens.cpu().numpy()
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
        """Beam-search captions for a device batch: tokens [B, L]."""
        mc, ic = self.config.model, self.config.inference
        steps = 0

        def step_fn(state, tokens):
            nonlocal steps
            steps += 1
            return self.model.step(state, tokens)

        state = self.model.init_cache(images, ic.max_length)
        res = beam_search(step_fn, state, images.shape[0], ic.beam_size,
                          mc.bos_token_id, mc.eos_token_id, mc.pad_token_id,
                          ic.max_length, length_penalty=ic.length_penalty,
                          min_length=ic.min_length)
        self.stats.record_steps(steps)
        return res.tokens

    def _dispatch(self, images: List[np.ndarray]) -> torch.Tensor:
        """Pad to the smallest bucket >= the micro-batch and decode it on the
        device; returns the device tokens."""
        if len(images) > self.batch_size:
            raise ValueError(f"micro-batch of {len(images)} exceeds "
                             f"batch_size {self.batch_size}")
        bucket = next(b for b in self.bucket_sizes if b >= len(images))
        batch = np.stack(images + [images[-1]] * (bucket - len(images)))
        with torch.inference_mode():
            return self._decode(torch.from_numpy(batch).to(self.device))

    def _run_images(self, images: List[np.ndarray]) -> List[str]:
        """Synchronous decode of any number of images (warmup /
        programmatic use), in ``batch_size`` chunks."""
        captions: List[str] = []
        for lo in range(0, len(images), self.batch_size):
            chunk = images[lo:lo + self.batch_size]
            tokens = self._dispatch(chunk).cpu().numpy()
            captions.extend(
                self.tokenizer.decode(tokens[i], skip_special_tokens=True)
                for i in range(len(chunk)))
        return captions


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
                self._reply(501, {"error": _NOT_PORTED_RELOAD})
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
          checkpoint_path: Optional[str] = None):
    """CLI entry: build the service, warm it up, and serve forever."""
    service = CaptionService(config, tokenizer, device,
                             checkpoint_path=checkpoint_path,
                             batch_size=batch_size, max_wait_ms=max_wait_ms,
                             pipeline_depth=pipeline_depth,
                             bucket_sizes=bucket_sizes)
    service.start(warmup=True)
    httpd = make_http_server(service, host, port)
    logger.info("Serving captions on http://%s:%d (buckets %s, max wait "
                "%.0f ms) — POST image bytes to /caption", host,
                httpd.server_address[1], service.bucket_sizes, max_wait_ms)

    # graceful drain: SIGTERM stops accepting connections; service.stop()
    # then fails still-queued requests instead of hanging their clients
    import signal

    def _drain(signum, frame):
        logger.info("SIGTERM: draining caption service")
        threading.Thread(target=httpd.shutdown, daemon=True).start()

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
