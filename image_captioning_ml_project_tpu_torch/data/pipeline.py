"""Host -> device data pipeline: background prefetch, and this rank's
rows of a host batch under a mesh.

Counterpart of ``image_captioning_ml_project_tpu.data.pipeline``: a
background thread takes the host batch iterator's next batch while the
device runs the current one, pins its arrays' host memory and copies them
to the device with ``non_blocking`` copies, keeping ``size`` batches in
flight. Non-array fields (captions, ids as lists) pass through. Under a
mesh the iterator itself yields this rank's rows of each batch
(``iterate_batches(rows=)``), so a rank decodes only its own images;
:func:`shard_batch` cuts a host batch that was made whole. The lists stay
whole, as in the JAX package, which places only the arrays' row blocks
on the devices of its mesh.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch

from ..parallel.mesh import batch_rows
from ..utils.profiling import span


def shard_batch(batch: Dict[str, Any], mesh,
                data_axis: str = "data") -> Dict[str, Any]:
    """This rank's rows (:func:`..parallel.mesh.batch_rows` over
    ``data_axis``) of every array field of a host batch; the other fields
    as they are. Without a mesh, the batch itself."""
    if mesh is None:
        return batch
    return {k: v[batch_rows(len(v), mesh, data_axis)]
            if isinstance(v, np.ndarray) and v.ndim else v
            for k, v in batch.items()}


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Every numpy array of ``batch`` as a tensor on ``device`` (through
    pinned host memory and a ``non_blocking`` copy on a CUDA device); the
    other fields as they are."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
        else:
            out[k] = v
    return out


def prefetch(iterator: Iterator[Dict[str, Any]], device="cpu",
             size: int = 2) -> Iterator[Dict[str, Any]]:
    """Wrap a host batch iterator with background-thread prefetch and
    device placement; ``size`` batches are made and sent ahead. The copies
    run on the thread's own CUDA stream and the consumer's stream waits
    for each batch's event before it reads it."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()
    err: list = []
    # Abandonment-safe: if the consumer stops iterating mid-epoch, the
    # generator's finally sets `stop`, the producer unblocks from its
    # bounded put, and the wrapped iterator is close()d so its own finally
    # runs (iterate_batches shuts down its worker pool).
    stop = threading.Event()
    stream = (torch.cuda.Stream(device) if device.type == "cuda" else None)

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                event = None
                with span("data.upload"):
                    if stream is not None:
                        with torch.cuda.stream(stream):
                            batch = to_device(batch, device)
                            event = torch.cuda.Event()
                            event.record(stream)
                    else:
                        batch = to_device(batch, device)
                if not _put((batch, event)):
                    break
        except Exception as e:  # propagate to consumer
            err.append(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
            _put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            with span("data.wait"):
                item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            batch, event = item
            if event is not None:
                torch.cuda.current_stream(device).wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(torch.cuda.current_stream(device))
            yield batch
    finally:
        stop.set()
        t.join(timeout=10)
