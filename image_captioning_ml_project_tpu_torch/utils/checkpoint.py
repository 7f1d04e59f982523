"""Checkpoints in torch's own format: training state + best-CIDEr policy.

Counterpart of ``image_captioning_ml_project_tpu.utils.checkpoint`` with
every behaviour of its Orbax store, on ``torch.save``:

* a checkpoint is a directory holding one ``torch.save`` file per
  top-level key of the state (``params.pt``, ``batch_stats.pt``,
  ``opt_state.pt``, ``step.pt`` for the trainer's state), beside a
  ``<name>.meta.json`` sidecar with the config and scalar metadata;
* a save writes a temporary directory and renames it into place, so a
  crash never leaves a half-written checkpoint under the final name;
* ``async_save=True`` stages the state to host memory, then writes it on a
  background thread; ``restore``, ``restore_partial`` and ``exists`` drain
  an in-flight save first;
* the rolling mid-epoch checkpoint alternates between the two
  :data:`STEP_SLOTS`, so the newest committed one is never the target of
  a save;
* :meth:`CheckpointManager.restore_partial` reads only the files asked for
  (a reload's weights, never the optimizer's bytes), memory-mapped.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from ..config import Config, config_to_dict

# Physical slots behind the logical rolling step checkpoint: a crash during
# a save can only lose the slot being written, never the newest committed
# save (the JAX store's reason: a single rolling name lost both saves to a
# host kill mid-save).
STEP_SLOTS = ("checkpoint_step_0", "checkpoint_step_1")
# accepted on restore for checkpoints written before the two-slot scheme
_LEGACY_STEP = "checkpoint_step"


def _step_sort_key(directory: str, name: str):
    """Recency key for a committed step checkpoint: optimizer step if the
    sidecar recorded it, else (epoch, phase, batch) — both monotonic over
    a run. The sidecar alone does not prove a commit (it is written as
    soon as the save is staged); callers must check the directory."""
    meta_path = os.path.join(directory, name + ".meta.json")
    m = {}
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                m = json.load(f).get("metadata", {})
        except (OSError, ValueError):
            m = {}
    return (m.get("step", -1), m.get("epoch", -1),
            1 if m.get("phase") == "scst" else 0, m.get("batch_index", -1))


def latest_step_checkpoint(directory: str) -> Optional[str]:
    """Name of the newest COMMITTED rolling step checkpoint in
    ``directory`` (two-slot scheme + the legacy single name), or None.
    Committed = the checkpoint directory exists: a save renames its
    temporary directory into place only once every file is written."""
    candidates = [n for n in STEP_SLOTS + (_LEGACY_STEP,)
                  if os.path.isdir(os.path.join(directory, n))]
    if not candidates:
        return None
    return max(candidates, key=lambda n: _step_sort_key(directory, n))


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor on the CPU, detached, and
    Python scalars as they are: the staged state an async save writes
    while training moves on."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointManager:
    """Checkpoint store under ``directory``.

    With ``async_save=True``, :meth:`save` returns once the state is
    staged to host memory; the files and the atomic rename are written by
    a background thread, so the next epoch's compute overlaps the disk
    write. Callers should :meth:`wait_until_finished` before the process
    exits (the trainer does); a failed background save raises there.
    """

    def __init__(self, directory: str, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.async_save = async_save
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, name: str) -> str:
        """Names are keys within the checkpoint dir; anything spelled as a
        path (absolute or containing a separator) is used verbatim so
        ``--checkpoint runs/x/best_model`` does not silently resolve under
        ``checkpoint_dir``. Bare names always resolve under the directory —
        resolution must not depend on what happens to exist in the CWD."""
        if os.path.isabs(name) or os.sep in name:
            return os.path.abspath(name)
        return os.path.join(self.directory, name)

    @staticmethod
    def _write(path: str, state: Dict[str, Any]) -> None:
        """Every top-level key to its file in a temporary directory, then
        the directory renamed into place (an older one moved aside
        first and removed after)."""
        parent = os.path.dirname(path)
        os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for key, value in state.items():
            torch.save(value, os.path.join(tmp, f"{key}.pt"))
        old = None
        if os.path.exists(path):
            old = f"{tmp}.old"
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)

    def _run(self, path: str, state: Dict[str, Any]) -> None:
        try:
            self._write(path, state)
        except BaseException as e:  # raised by wait_until_finished
            self._error = e

    def save(self, name: str, state: Dict[str, Any],
             metadata: Optional[Dict[str, Any]] = None,
             config: Optional[Config] = None):
        """Save ``state`` (a dict of state dicts, tensors and scalars)
        under ``name`` (overwrites), with its JSON sidecar."""
        path = self._path(name)
        self.wait_until_finished()
        staged = _to_host(state)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._run, args=(path, staged),
                name="checkpoint-writer", daemon=True)
            self._thread.start()
        else:
            self._write(path, staged)
        side = {"metadata": metadata or {}}
        if config is not None:
            side["config"] = config_to_dict(config)
        with open(path + ".meta.json", "w") as f:
            json.dump(side, f)

    def wait_until_finished(self):
        """Drain any in-flight async save (no-op for sync saves); raise
        what a failed one raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save_step(self, state: Dict[str, Any],
                  metadata: Optional[Dict[str, Any]] = None,
                  config: Optional[Config] = None) -> str:
        """Rolling step checkpoint into the slot NOT holding the newest
        committed save, so a crash during this save can only lose a stale
        slot, never the latest durable state. Returns the slot written."""
        self.wait_until_finished()
        newest = latest_step_checkpoint(self.directory)
        slot = STEP_SLOTS[1] if newest == STEP_SLOTS[0] else STEP_SLOTS[0]
        self.save(slot, state, metadata, config)
        return slot

    def _resolve(self, name: str) -> str:
        """The logical rolling name resolves to the newest committed slot
        when no literal (legacy) checkpoint of that name exists."""
        if name == _LEGACY_STEP and not os.path.isdir(self._path(name)):
            latest = latest_step_checkpoint(self.directory)
            if latest is not None:
                return latest
        return name

    def _sidecar(self, path: str):
        meta_path = path + ".meta.json"
        side = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                side = json.load(f)
        return side.get("metadata", {}), side.get("config")

    def _load(self, path: str, keys, mmap: bool) -> Dict[str, Any]:
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        out = {}
        for key in keys:
            out[key] = torch.load(os.path.join(path, f"{key}.pt"),
                                  map_location="cpu", weights_only=True,
                                  mmap=mmap)
        return out

    def restore(self, name: str, target: Optional[Dict[str, Any]] = None):
        """(state, metadata, config dict) of checkpoint ``name``: every
        file, or the top-level keys of ``target`` only. Tensors come back
        on the CPU."""
        self.wait_until_finished()
        path = self._path(self._resolve(name))
        keys = (list(target) if target is not None
                else sorted(f[:-3] for f in os.listdir(path)
                            if f.endswith(".pt")))
        state = self._load(path, keys, mmap=False)
        return (state, *self._sidecar(path))

    def restore_partial(self, name: str, target: Dict[str, Any]):
        """Restore only the top-level keys of ``target`` (for a reload:
        ``params`` and ``batch_stats``), memory-mapped, reading none of
        the other files: the optimizer moments are two thirds of an AdamW
        checkpoint's bytes and a serving swap never needs them. A key the
        checkpoint lacks is left out of the result."""
        self.wait_until_finished()
        path = self._path(self._resolve(name))
        keys = [k for k in target
                if os.path.exists(os.path.join(path, f"{k}.pt"))]
        state = self._load(path, keys, mmap=True)
        return (state, *self._sidecar(path))

    def model_weights(self, name: str) -> Dict[str, Any]:
        """The model's weights in checkpoint ``name`` as one state dict:
        its params and BatchNorm statistics, memory-mapped, without the
        optimizer's files (:meth:`restore_partial`)."""
        restored, _, _ = self.restore_partial(
            name, {"params": None, "batch_stats": None})
        state = dict(restored["params"]["model"])
        state.update(restored.get("batch_stats", {}))
        return state

    def exists(self, name: str) -> bool:
        self.wait_until_finished()
        return os.path.exists(self._path(self._resolve(name)))

    def save_epoch(self, epoch: int, state, metadata=None, config=None,
                   is_best: bool = False):
        """Epoch checkpoint + optional ``best_model``
        (reference policy: src/train/trainer.py:190-198)."""
        self.save(f"checkpoint_epoch_{epoch + 1}", state, metadata, config)
        if is_best:
            self.save("best_model", state, metadata, config)
