"""Process mesh: data parallelism and Megatron tensor parallelism over
``torch.distributed``, one process per rank.

Counterpart of ``image_captioning_ml_project_tpu.parallel.mesh``. The JAX
package builds a ``(data, model)`` mesh of devices and lets one GSPMD
program run over it; here each rank is a process (``torchrun``, or spawned
by a test), and the mesh is the process group split along the two axes:
rank ``r`` sits at data index ``r // model`` and model index ``r % model``
(the JAX mesh's ``devices.reshape(data, model)``), with one
``new_group`` per data row and per model column.

* :func:`mesh_shape` is the JAX ``create_mesh``'s axis arithmetic (``-1``
  absorbs what the other axis leaves; the product must be the rank count);
* :func:`replicate` broadcasts a module's weights, or a state tree, from
  rank 0: every rank draws the same seeded weights, and rank 0's win;
* :func:`batch_rows` is this rank's slice of a global batch: rows
  ``[r * B / dp, (r + 1) * B / dp)`` for data rank ``r``, as the JAX
  ``batch_sharding`` places them;
* :func:`gather_rows_host` is the inverse on the host: numpy rows of every
  data rank, in rank order, through CPU tensors (a gloo group takes CUDA
  tensors only for ``all_reduce`` and ``broadcast``);
* :func:`broadcast_host` carries the caption service's host batch
  (:mod:`..inference.server`) from rank 0 to every rank over the whole
  group, as a CPU tensor (``init_distributed``'s ``cpu:gloo,cuda:nccl``
  sends it over gloo in any case); the service's small commands and
  statuses go as objects (``broadcast_object_list``,
  ``all_gather_object``).

No mesh means no process group: a run without ``WORLD_SIZE`` is one
process with ``mesh=None``, the JAX package's one-device mesh.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig


def mesh_shape(mesh_config: Optional[MeshConfig], n: int) -> Tuple[int, int]:
    """(data, model) sizes of ``mesh_config`` over ``n`` ranks: a size of
    ``-1`` (or 0) takes what the other leaves, both ``-1`` is pure data
    parallelism; the product must be ``n`` (an ``AssertionError``
    otherwise, as the JAX ``create_mesh``)."""
    mesh_config = mesh_config or MeshConfig()
    dp, mp = mesh_config.data_parallel, mesh_config.model_parallel
    if dp <= 0 and mp <= 0:
        dp, mp = n, 1
    elif mp <= 0:
        mp = n // dp
    elif dp <= 0:
        dp = n // mp
    assert dp * mp == n, f"mesh {dp}x{mp} does not cover {n} devices"
    return dp, mp


@dataclass
class Mesh:
    """This rank's view of the mesh: the axis sizes by name (``shape``,
    as a JAX mesh's), its index along each axis and the process group of
    the ranks that differ from it only along that axis."""

    shape: Dict[str, int]
    data_axis: str
    model_axis: str
    rank: int
    coords: Dict[str, int] = field(default_factory=dict)
    groups: Dict[str, Any] = field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def dp(self) -> int:
        return self.size(self.data_axis)

    @property
    def mp(self) -> int:
        return self.size(self.model_axis)

    @property
    def data_rank(self) -> int:
        return self.index(self.data_axis)

    @property
    def model_rank(self) -> int:
        return self.index(self.model_axis)

    @property
    def data_group(self):
        return self.groups[self.data_axis]

    @property
    def model_group(self):
        return self.groups[self.model_axis]


def create_mesh(mesh_config: Optional[MeshConfig] = None) -> Mesh:
    """The ``(data, model)`` mesh over the initialised process group's
    ranks (:func:`mesh_shape`). Every rank must call it, in the same
    order as its other ``new_group`` calls."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(init_distributed)")
    mesh_config = mesh_config or MeshConfig()
    n, rank = dist.get_world_size(), dist.get_rank()
    dp, mp = mesh_shape(mesh_config, n)
    data_axis, model_axis = mesh_config.data_axis, mesh_config.model_axis
    grid = np.arange(n).reshape(dp, mp)
    groups = {}
    # every rank creates every group, data columns first, then model rows
    for m in range(mp):
        g = dist.new_group([int(r) for r in grid[:, m]])
        if rank in grid[:, m]:
            groups[data_axis] = g
    for d in range(dp):
        g = dist.new_group([int(r) for r in grid[d]])
        if rank in grid[d]:
            groups[model_axis] = g
    return Mesh(shape={data_axis: dp, model_axis: mp}, data_axis=data_axis,
                model_axis=model_axis, rank=rank,
                coords={data_axis: rank // mp, model_axis: rank % mp},
                groups=groups)


def init_distributed(rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     timeout_s: float = 1800.0
                     ) -> Optional[Tuple[int, int, int]]:
    """Start the process group from the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``),
    or from the arguments (a ``file://`` or ``tcp://`` ``init_method``).
    Returns (rank, world size, local rank), or None when there is nothing
    to start (no ``WORLD_SIZE`` and no arguments): one process, no mesh.

    With at least one card per local rank the group is ``cpu:gloo,
    cuda:nccl``; where local ranks share a card (NCCL refuses two ranks on
    one device) or on the CPU, gloo."""
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return None
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if not dist.is_initialized():
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = "gloo"
        if cards >= local_world:
            backend = "cpu:gloo,cuda:nccl"
            torch.cuda.set_device(local_rank)
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout_s))
    return rank, world_size, local_rank


def rank_device(device: str, local_rank: int) -> str:
    """The device of local rank ``local_rank`` for a ``--device`` value:
    ``cuda:{local_rank % cards}`` for CUDA (ranks share cards round
    robin), the CPU as it is."""
    if torch.device(device).type != "cuda":
        return device
    return f"cuda:{local_rank % torch.cuda.device_count()}"


def replicate(obj, mesh: Optional[Mesh], src: int = 0):
    """Broadcast from global rank ``src``: a module's parameters and
    buffers in place, or every tensor of a (nested dict) state tree in
    place. Returns ``obj``; without a mesh, ``obj`` as it is."""
    if mesh is None:
        return obj
    if isinstance(obj, torch.nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    else:
        tensors = _leaves(obj)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src)
    return obj


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def batch_rows(batch_size: int, mesh: Optional[Mesh],
               data_axis: Optional[str] = None) -> slice:
    """This rank's rows of a global batch of ``batch_size``: the
    ``data_axis`` index's contiguous ``batch_size / dp`` (all of them
    without a mesh). The batch must divide; the trainers round their
    batches up to the data axis and pad them."""
    if mesh is None:
        return slice(0, batch_size)
    axis = data_axis or mesh.data_axis
    dp = mesh.size(axis)
    if batch_size % dp:
        raise ValueError(f"a batch of {batch_size} does not divide over "
                         f"the {dp} ranks of the {axis!r} axis")
    n = batch_size // dp
    r = mesh.index(axis)
    return slice(r * n, (r + 1) * n)


def gather_rows_host(rows: np.ndarray, mesh: Optional[Mesh],
                     data_axis: Optional[str] = None) -> np.ndarray:
    """Every data rank's ``rows`` (the same shape on each), concatenated
    in rank order on the host: the global batch a :func:`batch_rows`
    split came from. Through CPU tensors on the data axis's group."""
    if mesh is None:
        return np.asarray(rows)
    axis = data_axis or mesh.data_axis
    if mesh.size(axis) == 1:
        return np.asarray(rows)
    t = torch.from_numpy(np.ascontiguousarray(rows))
    out = [torch.empty_like(t) for _ in range(mesh.size(axis))]
    dist.all_gather(out, t, group=mesh.group(axis))
    return torch.cat(out).numpy()


def all_reduce_host(values: np.ndarray, mesh: Optional[Mesh],
                    axis: Optional[str] = None) -> np.ndarray:
    """The sum over ``axis``'s ranks (the data axis by default) of a small
    float64 host array, through a CPU tensor."""
    values = np.asarray(values, dtype=np.float64)
    if mesh is None or mesh.size(axis or mesh.data_axis) == 1:
        return values
    t = torch.from_numpy(values.copy())
    dist.all_reduce(t, group=mesh.group(axis or mesh.data_axis))
    return t.numpy()


def broadcast_host(array: Optional[np.ndarray], shape, dtype,
                   mesh: Mesh) -> np.ndarray:
    """Global rank 0's host ``array`` of ``shape`` and numpy ``dtype`` on
    every rank (the others pass None), through a CPU tensor."""
    if mesh.rank == 0:
        array = np.ascontiguousarray(array, dtype=dtype)
        if array.shape != tuple(shape):
            raise ValueError(f"broadcast of {array.shape}, announced as "
                             f"{tuple(shape)}")
        t = torch.from_numpy(array)
    else:
        t = torch.from_numpy(np.empty(shape, dtype=dtype))
    dist.broadcast(t, 0)
    return t.numpy()
