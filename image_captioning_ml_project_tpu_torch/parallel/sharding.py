"""Parameter placement: Megatron tensor parallelism of GPT-2 over the
mesh's model axis, and the collectives the sharded forward runs.

Counterpart of ``image_captioning_ml_project_tpu.parallel.sharding``. The
placements are the JAX package's (:data:`GPT2_TP_RULES`, first match
wins; a dimension that does not divide stays replicated): ``c_attn`` and
``c_fc`` split on their output dimension with their biases, the two
``c_proj`` on their input dimension, everything else replicated. Torch
``nn.Linear`` weights are ``[out, in]``, so the JAX kernel's ``(None,
"model")`` is dim 0 here.

The JAX package shards the packed ``[H, 3H]`` ``c_attn`` kernel
contiguously and lets GSPMD make up for cuts inside a q/k/v block. Here
each rank holds whole heads: its local ``c_attn`` rows are ``[q_r; k_r;
v_r]`` (rank ``r``'s ``H / M`` rows of each block), so its attention runs
``num_heads / M`` heads on its own (:func:`shard_params` permutes, and
:func:`gather_params` undoes it; a tensor-parallel checkpoint is the same
file as a one-process one). The forward then needs one all-reduce after
each row-split product and the backward one before each column-split
product: :func:`reduce_from` (all-reduce forward, identity backward) and
:func:`copy_to` (identity forward, all-reduce backward), each a
``torch.autograd.Function``. Their composition is the differentiable
all-reduce the BatchNorm statistics and the losses' global features go
through (:func:`all_reduce_sum`, :func:`gather_rows`).

:func:`shard_decode_model` shards a decode model (``load_model``'s) the
same way for the service and the demo, which decode on the shards; GPT-2
then decodes on its split path (:mod:`..models.gpt2`).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

# (name regex, placement per dim) over the port's parameter names; first
# match wins
GPT2_TP_RULES: List[Tuple[str, Tuple]] = [
    (r".*attn\.c_attn\.weight$", ("model", None)),
    (r".*attn\.c_attn\.bias$", ("model",)),
    (r".*attn\.c_proj\.weight$", (None, "model")),
    (r".*mlp\.c_fc\.weight$", ("model", None)),
    (r".*mlp\.c_fc\.bias$", ("model",)),
    (r".*mlp\.c_proj\.weight$", (None, "model")),
]

# the packed [q; k; v] projection, sharded head-whole
_QKV = re.compile(r".*attn\.c_attn\.(weight|bias)$")


def infer_param_shardings(shapes: Mapping[str, Tuple[int, ...]],
                          model_size: int,
                          rules: List[Tuple[str, Tuple]] = GPT2_TP_RULES,
                          model_axis: str = "model"
                          ) -> Dict[str, Tuple]:
    """{name: placement} for parameter ``shapes`` by name: a rule's
    placement (``model_axis`` on the split dim, None elsewhere) where the
    model axis is larger than 1, the rule's rank is the tensor's and each
    split dim divides by ``model_size``; ``()`` (replicated) otherwise."""
    out = {}
    for name, shape in shapes.items():
        out[name] = ()
        if model_size <= 1:
            continue
        for pattern, spec in rules:
            if re.match(pattern, name):
                spec = tuple(model_axis if s == "model" else s for s in spec)
                ok = all(s is None or dim % model_size == 0
                         for dim, s in zip(shape, spec))
                if ok and len(spec) == len(shape):
                    out[name] = spec
                break
    return out


def _split_dim(spec: Tuple) -> Optional[int]:
    for d, s in enumerate(spec):
        if s is not None:
            return d
    return None


def shard_tensor(name: str, full: torch.Tensor, spec: Tuple, rank: int,
                 size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``full`` under ``spec``: a contiguous
    chunk of the split dim, or for the packed ``c_attn`` rank ``rank``'s
    chunk of each of its q, k and v blocks, concatenated."""
    d = _split_dim(spec)
    if d is None:
        return full
    if _QKV.match(name):
        return torch.cat([b.chunk(size, d)[rank]
                          for b in full.chunk(3, d)], d).contiguous()
    return full.chunk(size, d)[rank].contiguous()


def unshard_tensor(name: str, shards: List[torch.Tensor], spec: Tuple
                   ) -> torch.Tensor:
    """The full tensor of every rank's :func:`shard_tensor`, in rank
    order."""
    d = _split_dim(spec)
    if d is None:
        return shards[0]
    if _QKV.match(name):
        parts = [s.chunk(3, d) for s in shards]
        return torch.cat([torch.cat([p[i] for p in parts], d)
                          for i in range(3)], d)
    return torch.cat(shards, d)


def _model_coords(mesh) -> Tuple[int, int]:
    if mesh is None:
        return 0, 1
    return mesh.model_rank, mesh.mp


def shard_params(state: Mapping[str, torch.Tensor], mesh,
                 rules: List[Tuple[str, Tuple]] = GPT2_TP_RULES
                 ) -> Dict[str, torch.Tensor]:
    """This rank's local shards of a full state dict (parameters, or an
    optimizer moment by the same names), head-whole for ``c_attn``."""
    rank, size = _model_coords(mesh)
    specs = infer_param_shardings({n: tuple(t.shape)
                                   for n, t in state.items()}, size, rules)
    return {n: shard_tensor(n, t, specs[n], rank, size)
            for n, t in state.items()}


def gather_params(local: Mapping[str, torch.Tensor], mesh,
                  full_shapes: Mapping[str, Tuple[int, ...]],
                  rules: List[Tuple[str, Tuple]] = GPT2_TP_RULES
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`: full tensors (on each
    tensor's own device) from every model rank's local ones, gathered
    through CPU tensors on the model axis's group. ``full_shapes`` names
    the full shapes, which decide each tensor's placement (a name it
    lacks is replicated)."""
    rank, size = _model_coords(mesh)
    specs = infer_param_shardings(dict(full_shapes), size, rules)
    out = {}
    for n, t in local.items():
        if not specs.get(n):
            out[n] = t
            continue
        host = t.detach().cpu().contiguous()
        shards = [torch.empty_like(host) for _ in range(size)]
        dist.all_gather(shards, host, group=mesh.model_group)
        out[n] = unshard_tensor(n, shards, specs[n]).to(t.device)
    return out


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce (sum) of the gradient backward: the
    input of a column-split product (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the output of a
    row-split product (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable: each
    rank's loss reaches every rank's ``x``, so the backward sums the
    gradients too. Where each rank's loss is its share of the global loss
    (the shares summing to it), this is the global batch's gradient."""
    return copy_to(reduce_from(x, group), group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``x`` (the same shape on each) concatenated
    in rank order, differentiable (an all-reduce of the rows placed in a
    zero tensor, so any device and backend takes it). The backward hands
    each rank the summed gradient of its own rows."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[0]
    padded = x.new_zeros((size * n,) + tuple(x.shape[1:]))
    padded = torch.cat([padded[:rank * n], x, padded[(rank + 1) * n:]])
    return all_reduce_sum(padded, group)


def tensor_parallel(model: nn.Module, mesh,
                    rules: List[Tuple[str, Tuple]] = GPT2_TP_RULES
                    ) -> Dict[str, Tuple[int, ...]]:
    """Shard ``model``'s parameters in place over the mesh's model axis
    (its full weights replaced by this rank's :func:`shard_params`) and
    point the GPT-2 attention and MLP blocks whose weights were split at
    the model group, so their forwards run Megatron-style. Returns the
    full shapes by parameter name (for :func:`gather_params`). A no-op
    where the model axis has one rank."""
    full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if mesh is None or mesh.mp <= 1:
        return full_shapes
    specs = infer_param_shardings(full_shapes, mesh.mp, rules)
    local = shard_params(dict(model.named_parameters()), mesh, rules)
    for name, spec in specs.items():
        if not spec:
            continue
        owner, attr = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        setattr(module, attr, nn.Parameter(local[name].detach().clone()))
    for name, module in model.named_modules():
        if not hasattr(module, "tp_group"):
            continue
        split = [specs.get(f"{name}.{p}", ()) for p in module.tp_params]
        if all(split):
            heads = getattr(module, "num_heads", mesh.mp)
            if heads % mesh.mp:
                raise ValueError(f"{name}: {heads} heads do not divide over "
                                 f"{mesh.mp} model ranks")
            module.tp_group = mesh.model_group
        elif any(split):
            raise ValueError(f"{name}: its weights split only in part "
                             f"({module.tp_params}: {split})")
    return full_shapes


def shard_decode_model(model: nn.Module, mesh) -> nn.Module:
    """A decode model (:func:`..models.captioning_model.load_model`'s) on
    this rank's shards: :func:`tensor_parallel` where the mesh's model axis
    is larger than 1, the shards frozen, and the GPT-2 decoder's
    layer-stacked operands dropped (the whole-stack kernel cannot run on a
    shard, so they would only hold the full weights). Returns ``model``."""
    if mesh is None or mesh.mp <= 1:
        return model
    tensor_parallel(model, mesh)
    model.requires_grad_(False)
    decoder = getattr(model, "decoder", None)
    if getattr(decoder, "stack", None) is not None:
        decoder.stack = None
    return model
