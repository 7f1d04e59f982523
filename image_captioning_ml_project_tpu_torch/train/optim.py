"""Optimizer and LR schedules, computed as optax computes them.

Counterpart of ``image_captioning_ml_project_tpu.train.optim``: AdamW with
weight decay on every parameter of more than one dimension, the three
schedules (linear warmup then linear decay, linear warmup then cosine
decay, and StepLR(total/3, gamma=0.1)), and optional global-norm
clipping. Written from optax's arithmetic, not torch's defaults:

* the schedules are evaluated in float32 as optax's ``join_schedules`` /
  ``linear_schedule`` / ``cosine_decay_schedule`` /
  ``piecewise_constant_schedule`` trace them (the linear warmup gives lr 0
  at step 0);
* :class:`AdamW` is optax's ``chain(scale_by_adam, add_decayed_weights,
  scale_by_learning_rate)``: bias-corrected moments, ``eps`` outside the
  square root, decoupled decay ``lr * wd * p`` on the mask, the first
  moment stored in bfloat16 when ``adam_mu_dtype`` says so; a parameter
  with a zero gradient (a frozen encoder's) still decays, where
  ``torch.optim.AdamW`` would skip one whose ``.grad`` is None;
* clipping is optax's ``clip_by_global_norm``: ``g / norm * max_norm``
  where the norm reaches ``max_norm`` (no ``+1e-6`` as in
  ``clip_grad_norm_``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_F32 = np.float32


def no_decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies: parameters of more than one
    dimension (biases, norm scales and other vectors are excluded)."""
    return {name: p.ndim > 1 for name, p in params.items()}


def _linear(init: float, end: float, steps: int) -> Callable:
    """optax.linear_schedule (polynomial, power 1) in float32."""
    if steps <= 0:
        return lambda count: _F32(init)

    def schedule(count):
        c = _F32(min(max(count, 0), steps))
        frac = _F32(1) - c / _F32(steps)
        return _F32(init - end) * frac + _F32(end)

    return schedule


def _cosine(init: float, decay_steps: int) -> Callable:
    """optax.cosine_decay_schedule (alpha 0, exponent 1) in float32."""
    def schedule(count):
        c = _F32(min(count, decay_steps))
        cos = _F32(np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        decayed = _F32(0.5) * (_F32(1) + cos)
        return _F32(init) * (_F32(1.0) * decayed + _F32(0.0))

    return schedule


def _join(schedules: List[Callable], boundaries: List[int]) -> Callable:
    """optax.join_schedules."""
    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def _piecewise(init: float, boundaries_and_scales: Dict[int, float]
               ) -> Callable:
    """optax.piecewise_constant_schedule in float32."""
    def schedule(count):
        v = _F32(init)
        for threshold, scale in sorted(boundaries_and_scales.items()):
            indicator = _F32(max(0.0, np.sign(threshold - count)))
            v = v * indicator + (_F32(1) - indicator) * _F32(scale) * v
        return _F32(v)

    return schedule


def create_learning_rate_schedule(config, total_steps: int) -> Callable:
    """step (int) -> learning rate (float32), as the JAX package's
    schedule of the same ``TrainingConfig``."""
    lr = config.learning_rate
    warmup = min(config.warmup_steps, max(total_steps - 1, 1))
    if config.lr_scheduler == "linear":
        return _join([_linear(0.0, lr, warmup),
                      _linear(lr, 0.0, max(total_steps - warmup, 1))],
                     [warmup])
    if config.lr_scheduler == "cosine":
        return _join([_linear(0.0, lr, warmup),
                      _cosine(lr, max(total_steps - warmup, 1))], [warmup])
    # StepLR: decay x0.1 three times over training
    step_size = max(total_steps // 3, 1)
    return _piecewise(lr, {step_size: 0.1, 2 * step_size: 0.1,
                           3 * step_size: 0.1})


def sum_of_squares(grads: List[torch.Tensor]) -> torch.Tensor:
    """The sum of every gradient's squared entries, in f32 (0 for none).

    On CUDA one ``_foreach_norm`` (a few multi-tensor launches for the
    whole list, f32 partial sums reduced as a tree). On the CPU each
    tensor's sum of squares is a ``sum``: there ``_foreach_norm`` and
    ``vector_norm`` accumulate in one f32 running sum, 2.7e-3 off on a
    tensor of 38 M normal entries (GPT-2's embedding), its ``sum`` 5e-8
    (torch 2.13, against a float64 sum)."""
    if not grads:
        return torch.zeros(())
    if grads[0].is_cuda:
        return torch.stack(torch._foreach_norm(
            [g.float() for g in grads])).square().sum()
    return torch.stack([g.float().square().sum() for g in grads]).sum()


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of :func:`sum_of_squares`."""
    return sum_of_squares(grads).sqrt()


class AdamW:
    """optax.adamw over named parameters (updated in place; decay on
    :func:`no_decay_mask`), with optional global-norm clipping before
    it.

    ``step(grads)`` takes one gradient per parameter (zeros where the
    loss does not reach one) and returns the global norm of the
    unclipped gradients. ``state_dict()`` holds ``count`` (the updates
    taken, optax's shared count of Adam and the schedule) and the
    moments ``mu`` and ``nu`` by parameter name."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Callable,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None,
                 clip_norm: float = 0.0,
                 norm_fn: Callable[[List[torch.Tensor]], torch.Tensor]
                 = global_norm):
        self.params = params
        # the gradients' global norm, given them in ``names`` order (a
        # tensor-parallel trainer's sums the shards over the model axis)
        self.norm_fn = norm_fn
        self.names = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.mask = no_decay_mask(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip_norm = clip_norm
        self.count = 0
        self.mu_dtype = mu_dtype
        self.mu = {n: torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        names = self.names
        g = [grads[n] for n in names]
        norm = self.norm_fn(g)
        if self.clip_norm and self.clip_norm > 0:
            trigger = norm < self.clip_norm
            g = [torch.where(trigger, t, (t / norm) * self.clip_norm)
                 for t in g]
        b1, b2 = self.b1, self.b2
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        # (1 - b) * g^order + b * moment. For a bf16 first moment optax
        # multiplies by b rounded to bf16 (a weak-typed Python float takes
        # the array's dtype), and XLA keeps the product's f32 precision
        # into the f32 sum
        mb1 = (b1 if self.mu_dtype is None
               else torch.tensor(b1, dtype=self.mu_dtype).item())
        mu_new = torch._foreach_add(
            torch._foreach_mul(g, 1 - b1),
            torch._foreach_mul([m.float() for m in mu], mb1))
        nu_new = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
            torch._foreach_mul(nu, b2))
        count = self.count + 1
        # 1 - decay ** count in float32, as optax's bias correction
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu_new, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = list(torch._foreach_div(torch._foreach_div(mu_new, bc1),
                                          denom))
        decay = [i for i, n in enumerate(names) if self.mask[n]]
        if self.weight_decay and decay:
            decayed = torch._foreach_add(
                [updates[i] for i in decay],
                torch._foreach_mul([self.params[names[i]] for i in decay],
                                   self.weight_decay))
            for i, u in zip(decay, decayed):
                updates[i] = u
        step_size = float(_F32(-1) * _F32(self.schedule(self.count)))
        torch._foreach_mul_(updates, step_size)
        torch._foreach_add_([self.params[n] for n in names], updates)
        for n, m, v in zip(names, mu_new, nu_new):
            self.mu[n] = m.to(self.mu[n].dtype)
            self.nu[n] = v
        self.count = count
        return norm

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Copy a :meth:`state_dict` (from a checkpoint, any device) into
        this optimizer's moments, keeping their dtypes."""
        self.count = int(state["count"])
        for key in ("mu", "nu"):
            mine = getattr(self, key)
            theirs = state[key]
            if set(theirs) != set(mine):
                raise KeyError(f"optimizer state {key} has parameters "
                               f"{sorted(set(theirs) ^ set(mine))} that "
                               f"differ from the model's")
            for n, t in theirs.items():
                mine[n] = t.to(mine[n].device, mine[n].dtype).clone()


def create_optimizer(config, total_steps: int,
                     params: Dict[str, torch.Tensor],
                     norm_fn: Callable[[List[torch.Tensor]], torch.Tensor]
                     = global_norm) -> Tuple[AdamW, Callable]:
    """(AdamW over ``params``, its schedule) for a ``TrainingConfig``;
    ``norm_fn`` as :class:`AdamW`'s."""
    schedule = create_learning_rate_schedule(config, total_steps)
    mu_dtype = (torch.bfloat16
                if getattr(config, "adam_mu_dtype", "float32") == "bfloat16"
                else None)
    return AdamW(params, schedule, config.weight_decay, mu_dtype=mu_dtype,
                 clip_norm=config.grad_clip_norm,
                 norm_fn=norm_fn), schedule
