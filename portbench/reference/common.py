"""Plain PyTorch building blocks of the references: float32, no kernel, no
cache, no batching tricks, and nothing imported from the program.

Every matrix product of a dense layer goes through ``Numerics.mm``, so the
correctness control can run the same reference with its products in fp8
(the step below the bf16 the configurations state, their results stored in
bf16) and nothing else changed. Attention scores and softmax stay float32
in both.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

NEG = -1.0e9


def _fp8(t: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to float8 (e4m3, or e5m2 for gradients) under one
    per-tensor scale (amax onto the format's largest normal), back in
    float32."""
    amax = t.abs().amax().clamp_min(1e-30)
    scale = torch.finfo(fmt).max / amax
    return (t * scale).to(fmt).to(torch.float32) / scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


class _FP8MatMul(torch.autograd.Function):
    """``x @ w^T`` with both operands rounded to fp8 e4m3 and the product
    stored in bf16; in the backward the incoming gradient is rounded to
    fp8 e5m2 (the usual fp8 training recipe) and both products are stored
    in bf16: each of the three products of a dense layer's training step
    in fp8, sums in f32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x), _fp8(w)
        ctx.save_for_backward(xq, wq)
        return _bf16(torch.matmul(xq, wq.t()))

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dq = _fp8(dy, torch.float8_e5m2)
        dx = torch.matmul(dq, wq)
        dw = torch.matmul(dq.reshape(-1, dq.shape[-1]).t(),
                          xq.reshape(-1, xq.shape[-1]))
        return _bf16(dx), _bf16(dw)


class Numerics:
    """How a reference multiplies: ``"f32"`` (TF32 off) or ``"fp8"`` (the
    operands of every dense product rounded to e4m3, f32 sums, the
    product stored in bf16 as the program stores its activations)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self._cache: Dict[int, torch.Tensor] = {}

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return w
        key = id(w)
        if key not in self._cache:
            self._cache[key] = _fp8(w)
        return self._cache[key]

    def mm(self, x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x @ w^T + b`` with ``w`` in the ``nn.Linear`` layout; in fp8
        under autograd the backward's products are fp8 too."""
        if self.precision == "f32":
            y = torch.matmul(x, w.t())
        elif torch.is_grad_enabled() and (x.requires_grad
                                          or w.requires_grad):
            y = _FP8MatMul.apply(x, w)
        else:
            y = _bf16(torch.matmul(_fp8(x), self.weight(w).t()))
        return y if b is None else y + b


def no_tf32():
    """Float32 products in float32: the card would otherwise run them in
    TF32, a lower precision than the reference claims."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def attention(q, k, v, heads: int, mask: Optional[torch.Tensor] = None):
    """q [n, Tq, H], k/v [n, Tk, H]; ``mask`` [Tq, Tk] True = visible."""
    n, Tq, H = q.shape
    Tk = k.shape[1]
    hd = H // heads
    q = q.reshape(n, Tq, heads, hd).transpose(1, 2)
    k = k.reshape(n, Tk, heads, hd).transpose(1, 2)
    v = v.reshape(n, Tk, heads, hd).transpose(1, 2)
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        s = s.masked_fill(~mask, NEG)
    out = torch.matmul(torch.softmax(s, dim=-1), v)
    return out.transpose(1, 2).reshape(n, Tq, H)


def causal(T: int, device) -> torch.Tensor:
    return torch.ones((T, T), dtype=torch.bool, device=device).tril()


def patches(images: torch.Tensor, p: int) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalised float32 patch vectors
    [n, (H/p)(W/p), p*p*3], each flattened in (kh, kw, c) order."""
    mean = torch.tensor((0.485, 0.456, 0.406), device=images.device)
    std = torch.tensor((0.229, 0.224, 0.225), device=images.device)
    x = (images.float() / 255.0 - mean) / std
    n, hi, wi, c = x.shape
    gh, gw = hi // p, wi // p
    x = x[:, :gh * p, :gw * p].reshape(n, gh, p, gw, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, gh * gw, p * p * c)


def beam_search(logits_fn: Callable[[torch.Tensor], torch.Tensor], n: int,
                K: int, bos: int, eos: int, pad: int, L: int,
                length_penalty: float, min_length: int, device):
    """HF ``generate``'s beam search, written out plainly: scores are
    ``sum logprob / length ** length_penalty``; EOS is barred while the
    step is below ``min_length``; a hypothesis finishes only if its EOS
    candidate ranks within the top K of the 2K; an image stops once its K
    finished slots are full and its best running beam, normalised at the
    current length, cannot beat its worst finished one; unfinished beams
    are normalised at ``L - 1``. ``logits_fn(tokens [n*K, t])`` gives the
    next token's logits [n*K, V]. Returns the best hypothesis' tokens
    [n, L] (BOS first, pads after EOS) and its score [n]."""
    seqs = torch.full((n, K, L), pad, dtype=torch.long, device=device)
    seqs[:, :, 0] = bos
    live = torch.full((n, K), NEG, device=device)
    live[:, 0] = 0.0
    fin_seqs = seqs.clone()
    fin = torch.full((n, K), NEG, device=device)
    stopped = torch.zeros(n, dtype=torch.bool, device=device)
    rank_ok = torch.arange(2 * K, device=device)[None] < K
    for t in range(1, L):
        logits = logits_fn(seqs[:, :, :t].reshape(n * K, t))
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(n, K, V)
        if t < min_length:
            logp[:, :, eos] = NEG
        total = (live[:, :, None] + logp).reshape(n, K * V)
        cand, idx = total.topk(2 * K, dim=1)
        cbeam, ctok = idx // V, idx % V
        is_eos = ctok == eos
        norm = float(t) ** length_penalty
        fcand = (cand / norm).masked_fill(~is_eos | ~rank_ok
                                          | stopped[:, None], NEG)
        cseqs = seqs.gather(1, cbeam[:, :, None].expand(n, 2 * K, L)).clone()
        cseqs[:, :, t] = ctok
        fin, fidx = torch.cat([fin, fcand], 1).topk(K, dim=1)
        fin_seqs = torch.cat([fin_seqs, cseqs], 1).gather(
            1, fidx[:, :, None].expand(n, K, L))
        live, lidx = cand.masked_fill(is_eos, NEG).topk(K, dim=1)
        seqs = seqs.gather(1, cbeam.gather(1, lidx)[:, :, None]
                           .expand(n, K, L)).clone()
        seqs[:, :, t] = ctok.gather(1, lidx)
        full = (fin > NEG / 2).all(1)
        best = live.max(1).values / norm
        stopped = stopped | (full & (best <= fin.min(1).values))
        if bool(stopped.all()):
            break
    live_norm = (live / float(L - 1) ** length_penalty).masked_fill(
        stopped[:, None], NEG)
    score, top = torch.cat([fin, live_norm], 1).topk(1, dim=1)
    best = torch.cat([fin_seqs, seqs], 1).gather(
        1, top[:, :, None].expand(n, 1, L))[:, 0]
    return best, score[:, 0]


def sequence_logprobs(logits: torch.Tensor, tokens: torch.Tensor, eos: int,
                      min_length: int) -> torch.Tensor:
    """Per-position log-probabilities [n, T] of ``tokens`` [n, T] under
    ``logits`` [n, T, V] (position t predicts ``tokens[:, t]``), EOS barred
    where the step ``t + 1`` is below ``min_length``, as the search bars
    it."""
    logits = logits.float().clone()
    T = logits.shape[1]
    steps = torch.arange(1, T + 1, device=logits.device)
    logits[:, steps < min_length, eos] = NEG
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(2, tokens[:, :, None])[:, :, 0], logp


def cosine_lr(lr: float, total_steps: int, step: int) -> float:
    """A cosine decay from ``lr`` to 0 over ``total_steps`` (no warmup),
    float32 arithmetic."""
    c = np.float32(min(step, total_steps))
    cos = np.float32(np.cos(np.float32(np.pi) * c / np.float32(total_steps)))
    return float(np.float32(lr) * (np.float32(0.5) * (np.float32(1) + cos)))


class AdamW:
    """AdamW as optax chains it: bias-corrected moments, ``eps`` outside
    the square root, decoupled decay ``lr * wd * p`` on every parameter of
    more than one dimension, the learning rate applied last."""

    def __init__(self, params: Dict[str, torch.Tensor], wd: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.p, self.wd, self.b1, self.b2, self.eps = params, wd, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float):
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                      + self.eps)
            if p.dim() > 1:
                u = u + self.wd * p
            p -= lr * u


def follow_steps(ref, batches, lr_fn, wd: float, block: int,
                 rows: slice = slice(None)):
    """The reference's own training steps from its weights, one per batch
    of (images, captions, mask): the mean CE over the batch's supervised
    tokens (``rows`` of each batch), its gradient by autograd in blocks of
    ``block`` rows, AdamW at ``lr_fn(step)``. Returns each step's loss,
    the first step's gradient and the change over all the steps, by
    leaf."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in ref.w.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    ref.w = params
    opt = AdamW(params, wd)
    losses, first = [], None
    for step, (images, captions, mask) in enumerate(batches):
        images, captions, mask = images[rows], captions[rows], mask[rows]
        count = mask[:, 1:].float().sum()
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for lo in range(0, len(captions), block):
            s, _ = ref.ce_sum(images[lo:lo + block],
                              captions[lo:lo + block], mask[lo:lo + block])
            part = torch.autograd.grad(s / count, list(params.values()),
                                       allow_unused=True)
            for k, g in zip(params, part):
                if g is not None:
                    grads[k] += g
            total += float(s.detach())
        losses.append(total / float(count))
        if step == 0:
            first = {k: g.clone() for k, g in grads.items()}
        opt.step(grads, lr_fn(step))
    deltas = {k: params[k].detach() - start[k] for k in params}
    return {"losses": losses, "grads": first, "deltas": deltas}
