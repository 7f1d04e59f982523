"""Legacy training loop: the baseline "Show, Attend and Tell" recipe, in
PyTorch.

Counterpart of ``image_captioning_ml_project_tpu.legacy.train``: batch 16,
Adam at lr 4e-4, the masked CE over the shifted targets plus the
doubly-stochastic attention regularisation ``((1 - sum_t alpha)^2)
.mean()`` at ``att_reg_weight``, each gradient entry clamped to +-5, the
learning rate x0.8 every 1000 batches, mid-epoch checkpoints every 1000
batches and per-epoch encoder and decoder checkpoints
(``encoder_epoch_{e}[_mid]``, ``decoder_epoch_{e}[_mid]``).

The update is optax's ``chain(clip(grad_clip), scale_by_adam(),
scale_by_learning_rate(lr * decay_rate ** (step // decay_every)))`` in
its arithmetic: the element-wise clamp, then :class:`..train.optim.AdamW`
without weight decay (bias-corrected moments, ``eps`` outside the square
root, the schedule evaluated in float32 at the update count).

Under a mesh (``mesh``, data parallelism: each rank its rows of every
batch) the CE and the regularisation are the rank's shares of the global
batch's, the ResNet's BatchNorm takes the global batch's statistics, the
gradients are all-reduced by sum before the clamp, and only global rank 0
writes checkpoints; dropout masks are drawn per rank. The legacy stack
reaches no kernel: every op is plain PyTorch.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
import torch

from ..config import EncoderConfig
from ..data.coco import iterate_batches, normalize_images
from ..data.pipeline import prefetch
from ..models.layers import data_parallel, dropout_generator
from ..params import init_legacy_flax_params, legacy_from_flax
from ..parallel.mesh import batch_rows, replicate
from ..train.losses import attention_regularization, global_count
from ..train.optim import AdamW
from ..utils.checkpoint import CheckpointManager
from ..utils.rng import fold_in, generator
from .model import ShowAttendTell


def masked_caption_ce(predictions: torch.Tensor, captions: torch.Tensor,
                      pad_token_id: int, group=None) -> torch.Tensor:
    """CE over decode steps: predictions[t] scores captions[t + 1], pads
    masked out; under a data-axis ``group`` this rank's share (the global
    token count divides)."""
    targets = captions[:, 1:predictions.shape[1] + 1].long()
    mask = (targets != pad_token_id).float()
    logp = torch.log_softmax(predictions, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return (nll * mask).sum() / global_count(mask.sum(), group).clamp_min(1.0)


def legacy_schedule(learning_rate: float, decay_every: int,
                    decay_rate: float):
    """update count -> ``learning_rate * decay_rate ** (count //
    decay_every)`` in float32."""
    def schedule(count: int):
        return np.float32(learning_rate) * np.float32(decay_rate) \
            ** np.float32(count // decay_every)

    return schedule


class LegacyTrainer:
    """The legacy trainer on ``device`` (``"cuda"`` unless the caller
    passes the CPU). The model starts from ``params`` (the JAX legacy
    model's variable tree), ``state_dict`` (this package's), or weights
    drawn from ``seed`` (:func:`..params.init_legacy_flax_params`).
    ``dropout`` is the decoder's rate (the JAX model's fixed 0.5 by
    default)."""

    def __init__(self, vocab, train_dataset, val_dataset=None,
                 batch_size: int = 16, learning_rate: float = 4e-4,
                 num_epochs: int = 4, grad_clip: float = 5.0,
                 decay_every: int = 1000, decay_rate: float = 0.8,
                 att_reg_weight: float = 1.0, use_bert: bool = False,
                 checkpoint_dir: str = "checkpoints_legacy",
                 encoder_config=None, mesh=None, seed: int = 0,
                 device="cuda", params=None, state_dict=None,
                 dropout: float = 0.5):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to train on the CPU")
        self.vocab = vocab
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.grad_clip = grad_clip
        self.decay_every = decay_every
        self.att_reg_weight = att_reg_weight
        self.use_bert = use_bert
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        self._data_group = (mesh.data_group if mesh is not None
                            and mesh.dp > 1 else None)
        self.logger = logging.getLogger(__name__)
        self.ckpt = CheckpointManager(checkpoint_dir)

        self.model = ShowAttendTell(len(vocab), encoder_config=encoder_config,
                                    use_bert=use_bert, dropout=dropout)
        if state_dict is None:
            if params is None:
                params = init_legacy_flax_params(
                    len(vocab), encoder_config or EncoderConfig(), seed,
                    use_bert=use_bert)
            state_dict = legacy_from_flax(params)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device, memory_format=torch.channels_last)
        replicate(self.model, mesh)
        self.optimizer = AdamW(
            dict(self.model.named_parameters()),
            legacy_schedule(learning_rate, decay_every, decay_rate),
            weight_decay=0.0)
        self.step = 0
        self._rng_seed = seed + 1

    # -- state ---------------------------------------------------------

    def state_tree(self) -> Dict[str, Any]:
        """The parameters, BatchNorm statistics, Adam state and step."""
        return {"params": {n: p.detach()
                           for n, p in self.model.named_parameters()},
                "batch_stats": {n: b for n, b in self.model.named_buffers()},
                "opt_state": self.optimizer.state_dict(),
                "step": self.step}

    @torch.no_grad()
    def load_state(self, state: Dict[str, Any]) -> None:
        """Take a :meth:`state_tree` (from any device)."""
        mine = dict(self.model.named_parameters())
        mine.update(self.model.named_buffers())
        theirs = dict(state["params"])
        theirs.update(state.get("batch_stats", {}))
        if set(theirs) != set(mine):
            raise KeyError(f"state differs from the model's: "
                           f"{sorted(set(theirs) ^ set(mine))}")
        for n, t in theirs.items():
            mine[n].copy_(t)
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])

    # -- steps ---------------------------------------------------------

    def _generator(self, step: int) -> torch.Generator:
        seed = fold_in(self._rng_seed, step)
        if self.mesh is not None:
            seed = fold_in(seed, self.mesh.data_rank)
        return generator(seed, self.device)

    def train_step(self, images, captions, caption_embeddings=None
                   ) -> Dict[str, torch.Tensor]:
        """One step on a batch (this rank's rows under a mesh): uint8
        images [B, H, W, 3], caption ids [B, T], optionally the BERT
        caption embeddings [B, T, 768]. Returns the global batch's ``ce``
        and ``att_reg`` as device scalars."""
        images = normalize_images(torch.as_tensor(images).to(self.device))
        captions = torch.as_tensor(captions).to(self.device).long()
        if caption_embeddings is not None:
            caption_embeddings = torch.as_tensor(
                caption_embeddings).to(self.device)
        pad = self.vocab.pad_token_id
        group = self._data_group
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        with torch.enable_grad(), data_parallel(group), \
                dropout_generator(self._generator(self.step)):
            out = self.model(images, captions,
                             caption_embeddings=caption_embeddings)
            ce = masked_caption_ce(out["predictions"].float(), captions, pad,
                                   group=group)
            dec_mask = (captions[:, 1:out["alphas"].shape[1] + 1]
                        != pad).float()
            reg = attention_regularization(out["alphas"], dec_mask,
                                           group=group)
            (ce + self.att_reg_weight * reg).backward()
        params = dict(self.model.named_parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params.values()]
        metrics = torch.stack([ce.detach(), reg.detach()])
        if group is not None:
            flat = torch._utils._flatten_dense_tensors(grads)
            torch.distributed.all_reduce(flat, group=group)
            grads = torch._utils._unflatten_dense_tensors(flat, grads)
            torch.distributed.all_reduce(metrics, group=group)
        with torch.no_grad():
            clipped = {n: g.clamp(-self.grad_clip, self.grad_clip)
                       for n, g in zip(params, grads)}
            self.optimizer.step(clipped)
        for p in params.values():
            p.grad = None
        self.step += 1
        return {"ce": metrics[0], "att_reg": metrics[1]}

    # -- loop ----------------------------------------------------------

    def train(self, bert_embedder=None):
        """``num_epochs`` epochs over shuffled batches (``seed=epoch``),
        the mid-epoch checkpoint every ``decay_every`` steps, the epoch
        checkpoints after each; returns the final :meth:`state_tree`."""
        step = 0  # this call's batches, for the mid-epoch checkpoints
        for epoch in range(self.num_epochs):
            losses = []
            it = iterate_batches(
                self.train_dataset, self.batch_size, shuffle=True,
                seed=epoch, rows=None if self.mesh is None else batch_rows(
                    self.batch_size, self.mesh))
            for batch in prefetch(it, self.device):
                cap_emb = None
                if self.use_bert:
                    assert bert_embedder is not None
                    texts = batch["caption"][batch_rows(
                        len(batch["caption"]), self.mesh)]
                    cap_emb = bert_embedder.embed_batch(
                        texts, batch["caption_tokens"].shape[1])
                metrics = self.train_step(batch["image"],
                                          batch["caption_tokens"], cap_emb)
                losses.append(metrics["ce"])
                step += 1
                if step % self.decay_every == 0:
                    self._save(epoch, mid=True)
            mean_ce = (float(torch.stack(losses).mean()) if losses else 0.0)
            self.logger.info("legacy epoch %d: ce=%.4f", epoch + 1, mean_ce)
            self._save(epoch)
        return self.state_tree()

    def _save(self, epoch: int, mid: bool = False):
        """Per-epoch encoder and decoder checkpoints (``_mid`` variants),
        by global rank 0."""
        if not self.is_main:
            return
        suffix = "_mid" if mid else ""
        enc, dec = self.model.encoder, self.model.decoder
        self.ckpt.save(f"encoder_epoch_{epoch}{suffix}",
                       {"params": {n: p.detach()
                                   for n, p in enc.named_parameters()},
                        "batch_stats": dict(enc.named_buffers())})
        self.ckpt.save(f"decoder_epoch_{epoch}{suffix}",
                       {"params": {n: p.detach()
                                   for n, p in dec.named_parameters()}})


def load_legacy_checkpoints(model: ShowAttendTell, checkpoint_dir: str,
                            encoder_ckpt: str, decoder_ckpt: str) -> None:
    """Copy an encoder and a decoder checkpoint of :class:`LegacyTrainer`
    into ``model``."""
    ckpt = CheckpointManager(checkpoint_dir)
    enc, _, _ = ckpt.restore(encoder_ckpt)
    dec, _, _ = ckpt.restore(decoder_ckpt)
    state = {f"encoder.{n}": t for n, t in enc["params"].items()}
    state.update({f"encoder.{n}": t
                  for n, t in enc.get("batch_stats", {}).items()})
    state.update({f"decoder.{n}": t for n, t in dec["params"].items()})
    model.load_state_dict(state, strict=True)


def main(argv=None):
    """Script entry::

        python -m image_captioning_ml_project_tpu_torch.legacy.train \\
            --data_root data --vocab vocab.json [--use_bert] [--device cpu]
    """
    import argparse

    from ..data.coco import COCOCaptionDataset
    from ..data.tokenizer import WordVocab
    from ..utils.logging import setup_logging
    from .validate import validate

    p = argparse.ArgumentParser(description="Legacy Show-Attend-Tell training")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--vocab", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_epochs", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=4e-4)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--max_length", type=int, default=50)
    p.add_argument("--use_bert", action="store_true")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints_legacy")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:N, cpu)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu "
                         "to train on the CPU")

    setup_logging(args.checkpoint_dir)
    vocab = WordVocab.load(args.vocab)
    train_ds = COCOCaptionDataset(
        args.data_root, "annotations/captions_train2014.json", "train2014",
        vocab, image_size=args.image_size, max_length=args.max_length,
        is_training=True)
    val_ds = COCOCaptionDataset(
        args.data_root, "annotations/captions_val2014.json", "val2014",
        vocab, image_size=args.image_size, max_length=args.max_length,
        is_training=False)
    trainer = LegacyTrainer(
        vocab, train_ds, val_ds, batch_size=args.batch_size,
        num_epochs=args.num_epochs, learning_rate=args.learning_rate,
        use_bert=args.use_bert, checkpoint_dir=args.checkpoint_dir,
        device=args.device)
    embedder = None
    if args.use_bert:
        from .bert_embedder import BertCaptionEmbedder

        embedder = BertCaptionEmbedder()
    trainer.train(bert_embedder=embedder)
    return validate(trainer.model, val_ds, vocab, batch_size=args.batch_size,
                    bert_embedder=embedder)


if __name__ == "__main__":
    main()
