"""Training engine of the port: cross-entropy training, SCST fine-tuning
with on-device CIDEr rewards, validation with caption metrics, checkpoints.

Counterpart of ``image_captioning_ml_project_tpu.train.trainer.
CaptioningTrainer``, with the same construction surface, schedule horizon,
logging cadence, validation and checkpoint policy (best val CIDEr, rolling
mid-epoch step checkpoints, full resume):

* the state is f32 master weights (the model's parameters and the loss's
  ITM head and projections), the ResNet's BatchNorm statistics (buffers of
  the model), the AdamW state and the step (:meth:`_state_tree`);
* :meth:`train_step` runs the teacher-forced forward and the combined
  loss in ``bfloat16`` when ``use_amp`` (weights cast at use, as flax
  modules with ``dtype=bfloat16`` cast their f32 params; norms stay f32),
  backpropagates to the masters and takes one optax-exact AdamW step
  (:mod:`.optim`). Dropout masks and ITM negatives come from generators
  seeded from ``config.seed`` and the step (``fold_in``), so a resumed run
  draws what the uninterrupted one would have drawn. No kernel runs in a
  training step: the kernels have no backward, and the model's training
  mode routes around every one of them;
* epochs from ``rl_start_epoch`` (with ``use_rl``) add an SCST pass after
  the CE pass. Each step (:meth:`scst_fused_step`) is three parts that can
  be called apart: :meth:`rollout_step` (a sampled and a greedy decode
  from one ``init_cache``, through the kernels, on :meth:`rollout_model`),
  :meth:`scst_rewards` (per-sample CIDEr-D on the device,
  :mod:`..evaluate.cider_device`) and :meth:`rl_update_step` (the
  REINFORCE loss with the greedy reward as baseline, then one AdamW step).
  The REINFORCE forward is the model's eval numerics (no dropout,
  BatchNorm on its running statistics) with gradients on, as the JAX
  trainer differentiates ``apply(..., train=False)``: it runs inside
  :func:`..models.layers.plain_routes`, so no kernel is entered. The
  rollouts draw from a generator keyed on the step (stream 2 beside
  dropout's 0 and ITM's 1), so a resumed run samples what the
  uninterrupted one would have. With another reward than CIDEr, or
  ``rl_on_device_reward`` off, the rollouts are decoded to text and scored
  on the host (:meth:`_rewards`);
* decoding (validation here, and the server after a reload) runs on
  :meth:`eval_state`: a :func:`..models.captioning_model.load_model` copy
  of the current masters, cast once and stacked for the kernels, in eval
  mode. It is built anew at each call, so it can never hold stale
  weights. The SCST rollouts instead build one per pass and copy the
  masters into it in place before each step (:meth:`rollout_model`);
* a curriculum sampler (:mod:`.curriculum`) orders each epoch's
  training batches in place of the shuffle, in both passes of an SCST
  epoch, and its per-epoch length sets the schedule's horizon;
* with a CLIP ``reranker``, validation decodes beam candidates as the
  eval CLI and the server do (:func:`..inference.decoding.decode_images`)
  and the reranker picks each image's caption, so the best-CIDEr
  checkpoint is chosen by the decode that ships (on the resized pixels
  where validation batches carry ``device_resize`` canvases; never in the
  object-region mode, whose batches hold no pixels);
* the model's inputs (:meth:`_prepare_inputs`): uint8 images as they are
  (the encoder normalises them, or under ``fold_normalize`` a ViT or CLIP
  patch embed folds the normalisation), ``device_resize`` canvases resized
  and normalised on the device (:func:`..ops.resize.resize_normalize`),
  and in the object-region mode (``object_region`` encoder or
  ``use_object_features``) the detector regions' dict.

Under a mesh (:mod:`..parallel`, one process per rank) the trainer is
one rank of the JAX trainer's one program:

* every rank draws the same seeded weights and rank 0's are broadcast;
  with a model axis larger than 1 the GPT-2 blocks are sharded
  Megatron-style (:func:`..parallel.sharding.tensor_parallel`), and the
  Adam moments with them;
* each rank takes its contiguous rows of every global batch
  (:func:`..data.pipeline.prefetch` with the mesh); the losses are its
  shares of the global batch's (:mod:`.losses`), BatchNorm takes the
  global batch's statistics (:func:`..models.layers.data_parallel`), the
  gradients are all-reduced by sum over the data axis, and the clip's
  global norm sums the shards' squares over the model axis; the returned
  losses are the global batch's;
* dropout masks come from the step's generator folded with the data
  rank, so a run with dropout differs from the one-process run;
* validation rounds its batch up to the data axis, decodes this rank's
  rows on full (gathered) weights and gathers the tokens on the host;
* checkpoints hold the full tensors (a tensor-parallel checkpoint is a
  one-process one) and only global rank 0 writes them and the log file;
  resume shards what it reads.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import Config, reads_regions
from ..data.coco import iterate_batches
from ..data.pipeline import prefetch
from ..evaluate.cider_device import (build_df_table, encode_references,
                                     per_sample_cider_device)
from ..evaluate.metrics import (bleu, calculate_metrics, meteor_lite,
                                metric_tokenize, per_sample_cider,
                                per_sample_spice, rouge_l)
from ..inference.decoding import (_map, batch_size_of, decode_images,
                                  greedy_decode, sample_decode)
from ..models.captioning_model import (ImageCaptioningModel,
                                       build_train_model, load_model)
from ..models.layers import data_parallel, dropout_generator, plain_routes
from ..ops.resize import resize_normalize, resize_square
from ..parallel.mesh import (all_reduce_host, batch_rows, gather_rows_host,
                             replicate)
from ..parallel.sharding import (gather_params, infer_param_shardings,
                                 shard_params, tensor_parallel)
from ..utils.amp import cast_for_compute, castable_parameters
from ..utils.checkpoint import CheckpointManager
from ..utils.logging import MetricLogger, setup_logging
from ..utils.profiling import span
from ..utils.rng import fold_in, generator
from .losses import CombinedLoss, global_count, shifted_cross_entropy
from .optim import create_optimizer, global_norm, sum_of_squares

def compute_dtype(config: Config) -> torch.dtype:
    """A trainer's compute dtype: bf16 under ``use_amp`` unless the model
    is configured ``float32``; the masters stay f32 either way."""
    if config.training.use_amp and config.model.dtype != "float32":
        return torch.bfloat16
    return torch.float32


def load_decode_model(config: Config, device, state_dict=None
                      ) -> ImageCaptioningModel:
    """The decode model of a trainer's weights (``state_dict``, or the
    seed's without one): a :func:`..models.captioning_model.load_model`
    cast once to :func:`compute_dtype` (norms f32), stacked for the
    kernels, in eval mode. Validation, the SCST rollouts and the eval and
    demo CLIs decode on it."""
    cfg = copy.copy(config)
    cfg.model = copy.copy(config.model)
    cfg.model.dtype = ("bfloat16" if compute_dtype(config) == torch.bfloat16
                       else "float32")
    return load_model(cfg, device, state_dict=state_dict)


REGION_KEYS = ("region_features", "region_boxes", "region_mask")


def batch_inputs(batch, regions: bool):
    """The model-input arrays of a data batch: in the object-region mode
    (``regions``) the detector regions' dict, from ``device_resize``
    canvases a dict of the canvases and their sides (``image_size``), else
    the images."""
    if regions:
        return {k: batch[k] for k in REGION_KEYS}
    if "image_size" in batch:
        return {"image": batch["image"], "image_size": batch["image_size"]}
    return batch["image"]


def to_device(inputs, device):
    """:func:`batch_inputs`' arrays (numpy or torch) on ``device``."""
    if isinstance(inputs, dict):
        return {k: to_device(v, device) for k, v in inputs.items()}
    if isinstance(inputs, np.ndarray):
        inputs = torch.from_numpy(inputs)
    return inputs.to(device)


def prepare_inputs(inputs, image_size: int):
    """What the model takes of :func:`batch_inputs` on the device: canvases
    resized to ``image_size`` and normalised there
    (:func:`..ops.resize.resize_normalize`); uint8 images and region dicts
    as they are (the encoder normalises uint8 images, or under
    ``fold_normalize`` a ViT or CLIP patch embed folds the same affine, as
    the JAX trainer hands those two raw pixels)."""
    if isinstance(inputs, dict) and "image_size" in inputs:
        return resize_normalize(inputs["image"], inputs["image_size"],
                                image_size)
    return inputs


def rerank_pixels(inputs, image_size: int):
    """The pixels a CLIP reranker scores for :func:`batch_inputs` on the
    device: of canvases, the resized ones the captioner saw (floats on
    the 0-255 scale, :func:`..ops.resize.resize_square`), else the
    images."""
    if isinstance(inputs, dict):
        return resize_square(inputs["image"], inputs["image_size"],
                             image_size)
    return inputs


def _init_loss(loss_mod: CombinedLoss, seed: int) -> None:
    """Seeded weights of the loss's linear layers: N(0, 1/fan_in) kernels
    drawn from ``numpy.random.RandomState(seed)``, zero biases."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in loss_mod.named_parameters():
            if name.endswith("weight"):
                p.copy_(torch.from_numpy(
                    (rs.standard_normal(tuple(p.shape))
                     / np.sqrt(p.shape[1])).astype(np.float32)))
            else:
                p.zero_()


class CaptioningTrainer:
    """CE and SCST trainer on ``device`` (``"cuda"`` unless the caller
    passes the CPU, as the tests do). The model starts from ``params``,
    the JAX package's variable tree, or ``state_dict``, this package's
    (a checkpoint's model weights); with neither the weights are drawn
    from ``config.seed`` (:func:`..params.init_flax_params`). ``mesh``
    (:func:`..parallel.mesh.create_mesh`) makes it one rank of a data-
    and tensor-parallel run; ``device`` is then this rank's."""

    def __init__(self, config: Config, train_dataset, val_dataset,
                 tokenizer, mesh=None, curriculum_sampler=None,
                 reranker=None, device="cuda", params=None,
                 state_dict=None):
        enc = config.model.encoder
        self._object_mode = reads_regions(enc)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to train on the CPU")
        self.config = config
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.tokenizer = tokenizer
        self.curriculum_sampler = curriculum_sampler
        self.reranker = reranker
        tc = config.training
        dp = mesh.dp if mesh is not None else 1
        if tc.batch_size % dp:
            raise ValueError(f"batch size {tc.batch_size} does not divide "
                             f"over the {dp} ranks of the data axis")
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        # the data axis's group where it has more than one rank
        self._data_group = mesh.data_group if dp > 1 else None
        # only global rank 0 writes the log file
        self.logger = setup_logging(config.output_dir if self.is_main
                                    else None, __name__)
        if not self.is_main:
            self.logger.setLevel(logging.WARNING)

        self.dtype = compute_dtype(config)
        self.model = replicate(build_train_model(
            config, self.device, params=params, state_dict=state_dict), mesh)

        mc = config.model
        self.loss_mod = CombinedLoss(
            pad_token_id=mc.pad_token_id,
            use_contrastive=tc.use_contrastive_loss,
            use_itm=tc.use_itm_loss,
            contrastive_weight=tc.contrastive_weight,
            itm_weight=tc.itm_weight,
            temperature=tc.contrastive_temperature,
            hidden_dim=mc.projection_dim,
            attention_reg_weight=tc.attention_reg_weight,
            image_dim=mc.encoder.feature_dim,
            text_dim=mc.decoder.hidden_dim)
        _init_loss(self.loss_mod, config.seed + 2)
        self.loss_mod.to(self.device).train()
        replicate(self.loss_mod, mesh)
        self.loss_mod.data_group = self._data_group
        # tensor parallelism: the GPT-2 blocks' shards (a no-op without a
        # model axis); the full shapes by model and optimizer name decide
        # the placements of what is gathered and sharded
        shapes = tensor_parallel(self.model, mesh)
        self._full_shapes = dict(shapes)
        self._full_shapes.update({f"model.{n}": s for n, s in shapes.items()})
        self._sharded = {n for n, spec in infer_param_shardings(
            self._full_shapes, mesh.mp if mesh is not None else 1).items()
            if spec}

        self.steps_per_epoch = max(len(train_dataset) // tc.batch_size, 1)

        # Epochs >= rl_start_epoch take two optimizer passes (CE, then
        # SCST), so they count twice in the schedule's horizon, as in the
        # JAX trainer.
        def _passes(e: int) -> int:
            return 2 if (tc.use_rl and e >= tc.rl_start_epoch) else 1

        if curriculum_sampler is not None:
            # curriculum pacing shrinks the early epochs: the horizon
            # probes the sampler's length per epoch (set_epoch only stores
            # the index; train() sets it again each epoch)
            total = 0
            for e in range(tc.num_epochs):
                curriculum_sampler.set_epoch(e)
                total += _passes(e) * max(
                    len(curriculum_sampler) // tc.batch_size, 1)
            curriculum_sampler.set_epoch(0)
            self.total_steps = max(total, 1)
        else:
            self.total_steps = self.steps_per_epoch * sum(
                _passes(e) for e in range(tc.num_epochs))

        # async: the epoch-N save's disk write overlaps epoch N+1 compute;
        # train() drains in-flight saves before returning
        self.ckpt = CheckpointManager(config.checkpoint_dir, async_save=True)
        self.best_val_score = 0.0
        self.start_epoch = 0
        # mid-epoch resume position (set by load_checkpoint on a step
        # checkpoint): the first resumed epoch continues at this batch
        self.start_batch = 0
        self.start_phase = "ce"
        self.history = []

        self._cast_names = {
            "model": castable_parameters(self.model),
            "loss": castable_parameters(self.loss_mod)}
        self.optimizer, self.lr_schedule = create_optimizer(
            tc, self.total_steps, self._named_params(),
            norm_fn=self._sharded_norm if self._sharded else global_norm)
        self.step = 0
        self._rng_seed = config.seed + 1
        # SCST: the train references and their CIDEr document frequencies
        # (built at the first scst_references call) and the rollouts'
        # decode model (built once per pass, refreshed in place before
        # each step)
        self._cider_refs = self._cider_df = None
        self._rollout = None

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def _named_params(self) -> Dict[str, torch.nn.Parameter]:
        """Every trained parameter by optimizer name: the model's under
        ``model.``, the loss's under ``loss.``."""
        out = {f"model.{n}": p for n, p in self.model.named_parameters()}
        out.update({f"loss.{n}": p
                    for n, p in self.loss_mod.named_parameters()})
        return out

    def _gather(self, local: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Full tensors of local ones by model or optimizer name (every
        rank of the model axis must call it)."""
        if not self._sharded:
            return local
        return gather_params(local, self.mesh, self._full_shapes)

    def _shard(self, full: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """This rank's shards of full tensors by model or optimizer name."""
        if not self._sharded:
            return full
        return shard_params(full, self.mesh)

    def _sharded_norm(self, grads) -> torch.Tensor:
        """The global norm of the full gradient under tensor parallelism:
        the shards' squares summed over the model axis, the replicated
        gradients' counted once."""
        names = self.optimizer.names
        split = [g for n, g in zip(names, grads) if n in self._sharded]
        whole = [g for n, g in zip(names, grads) if n not in self._sharded]
        sq = sum_of_squares(split).to(grads[0].device)
        torch.distributed.all_reduce(sq, group=self.mesh.model_group)
        return (sq + sum_of_squares(whole).to(sq.device)).sqrt()

    def _state_tree(self) -> Dict[str, Any]:
        """The one checkpointed view of the training state — save_checkpoint,
        save_step_checkpoint and load_checkpoint must agree or resume
        silently drops fields. Full tensors under tensor parallelism
        (gathered: every rank of the model axis must call it)."""
        opt = self.optimizer.state_dict()
        return {
            "params": {
                "model": self._gather(
                    {n: p.detach() for n, p in self.model.named_parameters()}),
                "loss": {n: p.detach()
                         for n, p in self.loss_mod.named_parameters()}},
            "batch_stats": {n: b for n, b in self.model.named_buffers()},
            "opt_state": dict(opt, mu=self._gather(opt["mu"]),
                              nu=self._gather(opt["nu"])),
            "step": self.step,
        }

    @torch.no_grad()
    def _load_weights(self, params: Dict[str, Dict[str, torch.Tensor]],
                      batch_stats: Optional[Dict[str, torch.Tensor]]) -> None:
        """Copy checkpointed weights (any device, full tensors) into the
        masters (this rank's shards of them)."""
        for group, module in (("model", self.model),
                              ("loss", self.loss_mod)):
            theirs = params[group]
            if group == "model":
                theirs = self._shard(dict(theirs))
            mine = dict(module.named_parameters())
            if set(theirs) != set(mine):
                raise KeyError(f"checkpoint {group} parameters differ from "
                               f"the model's: "
                               f"{sorted(set(theirs) ^ set(mine))}")
            for n, t in theirs.items():
                mine[n].copy_(t)
        if batch_stats is not None:
            buffers = dict(self.model.named_buffers())
            for n, t in batch_stats.items():
                buffers[n].copy_(t)

    def load_state(self, state: Dict[str, Any]) -> None:
        """Take a whole training state (a :meth:`_state_tree` dict, e.g. a
        JAX trainer's through :func:`..params.train_state_from_flax`)."""
        self._load_weights(state["params"], state.get("batch_stats"))
        opt = state["opt_state"]
        self.optimizer.load_state_dict(dict(
            opt, mu=self._shard(dict(opt["mu"])),
            nu=self._shard(dict(opt["nu"]))))
        self.step = int(state["step"])

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------

    def _prepare_inputs(self, inputs):
        return prepare_inputs(inputs, self.config.image_size)

    def _batch_inputs(self, batch):
        return batch_inputs(batch, self._object_mode)

    def _to_device(self, x):
        return to_device(x, self.device)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _apply(self, module, group: str, *args, **kwargs):
        """``module(*args)`` computing in the trainer's dtype: in bf16 a
        ``functional_call`` with its castable parameters cast (gradients
        reach the f32 masters), in f32 the module itself."""
        if self.dtype == torch.float32:
            return module(*args, **kwargs)
        weights = cast_for_compute(module, self._cast_names[group],
                                   self.dtype)
        return torch.func.functional_call(module, weights, args, kwargs)

    def _forward_loss(self, images, captions, caption_mask, itm_gen
                      ) -> Dict[str, torch.Tensor]:
        out = self._apply(self.model, "model", images, captions)
        return self._apply(
            self.loss_mod, "loss", out["logits"].float(), captions,
            image_features=out.get("pooled_features"),
            text_features=out.get("text_features"),
            attention_weights=out.get("attention_weights"),
            target_mask=caption_mask, generator=itm_gen)

    def _rank_seed(self, seed: int) -> int:
        """``seed`` folded with the data rank under a mesh (each rank's
        rows draw their own masks and samples), else ``seed``."""
        if self.mesh is None:
            return seed
        return fold_in(seed, self.mesh.data_rank)

    def _step_generators(self, step: int):
        """(dropout, ITM) generators of ``step``, on the trainer's device;
        the dropout one folded with the data rank (the ITM negatives are
        drawn over the global batch, the same on every rank)."""
        seed = fold_in(self._rng_seed, step)
        return (generator(self._rank_seed(fold_in(seed, 0)), self.device),
                generator(fold_in(seed, 1), self.device))

    def _data_sum(self, metrics: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Each rank's loss shares summed over the data axis: the global
        batch's losses (one all-reduce)."""
        if self._data_group is None:
            return metrics
        keys = list(metrics)
        flat = torch.stack([metrics[k].float() for k in keys])
        torch.distributed.all_reduce(flat, group=self._data_group)
        return dict(zip(keys, flat.unbind()))

    def _global_mean(self, values: torch.Tensor) -> torch.Tensor:
        """The mean of per-row ``values`` over the global batch."""
        if self._data_group is None:
            return values.float().mean()
        total = torch.stack([values.float().sum(),
                             torch.tensor(float(values.numel()),
                                          device=values.device)])
        torch.distributed.all_reduce(total, group=self._data_group)
        return total[0] / total[1]

    def train_step(self, images, captions, caption_mask
                   ) -> Dict[str, torch.Tensor]:
        """One CE step on a batch (uint8 images [B, H, W, 3], caption ids
        and their mask [B, T], host arrays or tensors). Returns the losses,
        ``learning_rate`` and ``grad_norm`` as device scalars."""
        with span("train.step"):
            with span("train.inputs"):
                images = self._prepare_inputs(self._to_device(images))
                captions = self._to_device(captions)
                caption_mask = self._to_device(caption_mask)
            self.model.train()
            self.loss_mod.train()
            drop_gen, itm_gen = self._step_generators(self.step)
            self._zero_grads()
            with torch.enable_grad(), dropout_generator(drop_gen), \
                    data_parallel(self._data_group):
                with span("train.forward"):
                    losses = self._forward_loss(images, captions,
                                                caption_mask, itm_gen)
                with span("train.backward"):
                    losses["total_loss"].backward()
            metrics = self._data_sum({k: v.detach()
                                      for k, v in losses.items()})
            with span("train.optimizer"):
                metrics.update(self._apply_gradients())
            return metrics

    def _zero_grads(self) -> None:
        for p in self._named_params().values():
            p.grad = None

    def _apply_gradients(self) -> Dict[str, torch.Tensor]:
        """One AdamW step on the gradients the last backward left on the
        parameters, then the step count; returns ``learning_rate`` and
        ``grad_norm``. A parameter the loss does not reach has a zero
        gradient, as in ``jax.grad``: it still takes AdamW's decay."""
        params = self._named_params()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if self._data_group is not None:
            # one all-reduce (sum) of every gradient over the data axis
            names = list(grads)
            flat = torch._utils._flatten_dense_tensors(
                [grads[n].float() for n in names])
            torch.distributed.all_reduce(flat, group=self._data_group)
            grads = dict(zip(names, torch._utils._unflatten_dense_tensors(
                flat, [grads[n] for n in names])))
        lr = float(self.lr_schedule(self.step))
        norm = self.optimizer.step(grads)
        for p in params.values():
            p.grad = None
        self.step += 1
        return {"learning_rate": torch.tensor(lr, dtype=torch.float32),
                "grad_norm": norm}

    def eval_state(self) -> ImageCaptioningModel:
        """The decode model of the current masters
        (:func:`load_decode_model`). Built anew at every call: its stacked
        operands are copies, so a kept one would decode with old
        weights."""
        state = {n: t.detach() for n, t in self.model.state_dict().items()}
        return load_decode_model(self.config, self.device,
                                 self._gather(state))

    @torch.inference_mode()
    def eval_loss_step(self, model, images, captions, caption_mask,
                       row_valid) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-token CE over *valid* rows only (``row_valid`` [B] masks out
        pad_last duplicate rows), on an :meth:`eval_state` model; also the
        supervised-token count, so the caller weights batches by tokens."""
        images = self._prepare_inputs(self._to_device(images))
        captions = self._to_device(captions)
        caption_mask = self._to_device(caption_mask)
        row_valid = self._to_device(row_valid)
        caption_mask = caption_mask * row_valid[:, None].to(
            caption_mask.dtype)
        out = model(images, captions)
        ce = shifted_cross_entropy(out["logits"].float(), captions,
                                   self.config.model.pad_token_id,
                                   target_mask=caption_mask)
        return ce, caption_mask[:, 1:].float().sum()

    def val_decode_step(self, model, images,
                        gen: Optional[torch.Generator] = None,
                        candidates: bool = False) -> torch.Tensor:
        """Decode with the configured ``InferenceConfig`` strategy on an
        :meth:`eval_state` model, or with ``candidates`` the CLIP
        reranker's beam candidates, as the eval CLI and the server do
        (:func:`..inference.decoding.decode_images`), so best-CIDEr
        checkpoint selection runs the decode that ships."""
        images = self._prepare_inputs(self._to_device(images))
        return decode_images(model, images, self.config, gen,
                             candidates=candidates)

    # ------------------------------------------------------------------
    # epoch loops
    # ------------------------------------------------------------------

    def _needs_scst(self, epoch: int) -> bool:
        tc = self.config.training
        return tc.use_rl and epoch >= tc.rl_start_epoch

    def train(self):
        tc = self.config.training
        self.logger.info("Starting training...")
        for epoch in range(self.start_epoch, tc.num_epochs):
            self.logger.info("Epoch %d/%d", epoch + 1, tc.num_epochs)
            if self.curriculum_sampler is not None:
                self.curriculum_sampler.set_epoch(epoch)
                self.logger.info("Curriculum: %d samples",
                                 len(self.curriculum_sampler))
            resumed = epoch == self.start_epoch
            train_loss = self._train_epoch(
                epoch, start_batch=self.start_batch if resumed else 0,
                start_phase=self.start_phase if resumed else "ce")
            val_loss, val_metrics = self._validate_epoch(epoch)
            self.logger.info(
                "Epoch %d: Train Loss: %.4f, Val Loss: %.4f, Val CIDEr: %.4f",
                epoch + 1, train_loss, val_loss, val_metrics.get("CIDEr", 0.0))
            self.history.append({
                "epoch": epoch + 1, "train_loss": float(train_loss),
                "val_loss": float(val_loss),
                "val_metrics": {k: float(v) for k, v in val_metrics.items()},
                "scst": self._needs_scst(epoch)})
            is_best = val_metrics.get("CIDEr", 0.0) > self.best_val_score
            if is_best:
                self.best_val_score = val_metrics.get("CIDEr", 0.0)
                self.logger.info("New best model with CIDEr: %.4f",
                                 self.best_val_score)
            if (epoch + 1) % self.config.save_every == 0 or is_best:
                self.save_checkpoint(epoch, is_best=is_best)
        self.ckpt.wait_until_finished()

    def _train_batches(self, epoch: int = 0,
                       skip_batches: int = 0) -> Iterator[Dict[str, Any]]:
        sampler = self.curriculum_sampler
        it = iterate_batches(
            self.train_dataset, self.config.training.batch_size,
            shuffle=sampler is None,
            # the curriculum's order (its generator advances at each
            # pass), else a fresh shuffle every epoch (torch
            # DataLoader(shuffle=True)); a resume skips in that order
            sampler=iter(sampler) if sampler is not None else None,
            seed=self.config.seed + epoch,
            num_workers=self.config.num_workers,
            skip_batches=skip_batches, rows=self._rows(
                self.config.training.batch_size))
        return prefetch(it, self.device)

    def _rows(self, batch_size: int) -> Optional[slice]:
        """This rank's rows of a global batch (None without a mesh)."""
        return None if self.mesh is None else batch_rows(batch_size,
                                                          self.mesh)

    def save_step_checkpoint(self, epoch: int, batch_index: int, phase: str):
        """Rolling mid-epoch checkpoint (``config.save_every_steps``).

        ``batch_index`` is the number of batches *completed* this epoch;
        resume re-creates the identically seeded epoch iterator and skips
        exactly that many. Two alternating slots keep disk bounded while
        the newest committed save is never the one being written.

        With ``config.step_ckpt_max_overhead`` > 0 the save is adaptively
        throttled: after a save whose blocking portion cost ``c`` seconds,
        further step saves are skipped until ``c / frac`` wall seconds have
        passed, so a degraded storage path coarsens checkpoints instead of
        stalling the train loop."""
        frac = getattr(self.config, "step_ckpt_max_overhead", 0.0)
        now = time.monotonic()
        throttled = False
        if frac and hasattr(self, "_step_ckpt_done_t"):
            wait_s = self._step_ckpt_cost_s / frac
            if now - self._step_ckpt_done_t < wait_s:
                self.logger.warning(
                    "step checkpoint throttled: last save blocked %.1fs; "
                    "next allowed %.0fs after it (%.0fs remain)",
                    self._step_ckpt_cost_s, wait_s,
                    wait_s - (now - self._step_ckpt_done_t))
                throttled = True
        if self._sharded:
            # the gather is collective: rank 0's decision holds for all
            decision = [throttled]
            torch.distributed.broadcast_object_list(decision, src=0)
            throttled = decision[0]
        if throttled or not (self.is_main or self._sharded):
            return
        # the blocking cost includes the drain of the previous in-flight
        # save, so a slow disk write shows in the throttle too
        t0 = time.monotonic()
        self.ckpt.wait_until_finished()
        state = self._state_tree()
        if not self.is_main:
            return
        self.ckpt.save_step(
            state,
            metadata={"epoch": epoch, "batch_index": batch_index,
                      "phase": phase, "step": int(self.step),
                      "best_val_score": self.best_val_score},
            config=self.config)
        self._step_ckpt_done_t = time.monotonic()
        self._step_ckpt_cost_s = self._step_ckpt_done_t - t0

    def _train_epoch(self, epoch: int, start_batch: int = 0,
                     start_phase: str = "ce") -> float:
        """The CE pass, then the SCST pass where the epoch needs one.
        Returns the CE loss, or the RL loss when the epoch resumed inside
        its SCST pass (the loss that was trained)."""
        tc = self.config.training
        if start_phase == "scst":
            # resumed inside the SCST pass: this epoch's CE pass already ran
            if self._needs_scst(epoch):
                return self._train_reinforcement_learning(
                    epoch, start_batch=start_batch)
            self.logger.warning(
                "resumed a '%s'-phase checkpoint for epoch %d but the "
                "current config has use_rl=%s rl_start_epoch=%d: no "
                "training pass remains for this epoch", start_phase,
                epoch + 1, tc.use_rl, tc.rl_start_epoch)
            return 0.0
        save_steps = getattr(self.config, "save_every_steps", 0)
        meter = MetricLogger()
        # curriculum pacing shrinks early epochs: the real denominator
        epoch_batches = max(
            (len(self.curriculum_sampler)
             if self.curriculum_sampler is not None
             else len(self.train_dataset)) // tc.batch_size, 1)
        # Off the logging cadence, losses stay device scalars and are read
        # at epoch end: a per-batch read would make the host wait for each
        # step before preparing the next.
        pending_losses = []
        t0, n_since = None, 0
        for i, batch in enumerate(self._train_batches(epoch, start_batch),
                                  start=start_batch):
            metrics = self.train_step(self._batch_inputs(batch),
                                      batch["caption_tokens"],
                                      batch["attention_mask"])
            n_since += 1
            if save_steps and (i + 1) % save_steps == 0:
                self.save_step_checkpoint(epoch, i + 1, "ce")
            if t0 is None:
                # the first step (kernel builds, allocator warm-up) is
                # outside the timed window
                host = {k: float(v) for k, v in metrics.items()}
                meter.update(**host)
                t0, n_since = time.perf_counter(), 0
                continue
            if (i + 1) % self.config.log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                meter.update(**host)
                self.logger.info(
                    "Epoch %d, Batch %d/%d, Loss: %.4f, LR: %.6f, "
                    "step: %.0f ms (windowed avg)",
                    epoch + 1, i + 1, epoch_batches,
                    host["total_loss"], host["learning_rate"],
                    1e3 * dt / max(n_since, 1))
                t0, n_since = time.perf_counter(), 0
            else:
                pending_losses.append(metrics["total_loss"])
        for v in (torch.stack(pending_losses).float().cpu().numpy()
                  if pending_losses else []):
            meter.update(total_loss=float(v))
        if self._needs_scst(epoch):
            self._train_reinforcement_learning(epoch)
        return meter.averages().get("total_loss", 0.0)

    # ------------------------------------------------------------------
    # SCST
    # ------------------------------------------------------------------

    def _rollout_generator(self, step: int) -> torch.Generator:
        """The rollouts' sampling generator of ``step`` on the trainer's
        device: stream 2 of the step's seed (dropout is 0, ITM 1), folded
        with the data rank under a mesh."""
        return generator(self._rank_seed(
            fold_in(fold_in(self._rng_seed, step), 2)), self.device)

    def rollout_model(self) -> ImageCaptioningModel:
        """The rollouts' decode model on the current masters: an
        :meth:`eval_state` model built at the first call of an SCST pass,
        and at every later call the masters (cast) and the BatchNorm
        statistics copied into it in place. Its parameters are views of the
        kernels' stacked operands, so the stacks follow. Under tensor
        parallelism a fresh :meth:`eval_state` of the gathered weights at
        every call."""
        if self._sharded:
            return self.eval_state()
        if self._rollout is None:
            model = self.eval_state()
            mine = dict(self.model.named_parameters())
            mine.update(self.model.named_buffers())
            theirs = list(model.named_parameters()) \
                + list(model.named_buffers())
            self._rollout = (model, [t for _, t in theirs],
                             [mine[n].detach() for n, _ in theirs])
            return model
        model, dst, src = self._rollout
        with torch.no_grad():
            torch._foreach_copy_(dst, src)
        return model

    @torch.no_grad()
    def rollout_step(self, model: ImageCaptioningModel, images,
                     gen: torch.Generator
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """SCST rollouts on ``model`` (:meth:`rollout_model`): one sampled
        and one greedy decode from one shared ``init_cache``: (sampled
        tokens [B, L], the sampler's token mask [B, L], greedy tokens
        [B, L]). Under ``no_grad``, not ``inference_mode``: the REINFORCE
        forward saves the sampled ids for its backward."""
        images = self._prepare_inputs(self._to_device(images))
        mc = self.config.model
        max_length = self.config.inference.max_length
        B = batch_size_of(images)
        state = model.init_cache(images, max_length)
        # the decodes append to their caches in place: the sampler gets
        # copies, the greedy decode the originals; the per-image constants
        # are shared
        forked = {k: v if k == "shared" else _map(torch.clone, v)
                  for k, v in state.items()}
        sample = sample_decode(model.step, forked, gen, B, mc.bos_token_id,
                               mc.eos_token_id, mc.pad_token_id, max_length)
        greedy = greedy_decode(model.step, state, B, mc.bos_token_id,
                               max_length, eos_token_id=mc.eos_token_id,
                               pad_token_id=mc.pad_token_id)
        return sample.tokens, sample.mask, greedy

    def _cider_specials(self) -> Tuple[int, int, int]:
        mc = self.config.model
        return (mc.pad_token_id, mc.bos_token_id, mc.eos_token_id)

    def scst_references(self, image_ids) -> Tuple[np.ndarray, np.ndarray]:
        """The train references of ``image_ids`` packed for
        :meth:`scst_rewards` (:func:`..evaluate.cider_device.
        encode_references`: token ids [B, R, L], -1 past each end, and the
        valid mask [B, R]; an image without references gets one EOS). The
        first call also builds the train set's CIDEr document frequencies
        on the trainer's device."""
        mc = self.config.model
        ref_len = mc.decoder.max_length
        if self._cider_df is None:
            self._cider_refs = self._tokenized_refs_by_image_id(ref_len)
            self._cider_df = build_df_table(
                list(self._cider_refs.values()),
                special_ids=self._cider_specials(), device=self.device)
        refs = [self._cider_refs.get(int(i), [[mc.eos_token_id]])
                for i in image_ids]
        # the dataset's reference budget, which validation batches carry too
        max_refs = getattr(self.train_dataset, "max_ref_captions", 5)
        return encode_references(refs, max_refs, ref_len)

    @torch.no_grad()
    def scst_rewards(self, sampled, greedy, ref_tokens, ref_valid
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-sample CIDEr-D of the sampled and greedy tokens against
        references packed by :meth:`scst_references`, on the device, and
        the advantages ``sample - greedy``: three [B] float32 tensors."""
        ref_tokens = self._to_device(ref_tokens)
        ref_valid = self._to_device(ref_valid)
        specials = self._cider_specials()
        sample_r = per_sample_cider_device(self._to_device(sampled),
                                           ref_tokens, ref_valid,
                                           self._cider_df, specials)
        greedy_r = per_sample_cider_device(self._to_device(greedy),
                                           ref_tokens, ref_valid,
                                           self._cider_df, specials)
        return sample_r, greedy_r, sample_r - greedy_r

    def _reinforce_loss(self, images, sampled, token_mask, advantages
                        ) -> torch.Tensor:
        """``rl_weight * -sum(adv * logp(sampled) * mask) / max(sum(mask),
        1)`` over positions 1.., the sampler's mask marking the sampled
        tokens (EOS included), on the model's eval numerics with gradients
        on (plain routes: no kernel)."""
        self.model.eval()
        try:
            with torch.enable_grad(), plain_routes():
                out = self._apply(self.model, "model", images, sampled)
                logp = torch.log_softmax(out["logits"].float()[:, :-1],
                                         dim=-1)
                tok_logp = logp.gather(-1, sampled[:, 1:, None])[..., 0]
                mask = token_mask[:, 1:].float()
                loss = -(advantages[:, None] * tok_logp * mask).sum() \
                    / global_count(mask.sum(),
                                   self._data_group).clamp_min(1.0)
                return self.config.training.rl_weight * loss
        finally:
            self.model.train()

    def rl_update_step(self, images, sampled, sample_mask, advantages
                       ) -> Dict[str, torch.Tensor]:
        """The REINFORCE update on given rollouts: sampled tokens and their
        mask [B, L], advantages [B] (host arrays or tensors); one AdamW
        step. Returns ``rl_loss``, ``learning_rate`` and ``grad_norm`` as
        device scalars."""
        images = self._prepare_inputs(self._to_device(images))
        sampled = self._to_device(sampled).long()
        sample_mask = self._to_device(sample_mask)
        advantages = self._to_device(advantages).float()
        self._zero_grads()
        loss = self._reinforce_loss(images, sampled, sample_mask,
                                    advantages)
        with torch.enable_grad():
            loss.backward()
        metrics = self._data_sum({"rl_loss": loss.detach()})
        metrics.update(self._apply_gradients())
        return metrics

    def scst_fused_step(self, images, ref_tokens, ref_valid,
                        rollouts=None) -> Dict[str, torch.Tensor]:
        """One SCST step on the device: the rollouts (``rollouts``, a
        (sampled, mask, greedy) triple, stands in for them), the CIDEr
        rewards, the update. Returns ``rl_loss``, ``reward``,
        ``greedy_reward`` and ``adv_abs`` (the mean |advantage|: 0 iff the
        step's gradient is identically zero), ``learning_rate`` and
        ``grad_norm``, as device scalars."""
        if rollouts is None:
            rollouts = self.rollout_step(
                self.rollout_model(), images,
                self._rollout_generator(self.step))
        sampled, mask, greedy = rollouts
        sample_r, greedy_r, adv = self.scst_rewards(sampled, greedy,
                                                    ref_tokens, ref_valid)
        metrics = self.rl_update_step(images, sampled, mask, adv)
        metrics.update(reward=self._global_mean(sample_r),
                       greedy_reward=self._global_mean(greedy_r),
                       adv_abs=self._global_mean(adv.abs()))
        return metrics

    def _references_by_image_id(self) -> Dict[int, list]:
        refs: Dict[int, list] = {}
        for ex in self.train_dataset.examples:
            refs.setdefault(ex["image_id"], []).append(ex["caption"])
        return refs

    def _tokenized_refs_by_image_id(self, max_length: int) -> Dict[int, list]:
        """Token-id reference lists per image (the device-CIDEr path)."""
        refs: Dict[int, list] = {}
        for ex in self.train_dataset.examples:
            ids, mask = self.tokenizer.encode(ex["caption"], max_length)
            refs.setdefault(ex["image_id"], []).append(
                ids[: int(mask.sum())].tolist())
        return refs

    def _train_reinforcement_learning(self, epoch: int,
                                      start_batch: int = 0) -> float:
        """The epoch's SCST pass; returns its mean RL loss."""
        tc = self.config.training
        try:
            if tc.rl_reward.lower() == "cider" and tc.rl_on_device_reward:
                return self._train_scst_on_device(epoch, start_batch)
            return self._train_scst_host_reward(epoch, start_batch)
        finally:
            # validation builds its own decode model
            self._rollout = None

    def _train_scst_on_device(self, epoch: int, start_batch: int = 0
                              ) -> float:
        """SCST pass with CIDEr rewards on the device."""
        self.logger.info("Running SCST (on-device CIDEr) for epoch %d",
                         epoch + 1)
        meter = MetricLogger()
        save_steps = getattr(self.config, "save_every_steps", 0)
        for i, batch in enumerate(self._train_batches(epoch, start_batch),
                                  start=start_batch):
            ref_tokens, ref_valid = self.scst_references(
                batch["image_id"].tolist())
            metrics = self.scst_fused_step(self._batch_inputs(batch),
                                           ref_tokens, ref_valid)
            meter.update(**{k: float(metrics[k]) for k in (
                "rl_loss", "reward", "greedy_reward", "adv_abs")})
            if save_steps and (i + 1) % save_steps == 0:
                self.save_step_checkpoint(epoch, i + 1, "scst")
            if (i + 1) % self.config.log_every == 0:
                self.logger.info("SCST batch %d: %s", i + 1, meter)
        return meter.averages().get("rl_loss", 0.0)

    def _train_scst_host_reward(self, epoch: int, start_batch: int = 0
                                ) -> float:
        """SCST pass with the rollouts decoded to text and scored on the
        host by the configured reward. Returns the mean RL loss, as the
        on-device pass does (the JAX trainer's returns None, and its resume
        inside this pass then fails on the epoch's loss)."""
        self.logger.info("Running SCST for epoch %d", epoch + 1)
        refs_by_id = self._references_by_image_id()
        meter = MetricLogger()
        save_steps = getattr(self.config, "save_every_steps", 0)
        for i, batch in enumerate(self._train_batches(epoch, start_batch),
                                  start=start_batch):
            images = self._batch_inputs(batch)
            sampled, sample_mask, greedy = self.rollout_step(
                self.rollout_model(), images,
                self._rollout_generator(self.step))
            sample_texts = [self.tokenizer.decode(t, skip_special_tokens=True)
                            for t in sampled.cpu().numpy()]
            greedy_texts = [self.tokenizer.decode(t, skip_special_tokens=True)
                            for t in greedy.cpu().numpy()]
            gt = [refs_by_id.get(iid, [""])
                  for iid in batch["image_id"].tolist()]
            sample_r = self._rewards(sample_texts, gt)
            greedy_r = self._rewards(greedy_texts, gt)
            advantages = torch.as_tensor(
                np.asarray(sample_r - greedy_r, dtype=np.float32))
            metrics = self.rl_update_step(images, sampled, sample_mask,
                                          advantages)
            meter.update(rl_loss=float(metrics["rl_loss"]),
                         reward=float(np.mean(sample_r)))
            if save_steps and (i + 1) % save_steps == 0:
                self.save_step_checkpoint(epoch, i + 1, "scst")
            if (i + 1) % self.config.log_every == 0:
                self.logger.info("SCST batch %d: %s", i + 1, meter)
        return meter.averages().get("rl_loss", 0.0)

    def _rewards(self, texts, refs) -> np.ndarray:
        """Per-sample rewards of the configured metric on the host: CIDEr-D,
        BLEU-4, METEOR (needs nltk, and raises without it), ROUGE-L, or
        SPICE (pycocoevalcap's Java scorer; CIDEr with one warning where it
        cannot run)."""
        reward_type = self.config.training.rl_reward.lower()
        if reward_type == "cider":
            return per_sample_cider(texts, refs)
        gen = [metric_tokenize(t) for t in texts]
        rr = [[metric_tokenize(r) for r in rs] for rs in refs]
        if reward_type == "bleu":
            _, ps = bleu(gen, rr)
            return ps[:, 3]
        if reward_type == "meteor":
            _, ps = meteor_lite(gen, rr)
            return ps
        if reward_type == "rouge":
            _, ps = rouge_l(gen, rr)
            return ps
        if reward_type == "spice":
            try:
                return per_sample_spice(texts, refs)
            except Exception as e:  # pycocoevalcap or Java missing
                if not getattr(self, "_spice_warned", False):
                    self._spice_warned = True
                    self.logger.warning(
                        "SPICE reward unavailable (%s: pycocoevalcap SPICE "
                        "needs Java); falling back to per-sample CIDEr", e)
                return per_sample_cider(texts, refs)
        self.logger.warning("Unknown reward '%s', using CIDEr", reward_type)
        return per_sample_cider(texts, refs)

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------

    def _validate_epoch(self, epoch: int) -> Tuple[float, Dict[str, float]]:
        # validation batch size = inference.num_candidates, as in the JAX
        # trainer, rounded up to a multiple of the data axis; each rank
        # takes its rows and the tokens are gathered on the host
        dp = self.mesh.dp if self.mesh is not None else 1
        nc = self.config.inference.num_candidates
        batch_size = -(-nc // dp) * dp
        gen = generator(self._rank_seed(self.config.seed + 17), self.device)
        losses = []
        generated, references, image_ids = [], [], []
        # pad_last so the trailing short batch is evaluated, covering every
        # val image
        it = iterate_batches(self.val_dataset, batch_size, shuffle=False,
                             drop_last=False, pad_last=True,
                             num_workers=self.config.num_workers,
                             rows=self._rows(batch_size))
        model = self.eval_state()
        # the reranker scores pixels: the object-region mode has none
        reranker = None if self._object_mode else self.reranker
        for batch in prefetch(it, self.device):
            first_ref = batch["caption_tokens"][:, 0, :]
            first_mask = batch["attention_mask"][:, 0, :]
            inputs = self._batch_inputs(batch)
            valid = batch.get("batch_valid")
            if valid is None:
                valid = torch.ones(len(first_ref), dtype=torch.bool,
                                   device=self.device)
            loss_b, ntok_b = self.eval_loss_step(model, inputs, first_ref,
                                                 first_mask, valid)
            losses.append((float(loss_b), float(ntok_b)))
            if reranker is not None:
                # the reranker reads the batch's device images: no second
                # host round trip
                tokens = reranker(
                    rerank_pixels(inputs, self.config.image_size),
                    self.val_decode_step(model, inputs, candidates=True))
            else:
                tokens = self.val_decode_step(model, inputs, gen)
            if isinstance(tokens, torch.Tensor):
                tokens = tokens.cpu().numpy()
            # every data rank's rows, in the global batch's order
            tokens = gather_rows_host(np.asarray(tokens), self.mesh)
            valid = gather_rows_host(valid.cpu().numpy(), self.mesh)
            ids = gather_rows_host(batch["image_id"].cpu().numpy(),
                                   self.mesh)
            for j in range(len(tokens)):
                if not valid[j]:
                    continue
                generated.append(self.tokenizer.decode(
                    tokens[j], skip_special_tokens=True))
                references.append(batch["captions"][j])
                image_ids.append(int(ids[j]))
        del model
        loss_sum, ntok = all_reduce_host(
            [sum(l * n for l, n in losses), sum(n for _, n in losses)],
            self.mesh)
        val_loss = float(loss_sum / max(ntok, 1)) if losses else 0.0
        metrics = calculate_metrics(generated, references, image_ids) \
            if generated else {"CIDEr": 0.0}
        return val_loss, metrics

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def save_checkpoint(self, epoch: int, is_best: bool = False):
        """The epoch checkpoint (and ``best_model``), written by global
        rank 0 (every rank of the model axis gathers)."""
        if not (self.is_main or self._sharded):
            return
        state = self._state_tree()
        if not self.is_main:
            return
        self.ckpt.save_epoch(
            epoch, state,
            metadata={"epoch": epoch, "best_val_score": self.best_val_score},
            config=self.config, is_best=is_best)

    def load_checkpoint(self, name: str = "best_model"):
        restored, meta, _ = self.ckpt.restore(name, self._state_tree())
        self.load_state(restored)
        self.best_val_score = meta.get("best_val_score", 0.0)
        if "batch_index" in meta:
            # mid-epoch (step) checkpoint: resume INSIDE meta["epoch"] at
            # the recorded batch index / phase
            self.start_epoch = meta.get("epoch", 0)
            self.start_batch = int(meta["batch_index"])
            self.start_phase = meta.get("phase", "ce")
            self.logger.info(
                "Loaded step checkpoint '%s' (epoch %d, %s batch %d, "
                "best %.4f)", name, self.start_epoch + 1, self.start_phase,
                self.start_batch, self.best_val_score)
            return
        self.start_epoch = meta.get("epoch", -1) + 1
        self.start_batch = 0
        self.start_phase = "ce"
        self.logger.info("Loaded checkpoint '%s' (epoch %d, best %.4f)",
                         name, self.start_epoch, self.best_val_score)

    def load_weights(self, name: str = "best_model"):
        """Restore params + BatchNorm statistics ONLY (optimizer state
        untouched), reading none of the optimizer's bytes. For
        inference-side swaps; resuming training takes
        :meth:`load_checkpoint`."""
        restored, meta, _ = self.ckpt.restore_partial(
            name, {"params": None, "batch_stats": None})
        self._load_weights(restored["params"], restored.get("batch_stats"))
        self.best_val_score = meta.get("best_val_score", 0.0)
        self.logger.info("Loaded weights from '%s' (best %.4f)",
                         name, self.best_val_score)
