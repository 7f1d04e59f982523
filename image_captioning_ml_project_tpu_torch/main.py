"""CLI entry point of the PyTorch port: ``--mode train``, ``eval``,
``demo`` and ``serve``.

The JAX CLI's flags (``python -m image_captioning_ml_project_tpu.main``),
applied to the config as it applies them, plus ``--device`` (``cuda``
unless asked for the CPU) and ``--seed``. Run as::

    python -m image_captioning_ml_project_tpu_torch.main --mode train \
        --config flagship --data_root data --output_dir runs/x
    python -m image_captioning_ml_project_tpu_torch.main --mode eval \
        --config flagship --data_root data --vocab runs/x/vocab.json \
        --output_dir runs/x --checkpoint best_model
    python -m image_captioning_ml_project_tpu_torch.main --mode demo \
        --config flagship --vocab runs/x/vocab.json --output_dir runs/x \
        --checkpoint best_model --image_path photo.jpg
    python -m image_captioning_ml_project_tpu_torch.main --mode serve \
        --config flagship --vocab runs/x/vocab.json \
        --output_dir runs/x --checkpoint best_model

``--config`` takes a JSON file, or the name of a built-in configuration:
``flagship`` (:func:`flagship_config`, CLIP + GPT-2), ``transformer``
(:func:`transformer_config`, ViT + Transformer decoder; ``--encoder_type
swin`` puts Swin-B in the ViT's place), ``lstm`` (:func:`lstm_config`,
ResNet-101 + LSTM with soft attention; ``--attention_type
multi_head|adaptive|aoa`` picks another variant), ``qformer``
(:func:`qformer_config`, ViT + Q-Former + Transformer decoder) or
``butd`` (:func:`butd_config`, detector regions + Transformer decoder);
without it the JAX package's default configuration (ViT-B/16 + 6-layer
GPT-2). In the object-region mode (``butd``, or any configuration with
``use_object_features``) train and eval read detector features under
``data_root/features_dir`` (:func:`.data.coco.build_object_datasets`),
and CLIP reranking is skipped with a warning: there are no pixels to
score.

``train`` builds the COCO datasets under ``--data_root``, the tokenizer
and :class:`.train.trainer.CaptioningTrainer`, resumes from
``--checkpoint`` when given (an epoch checkpoint, ``best_model`` or the
rolling ``checkpoint_step``), and trains: cross-entropy every epoch
(in the curriculum's order with ``use_curriculum``), then with ``use_rl``
(the default) an SCST pass from ``rl_start_epoch``, writing checkpoints
under ``output_dir/checkpoints``; with ``use_clip_reranking`` validation
reranks its beam candidates.

``eval`` captions every validation image of ``--data_root`` with the
``--checkpoint`` weights (or the seed's), in batches of
``inference.num_candidates`` (the reference's quirk), writes
``output_dir/results.json`` and logs the caption metrics. ``demo``
captions ``--image_path``, prints the caption and, where matplotlib is
installed, saves ``output_dir/demo.png``. Both decode with the
``inference`` section's strategy, and with ``use_clip_reranking`` rerank
``num_candidates`` beam candidates with CLIP.

``serve`` loads ``--checkpoint`` (its weights only) or, without one,
draws the weights from ``--seed``, and answers ``/caption`` and
``/reload``. The JSON config's ``inference`` section picks the decode:
``decoding_strategy`` ``beam`` (``beam_size``, ``num_beam_groups`` and
``diversity_penalty`` for diverse groups), ``greedy`` or ``nucleus``
(``top_p``, ``temperature``), and ``use_clip_reranking``
(``num_candidates``), which needs a locally cached HF CLIP checkpoint
(without one the service warns and serves without reranking).

Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set),
every mode is one rank of a mesh: the process group starts
(:func:`.parallel.mesh.init_distributed`: NCCL for CUDA tensors where
every local rank has its card, gloo where ranks share one), the mesh is
built from the config's ``mesh`` section (``data_parallel``,
``model_parallel``; -1 takes the rest), rank ``r`` runs on
``cuda:{LOCAL_RANK % cards}``, and the group is torn down at the end.
``eval`` rounds its batch up to the data axis and each rank decodes its
rows. Only global rank 0 writes checkpoints, ``results.json`` and the log
file. ``serve`` is the JAX ``CaptionService(mesh=)``: rank 0 binds
``--port`` and batches, every rank decodes its data rank's rows of each
batch (:mod:`.inference.server`), and SIGTERM to the launcher drains rank
0, which stops the others. ``demo`` decodes the one image on every rank
(replicated over the data axis, as the JAX demo's unsharded image is);
only rank 0 prints it and writes ``demo.png``. Serving and the demo
decode on each rank's shards of GPT-2's heads under a model axis
(:func:`.parallel.sharding.shard_decode_model`); ``eval`` and validation
decode on gathered weights::

    torchrun --nproc_per_node 2 -m image_captioning_ml_project_tpu_torch.main \
        --mode train --config run.json --data_root data --output_dir runs/x
    torchrun --nproc_per_node 2 -m image_captioning_ml_project_tpu_torch.main \
        --mode serve --config run.json --vocab runs/x/vocab.json \
        --output_dir runs/x --checkpoint best_model --port 8000

``--native_loader`` decodes JPEGs with the port's C++ loader
(:mod:`.native`; PIL where it did not build). ``--device_resize`` moves
eval's resize and normalisation to the device: the host decodes each
image's centre square onto a canvas (:func:`.data.coco.
load_image_square`) and :func:`.ops.resize.resize_normalize` does the
rest. ``--fold_normalize`` hands uint8 pixels to a ViT or CLIP patch
embed, which folds the ImageNet normalisation into its matrix product
(:class:`.models.encoders.PatchEmbed`).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional

import numpy as np
import torch

from .config import (AttentionType, Config, DecoderType, EncoderType,
                     get_default_config, load_config, reads_regions,
                     save_config)
from .data.tokenizer import HFTokenizerAdapter, WordVocab


def flagship_config() -> Config:
    """The served main path: CLIP ViT-B/32 vision tower (12 layers, width
    768, 224x224 input) -> 10-token image prefix -> GPT-2 (12 layers,
    12 heads, width 768, vocab 50257, tied LM head), beam 5, max length 20,
    length penalty 0.8, min length 5; bf16 weights."""
    c = get_default_config()
    c.model.encoder.encoder_type = EncoderType.CLIP
    c.model.encoder.hidden_size = 768
    c.model.encoder.num_layers = 12
    c.model.encoder.num_heads = 12
    c.model.encoder.patch_size = 32
    c.model.encoder.feature_dim = 768
    c.model.decoder.decoder_type = DecoderType.GPT2
    c.model.decoder.hidden_dim = 768
    c.model.decoder.num_layers = 12
    c.model.decoder.num_heads = 12
    c.model.decoder.prefix_length = 10
    c.model.vocab_size = 50257
    c.model.dtype = "bfloat16"
    c.image_size = 224
    c.inference.beam_size = 5
    c.inference.max_length = 20
    c.inference.length_penalty = 0.8
    c.inference.min_length = 5
    return c


def transformer_config() -> Config:
    """The Transformer-decoder family at the widths of the JAX package's
    ``scripts/bench_transformer.py``: ViT-B/16 (12 layers, width 768, 12
    heads, 224x224 input: 196 patch tokens) -> 6-layer Transformer decoder
    (width 768, 12 heads, learned positions for 24 tokens) over vocab
    30000, beam 5, max length 20, length penalty 0.8, min length 5; bf16
    weights."""
    c = get_default_config()
    c.model.encoder.encoder_type = EncoderType.VIT
    c.model.encoder.hidden_size = 768
    c.model.encoder.num_layers = 12
    c.model.encoder.num_heads = 12
    c.model.encoder.patch_size = 16
    c.model.encoder.feature_dim = 768
    c.model.decoder.decoder_type = DecoderType.TRANSFORMER
    c.model.decoder.hidden_dim = 768
    c.model.decoder.num_layers = 6
    c.model.decoder.num_heads = 12
    c.model.decoder.max_length = 24
    c.model.attention.attention_type = AttentionType.MULTI_HEAD
    c.model.vocab_size = 30_000
    c.model.dtype = "bfloat16"
    c.image_size = 224
    c.inference.beam_size = 5
    c.inference.max_length = 20
    c.inference.length_penalty = 0.8
    c.inference.min_length = 5
    return c


def lstm_config() -> Config:
    """The LSTM family at the widths of the JAX package's
    ``scripts/bench_lstm.py``: ResNet-101 (bottleneck stages of depths
    3, 4, 23, 3 and widths 256-2048, stem 64, 224x224 input: 7x7 = 49
    feature rows, projected to 512) -> 6-layer LSTM (width 512) with soft
    attention (width 512, 8 heads for the variants that use them) through
    the JAX package's kernel switch ``use_pallas``, vocab 10000, beam 5, max
    length 20, length penalty 0.8, min length 5; bf16 weights."""
    c = get_default_config()
    c.model.encoder.encoder_type = EncoderType.RESNET
    c.model.encoder.resnet_depths = (3, 4, 23, 3)
    c.model.encoder.resnet_hidden_sizes = (256, 512, 1024, 2048)
    c.model.encoder.resnet_embedding_size = 64
    c.model.encoder.resnet_layer_type = "bottleneck"
    c.model.encoder.feature_dim = 512
    c.model.decoder.decoder_type = DecoderType.LSTM
    c.model.decoder.hidden_dim = 512
    c.model.decoder.num_layers = 6
    c.model.attention.attention_type = AttentionType.SOFT
    c.model.attention.hidden_dim = 512
    c.model.attention.num_heads = 8
    c.model.attention.use_pallas = True
    c.model.projection_dim = 512
    c.model.vocab_size = 10_000
    c.model.dtype = "bfloat16"
    c.image_size = 224
    c.inference.beam_size = 5
    c.inference.max_length = 20
    c.inference.length_penalty = 0.8
    c.inference.min_length = 5
    return c


def qformer_config() -> Config:
    """The Q-Former family at the widths of the JAX package's
    ``scripts/bench_families.py`` (its ``on_tpu`` branch): ViT-B/16 (the
    default encoder: 12 layers, width 768, 224x224 input) -> a Q-Former of
    32 learned queries, 2 self-attention + 2 cross-attention layers of
    width 768 with 8 heads -> 6-layer Transformer decoder (width 768, 12
    heads, learned positions for 24 tokens) over vocab 30000, beam 5, max
    length 20; bf16 weights."""
    c = _bench_families_config()
    c.model.encoder.encoder_type = EncoderType.VIT
    c.model.use_q_former = True
    c.model.projection_dim = c.model.decoder.hidden_dim
    c.model.q_former_num_queries = 32
    c.model.q_former_num_layers = 2
    c.model.q_former_num_heads = 8
    return c


def butd_config() -> Config:
    """The bottom-up top-down family at the widths of the JAX package's
    ``scripts/bench_families.py``: the object-region encoder over 36
    detector regions of 2048-d features and their boxes, projected to 768
    -> the same 6-layer Transformer decoder as :func:`qformer_config`."""
    c = _bench_families_config()
    c.model.encoder.encoder_type = EncoderType.OBJECT_REGION
    c.model.encoder.max_objects = 36
    c.model.encoder.region_feature_dim = 2048
    c.model.encoder.feature_dim = c.model.decoder.hidden_dim
    c.model.projection_dim = c.model.decoder.hidden_dim
    return c


def _bench_families_config() -> Config:
    """What ``bench_families.build_config`` sets for both families: the
    Transformer decoder (width 768, 6 layers, 12 heads, 24 positions),
    multi-head attention, vocab 30000, beam 5, max length 20; bf16."""
    c = get_default_config()
    c.model.decoder.decoder_type = DecoderType.TRANSFORMER
    c.model.attention.attention_type = AttentionType.MULTI_HEAD
    c.model.decoder.hidden_dim = 768
    c.model.decoder.num_layers = 6
    c.model.decoder.num_heads = 12
    c.model.decoder.max_length = 24
    c.model.vocab_size = 30_000
    c.model.dtype = "bfloat16"
    c.inference.max_length = 20
    c.inference.beam_size = 5
    return c


CONFIGS = {"flagship": flagship_config, "transformer": transformer_config,
           "lstm": lstm_config, "qformer": qformer_config,
           "butd": butd_config}



def resolve_config(name: Optional[str]) -> Config:
    """``--config``: a built-in configuration's name (:data:`CONFIGS`), a
    JSON file, or None for the JAX package's default configuration."""
    if name is None:
        return get_default_config()
    if name in CONFIGS:
        return CONFIGS[name]()
    return load_config(name)


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Image captioning on NVIDIA GPUs (PyTorch/CUDA port)")
    parser.add_argument("--mode", type=str, default="serve",
                        choices=["train", "eval", "demo", "serve"])
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config file, or a built-in configuration:"
                             " " + ", ".join(CONFIGS))
    parser.add_argument("--save_config", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--num_epochs", type=int, default=None)
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--encoder_type", type=str, default=None,
                        choices=["resnet", "vit", "swin", "clip"])
    parser.add_argument("--decoder_type", type=str, default=None,
                        choices=["lstm", "transformer", "gpt2"])
    parser.add_argument("--attention_type", type=str, default=None,
                        choices=["soft", "multi_head", "adaptive", "aoa"])
    parser.add_argument("--use_rl", action="store_true",
                        help="SCST fine-tuning from rl_start_epoch")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--image_path", type=str, default=None,
                        help="The image --mode demo captions")
    parser.add_argument("--vocab", type=str, default=None,
                        help="Word-vocab JSON path; without it a locally "
                             "cached HF tokenizer of the decoder's "
                             "pretrained name, else a vocab built from the "
                             "train annotations")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train or serve on (cuda, "
                             "cuda:N, cpu)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the weights drawn when no checkpoint "
                             "is given (default: the config's seed)")
    parser.add_argument("--native_loader", action="store_true",
                        help="Decode JPEGs with the native C++ loader "
                             "(native/jpeg_loader.cpp, built with g++ and "
                             "libjpeg at first use); PIL where it did not "
                             "build")
    parser.add_argument("--native_threads", type=int, default=None,
                        help="Native decode threads (0 = one per host CPU)")
    parser.add_argument("--native_draft", action="store_true",
                        help="DCT-scaled native eval decode (the fastest; "
                             "device_resize-grade resampling instead of "
                             "PIL's)")
    parser.add_argument("--device_resize", action="store_true",
                        help="Device-resident eval preprocessing: the host "
                             "decodes only; resize and normalisation run "
                             "on the device (ops/resize.py)")
    parser.add_argument("--fold_normalize", action="store_true",
                        help="Fold the ImageNet normalisation into the "
                             "ViT/CLIP patch-embed matmul: the model takes "
                             "raw uint8 pixels (models/encoders.PatchEmbed)")
    parser.add_argument("--save_every_steps", type=int, default=None,
                        help="Rolling mid-epoch checkpoint every N train "
                             "batches (two alternating slots)")
    parser.add_argument("--step_ckpt_max_overhead", type=float,
                        default=None,
                        help="Skip step checkpoints while the last one's "
                             "blocking cost exceeds this share of wall time")
    serve = parser.add_argument_group("serve mode (inference/server.py)")
    serve.add_argument("--host", type=str, default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8000)
    serve.add_argument("--serve_batch_size", type=int, default=8,
                       help="Largest micro-batch one decode runs")
    serve.add_argument("--serve_pipeline_depth", type=int, default=2,
                       help="device batches in flight: the batcher decodes "
                            "batch N+1 while batch N is being detokenized")
    serve.add_argument("--serve_max_wait_ms", type=float, default=10.0,
                       help="Max time the batcher holds a partial batch "
                            "waiting for more requests")
    serve.add_argument("--serve_buckets", type=str, default=None,
                       help="Comma-separated batch-shape ladder (e.g. "
                            "1,8,64); each micro-batch runs on the smallest "
                            "bucket >= queue depth. Default 1,8,max")
    return parser


def _update_config_from_args(config: Config, args) -> None:
    if args.output_dir:
        config.output_dir = args.output_dir
        config.checkpoint_dir = os.path.join(args.output_dir, "checkpoints")
    if args.batch_size:
        config.training.batch_size = args.batch_size
    if args.num_epochs:
        config.training.num_epochs = args.num_epochs
    if args.learning_rate:
        config.training.learning_rate = args.learning_rate
    if args.encoder_type:
        config.model.encoder.encoder_type = EncoderType(args.encoder_type)
    if args.decoder_type:
        config.model.decoder.decoder_type = DecoderType(args.decoder_type)
    if args.attention_type:
        config.model.attention.attention_type = AttentionType(
            args.attention_type)
    if args.use_rl:
        config.training.use_rl = True
    if args.data_root:
        config.data_root = args.data_root
    if args.seed is not None:
        config.seed = args.seed
    if args.device_resize:
        config.device_resize = True
    if args.native_loader:
        config.native_loader = True
    if args.native_threads is not None:
        config.native_threads = args.native_threads
    if args.native_draft:
        config.native_draft = True
    if args.fold_normalize:
        config.fold_normalize = True
    if args.save_every_steps is not None:
        config.save_every_steps = args.save_every_steps
    if args.step_ckpt_max_overhead is not None:
        config.step_ckpt_max_overhead = args.step_ckpt_max_overhead


def setup_tokenizer(config: Config, vocab_path: Optional[str] = None):
    """Resolve the tokenizer and wire its special-token ids into the
    config, in the JAX package's order: an explicit ``--vocab`` JSON, else
    the locally cached HF tokenizer of ``decoder.pretrained_model_name``
    (``local_files_only``: nothing is downloaded), else a word vocabulary
    built from the train annotations (saved to ``output_dir/vocab.json``).
    Any failure of the HF branch, ``transformers`` missing included, falls
    through to the word vocabulary."""
    logger = logging.getLogger(__name__)
    if vocab_path and os.path.exists(vocab_path):
        tokenizer = WordVocab.load(vocab_path)
    else:
        try:
            from transformers import AutoTokenizer

            hf = AutoTokenizer.from_pretrained(
                config.model.decoder.pretrained_model_name,
                local_files_only=True)
            tokenizer = HFTokenizerAdapter(hf)
        except Exception:
            train_json = os.path.join(config.data_root, config.train_json)
            logger.info("No cached HF tokenizer; building word vocab from "
                        "%s", train_json)
            with open(train_json) as f:
                ann = json.load(f)
            tokenizer = WordVocab.build([a["caption"]
                                         for a in ann["annotations"]])
            os.makedirs(config.output_dir, exist_ok=True)
            out = vocab_path or os.path.join(config.output_dir, "vocab.json")
            tokenizer.save(out)
            logger.info("Saved vocab (%d words) to %s", len(tokenizer), out)
    config.model.vocab_size = len(tokenizer)
    config.model.pad_token_id = int(tokenizer.pad_token_id)
    config.model.bos_token_id = int(tokenizer.bos_token_id)
    config.model.eos_token_id = int(tokenizer.eos_token_id)
    return tokenizer


def _resolve_reranker(config: Config, tokenizer, reranker, device):
    """The CLIP reranker when ``use_clip_reranking`` is set: an injected
    ``reranker`` wins; otherwise one is built on ``device`` from a locally
    cached HF CLIP checkpoint, or None with a warning when there is none
    (:func:`.inference.reranking.build_hf_reranker`)."""
    if not config.inference.use_clip_reranking:
        return None
    if reranker is not None:
        return reranker
    from .inference.reranking import build_hf_reranker

    return build_hf_reranker(
        lambda ids: tokenizer.decode(ids, skip_special_tokens=True), device)


def _datasets(config: Config, tokenizer):
    """The train/val pair: detector features in the object-region mode,
    else COCO images."""
    from .data.coco import build_coco_datasets, build_object_datasets

    if reads_regions(config.model.encoder):
        return build_object_datasets(config, tokenizer)
    return build_coco_datasets(config, tokenizer)


def train(config: Config, checkpoint_path: Optional[str] = None,
          tokenizer=None, device="cuda", reranker=None, mesh=None):
    """Training on ``device`` (the JAX CLI's ``train``): the COCO
    datasets, the tokenizer, the curriculum sampler when
    ``use_curriculum`` is set, the CLIP reranker of validation when
    ``use_clip_reranking`` is set (``reranker``, or one built by
    :func:`_resolve_reranker`), the trainer, an optional resume from
    ``checkpoint_path``, then ``train()``: cross-entropy epochs, and SCST
    from ``rl_start_epoch`` when ``use_rl``; one rank of ``mesh`` where
    one is given. Returns the trainer."""
    from .train.curriculum import create_curriculum_sampler
    from .train.trainer import CaptioningTrainer

    tokenizer = tokenizer or setup_tokenizer(config)
    train_ds, val_ds = _datasets(config, tokenizer)
    sampler = create_curriculum_sampler(train_ds, config)
    # with use_clip_reranking, validation reranks too, so the best-CIDEr
    # checkpoint is selected by the decode that ships (not in the
    # object-region mode: no pixels)
    if not reads_regions(config.model.encoder):
        reranker = _resolve_reranker(config, tokenizer, reranker, device)
    trainer = CaptioningTrainer(config, train_ds, val_ds, tokenizer,
                                curriculum_sampler=sampler,
                                reranker=reranker, device=device, mesh=mesh)
    if checkpoint_path:
        trainer.load_checkpoint(checkpoint_path)
    trainer.train()
    return trainer


def _load_decode_model(config: Config, checkpoint_path: Optional[str],
                       device):
    """The decode model of eval and the demo on ``device``: the model
    weights of ``checkpoint_path`` (read memory-mapped, the optimizer's
    files left unread), or the seed's without one, cast as a trainer's
    validation casts them (:func:`.train.trainer.load_decode_model`)."""
    from .train.trainer import load_decode_model
    from .utils.checkpoint import CheckpointManager

    weights = (CheckpointManager(config.checkpoint_dir).model_weights(
        checkpoint_path) if checkpoint_path else None)
    return load_decode_model(config, device, weights)


def evaluate(config: Config, checkpoint_path: Optional[str] = None,
             tokenizer=None, reranker=None, device="cuda", mesh=None):
    """Caption the validation set on ``device`` with the configured
    strategy (the JAX CLI's ``eval``) and return the caption metrics: the
    ``checkpoint_path`` weights (or the seed's) in one decode model for
    the run (:func:`_load_decode_model`), batches of
    ``inference.num_candidates`` (the reference's quirk) rounded up to a
    multiple of ``mesh``'s data axis, each rank decoding its rows and the
    tokens gathered on the host (only rank 0 writes ``results.json``),
    the last batch padded and its padding ignored,
    and with ``use_clip_reranking`` the reranker (``reranker``, or
    :func:`_resolve_reranker`'s) picking among ``num_candidates`` beam
    candidates on the batch's device images (from ``device_resize``
    canvases, the resized pixels the captioner saw; skipped with a warning
    in the object-region mode). Scored by
    :func:`.evaluate.coco_eval.evaluate_model_on_coco`, which also writes
    ``output_dir/results.json``."""
    from .evaluate.coco_eval import evaluate_model_on_coco
    from .inference.decoding import decode_images
    from .train.trainer import (batch_inputs, prepare_inputs, rerank_pixels,
                                to_device)

    tokenizer = tokenizer or setup_tokenizer(config)
    _, val_ds = _datasets(config, tokenizer)
    model = _load_decode_model(config, checkpoint_path, device)
    regions = reads_regions(config.model.encoder)
    if regions and config.inference.use_clip_reranking:
        logging.getLogger(__name__).warning(
            "CLIP reranking needs raw images; the object-region pipeline "
            "carries detector features only: skipping it")
        reranker = None
    else:
        reranker = _resolve_reranker(config, tokenizer, reranker, device)
    seed = config.seed if mesh is None else config.seed + mesh.data_rank
    generator = torch.Generator(device=device).manual_seed(seed)

    @torch.inference_mode()
    def decode_rows(batch):
        inputs = to_device(batch_inputs(batch, regions), device)
        tokens = decode_images(model, prepare_inputs(inputs,
                                                     config.image_size),
                               config, generator,
                               candidates=reranker is not None)
        if reranker is not None:
            tokens = reranker(rerank_pixels(inputs, config.image_size),
                              tokens)
        return tokens

    dp = mesh.dp if mesh is not None else 1
    main_rank = mesh is None or mesh.rank == 0
    return evaluate_model_on_coco(
        decode_rows, val_ds, tokenizer,
        batch_size=-(-config.inference.num_candidates // dp) * dp,
        results_file=(os.path.join(config.output_dir, "results.json")
                      if main_rank else None),
        num_workers=config.num_workers, mesh=mesh)


def demo(config: Config, checkpoint_path: Optional[str] = None,
         image_path: Optional[str] = None, tokenizer=None, show: bool = False,
         reranker=None, device="cuda", mesh=None) -> str:
    """Caption one image on ``device`` (the JAX CLI's ``demo``) with the
    eval transform, the configured strategy and, with
    ``use_clip_reranking``, CLIP reranking; prints and returns the
    caption, and saves ``output_dir/demo.png`` where matplotlib is
    installed (a failure of the plot is ignored, one of the decode is
    not). Under a ``mesh`` every rank decodes the image (replicated over
    the data axis), the model ranks together on their shards; only rank 0
    prints, logs and plots, and every rank returns the caption."""
    from .data.coco import load_image
    from .inference.decoding import decode_images
    from .parallel.sharding import shard_decode_model

    tokenizer = tokenizer or setup_tokenizer(config)
    model = shard_decode_model(
        _load_decode_model(config, checkpoint_path, device), mesh)
    reranker = _resolve_reranker(config, tokenizer, reranker, device)
    img = load_image(image_path, config.image_size, train=False)
    with torch.inference_mode():
        images = torch.from_numpy(np.array(img[None])).to(device)
        tokens = decode_images(
            model, images, config,
            torch.Generator(device=device).manual_seed(config.seed),
            candidates=reranker is not None)
        if reranker is not None:
            tokens = reranker(images, tokens)
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu().numpy()
    caption = tokenizer.decode(np.asarray(tokens)[0],
                               skip_special_tokens=True)
    if mesh is not None and mesh.rank != 0:
        return caption
    logging.getLogger(__name__).info("Generated caption: %s", caption)
    print(caption)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(8, 6))
        plt.imshow(img)
        plt.title(caption)
        plt.axis("off")
        os.makedirs(config.output_dir, exist_ok=True)
        plt.savefig(os.path.join(config.output_dir, "demo.png"))
        if show:
            plt.show()
        plt.close()
    except Exception:
        pass
    return caption


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device is available; pass --device cpu "
                         f"to {args.mode} on the CPU")
    if args.mode == "demo" and not args.image_path:
        raise SystemExit("--image_path is required for demo mode")
    config = resolve_config(args.config)
    _update_config_from_args(config, args)
    if args.save_config:
        save_config(config, args.save_config)
    logging.basicConfig(level=logging.INFO)
    tokenizer = setup_tokenizer(config, vocab_path=args.vocab)
    return _run_mode(config, args, tokenizer)


def _run_mode(config: Config, args, tokenizer):
    """Any ``--mode``: alone, or under ``torchrun`` as one rank of the
    config's mesh (the process group torn down after; each rank logs that
    it ended cleanly)."""
    from .parallel.mesh import create_mesh, init_distributed, rank_device

    ranks = init_distributed()
    device, mesh = args.device, None
    if ranks is not None:
        device = rank_device(args.device, ranks[2])
        mesh = create_mesh(config.mesh)
    try:
        if args.mode == "train":
            result = train(config, checkpoint_path=args.checkpoint,
                           tokenizer=tokenizer, device=device, mesh=mesh)
        elif args.mode == "eval":
            result = evaluate(config, args.checkpoint, tokenizer=tokenizer,
                              device=device, mesh=mesh)
        elif args.mode == "demo":
            result = demo(config, args.checkpoint, args.image_path,
                          tokenizer=tokenizer, device=device, mesh=mesh)
        else:
            from .inference.server import serve

            result = serve(
                config, tokenizer, device, host=args.host, port=args.port,
                batch_size=args.serve_batch_size,
                max_wait_ms=args.serve_max_wait_ms,
                pipeline_depth=args.serve_pipeline_depth,
                bucket_sizes=[int(b) for b in args.serve_buckets.split(",")]
                if args.serve_buckets else None,
                checkpoint_path=args.checkpoint, mesh=mesh)
    finally:
        if ranks is not None:
            torch.distributed.destroy_process_group()
    if ranks is not None:
        logging.getLogger(__name__).info(
            "rank %d of %d: --mode %s ended cleanly", ranks[0], ranks[1],
            args.mode)
    return result


if __name__ == "__main__":
    main()
