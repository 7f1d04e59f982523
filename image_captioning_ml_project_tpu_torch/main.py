"""CLI entry point of the PyTorch port: ``--mode serve``.

Same flags as the JAX CLI's serve path
(``python -m image_captioning_ml_project_tpu.main --mode serve``), plus
``--device`` and ``--seed``. Run as::

    python -m image_captioning_ml_project_tpu_torch.main --mode serve \\
        --config flagship.json --vocab vocab.json

With no checkpoint the weights are drawn from ``--seed`` (checkpoint
restore is not yet ported). Training, evaluation and the demo are not yet
ported and raise.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional

import torch

from .config import (AttentionType, Config, DecoderType, EncoderType,
                     get_default_config, load_config, save_config)
from .data.tokenizer import WordVocab


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


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Image captioning on NVIDIA GPUs (PyTorch/CUDA port)")
    parser.add_argument("--mode", type=str, default="serve",
                        choices=["train", "eval", "demo", "serve"])
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--save_config", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--encoder_type", type=str, default=None,
                        choices=["resnet", "vit", "swin", "clip"])
    parser.add_argument("--decoder_type", type=str, default=None,
                        choices=["lstm", "transformer", "gpt2"])
    parser.add_argument("--attention_type", type=str, default=None,
                        choices=["soft", "multi_head", "adaptive", "aoa"])
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--vocab", type=str, default=None,
                        help="Word-vocab JSON path (built from train "
                             "annotations if absent)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to serve on (cuda, cuda:N, cpu)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the weights drawn when no checkpoint "
                             "is given (default: the config's seed)")
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
    if args.encoder_type:
        config.model.encoder.encoder_type = EncoderType(args.encoder_type)
    if args.decoder_type:
        config.model.decoder.decoder_type = DecoderType(args.decoder_type)
    if args.attention_type:
        config.model.attention.attention_type = AttentionType(
            args.attention_type)
    if args.data_root:
        config.data_root = args.data_root
    if args.seed is not None:
        config.seed = args.seed


def setup_tokenizer(config: Config, vocab_path: Optional[str] = None):
    """Resolve the word vocabulary and wire its special-token ids into the
    config: an explicit ``--vocab`` JSON, else one built from the train
    annotations (saved to ``output_dir/vocab.json``). HF tokenizers are not
    used: the GPU machine carries no ``transformers``."""
    logger = logging.getLogger(__name__)
    if vocab_path and os.path.exists(vocab_path):
        tokenizer = WordVocab.load(vocab_path)
    else:
        train_json = os.path.join(config.data_root, config.train_json)
        logger.info("Building word vocab from %s", train_json)
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


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.mode != "serve":
        raise NotImplementedError(
            f"--mode {args.mode} is not yet ported to PyTorch (ROADMAP.md "
            f"Queue 1: remaining CLI modes)")
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to "
                         "serve on the CPU")
    config = load_config(args.config) if args.config else get_default_config()
    _update_config_from_args(config, args)
    if args.save_config:
        save_config(config, args.save_config)
    logging.basicConfig(level=logging.INFO)
    tokenizer = setup_tokenizer(config, vocab_path=args.vocab)

    from .inference.server import serve

    serve(config, tokenizer, args.device, host=args.host, port=args.port,
          batch_size=args.serve_batch_size,
          max_wait_ms=args.serve_max_wait_ms,
          pipeline_depth=args.serve_pipeline_depth,
          bucket_sizes=[int(b) for b in args.serve_buckets.split(",")]
          if args.serve_buckets else None,
          checkpoint_path=args.checkpoint)


if __name__ == "__main__":
    main()
