"""Legacy demo: caption every image in a directory, in PyTorch.

Counterpart of ``image_captioning_ml_project_tpu.legacy.demo``: load a
trained legacy checkpoint (or the seed's weights), caption each image of a
directory with the greedy decode, optionally render the attention
overlays.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..data.coco import load_image, normalize_images
from .model import ShowAttendTell
from .validate import strip_specials, visualize_attention


@torch.inference_mode()
def generate_captions(model: ShowAttendTell, vocab, image_dir: str,
                      image_size: int = 224, max_length: int = 20,
                      save_attention_dir: Optional[str] = None
                      ) -> Dict[str, str]:
    """Caption all images in ``image_dir`` (files that do not load as
    images are skipped) on ``model``'s device; returns {filename:
    caption}."""
    logger = logging.getLogger(__name__)
    device = next(model.parameters()).device
    model.eval()
    results = {}
    for name in sorted(os.listdir(image_dir)):
        path = os.path.join(image_dir, name)
        try:
            img = load_image(path, image_size, train=False)
        except Exception:
            continue
        images = normalize_images(torch.from_numpy(np.array(img[None])).to(
            device))
        tokens, alphas = model.generate(images, max_length,
                                        start_token_id=vocab.bos_token_id)
        words = strip_specials(tokens[0].cpu().numpy(), vocab)
        caption = " ".join(words)
        results[name] = caption
        logger.info("%s: %s", name, caption)
        if save_attention_dir:
            visualize_attention(
                img, words, alphas[0].cpu().numpy(),
                grid_size=model.encoded_image_size,
                save_path=os.path.join(save_attention_dir,
                                       f"{os.path.splitext(name)[0]}_att.png"))
    return results


def main(argv=None):
    """Script entry::

        python -m image_captioning_ml_project_tpu_torch.legacy.demo \\
            --vocab vocab.json --image_dir images/ \\
            [--checkpoint_dir ckpts --encoder_ckpt ... --decoder_ckpt ...] \\
            [--attention_dir out/att] [--device cpu]
    """
    import argparse

    from ..data.tokenizer import WordVocab
    from ..utils.logging import setup_logging
    from .validate import build_legacy_model

    p = argparse.ArgumentParser(description="Legacy captioning demo")
    p.add_argument("--vocab", type=str, required=True)
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--encoder_ckpt", type=str, default="encoder_epoch_0")
    p.add_argument("--decoder_ckpt", type=str, default="decoder_epoch_0")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--max_length", type=int, default=20)
    p.add_argument("--attention_dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    setup_logging(None)
    vocab = WordVocab.load(args.vocab)
    model = build_legacy_model(vocab, args.image_size, args.checkpoint_dir,
                               args.encoder_ckpt, args.decoder_ckpt,
                               device=args.device)
    results = generate_captions(model, vocab, args.image_dir,
                                image_size=args.image_size,
                                max_length=args.max_length,
                                save_attention_dir=args.attention_dir)
    for name, caption in results.items():
        print(f"{name}: {caption}")
    return results


if __name__ == "__main__":
    main()
