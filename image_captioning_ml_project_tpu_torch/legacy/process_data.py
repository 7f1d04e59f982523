"""Legacy data preparation: vocabulary building and image resizing (a
copy of ``image_captioning_ml_project_tpu.legacy.process_data`` over the
port's ``WordVocab``).

Parity with the reference's preprocessing script
(reference: processData.py:30-96): build a frequency-thresholded word
vocabulary from COCO train captions (threshold 5, :43-46) and batch-resize
images — center-crop to square then resize to 224x224 into ``*_resized``
directories (:53-67, 82-94). Exposed as a module CLI::

    python -m image_captioning_ml_project_tpu_torch.legacy.process_data \
        --caption_path .../captions_train2014.json --vocab_path vocab.json \
        --image_dir train2014 --output_dir train2014_resized
"""

from __future__ import annotations

import argparse
import json
import os
from ..data.tokenizer import WordVocab


def build_vocab(caption_path: str, threshold: int = 5) -> WordVocab:
    """reference: processData.py:30-50."""
    with open(caption_path) as f:
        ann = json.load(f)
    return WordVocab.build([a["caption"] for a in ann["annotations"]],
                           threshold=threshold)


def resize_image(image, size: int = 224):
    """Center-crop to square, then resize (reference: processData.py:53-67)."""
    from PIL import Image

    W, H = image.size
    side = min(W, H)
    left = (W - side) // 2
    top = (H - side) // 2
    image = image.crop((left, top, left + side, top + side))
    return image.resize((size, size), Image.LANCZOS)


def resize_images(image_dir: str, output_dir: str, size: int = 224) -> int:
    """reference: processData.py:82-94. Returns the number resized."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(image_dir)):
        path = os.path.join(image_dir, name)
        try:
            with Image.open(path) as img:
                resize_image(img.convert("RGB"), size).save(
                    os.path.join(output_dir, name))
            count += 1
        except Exception as e:  # skip non-images
            print(f"skip {name}: {e}")
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description="Legacy COCO preprocessing")
    p.add_argument("--caption_path", type=str, default=None)
    p.add_argument("--vocab_path", type=str, default="vocab.json")
    p.add_argument("--threshold", type=int, default=5)
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--image_size", type=int, default=224)
    args = p.parse_args(argv)

    if args.caption_path:
        vocab = build_vocab(args.caption_path, args.threshold)
        vocab.save(args.vocab_path)
        print(f"Saved vocabulary ({len(vocab)} words) to {args.vocab_path}")
    if args.image_dir:
        out = args.output_dir or args.image_dir.rstrip("/") + "_resized"
        n = resize_images(args.image_dir, out, args.image_size)
        print(f"Resized {n} images into {out}")


if __name__ == "__main__":
    main()
