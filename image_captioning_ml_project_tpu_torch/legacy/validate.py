"""Legacy validation: teacher-forced loss, corpus BLEU-1..4, attention
visualisation, in PyTorch.

Counterpart of ``image_captioning_ml_project_tpu.legacy.validate``: the
teacher-forced CE over each batch's first reference, greedy decodes
scored by corpus BLEU-1..4 with the special tokens stripped from
hypotheses and references alike (one tokenisation on both sides), and
attention maps overlaid on the image, saved to files where there is no
display.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.coco import iterate_batches, normalize_images
from ..evaluate.metrics import bleu


def strip_specials(ids: np.ndarray, vocab) -> List[str]:
    """Drop <pad>/<start>/<unk>, stop at <end>."""
    words = []
    for i in ids:
        i = int(i)
        if i == vocab.eos_token_id:
            break
        if i in (vocab.pad_token_id, vocab.bos_token_id, vocab.unk_token_id):
            continue
        words.append(vocab.idx2word.get(i, "<unk>"))
    return words


@torch.inference_mode()
def validate(model, dataset, vocab, batch_size: int = 16,
             max_length: int = 20, bert_embedder=None) -> Dict[str, float]:
    """Validation loss and corpus BLEU-1..4 of ``model`` (a
    :class:`.model.ShowAttendTell` on its device, evaluated in eval mode:
    BatchNorm on its running statistics, no dropout).

    ``pad_last`` covers the trailing short batch; padded rows are masked
    out of the loss (per-row sums: the summed NLL and the supervised-token
    count over valid rows) and of BLEU. ``bert_embedder`` is required for
    ``use_bert`` models: the teacher-forced loss uses contextual caption
    embeddings, generation a static per-token vocabulary table."""
    logger = logging.getLogger(__name__)
    device = next(model.parameters()).device
    model.eval()
    table = None
    if model.use_bert:
        assert bert_embedder is not None, (
            "use_bert validation needs a BertCaptionEmbedder")
        table = torch.as_tensor(bert_embedder.vocab_table(vocab)).to(device)

    loss_sum, ntok, hyps, refs = 0.0, 0.0, [], []
    for batch in iterate_batches(dataset, batch_size, shuffle=False,
                                 drop_last=False, pad_last=True):
        captions = batch["caption_tokens"]
        first_ref = captions[:, 0] if captions.ndim == 3 else captions
        valid = batch.get("batch_valid", np.ones(len(first_ref), dtype=bool))
        cap_emb = None
        if model.use_bert:
            texts = [caps[0] for caps in batch["captions"]] \
                if "captions" in batch else [
                    " ".join(strip_specials(np.asarray(r), vocab))
                    for r in first_ref]
            cap_emb = torch.as_tensor(bert_embedder.embed_batch(
                texts, first_ref.shape[1])).to(device)
        images = normalize_images(torch.from_numpy(batch["image"]).to(device))
        caps = torch.from_numpy(first_ref).to(device).long()
        out = model(images, caps, caption_embeddings=cap_emb)
        preds = out["predictions"].float()
        targets = caps[:, 1:preds.shape[1] + 1]
        mask = ((targets != vocab.pad_token_id)
                & torch.from_numpy(valid).to(device)[:, None]).float()
        nll = -torch.log_softmax(preds, dim=-1).gather(
            -1, targets[..., None])[..., 0]
        loss_sum += float((nll * mask).sum())
        ntok += float(mask.sum())
        tokens, _ = model.generate(images, max_length,
                                   start_token_id=vocab.bos_token_id,
                                   embedding_table=table)
        ref_mask = batch.get("ref_mask")
        for i, row in enumerate(tokens.cpu().numpy()):
            if not valid[i]:
                continue
            hyps.append(strip_specials(row, vocab))
            if captions.ndim == 3:
                rows = [r for j, r in enumerate(captions[i])
                        if ref_mask is None or ref_mask[i][j]]
                refs.append([strip_specials(np.asarray(r), vocab)
                             for r in rows] or [[]])
            else:
                refs.append([strip_specials(np.asarray(first_ref[i]),
                                            vocab)])

    scores, _ = bleu(hyps, refs)
    out = {"loss": loss_sum / max(ntok, 1.0) if hyps else 0.0,
           "Bleu_1": scores[0], "Bleu_2": scores[1],
           "Bleu_3": scores[2], "Bleu_4": scores[3]}
    logger.info("legacy validation: %s", out)
    return out


def visualize_attention(image: np.ndarray, words: List[str],
                        alphas: np.ndarray, grid_size: int = 14,
                        save_path: Optional[str] = None):
    """Overlay per-word attention maps on the image; alphas [T,
    grid * grid]. Saves to ``save_path`` (returned) or returns the
    figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(len(words), alphas.shape[0])
    cols = 4
    rows = (n + cols) // cols
    plt.figure(figsize=(3 * cols, 3 * rows))
    ax = plt.subplot(rows, cols, 1)
    ax.imshow(image)
    ax.set_title("input")
    ax.axis("off")
    H = image.shape[0]
    for t in range(n):
        ax = plt.subplot(rows, cols, t + 2)
        ax.imshow(image)
        amap = alphas[t].reshape(grid_size, grid_size)
        amap = np.kron(amap, np.ones((H // grid_size, H // grid_size)))
        ax.imshow(amap, alpha=0.6, cmap="jet")
        ax.set_title(words[t])
        ax.axis("off")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        plt.savefig(save_path, bbox_inches="tight")
        plt.close()
        return save_path
    return plt.gcf()


def build_legacy_model(vocab, image_size: int, checkpoint_dir=None,
                       encoder_ckpt: str = "encoder_epoch_0",
                       decoder_ckpt: str = "decoder_epoch_0",
                       use_bert: bool = False, device="cuda", seed: int = 0):
    """The CLIs' model on ``device``: weights drawn from ``seed``, then
    the encoder and decoder checkpoints of ``checkpoint_dir`` where one
    is given."""
    from ..config import EncoderConfig
    from ..params import init_legacy_flax_params, legacy_from_flax
    from .model import ShowAttendTell
    from .train import load_legacy_checkpoints

    model = ShowAttendTell(len(vocab), use_bert=use_bert)
    model.load_state_dict(legacy_from_flax(init_legacy_flax_params(
        len(vocab), EncoderConfig(), seed, use_bert=use_bert)))
    if checkpoint_dir:
        load_legacy_checkpoints(model, checkpoint_dir, encoder_ckpt,
                                decoder_ckpt)
    return model.to(device, memory_format=torch.channels_last).eval()


def main(argv=None):
    """Script entry::

        python -m image_captioning_ml_project_tpu_torch.legacy.validate \\
            --data_root data --vocab vocab.json \\
            [--checkpoint_dir ckpts --encoder_ckpt ... --decoder_ckpt ...]
    """
    import argparse

    from ..data.coco import COCOCaptionDataset
    from ..data.tokenizer import WordVocab
    from ..utils.logging import setup_logging

    p = argparse.ArgumentParser(
        description="Legacy Show-Attend-Tell validation")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--vocab", type=str, required=True)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--encoder_ckpt", type=str, default="encoder_epoch_0")
    p.add_argument("--decoder_ckpt", type=str, default="decoder_epoch_0")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--max_length", type=int, default=20)
    p.add_argument("--use_bert", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    setup_logging(None)
    vocab = WordVocab.load(args.vocab)
    val_ds = COCOCaptionDataset(
        args.data_root, "annotations/captions_val2014.json", "val2014",
        vocab, image_size=args.image_size, is_training=False)
    embedder = None
    if args.use_bert:
        from .bert_embedder import BertCaptionEmbedder

        embedder = BertCaptionEmbedder()
    model = build_legacy_model(vocab, args.image_size, args.checkpoint_dir,
                               args.encoder_ckpt, args.decoder_ckpt,
                               use_bert=args.use_bert, device=args.device)
    metrics = validate(model, val_ds, vocab, batch_size=args.batch_size,
                       max_length=args.max_length, bert_embedder=embedder)
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
