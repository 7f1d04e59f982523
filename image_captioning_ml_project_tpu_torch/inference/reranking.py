"""CLIP candidate reranking, in PyTorch.

Counterpart of ``image_captioning_ml_project_tpu.inference.reranking``:

1. the decode engine gives K candidates per image
   (``beam_search(..., return_all=True)``, :mod:`.decoding`);
2. the host decodes them to text and re-tokenizes the text with the CLIP
   tokenizer (a host callable: CLIP's BPE is not the captioning
   tokenizer's);
3. one :class:`..models.clip_text.CLIPScorer` pass scores the B*K
   (image, caption) pairs on the device; the argmax over K picks each
   image's winner (the first of equal scores).

The scorer's vision tower runs the encoder kernel (#5) on a CUDA device.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.resize import resize_cubic

# CLIP's own preprocessing statistics (not ImageNet's)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def clip_normalize(images_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> CLIP-normalised float32 NHWC on the images' device."""
    x = images_uint8.float() / 255.0
    mean = torch.from_numpy(CLIP_MEAN).to(x.device)
    std = torch.from_numpy(CLIP_STD).to(x.device)
    return (x - mean) / std


def clip_rerank_scores(scorer, images: torch.Tensor,
                       clip_ids: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (CLIP-normalised); clip_ids [B, K, L] -> the
    cosine similarities [B, K]."""
    B, K, L = clip_ids.shape
    img_feat = scorer.encode_image(images)                       # [B, P]
    txt_feat = scorer.encode_text(clip_ids.reshape(B * K, L))
    return torch.einsum("bp,bkp->bk", img_feat,
                        txt_feat.reshape(B, K, -1))


def rerank_candidates(
    candidates: torch.Tensor,
    images: torch.Tensor,
    decode_fn: Callable[[np.ndarray], str],
    clip_tokenize_fn: Callable[[List[str]], np.ndarray],
    scorer,
    score_fn: Optional[Callable] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """candidates [B, K, L] caption-tokenizer ids -> (best [B, L], scores
    [B, K]) on the host.

    ``decode_fn``: caption ids -> text; ``clip_tokenize_fn``: the B*K texts
    -> [B*K, L_clip] CLIP ids. ``score_fn(images, clip_ids)`` scores them
    (default: :func:`clip_rerank_scores` with ``scorer`` on ``images`` as
    they are); :class:`CLIPReranker` passes its own, which normalises and
    resizes the raw images first."""
    cand = (candidates.cpu().numpy() if isinstance(candidates, torch.Tensor)
            else np.asarray(candidates))
    B, K, L = cand.shape
    texts = [decode_fn(cand[b, k]) for b in range(B) for k in range(K)]
    clip_ids = np.asarray(clip_tokenize_fn(texts)).reshape(B, K, -1)
    ids = torch.from_numpy(clip_ids.astype(np.int64)).to(images.device)
    if score_fn is None:
        scores = clip_rerank_scores(scorer, images, ids)
    else:
        scores = score_fn(images, ids)
    scores = scores.float().cpu().numpy()
    best = scores.argmax(axis=1)
    return cand[np.arange(B), best], scores


class CLIPReranker:
    """Turns [B, K, L] beam candidates into [B, L] CLIP-selected winners.

    ``scorer`` is a :class:`..models.clip_text.CLIPScorer` in float32 on
    the serving device (:func:`..params.load_scorer`);
    ``clip_tokenize_fn``: the B*K caption strings -> [B*K, L_clip] CLIP
    ids; ``decode_fn``: caption-tokenizer ids -> text. Images arrive uint8
    NHWC at the serving resolution on the scorer's device; they are
    CLIP-normalised there and, where the serving size is not the
    checkpoint's ``image_size``, resized with JAX's cubic resize
    (:func:`..ops.resize.resize_cubic`). Scoring runs under
    ``torch.inference_mode()``, on whichever thread calls."""

    def __init__(self, scorer,
                 clip_tokenize_fn: Callable[[List[str]], np.ndarray],
                 decode_fn: Callable[[np.ndarray], str],
                 image_size: int = 224):
        self.scorer = scorer
        self.clip_tokenize_fn = clip_tokenize_fn
        self.decode_fn = decode_fn
        self.image_size = image_size

    def score(self, images_uint8: torch.Tensor,
              clip_ids: torch.Tensor) -> torch.Tensor:
        """Raw uint8 images [B, H, W, 3] and CLIP ids [B, K, L] -> [B, K]."""
        x = clip_normalize(images_uint8)
        if tuple(x.shape[1:3]) != (self.image_size, self.image_size):
            x = resize_cubic(x, self.image_size)
        return clip_rerank_scores(self.scorer, x, clip_ids)

    def __call__(self, images_uint8: torch.Tensor,
                 candidates: torch.Tensor) -> np.ndarray:
        with torch.inference_mode():
            best, _ = rerank_candidates(candidates, images_uint8,
                                        self.decode_fn,
                                        self.clip_tokenize_fn, self.scorer,
                                        score_fn=self.score)
        return best


def build_hf_reranker(decode_fn, device,
                      clip_model_name: str = "openai/clip-vit-base-patch32"
                      ) -> Optional[CLIPReranker]:
    """A :class:`CLIPReranker` on ``device`` from a locally cached HF CLIP
    checkpoint and tokenizer (``local_files_only``: nothing is
    downloaded); None, with the JAX package's warning, when either is not
    available offline or anything else fails, as there."""
    logger = logging.getLogger(__name__)
    try:
        from transformers import CLIPModel, CLIPTokenizer

        from ..models.clip_text import CLIPScorer
        from ..params import load_scorer, scorer_from_hf

        model = CLIPModel.from_pretrained(clip_model_name,
                                          local_files_only=True)
        tok = CLIPTokenizer.from_pretrained(clip_model_name,
                                            local_files_only=True)
        vc, tc = model.config.vision_config, model.config.text_config
        with torch.device("meta"):
            scorer = CLIPScorer(
                vision_hidden=vc.hidden_size,
                vision_layers=vc.num_hidden_layers,
                vision_heads=vc.num_attention_heads,
                patch_size=vc.patch_size, image_size=vc.image_size,
                text_vocab=tc.vocab_size, text_hidden=tc.hidden_size,
                text_layers=tc.num_hidden_layers,
                text_heads=tc.num_attention_heads,
                text_eos_token_id=tc.eos_token_id,
                text_max_positions=tc.max_position_embeddings,
                projection_dim=model.config.projection_dim)
        scorer = load_scorer(scorer, scorer_from_hf(model.state_dict()),
                             device)

        def clip_tokenize(texts: List[str]) -> np.ndarray:
            enc = tok(texts, padding="max_length", truncation=True,
                      max_length=tc.max_position_embeddings,
                      return_tensors="np")
            return enc["input_ids"].astype(np.int32)

        return CLIPReranker(scorer, clip_tokenize, decode_fn,
                            image_size=vc.image_size)
    except Exception as e:
        logger.warning(
            "CLIP reranking requested but no local CLIP checkpoint for "
            "'%s' (%s); continuing without reranking", clip_model_name, e)
        return None
