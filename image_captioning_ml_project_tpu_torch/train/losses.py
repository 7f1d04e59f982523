"""Training losses: shifted cross-entropy, doubly-stochastic attention
regularization, CLIP-style contrastive, and image-text matching.

Counterpart of ``image_captioning_ml_project_tpu.train.losses``: the same
functions on tensors, and :class:`CombinedLoss` as an ``nn.Module`` whose
parameters (the ITM head and the two feature projections) are the
trainer's ``"loss"`` group. The linear layers are named so that
:func:`..params.loss_from_flax` maps the flax module's ``Dense_0``,
``Dense_1``, ``image_feat_proj`` and ``text_feat_proj`` onto them.

Under data parallelism (a ``group``, the mesh's data axis) each loss is
this rank's share of the global batch's loss, so that the shares sum to
it and the gradients all-reduced by sum are the global batch's, as the
JAX trainer's one program over the sharded batch computes them: the
masked CE and the REINFORCE loss divide local sums by the global token
count, the attention regularisation its local sum by the global element
count, and the contrastive and ITM losses run on every rank over the
global features (gathered differentiably,
:func:`..parallel.sharding.gather_rows`) and count ``1 / dp`` each.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.layers import dropout
from ..parallel.sharding import gather_rows


def global_count(count: torch.Tensor, group) -> torch.Tensor:
    """``count`` (a denominator, no gradient) summed over ``group``'s
    ranks; as it is without one."""
    if group is None:
        return count
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    return count


def _ranks(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def shifted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          pad_token_id: int,
                          target_mask: Optional[torch.Tensor] = None,
                          group=None) -> torch.Tensor:
    """Language-modeling CE: predict targets[t+1] from logits[t].

    ``target_mask`` [B, T] (1 = supervised token, e.g. the tokenizer's
    attention mask) takes precedence over pad-id masking — required for
    GPT-2 style tokenizers where pad == eos, so the terminating EOS stays a
    training target instead of being stripped with the padding."""
    shift_logits = logits[:, :-1]
    shift_targets = targets[:, 1:].long()
    if target_mask is not None:
        mask = target_mask[:, 1:].float()
    else:
        mask = (shift_targets != pad_token_id).float()
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -logp.gather(-1, shift_targets[..., None])[..., 0]
    return (nll * mask).sum() \
        / global_count(mask.sum(), group).clamp_min(1.0)


def attention_regularization(attention_weights: torch.Tensor,
                             token_mask: Optional[torch.Tensor] = None,
                             group=None) -> torch.Tensor:
    """Doubly-stochastic regularization ``((1 - sum_t alpha)^2).mean()``;
    attention_weights [B, T, S], token_mask [B, T] marks real caption
    steps."""
    if token_mask is not None:
        attention_weights = attention_weights * token_mask[:, :, None]
    total = attention_weights.sum(dim=1)  # [B, S]
    if group is None:
        return ((1.0 - total) ** 2).mean()
    return ((1.0 - total) ** 2).sum() / (total.numel() * _ranks(group))


def contrastive_loss(image_features: torch.Tensor,
                     text_features: torch.Tensor,
                     temperature: float = 0.07, group=None) -> torch.Tensor:
    """Symmetric InfoNCE over the (global) batch."""
    if group is not None:
        return contrastive_loss(gather_rows(image_features, group),
                                gather_rows(text_features, group),
                                temperature) / _ranks(group)
    img = image_features / torch.linalg.vector_norm(image_features, dim=-1,
                                                    keepdim=True)
    txt = text_features / torch.linalg.vector_norm(text_features, dim=-1,
                                                   keepdim=True)
    logits = img @ txt.T / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)[:, None]
    loss_i2t = -torch.log_softmax(logits, dim=-1).gather(-1, labels).mean()
    loss_t2i = -torch.log_softmax(logits.T, dim=-1).gather(-1, labels).mean()
    return (loss_i2t + loss_t2i) / 2.0


def itm_negative_indices(generator: Optional[torch.Generator],
                         batch_size: int, num_neg: int, device="cpu"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices for ITM mismatched pairs: adjacent entries of one full-batch
    permutation drawn from ``generator``, so ``img_idx[i] != txt_idx[i]``
    whenever batch_size >= 2."""
    perm = torch.randperm(batch_size, generator=generator,
                          device=torch.device(device))
    nxt = (torch.arange(num_neg, device=perm.device) + 1) % batch_size
    return perm[:num_neg], perm[nxt]


class ITMHead(nn.Module):
    """Image-text matching binary classifier: MLP over [img; txt] -> 2,
    with dropout 0.1 in training."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.dense_0 = nn.Linear(input_dim, hidden_dim)
        self.dense_1 = nn.Linear(hidden_dim, 2)

    def forward(self, image_features, text_features):
        x = torch.cat([image_features, text_features], dim=-1)
        x = dropout(F.relu(self.dense_0(x)), 0.1, self.training)
        return self.dense_1(x)


class CombinedLoss(nn.Module):
    """CE + weighted contrastive + weighted ITM (+ attention
    regularization). ``image_dim`` and ``text_dim`` are the widths of the
    model's pooled image features (the encoder's ``feature_dim``) and text
    features (the decoder's ``hidden_dim``), which flax infers at init."""

    # the mesh's data axis group (set by a trainer under a mesh): the
    # losses are then this rank's shares of the global batch's
    data_group = None

    def __init__(self, pad_token_id: int, use_contrastive: bool = False,
                 use_itm: bool = False, contrastive_weight: float = 0.1,
                 itm_weight: float = 0.1, temperature: float = 0.07,
                 hidden_dim: int = 768, attention_reg_weight: float = 0.0,
                 negative_ratio: float = 0.5, image_dim: int = 768,
                 text_dim: int = 768):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.use_contrastive = use_contrastive
        self.use_itm = use_itm
        self.contrastive_weight = contrastive_weight
        self.itm_weight = itm_weight
        self.temperature = temperature
        self.attention_reg_weight = attention_reg_weight
        self.negative_ratio = negative_ratio
        if use_itm:
            self.itm_head = ITMHead(2 * hidden_dim, hidden_dim)
        if use_contrastive or use_itm:
            # project (possibly differently sized) image/text features to a
            # common embedding dim
            self.image_feat_proj = nn.Linear(image_dim, hidden_dim)
            self.text_feat_proj = nn.Linear(text_dim, hidden_dim)

    def forward(self, logits, targets, image_features=None,
                text_features=None, attention_weights=None, target_mask=None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The losses by name, ``total_loss`` their weighted sum. The ITM
        negatives come from ``generator`` (the trainer's per-step stream);
        without one, from a generator seeded 0, as the JAX module falls
        back to a fixed key outside training."""
        group = self.data_group
        ce = shifted_cross_entropy(logits, targets, self.pad_token_id,
                                   target_mask=target_mask, group=group)
        total = ce
        out = {"ce_loss": ce}
        have_features = (image_features is not None
                         and text_features is not None)
        if (self.use_contrastive or self.use_itm) and have_features:
            image_features = self.image_feat_proj(image_features)
            text_features = self.text_feat_proj(text_features)

        if self.use_contrastive and have_features:
            cl = contrastive_loss(image_features, text_features,
                                  self.temperature, group=group)
            total = total + self.contrastive_weight * cl
            out["contrastive_loss"] = cl

        if self.use_itm and have_features:
            if group is not None:
                # the global batch's pairs and negatives on every rank
                image_features = gather_rows(image_features, group)
                text_features = gather_rows(text_features, group)
            B = image_features.shape[0]
            num_neg = int(B * self.negative_ratio)
            device = image_features.device
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            neg_idx, neg_txt_idx = itm_negative_indices(generator, B,
                                                        num_neg, device)
            all_img = torch.cat([image_features, image_features[neg_idx]])
            all_txt = torch.cat([text_features, text_features[neg_txt_idx]])
            labels = torch.cat([torch.ones(B, dtype=torch.long,
                                           device=device),
                                torch.zeros(num_neg, dtype=torch.long,
                                            device=device)])
            itm_logits = self.itm_head(all_img, all_txt)
            logp = torch.log_softmax(itm_logits, dim=-1)
            il = -logp.gather(-1, labels[:, None]).mean() / _ranks(group)
            total = total + self.itm_weight * il
            out["itm_loss"] = il

        if self.attention_reg_weight > 0.0 and attention_weights is not None:
            # attention_weights[t] is the attention used to predict
            # targets[t+1] (same alignment as shifted_cross_entropy), so the
            # step mask is the shifted target validity; target_mask takes
            # precedence for pad == eos tokenizers
            if target_mask is not None:
                valid = target_mask.float()
            else:
                valid = (targets != self.pad_token_id).float()
            token_mask = torch.cat([valid[:, 1:],
                                    torch.zeros_like(valid[:, :1])], dim=1)
            ar = attention_regularization(attention_weights, token_mask,
                                          group=group)
            total = total + self.attention_reg_weight * ar
            out["attention_reg_loss"] = ar

        out["total_loss"] = total
        return out
