"""Legacy "Show, Attend and Tell" model (ResNet + LSTM + gated soft
attention) in PyTorch.

Counterpart of ``image_captioning_ml_project_tpu.legacy.model``:

* :class:`LegacyEncoder`: the port's ResNet backbone (no head), then an
  adaptive average pool to an ``encoded_image_size`` grid, NHWC out;
* :class:`LegacyDecoder` per step: ReLU additive soft attention
  (``enc_att``/``dec_att``/``att``) over the grid, a sigmoid gate
  ``f_beta(h)`` scaling the context, the port's fused LSTM cell over
  ``[embedding; gated context]``, h and c from the mean encoder output;
  teacher forcing over ``dec_len = T - 1`` steps, or greedy ``generate``;
  the ``use_bert`` variant takes caption embeddings (and an embedding
  table to generate) in place of its own embedding.

Plain PyTorch modules throughout: the JAX legacy stack reaches no Pallas
kernel (its ReLU attention is not the ``tanh`` scores of the additive
kernel), so this one launches none. Images are NHWC floats, already
normalised (the trainer normalises uint8 batches on the device).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import EncoderConfig
from ..models.encoders import ResNetBackbone
from ..models.layers import dropout
from ..models.lstm import FusedLSTMCell


def adaptive_avg_pool_2d(x: torch.Tensor, output_size: int) -> torch.Tensor:
    """NHWC adaptive average pooling to (output_size, output_size), torch
    ``AdaptiveAvgPool2d``'s windows (start ``floor(i * in / out)``, end
    ``ceil((i + 1) * in / out)``)."""
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), output_size)
    return y.permute(0, 2, 3, 1)


class LegacyEncoder(nn.Module):
    """ResNet backbone + adaptive pool: images [B, H, W, 3] ->
    [B, E, E, C] (C the last stage's width)."""

    def __init__(self, encoded_image_size: int = 14,
                 encoder_config: Optional[EncoderConfig] = None):
        super().__init__()
        cfg = encoder_config or EncoderConfig()
        self.encoded_image_size = encoded_image_size
        self.backbone = ResNetBackbone(
            embedding_size=cfg.resnet_embedding_size,
            hidden_sizes=tuple(cfg.resnet_hidden_sizes),
            depths=tuple(cfg.resnet_depths),
            layer_type=cfg.resnet_layer_type)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # NHWC memory read as NCHW: the channels_last layout, no copy
        x = self.backbone(images.permute(0, 3, 1, 2))
        return F.adaptive_avg_pool2d(x, self.encoded_image_size).permute(
            0, 2, 3, 1)


class LegacyDecoder(nn.Module):
    """Gated-soft-attention LSTM decoder."""

    def __init__(self, vocab_size: int, encoder_dim: int = 2048,
                 attention_dim: int = 512, decoder_dim: int = 512,
                 embed_dim: int = 512, dropout: float = 0.5,
                 use_bert: bool = False):
        super().__init__()
        self.vocab_size = vocab_size
        self.encoder_dim = encoder_dim
        self.rate = dropout
        self.use_bert = use_bert
        self.enc_att = nn.Linear(encoder_dim, attention_dim)
        self.dec_att = nn.Linear(decoder_dim, attention_dim)
        self.att = nn.Linear(attention_dim, 1)
        self.decode_step = FusedLSTMCell(embed_dim + encoder_dim,
                                         decoder_dim)
        self.h_lin = nn.Linear(encoder_dim, decoder_dim)
        self.c_lin = nn.Linear(encoder_dim, decoder_dim)
        self.f_beta = nn.Linear(decoder_dim, encoder_dim)
        self.fc = nn.Linear(decoder_dim, vocab_size)
        self.embedding = (None if use_bert
                          else nn.Embedding(vocab_size, embed_dim))

    def _attend(self, encoder_out: torch.Tensor, enc_att: torch.Tensor,
                h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """ReLU additive attention: (context [B, E], alpha [B, N]);
        ``enc_att`` is ``self.enc_att(encoder_out)``, the same every
        step."""
        att = self.att(F.relu(enc_att + self.dec_att(h)[:, None, :]))[..., 0]
        alpha = torch.softmax(att, dim=1)
        return (encoder_out * alpha[..., None]).sum(dim=1), alpha

    def init_hidden(self, encoder_out: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h and c from the mean encoder output."""
        avg = encoder_out.mean(dim=1)
        return self.h_lin(avg), self.c_lin(avg)

    def _step(self, encoder_out, enc_att, h, c, emb):
        context, alpha = self._attend(encoder_out, enc_att, h)
        gate = torch.sigmoid(self.f_beta(h))
        h, c = self.decode_step(h, c, torch.cat([emb, gate * context],
                                                dim=-1))
        return h, c, alpha

    def forward(self, encoder_out: torch.Tensor,
                encoded_captions: Optional[torch.Tensor] = None,
                caption_embeddings: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward. encoder_out [B, E, E, C] or [B, N, C];
        ``encoded_captions`` [B, T] ids, or ``caption_embeddings``
        [B, T, embed] (the BERT path). Returns ``predictions`` [B, T-1, V]
        (step t predicts token t + 1) and ``alphas`` [B, T-1, N]; in
        training mode ``h`` is dropped out before ``fc``."""
        B = encoder_out.shape[0]
        encoder_out = encoder_out.reshape(B, -1, self.encoder_dim)
        embeddings = (caption_embeddings if caption_embeddings is not None
                      else self.embedding(encoded_captions.long()))
        T = embeddings.shape[1] - 1  # dec_len = caption_length - 1
        h, c = self.init_hidden(encoder_out)
        enc_att = self.enc_att(encoder_out)
        preds, alphas = [], []
        for t in range(T):
            h, c, alpha = self._step(encoder_out, enc_att, h, c,
                                     embeddings[:, t])
            preds.append(self.fc(dropout(h, self.rate, self.training)))
            alphas.append(alpha)
        return {"predictions": torch.stack(preds, dim=1),
                "alphas": torch.stack(alphas, dim=1)}

    def generate(self, encoder_out: torch.Tensor, max_length: int,
                 start_token_id: int = 1,
                 embedding_table: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decode: (tokens [B, L], alphas [B, L, N]), position 0
        the start token. With ``use_bert`` there is no learned embedding:
        ``embedding_table`` [V, embed] maps tokens to embeddings."""
        if self.use_bert and embedding_table is None:
            raise ValueError(
                "use_bert decoder has no learned embedding table; pass "
                "embedding_table (BertCaptionEmbedder.vocab_table) to "
                "generate()")
        B = encoder_out.shape[0]
        encoder_out = encoder_out.reshape(B, -1, self.encoder_dim)
        h, c = self.init_hidden(encoder_out)
        enc_att = self.enc_att(encoder_out)
        current = torch.full((B,), start_token_id, dtype=torch.long,
                             device=encoder_out.device)
        tokens, alphas = [], []
        for _ in range(max_length):
            emb = (embedding_table[current] if embedding_table is not None
                   else self.embedding(current))
            h, c, alpha = self._step(encoder_out, enc_att, h, c, emb)
            tokens.append(current)
            alphas.append(alpha)
            current = self.fc(h).argmax(dim=-1)
        return torch.stack(tokens, dim=1), torch.stack(alphas, dim=1)


class ShowAttendTell(nn.Module):
    """Encoder + decoder. ``dropout`` is the decoder's (0.5, the JAX
    model's fixed rate, by default)."""

    def __init__(self, vocab_size: int, encoded_image_size: int = 14,
                 encoder_config: Optional[EncoderConfig] = None,
                 use_bert: bool = False, embed_dim: int = 512,
                 dropout: float = 0.5):
        super().__init__()
        enc_cfg = encoder_config or EncoderConfig()
        self.encoded_image_size = encoded_image_size
        self.use_bert = use_bert
        self.encoder = LegacyEncoder(encoded_image_size, enc_cfg)
        self.decoder = LegacyDecoder(
            vocab_size, encoder_dim=enc_cfg.resnet_hidden_sizes[-1],
            embed_dim=768 if use_bert else embed_dim, dropout=dropout,
            use_bert=use_bert)

    def forward(self, images, encoded_captions=None, caption_embeddings=None
                ) -> Dict[str, torch.Tensor]:
        return self.decoder(self.encoder(images), encoded_captions,
                            caption_embeddings)

    def generate(self, images, max_length: int, start_token_id: int = 1,
                 embedding_table=None):
        return self.decoder.generate(self.encoder(images), max_length,
                                     start_token_id,
                                     embedding_table=embedding_table)
