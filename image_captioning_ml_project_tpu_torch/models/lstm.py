"""LSTM cells in PyTorch, with one gate product per layer and step.

Counterpart of ``image_captioning_ml_project_tpu.models.lstm``: each layer
is one ``nn.Linear(in + H, 4H)`` over ``[x; h]``, gates in torch's packed
order (i, f, g, o). ``nn.LSTM`` is not used: its two products (input and
hidden) are rounded separately, which at bf16 is not the JAX cell's one
product. Dropout between layers only when asked for (``deterministic=
False`` in training mode), as the JAX ``StackedLSTM``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from .layers import dropout


class FusedLSTMCell(nn.Module):
    """``c' = f*c + i*g``, ``h' = o * tanh(c')`` with i, f, o sigmoid and g
    tanh, all from one product of ``[x; h]``."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.gates = nn.Linear(input_dim + hidden_dim, 4 * hidden_dim)

    def forward(self, h: torch.Tensor, c: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        i, f, g, o = self.gates(torch.cat([x, h], dim=-1)).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new


class StackedLSTM(nn.Module):
    """``num_layers`` stacked cells; layer l > 0 takes layer l - 1's new
    hidden state as its input."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int,
                 rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.cells = nn.ModuleList(
            FusedLSTMCell(input_dim if l == 0 else hidden_dim, hidden_dim)
            for l in range(num_layers))

    def forward(self, h: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
                deterministic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """h, c [B, L, H]; x [B, in]. Returns (h', c' [B, L, H], the top
        layer's output [B, H]). With ``deterministic`` False, in training
        mode, each layer's output but the top one is dropped out on its way
        to the next layer."""
        new_h: List[torch.Tensor] = []
        new_c: List[torch.Tensor] = []
        inp = x
        for l, cell in enumerate(self.cells):
            h_l, c_l = cell(h[:, l], c[:, l], inp)
            new_h.append(h_l)
            new_c.append(c_l)
            inp = h_l
            if l < len(self.cells) - 1 and not deterministic:
                inp = dropout(inp, self.rate, self.training)
        return torch.stack(new_h, dim=1), torch.stack(new_c, dim=1), inp
