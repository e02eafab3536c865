"""LSTM decoder, vector memory (counterpart of ``img2latex_tpu/models/decoder.py``).

With a length-1 memory the attention softmax is identically 1, so the
context is the encoder embedding ``memory[:, 0, :]`` at every step; the
JAX package takes this fast path for vector memory, and it is the only path
ported so far.  A memory with S > 1 (grid memory, additive attention)
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from img2latex_tpu_torch.models.lstm import Carry, StackedLSTM


def _context(memory: torch.Tensor) -> torch.Tensor:
    if memory.shape[1] != 1:
        raise NotImplementedError("grid memory (S > 1) is not ported yet; use model.memory='vector'")
    return memory[:, 0, :]


class DecoderCell(nn.Module):
    """One decode step: embed -> [emb; context] -> LSTM step -> vocab projection."""

    def __init__(self, vocab_size: int, embedding_dim: int, hidden_dim: int,
                 lstm_layers: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Embedding(vocab_size, embedding_dim)
        self.lstm = StackedLSTM(2 * embedding_dim, hidden_dim, lstm_layers, dtype=dtype)
        self.out = nn.Linear(hidden_dim, vocab_size)

    def project(self, y: torch.Tensor) -> torch.Tensor:
        return F.linear(y, self.out.weight.to(self.dtype), self.out.bias.to(self.dtype))

    def forward(self, carry: Carry, token: torch.Tensor, memory: torch.Tensor):
        """token (B,) -> (new carry, logits (B, V))."""
        emb = self.embedding.weight.to(self.dtype)[token.long()]
        x = torch.cat([emb, _context(memory).to(self.dtype)], dim=-1)
        y, new_carry = self.lstm.step(x, carry)
        return new_carry, self.project(y)


class LSTMDecoder(nn.Module):
    """Teacher-forced sequences and single-step decode."""

    def __init__(self, vocab_size: int, embedding_dim: int = 512, hidden_dim: int = 512,
                 lstm_layers: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding_dim, self.hidden_dim, self.lstm_layers = embedding_dim, hidden_dim, lstm_layers
        self.dtype = dtype
        self.cell = DecoderCell(vocab_size, embedding_dim, hidden_dim, lstm_layers, dtype=dtype)

    def init_carry(self, batch_size: int, device=None) -> Carry:
        return self.cell.lstm.init_carry(batch_size, device)

    def forward(self, memory: torch.Tensor, target_sequence: torch.Tensor) -> torch.Tensor:
        """memory (B, 1, E), target_sequence (B, T) input tokens -> logits (B, T, V)."""
        B, T = target_sequence.shape
        emb = self.cell.embedding.weight.to(self.dtype)[target_sequence.long()]  # (B, T, E)
        context = _context(memory).to(self.dtype)[:, None, :].expand(B, T, self.embedding_dim)
        ys, _ = self.cell.lstm(torch.cat([emb, context], dim=-1))
        return self.cell.project(ys)

    def decode_step(self, memory: torch.Tensor, token: torch.Tensor,
                    carry: Carry) -> Tuple[torch.Tensor, Carry]:
        """token (B,) -> (logits (B, V), new carry)."""
        new_carry, logits = self.cell(carry, token, memory)
        return logits, new_carry
