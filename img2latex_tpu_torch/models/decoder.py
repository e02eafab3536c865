"""LSTM decoder with additive attention (counterpart of ``img2latex_tpu/models/decoder.py``).

* Vector memory (S = 1), or attention off: the softmax over one slot is
  identically 1, so the context is ``memory[:, 0, :]`` at every step and a
  teacher-forced sequence runs through the LSTM in one pass.
* Grid memory (S > 1) with attention: each step attends from the previous
  top-layer h over the memory, then steps the LSTM on ``[emb; context]``.
  The step-invariant memory half of the attention, ``U = m @ W_m + b``, is
  computed once (:meth:`LSTMDecoder.memory_proj`) and passed to every step.

With ``train=True`` dropout applies where flax applies it: on the
embeddings and on the LSTM outputs before ``out``, and between LSTM layers
(per step inside the cell for grid memory).  The grid teacher-forced pass
has no Pallas kernel in the JAX package (an ``nn.scan`` over cell steps), so
it is a plain loop of cell steps here too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from img2latex_tpu_torch.models.lstm import Carry, StackedLSTM, dropout


class AdditiveAttention(nn.Module):
    """``softmax_s(v . tanh(W [h; m_s] + b))``-weighted sum of the memory.

    ``attn`` is one Linear over the concat ``[h; m]`` with the h columns
    first, applied split: ``h_half`` per step (no bias) and ``memory_half``
    (``m @ W_m + b``) once per memory.  ``v`` has no bias."""

    def __init__(self, hidden_dim: int, mem_dim: int, attn_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim, self.dtype = hidden_dim, dtype
        self.attn = nn.Linear(hidden_dim + mem_dim, attn_dim)
        self.v = nn.Linear(attn_dim, 1, bias=False)

    def memory_half(self, memory: torch.Tensor) -> torch.Tensor:
        """(B, S, E) -> (B, S, A)."""
        w_m = self.attn.weight[:, self.hidden_dim:].to(self.dtype)
        return F.linear(memory.to(self.dtype), w_m, self.attn.bias.to(self.dtype))

    def h_half(self, h: torch.Tensor) -> torch.Tensor:
        """(B, H) -> (B, A)."""
        return F.linear(h.to(self.dtype), self.attn.weight[:, : self.hidden_dim].to(self.dtype))

    def forward(self, h: torch.Tensor, memory: torch.Tensor,
                mem_proj: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """h (B, H), memory (B, S, E) -> (context (B, E), weights (B, S))."""
        if mem_proj is None:
            mem_proj = self.memory_half(memory)
        energy = torch.tanh(mem_proj + self.h_half(h)[:, None, :])
        scores = F.linear(energy, self.v.weight.to(self.dtype))[..., 0]
        weights = torch.softmax(scores, dim=-1)
        context = torch.einsum("bs,bse->be", weights, memory.to(self.dtype))
        return context, weights


class DecoderCell(nn.Module):
    """One decode step: embed -> attend (grid memory) -> LSTM step -> vocab projection."""

    def __init__(self, vocab_size: int, embedding_dim: int, hidden_dim: int,
                 lstm_layers: int = 1, use_attention: bool = True, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.use_attention = use_attention
        self.dropout = dropout
        self.embedding = nn.Embedding(vocab_size, embedding_dim)
        self.lstm = StackedLSTM(2 * embedding_dim, hidden_dim, lstm_layers, dropout=dropout,
                                dtype=dtype)
        if use_attention:
            self.attention = AdditiveAttention(hidden_dim, embedding_dim, hidden_dim, dtype=dtype)
        self.out = nn.Linear(hidden_dim, vocab_size)

    def attends(self, memory: torch.Tensor) -> bool:
        return self.use_attention and memory.shape[1] > 1

    def project(self, y: torch.Tensor) -> torch.Tensor:
        return F.linear(y, self.out.weight.to(self.dtype), self.out.bias.to(self.dtype))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Embedding rows of ``tokens`` in the compute type.  ``F.embedding``'s
        backward sums the rows' gradients by token; the backward of an index
        (``weight[tokens]``) is a sort-based kernel that took 8.6 ms of a
        64.5 ms train step at ``bench_train.py``'s shapes (NVIDIA H100 80GB
        HBM3, 700 W; ``chip_smoke.py``'s profile)."""
        return F.embedding(tokens.long(), self.embedding.weight.to(self.dtype))

    def drop(self, x: torch.Tensor, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
        return dropout(x, self.dropout, generator) if train else x

    def forward(self, carry: Carry, token: torch.Tensor, memory: torch.Tensor,
                mem_proj: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """token (B,) -> (new carry, logits (B, V))."""
        emb = self.drop(self.embed(token), train, generator)
        if self.attends(memory):
            context, _ = self.attention(carry[0][-1], memory, mem_proj=mem_proj)
        else:
            context = memory[:, 0, :].to(self.dtype)
        y, new_carry = self.lstm.step(torch.cat([emb, context], dim=-1), carry, train, generator)
        return new_carry, self.project(self.drop(y, train, generator))


class LSTMDecoder(nn.Module):
    """Teacher-forced sequences and single-step decode."""

    def __init__(self, vocab_size: int, embedding_dim: int = 512, hidden_dim: int = 512,
                 lstm_layers: int = 1, use_attention: bool = True, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding_dim, self.hidden_dim, self.lstm_layers = embedding_dim, hidden_dim, lstm_layers
        self.dtype = dtype
        self.cell = DecoderCell(vocab_size, embedding_dim, hidden_dim, lstm_layers,
                                use_attention=use_attention, dropout=dropout, dtype=dtype)

    def init_carry(self, batch_size: int, device=None) -> Carry:
        return self.cell.lstm.init_carry(batch_size, device)

    def forward(self, memory: torch.Tensor, target_sequence: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """memory (B, S, E), target_sequence (B, T) input tokens -> logits (B, T, V)."""
        B, T = target_sequence.shape
        cell = self.cell
        if not cell.attends(memory):
            emb = cell.embed(target_sequence)  # (B, T, E)
            emb = cell.drop(emb, train, generator)
            context = memory[:, 0, :].to(self.dtype)[:, None, :].expand(B, T, self.embedding_dim)
            ys, _ = cell.lstm(torch.cat([emb, context], dim=-1), train=train, generator=generator)
            return cell.project(cell.drop(ys, train, generator))
        mem_proj = self.memory_proj(memory)
        carry = self.init_carry(B, memory.device)
        logits = []
        for t in range(T):
            carry, step_logits = cell(carry, target_sequence[:, t], memory, mem_proj, train, generator)
            logits.append(step_logits)
        return torch.stack(logits, dim=1)

    def decode_step(self, memory: torch.Tensor, token: torch.Tensor, carry: Carry,
                    mem_proj: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Carry]:
        """token (B,) -> (logits (B, V), new carry).  ``mem_proj`` from
        :meth:`memory_proj` spares the memory half of the attention."""
        new_carry, logits = self.cell(carry, token, memory, mem_proj)
        return logits, new_carry

    def memory_proj(self, memory: torch.Tensor) -> Optional[torch.Tensor]:
        """The attention's memory half U (B, S, A), or None where the decoder
        does not attend (vector memory, or attention off)."""
        if not self.cell.attends(memory):
            return None
        return self.cell.attention.memory_half(memory)
