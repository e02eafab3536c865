"""Stacked LSTM with PyTorch gate order (counterpart of ``img2latex_tpu/models/lstm.py``).

Gate order is (i, f, g, o).  Parameters use ``torch.nn.LSTM``'s names and
layout: ``weight_ih_l{i}`` (4H, In), ``weight_hh_l{i}`` (4H, H),
``bias_ih_l{i}`` and ``bias_hh_l{i}`` (4H,); the flax tree stores the two
matrices transposed.

Full sequences (:meth:`StackedLSTM.forward`, the teacher-forced pass of
training and validation) take the JAX package's ``pallas_seq`` path: per
layer the input projection of all steps with both biases folded in, one
``torch.matmul``, then the whole recurrence through
:func:`~img2latex_tpu_torch.ops.lstm_train.lstm_seq` (the hand-written
forward and backward kernels on the card).  :meth:`StackedLSTM.step` is the
single step of the decode loops and of the grid teacher-forced pass.  With
``train=True`` both apply dropout between layers (not after the last), as
flax ``nn.Dropout`` does, drawing from the ``torch.Generator`` given.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from img2latex_tpu_torch.ops.lstm_train import lstm_seq

Carry = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each (num_layers, B, H)


def lstm_cell_step(gates_x, h, c, w_hh, b_hh):
    """One cell update from a precomputed input projection gates_x (B, 4H)."""
    gates = gates_x + h @ w_hh.t() + b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)`` in ``x``'s type.
    The mask is drawn from ``generator`` on ``x``'s device (threefry and torch
    draw different streams: the masks never equal the JAX package's)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class StackedLSTM(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.dropout = dropout
        self.dtype = dtype
        for layer in range(num_layers):
            in_dim = input_dim if layer == 0 else hidden_dim
            self.register_parameter(f"weight_ih_l{layer}", nn.Parameter(torch.empty(4 * hidden_dim, in_dim)))
            self.register_parameter(f"weight_hh_l{layer}", nn.Parameter(torch.empty(4 * hidden_dim, hidden_dim)))
            self.register_parameter(f"bias_ih_l{layer}", nn.Parameter(torch.empty(4 * hidden_dim)))
            self.register_parameter(f"bias_hh_l{layer}", nn.Parameter(torch.empty(4 * hidden_dim)))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """U(-1/sqrt(H), 1/sqrt(H)) for every weight and bias, as torch and flax init them."""
        s = 1.0 / math.sqrt(self.hidden_dim)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-s, s)

    def _layer(self, layer: int):
        c = lambda name: getattr(self, f"{name}_l{layer}").to(self.dtype)  # noqa: E731
        return c("weight_ih"), c("weight_hh"), c("bias_ih"), c("bias_hh")

    def init_carry(self, batch_size: int, device=None) -> Carry:
        shape = (self.num_layers, batch_size, self.hidden_dim)
        z = torch.zeros(shape, dtype=self.dtype, device=device)
        return z, z.clone()

    def _drop(self, y: torch.Tensor, layer: int, train: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        """Dropout between layers: after every layer but the last, in training."""
        if train and layer < self.num_layers - 1:
            return dropout(y, self.dropout, generator)
        return y

    def forward(self, xs: torch.Tensor, carry: Carry = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Carry]:
        """Full sequence: xs (B, T, input_dim) -> ys (B, T, H), final carry.

        Runs time-major: per layer ``gates_x = ys @ W_ih^T + (b_ih + b_hh)``
        (T, B, 4H) as one product, then :func:`lstm_seq` over the T steps."""
        if carry is None:
            carry = self.init_carry(xs.shape[0], xs.device)
        h0, c0 = carry
        ys = xs.to(self.dtype).transpose(0, 1)  # (T, B, In)
        h_out: List[torch.Tensor] = []
        c_out: List[torch.Tensor] = []
        for layer in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = self._layer(layer)
            gates_x = torch.matmul(ys, w_ih.t()) + (b_ih + b_hh)  # hoisted over the steps
            ys, h, c = lstm_seq(gates_x, h0[layer], c0[layer], w_hh)
            ys = self._drop(ys, layer, train, generator)
            h_out.append(h)
            c_out.append(c)
        return ys.transpose(0, 1), (torch.stack(h_out), torch.stack(c_out))

    def step(self, x: torch.Tensor, carry: Carry, train: bool = False,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Carry]:
        """One step: x (B, input_dim) -> y (B, H), new carry (undropped)."""
        h0, c0 = carry
        y = x.to(self.dtype)
        h_out, c_out = [], []
        for layer in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = self._layer(layer)
            h2, c2 = lstm_cell_step(y @ w_ih.t() + b_ih, h0[layer], c0[layer], w_hh, b_hh)
            y = self._drop(h2, layer, train, generator)
            h_out.append(h2)
            c_out.append(c2)
        return y, (torch.stack(h_out), torch.stack(c_out))
