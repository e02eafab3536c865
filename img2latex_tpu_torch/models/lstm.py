"""Stacked LSTM with PyTorch gate order (counterpart of ``img2latex_tpu/models/lstm.py``).

Gate order is (i, f, g, o).  Parameters use ``torch.nn.LSTM``'s names and
layout: ``weight_ih_l{i}`` (4H, In), ``weight_hh_l{i}`` (4H, H),
``bias_ih_l{i}`` and ``bias_hh_l{i}`` (4H,); the flax tree stores the two
matrices transposed.  Full sequences hoist the input projection of all
steps into one product and loop over the recurrence only.  Inference only:
dropout between layers is not applied (``deterministic=True`` in the JAX
package).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

Carry = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each (num_layers, B, H)


def lstm_cell_step(gates_x, h, c, w_hh, b_hh):
    """One cell update from a precomputed input projection gates_x (B, 4H)."""
    gates = gates_x + h @ w_hh.t() + b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


class StackedLSTM(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
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

    def forward(self, xs: torch.Tensor, carry: Carry = None) -> Tuple[torch.Tensor, Carry]:
        """Full sequence: xs (B, T, input_dim) -> ys (B, T, H), final carry."""
        if carry is None:
            carry = self.init_carry(xs.shape[0], xs.device)
        h0, c0 = carry
        ys = xs.to(self.dtype)
        h_out: List[torch.Tensor] = []
        c_out: List[torch.Tensor] = []
        for layer in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = self._layer(layer)
            gates_x = ys @ w_ih.t() + b_ih  # (B, T, 4H), hoisted over the steps
            h, c = h0[layer], c0[layer]
            steps = []
            for t in range(xs.shape[1]):
                h, c = lstm_cell_step(gates_x[:, t], h, c, w_hh, b_hh)
                steps.append(h)
            ys = torch.stack(steps, dim=1)
            h_out.append(h)
            c_out.append(c)
        return ys, (torch.stack(h_out), torch.stack(c_out))

    def step(self, x: torch.Tensor, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        """One step: x (B, input_dim) -> y (B, H), new carry."""
        h0, c0 = carry
        y = x.to(self.dtype)
        h_out, c_out = [], []
        for layer in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = self._layer(layer)
            h2, c2 = lstm_cell_step(y @ w_ih.t() + b_ih, h0[layer], c0[layer], w_hh, b_hh)
            y = h2
            h_out.append(h2)
            c_out.append(c2)
        return y, (torch.stack(h_out), torch.stack(c_out))
