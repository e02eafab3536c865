"""CNN image encoder (counterpart of ``img2latex_tpu/models/encoder.py::CNNEncoder``).

Each block is conv3x3 (SAME) + ReLU + maxpool 2x2; a Dense head + ReLU maps
the flattened feature map to one (B, E) embedding ("vector" memory).

* Block 0 (one input channel) goes through the conv1-pool kernel's wrapper
  (:func:`~img2latex_tpu_torch.ops.conv1_phase.conv1_pool`): NHWC in, NCHW
  out, bias added in float32 as the TPU kernel adds it.
* Blocks 1..n are ``conv2d`` + ReLU + ``max_pool2d`` on NCHW, as the JAX
  package leaves them to XLA outside any Pallas kernel.
* The head flattens NCHW in (c, h, w) order.  The JAX package flattens NHWC
  in (h, w, c) order; :mod:`img2latex_tpu_torch.bridge` permutes the head's
  rows when it loads flax weights.

Parameters are kept in float32 and cast to the compute type at use, as flax
does with ``dtype`` / ``param_dtype``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from img2latex_tpu_torch.ops.conv1_phase import conv1_pool


class CNNEncoder(nn.Module):
    def __init__(
        self,
        img_height: int,
        img_width: int,
        channels: int = 1,
        conv_filters: Sequence[int] = (32, 64, 128),
        kernel_size: int = 3,
        pool_size: int = 2,
        embedding_dim: int = 512,
        output: str = "vector",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if output != "vector":
            raise NotImplementedError("only output='vector' is ported; the grid head comes later")
        if channels != 1 or kernel_size != 3 or pool_size != 2:
            raise NotImplementedError(
                "the ported encoder takes 1-channel images, 3x3 convs and 2x2 pools"
            )
        if img_height % 2 or img_width % 2:
            raise ValueError("block 0 needs an even canvas height and width")
        self.dtype = dtype
        self.convs = nn.ModuleList()
        cin, h, w = channels, img_height, img_width
        for filters in conv_filters:
            self.convs.append(nn.Conv2d(cin, filters, kernel_size, padding=kernel_size // 2))
            cin, h, w = filters, h // pool_size, w // pool_size
        self.feature_shape: Tuple[int, int, int] = (cin, h, w)  # (C, H', W') after the stack
        self.head = nn.Linear(cin * h * w, embedding_dim)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 1) float NHWC -> conv feature map (B, C, H', W') NCHW."""
        x = x.to(self.dtype)
        c0 = self.convs[0]
        y = conv1_pool(x, c0.weight, c0.bias)
        for conv in self.convs[1:]:
            y = F.conv2d(y, conv.weight.to(self.dtype), conv.bias.to(self.dtype), padding=1)
            y = F.max_pool2d(F.relu(y), 2)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 1) float NHWC -> (B, E)."""
        y = self.features(x).flatten(1)
        return F.relu(F.linear(y, self.head.weight.to(self.dtype), self.head.bias.to(self.dtype)))
