"""Image encoders (counterparts of ``img2latex_tpu/models/encoder.py``'s
``CNNEncoder`` and ``ResNetEncoder``).

:class:`CNNEncoder`:

Each block is conv3x3 (SAME) + ReLU + maxpool 2x2; a Dense head + ReLU maps
the feature map to the memory:

* ``output="vector"``: the flattened map -> one (B, E) embedding;
* ``output="grid"``: each of the W' feature columns -> one (B, W', E) slot
  (``encoder.py:245-251``: NHWC to (B, W', H'·C), rows in (h, c) order).

* Block 0 (one input channel) goes through the conv1-pool kernel's wrapper
  (:func:`~img2latex_tpu_torch.ops.conv1_phase.conv1_pool`): NHWC in, NCHW
  out, bias added in float32 as the TPU kernel adds it.
* Blocks 1..n are ``conv2d`` + ReLU + ``max_pool2d`` on NCHW, as the JAX
  package leaves them to XLA outside any Pallas kernel; or, with
  ``pallas_chain`` (``hardware.pallas_chain``) and the JAX gate holding (H
  and W divisible by 2**n_blocks: ``encoder.py:96-108``), the channel-first
  chain's block (:func:`~img2latex_tpu_torch.ops.conv_cf.convblock_cf`,
  the counterpart of ``_chain_path``), which adds the bias in float32 and
  rounds once.  The JAX gate's "backend is a TPU" has no counterpart: on the
  card the kernels run, on the CPU their plain versions.
* The vector head flattens NCHW in (c, h, w) order.  The JAX package
  flattens NHWC in (h, w, c) order; :mod:`img2latex_tpu_torch.bridge`
  permutes the head's rows when it loads flax weights.  The grid head takes
  NCHW to (B, W', H', C) first, so its rows are the JAX (h·C + c) already.
  So the chain path needs no head of its own: the flatten plus the bridge's
  row permutation is the JAX ``kperm``, and the grid permute the JAX
  ``einsum("bchw,hce->bwe")`` (``encoder.py:229-243``).

Parameters are kept in float32 and cast to the compute type at use, as flax
does with ``dtype`` / ``param_dtype``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from img2latex_tpu_torch.models.resnet import ResNetBackbone, feature_dim, feature_hw
from img2latex_tpu_torch.ops.conv1_phase import conv1_pool
from img2latex_tpu_torch.ops.conv_cf import convblock_cf


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
        pallas_chain: bool = False,
    ):
        super().__init__()
        if output not in ("vector", "grid"):
            raise ValueError(f"output must be 'vector' or 'grid', got {output!r}")
        if channels != 1 or kernel_size != 3 or pool_size != 2:
            raise NotImplementedError(
                "the ported encoder takes 1-channel images, 3x3 convs and 2x2 pools"
            )
        if img_height % 2 or img_width % 2:
            raise ValueError("block 0 needs an even canvas height and width")
        self.dtype = dtype
        self.output = output
        self.pallas_chain = bool(pallas_chain)
        self.convs = nn.ModuleList()
        cin, h, w = channels, img_height, img_width
        for filters in conv_filters:
            self.convs.append(nn.Conv2d(cin, filters, kernel_size, padding=kernel_size // 2))
            cin, h, w = filters, h // pool_size, w // pool_size
        self.feature_shape: Tuple[int, int, int] = (cin, h, w)  # (C, H', W') after the stack
        self.head = nn.Linear(cin * h if output == "grid" else cin * h * w, embedding_dim)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 1) float NHWC -> conv feature map (B, C, H', W') NCHW."""
        x = x.to(self.dtype)
        c0 = self.convs[0]
        y = conv1_pool(x, c0.weight, c0.bias, layout="nchw")
        scale = 2 ** len(self.convs)
        chain = self.pallas_chain and x.shape[1] % scale == 0 and x.shape[2] % scale == 0
        for conv in self.convs[1:]:
            if chain:
                y = convblock_cf(y, conv.weight, conv.bias)
                continue
            y = F.conv2d(y, conv.weight.to(self.dtype), conv.bias.to(self.dtype), padding=1)
            y = F.max_pool2d(F.relu(y), 2)
        return y

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x (B, H, W, 1) float NHWC -> (B, E) vector or (B, W', E) grid.
        ``train`` is ignored: the CNN has no BatchNorm and no dropout."""
        y = self.features(x)
        if self.output == "grid":
            B, C, Hf, Wf = y.shape
            y = y.permute(0, 3, 2, 1).reshape(B, Wf, Hf * C)
        else:
            y = y.flatten(1)
        return F.relu(F.linear(y, self.head.weight.to(self.dtype), self.head.bias.to(self.dtype)))


class ResNetEncoder(nn.Module):
    """:class:`~img2latex_tpu_torch.models.resnet.ResNetBackbone` plus a Dense
    head and ReLU:

    * ``output="vector"``: the mean of layer4's map over (H', W') -> (B, E)
      (torch's ``AdaptiveAvgPool2d(1)`` before the head);
    * ``output="grid"``: each of the W' columns' H'·F features, in (h, f)
      order as the JAX package's NHWC transpose gives them -> (B, W', E).

    The backbone is cuDNN's convolutions and plain tensor ops, as the JAX
    package leaves it to XLA outside any Pallas kernel; so
    ``hardware.pallas_chain`` has no effect on this encoder, as in the JAX
    package (``models/seq2seq.py:63-70``).  ``train`` selects the
    BatchNorm statistics: the batch's (and the running buffers updated), or
    the running ones."""

    def __init__(self, model_name: str = "resnet50", img_height: int = 64, img_width: int = 800,
                 channels: int = 3, embedding_dim: int = 512, output: str = "vector",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if output not in ("vector", "grid"):
            raise ValueError(f"output must be 'vector' or 'grid', got {output!r}")
        self.dtype = dtype
        self.output = output
        self.backbone = ResNetBackbone(model_name, channels, dtype)
        fdim = feature_dim(model_name)
        hf, wf = feature_hw(img_height, img_width)
        self.feature_shape: Tuple[int, int, int] = (fdim, hf, wf)  # (F, H', W') after layer4
        self.head = nn.Linear(fdim * hf if output == "grid" else fdim, embedding_dim)

    def features(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x (B, H, W, C) float NHWC -> layer4's map (B, F, H', W') NCHW."""
        return self.backbone(x, train)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x (B, H, W, C) float NHWC -> (B, E) vector or (B, W', E) grid."""
        return self.project(self.features(x, train))

    def project(self, y: torch.Tensor) -> torch.Tensor:
        """The head: layer4's map (B, F, H', W') -> (B, E) vector or (B, W', E) grid."""
        if self.output == "grid":
            B, Fd, Hf, Wf = y.shape
            y = y.permute(0, 3, 2, 1).reshape(B, Wf, Hf * Fd)
        else:
            y = y.mean(dim=(2, 3))
        return F.relu(F.linear(y, self.head.weight.to(self.dtype), self.head.bias.to(self.dtype)))
