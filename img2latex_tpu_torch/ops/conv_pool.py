"""Channels-last conv3x3 (SAME) + ReLU + maxpool 2x2, no bias, any Cin.

Replaces the TPU kernel ``img2latex_tpu/ops/pallas/conv_pool.py::fused_conv_relu_pool``
(``pl.pallas_call`` at line 101): the kernel of ``csrc/conv_pool.cu`` in its
channels-last layout, without a bias (its channel-first layout with a bias
is :mod:`img2latex_tpu_torch.ops.conv_cf`).  :func:`fused_conv_relu_pool_plain`
is its plain PyTorch version.  Forward only, as the JAX function is (it has
no VJP).
"""

from __future__ import annotations

from typing import Optional

import torch

from img2latex_tpu_torch.ops import _build
from img2latex_tpu_torch.ops.conv_cf import conv_pool_launch, convblock_cf_plain


def fused_conv_relu_pool_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Cin) NHWC, weight (Cout, Cin, 3, 3) -> (B, H/2, W/2, Cout)
    in ``x.dtype``: conv in float32 on the compute-type values, ReLU, one
    cast, 2x2 max pool (``_conv_pool_kernel``'s math)."""
    y = convblock_cf_plain(x.permute(0, 3, 1, 2), weight, None)
    return y.permute(0, 2, 3, 1).contiguous()


def fused_conv_relu_pool(x: torch.Tensor, weight: torch.Tensor, w_tile: Optional[int] = None) -> torch.Tensor:
    """x (B, H, W, Cin) NHWC, weight (Cout, Cin, 3, 3) -> (B, H/2, W/2, Cout):
    conv (SAME) -> ReLU -> maxpool (2, 2).  A CUDA tensor goes through the
    kernel, a CPU tensor through :func:`fused_conv_relu_pool_plain`.

    ``w_tile`` is the TPU kernel's VMEM tiling of W, which does not change the
    result: it is checked as the JAX function checks it (even, dividing W)
    and otherwise ignored.  Not differentiable: it raises when autograd
    would record it."""
    _build.check_no_grad("fused_conv_relu_pool", x, weight)
    if x.dim() != 4:
        raise ValueError(f"fused_conv_relu_pool: x must be (B, H, W, Cin), got {tuple(x.shape)}")
    W = x.shape[2]
    if w_tile is not None and (w_tile <= 0 or W % w_tile or w_tile % 2):
        raise ValueError(f"fused_conv_relu_pool: W tile {w_tile} must divide W={W} and be even")
    if x.device.type == "cpu":
        return fused_conv_relu_pool_plain(x, weight)
    out = conv_pool_launch(x, weight, None, "nhwc", "fused_conv_relu_pool")
    fused_conv_relu_pool.launches += 1
    return out


fused_conv_relu_pool.launches = 0  # launches of the kernel in its channels-last layout
