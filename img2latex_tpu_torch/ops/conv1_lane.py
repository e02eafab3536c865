"""Single-channel conv3x3 (SAME) + ReLU + maxpool 2x2, no bias, channels-last out.

Replaces the TPU kernel ``img2latex_tpu/ops/pallas/conv1_lane.py::conv1_lane_relu_pool``
(``pl.pallas_call`` at line 96): the conv1-pool kernels (``csrc/conv1_pool_tc.cu``
in bf16, ``csrc/conv1_pool.cu`` otherwise; :mod:`img2latex_tpu_torch.ops.conv1_phase`)
with a zero bias and their NHWC output.  :func:`conv1_lane_relu_pool_plain` is its plain PyTorch version.
Forward only, as the JAX function is (it has no VJP).
"""

from __future__ import annotations

import torch

from img2latex_tpu_torch.ops import _build
from img2latex_tpu_torch.ops.conv1_phase import conv1_pool_fwd, conv1_pool_plain


def _zero_bias(weight: torch.Tensor) -> torch.Tensor:
    return torch.zeros(weight.shape[0], dtype=torch.float32, device=weight.device)


def conv1_lane_relu_pool_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 1), weight (Cout, 1, 3, 3) -> (B, H/2, W/2, Cout) in
    ``x.dtype``, in plain PyTorch."""
    return conv1_pool_plain(x, weight, _zero_bias(weight), layout="nhwc")


def conv1_lane_relu_pool(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 1) NHWC, weight (Cout, 1, 3, 3) -> (B, H/2, W/2, Cout):
    conv (SAME) -> ReLU -> maxpool (2, 2).  A CUDA tensor goes through the
    conv1-pool kernel (counted in ``conv1_pool.launches`` and
    ``conv1_pool.nhwc_launches``), a CPU tensor
    through :func:`conv1_lane_relu_pool_plain`.  Not differentiable: it
    raises when autograd would record it."""
    _build.check_no_grad("conv1_lane_relu_pool", x, weight)
    return conv1_pool_fwd(x, weight, _zero_bias(weight), layout="nhwc")
