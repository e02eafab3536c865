"""First encoder block, conv3x3 (Cin=1, SAME) + bias + ReLU + maxpool 2x2.

Replaces the TPU kernel ``img2latex_tpu/ops/pallas/conv1_phase.py::fused_conv1_pool``
(``pl.pallas_call`` at line 208) and covers ``conv1_lane.py::conv1_lane_relu_pool``
(the same op without the bias: pass a zero bias).  The CUDA kernel is
``csrc/conv1_pool.cu``; :func:`conv1_pool_plain` is its plain PyTorch version.

Layouts: the input is NHWC ``(B, H, W, 1)``, as in the JAX package; the
output is NCHW ``(B, Cout, H/2, W/2)``, which is what the next block's
``conv2d`` takes (the JAX kernel's ``layout="nchw"``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from img2latex_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_COUT = 128  # taps and bias live in the kernel's shared memory


def conv1_pool_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The math of the kernel in plain PyTorch: conv and bias in float32 on
    the compute-type values, ReLU, cast, 2x2 max pool (``_xla_conv1_pool``)."""
    w = weight.to(x.dtype).float()
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w, bias.float(), padding=1)
    # rounding is monotone, so pooling before the cast gives the same values
    return F.max_pool2d(F.relu(y), 2).to(x.dtype)


def conv1_pool(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 1) NHWC, weight (Cout, 1, 3, 3), bias (Cout,) ->
    (B, Cout, H/2, W/2) NCHW in ``x.dtype``.

    A CUDA tensor goes through the kernel, a CPU tensor through
    :func:`conv1_pool_plain`."""
    if x.device.type == "cpu":
        return conv1_pool_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv1_pool: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv1_pool: dtype {x.dtype} is not float32 or bfloat16")
    if x.dim() != 4 or x.shape[-1] != 1:
        raise ValueError(f"conv1_pool: x must be (B, H, W, 1), got {tuple(x.shape)}")
    B, H, W, _ = x.shape
    Cout = weight.shape[0]
    if tuple(weight.shape) != (Cout, 1, 3, 3) or tuple(bias.shape) != (Cout,):
        raise ValueError(f"conv1_pool: weight {tuple(weight.shape)} / bias {tuple(bias.shape)}")
    if H % 2 or W % 2:
        raise ValueError(f"conv1_pool: H and W must be even, got {H}x{W}")
    if not 0 < Cout <= MAX_COUT:
        raise ValueError(f"conv1_pool: Cout must be in 1..{MAX_COUT}, got {Cout}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("conv1_pool: x, weight and bias must be on one device")
    x = x.contiguous()
    # the taps are the compute-type weights, held in float32 (kernel.astype(dtype))
    taps = weight.to(x.dtype).float().reshape(Cout, 9).contiguous()
    b = bias.float().contiguous()
    out = torch.empty((B, Cout, H // 2, W // 2), dtype=x.dtype, device=x.device)
    err = _build.lib().i2l_conv1_pool(
        x.data_ptr(), taps.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, H, W, Cout, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "i2l_conv1_pool")
    conv1_pool.launches += 1
    return out


conv1_pool.launches = 0
