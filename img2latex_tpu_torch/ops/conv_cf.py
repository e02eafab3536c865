"""Channel-first conv block, conv3x3 (SAME) + bias + ReLU + maxpool 2x2 for any Cin.

Replaces the TPU kernel ``img2latex_tpu/ops/pallas/conv_cf.py::fused_convblock_cf``
(``pl.pallas_call`` at line 170) and its custom VJP ``convblock_cf``
(:210-227): encoder blocks 2..n of the ``hardware.pallas_chain`` path.  The
CUDA kernel is ``csrc/conv_pool.cu`` in its channel-first layout (its
channels-last layout is :mod:`img2latex_tpu_torch.ops.conv_pool`);
:func:`convblock_cf_plain` is its plain PyTorch version, the counterpart of
``_xla_convblock_cf``.

Rounding points, as in the JAX package: the conv of the compute-type values
summed in float32, the float32 bias added, ReLU, one cast to the compute
type, then the pool.  The port's other path (``conv2d`` + ``relu`` +
``max_pool2d`` in the compute type, the JAX XLA path) rounds the conv before
it adds a compute-type bias, so in bf16 the two paths differ by a rounding
step.

Weights are the port's OIHW ``nn.Conv2d`` tensors ``(Cout, Cin, 3, 3)``.

:func:`convblock_cf` is a ``torch.autograd.Function``: its forward is the
kernel (or, for CPU tensors, the plain version), its backward autograd of
:func:`convblock_cf_plain` at the saved inputs, recomputing the forward, the
route of the JAX VJP (``_convblock_cf_bwd`` linearizes ``_xla_convblock_cf``;
the JAX package has no Pallas backward for this op).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from img2latex_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def conv_taps(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """weight (Cout, Cin, 3, 3) -> the taps ``csrc/conv_pool.cu`` reads for
    inputs of ``dtype``: the compute-type weights (``kernel.astype(dtype)``)
    as (Cin, 3, 3, Cout), held in float32 for the float32 kernel; for the
    bf16 tensor-core kernel in bf16, zero-padded to (Cin16, 3, 3, Cout64)
    (Cin and Cout rounded up to multiples of 16 and 64), so that every copy of
    a stage of 16 input channels and a tile of 64 output channels lies inside
    the array."""
    taps = weight.to(dtype).permute(1, 2, 3, 0)
    if dtype == torch.float32:
        return taps.float().contiguous()
    Cin, Cout = taps.shape[0], taps.shape[3]
    out = torch.zeros((_round_up(Cin, 16), 3, 3, _round_up(Cout, 64)), dtype=dtype, device=weight.device)
    out[:Cin, :, :, :Cout] = taps
    return out


def conv_pool_launch(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                     layout: str, name: str) -> torch.Tensor:
    """One launch of ``csrc/conv_pool.cu`` on CUDA tensors: x (B, Cin, H, W)
    with ``layout="nchw"`` or (B, H, W, Cin) with ``"nhwc"``, weight (Cout,
    Cin, 3, 3), bias (Cout,) or None -> the pooled map in the same layout.
    Raises on what the kernel does not take; counts nothing (the callers do)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} is not float32 or bfloat16")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be 4-d, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    nhwc = layout == "nhwc"
    B, H, W, Cin = x.shape if nhwc else (x.shape[0], x.shape[2], x.shape[3], x.shape[1])
    Cout = weight.shape[0]
    if tuple(weight.shape) != (Cout, Cin, 3, 3) or (bias is not None and tuple(bias.shape) != (Cout,)):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} / bias "
                         f"{None if bias is None else tuple(bias.shape)} for Cin {Cin}")
    if H % 2 or W % 2:
        raise ValueError(f"{name}: H and W must be even, got {H}x{W}")
    if B > 65535 or Cout == 0 or Cin == 0:
        raise ValueError(f"{name}: B {B}, Cin {Cin}, Cout {Cout} out of range")
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError(f"{name}: x, weight and bias must be on one device")
    taps = conv_taps(weight, x.dtype)
    b = None if bias is None else bias.float().contiguous()
    shape = (B, H // 2, W // 2, Cout) if nhwc else (B, Cout, H // 2, W // 2)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    err = _build.lib().i2l_conv_pool(
        x.data_ptr(), taps.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
        B, Cin, H, W, Cout, int(nhwc), _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "i2l_conv_pool")
    return out


def convblock_cf_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, Cin, H, W), weight (Cout, Cin, 3, 3), bias (Cout,) or None ->
    (B, Cout, H/2, W/2) in ``x.dtype``: ``_xla_convblock_cf`` in plain
    PyTorch, the kernel's math on NCHW.  The conv of the compute-type values
    and the bias in float32, ReLU, one cast, then the 2x2 max pool in the
    compute type: pooling after the cast sends the gradient of a window
    whose compute-type values tie to the first of them, where JAX's
    select-and-scatter sends it."""
    w = weight.to(x.dtype).float()
    y = F.conv2d(x.float(), w, None if bias is None else bias.float(), padding=1)
    return F.max_pool2d(F.relu(y).to(x.dtype), 2)


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return convblock_cf_plain(x, weight, bias)
    out = conv_pool_launch(x, weight, bias, "nchw", "convblock_cf")
    convblock_cf.launches += 1
    return out


def fused_convblock_cf(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward alone (``fused_convblock_cf``): a CUDA tensor goes through
    the kernel, a CPU tensor through :func:`convblock_cf_plain`.  Not
    differentiable: it raises when autograd would record it."""
    _build.check_no_grad("fused_convblock_cf", x, weight, bias)
    return _forward(x, weight, bias)


class _ConvBlockCF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return _forward(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        convblock_cf.backward_calls += 1
        return _build.recompute_backward(convblock_cf_plain, ctx.saved_tensors, ctx.needs_input_grad, grad)


def convblock_cf(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, H, W) NCHW, weight (Cout, Cin, 3, 3), bias (Cout,) ->
    (B, Cout, H/2, W/2) NCHW in ``x.dtype``, differentiable in all three.

    The forward goes through the kernel for a CUDA tensor and through
    :func:`convblock_cf_plain` for a CPU tensor; the backward is autograd of
    :func:`convblock_cf_plain`, recomputing the forward."""
    return _ConvBlockCF.apply(x, weight, bias)


convblock_cf.launches = 0  # launches of the kernel in its channel-first layout
convblock_cf.backward_calls = 0  # eager backward passes
