"""First encoder block, conv3x3 (Cin=1, SAME) + bias + ReLU + maxpool 2x2.

Replaces the TPU kernel ``img2latex_tpu/ops/pallas/conv1_phase.py::fused_conv1_pool``
(``pl.pallas_call`` at line 208); with a zero bias and ``layout="nhwc"`` it is
``conv1_lane.py::conv1_lane_relu_pool`` (:mod:`img2latex_tpu_torch.ops.conv1_lane`).
The CUDA kernel is ``csrc/conv1_pool.cu``; :func:`conv1_pool_plain` is its
plain PyTorch version.

Layouts: the input is NHWC ``(B, H, W, 1)``, as in the JAX package.  The
output is ``layout="nchw"`` ``(B, Cout, H/2, W/2)``, what the next block's
``conv2d`` and the channel-first chain take (the JAX kernel's
``layout="nchw"``), or ``layout="nhwc"`` ``(B, H/2, W/2, Cout)``.  Callers
name the layout; the port's default is "nchw", where the JAX package's
``fused_conv1_pool`` / ``conv1_pool`` default to "nhwc".

:func:`conv1_pool` is a ``torch.autograd.Function``: its forward is the
kernel (or, for CPU tensors, the plain version), its backward is autograd of
:func:`conv1_pool_plain` at the same inputs, recomputing the forward.  That is
what the JAX custom VJP does (``conv1_phase.py:248-285``: ``_conv1_pool_bwd``
linearizes ``_xla_conv1_pool``); the JAX package has no Pallas backward for
this op, so the backward here is eager PyTorch (cuDNN's convolution
gradients on the card), not a kernel of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from img2latex_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_COUT = 128  # taps and bias live in the kernel's shared memory
LAYOUTS = ("nchw", "nhwc")


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")


def conv1_pool_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     layout: str = "nchw") -> torch.Tensor:
    """The math of the kernel in plain PyTorch: conv and bias in float32 on
    the compute-type values, ReLU, one cast, 2x2 max pool (``_xla_conv1_pool``).
    Pooling after the cast, as the JAX composition does, sends the gradient
    of a window whose compute-type values tie to the first of them, where
    JAX's select-and-scatter sends it."""
    _check_layout(layout)
    w = weight.to(x.dtype).float()
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w, bias.float(), padding=1)
    y = F.max_pool2d(F.relu(y).to(x.dtype), 2)
    return y if layout == "nchw" else y.permute(0, 2, 3, 1).contiguous()


def conv1_pool_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   layout: str = "nchw") -> torch.Tensor:
    """The forward alone: a CUDA tensor goes through the kernel, a CPU tensor
    through :func:`conv1_pool_plain`.  Not differentiable: the kernel writes
    its output where autograd does not see it."""
    _check_layout(layout)
    if x.device.type == "cpu":
        return conv1_pool_plain(x, weight, bias, layout)
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
    nhwc = layout == "nhwc"
    shape = (B, H // 2, W // 2, Cout) if nhwc else (B, Cout, H // 2, W // 2)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    err = _build.lib().i2l_conv1_pool(
        x.data_ptr(), taps.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, H, W, Cout, int(nhwc), _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "i2l_conv1_pool")
    conv1_pool.launches += 1
    conv1_pool.nhwc_launches += nhwc
    return out


class _Conv1Pool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, layout):
        ctx.save_for_backward(x, weight, bias)
        ctx.layout = layout
        return conv1_pool_fwd(x, weight, bias, layout)

    @staticmethod
    def backward(ctx, grad):
        conv1_pool.backward_calls += 1
        grads = _build.recompute_backward(conv1_pool_plain, ctx.saved_tensors, ctx.needs_input_grad, grad, ctx.layout)
        return grads + (None,)


def conv1_pool(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               layout: str = "nchw") -> torch.Tensor:
    """x (B, H, W, 1) NHWC, weight (Cout, 1, 3, 3), bias (Cout,) ->
    (B, Cout, H/2, W/2) NCHW, or (B, H/2, W/2, Cout) with ``layout="nhwc"``,
    in ``x.dtype``, differentiable in x, weight and bias.

    The forward goes through the kernel for a CUDA tensor and through
    :func:`conv1_pool_plain` for a CPU tensor; the backward is autograd of
    :func:`conv1_pool_plain`, recomputing the forward."""
    return _Conv1Pool.apply(x, weight, bias, layout)


conv1_pool.launches = 0  # launches of the kernel in either layout, counted by conv1_pool_fwd
conv1_pool.nhwc_launches = 0  # those of them with the channels-last output
conv1_pool.backward_calls = 0  # eager backward passes
