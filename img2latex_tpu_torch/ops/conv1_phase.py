"""First encoder block, conv3x3 (Cin=1, SAME) + bias + ReLU + maxpool 2x2.

Replaces the TPU kernel ``img2latex_tpu/ops/pallas/conv1_phase.py::fused_conv1_pool``
(``pl.pallas_call`` at line 208); with a zero bias and ``layout="nhwc"`` it is
``conv1_lane.py::conv1_lane_relu_pool`` (:mod:`img2latex_tpu_torch.ops.conv1_lane`).
:func:`conv1_plan` names the kernel: bf16 with Cout a multiple of 8 runs
``csrc/conv1_pool_tc.cu`` (the tensor cores, on the TPU kernel's 16-tap
phase-split product, :func:`pack_conv1_taps`); float32 and the other shapes
run ``csrc/conv1_pool.cu`` (the CUDA cores; in float32 the exactness
oracle).  :func:`conv1_pool_plain` is their plain PyTorch version.

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

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from img2latex_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_COUT = 128  # taps and bias live in the kernel's shared memory
LAYOUTS = ("nchw", "nhwc")
# The launches of csrc/conv1_pool.cu (CUDA cores) and csrc/conv1_pool_tc.cu (tensor cores).
CORE_THREADS = 128
CORE_SMEM_BYTES = 4 * MAX_COUT * 10  # static: the taps and the bias
TC_THREADS = 128
TC_ROWS = 4  # pooled rows a block: 2 halo rows staged for 8
TC_SPAN = 4  # 16-pixel tiles of a warp's item
TC_STAGE_BYTES = TC_THREADS // 32 * TC_SPAN * 1024  # each warp's (16 TC_SPAN) x 32 bf16 result
TC_MAX_W = 1 << 16
MAX_SMEM = 232_448


@dataclass(frozen=True)
class Conv1Plan:
    """How conv1_pool launches: ``route`` "tc" (``conv1_pool_tc_kernel``,
    bf16) or "cuda_core" (``conv1_pool_kernel``); ``grid`` (x, y, z);
    ``threads`` a block; ``rows`` pooled rows a block; ``smem_bytes`` of
    shared memory a block (dynamic on the tensor-core route, static on the
    other)."""
    route: str
    grid: Tuple[int, int, int]
    threads: int
    rows: int
    smem_bytes: int


def tc_row_words(W: int) -> int:
    """32-bit words of one staged input row of the tensor-core kernel: 16
    bytes of zeros, the row, zeros past the last 16-pixel tile's reads, the
    whole rounded up to 16 mod 32 (two window rows on disjoint banks)."""
    need = 16 * -(-(W // 2) // 16) + 5
    return need + (16 - need) % 32


def tc_smem_bytes(W: int, rows: int) -> int:
    """Dynamic shared memory of a tensor-core block: its ``2 rows + 2``
    input rows and each warp's staged result."""
    return TC_STAGE_BYTES + 4 * (2 * rows + 2) * tc_row_words(W)


def conv1_plan(B: int, H: int, W: int, Cout: int, dtype: torch.dtype) -> Conv1Plan:
    """The route and launch of conv1_pool at x (B, H, W, 1) of ``dtype`` and
    Cout channels, by shape and dtype alone: bf16 with Cout a multiple of 8
    takes the tensor-core kernel, a block of 4 warps for each band of
    TC_ROWS pooled rows (fewer where H/2 is smaller) of one image; float32
    and the other bf16 shapes take the CUDA-core kernel, a thread a pooled
    pixel.  Raises on a shape neither kernel takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"conv1_pool: dtype {dtype} is not float32 or bfloat16")
    if B <= 0 or B > 65535 or H < 2 or W < 2 or H % 2 or W % 2 or H // 2 > 65535:
        raise ValueError(f"conv1_pool: B={B}, H={H}, W={W} (B <= 65535, H and W even and >= 2)")
    if not 0 < Cout <= MAX_COUT:
        raise ValueError(f"conv1_pool: Cout must be in 1..{MAX_COUT}, got {Cout}")
    H2, W2 = H // 2, W // 2
    if dtype == torch.bfloat16 and Cout % 8 == 0 and W <= TC_MAX_W:
        rows = min(TC_ROWS, H2)
        while rows > 1 and tc_smem_bytes(W, rows) > MAX_SMEM:
            rows -= 1
        if tc_smem_bytes(W, rows) <= MAX_SMEM:
            return Conv1Plan("tc", (-(-H2 // rows), B, 1), TC_THREADS, rows, tc_smem_bytes(W, rows))
    return Conv1Plan("cuda_core", (-(-W2 // CORE_THREADS), H2, B), CORE_THREADS, 1, CORE_SMEM_BYTES)


def tc_launch_shape(B: int, H: int, W: int, Cout: int, rows: int) -> Optional[Conv1Plan]:
    """The tensor-core launch as the library computes it (needs the built
    library), or None where it refuses the shape."""
    dims = (ctypes.c_int * 3)()
    smem = _build.lib().i2l_conv1_tc_launch_shape(B, H, W, Cout, rows, dims)
    return None if smem < 0 else Conv1Plan("tc", (dims[0], dims[1], 1), dims[2], rows, smem)


def pack_conv1_taps(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, 1, 3, 3) -> (4 Cout, 16) in ``weight``'s dtype, the layout of
    the JAX package's ``pack_conv1_taps``: row p Cout + c holds pool phase
    p = 2a + b, column 4s + t holds K_ab[s, t] = w[c, 0, s - a, t - b] (zero
    outside the 3x3 support) -- channel c's taps placed in the 4x4 input
    window of a pooled pixel at the conv output (a, b) of its pool window.
    The tensor-core kernel's B operand."""
    Cout = weight.shape[0]
    if tuple(weight.shape) != (Cout, 1, 3, 3):
        raise ValueError(f"pack_conv1_taps: weight must be (Cout, 1, 3, 3), got {tuple(weight.shape)}")
    kp = F.pad(weight.reshape(Cout, 3, 3), (1, 1, 1, 1))  # (Cout, 5, 5): kp[c, u + 1, v + 1] = w[c, 0, u, v]
    # win[i, j, c, s, t] = kp[c, i + s, j + t] = K_ab[s, t] at (i, j) = (1 - a, 1 - b)
    win = kp.as_strided((2, 2, Cout, 4, 4), (5, 1, 25, 5, 1))
    return win.flip(0, 1).reshape(4 * Cout, 16)


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
    """The forward alone: a CUDA tensor goes through the kernel that
    :func:`conv1_plan` names, a CPU tensor through :func:`conv1_pool_plain`.
    Not differentiable: the kernel writes its output where autograd does not
    see it."""
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
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("conv1_pool: x, weight and bias must be on one device")
    plan = conv1_plan(B, H, W, Cout, x.dtype)
    # the taps are the compute-type weights (kernel.astype(dtype)): packed in
    # bf16 for the tensor cores, held in float32 (Cout, 9) for the CUDA cores
    w = weight.to(x.dtype)
    taps = pack_conv1_taps(w) if plan.route == "tc" else w.float().reshape(Cout, 9)
    return conv1_pool_launch(x, taps, bias.float(), layout, plan)


def conv1_pool_launch(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, layout: str,
                      plan: Conv1Plan) -> torch.Tensor:
    """Launch ``plan``'s kernel on CUDA x (B, H, W, 1) with the taps in that
    route's form (:func:`conv1_pool_fwd` makes them) and a float32 bias;
    counted in ``conv1_pool.launches`` and by route."""
    B, H, W, _ = x.shape
    Cout = bias.shape[0]
    x, taps, bias = x.contiguous(), taps.contiguous(), bias.contiguous()
    nhwc = layout == "nhwc"
    shape = (B, H // 2, W // 2, Cout) if nhwc else (B, Cout, H // 2, W // 2)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.route == "tc":
        err = _build.lib().i2l_conv1_pool_tc(
            x.data_ptr(), taps.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, Cout, int(nhwc), plan.rows,
            stream)
        _build.check(err, "i2l_conv1_pool_tc")
        conv1_pool.tc_launches += 1
    else:
        err = _build.lib().i2l_conv1_pool(
            x.data_ptr(), taps.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, Cout, int(nhwc),
            _DTYPES[x.dtype], stream)
        _build.check(err, "i2l_conv1_pool")
        conv1_pool.core_launches += 1
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


conv1_pool.launches = 0  # launches of either kernel in either layout, counted by conv1_pool_launch
conv1_pool.nhwc_launches = 0  # those of them with the channels-last output
conv1_pool.tc_launches = 0  # those of them on the tensor-core route (conv1_pool_tc_kernel)
conv1_pool.core_launches = 0  # those of them on the CUDA-core route (conv1_pool_kernel)
conv1_pool.backward_calls = 0  # eager backward passes
