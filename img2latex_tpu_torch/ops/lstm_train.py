"""One LSTM layer's recurrence over a whole sequence, for training, with its backward.

Replaces the TPU kernels of ``img2latex_tpu/ops/pallas/lstm_train.py::lstm_seq_pallas``:
the forward (``pl.pallas_call`` at line 103) and the backward (line 205),
tied by the custom VJP ``_make_lstm_seq`` (line 244).  :func:`lstm_seq` is
the ``torch.autograd.Function`` with ``lstm_seq_pallas``'s contract: inputs
time-major ``gates_x`` (T, B, 4H) with both biases folded in, ``h0`` and
``c0`` (B, H) and ``w_hh``; outputs ``(ys (T, B, H), hT, cT)``;
differentiable in all four inputs.

``w_hh`` is kept in torch's (4H, H) layout, as :mod:`img2latex_tpu_torch.models.lstm`
holds it (the flax tree stores its transpose).  The forward kernel is handed
``w_hh.t().contiguous()`` (H, 4H), the matrix that ``h @ W`` multiplies; the
backward kernels take ``w_hh`` (4H, H) itself, the matrix of ``dpre @ W``;
the returned ``dW_hh`` is (4H, H).

Hand-written CUDA kernels (``csrc/lstm_seq.cu``) carry it on the card, one
launch per step from a host loop (W_hh is served from L2):

* :func:`lstm_seq_fwd` - ``g = h @ W_hh^T + gx_t`` in float32, the gates in
  float32, ``ys``, ``cs`` and the activated gates ``ga`` stored in the
  compute type; the carries are rounded to the compute type between steps,
  as the TPU kernel's scratch carries are;
* :func:`lstm_seq_bwd` - the gate gradients rebuilt from ``ga``, ``cs`` and
  ``c_prev`` in float32, ``dgates_x`` stored in the compute type, ``dh`` and
  ``dc`` carried in float32, and ``dW_hh`` summed in float32 over every step
  and row by the dW_hh kernel and its reduce, then cast to ``w_hh``'s type.  The final-state
  cotangents enter as the JAX VJP feeds them: ``dhT`` joins the last step's
  ``dys`` (added in the compute type), ``dcT`` starts the dc carry.

Their plain versions, :func:`lstm_seq_fwd_plain` and :func:`lstm_seq_bwd_plain`,
compute the same with the same rounding points and run for CPU tensors.
:func:`lstm_seq_plain` is the layer as a plain loop of the gate math that
autograd differentiates: the independent oracle of both.
"""

from __future__ import annotations

from typing import Tuple

import torch

from img2latex_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SM_COUNT = 132  # H100 SXM: the dW_hh kernel splits its rows until ~2 blocks per SM


def _gates(g: torch.Tensor, H: int):
    return (torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:2 * H]),
            torch.tanh(g[:, 2 * H:3 * H]), torch.sigmoid(g[:, 3 * H:]))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def lstm_seq_plain(gates_x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                   w_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layer as a loop over T of the gate math, differentiated by autograd.

    Float32 products and gates (float64 for float64 inputs), carries rounded
    to ``gates_x.dtype`` between steps; ``w_hh`` (4H, H).  Autograd's
    backward rounds the gradients of the compute-type carries to that type at
    every step, where the kernel carries them in float32."""
    dtype = gates_x.dtype
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    H = w_hh.shape[1]
    w = w_hh.to(dtype).to(acc)
    h, c = h0.to(dtype), c0.to(dtype)
    ys = []
    for t in range(gates_x.shape[0]):
        i, f, g, o = _gates(h.to(acc) @ w.t() + gates_x[t].to(acc), H)
        c2 = f * c.to(acc) + i * g
        h = (o * torch.tanh(c2)).to(dtype)
        c = c2.to(dtype)
        ys.append(h)
    return torch.stack(ys), h, c


def lstm_seq_fwd_plain(gates_x, h0, c0, w_t):
    """Plain version of :func:`lstm_seq_fwd`: -> (ys, cs, ga) in the compute type."""
    T, B, G = gates_x.shape
    H = G // 4
    ys = gates_x.new_empty((T, B, H))
    cs = gates_x.new_empty((T, B, H))
    ga = gates_x.new_empty((T, B, G))
    w = w_t.float()
    h, c = h0, c0
    for t in range(T):
        i, f, g, o = _gates(h.float() @ w + gates_x[t].float(), H)
        c2 = f * c.float() + i * g
        ys[t] = o * torch.tanh(c2)
        cs[t] = c2
        ga[t] = torch.cat([i, f, g, o], dim=-1)
        h, c = ys[t], cs[t]
    return ys, cs, ga


def lstm_seq_bwd_plain(dys, dhT, dcT, ga, cs, h0, c0, ys, w):
    """Plain version of :func:`lstm_seq_bwd`: -> (dgates_x, dh0, dc0, dW_hh (4H, H))."""
    T, B, H = ys.shape
    dtype = ga.dtype
    wf = w.float()
    dgx = torch.empty_like(ga)
    dw = torch.zeros((4 * H, H), dtype=torch.float32, device=ga.device)
    dh = torch.zeros((B, H), dtype=torch.float32, device=ga.device)
    dc = dcT.float()
    for t in reversed(range(T)):
        dy = (dys[t] + dhT).to(dtype) if t == T - 1 else dys[t]
        dh = dy.float() + dh
        i, f, g, o = ga[t].float().chunk(4, dim=-1)
        tc = torch.tanh(cs[t].float())
        c_prev = (c0 if t == 0 else cs[t - 1]).float()
        h_prev = h0 if t == 0 else ys[t - 1]
        d_o = dh * tc
        dc = dc + dh * o * (1.0 - tc * tc)
        di, dg, df = dc * g, dc * i, dc * c_prev
        dc = dc * f
        dpre = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g),
                          d_o * o * (1.0 - o)], dim=-1).to(dtype)
        dgx[t] = dpre
        dh = dpre.float() @ wf
        dw += dpre.float().t() @ h_prev.float()
    return dgx, dh.to(dtype), dc.to(dtype), dw.to(w.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, dtype: torch.dtype, device: torch.device, *tensors) -> None:
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} is not float32 or bfloat16")
    for t in tensors:
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name}: operands must be contiguous, of one dtype, on one device")


def lstm_seq_fwd(gates_x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                 w_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward over T steps: gates_x (T, B, 4H), h0 and c0 (B, H), w_t = W_hh^T
    (H, 4H), all in the compute type -> ys, cs (T, B, H) and ga (T, B, 4H).

    One kernel launch per step on the card; the plain version on the CPU."""
    if gates_x.device.type == "cpu":
        return lstm_seq_fwd_plain(gates_x, h0, c0, w_t)
    if gates_x.device.type != "cuda":
        raise ValueError(f"lstm_seq_fwd: unsupported device {gates_x.device}")
    T, B, G = gates_x.shape
    H = G // 4
    _check("lstm_seq_fwd", gates_x.dtype, gates_x.device, gates_x, h0, c0, w_t)
    if G != 4 * H or T < 1 or tuple(h0.shape) != (B, H) or tuple(c0.shape) != (B, H) \
            or tuple(w_t.shape) != (H, G):
        raise ValueError(f"lstm_seq_fwd: gates_x {tuple(gates_x.shape)}, h0 {tuple(h0.shape)}, "
                         f"c0 {tuple(c0.shape)}, w_t {tuple(w_t.shape)}")
    ys = gates_x.new_empty((T, B, H))
    cs = gates_x.new_empty((T, B, H))
    ga = torch.empty_like(gates_x)
    # Step t's operands by address (base + t * stride): slicing a view per
    # step would cost the host more than the step costs the card.
    launch = _build.lib().i2l_lstm_seq_fwd_step
    code, stream = _DTYPES[gates_x.dtype], torch.cuda.current_stream(gates_x.device).cuda_stream
    s_g, s_h = B * G * gates_x.element_size(), B * H * gates_x.element_size()
    gx, y, cell, a, w = gates_x.data_ptr(), ys.data_ptr(), cs.data_ptr(), ga.data_ptr(), w_t.data_ptr()
    h, c = h0.data_ptr(), c0.data_ptr()
    for t in range(T):
        err = launch(gx + t * s_g, h, c, w, y + t * s_h, cell + t * s_h, a + t * s_g, B, H, code, stream)
        _build.check(err, "i2l_lstm_seq_fwd_step")
        lstm_seq_fwd.launches += 1
        h, c = y + t * s_h, cell + t * s_h
    return ys, cs, ga


lstm_seq_fwd.launches = 0


def dw_splits(M: int, H: int) -> int:
    """Row chunks of the dW_hh kernel for M = T*B rows: enough blocks of
    64x64 output tiles for about two per SM, each chunk at least 256 rows."""
    tiles = -(-4 * H // 64) * -(-H // 64)
    return max(1, min(-(-2 * SM_COUNT // tiles), -(-M // 256)))


def lstm_seq_bwd(dys, dhT, dcT, ga, cs, h0, c0, ys, w):
    """Backward over T steps from the forward's residuals: dys (T, B, H), dhT
    and dcT (B, H), ga, cs, ys, h0, c0 as the forward had them, w = W_hh
    (4H, H), all in the compute type -> (dgates_x (T, B, 4H), dh0, dc0,
    dW_hh (4H, H)).

    On the card T + 1 launches of the step kernel (the last writes dh0 and
    dc0), then two of the dW_hh kernel (the float32 partials and their sum);
    the plain version on the CPU."""
    if ga.device.type == "cpu":
        return lstm_seq_bwd_plain(dys, dhT, dcT, ga, cs, h0, c0, ys, w)
    if ga.device.type != "cuda":
        raise ValueError(f"lstm_seq_bwd: unsupported device {ga.device}")
    T, B, H = ys.shape
    dtype = ga.dtype
    _check("lstm_seq_bwd", dtype, ga.device, dys, dhT, dcT, ga, cs, h0, c0, ys, w)
    if tuple(dys.shape) != (T, B, H) or tuple(ga.shape) != (T, B, 4 * H) \
            or tuple(cs.shape) != (T, B, H) or tuple(w.shape) != (4 * H, H) \
            or any(tuple(x.shape) != (B, H) for x in (dhT, dcT, h0, c0)):
        raise ValueError("lstm_seq_bwd: shapes disagree")
    dgx = torch.empty_like(ga)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    dc = dcT.to(torch.float32, copy=True).contiguous()  # the float32 dc carry, updated in place
    dy_last = (dys[-1] + dhT).to(dtype)  # dhT joins the last step's cotangent
    launch = _build.lib().i2l_lstm_seq_bwd_step
    code, stream = _DTYPES[dtype], torch.cuda.current_stream(ga.device).cuda_stream
    s_g, s_h = B * 4 * H * ga.element_size(), B * H * ga.element_size()
    dg, dy, a, cell, w_p, dc_p = (dgx.data_ptr(), dys.data_ptr(), ga.data_ptr(), cs.data_ptr(),
                                  w.data_ptr(), dc.data_ptr())
    for t in reversed(range(T)):
        err = launch(None if t == T - 1 else dg + (t + 1) * s_g, w_p,
                     dy_last.data_ptr() if t == T - 1 else dy + t * s_h, a + t * s_g, cell + t * s_h,
                     c0.data_ptr() if t == 0 else cell + (t - 1) * s_h, dc_p, dg + t * s_g,
                     None, None, B, H, code, stream)
        _build.check(err, "i2l_lstm_seq_bwd_step")
        lstm_seq_bwd.launches += 1
    err = launch(dg, w_p, None, None, None, None, dc_p, None, dh0.data_ptr(), dc0.data_ptr(),
                 B, H, code, stream)
    _build.check(err, "i2l_lstm_seq_bwd_step")
    lstm_seq_bwd.launches += 1
    nsplit = dw_splits(T * B, H)
    partial = torch.empty((nsplit, 4 * H, H), dtype=torch.float32, device=ga.device)
    dw = torch.empty_like(w)
    err = _build.lib().i2l_lstm_seq_dw(dgx.data_ptr(), h0.data_ptr(), ys.data_ptr(),
                                       partial.data_ptr(), dw.data_ptr(), T * B, B, H, nsplit, code,
                                       stream)
    _build.check(err, "i2l_lstm_seq_dw")
    lstm_seq_bwd.launches += 2
    return dgx, dh0, dc0, dw


lstm_seq_bwd.launches = 0


class _LSTMSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates_x, h0, c0, w_hh):
        dtype = gates_x.dtype
        gates_x = gates_x.contiguous()
        h0c = h0.to(dtype).contiguous()
        c0c = c0.to(dtype).contiguous()
        w = w_hh.to(dtype).contiguous()
        ys, cs, ga = lstm_seq_fwd(gates_x, h0c, c0c, w.t().contiguous())
        ctx.save_for_backward(ys, cs, ga, h0c, c0c, w)
        return ys, ys[-1].clone(), cs[-1].clone()

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        ys, cs, ga, h0, c0, w = ctx.saved_tensors
        dtype = ga.dtype
        dgx, dh0, dc0, dw = lstm_seq_bwd(
            dys.to(dtype).contiguous(), dhT.to(dtype).contiguous(), dcT.to(dtype).contiguous(),
            ga, cs, h0, c0, ys, w)
        return dgx, dh0, dc0, dw


def lstm_seq(gates_x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
             w_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LSTM layer over a full sequence: gates_x (T, B, 4H) = x @ W_ih^T +
    b_ih + b_hh, h0 and c0 (B, H), w_hh (4H, H) -> (ys (T, B, H), hT, cT),
    all in ``gates_x.dtype``; differentiable in every input."""
    return _LSTMSeq.apply(gates_x, h0, c0, w_hh)
