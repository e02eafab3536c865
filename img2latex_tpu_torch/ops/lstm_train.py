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

Hand-written CUDA kernels carry it on the card, by the route :func:`seq_plan`
names for the batch, width and type:

* bf16, ``"persistent"`` (``csrc/lstm_seq_tc.cu``): one launch a layer and
  direction.  A thread-block cluster owns 16 or 32 rows for all T steps, its
  blocks split the hidden units and keep their slice of ``W_hh`` in shared
  memory, each step's product runs on the tensor cores and the new ``h``
  (forward) or the float32 partials of ``dh`` (backward) go to the other
  blocks of the cluster through distributed shared memory before a cluster
  barrier;
* ``"step"`` (``csrc/lstm_seq.cu``): one launch a step from a host loop,
  ``W_hh`` served from L2, float32 products on the CUDA cores - float32 (the
  exactness oracle), and bf16 where the slice does not fit in shared memory;
* dW_hh after the recurrence, over all T*B rows at once: on the tensor cores
  in bf16 (``lstm_seq_tc.cu``), on the CUDA cores in float32 (``lstm_seq.cu``);
  float32 partials of row chunks, summed without atomics.

Both routes keep the TPU kernels' rounding points:

* :func:`lstm_seq_fwd` - ``g = h @ W_hh^T + gx_t`` in float32, the gates in
  float32, ``ys``, ``cs`` and the activated gates ``ga`` stored in the
  compute type; the carries are rounded to the compute type between steps,
  as the TPU kernel's scratch carries are;
* :func:`lstm_seq_bwd` - the gate gradients rebuilt from ``ga``, ``cs`` and
  ``c_prev`` in float32, ``dgates_x`` stored in the compute type, ``dh`` and
  ``dc`` carried in float32 (:func:`_bwd_recurrence`), and ``dW_hh``
  summed in float32 over every step and row (:func:`_dw_hh`), then cast
  to ``w_hh``'s type.  The final-state cotangents enter as the JAX VJP feeds
  them: ``dhT`` joins the last step's ``dys`` (added in the compute type),
  ``dcT`` starts the dc carry.

Their plain versions, :func:`lstm_seq_fwd_plain` and :func:`lstm_seq_bwd_plain`,
compute the same with the same rounding points and run for CPU tensors.
:func:`lstm_seq_plain` is the layer as a plain loop of the gate math that
autograd differentiates: the independent oracle of both.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from img2latex_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SM_COUNT = 132  # H100 SXM: the dW_hh kernels split their rows to fill the SMs
SMEM_LIMIT = 232_448  # dynamic shared memory a block may have on an H100 (227 KB)
MAX_CLUSTER = 16  # blocks a cluster, the non-portable maximum
PERSIST_UNITS = (8, 16, 24, 32, 40)  # hidden units a block, the instantiated widths
SM_SMEM = 233_472  # shared memory of an H100 SM (228 KB); each block also reserves 1 KB of it
# SMs that clusters of 16 fill at once at one block an SM: cudaOccupancyMaxActiveClusters gives 7 on
# an H100 80GB HBM3, not 132 / 16 = 8, and 14 where two blocks fit an SM's shared memory.
CO_RESIDENT_SMS = 7 * 16
_STAGE = 64  # products a tensor-core stage sums from zero


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
# Routes
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _fwd_smem(H: int, U: int, nbuf: int, rows: int) -> int:
    """Dynamic shared memory of a persistent forward block: W_hh^T's slice
    (depth x 4U), nbuf h buffers of ``rows`` rows (padded by 16 bytes), the
    new h."""
    K = _round_up(H, _STAGE)
    return 2 * (K * 4 * U + nbuf * rows * (K + 8) + rows * U)


def _bwd_smem(H: int, U: int, nbuf: int, rows: int) -> int:
    """... of a persistent backward block: W_hh's rows of its gate columns
    (4U x H), its dpre slice (``rows`` x 4U, padded by 16 bytes), nbuf
    buffers of the C ranks' float32 partials of its units (C x rows x U)."""
    return 2 * (4 * U * H + rows * (4 * U + 8)) + 4 * nbuf * rows * H


@dataclass(frozen=True)
class SeqRoute:
    """How one direction runs: ``route`` "persistent" (one cluster launch,
    ``lstm_seq_tc.cu``) or "step" (a launch a step, ``lstm_seq.cu``);
    ``cluster`` blocks a cluster, ``rows`` a cluster, ``buffers`` exchange
    buffers (2: one cluster barrier a step, 1: two) and ``smem_bytes`` of
    dynamic shared memory a block - all 0 on the step route."""
    route: str
    cluster: int = 0
    rows: int = 0
    buffers: int = 0
    smem_bytes: int = 0


@dataclass(frozen=True)
class SeqPlan:
    fwd: SeqRoute
    bwd: SeqRoute

    def fwd_launches(self, T: int) -> int:
        return 1 if self.fwd.route == "persistent" else T

    def bwd_launches(self, T: int) -> int:
        """The recurrence's launches (the step route's last writes dh0 and
        dc0), plus two of dW_hh (partials, sum)."""
        return (1 if self.bwd.route == "persistent" else T + 1) + 2


_STEP = SeqRoute("step")


def co_resident_clusters(C: int, smem: int) -> int:
    """Clusters of C blocks that the card runs at once when each block has
    ``smem`` bytes of dynamic shared memory: CO_RESIDENT_SMS SMs, each with
    as many blocks as its shared memory holds."""
    return max(1, CO_RESIDENT_SMS * (SM_SMEM // (smem + 1024)) // C)


def _persistent(B: int, H: int, smem) -> SeqRoute:
    """The persistent route at width H, if its slice fits: C = the largest
    divisor of H / 8 up to 16, U = H / C one of PERSIST_UNITS; 16 rows a
    cluster, or 32 where they fit and run in fewer waves of co-resident
    clusters; two exchange buffers where they fit, else one."""
    if H % 8:
        return _STEP
    C = max(d for d in range(1, MAX_CLUSTER + 1) if (H // 8) % d == 0)
    U = H // C
    if U not in PERSIST_UNITS:
        return _STEP
    best, best_waves = _STEP, 0
    for r in (16, 32):
        nbuf = next((n for n in (2, 1) if smem(H, U, n, r) <= SMEM_LIMIT), None)
        if nbuf is None:
            break
        route = SeqRoute("persistent", C, r, nbuf, smem(H, U, nbuf, r))
        waves = -(-(-(-B // r)) // co_resident_clusters(C, route.smem_bytes))
        if best is _STEP or waves < best_waves:
            best, best_waves = route, waves
    return best


def seq_plan(B: int, H: int, dtype: torch.dtype) -> SeqPlan:
    """The route of each direction for B rows at width H: bf16 takes the
    persistent cluster kernels where a block's slice of W_hh and its exchange
    buffer fit in shared memory (H a multiple of 8, H / C <= 40 units a block
    for C <= 16), and the per-step kernels otherwise; float32 always takes
    the per-step kernels.  At B = 128: H = 512 runs both directions
    persistent in 4 clusters of 16 blocks and 32 rows (16 rows would take
    two waves), its backward with one buffer of partials; H = 384 runs its
    forward in 8 clusters of 16 rows (two blocks an SM: one wave) and its
    backward in 4 of 32; H = 640 runs its forward persistent with 16 rows
    and one h buffer, its backward (a 160 x 640 slice of W_hh and the
    partials, 245 KB) by steps; H = 1024 by steps."""
    if B <= 0 or H <= 0 or dtype not in _DTYPES:
        raise ValueError(f"seq_plan: B={B}, H={H}, dtype {dtype}")
    if dtype != torch.bfloat16:
        return SeqPlan(_STEP, _STEP)
    return SeqPlan(_persistent(B, H, _fwd_smem), _persistent(B, H, _bwd_smem))


def persist_shape(B: int, H: int, route: SeqRoute, direction: str) -> dict:
    """The persistent launch as the library sees it, for logs and tests:
    its shared memory a block (bytes), clusters, threads a block and
    ``cudaOccupancyMaxActiveClusters`` for it (needs the card)."""
    dims = (ctypes.c_int * 3)()
    smem = _build.lib().i2l_lstm_seq_persist_shape(B, H, route.cluster, route.rows, route.buffers,
                                                   0 if direction == "fwd" else 1, dims)
    return {"smem_bytes": smem, "clusters": dims[1], "threads": dims[2], "max_active_clusters": dims[0]}


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, dtype: torch.dtype, device: torch.device, *tensors) -> None:
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} is not float32 or bfloat16")
    for t in tensors:
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name}: operands must be contiguous, of one dtype, on one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy where its data does not start on 16 bytes (the
    persistent kernels copy rows in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def lstm_seq_fwd(gates_x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                 w_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward over T steps: gates_x (T, B, 4H), h0 and c0 (B, H), w_t = W_hh^T
    (H, 4H), all in the compute type -> ys, cs (T, B, H) and ga (T, B, 4H).

    On the card one cluster launch (``seq_plan``'s persistent route) or one
    launch per step; the plain version on the CPU."""
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
    code, stream = _DTYPES[gates_x.dtype], torch.cuda.current_stream(gates_x.device).cuda_stream
    route = seq_plan(B, H, gates_x.dtype).fwd
    if route.route == "persistent":
        gx, h, c, w = (_aligned(x) for x in (gates_x, h0, c0, w_t))
        err = _build.lib().i2l_lstm_seq_fwd_persist(
            gx.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(), ys.data_ptr(), cs.data_ptr(),
            ga.data_ptr(), T, B, H, route.cluster, route.rows, route.buffers, stream)
        _build.check(err, "i2l_lstm_seq_fwd_persist")
        lstm_seq_fwd.launches += 1
        lstm_seq_fwd.persistent_launches += 1
        return ys, cs, ga
    # Step t's operands by address (base + t * stride): slicing a view per
    # step would cost the host more than the step costs the card.
    launch = _build.lib().i2l_lstm_seq_fwd_step
    s_g, s_h = B * G * gates_x.element_size(), B * H * gates_x.element_size()
    gx, y, cell, a, w = gates_x.data_ptr(), ys.data_ptr(), cs.data_ptr(), ga.data_ptr(), w_t.data_ptr()
    h, c = h0.data_ptr(), c0.data_ptr()
    for t in range(T):
        err = launch(gx + t * s_g, h, c, w, y + t * s_h, cell + t * s_h, a + t * s_g, B, H, code, stream)
        _build.check(err, "i2l_lstm_seq_fwd_step")
        lstm_seq_fwd.launches += 1
        lstm_seq_fwd.step_launches += 1
        h, c = y + t * s_h, cell + t * s_h
    return ys, cs, ga


# launches of every route, and of each
lstm_seq_fwd.launches = lstm_seq_fwd.persistent_launches = lstm_seq_fwd.step_launches = 0


def dw_splits(M: int, H: int) -> int:
    """Row chunks of the float32 dW_hh kernel for M = T*B rows: enough blocks
    of 64x64 output tiles for about two per SM, each chunk at least 256 rows."""
    tiles = -(-4 * H // 64) * -(-H // 64)
    return max(1, min(-(-2 * SM_COUNT // tiles), -(-M // 256)))


def dw_tc_splits(M: int, H: int) -> int:
    """Row chunks of the bf16 tensor-core dW_hh kernel: its 128x128 output
    tiles times the chunks fill the SMs once (one block an SM), each chunk at
    least 256 rows."""
    tiles = -(-4 * H // 128) * -(-H // 128)
    return max(1, min(SM_COUNT // tiles, -(-M // 256)))


def _check_bwd(dys, dhT, dcT, ga, cs, h0, c0, ys, w):
    T, B, H = ys.shape
    _check("lstm_seq_bwd", ga.dtype, ga.device, dys, dhT, dcT, ga, cs, h0, c0, ys, w)
    if tuple(dys.shape) != (T, B, H) or tuple(ga.shape) != (T, B, 4 * H) \
            or tuple(cs.shape) != (T, B, H) or tuple(w.shape) != (4 * H, H) \
            or any(tuple(x.shape) != (B, H) for x in (dhT, dcT, h0, c0)):
        raise ValueError("lstm_seq_bwd: shapes disagree")


def _bwd_recurrence(dys, dhT, dcT, ga, cs, c0, w):
    """The backward's recurrence on the card, on operands that
    :func:`lstm_seq_bwd` has checked: dys (T, B, H), dhT and dcT (B, H), ga,
    cs, c0 as the forward had them, w = W_hh (4H, H), all in the compute type -> (dgates_x (T, B, 4H), dh0, dc0).  One cluster launch
    (``seq_plan``'s persistent route) or T + 1 launches of the step kernel
    (the last writes dh0 and dc0)."""
    T, B, H = cs.shape
    dtype = ga.dtype
    dgx = torch.empty_like(ga)
    dh0 = torch.empty_like(c0)
    dc0 = torch.empty_like(c0)
    dy_last = (dys[-1] + dhT).to(dtype)  # dhT joins the last step's cotangent
    code, stream = _DTYPES[dtype], torch.cuda.current_stream(ga.device).cuda_stream
    route = seq_plan(B, H, dtype).bwd
    if route.route == "persistent":
        ops = [_aligned(x) for x in (dys, dy_last, dcT, ga, cs, c0, w)]
        err = _build.lib().i2l_lstm_seq_bwd_persist(
            *(x.data_ptr() for x in ops), dgx.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            T, B, H, route.cluster, route.rows, route.buffers, stream)
        _build.check(err, "i2l_lstm_seq_bwd_persist")
        lstm_seq_bwd.launches += 1
        lstm_seq_bwd.persistent_launches += 1
        return dgx, dh0, dc0
    dc = dcT.to(torch.float32, copy=True).contiguous()  # the float32 dc carry, updated in place
    launch = _build.lib().i2l_lstm_seq_bwd_step
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
        lstm_seq_bwd.step_launches += 1
    err = launch(dg, w_p, None, None, None, None, dc_p, None, dh0.data_ptr(), dc0.data_ptr(),
                 B, H, code, stream)
    _build.check(err, "i2l_lstm_seq_bwd_step")
    lstm_seq_bwd.launches += 1
    lstm_seq_bwd.step_launches += 1
    return dgx, dh0, dc0


def _dw_hh(dgx, h0, ys, w):
    """dW_hh (4H, H) = dgates_x^T @ [h0; ys[:-1]] over all T*B rows on the
    card, on operands that :func:`lstm_seq_bwd` has checked, in ``w``'s
    type: bf16 on the tensor cores, float32 on the CUDA cores; float32
    partials of row chunks, then one launch that sums them in a fixed order
    and casts.  Two launches."""
    T, B, H = ys.shape
    M = T * B
    stream = torch.cuda.current_stream(dgx.device).cuda_stream
    dw = torch.empty_like(w)
    if dgx.dtype == torch.bfloat16:
        nsplit = dw_tc_splits(M, H)
        partial = torch.empty((nsplit, 4 * H, H), dtype=torch.float32, device=dgx.device)
        err = _build.lib().i2l_lstm_seq_dw_tc(dgx.data_ptr(), h0.data_ptr(), ys.data_ptr(), partial.data_ptr(),
                                              dw.data_ptr(), M, B, H, nsplit, stream)
        _build.check(err, "i2l_lstm_seq_dw_tc")
    else:
        nsplit = dw_splits(M, H)
        partial = torch.empty((nsplit, 4 * H, H), dtype=torch.float32, device=dgx.device)
        err = _build.lib().i2l_lstm_seq_dw(dgx.data_ptr(), h0.data_ptr(), ys.data_ptr(), partial.data_ptr(),
                                           dw.data_ptr(), M, B, H, nsplit, stream)
        _build.check(err, "i2l_lstm_seq_dw")
    lstm_seq_bwd.launches += 2
    lstm_seq_bwd.dw_launches += 2
    return dw


def lstm_seq_bwd(dys, dhT, dcT, ga, cs, h0, c0, ys, w):
    """Backward over T steps from the forward's residuals: dys (T, B, H), dhT
    and dcT (B, H), ga, cs, ys, h0, c0 as the forward had them, w = W_hh
    (4H, H), all in the compute type -> (dgates_x (T, B, 4H), dh0, dc0,
    dW_hh (4H, H)).

    On the card the recurrence (:func:`_bwd_recurrence`), then
    dW_hh (:func:`_dw_hh`); the plain version on the CPU."""
    if ga.device.type == "cpu":
        return lstm_seq_bwd_plain(dys, dhT, dcT, ga, cs, h0, c0, ys, w)
    if ga.device.type != "cuda":
        raise ValueError(f"lstm_seq_bwd: unsupported device {ga.device}")
    _check_bwd(dys, dhT, dcT, ga, cs, h0, c0, ys, w)
    dgx, dh0, dc0 = _bwd_recurrence(dys, dhT, dcT, ga, cs, c0, w)
    return dgx, dh0, dc0, _dw_hh(dgx, h0, ys, w)


# launches of every route, and of each: the persistent recurrence, the step
# recurrence, dW_hh
lstm_seq_bwd.launches = lstm_seq_bwd.persistent_launches = lstm_seq_bwd.step_launches = 0
lstm_seq_bwd.dw_launches = 0


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
