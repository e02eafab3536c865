"""Whole greedy decode of the LSTM decoder, vector memory.

Replaces the TPU kernel ``img2latex_tpu/ops/pallas/decode_step.py::pallas_full_greedy_decode``
(``pl.pallas_call`` at line 523), ``early_exit`` and the per-row scores
included.  The TPU kernel keeps all decoder weights (about 11.5 MB in bf16
at E=H=512, L=2) in VMEM for the 141 steps; a Hopper SM has 227 KB of
shared memory, so here the weights are served from the 50 MB L2 and each
step is L + 1 launches of two hand-written kernels (``csrc/greedy_decode.cu``):

* :func:`lstm_layer_step` - one LSTM layer: the gate product
  ``[emb[tok]; ctx] @ W_ih + h @ W_hh + b`` (the embedding is a row gather
  inside layer 0) fused with the gate math in float32; carries are stored in
  the compute type, as the TPU kernel stores them;
* :func:`vocab_argmax_step` - the vocab product fused with the row argmax
  (lowest index wins ties), the PAD-after-END rule, the token store and,
  when asked, the step's confidence signal added to a per-row score; the
  logits never reach device memory.

:func:`greedy_decode` is the host loop over the steps.  Its context comes
from a per-step hook: the constant context here, additive attention over
grid memory in :mod:`img2latex_tpu_torch.ops.grid_decode`.  With
``early_exit`` the output is PAD-filled first and the host reads the
all-finished flag every :data:`EARLY_EXIT_EVERY` steps (each read waits for
the card), stopping once every row has emitted END.  The same two launches
make one greedy step, :func:`decode_step`, the counterpart of
``decode_step.py::fused_decode_step`` (``pl.pallas_call`` at line 176).

Sampling replaces ``decode_step.py::pallas_full_sample_decode``
(``pl.pallas_call`` at line 772): the same loop with
:func:`vocab_sample_step` (``csrc/sample_step.cu``) in place of
:func:`vocab_argmax_step`, on the vocab weights with the temperature folded
in (:func:`fold_temperature`).  Its draws come from :func:`uniform_field`,
the TPU kernels' counter-based hash, so the port draws the TPU kernels'
tokens: the TPU kernel decodes tiles of ``batch_tile`` rows, and row r is
row ``r % batch_tile`` of the tile seeded ``seed + r // batch_tile``; here
one launch covers every row, and the tile only defines the random stream.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (``*_plain``) for CPU tensors.  The sampling step runs one
of two kernels by route (:func:`sample_plan`): in bf16 the tensor-core
kernel of ``csrc/sample_step_tc.cu`` (the product's columns split over a
thread-block cluster, then a warp a row), otherwise the CUDA-core one of
``csrc/sample_step.cu``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from img2latex_tpu_torch.decoding.decode import NEG_INF, parse_signal, step_signal
from img2latex_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SIGNAL_CODES = {"logp": 1, "margin": 2, "entropy": 3, "margin_logp": 4}  # 0: no score
EARLY_EXIT_EVERY = 8  # steps between the host's reads of the all-finished flag


BATCH_TILE = 256  # pallas_full_sample_decode's default tile: the random stream's rows a seed
# lowbias32 hash of the TPU sampling kernels (decode_step.py:698-714), uint32
_MASK32 = 0xFFFFFFFF
_HASH_T, _HASH_ROW, _HASH_COL = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_HASH_MUL = (0x7FEB352D, 0x846CA68B)
_U_SCALE, _U_SHIFT = float(np.float32(1.0 - 2e-7)), float(np.float32(1e-7))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_decoder_weights(decoder, dtype: torch.dtype) -> Dict[str, Any]:
    """Decode-path weights of an :class:`~img2latex_tpu_torch.models.decoder.LSTMDecoder`
    in the kernels' layout (counterpart of ``decode_step.py::pack_decoder_weights``).

    ``emb (Vp, E)``, per layer ``w_ih_i (In, 4H)``, ``w_hh_i (H, 4H)`` in
    ``dtype`` and ``b_i (4H,)`` = ``b_ih + b_hh`` in float32, ``w_out (H, Vp)``
    in ``dtype`` and ``b_out (Vp,)`` in float32 with -1e30 on the padded
    columns; the vocab is padded to a multiple of 128."""
    cell = decoder.cell
    with torch.no_grad():
        emb = cell.embedding.weight.detach().float()
        V, E = emb.shape
        Vp = _round_up(V, 128)
        dev = emb.device
        emb_p = torch.zeros((Vp, E), dtype=torch.float32, device=dev)
        emb_p[:V] = emb
        w_out = cell.out.weight.detach().float().t()  # (H, V)
        H = w_out.shape[0]
        w_out_p = torch.zeros((H, Vp), dtype=torch.float32, device=dev)
        w_out_p[:, :V] = w_out
        b_out_p = torch.full((Vp,), NEG_INF, dtype=torch.float32, device=dev)
        b_out_p[:V] = cell.out.bias.detach().float()
        packed: Dict[str, Any] = {
            "emb": emb_p.to(dtype).contiguous(),
            "w_out": w_out_p.to(dtype).contiguous(),
            "b_out": b_out_p.contiguous(),
            "num_layers": cell.lstm.num_layers,
            "vocab_padded": Vp,
            "vocab": V,
            "hidden_dim": H,
        }
        for i in range(cell.lstm.num_layers):
            lstm = cell.lstm
            packed[f"w_ih_{i}"] = getattr(lstm, f"weight_ih_l{i}").detach().t().to(dtype).contiguous()
            packed[f"w_hh_{i}"] = getattr(lstm, f"weight_hh_l{i}").detach().t().to(dtype).contiguous()
            packed[f"b_{i}"] = (
                getattr(lstm, f"bias_ih_l{i}").detach().float()
                + getattr(lstm, f"bias_hh_l{i}").detach().float()
            ).contiguous()
    return packed


# ---------------------------------------------------------------------------
# Kernel 2a: one LSTM layer step
# ---------------------------------------------------------------------------


def lstm_layer_step_plain(tokens, emb, x1, h_in, w_ih, w_hh, b, c, h_out) -> None:
    """Plain version of :func:`lstm_layer_step` (same arguments, same effect)."""
    x = x1 if tokens is None else torch.cat([emb[tokens.long()], x1], dim=-1)
    gates = x.float() @ w_ih.float() + h_in.float() @ w_hh.float() + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    c.copy_(c_new.to(c.dtype))
    h_out.copy_(h_new.to(h_out.dtype))


def lstm_layer_step(tokens, emb, x1, h_in, w_ih, w_hh, b, c, h_out) -> None:
    """One LSTM layer, one step, for all rows.

    Layer 0: ``x = [emb[tokens]; x1]`` (``x1`` the context); later layers:
    ``tokens`` and ``emb`` are None and ``x = x1`` (the layer below's new h).
    ``gates = x @ w_ih + h_in @ w_hh + b`` with float32 sums; ``c`` (B, H) is
    updated in place, the new h goes to ``h_out`` (B, H), which must not
    alias ``h_in``.  Both are stored in the compute type."""
    _build.check_no_grad("lstm_layer_step", emb, x1, h_in, w_ih, w_hh, b, c)
    if x1.device.type == "cpu":
        return lstm_layer_step_plain(tokens, emb, x1, h_in, w_ih, w_hh, b, c, h_out)
    if x1.device.type != "cuda":
        raise ValueError(f"lstm_layer_step: unsupported device {x1.device}")
    B, H = h_in.shape
    E1 = x1.shape[1]
    E0 = 0 if tokens is None else emb.shape[1]
    dtype = x1.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"lstm_layer_step: dtype {dtype} is not float32 or bfloat16")
    mats = [x1, h_in, w_ih, w_hh, c, h_out] + ([emb] if tokens is not None else [])
    for t in mats:
        if t.dtype != dtype or not t.is_contiguous() or t.device != x1.device:
            raise ValueError("lstm_layer_step: operands must be contiguous, of one dtype, on one device")
    if tuple(w_ih.shape) != (E0 + E1, 4 * H) or tuple(w_hh.shape) != (H, 4 * H):
        raise ValueError(f"lstm_layer_step: w_ih {tuple(w_ih.shape)}, w_hh {tuple(w_hh.shape)}")
    if tuple(b.shape) != (4 * H,) or b.dtype != torch.float32 or not b.is_contiguous():
        raise ValueError("lstm_layer_step: b must be contiguous float32 (4H,)")
    if x1.shape[0] != B or tuple(c.shape) != (B, H) or tuple(h_out.shape) != (B, H):
        raise ValueError("lstm_layer_step: row counts or widths disagree")
    if h_out.data_ptr() == h_in.data_ptr():
        raise ValueError("lstm_layer_step: h_out must not alias h_in")
    if tokens is not None and (tokens.dtype != torch.int32 or tuple(tokens.shape) != (B,)
                               or not tokens.is_contiguous()):
        raise ValueError("lstm_layer_step: tokens must be contiguous int32 (B,)")
    err = _build.lib().i2l_lstm_layer_step(
        None if tokens is None else tokens.data_ptr(),
        None if tokens is None else emb.data_ptr(), E0,
        x1.data_ptr(), E1, h_in.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
        c.data_ptr(), h_out.data_ptr(), B, H, _DTYPES[dtype],
        torch.cuda.current_stream(x1.device).cuda_stream,
    )
    _build.check(err, "i2l_lstm_layer_step")
    lstm_layer_step.launches += 1


lstm_layer_step.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2b: vocab product + argmax + END/PAD rule
# ---------------------------------------------------------------------------


def vocab_argmax_step_plain(h, w_out, b_out, tokens, finished, out, t: int,
                            end_id: int, pad_id: int, score: Optional[torch.Tensor] = None,
                            signal: str = "logp",
                            margins: Optional[torch.Tensor] = None) -> None:
    """Plain version of :func:`vocab_argmax_step`.  ``margins`` (B, T) f32,
    when given, receives the top-1 minus top-2 logit of step ``t``."""
    logits = h.float() @ w_out.float() + b_out
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)  # first maximum wins
    if margins is not None:
        top2 = torch.topk(logits, 2, dim=-1).values
        margins[:, t] = top2[:, 0] - top2[:, 1]
    if score is not None:
        live = 1.0 if finished is None else (finished == 0).float()
        score += step_signal(logits, nxt, signal) * live
    if finished is not None:
        nxt = torch.where(finished.bool(), torch.full_like(nxt, pad_id), nxt)
        finished.copy_(torch.maximum(finished, (nxt == end_id).to(torch.int32)))
    tokens.copy_(nxt)
    if out is not None:
        out[:, t] = nxt


def vocab_argmax_step(h, w_out, b_out, tokens, finished, out, t: int,
                      end_id: int, pad_id: int, score: Optional[torch.Tensor] = None,
                      signal: str = "logp") -> None:
    """``nxt = argmax(h @ w_out + b_out)`` per row (float32 logits, lowest
    index wins ties).  With ``finished`` (B,) int32: finished rows emit
    ``pad_id`` and a row that emits ``end_id`` becomes finished.  The token
    goes to ``tokens`` (B,) and, with ``out`` (B, T), to ``out[:, t]``.
    With ``score`` (B,) float32, the step's ``signal`` (``decoding.decode.step_signal``)
    is added to it on the rows not finished before this step."""
    _build.check_no_grad("vocab_argmax_step", h, w_out, b_out, score)
    if h.device.type == "cpu":
        return vocab_argmax_step_plain(h, w_out, b_out, tokens, finished, out, t, end_id, pad_id,
                                       score=score, signal=signal)
    if h.device.type != "cuda":
        raise ValueError(f"vocab_argmax_step: unsupported device {h.device}")
    B, H = h.shape
    Vp = w_out.shape[1]
    if h.dtype not in _DTYPES or w_out.dtype != h.dtype:
        raise TypeError("vocab_argmax_step: h and w_out must share a float32 or bfloat16 dtype")
    if tuple(w_out.shape) != (H, Vp) or tuple(b_out.shape) != (Vp,) or b_out.dtype != torch.float32:
        raise ValueError("vocab_argmax_step: w_out must be (H, Vp), b_out float32 (Vp,)")
    ints = [tokens] + [x for x in (finished, out) if x is not None]
    for x in [h, w_out, b_out] + ints + ([score] if score is not None else []):
        if not x.is_contiguous() or x.device != h.device:
            raise ValueError("vocab_argmax_step: operands must be contiguous and on one device")
    for x in ints:
        if x.dtype != torch.int32 or x.shape[0] != B:
            raise ValueError("vocab_argmax_step: tokens/finished/out must be int32 with B rows")
    if score is not None and (score.dtype != torch.float32 or tuple(score.shape) != (B,)):
        raise ValueError("vocab_argmax_step: score must be float32 (B,)")
    name, alpha = parse_signal(signal)
    T = 1 if out is None else out.shape[1]
    if not 0 <= t < T:
        raise ValueError(f"vocab_argmax_step: step {t} outside 0..{T - 1}")
    err = _build.lib().i2l_vocab_argmax_step(
        h.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), tokens.data_ptr(),
        None if finished is None else finished.data_ptr(),
        None if out is None else out.data_ptr(),
        None if score is None else score.data_ptr(),
        0 if score is None else SIGNAL_CODES[name], alpha,
        t, T, B, H, Vp, end_id, pad_id, _DTYPES[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, "i2l_vocab_argmax_step")
    vocab_argmax_step.launches += 1


vocab_argmax_step.launches = 0


# ---------------------------------------------------------------------------
# Routes of the steps that need a row's whole logits (sampling, beam search)
# ---------------------------------------------------------------------------

TILE_ROWS, TILE_COLS = 32, 64  # csrc/tile_mma.cuh: rows and columns of a block's product
TILE_RING_BYTES = 55_296       # its cp.async ring (tile::kSmemBytes)
SLICE_BYTES = 32 * 72 * 4      # a slice's float32 logits, rows padded to 72 (csrc/vocab_slices.cuh)
MAX_CLUSTER = 8                # the portable cluster size
MAX_GRID_Y = 65535
SAMPLE_TC_MAX_VP = 1024        # csrc/sample_step_tc.cu: a row's keys in a warp's registers
SAMPLE_TC_MAX_TOP_K = 64       # ... and the k passes a warp makes
BLOCK_ROWS = 16                # csrc/block_logits.cuh: rows of a CUDA-core block's product
BLOCK_MAX_SMEM = 226 * 1024    # the CUDA-core kernels' dynamic shared memory at most
ROUTE_CODES = {"block": 0, "cluster_tc": 1}


@dataclass(frozen=True)
class StepPlan:
    """How a sampling or beam step launches: ``route`` "cluster_tc" (the
    bf16 tensor-core kernel, clusters of ``cluster`` blocks along x) or
    "block" (the CUDA-core kernel, ``cluster`` 1); ``grid`` (x, y); ``rows``
    a tile; ``smem_bytes`` of dynamic shared memory a block; and the floats
    of device-memory scratch the block route needs where a block's work does
    not fit its shared memory."""
    route: str
    grid: Tuple[int, int]
    cluster: int
    rows: int
    smem_bytes: int
    scratch_floats: int = 0


def staged_floats(H: int) -> int:
    """Floats of shared memory ``block_logits.cuh`` stages h and a W_out tile through."""
    hp = _round_up(H, 32)
    return (hp * 17 + 3) // 4 * 4 + 32 * 128


def cluster_tc_plan(tiles: int, Vp: int, rows: int) -> StepPlan:
    """The cluster launch of ``csrc/vocab_slices.cuh`` for ``tiles`` row
    tiles: C = min(8, Vp / 64) blocks a cluster, each holding its slices'
    logits beside the product's ring."""
    n_slices = Vp // TILE_COLS
    C = min(MAX_CLUSTER, n_slices)
    smem = TILE_RING_BYTES + -(-n_slices // C) * SLICE_BYTES
    return StepPlan("cluster_tc", (C, tiles), C, rows, smem)


def block_plan(blocks: int, rows: int, H: int, work: int) -> StepPlan:
    """The launch of a CUDA-core block kernel whose blocks each need
    ``work`` floats beside ``block_logits.cuh``'s staging: in shared memory
    where it fits, else in device-memory scratch."""
    fits = 4 * (staged_floats(H) + work) <= BLOCK_MAX_SMEM
    return StepPlan("block", (blocks, 1), 1, rows, 4 * (staged_floats(H) + (work if fits else 0)),
                    0 if fits else blocks * work)


def _check_plan_args(name: str, B: int, H: int, Vp: int, dtype: torch.dtype) -> None:
    if B <= 0 or H <= 0 or Vp <= 0 or Vp % 128 or dtype not in _DTYPES:
        raise ValueError(f"{name}: B={B}, H={H}, Vp={Vp} (a positive multiple of 128), dtype {dtype}")
    if 4 * staged_floats(H) > BLOCK_MAX_SMEM:
        raise ValueError(f"{name}: H={H} does not fit the CUDA-core kernel's staging")


def sample_plan(B: int, H: int, Vp: int, top_k: int, dtype: torch.dtype, top_p: float = 0.0) -> StepPlan:
    """The route of :func:`vocab_sample_step` for B rows of Vp columns:
    bf16 takes the tensor-core cluster kernel where a row's Np keys fit a
    warp's registers (Vp <= 1024) and its k passes cover top-k (top_k <= 64
    or top_k >= Vp, which turns the filter off); float32 and the other bf16
    shapes take the CUDA-core kernel, whose logits and sort keys go to
    device-memory scratch where they do not fit its shared memory (top_p >
    0 adds the keys).  At B = 512, Vp = 512: 8 x 16 = 128 blocks in clusters
    of 8, against 32 blocks of 16 rows."""
    _check_plan_args("sample_plan", B, H, Vp, dtype)
    if top_k < 0:
        raise ValueError(f"sample_plan: top_k {top_k}")
    tiles = -(-B // TILE_ROWS)
    if (dtype == torch.bfloat16 and Vp <= SAMPLE_TC_MAX_VP and (top_k <= SAMPLE_TC_MAX_TOP_K or top_k >= Vp)
            and tiles <= MAX_GRID_Y):
        return cluster_tc_plan(tiles, Vp, TILE_ROWS)
    keys = 2 * BLOCK_ROWS * (1 << (Vp - 1).bit_length()) if top_p > 0.0 else 0  # 64-bit keys of Np columns
    return block_plan(-(-B // BLOCK_ROWS), BLOCK_ROWS, H, BLOCK_ROWS * Vp + keys)


def launch_shape(name: str, *args) -> Optional[StepPlan]:
    """The launch the library computes for ``name`` ("sample": B, H, Vp,
    top_k, top_p_on, route code; "beam": B, K, H, Vp, route code), as a
    :class:`StepPlan`, or None where it refuses the route (needs the
    library, so the card's machine)."""
    dims = (ctypes.c_longlong * 5)()
    fn = _build.lib().i2l_sample_launch_shape if name == "sample" else _build.lib().i2l_beam_launch_shape
    smem = fn(*args, dims)
    if smem < 0:
        return None
    route = "cluster_tc" if args[-1] == ROUTE_CODES["cluster_tc"] else "block"
    return StepPlan(route, (dims[0], dims[1]), dims[2], dims[3], smem, dims[4])


def _count_launch(wrapper, plan: StepPlan) -> None:
    wrapper.launches += 1
    if plan.route == "cluster_tc":
        wrapper.cluster_tc_launches += 1
    else:
        wrapper.block_launches += 1


# ---------------------------------------------------------------------------
# Kernel 2c: vocab product + temperature, top-k, top-p and the draw
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 tensors x in [0, 2^32), in 16-bit halves
    so that no product leaves int64."""
    return ((x & 0xFFFF) * m + ((((x >> 16) * m) & 0xFFFF) << 16)) & _MASK32


def uniform_field(seed: int, t: int, rows: int, Vp: int, batch_tile: int = BATCH_TILE,
                  device=None) -> torch.Tensor:
    """The (rows, Vp) float32 uniforms of step ``t``: the TPU sampling
    kernels' lowbias32 hash of (tile seed, t, row in tile, column) in uint32
    arithmetic (carried in int64, masked to 32 bits; the TPU kernel runs it
    in int32 with logical shifts), the top 24 bits times 2^-24, then times
    1 - 2e-7 plus 1e-7 in float32.  Row r is row ``r % batch_tile`` of the
    tile whose seed is ``seed + r // batch_tile`` (mod 2^32)."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(Vp, dtype=torch.int64, device=device)[None, :]
    x = ((seed + r // batch_tile) & _MASK32) + ((t * _HASH_T) & _MASK32)
    x = (x + _mul32(r % batch_tile, _HASH_ROW) + _mul32(col, _HASH_COL)) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _HASH_MUL[0])
    x = x ^ (x >> 15)
    x = _mul32(x, _HASH_MUL[1])
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))  # exact: 24 bits
    scale = torch.tensor(_U_SCALE, dtype=torch.float32, device=device)
    return u * scale + torch.tensor(_U_SHIFT, dtype=torch.float32, device=device)


def fold_temperature(packed: Dict[str, Any], temperature: float) -> Dict[str, Any]:
    """``packed`` with the temperature folded into the vocab projection, as
    the TPU sampling kernels fold it: ``w_out`` times float32(1 / T) in
    float32, rounded back to the compute type, and ``b_out`` times it; the
    logits are not divided (in bf16 the rounding of the folded weights
    decides the draws).  No fold at T in {0, 1}.  The folded copy is cached
    in ``packed`` per temperature."""
    if temperature in (0.0, 1.0):
        return packed
    cache = packed.setdefault("folded_by_temperature", {})
    if temperature not in cache:
        with torch.no_grad():
            w_out = packed["w_out"]
            inv_t = torch.tensor(1.0 / temperature, dtype=torch.float32, device=w_out.device)
            folded = {k: v for k, v in packed.items() if k != "folded_by_temperature"}
            folded["w_out"] = (w_out.float() * inv_t).to(w_out.dtype).contiguous()
            folded["b_out"] = (packed["b_out"] * inv_t).contiguous()
        cache[temperature] = folded
    return cache[temperature]


def sample_tokens(logits: torch.Tensor, u: torch.Tensor, top_k: int, top_p: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TPU kernels' filtered draw (``decode_step.py::_sample_next_token``)
    from (B, Vp) float32 logits (temperature folded in) and uniforms ``u``.

    Returns the (B,) int32 tokens and two (B,) float32 distances to a
    knife edge, inf where none applies: ``gap``, in logit units, the least
    of the two best perturbed scores' difference, with top-k the k-th minus
    the (k+1)-th logit, and with top-p the logit of the nucleus's last token
    minus that of the first one left out (their order decides which stays);
    ``mass_gap``, with top-p, the least distance of the masses before those
    two tokens to ``top_p``.  Another version of the same draw whose logits
    and masses differ by less than these draws the same token."""
    B, Vp = logits.shape
    inf = torch.full((B,), float("inf"), device=logits.device)
    gap, mass_gap = inf, inf.clone()
    keep = torch.ones_like(logits, dtype=torch.bool)
    if 0 < top_k < Vp:
        top = torch.topk(logits, top_k + 1, dim=-1).values
        keep = logits >= top[:, top_k - 1 : top_k]
        gap = top[:, top_k - 1] - top[:, top_k]
    if top_p > 0.0:
        m = logits.max(dim=-1, keepdim=True).values
        e = torch.exp(logits - m)
        probs = e / e.sum(dim=-1, keepdim=True)
        if top_k > 0:  # renormalized between the filters
            probs = torch.where(keep, probs, torch.zeros_like(probs))
            probs = probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-38)
        srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        # The nucleus as the TPU kernel measures it: the mass before each
        # token summed sequentially in float32, in the sorted order.  Past n
        # every row's mass is above p (float32 sums of <= Vp terms stay
        # within 1e-4 of the float64 ones).
        p32 = float(np.float32(top_p))
        before64 = torch.cumsum(srt.double(), dim=-1) - srt.double()
        n = max(1, min(Vp, int((before64 <= top_p + 1e-4).sum(dim=-1).max())))
        before = torch.empty((B, n + 1), dtype=torch.float32, device=logits.device)
        cum = torch.zeros((B,), dtype=torch.float32, device=logits.device)
        for j in range(n):
            before[:, j] = cum
            cum = torch.where(cum <= p32, cum + srt[:, j], cum)
        before[:, n] = cum
        kept_sorted = before[:, :n] <= p32
        count = kept_sorted.sum(dim=-1, keepdim=True)  # >= 1: the first always stays
        nucleus = torch.zeros_like(keep).scatter(1, order[:, :n], kept_sorted)
        keep = nucleus & (probs > 0)
        score = torch.where(keep, torch.log(probs.clamp_min(1e-38)), float("-inf"))
        mass_gap = p32 - before.gather(1, count - 1)[:, 0]
        nxt_i = count.clamp_max(Vp - 1)  # the first one left out, where there is one
        dropped = (count[:, 0] < Vp) & (srt.gather(1, nxt_i)[:, 0] > 0)
        mass_gap = torch.where(dropped, torch.minimum(mass_gap, before.gather(1, count.clamp_max(n))[:, 0] - p32),
                               mass_gap)
        lsrt = logits.gather(1, order)
        gap = torch.where(dropped, torch.minimum(gap, lsrt.gather(1, count - 1)[:, 0] - lsrt.gather(1, nxt_i)[:, 0]),
                          gap)
    else:
        score = torch.where(keep, logits, float("-inf"))
    pert = score + (-torch.log(-torch.log(u)))
    top2 = torch.topk(pert, 2, dim=-1).values
    gap = torch.minimum(gap, top2[:, 0] - top2[:, 1])
    return torch.argmax(pert, dim=-1).to(torch.int32), gap, mass_gap


def vocab_sample_step_plain(h, w_out, b_out, tokens, finished, out, t: int, end_id: int,
                            pad_id: int, seed: int = 0, top_k: int = 0, top_p: float = 0.0,
                            batch_tile: int = BATCH_TILE, gaps: Optional[torch.Tensor] = None,
                            mass_gaps: Optional[torch.Tensor] = None) -> None:
    """Plain version of :func:`vocab_sample_step`.  ``gaps`` and
    ``mass_gaps`` (B, T) float32, when given, receive at column ``t`` the
    step's distances to a knife edge (:func:`sample_tokens`)."""
    logits = h.float() @ w_out.float() + b_out
    u = uniform_field(seed, t, h.shape[0], logits.shape[1], batch_tile, device=h.device)
    nxt, gap, mass_gap = sample_tokens(logits, u, top_k, top_p)
    if gaps is not None:
        gaps[:, t] = gap
    if mass_gaps is not None:
        mass_gaps[:, t] = mass_gap
    if finished is not None:
        nxt = torch.where(finished.bool(), torch.full_like(nxt, pad_id), nxt)
        finished.copy_(torch.maximum(finished, (nxt == end_id).to(torch.int32)))
    tokens.copy_(nxt)
    if out is not None:
        out[:, t] = nxt


def vocab_sample_step(h, w_out, b_out, tokens, finished, out, t: int, end_id: int, pad_id: int,
                      seed: int = 0, top_k: int = 0, top_p: float = 0.0,
                      batch_tile: int = BATCH_TILE) -> None:
    """One sampling step: ``l = h @ w_out + b_out`` per row (float32, the
    temperature folded into ``w_out`` and ``b_out``), top-k (``top_k`` > 0:
    every logit tied with the k-th largest stays), top-p (``top_p`` > 0: the
    nucleus of the probabilities, renormalized after top-k) and a Gumbel-max
    draw with :func:`uniform_field` of (``seed``, ``t``, ``batch_tile``); one
    of the filters must be on.  ``seed`` is an int32 (taken mod 2^32).
    ``tokens``, ``finished`` and ``out`` as in :func:`vocab_argmax_step`."""
    if top_k < 0 or not top_p >= 0.0 or (top_k == 0 and top_p == 0.0) or batch_tile < 1:
        raise ValueError(f"vocab_sample_step: top_k {top_k}, top_p {top_p}, batch_tile {batch_tile}: "
                         "one filter must be on and the tile positive")
    _build.check_no_grad("vocab_sample_step", h, w_out, b_out)
    if h.device.type == "cpu":
        return vocab_sample_step_plain(h, w_out, b_out, tokens, finished, out, t, end_id, pad_id,
                                       seed, top_k, top_p, batch_tile)
    if h.device.type != "cuda":
        raise ValueError(f"vocab_sample_step: unsupported device {h.device}")
    B, H = h.shape
    Vp = w_out.shape[1]
    if h.dtype not in _DTYPES or w_out.dtype != h.dtype:
        raise TypeError("vocab_sample_step: h and w_out must share a float32 or bfloat16 dtype")
    if tuple(w_out.shape) != (H, Vp) or tuple(b_out.shape) != (Vp,) or b_out.dtype != torch.float32:
        raise ValueError("vocab_sample_step: w_out must be (H, Vp), b_out float32 (Vp,)")
    if Vp % 128 or w_out.data_ptr() % 16:
        raise ValueError("vocab_sample_step: w_out must be 16-byte aligned with Vp a multiple of 128")
    ints = [tokens] + [x for x in (finished, out) if x is not None]
    for x in [h, w_out, b_out] + ints:
        if not x.is_contiguous() or x.device != h.device:
            raise ValueError("vocab_sample_step: operands must be contiguous and on one device")
    for x in ints:
        if x.dtype != torch.int32 or x.shape[0] != B:
            raise ValueError("vocab_sample_step: tokens/finished/out must be int32 with B rows")
    T = 1 if out is None else out.shape[1]
    if not 0 <= t < T:
        raise ValueError(f"vocab_sample_step: step {t} outside 0..{T - 1}")
    plan = sample_plan(B, H, Vp, int(top_k), h.dtype, float(top_p))
    scratch = (torch.empty((plan.scratch_floats,), dtype=torch.float32, device=h.device)
               if plan.scratch_floats else None)
    seed32 = (int(seed) + (1 << 31)) % (1 << 32) - (1 << 31)  # the uint32 bits as a C int
    err = _build.lib().i2l_vocab_sample_step(
        h.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), tokens.data_ptr(),
        None if finished is None else finished.data_ptr(), None if out is None else out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), t, T, B, H, Vp, end_id, pad_id, seed32,
        int(top_k), float(top_p), int(batch_tile), ROUTE_CODES[plan.route], _DTYPES[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, "i2l_vocab_sample_step")
    _count_launch(vocab_sample_step, plan)


vocab_sample_step.launches = vocab_sample_step.cluster_tc_launches = vocab_sample_step.block_launches = 0


# ---------------------------------------------------------------------------
# The decode loops
# ---------------------------------------------------------------------------


# ctx_of(h_top (B, H) compute type) -> context (B, E) compute type
ContextFn = Callable[[torch.Tensor], torch.Tensor]


def _decode(layer_step, vocab_step, packed, ctx_of: ContextFn, B: int, device,
            max_length, start_id, end_id, pad_id, early_exit=False, return_scores=False,
            signal="logp", return_margins=False):
    """The loop shared by both memory kinds: per step, the context from
    ``ctx_of`` (given the previous step's top-layer h, zero at t = 0), the L
    layer launches, then the vocab launch.  Returns tokens (B, T) int32,
    followed by the (B,) float32 scores with ``return_scores`` and by the
    (B, T) float32 top-2 margins with ``return_margins`` (plain versions only)."""
    L = int(packed["num_layers"])
    H = int(packed["hidden_dim"])
    dtype = packed["emb"].dtype
    tokens = torch.full((B,), start_id, dtype=torch.int32, device=device)
    finished = torch.zeros((B,), dtype=torch.int32, device=device)
    if early_exit:  # the steps that are skipped would emit PAD
        out = torch.full((B, max_length), pad_id, dtype=torch.int32, device=device)
    else:
        out = torch.empty((B, max_length), dtype=torch.int32, device=device)
    res = (out,)
    extra = {}
    if return_scores:
        extra.update(score=torch.zeros((B,), dtype=torch.float32, device=device), signal=signal)
        res += (extra["score"],)
    if return_margins:
        extra["margins"] = torch.zeros((B, max_length), dtype=torch.float32, device=device)
        res += (extra["margins"],)
    h = torch.zeros((2, L, B, H), dtype=dtype, device=device)  # ping-pong: read one, write the other
    c = torch.zeros((L, B, H), dtype=dtype, device=device)
    cur = 0
    for t in range(max_length):
        if early_exit and t % EARLY_EXIT_EVERY == 0 and t > 0 and bool(finished.all()):
            break
        x1 = ctx_of(h[cur, L - 1])
        for i in range(L):
            layer_step(
                tokens if i == 0 else None, packed["emb"] if i == 0 else None, x1,
                h[cur, i], packed[f"w_ih_{i}"], packed[f"w_hh_{i}"], packed[f"b_{i}"],
                c[i], h[1 - cur, i],
            )
            x1 = h[1 - cur, i]
        vocab_step(x1, packed["w_out"], packed["b_out"], tokens, finished, out, t,
                   end_id, pad_id, **extra)
        cur = 1 - cur
    return res if len(res) > 1 else out


def _vector(layer_step, vocab_step, packed, ctx, *args, **kwargs):
    ctx = ctx.to(packed["emb"].dtype).contiguous()
    return _decode(layer_step, vocab_step, packed, lambda h_top: ctx, ctx.shape[0], ctx.device,
                   *args, **kwargs)


def greedy_decode(packed: Dict[str, Any], ctx: torch.Tensor, max_length: int,
                  start_id: int, end_id: int, pad_id: int, early_exit: bool = False,
                  return_scores: bool = False, signal: str = "logp"):
    """Greedy decode of all rows: ctx (B, E) -> tokens (B, max_length) int32,
    END kept and PAD after it; with ``return_scores`` also the (B,) float32
    sums of ``signal`` over each row's live steps.  CUDA tensors run the
    kernels; CPU tensors run their plain versions."""
    return _vector(lstm_layer_step, vocab_argmax_step, packed, ctx, max_length, start_id, end_id,
                   pad_id, early_exit, return_scores, signal)


def greedy_decode_plain(packed: Dict[str, Any], ctx: torch.Tensor, max_length: int,
                        start_id: int, end_id: int, pad_id: int, early_exit: bool = False,
                        return_scores: bool = False, signal: str = "logp",
                        return_margins: bool = False):
    """:func:`greedy_decode` through the plain versions on any device.  With
    ``return_margins`` the last output is (B, T) float32 top-1 minus top-2
    logits of every step."""
    return _vector(lstm_layer_step_plain, vocab_argmax_step_plain, packed, ctx, max_length,
                   start_id, end_id, pad_id, early_exit, return_scores, signal, return_margins)


def sampler(vocab_step, top_k: int, seed: int, top_p: float, batch_tile: int, **kwargs):
    """``vocab_step`` (:func:`vocab_sample_step` or its plain version) with
    the sampling settings bound, for the decode loops."""
    return functools.partial(vocab_step, seed=int(seed), top_k=int(top_k), top_p=float(top_p),
                             batch_tile=int(batch_tile), **kwargs)


def sample_decode(packed: Dict[str, Any], ctx: torch.Tensor, max_length: int, start_id: int,
                  end_id: int, pad_id: int, top_k: int, seed: int, temperature: float = 1.0,
                  top_p: float = 0.0, batch_tile: int = BATCH_TILE, early_exit: bool = False):
    """Sampling decode of all rows (``pallas_full_sample_decode``): ctx
    (B, E) -> tokens (B, max_length) int32, END kept and PAD after it,
    drawn with temperature, top-k and top-p (:func:`vocab_sample_step`)
    from the random stream of ``seed`` and ``batch_tile``.  CUDA tensors run
    the kernels; CPU tensors run their plain versions."""
    return _vector(lstm_layer_step, sampler(vocab_sample_step, top_k, seed, top_p, batch_tile),
                   fold_temperature(packed, temperature), ctx, max_length, start_id, end_id,
                   pad_id, early_exit)


def sample_decode_plain(packed: Dict[str, Any], ctx: torch.Tensor, max_length: int, start_id: int,
                        end_id: int, pad_id: int, top_k: int, seed: int, temperature: float = 1.0,
                        top_p: float = 0.0, batch_tile: int = BATCH_TILE, early_exit: bool = False,
                        return_gaps: bool = False):
    """:func:`sample_decode` through the plain versions on any device.  With
    ``return_gaps`` also the (B, T) float32 ``gaps`` and ``mass_gaps`` of
    every step (:func:`sample_tokens`)."""
    gaps = _gaps(ctx.shape[0], max_length, ctx.device) if return_gaps else {}
    tokens = _vector(lstm_layer_step_plain,
                     sampler(vocab_sample_step_plain, top_k, seed, top_p, batch_tile, **gaps),
                     fold_temperature(packed, temperature), ctx, max_length, start_id, end_id,
                     pad_id, early_exit)
    return (tokens, gaps["gaps"], gaps["mass_gaps"]) if return_gaps else tokens


def _gaps(B: int, T: int, device) -> Dict[str, torch.Tensor]:
    """inf-filled (B, T) float32 gap records (the steps not run keep inf)."""
    return {k: torch.full((B, T), float("inf"), device=device) for k in ("gaps", "mass_gaps")}


def _step(layer_step, vocab_step, packed, tokens, ctx, h, c):
    L = int(packed["num_layers"])
    dtype = packed["emb"].dtype
    h_in = h.to(dtype).contiguous()
    h_new = torch.empty_like(h_in)
    c_new = c.to(dtype).clone()
    x1 = ctx.to(dtype).contiguous()
    for i in range(L):
        layer_step(tokens.to(torch.int32).contiguous() if i == 0 else None,
                   packed["emb"] if i == 0 else None, x1, h_in[i],
                   packed[f"w_ih_{i}"], packed[f"w_hh_{i}"], packed[f"b_{i}"], c_new[i], h_new[i])
        x1 = h_new[i]
    nxt = torch.empty((tokens.shape[0],), dtype=torch.int32, device=tokens.device)
    vocab_step(x1, packed["w_out"], packed["b_out"], nxt, None, None, 0, -1, 0)
    return nxt, h_new, c_new


def decode_step(packed: Dict[str, Any], tokens: torch.Tensor, ctx: torch.Tensor,
                h: torch.Tensor, c: torch.Tensor):
    """One greedy step without the END rule (``fused_decode_step``): tokens
    (B,) int32, ctx (B, E), h and c (L, B, H) -> (next tokens (B,), new h,
    new c), through the same two kernels as :func:`greedy_decode`."""
    return _step(lstm_layer_step, vocab_argmax_step, packed, tokens, ctx, h, c)


def decode_step_plain(packed: Dict[str, Any], tokens: torch.Tensor, ctx: torch.Tensor,
                      h: torch.Tensor, c: torch.Tensor):
    """:func:`decode_step` through the plain versions on any device."""
    return _step(lstm_layer_step_plain, vocab_argmax_step_plain, packed, tokens, ctx, h, c)
