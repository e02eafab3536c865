"""Whole greedy and beam decodes of the LSTM decoder over grid memory (S > 1).

Replaces the TPU kernels ``img2latex_tpu/ops/pallas/grid_decode.py::pallas_full_grid_greedy_decode``
(``pl.pallas_call`` at line 373), ``early_exit`` and the per-row scores
included, and ``::pallas_full_grid_beam_decode`` (``pl.pallas_call`` at
line 561, the kernel ``_grid_beam_kernel`` at line 391).  The greedy kernel
runs the vector decode loop with a context that attends, every step, from
the previous top-layer h over the memory
(B, S, E) and its projection ``U = memory @ W_m + b`` (B, S, A), both held
in VMEM for the whole decode.  Here the loop is
:func:`img2latex_tpu_torch.ops.decode_step._decode` (the LSTM and vocab
kernels of ``csrc/greedy_decode.cu``) and its context hook is
:func:`attend_step`, the hand-written attention of ``csrc/grid_attend.cu``,
which streams U and the memory from device memory every step: at B = 512
they are 65.5 MB in bf16, more than the 50 MB L2.

* :func:`pack_attention_weights` - ``w_h`` (H, A), ``w_m`` (E, A), ``v``
  (A,) in the compute type, ``b`` (A,) float32 (``grid_decode.py:63-97``);
* :func:`grid_memory_proj` - U once per batch, a plain product outside the
  kernel, as the JAX package leaves it to XLA (``grid_decode.py:100-120``);
* :func:`attend_step` / :func:`attend_step_plain` - one attention step;
* :func:`grid_greedy_decode` / :func:`grid_greedy_decode_plain`;
* :func:`grid_beam_decode` / :func:`grid_beam_decode_plain` - the beam loop
  of :mod:`img2latex_tpu_torch.ops.beam_decode` with the context of each
  beam from :func:`attend_step` on its parent-gathered top-layer h, with
  ``rows_per_mem = K``: the K beams of a sample (adjacent rows) attend over
  that sample's row of U and the memory, which stay (B, S, .) and are never
  copied K times, as in the TPU kernel.  The TPU kernel's tile choice
  (``_auto_tile_beam`` and the VMEM budget, lines 488-519) has no
  counterpart here: the card's kernels take the whole batch at once;
* :func:`grid_sample_decode` / :func:`grid_sample_decode_plain` - the
  sampling decode (``::pallas_full_grid_sample_decode``, ``pl.pallas_call``
  at line 665): the greedy loop with ``decode_step.vocab_sample_step``.
  The TPU kernel's batch tile defines its random stream (row r is row
  ``r % tile`` of the tile seeded ``seed + r // tile``), so its default,
  :func:`auto_tile` (``_auto_tile``, lines 243-284), is ported as a shape
  function with the fixed 96 MiB budget; the launches still take the whole
  batch at once.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from img2latex_tpu_torch.decoding.decode import DecodeConfig
from img2latex_tpu_torch.ops import _build
from img2latex_tpu_torch.ops.beam_decode import _beam, beam_step, beam_step_plain
from img2latex_tpu_torch.ops.decode_step import (
    _DTYPES,
    _decode,
    _gaps,
    _round_up,
    fold_temperature,
    lstm_layer_step,
    lstm_layer_step_plain,
    sampler,
    vocab_argmax_step,
    vocab_argmax_step_plain,
    vocab_sample_step,
    vocab_sample_step_plain,
)

VMEM_BUDGET_BYTES = 96 * 1024 * 1024  # _vmem_budget_bytes' default


def pack_attention_weights(decoder, dtype: torch.dtype) -> Dict[str, Any]:
    """The attention weights of an :class:`~img2latex_tpu_torch.models.decoder.LSTMDecoder`
    in the kernel's layout: ``attn.weight`` (A, H+E) split into ``w_h``
    (H, A) and ``w_m`` (E, A)."""
    att = decoder.cell.attention
    H = decoder.hidden_dim
    with torch.no_grad():
        w = att.attn.weight.detach().float()  # (A, H + E), h columns first
        return {
            "w_h": w[:, :H].t().to(dtype).contiguous(),
            "w_m": w[:, H:].t().to(dtype).contiguous(),
            "b": att.attn.bias.detach().float().contiguous(),
            "v": att.v.weight.detach()[0].to(dtype).contiguous(),
            "attn_dim": w.shape[0],
            "mem_dim": w.shape[1] - H,
            "hidden_dim": H,
        }


def grid_memory_proj(att: Dict[str, Any], memory: torch.Tensor) -> torch.Tensor:
    """U = memory @ W_m + b (B, S, A): the compute-type operands, summed in
    float32 and rounded once to the compute type."""
    dtype = att["w_m"].dtype
    u = torch.matmul(memory.to(dtype).float(), att["w_m"].float()) + att["b"]
    return u.to(dtype).contiguous()


def attend_step_plain(h, w_h, v, u, mem, ctx, hw=None, rows_per_mem: int = 1) -> torch.Tensor:
    """Plain version of :func:`attend_step` (same arguments, same effect);
    ``hw`` is unused."""
    dtype = u.dtype
    M, S, A = u.shape
    hw_ = (h.float() @ w_h.float()).to(dtype).view(M, rows_per_mem, 1, A)
    energy = torch.tanh(u[:, None] + hw_)  # (M, rows_per_mem, S, A)
    scores = (energy * v).float().sum(-1)
    w = torch.softmax(scores, dim=-1).to(dtype)
    ctx.copy_((w[..., None] * mem[:, None]).float().sum(2).to(dtype).view(ctx.shape))
    return ctx


def attend_step(h, w_h, v, u, mem, ctx, hw=None, rows_per_mem: int = 1) -> torch.Tensor:
    """One additive-attention step for all rows, into ``ctx`` (B, E):
    ``softmax_s(sum_a tanh(U + h @ W_h) v) . memory``, rounded to the
    compute type where ``grid_decode.py::_attend`` rounds (hw, the energy,
    the products, the weights).  h (B, H), w_h (H, A), v (A,), all of one
    compute type; row b attends over row ``b // rows_per_mem`` of u
    (B / rows_per_mem, S, A) and mem (B / rows_per_mem, S, E), so the K
    beams of a sample share its memory with ``rows_per_mem = K``.  ``hw``
    (B, A) is scratch for ``h @ W_h``, allocated here when not given.
    Returns ``ctx``."""
    _build.check_no_grad("attend_step", h, w_h, v, u, mem)
    if h.device.type == "cpu":
        return attend_step_plain(h, w_h, v, u, mem, ctx, rows_per_mem=rows_per_mem)
    if h.device.type != "cuda":
        raise ValueError(f"attend_step: unsupported device {h.device}")
    B, H = h.shape
    _, S, E = mem.shape
    A = w_h.shape[1]
    dtype = h.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"attend_step: dtype {dtype} is not float32 or bfloat16")
    if rows_per_mem < 1 or B % rows_per_mem:
        raise ValueError(f"attend_step: {B} rows are not a multiple of rows_per_mem {rows_per_mem}")
    M = B // rows_per_mem
    if hw is None:
        hw = torch.empty((B, A), dtype=dtype, device=h.device)
    shapes = {"w_h": (w_h, (H, A)), "v": (v, (A,)), "u": (u, (M, S, A)), "mem": (mem, (M, S, E)),
              "ctx": (ctx, (B, E)), "hw": (hw, (B, A))}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"attend_step: {name} is {tuple(x.shape)}, expected {shape}")
    for x in [h] + [x for x, _ in shapes.values()]:
        if x.dtype != dtype or not x.is_contiguous() or x.device != h.device:
            raise ValueError("attend_step: operands must be contiguous, of one dtype, on one device")
    err = _build.lib().i2l_attend_step(
        h.data_ptr(), w_h.data_ptr(), v.data_ptr(), u.data_ptr(), mem.data_ptr(), hw.data_ptr(),
        ctx.data_ptr(), B, S, E, H, A, rows_per_mem, _DTYPES[dtype],
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, "i2l_attend_step")
    attend_step.launches += 1
    return ctx


attend_step.launches = 0


def _grid(layer_step, vocab_step, attend, packed, att, memory, u, *args):
    dtype = packed["emb"].dtype
    B, _, E = memory.shape
    mem = memory.to(dtype).contiguous()
    u = u.to(dtype).contiguous()
    ctx = torch.empty((B, E), dtype=dtype, device=mem.device)
    hw = torch.empty((B, att["attn_dim"]), dtype=dtype, device=mem.device)

    def ctx_of(h_top):
        return attend(h_top, att["w_h"], att["v"], u, mem, ctx, hw)

    return _decode(layer_step, vocab_step, packed, ctx_of, B, mem.device, *args)


def grid_greedy_decode(packed: Dict[str, Any], att: Dict[str, Any], memory: torch.Tensor,
                       u: torch.Tensor, max_length: int, start_id: int, end_id: int, pad_id: int,
                       early_exit: bool = False, return_scores: bool = False,
                       signal: str = "logp"):
    """Greedy decode over grid memory: memory (B, S, E) and its projection
    ``u`` (:func:`grid_memory_proj`) -> tokens (B, max_length) int32, END
    kept and PAD after it; with ``return_scores`` also the (B,) float32 sums
    of ``signal`` over each row's live steps.  CUDA tensors run the kernels;
    CPU tensors run their plain versions."""
    return _grid(lstm_layer_step, vocab_argmax_step, attend_step, packed, att, memory, u,
                 max_length, start_id, end_id, pad_id, early_exit, return_scores, signal)


def grid_greedy_decode_plain(packed: Dict[str, Any], att: Dict[str, Any], memory: torch.Tensor,
                             u: torch.Tensor, max_length: int, start_id: int, end_id: int,
                             pad_id: int, early_exit: bool = False, return_scores: bool = False,
                             signal: str = "logp", return_margins: bool = False):
    """:func:`grid_greedy_decode` through the plain versions on any device.
    With ``return_margins`` the last output is (B, T) float32 top-1 minus
    top-2 logits of every step."""
    return _grid(lstm_layer_step_plain, vocab_argmax_step_plain, attend_step_plain, packed, att,
                 memory, u, max_length, start_id, end_id, pad_id, early_exit, return_scores,
                 signal, return_margins)


def _grid_beam(layer_step, step_fn, attend, packed, att, memory, u, K, cfg, **kwargs):
    dtype = packed["emb"].dtype
    B, _, E = memory.shape
    mem = memory.to(dtype).contiguous()
    u = u.to(dtype).contiguous()
    ctx = torch.empty((B * K, E), dtype=dtype, device=mem.device)
    hw = torch.empty((B * K, att["attn_dim"]), dtype=dtype, device=mem.device)

    def ctx_of(h_top):
        return attend(h_top, att["w_h"], att["v"], u, mem, ctx, hw, rows_per_mem=K)

    return _beam(layer_step, step_fn, packed, ctx_of, B, K, mem.device, cfg, **kwargs)


def grid_beam_decode(packed: Dict[str, Any], att: Dict[str, Any], memory: torch.Tensor,
                     u: torch.Tensor, beam_size: int, cfg: DecodeConfig,
                     trace: Optional[Dict[str, torch.Tensor]] = None):
    """Beam search of width ``beam_size`` over grid memory: memory (B, S, E)
    and its projection ``u`` (:func:`grid_memory_proj`) -> the best beam's
    tokens (B, cfg.max_length) int32 (END kept, PAD after it) and its
    selection score (B,) float32, with ``cfg``'s ids, ``length_penalty``
    and ``early_exit``; ``trace`` as in ``ops/beam_decode.py::_beam``.  CUDA
    tensors run the kernels; CPU tensors run their plain versions."""
    return _grid_beam(lstm_layer_step, beam_step, attend_step, packed, att, memory, u, beam_size,
                      cfg, trace=trace)


def grid_beam_decode_plain(packed: Dict[str, Any], att: Dict[str, Any], memory: torch.Tensor,
                           u: torch.Tensor, beam_size: int, cfg: DecodeConfig,
                           trace: Optional[Dict[str, torch.Tensor]] = None):
    """:func:`grid_beam_decode` through the plain versions on any device;
    its ``trace`` also receives the gaps of every step."""
    return _grid_beam(lstm_layer_step_plain, beam_step_plain, attend_step_plain, packed, att,
                      memory, u, beam_size, cfg, trace=trace)


def auto_tile(packed: Dict[str, Any], att: Dict[str, Any], S: int, batch: int = 0) -> int:
    """The TPU grid kernels' default batch tile (``grid_decode.py::_auto_tile``
    with its default 96 MiB budget): the largest of 256, 128, ..., 8 and
    the batch rounded up to 8 (capped at it) whose VMEM estimate
    (``grid_vmem_bytes_estimate``: every weight, the tile's memory and U,
    the attention's temporaries and the carries) fits the budget.  Here it
    only defines the sampling decode's random stream."""
    itemsize = packed["emb"].element_size()
    weights = sum(v.numel() * v.element_size() for src in (packed, att) for v in src.values()
                  if isinstance(v, torch.Tensor))
    E, A = att["mem_dim"], att["attn_dim"]
    L, H, Vp = packed["num_layers"], packed["hidden_dim"], packed["vocab_padded"]

    def estimate(tile: int) -> int:
        return (weights + tile * S * (E + A) * itemsize + tile * S * A * (itemsize + 4)
                + tile * (4 * L * H + 4 * H + 2 * Vp) * max(itemsize, 4))

    cap = max(8, _round_up(batch, 8)) if batch > 0 else 256
    for tile in sorted({256, 128, 64, 32, 16, 8, cap}, reverse=True):
        if tile <= cap and estimate(tile) <= VMEM_BUDGET_BYTES:
            return tile
    return 8


def _grid_sample(layer_step, vocab_step, attend, packed, att, memory, u, max_length, start_id,
                 end_id, pad_id, top_k, seed, temperature, top_p, batch_tile, early_exit, **kwargs):
    if batch_tile <= 0:
        batch_tile = auto_tile(packed, att, memory.shape[1], batch=memory.shape[0])
    return _grid(layer_step, sampler(vocab_step, top_k, seed, top_p, batch_tile, **kwargs), attend,
                 fold_temperature(packed, temperature), att, memory, u, max_length, start_id,
                 end_id, pad_id, early_exit)


def grid_sample_decode(packed: Dict[str, Any], att: Dict[str, Any], memory: torch.Tensor,
                       u: torch.Tensor, max_length: int, start_id: int, end_id: int, pad_id: int,
                       top_k: int, seed: int, temperature: float = 1.0, top_p: float = 0.0,
                       batch_tile: int = 0, early_exit: bool = False):
    """Sampling decode over grid memory (``pallas_full_grid_sample_decode``):
    memory (B, S, E) and its projection ``u`` -> tokens (B, max_length)
    int32, END kept and PAD after it, drawn as in
    ``decode_step.sample_decode``; ``batch_tile`` 0 takes :func:`auto_tile`.
    CUDA tensors run the kernels; CPU tensors run their plain versions."""
    return _grid_sample(lstm_layer_step, vocab_sample_step, attend_step, packed, att, memory, u,
                        max_length, start_id, end_id, pad_id, top_k, seed, temperature, top_p,
                        batch_tile, early_exit)


def grid_sample_decode_plain(packed: Dict[str, Any], att: Dict[str, Any], memory: torch.Tensor,
                             u: torch.Tensor, max_length: int, start_id: int, end_id: int,
                             pad_id: int, top_k: int, seed: int, temperature: float = 1.0,
                             top_p: float = 0.0, batch_tile: int = 0, early_exit: bool = False,
                             return_gaps: bool = False):
    """:func:`grid_sample_decode` through the plain versions on any device;
    ``return_gaps`` as in ``decode_step.sample_decode_plain``."""
    gaps = _gaps(memory.shape[0], max_length, memory.device) if return_gaps else {}
    tokens = _grid_sample(lstm_layer_step_plain, vocab_sample_step_plain, attend_step_plain, packed,
                          att, memory, u, max_length, start_id, end_id, pad_id, top_k, seed,
                          temperature, top_p, batch_tile, early_exit, **gaps)
    return (tokens, gaps["gaps"], gaps["mass_gaps"]) if return_gaps else tokens
