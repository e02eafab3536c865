"""Whole greedy decode of the LSTM decoder, vector memory.

Replaces the TPU kernel ``img2latex_tpu/ops/pallas/decode_step.py::pallas_full_greedy_decode``
(``pl.pallas_call`` at line 523; ``early_exit=False``, no scores).  The TPU
kernel keeps all decoder weights (about 11.5 MB in bf16 at E=H=512, L=2)
in VMEM for the 141 steps; a Hopper SM has 227 KB of shared memory, so here
the weights are served from the 50 MB L2 and each step is L + 1 launches of
two hand-written kernels (``csrc/greedy_decode.cu``):

* :func:`lstm_layer_step` - one LSTM layer: the gate product
  ``[emb[tok]; ctx] @ W_ih + h @ W_hh + b`` (the embedding is a row gather
  inside layer 0) fused with the gate math in float32; carries are stored in
  the compute type, as the TPU kernel stores them;
* :func:`vocab_argmax_step` - the vocab product fused with the row argmax
  (lowest index wins ties), the PAD-after-END rule and the token store.

:func:`greedy_decode` is the host loop over the steps.  The same two
launches make one greedy step, :func:`decode_step`, the counterpart of
``decode_step.py::fused_decode_step`` (``pl.pallas_call`` at line 176).

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (``*_plain``) for CPU tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from img2latex_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
                            end_id: int, pad_id: int,
                            margins: Optional[torch.Tensor] = None) -> None:
    """Plain version of :func:`vocab_argmax_step`.  ``margins`` (B, T) f32,
    when given, receives the top-1 minus top-2 logit of step ``t``."""
    logits = h.float() @ w_out.float() + b_out
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)  # first maximum wins
    if margins is not None:
        top2 = torch.topk(logits, 2, dim=-1).values
        margins[:, t] = top2[:, 0] - top2[:, 1]
    if finished is not None:
        nxt = torch.where(finished.bool(), torch.full_like(nxt, pad_id), nxt)
        finished.copy_(torch.maximum(finished, (nxt == end_id).to(torch.int32)))
    tokens.copy_(nxt)
    if out is not None:
        out[:, t] = nxt


def vocab_argmax_step(h, w_out, b_out, tokens, finished, out, t: int,
                      end_id: int, pad_id: int) -> None:
    """``nxt = argmax(h @ w_out + b_out)`` per row (float32 logits, lowest
    index wins ties).  With ``finished`` (B,) int32: finished rows emit
    ``pad_id`` and a row that emits ``end_id`` becomes finished.  The token
    goes to ``tokens`` (B,) and, with ``out`` (B, T), to ``out[:, t]``."""
    if h.device.type == "cpu":
        return vocab_argmax_step_plain(h, w_out, b_out, tokens, finished, out, t, end_id, pad_id)
    if h.device.type != "cuda":
        raise ValueError(f"vocab_argmax_step: unsupported device {h.device}")
    B, H = h.shape
    Vp = w_out.shape[1]
    if h.dtype not in _DTYPES or w_out.dtype != h.dtype:
        raise TypeError("vocab_argmax_step: h and w_out must share a float32 or bfloat16 dtype")
    if tuple(w_out.shape) != (H, Vp) or tuple(b_out.shape) != (Vp,) or b_out.dtype != torch.float32:
        raise ValueError("vocab_argmax_step: w_out must be (H, Vp), b_out float32 (Vp,)")
    ints = [tokens] + [x for x in (finished, out) if x is not None]
    for x in [h, w_out, b_out] + ints:
        if not x.is_contiguous() or x.device != h.device:
            raise ValueError("vocab_argmax_step: operands must be contiguous and on one device")
    for x in ints:
        if x.dtype != torch.int32 or x.shape[0] != B:
            raise ValueError("vocab_argmax_step: tokens/finished/out must be int32 with B rows")
    T = 1 if out is None else out.shape[1]
    if not 0 <= t < T:
        raise ValueError(f"vocab_argmax_step: step {t} outside 0..{T - 1}")
    err = _build.lib().i2l_vocab_argmax_step(
        h.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), tokens.data_ptr(),
        None if finished is None else finished.data_ptr(),
        None if out is None else out.data_ptr(),
        t, T, B, H, Vp, end_id, pad_id, _DTYPES[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, "i2l_vocab_argmax_step")
    vocab_argmax_step.launches += 1


vocab_argmax_step.launches = 0


# ---------------------------------------------------------------------------
# The decode loops
# ---------------------------------------------------------------------------


def _decode(layer_step, vocab_step, packed, ctx, max_length, start_id, end_id, pad_id,
            margins=None):
    L = int(packed["num_layers"])
    H = int(packed["hidden_dim"])
    dtype = packed["emb"].dtype
    B = ctx.shape[0]
    dev = ctx.device
    ctx = ctx.to(dtype).contiguous()
    tokens = torch.full((B,), start_id, dtype=torch.int32, device=dev)
    finished = torch.zeros((B,), dtype=torch.int32, device=dev)
    out = torch.empty((B, max_length), dtype=torch.int32, device=dev)
    h = torch.zeros((2, L, B, H), dtype=dtype, device=dev)  # ping-pong: read one, write the other
    c = torch.zeros((L, B, H), dtype=dtype, device=dev)
    cur = 0
    extra = {} if margins is None else {"margins": margins}
    for t in range(max_length):
        x1 = ctx
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
    return out


def greedy_decode(packed: Dict[str, Any], ctx: torch.Tensor, max_length: int,
                  start_id: int, end_id: int, pad_id: int) -> torch.Tensor:
    """Greedy decode of all rows: ctx (B, E) -> tokens (B, max_length) int32,
    END kept and PAD after it.  CUDA tensors run the kernels; CPU tensors
    run their plain versions."""
    return _decode(lstm_layer_step, vocab_argmax_step, packed, ctx, max_length,
                   start_id, end_id, pad_id)


def greedy_decode_plain(packed: Dict[str, Any], ctx: torch.Tensor, max_length: int,
                        start_id: int, end_id: int, pad_id: int,
                        return_margins: bool = False):
    """:func:`greedy_decode` through the plain versions on any device.  With
    ``return_margins`` also returns (B, T) float32 top-1 minus top-2 logits."""
    margins = None
    if return_margins:
        margins = torch.zeros((ctx.shape[0], max_length), dtype=torch.float32, device=ctx.device)
    out = _decode(lstm_layer_step_plain, vocab_argmax_step_plain, packed, ctx, max_length,
                  start_id, end_id, pad_id, margins=margins)
    return (out, margins) if return_margins else out


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
