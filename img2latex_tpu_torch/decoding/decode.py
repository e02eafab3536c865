"""Greedy decoding: the eager oracle and host-side post-processing.

Counterpart of the greedy branch of ``img2latex_tpu/decoding/decode.py::greedy_sample_decode``,
of ``signal_alpha`` and of ``trim_host``.  Greedy is the argmax of the
logits (the lowest index wins ties); a row that emitted END emits PAD from
the next step on, and the token fed back is the one emitted.
:func:`greedy_decode_eager` steps the model one token at a time in plain
PyTorch, for either memory kind (the caller's step function closes over the
memory and, for grid memory, its attention projection); the whole-decode
kernels (:mod:`img2latex_tpu_torch.ops.decode_step`,
:mod:`img2latex_tpu_torch.ops.grid_decode`) are held against it.

Per-row confidence scores (``return_scores``) sum a per-step signal over the
steps a row is live (END included, the PAD steps after it not), from the
float32 logits of the step (:func:`step_signal`):

* ``"logp"``: log-softmax of the chosen token;
* ``"margin"``: top-1 minus top-2 logit (the log-probability gap);
* ``"entropy"``: negative entropy of the step's distribution;
* ``"margin_logp[:alpha]"``: margin + alpha * logp (alpha 1 by default).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

# step_fn(tokens (B,), carry) -> (logits (B, V), new_carry)
StepFn = Callable[[torch.Tensor, object], Tuple[torch.Tensor, object]]


NEG_INF = -1e30


def signal_alpha(signal: str, default: float = 1.0) -> float:
    """The blend weight of a ``"margin_logp[:alpha]"`` signal.

    Strict: the head must be exactly ``margin_logp`` and the alpha finite.
    Unlike the JAX package, which reads ``"margin_logp:"`` (a colon with
    nothing after it) as the default alpha, this raises for it."""
    head, colon, tail = signal.partition(":")
    if head != "margin_logp" or (colon and not tail):
        raise ValueError(
            f"malformed composite selective signal {signal!r} "
            "(expected 'margin_logp' or 'margin_logp:<alpha>')"
        )
    alpha = float(tail) if tail else default
    if not math.isfinite(alpha):
        raise ValueError(f"selective-signal alpha must be finite, got {alpha!r}")
    return alpha


def parse_signal(signal: str) -> Tuple[str, float]:
    """``signal`` -> (``"logp"``, ``"margin"``, ``"entropy"`` or
    ``"margin_logp"``, alpha); raises for any other name."""
    if signal in ("logp", "margin", "entropy"):
        return signal, 0.0
    return "margin_logp", signal_alpha(signal)


@dataclass(frozen=True)
class DecodeConfig:
    """Greedy decode settings (beam and sampling come in later slices).

    ``early_exit``: stop once every row has emitted END; the output is the
    same as the full loop's.  ``selective_signal``: the per-step confidence
    that ``return_scores`` sums (module docstring)."""

    max_length: int = 141
    start_id: int = 1
    end_id: int = 2
    pad_id: int = 0
    early_exit: bool = False
    selective_signal: str = "margin"


def step_signal(logits: torch.Tensor, nxt: torch.Tensor, signal: str) -> torch.Tensor:
    """(B, V) logits and the chosen tokens (B,) -> the (B,) float32 signal,
    as the TPU decode loop computes it (``ops/pallas/decode_step.py:327-372``):
    the logsumexp from the row max, the runner-up by masking the chosen
    column (greedy picks the argmax, so an exact tie gives margin 0)."""
    name, alpha = parse_signal(signal)
    logits = logits.float()
    top1 = logits.max(dim=-1).values
    lse = top1 + torch.log(torch.exp(logits - top1[:, None]).sum(-1))
    chosen = logits.gather(1, nxt.long()[:, None])[:, 0]
    if name == "logp":
        return chosen - lse
    if name == "entropy":
        logp = logits - lse[:, None]
        return (torch.exp(logp) * logp).sum(-1)
    col = torch.arange(logits.shape[1], device=logits.device)
    rest = torch.where(col[None, :] == nxt.long()[:, None], NEG_INF, logits)
    margin = top1 - rest.max(dim=-1).values
    return margin if name == "margin" else margin + alpha * (chosen - lse)


@torch.no_grad()
def greedy_decode_eager(step_fn: StepFn, carry0, batch_size: int, cfg: DecodeConfig,
                        return_scores: bool = False):
    """Token ids (B, max_length) int32: generated tokens only (no START),
    END kept, PAD after it.  Runs on the device of the (h, c) ``carry0``.
    With ``return_scores`` also returns the (B,) float32 sums of
    ``cfg.selective_signal`` over the live steps."""
    device = carry0[0].device
    tokens = torch.full((batch_size,), cfg.start_id, dtype=torch.int32, device=device)
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=device)
    score = torch.zeros((batch_size,), dtype=torch.float32, device=device)
    out = torch.full((batch_size, cfg.max_length), cfg.pad_id, dtype=torch.int32, device=device)
    carry = carry0
    for t in range(cfg.max_length):
        if cfg.early_exit and bool(finished.all()):
            break  # the remaining steps would emit PAD
        logits, carry = step_fn(tokens, carry)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if return_scores:
            score += torch.where(finished, 0.0, step_signal(logits, nxt, cfg.selective_signal))
        tokens = torch.where(finished, torch.full_like(nxt, cfg.pad_id), nxt)
        finished = finished | (tokens == cfg.end_id)
        out[:, t] = tokens
    return (out, score) if return_scores else out


def trim_host(tokens: np.ndarray, end_id: int, pad_id: int,
              start_id: Optional[int] = None) -> List[List[int]]:
    """(B, T) ids -> one list per row, cut at the first END (exclusive),
    PAD dropped, and a START at position 0 dropped when ``start_id`` is given."""
    arr = np.asarray(tokens)
    if arr.size == 0:
        return [[] for _ in range(arr.shape[0])] if arr.ndim == 2 else []
    B, T = arr.shape
    is_end = arr == end_id
    end_pos = np.where(is_end.any(axis=1), is_end.argmax(axis=1), T)
    valid = (np.arange(T)[None, :] < end_pos[:, None]) & (arr != pad_id)
    if start_id is not None:
        valid[:, 0] &= arr[:, 0] != start_id
    return [arr[i, valid[i]].tolist() for i in range(B)]
