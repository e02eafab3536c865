"""Greedy decoding: the eager oracle and host-side post-processing.

Counterpart of the greedy branch of ``img2latex_tpu/decoding/decode.py::greedy_sample_decode``
and of ``trim_host``.  Greedy is the argmax of the logits (the lowest index
wins ties); a row that emitted END emits PAD from the next step on, and the
token fed back is the one emitted.  :func:`greedy_decode_eager` steps the model
one token at a time in plain PyTorch; the whole-decode kernels
(:mod:`img2latex_tpu_torch.ops.decode_step`) are held against it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

# step_fn(tokens (B,), carry) -> (logits (B, V), new_carry)
StepFn = Callable[[torch.Tensor, object], Tuple[torch.Tensor, object]]


@dataclass(frozen=True)
class DecodeConfig:
    """Greedy decode settings (beam, sampling and early exit come in later slices)."""

    max_length: int = 141
    start_id: int = 1
    end_id: int = 2
    pad_id: int = 0


@torch.no_grad()
def greedy_decode_eager(step_fn: StepFn, carry0, batch_size: int,
                        cfg: DecodeConfig) -> torch.Tensor:
    """Token ids (B, max_length) int32: generated tokens only (no START),
    END kept, PAD after it.  Runs on the device of the (h, c) ``carry0``."""
    device = carry0[0].device
    tokens = torch.full((batch_size,), cfg.start_id, dtype=torch.int32, device=device)
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=device)
    carry = carry0
    out = []
    for _ in range(cfg.max_length):
        logits, carry = step_fn(tokens, carry)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens = torch.where(finished, torch.full_like(nxt, cfg.pad_id), nxt)
        finished = finished | (tokens == cfg.end_id)
        out.append(tokens)
    return torch.stack(out, dim=1)


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
