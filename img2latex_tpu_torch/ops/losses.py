"""Loss and accuracy on the device (counterpart of ``img2latex_tpu/ops/losses.py``).

Label-smoothed cross-entropy over the non-PAD positions, with the
log-softmax taken in float32, and masked token counts.  Everything stays a
tensor on the device: the host reads the metrics at its log cadence.

``F.cross_entropy(ignore_index=pad, label_smoothing=s)`` computes the same
loss but gives NaN for a batch that is all PAD (0 / 0); here the mean
divides by ``max(sum(mask), 1)``, so such a batch gives 0, as in the JAX
package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def smoothed_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, pad_token_id: int,
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean over non-PAD positions of ``(1 - s) * nll + s * mean_j(-logp_j)``.

    logits (..., V) in any float type, targets (...) int class ids; a
    float32 scalar."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        loss = (1.0 - label_smoothing) * nll + label_smoothing * (-logp.mean(dim=-1))
    else:
        loss = nll
    mask = (targets != pad_token_id).float()
    return (loss * mask).sum() / mask.sum().clamp_min(1.0)


def masked_token_counts(pred_ids: torch.Tensor, targets: torch.Tensor,
                        pad_token_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correct, total) int64 counts of ``pred_ids == targets`` over non-PAD positions."""
    mask = targets != pad_token_id
    return ((pred_ids == targets) & mask).sum(), mask.sum()


def masked_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                    pad_token_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correct, total) of the logits' argmax over non-PAD positions."""
    return masked_token_counts(logits.argmax(dim=-1), targets, pad_token_id)
