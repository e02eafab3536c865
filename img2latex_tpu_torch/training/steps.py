"""Train and eval steps (counterpart of ``img2latex_tpu/training/steps.py``).

One train step takes a uint8 batch, normalizes it on the device (float32,
as the JAX step does; the model casts to the compute type), runs the
teacher-forced forward with dropout from the state's ``torch.Generator``,
the label-smoothed loss, the backward, and the optimizer's clip, L2 and Adam
(:mod:`img2latex_tpu_torch.training.optim`).  It returns the JAX step's
metrics as tensors on the device (``loss``, ``correct``, ``total`` and
``grad_norm``, the global norm of the raw gradients); the host reads them at
its log cadence, not once per step.  The eval step is the teacher-forced
pass without dropout and returns ``loss``, ``correct``, ``total``,
``pred_ids`` and ``probs_max``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from img2latex_tpu_torch.config import Config
from img2latex_tpu_torch.models.seq2seq import Seq2SeqModel
from img2latex_tpu_torch.ops.losses import masked_accuracy, masked_token_counts, smoothed_cross_entropy
from img2latex_tpu_torch.ops.preprocess import normalize_images
from img2latex_tpu_torch.training.optim import Optimizer, global_norm


@dataclass
class TrainState:
    """The model (its parameters), the optimizer (its state), the generator
    of the dropout draws, and the count of train steps taken."""

    model: Seq2SeqModel
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0


def create_train_state(model: Seq2SeqModel, optimizer: Optimizer, cfg: Config,
                       seed: Optional[int] = None) -> TrainState:
    """A state whose dropout generator lives on the model's device, seeded
    with ``seed`` (default ``cfg.training.seed``)."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.training.seed if seed is None else int(seed))
    return TrainState(model=model, optimizer=optimizer, generator=generator)


def _device_batch(cfg: Config, device: torch.device, batch: Dict[str, Any]):
    """Host or device batch -> (float32 normalized images, int64 formulas) on ``device``."""
    pre = cfg.preprocessing
    images = torch.as_tensor(batch["images"]).to(device)
    images = normalize_images(images, pre.normalization_mean, pre.normalization_std, torch.float32)
    return images, torch.as_tensor(batch["formulas"]).to(device).long()


def train_loss(state: TrainState, cfg: Config, batch: Dict[str, Any], pad_id: int):
    """The train step's forward: -> (loss, logits, targets), dropout drawn
    from ``state.generator``."""
    model = state.model
    images, formulas = _device_batch(cfg, next(model.parameters()).device, batch)
    targets = formulas[:, 1:]
    logits = model(images, formulas, train=True, generator=state.generator)
    return smoothed_cross_entropy(logits, targets, pad_id, cfg.training.label_smoothing), logits, targets


def make_train_step(cfg: Config, pad_id: int) -> Callable[[TrainState, Dict[str, Any]], Dict[str, torch.Tensor]]:
    """``train_step(state, batch) -> metrics``; updates the model and optimizer in place."""

    def train_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad()
        loss, logits, targets = train_loss(state, cfg, batch, pad_id)
        loss.backward()
        with torch.no_grad():
            correct, total = masked_accuracy(logits, targets, pad_id)
            grad_norm = global_norm(p.grad for p in state.optimizer.params if p.grad is not None)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "correct": correct, "total": total, "grad_norm": grad_norm}

    return train_step


def make_eval_step(cfg: Config, pad_id: int) -> Callable[[TrainState, Dict[str, Any]], Dict[str, torch.Tensor]]:
    """``eval_step(state, batch) -> outputs`` of the teacher-forced pass, no dropout."""
    smoothing = cfg.training.label_smoothing

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        model = state.model
        images, formulas = _device_batch(cfg, next(model.parameters()).device, batch)
        targets = formulas[:, 1:]
        logits = model(images, formulas)
        loss = smoothed_cross_entropy(logits, targets, pad_id, smoothing)
        probs = torch.softmax(logits.float(), dim=-1)
        pred_ids = probs.argmax(dim=-1).to(torch.int32)  # softmax keeps the argmax
        probs_max = probs.max(dim=-1).values
        correct, total = masked_token_counts(pred_ids, targets, pad_id)
        return {"loss": loss, "correct": correct, "total": total, "pred_ids": pred_ids,
                "probs_max": probs_max}

    return eval_step
