"""Optimizer and host-side learning-rate control (counterpart of ``img2latex_tpu/training/optim.py``).

The JAX package chains, with optax: a global-norm clip at
``clip_grad_norm``, the L2 term added into the gradient
(``add_decayed_weights``, torch ``Adam(weight_decay=...)``, not the
decoupled AdamW), Adam with eps 1e-8, the learning rate; and, with
``accumulation_steps`` k > 1, ``optax.MultiSteps``: the running mean of k
micro-batch gradients is clipped and applied once, and the parameters do
not change in between.  :class:`Optimizer` does the same around
``torch.optim.Adam`` (the JAX optimizer is XLA, not a Pallas kernel).

With ``model.encoder.resnet.freeze_backbone`` (a ``resnet_lstm``), the
ResNet backbone's parameters outside ``layer4_*`` are frozen, as the JAX
package's ``optax.multi_transform`` with ``set_to_zero`` freezes them
(:func:`trainable_label`): they get no update, no L2 and no Adam moments,
and the global-norm clip is taken over the trainable parameters only.  Their
gradients are still computed (the train step reports ``grad_norm`` over all
parameters, as ``optax.global_norm(grads)`` does) and their BatchNorm running
statistics still update in train mode.

The learning rate lives in Adam's param groups: :func:`set_learning_rate`
edits them, :func:`get_learning_rate` reads them.  :class:`PlateauScheduler`
(torch ``ReduceLROnPlateau`` semantics) and :class:`EarlyStopping` are
copies of the JAX classes.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

from img2latex_tpu_torch.config import Config


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32, on the device."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def trainable_label(name: str) -> str:
    """"freeze" for a ResNet backbone parameter outside layer4 (by its
    ``named_parameters`` name), else "train"."""
    parts = name.split(".")
    if "backbone" in parts and not any(p.startswith("layer4_") for p in parts):
        return "freeze"
    return "train"


class Optimizer:
    """clip -> L2 -> Adam, with MultiSteps accumulation over ``accumulation_steps``.

    :meth:`step` consumes the ``.grad`` of the parameters (the raw gradients
    of one micro-batch) and clears them; ``frozen`` parameters get no update,
    and their gradients are cleared with the others'."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float,
                 weight_decay: float = 0.0, clip_grad_norm: float = 5.0,
                 accumulation_steps: int = 1, frozen: Iterable[torch.nn.Parameter] = ()):
        self.params: List[torch.nn.Parameter] = [p for p in params if p.requires_grad]
        self.frozen: List[torch.nn.Parameter] = list(frozen)
        self.adam = torch.optim.Adam(self.params, lr=learning_rate, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)
        self.clip_grad_norm = float(clip_grad_norm)
        self.accumulation_steps = int(accumulation_steps)
        self.mini_step = 0
        self._acc: Optional[List[torch.Tensor]] = None

    def _clip(self, grads: List[torch.Tensor]) -> None:
        """optax ``clip_by_global_norm``: unchanged below the limit, else g / norm * limit."""
        norm = global_norm(grads)
        under = norm < self.clip_grad_norm
        div = torch.where(under, torch.ones_like(norm), norm)
        mul = torch.where(under, torch.ones_like(norm), torch.full_like(norm, self.clip_grad_norm))
        for g in grads:
            g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))

    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        k = self.accumulation_steps
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self._acc, grads):  # running mean, as MultiSteps keeps it
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < k:
                self.zero_grad()
                return
            grads = [a.clone() for a in self._acc]
            for a in self._acc:
                a.zero_()
            self.mini_step = 0
        self._clip(grads)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()
        self.zero_grad()

    def zero_grad(self) -> None:
        for p in self.params + self.frozen:
            p.grad = None

    def state_dict(self) -> Dict:
        return {"adam": self.adam.state_dict(), "mini_step": self.mini_step,
                "acc": None if self._acc is None else [a.cpu() for a in self._acc]}

    def load_state_dict(self, d: Dict) -> None:
        self.adam.load_state_dict(d["adam"])
        self.mini_step = int(d.get("mini_step", 0))
        acc = d.get("acc")
        self._acc = None if acc is None else [a.to(p.device) for a, p in zip(acc, self.params)]


def build_optimizer(cfg: Config, model: torch.nn.Module) -> Optimizer:
    """The optimizer of ``model``'s parameters, with the freeze mask of a
    ``resnet_lstm`` whose ``model.encoder.resnet.freeze_backbone`` is set."""
    tcfg = cfg.training
    if tcfg.optimizer.lower() != "adam":
        raise ValueError(f"Unsupported optimizer {tcfg.optimizer!r} (reference supports adam)")
    freeze_backbone = cfg.model.name == "resnet_lstm" and cfg.model.encoder.resnet.freeze_backbone
    named = list(model.named_parameters())
    frozen = [p for n, p in named if freeze_backbone and trainable_label(n) == "freeze"]
    ids = {id(p) for p in frozen}
    return Optimizer([p for _, p in named if id(p) not in ids], tcfg.learning_rate,
                     weight_decay=tcfg.weight_decay, clip_grad_norm=tcfg.clip_grad_norm,
                     accumulation_steps=tcfg.accumulation_steps, frozen=frozen)


def set_learning_rate(opt: Optimizer, learning_rate: float) -> None:
    """Set the learning rate of every param group."""
    for group in opt.adam.param_groups:
        group["lr"] = float(learning_rate)


def get_learning_rate(opt: Optimizer) -> Optional[float]:
    groups = opt.adam.param_groups
    return float(groups[0]["lr"]) if groups else None


class PlateauScheduler:
    """torch ``ReduceLROnPlateau(mode=min, threshold_mode=rel)`` semantics."""

    def __init__(self, init_lr: float, factor: float = 0.5, patience: int = 2,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = float(init_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.num_bad_epochs = 0

    def step(self, metric: float) -> bool:
        """Record an epoch metric; returns True when the LR was reduced."""
        if self.best is None or metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
            return False
        self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            reduced = new_lr < self.lr
            self.lr = new_lr
            self.num_bad_epochs = 0
            return reduced
        return False

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.best = None if d.get("best") is None else float(d["best"])
        self.num_bad_epochs = int(d.get("num_bad_epochs", 0))


class EarlyStopping:
    """Stop when the validation loss has not improved for ``patience`` epochs."""

    def __init__(self, patience: int = 10, threshold: float = 0.0):
        self.patience = patience
        self.threshold = threshold
        self.best: Optional[float] = None
        self.num_bad_epochs = 0

    def step(self, metric: float) -> bool:
        """Returns True when training should stop."""
        if self.best is None or metric < self.best - self.threshold:
            self.best = metric
            self.num_bad_epochs = 0
            return False
        self.num_bad_epochs += 1
        return self.num_bad_epochs >= self.patience

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.best = None if d.get("best") is None else float(d["best"])
        self.num_bad_epochs = int(d.get("num_bad_epochs", 0))
