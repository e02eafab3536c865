"""Trainer: epochs, validation, plateau LR, early stop, checkpoints
(counterpart of ``img2latex_tpu/training/trainer.py``).

One device, the card unless ``device="cpu"`` is named.  Each train step is
:func:`~img2latex_tpu_torch.training.steps.make_train_step`'s; its metrics
are summed on the device and the host reads them once per
``data.log_frequency`` steps and at the end of the epoch.  Validation is the
teacher-forced loss and accuracy over the validate loader, and BLEU and
Levenshtein of the teacher-forced argmax over its first
``evaluation.bleu_batches`` batches, each row cut at its target's length and
at END (:func:`_trim_batch_ids`).  After each epoch the plateau scheduler
and early stopping read the validation loss; a best checkpoint, one every
``training.save_checkpoint_epochs`` epochs and a final one are written when
a :class:`~img2latex_tpu_torch.utils.paths.PathManager` is given, and
:meth:`Trainer.load_checkpoint` resumes the step, the learning rate, the best
loss and the scheduler's and early stop's counters.

A loader is anything that yields batch dicts (``images`` uint8 NHWC,
``formulas`` int32, optionally ``n_valid``): a
:class:`~img2latex_tpu_torch.data.pipeline.BatchLoader` or a list of
in-memory batches.  Not ported yet: the device mesh, the device-resident
train split, the experiment registry, the enhanced metrics and profiling.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from img2latex_tpu_torch.config import Config
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.models.seq2seq import Seq2SeqModel, build_model
from img2latex_tpu_torch.ops.metrics import calculate_metrics
from img2latex_tpu_torch.training.optim import (
    EarlyStopping,
    PlateauScheduler,
    build_optimizer,
    set_learning_rate,
)
from img2latex_tpu_torch.training.steps import create_train_state, make_eval_step, make_train_step
from img2latex_tpu_torch.utils import checkpoint as ckpt_lib
from img2latex_tpu_torch.utils.device import resolve_device
from img2latex_tpu_torch.utils.paths import PathManager

logger = logging.getLogger(__name__)


def _trim_batch_ids(ids: np.ndarray, targets: np.ndarray, pad_id: int,
                    end_id: int) -> Tuple[List[List[int]], List[List[int]]]:
    """Per row: the target without PAD, cut at END, and the prediction cut to
    that length."""
    preds, tgts = [], []
    for p_row, t_row in zip(ids, targets):
        t_list = [int(t) for t in t_row if t != pad_id]
        if end_id in t_list:
            t_list = t_list[: t_list.index(end_id)]
        preds.append([int(x) for x in p_row[: len(t_list)]])
        tgts.append(t_list)
    return preds, tgts


class Trainer:
    def __init__(self, cfg: Config, tokenizer: LaTeXTokenizer, loaders: Dict[str, Iterable],
                 model: Optional[Seq2SeqModel] = None, paths: Optional[PathManager] = None,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.loaders = loaders
        if model is None:
            model = build_model(cfg, tokenizer.vocab_size, device=str(self.device), seed=cfg.training.seed)
        self.model = model.to(self.device)
        self.paths = paths
        self.experiment_name = cfg.training.experiment_name
        self.optimizer = build_optimizer(cfg, self.model)
        self.state = create_train_state(self.model, self.optimizer, cfg)
        self.train_step = make_train_step(cfg, tokenizer.pad_token_id)
        self.eval_step = make_eval_step(cfg, tokenizer.pad_token_id)
        tcfg = cfg.training
        self.scheduler = PlateauScheduler(tcfg.learning_rate, factor=tcfg.lr_plateau_factor,
                                          patience=tcfg.lr_plateau_patience)
        self.early_stopping = EarlyStopping(tcfg.early_stopping_patience)
        self.start_epoch = 0
        self.best_val_loss = float("inf")
        self.history: Dict[int, Dict[str, float]] = {}

    @property
    def ckpt_dir(self):
        if self.paths is not None:
            return self.paths.get_dir(self.experiment_name, "checkpoints")
        return None

    # ------------------------------------------------------------------
    def save_checkpoint(self, epoch: int, is_best: bool = False) -> None:
        if self.ckpt_dir is None:
            return
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "step": self.state.step, "generator": self.state.generator.get_state()}
        meta = {
            "epoch": epoch,
            "step": self.state.step,
            "best_val_loss": self.best_val_loss,
            "config": self.cfg.to_dict(),
            "tokenizer_config": self.tokenizer.to_config(),
            "metrics": self.history.get(epoch, {}),
            # without these a resume would restart the plateau LR at the config
            # value and reset the early-stop patience
            "scheduler": self.scheduler.state_dict(),
            "early_stopping": self.early_stopping.state_dict(),
        }
        ckpt_lib.save_checkpoint(self.ckpt_dir, state, meta, step=self.state.step, is_best=is_best)
        logger.info("Saved checkpoint at step %d (best=%s)", self.state.step, is_best)

    def load_checkpoint(self, path: str, step: Optional[int] = None) -> None:
        ckpt_dir, found_step = ckpt_lib.resolve_checkpoint_path(path)
        state, meta = ckpt_lib.restore_checkpoint(ckpt_dir, step if step is not None else found_step)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.state.step = int(state["step"])
        if "generator" in state:
            self.state.generator.set_state(state["generator"])
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        if "scheduler" in meta:
            self.scheduler.load_state_dict(meta["scheduler"])
        if "early_stopping" in meta:
            self.early_stopping.load_state_dict(meta["early_stopping"])
        set_learning_rate(self.optimizer, self.scheduler.lr)
        logger.info("Resumed from %s at step %d (epoch %d, lr %.3e)", path, self.state.step,
                    self.start_epoch, self.scheduler.lr)

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        step_ckpt_every = self.cfg.training.save_checkpoint_steps
        every = max(self.cfg.data.log_frequency, 1)
        loader = self.loaders["train"]
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        self.model.train()
        t0 = time.time()
        totals: Optional[Dict[str, torch.Tensor]] = None  # summed on the device
        n_batches = 0
        for batch in loader:
            metrics = self.train_step(self.state, batch)
            acc = {k: metrics[k] for k in ("loss", "correct", "total")}
            totals = acc if totals is None else {k: totals[k] + acc[k] for k in acc}
            n_batches += 1
            if n_batches % every == 0:
                snap = {k: v.item() for k, v in totals.items()}  # one read at the log cadence
                logger.info("epoch %d step %d loss %.4f acc %.4f", epoch + 1, self.state.step,
                            snap["loss"] / n_batches, snap["correct"] / max(snap["total"], 1))
            if step_ckpt_every and self.state.step % step_ckpt_every == 0:
                self.save_checkpoint(epoch)
        snap = {k: v.item() for k, v in totals.items()} if totals else {"loss": 0.0, "correct": 0, "total": 0}
        elapsed = time.time() - t0
        n_images = n_batches * self.cfg.data.batch_size
        return {
            "train_loss": snap["loss"] / max(n_batches, 1),
            "train_accuracy": snap["correct"] / max(snap["total"], 1),
            "train_time_s": elapsed,
            "train_images_per_sec": n_images / elapsed if elapsed > 0 else 0.0,
            "steps": n_batches,
        }

    def validate(self, epoch: int) -> Dict[str, float]:
        loader = self.loaders.get("validate")
        if loader is None:
            return {}
        self.model.eval()
        totals: Optional[Dict[str, torch.Tensor]] = None
        bleu_outs = []
        ecfg = self.cfg.evaluation
        for i, batch in enumerate(loader):
            out = self.eval_step(self.state, batch)
            acc = {"loss_tokens": out["loss"] * out["total"], "correct": out["correct"],
                   "total": out["total"]}
            totals = acc if totals is None else {k: totals[k] + acc[k] for k in acc}
            if i < ecfg.bleu_batches:
                n_valid = int(batch.get("n_valid", np.shape(batch["images"])[0]))
                bleu_outs.append((out["pred_ids"], batch["formulas"], n_valid))
        snap = {k: v.item() for k, v in totals.items()} if totals else {"loss_tokens": 0.0, "correct": 0, "total": 0}
        tok = self.tokenizer
        bleu_preds: List[List[int]] = []
        bleu_tgts: List[List[int]] = []
        for pred_dev, formulas, n_valid in bleu_outs:
            targets = np.asarray(torch.as_tensor(formulas).cpu())[:n_valid, 1:]
            p, t = _trim_batch_ids(pred_dev[:n_valid].cpu().numpy(), targets, tok.pad_token_id,
                                   tok.end_token_id)
            bleu_preds.extend(p)
            bleu_tgts.extend(t)
        total_tokens = max(int(snap["total"]), 1)
        quality = (calculate_metrics(bleu_preds, bleu_tgts, ecfg.bleu_n) if bleu_preds
                   else {"bleu": 0.0, "levenshtein": 0.0})
        return {
            "val_loss": float(snap["loss_tokens"]) / total_tokens,
            "val_accuracy": int(snap["correct"]) / total_tokens,
            "val_bleu": quality["bleu"],
            "val_levenshtein": quality["levenshtein"],
        }

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        tcfg = self.cfg.training
        stopped_early = False
        epoch = self.start_epoch - 1
        for epoch in range(self.start_epoch, tcfg.epochs):
            train_metrics = self.train_epoch(epoch)
            val_metrics = self.validate(epoch)
            self.history[epoch] = {**train_metrics, **val_metrics, "learning_rate": self.scheduler.lr}
            logger.info("epoch %d/%d: train_loss %.4f val_loss %.4f val_acc %.4f bleu %.4f lr %.2e",
                        epoch + 1, tcfg.epochs, train_metrics["train_loss"],
                        val_metrics.get("val_loss", 0.0), val_metrics.get("val_accuracy", 0.0),
                        val_metrics.get("val_bleu", 0.0), self.scheduler.lr)
            val_loss = val_metrics.get("val_loss", train_metrics["train_loss"])
            if self.scheduler.step(val_loss):
                set_learning_rate(self.optimizer, self.scheduler.lr)
                logger.info("Plateau: reduced learning rate to %.3e", self.scheduler.lr)
            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self.save_checkpoint(epoch, is_best=True)
            elif tcfg.save_checkpoint_epochs and (epoch + 1) % tcfg.save_checkpoint_epochs == 0:
                self.save_checkpoint(epoch)
            if self.early_stopping.step(val_loss):
                logger.info("Early stopping at epoch %d", epoch + 1)
                stopped_early = True
                break
        self.save_checkpoint(max(epoch, 0))  # the last state, for resume and predict
        return {
            "epochs_run": (epoch + 1) - self.start_epoch,
            "best_val_loss": self.best_val_loss,
            "stopped_early": stopped_early,
            "history": self.history,
        }
