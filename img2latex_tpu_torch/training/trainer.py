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
in-memory batches.

Also, as in the JAX trainer:

* a ``resnet_lstm`` loads ``model.encoder.resnet.pretrained_path`` (a
  converted ``.npz``, :func:`~img2latex_tpu_torch.models.pretrained.load_converted_resnet`)
  into its backbone at construction, and ``freeze_backbone`` freezes the
  backbone outside layer4 (:mod:`~img2latex_tpu_torch.training.optim`);
* ``data.device_cache`` uploads the train and validate splits (the
  loaders' datasets) once as uint8, 1 channel with
  ``data.device_cache_grayscale`` where the model takes 3, and gathers each
  batch on the card: the train epoch in the host loader's order
  (``loader._order()``, so that the cache gives the same batches as the
  loader; ``n // B`` steps), the validate split padded to whole batches with
  each batch's ``n_valid``.  A split over the budget
  (``data.device_cache_budget_gb``, else a share of the card's free memory)
  is logged and left to the host loader;
* ``registry`` (an :class:`~img2latex_tpu_torch.utils.registry.ExperimentRegistry`)
  registers ``experiment_name`` and moves it ``initialized -> training ->
  completed``, with each epoch's metrics under its 1-based epoch; without a
  registry and with ``evaluation.save_basic_metrics`` the epochs go to the
  experiment's ``metrics/metrics.json``;
* every ``logging.detailed_eval_frequency`` epochs the validate BLEU rows,
  ``probs_max`` and ``pred_ids`` feed
  :func:`~img2latex_tpu_torch.ops.metrics.compute_all_metrics`, which writes
  the enhanced-metrics file;
* ``hardware.profile`` traces the first epoch with ``torch.profiler`` under
  ``logs/traces/train_epoch0/``, and ``hardware.debug_nans`` makes the train
  step raise at a non-finite loss or gradient
  (:mod:`~img2latex_tpu_torch.utils.profiling`).

Not ported yet: the device mesh (DDP over several cards).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from img2latex_tpu_torch.config import Config
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.models.pretrained import load_converted_resnet
from img2latex_tpu_torch.models.seq2seq import Seq2SeqModel, build_model
from img2latex_tpu_torch.ops.metrics import calculate_metrics, compute_all_metrics
from img2latex_tpu_torch.training.optim import (
    EarlyStopping,
    PlateauScheduler,
    build_optimizer,
    set_learning_rate,
)
from img2latex_tpu_torch.training.steps import create_train_state, make_eval_step, make_train_step
from img2latex_tpu_torch.utils import checkpoint as ckpt_lib
from img2latex_tpu_torch.utils.device import device_cache_budget, resolve_device, upload_rows
from img2latex_tpu_torch.utils.paths import PathManager
from img2latex_tpu_torch.utils.profiling import apply_numerics_flags, maybe_trace
from img2latex_tpu_torch.utils.registry import ExperimentRegistry

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
                 device: Optional[str] = None, registry: Optional[ExperimentRegistry] = None,
                 experiment_name: Optional[str] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.loaders = loaders
        if model is None:
            model = build_model(cfg, tokenizer.vocab_size, device=str(self.device), seed=cfg.training.seed)
        self.model = model.to(self.device)
        self.paths = paths
        self.registry = registry
        self.experiment_name = experiment_name or cfg.training.experiment_name
        pretrained = cfg.model.encoder.resnet.pretrained_path
        if cfg.model.name == "resnet_lstm" and pretrained:
            load_converted_resnet(self.model.encoder.backbone, pretrained)
            logger.info("Loaded pretrained backbone from %s", pretrained)
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
        self._device_cache: Any = None  # the train split on the card, False where it is not
        self._val_device_cache: Any = None
        if self.registry is not None and self.registry.get(self.experiment_name) is None:
            self.registry.register_experiment(self.experiment_name,
                                              description=f"{cfg.model.name} on {cfg.data.data_dir}",
                                              auto_version=False)

    @property
    def ckpt_dir(self):
        if self.paths is not None:
            return self.paths.get_dir(self.experiment_name, "checkpoints")
        return None

    def _metrics_dir(self) -> Optional[str]:
        if self.paths is not None:
            return str(self.paths.get_dir(self.experiment_name, "metrics"))
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
    def _use_device_cache(self) -> bool:
        return bool(self.cfg.data.device_cache)

    def _cache_budget(self, fallback_gib: float, share: float) -> int:
        return device_cache_budget(self.cfg.data.device_cache_budget_gb, self.device, share, fallback_gib)

    def _cache_store_channels(self, c: int) -> int:
        """Channels a device cache stores: 1 with ``data.device_cache_grayscale``
        where the model takes more (tiled back in the train and eval steps), else ``c``."""
        return 1 if self.cfg.data.device_cache_grayscale and c > 1 else c

    def _upload_split(self, split: str, rows: int, share: float, fallback_gib: float) -> Any:
        """The ``split`` loader's dataset on the card: uint8 images (rows, H, W,
        C stored) and int64 formulas (rows, L), rows past the dataset zero
        images and all-PAD formulas; False where the loader has no dataset or
        the split is over the budget."""
        ds = getattr(self.loaders[split], "dataset", None)
        if ds is None:
            logger.warning("data.device_cache: the %s loader has no dataset; using the loader", split)
            return False
        h, w, c = self.cfg.image_shape
        L = self.tokenizer.max_sequence_length
        budget = self._cache_budget(fallback_gib, share)
        forms = np.full((rows, L), self.tokenizer.pad_token_id, np.int32)

        def fill(c_s: int) -> Optional[np.ndarray]:
            arr = np.zeros((rows, h, w, c_s), np.uint8)
            for i in range(len(ds)):
                img = ds.image(i)
                if c_s != c and not np.array_equal(img, np.broadcast_to(img[..., :1], img.shape)):
                    logger.warning("device_cache_grayscale: %s image %d has unequal channels; "
                                   "storing the full %d-channel cache", split, i, c)
                    return None
                arr[i] = img[..., :c_s]
                forms[i] = ds.token_ids(i)
            return arr

        imgs = None
        for c_s in dict.fromkeys((self._cache_store_channels(c), c)):
            est = rows * (h * w * c_s + L * 4)
            if est > budget:
                logger.warning("device_cache: the %s split would use %.2f GiB (> %.2f GiB budget); "
                               "using the host loader", split, est / 1024**3, budget / 1024**3)
                return False
            imgs = fill(c_s)
            if imgs is not None:
                break
        logger.info("device_cache: %d %s samples (%.2f GiB, %d channel(s) stored) on %s", len(ds), split,
                    imgs.nbytes / 1024**3, imgs.shape[-1], self.device)
        return {"images": upload_rows([imgs], self.device),
                "formulas": torch.from_numpy(forms).to(self.device).long(),
                "formulas_host": forms, "n": len(ds)}

    def _get_device_cache(self) -> Any:
        """The train split on the card, uploaded once."""
        if self._device_cache is None:
            ds = getattr(self.loaders["train"], "dataset", None)
            self._device_cache = self._upload_split("train", len(ds) if ds is not None else 0,
                                                    share=0.6, fallback_gib=4.0)
        return self._device_cache

    def _get_val_device_cache(self) -> Any:
        """The validate split on the card, padded to whole eval batches."""
        if self._val_device_cache is None:
            loader = self.loaders.get("validate")
            ds = getattr(loader, "dataset", None)
            if ds is None:
                self._val_device_cache = False
            else:
                B = loader.batch_size
                self._val_device_cache = self._upload_split("validate", -(-len(ds) // B) * B,
                                                            share=0.3, fallback_gib=2.0)
                if self._val_device_cache:
                    self._val_device_cache["batch"] = B
        return self._val_device_cache

    def _epoch_steps(self, epoch: int) -> Iterator[Dict[str, Any]]:
        """One epoch's train batches: gathered on the card from the device
        cache in the loader's order, or the loader's own."""
        loader = self.loaders["train"]
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        cache = self._get_device_cache() if self._use_device_cache() else False
        if not cache:
            yield from loader
            return
        B = self.cfg.data.batch_size
        perm = torch.from_numpy(loader._order().astype(np.int64)).to(self.device)
        for i in range(cache["n"] // B):  # the host loader's drop_last
            idx = perm[i * B : (i + 1) * B]
            yield {"images": cache["images"].index_select(0, idx),
                   "formulas": cache["formulas"].index_select(0, idx)}

    def _val_batches(self) -> Iterator[Tuple[Dict[str, torch.Tensor], Any, int]]:
        """(eval step outputs, the batch's formulas on the host, n_valid) per
        validate batch: from the device cache or the loader."""
        vc = self._get_val_device_cache() if self._use_device_cache() else False
        if vc:
            B = vc["batch"]
            for i in range(vc["images"].shape[0] // B):
                sl = slice(i * B, (i + 1) * B)
                out = self.eval_step(self.state, {"images": vc["images"][sl], "formulas": vc["formulas"][sl]})
                yield out, vc["formulas_host"][sl], max(0, min(B, vc["n"] - i * B))
            return
        for batch in self.loaders["validate"]:
            n_valid = int(batch.get("n_valid", np.shape(batch["images"])[0]))
            yield self.eval_step(self.state, batch), batch["formulas"], n_valid

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        step_ckpt_every = self.cfg.training.save_checkpoint_steps
        every = max(self.cfg.data.log_frequency, 1)
        t0 = time.time()
        totals: Optional[Dict[str, torch.Tensor]] = None  # summed on the device
        n_batches = 0
        for batch in self._epoch_steps(epoch):
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
        if self.loaders.get("validate") is None:
            return {}
        totals: Optional[Dict[str, torch.Tensor]] = None
        bleu_outs = []
        ecfg = self.cfg.evaluation
        for i, (out, formulas, n_valid) in enumerate(self._val_batches()):
            acc = {"loss_tokens": out["loss"] * out["total"], "correct": out["correct"],
                   "total": out["total"]}
            totals = acc if totals is None else {k: totals[k] + acc[k] for k in acc}
            if i < ecfg.bleu_batches:
                bleu_outs.append((out["pred_ids"], out["probs_max"], formulas, n_valid))
        snap = {k: v.item() for k, v in totals.items()} if totals else {"loss_tokens": 0.0, "correct": 0, "total": 0}
        tok = self.tokenizer
        bleu_preds: List[List[int]] = []
        bleu_tgts: List[List[int]] = []
        sample = None  # the first batch's (probs_max, pred_ids, targets) for the enhanced metrics
        for pred_dev, probs_dev, formulas, n_valid in bleu_outs:
            targets = np.asarray(torch.as_tensor(formulas).cpu())[:n_valid, 1:]
            pred_ids = pred_dev[:n_valid].cpu().numpy()
            p, t = _trim_batch_ids(pred_ids, targets, tok.pad_token_id, tok.end_token_id)
            bleu_preds.extend(p)
            bleu_tgts.extend(t)
            if sample is None:
                sample = (probs_dev[:n_valid].cpu().numpy(), pred_ids, targets)
        total_tokens = max(int(snap["total"]), 1)
        quality = (calculate_metrics(bleu_preds, bleu_tgts, ecfg.bleu_n) if bleu_preds
                   else {"bleu": 0.0, "levenshtein": 0.0})
        if self.paths is not None and (epoch + 1) % max(self.cfg.logging.detailed_eval_frequency, 1) == 0 \
                and bleu_preds:
            compute_all_metrics(bleu_preds, bleu_tgts, tok, probs_max=sample[0], pred_ids=sample[1],
                                dense_targets=sample[2], num_samples=ecfg.enhanced_samples,
                                experiment_name=self.experiment_name, metrics_dir=self._metrics_dir(),
                                save_to_file=True, epoch=epoch + 1, bleu_n=ecfg.bleu_n)
        return {
            "val_loss": float(snap["loss_tokens"]) / total_tokens,
            "val_accuracy": int(snap["correct"]) / total_tokens,
            "val_bleu": quality["bleu"],
            "val_levenshtein": quality["levenshtein"],
        }

    def _write_basic_metrics(self, epoch: int, epoch_metrics: Dict[str, Any]) -> None:
        """metrics.json without a registry: the epoch's numbers under its 1-based key."""
        mfile = self.paths.get_dir(self.experiment_name, "metrics") / "metrics.json"
        data = {}
        if mfile.exists():
            try:
                data = json.loads(mfile.read_text())
            except json.JSONDecodeError:
                data = {}
        data.setdefault("steps", {})[str(epoch + 1)] = {
            "step": epoch + 1,
            **{k: float(v) for k, v in epoch_metrics.items() if isinstance(v, (int, float))},
        }
        mfile.write_text(json.dumps(data, indent=2))

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        tcfg = self.cfg.training
        apply_numerics_flags(self.cfg.hardware.debug_nans)
        profile = self.cfg.hardware.profile and self.paths is not None
        log_dir = str(self.paths.get_dir(self.experiment_name, "logs")) if profile else ""
        if self.registry is not None:
            self.registry.update_status(self.experiment_name, "training")
        stopped_early = False
        epoch = self.start_epoch - 1
        for epoch in range(self.start_epoch, tcfg.epochs):
            with maybe_trace(profile and epoch == self.start_epoch, log_dir, "train_epoch0"):
                train_metrics = self.train_epoch(epoch)
            val_metrics = self.validate(epoch)
            epoch_metrics = {**train_metrics, **val_metrics, "learning_rate": self.scheduler.lr}
            self.history[epoch] = epoch_metrics
            logger.info("epoch %d/%d: train_loss %.4f val_loss %.4f val_acc %.4f bleu %.4f lr %.2e",
                        epoch + 1, tcfg.epochs, train_metrics["train_loss"],
                        val_metrics.get("val_loss", 0.0), val_metrics.get("val_accuracy", 0.0),
                        val_metrics.get("val_bleu", 0.0), self.scheduler.lr)
            if self.registry is not None:
                self.registry.log_metrics(self.experiment_name, epoch + 1, epoch_metrics)
            elif self.paths is not None and self.cfg.evaluation.save_basic_metrics:
                self._write_basic_metrics(epoch, epoch_metrics)
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
        if self.registry is not None:
            self.registry.update_status(self.experiment_name, "completed")
        return {
            "epochs_run": (epoch + 1) - self.start_epoch,
            "best_val_loss": self.best_val_loss,
            "stopped_early": stopped_early,
            "history": self.history,
        }
