"""Checkpoint save and restore: the port's own format (counterpart of
``img2latex_tpu/utils/checkpoint.py``, which writes Orbax directories).

``<ckpt_dir>/step_<N>/`` holds ``state.pt``, a ``torch.save`` of
``{"model": state_dict, "optimizer": state_dict, "step": N}`` (the model's
``state_dict`` carries a ResNet's BatchNorm running buffers), and
``meta.json`` with the JAX trainer's keys (``epoch``, ``step``,
``best_val_loss``, ``config``, ``tokenizer_config``, ``metrics``,
``scheduler``, ``early_stopping``), so a predictor rebuilds config,
tokenizer and model from one directory.  ``meta.json`` is written last: a
step directory without it is incomplete and never counts as the latest.  The
``best`` file names the best step.

:func:`convert_flax_checkpoint` writes a JAX package's checkpoint in this
format.  It imports no orbax: reading the Orbax arrays is the caller's, where
JAX is installed::

    import jax
    from img2latex_tpu.utils.checkpoint import restore_checkpoint
    state, meta = restore_checkpoint("runs/x/checkpoints", step=None)
    state = jax.device_get(state)
    convert_flax_checkpoint(state["params"], meta, "runs/x_torch/checkpoints",
                            step=int(meta["step"]), batch_stats=state.get("batch_stats"))
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

_STATE_FILE = "state.pt"
_META_FILE = "meta.json"
_BEST_FILE = "best"


def save_checkpoint(ckpt_dir: str | Path, state: Dict[str, Any], meta: Dict[str, Any], step: int,
                    is_best: bool = False) -> Path:
    """Write ``state`` (tensors) and ``meta`` (JSON) under ``step_<step>/``."""
    step_dir = Path(ckpt_dir).absolute() / f"step_{step}"
    step_dir.mkdir(parents=True, exist_ok=True)
    tmp = step_dir / (_STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, step_dir / _STATE_FILE)
    (step_dir / _META_FILE).write_text(json.dumps(meta, indent=2))
    if is_best:
        (step_dir.parent / _BEST_FILE).write_text(str(step))
    return step_dir


def _list_steps(ckpt_dir: Path) -> list:
    if not ckpt_dir.exists():
        return []
    return [int(p.name[5:]) for p in ckpt_dir.iterdir()
            if p.is_dir() and p.name.startswith("step_") and p.name[5:].isdigit()
            and (p / _STATE_FILE).exists() and (p / _META_FILE).exists()]


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = _list_steps(Path(ckpt_dir))
    return max(steps) if steps else None


def best_step(ckpt_dir: str | Path) -> Optional[int]:
    f = Path(ckpt_dir) / _BEST_FILE
    if f.exists():
        try:
            return int(f.read_text().strip())
        except ValueError:
            return None
    return None


def restore_checkpoint(ckpt_dir: str | Path,
                       step: Optional[int] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(state, meta)`` of ``step``, tensors on the CPU: None picks the
    latest, -1 the ``best`` pointer (else the latest)."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if step is None:
        step = latest_step(ckpt_dir)
    elif step == -1:
        best = best_step(ckpt_dir)  # step 0 is a valid best
        step = best if best is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"No checkpoints under {ckpt_dir}")
    step_dir = ckpt_dir / f"step_{step}"
    if not (step_dir / _STATE_FILE).exists():
        raise FileNotFoundError(f"Checkpoint not found: {step_dir}")
    state = torch.load(step_dir / _STATE_FILE, map_location="cpu", weights_only=True)
    meta_file = step_dir / _META_FILE
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    return state, meta


def resolve_checkpoint_path(path: str | Path) -> Tuple[Path, Optional[int]]:
    """A checkpoint dir, a ``step_N`` dir, or a dir holding ``checkpoints/``
    -> (ckpt_dir, step or None)."""
    p = Path(path).absolute()
    if p.name.startswith("step_") and p.name[5:].isdigit():
        return p.parent, int(p.name[5:])
    if (p / "checkpoints").is_dir():
        return p / "checkpoints", None
    return p, None


def convert_flax_checkpoint(params: Mapping[str, Any], meta: Dict[str, Any], ckpt_dir: str | Path,
                            step: int, batch_stats: Optional[Mapping[str, Any]] = None) -> Path:
    """Write a JAX package's checkpoint as the port's ``step_<step>/``.

    ``params`` is the flax parameter tree as nested dicts of numpy arrays
    (``state["params"]`` of the JAX ``restore_checkpoint``, after
    ``jax.device_get``), ``meta`` the JAX ``meta.json`` dict (``config``,
    ``tokenizer_config``, ``step``, ...).  The tree is mapped by
    :func:`img2latex_tpu_torch.bridge.load_flax_params` onto
    ``build_model(config, vocab, device="cpu")``, which checks every leaf
    and every parameter; ``meta`` is kept as it is, with ``step`` set.  The
    step holds the model only: Optax's optimizer state is not converted, so
    the step serves :meth:`~img2latex_tpu_torch.training.predictor.Predictor.from_checkpoint`
    and not a trainer's resume.  ``batch_stats`` (a ``resnet_lstm``'s
    BatchNorm running statistics, ``state["batch_stats"]``) go into the
    running buffers; the bridge raises where a ResNet lacks them, and a
    ``cnn_lstm`` given some raises ``NotImplementedError`` (no CNN of either
    package has BatchNorm)."""
    from img2latex_tpu_torch.bridge import load_flax_params
    from img2latex_tpu_torch.config import config_from_dict
    from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
    from img2latex_tpu_torch.models.seq2seq import build_model

    if "config" not in meta or "tokenizer_config" not in meta:
        raise ValueError("meta lacks the config/tokenizer_config sidecars")
    cfg = config_from_dict(meta["config"])
    if batch_stats and cfg.model.name != "resnet_lstm":
        raise NotImplementedError(f"batch_stats given for a {cfg.model.name}: only the ResNet encoder has BatchNorm")
    vocab = LaTeXTokenizer.from_config(meta["tokenizer_config"]).vocab_size
    model = load_flax_params(build_model(cfg, vocab, device="cpu"), params, batch_stats or None)
    out_meta = json.loads(json.dumps(meta))  # a copy, and a check that it is JSON
    out_meta["step"] = int(step)
    return save_checkpoint(ckpt_dir, {"model": model.state_dict(), "step": int(step)}, out_meta, int(step))
