"""Versioned file-based experiment registry (counterpart of ``img2latex_tpu/utils/registry.py``).

The same file, keys and statuses as the JAX package, so that a registry
written by either package is read by the other: a JSON registry at
``outputs/registry/experiment_registry.json`` holding, per experiment,
``{creation_time, status, tags, description, config_path, metrics: {steps:
{"<step>": {...}}}}`` (and ``last_updated`` once a status changes);
auto-versioning ``name -> name_vN``; per-step metrics written to the
registry and to the experiment's ``metrics/metrics.json``; list, filter,
compare and delete.  Messages go to plain ``logging``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np

from img2latex_tpu_torch.utils.paths import PathManager, path_manager

logger = logging.getLogger(__name__)

STATUSES = ("initialized", "training", "completed", "failed")


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, datetime):
        return obj.isoformat()
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item"):  # torch scalars
        try:
            return _jsonable(obj.item())
        except Exception:
            return str(obj)
    return obj


def _new_entry(status: str, description: str = "", tags: Optional[List[str]] = None,
               config_path: Optional[str] = None) -> Dict[str, Any]:
    return {
        "creation_time": datetime.now().isoformat(),
        "status": status,
        "tags": tags or [],
        "description": description,
        "config_path": config_path,
        "metrics": {"steps": {}},
    }


def _write_json(path, data: Dict[str, Any]) -> None:
    """Atomic replace: a kill mid-write leaves the old file whole."""
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(data, indent=2))
    os.replace(tmp, path)


class ExperimentRegistry:
    def __init__(self, paths: Optional[PathManager] = None):
        self.paths = paths or path_manager()

    def _load(self) -> Dict[str, Any]:
        f = self.paths.registry_file()
        if f.exists():
            try:
                return json.loads(f.read_text())
            except json.JSONDecodeError:
                logger.warning("Corrupt registry file %s; starting fresh", f)
        return {}

    def _save(self, data: Dict[str, Any]) -> None:
        _write_json(self.paths.registry_file(), _jsonable(data))

    def register_experiment(self, name: str, description: str = "", tags: Optional[List[str]] = None,
                            config_path: Optional[str] = None, auto_version: bool = True) -> str:
        """Register (auto-versioned unless ``auto_version`` is off) and return the final name."""
        data = self._load()
        final = name
        if auto_version and name in data:
            version = 1
            while f"{name}_v{version}" in data:
                version += 1
            final = f"{name}_v{version}"
        data[final] = _new_entry("initialized", description, tags, config_path)
        self._save(data)
        logger.info("Registered experiment %s", final)
        return final

    def update_status(self, name: str, status: str) -> None:
        if status not in STATUSES:
            raise ValueError(f"Invalid status {status!r}; valid: {STATUSES}")
        data = self._load()
        if name not in data:
            logger.warning("update_status: unknown experiment %s", name)
            return
        data[name]["status"] = status
        data[name]["last_updated"] = datetime.now().isoformat()
        self._save(data)

    def log_metrics(self, name: str, step: int, metrics: Dict[str, Any]) -> None:
        """Write one step's metrics to the registry and to the experiment's
        ``metrics/metrics.json``; an unknown experiment is registered first,
        as ``training``."""
        data = self._load()
        if name not in data:
            logger.warning("log_metrics: unknown experiment %s; registering", name)
            data[name] = _new_entry("training")
        entry = _jsonable({"step": step, **metrics})
        data[name]["metrics"]["steps"][str(step)] = entry
        self._save(data)

        mfile = self.paths.get_dir(name, "metrics") / "metrics.json"
        per_exp: Dict[str, Any] = {}
        if mfile.exists():
            try:
                per_exp = json.loads(mfile.read_text())
            except json.JSONDecodeError:
                logger.warning("Corrupt %s; starting a fresh step history", mfile)
                per_exp = {}
        per_exp.setdefault("steps", {})[str(step)] = entry
        _write_json(mfile, per_exp)

    def get(self, name: str) -> Optional[Dict[str, Any]]:
        return self._load().get(name)

    def list_experiments(self, status: Optional[str] = None, tag: Optional[str] = None,
                         sort_by: str = "creation_time") -> List[Dict[str, Any]]:
        rows = [{"name": k, **v} for k, v in self._load().items()]
        if status:
            rows = [r for r in rows if r.get("status") == status]
        if tag:
            rows = [r for r in rows if tag in r.get("tags", [])]
        return sorted(rows, key=lambda r: str(r.get(sort_by, "")), reverse=True)

    def delete_experiment(self, name: str, delete_files: bool = False) -> bool:
        data = self._load()
        if name not in data:
            return False
        del data[name]
        self._save(data)
        if delete_files:
            exp_dir = self.paths.experiment_dir(name)
            if exp_dir.exists():
                shutil.rmtree(exp_dir)
        return True

    def compare_experiments(self, names: Optional[List[str]] = None, metric: str = "val_loss",
                            minimize: bool = True) -> List[Dict[str, Any]]:
        """One row per experiment with its best step by ``metric``: the JAX
        package's DataFrame columns, as a list of dicts (pandas is not needed)."""
        data = self._load()
        rows = []
        for name in names or list(data):
            exp = data.get(name)
            if not exp:
                continue
            steps = exp.get("metrics", {}).get("steps", {})
            best_val, best_step = None, None
            for step_key, m in steps.items():
                v = m.get(metric)
                if v is None:
                    continue
                if best_val is None or (v < best_val if minimize else v > best_val):
                    best_val, best_step = v, step_key
            rows.append({"experiment": name, "status": exp.get("status"), "num_steps": len(steps),
                         f"best_{metric}": best_val, "best_step": best_step})
        return rows


_default: Optional[ExperimentRegistry] = None


def experiment_registry() -> ExperimentRegistry:
    global _default
    if _default is None:
        _default = ExperimentRegistry()
    return _default
