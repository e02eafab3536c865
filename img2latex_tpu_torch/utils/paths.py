"""PathManager: the experiment directory tree (counterpart of ``img2latex_tpu/utils/paths.py``).

``<project>/outputs/<experiment>/{checkpoints,logs,metrics,plots,reports,predictions}``,
each created on access.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

SUBDIRS = ("checkpoints", "logs", "metrics", "plots", "reports", "predictions")


def find_project_root(start: Optional[str] = None) -> Path:
    """Walk up from ``start`` (default the working directory) to a directory
    holding ``.git``, ``pyproject.toml`` or the package; else ``start``."""
    p = Path(start or os.getcwd()).resolve()
    for candidate in [p, *p.parents]:
        for marker in (".git", "pyproject.toml", "img2latex_tpu_torch"):
            if (candidate / marker).exists():
                return candidate
    return p


class PathManager:
    """``project_root`` is taken as given; without it the root is found from
    the working directory (:func:`find_project_root`)."""

    def __init__(self, project_root: Optional[str] = None, outputs_dirname: str = "outputs"):
        self.project_root = Path(project_root).resolve() if project_root else find_project_root()
        self.outputs_dir = self.project_root / outputs_dirname

    def experiment_dir(self, experiment_name: str) -> Path:
        return self.outputs_dir / experiment_name

    def get_dir(self, experiment_name: str, kind: str) -> Path:
        """Kind in :data:`SUBDIRS`; created on access."""
        if kind not in SUBDIRS:
            raise ValueError(f"Unknown experiment subdir {kind!r}; valid: {SUBDIRS}")
        d = self.experiment_dir(experiment_name) / kind
        d.mkdir(parents=True, exist_ok=True)
        return d
