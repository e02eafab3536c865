"""Profiling and the NaN check (counterpart of ``img2latex_tpu/utils/profiling.py``).

* :func:`maybe_trace` runs ``torch.profiler`` (CPU activity, and CUDA where
  a card is present) and writes a Chrome trace under
  ``<log_dir>/traces/<name>/``, where the JAX package writes its
  ``jax.profiler`` trace (``hardware.profile``; the trainer traces its
  first epoch).
* :class:`StepTimer` times steps on the host's clock after synchronizing the
  card, so that a step's time includes its device work.
* :func:`apply_numerics_flags` turns the NaN check on or off
  (``hardware.debug_nans``, the JAX package's ``jax_debug_nans``): with it
  on, :func:`check_finite` raises ``FloatingPointError`` at the first
  non-finite value it is given; the train step gives it the loss and the
  gradient norm (non-finite where any gradient is).  With it off the train
  step never calls it, so the default step reads nothing back to the host.

The JAX package's ``enable_compilation_cache`` and ``apply_rng_impl`` have
no meaning here (no XLA programs are compiled; the dropout draws come from a
``torch.Generator``): the config keys that feed them
(``hardware.compilation_cache_dir``, ``hardware.rng_impl``) are read and not
acted on.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch

logger = logging.getLogger(__name__)

_debug_nans = False


@contextlib.contextmanager
def maybe_trace(enabled: bool, log_dir: str, name: str = "train") -> Iterator[None]:
    """A ``torch.profiler`` trace written to ``<log_dir>/traces/<name>/trace.json``
    (Chrome trace format); nothing when not ``enabled``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    trace_dir = os.path.join(log_dir, "traces", name)
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logger.info("Profiler trace -> %s", trace_dir)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    logger.info("Profiler trace complete: %s", trace_dir)


def apply_numerics_flags(debug_nans: bool) -> None:
    """Turn the NaN check of the train step on (``debug_nans``) or off."""
    global _debug_nans
    _debug_nans = bool(debug_nans)
    if _debug_nans:
        logger.info("debug_nans enabled: the train step raises at a non-finite loss or gradient")


def debug_nans_enabled() -> bool:
    return _debug_nans


def check_finite(**values: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` naming the first of ``values`` that holds
    a non-finite element (a read back to the host)."""
    for name, value in values.items():
        if not bool(torch.isfinite(value).all()):
            raise FloatingPointError(f"debug_nans: non-finite {name} ({value.detach().float().cpu()})")


class StepTimer:
    """Per-step wall-clock aggregator: a ``with`` block is one step, its
    clock read after the card (where there is one) has finished its work."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        dev = torch.device(device) if device is not None else None
        self._sync = torch.cuda.is_available() and (dev is None or dev.type == "cuda")
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.total = 0.0
        self._t0: Optional[float] = None

    def _now(self) -> float:
        if self._sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    def __enter__(self) -> "StepTimer":
        self._t0 = self._now()
        return self

    def __exit__(self, *exc) -> None:
        self.total += self._now() - self._t0
        self.count += 1

    @property
    def mean_ms(self) -> float:
        return (self.total / self.count * 1e3) if self.count else 0.0
