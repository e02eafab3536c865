"""Device choice for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU by
name.  Without a card and without ``device="cpu"`` it raises: the port never
carries on on the CPU by itself.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); otherwise the device named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def free_device_memory_bytes(fallback: Optional[int] = None,
                             device: Optional[Union[str, torch.device]] = None) -> Optional[int]:
    """Free memory of the card (``device``, default the current CUDA device)
    in bytes from ``torch.cuda.mem_get_info``, or ``fallback`` for a CPU
    device or where no card is available (the counterpart of
    ``img2latex_tpu/utils/device.py::free_device_memory_bytes``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return fallback
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free)


def device_cache_budget(knob_gb: Optional[float], device: Union[str, torch.device], share: float,
                        fallback_gib: float) -> int:
    """Bytes a device-resident split may take: ``knob_gb`` GiB where set
    (``data.device_cache_budget_gb``), else ``share`` of the card's free
    memory, else (a CPU device) ``fallback_gib`` GiB."""
    if knob_gb:
        return int(knob_gb * 1024**3)
    free = free_device_memory_bytes(device=device)
    return int(free * share) if free else int(fallback_gib * 1024**3)


def upload_rows(arrays: Sequence[np.ndarray], device: Union[str, torch.device]) -> torch.Tensor:
    """Host arrays stacked along their first axis and uploaded in one copy;
    on the card the call returns once the copy has ended."""
    host = arrays[0] if len(arrays) == 1 else np.concatenate(arrays, axis=0)
    big = torch.from_numpy(np.ascontiguousarray(host)).to(device)
    if big.device.type == "cuda":
        torch.cuda.synchronize(big.device)
    return big


def torch_dtype(name: str) -> torch.dtype:
    """'float32' | 'bfloat16' -> torch dtype."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return table[name]
