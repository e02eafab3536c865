"""Device choice for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU by
name.  Without a card and without ``device="cpu"`` it raises: the port never
carries on on the CPU by itself.
"""

from __future__ import annotations

from typing import Optional, Union

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


def torch_dtype(name: str) -> torch.dtype:
    """'float32' | 'bfloat16' -> torch dtype."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return table[name]
