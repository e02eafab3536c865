"""Pretrained torchvision ResNet weights: key mapping, conversion, loading
(counterpart of ``img2latex_tpu/models/pretrained.py``).

The converted file is the JAX package's: an ``.npz`` of flat flax paths
(``conv1/kernel`` HWIO, ``bn1/scale``, ``layer1_0/conv1/kernel``,
``layer1_0/downsample_bn/mean``, ...), written by
``scripts/convert_torchvision_resnet.py`` or ``scripts/extract_backbone.py``
of the JAX package, so one file serves both packages.
:func:`map_torch_key`, :func:`convert_state_dict` and :func:`unflatten` are
copies of the JAX functions (numpy only); :func:`load_converted_resnet` loads
such a file into the port's :class:`~img2latex_tpu_torch.models.resnet.ResNetBackbone`,
checking every path and shape, and naming the offending one as the JAX loader
does.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from img2latex_tpu_torch.models.resnet import BatchNorm

# torch key -> (flax path, kind); kind in {conv, scale, bias, mean, var}
_BN_PARTS = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
# flax leaf -> the port's parameter or buffer of the same module, by the module's kind
_PORT_LEAF = {"conv": {"kernel": "weight"},
              "norm": {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}}


def map_torch_key(key: str) -> Tuple[str, str] | None:
    """Map one torchvision state-dict key to (flax_path, kind); None = skip."""
    if key.endswith("num_batches_tracked") or key.startswith("fc."):
        return None
    if key == "conv1.weight":
        return "conv1/kernel", "conv"
    m = re.match(r"bn1\.(\w+)$", key)
    if m and m.group(1) in _BN_PARTS:
        return f"bn1/{_BN_PARTS[m.group(1)]}", _BN_PARTS[m.group(1)]
    m = re.match(r"layer(\d)\.(\d+)\.conv(\d)\.weight$", key)
    if m:
        s, b, n = m.groups()
        return f"layer{s}_{b}/conv{n}/kernel", "conv"
    m = re.match(r"layer(\d)\.(\d+)\.bn(\d)\.(\w+)$", key)
    if m and m.group(4) in _BN_PARTS:
        s, b, n, part = m.groups()
        return f"layer{s}_{b}/bn{n}/{_BN_PARTS[part]}", _BN_PARTS[part]
    m = re.match(r"layer(\d)\.(\d+)\.downsample\.0\.weight$", key)
    if m:
        s, b = m.groups()
        return f"layer{s}_{b}/downsample_conv/kernel", "conv"
    m = re.match(r"layer(\d)\.(\d+)\.downsample\.1\.(\w+)$", key)
    if m and m.group(3) in _BN_PARTS:
        s, b, part = m.groups()
        return f"layer{s}_{b}/downsample_bn/{_BN_PARTS[part]}", _BN_PARTS[part]
    return None


def convert_state_dict(state_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """torch state dict -> flat {path: array} with flax layouts."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        mapped = map_torch_key(key)
        if mapped is None:
            continue
        path, kind = mapped
        arr = np.asarray(value.detach().cpu().numpy() if hasattr(value, "detach") else value)
        if kind == "conv":
            arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW -> HWIO
        out[path] = arr.astype(np.float32)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """Split into (params, batch_stats) nested trees for the backbone."""
    params: Dict = {}
    stats: Dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        leaf = parts[-1]
        target = stats if leaf in ("mean", "var") else params
        node = target
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return params, stats


def load_converted_resnet(backbone: torch.nn.Module, npz_path: str,
                          scope: str = "encoder/backbone") -> torch.nn.Module:
    """Copy a converted ``.npz`` into ``backbone`` (a ``ResNetBackbone``) in
    place and return it.  A path with no module, parameter or buffer raises
    ``KeyError``, a shape that differs ``ValueError``; both name the path
    under ``scope`` with the model's shape in the flax layout, as the JAX
    loader does.  Paths the file lacks keep their values."""
    flat = dict(np.load(npz_path))
    modules = dict(backbone.named_modules())
    with torch.no_grad():
        for path in sorted(flat):
            arr = flat[path]
            parts = path.split("/")
            for i in range(1, len(parts)):  # the first module the model lacks, as the JAX merge names it
                if ".".join(parts[:i]) not in modules:
                    raise KeyError(f"{scope}/{'/'.join(parts[: i])} not in model tree")
            *mod_parts, leaf = parts
            mod = modules[".".join(mod_parts)]
            kind = "conv" if isinstance(mod, torch.nn.Conv2d) else "norm" if isinstance(mod, BatchNorm) else ""
            target = getattr(mod, _PORT_LEAF.get(kind, {}).get(leaf, ""), None)
            if not isinstance(target, torch.Tensor):
                raise KeyError(f"{scope}/{path} not in model tree")
            model_shape = tuple(target.permute(2, 3, 1, 0).shape) if leaf == "kernel" else tuple(target.shape)
            if model_shape != tuple(arr.shape):
                raise ValueError(f"shape mismatch at {scope}/{path}: "
                                 f"model {model_shape} vs checkpoint {tuple(arr.shape)}")
            value = torch.from_numpy(np.asarray(arr, np.float32))
            if leaf == "kernel":
                value = value.permute(3, 2, 0, 1)  # HWIO -> OIHW
            target.copy_(value.to(target.dtype))
    return backbone
