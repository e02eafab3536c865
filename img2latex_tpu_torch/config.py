"""Typed configuration tree for the PyTorch port.

A copy of the schema of ``img2latex_tpu/config.py`` cut to the sections the
port reads: data, model (encoder, decoder), inference, preprocessing and the
compute-type settings of ``hardware``.  Keys this schema does not know are
ignored by :func:`config_from_dict` (``strict=False``), so a config dict
written by the JAX package loads unchanged.

YAML is read only by :func:`load_config`, which imports ``yaml`` inside the
function: nothing on the inference path needs it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class DataConfig:
    max_seq_length: int = 141


@dataclass
class CNNEncoderConfig:
    img_height: int = 64
    img_width: int = 800
    channels: int = 1
    conv_filters: List[int] = field(default_factory=lambda: [32, 64, 128])
    kernel_size: int = 3
    pool_size: int = 2


@dataclass
class EncoderConfig:
    cnn: CNNEncoderConfig = field(default_factory=CNNEncoderConfig)


@dataclass
class DecoderConfig:
    hidden_dim: int = 512
    lstm_layers: int = 2


@dataclass
class ModelConfig:
    name: str = "cnn_lstm"  # the only model ported; "resnet_lstm" comes later
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    embedding_dim: int = 512
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    memory: str = "vector"  # "vector" | "grid" (only vector is ported)


@dataclass
class InferenceConfig:
    beam_size: int = 0
    max_length: int = 141
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    early_exit: bool = False


@dataclass
class PreprocessingConfig:
    pad_value: int = 255
    normalization_mean: List[float] = field(default_factory=lambda: [0.485, 0.456, 0.406])
    normalization_std: List[float] = field(default_factory=lambda: [0.229, 0.224, 0.225])


@dataclass
class HardwareConfig:
    """``compute_dtype`` is the activation type (bf16 on the card); the
    parameters stay float32 and are cast at use, as the JAX package does."""

    compute_dtype: str = "bfloat16"


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    hardware: HardwareConfig = field(default_factory=HardwareConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        """(height, width, channels) of the canvas (NHWC)."""
        enc = self.model.encoder.cnn
        return (enc.img_height, enc.img_width, enc.channels)


def _coerce(value: Any, target_type: Any) -> Any:
    if value is None:
        return value
    if getattr(target_type, "__origin__", None) is tuple:
        return tuple(value)
    if target_type is float and isinstance(value, int):
        return float(value)
    return value


def _update_dataclass(obj: Any, data: Dict[str, Any], path: str = "") -> List[str]:
    """Recursively update ``obj`` in place from ``data``; returns unknown keys."""
    unknown: List[str] = []
    fields = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in (data or {}).items():
        if key not in fields:
            unknown.append(f"{path}{key}")
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            unknown.extend(_update_dataclass(current, value, path=f"{path}{key}."))
        else:
            setattr(obj, key, _coerce(value, fields[key].type))
    return unknown


def config_from_dict(data: Optional[Dict[str, Any]], strict: bool = False) -> Config:
    """Build a :class:`Config` from a (possibly partial) nested dict."""
    cfg = Config()
    unknown = _update_dataclass(cfg, data or {})
    if strict and unknown:
        raise ValueError(f"Unknown config keys: {unknown}")
    validate_config(cfg)
    return cfg


def load_config(path: str | Path | None = None, overrides: Dict[str, Any] | None = None) -> Config:
    """Load a YAML config (or the defaults) and apply dotted-path overrides."""
    data: Dict[str, Any] = {}
    if path is not None:
        try:
            import yaml
        except ImportError as e:  # pragma: no cover - depends on the installation
            raise ImportError(
                "load_config(path) reads YAML and needs the pyyaml package; "
                "build the Config with config_from_dict instead"
            ) from e
        with open(path) as f:
            data = yaml.safe_load(f) or {}
    cfg = config_from_dict(data)
    for dotted, value in (overrides or {}).items():
        if value is not None:
            set_by_path(cfg, dotted, value)
    validate_config(cfg)
    return cfg


def set_by_path(cfg: Config, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    obj: Any = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    fields = {f.name: f for f in dataclasses.fields(obj)}
    if parts[-1] not in fields:
        raise AttributeError(f"No config field {dotted!r}")
    setattr(obj, parts[-1], _coerce(value, fields[parts[-1]].type))


def validate_config(cfg: Config) -> None:
    if cfg.model.name != "cnn_lstm":
        raise ValueError(f"model.name must be cnn_lstm (the only model ported), got {cfg.model.name!r}")
    if cfg.model.memory not in ("vector", "grid"):
        raise ValueError(f"model.memory must be vector or grid, got {cfg.model.memory!r}")
    if cfg.data.max_seq_length < 3:
        raise ValueError("data.max_seq_length must be >= 3 (START + token + END)")
    if cfg.inference.beam_size < 0:
        raise ValueError("inference.beam_size must be >= 0")
    if cfg.hardware.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"hardware.compute_dtype must be float32 or bfloat16, got {cfg.hardware.compute_dtype!r}"
        )
