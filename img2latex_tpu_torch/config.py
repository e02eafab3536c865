"""Typed configuration tree for the PyTorch port.

A copy of the schema of ``img2latex_tpu/config.py`` cut to the sections the
port reads: data, model (the CNN and ResNet encoders, the decoder),
training, evaluation, inference, preprocessing, ``logging``'s enhanced-metrics
cadence and the compute-type, encoder-chain, profiling and NaN-check settings
of ``hardware``.  Keys this schema does not know are ignored by
:func:`config_from_dict` (``strict=False``), so a config dict written by the
JAX package loads unchanged.

YAML is read only by :func:`load_config`, which imports ``yaml`` inside the
function: nothing on the inference or training path needs it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class DataConfig:
    data_dir: str = "data"
    train_file: str = "im2latex_train_filter.lst"
    validate_file: str = "im2latex_validate_filter.lst"
    test_file: str = "im2latex_test_filter.lst"
    formulas_file: str = "im2latex_formulas.norm.lst"
    img_dir: str = "img"
    batch_size: int = 128
    num_workers: int = 0
    max_seq_length: int = 141
    log_frequency: int = 1000  # train steps between the host's reads of the metrics
    eval_batch_size_multiplier: int = 2
    max_eval_batch_size: int = 128
    load_in_memory: bool = False  # hold a split's canvases in host RAM (skipped over half the free RAM)
    # A memory-mapped .npy of a split's prepared uint8 canvases, keyed as the
    # JAX package keys it (data/pipeline.py::canvas_cache_path): built once
    # where Pillow is, then read anywhere with numpy alone.
    canvas_cache_dir: Optional[str] = None
    device_prefetch: int = 2  # batches the host loader prepares ahead
    # evaluate: upload the split once as uint8 to the card and decode from
    # device-side batch views; a split over the budget streams instead
    device_cache: bool = False
    device_cache_budget_gb: Optional[float] = None  # None: a share of the card's free memory
    # Store a device cache as 1 channel where the model takes 3 (ResNet) and
    # tile the gathered batch on the card: 3x less memory.  Exact for
    # grayscale sources; an image whose channels differ makes the cache
    # store every channel.
    device_cache_grayscale: bool = False


@dataclass
class CNNEncoderConfig:
    img_height: int = 64
    img_width: int = 800
    channels: int = 1
    conv_filters: List[int] = field(default_factory=lambda: [32, 64, 128])
    kernel_size: int = 3
    pool_size: int = 2


@dataclass
class ResNetEncoderConfig:
    img_height: int = 64
    img_width: int = 800
    channels: int = 3
    model_name: str = "resnet50"
    freeze_backbone: bool = False  # train only layer4 of the backbone, the head and the decoder
    pretrained_path: Optional[str] = None  # converted torchvision weights (.npz, flax names)


@dataclass
class EncoderConfig:
    cnn: CNNEncoderConfig = field(default_factory=CNNEncoderConfig)
    resnet: ResNetEncoderConfig = field(default_factory=ResNetEncoderConfig)


@dataclass
class DecoderConfig:
    hidden_dim: int = 512
    lstm_layers: int = 2
    dropout: float = 0.3  # training only: between LSTM layers, on embeddings and LSTM outputs
    attention: bool = True  # additive attention over grid memory (S > 1)


@dataclass
class ModelConfig:
    name: str = "cnn_lstm"  # "cnn_lstm" | "resnet_lstm"
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    embedding_dim: int = 512
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    memory: str = "vector"  # "vector" (one embedding) | "grid" (one slot per feature column)


@dataclass
class TrainingConfig:
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4  # L2 added into the gradient (torch Adam), not decoupled
    epochs: int = 30
    early_stopping_patience: int = 10
    clip_grad_norm: float = 5.0
    save_checkpoint_epochs: int = 5
    save_checkpoint_steps: Optional[int] = None
    experiment_name: str = "img2latex_v1"
    accumulation_steps: int = 1
    label_smoothing: float = 0.1
    lr_plateau_factor: float = 0.5
    lr_plateau_patience: int = 2
    seed: int = 42


@dataclass
class EvaluationConfig:
    bleu_n: int = 4
    bleu_batches: int = 10  # validation batches whose teacher-forced argmax feeds BLEU and Levenshtein
    enhanced_samples: int = 2  # rows dumped token by token into the enhanced-metrics file
    save_basic_metrics: bool = True  # metrics.json per epoch where no registry is given
    detailed_eval_frequency: int = 1


@dataclass
class InferenceConfig:
    beam_size: int = 0
    max_length: int = 141
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    length_penalty: float = 0.0  # beam: the best beam by score / length^length_penalty
    # Selective beam: with beam_size > 0 and 0 < frac < 1, decode greedily,
    # then beam-decode the ceil(frac * batch) rows that are least confident
    # by the mean of selective_signal; 0 (or >= 1) is beam over every row.
    selective_beam_frac: float = 0.0
    selective_signal: str = "margin"  # logp | margin | entropy | margin_logp[:alpha]
    early_exit: bool = False


@dataclass
class LoggingConfig:
    detailed_eval_frequency: int = 1  # epochs between the trainer's enhanced-metrics files


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
    # The channel-first encoder chain: blocks 2..n through the conv_cf
    # kernel (bias in float32, one rounding), as the JAX package's
    # hardware.pallas_chain; off by default there and here.
    pallas_chain: bool = False
    profile: bool = False  # a torch.profiler trace of the first epoch under logs/traces/
    debug_nans: bool = False  # raise at the first non-finite loss or gradient


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    hardware: HardwareConfig = field(default_factory=HardwareConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        """(height, width, channels) of the canvas (NHWC) of the model's encoder."""
        enc = self.model.encoder.resnet if self.model.name == "resnet_lstm" else self.model.encoder.cnn
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
    if cfg.model.name not in ("cnn_lstm", "resnet_lstm"):
        raise ValueError(f"model.name must be cnn_lstm or resnet_lstm, got {cfg.model.name!r}")
    if cfg.model.name == "resnet_lstm":
        valid = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")
        if cfg.model.encoder.resnet.model_name not in valid:
            raise ValueError(f"encoder.resnet.model_name must be one of {valid}, "
                             f"got {cfg.model.encoder.resnet.model_name!r}")
    if cfg.model.memory not in ("vector", "grid"):
        raise ValueError(f"model.memory must be vector or grid, got {cfg.model.memory!r}")
    if cfg.data.max_seq_length < 3:
        raise ValueError("data.max_seq_length must be >= 3 (START + token + END)")
    if cfg.training.accumulation_steps < 1:
        raise ValueError("training.accumulation_steps must be >= 1")
    if not 0.0 <= cfg.training.label_smoothing < 1.0:
        raise ValueError("training.label_smoothing must be in [0, 1)")
    if cfg.inference.beam_size < 0:
        raise ValueError("inference.beam_size must be >= 0")
    from img2latex_tpu_torch.decoding.decode import parse_signal

    try:
        parse_signal(cfg.inference.selective_signal)
    except ValueError:
        raise ValueError(
            "inference.selective_signal must be logp, margin, entropy or "
            f"margin_logp[:alpha], got {cfg.inference.selective_signal!r}"
        ) from None
    if cfg.hardware.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"hardware.compute_dtype must be float32 or bfloat16, got {cfg.hardware.compute_dtype!r}"
        )
