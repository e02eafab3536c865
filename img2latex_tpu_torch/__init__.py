"""img2latex_tpu_torch: the PyTorch/CUDA port of img2latex_tpu for an NVIDIA H100.

The port imports torch and numpy, and nothing of the JAX package.  Its
kernels are CUDA C++ under ``csrc/``, built with ``nvcc`` at first use.
Heavy modules are re-exported lazily.
"""

__version__ = "0.1.0"

__all__ = [
    "Config",
    "config_from_dict",
    "load_config",
    "LaTeXTokenizer",
    "Seq2SeqModel",
    "build_model",
    "Predictor",
    "DecodeConfig",
]

_LAZY = {
    "Config": "img2latex_tpu_torch.config",
    "config_from_dict": "img2latex_tpu_torch.config",
    "load_config": "img2latex_tpu_torch.config",
    "LaTeXTokenizer": "img2latex_tpu_torch.data.tokenizer",
    "Seq2SeqModel": "img2latex_tpu_torch.models.seq2seq",
    "build_model": "img2latex_tpu_torch.models.seq2seq",
    "Predictor": "img2latex_tpu_torch.training.predictor",
    "DecodeConfig": "img2latex_tpu_torch.decoding.decode",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'img2latex_tpu_torch' has no attribute {name!r}")
