"""Weight bridge: a flax parameter tree of the JAX package -> this port's state_dict.

The tree comes as nested dicts of numpy arrays (``{"params": {...}}`` or the
inner dict); fetching it from JAX devices is the caller's business, so this
module imports no JAX.  The mapping:

* conv kernels HWIO -> OIHW;
* dense kernels (in, out) -> (out, in);
* LSTM ``W_ih_l{i}`` / ``W_hh_l{i}`` (in, 4H) -> ``weight_ih_l{i}`` /
  ``weight_hh_l{i}`` (4H, in), biases as they are;
* the vector head's rows from the JAX flatten order (h, w, c) of NHWC to
  this port's (c, h, w) of NCHW; the grid head's rows are (h·C + c) in
  both, so it is only transposed;
* the attention's ``attn`` kernel (H+E, A), h rows first, and ``v`` (A, 1)
  transposed into ``attn.weight`` (A, H+E) and ``v.weight`` (1, A);
* the ResNet encoder: every ``encoder/backbone/<module path>`` conv kernel
  HWIO -> OIHW and BatchNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``,
  the ``batch_stats`` tree's ``mean`` / ``var`` -> the ``running_mean`` /
  ``running_var`` buffers (flax keeps the biased variance, and so does the
  port's BatchNorm), and the head ``encoder/Dense_0`` transposed: its vector
  rows are the pooled features, its grid rows (h·F + f) in both packages.

Every leaf must be used and every parameter and buffer of the module set;
either failure raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from img2latex_tpu_torch.models.encoder import ResNetEncoder
from img2latex_tpu_torch.models.resnet import BatchNorm


def _flat(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _cnn_head_rows(enc, kern: np.ndarray) -> np.ndarray:
    """The CNN's vector head rows from the JAX (h, w, c) flatten order to the
    port's (c, h, w); the grid head's rows as they are."""
    if enc.output != "vector":
        return kern
    C, Hf, Wf = enc.feature_shape
    if kern.shape[0] != C * Hf * Wf:  # (Hf*Wf*C, E)
        raise ValueError(f"head kernel has {kern.shape[0]} rows, the encoder flattens {C * Hf * Wf}")
    return kern.reshape(Hf, Wf, C, -1).transpose(2, 0, 1, 3).reshape(C * Hf * Wf, -1)


def params_from_flax(tree: Mapping[str, Any], model,
                     batch_stats: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """Map ``tree`` onto ``model`` (a :class:`~img2latex_tpu_torch.models.seq2seq.Seq2SeqModel`).

    ``tree`` is the params tree or a variables dict (``{"params": ...,
    "batch_stats": ...}``); ``batch_stats`` (the ResNet's running
    statistics) may also be given apart.  Returns a float32 state_dict on
    the CPU with exactly the model's keys and shapes; raises ``KeyError``
    for a leaf left unused or a parameter or buffer left unset,
    ``ValueError`` for a shape that does not fit."""
    if batch_stats is None and isinstance(tree.get("batch_stats"), Mapping):
        batch_stats = tree["batch_stats"]
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    if batch_stats is not None and "batch_stats" in batch_stats:
        batch_stats = batch_stats["batch_stats"]
    leaves = _flat(tree)
    leaves.update({f"batch_stats/{k}": v for k, v in _flat(batch_stats or {}).items()})
    used = set()

    def take(path: str) -> np.ndarray:
        if path not in leaves:
            raise KeyError(f"flax tree lacks {path!r}")
        used.add(path)
        return np.asarray(leaves[path], np.float32)

    sd: Dict[str, np.ndarray] = {}
    enc = model.encoder
    if isinstance(enc, ResNetEncoder):
        for name, mod in enc.backbone.named_modules():
            path = "encoder/backbone/" + name.replace(".", "/")
            key = "encoder.backbone." + name
            if isinstance(mod, torch.nn.Conv2d):
                sd[f"{key}.weight"] = take(f"{path}/kernel").transpose(3, 2, 0, 1)
            elif isinstance(mod, BatchNorm):
                sd[f"{key}.weight"] = take(f"{path}/scale")
                sd[f"{key}.bias"] = take(f"{path}/bias")
                sd[f"{key}.running_mean"] = take(f"batch_stats/{path}/mean")
                sd[f"{key}.running_var"] = take(f"batch_stats/{path}/var")
        kern = take("encoder/Dense_0/kernel")  # (F, E) vector, (H'*F, E) grid: the port's rows already
    else:
        for i in range(len(enc.convs)):
            sd[f"encoder.convs.{i}.weight"] = take(f"encoder/Conv_{i}/kernel").transpose(3, 2, 0, 1)
            sd[f"encoder.convs.{i}.bias"] = take(f"encoder/Conv_{i}/bias")
        kern = _cnn_head_rows(enc, take("encoder/Dense_0/kernel"))
    sd["encoder.head.weight"] = kern.T
    sd["encoder.head.bias"] = take("encoder/Dense_0/bias")

    cell = "decoder/cell"
    sd["decoder.cell.embedding.weight"] = take(f"{cell}/embedding/embedding")
    for i in range(model.decoder.lstm_layers):
        sd[f"decoder.cell.lstm.weight_ih_l{i}"] = take(f"{cell}/lstm/W_ih_l{i}").T
        sd[f"decoder.cell.lstm.weight_hh_l{i}"] = take(f"{cell}/lstm/W_hh_l{i}").T
        sd[f"decoder.cell.lstm.bias_ih_l{i}"] = take(f"{cell}/lstm/b_ih_l{i}")
        sd[f"decoder.cell.lstm.bias_hh_l{i}"] = take(f"{cell}/lstm/b_hh_l{i}")
    if model.decoder.cell.use_attention:
        sd["decoder.cell.attention.attn.weight"] = take(f"{cell}/attention/attn/kernel").T
        sd["decoder.cell.attention.attn.bias"] = take(f"{cell}/attention/attn/bias")
        sd["decoder.cell.attention.v.weight"] = take(f"{cell}/attention/v/kernel").T
    sd["decoder.cell.out.weight"] = take(f"{cell}/out/kernel").T
    sd["decoder.cell.out.bias"] = take(f"{cell}/out/bias")

    unused = sorted(set(leaves) - used)
    if unused:
        raise KeyError(f"flax leaves left unused: {unused}")
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(expected) - set(sd))
    if missing:
        raise KeyError(f"module parameters or buffers left unset: {missing}")
    for k, v in sd.items():
        if k not in expected:
            raise KeyError(f"no module parameter named {k!r}")
        if tuple(v.shape) != expected[k]:
            raise ValueError(f"{k}: flax gives {tuple(v.shape)}, the module has {expected[k]}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def load_flax_params(model, tree: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None):
    """Load ``tree`` (and ``batch_stats``) into ``model`` in place (strict) and return the model."""
    model.load_state_dict(params_from_flax(tree, model, batch_stats), strict=True)
    return model
