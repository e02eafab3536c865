"""Weight bridge: a flax parameter tree of the JAX package -> this port's state_dict.

The tree comes as nested dicts of numpy arrays (``{"params": {...}}`` or the
inner dict); fetching it from JAX devices is the caller's business, so this
module imports no JAX.  The mapping:

* conv kernels HWIO -> OIHW;
* dense kernels (in, out) -> (out, in);
* LSTM ``W_ih_l{i}`` / ``W_hh_l{i}`` (in, 4H) -> ``weight_ih_l{i}`` /
  ``weight_hh_l{i}`` (4H, in), biases as they are;
* the vector head's rows from the JAX flatten order (h, w, c) of NHWC to
  this port's (c, h, w) of NCHW.

Every leaf must be used and every parameter of the module set; either
failure raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flat(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def params_from_flax(tree: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """Map ``tree`` onto ``model`` (a :class:`~img2latex_tpu_torch.models.seq2seq.Seq2SeqModel`).

    Returns a float32 state_dict on the CPU with exactly the model's keys and
    shapes; raises ``KeyError`` for a leaf left unused or a parameter left
    unset, ``ValueError`` for a shape that does not fit."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    leaves = _flat(tree)
    used = set()

    def take(path: str) -> np.ndarray:
        if path not in leaves:
            raise KeyError(f"flax tree lacks {path!r}")
        used.add(path)
        return np.asarray(leaves[path], np.float32)

    sd: Dict[str, np.ndarray] = {}
    enc = model.encoder
    for i in range(len(enc.convs)):
        sd[f"encoder.convs.{i}.weight"] = take(f"encoder/Conv_{i}/kernel").transpose(3, 2, 0, 1)
        sd[f"encoder.convs.{i}.bias"] = take(f"encoder/Conv_{i}/bias")
    C, Hf, Wf = enc.feature_shape
    kern = take("encoder/Dense_0/kernel")  # (Hf*Wf*C, E), rows in (h, w, c) order
    if kern.shape[0] != C * Hf * Wf:
        raise ValueError(f"head kernel has {kern.shape[0]} rows, the encoder flattens {C * Hf * Wf}")
    kern = kern.reshape(Hf, Wf, C, -1).transpose(2, 0, 1, 3).reshape(C * Hf * Wf, -1)
    sd["encoder.head.weight"] = kern.T
    sd["encoder.head.bias"] = take("encoder/Dense_0/bias")

    cell = "decoder/cell"
    sd["decoder.cell.embedding.weight"] = take(f"{cell}/embedding/embedding")
    for i in range(model.decoder.lstm_layers):
        sd[f"decoder.cell.lstm.weight_ih_l{i}"] = take(f"{cell}/lstm/W_ih_l{i}").T
        sd[f"decoder.cell.lstm.weight_hh_l{i}"] = take(f"{cell}/lstm/W_hh_l{i}").T
        sd[f"decoder.cell.lstm.bias_ih_l{i}"] = take(f"{cell}/lstm/b_ih_l{i}")
        sd[f"decoder.cell.lstm.bias_hh_l{i}"] = take(f"{cell}/lstm/b_hh_l{i}")
    sd["decoder.cell.out.weight"] = take(f"{cell}/out/kernel").T
    sd["decoder.cell.out.bias"] = take(f"{cell}/out/bias")

    unused = sorted(set(leaves) - used)
    if unused:
        raise KeyError(f"flax leaves left unused: {unused}")
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(expected) - set(sd))
    if missing:
        raise KeyError(f"module parameters left unset: {missing}")
    for k, v in sd.items():
        if k not in expected:
            raise KeyError(f"no module parameter named {k!r}")
        if tuple(v.shape) != expected[k]:
            raise ValueError(f"{k}: flax gives {tuple(v.shape)}, the module has {expected[k]}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def load_flax_params(model, tree: Mapping[str, Any]):
    """Load ``tree`` into ``model`` in place (strict) and return the model."""
    model.load_state_dict(params_from_flax(tree, model), strict=True)
    return model
