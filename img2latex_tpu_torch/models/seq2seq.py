"""Seq2Seq model: CNN encoder + LSTM decoder, built from a Config.

Counterpart of ``img2latex_tpu/models/seq2seq.py``.  ``forward`` is the
teacher-forced pass (inputs ``targets[:, :-1]``, logits over the shifted
sequence); ``encode`` and ``decode_step`` serve the decode loops.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from img2latex_tpu_torch.config import Config
from img2latex_tpu_torch.models.decoder import LSTMDecoder
from img2latex_tpu_torch.models.encoder import CNNEncoder
from img2latex_tpu_torch.models.lstm import Carry
from img2latex_tpu_torch.utils.device import resolve_device, torch_dtype


class Seq2SeqModel(nn.Module):
    def __init__(self, encoder: CNNEncoder, decoder: LSTMDecoder):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C) float NHWC -> memory (B, 1, E)."""
        return self.encoder(images)[:, None, :]

    def forward(self, images: torch.Tensor, target_sequences: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits (B, T-1, V) for inputs ``target_sequences[:, :-1]``."""
        return self.decoder(self.encode(images), target_sequences[:, :-1])

    def decode_step(self, memory: torch.Tensor, token: torch.Tensor,
                    carry: Carry) -> Tuple[torch.Tensor, Carry]:
        return self.decoder.decode_step(memory, token, carry)

    def init_carry(self, batch_size: int, device=None) -> Carry:
        return self.decoder.init_carry(batch_size, device)


def init_weights(model: Seq2SeqModel, seed: int = 0) -> None:
    """Fill every parameter from ``numpy.random.default_rng(seed)`` with the
    flax initializers' distributions: LeCun normal for conv and dense
    kernels, zero biases, normal(0, 1/sqrt(V)) embeddings, and
    U(-1/sqrt(H), 1/sqrt(H)) for the LSTM."""
    rng = np.random.default_rng(seed)
    hidden = model.decoder.hidden_dim
    with torch.no_grad():
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            if ".lstm." in name:
                s = 1.0 / math.sqrt(hidden)
                arr = rng.uniform(-s, s, size=shape)
            elif name.endswith("bias"):
                arr = np.zeros(shape)
            elif name.endswith("embedding.weight"):
                arr = rng.standard_normal(size=shape, dtype=np.float32) / math.sqrt(shape[0])
            else:  # conv (O, I, kh, kw) or dense (out, in): fan_in = prod(shape[1:])
                arr = rng.standard_normal(size=shape, dtype=np.float32) / math.sqrt(np.prod(shape[1:]))
            p.copy_(torch.from_numpy(np.asarray(arr, np.float32)))


def build_model(cfg: Config, vocab_size: int, device: Optional[str] = None,
                seed: int = 0) -> Seq2SeqModel:
    """The CNN-LSTM of ``cfg`` on ``device`` (the card unless ``"cpu"`` is
    named), computing in ``cfg.hardware.compute_dtype``, with weights from
    ``numpy.random.default_rng(seed)`` (:func:`init_weights`)."""
    if cfg.model.memory != "vector":
        raise NotImplementedError("model.memory='grid' is not ported yet; use 'vector'")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.hardware.compute_dtype)
    enc = cfg.model.encoder.cnn
    encoder = CNNEncoder(
        img_height=enc.img_height,
        img_width=enc.img_width,
        channels=enc.channels,
        conv_filters=tuple(enc.conv_filters),
        kernel_size=enc.kernel_size,
        pool_size=enc.pool_size,
        embedding_dim=cfg.model.embedding_dim,
        output=cfg.model.memory,
        dtype=dtype,
    )
    decoder = LSTMDecoder(
        vocab_size=vocab_size,
        embedding_dim=cfg.model.embedding_dim,
        hidden_dim=cfg.model.decoder.hidden_dim,
        lstm_layers=cfg.model.decoder.lstm_layers,
        dtype=dtype,
    )
    model = Seq2SeqModel(encoder, decoder)
    init_weights(model, seed)
    return model.to(dev).eval()
