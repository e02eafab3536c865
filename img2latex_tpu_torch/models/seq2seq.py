"""Seq2Seq model: CNN or ResNet encoder + LSTM decoder, built from a Config.

Counterpart of ``img2latex_tpu/models/seq2seq.py``: ``model.name``
``cnn_lstm`` or ``resnet_lstm``.  ``forward`` is the teacher-forced pass
(inputs ``targets[:, :-1]``, logits over the shifted sequence; ``train=True``
turns dropout on, and the ResNet's BatchNorm onto the batch's statistics,
updating its running buffers); ``encode`` and ``decode_step`` serve the
decode loops, and ``encode_features`` / ``encode_from_features`` split the
encode at the feature map for aspect-ratio bucketing.  :func:`build_model` returns the model in eval mode:
training passes ``train=True`` explicitly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from img2latex_tpu_torch.config import Config
from img2latex_tpu_torch.models.decoder import LSTMDecoder
from img2latex_tpu_torch.models.encoder import CNNEncoder, ResNetEncoder
from img2latex_tpu_torch.models.lstm import Carry
from img2latex_tpu_torch.models.resnet import BatchNorm
from img2latex_tpu_torch.utils.device import resolve_device, torch_dtype


class Seq2SeqModel(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: LSTMDecoder):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def encode(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """images (B, H, W, C) float NHWC -> memory (B, 1, E) vector or (B, W', E)
        grid; ``train`` reaches the ResNet's BatchNorm (the CNN has none)."""
        out = self.encoder(images, train=train)
        return out[:, None, :] if out.dim() == 2 else out

    def encode_features(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C) float NHWC -> the map before the head, (B, C, H',
        W') NCHW: the CNN's conv stack or the ResNet backbone through layer4
        in eval mode (the JAX ``encode_features``, which gives it NHWC)."""
        return self.encoder.features(images, train=False)

    def encode_from_features(self, features: torch.Tensor) -> torch.Tensor:
        """The head on a map of :meth:`encode_features` -> memory (B, 1, E)
        vector or (B, W', E) grid (the JAX ``encode_from_features``)."""
        out = self.encoder.project(features)
        return out[:, None, :] if out.dim() == 2 else out

    def forward(self, images: torch.Tensor, target_sequences: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits (B, T-1, V) for inputs ``target_sequences[:, :-1]``;
        ``train`` applies dropout, drawn from ``generator``."""
        return self.decoder(self.encode(images, train=train), target_sequences[:, :-1], train=train,
                            generator=generator)

    def decode_step(self, memory: torch.Tensor, token: torch.Tensor, carry: Carry,
                    mem_proj: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Carry]:
        return self.decoder.decode_step(memory, token, carry, mem_proj=mem_proj)

    def memory_proj(self, memory: torch.Tensor) -> Optional[torch.Tensor]:
        """The attention's step-invariant memory projection (B, S, A), or None
        where the decoder does not attend."""
        return self.decoder.memory_proj(memory)

    def init_carry(self, batch_size: int, device=None) -> Carry:
        return self.decoder.init_carry(batch_size, device)


def init_weights(model: Seq2SeqModel, seed: int = 0) -> None:
    """Fill every parameter from ``numpy.random.default_rng(seed)`` with the
    flax initializers' distributions: LeCun normal for conv and dense
    kernels (the attention's ``attn`` and ``v`` too), zero biases,
    normal(0, 1/sqrt(V)) embeddings, and U(-1/sqrt(H), 1/sqrt(H)) for the
    LSTM.  The ResNet's BatchNorm scales are drawn as 1 + 0.1 N(0, 1) and
    its biases as 0.1 N(0, 1), not left at flax's 1 and 0, so that a test
    of them has power; the running buffers keep flax's 0 and 1."""
    rng = np.random.default_rng(seed)
    hidden = model.decoder.hidden_dim
    norms = {f"{m}.{p}" for m, mod in model.named_modules() if isinstance(mod, BatchNorm)
             for p in ("weight", "bias")}
    with torch.no_grad():
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            if name in norms:
                arr = rng.standard_normal(size=shape) * 0.1 + (1.0 if name.endswith("weight") else 0.0)
            elif ".lstm." in name:
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
    """The CNN-LSTM or ResNet-LSTM of ``cfg`` (``model.name``) on ``device``
    (the card unless ``"cpu"`` is named), computing in
    ``cfg.hardware.compute_dtype``, a CNN encoder on the channel-first chain
    with ``cfg.hardware.pallas_chain``, with weights from
    ``numpy.random.default_rng(seed)`` (:func:`init_weights`)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.hardware.compute_dtype)
    if cfg.model.name == "resnet_lstm":
        res = cfg.model.encoder.resnet
        encoder: nn.Module = ResNetEncoder(
            model_name=res.model_name,
            img_height=res.img_height,
            img_width=res.img_width,
            channels=res.channels,
            embedding_dim=cfg.model.embedding_dim,
            output=cfg.model.memory,
            dtype=dtype,
        )
    else:
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
            pallas_chain=bool(cfg.hardware.pallas_chain),
        )
    decoder = LSTMDecoder(
        vocab_size=vocab_size,
        embedding_dim=cfg.model.embedding_dim,
        hidden_dim=cfg.model.decoder.hidden_dim,
        lstm_layers=cfg.model.decoder.lstm_layers,
        # vector memory never attends, and flax creates no attention leaves for it
        use_attention=cfg.model.decoder.attention and cfg.model.memory == "grid",
        dropout=cfg.model.decoder.dropout,
        dtype=dtype,
    )
    model = Seq2SeqModel(encoder, decoder)
    init_weights(model, seed)
    return model.to(dev).eval()
