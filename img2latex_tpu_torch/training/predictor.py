"""Batched greedy inference (counterpart of ``img2latex_tpu/training/predictor.py::Predictor``).

The path: images -> uint8 (H, W, C) canvases on the host -> fixed-size
batches (the short last batch padded with zero canvases and cropped after)
-> on-device normalize -> CNN encoder (block 0 through the conv1-pool
kernel) -> whole greedy decode (the decode kernels) -> token ids -> LaTeX.

Only greedy decoding with vector memory is ported; asking for beam search
or sampling raises ``NotImplementedError``.  ``from_checkpoint`` is not
ported yet (the JAX package's checkpoints are Orbax directories); load
weights with :func:`img2latex_tpu_torch.bridge.load_flax_params` or
``model.load_state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from img2latex_tpu_torch.config import Config
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.data.transforms import prepare_image_u8
from img2latex_tpu_torch.decoding.decode import DecodeConfig, trim_host
from img2latex_tpu_torch.models.seq2seq import Seq2SeqModel
from img2latex_tpu_torch.ops.decode_step import greedy_decode, pack_decoder_weights
from img2latex_tpu_torch.ops.preprocess import normalize_images
from img2latex_tpu_torch.utils.device import resolve_device, torch_dtype


class Predictor:
    def __init__(self, cfg: Config, model: Seq2SeqModel, tokenizer: LaTeXTokenizer,
                 batch_size: int = 16, device: Optional[str] = None):
        """``device``: the card unless ``"cpu"`` is named; the model is moved there."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.batch_size = int(batch_size)
        self.dtype = torch_dtype(cfg.hardware.compute_dtype)
        self._packed: Optional[Dict[str, Any]] = None

    def packed_decoder(self) -> Dict[str, Any]:
        """The decode kernels' weights, packed once per Predictor."""
        if self._packed is None:
            self._packed = pack_decoder_weights(self.model.decoder, self.dtype)
        return self._packed

    def _check_greedy(self) -> None:
        icfg = self.cfg.inference
        sampling = icfg.temperature > 0 and (icfg.top_k > 0 or icfg.top_p > 0.0)
        if icfg.beam_size > 0 or sampling or icfg.early_exit:
            raise NotImplementedError(
                "only plain greedy decoding is ported (beam_size=0, top_k=0, top_p=0, early_exit=False)"
            )

    @torch.no_grad()
    def decode_canvases(self, canvases_u8: np.ndarray, max_length: Optional[int] = None) -> np.ndarray:
        """uint8 (B, H, W, C) canvases -> token ids (B, max_length) int32 on the host."""
        tok = self.tokenizer
        dcfg = DecodeConfig(
            max_length=max_length if max_length is not None else self.cfg.inference.max_length,
            start_id=tok.start_token_id, end_id=tok.end_token_id, pad_id=tok.pad_token_id,
        )
        icfg = self.cfg.preprocessing
        x = torch.from_numpy(np.ascontiguousarray(canvases_u8)).to(self.device)
        x = normalize_images(x, icfg.normalization_mean, icfg.normalization_std, self.dtype)
        memory = self.model.encode(x)
        tokens = greedy_decode(self.packed_decoder(), memory[:, 0, :], dcfg.max_length,
                               dcfg.start_id, dcfg.end_id, dcfg.pad_id)
        return tokens.cpu().numpy()

    def predict_batch(self, images: Sequence[Any], max_length: Optional[int] = None,
                      batch_size: Optional[int] = None, return_ids: bool = False) -> List[Any]:
        """Greedy-decode ``images`` (paths or arrays) in fixed batches of
        ``batch_size``; returns LaTeX strings, or id lists with ``return_ids``."""
        self._check_greedy()
        B = int(batch_size or self.batch_size)
        h, w, c = self.cfg.image_shape
        pad = self.cfg.preprocessing.pad_value
        tok = self.tokenizer
        results: List[Any] = []
        for i in range(0, len(images), B):
            chunk = images[i : i + B]
            buf = np.zeros((B, h, w, c), dtype=np.uint8)
            for j, img in enumerate(chunk):
                buf[j] = prepare_image_u8(img, h, w, c, pad)
            tokens = self.decode_canvases(buf, max_length)[: len(chunk)]
            ids = trim_host(tokens, tok.end_token_id, tok.pad_token_id, start_id=tok.start_token_id)
            results.extend(ids if return_ids else (tok.decode(r) for r in ids))
        return results

    def predict(self, image: Any, **kwargs) -> Any:
        return self.predict_batch([image], **kwargs)[0]
