"""Batched greedy and beam inference (counterpart of ``img2latex_tpu/training/predictor.py::Predictor``).

The path: images -> uint8 (H, W, C) canvases on the host -> fixed-size
batches (the short last batch padded with zero canvases and cropped after)
-> on-device normalize -> CNN encoder (block 0 through the conv1-pool
kernel) -> whole greedy decode -> token ids -> LaTeX.  The decode is the
vector one (the LSTM and vocab kernels) on ``memory[:, 0, :]``, or, for grid
memory with attention, the grid one: the attention's memory projection once
per batch, then the attention kernel feeding the same two kernels each
step.  With attention off the context is ``memory[:, 0, :]`` whatever the
memory kind, as in the JAX package, so that takes the vector decode.
``inference.early_exit`` stops a batch's decode once every row has ended.

With ``beam_size`` K > 0 the batch is beam-decoded instead (the vector or
grid beam decode of the same kernels plus the beam-step kernel), and the
best beam's tokens are kept (by ``score / length^length_penalty`` when the
penalty is above 0).  With ``0 < selective_beam_frac < 1`` the batch is
decoded greedily with per-row scores of ``selective_signal``, and only the
``ceil(frac * batch)`` rows of least mean score are beam-decoded and their
tokens put in place of the greedy ones; the zero canvases that pad a short
last batch compete for those rows, as in the JAX package.  With sampling
on (``top_k`` or ``top_p`` above 0 at a positive temperature) and no beam,
the batch is drawn by the vector or grid sampling decode (the same kernels
with the vocab-sample kernel in place of the argmax) from the kernel seed
of the batch (:func:`batch_seed`); with beam on, the sampling settings are
ignored, as the JAX package's beam ignores them.  :meth:`Predictor.from_checkpoint`
rebuilds config, tokenizer and model from a checkpoint of the port's trainer
(:mod:`img2latex_tpu_torch.utils.checkpoint`), or from a JAX package's
checkpoint converted by
:func:`img2latex_tpu_torch.utils.checkpoint.convert_flax_checkpoint`; its
``use_pallas_chain`` puts the encoder on the channel-first chain
(``hardware.pallas_chain``).  :meth:`Predictor.predict` decodes one image at
batch 1, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from img2latex_tpu_torch.config import Config, config_from_dict, set_by_path, validate_config
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.data.transforms import prepare_image_u8
from img2latex_tpu_torch.decoding.decode import DecodeConfig, select_uncertain, trim_host
from img2latex_tpu_torch.models.seq2seq import Seq2SeqModel, build_model
from img2latex_tpu_torch.ops.beam_decode import beam_decode
from img2latex_tpu_torch.ops.decode_step import greedy_decode, pack_decoder_weights, sample_decode
from img2latex_tpu_torch.ops.grid_decode import (
    grid_beam_decode,
    grid_greedy_decode,
    grid_memory_proj,
    grid_sample_decode,
    pack_attention_weights,
)
from img2latex_tpu_torch.ops.preprocess import normalize_images
from img2latex_tpu_torch.utils import checkpoint as ckpt_lib
from img2latex_tpu_torch.utils.device import resolve_device, torch_dtype


def batch_seed(seed: int, index: int) -> int:
    """The int32 kernel seed of the ``index``-th batch of a ``predict_batch``
    call with ``seed``: the first 32 bits of numpy's ``SeedSequence([seed,
    index])`` as a signed int.  (The JAX package takes ``jax.random.bits`` of
    the index-th split of ``PRNGKey(seed)``, which cannot be had without JAX:
    the two draw different streams from the same seed.)"""
    bits = np.random.SeedSequence([seed, index]).generate_state(1, dtype=np.uint32)[0]
    return int(bits.astype(np.int32))


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
        self._packed_att: Optional[Dict[str, Any]] = None

    @classmethod
    def from_checkpoint(cls, path: str, step: Optional[int] = None, batch_size: int = 16,
                        device: Optional[str] = None,
                        config_overrides: Optional[Dict[str, Any]] = None,
                        use_pallas_chain: Optional[bool] = None) -> "Predictor":
        """Rebuild config, tokenizer, model and weights from one checkpoint
        directory of the port's format (the contract of the JAX package's
        ``Predictor.from_checkpoint``): ``path`` is a checkpoint directory (its
        ``best`` step, else the latest), a ``step_N`` directory, or a directory
        holding ``checkpoints/``.  ``use_pallas_chain`` sets
        ``hardware.pallas_chain`` when it is not None; then
        ``config_overrides``, which maps dotted config paths to values, is
        set on the checkpoint's config and wins, as in the JAX package."""
        ckpt_dir, found_step = ckpt_lib.resolve_checkpoint_path(path)
        if step is None:
            step = found_step if found_step is not None else -1
        state, meta = ckpt_lib.restore_checkpoint(ckpt_dir, step)
        if "config" not in meta or "tokenizer_config" not in meta:
            raise ValueError(f"Checkpoint at {path} lacks config/tokenizer sidecars")
        cfg = config_from_dict(meta["config"])
        if use_pallas_chain is not None:
            cfg.hardware.pallas_chain = bool(use_pallas_chain)
        for dotted, value in (config_overrides or {}).items():
            set_by_path(cfg, dotted, value)
        validate_config(cfg)
        tokenizer = LaTeXTokenizer.from_config(meta["tokenizer_config"])
        model = build_model(cfg, tokenizer.vocab_size, device=device)
        model.load_state_dict(state["model"])
        return cls(cfg, model, tokenizer, batch_size=batch_size, device=device)

    def packed_decoder(self) -> Dict[str, Any]:
        """The decode kernels' weights, packed once per Predictor."""
        if self._packed is None:
            self._packed = pack_decoder_weights(self.model.decoder, self.dtype)
        return self._packed

    def packed_attention(self) -> Dict[str, Any]:
        """The attention kernel's weights, packed once per Predictor."""
        if self._packed_att is None:
            self._packed_att = pack_attention_weights(self.model.decoder, self.dtype)
        return self._packed_att

    def decode_config(self, beam_size: Optional[int] = None, max_length: Optional[int] = None,
                      temperature: Optional[float] = None, top_k: Optional[int] = None,
                      top_p: Optional[float] = None, length_penalty: Optional[float] = None,
                      early_exit: Optional[bool] = None,
                      selective_beam_frac: Optional[float] = None) -> DecodeConfig:
        """The decode settings of ``cfg.inference`` with the given overrides."""
        icfg = self.cfg.inference

        def pick(value, default):
            return default if value is None else value

        beam = int(pick(beam_size, icfg.beam_size))
        tok = self.tokenizer
        frac = float(pick(selective_beam_frac, icfg.selective_beam_frac))
        dcfg = DecodeConfig(
            max_length=int(pick(max_length, icfg.max_length)),
            start_id=tok.start_token_id, end_id=tok.end_token_id, pad_id=tok.pad_token_id,
            temperature=float(pick(temperature, icfg.temperature)),
            top_k=int(pick(top_k, icfg.top_k)), top_p=float(pick(top_p, icfg.top_p)),
            beam_size=beam,
            length_penalty=float(pick(length_penalty, icfg.length_penalty)),
            selective_beam_frac=frac,
            early_exit=bool(pick(early_exit, icfg.early_exit)),
            selective_signal=icfg.selective_signal,
        )
        if dcfg.sampling:  # the JAX package's beam runs over every row when it would sample
            dcfg = dataclasses.replace(dcfg, selective_beam_frac=0.0)
        return dcfg

    @torch.no_grad()
    def decode_canvases(self, canvases_u8: np.ndarray, dcfg: Optional[DecodeConfig] = None,
                        seed: int = 0) -> np.ndarray:
        """uint8 (B, H, W, C) canvases -> token ids (B, dcfg.max_length) int32
        on the host, with ``dcfg`` (default :meth:`decode_config`); a
        sampling decode draws with the int32 kernel ``seed``."""
        if dcfg is None:
            dcfg = self.decode_config()
        sample = dict(top_k=dcfg.top_k, seed=int(seed),
                      temperature=dcfg.temperature, top_p=dcfg.top_p, early_exit=dcfg.early_exit)
        icfg = self.cfg.preprocessing
        x = torch.from_numpy(np.ascontiguousarray(canvases_u8)).to(self.device)
        x = normalize_images(x, icfg.normalization_mean, icfg.normalization_std, self.dtype)
        memory = self.model.encode(x)
        packed = self.packed_decoder()
        args = (dcfg.max_length, dcfg.start_id, dcfg.end_id, dcfg.pad_id)
        if self.model.decoder.cell.attends(memory):
            att = self.packed_attention()
            u = grid_memory_proj(att, memory)  # once per batch

            def greedy(**kw):
                return grid_greedy_decode(packed, att, memory, u, *args, early_exit=dcfg.early_exit, **kw)

            def draw():
                return grid_sample_decode(packed, att, memory, u, *args, **sample)

            def beam(idx=None):
                mem, uu = (memory, u) if idx is None else (memory[idx], u[idx])
                return grid_beam_decode(packed, att, mem, uu, dcfg.beam_size, dcfg)[0]
        else:
            ctx = memory[:, 0, :]

            def greedy(**kw):
                return greedy_decode(packed, ctx, *args, early_exit=dcfg.early_exit, **kw)

            def draw():
                return sample_decode(packed, ctx, *args, **sample)

            def beam(idx=None):
                return beam_decode(packed, ctx if idx is None else ctx[idx], dcfg.beam_size, dcfg)[0]

        frac = dcfg.selective_beam_frac
        if dcfg.beam_size == 0 and dcfg.sampling:
            tokens = draw()
        elif dcfg.beam_size == 0:
            tokens = greedy()
        elif 0.0 < frac < 1.0:
            # greedy over every row, beam over the least confident ones
            tokens, scores = greedy(return_scores=True, signal=dcfg.selective_signal)
            k = max(1, math.ceil(frac * tokens.shape[0]))
            idx = select_uncertain(tokens, scores, k, dcfg.pad_id)
            tokens[idx] = beam(idx)
        else:
            tokens = beam()
        return tokens.cpu().numpy()

    def predict_batch(self, images: Sequence[Any], beam_size: Optional[int] = None,
                      max_length: Optional[int] = None, temperature: Optional[float] = None,
                      top_k: Optional[int] = None, top_p: Optional[float] = None,
                      length_penalty: Optional[float] = None, early_exit: Optional[bool] = None,
                      batch_size: Optional[int] = None, seed: int = 0, return_ids: bool = False,
                      selective_beam_frac: Optional[float] = None) -> List[Any]:
        """Decode ``images`` (paths, PIL images or arrays) in fixed batches of
        ``batch_size``; returns LaTeX strings, or id lists with ``return_ids``.
        The decode settings are ``cfg.inference``'s, with the keyword
        overrides of the JAX package's ``predict_batch``; a sampling decode
        draws batch i with the kernel seed ``batch_seed(seed, i)``."""
        dcfg = self.decode_config(beam_size=beam_size, max_length=max_length,
                                  temperature=temperature, top_k=top_k, top_p=top_p,
                                  length_penalty=length_penalty, early_exit=early_exit,
                                  selective_beam_frac=selective_beam_frac)
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
            tokens = self.decode_canvases(buf, dcfg=dcfg, seed=batch_seed(seed, i // B))[: len(chunk)]
            ids = trim_host(tokens, tok.end_token_id, tok.pad_token_id, start_id=tok.start_token_id)
            results.extend(ids if return_ids else (tok.decode(r) for r in ids))
        return results

    def predict(self, image: Any, **kwargs) -> Any:
        """One image, decoded at batch 1 (the JAX ``Predictor.predict``)."""
        return self.predict_batch([image], batch_size=1, **kwargs)[0]
