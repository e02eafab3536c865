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

``predict_batch`` pipelines the host against the card as the JAX
``Predictor`` does (``_decode_chunks``, ``_prep_pool``, ``_prep_chunk``):
it runs its chunks through :func:`img2latex_tpu_torch.decoding.decode.decode_chunks`,
which dispatches chunk i (:meth:`Predictor.decode_canvases` with
``fetch=False``: the upload and every launch enqueued, the tokens left on
the card), then preps chunk i + 1 (in a thread pool where Pillow reads an
image of it) and only then fetches chunk i.  On the card a
chunk's canvases are prepped straight into one of two pinned host buffers
and uploaded with ``non_blocking=True``, so that the upload does not stall
the host.  ``stats`` takes the JAX package's accounting (``prep_s``,
``dispatch_s``, ``fetch_s``, ``first_calls``, ``steady_images``, ``post_s``).
The dispatch still waits for the card where a decode reads a flag back:
early exit reads whether every row has ended once every 8 steps
(``ops/decode_step.py:597``, ``ops/beam_decode.py:231``), so there the
overlap is partial.  The selective-beam split reads nothing back: its k
rows are counted on the host from ``frac * batch`` and chosen on the card.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from img2latex_tpu_torch.config import (
    Config,
    InferenceConfig,
    config_from_dict,
    set_by_path,
    validate_config,
)
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.data.transforms import assign_bucket, prepare_image_at_width, prepare_image_u8
from img2latex_tpu_torch.decoding.decode import DecodeConfig, decode_chunks, select_uncertain, trim_host
from img2latex_tpu_torch.models.resnet import receptive_field
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
from img2latex_tpu_torch.utils.device import resolve_device, torch_dtype, upload_rows


STAGING_SLOTS = 2  # pinned host buffers: a chunk being prepped while the one before uploads


def batch_seed(seed: int, index: int) -> int:
    """The int32 kernel seed of the ``index``-th batch of a ``predict_batch``
    call with ``seed``: the first 32 bits of numpy's ``SeedSequence([seed,
    index])`` as a signed int.  (The JAX package takes ``jax.random.bits`` of
    the index-th split of ``PRNGKey(seed)``, which cannot be had without JAX:
    the two draw different streams from the same seed.)"""
    bits = np.random.SeedSequence([seed, index]).generate_state(1, dtype=np.uint32)[0]
    return int(bits.astype(np.int32))


def bucket_stride(cfg: Config) -> int:
    """Input pixels a column of the encoder's feature map: the CNN's pooling,
    or 32 for every ResNet (conv1, the max pool and layers 2-4 halve the
    width)."""
    if cfg.model.name == "resnet_lstm":
        return 32
    ccfg = cfg.model.encoder.cnn
    return int(ccfg.pool_size) ** len(ccfg.conv_filters)


def bucket_margin_px(cfg: Config) -> int:
    """The white margin a bucket's canvas has right of its width, and that an
    image's content must leave inside it, so that the feature columns kept
    from the bucket's canvas never see its edge: 4 columns for the CNN (its
    blocks' reach), half the ResNet's receptive field rounded up to the
    stride for the ResNet (224 px for ResNet-50).  A bucket whose canvas
    would not be narrower than the full one is never chosen
    (:func:`~img2latex_tpu_torch.data.transforms.assign_bucket`)."""
    stride = bucket_stride(cfg)
    if cfg.model.name == "resnet_lstm":
        half = (receptive_field(cfg.model.encoder.resnet.model_name) - 1) // 2
        return -(-half // stride) * stride
    return 4 * stride


def run_passes(dispatch: Callable[[], Any], fetch: Callable[[Any], Any], post: Callable[[Any], Any], first: Any,
               passes: int, stats: Dict[str, Any], n_images: int) -> Any:
    """The later passes of a split held on the card, in the JAX order: pass
    N + 1 is dispatched, then pass N (``first`` for N = 1, already fetched)
    is posted on the host while the card decodes, then pass N + 1 is
    fetched.  ``stats`` gains ``dispatch_s``, ``post_s``, ``fetch_s`` and
    ``steady_images`` of those passes, and ``post_s`` also the last pass's
    post, whose result is returned."""
    fetched = first
    for _ in range(max(passes, 1) - 1):
        t0 = time.perf_counter()
        fut = dispatch()
        t1 = time.perf_counter()
        post(fetched)  # rides under the card's decode of this pass
        t2 = time.perf_counter()
        fetched = fetch(fut)
        t3 = time.perf_counter()
        stats["dispatch_s"] = stats.get("dispatch_s", 0.0) + (t1 - t0)
        stats["post_s"] = stats.get("post_s", 0.0) + (t2 - t1)
        stats["fetch_s"] = stats.get("fetch_s", 0.0) + (t3 - t2)
        stats["steady_images"] = stats.get("steady_images", 0) + n_images
    t0 = time.perf_counter()
    out = post(fetched)
    stats["post_s"] = stats.get("post_s", 0.0) + (time.perf_counter() - t0)
    return out


def _needs_pillow(image: Any, h: int, w: Optional[int]) -> bool:
    """Whether ``image``'s canvas is made through Pillow: a path, a PIL image,
    or an array (HW, HWC or CHW) off the (h, w) canvas; with ``w`` None (a
    bucket's canvas, ``prepare_image_at_width``) an array off the height h."""
    if isinstance(image, str) or hasattr(image, "getbands"):
        return True
    shape = np.shape(image)
    if w is None:
        return shape[0] != h and not (len(shape) == 3 and shape[1] == h)
    return shape[:2] != (h, w) and not (len(shape) == 3 and shape[1:] == (h, w))


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
        self._pool: Optional[ThreadPoolExecutor] = None
        # on the card: STAGING_SLOTS flat pinned host buffers, each with the
        # event recorded after its last upload; a batch of any canvas width
        # up to the full one is a view of one of them
        self._staged: List[Tuple[torch.Tensor, Optional[torch.cuda.Event]]] = []
        self._slot = 0
        self._white: Dict[int, torch.Tensor] = {}  # the white canvas's feature map by batch size

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
                      selective_beam_frac: Optional[float] = None,
                      inference: Optional[InferenceConfig] = None) -> DecodeConfig:
        """The decode settings of ``inference`` (default ``cfg.inference``)
        with the given overrides."""
        icfg = self.cfg.inference if inference is None else inference

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

    def staging_buffer(self, shape: Tuple[int, ...]) -> np.ndarray:
        """A host uint8 array of ``shape`` to prep canvases into.  On the card
        it is a view of the first bytes of the next of ``STAGING_SLOTS`` flat
        pinned buffers, handed out once that buffer's last upload has ended,
        and :meth:`dispatch_canvases` uploads it without a further copy; on
        the CPU it is a new array of zeros.  The buffers hold at least a
        batch of full canvases, so the narrower canvases of the buckets are
        views of the same buffers: only a larger batch pins anew."""
        shape = tuple(int(d) for d in shape)
        if self.device.type != "cuda":
            return np.zeros(shape, np.uint8)
        n = int(np.prod(shape))
        if not self._staged or self._staged[0][0].numel() < n:
            for _, ev in self._staged:
                if ev is not None:
                    ev.synchronize()
            cap = max(n, shape[0] * int(np.prod(self.cfg.image_shape)))
            self._staged = [(torch.empty(cap, dtype=torch.uint8, pin_memory=True), None)
                            for _ in range(STAGING_SLOTS)]
            self._slot = 0
        buf, ev = self._staged[self._slot]
        if ev is not None:
            ev.synchronize()  # its last upload has been read
        self._slot = (self._slot + 1) % STAGING_SLOTS
        return buf[:n].numpy().reshape(shape)

    def _upload(self, canvases: Any) -> torch.Tensor:
        """Canvases (a host array or a tensor) -> a uint8 tensor on the device.
        On the card a host array goes through a pinned staging buffer
        (:meth:`staging_buffer`; copied into one unless it is one) with
        ``non_blocking=True``, and an event recorded after the copy guards
        the buffer's reuse."""
        if isinstance(canvases, torch.Tensor):
            return canvases.to(self.device, non_blocking=True)
        arr = np.ascontiguousarray(canvases)
        if self.device.type != "cuda" or arr.dtype != np.uint8:
            return torch.from_numpy(arr).to(self.device)

        def slot_of(a):
            return next((i for i, (t, _) in enumerate(self._staged)
                         if a.ctypes.data == t.data_ptr() and a.size <= t.numel()), None)

        i = slot_of(arr)
        if i is None:
            view = self.staging_buffer(arr.shape)
            view[...] = arr
            i = slot_of(view)
        buf = self._staged[i][0]
        x = buf[: arr.size].view(arr.shape).to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._staged[i] = (buf, ev)
        return x

    @torch.no_grad()
    def decode_canvases(self, canvases_u8: Any, dcfg: Optional[DecodeConfig] = None,
                        seed: int = 0, fetch: bool = True, width: Optional[int] = None) -> Any:
        """uint8 (B, H, W, C) canvases -> token ids (B, dcfg.max_length) int32
        on the host, with ``dcfg`` (default :meth:`decode_config`); a
        sampling decode draws with the int32 kernel ``seed``: the dispatch
        (:meth:`dispatch_canvases`), then the fetch (``.cpu()``).  With
        ``fetch=False`` the dispatch alone, the tokens left on the device:
        ``predict_batch`` and evaluate decode so, and fetch later.
        ``width``: the canvases are a bucket's (:meth:`encode`)."""
        tokens = self.dispatch_canvases(canvases_u8, dcfg=dcfg, seed=seed, width=width)
        return tokens.cpu().numpy() if fetch else tokens

    @torch.no_grad()
    def dispatch_canvases(self, canvases_u8: Any, dcfg: Optional[DecodeConfig] = None,
                          seed: int = 0, width: Optional[int] = None) -> torch.Tensor:
        """uint8 (B, H, W, C) canvases (a host array, or a tensor such as a
        view of a device-resident split) -> the token ids (B,
        dcfg.max_length) int32 on the device: the upload, normalize, encode
        (:meth:`encode`, at bucket ``width`` where given) and decode
        enqueued, with no wait for the card except early exit's flag reads
        (module docstring)."""
        if dcfg is None:
            dcfg = self.decode_config()
        sample = dict(top_k=dcfg.top_k, seed=int(seed),
                      temperature=dcfg.temperature, top_p=dcfg.top_p, early_exit=dcfg.early_exit)
        icfg = self.cfg.preprocessing
        x = self._upload(canvases_u8)
        x = normalize_images(x, icfg.normalization_mean, icfg.normalization_std, self.dtype)
        memory = self.encode(x, width)
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
        return tokens

    @torch.no_grad()
    def dispatch_split(self, images: Any, dcfg: DecodeConfig, seeds: Sequence[int],
                       width: Optional[int] = None) -> torch.Tensor:
        """A split already on the device, uint8 (n_b, B, H, W, C) -> its token
        ids (n_b, B, dcfg.max_length) int32 on the device: each batch's decode
        (:meth:`dispatch_canvases`, batch i with the kernel seed ``seeds[i]``)
        enqueued right after the one before, and written into one tensor, so
        that the split is fetched once (the counterpart of the JAX
        ``_decode_split_fn``, a ``lax.map`` over the batches).  The tokens are
        the per-batch loop's.  Early exit still reads its flag from the card
        every 8 steps of each batch."""
        out: Optional[torch.Tensor] = None
        for i in range(len(images)):
            tokens = self.dispatch_canvases(images[i], dcfg=dcfg, seed=seeds[i], width=width)
            if out is None:
                out = torch.empty((len(images),) + tuple(tokens.shape), dtype=tokens.dtype, device=tokens.device)
            out[i].copy_(tokens)
        return out

    # ---- aspect-ratio buckets (the JAX Predictor's bucketing) -----------------

    def _bucket_stride(self) -> int:
        return bucket_stride(self.cfg)

    def bucket_margin_px(self) -> int:
        return bucket_margin_px(self.cfg)

    def _white_fill(self, batch: int) -> torch.Tensor:
        """The feature map (C, H', W') of an all-white full canvas: the values
        the model sees right of the content on the full canvas, its right
        edge's padding included.  It is encoded once per batch size, in a
        batch of ``batch`` white canvases through :meth:`Seq2SeqModel.encode_features`
        on this predictor's device and dtype, so that it takes the kernels
        and the library's algorithms of a full-canvas batch."""
        if batch not in self._white:
            h, w, c = self.cfg.image_shape
            pre = self.cfg.preprocessing
            white = torch.full((batch, h, w, c), pre.pad_value, dtype=torch.uint8, device=self.device)
            x = normalize_images(white, pre.normalization_mean, pre.normalization_std, self.dtype)
            with torch.no_grad():
                self._white[batch] = self.model.encode_features(x)[0].clone()
        return self._white[batch]

    def encode(self, x: torch.Tensor, width: Optional[int] = None) -> torch.Tensor:
        """Normalized canvases -> memory.  With a bucket ``width`` the canvases
        are ``width + bucket_margin_px()`` wide: the encoder's feature map is
        computed on them, its first ``width // stride`` columns are kept and
        the white canvas's columns (:meth:`_white_fill`) put after them, and
        the head runs on that full-width map, so that the memory is the full
        canvas's (the JAX ``_decode_impl``'s ``width``)."""
        if width is None:
            return self.model.encode(x)
        keep = width // self._bucket_stride()
        feats = self.model.encode_features(x)[..., :keep]
        fill = self._white_fill(x.shape[0])[..., keep:].to(feats.dtype)
        fill = fill[None].expand((feats.shape[0],) + tuple(fill.shape))
        return self.model.encode_from_features(torch.cat([feats, fill], dim=-1))

    def _assign_bucket(self, image: Any, bucket_widths: Sequence[int]) -> Optional[int]:
        """The bucket of ``image`` (:func:`assign_bucket`), or None for the full canvas."""
        h, w_full, _ = self.cfg.image_shape
        return assign_bucket(image, bucket_widths, h, w_full, self._bucket_stride(), self.bucket_margin_px())

    def _bucket_groups(self, images: Sequence[Any],
                       bucket_widths: Sequence[int]) -> List[Tuple[Optional[int], List[int]]]:
        """The input positions of each bucket, narrowest first, the full canvas last."""
        groups: Dict[Optional[int], List[int]] = {}
        for idx, img in enumerate(images):
            groups.setdefault(self._assign_bucket(img, bucket_widths), []).append(idx)
        return sorted(groups.items(), key=lambda kv: (kv[0] is None, kv[0] or 0))

    def _canvas_fn(self, width: Optional[int]) -> Tuple[int, Callable[[Any], np.ndarray]]:
        """(canvas width, an input -> its canvas) of a bucket, or of the full
        canvas where ``width`` is None (:func:`prepare_image_at_width`, as the
        JAX package preps every group of a bucketed decode)."""
        h, w_full, c = self.cfg.image_shape
        canvas_w = w_full if width is None else width + self.bucket_margin_px()
        pad = self.cfg.preprocessing.pad_value
        return canvas_w, lambda img: prepare_image_at_width(img, h, canvas_w, c, pad)

    def _prep_pool(self) -> Optional[ThreadPoolExecutor]:
        """The shared thread pool of a chunk's image prep, ``min(8, cores)``
        workers (Pillow's decode and resize release the GIL); None on one
        core, where the chunk is prepped serially."""
        n = os.cpu_count() or 1
        if n <= 1:
            return None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=min(8, n))
        return self._pool

    def _prep_chunk(self, buf: np.ndarray, imgs: Sequence[Any],
                    prep_one: Callable[[Any], np.ndarray], any_width: bool = False) -> np.ndarray:
        """Prep ``imgs`` into the first rows of ``buf``: in the pool where
        there is one and Pillow decodes or resizes an image of the chunk;
        serially where every image is an array at the canvas size (with
        ``any_width``, a bucket's prep, at the canvas height), whose prep
        holds the GIL, so that threads only add their overhead (on the card
        the pool took ``predict_batch`` of such arrays below the serial loop;
        ``PERF.md``)."""
        h, w = buf.shape[1:3]
        w = None if any_width else w
        pool = self._prep_pool() if any(_needs_pillow(img, h, w) for img in imgs) else None
        if pool is not None and len(imgs) > 1:
            for j, row in enumerate(pool.map(prep_one, imgs)):
                buf[j] = row
        else:
            for j, img in enumerate(imgs):
                buf[j] = prep_one(img)
        return buf

    def predict_batch(self, images: Sequence[Any], beam_size: Optional[int] = None,
                      max_length: Optional[int] = None, temperature: Optional[float] = None,
                      top_k: Optional[int] = None, top_p: Optional[float] = None,
                      length_penalty: Optional[float] = None, early_exit: Optional[bool] = None,
                      batch_size: Optional[int] = None, seed: int = 0, return_ids: bool = False,
                      selective_beam_frac: Optional[float] = None,
                      stats: Optional[Dict[str, Any]] = None,
                      bucket_widths: Optional[Sequence[int]] = None) -> List[Any]:
        """Decode ``images`` (paths, PIL images or arrays) in fixed batches of
        ``batch_size``; returns LaTeX strings, or id lists with ``return_ids``.
        The decode settings are ``cfg.inference``'s, with the keyword
        overrides of the JAX package's ``predict_batch``; a sampling decode
        draws batch i with the kernel seed ``batch_seed(seed, i)``.  The
        batches run through :func:`decode_chunks` (module docstring), which
        fills ``stats``; the host's trim and detokenize add ``post_s``.
        ``bucket_widths`` (default ``cfg.inference.bucket_widths``) decodes
        by aspect-ratio bucket (:meth:`_predict_bucketed`)."""
        dcfg = self.decode_config(beam_size=beam_size, max_length=max_length,
                                  temperature=temperature, top_k=top_k, top_p=top_p,
                                  length_penalty=length_penalty, early_exit=early_exit,
                                  selective_beam_frac=selective_beam_frac)
        B = int(batch_size or self.batch_size)
        if bucket_widths is None:
            bucket_widths = self.cfg.inference.bucket_widths
        if bucket_widths:
            return self._predict_bucketed(images, dcfg, B, seed, return_ids, bucket_widths, stats)
        h, w, c = self.cfg.image_shape
        pad = self.cfg.preprocessing.pad_value
        tok = self.tokenizer

        def run(buf: np.ndarray, kernel_seed: int) -> torch.Tensor:
            return self.decode_canvases(buf, dcfg=dcfg, seed=kernel_seed, fetch=False)

        def prep_one(img: Any) -> np.ndarray:
            return prepare_image_u8(img, h, w, c, pad)

        def make_prep(chunk: Sequence[Any]) -> Callable[[], np.ndarray]:
            def prep() -> np.ndarray:
                buf = self.staging_buffer((B, h, w, c))
                buf[len(chunk):] = 0  # the zero canvases that pad a short last batch
                return self._prep_chunk(buf, chunk, prep_one)

            return prep

        plan = [((B, None), run, make_prep(images[i : i + B]), range(i, min(i + B, len(images))))
                for i in range(0, len(images), B)]
        results: List[Any] = []
        t_post = 0.0
        for idxs, tokens in decode_chunks(plan, seed, stats):
            t0 = time.perf_counter()
            ids = trim_host(tokens[: len(idxs)], tok.end_token_id, tok.pad_token_id,
                            start_id=tok.start_token_id)
            results.extend(ids if return_ids else (tok.decode(r) for r in ids))
            t_post += time.perf_counter() - t0
        if stats is not None:
            stats["post_s"] = stats.get("post_s", 0.0) + t_post
        return results

    def _post_ids(self, tokens: np.ndarray) -> List[List[int]]:
        tok = self.tokenizer
        return trim_host(tokens, tok.end_token_id, tok.pad_token_id, start_id=tok.start_token_id)

    def _predict_bucketed(self, images: Sequence[Any], dcfg: DecodeConfig, B: int, seed: int,
                          return_ids: bool, bucket_widths: Sequence[int],
                          stats: Optional[Dict[str, Any]] = None) -> List[Any]:
        """Decode ``images`` by aspect-ratio bucket (the JAX
        ``_predict_bucketed``): each image goes to the narrowest bucket that
        holds it (``stats["bucket_assign_s"]``), each bucket's chunks of B
        are prepped at its canvas width and encoded there (:meth:`encode`),
        and the results come back in input order; the tokens are the full
        canvas's.  One plan over every bucket, narrowest first and the full
        canvas last, runs through :func:`decode_chunks` (an exec key per
        ``(B, bucket)``), so the j-th chunk of that order draws with
        ``batch_seed(seed, j)`` (the JAX package's keys differ)."""
        h, _, c = self.cfg.image_shape
        t0 = time.perf_counter()
        groups = self._bucket_groups(images, bucket_widths)
        if stats is not None:
            stats["bucket_assign_s"] = stats.get("bucket_assign_s", 0.0) + (time.perf_counter() - t0)

        def make_prep(canvas_w: int, prep_one, chunk: Sequence[int]) -> Callable[[], np.ndarray]:
            def prep() -> np.ndarray:
                buf = self.staging_buffer((B, h, canvas_w, c))
                buf[len(chunk):] = 0  # the zero canvases that pad a short last batch
                return self._prep_chunk(buf, [images[k] for k in chunk], prep_one, any_width=True)

            return prep

        plan = []
        for bw, idxs in groups:
            canvas_w, prep_one = self._canvas_fn(bw)

            def run(buf: np.ndarray, kernel_seed: int, bw=bw) -> torch.Tensor:
                return self.decode_canvases(buf, dcfg=dcfg, seed=kernel_seed, fetch=False, width=bw)

            for i in range(0, len(idxs), B):
                chunk = idxs[i : i + B]
                plan.append(((B, bw), run, make_prep(canvas_w, prep_one, chunk), chunk))
        results: List[Any] = [None] * len(images)
        t_post = 0.0
        for chunk, tokens in decode_chunks(plan, seed, stats):
            t1 = time.perf_counter()
            for idx, ids in zip(chunk, self._post_ids(tokens[: len(chunk)])):
                results[idx] = ids if return_ids else self.tokenizer.decode(ids)
            t_post += time.perf_counter() - t1
        if stats is not None:
            stats["post_s"] = stats.get("post_s", 0.0) + t_post
        return results

    def predict_split_bucketed(self, images: Sequence[Any], dcfg: DecodeConfig, B: int,
                               bucket_widths: Sequence[int], passes: int = 1,
                               stats: Optional[Dict[str, Any]] = None, seed: int = 0) -> List[List[int]]:
        """Decode ``images`` by aspect-ratio bucket with each bucket held on
        the card as a whole split (the JAX ``predict_split_bucketed``): each
        bucket's canvases are prepped and uploaded once (``cache_build_s``,
        with the assignment), then each bucket is decoded by
        :meth:`dispatch_split` and fetched once.  Returns the trimmed id
        lists in input order; an empty input gives ``[]``.

        Seeds: the batches of the buckets, narrowest bucket first and the
        full canvas last, are numbered j = 0, 1, ... and batch j draws with
        ``batch_seed(seed, j)``, the seeds :meth:`_predict_bucketed` gives
        the same chunks (the JAX package draws a bucket's batches from
        ``fold_in(PRNGKey(0), bucket)``).

        ``passes >= 2`` decodes the split again, each pass dispatched before
        the host trims the one before and fetched after (a pass's post rides
        under the next pass's decode).  ``stats`` takes the JAX accounting:
        ``cache_build_s``, ``setup_s`` (the weights' packing, the white
        canvas's features, the seeds), ``first_calls`` (one a bucket: pass
        1, its dispatch wall on the first entry), ``dispatch_s``,
        ``fetch_s``, ``post_s`` and ``steady_images`` of the later passes."""
        if not len(images):
            return []
        h, _, c = self.cfg.image_shape
        st: Dict[str, Any] = stats if stats is not None else {}
        t0 = time.perf_counter()
        groups = self._bucket_groups(images, bucket_widths)
        st["cache_build_s"] = st.get("cache_build_s", 0.0) + (time.perf_counter() - t0)
        buckets = []  # (bucket, input positions, canvases on the device (n_b, B, H, W, C))
        for bw, idxs in groups:
            t0 = time.perf_counter()
            canvas_w, prep_one = self._canvas_fn(bw)
            n_b = -(-len(idxs) // B)
            buf = np.zeros((n_b * B, h, canvas_w, c), dtype=np.uint8)
            self._prep_chunk(buf, [images[k] for k in idxs], prep_one, any_width=True)
            dev = upload_rows([buf], self.device).view(n_b, B, h, canvas_w, c)
            st["cache_build_s"] += time.perf_counter() - t0
            buckets.append((bw, idxs, dev))

        t0 = time.perf_counter()
        self.packed_decoder()
        if self.cfg.model.memory == "grid" and self.cfg.model.decoder.attention:
            self.packed_attention()
        runs, j = [], 0
        for bw, idxs, dev in buckets:
            if bw is not None:
                self._white_fill(B)
            runs.append((bw, idxs, dev, [batch_seed(seed, j + i) for i in range(dev.shape[0])]))
            j += dev.shape[0]
        st["setup_s"] = st.get("setup_s", 0.0) + (time.perf_counter() - t0)

        def dispatch_all() -> List[torch.Tensor]:
            return [self.dispatch_split(dev, dcfg, seeds, width=bw) for bw, _, dev, seeds in runs]

        def post(toks_by_bucket) -> List[List[int]]:
            results: List[Any] = [None] * len(images)
            for (_, idxs, _, _), toks in zip(runs, toks_by_bucket):
                flat = toks.reshape(-1, toks.shape[-1])[: len(idxs)]
                for idx, ids in zip(idxs, self._post_ids(flat)):
                    results[idx] = ids
            return results

        # pass 1: each bucket's first call (the kernels' build, the
        # libraries' plans at its width); the dispatch wall goes to the first
        t0 = time.perf_counter()
        futs = dispatch_all()
        first_dispatch = time.perf_counter() - t0
        toks_by_bucket = []
        for (bw, idxs, dev, _), fut in zip(runs, futs):
            t0 = time.perf_counter()
            toks_by_bucket.append(fut.cpu().numpy())
            st.setdefault("first_calls", []).append({
                "exec": f"bucket_split[{'full' if bw is None else bw}][{dev.shape[0]}x{B}]",
                "seconds": time.perf_counter() - t0, "images": len(idxs)})
        st["first_calls"][-len(runs)]["seconds"] += first_dispatch
        return run_passes(dispatch_all, lambda futs: [f.cpu().numpy() for f in futs], post, toks_by_bucket,
                          passes, st, len(images))

    def predict(self, image: Any, **kwargs) -> Any:
        """One image, decoded at batch 1 (the JAX ``Predictor.predict``)."""
        return self.predict_batch([image], batch_size=1, **kwargs)[0]
