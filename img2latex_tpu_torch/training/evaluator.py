"""Evaluate a checkpoint over a split: the free-running decode, the metrics
and ``predictions.json`` (counterpart of ``img2latex_tpu/training/evaluator.py``).

:func:`evaluate_checkpoint` loads a checkpoint into a
:class:`~img2latex_tpu_torch.training.predictor.Predictor` (or takes the
caller's), decodes the split with greedy, beam or sampling, computes BLEU-4,
Levenshtein similarity and token accuracy over the whole split
(:mod:`img2latex_tpu_torch.ops.metrics`) and, given ``output_dir``, writes
``predictions.json`` (``{"metrics", "predictions": [{"image", "prediction",
"reference"}]}``).  The result has the JAX package's keys.

The loops, as in the JAX package:

* streaming: the loader's background thread preps batch i + 1 while the
  card decodes batch i, and the loop dispatches batch i
  (:meth:`Predictor.decode_canvases` with ``fetch=False``), fetches batch
  i - 1, and only then waits for batch i's tokens;
* ``data.device_cache``: the split is uploaded once as uint8 (one stacked
  copy).  The split must fit ``data.device_cache_budget_gb``, else half
  the card's free memory (2 GiB where none is reported); a split over it is
  logged and streams, as the JAX package does.  ``cache_build_seconds`` is
  above 0 exactly when the split was cached.  With ``inference.whole_split``
  (the default) and every batch full, the split is decoded as a whole
  (:func:`_evaluate_whole_split`: every batch enqueued back to back by
  :meth:`Predictor.dispatch_split`, one fetch), ``passes`` times; the
  result has ``whole_split`` and ``decode_passes``.  Otherwise each batch
  is a view of it on the card, decoded as in the streaming loop;
* ``bucket_widths`` (default ``inference.bucket_widths``): the images are
  read from their files (their natural widths decide the buckets, which
  the fixed canvases of the loader and the canvas cache have lost) and
  decoded by aspect-ratio bucket (:func:`_evaluate_bucketed`): streaming
  through ``Predictor.predict_batch``'s bucketed plan, or with
  ``data.device_cache`` and ``inference.whole_split`` each bucket as a
  whole split (``Predictor.predict_split_bucketed``).

A sampling decode draws batch i with the kernel seed ``batch_seed(0, i)``
(the JAX package splits ``PRNGKey(0)``); the bucketed loops number the
batches bucket by bucket (``Predictor.predict_split_bucketed``).

Throughput accounting, with the JAX package's inclusion rule: each decode
configuration's first call (in the port, the kernel library's first-launch
build and the libraries' handles and plans) and exactly its images are left
out of the steady figures.

* ``end_to_end_seconds``: the whole wall, prep to the last detokenize;
* ``decode_seconds``: steady dispatch (upload and enqueue) plus the fetch's wait;
* ``compile_and_first_batch_seconds``: the first calls' walls;
* ``host_prep_seconds`` / ``host_post_seconds`` / ``input_wait_seconds`` /
  ``cache_build_seconds`` / ``setup_seconds``: host buckets (prep overlaps
  the decode, so they do not sum to the wall), and ``host_other_seconds``
  the rest;
* ``images_per_second``: steady images over the wall less the first calls;
  ``images_per_second_decode_only`` over ``decode_seconds``;
  ``images_per_second_resident`` also without the cache build and set-up.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from img2latex_tpu_torch.config import set_by_path, validate_config
from img2latex_tpu_torch.data.pipeline import _image_path, create_data_loaders
from img2latex_tpu_torch.decoding.decode import DecodeConfig, trim_host
from img2latex_tpu_torch.ops.metrics import calculate_metrics, token_list_accuracy
from img2latex_tpu_torch.training.predictor import Predictor, batch_seed, run_passes
from img2latex_tpu_torch.utils.device import device_cache_budget, upload_rows

logger = logging.getLogger(__name__)


def evaluate_checkpoint(
    checkpoint_path: Optional[str],
    data_dir: Optional[str] = None,
    split: str = "test",
    beam_size: Optional[int] = None,
    max_length: Optional[int] = None,
    temperature: Optional[float] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    length_penalty: Optional[float] = None,
    early_exit: Optional[bool] = None,
    batch_size: Optional[int] = None,
    max_batches: Optional[int] = None,
    output_dir: Optional[str] = None,
    predictor: Optional[Predictor] = None,
    bucket_widths: Optional[Any] = None,
    config_overrides: Optional[Dict[str, Any]] = None,
    passes: int = 1,
    device: Optional[str] = None,
) -> Dict[str, Any]:
    """Decode ``split`` of the corpus under ``data_dir`` (default the
    config's) and return the metrics and the accounting (module docstring).
    ``predictor`` is used as given, its config left untouched:
    ``config_overrides`` then apply to this evaluation's copy of it;
    without one, the checkpoint is loaded with them onto ``device`` (the card
    unless ``"cpu"`` is named).  ``batch_size`` sets the evaluation batch;
    ``max_batches`` caps the batches decoded; ``passes`` is the decodes of
    a split held on the card as a whole (module docstring)."""
    pred = predictor or Predictor.from_checkpoint(checkpoint_path, config_overrides=config_overrides,
                                                  device=device)
    cfg = copy.deepcopy(pred.cfg)  # per-evaluation overrides never reach the caller's predictor
    if predictor is not None and config_overrides:
        for dotted, value in config_overrides.items():
            set_by_path(cfg, dotted, value)
        validate_config(cfg)
    if data_dir:
        cfg.data.data_dir = data_dir
    if batch_size:
        cfg.data.batch_size = batch_size
        cfg.data.eval_batch_size_multiplier = 1
        cfg.data.max_eval_batch_size = batch_size
    tok = pred.tokenizer
    loader = create_data_loaders(cfg, tok, splits=(split,))[split]
    dcfg = pred.decode_config(beam_size=beam_size, max_length=max_length, temperature=temperature,
                              top_k=top_k, top_p=top_p, length_penalty=length_penalty,
                              early_exit=early_exit, inference=cfg.inference)
    if bucket_widths is None:
        bucket_widths = cfg.inference.bucket_widths
    if bucket_widths:
        return _evaluate_bucketed(pred, cfg, loader, dcfg, split, bucket_widths, max_batches, output_dir, passes)

    stats: Dict[str, Any] = {}
    wall0 = time.perf_counter()
    use_cache = bool(cfg.data.device_cache)
    if use_cache:
        h, w, c = cfg.image_shape
        n_rows = len(loader.dataset)
        if max_batches is not None:
            n_rows = min(n_rows, max_batches * loader.batch_size)
        est = n_rows * h * w * c
        budget = device_cache_budget(cfg.data.device_cache_budget_gb, pred.device, share=0.5, fallback_gib=2.0)
        if est > budget:
            logger.warning("data.device_cache: %s split would use %.2f GiB (> %.2f GiB budget); "
                           "streaming from the host loader instead", split, est / 1024**3, budget / 1024**3)
            use_cache = False
    if use_cache:
        t0 = time.perf_counter()
        cached = []
        for bi, batch in enumerate(loader):
            if max_batches is not None and bi >= max_batches:
                break
            cached.append(dict(batch))
        big = upload_rows([b["images"] for b in cached], pred.device) if cached else None
        if (big is not None and cfg.inference.whole_split
                and all(b["images"].shape[0] == loader.batch_size for b in cached)):
            stats["cache_build_s"] = time.perf_counter() - t0
            return _evaluate_whole_split(pred, cfg, tok, split, loader, cached, big, dcfg, stats, wall0,
                                         output_dir, passes)
        if cached:
            # each batch a view of the one stacked upload on the device
            off = 0
            for b in cached:
                n = b["images"].shape[0]
                b["_images_dev"] = big[off : off + n]
                off += n
        stats["cache_build_s"] = time.perf_counter() - t0
        batch_iter: Any = enumerate(cached)
    else:
        batch_iter = enumerate(loader)

    all_preds: List[List[int]] = []
    all_tgts: List[List[int]] = []
    rows: List[Dict[str, Any]] = []
    n_images = 0
    run = None
    sample_offset = 0
    ds = loader.dataset
    pending = None  # (tokens on the device, n_valid, row_base, first dispatch wall)
    seen_exec = False
    t_post = 0.0

    def _collect(p) -> None:
        nonlocal t_post, seen_exec
        tokens_dev, n_local, row_base, dispatch_wall = p
        t0 = time.perf_counter()
        tokens = tokens_dev.cpu().numpy()
        dt = time.perf_counter() - t0
        if not seen_exec:
            stats.setdefault("first_calls", []).append(
                {"exec": "decode", "seconds": dt + dispatch_wall, "images": n_local})
            seen_exec = True
        else:
            stats["fetch_s"] = stats.get("fetch_s", 0.0) + dt
            stats["steady_images"] = stats.get("steady_images", 0) + n_local
        t1 = time.perf_counter()
        pred_ids = trim_host(tokens[:n_local], tok.end_token_id, tok.pad_token_id,
                             start_id=tok.start_token_id)
        all_preds.extend(pred_ids)
        pred_strs = tok.decode_rows(pred_ids)
        for j in range(n_local):
            idx = row_base + j
            name = ds.samples[idx][0] if idx < len(ds.samples) and not loader.shuffle else None
            rows.append({"image": name, "prediction": pred_strs[j]})
        t_post += time.perf_counter() - t1

    # the first dispatch's wall is folded into its fetch's: first_calls[0]
    # holds both walls of batch 0, and the steady dispatch_s starts at batch 1
    t_input0 = time.perf_counter()
    for bi, batch in batch_iter:
        stats["input_wait_s"] = stats.get("input_wait_s", 0.0) + (time.perf_counter() - t_input0)
        if max_batches is not None and bi >= max_batches:
            break
        B = batch["images"].shape[0]
        if run is None:
            t_setup = time.perf_counter()
            _pack(pred, cfg)

            def run(images, seed):
                return pred.decode_canvases(images, dcfg=dcfg, seed=seed, fetch=False)

            stats["setup_s"] = time.perf_counter() - t_setup
        n_valid = int(batch.get("n_valid", B))
        t0 = time.perf_counter()
        images = batch.get("_images_dev")
        tokens = run(batch["images"] if images is None else images, batch_seed(0, bi))
        t_dispatch = time.perf_counter() - t0
        if seen_exec or pending is not None:
            stats["dispatch_s"] = stats.get("dispatch_s", 0.0) + t_dispatch
            t_dispatch = 0.0
        # the targets trim on the host while the card decodes
        t1 = time.perf_counter()
        all_tgts.extend(trim_host(np.asarray(batch["formulas"])[:n_valid, 1:],  # START stripped
                                  tok.end_token_id, tok.pad_token_id))
        t_post += time.perf_counter() - t1
        if pending is not None:
            _collect(pending)
        pending = (tokens, n_valid, sample_offset, t_dispatch)
        sample_offset += n_valid
        n_images += n_valid
        t_input0 = time.perf_counter()
    if pending is not None:
        _collect(pending)
    stats["post_s"] = stats.get("post_s", 0.0) + t_post
    for r, ref in zip(rows, tok.decode_rows(all_tgts)):  # references join their rows now
        r["reference"] = ref
    return _finish(cfg, tok, split, all_preds, all_tgts, rows, n_images, stats,
                   time.perf_counter() - wall0, dcfg, output_dir)


def _pack(pred: Predictor, cfg) -> None:
    """The decode kernels' weights, packed once per Predictor."""
    pred.packed_decoder()
    if cfg.model.memory == "grid" and cfg.model.decoder.attention:
        pred.packed_attention()


def _evaluate_whole_split(pred: Predictor, cfg, tok, split: str, loader, cached, big, dcfg: DecodeConfig,
                          stats: Dict[str, Any], wall0: float, output_dir: Optional[str],
                          passes: int) -> Dict[str, Any]:
    """The cached split decoded as a whole (the JAX ``_evaluate_whole_split``):
    ``Predictor.dispatch_split`` enqueues every batch back to back, batch i
    with ``batch_seed(0, i)`` as the per-batch loop draws it, and the split
    is fetched once.  The targets are trimmed and detokenized once, in the
    set-up.  Pass 1 is the first call; with ``passes >= 2`` each later pass
    is dispatched, then the pass before is trimmed and detokenized on the
    host while the card decodes, then the pass is fetched (:func:`run_passes`),
    so that those passes are the steady figures (``images_per_second_resident``)."""
    B = loader.batch_size
    n_b = len(cached)
    t_setup = time.perf_counter()
    _pack(pred, cfg)
    seeds = [batch_seed(0, i) for i in range(n_b)]
    images_all = big.view((n_b, B) + tuple(big.shape[1:]))
    n_valid = [int(b.get("n_valid", B)) for b in cached]
    tgt_ids = [trim_host(np.asarray(b["formulas"])[:n, 1:], tok.end_token_id, tok.pad_token_id)  # START stripped
               for b, n in zip(cached, n_valid)]
    tgt_strs = [tok.decode_rows(t) for t in tgt_ids]
    stats["setup_s"] = time.perf_counter() - t_setup
    n_images = sum(n_valid)
    ds = loader.dataset

    def post(tokens: np.ndarray):
        """A pass's trim, detokenize and rows, as a repeated evaluation pays them."""
        all_preds, all_tgts, rows = [], [], []
        offset = 0
        for bi, n in enumerate(n_valid):
            pred_ids = trim_host(tokens[bi, :n], tok.end_token_id, tok.pad_token_id, start_id=tok.start_token_id)
            all_preds.extend(pred_ids)
            all_tgts.extend(tgt_ids[bi])
            for j, (p, r) in enumerate(zip(tok.decode_rows(pred_ids), tgt_strs[bi])):
                idx = offset + j
                name = ds.samples[idx][0] if idx < len(ds.samples) and not loader.shuffle else None
                rows.append({"image": name, "prediction": p, "reference": r})
            offset += n
        return all_preds, all_tgts, rows

    t0 = time.perf_counter()
    tokens = pred.dispatch_split(images_all, dcfg, seeds).cpu().numpy()
    stats["first_calls"] = [{"exec": f"whole_split_decode[{n_b}x{B}]", "seconds": time.perf_counter() - t0,
                             "images": n_images}]
    all_preds, all_tgts, rows = run_passes(lambda: pred.dispatch_split(images_all, dcfg, seeds),
                                           lambda fut: fut.cpu().numpy(), post, tokens, passes, stats, n_images)
    return _finish(cfg, tok, split, all_preds, all_tgts, rows, n_images, stats, time.perf_counter() - wall0,
                   dcfg, output_dir, extra_fields={"whole_split": True, "decode_passes": max(passes, 1)})


def _evaluate_bucketed(pred: Predictor, cfg, loader, dcfg: DecodeConfig, split: str, bucket_widths,
                       max_batches: Optional[int], output_dir: Optional[str], passes: int) -> Dict[str, Any]:
    """Evaluate by aspect-ratio bucket from the image files (the JAX
    ``_evaluate_bucketed``): with ``data.device_cache`` and
    ``inference.whole_split`` each bucket as a whole split
    (``Predictor.predict_split_bucketed``, ``passes`` times), else streaming
    through the bucketed ``predict_batch`` plan.  The wall starts at the
    decode, as in the JAX package."""
    tok = pred.tokenizer
    ds = loader.dataset
    n = len(ds.samples)
    if max_batches is not None:
        n = min(n, max_batches * loader.batch_size)
    paths = [_image_path(ds.img_dir, name) for name, _ in ds.samples[:n]]
    stats: Dict[str, Any] = {}
    use_split = bool(cfg.data.device_cache) and cfg.inference.whole_split
    t0 = time.perf_counter()
    if use_split:
        pred_ids = pred.predict_split_bucketed(paths, dcfg, loader.batch_size, bucket_widths, passes=passes,
                                               stats=stats)
    else:
        pred_ids = pred._predict_bucketed(paths, dcfg, loader.batch_size, 0, True, bucket_widths, stats)
    wall = time.perf_counter() - t0
    tgt_ids = (trim_host(np.stack([ds.token_ids(i) for i in range(n)])[:, 1:], tok.end_token_id, tok.pad_token_id)
               if n else [])
    rows = [{"image": ds.samples[i][0], "prediction": tok.decode(pred_ids[i]), "reference": tok.decode(tgt_ids[i])}
            for i in range(n)]
    return _finish(cfg, tok, split, pred_ids, tgt_ids, rows, n, stats, wall, dcfg, output_dir, bucketed=True,
                   extra_fields={"whole_split": True, "decode_passes": max(passes, 1)} if use_split else None)


def _finish(cfg, tok, split: str, all_preds, all_tgts, rows, n_images: int, stats: Dict[str, Any],
            wall_s: float, dcfg: DecodeConfig, output_dir: Optional[str], bucketed: bool = False,
            extra_fields: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The metrics over the split, the accounting, and ``predictions.json``
    (the JAX package's ``_finish``, ``evaluator.py:461-570``, and its keys;
    ``extra_fields`` join them)."""
    quality = calculate_metrics(all_preds, all_tgts, cfg.evaluation.bleu_n)
    correct, total = token_list_accuracy(all_preds, all_tgts, tok.pad_token_id)
    first_calls = stats.get("first_calls", [])
    compile_s = sum(f["seconds"] for f in first_calls)
    steady_images = int(stats.get("steady_images", 0))
    decode_s = stats.get("dispatch_s", 0.0) + stats.get("fetch_s", 0.0)
    steady_wall = max(wall_s - compile_s, 0.0)
    if steady_images > 0 and steady_wall > 0 and decode_s > 0:
        ips = steady_images / steady_wall
        ips_decode = steady_images / decode_s
        includes_compile = False
    else:  # one batch: no steady measurement exists, so the rate includes the first call
        ips = n_images / max(wall_s, 1e-9)
        ips_decode = ips
        includes_compile = True
    result = {
        "split": split,
        "num_images": n_images,
        "bleu": quality["bleu"],
        "levenshtein": quality["levenshtein"],
        "token_accuracy": correct / total if total else 0.0,
        "end_to_end_seconds": wall_s,
        "decode_seconds": decode_s,
        "compile_and_first_batch_seconds": compile_s,
        "host_prep_seconds": stats.get("prep_s", 0.0) + stats.get("bucket_assign_s", 0.0),
        "host_post_seconds": stats.get("post_s", 0.0),
        "input_wait_seconds": stats.get("input_wait_s", 0.0),
        "cache_build_seconds": stats.get("cache_build_s", 0.0),
        "setup_seconds": stats.get("setup_s", 0.0),
        "host_other_seconds": max(
            wall_s - compile_s - stats.get("setup_s", 0.0) - stats.get("cache_build_s", 0.0) - decode_s
            - stats.get("post_s", 0.0) - stats.get("prep_s", 0.0) - stats.get("bucket_assign_s", 0.0)
            - stats.get("input_wait_s", 0.0),
            0.0),
        "steady_images": steady_images,
        "images_per_second": ips,
        "images_per_second_decode_only": ips_decode,
        "images_per_second_resident": (
            steady_images / max(steady_wall - stats.get("cache_build_s", 0.0) - stats.get("setup_s", 0.0), 1e-9)
            if steady_images > 0 and steady_wall > 0 else ips),
        "images_per_second_includes_compile": includes_compile,
        "accounting": (
            "images_per_second = steady end-to-end: (num_images - first-call "
            "images) / (end_to_end_seconds - compile_and_first_batch_seconds); "
            "images_per_second_decode_only divides the same images by "
            "decode_seconds (device dispatch + blocking wait only); "
            "images_per_second_resident additionally excludes the one-time "
            "cache_build_seconds + setup_seconds (the repeated-eval regime)"),
        "bucketed": bucketed,
        "decode": {
            "beam_size": dcfg.beam_size,
            "temperature": dcfg.temperature,
            "top_k": dcfg.top_k,
            "top_p": dcfg.top_p,
            "length_penalty": dcfg.length_penalty,
            "selective_beam_frac": dcfg.selective_beam_frac,
            "max_length": dcfg.max_length,
        },
    }
    result.update(extra_fields or {})
    logger.info("evaluate[%s]: %d images bleu %.4f lev %.4f acc %.4f (%.0f img/s end-to-end, "
                "%.0f img/s decode-only%s)", split, n_images, result["bleu"], result["levenshtein"],
                result["token_accuracy"], result["images_per_second"],
                result["images_per_second_decode_only"], " incl. first call" if includes_compile else "")
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "predictions.json"), "w") as f:
            json.dump({"metrics": result, "predictions": rows}, f, indent=2)
        logger.info("Wrote %s/predictions.json", output_dir)
    return result
