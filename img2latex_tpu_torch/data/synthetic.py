"""Synthetic formula images for tests and the card's smoke run (counterpart of
``img2latex_tpu/data/synthetic.py``).

Each vocabulary id renders as a deterministic black-on-white glyph, glyphs
are placed left to right, and the image/label pair is a learnable mapping.
:func:`synthetic_batch` is numpy only: it fits each rendered formula to the
canvas with :func:`fit_canvas_u8`, a numpy copy of the geometry of
``transforms.array_to_canvas_u8`` (Pillow's Lanczos resize to the canvas
height, then white right-padding or a centre crop) that gives Pillow's bytes,
so the batches equal the JAX package's for the same seed on a machine
without Pillow.  :func:`write_synthetic_corpus` writes PNGs and imports
Pillow inside the function.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

_GLYPH_H, _GLYPH_W = 12, 8
_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point coefficients for 8-bit images


def token_glyph(token_id: int, h: int = _GLYPH_H, w: int = _GLYPH_W) -> np.ndarray:
    """Deterministic binary glyph for a token id (uint8, 0=ink, 255=paper)."""
    rng = np.random.default_rng(0xC0FFEE + int(token_id))
    pattern = rng.random((h, w)) < 0.45
    # Force a distinctive border bit per id so small vocabularies stay separable.
    pattern[0, :] = (token_id % 2) == 0
    pattern[:, 0] = (token_id % 3) == 0
    return np.where(pattern, 0, 255).astype(np.uint8)


def render_formula_image(token_ids: Sequence[int], img_height: int = 32, margin: int = 2,
                         scale: int = 2) -> np.ndarray:
    """Render token ids into a variable-width grayscale image (H, W) uint8."""
    gh, gw = _GLYPH_H * scale, _GLYPH_W * scale
    width = max(len(token_ids), 1) * (gw + margin) + margin
    canvas = np.full((img_height, width), 255, dtype=np.uint8)
    y0 = max((img_height - gh) // 2, 0)
    x = margin
    for tid in token_ids:
        glyph = np.kron(token_glyph(int(tid)), np.ones((scale, scale), dtype=np.uint8))
        h = min(gh, img_height - y0)
        canvas[y0 : y0 + h, x : x + gw] = glyph[:h]
        x += gw + margin
    return canvas


def _lanczos(x: np.ndarray) -> np.ndarray:
    """Pillow's Lanczos filter: sinc(x) sinc(x / 3) on [-3, 3)."""
    return np.where((x >= -3.0) & (x < 3.0), np.sinc(x) * np.sinc(x / 3.0), 0.0)


@functools.lru_cache(maxsize=512)
def _lanczos_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) int64 fixed-point weights, as Pillow's
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` make them; cached
    by size (read-only), since a corpus's formula widths repeat."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ss = 1.0 / filterscale
    k = np.zeros((out_size, in_size), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = _lanczos((np.arange(xmin, xmax) - center + 0.5) * ss)
        ww = 0.0
        for v in w:  # summed in order, as Pillow sums
            ww += float(v)
        k[xx, xmin:xmax] = w / ww if ww != 0.0 else w
    fixed = k * (1 << _PRECISION_BITS)
    out = np.where(k < 0, np.trunc(fixed - 0.5), np.trunc(fixed + 0.5)).astype(np.int64)
    out.flags.writeable = False
    return out


def _resample(img: np.ndarray, coeffs: np.ndarray, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis``, with its rounding and clip."""
    src = np.moveaxis(img.astype(np.float64), axis, -1)
    # a float64 product is exact here (integer terms, sums below 2^53) and
    # runs in BLAS, where an int64 one does not
    acc = (1 << (_PRECISION_BITS - 1)) + (src @ coeffs.T.astype(np.float64)).astype(np.int64)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def lanczos_resize_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W) uint8 -> (out_h, out_w) uint8, the bytes of Pillow's
    ``Image.resize((out_w, out_h), LANCZOS)`` on an "L" image: a horizontal
    pass, then a vertical one, each only where the size changes."""
    h, w = img.shape
    if (h, w) == (out_h, out_w):
        return img.copy()
    out = img
    if out_w != w:
        out = _resample(out, _lanczos_coeffs(w, out_w), axis=1)
    if out_h != h:
        out = _resample(out, _lanczos_coeffs(h, out_h), axis=0)
    return out


def fit_canvas_u8(img: np.ndarray, target_height: int, target_width: int,
                  pad_value: int = 255) -> np.ndarray:
    """(H, W) uint8 -> (target_height, target_width, 1) canvas: resize to the
    target height keeping the aspect ratio, then right-pad or centre-crop."""
    height, width = img.shape
    if height == 0:
        return np.full((target_height, target_width, 1), pad_value, dtype=np.uint8)
    new_width = max(1, int(round(target_height * (width / height))))
    resized = lanczos_resize_u8(img, target_height, new_width)
    if new_width >= target_width:
        left = (new_width - target_width) // 2
        out = resized[:, left : left + target_width]
    else:
        out = np.full((target_height, target_width), pad_value, dtype=np.uint8)
        out[:, :new_width] = resized
    return np.ascontiguousarray(out)[:, :, None]


def random_formulas(n: int, vocab_tokens: Sequence[str], min_len: int = 3, max_len: int = 12,
                    seed: int = 0) -> List[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(min_len, max_len + 1))
        out.append(" ".join(rng.choice(vocab_tokens, size=length)))
    return out


def write_synthetic_corpus(root: str, n_train: int = 64, n_val: int = 16, n_test: int = 16,
                           vocab_tokens: Optional[Sequence[str]] = None, img_height: int = 32,
                           seed: int = 0) -> str:
    """Write a miniature IM2LaTeX-layout dataset under ``root``:
    ``im2latex_{train,validate,test}_filter.lst`` (lines ``<image>.png
    <formula_line_index>``), ``im2latex_formulas.norm.lst`` and ``img/``."""
    from PIL import Image

    if vocab_tokens is None:
        vocab_tokens = "+ - = ( ) \\frac \\sum a b c x y z 0 1 2 _ ^".split()
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    totals = {"train": n_train, "validate": n_val, "test": n_test}
    formulas = random_formulas(sum(totals.values()), vocab_tokens, seed=seed)
    with open(os.path.join(root, "im2latex_formulas.norm.lst"), "w") as f:
        f.write("\n".join(formulas) + "\n")
    # Token ids for rendering: position in an alphabetical token list (stable,
    # independent of the tokenizer so images don't depend on fit order).
    render_ids = {t: i for i, t in enumerate(sorted(set(vocab_tokens)))}
    idx = 0
    for split, count in totals.items():
        lines = []
        for _ in range(count):
            name = f"syn_{idx:06d}"
            ids = [render_ids[t] for t in formulas[idx].split()]
            arr = render_formula_image(ids, img_height=img_height)
            Image.fromarray(arr, mode="L").save(os.path.join(root, "img", f"{name}.png"))
            lines.append(f"{name}.png {idx}")
            idx += 1
        with open(os.path.join(root, f"im2latex_{split}_filter.lst"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def synthetic_batch(batch_size: int, img_shape: Tuple[int, int, int], max_seq_length: int,
                    vocab_size: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """In-memory (images_u8 NHWC, formulas int32) batch, numpy only.

    Formulas follow the <START> body <END> PAD... layout with ids >= 4."""
    if vocab_size <= 4:
        raise ValueError(f"synthetic_batch needs vocab_size > 4 (body ids are >= 4), got {vocab_size}")
    rng = np.random.default_rng(seed)
    h, w, c = img_shape
    images = np.zeros((batch_size, h, w, c), dtype=np.uint8)
    formulas = np.zeros((batch_size, max_seq_length), dtype=np.int32)
    for i in range(batch_size):
        body_len = int(rng.integers(3, max(4, max_seq_length // 2)))
        body = rng.integers(4, vocab_size, size=body_len)
        canvas = fit_canvas_u8(render_formula_image(body), h, w)
        images[i] = canvas if c == 1 else np.repeat(canvas, c, axis=2)
        seq = [1] + body.tolist() + [2]
        formulas[i, : len(seq)] = seq[:max_seq_length]
    return images, formulas

