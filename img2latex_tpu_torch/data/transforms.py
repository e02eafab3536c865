"""Host-side image geometry: any accepted input -> uint8 (H, W, C) canvas.

The counterpart of ``img2latex_tpu/data/transforms.py``.  Arrays already at
canvas size need numpy only (dtype, HW/HWC/CHW and gray/RGB handling, as in
``prepare_image_u8`` there).  Resizing an off-size image, or reading a file,
uses Pillow, which is imported inside those functions only and raises a
clear error where it is missing.  Normalization is not done here: it runs on
the device (:mod:`img2latex_tpu_torch.ops.preprocess`).

Aspect-ratio buckets: :func:`natural_size` and :func:`assign_bucket` are the
JAX package's routing rule, and :func:`prepare_image_at_width` the canvas at
a bucket's width (``Predictor._prepare_image_at_width`` there).  An array
already at the model height takes a numpy route: Pillow's resize to the
same size is a copy, so padding on the right or center-cropping gives the
JAX package's canvas exactly, without Pillow.
"""

from __future__ import annotations

import numpy as np


def _pil():
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - depends on the installation
        raise ImportError(
            "resizing an image to the canvas or reading an image file needs Pillow; "
            "pass uint8 arrays already at the canvas size instead"
        ) from e
    return Image


def resize_with_aspect_ratio(img, target_height: int, target_width: int, pad_value: int = 255):
    """Resize a PIL image to ``target_height`` keeping its aspect ratio (LANCZOS),
    then right-pad with ``pad_value`` or center-crop to ``target_width``."""
    Image = _pil()
    lanczos = getattr(getattr(Image, "Resampling", Image), "LANCZOS")
    fill = pad_value if len(img.getbands()) == 1 else (pad_value,) * len(img.getbands())
    width, height = img.size
    if height == 0:
        return Image.new(img.mode, (target_width, target_height), fill)
    new_width = max(1, int(round(target_height * (width / height))))
    img = img.resize((new_width, target_height), lanczos)
    if new_width == target_width:
        return img
    if new_width < target_width:
        padded = Image.new(img.mode, (target_width, target_height), fill)
        padded.paste(img, (0, 0))
        return padded
    left = (new_width - target_width) // 2
    return img.crop((left, 0, left + target_width, target_height))


def array_to_canvas_u8(
    arr: np.ndarray, target_height: int, target_width: int, pad_value: int = 255
) -> np.ndarray:
    """An in-memory uint8 array (HW or HWC) of any size -> canvas, via Pillow."""
    Image = _pil()
    if arr.ndim == 3 and arr.shape[2] == 1:
        img = Image.fromarray(arr[:, :, 0], mode="L")
    else:
        img = Image.fromarray(arr)
    res = np.asarray(resize_with_aspect_ratio(img, target_height, target_width, pad_value), np.uint8)
    return res[:, :, None] if res.ndim == 2 else res


def _to_mode(img, channels: int):
    """A PIL image converted to "L" (one channel) or "RGB" (three)."""
    mode = "L" if channels == 1 else "RGB"
    return img if img.mode == mode else img.convert(mode)


def load_image_u8(path: str, target_height: int, target_width: int, channels: int,
                  pad_value: int = 255) -> np.ndarray:
    """Read an image file and fit it to the canvas, via Pillow.  A missing
    file raises ``FileNotFoundError``; any other error in reading it gives a
    zero canvas, as the JAX package's ``load_image_u8`` does."""
    Image = _pil()
    try:
        img = _to_mode(Image.open(path), channels)
        return array_to_canvas_u8(np.asarray(img, np.uint8), target_height, target_width, pad_value)
    except FileNotFoundError:
        raise
    except Exception:
        return np.zeros((target_height, target_width, channels), dtype=np.uint8)


def rgb_to_gray_u8(arr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W, 1) uint8 with the ITU-R 601 luma weights."""
    a = arr.astype(np.float32)
    gray = a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114
    return np.clip(gray + 0.5, 0, 255).astype(np.uint8)[..., None]


def prepare_image_u8(
    image, target_height: int, target_width: int, channels: int, pad_value: int = 255
) -> np.ndarray:
    """A path string, a PIL image (converted to "L" or "RGB" first) or an
    array (uint8 or float in [0, 1] / [-1, 1]; HW, HWC or CHW; 1 or 3
    channels) -> uint8 (H, W, C) canvas."""
    h, w, c = target_height, target_width, channels
    if isinstance(image, str):
        return load_image_u8(image, h, w, c, pad_value)
    if hasattr(image, "getbands"):  # a PIL image, known without importing Pillow
        image = _to_mode(image, c)
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        a = arr.astype(np.float32)
        if a.min() < 0:
            a = (a + 1.0) / 2.0
        arr = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = np.transpose(arr, (1, 2, 0))  # CHW -> HWC
    if arr.shape[2] == 1 and c == 3:
        arr = np.repeat(arr, 3, axis=2)
    if arr.shape[2] == 3 and c == 1:
        arr = rgb_to_gray_u8(arr)
    if arr.shape[:2] != (h, w):
        arr = array_to_canvas_u8(arr, h, w, pad_value)
    return arr


def _array_u8(image) -> np.ndarray:
    """An array input as uint8 (a float array in [0, 1] or [-1, 1] scaled as
    ``prepare_image_u8`` scales it), CHW turned to HWC."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        a = arr.astype(np.float32)
        if a.min() < 0:
            a = (a + 1.0) / 2.0
        arr = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = np.transpose(arr, (1, 2, 0))  # CHW -> HWC
    return arr


def pil_gray_u8(arr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) uint8 as Pillow's ``convert("L")`` computes
    it: ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``."""
    a = arr.astype(np.uint32)
    return ((a[..., 0] * 19595 + a[..., 1] * 38470 + a[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def _fit_width(arr: np.ndarray, width: int, pad_value: int) -> np.ndarray:
    """An (H, W, C) canvas at the model height padded on the right with
    ``pad_value`` or center-cropped to ``width``: Pillow's resize of an image
    to its own size is a copy, so this is ``resize_with_aspect_ratio`` there."""
    w = arr.shape[1]
    if w == width:
        return arr
    if w < width:
        out = np.full((arr.shape[0], width, arr.shape[2]), pad_value, dtype=np.uint8)
        out[:, :w] = arr
        return out
    left = (w - width) // 2
    return arr[:, left : left + width]


def prepare_image_at_width(image, target_height: int, canvas_width: int, channels: int,
                           pad_value: int = 255) -> np.ndarray:
    """Any accepted input -> uint8 (H, canvas_width, C) canvas, the geometry of
    the fixed canvas at a bucket's width (``Predictor._prepare_image_at_width``
    of the JAX package): the input converted as Pillow's ``convert("L")`` or
    ``convert("RGB")`` converts it, then fitted to the height keeping its
    aspect ratio and padded or cropped to the width.  A file that cannot be
    read gives a zero canvas.  An array of 1 or 3 channels at the model
    height needs no Pillow (module docstring)."""
    h, c = target_height, channels
    if isinstance(image, str):
        Image = _pil()
        try:
            arr = np.asarray(_to_mode(Image.open(image), c), np.uint8)
        except Exception:
            return np.zeros((h, canvas_width, c), dtype=np.uint8)
    elif hasattr(image, "getbands"):  # a PIL image
        arr = np.asarray(_to_mode(image, c), np.uint8)
    else:
        arr = _array_u8(image)
        if arr.ndim == 3 and arr.shape[2] == 1:
            arr = arr[:, :, 0]
        if arr.ndim == 3 and arr.shape[2] == 3:
            arr = pil_gray_u8(arr) if c == 1 else arr
        elif arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2) if c == 3 else arr
        else:  # 2 or 4 bands: Pillow's conversion
            arr = np.asarray(_to_mode(_pil().fromarray(arr), c), np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[0] == h:
        return np.ascontiguousarray(_fit_width(arr, canvas_width, pad_value))
    return array_to_canvas_u8(arr, h, canvas_width, pad_value)


def natural_size(image):
    """(width, height) of the raw input, or None where it cannot be had: a
    file's header (Pillow), a PIL image's size, an array's shape (CHW known
    as ``prepare_image_u8`` knows it)."""
    if isinstance(image, str):
        try:
            with _pil().open(image) as im:
                return im.size
        except Exception:
            return None
    if hasattr(image, "getbands"):
        return image.size
    shape = np.shape(image)
    if len(shape) in (2, 3):
        if len(shape) == 3 and shape[0] in (1, 3) and shape[-1] not in (1, 3):
            return shape[2], shape[1]  # CHW
        return shape[1], shape[0]
    return None


def assign_bucket(image, bucket_widths, target_height: int, full_width: int, stride: int,
                  margin: int):
    """The smallest bucket whose width holds the input's content, resized to
    ``target_height``, plus the white ``margin``; None for the full canvas.
    A bucket counts only where its width is a multiple of ``stride`` (the
    encoder's pooling) and its canvas (width + margin) is narrower than the
    full one."""
    size = natural_size(image)
    if size is None or size[1] == 0:
        return None
    nat_w = int(round(target_height * size[0] / size[1]))
    for bw in sorted(int(b) for b in bucket_widths):
        if bw % stride or bw + margin >= full_width:
            continue
        if nat_w + margin <= bw:
            return bw
    return None
