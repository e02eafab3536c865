"""Host-side image geometry: any accepted input -> uint8 (H, W, C) canvas.

The counterpart of ``img2latex_tpu/data/transforms.py``.  Arrays already at
canvas size need numpy only (dtype, HW/HWC/CHW and gray/RGB handling, as in
``prepare_image_u8`` there).  Resizing an off-size image, or reading a file,
uses Pillow, which is imported inside those functions only and raises a
clear error where it is missing.  Normalization is not done here: it runs on
the device (:mod:`img2latex_tpu_torch.ops.preprocess`).
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


def load_image_u8(path: str, target_height: int, target_width: int, channels: int,
                  pad_value: int = 255) -> np.ndarray:
    """Read an image file and fit it to the canvas, via Pillow."""
    Image = _pil()
    img = Image.open(path)
    mode = "L" if channels == 1 else "RGB"
    if img.mode != mode:
        img = img.convert(mode)
    return array_to_canvas_u8(np.asarray(img, np.uint8), target_height, target_width, pad_value)


def rgb_to_gray_u8(arr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W, 1) uint8 with the ITU-R 601 luma weights."""
    a = arr.astype(np.float32)
    gray = a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114
    return np.clip(gray + 0.5, 0, 255).astype(np.uint8)[..., None]


def prepare_image_u8(
    image, target_height: int, target_width: int, channels: int, pad_value: int = 255
) -> np.ndarray:
    """A path string or an array (uint8 or float in [0, 1] / [-1, 1]; HW, HWC
    or CHW; 1 or 3 channels) -> uint8 (H, W, C) canvas."""
    h, w, c = target_height, target_width, channels
    if isinstance(image, str):
        return load_image_u8(image, h, w, c, pad_value)
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
