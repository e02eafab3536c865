"""On-device image normalization (counterpart of ``img2latex_tpu/ops/preprocess.py``).

uint8 NHWC batches go to the device and are normalized there:

* grayscale (C=1): ``x/255 * 2 - 1`` -> [-1, 1];
* RGB (C=3): ``(x/255 - mean) / std``;
* :func:`grayscale_to_rgb` tiles a 1-channel batch to the ResNet's 3.

The arithmetic runs in the compute type, in the same order as the JAX
function, so both round alike.
"""

from __future__ import annotations

from typing import Sequence

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(
    images_u8: torch.Tensor,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 (B, H, W, C) -> normalized float (B, H, W, C) in ``dtype``."""
    x = images_u8.to(dtype) * (1.0 / 255.0)
    if images_u8.shape[-1] == 1:
        return x * 2.0 - 1.0
    m = torch.tensor(mean, dtype=dtype, device=x.device)
    s = torch.tensor(std, dtype=dtype, device=x.device)
    return (x - m) / s


def grayscale_to_rgb(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) -> (B, H, W, 3) by channel replication; RGB as it is."""
    if images.shape[-1] == 3:
        return images
    return images.expand(*images.shape[:-1], 3)
