"""ResNet backbone, 18 to 152 (counterpart of ``img2latex_tpu/models/resnet.py``).

torchvision's architecture, written out by hand: a 7x7/2 stem conv with
padding 3, BatchNorm, ReLU and a 3x3/2 max pool over -inf padding of 1,
then four stages of basic (18, 34) or bottleneck (50, 101, 152) blocks whose
first block strides by 2 from stage 2 on, with a 1x1 projection where the
shape changes.  No pool and no classifier: the encoder's head takes layer4's
map.  Tensors are NCHW; an NHWC input permuted to NCHW keeps channels-last
strides, which cuDNN's convolutions keep in turn.

Module names follow the flax tree (``conv1``, ``bn1``, ``layer{s}_{b}``,
``downsample_conv``, ``downsample_bn``), so :mod:`img2latex_tpu_torch.bridge`
and :mod:`img2latex_tpu_torch.models.pretrained` map paths one to one.

:class:`BatchNorm` is ``flax.linen.BatchNorm`` (momentum 0.9, epsilon 1e-5),
not ``nn.BatchNorm2d``: batch statistics in float32 as ``max(0, E[x^2] -
E[x]^2)``, the biased variance in the running buffer, ``ra = 0.9 ra + 0.1
batch``, and ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32,
rounded once to the compute type.  Train mode is the ``train`` argument of
``forward``, not ``Module.training``.  Convolutions keep float32 weights
and compute in ``dtype``, as flax's ``dtype`` / ``param_dtype`` do.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

STAGE_SIZES = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
BOTTLENECK = {"resnet18": False, "resnet34": False, "resnet50": True, "resnet101": True, "resnet152": True}
FEATURE_DIM = {"resnet18": 512, "resnet34": 512, "resnet50": 2048, "resnet101": 2048, "resnet152": 2048}

MOMENTUM = 0.9
EPSILON = 1e-5


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the channel axis of NCHW (module docstring)."""

    def __init__(self, num_features: int, momentum: float = MOMENTUM, eps: float = EPSILON):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))  # flax batch_stats "mean"
        self.register_buffer("running_var", torch.ones(num_features))  # "var", biased

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # float32 at least, as flax
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var + (1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


def _apply_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, 1, 1)
        self.bn2 = BatchNorm(filters)
        if downsample:
            self.downsample_conv = _conv(cin, filters, 1, stride)
            self.downsample_bn = BatchNorm(filters)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(_apply_conv(self.conv1, x), train))
        y = self.bn2(_apply_conv(self.conv2, y), train)
        residual = self.downsample_bn(_apply_conv(self.downsample_conv, x), train) if self.downsample else x
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, stride, 1)
        self.bn2 = BatchNorm(filters)
        self.conv3 = _conv(filters, filters * 4, 1)
        self.bn3 = BatchNorm(filters * 4)
        if downsample:
            self.downsample_conv = _conv(cin, filters * 4, 1, stride)
            self.downsample_bn = BatchNorm(filters * 4)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(_apply_conv(self.conv1, x), train))
        y = F.relu(self.bn2(_apply_conv(self.conv2, y), train))
        y = self.bn3(_apply_conv(self.conv3, y), train)
        residual = self.downsample_bn(_apply_conv(self.downsample_conv, x), train) if self.downsample else x
        return F.relu(y + residual)


class ResNetBackbone(nn.Module):
    """The feature extractor up to and including layer4."""

    def __init__(self, model_name: str = "resnet50", in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if model_name not in STAGE_SIZES:
            raise ValueError(f"Unknown ResNet variant: {model_name}")
        self.model_name = model_name
        self.dtype = dtype
        block_cls = Bottleneck if BOTTLENECK[model_name] else BasicBlock
        self.conv1 = _conv(in_channels, 64, 7, 2, 3)
        self.bn1 = BatchNorm(64)
        self.block_names: List[str] = []
        cin = 64
        for stage, num_blocks in enumerate(STAGE_SIZES[model_name]):
            filters = 64 * 2**stage
            for block in range(num_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                needs_proj = stride != 1 or cin != filters * block_cls.expansion
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, block_cls(cin, filters, stride, needs_proj))
                self.block_names.append(name)
                cin = filters * block_cls.expansion

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x (B, H, W, C) float NHWC -> layer4's map (B, F, H', W') NCHW."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(_apply_conv(self.conv1, x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return x


def feature_dim(model_name: str) -> int:
    return FEATURE_DIM[model_name]


def feature_hw(height: int, width: int) -> Tuple[int, int]:
    """(H', W') of layer4's map: five stride-2 steps (stem conv, pool, the
    first blocks of stages 2-4), each ``ceil(n / 2)`` at these paddings."""
    for _ in range(5):
        height, width = (height + 1) // 2, (width + 1) // 2
    return height, width


def receptive_field(model_name: str) -> int:
    """Receptive field in pixels, one axis, of a layer4 position: ``1 +
    sum((k - 1) * jump)`` over the conv and pool chain, ``jump`` the product
    of the strides before (1x1 convs add nothing)."""
    convs_per_block = 1 if BOTTLENECK[model_name] else 2
    rf, jump = 1, 1
    rf += 6 * jump  # conv1 7x7 stride 2
    jump *= 2
    rf += 2 * jump  # max pool 3x3 stride 2
    jump *= 2
    for stage, num_blocks in enumerate(STAGE_SIZES[model_name]):
        for block in range(num_blocks):
            strided = stage > 0 and block == 0
            for conv in range(convs_per_block):
                rf += 2 * jump  # every counted conv is 3x3
                if conv == 0 and strided:
                    jump *= 2
    return rf
