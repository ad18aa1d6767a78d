"""MobileNetV3, large and small, as a feature extractor (counterpart of
m3vit_tpu/models/mobilenetv3.py:21-150), NCHW: inverted residual blocks
with squeeze-excite and h-swish, returning the last feature map (no pool,
no classifier).  Modules take the JAX package's names (``stem``,
``block{i}.expand`` / ``dw`` / ``se.fc1`` / ``project``, ``head_conv``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from m3vit_tpu_torch.models.resnet import (
    apply_bn,
    bn,
    conv,
    refuse_parallel,
)
from m3vit_tpu_torch.models.vit import conv2d


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def h_swish(x: torch.Tensor) -> torch.Tensor:
    return x * h_sigmoid(x)


class Cfg(NamedTuple):
    kernel: int
    expand: int
    out: int
    se: bool
    act: str  # 'relu' | 'hswish'
    stride: int


LARGE = [
    Cfg(3, 16, 16, False, "relu", 1),
    Cfg(3, 64, 24, False, "relu", 2),
    Cfg(3, 72, 24, False, "relu", 1),
    Cfg(5, 72, 40, True, "relu", 2),
    Cfg(5, 120, 40, True, "relu", 1),
    Cfg(5, 120, 40, True, "relu", 1),
    Cfg(3, 240, 80, False, "hswish", 2),
    Cfg(3, 200, 80, False, "hswish", 1),
    Cfg(3, 184, 80, False, "hswish", 1),
    Cfg(3, 184, 80, False, "hswish", 1),
    Cfg(3, 480, 112, True, "hswish", 1),
    Cfg(3, 672, 112, True, "hswish", 1),
    Cfg(5, 672, 160, True, "hswish", 2),
    Cfg(5, 960, 160, True, "hswish", 1),
    Cfg(5, 960, 160, True, "hswish", 1),
]

SMALL = [
    Cfg(3, 16, 16, True, "relu", 2),
    Cfg(3, 72, 24, False, "relu", 2),
    Cfg(3, 88, 24, False, "relu", 1),
    Cfg(5, 96, 40, True, "hswish", 2),
    Cfg(5, 240, 40, True, "hswish", 1),
    Cfg(5, 240, 40, True, "hswish", 1),
    Cfg(5, 120, 48, True, "hswish", 1),
    Cfg(5, 144, 48, True, "hswish", 1),
    Cfg(5, 288, 96, True, "hswish", 2),
    Cfg(5, 576, 96, True, "hswish", 1),
    Cfg(5, 576, 96, True, "hswish", 1),
]

#: the last feature map's channels (mobilenetv3.py:146)
OUT_CHANNELS = {"large": 960, "small": 576}


def _make_divisible(v, divisor: int = 8) -> int:
    """The nearest multiple of `divisor`, never below 90% of v
    (mobilenetv3.py:71-77)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcite(nn.Module):
    """mobilenetv3.py:80-91: the channel means, 1x1 conv, ReLU, 1x1 conv,
    h-sigmoid, scaling x."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        hidden = _make_divisible(channels // 4)
        self.fc1 = conv(channels, hidden, 1, bias=True)
        self.fc2 = conv(hidden, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        s = F.relu(conv2d(self.fc1, s, self.dtype))
        return x * h_sigmoid(conv2d(self.fc2, s, self.dtype))


class InvertedResidual(nn.Module):
    """mobilenetv3.py:94-131: 1x1 expand + BatchNorm + act (when the
    expansion differs from the input's channels), depthwise conv +
    BatchNorm, squeeze-excite and act (SE before the act in an expanded
    block, after it otherwise), 1x1 projection + BatchNorm, and the
    residual at stride 1 with equal channels."""

    def __init__(self, cin: int, cfg: Cfg, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.expanded = cfg.expand != cin
        self.residual = cfg.stride == 1 and cin == cfg.out
        if self.expanded:
            self.expand = conv(cin, cfg.expand, 1)
            self.expand_bn = bn(cfg.expand)
        self.dw = conv(cfg.expand, cfg.expand, cfg.kernel, cfg.stride,
                       groups=cfg.expand)
        self.dw_bn = bn(cfg.expand)
        if cfg.se:
            self.se = SqueezeExcite(cfg.expand, dtype)
        self.project = conv(cfg.expand, cfg.out, 1)
        self.project_bn = bn(cfg.out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        act = F.relu if c.act == "relu" else h_swish
        h = x
        if self.expanded:
            h = act(apply_bn(self.expand_bn,
                             conv2d(self.expand, h, self.dtype)))
        h = apply_bn(self.dw_bn, conv2d(self.dw, h, self.dtype))
        if self.expanded:
            h = act(self.se(h) if c.se else h)
        else:
            h = act(h)
            if c.se:
                h = self.se(h)
        h = apply_bn(self.project_bn, conv2d(self.project, h, self.dtype))
        return h + x if self.residual else h


class MobileNetV3(nn.Module):
    """mobilenetv3.py:134-150: stem (3x3 stride-2 conv to 16, BatchNorm,
    h-swish), the variant's blocks, 1x1 head conv + BatchNorm + h-swish to
    960 (large) or 576 (small) channels."""

    def __init__(self, variant: str = "large", dtype=torch.float32):
        super().__init__()
        if variant not in OUT_CHANNELS:
            raise ValueError(f"MobileNetV3 variant {variant!r}: large or "
                             f"small")
        self.dtype = dtype
        self.out_channels = OUT_CHANNELS[variant]
        self.stem = conv(3, 16, 3, 2)
        self.stem_bn = bn(16)
        cin = 16
        cfgs = LARGE if variant == "large" else SMALL
        self.num_blocks = len(cfgs)
        for i, cfg in enumerate(cfgs):
            setattr(self, f"block{i}", InvertedResidual(cin, cfg, dtype))
            cin = cfg.out
        self.head_conv = conv(cin, self.out_channels, 1)
        self.head_bn = bn(self.out_channels)

    def forward(self, x: torch.Tensor, task_id=None,
                noise=None) -> torch.Tensor:
        """x [B, 3, H, W] -> the /32 feature map; task_id and noise
        unused."""
        refuse_parallel("a CNN backbone")
        h = h_swish(apply_bn(self.stem_bn,
                             conv2d(self.stem, x, self.dtype)))
        for i in range(self.num_blocks):
            h = getattr(self, f"block{i}")(h)
        return h_swish(apply_bn(self.head_bn,
                                conv2d(self.head_conv, h, self.dtype)))
