"""CNN decode heads: DeepLab's ASPP and HRNet's fuse and head
(counterpart of m3vit_tpu/models/cnn_heads.py:20-98), NCHW.

A head is called as ``head(features, noise)``; ``noise`` is the
torch.Generator ASPP's training dropout draws its mask from
(``ops/dropout.py``).  Outputs are f32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from m3vit_tpu_torch.models.heads import resize_bilinear
from m3vit_tpu_torch.models.resnet import apply_bn, bn, conv
from m3vit_tpu_torch.models.vit import conv2d
from m3vit_tpu_torch.ops.dropout import dropout

#: ASPP's dropout rate in training (cnn_heads.py:44-45)
ASPP_DROPOUT = 0.5


class ASPP(nn.Module):
    """cnn_heads.py:20-46: a 1x1 branch, three 3x3 branches dilated by
    `atrous_rates`, and an image-pooling branch (the mean over H, W, a 1x1
    conv, then broadcast back, no resize), each conv + BatchNorm + ReLU;
    concatenated, projected by 1x1 conv + BatchNorm + ReLU, then dropout
    0.5 in training."""

    def __init__(self, cin: int, atrous_rates: Sequence[int] = (12, 24, 36),
                 out_channels: int = 256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.rates = list(atrous_rates)
        self.conv0 = conv(cin, out_channels, 1)
        self.bn0 = bn(out_channels)
        for i, rate in enumerate(self.rates):
            setattr(self, f"conv{i + 1}", conv(cin, out_channels, 3, 1, rate))
            setattr(self, f"bn{i + 1}", bn(out_channels))
        self.pool_conv = conv(cin, out_channels, 1)
        self.pool_bn = bn(out_channels)
        n = len(self.rates) + 2
        self.proj_conv = conv(out_channels * n, out_channels, 1)
        self.proj_bn = bn(out_channels)

    def _branch(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return F.relu(apply_bn(getattr(self, f"bn{i}"), conv2d(
            getattr(self, f"conv{i}"), x, self.dtype)))

    def forward(self, x: torch.Tensor,
                noise: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        res = [self._branch(i, x) for i in range(len(self.rates) + 1)]
        g = x.float().mean((2, 3), keepdim=True)
        g = F.relu(apply_bn(self.pool_bn,
                            conv2d(self.pool_conv, g, self.dtype)))
        res.append(g.expand_as(res[0]))
        h = F.relu(apply_bn(self.proj_bn, conv2d(
            self.proj_conv, torch.cat(res, 1), self.dtype)))
        if self.training:
            h = dropout(h, ASPP_DROPOUT, noise, mask)
        return h


class DeepLabHead(nn.Module):
    """cnn_heads.py:49-59: ASPP, 3x3 conv + BatchNorm + ReLU, 1x1
    classifier (with bias)."""

    def __init__(self, cin: int, num_classes: int = 21, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.aspp = ASPP(cin, dtype=dtype)
        self.conv = conv(256, 256, 3)
        self.bn = bn(256)
        self.classifier = conv(256, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor,
                noise: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.aspp(x, noise)
        h = F.relu(apply_bn(self.bn, conv2d(self.conv, h, self.dtype)))
        return conv2d(self.classifier, h, self.dtype).float()


def fuse_streams(xs: List[torch.Tensor]) -> torch.Tensor:
    """cnn_heads.py:62-68: every stream upsampled to the first's size,
    concatenated along the channels."""
    hw = tuple(xs[0].shape[-2:])
    return torch.cat([xs[0]] + [resize_bilinear(x, hw) for x in xs[1:]], 1)


class HighResolutionFuse(nn.Module):
    """cnn_heads.py:71-81: the streams fused at the highest resolution,
    then 1x1 conv + BatchNorm + ReLU over their channels."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = conv(channels, channels, 1)
        self.bn = bn(channels)

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        h = fuse_streams(list(xs))
        return F.relu(apply_bn(self.bn, conv2d(self.conv, h, self.dtype)))


class HighResolutionHead(nn.Module):
    """cnn_heads.py:84-98: the streams fused (a list; a map is taken as
    is), 1x1 conv + BatchNorm + ReLU, 1x1 conv (with bias) to the
    classes."""

    def __init__(self, channels: int, num_classes: int = 21,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = conv(channels, channels, 1)
        self.bn0 = bn(channels)
        self.conv1 = conv(channels, num_classes, 1, bias=True)

    def forward(self, xs: Union[torch.Tensor, List[torch.Tensor]],
                noise: Optional[torch.Generator] = None) -> torch.Tensor:
        h = fuse_streams(list(xs)) if isinstance(xs, (list, tuple)) else xs
        h = F.relu(apply_bn(self.bn0, conv2d(self.conv0, h, self.dtype)))
        return conv2d(self.conv1, h, self.dtype).float()
