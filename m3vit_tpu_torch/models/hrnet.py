"""HRNet-W18-small-v2 backbone (counterpart of m3vit_tpu/models/hrnet.py:
23-126), NCHW.

The stem (two stride-2 3x3 convs, /4), stage 1 (bottlenecks at 64
channels, output 256), then stages 2-4 on [18, 36, 72, 144] channels with
(1, 3, 2) modules of two BasicBlocks a branch and a summing fusion.  The
forward returns the list of the four streams.  Modules take the JAX
package's names (``stem_conv1``, ``trans{nb}_{i}_conv``,
``stage{nb}_module{m}.fuse{i}_{j}_conv``, ...), stage 1's blocks
torchvision's ``layer1.{b}``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from m3vit_tpu_torch.models.heads import resize_bilinear
from m3vit_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    apply_bn,
    bn,
    conv,
    refuse_parallel,
)
from m3vit_tpu_torch.models.vit import conv2d


class HRModule(nn.Module):
    """hrnet.py:30-75: each branch's BasicBlocks, then the fusion: stream
    i sums every stream j brought to its resolution and channels (j > i:
    1x1 conv + BatchNorm, bilinear upsampling; j < i: i - j stride-2 3x3
    convs, each + BatchNorm, ReLU between them, none after the last),
    then a ReLU."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.channels = list(channels)
        nb = len(channels)
        for i, c in enumerate(channels):
            for b in range(num_blocks):
                setattr(self, f"branch{i}_block{b}",
                        BasicBlock(c, c, dtype=dtype))
        self.num_blocks = num_blocks
        for i in range(nb):
            for j in range(nb):
                if j > i:
                    setattr(self, f"fuse{i}_{j}_conv",
                            conv(channels[j], channels[i], 1))
                    setattr(self, f"fuse{i}_{j}_bn", bn(channels[i]))
                elif j < i:
                    for k in range(i - j):
                        ch = channels[i] if k == i - j - 1 else channels[j]
                        setattr(self, f"fuse{i}_{j}_ds{k}_conv",
                                conv(channels[j], ch, 3, 2))
                        setattr(self, f"fuse{i}_{j}_ds{k}_bn", bn(ch))

    def _cbn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return apply_bn(getattr(self, f"{name}_bn"), conv2d(
            getattr(self, f"{name}_conv"), x, self.dtype))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = []
        for i, x in enumerate(xs):
            for b in range(self.num_blocks):
                x = getattr(self, f"branch{i}_block{b}")(x)
            ys.append(x)
        nb = len(self.channels)
        outs = []
        for i in range(nb):
            acc = ys[i]
            for j in range(nb):
                if j > i:
                    h = resize_bilinear(self._cbn(f"fuse{i}_{j}", ys[j]),
                                        tuple(acc.shape[-2:]))
                elif j < i:
                    h = ys[j]
                    for k in range(i - j):
                        h = self._cbn(f"fuse{i}_{j}_ds{k}", h)
                        if k < i - j - 1:
                            h = F.relu(h)
                else:
                    continue
                acc = acc + h
            outs.append(F.relu(acc))
        return outs


class HighResolutionNet(nn.Module):
    """hrnet.py:78-122.  Transitions ``trans{nb}_{i}``: a stream whose
    channels change gets a 3x3 conv + BatchNorm + ReLU; a new stream is a
    stride-2 3x3 conv + BatchNorm + ReLU of the last old one."""

    def __init__(self, channels: Sequence[int] = (18, 36, 72, 144),
                 stage_modules: Sequence[int] = (1, 3, 2),
                 stage1_blocks: int = 2, num_blocks: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.channels = list(channels)
        self.stage_modules = list(stage_modules)
        self.stem_conv1 = conv(3, 64, 3, 2)
        self.stem_bn1 = bn(64)
        self.stem_conv2 = conv(64, 64, 3, 2)
        self.stem_bn2 = bn(64)
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if b == 0 else 256, 64, downsample=b == 0,
                       dtype=dtype) for b in range(stage1_blocks)])
        prev = [256]
        for s, n_modules in enumerate(stage_modules):
            nb = s + 2
            for i in range(nb):
                if i < len(prev):
                    if prev[i] != channels[i]:
                        self._transition(nb, i, prev[i], channels[i], 1)
                else:
                    self._transition(nb, i, prev[-1], channels[i], 2)
            for m in range(n_modules):
                setattr(self, f"stage{nb}_module{m}",
                        HRModule(channels[:nb], num_blocks, dtype))
            prev = list(channels[:nb])

    def _transition(self, nb: int, i: int, cin: int, cout: int, s: int):
        setattr(self, f"trans{nb}_{i}_conv", conv(cin, cout, 3, s))
        setattr(self, f"trans{nb}_{i}_bn", bn(cout))

    def _cbr(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.relu(apply_bn(getattr(self, f"{name}_bn"), conv2d(
            getattr(self, f"{name}_conv"), x, self.dtype)))

    def forward(self, x: torch.Tensor, task_id=None,
                noise=None) -> List[torch.Tensor]:
        """x [B, 3, H, W] -> the four streams, at /4, /8, /16 and /32;
        task_id and noise unused."""
        refuse_parallel("a CNN backbone")
        h = x
        for i in (1, 2):
            h = F.relu(apply_bn(getattr(self, f"stem_bn{i}"), conv2d(
                getattr(self, f"stem_conv{i}"), h, self.dtype)))
        xs = [self.layer1(h)]
        for s, n_modules in enumerate(self.stage_modules):
            nb = s + 2
            new = []
            for i in range(nb):
                name = f"trans{nb}_{i}"
                src = xs[i] if i < len(xs) else xs[-1]
                new.append(self._cbr(name, src) if hasattr(
                    self, f"{name}_conv") else src)
            xs = new
            for m in range(n_modules):
                xs = getattr(self, f"stage{nb}_module{m}")(xs)
        return xs


def hrnet_w18(dtype=torch.float32) -> HighResolutionNet:
    return HighResolutionNet(dtype=dtype)
