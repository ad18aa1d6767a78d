"""ResNet backbones with optional dilation and stage-wise access
(counterpart of m3vit_tpu/models/resnet.py:22-169), NCHW.

ResNet-18 (BasicBlock) and ResNet-50 (Bottleneck) feature extractors, no
pool or classifier; ``dilate_scale`` 8 or 16 turns the last stages' strides
into dilations as the reference's ResnetDilated does.  The stage-wise entry
points (``forward_stem``, ``forward_stage``, ``forward_stage_last_block``)
serve the MTL methods (Cross-Stitch, NDDR-CNN, MTAN).  Modules take
torchvision's names (``conv1``, ``bn1``, ``layer{s}.{b}.conv1``,
``layer{s}.{b}.downsample.0/.1``), so ImageNet weights in torchvision's
layout load by name.

The conventions of the CNN modules of the port live here too: convs are
bias-free with symmetric explicit padding d * (k // 2) (``conv``), their
weights f32 and cast to the compute dtype at use (``vit.conv2d``), kernels
drawn as flax's lecun_normal (``Conv2d.init_weights``); BatchNorm is eps
1e-5 in f32 with flax's momentum 0.9 (``bn``, applied by
``heads.batch_norm``, which folds the biased variance as flax does).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from m3vit_tpu_torch import parallel
from m3vit_tpu_torch.models.heads import batch_norm
from m3vit_tpu_torch.models.vit import conv2d


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax's lecun_normal: a normal of std sqrt(1 / fan_in) / .8796
    truncated at 2 std (the distribution of ``heads.init_conv_lecun``),
    drawn on the weight's device from `gen` (a generator there) by
    redrawing the draws beyond 2 std; fan_in = weight[0].numel()."""
    std = (1.0 / weight[0].numel()) ** 0.5 / 0.87962566103423978
    w = torch.empty(weight.shape, device=weight.device).normal_(
        generator=gen)
    bad = w.abs() > 2.0
    while bool(bad.any()):
        w[bad] = torch.empty(int(bad.sum()), device=w.device).normal_(
            generator=gen)
        bad = w.abs() > 2.0
    weight.copy_(w.mul_(std))


class Conv2d(nn.Conv2d):
    """nn.Conv2d with flax's init: lecun_normal kernel, zero bias.  The
    kernel is drawn by ``init_weights`` alone (the factory's seeded init),
    not first by torch's default as well."""

    def reset_parameters(self) -> None:
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def init_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.weight, gen)
        self.reset_parameters()


class Linear(nn.Linear):
    """nn.Linear with flax Dense's init: lecun_normal kernel, zero bias,
    drawn by ``init_weights`` alone, as for ``Conv2d``."""

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.bias)

    def init_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.weight, gen)
        self.reset_parameters()


def conv(cin: int, cout: int, k: int, s: int = 1, d: int = 1,
         groups: int = 1, bias: bool = False) -> Conv2d:
    """resnet.py:_conv: padding d * (k // 2) on every side (none for a 1x1;
    a 1x1 flax conv's SAME padding is none too), no bias unless asked."""
    return Conv2d(cin, cout, k, stride=s, padding=d * (k // 2), dilation=d,
                  groups=groups, bias=bias)


def bn(c: int) -> nn.BatchNorm2d:
    """resnet.py:_bn: flax BatchNorm momentum 0.9, eps 1e-5, f32."""
    return nn.BatchNorm2d(c, eps=1e-5)


def apply_bn(b: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in training or eval as `b` is, on x in f32."""
    return batch_norm(b, x.float(), b.training)


def refuse_parallel(what: str) -> None:
    """The CNN models do not train under a torch.distributed layout yet."""
    if parallel.active() is not None:
        raise NotImplementedError(
            f"{what} under torch.distributed is not ported to "
            f"m3vit_tpu_torch (ROADMAP.md queue 1 item 8b)")


class Downsample(nn.Sequential):
    """torchvision's ``downsample``: 1x1 conv (stride s) then BatchNorm."""

    def __init__(self, cin: int, cout: int, s: int):
        super().__init__(conv(cin, cout, 1, s), bn(cout))

    def forward(self, x, dtype=torch.float32):
        return apply_bn(self[1], conv2d(self[0], x, dtype))


class BasicBlock(nn.Module):
    """resnet.py:35-61.  dilation2: the second conv's dilation (0: as
    `dilation`); the first block of a dilated stage has dilation // 2 on
    its strided conv and the full dilation on the other (:40-43)."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1, dilation2: int = 0,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv(cin, features, 3, stride, dilation)
        self.bn1 = bn(features)
        self.conv2 = conv(features, features, 3, 1, dilation2 or dilation)
        self.bn2 = bn(features)
        self.downsample = Downsample(cin, features, stride) if downsample \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(apply_bn(self.bn1, conv2d(self.conv1, x, self.dtype)))
        h = apply_bn(self.bn2, conv2d(self.conv2, h, self.dtype))
        identity = x if self.downsample is None else \
            self.downsample(x, self.dtype)
        return F.relu(h + identity)


class Bottleneck(nn.Module):
    """resnet.py:64-85: 1x1, 3x3 (stride, dilation), 1x1 to features * 4."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv(cin, features, 1)
        self.bn1 = bn(features)
        self.conv2 = conv(features, features, 3, stride, dilation)
        self.bn2 = bn(features)
        self.conv3 = conv(features, features * 4, 1)
        self.bn3 = bn(features * 4)
        self.downsample = Downsample(cin, features * 4, stride) \
            if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(apply_bn(self.bn1, conv2d(self.conv1, x, self.dtype)))
        h = F.relu(apply_bn(self.bn2, conv2d(self.conv2, h, self.dtype)))
        h = apply_bn(self.bn3, conv2d(self.conv3, h, self.dtype))
        identity = x if self.downsample is None else \
            self.downsample(x, self.dtype)
        return F.relu(h + identity)


class ResNet(nn.Module):
    """Feature extractor (resnet.py:88-157): the stem (7x7 stride-2 conv,
    BatchNorm, ReLU, 3x3 stride-2 max-pool with padding 1) and four
    stages; forward returns the stage-4 map.  dilate_scale 0, 8 or 16."""

    def __init__(self, block: str = "basic",
                 layers: Sequence[int] = (2, 2, 2, 2), dilate_scale: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        blk = BasicBlock if block == "basic" else Bottleneck
        widths = (64, 128, 256, 512)
        dil, strides = [1, 1, 1, 1], [1, 2, 2, 2]
        if dilate_scale == 8:
            dil, strides = [1, 1, 2, 4], [1, 2, 1, 1]
        elif dilate_scale == 16:
            dil, strides = [1, 1, 1, 2], [1, 2, 2, 1]
        self.stage_channels = [w * blk.expansion for w in widths]
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = bn(64)
        cin = 64
        for si, (w, n) in enumerate(zip(widths, layers)):
            blocks = []
            for bi in range(n):
                stride = strides[si] if bi == 0 else 1
                d = dil[si]
                kw = dict(stride=stride,
                          dilation=max(d // 2, 1) if bi == 0 and d > 1 else d,
                          downsample=bi == 0 and (
                              stride != 1 or cin != w * blk.expansion),
                          dtype=dtype)
                if blk is BasicBlock and bi == 0 and d > 1:
                    kw["dilation2"] = d
                blocks.append(blk(cin, w, **kw))
                cin = w * blk.expansion
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))

    def stage(self, s: int) -> nn.Sequential:
        return getattr(self, f"layer{s + 1}")

    def forward_stem(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(apply_bn(self.bn1, conv2d(self.conv1, x, self.dtype)))
        # flax's nn.max_pool pads with -inf, as F.max_pool2d does
        return F.max_pool2d(h, 3, 2, 1)

    def forward_stage(self, x: torch.Tensor, s: int,
                      skip_last: bool = False) -> torch.Tensor:
        """Stage s (0-based); skip_last stops before its last block
        (MTAN's forward_stage_except_last_block)."""
        blocks = list(self.stage(s))
        for b in blocks[:len(blocks) - 1] if skip_last else blocks:
            x = b(x)
        return x

    def forward_stage_last_block(self, x: torch.Tensor,
                                 s: int) -> torch.Tensor:
        return self.stage(s)[-1](x)

    def forward(self, x: torch.Tensor, task_id=None,
                noise=None) -> torch.Tensor:
        """x [B, 3, H, W] -> the stage-4 map; task_id and noise unused."""
        refuse_parallel("a CNN backbone")
        h = self.forward_stem(x)
        for s in range(4):
            h = self.forward_stage(h, s)
        return h


def resnet18(dilated: bool = False, dtype=torch.float32) -> ResNet:
    return ResNet("basic", (2, 2, 2, 2), 8 if dilated else 0, dtype)


def resnet50(dilated: bool = False, dtype=torch.float32) -> ResNet:
    return ResNet("bottleneck", (3, 4, 6, 3), 8 if dilated else 0, dtype)
