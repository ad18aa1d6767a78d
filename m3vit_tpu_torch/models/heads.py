"""PUP decode head, eval and train (counterpart of m3vit_tpu/models/heads.py).

LN -> 2-D reshape -> 4x(conv3x3 + BN + ReLU, 2x bilinear upsample between)
-> 1x1 conv -> 2x bilinear upsample (reference models/heads/vit_up_head.py).
NCHW tensors in channels_last memory: the [B, h, w, C] token grid permuted
to NCHW is already channels_last, so no copy is made.  Conv weights are f32
and cast to the compute dtype at use.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from m3vit_tpu_torch.models.vit import conv2d, layer_norm

#: flax BatchNorm momentum 0.9 (running = 0.9 running + 0.1 batch) is
#: torch's momentum 0.1 (heads.py:59-60)
BN_MOMENTUM = 0.1


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """align_corners=False bilinear resize of NCHW x (heads.py:21-26); for
    these upsamplings it matches jax.image.resize."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


class VisionTransformerUpHead(nn.Module):
    """heads.py:29-101, num_conv = num_upsample_layer = 4.  BatchNorm, eps
    1e-5, normalises in f32 and its output is cast to the compute dtype at
    once: in eval by its running statistics; in training by the batch's,
    folding the batch's *biased* variance into running_var as flax does
    (torch.nn.BatchNorm2d folds the unbiased one)."""

    def __init__(self, img_size=(512, 512), patch_size: int = 16,
                 embed_dim: int = 384, num_classes: int = 21,
                 dtype=torch.float32):
        super().__init__()
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.dtype = dtype
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        chans = [embed_dim, 256, 256, 256, 256]
        for i in range(4):
            setattr(self, f"conv_{i}", nn.Conv2d(chans[i], 256, 3, padding=1))
            setattr(self, f"syncbn_fc_{i}", nn.BatchNorm2d(256, eps=1e-5))
        self.conv_4 = nn.Conv2d(256, num_classes, 1)

    def init_weights(self, gen: torch.Generator) -> None:
        # flax Conv default: lecun_normal kernel (truncated), zero bias
        for i in range(5):
            conv = getattr(self, f"conv_{i}")
            fan_in = conv.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                w = torch.empty(conv.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                conv.weight.copy_(w)
            nn.init.zeros_(conv.bias)

    def _bn_relu(self, i: int, x: torch.Tensor) -> torch.Tensor:
        bn = getattr(self, f"syncbn_fc_{i}")
        if not self.training:
            y = F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, False, 0.0, bn.eps)
            return F.relu(y.to(self.dtype))
        # batch statistics in f32 (a bf16 input is normalised in f32 and
        # rounded once).  F.batch_norm folds the batch statistics into
        # copies (autograd keeps the tensors it was given); torch folds
        # var * n / (n - 1) into running_var, flax the biased var: undo the
        # factor when copying back
        n = x.numel() // x.shape[1]
        mean, var = bn.running_mean.clone(), bn.running_var.clone()
        y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, BN_MOMENTUM,
                         bn.eps)
        with torch.no_grad():
            kept = (1.0 - BN_MOMENTUM) * bn.running_var
            bn.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
            bn.running_mean.copy_(mean)
            bn.num_batches_tracked.add_(1)
        return F.relu(y.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, N, C] tokens -> [B, num_classes, H, W] f32."""
        h = self.img_size[0] // self.patch_size
        w = self.img_size[1] // self.patch_size
        if x.shape[1] % 48 != 0:  # drop cls tokens when present
            x = x[:, x.shape[1] - h * w:]
        x = layer_norm(self.norm, x)
        B, _, C = x.shape
        x = x.reshape(B, h, w, C).permute(0, 3, 1, 2).to(self.dtype)
        for i in range(4):
            if i:
                x = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))
            x = self._bn_relu(i, conv2d(getattr(self, f"conv_{i}"), x,
                                        self.dtype))
        x = conv2d(self.conv_4, x, self.dtype)
        x = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))
        return x.float()
