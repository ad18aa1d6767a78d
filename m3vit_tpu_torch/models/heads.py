"""PUP decode head, eval and train (counterpart of m3vit_tpu/models/heads.py).

LN -> 2-D reshape -> 4x(conv3x3 + BN + ReLU, 2x bilinear upsample between)
-> 1x1 conv -> 2x bilinear upsample (reference models/heads/vit_up_head.py);
with return_tam_features, in training, also the three features TAM reads.
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

from m3vit_tpu_torch import parallel
from m3vit_tpu_torch.models.vit import _hooked, conv2d, layer_norm

#: flax BatchNorm momentum 0.9 (running = 0.9 running + 0.1 batch) is
#: torch's momentum 0.1 (heads.py:59-60)
BN_MOMENTUM = 0.1


def init_conv_lecun(weight: torch.Tensor, fan_in: int,
                    gen: torch.Generator) -> None:
    """flax's default conv kernel init: lecun_normal (truncated at 2 std)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        w = torch.empty(weight.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        weight.copy_(w)


def sync_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Training BatchNorm over the global batch of a data-parallel run: the
    per-channel sum, then the sum of squared deviations from the global
    mean, each summed over the world differentiably (parallel.
    world_sum_grad), in f32; folds the global *biased* variance as flax
    does (a SyncBN of the JAX package's global-batch semantics).  Every
    rank holds as many images (the train sampler's shards, the eval's
    padded global batches)."""
    xf = x.float()
    dims = [0] + list(range(2, x.ndim))
    n = float(x.numel() // x.shape[1] * parallel.world_size())
    mean = parallel.world_sum_grad(xf.sum(dims)) / n
    shape = (1, -1) + (1,) * (x.ndim - 2)
    xc = xf - mean.reshape(shape)
    var = parallel.world_sum_grad((xc * xc).sum(dims)) / n
    y = xc * (torch.rsqrt(var + bn.eps) * bn.weight).reshape(shape) \
        + bn.bias.reshape(shape)
    with torch.no_grad():
        bn.running_mean.lerp_(mean, BN_MOMENTUM)
        bn.running_var.lerp_(var, BN_MOMENTUM)
        bn.num_batches_tracked.add_(1)
    return y


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor,
               training: bool) -> torch.Tensor:
    """flax BatchNorm(momentum 0.9, dtype f32) with `bn`'s parameters and
    statistics, eps bn.eps: in eval by the running statistics (on x in
    f32); in training by the batch's, computed in f32 (a bf16 input is
    normalised in f32 and rounded once), folding the batch's *biased*
    variance into running_var as flax does, where torch.nn.BatchNorm2d
    folds the unbiased one.  Under data parallelism the statistics are
    the global batch's (``sync_batch_norm``)."""
    return _hooked(bn, x, _batch_norm(bn, x, training))


def _batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor,
                training: bool) -> torch.Tensor:
    if not training:
        return F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, False, 0.0, bn.eps)
    if parallel.active() is not None:
        return sync_batch_norm(bn, x)
    # F.batch_norm folds the batch statistics into copies (autograd keeps
    # the tensors it was given); torch folds var * n / (n - 1) into
    # running_var, flax the biased var: undo the factor when copying back
    n = x.numel() // x.shape[1]
    mean, var = bn.running_mean.clone(), bn.running_var.clone()
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, BN_MOMENTUM,
                     bn.eps)
    with torch.no_grad():
        kept = (1.0 - BN_MOMENTUM) * bn.running_var
        bn.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
        bn.running_mean.copy_(mean)
        bn.num_batches_tracked.add_(1)
    return y


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """align_corners=False bilinear resize of NCHW x (heads.py:21-26); for
    these upsamplings it matches jax.image.resize."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


class VisionTransformerUpHead(nn.Module):
    """heads.py:29-101, num_conv = num_upsample_layer = 4.  BatchNorm, eps
    1e-5, normalises in f32 (``batch_norm``) and its output is cast to the
    compute dtype at once.  With return_tam_features a forward in training
    returns (prediction, f0, f1, f2), the ReLU outputs of the second, third
    and fourth conv stages (heads.py:85-100)."""

    def __init__(self, img_size=(512, 512), patch_size: int = 16,
                 embed_dim: int = 384, num_classes: int = 21,
                 dtype=torch.float32, return_tam_features: bool = False):
        super().__init__()
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.dtype = dtype
        self.return_tam_features = return_tam_features
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
            init_conv_lecun(conv.weight, conv.weight[0].numel(), gen)
            nn.init.zeros_(conv.bias)

    def _bn_relu(self, i: int, x: torch.Tensor) -> torch.Tensor:
        y = batch_norm(getattr(self, f"syncbn_fc_{i}"), x, self.training)
        return F.relu(y.to(self.dtype))

    def forward(self, x: torch.Tensor):
        """x [B, N, C] tokens -> [B, num_classes, H, W] f32 (with the TAM
        features in training when return_tam_features)."""
        h = self.img_size[0] // self.patch_size
        w = self.img_size[1] // self.patch_size
        if x.shape[1] % 48 != 0:  # drop cls tokens when present
            x = x[:, x.shape[1] - h * w:]
        x = layer_norm(self.norm, x)
        B, _, C = x.shape
        x = x.reshape(B, h, w, C).permute(0, 3, 1, 2).to(self.dtype)
        taps = []
        for i in range(4):
            if i:
                x = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))
            x = self._bn_relu(i, conv2d(getattr(self, f"conv_{i}"), x,
                                        self.dtype))
            taps.append(x)
        x = conv2d(self.conv_4, x, self.dtype)
        x = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2)).float()
        if self.return_tam_features and self.training:
            return (x, *taps[1:])
        return x
