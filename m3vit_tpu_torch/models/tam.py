"""TAM, task-attention fusion over the per-task decoder features
(counterpart of m3vit_tpu/models/tam.py:37-107; reference
models/models.py:11-134).

The tasks' features are concatenated; a conv/BN/ReLU, conv/BN/sigmoid gate
B weighs each task's features by B or 1 - B (the reference's hand-unrolled
per-task multipliers); a conv/BN/ReLU refines them; an encoder of two
stride-2 conv/BN/ReLU and a decoder of two ConvTranspose2d(k=3, s=2, p=1,
output_padding=1)/BN (ReLU, then sigmoid) give the modulation M; each task
reads its output from the features times 1 + M through a conv/BN/ReLU of
256 channels and a 1x1 conv.  Everything runs in f32, as the JAX
package's TamModule (dtype f32), and its BatchNorms are those of the PUP
heads (``heads.batch_norm``).  Parameters are named like the reference's
(``layers0.0`` conv, ``layers0.1`` BatchNorm, ..., ``layers3.{task}.0``,
``layers4.{task}.0``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from m3vit_tpu_torch.models.heads import batch_norm, init_conv_lecun


def tam_gate_weights(n: int):
    """Each task's multiplier of B ("b") or 1 - B ("nb") in the gated
    concat (tam.py:22-34; reference models.py:96-103)."""
    if n == 2:
        return [("b", 1.0), ("nb", 1.0)]
    if n == 3:
        return [("b", 1.0), ("nb", 0.5), ("nb", 0.5)]
    if n == 4:
        return [("b", 0.5), ("b", 0.5), ("nb", 0.5), ("nb", 0.5)]
    if n == 5:
        return [("b", 0.5), ("b", 0.5), ("nb", 1 / 3), ("nb", 1 / 3),
                ("nb", 1 / 3)]
    raise NotImplementedError(f"TAM supports 2-5 tasks, got {n}")


def _conv_bn(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1),
                         nn.BatchNorm2d(cout, eps=1e-5))


def _deconv_bn(c: int) -> nn.Sequential:
    return nn.Sequential(nn.ConvTranspose2d(c, c, 3, 2, 1, output_padding=1),
                         nn.BatchNorm2d(c, eps=1e-5))


class TamModule(nn.Module):
    def __init__(self, tasks: Sequence[str], input_channels: int,
                 num_outputs: Dict[str, int]):
        super().__init__()
        self.tasks = list(tasks)
        self.weights = tam_gate_weights(len(self.tasks))
        n, ic = len(self.tasks), input_channels
        self.layers0 = _conv_bn(n * ic, ic)
        self.layers1 = _conv_bn(ic, ic)
        self.layers2 = _conv_bn(n * ic, ic)
        self.encoder0 = _conv_bn(ic, ic, 2)
        self.encoder1 = _conv_bn(ic, ic, 2)
        self.decoder0 = _deconv_bn(ic)
        self.decoder1 = _deconv_bn(ic)
        self.layers3 = nn.ModuleDict(
            {t: _conv_bn(n * ic, 256) for t in self.tasks})
        self.layers4 = nn.ModuleDict(
            {t: nn.Sequential(nn.Conv2d(256, num_outputs[t], 1))
             for t in self.tasks})

    def init_weights(self, gen: torch.Generator) -> None:
        """flax's conv and transposed-conv init (lecun_normal over
        kh*kw*in, zero bias); BatchNorm scale 1, bias 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_conv_lecun(m.weight, m.weight[0].numel(), gen)
            elif isinstance(m, nn.ConvTranspose2d):
                init_conv_lecun(m.weight, m.weight[:, 0].numel(), gen)
            else:
                continue
            nn.init.zeros_(m.bias)

    def _stage(self, seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        conv, bn = seq[0], seq[1]
        if isinstance(conv, nn.ConvTranspose2d):
            y = F.conv_transpose2d(x, conv.weight, conv.bias, 2, 1, 1)
        else:
            y = F.conv2d(x, conv.weight, conv.bias, conv.stride, 1)
        return batch_norm(bn, y, self.training)

    def forward(self, deep_features: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """{task: [B, ic, h, w]} -> {task: [B, num_outputs, h, w] f32}; h
        and w divisible by 4."""
        feats = [deep_features[t].float() for t in self.tasks]
        x = torch.cat(feats, dim=1)
        h = F.relu(self._stage(self.layers0, x))
        gate = torch.sigmoid(self._stage(self.layers1, h))
        fb = torch.cat([f * (gate if kind == "b" else 1.0 - gate) * w
                        for (kind, w), f in zip(self.weights, feats)], dim=1)
        h = F.relu(self._stage(self.layers2, fb))
        h = F.relu(self._stage(self.encoder0, h))
        h = F.relu(self._stage(self.encoder1, h))
        h = F.relu(self._stage(self.decoder0, h))
        mod = torch.sigmoid(self._stage(self.decoder1, h))
        ftam = torch.cat([f * (1.0 + mod) for f in feats], dim=1)
        out = {}
        for t in self.tasks:
            h = F.relu(self._stage(self.layers3[t], ftam))
            conv = self.layers4[t][0]
            out[t] = F.conv2d(h, conv.weight, conv.bias)
        return out
