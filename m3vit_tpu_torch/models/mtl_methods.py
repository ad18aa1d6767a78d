"""The classic multi-task baselines: Cross-Stitch, NDDR-CNN, MTAN, PAD-Net
and MTI-Net (counterpart of m3vit_tpu/models/mtl_methods.py:23-454), NCHW.

Every model's forward is ``model(x, single_task=None, noise=None)`` and
returns ``(pred, cv, stats)`` as the other models of the port do, cv 0 and
stats empty; it computes every task whatever `single_task` says, as the
JAX models do.  ``pred`` holds each task's output resized to the input;
in training PAD-Net also returns ``initial_{task}`` and MTI-Net
``deep_supervision`` (``{"scale_{i}": {task: prediction}}``), which its
loss scheme reads (``losses/schemes.py``).  ``noise`` is the generator
the heads' training dropout draws from.  The layers these methods add
compute in f32, as the JAX modules without a dtype do; the backbones and
heads in the model's dtype.  Modules take the JAX package's names
(``stitch_stage{s}.stitch_{ti}_{tj}``, ``nddr_stage{s}.conv_{task}``,
``attention_{s}_{task}``, ``refine_{s}.bottleneck``, ``initial.b1_{task}``,
``distillation.sa_{t}_{a}``, ``scale_{i}``, ``fpm_{i}``, ``dist_{i}``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from m3vit_tpu_torch.models.heads import resize_bilinear
from m3vit_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    Linear,
    ResNet,
    apply_bn,
    conv,
    refuse_parallel,
)
from m3vit_tpu_torch.models.vit import conv2d, linear

#: the methods' own layers compute in f32, as the JAX modules without a
#: dtype do
F32 = torch.float32


def _zero_cv(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), device=x.device)


def _heads_out(heads: nn.ModuleDict, feats: Dict[str, torch.Tensor],
               tasks: Sequence[str], size, noise) -> Dict[str, torch.Tensor]:
    return {t: resize_bilinear(heads[t](feats[t], noise), size)
            for t in tasks}


class SEBlock(nn.Module):
    """Squeeze-and-excitation (mtl_methods.py:27-41): the channel means,
    dense to C // r, ReLU, dense to C, sigmoid, scaling x."""

    def __init__(self, channels: int, r: int = 16):
        super().__init__()
        self.fc1 = Linear(channels, channels // r)
        self.fc2 = Linear(channels // r, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(linear(self.fc1, x.mean((2, 3)), F32))
        s = torch.sigmoid(linear(self.fc2, s, F32))
        return x * s[:, :, None, None]


class SABlock(nn.Module):
    """Spatial attention (mtl_methods.py:44-56): a 3x3 conv's features
    times the sigmoid of another 3x3 conv's."""

    def __init__(self, cin: int, out_channels: int):
        super().__init__()
        self.attention = conv(cin, out_channels, 3)
        self.conv = conv(cin, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = torch.sigmoid(conv2d(self.attention, x, F32))
        return conv2d(self.conv, x, F32) * att


# ---------------------------------------------------------------------------
# Cross-stitch (mtl_methods.py:59-114)
# ---------------------------------------------------------------------------
class CrossStitchUnit(nn.Module):
    """out[ti] = sum over tj of stitch_{ti}_{tj} (per channel) * feats[tj];
    the weights start at alpha on a task's own features, beta on the
    others'."""

    def __init__(self, tasks: Sequence[str], num_channels: int,
                 alpha: float = 0.9, beta: float = 0.1):
        super().__init__()
        self.tasks = list(tasks)
        for ti in self.tasks:
            for tj in self.tasks:
                self.register_parameter(f"stitch_{ti}_{tj}", nn.Parameter(
                    torch.full((num_channels,), alpha if ti == tj else beta)))

    def forward(self, feats: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        out = {}
        for ti in self.tasks:
            acc = None
            for tj in self.tasks:
                w = getattr(self, f"stitch_{ti}_{tj}")
                term = feats[tj] * w[None, :, None, None]
                acc = term if acc is None else acc + term
            out[ti] = acc
        return out


class _StitchedResNets(nn.Module):
    """One ResNet a task, their features mixed after every stage by a unit
    ``{prefix}{s}`` (Cross-Stitch and NDDR-CNN, mtl_methods.py:79-114,
    :149-176); the heads read each task's stage-4 map."""

    prefix = ""

    def __init__(self, backbones: Dict[str, ResNet],
                 heads: Dict[str, nn.Module], tasks: Sequence[str],
                 channels: Sequence[int], alpha: float = 0.9,
                 beta: float = 0.1):
        super().__init__()
        self.tasks = list(tasks)
        self.backbones = nn.ModuleDict(backbones)
        self.heads = nn.ModuleDict(heads)
        for s in range(4):
            self.add_module(f"{self.prefix}{s}",
                            self.unit(self.tasks, channels[s], alpha, beta))

    def forward(self, x: torch.Tensor, single_task: Optional[str] = None,
                noise: Optional[torch.Generator] = None):
        refuse_parallel(type(self).__name__)
        feats = {t: self.backbones[t].forward_stem(x) for t in self.tasks}
        for s in range(4):
            feats = {t: self.backbones[t].forward_stage(feats[t], s)
                     for t in self.tasks}
            feats = getattr(self, f"{self.prefix}{s}")(feats)
        return (_heads_out(self.heads, feats, self.tasks, x.shape[-2:],
                           noise), _zero_cv(x), {})


class CrossStitchNetwork(_StitchedResNets):
    prefix = "stitch_stage"
    unit = CrossStitchUnit


# ---------------------------------------------------------------------------
# NDDR-CNN (mtl_methods.py:117-176)
# ---------------------------------------------------------------------------
class NDDRLayer(nn.Module):
    """Per task: a 1x1 conv over every task's features concatenated, then
    BatchNorm (flax momentum 0.95) and ReLU.  The conv starts at beta * I
    on every task's block and alpha * I on the task's own
    (mtl_methods.py:133-140)."""

    def __init__(self, tasks: Sequence[str], channels: int,
                 alpha: float = 0.9, beta: float = 0.1):
        super().__init__()
        self.tasks = list(tasks)
        self.channels, self.alpha, self.beta = channels, alpha, beta
        T = len(self.tasks)
        for t in self.tasks:
            # a plain nn.Conv2d: init_weights below sets it, not lecun
            setattr(self, f"conv_{t}",
                    nn.Conv2d(channels * T, channels, 1, bias=False))
            setattr(self, f"bn_{t}",
                    nn.BatchNorm2d(channels, eps=1e-5, momentum=0.05))

    def init_weights(self, gen: torch.Generator) -> None:
        C, T = self.channels, len(self.tasks)
        eye = torch.eye(C)
        with torch.no_grad():
            for i, t in enumerate(self.tasks):
                w = torch.cat([eye * (self.alpha if j == i else self.beta)
                               for j in range(T)], 1)
                getattr(self, f"conv_{t}").weight.copy_(w[:, :, None, None])

    def forward(self, feats: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        cat = torch.cat([feats[t].float() for t in self.tasks], 1)
        return {t: F.relu(apply_bn(getattr(self, f"bn_{t}"), conv2d(
            getattr(self, f"conv_{t}"), cat, F32))) for t in self.tasks}


class NDDRCNN(_StitchedResNets):
    prefix = "nddr_stage"
    unit = NDDRLayer


# ---------------------------------------------------------------------------
# MTAN (mtl_methods.py:178-258)
# ---------------------------------------------------------------------------
class AttentionLayer(nn.Module):
    """1x1 conv + BatchNorm + ReLU, 1x1 conv + BatchNorm, sigmoid (the
    convs with bias)."""

    def __init__(self, cin: int, mid_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = conv(cin, mid_channels, 1, bias=True)
        self.bn1 = nn.BatchNorm2d(mid_channels, eps=1e-5)
        self.conv2 = conv(mid_channels, out_channels, 1, bias=True)
        self.bn2 = nn.BatchNorm2d(out_channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(apply_bn(self.bn1, conv2d(self.conv1, x, F32)))
        return torch.sigmoid(apply_bn(self.bn2, conv2d(self.conv2, h, F32)))


class RefinementBlock(nn.Module):
    """A Bottleneck with a 1x1 downsample to out_channels."""

    def __init__(self, cin: int, out_channels: int):
        super().__init__()
        self.bottleneck = Bottleneck(cin, out_channels // 4, downsample=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bottleneck(x)


class MTAN(nn.Module):
    """Task attention over one shared ResNet (mtl_methods.py:204-258): at
    stage s each task's mask (AttentionLayer on the stage's
    all-but-last-block output, with the task's previous attended features
    concatenated from stage 1 on) multiplies the stage's output; one
    RefinementBlock a stage, shared by the tasks, then a 2x2 max-pool
    (floors odd sizes) where downsample[s]."""

    def __init__(self, backbone: ResNet, heads: Dict[str, nn.Module],
                 tasks: Sequence[str], channels: Sequence[int],
                 downsample: Sequence[bool] = (True, True, True, False)):
        super().__init__()
        self.tasks = list(tasks)
        self.downsample = list(downsample)
        self.backbone = backbone
        self.heads = nn.ModuleDict(heads)
        ch = list(channels)
        for s in range(4):
            cin = ch[s] if s == 0 else 2 * ch[s]
            for t in self.tasks:
                self.add_module(f"attention_{s}_{t}",
                                AttentionLayer(cin, ch[s] // 4, ch[s]))
            if s < 3:
                self.add_module(f"refine_{s}",
                                RefinementBlock(ch[s], ch[s + 1]))

    def forward(self, x: torch.Tensor, single_task: Optional[str] = None,
                noise: Optional[torch.Generator] = None):
        refuse_parallel("MTAN")
        bb = self.backbone
        h = bb.forward_stem(x)
        u_b, u_t = [], []
        for s in range(4):
            b = bb.forward_stage(h, s, skip_last=True)
            h = bb.forward_stage_last_block(b, s)
            u_b.append(b)
            u_t.append(h)
        a: Dict[str, torch.Tensor] = {}
        for s in range(4):
            new_a = {}
            for t in self.tasks:
                inp = u_b[s] if s == 0 else torch.cat(
                    [u_b[s].float(), a[t]], 1)
                mask = getattr(self, f"attention_{s}_{t}")(inp)
                new_a[t] = mask * u_t[s]
            if s < 3:
                refine = getattr(self, f"refine_{s}")
                a = {}
                for t in self.tasks:
                    r = refine(new_a[t])
                    # flax's VALID 2x2 max-pool floors odd sizes, as here
                    a[t] = F.max_pool2d(r, 2, 2) if self.downsample[s] \
                        else r
            else:
                a = new_a
        return (_heads_out(self.heads, a, self.tasks, x.shape[-2:], noise),
                _zero_cv(x), {})


# ---------------------------------------------------------------------------
# PAD-Net (mtl_methods.py:261-337)
# ---------------------------------------------------------------------------
class InitialTaskPredictionModule(nn.Module):
    """Per task: two Bottlenecks to `intermediate_channels` (the first
    with a 1x1 downsample when the input's channels differ), the features
    ``features_{task}``, and a 1x1 conv (with bias) to the task's
    prediction."""

    def __init__(self, tasks: Sequence[str], num_outputs: Dict[str, int],
                 cin: int, intermediate_channels: int = 256):
        super().__init__()
        self.tasks = list(tasks)
        c = intermediate_channels
        for t in self.tasks:
            setattr(self, f"b1_{t}",
                    Bottleneck(cin, c // 4, downsample=cin != c))
            setattr(self, f"b2_{t}", Bottleneck(c, c // 4))
            setattr(self, f"conv_out_{t}",
                    conv(c, num_outputs[t], 1, bias=True))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        out = {}
        for t in self.tasks:
            inp = x[t] if isinstance(x, dict) else x
            h = getattr(self, f"b2_{t}")(getattr(self, f"b1_{t}")(inp))
            out[f"features_{t}"] = h
            out[t] = conv2d(getattr(self, f"conv_out_{t}"), h, F32)
        return out


class MultiTaskDistillationModule(nn.Module):
    """out[t] = features_t + the sum over the other auxiliary tasks a of
    SABlock_{t,a}(features_a)."""

    def __init__(self, tasks: Sequence[str], auxilary_tasks: Sequence[str],
                 channels: int):
        super().__init__()
        self.tasks = list(tasks)
        self.aux = list(auxilary_tasks)
        for t in self.tasks:
            for a in self.aux:
                if a != t:
                    setattr(self, f"sa_{t}_{a}", SABlock(channels, channels))

    def forward(self, x: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        out = {}
        for t in self.tasks:
            acc = x[f"features_{t}"]
            for a in self.aux:
                if a != t:
                    acc = acc + getattr(self, f"sa_{t}_{a}")(
                        x[f"features_{a}"])
            out[t] = acc
        return out


class PADNet(nn.Module):
    """mtl_methods.py:304-337: initial predictions of the auxiliary tasks
    on the backbone's features, their distillation into each task's
    features, then per task two Bottlenecks and a 1x1 conv, resized to the
    input."""

    def __init__(self, backbone: nn.Module, backbone_channels: int,
                 tasks: Sequence[str], auxilary_tasks: Sequence[str],
                 num_outputs: Dict[str, int]):
        super().__init__()
        self.tasks = list(tasks)
        self.aux = list(auxilary_tasks)
        self.backbone = backbone
        self.initial = InitialTaskPredictionModule(self.aux, num_outputs,
                                                   backbone_channels)
        self.distillation = MultiTaskDistillationModule(self.tasks, self.aux,
                                                        256)
        for t in self.tasks:
            setattr(self, f"head_b1_{t}", Bottleneck(256, 64))
            setattr(self, f"head_b2_{t}", Bottleneck(256, 64))
            setattr(self, f"head_out_{t}",
                    conv(256, num_outputs[t], 1, bias=True))

    def forward(self, x: torch.Tensor, single_task: Optional[str] = None,
                noise: Optional[torch.Generator] = None):
        refuse_parallel("PAD-Net")
        out: Dict[str, torch.Tensor] = {}
        initial = self.initial(self.backbone(x).float())
        if self.training:
            for t in self.aux:
                out[f"initial_{t}"] = initial[t]
        distilled = self.distillation(initial)
        for t in self.tasks:
            h = getattr(self, f"head_b2_{t}")(
                getattr(self, f"head_b1_{t}")(distilled[t]))
            out[t] = resize_bilinear(
                conv2d(getattr(self, f"head_out_{t}"), h, F32),
                x.shape[-2:])
        return out, _zero_cv(x), {}


# ---------------------------------------------------------------------------
# MTI-Net (mtl_methods.py:339-454)
# ---------------------------------------------------------------------------
class MTIInitialPrediction(nn.Module):
    """Per auxiliary task: the scale's features (with the previous
    scale's task features upsampled x2 and concatenated, when there is a
    previous scale), two BasicBlocks to `task_channels` (the first with a
    1x1 downsample when the channels differ), and a 1x1 conv (with bias)
    to the prediction."""

    def __init__(self, tasks: Sequence[str], num_outputs: Dict[str, int],
                 cin: int, task_channels: int):
        super().__init__()
        self.tasks = list(tasks)
        for t in self.tasks:
            setattr(self, f"refine1_{t}", BasicBlock(
                cin, task_channels, downsample=cin != task_channels))
            setattr(self, f"refine2_{t}",
                    BasicBlock(task_channels, task_channels))
            setattr(self, f"decoder_{t}",
                    conv(task_channels, num_outputs[t], 1, bias=True))

    def forward(self, feat_cur: torch.Tensor,
                feat_prev: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        out = {}
        for t in self.tasks:
            inp = feat_cur
            if feat_prev is not None:
                prev = feat_prev[t]
                prev = resize_bilinear(prev, (prev.shape[2] * 2,
                                              prev.shape[3] * 2))
                inp = torch.cat([feat_cur.float(), prev], 1)
            h = getattr(self, f"refine2_{t}")(
                getattr(self, f"refine1_{t}")(inp))
            out[f"features_{t}"] = h
            out[t] = conv2d(getattr(self, f"decoder_{t}"), h, F32)
        return out


class FPM(nn.Module):
    """Feature propagation (mtl_methods.py:376-405): the tasks' features
    concatenated (C = N * per_task channels), two BasicBlocks to C // 4
    and a 1x1 conv (with bias) back to C give a mask, softmaxed over
    groups of N consecutive channels; the masked features, a BasicBlock
    down to per_task channels, and per task an SEBlock of them plus the
    task's own features."""

    def __init__(self, tasks: Sequence[str], per_task_channels: int):
        super().__init__()
        self.tasks = list(tasks)
        N = len(self.tasks)
        C = per_task_channels * N
        self.nl1 = BasicBlock(C, C // 4, downsample=True)
        self.nl2 = BasicBlock(C // 4, C // 4)
        self.nl_out = conv(C // 4, C, 1, bias=True)
        self.dim_red = BasicBlock(C, per_task_channels, downsample=True)
        for t in self.tasks:
            setattr(self, f"se_{t}", SEBlock(per_task_channels))

    def forward(self, x: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        N = len(self.tasks)
        concat = torch.cat([x[f"features_{t}"] for t in self.tasks], 1)
        B, C, H, W = concat.shape
        shared = conv2d(self.nl_out, self.nl2(self.nl1(concat)), F32)
        # the reference's view(B, C // N, N, H, W).softmax(2): groups of N
        # consecutive channels (mti_net.py:89-91)
        mask = shared.view(B, C // N, N, H, W).softmax(2)
        mixed = (mask * concat.view(B, C // N, N, H, W)).view(B, C, H, W)
        mixed = self.dim_red(mixed)
        return {t: getattr(self, f"se_{t}")(mixed) + x[f"features_{t}"]
                for t in self.tasks}


class MTINet(nn.Module):
    """MTI-Net on the four streams of an HRNet (mtl_methods.py:408-454):
    initial predictions from the coarsest scale up (``scale_3`` ..
    ``scale_0``), an FPM between scales, a distillation at every scale,
    and per task a head over the four distilled streams, resized to the
    input."""

    def __init__(self, backbone: nn.Module, heads: Dict[str, nn.Module],
                 tasks: Sequence[str], auxilary_tasks: Sequence[str],
                 num_outputs: Dict[str, int],
                 channels: Sequence[int] = (18, 36, 72, 144)):
        super().__init__()
        self.tasks = list(tasks)
        self.aux = list(auxilary_tasks)
        self.backbone = backbone
        self.heads = nn.ModuleDict(heads)
        ch = list(channels)
        for i in range(4):
            cin = ch[i] if i == 3 else ch[i] + ch[i + 1]
            self.add_module(f"scale_{i}", MTIInitialPrediction(
                self.aux, num_outputs, cin, ch[i]))
        for i in (3, 2, 1):
            self.add_module(f"fpm_{i}", FPM(self.aux, ch[i]))
        for i in range(4):
            self.add_module(f"dist_{i}", MultiTaskDistillationModule(
                self.tasks, self.aux, ch[i]))

    def forward(self, x: torch.Tensor, single_task: Optional[str] = None,
                noise: Optional[torch.Generator] = None):
        refuse_parallel("MTI-Net")
        xs: List[torch.Tensor] = [s.float() for s in self.backbone(x)]
        scales: List[Optional[Dict[str, torch.Tensor]]] = [None] * 4
        prev = None
        for i in (3, 2, 1, 0):
            scales[i] = getattr(self, f"scale_{i}")(xs[i], prev)
            if i:
                prev = getattr(self, f"fpm_{i}")(scales[i])
        out: Dict = {}
        if self.training:
            out["deep_supervision"] = {
                f"scale_{i}": {k: v for k, v in scales[i].items()
                               if not k.startswith("features_")}
                for i in range(4)}
        dist = [getattr(self, f"dist_{i}")(scales[i]) for i in range(4)]
        for t in self.tasks:
            out[t] = resize_bilinear(
                self.heads[t]([d[t] for d in dist], noise), x.shape[-2:])
        return out, _zero_cv(x), {}
