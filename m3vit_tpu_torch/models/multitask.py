"""Shared encoder + per-task decoders, eval and train (counterpart of
m3vit_tpu/models/multitask.py: SingleTaskModel :22-37, MultiTaskModel
:40-227).

multi_gate: one backbone pass per task with that task's routers
(multitask.py:199-207), or with shared_prefix the task-independent prefix
once and the rest per task (multitask.py:157-167); a backbone whose one
router reads the task feature (``gate_task_represent``) runs so too, as
the JAX package's TaskConditionedMultiTaskModel does (multitask.py:
230-269).  single_task runs one
task's pathway only (multitask.py:121-127): the sparse serving path.
Outputs are NCHW, bilinearly resized to the input size; every forward
returns (pred_dict, cv_loss, moe_stats) like the JAX model.  The module's
training flag is the JAX ``train`` argument; in training the gate noise
and the dropout and drop-path masks are drawn from ``noise``, a
torch.Generator on the model's device.  With ``tam`` a multi-task forward
in training also runs a TAM per level in ``tam_levels`` over the heads'
features and returns its outputs as ``tam_level{lvl}_{task}``
(multitask.py:129-227).  ``stacked_tasks`` (multi_gate) runs every task's
routing in one backbone pass over a task-major stack of the batch
(multitask.py:157-167).  Every form passes ``sem`` (semseg labels, for the
sem-guided knobs) and ``expert_mask`` to the backbone when given.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from m3vit_tpu_torch.models.heads import resize_bilinear
from m3vit_tpu_torch.models.tam import TamModule
from m3vit_tpu_torch.models.vit import reject_left_out
from m3vit_tpu_torch.models.vit_moe import add_stats


def _run_backbone(backbone: nn.Module, x: torch.Tensor, task_id, noise,
                  **inputs):
    """(tokens, cv, stats) of one backbone pass; a dense backbone returns
    tokens alone, and then cv is 0 and stats empty (multitask.py:29-34,
    :83-94).  inputs: the backbone's keyword inputs that are not None."""
    ret = backbone(x, task_id, noise,
                   **{k: v for k, v in inputs.items() if v is not None})
    if isinstance(ret, tuple):
        return ret
    return ret, torch.zeros((), device=x.device), {}


def _prediction(ret):
    """A head's prediction, without the TAM features it may return."""
    return ret[0] if isinstance(ret, tuple) else ret


class SingleTaskModel(nn.Module):
    """Encoder + one decoder, named ``decoder`` as in the reference
    (multitask.py:22-37; reference models.py:137-148)."""

    def __init__(self, backbone: nn.Module, decoder: nn.Module, task: str):
        super().__init__()
        self.backbone = backbone
        self.decoder = decoder
        self.task = task

    def forward(self, x: torch.Tensor, single_task: Optional[str] = None,
                noise: Optional[torch.Generator] = None):
        """x [B, 3, H, W] -> ({task: [B, C, H, W] f32}, cv, stats);
        single_task, when given, must be the model's task."""
        if single_task not in (None, self.task):
            raise ValueError(f"this model runs {self.task!r} only, not "
                             f"{single_task!r}")
        feats, cv, stats = _run_backbone(self.backbone, x, None, noise)
        out = resize_bilinear(_prediction(self.decoder(feats, noise)),
                              tuple(x.shape[-2:]))
        return {self.task: out}, cv, stats


class MultiTaskModel(nn.Module):
    def __init__(self, backbone: nn.Module, decoders: Dict[str, nn.Module],
                 tasks: List[str], multi_gate: bool = False,
                 shared_prefix: bool = False, tam: bool = False,
                 tam_levels: Sequence[bool] = (True, True, True),
                 num_outputs: Optional[Dict[str, int]] = None,
                 stacked_tasks: bool = False, **left_out):
        super().__init__()
        reject_left_out(left_out)
        if shared_prefix and stacked_tasks:
            raise ValueError("stacked_tasks and shared_prefix are separate "
                             "multi-gate execution strategies; pick one")
        self.backbone = backbone
        self.decoders = nn.ModuleDict(decoders)
        self.tasks = list(tasks)
        self.multi_gate = multi_gate
        self.shared_prefix = shared_prefix
        self.stacked_tasks = stacked_tasks
        self.tam_levels = [lvl for lvl in range(3)
                           if tam and tam_levels[lvl]]
        for lvl in self.tam_levels:
            self.add_module(f"tam_model{lvl}",
                            TamModule(self.tasks, 256, num_outputs))

    def forward(self, x: torch.Tensor, single_task: Optional[str] = None,
                noise: Optional[torch.Generator] = None,
                sem: Optional[torch.Tensor] = None, expert_mask=None):
        """x [B, 3, H, W] -> ({task: [B, C_task, H, W] f32}, cv, stats);
        sem [B, 1, H, W] and expert_mask go to the backbone."""
        out_size = tuple(x.shape[-2:])
        out: Dict[str, torch.Tensor] = {}
        inputs = {"sem": sem, "expert_mask": expert_mask}
        if single_task is not None:
            tid = self.tasks.index(single_task) if self.multi_gate else None
            feats, cv, stats = _run_backbone(self.backbone, x, tid, noise,
                                             **inputs)
            out[single_task] = resize_bilinear(
                _prediction(self.decoders[single_task](feats, noise)),
                out_size)
            return out, cv, stats
        deep: List[Dict[str, torch.Tensor]] = [{}, {}, {}]

        def decode(task, feats):
            ret = self.decoders[task](feats, noise)
            if isinstance(ret, tuple):
                for lvl in range(3):
                    deep[lvl][task] = ret[1 + lvl]
            return resize_bilinear(_prediction(ret), out_size)

        if not self.multi_gate:
            feats, total_cv, stats = _run_backbone(self.backbone, x, None,
                                                   noise, **inputs)
            for task in self.tasks:
                out[task] = decode(task, feats)
        elif self.shared_prefix or self.stacked_tasks:
            # one call: the prefix once, or one pass over the task stack
            T = len(self.tasks)
            mode = "stacked_tasks" if self.stacked_tasks else "shared_prefix"
            feats, total_cv, stats = _run_backbone(
                self.backbone, x, list(range(T)), noise, **{mode: True},
                **inputs)
            per_task = feats.reshape((T, x.shape[0]) + feats.shape[1:])
            for i, task in enumerate(self.tasks):
                out[task] = decode(task, per_task[i])
        else:
            total_cv = torch.zeros((), device=x.device)
            stats: Dict[str, torch.Tensor] = {}
            for i, task in enumerate(self.tasks):
                feats, cv, st = _run_backbone(self.backbone, x, i, noise,
                                              **inputs)
                total_cv = total_cv + cv
                stats = add_stats(stats, st)
                out[task] = decode(task, feats)
        if self.training:
            for lvl in self.tam_levels:
                if deep[lvl]:
                    tam_out = getattr(self, f"tam_model{lvl}")(deep[lvl])
                    for task in self.tasks:
                        out[f"tam_level{lvl}_{task}"] = resize_bilinear(
                            tam_out[task], out_size)
        return out, total_cv, stats

