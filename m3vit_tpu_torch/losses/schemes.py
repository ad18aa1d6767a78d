"""Loss schemes (counterpart of m3vit_tpu/losses/schemes.py :16-103):
the per-task loss functions of a config, one task's loss, and the weighted
multi-task sum with its TAM and multi-level branches."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from m3vit_tpu_torch.losses.functions import loss_fn_for_task
from m3vit_tpu_torch.tasks import parse_task_dictionary


def build_loss_fns(p: Dict) -> Dict[str, Callable]:
    """{task: loss function} for the tasks of config `p` (its
    train_db_name and task_dictionary; schemes.py:16-17)."""
    tasks, extra = parse_task_dictionary(p["train_db_name"],
                                         p["task_dictionary"])
    q = {**extra, **p}
    return {t.name: loss_fn_for_task(t.name, q) for t in tasks}


def single_task_loss(pred: Dict[str, torch.Tensor],
                     gt: Dict[str, torch.Tensor], task: str,
                     loss_fns: Dict[str, Callable]
                     ) -> Dict[str, torch.Tensor]:
    """{task: loss, "total": loss}, unweighted (schemes.py:20-29)."""
    loss = loss_fns[task](pred[task], gt[task])
    return {task: loss, "total": loss}


def multi_task_loss(pred: Dict[str, torch.Tensor], gt: Dict[str, torch.Tensor],
                    tasks: List[str], loss_fns: Dict[str, Callable],
                    loss_weights: Dict[str, float],
                    single_task: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
    """{task: loss, "total": sum of weight * loss}; a NaN human_parts loss
    counts as 0 (schemes.py:89-98).  With single_task, that task's loss and
    its weighted total alone (schemes.py:41-44).  Predictions
    ``tam_{task}``, ``tam_level{0,1,2}_{task}`` and ``level{1,2,3}_{task}``
    (when present for the first task) add their tasks' weighted losses,
    NaN counted as 0; with the ``level`` outputs every term is scaled by
    0.25 (schemes.py:50-98)."""
    if single_task is not None:
        loss = loss_fns[single_task](pred[single_task], gt[single_task])
        return {single_task: loss,
                "total": loss_weights[single_task] * loss}
    out: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=pred[tasks[0]].device)
    scale = 0.25 if f"level1_{tasks[0]}" in pred else 1.0
    branches = ["tam_{}"] + [f"tam_level{lvl}_{{}}" for lvl in range(3)] \
        + [f"level{lvl}_{{}}" for lvl in (1, 2, 3)]
    for form in branches:
        if form.format(tasks[0]) not in pred:
            continue
        for task in tasks:
            key = form.format(task)
            loss = torch.nan_to_num(loss_fns[task](pred[key], gt[task]),
                                    nan=0.0)
            out[key] = loss
            total = total + scale * loss_weights[task] * loss
    for task in tasks:
        loss = loss_fns[task](pred[task], gt[task])
        if task == "human_parts":
            loss = torch.nan_to_num(loss, nan=0.0)
        out[task] = loss
        total = total + scale * loss_weights[task] * loss
    out["total"] = total
    return out
