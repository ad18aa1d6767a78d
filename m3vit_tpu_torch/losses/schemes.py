"""Loss schemes (counterpart of m3vit_tpu/losses/schemes.py :16-103):
the per-task loss functions of a config, one task's loss, and the weighted
multi-task sum (its plain branch)."""

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
    its weighted total alone (schemes.py:41-44).  The TAM and multi-level
    branches are not ported and raise."""
    if single_task is not None:
        loss = loss_fns[single_task](pred[single_task], gt[single_task])
        return {single_task: loss,
                "total": loss_weights[single_task] * loss}
    if any(k.startswith(("tam_", "level")) for k in pred):
        raise NotImplementedError("TAM / multi-level loss branches are not "
                                  "ported to m3vit_tpu_torch")
    out: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=pred[tasks[0]].device)
    for task in tasks:
        loss = loss_fns[task](pred[task], gt[task])
        if task == "human_parts":
            loss = torch.nan_to_num(loss, nan=0.0)
        out[task] = loss
        total = total + loss_weights[task] * loss
    out["total"] = total
    return out
