"""The weighted multi-task loss (counterpart of
m3vit_tpu/losses/schemes.py:multi_task_loss :32-103, its plain branch)."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


def multi_task_loss(pred: Dict[str, torch.Tensor], gt: Dict[str, torch.Tensor],
                    tasks: List[str], loss_fns: Dict[str, Callable],
                    loss_weights: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """{task: loss, "total": sum of weight * loss}; a NaN human_parts loss
    counts as 0 (schemes.py:89-98).  The TAM and multi-level branches are
    not ported and raise."""
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
