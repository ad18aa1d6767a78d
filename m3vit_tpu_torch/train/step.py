"""The train step (counterpart of m3vit_tpu/train/step.py:make_train_step
:21-131, its plain branch).

One optimizer step: forward over all tasks in training mode (BatchNorm
running statistics update in the forward), the weighted multi-task loss
plus cv_weight * the MoE balance loss, backward, then SGD at the schedule's
lr for this step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from m3vit_tpu_torch.losses.schemes import multi_task_loss


def make_train_step(model: torch.nn.Module, tasks: List[str],
                    loss_fns: Dict[str, Callable],
                    loss_weights: Dict[str, float],
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float],
                    cv_weight: float = 0.01):
    """Returns train_step(batch, noise) -> metrics, with the step count in
    ``train_step.step``.  batch: {"image": [B, 3, H, W], task: label
    [B, C, H, W]}; noise: the torch.Generator, on the model's device, that
    the gate noise is drawn from (unused when vmoe_noisy_std is 0).
    Metrics are detached 0-dim tensors: loss_<task>, loss_total, loss_cv,
    loss_total_with_cv and moe_dropped_frac (mean over MoE blocks and
    tasks)."""

    def train_step(batch: Dict[str, torch.Tensor],
                   noise: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        for group in optimizer.param_groups:
            group["lr"] = schedule(train_step.step)
        optimizer.zero_grad(set_to_none=True)
        pred, cv, stats = model(batch["image"], noise=noise)
        losses = multi_task_loss(pred, batch, tasks, loss_fns, loss_weights)
        total = losses["total"] + cv_weight * cv
        total.backward()
        optimizer.step()
        train_step.step += 1
        metrics = {f"loss_{k}": v.detach() for k, v in losses.items()}
        metrics["loss_cv"] = cv.detach()
        metrics["loss_total_with_cv"] = total.detach()
        if "dropped_slot_fraction" in stats:
            metrics["moe_dropped_frac"] = (
                stats["dropped_slot_fraction"]
                / stats["moe_stat_count"].clamp(min=1.0)).detach()
        return metrics

    train_step.step = 0
    return train_step
