"""Train and eval steps (counterpart of m3vit_tpu/train/step.py:
make_train_step :21-131, its plain branch; make_one_by_one_train_step
:134-197; make_eval_step :200-218; make_single_task_eval_step :221-233).

A train step is one forward over all tasks in training mode (BatchNorm
running statistics update in the forward), the weighted multi-task loss
plus cv_weight * the MoE balance loss, backward, then the optimizer at the
schedule's lr.  With ``accumulation_steps`` k > 1 (optax.MultiSteps in the
JAX package) a call is one micro-batch: the gradients are zeroed at the
start of a window of k calls, each backward adds its gradient / k, and the
k-th call steps on their mean, so the schedule counts optimizer steps.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch

from m3vit_tpu_torch.losses.schemes import multi_task_loss
from m3vit_tpu_torch.models.vit_moe import collect_gate_stats


def _set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def analysis(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The MoE analysis aggregates of summed block stats
    (step.py:102-113): gate entropy and top-1 probability means over
    routed tokens, the per-expert load histogram, the share of experts
    that got no token and the load's coefficient of variation."""
    n_tok = stats["gate_token_count"].clamp(min=1.0)
    hist = stats["expert_load_hist"]
    return {
        "gate_entropy_mean": stats["gate_entropy_sum"] / n_tok,
        "top1_prob_mean": stats["top1_prob_sum"] / n_tok,
        "expert_load_hist": hist,
        "dead_expert_ratio": (hist <= 0).float().mean(),
        "expert_load_cv": hist.std(correction=0) / hist.mean().clamp(
            min=1e-9),
    }


def make_train_step(model: torch.nn.Module, tasks: List[str],
                    loss_fns: Dict[str, Callable],
                    loss_weights: Dict[str, float],
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float],
                    cv_weight: float = 0.01,
                    analysis_metrics: bool = False,
                    accumulation_steps: int = 1):
    """Returns train_step(batch, noise) -> metrics, with the count of calls
    (micro-batches) in ``train_step.step``.  batch: {"image": [B, 3, H, W],
    task: label [B, C, H, W]}; noise: the torch.Generator, on the model's
    device, that the gate noise is drawn from (unused when the VMoE gate's
    vmoe_noisy_std is 0).  Metrics are detached tensors of the call's
    micro-batch: loss_<task>, loss_total, loss_cv, loss_total_with_cv and
    moe_dropped_frac (mean over MoE blocks and tasks); with
    analysis_metrics also those of ``analysis``.  accumulation_steps: the
    config's, as build_optimizer read it."""
    accum = max(int(accumulation_steps), 1)

    def train_step(batch: Dict[str, torch.Tensor],
                   noise: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        i = train_step.step
        if i % accum == 0:
            optimizer.zero_grad(set_to_none=True)
        with (collect_gate_stats(model) if analysis_metrics
              else contextlib.nullcontext()):
            pred, cv, stats = model(batch["image"], noise=noise)
        losses = multi_task_loss(pred, batch, tasks, loss_fns, loss_weights)
        total = losses["total"] + cv_weight * cv
        (total / accum if accum > 1 else total).backward()
        if (i + 1) % accum == 0:
            _set_lr(optimizer, schedule(i // accum))
            optimizer.step()
        train_step.step += 1
        metrics = {f"loss_{k}": v.detach() for k, v in losses.items()}
        metrics["loss_cv"] = cv.detach()
        metrics["loss_total_with_cv"] = total.detach()
        if "dropped_slot_fraction" in stats:
            metrics["moe_dropped_frac"] = (
                stats["dropped_slot_fraction"]
                / stats["moe_stat_count"].clamp(min=1.0)).detach()
        if analysis_metrics and "gate_token_count" in stats:
            metrics.update(analysis(stats))
        return metrics

    train_step.step = 0
    return train_step


def make_one_by_one_train_step(model: torch.nn.Module, tasks: List[str],
                               loss_fns: Dict[str, Callable],
                               loss_weights: Dict[str, float],
                               optimizer: torch.optim.Optimizer,
                               schedule: Callable[[int], float],
                               cv_weight: float = 0.01):
    """Returns one_by_one_step(batch, noise) -> metrics, the per-task
    training of the reference's --one_by_one (step.py:134-197; reference
    train_utils.py:370-421): for each task one single_task forward and
    backward on the same batch (fresh gate noise per pass, as the
    generator moves on), the gradients adding up in ``.grad``, then one
    optimizer step.  The gradients are the joint multi-gate step's; only
    one task's activations are live at a time.  Each pass runs only its
    task's decoder, so every BatchNorm updates once a step.  Metrics:
    loss_<task> (unweighted), loss_cv (summed over the passes) and
    loss_total (the sum of the passes' weighted losses plus cv_weight *
    cv)."""

    def one_by_one_step(batch: Dict[str, torch.Tensor],
                        noise: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        metrics: Dict[str, torch.Tensor] = {}
        total_cv = total = 0.0
        for task in tasks:
            pred, cv, _ = model(batch["image"], single_task=task, noise=noise)
            task_loss = loss_fns[task](pred[task], batch[task])
            loss = loss_weights[task] * task_loss + cv_weight * cv
            loss.backward()
            metrics[f"loss_{task}"] = task_loss.detach()
            total_cv = total_cv + cv.detach()
            total = total + loss.detach()
        _set_lr(optimizer, schedule(one_by_one_step.step))
        optimizer.step()
        one_by_one_step.step += 1
        metrics["loss_cv"] = total_cv
        metrics["loss_total"] = total
        return metrics

    one_by_one_step.step = 0
    return one_by_one_step


def make_eval_step(model: torch.nn.Module, tasks: List[str],
                   with_stats: bool = False):
    """Returns eval_step(batch) -> pred dict, the full multi-task forward
    in eval mode without autograd (step.py:200-218).  with_stats returns
    (pred, moe stats) — the dropped-slot fraction the eval's no-drop guard
    reads, and the gates' analysis statistics."""

    def eval_step(batch: Dict[str, torch.Tensor]):
        model.eval()
        with torch.no_grad(), (collect_gate_stats(model) if with_stats
                               else contextlib.nullcontext()):
            pred, _, stats = model(batch["image"])
        return (pred, stats) if with_stats else pred

    return eval_step


def make_single_task_eval_step(model: torch.nn.Module, task: str):
    """Returns eval_step(batch) -> {task: pred}: only `task`'s router
    pathway and decoder, the sparse single-task inference
    (step.py:221-233)."""

    def eval_step(batch: Dict[str, torch.Tensor]):
        model.eval()
        with torch.no_grad():
            return model(batch["image"], single_task=task)[0]

    return eval_step
