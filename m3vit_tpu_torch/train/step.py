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

Under data and expert parallelism (a ``parallel`` layout in force, the
model's experts sharded by ``parallel.shard_experts``) each rank runs the
step on its shard of the global batch: its loss is its share of the
global loss, the balance loss counts once over the world, the gradients
are summed across ranks before the optimizer steps (``parallel.
sync_grads``) and the metrics are the global batch's.

For the token model the auxiliary loss the model returns already holds
the blocks' sharing loss beside the cv loss, and it is weighted by
cv_weight as a whole, as in the JAX package (step.py:75); the train step
passes the epoch's Gumbel temperature (``share_temp``) to the model when
given (step.py:48-62).

With ``pass_sem`` (the sem-guided knobs' warm-up step, step.py:41-78) the
batch's semseg labels go to the model, and the MoE blocks' regularisers
join the total: semregu_weight x ``semregu_loss`` and subimage_weight x
``regu_subimage_loss`` (summed over blocks and task passes), logged as
``loss_semregu`` and ``loss_regu_subimage``.  The reference computes both
and leaves the addition commented out; the JAX package applies it, and so
does the port.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Optional

import torch

from m3vit_tpu_torch import parallel
from m3vit_tpu_torch.losses.schemes import multi_task_loss
from m3vit_tpu_torch.models.vit_moe import collect_gate_stats


def _set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def analysis(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The MoE analysis aggregates of summed block stats
    (step.py:102-121): gate entropy and top-1 probability means over
    routed tokens, the per-expert load histogram, the share of experts
    that got no token and the load's coefficient of variation; with the
    gate internals (M3VIT_LOG_GATE_INTERNALS) also their means."""
    n_tok = stats["gate_token_count"].clamp(min=1.0)
    hist = stats["expert_load_hist"]
    out = {
        "gate_entropy_mean": stats["gate_entropy_sum"] / n_tok,
        "top1_prob_mean": stats["top1_prob_sum"] / n_tok,
        "expert_load_hist": hist,
        "dead_expert_ratio": (hist <= 0).float().mean(),
        "expert_load_cv": hist.std(correction=0) / hist.mean().clamp(
            min=1e-9),
    }
    for k in ("gate_full_entropy", "gate_pmax", "topk_group_count"):
        if f"{k}_sum" in stats:
            out[f"{k}_mean"] = stats[f"{k}_sum"] / n_tok
    return out


def _step(model, optimizer, lr: float) -> None:
    """The optimizer step at `lr`, after summing the gradients across
    ranks when a layout is in force."""
    lay = parallel.active()
    if lay is not None:
        parallel.sync_grads(model, lay)
    _set_lr(optimizer, lr)
    optimizer.step()


def _global_losses(losses: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Each rank's share of every loss summed over the world, detached:
    the global batch's losses (one all-reduce); the values themselves on
    one process."""
    if parallel.active() is None:
        return {k: v.detach() for k, v in losses.items()}
    keys = list(losses)
    flat = parallel.world_sum(torch.stack([losses[k].detach().float()
                                           for k in keys]))
    return dict(zip(keys, flat.unbind()))


def make_train_step(model: torch.nn.Module, tasks: List[str],
                    loss_fns: Dict[str, Callable],
                    loss_weights: Dict[str, float],
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float],
                    cv_weight: float = 0.01,
                    analysis_metrics: bool = False,
                    accumulation_steps: int = 1,
                    loss_scheme: Optional[Callable] = None,
                    pass_sem: bool = False, semregu_weight: float = 0.01,
                    subimage_weight: float = 0.01):
    """Returns train_step(batch, noise, share_temp=None) -> metrics, with
    the count of calls (micro-batches) in ``train_step.step``; share_temp
    (the token model's Gumbel temperature of the epoch) goes to the model
    when given.  batch: {"image": [B, 3, H, W],
    task: label [B, C, H, W]}; noise: the torch.Generator, on the model's
    device, that the gate noise is drawn from (unused when the VMoE gate's
    vmoe_noisy_std is 0).  Metrics are detached tensors of the call's
    micro-batch: loss_<task>, loss_total, loss_cv, loss_total_with_cv and
    moe_dropped_frac (mean over MoE blocks and tasks); with
    analysis_metrics also those of ``analysis``.  accumulation_steps: the
    config's, as build_optimizer read it.  loss_scheme: loss(pred, batch)
    -> {name: loss, "total": ...} (``losses.schemes.loss_scheme_of``),
    the weighted multi-task sum by default; each of its terms is a
    metric.  pass_sem, semregu_weight, subimage_weight: the sem step (the
    module docstring)."""
    accum = max(int(accumulation_steps), 1)
    if loss_scheme is None:
        loss_scheme = functools.partial(multi_task_loss, tasks=tasks,
                                        loss_fns=loss_fns,
                                        loss_weights=loss_weights)

    def train_step(batch: Dict[str, torch.Tensor],
                   noise: Optional[torch.Generator] = None,
                   share_temp: Optional[float] = None
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        i = train_step.step
        if i % accum == 0:
            optimizer.zero_grad(set_to_none=True)
        kw = {} if share_temp is None else {"share_temp": share_temp}
        if pass_sem:
            kw["sem"] = batch["semseg"]
        with (collect_gate_stats(model) if analysis_metrics
              else contextlib.nullcontext()):
            pred, cv, stats = model(batch["image"], noise=noise, **kw)
        losses = loss_scheme(pred, batch)
        # the balance loss is the global batch's on every rank: it counts
        # once over the world
        total = losses["total"] + cv_weight * cv / parallel.world_size()
        regu = {}   # name -> (loss, weight)
        if pass_sem:
            for name, key, w in (("semregu", "semregu_loss", semregu_weight),
                                 ("regu_subimage", "regu_subimage_loss",
                                  subimage_weight)):
                if key in stats:
                    total = total + w * stats[key]
                    regu[name] = (stats[key].detach(), w)
        (total / accum if accum > 1 else total).backward()
        if (i + 1) % accum == 0:
            _step(model, optimizer, schedule(i // accum))
        train_step.step += 1
        losses = _global_losses(losses)
        stats = parallel.reduce_stats(stats)
        metrics = {f"loss_{k}": v for k, v in losses.items()}
        metrics["loss_cv"] = cv.detach()
        metrics["loss_total_with_cv"] = losses["total"] + cv_weight * \
            cv.detach()
        for k, (v, w) in regu.items():
            metrics[f"loss_{k}"] = v
            metrics["loss_total_with_cv"] = \
                metrics["loss_total_with_cv"] + w * v
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
                               cv_weight: float = 0.01,
                               accumulation_steps: int = 1):
    """Returns one_by_one_step(batch, noise) -> metrics, the per-task
    training of the reference's --one_by_one (step.py:134-197; reference
    train_utils.py:370-421): for each task one single_task forward and
    backward on the same batch (fresh gate noise per pass, as the
    generator moves on), the gradients adding up in ``.grad``, then one
    optimizer step.  The gradients are the joint multi-gate step's; only
    one task's activations are live at a time.  Each pass runs only its
    task's decoder, so every BatchNorm updates once a step, with the
    statistics of its own pass (cli/train.py:806-809).  With
    ``accumulation_steps`` k > 1 a call is one micro-batch, as the JAX
    CLI's one-by-one under optax.MultiSteps (cli/train.py:667-671,
    :796-812): the per-task gradients of each batch add up, the k-th call
    steps on their mean over the k batches, at the schedule's lr of the
    optimizer step.  Metrics: loss_<task> (unweighted), loss_cv (summed
    over the passes) and loss_total (the sum of the passes' weighted
    losses plus cv_weight * cv), of the call's batch."""
    accum = max(int(accumulation_steps), 1)

    def one_by_one_step(batch: Dict[str, torch.Tensor],
                        noise: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
        model.train()
        i = one_by_one_step.step
        if i % accum == 0:
            optimizer.zero_grad(set_to_none=True)
        world = parallel.world_size()
        losses: Dict[str, torch.Tensor] = {}
        total_cv = 0.0
        for task in tasks:
            pred, cv, _ = model(batch["image"], single_task=task, noise=noise)
            task_loss = loss_fns[task](pred[task], batch[task])
            loss = loss_weights[task] * task_loss + cv_weight * cv / world
            (loss / accum if accum > 1 else loss).backward()
            losses[task] = task_loss
            total_cv = total_cv + cv.detach()
        if (i + 1) % accum == 0:
            _step(model, optimizer, schedule(i // accum))
        one_by_one_step.step += 1
        losses = _global_losses(losses)
        metrics = {f"loss_{task}": v for task, v in losses.items()}
        metrics["loss_cv"] = total_cv
        metrics["loss_total"] = sum(loss_weights[task] * losses[task]
                                    for task in tasks) + cv_weight * total_cv
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
        return (pred, parallel.reduce_stats(stats)) if with_stats else pred

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
