"""Loss schemes (counterpart of m3vit_tpu/losses/schemes.py :16-162):
the per-task loss functions of a config, one task's loss, the weighted
multi-task sum with its TAM and multi-level branches, and the
deep-supervision schemes of PAD-Net and MTI-Net, which a config picks by
``loss_kwargs.loss_scheme`` (``loss_scheme_of``; the JAX trainer scores
the final outputs alone whatever the key says, m3vit_tpu/train/step.py:71)."""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch

from m3vit_tpu_torch.losses.functions import loss_fn_for_task
from m3vit_tpu_torch.models.heads import resize_bilinear
from m3vit_tpu_torch.tasks import parse_task_dictionary


def auxilary_task_names(p: Dict) -> List[str]:
    """The auxiliary tasks of config `p` (its auxilary_task_dictionary),
    else its tasks."""
    key = "auxilary_task_dictionary" if "auxilary_task_dictionary" in p \
        else "task_dictionary"
    return [t.name for t in parse_task_dictionary(p["train_db_name"],
                                                  p[key])[0]]


def build_loss_fns(p: Dict) -> Dict[str, Callable]:
    """{task: loss function} for the tasks and auxiliary tasks of config
    `p` (its train_db_name, task_dictionary and auxilary_task_dictionary;
    schemes.py:16-17)."""
    tasks, extra = parse_task_dictionary(p["train_db_name"],
                                         p["task_dictionary"])
    if "auxilary_task_dictionary" in p:
        aux, aux_extra = parse_task_dictionary(
            p["train_db_name"], p["auxilary_task_dictionary"])
        tasks = list(tasks) + [t for t in aux
                               if t.name not in {u.name for u in tasks}]
        extra = {**aux_extra, **extra}
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


def _resize_to(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred upsampled to the label's size (schemes.py:104-111)."""
    return resize_bilinear(pred, tuple(gt.shape[-2:]))


def padnet_loss(pred: Dict, gt: Dict[str, torch.Tensor], tasks: List[str],
                auxilary_tasks: List[str], loss_fns: Dict[str, Callable],
                loss_weights: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """PAD-Net's deep supervision (schemes.py:114-136; reference
    loss_schemes.py:118-163): each auxiliary task's initial prediction,
    upsampled to its label, as ``deepsup_{task}``, plus the final
    outputs, all weighted."""
    out: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=pred[tasks[0]].device)
    for task in auxilary_tasks:
        loss = loss_fns[task](_resize_to(pred[f"initial_{task}"], gt[task]),
                              gt[task])
        out[f"deepsup_{task}"] = loss
        total = total + loss_weights[task] * loss
    for task in tasks:
        loss = loss_fns[task](pred[task], gt[task])
        out[task] = loss
        total = total + loss_weights[task] * loss
    out["total"] = total
    return out


def mtinet_loss(pred: Dict, gt: Dict[str, torch.Tensor], tasks: List[str],
                auxilary_tasks: List[str], loss_fns: Dict[str, Callable],
                loss_weights: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """MTI-Net's four-scale deep supervision (schemes.py:139-162;
    reference loss_schemes.py:215-247): each scale's auxiliary
    predictions, upsampled to their labels, as ``scale_{i}_{task}``, plus
    the final outputs, all weighted."""
    out: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=pred[tasks[0]].device)
    for scale in range(4):
        ps = pred["deep_supervision"][f"scale_{scale}"]
        for task in auxilary_tasks:
            loss = loss_fns[task](_resize_to(ps[task], gt[task]), gt[task])
            out[f"scale_{scale}_{task}"] = loss
            total = total + loss_weights[task] * loss
    for task in tasks:
        loss = loss_fns[task](pred[task], gt[task])
        out[task] = loss
        total = total + loss_weights[task] * loss
    out["total"] = total
    return out


#: loss_kwargs.loss_scheme -> its deep-supervision scheme
_SCHEMES = {"pad_net": padnet_loss, "mti_net": mtinet_loss}


def loss_scheme_of(p: Dict, tasks: List[str], loss_fns: Dict[str, Callable],
                   loss_weights: Dict[str, float]) -> Callable:
    """loss(pred, gt) -> {name: loss, "total": ...} as config `p`'s
    loss_kwargs.loss_scheme says: ``baseline`` (or none) the weighted
    multi-task sum, ``pad_net`` ``padnet_loss``, ``mti_net``
    ``mtinet_loss``, over the auxiliary tasks ``auxilary_task_names``."""
    scheme = (p.get("loss_kwargs") or {}).get("loss_scheme", "baseline")
    if scheme == "baseline":
        return functools.partial(multi_task_loss, tasks=tasks,
                                 loss_fns=loss_fns, loss_weights=loss_weights)
    if scheme not in _SCHEMES:
        raise NotImplementedError(f"loss_scheme {scheme!r}")
    return functools.partial(_SCHEMES[scheme], tasks=tasks,
                             auxilary_tasks=auxilary_task_names(p),
                             loss_fns=loss_fns, loss_weights=loss_weights)
