"""Per-task loss functions (counterpart of m3vit_tpu/losses/functions.py
:26-158; reference losses/loss_functions.py), NCHW.

Predictions are [B, C, H, W] and labels [B, C_label, H, W]; every loss is
computed in f32 and returns a scalar.  The ignore label is 255.

Under data parallelism (a ``parallel`` layout in force) every count a loss
divides by -- valid pixels, elements, positive labels -- is the global
batch's, summed over the world without gradient, so a rank's loss is its
share of the global loss (functions.py:47-48, :76-83, :110, :126 see the
whole batch) and the ranks' losses and gradients add up to it.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from m3vit_tpu_torch.parallel import world_size, world_sum

IGNORE = 255.0


def softmax_ce_loss(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Cross entropy with ignore label 255, the mean over valid pixels; 0
    when every pixel is ignored (functions.py:26-48).  label [B, 1, H, W]."""
    lab = label[:, 0].long()
    nll = F.cross_entropy(logits.float(), lab, ignore_index=255,
                          reduction="none")
    n_valid = world_sum((lab != 255).sum()).clamp(min=1)
    return nll.sum() / n_valid


def _stable_bce_terms(output: torch.Tensor, labels: torch.Tensor):
    """Elementwise stable BCE-with-logits terms in the reference's form
    (functions.py:51-64)."""
    output = output.float()
    out_gt_zero = (output >= 0).float()
    loss_val = output * (labels - out_gt_zero) - torch.log1p(
        torch.exp(output - 2.0 * output * out_gt_zero))
    return -labels * loss_val, -(1.0 - labels) * loss_val


def balanced_bce_loss(output: torch.Tensor, label: torch.Tensor,
                      pos_weight: Optional[float] = None,
                      size_average: bool = True) -> torch.Tensor:
    """HED-style class-balanced BCE (functions.py:67-88): edge gets the
    config's pos_weight, sal the dynamic negative fraction."""
    labels = (label.float() >= 0.5).float()
    n = world_size()
    if pos_weight is None:
        num_total = float(labels.numel() * n)
        w = (num_total - world_sum(labels.sum())) / num_total
    else:
        w = pos_weight
    loss_pos_pix, loss_neg_pix = _stable_bce_terms(output, labels)
    final = w * loss_pos_pix.sum() + (1.0 - w) * loss_neg_pix.sum()
    return final / float(n * (labels.numel() if size_average
                              else labels.shape[0]))


def bce_loss(output: torch.Tensor, label: torch.Tensor,
             size_average: bool = True) -> torch.Tensor:
    """Unbalanced BCE with logits (functions.py:91-102; reference
    BinaryCrossEntropyLoss)."""
    labels = (label.float() >= 0.5).float()
    loss_pos_pix, loss_neg_pix = _stable_bce_terms(output, labels)
    final = loss_pos_pix.sum() + loss_neg_pix.sum()
    return final / float(world_size() * (labels.numel() if size_average
                                         else labels.shape[0]))


def depth_l1_loss(output: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean |output - label| over the pixels whose label is not 255, at
    least one (functions.py:105-111)."""
    label = label.float()
    mask = label != IGNORE
    diff = torch.where(mask, (output.float() - label).abs(), 0.0)
    return diff.sum() / world_sum(mask.sum()).clamp(min=1)


def normals_l1_loss(output: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """L2-normalise the prediction over channels, then the L1 over
    elements whose label is not 255, divided by max(n_valid, 1e-6)
    (functions.py:114-127)."""
    label = label.float()
    out = output.float()
    out = out / (torch.linalg.vector_norm(out, dim=1, keepdim=True) + 1e-12)
    mask = label != IGNORE
    diff = torch.where(mask, (out - label).abs(), 0.0)
    return diff.sum() / world_sum(mask.sum().float()).clamp(min=1e-6)


def get_loss_fn(loss_kind: str, p=None) -> Callable:
    """The loss of a TaskSpec.loss_kind (functions.py:130-142; reference
    utils/common_config.py:780-807)."""
    fns = {"softmax_ce": softmax_ce_loss, "balanced_bce": balanced_bce_loss,
           "bce": bce_loss, "depth_l1": depth_l1_loss,
           "normals_l1": normals_l1_loss}
    if loss_kind not in fns:
        raise NotImplementedError(loss_kind)
    return fns[loss_kind]


def loss_fn_for_task(task_name: str, p) -> Callable:
    """Task-name factory (functions.py:145-158): edge gets the config's
    pos_weight, sal uses dynamic HED weighting."""
    if task_name == "edge":
        return functools.partial(balanced_bce_loss,
                                 pos_weight=float(p["edge_w"]))
    if task_name in ("semseg", "human_parts"):
        return softmax_ce_loss
    if task_name == "normals":
        return normals_l1_loss
    if task_name == "sal":
        return balanced_bce_loss
    if task_name == "depth":
        return depth_l1_loss
    raise NotImplementedError(task_name)
