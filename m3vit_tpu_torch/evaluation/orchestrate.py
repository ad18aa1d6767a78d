"""Evaluation orchestration: run the model over the val set and score it
(counterpart of m3vit_tpu/evaluation/orchestrate.py:33-259).

Two protocols:
  * online (``evaluate_online``) — accumulate meters directly on
    post-processed predictions at the network's output resolution resized
    back to each image's ORIGINAL size with the task's inference
    interpolation (the reference's protocol scores at original resolution,
    SURVEY invariant #6).
  * save-to-disk — reference-compatible: write per-image PNG (.mat for
    depth) into save_dir/<task>/ (``save_model_predictions``; reference
    evaluate_utils.py:275-358), then score the files
    (``eval_saved_predictions``, :361-429), with the boundary odsF of
    ``edge_eval``.
Both hold the pass to the reference's no-drop routing (``_DropGuard``).

An eval step here is ``eval_step(batch) -> pred`` or ``(pred, moe_stats)``
(train/step.py:make_eval_step) on {"image": [B, 3, H, W]}; predictions are
NCHW tensors on any device, labels NCHW tensors on the host or the device,
"meta" the per-image list of {"image": id, "im_size": (H, W)}.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import cv2
import numpy as np
import torch

from m3vit_tpu_torch.data.loader import init_worker
from m3vit_tpu_torch.evaluation.meters import (
    PerformanceMeter,
    calculate_multi_task_performance,
    single_task_reference_dict,
)
from m3vit_tpu_torch.evaluation.outputs import get_output

_CV2 = {"nearest": cv2.INTER_NEAREST, "linear": cv2.INTER_LINEAR,
        "cubic": cv2.INTER_CUBIC}


def _resize_pred(pred: np.ndarray, size, flag: str) -> np.ndarray:
    """Resize one image's postprocessed prediction back to original size."""
    if pred.shape[:2] == tuple(size):
        return pred
    return cv2.resize(pred.astype(np.float32), tuple(size)[::-1],
                      interpolation=_CV2[flag])


def _labels_hwc(label: torch.Tensor) -> np.ndarray:
    """A batch's NCHW label tensor as host numpy [B, H, W, C]."""
    return np.ascontiguousarray(label.cpu().numpy().transpose(0, 2, 3, 1))


class _DropGuard:
    """Accumulates the MoE dropped-slot fraction over an eval pass and
    enforces the reference's no-drop semantics (fastmoe's ragged dispatch,
    ckpt/custom_moe_layer.py:263-265; orchestrate.py:41-69): any token the
    static capacity dropped at eval is a deviation, and ``check`` raises,
    pointing at ``moe_eval_capacity_factor: nodrop``, unless the config
    sets ``allow_eval_drops``.  The sum stays on the device until
    ``check`` reads it once."""

    def __init__(self, p: Dict):
        self.total: Optional[torch.Tensor] = None
        self.allow = bool(p.get("allow_eval_drops", False))

    def update(self, stats: Optional[Dict[str, torch.Tensor]]) -> None:
        if stats and "dropped_slot_fraction" in stats:
            d = stats["dropped_slot_fraction"]
            self.total = d if self.total is None else self.total + d

    def check(self) -> None:
        if self.total is None:
            return
        total = float(self.total)
        if total > 0 and not self.allow:
            raise RuntimeError(
                f"eval dropped MoE routing slots (sum of per-block dropped "
                f"fractions = {total:.3e}); the reference never drops. Set "
                f"moe_eval_capacity_factor: nodrop (guaranteed-sufficient "
                f"capacity) or allow_eval_drops: true to override.")


def _split_eval_out(out):
    """eval_step may return pred or (pred, moe_stats)."""
    if isinstance(out, tuple):
        return out
    return out, None


def evaluate_online(
    p,
    eval_step: Callable,
    val_loader: Iterable[Dict],
    epoch: int = 0,
) -> Dict:
    """Online evaluation at original image resolution.

    val_loader yields batches with 'meta' (original sizes); eval_step sees
    the batch's image only.  Each prediction and the batch's (transformed)
    label are resized back to the image's original size and scored there:
    the JAX package's online protocol, slightly off the reference's
    from-disk one (``eval_saved_predictions``).
    """
    meter = PerformanceMeter(p)
    guard = _DropGuard(p)
    infer_flags = {t.name: t.infer_flagval for t in p["TASKS"]}
    for batch in val_loader:
        meta = batch["meta"]
        pred, moe_stats = _split_eval_out(eval_step({"image": batch["image"]}))
        guard.update(moe_stats)
        for task, raw in pred.items():
            post = get_output(raw, task)  # [B, ...]
            labels = _labels_hwc(batch[task])
            for i, m in enumerate(meta):
                size = m["im_size"]
                pr = _resize_pred(np.asarray(post[i]), size, infer_flags[task])
                gt = _resize_pred(labels[i], size, "nearest")
                meter.meters[task].update(pr[None], gt[None])
    guard.check()
    results = meter.get_score()
    if p.get("setup") == "multi_task":
        stl = single_task_reference_dict(p["train_db_name"], p["TASK_NAMES"])
        if stl:
            results["multi_task_performance"] = calculate_multi_task_performance(
                results, stl
            )
    return results


def save_model_predictions(
    p, eval_step: Callable, val_loader: Iterable[Dict],
    save_dir: Optional[str] = None
) -> str:
    """Write per-image predictions to disk (reference protocol)."""
    import scipy.io as sio

    save_dir = save_dir or p["save_dir"]
    tasks = list(p["TASK_NAMES"])
    guard = _DropGuard(p)
    for t in tasks:
        os.makedirs(os.path.join(save_dir, t), exist_ok=True)
    infer_flags = {t.name: t.infer_flagval for t in p["TASKS"]}

    for batch in val_loader:
        meta = batch["meta"]
        pred, moe_stats = _split_eval_out(eval_step({"image": batch["image"]}))
        guard.update(moe_stats)
        for task in tasks:
            post = get_output(pred[task], task)
            for i, m in enumerate(meta):
                size = m["im_size"]
                pr = _resize_pred(np.asarray(post[i]), size, infer_flags[task])
                fname = os.path.join(save_dir, task, f"{m['image']}")
                if task == "depth":
                    sio.savemat(fname + ".mat", {"depth": pr})
                else:
                    arr = pr
                    if task in ("semseg", "human_parts"):
                        arr = pr.astype(np.uint8)
                    else:
                        arr = np.clip(np.round(pr), 0, 255).astype(np.uint8)
                    cv2.imwrite(
                        fname + ".png",
                        arr if arr.ndim == 2 else arr[:, :, ::-1],
                    )
    guard.check()
    return save_dir


def validate_results(p, current: Dict, best: Optional[Dict]) -> (Dict, bool):
    """Track the best model (reference validate_results,
    evaluate_utils.py:104-179): multi-task uses Δm, single task its metric."""
    if best is None:
        return current, True
    if "multi_task_performance" in current:
        improve = (
            current["multi_task_performance"] > best.get(
                "multi_task_performance", -1e9)
        )
        return (current, True) if improve else (best, False)
    task = p["TASK_NAMES"][0]
    cur, prev = current[task], best[task]
    higher = {"semseg": "mIoU", "human_parts": "mIoU", "sal": "mIoU"}
    lower = {"normals": "mean", "depth": "rmse", "edge": "loss"}
    if task in higher:
        improve = cur[higher[task]] > prev[higher[task]]
    else:
        improve = cur[lower[task]] < prev[lower[task]]
    return (current, True) if improve else (best, False)


def _keep(sample):
    return sample


def _samples(dataset, num_workers: int) -> Iterable[Dict]:
    """dataset[0], dataset[1], ... in order, read by `num_workers` worker
    processes (in this process when 0)."""
    if num_workers <= 0:
        return (dataset[i] for i in range(len(dataset)))
    return iter(torch.utils.data.DataLoader(
        dataset, batch_size=None, num_workers=num_workers,
        collate_fn=_keep, worker_init_fn=init_worker))


def eval_saved_predictions(p, save_dir: str, dataset) -> Dict:
    """Score predictions written by save_model_predictions against dataset GT
    at original resolution (reference eval_all_results, evaluate_utils.py:
    361-429; per-task eval_*_predictions readers).  The samples are read
    once, by the config's ``nworkers`` worker processes, and their edge
    maps also serve the boundary odsF."""
    import scipy.io as sio

    meter = PerformanceMeter(p)
    tasks = list(p["TASK_NAMES"])
    edge_gts = []
    for i, sample in enumerate(_samples(dataset, int(p.get("nworkers", 0)))):
        im_id = dataset.im_ids[i] if hasattr(dataset, "im_ids") else str(i)
        if "edge" in tasks:
            edge_gts.append(sample["edge"])
        for task in tasks:
            gt = np.asarray(sample[task], np.float32)
            if gt.ndim == 3 and gt.shape[-1] == 1:
                gt = gt[..., 0]
            if task == "human_parts":
                # reference folder protocol (eval_human_parts.py:36-40):
                # images whose raw GT is all-background or all-ignore are
                # skipped entirely (the saver also skips them, so the file
                # may not exist)
                uniq = np.unique(gt)
                if len(uniq) == 1 and uniq[0] in (0.0, 255.0):
                    continue
            if task == "normals":
                # reference folder protocol (eval_normals.py:47-53): valid
                # pixels are where the RAW label has nonzero norm (the
                # distilled loader zeroes invalid pixels, not 255); the
                # label is re-normalized over valid pixels.  Map invalid
                # pixels to the meter's 255-ignore convention.
                norm = np.linalg.norm(gt, ord=2, axis=2, keepdims=True)
                valid = norm[..., 0] != 0
                gt = np.where(valid[..., None], gt / (norm + 1e-12), 255.0)
            fname = os.path.join(save_dir, task, im_id)
            if task == "depth":
                pred = sio.loadmat(fname + ".mat")["depth"].astype(np.float32)
            else:
                img = cv2.imread(fname + ".png", cv2.IMREAD_UNCHANGED)
                if img is None:
                    raise FileNotFoundError(fname + ".png")
                if img.ndim == 3:
                    img = img[:, :, ::-1]  # BGR -> RGB (normals)
                pred = img.astype(np.float32)
                if task == "normals":
                    # reference folder protocol (eval_normals.py:38-40):
                    # dequantize and RE-normalize the uint8-quantized vectors
                    # before scoring (the meter itself does not renormalize)
                    vec = 2.0 * pred / 255.0 - 1.0
                    norm = np.linalg.norm(vec, ord=2, axis=2)[..., None]
                    vec = vec / (norm + 1e-12)
                    pred = (vec + 1.0) * 255.0 / 2.0
            meter.meters[task].update(pred[None], gt[None])
    results = meter.get_score()
    if "edge" in tasks and p.get("eval_edge_odsF", True):
        # true boundary odsF on the saved files — the in-process equivalent
        # of the reference's external seism job (run_evaluation_edge.py:
        # 30-85); exact (CSA-cardinality) correspondence by default
        from m3vit_tpu_torch.evaluation.edge_eval import (
            eval_edge_predictions_from_dir,
        )

        ods = eval_edge_predictions_from_dir(
            save_dir, dataset,
            thresholds=int(p.get("edge_odsF_thresholds", 25)),
            matcher=str(p.get("edge_odsF_matcher", "exact")),
            gts=edge_gts,
        )
        results["edge"].update(
            {k: ods[k] for k in ("odsF", "oisF", "ap", "ods_threshold")}
        )
    if p.get("setup") == "multi_task":
        stl = single_task_reference_dict(p["train_db_name"], p["TASK_NAMES"])
        if stl:
            results["multi_task_performance"] = calculate_multi_task_performance(
                results, stl
            )
    return results
