"""Online per-task performance meters + the Δm multi-task metric (the
port's own copy of m3vit_tpu/evaluation/meters.py).

Numerics mirror the reference meters exactly:
  SemsegMeter      evaluation/eval_semseg.py:83-147  (TP/FP/FN jaccard, valid=gt!=255)
  HumanPartsMeter  evaluation/eval_human_parts.py:78-122
  NormalsMeter     evaluation/eval_normals.py:66-110 (pred in [0,255] -> [-1,1])
  DepthMeter       evaluation/eval_depth.py:61-95    (accumulated rmse/log_rmse)
  SaliencyMeter    evaluation/eval_sal.py:69-130     (threshold sweep 0.2..0.9 x15)
  EdgeMeter        evaluation/eval_edge.py:14-40     (balanced-BCE proxy; true odsF
                                                      comes from the offline evaluator)
  PerformanceMeter evaluation/evaluate_utils.py:17-42
  Δm               evaluation/evaluate_utils.py:45-70 with the hard-coded STL
                   anchor dicts (:396-403)

Meters take get_output()-processed predictions (see outputs.py) as numpy.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def jaccard(gt: np.ndarray, pred: np.ndarray) -> float:
    """reference: evaluation/jaccard.py:12-28 (no void pixels path)."""
    gt = gt.astype(bool)
    pred = pred.astype(bool)
    if np.isclose(gt.sum(), 0) and np.isclose(pred.sum(), 0):
        return 1.0
    return float((gt & pred).sum() / np.sum(gt | pred, dtype=np.float32))


def precision_recall(gt: np.ndarray, pred: np.ndarray):
    gt = gt.astype(bool)
    pred = pred.astype(bool)
    tp = (pred & gt).sum()
    fp = (pred & ~gt).sum()
    fn = (~pred & gt).sum()
    return tp / (tp + fp + 1e-12), tp / (tp + fn + 1e-12)


class _JaccardMeter:
    """Shared TP/FP/FN-per-class jaccard machinery (semseg / human parts)."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def reset(self):
        self.tp = np.zeros(self.n_classes, np.int64)
        self.fp = np.zeros(self.n_classes, np.int64)
        self.fn = np.zeros(self.n_classes, np.int64)

    def update(self, pred: np.ndarray, gt: np.ndarray):
        pred = np.squeeze(np.asarray(pred))
        gt = np.squeeze(np.asarray(gt))
        valid = gt != 255
        for i in range(self.n_classes):
            tmp_gt = gt == i
            tmp_pred = pred == i
            self.tp[i] += int((tmp_gt & tmp_pred & valid).sum())
            self.fp[i] += int((~tmp_gt & tmp_pred & valid).sum())
            self.fn[i] += int((tmp_gt & ~tmp_pred & valid).sum())

    def get_score(self, verbose: bool = False) -> Dict:
        jac = [
            float(self.tp[i]) / max(float(self.tp[i] + self.fp[i] + self.fn[i]), 1e-8)
            for i in range(self.n_classes)
        ]
        return {"jaccards_all_categs": jac, "mIoU": float(np.mean(jac))}


class SemsegMeter(_JaccardMeter):
    def __init__(self, database: str):
        n = {"PASCALContext": 21, "NYUD": 40, "CityScapes": 7}[database]
        super().__init__(n)


class HumanPartsMeter(_JaccardMeter):
    def __init__(self, database: str = "PASCALContext"):
        assert database == "PASCALContext"
        super().__init__(7)


class NormalsMeter:
    """Angular error in degrees; pred arrives in [0,255] (get_output scale)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sums = {"mean": 0.0, "rmse": 0.0, "11.25": 0.0, "22.5": 0.0, "30": 0.0}
        self.n = 0

    def update(self, pred: np.ndarray, gt: np.ndarray):
        pred = 2.0 * np.asarray(pred, np.float32) / 255.0 - 1.0  # [B,H,W,3]
        gt = np.asarray(gt, np.float32)
        valid = gt[..., 0] != 255
        pred = np.where(gt == 255, 0.0, pred)
        gt = np.where(gt == 255, 0.0, gt)
        dot = np.clip((pred * gt).sum(-1), -1.0, 1.0)
        deg = np.degrees(np.arccos(dot))[valid]
        self.sums["mean"] += float(deg.sum())
        self.sums["rmse"] += float((deg**2).sum())
        self.sums["11.25"] += float((deg < 11.25).sum()) * 100
        self.sums["22.5"] += float((deg < 22.5).sum()) * 100
        self.sums["30"] += float((deg < 30).sum()) * 100
        self.n += deg.size

    def get_score(self, verbose: bool = False) -> Dict:
        n = max(self.n, 1)
        return {
            "mean": self.sums["mean"] / n,
            "rmse": (self.sums["rmse"] / n) ** 0.5,
            "11.25": self.sums["11.25"] / n,
            "22.5": self.sums["22.5"] / n,
            "30": self.sums["30"] / n,
        }


class DepthMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_rmses = 0.0
        self.total_log_rmses = 0.0
        self.n_valid = 0.0

    def update(self, pred: np.ndarray, gt: np.ndarray):
        pred = np.squeeze(np.asarray(pred, np.float32))
        gt = np.squeeze(np.asarray(gt, np.float32))
        mask = gt != 255
        self.n_valid += float(mask.sum())
        pred = np.clip(pred, 1e-9, None)
        safe_gt = np.clip(gt, 1e-9, None)
        self.total_log_rmses += float(
            ((np.log(safe_gt) - np.log(pred)) ** 2)[mask].sum()
        )
        self.total_rmses += float(((gt - pred) ** 2)[mask].sum())

    def get_score(self, verbose: bool = False) -> Dict:
        n = max(self.n_valid, 1.0)
        return {
            "rmse": (self.total_rmses / n) ** 0.5,
            "log_rmse": (self.total_log_rmses / n) ** 0.5,
        }


class SaliencyMeter:
    """Per-image jaccard/precision/recall over a 15-point threshold sweep."""

    def __init__(self):
        self.mask_thres = np.linspace(0.2, 0.9, 15)
        self.reset()

    def reset(self):
        self.all_jac: List[np.ndarray] = []
        self.prec: List[np.ndarray] = []
        self.rec: List[np.ndarray] = []

    def update(self, pred: np.ndarray, gt: np.ndarray):
        pred = np.asarray(pred, np.float32) / 255.0  # [B, H, W]
        gt = np.squeeze(np.asarray(gt))
        if pred.ndim == 2:
            pred = pred[None]
        if gt.ndim == 2:
            gt = gt[None]
        b = pred.shape[0]
        jac = np.zeros((b, len(self.mask_thres)))
        prec = np.zeros((b, len(self.mask_thres)))
        rec = np.zeros((b, len(self.mask_thres)))
        for j, thr in enumerate(self.mask_thres):
            mask_eval = pred > thr
            for i in range(b):
                jac[i, j] = jaccard(gt[i], mask_eval[i])
                prec[i, j], rec[i, j] = precision_recall(gt[i], mask_eval[i])
        self.all_jac.append(jac)
        self.prec.append(prec)
        self.rec.append(rec)

    def get_score(self, verbose: bool = False) -> Dict:
        jac = np.concatenate(self.all_jac)
        prec = np.concatenate(self.prec).mean(0)
        rec = np.concatenate(self.rec).mean(0)
        f = 2 * prec * rec / (prec + rec + 1e-12)
        return {
            "mIoUs": jac.mean(0).tolist(),
            "mIoU": float(jac.mean(0).max()),
            "maxF": float(f.max()),
        }


class EdgeMeter:
    """Proxy metric: balanced BCE in probability space on [0,255] preds.
    True odsF comes from the offline boundary evaluator
    (m3vit_tpu_torch.evaluation.edge_eval)."""

    def __init__(self, pos_weight: float):
        self.pos_weight = pos_weight
        self.reset()

    def reset(self):
        self.loss = 0.0
        self.n = 0

    def update(self, pred: np.ndarray, gt: np.ndarray):
        gt = np.squeeze(np.asarray(gt, np.float32))
        pred = np.squeeze(np.asarray(pred, np.float32)) / 255.0
        labels = (gt >= 0.5).astype(np.float32)
        w = self.pos_weight
        # the reference feeds probabilities into the logit-space balanced BCE
        # (eval_edge.py:22-25); reproduce that literally
        out_gt_zero = (pred >= 0).astype(np.float32)
        loss_val = pred * (labels - out_gt_zero) - np.log1p(
            np.exp(pred - 2.0 * pred * out_gt_zero)
        )
        loss_pos = -(labels * loss_val).sum()
        loss_neg = -((1 - labels) * loss_val).sum()
        loss = (w * loss_pos + (1 - w) * loss_neg) / gt.size
        self.loss += gt.size * float(loss)
        self.n += gt.size

    def get_score(self, verbose: bool = False) -> Dict:
        return {"loss": self.loss / max(self.n, 1)}


def get_single_task_meter(p, database: str, task: str):
    if task == "semseg":
        return SemsegMeter(database)
    if task == "human_parts":
        return HumanPartsMeter(database)
    if task == "normals":
        return NormalsMeter()
    if task == "depth":
        return DepthMeter()
    if task == "sal":
        return SaliencyMeter()
    if task == "edge":
        return EdgeMeter(pos_weight=float(p["edge_w"]))
    raise NotImplementedError(task)


class PerformanceMeter:
    """Multi-task meter dict (reference: evaluate_utils.py:17-42)."""

    def __init__(self, p):
        self.database = p["train_db_name"]
        self.tasks = list(p["TASK_NAMES"])
        self.meters = {
            t: get_single_task_meter(p, self.database, t) for t in self.tasks
        }

    def reset(self):
        for m in self.meters.values():
            m.reset()

    def update(self, pred: Dict, gt: Dict):
        for t in (pred.keys() if len(pred) < len(self.tasks) else self.tasks):
            self.meters[t].update(pred[t], gt[t])

    def get_score(self, verbose: bool = False) -> Dict:
        return {t: self.meters[t].get_score(verbose) for t in self.tasks}


# Hard-coded single-task anchors (reference: evaluate_utils.py:396-403).
_STL_DICTS = {
    "NYUD": {
        "depth": {"rmse": 0.585},
        "semseg": {"mIoU": 0.439},
        "normals": {"mean": 19.763},
    },
    "PASCALContext": {
        "human_parts": {"mIoU": 0.599},
        "semseg": {"mIoU": 0.662},
        "normals": {"mean": 13.9},
        "sal": {"mIoU": 0.663},
    },
    "CityScapes": {"depth": {"rmse": 0.585}, "semseg": {"mIoU": 0.727}},
}


def single_task_reference_dict(database: str, task_names: List[str]) -> Dict:
    d = {k: dict(v) for k, v in _STL_DICTS[database].items()}
    return {k: v for k, v in d.items() if k in task_names}


def calculate_multi_task_performance(
    eval_dict: Dict, single_task_dict: Dict
) -> float:
    """Δm (reference: evaluate_utils.py:45-70)."""
    assert set(eval_dict.keys()) >= set(single_task_dict.keys())
    perf = 0.0
    for task, stl in single_task_dict.items():
        mtl = eval_dict[task]
        if task == "depth":
            perf -= (mtl["rmse"] - stl["rmse"]) / stl["rmse"]
        elif task in ("semseg", "sal", "human_parts"):
            perf += (mtl["mIoU"] - stl["mIoU"]) / stl["mIoU"]
        elif task == "normals":
            perf -= (mtl["mean"] - stl["mean"]) / stl["mean"]
        elif task == "edge":
            perf += (mtl["odsF"] - stl["odsF"]) / stl["odsF"]
        else:
            raise NotImplementedError(task)
    return perf / len(single_task_dict)
