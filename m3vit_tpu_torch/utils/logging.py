"""Logging: stdout tee + structured metric logger (the port's own copy of
m3vit_tpu/utils/logging.py).

reference: utils/logger.py (stdout tee to log_file.txt) and
utils/wandb_logger.py (singleton with train/val/best/analysis namespaces).
Metrics always go to a jsonl file with the namespaced keys; with
use_wandb they also go to wandb, and then its absence raises.  Device
memory comes from the torch.cuda statistics.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from typing import Dict, Optional


class Tee:
    """Mirror stdout/stderr into a log file (reference Logger, logger.py:9-43)."""

    def __init__(self, path: str, stream):
        self.stream = stream
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.f = open(path, "a")

    def write(self, data):
        self.stream.write(data)
        self.f.write(data)

    def flush(self):
        self.stream.flush()
        self.f.flush()


def setup_stdout_tee(output_dir: str):
    """Mirrors stdout and stderr into <output_dir>/log_file.txt; returns a
    function that restores both streams and closes the file."""
    prev = sys.stdout, sys.stderr
    sys.stdout = Tee(os.path.join(output_dir, "log_file.txt"), sys.stdout)
    sys.stderr = Tee(os.path.join(output_dir, "log_file.txt"), sys.stderr)
    tees = sys.stdout, sys.stderr

    def restore():
        sys.stdout, sys.stderr = prev
        for t in tees:
            t.f.close()

    return restore


class MetricLogger:
    """Namespaced metric logging: jsonl always, wandb when asked for."""

    def __init__(self, output_dir: str, use_wandb: bool = False,
                 config: Optional[Dict] = None, run_name: Optional[str] = None,
                 project: Optional[str] = None, entity: Optional[str] = None):
        os.makedirs(output_dir, exist_ok=True)
        self.jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self.step = 0
        self.wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                raise RuntimeError(
                    "--wandb was given but wandb is not installed") from e
            self.wandb = wandb.init(
                project=project or "m3vit_tpu", name=run_name,
                entity=entity,
                config={k: str(v) for k, v in (config or {}).items()},
            )

    def close(self):
        self.jsonl.close()
        if self.wandb is not None:
            self.wandb.finish()

    def log(self, metrics: Dict, step: Optional[int] = None):
        # global monotonic step regardless of caller, like the reference's
        # singleton logger (wandb_logger.py:404-430)
        step = step if step is not None else self.step
        self.step = max(self.step, step + 1)
        rec = {"_step": step, "_t": time.time()}
        rec.update({k: _to_py(v) for k, v in metrics.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def log_train_losses(self, losses: Dict, epoch: int, step: int):
        """Reference train-loss namespace (wandb_logger.py:134-183):
        train/loss_<task>, train/cv_loss, train/semregu_loss,
        train/regu_subimage_loss, train/total_loss, train/tam_levelN_loss_*,
        train/levelN_loss_*; MoE analysis aggregates go to analysis/* and
        moe/* (wandb_logger.py:325-399)."""
        out: Dict = {"train/epoch": epoch}
        for k, v in losses.items():
            out.update(_map_train_metric(k, v))
        self.log(out, step)

    def log_val_performance(self, results: Dict, epoch: int):
        """val/<task>_<metric> canonical names (wandb_logger.py:238-276)
        plus the full flattened result tree."""
        flat = _flatten("val", results)
        flat.update(_canonical_task_metrics("val", results))
        flat["val/epoch"] = epoch
        self.log(flat)

    def log_best(self, results: Dict, epoch: int):
        """best/<task>_<metric> (reference log_best_results,
        wandb_logger.py:277-300) plus the full flattened tree."""
        flat = _flatten("best", results)
        flat.update(_canonical_task_metrics("best", results))
        flat["best/epoch"] = epoch
        self.log(flat)

    def log_learning_rate(self, lr: float, step: Optional[int] = None):
        """reference wandb_logger.py:302-312"""
        self.log({"train/lr": float(lr)}, step)

    def log_epoch(self, epoch: int):
        """reference wandb_logger.py:314-323"""
        self.log({"epoch": epoch})

    def log_memory(self, step: Optional[int] = None):
        """Device + host memory under memory/* (the reference's CUDA memory
        prints): allocated, peak allocated and total bytes per card from
        torch.cuda, and host RSS."""
        import torch

        out = {}
        if torch.cuda.is_initialized():
            for d in range(torch.cuda.device_count()):
                out[f"memory/device{d}/bytes_in_use"] = \
                    torch.cuda.memory_allocated(d)
                out[f"memory/device{d}/peak_bytes_in_use"] = \
                    torch.cuda.max_memory_allocated(d)
                out[f"memory/device{d}/bytes_limit"] = \
                    torch.cuda.get_device_properties(d).total_memory
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        out["memory/host_rss_kb"] = int(line.split()[1])
                        break
        except OSError:
            pass
        if out:
            self.log(out, step)


_ANALYSIS_KEYS = frozenset({
    "gate_entropy_mean", "top1_prob_mean", "dead_expert_ratio",
    "expert_load_cv",
})


def _map_train_metric(k: str, v) -> Dict:
    """One train-step metric -> reference logging namespace + name."""
    if k == "expert_load_hist":
        return {f"analysis/expert_load_hist/e{i}": h
                for i, h in enumerate(_to_py(v) or [])}
    if k in _ANALYSIS_KEYS:
        return {f"analysis/{k}": v}
    if k == "moe_dropped_frac":
        return {"moe/dropped_slot_fraction": v}
    if k == "loss_total":
        return {"train/total_loss": v}
    if k == "loss_cv":
        return {"train/cv_loss": v}
    if k == "loss_total_with_cv":
        return {"train/total_loss_with_cv": v}
    if k == "loss_semregu":
        return {"train/semregu_loss": v}
    if k == "loss_regu_subimage":
        return {"train/regu_subimage_loss": v}
    m = re.fullmatch(r"loss_(tam_)?level(\d)_(.+)", k)
    if m:
        tam, lvl, task = m.groups()
        return {f"train/{tam or ''}level{lvl}_loss_{task}": v}
    return {f"train/{k}": v}


def _canonical_task_metrics(ns: str, results: Dict) -> Dict:
    """Per-task canonical metric names (reference wandb_logger.py:185-300)."""
    names = {
        "semseg": [("mIoU", "mIoU"), ("acc", "acc")],
        "human_parts": [("mIoU", "mIoU"), ("acc", "acc")],
        "depth": [("rmse", "rmse"), ("abs_err", "abs_err")],
        "normals": [("mean", "mean"), ("median", "median"),
                    ("11.25", "11.25"), ("22.5", "22.5"), ("30", "30")],
        "edge": [("odsF", "odsF"), ("loss", "loss")],
        "sal": [("maxF", "maxF"), ("mIoU", "mIoU")],
    }
    out = {}
    for task, pairs in names.items():
        r = results.get(task)
        if not isinstance(r, dict):
            continue
        for src, dst in pairs:
            if src in r:
                out[f"{ns}/{task}_{dst}"] = _to_py(r[src])
    if "multi_task_performance" in results:
        out[f"{ns}/multi_task_performance"] = _to_py(
            results["multi_task_performance"])
    return out


def _to_py(v):
    try:
        import numpy as np

        if isinstance(v, (np.ndarray,)):
            return v.tolist()
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            return v.item()
    except Exception:
        pass
    if isinstance(v, (list, tuple, dict, str, int, float, bool, type(None))):
        return v
    try:
        return float(v)
    except Exception:
        return str(v)


def _flatten(prefix: str, d: Dict) -> Dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(key, v))
        else:
            out[key] = _to_py(v)
    return out
