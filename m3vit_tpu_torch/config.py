"""Config system: two-file YAML (env paths + experiment) merged into one dict
(the port's own copy of m3vit_tpu/config.py:21-160).

Schema-compatible with the reference's configs/*.yml and path_env.yml
(reference: utils/config.py:97-231). Differences:
  * interpolation modes are strings ('nearest'/'linear'/'cubic'), not cv2 ints
  * without root_dir (env) or save_dir (args), runs go under the temporary
    directory ($TMPDIR/m3vit_tpu_torch)
  * MoE expert counts stay GLOBAL; expert parallelism is a sharding decision,
    not a config mutation (the reference divides moe_experts by world_size,
    common_config.py:179-185)
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional

import yaml

from m3vit_tpu_torch.tasks import TaskSpec, parse_task_dictionary, task_names


class AttrDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, AttrDict):
            return cls(v)
        if isinstance(v, list):
            return [cls._wrap(x) for x in v]
        return v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)


# Per-dataset train/test scales (reference: utils/config.py:163-179)
_DB_SCALES = {
    "PASCALContext": ((512, 512), (512, 512)),
    "NYUD": ((480, 640), (480, 640)),
    "CityScapes": ((128, 256), (128, 256)),
}


def _expand(path: str) -> str:
    return os.path.expandvars(os.path.expanduser(path))


def load_env(env_file: str) -> Dict[str, Any]:
    with open(env_file, "r") as f:
        env_cfg = yaml.safe_load(f) or {}
    return env_cfg


def create_config(
    env_file: Optional[str],
    exp_file: str,
    args: Optional[Dict[str, Any]] = None,
    make_dirs: bool = False,
) -> AttrDict:
    """Build the full experiment config `p`.

    `args` is a flat dict of CLI overrides applied after the YAML merge
    (the reference applies ~40 argparse flags the same way,
    train_fastmoe.py:232-266).
    """
    args = dict(args or {})

    env_cfg: Dict[str, Any] = {}
    if env_file is not None:
        env_cfg = load_env(env_file)

    root_dir = args.get("save_dir") or env_cfg.get(
        "root_dir", os.path.join(tempfile.gettempdir(), "m3vit_tpu_torch"))
    root_dir = _expand(str(root_dir))
    if args.get("run_name"):
        root_dir = os.path.join(root_dir, str(args["run_name"]))

    with open(exp_file, "r") as f:
        exp_cfg = yaml.safe_load(f)

    p = AttrDict(exp_cfg)
    p["db_paths"] = {
        k: _expand(str(v)) for k, v in (env_cfg.get("dataset_roots") or {}).items()
    }
    if "db_root_dir" in env_cfg:
        p["db_root_dir"] = _expand(str(env_cfg["db_root_dir"]))

    # Task dictionary expansion (reference: utils/config.py:129-159)
    tasks, extra = parse_task_dictionary(p["train_db_name"], p["task_dictionary"])
    for k, v in extra.items():
        p[k] = v
    p["TASKS"] = tasks
    p["TASK_NAMES"] = task_names(tasks)

    if "auxilary_task_dictionary" in p:
        aux_tasks, extra = parse_task_dictionary(
            p["train_db_name"], p["auxilary_task_dictionary"]
        )
        for k, v in extra.items():
            p[k] = v
        p["AUXILARY_TASKS"] = aux_tasks
        all_tasks = list(tasks)
        for t in aux_tasks:
            if t.name not in [x.name for x in all_tasks]:
                all_tasks.append(t)
        p["ALL_TASKS"] = all_tasks
    else:
        p["ALL_TASKS"] = list(tasks)

    if p["train_db_name"] not in _DB_SCALES:
        raise NotImplementedError(p["train_db_name"])
    train_scale, test_scale = _DB_SCALES[p["train_db_name"]]
    # explicit YAML override (non-reference extension; used by smoke configs)
    p["train_scale"] = tuple(p.get("train_scale", train_scale))
    p["test_scale"] = tuple(p.get("test_scale", test_scale))

    # Flag defaults (reference: utils/config.py:196-213)
    p.setdefault("overfit", False)
    p.setdefault("multi_level", False)
    p["use_cv_loss"] = bool(args.get("use_cv_loss", p.get("use_cv_loss", False)))
    p["use_checkpointing"] = bool(
        args.get("use_checkpointing", p.get("use_checkpointing", False))
    )

    # CLI overrides: every remaining arg key overwrites / inserts into p.
    for k, v in args.items():
        if k in ("save_dir", "run_name"):
            continue
        if v is not None:
            p[k] = v

    # Output directory layout (reference: utils/config.py:216-230)
    model_name = (p.get("backbone_kwargs") or {}).get("model_name")
    leaf = model_name if model_name else p.get("backbone", p.get("model", "model"))
    output_dir = os.path.join(root_dir, p["train_db_name"], str(leaf))
    p["root_dir"] = root_dir
    p["output_dir"] = output_dir
    p["save_dir"] = os.path.join(output_dir, "results")
    p["checkpoint_dir"] = os.path.join(output_dir, "checkpoint")
    p["best_model_dir"] = os.path.join(output_dir, "best_model")

    if make_dirs:
        os.makedirs(p["output_dir"], exist_ok=True)
        os.makedirs(p["save_dir"], exist_ok=True)

    return p


def tasks_of(p: AttrDict) -> List[TaskSpec]:
    return list(p["TASKS"])
