"""Task registry: per-dataset output dims, interpolation modes, loss wiring.

The port's own copy of m3vit_tpu/tasks.py:20-87 (reference
utils/config.py:17-94), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

NEAREST = "nearest"
LINEAR = "linear"
CUBIC = "cubic"


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Static description of one dense-prediction task."""

    name: str
    num_output: int
    # interpolation used when resizing the *label* during data augmentation
    flagval: str
    # interpolation used when resizing *predictions* back to original size
    infer_flagval: str
    # loss function key: 'softmax_ce' | 'balanced_bce' | 'bce' | 'normals_l1' | 'depth_l1'
    loss_kind: str


# dataset name -> semseg class count (reference: utils/config.py:34-41)
_SEMSEG_CLASSES = {"PASCALContext": 21, "NYUD": 40, "CityScapes": 7}


def parse_task_dictionary(
    db_name: str, task_dictionary: Dict
) -> Tuple[List[TaskSpec], Dict]:
    """Expand a YAML `task_dictionary` into TaskSpec list + extra config args,
    in the reference's task order: semseg, human_parts, sal, normals, edge,
    depth."""
    tasks: List[TaskSpec] = []
    extra: Dict = {}

    def inc(key: str) -> bool:
        return bool(task_dictionary.get(key, False))

    if inc("include_semseg"):
        if db_name not in _SEMSEG_CLASSES:
            raise NotImplementedError(f"semseg not defined for {db_name}")
        tasks.append(
            TaskSpec("semseg", _SEMSEG_CLASSES[db_name], NEAREST, NEAREST, "softmax_ce")
        )

    if inc("include_human_parts"):
        assert db_name == "PASCALContext"
        tasks.append(TaskSpec("human_parts", 7, NEAREST, NEAREST, "softmax_ce"))

    if inc("include_sal"):
        assert db_name == "PASCALContext"
        tasks.append(TaskSpec("sal", 1, NEAREST, LINEAR, "balanced_bce"))

    if inc("include_normals"):
        assert db_name in ("PASCALContext", "NYUD")
        tasks.append(TaskSpec("normals", 3, CUBIC, LINEAR, "normals_l1"))
        extra["normloss"] = 1

    if inc("include_edge"):
        assert db_name in ("PASCALContext", "NYUD")
        tasks.append(TaskSpec("edge", 1, NEAREST, LINEAR, "balanced_bce"))
        extra["edge_w"] = task_dictionary["edge_w"]
        extra["eval_edge"] = False

    if inc("include_depth"):
        assert db_name in ("NYUD", "CityScapes")
        tasks.append(TaskSpec("depth", 1, NEAREST, LINEAR, "depth_l1"))
        extra["depthloss"] = "l1"

    return tasks, extra


def task_names(tasks: List[TaskSpec]) -> List[str]:
    return [t.name for t in tasks]
