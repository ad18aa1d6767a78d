"""Checkpoints with ``torch.save`` (counterpart of the orbax-based
m3vit_tpu/utils/checkpoint.py).

A checkpoint directory holds ``{index}.pt`` files, the index an epoch or,
for mid-epoch step checkpoints, a global step, each with its
``meta_{index}.json`` sidecar as the JAX module writes it ({"epoch":
index, **extra}).  A file holds the model's state dict (the reference's
parameter names), the optimizer's state, the train step's call counter
(which drives the lr schedule) and the meta dict, whose ``epoch`` and
``next_it`` say where a resumed run goes on.  The newest ``max_to_keep``
(3) indices are kept.  Saving is crash-safe: the file is written whole to
a temporary name and then moved over the old one with ``os.replace``, so a
death mid-save never destroys the only copy of an index.

Under expert parallelism (a ``parallel`` layout passed as ``layout``) a
checkpoint is still the one-card state: every rank gathers the expert
banks (and their optimizer state) over its expert group, rank 0 writes,
and a restore cuts each bank to the restoring rank's shard, so a run
resumes at any n_expert and a one-card checkpoint starts a parallel run.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import torch

from m3vit_tpu_torch import parallel

_PT = re.compile(r"^(\d+)\.pt$")


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def indices(directory: str) -> List[int]:
    """The checkpoint indices in `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_PT.match,
                                               os.listdir(directory)) if m)


def latest_index(directory: str) -> Optional[int]:
    found = indices(directory)
    return found[-1] if found else None


def save_checkpoint(directory: str, index: int, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    train_step_calls: int = 0, extra: Optional[Dict] = None,
                    max_to_keep: int = 3, layout=None) -> str:
    """Writes checkpoint `index` (overwriting it, crash-safe) and its meta
    sidecar, then removes all but the newest `max_to_keep` indices;
    returns the file's path.  With a parallel `layout` every rank must
    call it: the expert banks are gathered, and rank 0 writes."""
    meta = {"epoch": index, **(extra or {})}
    path = os.path.join(directory, f"{index}.pt")
    if layout is not None:
        sd, osd = parallel.full_state(model, optimizer, layout)
        if layout.rank != 0:
            return path
    else:
        sd = model.state_dict()
        osd = None if optimizer is None else optimizer.state_dict()
    os.makedirs(directory, exist_ok=True)
    payload = {"model": sd, "optimizer": osd,
               "train_step_calls": int(train_step_calls), "meta": meta}
    _atomic_write(path, lambda tmp: torch.save(payload, tmp))

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f)

    _atomic_write(os.path.join(directory, f"meta_{index}.json"), write_meta)
    for old in indices(directory)[:-max_to_keep]:
        for name in (f"{old}.pt", f"meta_{old}.json"):
            try:
                os.remove(os.path.join(directory, name))
            except FileNotFoundError:
                pass
    return path


def restore_checkpoint(directory: str, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None,
                       index: Optional[int] = None,
                       layout=None) -> Optional[Dict]:
    """Loads checkpoint `index` (the newest when None) into `model` (strict)
    and `optimizer`, onto the model's device; returns its meta dict with
    ``train_step_calls`` added, or None when there is no checkpoint.  With
    a parallel `layout` the expert banks are cut to the rank's shard."""
    index = latest_index(directory) if index is None else index
    if index is None:
        return None
    device = next(model.parameters()).device
    payload = torch.load(os.path.join(directory, f"{index}.pt"),
                         map_location=device, weights_only=True)
    sd, osd = payload["model"], payload["optimizer"]
    if layout is not None:
        sd, osd = parallel.shard_state(model, optimizer, sd, osd, layout)
    model.load_state_dict(sd, strict=True)
    if optimizer is not None and osd is not None:
        optimizer.load_state_dict(osd)
    return {**payload["meta"],
            "train_step_calls": int(payload["train_step_calls"])}
