"""Numerical tracing: layer output dumps for diffing the port against the
JAX package (or the torch reference), the module tree, a profiler context
and FLOP counts (counterpart of m3vit_tpu/utils/tracing.py; reference
utils/tracing.py:56-316).

* ``trace_model`` runs a model with a forward hook on every module and
  keeps, per module path (the port's names, which are the torch
  reference's: ``backbone.patch_embed``, ``backbone.blocks.0``,
  ``decoders.semseg.conv_0``), a summary of its output: shape, dtype,
  mean, std and the first 100 values.  4-D outputs (NCHW convolutions)
  are summarised in NHWC order, the JAX package's layout, so the two
  packages' dumps line up element for element.
* ``dump_trace`` / ``load_trace`` write and read the JAX package's
  JSON-lines format (one ``{"layer": path, ...}`` a line), and
  ``numeric_diff`` compares two traces' stored values.
* ``profile_trace`` records a ``torch.profiler`` trace (the card's kernels
  too when CUDA is available) and writes it as a Chrome trace.
* ``flops_of`` counts a call's FLOPs with ``FlopCounterMode``; the
  hand-written kernels are opaque to a dispatch mode, so each kernel
  wrapper states its FLOPs from its shapes (``ops/_build.count_launch``),
  counted as the mode counts its plain version: the count on the card
  equals the plain path's on the same model.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from m3vit_tpu_torch.ops import _build


def _summarize(x: torch.Tensor, first_k: int = 100) -> Dict:
    t = x.detach()
    if t.ndim == 4:
        t = t.permute(0, 2, 3, 1)
    arr = t.float().cpu().numpy()
    flat = arr.reshape(-1).astype(np.float64)
    return {
        "shape": list(arr.shape),
        "dtype": str(x.dtype).replace("torch.", ""),
        "mean": float(flat.mean()) if flat.size else 0.0,
        "std": float(flat.std()) if flat.size else 0.0,
        "first": flat[:first_k].round(6).tolist(),
    }


def _first_tensor(out):
    if torch.is_tensor(out):
        return out
    if isinstance(out, (tuple, list)) and out:
        return _first_tensor(out[0])
    if isinstance(out, dict) and out:
        return _first_tensor(next(iter(out.values())))
    return None


def trace_model(model: torch.nn.Module, *args,
                filter_fn: Optional[Callable[[str], bool]] = None,
                first_k: int = 100, **kwargs) -> Dict[str, Dict]:
    """Runs model(*args, **kwargs) without autograd, with a forward hook on
    every submodule; returns {module path: summary of its output} (a
    tuple's or dict's first tensor).  filter_fn gets the dotted path and
    keeps everything by default; a module run twice keeps its last
    output."""
    traces: Dict[str, Dict] = {}
    handles = []
    for name, mod in model.named_modules():
        if not name or (filter_fn is not None and not filter_fn(name)):
            continue

        def hook(_mod, _inp, out, name=name):
            t = _first_tensor(out)
            if t is not None:
                traces[name] = _summarize(t, first_k)

        handles.append(mod.register_forward_hook(hook))
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return traces


def dump_trace(traces: Dict[str, Dict], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for name in sorted(traces):
            f.write(json.dumps({"layer": name, **traces[name]}) + "\n")


def load_trace(path: str) -> Dict[str, Dict]:
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out[rec.pop("layer")] = rec
    return out


def numeric_diff(a: Dict[str, Dict], b: Dict[str, Dict]) -> Dict[str, float]:
    """Max abs difference of the stored value prefixes of the layers in
    both traces."""
    diffs = {}
    for k in sorted(set(a) & set(b)):
        va, vb = a[k].get("first", []), b[k].get("first", [])
        n = min(len(va), len(vb))
        if n:
            diffs[k] = float(np.abs(np.asarray(va[:n])
                                    - np.asarray(vb[:n])).max())
    return diffs


def module_tree(model: torch.nn.Module) -> str:
    """The module tree with each parameter's and buffer's shape and dtype
    (the reference's constructor logging, tracing.py:228-316)."""
    lines = []
    for name, mod in model.named_modules():
        depth = name.count(".") + 1 if name else 0
        lines.append("  " * depth + (name.rsplit(".", 1)[-1] or
                                     type(model).__name__)
                     + f" ({type(mod).__name__})")
        for pname, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            lines.append("  " * (depth + 1) + f"{pname}: {tuple(t.shape)} "
                         f"{str(t.dtype).replace('torch.', '')}")
    return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A torch.profiler recording (CPU, and the card's kernels when CUDA is
    available) written to ``<log_dir>/trace.json`` (Chrome trace format)
    on exit; yields the profiler, whose ``key_averages()`` tabulates it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def flops_of(fn: Callable, *args, **kwargs) -> float:
    """The FLOPs of fn(*args, **kwargs): products and convolutions as
    FlopCounterMode counts them, plus each hand-written kernel launch's
    stated FLOPs (ops/_build.count_launch)."""
    tally: Dict[str, float] = {}
    _build.flop_tallies.append(tally)
    try:
        with FlopCounterMode(display=False) as mode:
            fn(*args, **kwargs)
    finally:
        _build.flop_tallies.remove(tally)
    return float(mode.get_total_flops() + sum(tally.values()))
