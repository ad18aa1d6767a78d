#!/usr/bin/env python3
"""How far a CNN model's f32 gradients sit from f64 ones, on the CPU.

    python3 scripts/cnn_grad_precision.py nyud/resnet50/nddr_cnn.yml \
        [--batch 2 --hw 128]
    python3 scripts/cnn_grad_precision.py --forward [CASE ...]

Builds the config (configs/<CONFIG>, full widths) with the port's
factory on the CPU, runs one train forward and backward of its loss
scheme on a synthetic batch in f32, then the same on an f64 copy of the
model with the f32 run's ReLU and dropout masks replayed (so both take
the same branches), and prints one JSON line: the loss of each and, per
parameter group (the top module's leading word, as chip_smoke.py groups
them), |g32 - g64| / |g64|.  That is the f32 step's own rounding error,
the yardstick for comparing two f32 summation orders (the card's cuDNN
against the CPU's, chip_smoke.py's cnn_vs_cpu).

The port computes BatchNorm and the MTL methods' own layers in f32 by
design; for the f64 run the script widens those helpers.

With --forward it does the same for the forward outputs and the
BatchNorm running statistics of each case of tests/test_torch_port_cnn.py
(``FORWARD_CASES``), for both packages.  The JAX package's f32 results
come from the test's own worker (``python -m tests.torch_port_cnn_jax``,
run as a subprocess, four at a time: this script imports no JAX); the
port loads the same weights and input and runs its f32 forward and an f64
copy's, JAX's ReLU and dropout masks replayed in both train forwards.
The f64 run is the reference for both packages' f32 values (the JAX
modules pin their compute dtype to f32, so an f64 run of them would be
another model).  One JSON line a case: per output (eval and train) and
for the running statistics, the largest |f32 - f64| over the tensor's
scale, max(1, max |f64|), the measure the test holds to 5e-5, for the
port and for JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile

import numpy as np

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from m3vit_tpu_torch.config import create_config  # noqa: E402
from m3vit_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from m3vit_tpu_torch.losses.schemes import (  # noqa: E402
    build_loss_fns,
    loss_scheme_of,
)
from m3vit_tpu_torch.models import (  # noqa: E402
    build_model,
    cnn_heads,
    hrnet,
    mobilenetv3,
    mtl_methods,
    resnet,
)
from m3vit_tpu_torch.models.heads import batch_norm  # noqa: E402
from m3vit_tpu_torch.ops import dropout as dropout_ops  # noqa: E402
from m3vit_tpu_torch.utils.convert import (  # noqa: E402
    cnn_variables_to_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the shapes of tests/torch_port_cnn_jax.py's cases (a strict load of its
# weights checks them)
TASKS, AUX = ["semseg", "depth"], ["semseg", "depth", "normals"]
NUM_OUT = {"semseg": 5, "depth": 1, "normals": 3}
MTI_CH = (16, 16, 16, 16)
HR_SMALL = dict(channels=(16, 16, 32, 64), stage_modules=(1, 1, 1),
                stage1_blocks=1, num_blocks=1)


class _HeadAndFuse(torch.nn.Module):
    """The HRNet head and fuse module over four streams of x."""

    def __init__(self):
        super().__init__()
        self.head = cnn_heads.HighResolutionHead(32, 3)
        self.fuse = cnn_heads.HighResolutionFuse(32)

    def forward(self, x):
        xs = [x] + [F.avg_pool2d(x, s) for s in (2, 4, 8)]
        return [self.head(xs), self.fuse(xs)]


class _StandIn(torch.nn.Module):
    """Four strided streams standing in for HRNet under MTI-Net."""

    def __init__(self):
        super().__init__()
        self.conv0 = torch.nn.Conv2d(3, MTI_CH[0], 4, 4)
        for i in (1, 2, 3):
            setattr(self, f"conv{i}",
                    torch.nn.Conv2d(MTI_CH[i - 1], MTI_CH[i], 3, 2, 1))

    def forward(self, x):
        h = F.relu(self.conv0(x))
        xs = [h]
        for i in (1, 2, 3):
            h = F.relu(getattr(self, f"conv{i}")(h))
            xs.append(h)
        return xs


def _heads(cin: int):
    return {t: cnn_heads.HighResolutionHead(cin, NUM_OUT[t]) for t in TASKS}


def _stitched(cls):
    bbs = {t: resnet.ResNet("basic", (1, 1, 1, 1), 8) for t in TASKS}
    ch = bbs[TASKS[0]].stage_channels
    return cls(bbs, _heads(ch[-1]), TASKS, ch)


def _mtan():
    bb = resnet.resnet18(dilated=True)
    ch = bb.stage_channels
    return mtl_methods.MTAN(bb, _heads(ch[-1]), TASKS, ch,
                            (True, False, False, False))


_MTL = "mtl"   # called with a noise generator
#: case of tests/test_torch_port_cnn.py -> (the port's model, how to call it)
FORWARD_CASES = {
    "resnet-basic-0": (lambda: resnet.ResNet("basic", (1, 1, 1, 1), 0), None),
    "resnet-basic-8": (lambda: resnet.ResNet("basic", (1, 1, 1, 1), 8), None),
    "resnet-bottleneck-16": (
        lambda: resnet.ResNet("bottleneck", (1, 1, 1, 1), 16), None),
    "hrnet": (lambda: hrnet.HighResolutionNet(**HR_SMALL), None),
    "mobilenetv3-small": (lambda: mobilenetv3.MobileNetV3("small"), None),
    "mobilenetv3-large": (lambda: mobilenetv3.MobileNetV3("large"), None),
    "deeplab": (lambda: cnn_heads.DeepLabHead(32, 5), _MTL),
    "hrnet-head": (_HeadAndFuse, None),
    "cross_stitch": (lambda: _stitched(mtl_methods.CrossStitchNetwork), _MTL),
    "nddr_cnn": (lambda: _stitched(mtl_methods.NDDRCNN), _MTL),
    "mtan": (_mtan, _MTL),
    "padnet": (lambda: mtl_methods.PADNet(
        resnet.ResNet("basic", (1, 1, 1, 1), 8), 512, TASKS, AUX, NUM_OUT),
        _MTL),
    "mti_net": (lambda: mtl_methods.MTINet(
        _StandIn(), {t: cnn_heads.HighResolutionHead(sum(MTI_CH), NUM_OUT[t])
                     for t in TASKS}, TASKS, TASKS, NUM_OUT, MTI_CH), _MTL),
}


def widen_to_f64(model: torch.nn.Module) -> torch.nn.Module:
    """An f64 copy of `model`, its f32 helpers widened to the input's
    dtype."""
    for mod in (resnet, hrnet, mobilenetv3, cnn_heads, mtl_methods):
        mod.apply_bn = lambda b, x: batch_norm(b, x, b.training)
    mtl_methods.F32 = torch.float64
    torch.Tensor.float = lambda self: self
    m = copy.deepcopy(model).double()
    for sub in m.modules():
        if hasattr(sub, "dtype"):
            sub.dtype = torch.float64
    return m


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 3, 1, 2) if a.ndim == 4 else a))


def _leaves(out):
    """A model's outputs as a list of tensors (the MTL methods' (pred, cv,
    stats) reduced to pred), in the order of a sorted-key walk."""
    if isinstance(out, tuple) and len(out) == 3 and isinstance(out[0], dict):
        out = out[0]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _leaves(v)]
    return [out]


def _np_leaves(out):
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _np_leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _np_leaves(v)]
    return [out.transpose(0, 3, 1, 2) if out.ndim == 4 else out]


def _jax_results(cases, out_dir: str):
    """case -> the f32 results of tests/torch_port_cnn_jax.py for it, its
    worker processes four at a time."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get(
               "PYTHONPATH", "")])}
    groups = [cases[i::4] for i in range(4) if cases[i::4]]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_port_cnn_jax",
                               out_dir, *g], cwd=ROOT, env=env)
             for g in groups]
    for proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"the JAX worker {proc.args} failed")
    res = {}
    for name in cases:
        with open(os.path.join(out_dir, f"{name}.pkl"), "rb") as f:
            res[name] = pickle.load(f)
    return res


def _forward(model, how, res, x, dtype):
    """(eval outputs or None, train outputs, running statistics) of `model`
    on x, JAX's ReLU and dropout masks replayed in the train forward."""
    call = (lambda m, v: m(v, noise=torch.Generator())) if how == _MTL \
        else (lambda m, v: m(v))
    if how == _MTL and isinstance(model, cnn_heads.DeepLabHead):
        call = lambda m, v: m(v, torch.Generator())  # noqa: E731
    ev = None
    with torch.no_grad():
        if res["eval"] is not None:
            model.eval()
            ev = [t.detach().double() for t in _leaves(call(model, x))]
        relus = [_nchw(m) for m in res["relu"]]
        drops = [_nchw(m) for m in res["dropout"]]
        relu, mask = F.relu, dropout_ops._mask
        F.relu = lambda v: torch.where(relus.pop(0), v,
                                       torch.zeros((), dtype=dtype))
        dropout_ops._mask = lambda shape, keep, rng, device: drops.pop(0)
        try:
            model.train()
            tr = [t.detach().double() for t in _leaves(call(model, x))]
        finally:
            F.relu, dropout_ops._mask = relu, mask
    if relus or drops:
        raise RuntimeError("the port ran fewer ReLUs or dropouts than JAX")
    stats = {k: v.double() for k, v in model.state_dict().items()
             if "running" in k}
    return ev, tr, stats


def _gap(a, ref) -> float:
    """max |a - ref| over the scale max(1, max |ref|)."""
    ref = torch.as_tensor(ref).double()
    return float((torch.as_tensor(a).double() - ref).abs().max()
                 / max(1.0, float(ref.abs().max())))


def forward_precision(cases) -> None:
    """One JSON line a case: the port's and JAX's f32 forward against the
    port's f64 forward (see the module's docstring)."""
    cases = list(cases or FORWARD_CASES)
    with tempfile.TemporaryDirectory(prefix="cnn_fwd_precision_") as d:
        jres = _jax_results(cases, d)
    f32 = {}
    for name in cases:
        build, how = FORWARD_CASES[name]
        res = jres[name]
        model = build()
        model.load_state_dict(cnn_variables_to_state_dict(res["variables"]),
                              strict=True)
        model64 = copy.deepcopy(model)
        f32[name] = (_forward(model, how, res, _nchw(res["x"]),
                              torch.float32), model64)
    widen_to_f64(torch.nn.Identity())   # the f32 helpers, widened
    for name in cases:
        res = jres[name]
        (ev32, tr32, st32), model64 = f32[name]
        ev64, tr64, st64 = _forward(widen_to_f64(model64), FORWARD_CASES[
            name][1], res, _nchw(res["x"]).double(), torch.float64)
        jst = cnn_variables_to_state_dict(
            {"params": res["variables"]["params"],
             "batch_stats": res["batch_stats"]})
        line = {"case": name}
        for what, port, jax_out, ref in (
                ("eval_output", ev32, res["eval"], ev64),
                ("train_output", tr32, res["train"], tr64)):
            if ref is None:
                continue
            jl = _np_leaves(jax_out)
            line[what] = {
                "port_f32_vs_f64": max(_gap(a, b) for a, b in zip(port, ref)),
                "jax_f32_vs_f64": max(_gap(np.asarray(a), b)
                                      for a, b in zip(jl, ref))}
        line["running_stats"] = {
            "port_f32_vs_f64": max(_gap(st32[k], st64[k]) for k in st64),
            "jax_f32_vs_f64": max(_gap(jst[k], st64[k]) for k in st64)}
        print(json.dumps(line), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="*",
                    help="path under configs/; with --forward, cases of "
                         "FORWARD_CASES (default: all)")
    ap.add_argument("--forward", action="store_true",
                    help="the forward outputs and running statistics of "
                         "the CPU test's cases, the port's and JAX's")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--hw", type=int, default=128)
    args = ap.parse_args(argv)
    if args.forward:
        return forward_precision(args.config)
    if len(args.config) != 1:
        ap.error("give one config (or --forward)")
    args.config = args.config[0]
    root = ROOT
    p = create_config(None, os.path.join(root, "configs", args.config), {})
    names = list(p["TASK_NAMES"])
    model, _ = build_model(p, device="cpu")
    loss_fns = build_loss_fns(p)
    weights = dict(p["loss_kwargs"]["loss_weights"])
    scheme = loss_scheme_of(p, names, loss_fns, weights)
    batch = synthetic_batch(torch.Generator().manual_seed(1), p["ALL_TASKS"],
                            args.batch, (args.hw, args.hw))
    relus, drops = [], []
    orig_mask = dropout_ops._mask

    def record_relu(v):
        relus.append(v > 0)
        return torch.where(relus[-1], v, torch.zeros((), dtype=v.dtype))

    def record_mask(shape, keep, rng, device):
        drops.append(orig_mask(shape, keep, rng, device))
        return drops[-1]

    def step(m, b):
        m.train()
        pred = m(b["image"], noise=torch.Generator().manual_seed(2))[0]
        losses = scheme(pred, b)
        losses["total"].backward()
        return float(losses["total"].detach())

    model64 = copy.deepcopy(model)
    F.relu, dropout_ops._mask = record_relu, record_mask
    loss32 = step(model, batch)
    model64 = widen_to_f64(model64)
    F.relu = lambda v: torch.where(relus.pop(0), v,
                                   torch.zeros((), dtype=v.dtype))
    dropout_ops._mask = lambda shape, keep, rng, device: drops.pop(0)
    loss64 = step(model64, {k: v.double() for k, v in batch.items()})
    g32 = {n: q.grad for n, q in model.named_parameters()}
    groups = {}
    for n, q in model64.named_parameters():
        g = re.match(r"[a-z]+", n).group()
        d, r = groups.get(g, (0.0, 0.0))
        groups[g] = (d + float((g32[n].double() - q.grad).square().sum()),
                     r + float(q.grad.square().sum()))
    print(json.dumps({"config": args.config, "batch": args.batch,
                      "hw": args.hw, "loss_f32": loss32, "loss_f64": loss64,
                      "grad_rel_err_f32_vs_f64": {
                          g: (d / r) ** 0.5 for g, (d, r) in groups.items()}}))


if __name__ == "__main__":
    main()
