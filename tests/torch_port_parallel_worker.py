"""The ranks of tests/test_torch_port_parallel.py: one Gloo world of
WORLD processes on the CPU, spawned once, running every distributed check
of the port and saving what each rank computed to ``<out>/<rank>.pt`` for
the test process to hold against the JAX package and against the port's
own one-process path.  It imports no JAX (the ranks run the port alone).
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from m3vit_tpu_torch import parallel
from m3vit_tpu_torch.models import build_flagship
from m3vit_tpu_torch.moe.dispatch import MoEFfnParams, moe_ffn
from m3vit_tpu_torch.tasks import parse_task_dictionary
from m3vit_tpu_torch.train.optim import build_optimizer
from m3vit_tpu_torch.train.step import make_eval_step, make_train_step
from m3vit_tpu_torch.losses.functions import loss_fn_for_task
from m3vit_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)

WORLD = 4
TASKS = {"include_semseg": True, "include_normals": True}
#: the tiny MoE flagship of the DP x EP step
ARCH = dict(img=32, embed=64, depth=2, heads=2, experts=4, top_k=2,
            dtype=torch.float32, capacity_factor=float("inf"),
            eval_capacity_factor=float("inf"), device="cpu", seed=3)
OPT = {"optimizer": "sgd", "epochs": 2, "scheduler": "poly",
       "optimizer_kwargs": {"lr": 0.01, "momentum": 0.9,
                            "weight_decay": 1e-4}}
WEIGHTS = {"semseg": 1.0, "normals": 10.0}


def tiny_model():
    tasks = parse_task_dictionary("PASCALContext", TASKS)[0]
    model, _ = build_flagship(tasks=tasks, **ARCH)
    return model, [t.name for t in tasks]


def train_step(model, names):
    opt, schedule = build_optimizer(model.parameters(), OPT,
                                    steps_per_epoch=2)
    fns = {n: loss_fn_for_task(n, {}) for n in names}
    return opt, make_train_step(model, names, fns, WEIGHTS, opt, schedule,
                                analysis_metrics=True)


def _rows(a, rank, world=WORLD):
    n = a.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1) * n]))


def _dispatch(spec, layout, rank):
    """The exchange path for each a2a_chunks: this rank's output and its
    gradients in x, the gates and its expert shard (the shard's summed
    over the data group, the ranks holding the same experts)."""
    d = spec["dispatch"]
    out = {}
    E_local = d["w1"].shape[0] // layout.n_expert
    lo = layout.expert_rank * E_local
    for chunks in d["chunks"]:
        x = _rows(d["x"], rank).requires_grad_(True)
        gates = _rows(d["gates"], rank).requires_grad_(True)
        idx = _rows(d["idx"], rank)
        banks = [torch.from_numpy(d[k][lo:lo + E_local].copy())
                 .requires_grad_(True) for k in ("w1", "b1", "w2", "b2")]
        y = moe_ffn(x, idx, gates, MoEFfnParams(*banks),
                    capacity_factor=d["cf"], group=layout.expert_group,
                    num_experts_global=d["w1"].shape[0], a2a_chunks=chunks)
        (y * _rows(d["cot"], rank)).sum().backward()
        bank_grads = [b.grad.clone() for b in banks]
        for g in bank_grads:
            dist.all_reduce(g, group=layout.data_group)
        out[chunks] = {"y": y.detach(), "dx": x.grad, "dgates": gates.grad,
                       "dbanks": bank_grads}
    return out


def _step(spec, layout, rank, ckpt_dir=None):
    """One train step of the tiny model on this rank's shard of the
    global batch, then an eval step; the losses, the one-card state after
    the step and the eval's statistics and predictions."""
    torch.manual_seed(0)
    model, names = tiny_model()
    parallel.shard_experts(model, layout, a2a_chunks=2)
    opt, step = train_step(model, names)
    batch = {k: _rows(v, rank) for k, v in spec["batch"].items()}
    metrics = step(batch, torch.Generator().manual_seed(spec["noise_seed"]))
    sd, osd = parallel.full_state(model, opt, layout)
    pred, stats = make_eval_step(model, names, with_stats=True)(
        {"image": batch["image"]})
    if ckpt_dir is not None:
        save_checkpoint(ckpt_dir, 0, model, opt, step.step, layout=layout)
    return model, opt, {"metrics": metrics, "state": sd, "opt": osd,
                        "eval_stats": stats, "pred": pred}


def run(rank, port, out_dir, spec):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    res = {}
    try:
        ep = parallel.make_layout(2, 2)
        dp = parallel.make_layout(4, 1)
        res["dispatch"] = _dispatch(spec, ep, rank)
        ckpt = os.path.join(out_dir, "ckpt")
        for name, lay in (("dpxep", ep), ("dp", dp)):
            parallel.set_layout(lay)
            _, _, res[name] = _step(spec, lay, rank,
                                    ckpt if name == "dpxep" else None)
        dist.barrier()
        # the (2, 2) checkpoint restored at n_expert 1: every rank holds
        # every expert, the banks and their momentum whole
        parallel.set_layout(dp)
        model, names = tiny_model()
        parallel.shard_experts(model, dp)
        opt, _ = train_step(model, names)
        meta = restore_checkpoint(ckpt, model, opt, layout=dp)
        res["restored"] = {"meta": meta,
                           "state": parallel.full_state(model, opt, dp)}
    finally:
        parallel.set_layout(None)
        torch.save(res, os.path.join(out_dir, f"{rank}.pt"))
        dist.destroy_process_group()
