"""Multi-task (MoE-)ViT trainer CLI (counterpart of
m3vit_tpu/cli/train.py:parse_args and run :46-878; reference
train_fastmoe.py:76-761).

One process trains on one card (``--device``, the card by default; the
CPU only when asked for) through the port's model, its hand-written
kernels, the worker-process loader and ``torch.save`` checkpoints:

  read the config -> dataset readers + transforms -> DataLoader workers,
  pinned batches copied non_blocking one batch ahead -> train step ->
  step / epoch checkpoints -> online evaluation (no-drop guard, meters,
  best model) -> --eval, --eval --save_predictions (files + edge odsF)

Under ``torchrun`` (or with --n_data / --n_expert / --moe_data_distributed)
one process a card trains data- and expert-parallel over
``torch.distributed`` (NCCL; Gloo with --device cpu), as the JAX CLI does
over its ('data', 'expert') mesh: rank r sits at (r // n_expert,
r % n_expert), loads trBatch images of every global batch of trBatch x
world, holds E / n_expert experts of every MoE block and exchanges tokens
with its expert group by all-to-all (--a2a_chunks pieces); everything
else is replicated.  Evaluation runs on every rank (the exchange needs
all of them) over the padded global batches, and checkpoints stay
one-card files, which rank 0 writes.

Resume is exact: the batch order is fixed by (seed, epoch), each sample's
augmentation by (seed, epoch, index), each step's gate noise by a
torch.Generator seeded from (seed, global step) (a rank takes its rows of
the global batch's noise), and a checkpoint holds the weights, the
optimizer's state and the train step's call counter (the lr schedule's
step).  A run stopped by --stop_after_steps or SIGTERM and then
--resume'd ends where the uninterrupted run ends.

A run can start from a DeiT checkpoint (--pretrained: its dense MLPs
upcycled into the MoE blocks' experts, the position embedding resized or,
by default, left at its initial values) or from a reference multi-task
checkpoint, one file or a rank-sharded directory (--ref_ckpt); each
reports the tensors it left at their initial values.  use_checkpointing
(the config key or the flag) rematerialises the backbone's blocks.
--forward_hook writes the layer summaries of one forward to
<output_dir>/forward_hook.log (utils/tracing.py); --flops and --time
report the FLOPs and the latency of a forward on one image and exit;
--profile_dir records a torch.profiler trace of the first train steps.
Flags of features not ported yet raise NotImplementedError naming their
ROADMAP.md item.

Example (a fabricated tree: scripts/fabricate_dataset.py):
  python -m m3vit_tpu_torch.cli.train --config_env env.yml \\
      --config_exp configs/pascal/vit_moe_small_multi_task.yml \\
      --trBatch 8 --epochs 2 --moe_eval_capacity_factor nodrop
  torchrun --nproc_per_node 4 -m m3vit_tpu_torch.cli.train \\
      --config_env env.yml \\
      --config_exp configs/cityscapes/vit_base_moe_ep.yml \\
      --n_data 1 --n_expert 4 --a2a_chunks 2
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from m3vit_tpu_torch import parallel
from m3vit_tpu_torch.config import create_config
from m3vit_tpu_torch.data.loader import EpochLoader, get_dataset, to_device
from m3vit_tpu_torch.data.synthetic import synthetic_batch
from m3vit_tpu_torch.data.transforms import get_transformations
from m3vit_tpu_torch.evaluation.orchestrate import (
    _DropGuard,
    eval_saved_predictions,
    evaluate_online,
    save_model_predictions,
    validate_results,
)
from m3vit_tpu_torch.losses.schemes import build_loss_fns
from m3vit_tpu_torch.models.factory import build_model
from m3vit_tpu_torch.models.vit_moe import VisionTransformerMoE
from m3vit_tpu_torch.moe.dispatch import parse_capacity_factor
from m3vit_tpu_torch.train.optim import build_optimizer
from m3vit_tpu_torch.train.step import (
    make_eval_step,
    make_one_by_one_train_step,
    make_train_step,
)
from m3vit_tpu_torch.utils.checkpoint import (
    latest_index,
    restore_checkpoint,
    save_checkpoint,
)
from m3vit_tpu_torch.utils.device import resolve_device
from m3vit_tpu_torch.utils.logging import MetricLogger, setup_stdout_tee
from m3vit_tpu_torch.utils.tracing import (
    dump_trace,
    flops_of,
    profile_trace,
    trace_model,
)
from m3vit_tpu_torch.utils.torch_interop import (
    deit_to_backbone_params,
    load_into_model,
    load_reference_checkpoint,
    load_torch_state_dict,
    validate_reference_moe_checkpoint,
)

_ITEM7 = ("the token variant, task-conditioned models and research knobs, "
          "ROADMAP.md queue 1 item 7")
_ITEM10 = "sequence parallelism, ROADMAP.md queue 1 item 10"

#: flags of the JAX CLI whose feature the port lacks: (flag, takes a
#: value, why); any use raises NotImplementedError
UNPORTED = (
    ("--n_seq", True, _ITEM10),
    ("--stacked_tasks", False, _ITEM7), ("--scan_tasks", False, _ITEM7),
    ("--scan_blocks", False, _ITEM7), ("--no_scan_tasks_remat", False, _ITEM7),
    ("--task_one_hot", False, _ITEM7),
    ("--gate_task_specific_dim", True, _ITEM7),
    ("--expert_prune", False, _ITEM7),
    ("--regu_experts_fromtask", False, _ITEM7),
    ("--num_experts_pertask", True, _ITEM7), ("--regu_sem", False, _ITEM7),
    ("--sem_force", False, _ITEM7), ("--regu_subimage", False, _ITEM7),
    ("--semregu_loss_weight", True, _ITEM7),
    ("--subimageregu_weight", True, _ITEM7),
    ("--warmup_epochs", True, _ITEM7), ("--gate_input_ahead", False, _ITEM7),
    ("--share_gamma", True, _ITEM7), ("--bootstrap_share_gamma", True, _ITEM7),
    ("--bootstrap_first_moe", True, _ITEM7),
    ("--platform", True, "a JAX option; the port takes --device"),
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser("m3vit_tpu_torch trainer")
    ap.add_argument("--config_env", default=None)
    ap.add_argument("--config_exp", "--config_path", dest="config_exp",
                    required=True)
    ap.add_argument("--run_name", default=None)
    ap.add_argument("--save_dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; the card ('cuda') by default, which "
                         "raises without CUDA ('cpu' runs the plain path)")
    # MoE flags (reference train_fastmoe.py:76-182)
    ap.add_argument("--moe_experts", type=int, default=None)
    ap.add_argument("--moe_top_k", type=int, default=None)
    ap.add_argument("--multi_gate", action="store_true", default=None)
    ap.add_argument("--shared_prefix", action="store_true",
                    help="run the task-independent prefix (patch embed + "
                         "leading dense blocks) once per step instead of "
                         "once per task")
    ap.add_argument("--moe_gate_type", "--moe_gate_arch",
                    dest="moe_gate_type", default=None,
                    help="'noisy_vmoe' (default) or 'noisy' (reference "
                         "--moe_gate_arch)")
    ap.add_argument("--moe_mlp_ratio", type=float, default=None)
    ap.add_argument("--one_by_one", action="store_true",
                    help="per-task forward/backward with the gradients "
                         "added up, one optimizer step per batch (per "
                         "accumulation_steps batches; reference "
                         "train_utils.py:370-421); the joint step's "
                         "gradients at ~1/T of its peak memory")
    ap.add_argument("--use_checkpointing", action="store_true", default=None,
                    help="rematerialise the backbone's blocks in the "
                         "backward (over the YAML's use_checkpointing)")
    # DeiT and reference checkpoints (reference train_fastmoe.py:109-121,
    # :180, :525-556)
    ap.add_argument("--pretrained", default=None,
                    help="DeiT .pth to start the backbone from (dense MLPs "
                         "upcycled into the MoE blocks' experts); a "
                         ".msgpack export is not ported")
    ap.add_argument("--backbone_random_init", action="store_true",
                    help="keep the backbone's initial values even when "
                         "--pretrained is given (reference 'scratch' mode)")
    ap.add_argument("--pos_emb_from_pretrained", action="store_true",
                    help="load (and resize) pos_embed from --pretrained; "
                         "by default it keeps its initial values "
                         "(reference common_config.py:36)")
    ap.add_argument("--use_weight_scaling", action="store_true",
                    help="sqrt(E*G^2/K) scaling of split-upcycled experts")
    ap.add_argument("--use_virtual_group_initialization",
                    action="store_true",
                    help="accepted for the reference CLI's sake: the split "
                         "upcycling engages whenever the expert hidden is "
                         "below the dense MLP hidden")
    ap.add_argument("--ref_ckpt", default=None,
                    help="reference multi-task checkpoint to start from: a "
                         ".pth, or a directory of rank-sharded "
                         "{rank}.pth files")
    # TAM levels (reference train_fastmoe.py:158-163)
    for i in range(3):
        ap.add_argument(f"--tam_level{i}", type=lambda v: v.lower() not in
                        ("0", "false", "no"), default=None)
    ap.add_argument("--weight_decay", type=float, default=None,
                    help="override optimizer_kwargs.weight_decay")
    ap.add_argument("--opt", default=None,
                    help="override the optimizer name (sgd | adam | adamw)")
    ap.add_argument("--vmoe_noisy_std", type=float, default=None)
    ap.add_argument("--moe_noisy_gate_loss_weight", type=float, default=0.01)
    ap.add_argument("--moe_capacity_factor", type=parse_capacity_factor,
                    default=None,
                    help="train dispatch capacity factor (a number, or "
                         "'nodrop' for provably-no-drop capacity)")
    ap.add_argument("--moe_eval_capacity_factor", type=parse_capacity_factor,
                    default=None,
                    help="eval dispatch capacity factor; 'nodrop' guarantees "
                         "the reference's never-drop semantics")
    ap.add_argument("--moe_drop_warn_threshold", type=float, default=0.01,
                    help="warn when the train-step mean dropped-slot "
                         "fraction exceeds this (the reference's ragged "
                         "dispatch never drops)")
    ap.add_argument("--allow_eval_drops", action="store_true",
                    help="do not fail eval when the static capacity drops "
                         "routing slots")
    ap.add_argument("--use_cv_loss", action="store_true", default=None)
    ap.add_argument("--use_pallas_ln_mlp", action="store_true",
                    help="fuse the dense blocks' LN+MLP+residual sublayer "
                         "into one kernel (K5/K6); default off")
    ap.add_argument("--no_pallas_ln_mlp", action="store_true",
                    help="disable the fused LN+MLP+residual kernel (over a "
                         "YAML use_pallas_ln_mlp: true)")
    ap.add_argument("--compute_dtype", default=None,
                    choices=[None, "bfloat16", "float32"])
    # run control
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None,
                    help="override optimizer_kwargs.lr from the config "
                         "(reference train_fastmoe.py:122)")
    ap.add_argument("--trBatch", type=int, default=None)
    ap.add_argument("--accumulation_steps", type=int, default=None)
    ap.add_argument("--valBatch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval", action="store_true", help="eval-only")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckp", default=None,
                    help="explicit checkpoint dir for --eval/--resume "
                         "(defaults to the run's checkpoint dir)")
    ap.add_argument("--ckpt_every_steps", type=int, default=0,
                    help="save a mid-epoch step checkpoint every N train "
                         "steps (0 = epoch granularity only); SIGTERM also "
                         "saves a step checkpoint at the next step "
                         "boundary, then exits")
    ap.add_argument("--stop_after_steps", type=int, default=0,
                    help="save a step checkpoint and exit after N global "
                         "train steps (preemption drill)")
    ap.add_argument("--dev_test", action="store_true",
                    help="run one eval before training")
    ap.add_argument("--save_predictions", action="store_true",
                    help="with --eval: write per-image predictions to "
                         "save_dir and score the files (reference "
                         "save_model_predictions/eval_all_results protocol)")
    ap.add_argument("--overfit", action="store_true")
    ap.add_argument("--synthetic", type=int, default=0, metavar="NBATCH",
                    help="train on N synthetic batches/epoch, made on the "
                         "device (no dataset needed)")
    ap.add_argument("--wandb", "--use_wandb", dest="wandb",
                    action="store_true",
                    help="also log to wandb (raises when it is absent)")
    ap.add_argument("--wandb_project", default=None)
    ap.add_argument("--wandb_entity", default=None)
    ap.add_argument("--wandb_name", default=None,
                    help="wandb run name (defaults to --run_name)")
    ap.add_argument("--log_interval", type=int, default=25)
    ap.add_argument("--run_summary", default=None, metavar="FILE",
                    help="write a JSON record of the run there (rank 0): "
                         "steps, logged losses, step times, results, the "
                         "kernels' launches and the peak device memory")
    # data and expert parallelism (reference train_fastmoe.py:268-312)
    ap.add_argument("--n_data", type=int, default=None,
                    help="data-parallel rows of the (data, expert) mesh "
                         "(default 1; the world under "
                         "--moe_data_distributed)")
    ap.add_argument("--n_expert", type=int, default=None,
                    help="expert-parallel ranks a row (default world / "
                         "n_data); each holds E / n_expert experts")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group torchrun describes "
                         "across hosts (its environment is required)")
    ap.add_argument("--moe_data_distributed", action="store_true",
                    help="replicate the experts on every rank instead of "
                         "sharding them (forces --n_expert 1)")
    ap.add_argument("--a2a_chunks", type=int, default=None,
                    help="split each MoE block's token exchange over N "
                         "groups of local experts, so a chunk's all-to-all "
                         "runs beside the previous chunk's expert FFN")
    # tracing (reference utils/tracing.py, main.py:97-108)
    ap.add_argument("--forward_hook", action="store_true",
                    help="dump every layer's output summary for the first "
                         "batch to <output_dir>/forward_hook.log")
    ap.add_argument("--flops", action="store_true",
                    help="print the FLOPs of a forward on one image and "
                         "exit")
    ap.add_argument("--time", dest="time_fwd", action="store_true",
                    help="print the latency of a forward on one image and "
                         "exit")
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace of the first epoch's "
                         "first three train steps there")
    for flag, value, why in UNPORTED:
        ap.add_argument(flag, default=None, help=f"not ported: {why}",
                        **({} if value else {"action": "store_const",
                                             "const": True}))
    return ap.parse_args(argv)


def _refuse_unported(args) -> None:
    for flag, _, why in UNPORTED:
        if getattr(args, flag[2:]) is not None:
            raise NotImplementedError(
                f"{flag} is not ported to m3vit_tpu_torch ({why})")


class SyntheticLoader:
    """A fixed set of synthetic batches made on the device (smoke mode):
    rank `rank`'s slice of each of `world` x batch_size images."""

    def __init__(self, tasks, n_batches: int, batch_size: int, img_size,
                 device, rank: int = 0, world: int = 1):
        self.batches = []
        n = batch_size * world
        for i in range(n_batches):
            gen = torch.Generator(device=device).manual_seed(i)
            b = synthetic_batch(gen, tasks, n, tuple(img_size))
            b["meta"] = [{"image": f"synth_{i}_{j}",
                          "im_size": tuple(img_size)} for j in range(n)]
            lo = rank * batch_size
            self.batches.append({k: v[lo:lo + batch_size]
                                 for k, v in b.items()})

    def __len__(self):
        return len(self.batches)

    def epoch(self, epoch: int, start: int = 0):
        return iter(self.batches[start:])


def step_seed(seed: int, global_step: int) -> int:
    """The gate-noise seed of train step `global_step` of a run."""
    return int(np.random.SeedSequence([seed, global_step])
               .generate_state(1, np.uint64)[0])


class _NullLogger:
    """MetricLogger's interface, logging nothing (ranks other than 0)."""

    def __getattr__(self, name):
        return lambda *a, **k: None


def _parallel_layout(args):
    """(this rank's layout, whether the run joined the process group
    itself) for a parallel run (under torchrun, or when a mesh flag is
    given); (None, False) for a one-process run."""
    under_torchrun = "WORLD_SIZE" in os.environ
    if not (under_torchrun or args.multihost or args.moe_data_distributed
            or args.n_data is not None or args.n_expert is not None):
        return None, False
    if args.multihost and not under_torchrun:
        raise RuntimeError("--multihost joins the process group torchrun "
                           "describes: launch with torchrun")
    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.moe_data_distributed:
        # reference --moe_data_distributed: experts replicated
        # (m3vit_tpu/cli/train.py:449-450)
        n_expert, n_data = 1, args.n_data or world
    else:
        n_data = args.n_data or 1
        n_expert = args.n_expert if args.n_expert is not None else max(
            world // n_data, 1)
    joined = not dist.is_initialized()
    return parallel.init_distributed(n_data, n_expert, args.device), joined


def sharded_eval_step(eval_step, layout: parallel.Layout, global_batch: int):
    """eval_step over this rank's rows of a global batch: the batch's
    images padded to `global_batch` rows by repeating the last
    (m3vit_tpu/data/loader.py:439), the rank's slice run (every rank, as
    the exchange needs them all), the predictions gathered from every
    rank and cut back to the batch's own rows, the MoE statistics the
    global batch's."""
    per = global_batch // layout.world

    def step(batch):
        img = batch["image"]
        n = img.shape[0]
        if n < global_batch:
            img = torch.cat([img, img[-1:].expand(global_batch - n,
                                                  *img.shape[1:])])
        pred, stats = eval_step({"image": img[layout.rank * per:
                                              (layout.rank + 1) * per]})
        full = {}
        for task, v in pred.items():
            parts = [torch.empty_like(v) for _ in range(layout.world)]
            dist.all_gather(parts, v.contiguous())
            full[task] = torch.cat(parts)[:n]
        return full, stats

    return step


def _plain(d):
    if isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_plain(v) for v in d]
    try:
        return float(d)
    except Exception:
        return d


def _config(args):
    overrides = {
        k: getattr(args, k)
        for k in ("moe_experts", "moe_top_k", "vmoe_noisy_std",
                  "moe_capacity_factor", "moe_eval_capacity_factor",
                  "epochs", "trBatch", "valBatch", "compute_dtype",
                  "save_dir", "run_name", "accumulation_steps",
                  "moe_gate_type", "moe_mlp_ratio")
        if getattr(args, k) is not None
    }
    if args.allow_eval_drops:
        overrides["allow_eval_drops"] = True
    # three-state flags: the YAML value wins unless the flag is given
    for k in ("multi_gate", "use_cv_loss", "use_checkpointing"):
        if getattr(args, k) is not None:
            overrides[k] = getattr(args, k)
    if args.use_pallas_ln_mlp and args.no_pallas_ln_mlp:
        raise SystemExit(
            "--use_pallas_ln_mlp and --no_pallas_ln_mlp are "
            "contradictory; pass at most one")
    if args.use_pallas_ln_mlp:
        overrides["use_pallas_ln_mlp"] = True
    if args.no_pallas_ln_mlp:
        overrides["use_pallas_ln_mlp"] = False
    if args.shared_prefix:
        overrides["shared_prefix"] = True
    if args.overfit:
        overrides["overfit"] = True
    p = create_config(args.config_env, args.config_exp, overrides,
                      make_dirs=True)
    if p.get("shared_prefix") and not (
            p.get("multi_gate")
            and p.get("backbone") == "VisionTransformer_moe"):
        print("WARNING: shared_prefix needs per-task routing (multi_gate) "
              "on the VisionTransformer_moe backbone; ignored")
        p["shared_prefix"] = False
    if args.lr is not None:
        p["optimizer_kwargs"]["lr"] = args.lr
    if args.weight_decay is not None:
        p["optimizer_kwargs"]["weight_decay"] = args.weight_decay
    if args.opt is not None:
        p["optimizer"] = args.opt
    levels = {f"tam_level{i}": getattr(args, f"tam_level{i}")
              for i in range(3) if getattr(args, f"tam_level{i}") is not None}
    if levels:
        p["model_kwargs"] = {**(p.get("model_kwargs") or {}), **levels}
    return p


def _report(what: str, missing) -> None:
    if missing:
        print(f"[{what}] kept initial values for {len(missing)} tensors "
              f"(e.g. {missing[:4]})")


def load_pretrained_backbone(model: torch.nn.Module, path: str, p: Dict,
                             pos_emb_from_pretrained: bool = False,
                             use_weight_scaling: bool = False):
    """Load a DeiT ``.pth`` into the model's backbone, in place
    (m3vit_tpu/cli/train.py:880-935): the position embedding resized to the
    patch grid (dropped unless pos_emb_from_pretrained), and on the MoE
    backbone the odd blocks' dense MLPs upcycled into expert banks of the
    model's expert hidden size.  Returns the backbone parameters it left at
    their initial values (the gates among them)."""
    if path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: the JAX package's own backbone export is not ported "
            "to m3vit_tpu_torch (pretraining, ROADMAP.md queue 1 item 9)")
    kw = p.get("backbone_kwargs") or {}
    bb = model.backbone
    patch = int(kw.get("patch_size", 16))
    img = kw.get("img_size", [512, 512])
    img = (img, img) if isinstance(img, int) else img
    moe = isinstance(bb, VisionTransformerMoE)
    loaded = deit_to_backbone_params(
        load_torch_state_dict(path), depth=len(bb.blocks),
        num_experts=bb.blocks[1].mlp.num_experts if moe else None,
        expert_hidden=(bb.blocks[1].mlp.experts.htoh4.weight.shape[1]
                       if moe else None),
        top_k=bb.blocks[1].mlp.top_k if moe else 4,
        target_grid=(int(img[0]) // patch, int(img[1]) // patch),
        use_weight_scaling=use_weight_scaling)
    if not pos_emb_from_pretrained:
        loaded.pop("pos_embed", None)
    missing = load_into_model(model, loaded, prefix="backbone.")
    _report("pretrained", missing)
    return missing


def import_reference_checkpoint(model: torch.nn.Module, path: str, p: Dict):
    """Load a reference multi-task checkpoint (a ``.pth`` or a rank-sharded
    directory) into the model, in place, after refusing rank-local expert
    banks (m3vit_tpu/cli/train.py:544-575).  Returns (the checkpoint, the
    parameters it left at their initial values)."""
    ckpt, sd = load_reference_checkpoint(path)
    validate_reference_moe_checkpoint(ckpt, sd, int(p.get("moe_experts", 16)),
                                      path)
    missing = load_into_model(model, sd)
    epoch = ckpt.get("epoch") if isinstance(ckpt, dict) else None
    print(f"imported reference checkpoint {path} (epoch={epoch}, "
          f"missing={len(missing)})")
    _report("ref_ckpt", missing)
    return ckpt, missing


def run(args) -> Dict:
    """Trains or evaluates as `args` say.  Returns {"stopped_at_step": n}
    after --stop_after_steps or SIGTERM, the eval results with --eval,
    else {"best": the best results}; each with "steps_run" (train steps
    this call ran), "step_times" ([(global step, perf_counter when the
    step's call returned)], no device sync) and "state" ({"model",
    "optimizer", "train_step"}, as the run left them); with --pretrained
    or --ref_ckpt also "pretrained_missing" / "ref_ckpt_missing", the
    parameters the checkpoint left at their initial values."""
    _refuse_unported(args)
    layout, joined = _parallel_layout(args)
    device = resolve_device(args.device) if layout is None else layout.device
    try:
        p = _config(args)
    except BaseException:
        _leave_group(layout, joined)
        raise
    restore_streams = setup_stdout_tee(p["output_dir"]) if rank0(layout) \
        else (lambda: None)
    logger = None
    loaders = []
    prev_sigterm = None
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        # preemption notice: finish the in-flight step, checkpoint, exit
        preempted["flag"] = True

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not in the main thread (library embedding)
    try:
        logger = MetricLogger(p["output_dir"], use_wandb=args.wandb,
                              config=p,
                              run_name=args.wandb_name or args.run_name,
                              project=args.wandb_project,
                              entity=args.wandb_entity) if rank0(layout) \
            else _NullLogger()
        return _run(args, p, device, logger, loaders, preempted, layout)
    finally:
        _leave_group(layout, joined)
        for ld in loaders:
            ld.close()
        if logger is not None:
            logger.close()
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        restore_streams()


def _leave_group(layout, joined: bool) -> None:
    """Clears the run's layout, and leaves the process group if the run
    joined it."""
    if layout is not None:
        parallel.set_layout(None)
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, p, device, logger, loaders, preempted, layout=None) -> Dict:
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    world = 1 if layout is None else layout.world
    rank = 0 if layout is None else layout.rank
    print(f"device: {device} ({name})")
    if layout is not None:
        print(f"parallel: rank {rank} of {world}, mesh (n_data "
              f"{layout.n_data}, n_expert {layout.n_expert}) position "
              f"{parallel.mesh_position(rank, layout.n_expert)}, backend "
              f"{dist.get_backend()}, a2a_chunks {args.a2a_chunks or 1}")
    print(f"tasks: {p['TASK_NAMES']}")
    model, _ = build_model(p, device=device, seed=args.seed)
    tasks = list(p["TASK_NAMES"])
    loss_fns = build_loss_fns(p)
    loss_weights = dict(
        (p.get("loss_kwargs") or {}).get("loss_weights", {t: 1.0 for t in tasks})
    )

    batch_size = int(p.get("trBatch", 2))
    val_batch = int(p.get("valBatch", p.get("trBatch", 2)))
    # per-rank batches: the global batch is batch_size x world
    # (m3vit_tpu/cli/train.py:466-468); the val loader yields whole global
    # batches on every rank, which sharded_eval_step pads and slices
    if args.synthetic:
        train_loader = SyntheticLoader(p["TASKS"], args.synthetic, batch_size,
                                       p["train_scale"], device, rank, world)
        val_loader = SyntheticLoader(p["TASKS"], max(args.synthetic // 2, 1),
                                     val_batch * world, p["test_scale"],
                                     device)
    else:
        tr, ts = get_transformations(p)
        nworkers = int(p.get("nworkers", 8))
        pin = device.type == "cuda"
        train_loader = EpochLoader(
            get_dataset(p, "train", None, overfit=p["overfit"]), tr,
            batch_size=batch_size, shuffle=True, seed=args.seed,
            num_workers=nworkers, pin_memory=pin, rank=rank, world=world)
        loaders.append(train_loader)
        val_loader = EpochLoader(
            get_dataset(p, "val", None, overfit=p["overfit"]), ts,
            batch_size=val_batch * world, shuffle=False, drop_last=False,
            seed=args.seed, num_workers=nworkers, pin_memory=pin)
        loaders.append(val_loader)

    steps_per_epoch = max(len(train_loader), 1)
    epochs = int(p["epochs"])
    accum = max(int(p.get("accumulation_steps", 1)), 1)
    n_params = sum(x.numel() for x in model.parameters())
    print(f"parameters: {n_params/1e6:.2f}M, steps/epoch: {steps_per_epoch}")

    out: Dict = {"steps_run": 0, "step_times": [],
                 "state": {"model": model, "layout": layout}}
    if args.pretrained and args.backbone_random_init:
        # reference 'scratch' mode (train_fastmoe.py:192-197)
        print(f"backbone_random_init: ignoring {args.pretrained}")
    elif args.pretrained:
        out["pretrained_missing"] = load_pretrained_backbone(
            model, args.pretrained, p,
            pos_emb_from_pretrained=args.pos_emb_from_pretrained,
            use_weight_scaling=args.use_weight_scaling)
        print(f"loaded pretrained backbone from {args.pretrained}")
    if args.ref_ckpt:
        out["ref_ckpt_missing"] = import_reference_checkpoint(
            model, args.ref_ckpt, p)[1]
    if layout is not None:
        # the whole banks loaded, keep this rank's experts
        parallel.shard_experts(model, layout, args.a2a_chunks or 1)
    optimizer, lr_schedule = build_optimizer(model.parameters(), p,
                                             steps_per_epoch)
    out["state"]["optimizer"] = optimizer

    cv_w = float(args.moe_noisy_gate_loss_weight) if p.get("use_cv_loss") \
        else 0.0
    if args.one_by_one:
        train_step = make_one_by_one_train_step(
            model, tasks, loss_fns, loss_weights, optimizer, lr_schedule,
            cv_weight=cv_w, accumulation_steps=accum)
    else:
        train_step = make_train_step(
            model, tasks, loss_fns, loss_weights, optimizer, lr_schedule,
            cv_weight=cv_w, analysis_metrics=True, accumulation_steps=accum)
    # stats-carrying eval step: evaluate_online enforces the reference's
    # no-drop semantics on dropped_slot_fraction (see _DropGuard)
    eval_step = make_eval_step(model, tasks, with_stats=True)
    if layout is not None:
        eval_step = sharded_eval_step(eval_step, layout, val_batch * world)

    start_epoch = 0
    skip_iters = 0
    step_ckpt_dir = os.path.join(p["output_dir"], "step_checkpoint")
    if args.resume or args.eval:
        ckpt_dir = args.ckp or p["checkpoint_dir"]
        meta = restore_checkpoint(ckpt_dir, model, optimizer,
                                  layout=layout)
        if meta is not None:
            train_step.step = meta["train_step_calls"]
            start_epoch = int(meta.get("epoch", -1)) + 1
            print(f"resumed from epoch {start_epoch - 1}")
        elif args.eval and not (args.ref_ckpt or args.pretrained):
            raise FileNotFoundError(f"--eval needs a checkpoint in {ckpt_dir} "
                                    "(or --ref_ckpt / --pretrained)")
    if args.resume and not args.eval and args.ckp is None:
        # step-granularity resume: the run's own mid-epoch checkpoint wins
        # when it is newer than the last epoch checkpoint (an explicit --ckp
        # always wins).  skip_iters == steps_per_epoch means the epoch's
        # steps all ran but its end-of-epoch eval/checkpoint did not:
        # re-enter that epoch with zero iterations so they still do.
        idx = latest_index(step_ckpt_dir)
        if idx is not None:
            with open(os.path.join(step_ckpt_dir, f"meta_{idx}.json")) as f:
                s_meta = json.load(f)
            s_epoch, s_next = int(s_meta["epoch"]), int(s_meta["next_it"])
            if s_epoch * steps_per_epoch + s_next > \
                    start_epoch * steps_per_epoch:
                meta = restore_checkpoint(step_ckpt_dir, model, optimizer,
                                          index=idx, layout=layout)
                train_step.step = meta["train_step_calls"]
                start_epoch, skip_iters = s_epoch, s_next
                print(f"resumed mid-epoch: epoch {s_epoch} iter {s_next}")

    out["state"]["train_step"] = train_step

    def run_eval(epoch: int) -> Dict:
        batches = to_device(val_loader.epoch(epoch), device, keys=("image",))
        results = evaluate_online(p, eval_step, batches, epoch)
        logger.log_val_performance(results, epoch)
        print(f"[epoch {epoch}] val: "
              + ", ".join(f"{t}={results[t]}" for t in tasks))
        if "multi_task_performance" in results:
            print(f"[epoch {epoch}] Δm = "
                  f"{100 * results['multi_task_performance']:.2f}%")
        return results

    if _tracing(args, p, model, tasks, train_loader, device, layout, out):
        return out

    if args.eval:
        if args.save_predictions:
            batches = to_device(val_loader.epoch(start_epoch), device,
                                keys=("image",))
            if not rank0(layout):
                # the exchange needs every rank; rank 0 writes the files
                guard = _DropGuard(p)
                for b in batches:
                    guard.update(eval_step({"image": b["image"]})[1])
                guard.check()
                return out
            save_dir = save_model_predictions(p, eval_step, batches)
            print(f"predictions written to {save_dir}")
            if args.synthetic:
                return out
            ds = get_dataset(p, "val", None, overfit=p["overfit"])
            results = eval_saved_predictions(p, save_dir, ds)
            logger.log_val_performance(results, start_epoch)
            print("file-protocol results:", _plain(results))
            return {**results, **out}
        return {**run_eval(start_epoch), **out}
    if args.dev_test:
        run_eval(start_epoch)

    eval_interval = int(p.get("eval_interval", 1))
    final10 = bool(p.get("eval_final_10_epochs_only", False))
    best: Optional[Dict] = None
    opt_steps_per_epoch = max(steps_per_epoch // accum, 1)
    metrics: Dict = {}

    for epoch in range(start_epoch, epochs):
        t_epoch = time.time()
        # reference per-epoch logging surface: epoch counter, adjusted lr
        # (wandb_logger.py:302-323) + device/host memory
        logger.log_epoch(epoch)
        logger.log_learning_rate(lr_schedule(epoch * opt_steps_per_epoch),
                                 epoch * steps_per_epoch)
        logger.log_memory(epoch * steps_per_epoch)
        it0 = skip_iters if epoch == start_epoch else 0
        # a mid-epoch resume starts the sampler at it0: the batches before
        # it are never read
        batches = to_device(train_loader.epoch(epoch, start=it0), device)
        t_win = time.time()
        profiling = None
        if args.profile_dir and epoch == start_epoch:
            profiling = profile_trace(
                args.profile_dir if rank0(layout) else
                os.path.join(args.profile_dir, f"rank{rank}"))
            out["profile"] = profiling.__enter__()
        for it, batch in enumerate(batches, start=it0):
            batch.pop("meta", None)
            # this step's gate noise, from (seed, the step's index)
            noise = torch.Generator(device=device).manual_seed(
                step_seed(args.seed, epoch * steps_per_epoch + it))
            metrics = train_step(batch, noise)
            if profiling is not None and it == it0 + 2:
                # the first three steps (m3vit_tpu/cli/train.py:797-799)
                profiling.__exit__(None, None, None)
                profiling = None
            global_step = epoch * steps_per_epoch + it + 1   # steps done
            out["steps_run"] += 1
            out["step_times"].append((global_step, time.perf_counter()))
            if (it + 1) % args.log_interval == 0:
                loss = float(metrics["loss_total"])  # sync point
                out.setdefault("losses", []).append((global_step, loss))
                dt = time.time() - t_win
                ips = args.log_interval * batch_size * world / dt
                t_win = time.time()
                logger.log_train_losses(
                    {k: (v.tolist() if v.ndim else float(v))
                     for k, v in metrics.items()}
                    | {"throughput_images_per_sec": ips}, epoch,
                    global_step - 1)
                print(f"[epoch {epoch} it {it+1}/{steps_per_epoch}] "
                      f"loss={loss:.4f} ips={ips:.1f}")
                drop = float(metrics.get("moe_dropped_frac", 0.0))
                if drop > args.moe_drop_warn_threshold:
                    print(f"WARNING: mean MoE dropped-slot fraction "
                          f"{drop:.3f} > {args.moe_drop_warn_threshold} — "
                          f"raise moe_capacity_factor (or use 'nodrop'); "
                          f"the reference's ragged dispatch never drops")
            stop_now = preempted["flag"] or (
                args.stop_after_steps and global_step >= args.stop_after_steps)
            periodic = (args.ckpt_every_steps
                        and (it + 1) % args.ckpt_every_steps == 0
                        and it + 1 < steps_per_epoch)
            if periodic or stop_now:
                save_checkpoint(step_ckpt_dir, global_step, model,
                                optimizer, train_step.step,
                                {"epoch": epoch, "next_it": it + 1,
                                 "mid_epoch": True}, layout=layout)
            if stop_now:
                why = "SIGTERM" if preempted["flag"] else "--stop_after_steps"
                print(f"[{why}] step checkpoint saved at epoch {epoch} "
                      f"iter {it + 1} -> {step_ckpt_dir}; exiting")
                return {"stopped_at_step": global_step, **out}
        if profiling is not None:
            profiling.__exit__(None, None, None)
        # epoch end: final loss sync (a fully-trained resumed epoch —
        # skip_iters == steps_per_epoch — runs zero iterations here and goes
        # straight to its pending eval/checkpoint)
        if it0 < steps_per_epoch:
            loss = float(metrics["loss_total"])
            print(f"[epoch {epoch}] done in {time.time()-t_epoch:.1f}s "
                  f"loss={loss:.4f}")

        # reference policy (train_fastmoe.py:643-657): eval every
        # eval_interval epochs; with eval_final_10_epochs_only, only within
        # the last 10 epochs (the final epoch always evaluates)
        do_eval = ((epoch + 1) % eval_interval == 0) or epoch == epochs - 1
        if final10 and epoch < epochs - 10 and epoch != epochs - 1:
            do_eval = False
        if do_eval:
            results = run_eval(epoch)
            best, improved = validate_results(p, results, best)
            if improved:
                save_checkpoint(p["best_model_dir"], epoch, model, optimizer,
                                train_step.step,
                                {"results": _plain(results)}, layout=layout)
                logger.log_best(results, epoch)
        save_checkpoint(p["checkpoint_dir"], epoch, model, optimizer,
                        train_step.step, layout=layout)

    return {"best": best, **out}


def rank0(layout) -> bool:
    return layout is None or layout.rank == 0


def _tracing(args, p, model, tasks, train_loader, device, layout,
             res: Dict) -> bool:
    """--forward_hook (then training goes on), --flops and --time (a
    forward on one image; the run ends), as the JAX CLI wires them
    (m3vit_tpu/cli/train.py:615-626, :691-720), their results put in
    `res`.  Returns whether the run ends."""
    if not (args.forward_hook or args.flops or args.time_fwd):
        return False
    sample = next(iter(to_device(train_loader.epoch(0), device)))
    model.eval()
    if args.forward_hook:
        traces = trace_model(model, sample["image"])
        res["forward_hook"] = os.path.join(p["output_dir"], "forward_hook.log")
        if rank0(layout):
            dump_trace(traces, res["forward_hook"])
        print(f"[forward_hook] {len(traces)} layer summaries -> "
              f"{res['forward_hook']}")
    if not (args.flops or args.time_fwd):
        return False
    img = sample["image"][:1]

    def fwd():
        with torch.no_grad():
            return model(img)[0][tasks[0]]

    if args.flops:
        res["flops"] = flops_of(fwd)
        print(f"forward FLOPs (batch=1): {res['flops'] / 1e9:.2f} G")
    if args.time_fwd:
        fwd()
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(5):
                fwd()
            end.record()
            end.synchronize()
            res["forward_ms"] = start.elapsed_time(end) / 5
        else:
            t0 = time.perf_counter()
            for _ in range(5):
                fwd()
            res["forward_ms"] = (time.perf_counter() - t0) / 5 * 1e3
        print(f"forward latency: {res['forward_ms']:.1f} ms")
    return True


def write_run_summary(path: str, result: Dict, device) -> None:
    """The run's record as JSON: everything `run` returned but the live
    state, the kernels' launches in this process and its peak device
    memory."""
    from m3vit_tpu_torch.ops import _build

    rec = {k: _plain(v) for k, v in result.items()
           if k not in ("state", "profile")}
    rec["launches"] = {k: v for k, v in _build.launches.items() if v}
    if device.type == "cuda":
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    result = run(args)
    layout = (result.get("state") or {}).get("layout")
    if args.run_summary and rank0(layout):
        model = result["state"]["model"]
        write_run_summary(args.run_summary, result,
                          next(model.parameters()).device)
    return result


if __name__ == "__main__":
    main()
