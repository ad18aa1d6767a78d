#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (m3vit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from m3vit_tpu_torch/csrc (K1/K2 flash
attention forward/backward, K3/K4 fused FFN forward/backward, K5/K6 fused
LayerNorm + MLP + residual forward/backward, K7 int8-weight FFN forward),
holds each against its plain PyTorch version at the flagship's shapes and
times them (each also runs twice and must give the same bits, and builds
with 0 bytes spilled; K4/K6/K7 report each pass's device time and the
memory one call holds, and K7 must give K3's bits on the dequantized
banks).  Then it
drives the flagship model (ViT-small-MoE, 512x512, 5 PASCAL tasks, seeded
random weights) along each of its paths, the kernels' launch counts set to
0 just before each path and read just after:
- serving: InferenceSession at buckets 1/2/4/8 plus one 5-task eval;
- training (B=8 synthetic batches, shared prefix, train capacity factor
  1.25, SGD): one step with kernels against one with the plain path on the
  same weights, batch and gate noise (the plain path also replaying the
  kernel path's routing, whole and for the backbone alone under a fixed
  cotangent), then steps that must lower the loss, timed, with the
  kernels' launches counted per step;
- int8 serving: the flagship's expert banks quantized by the port's own
  quantizer and served at buckets 1/2/4/8 (peak memory, and the device
  time of a bucket-8 request), held against its plain path;
- ln_mlp: the flagship with the fused dense sublayer, served at bucket 8
  with one 5-task eval and trained, each held against the unfused model on
  the same weights, with timed steps;
- one-by-one, accumulation, the learned-noise gate, the no-drop eval and
  the dense ViT-small, each held against its plain path;
- cli: the trainer CLI (m3vit_tpu_torch.cli.train) on a PASCAL-Context
  tree fabricated by scripts/fabricate_dataset.py, with the headline
  config: the worker loader against in-process loading, then a run
  stopped after 11 steps, its --resume (the rest, one evaluation, the
  best-model and epoch checkpoints), --eval and --eval
  --save_predictions, launches counted over each run; a checkpoint loaded
  into a fresh model and optimizer; the CLI's step time beside a
  synthetic-batch step;
- recipe: the paper's training recipe on the cli phase's tree: the
  headline config from a DeiT-small-format checkpoint written here
  (--pretrained, experts upcycled from the dense MLPs, checked bit for
  bit; peak memory and step time with and without rematerialisation),
  its model through rank-sharded reference files and --ref_ckpt --eval
  bit for bit, the dense ViT-small with TAM (--pos_emb_from_pretrained;
  rematerialised against not), and the NYUD dropout/drop-path config at
  480 x 640, whose training leaves the FFN kernels as the JAX package
  does;
- wide: the ViT-base, ViT-large and ViT-tiny families (K3-K7 at d 768,
  1024 and 192) through the CLI, served and trained;
- parallel: the expert-parallel exchange (moe/dispatch.py) over a
  one-rank NCCL group against the local FFN for a2a_chunks 1, 2 and 3,
  then the EP config (configs/cityscapes/vit_base_moe_ep.yml, ViT-base at
  full width) through the CLI under torch.distributed.run with --n_data 1
  --n_expert 1 --a2a_chunks 2: steps, --resume, --eval, one-by-one with
  accumulation and the tracing flags, against a run without a process
  group.
Each phase prints one JSON line; the line before the last is nvidia-smi's
card name and power limit, and the last line is {"ok": true, "device":
{...}}.  Any failed check exits non-zero before that line; without CUDA the
script exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from m3vit_tpu_torch import native  # noqa: E402
from m3vit_tpu_torch.cli.train import main as cli_main  # noqa: E402
from m3vit_tpu_torch.config import create_config  # noqa: E402
from m3vit_tpu_torch.data.loader import EpochLoader, get_dataset  # noqa: E402
from m3vit_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from m3vit_tpu_torch.data.transforms import get_transformations  # noqa: E402
from m3vit_tpu_torch.evaluation.orchestrate import _DropGuard  # noqa: E402
from m3vit_tpu_torch.losses.functions import loss_fn_for_task  # noqa: E402
from m3vit_tpu_torch.losses.schemes import (  # noqa: E402
    build_loss_fns,
    multi_task_loss,
)
from m3vit_tpu_torch.models import (  # noqa: E402
    VisionTransformer,
    build_flagship,
    build_model,
    set_use_kernels,
)
from m3vit_tpu_torch.models import vit_moe  # noqa: E402
from m3vit_tpu_torch.moe.dispatch import (  # noqa: E402
    compute_capacity,
    parse_capacity_factor,
)
from m3vit_tpu_torch.moe.gating import (  # noqa: E402
    noisy_gate,
    noisy_vmoe_gate,
    small_topk,
)
from m3vit_tpu_torch.ops import _build  # noqa: E402
from m3vit_tpu_torch.ops.expert_ffn import (  # noqa: E402
    BWD_KSTEP,
    _scratch_bytes,
    bwd_plan,
    dequantize_weight,
    expert_ffn_bwd,
    expert_ffn_bwd_plain,
    expert_ffn_fwd,
    expert_ffn_q_dequant,
    expert_ffn_q_fwd,
    ffn_route,
    fused_expert_ffn_plain,
    quantized_expert_ffn_plain,
)
from m3vit_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_lse_plain,
    flash_attention_qkv_bwd_plain,
    flash_attention_qkv_plain,
)
from m3vit_tpu_torch.ops.ln_mlp import (  # noqa: E402
    ln_mlp_bwd,
    ln_mlp_fwd,
    ln_mlp_residual_bwd_plain,
    ln_mlp_residual_plain,
)
from m3vit_tpu_torch.serve import InferenceSession  # noqa: E402
from m3vit_tpu_torch.serve.quantize import (  # noqa: E402
    quantize_expert_state_dict,
    quantize_weight,
)
from m3vit_tpu_torch.train.optim import build_optimizer  # noqa: E402
from m3vit_tpu_torch.train.step import (  # noqa: E402
    make_eval_step,
    make_one_by_one_train_step,
    make_train_step,
)
from m3vit_tpu_torch.utils.checkpoint import restore_checkpoint  # noqa: E402

BUCKETS = (1, 2, 4, 8)
IMG = 512
ATTN_TOL = 2e-2          # JAX package's bf16 tolerance (test_flash_attention.py:53)
LSE_TOL = 1e-3           # K1's lse: f32 sums of the same bf16 products, lse ~ 7-10
FFN_ABS_TOL, FFN_REL_TOL = 2e-2, 1e-2
AGREE_MIN, LOGIT_REL_TOL = 0.99, 2e-2
# the dense ViT and the trained learned-noise-gate flagship serve class maps
# whose bf16 rounding alone moves more than 1 - AGREE_MIN of the pixels on
# seeded random weights (the dense ViT at bucket 8: plain bf16 vs plain f32
# agree on 98.54%, kernel vs plain f32 on 98.54%; on an H100).  There the
# kernel path's agreement with the plain f32 path must be the plain bf16
# path's, within F32_AGREE_SLACK, beside the logit limit
F32_AGREE_SLACK = 2e-3
# backward kernels vs their plain versions (bf16 outputs; p, dS and da are
# rounded to bf16 from f32 values summed in another order): relative
# Frobenius error, and max abs error as a fraction of the largest |ref|
GRAD_REL_TOL, GRAD_ABS_FRAC = 1e-2, 2e-2
# kernel vs plain train step on the same weights, batch and noise: the
# losses agree to TRAIN_LOSS_REL_TOL relative.  The backbone alone, under a
# fixed random cotangent on its output tokens and with the plain path
# replaying the kernel path's routing (RoutingTape), gives each parameter
# group's gradient to BACKBONE_GRAD_REL_TOL (||g_kernel - g_plain|| /
# ||g_plain||)
# (limits about 10x and 2x the readings on an H100: 8.9e-6 in two runs, and
# at most 0.0094 per group)
TRAIN_LOSS_REL_TOL, BACKBONE_GRAD_REL_TOL = 1e-4, 2e-2
TRAIN_BATCH, TRAIN_STEPS, TIMED_STEPS = 8, 10, 10
# gradient accumulation: the kernel path's gradient after its two
# micro-batches against the mean of the two micro-batches' gradients taken
# one by one on the same path, per parameter group, to
# BACKBONE_GRAD_REL_TOL.  Two such whole-step gradients of one path differ
# by ~1% (the heads' bilinear-upsampling backward adds with atomics in
# bf16, and train-mode BatchNorm's backward carries that into the
# backbone: 1.1-1.2% on an H100), which the run measures and reports; a
# lost micro-batch or a missing 1/k is off by 50% or more
ADAM_STEPS, ADAM_LR = 5, 5e-5   # optimizer steps (two micro-batches each)
DENSE_REQUESTS = 50      # timed bucket-8 requests of the dense ViT
LN_MLP_REQUESTS = 100    # timed bucket-8 requests of the ln_mlp serving path
LOSS_WEIGHTS = {"semseg": 1.0, "human_parts": 2.0, "sal": 5.0, "edge": 50.0,
                "normals": 10.0}
# bench.py:316-322: SGD, lr 0.002, momentum 0.9, wd 1e-4, poly over 100
# epochs of 100 steps
OPTIM = {"optimizer": "sgd", "scheduler": "poly", "epochs": 100,
         "optimizer_kwargs": {"lr": 0.002, "momentum": 0.9,
                              "weight_decay": 1e-4}}

# configs/pascal/vit_small_dense_multi_task.yml as a literal (the card's
# installation may lack PyYAML; tests/test_torch_port_step_paths.py holds it
# equal to the YAML)
DENSE_CONFIG = {
    "setup": "multi_task", "train_db_name": "PASCALContext",
    "epochs": 100, "optimizer": "sgd",
    "optimizer_kwargs": {"lr": 0.002, "momentum": 0.9,
                         "weight_decay": 0.0001},
    "scheduler": "poly", "model": "baseline", "backbone": "VisionTransformer",
    "backbone_kwargs": {"model_name": "vit_small_patch16_224",
                        "img_size": [512, 512], "patch_size": 16,
                        "embed_dim": 384, "depth": 12, "num_heads": 6,
                        "mlp_ratio": 4.0, "qkv_bias": True},
    "head": "VisionTransformerUpHead",
    "head_kwargs": {"embed_dim": 384, "img_size": [512, 512], "num_conv": 4,
                    "num_upsampe_layer": 4, "patch_size": 16},
    "compute_dtype": "bfloat16",
    "task_dictionary": {"include_semseg": True, "include_human_parts": True,
                        "include_sal": True, "include_edge": True,
                        "include_normals": True, "edge_w": 0.95},
    "loss_kwargs": {"loss_weights": {"semseg": 1.0, "human_parts": 2.0,
                                     "sal": 5.0, "edge": 50.0,
                                     "normals": 10.0}},
}

# (bf16 dense tensor-core FLOP/s, HBM bytes/s) by device name, from NVIDIA's
# data sheet (H100 SXM5, at its 700 W limit)
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}
REQUESTS = 200           # timed requests per serving cell
EVAL_REPS = 10

failures = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)
        print(f"chip_smoke: CHECK FAILED: {what}", file=sys.stderr, flush=True)


def peaks_for(name: str):
    if name not in PEAKS:
        raise RuntimeError(f"no peak rates known for {name!r} (known: "
                           f"{sorted(PEAKS)}); bound_ms cannot be computed")
    return PEAKS[name]


def time_calls(fn, reps: int = 30, warmup: int = 3):
    """(device ms, host ms) per call of fn.  `reps` calls go back to back
    between one pair of CUDA events, after `warmup` calls.  The device is
    first held in a spin (torch.cuda._sleep) long enough for the host to
    queue all of them, so the events see the calls run as one queue: the
    device time, not the gaps of a host slower than the kernel.  The host
    time is the wall clock of queueing one call (the wrapper's own work)."""
    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        per_call = time.perf_counter() - t0   # the last, warm, call
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    # ~2e9 cycles/s: twice the expected queueing time plus 1 ms, at most ~1 s
    torch.cuda._sleep(int(2e9 * min(2 * per_call * reps + 1e-3, 1.0)))
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, host_ms


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Device ms per call of fn (see time_calls)."""
    return time_calls(fn, reps, warmup)[0]


def device_profile(fn, n: int = 3, top: int = 8):
    """n calls of fn under torch.profiler: the device time per call (every
    kernel, copy and fill the card ran, summed) and the `top` kernels by
    time.  Set against the call's unprofiled time, it says how long the
    card sits idle waiting for the host."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / 1e3 / n, e.count / n, e.key)
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA"), reverse=True)
    return {"device_ms": sum(r[0] for r in rows), "top": [
        {"name": k[:90], "ms": ms, "calls": c} for ms, c, k in rows[:top]]}


def bound(flops: float, nbytes: float, peaks):
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# the device kernels K4 and K6 launch, by pass (substrings of their names)
FFN_BWD_PASSES = (("ln_prepass", "ln_prepass_kernel"),
                  ("hidden", "ffn_bwd_hidden_kernel"),
                  ("dh", "ffn_gemm_kernel<0, 1"),
                  ("dw1_dw2", "ffn_gemm_kernel<1, 1"),
                  ("dx", "ln_dx_kernel"), ("sums", "sum_parts_kernel"))


# ... and the two-pass forward route of K3/K5/K7 at d in {768, 1024}
# (csrc/ffn_fwd_gemm.cuh): K5's LayerNorm pre-pass, K7's dequantizing pass,
# the hidden pass (bias + GELU epilogue), the output pass (bias, or bias and
# K5's residual)
FFN_TWO_PASS_PASSES = (("ln_prepass", "ln_prepass_kernel"),
                       ("dequant", "dequant_banks_kernel"),
                       ("hidden", "ffn_gemm_kernel<0, 0, 1"),
                       ("output", "ffn_gemm_kernel<0, 0, 2"),
                       ("output_residual", "ffn_gemm_kernel<0, 0, 3"))


# ... and K7: its dequantizing pass, then K3's forward on the bf16 banks
FFN_Q_PASSES = (("dequant", "dequant_banks_kernel"),
                ("products", "ffn_fwd_kernel"))


def pass_times(fn, passes=FFN_BWD_PASSES):
    """Device ms per call of fn by pass of K4/K6 (or `passes`; torch.profiler,
    5 calls), and their sum.  A profile that caught none of the passes
    (the profiler now and then returns no device events) is taken again,
    up to three times; None if none of them did."""
    for _ in range(3):
        top = device_profile(fn, 5, top=20)["top"]
        out = {}
        for name, key in passes:
            ms = sum(r["ms"] for r in top if key in r["name"])
            if ms:
                out[name] = ms
        if out:
            out["total"] = sum(out.values())
            return out
    print("chip_smoke: no device events in three profiles", file=sys.stderr)
    return None


def two_pass_readings(fn, name: str, shape, hidden_elems: int):
    """On the two-pass forward route (ops/expert_ffn.py:ffn_route), each
    pass's device time inside a call of fn, the scratch the call allocates
    (kernel `name`'s C <name>_scratch for `shape`), and the measured cost of
    the hidden activation's round trip through device memory: a copy of a
    bf16 tensor of `hidden_elems` elements (it reads them once and writes
    them once); {} on the fused route."""
    if ffn_route(shape[-2], shape[-1]) != "two_pass":
        return {}
    a = torch.empty(hidden_elems, dtype=torch.bfloat16, device="cuda")
    b = torch.empty_like(a)
    out = {"route": "two_pass",
           "scratch_mb": _scratch_bytes(name, *shape) / 1e6,
           "hidden_mb_each_way": 2.0 * hidden_elems / 1e6,
           "hidden_round_trip_ms": time_ms(lambda: b.copy_(a), 30),
           "passes_ms": pass_times(fn, FFN_TWO_PASS_PASSES)}
    del a, b
    return out


def call_memory_mb(fn) -> float:
    """Device memory one call of fn holds at its peak beyond what was
    allocated before it (its outputs and transient scratch), MB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def attention_phase(peaks, dev):
    """K1 at the train/serve bucket-8 shape (all keys, and 1000 valid) and
    at serving bucket 1; its o against the plain version, its lse against
    the plain logsumexp, and two runs bit for bit."""
    N, C, H = 1025, 384, 6
    d = C // H
    scale = d ** -0.5
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for B, valid in ((8, None), (8, 1000), (1, None)):
        qkv = torch.randn(B, N, 3 * C, device=dev, generator=g).bfloat16()
        q, k, v = qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
        n_kv = N if valid is None else valid
        got, lse = flash_attention_fwd(qkv, H, scale, valid)
        again, lse_again = flash_attention_fwd(qkv, H, scale, valid)
        ref = flash_attention_qkv_plain(qkv, H, scale, valid)
        err = (got.float() - ref.float()).abs().max().item()
        lse_err = (lse - flash_attention_lse_plain(qkv, H, scale, valid)
                   ).abs().max().item()
        same = torch.equal(got, again) and torch.equal(lse, lse_again)
        check(err <= ATTN_TOL and lse_err <= LSE_TOL and same
              and bool(torch.isfinite(got).all()),
              f"flash_attention_fwd B={B} valid_len={valid}: max abs err "
              f"{err}, lse max abs err {lse_err}, bitwise repeatable {same}")
        mask = None if valid is None else (
            torch.arange(N, device=dev) < valid).view(1, 1, 1, N)
        flops = 4.0 * B * H * N * n_kv * d
        nbytes = 2.0 * B * C * (N + 2 * n_kv) + 2.0 * B * N * C + 4.0 * B * H * N
        b_ms, b_by = bound(flops, nbytes, peaks)
        ms, host_ms = time_calls(
            lambda: flash_attention_fwd(qkv, H, scale, valid), 100)
        cases.append({
            "shape": f"qkv [{B},{N},{3 * C}] bf16, {H} heads of {d}",
            "valid_len": valid, "max_abs_err": err,
            "lse_max_abs_err": lse_err, "bitwise_repeatable": same,
            "ms": ms, "host_ms": host_ms, "tflops": flops / ms / 1e9,
            "plain_ms": time_ms(
                lambda: flash_attention_qkv_plain(qkv, H, scale, valid), 20),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale), 100),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
        })
    emit({"phase": "flash_attention_fwd", "cases": cases})
    return cases


# K3's shapes on the wider models' paths (the flagship's are ffn_phase's
# own): ViT-base M3ViT's experts at the train capacity (B=8, 1025 tokens an
# image, E 16, K 2, cf 1.25) and at the CLI's no-drop eval capacity, its
# dense MLP; ViT-large's dense MLP (B=8, 1201 tokens); ViT-tiny MoE's
# experts (B=4, 129 tokens) and dense MLP: the widths 768, 1024 and 192
WIDE_FFN_SHAPES = (
    ("vit_base_experts_train", 16, compute_capacity(8200, 2, 16, 1.25), 768,
     1536),
    ("vit_base_experts_eval_nodrop", 16, 8200, 768, 1536),
    ("vit_base_dense_mlp", 1, 8200, 768, 3072),
    ("vit_large_dense_mlp", 1, 9608, 1024, 4096),
    ("vit_tiny_experts_train", 16, compute_capacity(516, 2, 16, 1.25), 192,
     384),
    ("vit_tiny_dense_mlp", 1, 516, 192, 768))
# K4 and K6 at the train steps' shapes, K5 at the dense blocks', K7 at
# ViT-base's int8 serving capacities (eval cf 4.0: buckets 8 and 1)
WIDE_FFN_BWD_SHAPES = tuple(c for c in WIDE_FFN_SHAPES
                            if "nodrop" not in c[0])
WIDE_LN_MLP_SHAPES = (("vit_base", 8200, 768, 3072),
                      ("vit_large", 9608, 1024, 4096),
                      ("vit_tiny", 516, 192, 768))
WIDE_FFN_Q_SHAPES = (
    ("vit_base_bucket_8", 16, compute_capacity(8200, 2, 16, 4.0), 768, 1536),
    ("vit_base_bucket_1", 16, compute_capacity(1025, 2, 16, 4.0), 768, 1536))


def ffn_phase(peaks, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    cases = []
    # expert banks at the serving capacity (cf 2.0) and the train capacity
    # (cf 1.25), the dense MLP at E=1, and the expert banks at the 5-task
    # eval's no-drop capacity (every token); B=8, 1025 tokens per image;
    # then the wider models' shapes
    nodrop = compute_capacity(8 * 1025, 4, 16, parse_capacity_factor("nodrop"))
    for name, E, Ct, d, Hd in (("experts", 16, 4104, 384, 384),
                               ("dense_mlp", 1, 8200, 384, 1536),
                               ("experts_train", 16, 2568, 384, 384),
                               ("experts_eval_nodrop", 16, nodrop, 384,
                                384)) + WIDE_FFN_SHAPES:
        r = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
        # unit-scale tokens (LayerNorm output) and fan-in scaled weights
        h = r(E, Ct, d).bfloat16()
        w1 = (r(E, Hd, d) * d ** -0.5).bfloat16()
        w2 = (r(E, d, Hd) * 0.5 * Hd ** -0.5).bfloat16()
        b1, b2 = r(E, Hd) * 0.1, r(E, d) * 0.1
        got = expert_ffn_fwd(h, w1, b1, w2, b2)
        same = torch.equal(got, expert_ffn_fwd(h, w1, b1, w2, b2))
        ref = fused_expert_ffn_plain(h, w1, b1, w2, b2)
        diff = got.float() - ref.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / ref.float().norm()).item()
        check(err <= FFN_ABS_TOL and rel <= FFN_REL_TOL and same
              and bool(torch.isfinite(got).all()),
              f"expert_ffn_fwd {name}: max abs err {err}, rel {rel}, "
              f"bitwise repeatable {same}")
        b1h, b2h = b1.bfloat16()[:, None], b2.bfloat16()[:, None]

        def yardstick():
            a = F.gelu(torch.baddbmm(b1h, h, w1.transpose(1, 2)))
            return torch.baddbmm(b2h, a, w2.transpose(1, 2))

        flops = 4.0 * E * Ct * d * Hd
        nbytes = 2.0 * (2 * E * Ct * d + 2 * E * d * Hd) + 4.0 * E * (Hd + d)
        b_ms, b_by = bound(flops, nbytes, peaks)
        ms, host_ms = time_calls(lambda: expert_ffn_fwd(h, w1, b1, w2, b2))
        cases.append({
            "shape": f"{name}: h [{E},{Ct},{d}] x hidden {Hd} bf16",
            "max_abs_err": err, "rel_err": rel, "bitwise_repeatable": same,
            "ms": ms, "host_ms": host_ms, "tflops": flops / ms / 1e9,
            "plain_ms": time_ms(
                lambda: fused_expert_ffn_plain(h, w1, b1, w2, b2), 20),
            "library_ms": None,
            "yardstick_bmm_gelu_bmm_ms": time_ms(yardstick),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
            **two_pass_readings(lambda: expert_ffn_fwd(h, w1, b1, w2, b2),
                                "expert_ffn_fwd", (E, Ct, d, Hd),
                                E * Ct * Hd),
        })
        del h, w1, w2, got, ref, diff
    emit({"phase": "expert_ffn_fwd", "cases": cases})
    return cases


def grad_errors(got, ref):
    """(max abs err, relative Frobenius err, largest |ref|) of got vs ref."""
    diff = got.float() - ref.float()
    return (diff.abs().max().item(),
            (diff.norm() / ref.float().norm().clamp(min=1e-30)).item(),
            ref.float().abs().max().item())


def check_grads(got, ref, what):
    err, rel, scale = grad_errors(got, ref)
    check(rel <= GRAD_REL_TOL and err <= GRAD_ABS_FRAC * max(1.0, scale)
          and bool(torch.isfinite(got).all()),
          f"{what}: max abs err {err} (ref max {scale}), rel {rel}")
    return {"max_abs_err": err, "rel_err": rel, "ref_max": scale}


def attention_bwd_phase(peaks, dev):
    B, N, C, H = 8, 1025, 384, 6
    d = C // H
    scale = d ** -0.5
    g = torch.Generator(device=dev).manual_seed(2)
    qkv = torch.randn(B, N, 3 * C, device=dev, generator=g).bfloat16()
    dout = torch.randn(B, N, C, device=dev, generator=g).bfloat16()
    cases = []
    for valid in (None, 1000):
        n_kv = N if valid is None else valid
        o, lse = flash_attention_fwd(qkv, H, scale, valid)
        got = flash_attention_bwd(qkv, o, lse, dout, H, scale, valid)
        same = torch.equal(
            got, flash_attention_bwd(qkv, o, lse, dout, H, scale, valid))
        check(same, f"flash_attention_bwd valid_len={valid}: two runs differ")
        # the plain backward fed the plain lse, so a wrong K1 lse shows here
        ref = flash_attention_qkv_bwd_plain(
            qkv, o, flash_attention_lse_plain(qkv, H, scale, valid), dout, H,
            scale, valid)
        errs = {f"d{n}": check_grads(got[..., i * C:(i + 1) * C],
                                     ref[..., i * C:(i + 1) * C],
                                     f"flash_attention_bwd valid_len={valid}"
                                     f" d{n}")
                for i, n in enumerate("qkv")}
        # SDPA's backward alone: its graph built once, autograd.grad timed
        q, k, v = (t.detach().clone().requires_grad_() for t in
                   qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4))
        do4 = dout.view(B, N, H, d).transpose(1, 2)
        mask = None if valid is None else (
            torch.arange(N, device=dev) < valid).view(1, 1, 1, N)
        sdpa_out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=scale)

        flops = 10.0 * B * H * N * n_kv * d
        nbytes = (2.0 * B * N * 3 * C * 2 + 2.0 * B * N * C * 2
                  + 4.0 * B * H * N)
        b_ms, b_by = bound(flops, nbytes, peaks)
        ms, host_ms = time_calls(lambda: flash_attention_bwd(
            qkv, o, lse, dout, H, scale, valid), 100)
        cases.append({
            "shape": f"qkv [{B},{N},{3 * C}] bf16, {H} heads of {d}",
            "valid_len": valid, **errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "bitwise_repeatable": same,
            "ms": ms, "host_ms": host_ms, "tflops": flops / ms / 1e9,
            "plain_ms": time_ms(lambda: flash_attention_qkv_bwd_plain(
                qkv, o, lse, dout, H, scale, valid), 10),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                sdpa_out, (q, k, v), do4, retain_graph=True), 100),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_7_products_ms": bound(1.4 * flops, nbytes, peaks)[0],
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        })
    emit({"phase": "flash_attention_bwd", "cases": cases})
    return cases


def ffn_bwd_phase(peaks, dev):
    """K4 at the train step's two shapes: the expert banks at the train
    capacity and the dense MLP; against its plain version, two runs bit for
    bit, each pass's device time, and two yardsticks: a bmm backward that
    recomputes the forward, and the autograd backward of bmm -> GELU -> bmm
    with its forward saved.  Where the planner's token splits leave the
    weight launch short of a wave, it is also timed at the fewest splits
    that fill one (the rule `bwd_plan` does not take)."""
    g = torch.Generator(device=dev).manual_seed(3)
    cases, plans = [], {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, E, Ct, d, Hd in (("experts", 16, 2568, 384, 384),
                               ("dense_mlp", 1, 8200, 384, 1536)
                               ) + WIDE_FFN_BWD_SHAPES:
        r = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
        h = r(E, Ct, d).bfloat16()
        w1 = (r(E, Hd, d) * d ** -0.5).bfloat16()
        w2 = (r(E, d, Hd) * 0.5 * Hd ** -0.5).bfloat16()
        b1 = r(E, Hd) * 0.1
        gy = r(E, Ct, d).bfloat16()
        got = expert_ffn_bwd(h, w1, b1, w2, gy)
        again = expert_ffn_bwd(h, w1, b1, w2, gy)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        check(same, f"expert_ffn_bwd {name}: two runs differ")
        ref = expert_ffn_bwd_plain(h, w1, b1, w2, gy)
        errs = {k: check_grads(a, b, f"expert_ffn_bwd {name} {k}")
                for k, a, b in zip(("dh", "dw1", "db1", "dw2", "db2"), got,
                                   ref)}
        del again, ref
        b1h = b1.bfloat16()[:, None]

        def yardstick():   # recompute, then bmm for dh, dw1 and dw2
            a_pre = torch.baddbmm(b1h, h, w1.transpose(1, 2)).float()
            cdf = 0.5 * (1.0 + torch.erf(a_pre * 0.5 ** 0.5))
            a = (a_pre * cdf).bfloat16()
            dgelu = cdf + a_pre * torch.exp(-0.5 * a_pre * a_pre) * (
                2.0 * np.pi) ** -0.5
            da = (torch.bmm(gy, w2).float() * dgelu).bfloat16()
            return (torch.bmm(da, w1), torch.bmm(da.transpose(1, 2), h),
                    torch.bmm(gy.transpose(1, 2), a), da.float().sum(1),
                    gy.float().sum(1))

        # bmm -> GELU -> bmm in bf16, its graph (forward saved) built once
        leaves = [t.detach().clone().requires_grad_() for t in (
            h, w1, b1h, w2, torch.zeros_like(h[:, :1]))]
        lh, lw1, lb1, lw2, lb2 = leaves
        out = torch.baddbmm(
            lb2, F.gelu(torch.baddbmm(lb1, lh, lw1.transpose(1, 2))),
            lw2.transpose(1, 2))

        flops = 10.0 * E * Ct * d * Hd
        nbytes = (2.0 * 3 * E * Ct * d + 2.0 * 2 * E * d * Hd
                  + 4.0 * 2 * E * d * Hd + 4.0 * 2 * E * Hd + 4.0 * E * d)
        b_ms, b_by = bound(flops, nbytes, peaks)
        ms, host_ms = time_calls(lambda: expert_ffn_bwd(h, w1, b1, w2, gy))
        plan = bwd_plan(E, Ct, d, Hd, sms)
        plans[name] = {**plan._asdict(), "ms": ms}
        # the fewest splits that fill a wave, within one a k-step
        fill = min(-(-sms // (plan.tiles[2] // plan.splits)),
                   -(-Ct // BWD_KSTEP))
        if fill != plan.splits:
            alt = bwd_plan(E, Ct, d, Hd, sms, splits=fill)
            plans[name]["filling_a_wave"] = {
                **alt._asdict(), "ms": time_calls(
                    lambda: expert_ffn_bwd(h, w1, b1, w2, gy, plan=alt))[0]}
        cases.append({
            "shape": f"{name}: h [{E},{Ct},{d}] x hidden {Hd} bf16",
            **errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "bitwise_repeatable": same,
            "ms": ms, "host_ms": host_ms, "tflops": flops / ms / 1e9,
            "passes_ms": pass_times(lambda: expert_ffn_bwd(h, w1, b1, w2,
                                                           gy)),
            "call_memory_mb": call_memory_mb(
                lambda: expert_ffn_bwd(h, w1, b1, w2, gy)),
            "plain_ms": time_ms(
                lambda: expert_ffn_bwd_plain(h, w1, b1, w2, gy), 10),
            "library_ms": None,
            "yardstick_bmm_backward_ms": time_ms(yardstick),
            "yardstick_autograd_backward_ms": time_ms(
                lambda: torch.autograd.grad(out, leaves, gy,
                                            retain_graph=True)),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
        })
        del out, leaves
    emit({"phase": "expert_ffn_bwd", "cases": cases, "plans": plans})
    return cases


def ffn_q_phase(peaks, dev):
    """K7 at the int8 serving path's expert shapes: bucket 8 and bucket 1
    at the eval capacity factor 2.0.  Against its plain version; bit for
    bit against K3 on the plain-dequantized bf16 banks and against a second
    run; its dequantizing pass alone (bit for bit against the plain
    dequantization, and timed against its byte bound), K3 alone on those
    banks, each pass's device time inside a K7 call, and the memory one
    call holds (its output and its transient scratch)."""
    g = torch.Generator(device=dev).manual_seed(4)
    cases = []
    for name, E, Ct, d, Hd in (("bucket_8", 16, 4104, 384, 384),
                               ("bucket_1", 16, 520, 384, 384)
                               ) + WIDE_FFN_Q_SHAPES:
        r = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
        h = r(E, Ct, d).bfloat16()
        q1, s1 = quantize_weight(r(E, Hd, d) * d ** -0.5)
        q2, s2 = quantize_weight(r(E, d, Hd) * 0.5 * Hd ** -0.5)
        b1, b2 = r(E, Hd) * 0.1, r(E, d) * 0.1
        args = (h, q1, s1, b1, q2, s2, b2)
        got = expert_ffn_q_fwd(*args)
        ref = quantized_expert_ffn_plain(*args)
        diff = got.float() - ref.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / ref.float().norm()).item()
        same = torch.equal(got, expert_ffn_q_fwd(*args))
        w1 = dequantize_weight(q1, s1).bfloat16()
        w2 = dequantize_weight(q2, s2).bfloat16()
        dq1, dq2 = expert_ffn_q_dequant(q1, s1, q2, s2)
        dequant_bitwise = torch.equal(dq1, w1) and torch.equal(dq2, w2)
        k3_bitwise = torch.equal(got, expert_ffn_fwd(h, w1, b1, w2, b2))
        check(err <= FFN_ABS_TOL and rel <= FFN_REL_TOL and same
              and dequant_bitwise and k3_bitwise
              and bool(torch.isfinite(got).all()),
              f"expert_ffn_q_fwd {name}: max abs err {err}, rel {rel}, "
              f"bitwise repeatable {same}, dequantizing pass bitwise "
              f"{dequant_bitwise}, bitwise K3 on its banks {k3_bitwise}")
        del dq1, dq2
        b1h, b2h = b1.bfloat16()[:, None], b2.bfloat16()[:, None]

        def yardstick():   # dequantize -> bmm -> GELU -> bmm
            w1 = dequantize_weight(q1, s1).bfloat16()
            w2 = dequantize_weight(q2, s2).bfloat16()
            a = F.gelu(torch.baddbmm(b1h, h, w1.transpose(1, 2)))
            return torch.baddbmm(b2h, a, w2.transpose(1, 2))

        flops = 4.0 * E * Ct * d * Hd
        nbytes = (2.0 * 2 * E * Ct * d + 1.0 * 2 * E * d * Hd
                  + 4.0 * 2 * E * (Hd + d))
        b_ms, b_by = bound(flops, nbytes, peaks)
        # the dequantizing pass: int8 banks and scales in, bf16 banks out
        dq_bytes = (1.0 + 2.0) * 2 * E * d * Hd + 4.0 * E * (Hd + d)
        ms, host_ms = time_calls(lambda: expert_ffn_q_fwd(*args))
        cases.append({
            "shape": f"{name}: h [{E},{Ct},{d}] bf16 x hidden {Hd}, int8 "
                     "weights",
            "max_abs_err": err, "rel_err": rel, "bitwise_repeatable": same,
            "bitwise_k3_on_dequantized_banks": k3_bitwise,
            "ms": ms, "host_ms": host_ms, "tflops": flops / ms / 1e9,
            "passes_ms": pass_times(lambda: expert_ffn_q_fwd(*args),
                                    FFN_Q_PASSES)
            if ffn_route(d, Hd) == "fused" else None,
            "call_memory_mb": call_memory_mb(
                lambda: expert_ffn_q_fwd(*args)),
            "dequant": {
                "bitwise": dequant_bitwise,
                "ms": time_ms(lambda: expert_ffn_q_dequant(q1, s1, q2, s2),
                              100),
                "bound_ms": dq_bytes / peaks[1] * 1e3,
                "mbytes": dq_bytes / 1e6},
            "k3_on_dequantized_banks_ms": time_ms(
                lambda: expert_ffn_fwd(h, w1, b1, w2, b2)),
            "plain_ms": time_ms(lambda: quantized_expert_ffn_plain(*args), 20),
            "library_ms": None,
            "yardstick_dequant_bmm_gelu_bmm_ms": time_ms(yardstick),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
            **two_pass_readings(lambda: expert_ffn_q_fwd(*args),
                                "expert_ffn_q_fwd", (E, Ct, d, Hd),
                                E * Ct * Hd),
        })
    emit({"phase": "expert_ffn_q_fwd", "cases": cases})
    return cases


def ln_mlp_inputs(dev, seed: int, S: int = 8200, d: int = 384,
                  H: int = 1536):
    """The dense blocks' sublayer at B=8 (8200 tokens): x and gr bf16,
    gamma/beta/b1/b2 f32, w1 [H, d] and w2 [d, H] bf16."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
    return (r(S, d).bfloat16(), 1.0 + 0.1 * r(d), 0.1 * r(d),
            (r(H, d) * d ** -0.5).bfloat16(), r(H) * 0.1,
            (r(d, H) * 0.5 * H ** -0.5).bfloat16(), r(d) * 0.1,
            r(S, d).bfloat16())


def library_ln_mlp(x, gamma, beta, w1, b1, w2, b2):
    """The yardstick: F.layer_norm -> F.linear -> F.gelu -> F.linear -> add
    in bf16 (never called by the port)."""
    h = F.layer_norm(x, x.shape[-1:], gamma.bfloat16(), beta.bfloat16(), 1e-6)
    return x + F.linear(F.gelu(F.linear(h, w1, b1.bfloat16())), w2,
                        b2.bfloat16())


def ln_mlp_fwd_phase(peaks, dev):
    """K5 at the dense blocks' shape, then at the wider models'."""
    cases = []
    for case, S, d, H in (("flagship", 8200, 384, 1536),) + WIDE_LN_MLP_SHAPES:
        x, gamma, beta, w1, b1, w2, b2, _ = ln_mlp_inputs(dev, 5, S, d, H)
        args = (x, gamma, beta, w1, b1, w2, b2)
        got = ln_mlp_fwd(*args)
        same = torch.equal(got, ln_mlp_fwd(*args))
        ref = ln_mlp_residual_plain(*args)
        diff = got.float() - ref.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / ref.float().norm()).item()
        check(err <= FFN_ABS_TOL and rel <= FFN_REL_TOL and same
              and bool(torch.isfinite(got).all()),
              f"ln_mlp_fwd {case}: max abs err {err}, rel {rel}, bitwise "
              f"repeatable {same}")
        flops = 4.0 * S * d * H
        nbytes = 2.0 * 2 * S * d + 2.0 * 2 * d * H + 4.0 * (3 * d + H)
        b_ms, b_by = bound(flops, nbytes, peaks)
        ms, host_ms = time_calls(lambda: ln_mlp_fwd(*args))
        cases.append({
            "shape": f"{case}: x [{S},{d}] bf16 x hidden {H}",
            "max_abs_err": err, "rel_err": rel, "bitwise_repeatable": same,
            "ms": ms, "host_ms": host_ms, "tflops": flops / ms / 1e9,
            "plain_ms": time_ms(lambda: ln_mlp_residual_plain(*args), 20),
            "library_ms": None,
            "yardstick_layer_norm_linear_gelu_linear_add_ms":
                time_ms(lambda: library_ln_mlp(*args)),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
            **two_pass_readings(lambda: ln_mlp_fwd(*args), "ln_mlp_fwd",
                                (S, d, H), S * H),
        })
        del x, got, ref, diff
    emit({"phase": "ln_mlp_fwd", "cases": cases})
    return cases


def ln_mlp_bwd_phase(peaks, dev):
    """K6 at the dense blocks' shape, then at the wider models'."""
    cases, plans = [], {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, S, d, H in (("flagship", 8200, 384, 1536),) + WIDE_LN_MLP_SHAPES:
        x, gamma, beta, w1, b1, w2, b2, gr = ln_mlp_inputs(dev, 6, S, d, H)
        args = (x, gamma, beta, w1, b1, w2, gr)
        got = ln_mlp_bwd(*args)
        same = all(torch.equal(a, b) for a, b in zip(got, ln_mlp_bwd(*args)))
        check(same, f"ln_mlp_bwd {case}: two runs differ")
        ref = ln_mlp_residual_bwd_plain(*args)
        errs = {k: check_grads(a, b, f"ln_mlp_bwd {case} {k}")
                for k, a, b in zip(("dx", "dgamma", "dbeta", "dw1", "db1",
                                    "dw2", "db2"), got, ref)}
        del got, ref
        # the yardstick's autograd backward, its graph built once
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, gamma, beta, w1, b1, w2, b2)]
        out = library_ln_mlp(*leaves)
        flops = 10.0 * S * d * H
        nbytes = (2.0 * 3 * S * d + 2.0 * 2 * d * H + 4.0 * 2 * d * H
                  + 4.0 * (2 * d + H) + 4.0 * (3 * d + H))
        b_ms, b_by = bound(flops, nbytes, peaks)
        ms, host_ms = time_calls(lambda: ln_mlp_bwd(*args))
        plans[case] = bwd_plan(1, S, d, H, sms)._asdict()
        cases.append({
            "shape": f"{case}: x [{S},{d}] bf16 x hidden {H}", **errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "bitwise_repeatable": same,
            "ms": ms, "host_ms": host_ms, "tflops": flops / ms / 1e9,
            "passes_ms": pass_times(lambda: ln_mlp_bwd(*args)),
            "call_memory_mb": call_memory_mb(lambda: ln_mlp_bwd(*args)),
            "plain_ms": time_ms(lambda: ln_mlp_residual_bwd_plain(*args),
                                10),
            "library_ms": None,
            "yardstick_autograd_backward_ms": time_ms(
                lambda: torch.autograd.grad(out, leaves, gr,
                                            retain_graph=True)),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
        })
        del out, leaves, x, gr
    emit({"phase": "ln_mlp_bwd", "cases": cases, "plans": plans})
    return cases


def time_requests(sess, x, post: bool, n: int, classes: int = 21):
    """One untimed and `n` timed semseg requests of the batch `x` (numpy,
    [b, H, W, 3]) for a model of `classes` semseg classes; checks the last
    output and returns its latency row."""
    b, H, W = x.shape[:3]
    out = sess.predict(x, "semseg", postprocess=post)
    lats = []
    t_window = time.perf_counter()
    for _ in range(n):
        t0 = time.perf_counter()
        out = sess.predict(x, "semseg", postprocess=post)
        lats.append((time.perf_counter() - t0) * 1e3)
    window_s = time.perf_counter() - t_window
    if post:
        check(out.shape == (b, H, W) and out.dtype == np.uint8
              and int(out.max()) < classes,
              f"bucket {b} class map {out.shape} {out.dtype}")
    else:
        check(out.shape == (b, H, W, classes)
              and bool(np.isfinite(out).all()),
              f"bucket {b} logits {out.shape} finite")
    # img/s over the whole window: every image over all the time
    return {"requests": n, "p50_ms": float(np.percentile(lats, 50)),
            "p99_ms": float(np.percentile(lats, 99)), "max_ms": max(lats),
            "img_per_s": b * n / window_s}


def time_eval(model, x, tasks):
    """One untimed and EVAL_REPS timed 5-task eval passes of `x`; checks
    the outputs and returns (ms per pass, last outputs, last stats)."""
    with torch.inference_mode():
        model(x)
        t0 = time.perf_counter()
        for _ in range(EVAL_REPS):
            out, _, stats = model(x)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) / EVAL_REPS * 1e3
    check(set(out) == {t.name for t in tasks} and all(
        v.shape == (x.shape[0], t.num_output, IMG, IMG)
        and bool(torch.isfinite(v).all())
        for t in tasks for v in [out[t.name]]), "5-task eval outputs")
    return eval_ms, out, stats


def logit_agreement(a, b):
    """(class-map agreement, relative logit error) of logits a against
    b, NHWC numpy."""
    return (float((a.argmax(-1) == b.argmax(-1)).mean()),
            float(np.linalg.norm(a - b) / np.linalg.norm(b)))


def serving_phase(dev):
    t0 = time.perf_counter()
    model, tasks = build_flagship(device=dev, seed=0)
    names = [t.name for t in tasks]
    build_s = time.perf_counter() - t0
    sess = InferenceSession(model, names, (IMG, IMG), buckets=BUCKETS,
                            device=dev)
    raw = InferenceSession(model, names, (IMG, IMG), buckets=BUCKETS,
                           raw_uint8_input=True, device=dev)
    t0 = time.perf_counter()
    sess.warmup(tasks=["semseg"])
    raw.warmup(tasks=["semseg"], postprocess=True)
    warmup_s = time.perf_counter() - t0
    emit({"phase": "serving_setup", "model_build_s": build_s,
          "warmup_s": warmup_s, "params": sum(
              p.numel() for p in model.parameters())})

    rng = np.random.RandomState(0)
    requests = 0
    _build.reset_launches()            # the main path starts here
    for b in BUCKETS:
        imgs = rng.randn(b, IMG, IMG, 3).astype(np.float32)
        u8 = rng.randint(0, 256, (b, IMG, IMG, 3)).astype(np.uint8)
        row = {"bucket": b}
        for kind, s, x, post in (("f32_logits", sess, imgs, False),
                                 ("uint8_post", raw, u8, True)):
            row[kind] = time_requests(s, x, post, REQUESTS)
            requests += REQUESTS + 1
        emit({"phase": "serving", **row})

    x = torch.randn(8, 3, IMG, IMG, device=dev).contiguous(
        memory_format=torch.channels_last)
    eval_ms, out, stats = time_eval(model, x, tasks)
    launches = dict(_build.launches)   # ... and ends here
    emit({"phase": "eval_5task", "batch": 8, "ms": eval_ms,
          "img_per_s": 8 / eval_ms * 1e3,
          "dropped_slot_fraction": (stats["dropped_slot_fraction"]
                                    / stats["moe_stat_count"]).item()})
    passes = requests + 5 * (1 + EVAL_REPS)   # single-task requests + task passes
    emit({"phase": "launches", "launches": launches,
          "backbone_passes": passes,
          "per_pass": check_launches(
              launches, passes,
              expected_serving_launches(len(model.backbone.blocks)),
              "serving")})
    # the device's share of a bucket-8 uint8 request (p50 above)
    prof = device_profile(lambda: raw.predict(u8, "semseg", postprocess=True),
                          5)
    emit({"phase": "serving_profile", "bucket": 8,
          "device_ms_per_request": prof["device_ms"],
          "device_idle_frac": 1.0 - prof["device_ms"] / row["uint8_post"][
              "p50_ms"], "top_kernels": prof["top"]})

    # the same weights through the plain PyTorch versions, at bucket 2
    imgs = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    k_logits = sess.predict(imgs, "semseg")
    before = dict(_build.launches)
    set_use_kernels(model, False)
    p_logits = sess.predict(imgs, "semseg")
    set_use_kernels(model, True)
    check(dict(_build.launches) == before, "plain run launched a kernel")
    agree, rel = logit_agreement(k_logits, p_logits)
    check(agree >= AGREE_MIN and rel <= LOGIT_REL_TOL,
          f"kernel vs plain at bucket 2: class agreement {agree}, "
          f"logit rel err {rel}")
    emit({"phase": "kernel_vs_plain", "bucket": 2,
          "class_map_agreement": agree, "logit_rel_err": rel})
    return launches


PARAM_GROUPS = (("attention", ".attn."), ("dense_mlp", ".mlp.fc"),
                ("experts", ".mlp.experts."), ("gates", ".mlp.gate."),
                ("heads", "decoders."), ("tam", "tam_model"))


def param_group(name: str) -> str:
    return next((g for g, key in PARAM_GROUPS if key in name),
                "embed_and_norms")


class RoutingTape:
    """Records every gate's top-(k+1) experts during one forward and
    replays them, in call order, during another, so that two forwards whose
    roundings differ route every token alike.  Replayed gate values are the
    replaying forward's own scores at the recorded experts (the VMoE gate's
    softmax probabilities; the learned-noise gate's logits, its k scores
    renormalised), so the gates stay differentiable.  Counts the tokens
    whose own top-k set differs from the recording.  Installed in place of
    the MoE block's gate functions; for this script's comparisons only."""

    def __init__(self):
        self.tape, self.replaying, self.pos = [], False, 0
        self.tokens = self.rerouted = 0

    def __enter__(self):
        vit_moe.noisy_vmoe_gate = self.gate
        vit_moe.noisy_gate = self.learned_gate
        self.pos = 0
        return self

    def __exit__(self, *exc):
        vit_moe.noisy_vmoe_gate = noisy_vmoe_gate
        vit_moe.noisy_gate = noisy_gate
        if not exc[0] and self.replaying and self.pos != len(self.tape):
            raise RuntimeError(f"replayed {self.pos} of {len(self.tape)} "
                               "gate calls")
        self.replaying = True

    def _tape(self, out, scores, top_k, renormalise: bool):
        if not self.replaying:
            self.tape.append(small_topk(scores.detach(),
                                        out.top_logits.shape[1])[1])
            return out
        idx = self.tape[self.pos]
        self.pos += 1
        own = out.top_k_indices.sort(dim=-1).values
        self.rerouted += int((own != idx[:, :top_k].sort(dim=-1).values)
                             .any(dim=-1).sum())
        self.tokens += idx.shape[0]
        top = scores.gather(1, idx)
        if not renormalise:
            return out._replace(top_k_indices=idx[:, :top_k],
                                top_k_gates=top[:, :top_k], top_logits=top)
        gates = torch.softmax(top[:, :top_k], dim=-1)
        return out._replace(
            top_k_indices=idx[:, :top_k], top_k_gates=gates, top_logits=top,
            gates=torch.zeros_like(scores).scatter(1, idx[:, :top_k], gates))

    def gate(self, gate_inp, w_gate, *, top_k, noise_std=1.0, noise=None):
        out = noisy_vmoe_gate(gate_inp, w_gate, top_k=top_k,
                              noise_std=noise_std, noise=noise)
        return self._tape(out, torch.softmax(out.noisy_logits, dim=-1),
                          top_k, False)

    def learned_gate(self, gate_inp, w_gate, w_noise, *, top_k, noise=None):
        out = noisy_gate(gate_inp, w_gate, w_noise, top_k=top_k, noise=noise)
        return self._tape(out, out.noisy_logits, top_k, True)


def expected_train_launches(depth: int, num_tasks: int,
                            ln_mlp: bool = False):
    """Launches per shared-prefix train step (vit_moe.py:1064-1091): block
    0 and block 1's attention once, the rest once per task; even blocks
    dense (K3/K4 at E=1, or K5/K6 with ln_mlp), odd blocks MoE; each
    forward launch has one backward launch.  With one task, those of one
    whole backbone pass (one K3 per block: the dense ViT's too)."""
    attn = 2 + (depth - 2) * num_tasks
    dense = 1 + ((depth + 1) // 2 - 1) * num_tasks
    moe = depth // 2 * num_tasks
    out = {"flash_attention_fwd": attn, "flash_attention_bwd": attn}
    if ln_mlp:
        out.update(expert_ffn_fwd=moe, expert_ffn_bwd=moe, ln_mlp_fwd=dense,
                   ln_mlp_bwd=dense)
    else:
        out.update(expert_ffn_fwd=dense + moe, expert_ffn_bwd=dense + moe)
    return out


def expected_serving_launches(depth: int, ln_mlp: bool = False,
                              int8: bool = False):
    """Launches per single-task backbone pass: one attention per block,
    one dense MLP per even block, one expert FFN per odd block (one K3 per
    block: the dense ViT's too)."""
    dense, moe = (depth + 1) // 2, depth // 2
    out = {"flash_attention_fwd": depth}
    if ln_mlp:
        out.update(ln_mlp_fwd=dense, expert_ffn_fwd=moe)
    elif int8:
        out.update(expert_ffn_fwd=dense, expert_ffn_q_fwd=moe)
    else:
        out.update(expert_ffn_fwd=dense + moe)
    return out


def check_launches(launches, count: int, expected, what: str):
    """Per-pass (or per-step) launches over `count` passes: exactly
    `expected`, every other kernel not at all."""
    per = {k: v / count for k, v in launches.items() if v}
    check(per == expected, f"{what}: launches per pass/step {per}, expected "
          f"{expected}")
    return per


def rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def rel_by_group(a, b):
    """Relative error of gradient dict a against b per parameter group."""
    sq = {}
    for n, ga in a.items():
        acc = sq.setdefault(param_group(n), [0.0, 0.0])
        acc[0] += (ga - b[n]).square().sum().item()
        acc[1] += b[n].square().sum().item()
    return {g: (x / y) ** 0.5 for g, (x, y) in sq.items()}


def param_grads(model):
    return {n: p.grad.detach().float().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def train_setup(dev, shared_prefix: bool = True, **knobs):
    """The flagship (seed 0, shared prefix unless asked otherwise, `knobs`
    passed to build_flagship), its B=8 synthetic batch, loss functions, a
    copy of its initial state and the random cotangent for shared-prefix
    backbone runs."""
    model, tasks = build_flagship(device=dev, seed=0,
                                  shared_prefix=shared_prefix, **knobs)
    names = [t.name for t in tasks]
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(0),
                            tasks, TRAIN_BATCH, (IMG, IMG))
    loss_fns = {n: loss_fn_for_task(n, {"edge_w": 0.95}) for n in names}
    init = {k: v.clone() for k, v in model.state_dict().items()}
    cotangent = torch.randn((len(names) * TRAIN_BATCH,) + tuple(
        model.backbone.pos_embed.shape[1:]), device=dev,
        generator=torch.Generator(device=dev).manual_seed(3))
    return model, names, batch, loss_fns, init, cotangent


def make_grad_run(dev, names, batch, loss_fns, init, cotangent):
    """run(m, kernels, tape, mode): one forward and backward of model `m`
    from the state `init` (see below)."""
    smooth_weights = {**LOSS_WEIGHTS, "normals": 0.0}

    def run(m, kernels: bool, tape=None, mode: str = "step"):
        """One forward and backward from `init` in training mode; mode
        "step" is the train step's loss, "smooth" the same without the
        normals term, "smooth_bn_running" that with the heads in eval mode
        (BatchNorm on running statistics), "backbone" the backbone alone
        under `cotangent`.
        Returns (loss, parameter grads, {"dpred": grads of the heads'
        outputs, "dfeat": grad of the backbone's output tokens, "l1_sign":
        sign of the normals L1 term per element}) ({} for "backbone")."""
        m.load_state_dict(init)
        set_use_kernels(m, kernels)
        m.train()
        if mode == "smooth_bn_running":
            for head in m.decoders.values():
                head.eval()
        m.zero_grad(set_to_none=True)
        noise = torch.Generator(device=dev).manual_seed(1)
        feats, extra, loss = [], {}, float("nan")
        hook = m.backbone.register_forward_hook(
            lambda mod, args, out: feats.append(
                out[0] if isinstance(out, tuple) else out))
        with tape or contextlib.nullcontext():
            if mode == "backbone" and isinstance(m.backbone,
                                                 VisionTransformer):
                m.backbone(batch["image"]).float().backward(cotangent)
            elif mode == "backbone":
                m.backbone(batch["image"], list(range(len(names))), noise,
                           shared_prefix=True)[0].float().backward(cotangent)
            else:
                pred, cv, _ = m(batch["image"], noise=noise)
                for v in (*pred.values(), feats[0]):
                    v.retain_grad()
                total = multi_task_loss(
                    pred, batch, names, loss_fns,
                    LOSS_WEIGHTS if mode == "step" else smooth_weights
                )["total"] + 0.01 * cv
                total.backward()
                loss = total.item()
                nrm = pred["normals"].detach()
                extra = {"dpred": {k: v.grad for k, v in pred.items()},
                         "dfeat": feats[0].grad, "l1_sign": torch.sign(
                             nrm / (nrm.norm(dim=1, keepdim=True) + 1e-12)
                             - batch["normals"])}
        hook.remove()
        return loss, param_grads(m), extra

    return run


def timed_steps(model, names, loss_fns, batch, dev, expected, what: str,
                make_step=make_train_step, loss_falls: bool = False,
                profile: bool = True, steps: int = TIMED_STEPS,
                weights=LOSS_WEIGHTS):
    """`steps` train steps (`make_step`'s, SGD) on one batch, each
    between CUDA events, with the kernels' launches counted over them and
    held to `expected` per step, and with loss_falls the loss lower after
    them than at their first; with `profile`, the device time of a step
    (torch.profiler) and the card's idle share.  Returns (the phase's
    readings, the launches)."""
    opt, schedule = build_optimizer(model.parameters(), OPTIM,
                                    steps_per_epoch=100)
    step = make_step(model, names, loss_fns, weights, opt, schedule)
    noise = torch.Generator(device=dev).manual_seed(2)
    for _ in range(2):   # warm-up
        step(batch, noise)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    _build.reset_launches()            # the train path starts here
    t_window = time.perf_counter()
    metrics = []
    for a, b in ev:
        a.record()
        metrics.append(step(batch, noise))
        b.record()
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t_window
    launches = dict(_build.launches)   # ... and ends here
    key = "loss_total_with_cv" if "loss_total_with_cv" in metrics[0] \
        else "loss_total"
    losses = [m[key].item() for m in metrics]
    m = metrics[-1]
    check(all(np.isfinite(losses)), f"{what} timed step loss {losses}")
    if loss_falls:
        check(losses[-1] < losses[0],
              f"{what}: losses over {steps} timed steps do not fall: "
              f"{losses}")
    per_step = check_launches(launches, steps, expected, what)
    B = batch["image"].shape[0]
    step_ms = [a.elapsed_time(b) for a, b in ev]
    median = float(np.median(step_ms))
    prof = {}
    if profile:
        p = device_profile(lambda: step(batch, noise))
        prof = {"device_ms_per_step": p["device_ms"],
                "device_idle_frac": 1.0 - p["device_ms"] / median,
                "top_kernels": p["top"]}
    return {"batch": B, "steps": steps,
            "step_ms_median": median, "step_ms": step_ms, **prof,
            "img_per_s": steps * B / window_s,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": per_step, "losses": losses,
            **({"moe_dropped_frac": m["moe_dropped_frac"].item()}
               if "moe_dropped_frac" in m else {})}, launches


def train_phase(dev):
    t0 = time.perf_counter()
    model, names, batch, loss_fns, init, cotangent = train_setup(dev)
    build_s = time.perf_counter() - t0

    # (a) kernels against the plain path on the same weights, batch and
    # gate noise, the plain path replaying the kernel path's routing
    # (RoutingTape): the train step (also with each path routing on its
    # own, and against an f32 plain reference), the step without the
    # normals term (its L1 gradient is a sign), that with the heads'
    # BatchNorm on running statistics, and the backbone alone under a fixed
    # random cotangent on its output tokens (the check on the gradients)
    run = make_grad_run(dev, names, batch, loss_fns, init, cotangent)

    def compare(k, p):
        """Readings of a kernel run `k` against a plain run `p`."""
        out = {"grad_rel_err": rel_by_group(k[1], p[1])}
        if k[2]:
            valid = batch["normals"] != 255
            out.update(
                backbone_output_grad_rel_err=rel(k[2]["dfeat"], p[2]["dfeat"]),
                heads_output_grad_rel_err={n: rel(k[2]["dpred"][n],
                                                  p[2]["dpred"][n])
                                           for n in names
                                           if bool(p[2]["dpred"][n].any())},
                normals_l1_sign_flip_frac=(
                    (k[2]["l1_sign"] != p[2]["l1_sign"]) & valid).sum().item()
                / valid.sum().item())
        return out

    tapes = {mode: RoutingTape() for mode in ("step", "smooth",
                                              "smooth_bn_running", "backbone")}
    kernel_runs = {mode: run(model, True, tapes[mode], mode) for mode in tapes}
    before = dict(_build.launches)
    p_own = run(model, False)
    own_routing = compare(kernel_runs["step"], p_own)
    p_loss = p_own[0]
    del p_own
    readings = {}
    for mode in ("smooth", "smooth_bn_running", "backbone", "step"):
        # "step" last: its plain run is kept for the f32 comparison
        p_run = run(model, False, tapes[mode], mode)
        readings[mode] = compare(kernel_runs[mode], p_run)
    rerouted = {"plain": tapes["step"].rerouted / tapes["step"].tokens}
    ref_model, _ = build_flagship(device=dev, seed=0, shared_prefix=True,
                                  dtype=torch.float32)
    tapes["step"].rerouted = tapes["step"].tokens = 0
    r_loss, r_grads, _ = run(ref_model, False, tapes["step"])
    rerouted["f32"] = tapes["step"].rerouted / tapes["step"].tokens
    del ref_model
    check(dict(_build.launches) == before, "plain train step launched a kernel")
    set_use_kernels(model, True)
    model.load_state_dict(init)
    k_loss = kernel_runs["step"][0]
    kr = rel_by_group(kernel_runs["step"][1], r_grads)
    pr = rel_by_group(p_run[1], r_grads)
    del kernel_runs, p_run, r_grads
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    backbone = readings["backbone"]["grad_rel_err"]
    check(np.isfinite(k_loss) and loss_rel <= TRAIN_LOSS_REL_TOL
          and all(v <= BACKBONE_GRAD_REL_TOL for v in backbone.values()),
          f"train kernel vs plain: loss {k_loss} vs {p_loss} (rel limit "
          f"{TRAIN_LOSS_REL_TOL}); backbone grad rel err under a fixed "
          f"cotangent {backbone} (limit {BACKBONE_GRAD_REL_TOL})")
    emit({"phase": "train_kernel_vs_plain", "loss_kernel": k_loss,
          "loss_plain": p_loss, "loss_rel_err": loss_rel,
          "loss_f32_replayed": r_loss, "step_own_routing": own_routing,
          "step_replayed": readings["step"],
          "step_without_normals_replayed": readings["smooth"],
          "step_without_normals_bn_running_replayed":
              readings["smooth_bn_running"],
          "backbone_cotangent_replayed": readings["backbone"],
          "step_grad_rel_err_kernel_vs_f32_replayed": kr,
          "step_grad_rel_err_plain_vs_f32_replayed": pr,
          "rerouted_token_frac": rerouted,
          "gate_calls": len(tapes["step"].tape), "model_build_s": build_s})

    # (b) steps on one fixed batch: the loss is finite and falls
    opt, schedule = build_optimizer(model.parameters(), OPTIM,
                                    steps_per_epoch=100)
    step = make_train_step(model, names, loss_fns, LOSS_WEIGHTS, opt,
                           schedule)
    noise = torch.Generator(device=dev).manual_seed(2)
    metrics = [step(batch, noise) for _ in range(TRAIN_STEPS)]
    losses = [m["loss_total_with_cv"].item() for m in metrics]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train losses over {TRAIN_STEPS} steps do not fall: {losses}")
    emit({"phase": "train_loss", "steps": TRAIN_STEPS, "losses": losses,
          "last": {k: v.item() for k, v in metrics[-1].items()}})

    # (c) timed steps, (d) kernel launches per step
    readings, launches = timed_steps(
        model, names, loss_fns, batch, dev,
        expected_train_launches(len(model.backbone.blocks), len(names)),
        "train")
    emit({"phase": "train_step", **readings})
    return launches


def int8_serving_phase(dev):
    """The int8 serving path (scripts/bench_serving.py --int8): the seeded
    flagship's expert banks quantized by the port's own quantizer, served
    uint8 in / class map out at every bucket, then held against its plain
    path and read against the float model at bucket 2."""
    t0 = time.perf_counter()
    fmodel, tasks = build_flagship(device=dev, seed=0)
    names = [t.name for t in tasks]
    qsd, q_err = quantize_expert_state_dict(fmodel.state_dict(),
                                            with_error=True)
    model, _ = build_flagship(device=dev, seed=0, expert_weights_int8=True)
    model.load_state_dict(qsd, strict=True)
    del qsd
    build_s = time.perf_counter() - t0
    kw = dict(buckets=BUCKETS, device=dev)
    raw = InferenceSession(model, names, (IMG, IMG), raw_uint8_input=True,
                           **kw)
    t0 = time.perf_counter()
    raw.warmup(tasks=["semseg"], postprocess=True)
    warmup_s = time.perf_counter() - t0

    rng = np.random.RandomState(10)
    rows, requests = [], 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()            # the int8 serving path starts here
    for b in BUCKETS:
        u8 = rng.randint(0, 256, (b, IMG, IMG, 3)).astype(np.uint8)
        rows.append({"bucket": b,
                     "uint8_post": time_requests(raw, u8, True, REQUESTS)})
        requests += REQUESTS + 1
    launches = dict(_build.launches)   # ... and ends here
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    per_pass = check_launches(
        launches, requests,
        expected_serving_launches(len(model.backbone.blocks), int8=True),
        "int8 serving")
    # the device's share of a bucket-8 request (p50 above)
    prof = device_profile(lambda: raw.predict(u8, "semseg", postprocess=True),
                          5)

    # the int8 kernel session against the int8 plain path, and against
    # the float model, at bucket 2 (f32 logits)
    sess = InferenceSession(model, names, (IMG, IMG), **kw)
    fsess = InferenceSession(fmodel, names, (IMG, IMG), **kw)
    imgs = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    k_logits = sess.predict(imgs, "semseg")
    before = dict(_build.launches)
    set_use_kernels(model, False)
    p_logits = sess.predict(imgs, "semseg")
    set_use_kernels(model, True)
    check(dict(_build.launches) == before, "int8 plain run launched a kernel")
    agree, rel_err = logit_agreement(k_logits, p_logits)
    check(agree >= AGREE_MIN and rel_err <= LOGIT_REL_TOL,
          f"int8 kernel vs plain at bucket 2: class agreement {agree}, "
          f"logit rel err {rel_err}")
    f_agree, f_rel = logit_agreement(k_logits, fsess.predict(imgs, "semseg"))
    emit({"phase": "int8_serving", "rows": rows, "model_build_s": build_s,
          "warmup_s": warmup_s, "peak_memory_mb": peak_mb,
          "bucket_8_profile": {
              "device_ms_per_request": prof["device_ms"],
              "device_idle_frac": 1.0 - prof["device_ms"] / rows[-1][
                  "uint8_post"]["p50_ms"], "top_kernels": prof["top"]},
          "launches": launches,
          "backbone_passes": requests, "per_pass": per_pass,
          "kernel_vs_plain": {"bucket": 2, "class_map_agreement": agree,
                              "logit_rel_err": rel_err},
          "int8_vs_float": {"bucket": 2, "class_map_agreement": f_agree,
                            "logit_rel_err": f_rel},
          "expert_quantization_error": q_err,
          "expert_buffer_mb": sum(
              b.numel() * b.element_size() for n, b in model.named_buffers()
              if "experts" in n) / 1e6})
    return launches


def ln_mlp_path_phase(dev):
    """The ln_mlp configuration (bench.py --ln_mlp): the flagship with the
    fused dense sublayer, served at bucket 8 with one 5-task eval and
    trained, each held against the unfused kernel model on the same
    weights.  Returns the launches of its serving and of its train path."""
    model, tasks = build_flagship(device=dev, seed=0)
    fused, _ = build_flagship(device=dev, seed=0, ln_mlp=True)
    fused.load_state_dict(model.state_dict())
    names = [t.name for t in tasks]
    depth = len(model.backbone.blocks)
    raw = InferenceSession(fused, names, (IMG, IMG), buckets=(8,),
                           raw_uint8_input=True, device=dev)
    raw.warmup(tasks=["semseg"], postprocess=True)
    rng = np.random.RandomState(11)
    u8 = rng.randint(0, 256, (8, IMG, IMG, 3)).astype(np.uint8)
    x = torch.randn(8, 3, IMG, IMG, device=dev).contiguous(
        memory_format=torch.channels_last)
    _build.reset_launches()            # the ln_mlp serving path starts here
    row = time_requests(raw, u8, True, LN_MLP_REQUESTS)
    eval_ms, out, _ = time_eval(fused, x, tasks)
    serve_launches = dict(_build.launches)   # ... and ends here
    passes = LN_MLP_REQUESTS + 1 + len(names) * (1 + EVAL_REPS)
    per_pass = check_launches(serve_launches, passes,
                              expected_serving_launches(depth, ln_mlp=True),
                              "ln_mlp serving")
    # against the unfused model: bucket 8 logits and the 5-task eval
    imgs = rng.randn(8, IMG, IMG, 3).astype(np.float32)
    agree, rel_err = logit_agreement(
        InferenceSession(fused, names, (IMG, IMG), buckets=(8,),
                         device=dev).predict(imgs, "semseg"),
        InferenceSession(model, names, (IMG, IMG), buckets=(8,),
                         device=dev).predict(imgs, "semseg"))
    with torch.inference_mode():
        ref = model(x)[0]
    eval_rel = {n: rel(out[n], ref[n]) for n in names}
    check(agree >= AGREE_MIN and rel_err <= LOGIT_REL_TOL
          and all(v <= LOGIT_REL_TOL for v in eval_rel.values()),
          f"ln_mlp vs unfused serving: bucket 8 class agreement {agree}, "
          f"logit rel err {rel_err}; 5-task eval rel err {eval_rel}")
    emit({"phase": "ln_mlp_serving", "bucket": 8, "uint8_post": row,
          "eval_5task_ms": eval_ms, "eval_img_per_s": 8 / eval_ms * 1e3,
          "launches": serve_launches, "backbone_passes": passes,
          "per_pass": per_pass,
          "vs_unfused": {"class_map_agreement": agree,
                         "logit_rel_err": rel_err,
                         "eval_5task_rel_err": eval_rel}})
    del model, fused, raw, out, ref

    # the train step against the unfused one on the same weights, batch
    # and gate noise (loss, each routing on its own), and the backbone
    # alone under a fixed cotangent with the unfused run replaying the
    # fused run's routing
    t0 = time.perf_counter()
    fused, names, batch, loss_fns, init, cotangent = train_setup(
        dev, ln_mlp=True)
    model, _ = build_flagship(device=dev, seed=0, shared_prefix=True)
    build_s = time.perf_counter() - t0
    run = make_grad_run(dev, names, batch, loss_fns, init, cotangent)
    step_tape, backbone_tape = RoutingTape(), RoutingTape()
    k_loss = run(fused, True, step_tape)[0]
    u_loss = run(model, True)[0]
    k_bb = run(fused, True, backbone_tape, "backbone")[1]
    u_bb = run(model, True, backbone_tape, "backbone")[1]
    backbone = rel_by_group(k_bb, u_bb)
    loss_rel = abs(k_loss - u_loss) / abs(u_loss)
    check(np.isfinite(k_loss) and loss_rel <= TRAIN_LOSS_REL_TOL
          and all(v <= BACKBONE_GRAD_REL_TOL for v in backbone.values()),
          f"ln_mlp vs unfused train: loss {k_loss} vs {u_loss} (rel limit "
          f"{TRAIN_LOSS_REL_TOL}); backbone grad rel err under a fixed "
          f"cotangent {backbone} (limit {BACKBONE_GRAD_REL_TOL})")
    emit({"phase": "ln_mlp_train_vs_unfused", "loss_ln_mlp": k_loss,
          "loss_unfused": u_loss, "loss_rel_err": loss_rel,
          "backbone_cotangent_replayed": {"grad_rel_err": backbone},
          "rerouted_token_frac": backbone_tape.rerouted / backbone_tape.tokens,
          "model_build_s": build_s})
    del model, k_bb, u_bb
    fused.load_state_dict(init)
    readings, train_launches = timed_steps(
        fused, names, loss_fns, batch, dev,
        expected_train_launches(depth, len(names), ln_mlp=True),
        "ln_mlp train")
    emit({"phase": "ln_mlp_train_step", **readings})
    return serve_launches, train_launches


def serving_vs_plain_and_f32(model, ref, names, imgs, what: str):
    """One request of `imgs` (bucket = its size) on `model`'s kernel and
    plain paths and on `ref`, the same weights computing in f32 on the
    plain path: logits kernel vs plain to LOGIT_REL_TOL, and the kernel
    path's class-map agreement with f32 at least the plain bf16 path's less
    F32_AGREE_SLACK."""
    def predict(m):
        return InferenceSession(m, names, imgs.shape[1:3],
                                buckets=(len(imgs),),
                                device=next(m.parameters()).device
                                ).predict(imgs, "semseg")

    k_logits = predict(model)
    set_use_kernels(model, False)
    p_logits = predict(model)
    set_use_kernels(model, True)
    set_use_kernels(ref, False)
    r_logits = predict(ref)
    agree, rel_err = logit_agreement(k_logits, p_logits)
    k32, p32 = (logit_agreement(x, r_logits)[0] for x in (k_logits,
                                                          p_logits))
    check(rel_err <= LOGIT_REL_TOL and k32 >= p32 - F32_AGREE_SLACK,
          f"{what} kernel vs plain at bucket {len(imgs)}: logit rel err "
          f"{rel_err} (limit {LOGIT_REL_TOL}); class-map agreement with f32 "
          f"{k32}, plain bf16's {p32} (slack {F32_AGREE_SLACK})")
    return {"bucket": len(imgs), "class_map_agreement": agree,
            "logit_rel_err": rel_err, "class_map_agreement_with_f32": {
                "kernel": k32, "plain": p32}}


def one_by_one_phase(dev):
    """--one_by_one (train/step.py:make_one_by_one_train_step): the
    flagship without the shared prefix and with gate noise 0.  One
    one-by-one step against one joint multi-gate step on the same weights
    and batch (replaying the joint step's routing): the loss, and every
    parameter group's gradient to BACKBONE_GRAD_REL_TOL; the same
    one-by-one step on the plain path (loss); each step's peak device
    memory, the one-by-one's lower; then timed one-by-one steps that lower
    the loss, launches counted per step."""
    t0 = time.perf_counter()
    model, names, batch, loss_fns, init, _ = train_setup(
        dev, shared_prefix=False, vmoe_noisy_std=0.0)
    build_s = time.perf_counter() - t0
    depth = len(model.backbone.blocks)
    opt, schedule = build_optimizer(model.parameters(), OPTIM,
                                    steps_per_epoch=100)
    joint = make_train_step(model, names, loss_fns, LOSS_WEIGHTS, opt,
                            schedule)
    obo = make_one_by_one_train_step(model, names, loss_fns, LOSS_WEIGHTS,
                                     opt, schedule)

    def one(step, kernels, tape):
        """One step from `init`: (loss, parameter grads)."""
        model.load_state_dict(init)
        set_use_kernels(model, kernels)
        with tape:
            m = step(batch)
        key = "loss_total_with_cv" if "loss_total_with_cv" in m \
            else "loss_total"
        return m[key].item(), param_grads(model)

    tape = RoutingTape()
    _build.reset_launches()
    j_loss, j_grads = one(joint, True, tape)
    joint_launches = dict(_build.launches)
    _build.reset_launches()
    o_loss, o_grads = one(obo, True, tape)
    obo_launches = dict(_build.launches)
    rerouted = {"one_by_one": tape.rerouted / tape.tokens}
    tape.rerouted = tape.tokens = 0
    before = dict(_build.launches)
    p_loss, p_grads = one(obo, False, tape)
    check(dict(_build.launches) == before,
          "plain one-by-one step launched a kernel")
    rerouted["one_by_one_plain"] = tape.rerouted / tape.tokens
    set_use_kernels(model, True)
    # every task's whole backbone pass, each with its backward
    expected = {k: len(names) * v for k, v in
                expected_train_launches(depth, 1).items()}
    for what, launches in (("joint", joint_launches),
                           ("one_by_one", obo_launches)):
        check_launches(launches, 1, expected, f"{what} step (no prefix)")
    vs_joint = rel_by_group(o_grads, j_grads)
    vs_plain = rel_by_group(o_grads, p_grads)
    loss_rel = abs(o_loss - j_loss) / abs(j_loss)
    plain_rel = abs(o_loss - p_loss) / abs(p_loss)
    check(np.isfinite(o_loss) and loss_rel <= TRAIN_LOSS_REL_TOL
          and plain_rel <= TRAIN_LOSS_REL_TOL
          and all(v <= BACKBONE_GRAD_REL_TOL for v in vs_joint.values()),
          f"one-by-one vs joint step: loss {o_loss} vs {j_loss}, plain "
          f"{p_loss} (rel limit {TRAIN_LOSS_REL_TOL}); grad rel err by group "
          f"{vs_joint} (limit {BACKBONE_GRAD_REL_TOL})")
    del j_grads, o_grads, p_grads

    # peak device memory of each kind of step, both after a warm-up (the
    # momentum buffers exist) and with the same weights and optimizer
    peaks = {}
    for what, step in (("one_by_one", obo), ("joint", joint)):
        model.load_state_dict(init)
        step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(batch)
        torch.cuda.synchronize()
        peaks[what] = torch.cuda.max_memory_allocated() / 1e9
    check(peaks["one_by_one"] < peaks["joint"],
          f"one-by-one peak memory {peaks['one_by_one']} GB is not below the "
          f"joint step's {peaks['joint']} GB")
    emit({"phase": "one_by_one_vs_joint", "loss_one_by_one": o_loss,
          "loss_joint": j_loss, "loss_one_by_one_plain": p_loss,
          "loss_rel_err": loss_rel, "plain_loss_rel_err": plain_rel,
          "grad_rel_err_vs_joint": vs_joint,
          "grad_rel_err_kernel_vs_plain": vs_plain,
          "rerouted_token_frac": rerouted,
          "launches_per_step": expected,
          "max_memory_allocated_gb": peaks, "model_build_s": build_s})
    model.load_state_dict(init)
    readings, launches = timed_steps(
        model, names, loss_fns, batch, dev, expected, "one_by_one",
        make_step=make_one_by_one_train_step, loss_falls=True)
    emit({"phase": "one_by_one_step", **readings})
    return launches


def accumulation_phase(dev):
    """accumulation_steps 2 (optax.MultiSteps in the JAX package): the
    train-phase flagship's B=8 batch as two micro-batches of 4 and one SGD
    step, kernel against plain on the same weights, batch and gate noise
    (the plain path replaying the kernel path's routing): each
    micro-batch's loss; on the kernel path the gradient it steps on is the
    mean of the two micro-batches' own gradients.  Then ADAM_STEPS
    optimizer steps each of Adam and AdamW (two micro-batches each) that
    lower the loss."""
    model, names, batch, loss_fns, init, _ = train_setup(dev)
    depth = len(model.backbone.blocks)
    half = TRAIN_BATCH // 2
    micro = [{k: v[i * half:(i + 1) * half] for k, v in batch.items()}
             for i in range(2)]

    def accumulate(kernels, tape=None, optim=OPTIM, steps=1):
        """`steps` optimizer steps of two micro-batches from `init`: the
        micro-batch losses and the last step's gradients."""
        model.load_state_dict(init)
        set_use_kernels(model, kernels)
        opt, schedule = build_optimizer(
            model.parameters(), {**optim, "accumulation_steps": 2},
            steps_per_epoch=100)
        step = make_train_step(model, names, loss_fns, LOSS_WEIGHTS, opt,
                               schedule, accumulation_steps=2)
        noise = torch.Generator(device=dev).manual_seed(1)
        with tape or contextlib.nullcontext():
            losses = [step(mb, noise)["loss_total_with_cv"].item()
                      for _ in range(steps) for mb in micro]
        return losses, param_grads(model)

    tape = RoutingTape()
    _build.reset_launches()
    k_losses, k_grads = accumulate(True, tape)
    launches = dict(_build.launches)
    before = dict(_build.launches)
    p_losses, p_grads = accumulate(False, tape)
    check(dict(_build.launches) == before,
          "plain accumulation launched a kernel")
    set_use_kernels(model, True)
    per_step = check_launches(
        launches, 1, {k: 2 * v for k, v in expected_train_launches(
            depth, len(names)).items()}, "accumulation (2 micro-batches)")
    def micro_batch_mean():
        """The mean of the micro-batches' own gradients, kernel path."""
        model.load_state_dict(init)
        model.train()
        noise = torch.Generator(device=dev).manual_seed(1)
        mean = {}
        for mb in micro:
            model.zero_grad(set_to_none=True)
            pred, cv, _ = model(mb["image"], noise=noise)
            (multi_task_loss(pred, mb, names, loss_fns, LOSS_WEIGHTS)[
                "total"] + 0.01 * cv).backward()
            for n, g in param_grads(model).items():
                mean[n] = mean.get(n, 0.0) + 0.5 * g
        return mean

    mean = micro_batch_mean()
    accum_rel = rel_by_group(k_grads, mean)
    run_to_run = rel_by_group(micro_batch_mean(), mean)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses)]
    check(all(np.isfinite(k_losses))
          and all(r <= TRAIN_LOSS_REL_TOL for r in loss_rel)
          and all(v <= BACKBONE_GRAD_REL_TOL for v in accum_rel.values()),
          f"accumulation: micro-batch losses {k_losses} vs plain {p_losses} "
          f"(rel limit {TRAIN_LOSS_REL_TOL}); gradient vs the mean of the "
          f"micro-batch gradients {accum_rel} (limit {BACKBONE_GRAD_REL_TOL}"
          f"; two runs of that mean differ by {run_to_run})")
    vs_plain = rel_by_group(k_grads, p_grads)
    del k_grads, p_grads, mean

    adam = {}
    for name in ("adam", "adamw"):
        optim = {**OPTIM, "optimizer": name,
                 "optimizer_kwargs": {"lr": ADAM_LR, "weight_decay": 1e-4}}
        losses = accumulate(True, optim=optim, steps=ADAM_STEPS)[0]
        per_opt_step = [(a + b) / 2 for a, b in zip(losses[::2],
                                                    losses[1::2])]
        check(all(np.isfinite(losses))
              and per_opt_step[-1] < per_opt_step[0],
              f"{name}: losses over {ADAM_STEPS} steps do not fall: "
              f"{per_opt_step}")
        adam[name] = per_opt_step
    emit({"phase": "accumulation", "micro_batch": half,
          "accumulation_steps": 2, "losses_kernel": k_losses,
          "losses_plain": p_losses, "loss_rel_err": loss_rel,
          "grad_rel_err_vs_micro_batch_mean": accum_rel,
          "micro_batch_mean_run_to_run_rel_err": run_to_run,
          "grad_rel_err_kernel_vs_plain_replayed": vs_plain,
          "rerouted_token_frac": tape.rerouted / tape.tokens,
          "launches": launches, "launches_per_step": per_step,
          "adam_lr": ADAM_LR, "losses_per_optimizer_step": adam})
    return launches


def noisy_gate_phase(dev):
    """moe_gate_type "noisy" (the learned-noise gate): the train-phase
    flagship with it, a train step kernel against plain on the same
    weights, batch and [T, E] normals (the loss; the plain path replaying
    the kernel path's routing, the backbone alone under a fixed cotangent
    to BACKBONE_GRAD_REL_TOL), timed steps that lower the loss, and a
    bucket-8 request held against the plain path."""
    t0 = time.perf_counter()
    model, names, batch, loss_fns, init, cotangent = train_setup(
        dev, moe_gate_type="noisy")
    build_s = time.perf_counter() - t0
    depth = len(model.backbone.blocks)
    run = make_grad_run(dev, names, batch, loss_fns, init, cotangent)
    step_tape, backbone_tape = RoutingTape(), RoutingTape()
    before = dict(_build.launches)
    k_loss = run(model, True, step_tape)[0]
    k_bb = run(model, True, backbone_tape, "backbone")[1]
    mid = dict(_build.launches)
    p_loss = run(model, False, step_tape)[0]
    p_bb = run(model, False, backbone_tape, "backbone")[1]
    check(dict(_build.launches) == mid and mid != before,
          "noisy gate: the plain runs launched a kernel, or the kernel runs "
          "none")
    backbone = rel_by_group(k_bb, p_bb)
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    check(np.isfinite(k_loss) and loss_rel <= TRAIN_LOSS_REL_TOL
          and all(v <= BACKBONE_GRAD_REL_TOL for v in backbone.values()),
          f"noisy gate train kernel vs plain: loss {k_loss} vs {p_loss} (rel "
          f"limit {TRAIN_LOSS_REL_TOL}); backbone grad rel err under a fixed "
          f"cotangent {backbone} (limit {BACKBONE_GRAD_REL_TOL})")
    del k_bb, p_bb
    set_use_kernels(model, True)
    model.load_state_dict(init)
    readings, launches = timed_steps(
        model, names, loss_fns, batch, dev,
        expected_train_launches(depth, len(names)), "noisy gate train",
        loss_falls=True)

    # a bucket-8 request, kernel against plain, on the trained weights
    model.eval()
    ref, _ = build_flagship(device=dev, seed=0, moe_gate_type="noisy",
                            dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    serving = serving_vs_plain_and_f32(
        model, ref, names,
        np.random.RandomState(13).randn(8, IMG, IMG, 3).astype(np.float32),
        "noisy gate")
    del ref
    emit({"phase": "noisy_gate", "loss_kernel": k_loss, "loss_plain": p_loss,
          "loss_rel_err": loss_rel,
          "backbone_cotangent_replayed": {"grad_rel_err": backbone},
          "rerouted_token_frac": backbone_tape.rerouted / backbone_tape.tokens,
          "train_step": readings,
          "serving_kernel_vs_plain": serving, "model_build_s": build_s})
    return launches


def dense_phase(dev):
    """The dense ViT-small multi-task model that build_model makes from
    configs/pascal/vit_small_dense_multi_task.yml (DENSE_CONFIG): uint8
    requests at bucket 8 (launches counted per pass), a bucket-8 request
    kernel against plain, a train step kernel against plain (the loss; the
    backbone alone under a fixed cotangent to BACKBONE_GRAD_REL_TOL) and
    timed steps that lower the loss, launches counted per step.  Returns
    the launches of its serving and of its train path."""
    t0 = time.perf_counter()
    model, tasks = build_model(DENSE_CONFIG, device=dev, seed=0)
    build_s = time.perf_counter() - t0
    names = [t.name for t in tasks]
    depth = len(model.backbone.blocks)
    raw = InferenceSession(model, names, (IMG, IMG), buckets=(8,),
                           raw_uint8_input=True, device=dev)
    raw.warmup(tasks=["semseg"], postprocess=True)
    rng = np.random.RandomState(14)
    u8 = rng.randint(0, 256, (8, IMG, IMG, 3)).astype(np.uint8)
    _build.reset_launches()            # the dense serving path starts here
    row = time_requests(raw, u8, True, DENSE_REQUESTS)
    serve_launches = dict(_build.launches)   # ... and ends here
    serve_per_pass = check_launches(
        serve_launches, DENSE_REQUESTS + 1,
        expected_serving_launches(depth), "dense serving")
    ref, _ = build_model({**DENSE_CONFIG, "compute_dtype": "float32"},
                         device=dev, seed=0)
    serving = serving_vs_plain_and_f32(
        model, ref, names, rng.randn(8, IMG, IMG, 3).astype(np.float32),
        "dense")
    del ref

    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(0),
                            tasks, TRAIN_BATCH, (IMG, IMG))
    loss_fns = build_loss_fns(DENSE_CONFIG)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    cotangent = torch.randn((TRAIN_BATCH,) + tuple(
        model.backbone.pos_embed.shape[1:]), device=dev,
        generator=torch.Generator(device=dev).manual_seed(3))
    run = make_grad_run(dev, names, batch, loss_fns, init, cotangent)
    k_loss = run(model, True)[0]
    k_bb = run(model, True, None, "backbone")[1]
    before = dict(_build.launches)
    p_loss = run(model, False)[0]
    p_bb = run(model, False, None, "backbone")[1]
    check(dict(_build.launches) == before,
          "dense plain runs launched a kernel")
    backbone = rel_by_group(k_bb, p_bb)
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    check(np.isfinite(k_loss) and loss_rel <= TRAIN_LOSS_REL_TOL
          and all(v <= BACKBONE_GRAD_REL_TOL for v in backbone.values()),
          f"dense train kernel vs plain: loss {k_loss} vs {p_loss} (rel limit "
          f"{TRAIN_LOSS_REL_TOL}); backbone grad rel err under a fixed "
          f"cotangent {backbone} (limit {BACKBONE_GRAD_REL_TOL})")
    del k_bb, p_bb
    set_use_kernels(model, True)
    model.load_state_dict(init)
    readings, train_launches = timed_steps(
        model, names, loss_fns, batch, dev,
        expected_train_launches(depth, 1), "dense train", loss_falls=True)
    emit({"phase": "dense", "config": "configs/pascal/"
          "vit_small_dense_multi_task.yml", "model_build_s": build_s,
          "params": sum(p.numel() for p in model.parameters()),
          "serving": {"bucket": 8, "uint8_post": row,
                      "launches_per_pass": serve_per_pass,
                      "kernel_vs_plain": serving},
          "train_kernel_vs_plain": {
              "loss_kernel": k_loss, "loss_plain": p_loss,
              "loss_rel_err": loss_rel,
              "backbone_cotangent": {"grad_rel_err": backbone}},
          "train_step": readings})
    return serve_launches, train_launches


def eval_nodrop_phase(dev):
    """The flagship's 5-task eval step with stats (train/step.py:
    make_eval_step) at eval capacity factor "nodrop" (K3 at every token's
    capacity) through the eval's no-drop guard (_DropGuard): 0 drops,
    launches counted per task pass, the outputs against the plain path;
    then the dropped fraction of the same eval at cf 2.0 (read, not
    guarded)."""
    model, tasks = build_flagship(
        device=dev, seed=0, eval_capacity_factor=parse_capacity_factor(
            "nodrop"))
    names = [t.name for t in tasks]
    depth = len(model.backbone.blocks)
    x = torch.randn(8, 3, IMG, IMG, device=dev, generator=torch.Generator(
        device=dev).manual_seed(12)).contiguous(
            memory_format=torch.channels_last)
    batch = {"image": x}
    step = make_eval_step(model, names, with_stats=True)
    step(batch)
    guard = _DropGuard({})
    torch.cuda.synchronize()
    _build.reset_launches()            # the eval path starts here
    t0 = time.perf_counter()
    for _ in range(EVAL_REPS):
        pred, stats = step(batch)
        guard.update(stats)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) / EVAL_REPS * 1e3
    launches = dict(_build.launches)   # ... and ends here
    per_pass = check_launches(launches, len(names) * EVAL_REPS,
                              expected_serving_launches(depth),
                              "eval nodrop")
    guard.check()                      # raises if any slot was dropped
    dropped = float(guard.total)
    check(dropped == 0.0 and all(
        pred[t.name].shape == (8, t.num_output, IMG, IMG)
        and bool(torch.isfinite(pred[t.name]).all()) for t in tasks),
          f"eval nodrop: dropped {dropped}, outputs "
          f"{ {n: tuple(v.shape) for n, v in pred.items()} }")
    set_use_kernels(model, False)
    plain, _ = step(batch)
    set_use_kernels(model, True)
    eval_rel = {n: rel(pred[n], plain[n]) for n in names}
    check(all(v <= LOGIT_REL_TOL for v in eval_rel.values()),
          f"eval nodrop kernel vs plain: rel err {eval_rel} (limit "
          f"{LOGIT_REL_TOL})")
    for m in model.modules():
        if isinstance(m, vit_moe.MoEMlp):
            m.eval_capacity_factor = 2.0
    _, st2 = step(batch)
    T = 8 * model.backbone.pos_embed.shape[1]
    emit({"phase": "eval_nodrop", "batch": 8, "ms": eval_ms,
          "img_per_s": 8 / eval_ms * 1e3,
          "capacity": compute_capacity(T, 4, 16, parse_capacity_factor(
              "nodrop")),
          "dropped_slot_fraction_sum": dropped,
          "launches": launches, "task_passes": len(names) * EVAL_REPS,
          "per_pass": per_pass, "kernel_vs_plain_rel_err": eval_rel,
          "gate_entropy_mean": (stats["gate_entropy_sum"]
                                / stats["gate_token_count"]).item(),
          "cf_2_dropped_slot_fraction": (st2["dropped_slot_fraction"]
                                         / st2["moe_stat_count"]).item(),
          "cf_2_capacity": compute_capacity(T, 4, 16, 2.0)})
    return launches


# the cli phase: a fabricated PASCAL-Context tree of CLI_IMAGES images at
# PASCAL-Context's usual 375 x 500, the headline config at full width
CLI_CONFIG = "configs/pascal/vit_moe_small_multi_task.yml"
CLI_IMAGES, CLI_HW, CLI_BATCH = 64, (375, 500), 8
CLI_EVAL_REL_TOL = 1e-5      # --eval against the results of run 2's eval
CLI_PHASE_LIMIT_S = 150.0


def expected_cli_launches(steps: int, eval_batches: int,
                          remat: bool = True, ln_mlp: bool = False):
    """Launches of `steps` joint train steps of a 12-block, 5-task MoE
    model without the shared prefix (12 K1-K4 each per task pass; with
    ln_mlp the 6 dense blocks' K3/K4 are K5/K6) and `eval_batches` no-drop
    eval batches (one forward launch a block and task pass); kernels
    launched 0 times left out.  With remat (the headline config's
    use_checkpointing) the backward runs every block's forward again: one
    more forward launch a block and task pass."""
    per = expected_train_launches(12, 1, ln_mlp)
    out = {k: 5 * v * steps for k, v in per.items()}
    fwd = expected_serving_launches(12, ln_mlp)
    for k, v in fwd.items():
        out[k] += v * 5 * (eval_batches + (steps if remat else 0))
    return {k: v for k, v in out.items() if v}


def _leaves(d, prefix=""):
    """(path, number) of every numeric leaf of a results dict."""
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(d, (list, tuple)):
        for i, v in enumerate(d):
            yield from _leaves(v, f"{prefix}/{i}")
    elif isinstance(d, (int, float)):
        yield prefix, float(d)


def _summary(result):
    """A CLI run's result without its per-class lists and step times."""
    if isinstance(result, dict):
        return {k: _summary(v) for k, v in result.items()
                if k != "step_times" and not isinstance(v, list)}
    return result


def cli_phase(dev, root: str):
    """The trainer CLI (python -m m3vit_tpu_torch.cli.train) on a PASCAL_MT
    tree made by scripts/fabricate_dataset.py under `root`, with the
    headline config (greedy edge matcher, 5 thresholds; its
    use_checkpointing rematerialises the blocks): the worker loader alone
    (its first batches against in-process loading, bit for bit), then four
    in-process runs, launches counted over each: 11 steps stopped by
    --stop_after_steps, --resume (the 5 steps left, one eval, the best
    and epoch-1 checkpoints), --eval (run 2's results) and --eval
    --save_predictions (files, edge odsF); the epoch-1 checkpoint loaded
    into a fresh model and optimizer; the CLI's ms per step beside run 1's
    own train step (analysis metrics on, as the CLI builds it) timed on a
    synthetic batch.  Leaves root/env.yml and root/config.yml (the headline
    config as run) for the recipe phase."""
    import yaml

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    log_path = os.path.join(root, "cli.log")
    try:
        db = os.path.join(root, "PASCAL_MT")
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]); "
             "from fabricate_dataset import fabricate_pascal; "
             "fabricate_pascal(sys.argv[2], int(sys.argv[3]), "
             "(int(sys.argv[4]), int(sys.argv[5])))",
             os.path.join(here, "scripts"), db, str(CLI_IMAGES),
             *map(str, CLI_HW)], check=True, timeout=300)
        fabricate_s = time.perf_counter() - t0
        env = os.path.join(root, "env.yml")
        cfg = os.path.join(root, "config.yml")
        with open(env, "w") as f:
            yaml.safe_dump({"root_dir": os.path.join(root, "runs"),
                            "dataset_roots": {"PASCAL_MT": db}}, f)
        with open(os.path.join(here, CLI_CONFIG)) as f:
            exp = yaml.safe_load(f)
        exp.update(edge_odsF_matcher="greedy", edge_odsF_thresholds=5)
        with open(cfg, "w") as f:
            yaml.safe_dump(exp, f)
        p = create_config(env, cfg, {"moe_eval_capacity_factor":
                                     parse_capacity_factor("nodrop")})

        # the loader alone, the card idle: two batches in-process, then one
        # epoch with the config's workers (started by the epoch)
        tr, _ = get_transformations(p)
        ds = get_dataset(p, "train", None)
        ref = EpochLoader(ds, tr, CLI_BATCH, seed=0, num_workers=0)
        t0 = time.perf_counter()
        first = list(itertools.islice(ref.epoch(0), 2))
        in_process_s = (time.perf_counter() - t0) / (2 * CLI_BATCH)
        loader = EpochLoader(ds, tr, CLI_BATCH, seed=0,
                             num_workers=int(p["nworkers"]), pin_memory=True)
        got, arrivals = [], []
        t0 = time.perf_counter()
        for i, b in enumerate(loader.epoch(0)):
            arrivals.append(time.perf_counter() - t0)
            if i < 2:
                got.append(b)
        loader.close()
        same = all(
            a["meta"] == b["meta"] and a.keys() == b.keys()
            and all(torch.equal(a[k], b[k]) for k in a if k != "meta")
            for a, b in zip(first, got))
        check(len(got) == 2 and same,
              "cli: the worker loader's first two batches differ from "
              "in-process loading")
        n_img = len(arrivals) * CLI_BATCH
        emit({"phase": "cli_loader", "workers": int(p["nworkers"]),
              "images": n_img, "batch": CLI_BATCH, "image_hw": CLI_HW,
              "epoch_s": arrivals[-1], "first_batch_s": arrivals[0],
              "img_per_s": n_img / arrivals[-1],
              "img_per_s_after_first_batch":
                  (n_img - CLI_BATCH) / (arrivals[-1] - arrivals[0]),
              "in_process_s_per_sample": in_process_s,
              "first_batches_bitwise_equal": same,
              "fabricate_s": fabricate_s})

        base = ["--config_env", env, "--config_exp", cfg,
                "--trBatch", str(CLI_BATCH), "--valBatch", str(CLI_BATCH),
                "--epochs", "2", "--moe_eval_capacity_factor", "nodrop"]
        spe = CLI_IMAGES // CLI_BATCH
        val_batches = CLI_IMAGES // CLI_BATCH
        runs, launches = {}, {}
        with open(log_path, "w") as log, contextlib.redirect_stdout(log):
            for name, extra in (("stop", ["--stop_after_steps", "11"]),
                                ("resume", ["--resume"]),
                                ("eval", ["--eval"]),
                                ("save_predictions",
                                 ["--eval", "--save_predictions"])):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _build.reset_launches()    # the cli path starts here
                runs[name] = cli_main(base + extra)
                torch.cuda.synchronize()
                launches[name] = dict(_build.launches)   # ... and ends here
                runs[name]["seconds"] = time.perf_counter() - t0
                if runs[name]["step_times"]:
                    runs[name]["first_step_s"] = \
                        runs[name]["step_times"][0][1] - t0
        r1, r2, r3, r4 = (runs[k] for k in ("stop", "resume", "eval",
                                            "save_predictions"))
        step_dir = os.path.join(p["output_dir"], "step_checkpoint")
        with open(os.path.join(step_dir, "meta_11.json")) as f:
            step_meta = json.load(f)
        check(r1.get("stopped_at_step") == 11 and r1["steps_run"] == 11
              and step_meta["epoch"] == 1 and step_meta["next_it"] == 3,
              f"cli run 1: stopped at {r1.get('stopped_at_step')} after "
              f"{r1['steps_run']} steps, step checkpoint {step_meta}")
        check(r2["steps_run"] == 2 * spe - 11 and r2.get("best") is not None
              and os.path.exists(os.path.join(p["best_model_dir"], "1.pt"))
              and os.path.exists(os.path.join(p["checkpoint_dir"], "1.pt")),
              f"cli run 2 (--resume): {r2['steps_run']} steps, best "
              f"{r2.get('best') is not None}, checkpoints "
              f"{os.listdir(p['checkpoint_dir'])}")
        per = {}
        for name, (S, V) in (("stop", (11, 0)), ("resume", (2 * spe - 11,
                                                            val_batches)),
                             ("eval", (0, val_batches)),
                             ("save_predictions", (0, val_batches))):
            per[name] = check_launches(launches[name], 1,
                                       expected_cli_launches(S, V),
                                       f"cli run {name}")
        # run 3 against run 2's eval, and the eval forward twice
        ref_leaves = dict(_leaves(r2["best"]))
        got_leaves = dict(_leaves({k: r3[k] for k in r2["best"]}))
        eval_rel = max(abs(got_leaves[k] - v) / max(abs(v), 1e-12)
                       for k, v in ref_leaves.items())
        check(got_leaves.keys() == ref_leaves.keys()
              and eval_rel <= CLI_EVAL_REL_TOL,
              f"cli --eval vs run 2's results: max rel diff {eval_rel} "
              f"(limit {CLI_EVAL_REL_TOL})")
        model3 = r3["state"]["model"]
        names = list(p["TASK_NAMES"])
        vb = next(iter(EpochLoader(get_dataset(p, "val", None),
                                   get_transformations(p)[1], CLI_BATCH,
                                   shuffle=False, drop_last=False).epoch(0)))
        step = make_eval_step(model3, names, with_stats=True)
        x = vb["image"].to(dev)
        e1, e2 = step({"image": x})[0], step({"image": x})[0]
        eval_bitwise = all(torch.equal(e1[n], e2[n]) for n in names)
        check(eval_bitwise, "cli: the eval forward differs between two runs")
        ods = (r4.get("edge") or {}).get("odsF")
        finite = all(np.isfinite(v) for k, v in _leaves(
            {n: r4.get(n) for n in names}))
        check(all(n in r4 for n in names) and finite and ods is not None
              and native.native_available()
              and os.path.realpath(native.lib_path()).startswith(
                  os.path.realpath(os.path.join(here, "m3vit_tpu_torch",
                                                "_build"))),
              f"cli --eval --save_predictions: tasks {sorted(r4)}, finite "
              f"{finite}, odsF {ods}, native library "
              f"{native.native_available()} at {native.lib_path()}")

        # the epoch-1 checkpoint into a fresh model and optimizer
        fresh, _ = build_model(p, device=dev, seed=1)
        fresh_opt, _ = build_optimizer(fresh.parameters(), p, spe)
        restore_checkpoint(p["checkpoint_dir"], fresh, fresh_opt, index=1)
        m2, o2 = r2["state"]["model"], r2["state"]["optimizer"]
        sd_ok = all(torch.equal(v, fresh.state_dict()[k])
                    for k, v in m2.state_dict().items())
        o_ref, o_got = o2.state_dict(), fresh_opt.state_dict()
        opt_ok = o_ref["param_groups"] == o_got["param_groups"] and all(
            torch.equal(v, o_got["state"][i][k])
            for i, st in o_ref["state"].items() for k, v in st.items())
        check(sd_ok and opt_ok, f"cli checkpoint round trip: model "
              f"{sd_ok}, optimizer {opt_ok}")
        del fresh, fresh_opt, m2, o2, model3, e1, e2
        cli_model = r1["state"]["model"]
        cli_step = r1["state"]["train_step"]
        for r in runs.values():
            r.pop("state")

        # the CLI's ms per step: between consecutive steps' returns within
        # an epoch, after the first two steps
        t = dict(r1["step_times"])
        gaps = {s: (t[s] - t[s - 1]) * 1e3 for s in t
                if s - 1 in t and (s - 1) % spe and s > 2}
        epoch1 = [gaps[s] for s in gaps if s > spe]
        cli_ms = float(np.median(list(gaps.values())))
        # run 1's own train step (the CLI's, on its model) on a synthetic
        # batch
        batch = synthetic_batch(torch.Generator(device=dev).manual_seed(0),
                                p["TASKS"], CLI_BATCH, (IMG, IMG))
        readings, synth_launches = timed_steps(
            cli_model, names, None, batch, dev, expected_cli_launches(1, 0),
            "cli step on a synthetic batch",
            make_step=lambda *_: cli_step, profile=False)
        del cli_model, cli_step, batch
        phase_s = time.perf_counter() - t_phase
        check(phase_s < CLI_PHASE_LIMIT_S,
              f"cli phase took {phase_s:.1f} s (limit {CLI_PHASE_LIMIT_S})")
        emit({"phase": "cli", "runs": {k: _summary(r)
                                       for k, r in runs.items()},
              "launches": launches, "launches_expected_equal": per,
              "step_checkpoint_meta": step_meta,
              "eval_vs_run2_max_rel": eval_rel,
              "eval_forward_bitwise_twice": eval_bitwise,
              "checkpoint_roundtrip_bitwise": sd_ok and opt_ok,
              "cli_ms_per_step_median": cli_ms,
              "cli_img_per_s": CLI_BATCH / cli_ms * 1e3,
              "cli_step_gaps_ms": gaps, "cli_epoch1_gaps_ms": epoch1,
              "synthetic_step": readings,
              "phase_s": phase_s})
    except BaseException:
        if os.path.exists(log_path):
            with open(log_path) as f:
                print(f.read()[-6000:], file=sys.stderr)
        raise
    total = {}
    for ln in launches.values():
        for k, v in ln.items():
            total[k] = total.get(k, 0) + v
    return total, synth_launches


# the recipe phase: the paper's training recipe through the CLI on the cli
# phase's tree, a DeiT-small-format checkpoint fabricated from a seed
DEIT_CONFIG = "configs/pascal/vit/pup_vit_small_deit_multi_task_baseline.yml"
DROP_CONFIG = ("configs/nyud/vit_moe/pup_moe_vit_small_multi_task_baseline_"
               "drop0.1_droppath0.1.yml")
RECIPE_PHASE_LIMIT_S = 150.0
RECIPE_STEPS = 2           # CLI train steps of runs A and B


def write_deit_checkpoint(path: str, depth: int = 12, embed: int = 384,
                          hidden: int = 1536, classes: int = 1000):
    """A DeiT-small checkpoint in timm's names and shapes (cls token,
    pos_embed [1, 197, 384], 12 blocks, fc1 [1536, 384], a 1000-class
    head) of seeded normals, saved as {"model": state dict}; returns it."""
    gen = torch.Generator().manual_seed(11)

    def a(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    sd = {"cls_token": a(1, 1, embed), "pos_embed": a(1, 197, embed),
          "patch_embed.proj.weight": a(embed, 3, 16, 16),
          "patch_embed.proj.bias": a(embed), "norm.weight": a(embed),
          "norm.bias": a(embed), "head.weight": a(classes, embed),
          "head.bias": a(classes)}
    for i in range(depth):
        for n, shape in (("norm1", (embed,)), ("norm2", (embed,)),
                         ("attn.qkv", (3 * embed, embed)),
                         ("attn.proj", (embed, embed)),
                         ("mlp.fc1", (hidden, embed)),
                         ("mlp.fc2", (embed, hidden))):
            sd[f"blocks.{i}.{n}.weight"] = a(*shape)
            sd[f"blocks.{i}.{n}.bias"] = a(shape[0])
    torch.save({"model": sd}, path)
    return sd


def split_upcycle(sd, i: int, experts: int, hidden: int, scale: float):
    """Block i's split-mode expert banks from a DeiT state dict, computed
    here from its own slicing: expert e holds dense-hidden chunk e % G of
    fc1 (rows) and fc2 (columns), weights and fc1's bias times `scale`."""
    fc1, b1 = sd[f"blocks.{i}.mlp.fc1.weight"], sd[f"blocks.{i}.mlp.fc1.bias"]
    fc2, b2 = sd[f"blocks.{i}.mlp.fc2.weight"], sd[f"blocks.{i}.mlp.fc2.bias"]
    G = fc1.shape[0] // hidden
    chunk = [slice((e % G) * hidden, (e % G + 1) * hidden)
             for e in range(experts)]
    return {"htoh4.weight": torch.stack([fc1[c] * scale for c in chunk]),
            "htoh4.bias": torch.stack([b1[c] * scale for c in chunk]),
            "h4toh.weight": torch.stack([fc2[:, c] * scale for c in chunk]),
            "h4toh.bias": b2[None].expand(experts, -1)}


def grads_with_and_without_remat(model, names, loss_fns, weights, batch,
                                 dev):
    """Forwards and backwards of `model` from its current state on `batch`,
    the same generator seed for the masks and gate noise each time: the
    train step's loss with use_checkpointing on, off, and off again
    ((loss, parameter gradients) each; the last pair's difference is the
    floor the heads' atomic upsampling backward sets), then the backbone
    alone (an MoE backbone routing for task 0, gate noise drawn from the
    same seed) under a fixed random cotangent on its output tokens, on and
    off (its parameter gradients each)."""
    init = {k: v.clone() for k, v in model.state_dict().items()}
    steps, alone = [], []
    for remat in (True, False, False):
        model.load_state_dict(init)
        model.backbone.use_checkpointing = remat
        model.zero_grad(set_to_none=True)
        model.train()
        noise = torch.Generator(device=dev).manual_seed(4)
        pred, cv, _ = model(batch["image"], noise=noise)
        total = multi_task_loss(pred, batch, names, loss_fns,
                                weights)["total"] + 0.01 * cv
        total.backward()
        steps.append((total.detach().clone(), param_grads(model)))
    cotangent = None
    for remat in (True, False):
        model.load_state_dict(init)
        model.backbone.use_checkpointing = remat
        model.zero_grad(set_to_none=True)
        tokens = model.backbone(batch["image"], 0, torch.Generator(
            device=dev).manual_seed(4))
        if isinstance(tokens, tuple):      # the MoE backbone's (tokens, cv,
            tokens = tokens[0]             # stats)
        if cotangent is None:
            cotangent = torch.randn(tokens.shape, device=dev,
                                    generator=torch.Generator(
                                        device=dev).manual_seed(3))
        tokens.float().backward(cotangent)
        alone.append(param_grads(model))
    model.load_state_dict(init)
    model.backbone.use_checkpointing = True
    return steps, alone


def check_remat(readings, what: str):
    """Checks grads_with_and_without_remat's readings: the loss bit for
    bit, each backbone parameter group's gradient within
    BACKBONE_GRAD_REL_TOL (the heads' upsampling backward adds with
    atomics: two steps without remat differ too, reported), and the
    backbone alone bit for bit; returns them for the phase's line."""
    steps, alone = readings
    (loss_r, g_r), (loss_n, g_n), (_, g_n2) = steps
    by_group = rel_by_group(g_r, g_n)
    groups = {g: v for g, v in by_group.items() if g not in ("heads", "tam")}
    alone_bitwise = alone[0].keys() == alone[1].keys() and all(
        torch.equal(v, alone[1][k]) for k, v in alone[0].items())
    check(torch.equal(loss_r, loss_n)
          and max(groups.values()) <= BACKBONE_GRAD_REL_TOL and alone_bitwise,
          f"{what}, remat against none: loss {loss_r.item()} / "
          f"{loss_n.item()}, backbone gradients {groups}, the backbone "
          f"alone bitwise {alone_bitwise}")
    return {"loss_bitwise": torch.equal(loss_r, loss_n),
            "backbone_grad_rel": groups,
            "no_remat_twice_grad_rel": rel_by_group(g_n2, g_n),
            "backbone_alone_grads_bitwise": alone_bitwise,
            "heads_and_tam_grad_rel": {g: v for g, v in by_group.items()
                                       if g in ("heads", "tam")}}


def recipe_phase(dev, root: str):
    """The paper's training recipe through the CLI, at full width, on the
    cli phase's tree and headline config (root/env.yml, root/config.yml):
    - run A: the headline config with --pretrained (a DeiT-small-format
      file written here) --use_weight_scaling, RECIPE_STEPS steps: right
      after the load, every expert bank is the split-mode upcycle (G = 4,
      E = 16, scale sqrt(E G^2 / K) = 4) of the file bit for bit and
      pos_embed kept its initial values; K1-K4 launched exactly (remat);
      its train step's peak memory and ms with use_checkpointing on and off;
      remat against none as in run B below (gate noise drawn from one seed
      both times, so routing repeats);
    - run B: DEIT_CONFIG (dense ViT-small, five tasks, TAM level 0, remat,
      512^2, B=8) with --pretrained --pos_emb_from_pretrained: launches,
      finite tam_level0 losses, step ms and peak memory; one step with
      remat and one without on the same weights, batch and masks
      (check_remat): the loss bit for bit, each backbone parameter group's
      gradient within BACKBONE_GRAD_REL_TOL, and the backbone alone under a
      fixed cotangent: its gradients bit for bit;
    - the round trip: run A's model saved as 2 rank shards, loaded by
      --ref_ckpt ... --eval (a synthetic eval batch): the state dict bit
      for bit, and the eval forward bitwise run A's own;
    - the dropout step: DROP_CONFIG at full width (480 x 640, B=2,
      multi-gate, E=16, K=2, expert hidden 768, TAM, remat) on a synthetic
      batch: K1/K2 exactly per train step and K3/K4 not at all (the JAX
      package's rule: no FFN kernel under dropout), K1/K3 in eval as
      usual, the same loss bits from the same seed twice, step ms."""
    import yaml

    from m3vit_tpu_torch.cli import train as cli_mod
    from m3vit_tpu_torch.utils.torch_interop import (
        save_reference_sharded_checkpoint,
    )

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    env, cfg_a = (os.path.join(root, n) for n in ("env.yml", "config.yml"))
    p_a = create_config(env, cfg_a)
    kw = p_a["backbone_kwargs"]
    deit_path = os.path.join(root, "deit_small.pth")
    deit = write_deit_checkpoint(
        deit_path, int(kw["depth"]), int(kw["embed_dim"]),
        int(kw["embed_dim"] * kw["mlp_ratio"]))
    log_path = os.path.join(root, "recipe.log")
    paths = {}
    base = ["--config_env", env, "--trBatch", str(CLI_BATCH), "--valBatch",
            str(CLI_BATCH), "--epochs", "1", "--moe_eval_capacity_factor",
            "nodrop", "--stop_after_steps", str(RECIPE_STEPS)]

    # run A, the banks read right after the load
    loaded = {}
    load = cli_mod.load_pretrained_backbone

    def load_and_read(model, *args, **kw):
        before = model.backbone.pos_embed.detach().clone()
        missing = load(model, *args, **kw)
        loaded["pos_embed_kept"] = torch.equal(
            before, model.backbone.pos_embed.detach())
        loaded["banks"] = {k: v.detach().clone()
                           for k, v in model.state_dict().items()
                           if ".mlp.experts." in k}
        loaded["missing"] = len(missing)
        return missing

    try:
        cli_mod.load_pretrained_backbone = load_and_read
        with open(log_path, "w") as log, contextlib.redirect_stdout(log):
            _build.reset_launches()        # the run A path starts here
            run_a = cli_main(base + ["--config_exp", cfg_a, "--run_name",
                                     "recipe_a", "--pretrained", deit_path,
                                     "--use_weight_scaling"])
            torch.cuda.synchronize()
            paths["recipe_moe"] = dict(_build.launches)   # ... ends here
        cli_mod.load_pretrained_backbone = load
        names_a = list(p_a["TASK_NAMES"])
        model_a = run_a["state"]["model"]
        moe = model_a.backbone.blocks[1].mlp
        E, K, hidden = (moe.num_experts, moe.top_k,
                        moe.experts.htoh4.weight.shape[1])
        G = deit["blocks.1.mlp.fc1.weight"].shape[0] // hidden
        banks_ok = True
        for i in range(1, len(model_a.backbone.blocks), 2):
            ref = split_upcycle(deit, i, E, hidden,
                                (E // G * G * G / K) ** 0.5)
            for k, v in ref.items():
                got = loaded["banks"][f"backbone.blocks.{i}.mlp.experts.{k}"]
                banks_ok &= torch.equal(got.cpu(), v)
        check(banks_ok and loaded["pos_embed_kept"],
              f"recipe run A: expert banks the file's split upcycle "
              f"{banks_ok}, pos_embed kept {loaded['pos_embed_kept']}")
        check(run_a.get("stopped_at_step") == RECIPE_STEPS,
              f"recipe run A stopped at {run_a.get('stopped_at_step')}")
        launches_a = check_launches(
            paths["recipe_moe"], 1, expected_cli_launches(RECIPE_STEPS, 0),
            "recipe run A")
        batch = synthetic_batch(torch.Generator(device=dev).manual_seed(0),
                                p_a["TASKS"], CLI_BATCH, (IMG, IMG))
        step_a = run_a["state"]["train_step"]
        memory_a = {}
        for remat in (True, False):
            model_a.backbone.use_checkpointing = remat
            memory_a["remat" if remat else "no_remat"] = timed_steps(
                model_a, names_a, None, batch, dev,
                expected_cli_launches(1, 0, remat=remat),
                f"recipe run A step, use_checkpointing {remat}",
                make_step=lambda *_: step_a, profile=False)[0]
        remat_a = check_remat(grads_with_and_without_remat(
            model_a, names_a, build_loss_fns(p_a),
            p_a["loss_kwargs"]["loss_weights"], batch, dev), "recipe run A")

        # the round trip through rank shards and --ref_ckpt --eval
        shards = os.path.join(root, "ref_a")
        save_reference_sharded_checkpoint(model_a.state_dict(), shards, 2,
                                          extra={"epoch": 0})
        with open(log_path, "a") as log, contextlib.redirect_stdout(log):
            run_rt = cli_main(["--config_env", env, "--config_exp", cfg_a,
                               "--run_name", "recipe_rt", "--ref_ckpt",
                               shards, "--eval", "--synthetic", "1",
                               "--valBatch", str(CLI_BATCH),
                               "--moe_eval_capacity_factor", "nodrop"])
        model_rt = run_rt["state"]["model"]
        sd_rt = model_rt.state_dict()
        sd_same = sd_rt.keys() == model_a.state_dict().keys() and all(
            torch.equal(v, sd_rt[k]) for k, v in model_a.state_dict().items())
        ea = make_eval_step(model_a, names_a)(batch)
        er = make_eval_step(model_rt, names_a)(batch)
        eval_same = all(torch.equal(ea[n], er[n]) for n in names_a)
        check(sd_same and eval_same and not run_rt["ref_ckpt_missing"],
              f"recipe round trip: state dict bitwise {sd_same}, eval "
              f"forward bitwise {eval_same}, left at init "
              f"{run_rt['ref_ckpt_missing'][:4]}")
        del run_a, run_rt, model_a, model_rt, step_a, sd_rt, ea, er
        torch.cuda.empty_cache()

        # run B: dense ViT-small with TAM level 0 from the DeiT file
        with open(os.path.join(here, DEIT_CONFIG)) as f:
            exp = yaml.safe_load(f)
        cfg_b = os.path.join(root, "config_b.yml")
        with open(cfg_b, "w") as f:
            yaml.safe_dump(exp, f)
        with open(log_path, "a") as log, contextlib.redirect_stdout(log):
            _build.reset_launches()        # the run B path starts here
            run_b = cli_main(base + ["--config_exp", cfg_b, "--run_name",
                                     "recipe_b", "--pretrained", deit_path,
                                     "--pos_emb_from_pretrained"])
            torch.cuda.synchronize()
            paths["recipe_dense_tam"] = dict(_build.launches)  # ... ends
        p_b = create_config(env, cfg_b)
        names_b = list(p_b["TASK_NAMES"])
        model_b, step_b = run_b["state"]["model"], run_b["state"]["train_step"]
        per_step_b = {"flash_attention_fwd": 24, "flash_attention_bwd": 12,
                      "expert_ffn_fwd": 24, "expert_ffn_bwd": 12}
        launches_b = check_launches(paths["recipe_dense_tam"], RECIPE_STEPS,
                                    per_step_b, "recipe run B")
        # the dense ViT takes every tensor of the file, pos_embed resized
        check(run_b.get("stopped_at_step") == RECIPE_STEPS
              and not run_b["pretrained_missing"],
              f"recipe run B: stopped at {run_b.get('stopped_at_step')}, "
              f"left at init {run_b['pretrained_missing'][:4]}")
        batch_b = synthetic_batch(torch.Generator(device=dev).manual_seed(0),
                                  p_b["TASKS"], CLI_BATCH, (IMG, IMG))
        loss_fns_b = build_loss_fns(p_b)
        weights_b = p_b["loss_kwargs"]["loss_weights"]
        remat_b = check_remat(grads_with_and_without_remat(
            model_b, names_b, loss_fns_b, weights_b, batch_b, dev),
            "recipe run B")
        readings_b, _ = timed_steps(
            model_b, names_b, None, batch_b, dev, per_step_b,
            "recipe run B step", make_step=lambda *_: step_b, profile=False)
        tam_losses = {k: v for k, v in step_b(batch_b, torch.Generator(
            device=dev).manual_seed(5)).items() if "tam_level0" in k}
        check(len(tam_losses) == len(names_b) and all(
            np.isfinite(v.item()) for v in tam_losses.values()),
            f"recipe run B: tam_level0 losses {tam_losses}")
        del run_b, model_b, step_b
        torch.cuda.empty_cache()

        # the dropout step: NYUD, multi-gate MoE, TAM, remat, synthetic
        with open(os.path.join(here, DROP_CONFIG)) as f:
            p_d = yaml.safe_load(f)
        model_d, tasks_d = build_model(p_d, device=dev, seed=0)
        names_d = [tk.name for tk in tasks_d]
        hw = tuple(p_d["backbone_kwargs"]["img_size"])
        batch_d = synthetic_batch(torch.Generator(device=dev).manual_seed(0),
                                  tasks_d, int(p_d["trBatch"]), hw)
        loss_fns_d = build_loss_fns(p_d)
        weights_d = p_d["loss_kwargs"]["loss_weights"]
        init_d = {k: v.clone() for k, v in model_d.state_dict().items()}
        losses_d = []
        for _ in range(2):
            model_d.load_state_dict(init_d)
            model_d.zero_grad(set_to_none=True)
            model_d.train()
            pred, cv, _ = model_d(batch_d["image"], noise=torch.Generator(
                device=dev).manual_seed(6))
            loss = multi_task_loss(pred, batch_d, names_d, loss_fns_d,
                                   weights_d)["total"] + 0.01 * cv
            loss.backward()
            losses_d.append(loss.detach())
        same_d = torch.equal(*losses_d)
        check(same_d and bool(torch.isfinite(losses_d[0])),
              f"recipe dropout step: losses {[v.item() for v in losses_d]} "
              f"from one seed")
        per_step_d = {"flash_attention_fwd": 12 * len(names_d) * 2,
                      "flash_attention_bwd": 12 * len(names_d)}
        readings_d, paths["recipe_dropout_train"] = timed_steps(
            model_d, names_d, None, batch_d, dev, per_step_d,
            "recipe dropout step",
            make_step=lambda m, n, lf, lw, o, s: make_train_step(
                m, n, loss_fns_d, weights_d, o, s))
        _build.reset_launches()            # the dropout eval path starts
        make_eval_step(model_d, names_d)(batch_d)
        torch.cuda.synchronize()
        paths["recipe_dropout_eval"] = dict(_build.launches)   # ... ends
        eval_d = check_launches(
            paths["recipe_dropout_eval"], len(names_d),
            {"flash_attention_fwd": 12, "expert_ffn_fwd": 12},
            "recipe dropout model, eval per task pass")
        del model_d, init_d, pred, loss
        torch.cuda.empty_cache()
    except BaseException:
        if os.path.exists(log_path):
            with open(log_path) as f:
                print(f.read()[-6000:], file=sys.stderr)
        raise
    finally:
        cli_mod.load_pretrained_backbone = load
    phase_s = time.perf_counter() - t_phase
    check(phase_s < RECIPE_PHASE_LIMIT_S,
          f"recipe phase took {phase_s:.1f} s (limit {RECIPE_PHASE_LIMIT_S})")
    emit({"phase": "recipe", "steps": RECIPE_STEPS,
          "run_a": {"config": CLI_CONFIG, "launches_per_run": launches_a,
                    "experts": E, "top_k": K, "expert_hidden": hidden,
                    "groups": G,
                    "banks_bitwise_upcycle": banks_ok,
                    "pos_embed_kept_init": loaded["pos_embed_kept"],
                    "left_at_init": loaded["missing"],
                    "step_remat": memory_a["remat"],
                    "step_no_remat": memory_a["no_remat"],
                    "remat_vs_none": remat_a},
          "round_trip": {"ranks": 2, "state_dict_bitwise": sd_same,
                         "eval_forward_bitwise": eval_same},
          "run_b": {"config": DEIT_CONFIG, "launches_per_step": launches_b,
                    "tam_level0_losses": {k: v.item()
                                          for k, v in tam_losses.items()},
                    "step": readings_b,
                    "remat_vs_none": remat_b},
          "dropout": {"config": DROP_CONFIG, "image_hw": hw,
                      "batch": int(p_d["trBatch"]),
                      "loss_bitwise_same_seed": same_d,
                      "eval_launches_per_task_pass": eval_d,
                      "step": readings_d},
          "phase_s": phase_s})
    return paths


# the wider model families: the paper's ViT-base M3ViT through the CLI and
# served (d 768), the dense ViT-large (d 1024) and the ViT-tiny MoE (d 192),
# at full width and depth, seeded random weights
WIDE_MOE_CONFIG = ("configs/pascal/vit_moe/"
                   "pup_moe_vit_base_multi_task_baseline.yml")
LARGE_CONFIG = "configs/nyud/vit/pup_vit_large_semseg.yml"
TINY_CONFIG = "configs/cityscapes/pup_vit_tiny_deit_multi_task_baseline.yml"
WIDE_IMAGES = 32           # the ViT-base CLI's tree: 4 steps an epoch at B=8
WIDE_STOP = 6              # run 1 stops after 6 steps (2 into epoch 1)
WIDE_STEPS = 5             # timed synthetic-batch steps of each model
WIDE_REQUESTS = 20         # timed requests per serving cell
WIDE_PHASE_LIMIT_S = 300.0


def load_config(path: str):
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           path)) as f:
        return yaml.safe_load(f)


def train_vs_plain(model, names, batch, p, dev, what: str):
    """One train-mode forward and backward of `model` (config `p`) from its
    current state with kernels and on the plain path, the same batch and
    gate-noise seed, the plain path replaying the kernel path's routing
    (RoutingTape): the loss (+ 0.01 cv) to TRAIN_LOSS_REL_TOL; then the
    backbone alone (an MoE backbone routing for task 0) under a fixed
    random cotangent on its output tokens, each parameter group's gradient
    to BACKBONE_GRAD_REL_TOL.  Leaves the model on the kernel path in its
    initial state."""
    loss_fns, weights = build_loss_fns(p), p["loss_kwargs"]["loss_weights"]
    init = {k: v.clone() for k, v in model.state_dict().items()}
    moe = not isinstance(model.backbone, VisionTransformer)
    cotangent = torch.randn(
        (batch["image"].shape[0],) + tuple(model.backbone.pos_embed.shape[1:]),
        device=dev, generator=torch.Generator(device=dev).manual_seed(3))

    def run(kernels: bool, tape, alone: bool):
        model.load_state_dict(init)
        set_use_kernels(model, kernels)
        model.train()
        model.zero_grad(set_to_none=True)
        noise = torch.Generator(device=dev).manual_seed(1)
        loss = None
        with tape if moe else contextlib.nullcontext():
            if alone:
                out = (model.backbone(batch["image"], 0, noise) if moe
                       else model.backbone(batch["image"]))
                (out[0] if moe else out).float().backward(cotangent)
            else:
                pred, cv, _ = model(batch["image"], noise=noise)
                total = multi_task_loss(pred, batch, names, loss_fns,
                                        weights)["total"] + 0.01 * cv
                total.backward()
                loss = total.item()
        return loss, param_grads(model)

    tapes = {mode: RoutingTape() for mode in ("step", "backbone")}
    k_loss = run(True, tapes["step"], False)[0]
    k_bb = run(True, tapes["backbone"], True)[1]
    before = dict(_build.launches)
    p_loss = run(False, tapes["step"], False)[0]
    p_bb = run(False, tapes["backbone"], True)[1]
    check(dict(_build.launches) == before, f"{what}: plain runs launched a "
          "kernel")
    backbone = rel_by_group(k_bb, p_bb)
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    check(np.isfinite(k_loss) and loss_rel <= TRAIN_LOSS_REL_TOL
          and all(v <= BACKBONE_GRAD_REL_TOL for v in backbone.values()),
          f"{what} train kernel vs plain: loss {k_loss} vs {p_loss} (rel "
          f"limit {TRAIN_LOSS_REL_TOL}); backbone grad rel err under a fixed "
          f"cotangent {backbone} (limit {BACKBONE_GRAD_REL_TOL})")
    set_use_kernels(model, True)
    model.load_state_dict(init)
    model.zero_grad(set_to_none=True)
    return {"loss_kernel": k_loss, "loss_plain": p_loss,
            "loss_rel_err": loss_rel,
            "backbone_cotangent": {"grad_rel_err": backbone},
            "rerouted_token_frac": {
                m: t.rerouted / t.tokens for m, t in tapes.items()
                if t.tokens}}


def serve_rows(model, names, hw, buckets, classes: int, expected, what: str,
               seed: int):
    """uint8 semseg requests (class map out) at each bucket: WIDE_REQUESTS
    timed each, launches counted per backbone pass over all of them, the
    peak memory."""
    sess = InferenceSession(model, names, hw, buckets=buckets,
                            raw_uint8_input=True,
                            device=next(model.parameters()).device)
    sess.warmup(tasks=["semseg"], postprocess=True)
    rng = np.random.RandomState(seed)
    rows = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()            # the serving path starts here
    for b in buckets:
        u8 = rng.randint(0, 256, (b,) + tuple(hw) + (3,)).astype(np.uint8)
        rows.append({"bucket": b, "uint8_post": time_requests(
            sess, u8, True, WIDE_REQUESTS, classes)})
    launches = dict(_build.launches)   # ... and ends here
    per_pass = check_launches(launches, len(buckets) * (WIDE_REQUESTS + 1),
                              expected, what)
    return {"rows": rows, "launches_per_pass": per_pass,
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 1e6}, \
        launches


def wide_cli_phase(dev, root: str):
    """The paper's ViT-base M3ViT (WIDE_MOE_CONFIG: d 768, 12 heads, E 16,
    K 2, expert hidden 1536, multi-gate, five PASCAL tasks, TAM level 0,
    remat, 512^2, B=8) through the trainer CLI on a fabricated PASCAL tree
    of WIDE_IMAGES images: a run stopped after WIDE_STOP steps, its
    --resume (the epoch's rest, one no-drop evaluation, checkpoints),
    --eval against the resumed run's results, and a short run with
    --use_pallas_ln_mlp (K5/K6 at 768); launches counted exactly over each
    run; the models of run 1 and of the ln_mlp run each held against their
    plain path (train_vs_plain), then the CLI's train step on a synthetic
    batch (WIDE_STEPS timed steps that lower the loss); the CLI's ms per
    step beside that step, and each run's peak memory."""
    import yaml

    here = os.path.dirname(os.path.abspath(__file__))
    db = os.path.join(root, "PASCAL_MT")
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "from fabricate_dataset import fabricate_pascal; "
         "fabricate_pascal(sys.argv[2], int(sys.argv[3]), "
         "(int(sys.argv[4]), int(sys.argv[5])))",
         os.path.join(here, "scripts"), db, str(WIDE_IMAGES),
         *map(str, CLI_HW)], check=True, timeout=300)
    fabricate_s = time.perf_counter() - t0
    env, cfg = os.path.join(root, "env.yml"), os.path.join(root, "config.yml")
    with open(env, "w") as f:
        yaml.safe_dump({"root_dir": os.path.join(root, "runs"),
                        "dataset_roots": {"PASCAL_MT": db}}, f)
    exp = load_config(WIDE_MOE_CONFIG)
    exp.update(edge_odsF_matcher="greedy", edge_odsF_thresholds=5)
    with open(cfg, "w") as f:
        yaml.safe_dump(exp, f)
    p = create_config(env, cfg, {"moe_eval_capacity_factor":
                                 parse_capacity_factor("nodrop")})
    spe = WIDE_IMAGES // CLI_BATCH
    base = ["--config_env", env, "--config_exp", cfg, "--trBatch",
            str(CLI_BATCH), "--valBatch", str(CLI_BATCH), "--epochs", "2",
            "--moe_eval_capacity_factor", "nodrop"]
    runs, launches, peak = {}, {}, {}
    vs_plain, readings, synth = {}, {}, {}
    # the train step as cli/train.py builds it (cv weight 0.01, one
    # micro-batch), on the optimizer timed_steps makes
    cli_step = functools.partial(make_train_step, analysis_metrics=True)
    names = list(p["TASK_NAMES"])
    log_path = os.path.join(root, "wide_cli.log")
    try:
        with open(log_path, "w") as log, contextlib.redirect_stdout(log):
            for name, extra in (
                    ("stop", ["--stop_after_steps", str(WIDE_STOP)]),
                    ("resume", ["--resume"]), ("eval", ["--eval"]),
                    ("ln_mlp", ["--use_pallas_ln_mlp", "--run_name",
                                "wide_ln_mlp", "--stop_after_steps", "2"])):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                _build.reset_launches()    # the run's path starts here
                runs[name] = cli_main(base + extra)
                torch.cuda.synchronize()
                launches[name] = dict(_build.launches)   # ... ends here
                runs[name]["seconds"] = time.perf_counter() - t0
                peak[name] = torch.cuda.max_memory_allocated() / 1e9
                if name in ("stop", "ln_mlp"):
                    # the run's own model against its plain path, then the
                    # CLI's step on a synthetic batch, with a fresh SGD at
                    # the config's rate (run 1's poly schedule over 2
                    # epochs is at its end there, where the rate is 0)
                    model = runs[name]["state"]["model"]
                    batch = synthetic_batch(
                        torch.Generator(device=dev).manual_seed(0),
                        p["TASKS"], CLI_BATCH, (IMG, IMG))
                    vs_plain[name] = train_vs_plain(
                        model, names, batch, p, dev, f"wide cli run {name}")
                    readings[name], synth[name] = timed_steps(
                        model, names, build_loss_fns(p), batch, dev,
                        expected_cli_launches(1, 0, ln_mlp=name == "ln_mlp"),
                        f"wide cli run {name}: the CLI's step on a "
                        "synthetic batch", make_step=cli_step,
                        loss_falls=True, profile=False, steps=WIDE_STEPS,
                        weights=p["loss_kwargs"]["loss_weights"])
                    del model, batch
                runs[name].pop("state")
                torch.cuda.empty_cache()
    except BaseException:
        if os.path.exists(log_path):
            with open(log_path) as f:
                print(f.read()[-6000:], file=sys.stderr)
        raise
    r1, r2, r3, r4 = (runs[k] for k in ("stop", "resume", "eval", "ln_mlp"))
    check(r1.get("stopped_at_step") == WIDE_STOP
          and r1["steps_run"] == WIDE_STOP
          and r2["steps_run"] == 2 * spe - WIDE_STOP
          and r2.get("best") is not None
          and r4.get("stopped_at_step") == 2,
          f"wide cli: run 1 stopped at {r1.get('stopped_at_step')} after "
          f"{r1['steps_run']} steps, run 2 {r2['steps_run']} steps (best "
          f"{r2.get('best') is not None}), ln_mlp run stopped at "
          f"{r4.get('stopped_at_step')}")
    per = {}
    for name, (S, V, ln) in (("stop", (WIDE_STOP, 0, False)),
                             ("resume", (2 * spe - WIDE_STOP, spe, False)),
                             ("eval", (0, spe, False)),
                             ("ln_mlp", (2, 0, True))):
        per[name] = check_launches(launches[name], 1,
                                   expected_cli_launches(S, V, ln_mlp=ln),
                                   f"wide cli run {name}")
    ref_leaves = dict(_leaves(r2["best"]))
    got_leaves = dict(_leaves({k: r3[k] for k in r2["best"]}))
    eval_rel = max(abs(got_leaves[k] - v) / max(abs(v), 1e-12)
                   for k, v in ref_leaves.items())
    check(got_leaves.keys() == ref_leaves.keys()
          and eval_rel <= CLI_EVAL_REL_TOL
          and all(np.isfinite(v) for v in got_leaves.values()),
          f"wide cli --eval vs run 2's results: max rel diff {eval_rel} "
          f"(limit {CLI_EVAL_REL_TOL})")
    t = dict(r1["step_times"])
    gaps = {s: (t[s] - t[s - 1]) * 1e3 for s in t
            if s - 1 in t and (s - 1) % spe and s > 2}
    cli_ms = float(np.median(list(gaps.values()))) if gaps else None
    emit({"phase": "wide_cli", "config": WIDE_MOE_CONFIG,
          "images": WIDE_IMAGES, "fabricate_s": fabricate_s,
          "runs": {k: _summary(r) for k, r in runs.items()},
          "launches": launches, "launches_expected_equal": per,
          "peak_memory_gb": peak, "eval_vs_run2_max_rel": eval_rel,
          "cli_ms_per_step_median": cli_ms, "cli_step_gaps_ms": gaps,
          "train_kernel_vs_plain": vs_plain, "synthetic_step": readings})
    return {"wide_cli": launches["stop"], "wide_cli_ln_mlp":
            launches["ln_mlp"], "wide_cli_synthetic_step": synth["stop"],
            "wide_cli_ln_mlp_synthetic_step": synth["ln_mlp"]}


def wide_serving_phase(dev):
    """ViT-base M3ViT (WIDE_MOE_CONFIG, seed 0) served: semseg at buckets 1
    and 8, float and with its expert banks quantized to int8 (K7 at 768);
    each held against its plain path at bucket 8 (float: logits to
    LOGIT_REL_TOL and class maps against an f32 copy as for the dense
    ViT; int8: class maps to AGREE_MIN and logits to LOGIT_REL_TOL), and
    the int8 class maps against the float ones (AGREE_MIN)."""
    p = load_config(WIDE_MOE_CONFIG)
    model, tasks = build_model(p, device=dev, seed=0)
    names = [tk.name for tk in tasks]
    float_rows, float_launches = serve_rows(
        model, names, (IMG, IMG), (1, 8), 21,
        expected_serving_launches(12), "wide serving", 20)
    rng = np.random.RandomState(21)
    imgs = rng.randn(8, IMG, IMG, 3).astype(np.float32)
    ref, _ = build_model({**p, "compute_dtype": "float32"}, device=dev,
                         seed=0)
    float_vs_plain = serving_vs_plain_and_f32(model, ref, names, imgs,
                                              "wide serving")
    del ref
    torch.cuda.empty_cache()
    qsd, q_err = quantize_expert_state_dict(model.state_dict(),
                                            with_error=True)
    qmodel, _ = build_model({**p, "expert_weights_int8": True}, device=dev,
                            seed=0)
    qmodel.load_state_dict(qsd, strict=True)
    del qsd
    int8_rows, int8_launches = serve_rows(
        qmodel, names, (IMG, IMG), (1, 8), 21,
        expected_serving_launches(12, int8=True), "wide int8 serving", 22)

    def logits(m):
        return InferenceSession(m, names, (IMG, IMG), buckets=(8,),
                                device=dev).predict(imgs, "semseg")

    q_logits, f_logits = logits(qmodel), logits(model)
    before = dict(_build.launches)
    set_use_kernels(qmodel, False)
    qp_logits = logits(qmodel)
    set_use_kernels(qmodel, True)
    check(dict(_build.launches) == before,
          "wide int8 plain run launched a kernel")
    agree, rel_err = logit_agreement(q_logits, qp_logits)
    f_agree, f_rel = logit_agreement(q_logits, f_logits)
    check(agree >= AGREE_MIN and rel_err <= LOGIT_REL_TOL
          and f_agree >= AGREE_MIN,
          f"wide int8 serving at bucket 8: kernel vs plain class agreement "
          f"{agree}, logit rel err {rel_err}; int8 vs float class agreement "
          f"{f_agree}")
    del model, qmodel
    torch.cuda.empty_cache()
    emit({"phase": "wide_serving", "config": WIDE_MOE_CONFIG,
          "float": {**float_rows, "kernel_vs_plain": float_vs_plain},
          "int8": {**int8_rows, "kernel_vs_plain": {
              "bucket": 8, "class_map_agreement": agree,
              "logit_rel_err": rel_err},
              "int8_vs_float": {"bucket": 8, "class_map_agreement": f_agree,
                                "logit_rel_err": f_rel},
              "expert_quantization_error": q_err}})
    return {"wide_serving": float_launches,
            "wide_int8_serving": int8_launches}


def vit_large_phase(dev):
    """The dense ViT-large (LARGE_CONFIG: d 1024, 16 heads, hidden 4096,
    NYUD semseg, 480 x 640, B=8, remat): a train step kernel against plain
    (train_vs_plain), WIDE_STEPS timed steps that lower the loss with
    launches counted per step, bucket-8 serving (launches per pass, kernel
    against plain and f32); then the same weights with the fused dense
    sublayer (use_pallas_ln_mlp: K5/K6 at 1024): a step against plain and
    timed steps."""
    p = load_config(LARGE_CONFIG)
    hw = tuple(p["backbone_kwargs"]["img_size"])
    model, tasks = build_model(p, device=dev, seed=0)
    names = [tk.name for tk in tasks]
    B = int(p["trBatch"])
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(0),
                            tasks, B, hw)
    loss_fns, weights = build_loss_fns(p), p["loss_kwargs"]["loss_weights"]
    out, paths = {}, {}
    out["train_kernel_vs_plain"] = train_vs_plain(model, names, batch, p,
                                                  dev, "vit_large")
    per_step = {"flash_attention_fwd": 24, "flash_attention_bwd": 12,
                "expert_ffn_fwd": 24, "expert_ffn_bwd": 12}
    out["train_step"], paths["vit_large_train"] = timed_steps(
        model, names, loss_fns, batch, dev, per_step, "vit_large train",
        loss_falls=True, steps=WIDE_STEPS, weights=weights)
    model.eval()
    classes = next(tk.num_output for tk in tasks if tk.name == "semseg")
    out["serving"], paths["vit_large_serving"] = serve_rows(
        model, names, hw, (8,), classes, expected_serving_launches(12),
        "vit_large serving", 23)
    ref, _ = build_model({**p, "compute_dtype": "float32"}, device=dev,
                         seed=0)
    ref.load_state_dict(model.state_dict())
    out["serving"]["kernel_vs_plain"] = serving_vs_plain_and_f32(
        model, ref, names, np.random.RandomState(24).randn(
            8, *hw, 3).astype(np.float32), "vit_large")
    del ref
    fused, _ = build_model({**p, "use_pallas_ln_mlp": True}, device=dev,
                           seed=0)
    fused.load_state_dict(model.state_dict())
    del model
    torch.cuda.empty_cache()
    out["ln_mlp_train_kernel_vs_plain"] = train_vs_plain(
        fused, names, batch, p, dev, "vit_large ln_mlp")
    out["ln_mlp_train_step"], paths["vit_large_ln_mlp_train"] = timed_steps(
        fused, names, loss_fns, batch, dev,
        {"flash_attention_fwd": 24, "flash_attention_bwd": 12,
         "ln_mlp_fwd": 24, "ln_mlp_bwd": 12}, "vit_large ln_mlp train",
        loss_falls=True, steps=WIDE_STEPS, weights=weights)
    del fused, batch
    torch.cuda.empty_cache()
    emit({"phase": "vit_large", "config": LARGE_CONFIG, "image_hw": hw,
          "batch": B, **out})
    return paths


def vit_tiny_phase(dev):
    """The ViT-tiny MoE (TINY_CONFIG: d 192, 3 heads, E 16, K 2, expert
    hidden 384, multi-gate, CityScapes semseg + depth, TAM level 0, remat,
    128 x 256, B=4): a train step kernel against plain with routing
    replayed (train_vs_plain), WIDE_STEPS timed steps that lower the loss
    with launches counted per step, and semseg serving at bucket 4
    (launches per pass, kernel against plain and f32)."""
    p = load_config(TINY_CONFIG)
    hw = tuple(p["backbone_kwargs"]["img_size"])
    model, tasks = build_model(p, device=dev, seed=0)
    names = [tk.name for tk in tasks]
    B = int(p["trBatch"])
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(0),
                            tasks, B, hw)
    out, paths = {}, {}
    out["train_kernel_vs_plain"] = train_vs_plain(model, names, batch, p,
                                                  dev, "vit_tiny")
    T = len(names)
    out["train_step"], paths["vit_tiny_train"] = timed_steps(
        model, names, build_loss_fns(p), batch, dev,
        {"flash_attention_fwd": 24 * T, "flash_attention_bwd": 12 * T,
         "expert_ffn_fwd": 24 * T, "expert_ffn_bwd": 12 * T},
        "vit_tiny train", loss_falls=True, steps=WIDE_STEPS,
        weights=p["loss_kwargs"]["loss_weights"])
    model.eval()
    classes = next(tk.num_output for tk in tasks if tk.name == "semseg")
    out["serving"], paths["vit_tiny_serving"] = serve_rows(
        model, names, hw, (B,), classes, expected_serving_launches(12),
        "vit_tiny serving", 25)
    ref, _ = build_model({**p, "compute_dtype": "float32"}, device=dev,
                         seed=0)
    ref.load_state_dict(model.state_dict())
    out["serving"]["kernel_vs_plain"] = serving_vs_plain_and_f32(
        model, ref, names, np.random.RandomState(26).randn(
            B, *hw, 3).astype(np.float32), "vit_tiny")
    del model, ref, batch
    torch.cuda.empty_cache()
    emit({"phase": "vit_tiny", "config": TINY_CONFIG, "image_hw": hw,
          "batch": B, **out})
    return paths


def wide_phase(dev, root: str):
    """The wide paths in turn (wide_cli_phase, wide_serving_phase,
    vit_large_phase, vit_tiny_phase); their launches by path."""
    t0 = time.perf_counter()
    paths = wide_cli_phase(dev, root)
    torch.cuda.empty_cache()
    for phase in (wide_serving_phase, vit_large_phase, vit_tiny_phase):
        paths.update(phase(dev))
    phase_s = time.perf_counter() - t0
    check(phase_s < WIDE_PHASE_LIMIT_S,
          f"wide phases took {phase_s:.1f} s (limit {WIDE_PHASE_LIMIT_S})")
    emit({"phase": "wide_total", "seconds": phase_s})
    return paths


EP_CONFIG = "configs/cityscapes/vit_base_moe_ep.yml"
EP_IMAGES, EP_HW, EP_BATCH = 32, (256, 512), 8   # 4 steps an epoch
EP_STOP = 3                # run 1 stops after 3 steps, --resume runs 1
EP_STEPS = 5               # timed steps of the in-process EP step
EP_OBO_CALLS = 4           # one-by-one calls (2 optimizer steps) at accum 2
EP_CHUNKS = 2              # the CLI runs' --a2a_chunks
EP_TIMED = 20              # timed calls of the exchange and the local FFN
EP_LOSS_REL_TOL = 2e-3     # the EP run's first loss against the no-group run's
EP_RUN_TIMEOUT_S = 300
PARALLEL_PHASE_LIMIT_S = 300.0
#: device kernels a trace of the EP CLI's train steps must show (K1-K4 at
#: d 768: K1, K2's main kernel, K3's two-pass GEMMs, K4's hidden pass);
#: NCCL's kernels, which a one-rank group does not launch (its exchange and
#: all-reduces are device copies), are read where there are any
EP_TRACE_KERNELS = {"flash_attention_fwd": r"flash_fwd_kernel",
                    "flash_attention_bwd": r"flash_bwd_kernel",
                    "expert_ffn_fwd": r"ffn_gemm_kernel<0, ?0, ?[12],",
                    "expert_ffn_bwd": r"ffn_bwd_hidden_kernel"}
EP_TRACE_NCCL = r"nccl"


def expected_ep_launches(calls: int, eval_batches: int,
                         chunks: int = EP_CHUNKS, tasks: int = 2,
                         depth: int = 12, remat: bool = True):
    """Launches of `calls` train steps (joint or one-by-one: a forward and
    a backward a task pass) and `eval_batches` eval batches of the EP
    config (`depth` blocks, half MoE, `tasks` task passes, remat): K1 and
    K3 once a block and pass forward (again in the remat's recompute),
    K2 and K4 once a block and pass backward; an MoE block's FFN is
    `chunks` K3 / K4 launches (one a chunk of local experts)."""
    ffn = depth // 2 + (depth // 2) * chunks
    fwd = calls * (2 if remat else 1) + eval_batches
    out = {"flash_attention_fwd": tasks * depth * fwd,
           "flash_attention_bwd": tasks * depth * calls,
           "expert_ffn_fwd": tasks * ffn * fwd,
           "expert_ffn_bwd": tasks * ffn * calls}
    return {k: v for k, v in out.items() if v}


def ep_dispatch_phase(dev, layout):
    """moe_ffn's exchange path over a one-rank NCCL expert group at the EP
    config's shape (B=8 at 128 x 256: 1032 tokens, E 16, K 4, d 768,
    expert hidden 768, train capacity factor 2.0: K3/K4 on [16 / C, 520,
    768] a chunk) for a2a_chunks 1, 2 and 3 (3 falls back to 2) against
    moe_ffn_local on the same kernels and inputs: the forward the same
    bits, each gradient's difference stated (K4's token splits follow E,
    so a chunk's weight gradients may sum in another order), launches
    exactly C K3 and C K4 a call; forward+backward ms of each beside the
    local path's (CUDA events)."""
    import torch.distributed as dist

    from m3vit_tpu_torch.moe.dispatch import (MoEFfnParams, a2a_chunk_count,
                                              moe_ffn)

    t0 = time.perf_counter()
    p = load_config(EP_CONFIG)
    E, K, d = p["moe_experts"], p["moe_top_k"], 768
    hidden = int(d * p["backbone_kwargs"]["moe_mlp_ratio"])
    T = EP_BATCH * ((128 // 16) * (256 // 16) + 1)
    cf = 2.0
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(T, d, generator=gen, device=dev).bfloat16()
    gates, idx = small_topk(torch.softmax(torch.randn(
        T, E, generator=gen, device=dev), -1), K)
    bound = hidden ** -0.5
    banks = [(torch.rand(*shape, generator=gen, device=dev) * 2 - 1)
             * bound for shape in ((E, hidden, d), (E, hidden),
                                   (E, d, hidden), (E, d))]
    cot = torch.randn(T, d, generator=gen, device=dev).bfloat16()
    leaves = [x.requires_grad_(), gates.requires_grad_()] + [
        b.requires_grad_() for b in banks]

    def call(chunks, backward=True):
        y = moe_ffn(x, idx, gates, MoEFfnParams(*banks),
                    capacity_factor=cf,
                    group=None if chunks is None
                    else layout.expert_group,
                    num_experts_global=E, a2a_chunks=chunks or 1)
        if backward:
            (y.float() * cot.float()).sum().backward()
        return y

    def run(chunks):
        for t in leaves:
            t.grad = None
        torch.cuda.synchronize()
        _build.reset_launches()
        y = call(chunks)
        torch.cuda.synchronize()
        return (y.detach(), [t.grad.clone() for t in leaves],
                {k: v for k, v in _build.launches.items() if v})

    ref_y, ref_g, ref_l = run(None)
    check(ref_l == {"expert_ffn_fwd": 1, "expert_ffn_bwd": 1},
          f"ep dispatch: the local path launched {ref_l}")
    names = ("x", "gates", "w1", "b1", "w2", "b2")
    rows = {"local": {"ms_fwd_bwd": time_ms(lambda: call(None),
                                            reps=EP_TIMED)}}
    cap = compute_capacity(T, K, E, cf)
    for c in (1, 2, 3):
        C = a2a_chunk_count(E, c)
        y, g, launches = run(c)
        same_fwd = torch.equal(y, ref_y)
        diffs = {n: float((a.float() - b.float()).abs().max()
                          / max(float(b.float().abs().max()), 1e-30))
                 for n, a, b in zip(names, g, ref_g)}
        same_grads = {n: torch.equal(a, b)
                      for n, a, b in zip(names, g, ref_g)}
        check(same_fwd, f"ep dispatch a2a_chunks {c}: the forward "
              "differs from moe_ffn_local's")
        check(all(v <= GRAD_ABS_FRAC for v in diffs.values()),
              f"ep dispatch a2a_chunks {c}: gradients off the local "
              f"path's by {diffs} of their largest (limit "
              f"{GRAD_ABS_FRAC})")
        check(launches == {"expert_ffn_fwd": C, "expert_ffn_bwd": C},
              f"ep dispatch a2a_chunks {c}: launches {launches}, "
              f"expected {C} K3 and {C} K4")
        rows[c] = {"chunks_used": C, "forward_same_bits": same_fwd,
                   "grads_same_bits": same_grads,
                   "grad_max_abs_err_frac": diffs,
                   "launches": launches,
                   "ms_fwd_bwd": time_ms(lambda: call(c),
                                         reps=EP_TIMED)}
    for t in leaves:
        t.grad = None
    # the host's time for one collective call over the one-rank group
    # (no device sync in the loop), against a plain device copy
    small = torch.zeros(1024, device=dev)
    buf, out_buf = x.detach().clone(), torch.empty_like(x)

    def host_us(fn, n: int = 100):
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t1) / n * 1e6
        torch.cuda.synchronize()
        return us
    rows["host_us_per_call"] = {
        "all_reduce_4kb": host_us(lambda: dist.all_reduce(small)),
        "all_to_all_sync": host_us(lambda: dist.all_to_all_single(
            out_buf, buf, group=layout.expert_group)),
        "all_to_all_async_wait": host_us(lambda: dist.all_to_all_single(
            out_buf, buf, group=layout.expert_group,
            async_op=True).wait()),
        "all_to_all_async_issue": host_us(lambda: dist.all_to_all_single(
            out_buf, buf, group=layout.expert_group, async_op=True)),
        "device_copy": host_us(lambda: out_buf.copy_(buf))}
    emit({"phase": "parallel_dispatch", "tokens": T, "experts": E,
          "top_k": K, "d": d, "hidden": hidden, "capacity": cap,
          "k3_shape_per_chunk": {c: [E // rows[c]["chunks_used"], cap,
                                     d] for c in (1, 2, 3)},
          "rows": rows, "seconds": time.perf_counter() - t0})
    return {"parallel_dispatch": rows[2]["launches"]}


def host_profile(fn, n: int = 3, top: int = 10):
    """n calls of fn under torch.profiler: the card's busy time per call
    (as device_profile) and the host's time per call in each operator
    itself (self CPU time), the `top` operators."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    rows = sorted(((e.self_cpu_time_total / 1e3 / n, e.count / n, e.key)
                   for e in avg), reverse=True)
    dev_ms = sum(e.device_time_total for e in avg
                 if e.device_type.name == "CUDA") / 1e3 / n
    return {"device_ms": dev_ms, "self_cpu_ms": sum(r[0] for r in rows),
            "top": [{"name": k[:90], "ms": ms, "calls": c}
                    for ms, c, k in rows[:top]]}


def ep_step_phase(dev, layout):
    """The EP config's train step (B=8 synthetic batch, the CLI's step:
    make_train_step with the analysis metrics) in steady state, with the
    one-rank layout (exchange in EP_CHUNKS pieces, SyncBN, the gradient
    all-reduces) and without a process group, each on a model from the
    same seed: EP_STEPS steps between CUDA events after 2 warm-up steps,
    launches per step exactly, peak memory, then 3 steps under
    torch.profiler: the device time of a step, its idle share and the
    host's self time by operator; the first step's loss of each against
    the other."""
    import yaml

    from m3vit_tpu_torch import parallel

    exp = load_config(EP_CONFIG)
    root = tempfile.mkdtemp(prefix="chip_smoke_ep_")
    try:
        env, cfg = os.path.join(root, "env.yml"), os.path.join(root, "ep.yml")
        with open(env, "w") as f:
            yaml.safe_dump({"root_dir": os.path.join(root, "runs")}, f)
        with open(cfg, "w") as f:
            yaml.safe_dump(exp, f)
        p = create_config(env, cfg, {})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    names = list(p["TASK_NAMES"])
    loss_fns, weights = build_loss_fns(p), p["loss_kwargs"]["loss_weights"]
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(0),
                            p["TASKS"], EP_BATCH, tuple(p["train_scale"]))
    cli_step = functools.partial(make_train_step, analysis_metrics=True)
    readings, launches, first = {}, {}, {}
    for name, lay in (("ep", layout), ("nogroup", None)):
        parallel.set_layout(lay)
        try:
            model, _ = build_model(p, device=dev, seed=0)
            model.train()
            if lay is not None:
                parallel.shard_experts(model, lay, EP_CHUNKS)
            with torch.no_grad():
                pred, cv, _ = model(batch["image"], noise=torch.Generator(
                    device=dev).manual_seed(1))
                first[name] = (multi_task_loss(pred, batch, names, loss_fns,
                                               weights)["total"]
                               + 0.01 * cv).item()
                del pred, cv
            readings[name], launches[name] = timed_steps(
                model, names, loss_fns, batch, dev,
                expected_ep_launches(1, 0, chunks=EP_CHUNKS if lay else 1),
                f"ep step {name}", make_step=cli_step, weights=weights,
                profile=False, steps=EP_STEPS)
            step = cli_step(model, names, loss_fns, weights,
                            *build_optimizer(model.parameters(), OPTIM,
                                             steps_per_epoch=100))
            noise = torch.Generator(device=dev).manual_seed(2)
            prof = host_profile(lambda: step(batch, noise))
            readings[name].update(
                device_ms_per_step=prof["device_ms"],
                device_idle_frac=1.0 - prof["device_ms"]
                / readings[name]["step_ms_median"], host=prof)
            del model, step
        finally:
            parallel.set_layout(None)
        gc.collect()
        torch.cuda.empty_cache()
    rel = abs(first["ep"] - first["nogroup"]) / abs(first["nogroup"])
    check(rel <= EP_LOSS_REL_TOL, f"ep step: first loss {first} (rel limit "
          f"{EP_LOSS_REL_TOL})")
    emit({"phase": "parallel_step", "config": EP_CONFIG, "batch": EP_BATCH,
          "first_loss": first, "first_loss_rel": rel, "steps": readings})
    return {"parallel_step": launches["ep"]}


def _trace_kernels(path: str, steps: int, top: int = 12):
    """From a torch.profiler Chrome trace of `steps` train steps, per step:
    the launches and device time of each EP_TRACE_KERNELS pattern, of
    NCCL's kernels, of all kernels and of the device-to-device copies
    (where a one-rank group's collectives land); the `top` kernels by
    device time; the host time of the collectives' calls (c10d / NCCL
    operators) and the `top` CPU operators and CUDA runtime calls by
    total (inclusive) time."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    def per_step(evs):
        return {"launches": len(evs) / steps,
                "ms": sum(e.get("dur", 0) for e in evs) / 1e3 / steps}

    def tops(evs):
        tot = {}
        for e in evs:
            tot[e.get("name", "")] = tot.get(e.get("name", ""), 0) + \
                e.get("dur", 0)
        return [{"name": k[:90], "ms": v / 1e3 / steps} for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    by_cat = {}
    for e in events:
        by_cat.setdefault(e.get("cat"), []).append(e)
    kern = by_cat.get("kernel", [])
    out = {"all_kernels": per_step(kern)}
    for key, pat in EP_TRACE_KERNELS.items():
        out[key] = per_step([e for e in kern
                             if re.search(pat, e.get("name", ""))])
    out["nccl_kernels"] = per_step([e for e in kern if re.search(
        EP_TRACE_NCCL, e.get("name", ""), re.I)])
    out["dtod_copies"] = per_step([e for e in by_cat.get("gpu_memcpy", [])
                                   if "DtoD" in e.get("name", "")
                                   or "Device -> Device" in e.get("name",
                                                                  "")])
    cpu = by_cat.get("cpu_op", [])
    out["host_collectives"] = per_step([e for e in cpu if re.match(
        r"(c10d::|nccl:)", e.get("name", ""))])
    out["top_kernels"] = tops(kern)
    out["top_cpu_ops"] = tops(cpu)
    out["top_cuda_runtime"] = tops(by_cat.get("cuda_runtime", []))
    return out


def parallel_cli_phase(dev, root: str):
    """The EP config (EP_CONFIG: ViT-base d 768, depth 12, E 16, K 4,
    expert hidden 768, two Cityscapes tasks, remat, 128 x 256, B=8) at
    full width through the trainer CLI under ``python -m
    torch.distributed.run --nproc_per_node 1`` with --n_data 1 --n_expert
    1 --a2a_chunks EP_CHUNKS (a one-rank NCCL group: the exchange path,
    SyncBN, the gradient all-reduces, gathered checkpoints) on a
    fabricated Cityscapes tree of EP_IMAGES images: a run stopped after
    EP_STOP steps (with --forward_hook, its first 3 steps traced by
    --profile_dir: K1-K4 must show there), then side by side its --resume
    (the rest, one no-drop evaluation) and --eval (against the resumed
    run's results), and the same run without a process group (its losses
    the reference: the first to EP_LOSS_REL_TOL), a --one_by_one run with
    accumulation_steps 2 and a --flops --time run (the count on the card
    against the plain path's on the same model, in this process); each
    run's launches (its --run_summary) checked exactly."""
    import yaml

    from m3vit_tpu_torch.parallel.mesh import free_port
    from m3vit_tpu_torch.utils.tracing import flops_of

    here = os.path.dirname(os.path.abspath(__file__))
    db = os.path.join(root, "cityscapes")
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "from fabricate_dataset import fabricate_cityscapes; "
         "fabricate_cityscapes(sys.argv[2], int(sys.argv[3]), "
         "(int(sys.argv[4]), int(sys.argv[5])))",
         os.path.join(here, "scripts"), db, str(EP_IMAGES),
         *map(str, EP_HW)], check=True, timeout=300)
    fabricate_s = time.perf_counter() - t0
    env, cfg = os.path.join(root, "env.yml"), os.path.join(root, "ep.yml")
    with open(env, "w") as f:
        yaml.safe_dump({"root_dir": os.path.join(root, "runs"),
                        "dataset_roots": {"cityscapes": db}}, f)
    with open(cfg, "w") as f:
        yaml.safe_dump(load_config(EP_CONFIG), f)
    spe = EP_IMAGES // EP_BATCH
    base = ["--config_env", env, "--config_exp", cfg, "--epochs", "1",
            "--trBatch", str(EP_BATCH), "--valBatch", str(EP_BATCH),
            "--moe_eval_capacity_factor", "nodrop", "--log_interval", "1"]
    mesh = ["--n_data", "1", "--n_expert", "1", "--a2a_chunks",
            str(EP_CHUNKS)]
    prof = os.path.join(root, "profile_ep")
    runs, logs, failed = {}, {}, []
    # torchrun sets OMP_NUM_THREADS=1 where it is unset; every run gets
    # this process's thread count, so the runs differ only in the group
    run_env = {**os.environ, "OMP_NUM_THREADS": str(torch.get_num_threads())}

    def cli(name, extra, torchrun=True):
        summary = os.path.join(root, f"{name}.json")
        cmd = [sys.executable] + (
            ["-m", "torch.distributed.run", "--nproc_per_node", "1",
             "--master_port", str(free_port())] if torchrun else []) + [
            "-m", "m3vit_tpu_torch.cli.train"] + base + (
            mesh if torchrun else []) + extra + ["--run_summary", summary]
        t1 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                              timeout=EP_RUN_TIMEOUT_S, env=run_env)
        logs[name] = proc.stdout[-3000:]
        if proc.returncode != 0 or not os.path.exists(summary):
            failed.append(f"{name} (rc {proc.returncode}): "
                          f"{proc.stderr[-3000:]}\n{proc.stdout[-2000:]}")
            return False
        with open(summary) as f:
            runs[name] = json.load(f)
        runs[name]["seconds"] = time.perf_counter() - t1
        runs[name]["launched_by_torchrun"] = torchrun
        return True

    def chain(*items):
        return all(cli(*item) for item in items)

    # run 1 alone (its first 3 steps traced), then two chains side by side
    # on the card: its --resume and --eval, and the runs that do not
    # depend on it (their host clocks share the machine, so no step time
    # is read from them)
    chain(("stop", ["--run_name", "ep", "--stop_after_steps", str(EP_STOP),
                    "--profile_dir", prof, "--forward_hook"]))
    if not failed:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(2) as pool:
            jobs = [pool.submit(chain, ("resume", ["--run_name", "ep",
                                                   "--resume"]),
                                ("eval", ["--run_name", "ep", "--eval"])),
                    pool.submit(chain, ("nogroup", [
                        "--run_name", "nogroup", "--stop_after_steps",
                        str(EP_STOP)], False),
                        ("one_by_one", ["--run_name", "ep_obo",
                                        "--one_by_one",
                                        "--accumulation_steps", "2",
                                        "--stop_after_steps",
                                        str(EP_OBO_CALLS)]),
                        ("tracing", ["--run_name", "ep_trace", "--flops",
                                     "--time"]))]
            for job in jobs:
                job.result()
    check(not failed, f"parallel cli runs failed: {failed}")
    if failed:
        return {"parallel_cli": {}, "parallel_cli_one_by_one": {}}
    val_batches = spe
    # run 1's --forward_hook: one eval forward over its first batch
    expected = {"stop": expected_ep_launches(EP_STOP, 1),
                "nogroup": expected_ep_launches(EP_STOP, 0, chunks=1),
                "resume": expected_ep_launches(spe - EP_STOP, val_batches),
                "eval": expected_ep_launches(0, val_batches),
                "one_by_one": expected_ep_launches(EP_OBO_CALLS, 0),
                "tracing": expected_ep_launches(0, 0)}
    # --flops' and --time's forwards on one image (1, then 1 + 5)
    expected["tracing"] = expected_ep_launches(0, 1 + 1 + 5)
    for name, exp in expected.items():
        check(runs[name]["launches"] == exp,
              f"parallel cli run {name}: launches {runs[name]['launches']}, "
              f"expected {exp}")
    r1, r0, r2, r3 = (runs[k] for k in ("stop", "nogroup", "resume", "eval"))
    check(r1.get("stopped_at_step") == EP_STOP
          and r0.get("stopped_at_step") == EP_STOP
          and r2["steps_run"] == spe - EP_STOP
          and r2.get("best") is not None
          and runs["one_by_one"].get("stopped_at_step") == EP_OBO_CALLS,
          f"parallel cli: stops {r1.get('stopped_at_step')} / "
          f"{r0.get('stopped_at_step')}, resume {r2['steps_run']} steps")
    l1, l0 = dict(map(tuple, r1["losses"])), dict(map(tuple, r0["losses"]))
    loss_rel = {s: abs(l1[s] - l0[s]) / abs(l0[s]) for s in l0 if s in l1}
    check(len(loss_rel) == EP_STOP
          and all(np.isfinite(list(l1.values())))
          and loss_rel.get(1, 1.0) <= EP_LOSS_REL_TOL,
          f"parallel cli: EP losses {l1} against no group {l0} (first step "
          f"rel limit {EP_LOSS_REL_TOL})")
    ref_leaves = dict(_leaves(r2["best"]))
    got_leaves = dict(_leaves({k: r3[k] for k in r2["best"]}))
    eval_rel = max(abs(got_leaves[k] - v) / max(abs(v), 1e-12)
                   for k, v in ref_leaves.items())
    check(got_leaves.keys() == ref_leaves.keys()
          and eval_rel <= CLI_EVAL_REL_TOL,
          f"parallel cli --eval vs the resumed run's results: max rel diff "
          f"{eval_rel} (limit {CLI_EVAL_REL_TOL})")
    # the --flops count on the card against the plain path's, same model
    tr = runs["tracing"]
    p = create_config(env, cfg, {"moe_eval_capacity_factor":
                                 parse_capacity_factor("nodrop")})
    model, _ = build_model(p, device=dev, seed=0)
    set_use_kernels(model, False)
    with torch.no_grad():
        plain_flops = flops_of(lambda: model(torch.zeros(
            1, 3, *p["train_scale"], device=dev)))
    del model
    torch.cuda.empty_cache()
    check(tr.get("flops") == plain_flops,
          f"parallel cli --flops {tr.get('flops')} on the card, the plain "
          f"path's {plain_flops}")
    hook_lines = 0
    if r1.get("forward_hook") and os.path.exists(r1["forward_hook"]):
        with open(r1["forward_hook"]) as f:
            hook_lines = sum(1 for _ in f)
    check(hook_lines > 0 and tr.get("forward_ms", 0) > 0,
          f"parallel cli tracing: forward_hook.log {hook_lines} lines, "
          f"forward {tr.get('forward_ms')} ms")
    path = os.path.join(prof, "trace.json")
    check(os.path.exists(path), f"parallel cli: no trace in {prof}")
    ep_trace = _trace_kernels(path, 3) if os.path.exists(path) else {}
    for key in EP_TRACE_KERNELS:
        check(ep_trace.get(key, {}).get("launches", 0) > 0,
              f"parallel cli: the EP run's trace shows no {key} kernel")

    emit({"phase": "parallel_cli", "config": EP_CONFIG,
          "images": EP_IMAGES, "fabricate_s": fabricate_s,
          "runs": {k: {kk: vv for kk, vv in r.items()
                       if kk not in ("best", "step_times")}
                   for k, r in runs.items()},
          "launches_expected": expected, "loss_rel_vs_nogroup": loss_rel,
          "eval_vs_resume_max_rel": eval_rel, "plain_flops": plain_flops,
          "peak_memory_gb": {k: runs[k].get("peak_memory_bytes", 0) / 1e9
                             for k in runs},
          "trace_per_step": ep_trace, "forward_hook_lines": hook_lines,
          "log_tail": {k: v[-600:] for k, v in logs.items()}})
    return {"parallel_cli": r1["launches"],
            "parallel_cli_one_by_one": runs["one_by_one"]["launches"]}


def parallel_phase(dev, root: str):
    """The parallel paths in turn over a one-rank NCCL group made here:
    the exchange against the local FFN, the EP step in steady state with
    and without the group, then the EP config through torchrun; their
    launches by path."""
    import torch.distributed as dist

    from m3vit_tpu_torch import parallel

    t0 = time.perf_counter()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{parallel.mesh.free_port()}",
        rank=0, world_size=1, device_id=dev)
    try:
        layout = parallel.make_layout(1, 1, dev)
        paths = ep_dispatch_phase(dev, layout)
        torch.cuda.empty_cache()
        paths.update(ep_step_phase(dev, layout))
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    paths.update(parallel_cli_phase(dev, root))
    phase_s = time.perf_counter() - t0
    check(phase_s < PARALLEL_PHASE_LIMIT_S,
          f"parallel phases took {phase_s:.1f} s (limit "
          f"{PARALLEL_PHASE_LIMIT_S})")
    emit({"phase": "parallel_total", "seconds": phase_s})
    return paths


# the phases, in order, by the names `--only` takes: the kernels against
# their plain versions, the flagship's paths, the CLI and the training
# recipe on its tree, the wider model families, and data and expert
# parallelism
PHASES = ("kernels", "flagship", "cli", "wide", "parallel")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run, of "
                         f"{','.join(PHASES)} (default: all); a partial run "
                         "prints no ok line")
    args = ap.parse_args(argv)
    only = [ph for ph in args.only.split(",") if ph]
    if not set(only) <= set(PHASES) or not only:
        ap.error(f"--only takes phases of {PHASES}, got {args.only!r}")
    full = set(only) == set(PHASES)   # a partial run drops absent paths
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: full f32
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    peaks = peaks_for(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "bf16_flops": peaks[0],
          "hbm_bytes_per_s": peaks[1]})

    t0 = time.perf_counter()
    per_source = _build.build_all()
    ptxas = [ln.strip() for k in _build.kernel_names()
             for ln in _build.compile_log(k).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "ptxas": ptxas})
    for k in _build.kernel_names():
        log = _build.compile_log(k)
        spilled = [ln.strip() for ln in log.splitlines()
                   if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
        serial = [ln.strip() for ln in log.splitlines() if "serialized" in ln]
        check(not spilled and not serial,
              f"{k}: ptxas reports spills {spilled} or serialised wgmma "
              f"{serial}")

    cases = {}
    if "kernels" in only:
        cases = {"flash_attention_fwd": attention_phase(peaks, dev),
                 "expert_ffn_fwd": ffn_phase(peaks, dev),
                 "flash_attention_bwd": attention_bwd_phase(peaks, dev),
                 "expert_ffn_bwd": ffn_bwd_phase(peaks, dev),
                 "expert_ffn_q_fwd": ffn_q_phase(peaks, dev),
                 "ln_mlp_fwd": ln_mlp_fwd_phase(peaks, dev),
                 "ln_mlp_bwd": ln_mlp_bwd_phase(peaks, dev)}
    paths = {}
    if "flagship" in only:
        paths.update(serving=serving_phase(dev), train=train_phase(dev),
                     int8_serving=int8_serving_phase(dev))
        paths["ln_mlp_serving"], paths["ln_mlp_train"] = \
            ln_mlp_path_phase(dev)
        for path, phase in (("one_by_one", one_by_one_phase),
                            ("accumulation", accumulation_phase),
                            ("noisy_gate_train", noisy_gate_phase),
                            ("eval_nodrop", eval_nodrop_phase)):
            paths[path] = phase(dev)
            torch.cuda.empty_cache()
        paths["dense_serving"], paths["dense_train"] = dense_phase(dev)
        torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        if "cli" in only:
            paths["cli"], paths["cli_synthetic_step"] = cli_phase(dev, root)
            torch.cuda.empty_cache()
            paths.update(recipe_phase(dev, root))
            torch.cuda.empty_cache()
        if "wide" in only:
            wide_root = os.path.join(root, "wide")
            os.makedirs(wide_root)
            paths.update(wide_phase(dev, wide_root))
            torch.cuda.empty_cache()
        if "parallel" in only:
            ep_root = os.path.join(root, "parallel")
            os.makedirs(ep_root)
            paths.update(parallel_phase(dev, ep_root))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    kernels = []
    # kernel, its TPU kernel, its paths (the first is the one whose count
    # is "launches")
    train_paths = ("train", "ln_mlp_train", "one_by_one", "accumulation",
                   "noisy_gate_train", "dense_train", "cli", "recipe_moe",
                   "recipe_dense_tam")
    wide_train = ("wide_cli", "wide_cli_ln_mlp", "wide_cli_synthetic_step",
                  "wide_cli_ln_mlp_synthetic_step", "vit_large_train",
                  "vit_tiny_train", "parallel_step", "parallel_cli",
                  "parallel_cli_one_by_one")
    wide_serving = ("wide_serving", "wide_int8_serving", "vit_large_serving",
                    "vit_tiny_serving")
    fwd_paths = train_paths[:1] + ("serving", "int8_serving",
                                   "ln_mlp_serving") + train_paths[1:] + (
        "eval_nodrop", "dense_serving", "recipe_dropout_eval")
    # the dropout step's training runs K1 and K2 only (the plain FFNs)
    for kname, line, on in (
            ("flash_attention_fwd", "flash_attention.py:103",
             fwd_paths + ("recipe_dropout_train",) + wide_train
             + ("vit_large_ln_mlp_train",) + wide_serving),
            ("flash_attention_bwd", "flash_attention.py:125",
             train_paths + ("recipe_dropout_train",) + wide_train
             + ("vit_large_ln_mlp_train",)),
            ("expert_ffn_fwd", "expert_ffn.py:145",
             fwd_paths + wide_train + wide_serving + ("parallel_dispatch",)),
            ("expert_ffn_bwd", "expert_ffn.py:203",
             train_paths + wide_train + ("parallel_dispatch",)),
            ("ln_mlp_fwd", "ln_mlp.py:129",
             ("ln_mlp_train", "ln_mlp_serving", "wide_cli_ln_mlp",
              "wide_cli_ln_mlp_synthetic_step", "vit_large_ln_mlp_train")),
            ("ln_mlp_bwd", "ln_mlp.py:183",
             ("ln_mlp_train", "wide_cli_ln_mlp",
              "wide_cli_ln_mlp_synthetic_step", "vit_large_ln_mlp_train")),
            ("expert_ffn_q_fwd", "expert_ffn.py:334",
             ("int8_serving", "wide_int8_serving"))):
        by_path = {p: paths[p].get(kname, 0) for p in on
                   if full or p in paths}
        for p, n in by_path.items():
            check(n > 0, f"{kname} was not launched on the {p} path")
        if not full and kname not in cases:
            continue
        kcases = cases[kname]
        main_case = kcases[0]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"m3vit_tpu_torch/csrc/{kname}.cu",
            "replaces": f"m3vit_tpu/ops/{line}",
            "launches": by_path.get(on[0], 0),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in kcases),
            **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "cases": kcases,
        })
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    if kernels:
        emit({"kernels": kernels})
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    if not full:
        print(f"chip_smoke: partial run ({','.join(only)}): no ok line",
              file=sys.stderr)
        return 0
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
