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
  the same weights, with timed steps.
Each phase prints one JSON line; the line before the last is nvidia-smi's
card name and power limit, and the last line is {"ok": true, "device":
{...}}.  Any failed check exits non-zero before that line; without CUDA the
script exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from m3vit_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from m3vit_tpu_torch.losses.functions import loss_fn_for_task  # noqa: E402
from m3vit_tpu_torch.losses.schemes import multi_task_loss  # noqa: E402
from m3vit_tpu_torch.models import build_flagship, set_use_kernels  # noqa: E402
from m3vit_tpu_torch.models import vit_moe  # noqa: E402
from m3vit_tpu_torch.moe.gating import noisy_vmoe_gate, small_topk  # noqa: E402
from m3vit_tpu_torch.ops import _build  # noqa: E402
from m3vit_tpu_torch.ops.expert_ffn import (  # noqa: E402
    BWD_KSTEP,
    bwd_plan,
    dequantize_weight,
    expert_ffn_bwd,
    expert_ffn_bwd_plain,
    expert_ffn_fwd,
    expert_ffn_q_dequant,
    expert_ffn_q_fwd,
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
from m3vit_tpu_torch.train.step import make_train_step  # noqa: E402

BUCKETS = (1, 2, 4, 8)
IMG = 512
ATTN_TOL = 2e-2          # JAX package's bf16 tolerance (test_flash_attention.py:53)
LSE_TOL = 1e-3           # K1's lse: f32 sums of the same bf16 products, lse ~ 7-10
FFN_ABS_TOL, FFN_REL_TOL = 2e-2, 1e-2
AGREE_MIN, LOGIT_REL_TOL = 0.99, 2e-2
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
LN_MLP_REQUESTS = 100    # timed bucket-8 requests of the ln_mlp serving path
LOSS_WEIGHTS = {"semseg": 1.0, "human_parts": 2.0, "sal": 5.0, "edge": 50.0,
                "normals": 10.0}
# bench.py:316-322: SGD, lr 0.002, momentum 0.9, wd 1e-4, poly over 100
# epochs of 100 steps
OPTIM = {"optimizer": "sgd", "scheduler": "poly", "epochs": 100,
         "optimizer_kwargs": {"lr": 0.002, "momentum": 0.9,
                              "weight_decay": 1e-4}}

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
                  ("dh", "ffn_bwd_gemm_kernel<0"),
                  ("dw1_dw2", "ffn_bwd_gemm_kernel<1"),
                  ("dx", "ln_dx_kernel"), ("sums", "sum_parts_kernel"))


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


def ffn_phase(peaks, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    cases = []
    # expert banks at the serving capacity (cf 2.0) and the train capacity
    # (cf 1.25), and the dense MLP at E=1; B=8, 1025 tokens per image
    for name, E, Ct, d, Hd in (("experts", 16, 4104, 384, 384),
                               ("dense_mlp", 1, 8200, 384, 1536),
                               ("experts_train", 16, 2568, 384, 384)):
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
        })
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
                               ("dense_mlp", 1, 8200, 384, 1536)):
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
                               ("bucket_1", 16, 520, 384, 384)):
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
                                    FFN_Q_PASSES),
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
    """K5 at the dense blocks' shape."""
    x, gamma, beta, w1, b1, w2, b2, _ = ln_mlp_inputs(dev, 5)
    args = (x, gamma, beta, w1, b1, w2, b2)
    S, d = x.shape
    H = w1.shape[0]
    got = ln_mlp_fwd(*args)
    same = torch.equal(got, ln_mlp_fwd(*args))
    ref = ln_mlp_residual_plain(*args)
    diff = got.float() - ref.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.float().norm()).item()
    check(err <= FFN_ABS_TOL and rel <= FFN_REL_TOL and same
          and bool(torch.isfinite(got).all()),
          f"ln_mlp_fwd: max abs err {err}, rel {rel}, bitwise repeatable "
          f"{same}")
    flops = 4.0 * S * d * H
    nbytes = 2.0 * 2 * S * d + 2.0 * 2 * d * H + 4.0 * (3 * d + H)
    b_ms, b_by = bound(flops, nbytes, peaks)
    ms, host_ms = time_calls(lambda: ln_mlp_fwd(*args))
    cases = [{
        "shape": f"x [{S},{d}] bf16 x hidden {H}",
        "max_abs_err": err, "rel_err": rel, "bitwise_repeatable": same,
        "ms": ms, "host_ms": host_ms, "tflops": flops / ms / 1e9,
        "plain_ms": time_ms(lambda: ln_mlp_residual_plain(*args), 20),
        "library_ms": None,
        "yardstick_layer_norm_linear_gelu_linear_add_ms":
            time_ms(lambda: library_ln_mlp(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
        "mbytes": nbytes / 1e6,
    }]
    emit({"phase": "ln_mlp_fwd", "cases": cases})
    return cases


def ln_mlp_bwd_phase(peaks, dev):
    """K6 at the dense blocks' shape."""
    x, gamma, beta, w1, b1, w2, b2, gr = ln_mlp_inputs(dev, 6)
    args = (x, gamma, beta, w1, b1, w2, gr)
    S, d = x.shape
    H = w1.shape[0]
    got = ln_mlp_bwd(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, ln_mlp_bwd(*args)))
    check(same, "ln_mlp_bwd: two runs differ")
    ref = ln_mlp_residual_bwd_plain(*args)
    errs = {k: check_grads(a, b, f"ln_mlp_bwd {k}")
            for k, a, b in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2",
                                "db2"), got, ref)}
    # the yardstick's autograd backward, its graph built once
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, gamma, beta, w1, b1, w2, b2)]
    out = library_ln_mlp(*leaves)
    flops = 10.0 * S * d * H
    nbytes = (2.0 * 3 * S * d + 2.0 * 2 * d * H + 4.0 * 2 * d * H
              + 4.0 * (2 * d + H) + 4.0 * (3 * d + H))
    b_ms, b_by = bound(flops, nbytes, peaks)
    ms, host_ms = time_calls(lambda: ln_mlp_bwd(*args))
    plan = bwd_plan(1, S, d, H,
                    torch.cuda.get_device_properties(dev).multi_processor_count)
    cases = [{
        "shape": f"x [{S},{d}] bf16 x hidden {H}", **errs,
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "bitwise_repeatable": same,
        "ms": ms, "host_ms": host_ms, "tflops": flops / ms / 1e9,
        "passes_ms": pass_times(lambda: ln_mlp_bwd(*args)),
        "call_memory_mb": call_memory_mb(lambda: ln_mlp_bwd(*args)),
        "plain_ms": time_ms(lambda: ln_mlp_residual_bwd_plain(*args), 10),
        "library_ms": None,
        "yardstick_autograd_backward_ms": time_ms(
            lambda: torch.autograd.grad(out, leaves, gr, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
        "mbytes": nbytes / 1e6,
    }]
    emit({"phase": "ln_mlp_bwd", "cases": cases, "plan": plan._asdict()})
    return cases


def time_requests(sess, x, post: bool, n: int):
    """One untimed and `n` timed semseg requests of the batch `x` (numpy);
    checks the last output and returns its latency row."""
    b = x.shape[0]
    out = sess.predict(x, "semseg", postprocess=post)
    lats = []
    t_window = time.perf_counter()
    for _ in range(n):
        t0 = time.perf_counter()
        out = sess.predict(x, "semseg", postprocess=post)
        lats.append((time.perf_counter() - t0) * 1e3)
    window_s = time.perf_counter() - t_window
    if post:
        check(out.shape == (b, IMG, IMG) and out.dtype == np.uint8
              and int(out.max()) < 21,
              f"bucket {b} class map {out.shape} {out.dtype}")
    else:
        check(out.shape == (b, IMG, IMG, 21)
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
                ("heads", "decoders."))


def param_group(name: str) -> str:
    return next((g for g, key in PARAM_GROUPS if key in name),
                "embed_and_norms")


class RoutingTape:
    """Records every gate's top-(k+1) experts during one forward and
    replays them, in call order, during another, so that two forwards whose
    roundings differ route every token alike.  Replayed gate values are the
    replaying forward's own softmax probabilities at the recorded experts,
    so the gates stay differentiable.  Counts the tokens whose own top-k set
    differs from the recording.  Installed in place of the MoE block's gate
    function; for this script's comparisons only."""

    def __init__(self):
        self.tape, self.replaying, self.pos = [], False, 0
        self.tokens = self.rerouted = 0

    def __enter__(self):
        vit_moe.noisy_vmoe_gate = self.gate
        self.pos = 0
        return self

    def __exit__(self, *exc):
        vit_moe.noisy_vmoe_gate = noisy_vmoe_gate
        if not exc[0] and self.replaying and self.pos != len(self.tape):
            raise RuntimeError(f"replayed {self.pos} of {len(self.tape)} "
                               "gate calls")
        self.replaying = True

    def gate(self, gate_inp, w_gate, *, top_k, noise_std=1.0, noise=None):
        out = noisy_vmoe_gate(gate_inp, w_gate, top_k=top_k,
                              noise_std=noise_std, noise=noise)
        probs = torch.softmax(out.noisy_logits, dim=-1)
        if not self.replaying:
            self.tape.append(small_topk(probs.detach(),
                                        out.top_logits.shape[1])[1])
            return out
        idx = self.tape[self.pos]
        self.pos += 1
        own = out.top_k_indices.sort(dim=-1).values
        self.rerouted += int((own != idx[:, :top_k].sort(dim=-1).values)
                             .any(dim=-1).sum())
        self.tokens += idx.shape[0]
        top = probs.gather(1, idx)
        return out._replace(top_k_indices=idx[:, :top_k],
                            top_k_gates=top[:, :top_k], top_logits=top)


def expected_train_launches(depth: int, num_tasks: int,
                            ln_mlp: bool = False):
    """Launches per shared-prefix train step (vit_moe.py:1064-1091): block
    0 and block 1's attention once, the rest once per task; even blocks
    dense (K3/K4 at E=1, or K5/K6 with ln_mlp), odd blocks MoE; each
    forward launch has one backward launch."""
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
    one dense MLP per even block, one expert FFN per odd block."""
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


def train_setup(dev, **knobs):
    """The shared-prefix flagship (seed 0, `knobs` passed to
    build_flagship), its B=8 synthetic batch, loss functions, a copy of
    its initial state and the random cotangent for backbone runs."""
    model, tasks = build_flagship(device=dev, seed=0, shared_prefix=True,
                                  **knobs)
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
            lambda mod, args, out: feats.append(out[0]))
        with tape or contextlib.nullcontext():
            if mode == "backbone":
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
        return loss, {n: p.grad.detach().float().clone()
                      for n, p in m.named_parameters()
                      if p.grad is not None}, extra

    return run


def timed_steps(model, names, loss_fns, batch, dev, expected, what: str):
    """TIMED_STEPS train steps on one batch, each between CUDA events, with
    the kernels' launches counted over them and held to `expected` per
    step; returns (the phase's readings, the launches)."""
    opt, schedule = build_optimizer(model.parameters(), OPTIM,
                                    steps_per_epoch=100)
    step = make_train_step(model, names, loss_fns, LOSS_WEIGHTS, opt,
                           schedule)
    noise = torch.Generator(device=dev).manual_seed(2)
    for _ in range(2):   # warm-up
        step(batch, noise)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(TIMED_STEPS)]
    _build.reset_launches()            # the train path starts here
    t_window = time.perf_counter()
    for a, b in ev:
        a.record()
        m = step(batch, noise)
        b.record()
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t_window
    launches = dict(_build.launches)   # ... and ends here
    check(bool(torch.isfinite(m["loss_total_with_cv"])),
          f"{what} timed step loss")
    per_step = check_launches(launches, TIMED_STEPS, expected, what)
    step_ms = [a.elapsed_time(b) for a, b in ev]
    median = float(np.median(step_ms))
    prof = device_profile(lambda: step(batch, noise))
    return {"batch": TRAIN_BATCH, "steps": TIMED_STEPS,
            "step_ms_median": median, "step_ms": step_ms,
            "device_ms_per_step": prof["device_ms"],
            "device_idle_frac": 1.0 - prof["device_ms"] / median,
            "top_kernels": prof["top"],
            "img_per_s": TIMED_STEPS * TRAIN_BATCH / window_s,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": per_step,
            "moe_dropped_frac": m["moe_dropped_frac"].item()}, launches


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


def main() -> int:
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

    attn = attention_phase(peaks, dev)
    ffn = ffn_phase(peaks, dev)
    attn_bwd = attention_bwd_phase(peaks, dev)
    ffn_bwd = ffn_bwd_phase(peaks, dev)
    ffn_q = ffn_q_phase(peaks, dev)
    ln_fwd = ln_mlp_fwd_phase(peaks, dev)
    ln_bwd = ln_mlp_bwd_phase(peaks, dev)
    paths = {"serving": serving_phase(dev), "train": train_phase(dev),
             "int8_serving": int8_serving_phase(dev)}
    paths["ln_mlp_serving"], paths["ln_mlp_train"] = ln_mlp_path_phase(dev)

    kernels = []
    # kernel, its TPU kernel, its phase's cases, its paths (the first is
    # the one whose count is "launches")
    for kname, line, cases, on in (
            ("flash_attention_fwd", "flash_attention.py:103", attn,
             ("train", "serving", "int8_serving", "ln_mlp_serving",
              "ln_mlp_train")),
            ("flash_attention_bwd", "flash_attention.py:125", attn_bwd,
             ("train", "ln_mlp_train")),
            ("expert_ffn_fwd", "expert_ffn.py:145", ffn,
             ("train", "serving", "int8_serving", "ln_mlp_serving",
              "ln_mlp_train")),
            ("expert_ffn_bwd", "expert_ffn.py:203", ffn_bwd,
             ("train", "ln_mlp_train")),
            ("ln_mlp_fwd", "ln_mlp.py:129", ln_fwd,
             ("ln_mlp_train", "ln_mlp_serving")),
            ("ln_mlp_bwd", "ln_mlp.py:183", ln_bwd, ("ln_mlp_train",)),
            ("expert_ffn_q_fwd", "expert_ffn.py:334", ffn_q,
             ("int8_serving",))):
        by_path = {p: paths[p].get(kname, 0) for p in on}
        for p, n in by_path.items():
            check(n > 0, f"{kname} was not launched on the {p} path")
        main_case = cases[0]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"m3vit_tpu_torch/csrc/{kname}.cu",
            "replaces": f"m3vit_tpu/ops/{line}", "launches": by_path[on[0]],
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "cases": cases,
        })
    emit({"kernels": kernels})
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
