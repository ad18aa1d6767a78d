#!/usr/bin/env python3
"""Times the port's int8-weight expert FFN (K7, ``expert_ffn_q_fwd``) on one
NVIDIA GPU at the int8 serving path's expert shapes (buckets 8 and 1), and a
bucket-8 int8 serving request of the flagship, with the kernels of the
checkout at ``--root`` (default: this one):

    python3 scripts/time_ffn_q.py [--root DIR] [--label NAME]

Run it for two checkouts in turns (a, b, b, a) inside one machine to
compare them on one card.  Each shape is held against its plain version
(K3's tolerances: 2e-2 abs, 1e-2 relative Frobenius) and run twice for the
same bits; beside K7 it times the dequantize -> bmm -> GELU -> bmm chain,
K3 on the dequantized bf16 banks and, where the checkout has one, K7's
dequantizing pass alone.  Kernel times are device ms per call from one pair
of CUDA events around 50 queued calls (as chip_smoke.py's time_calls).  The
request is the seeded flagship with its expert banks quantized, served
uint8 in / class map out: p50 of 20 requests on the host clock, the device
time of one (torch.profiler, 5 requests), and the peak device memory over
those requests.  Prints one JSON line with the card's name and power
limit; exits non-zero when a check fails or there is no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from time_ffn_fwd import time_ms  # this script's directory is on sys.path


def device_ms(torch, fn, n: int = 5) -> float:
    """Device time per call of fn: every kernel, copy and fill the card ran
    in n calls under torch.profiler, summed, over n."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / n


def request_row(torch, np, dev):
    from m3vit_tpu_torch.models import build_flagship
    from m3vit_tpu_torch.serve import InferenceSession
    from m3vit_tpu_torch.serve.quantize import quantize_expert_state_dict

    fmodel, tasks = build_flagship(device=dev, seed=0)
    qsd = quantize_expert_state_dict(fmodel.state_dict())
    del fmodel
    model, _ = build_flagship(device=dev, seed=0, expert_weights_int8=True)
    model.load_state_dict(qsd, strict=True)
    del qsd
    sess = InferenceSession(model, [t.name for t in tasks], (512, 512),
                            buckets=(8,), raw_uint8_input=True, device=dev)
    u8 = np.random.RandomState(10).randint(0, 256, (8, 512, 512, 3)).astype(
        np.uint8)
    sess.predict(u8, "semseg", postprocess=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lats = []
    for _ in range(20):
        t0 = time.perf_counter()
        out = sess.predict(u8, "semseg", postprocess=True)
        lats.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e6
    ok = out.shape == (8, 512, 512) and int(out.max()) < 21
    return {"bucket": 8, "p50_ms": float(np.median(lats)),
            "device_ms_per_request": device_ms(
                torch, lambda: sess.predict(u8, "semseg", postprocess=True)),
            "peak_memory_mb": peak, "ok": bool(ok)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("time_ffn_q: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from m3vit_tpu_torch.ops import _build
    from m3vit_tpu_torch.ops import expert_ffn as ops
    from m3vit_tpu_torch.serve.quantize import quantize_weight

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dequant = getattr(ops, "expert_ffn_q_dequant", None)
    g = torch.Generator(device=dev).manual_seed(4)
    r = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
    cases, ok = [], True
    for name, E, Ct, d, Hd in (("bucket_8", 16, 4104, 384, 384),
                               ("bucket_1", 16, 520, 384, 384)):
        h = r(E, Ct, d).bfloat16()
        q1, s1 = quantize_weight(r(E, Hd, d) * d ** -0.5)
        q2, s2 = quantize_weight(r(E, d, Hd) * 0.5 * Hd ** -0.5)
        b1, b2 = r(E, Hd) * 0.1, r(E, d) * 0.1
        qargs = (h, q1, s1, b1, q2, s2, b2)
        got, again = ops.expert_ffn_q_fwd(*qargs), ops.expert_ffn_q_fwd(*qargs)
        ref = ops.quantized_expert_ffn_plain(*qargs)
        diff = got.float() - ref.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / ref.float().norm()).item()
        same = torch.equal(got, again)
        good = (err <= 2e-2 and rel <= 1e-2 and same
                and bool(torch.isfinite(got).all()))
        ok &= good
        w1 = ops.dequantize_weight(q1, s1).bfloat16()
        w2 = ops.dequantize_weight(q2, s2).bfloat16()
        b1h, b2h = b1.bfloat16()[:, None], b2.bfloat16()[:, None]

        def chain():
            v1 = ops.dequantize_weight(q1, s1).bfloat16()
            v2 = ops.dequantize_weight(q2, s2).bfloat16()
            a = F.gelu(torch.baddbmm(b1h, h, v1.transpose(1, 2)))
            return torch.baddbmm(b2h, a, v2.transpose(1, 2))

        cases.append({
            "shape": f"{name}: [{E},{Ct},{d}] x hidden {Hd}, int8 weights",
            "ms": time_ms(torch, lambda: ops.expert_ffn_q_fwd(*qargs)),
            "dequant_ms": None if dequant is None else time_ms(
                torch, lambda: dequant(q1, s1, q2, s2), 100),
            "k3_on_dequantized_banks_ms": time_ms(
                torch, lambda: ops.expert_ffn_fwd(h, w1, b1, w2, b2)),
            "chain_ms": time_ms(torch, chain),
            "max_abs_err": err, "rel_err": rel, "bitwise_repeatable": same,
            "ok": good})
    req = request_row(torch, np, dev)
    ok &= req["ok"]
    print(json.dumps({"label": args.label or args.root, "nvidia_smi": smi,
                      "cases": cases, "int8_request": req}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
