#!/usr/bin/env python3
"""Times the port's fused-FFN forward kernels on one NVIDIA GPU: K3
(``expert_ffn_fwd``: the expert banks at the serving and train capacities,
the dense MLP at E=1) and K5 (``ln_mlp_fwd``), at the flagship's shapes,
with the kernels of the checkout at ``--root`` (default: this one):

    python3 scripts/time_ffn_fwd.py [--root DIR] [--label NAME]

Run it for two checkouts in turns (a, b, b, a) inside one machine to
compare them on one card.  Each shape is held against its plain version
(K3's tolerances: 2e-2 abs, 1e-2 relative Frobenius) and run twice for the
same bits; the time is device ms per call from one pair of CUDA events
around 50 queued calls (as chip_smoke.py's time_calls).  Prints one JSON
line with the card's name and power limit; exits non-zero when a check
fails or there is no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def time_ms(torch, fn, reps: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per_call = time.perf_counter() - t0
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(int(2e9 * min(2 * per_call * reps + 1e-3, 1.0)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("time_ffn_fwd: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from m3vit_tpu_torch.ops import _build
    from m3vit_tpu_torch.ops.expert_ffn import (expert_ffn_fwd,
                                                fused_expert_ffn_plain)
    from m3vit_tpu_torch.ops.ln_mlp import ln_mlp_fwd, ln_mlp_residual_plain

    dev = torch.device("cuda")
    _build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(1)
    r = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
    cases, ok = [], True
    for name, E, Ct, d, Hd in (("experts", 16, 4104, 384, 384),
                               ("experts_train", 16, 2568, 384, 384),
                               ("dense_mlp", 1, 8200, 384, 1536),
                               ("ln_mlp", 1, 8200, 384, 1536)):
        h = r(E, Ct, d).bfloat16()
        w1 = (r(E, Hd, d) * d ** -0.5).bfloat16()
        w2 = (r(E, d, Hd) * 0.5 * Hd ** -0.5).bfloat16()
        b1, b2 = r(E, Hd) * 0.1, r(E, d) * 0.1
        if name == "ln_mlp":
            gamma, beta = 1.0 + 0.1 * r(d), 0.1 * r(d)
            xargs = (h[0], gamma, beta, w1[0], b1[0], w2[0], b2[0])
            fn = lambda: ln_mlp_fwd(*xargs)  # noqa: E731
            ref = ln_mlp_residual_plain(*xargs)
        else:
            fn = lambda: expert_ffn_fwd(h, w1, b1, w2, b2)  # noqa: E731
            ref = fused_expert_ffn_plain(h, w1, b1, w2, b2)
        got, again = fn(), fn()
        diff = got.float() - ref.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / ref.float().norm()).item()
        same = torch.equal(got, again)
        good = (err <= 2e-2 and rel <= 1e-2 and same
                and bool(torch.isfinite(got).all()))
        ok &= good
        cases.append({"shape": f"{name}: [{E},{Ct},{d}] x hidden {Hd}",
                      "ms": time_ms(torch, fn), "max_abs_err": err,
                      "rel_err": rel, "bitwise_repeatable": same,
                      "ok": good})
    print(json.dumps({"label": args.label or args.root, "nvidia_smi": smi,
                      "cases": cases}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
