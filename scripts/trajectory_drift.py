"""How far f32 rounding alone moves the 5-step trajectory of
tests/test_torch_port_train.py::test_train_trajectory_matches_jax.

    JAX_PLATFORMS=cpu python scripts/trajectory_drift.py [--other_draw]

Runs the test's trajectory (the JAX package and the port from the same
weights, JAX's head ReLU masks replayed in the port) and prints the
largest final-parameter gap, then the gaps that f32 rounding alone makes:
JAX's own program at XLA's default optimisation level against the lowest
(which the test compiles at), and each side again from weights perturbed
by a relative 6e-8 (f32 rounding) against itself.  --other_draw
initialises the heads' truncated-normal convolution kernels by redrawing
only the out-of-range values (the same distribution, other numbers).
Minutes on a CPU; imports JAX, so it is a test-side tool, not the port's.
"""
import argparse
import os
import sys

import numpy as np
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ap = argparse.ArgumentParser()
ap.add_argument("--other_draw", action="store_true")
if ap.parse_args().other_draw:
    import math

    from m3vit_tpu_torch.models import heads, tam

    def init_conv_lecun(weight, fan_in, gen):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        with torch.no_grad():
            w = torch.empty(weight.shape).normal_(0.0, std, generator=gen)
            bad = w.abs() > 2 * std
            while bad.any():
                w[bad] = torch.empty(int(bad.sum())).normal_(
                    0.0, std, generator=gen)
                bad = w.abs() > 2 * std
            weight.copy_(w)

    heads.init_conv_lecun = tam.init_conv_lecun = init_conv_lecun
from tests.test_torch_port_train import (jax_parse, TASK_DICT, B, IMG, _labels,
    parse_task_dictionary, build_flagship, ARCH, TRAIN, reference_mtl_sd_to_params,
    jax_build_flagship, jax_build_optimizer, OPT, TrainState, jax_make_train_step,
    jax_loss_fn, WEIGHTS, FAST_COMPILE, _jit, capture_bn, head_masks, STEPS,
    build_optimizer, make_train_step, loss_fn_for_task, _nchw, replay_head_masks,
    jax_variables_to_state_dict)

jtasks = jax_parse("PASCALContext", TASK_DICT)[0]
names = [tk.name for tk in jtasks]
rng = np.random.RandomState(9)
img = rng.randn(B, IMG, IMG, 3).astype(np.float32)
batch = {"image": img, **_labels(rng, B, IMG, IMG, jtasks)}
tasks = parse_task_dictionary("PASCALContext", TASK_DICT)[0]
model0, _ = build_flagship(tasks=tasks, dtype=torch.float32, device="cpu", seed=1, **ARCH, **TRAIN)
sd0 = {k: v.clone() for k, v in model0.state_dict().items()}

def perturbed(sd, eps, seed):
    g = np.random.RandomState(seed)
    out = {}
    for k, v in sd.items():
        if v.is_floating_point() and "running" not in k:
            a = v.numpy().astype(np.float64)
            out[k] = torch.from_numpy((a * (1 + eps * g.randn(*a.shape))).astype(np.float32))
        else:
            out[k] = v.clone()
    return out

jmodel, _ = jax_build_flagship(tasks=jtasks, dtype=jnp.float32, use_checkpointing=False, **ARCH, **TRAIN)
jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

def jax_run(sd, opts):
    params, stats = reference_mtl_sd_to_params(
        {k: v.numpy().copy() for k, v in sd.items() if not k.endswith("num_batches_tracked")},
        names, multi_gate_tasks=len(names))
    tx = jax_build_optimizer(OPT, steps_per_epoch=2)
    state = _jit(lambda p, s: TrainState.create(apply_fn=jmodel.apply, params=p, tx=tx, batch_stats=s))(params, stats)
    jstep = jax_make_train_step(jmodel, names, {n: jax_loss_fn(n, {"edge_w": 0.95}) for n in names}, WEIGHTS, donate=False)
    low = jstep.lower(state, jbatch, jax.random.key(0))
    jstep = low.compile(opts) if opts is not None else low.compile()
    bn_out = _jit(lambda params, stats, img: jmodel.apply(
        {"params": params, "batch_stats": stats}, img, train=True,
        rngs={"gate_noise": jax.random.key(0)}, mutable=["batch_stats"],
        capture_intermediates=capture_bn)[1]["intermediates"])
    masks = []
    for i in range(STEPS):
        masks.append(head_masks(bn_out(state.params, state.batch_stats, jbatch["image"]), names))
        state, m = jstep(state, jbatch, jax.random.key(i))
    final = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return jax_variables_to_state_dict(final, tasks, len(tasks)), masks

def port_run(sd, masks, dtype=torch.float32):
    model, _ = build_flagship(tasks=tasks, dtype=dtype, device="cpu", seed=1, **ARCH, **TRAIN)
    model.load_state_dict(sd)
    opt, schedule = build_optimizer(model.parameters(), OPT, steps_per_epoch=2)
    step = make_train_step(model, names, {n: loss_fn_for_task(n, {"edge_w": 0.95}) for n in names}, WEIGHTS, opt, schedule)
    tbatch = {k: _nchw(v) for k, v in batch.items()}
    for i in range(STEPS):
        with replay_head_masks(model, masks[i]):
            step(tbatch)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}

def diff(a, b, what):
    worst = []
    for k, v in a.items():
        if k.endswith("num_batches_tracked") or "running" in k:
            continue
        worst.append(((a[k].double() - b[k].double()).abs().max().item(), k))
    worst.sort(reverse=True)
    key = "decoders.normals.conv_4.weight"
    print(f"{what}: normals.conv_4.weight {(a[key].double()-b[key].double()).abs().max().item():.3e}; worst {worst[:3]}", flush=True)

def mask_flips(m1, m2):
    return sum(int((x != y).sum()) for i in range(len(m1)) for n in m1[i] for x, y in zip(m1[i][n], m2[i][n]))

J0, M0 = jax_run(sd0, FAST_COMPILE)
P0 = port_run(sd0, M0)
diff(P0, J0, "A port vs JAX (the test)")
Jfull, Mfull = jax_run(sd0, None)
diff(Jfull, J0, "D JAX default XLA opts vs JAX lowest level")
print("   mask flips D:", mask_flips(M0, Mfull))
for seed in (1, 2):
    sdp = perturbed(sd0, 6e-8, seed)
    Jp, Mp = jax_run(sdp, FAST_COMPILE)
    diff(Jp, J0, f"B{seed} JAX perturbed 6e-8 vs JAX")
    print("   mask flips B:", mask_flips(M0, Mp))
    Pp = port_run(sdp, M0)
    diff(Pp, P0, f"C{seed} port perturbed 6e-8 vs port (JAX masks replayed)")
