"""The port's train path against the JAX package's (CPU, f32).

Each backward (K2's and K4's plain versions, dispatch, combine, the train
gate's balance loss), the losses, SGD, a PUP head in train mode and one
whole train step of a tiny flagship are held against the JAX package on the
same numpy inputs made from a seed.  The JAX kernels run in Pallas
interpret mode, as the JAX package's own CPU tests run them; the JAX model
runs its plain paths.  Tolerances: the JAX package's own (flash attention
grads 1e-4, tests/test_flash_attention.py:65; FFN grads 1e-3,
tests/test_pallas_ffn.py:44); 1e-5 where both sides compute the same f32
expression in another order; the train step as stated at its test.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import build_flagship as jax_build_flagship
from m3vit_tpu.losses.functions import loss_fn_for_task as jax_loss_fn
from m3vit_tpu.models.heads import VisionTransformerUpHead as JaxHead
from m3vit_tpu.moe import dispatch as jdisp
from m3vit_tpu.moe import gating as jgate
from m3vit_tpu.ops.expert_ffn import fused_dense_mlp as jax_dense_mlp
from m3vit_tpu.ops.expert_ffn import fused_expert_ffn as jax_expert_ffn
from m3vit_tpu.ops.flash_attention import flash_attention_qkv as jax_flash
from m3vit_tpu.tasks import parse_task_dictionary as jax_parse
from m3vit_tpu.train.optim import build_optimizer as jax_build_optimizer
from m3vit_tpu.train.state import TrainState
from m3vit_tpu.train.step import make_train_step as jax_make_train_step
from m3vit_tpu.utils.torch_interop import (
    reference_mtl_sd_to_params,
    reference_pup_head_sd_to_params,
)
from m3vit_tpu_torch.data.synthetic import synthetic_batch
from m3vit_tpu_torch.losses.functions import loss_fn_for_task
from m3vit_tpu_torch.models import build_flagship
from m3vit_tpu_torch.models.factory import init_weights
from m3vit_tpu_torch.models.heads import VisionTransformerUpHead
from m3vit_tpu_torch.moe import dispatch as tdisp
from m3vit_tpu_torch.moe import gating as tgate
from m3vit_tpu_torch.ops.expert_ffn import (
    expert_ffn_bwd_plain,
    fused_dense_mlp,
    fused_expert_ffn,
)
from m3vit_tpu_torch.ops.flash_attention import (
    flash_attention_lse_plain,
    flash_attention_qkv,
    flash_attention_qkv_bwd_plain,
    flash_attention_qkv_plain,
)
from m3vit_tpu_torch.tasks import parse_task_dictionary
from m3vit_tpu_torch.train.optim import build_optimizer
from m3vit_tpu_torch.train.step import make_train_step
from m3vit_tpu_torch.utils.convert import jax_variables_to_state_dict

t = torch.from_numpy


def _np(x):
    return np.asarray(x, np.float32)


def _jit_vjp(fn):
    """(primals, cotangent) -> the VJP of fn, as one jitted program."""
    return jax.jit(lambda primals, g: jax.vjp(fn, *primals)[1](g))


@pytest.mark.parametrize("valid_len", [None, 50])
def test_flash_attention_bwd_matches_jax_grad(valid_len):
    B, N, C, H = 1, 65, 128, 2          # N=65: no tile multiple
    scale = (C // H) ** -0.5
    rng = np.random.RandomState(0)
    qkv = rng.randn(B, N, 3 * C).astype(np.float32)
    dout = rng.randn(B, N, C).astype(np.float32)
    ref = _np(_jit_vjp(lambda x: jax_flash(x, H, scale, True, valid_len))(
        (jnp.asarray(qkv),), jnp.asarray(dout))[0])
    o = flash_attention_qkv_plain(t(qkv), H, scale, valid_len)
    lse = flash_attention_lse_plain(t(qkv), H, scale, valid_len)
    got = flash_attention_qkv_bwd_plain(t(qkv), o, lse, t(dout), H, scale,
                                        valid_len)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    x = t(qkv).requires_grad_()     # and through the autograd Function
    flash_attention_qkv(x, H, scale, valid_len).backward(t(dout))
    np.testing.assert_allclose(x.grad.numpy(), ref, atol=1e-4)


def _ffn_arrays(rng, E, C, d, H):
    """JAX-layout inputs: h, w1 [E, d, H], b1, w2 [E, H, d], b2, cotangent."""
    return (rng.randn(E, C, d).astype(np.float32),
            (rng.randn(E, d, H) * 0.1).astype(np.float32),
            (rng.randn(E, H) * 0.1).astype(np.float32),
            (rng.randn(E, H, d) * 0.1).astype(np.float32),
            (rng.randn(E, d) * 0.1).astype(np.float32),
            rng.randn(E, C, d).astype(np.float32))


@pytest.mark.parametrize("dense", [False, True], ids=["experts", "dense_mlp"])
def test_fused_ffn_bwd_matches_jax_grad(dense):
    E, C, d, H = (1, 40, 128, 512) if dense else (4, 40, 128, 256)
    h, w1, b1, w2, b2, g = _ffn_arrays(np.random.RandomState(1), E, C, d, H)
    args = tuple(map(jnp.asarray, (h, w1, b1, w2, b2)))
    if dense:   # fused_dense_mlp on [B, N, d] with [d, H] / [H, d] weights
        fn = lambda h, w1, b1, w2, b2: jax_dense_mlp(  # noqa: E731
            h.reshape(2, -1, d), w1[0], b1[0], w2[0], b2[0],
            interpret=True).reshape(h.shape)
    else:
        fn = lambda *a: jax_expert_ffn(*a, True)  # noqa: E731
    ref = [_np(r) for r in _jit_vjp(fn)(args, jnp.asarray(g))]
    ref[1], ref[3] = ref[1].transpose(0, 2, 1), ref[3].transpose(0, 2, 1)
    tw1, tw2 = t(w1).transpose(1, 2), t(w2).transpose(1, 2)
    got = expert_ffn_bwd_plain(t(h), tw1, t(b1), tw2, t(g))
    tol = dict(atol=1e-3, rtol=1e-3)
    for name, a, b in zip(("dh", "dw1", "db1", "dw2", "db2"), got, ref):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **tol)
    # the autograd Function (fused_dense_mlp at E=1) gives the same grads
    leaves = [x.clone().requires_grad_() for x in (t(h), tw1, t(b1), tw2,
                                                    t(b2))]
    if dense:
        out = fused_dense_mlp(leaves[0].reshape(2, -1, d), leaves[1][0],
                              leaves[2][0], leaves[3][0], leaves[4][0])
    else:
        out = fused_expert_ffn(*leaves)
    out.reshape(g.shape).backward(t(g))
    for name, x, b in zip(("dh", "dw1", "db1", "dw2", "db2"), leaves, ref):
        np.testing.assert_allclose(x.grad.numpy(), b, err_msg=name, **tol)


def _routing(rng, T, E, K):
    idx = rng.randint(0, E, (T, K)).astype(np.int32)
    idx[:, 1] = (idx[:, 0] + 1 + rng.randint(0, E - 1, T)) % E  # distinct
    return idx, rng.rand(T, K).astype(np.float32)


@pytest.mark.parametrize("which", ["dispatch", "combine"])
def test_gather_vjps_match_jax_custom_vjps(which):
    """Capacity 24 < the busiest expert's load: dropped slots included."""
    rng = np.random.RandomState(2)
    T, d, E, K, cap = 48, 16, 4, 2, 24
    idx, gates = _routing(rng, T, E, K)
    x = rng.randn(T, d).astype(np.float32)
    y = rng.randn(E * cap, d).astype(np.float32)
    jplan = jax.jit(jdisp.make_dispatch_plan, static_argnums=(1, 2))(
        jnp.asarray(idx.reshape(-1)), E, cap, jnp.asarray(gates.reshape(-1)))
    plan = tdisp.make_dispatch_plan(t(idx.reshape(-1)), E, cap,
                                    t(gates.reshape(-1)))
    assert (np.asarray(jplan.dst) == E * cap).any()
    jsrc, src = jplan.src_flat // K, plan.src_flat // K
    if which == "dispatch":
        g = rng.randn(E * cap, d).astype(np.float32)
        refs = [_np(_jit_vjp(lambda a: jdisp._dispatch_gather(
            a, jsrc, jplan.dst))((jnp.asarray(x),), jnp.asarray(g))[0])]
        leaves = [t(x).requires_grad_()]
        out = tdisp.dispatch_gather(leaves[0], src, plan.dst)
    else:
        g = rng.randn(T, d).astype(np.float32)
        refs = [_np(r) for r in _jit_vjp(lambda a, s: jdisp._combine_gather(
            a, s, jplan.dst, jsrc, jplan.w_slot))(
                (jnp.asarray(y), jnp.asarray(gates)), jnp.asarray(g))]
        leaves = [t(y).requires_grad_(), t(gates).requires_grad_()]
        out = tdisp.combine_gather(leaves[0], leaves[1], plan.dst, src,
                                   plan.w_slot)
    out.backward(t(g))
    for leaf, ref in zip(leaves, refs):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=1e-5)


def test_moe_ffn_local_grads_match_jax():
    rng = np.random.RandomState(3)
    T, d, H, E, K, cap = 64, 128, 64, 4, 2, 32
    idx, gates = _routing(rng, T, E, K)
    h, w1, b1, w2, b2, _ = _ffn_arrays(rng, 1, T, d, H)
    x = h[0]
    w1, b1, w2, b2 = ((rng.randn(*s) * 0.1).astype(np.float32)
                      for s in ((E, d, H), (E, H), (E, H, d), (E, d)))
    gy = rng.randn(T, d).astype(np.float32)

    def jloss(x, gates, w1, b1, w2, b2):
        out = jdisp.moe_ffn_local(
            x, jnp.asarray(idx), gates, jdisp.MoEFfnParams(w1, b1, w2, b2),
            capacity=cap, compute_dtype=jnp.float32)
        return jnp.sum(out * gy)

    refs = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *map(jnp.asarray, (x, gates, w1, b1, w2, b2)))
    leaves = [a.clone().requires_grad_() for a in (
        t(x), t(gates), t(w1).transpose(1, 2), t(b1), t(w2).transpose(1, 2),
        t(b2))]
    out = tdisp.moe_ffn_local(leaves[0], t(idx), leaves[1],
                              tdisp.MoEFfnParams(*leaves[2:]), capacity=cap)
    (out * t(gy)).sum().backward()
    assert np.bincount(idx.reshape(-1)).max() > cap
    for i, (leaf, ref) in enumerate(zip(leaves, refs)):
        ref = _np(ref)
        if i in (2, 4):
            ref = ref.transpose(0, 2, 1)
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=1e-4,
                                   err_msg=str(i))


@pytest.mark.parametrize("noise_std", [1.0, 0.0])
def test_train_gate_aux_loss_matches_jax(noise_std):
    """The same noise on both sides: drawn by JAX as its gate draws it,
    handed to the port.  std 1.0 takes the smooth load, 0.0 the hard one."""
    rng = np.random.RandomState(4)
    T, dg, E, K = 200, 32, 16, 4
    inp = rng.randn(T, dg).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (dg, E)).astype(np.float32)
    key = jax.random.key(7)

    def jloss(inp, w):
        gate = jgate.noisy_vmoe_gate(inp, w, top_k=K, noise_std=noise_std,
                                     train=True, rng=key,
                                     build_dense_gates=False)
        return jgate.moe_aux_loss(gate, K, E, True)

    ref, (gi, gw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(inp), jnp.asarray(w))
    noise = np.array(jax.random.normal(key, (T, E), jnp.float32))
    x, wt = t(inp).requires_grad_(), t(w).requires_grad_()
    gate = tgate.noisy_vmoe_gate(x, wt, top_k=K, noise_std=noise_std,
                                 noise=t(noise))
    loss = tgate.moe_aux_loss(gate, K, E, True)
    loss.backward()
    assert float(ref) > 0
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), _np(gi), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), _np(gw), atol=1e-5, rtol=1e-4)
    assert tgate.moe_aux_loss(gate, K, E, False).item() == 0.0


def _labels(rng, B, H, W, tasks):
    """JAX-layout (NHWC) labels with the synthetic batch's encodings."""
    ignore = rng.rand(B, H, W, 1) < 0.1
    out = {}
    for tk in tasks:
        if tk.loss_kind == "softmax_ce":
            lab = rng.randint(0, tk.num_output, (B, H, W, 1)).astype(
                np.float32)
            out[tk.name] = np.where(ignore, 255.0, lab).astype(np.float32)
        elif tk.loss_kind == "balanced_bce":
            out[tk.name] = (rng.rand(B, H, W, 1) > 0.9).astype(np.float32)
        else:
            v = rng.randn(B, H, W, 3)
            v /= np.linalg.norm(v, axis=-1, keepdims=True)
            out[tk.name] = np.where(ignore, 255.0, v).astype(np.float32)
    return out


def _nchw(a):
    return t(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("task", ["semseg", "sal", "edge", "normals"])
def test_loss_matches_jax(task):
    tasks = {tk.name: tk for tk in jax_parse(
        "PASCALContext", {"include_semseg": True, "include_sal": True,
                          "include_edge": True, "include_normals": True,
                          "edge_w": 0.95})[0]}
    rng = np.random.RandomState(5)
    tk = tasks[task]
    pred = rng.randn(2, 16, 16, tk.num_output).astype(np.float32)
    lab = _labels(rng, 2, 16, 16, [tk])[task]
    ref, gref = jax.jit(jax.value_and_grad(
        jax_loss_fn(task, {"edge_w": 0.95})))(
        jnp.asarray(pred), jnp.asarray(lab))
    p = _nchw(pred).requires_grad_()
    got = loss_fn_for_task(task, {"edge_w": 0.95})(p, _nchw(lab))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy().transpose(0, 2, 3, 1),
                               _np(gref), atol=1e-7, rtol=1e-4)


def test_sgd_matches_optax():
    """Three steps of optax (add_decayed_weights + sgd momentum, poly lr
    changing every step) and torch SGD on the same gradients."""
    rng = np.random.RandomState(6)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) for _ in range(3)]
    cfg = {"optimizer": "sgd", "scheduler": "poly", "epochs": 4,
           "optimizer_kwargs": {"lr": 0.1, "momentum": 0.9,
                                "weight_decay": 1e-2}}
    tx = jax_build_optimizer(cfg, steps_per_epoch=1)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    param = torch.nn.Parameter(t(p0.copy()))
    opt, schedule = build_optimizer([param], cfg, steps_per_epoch=1)
    for i, g in enumerate(grads):
        upd, state = update(jnp.asarray(g), state, jp)
        jp = jp + upd
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        param.grad = t(g.copy())
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), _np(jp),
                                   atol=1e-6, err_msg=f"step {i}")


def test_head_train_bn_matches_flax():
    """PUP head in train mode: outputs, and BN running statistics folded
    with flax's biased batch variance (momentum 0.9); at 2x4x4 positions
    per channel torch's n/(n-1) factor would be 1.03."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 16, 32).astype(np.float32)        # img 64 -> 4x4 grid
    head = VisionTransformerUpHead(img_size=(64, 64), patch_size=16,
                                   embed_dim=32, num_classes=3)
    init_weights(head, torch.Generator().manual_seed(0))
    for i in range(4):
        bn = getattr(head, f"syncbn_fc_{i}")
        bn.running_mean.copy_(t(rng.randn(256).astype(np.float32) * 0.2))
        bn.running_var.copy_(t(rng.uniform(0.5, 2.0, 256).astype(np.float32)))
    # copies: JAX on the CPU may alias a numpy buffer and runs
    # asynchronously, while the torch forward below updates the running
    # statistics in place
    params, stats = reference_pup_head_sd_to_params(
        {k: v.numpy().copy() for k, v in head.state_dict().items()}, "")
    ref, new = jax.jit(functools.partial(
        JaxHead(img_size=(64, 64), patch_size=16, embed_dim=32,
                num_classes=3).apply, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
    got = head.train()(t(x))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               _np(ref), atol=1e-4)
    for name, bn in new["batch_stats"].items():
        mod = getattr(head, name)
        np.testing.assert_allclose(mod.running_mean.numpy(), _np(bn["mean"]),
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(mod.running_var.numpy(), _np(bn["var"]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_synthetic_batch_encodings():
    tasks = parse_task_dictionary("PASCALContext", {
        "include_semseg": True, "include_sal": True,
        "include_normals": True})[0]
    b = synthetic_batch(torch.Generator().manual_seed(0), tasks, 2, (32, 32))
    assert b["image"].shape == (2, 3, 32, 32)
    sem = b["semseg"]
    assert sem.shape == (2, 1, 32, 32)
    assert 0.05 < (sem == 255).float().mean().item() < 0.15
    assert sem[sem != 255].max().item() < 21
    assert set(b["sal"].unique().tolist()) == {0.0, 1.0}
    nrm = b["normals"]
    valid = (nrm != 255).all(dim=1)
    norms = torch.linalg.vector_norm(nrm, dim=1)[valid]
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


# ---- one whole train step of a tiny flagship, and a 5-step trajectory ----

IMG, B, STEPS = 64, 2, 5
TASK_DICT = {"include_semseg": True, "include_sal": True,
             "include_normals": True}
ARCH = dict(img=IMG, embed=128, depth=2, heads=2, experts=4, top_k=2)
WEIGHTS = {"semseg": 1.0, "sal": 5.0, "normals": 10.0}
OPT = {"optimizer": "sgd", "scheduler": "poly", "epochs": 3,
       "optimizer_kwargs": {"lr": 0.01, "momentum": 0.9,
                            "weight_decay": 1e-4}}
TRAIN = dict(capacity_factor=1.25, vmoe_noisy_std=0.0, shared_prefix=True)


@pytest.fixture(scope="module")
def trajectories():
    """STEPS train steps of the JAX model (one jitted program) and of the
    port, from the same weights (the port's seeded init) on the same batch;
    the state after step 1 and after the last step."""
    jtasks = jax_parse("PASCALContext", TASK_DICT)[0]
    names = [tk.name for tk in jtasks]
    rng = np.random.RandomState(9)
    img = rng.randn(B, IMG, IMG, 3).astype(np.float32)
    batch = {"image": img, **_labels(rng, B, IMG, IMG, jtasks)}
    # the port's seeded weights, carried to JAX by the JAX package's own
    # reference-checkpoint converter (no flax init to compile); copied, as
    # the port's steps update them in place
    tasks = parse_task_dictionary("PASCALContext", TASK_DICT)[0]
    model, _ = build_flagship(tasks=tasks, dtype=torch.float32, device="cpu",
                              seed=1, **ARCH, **TRAIN)
    params, stats = reference_mtl_sd_to_params(
        {k: v.numpy().copy() for k, v in model.state_dict().items()
         if not k.endswith("num_batches_tracked")}, names,
        multi_gate_tasks=len(names))
    jmodel, _ = jax_build_flagship(tasks=jtasks, dtype=jnp.float32,
                                   use_checkpointing=False, **ARCH, **TRAIN)
    tx = jax_build_optimizer(OPT, steps_per_epoch=2)
    state = jax.jit(lambda p, s: TrainState.create(
        apply_fn=jmodel.apply, params=p, tx=tx, batch_stats=s))(params, stats)
    jstep = jax_make_train_step(
        jmodel, names, {n: jax_loss_fn(n, {"edge_w": 0.95}) for n in names},
        WEIGHTS, donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmetrics, jstates = [], []
    for i in range(STEPS):
        state, m = jstep(state, jbatch, jax.random.key(i))
        jmetrics.append({k: float(v) for k, v in m.items()})
        if i in (0, STEPS - 1):
            jstates.append(jax.tree.map(np.asarray, {
                "params": state.params, "batch_stats": state.batch_stats}))

    opt, schedule = build_optimizer(model.parameters(), OPT,
                                    steps_per_epoch=2)
    step = make_train_step(
        model, names, {n: loss_fn_for_task(n, {"edge_w": 0.95})
                       for n in names}, WEIGHTS, opt, schedule)
    tbatch = {k: _nchw(v) for k, v in batch.items()}
    metrics, states = [], []
    for i in range(STEPS):
        metrics.append({k: v.item() for k, v in step(tbatch).items()})
        if i in (0, STEPS - 1):
            states.append({k: v.detach().clone()
                           for k, v in model.state_dict().items()})
    return names, tasks, jmetrics, jstates, metrics, states


def test_train_step_matches_jax(trajectories):
    """Step 1: every loss and metric to 1e-5 relative; every updated
    parameter and BN running statistic to 2e-6 (f32 sums in another
    order)."""
    names, tasks, jmetrics, jstates, metrics, states = trajectories
    for k, v in jmetrics[0].items():
        np.testing.assert_allclose(metrics[0][k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert metrics[0]["loss_cv"] > 0
    ref = jax_variables_to_state_dict(jstates[0], tasks, len(tasks))
    got = states[0]
    assert set(ref) == set(got)
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            assert got[k].item() == 1
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-6,
                                   err_msg=k)


def test_train_trajectory_matches_jax(trajectories):
    """STEPS steps on one batch: the losses fall and track JAX's.  The f32
    summation-order differences of step 1 (~3e-7) grow with every step
    (to ~2e-4 by step 5), so the trajectory is held to 1e-3 relative, the
    final parameters to 1e-4 and the BN running statistics to 1e-3 of
    their largest magnitude."""
    names, tasks, jmetrics, jstates, metrics, states = trajectories
    for i, (m, jm) in enumerate(zip(metrics, jmetrics)):
        for k in ["loss_total_with_cv", "loss_cv"] + [f"loss_{n}"
                                                     for n in names]:
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-3,
                                       err_msg=f"step {i} {k}")
    total = [m["loss_total_with_cv"] for m in metrics]
    assert total[-1] < total[0]
    ref = jax_variables_to_state_dict(jstates[-1], tasks, len(tasks))
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        atol = 1e-3 * v.abs().max().item() if "running" in k else 1e-4
        np.testing.assert_allclose(states[-1][k].numpy(), v.numpy(),
                                   atol=atol, err_msg=k)
