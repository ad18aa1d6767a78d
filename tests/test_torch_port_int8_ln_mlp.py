"""The port's int8 expert serving and fused LN+MLP+residual sublayer against
the JAX package's (CPU, f32).

Inputs and weights are made from a seed with numpy and handed to JAX as
copies.  The JAX Pallas kernels run in interpret mode, as the JAX package's
own CPU tests run them: ``quantized_expert_ffn(..., interpret=True)`` and
``fused_ln_mlp_residual(..., interpret=True)`` directly, and the model's
fused dense sublayer under ``_FORCE_INTERPRET_FOR_TESTS``.  The JAX kernels
use the Abramowitz-Stegun erf (|error| < 1.5e-7) where the port uses the
exact one; the op tolerances (2e-5 of the largest |ref|) hold that and f32
sums in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import build_flagship as jax_build_flagship
from m3vit_tpu.losses.functions import loss_fn_for_task as jax_loss_fn
from m3vit_tpu.models.vit_moe import MoEMlp as JaxMoEMlp
from m3vit_tpu.moe.dispatch import MoEFfnParamsQ as JaxParamsQ
from m3vit_tpu.ops import expert_ffn as jax_expert_ffn_mod
from m3vit_tpu.ops.expert_ffn import quantized_expert_ffn as jax_q_ffn
from m3vit_tpu.ops.ln_mlp import fused_ln_mlp_residual as jax_ln_mlp
from m3vit_tpu.serve import InferenceSession as JaxSession
from m3vit_tpu.serve import quantize as jq
from m3vit_tpu.tasks import parse_task_dictionary as jax_parse
from m3vit_tpu.train.optim import build_optimizer as jax_build_optimizer
from m3vit_tpu.train.state import TrainState
from m3vit_tpu.train.step import make_train_step as jax_make_train_step
from m3vit_tpu.utils.torch_interop import reference_mtl_sd_to_params
from m3vit_tpu_torch.losses.functions import loss_fn_for_task
from m3vit_tpu_torch.models import build_flagship
from m3vit_tpu_torch.models.vit_moe import MoEMlp
from m3vit_tpu_torch.ops.expert_ffn import quantized_expert_ffn_plain
from m3vit_tpu_torch.ops.ln_mlp import fused_ln_mlp_residual
from m3vit_tpu_torch.serve import InferenceSession
from m3vit_tpu_torch.serve import quantize as tq
from m3vit_tpu_torch.tasks import parse_task_dictionary
from m3vit_tpu_torch.train.optim import build_optimizer
from m3vit_tpu_torch.train.step import make_train_step
from m3vit_tpu_torch.utils.convert import jax_variables_to_state_dict
from tests.jax_fast_compile import FAST_COMPILE, fast_jit as _jit

t = torch.from_numpy
OP_TOL = 2e-5     # of the largest |ref|


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tests, restored afterwards
    (a process-wide setting: left in place it would slow every later test
    file of the same worker)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float32), _np(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=OP_TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _bank(rng, shape):
    """A JAX-layout [..., E, in, out] bank with an all-zero out channel and
    one whose scale is exactly 1 and whose values sit on half steps, where
    rounding goes to even (2.5 -> 2, -3.5 -> -4, 0.5 -> 0)."""
    w = (rng.randn(*shape) * 0.1).astype(np.float32)
    w[..., 0, :, 1] = 0.0
    halves = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5], np.float32)
    w[..., 1, :, 2] = np.resize(halves, shape[-2])
    return w


@pytest.mark.parametrize("shape", [(3, 40, 24), (2, 3, 16, 8)],
                         ids=["bank", "stacked"])
def test_quantize_weight_bitwise_matches_jax(shape):
    w = _bank(np.random.RandomState(0), shape)
    jqw, js = jq.quantize_weight(w.copy())
    q, s = tq.quantize_weight(t(w).transpose(-1, -2))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.transpose(-1, -2).numpy(),
                                  np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_weight(q, s).transpose(-1, -2).numpy(),
        np.asarray(jq.dequantize_weight(jqw, js)))


def test_expert_quantization_error_matches_jax():
    rng = np.random.RandomState(1)
    banks = {"experts_w1": _bank(rng, (3, 40, 24)),
             "experts_w2": _bank(rng, (3, 24, 40))}
    ref = jq.expert_quantization_error({"block_1": {"mlp": dict(banks)}})
    sd = {f"backbone.blocks.1.mlp.experts.{n}.weight":
          t(banks[k]).transpose(1, 2).contiguous()
          for k, n in (("experts_w1", "htoh4"), ("experts_w2", "h4toh"))}
    assert 0 < ref < 1e-2
    np.testing.assert_allclose(tq.expert_quantization_error(sd), ref,
                               rtol=1e-6)


# bf16, the flagship's compute dtype, rounds each dequantized weight and the
# activation to bf16 before its product (the rounding points any K7 keeps).
# Sums in another order may flip single bf16 roundings: max abs error 1e-2
# of the largest |ref|, and 1e-3 relative Frobenius error, which a weight or
# activation left unrounded exceeds (3.8e-3 at these inputs; here the two
# agree bit for bit).  f32: OP_TOL of the largest |ref|.
# the model widths the port's FFN kernels take: the flagships' 128 (384
# alike), ViT-tiny's 192, ViT-base's 768 and ViT-large's 1024
WIDTHS = (128, 192, 768, 1024)


@pytest.mark.parametrize("d", WIDTHS, ids=[f"d{d}" for d in WIDTHS])
@pytest.mark.parametrize("dtype,tol,fro", [(torch.float32, OP_TOL, None),
                                           (torch.bfloat16, 1e-2, 1e-3)],
                         ids=["f32", "bf16"])
def test_quantized_expert_ffn_plain_matches_jax_kernel(dtype, tol, fro, d):
    rng = np.random.RandomState(2)
    E, C, H = 2, 40 if d == 128 else 24, 128
    w1, w2 = ((rng.randn(*sh) * 0.1).astype(np.float32)
              for sh in ((E, d, H), (E, H, d)))
    w1[0, :, 1] = 0.0                       # an all-zero out channel
    b1, b2 = (rng.randn(E, n).astype(np.float32) * 0.1 for n in (H, d))
    h = t(rng.randn(E, C, d).astype(np.float32)).to(dtype)
    q1, s1 = jq.quantize_weight(w1.copy())
    q2, s2 = jq.quantize_weight(w2.copy())
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_q_ffn(jnp.asarray(h.float().numpy()).astype(jdtype),
                    JaxParamsQ(q1, jnp.asarray(b1), q2, jnp.asarray(b2), s1,
                               s2), interpret=True)
    assert ref.dtype == jdtype
    tq1, ts1 = tq.quantize_weight(t(w1).transpose(1, 2))
    tq2, ts2 = tq.quantize_weight(t(w2).transpose(1, 2))
    got = quantized_expert_ffn_plain(h, tq1, ts1, t(b1), tq2, ts2, t(b2))
    assert got.dtype == dtype
    ref = _np(ref)
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())
    if fro is not None:
        assert np.linalg.norm(got - ref) <= fro * np.linalg.norm(ref)


@pytest.mark.parametrize("d", WIDTHS, ids=[f"d{d}" for d in WIDTHS])
def test_ln_mlp_plain_and_function_match_jax_vjp(d):
    rng = np.random.RandomState(3)
    # S not a tile multiple
    S, H = (40, 256) if d == 128 else (24, 128)
    x = (rng.randn(S, d) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    beta = (0.1 * rng.randn(d)).astype(np.float32)
    w1 = (rng.randn(d, H) * d ** -0.5).astype(np.float32)
    w2 = (rng.randn(H, d) * H ** -0.5).astype(np.float32)
    b1, b2 = (rng.randn(n).astype(np.float32) * 0.1 for n in (H, d))
    g = rng.randn(S, d).astype(np.float32)
    args = tuple(jnp.asarray(a) for a in (x, gamma, beta, w1, b1, w2, b2))
    ref, vjp = jax.vjp(lambda *a: jax_ln_mlp(*a, 1e-6, True), *args)
    rgrads = vjp(jnp.asarray(g))
    leaves = [a.clone().requires_grad_() for a in (
        t(x), t(gamma), t(beta), t(w1).t(), t(b1), t(w2).t(), t(b2))]
    out = fused_ln_mlp_residual(*leaves)
    _close(out.detach().numpy(), ref, "forward")
    out.backward(t(g))
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for i, (name, leaf, r) in enumerate(zip(names, leaves, rgrads)):
        r = _np(r)
        _close(leaf.grad.numpy(), r.T if i in (3, 5) else r, name)


# ---- a tiny int8 flagship through both InferenceSessions ----------------

IMG = 64
TASK_DICT = {"include_semseg": True, "include_sal": True,
             "include_normals": True}
SERVE_ARCH = dict(img=IMG, embed=128, depth=4, heads=2, experts=4, top_k=2)


def _routing_hooks(model, sink):
    return [m.register_forward_hook(
        lambda mod, args, out: sink.append(out[1].top_k_indices.numpy()))
        for m in model.modules() if isinstance(m, MoEMlp)]


def test_int8_session_matches_jax_session():
    """JAX: the port's seeded float flagship carried across, its expert
    banks quantized by quantize_expert_tree, run with expert_weights_int8;
    the port: those variables carried back and strict-loaded into a model
    built with expert_weights_int8.  Routing of every MoE block is
    identical and the logits agree to 1e-4."""
    jtasks = jax_parse("PASCALContext", TASK_DICT)[0]
    names = [tk.name for tk in jtasks]
    tasks = parse_task_dictionary("PASCALContext", TASK_DICT)[0]
    fmodel, _ = build_flagship(tasks=tasks, dtype=torch.float32,
                               device="cpu", seed=3, **SERVE_ARCH)
    params, stats = reference_mtl_sd_to_params(
        {k: v.numpy().copy() for k, v in fmodel.state_dict().items()
         if not k.endswith("num_batches_tracked")}, names,
        multi_gate_tasks=len(names))
    qvars = {"params": jq.quantize_expert_tree(params), "batch_stats": stats}
    jmodel, _ = jax_build_flagship(tasks=jtasks, dtype=jnp.float32,
                                   use_checkpointing=False, **SERVE_ARCH)
    jmodel = dataclasses.replace(jmodel, backbone=dataclasses.replace(
        jmodel.backbone, expert_weights_int8=True))
    x = np.random.RandomState(4).randn(2, IMG, IMG, 3).astype(np.float32)

    def run(v, x):   # logits and each MoE block's routing, one program
        (pred, _, _), st = jmodel.apply(
            v, x, train=False, single_task="semseg",
            capture_intermediates=lambda m, _: isinstance(m, JaxMoEMlp),
            mutable=["intermediates"])
        gates = [leaf for leaf in jax.tree.leaves(
            st["intermediates"], is_leaf=lambda n: hasattr(n, "top_k_indices"))
            if hasattr(leaf, "top_k_indices")]
        return pred["semseg"], [gt.top_k_indices for gt in gates]

    ref, jroutes = _jit(run)(qvars, jnp.asarray(x))
    jsess = JaxSession(jmodel, qvars, names, img_size=(IMG, IMG),
                       buckets=(2,))
    jlogits = jsess.predict(x, "semseg")

    model, _ = build_flagship(tasks=tasks, dtype=torch.float32, device="cpu",
                              expert_weights_int8=True, **SERVE_ARCH)
    model.load_state_dict(jax_variables_to_state_dict(qvars, tasks,
                                                      len(tasks)),
                          strict=True)
    sess = InferenceSession(model, names, (IMG, IMG), buckets=(2,),
                            device="cpu")
    routes = []
    hooks = _routing_hooks(model, routes)
    logits = sess.predict(x, "semseg")
    for hk in hooks:
        hk.remove()
    assert len(routes) == len(jroutes) == SERVE_ARCH["depth"] // 2
    for got, want in zip(routes, jroutes):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(np.asarray(jlogits), _np(ref), atol=1e-6)
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=1e-4)


# ---- a tiny flagship with the fused dense sublayer: eval and one step ----

B = 2
TRAIN_ARCH = dict(img=IMG, embed=128, depth=2, heads=2, experts=4, top_k=2)
WEIGHTS = {"semseg": 1.0, "sal": 5.0, "normals": 10.0}
OPT = {"optimizer": "sgd", "scheduler": "poly", "epochs": 3,
       "optimizer_kwargs": {"lr": 0.01, "momentum": 0.9,
                            "weight_decay": 1e-4}}
TRAIN = dict(capacity_factor=1.25, vmoe_noisy_std=0.0, shared_prefix=True)


def _labels(rng, tasks):
    """NHWC labels with the synthetic batch's encodings (10% ignored)."""
    ignore = rng.rand(B, IMG, IMG, 1) < 0.1
    out = {}
    for tk in tasks:
        if tk.loss_kind == "softmax_ce":
            lab = rng.randint(0, tk.num_output, (B, IMG, IMG, 1))
            out[tk.name] = np.where(ignore, 255.0, lab).astype(np.float32)
        elif tk.loss_kind == "balanced_bce":
            out[tk.name] = (rng.rand(B, IMG, IMG, 1) > 0.9).astype(np.float32)
        else:
            v = rng.randn(B, IMG, IMG, 3)
            v /= np.linalg.norm(v, axis=-1, keepdims=True)
            out[tk.name] = np.where(ignore, 255.0, v).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ln_mlp_runs():
    """The port's seeded ln_mlp flagship carried to a JAX model built with
    use_pallas_ln_mlp (its fused sublayer in interpret mode); both run the
    multi-task eval and one train step on the same batch."""
    jtasks = jax_parse("PASCALContext", TASK_DICT)[0]
    names = [tk.name for tk in jtasks]
    rng = np.random.RandomState(5)
    batch = {"image": rng.randn(B, IMG, IMG, 3).astype(np.float32),
             **_labels(rng, jtasks)}
    tasks = parse_task_dictionary("PASCALContext", TASK_DICT)[0]
    model, _ = build_flagship(tasks=tasks, dtype=torch.float32, device="cpu",
                              seed=2, ln_mlp=True, **TRAIN_ARCH, **TRAIN)
    params, stats = reference_mtl_sd_to_params(
        {k: v.numpy().copy() for k, v in model.state_dict().items()
         if not k.endswith("num_batches_tracked")}, names,
        multi_gate_tasks=len(names))
    jmodel, _ = jax_build_flagship(tasks=jtasks, dtype=jnp.float32,
                                   use_checkpointing=False,
                                   use_pallas_ln_mlp=True, **TRAIN_ARCH,
                                   **TRAIN)
    tx = jax_build_optimizer(OPT, steps_per_epoch=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_expert_ffn_mod, "_FORCE_INTERPRET_FOR_TESTS", True)
        jeval = jax.tree.map(np.asarray, _jit(
            lambda v, x: jmodel.apply(v, x, train=False)[0])(
                {"params": params, "batch_stats": stats}, jbatch["image"]))
        state = TrainState.create(apply_fn=jmodel.apply, params=params,
                                  tx=tx, batch_stats=stats)
        jstep = jax_make_train_step(
            jmodel, names, {n: jax_loss_fn(n, {"edge_w": 0.95})
                            for n in names}, WEIGHTS, donate=False)
        jstep = jstep.lower(state, jbatch, jax.random.key(0)).compile(
            FAST_COMPILE)
        state, jm = jstep(state, jbatch, jax.random.key(0))
    jmetrics = {k: float(v) for k, v in jm.items()}
    jstate = jax.tree.map(np.asarray, {"params": state.params,
                                       "batch_stats": state.batch_stats})

    with torch.no_grad():
        pred = model(t(batch["image"].transpose(0, 3, 1, 2).copy()))[0]
    got_eval = {k: v.permute(0, 2, 3, 1).numpy() for k, v in pred.items()}
    opt, schedule = build_optimizer(model.parameters(), OPT,
                                    steps_per_epoch=2)
    step = make_train_step(model, names, {
        n: loss_fn_for_task(n, {"edge_w": 0.95}) for n in names}, WEIGHTS,
        opt, schedule)
    tbatch = {k: t(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
              for k, v in batch.items()}
    metrics = {k: v.item() for k, v in step(tbatch).items()}
    return (names, tasks, jeval, got_eval, jmetrics, jstate, metrics,
            {k: v.detach().clone() for k, v in model.state_dict().items()})


def test_ln_mlp_eval_matches_jax(ln_mlp_runs):
    names, _, jeval, got, *_ = ln_mlp_runs
    assert set(got) == set(names)
    for task in names:
        np.testing.assert_allclose(got[task], jeval[task], atol=1e-4,
                                   err_msg=task)


def test_ln_mlp_train_step_matches_jax(ln_mlp_runs):
    """One step: every loss and metric to 1e-5 relative, every updated
    parameter and BN running statistic to 2e-6 (the tolerances of
    test_torch_port_train.py)."""
    _, tasks, _, _, jmetrics, jstate, metrics, state = ln_mlp_runs
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    ref = jax_variables_to_state_dict(jstate, tasks, len(tasks))
    assert set(ref) == set(state)
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=2e-6,
                                   err_msg=k)
