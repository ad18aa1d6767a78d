"""The trainer's remaining step paths of the port against the JAX package
(CPU, f32): capacity parsing, the learned-noise gate and its balance
loss, the bce and depth losses, the single-task loss schemes, the step
schedule, Adam / AdamW / SGD with gradient accumulation (optax.MultiSteps),
the one-by-one step, the eval step with its MoE stats and no-drop guard,
the analysis metrics, and the dense and MoE models that both factories
build from the reference YAMLs.

Models are shrunk (img 32, embed 128, depth 2, 2 heads, E=4, K=2, f32).
Their weights are the port's seeded init, carried into a flax tree by the
JAX package's reference-checkpoint converter and back into the port by
``jax_variables_to_state_dict`` (strict load).  Each fixture's JAX side
runs as one jitted program.  Tolerances are stated at each test: 1e-5
relative (1e-6 absolute for parameters) where both sides compute the same
f32 expression in another order, 1e-4 for model outputs (the JAX
package's own, tests/test_torch_port_model.py).
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from m3vit_tpu.evaluation.orchestrate import _DropGuard as JaxDropGuard
from m3vit_tpu.losses import functions as jfun
from m3vit_tpu.losses import schemes as jsch
from m3vit_tpu.models.factory import build_model as jax_build_model
from m3vit_tpu.moe import gating as jgate
from m3vit_tpu.moe.dispatch import parse_capacity_factor as jax_parse_cf
from m3vit_tpu.tasks import parse_task_dictionary as jax_parse
from m3vit_tpu.train import step as jstep
from m3vit_tpu.train.optim import build_optimizer as jax_build_optimizer
from m3vit_tpu.train.optim import build_schedule as jax_build_schedule
from m3vit_tpu.train.state import TrainState
from m3vit_tpu.utils.torch_interop import (
    params_to_reference_sd,
    reference_mtl_sd_to_params,
)
from m3vit_tpu_torch.evaluation.orchestrate import _DropGuard
from m3vit_tpu_torch.losses import functions as tfun
from m3vit_tpu_torch.losses import schemes as tsch
from m3vit_tpu_torch.models import SingleTaskModel, build_model
from m3vit_tpu_torch.moe import gating as tgate
from m3vit_tpu_torch.moe.dispatch import NO_DROP, parse_capacity_factor
from m3vit_tpu_torch.train.optim import build_optimizer, build_schedule
from m3vit_tpu_torch.train.step import (
    make_eval_step,
    make_one_by_one_train_step,
    make_single_task_eval_step,
    make_train_step,
)
from m3vit_tpu_torch.models.vit_moe import GATE_INTERNALS_ENV, MoEMlp
from m3vit_tpu_torch.utils.convert import jax_variables_to_state_dict
from m3vit_tpu_torch.utils.tracing import (dump_trace, load_trace,
                                           numeric_diff, trace_model)
from tests.jax_fast_compile import FAST_COMPILE, fast_jit as _jit
from tests.torch_port_replay import capture_bn, head_masks, replay_head_masks

ROOT = Path(__file__).resolve().parent.parent
t = torch.from_numpy

def _np(x):
    return np.asarray(x, np.float32)


def _nchw(a):
    return t(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tests, restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("value", [2, 1.25, "2.5", "nodrop", "no_drop",
                                   " INF "])
def test_parse_capacity_factor_matches_jax(value):
    got = parse_capacity_factor(value)
    assert got == jax_parse_cf(value)
    assert (got == NO_DROP) == (str(value).strip().lower() in
                                ("nodrop", "no_drop", "inf"))


@pytest.mark.parametrize("top_k", [2, 4], ids=["topk_lt_E", "topk_eq_E"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_noisy_gate_matches_jax(train, top_k):
    """noisy_gate and moe_aux_loss_noisy, with the gradients of the loss
    plus a random functional of the dense gates in the gate input, w_gate
    and w_noise.  JAX draws the normals from its key; the port is handed
    the same normals.  Same f32 expressions: 1e-5 relative, grads 1e-5
    absolute / 1e-4 relative (as the VMoE gate's test)."""
    rng = np.random.RandomState(11)
    T, dg, E = 96, 16, 4
    inp = rng.randn(T, dg).astype(np.float32)
    wg, wn = (rng.uniform(-0.5, 0.5, (dg, E)).astype(np.float32)
              for _ in range(2))
    cot = rng.randn(T, E).astype(np.float32)
    key = jax.random.key(5)

    def jfn(inp, wg, wn):
        gate = jgate.noisy_gate(inp, wg, wn, top_k=top_k, train=train,
                                rng=key if train else None)
        aux = jgate.moe_aux_loss_noisy(gate, top_k, E, train)
        return aux + (gate.gates * cot).sum(), (gate.top_k_indices,
                                                gate.gates, aux)

    (_, (idx, gates, aux)), grads = _jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray,
                                                     (inp, wg, wn)))
    noise = t(np.array(jax.random.normal(key, (T, E), jnp.float32))) \
        if train else None
    leaves = [t(a).requires_grad_() for a in (inp, wg, wn)]
    gate = tgate.noisy_gate(*leaves, top_k=top_k, noise=noise)
    loss = tgate.moe_aux_loss_noisy(gate, top_k, E, train)
    (loss + (gate.gates * t(cot)).sum()).backward()
    assert np.array_equal(gate.top_k_indices.numpy(), np.asarray(idx))
    np.testing.assert_allclose(gate.gates.detach().numpy(), _np(gates),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(loss.item(), float(aux), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == train
    for name, leaf, ref in zip(("x", "w_gate", "w_noise"), leaves, grads):
        # in eval w_noise takes no part: no gradient, JAX's zeros
        got = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("kind", ["bce", "depth_l1"])
def test_loss_matches_jax(kind):
    """bce_loss and depth_l1_loss with their gradients; 1e-5 relative."""
    rng = np.random.RandomState(12)
    pred = rng.randn(2, 16, 16, 1).astype(np.float32)
    if kind == "bce":
        lab = (rng.rand(2, 16, 16, 1) > 0.8).astype(np.float32)
    else:
        lab = np.where(rng.rand(2, 16, 16, 1) < 0.2, 255.0,
                       rng.rand(2, 16, 16, 1) * 5).astype(np.float32)
    ref, gref = _jit(jax.value_and_grad(jfun.get_loss_fn(kind)))(
        jnp.asarray(pred), jnp.asarray(lab))
    p = _nchw(pred).requires_grad_()
    got = tfun.get_loss_fn(kind)(p, _nchw(lab))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy().transpose(0, 2, 3, 1),
                               _np(gref), atol=1e-8, rtol=1e-5)
    if kind == "depth_l1":
        assert tfun.loss_fn_for_task("depth", {}) is tfun.depth_l1_loss


@pytest.mark.parametrize("scheme", ["single_task_loss", "multi_task_loss"])
def test_single_task_loss_schemes_match_jax(scheme):
    """build_loss_fns from the config's task dictionary, then each task's
    single_task_loss (unweighted) or multi_task_loss(single_task=)
    (weighted); 1e-5 relative."""
    tdict = {"include_semseg": True, "include_sal": True,
             "include_edge": True, "include_normals": True, "edge_w": 0.95}
    p = {"train_db_name": "PASCALContext", "task_dictionary": tdict}
    jtasks, extra = jax_parse("PASCALContext", tdict)
    jfns = jsch.build_loss_fns({"TASKS": jtasks, **extra})
    fns = tsch.build_loss_fns(p)
    assert set(fns) == set(jfns)
    weights = {"semseg": 1.0, "sal": 5.0, "edge": 50.0, "normals": 10.0}
    rng = np.random.RandomState(13)
    preds, gts = {}, {}
    for tk in jtasks:
        preds[tk.name] = rng.randn(2, 8, 8, tk.num_output).astype(np.float32)
        if tk.num_output == 3:
            v = rng.randn(2, 8, 8, 3)
            lab = v / np.linalg.norm(v, axis=-1, keepdims=True)
        elif tk.loss_kind == "softmax_ce":
            lab = rng.randint(0, tk.num_output, (2, 8, 8, 1))
        else:
            lab = rng.rand(2, 8, 8, 1) > 0.7
        gts[tk.name] = lab.astype(np.float32)
    names = [tk.name for tk in jtasks]
    if scheme == "single_task_loss":
        jfn = lambda p, g: {n: jsch.single_task_loss(  # noqa: E731
            p, g, n, jfns) for n in names}
        tfn = lambda p, g, n: tsch.single_task_loss(  # noqa: E731
            p, g, n, fns)
    else:
        jfn = lambda p, g: {n: jsch.multi_task_loss(  # noqa: E731
            p, g, [n], jfns, weights, single_task=n) for n in names}
        tfn = lambda p, g, n: tsch.multi_task_loss(  # noqa: E731
            p, g, [n], fns, weights, single_task=n)
    refs = _jit(jfn)(*({k: jnp.asarray(v) for k, v in d.items()}
                          for d in (preds, gts)))
    tp, tg = ({k: _nchw(v) for k, v in d.items()} for d in (preds, gts))
    for n in names:
        got = tfn(tp, tg, n)
        assert set(got) == set(refs[n]) == {n, "total"}
        for k, ref in refs[n].items():
            np.testing.assert_allclose(got[k].item(), float(ref),
                                       rtol=1e-5, err_msg=f"{n} {k}")


SCHEDULES = {
    "poly": {"scheduler": "poly", "epochs": 6,
             "optimizer_kwargs": {"lr": 0.1}},
    "step": {"scheduler": "step", "epochs": 6,
             "optimizer_kwargs": {"lr": 0.1},
             "scheduler_kwargs": {"lr_decay_epochs": [2, 4],
                                  "lr_decay_rate": 0.5}},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    """lr at every step of 7 epochs of 3 steps (the step schedule decays
    only once an epoch is strictly past a decay epoch); 1e-6 relative."""
    js = _jit(jax_build_schedule(SCHEDULES[name], 3))
    ts = build_schedule(SCHEDULES[name], 3)
    got = [ts(s) for s in range(21)]
    np.testing.assert_allclose(got, [float(js(s)) for s in range(21)],
                               rtol=1e-6)
    if name == "step":
        assert got[8] == 0.1 and got[9] == 0.05 and got[15] == 0.025


class _Linear(torch.nn.Module):
    """pred = <w, x>: the gradient of its loss is the batch's x."""

    def __init__(self, w0):
        super().__init__()
        self.w = torch.nn.Parameter(t(w0.copy()))

    def forward(self, x, noise=None):
        return {"t": (self.w * x).sum()}, torch.zeros(()), {}


OPTIMIZERS = {
    "sgd_accum2": {"optimizer": "sgd", "accumulation_steps": 2,
                   "optimizer_kwargs": {"momentum": 0.9}},
    "adam": {"optimizer": "adam"},
    "adamw": {"optimizer": "adamw"},
    "adamw_accum2_step": {"optimizer": "adamw", "accumulation_steps": 2,
                          "scheduler": "step",
                          "scheduler_kwargs": {"lr_decay_epochs": [0, 1]}},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trajectory_matches_optax(name):
    """Eight micro-batch gradients through the port's train step (its
    accumulation included) and through the JAX optimizer (optax.MultiSteps
    when accumulation_steps > 1), the lr schedule moving every optimizer
    step, the parameters compared after every micro-batch.  The config sets
    weight_decay 1e-2 throughout: SGD couples it, AdamW decouples it and
    Adam ignores it, in both.  Limits: 1e-6 absolute (SGD, as
    test_sgd_matches_optax); 1e-5 for Adam/AdamW, whose steps of up to lr
    0.1 differ by up to ~1.3e-5 relative: optax forms the bias correction
    1 - 0.999**t in f32 (0.999 is 1.3e-8 off in f32, so 1 - 0.999 is
    1.3e-5 off), torch in double (4e-6 after 8 steps, measured)."""
    spec = OPTIMIZERS[name]
    cfg = {"scheduler": "poly", "epochs": 4, **spec,
           "optimizer_kwargs": {"lr": 0.1, "weight_decay": 1e-2,
                                **spec.get("optimizer_kwargs", {})}}
    accum = int(cfg.get("accumulation_steps", 1))
    rng = np.random.RandomState(14)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) for _ in range(8)]
    tx = jax_build_optimizer(cfg, steps_per_epoch=2)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    update = _jit(tx.update)
    model = _Linear(p0)
    opt, schedule = build_optimizer(model.parameters(), cfg,
                                    steps_per_epoch=2)
    if cfg["optimizer"] == "adam":
        assert opt.param_groups[0]["weight_decay"] == 0.0
    step = make_train_step(model, ["t"], {"t": lambda pred, gt: pred},
                           {"t": 1.0}, opt, schedule,
                           accumulation_steps=accum)
    atol = 1e-6 if cfg["optimizer"] == "sgd" else 1e-5
    for i, g in enumerate(grads):
        upd, state = update(jnp.asarray(g), state, jp)
        jp = jp + upd
        step({"image": t(g.copy()), "t": None})
        np.testing.assert_allclose(model.w.detach().numpy(), _np(jp),
                                   atol=atol, err_msg=f"micro-batch {i}")
    assert not np.allclose(_np(jp), p0)


@pytest.mark.parametrize("drops,allow", [(0.0, False), (0.01, False),
                                         (0.01, True)])
def test_drop_guard_matches_jax(drops, allow):
    """Raises exactly when JAX's guard does, with its message."""
    stream = [{"dropped_slot_fraction": 0.0}, None, {},
              {"dropped_slot_fraction": drops}]
    guards = (_DropGuard({"allow_eval_drops": allow}),
              JaxDropGuard({"allow_eval_drops": allow}))
    errors = []
    for g, as_array in zip(guards, (torch.tensor, jnp.asarray)):
        for st in stream:
            g.update(st and {k: as_array(v) for k, v in st.items()})
        try:
            g.check()
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert (errors[0] is not None) == (drops > 0 and not allow)
    _DropGuard({}).check()          # nothing seen: nothing to hold


# ---- models built from the reference YAMLs, shrunk ----

IMG, EMBED, B = 32, 128, 4
TASK_DICT = {"include_semseg": True, "include_normals": True}
WEIGHTS = {"semseg": 1.0, "normals": 10.0}
OPT = {"optimizer": "sgd", "scheduler": "poly", "epochs": 3,
       "optimizer_kwargs": {"lr": 0.01, "momentum": 0.9,
                            "weight_decay": 1e-4}}
def _config(name, task_dict=TASK_DICT, **over):
    """A reference YAML of configs/pascal, shrunk to IMG / EMBED / depth 2 /
    2 heads, f32, no rematerialisation; E=4, K=2 and gate noise 0 for the
    MoE one."""
    with open(ROOT / "configs" / "pascal" / name) as f:
        p = yaml.safe_load(f)
    p["backbone_kwargs"].update(img_size=[IMG, IMG], embed_dim=EMBED,
                                depth=2, num_heads=2)
    p["head_kwargs"].update(img_size=[IMG, IMG], embed_dim=EMBED)
    if p["backbone"] == "VisionTransformer_moe":
        ntasks = sum(1 for k, v in task_dict.items() if k.startswith(
            "include_") and v)
        p["backbone_kwargs"]["gate_dim"] = EMBED + ntasks
        p.update(moe_experts=4, moe_top_k=2, vmoe_noisy_std=0.0)
    p.update(compute_dtype="float32", use_checkpointing=False,
             task_dictionary=task_dict, **over)
    return p


def _jax_config(p):
    jtasks, extra = jax_parse(p["train_db_name"], p["task_dictionary"])
    return {**p, **extra, "TASKS": jtasks}


def _labels(rng, tasks):
    """NHWC labels with the synthetic batch's encodings."""
    ignore = rng.rand(B, IMG, IMG, 1) < 0.1
    out = {}
    for tk in tasks:
        if tk.loss_kind == "softmax_ce":
            lab = rng.randint(0, tk.num_output, (B, IMG, IMG, 1))
            out[tk.name] = np.where(ignore, 255.0, lab).astype(np.float32)
        else:
            v = rng.randn(B, IMG, IMG, 3)
            v /= np.linalg.norm(v, axis=-1, keepdims=True)
            out[tk.name] = np.where(ignore, 255.0, v).astype(np.float32)
    return out


def _batch(seed, tasks):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(B, IMG, IMG, 3).astype(np.float32),
            **_labels(rng, tasks)}


def _seeded_variables(p, names, gates, seed):
    """The port's seeded weights for config `p`, with seeded non-trivial
    BN running statistics, as a flax variable tree made by the JAX
    package's own reference-checkpoint converter (no flax init to
    compile).  A SingleTaskModel's head goes by ``decoder`` there."""
    model, _ = build_model(p, device="cpu", seed=seed)
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        v = v.numpy().copy()
        if k.endswith("running_mean"):
            v = (rng.randn(*v.shape) * 0.2).astype(np.float32)
        elif k.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        sd[k.replace("decoder.", f"decoders.{names[0]}.", 1)
           if k.startswith("decoder.") else k] = v
    params, stats = reference_mtl_sd_to_params(sd, names,
                                               multi_gate_tasks=gates)
    if isinstance(model, SingleTaskModel):
        params["decoder"] = params.pop(f"decoders_{names[0]}")
        stats["decoder"] = stats.pop(f"decoders_{names[0]}")
    return {"params": params, "batch_stats": stats}


def _port_model(p, variables, names, gates):
    """The port's model of config `p`, strict-loaded from a flax tree
    through jax_variables_to_state_dict."""
    model, _ = build_model(p, device="cpu", seed=99)
    sd = jax_variables_to_state_dict(variables, names, gates)
    model.load_state_dict(sd, strict=True)
    return model, sd


def _state_sd(variables, names, gates):
    """Port-named parameters (and running statistics) of a JAX tree."""
    return {k: v for k, v in jax_variables_to_state_dict(
        variables, names, gates).items()
        if not k.endswith("num_batches_tracked")}


def _assert_sd_close(got, ref, atol, what):
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   atol=atol, err_msg=f"{what} {k}")


def _assert_keys_match_reference_export(sd, variables, names, gates,
                                        single_task=None):
    """The port's keys are params_to_reference_sd's (a SingleTaskModel's
    decoder exported as the one task's and named ``decoder``)."""
    params = dict(variables["params"])
    stats = dict(variables.get("batch_stats") or {})
    if single_task is not None:
        params[f"decoders_{single_task}"] = params.pop("decoder")
        stats[f"decoders_{single_task}"] = stats.pop("decoder")
    ref = params_to_reference_sd(params, stats, names, gates)
    if single_task is not None:
        pre = f"decoders.{single_task}."
        ref = {("decoder." + k[len(pre):] if k.startswith(pre) else k): v
               for k, v in ref.items()}
    ours = {k: v for k, v in sd.items() if "num_batches_tracked" not in k}
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def moe_run():
    """The MoE config (multi-gate, gate noise 0, train cf 1.25, eval cf
    0.5 so that eval drops slots) through JAX in one program, each part
    from the same state: the eval step with stats, a single-task eval, the
    one-by-one step (its per-task gradient programs, summed, the
    reference CLI's batch-stat merge, then the update, and the signs of
    each task pass's head BatchNorm outputs), a joint train step with the
    analysis metrics and the gate internals (M3VIT_LOG_GATE_INTERNALS
    set while it traces), and its updated parameters; and the outputs of
    the patch embedding, block 0 and the first head's first conv in
    eval."""
    p = _config("vit_moe_small_multi_task.yml", moe_eval_capacity_factor=0.5)
    jp = _jax_config(p)
    names = [tk.name for tk in jp["TASKS"]]
    v = _seeded_variables(p, names, len(names), seed=3)
    jmodel = jax_build_model(jp)
    lfns = jsch.build_loss_fns(jp)
    tx = jax_build_optimizer(OPT, steps_per_epoch=2)
    batch = _batch(15, jp["TASKS"])
    grad_fns, apply_fn = jstep.make_one_by_one_train_step(
        jmodel, names, lfns, WEIGHTS)
    eval_step = jstep.make_eval_step(jmodel, names, with_stats=True)
    single_eval = jstep.make_single_task_eval_step(jmodel, names[-1])
    train_step = jstep.make_train_step(jmodel, names, lfns, WEIGHTS,
                                       donate=False, analysis_metrics=True)
    traced = ("patch_embed", "block_0", "conv_0")

    def run(v, batch):
        state = TrainState.create(apply_fn=jmodel.apply, params=v["params"],
                                  tx=tx, batch_stats=v["batch_stats"])
        rng = jax.random.key(1)
        pred, stats = eval_step(state, batch)
        single = single_eval(state, batch)
        grads, metrics, merged = None, {}, {}
        for tk in names:
            g, m, bs = grad_fns[tk](state, batch, rng)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
            metrics[tk] = m
            merged[f"decoders_{tk}"] = bs[f"decoders_{tk}"]
        obo = apply_fn(state, grads, merged)
        joint, analysis = train_step(state, batch, rng)
        # each head's BatchNorm outputs in its own task pass (the joint
        # forward's passes are the one-by-one step's)
        bn = jmodel.apply(
            {"params": v["params"], "batch_stats": v["batch_stats"]},
            batch["image"], train=True, rngs={"gate_noise": rng},
            mutable=["batch_stats"],
            capture_intermediates=capture_bn)[1]["intermediates"]
        inter = jmodel.apply(
            v, batch["image"], train=False, mutable=["intermediates"],
            capture_intermediates=lambda m, _: m.name in traced)[1]
        return (pred, stats, single, grads, metrics,
                {"params": obo.params, "batch_stats": obo.batch_stats},
                bn, joint.params, inter["intermediates"], analysis)

    prev = os.environ.get(GATE_INTERNALS_ENV)
    os.environ[GATE_INTERNALS_ENV] = "1"
    try:
        out = _to_np(jax.jit(run, compiler_options=FAST_COMPILE)(
            v, {k: jnp.asarray(a) for k, a in batch.items()}))
    finally:
        if prev is None:
            del os.environ[GATE_INTERNALS_ENV]
        else:
            os.environ[GATE_INTERNALS_ENV] = prev
    return p, names, batch, v, out


def test_moe_model_keys_match_reference_export(moe_run):
    p, names, _, v, _ = moe_run
    _, sd = _port_model(p, v, names, len(names))
    _assert_keys_match_reference_export(sd, v, names, len(names))


def test_eval_step_with_stats_matches_jax(moe_run, monkeypatch):
    """make_eval_step(with_stats): every task's output (1e-4) and the MoE
    stats (dropped_slot_fraction 1e-7 absolute, sums 1e-5 relative, counts
    and the load histogram exactly); eval cf 0.5 drops slots, which the
    guard refuses.  make_single_task_eval_step too."""
    p, names, batch, v, (jpred, jstats, jsingle, *_rest) = moe_run
    monkeypatch.setenv(GATE_INTERNALS_ENV, "1")
    model, _ = _port_model(p, v, names, len(names))
    tb = {"image": _nchw(batch["image"])}
    pred, stats = make_eval_step(model, names, with_stats=True)(tb)
    for n in names:
        np.testing.assert_allclose(pred[n].numpy().transpose(0, 2, 3, 1),
                                   jpred[n], atol=1e-4, err_msg=n)
    assert set(stats) == set(jstats)
    assert jstats["dropped_slot_fraction"] > 0
    for k, ref in jstats.items():
        got = stats[k].numpy()
        if k in ("moe_stat_count", "gate_token_count", "expert_load_hist"):
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    guard = _DropGuard({})
    guard.update(stats)
    with pytest.raises(RuntimeError, match="moe_eval_capacity_factor: nodrop"):
        guard.check()
    assert not any(m.gate_stats for m in model.modules()
                   if hasattr(m, "gate_stats"))
    task = names[-1]
    single = make_single_task_eval_step(model, task)(tb)
    assert set(single) == {task}
    np.testing.assert_allclose(single[task].numpy().transpose(0, 2, 3, 1),
                               jsingle[task], atol=1e-4)


def _train_batch(batch):
    return {k: _nchw(v) for k, v in batch.items()}


def test_one_by_one_step_matches_jax(moe_run):
    """One one-by-one step at gate noise 0: each task's loss (1e-5
    relative), the gradients summed over the task passes (1e-4 of each
    tensor's largest magnitude: f32 sums in another order), and the
    parameters and BN running statistics after the SGD update (2e-6, as
    the joint step's test).  The heads' ReLU masks are JAX's, replayed
    (tests/torch_port_replay.py)."""
    p, names, batch, v, (_, _, _, jgrads, jmetrics, jnew, jbn,
                               *_rest) = moe_run
    model, _ = _port_model(p, v, names, len(names))
    opt, schedule = build_optimizer(model.parameters(), OPT,
                                    steps_per_epoch=2)
    step = make_one_by_one_train_step(model, names, tsch.build_loss_fns(p),
                                      WEIGHTS, opt, schedule)
    masks = head_masks(jbn, names)
    with replay_head_masks(model, masks):
        metrics = step(_train_batch(batch))
    for n in names:
        np.testing.assert_allclose(metrics[f"loss_{n}"].item(),
                                   float(jmetrics[n][f"loss_{n}"]),
                                   rtol=1e-5, err_msg=n)
    np.testing.assert_allclose(
        metrics["loss_total"].item(),
        sum(float(m["loss_total"]) for m in jmetrics.values()), rtol=1e-5)
    ref = jax_variables_to_state_dict({"params": jgrads}, names, len(names))
    for k, prm in model.named_parameters():
        scale = max(float(ref[k].abs().max()), 1e-3)
        np.testing.assert_allclose(prm.grad.numpy(), ref[k].numpy(),
                                   atol=1e-4 * scale, err_msg=k)
    _assert_sd_close(model.state_dict(), _state_sd(jnew, names, len(names)),
                     2e-6, "after the step:")


def test_head_grads_of_joint_step_equal_one_by_one(moe_run):
    """A head's gradient in the joint step (one backbone pass per task)
    equals its gradient in its own task pass alone, bit for bit, in each
    package: JAX's joint step updates every head's parameters as its
    one-by-one step does, and so does the port's (ROADMAP.md queue 3:
    neither side moves the heads' gradients with the task passes; the
    packages' gap there is a head ReLU mask rounded to opposite signs,
    tests/torch_port_replay.py)."""
    p, names, batch, v, (*_r, jobo, _, jjoint, _, _) = moe_run
    for n in names:
        key = f"decoders_{n}"
        for (path, a), b in zip(
                jax.tree_util.tree_leaves_with_path(jjoint[key]),
                jax.tree_util.tree_leaves(jobo["params"][key])):
            np.testing.assert_array_equal(a, b, err_msg=f"{key}{path}")
    grads = {}
    for kind in ("joint", "one_by_one"):
        model, _ = _port_model(p, v, names, len(names))
        opt, schedule = build_optimizer(model.parameters(), OPT,
                                        steps_per_epoch=2)
        make = make_train_step if kind == "joint" else \
            make_one_by_one_train_step
        make(model, names, tsch.build_loss_fns(p), WEIGHTS, opt,
             schedule)(_train_batch(batch))
        grads[kind] = {k: prm.grad for k, prm in model.named_parameters()
                       if k.startswith("decoders.")}
    assert set(grads["joint"]) == set(grads["one_by_one"])
    for k, g in grads["joint"].items():
        torch.testing.assert_close(g, grads["one_by_one"][k], rtol=0,
                                   atol=0, msg=k)


def test_analysis_metrics_match_jax(moe_run, monkeypatch):
    """make_train_step(analysis_metrics=True): the analysis metrics, the
    gate internals (M3VIT_LOG_GATE_INTERNALS set on both sides) and the
    losses of one joint step at gate noise 0 (1e-5 relative; the load
    histogram exactly); without the flag the step returns none of them."""
    p, names, batch, v, (*_rest, janalysis) = moe_run
    monkeypatch.setenv(GATE_INTERNALS_ENV, "1")
    assert "topk_group_count_mean" in janalysis
    model, _ = _port_model(p, v, names, len(names))
    opt, schedule = build_optimizer(model.parameters(), OPT,
                                    steps_per_epoch=2)
    step = make_train_step(model, names, tsch.build_loss_fns(p), WEIGHTS,
                           opt, schedule, analysis_metrics=True)
    metrics = step(_train_batch(batch))
    assert set(metrics) == set(janalysis)
    for k, ref in janalysis.items():
        if k == "expert_load_hist":
            np.testing.assert_array_equal(metrics[k].numpy(), ref)
        else:
            np.testing.assert_allclose(metrics[k].item(), float(ref),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert "gate_entropy_mean" not in make_train_step(
        model, names, tsch.build_loss_fns(p), WEIGHTS, opt,
        schedule)(_train_batch(batch))


def test_gate_internals_need_the_variable(monkeypatch):
    """The gate internals are computed only when M3VIT_LOG_GATE_INTERNALS
    is set (to 1 / true / yes / on); with E % 4 != 0 the groups are single
    experts, with the JAX package's warning, so the group count is the
    number of distinct experts, K."""
    rng = np.random.RandomState(2)
    logits = t(rng.randn(12, 6).astype(np.float32))
    gate = tgate.noisy_vmoe_gate(logits, torch.eye(6), top_k=3)
    monkeypatch.delenv(GATE_INTERNALS_ENV, raising=False)
    assert "gate_pmax_sum" not in MoEMlp.analysis_stats(gate)
    monkeypatch.setenv(GATE_INTERNALS_ENV, "off")
    assert "gate_pmax_sum" not in MoEMlp.analysis_stats(gate)
    monkeypatch.setenv(GATE_INTERNALS_ENV, "yes")
    with pytest.warns(UserWarning, match="group_size=1"):
        st = MoEMlp.analysis_stats(gate)
    assert float(st["topk_group_count_sum"]) == 12 * 3
    probs = torch.softmax(logits, -1)
    np.testing.assert_allclose(float(st["gate_pmax_sum"]),
                               float(probs.max(-1).values.sum()), rtol=1e-6)


def test_one_by_one_accumulation_matches_jax():
    """--one_by_one with accumulation_steps 2 over four batches: the port's
    one-by-one step against the JAX package's per-task gradient programs
    and apply (make_one_by_one_train_step) under optax.MultiSteps(2), as
    the JAX CLI runs them (m3vit_tpu/cli/train.py:796-812: the task
    gradients of a batch summed, each decoder's statistics from its own
    pass), on a two-task toy model (a linear map and a statistic per
    task): the optimizer steps on the mean of two batches' summed task
    gradients, every second batch, at the schedule's lr of the optimizer
    step; parameters and statistics after every batch to 1e-6 (SGD, as
    test_optimizer_trajectory_matches_optax)."""
    from flax import linen as fnn

    names, D = ["a", "b"], 6
    cfg = {"optimizer": "sgd", "scheduler": "poly", "epochs": 2,
           "accumulation_steps": 2,
           "optimizer_kwargs": {"lr": 0.1, "momentum": 0.9,
                                "weight_decay": 1e-2}}
    rng = np.random.RandomState(21)
    w0 = rng.randn(len(names), D).astype(np.float32)
    batches = [{"image": rng.randn(3, D).astype(np.float32),
                **{n: rng.randn(3).astype(np.float32) for n in names}}
               for _ in range(4)]

    class JToy(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False, single_task=None):
            w = self.param("w", lambda k: jnp.asarray(w0))
            i = names.index(single_task)
            pred = x @ w[i]
            stat = self.variable("batch_stats", f"decoders_{single_task}",
                                 lambda: jnp.zeros(()))
            if train:
                stat.value = 0.9 * stat.value + 0.1 * pred.mean()
            return {single_task: pred}, jnp.zeros(()), {}

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(t(w0.copy()))
            for n in names:
                self.register_buffer(f"stat_{n}", torch.zeros(()))

        def forward(self, x, single_task=None, noise=None):
            pred = x @ self.w[names.index(single_task)]
            if self.training:
                buf = getattr(self, f"stat_{single_task}")
                buf.mul_(0.9).add_(0.1 * pred.detach().mean())
            return {single_task: pred}, torch.zeros(()), {}

    def mse(pred, gt):
        return ((pred - gt) ** 2).mean()

    weights = {"a": 1.0, "b": 2.0}
    jmodel = JToy()
    variables = jmodel.init(jax.random.key(0), jnp.zeros((3, D)),
                            single_task="a")
    for n in names[1:]:
        variables = {**variables, "batch_stats": {
            **variables["batch_stats"],
            **jmodel.init(jax.random.key(0), jnp.zeros((3, D)),
                          single_task=n)["batch_stats"]}}
    grad_fns, apply_fn = jstep.make_one_by_one_train_step(
        jmodel, names, {n: mse for n in names}, weights, cv_weight=0.0)
    state = TrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        tx=jax_build_optimizer(cfg, steps_per_epoch=4),
        batch_stats=variables["batch_stats"])
    model = Toy()
    opt, schedule = build_optimizer(model.parameters(), cfg,
                                    steps_per_epoch=4)
    step = make_one_by_one_train_step(model, names, {n: mse for n in names},
                                      weights, opt, schedule, cv_weight=0.0,
                                      accumulation_steps=2)
    key = jax.random.key(1)
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(a) for k, a in b.items()}
        grads, merged = None, {}
        for n in names:
            g, _, bs = grad_fns[n](state, jb, key)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
            merged[f"decoders_{n}"] = bs[f"decoders_{n}"]
        state = apply_fn(state, grads, merged)
        metrics = step({k: t(a.copy()) for k, a in b.items()})
        np.testing.assert_allclose(model.w.detach().numpy(),
                                   np.asarray(state.params["w"]), atol=1e-6,
                                   err_msg=f"batch {i}")
        for n in names:
            np.testing.assert_allclose(
                getattr(model, f"stat_{n}").item(),
                float(state.batch_stats[f"decoders_{n}"]), atol=1e-6,
                err_msg=f"batch {i} {n}")
        assert set(metrics) == {"loss_a", "loss_b", "loss_cv", "loss_total"}
        assert (i % 2 == 1) != np.allclose(np.asarray(state.params["w"]),
                                           w0) or i > 1
    assert step.step == 4 and not np.allclose(model.w.detach().numpy(), w0)


def test_trace_matches_jax_trace(moe_run, tmp_path):
    """utils/tracing.py: the port's trace of an eval forward, dumped and
    read back, against the JAX package's summaries of the same layers on
    the same weights (patch embedding, block 0, the first head's first
    conv, in NHWC order), by numeric_diff: within 1e-4, the model
    outputs' tolerance."""
    from m3vit_tpu.utils.tracing import _summarize as jax_summarize
    from m3vit_tpu.utils.tracing import dump_trace as jax_dump

    p, names, batch, v, (*_r, inter, _) = moe_run
    model, _ = _port_model(p, v, names, len(names))
    model.eval()
    keep = {"backbone.patch_embed": "backbone/patch_embed",
            "backbone.blocks.0": "backbone/block_0",
            f"decoders.{names[0]}.conv_0": f"decoders_{names[0]}/conv_0"}
    traces = trace_model(model, _nchw(batch["image"]),
                         filter_fn=lambda name: name in keep)
    dump_trace(traces, str(tmp_path / "port.log"))
    ours = load_trace(str(tmp_path / "port.log"))
    assert set(ours) == set(keep)
    jtraces = {}
    for port_name, jname in keep.items():
        node = inter
        for part in jname.split("/"):
            node = node[part]
        # the module's last call (the port's hook keeps its last output)
        jtraces[port_name] = jax_summarize(node["__call__"][-1])
    jax_dump(jtraces, str(tmp_path / "jax.log"))
    theirs = load_trace(str(tmp_path / "jax.log"))
    for k in keep:
        assert ours[k]["shape"][-1] == theirs[k]["shape"][-1], k
        assert len(ours[k]["first"]) == 100
        np.testing.assert_allclose(ours[k]["mean"], theirs[k]["mean"],
                                   atol=1e-5, err_msg=k)
    diffs = numeric_diff(ours, theirs)
    assert set(diffs) == set(keep)
    assert max(diffs.values()) < 1e-4, diffs


MODEL_CASES = {
    "dense_multi_task": ("vit_small_dense_multi_task.yml", TASK_DICT, {}),
    "dense_single_task": ("vit_small_dense_multi_task.yml",
                          {"include_semseg": True}, {"setup": "single_task"}),
    # eval only: JAX draws the learned-noise gate's normals per block from
    # its key, which the port cannot reproduce
    "moe_noisy_single_task": ("vit_moe_small_multi_task.yml",
                              {"include_semseg": True},
                              {"setup": "single_task",
                               "moe_gate_type": "noisy"}),
}


@pytest.fixture(scope="module")
def model_runs():
    """The dense config as a multi-task model and as a SingleTaskModel
    (setup single_task, semseg alone), and the MoE config with the
    learned-noise gate (setup single_task), in one JAX program: each
    model's eval forward and, for the dense ones, one train step (SGD)."""
    cases = {k: _config(name, tdict, **over)
             for k, (name, tdict, over) in MODEL_CASES.items()}
    jps = {k: _jax_config(p) for k, p in cases.items()}
    names = {k: [tk.name for tk in jp["TASKS"]] for k, jp in jps.items()}
    gates = {k: len(names[k]) if cases[k].get("multi_gate") else 0
             for k in cases}
    models = {k: jax_build_model(jp) for k, jp in jps.items()}
    variables = {k: _seeded_variables(cases[k], names[k], gates[k], seed=4)
                 for k in cases}
    batches = {k: _batch(16, jp["TASKS"]) for k, jp in jps.items()}
    tx = jax_build_optimizer(OPT, steps_per_epoch=2)
    steps = {k: jstep.make_train_step(models[k], names[k],
                                      jsch.build_loss_fns(jps[k]), WEIGHTS,
                                      donate=False)
             for k in cases if k.startswith("dense")}

    def run(variables, batches):
        out = {}
        for k, m in models.items():
            v = variables[k]
            res = {"pred": m.apply(v, batches[k]["image"], train=False)[0]}
            if k in steps:
                state = TrainState.create(
                    apply_fn=m.apply, params=v["params"], tx=tx,
                    batch_stats=v["batch_stats"])
                state, res["metrics"] = steps[k](state, batches[k],
                                                 jax.random.key(1))
                res["new"] = {"params": state.params,
                              "batch_stats": state.batch_stats}
            out[k] = res
        return out

    out = _to_np(jax.jit(run, compiler_options=FAST_COMPILE)(
        variables, {k: {n: jnp.asarray(a) for n, a in b.items()}
                    for k, b in batches.items()}))
    return cases, names, gates, variables, batches, out


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_factory_model_matches_jax(model_runs, case):
    """build_model on the same YAML dict as the JAX factory: the same
    model class, keys equal to params_to_reference_sd's, the eval outputs
    (1e-4), and for the dense models one train step: losses 1e-5
    relative, parameters and BN running statistics 2e-6."""
    cases, names, gates, variables, batches, out = model_runs
    p, res, names, gates = cases[case], out[case], names[case], gates[case]
    model, sd = _port_model(p, variables[case], names, gates)
    single = case == "dense_single_task"
    assert isinstance(model, SingleTaskModel) == single
    _assert_keys_match_reference_export(sd, variables[case], names, gates,
                                        single_task=names[0] if single
                                        else None)
    if case.startswith("moe"):
        assert any(k.endswith("gate.0.w_noise") for k in sd)
    x = _nchw(batches[case]["image"])
    with torch.no_grad():
        pred = model(x)[0]
    assert set(pred) == set(names)
    if single:
        with pytest.raises(ValueError, match="runs 'semseg' only"):
            model(x, single_task="normals")
    for n in names:
        np.testing.assert_allclose(pred[n].numpy().transpose(0, 2, 3, 1),
                                   res["pred"][n], atol=1e-4, err_msg=n)
    if "metrics" not in res:
        return
    opt, schedule = build_optimizer(model.parameters(), OPT,
                                    steps_per_epoch=2)
    step = make_train_step(model, names, tsch.build_loss_fns(p), WEIGHTS,
                           opt, schedule)
    metrics = step(_train_batch(batches[case]))
    for k, ref in res["metrics"].items():
        np.testing.assert_allclose(metrics[k].item(), float(ref),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    _assert_sd_close(model.state_dict(), _state_sd(res["new"], names, 0),
                     2e-6, "after the step:")


@pytest.mark.parametrize("key,value,match", [
    ("backbone", "resnet18", "queue 1 items 7 and 8"),
    ("head", "deeplab", "queue 1 items 7 and 8"),
    ("model", "mtan", "queue 1 item 8"),
    ("stacked_tasks", True, "queue 1 item 7"),
    ("gate_task_specific_dim", 64, "queue 1 item 7"),
])
def test_build_model_refuses_what_is_not_ported(key, value, match):
    """What the JAX factory builds and the port does not yet raises, naming
    the ROADMAP item that ports it."""
    p = _config("vit_moe_small_multi_task.yml", **{key: value})
    with pytest.raises(NotImplementedError, match=match):
        build_model(p, device="cpu")


def test_chip_smoke_dense_config_is_the_yaml():
    """chip_smoke.py builds its dense model from a literal dict (the card
    may lack PyYAML); it must be the YAML on every key it holds, and hold
    every key build_model reads."""
    import chip_smoke

    with open(ROOT / "configs" / "pascal"
              / "vit_small_dense_multi_task.yml") as f:
        ref = yaml.safe_load(f)
    lit = chip_smoke.DENSE_CONFIG
    read = {"setup", "train_db_name", "task_dictionary", "model", "backbone",
            "backbone_kwargs", "head", "head_kwargs", "compute_dtype"}
    assert read <= set(lit) <= set(ref)
    assert {k: ref[k] for k in lit} == lit
