"""The JAX side of tests/test_torch_port_knobs.py, run in worker processes
so that its programs trace and compile side by side:

    python -m tests.torch_port_knobs_jax OUT_DIR GROUP [GROUP ...]

A group (``GROUPS``) is some knob backbones and the gates, or the sem
train step.  A backbone's weights are drawn with numpy into the shapes of
its flax variables (``jax.eval_shape`` of the init, with ``sem`` where
the regu_sem head must exist); each group runs one jitted program (XLA's
lowest CPU level) and pickles the inputs, the variables and the results to
OUT_DIR/GROUP.pkl.  The "step" group takes its weights from the test
(OUT_DIR/step_weights.pkl, written before the workers start).
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

import jax
import jax.numpy as jnp
from flax import linen as nn

from m3vit_tpu.models import gate_vit as jgv
from m3vit_tpu.models import vit_moe as jvm
from m3vit_tpu.models.heads import VisionTransformerUpHead as JHead
from m3vit_tpu.models.multitask import MultiTaskModel as JMultiTask
from m3vit_tpu.moe import gating as jg
from tests.jax_fast_compile import FAST_COMPILE

IMG, B, E, K, T = 128, 2, 16, 4, 3
STEP_IMG = 80   # the sem step's images: a 5 x 5 patch grid, one subimage
NAMES = ["semseg", "sal", "normals"]
STEP_NAMES = ["semseg"]   # the sem step's tasks: its cost is its heads'
NUM_OUT = {"semseg": 21, "sal": 1, "normals": 3}
WEIGHTS = {"semseg": 1.0, "sal": 5.0, "normals": 10.0}
ARCH = dict(img_size=(IMG, IMG), patch_size=16, embed_dim=32, depth=2,
            num_heads=2, moe_mlp_ratio=1.0, moe_experts=E, moe_top_k=K,
            multi_gate=True, num_tasks=T, capacity_factor=1.25,
            eval_capacity_factor=2.0, vmoe_noisy_std=0.0)
GATE_DIM = 16
#: backbone -> its knobs ("gated": wrapped with a one-block gate ViT)
BACKBONES = {
    "force": dict(sem_force=True, regu_sem=True, regu_subimage=True),
    "win3": dict(regu_experts_fromtask=True, num_experts_pertask=8),
    "win5": dict(regu_experts_fromtask=True, num_experts_pertask=8,
                 multi_gate=False, num_tasks=5),
    "prune": dict(expert_prune=True),
    "ahead": dict(gate_input_ahead=True),
    "distilled": dict(distilled=True),
    "plain": {},
    "gated": {},
}
#: backbone -> [(label, one apply's arguments)]
CALLS = {
    "force": [("train_t0", dict(task_id=0, train=True, sem=True)),
              ("eval_t1", dict(task_id=1, sem=True))],
    "win3": [("eval_t1", dict(task_id=1)),
             ("train_t2", dict(task_id=2, train=True))],
    "win5": [("eval_t4", dict(task_id=4)),
             ("train_t4", dict(task_id=4, train=True))],
    "prune": [("train_t1", dict(task_id=1, train=True))],
    "ahead": [("eval_t0", dict(task_id=0)),
              ("train_prefix", dict(task_id=list(range(T)),
                                    shared_prefix=True, train=True))],
    "distilled": [("train_t1", dict(task_id=1, train=True))],
    "plain": [("train_stacked", dict(task_id=list(range(T)),
                                     stacked_tasks=True, train=True)),
              ("eval_masked", dict(task_id=0, expert_mask=True))],
    "gated": [("train_t1", dict(task_id=1, train=True))],
}
MASK = np.array([i % 3 != 1 for i in range(E)])   # 11 experts routable
#: worker group -> its backbones (and "gates", "step")
GROUPS = {"a": ("force", "win3"), "b": ("win5", "prune", "distilled"),
          "c": ("ahead", "plain"), "d": ("gated", "gates"),
          "step": ("step",)}
STEP_KNOBS = dict(sem_force=True, regu_sem=True, regu_subimage=True)
OPT = {"optimizer": "sgd", "scheduler": "poly", "epochs": 3,
       "optimizer_kwargs": {"lr": 0.01, "momentum": 0.0,
                            "weight_decay": 0.0}}


def draw(shapes, seed: int):
    """numpy values for a flax variable tree of `shapes`: fan-in scaled
    kernels, expert banks and routers, LayerNorm / BatchNorm scales near
    1, BatchNorm statistics with variances in [0.5, 1.5], small biases,
    embeddings and tokens."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if path[0].key == "batch_stats":
            return (rng.random(s.shape) + 0.5 if name == "var"
                    else 0.1 * rng.standard_normal(s.shape)
                    ).astype(np.float32)
        z = rng.standard_normal(s.shape)
        if name in ("kernel", "w_gate", "experts_w1", "experts_w2"):
            z = z / np.sqrt(np.prod(s.shape[-4:-1]) if len(s.shape) == 4
                            else s.shape[-2])
        elif name == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def sem_labels(rng, img: int = IMG):
    """[B, img, img] labels a patch: mostly background (class 0, which
    forces experts 0 / 1 past their capacity), some 15 and 7, some 255, a
    few patches of mixed pixels (no class over 40%)."""
    g = img // 16
    cls = rng.choice([0, 0, 0, 0, 0, 15, 7, 255], size=(B, g, g))
    lab = np.kron(cls, np.ones((16, 16))).astype(np.float32)
    for b, i, j in ((0, 1, 2), (1, g - 1, g - 1)):
        lab[b, i * 16:(i + 1) * 16, j * 16:(j + 1) * 16] = rng.integers(
            0, 21, (16, 16))
    return lab


def inputs():
    """The images [B, IMG, IMG, 3], their labels and the gate tests'
    inputs, from one seed (every worker makes the same)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    sem = sem_labels(rng)
    ginp = rng.standard_normal((60, 8)).astype(np.float32)
    gw = (rng.standard_normal((8, E)) / np.sqrt(8)).astype(np.float32)
    gwn = (rng.standard_normal((8, E)) / np.sqrt(8)).astype(np.float32)
    sub = rng.standard_normal((2, 100, E)).astype(np.float32)
    return {"x": x, "sem": sem, "gate": (ginp, gw, gwn), "sub": sub}


def jbackbone(name):
    kw = {**ARCH, **BACKBONES[name]}
    bb = jvm.VisionTransformerMoE(dtype=jnp.float32, use_checkpointing=False,
                                  **kw)
    if name == "gated":
        return jgv.MoEViTWithGate(
            backbone=bb, gate_model=jgv.GateViT(
                img_size=(IMG, IMG), embed_dim=GATE_DIM, depth=1,
                num_heads=2))
    return bb


class Recorder:
    """flax interceptor: each MoEMlp's gate top-k ids, in call order."""

    def __init__(self):
        self.ids = []

    def __call__(self, next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, jvm.MoEMlp) \
                and context.method_name == "__call__":
            self.ids.append(out[1].top_k_indices)
        return out


def _apply_kwargs(kw, sem):
    kw = dict(kw)
    kw["task_id"] = jnp.asarray(kw["task_id"], jnp.int32)
    if kw.pop("sem", False):
        kw["sem"] = sem
    if kw.pop("expert_mask", False):
        kw["expert_mask"] = jnp.asarray(MASK)
    if kw.get("train"):
        kw["rngs"] = {"gate_noise": jax.random.key(0)}
    return kw


def run_backbones(names, inp):
    """Each backbone's variables and every call of CALLS: tokens, cv loss,
    stats and each MoE layer's gate ids; "gated" also its gate ViT's
    features alone."""
    x, sem = inp["x"], inp["sem"]
    models = {n: jbackbone(n) for n in names}
    variables = {
        n: draw(jax.eval_shape(lambda m=m, n=n: m.init(
            {"params": jax.random.key(0), "gate_noise": jax.random.key(1)},
            x, task_id=jnp.asarray(0),
            **({"sem": sem} if n == "force" else {}))),
            10 + list(BACKBONES).index(n))
        for n, m in models.items()}

    def program(variables, x, sem):
        res = {}
        for n, m in models.items():
            for label, kw in CALLS[n]:
                rec = Recorder()
                with nn.intercept_methods(rec):
                    out = m.apply(variables[n], x, **_apply_kwargs(kw, sem))
                res[(n, label)] = {"tokens": out[0], "cv": out[1],
                                   "stats": out[2], "ids": rec.ids}
            if n == "gated":
                res[(n, "gate_features")] = m.gate_model.apply(
                    {"params": variables[n]["params"]["gate_model"]}, x)
        return res

    args = (variables, x, sem)
    res = jax.jit(program).lower(*args).compile(FAST_COMPILE)(*args)
    return {"variables": variables,
            "results": jax.tree_util.tree_map(np.asarray, res)}


def run_gates(inp):
    """Both gates with the expert mask in training, their noise JAX's own
    normal draw (returned for the port), the per-segment statistics and
    cv loss, the sem functions."""

    def program(ginp, gw, gwn, sem, sub):
        key = jax.random.key(5)
        mask = jnp.asarray(MASK)
        g = {"noise": jax.random.normal(key, (60, E), jnp.float32)}
        g["vmoe"] = jg.noisy_vmoe_gate(ginp, gw, top_k=K, noise_std=1.0,
                                       train=True, rng=key, expert_mask=mask)
        g["noisy"] = jg.noisy_gate(ginp, gw, gwn, top_k=K, train=True,
                                   rng=key, expert_mask=mask)
        g["aux3"] = jg.moe_aux_loss(g["vmoe"], K, E, True, segments=3)
        g["imp3"] = jg.gate_importance(g["vmoe"], segments=3)
        g["load3"] = jg.gate_load_counts(g["vmoe"], segments=3)
        g["labels"] = jvm.patch_majority_labels(sem, 16)
        g["force"] = jvm.build_sem_force_routing(
            g["labels"].reshape(B, -1), K, 1)
        g["subimage"] = jvm._regu_subimage_loss(sub, 5)
        return g

    args = (*inp["gate"], inp["sem"], inp["sub"])
    res = jax.jit(program).lower(*args).compile(FAST_COMPILE)(*args)
    return jax.tree_util.tree_map(np.asarray, res)


def step_batch():
    """The sem step's batch, NHWC: STEP_IMG images and STEP_NAMES'
    labels, semseg with the patch pattern."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, STEP_IMG, STEP_IMG, 3)).astype(np.float32)
    nrm = rng.standard_normal((B, STEP_IMG, STEP_IMG, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    batch = {"image": x, "semseg": sem_labels(rng, STEP_IMG)[..., None],
             "sal": (rng.random((B, STEP_IMG, STEP_IMG, 1)) > 0.7).astype(
                 np.float32),
             "normals": nrm.astype(np.float32)}
    return {k: v for k, v in batch.items() if k in ["image"] + STEP_NAMES}


def step_model():
    arch = {**ARCH, **STEP_KNOBS, "img_size": (STEP_IMG, STEP_IMG)}
    bb = jvm.VisionTransformerMoE(dtype=jnp.float32, use_checkpointing=False,
                                  **arch)
    heads = {n: JHead(img_size=(STEP_IMG, STEP_IMG), patch_size=16,
                      embed_dim=32, num_classes=NUM_OUT[n])
             for n in STEP_NAMES}
    return JMultiTask(backbone=bb, decoders=heads, tasks=STEP_NAMES,
                      multi_gate=True, shared_prefix=True)


def run_step(out_dir: str):
    """One JAX sem train step (make_train_step(pass_sem=True); SGD without
    momentum or decay, so an update is -lr x the gradient) of the step
    model, its weights the port's seeded init (OUT_DIR/step_weights.pkl,
    a reference-format state dict) carried in by the JAX package's own
    reference converter."""
    from m3vit_tpu.train.optim import build_optimizer as jax_build_optimizer
    from m3vit_tpu.train.state import TrainState
    from m3vit_tpu.train.step import make_train_step as jax_make_train_step
    from m3vit_tpu.utils.torch_interop import reference_mtl_sd_to_params

    with open(os.path.join(out_dir, "step_weights.pkl"), "rb") as f:
        sd = pickle.load(f)
    params, stats = reference_mtl_sd_to_params(sd, STEP_NAMES,
                                               multi_gate_tasks=T)
    for k, w in sd.items():   # the regu_sem heads (the converter's gap)
        if k.endswith("regu_sem_head.weight"):
            blk = params["backbone"][f"block_{k.split('.')[2]}"]["mlp"]
            blk["regu_sem_head"] = {"kernel": w.T,
                                    "bias": sd[k[:-len("weight")] + "bias"]}
    batch = step_batch()
    model = step_model()
    tx = jax_build_optimizer(OPT, steps_per_epoch=2)
    from m3vit_tpu.losses.functions import loss_fn_for_task as jax_loss_fn

    jstep = jax_make_train_step(
        model, STEP_NAMES, {n: jax_loss_fn(n, {"edge_w": 0.95})
                            for n in STEP_NAMES},
        WEIGHTS, donate=False, pass_sem=True)

    def program(params, stats, batch):
        state = TrainState.create(apply_fn=model.apply, params=params, tx=tx,
                                  batch_stats=stats)
        new, metrics = jstep(state, batch, jax.random.key(0))
        return new.params, metrics

    args = (params, stats, batch)
    out = jax.jit(program).lower(*args).compile(FAST_COMPILE)(*args)
    new, metrics = jax.tree_util.tree_map(np.asarray, out)
    return {"batch": batch, "variables": {"params": params,
                                          "batch_stats": stats},
            "new_params": new,
            "metrics": {k: float(m) for k, m in metrics.items()}}


def run_group(group: str, out_dir: str):
    inp = inputs()
    out = {"inputs": inp}
    names = [n for n in GROUPS[group] if n in BACKBONES]
    if names:   # one program for the group's backbones
        out.update(run_backbones(names, inp))
    if "gates" in GROUPS[group]:
        out["gates"] = run_gates(inp)
    if "step" in GROUPS[group]:
        out["step"] = run_step(out_dir)
    return out


def main(argv):
    out_dir, groups = argv[0], argv[1:]
    for group in groups:
        res = run_group(group, out_dir)
        tmp = os.path.join(out_dir, f".{group}.pkl")
        with open(tmp, "wb") as f:
            pickle.dump(res, f)
        os.replace(tmp, os.path.join(out_dir, f"{group}.pkl"))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1:])
