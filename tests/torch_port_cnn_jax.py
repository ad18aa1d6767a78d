"""The JAX side of tests/test_torch_port_cnn.py, run in worker processes
so that the JAX programs trace and compile side by side:

    python -m tests.torch_port_cnn_jax OUT_DIR CASE [CASE ...]

For each case (``CASES``) it builds the JAX model, draws its weights with
numpy from the case's seed into the shapes of its flax variables
(``jax.eval_shape`` of its init, so no init program is compiled, and the
BatchNorm statistics are not the trivial 0 / 1), runs one program (XLA's
lowest CPU level) with the eval forward and a train forward with the
gradient of sum(sin(outputs)) with respect to every parameter, and
pickles the variables, the input, the outputs, the new batch_stats, the
gradients, the train forward's ReLU masks and dropout masks in call order
to OUT_DIR/CASE.pkl.

ReLU masks: every ``jax.nn.relu`` of the JAX modules records the mask it
applies, so the port can replay it (a BatchNorm output within f32
rounding of 0 takes opposite signs in the two packages; ROADMAP.md
queue 3).  Dropout: flax's nn.Dropout is intercepted and given a mask
drawn with numpy.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import sys

import numpy as np

import jax
import jax.numpy as jnp
from flax import linen as nn

from m3vit_tpu.models import cnn_heads as jheads
from m3vit_tpu.models import mtl_methods as jmtl
from m3vit_tpu.models.hrnet import HighResolutionNet
from m3vit_tpu.models.mobilenetv3 import MobileNetV3
from m3vit_tpu.models.resnet import ResNet
from tests.jax_fast_compile import FAST_COMPILE

HR_SMALL = dict(channels=(16, 16, 32, 64), stage_modules=(1, 1, 1),
                stage1_blocks=1, num_blocks=1)
RN_SMALL = dict(block="basic", layers=(1, 1, 1, 1), dilate_scale=8)
TASKS = ["semseg", "depth"]
AUX = ["semseg", "depth", "normals"]
NUM_OUT = {"semseg": 5, "depth": 1, "normals": 3}
MTI_CH = (16, 16, 16, 16)


class Streams(nn.Module):
    """Four streams at /1, /2, /4, /8 of x, for the HRNet head."""

    @nn.compact
    def __call__(self, x, train=False):
        return [x] + [nn.avg_pool(x, (s, s), (s, s)) for s in (2, 4, 8)]


class HeadAndFuse(nn.Module):
    """The HRNet head and the fuse module over the same four streams."""

    @nn.compact
    def __call__(self, x, train=False):
        xs = Streams()(x)
        return (jheads.HighResolutionHead(num_classes=3, name="head")(
            xs, train), jheads.HighResolutionFuse(name="fuse")(xs, train))


class StandIn(nn.Module):
    """Four strided streams of x standing in for HRNet under MTI-Net (the
    full HRNet costs a minute of JAX compile): a 4x4 stride-4 conv, then
    three stride-2 3x3 convs, each with ReLU."""

    @nn.compact
    def __call__(self, x, task_id=None, train=False):
        h = jax.nn.relu(nn.Conv(MTI_CH[0], (4, 4), strides=(4, 4),
                                padding="VALID", name="conv0")(x))
        xs = [h]
        for i in (1, 2, 3):
            h = jax.nn.relu(nn.Conv(MTI_CH[i], (3, 3), strides=(2, 2),
                                    padding=((1, 1), (1, 1)),
                                    name=f"conv{i}")(h))
            xs.append(h)
        return xs


def _hr_heads():
    return {t: jheads.HighResolutionHead(num_classes=NUM_OUT[t])
            for t in TASKS}


def _stitched(cls):
    return cls(backbones={t: ResNet(**RN_SMALL) for t in TASKS},
               heads=_hr_heads(), tasks=TASKS, channels=(64, 128, 256, 512))


#: case -> (model builder, input shape NHWC, whether to run the eval
#: forward); every input is 2 images
CASES = {
    "resnet-basic-0": (lambda: ResNet(block="basic", layers=(1, 1, 1, 1),
                                      dilate_scale=0), (2, 64, 64, 3), True),
    "resnet-basic-8": (lambda: ResNet(**RN_SMALL), (2, 64, 64, 3), True),
    "resnet-bottleneck-16": (
        lambda: ResNet(block="bottleneck", layers=(1, 1, 1, 1),
                       dilate_scale=16), (2, 64, 64, 3), True),
    "hrnet": (lambda: HighResolutionNet(**HR_SMALL), (2, 64, 64, 3), True),
    "mobilenetv3-small": (lambda: MobileNetV3(variant="small"),
                          (2, 64, 64, 3), True),
    "mobilenetv3-large": (lambda: MobileNetV3(variant="large"),
                          (2, 64, 64, 3), True),
    "deeplab": (lambda: jheads.DeepLabHead(num_classes=5), (2, 8, 8, 32),
                True),
    "hrnet-head": (HeadAndFuse, (2, 16, 16, 8), True),
    "cross_stitch": (lambda: _stitched(jmtl.CrossStitchNetwork),
                     (2, 64, 64, 3), False),
    "nddr_cnn": (lambda: _stitched(jmtl.NDDRCNN), (2, 64, 64, 3), False),
    "mtan": (lambda: jmtl.MTAN(
        backbone=ResNet(layers=(2, 2, 2, 2), dilate_scale=8),
        heads=_hr_heads(), tasks=TASKS, channels=(64, 128, 256, 512),
        downsample=(True, False, False, False)), (2, 64, 64, 3), False),
    "padnet": (lambda: jmtl.PADNet(backbone=ResNet(**RN_SMALL), tasks=TASKS,
                                   auxilary_tasks=AUX, num_outputs=NUM_OUT),
               (2, 64, 64, 3), False),
    "mti_net": (lambda: jmtl.MTINet(
        backbone=StandIn(), heads=_hr_heads(), tasks=TASKS,
        auxilary_tasks=TASKS, num_outputs=NUM_OUT, channels=MTI_CH),
        (2, 64, 64, 3), False),
}


def draw(shapes, seed: int):
    """numpy values for a flax variable tree of `shapes`: lecun-scaled
    kernels, BatchNorm scales near 1, statistics with variances in
    [0.5, 1.5], small biases, Cross-Stitch weights near 0.5."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if path[0].key == "batch_stats":
            return (rng.random(s.shape) + 0.5 if name == "var"
                    else 0.1 * rng.standard_normal(s.shape)
                    ).astype(np.float32)
        z = rng.standard_normal(s.shape)
        if name == "kernel":
            z = z / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            z = 1.0 + 0.1 * z
        elif name.startswith("stitch_"):
            z = 0.5 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def swapped(owner, name: str, fn):
    orig = getattr(owner, name)
    setattr(owner, name, fn)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def preds(out):
    """A model's outputs without the MTL methods' (cv, stats)."""
    if isinstance(out, tuple) and len(out) == 3 and isinstance(out[0], dict):
        return out[0]
    return out


def sin_loss(tree):
    return sum(jnp.sum(jnp.sin(v)) for v in jax.tree_util.tree_leaves(tree))


def run_case(name: str, seed: int = 0):
    build, shape, with_eval = CASES[name]
    model = build()
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal(shape).astype(np.float32)
    variables = draw(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x)), seed)
    dropout = []

    def drop(next_fun, args, kwargs, context):
        if not (isinstance(context.module, nn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        keep = 1.0 - context.module.rate
        mask = rng.random(args[0].shape) < keep
        dropout.append(mask)
        return jnp.where(mask, args[0] / keep, 0.0)

    def program(params, stats, x):
        ev = preds(model.apply({"params": params, "batch_stats": stats},
                               x)) if with_eval else None

        def loss(p):
            kept = []

            def relu(v):
                kept.append(v > 0)
                return jnp.where(kept[-1], v, 0.0)

            with nn.intercept_methods(drop), swapped(jax.nn, "relu", relu):
                out, new = model.apply({"params": p, "batch_stats": stats},
                                       x, train=True, mutable=["batch_stats"])
            out = preds(out)
            return sin_loss(out), (out, new["batch_stats"], kept)

        (_, (out, new, kept)), grads = jax.value_and_grad(
            loss, has_aux=True)(params)
        return ev, out, new, grads, kept

    args = (variables["params"], variables["batch_stats"], x)
    res = jax.jit(program).lower(*args).compile(FAST_COMPILE)(*args)
    ev, out, new, grads, kept = jax.tree_util.tree_map(np.asarray, res)
    return {"variables": variables, "x": x, "eval": ev, "train": out,
            "batch_stats": new, "grads": grads, "relu": kept,
            "dropout": dropout}


def main(argv):
    out_dir, names = argv[0], argv[1:]
    for name in names:
        res = run_case(name)
        tmp = os.path.join(out_dir, f".{name}.pkl")
        with open(tmp, "wb") as f:
            pickle.dump(res, f)
        os.replace(tmp, os.path.join(out_dir, f"{name}.pkl"))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1:])
