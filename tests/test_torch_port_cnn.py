"""The port's CNN models against the JAX package's, on the CPU in f32
(m3vit_tpu_torch/models/resnet.py, hrnet.py, mobilenetv3.py,
cnn_heads.py, mtl_methods.py; losses/schemes.py's deep-supervision
schemes; the factory and CLI routes of the 39 CNN configs).

The JAX side of the model comparisons runs in six worker processes
(tests/torch_port_cnn_jax.py), started by the first test of this file, so
that its programs trace and compile side by side while the JAX-free tests
run here.  Each model is one JAX program (XLA's lowest CPU level): the
eval forward, and a train forward with the gradient of sum(sin(outputs))
with respect to every parameter, on weights drawn with numpy into the
shapes of its flax variables.  They reach the port through
``utils/convert.py:cnn_variables_to_state_dict`` (a strict load, so the
converter is held too).  The port's own seeded init is held against
flax's initialisers by ``test_seeded_init_follows_flax``.

The port's train forward replays JAX's masks: ASPP's dropout masks, and
the ReLU masks of every ``jax.nn.relu`` through
``torch.nn.functional.relu`` in the same order (a call out of order
fails on its shape or its values).  A train-mode BatchNorm output within
f32 rounding of 0 takes opposite signs in the two packages (ROADMAP.md
queue 3), and BatchNorms over a few dozen values a channel amplify the
packages' rounding, so without the replay one flip moves a bias
gradient far past the tolerance below.

Tolerances: outputs and updated running statistics 5e-5 of their scale
(max(1, largest magnitude)); parameter gradients 5e-4 of each tensor's
largest magnitude, or of 1% of the model's largest gradient where that
is larger (a BatchNorm bias followed by another train-mode BatchNorm has
a gradient of 0 up to rounding).  Both sit above the rounding of JAX's
f32 BatchNorm statistics (E[x^2] - E[x]^2), which puts JAX's f32 values
farther from an f64 run than the port's on the deeper cases
(resnet-bottleneck-16, mobilenetv3-large).
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import linen as nn

from m3vit_tpu.losses import schemes as jsch
from m3vit_tpu.losses.functions import loss_fn_for_task as jax_loss_fn
from m3vit_tpu.models import mtl_methods as jmtl
from m3vit_tpu_torch.cli import train as cli
from m3vit_tpu_torch.losses import schemes as tsch
from m3vit_tpu_torch.losses.functions import loss_fn_for_task
from m3vit_tpu_torch.models import cnn_heads, factory, mtl_methods, resnet
from m3vit_tpu_torch.models.heads import batch_norm, resize_bilinear
from m3vit_tpu_torch.models.hrnet import HighResolutionNet
from m3vit_tpu_torch.models.mobilenetv3 import MobileNetV3
from m3vit_tpu_torch.ops import dropout as dropout_ops
from m3vit_tpu_torch.utils.convert import cnn_variables_to_state_dict
from tests import torch_port_cnn_jax as J
from tests.jax_fast_compile import fast_jit

ROOT = Path(__file__).resolve().parent.parent
CNN_BACKBONES = ("resnet18", "resnet50", "hrnet_w18", "mobilenetv3")
CNN_CONFIGS = sorted(
    str(f.relative_to(ROOT / "configs"))
    for f in (ROOT / "configs").rglob("*.yml")
    if (yaml.safe_load(f.read_text()) or {}).get("backbone") in CNN_BACKBONES)
OUT_TOL, GRAD_TOL = 5e-5, 5e-4
#: the JAX cases of each worker process, balanced by their trace and
#: compile time
WORKERS = (("mti_net", "cross_stitch"),
           ("mobilenetv3-large", "deeplab", "hrnet-head"),
           ("mtan", "resnet-basic-8"),
           ("hrnet", "resnet-bottleneck-16"),
           ("mobilenetv3-small", "resnet-basic-0"),
           ("padnet", "nddr_cnn"))


# ---------------------------------------------------------------------------
# the JAX workers and the port's run
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def jax_cases(request, tmp_path_factory):
    """case -> the JAX worker's result (a dict, see
    tests/torch_port_cnn_jax.py), waited for and read once.  The workers
    start with the first test of the file, when a collected test uses
    this fixture's results; the file's torch runs on one thread."""
    wanted = any("jax_case" in getattr(item, "fixturenames", ())
                 for item in request.session.items
                 if item.module is request.module)
    out = tmp_path_factory.mktemp("cnn_jax")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = {}
    if wanted:
        for i, names in enumerate(WORKERS):
            # stderr to a file: a pipe nobody reads could fill and stall it
            with open(out / f"worker{i}.err", "w") as err:
                p = subprocess.Popen(
                    [sys.executable, "-m", "tests.torch_port_cnn_jax",
                     str(out), *names], cwd=ROOT, env=env,
                    stdout=subprocess.DEVNULL, stderr=err)
            p.err = out / f"worker{i}.err"
            procs.update({n: p for n in names})
    # torch on one thread beside the workers: its intra-op pool would spin
    # against them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def get(name):
        path, p = out / f"{name}.pkl", procs[name]
        deadline = time.time() + 600
        while not path.exists():
            if p.poll() is not None and not path.exists():
                raise RuntimeError(f"JAX worker for {name} failed:\n"
                                   + p.err.read_text()[-4000:])
            assert time.time() < deadline, f"JAX worker {name} timed out"
            time.sleep(0.05)
        with open(path, "rb") as f:
            res = pickle.load(f)
        path.unlink()   # ~0.5 GB in all: keep none of it on the disk
        return res

    yield get
    torch.set_num_threads(threads)
    for p in set(procs.values()):
        if p.poll() is None:
            p.kill()
        p.wait()
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture
def jax_case(jax_cases):
    return jax_cases


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _port_tree(out):
    """Port outputs as numpy NHWC, in JAX's tree layout."""
    out = J.preds(out)
    if isinstance(out, dict):
        return {k: _port_tree(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return [_port_tree(v) for v in out]
    return out.detach().numpy().transpose(0, 2, 3, 1)


def _assert_trees(port, ref, what: str, tol: float = OUT_TOL):
    pl = jax.tree_util.tree_flatten_with_path(port)[0]
    rl = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in pl] == [p for p, _ in rl], what
    for (path, a), (_, b) in zip(pl, rl):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(
            a, b, rtol=0, atol=tol * scale,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _replay(monkeypatch, res):
    """The port's ReLU and dropout calls apply JAX's masks, in order;
    returns the lists the calls pop from."""
    relu = [torch.from_numpy(np.ascontiguousarray(
        m.transpose(0, 3, 1, 2) if m.ndim == 4 else m)) for m in res["relu"]]
    drop = [_nchw(m) for m in res["dropout"]]

    def replay_relu(v):
        keep = relu.pop(0)
        assert keep.shape == v.shape, "ReLU calls out of order"
        return torch.where(keep, v, torch.zeros((), dtype=v.dtype))

    monkeypatch.setattr(torch.nn.functional, "relu", replay_relu)
    monkeypatch.setattr(dropout_ops, "_mask",
                        lambda shape, keep, rng, device: drop.pop(0))
    return relu, drop


def _check(port: torch.nn.Module, res, monkeypatch,
           call=lambda m, x: m(x)):
    """Holds the port on the JAX worker's weights against its result: the
    eval outputs (when the case ran them), the train outputs, the running
    statistics after the train forward, every parameter's gradient."""
    port.load_state_dict(cnn_variables_to_state_dict(res["variables"]),
                         strict=True)
    xt = _nchw(res["x"])
    if res["eval"] is not None:
        port.eval()
        with torch.no_grad():
            _assert_trees(_port_tree(call(port, xt)), res["eval"],
                          "eval output")
    port.train()
    with monkeypatch.context() as mp:
        relu, drop = _replay(mp, res)
        pout = call(port, xt)
    assert not relu and not drop, "the port ran fewer ReLUs or dropouts"
    _assert_trees(_port_tree(pout), res["train"], "train output")
    sum(torch.sin(v).sum() for v in jax.tree_util.tree_leaves(
        J.preds(pout))).backward()
    ref_sd = cnn_variables_to_state_dict({
        "params": res["variables"]["params"],
        "batch_stats": res["batch_stats"]})
    sd = port.state_dict()
    for k, v in ref_sd.items():
        if "running" in k:
            np.testing.assert_allclose(
                sd[k].numpy(), v.numpy(), rtol=0,
                atol=OUT_TOL * max(1.0, float(v.abs().max())), err_msg=k)
    ref_g = cnn_variables_to_state_dict({"params": res["grads"]})
    named = dict(port.named_parameters())
    assert set(named) <= set(ref_g)
    floor = 0.01 * max(float(ref_g[k].abs().max()) for k in named)
    for k, p in named.items():
        g = ref_g[k]
        assert p.grad is not None, k
        np.testing.assert_allclose(
            p.grad.numpy(), g.numpy(), rtol=0,
            atol=GRAD_TOL * max(float(g.abs().max()), floor), err_msg=k)


# ---------------------------------------------------------------------------
# configs, init, hazards (no JAX worker: these run while the workers do)
# ---------------------------------------------------------------------------
def _cheap_init(weight, gen):
    """1 / fan_in in every kernel: the configs' 1.3 G parameters drawn by
    lecun_normal_ would take most of this file's time."""
    weight.detach().fill_(1.0 / weight[0].numel())


@pytest.mark.parametrize("config", CNN_CONFIGS)
def test_cnn_config_builds_and_runs(config, monkeypatch):
    """Every CNN config builds through build_model(p, device="cpu") as its
    YAML says (full widths; kernels by ``_cheap_init``), and a 64x64 eval
    forward gives every task [1, C_t, 64, 64], finite."""
    monkeypatch.setattr(resnet, "lecun_normal_", _cheap_init)
    p = yaml.safe_load((ROOT / "configs" / config).read_text())
    model, tasks = factory.build_model(p, device="cpu")
    assert factory.is_cnn_model(model)
    with torch.no_grad():
        out = model(torch.randn(1, 3, 64, 64))[0]
    assert set(out) == {t.name for t in tasks}
    for t in tasks:
        assert out[t.name].shape == (1, t.num_output, 64, 64), t.name
        assert torch.isfinite(out[t.name]).all(), t.name


def test_cnn_configs_are_the_39():
    assert len(CNN_CONFIGS) == 39
    small = yaml.safe_load((ROOT / "configs" / "pascal" / "resnet18" /
                            "mobilenetv3_multi_task_baseline.yml").read_text())
    bb = factory.build_backbone(small, 5)
    assert isinstance(bb, MobileNetV3) and bb.out_channels == 576, \
        "backbone_kwargs.mode: small picks the small variant"


def test_seeded_init_follows_flax():
    """The port's seeded init against flax's initialisers: conv and dense
    kernels lecun_normal (std sqrt(1 / fan_in), truncated at 2 std of the
    underlying normal), zero biases, BatchNorm scale 1 and bias 0,
    Cross-Stitch at 0.9 / 0.1 and NDDR's conv at its alpha / beta blocks,
    as the JAX modules' init gives them."""
    tasks = ["semseg", "depth"]
    feats = {t: jnp.ones((1, 2, 2, 4)) for t in tasks}
    key = jax.random.PRNGKey(0)
    ref, nddr, stitch = jax.tree_util.tree_map(np.asarray, fast_jit(
        lambda k: (nn.initializers.lecun_normal()(k, (3, 3, 256, 128)),
                   jmtl.NDDRLayer(tuple(tasks), 4).init(k, feats),
                   jmtl.CrossStitchUnit(tuple(tasks), 4).init(k, feats)))(
        key))
    conv = resnet.conv(256, 128, 3, bias=True)
    conv.init_weights(torch.Generator().manual_seed(0))
    w = conv.weight.detach().numpy()
    bound = 2 * np.sqrt(1 / (9 * 256)) / 0.87962566103423978
    assert abs(w.std() / ref.std() - 1) < 0.01
    assert np.abs(w).max() <= bound and np.abs(ref).max() <= bound * 1.0001
    assert np.abs(w).max() > 0.99 * bound
    assert not conv.bias.detach().any()
    model = resnet.ResNet("basic", (1, 1, 1, 1))
    factory.init_weights(model, torch.Generator().manual_seed(0))
    assert model.bn1.weight.eq(1).all() and not model.bn1.bias.any()
    assert abs(model.layer4[0].conv2.weight.std().item()
               / np.sqrt(1 / (9 * 512)) - 1) < 0.02
    layer = mtl_methods.NDDRLayer(tasks, 4)
    layer.init_weights(torch.Generator())
    unit = mtl_methods.CrossStitchUnit(tasks, 4)
    for mod, jv in ((layer, nddr), (unit, stitch)):
        sd = cnn_variables_to_state_dict(jv)
        for k, v in mod.state_dict().items():
            if "running" not in k and "num_batches" not in k:
                np.testing.assert_array_equal(v.numpy(), sd[k].numpy(),
                                              err_msg=k)


def test_resize_upsamples_only():
    """Every resize of the CNN path upsamples, where F.interpolate equals
    jax.image.resize; asked to shrink, the port raises instead of
    differing silently (jax.image.resize antialiases a downsampling)."""
    x = np.random.default_rng(5).standard_normal((1, 5, 7, 2)).astype(
        np.float32)
    got = resize_bilinear(_nchw(x), (10, 21)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(
        got, np.asarray(jax.image.resize(x, (1, 10, 21, 2), "bilinear")),
        atol=1e-6)
    with pytest.raises(ValueError, match="upsamples only"):
        resize_bilinear(_nchw(x), (4, 7))


def test_batch_norm_of_one_value_a_channel_matches_flax():
    """ASPP's pooled branch at trBatch 1 normalises one value a channel in
    training: F.batch_norm refuses it, flax gives the bias; the port's
    batch_norm follows flax, running statistics included."""
    x = np.random.default_rng(6).standard_normal((1, 1, 1, 8)).astype(
        np.float32)
    bn_j = nn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    v = bn_j.init(jax.random.PRNGKey(0), x)
    v = {"params": {"scale": np.full(8, 1.5, np.float32),
                    "bias": np.arange(8, dtype=np.float32)},
         "batch_stats": v["batch_stats"]}
    y, new = bn_j.apply(v, x, mutable=["batch_stats"])
    bn = resnet.bn(8)
    bn.load_state_dict(cnn_variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, v)))
    got = batch_norm(bn, _nchw(x), True)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y), atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]),
                               atol=1e-7)


def test_cnn_models_refuse_torch_distributed(monkeypatch):
    """Under a torch.distributed layout a CNN model raises, naming the
    ROADMAP item that ports it, rather than train unsynchronised."""
    monkeypatch.setattr(resnet.parallel, "active", lambda: object())
    for model in (resnet.ResNet("basic", (1, 1, 1, 1)),
                  HighResolutionNet(**J.HR_SMALL), MobileNetV3("small")):
        with pytest.raises(NotImplementedError, match="queue 1 item 8b"):
            model(torch.zeros(1, 3, 32, 32))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
LOSS_P = {"train_db_name": "NYUD", "edge_w": 0.95}


def _labels(rng, b=2, hw=32):
    return {
        "semseg": np.where(rng.random((b, hw, hw, 1)) < 0.1, 255,
                           rng.integers(0, 5, (b, hw, hw, 1))).astype(
            np.float32),
        "depth": np.where(rng.random((b, hw, hw, 1)) < 0.1, 0.0,
                          rng.random((b, hw, hw, 1)) * 5).astype(np.float32),
        "normals": rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("scheme", ["pad_net", "mti_net"])
def test_deep_supervision_losses_match_jax(scheme):
    """padnet_loss and mtinet_loss: every term and the total, and the
    total's gradient with respect to every prediction (the coarse ones
    upsampled to the labels)."""
    rng = np.random.default_rng(7)
    gt = _labels(rng)
    weights = {"semseg": 1.0, "depth": 2.0, "normals": 10.0}

    def pred(hw):
        return {t: rng.standard_normal((2, hw, hw, J.NUM_OUT[t])).astype(
            np.float32) for t in J.AUX}

    if scheme == "pad_net":
        jfun, tfun = jsch.padnet_loss, tsch.padnet_loss
        preds = {**{t: v for t, v in pred(32).items() if t in J.TASKS},
                 **{f"initial_{t}": v for t, v in pred(8).items()}}
    else:
        jfun, tfun = jsch.mtinet_loss, tsch.mtinet_loss
        preds = {t: v for t, v in pred(32).items() if t in J.TASKS}
        preds["deep_supervision"] = {f"scale_{i}": pred(16 >> i)
                                     for i in range(4)}
    jfns = {t: jax_loss_fn(t, LOSS_P) for t in J.AUX}
    tfns = {t: loss_fn_for_task(t, LOSS_P) for t in J.AUX}

    def jtotal(p):
        out = jfun(p, gt, J.TASKS, J.AUX, jfns, weights)
        return out["total"], out

    (_, jout), jgrad = fast_jit(jax.value_and_grad(jtotal, has_aux=True))(
        preds)
    tpred = jax.tree_util.tree_map(lambda a: _nchw(a).requires_grad_(), preds)
    tgt = {k: _nchw(v) for k, v in gt.items()}
    tout = tfun(tpred, tgt, J.TASKS, J.AUX, tfns, weights)
    assert set(tout) == set(jout)
    for k, v in jout.items():
        np.testing.assert_allclose(tout[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)
    tout["total"].backward()
    _assert_trees(jax.tree_util.tree_map(
        lambda t: t.grad.numpy().transpose(0, 2, 3, 1), tpred),
        jax.tree_util.tree_map(np.asarray, jgrad), "loss gradient", 1e-6)


@pytest.mark.parametrize("config,scheme", [
    ("nyud/hrnet18/mti_net+edges_normals.yml", "mtinet_loss"),
    ("pascal/hrnet18/pad_net.yml", "padnet_loss"),
    ("pascal/resnet18/mtan.yml", "multi_task_loss"),
])
def test_cli_picks_the_loss_scheme(config, scheme, monkeypatch, tmp_path):
    """The CLI's train step scores what loss_kwargs.loss_scheme names, over
    the config's auxiliary tasks, with TF32 off for an f32 config while it
    runs (and the flags restored after)."""
    seen = {}

    def capture(*args, **kw):
        seen.update(kw, tf32=(torch.backends.cudnn.allow_tf32,
                              torch.backends.cuda.matmul.allow_tf32))
        step = lambda *a, **k: {}  # noqa: E731
        step.step = 0
        return step

    monkeypatch.setattr(cli, "make_train_step", capture)
    # no step runs: the optimizer (and the first one's one-time imports)
    # is not needed
    monkeypatch.setattr(cli, "build_optimizer",
                        lambda params, p, steps: (None, lambda i: 0.0))
    monkeypatch.setattr(resnet, "lecun_normal_", _cheap_init)
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    env = tmp_path / "env.yml"
    env.write_text(yaml.safe_dump({"root_dir": str(tmp_path / "out")}))
    cli.main(["--config_env", str(env), "--config_exp",
              str(ROOT / "configs" / config), "--device", "cpu",
              "--synthetic", "1", "--epochs", "0", "--trBatch", "1"])
    fn = seen["loss_scheme"]
    assert fn.func.__name__ == scheme
    if scheme != "multi_task_loss":
        p = yaml.safe_load((ROOT / "configs" / config).read_text())
        assert fn.keywords["auxilary_tasks"] == tsch.auxilary_task_names(p)
        assert set(fn.keywords["loss_fns"]) >= set(
            fn.keywords["auxilary_tasks"])
    assert seen["tf32"] == (False, False)
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


# ---------------------------------------------------------------------------
# module families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block,dilate", [("basic", 0), ("basic", 8),
                                          ("bottleneck", 16)])
def test_resnet_matches_jax(block, dilate, jax_case, monkeypatch):
    """ResNet at layers (1, 1, 1, 1): the stem's max-pool, BasicBlock's
    asymmetric dilations on a dilated stage's first block, Bottleneck,
    the strides of dilate_scale 0 / 8 / 16."""
    _check(resnet.ResNet(block, (1, 1, 1, 1), dilate),
           jax_case(f"resnet-{block}-{dilate}"), monkeypatch)


def test_hrnet_matches_jax(jax_case, monkeypatch):
    """A shrunk HRNet: stem, stage 1, the transitions and one module a
    stage with its full fusion (upsampling and strided-conv chains); the
    four streams."""
    _check(HighResolutionNet(**J.HR_SMALL), jax_case("hrnet"), monkeypatch)


@pytest.mark.parametrize("variant", ["small", "large"])
def test_mobilenetv3_matches_jax(variant, jax_case, monkeypatch):
    _check(MobileNetV3(variant), jax_case(f"mobilenetv3-{variant}"),
           monkeypatch)


def test_deeplab_head_matches_jax(jax_case, monkeypatch):
    """ASPP (rates 12/24/36 wider than the map, the pooled branch's mean
    and broadcast, dropout 0.5 in training with JAX's mask replayed) and
    the DeepLab head."""
    _check(cnn_heads.DeepLabHead(32, 5), jax_case("deeplab"), monkeypatch,
           call=lambda m, x: m(x, torch.Generator()))


class _HeadAndFuse(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.head = cnn_heads.HighResolutionHead(32, 3)
        self.fuse = cnn_heads.HighResolutionFuse(32)

    def forward(self, x):
        xs = [x] + [torch.nn.functional.avg_pool2d(x, s) for s in (2, 4, 8)]
        return [self.head(xs), self.fuse(xs)]


def test_hrnet_head_and_fuse_match_jax(jax_case, monkeypatch):
    """The HRNet head over four streams (each upsampled to the first's
    size and concatenated), and the fuse module on the same streams."""
    _check(_HeadAndFuse(), jax_case("hrnet-head"), monkeypatch)


# ---------------------------------------------------------------------------
# the MTL methods
# ---------------------------------------------------------------------------
def _theads(cin: int):
    return {t: cnn_heads.HighResolutionHead(cin, J.NUM_OUT[t])
            for t in J.TASKS}


def _mtl_call(m, x):
    return m(x, noise=torch.Generator())


@pytest.mark.parametrize("name", ["cross_stitch", "nddr_cnn"])
def test_stitched_resnets_match_jax(name, jax_case, monkeypatch):
    """Cross-Stitch and NDDR-CNN on a ResNet a task (layers (1, 1, 1, 1),
    dilated), a unit after every stage (NDDR's BatchNorm at flax momentum
    0.95)."""
    cls = {"cross_stitch": mtl_methods.CrossStitchNetwork,
           "nddr_cnn": mtl_methods.NDDRCNN}[name]
    bbs = {t: resnet.ResNet("basic", (1, 1, 1, 1), 8) for t in J.TASKS}
    ch = bbs[J.TASKS[0]].stage_channels
    _check(cls(bbs, _theads(ch[-1]), J.TASKS, ch), jax_case(name),
           monkeypatch, call=_mtl_call)


def test_mtan_matches_jax(jax_case, monkeypatch):
    """MTAN on a dilated ResNet-18 (the attention needs two blocks a
    stage: it reads the stage's all-but-last output), its shared
    refinement blocks and the 2x2 max-pool after stage 0 alone."""
    bb = resnet.resnet18(dilated=True)
    ch = bb.stage_channels
    _check(mtl_methods.MTAN(bb, _theads(ch[-1]), J.TASKS, ch,
                            (True, False, False, False)),
           jax_case("mtan"), monkeypatch, call=_mtl_call)


def test_padnet_matches_jax(jax_case, monkeypatch):
    """PAD-Net: initial predictions of three auxiliary tasks (returned in
    training), their distillation into two tasks' features, the heads."""
    bb = resnet.ResNet("basic", (1, 1, 1, 1), 8)
    _check(mtl_methods.PADNet(bb, 512, J.TASKS, J.AUX, J.NUM_OUT),
           jax_case("padnet"), monkeypatch, call=_mtl_call)


class _StandIn(torch.nn.Module):
    """The port twin of torch_port_cnn_jax.StandIn."""

    def __init__(self):
        super().__init__()
        ch = J.MTI_CH
        self.conv0 = torch.nn.Conv2d(3, ch[0], 4, 4)
        for i in (1, 2, 3):
            setattr(self, f"conv{i}",
                    torch.nn.Conv2d(ch[i - 1], ch[i], 3, 2, 1))

    def forward(self, x):
        h = torch.nn.functional.relu(self.conv0(x))
        xs = [h]
        for i in (1, 2, 3):
            h = torch.nn.functional.relu(getattr(self, f"conv{i}")(h))
            xs.append(h)
        return xs


def test_mti_net_matches_jax(jax_case, monkeypatch):
    """MTI-Net on four stand-in streams: the initial predictions from the
    coarsest scale up (the previous scale upsampled x2), the FPM's
    softmax over groups of N consecutive channels (N = 2 tasks, also the
    auxiliary ones), the distillations, the HRNet heads, and the
    deep-supervision outputs in training."""
    heads = {t: cnn_heads.HighResolutionHead(sum(J.MTI_CH), J.NUM_OUT[t])
             for t in J.TASKS}
    _check(mtl_methods.MTINet(_StandIn(), heads, J.TASKS, J.TASKS, J.NUM_OUT,
                              J.MTI_CH),
           jax_case("mti_net"), monkeypatch, call=_mtl_call)
