"""The port's research knobs, stacked tasks, pruning and the decoupled gate
ViT against the JAX package's, on the CPU in f32.

Sizes: 128 x 128 images, patch 16 (an 8 x 8 grid, so a 5 x 5 subimage
fits), d 32, depth 2, E 16, K 4, three PASCAL tasks (semseg, sal, normals),
two images; the sem train step at 80 x 80.  The JAX side runs in three
worker processes (tests/torch_port_knobs_jax.py), started by the file's
first test and run beside its JAX-free tests: each traces and compiles
one program (XLA's lowest CPU level) over its knob backbones (the weights
drawn with numpy into the shapes of their flax variables), the gates, or
the sem train step (the port's seeded weights carried in by the JAX
package's reference converter).  Every JAX tree reaches the port through
``utils/convert.py`` with a strict load.  The gate noise is 0
(vmoe_noisy_std 0) but in the gate tests, which hand JAX's own normal
draws to the port.

Tolerances: outputs, cv losses, regularisers and statistics 2e-5; top-k
ids, patch labels and forced routing equal; the sem step's losses 1e-5
relative, its updates (-lr x the gradient) by parameter group 1e-4
relative.
"""

from __future__ import annotations

import importlib.util
import json
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

from m3vit_tpu.moe import pruning as jpr
from m3vit_tpu_torch.cli import train as cli
from m3vit_tpu_torch.losses.functions import loss_fn_for_task
from m3vit_tpu_torch.models import gate_vit as tgv
from m3vit_tpu_torch.models import vit_moe as tvm
from m3vit_tpu_torch.models.factory import init_weights
from m3vit_tpu_torch.models.heads import VisionTransformerUpHead
from m3vit_tpu_torch.models.multitask import MultiTaskModel
from m3vit_tpu_torch.moe import gating as tg
from m3vit_tpu_torch.moe import pruning as tpr
from m3vit_tpu_torch.train.optim import build_optimizer
from m3vit_tpu_torch.train.step import make_train_step
from m3vit_tpu_torch.utils.convert import jax_variables_to_state_dict
from tests import torch_port_knobs_jax as J

ROOT = Path(__file__).resolve().parent.parent
B, E, K, T, IMG = J.B, J.E, J.K, J.T, J.IMG
TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


def step_port_model():
    """The port's twin of the worker's sem step model."""
    arch = {**J.ARCH, **J.STEP_KNOBS, "img_size": (J.STEP_IMG, J.STEP_IMG)}
    decoders = {n: VisionTransformerUpHead(
        img_size=(J.STEP_IMG, J.STEP_IMG), patch_size=16, embed_dim=32,
        num_classes=J.NUM_OUT[n]) for n in J.STEP_NAMES}
    return MultiTaskModel(tvm.VisionTransformerMoE(**arch), decoders,
                          J.STEP_NAMES, multi_gate=True, shared_prefix=True)


@pytest.fixture(scope="module", autouse=True)
def jax_groups(request, tmp_path_factory):
    """group -> the JAX worker's result (tests/torch_port_knobs_jax.py),
    waited for and read once.  The workers start with the first test of
    the file, when a collected test of it uses this fixture's results;
    the file's torch runs on one thread beside them."""
    wanted = any({"jax_group", "sem_step"} & set(
        getattr(item, "fixturenames", ())) for item in request.session.items
        if item.module is request.module)
    out = tmp_path_factory.mktemp("knobs_jax")
    model = step_port_model()
    init_weights(model, torch.Generator().manual_seed(0))
    with open(out / "step_weights.pkl", "wb") as f:
        pickle.dump({k: v.numpy() for k, v in model.state_dict().items()
                     if not k.endswith("num_batches_tracked")}, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = {}
    if wanted:
        for g in J.GROUPS:
            with open(out / f"{g}.err", "w") as err:
                p = subprocess.Popen(
                    [sys.executable, "-m", "tests.torch_port_knobs_jax",
                     str(out), g], cwd=ROOT, env=env,
                    stdout=subprocess.DEVNULL, stderr=err)
            p.err = out / f"{g}.err"
            procs[g] = p
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cache = {}

    def get(group):
        if group not in cache:
            path, p = out / f"{group}.pkl", procs[group]
            deadline = time.time() + 600
            while not path.exists():
                if p.poll() is not None and not path.exists():
                    raise RuntimeError(f"JAX worker {group} failed:\n"
                                       + p.err.read_text()[-4000:])
                assert time.time() < deadline, f"JAX worker {group} timed out"
                time.sleep(0.05)
            with open(path, "rb") as f:
                cache[group] = pickle.load(f)
        return cache[group]

    yield get
    torch.set_num_threads(threads)
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait()
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture
def jax_group(jax_groups):
    return jax_groups


def group_of(name):
    return next(g for g, names in J.GROUPS.items() if name in names)


def tbackbone(name, variables):
    """The port's backbone `name` on the JAX weights, in eval mode."""
    kw = {**J.ARCH, **J.BACKBONES[name]}
    if name == "gated":
        m = tgv.MoEViTWithGate(
            tvm.VisionTransformerMoE(gate_dim=J.GATE_DIM, **kw),
            tgv.GateViT((IMG, IMG), embed_dim=J.GATE_DIM, depth=1,
                        num_heads=2))
    else:
        m = tvm.VisionTransformerMoE(**kw)
    sd = jax_variables_to_state_dict(variables, [],
                                     T if kw["multi_gate"] else 0)
    if name != "gated":
        sd = {k[len("backbone."):]: v for k, v in sd.items()}
    m.load_state_dict(sd, strict=True)
    return m.eval()


def run_port(m, inputs, kw):
    """(tokens, cv, stats with the analysis statistics, each gate's top-k
    ids in call order) of backbone m on one call of J.CALLS."""
    kw = dict(kw)
    if kw.pop("train", False):
        m.train()
    if kw.pop("sem", False):
        kw["sem"] = _t(inputs["sem"])[:, None]
    if kw.pop("expert_mask", False):
        kw["expert_mask"] = _t(J.MASK)
    tid = kw.pop("task_id")
    with tpr.recorded_gates(m) as seen, tvm.collect_gate_stats(m), \
            torch.no_grad():
        tokens, cv, stats = m(_nchw(inputs["x"]), tid, torch.Generator(),
                              **kw)
    return tokens, cv, stats, [g.top_k_indices for g in seen]


def _close(got, ref, what, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


def _nodrop(m):
    for blk in m.blocks[1::2]:
        blk.mlp.capacity_factor = blk.mlp.eval_capacity_factor = \
            float("inf")
    return m


def _seeded(**knobs):
    m = tvm.VisionTransformerMoE(**{**J.ARCH, **knobs})
    init_weights(m, torch.Generator().manual_seed(1))
    m.init_weights(torch.Generator().manual_seed(2))
    return m


# ---------------------------------------------------------------------------
# JAX-free (these run while the workers do)
# ---------------------------------------------------------------------------
def test_window_starts_are_cumulative():
    """regu_experts_fromtask's windows: cumulative starts clamped to
    E - n, the columns before the true start masked (task 4 of 5: the
    whole window)."""
    assert tvm.expert_windows(16, 3, 8) == [(0, 0), (4, 4), (12, 8)]
    assert tvm.expert_windows(16, 5, 8) == [(0, 0), (2, 2), (6, 6),
                                            (12, 8), (20, 8)]
    with pytest.raises(ValueError):
        tvm.expert_windows(16, 1, 8)


def test_knobs_refuse_torch_distributed(monkeypatch):
    """Under a torch.distributed layout a knob raises, naming item 7b."""
    bb = tvm.VisionTransformerMoE(**{**J.ARCH, "expert_prune": True})
    monkeypatch.setattr(tvm.parallel, "active", lambda: object())
    with pytest.raises(NotImplementedError, match="queue 1 item 7b"):
        bb(torch.zeros(1, 3, IMG, IMG), 0)


def test_stacked_matches_the_task_loop():
    """The stacked pass against the task loop on the same weights, the
    noise off and no drops: each task's tokens, the cv loss (summed per
    task segment) and the load histogram."""
    m = _nodrop(_seeded()).train()
    x = torch.randn(B, 3, IMG, IMG, generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), tvm.collect_gate_stats(m):
        stacked, cv, st = m(x, list(range(T)), stacked_tasks=True)
        loop = [m(x, t) for t in range(T)]
    for t in range(T):
        _close(stacked[t * B:(t + 1) * B], loop[t][0].numpy(), f"task {t}")
    _close(cv, sum(float(r[1]) for r in loop), "cv")
    _close(st["expert_load_hist"],
           sum(r[2]["expert_load_hist"] for r in loop).numpy(), "hist")


def test_pruned_state_dict_matches_the_masked_model():
    """prune_experts_in_state_dict's model with 8 experts against the full
    model under the masks of those 8 a block (no-drop capacity in both):
    the same tokens.  The 8 are collect_expert_usage's over two batches,
    select_top_experts' as the JAX package selects them."""
    full = _nodrop(_seeded()).eval()
    x = torch.randn(B, 3, IMG, IMG, generator=torch.Generator().manual_seed(4))

    class Serve(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = full

        def forward(self, img, single_task=None):
            return self.backbone(img, 0)

    usage = tpr.collect_expert_usage(tpr.dense_gates(Serve(), "semseg"),
                                     [{"image": x}, {"image": x.flip(-1)}], 1)
    keep = tpr.select_top_experts(usage, 8)
    np.testing.assert_array_equal(keep[0],
                                  jpr.select_top_experts(usage, 8)[0])
    with torch.no_grad():
        ref = full(x, 0, expert_mask=tpr.usage_to_masks(keep, E))[0]
    pruned = _nodrop(tvm.VisionTransformerMoE(**{**J.ARCH,
                                                 "moe_experts": 8}))
    pruned.load_state_dict(tpr.prune_experts_in_state_dict(
        full.state_dict(), {1: keep[0]}), strict=True)
    with torch.no_grad():
        _close(pruned.eval()(x, 0)[0], ref.numpy(), "pruned vs masked")


def _fab():
    spec = importlib.util.spec_from_file_location(
        "fabricate_dataset", ROOT / "scripts" / "fabricate_dataset.py")
    fab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fab)
    return fab


def test_cli_sem_warmup_switches_the_step(tmp_path):
    """Two epochs of the CLI on --device cpu with every sem knob, the
    expert windows, prune and gate_input_ahead at --warmup_epochs 1: the
    regularisers are logged in epoch 0 only, and the checkpoint carries
    the regu_sem heads."""
    _fab().fabricate_pascal(str(tmp_path / "PASCAL_MT"), 4, (48, 64))
    env = tmp_path / "env.yml"
    env.write_text(yaml.safe_dump({
        "root_dir": str(tmp_path / "runs"),
        "dataset_roots": {"PASCAL_MT": str(tmp_path / "PASCAL_MT")}}))
    p = yaml.safe_load((ROOT / "configs" / "pascal" /
                        "vit_moe_small_multi_task.yml").read_text())
    p["backbone_kwargs"].update(img_size=[32, 32], embed_dim=32, depth=2,
                                num_heads=2, gate_dim=35)
    p["head_kwargs"].update(img_size=[32, 32], embed_dim=32)
    p["task_dictionary"] = {"include_semseg": True, "include_sal": True,
                            "include_normals": True}
    p.update(train_scale=[32, 32], test_scale=[32, 32], nworkers=0,
             trBatch=2, valBatch=2, epochs=2, eval_interval=2,
             compute_dtype="float32", use_checkpointing=False)
    exp = tmp_path / "exp.yml"
    exp.write_text(yaml.safe_dump(p))
    res = cli.main([
        "--config_env", str(env), "--config_exp", str(exp), "--device",
        "cpu", "--moe_eval_capacity_factor", "nodrop", "--log_interval",
        "1", "--sem_force", "--regu_sem", "--regu_subimage",
        "--regu_experts_fromtask", "--num_experts_pertask", "12",
        "--expert_prune", "--gate_input_ahead", "--warmup_epochs", "1"])
    assert res["steps_run"] == 4 and res["state"]["train_step"].step == 4
    ckpt = torch.load(next((tmp_path / "runs").rglob("1.pt")),
                      map_location="cpu", weights_only=False)
    assert "backbone.blocks.1.mlp.regu_sem_head.weight" in ckpt["model"]
    log = next((tmp_path / "runs").rglob("metrics.jsonl"))
    train = [ln for ln in map(json.loads, log.read_text().splitlines())
             if "train/total_loss" in ln]
    assert [ln["train/epoch"] for ln in train] == [0, 0, 1, 1]
    for ln in train:
        has = {"train/semregu_loss", "train/regu_subimage_loss"} <= set(ln)
        assert has == (ln["train/epoch"] == 0), ln


# ---------------------------------------------------------------------------
# against the JAX workers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["vmoe", "noisy", "segments"])
def test_gates_with_expert_mask_match_jax(which, jax_group):
    """Both gates with an expert mask and JAX's noise: ids equal, scores
    and logits to 2e-5; the per-segment importance, load and cv loss."""
    res = jax_group(group_of("gates"))
    g = res["gates"]
    inp, w, wn = (_t(a) for a in res["inputs"]["gate"])
    noise, mask = _t(g["noise"]), _t(J.MASK)
    vm = tg.noisy_vmoe_gate(inp, w, top_k=K, noise_std=1.0, noise=noise,
                            expert_mask=mask)
    if which == "segments":
        _close(tg.gate_importance(vm, 3), g["imp3"], "importance")
        _close(tg.gate_load_counts(vm, 3), g["load3"], "load")
        _close(tg.moe_aux_loss(vm, K, E, True, segments=3), g["aux3"], "aux")
        return
    got = vm if which == "vmoe" else tg.noisy_gate(
        inp, w, wn, top_k=K, noise=noise, expert_mask=mask)
    ref = g[which]
    np.testing.assert_array_equal(got.top_k_indices.numpy(),
                                  ref.top_k_indices)
    assert J.MASK[got.top_k_indices.numpy()].all()
    _close(got.top_k_gates, ref.top_k_gates, "gates")
    _close(got.noisy_logits, ref.noisy_logits, "logits")


@pytest.mark.parametrize("which", ["patch_labels", "force_routing",
                                   "subimage_loss"])
def test_sem_functions_match_jax(which, jax_group):
    """patch_majority_labels and build_sem_force_routing bit for bit,
    regu_subimage_loss on a 10 x 10 grid to 2e-5."""
    res = jax_group(group_of("gates"))
    g, inputs = res["gates"], res["inputs"]
    labels = tvm.patch_majority_labels(_t(inputs["sem"])[:, None], 16)
    if which == "patch_labels":
        np.testing.assert_array_equal(labels.numpy(), g["labels"])
        assert (labels == 255).any() and (labels == 0).any()
    elif which == "force_routing":
        idx, mask = tvm.build_sem_force_routing(labels.reshape(B, -1), K, 1)
        np.testing.assert_array_equal(idx.numpy(), g["force"][0])
        np.testing.assert_array_equal(mask.numpy(), g["force"][1])
    else:
        _close(tvm.regu_subimage_loss(_t(inputs["sub"]), 5), g["subimage"],
               "subimage")


CASES = [(n, label) for names in J.GROUPS.values() for n in names
         if n in J.CALLS for label, _ in J.CALLS[n]]


@pytest.mark.parametrize("name,label", CASES,
                         ids=[f"{n}-{lb}" for n, lb in CASES])
def test_backbone_knob_matches_jax(name, label, jax_group):
    """Each knob's backbone (tokens, cv loss, the statistics, the
    regularisers) to 2e-5 and each gate's top-k ids equal: a sem-forced
    batch that overflows the forced experts' capacity, expert windows at
    3 and 5 tasks of 8 experts each (task 4 of 5: a window masked whole),
    expert_prune, gate_input_ahead alone and with the shared prefix,
    distilled, stacked tasks, an expert mask, the decoupled gate ViT."""
    res = jax_group(group_of(name))
    ref = res["results"][(name, label)]
    m = tbackbone(name, res["variables"][name])
    tokens, cv, stats, ids = run_port(m, res["inputs"],
                                      dict(J.CALLS[name])[label])
    assert len(ids) == len(ref["ids"])
    for i, (a, b) in enumerate(zip(ids, ref["ids"])):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"ids {i}")
    _close(tokens, ref["tokens"], "tokens")
    _close(cv, ref["cv"], "cv")
    assert set(stats) == set(ref["stats"])
    for k, v in ref["stats"].items():
        _close(stats[k], v, k)
    if name == "force" and label.startswith("train"):
        assert float(stats["dropped_slot_fraction"]) > 0.1   # overflow
        assert float(stats["regu_subimage_loss"]) > 0
        assert float(stats["semregu_loss"]) > 0


def test_gate_vit_matches_jax(jax_group):
    """GateViT alone (the fixed sin-cos position embedding, its dense
    block, the final LayerNorm) on the gated model's weights."""
    res = jax_group(group_of("gated"))
    m = tbackbone("gated", res["variables"]["gated"])
    with torch.no_grad():
        got = m.gate_model(_nchw(res["inputs"]["x"]))
    _close(got, res["results"][("gated", "gate_features")], "features")
    pos = tgv.sincos_2d_pos_embed(8, 8, 32)
    assert pos.shape == (1, 64, 32) and np.abs(pos).max() <= 1.0


# ---------------------------------------------------------------------------
# the sem train step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sem_step(jax_groups):
    """The port's sem step (make_train_step(pass_sem=True), the optimizer
    of the worker's) from the JAX step's starting weights, beside the JAX
    step: (port metrics, JAX metrics, port updates, JAX updates)."""
    res = jax_groups("step")["step"]
    model = step_port_model()
    sd = jax_variables_to_state_dict(res["variables"], J.STEP_NAMES, T)
    model.load_state_dict(sd, strict=True)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt, schedule = build_optimizer(model.parameters(), J.OPT,
                                    steps_per_epoch=2)
    step = make_train_step(model, J.STEP_NAMES, {n: loss_fn_for_task(
        n, {"edge_w": 0.95}) for n in J.STEP_NAMES}, J.WEIGHTS, opt, schedule,
        pass_sem=True)
    metrics = {k: float(m) for k, m in step(
        {k: _nchw(a) for k, a in res["batch"].items()}).items()}
    new = jax_variables_to_state_dict({"params": res["new_params"]},
                                      J.STEP_NAMES, T)
    upd = {k: (p.detach() - before[k]).numpy()
           for k, p in model.named_parameters()}
    ref = {k: new[k].numpy() - sd[k].numpy() for k in upd}
    return metrics, res["metrics"], upd, ref


def test_sem_step_losses_match_jax(sem_step):
    """The sem step's losses (the tasks', cv, the two regularisers, the
    total with them) to 1e-5 relative."""
    metrics, jmetrics, _, _ = sem_step
    for k in ("loss_semregu", "loss_regu_subimage", "loss_cv",
              "loss_total", "loss_total_with_cv") + tuple(
            f"loss_{n}" for n in J.STEP_NAMES):
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-5,
                                   err_msg=k)
    assert metrics["loss_semregu"] > 0 and metrics["loss_regu_subimage"] > 0


def _group(name):
    for g, key in (("gates", ".gate."), ("regu_sem_head", "regu_sem_head"),
                   ("experts", ".experts."), ("attention", ".attn."),
                   ("heads", "decoders.")):
        if key in name:
            return g
    return "embed_norms_mlp"


def test_sem_step_gradients_match_jax(sem_step):
    """The step's updates (-lr x the gradient) by parameter group to 1e-4
    relative; the routers and the regu_sem heads carry the regularisers'
    gradients."""
    _, _, upd, ref = sem_step
    acc = {}
    for k, a in upd.items():
        d, r = acc.get(_group(k), (0.0, 0.0))
        acc[_group(k)] = (d + float(((a - ref[k]) ** 2).sum()),
                          r + float((ref[k] ** 2).sum()))
    errs = {g: (d / r) ** 0.5 for g, (d, r) in acc.items()}
    assert acc["regu_sem_head"][1] > 0 and acc["gates"][1] > 0
    assert all(e <= 1e-4 for e in errs.values()), errs
