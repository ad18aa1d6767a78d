"""The port at the wider model families against the JAX package (CPU,
f32): the paper's ViT-base M3ViT config at its real width, and the route
the FFN kernels take for every config the port builds.

The slice test builds configs/pascal/vit_moe/pup_moe_vit_base_multi_task_
baseline.yml through both factories at width 768 (12 heads, dense hidden
3072, 16 experts of hidden 1536, top-2, gate_dim 773, five PASCAL tasks,
TAM at level 0), shrunk to depth 2 (one dense and one MoE block) and a
64 x 64 image, gate noise 0, f32.  The port's seeded weights go to JAX
through the JAX package's reference converter.  One train step's losses,
the eval forward, and the backbone's gradients under a fixed random
cotangent on its output tokens (task 0's routing, train mode, plus 0.01
cv: the flagship's backbone-alone check) are held to the tolerances of
tests/test_torch_port_recipe.py and tests/test_torch_port_step_paths.py:
outputs and losses 1e-4, each gradient to 1e-4 of its largest magnitude
(f32 sums in another order).  The whole step's gradients are not compared:
with two or more task passes the heads' gradients of the two packages
differ by up to ~6e-3 of their magnitude at any width, dense or MoE, while
the port's own equal those of one task pass alone (ROADMAP queue 3).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from m3vit_tpu.config import create_config as jax_create_config
from m3vit_tpu.losses import schemes as jsch
from m3vit_tpu.models.factory import build_backbone as jax_build_backbone
from m3vit_tpu.models.factory import build_model as jax_build_model
from m3vit_tpu_torch.config import create_config
from m3vit_tpu_torch.data.synthetic import synthetic_batch
from m3vit_tpu_torch.losses import schemes as tsch
from m3vit_tpu_torch.models import build_model
from m3vit_tpu_torch.models.factory import TOKEN_BACKBONES
from m3vit_tpu_torch.ops.expert_ffn import (FUSED_DIMS, TWO_PASS_DIMS,
                                            ffn_route)
from m3vit_tpu_torch.ops.flash_attention import HEAD_DIMS
from m3vit_tpu_torch.utils.convert import jax_variables_to_state_dict
from tests.jax_fast_compile import FAST_COMPILE
from tests.test_torch_port_recipe import _files, _flax_params

ROOT = Path(__file__).resolve().parent.parent
VIT_BASE_MOE = ROOT / "configs" / "pascal" / "vit_moe" / \
    "pup_moe_vit_base_multi_task_baseline.yml"
IMG, B = 64, 2
t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tests, restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def vit_base_run(tmp_path_factory):
    """The ViT-base M3ViT config at width 768, depth 2, 64 x 64, f32, gate
    noise 0, through both factories on the same weights and batch: JAX's
    eval forward, one train step's losses (train-mode BN), and the
    backbone's gradients under a fixed cotangent, in one jitted program;
    the port's model carried back by jax_variables_to_state_dict."""
    p = yaml.safe_load(VIT_BASE_MOE.read_text())
    kw = p["backbone_kwargs"]
    assert (kw["embed_dim"], kw["num_heads"], kw["gate_dim"],
            p["moe_experts"], p["moe_top_k"]) == (768, 12, 773, 16, 2)
    kw.update(img_size=[IMG, IMG], depth=2)
    p["head_kwargs"].update(img_size=[IMG, IMG])
    p.update(compute_dtype="float32", use_checkpointing=False,
             vmoe_noisy_std=0.0, nworkers=0, trBatch=B, valBatch=B,
             train_scale=[IMG, IMG], test_scale=[IMG, IMG])
    files = _files(tmp_path_factory.mktemp("vit_base"), p)
    tp, jp = create_config(*files), jax_create_config(*files)
    names = list(tp["TASK_NAMES"])
    model, _ = build_model(tp, device="cpu", seed=5)
    params, stats = _flax_params(model.state_dict(), names, True)
    model.load_state_dict(jax_variables_to_state_dict(
        {"params": params, "batch_stats": stats}, names, len(names)),
        strict=True)
    batch = {k: v.numpy() for k, v in synthetic_batch(
        torch.Generator().manual_seed(6), tp["TASKS"], B, (IMG, IMG)).items()}
    cotangent = np.random.RandomState(7).randn(
        B, 1 + (IMG // 16) ** 2, 768).astype(np.float32)
    weights = jp["loss_kwargs"]["loss_weights"]
    jfns = jsch.build_loss_fns(jp)
    jmodel = jax_build_model(jp)
    jbackbone, _ = jax_build_backbone(jp)
    rngs = {"gate_noise": jax.random.key(0), "dropout": jax.random.key(1)}

    def run(params, stats, batch, cotangent):
        variables = {"params": params, "batch_stats": stats}
        pred = jmodel.apply(variables, batch["image"], train=False)[0]
        (tpred, cv, _), _ = jmodel.apply(
            variables, batch["image"], train=True, rngs=rngs,
            mutable=["batch_stats"])
        losses = jsch.multi_task_loss(tpred, batch, names, jfns, weights)

        def backbone_alone(bparams):
            tokens, bcv, _ = jbackbone.apply(
                {"params": bparams}, batch["image"], jnp.int32(0),
                train=True, rngs=rngs)
            return jnp.sum(tokens * cotangent) + 0.01 * bcv

        grads = jax.grad(backbone_alone)(params["backbone"])
        return pred, losses["total"] + 0.01 * cv, losses, grads

    nhwc = {k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in batch.items()}
    out = jax.tree.map(np.asarray, jax.jit(
        run, compiler_options=FAST_COMPILE)(params, stats, nhwc,
                                            jnp.asarray(cotangent)))
    return tp, names, model, batch, cotangent, params, out


def test_vit_base_moe_eval_forward_matches_jax(vit_base_run):
    tp, names, model, batch, _, _, (jpred, _, _, _) = vit_base_run
    model.eval()
    with torch.no_grad():
        pred = model(t(batch["image"]))[0]
    assert set(pred) == set(names)
    for n in names:
        np.testing.assert_allclose(pred[n].numpy().transpose(0, 2, 3, 1),
                                   jpred[n], rtol=1e-4, atol=1e-4, err_msg=n)


def test_vit_base_moe_train_step_matches_jax(vit_base_run):
    """One train step's objective (the multi-task loss with TAM's level-0
    terms, plus 0.01 cv) and each of its terms to 1e-4 relative; the
    backbone alone (task 0's routers) under a fixed cotangent: every
    parameter's gradient to 1e-4 of its largest magnitude, experts and
    routers included."""
    (tp, names, model, batch, cotangent, params,
     (_, jtotal, jlosses, jgrads)) = vit_base_run
    model.train()
    pred, cv, _ = model(t(batch["image"]))
    losses = tsch.multi_task_loss(pred, {k: t(v) for k, v in batch.items()},
                                  names, tsch.build_loss_fns(tp),
                                  tp["loss_kwargs"]["loss_weights"])
    assert len(losses) == 2 * len(names) + 1
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jlosses[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose((losses["total"] + 0.01 * cv).item(),
                               float(jtotal), rtol=1e-4)

    model.zero_grad(set_to_none=True)
    tokens, bcv, _ = model.backbone(t(batch["image"]), 0)
    ((tokens * t(cotangent)).sum() + 0.01 * bcv).backward()
    zeros = jax.tree.map(np.zeros_like, params)
    ref = jax_variables_to_state_dict(
        {"params": {**zeros, "backbone": jgrads}}, names, len(names))
    backbone = [(k, prm) for k, prm in model.named_parameters()
                if k.startswith("backbone.")]
    assert any(".mlp.experts.htoh4" in k for k, _ in backbone)
    for k, prm in backbone:
        if prm.grad is None:     # the other tasks' routers
            assert ".gate." in k and not k.split(".gate.")[1].startswith(
                "0."), k
            assert not ref[k].abs().max(), k
            continue
        scale = max(float(ref[k].abs().max()), 1e-3)
        np.testing.assert_allclose(prm.grad.numpy(), ref[k].numpy(),
                                   atol=1e-4 * scale, err_msg=k)


# ---- the route every config takes --------------------------------------

# the one config with a ViT backbone that has no kernel route: d = 64 with
# 4 heads (head dim 16, which K1/K2 do not take; ROADMAP queue 2).
# cityscapes/vit_base_moe_ep has a route at d 768 on one card; what it
# waits on is expert parallelism across cards (ROADMAP queue 1 item 6)
QUEUED = {"configs/smoke/tiny_moe_synthetic.yml": "head dim 16",
          "configs/smoke/tiny_token_synthetic.yml": "head dim 16"}
# the configs the token slice brings onto the card (the token variant and
# the task-conditioned router; tiny_token_synthetic is queued)
TOKEN = {
    "configs/pascal/token_moe/pup_moe_vit_small_multi_task_baseline.yml",
    "configs/pascal/token_moe_multi_task.yml",
    "configs/nyud/vit_moe_task_conditioned.yml",
    "configs/pascal/vit_moe/pup_moe_vit_small_multi_task_baseline_onehot.yml",
} | {f"configs/nyud/token_moe/pup_moe_vit_{w}_{t}.yml"
     for w, ts in (("small", ("semseg", "depth", "normal",
                              "multi_task_baseline")),
                   ("base", ("semseg", "depth", "multi_task_baseline")))
     for t in ts}
# the configs this width slice brings onto the card
WIDE = {
    "configs/pascal/vit_moe/pup_moe_vit_base_multi_task_baseline.yml",
    "configs/nyud/vit_moe/pup_moe_vit_base_semseg.yml",
    "configs/nyud/vit_moe/pup_moe_vit_base_depth.yml",
    "configs/nyud/vit_moe/pup_moe_vit_base_multi_task_baseline.yml",
    "configs/nyud/vit/pup_vit_base_deit_semseg.yml",
    "configs/nyud/vit/pup_vit_base_deit_depth.yml",
    "configs/nyud/vit/pup_vit_base_deit_multi_task_baseline.yml",
    "configs/pascal/vit/pup_vit_base_deit_multi_task_baseline.yml",
    "configs/nyud/vit/pup_vit_large_semseg.yml",
    "configs/nyud/vit/pup_vit_large_depth.yml",
    "configs/nyud/vit/pup_vit_large_multi_task_baseline.yml",
    "configs/cityscapes/pup_vit_tiny_deit_multi_task_baseline.yml",
    "configs/nyud/vit/pup_vit_tiny_multi_task_baseline.yml",
    "configs/pascal/vit/pup_vit_tiny_deit_multi_task_baseline.yml",
}


def _vit_configs():
    """(path relative to the repo, config) of every config with a ViT
    backbone the port builds."""
    out = {}
    for f in sorted((ROOT / "configs").rglob("*.yml")):
        p = yaml.safe_load(f.read_text())
        if isinstance(p, dict) and p.get("backbone") in (
                "VisionTransformer", "VisionTransformer_moe") \
                + TOKEN_BACKBONES:
            out[str(f.relative_to(ROOT))] = p
    return out


def _widths(p):
    """(model width, head dim, FFN hidden sizes) of a ViT config."""
    kw = p["backbone_kwargs"]
    d = int(kw["embed_dim"])
    hidden = {int(d * kw.get("mlp_ratio", 4.0))}
    if p["backbone"] != "VisionTransformer":
        hidden.add(int(d * kw.get("moe_mlp_ratio", 1)))
    return d, d // int(kw["num_heads"]), hidden


def test_every_vit_config_has_a_kernel_route():
    """Every ViT config the port builds, bar the queued ones, has a head
    dim K1/K2 take and a route for each of its FFN widths (fused for d in
    FUSED_DIMS, two-pass for TWO_PASS_DIMS); the configs this slice adds
    are among them, and those of the token slice (11 of its 12; the
    twelfth, d 64, is queued), and d = 64 still has no route."""
    configs = _vit_configs()
    assert set(QUEUED) | WIDE | TOKEN <= set(configs)
    assert len(TOKEN) == 11
    routes = {}
    for path, p in configs.items():
        if path in QUEUED:
            continue
        d, head_dim, hidden = _widths(p)
        assert head_dim in HEAD_DIMS, path
        routes[path] = {ffn_route(d, h) for h in hidden}
        assert routes[path] == {"two_pass" if d in TWO_PASS_DIMS
                                else "fused"}, path
    assert {_widths(configs[f])[0] for f in WIDE} == {192, 768, 1024}
    assert routes["configs/cityscapes/vit_base_moe_ep.yml"] == {"two_pass"}
    assert {d for d, _, _ in map(_widths, configs.values())} - {64} <= set(
        FUSED_DIMS + TWO_PASS_DIMS)
    with pytest.raises(ValueError, match="model width 64"):
        ffn_route(_widths(configs["configs/smoke/tiny_moe_synthetic.yml"])[0],
                  256)


@pytest.mark.parametrize("d,hidden,route", [
    (128, 256, "fused"), (192, 384, "fused"), (384, 1536, "fused"),
    (768, 1536, "two_pass"), (1024, 4096, "two_pass")])
def test_ffn_route_by_width(d, hidden, route):
    assert ffn_route(d, hidden) == route


@pytest.mark.parametrize("d,hidden", [(64, 256), (512, 2048), (768, 1000),
                                      (1024, 0)])
def test_ffn_route_refuses_other_shapes(d, hidden):
    with pytest.raises(ValueError):
        ffn_route(d, hidden)


def test_head_gradient_gap_is_a_relu_flip(vit_base_run, monkeypatch):
    """ROADMAP.md queue 3, located: a head's train-mode gradient moves by
    up to ~1e-2 of its magnitude between the packages because a BatchNorm
    output within f32 rounding of zero takes opposite signs, so the ReLU
    keeps the element on one side only (JAX's two-pass head gradients
    equal its one-pass ones bit for bit, as the port's do:
    test_torch_port_step_paths.py::test_head_grads_of_joint_step_equal_
    one_by_one).  Each head in f32 against the same head in f64 on the
    same features: with the f64 ReLU masks replayed the f32 gradients
    agree to 1e-4 of their largest magnitude (this file's gradient
    tolerance), and without them a head's gradients leave that tolerance
    only where a mask flipped.  The normals head is left out: its L1 loss
    has a sign of its own at every element (|out - label|), which the
    same rounding flips."""
    import copy
    import types

    import torch.nn.functional as F

    from m3vit_tpu_torch.losses.functions import loss_fn_for_task
    from m3vit_tpu_torch.models import heads as heads_mod
    from m3vit_tpu_torch.models.heads import resize_bilinear
    from tests.torch_port_replay import replay_head_masks

    tp, names, model, batch, *_ = vit_base_run
    model.train()
    x = t(batch["image"])

    def run(head, feats, task, masks=None):
        """The head's parameter gradients, and its ReLU masks."""
        seen = []

        def bn_relu(self, j, y):
            z = heads_mod.batch_norm(getattr(self, f"syncbn_fc_{j}"), y,
                                     self.training).to(self.dtype)
            seen.append(z.detach() > 0)
            return F.relu(z)

        head.zero_grad(set_to_none=True)
        with monkeypatch.context() as m:
            if head.dtype == torch.float64:   # LayerNorm in f64 too
                m.setattr(heads_mod, "layer_norm", lambda n, v: F.layer_norm(
                    v, n.normalized_shape, n.weight, n.bias, n.eps))
            if masks is None:
                m.setattr(heads_mod.VisionTransformerUpHead, "_bn_relu",
                          bn_relu)
                out = head(feats)
            else:
                with replay_head_masks(types.SimpleNamespace(
                        decoders={task: head}), {task: masks}):
                    out = head(feats)
        out = out[0] if isinstance(out, tuple) else out   # TAM's features
        loss_fn_for_task(task, tp)(resize_bilinear(out, (IMG, IMG)),
                                   t(batch[task])).backward()
        return {k: p.grad.double() for k, p in head.named_parameters()}, seen

    flipped, gapped = set(), set()
    for i, task in enumerate(names):
        if task == "normals":
            continue
        with torch.no_grad():
            feats = model.backbone(x, i)[0]
        head64 = copy.deepcopy(model.decoders[task]).double()
        head64.dtype = torch.float64
        g64, masks64 = run(head64, feats.double(), task)
        g32, masks32 = run(copy.deepcopy(model.decoders[task]), feats, task)
        g32r, _ = run(copy.deepcopy(model.decoders[task]), feats, task,
                      masks64)
        if any(bool((a != b).any()) for a, b in zip(masks32, masks64)):
            flipped.add(task)
        for k, ref in g64.items():
            if k in ("conv_0.bias", "conv_1.bias", "conv_2.bias",
                     "conv_3.bias"):
                # a bias before a train-mode BatchNorm: zero in exact
                # arithmetic, f32 rounding in either package
                assert float(ref.abs().max()) < 1e-12, (task, k)
                continue
            scale = max(float(ref.abs().max()), 1e-3)
            np.testing.assert_allclose(g32r[k].numpy(), ref.numpy(),
                                       atol=1e-4 * scale,
                                       err_msg=f"{task} {k}, masks replayed")
            if float((g32[k] - ref).abs().max()) > 1e-4 * scale:
                gapped.add(task)
    assert gapped <= flipped, (gapped, flipped)
    assert flipped, "no head's ReLU mask flipped at these weights"
