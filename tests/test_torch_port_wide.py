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
QUEUED = {"configs/smoke/tiny_moe_synthetic.yml": "head dim 16"}
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
                "VisionTransformer", "VisionTransformer_moe"):
            out[str(f.relative_to(ROOT))] = p
    return out


def _widths(p):
    """(model width, head dim, FFN hidden sizes) of a ViT config."""
    kw = p["backbone_kwargs"]
    d = int(kw["embed_dim"])
    hidden = {int(d * kw.get("mlp_ratio", 4.0))}
    if p["backbone"] == "VisionTransformer_moe":
        hidden.add(int(d * kw.get("moe_mlp_ratio", 1)))
    return d, d // int(kw["num_heads"]), hidden


def test_every_vit_config_has_a_kernel_route():
    """Every ViT config the port builds, bar the queued ones, has a head
    dim K1/K2 take and a route for each of its FFN widths (fused for d in
    FUSED_DIMS, two-pass for TWO_PASS_DIMS); the configs this slice adds
    are among them, and d = 64 still has no route."""
    configs = _vit_configs()
    assert set(QUEUED) | WIDE <= set(configs)
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
