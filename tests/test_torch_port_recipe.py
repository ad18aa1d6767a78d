"""The paper's training recipe in the port against the JAX package (CPU,
f32): the reference / DeiT checkpoint interop (expert upcycling, the
position-embedding resize, rank-sharded reference checkpoints both ways,
their validation), the CLI's --pretrained, --ref_ckpt and
--backbone_random_init, TAM with its loss branches, dropout and drop-path,
and block rematerialisation.

Reference-format files are written here from seeded tensors at small
shapes.  The JAX side runs as one jitted program at XLA's lowest CPU
optimisation level where it runs a model.  Tolerances: the interop
functions bit for bit (both sides copy and scale numpy arrays alike); the
position-embedding resize 1e-6 (jax.image.resize against the port's numpy
weights, summed in another order); model outputs and losses 1e-4, as
tests/test_torch_port_model.py; dropout bit for bit on the same mask;
rematerialised gradients bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from m3vit_tpu.cli.train import load_pretrained_backbone as jax_load_pretrained
from m3vit_tpu.config import create_config as jax_create_config
from m3vit_tpu.losses import schemes as jsch
from m3vit_tpu.losses.functions import loss_fn_for_task as jax_loss_fn
from m3vit_tpu.models.factory import build_model as jax_build_model
from m3vit_tpu.utils import torch_interop as jint
from m3vit_tpu_torch.cli import train as cli
from m3vit_tpu_torch.config import create_config
from m3vit_tpu_torch.data.synthetic import synthetic_batch
from m3vit_tpu_torch.losses import schemes as tsch
from m3vit_tpu_torch.losses.functions import loss_fn_for_task
from m3vit_tpu_torch.models import build_model
from m3vit_tpu_torch.models.vit_moe import collect_gate_stats
from m3vit_tpu_torch.ops import dropout as dropout_ops
from m3vit_tpu_torch.ops.dropout import drop_path, dropout
from m3vit_tpu_torch.utils import torch_interop as tint
from m3vit_tpu_torch.utils.convert import jax_variables_to_state_dict
from tests.jax_fast_compile import FAST_COMPILE

ROOT = Path(__file__).resolve().parent.parent
HEADLINE = ROOT / "configs" / "pascal" / "vit_moe_small_multi_task.yml"
DEIT_CFG = ROOT / "configs" / "pascal" / "vit" / \
    "pup_vit_small_deit_multi_task_baseline.yml"
DROP_CFG = ROOT / "configs" / "nyud" / "vit_moe" / \
    "pup_moe_vit_small_multi_task_baseline_drop0.1_droppath0.1.yml"
TASKS3 = {"include_semseg": True, "include_sal": True,
          "include_normals": True}
TASKS2 = {"include_semseg": True, "include_normals": True}
NO_TAM = {"tam": False}
EMBED, HIDDEN = 64, 256
t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tests, restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _deit_sd(seed=0, depth=2, embed=EMBED, hidden=HIDDEN, grid=14):
    """A DeiT-small-format state dict (timm names, a cls token, a
    grid x grid position embedding, a 10-class head) of seeded arrays."""
    rng = np.random.RandomState(seed)

    def a(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    sd = {"cls_token": a(1, 1, embed), "pos_embed": a(1, 1 + grid * grid,
                                                     embed),
          "patch_embed.proj.weight": a(embed, 3, 16, 16),
          "patch_embed.proj.bias": a(embed), "norm.weight": a(embed),
          "norm.bias": a(embed), "head.weight": a(10, embed),
          "head.bias": a(10)}
    for i in range(depth):
        pre = f"blocks.{i}."
        for n, shape in (("norm1", (embed,)), ("norm2", (embed,)),
                         ("attn.qkv", (3 * embed, embed)),
                         ("attn.proj", (embed, embed)),
                         ("mlp.fc1", (hidden, embed)),
                         ("mlp.fc2", (embed, hidden))):
            sd[pre + n + ".weight"] = a(*shape)
            sd[pre + n + ".bias"] = a(shape[0])
    return sd


def _save_pth(sd, path):
    torch.save({"model": {k: t(v) for k, v in sd.items()}}, path)
    return str(path)


# ----------------------------------------------------------------- interop

@pytest.mark.parametrize("expert_hidden,scaling", [
    (HIDDEN, False), (EMBED, False), (EMBED, True)],
    ids=["replicate", "split", "split_scaled"])
def test_upcycle_matches_jax(expert_hidden, scaling):
    """The expert banks of both modes, bit for bit; the port's are in the
    torch [E, out, in] layout (E=8, K=2; split G=4)."""
    sd = _deit_sd()
    args = [sd[f"blocks.1.mlp.{k}"] for k in ("fc1.weight", "fc1.bias",
                                              "fc2.weight", "fc2.bias")]
    got = tint.upcycle_dense_mlp_to_experts(*args, 8, expert_hidden, 2,
                                            scaling)
    ref = jint.upcycle_dense_mlp_to_experts(*args, 8, expert_hidden, 2,
                                            scaling)
    for g, r, tr in zip(got, ref, (True, False, True, False)):
        r = r.transpose(0, 2, 1) if tr else r
        assert g.dtype == r.dtype and np.array_equal(g, r)
    if scaling:
        np.testing.assert_array_equal(got[0][1], args[0][EMBED:2 * EMBED]
                                      * np.float32(4.0))


@pytest.mark.parametrize("moe", [True, False], ids=["moe", "dense"])
def test_deit_to_backbone_params_matches_jax(moe):
    """Every tensor, bit for bit, with the JAX tree carried into the port's
    names by jax_variables_to_state_dict (the dense case: every block
    dense)."""
    sd = _deit_sd(depth=4)
    kw = dict(depth=4, num_experts=8 if moe else None,
              expert_hidden=EMBED, top_k=2, use_weight_scaling=True)
    got = tint.deit_to_backbone_params(sd, **kw)
    ref = jax_variables_to_state_dict(
        {"params": jint.deit_to_backbone_params(sd, **kw)}, [])
    assert {"backbone." + k for k in got} == set(ref)
    for k, v in got.items():
        assert np.array_equal(v, ref["backbone." + k].numpy()), k
    assert ("blocks.1.mlp.experts.htoh4.weight" in got) == moe


@pytest.mark.parametrize("target", [(32, 32), (4, 4), (30, 40)],
                         ids=["up", "down", "nyud"])
def test_interpolate_pos_embed_matches_jax(target):
    """jax.image.resize's bilinear resize, antialiased when downscaling,
    to 1e-6."""
    pos = _deit_sd()["pos_embed"]
    got = tint.interpolate_pos_embed(pos, 1, target)
    ref = jint.interpolate_pos_embed(pos, 1, target)
    assert got.shape == ref.shape == (1, 1 + target[0] * target[1], EMBED)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_sd():
    """{seed: state dict as arrays} of the tiny MoE model (_tiny_p of the
    headline config) at seeds 0, 3 and 5; 0 is the CLI's."""
    return {seed: {k: v.numpy() for k, v in build_model(
        _tiny_p(HEADLINE), device="cpu", seed=seed)[0].state_dict().items()}
        for seed in (0, 3, 5)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_reference_checkpoint_both_ways(tmp_path, writer, tiny_sd):
    """A 2-rank directory written by one side and read by the other: the
    merged state dict bit for bit, expert banks split on dim 0 in rank
    order, meta global after the merge.  (The JAX writer stores a 0-d
    array, a BatchNorm's step count, as one element: np.ascontiguousarray;
    the port's keeps its shape.)"""
    sd = tiny_sd[3]
    save = (jint if writer == "jax" else tint).save_reference_sharded_checkpoint
    load = (tint if writer == "jax" else jint).load_reference_checkpoint
    save(sd, str(tmp_path / "ref"), 2, extra={"epoch": 7})
    shard = torch.load(tmp_path / "ref" / "1.pth", weights_only=False)
    assert set(shard["state_dict"]) == {k for k in sd if ".experts." in k}
    assert shard["meta"]["expert_format"] == "local"
    ckpt, got = load(str(tmp_path / "ref"))
    assert ckpt["epoch"] == 7 and ckpt["meta"]["expert_format"] == "global"
    assert set(got) == set(sd)
    for k, v in sd.items():
        g = got[k].reshape(v.shape) if writer == "jax" else got[k]
        assert g.shape == v.shape and np.array_equal(g, v), k
    mine = tint.load_reference_checkpoint(str(tmp_path / "ref"))[1]
    assert all(np.array_equal(mine[k], got[k]) for k in got)


def _validate_cases():
    local = np.zeros((2, 4, 4), np.float32)
    full = np.zeros((4, 4, 4), np.float32)
    key = "module.blocks.1.mlp.experts.htoh4.weight"
    return {
        "meta_local": ({"meta": {"expert_format": "local"}}, {key: full}),
        "meta_global_wrong": ({"meta": {"expert_format": "global"}},
                              {key: local}),
        "args_world": ({"args": {"world_size": 2, "moe_experts": 4}},
                       {key: local}),
        "no_meta_wrong": ({}, {key: local}),
        "valid": ({"meta": {"expert_format": "global"}}, {key: full}),
        "dense": ({"meta": {"expert_format": "local"}},
                  {"blocks.0.mlp.fc1.weight": full}),
    }


@pytest.mark.parametrize("case", sorted(_validate_cases()))
def test_validate_reference_moe_checkpoint_matches_jax(case):
    """The same inputs raise the same error on both sides (or neither)."""
    ckpt, sd = _validate_cases()[case]
    errs = []
    for mod in (tint, jint):
        try:
            mod.validate_reference_moe_checkpoint(ckpt, sd, 4, "x")
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == (case in ("valid", "dense"))


# --------------------------------------------------------------------- CLI

def _tiny_p(cfg, tasks=TASKS3, **over):
    """Config `cfg` shrunk to img 32, embed 64, depth 2 (the MoE backbone's
    E=4, K=2), f32, the three tasks of TASKS3 on PASCAL-Context."""
    p = yaml.safe_load(Path(cfg).read_text())
    p["backbone_kwargs"].update(img_size=[32, 32], embed_dim=EMBED, depth=2,
                                num_heads=2, gate_dim=EMBED + len(tasks))
    p["head_kwargs"].update(img_size=[32, 32], embed_dim=EMBED)
    p.update(train_db_name="PASCALContext", val_db_name="PASCALContext",
             task_dictionary=tasks, train_scale=[32, 32],
             test_scale=[32, 32], nworkers=0, trBatch=2, valBatch=2,
             compute_dtype="float32", moe_experts=4, moe_top_k=2,
             use_checkpointing=False,
             loss_kwargs={"loss_scheme": "baseline", "loss_weights": {
                 "semseg": 1.0, "sal": 5.0, "normals": 10.0}})
    p.update(over)
    if "moe_mlp_ratio" not in p["backbone_kwargs"]:
        p["backbone_kwargs"]["moe_mlp_ratio"] = 1
    return p


def _files(tmp_path, p):
    env, exp = tmp_path / "env.yml", tmp_path / "exp.yml"
    env.write_text(yaml.safe_dump({"root_dir": str(tmp_path / "runs")}))
    exp.write_text(yaml.safe_dump(p))
    return str(env), str(exp)


def _cli(files, *extra):
    """The CLI on the CPU, building the model and loading what it is told,
    then training no epoch."""
    env, exp = files
    return cli.main(["--config_env", env, "--config_exp", exp, "--device",
                     "cpu", "--synthetic", "1", "--epochs", "0", *extra])


def _flax_params(model_sd, names, multi_gate):
    """The port's state dict as the JAX model's (params, batch_stats), by
    the JAX package's reference converter, TAM modules included."""
    sd = {k: np.array(v) for k, v in model_sd.items()
          if not k.endswith("num_batches_tracked")}
    params, stats = jint.reference_mtl_sd_to_params(
        sd, names, multi_gate_tasks=len(names) if multi_gate else 0)
    for lvl in range(3):
        pre = f"tam_model{lvl}."
        if any(k.startswith(pre) for k in sd):
            params[pre[:-1]], stats[pre[:-1]] = _tam_to_flax(sd, pre, names)
    return params, stats


def _tam_to_flax(sd, pre, names):
    """A TAM's reference-named tensors as flax (params, batch_stats): conv
    OIHW -> HWIO, ConvTranspose2d [in, out, kh, kw] -> [kh, kw, in, out]
    flipped (tests/test_reference_parity.py:test_tam_module_matches_reference)."""
    params, stats = {}, {}

    def conv(k):
        return {"kernel": sd[k + ".weight"].transpose(2, 3, 1, 0),
                "bias": sd[k + ".bias"]}

    def stage(src, dst, transposed=False):
        k = pre + src
        w = sd[k + ".0.weight"]
        params[dst + "_conv"] = {"kernel": w.transpose(2, 3, 0, 1)[::-1, ::-1]
                                 .copy(), "bias": sd[k + ".0.bias"]} \
            if transposed else conv(k + ".0")
        params[dst + "_bn"] = {"scale": sd[k + ".1.weight"],
                               "bias": sd[k + ".1.bias"]}
        stats[dst + "_bn"] = {"mean": sd[k + ".1.running_mean"],
                              "var": sd[k + ".1.running_var"]}

    for i in range(3):
        stage(f"layers{i}", f"layers{i}")
    for i in range(2):
        stage(f"encoder{i}", f"encoder{i}")
        stage(f"decoder{i}", f"decoder{i}", transposed=True)
    for n in names:
        stage(f"layers3.{n}", f"layers3_{n}")
        params[f"layers4_{n}"] = conv(f"{pre}layers4.{n}.0")
    return params, stats


def _jax_name(port_name):
    """The JAX tree path of a port parameter name (routers stacked on a
    task axis in JAX: every task's router maps to one path)."""
    n = port_name.removeprefix("backbone.")
    parts = n.split(".")
    if parts[0] == "blocks" and parts[3] == "gate":
        return f"block_{parts[1]}/mlp/{parts[-1]}"
    if parts[0].startswith("tam_model"):
        leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
        if parts[1] in ("layers3", "layers4"):
            stage = f"{parts[1]}_{parts[2]}"
            sub = parts[3]
        else:
            stage, sub = parts[1], parts[2]
        if parts[1] == "layers4":
            return f"{parts[0]}/{stage}/{leaf}"
        if sub == "1":
            leaf = {"kernel": "scale", "bias": "bias"}[leaf]
            return f"{parts[0]}/{stage}_bn/{leaf}"
        return f"{parts[0]}/{stage}_conv/{leaf}"
    return n.replace(".", "/")


@pytest.mark.parametrize("pos", [False, True], ids=["pos_init", "pos_deit"])
def test_cli_pretrained_matches_jax(tmp_path, pos, tiny_sd):
    """--pretrained deit.pth --use_weight_scaling [--pos_emb_from_pretrained]
    on the tiny MoE config (DeiT hidden 256 split into G=4 experts of 64,
    E=4, K=2; its 14 x 14 grid resized down to 2 x 2): the state dict
    equals JAX's load_pretrained_backbone on the same initial weights,
    converted, bit for bit (pos_embed to 1e-6 when resized); the tensors
    left at their initial values are JAX's, by name (its per-task routers
    are one stacked tensor)."""
    p = _tiny_p(HEADLINE)
    files = _files(tmp_path, p)
    deit = _save_pth(_deit_sd(), tmp_path / "deit.pth")
    flags = ["--pretrained", deit, "--use_weight_scaling",
             "--use_virtual_group_initialization"]
    out = _cli(files, *flags, *(["--pos_emb_from_pretrained"] if pos else []))
    got = out["state"]["model"].state_dict()

    jp = jax_create_config(*files)
    names = list(jp["TASK_NAMES"])
    params, stats = _flax_params(tiny_sd[0], names, True)
    merged = jax_load_pretrained(params, deit, jp,
                                 pos_emb_from_pretrained=pos,
                                 use_weight_scaling=True)
    ref = jax_variables_to_state_dict(
        {"params": merged, "batch_stats": stats}, names, len(names))
    assert set(ref) == set(got)
    for k, v in ref.items():
        if k == "backbone.pos_embed" and pos:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6)
        else:
            assert torch.equal(got[k], v), k
    loaded = jint.deit_to_backbone_params(
        jint.load_torch_state_dict(deit), depth=2, num_experts=4,
        expert_hidden=EMBED, top_k=2, use_weight_scaling=True,
        target_grid=(2, 2))
    if not pos:
        loaded.pop("pos_embed")
    _, missing = jint.merge_into(params["backbone"], loaded)
    assert {_jax_name(n) for n in out["pretrained_missing"]} == set(missing)
    assert ("backbone.pos_embed" in out["pretrained_missing"]) != pos


def test_cli_pretrained_dense_loads_every_block(tmp_path):
    """--pretrained on the dense ViT (the DeiT baseline config, shrunk)
    loads every block's MLP from the file.  The JAX CLI upcycles the odd
    blocks as if the backbone were MoE and so leaves their dense MLPs at
    their initial values (m3vit_tpu/cli/train.py:915-927), a fault the port
    does not inherit: the two agree on every other tensor, bit for bit."""
    p = _tiny_p(DEIT_CFG, TASKS2)
    files = _files(tmp_path, p)
    deit_sd = _deit_sd()
    deit = _save_pth(deit_sd, tmp_path / "deit.pth")
    out = _cli(files, "--pretrained", deit)
    got = out["state"]["model"].state_dict()
    assert out["pretrained_missing"] == ["backbone.pos_embed"]
    for i in range(2):
        for k in ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"):
            assert np.array_equal(got[f"backbone.blocks.{i}.mlp.{k}"].numpy(),
                                  deit_sd[f"blocks.{i}.mlp.{k}"])
    jp = jax_create_config(*files)
    names = list(jp["TASK_NAMES"])
    init, _ = build_model(create_config(*files), device="cpu", seed=0)
    params, stats = _flax_params(init.state_dict(), names, False)
    ref = jax_variables_to_state_dict(
        {"params": jax_load_pretrained(params, deit, jp,
                                       pos_emb_from_pretrained=False),
         "batch_stats": stats}, names)
    odd = {f"backbone.blocks.1.mlp.{k}" for k in ("fc1.weight", "fc1.bias",
                                                 "fc2.weight", "fc2.bias")}
    for k, v in ref.items():
        assert torch.equal(got[k], v) != (k in odd), k


def test_cli_ref_ckpt_matches_jax(tmp_path, tiny_sd):
    """--ref_ckpt on a 2-rank reference directory (weights of another seed,
    VMoE gates) into the tiny MoE config with the learned-noise gate: the
    state dict equals the JAX CLI's import (load, validate, reference
    converter, merge_into) converted, bit for bit, with the same parameters
    left at their initial values (the noise weights, which JAX stacks over
    the tasks)."""
    p = _tiny_p(HEADLINE, moe_gate_type="noisy")
    files = _files(tmp_path, p)
    src = tiny_sd[5]
    jint.save_reference_sharded_checkpoint(src, str(tmp_path / "ref"), 2)
    out = _cli(files, "--ref_ckpt", str(tmp_path / "ref"))
    got = out["state"]["model"].state_dict()

    jp = jax_create_config(*files)
    names = list(jp["TASK_NAMES"])
    init, _ = build_model(create_config(*files), device="cpu", seed=0)
    params, stats = _flax_params(init.state_dict(), names, True)
    ckpt, sd = jint.load_reference_checkpoint(str(tmp_path / "ref"))
    jint.validate_reference_moe_checkpoint(ckpt, sd, 4)
    loaded, bstats = jint.reference_mtl_sd_to_params(
        sd, names, depth=2, multi_gate_tasks=len(names))
    merged, missing = jint.merge_into(params, loaded)
    new_stats, _ = jint.merge_into(stats, bstats)
    ref = jax_variables_to_state_dict(
        {"params": merged, "batch_stats": new_stats}, names, len(names))
    assert set(ref) == set(got)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    for k, v in src.items():
        assert np.array_equal(got[k].numpy(), v), k
    assert missing and {"backbone/" + _jax_name(n)
                        for n in out["ref_ckpt_missing"]} == set(missing)
    assert len(out["ref_ckpt_missing"]) == len(names) * len(missing)


def test_cli_backbone_random_init_and_msgpack(tmp_path, tiny_sd):
    """--backbone_random_init keeps the initial weights despite
    --pretrained; a .msgpack checkpoint (the JAX package's own export)
    raises naming its ROADMAP item."""
    p = _tiny_p(HEADLINE)
    files = _files(tmp_path, p)
    deit = _save_pth(_deit_sd(), tmp_path / "deit.pth")
    out = _cli(files, "--pretrained", deit, "--backbone_random_init")
    model = out["state"]["model"]
    assert "pretrained_missing" not in out
    for k, v in tiny_sd[0].items():
        assert np.array_equal(model.state_dict()[k].numpy(), v), k
    with pytest.raises(NotImplementedError, match="item 9"):
        cli.load_pretrained_backbone(model, str(tmp_path / "x.msgpack"), p)


# --------------------------------------------------------------------- TAM

def _labels(rng, names, B, H, W):
    lab = {"semseg": rng.randint(0, 21, (B, 1, H, W)).astype(np.float32),
           "sal": (rng.rand(B, 1, H, W) > 0.7).astype(np.float32)}
    v = rng.randn(B, 3, H, W).astype(np.float32)
    lab["normals"] = v / np.linalg.norm(v, axis=1, keepdims=True)
    return {n: lab[n] for n in names}


def test_tam_train_outputs_and_loss_match_jax(tmp_path):
    """The tiny dense ViT of the DeiT baseline config (TAM at level 0,
    three tasks) in train mode, weights and seeded BN statistics carried
    into the JAX model and back into the port by jax_variables_to_state_dict
    (strict): the tam_level0_* outputs and the total loss to 1e-4, and the
    TAM's updated BN running statistics (flax momentum 0.9, biased
    variance) to 1e-5."""
    p = _tiny_p(DEIT_CFG, TASKS2)
    files = _files(tmp_path, p)
    tp, jp = create_config(*files), jax_create_config(*files)
    names = list(tp["TASK_NAMES"])
    model, _ = build_model(tp, device="cpu", seed=4)
    rng = np.random.RandomState(4)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_mean"):
            v = t((rng.randn(*v.shape) * 0.2).astype(np.float32))
        elif k.endswith("running_var"):
            v = t(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        sd[k] = v
    params, stats = _flax_params(sd, names, False)
    model.load_state_dict(jax_variables_to_state_dict(
        {"params": params, "batch_stats": stats}, names), strict=True)

    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    lab = _labels(rng, names, 2, 32, 32)
    weights = jp["loss_kwargs"]["loss_weights"]
    jfns = {n: jax_loss_fn(n, jp) for n in names}
    jmodel = jax_build_model(jp)

    def jrun(params, stats, x, lab):
        (pred, _, _), upd = jmodel.apply(
            {"params": params, "batch_stats": stats}, x, train=True,
            mutable=["batch_stats"])
        return pred, jsch.multi_task_loss(pred, lab, names, jfns, weights), \
            upd["batch_stats"]

    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    jpred, jloss, jstats = jax.jit(jrun, compiler_options=FAST_COMPILE)(
        params, stats, nhwc(x), {k: nhwc(v) for k, v in lab.items()})

    model.train()
    pred, _, _ = model(t(x))
    loss = tsch.multi_task_loss(pred, {k: t(v) for k, v in lab.items()},
                                names, {n: loss_fn_for_task(n, tp)
                                        for n in names}, weights)
    assert sorted(pred) == sorted(names + [f"tam_level0_{n}"
                                           for n in names])
    for n in names:
        np.testing.assert_allclose(
            pred[f"tam_level0_{n}"].detach().numpy(),
            np.asarray(jpred[f"tam_level0_{n}"]).transpose(0, 3, 1, 2),
            rtol=1e-4, atol=1e-4, err_msg=n)
        np.testing.assert_allclose(loss[f"tam_level0_{n}"].item(),
                                   float(jloss[f"tam_level0_{n}"]),
                                   rtol=1e-4)
    np.testing.assert_allclose(loss["total"].item(), float(jloss["total"]),
                               rtol=1e-4)
    ref = jax_variables_to_state_dict(
        {"params": params, "batch_stats": jax.tree.map(np.asarray, jstats)},
        names)
    got = model.state_dict()
    keys = [k for k in ref if k.startswith("tam_model0.")
            and "running" in k]
    assert len(keys) == 2 * (7 + len(names))
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_tam_and_level_loss_branches_match_jax():
    """The tam_*, tam_level* and level* branches (the level outputs scale
    every term by 0.25; NaN counted as 0) on the same predictions, to
    1e-6 relative."""
    rng = np.random.RandomState(8)
    names = ["semseg", "sal"]
    lab = _labels(rng, names, 2, 8, 8)
    keys = names + [f"{f}_{n}" for f in ("tam", "tam_level0", "tam_level2",
                                         "level1", "level2", "level3")
                    for n in names]
    pred = {k: rng.randn(2, 21 if k.endswith("semseg") else 1, 8, 8)
            .astype(np.float32) for k in keys}
    weights = {"semseg": 1.0, "sal": 5.0}
    fns = {n: loss_fn_for_task(n, {}) for n in names}
    jfns = {n: jax_loss_fn(n, {}) for n in names}
    got = tsch.multi_task_loss({k: t(v) for k, v in pred.items()},
                               {k: t(v) for k, v in lab.items()}, names, fns,
                               weights)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    ref = jax.jit(lambda p, g: jsch.multi_task_loss(p, g, names, jfns,
                                                    weights),
                  compiler_options=FAST_COMPILE)(
        {k: nhwc(v) for k, v in pred.items()},
        {k: nhwc(v) for k, v in lab.items()})
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-6,
                                   err_msg=k)


# ------------------------------------------------- dropout and drop-path

@pytest.mark.parametrize("kind", ["dropout", "drop_path"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_jnp_where(kind, dtype):
    """With the same mask: jnp.where(mask, x / keep, 0) bit for bit (flax
    nn.Dropout; m3vit_tpu/models/vit.py:drop_path)."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 9, 16).astype(np.float32)
    shape = x.shape if kind == "dropout" else (4, 1, 1)
    mask = rng.rand(*shape) < 0.7
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(jnp.where(jnp.asarray(mask), jx / 0.7, 0.0)
                     .astype(jnp.float32))
    fn = dropout if kind == "dropout" else drop_path
    got = fn(t(x).to(getattr(torch, dtype)), 0.3, None, t(mask))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_dropout_masks_keep_their_share():
    """Drawn masks keep 1 - p of the elements (of the samples, for
    drop-path) within 4 sigma, scale the kept by 1 / keep, and come from
    the generator alone; rate 0 returns x itself."""
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = dropout(x, 0.1, g)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 4 * (0.9 * 0.1 / x.numel()) ** 0.5
    assert torch.all((y == 0) | (y == torch.tensor(1 / 0.9)))
    xs = torch.ones(20_000, 3, 2)
    ys = drop_path(xs, 0.25, g)
    per = (ys[:, 0, 0] != 0).float()
    assert torch.equal(ys != 0, per[:, None, None].expand_as(ys).bool())
    assert abs(per.mean().item() - 0.75) < 4 * (0.75 * 0.25 / 20_000) ** 0.5
    a = dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(a, dropout(x, 0.1, torch.Generator().manual_seed(3)))
    assert dropout(x, 0.0, None) is x and drop_path(x, 0.0, None) is x


def _drop_model(cfg, **over):
    p = _tiny_p(cfg, TASKS2, **over)
    p["backbone_kwargs"].update(drop_rate=0.1, attn_drop_rate=0.1,
                                drop_path_rate=0.1)
    return p


@pytest.mark.parametrize("cfg", [DROP_CFG, DEIT_CFG], ids=["moe", "dense"])
def test_dropout_inactive_in_eval_is_identity(cfg):
    """In eval a model with dropout, attention dropout and drop-path gives
    the bits of the same weights without them."""
    p = _drop_model(cfg, vmoe_noisy_std=0.0, model_kwargs=NO_TAM)
    q = _tiny_p(cfg, TASKS2, vmoe_noisy_std=0.0, model_kwargs=NO_TAM)
    with_drop, _ = build_model(p, device="cpu", seed=6)
    plain, _ = build_model(q, device="cpu", seed=6)
    plain.load_state_dict(with_drop.state_dict())
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = with_drop(x)[0], plain(x)[0]
    assert all(torch.equal(a[k], b[k]) for k in b)


def _fixed_mask(shape, keep, kind):
    """The mask both sides draw for a site of `shape`: all kept, or a
    seeded one keeping about `keep` of it, keyed by the element count alone
    (so the order in which the sides draw does not matter, nor a flattening
    of the batch into the token axis, which the port's dense MLP does)."""
    size = int(np.prod(shape))
    if kind == "keep_all":
        return np.ones(shape, bool)
    return (np.random.RandomState(size).rand(size) < keep).reshape(shape)


MASK_KINDS = ("keep_all", "seeded")


@pytest.fixture(scope="module", params=[DROP_CFG, DEIT_CFG],
                ids=["moe", "dense"])
def dropout_case(request, tmp_path_factory):
    """A tiny model of the config with dropout, attention dropout and
    drop-path at 0.1 (TAM off, gate noise 0), an input and labels, and the
    JAX model's training forward on the same weights under each kind of
    _fixed_mask (jax.random.bernoulli, which flax's nn.Dropout and the JAX
    drop-path and expert dropout call, replaced), both in one program:
    {kind: (predictions, cv loss, total loss, element counts drawn)}."""
    cfg = request.param
    p = _drop_model(cfg, vmoe_noisy_std=0.0, model_kwargs=NO_TAM)
    files = _files(tmp_path_factory.mktemp("dropout"), p)
    tp, jp = create_config(*files), jax_create_config(*files)
    names = list(tp["TASK_NAMES"])
    model, _ = build_model(tp, device="cpu", seed=7)
    params, stats = _flax_params(model.state_dict(), names, cfg == DROP_CFG)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    lab = _labels(rng, names, 2, 32, 32)
    weights = jp["loss_kwargs"]["loss_weights"]
    jfns = {n: jax_loss_fn(n, jp) for n in names}
    jmodel = jax_build_model(jp)
    drawn = {kind: [] for kind in MASK_KINDS}
    now = {}

    def jax_bernoulli(key, p=0.5, shape=None):
        drawn[now["kind"]].append(int(np.prod(shape)))
        return jnp.asarray(_fixed_mask(shape, p, now["kind"]))

    def jrun(params, stats, x, lab):
        out = {}
        for kind in MASK_KINDS:
            now["kind"] = kind
            (pred, cv, _), _ = jmodel.apply(
                {"params": params, "batch_stats": stats}, x, train=True,
                mutable=["batch_stats"], rngs={
                    "dropout": jax.random.PRNGKey(0),
                    "gate_noise": jax.random.PRNGKey(1)})
            out[kind] = (pred, cv, jsch.multi_task_loss(
                pred, lab, names, jfns, weights)["total"])
        return out

    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", jax_bernoulli)
        ref = jax.jit(jrun, compiler_options=FAST_COMPILE)(
            params, stats, nhwc(x), {k: nhwc(v) for k, v in lab.items()})
    return {"tp": tp, "names": names, "model": model, "x": x, "lab": lab,
            "weights": weights,
            "ref": {k: jax.tree.map(np.asarray, v) + (drawn[k],)
                    for k, v in ref.items()}}


@pytest.mark.parametrize("kind", MASK_KINDS)
def test_dropout_sites_match_jax(monkeypatch, dropout_case, kind):
    """The port's training forward of dropout_case's model, its masks too
    taken from _fixed_mask (ops.dropout._mask replaced), against the JAX
    model's: all kept checks each site's 1 / keep scaling, the seeded masks
    which elements each site drops.  The same element counts drawn, the
    predictions, the cv loss and the total loss to 1e-4, so a site missing,
    doubled or moved (before the GELU, say) fails here."""
    c = dropout_case
    names, tp = c["names"], c["tp"]
    jpred, jcv, jloss, jdrawn = c["ref"][kind]
    drawn = []

    def port_mask(shape, keep, rng, device):
        drawn.append(int(np.prod(shape)))
        return t(_fixed_mask(shape, keep, kind)).to(device)

    monkeypatch.setattr(dropout_ops, "_mask", port_mask)
    model = c["model"].train()
    with torch.no_grad():
        pred, cv, _ = model(t(c["x"]), noise=torch.Generator().manual_seed(0))
        loss = tsch.multi_task_loss(
            pred, {k: t(v) for k, v in c["lab"].items()}, names,
            {n: loss_fn_for_task(n, tp) for n in names},
            c["weights"])["total"]
    assert sorted(drawn) == sorted(jdrawn)
    assert sorted(pred) == sorted(names)
    for n in names:
        np.testing.assert_allclose(
            pred[n].numpy(), jpred[n].transpose(0, 3, 1, 2),
            rtol=1e-4, atol=1e-4, err_msg=n)
    np.testing.assert_allclose(float(cv), float(jcv), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)


@pytest.mark.parametrize("cfg", [DROP_CFG, DEIT_CFG], ids=["moe", "dense"])
def test_remat_gradients_are_bitwise(cfg):
    """One train forward and backward of the same weights with
    use_checkpointing on and off, dropout, attention dropout and drop-path
    active, gate noise on, TAM at level 0 on the MoE config, the masks
    drawn from generators of one seed: the loss, every parameter gradient,
    the BN statistics and the gate statistics bit for bit; the generator
    ends in the same state (the recompute replays the masks and does not
    disturb later draws)."""
    p = _drop_model(cfg, model_kwargs={"tam": cfg == DROP_CFG,
                                       "tam_level1": False,
                                       "tam_level2": False})
    model, tasks = build_model(p, device="cpu", seed=2)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    names = [tk.name for tk in tasks]
    batch = synthetic_batch(torch.Generator().manual_seed(0), tasks, 2,
                            (32, 32))
    runs = []
    for remat in (False, True):
        model.load_state_dict(init)
        model.zero_grad(set_to_none=True)
        model.backbone.use_checkpointing = remat
        gen = torch.Generator().manual_seed(9)
        model.train()
        with collect_gate_stats(model):
            pred, cv, stats = model(batch["image"], noise=gen)
        loss = tsch.multi_task_loss(
            pred, batch, names, {n: loss_fn_for_task(n, p) for n in names},
            p["loss_kwargs"]["loss_weights"])["total"] + 0.01 * cv
        loss.backward()
        runs.append((loss.detach(), {n: q.grad for n, q in
                                     model.named_parameters()},
                     {k: v.clone() for k, v in model.state_dict().items()},
                     stats, gen.get_state(), pred))
    (l0, g0, s0, st0, r0, p0), (l1, g1, s1, st1, r1, p1) = runs
    assert ("tam_level0_semseg" in p0) == (cfg == DROP_CFG)
    assert torch.equal(l0, l1) and torch.equal(r0, r1)
    assert all(v is not None for v in g0.values())
    assert all(torch.equal(v, g1[k]) for k, v in g0.items())
    assert all(torch.equal(v, s1[k]) for k, v in s0.items())
    assert st0.keys() == st1.keys()
    assert all(torch.equal(v, st1[k]) for k, v in st0.items())
    if cfg == DROP_CFG:
        # one token count per MoE block and task pass: not counted twice
        assert st0["gate_token_count"].item() == 2 * 2 * 5
