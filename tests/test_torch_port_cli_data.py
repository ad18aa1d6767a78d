"""The port's trainer CLI slice against the JAX package (CPU): the config,
the dataset readers and transforms, the loader, get_output, the online
evaluation and its meters, the boundary evaluation, the checkpoints, and
the CLI end to end.

Data are trees made by scripts/fabricate_dataset.py (4 images of 48 x 64
per dataset); the model is the headline config shrunk (img 32, embed 64,
depth 2, 2 heads, E=4, K=2, f32).  Loading is in-process (nworkers 0): the
worker path is held to it on the card by chip_smoke.py.  Tolerances are
stated at each test: bit for bit where both sides run the same numpy/cv2
code, 1e-6 relative for meters fed the same predictions, 1e-4 relative
for the evaluation of one model's weights through both frameworks.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from m3vit_tpu import native as jax_native
from m3vit_tpu.config import create_config as jax_create_config
from m3vit_tpu.data import loader as jloader
from m3vit_tpu.data.pascal_context import zhang_suen_thin as jax_thin
from m3vit_tpu.data.transforms import get_transformations as jax_transforms
from m3vit_tpu.evaluation import edge_eval as jedge
from m3vit_tpu.evaluation import orchestrate as jorch
from m3vit_tpu.evaluation.outputs import get_output as jax_get_output
from m3vit_tpu.models.factory import build_model as jax_build_model
from m3vit_tpu.moe.dispatch import parse_capacity_factor as jax_parse_cf
from m3vit_tpu.train.state import TrainState
from m3vit_tpu.utils.torch_interop import reference_mtl_sd_to_params
from m3vit_tpu_torch import native
from m3vit_tpu_torch.cli import train as cli
from m3vit_tpu_torch.config import create_config
from m3vit_tpu_torch.data import loader
from m3vit_tpu_torch.data.pascal_context import zhang_suen_thin
from m3vit_tpu_torch.data.transforms import get_transformations
from m3vit_tpu_torch.evaluation import edge_eval
from m3vit_tpu_torch.evaluation import orchestrate
from m3vit_tpu_torch.evaluation.outputs import get_output
from m3vit_tpu_torch.models import build_model
from m3vit_tpu_torch.models.token_moe import TokenMultiTaskModel
from m3vit_tpu_torch.moe.dispatch import parse_capacity_factor
from m3vit_tpu_torch.train.optim import build_optimizer
from m3vit_tpu_torch.utils import checkpoint as ckpt
from m3vit_tpu_torch.utils.convert import jax_variables_to_state_dict
from tests.jax_fast_compile import FAST_COMPILE

ROOT = Path(__file__).resolve().parent.parent
HEADLINE = ROOT / "configs" / "pascal" / "vit_moe_small_multi_task.yml"
N_IMAGES, HW = 4, (48, 64)
#: dataset -> (its env root key, the fabricating function)
DB = {"PASCALContext": ("PASCAL_MT", "fabricate_pascal"),
      "NYUD": ("NYUD_MT", "fabricate_nyud"),
      "CityScapes": ("cityscapes", "fabricate_cityscapes")}
#: per-dataset task dictionaries (every task each reader serves)
TASK_DICTS = {
    "PASCALContext": {"include_semseg": True, "include_human_parts": True,
                      "include_sal": True, "include_edge": True,
                      "include_normals": True, "edge_w": 0.95},
    "NYUD": {"include_semseg": True, "include_edge": True,
             "include_normals": True, "include_depth": True,
             "edge_w": 0.95},
    "CityScapes": {"include_semseg": True, "include_depth": True},
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tests, restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{db name: (root, env file)} of fabricated trees."""
    spec = importlib.util.spec_from_file_location(
        "fabricate_dataset", ROOT / "scripts" / "fabricate_dataset.py")
    fab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fab)
    base = tmp_path_factory.mktemp("trees")
    env = base / "env.yml"
    roots = {}
    for sub, fn in DB.values():
        getattr(fab, fn)(str(base / sub), N_IMAGES, HW)
        roots[sub] = str(base / sub)
    env.write_text(yaml.safe_dump({"root_dir": str(base / "runs"),
                                   "dataset_roots": roots}))
    return base, env


def _exp_file(tmp_path, db, **over):
    """The headline YAML with `db`'s dataset and tasks, 32 x 32 scales."""
    p = yaml.safe_load(HEADLINE.read_text())
    p.update(train_db_name=db, val_db_name=db, task_dictionary=TASK_DICTS[db],
             train_scale=[32, 32], test_scale=[32, 32], **over)
    path = tmp_path / f"{db}.yml"
    path.write_text(yaml.safe_dump(p))
    return path


def _configs(trees, tmp_path, db, **over):
    _, env = trees
    exp = _exp_file(tmp_path, db, **over)
    return (create_config(str(env), str(exp)),
            jax_create_config(str(env), str(exp)))


def _same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "meta":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- readers, transforms, loader ----

@pytest.mark.parametrize("db", sorted(DB))
def test_reader_matches_jax(trees, tmp_path, db):
    """Every sample of both splits, every key, bit for bit."""
    p, jp = _configs(trees, tmp_path, db)
    for split in ("train", "val"):
        ours = loader.get_dataset(p, split, None)
        ref = jloader.get_dataset(jp, split, None)
        assert len(ours) == len(ref) == N_IMAGES
        for i in range(N_IMAGES):
            _same_sample(ours[i], ref[i])


def test_zhang_suen_thin_matches_jax():
    """The numpy thinning and the native one, bit for bit."""
    rng = np.random.RandomState(0)
    img = rng.rand(40, 56) > 0.45
    img[10:30, 5:50] = True
    ref = jax_thin(img)
    np.testing.assert_array_equal(zhang_suen_thin(img), ref)
    assert native.native_available()
    np.testing.assert_array_equal(native.thin(img), jax_native.thin(img))
    np.testing.assert_array_equal(native.thin(img), ref)


@pytest.mark.parametrize("chain", ["train", "val"])
@pytest.mark.parametrize("db", sorted(DB))
def test_transforms_match_jax(trees, tmp_path, db, chain):
    """The train / val chain over every sample, each side drawing from
    one RandomState of the same seed: bit for bit."""
    p, jp = _configs(trees, tmp_path, db)
    k = 0 if chain == "train" else 1
    ours, ref = get_transformations(p)[k], jax_transforms(jp)[k]
    ds = loader.get_dataset(p, "train", None)
    r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
    for i in range(N_IMAGES):
        _same_sample(ours(ds[i], r1), ref(ds[i], r2))


@pytest.mark.parametrize("drop_last", [True, False])
def test_epoch_order_matches_jax(drop_last):
    """The batch sampler's keys are the JAX loader's epoch order, cut into
    its batches; a start skips whole batches."""
    n, bs, seed = 11, 3, 5
    ref = jloader.EpochLoader(list(range(n)), bs, shuffle=True,
                              drop_last=drop_last, seed=seed, num_workers=1)
    sampler = loader.EpochBatchSampler(n, bs, True, drop_last, seed)
    assert sampler.num_batches() == len(ref)
    for epoch in range(3):
        order = ref._epoch_order(epoch)
        sampler.set_epoch(epoch)
        got = list(sampler)
        assert [e for b in got for e, _ in b] == [epoch] * sum(map(len, got))
        flat = [i for b in got for _, i in b]
        assert flat == order[:len(flat)].tolist()
        assert len(got) == len(ref)
        sampler.set_epoch(epoch, start=2)
        assert list(sampler) == got[2:]


def test_val_batches_match_jax(trees, tmp_path):
    """The val loader's batches (a partial last one too): JAX's EpochLoader
    and collate over the same transform, transposed to NCHW, bit for
    bit."""
    p, jp = _configs(trees, tmp_path, "PASCALContext")
    ts = get_transformations(p)[1]
    ds = loader.get_dataset(p, "val", None)
    ours = loader.EpochLoader(ds, ts, 3, shuffle=False, drop_last=False)

    class _TDS:       # the JAX CLI's wrapper (cli/train.py:477-488)
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            return ts(ds[i], np.random.RandomState(i))

    ref = jloader.EpochLoader(_TDS(), 3, shuffle=False, drop_last=False,
                              num_workers=1)
    got, want = list(ours.epoch(0)), list(ref.epoch(0))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a["meta"] == b["meta"] and a.keys() == b.keys()
        for k in b:
            if k != "meta":
                assert a[k].dtype == torch.float32
                np.testing.assert_array_equal(
                    a[k].numpy(), b[k].transpose(0, 3, 1, 2), err_msg=k)


def test_augmentation_differs_between_epochs(trees, tmp_path):
    """The port draws a sample's augmentation from (seed, epoch, index):
    one index differs between epochs 0 and 1 and repeats within an epoch.
    The JAX CLI keys it on (seed, index) alone (cli/train.py:484-488),
    the same draw every epoch."""
    p, _ = _configs(trees, tmp_path, "PASCALContext")
    ds = loader.TransformedDataset(loader.get_dataset(p, "train", None),
                                   get_transformations(p)[0], seed=0)
    a, b, again = ds[(0, 1)], ds[(1, 1)], ds[(0, 1)]
    assert not np.array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["image"], again["image"])
    jax_rng = [np.random.RandomState((0 * 1_000_003 + 1) % 2**31)
               for _ in range(2)]
    assert jax_rng[0].random_sample() == jax_rng[1].random_sample()


# ---- evaluation ----

@pytest.mark.parametrize("task", ["semseg", "human_parts", "normals", "edge",
                                  "sal", "depth"])
def test_get_output_matches_jax(task):
    """get_output on NCHW logits: JAX's on the NHWC ones, bit for bit."""
    c = {"semseg": 21, "human_parts": 7, "normals": 3}.get(task, 1)
    x = np.random.RandomState(3).randn(2, c, 9, 11).astype(np.float32)
    got = get_output(torch.from_numpy(x.copy()), task)
    ref = jax_get_output(x.transpose(0, 2, 3, 1).copy(), task)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def _raw_predictions(names, n_batches, bs, seed=4):
    """Fixed raw NHWC predictions per batch at the 32 x 32 test scale."""
    c = {"semseg": 21, "human_parts": 7, "normals": 3}
    rng = np.random.RandomState(seed)
    return [{t: rng.randn(bs, 32, 32, c.get(t, 1)).astype(np.float32)
             for t in names} for _ in range(n_batches)]


def _assert_results_close(got, ref, rtol):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        for k in ref:
            _assert_results_close(got[k], ref[k], rtol)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(ref, np.float64), rtol=rtol,
                                   atol=1e-12)


def test_evaluate_online_matches_jax(trees, tmp_path):
    """evaluate_online with a stub eval step that returns fixed raw
    predictions: JAX's results dict to 1e-6, and validate_results keeps
    the same best over a sequence of results."""
    p, jp = _configs(trees, tmp_path, "PASCALContext")
    names = list(p["TASK_NAMES"])
    ts = get_transformations(p)[1]
    ds = loader.get_dataset(p, "val", None)
    raw = _raw_predictions(names, 2, 2)
    calls = []

    def step(batch):
        i = len(calls)
        calls.append(i)
        return {t: torch.from_numpy(raw[i][t].transpose(0, 3, 1, 2).copy())
                for t in names}

    got = orchestrate.evaluate_online(
        p, step, loader.EpochLoader(ds, ts, 2, shuffle=False).epoch(0))
    jbatches = [jloader.collate([ts(ds[j]) for j in (2 * i, 2 * i + 1)])
                for i in range(2)]
    jcalls = []

    def jstep(state, arrays):
        jcalls.append(0)
        return raw[len(jcalls) - 1]

    ref = jorch.evaluate_online(jp, jstep, None, jbatches)
    _assert_results_close(got, ref, 1e-6)
    worse = json.loads(json.dumps(ref))
    worse["multi_task_performance"] -= 0.1
    better = json.loads(json.dumps(ref))
    better["multi_task_performance"] += 0.1
    best, jbest = None, None
    for r in (ref, worse, better, worse):
        best, imp = orchestrate.validate_results(p, r, best)
        jbest, jimp = jorch.validate_results(jp, r, jbest)
        assert imp == jimp and best is jbest


def test_saved_predictions_match_jax(trees, tmp_path):
    """save_model_predictions then eval_saved_predictions (greedy odsF over
    5 thresholds) with the stub eval step: JAX's files, byte for byte, and
    JAX's results dict on them to 1e-6."""
    p, jp = _configs(trees, tmp_path, "PASCALContext",
                     edge_odsF_matcher="greedy", edge_odsF_thresholds=5,
                     nworkers=0)
    names = list(p["TASK_NAMES"])
    ts = get_transformations(p)[1]
    ds = loader.get_dataset(p, "val", None)
    raw = _raw_predictions(names, 2, 2, seed=6)
    it = iter(raw)
    ours = orchestrate.save_model_predictions(
        p, lambda b: {t: torch.from_numpy(v.transpose(0, 3, 1, 2).copy())
                      for t, v in next(it).items()},
        loader.EpochLoader(ds, ts, 2, shuffle=False).epoch(0),
        str(tmp_path / "ours"))
    jit = iter(raw)
    ref = jorch.save_model_predictions(
        jp, lambda s, b: next(jit), None,
        [jloader.collate([ts(ds[j]) for j in (2 * i, 2 * i + 1)])
         for i in range(2)], str(tmp_path / "ref"))
    files = sorted(f.relative_to(ref) for f in Path(ref).rglob("*.png"))
    assert len(files) == N_IMAGES * len(names)
    assert files == sorted(f.relative_to(ours)
                           for f in Path(ours).rglob("*.png"))
    for f in files:
        assert (Path(ours) / f).read_bytes() == (Path(ref) / f).read_bytes()
    got = orchestrate.eval_saved_predictions(p, ours, ds)
    want = jorch.eval_saved_predictions(jp, ref, jloader.get_dataset(
        jp, "val", None))
    assert "odsF" in want["edge"]
    _assert_results_close(got, want, 1e-6)


@pytest.mark.parametrize("matcher", ["exact", "greedy_native",
                                     "greedy_python"])
def test_evaluate_boundaries_matches_jax(matcher, monkeypatch):
    """evaluate_boundaries on soft edge maps: JAX's dict exactly, with the
    exact matcher, the greedy one through the native library, and the
    greedy one's Python matching (the native matcher taken away on both
    sides)."""
    if matcher == "greedy_python":
        monkeypatch.setattr(native, "match_boundaries", lambda *a: None)
        monkeypatch.setattr(jax_native, "match_boundaries", lambda *a: None)
    rng = np.random.RandomState(9)
    preds, gts = [], []
    for _ in range(3):
        gt = np.zeros((40, 56), np.float32)
        gt[rng.randint(5, 35), :] = 1
        gt[:, rng.randint(5, 50)] = 1
        preds.append(np.clip(gt * 0.7 + rng.rand(40, 56) * 0.5, 0, 1)
                     .astype(np.float32))
        gts.append(gt)
    kind = "exact" if matcher == "exact" else "greedy"
    got = edge_eval.evaluate_boundaries(preds, gts, thresholds=7,
                                        matcher=kind)
    ref = jedge.evaluate_boundaries(preds, gts, thresholds=7, matcher=kind)
    assert got == ref
    assert got["odsF"] > 0


def test_create_config_matches_jax(trees):
    """The headline YAML with an env file: JAX's dict on every key, the
    tasks compared by name."""
    _, env = trees
    args = {"moe_eval_capacity_factor": "nodrop", "trBatch": 8}
    p = create_config(str(env), str(HEADLINE), args)
    jp = jax_create_config(str(env), str(HEADLINE), args)
    assert p.keys() == jp.keys()
    for k in jp:
        if k in ("TASKS", "ALL_TASKS"):
            assert [t.name for t in p[k]] == [t.name for t in jp[k]]
            assert [t.infer_flagval for t in p[k]] == \
                [t.infer_flagval for t in jp[k]]
        else:
            assert p[k] == jp[k], k
    assert p.backbone_kwargs.embed_dim == 384


# ---- checkpoints ----

def _model_and_optimizer():
    """A small model with BatchNorm buffers, and SGD with momentum."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32),
                                torch.nn.BatchNorm1d(32),
                                torch.nn.Linear(32, 4))
    opt, _ = build_optimizer(model.parameters(), {
        "optimizer": "sgd", "optimizer_kwargs": {"lr": 0.1, "momentum": 0.9},
        "epochs": 2}, 2)
    return model, opt


def test_checkpoint_roundtrip_bitwise(tmp_path):
    """save then restore into a fresh model and optimizer: every tensor
    bit for bit, the step counter and meta back; three indices kept."""
    model, opt = _model_and_optimizer()
    model(torch.randn(8, 16)).square().sum().backward()   # BN stats move
    opt.step()
    for i in range(5):
        ckpt.save_checkpoint(str(tmp_path), i, model, opt, 7 + i,
                             {"next_it": 3})
    assert ckpt.indices(str(tmp_path)) == [2, 3, 4]
    assert json.loads((tmp_path / "meta_4.json").read_text()) == {
        "epoch": 4, "next_it": 3}
    fresh, fresh_opt = _model_and_optimizer()
    meta = ckpt.restore_checkpoint(str(tmp_path), fresh, fresh_opt)
    assert meta == {"epoch": 4, "next_it": 3, "train_step_calls": 11}
    assert int(model[1].num_batches_tracked) == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    a, b = opt.state_dict(), fresh_opt.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, st in a["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["state"][i][k])
    assert ckpt.restore_checkpoint(str(tmp_path / "none"), fresh) is None


def test_checkpoint_overwrite_survives_failed_save(tmp_path, monkeypatch):
    """A save that dies while overwriting an index leaves the old file
    loadable and whole."""
    model, opt = _model_and_optimizer()
    ckpt.save_checkpoint(str(tmp_path), 3, model, opt, 5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for prm in model.parameters():
            prm.add_(1.0)
    real_save = torch.save

    def dying_save(obj, path):
        real_save({"partial": torch.zeros(3)}, path)
        raise OSError("killed mid-save")

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(OSError, match="killed mid-save"):
        ckpt.save_checkpoint(str(tmp_path), 3, model, opt, 6)
    monkeypatch.setattr(torch, "save", real_save)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3.pt",
                                                          "meta_3.json"]
    fresh, _ = _model_and_optimizer()
    meta = ckpt.restore_checkpoint(str(tmp_path), fresh)
    assert meta["train_step_calls"] == 5
    for k, v in before.items():
        assert torch.equal(fresh.state_dict()[k], v), k


# ---- the CLI ----

TINY = dict(nworkers=0, trBatch=2, valBatch=2, epochs=2, eval_interval=1,
            compute_dtype="float32", moe_experts=4, moe_top_k=2,
            use_checkpointing=False)
#: one task of each output kind (class map, sigmoid map, unit vectors)
TINY_TASKS = {"include_semseg": True, "include_sal": True,
              "include_normals": True}


def _tiny_exp(tmp_path, **over):
    """The headline config shrunk to img 32, embed 64, depth 2, 2 heads,
    E=4, K=2, f32 and three of its tasks, on the PASCAL tree at 32 x 32."""
    p = yaml.safe_load(HEADLINE.read_text())
    p["backbone_kwargs"].update(img_size=[32, 32], embed_dim=64, depth=2,
                                num_heads=2, gate_dim=64 + len(TINY_TASKS))
    p["task_dictionary"] = TINY_TASKS
    p["head_kwargs"].update(img_size=[32, 32], embed_dim=64)
    p.update(train_scale=[32, 32], test_scale=[32, 32], **TINY, **over)
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(p))
    return path


def _cli(trees, exp, *extra):
    _, env = trees
    return cli.main(["--config_env", str(env), "--config_exp", str(exp),
                     "--device", "cpu", "--moe_eval_capacity_factor",
                     "nodrop", *extra])


def test_cli_eval_matches_jax_evaluate_online(trees, tmp_path):
    """--eval on a checkpoint of the tiny JAX model's weights (the port's
    seeded init carried into a flax tree by the JAX package's reference
    converter, with seeded BN running statistics, and back by
    jax_variables_to_state_dict): the JAX evaluate_online results with
    the JAX eval step (one program, at XLA's lowest CPU optimisation
    level) on the same val tree, to 1e-4 relative."""
    exp = _tiny_exp(tmp_path)
    _, env = trees
    args = {"moe_eval_capacity_factor": "nodrop", "run_name": "jax_eval"}
    p = create_config(str(env), str(exp), {
        **args, "moe_eval_capacity_factor": parse_capacity_factor("nodrop")})
    jp = jax_create_config(str(env), str(exp), {
        **args, "moe_eval_capacity_factor": jax_parse_cf("nodrop")})
    names = list(p["TASK_NAMES"])
    model, _ = build_model(p, device="cpu", seed=2)
    rng = np.random.RandomState(2)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        v = v.numpy().copy()
        if k.endswith("running_mean"):
            v = (rng.randn(*v.shape) * 0.2).astype(np.float32)
        elif k.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        sd[k] = v
    params, stats = reference_mtl_sd_to_params(sd, names,
                                               multi_gate_tasks=len(names))
    variables = {"params": params, "batch_stats": stats}
    model.load_state_dict(jax_variables_to_state_dict(variables, names,
                                                      len(names)))
    ckpt.save_checkpoint(p["checkpoint_dir"], 0, model)
    got = _cli(trees, exp, "--eval", "--run_name", "jax_eval")

    jmodel = jax_build_model(jp)

    def jeval(state, batch):
        pred, _, st = jmodel.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            batch["image"], train=False)
        return pred, st

    jitted = jax.jit(jeval, compiler_options=FAST_COMPILE)
    state = TrainState.create(apply_fn=jmodel.apply, params=params,
                              tx=optax.identity(),
                              batch_stats=stats)
    ts = jax_transforms(jp)[1]
    ds = jloader.get_dataset(jp, "val", None)
    batches = [jloader.collate([ts(ds[j]) for j in (2 * i, 2 * i + 1)])
               for i in range(2)]
    ref = jorch.evaluate_online(
        jp, lambda s, b: jitted(s, {"image": jnp.asarray(b["image"])}),
        state, batches)
    _assert_results_close({k: got[k] for k in ref}, ref, 1e-4)


@pytest.fixture(scope="module")
def full_run(trees, tmp_path_factory):
    """The tiny config's uninterrupted CLI run (two epochs of two steps)."""
    exp = _tiny_exp(tmp_path_factory.mktemp("full"))
    return exp, _cli(trees, exp, "--run_name", "full")


def test_cli_stop_and_resume_is_bitwise(trees, full_run):
    """A run stopped by --stop_after_steps mid-epoch and then --resume'd
    ends with the uninterrupted run's weights, BN statistics, optimizer
    state and step counter, bit for bit (gate noise on)."""
    exp, full = full_run
    stop = _cli(trees, exp, "--run_name", "split", "--stop_after_steps", "3")
    assert stop["stopped_at_step"] == 3 and stop["steps_run"] == 3
    rest = _cli(trees, exp, "--run_name", "split", "--resume")
    assert rest["steps_run"] == 1 and full["steps_run"] == 4
    a, b = full["state"], rest["state"]
    assert a["train_step"].step == b["train_step"].step == 4
    for k, v in a["model"].state_dict().items():
        assert torch.equal(v, b["model"].state_dict()[k]), k
    sa, sb = a["optimizer"].state_dict(), b["optimizer"].state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k])


def test_cli_ln_mlp_step_runs(trees, tmp_path):
    """--use_pallas_ln_mlp trains through the fused dense sublayer."""
    exp = _tiny_exp(tmp_path)
    out = _cli(trees, exp, "--run_name", "ln_mlp", "--use_pallas_ln_mlp",
               "--stop_after_steps", "1")
    assert out["stopped_at_step"] == 1
    model = out["state"]["model"]
    assert all(b.ln_mlp for b in model.backbone.blocks[::2])
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_cli_synthetic_batches(trees, tmp_path):
    """--synthetic N trains on N batches an epoch made from seeds, and
    evaluates on synthetic ones, with no dataset read."""
    exp = _tiny_exp(tmp_path)
    out = _cli(trees, exp, "--run_name", "synthetic", "--synthetic", "2",
               "--epochs", "1")
    assert out["steps_run"] == 2
    assert set(out["best"]) >= {"semseg", "sal", "normals"}


def test_cli_needs_cuda_by_default(trees, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, env = trees
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--config_env", str(env), "--config_exp",
                  str(_tiny_exp(tmp_path))])


@pytest.mark.parametrize("flag,takes_value", [
    (f, v) for f, v, _ in cli.UNPORTED], ids=[f for f, _, _ in cli.UNPORTED])
def test_cli_refuses_unported_flags(trees, tmp_path, flag, takes_value):
    """Every flag of a feature the port lacks raises NotImplementedError,
    naming what ports it."""
    _, env = trees
    argv = ["--config_env", str(env), "--config_exp", str(HEADLINE),
            "--device", "cpu", flag] + (["1"] if takes_value else [])
    with pytest.raises(NotImplementedError, match=flag):
        cli.main(argv)


def _shrunk_exp(tmp_path, config, **over):
    """A config of the repo shrunk to img 32, embed 64, depth 2, 4 heads,
    E=4, K=2, f32 and its first two tasks' kind (semseg, sal)."""
    p = yaml.safe_load((ROOT / config).read_text())
    p["backbone_kwargs"].update(img_size=[32, 32], embed_dim=64, depth=2,
                                num_heads=4)
    p["head_kwargs"].update(img_size=[32, 32], embed_dim=64)
    p["task_dictionary"] = {"include_semseg": True, "include_sal": True}
    p["loss_kwargs"]["loss_weights"] = {"semseg": 1.0, "sal": 5.0}
    p.update(train_scale=[32, 32], test_scale=[32, 32], **TINY, **over)
    path = tmp_path / "shrunk.yml"
    path.write_text(yaml.safe_dump(p))
    return path


TOKEN_CONFIG = "configs/pascal/token_moe/pup_moe_vit_small_multi_task_baseline.yml"
ONEHOT_CONFIG = ("configs/pascal/vit_moe/"
                 "pup_moe_vit_small_multi_task_baseline_onehot.yml")


@pytest.mark.parametrize("flag,value", [
    ("--share_gamma", "0.7"), ("--bootstrap_share_gamma", "0.2"),
    ("--bootstrap_first_moe", "false"), ("--gate_task_specific_dim", "8"),
    ("--task_one_hot", None)])
def test_cli_takes_the_token_and_conditioning_flags(trees, tmp_path, flag,
                                                    value):
    """The five flags ported with the token variant and the
    task-conditioned router are taken and act: the token model's
    thresholds, the task feature's width (and with it the shared
    router's input), and --task_one_hot trains one task a pass."""
    config = ONEHOT_CONFIG if flag in ("--gate_task_specific_dim",
                                       "--task_one_hot") else TOKEN_CONFIG
    _, env = trees
    out = cli.main(["--config_env", str(env), "--config_exp",
                    str(_shrunk_exp(tmp_path, config)), "--device", "cpu",
                    "--synthetic", "1", "--epochs", "0", flag]
                   + ([value] if value else []))
    model = out["state"]["model"]
    bb = model.backbone
    if flag == "--share_gamma":
        assert bb.share_gamma == 0.7
    elif flag == "--bootstrap_share_gamma":
        assert bb.bootstrap_share_gamma == 0.2 and bb.bootstrap_first_moe
    elif flag == "--bootstrap_first_moe":
        assert bb.bootstrap_first_moe is False
    elif flag == "--gate_task_specific_dim":
        assert bb.gate_task_represent.fc2.out_features == 8
        assert bb.blocks[1].mlp.gate.w_gate.shape[0] == 64 + 8
    else:
        assert model.multi_gate and bb.gate_task_represent is not None
        assert out["state"]["train_step"].__name__ == "one_by_one_step"


def test_cli_trains_the_token_model_on_its_temperature_schedule(
        trees, tmp_path):
    """The token config through the CLI on the PASCAL tree, two epochs:
    the shareability temperature goes from the schedule's start to its
    end (its warm-up cut with the epochs), the steps train the token
    model, and the no-drop evaluation reads its MoE statistics."""
    exp = _shrunk_exp(tmp_path, TOKEN_CONFIG,
                      share_pred_temp_warmup_epochs=0)
    out = _cli(trees, exp, "--run_name", "token", "--epochs", "2")
    assert out["share_temps"] == {0: 1.5, 1: 0.5}
    assert out["steps_run"] == 2 * (N_IMAGES // 2)
    assert isinstance(out["state"]["model"], TokenMultiTaskModel)
    assert set(out["best"]) >= {"semseg", "sal"}


def test_cli_parallel_world_of_one_matches_one_process(trees, full_run):
    """--n_data 1 --n_expert 1 --a2a_chunks 2 without torchrun: a Gloo
    world of one rank, the exchange path, SyncBN, the gradient
    all-reduces and the gathered checkpoints; stopped after 2 steps and
    --resume'd, it ends where the one-process run ends (1e-5: the
    statistics summed in another order) and leaves the process group."""
    import torch.distributed as dist

    exp, solo = full_run
    mesh = ("--n_data", "1", "--n_expert", "1", "--a2a_chunks", "2")
    stop = _cli(trees, exp, "--run_name", "pg", *mesh,
                "--stop_after_steps", "2")
    assert stop["stopped_at_step"] == 2 and not dist.is_initialized()
    mlp = stop["state"]["model"].backbone.blocks[1].mlp
    assert mlp.layout is stop["state"]["layout"] and mlp.a2a_chunks == 2
    rest = _cli(trees, exp, "--run_name", "pg", *mesh, "--resume")
    assert rest["steps_run"] == solo["steps_run"] - 2
    ref = solo["state"]["model"].state_dict()
    for k, v in rest["state"]["model"].state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(ref[k]), k
            continue
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_cli_one_by_one_with_accumulation(trees, tmp_path):
    """--one_by_one with accumulation_steps 2: four one-by-one calls make
    two optimizer steps (the schedule counts optimizer steps)."""
    exp = _tiny_exp(tmp_path, accumulation_steps=2)
    out = _cli(trees, exp, "--run_name", "obo", "--one_by_one",
               "--stop_after_steps", "4")
    assert out["stopped_at_step"] == 4
    step, opt = out["state"]["train_step"], out["state"]["optimizer"]
    assert step.step == 4
    assert all(torch.isfinite(p).all()
               for p in out["state"]["model"].parameters())
    assert {len(st) for st in opt.state_dict()["state"].values()} == {1}


def test_cli_tracing_flags(trees, tmp_path):
    """--forward_hook writes every layer's summary (the port's module
    paths) to <output_dir>/forward_hook.log; --flops and --time report a
    forward on one image (flops_of's count) and end the run;
    --profile_dir writes a torch.profiler trace of the first steps."""
    import json

    from m3vit_tpu_torch.utils.tracing import flops_of, load_trace

    exp = _tiny_exp(tmp_path)
    out = _cli(trees, exp, "--run_name", "trace", "--forward_hook",
               "--flops", "--time")
    assert out["steps_run"] == 0 and out["forward_ms"] > 0
    traces = load_trace(out["forward_hook"])
    assert {"backbone.patch_embed", "backbone.blocks.1.mlp",
            "decoders.semseg.conv_0",
            "decoders.semseg.syncbn_fc_0"} <= set(traces)
    assert traces["decoders.semseg.conv_0"]["shape"][-1] == 256
    model = out["state"]["model"].eval()
    with torch.no_grad():
        assert out["flops"] == flops_of(
            lambda: model(torch.zeros(1, 3, 32, 32)))
    prof = tmp_path / "prof"
    run = _cli(trees, exp, "--run_name", "prof", "--profile_dir", str(prof),
               "--stop_after_steps", "3")
    assert run["stopped_at_step"] == 3
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
