"""The port's flagship-shaped model and serving session against the JAX
package's, on the same weights (CPU, f32).

A tiny flagship (img 64, patch 16, embed 128, depth 4, 2 heads, E=4, K=2,
expert hidden 128, three tasks) is initialised in JAX from a seed, its BN
running statistics set to seeded non-trivial values, carried across with
``jax_variables_to_state_dict`` and strict-loaded into the port.  The JAX
model runs its plain paths on the CPU (no Pallas), as its own tests do.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import build_flagship as jax_build_flagship
from m3vit_tpu.serve import InferenceSession as JaxSession
from m3vit_tpu.tasks import parse_task_dictionary as jax_parse
from m3vit_tpu.utils.torch_interop import params_to_reference_sd
from m3vit_tpu_torch.models import build_flagship
from m3vit_tpu_torch.serve import InferenceSession
from m3vit_tpu_torch.tasks import parse_task_dictionary
from m3vit_tpu_torch.utils.convert import jax_variables_to_state_dict


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tests, restored afterwards
    (a process-wide setting: left in place it would slow every later test
    file of the same worker)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


IMG = 64
TASK_DICT = {"include_semseg": True, "include_sal": True,
             "include_normals": True}
ARCH = dict(img=IMG, embed=128, depth=4, heads=2, experts=4, top_k=2)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def pair():
    jtasks = jax_parse("PASCALContext", TASK_DICT)[0]
    jmodel, _ = jax_build_flagship(tasks=jtasks, dtype=jnp.float32,
                                   use_checkpointing=False, **ARCH)
    img = jnp.zeros((2, IMG, IMG, 3), jnp.float32)
    variables = _np_tree(jax.jit(
        lambda r: jmodel.init({"params": r}, img, train=False))(
            jax.random.key(0)))
    rng = np.random.RandomState(0)
    for head in variables["batch_stats"].values():
        for bn in head.values():
            bn["mean"] = rng.randn(*bn["mean"].shape).astype(np.float32) * 0.2
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    tasks = parse_task_dictionary("PASCALContext", TASK_DICT)[0]
    model, _ = build_flagship(tasks=tasks, dtype=torch.float32, device="cpu",
                              **ARCH)
    sd = jax_variables_to_state_dict(variables, tasks, len(tasks))
    model.load_state_dict(sd, strict=True)
    return jmodel, variables, model, [t.name for t in tasks]


def test_state_dict_keys_match_reference_export(pair):
    _, variables, model, names = pair
    sd = jax_variables_to_state_dict(variables, names, len(names))
    ref = params_to_reference_sd(variables["params"],
                                 variables["batch_stats"], names, len(names))
    ours = {k: v for k, v in sd.items() if "num_batches_tracked" not in k}
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert set(sd) == set(model.state_dict())


@pytest.fixture(scope="module")
def jax_outputs(pair):
    """Every task's single-task output and the multi-gate eval, from one
    jitted JAX program (one compile instead of op-by-op dispatch)."""
    jmodel, variables, _, names = pair
    x = np.random.RandomState(1).randn(2, IMG, IMG, 3).astype(np.float32)

    def run(v, x):
        single = {t: jmodel.apply(v, x, train=False, single_task=t)[0][t]
                  for t in names}
        multi, _, stats = jmodel.apply(v, x, train=False)
        return single, multi, stats

    return x, _np_tree(jax.jit(run)(variables, x))


def _port(model, x, **kw):
    with torch.inference_mode():
        pred, _, stats = model(torch.from_numpy(x).permute(0, 3, 1, 2), **kw)
    return {k: v.permute(0, 2, 3, 1).numpy() for k, v in pred.items()}, stats


def test_single_task_outputs_match_jax(pair, jax_outputs):
    _, _, model, names = pair
    x, (ref, _, _) = jax_outputs
    for task in names:
        got, _ = _port(model, x, single_task=task)
        assert set(got) == {task}
        np.testing.assert_allclose(got[task], ref[task], atol=1e-4,
                                   err_msg=task)


def test_multi_task_eval_matches_jax(pair, jax_outputs):
    _, _, model, names = pair
    x, (_, ref, jstats) = jax_outputs
    got, stats = _port(model, x)
    assert set(got) == set(names)
    for task in names:
        np.testing.assert_allclose(got[task], ref[task], atol=1e-4,
                                   err_msg=task)
    np.testing.assert_allclose(stats["dropped_slot_fraction"].item(),
                               float(jstats["dropped_slot_fraction"]),
                               atol=1e-7)
    assert stats["moe_stat_count"].item() == float(jstats["moe_stat_count"])


def test_session_matches_jax_session(pair):
    """Bucket padding (3 images -> bucket 4), uint8 input, postprocess."""
    jmodel, variables, model, names = pair
    img = np.random.RandomState(3).randint(0, 256, (3, IMG, IMG, 3)).astype(
        np.uint8)
    kw = dict(img_size=(IMG, IMG), buckets=(1, 2, 4), raw_uint8_input=True)
    jsess = JaxSession(jmodel, variables, names, **kw)
    sess = InferenceSession(model, names, device="cpu", **kw)
    for task in ("semseg", "normals"):
        ref = jsess.predict(img, task, postprocess=True)
        got = sess.predict(img, task, postprocess=True)
        assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
        if task == "semseg":
            assert (got == ref).mean() >= 0.999
        else:
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    logits = sess.predict(img[:1], "semseg")
    assert logits.shape == (1, IMG, IMG, 21) and logits.dtype == np.float32
