"""The port's data and expert parallelism (m3vit_tpu_torch/parallel,
moe/dispatch.py:moe_ffn_expert_parallel) on the CPU: one Gloo world of 4
processes, spawned once by a module fixture, runs every distributed check
(tests/torch_port_parallel_worker.py, which imports no JAX); this process
holds what the ranks computed against the JAX package and against the
port's own one-process path.

* The exchange: the port's expert-parallel MoE FFN at (n_data 2, n_expert
  2) for a2a_chunks 1, 2 and 3 (3 falls back to 2 local-expert groups of
  the 4: the non-divisible fallback) against JAX's ``moe_ffn`` on a (2, 2)
  mesh of the conftest's virtual CPU devices, at a capacity factor that
  drops slots: outputs and gradients in x, the gates and the expert banks
  to f32 atol 1e-5.
* One DP x EP train step (2 x 2) and one data-parallel step (4 x 1,
  ``--moe_data_distributed``) of a tiny two-task MoE model, with gate noise
  and no drops, against the port's one-process step on the global batch:
  losses 1e-5 relative, parameters, BN running statistics and momentum
  1e-5; then the eval step's predictions and MoE statistics.
* A checkpoint written at n_expert 2 restored at n_expert 1, and into a
  one-process model.
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from m3vit_tpu.moe import dispatch as jdisp
from m3vit_tpu_torch.data.synthetic import synthetic_batch
from m3vit_tpu_torch.parallel.mesh import free_port
from m3vit_tpu_torch.tasks import parse_task_dictionary
from m3vit_tpu_torch.train.step import make_eval_step
from m3vit_tpu_torch.utils.checkpoint import restore_checkpoint
from tests import torch_port_parallel_worker as W
from tests.jax_fast_compile import FAST_COMPILE

CHUNKS = (1, 2, 3)
SPAWN_TIMEOUT_S = 300
# T 32 a rank, E 8 over 2 expert ranks, K 2, cf 0.5: capacity 8 a
# (source rank, expert) against ~8 routed slots on average, so some drop
T, D, H, E, K, CF = 32, 16, 32, 8, 2, 0.5


def _dispatch_spec():
    rng = np.random.RandomState(11)
    Tg = W.WORLD * T
    return {
        "x": rng.randn(Tg, D).astype(np.float32),
        "idx": rng.randint(0, E, (Tg, K)).astype(np.int64),
        "gates": rng.rand(Tg, K).astype(np.float32),
        "cot": rng.randn(Tg, D).astype(np.float32),
        # port layout [E, out, in]
        "w1": (rng.randn(E, H, D) * 0.1).astype(np.float32),
        "b1": (rng.randn(E, H) * 0.1).astype(np.float32),
        "w2": (rng.randn(E, D, H) * 0.1).astype(np.float32),
        "b2": (rng.randn(E, D) * 0.1).astype(np.float32),
        "cf": CF, "chunks": CHUNKS,
    }


def _global_batch():
    tasks = parse_task_dictionary("PASCALContext", W.TASKS)[0]
    b = synthetic_batch(torch.Generator().manual_seed(4), tasks, W.WORLD,
                        (W.ARCH["img"], W.ARCH["img"]))
    return {k: v.numpy() for k, v in b.items()}


def _jax_dispatch(d):
    """JAX's moe_ffn on a (2, 2) mesh: output and gradients, per chunks."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "expert"))
    params = jdisp.MoEFfnParams(
        w1=jnp.asarray(d["w1"].transpose(0, 2, 1)), b1=jnp.asarray(d["b1"]),
        w2=jnp.asarray(d["w2"].transpose(0, 2, 1)), b2=jnp.asarray(d["b2"]))
    x, gates = jnp.asarray(d["x"]), jnp.asarray(d["gates"])
    idx = jnp.asarray(d["idx"].astype(np.int32))
    cot = jnp.asarray(d["cot"])
    out = {}
    for c in CHUNKS:
        def f(x, gates, params, c=c):
            return jdisp.moe_ffn(x, idx, gates, params, mesh=mesh,
                                 expert_axis="expert", capacity_factor=CF,
                                 compute_dtype=jnp.float32, a2a_chunks=c)

        def loss(x, gates, params, f=f):
            return jnp.sum(f(x, gates, params) * cot)

        y, grads = jax.jit(lambda *a, f=f, loss=loss: (
            f(*a), jax.grad(loss, argnums=(0, 1, 2))(*a)),
            compiler_options=FAST_COMPILE)(x, gates, params)
        out[c] = jax.tree.map(np.asarray, (y, grads))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of one 4-rank Gloo spawn, and JAX's exchange
    (computed here while the ranks run)."""
    out = tmp_path_factory.mktemp("ranks")
    spec = {"dispatch": _dispatch_spec(), "batch": _global_batch(),
            "noise_seed": 7}
    ctx = mp.start_processes(W.run, args=(free_port(), str(out), spec),
                             nprocs=W.WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        jref = _jax_dispatch(spec["dispatch"])
    finally:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                pytest.fail(f"the {W.WORLD} ranks did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    res = [torch.load(out / f"{r}.pt", weights_only=False)
           for r in range(W.WORLD)]
    return spec, res, out, jref


@pytest.fixture(scope="module")
def one_process(ranks):
    """The tiny model's step and eval on the global batch in one process."""
    spec = ranks[0]
    model, names = W.tiny_model()
    opt, step = W.train_step(model, names)
    batch = {k: torch.from_numpy(v) for k, v in spec["batch"].items()}
    metrics = step(batch, torch.Generator().manual_seed(spec["noise_seed"]))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    pred, stats = make_eval_step(model, names, with_stats=True)(
        {"image": batch["image"]})
    return metrics, state, opt.state_dict(), pred, stats


def _rank_rows(a, r):
    n = a.shape[0] // W.WORLD
    return a[r * n:(r + 1) * n]


@pytest.mark.parametrize("chunks", CHUNKS)
def test_expert_parallel_dispatch_matches_jax(ranks, chunks):
    """Each rank's output and gradients against JAX's (2, 2) mesh, at a
    capacity that drops slots; the expert banks' gradients summed over the
    data group (as the step syncs them) against JAX's."""
    spec, res, _, jref = ranks
    y, (dx, dgates, dparams) = jref[chunks]
    cap = jdisp.compute_capacity(T, K, E, CF)
    counts = np.stack([np.bincount(_rank_rows(spec["dispatch"]["idx"], r)
                                   .reshape(-1), minlength=E)
                       for r in range(W.WORLD)])
    assert (counts > cap).any(), "no slot dropped"
    full = [dparams.w1.transpose(0, 2, 1), dparams.b1,
            dparams.w2.transpose(0, 2, 1), dparams.b2]
    for r in range(W.WORLD):
        got = res[r]["dispatch"][chunks]
        for name, a, b in (("y", got["y"], y), ("dx", got["dx"], dx),
                           ("dgates", got["dgates"], dgates)):
            np.testing.assert_allclose(a.numpy(), _rank_rows(b, r),
                                       atol=1e-5, err_msg=f"rank {r} {name}")
        e0 = (r % 2) * (E // 2)
        for i, g in enumerate(got["dbanks"]):
            np.testing.assert_allclose(g.numpy(), full[i][e0:e0 + E // 2],
                                       atol=1e-5, err_msg=f"rank {r} bank {i}")


def _assert_state(got, ref, what):
    assert set(got) == set(ref), what
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(v), f"{what} {k}"
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("layout", ["dpxep", "dp"])
def test_parallel_step_matches_one_process(ranks, one_process, layout):
    """(2, 2) and (4, 1) against one process on the global batch: every
    rank's metrics (the global batch's losses and MoE statistics), the
    one-card state after the step on rank 0 (parameters, BN running
    statistics, momentum), and the eval step's predictions (the ranks'
    rows in order) and statistics."""
    _, res, _, _ = ranks
    metrics, state, osd, pred, stats = one_process
    for r in range(W.WORLD):
        got = res[r][layout]
        assert set(got["metrics"]) == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"rank {r} {k}")
        for k, v in stats.items():
            np.testing.assert_allclose(got["eval_stats"][k].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=f"rank {r} eval {k}")
    assert metrics["loss_cv"] > 0 and float(
        metrics["moe_dropped_frac"]) == 0.0
    _assert_state(res[0][layout]["state"], state, layout)
    got_osd = res[0][layout]["opt"]
    for i, st in osd["state"].items():
        np.testing.assert_allclose(
            got_osd["state"][i]["momentum_buffer"].numpy(),
            st["momentum_buffer"].numpy(), atol=1e-5,
            err_msg=f"{layout} momentum {i}")
    for task, v in pred.items():
        rows = torch.cat([res[r][layout]["pred"][task]
                          for r in range(W.WORLD)])
        np.testing.assert_allclose(rows.numpy(), v.numpy(), atol=1e-5,
                                   err_msg=f"{layout} eval {task}")


def test_checkpoint_restores_at_another_n_expert(ranks):
    """The (2, 2) run's checkpoint (rank 0 wrote the one-card state) loaded
    at n_expert 1 on every rank, and into a one-process model, equals the
    state the (2, 2) ranks gathered: weights, statistics and momentum."""
    _, res, out, _ = ranks
    ref_sd, ref_osd = res[0]["dpxep"]["state"], res[0]["dpxep"]["opt"]
    for r in range(W.WORLD):
        sd, osd = res[r]["restored"]["state"]
        assert res[r]["restored"]["meta"]["train_step_calls"] == 1
        _assert_state(sd, ref_sd, f"rank {r}")
        for i, st in ref_osd["state"].items():
            torch.testing.assert_close(osd["state"][i]["momentum_buffer"],
                                       st["momentum_buffer"], rtol=0, atol=0)
    model, names = W.tiny_model()
    opt, _ = W.train_step(model, names)
    assert restore_checkpoint(str(out / "ckpt"), model, opt) is not None
    _assert_state(model.state_dict(), ref_sd, "one process")


def test_dropout_masks_are_the_global_batchs_rows():
    """Under a layout of 2 ranks, a rank's dropout and drop-path masks are
    its rows of the mask one process draws for the global batch, along
    the batch's dim (dim 1 for the dense MLP's [1, B*N, d] tokens); an
    expert buffer's (no batch dim) is drawn as one process draws it."""
    from m3vit_tpu_torch import parallel
    from m3vit_tpu_torch.ops.dropout import _rank_mask, drop_path

    def gen():
        return torch.Generator().manual_seed(3)

    x = torch.ones(2, 5, 4)
    ref = _rank_mask((4, 5, 4), 0.5, gen(), "cpu")
    ref_tok = _rank_mask((1, 20, 4), 0.5, gen(), "cpu")
    ref_path = drop_path(torch.ones(4, 1, 1), 0.5, gen())
    own = _rank_mask((2, 5, 4), 0.5, gen(), "cpu", None)
    try:
        parallel.set_layout(parallel.Layout(2, 1, 1, torch.device("cpu"),
                                            None, None))
        torch.testing.assert_close(_rank_mask(x.shape, 0.5, gen(), "cpu"),
                                   ref[2:], rtol=0, atol=0)
        torch.testing.assert_close(_rank_mask((1, 10, 4), 0.5, gen(), "cpu", 1),
                                   ref_tok[:, 10:], rtol=0, atol=0)
        torch.testing.assert_close(drop_path(torch.ones(2, 1, 1), 0.5,
                                             gen()), ref_path[2:],
                                   rtol=0, atol=0)
        torch.testing.assert_close(_rank_mask((2, 5, 4), 0.5, gen(), "cpu", None),
                                   own, rtol=0, atol=0)
    finally:
        parallel.set_layout(None)
