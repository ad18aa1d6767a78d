"""The port's gating and dispatch against the JAX package's (CPU, f32).

Routing decisions and dispatch plans must be bitwise equal; outputs agree
to 2e-5, the JAX package's f32 tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from m3vit_tpu.moe import dispatch as jdisp
from m3vit_tpu.moe import gating as jgate
from m3vit_tpu_torch.moe import dispatch as tdisp
from m3vit_tpu_torch.moe import gating as tgate


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tests, restored afterwards
    (a process-wide setting: left in place it would slow every later test
    file of the same worker)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_small_topk_ties_match_jax():
    # rows full of ties: the lower index must come first, as in JAX
    x = np.array([
        [0.1, 0.3, 0.3, 0.1, 0.3, 0.0, 0.2, 0.2],
        [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
        [0.0, 0.0, 0.9, 0.0, 0.9, 0.0, 0.0, 0.1],
        [0.2, 0.1, 0.2, 0.1, 0.2, 0.1, 0.2, 0.1],
    ], np.float32)
    for m in (1, 3, 5):
        jv, ji = jgate.small_topk(jnp.asarray(x), m)
        tv, ti = tgate.small_topk(torch.from_numpy(x), m)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_noisy_vmoe_gate_eval_matches_jax():
    rng = np.random.RandomState(0)
    inp = rng.randn(200, 32).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (32, 16)).astype(np.float32)
    jg = jgate.noisy_vmoe_gate(jnp.asarray(inp), jnp.asarray(w), top_k=4,
                               noise_std=1.0, train=False)
    tg = tgate.noisy_vmoe_gate(torch.from_numpy(inp), torch.from_numpy(w),
                               top_k=4)
    np.testing.assert_array_equal(tg.top_k_indices.numpy(),
                                  np.asarray(jg.top_k_indices))
    np.testing.assert_allclose(tg.top_k_gates.numpy(),
                               np.asarray(jg.top_k_gates), atol=1e-6)
    np.testing.assert_allclose(tg.top_logits.numpy(),
                               np.asarray(jg.top_logits), atol=1e-6)


@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0, 4.0, tdisp.NO_DROP])
def test_compute_capacity_matches_jax(cf):
    for T, K, E in ((8200, 4, 16), (17, 2, 4), (1025, 1, 8), (3, 4, 16)):
        assert tdisp.compute_capacity(T, K, E, cf) == \
            jdisp.compute_capacity(T, K, E, cf)


@pytest.mark.parametrize("E,C,seed", [(4, 8, 0), (8, 16, 1), (16, 40, 2)])
def test_dispatch_plan_bitwise(E, C, seed):
    """Over-capacity experts (ids skewed toward 0) and masked ids >= E."""
    rng = np.random.RandomState(seed)
    S = 160
    ids = rng.randint(0, E, S)
    ids[rng.rand(S) < 0.3] = 0          # expert 0 overflows its capacity
    ids[rng.rand(S) < 0.1] = E          # masked
    ids[rng.rand(S) < 0.05] = E + 3     # masked, beyond E
    w = rng.rand(S).astype(np.float32)
    jp = jdisp.make_dispatch_plan(jnp.asarray(ids, jnp.int32), E, C,
                                  jnp.asarray(w))
    tp = tdisp.make_dispatch_plan(torch.from_numpy(ids), E, C,
                                  torch.from_numpy(w))
    assert (np.asarray(jp.dst) == E * C).any()   # something was dropped
    np.testing.assert_array_equal(tp.src_flat.numpy(), np.asarray(jp.src_flat))
    np.testing.assert_array_equal(tp.w_slot.numpy(), np.asarray(jp.w_slot))
    np.testing.assert_array_equal(tp.dst.numpy(), np.asarray(jp.dst))


def test_moe_ffn_local_matches_jax():
    rng = np.random.RandomState(3)
    T, d, H, E, K = 96, 128, 64, 4, 2
    x = rng.randn(T, d).astype(np.float32)
    idx = rng.randint(0, E, (T, K)).astype(np.int32)
    idx[:, 1] = (idx[:, 0] + 1 + rng.randint(0, E - 1, T)) % E  # distinct
    gates = rng.rand(T, K).astype(np.float32)
    w1 = (rng.randn(E, d, H) * 0.1).astype(np.float32)
    b1 = (rng.randn(E, H) * 0.1).astype(np.float32)
    w2 = (rng.randn(E, H, d) * 0.1).astype(np.float32)
    b2 = (rng.randn(E, d) * 0.1).astype(np.float32)
    cap = 40   # < the busiest expert's load: drops are exercised
    ref = jdisp.moe_ffn_local(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates),
        jdisp.MoEFfnParams(*map(jnp.asarray, (w1, b1, w2, b2))),
        capacity=cap, compute_dtype=jnp.float32)
    t = torch.from_numpy
    got = tdisp.moe_ffn_local(
        t(x), t(idx), t(gates),
        tdisp.MoEFfnParams(t(w1).transpose(1, 2), t(b1),
                           t(w2).transpose(1, 2), t(b2)), capacity=cap)
    assert np.bincount(idx.reshape(-1)).max() > cap
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_gate_noise_is_an_input():
    """Given noise n, the gate routes on clean + n * noise_std / E: the JAX
    gate fed those logits (no noise of its own) routes the same way."""
    rng = np.random.RandomState(4)
    inp = rng.randn(64, 32).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (32, 16)).astype(np.float32)
    noise = rng.randn(64, 16).astype(np.float32)
    tg = tgate.noisy_vmoe_gate(torch.from_numpy(inp), torch.from_numpy(w),
                               top_k=4, noise_std=2.0,
                               noise=torch.from_numpy(noise))
    jg = jgate.noisy_vmoe_gate(
        None, jnp.asarray(w), top_k=4, noise_std=2.0, train=False,
        clean_logits=jnp.asarray(inp @ w + noise * 2.0 / 16))
    np.testing.assert_array_equal(tg.top_k_indices.numpy(),
                                  np.asarray(jg.top_k_indices))
    np.testing.assert_allclose(tg.top_k_gates.numpy(),
                               np.asarray(jg.top_k_gates), atol=1e-6)
    assert tg.noise_stddev.item() == pytest.approx(2.0 / 16)


def test_expert_ffn_dense_matches_jax():
    rng = np.random.RandomState(5)
    E, C, d, H = 3, 24, 16, 32
    h = rng.randn(E, C, d).astype(np.float32)
    w1, b1, w2, b2 = ((rng.randn(*s) * 0.1).astype(np.float32)
                      for s in ((E, d, H), (E, H), (E, H, d), (E, d)))
    ref = jdisp.expert_ffn_dense(
        jnp.asarray(h), jdisp.MoEFfnParams(*map(jnp.asarray, (w1, b1, w2, b2))),
        compute_dtype=jnp.float32)
    t = torch.from_numpy
    got = tdisp.expert_ffn_dense(
        t(h), tdisp.MoEFfnParams(t(w1).transpose(1, 2), t(b1),
                                 t(w2).transpose(1, 2), t(b2)),
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
