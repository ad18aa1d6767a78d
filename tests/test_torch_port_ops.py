"""The port's kernel modules against the JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as the JAX package's own CPU tests
run them.  Both sides get the same numpy inputs, in f32; the tolerance
2e-5 is the JAX package's own f32 kernel tolerance
(tests/test_pallas_ffn.py).  tests/test_torch_port_kernels.py holds the
hand-written kernels against these plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from m3vit_tpu.ops.expert_ffn import fused_dense_mlp as jax_dense_mlp
from m3vit_tpu.ops.expert_ffn import fused_expert_ffn as jax_expert_ffn
from m3vit_tpu.ops.flash_attention import flash_attention_qkv as jax_flash
from m3vit_tpu_torch.ops.expert_ffn import (
    BWD_KSTEP,
    bwd_plan,
    expert_ffn_fwd,
    expert_ffn_q_dequant,
    expert_ffn_q_fwd,
    fused_dense_mlp,
    fused_expert_ffn,
)
from m3vit_tpu_torch.ops.flash_attention import (
    flash_attention_fwd,
    flash_attention_qkv,
)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tests, restored afterwards
    (a process-wide setting: left in place it would slow every later test
    file of the same worker)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("valid_len", [None, 50])
def test_flash_attention_matches_jax(valid_len):
    B, N, C, H = 2, 65, 128, 2   # N=65: no tile multiple
    scale = (C // H) ** -0.5
    qkv = np.random.RandomState(0).randn(B, N, 3 * C).astype(np.float32)
    ref = np.asarray(jax_flash(jnp.asarray(qkv), H, scale, True, valid_len))
    got = flash_attention_qkv(torch.from_numpy(qkv), H, scale, valid_len)
    assert got.shape == (B, N, C)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def _ffn_inputs(rng, E, C, d, H):
    h = rng.randn(E, C, d).astype(np.float32)
    w1 = (rng.randn(E, d, H) * 0.1).astype(np.float32)   # JAX [E, in, out]
    b1 = (rng.randn(E, H) * 0.1).astype(np.float32)
    w2 = (rng.randn(E, H, d) * 0.1).astype(np.float32)
    b2 = (rng.randn(E, d) * 0.1).astype(np.float32)
    return h, w1, b1, w2, b2


# the model widths the port's FFN kernels take (d 128 and 384 in the
# flagships, 192 in ViT-tiny, 768 in ViT-base, 1024 in ViT-large), at small
# token counts and hidden sizes
FFN_WIDTHS = [(4, 40, 128, 256), (2, 24, 192, 128), (2, 24, 768, 128),
              (2, 24, 1024, 128)]


@pytest.mark.parametrize("E,C,d,H", FFN_WIDTHS,
                         ids=[f"d{c[2]}" for c in FFN_WIDTHS])
def test_fused_expert_ffn_matches_jax(E, C, d, H):
    h, w1, b1, w2, b2 = _ffn_inputs(np.random.RandomState(1), E, C, d, H)
    ref = np.asarray(jax_expert_ffn(*map(jnp.asarray, (h, w1, b1, w2, b2)),
                                    True))
    t = torch.from_numpy
    got = fused_expert_ffn(t(h), t(w1).transpose(1, 2), t(b1),
                           t(w2).transpose(1, 2), t(b2))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("E,C,d,H", FFN_WIDTHS,
                         ids=[f"d{c[2]}" for c in FFN_WIDTHS])
def test_fused_dense_mlp_matches_jax(E, C, d, H):
    rng = np.random.RandomState(2)
    h, w1, b1, w2, b2 = _ffn_inputs(rng, 1, C, d, H)
    x = h.reshape(2, C // 2, d)
    ref = np.asarray(jax_dense_mlp(jnp.asarray(x), jnp.asarray(w1[0]),
                                   jnp.asarray(b1[0]), jnp.asarray(w2[0]),
                                   jnp.asarray(b2[0]), interpret=True))
    t = torch.from_numpy
    got = fused_dense_mlp(t(x), t(w1[0]).T, t(b1[0]), t(w2[0]).T, t(b2[0]))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_kernel_entry_points_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(torch.zeros(1, 8, 3 * 128, dtype=torch.bfloat16),
                            2, 0.125)
    z = torch.zeros(1, 8, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_fwd(z, torch.zeros(1, 64, 128), torch.zeros(1, 64),
                       torch.zeros(1, 128, 64), torch.zeros(1, 128))
    q1, q2 = (torch.zeros(sh, dtype=torch.int8)
              for sh in ((1, 64, 128), (1, 128, 64)))
    s1, s2 = torch.ones(1, 64), torch.ones(1, 128)
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_q_fwd(z, q1, s1, torch.zeros(1, 64), q2, s2,
                         torch.zeros(1, 128))
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_q_dequant(q1, s1, q2, s2)


# (E, Ct, d, Hd): the flagship's expert banks at the train capacity and its
# dense MLP (both launched per train step), and the cuda tests' shapes
BWD_PLAN_SHAPES = [(16, 2568, 384, 384), (1, 8200, 384, 1536),
                   (16, 520, 384, 384), (1, 1000, 384, 1536),
                   (3, 77, 128, 256), (1, 77, 128, 256), (2, 4104, 128, 64)]
FLAGSHIP_BWD = BWD_PLAN_SHAPES[:2]


@pytest.mark.parametrize("E,Ct,d,Hd", BWD_PLAN_SHAPES)
def test_bwd_plan_covers_every_token_step_once(E, Ct, d, Hd):
    sms = 132
    plan = bwd_plan(E, Ct, d, Hd, sms)
    ks, n = plan.splits, -(-Ct // BWD_KSTEP)
    assert 1 <= ks <= n
    # split s reduces over k-steps [n s // ks, n (s + 1) // ks)
    steps = [(n * s // ks, n * (s + 1) // ks) for s in range(ks)]
    assert [k for b, e in steps for k in range(b, e)] == list(range(n))
    assert all(e > b for b, e in steps)   # no empty split
    # every launch is persistent: min(tiles, SMs) CTAs, none without a tile
    assert plan.grids == tuple(min(t, sms) for t in plan.tiles)
    assert all(g >= 1 for g in plan.grids)
    one = bwd_plan(E, Ct, d, Hd, sms, splits=1)
    assert plan.tiles[:2] == one.tiles[:2]
    assert plan.tiles[2] == ks * one.tiles[2]
    # the most splits that keep the weight launch within one wave
    assert ks == 1 or plan.tiles[2] <= sms
    assert ks == n or (ks + 1) * one.tiles[2] > sms
    if (E, Ct, d, Hd) in FLAGSHIP_BWD:
        # the hidden pass, half of a call's time, fills every SM many times
        assert plan.tiles[0] >= 10 * sms
