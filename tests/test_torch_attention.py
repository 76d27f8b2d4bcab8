"""The port's rel-pos attention against the JAX package: the plain
version of the CUDA kernels against JAX's fused Pallas kernels
(interpret mode) and its jnp oracle, forward and gradients, and
``RelPosMHAXL`` on both sides of the JAX module's 128-frame gate. f32 on
both sides: 2e-5 for the op, as the JAX package's own kernel test uses,
3e-5 after the projections, 1e-4 for gradients. The dropout mask is the
port's own Philox draw (the TPU's bits cannot be reproduced), so its
tests check determinism, independence and the keep rate, and that the
forward and the backward apply one mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsasr_tpu.models import attention as jax_attention
from tsasr_tpu.ops.attention_pallas import (
    fused_relpos_attention as jax_fused,
    relpos_attention_reference as jax_reference,
)
from tsasr_torch.kernels import relpos_attention
from tsasr_torch.models.attention import RelPosMHAXL, rel_pos_encoding

SCALE = 0.125


def make_case(rng, B=2, H=3, T=10, Dh=5, masked=True):
    """The cases of tests/test_attention_pallas.py, as numpy arrays."""
    qu, qv, k, v = (rng.normal(size=(B, H, T, Dh)).astype(np.float32)
                    for _ in range(4))
    p = rng.normal(size=(H, 2 * T - 1, Dh)).astype(np.float32)
    if masked:
        lens = np.array([T, T - 4])[:B]
        kp = np.where(np.arange(T)[None, :] < lens[:, None], 0.0, -1e9)
        am = np.where(np.triu(np.ones((T, T)), 3) > 0, -1e9, 0.0)
    else:
        kp = np.zeros((B, T))
        am = np.zeros((T, T))
    return qu, qv, k, v, p, kp.astype(np.float32), am.astype(np.float32)


@pytest.mark.parametrize("shape,masked", [
    (dict(), False),
    (dict(), True),
    (dict(B=1, H=2, T=37, Dh=12), True),
])
def test_plain_version_matches_jax_kernel_and_oracle(rng, shape, masked):
    args = make_case(rng, masked=masked, **shape)
    got = relpos_attention.relpos_attention_reference(
        *map(torch.from_numpy, args), SCALE).numpy()
    jargs = tuple(map(jnp.asarray, args))
    want_ref = jax_reference(*jargs, SCALE)
    want_kernel = jax_fused(*jargs, jnp.zeros((), jnp.float32), SCALE, 0.0,
                            True)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=2e-5)


def test_wrapper_takes_plain_version_on_cpu(rng):
    args = tuple(map(torch.from_numpy, make_case(rng)))
    before = (relpos_attention.launches, relpos_attention.bwd_launches)
    for rate in (0.0, 0.1):
        got = relpos_attention.fused_relpos_attention(*args, seed=3,
                                                      scale=SCALE, rate=rate)
        want = relpos_attention.relpos_attention_reference(*args, SCALE, 3,
                                                           rate)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (relpos_attention.launches,
            relpos_attention.bwd_launches) == before   # no kernel on the CPU


def test_plain_gradients_match_jax_kernel(rng):
    """Gradients of q_u, q_v, k, v and p at rate 0 against ``jax.grad``
    of the JAX fused kernel (its Pallas backward in interpret mode)."""
    args = make_case(rng)
    cot = rng.normal(size=args[0].shape).astype(np.float32)

    def jax_loss(*xs):
        out = jax_fused(*xs, *map(jnp.asarray, args[5:]),
                        jnp.zeros((), jnp.float32), SCALE, 0.0, True)
        return jnp.sum(out * cot)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, args[:5]))
    leaves = [torch.from_numpy(x).requires_grad_(i < 5)
              for i, x in enumerate(args)]
    out = relpos_attention.fused_relpos_attention(*leaves, seed=0,
                                                  scale=SCALE, rate=0.0)
    out.backward(torch.from_numpy(cot))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-4)


def test_philox_mask_is_deterministic_independent_and_at_rate():
    B, H, T, rate = 2, 3, 60, 0.1
    mask = relpos_attention.philox_keep_mask(7, B, H, T, rate)
    assert torch.equal(mask, relpos_attention.philox_keep_mask(7, B, H, T,
                                                               rate))
    assert not torch.equal(mask, relpos_attention.philox_keep_mask(
        8, B, H, T, rate))
    slices = mask.reshape(B * H, T * T)
    for a in range(B * H):
        for b in range(a):
            assert not torch.equal(slices[a], slices[b])
    n = mask.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(mask.float().mean().item() - (1 - rate)) < 4 * sigma
    # a tensor seed (as the model draws it) gives the same mask
    assert torch.equal(mask, relpos_attention.philox_keep_mask(
        torch.tensor([7]), B, H, T, rate))
    assert relpos_attention.dropout_threshold(rate) == int(0.1 * 2 ** 32)


def test_forward_and_backward_apply_one_mask(rng):
    """Autograd through the plain version at rate 0.2 equals the same
    function with the Philox mask applied by hand."""
    args = [torch.from_numpy(x) for x in make_case(rng)]
    B, H, T, _ = args[0].shape
    rate, seed = 0.2, 11
    cot = torch.from_numpy(rng.normal(size=args[0].shape).astype(np.float32))
    keep = relpos_attention.philox_keep_mask(seed, B, H, T, rate)
    grads = []
    for by_hand in (False, True):
        leaves = [x.clone().requires_grad_(i < 5) for i, x in enumerate(args)]
        if by_hand:
            qu, qv, k, v, p, kp, am = leaves
            ac = torch.einsum("bhtd,bhsd->bhts", qu, k)
            bd = relpos_attention.rel_shift(
                torch.einsum("bhtd,hsd->bhts", qv, p), T)
            probs = torch.softmax((ac + bd) * SCALE + am + kp[:, None, None],
                                  dim=-1)
            out = torch.einsum("bhts,bhsd->bhtd",
                               probs * keep / (1 - rate), v)
        else:
            out = relpos_attention.fused_relpos_attention(
                *leaves, seed=seed, scale=SCALE, rate=rate)
        out.backward(cot)
        grads.append([out.detach()] + [x.grad for x in leaves[:5]])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("T", [1, 9, 40])
def test_rel_shift_and_encoding_match_jax(rng, T):
    x = rng.normal(size=(2, 3, T, 2 * T - 1)).astype(np.float32)
    np.testing.assert_array_equal(
        relpos_attention.rel_shift(torch.from_numpy(x), T).numpy(),
        np.asarray(jax_attention._rel_shift(jnp.asarray(x), klen=T)))
    np.testing.assert_allclose(rel_pos_encoding(T, 16).numpy(),
                               np.asarray(jax_attention.rel_pos_encoding(
                                   T, 16)), atol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("T", [20, 140])
def test_module_matches_jax_around_length_gate(rng, monkeypatch, T, fused):
    """At T=20 the JAX module runs its Pallas kernel (interpret mode), at
    T=140 its length gate sends it to the XLA path; the port's fused
    module takes no gate. Same weights, key padding and a band mask."""
    monkeypatch.setenv("TSASR_ATTN_INTERPRET", "1")
    B, D, H = 2, 16, 4
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    kp = np.arange(T)[None, :] >= np.array([[T], [T - 5]])
    am = np.abs(np.arange(T)[:, None] - np.arange(T)[None, :]) > 6
    pe = jax_attention.rel_pos_encoding(T, D)

    jax_module = jax_attention.RelPosMHAXL(embed_dim=D, num_heads=H,
                                           fused=fused)
    params = jax_module.init(jax.random.PRNGKey(1), jnp.asarray(x), pe)
    want, _ = jax_module.apply(params, jnp.asarray(x), pe,
                               key_padding_mask=jnp.asarray(kp),
                               attn_mask=jnp.asarray(am))

    p = params["params"]
    module = RelPosMHAXL(D, H, fused=fused)
    module.load_state_dict({
        "qkv_proj.weight": torch.tensor(np.asarray(p["qkv_proj"]["kernel"]).T),
        "pos_proj.weight": torch.tensor(np.asarray(p["pos_proj"]["kernel"]).T),
        "pos_bias_u": torch.tensor(np.asarray(p["pos_bias_u"])),
        "pos_bias_v": torch.tensor(np.asarray(p["pos_bias_v"])),
        "out_proj.weight": torch.tensor(np.asarray(p["out_proj"]["kernel"]).T),
        "out_proj.bias": torch.tensor(np.asarray(p["out_proj"]["bias"])),
    })
    with torch.no_grad():
        got, attn = module(torch.from_numpy(x), rel_pos_encoding(T, D),
                           torch.from_numpy(kp), torch.from_numpy(am))
    assert (attn is None) == fused
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
