"""The port's RNN-T lattice and losses against the JAX package on the same
numpy inputs, and against the port's own per-cell oracle.

The lattice's plain version (what the CUDA kernels compute, and what the
wrapper runs on the CPU) is held against the JAX Pallas kernels in
interpret mode, both variants, as the JAX package's own tests run them,
and against its XLA wavefront solver. All f32: the row scans and the
wavefront sum in different orders, so 1e-4 abs and rel."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsasr_tpu.ops.rnnt_loss_pallas import _pallas_lattice
from tsasr_torch.kernels import rnnt_lattice
from tsasr_torch.ops.rnnt_loss import (_gather_label_blank_logprobs,
                                       rnnt_loss, rnnt_loss_reference,
                                       transducer_loss)
from tsasr_torch.ops.rnnt_loss_fused import rnnt_loss_fused

# the JAX ops package re-exports functions under its modules' names
jax_rnnt = importlib.import_module("tsasr_tpu.ops.rnnt_loss")
jax_fused = importlib.import_module("tsasr_tpu.ops.rnnt_loss_fused")
TOL = dict(atol=1e-4, rtol=1e-4)


def _problem(seed, B=4, T=19, U=5, V=7):
    """Ragged lengths with a label length of 0, an utterance of one frame
    and T not a multiple of the JAX slab height."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, U + 1, V)).astype(np.float32)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    t_lens = np.array([T, 1, T - 5, 11][:B], np.int32)
    u_lens = np.array([U, 0, U - 2, 3][:B], np.int32)
    return logits, labels, t_lens, u_lens


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def lattices():
    logits, labels, t_lens, u_lens = _problem(0)
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    lpb, lpl = jax_rnnt._gather_label_blank_logprobs(lp, jnp.asarray(labels),
                                                     0)
    ours = rnnt_lattice.rnnt_lattice(
        torch.tensor(np.asarray(lpb)), torch.tensor(np.asarray(lpl)),
        torch.from_numpy(t_lens), torch.from_numpy(u_lens))
    return (lpb, lpl, jnp.asarray(t_lens), jnp.asarray(u_lens)), ours


@pytest.mark.parametrize("solver", ["pallas_resident", "pallas_slab", "xla"])
def test_plain_lattice_matches_jax(lattices, solver):
    (lpb, lpl, tl, ul), ours = lattices
    if solver == "xla":
        want = jax_fused._solve_lattice(lpb, lpl, tl, ul, use_pallas=False)
    else:
        want = _pallas_lattice(lpb, lpl, tl, ul, interpret=True,
                               variant=solver.split("_")[1])
    for got, w in zip(ours, want):
        assert np.isfinite(_np(got)).all()
        np.testing.assert_allclose(_np(got), np.asarray(w), **TOL)


def test_gather_matches_jax(rng):
    logits, labels, _, _ = _problem(1)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    want = jax_rnnt._gather_label_blank_logprobs(jnp.asarray(lp),
                                                 jnp.asarray(labels), 0)
    got = _gather_label_blank_logprobs(torch.from_numpy(lp),
                                       torch.from_numpy(labels), 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_rnnt_loss_matches_jax_and_oracle():
    logits, labels, t_lens, u_lens = _problem(2)
    cot = np.random.default_rng(3).normal(size=len(t_lens)).astype(
        np.float32)

    def jax_loss(x):
        losses = jax_rnnt.rnnt_loss(x, jnp.asarray(labels),
                                    jnp.asarray(t_lens), jnp.asarray(u_lens),
                                    reduction="none", use_pallas=False)
        return jnp.sum(losses * cot), losses

    (_, want), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(logits))
    results = {}
    for name, fn in (("kernel", rnnt_loss), ("oracle", rnnt_loss_reference)):
        x = torch.from_numpy(logits).requires_grad_()
        kwargs = {"reduction": "none"} if name == "kernel" else {}
        losses = fn(x, torch.from_numpy(labels), torch.from_numpy(t_lens),
                    torch.from_numpy(u_lens), **kwargs)
        (losses * torch.from_numpy(cot)).sum().backward()
        results[name] = (losses, x.grad)
    for losses, grad in results.values():
        np.testing.assert_allclose(_np(losses), np.asarray(want), **TOL)
        np.testing.assert_allclose(_np(grad), np.asarray(want_grad), **TOL)


@pytest.mark.parametrize("reduction", ["mean", "batchmean", "sum", "none"])
def test_reductions_and_relative_lengths(reduction):
    logits, labels, t_lens, u_lens = _problem(4)
    T, U = logits.shape[1], labels.shape[1]
    rel_t = (t_lens / T).astype(np.float32)
    rel_u = (u_lens / U).astype(np.float32)
    want = jax_rnnt.transducer_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(rel_t),
        jnp.asarray(rel_u), reduction=reduction, use_pallas=False)
    got = transducer_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                          torch.from_numpy(rel_t), torch.from_numpy(rel_u),
                          reduction=reduction)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_fused_loss_matches_jax_and_oracle(chunk):
    """Loss and the gradients of enc, dec, head weight and bias; the JAX
    side is its fused loss with the XLA lattice solver, the oracle is
    autograd through the port's per-cell recursion on the full logits."""
    rng = np.random.default_rng(5)
    B, T, U, J, V = 3, 10, 4, 8, 7
    enc, dec = (rng.normal(size=s).astype(np.float32)
                for s in ((B, T, J), (B, U + 1, J)))
    w = (rng.normal(size=(J, V)) * 0.3).astype(np.float32)
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    t_lens = np.array([T, 6, 1], np.int32)
    u_lens = np.array([U, 0, 2], np.int32)

    def jax_loss(*xs):
        return jnp.sum(jax_fused.rnnt_loss_fused(
            *xs, jnp.asarray(labels), jnp.asarray(t_lens),
            jnp.asarray(u_lens), chunk=chunk, use_pallas=False))

    want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (enc, dec, w, b)))
    want = [want[0], *want[1]]

    ins = [torch.from_numpy(x).requires_grad_() for x in (enc, dec, w, b)]
    got = rnnt_loss_fused(*ins, torch.from_numpy(labels),
                          torch.from_numpy(t_lens), torch.from_numpy(u_lens),
                          chunk=chunk).sum()
    got.backward()
    got = [got] + [x.grad for x in ins]

    ref_ins = [torch.from_numpy(x).requires_grad_() for x in (enc, dec, w, b)]
    joint = torch.nn.functional.leaky_relu(
        ref_ins[0][:, :, None] + ref_ins[1][:, None], 0.01)
    oracle = rnnt_loss_reference(joint @ ref_ins[2] + ref_ins[3],
                                 torch.from_numpy(labels),
                                 torch.from_numpy(t_lens),
                                 torch.from_numpy(u_lens)).sum()
    oracle.backward()
    oracle = [oracle] + [x.grad for x in ref_ins]
    for g, w_, o in zip(got, want, oracle):
        np.testing.assert_allclose(_np(g), np.asarray(w_), **TOL)
        np.testing.assert_allclose(_np(g), _np(o), **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_losses_stay_f64_in_f64(fused):
    """In f64 (the card's noise-floor run) the loss, the lattice and the
    gradients stay f64 and agree with the per-cell oracle to f64
    rounding: 1e-9 abs and rel."""
    rng = np.random.default_rng(7)
    B, T, U, J, V = 3, 9, 4, 6, 7
    enc, dec = (torch.from_numpy(rng.normal(size=s)).requires_grad_()
                for s in ((B, T, J), (B, U + 1, J)))
    w = torch.from_numpy(rng.normal(size=(J, V)) * 0.3).requires_grad_()
    b = torch.from_numpy(rng.normal(size=V) * 0.1).requires_grad_()
    labels = torch.from_numpy(rng.integers(1, V, size=(B, U)))
    t_lens = torch.tensor([T, 5, 1], dtype=torch.int32)
    u_lens = torch.tensor([U, 0, 2], dtype=torch.int32)
    logits = torch.nn.functional.leaky_relu(
        enc[:, :, None] + dec[:, None], 0.01) @ w + b
    if fused:
        got = rnnt_loss_fused(enc, dec, w, b, labels, t_lens, u_lens,
                              chunk=4)
    else:
        got = rnnt_loss(logits, labels, t_lens, u_lens, reduction="none")
    got_grads = torch.autograd.grad(got.sum(), (enc, dec, w, b),
                                    retain_graph=True)
    want = rnnt_loss_reference(logits, labels, t_lens, u_lens)
    want_grads = torch.autograd.grad(want.sum(), (enc, dec, w, b))
    assert got.dtype == torch.float64
    for g, w_ in zip((got, *got_grads), (want, *want_grads)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(_np(g), _np(w_), atol=1e-9, rtol=1e-9)


def test_lattice_wrapper_rules():
    assert rnnt_lattice.resident_fits(208, 129)       # 8 s batches
    assert rnnt_lattice.resident_fits(104, 61)        # bench.py's step
    assert not rnnt_lattice.resident_fits(408, 241)   # 16 s batches
    with pytest.raises(ValueError, match="variant"):
        rnnt_lattice.rnnt_lattice(torch.zeros(1, 2, 2), torch.zeros(1, 2, 2),
                                  torch.ones(1, dtype=torch.int32),
                                  torch.ones(1, dtype=torch.int32),
                                  variant="wavefront")
    before = (rnnt_lattice.resident_launches,
              rnnt_lattice.alpha_slab_launches,
              rnnt_lattice.beta_slab_launches)
    logits, labels, t_lens, u_lens = _problem(6)
    rnnt_loss(torch.from_numpy(logits), torch.from_numpy(labels),
              torch.from_numpy(t_lens), torch.from_numpy(u_lens))
    assert (rnnt_lattice.resident_launches, rnnt_lattice.alpha_slab_launches,
            rnnt_lattice.beta_slab_launches) == before   # no kernel on CPU
