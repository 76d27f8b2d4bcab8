"""The CUDA kernels of tsasr_torch on the card, against their plain
PyTorch versions. Marked ``cuda``: they skip on hosts without a GPU and
run on one with ``python -m pytest tests/test_torch_cuda.py --noconftest
-m cuda`` (``nvcc`` builds the kernels on first use)."""

import numpy as np
import pytest
import torch

from tsasr_torch.kernels import relpos_attention, rnnt_lattice
from tsasr_torch.ops.rnnt_loss import _gather_label_blank_logprobs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def attention_case(B, H, T, Dh, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    qu, qv, k, v = (torch.randn(B, H, T, Dh, generator=g) for _ in range(4))
    p = torch.randn(H, 2 * T - 1, Dh, generator=g)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    kp = torch.where(torch.arange(T)[None] < lens[:, None], 0.0, -1e9)
    band = (torch.arange(T)[:, None] - torch.arange(T)[None]).abs() > 7
    am = torch.where(band, -1e9, 0.0)
    return [t.to(device) for t in (qu, qv, k, v, p, kp, am)]


@pytest.mark.parametrize("B,H,T,Dh", [(2, 3, 10, 5), (1, 2, 37, 12),
                                      (8, 4, 101, 64), (2, 4, 300, 64),
                                      (1, 1, 65, 128)])
def test_relpos_attention_kernel_matches_plain(cuda, B, H, T, Dh):
    """f32 on both sides; the kernel sums in another order (online
    softmax over key tiles, 3xTF32 products), hence 1e-4 rather than
    bitwise."""
    args = attention_case(B, H, T, Dh, cuda, seed=T)
    before = relpos_attention.launches
    got = relpos_attention.fused_relpos_attention(*args, seed=0, scale=0.0625,
                                                  rate=0.0)
    torch.cuda.synchronize()
    assert relpos_attention.launches == before + 1
    want = relpos_attention.relpos_attention_reference(*args, 0.0625)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("M,N,K", [(16, 8, 8), (37, 29, 45), (64, 128, 64),
                                   (208, 64, 200)])
def test_tf32x3_mma_helper_matches_f32_matmul(cuda, M, N, K):
    """The attention backward's 3xTF32 mma.sync helper (fragment layout,
    split, ragged edges) as a plain product, against f64. Its error is
    f32's: within 1e-5 of max (|A| @ |B|), a tolerance that the inputs
    cut to TF32 (what 1xTF32 would multiply) miss."""
    import ctypes

    from tsasr_torch.kernels import _build
    fn = _build.load(relpos_attention.BWD_SOURCE).relpos_tf32x3_matmul_test
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator().manual_seed(M + N + K)
    a = torch.randn(M, K, generator=g).to(cuda)
    b = torch.randn(K, N, generator=g).to(cuda)
    c = torch.full((M, N), float("nan"), device=cuda)
    _build.check_launch(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                           torch.cuda.current_stream().cuda_stream),
                        "relpos_tf32x3_matmul_test")
    torch.cuda.synchronize()
    want = a.double() @ b.double()
    tol = 1e-5 * (a.double().abs() @ b.double().abs()).max().item()
    assert (c.double() - want).abs().max().item() <= tol
    assert (tf32(a) @ tf32(b) - want).abs().max().item() > tol


def tf32(x):
    """x cut to TF32 (what 1xTF32 multiplies), in f64."""
    return (x.view(torch.int32) & -8192).view(torch.float32).double()


@pytest.mark.parametrize("M,N,K,P", [(16, 8, 8, 8), (37, 29, 45, 13),
                                     (64, 64, 64, 64), (101, 32, 64, 64)])
def test_tf32x3_accumulator_route_matches_f64(cuda, M, N, K, P):
    """(A @ B) @ D with A @ B taken from the accumulators into the A
    operand as the attention forward takes P (load_a_acc, acc_key),
    against f64 within 1e-5 of max(|A| |B| |D|); the same chain on
    TF32-cut operands misses that."""
    import ctypes

    from tsasr_torch.kernels import _build
    fn = _build.load(relpos_attention.SOURCE).relpos_tf32x3_chain_test
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator().manual_seed(M + N + K + P)
    a = torch.randn(M, K, generator=g).to(cuda)
    b = torch.randn(K, N, generator=g).to(cuda)
    d = torch.randn(N, P, generator=g).to(cuda)
    c = torch.full((M, P), float("nan"), device=cuda)
    _build.check_launch(fn(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                           c.data_ptr(), M, N, K, P,
                           torch.cuda.current_stream().cuda_stream),
                        "relpos_tf32x3_chain_test")
    torch.cuda.synchronize()
    want = (a.double() @ b.double()) @ d.double()
    tol = 1e-5 * (a.double().abs() @ b.double().abs()
                  @ d.double().abs()).max().item()
    one = tf32((tf32(a) @ tf32(b)).float()) @ tf32(d)
    assert (c.double() - want).abs().max().item() <= tol
    assert (one - want).abs().max().item() > tol


def plain_row_stats(qu, qv, k, v, p, kp, am, scale):
    """Row max and 1 / row sum of the scores, in f32 as the plain version
    adds them (a fully masked row's scores round to -1e9 alike)."""
    T = qu.shape[2]
    s = ((qu @ k.transpose(-1, -2)
          + relpos_attention.rel_shift(torch.einsum("bhtd,hsd->bhts", qv, p),
                                       T)) * scale
         + am + kp[:, None, None])
    m = s.max(-1).values
    return m, 1.0 / torch.exp(s - m[..., None]).sum(-1)


@pytest.mark.parametrize("B,H,T,Dh", [(2, 3, 5, 64), (3, 2, 17, 64),
                                      (2, 2, 33, 5), (2, 2, 70, 36),
                                      (1, 2, 45, 128), (8, 4, 101, 64),
                                      (6, 4, 208, 64)])
def test_relpos_attention_forward_stats_and_edges(cuda, B, H, T, Dh):
    """The forward at T < 16 (the second warp half of every row group
    sees no key below T), T = 17 (it sees one), ragged Dh and both query
    tiles: out with and without stats bit for bit the same, within 1e-4
    of the plain version, and the stats against the plain row max
    (1e-5 of max(1, |m|)) and 1 / row sum (1e-4 relative), rows whose
    keys are all masked included (the last utterance has one key, the
    band half-width 7)."""
    args = attention_case(B, H, T, Dh, cuda, seed=T + Dh)
    args[5][-1] = torch.where(torch.arange(T, device=cuda) < 1, 0.0, -1e9)
    out, stats, _ = relpos_attention._launch_fwd(*args, 0, 0.0625, 0.0,
                                                 want_stats=True)
    bare, none, _ = relpos_attention._launch_fwd(*args, 0, 0.0625, 0.0,
                                                 want_stats=False)
    torch.cuda.synchronize()
    assert none is None and torch.equal(out, bare)
    want = relpos_attention.relpos_attention_reference(*args, 0.0625)
    assert (out - want).abs().max().item() <= 1e-4
    m, linv = plain_row_stats(*args, 0.0625)
    if T > 9:
        assert m.min().item() < -1e8               # a fully masked row
    assert ((stats[..., 0] - m).abs() <= 1e-5 * m.abs().clamp(min=1.0)).all()
    assert ((stats[..., 1] - linv).abs() <= 1e-4 * linv).all()


@pytest.mark.parametrize("B,H,T", [(8, 4, 101), (8, 4, 10), (6, 4, 208)])
def test_relpos_attention_forward_is_deterministic(cuda, B, H, T):
    """The forward merges its two warps' softmax through shared memory
    and has no atomics: repeated launches on the same inputs give the
    same bits of out and of the stats, at the serving shape, at T10 (the
    second warp half of every row group sees no key) and at the 8 s
    training shape."""
    args = attention_case(B, H, T, 64, cuda, seed=3 * T)
    first = relpos_attention._launch_fwd(*args, 0, 0.0625, 0.0,
                                         want_stats=True)[:2]
    for _ in range(3):
        again = relpos_attention._launch_fwd(*args, 0, 0.0625, 0.0,
                                             want_stats=True)[:2]
        torch.cuda.synchronize()
        assert torch.isfinite(first[0]).all()
        assert all(torch.equal(a, f) for a, f in zip(again, first))


@pytest.mark.parametrize("B,H,T", [(2, 3, 45), (3, 4, 200)])
def test_dropout_mask_bit_identical(cuda, B, H, T):
    want = relpos_attention.philox_keep_mask(1234567, B, H, T, 0.1, cuda)
    got = relpos_attention.dropout_mask_cuda(1234567, B, H, T, 0.1, cuda)
    assert torch.equal(got, want)
    assert abs(got.float().mean().item() - 0.9) < 0.01


@pytest.mark.parametrize("B,H,T,Dh", [(2, 3, 45, 16), (3, 4, 130, 64),
                                      (2, 2, 10, 5), (1, 3, 64, 64),
                                      (2, 2, 97, 5), (2, 2, 75, 128),
                                      (2, 2, 130, 36)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_relpos_attention_forward_and_backward_match_plain(cuda, B, H, T,
                                                           Dh, rate):
    """Forward and every gradient of the kernels against autograd through
    the plain version with the same Philox mask. f32; the kernels sum in
    other orders and dp sums its per-batch partials in batch order, so
    1e-4 of each output's largest magnitude (at least 1) rather than
    bitwise: dp sums over every batch element and position."""
    args = attention_case(B, H, T, Dh, cuda, seed=B * T)
    seed = torch.tensor([777], device=cuda)
    outs = {}
    for name, fn in (("kernel", relpos_attention.fused_relpos_attention),
                     ("plain", relpos_attention.relpos_attention_reference)):
        leaves = [t.clone().requires_grad_(i < 5) for i, t in enumerate(args)]
        out = fn(*leaves, seed=seed, scale=0.0625, rate=rate)
        g = torch.Generator(device=cuda).manual_seed(5)
        out.backward(torch.randn(out.shape, generator=g, device=cuda))
        outs[name] = [out] + [t.grad for t in leaves[:5]]
    torch.cuda.synchronize()
    for got, want in zip(outs["kernel"], outs["plain"]):
        scale = max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.detach().cpu().numpy(),
                                   want.detach().cpu().numpy(),
                                   atol=1e-4 * scale, rtol=0)


def causal_mask(T, context):
    """A causal encoder's ``am_add``: the lookahead mask, and with
    ``context`` the band of ``att_context_size`` (keys that many frames or
    more back hidden too)."""
    pos = torch.arange(T)
    hidden = pos[None, :] > pos[:, None]
    if context:
        hidden |= (pos[:, None] - pos[None, :]) >= context
    return torch.where(hidden, -1e9, 0.0)


@pytest.mark.parametrize("T", [101, 208])
@pytest.mark.parametrize("context", [0, 64])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_relpos_attention_on_causal_masks_matches_plain(cuda, T, context,
                                                        rate):
    """The masks a causal model gives the kernels (row 0 sees one key,
    most of a row is fill; with the band, padded rows see none): the
    forward and every gradient against autograd through the plain
    version, with key padding and the same Philox mask, at the tolerance
    of the test above."""
    args = attention_case(8, 4, T, 64, cuda, seed=T + context)
    args[6] = causal_mask(T, context).to(cuda)
    seed = torch.tensor([4242], device=cuda)
    outs = {}
    for name, fn in (("kernel", relpos_attention.fused_relpos_attention),
                     ("plain", relpos_attention.relpos_attention_reference)):
        leaves = [t.clone().requires_grad_(i < 5) for i, t in enumerate(args)]
        out = fn(*leaves, seed=seed, scale=0.0625, rate=rate)
        g = torch.Generator(device=cuda).manual_seed(6)
        out.backward(torch.randn(out.shape, generator=g, device=cuda))
        outs[name] = [out] + [t.grad for t in leaves[:5]]
    torch.cuda.synchronize()
    for got, want in zip(outs["kernel"], outs["plain"]):
        scale = max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.detach().cpu().numpy(),
                                   want.detach().cpu().numpy(),
                                   atol=1e-4 * scale, rtol=0)


def lattice_case(B, T, U1, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    V = 7
    logits = torch.randn(B, T, U1, V, generator=g)
    labels = torch.randint(1, V, (B, U1 - 1), generator=g)
    lpb, lpl = _gather_label_blank_logprobs(torch.log_softmax(logits, -1),
                                            labels, 0)
    t_lens = torch.randint(max(1, T // 2), T + 1, (B,), generator=g)
    u_lens = torch.randint(0, U1, (B,), generator=g)
    t_lens[0], u_lens[0] = T, U1 - 1
    return [x.to(device) for x in (lpb, lpl, t_lens.int(), u_lens.int())]


def lattice_tol(loss, T, U1):
    """atol 1e-4 and rtol from the loss, as chip_smoke.py::lattice_rtol
    states it: 2 sqrt(T + U) roundings of the largest loss."""
    return 1e-4, max(1e-4, 2 * (T + U1) ** 0.5 * loss.abs().max().item()
                     * 2.0 ** -24)


@pytest.mark.parametrize("variant,B,T,U1", [
    ("resident", 3, 40, 8), ("resident", 2, 17, 1500),
    ("slab", 3, 70, 13), ("slab", 2, 150, 1100), ("auto", 4, 33, 61)])
def test_rnnt_lattice_kernels_match_plain(cuda, variant, B, T, U1):
    """Loss and both gradient lattices against the plain row scan on the
    card. U1 1100 and 1500 are wider than a row chain's chunk of 1024
    columns, so the rows are walked in chunks. f32 sums in another order:
    atol 1e-4 and
    rtol 1e-4, or more on long lattices: a gradient is
    exp(alpha + lp + beta - logZ), whose exponent is a difference of sums
    of magnitude ~|logZ| = loss, and their rounding errors add up like a
    random walk over a path's T + U steps: 2 sqrt(T + U) roundings of
    the largest loss."""
    args = lattice_case(B, T, U1, cuda, seed=T + U1)
    counts = (rnnt_lattice.resident_launches,
              rnnt_lattice.alpha_slab_launches,
              rnnt_lattice.beta_slab_launches)
    got = rnnt_lattice.rnnt_lattice(*args, variant=variant)
    torch.cuda.synchronize()
    want = rnnt_lattice.rnnt_lattice_reference(*args)
    atol, rtol = lattice_tol(want[0], T, U1)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=atol, rtol=rtol)
    slab = variant == "slab" or (
        variant == "auto" and not rnnt_lattice.resident_fits(T, U1))
    assert (rnnt_lattice.resident_launches - counts[0],
            rnnt_lattice.alpha_slab_launches - counts[1],
            rnnt_lattice.beta_slab_launches - counts[2]) == \
        ((0, 1, 1) if slab else (1, 0, 0))


def f64(args):
    return [x.double() if x.is_floating_point() else x for x in args]


def beta_slab(args, alpha, logz):
    """The beta slab kernel alone, through its C entry, into outputs
    filled with NaN so that a cell it leaves unwritten shows."""
    lpb, lpl, t_lens, u_lens = args
    B, T, U1 = lpb.shape
    dlpb = torch.full_like(lpb, float("nan"))
    dlpl = torch.full_like(lpl, float("nan"))
    err = rnnt_lattice._kernels()["beta"](
        lpb.data_ptr(), lpl.data_ptr(), t_lens.data_ptr(), u_lens.data_ptr(),
        alpha.data_ptr(), logz.data_ptr(), dlpb.data_ptr(), dlpl.data_ptr(),
        B, T, U1, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return dlpb, dlpl


@pytest.mark.parametrize("B,T,U1,beta_k", [(5, 60, 40, (4, 8)),
                                           (6, 208, 129, (8, 8))])
def test_rnnt_lattice_variants_agree(cuda, B, T, U1, beta_k):
    """Each variant against the plain version in f64, within the lattice
    tolerance. Both run the same alpha row chain at the same K here (4 at
    U+1 40, 8 at 129), so their losses agree bit for bit. The beta
    passes are one chain's text in two copies: where their K differ
    (``beta_k``: the resident kernel's, the beta slab's) the gradients
    agree within twice the tolerance (each within it of f64), where it is
    the same, bit for bit."""
    assert rnnt_lattice.alpha_slab_cols(U1) == rnnt_lattice.resident_cols(
        T, U1) == beta_k[0]
    args = lattice_case(B, T, U1, cuda, seed=3)
    res = rnnt_lattice.rnnt_lattice(*args, variant="resident")
    slab = rnnt_lattice.rnnt_lattice(*args, variant="slab")
    want = rnnt_lattice.rnnt_lattice_reference(*f64(args))
    atol, rtol = lattice_tol(want[0], T, U1)
    for r, s, w in zip(res, slab, want):
        for got in (r, s):
            np.testing.assert_allclose(got.double().cpu().numpy(),
                                       w.cpu().numpy(), atol=atol,
                                       rtol=rtol)
        np.testing.assert_allclose(r.cpu().numpy(), s.cpu().numpy(),
                                   atol=2 * atol, rtol=2 * rtol)
    assert torch.equal(res[0], slab[0])
    if beta_k[0] == beta_k[1]:
        assert torch.equal(res[1], slab[1]) and torch.equal(res[2], slab[2])


def alpha_slab(args):
    """The alpha slab kernel alone, through its C entry: (alpha filled
    with NaN first, so that a cell it leaves unwritten shows, logZ,
    loss)."""
    lpb, lpl, t_lens, u_lens = args
    B, T, U1 = lpb.shape
    alpha = torch.full_like(lpb, float("nan"))
    logz = torch.full((B,), float("nan"), device=lpb.device)
    loss = torch.full((B,), float("nan"), device=lpb.device)
    err = rnnt_lattice._kernels()["alpha"](
        lpb.data_ptr(), lpl.data_ptr(), t_lens.data_ptr(), u_lens.data_ptr(),
        alpha.data_ptr(), logz.data_ptr(), loss.data_ptr(), B, T, U1,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return alpha, logz, loss


def inside(t_lens, u_lens, T, U1):
    """(B, T, U+1) mask of the cells inside each utterance's lattice."""
    t = torch.arange(T, device=t_lens.device)[None, :, None]
    u = torch.arange(U1, device=t_lens.device)[None, None]
    return (t < t_lens.long()[:, None, None]) & (
        u <= u_lens.long()[:, None, None])


@pytest.mark.parametrize("B,T,U1", [(3, 70, 13), (2, 150, 1100),
                                    (3, 408, 241), (2, 64, 300),
                                    (4, 33, 257), (3, 20, 2)])
def test_rnnt_alpha_slab_matches_f64(cuda, B, T, U1):
    """The alpha slab kernel (the alpha row chain into device memory, rows
    U+1 apart) against its plain version (rnnt_alpha_reference) in f64:
    alpha inside each lattice and logZ at the lattice tolerance, the loss
    -logZ. Rows of one chunk (U+1 13 at K = 4, 241, 300, 257), of two
    chunks of 1024 (1100: alpha[t-1] read back from device memory) and
    U+1 2, where every lane but the first owns columns past the stride.
    The beta slab kernel then reads this alpha, NaN outside the lattices,
    and its gradients are finite and within the tolerance of f64."""
    args = lattice_case(B, T, U1, cuda, seed=11 * T + U1)
    alpha, logz, loss = alpha_slab(args)
    torch.cuda.synchronize()
    want, want_z = rnnt_lattice.rnnt_alpha_reference(*f64(args))
    atol, rtol = lattice_tol(want_z, T, U1)
    cells = inside(args[2], args[3], T, U1)
    got = alpha[cells]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want[cells].cpu().numpy(), atol=atol,
                               rtol=rtol)
    np.testing.assert_allclose(logz.double().cpu().numpy(),
                               want_z.cpu().numpy(), atol=atol, rtol=rtol)
    assert torch.equal(loss, -logz)
    grads = beta_slab(args, alpha, logz)
    torch.cuda.synchronize()
    full = rnnt_lattice.rnnt_lattice_reference(*f64(args))
    for g, w in zip(grads, full[1:]):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.double().cpu().numpy(),
                                   w.cpu().numpy(), atol=atol, rtol=rtol)


def test_rnnt_slab_empty_utterances(cuda):
    """Tl = 0: logZ NEG, loss -NEG (1e30) and every gradient 0, as the JAX
    kernels give; Ul = 0 (one column) and a full utterance beside it
    within the lattice tolerance of f64."""
    args = lattice_case(3, 12, 8, cuda, seed=1)
    args[2][:] = torch.tensor([12, 0, 7], dtype=torch.int32)
    args[3][:] = torch.tensor([7, 3, 0], dtype=torch.int32)
    _, logz, _ = alpha_slab(args)
    loss, dlpb, dlpl = rnnt_lattice.rnnt_lattice(*args, variant="slab")
    torch.cuda.synchronize()
    want = rnnt_lattice.rnnt_lattice_reference(*f64(args))
    assert logz[1].item() == float(np.float32(rnnt_lattice.NEG))
    assert loss[1].item() == float(np.float32(-rnnt_lattice.NEG))
    assert (dlpb[1] == 0).all() and (dlpl[1] == 0).all()
    atol, rtol = lattice_tol(want[0][[0, 2]], 12, 8)
    for g, w in zip((loss, dlpb, dlpl), want):
        np.testing.assert_allclose(g[[0, 2]].double().cpu().numpy(),
                                   w[[0, 2]].cpu().numpy(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("B,T,U1", [(3, 408, 241), (2, 150, 1100)])
def test_rnnt_slab_pair_is_deterministic(cuda, B, T, U1):
    """No atomics and a fixed order of every sum: the slab pair (alpha
    slab, then beta slab) repeated on the same inputs gives the same bits
    of the loss and both gradients."""
    args = lattice_case(B, T, U1, cuda, seed=U1 + 2)
    first = rnnt_lattice.rnnt_lattice(*args, variant="slab")
    for _ in range(3):
        again = rnnt_lattice.rnnt_lattice(*args, variant="slab")
        torch.cuda.synchronize()
        assert torch.isfinite(first[1]).all()
        assert all(torch.equal(a, f) for a, f in zip(again, first))


def test_rnnt_alpha_slab_cols_matches_python(cuda):
    """The alpha slab kernel's K as its C entry computes it and as
    ``rnnt_lattice.alpha_slab_cols`` states it."""
    fn = rnnt_lattice._kernels()["alpha_slab_cols"]
    for U1 in (1, 3, 4, 61, 128, 129, 241, 256, 257, 298, 512, 513, 801,
               1024, 1025, 1100, 5000):
        assert fn(U1) == rnnt_lattice.alpha_slab_cols(U1), U1


@pytest.mark.parametrize("B,T,U1", [(3, 70, 13), (2, 150, 1100),
                                    (3, 408, 241), (2, 64, 300),
                                    (4, 33, 257)])
def test_rnnt_beta_slab_matches_f64(cuda, B, T, U1):
    """The beta slab kernel given the alpha slab kernel's alpha and logZ,
    against its plain version (rnnt_beta_reference) in f64 on the same
    inputs, and the slab variant as a whole against the f64 lattice, at
    the lattice tolerance. Rows of one chunk (256 columns), of two and
    of five; U+1 257 is one column past a chunk."""
    args = lattice_case(B, T, U1, cuda, seed=7 * T + U1)
    lpb, lpl, t_lens, u_lens = args
    alpha = torch.empty_like(lpb)
    logz = torch.empty(B, device=cuda)
    loss = torch.empty(B, device=cuda)
    err = rnnt_lattice._kernels()["alpha"](
        lpb.data_ptr(), lpl.data_ptr(), t_lens.data_ptr(), u_lens.data_ptr(),
        alpha.data_ptr(), logz.data_ptr(), loss.data_ptr(), B, T, U1,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    got = beta_slab(args, alpha, logz)
    torch.cuda.synchronize()
    want = rnnt_lattice.rnnt_beta_reference(*f64(args), alpha.double(),
                                            logz.double())
    atol, rtol = lattice_tol(loss, T, U1)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.double().cpu().numpy(),
                                   w.cpu().numpy(), atol=atol, rtol=rtol)
    whole = rnnt_lattice.rnnt_lattice(*args, variant="slab")
    want = rnnt_lattice.rnnt_lattice_reference(*f64(args))
    for g, w in zip(whole, want):
        np.testing.assert_allclose(g.double().cpu().numpy(),
                                   w.cpu().numpy(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("B,T,U1", [(3, 408, 241), (2, 150, 1100)])
def test_rnnt_beta_slab_is_deterministic(cuda, B, T, U1):
    """No atomics and a fixed order of every sum: repeated launches on
    the same inputs give the same bits (each into outputs filled with
    NaN)."""
    args = lattice_case(B, T, U1, cuda, seed=U1)
    alpha, logz = rnnt_lattice.rnnt_alpha_reference(*args)
    first = beta_slab(args, alpha.contiguous(), logz.contiguous())
    for _ in range(3):
        again = beta_slab(args, alpha.contiguous(), logz.contiguous())
        torch.cuda.synchronize()
        assert torch.isfinite(first[0]).all()
        assert all(torch.equal(a, f) for a, f in zip(again, first))


def resident(args):
    """The resident kernel through its C entry, into outputs filled with
    NaN so that a cell it leaves unwritten shows."""
    lpb, lpl, t_lens, u_lens = args
    B, T, U1 = lpb.shape
    loss = torch.full((B,), float("nan"), device=lpb.device)
    dlpb = torch.full_like(lpb, float("nan"))
    dlpl = torch.full_like(lpl, float("nan"))
    err = rnnt_lattice._kernels()["resident"](
        lpb.data_ptr(), lpl.data_ptr(), t_lens.data_ptr(), u_lens.data_ptr(),
        loss.data_ptr(), dlpb.data_ptr(), dlpl.data_ptr(), B, T, U1,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return loss, dlpb, dlpl


@pytest.mark.parametrize("B,T,U1", [(3, 40, 8), (6, 208, 129), (4, 33, 257),
                                    (2, 17, 1500)])
def test_rnnt_resident_matches_f64(cuda, B, T, U1):
    """The resident kernel (alpha and beta row chains, alpha in shared
    memory) against the plain lattice in f64 at the lattice tolerance,
    at each K: a narrow lattice (K = 4), the 8 s training batch (K = 8),
    U+1 257 (K = 16, one column past 8's chunk) and U+1 1500 (K = 32, two
    chunks of 1024 a row, alpha[t-1] read back from shared memory)."""
    assert rnnt_lattice.resident_fits(T, U1)
    args = lattice_case(B, T, U1, cuda, seed=5 * T + U1)
    got = resident(args)
    torch.cuda.synchronize()
    want = rnnt_lattice.rnnt_lattice_reference(*f64(args))
    atol, rtol = lattice_tol(want[0], T, U1)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.double().cpu().numpy(),
                                   w.cpu().numpy(), atol=atol, rtol=rtol)


def test_rnnt_resident_empty_utterances(cuda):
    """Tl = 0: loss -NEG (1e30) and every gradient 0, as the JAX kernel
    gives; Ul = 0 (one column) and a full utterance beside it within the
    lattice tolerance of f64."""
    args = lattice_case(3, 12, 8, cuda, seed=1)
    args[2][:] = torch.tensor([12, 0, 7], dtype=torch.int32)
    args[3][:] = torch.tensor([7, 3, 0], dtype=torch.int32)
    loss, dlpb, dlpl = resident(args)
    torch.cuda.synchronize()
    want = rnnt_lattice.rnnt_lattice_reference(*f64(args))
    assert loss[1].item() == float(np.float32(-rnnt_lattice.NEG))
    assert (dlpb[1] == 0).all() and (dlpl[1] == 0).all()
    atol, rtol = lattice_tol(want[0][[0, 2]], 12, 8)
    for g, w in zip((loss, dlpb, dlpl), want):
        np.testing.assert_allclose(g[[0, 2]].double().cpu().numpy(),
                                   w[[0, 2]].cpu().numpy(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("B,T,U1", [(6, 208, 129), (2, 17, 1500)])
def test_rnnt_resident_is_deterministic(cuda, B, T, U1):
    """No atomics and a fixed order of every sum: repeated launches on
    the same inputs give the same bits (each into outputs filled with
    NaN)."""
    args = lattice_case(B, T, U1, cuda, seed=U1 + 1)
    first = resident(args)
    for _ in range(3):
        again = resident(args)
        torch.cuda.synchronize()
        assert torch.isfinite(first[1]).all()
        assert all(torch.equal(a, f) for a, f in zip(again, first))


def test_rnnt_resident_smem_matches_python(cuda):
    """The resident kernel's shared memory as its C entry computes it and
    as ``rnnt_lattice.resident_smem`` (the routing rule) does, at every
    K and at the fallback to K = 8 (T20 U+1 1500)."""
    fn = rnnt_lattice._kernels()["resident_smem"]
    for T in (1, 17, 20, 40, 104, 208, 391, 392, 408):
        for U1 in (1, 5, 8, 61, 129, 241, 256, 257, 512, 513, 1100, 1500):
            assert fn(T, U1) == rnnt_lattice.resident_smem(T, U1), (T, U1)


def test_relpos_attention_wrapper_rejects_bad_inputs(cuda):
    B, H, T, Dh = 1, 2, 8, 16
    args = [torch.zeros(B, H, T, Dh, device=cuda) for _ in range(4)] + [
        torch.zeros(H, 2 * T - 1, Dh, device=cuda),
        torch.zeros(B, T, device=cuda), torch.zeros(T, T, device=cuda)]
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError):
        relpos_attention.fused_relpos_attention(*bad, 0, 0.1, 0.0)
    bad = list(args)
    bad[4] = args[4][:, :-1]
    with pytest.raises(ValueError):
        relpos_attention.fused_relpos_attention(*bad, 0, 0.1, 0.0)
    bad = list(args)
    bad[2] = args[2].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        relpos_attention.fused_relpos_attention(*bad, 0, 0.1, 0.0)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="is on"):
        relpos_attention.fused_relpos_attention(*bad, 0, 0.1, 0.0)
    with pytest.raises(ValueError, match="rate"):
        relpos_attention.fused_relpos_attention(*args, 0, 0.1, 1.0)


def test_rnnt_lattice_wrapper_rejects_bad_inputs(cuda):
    lpb, lpl, t_lens, u_lens = lattice_case(2, 9, 5, cuda)
    with pytest.raises(TypeError):
        rnnt_lattice.rnnt_lattice(lpb.double(), lpl, t_lens, u_lens)
    with pytest.raises(TypeError):
        rnnt_lattice.rnnt_lattice(lpb, lpl, t_lens.long(), u_lens)
    with pytest.raises(ValueError, match="shape"):
        rnnt_lattice.rnnt_lattice(lpb, lpl[:, :-1], t_lens, u_lens)
    with pytest.raises(ValueError, match="contiguous"):
        rnnt_lattice.rnnt_lattice(lpb.transpose(0, 1).contiguous()
                                  .transpose(0, 1), lpl, t_lens, u_lens)
    with pytest.raises(ValueError, match="is on"):
        rnnt_lattice.rnnt_lattice(lpb, lpl, t_lens.cpu(), u_lens)
    big = torch.zeros(1, 400, 200, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        rnnt_lattice.rnnt_lattice(big, big, lens, lens, variant="resident")


@pytest.mark.parametrize("lm", [None, "ngram", "rnnlm"])
def test_batched_beam_on_the_card_matches_the_cpu(cuda, lm):
    """The batched beam (no kernel of its own) on the card and on the CPU
    over the same encoder output and weights, bare and with each LM:
    the tensors stay on the card; where the top two distinct hypotheses
    are more than 1e-4 apart the best tokens agree, and the best
    normalized scores within 1e-4 (f32 on both sides)."""
    import copy
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_torch.decoding import BatchedBeamSearcher
    from tsasr_torch.lm import (BackoffNgramLM, make_ngram_lm_step_fn,
                                train_backoff_ngram)
    from tsasr_torch.models.lm import RNNLM, RNNLMConfig, make_lm_step_fn
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)

    pieces = ["<unk>", "▁"] + list("abcdefghij")
    model = TSTransducer(TSTransducerConfig(
        vocab_size=len(pieces), d_model=16, nhead=2, encoder_num_layers=1,
        d_ffn=16, frontend_channels=(4, 4), injection_mode=None,
        use_speaker_encoder=False, decoder_neurons=64, joint_dim=32,
        dropout=0.0)).init_weights(seed=0).eval()
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.normal(size=(4, 60, 32)).astype(np.float32))
    rel = torch.tensor([1.0, 0.8, 0.6, 0.5])

    def searcher(device):
        kwargs = {}
        if lm == "ngram":
            tok = CharTokenizer(pieces)
            sents = [tok.encode_as_pieces(" ".join(np.random.default_rng(
                i).choice(list("abcdefghij"), 5))) for i in range(30)]
            step, init = make_ngram_lm_step_fn(
                BackoffNgramLM(*train_backoff_ngram(sents, order=3)),
                pieces, bos_id=0, device=device)
            kwargs = dict(lm_step_fn=step, lm_initial_state_fn=init,
                          lm_weight=0.3)
        elif lm == "rnnlm":
            net = RNNLM(RNNLMConfig(vocab_size=len(pieces), embedding_dim=8,
                                    hidden_size=16, num_layers=2,
                                    dnn_neurons=8)).init_weights(seed=0)
            net = net.to(device).eval()
            kwargs = dict(lm_step_fn=make_lm_step_fn(net),
                          lm_initial_state_fn=net.initial_state,
                          lm_weight=0.3)
        return BatchedBeamSearcher(copy.deepcopy(model).to(device),
                                   beam_size=8, nbest=8, **kwargs)

    got = searcher(cuda).decode(enc.to(cuda), rel.to(cuda))
    assert all(x.device.type == "cuda" for x in got)
    got = [x.cpu() for x in got]
    want = searcher(torch.device("cpu")).decode(enc, rel)
    for b in range(enc.shape[0]):
        def ranked(tokens, lengths, norm):
            out = {}
            for k in range(tokens.shape[1]):
                out.setdefault(tuple(tokens[b, k, :lengths[b, k]].tolist()),
                               norm[b, k].item())
            return out
        hyps, w_hyps = ranked(*got), ranked(*want)
        scores = list(hyps.values())
        best = next(iter(hyps))
        if best == next(iter(w_hyps)):
            assert abs(hyps[best] - w_hyps[best]) < 1e-4
        else:
            assert scores[0] - scores[1] <= 1e-4, b


# ------------------------------------------------------------------ bf16
@pytest.mark.parametrize("M,N,K", [(16, 16, 16), (64, 48, 32), (32, 64, 64)])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_bf16_mma_helper_matches_f64(cuda, M, N, K, mode):
    """The bf16 kernels' mma.sync m16n8k16 helper by each route of its
    fragments (ldmatrix, ldmatrix .trans, the functor loaders, the
    accumulators packed as the A operand) as a plain product of bf16
    operands, against f64: the products are exact and sum in f32."""
    import ctypes
    from tsasr_torch.kernels import _build
    fn = _build.load(relpos_attention.SOURCE).relpos_bf16_matmul_test
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    g = torch.Generator().manual_seed(M + N + K)
    a = torch.randn(M, K, generator=g).to(cuda).bfloat16()
    b = torch.randn(K, N, generator=g).to(cuda).bfloat16()
    c = torch.full((M, N), float("nan"), device=cuda)
    assert fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, mode,
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    want = a.double() @ b.double()
    assert (c.double() - want).abs().max() <= 1e-5 * (
        a.double().abs() @ b.double().abs()).max()


@pytest.mark.parametrize("B,H,T,Dh,rate", [(2, 3, 10, 8, 0.0),
                                           (8, 4, 101, 64, 0.1),
                                           (3, 4, 208, 64, 0.1),
                                           (2, 2, 45, 128, 0.1),
                                           (1, 2, 19, 12, 0.0)])
def test_relpos_attention_bf16_kernels_match_plain(cuda, B, H, T, Dh, rate):
    """The bf16 kernels against the plain bf16 version (the JAX kernels'
    rounding points), forward and backward: both round at the same
    points but sum in other orders, so an output near a rounding boundary
    lands an ulp apart: within 2^-7 of max |o| and 2^-6 of each
    gradient's max |g|; and no further from f64 than 1.5 times the plain
    version. The bf16 counts move, the f32 ones do not."""
    args = attention_case(B, H, T, Dh, cuda, seed=T + Dh)
    args = [x.bfloat16() for x in args[:5]] + args[5:]
    seed = torch.tensor([31337], device=cuda)
    do = torch.randn(B, H, T, Dh, device=cuda).bfloat16()
    res = {}
    before = (relpos_attention.launches, relpos_attention.bwd_launches,
              relpos_attention.bf16_launches,
              relpos_attention.bf16_bwd_launches)
    for name, fn, dtype in (
            ("kernel", relpos_attention.fused_relpos_attention, None),
            ("plain", relpos_attention.relpos_attention_reference, None),
            ("f64", relpos_attention.relpos_attention_reference,
             torch.float64)):
        leaves = [(x if dtype is None else x.to(dtype)).clone()
                  .requires_grad_(i < 5) for i, x in enumerate(args)]
        out = fn(*leaves, seed=seed, scale=0.0625, rate=rate)
        res[name] = [out.detach(), *torch.autograd.grad(
            out, leaves[:5], do if dtype is None else do.to(dtype))]
    torch.cuda.synchronize()
    after = (relpos_attention.launches, relpos_attention.bwd_launches,
             relpos_attention.bf16_launches,
             relpos_attention.bf16_bwd_launches)
    assert after == (before[0], before[1], before[2] + 1, before[3] + 1)

    def err(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max()).item()

    for i, (k, p, f) in enumerate(zip(res["kernel"], res["plain"],
                                      res["f64"])):
        assert k.dtype == torch.bfloat16
        assert err(k, p) <= (2.0 ** -7 if i == 0 else 2.0 ** -6)
        assert err(k, f) <= 1.5 * err(p, f) + 1e-7


@pytest.mark.parametrize("dh,max_t", [(1, 3424), (32, 3424), (33, 3264),
                                      (64, 3264), (65, 2944), (128, 2944)])
def test_bf16_forward_max_t_matches_the_wrapper(cuda, dh, max_t):
    """The wrapper's cutover, the resident bf16 forward's largest T as
    the built kernel computes it, is the T the kernel source states (and
    tests/test_torch_attention_tiling.py's layout gives)."""
    assert relpos_attention.bf16_fwd_max_t(dh) == max_t


@pytest.mark.parametrize("past", [0, 1])
def test_bf16_forward_routes_at_the_cutover(cuda, past):
    """At the resident route's largest T (227 KB of shared memory a
    block) and one key past it (the two-pass kernel): the forward within
    2^-7 of the plain bf16 version's max |o| at dropout 0.1, one launch
    counted on the route taken; the resident entry refuses the longer T
    itself."""
    Dh = 64
    T = relpos_attention.bf16_fwd_max_t(Dh) + past
    args = attention_case(1, 2, T, Dh, cuda, seed=T)
    args = [x.bfloat16() for x in args[:5]] + args[5:]
    seed = torch.tensor([7], device=cuda)
    before = (relpos_attention.bf16_launches,
              relpos_attention.bf16_long_launches)
    with torch.no_grad():
        got = relpos_attention.fused_relpos_attention(
            *args, seed=seed, scale=0.125, rate=0.1)
    torch.cuda.synchronize()
    after = (relpos_attention.bf16_launches,
             relpos_attention.bf16_long_launches)
    assert after == (before[0] + 1 - past, before[1] + past)
    want = relpos_attention.relpos_attention_fwd_bf16(*args, 0.125, seed, 0.1)
    err = ((got.double() - want.double()).abs().max()
           / want.double().abs().max()).item()
    assert err <= 2.0 ** -7
    if past:
        out = torch.empty_like(args[0])
        assert relpos_attention._fwd_kernel("relpos_attention_fwd_bf16")(
            *(x.data_ptr() for x in args), out.data_ptr(), 0, 0, 1.0, 0,
            1, 2, T, Dh, 0.125, torch.cuda.current_stream().cuda_stream,
            0) != 0


def bf16_backward_case(B, H, T, Dh, mask, device, seed=0):
    """bf16 operands, key padding (utterance lengths from the seed) and
    ``mask``'s am: none, the causal lookahead, or the lookahead and a
    band of 64; a bf16 output gradient."""
    args = attention_case(B, H, T, Dh, device, seed)
    pos = torch.arange(T)
    hidden = torch.zeros(T, T, dtype=torch.bool)
    if mask != "key padding":
        hidden = pos[None, :] > pos[:, None]
    if "band" in mask:
        hidden = hidden | ((pos[:, None] - pos[None, :]) >= 64)
    args[6] = torch.where(hidden, -1e9, 0.0).to(device)
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(B, H, T, Dh, generator=g).to(device).bfloat16()
    return [x.bfloat16() for x in args[:5]] + args[5:], do


def bf16_gradients(fn, args, do, seed, rate, dtype=None):
    leaves = [(x if dtype is None else x.to(dtype)).clone()
              .requires_grad_(i < 5) for i, x in enumerate(args)]
    out = fn(*leaves, seed=seed, scale=0.125, rate=rate)
    return torch.autograd.grad(out, leaves[:5],
                               do if dtype is None else do.to(dtype))


def bf16_bwd_counts():
    return (relpos_attention.bf16_bwd_launches,
            relpos_attention.bf16_bwd_long_launches,
            relpos_attention.bwd_launches)


@pytest.mark.parametrize("mask", ["key padding", "causal", "causal band 64"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh", [32, 64, 80])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 63, 64, 65, 101])
def test_bf16_backward_resident_route_matches_plain(cuda, T, Dh, rate, mask):
    """The resident bf16 backward at the CPU mirror's shapes and masks
    (tests/test_torch_attention_tiling.py): each gradient within 2^-6 of
    the plain bf16 backward's max |g| and no further from f64 than 1.5
    times the plain version; one launch on the resident route's count."""
    args, do = bf16_backward_case(2, 2, T, Dh, mask, cuda, seed=T + Dh)
    seed = torch.tensor([4242], device=cuda)
    before = bf16_bwd_counts()
    got = bf16_gradients(relpos_attention.fused_relpos_attention, args, do,
                         seed, rate)
    torch.cuda.synchronize()
    assert bf16_bwd_counts() == (before[0] + 1, before[1], before[2])
    plain = bf16_gradients(relpos_attention.relpos_attention_reference, args,
                           do, seed, rate)
    f64 = bf16_gradients(relpos_attention.relpos_attention_reference, args,
                         do, seed, rate, torch.float64)

    def err(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp(min=1e-30)).item()

    for name, k, p, f in zip(("dq_u", "dq_v", "dk", "dv", "dp"), got, plain,
                             f64):
        assert k.dtype == torch.bfloat16 and torch.isfinite(k).all(), name
        assert err(k, p) <= 2.0 ** -6, (name, err(k, p))
        assert err(k, f) <= 1.5 * err(p, f) + 1e-7, (name, err(k, f),
                                                     err(p, f))


def test_bf16_backward_is_deterministic(cuda):
    """Two calls on the same inputs give identical bits: every sum across
    blocks runs in a fixed order (B8 H4 T208 Dh64, dropout 0.1)."""
    args, do = bf16_backward_case(8, 4, 208, 64, "key padding", cuda, seed=5)
    seed = torch.tensor([99], device=cuda)
    a = bf16_gradients(relpos_attention.fused_relpos_attention, args, do,
                       seed, 0.1)
    b = bf16_gradients(relpos_attention.fused_relpos_attention, args, do,
                       seed, 0.1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dh,max_t", [(1, 1696), (32, 1696), (33, 1600),
                                      (64, 1600), (65, 1424), (128, 1424)])
def test_bf16_backward_max_t_matches_the_wrapper(cuda, dh, max_t):
    """The wrapper's cutover, the resident bf16 backward's largest T as
    the built kernel computes it (``relpos_attention_bwd_bf16_max_t``), is
    the T the kernel source states (and the CPU layout mirror gives)."""
    assert relpos_attention.bf16_bwd_max_t(dh) == max_t


@pytest.mark.parametrize("past", [0, 1])
def test_bf16_backward_routes_at_the_cutover(cuda, past):
    """At the resident route's largest T and one key past it (the five
    passes): the gradients within 2^-6 of the plain bf16 backward's max
    |g| at dropout 0.1, one launch counted on the route taken; the
    resident entry refuses the longer T itself."""
    Dh = 64
    T = relpos_attention.bf16_bwd_max_t(Dh) + past
    args, do = bf16_backward_case(1, 2, T, Dh, "key padding", cuda, seed=T)
    seed = torch.tensor([7], device=cuda)
    before = bf16_bwd_counts()
    got = bf16_gradients(relpos_attention.fused_relpos_attention, args, do,
                         seed, 0.1)
    torch.cuda.synchronize()
    assert bf16_bwd_counts() == (before[0] + 1 - past, before[1] + past,
                                 before[2])
    plain = relpos_attention.relpos_attention_bwd_bf16(*args, do, 0.125,
                                                       seed, 0.1)
    for k, p in zip(got, plain):
        err = ((k.double() - p.double()).abs().max()
               / p.double().abs().max()).item()
        assert err <= 2.0 ** -6
    if past:
        outs = [torch.empty_like(args[0]) for _ in range(4)]
        stats = torch.zeros(1, 2, T, 2, device=cuda)
        scratch = torch.empty(relpos_attention._bwd_scratch_floats(
            "relpos_attention_bwd_bf16_scratch_floats")(1, 2, T, Dh),
            device=cuda)
        assert relpos_attention._bwd_kernel_bf16()(
            *(x.data_ptr() for x in args), stats.data_ptr(), do.data_ptr(),
            0, 0, 1.0, stats.data_ptr(), *(x.data_ptr() for x in outs),
            scratch.data_ptr(), torch.empty_like(args[4]).data_ptr(), 1, 2,
            T, Dh, 0.125, torch.cuda.current_stream().cuda_stream, 0) != 0
