"""The tile algebra of ``csrc/relpos_attention_{fwd,bwd}.cu``, pinned on
the CPU.

``tiled_forward`` mirrors the forward kernel: query tiles of ``qtile``
rows (the kernel's 32), key tiles of ``tile`` keys, per row group of 16 rows
the positional term as a product with the group's window rows and a
skew read, and each of the group's two warps keeping its own online
softmax state (m, l, O) over its half of every key tile, merged at the
end. It runs in f64 against ``relpos_attention_reference`` and the
plain row statistics at 1e-10.

``tiled_backward`` is a plain torch mirror of the backward kernel's three
gradient passes exactly as they are tiled: square tiles of ``tile``
queries and keys, row groups of 16 query rows, the positional term as a
product with a window of p rows followed by a skew read (per row group:
``BD[rl][15 - rl + c]``), dS written back into a zeroed skewed buffer
for dq_v, the dp pass walking the tile diagonals of one shared window
into per-(b, h, diagonal) partials, and the partials summed per p row
in a fixed order. How the kernel splits a row group's columns between
its two warps leaves these indices as they are. It runs in f64 and is
held against autograd through
``relpos_attention_reference`` at 1e-10 of each gradient's max |g|: a
wrong rel-shift, window start, diagonal or padding row shows up as an
error of the order of the gradient itself.
"""

import numpy as np
import pytest
import torch

from tsasr_torch.kernels import relpos_attention

WARP_ROWS = 16      # query rows of a row group (the m16n8k8 row tile)


def padded_rows(x, start, n):
    """Rows ``start .. start + n`` of x's dim -2, zero outside x."""
    out = x.new_zeros(*x.shape[:-2], n, x.shape[-1])
    lo, hi = max(start, 0), min(start + n, x.shape[-2])
    if hi > lo:
        out[..., lo - start:hi - start, :] = x[..., lo:hi, :]
    return out


def window_start(T, tile, i0, j0):
    """First p row of the window of the tile pair (i0, j0): the pair
    (i, j) reads p row T-1-i+j, and (i0 + tile-1, j0) reads the least."""
    return T - tile - i0 + j0


def skew_index(tile, device):
    """(16, tile) column index of a row group's BD for (row rl, key c)."""
    rl = torch.arange(WARP_ROWS, device=device)[:, None]
    c = torch.arange(tile, device=device)[None]
    return WARP_ROWS - 1 - rl + c


def pair_scores(x, i0, j0, tile):
    """dS and dropped P of one tile pair, (B, H, tile, tile), built as the
    kernel builds them, row group by row group."""
    T = x["T"]
    qu, qv, do = (padded_rows(x[n], i0, tile) for n in ("qu", "qv", "do"))
    k, v = (padded_rows(x[n], j0, tile) for n in ("k", "v"))
    win = padded_rows(x["p"], window_start(T, tile, i0, j0), 2 * tile)
    bw = tile + WARP_ROWS           # a row group's window: tile+15, padded
    idx = skew_index(tile, qu.device)
    bd = []
    for w in range(tile // WARP_ROWS):
        r0 = w * WARP_ROWS
        first = tile - WARP_ROWS - r0         # group w's first window row
        bd_w = qv[..., r0:r0 + WARP_ROWS, :] @ \
            win[:, first:first + bw].transpose(-1, -2)
        bd.append(torch.gather(bd_w, -1, idx.expand(*bd_w.shape[:2], -1, -1)))
    bd = torch.cat(bd, -2)
    i = torch.arange(i0, i0 + tile)
    j = torch.arange(j0, j0 + tile)
    valid = (i[:, None] < T) & (j[None] < T)
    ic, jc = i.clamp(max=T - 1), j.clamp(max=T - 1)
    s = ((qu @ k.transpose(-1, -2) + bd) * x["scale"]
         + x["am"][ic][:, jc] + x["kp"][:, None, None, jc])
    m, linv = (x[n][:, :, ic, None] for n in ("m", "linv"))
    prob = torch.exp(s - m) * linv
    dpd = do @ v.transpose(-1, -2)
    if x["keep"] is not None:
        keep = x["keep"][:, :, ic][..., jc]
        pd = torch.where(keep, prob * x["keep_scale"], 0.0)
        dpd = torch.where(keep, dpd * x["keep_scale"], 0.0)
    else:
        pd = prob
    ds = prob * (dpd - x["delta"][:, :, ic, None]) * x["scale"]
    return torch.where(valid, ds, 0.0), torch.where(valid, pd, 0.0)


def dq_pass(x, tile):
    """One block per query tile over all key tiles: dq_u += dS k, and
    dq_v += dSk win, with dSk the row group's zeroed skewed buffer."""
    T, nt = x["T"], -(-x["T"] // tile)
    bw = tile + WARP_ROWS
    idx = skew_index(tile, x["qu"].device)
    dqu, dqv = torch.zeros_like(x["qu"]), torch.zeros_like(x["qv"])
    for it in range(nt):
        i0 = it * tile
        gu = x["qu"].new_zeros(*x["qu"].shape[:2], tile, x["qu"].shape[-1])
        gv = torch.zeros_like(gu)
        for jt in range(nt):
            j0 = jt * tile
            ds, _ = pair_scores(x, i0, j0, tile)
            gu += ds @ padded_rows(x["k"], j0, tile)
            win = padded_rows(x["p"], window_start(T, tile, i0, j0), 2 * tile)
            for w in range(tile // WARP_ROWS):
                r0 = w * WARP_ROWS
                first = tile - WARP_ROWS - r0
                dsk = ds.new_zeros(*ds.shape[:2], WARP_ROWS, bw)
                dsk.scatter_(-1, idx.expand(*ds.shape[:2], -1, -1),
                             ds[..., r0:r0 + WARP_ROWS, :])
                gv[..., r0:r0 + WARP_ROWS, :] += \
                    dsk @ win[None, :, first:first + bw]
        n = min(tile, T - i0)
        dqu[..., i0:i0 + n, :] = gu[..., :n, :]
        dqv[..., i0:i0 + n, :] = gv[..., :n, :]
    return dqu, dqv


def dkv_pass(x, tile):
    """One block per key tile over all query tiles: dv += Pd^T do and
    dk += dS^T q_u, both read transposed from the score tile."""
    T, nt = x["T"], -(-x["T"] // tile)
    dk, dv = torch.zeros_like(x["k"]), torch.zeros_like(x["v"])
    for jt in range(nt):
        j0 = jt * tile
        gk = x["k"].new_zeros(*x["k"].shape[:2], tile, x["k"].shape[-1])
        gv = torch.zeros_like(gk)
        for it in range(nt):
            i0 = it * tile
            ds, pd = pair_scores(x, i0, j0, tile)
            gv += pd.transpose(-1, -2) @ padded_rows(x["do"], i0, tile)
            gk += ds.transpose(-1, -2) @ padded_rows(x["qu"], i0, tile)
        n = min(tile, T - j0)
        dk[..., j0:j0 + n, :] = gk[..., :n, :]
        dv[..., j0:j0 + n, :] = gv[..., :n, :]
    return dk, dv


def dp_pass(x, tile):
    """Per (tile diagonal d = (j0 - i0) / tile, h, b; a kernel block
    walks two diagonals, d and d - nt, to even out the pairs): every
    pair on the diagonal shares the window starting at T - tile + d tile,
    so dp_win += dSk^T q_v accumulates over the diagonal into one
    partial, (2 tile) rows of the window. Then the sum pass:
    p row r takes the diagonals d_hi = floor((r - (T - tile)) / tile) and
    d_hi - 1 whose windows hold it, in that order, each over b in order."""
    T, nt = x["T"], -(-x["T"] // tile)
    B, H, _, Dh = x["qv"].shape
    win_rows = 2 * tile
    parts = x["qv"].new_zeros(B, H, 2 * nt - 1, win_rows, Dh)
    r = torch.arange(tile)[:, None]
    c = torch.arange(tile)[None]
    col = (tile - 1 - r + c).expand(B, H, -1, -1)
    for d in range(-(nt - 1), nt):
        acc = x["qv"].new_zeros(B, H, win_rows, Dh)
        for it in range(nt):
            i0, j0 = it * tile, (it + d) * tile
            if not 0 <= j0 < T:
                continue
            ds, _ = pair_scores(x, i0, j0, tile)
            dsk = ds.new_zeros(B, H, tile, win_rows).scatter_(-1, col, ds)
            acc += dsk.transpose(-1, -2) @ padded_rows(x["qv"], i0, tile)
        parts[:, :, d + nt - 1] = acc
    dp = x["p"].new_zeros(x["p"].shape)
    for row in range(2 * T - 1):
        d_hi = (row - (T - tile)) // tile
        for d in (d_hi - 1, d_hi):
            first = T - tile + d * tile
            if -(nt - 1) <= d <= nt - 1 and 0 <= row - first < win_rows:
                for b in range(B):
                    dp[:, row] += parts[b, :, d + nt - 1, row - first]
    return dp


def row_stats(args, scale):
    """Plain row max and 1 / row sum of exp(s - max) of the scores."""
    qu, qv, k, v, p, kp, am = args
    ac = qu @ k.transpose(-1, -2)
    bd = relpos_attention.rel_shift(torch.einsum("bhtd,hsd->bhts", qv, p),
                                    qu.shape[2])
    s = (ac + bd) * scale + am + kp[:, None, None]
    m = s.max(-1).values
    return m, 1.0 / torch.exp(s - m[..., None]).sum(-1)


def warp_state(x, i0, r0, hf, tile, qtile):
    """One warp's online softmax over its half ``hf`` of every key tile,
    for the 16 query rows i0 + r0 ...: (m, l, O), m = -inf while the
    warp has seen no key below T."""
    T, qu, qv, B, H = x["T"], x["qu"], x["qv"], *x["qu"].shape[:2]
    half, bw = tile // 2, tile + WARP_ROWS
    first = qtile - WARP_ROWS - r0           # the group's first window row
    idx = skew_index(tile, qu.device).expand(B, H, -1, -1)
    q_u, q_v = (padded_rows(t, i0 + r0, WARP_ROWS) for t in (qu, qv))
    i = torch.arange(i0 + r0, i0 + r0 + WARP_ROWS)
    ic = i.clamp(max=T - 1)
    m = qu.new_full((B, H, WARP_ROWS), -torch.inf)
    l = qu.new_zeros(B, H, WARP_ROWS)
    o = qu.new_zeros(B, H, WARP_ROWS, qu.shape[-1])
    for j0 in range(0, T, tile):
        win = padded_rows(x["p"], window_start(T, qtile, i0, j0),
                          qtile + tile)
        bd = q_v @ win[:, first:first + bw].transpose(-1, -2)
        bd = torch.gather(bd, -1, idx)[..., hf * half:(hf + 1) * half]
        c0 = j0 + hf * half
        k, v = (padded_rows(x[n], c0, half) for n in ("k", "v"))
        j = torch.arange(c0, c0 + half)
        jc = j.clamp(max=T - 1)
        s = ((q_u @ k.transpose(-1, -2) + bd) * x["scale"]
             + x["am"][ic][:, jc] + x["kp"][:, None, None, jc])
        s = torch.where(j < T, s, -torch.inf)
        mx = torch.maximum(m, s.max(-1).values)
        mu = torch.where(mx == -torch.inf, 0.0, mx)   # no exp(-inf + inf)
        corr = torch.exp(m - mu)
        e = torch.exp(s - mu[..., None])
        l = l * corr + e.sum(-1)
        pd = e
        if x["keep"] is not None:
            keep = x["keep"][:, :, ic][..., jc]
            valid = (i[:, None] < T) & (j[None] < T)
            pd = torch.where(valid, torch.where(keep, e * x["keep_scale"],
                                                0.0), e)
        o = o * corr[..., None] + pd @ v
        m = mx
    return m, l, o


def tiled_forward(args, scale, seed, rate, tile, qtile):
    """out (B, H, T, Dh) and the row statistics m, 1 / l (B, H, T) of the
    fused attention through the forward kernel's tiling: per row group,
    the two warp halves' states merged as m = max(m0, m1), l = l0 w0 +
    l1 w1 and O = O0 w0 + O1 w1 with w = exp(m_half - m)."""
    qu, qv, k, v, p, kp, am = args
    B, H, T, _ = qu.shape
    x = dict(T=T, qu=qu, qv=qv, k=k, v=v, p=p, kp=kp, am=am, scale=scale,
             keep=None, keep_scale=1.0)
    if rate > 0.0:
        x["keep"] = relpos_attention.philox_keep_mask(seed, B, H, T, rate)
        x["keep_scale"] = 1.0 / (1.0 - rate)
    out = torch.zeros_like(qu)
    m_out, linv_out = qu.new_zeros(B, H, T), qu.new_zeros(B, H, T)
    for i0 in range(0, T, qtile):
        for r0 in range(0, qtile, WARP_ROWS):
            n = min(WARP_ROWS, T - i0 - r0)
            if n <= 0:
                continue
            (m0, l0, o0), (m1, l1, o1) = (
                warp_state(x, i0, r0, hf, tile, qtile) for hf in (0, 1))
            m = torch.maximum(m0, m1)
            w0, w1 = torch.exp(m0 - m), torch.exp(m1 - m)
            linv = 1.0 / (l0 * w0 + l1 * w1)
            o = (o0 * w0[..., None] + o1 * w1[..., None]) * linv[..., None]
            rows = slice(i0 + r0, i0 + r0 + n)
            out[..., rows, :] = o[..., :n, :]
            m_out[..., rows], linv_out[..., rows] = m[..., :n], linv[..., :n]
    return out, m_out, linv_out


def tiled_backward(args, do, scale, seed, rate, tile, stats=None):
    """dq_u, dq_v, dk, dv, dp of the fused attention through the tiled
    passes, from the forward's row statistics (max, 1 / sum): ``stats``,
    or the plain ones."""
    qu, qv, k, v, p, kp, am = args
    B, H, T, _ = qu.shape
    m, linv = stats if stats is not None else row_stats(args, scale)
    out = relpos_attention.relpos_attention_reference(*args, scale, seed, rate)
    x = dict(T=T, qu=qu, qv=qv, k=k, v=v, p=p, kp=kp, am=am, do=do,
             scale=scale, m=m, linv=linv, delta=(do * out).sum(-1),
             keep=None, keep_scale=1.0)
    if rate > 0.0:
        x["keep"] = relpos_attention.philox_keep_mask(seed, B, H, T, rate)
        x["keep_scale"] = 1.0 / (1.0 - rate)
    return (*dq_pass(x, tile), *dkv_pass(x, tile), dp_pass(x, tile))


SCALE, SEED = 0.125, 99


def attention_case(T, Dh, rng_seed, B=2, H=2):
    """f64 inputs and an output gradient; key padding (one utterance at a
    third of T, so with the band its late rows have every key masked) and
    a band of half-width 7."""
    rng = np.random.default_rng(rng_seed)
    qu, qv, k, v, do = (torch.from_numpy(rng.normal(size=(B, H, T, Dh)))
                        for _ in range(5))
    p = torch.from_numpy(rng.normal(size=(H, 2 * T - 1, Dh)))
    lens = torch.tensor([T, max(1, T // 3)])
    kp = torch.where(torch.arange(T)[None] < lens[:, None], 0.0, -1e9)
    am = torch.where((torch.arange(T)[:, None] - torch.arange(T)[None]).abs()
                     > 7, -1e9, 0.0).double()
    return [qu, qv, k, v, p, kp.double(), am], do


def assert_close(name, got, want):
    """Within 1e-10 of max(1, max |want|): f64 on both sides, so only an
    index error can move it."""
    tol = 1e-10 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, f"{name}: max abs err {err:.3g} > {tol:.3g}"


def autograd_grads(args, do, rate):
    leaves = [a.clone().requires_grad_(i < 5) for i, a in enumerate(args)]
    out = relpos_attention.relpos_attention_reference(*leaves, SCALE, SEED,
                                                      rate)
    return torch.autograd.grad(out, leaves[:5], do)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh", [5, 64])
@pytest.mark.parametrize("T", [10, 17, 33, 45, 64, 130, 208, 301])
def test_tiled_forward_matches_reference(T, Dh, rate):
    """out against the plain version, m and 1 / l against the plain row
    statistics (each row's to 1e-10 of max(1, |m|): fully masked rows
    have m ~ -1e9). The kernel's tiles, 32 query rows and 32 keys: at
    T 10 the second warp half sees no key below T; T 17 leaves the
    second row group one row, T 33 a second query and key tile of one;
    at T 45, 130, 208 and 301 the last query tile has rows past T."""
    args, _ = attention_case(T, Dh, T * 1000 + Dh)
    out, m, linv = tiled_forward(args, SCALE, SEED, rate, 32, 32)
    assert_close("out", out,
                 relpos_attention.relpos_attention_reference(*args, SCALE,
                                                             SEED, rate))
    m_want, linv_want = row_stats(args, SCALE)
    if T >= 45:
        assert m_want.min().item() < -1e8      # a fully masked row
    assert ((m - m_want).abs() <= 1e-10 * m_want.abs().clamp(min=1.0)).all()
    assert ((linv - linv_want).abs() <= 1e-10 * linv_want).all()


def test_tiled_backward_from_tiled_forward_stats():
    """The backward's passes fed the forward mirror's statistics, as the
    kernels are chained in training."""
    T, rate = 130, 0.1
    args, do = attention_case(T, 64, 7)
    _, m, linv = tiled_forward(args, SCALE, SEED, rate, 32, 32)
    got = tiled_backward(args, do, SCALE, SEED, rate, 64, stats=(m, linv))
    for name, g, w in zip(("dq_u", "dq_v", "dk", "dv", "dp"), got,
                          autograd_grads(args, do, rate)):
        assert_close(name, g, w)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh", [5, 64])
@pytest.mark.parametrize("tile", [16, 64])
@pytest.mark.parametrize("T", [10, 45, 130, 208])
def test_tiled_backward_matches_autograd(T, tile, Dh, rate):
    """f64 on both sides, so 1e-10 of each gradient's max |g| (at least
    1): only an index error can move it."""
    args, do = attention_case(T, Dh, T * 1000 + tile * 10 + Dh)
    got = tiled_backward(args, do, SCALE, SEED, rate, tile)
    for name, g, w in zip(("dq_u", "dq_v", "dk", "dv", "dp"), got,
                          autograd_grads(args, do, rate)):
        assert_close(name, g, w)
