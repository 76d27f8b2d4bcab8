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

``tiled_forward_bf16`` mirrors the bf16 forward's resident kernel: a
block's rows of scores in one buffer, the positional term written skewed
over each row's whole window (window row w meets row r at key w + r -
(qtile - 1)), q_u k^T added in place, the exact row max and sum, P
normalised, dropped and then rounded to bf16, and P v summed in f32 in
the kernel's key order, k-steps of 16. Its scores run in f64 (the inputs
bf16 values), so its statistics meet the plain f64 ones at 1e-10 and its
output the plain bf16 version's within one bf16 ulp of max |o|.

The mirrors compute the kernels' blocks, warps and row groups side by
side, as tensors; only the k-steps that a block takes in order (the key
tiles of a query tile, the query tiles of a key tile or a diagonal) are
Python loops, so every ordered sum is summed in the kernel's order.
"""

import numpy as np
import pytest
import torch

from tsasr_torch.kernels import relpos_attention

WARP_ROWS = 16      # query rows of a row group (the m16n8k8 row tile)
# the bf16 forward's resident kernel (Res16 in csrc/relpos_attention_fwd.cu):
# query rows of a block, rows of a stage, stages, and the shared memory a
# block may use
BF16_ROWS, BF16_CHUNK, BF16_STAGES = 16, 64, 2
SMEM_LIMIT = 232448


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: beside other test processes a multi-threaded
    op's wait for all its threads costs more than the op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rows_at(x, starts, n):
    """Rows ``starts[k] .. starts[k] + n`` of x's dim -2 for each k,
    zero outside x: (..., K, n, D)."""
    idx = torch.as_tensor(starts)[:, None] + torch.arange(n)
    inside = (idx >= 0) & (idx < x.shape[-2])
    got = x[..., idx.clamp(0, x.shape[-2] - 1), :]
    return torch.where(inside[..., None], got, 0.0)


def window_start(T, tile, i0, j0):
    """First p row of the window of the tile pair (i0, j0): the pair
    (i, j) reads p row T-1-i+j, and (i0 + tile-1, j0) reads the least."""
    return T - tile - i0 + j0


def skew_index(tile, device):
    """(16, tile) column index of a row group's BD for (row rl, key c)."""
    rl = torch.arange(WARP_ROWS, device=device)[:, None]
    c = torch.arange(tile, device=device)[None]
    return WARP_ROWS - 1 - rl + c


def group_windows(p, starts, tile):
    """Each row group's window rows of p for the tile pairs whose windows
    start at ``starts`` (K,): group w reads ``tile + 16`` rows from its
    first row ``tile - 16 - 16 w`` of the pair's window. (H, K, G, tile
    + 16, Dh)."""
    G = tile // WARP_ROWS
    first = tile - WARP_ROWS - WARP_ROWS * torch.arange(G)
    rows = rows_at(p, (starts[:, None] + first).reshape(-1),
                   tile + WARP_ROWS)
    return rows.reshape(p.shape[0], len(starts), G, tile + WARP_ROWS, -1)


def pair_scores(x, i0, j0, tile):
    """dS and dropped P of the tile pairs (i0[k], j0[k]), (B, H, K,
    tile, tile), each built as the kernel builds it, row group by row
    group (the groups and the pairs side by side)."""
    T = x["T"]
    qu, qv, do = (rows_at(x[n], i0, tile) for n in ("qu", "qv", "do"))
    k, v = (rows_at(x[n], j0, tile) for n in ("k", "v"))
    B, H, K, _, Dh = qu.shape
    G = tile // WARP_ROWS
    win = group_windows(x["p"], window_start(T, tile, i0, j0), tile)
    bd = qv.reshape(B, H, K, G, WARP_ROWS, Dh) @ win.transpose(-1, -2)
    idx = skew_index(tile, qu.device).expand(B, H, K, G, -1, -1)
    bd = torch.gather(bd, -1, idx).reshape(B, H, K, tile, tile)
    i = i0[:, None] + torch.arange(tile)                    # (K, tile)
    j = j0[:, None] + torch.arange(tile)
    valid = (i[:, :, None] < T) & (j[:, None, :] < T)
    ic, jc = i.clamp(max=T - 1), j.clamp(max=T - 1)
    s = ((qu @ k.transpose(-1, -2) + bd) * x["scale"]
         + x["am"][ic[:, :, None], jc[:, None, :]]
         + x["kp"][:, jc][:, None, :, None, :])
    m, linv = (x[n][:, :, ic, None] for n in ("m", "linv"))
    prob = torch.exp(s - m) * linv
    dpd = do @ v.transpose(-1, -2)
    if x["keep"] is not None:
        keep = x["keep"][:, :, ic[:, :, None], jc[:, None, :]]
        pd = torch.where(keep, prob * x["keep_scale"], 0.0)
        dpd = torch.where(keep, dpd * x["keep_scale"], 0.0)
    else:
        pd = prob
    ds = prob * (dpd - x["delta"][:, :, ic, None]) * x["scale"]
    return torch.where(valid, ds, 0.0), torch.where(valid, pd, 0.0)


def all_pair_scores(x, tile):
    """dS and dropped P of every tile pair, (B, H, nt, nt, tile, tile):
    query tile first, key tile second."""
    nt = -(-x["T"] // tile)
    i0 = torch.arange(nt).repeat_interleave(nt) * tile
    j0 = torch.arange(nt).repeat(nt) * tile
    ds, pd = pair_scores(x, i0, j0, tile)
    B, H = ds.shape[:2]
    return (ds.reshape(B, H, nt, nt, tile, tile),
            pd.reshape(B, H, nt, nt, tile, tile))


def dq_pass(x, ds, tile):
    """One block per query tile (the blocks side by side) over the key
    tiles in order: dq_u += dS k, and dq_v += dSk win, with dSk each row
    group's zeroed skewed buffer."""
    T, nt = x["T"], -(-x["T"] // tile)
    B, H, _, Dh = x["qu"].shape
    G, bw = tile // WARP_ROWS, tile + WARP_ROWS
    i0 = torch.arange(nt) * tile
    idx = skew_index(tile, x["qu"].device).expand(B, H, nt, G, -1, -1)
    gu = x["qu"].new_zeros(B, H, nt, tile, Dh)
    gv = torch.zeros_like(gu)
    for jt in range(nt):                 # the kernel's k-steps, in order
        j0 = jt * tile
        d = ds[:, :, :, jt]                          # (B, H, nt, tile, tile)
        gu += d @ rows_at(x["k"], [j0], tile)
        win = group_windows(x["p"], window_start(T, tile, i0, j0), tile)
        dsk = d.new_zeros(B, H, nt, G, WARP_ROWS, bw).scatter_(
            -1, idx, d.reshape(B, H, nt, G, WARP_ROWS, tile))
        gv += (dsk @ win).reshape(B, H, nt, tile, Dh)
    return (gu.reshape(B, H, nt * tile, Dh)[:, :, :T],
            gv.reshape(B, H, nt * tile, Dh)[:, :, :T])


def dkv_pass(x, ds, pd, tile):
    """One block per key tile (the blocks side by side) over the query
    tiles in order: dv += Pd^T do and dk += dS^T q_u, both read
    transposed from the score tile."""
    T, nt = x["T"], -(-x["T"] // tile)
    B, H, _, Dh = x["k"].shape
    gk = x["k"].new_zeros(B, H, nt, tile, Dh)
    gv = torch.zeros_like(gk)
    for it in range(nt):
        i0 = it * tile
        gv += pd[:, :, it].transpose(-1, -2) @ rows_at(x["do"], [i0], tile)
        gk += ds[:, :, it].transpose(-1, -2) @ rows_at(x["qu"], [i0], tile)
    return (gk.reshape(B, H, nt * tile, Dh)[:, :, :T],
            gv.reshape(B, H, nt * tile, Dh)[:, :, :T])


def dp_pass(x, ds, tile):
    """Per (tile diagonal d = (j0 - i0) / tile, h, b; a kernel block
    walks two diagonals, d and d - nt, to even out the pairs): every
    pair on the diagonal shares the window starting at T - tile + d tile,
    so dp_win += dSk^T q_v accumulates over the diagonal, in order of
    its query tiles, into one partial, (2 tile) rows of the window (the
    diagonals side by side). Then the sum pass: p row r takes the
    diagonals d_hi = floor((r - (T - tile)) / tile) and d_hi - 1 whose
    windows hold it, in that order, each over b in order."""
    T, nt = x["T"], -(-x["T"] // tile)
    B, H, _, Dh = x["qv"].shape
    win_rows, n_diag = 2 * tile, 2 * nt - 1
    parts = x["qv"].new_zeros(B, H, n_diag, win_rows, Dh)
    r = torch.arange(tile)[:, None]
    c = torch.arange(tile)[None]
    col = (tile - 1 - r + c).expand(B, H, n_diag, -1, -1)
    diag = torch.arange(-(nt - 1), nt)
    for it in range(nt):
        jt = it + diag
        on = ((jt >= 0) & (jt < nt))[:, None, None]
        d = torch.where(on, ds[:, :, it, jt.clamp(0, nt - 1)], 0.0)
        dsk = d.new_zeros(B, H, n_diag, tile, win_rows).scatter_(-1, col, d)
        parts += dsk.transpose(-1, -2) @ rows_at(x["qv"], [it * tile], tile)
    rows = torch.arange(2 * T - 1)
    d_hi = (rows - (T - tile)) // tile
    dp = x["p"].new_zeros(x["p"].shape)
    for d in (d_hi - 1, d_hi):
        at = rows - (T - tile + d * tile)
        on = (d >= -(nt - 1)) & (d <= nt - 1) & (at >= 0) & (at < win_rows)
        got = parts[:, :, (d + nt - 1).clamp(0, n_diag - 1),
                    at.clamp(0, win_rows - 1)]
        got = torch.where(on[:, None], got, 0.0)
        for b in range(B):
            dp += got[b]
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


def warp_states(x, tile, qtile):
    """Every warp's online softmax over its half ``hf`` of every key
    tile, in order, for the 16 query rows of its row group (all row
    groups of all query tiles and both halves side by side): (m, l, O)
    of shape (B, H, NG, 2, 16[, Dh]); m = -inf while a warp has seen no
    key below T."""
    T, qu, qv = x["T"], x["qu"], x["qv"]
    B, H, _, Dh = qu.shape
    half, bw = tile // 2, tile + WARP_ROWS
    R = torch.arange(0, -(-T // qtile) * qtile, WARP_ROWS)  # groups' rows
    NG = len(R)
    idx = skew_index(tile, qu.device).expand(B, H, NG, -1, -1)
    q_u, q_v = (rows_at(t, R, WARP_ROWS) for t in (qu, qv))
    i = (R[:, None] + torch.arange(WARP_ROWS))[:, None, :, None]
    ic = i.clamp(max=T - 1)
    m = qu.new_full((B, H, NG, 2, WARP_ROWS), -torch.inf)
    l = qu.new_zeros(B, H, NG, 2, WARP_ROWS)
    o = qu.new_zeros(B, H, NG, 2, WARP_ROWS, Dh)
    for j0 in range(0, T, tile):         # the kernel's k-steps, in order
        # the group's first window row: T - 16 - R + j0
        win = rows_at(x["p"], T - WARP_ROWS - R + j0, bw)
        bd = torch.gather(q_v @ win.transpose(-1, -2), -1, idx)
        bd = bd.reshape(B, H, NG, WARP_ROWS, 2, half).transpose(3, 4)
        k, v = (rows_at(x[n], [j0, j0 + half], half) for n in ("k", "v"))
        j = (j0 + torch.arange(tile)).reshape(2, 1, half)
        jc = j.clamp(max=T - 1)
        s = ((q_u[:, :, :, None] @ k[:, :, None].transpose(-1, -2) + bd)
             * x["scale"] + x["am"][ic, jc] + x["kp"][:, jc][:, None, None])
        s = torch.where(j < T, s, -torch.inf)
        mx = torch.maximum(m, s.max(-1).values)
        mu = torch.where(mx == -torch.inf, 0.0, mx)   # no exp(-inf + inf)
        corr = torch.exp(m - mu)
        e = torch.exp(s - mu[..., None])
        l = l * corr + e.sum(-1)
        pd = e
        if x["keep"] is not None:
            keep = x["keep"][:, :, ic, jc]
            valid = (i < T) & (j < T)
            pd = torch.where(valid, torch.where(keep, e * x["keep_scale"],
                                                0.0), e)
        o = o * corr[..., None] + pd @ v[:, :, None]
        m = mx
    return m, l, o


def tiled_forward(args, scale, seed, rate, tile, qtile):
    """out (B, H, T, Dh) and the row statistics m, 1 / l (B, H, T) of the
    fused attention through the forward kernel's tiling: per row group,
    the two warp halves' states merged as m = max(m0, m1), l = l0 w0 +
    l1 w1 and O = O0 w0 + O1 w1 with w = exp(m_half - m)."""
    qu, qv, k, v, p, kp, am = args
    B, H, T, Dh = qu.shape
    x = dict(T=T, qu=qu, qv=qv, k=k, v=v, p=p, kp=kp, am=am, scale=scale,
             keep=None, keep_scale=1.0)
    if rate > 0.0:
        x["keep"] = relpos_attention.philox_keep_mask(seed, B, H, T, rate)
        x["keep_scale"] = 1.0 / (1.0 - rate)
    (m0, m1), (l0, l1), (o0, o1) = (t.unbind(3) for t in
                                    warp_states(x, tile, qtile))
    m = torch.maximum(m0, m1)
    w0, w1 = torch.exp(m0 - m), torch.exp(m1 - m)
    linv = 1.0 / (l0 * w0 + l1 * w1)
    o = (o0 * w0[..., None] + o1 * w1[..., None]) * linv[..., None]
    return (o.reshape(B, H, -1, Dh)[:, :, :T],
            m.reshape(B, H, -1)[:, :, :T], linv.reshape(B, H, -1)[:, :, :T])


def tiled_backward(args, do, scale, seed, rate, tile, stats=None):
    """dq_u, dq_v, dk, dv, dp of the fused attention through the tiled
    passes, from the forward's row statistics (max, 1 / sum): ``stats``,
    or the plain ones. Each pair's score tile is built once and read by
    all three passes."""
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
    ds, pd = all_pair_scores(x, tile)
    return (*dq_pass(x, ds, tile), *dkv_pass(x, ds, pd, tile),
            dp_pass(x, ds, tile))


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


# ----------------------------------------------- the bf16 resident forward
def tiled_forward_bf16(args, scale, keep, rate, dtype,
                       qtile=BF16_ROWS, chunk=BF16_CHUNK):
    """out (B, H, T, Dh) in bf16 and the row statistics m, 1 / l (B, H,
    T) through the resident bf16 forward's algebra, its blocks of
    ``qtile`` rows side by side: the window, then k, then the softmax,
    then v. The kernel streams each in chunks of ``chunk`` rows; each
    score is written once, so only the window's length (whole chunks)
    and P v's order (k-steps of 16) depend on them. ``args`` hold bf16
    values; ``keep`` is the dropout's (B, H, T, T) keep mask (None at
    rate 0); the scores and the softmax run in ``dtype``: f32 as the
    kernel (a fully masked row's scores, about -1e9, keep an ulp of 64
    there), f64 to meet the plain f64 statistics."""
    qu, qv, k, v, p, kp, am = (x.to(dtype) for x in args)
    B, H, T, Dh = qu.shape
    tp = -(-T // 16) * 16                       # keys in whole k-steps
    i0 = torch.arange(0, T, qtile)
    q_u, q_v = (rows_at(t, i0, qtile) for t in (qu, qv))  # (B, H, NB, TQ, Dh)
    # 1. the window: row w is p row T - qtile - i0 + w and meets row r at
    # key w + r - (qtile - 1); each product stored there, once
    nw = -(-(T + qtile - 1) // chunk) * chunk
    bd = q_v @ rows_at(p, T - qtile - i0, nw).transpose(-1, -2)
    r = torch.arange(qtile)[:, None]
    c = torch.arange(nw)[None] + r - (qtile - 1)
    rr, ww = torch.nonzero((c >= 0) & (c < T), as_tuple=True)
    s = qu.new_zeros(*q_u.shape[:-1], T)        # the block's scores
    s[..., rr, c[rr, ww]] = bd[..., rr, ww]
    # 2. q_u k^T added in place
    s = (q_u @ k[:, :, None].transpose(-1, -2) + s) * scale
    i = i0[:, None] + torch.arange(qtile)       # 3. the softmax
    ic = i.clamp(max=T - 1)
    s = s + am[ic] + kp[:, None, None, None, :]
    m = s.max(-1).values
    e = torch.exp(s - m[..., None])
    linv = 1.0 / e.sum(-1)
    prob = e * linv[..., None]
    if rate > 0.0:
        prob = torch.where((i < T)[..., None],
                           torch.where(keep[:, :, ic], prob / (1.0 - rate),
                                       0.0), prob)
    pb = prob.new_zeros(*prob.shape[:-1], tp).to(torch.bfloat16)
    pb[..., :T] = prob.to(torch.bfloat16)
    vb = rows_at(v, [0], tp).float()            # zeros past T
    o = torch.zeros(*q_u.shape, dtype=torch.float32)
    for k0 in range(0, tp, 16):                 # 4. O += P v, in key order
        o += pb[..., k0:k0 + 16].float() @ vb[..., k0:k0 + 16, :]
    return (o.to(torch.bfloat16).reshape(B, H, -1, Dh)[:, :, :T],
            m.reshape(B, H, -1)[:, :, :T], linv.reshape(B, H, -1)[:, :, :T])


def bf16_case(T, Dh, rng_seed, B=2, H=2):
    """``attention_case``'s inputs rounded to bf16 values, held in f64;
    at B 1 the utterance padded to a third of T."""
    args, _ = attention_case(T, Dh, rng_seed, max(B, 2), H)
    args[:5] = [x[:B].to(torch.bfloat16).double() for x in args[:4]] + [
        args[4].to(torch.bfloat16).double()]
    args[5] = args[5][-B:]
    return args


def assert_bf16_forward(args, rate):
    """The mirror's output, its scores in f32, within one bf16 ulp of the
    plain bf16 version's max |o|; its statistics, in f64, at 1e-10 of the
    plain f64 ones."""
    B, H, T, _ = args[0].shape
    keep = relpos_attention.philox_keep_mask(SEED, B, H, T, rate) \
        if rate > 0.0 else None
    out, _, _ = tiled_forward_bf16(args, SCALE, keep, rate, torch.float32)
    plain = relpos_attention.relpos_attention_fwd_bf16(
        *[x.to(torch.bfloat16) for x in args[:5]], *[x.float() for x in
                                                    args[5:]],
        SCALE, SEED, rate).double()
    top = plain.abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = (out.double() - plain).abs().max().item()
    assert err <= ulp, f"out: max abs err {err:.3g} > one bf16 ulp {ulp:.3g}"
    _, m, linv = tiled_forward_bf16(args, SCALE, keep, rate, torch.float64)
    m_want, linv_want = row_stats(args, SCALE)
    assert ((m - m_want).abs() <= 1e-10 * m_want.abs().clamp(min=1.0)).all()
    assert ((linv - linv_want).abs() <= 1e-10 * linv_want).all()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh", [5, 64])
@pytest.mark.parametrize("T", [10, 16, 17, 47, 64, 65, 130, 208])
def test_tiled_forward_bf16_matches_plain(T, Dh, rate):
    """The resident bf16 forward's algebra at the tile edges: 16-row
    blocks (T 16 and 17: one row past a block; T 10, 47, 130, 208: the
    last block has rows past T), 64-row chunks (T 64 and 65: a key
    chunk of one, a window of 79 or 80 rows), keys padded to k-steps of
    16; key padding and a band leave rows with every key masked."""
    assert_bf16_forward(bf16_case(T, Dh, T * 1000 + Dh), rate)


def resident_tile_bytes(dh):
    """A resident block's bf16 q_u and q_v tiles and stages, rows ``DP +
    8`` apart (DP: dh padded to 32, 64 or 128)."""
    dp = 32 if dh <= 32 else 64 if dh <= 64 else 128
    return 2 * (2 * BF16_ROWS + BF16_STAGES * BF16_CHUNK) * (dp + 8)


def resident_block_bytes(T, dh):
    """A resident block's shared memory at T keys: its f32 scores,
    ``BF16_ROWS`` rows of ``roundup(T, 16) + 4`` floats, beside its
    tiles."""
    return 4 * BF16_ROWS * (-(-T // 16) * 16 + 4) + resident_tile_bytes(dh)


def resident_max_t(dh):
    """The largest T whose resident block fits ``SMEM_LIMIT``."""
    ld = (SMEM_LIMIT - resident_tile_bytes(dh)) // (4 * BF16_ROWS)
    return (ld - 4) // 16 * 16


def test_tiled_forward_bf16_at_the_cutover():
    """At the largest T of the resident route (Dh 5, padded to 32): the
    index algebra of the widest rows of scores a block holds, one padded
    utterance, dropout 0 (the keep mask's int64 Philox over 11.7 M
    elements would take seconds; the drop is the same code at every T,
    held at the tile edges above)."""
    T = resident_max_t(5)
    assert_bf16_forward(bf16_case(T, 5, 11, B=1, H=1), 0.0)


@pytest.mark.parametrize("dh,max_t", [(1, 3424), (32, 3424), (33, 3264),
                                      (64, 3264), (65, 2944), (128, 2944)])
def test_bf16_forward_takes_the_long_route_past_the_cutover(dh, max_t,
                                                            monkeypatch):
    """The wrapper's route for the bf16 forward: resident up to the T
    whose block of scores and bf16 tiles fill the 227 KB a block may use
    (the kernel source states these T, and its C entry
    ``relpos_attention_fwd_bf16_max_t`` returns them on the card), the
    two-pass kernel from the next T on. Here the wrapper asks a stand-in
    for the built kernel that answers with this layout's T."""
    assert resident_block_bytes(max_t, dh) <= SMEM_LIMIT \
        < resident_block_bytes(max_t + 1, dh)
    assert resident_max_t(dh) == max_t
    ra = relpos_attention

    class Kernel:
        @staticmethod
        def relpos_attention_fwd_bf16_max_t(d):
            return resident_max_t(d)

    monkeypatch.setattr(ra._build, "load", lambda source: Kernel)
    ra.bf16_fwd_max_t.cache_clear()
    try:
        assert ra.bf16_fwd_max_t(dh) == max_t
        assert ra.bf16_fwd_route(max_t, dh) == "resident"
        assert ra.bf16_fwd_route(max_t + 1, dh) == "long"
    finally:
        ra.bf16_fwd_max_t.cache_clear()


# ---------------------------------------------- the bf16 resident backward
def tiled_backward_bf16(args, do, scale, keep, rate, dtype, stats,
                        rounded=True, qtile=BF16_ROWS):
    """dq_u, dq_v, dk, dv, dp through the resident bf16 backward's three
    passes. (1) rows: blocks of ``qtile`` query rows side by side, each
    score built once as the resident forward builds it (the window's
    products gathered from their skewed places, q_u k^T added, the masks
    in the plain version's order), P = exp(s - m) / l from ``stats`` (m,
    1 / l), the dropped Pd and dP, D exactly over the row, dS = P (dP - D)
    scale: the scratch. (2) columns: dS and Pd as (tile, tile) tiles of
    the scratch (tile 64 at Dh <= 64, else 32), dq_u and dq_v by
    ``dq_pass``, dk and dv by ``dkv_pass``, dp's diagonal partials by
    ``dp_pass``; (3) their ordered sum, in ``dp_pass``. ``args`` and
    ``do`` hold bf16 values; ``keep`` is the (B, H, T, T) keep mask (None
    at rate 0). With ``rounded`` dS, Pd and the gradients are rounded to
    bf16 where the kernel rounds them; the rest runs in ``dtype``."""
    qu, qv, k, v, p, kp, am = (x.to(dtype) for x in args)
    do = do.to(dtype)
    B, H, T, Dh = qu.shape

    def rnd(x):
        return x.to(torch.bfloat16).to(dtype) if rounded else x

    i0 = torch.arange(0, T, qtile)
    q_u, q_v, d_o = (rows_at(t, i0, qtile) for t in (qu, qv, do))
    i = i0[:, None] + torch.arange(qtile)        # (NB, TQ)
    ic = i.clamp(max=T - 1)
    r = torch.arange(qtile)[:, None]
    c = torch.arange(T)[None]
    # 1. rows: the positional term from its skewed place, then the scores
    bd = q_v @ rows_at(p, T - qtile - i0, T + qtile - 1).transpose(-1, -2)
    s = torch.gather(bd, -1, (c - r + qtile - 1).expand(*bd.shape[:-1], T))
    s = (q_u @ k[:, :, None].transpose(-1, -2) + s) * scale
    s = s + am[ic] + kp[:, None, None, None, :]
    m, linv = (x[:, :, ic, None] for x in stats)
    prob = torch.exp(s - m) * linv
    dprob = d_o @ v[:, :, None].transpose(-1, -2)
    pd = prob
    if keep is not None:
        kept = keep[:, :, ic]
        pd = torch.where(kept, prob / (1.0 - rate), 0.0)
        dprob = torch.where(kept, dprob / (1.0 - rate), 0.0)
    delta = (prob * dprob).sum(-1, keepdim=True)
    ds, pd = rnd(prob * (dprob - delta) * scale), rnd(pd)
    # 2. columns: the scratch's dS and Pd in tiles, query tile first
    tile = 64 if Dh <= 64 else 32
    nt = -(-T // tile)

    def tiles(x):
        x = x.reshape(B, H, -1, T)[:, :, :T]
        x = torch.nn.functional.pad(x, (0, nt * tile - T, 0, nt * tile - T))
        return x.reshape(B, H, nt, tile, nt, tile).transpose(3, 4)

    x = dict(T=T, qu=qu, qv=qv, k=k, do=do, p=p)
    dqu, dqv = dq_pass(x, tiles(ds), tile)
    dk, dv = dkv_pass(x, tiles(ds), tiles(pd), tile)
    dp = dp_pass(x, tiles(ds), tile)
    return tuple(rnd(g) for g in (dqu, dqv, dk, dv, dp))


BWD_MASKS = ("key padding", "causal", "causal band 64")


def bwd_case(T, Dh, mask, rng_seed, B=2, H=2):
    """bf16-valued inputs (f64), key padding (one utterance at a third of
    T) and ``mask``'s am: none, the causal lookahead, or the lookahead
    and a band of 64 (with the padding, rows from T / 3 + 63 on see no
    key); and a bf16-valued output gradient."""
    args = bf16_case(T, Dh, rng_seed, B, H)
    pos = torch.arange(T)
    hidden = torch.zeros(T, T, dtype=torch.bool)
    if mask != "key padding":
        hidden = pos[None, :] > pos[:, None]
    if "band" in mask:
        hidden = hidden | ((pos[:, None] - pos[None, :]) >= 64)
    args[6] = torch.where(hidden, -1e9, 0.0).double()
    rng = np.random.default_rng(rng_seed + 1)
    do = torch.from_numpy(rng.normal(size=(B, H, T, Dh))).to(
        torch.bfloat16).double()
    return args, do


BWD_T = (1, 15, 16, 17, 63, 64, 65, 101)
BWD_DH = (32, 64, 80)
BWD_GRADS = ("dq_u", "dq_v", "dk", "dv", "dp")
BF16_BWD_TOL = 2.0 ** -6            # chip_smoke.BF16_BWD_TOL


@pytest.mark.parametrize("mask", BWD_MASKS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh", BWD_DH)
@pytest.mark.parametrize("T", BWD_T)
def test_tiled_backward_bf16_matches_plain(T, Dh, rate, mask):
    """The resident bf16 backward's algebra in f32, rounding where the
    kernel rounds, from the forward mirror's f32 statistics, against the
    plain bf16 backward: within 2^-6 of each gradient's max |g| (both
    round at the JAX kernel's points and sum in other orders). T at the
    tile edges: 16-row blocks, 16-key k-steps, 64-key (Dh 80: 32-key)
    column tiles."""
    args, do = bwd_case(T, Dh, mask, T * 100 + Dh)
    B, H = args[0].shape[:2]
    keep = relpos_attention.philox_keep_mask(SEED, B, H, T, rate) \
        if rate > 0.0 else None
    _, m, linv = tiled_forward_bf16(args, SCALE, keep, rate, torch.float32)
    got = tiled_backward_bf16(args, do, SCALE, keep, rate, torch.float32,
                              (m, linv))
    plain = relpos_attention.relpos_attention_bwd_bf16(
        *[x.to(torch.bfloat16) for x in args[:5]],
        *[x.float() for x in args[5:]], do.to(torch.bfloat16), SCALE, SEED,
        rate)
    for name, g, want in zip(BWD_GRADS, got, plain):
        want = want.double()
        err = (g.double() - want).abs().max().item()
        tol = BF16_BWD_TOL * max(want.abs().max().item(), 1e-30)
        assert err <= tol, f"{name}: max abs err {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("mask", BWD_MASKS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh", BWD_DH)
@pytest.mark.parametrize("T", BWD_T)
def test_tiled_backward_bf16_indexing_matches_f64_autograd(T, Dh, rate,
                                                           mask):
    """The same passes with the roundings off, in f64 from the plain f64
    statistics, against autograd of the plain f64 function: within 1e-9
    of each gradient's max |g|, so only an index error can move it."""
    args, do = bwd_case(T, Dh, mask, T * 100 + Dh)
    B, H = args[0].shape[:2]
    keep = relpos_attention.philox_keep_mask(SEED, B, H, T, rate) \
        if rate > 0.0 else None
    got = tiled_backward_bf16(args, do, SCALE, keep, rate, torch.float64,
                              row_stats(args, SCALE), rounded=False)
    for name, g, want in zip(BWD_GRADS, got, autograd_grads(args, do, rate)):
        err = (g - want).abs().max().item()
        tol = 1e-9 * max(want.abs().max().item(), 1e-30)
        assert err <= tol, f"{name}: max abs err {err:.3g} > {tol:.3g}"


def resident_bwd_tile_bytes(dh):
    """A backward rows block's bf16 q_u, q_v and do tiles and its two
    64-row stages, rows ``DP + 8`` apart."""
    dp = 32 if dh <= 32 else 64 if dh <= 64 else 128
    return 2 * (3 * BF16_ROWS + BF16_STAGES * BF16_CHUNK) * (dp + 8)


def resident_bwd_block_bytes(T, dh):
    """A backward rows block's shared memory at T keys: its f32 P and dP,
    2 x ``BF16_ROWS`` rows of ``roundup(T, 16) + 4`` floats, beside its
    tiles."""
    return 8 * BF16_ROWS * (-(-T // 16) * 16 + 4) + resident_bwd_tile_bytes(dh)


def resident_bwd_max_t(dh):
    """The largest T whose backward rows block fits ``SMEM_LIMIT``."""
    ld = (SMEM_LIMIT - resident_bwd_tile_bytes(dh)) // (8 * BF16_ROWS)
    return (ld - 4) // 16 * 16


@pytest.mark.parametrize("dh,max_t", [(1, 1696), (32, 1696), (33, 1600),
                                      (64, 1600), (65, 1424), (128, 1424)])
def test_bf16_backward_takes_the_long_route_past_the_cutover(dh, max_t,
                                                             monkeypatch):
    """The wrapper's route for the bf16 backward: resident up to the T
    whose block of P and dP rows and bf16 tiles fill the 227 KB a block
    may use (the kernel source states these T, and its C entry
    ``relpos_attention_bwd_bf16_max_t`` returns them on the card), the
    five passes from the next T on. Here the wrapper asks a stand-in for
    the built kernel that answers with this layout's T."""
    assert resident_bwd_block_bytes(max_t, dh) <= SMEM_LIMIT \
        < resident_bwd_block_bytes(max_t + 1, dh)
    assert resident_bwd_max_t(dh) == max_t
    ra = relpos_attention

    class Kernel:
        @staticmethod
        def relpos_attention_bwd_bf16_max_t(d):
            return resident_bwd_max_t(d)

    monkeypatch.setattr(ra._build, "load", lambda source: Kernel)
    ra.bf16_bwd_max_t.cache_clear()
    try:
        assert ra.bf16_bwd_max_t(dh) == max_t
        assert ra.bf16_bwd_route(max_t, dh) == "resident"
        assert ra.bf16_bwd_route(max_t + 1, dh) == "long"
    finally:
        ra.bf16_bwd_max_t.cache_clear()
