"""The row chains of ``csrc/rnnt_lattice.cu``, pinned on the CPU: the
beta chain of ``rnnt_beta_slab_kernel`` (``chain_beta``), the alpha chain
(``chain_alpha``), both as ``rnnt_resident_kernel`` runs them
(``chain_resident``) and both as the slab pair runs them
(``chain_slab``).

``chain_beta`` mirrors the kernel's algebra exactly as it is tiled. A
row of an utterance's lattice (its ``Ul + 1`` columns) is walked from the
right in chunks of ``32 K`` columns, right-aligned, so only the leftmost
chunk of a row holds padding; lane ``l`` of the chain warp owns the ``K``
consecutive columns ``l K .. l K + K - 1`` of a chunk (the kernel takes
K = 8, 16 or 32, the least whose chunk holds the row). Per chunk:

- the producer stages the chunk's lpb, lpl and alpha (0 where a column
  lies left of column 0) into a ring of ``slots`` chunks and writes its
  suffix sums sufP: an in-lane suffix sum, a 32-lane inclusive suffix
  scan of the lane totals (shuffles down), the lane to the right's
  value as the exclusive carry, plus the row's carry from the chunks to
  its right;
- the chain forms ``x = (beta[t+1] + lpb) - sufP`` and its right-to-left
  log-sum-exp as (max, scaled sum) pairs: a sequential in-lane scan, a
  5-step inclusive suffix scan of the lane totals, the lane to the
  right's pair as the exclusive carry, the chunk carry from the right,
  then ``beta = sufP + max + log(sum)`` per column; beta[t+1] comes from
  the previous row's registers when a row is one chunk, else from the
  beta ring. beta goes into a ring of ``rows`` beta rows of ``R 32 K``
  positions, position ``u + R 32 K - (Ul + 1)``;
- the gradient warps compute a chunk's dlpb (beta[t+1] at u) and dlpl
  (beta[t] at u + 1) from the ring slots and the beta ring ``lag``
  chunks behind the chain, at most ``slots - 1``, the most the slot ring
  lets them fall behind.

``chain_alpha`` mirrors the alpha chain, the same walk left to right: a
row's chunks are left-aligned (only the rightmost holds padding); the
producer stages lpb of row t - 1 (0 at t = 0) and lpl of row t and writes
the exclusive prefix sums cumP (an exclusive in-lane sum, a 32-lane
inclusive scan of the lane totals by shuffles up, the lane to the left's
value as the carry, plus the row's carry from the chunks to its left);
the chain forms ``x = (alpha[t-1] + lpb[t-1]) - cumP`` (``[0, NEG..]``
at t = 0) and its left-to-right log-sum-exp as pairs, then ``alpha =
cumP + max + log(sum)``. alpha[t-1] comes from the previous row's
registers when a row is one chunk, else from the alpha the chain wrote,
whose rows are ``stride`` floats apart: ``U+1`` rounded up to 4 in the
resident kernel's shared memory, ``U+1`` in the alpha slab kernel's
device memory, where a lane's columns at or past the stride belong to no
row. The lane owning column Ul of row Tl - 1 forms logZ.
``chain_resident`` runs it, then ``chain_beta`` on the resident alpha;
``chain_slab`` runs it at stride ``U+1`` (the alpha slab kernel), then
``chain_beta`` on that alpha (the beta slab kernel).

Each runs in f64 against ``rnnt_lattice_reference`` (or
``rnnt_alpha_reference``) at 1e-10 of each output's max: a wrong chunk
offset, carry, ring index or ring size shows up as an error of the order
of the output itself."""

import math

import numpy as np
import pytest
import torch

from tsasr_torch.kernels import rnnt_lattice

NEG = rnnt_lattice.NEG
LANES = 32
K = 8           # columns per lane (kCols in csrc/rnnt_lattice.cu)
SLOTS = 6       # staged chunks (kSlots)


def cols_per_lane(U1):
    """The kernel's K for a lattice U1 columns wide (``beta_slab_cols``,
    below its shared-memory fallback): the least of 8, 16, 32 whose chunk
    holds the row."""
    return 8 if U1 <= 256 else 16 if U1 <= 512 else 32


def beta_rows(slots, rounds):
    """Beta rows the ring needs (the kernel's ``beta_ring_rows``): the
    gradient warps may lag ``slots - 1`` chunks behind the chain and read
    rows t and t + 1 of a chunk of row t."""
    return -(-(slots - 1) // rounds) + 2


def combine(a, b):
    """(max, scaled sum) pairs: log(sa e^ma + sb e^mb) as (m, s), with
    one exp, of minus the distance between the maxima."""
    q = torch.exp(-(a[0] - b[0]).abs())
    s = torch.where(a[0] >= b[0], b[1] * q + a[1], a[1] * q + b[1])
    return torch.maximum(a[0], b[0]), s


def shfl_down(v, o, fill):
    """Lane l gets lane l + o's value; ``fill`` past the last lane (the
    kernel keeps its own value there and does not combine it)."""
    return torch.cat([v[o:], v.new_full((o,), fill)])


def lane_suffix_sum(tot):
    incl = tot.clone()
    o = 1
    while o < LANES:
        incl = incl + shfl_down(incl, o, 0.0)
        o *= 2
    return incl


def lane_suffix_pairs(m, s):
    o = 1
    while o < LANES:
        m, s = combine((m, s), (shfl_down(m, o, NEG), shfl_down(s, o, 0.0)))
        o *= 2
    return m, s


def shfl_up(v, o, fill):
    """Lane l gets lane l - o's value; ``fill`` below lane 0."""
    return torch.cat([v.new_full((o,), fill), v[:-o]])


def lane_prefix_sum(tot):
    incl = tot.clone()
    o = 1
    while o < LANES:
        incl = incl + shfl_up(incl, o, 0.0)
        o *= 2
    return incl


def lane_prefix_pairs(m, s):
    o = 1
    while o < LANES:
        m, s = combine((m, s), (shfl_up(m, o, NEG), shfl_up(s, o, 0.0)))
        o *= 2
    return m, s


def alpha_stride(U1):
    """Row stride of the resident alpha: U+1 rounded up to 4 floats, so a
    lane's K (a multiple of 4) columns go in aligned float4 stores."""
    return -(-U1 // 4) * 4


def chain_utterance(lpb, lpl, alpha, logz, Tl, Ul, k, slots, lag, rows,
                    dlpb, dlpl):
    """One block of the kernel: utterance lattices (T, U1) in, its rows of
    dlpb / dlpl (zeroed by the caller) written."""
    C = LANES * k
    W = Ul + 1
    R = -(-W // C)
    off = R * C - W
    nb = rows if rows is not None else beta_rows(slots, R)
    dt = lpb.dtype
    ring = torch.full((nb, R * C), float("nan"), dtype=dt)
    u_all = torch.arange(R * C) - off
    ring[Tl % nb] = torch.where(u_all == Ul, 0.0, NEG).to(dt)
    slot = [None] * slots
    chunks = [(t, j) for t in range(Tl - 1, -1, -1) for j in range(R)]
    i = torch.arange(C)
    bn_reg = ring[Tl % nb][:C].clone() if R == 1 else None

    def gradient(c):
        t, j = chunks[c]
        s_lpb, s_lpl, s_alpha, _ = slot[c % slots]
        u = W - (j + 1) * C + i
        ok = u >= 0
        p = (R - 1 - j) * C + i
        bn = ring[(t + 1) % nb][p]
        bt = ring[t % nb][torch.clamp(p + 1, max=R * C - 1)]
        gb = -torch.exp(s_alpha + s_lpb + bn - logz)
        gl = torch.where(u < Ul, -torch.exp(s_alpha + s_lpl + bt - logz),
                         torch.zeros((), dtype=dt))
        dlpb[t, u[ok]] = gb[ok]
        dlpl[t, u[ok]] = gl[ok]

    for c, (t, j) in enumerate(chunks):
        # producer: stage the chunk, then its suffix sums
        u = W - (j + 1) * C + i
        ok = u >= 0
        uc = torch.clamp(u, min=0)
        s_lpb, s_lpl, s_alpha = (torch.where(ok, a[t, uc], 0.0)
                                 for a in (lpb, lpl, alpha))
        if j == 0:
            row_p = torch.zeros((), dtype=dt)
        p = torch.where(ok & (u < Ul), s_lpl, 0.0).view(LANES, k)
        suf_in = p.flip(1).cumsum(1).flip(1)
        incl = lane_suffix_sum(suf_in[:, 0])
        excl = shfl_down(incl, 1, 0.0)
        suf_p = (suf_in + excl[:, None] + row_p).view(C)
        row_p = row_p + incl[0]
        slot[c % slots] = (s_lpb, s_lpl, s_alpha, suf_p)

        # chain: x, in-lane pairs, lane scan, chunk carry, beta
        bn = bn_reg if R == 1 else ring[(t + 1) % nb][(R - 1 - j) * C:
                                                      (R - j) * C]
        x = torch.where(ok, (bn + s_lpb) - suf_p, NEG).view(LANES, k)
        pm = torch.empty_like(x)
        ps = torch.empty_like(x)
        m = torch.full((LANES,), NEG, dtype=dt)
        s = torch.zeros(LANES, dtype=dt)
        for kk in range(k - 1, -1, -1):
            m, s = combine((m, s), (x[:, kk], torch.ones_like(s)))
            pm[:, kk], ps[:, kk] = m, s
        im, is_ = lane_suffix_pairs(pm[:, 0], ps[:, 0])
        ex = (shfl_down(im, 1, NEG), shfl_down(is_, 1, 0.0))
        if j > 0:
            ex = combine(ex, carry)
        fm, fs = combine((pm, ps), (ex[0][:, None], ex[1][:, None]))
        beta = torch.where(ok.view(LANES, k) & (fm > NEG / 2),
                           suf_p.view(LANES, k) + (fm + torch.log(fs)),
                           NEG).view(C)
        carry = combine((im[0], is_[0]), carry) if j > 0 else (im[0],
                                                                is_[0])
        ring[t % nb][(R - 1 - j) * C:(R - j) * C] = beta
        if R == 1:
            bn_reg = beta
        if c >= lag:
            gradient(c - lag)
    for c in range(max(len(chunks) - lag, 0), len(chunks)):
        gradient(c)


def chain_beta(lpb, lpl, t_lens, u_lens, alpha, logz, k=K, slots=SLOTS,
               lag=None, rows=None):
    """The beta slab kernel as tiled: (dlpb, dlpl), each (B, T, U+1).
    ``lag`` defaults to the most the kernel allows; ``rows`` overrides
    the beta ring's size."""
    lag = slots - 1 if lag is None else lag
    assert 0 <= lag <= slots - 1
    dlpb = torch.zeros_like(lpb)
    dlpl = torch.zeros_like(lpl)
    for b in range(lpb.shape[0]):
        Tl = min(max(int(t_lens[b]), 0), lpb.shape[1])
        Ul = min(max(int(u_lens[b]), 0), lpb.shape[2] - 1)
        if Tl:
            chain_utterance(lpb[b], lpl[b], alpha[b], logz[b], Tl, Ul, k,
                            slots, lag, rows, dlpb[b], dlpl[b])
    return dlpb, dlpl


def chain_alpha_utterance(lpb, lpl, Tl, Ul, k, alpha, staged):
    """One block's alpha pass: rows 0 .. Tl - 1 of ``alpha`` (T, stride)
    written, each lane's columns short of the stride, or (``staged``, the
    alpha slab at K <= 8) the columns of the lattice; returns logZ."""
    C = LANES * k
    W = Ul + 1
    R = -(-W // C)
    S = alpha.shape[1]
    dt = lpb.dtype
    i = torch.arange(C)
    logz = torch.tensor(NEG, dtype=dt)
    for t in range(Tl):
        for j in range(R):
            # producer: stage the chunk, then its exclusive prefix sums
            u = j * C + i
            ok = u < W
            uc = torch.where(ok, u, 0)
            s_lpb = torch.where(ok & (t > 0), lpb[max(t - 1, 0), uc], 0.0)
            s_lpl = torch.where(ok, lpl[t, uc], 0.0)
            if j == 0:
                row_p = torch.zeros((), dtype=dt)
            p = torch.where(u < Ul, s_lpl, 0.0).view(LANES, k)
            cum_in = torch.cumsum(p, 1) - p
            incl = lane_prefix_sum(cum_in[:, -1] + p[:, -1])
            excl = shfl_up(incl, 1, 0.0)
            cum_p = (cum_in + excl[:, None] + row_p).view(C)
            row_p = row_p + incl[-1]

            # chain: alpha[t-1], x, in-lane pairs, lane scan, chunk carry
            if t == 0:
                an = torch.where(u == 0, 0.0, NEG).to(dt)
            elif R > 1:
                an = torch.where(u < S, alpha[t - 1, u.clamp(max=S - 1)],
                                 NEG)
            x = torch.where(ok, (an + s_lpb) - cum_p, NEG).view(LANES, k)
            pm = torch.empty_like(x)
            ps = torch.empty_like(x)
            m = torch.full((LANES,), NEG, dtype=dt)
            s = torch.zeros(LANES, dtype=dt)
            for kk in range(k):
                m, s = combine((m, s), (x[:, kk], torch.ones_like(s)))
                pm[:, kk], ps[:, kk] = m, s
            im, is_ = lane_prefix_pairs(pm[:, -1], ps[:, -1])
            ex = (shfl_up(im, 1, NEG), shfl_up(is_, 1, 0.0))
            if j > 0:
                ex = combine(ex, carry)
            fm, fs = combine((pm, ps), (ex[0][:, None], ex[1][:, None]))
            an = torch.where(ok.view(LANES, k) & (fm > NEG / 2),
                             cum_p.view(LANES, k) + (fm + torch.log(fs)),
                             NEG).view(C)
            carry = combine((im[-1], is_[-1]), carry) if j > 0 else (
                im[-1], is_[-1])
            keep = u < W if staged else u < S
            alpha[t, u[keep]] = an[keep]
            if t == Tl - 1 and j * C <= Ul < (j + 1) * C:
                logz = an[Ul - j * C] + lpb[Tl - 1, Ul]
    return logz


def chain_alpha(lpb, lpl, t_lens, u_lens, stride, k=K, staged=False):
    """The alpha chain as tiled: (alpha (B, T, stride), filled with NaN
    where the chain writes nothing, logZ (B,))."""
    B, T, U1 = lpb.shape
    alpha = torch.full((B, T, stride), float("nan"), dtype=lpb.dtype)
    logz = torch.full((B,), NEG, dtype=lpb.dtype)
    for b in range(B):
        Tl = min(max(int(t_lens[b]), 0), T)
        Ul = min(max(int(u_lens[b]), 0), U1 - 1)
        logz[b] = chain_alpha_utterance(lpb[b], lpl[b], Tl, Ul, k, alpha[b],
                                        staged)
    return alpha, logz


def chain_resident(lpb, lpl, t_lens, u_lens, k=K, **beta_kw):
    """The resident kernel as tiled: the alpha chain into the resident
    alpha, then the beta chain reading it: (loss, dlpb, dlpl)."""
    alpha, logz = chain_alpha(lpb, lpl, t_lens, u_lens,
                              alpha_stride(lpb.shape[2]), k=k)
    dlpb, dlpl = chain_beta(lpb, lpl, t_lens, u_lens,
                            alpha[..., :lpb.shape[2]], logz, k=k, **beta_kw)
    return -logz, dlpb, dlpl


def chain_slab(lpb, lpl, t_lens, u_lens, k=None):
    """The slab pair as tiled: the alpha slab kernel's chain into alpha
    rows U+1 apart (NaN where it writes nothing, so that a cell the beta
    chain reads unwritten shows; staged stores up to K = 8), then the
    beta slab kernel's chain reading it, at its own K: (loss, dlpb,
    dlpl). The alpha chain's K defaults to its kernel's own."""
    U1 = lpb.shape[2]
    k = rnnt_lattice.alpha_slab_cols(U1) if k is None else k
    alpha, logz = chain_alpha(lpb, lpl, t_lens, u_lens, U1, k=k,
                              staged=k <= 8)
    dlpb, dlpl = chain_beta(lpb, lpl, t_lens, u_lens, alpha, logz,
                            k=cols_per_lane(U1))
    return -logz, dlpb, dlpl


def lattice(seed, B, T, U1, t_lens, u_lens):
    """f64 log-prob lattices of random logits over 7 tokens."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.normal(size=(B, T, U1, 7)))
    labels = torch.from_numpy(rng.integers(1, 7, size=(B, U1 - 1)))
    lp = torch.log_softmax(logits, -1)
    lpb = lp[..., 0].contiguous()
    lpl = torch.cat([lp[:, :, :-1].gather(
        -1, labels[:, None, :, None].expand(B, T, U1 - 1, 1))[..., 0],
        torch.zeros(B, T, 1, dtype=lp.dtype)], -1).contiguous()
    return (lpb, lpl, torch.tensor(t_lens, dtype=torch.int32),
            torch.tensor(u_lens, dtype=torch.int32))


def check(args, **kw):
    alpha, logz = rnnt_lattice.rnnt_alpha_reference(*args)
    got = chain_beta(*args, alpha, logz, **kw)
    _, *want = rnnt_lattice.rnnt_lattice_reference(*args)
    for g, w in zip(got, want):
        tol = 1e-10 * w.abs().max().item()
        assert (g - w).abs().max().item() <= tol
    return got


# (T, U+1, t_lens, u_lens): Ul = 0, Tl = 1, Tl = 0, U+1 not a multiple of
# 32, and rows of one, two and four chunks at K = 8 (256 columns), one at
# the kernel's K (16 at U+1 300, 32 at 801)
SHAPES = [
    (7, 45, [7, 1, 4, 6], [44, 0, 20, 31]),
    (6, 241, [6, 3, 1, 0], [240, 150, 0, 7]),
    (5, 300, [5, 4, 2], [299, 257, 255]),
    (3, 801, [3, 2], [800, 513]),
]


@pytest.mark.parametrize("T,U1,t_lens,u_lens", SHAPES)
@pytest.mark.parametrize("rule", ["kernel", "K8"])
def test_chain_matches_reference(T, U1, t_lens, u_lens, rule):
    """At the kernel's K for the lattice, and at K = 8, where rows wider
    than 256 columns take several chunks."""
    k = cols_per_lane(U1) if rule == "kernel" else 8
    check(lattice(T + U1, len(t_lens), T, U1, t_lens, u_lens), k=k)


@pytest.mark.parametrize("k,slots,lag", [(1, 6, 5), (2, 3, 2), (1, 2, 1),
                                         (2, 6, 0), (8, 6, 1)])
def test_chain_rounds_slots_and_lag(k, slots, lag):
    """Narrow lanes make many chunks a row (K = 1: 32 columns), so the
    chunk carries, the beta ring's reads from a row several chunks back
    and every lag the slot ring allows run at a small size."""
    args = lattice(k + slots, 3, 6, 150, [6, 5, 2], [149, 97, 31])
    check(args, k=k, slots=slots, lag=lag)


@pytest.mark.parametrize("k,U1", [(8, 200), (1, 150)])
def test_beta_ring_is_no_larger_than_needed(k, U1):
    """One beta row fewer than ``beta_rows`` lets the chain overwrite a
    row that the gradient warps, at the largest lag, still read."""
    args = lattice(5, 1, 9, U1, [9], [U1 - 1])
    alpha, logz = rnnt_lattice.rnnt_alpha_reference(*args)
    R = math.ceil(U1 / (LANES * k))
    want = chain_beta(*args, alpha, logz, k=k)
    got = chain_beta(*args, alpha, logz, k=k,
                     rows=beta_rows(SLOTS, R) - 1)
    assert not all(torch.allclose(g, w) for g, w in zip(got, want))


def test_chain_in_f32_within_lattice_tolerance():
    """The same tiling in f32 against the f64 reference, at the tolerance
    that chip_smoke.py and the card tests hold the kernel to."""
    args = lattice(3, 2, 40, 241, [40, 31], [240, 170])
    alpha, logz = rnnt_lattice.rnnt_alpha_reference(*args)
    loss, *want = rnnt_lattice.rnnt_lattice_reference(*args)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    got = chain_beta(*f32, alpha.float(), logz.float())
    rtol = max(1e-4, 2 * math.sqrt(40 + 241) * loss.abs().max().item()
               * 2.0 ** -24)
    for g, w in zip(got, want):
        assert ((g.double() - w).abs() <= 1e-4 + rtol * w.abs()).all()


def in_lattice(t_lens, u_lens, T, U1):
    """(B, T, U+1) mask of the cells inside each utterance's lattice."""
    return ((torch.arange(T)[None, :, None] < t_lens.long()[:, None, None])
            & (torch.arange(U1)[None, None] < u_lens.long()[:, None, None]
               + 1))


@pytest.mark.parametrize("T,U1,t_lens,u_lens", SHAPES)
@pytest.mark.parametrize("rule", ["kernel", "K1", "K2"])
def test_alpha_chain_matches_reference(T, U1, t_lens, u_lens, rule):
    """At the resident kernel's K (one chunk a row: K = 4 up to 128
    columns, then as the beta slab's) and at K = 1 and 2 (32 and 64
    columns a chunk: several chunks a row, alpha[t-1] read back from the
    resident alpha). Inside each lattice alpha and logZ at 1e-10; a cell
    the chain reads before writing would be NaN."""
    k = {"kernel": rnnt_lattice.resident_cols(T, U1), "K1": 1,
         "K2": 2}[rule]
    args = lattice(T + U1 + k, len(t_lens), T, U1, t_lens, u_lens)
    alpha, logz = chain_alpha(*args, alpha_stride(U1), k=k)
    want, want_z = rnnt_lattice.rnnt_alpha_reference(*args)
    inside = in_lattice(args[2], args[3], T, U1)
    got = alpha[..., :U1][inside]
    assert torch.isfinite(got).all()
    assert (got - want[inside]).abs().max() <= 1e-10 * want[inside].abs(
    ).max()
    assert (logz - want_z).abs().max() <= 1e-10 * want_z.abs().max()


@pytest.mark.parametrize("T,U1,t_lens,u_lens", SHAPES)
@pytest.mark.parametrize("rule", ["kernel", "K2"])
def test_resident_chain_matches_reference(T, U1, t_lens, u_lens, rule):
    """Both passes as the resident kernel runs them, the beta chain
    reading the resident alpha: loss and both gradients at 1e-10."""
    k = rnnt_lattice.resident_cols(T, U1) if rule == "kernel" else 2
    args = lattice(2 * T + U1, len(t_lens), T, U1, t_lens, u_lens)
    got = chain_resident(*args, k=k)
    want = rnnt_lattice.rnnt_lattice_reference(*args)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-10 * w.abs().max().item()


def test_resident_chain_in_f32_within_lattice_tolerance():
    """The resident tiling in f32 against the f64 reference, at the
    tolerance that chip_smoke.py and the card tests hold the kernel to
    (B6 T208 U+1 129's width, fewer rows)."""
    args = lattice(4, 2, 40, 129, [40, 29], [128, 90])
    want = rnnt_lattice.rnnt_lattice_reference(*args)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    got = chain_resident(*f32)
    rtol = max(1e-4, 2 * math.sqrt(40 + 129) * want[0].abs().max().item()
               * 2.0 ** -24)
    for g, w in zip(got, want):
        assert ((g.double() - w).abs() <= 1e-4 + rtol * w.abs()).all()


@pytest.mark.parametrize("T,U1,fits,K", [
    (208, 129, True, 8), (104, 61, True, 4), (408, 241, False, 8),
    (17, 1500, True, 32), (20, 1500, True, 8), (400, 200, False, 8)])
def test_resident_footprint_routes_the_main_path(T, U1, fits, K):
    """The resident kernel's shared memory (``resident_smem``, the
    routing rule) admits the 8 s training batches (T208 U+1 129) and
    bench.py's step (T104 U+1 61) and refuses the 16 s ones (T408 U+1
    241), which take the slab; U+1 1500 fits at T17 in chunks of 1024
    columns and at T20 only at K = 8; U+1 61 takes K = 4 (128-column
    chunks). T208 U+1 129 by hand: 64 floats of
    mbarriers and logZ, 6 slots of 3 x 256, 208 alpha rows of 132, 7 beta
    rows of 256."""
    assert rnnt_lattice.resident_fits(T, U1) == fits
    assert rnnt_lattice.resident_cols(T, U1) == K
    if (T, U1) == (208, 129):
        assert rnnt_lattice.resident_smem(T, U1) == 4 * (
            64 + 6 * 3 * 256 + 208 * 132 + 7 * 256)


# SHAPES plus the slab's edges: U+1 1-3 (every lane's columns but the
# first's lie past the stride), rows of exactly 32 K columns (U+1 128 at
# the kernel's K = 4; 32 columns at K = 1) and 32 K + 1 (33 at K = 1)
SLAB_SHAPES = SHAPES + [
    (4, 1, [4, 0], [0, 0]),
    (5, 2, [5, 3, 0], [1, 0, 1]),
    (6, 3, [6, 2], [2, 1]),
    (5, 33, [5, 4, 3], [32, 31, 0]),
    (4, 128, [4, 2], [127, 100]),
]


@pytest.mark.parametrize("T,U1,t_lens,u_lens", SLAB_SHAPES)
@pytest.mark.parametrize("rule", ["kernel", "K1", "K2"])
def test_slab_chain_matches_reference(T, U1, t_lens, u_lens, rule):
    """The slab pair as tiled, the alpha chain at the alpha slab kernel's
    K (one chunk a row up to 1024 columns) and at K = 1 and 2 (several
    chunks a row, alpha[t-1] read back at stride U+1), the beta chain at
    the beta slab kernel's K: loss and both gradients at 1e-10 of the
    plain lattice; a cell read before it is written would be NaN."""
    k = {"kernel": None, "K1": 1, "K2": 2}[rule]
    args = lattice(3 * T + U1, len(t_lens), T, U1, t_lens, u_lens)
    got = chain_slab(*args, k=k)
    want = rnnt_lattice.rnnt_lattice_reference(*args)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-10 * w.abs().max().item()


def test_slab_chain_in_f32_within_lattice_tolerance():
    """The slab tiling in f32 against the f64 reference, at the tolerance
    that chip_smoke.py and the card tests hold the kernels to (B3 T408
    U+1 241's width, fewer rows)."""
    args = lattice(6, 2, 40, 241, [40, 31], [240, 170])
    want = rnnt_lattice.rnnt_lattice_reference(*args)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    got = chain_slab(*f32)
    rtol = max(1e-4, 2 * math.sqrt(40 + 241) * want[0].abs().max().item()
               * 2.0 ** -24)
    for g, w in zip(got, want):
        assert ((g.double() - w).abs() <= 1e-4 + rtol * w.abs()).all()


@pytest.mark.parametrize("U1,K", [(1, 4), (3, 4), (128, 4), (129, 8),
                                  (256, 8), (257, 16), (512, 16), (513, 32),
                                  (1024, 32), (1025, 32), (5000, 32)])
def test_alpha_slab_cols_is_the_least_chunk_holding_a_row(U1, K):
    """``alpha_slab_cols``: the least of 4, 8, 16, 32 whose chunk of 32 K
    columns holds a row of U+1, else 32 (several chunks a row)."""
    assert rnnt_lattice.alpha_slab_cols(U1) == K
    least = [k for k in (4, 8, 16, 32) if 32 * k >= U1]
    assert K == (least[0] if least else 32)


@pytest.mark.parametrize("T,U1,K_alpha,K_beta", [
    (408, 241, 8, 8), (832, 298, 16, 16), (1375, 801, 32, 32)])
def test_slab_routes_the_16s_batches(T, U1, K_alpha, K_beta):
    """The 3 x 16 s micro-batch (T408 U+1 241) and chip_smoke.py's longer
    slab lattices do not fit the resident kernel, so the wrapper takes
    the slab pair, each kernel at the K stated."""
    assert not rnnt_lattice.resident_fits(T, U1)
    assert rnnt_lattice.alpha_slab_cols(U1) == K_alpha
    assert cols_per_lane(U1) == K_beta
