"""Banded (pruned) RNN-T loss: the joint is evaluated on a diagonal band of
W label positions per encoder frame, so nothing of size (B, T, U+1, .) is
stored.

Counterpart of the JAX package's ``ops/rnnt_loss_banded.py``
(``band_centers``, ``_shift_left_neg``, ``_logcumsumexp``,
``rnnt_loss_banded``). For frame t the band covers the label positions

    u in [c(t), c(t) + W),  c(t) = clip(round(t * U / (T - 1)) - W // 2,
                                        0, max(U + 1 - W, 0))

which holds u = 0 at t = 0 and u = U at t = T - 1, so the loss is the
full RNN-T loss when W >= U + 1 and a lower bound on the path mass (a
larger loss) otherwise.

The lattice runs row by row (frame by frame) as the JAX ``lax.scan``
does, each row's label recurrence solved by a log-cumsum-exp over the
band, and the gradients come from autograd through the loop, as JAX
differentiates its scan. It is plain PyTorch: the JAX function reaches
no Pallas kernel. A row costs some thirty small launches, forward and
backward, so a few hundred frames take thousands.
"""

import torch

from tsasr_torch.kernels.rnnt_lattice import NEG, _logaddexp
from tsasr_torch.utils.precision import f32_or_wider


def band_centers(t_lens, u_lens, T, W):
    """Band starts c (B, T) int32 from absolute lengths ``t_lens`` /
    ``u_lens`` (B,) and the padded frame count T: nondecreasing in t,
    c(0) = 0, and the band at frame t_len - 1 holds u = u_len.
    ``t * u_len / (t_len - 1)`` is taken in f32 and rounded half to even,
    as ``jnp.round`` does."""
    t = torch.arange(T, device=t_lens.device)[None, :]
    tl = torch.clamp(t_lens.long()[:, None] - 1, min=1)
    ul = u_lens.long()[:, None]
    ideal = torch.round((t * ul).float() / tl.float()).long() - W // 2
    hi = torch.clamp(ul + 1 - W, min=0)
    return torch.minimum(torch.clamp(ideal, min=0), hi).to(torch.int32)


def _shift_left_neg(x, d):
    """out[b, j] = x[b, j + d[b]], NEG past the end (d >= 0)."""
    W = x.shape[1]
    idx = torch.arange(W, device=x.device)[None, :] + d[:, None]
    gathered = x.gather(1, torch.clamp(idx, max=W - 1))
    return torch.where(idx < W, gathered, NEG)


def _logcumsumexp(x):
    """Inclusive left-to-right log-cumsum-exp along the last axis, by
    doubling shifts with NEG fill (the JAX scan's own)."""
    n, shift = x.shape[-1], 1
    while shift < n:
        shifted = torch.cat([torch.full_like(x[..., :shift], NEG),
                             x[..., :-shift]], dim=-1)
        x = _logaddexp(x, shifted)
        shift *= 2
    return x


def rnnt_loss_banded(logits_band, labels, centers, logit_lengths,
                     label_lengths, blank=0, reduction="mean"):
    """Banded RNN-T negative log-likelihood.

    logits_band (B, T, W, V): the joint's logits on the band
    (``TSTransducer.joint_logits_banded``), cast to f32 as JAX does;
    labels (B, U) int; centers (B, T) the band starts
    (``band_centers``); logit_lengths / label_lengths (B,) absolute.
    ``reduction``: mean, batchmean, sum or none."""
    logits_band = logits_band.to(f32_or_wider(logits_band))
    labels, centers = labels.long(), centers.long()
    B, T, W, _ = logits_band.shape
    U = labels.shape[1]
    dev = logits_band.device
    log_probs = torch.log_softmax(logits_band, dim=-1)
    lpb = log_probs[..., blank]                             # (B, T, W)

    jj = torch.arange(W, device=dev)[None, :]
    u_abs = centers[:, :, None] + jj                        # (B, T, W)
    if U > 0:
        lab_ids = labels[:, None, :].expand(B, T, U).gather(
            2, torch.clamp(u_abs, 0, U - 1))
    else:
        lab_ids = torch.zeros_like(u_abs)
    lpl = log_probs.gather(-1, lab_ids[..., None])[..., 0]
    lpl = torch.where(u_abs < label_lengths.long()[:, None, None], lpl, NEG)

    Tl = logit_lengths.long()
    Ul = label_lengths.long()[:, None]
    row = torch.full((B, W), NEG, dtype=lpb.dtype, device=dev)
    logz = torch.full((B,), NEG, dtype=lpb.dtype, device=dev)
    start = torch.where(jj == 0, 0.0, NEG).to(lpb.dtype).expand(B, W)
    for t in range(T):
        c_t = centers[:, t]
        # blank transitions from row t-1, moved to this row's band
        seed = start if t == 0 else _shift_left_neg(
            row + lpb[:, t - 1], c_t - centers[:, t - 1])
        u_row = c_t[:, None] + jj
        seed = torch.where(u_row <= Ul, seed, NEG)
        # the in-row label recurrence as a log-cumsum-exp
        p = torch.where(u_row < Ul, lpl[:, t], 0.0)
        cum_p = torch.cumsum(p, dim=1) - p                  # exclusive
        row = cum_p + _logcumsumexp(seed - cum_p)
        row = torch.where(u_row <= Ul, row, NEG)
        # logZ = alpha[Tl - 1, Ul] + blank[Tl - 1, Ul]
        last = Tl == t + 1
        terminal = torch.where((u_row == Ul) & last[:, None],
                               row + lpb[:, t], 0.0).sum(dim=1)
        logz = torch.where(last, terminal, logz)
    losses = -logz

    if reduction == "mean":
        return losses.mean()
    if reduction == "batchmean":
        return losses.sum() / losses.shape[0]
    if reduction == "sum":
        return losses.sum()
    if reduction == "none":
        return losses
    raise ValueError(f"Unknown reduction: {reduction}")
