"""RNN-T (transducer) loss with analytic gradients.

Counterpart of the JAX package's ``ops/rnnt_loss.py``. The lattice of
blank and label log-probs is solved by ``kernels.rnnt_lattice`` (the CUDA
kernels on the card, their plain row scan on the CPU), which returns the
loss and the gradients w.r.t. both lattices; the backward of
``rnnt_loss`` is the log-softmax jacobian of the JAX ``_rnnt_bwd``:

    dlogits = dlogp - softmax(logits) * (dlpb + dlpl)

with dlogp[b, t, u, v] = dlpb * (v == blank) + dlpl * (v == labels[b, u]).

``rnnt_loss_reference`` is the independent oracle: a per-cell alpha
recursion in plain PyTorch, differentiated by autograd. Relative lengths
in ``transducer_loss`` are turned into counts with ``round(rel * size)``;
``reduction`` is mean, batchmean, sum or none.
"""

import torch

from tsasr_torch.kernels.rnnt_lattice import NEG, rnnt_lattice
from tsasr_torch.utils.precision import f32_or_wider


def _gather_label_blank_logprobs(log_probs, labels, blank):
    """Split (B, T, U+1, V) log-probs into blank (B, T, U+1) and label
    (B, T, U+1) lattices; label column U is NEG (no label left)."""
    B, T, U1, _ = log_probs.shape
    U = labels.shape[1]
    lpb = log_probs[..., blank]
    idx = labels.long()[:, None, :, None].expand(B, T, U, 1)
    lpl = log_probs[:, :, :U, :].gather(-1, idx)[..., 0]
    lpl = torch.cat([lpl, torch.full((B, T, U1 - U), NEG, dtype=lpl.dtype,
                                     device=lpl.device)], dim=2)
    return lpb.contiguous(), lpl.contiguous()


def _logprob_grads(log_probs, dlpb, dlpl, labels, blank):
    """d(loss)/d(logits) from the lattice gradients (the JAX ``_rnnt_bwd``)."""
    U = labels.shape[1]
    dlogp = torch.zeros_like(log_probs)
    dlogp[..., blank] = dlpb
    idx = labels.long()[:, None, :, None].expand(*dlpl.shape[:2], U, 1)
    dlogp[:, :, :U].scatter_add_(-1, idx, dlpl[:, :, :U, None])
    return dlogp - torch.exp(log_probs) * (dlpb + dlpl)[..., None]


class _RNNTLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, logit_lengths, label_lengths, blank):
        log_probs = torch.log_softmax(logits, dim=-1,
                                      dtype=f32_or_wider(logits))
        lpb, lpl = _gather_label_blank_logprobs(log_probs, labels, blank)
        loss, dlpb, dlpl = rnnt_lattice(lpb, lpl, logit_lengths,
                                        label_lengths)
        ctx.save_for_backward(log_probs, dlpb, dlpl, labels)
        ctx.blank = blank
        return loss

    @staticmethod
    def backward(ctx, g):
        log_probs, dlpb, dlpl, labels = ctx.saved_tensors
        dlogits = _logprob_grads(log_probs, dlpb, dlpl, labels, ctx.blank)
        return dlogits * g[:, None, None, None], None, None, None, None


def reduce_losses(losses, reduction):
    if reduction == "mean":
        return losses.mean()
    if reduction == "batchmean":
        return losses.sum() / losses.shape[0]
    if reduction == "sum":
        return losses.sum()
    if reduction == "none":
        return losses
    raise ValueError(f"Unknown reduction: {reduction}")


def rnnt_loss(logits, labels, logit_lengths, label_lengths, blank=0,
              reduction="mean"):
    """RNN-T loss over absolute lengths, as torchaudio's ``rnnt_loss``.

    logits: (B, T, U+1, V); labels: (B, U) int; lengths: (B,) int.
    """
    losses = _RNNTLoss.apply(logits, labels,
                             logit_lengths.to(torch.int32).contiguous(),
                             label_lengths.to(torch.int32).contiguous(),
                             blank)
    return reduce_losses(losses, reduction)


def transducer_loss(logits, targets, input_lens, target_lens, blank_index=0,
                    reduction="mean"):
    """``rnnt_loss`` over relative lengths, converted with
    ``round(lens * size)`` as the reference's ``transducer_loss`` does."""
    input_lens = torch.round(input_lens * logits.shape[1]).to(torch.int32)
    target_lens = torch.round(target_lens * targets.shape[1]).to(torch.int32)
    return rnnt_loss(logits, targets, input_lens, target_lens,
                     blank=blank_index, reduction=reduction)


def rnnt_loss_reference(logits, labels, logit_lengths, label_lengths,
                        blank=0):
    """Per-utterance losses (B,) from a readable per-cell recursion,

        alpha[0, 0] = 0
        alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                                alpha[t, u-1] + label[t, u-1])
        loss = -(alpha[T_b-1, U_b] + blank[T_b-1, U_b]),

    differentiable by autograd. Slow: it is the tests' oracle."""
    log_probs = torch.log_softmax(logits, dim=-1, dtype=f32_or_wider(logits))
    losses = []
    for b in range(logits.shape[0]):
        T_b, U_b = int(logit_lengths[b]), int(label_lengths[b])
        lp = log_probs[b]
        alpha = {}
        for t in range(T_b):
            for u in range(U_b + 1):
                terms = []
                if t == 0 and u == 0:
                    terms.append(lp.new_zeros(()))
                if t > 0:
                    terms.append(alpha[t - 1, u] + lp[t - 1, u, blank])
                if u > 0:
                    terms.append(alpha[t, u - 1]
                                 + lp[t, u - 1, int(labels[b, u - 1])])
                alpha[t, u] = torch.logsumexp(torch.stack(terms), dim=0)
        losses.append(-(alpha[T_b - 1, U_b] + lp[T_b - 1, U_b, blank]))
    return torch.stack(losses)
