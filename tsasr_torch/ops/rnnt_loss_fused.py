"""Fused joint + head + RNN-T loss: the (B, T, U+1, J) joint and the
(B, T, U+1, V) logits are never stored whole.

Counterpart of the JAX package's ``ops/rnnt_loss_fused.py``, as a
``torch.autograd.Function``:

- forward: over chunks of ``chunk`` frames, compute the joint, the head
  and the log-softmax, keep only the blank and label lattices
  (B, T, U+1), and solve them with ``kernels.rnnt_lattice``;
- backward: recompute each chunk's joint and push the lattice gradients
  through the log-softmax, head and leaky-relu jacobians (JAX
  ``_fused_bwd``), emitting d(enc), d(dec), d(head_w) and d(head_b).

The chunk products stay ``torch.matmul``, as the JAX package left them
to XLA. Only the recipe's joint (sum + leaky_relu) is supported.

bf16 (a bf16 model's enc and dec, f32 head parameters), as the JAX
function: the forward's joint and logits in bf16 (``joint @ w.bf16 +
b.bf16``), the log-softmax of the f32 logits; the backward recomputes the
bf16 joint, takes dw, db and d(joint) in f32 (``joint.float()``, ``w``),
the leaky-relu mask from the bf16 ``pre``, sums d(enc) and d(dec) in f32
and casts them to bf16 once. The lattice is f32 either way.
"""

import torch
import torch.nn.functional as F

from tsasr_torch.kernels.rnnt_lattice import rnnt_lattice
from tsasr_torch.ops.rnnt_loss import (_gather_label_blank_logprobs,
                                       _logprob_grads, reduce_losses)
from tsasr_torch.utils.precision import f32_or_wider


def _chunk_joint(enc_c, dec, w, b, slope):
    """enc_c (B, c, J), dec (B, U+1, J) -> (pre, joint, log-probs)."""
    pre = enc_c[:, :, None, :] + dec[:, None, :, :]
    joint = F.leaky_relu(pre, slope)
    logits = joint @ w.to(joint.dtype) + b.to(joint.dtype)
    return pre, joint, torch.log_softmax(logits, dim=-1,
                                         dtype=f32_or_wider(logits))


class _FusedRNNTLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc, dec, w, b, labels, t_lens, u_lens, blank, chunk,
                slope):
        T = enc.shape[1]
        lattices = [_gather_label_blank_logprobs(
            _chunk_joint(enc[:, c0:c0 + chunk], dec, w, b, slope)[2],
            labels, blank) for c0 in range(0, T, chunk)]
        lpb = torch.cat([x[0] for x in lattices], dim=1)
        lpl = torch.cat([x[1] for x in lattices], dim=1)
        loss, dlpb, dlpl = rnnt_lattice(lpb, lpl, t_lens, u_lens)
        ctx.save_for_backward(enc, dec, w, b, labels, dlpb, dlpl)
        ctx.blank, ctx.chunk, ctx.slope = blank, chunk, slope
        return loss

    @staticmethod
    def backward(ctx, g):
        enc, dec, w, b, labels, dlpb, dlpl = ctx.saved_tensors
        chunk, slope = ctx.chunk, ctx.slope
        # everything below is linear in the lattice gradients
        dlpb = dlpb * g[:, None, None]
        dlpl = dlpl * g[:, None, None]
        denc = torch.empty_like(enc)
        # d(dec) sums over the chunks in f32 (or wider) whatever dec's dtype
        ddec = torch.zeros_like(dec, dtype=f32_or_wider(dec))
        dw = torch.zeros_like(w)
        db = torch.zeros_like(b)
        for c0 in range(0, enc.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            pre, joint, lp = _chunk_joint(enc[:, sl], dec, w, b, slope)
            dlogits = _logprob_grads(lp, dlpb[:, sl], dlpl[:, sl], labels,
                                     ctx.blank)
            dw += torch.einsum("bcuj,bcuv->jv", joint.to(dlogits.dtype),
                               dlogits)
            db += dlogits.sum(dim=(0, 1, 2))
            djoint = dlogits @ w.T
            dpre = torch.where(pre > 0, djoint, slope * djoint)
            denc[:, sl] = dpre.sum(dim=2)
            ddec += dpre.sum(dim=1)
        return (denc, ddec.to(dec.dtype), dw, db, None, None, None, None,
                None, None)


def rnnt_loss_fused(enc, dec, head_w, head_b, labels, logit_lengths,
                    label_lengths, blank=0, reduction="none", chunk=8,
                    negative_slope=0.01):
    """RNN-T loss straight from the projected encoder and predictor
    outputs; equal at f32 to

        logits = leaky_relu(enc[:, :, None] + dec[:, None]) @ head_w + head_b
        rnnt_loss(logits, labels, logit_lengths, label_lengths, blank)

    enc (B, T, J), dec (B, U+1, J), head_w (J, V), head_b (V,), labels
    (B, U) int, lengths (B,) absolute. ``chunk`` bounds the transient
    joint at B * chunk * (U+1) * J elements.
    """
    losses = _FusedRNNTLoss.apply(
        enc, dec, head_w, head_b, labels,
        logit_lengths.to(torch.int32).contiguous(),
        label_lengths.to(torch.int32).contiguous(), blank, int(chunk),
        negative_slope)
    return reduce_losses(losses, reduction)
