"""Greedy transducer decoding.

Counterpart of the JAX package's ``decoding/greedy.py``: at most one
emission per encoder frame; the prediction network is stepped for every
row and its result kept (by select) only where a row emitted a
non-blank, as in the JAX scan. The frame loop only queues device work:
nothing is read back to the host until the loop ends. A bf16 model gives
bf16 log-probs (a log-softmax of bf16 logits, as the JAX searcher takes
them); the argmax keeps the first index on a tie, as ``jnp.argmax``
does, and the scores sum in f32.
"""

import torch


def greedy_decode(predict_step, joint_step, initial_state, enc_out,
                  rel_lengths=None, blank=0):
    """
    predict_step : (token (B,), state) -> (dec_proj (B, J), state)
    joint_step : (enc_t (B, J), dec (B, J)) -> log_probs (B, V)
    enc_out : (B, T, J) projected encoder output.
    rel_lengths : (B,) relative lengths; frames at or beyond
        ``round(rel * T)`` never emit.

    Returns tokens (B, T) int32 (blank where nothing was emitted),
    counts (B,) int32 and scores (B,) f32, the sum of emitted log-probs.
    """
    B, T, _ = enc_out.shape
    device = enc_out.device
    if rel_lengths is None:
        abs_len = torch.full((B,), T, dtype=torch.int32, device=device)
    else:
        abs_len = torch.round(rel_lengths * T).to(torch.int32)

    bos = torch.full((B,), blank, dtype=torch.long, device=device)
    dec, state = predict_step(bos, initial_state)
    count = torch.zeros(B, dtype=torch.int32, device=device)
    score = torch.zeros(B, dtype=torch.float32, device=device)
    tokens = []
    for t in range(T):
        log_probs = joint_step(enc_out[:, t], dec)
        best = log_probs.argmax(dim=-1)             # first index on ties
        best_lp = log_probs.gather(-1, best[:, None])[:, 0]
        emit = (best != blank) & (t < abs_len)
        new_dec, new_state = predict_step(best, state)
        dec = torch.where(emit[:, None], new_dec, dec)
        state = tuple(torch.where(emit[None, :, None], new, old)
                      for new, old in zip(new_state, state))
        count = count + emit.to(torch.int32)
        score = score + torch.where(emit, best_lp, 0.0)
        tokens.append(torch.where(emit, best, blank))
    return torch.stack(tokens, dim=1).to(torch.int32), count, score


class TransducerGreedySearcher:
    """Returns Python token lists, as the reference searcher does:
    ``(hyps, mean exp score, None, None)``."""

    def __init__(self, model, blank_index=0):
        self.model = model
        self.blank = blank_index

    def _joint_step(self, enc_t, dec):
        logits = self.model.joint_logits(enc_t[:, None, :],
                                         dec[:, None, :])[:, 0, :]
        return torch.log_softmax(logits, dim=-1)

    @torch.inference_mode()
    def __call__(self, enc_out, rel_lengths=None):
        state0 = self.model.predictor_initial_state(enc_out.shape[0],
                                                    enc_out.device)
        tokens, _, scores = greedy_decode(
            self.model.predict_step, self._joint_step, state0, enc_out,
            rel_lengths, self.blank)
        tokens = tokens.cpu().numpy()
        hyps = [[int(tok) for tok in row if tok != self.blank]
                for row in tokens]
        mean_score = float(torch.exp(scores).mean().cpu())
        return hyps, mean_score, None, None
