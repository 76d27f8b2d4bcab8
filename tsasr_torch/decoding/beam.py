"""Transducer beam search with state/expand pruning + optional LM fusion.

Counterpart of the JAX package's ``decoding/beam.py``, the exact
reference algorithm (the monotonic RNN-T beam of arXiv:1911.01629):

per frame: move hypotheses A -> B; repeatedly take the best hyp in A,
stop early when the best in B beats it by ``state_beam``; expand with the
top-k joint outputs; blank extensions land in B, non-blank extensions
within ``expand_beam`` of the best non-blank go back to A with an advanced
prediction-network state; finish when |B| >= beam_size. Hypotheses are
score-normalized by length for selection, and nbest scores are
``logp_score / len(prediction)``.

The priority queue runs on the host; each popped hypothesis makes one
prediction-network step and one joint call on the device and reads its
log-probs back. The top k come from ``np.argpartition`` / ``np.argsort``
of that host copy, as in the JAX package, so ties fall the same way.
Below beam 2 the greedy searcher runs instead.
"""

import numpy as np
import torch

from tsasr_torch.decoding.greedy import TransducerGreedySearcher


class _Hyp:
    __slots__ = ("prediction", "logp_score", "state", "lm_state")

    def __init__(self, prediction, logp_score, state, lm_state=None):
        self.prediction = prediction
        self.logp_score = logp_score
        self.state = state
        self.lm_state = lm_state

    @property
    def norm_score(self):
        return self.logp_score / len(self.prediction)


class TransducerBeamSearcher:
    """Beam (or greedy when beam_size==1) search over encoder outputs:
    ``__call__(enc_out [, rel_lengths])`` -> (best hyps, mean exp score,
    nbest, nbest scores)."""

    def __init__(self, model, blank_index=0, beam_size=4, nbest=5,
                 lm_step_fn=None, lm_weight=0.0, state_beam=2.3,
                 expand_beam=2.3):
        self.model = model
        self.blank = blank_index
        self.beam_size = beam_size
        self.nbest = nbest
        self.lm_step_fn = lm_step_fn
        self.lm_weight = lm_weight
        if lm_step_fn is None and lm_weight > 0:
            raise ValueError("lm_weight > 0 requires lm_step_fn")
        self.state_beam = state_beam
        self.expand_beam = expand_beam
        self._greedy = TransducerGreedySearcher(model, blank_index) \
            if beam_size <= 1 else None

    # ------------------------------------------------------- device calls
    def _predict_step(self, token, state, device):
        tokens = torch.tensor([token], dtype=torch.long, device=device)
        return self.model.predict_step(tokens, state)

    def _joint_log_probs(self, enc_t, dec):
        """enc_t (J,), dec (1, J) -> host log-probs (V,), f32 on the host
        (a bf16 model's log-probs are bf16, which f32 holds exactly; the
        scores sum as Python floats)."""
        logits = self.model.joint_logits(enc_t[None, None, :],
                                         dec[:, None, :])[:, 0, :]
        return torch.log_softmax(logits, dim=-1)[0].float().cpu().numpy()

    def _initial_state(self, device):
        return self.model.predictor_initial_state(1, device)

    # -------------------------------------------------------------- search
    @torch.inference_mode()
    def __call__(self, enc_out, rel_lengths=None):
        if self._greedy is not None:
            return self._greedy(enc_out, rel_lengths)
        B, T, _ = enc_out.shape
        if rel_lengths is None:
            abs_lens = [T] * B
        else:
            abs_lens = torch.round(rel_lengths.to(torch.float32) * T
                                   ).long().tolist()
        best, nbest_all, nbest_scores_all = [], [], []
        for b in range(B):
            hyps, scores = self._search_utterance(enc_out[b],
                                                  int(abs_lens[b]))
            best.append(hyps[0])
            nbest_all.append(hyps)
            nbest_scores_all.append(scores)
        mean_score = float(np.exp([s[0] for s in nbest_scores_all]).mean())
        return best, mean_score, nbest_all, nbest_scores_all

    def _search_utterance(self, enc_out, T):
        beam = [_Hyp([self.blank], 0.0, self._initial_state(enc_out.device))]
        # Safety valve: the A*-style loop can blow up on near-uniform
        # (e.g. untrained) models where blank never reaches the top-k;
        # cap expansions per frame (no effect on trained models, where
        # blank dominates).
        max_steps_per_frame = max(64, 16 * self.beam_size)
        for t in range(T):
            process, beam = beam, []
            steps = 0
            while len(beam) < self.beam_size and process and \
                    steps < max_steps_per_frame:
                steps += 1
                a_best = max(process, key=lambda h: h.norm_score)
                if beam:
                    b_best = max(beam, key=lambda h: h.norm_score)
                    if b_best.logp_score >= self.state_beam + \
                            a_best.logp_score:
                        break
                process.remove(a_best)

                dec, new_state = self._predict_step(
                    a_best.prediction[-1], a_best.state, enc_out.device)
                log_probs = self._joint_log_probs(enc_out[t], dec)

                if self.lm_weight > 0:
                    lm_log_probs, lm_state = self.lm_step_fn(
                        a_best.prediction[-1], a_best.lm_state)
                    lm_log_probs = lm_log_probs.cpu().numpy()

                k = min(self.beam_size, log_probs.shape[-1])
                top_idx = np.argpartition(-log_probs, k - 1)[:k]
                top_idx = top_idx[np.argsort(-log_probs[top_idx])]
                if top_idx[0] != self.blank:
                    best_logp = log_probs[top_idx[0]]
                else:
                    best_logp = log_probs[top_idx[1]]

                for idx in top_idx:
                    idx = int(idx)
                    logp = float(log_probs[idx])
                    if idx == self.blank:
                        beam.append(_Hyp(a_best.prediction[:],
                                         a_best.logp_score + logp,
                                         a_best.state, a_best.lm_state))
                        continue
                    if logp >= best_logp - self.expand_beam:
                        new_score = a_best.logp_score + logp
                        lm_s = a_best.lm_state
                        if self.lm_weight > 0:
                            new_score += self.lm_weight \
                                * float(lm_log_probs[idx])
                            lm_s = lm_state
                        process.append(_Hyp(a_best.prediction + [idx],
                                            new_score, new_state, lm_s))
            if not beam:
                # pathological frame (see safety valve above): carry the
                # best unfinished hypotheses forward
                beam = sorted(process, key=lambda h: h.norm_score,
                              reverse=True)[: self.beam_size]
        ranked = sorted(beam, key=lambda h: h.norm_score,
                        reverse=True)[: self.nbest]
        if not ranked:
            return [[]], [0.0]
        return ([h.prediction[1:] for h in ranked],
                [h.norm_score for h in ranked])
