"""Batched transducer beam search on the device.

Counterpart of the JAX package's ``decoding/beam_batched.py``: a
fixed-beam search where the hypothesis set is a dense (B, K) block and
pruning is masking. The JAX package compiles it as one ``lax.scan`` over
frames with a static inner loop; here the frames and the rounds are
Python loops that only queue work on the device: nothing is read back to
the host until the last frame.

Per frame, ``max_expansions`` rounds of:
  - joint log-probs for all (B, K) hypotheses at this frame;
  - candidate set = {stay: finalize the frame with a blank} ∪
    {expand: append a non-blank, advance the prediction network};
  - top-K over all candidates; "stayed" hypotheses are frozen for the
    rest of the frame.
After the loop any unfrozen hypothesis is forced to take its blank, and
frames past an utterance's valid length change nothing. ``expand_beam``
masks expansions more than ``expand_beam`` below the best expansion;
hypotheses are ranked by ``score / (len + 1)``.

``jax.lax.top_k`` and ``jnp.argsort`` put equal values in index order;
``torch.topk`` promises no order for ties, and on the first frame the
K-1 hypotheses at ``NEG`` tie exactly. So the top K and the final
ranking come from a stable sort, which keeps the JAX package's order on
the CPU and on the card. A bf16 model's log-probs are bf16, where ties
between tokens are common: the same stable sort decides them, and the
hypothesis scores sum in f32.
"""

import numpy as np
import torch

NEG = -1e30


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested tuples / lists (None is an
    empty tree, as in JAX)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _bcast_mask(mask_flat, leaf):
    """Broadcast a (N,) bool mask against a leaf with N at axis -2."""
    shape = [1] * leaf.ndim
    shape[-2] = mask_flat.shape[0]
    return mask_flat.reshape(shape)


def _select_streams(mask_flat, new, old):
    return tree_map(lambda n, o: torch.where(_bcast_mask(mask_flat, o), n, o),
                    new, old)


def beam_search_batched(predict_step, joint_step, initial_state, enc_out,
                        rel_lengths=None, blank=0, beam_size=4,
                        max_symbols=200, max_expansions=3,
                        expand_beam=2.3, lm_step_fn=None, lm_weight=0.0,
                        lm_initial_state=None):
    """
    predict_step : (tokens (N,), state) -> (dec_proj (N, J), state)
    joint_step : (enc (N, J), dec (N, J)) -> log_probs (N, V)
    initial_state : prediction-network state for N = B*K streams; its
        leaves have the stream axis at -2 (LSTM: (L, B*K, H)).
    enc_out : (B, T, J) projected encoder output.
    rel_lengths : (B,) relative lengths.
    lm_step_fn : optional shallow-fusion LM, (tokens (N,), state) ->
        (log_probs (N, V), state); non-blank expansions gain
        ``lm_weight * log p_lm(token)`` and the LM state advances with
        the emission.
    lm_initial_state : LM state for N = B*K streams (with an LM).

    Returns tokens (B, K, max_symbols), lengths (B, K) and the
    length-normalized scores (B, K), best first.
    """
    B, T, _ = enc_out.shape
    K = beam_size
    device = enc_out.device
    if rel_lengths is None:
        abs_len = torch.full((B,), T, dtype=torch.long, device=device)
    else:
        abs_len = torch.round(rel_lengths.to(torch.float32) * T).long()

    def flat(x):                       # (B, K, ...) -> (B*K, ...)
        return x.reshape((B * K,) + x.shape[2:])

    def unflat(x):
        return x.reshape((B, K) + x.shape[1:])

    def gather_k(x, src):              # x (B, K, ...), src (B, K)
        index = src.reshape(src.shape + (1,) * (x.ndim - 2))
        return torch.gather(x, 1, index.expand(src.shape + x.shape[2:]))

    stream_base = torch.arange(B, device=device)[:, None] * K

    def gather_streams(tree, src):
        flat_src = (src + stream_base).reshape(-1)
        return tree_map(lambda leaf: leaf.index_select(leaf.ndim - 2,
                                                       flat_src), tree)

    use_lm = lm_step_fn is not None and lm_weight > 0

    bos = torch.full((B * K,), blank, dtype=torch.long, device=device)
    dec0, state = predict_step(bos, initial_state)
    tokens = torch.full((B, K, max_symbols), blank, dtype=torch.long,
                        device=device)
    lengths = torch.zeros((B, K), dtype=torch.long, device=device)
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    dec = unflat(dec0)
    lm_logp = lm_state = None
    if use_lm:
        lm_logp0, lm_state = lm_step_fn(bos, lm_initial_state)
        lm_logp = unflat(lm_logp0)                        # (B, K, V)
    positions = torch.arange(max_symbols, device=device)

    for t in range(T):
        enc_flat = enc_out[:, t].repeat_interleave(K, dim=0)   # (B*K, J)
        f_tokens, f_lengths, f_scores, f_dec = tokens, lengths, scores, dec
        f_state, f_lm_logp, f_lm_state = state, lm_logp, lm_state
        frozen = torch.zeros((B, K), dtype=torch.bool, device=device)
        for _ in range(max_expansions):
            logp = unflat(joint_step(enc_flat, flat(f_dec)))    # (B, K, V)
            V = logp.shape[-1]
            stay_scores = torch.where(frozen, f_scores,
                                      f_scores + logp[..., blank])
            expand_total = f_scores[..., None] + logp
            if use_lm:
                expand_total = expand_total + lm_weight * f_lm_logp
            # the blank column, frozen and full hypotheses cannot expand
            expand_total[..., blank] = NEG
            expand_total = torch.where(frozen[..., None], NEG, expand_total)
            expand_total = torch.where(
                (f_lengths >= max_symbols)[..., None], NEG, expand_total)
            # expand_beam pruning relative to the best expansion
            best_expand = expand_total.amax(dim=(1, 2), keepdim=True)
            expand_total = torch.where(
                expand_total >= best_expand - expand_beam, expand_total,
                NEG)

            cand = torch.cat([stay_scores, expand_total.reshape(B, K * V)],
                             dim=1)
            top_scores, top_idx = torch.sort(cand, dim=1, descending=True,
                                             stable=True)
            top_scores, top_idx = top_scores[:, :K], top_idx[:, :K]
            is_stay = top_idx < K
            src = torch.where(is_stay, top_idx, (top_idx - K) // V)
            new_tok = torch.where(is_stay, blank, (top_idx - K) % V)

            f_tokens = gather_k(f_tokens, src)
            lengths_g = gather_k(f_lengths, src)
            frozen_g = gather_k(frozen, src)
            dec_g = gather_k(f_dec, src)
            state_g = gather_streams(f_state, src)

            # append the emitted token for expanded hypotheses
            emit = ~is_stay
            pos = lengths_g.clamp(0, max_symbols - 1)
            at_pos = positions[None, None, :] == pos[..., None]
            f_tokens = torch.where(at_pos & emit[..., None],
                                   new_tok[..., None], f_tokens)
            f_lengths = lengths_g + emit.long()

            # advance the prediction network for expanded hypotheses
            new_dec_flat, new_state = predict_step(flat(new_tok), state_g)
            emit_flat = emit.reshape(-1)
            f_dec = unflat(torch.where(emit_flat[:, None], new_dec_flat,
                                       flat(dec_g)))
            f_state = _select_streams(emit_flat, new_state, state_g)

            if use_lm:
                lm_logp_g = gather_k(f_lm_logp, src)
                lm_state_g = gather_streams(f_lm_state, src)
                new_lm_logp, new_lm_state = lm_step_fn(flat(new_tok),
                                                       lm_state_g)
                f_lm_logp = torch.where(emit[..., None],
                                        unflat(new_lm_logp), lm_logp_g)
                f_lm_state = _select_streams(emit_flat, new_lm_state,
                                             lm_state_g)
            f_scores = top_scores
            frozen = frozen_g | is_stay

        # force unfrozen hypotheses to consume their blank
        logp = unflat(joint_step(enc_flat, flat(f_dec)))
        f_scores = torch.where(frozen, f_scores,
                               f_scores + logp[..., blank])

        # frames past the valid length change nothing
        valid = t < abs_len                                   # (B,)
        tokens = torch.where(valid[:, None, None], f_tokens, tokens)
        lengths = torch.where(valid[:, None], f_lengths, lengths)
        scores = torch.where(valid[:, None], f_scores, scores)
        dec = torch.where(valid[:, None, None], f_dec, dec)
        stream_valid = valid.repeat_interleave(K)
        state = _select_streams(stream_valid, f_state, state)
        if use_lm:
            lm_logp = torch.where(valid[:, None, None], f_lm_logp, lm_logp)
            lm_state = _select_streams(stream_valid, f_lm_state, lm_state)

    # length-normalized ranking: score / len(prediction) with the BOS
    # counted
    norm = scores / torch.clamp(lengths + 1, min=1)
    order = torch.sort(-norm, dim=1, stable=True)[1]
    return (gather_k(tokens, order), gather_k(lengths, order),
            gather_k(norm, order))


class BatchedBeamSearcher:
    """The searcher interface over ``beam_search_batched``:
    ``__call__(enc_out, rel_lengths)`` -> (best hyps, mean exp score,
    nbest hyps, nbest scores). ``lm_initial_state_fn(n)`` gives the LM
    state of n streams."""

    def __init__(self, model, blank_index=0, beam_size=4, nbest=1,
                 expand_beam=2.3, max_expansions=3, max_symbols=300,
                 lm_step_fn=None, lm_weight=0.0, lm_initial_state_fn=None):
        self.model = model
        self.blank = blank_index
        self.beam_size = beam_size
        self.nbest = nbest
        self.expand_beam = expand_beam
        self.max_expansions = max_expansions
        self.max_symbols = max_symbols
        self.lm_step_fn = lm_step_fn
        self.lm_weight = lm_weight
        self.lm_initial_state_fn = lm_initial_state_fn
        if lm_weight > 0 and (lm_step_fn is None
                              or lm_initial_state_fn is None):
            raise ValueError("lm_weight > 0 requires lm_step_fn and "
                             "lm_initial_state_fn")

    def _joint_step(self, enc, dec):
        logits = self.model.joint_logits(enc[:, None, :],
                                         dec[:, None, :])[:, 0, :]
        return torch.log_softmax(logits, dim=-1)

    @torch.inference_mode()
    def decode(self, enc_out, rel_lengths=None):
        """(tokens (B, K, max_symbols), lengths (B, K), normalized scores
        (B, K)) on the encoder output's device, best first."""
        n = enc_out.shape[0] * self.beam_size
        state0 = self.model.predictor_initial_state(n, enc_out.device)
        lm_state0 = None
        if self.lm_weight > 0:
            lm_state0 = self.lm_initial_state_fn(n)
        return beam_search_batched(
            self.model.predict_step, self._joint_step, state0, enc_out,
            rel_lengths, blank=self.blank, beam_size=self.beam_size,
            max_symbols=self.max_symbols,
            max_expansions=self.max_expansions,
            expand_beam=self.expand_beam, lm_step_fn=self.lm_step_fn,
            lm_weight=self.lm_weight, lm_initial_state=lm_state0)

    def __call__(self, enc_out, rel_lengths=None):
        tokens, lengths, norm_scores = (
            x.cpu().numpy() for x in self.decode(enc_out, rel_lengths))
        best, nbest_all, nbest_scores = [], [], []
        for b in range(tokens.shape[0]):
            hyps = [tokens[b, k, :lengths[b, k]].tolist()
                    for k in range(min(self.nbest, tokens.shape[1]))]
            best.append(hyps[0])
            nbest_all.append(hyps)
            nbest_scores.append(norm_scores[b, :self.nbest].tolist())
        mean_score = float(np.exp(norm_scores[:, 0]).mean())
        return best, mean_score, nbest_all, nbest_scores
