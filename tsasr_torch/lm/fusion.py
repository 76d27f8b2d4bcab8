"""Shallow fusion with a backoff n-gram LM, as one gather on the device.

Counterpart of the JAX package's ``lm/fusion.py``. For the small token
vocabularies the beams run over (char/BPE) the whole backoff model
densifies exactly: ``table[context_index, token] -> log P(token |
context)`` for every possible (order-1)-token context, and the fused
step is one gather after a context shift. The beams get the same
``lm_step_fn(tokens (N,), state) -> (log_probs (N, V), state)`` contract
as the RNN-LM (``models/lm.py::make_lm_step_fn``), with state = the
context token ids (sentinel-padded before the first real token).

``dense_ngram_table`` is the JAX package's, line for line (numpy); the
step keeps the table on the device it is given. ``load_fusion_lm`` is
the recipe's LM loader, which the transcriber shares.
"""

import math

import numpy as np
import torch

from tsasr_torch.lm.arpa import read_arpa
from tsasr_torch.lm.ngram import BackoffNgramLM
from tsasr_torch.models.lm import load_lm_checkpoint, make_lm_step_fn

LOG10 = math.log(10.0)
FLOOR_LOG10 = -99.0  # conventional ARPA "effectively impossible"


def dense_ngram_table(lm, id2token, bos_token="<s>", bos_id=None):
    """Densify a :class:`BackoffNgramLM` over a token-id vocabulary.

    Builds ``table[(V+1)^(order-1), V]`` of NATURAL-log probabilities
    (matching the RNN-LM's log-softmax convention); context position
    value ``V`` is the sentinel meaning "before sentence start"
    (mapped to ``bos_token`` for the query). ``bos_id`` additionally
    maps that in-vocab id (the blank, which the recipe uses as BOS —
    ``make_text_pipeline``'s ``[blank]+tokens``) to the sentinel, so
    beams that seed the LM with the blank token get start-of-sentence
    statistics instead of an unseen-token backoff.
    """
    V = len(id2token)
    S = V + 1
    ctx_len = lm.top_order - 1
    n_ctx = S ** ctx_len
    table = np.empty((n_ctx, V), np.float32)

    def tok(i):
        return bos_token if i == V or i == bos_id else id2token[i]

    for idx in range(n_ctx):
        ids = [(idx // (S ** j)) % S for j in range(ctx_len)]
        # column 0 = oldest, column ctx_len-1 = most recent; repeated
        # leading sentinels resolve correctly through backoff (the
        # ("<s>", "<s>") context is unseen, backs off to ("<s>",))
        ctx = tuple(tok(i) for i in ids)
        for t in range(V):
            lp = lm.logprob(id2token[t], ctx)
            if lp == float("-inf"):
                lp = FLOOR_LOG10
            table[idx, t] = lp * LOG10
    return table


def make_ngram_lm_step_fn(lm, id2token, bos_token="<s>", bos_id=None,
                          device="cuda"):
    """-> ``(lm_step_fn, lm_initial_state_fn)`` for beam shallow fusion.

    ``lm_step_fn`` accepts a Python int or (N,) token ids; ``state=None``
    means the sentinel (sentence-start) context. The table, the powers
    and every state live on ``device``.
    """
    V = len(id2token)
    S = V + 1
    ctx_len = lm.top_order - 1
    device = torch.device(device)
    table = torch.from_numpy(dense_ngram_table(lm, id2token, bos_token,
                                               bos_id)).to(device)
    powers = torch.tensor([S ** j for j in range(ctx_len)],
                          dtype=torch.long, device=device)

    def initial_state_fn(n):
        return torch.full((n, ctx_len), V, dtype=torch.long, device=device)

    def lm_step_fn(tokens, state):
        arr = torch.as_tensor(tokens, dtype=torch.long, device=device)
        scalar = arr.ndim == 0
        batch = arr[None] if scalar else arr
        if state is None:
            state = initial_state_fn(batch.shape[0])
        if ctx_len > 0:
            state = torch.cat([state[:, 1:], batch[:, None]], dim=1)
            idx = (state * powers[None, :]).sum(dim=-1)
        else:
            idx = torch.zeros(batch.shape[0], dtype=torch.long,
                              device=device)
        lp = table[idx]
        return (lp[0] if scalar else lp), state

    return lm_step_fn, initial_state_fn


def load_fusion_lm(path, weight, pieces, blank_index, device="cuda"):
    """The recipe's shallow-fusion LM (the JAX recipe's
    ``_load_fusion_lm``): ``(lm_step_fn, lm_weight, lm_initial_state_fn)``
    on ``device``, or None without a path or at ``weight <= 0``.
    ``*.arpa`` loads a backoff n-gram over the tokenizer's ``pieces``
    (densified, the blank read as sentence start); any other path is the
    port's RNN-LM checkpoint (``models.lm.save_lm_checkpoint``)."""
    weight = float(weight or 0.0)
    if weight <= 0 or not path:
        return None
    if str(path).endswith(".arpa"):
        with open(path) as f:
            _, ngrams_d, backoffs = read_arpa(f)
        step_fn, initial_state_fn = make_ngram_lm_step_fn(
            BackoffNgramLM(ngrams_d, backoffs), list(pieces),
            bos_id=blank_index, device=device)
        return step_fn, weight, initial_state_fn
    lm = load_lm_checkpoint(path, device)
    return make_lm_step_fn(lm), weight, lm.initial_state
