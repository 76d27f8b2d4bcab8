"""Backoff n-gram language model: query, estimation, perplexity.

The query interface and the (ngrams, backoffs) nested-dict layout match
the reference (``speechbrain/lm/ngram.py:12-200``) so ARPA files loaded
by :mod:`tsasr_torch.lm.arpa` plug straight in. Estimation
(:func:`train_backoff_ngram`, absolute discounting) goes beyond the
reference, which ships only counting + query.

The port's own copy of the JAX package's ``lm/ngram.py``, line for
line, with its imports pointed at ``tsasr_torch``.
"""

import math
from collections import Counter, defaultdict

from tsasr_torch.lm.counting import SENT_START, count_ngrams

NEG_INF = float("-inf")


class BackoffNgramLM:
    """Katz-style backoff query over nested log10-prob dicts.

    ``ngrams[n][context_tuple][token] -> logprob`` and
    ``backoffs[n][context_tuple] -> log backoff weight`` (orders with no
    entries may be empty dicts; backoffs may omit the top order).
    """

    def __init__(self, ngrams, backoffs):
        order = len(ngrams)
        if len(backoffs) not in (order, order - 1):
            raise ValueError("backoffs must cover orders N or N-1")
        self.ngrams = ngrams
        self.backoffs = backoffs
        self.top_order = order

    def logprob(self, token, context=()):
        """log10 P(token | context) with iterative backoff: accumulate
        backoff weights while shortening the context until a stored
        probability (or the unigram floor) is reached."""
        context = tuple(context)
        if len(context) + 1 > self.top_order:
            context = context[-(self.top_order - 1):] \
                if self.top_order > 1 else ()
        acc = 0.0
        while True:
            order = len(context) + 1
            dist = self.ngrams.get(order, {}).get(context)
            if dist is not None and token in dist:
                return acc + dist[token]
            if order == 1:
                return NEG_INF
            acc += self.backoffs.get(order - 1, {}).get(context, 0.0)
            context = context[1:]


def ngram_evaluation_details(data, lm):
    """Per-sentence ``Counter(num_tokens, neglogprob)`` list.

    ``data`` iterates sentences of ``(token, context)`` pairs (see
    :func:`tsasr_torch.lm.counting.ngrams_for_evaluation`).
    """
    details = []
    for sentence in data:
        c = Counter()
        for token, context in sentence:
            c["num_tokens"] += 1
            c["neglogprob"] += -lm.logprob(token, context)
        details.append(c)
    return details


def ngram_perplexity(eval_details, logbase=10.0):
    """Corpus perplexity from :func:`ngram_evaluation_details` output."""
    total = sum(eval_details, Counter())
    return logbase ** (total["neglogprob"] / total["num_tokens"])


def train_backoff_ngram(sentences, order=3, discount=0.5):
    """Estimate a backoff model with absolute discounting.

    For each seen n-gram, ``P(w|h) = (c(hw) - D) / c(h)``; the mass
    removed by the discount becomes the backoff weight
    ``b(h) = D * N1+(h) / c(h)`` renormalized by the lower-order escape
    mass, i.e. the standard absolute-discounting backoff construction.
    Unigrams are NOT discounted against an open vocabulary: the unigram
    distribution is the MLE over seen tokens (``<s>`` excluded from
    prediction mass, as in ARPA convention where ``P(<s>)`` is -inf or
    tiny — here it is simply absent).

    Returns ``(ngrams, backoffs)`` dicts (log10) ready for
    :class:`BackoffNgramLM` / :func:`tsasr_torch.lm.arpa.write_arpa`.
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    counts = count_ngrams(sentences, order)
    ngrams = {n: defaultdict(dict) for n in range(1, order + 1)}
    backoffs = {n: {} for n in range(1, order)}

    # unigrams: MLE over predicted tokens (<s> never predicted)
    uni = {w: c for (w,), c in counts.get(1, Counter()).items()
           if w != SENT_START}
    uni_total = sum(uni.values())
    for w, c in uni.items():
        ngrams[1][()][w] = math.log10(c / uni_total)

    def lower_logprob(token, context):
        lm = BackoffNgramLM(
            {n: dict(ngrams[n]) for n in range(1, len(context) + 2)},
            {n: backoffs[n] for n in range(1, len(context) + 1)})
        return lm.logprob(token, context)

    for n in range(2, order + 1):
        ctx_totals = Counter()
        ctx_types = Counter()
        for gram, c in counts[n].items():
            ctx_totals[gram[:-1]] += c
            ctx_types[gram[:-1]] += 1
        for gram, c in counts[n].items():
            ctx, tok = gram[:-1], gram[-1]
            p = max(c - discount, 0.0) / ctx_totals[ctx]
            if p > 0:
                ngrams[n][ctx][tok] = math.log10(p)
        for ctx in ctx_totals:
            # leftover mass for unseen continuations of this context
            left = discount * ctx_types[ctx] / ctx_totals[ctx]
            # lower-order escape mass: 1 - sum of P_lower over the seen
            # continuations of ctx
            seen_lower = sum(
                10.0 ** lower_logprob(tok, ctx[1:])
                for tok in ngrams[n][ctx])
            denom = max(1.0 - seen_lower, 1e-12)
            backoffs[n - 1][ctx] = math.log10(max(left, 1e-12) / denom)

    return ({n: dict(d) for n, d in ngrams.items()}, backoffs)
