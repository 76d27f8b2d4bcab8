"""N-gram counting primitives.

Fresh implementation of the reference's counting pipeline
(``speechbrain/lm/counting.py:1-162``): sentence-end padding, n-gram
extraction, evaluation-context generation, plus a count accumulator used
by :func:`tsasr_torch.lm.ngram.train_backoff_ngram`.

The port's own copy of the JAX package's ``lm/counting.py``, line for
line, with its imports pointed at ``tsasr_torch``.
"""

from collections import Counter, defaultdict

SENT_START = "<s>"
SENT_END = "</s>"


def pad_ends(sequence, pad_left=True, left_pad_symbol=SENT_START,
             right_pad_symbol=SENT_END):
    """Sentence with start/end symbols attached (as a list).

    ``<s>`` conditions the first prediction and ``</s>`` is predicted,
    matching the reference convention (``lm/counting.py:17-60``).
    """
    body = list(sequence) + [right_pad_symbol]
    return ([left_pad_symbol] + body) if pad_left else body


def ngrams(sequence, n):
    """All order-``n`` n-grams of ``sequence`` as tuples."""
    if n <= 0:
        raise ValueError("n-gram order must be >= 1")
    seq = list(sequence)
    return [tuple(seq[i:i + n]) for i in range(len(seq) - n + 1)]


def ngrams_for_evaluation(sequence, max_n, predict_first=False):
    """Yield ``(token, context)`` pairs with contexts growing up to
    ``max_n - 1`` tokens (reference ``lm/counting.py:110-162``).

    With ``predict_first=False`` the first token (usually ``<s>``) is
    context only, never predicted.
    """
    if max_n <= 0:
        raise ValueError("max_n must be >= 1")
    seq = list(sequence)
    start = 0 if predict_first else 1
    for i in range(start, len(seq)):
        lo = max(0, i - (max_n - 1))
        yield seq[i], tuple(seq[lo:i])


def count_ngrams(sentences, order, pad=True):
    """Count all n-grams of orders ``1..order`` over tokenized sentences.

    Returns ``{n: Counter{ngram_tuple: count}}``. Sentences are
    end-padded by default so ``</s>`` is learnable and ``<s>`` appears
    only as context.
    """
    counts = defaultdict(Counter)
    for sent in sentences:
        toks = pad_ends(sent) if pad else list(sent)
        for n in range(1, order + 1):
            counts[n].update(ngrams(toks, n))
    return dict(counts)
