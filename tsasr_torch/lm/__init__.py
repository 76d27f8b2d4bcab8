"""Count-based (backoff n-gram) language modeling.

Counterpart of the JAX package's ``lm`` package: n-gram counting,
backoff-model estimation, ARPA read/write and perplexity (numpy-only
copies of its modules, line for line), and the dense fusion scorer for
the beams, with its table on the device.
"""

from tsasr_torch.lm.arpa import read_arpa, write_arpa
from tsasr_torch.lm.counting import (
    count_ngrams,
    ngrams,
    ngrams_for_evaluation,
    pad_ends,
)
from tsasr_torch.lm.fusion import dense_ngram_table, make_ngram_lm_step_fn
from tsasr_torch.lm.ngram import (
    BackoffNgramLM,
    ngram_evaluation_details,
    ngram_perplexity,
    train_backoff_ngram,
)

__all__ = [
    "BackoffNgramLM",
    "count_ngrams",
    "dense_ngram_table",
    "make_ngram_lm_step_fn",
    "ngram_evaluation_details",
    "ngram_perplexity",
    "ngrams",
    "ngrams_for_evaluation",
    "pad_ends",
    "read_arpa",
    "train_backoff_ngram",
    "write_arpa",
]
