"""Transducer decoding: greedy, the batched beam and the exact beam."""

from tsasr_torch.decoding.beam import TransducerBeamSearcher  # noqa: F401
from tsasr_torch.decoding.beam_batched import (  # noqa: F401
    BatchedBeamSearcher,
    beam_search_batched,
)
from tsasr_torch.decoding.greedy import (  # noqa: F401
    TransducerGreedySearcher,
    greedy_decode,
)
