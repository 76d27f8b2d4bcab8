"""Host-side data pieces: the char tokenizer and batch collation."""

from tsasr_torch.data.batch import PaddedBatch, PaddedData  # noqa: F401
from tsasr_torch.data.tokenizer import WORD_BOUNDARY, CharTokenizer  # noqa: F401
