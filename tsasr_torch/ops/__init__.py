"""Feature, mask, dropout and RNN-T loss ops."""

from tsasr_torch.ops.features import (  # noqa: F401
    Fbank,
    input_normalization,
    pad_audio_to_frame_multiple,
)
from tsasr_torch.ops.masks import (  # noqa: F401
    length_to_mask,
    lookahead_mask,
    relative_to_absolute_lengths,
)
