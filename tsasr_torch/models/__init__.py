"""The TS-Conformer transducer as ``nn.Module``s (the WavLM x-vector
speaker encoder is ``tsasr_torch.models.wavlm``)."""

from tsasr_torch.models.attention import RelPosMHAXL, rel_pos_encoding  # noqa: F401
from tsasr_torch.models.conformer import (  # noqa: F401
    ConformerEncoderLayer,
    TSConformerEncoder,
)
from tsasr_torch.models.frontend import ConvolutionFrontEnd  # noqa: F401
from tsasr_torch.models.rnn import LSTM  # noqa: F401
from tsasr_torch.models.transducer import (  # noqa: F401
    TSTransducer,
    TSTransducerConfig,
    scratch_config,
)
