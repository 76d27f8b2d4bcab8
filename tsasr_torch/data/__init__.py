"""Host-side data: manifests, dynamic items, mixing, tokenizers,
dynamic batching and the checkpointable loader (numpy only)."""

from tsasr_torch.data.batch import PaddedBatch, PaddedData  # noqa: F401
from tsasr_torch.data.dataset import (  # noqa: F401
    DynamicItemDataset,
    add_dynamic_item,
    set_output_keys,
)
from tsasr_torch.data.loader import (  # noqa: F401
    LoopedLoader,
    SaveableDataLoader,
    make_dataloader,
)
from tsasr_torch.data.pipeline import DataPipeline, provides, takes  # noqa: F401
from tsasr_torch.data.prepare import prepare_librispeechmix  # noqa: F401
from tsasr_torch.data.sampler import (  # noqa: F401
    DistributedSamplerWrapper,
    DynamicBatchSampler,
)
from tsasr_torch.data.tokenizer import (  # noqa: F401
    WORD_BOUNDARY,
    CharTokenizer,
    load_tokenizer,
    train_tokenizer,
)
