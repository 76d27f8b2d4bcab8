"""The tiny scratch step of ``tests/test_torch_distributed.py``, shared
by the test (one process) and its gloo workers (two ranks); imports no
JAX, so a worker starts in seconds."""

import contextlib

import numpy as np
import torch

from tsasr_torch.data.batch import PaddedBatch
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.recipes.librispeechmix import TSASRBrain

# torch_port_helpers.TINY at dropout 0
CONFIG = dict(d_model=32, nhead=4, encoder_num_layers=2, d_ffn=64,
              kernel_size=7, speaker_encoder_layers=1, decoder_neurons=32,
              joint_dim=48, frontend_channels=(8, 8), fused_attention=True,
              dropout=0.0)
# no optimizer step inside the test's micro-batches: the accumulated mean
# of one micro-batch is its gradient
HPARAMS = {"sample_rate": 16000, "n_fft": 512, "n_mels": 80,
           "win_length": 32, "augment": True, "blank_index": 0,
           "pad_feats_to": 32, "fused_joint_loss": True,
           "fused_loss_chunk": 3, "valid_search_freq": 1,
           "grad_accumulation_factor": 1000, "seed": 3}
PADDED_KEYS = ["mixed_sig", "enroll_sig", "tokens_bos", "tokens"]


class F64Brain(TSASRBrain):
    """The recipe's Brain with its float inputs in f64 (the model and the
    Fbank made f64 by ``step_brain``)."""

    def batch_to_arrays(self, batch):
        return {k: v.astype(np.float64) if v.dtype == np.float32 else v
                for k, v in super().batch_to_arrays(batch).items()}


def step_brain(state, augment, dtype=torch.float32):
    """A Brain over the tiny model with the weights ``state``, in
    ``dtype``, with ``augment`` set."""
    model = TSTransducer(TSTransducerConfig(**CONFIG))
    model.load_state_dict(state)
    brain = (F64Brain if dtype == torch.float64 else TSASRBrain)(
        modules={"model": model}, hparams=dict(HPARAMS, augment=augment),
        run_opts={"device": "cpu"})
    brain.model.to(dtype)
    brain.fbank.to(dtype)
    return brain


@contextlib.contextmanager
def default_dtype(dtype):
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(saved)


def fit(brain, examples, dtype=torch.float32):
    """``brain.fit_batch`` of the examples; returns (loss, gradients)."""
    with default_dtype(dtype):
        loss = brain.fit_batch(PaddedBatch(examples, padded_keys=PADDED_KEYS))
    return loss, None if brain._acc is None else [a.clone()
                                                  for a in brain._acc]
