"""The frozen speaker encoder of the ``pretrained`` recipe.

Counterpart of the JAX package's ``recipes/speaker_embeddings.py::
JaxSpeakerEncoder``: the port's WavLM x-vector model
(``models/wavlm.py``) loaded from a local HF checkpoint directory and run
frozen on the caller's device inside the training step, as the reference
runs HF's model under ``no_grad`` per batch. Its parameters are outside
the trained model, so they are neither in the optimizer nor in the
checkpoint.

The JAX package's second backend, a host d-vector cache over HF
``transformers`` (``torch_cache``), is not ported: it needs HF
``transformers``, which the port does not use.
"""

import logging
import os

import torch

from tsasr_torch.device import resolve_device
from tsasr_torch.models.wavlm import load_pretrained_xvector

logger = logging.getLogger(__name__)


def is_checkpoint_dir(path):
    """Whether ``path`` is a local HF checkpoint directory."""
    return bool(path) and os.path.isdir(path) and os.path.exists(
        os.path.join(path, "config.json"))


def require_checkpoint_dir(path):
    """Raise ``FileNotFoundError`` unless ``path`` is a local HF
    checkpoint directory."""
    if not is_checkpoint_dir(path):
        raise FileNotFoundError(
            f"speaker_encoder_path {path!r} is not a local HF checkpoint "
            "directory (config.json + model.safetensors or "
            "pytorch_model.bin); put the WavLM-sv checkpoint there first")


class FrozenSpeakerEncoder:
    """Frozen WavLM x-vector d-vectors on ``device`` (CUDA unless the
    caller asks for the CPU).

    ``embed(wav (B, L), rel_lens (B,))`` -> (B, 1, E) pooled embeddings,
    the valid lengths ``min(ceil(rel * L), L)`` as the reference masks;
    no gradient flows into the encoder. ``embedding_dim`` must be the
    checkpoint's x-vector width (the yaml's ``speaker_embedding_dim``).

    ``frame_level`` (the ``cross_attention`` injection) gives the frames
    (B, S, embedding_dim) instead: the first ``embedding_dim`` channels
    of the last hidden state, as the JAX ``JaxSpeakerEncoder`` and the
    reference take them (512 of WavLM-base's 768).
    """

    def __init__(self, model_path, frame_level=False, embedding_dim=512,
                 device="cuda"):
        require_checkpoint_dir(model_path)
        self.device = resolve_device(device)
        self.config, model = load_pretrained_xvector(model_path)
        width, what = (self.config.hidden_size, "hidden states") \
            if frame_level else (self.config.xvector_output_dim, "x-vectors")
        if embedding_dim > width or (not frame_level
                                     and embedding_dim != width):
            raise ValueError(
                f"the checkpoint's {what} have {width} dimensions, "
                f"speaker_embedding_dim is {embedding_dim}")
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.frame_level = frame_level
        self.embedding_dim = embedding_dim
        logger.info("%.1fM parameters in the frozen speaker encoder",
                    sum(p.numel() for p in self.model.parameters()) / 1e6)

    @torch.no_grad()
    def embed(self, wav, rel_lens):
        L = wav.shape[1]
        lengths = torch.clamp(torch.ceil(rel_lens * L), max=L).to(torch.int64)
        out = self.model(wav, lengths)
        if self.frame_level:
            return out["hidden_states"][-1][..., :self.embedding_dim]
        return out["embeddings"][:, None, :]
