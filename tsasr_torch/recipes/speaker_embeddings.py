"""The frozen speaker encoder of the ``pretrained`` recipe.

Counterpart of the JAX package's ``recipes/speaker_embeddings.py::
JaxSpeakerEncoder``: the port's WavLM x-vector model
(``models/wavlm.py``) loaded from a local HF checkpoint directory and run
frozen on the caller's device inside the training step, as the reference
runs HF's model under ``no_grad`` per batch. Its parameters are outside
the trained model, so they are neither in the optimizer nor in the
checkpoint.

The recipe's backend rule lives here, so that the recipe and the
transcriber build the same encoder from the same hparams
(``FrozenSpeakerEncoder.from_hparams``): ``resolve_speaker_backend``
picks it as the JAX recipe does, and ``check_speaker_backend`` raises for
what the port does not run. The JAX package's second backend, a host
d-vector cache over HF ``transformers`` (``torch_cache``), is not
ported: it needs HF ``transformers``, which the port does not use.
"""

import logging
import os

import torch

from tsasr_torch.device import resolve_device
from tsasr_torch.models.wavlm import load_pretrained_xvector
from tsasr_torch.utils.hparams import hparams_getter

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


def resolve_speaker_backend(hparams):
    """The frozen speaker encoder's backend for the ``pretrained``
    variant, as the JAX recipe picks it: ``speaker_encoder_backend``, or
    for ``auto`` the on-device encoder (``jax``) when
    ``speaker_encoder_path`` is a local checkpoint directory, else
    ``torch_cache``. The port runs ``jax`` as ``FrozenSpeakerEncoder``;
    ``torch_cache`` is not ported."""
    get = hparams_getter(hparams)
    backend = get("speaker_encoder_backend", "auto")
    if backend != "auto":
        return backend
    return "jax" if is_checkpoint_dir(get("speaker_encoder_path", "")) \
        else "torch_cache"


def check_speaker_backend(hparams):
    """Raise for a ``pretrained`` speaker backend the port does not run,
    and for a checkpoint directory that is not there."""
    backend = resolve_speaker_backend(hparams)
    if backend == "torch_cache":
        raise NotImplementedError(
            "speaker_encoder_backend torch_cache (what auto picks when "
            "speaker_encoder_path is no local checkpoint directory, e.g. a "
            "hub id) is not ported: it needs HF transformers; point "
            "speaker_encoder_path at a local WavLM-sv checkpoint directory")
    if backend != "jax":
        raise ValueError(f"unknown speaker_encoder_backend {backend!r}")
    require_checkpoint_dir(hparams_getter(hparams)("speaker_encoder_path"))


class FrozenSpeakerEncoder:
    """Frozen WavLM x-vector d-vectors on ``device`` (CUDA unless the
    caller asks for the CPU).

    ``embed(wav (B, L), rel_lens (B,))`` -> (B, 1, E) pooled embeddings,
    the valid lengths ``min(ceil(rel * L), L)`` as the reference masks;
    no gradient flows into the encoder. ``embedding_dim`` must be the
    checkpoint's x-vector width (the yaml's ``speaker_embedding_dim``);
    None takes it from the checkpoint.

    ``frame_level`` (the ``cross_attention`` injection) gives the frames
    (B, S, embedding_dim) instead: the first ``embedding_dim`` channels
    of the last hidden state, as the JAX ``JaxSpeakerEncoder`` and the
    reference take them (512 of WavLM-base's 768).
    """

    def __init__(self, model_path, frame_level=False, embedding_dim=None,
                 device="cuda"):
        require_checkpoint_dir(model_path)
        self.device = resolve_device(device)
        self.config, model = load_pretrained_xvector(model_path)
        width, what = (self.config.hidden_size, "hidden states") \
            if frame_level else (self.config.xvector_output_dim, "x-vectors")
        if embedding_dim is None:
            embedding_dim = width
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

    @classmethod
    def from_hparams(cls, hparams, device="cuda"):
        """The ``pretrained`` recipe's encoder from its hparams (a dict or
        a namespace): the backend checked by ``check_speaker_backend``,
        ``speaker_encoder_path``, frames under ``injection_mode:
        cross_attention``, ``speaker_embedding_dim`` wide."""
        check_speaker_backend(hparams)
        get = hparams_getter(hparams)
        return cls(get("speaker_encoder_path"),
                   frame_level=get("injection_mode") == "cross_attention",
                   embedding_dim=int(get("speaker_embedding_dim")),
                   device=device)

    @torch.no_grad()
    def embed(self, wav, rel_lens):
        L = wav.shape[1]
        lengths = torch.clamp(torch.ceil(rel_lens * L), max=L).to(torch.int64)
        out = self.model(wav, lengths)
        if self.frame_level:
            return out["hidden_states"][-1][..., :self.embedding_dim]
        return out["embeddings"][:, None, :]
