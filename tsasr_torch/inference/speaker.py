"""Speaker-recognition inference: embed, score and verify speaker pairs.

Counterpart of the JAX package's ``inference/speaker.py``
(``SpeakerRecognition``; reference surface: ``vendor/speechbrain/
speechbrain/pretrained/interfaces.py`` ``SpeakerRecognition``).
Embeddings are scored by cosine similarity in f64 on the host, as in
JAX, and a pair is the same speaker above ``threshold``. Backends, each
a factory with ``device`` (default CUDA, which raises when absent):

- ``from_wavlm``: a local HF WavLM x-vector checkpoint directory through
  the ``pretrained`` recipe's ``FrozenSpeakerEncoder`` (the port's
  loader; the valid lengths ``min(ceil(rel * L), L)`` as JAX's);
- ``from_ecapa``: an ``models.ecapa.ECAPA_TDNN`` over Fbank features
  with sentence normalization (the model and the Fbank on ``device``,
  as for ``from_tsasr``; neither factory moves them);
- ``from_tsasr``: the speaker branch of a ``TSTransducer``
  (``extract_speaker``, pooled and projected; a ``cross_attention``
  model's first frame, as JAX takes it). With ``fused_attention`` on, a
  Conformer branch runs the attention kernel once a layer;
- any callable ``(wav (B, L), rel_lens (B,)) -> (B, E)`` of tensors on
  the device.

EER and minDCF over scored trial lists are
``utils.metric_stats.BinaryMetricStats``.
"""

import numpy as np
import torch

from tsasr_torch.data.audio import read_resampled
from tsasr_torch.device import resolve_device
from tsasr_torch.ops.features import input_normalization


def to_numpy(x):
    """A tensor (any device) or an array -> numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def as_batch(wavs, rel_lens, device):
    """(B, L) waveforms and relative lengths (default all ones) -> f32
    tensors on ``device``."""
    wavs = torch.as_tensor(wavs, dtype=torch.float32).to(device)
    if rel_lens is None:
        rel_lens = torch.ones(wavs.shape[0])
    return wavs, torch.as_tensor(rel_lens, dtype=torch.float32).to(device)


class SpeakerRecognition:
    """Embed, score and verify speaker pairs with cosine similarity.

    ``embed_fn`` maps (wav (B, L), rel_lens (B,)) tensors on ``device``
    to (B, E) embeddings."""

    def __init__(self, embed_fn, sample_rate=16000, threshold=0.5,
                 device="cuda"):
        self.device = resolve_device(device)
        self.embed_fn = embed_fn
        self.sample_rate = sample_rate
        self.threshold = threshold

    # ------------------------------------------------------------ factory
    @classmethod
    def from_wavlm(cls, model_path, sample_rate=16000, threshold=0.5,
                   device="cuda"):
        """A local HF WavLM x-vector checkpoint directory, run frozen as
        the ``pretrained`` recipe runs it (``FrozenSpeakerEncoder``)."""
        from tsasr_torch.recipes.speaker_embeddings import \
            FrozenSpeakerEncoder
        encoder = FrozenSpeakerEncoder(model_path, device=device)
        return cls(lambda wavs, rel_lens: encoder.embed(wavs, rel_lens)[:, 0],
                   sample_rate, threshold, encoder.device)

    @classmethod
    def from_ecapa(cls, model, fbank, sample_rate=16000, threshold=0.5,
                   device="cuda"):
        """An ``ECAPA_TDNN`` (its weights loaded) over ``fbank`` (an
        ``ops.features.Fbank``) features, sentence-normalized."""
        return cls._over_features(lambda feats, rel_lens: model(
            feats, rel_lens)[:, 0, :], fbank, sample_rate, threshold, device)

    @classmethod
    def from_tsasr(cls, model, fbank, sample_rate=16000, threshold=0.5,
                   device="cuda"):
        """The speaker branch of a ``TSTransducer`` (its weights loaded)
        over ``fbank`` features, sentence-normalized."""
        def embed(feats, rel_lens):
            embs = model.extract_speaker(feats, rel_lens)
            return embs[:, 0, :] if embs.dim() == 3 else embs

        return cls._over_features(embed, fbank, sample_rate, threshold,
                                  device)

    @classmethod
    def _over_features(cls, embed, fbank, sample_rate, threshold, device):
        """``embed(features, rel_lens) -> (B, E)`` over ``fbank``
        features, sentence-normalized. The model and ``fbank`` lie on
        ``device`` already: the factory neither moves them nor switches
        their mode."""
        def embed_fn(wavs, rel_lens):
            return embed(input_normalization(fbank(wavs), rel_lens),
                         rel_lens)

        return cls(embed_fn, sample_rate, threshold, device)

    # ------------------------------------------------------------ embed
    @torch.inference_mode()
    def encode_batch(self, wavs, rel_lens=None):
        """(B, L) waveforms (numpy or tensors) -> (B, E) embeddings, a
        tensor on the device."""
        return self.embed_fn(*as_batch(wavs, rel_lens, self.device))

    def encode_file(self, path):
        """One audio file (resampled to ``sample_rate``) -> (E,) numpy."""
        wav = read_resampled(path, self.sample_rate)
        return to_numpy(self.encode_batch(wav[None]))[0]

    # ------------------------------------------------------------ verify
    @staticmethod
    def cosine(a, b):
        """Cosine similarity over the last axis in f64 numpy."""
        a = np.asarray(to_numpy(a), np.float64)
        b = np.asarray(to_numpy(b), np.float64)
        denom = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
        return np.sum(a * b, axis=-1) / np.maximum(denom, 1e-12)

    def verify_batch(self, wavs1, wavs2, rel_lens1=None, rel_lens2=None):
        """-> (scores (B,), decisions (B,) bool), numpy."""
        scores = self.cosine(self.encode_batch(wavs1, rel_lens1),
                             self.encode_batch(wavs2, rel_lens2))
        return scores, scores > self.threshold

    def verify_files(self, path1, path2):
        """-> (score, same_speaker) for two audio files."""
        score = float(self.cosine(self.encode_file(path1),
                                  self.encode_file(path2)))
        return score, score > self.threshold
