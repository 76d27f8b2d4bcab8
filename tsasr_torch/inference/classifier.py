"""Audio classification inference: embed, classify, decode the labels.

Counterpart of the JAX package's ``inference/classifier.py``
(``EncoderClassifier``; reference surface: ``vendor/speechbrain/
speechbrain/pretrained/interfaces.py`` ``EncoderClassifier``), the
"embedding + classifier head + labels" wrapper of language, speaker or
emotion identification. Backend-agnostic: ``encode_fn`` maps (wavs
(B, L), rel_lens (B,)) tensors on the device to (B, D) embeddings or
logits, ``classify_fn`` (optional, e.g. a
``models.ecapa.CosineClassifier``) maps them to (B, C) logits, and a
``data.encoder.CategoricalEncoder`` decodes the class indices.
"""

import torch

from tsasr_torch.data.audio import read_resampled
from tsasr_torch.device import resolve_device
from tsasr_torch.inference.speaker import as_batch


class EncoderClassifier:
    """Embed audio and classify it, with decoded labels, on ``device``
    (default CUDA, which raises when absent)."""

    def __init__(self, encode_fn, label_encoder=None, classify_fn=None,
                 sample_rate=16000, device="cuda"):
        self.device = resolve_device(device)
        self.encode_fn = encode_fn
        self.classify_fn = classify_fn
        self.label_encoder = label_encoder
        self.sample_rate = sample_rate

    @torch.inference_mode()
    def encode_batch(self, wavs, rel_lens=None):
        """(B, L) waveforms (numpy or tensors) -> (B, D), on the
        device."""
        return self.encode_fn(*as_batch(wavs, rel_lens, self.device))

    @torch.inference_mode()
    def classify_batch(self, wavs, rel_lens=None):
        """-> (log_probs (B, C), scores (B,), indices (B,)) tensors on the
        device, and the labels of the indices (None without a label
        encoder)."""
        emb = self.encode_batch(wavs, rel_lens)
        logits = self.classify_fn(emb) if self.classify_fn else emb
        log_probs = torch.log_softmax(logits, dim=-1)
        indices = torch.argmax(log_probs, dim=-1)
        scores = torch.gather(log_probs, -1, indices[:, None])[:, 0]
        labels = None
        if self.label_encoder is not None:
            labels = self.label_encoder.decode_ndim(indices.tolist())
        return log_probs, scores, indices, labels

    def classify_file(self, path):
        """One audio file (resampled to ``sample_rate``) -> (log_probs
        (C,), score, index, label or None)."""
        wav = read_resampled(path, self.sample_rate)
        log_probs, scores, indices, labels = self.classify_batch(wav[None])
        return (log_probs[0], float(scores[0]), int(indices[0]),
                labels[0] if labels else None)
