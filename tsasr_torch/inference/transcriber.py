"""Offline target-speaker transcription.

Counterpart of the JAX package's ``inference/transcriber.py::TSASRTranscriber``:
waveforms are zero-padded to the longest in the batch with relative
lengths ``len / max_len``, features are Fbank plus sentence
normalization, and the encoder output is searched greedily
(``beam_size <= 1``) or by the batched beam, with optional LM shallow
fusion. The enrollment conditions the model as the recipe's TEST
conditions it, by variant:

- ``scratch``: its features go through the model's speaker branch (a
  Conformer or an ECAPA branch);
- ``pretrained``: its waveform goes through the frozen WavLM x-vector
  encoder (``speaker_encoder``, a ``FrozenSpeakerEncoder``), pooled
  d-vectors or, under ``cross_attention``, frames, then through
  ``project_external_speaker``;
- ``none``: the model has no speaker input and the enrollment is
  ignored.

Its relative lengths mask the speaker frames of a ``cross_attention``
model. ``from_experiment`` loads a trained experiment: its
``hyperparams.yaml``, its tokenizer, its best checkpoint and, for a
``pretrained`` one, the frozen encoder of its ``speaker_encoder_path``.

Differences from the JAX transcriber:

- ``from_experiment`` shapes the input as the experiment's recipe does at
  TEST. Waveforms and enrollments are padded up to a multiple of the
  yaml's ``pad_to_multiple`` samples (the loader's shape quantization;
  relative lengths against the padded length), the features then to a
  frame multiple of ``pad_feats_to`` (the recipe's ``_features``; a
  ``pretrained`` enrollment is a waveform and gets no such padding), and
  the search gets the relative lengths before the second padding, as
  the recipe's TEST gives it. So a file's transcript is the one TEST
  records for that utterance in a batch of its own. The WavLM's feature
  encoder normalises over the padded waveform, so a ``pretrained``
  enrollment must be padded as TEST pads it.
- a ``pretrained`` model is conditioned on its enrollment, as the JAX
  recipe's TEST conditions it; the JAX transcriber encodes it with no
  speaker embedding at all.

``streaming`` gives a ``StreamingTranscriber`` over the same model, as
the JAX ``streaming`` does; where the JAX one builds it without the
speaker embedding, a model with a speaker branch here needs
``speaker_embs`` (``speaker_embedding`` computes them from an
enrollment) and raises without them.
"""

import os

import numpy as np
import torch

from tsasr_torch.decoding.beam_batched import BatchedBeamSearcher
from tsasr_torch.decoding.greedy import TransducerGreedySearcher
from tsasr_torch.device import resolve_device
from tsasr_torch.lm.fusion import load_fusion_lm
from tsasr_torch.ops.features import (Fbank, input_normalization,
                                      pad_audio_to_frame_multiple)
from tsasr_torch.ops.masks import relative_to_absolute_lengths


def _pad_batch(wavs, multiple=None):
    """List of 1-D arrays -> (zero-padded (B, max_len) f32, rel (B,)),
    max_len rounded up to a multiple of ``multiple`` if given."""
    max_len = max(len(w) for w in wavs)
    if multiple:
        max_len = -(-max_len // multiple) * multiple
    batch = np.zeros((len(wavs), max_len), np.float32)
    rel = np.zeros(len(wavs), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
        rel[i] = len(w) / max_len
    return batch, rel


class TSASRTranscriber:
    """Batch (offline) target-speaker transcription.

    ``model`` is a ``TSTransducer``; ``params`` is a ``state_dict`` to
    load into it, or None to keep its weights. The model is moved to
    ``device``, which defaults to CUDA and raises when CUDA is absent.
    ``beam_size > 1`` searches with the batched beam; ``lm_path`` with
    ``lm_weight > 0`` fuses an n-gram (``*.arpa``) or the port's RNN-LM
    into it. ``variant`` "scratch" runs the enrollments through the
    model's speaker branch; "pretrained" through ``speaker_encoder`` (a
    ``FrozenSpeakerEncoder`` on the same device), then the model's
    ``project_external_speaker``; "none" ignores them.
    """

    def __init__(self, model, params, tokenizer, sample_rate=16000,
                 n_fft=512, n_mels=80, win_length=32.0, blank_index=0,
                 beam_size=1, variant="scratch", lm_path=None,
                 lm_weight=0.0, pad_to_multiple=None, pad_feats_to=None,
                 speaker_encoder=None, device="cuda"):
        self.device = resolve_device(device)
        if (variant == "pretrained") != (speaker_encoder is not None):
            raise ValueError("the pretrained variant, and only it, takes a "
                             "speaker_encoder (a FrozenSpeakerEncoder)")
        self.speaker_encoder = speaker_encoder
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.blank_index = blank_index
        self.variant = variant
        self.win_length = win_length
        self.pad_to_multiple = dict(pad_to_multiple or {})
        self.pad_feats_to = pad_feats_to
        self.fbank = Fbank(sample_rate=sample_rate, n_fft=n_fft,
                           n_mels=n_mels, win_length=win_length
                           ).to(self.device)
        if beam_size <= 1:
            self.searcher = TransducerGreedySearcher(self.model, blank_index)
        else:
            lm_kwargs = {}
            fusion = load_fusion_lm(lm_path, lm_weight, tokenizer.pieces,
                                    blank_index, self.device)
            if fusion is not None:
                lm_kwargs = dict(zip(("lm_step_fn", "lm_weight",
                                      "lm_initial_state_fn"), fusion))
            self.searcher = BatchedBeamSearcher(
                self.model, blank_index, beam_size=beam_size, **lm_kwargs)

    # ------------------------------------------------------------ loading
    @classmethod
    def from_experiment(cls, experiment_dir, beam_size=1, min_key="WER",
                        lm_path=None, lm_weight=None, ckpt_path=None,
                        device="cuda"):
        """Load an experiment folder written by
        ``python -m tsasr_torch.train_librispeechmix_{scratch,none,
        pretrained}``: the model of its ``hyperparams.yaml``, the
        tokenizer under ``save_folder``, and the ``"model"`` entry of the
        best checkpoint's ``brain.ckpt`` on ``min_key`` (or of
        ``ckpt_path``, e.g. the output of
        ``tsasr_torch.tools.average_checkpoints``). A ``pretrained``
        experiment also loads its frozen encoder from
        ``speaker_encoder_path`` as the recipe does
        (``FrozenSpeakerEncoder.from_hparams``: a path that is no
        checkpoint directory raises ``FileNotFoundError``, the
        ``torch_cache`` backend ``NotImplementedError``). LM fusion
        defaults to the experiment's ``lm_path`` / ``lm_weight``. A run
        at precision ``bf16`` (its yaml's, or its ``--precision`` flag,
        which the run records in ``hyperparams.yaml``) is served by the
        model rebuilt in bf16, as the recipe trained it."""
        from tsasr_torch.data.tokenizer import load_tokenizer
        from tsasr_torch.recipes.librispeechmix import model_at_precision
        from tsasr_torch.recipes.speaker_embeddings import \
            FrozenSpeakerEncoder
        from tsasr_torch.training.checkpoints import Checkpointer, load_state
        from tsasr_torch.utils.hparams import load_hyperpyyaml

        device = resolve_device(device)
        with open(os.path.join(experiment_dir, "hyperparams.yaml")) as f:
            hparams = load_hyperpyyaml(
                f, overrides={"data_folder": "/nonexistent"},
                overrides_must_match=False)
        config = hparams["model_config"]
        variant = "scratch" if config.use_speaker_encoder else (
            "pretrained" if config.speaker_embedding_dim else "none")
        speaker_encoder = None
        if variant == "pretrained":
            speaker_encoder = FrozenSpeakerEncoder.from_hparams(hparams,
                                                                device)
        save_folder = hparams["save_folder"]
        tokenizer = load_tokenizer(os.path.join(
            save_folder, f"{hparams.get('token_type', 'char')}_"
            f"{hparams['vocab_size']}.json"))
        if ckpt_path is None:
            ckpt = Checkpointer(save_folder).find_checkpoint(min_key=min_key)
            if ckpt is None:
                raise FileNotFoundError(f"no checkpoint in {save_folder}")
            ckpt_path = ckpt.paramfile("brain")
        model = model_at_precision(hparams, hparams.get("precision"))
        model.load_state_dict(load_state(ckpt_path)["model"])
        if lm_path is None:
            lm_path = hparams.get("lm_path")
        if lm_weight is None:
            lm_weight = float(hparams.get("lm_weight", 0.0) or 0.0)
        return cls(model, None, tokenizer,
                   sample_rate=hparams["sample_rate"],
                   n_fft=hparams["n_fft"], n_mels=hparams["n_mels"],
                   win_length=float(hparams["win_length"]),
                   blank_index=hparams["blank_index"],
                   beam_size=beam_size, variant=variant, lm_path=lm_path,
                   lm_weight=lm_weight,
                   pad_to_multiple=hparams.get("pad_to_multiple"),
                   pad_feats_to=hparams.get("pad_feats_to"),
                   speaker_encoder=speaker_encoder, device=device)

    def streaming(self, mode="kv_cache", **kwargs):
        """A ``StreamingTranscriber`` over this model, tokenizer, features
        and device (causal models; ``inference.streaming``). A model with
        a speaker branch needs ``speaker_embs=``, e.g. from
        ``speaker_embedding(enrollment)``."""
        from tsasr_torch.inference.streaming import StreamingTranscriber
        return StreamingTranscriber(
            self.model, None, self.tokenizer, sample_rate=self.sample_rate,
            n_fft=self.fbank.n_fft, n_mels=self.fbank.mel.shape[1],
            win_length=self.win_length, blank_index=self.blank_index,
            mode=mode, device=self.device, **kwargs)

    @torch.inference_mode()
    def speaker_embedding(self, enroll):
        """One enrollment waveform -> the speaker embedding (1, 1, d_model)
        that ``encode_batch`` injects (``scratch``, either speaker branch,
        or ``pretrained``), or for a ``cross_attention`` model its valid
        frames (1, S', d_model): the ``round(rel * S)`` that the offline
        encode leaves unmasked, since a stream takes no lengths."""
        speaker, rel = self._speaker([enroll])
        if self.model.config.injection_mode == "cross_attention":
            speaker = speaker[:, :int(relative_to_absolute_lengths(
                rel, speaker.shape[1])[0])]
        return speaker

    # ---------------------------------------------------------- inference
    def _features(self, batch, rel):
        wav = torch.from_numpy(batch).to(self.device)
        rel = torch.from_numpy(rel).to(self.device)
        if self.pad_feats_to:
            wav, rel = pad_audio_to_frame_multiple(
                wav, rel, int(self.pad_feats_to), self.sample_rate,
                float(self.fbank.hop_length))
        return input_normalization(self.fbank(wav), rel), rel

    def _speaker(self, enrolls):
        """Enrollment waveforms -> (speaker embeddings (B, 1, d_model) or
        frames (B, S, d_model), their relative lengths (B,)), as the
        recipe's TEST conditions the model on them: padded to the
        ``enroll_sig`` multiple, then the speaker branch (``scratch``)
        or the frozen encoder and ``project_external_speaker``
        (``pretrained``)."""
        if self.variant == "none":
            raise ValueError("a 'none' model computes no speaker "
                             "embedding from an enrollment")
        batch, rel = _pad_batch(enrolls,
                                self.pad_to_multiple.get("enroll_sig"))
        if self.variant == "pretrained":
            rel = torch.from_numpy(rel).to(self.device)
            embs = self.speaker_encoder.embed(
                torch.from_numpy(batch).to(self.device), rel)
            return self.model.project_external_speaker(embs), rel
        efeats, rel = self._features(batch, rel)
        return self.model.extract_speaker(efeats, rel), rel

    @torch.inference_mode()
    def encode_batch(self, wavs, enrolls=None):
        """Waveforms (+ enrollments) -> (enc_out (B, T', J), rel (B,)):
        ``rel`` is ``len / max_len`` (the padded length), the lengths the
        search takes."""
        batch, rel = _pad_batch(wavs, self.pad_to_multiple.get("mixed_sig"))
        feats, feats_rel = self._features(batch, rel)
        speaker = enroll_rel = None
        if enrolls is not None and self.variant != "none":
            speaker, enroll_rel = self._speaker(enrolls)
        return (self.model.encode(feats, feats_rel, speaker, enroll_rel),
                torch.from_numpy(rel).to(self.device))

    def transcribe_batch(self, wavs, enrolls=None):
        """wavs: list of 1-D float arrays -> list of transcripts."""
        enc, rel = self.encode_batch(wavs, enrolls)
        hyps, _, _, _ = self.searcher(enc, rel)
        return [" ".join(self.tokenizer.decode_ids_to_words(h))
                for h in hyps]

    def transcribe(self, wav, enroll=None):
        return self.transcribe_batch(
            [wav], [enroll] if enroll is not None else None)[0]

    def transcribe_file(self, path, enroll_path=None):
        """Transcribe one audio file (wav or flac, resampled to the
        model's rate), with an optional enrollment file."""
        from tsasr_torch.data.audio import read_resampled
        enroll = read_resampled(enroll_path, self.sample_rate) \
            if enroll_path else None
        return self.transcribe(read_resampled(path, self.sample_rate),
                               enroll)
