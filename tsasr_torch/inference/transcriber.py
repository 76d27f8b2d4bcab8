"""Offline target-speaker transcription.

Counterpart of the JAX package's ``inference/transcriber.py::TSASRTranscriber``:
waveforms are zero-padded to the longest in the batch with relative
lengths ``len / max_len``, features are Fbank plus sentence
normalization, the enrollment goes through the speaker branch (the
``scratch`` variant, a Conformer or an ECAPA branch; ``none`` has none)
and its relative lengths mask the speaker frames of a
``cross_attention`` model, and the
encoder output is searched greedily (``beam_size <= 1``) or by the
batched beam, with optional LM shallow fusion. ``from_experiment`` loads
a trained experiment: its ``hyperparams.yaml``, its tokenizer and its
best checkpoint.

One difference from the JAX transcriber: ``from_experiment`` shapes the
input as the experiment's recipe does at TEST. Waveforms are padded up
to a multiple of the yaml's ``pad_to_multiple`` samples (the loader's
shape quantization; relative lengths against the padded length), then
to a frame multiple of ``pad_feats_to`` for the features (the recipe's
``_features``), and the search gets the relative lengths before the
second padding, as the recipe's TEST gives it. So a file's transcript is
the one TEST records for that utterance in a batch of its own.

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
    model's speaker branch; "none" ignores them.
    """

    def __init__(self, model, params, tokenizer, sample_rate=16000,
                 n_fft=512, n_mels=80, win_length=32.0, blank_index=0,
                 beam_size=1, variant="scratch", lm_path=None,
                 lm_weight=0.0, pad_to_multiple=None, pad_feats_to=None,
                 device="cuda"):
        self.device = resolve_device(device)
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
        ``python -m tsasr_torch.train_librispeechmix_{scratch,none}``: the
        model of its ``hyperparams.yaml``, the tokenizer under
        ``save_folder``,
        and the ``"model"`` entry of the best checkpoint's ``brain.ckpt``
        on ``min_key`` (or of ``ckpt_path``, e.g. the output of
        ``tsasr_torch.tools.average_checkpoints``). LM fusion defaults
        to the experiment's ``lm_path`` / ``lm_weight``."""
        from tsasr_torch.data.tokenizer import load_tokenizer
        from tsasr_torch.training.checkpoints import Checkpointer, load_state
        from tsasr_torch.utils.hparams import load_hyperpyyaml

        resolve_device(device)
        with open(os.path.join(experiment_dir, "hyperparams.yaml")) as f:
            hparams = load_hyperpyyaml(
                f, overrides={"data_folder": "/nonexistent"},
                overrides_must_match=False)
        config = hparams["model_config"]
        variant = "scratch" if config.use_speaker_encoder else (
            "pretrained" if config.speaker_embedding_dim else "none")
        if variant == "pretrained":
            # the JAX transcriber encodes such a model with no speaker
            # embedding at all, unlike the conditioning it was trained with
            raise NotImplementedError(
                "transcribing a pretrained-variant experiment is not "
                "ported: its model needs the frozen WavLM d-vectors of the "
                "enrollment, which the transcriber does not compute yet")
        save_folder = hparams["save_folder"]
        tokenizer = load_tokenizer(os.path.join(
            save_folder, f"{hparams.get('token_type', 'char')}_"
            f"{hparams['vocab_size']}.json"))
        if ckpt_path is None:
            ckpt = Checkpointer(save_folder).find_checkpoint(min_key=min_key)
            if ckpt is None:
                raise FileNotFoundError(f"no checkpoint in {save_folder}")
            ckpt_path = ckpt.paramfile("brain")
        model = hparams["model"]
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
                   pad_feats_to=hparams.get("pad_feats_to"), device=device)

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
        that ``encode_batch`` injects (the ``scratch`` variant, either
        speaker branch), or its frames (1, S, d_model) for a
        ``cross_attention`` model."""
        if self.variant != "scratch":
            raise ValueError(f"a {self.variant!r} model computes no speaker "
                             "embedding from an enrollment")
        efeats, rel = self._features(*_pad_batch(
            [enroll], self.pad_to_multiple.get("enroll_sig")))
        return self.model.extract_speaker(efeats, rel)

    # ---------------------------------------------------------- inference
    def _features(self, batch, rel):
        wav = torch.from_numpy(batch).to(self.device)
        rel = torch.from_numpy(rel).to(self.device)
        if self.pad_feats_to:
            wav, rel = pad_audio_to_frame_multiple(
                wav, rel, int(self.pad_feats_to), self.sample_rate,
                float(self.fbank.hop_length))
        return input_normalization(self.fbank(wav), rel), rel

    @torch.inference_mode()
    def encode_batch(self, wavs, enrolls=None):
        """Waveforms (+ enrollments) -> (enc_out (B, T', J), rel (B,)):
        ``rel`` is ``len / max_len`` (the padded length), the lengths the
        search takes."""
        batch, rel = _pad_batch(wavs, self.pad_to_multiple.get("mixed_sig"))
        feats, feats_rel = self._features(batch, rel)
        speaker = enroll_rel = None
        if enrolls is not None and self.variant == "scratch":
            efeats, enroll_rel = self._features(*_pad_batch(
                enrolls, self.pad_to_multiple.get("enroll_sig")))
            speaker = self.model.extract_speaker(efeats, enroll_rel)
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
        from tsasr_torch.data.audio import read_audio, resample
        wav, sr = read_audio(path)
        wav = resample(wav, sr, self.sample_rate)
        enroll = None
        if enroll_path:
            e, esr = read_audio(enroll_path)
            enroll = resample(e, esr, self.sample_rate)
        return self.transcribe(wav, enroll)
