"""LibriSpeechMix TS-ASR recipe: the ``scratch`` variant's Brain.

Counterpart of the JAX package's ``recipes/librispeechmix.py::TSASRBrain``
for the scratch variant (the Conformer speaker encoder trained jointly):

- ``batch_to_arrays`` takes a ``PaddedBatch`` in the JAX recipe's form
  (``mixed_sig``, ``enroll_sig``, ``tokens_bos``, ``tokens``) to numpy;
- ``_mixture_features``: the waveform is zero-padded so the frame count
  is a multiple of ``pad_feats_to``, then Fbank and sentence
  normalization; the enrollment goes the same way
  (``_forward_kwargs``);
- ``compute_forward`` runs ``encode_predict`` and hands the head's
  parameters to the fused joint + loss when ``fused_joint_loss`` is on
  (``_fused_loss_active``), else the model's full logits;
- ``compute_objectives`` is the weight-masked mean of the per-utterance
  RNN-T losses;
- at VALID, ``evaluate_batch_extra`` decodes greedily and accumulates
  WER against ``batch.target_words``.

Speed perturbation and SpecAugment (``augment: True``), the banded
joint and loss (a set ``joint_band_width``), the other variants, beam
search at TEST, the data pipeline and checkpoints are not ported yet
and raise.
"""

import numpy as np
import torch

from tsasr_torch.decoding.greedy import TransducerGreedySearcher
from tsasr_torch.ops.features import (Fbank, input_normalization,
                                      pad_audio_to_frame_multiple)
from tsasr_torch.ops.rnnt_loss import rnnt_loss
from tsasr_torch.ops.rnnt_loss_fused import rnnt_loss_fused
from tsasr_torch.training.brain import Brain
from tsasr_torch.utils.edit_distance import wer_details_for_batch, wer_summary
from tsasr_torch.utils.stage import Stage


class TSASRBrain(Brain):
    """Target-speaker ASR trainer over a ``TSTransducer`` model."""

    def __init__(self, *args, variant="scratch", tokenizer=None, **kwargs):
        if variant != "scratch":
            raise NotImplementedError(
                f"variant {variant!r} is not ported yet; the port has "
                "'scratch'")
        super().__init__(*args, **kwargs)
        self.variant = variant
        self.tokenizer = tokenizer
        self.fbank = Fbank(
            sample_rate=self.hparams.sample_rate, n_fft=self.hparams.n_fft,
            n_mels=self.hparams.n_mels,
            win_length=float(self.hparams.win_length)).to(self.device)
        self._current_epoch = 0
        self._greedy = None
        self.wer_details = []
        self.last_hyps = None

    # ------------------------------------------------------------ batches
    def batch_to_arrays(self, batch):
        # labels come from tokens_bos ([blank] + tokens), so their padded
        # width is the logits' U dimension minus one
        tokens_bos = batch.tokens_bos.data.astype(np.int64)
        abs_token_lens = np.round(
            batch.tokens.lengths
            * batch.tokens.data.shape[1]).astype(np.int64)
        return {
            "mixed_sig": batch.mixed_sig.data.astype(np.float32),
            "mixed_lens": batch.mixed_sig.lengths.astype(np.float32),
            "tokens_bos": tokens_bos,
            "tokens": tokens_bos[:, 1:],
            "tokens_lens": (abs_token_lens
                            / max(tokens_bos.shape[1] - 1, 1)
                            ).astype(np.float32),
            "weight": np.ones(len(batch), np.float32),
            "enroll_sig": batch.enroll_sig.data.astype(np.float32),
            "enroll_lens": batch.enroll_sig.lengths.astype(np.float32),
        }

    # ------------------------------------------------------------ forward
    def _features(self, wav, rel):
        pad_to = getattr(self.hparams, "pad_feats_to", None)
        if pad_to:
            wav, rel = pad_audio_to_frame_multiple(
                wav, rel, int(pad_to), self.hparams.sample_rate,
                float(self.fbank.hop_length))
        return input_normalization(self.fbank(wav), rel), rel

    def _mixture_features(self, batch, stage, generator):
        if bool(getattr(self.hparams, "augment", False)) \
                and stage == Stage.TRAIN:
            raise NotImplementedError(
                "speed perturbation and SpecAugment (augment: True) are not "
                "ported yet")
        return self._features(batch["mixed_sig"], batch["mixed_lens"])

    def _forward_kwargs(self, batch):
        feats, rel = self._features(batch["enroll_sig"], batch["enroll_lens"])
        return {"enroll_feats": feats, "enroll_rel_lens": rel}

    def _fused_loss_active(self):
        return bool(getattr(self.hparams, "fused_joint_loss", True))

    def compute_forward(self, batch, stage, generator):
        if getattr(self.hparams, "joint_band_width", None):
            raise NotImplementedError(
                "joint_band_width trains the banded joint with "
                "rnnt_loss_banded, which is not ported yet")
        feats, rel = self._mixture_features(batch, stage, generator)
        kwargs = self._forward_kwargs(batch)
        deterministic = stage != Stage.TRAIN
        if self._fused_loss_active():
            enc_out, dec_out = self.model.encode_predict(
                feats, rel, batch["tokens_bos"], **kwargs,
                deterministic=deterministic, generator=generator)
            head = self.model.transducer_head
            return (enc_out, dec_out, head.weight.t(), head.bias), enc_out, rel
        logits, enc_out = self.model(
            feats, rel, batch["tokens_bos"], **kwargs,
            deterministic=deterministic, generator=generator)
        # rel goes with the predictions: the loss masks with the lengths
        # the model encoded with
        return logits, enc_out, rel

    def compute_objectives(self, predictions, batch, stage):
        logits, _, rel = predictions
        tokens = batch["tokens"]
        target_lens = torch.round(batch["tokens_lens"]
                                  * tokens.shape[1]).to(torch.int32)
        blank = self.hparams.blank_index
        if isinstance(logits, tuple):          # fused joint + head + loss
            enc_out, dec_out, head_w, head_b = logits
            input_lens = torch.round(rel * enc_out.shape[1]).to(torch.int32)
            losses = rnnt_loss_fused(
                enc_out, dec_out, head_w, head_b, tokens, input_lens,
                target_lens, blank=blank, reduction="none",
                chunk=int(getattr(self.hparams, "fused_loss_chunk", 8)))
        else:
            input_lens = torch.round(rel * logits.shape[1]).to(torch.int32)
            losses = rnnt_loss(logits, tokens, input_lens, target_lens,
                               blank=blank, reduction="none")
        w = batch["weight"]
        return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)

    # ----------------------------------------------------------- decoding
    def on_stage_start(self, stage, epoch=None):
        if epoch is not None:
            self._current_epoch = epoch
        if stage != Stage.TRAIN:
            self.wer_details = []

    def evaluate_batch_extra(self, batch, arrays, predictions, stage):
        if stage == Stage.TEST:
            raise NotImplementedError(
                "TEST decodes with beam search, which is not ported yet")
        if self._current_epoch % self.hparams.valid_search_freq != 0:
            return
        if self._greedy is None:
            self._greedy = TransducerGreedySearcher(
                self.model, blank_index=self.hparams.blank_index)
        _, enc_out, _ = predictions
        hyps, _, _, _ = self._greedy(enc_out, arrays["mixed_lens"])
        words = [self.tokenizer.decode_ids_to_words(h) for h in hyps]
        self.last_hyps = words
        if "target_words" in batch:
            self.wer_details += wer_details_for_batch(
                batch.id, batch.target_words, words)

    def valid_wer(self):
        """Corpus WER summary of the VALID batches since the stage began."""
        return wer_summary(self.wer_details)
