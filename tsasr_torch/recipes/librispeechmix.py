"""LibriSpeechMix TS-ASR recipe: the Brain and the experiment of its
three variants.

Counterpart of the JAX package's ``recipes/librispeechmix.py``. The
variant selects the speaker conditioning: ``none`` (no conditioning,
injection off), ``scratch`` (the Conformer speaker encoder trained
jointly) and ``pretrained`` (frozen WavLM x-vector d-vectors, computed
on the device inside the step by ``FrozenSpeakerEncoder`` from a local
checkpoint directory; its parameters are neither trained nor
checkpointed).

- ``batch_to_arrays`` takes a ``PaddedBatch`` in the JAX recipe's form
  (``mixed_sig``, ``enroll_sig``, ``tokens_bos``, ``tokens``) to numpy;
  ``none`` leaves the enrollment out;
- ``_mixture_features``, in the JAX order: at TRAIN with ``augment`` on,
  speed perturbation (``rel = min(rel * factor, 1)``); the waveform is
  zero-padded so the frame count is a multiple of ``pad_feats_to``;
  Fbank and sentence normalization; at TRAIN with ``augment`` on,
  SpecAugment. The augmentation draws come from a CPU generator of the
  micro-batch (``Brain.step_generator(stream=1)``), a stream apart from
  dropout, so recovery stays bit for bit and drawing needs no device
  sync;
- ``_forward_kwargs``: nothing for ``none``; for ``scratch`` the
  enrollment's features, made as the mixture's; for ``pretrained`` the
  frozen encoder's (B, 1, E) d-vectors as ``external_speaker_embs``, or
  its (B, S, E) frames under ``injection_mode: cross_attention``;
- ``compute_forward`` runs ``encode_predict`` and hands the head's
  parameters to the fused joint + loss when ``_fused_loss_active``
  (``fused_joint_loss`` on, no ``joint_band_width``, the ``sum``
  joint), else the model's logits: the full lattice, or the band of
  ``joint_band_width`` label positions a frame;
- ``compute_objectives`` is the weight-masked mean of the per-utterance
  RNN-T losses (``rnnt_loss_banded`` on a band);
- ``evaluate_batch_extra`` decodes greedily at VALID every
  ``valid_search_freq`` epochs, and at TEST with ``_beam``: the batched
  or the exact beam by ``beam_backend``, greedy at ``beam_size <= 1``,
  with the LM of ``lm_path`` / ``lm_weight`` fused in (as the JAX
  recipe's ``_maybe_build_searchers`` and ``_load_fusion_lm``); CER and
  WER accumulate in ``ErrorRateStats``; ``on_stage_end`` logs each
  epoch, keeps the ``keep_checkpoints`` best checkpoints on min WER and
  writes the WER file at TEST;
- the switches around it: ``plot_attentions`` plots every encoder
  layer's attention maps of each VALID and TEST utterance
  (``collect_diagnostics``, ``TSTransducer.encode_with_attn``; the maps
  of the conditioning the model runs with, where the JAX recipe drops
  the ``pretrained`` variant's and the speaker frames' lengths),
  ``plot_embeddings`` the ``scratch`` speaker embeddings after TEST,
  ``plot_grad_norm`` the TRAIN gradient norms after ``fit``
  (``on_fit_batch_end``); ``prompt_test`` runs TEST twice, first on the
  enrollments (``wer_enrollments.txt``), then on the mixtures with the
  enrollment prompted in and its transcript's words stripped from each
  hypothesis (``_strip_enroll_transcripts``);
- ``dataio_prepare``, ``build_dataloader_kwargs`` and ``run_experiment``
  run the experiment: manifests, the tokenizer fitted on
  train+valid+test, datasets and dynamic batching, ``Brain.fit``, then
  TEST of every split of ``test_splits`` from the best checkpoint; the
  ``pretrained`` variant embeds the enrollment waveforms on the device,
  so no ``speaker_emb`` item (the JAX ``torch_cache`` backend's) is made;
  ``model_path`` warm-starts the model and ``--profile`` traces the run
  (see ``run_experiment``);
- data parallelism, in a run launched by ``python -m
  tsasr_torch.parallel.launch`` (the JAX recipe's ``:645-666``): TRAIN
  is the Brain's (each rank its rows of the global batch, one gradient
  all-reduce); ``compute_objectives`` divides by the global batch's
  summed weight, and the augmentation is drawn for the global batch,
  each rank applying its rows' draws with the global batch's mean as
  the masks' fill, so two ranks' step equals one process's;
  ``build_dataloader_kwargs`` gives each rank its shard of the VALID and
  TEST batches (``DistributedSamplerWrapper``, dynamic and static
  batching), ``_merge_distributed_metrics`` gathers the WER / CER scores
  and keeps each utterance once, and process 0 alone writes the WER
  file, the train log, the plots and prepares the data and the
  tokenizer;
- sequence and pipeline parallelism (``--sequence_parallel_count``,
  ``--pipeline_parallel_count``; the JAX recipe's ``_encoder_mesh``):
  ``compute_forward`` hands the Brain's ``layout`` to the model in TRAIN
  only, which splits the encoder over the axis; VALID and TEST stay
  rank-local; under a sequence axis ``pad_feats_to`` becomes its lcm
  with the frontend's subsampling times S (``seq_parallel_pad``), so the
  encoder's frames divide the axis; the global mean of SpecAugment's
  fill sums over the data axis alone.

Not ported yet, raising ``NotImplementedError`` before anything runs:
the ``torch_cache`` speaker backend (HF ``transformers``).
"""

import dataclasses
import itertools
import json
import logging
import math
import os

import numpy as np
import torch

from tsasr_torch.data import (
    DistributedSamplerWrapper,
    DynamicBatchSampler,
    DynamicItemDataset,
    prepare_librispeechmix,
    train_tokenizer,
)
from tsasr_torch.data.dataset import add_dynamic_item, set_output_keys
from tsasr_torch.data.mixing import make_audio_pipeline, make_text_pipeline
from tsasr_torch.decoding import (BatchedBeamSearcher,
                                  TransducerBeamSearcher,
                                  TransducerGreedySearcher)
from tsasr_torch.device import resolve_device
from tsasr_torch.lm.fusion import load_fusion_lm
from tsasr_torch.models.transducer import TSTransducer
from tsasr_torch.ops.augment import (apply_spec_augment, draw_spec_augment,
                                     spec_augment, speed_perturb, take_rows)
from tsasr_torch.ops.features import (Fbank, input_normalization,
                                      pad_audio_to_frame_multiple)
from tsasr_torch.ops.rnnt_loss import rnnt_loss
from tsasr_torch.ops.rnnt_loss_banded import band_centers, rnnt_loss_banded
from tsasr_torch.ops.rnnt_loss_fused import rnnt_loss_fused
from tsasr_torch.parallel import distributed
from tsasr_torch.parallel.distributed import if_main_process, run_on_main
from tsasr_torch.recipes.speaker_embeddings import (FrozenSpeakerEncoder,
                                                    check_speaker_backend)
from tsasr_torch.training.brain import Brain
from tsasr_torch.utils.hparams import hparams_getter
from tsasr_torch.utils.metric_stats import ErrorRateStats
from tsasr_torch.utils.parameter_transfer import Pretrainer
from tsasr_torch.utils.precision import compute_dtype
from tsasr_torch.utils.profiling import Profiler, profile
from tsasr_torch.utils.stage import Stage

logger = logging.getLogger(__name__)

VARIANTS = ("none", "scratch", "pretrained")


def specaugment_kwargs(hparams):
    """SpecAugment's keywords from the yaml's keys, with the reference
    recipe's defaults."""
    get = hparams_getter(hparams)
    return dict(
        time_warp=bool(get("time_warp", True)),
        time_warp_window=int(get("time_warp_window", 5)),
        freq_mask=bool(get("freq_mask", True)),
        freq_mask_width=get("freq_mask_width", 30),
        n_freq_mask=int(get("n_freq_mask", 2)),
        time_mask=bool(get("time_mask", True)),
        time_mask_width=get("time_mask_width", 20),
        n_time_mask=int(get("n_time_mask", 2)),
        replace_with_zero=bool(get("replace_with_zero", False)),
    )


def speed_perturb_kwargs(hparams, sample_rate=16000):
    """Speed perturbation's keywords (the yaml's ``speeds``, by default
    [95, 100, 105])."""
    get = hparams_getter(hparams)
    return dict(speeds=tuple(get("speeds", (95, 100, 105)) or
                             (95, 100, 105)),
                sample_rate=int(get("sample_rate", sample_rate)))


def model_at_precision(hparams, precision):
    """The yaml's model, rebuilt with a bf16 dtype under ``precision``
    ``bf16`` (bf16 compute; the parameters and the optimizer stay f32 and
    the same seed gives the same weights); else the yaml's own."""
    if precision == "bf16" and "model_config" in hparams:
        return TSTransducer(dataclasses.replace(
            hparams["model_config"], dtype=compute_dtype(precision)))
    return hparams["model"]


class TSASRBrain(Brain):
    """Target-speaker ASR trainer over a ``TSTransducer`` model."""

    def __init__(self, *args, variant="scratch", tokenizer=None, **kwargs):
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; the recipe has "
                             f"{VARIANTS}")
        super().__init__(*args, **kwargs)
        self.variant = variant
        self.tokenizer = tokenizer
        self.fbank = Fbank(
            sample_rate=self.hparams.sample_rate, n_fft=self.hparams.n_fft,
            n_mels=self.hparams.n_mels,
            win_length=float(self.hparams.win_length)).to(self.device)
        self._current_epoch = 0
        self._greedy = None
        self._beam = None
        self.cer_metric = ErrorRateStats(split_tokens=True)
        self.wer_metric = ErrorRateStats()
        self.last_hyps = None
        self.speaker_encoder = None
        if variant == "pretrained":
            self.speaker_encoder = FrozenSpeakerEncoder.from_hparams(
                self.hparams, self.device)

    # ------------------------------------------------------------ batches
    def batch_to_arrays(self, batch):
        # labels come from tokens_bos ([blank] + tokens), so their padded
        # width is the logits' U dimension minus one
        tokens_bos = batch.tokens_bos.data.astype(np.int64)
        abs_token_lens = np.round(
            batch.tokens.lengths
            * batch.tokens.data.shape[1]).astype(np.int64)
        arrays = {
            "mixed_sig": batch.mixed_sig.data.astype(np.float32),
            "mixed_lens": batch.mixed_sig.lengths.astype(np.float32),
            "tokens_bos": tokens_bos,
            "tokens": tokens_bos[:, 1:],
            "tokens_lens": (abs_token_lens
                            / max(tokens_bos.shape[1] - 1, 1)
                            ).astype(np.float32),
            "weight": np.ones(len(batch), np.float32),
        }
        if self.variant != "none":
            arrays["enroll_sig"] = batch.enroll_sig.data.astype(np.float32)
            arrays["enroll_lens"] = batch.enroll_sig.lengths.astype(
                np.float32)
        return arrays

    # ------------------------------------------------------------ forward
    def _features(self, wav, rel):
        pad_to = getattr(self.hparams, "pad_feats_to", None)
        if pad_to:
            wav, rel = pad_audio_to_frame_multiple(
                wav, rel, int(pad_to), self.hparams.sample_rate,
                float(self.fbank.hop_length))
        return input_normalization(self.fbank(wav), rel), rel

    def _mixture_features(self, batch, stage):
        wav, rel = batch["mixed_sig"], batch["mixed_lens"]
        augment = stage == Stage.TRAIN and bool(
            getattr(self.hparams, "augment", False))
        generator = self.step_generator(stream=1) if augment else None
        if augment and bool(getattr(self.hparams, "speed_perturb", True)):
            wav, factor = speed_perturb(
                wav, generator, **speed_perturb_kwargs(self.hparams))
            rel = torch.clamp(rel * factor, max=1.0)
        feats, rel = self._features(wav, rel)
        if augment:
            feats = self._spec_augment(feats, generator)
        return feats, rel

    def _spec_augment(self, feats, generator):
        """SpecAugment of a TRAIN batch; a rank of a data-parallel step
        draws for the global batch (the same draws on every rank), takes
        its rows' and fills the masks with the global batch's mean."""
        kwargs = specaugment_kwargs(self.hparams)
        shard = self.batch_shard
        if shard is None:
            return spec_augment(feats, generator, **kwargs)
        draws = draw_spec_augment(generator,
                                  (shard.size, *feats.shape[1:]), **kwargs)
        return apply_spec_augment(
            feats, take_rows(draws, shard.rows),
            kwargs["replace_with_zero"],
            mean=lambda x: _global_mean(x, shard))

    def _forward_kwargs(self, batch):
        if self.variant == "none":
            return {}
        if self.variant == "pretrained":
            return {"external_speaker_embs": self.speaker_encoder.embed(
                        batch["enroll_sig"], batch["enroll_lens"]),
                    "enroll_rel_lens": batch["enroll_lens"]}
        feats, rel = self._features(batch["enroll_sig"], batch["enroll_lens"])
        return {"enroll_feats": feats, "enroll_rel_lens": rel}

    def _fused_loss_active(self):
        """The fused joint + head + loss, as the JAX recipe chooses it:
        only for the ``sum`` joint and without a band, and
        ``fused_joint_loss: False`` opts out."""
        if getattr(self.hparams, "joint_band_width", None):
            return False
        if self.model.config.joint_mode != "sum":
            return False
        return bool(getattr(self.hparams, "fused_joint_loss", True))

    def compute_forward(self, batch, stage, generator):
        feats, rel = self._mixture_features(batch, stage)
        kwargs = self._forward_kwargs(batch)
        deterministic = stage != Stage.TRAIN
        if stage == Stage.TRAIN:
            # the sequence or pipeline axis splits the encoder in TRAIN;
            # VALID and TEST are rank-local (the JAX _encoder_mesh)
            kwargs["axes"] = self.layout
        if self._fused_loss_active():
            enc_out, dec_out = self.model.encode_predict(
                feats, rel, batch["tokens_bos"], **kwargs,
                deterministic=deterministic, generator=generator)
            head = self.model.transducer_head
            return (enc_out, dec_out, head.weight.t(), head.bias), enc_out, rel
        band = getattr(self.hparams, "joint_band_width", None)
        if band:
            kwargs["band_width"] = int(band)
            kwargs["token_rel_lens"] = batch["tokens_lens"]
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
            band = getattr(self.hparams, "joint_band_width", None)
            if band:
                # the same band centers the model's joint took
                centers = band_centers(input_lens, target_lens,
                                       logits.shape[1], int(band))
                losses = rnnt_loss_banded(logits, tokens, centers,
                                          input_lens, target_lens,
                                          blank=blank, reduction="none")
            else:
                losses = rnnt_loss(logits, tokens, input_lens, target_lens,
                                   blank=blank, reduction="none")
        w = batch["weight"]
        # a data-parallel rank holds some rows of the batch: its share of
        # the loss is over the global batch's weight, and the ranks' sum
        # is the global loss
        shard = self.batch_shard if stage == Stage.TRAIN else None
        total = w.sum() if shard is None else w.new_tensor(shard.weight_total)
        return (losses * w).sum() / torch.clamp(total, min=1.0)

    # ----------------------------------------------------------- decoding
    def _maybe_build_searchers(self, stage):
        """The greedy searcher, and at TEST the beam too, each built on
        first use (so VALID needs no beam settings), with the yaml's LM
        (``lm_path`` at ``lm_weight > 0``; the JAX recipe's
        ``_load_fusion_lm``) fused into the beam."""
        blank = self.hparams.blank_index
        if self._greedy is None:
            self._greedy = TransducerGreedySearcher(self.model,
                                                    blank_index=blank)
        if stage != Stage.TEST or self._beam is not None:
            return
        if self.hparams.beam_size <= 1:
            self._beam = self._greedy
            return
        fusion = load_fusion_lm(getattr(self.hparams, "lm_path", None),
                                getattr(self.hparams, "lm_weight", 0.0),
                                self.tokenizer.pieces, blank, self.device)
        if getattr(self.hparams, "beam_backend", "batched") == "batched":
            lm_kwargs = {} if fusion is None else dict(zip(
                ("lm_step_fn", "lm_weight", "lm_initial_state_fn"), fusion))
            self._beam = BatchedBeamSearcher(
                self.model, blank_index=blank,
                beam_size=self.hparams.beam_size, nbest=1,
                expand_beam=self.hparams.expand_beam, **lm_kwargs)
        else:
            lm_kwargs = {} if fusion is None else dict(zip(
                ("lm_step_fn", "lm_weight"), fusion))
            self._beam = TransducerBeamSearcher(
                self.model, blank_index=blank,
                beam_size=self.hparams.beam_size, nbest=1,
                state_beam=self.hparams.state_beam,
                expand_beam=self.hparams.expand_beam, **lm_kwargs)

    def evaluate_batch_extra(self, batch, arrays, predictions, stage):
        hp = self.hparams
        if getattr(hp, "plot_attentions", False) or \
                getattr(hp, "plot_embeddings", False):
            diag = self.collect_diagnostics(batch, arrays, stage)
            if "attentions" in diag:
                from tsasr_torch.utils.visualization import plot_attention
                for j, attn in enumerate(diag["attentions"]):
                    for i, ID in enumerate(batch.id):
                        safe = ID.replace("/", "_").split(".")[0]
                        for fmt in hp.image_formats:
                            plot_attention(attn[i], os.path.join(
                                hp.image_folder, safe, "attention",
                                f"{safe}_attention_"
                                f"{str(j + 1).zfill(2)}.{fmt}"))
        if stage != Stage.TEST and \
                self._current_epoch % hp.valid_search_freq:
            return
        self._maybe_build_searchers(stage)
        searcher = self._beam if stage == Stage.TEST else self._greedy
        _, enc_out, _ = predictions
        hyps, _, _, _ = searcher(enc_out, arrays["mixed_lens"])
        words = self.tokenizer(hyps, task="decode_from_list")
        if stage == Stage.TEST and getattr(hp, "prompt_test", False) and \
                not getattr(hp, "transcribe_enroll", False):
            words = self._strip_enroll_transcripts(batch.id, words)
        self.last_hyps = words
        logger.debug("%s decoded %s", stage.name, list(batch.id))
        if "target_words" in batch:
            self.cer_metric.append(batch.id, words, batch.target_words)
            self.wer_metric.append(batch.id, words, batch.target_words)

    def _strip_enroll_transcripts(self, ids, predicted_words):
        """Prompt-test mode: remove the enrollment's transcript (its
        words, from the first TEST pass) that was prepended / appended to
        each mixture's hypothesis (the JAX recipe's method)."""
        out = []
        mode = getattr(self.hparams, "prompt_mode", [])
        for ID, transcription in zip(ids, predicted_words):
            enroll = self.hparams.enroll_transcriptions[ID]
            if "prepend" in mode:
                transcription = transcription[len(enroll):]
            if "append" in mode:
                transcription = transcription[
                    : len(transcription) - len(enroll)]
            out.append(transcription if transcription else [""])
        return out

    @torch.no_grad()
    def collect_diagnostics(self, batch, arrays, stage):
        """What the plotting switches collect from an evaluation batch:
        with ``plot_attentions`` every encoder layer's attention
        probabilities (numpy, (B, H, T', T') each) through
        ``encode_with_attn`` on the batch's features and conditioning,
        and with ``plot_embeddings`` (``scratch`` only, as the JAX
        recipe) each utterance's speaker embedding into
        ``all_speaker_embs``."""
        out = {}
        if getattr(self.hparams, "plot_attentions", False):
            feats, rel = self._mixture_features(arrays, stage)
            speaker, speaker_rel = self.model.speaker_condition(
                **self._forward_kwargs(arrays))
            _, attns = self.model.encode_with_attn(feats, rel, speaker,
                                                   speaker_rel)
            out["attentions"] = [a.float().cpu().numpy() for a in attns]
        if getattr(self.hparams, "plot_embeddings", False) and \
                self.variant == "scratch":
            kwargs = self._forward_kwargs(arrays)
            embs = self.model.extract_speaker(kwargs["enroll_feats"],
                                              kwargs["enroll_rel_lens"])
            if not hasattr(self, "all_speaker_embs"):
                self.all_speaker_embs = {}
            for i, ID in enumerate(batch.id):
                self.all_speaker_embs[ID] = embs[i, 0].float().cpu().numpy()
        return out

    def valid_wer(self):
        """Corpus WER summary of the batches decoded since the stage
        began."""
        return self.wer_metric.summarize()

    # -------------------------------------------------------------- hooks
    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        """``plot_grad_norm`` records each micro-batch's gradient norm."""
        if getattr(self.hparams, "plot_grad_norm", False):
            if not hasattr(self, "grad_norm"):
                self.grad_norm = []
            self.grad_norm.append(self.last_grad_norm)

    def on_stage_start(self, stage, epoch=None):
        if epoch is not None:
            self._current_epoch = epoch
        if stage != Stage.TRAIN:
            self.cer_metric = ErrorRateStats(split_tokens=True)
            self.wer_metric = ErrorRateStats()

    def on_evaluate_start(self, max_key=None, min_key=None):
        super().on_evaluate_start(max_key=max_key, min_key=min_key)
        # report the recovered epoch: keep-best selection may load one
        # before the fit loop's last
        counter = getattr(self.hparams, "epoch_counter", None)
        if counter is not None and (
                self._recovered_ckpt is not None
                or counter.current > self._current_epoch):
            self._current_epoch = counter.current

    def on_stage_end(self, stage, stage_loss, epoch=None):
        stage_stats = {"loss": stage_loss}
        if stage == Stage.TRAIN:
            self.train_stats = stage_stats
            return
        self._merge_distributed_metrics(stage)
        if self.wer_metric.scores:
            stage_stats["CER"] = self.cer_metric.summarize("error_rate")
            stage_stats["WER"] = self.wer_metric.summarize("error_rate")
        if stage == Stage.VALID:
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch, "lr": self.current_lr(),
                            "steps": self.optimizer_step},
                train_stats=getattr(self, "train_stats",
                                    {"loss": float("nan")}),
                valid_stats=stage_stats)
            if "WER" in stage_stats and self.checkpointer is not None:
                self.checkpointer.save_and_keep_only(
                    meta={"WER": stage_stats["WER"]}, min_keys=["WER"],
                    num_to_keep=self.hparams.keep_checkpoints)
        elif stage == Stage.TEST:
            self.hparams.train_logger.log_stats(
                stats_meta={"Epoch loaded": self._current_epoch},
                test_stats=stage_stats)
            if hasattr(self.hparams, "wer_file") and if_main_process():
                with open(self.hparams.wer_file, "w") as f:
                    self.wer_metric.write_stats(f)

    def _merge_distributed_metrics(self, stage):
        """After a stage that decoded: the ranks' WER and CER scores
        gathered, each utterance kept once (a padded shard decodes some
        twice), in rank order on every rank; in one process nothing to
        merge."""
        if distributed.world_size() <= 1 or (
                stage != Stage.TEST
                and self._current_epoch % self.hparams.valid_search_freq):
            return
        n_local = len(self.wer_metric.scores)
        for metric in (self.cer_metric, self.wer_metric):
            gathered = distributed.all_gather_object(metric.scores)
            metric.scores = list({x["key"]: x for x in
                                  itertools.chain(*gathered)}.values())
        logger.info("metric merge: %d local -> %d merged utterances (%s)",
                    n_local, len(self.wer_metric.scores),
                    distributed.describe())


def _global_mean(x, shard):
    """The mean of a data-parallel step's global batch, from each rank's
    ``x`` (its rows, ``shard``): the sum of its rows that are no padding
    duplicate, summed over the data axis (the ranks of one data shard
    hold the same rows)."""
    real = torch.as_tensor(shard.real, device=x.device)
    total = distributed.layout().data.all_reduce_sum(
        x[real].sum().reshape(1))
    return (total / (shard.size * x[0].numel()))[0]


# ======================================================== dataio plumbing
def dataio_prepare(hparams, tokenizer):
    """Datasets + pipelines, mirroring
    ``train_librispeechmix_scratch.py:279-488``."""
    data_folder = hparams["data_folder"]
    replacements = {"DATA_ROOT": data_folder}

    train_data = DynamicItemDataset.from_json(hparams["train_json"],
                                              replacements=replacements)
    sorting = hparams.get("sorting", "ascending")
    if sorting in ("ascending", "descending"):
        train_data = train_data.filtered_sorted(
            sort_key="duration", reverse=sorting == "descending",
            key_max_value={"duration": hparams["train_remove_if_longer"]})
    elif sorting != "random":
        raise NotImplementedError(
            "`sorting` must be random, ascending or descending")

    valid_data = DynamicItemDataset.from_json(
        hparams["valid_json"], replacements=replacements).filtered_sorted(
        sort_key="duration", reverse=True,
        key_max_value={"duration": hparams["valid_remove_if_longer"]})
    test_data = DynamicItemDataset.from_json(
        hparams["test_json"], replacements=replacements).filtered_sorted(
        sort_key="duration", reverse=True,
        key_max_value={"duration": hparams["test_remove_if_longer"]})

    datasets = [train_data, valid_data, test_data]
    add_dynamic_item(datasets, make_audio_pipeline(hparams))
    add_dynamic_item(datasets, make_text_pipeline(
        tokenizer, blank_index=hparams["blank_index"]))
    set_output_keys(datasets, ["id", "mixed_sig", "enroll_sig",
                               "tokens_bos", "tokens", "target_words"])
    return train_data, valid_data, test_data


def build_dataloader_kwargs(hparams, dataset, stage):
    """Dynamic-batching loader kwargs (reference main :576-610). In a
    launched run every rank iterates the same TRAIN sampler (the Brain
    takes its rows of each batch), and each rank its own shard of the
    VALID and TEST batches (``DistributedSamplerWrapper``: rank r takes
    batches r, r + W, ..., the tail padded by duplication), with dynamic
    batching and with static batches alike."""
    world = distributed.world_size()
    shard = world > 1 and stage != "train"
    worker_mode = hparams.get("dataloader_worker_mode", "thread")
    workers = hparams.get("dataloader_workers", 0)
    if worker_mode == "thread":
        # more than one prefetch thread only adds GIL contention; core
        # scaling needs worker_mode: process
        workers = min(workers, 1)
    kwargs = {"num_workers": workers, "worker_mode": worker_mode,
              "mp_context": hparams.get("dataloader_mp_context", "fork"),
              "pad_to_multiple": hparams.get("pad_to_multiple")}
    if hparams.get("dynamic_batching", True):
        sampler = DynamicBatchSampler(
            dataset, hparams[f"{stage}_max_batch_length"],
            num_buckets=hparams["num_buckets"],
            length_func=lambda x: x["duration"],
            shuffle=False,
            batch_ordering=(hparams.get("sorting", "ascending")
                            if stage == "train" else "descending"),
            max_batch_ex=hparams["max_batch_size"])
        kwargs["batch_sampler"] = DistributedSamplerWrapper(
            sampler, rank=distributed.rank(), world_size=world) \
            if shard else sampler
    elif shard:
        bs = hparams[f"{stage}_batch_size"]
        batches = [list(range(i, min(i + bs, len(dataset))))
                   for i in range(0, len(dataset), bs)]
        kwargs["batch_sampler"] = DistributedSamplerWrapper(
            batches, rank=distributed.rank(), world_size=world)
    else:
        kwargs["batch_size"] = hparams[f"{stage}_batch_size"]
    return kwargs


PLOT_SWITCHES = ("plot_data", "plot_attentions", "plot_embeddings",
                 "plot_grad_norm")


def check_ported(hparams, variant):
    """Raise before anything runs for what cannot run: an unknown variant
    (``ValueError``), a speaker backend the port does not run
    (``NotImplementedError``), a fusion LM, a warm-start ``model_path``
    or a speaker encoder checkpoint that is not there
    (``FileNotFoundError``), and a set ``plot_*`` switch whose plotting
    package is missing (``ImportError``: nothing is ignored silently)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; the recipe has "
                         f"{VARIANTS}")
    if variant == "pretrained":
        check_speaker_backend(hparams)
    if any(hparams.get(key) for key in PLOT_SWITCHES):
        from tsasr_torch.utils.visualization import require_plot_packages
        require_plot_packages(embeddings=bool(hparams.get(
            "plot_embeddings")))
    # LM fusion runs at TEST, after training: a missing file fails first
    lm_path = hparams.get("lm_path")
    if float(hparams.get("lm_weight") or 0.0) > 0 and lm_path \
            and not os.path.isfile(lm_path):
        raise FileNotFoundError(f"lm_path {lm_path!r} (LM shallow fusion "
                                "at TEST) does not exist")
    model_path = hparams.get("model_path")
    if model_path and not (
            os.path.isfile(model_path)
            or os.path.isfile(os.path.join(model_path, "model.ckpt"))):
        raise FileNotFoundError(
            f"model_path {model_path!r} (warm start) is neither a file nor "
            "a directory holding model.ckpt")


def seq_parallel_pad(pad_feats_to, frontend_strides, sp):
    """``pad_feats_to`` under ``sp`` sequence ranks: its lcm with the
    frontend's subsampling times ``sp``, so the encoder's frame count
    divides the axis (the JAX recipe's ``:788-797``)."""
    need = int(np.prod(frontend_strides)) * int(sp)
    return math.lcm(int(pad_feats_to or 1), need)


def _prepare(hparams, splits):
    run_on_main(prepare_librispeechmix, kwargs={
        "data_folder": hparams["data_folder"],
        "save_folder": hparams["save_folder"],
        "splits": splits,
        "num_targets": hparams.get("num_targets"),
        "num_enrolls": hparams.get("num_enrolls"),
        "trim_nontarget": hparams.get("trim_nontarget"),
        "suppress_delay": hparams.get("suppress_delay"),
        "overlap_ratio": hparams.get("overlap_ratio"),
    })


def _speaker_label(key):
    """The enrollment's speaker in an utterance key: the folder two above
    the enrollment file (LibriSpeech's ``<speaker>/<chapter>/<file>``),
    as the JAX recipe labels its plot; the whole key when the path is
    shallower (the JAX recipe raises an IndexError there)."""
    parts = str(key).split("/")
    return parts[-3] if len(parts) >= 3 else str(key)


def run_experiment(variant="scratch", argv=None):
    """The experiment main of one variant (the reference's ``__main__``
    block, ``train_librispeechmix_scratch.py:491-687``): prepare, fit the
    tokenizer, build the datasets, ``Brain.fit``, then TEST every split
    of ``test_splits``. Returns the Brain.

    - ``model_path``: the file is collected into ``save_folder`` as the
      JAX recipe collects it (``Pretrainer``), then, unlike the JAX
      recipe, which never loads it, loaded into the model
      (``load_state_dict_into``) once the Brain is built; a checkpoint
      that ``fit``'s recovery finds in ``save_folder`` takes precedence;
    - ``--profile``: ``utils.profiling.profile`` hooks ``fit_batch`` and
      ``evaluate_batch`` with a ``Profiler`` on the Brain's device, its
      traces in ``--profile_dir`` or ``<output_folder>/profiler``. The
      JAX recipe never stops its profiler, so a window still open at the
      end of the run is never written; this one calls ``stop()`` after
      ``fit`` and after TEST, so the trace is always written;
    - ``prompt_test``: each TEST split is evaluated twice, first on its
      enrollments (``transcribe_enroll``; WER file
      ``wer_enrollments.txt``), whose hypotheses become
      ``enroll_transcriptions``, then on the prompted mixtures, their
      hypotheses stripped of those words;
    - ``plot_grad_norm`` plots after ``fit``, ``plot_embeddings`` after
      TEST, into ``image_folder``."""
    from tsasr_torch.training.experiment import (
        check_precision,
        create_experiment_directory,
        parse_arguments,
    )
    from tsasr_torch.utils.hparams import load_hyperpyyaml, parse_overrides

    hparams_file, run_opts, overrides = parse_arguments(argv)
    with open(hparams_file) as f:
        hparams = load_hyperpyyaml(f, overrides)
    check_ported(hparams, variant)
    precision = run_opts.get("precision", hparams.get("precision"))
    check_precision(precision)
    # the device is resolved before anything is written: asking for the
    # card on a host without one raises here
    resolve_device(run_opts.get("device", hparams.get("device", "cuda")))

    if "precision" in run_opts:
        # the folder's yaml records the run's precision, so that serving
        # rebuilds the model the run trained
        overrides = dict(parse_overrides(overrides),
                         precision=run_opts["precision"])
    create_experiment_directory(
        experiment_directory=hparams["output_folder"],
        hyperparams_to_save=hparams_file, overrides=overrides)
    _prepare(hparams, hparams["splits"])

    # the tokenizer is fitted on train+valid+test transcripts (reference
    # :526-556: token distributions may differ across splits)
    texts = []
    for split in ("train", "valid", "test"):
        with open(hparams[f"{split}_json"], encoding="utf-8") as f:
            texts.extend(e["wrd"] for e in json.load(f).values())
    tokenizer_kwargs = dict(
        vocab_size=hparams["vocab_size"],
        model_type=hparams.get("token_type", "char"),
        character_coverage=hparams.get("character_coverage", 1.0),
        unk_id=hparams["blank_index"])
    # process 0 fits and saves it; after the barrier every process loads
    # the saved one
    run_on_main(train_tokenizer, args=(hparams["save_folder"], texts),
                kwargs=tokenizer_kwargs)
    tokenizer = train_tokenizer(hparams["save_folder"], texts,
                                **tokenizer_kwargs)

    train_data, valid_data, _ = dataio_prepare(hparams, tokenizer)
    # warm start (the reference's Pretrainer, yaml model_path)
    pretrainer = None
    if hparams.get("model_path"):
        pretrainer = Pretrainer(collect_in=hparams["save_folder"],
                                paths={"model": hparams["model_path"]})
        run_on_main(pretrainer.collect_files)
    hparams["model"] = model_at_precision(hparams, precision)
    if distributed.layout().sp > 1:
        hparams["pad_feats_to"] = seq_parallel_pad(
            hparams.get("pad_feats_to"),
            hparams["model"].config.frontend_strides,
            distributed.layout().sp)
    model = hparams["model"].init_weights(seed=int(hparams["seed"]))
    brain = TSASRBrain(
        modules={"model": model}, opt_class=hparams["opt_class"],
        hparams=hparams, run_opts=run_opts,
        checkpointer=hparams.get("checkpointer"), variant=variant,
        tokenizer=tokenizer)
    logger.info("%.1fM trainable parameters on %s (%s)",
                sum(p.numel() for p in brain._params()) / 1e6, brain.device,
                distributed.describe())
    if pretrainer is not None:
        pretrainer.load_collected({"model": brain.model})
    profiler = None
    if run_opts.get("profile"):
        profile_dir = run_opts.get("profile_dir") \
            or os.path.join(hparams["output_folder"], "profiler")
        if not if_main_process():       # each rank traces its own process
            profile_dir = os.path.join(profile_dir,
                                       f"rank{distributed.rank()}")
        profiler = Profiler(profile_dir, device=brain.device)
        profile(brain, profiler)

    brain.fit(hparams["epoch_counter"], train_data, valid_data,
              train_loader_kwargs=build_dataloader_kwargs(
                  hparams, train_data, "train"),
              valid_loader_kwargs=build_dataloader_kwargs(
                  hparams, valid_data, "valid"))
    if profiler is not None:
        profiler.stop()
    if hparams.get("plot_grad_norm") and getattr(brain, "grad_norm", None) \
            and if_main_process():
        from tsasr_torch.utils.visualization import plot_grad_norm
        for fmt in hparams["image_formats"]:
            plot_grad_norm(brain.grad_norm, os.path.join(
                hparams["image_folder"], f"grad_norm.{fmt}"))

    for split in hparams["test_splits"]:
        _prepare(hparams, [split])
        _, _, test_data = dataio_prepare(hparams, tokenizer)
        brain.hparams.wer_file = os.path.join(
            hparams["output_folder"], f"wer_{split}.txt")
        if hparams.get("prompt_test"):
            # two passes: the enrollments first, then the prompted
            # mixtures with the enrollments' words stripped (reference
            # :660-687)
            # the Brain reads its namespace, the audio pipeline the dict
            brain.hparams.transcribe_enroll = \
                hparams["transcribe_enroll"] = True
            wer_file = brain.hparams.wer_file
            brain.hparams.wer_file = os.path.join(
                os.path.dirname(wer_file), "wer_enrollments.txt")
            brain.evaluate(test_data, min_key="WER",
                           test_loader_kwargs=build_dataloader_kwargs(
                               hparams, test_data, "test"))
            brain.hparams.enroll_transcriptions = {
                x["key"]: x["hyp_tokens"] for x in brain.wer_metric.scores}
            brain.hparams.transcribe_enroll = \
                hparams["transcribe_enroll"] = False
            brain.hparams.wer_file = wer_file
        brain.evaluate(test_data, min_key="WER",
                       test_loader_kwargs=build_dataloader_kwargs(
                           hparams, test_data, "test"))
    if profiler is not None:
        profiler.stop()

    if hparams.get("plot_embeddings") and \
            getattr(brain, "all_speaker_embs", None) and if_main_process():
        from tsasr_torch.utils.visualization import plot_embeddings
        for fmt in hparams["image_formats"]:
            plot_embeddings(
                list(brain.all_speaker_embs.values()),
                [_speaker_label(k) for k in brain.all_speaker_embs],
                os.path.join(hparams["image_folder"], f"embeddings.{fmt}"),
                title=f"Speaker embeddings ({variant})",
                perplexity=min(len(brain.all_speaker_embs) - 1, 30))
    return brain
