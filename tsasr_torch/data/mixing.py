"""On-the-fly mixture synthesis (host side).

The port's own copy of the JAX package's ``data/mixing.py``, with its
imports pointed at ``tsasr_torch``; ``plot_data: True`` dumps each example's
waveform and fbank images and its WAVs (``_plot_example``).

Numpy re-implementation of the recipe's audio pipeline
(the reference's ``train_librispeechmix_scratch.py:334-459``), whose math
must match closely for WER parity:

- load each source wav, take channel 0, resample to the target rate;
- scale each *interferer* so its power hits ``gain_nontarget`` dB relative
  to the target's power (power-ratio formula, :356-366);
- left-pad each source by ``ceil(delay * sr)`` samples, right-pad all to
  the longest, and sum (:367-379);
- crop ``[ceil(start*sr), ceil(start*sr) + ceil(duration*sr)]`` (:376-379);
- load + trim the enrollment to ``trim_enroll`` seconds (:383-395);
- optional prompting: prepend/append the enrollment to the mixture, or
  substitute it entirely (``transcribe_enroll``) (:448-457).
"""

import math
import os
from collections import OrderedDict

import numpy as np

from tsasr_torch.data.audio import read_audio, resample

# Decoded-audio LRU cache: on-the-fly mixing re-reads each utterance
# many times per epoch (as target, as interferer, as enrollment), and
# the decode+resample is the host pipeline's top cost (profiled ~60% of
# per-sample time). Entries are never mutated downstream (mix_signals
# allocates fresh buffers). Budget in MB via TSASR_AUDIO_CACHE_MB
# (0 disables).
_CACHE_BUDGET = int(os.environ.get("TSASR_AUDIO_CACHE_MB", "256")) \
    * 1024 * 1024
_cache = OrderedDict()
_cache_bytes = 0


def load_resampled(path, sample_rate):
    global _cache_bytes
    if _CACHE_BUDGET <= 0:
        sig, sr = read_audio(path)
        return resample(sig, sr, sample_rate)
    key = (path, sample_rate)
    hit = _cache.get(key)
    if hit is not None:
        _cache.move_to_end(key)
        return hit
    sig, sr = read_audio(path)
    sig = resample(sig, sr, sample_rate)
    sig.setflags(write=False)
    _cache[key] = sig
    _cache_bytes += sig.nbytes
    while _cache_bytes > _CACHE_BUDGET and _cache:
        _, old = _cache.popitem(last=False)
        _cache_bytes -= old.nbytes
    return sig


def mix_signals(wav_paths, delays, target_speaker_idx, sample_rate=16000,
                gain_nontarget=0.0, start=0.0, duration=None):
    """Build the mixture waveform; returns float32 (L,)."""
    sigs = [load_resampled(p, sample_rate) for p in wav_paths]

    target_power = float(np.mean(sigs[target_speaker_idx] ** 2))
    padded = []
    for i, (sig, delay) in enumerate(zip(sigs, delays)):
        if i != target_speaker_idx and gain_nontarget != 0.0:
            ratio = 10.0 ** (gain_nontarget / 10.0)
            interf_power = float(np.mean(sig ** 2))
            if interf_power > 0:
                sig = sig * math.sqrt(ratio * target_power / interf_power)
        pad = math.ceil(delay * sample_rate)
        padded.append(np.pad(sig, (pad, 0)))

    max_len = max(len(s) for s in padded)
    mixed = np.zeros(max_len, np.float32)
    for sig in padded:
        mixed[: len(sig)] += sig

    frame_start = math.ceil(start * sample_rate)
    if duration is not None:
        frame_dur = math.ceil(duration * sample_rate)
        mixed = mixed[frame_start: frame_start + frame_dur]
    elif frame_start:
        mixed = mixed[frame_start:]
    return mixed


def load_enrollment(path, sample_rate=16000, trim_enroll=None):
    sig = load_resampled(path, sample_rate)
    if trim_enroll is not None:
        sig = sig[: math.ceil(trim_enroll * sample_rate)]
    return sig


def make_audio_pipeline(hparams):
    """Build the ``@takes/@provides`` audio dynamic item for the recipe
    manifests. ``hparams`` needs: sample_rate, gain_nontarget,
    trim_enroll, prompt_test, prompt_mode, transcribe_enroll (optional).
    """
    from tsasr_torch.data.pipeline import provides, takes

    @takes("wavs", "enroll_wav", "delays", "start", "duration",
           "target_speaker_idx")
    @provides("mixed_sig", "enroll_sig")
    def audio_pipeline(wavs, enroll_wav, delays, start, duration,
                       target_speaker_idx):
        mixed = mix_signals(
            wavs, delays, target_speaker_idx,
            sample_rate=hparams["sample_rate"],
            gain_nontarget=hparams.get("gain_nontarget", 0.0) or 0.0,
            start=start, duration=duration)
        enroll = load_enrollment(
            enroll_wav, sample_rate=hparams["sample_rate"],
            trim_enroll=hparams.get("trim_enroll"))
        if hparams.get("plot_data"):
            _plot_example(hparams, mixed, enroll)
        if hparams.get("prompt_test"):
            mode = hparams.get("prompt_mode", [])
            if "prepend" in mode:
                mixed = np.concatenate([enroll, mixed])
            if "append" in mode:
                mixed = np.concatenate([mixed, enroll])
        if hparams.get("transcribe_enroll", False):
            mixed = enroll
        yield mixed
        yield enroll

    return audio_pipeline


def _plot_example(hparams, mixed, enroll, ID=None):
    """Per-example waveform / fbank images and WAV dumps (the
    ``plot_data`` switch in the audio pipeline), under ``image_folder``
    in a folder named by ``ID`` or, as the JAX pipeline calls it, a
    random one."""
    import os
    import uuid
    from tsasr_torch.utils.visualization import (
        play_waveform,
        plot_fbanks,
        plot_waveform,
    )
    folder = hparams["image_folder"]
    safe = (ID or uuid.uuid4().hex[:8]).replace("/", "_").split(".")[0]
    out = os.path.join(folder, safe)
    os.makedirs(out, exist_ok=True)
    sr = hparams["sample_rate"]
    play_waveform(mixed, sr, os.path.join(out, f"{safe}.wav"))
    play_waveform(enroll, sr, os.path.join(out, f"{safe}_enrollment.wav"))
    for fmt in hparams["image_formats"]:
        plot_waveform(mixed, sr,
                      os.path.join(out, f"{safe}_waveform.{fmt}"))
        plot_fbanks(mixed, sr, os.path.join(out, f"{safe}_fbanks.{fmt}"))


def make_text_pipeline(tokenizer, blank_index=0):
    """Tokenize transcripts: tokens_bos = [blank] + tokens (blank doubles
    as BOS), tokens, and whitespace-split target words with the empty-
    string guard (``train_librispeechmix_scratch.py:462-480``)."""
    from tsasr_torch.data.pipeline import provides, takes

    @takes("wrd")
    @provides("tokens_bos", "tokens", "target_words")
    def text_pipeline(wrd):
        ids = tokenizer.encode_as_ids(wrd)
        yield np.asarray([blank_index] + ids, np.int32)
        yield np.asarray(ids, np.int32)
        words = wrd.split(" ")
        yield [w if w else " " for w in words]

    return text_pipeline
