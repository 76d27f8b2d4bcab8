"""Host-side audio IO + resampling.

The port's own copy of the JAX package's ``data/audio.py``, line for
line, with its imports pointed at ``tsasr_torch``.

The reference decodes wav/flac via torchaudio (C++) and resamples with a
windowed-sinc polyphase resampler
(``vendor/speechbrain/speechbrain/processing/speech_augmentation.py:511-823``).
Neither torchaudio nor soundfile exists in this image, so:

- WAV: native reader on top of the stdlib ``wave`` module + numpy
  (PCM16/24/32 and float32), plus a writer for tests/tools.
- FLAC: native C++ decoder (``native/tsasr_native.cpp:tsasr_flac_read``)
  with a pure-Python full-spec fallback (``tsasr_torch/data/flac.py``).
- Resampling: windowed-sinc polyphase (Kaiser window) implemented with
  numpy; gcd reduction of the rate ratio, identical conv structure to the
  reference's Resample so outputs agree closely.
"""

import math
import os
import wave
from functools import lru_cache

import numpy as np


def read_audio(path):
    """Read an audio file -> (float32 waveform (L,) mono-ized, sample_rate).

    Multi-channel files return channel 0, matching the reference pipeline
    (``train_librispeechmix_scratch.py:347``: ``sig[0]``). Dispatches to
    the native C++ decoder when built.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        try:
            from tsasr_torch import native
            result = native.wav_read(path)
            if result is not None:
                return result
        except ImportError:
            pass
        return _read_wav(path)
    if ext == ".flac":
        try:
            from tsasr_torch import native
            result = native.flac_read(path)
            if result is not None:
                return result
        except ImportError:
            pass
        from tsasr_torch.data.flac import read_flac
        samples, sr, bps = read_flac(path)
        data = samples[:, 0].astype(np.float32) / float(1 << (bps - 1))
        return np.ascontiguousarray(data), sr
    raise ValueError(f"Unsupported audio format: {path}")


def _read_wav(path):
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        a = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        data = ((a[:, 0].astype(np.int32))
                | (a[:, 1].astype(np.int32) << 8)
                | (a[:, 2].astype(np.int32) << 16))
        data = (data - ((data & 0x800000) << 1)).astype(np.float32) / 8388608.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {width}")
    if ch > 1:
        data = data.reshape(-1, ch)[:, 0]
    return np.ascontiguousarray(data), sr


def write_wav(path, data, sample_rate):
    """Write float32 mono waveform as PCM16 WAV (for tools/tests)."""
    data = np.clip(np.asarray(data, np.float32), -1.0, 1.0)
    pcm = (data * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(int(sample_rate))
        f.writeframes(pcm.tobytes())


@lru_cache(maxsize=32)
def _sinc_kernel(orig_freq, new_freq, lowpass_filter_width=6,
                 rolloff=0.99, beta=14.769656459379492):
    """Polyphase windowed-sinc kernels for integer-reduced rates.

    Returns (kernels (new_freq, width), width, orig_freq, new_freq) after
    gcd reduction. Kaiser window by default (torchaudio-compatible
    quality).
    """
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_freq, new_freq = int(orig_freq) // g, int(new_freq) // g
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)
    kernels = []
    for i in range(new_freq):
        t = (-i / new_freq + idx / orig_freq) * base_freq
        t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
        window = np.i0(beta * np.sqrt(1 - (t / lowpass_filter_width) ** 2)) \
            / np.i0(beta)
        t = t * math.pi
        kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1, t))
        kernels.append(kernel * window * base_freq / orig_freq)
    return (np.stack(kernels).astype(np.float32), width, orig_freq,
            new_freq)


def resample(waveform, orig_freq, new_freq):
    """Windowed-sinc polyphase resampling of a (L,) float32 waveform.

    Dispatches to the native C++ resampler when built (same kernel math).
    """
    if int(orig_freq) == int(new_freq):
        return np.asarray(waveform, np.float32)
    try:
        from tsasr_torch import native
        result = native.resample(waveform, orig_freq, new_freq)
        if result is not None:
            return result
    except ImportError:
        pass
    kernels, width, of, nf = _sinc_kernel(int(orig_freq), int(new_freq))
    L = len(waveform)
    target_len = int(math.ceil(nf * L / of))
    padded = np.pad(np.asarray(waveform, np.float64), (width, width + of))
    # stride into frames of the kernel length, hop = orig_freq (reduced)
    kw = kernels.shape[1]
    n_frames = (len(padded) - kw) // of + 1
    frames = np.lib.stride_tricks.as_strided(
        padded, shape=(n_frames, kw),
        strides=(padded.strides[0] * of, padded.strides[0]))
    # (n_frames, kw) @ (kw, new_freq) -> interleave phases
    out = frames @ kernels.astype(np.float64).T    # (n_frames, new_freq)
    out = out.reshape(-1)[:target_len]
    return out.astype(np.float32)


def read_resampled(path, sample_rate):
    """An audio file (wav or flac) as a float32 waveform at
    ``sample_rate``."""
    wav, sr = read_audio(path)
    return resample(wav, sr, sample_rate)
