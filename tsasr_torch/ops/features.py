"""Log-mel features and sentence normalization.

Counterpart of the JAX package's ``ops/features.py`` (``Fbank``, ``stft``,
``spectral_magnitude``, ``mel_filterbank_matrix``, ``amplitude_to_db``,
``input_normalization``, ``pad_audio_to_frame_multiple``) for the
settings the recipe uses: periodic Hamming window, center zero padding
(``stft(center=False)`` frames a raw window as it is, which the
streaming transcriber needs), power spectrum, triangular mel filters, dB
with a per-utterance ``top_db`` clamp. The windowed DFT is one strided
``conv1d`` against the (window x DFT basis) rows, as in the JAX package;
on CUDA it needs TF32 off (``tsasr_torch.device.resolve_device``).
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tsasr_torch.ops.masks import length_to_mask, relative_to_absolute_lengths


def _ms_to_samples(sample_rate, ms):
    return int(round((sample_rate / 1000.0) * ms))


@functools.lru_cache(maxsize=8)
def _windowed_dft_filters(n_fft, win):
    """(2 * (n_fft//2+1), 1, n_fft) cos then sin rows, window applied."""
    n = np.arange(win)
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / win)   # periodic
    window = window.astype(np.float32)
    if win < n_fft:
        left = (n_fft - win) // 2
        window = np.pad(window, (left, n_fft - win - left))
    elif win > n_fft:
        raise ValueError(f"win_length ({win}) > n_fft ({n_fft})")
    k = np.arange(n_fft // 2 + 1)
    angle = -2.0 * np.pi * np.outer(np.arange(n_fft), k) / n_fft
    cos_m = np.cos(angle).astype(np.float32)
    sin_m = np.sin(angle).astype(np.float32)
    cos_f = (cos_m * window[:, None]).T[:, None, :]
    sin_f = (sin_m * window[:, None]).T[:, None, :]
    return np.concatenate([cos_f, sin_f], axis=0).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_filters_on(n_fft, win, device):
    return torch.from_numpy(_windowed_dft_filters(n_fft, win)).to(device)


def _stft(x, filters, n_fft, hop, center):
    if center:
        pad = n_fft // 2
        x = F.pad(x, (pad, pad))
    spec = F.conv1d(x[:, None, :], filters, stride=hop)     # (B, 2F, T)
    spec = spec.transpose(1, 2)
    n_bins = n_fft // 2 + 1
    return spec[..., :n_bins], spec[..., n_bins:]


def stft(x, sample_rate=16000, win_length=25.0, hop_length=10.0, n_fft=400,
         center=True):
    """Onesided STFT of (B, L) waveforms -> (real, imag), each
    (B, T, n_fft//2+1); ``center`` pads n_fft//2 zeros on both sides."""
    filters = _dft_filters_on(n_fft, _ms_to_samples(sample_rate, win_length),
                              x.device)
    return _stft(x, filters, n_fft, _ms_to_samples(sample_rate, hop_length),
                 center)


def spectral_magnitude(re, im):
    """|X|^2 of a complex spectrogram: the JAX function at the Fbank's
    settings (power 1, no log)."""
    return re * re + im * im


def _to_mel(hz):
    return 2595.0 * math.log10(1.0 + hz / 700.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank_matrix(n_mels=40, n_fft=400, sample_rate=16000):
    """Triangular mel filters (n_fft//2+1, n_mels) from 0 Hz to Nyquist,
    built in numpy."""
    n_stft = n_fft // 2 + 1
    mel = np.linspace(_to_mel(0.0), _to_mel(sample_rate / 2), n_mels + 2)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    band = (hz[1:] - hz[:-1])[:-1]
    f_central = hz[1:-1]
    all_freqs = np.linspace(0, sample_rate // 2, n_stft)
    slope = (all_freqs[None, :] - f_central[:, None]) / band[:, None]
    fbank = np.maximum(0.0, np.minimum(slope + 1.0, 1.0 - slope))
    return fbank.T.astype(np.float32)


def amplitude_to_db(x, multiplier=10.0, amin=1e-10, ref_value=1.0,
                    top_db=80.0):
    """Linear fbanks -> dB, clamped to ``top_db`` below each utterance's
    max over time and frequency."""
    x_db = multiplier * torch.log10(torch.clamp(x, min=amin))
    x_db = x_db - multiplier * math.log10(max(amin, ref_value))
    max_db = x_db.amax(dim=(-2, -1), keepdim=True)
    return torch.maximum(x_db, max_db - top_db)


class Fbank(nn.Module):
    """Waveform (B, L) -> log-mel features (B, T, n_mels)."""

    def __init__(self, sample_rate=16000, n_fft=400, n_mels=40,
                 win_length=25.0, hop_length=10.0):
        super().__init__()
        self.n_fft = n_fft
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.hop = _ms_to_samples(sample_rate, hop_length)
        win = _ms_to_samples(sample_rate, win_length)
        self.register_buffer("dft_filters", torch.from_numpy(
            _windowed_dft_filters(n_fft, win)), persistent=False)
        self.register_buffer("mel", torch.from_numpy(mel_filterbank_matrix(
            n_mels, n_fft, sample_rate)), persistent=False)

    def forward(self, wav):
        re, im = _stft(wav, self.dft_filters, self.n_fft, self.hop,
                       center=True)
        return amplitude_to_db(torch.matmul(spectral_magnitude(re, im),
                                            self.mel))


def input_normalization(x, rel_lengths, eps=1e-10):
    """Per-utterance mean / unbiased-std normalization over the valid
    ``round(rel*T)`` frames of ``x`` (B, T, F); std clamped to ``eps``."""
    T = x.shape[1]
    counts = relative_to_absolute_lengths(rel_lengths, T)
    mask = length_to_mask(counts, T)[..., None]
    n = torch.clamp(counts, min=1).to(x.dtype)[:, None, None]
    mean = torch.where(mask, x, 0.0).sum(dim=1, keepdim=True) / n
    sq = torch.where(mask, (x - mean) ** 2, 0.0).sum(dim=1, keepdim=True)
    std = torch.sqrt(sq / torch.clamp(n - 1.0, min=1.0))
    std = torch.clamp(std, min=eps)
    return (x - mean) / std


def pad_audio_to_frame_multiple(wav, rel_lengths, multiple,
                                sample_rate=16000, hop_length=10.0):
    """Zero-pad waveforms (B, L) so the center-STFT frame count
    ``1 + L // hop`` is a multiple of ``multiple``, rescaling relative
    lengths so ``round(rel * T)`` still covers the same samples. A no-op
    when already aligned. (The recipe's ``pad_feats_to``.)"""
    hop = _ms_to_samples(sample_rate, hop_length)
    L = wav.shape[-1]
    T = 1 + L // hop
    T_new = -(-T // multiple) * multiple
    L_new = (T_new - 1) * hop
    if L_new <= L:
        return wav, rel_lengths
    return F.pad(wav, (0, L_new - L)), rel_lengths * (L / L_new)
