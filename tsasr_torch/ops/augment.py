"""Train-time augmentation: SpecAugment and speed perturbation.

Counterpart of the JAX package's ``ops/augment.py``, with each random
draw kept apart from its transform: a ``draw_*`` function takes a
``torch.Generator`` and returns plain numbers (Python ints, or CPU int64
tensors for the per-example masks), and the matching ``apply_*`` is
deterministic given them. The two frameworks cannot share a random
stream; the parity tests make JAX's draws with ``jax.random`` and hand
them to the ``apply_*`` functions here. Drawing on a CPU generator
needs no device sync.

Semantics kept from the JAX functions:

- ``spec_augment``: one time warp for the whole batch (centre ``c``,
  warped to ``w``; the identity when ``T - window <= window``), a bicubic
  gather along time with torch's cubic kernel (a = -0.75), index maps
  computed in f32 and taps clamped to each segment; then the frequency
  masks, then the time masks, per example, with
  ``max_pos = max(1, D - lengths.max())`` over the whole batch; masked
  values take the mean of the whole padded batch (after the warp), or 0
  with ``replace_with_zero``; an empty width range is the identity. A
  rank of a data-parallel step draws for the global batch and applies
  its rows' draws (``take_rows``), the mean that of the global batch.
- ``speed_perturb``: one speed for the whole batch; 100 is the identity,
  any other speed resamples 100 -> speed with ``resample_device``; a
  speed below 100 gives fewer samples, zero-padded to the input length
  L, one above 100 more, truncated to L; the returned factor is
  ``min(new_len, L) / L`` in f32, by which the caller scales relative
  lengths.
"""

import math

import torch
import torch.nn.functional as F

from tsasr_torch.data.audio import _sinc_kernel

CUBIC_A = -0.75


# ------------------------------------------------------------- SpecAugment
def _width_range(width):
    """An int width is the range (0, width), as the reference takes it."""
    return (0, width) if isinstance(width, int) else tuple(width)


def draw_time_warp(generator, T, window):
    """(c, w) of one time warp over T frames, or None (the identity) when
    ``T - window <= window``."""
    if T - window <= window:
        return None
    c = int(torch.randint(window, T - window, (), generator=generator))
    w = int(torch.randint(c - window, c + window, (),
                          generator=generator)) + 1
    return c, w


def draw_masks(generator, B, D, n_masks, width_range):
    """(lengths, positions), each (B, n_masks, 1) int64 on the CPU, of
    span masks along an axis of size D; None for an empty width range."""
    lo, hi = width_range
    if hi <= lo:
        return None
    lengths = torch.randint(lo, hi, (B, n_masks, 1), generator=generator)
    max_pos = max(1, D - int(lengths.max()))
    pos = torch.randint(0, max_pos, (B, n_masks, 1), generator=generator)
    return lengths, pos


def draw_spec_augment(generator, shape, time_warp=True, time_warp_window=5,
                      freq_mask=True, freq_mask_width=(0, 30),
                      n_freq_mask=2, time_mask=True, time_mask_width=(0, 20),
                      n_time_mask=2, replace_with_zero=False):
    """The draws of one ``spec_augment`` call over features of ``shape``
    (B, T, F): ``{"warp": (c, w) | None, "freq": (lengths, pos) | None,
    "time": (lengths, pos) | None}``. Takes ``spec_augment``'s keywords
    (``replace_with_zero`` draws nothing)."""
    B, T, n_freq = shape
    return {
        "warp": (draw_time_warp(generator, T, time_warp_window)
                 if time_warp else None),
        "freq": (draw_masks(generator, B, n_freq, n_freq_mask,
                            _width_range(freq_mask_width))
                 if freq_mask else None),
        "time": (draw_masks(generator, B, T, n_time_mask,
                            _width_range(time_mask_width))
                 if time_mask else None),
    }


def take_rows(draws, rows):
    """The draws of ``draw_spec_augment`` for the rows ``rows`` (indices
    into the batch they were drawn for); the warp is the batch's."""
    rows = torch.as_tensor(rows, dtype=torch.int64)
    return {key: (value if key == "warp" or value is None
                  else tuple(m[rows] for m in value))
            for key, value in draws.items()}


def _cubic_weight(t, a=CUBIC_A):
    """torch's cubic convolution kernel (upsample bicubic, a = -0.75)."""
    t = t.abs()
    t2 = t * t
    t3 = t2 * t
    inner = (a + 2) * t3 - (a + 3) * t2 + 1
    outer = a * t3 - 5 * a * t2 + 8 * a * t - 4 * a
    return torch.where(t <= 1, inner,
                       torch.where(t < 2, outer, torch.zeros_like(t)))


def _cubic_gather_time(x, pos, lo_limit, hi_limit):
    """Sample x (B, T, F) at f32 time positions ``pos`` (T',) with the
    bicubic kernel, each tap clamped to [lo_limit, hi_limit] (T',)."""
    base = torch.floor(pos)
    frac = pos - base
    base = base.to(torch.int64)
    out = None
    for k in (-1, 0, 1, 2):
        idx = torch.minimum(torch.maximum(base + k, lo_limit), hi_limit)
        tap = x[:, idx] * _cubic_weight(frac - k)[None, :, None]
        out = tap if out is None else out + tap
    return out


def apply_time_warp(x, c, w):
    """Stretch frames [0, c) onto [0, w) and [c, T) onto [w, T) of x
    (B, T, F) by align-corners index maps in f32, each segment's taps
    clamped inside the segment."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    f32 = torch.float32

    def divide(num, den):
        # by a tensor: CUDA divides by a Python scalar as a product with
        # its reciprocal, which moves the maps by an ulp off the true
        # quotient, and the features by up to ~1e-3 at a steep frame
        num = num.to(f32)
        return num / torch.full_like(num, den)

    left = divide(t * (c - 1), max(w - 1, 1))
    right = c + divide((t - w) * (T - c - 1), max(T - w - 1, 1))
    is_left = t < w
    pos = torch.where(is_left, left, right)
    lo = torch.where(is_left, 0, c)
    hi = torch.where(is_left, c - 1, T - 1)
    pos = torch.minimum(torch.maximum(pos, lo.to(f32)), hi.to(f32))
    return _cubic_gather_time(x, pos, lo, hi)


def apply_masks(x, masks, dim, fill):
    """Fill the spans ``masks`` = (lengths, pos) (B, n, 1) along ``dim``
    (1 time, 2 frequency) of x (B, T, F) with ``fill``."""
    lengths, pos = (m.to(x.device, non_blocking=True) for m in masks)
    arange = torch.arange(x.shape[dim], device=x.device)[None, None, :]
    mask = ((pos <= arange) & (arange < pos + lengths)).any(dim=1)
    mask = mask[:, :, None] if dim == 1 else mask[:, None, :]
    return torch.where(mask, fill, x)


def apply_spec_augment(x, draws, replace_with_zero=False, mean=torch.mean):
    """SpecAugment of x (B, T, F) with the draws of
    ``draw_spec_augment``: time warp, frequency masks, time masks. The
    masks' fill is ``mean`` of the warped batch (a data-parallel rank
    passes the global batch's), or 0 with ``replace_with_zero``."""
    if draws["warp"] is not None:
        x = apply_time_warp(x, *draws["warp"])
    fill = torch.zeros((), dtype=x.dtype, device=x.device) \
        if replace_with_zero else mean(x)
    if draws["freq"] is not None:
        x = apply_masks(x, draws["freq"], 2, fill)
    if draws["time"] is not None:
        x = apply_masks(x, draws["time"], 1, fill)
    return x


def spec_augment(x, generator, **kwargs):
    """SpecAugment over (B, T, F) features, drawing from ``generator``;
    keywords as ``draw_spec_augment``."""
    draws = draw_spec_augment(generator, tuple(x.shape), **kwargs)
    return apply_spec_augment(x, draws,
                              bool(kwargs.get("replace_with_zero", False)))


# ------------------------------------------------------- speed perturbation
def _conv1d_f32(x, weight, stride):
    """``F.conv1d`` with cuDNN's TF32 off for the call (a full f32
    product, as the JAX version's ``Precision.HIGHEST``)."""
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv1d(x, weight, stride=stride)
    finally:
        torch.backends.cudnn.allow_tf32 = allow


def resample_device(wav, orig_freq, new_freq):
    """Windowed-sinc polyphase resampling (B, L) -> (B, ceil(nf L / of))
    on the tensor's device: the host resampler's Kaiser-sinc kernels
    (``data/audio.py::_sinc_kernel``) as one strided f32 convolution whose
    output channels are the phases, interleaved."""
    if int(orig_freq) == int(new_freq):
        return wav
    kernels, width, of, nf = _sinc_kernel(int(orig_freq), int(new_freq))
    B, L = wav.shape
    target_len = int(math.ceil(nf * L / of))
    padded = F.pad(wav, (width, width + of))
    weight = torch.from_numpy(kernels).to(wav.device, wav.dtype)[:, None, :]
    out = _conv1d_f32(padded[:, None, :], weight, of)      # (B, nf, frames)
    return out.transpose(1, 2).reshape(B, -1)[:, :target_len]


def draw_speed(generator, speeds):
    """The index into ``speeds`` of one batch's speed."""
    return int(torch.randint(0, len(speeds), (), generator=generator))


def apply_speed_perturb(wav, speed):
    """(B, L) waveforms at ``speed`` percent -> ((B, L) waveforms, f32
    factor (a 0-d tensor on the waveforms' device) to scale relative
    lengths by)."""
    B, L = wav.shape
    if speed == 100:
        return wav, torch.ones((), dtype=torch.float32, device=wav.device)
    out = resample_device(wav, 100, speed)
    new_len = out.shape[1]
    if new_len >= L:
        out = out[:, :L]
    else:
        out = F.pad(out, (0, L - new_len))
    factor = torch.tensor(min(new_len, L) / L, dtype=torch.float32,
                          device=wav.device)
    return out, factor


def speed_perturb(wav, generator, speeds=(95, 100, 105), sample_rate=16000):
    """Random speed change of (B, L) waveforms, one speed per batch drawn
    from ``generator``; the output stays (B, L). Returns (waveforms,
    factor). ``sample_rate`` is accepted for the yaml's keywords (the
    ratio alone sets the resampling)."""
    return apply_speed_perturb(wav, speeds[draw_speed(generator, speeds)])
