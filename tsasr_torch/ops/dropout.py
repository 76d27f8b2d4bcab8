"""Dropout with reduced-width random bits.

Counterpart of the JAX package's ``ops/dropout.py`` (``keep_mask``,
``Dropout``). ``bits`` is the width of the random draw per mask element:

- ``bits=32`` is a Bernoulli draw with keep probability ``1 - rate``;
- ``bits=8`` / ``bits=16`` draw raw uint bits and keep an element iff its
  draw is below ``min(round(keep * 2**bits), 2**bits - 1)``, so the keep
  probability is quantized (keep 0.9 at bits 8 is 230/256).

Kept elements are scaled by ``1 / (1 - rate)``; rate 0 or eval is the
identity. The draws come from an explicit ``torch.Generator`` on the
tensor's device (the JAX package's ``'dropout'`` rng stream): the two
frameworks give different bits from one seed, so tests compare rates
and feed both sides the same masks where they need equal numbers.
"""

import numpy as np
import torch
from torch import nn


def keep_mask(gen, keep_prob, shape, bits=32, device=None):
    """Boolean keep-mask of ``shape`` drawn from ``gen``."""
    device = gen.device if device is None else device
    if bits == 32:
        return torch.rand(shape, generator=gen, device=device) < keep_prob
    if bits not in (8, 16):
        raise ValueError(f"dropout bits must be 8, 16 or 32, got {bits}")
    thr = min(int(round(keep_prob * (1 << bits))), (1 << bits) - 1)
    dtype = torch.uint8 if bits == 8 else torch.int32
    draw = torch.randint(0, 1 << bits, shape, generator=gen, device=device,
                         dtype=dtype)
    return draw < thr


def dropout(x, gen, rate, bits=32, part=None):
    """Zero elements of ``x`` with probability ``rate`` and scale the rest
    by ``1 / (1 - rate)``. The mask depends on the generator and the
    shape only, so an f32 and a bf16 run of one step drop the same
    elements.

    ``part`` = (dim, start, size): ``x`` is the block [start, start +
    x.shape[dim]) along ``dim`` of a tensor ``size`` long there (a
    tensor-parallel rank's slice); the whole tensor's mask is drawn, so
    the generator moves on as one process's does, and ``x`` takes its
    block of it."""
    shape = list(x.shape)
    if part is not None:
        dim, start, shape[dim] = part
    keep = keep_mask(gen, 1.0 - rate, tuple(shape), bits, x.device)
    if part is not None:
        keep = keep.narrow(dim, start, x.shape[dim])
    return torch.where(keep, x / _keep_divisor(x, rate), 0.0).to(x.dtype)


def _keep_divisor(x, rate):
    """``1 - rate`` as the JAX package divides by it. Below f32 the
    weak-typed Python float takes x's dtype there (0.9 is 0.8984375 in
    bf16) and the quotient is rounded from the true one; a 0-d tensor on
    x's device does the same here, where a Python scalar would become a
    product with its reciprocal on CUDA, an ulp away in bf16. f32 and
    wider keep the Python float, as the f32 path always had."""
    if torch.finfo(x.dtype).bits >= 32:
        return 1.0 - rate
    return torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)


def fold_generator(generator, *data):
    """A generator on ``generator``'s device seeded from its seed and the
    ints ``data`` (the JAX package's ``fold_in``): folds of one seed by
    different data draw apart, and every process that folds the same
    seed by the same data draws the same. None folds to None."""
    if generator is None:
        return None
    key = np.random.SeedSequence([generator.initial_seed(), *data])
    folded = torch.Generator(device=generator.device)
    folded.manual_seed(int(key.generate_state(1, np.uint64)[0] >> 1))
    return folded


class Dropout(nn.Module):
    """``Dropout(rate, bits)``; called as ``(x, deterministic, generator)``
    like the JAX module's ``(x, deterministic)`` with its rng stream
    (``part``: see ``dropout``)."""

    def __init__(self, rate, bits=32):
        super().__init__()
        self.rate = float(rate)
        self.bits = bits

    def forward(self, x, deterministic=True, generator=None, part=None):
        if deterministic or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout needs a torch.Generator")
        return dropout(x, generator, self.rate, self.bits, part)
