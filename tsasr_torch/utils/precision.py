"""The precision softmaxes and log-softmaxes run in."""

import torch


def f32_or_wider(x):
    """f32, or ``x``'s own dtype when it is wider: the recipe's softmaxes
    run in f32, and an f64 run (the card's f32 noise-floor check in
    ``chip_smoke.py``) stays f64 throughout."""
    return torch.promote_types(x.dtype, torch.float32)
