"""The precision the model computes in, and the one its softmaxes run in.

``compute_dtype`` maps the recipe's ``precision`` ("fp32" or "bf16") to
the model's compute dtype. As a flax module with ``dtype=bfloat16`` does,
a bf16 model casts its f32 parameters and its inputs to bf16 at each use
(``cast``) and returns bf16: the parameters, their gradients and the
optimizer state stay f32. An f32 model computes in its tensors' own
dtype, so the f32 path runs exactly as it always did (and the card's f32
noise-floor check in ``chip_smoke.py`` runs it in f64).
"""

import torch

PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16}


def compute_dtype(precision):
    """torch dtype of a ``precision`` name ("fp32", "bf16"; None: fp32)."""
    if precision is None:
        return torch.float32
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{sorted(PRECISIONS)}")
    return PRECISIONS[precision]


def cast(x, dtype):
    """``x`` in the compute dtype: unchanged for an f32 model (or a None
    ``x``), else ``x.to(dtype)``."""
    if x is None or dtype == torch.float32:
        return x
    return x.to(dtype)


def f32_or_wider(x):
    """f32, or ``x``'s own dtype when it is wider: the recipe's softmaxes
    run in f32, and an f64 run (the card's f32 noise-floor check in
    ``chip_smoke.py``) stays f64 throughout."""
    return torch.promote_types(x.dtype, torch.float32)
