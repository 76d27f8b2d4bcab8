"""The trainer: ``Brain``, AdamW and the Noam schedule."""

from tsasr_torch.training.brain import Brain  # noqa: F401
from tsasr_torch.training.optimizers import make_adamw  # noqa: F401
from tsasr_torch.training.schedulers import (  # noqa: F401
    NoamScheduler,
    noam_schedule,
)
