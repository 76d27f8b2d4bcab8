"""The Noam learning-rate schedule.

Counterpart of the JAX package's ``training/schedulers.py``
(``noam_schedule``, ``NoamScheduler``): lr(n) = lr_initial * normalize *
min(n^-0.5, n * warmup^-1.5), normalize = warmup^0.5 (or
model_size^-0.5). The schedule takes ``max(step, 1)``; the JAX optimizer
calls it with its inner update count, which starts at 0, so the first
two updates share lr(1). The Brain keeps that. The mirror is a
checkpoint recoverable (``save`` / ``load``), as in JAX.
"""

import json


def noam_schedule(lr_initial, n_warmup_steps, model_size=None):
    """Pure schedule fn: step -> lr."""
    if not isinstance(lr_initial, (int, float)):
        raise TypeError(f"lr_initial must be a number, got {lr_initial!r}")
    normalize = n_warmup_steps ** 0.5 if model_size is None \
        else model_size ** -0.5

    def schedule(step):
        n = float(max(step, 1))
        return lr_initial * normalize * min(n ** -0.5,
                                            n * n_warmup_steps ** -1.5)

    return schedule


class NoamScheduler:
    """Host-side mirror of the schedule (the learning rate to log)."""

    def __init__(self, lr_initial, n_warmup_steps, model_size=None):
        self.lr_initial = lr_initial
        self.n_warmup_steps = n_warmup_steps
        self.model_size = model_size
        self.current_lr = lr_initial
        self.n_steps = 0
        self.normalize = n_warmup_steps ** 0.5
        if model_size is not None:
            self.normalize = model_size ** (-0.5)

    def __call__(self, *_args):
        """Advance one optimizer step; returns (old_lr, new_lr)."""
        self.n_steps += 1
        current = self.current_lr
        lr = self.lr_initial * self._scale(self.n_steps)
        self.current_lr = lr
        return current, lr

    def _scale(self, n):
        return self.normalize * min(n ** -0.5,
                                    n * self.n_warmup_steps ** -1.5)

    def as_schedule_fn(self):
        return noam_schedule(self.lr_initial, self.n_warmup_steps,
                             self.model_size)

    def save(self, path):
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"n_steps": self.n_steps,
                       "current_lr": self.current_lr}, f)

    def load(self, path, end_of_epoch=True):
        with open(path, encoding="utf-8") as f:
            saved = json.load(f)
        self.n_steps = saved["n_steps"]
        self.current_lr = saved["current_lr"]
