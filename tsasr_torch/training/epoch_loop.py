"""Checkpointable epoch iteration.

Equivalent of the reference ``EpochCounter`` / ``EpochCounterWithStopper``
(``vendor/speechbrain/speechbrain/utils/epoch_loop.py:17-187``): an
iterator over epochs whose position survives checkpointing, with
``end_of_epoch`` semantics — resuming from a mid-epoch checkpoint repeats
the interrupted epoch, resuming from an end-of-epoch checkpoint moves on.
"""

import json


class EpochCounter:
    def __init__(self, limit):
        self.current = 0
        self.limit = int(limit)

    def __iter__(self):
        return self

    def __next__(self):
        if self.current < self.limit:
            self.current += 1
            return self.current
        raise StopIteration

    # checkpoint hooks
    def save(self, path):
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"current": self.current}, f)

    def load(self, path, end_of_epoch=True):
        with open(path, encoding="utf-8") as f:
            saved = json.load(f)["current"]
        if end_of_epoch:
            self.current = saved
        else:
            # repeat the interrupted epoch
            self.current = max(saved - 1, 0)


class EpochCounterWithStopper(EpochCounter):
    """Early stopping: halts when the tracked metric hasn't improved by
    more than ``epsilon`` for ``patience`` epochs after ``limit_warmup``."""

    def __init__(self, limit, limit_to_stop, limit_warmup, direction="min",
                 epsilon=1e-5):
        super().__init__(limit)
        self.limit_to_stop = int(limit_to_stop)
        self.limit_warmup = int(limit_warmup)
        self.direction = direction
        self.epsilon = epsilon
        if self.limit_to_stop < 0 or self.limit_warmup < 0:
            raise ValueError("stopper limits must be non-negative")
        self.best_limit = 0
        self.best_score = float("inf") if direction == "min" \
            else float("-inf")
        self.should_stop = False

    def __next__(self):
        if self.should_stop:
            raise StopIteration
        return super().__next__()

    def update_metric(self, current_metric):
        if self.current > self.limit_warmup:
            improved = (current_metric < self.best_score - self.epsilon
                        if self.direction == "min"
                        else current_metric > self.best_score + self.epsilon)
            if improved:
                self.best_limit = self.current
                self.best_score = current_metric
            self.should_stop = (self.current - self.best_limit
                                >= self.limit_to_stop)

    def save(self, path):
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"current": self.current,
                       "best_limit": self.best_limit,
                       "best_score": self.best_score,
                       "should_stop": self.should_stop}, f)

    def load(self, path, end_of_epoch=True):
        with open(path, encoding="utf-8") as f:
            saved = json.load(f)
        self.best_limit = saved["best_limit"]
        self.best_score = saved["best_score"]
        self.should_stop = saved["should_stop"]
        self.current = saved["current"] if end_of_epoch \
            else max(saved["current"] - 1, 0)
