"""Optimizer factories.

Counterpart of the JAX package's ``training/optimizers.py``: the recipe's
optimizer slot holds a factory, and the Brain builds the optimizer from
it over the model's parameters. ``make_adamw`` gives ``optax.adamw``'s
semantics on ``torch.optim.AdamW``: bias-corrected moments,
``update / (sqrt(v_hat) + eps)`` and weight decay decoupled from the
moments, applied to every parameter (no mask). The learning rate is set
by the Brain before each update from the schedule.
"""

import torch


def make_adamw(lr=1e-3, betas=(0.9, 0.98), eps=1e-8, weight_decay=0.01):
    """AdamW factory matching the recipe's optimizer block."""

    def factory(params, learning_rate=None):
        return torch.optim.AdamW(
            params, lr=learning_rate if learning_rate is not None else lr,
            betas=tuple(betas), eps=eps, weight_decay=weight_decay)

    factory.base_lr = lr
    return factory
