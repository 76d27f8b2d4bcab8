"""The data axis's batch layout: each rank's rows of the global batch.

The port of the data-axis part of the JAX package's ``parallel/mesh.py``
(``pad_batch_to``, ``shard_batch``, ``:165-200``). Every rank builds the
same global host batch from the same sampler; ``pad_batch_to`` pads its
rows to a multiple of the world size by duplicating trailing rows, whose
``weight`` is 0, and ``shard_batch`` hands rank ``r`` its contiguous
block of rows (JAX's ``P("data")`` over a data axis of the world size).
Every other dimension keeps its global padded size, so the frames, the
relative lengths and the encoder lengths are what one process computes.
``BatchShard`` tells a rank which global rows it holds, for draws made
over the global batch (the recipe's augmentation) and for the global
loss denominator.

The model, sequence and pipeline axes of the JAX mesh are not ported
(``ROADMAP.md`` queue 1 item 7).
"""

from dataclasses import dataclass

import numpy as np


def pad_batch_to(batch_arrays, multiple):
    """Pad the batch dim by duplicating trailing examples so it divides
    ``multiple``; the ``weight`` entry is zeroed for duplicated rows so a
    sharded loss and its gradients equal the unsharded ones."""
    out = {}
    b = None
    for key, value in batch_arrays.items():
        arr = np.asarray(value)
        b = arr.shape[0] if b is None else b
        target = -(-b // multiple) * multiple
        if target != b:
            reps = np.concatenate(
                [arr, arr[: target - b]], axis=0) if target - b <= b else \
                np.concatenate([arr] * (-(-target // b)), axis=0)[:target]
            if key == "weight":
                reps = reps.copy()
                reps[b:] = 0
            out[key] = reps
        else:
            out[key] = arr
    return out


def shard_batch(batch_arrays, rank, world_size):
    """Rank ``rank``'s contiguous block of rows of a batch whose rows
    divide ``world_size`` (``pad_batch_to``)."""
    out = {}
    for key, value in batch_arrays.items():
        arr = np.asarray(value)
        if arr.shape[0] % world_size:
            raise ValueError(f"{key}: {arr.shape[0]} rows do not divide "
                             f"{world_size} ranks; pad_batch_to first")
        block = arr.shape[0] // world_size
        out[key] = arr[rank * block:(rank + 1) * block]
    return out


@dataclass(frozen=True)
class BatchShard:
    """Which rows of a global batch of ``size`` rows one rank holds:
    ``rows`` their indices in it, ``real`` False for a padding duplicate,
    ``weight_total`` the global batch's summed weight."""
    rows: np.ndarray
    real: np.ndarray
    size: int
    weight_total: float


def rank_rows(batch_arrays, rank, world_size):
    """(this rank's arrays, its ``BatchShard``) of a global batch."""
    size = len(np.asarray(batch_arrays["weight"]))
    padded = pad_batch_to(dict(batch_arrays, _row=np.arange(size)),
                          world_size)
    block = shard_batch(padded, rank, world_size)
    rows = block.pop("_row")
    start = rank * len(rows)
    shard = BatchShard(
        rows=rows, real=np.arange(start, start + len(rows)) < size,
        size=size,
        weight_total=float(np.asarray(batch_arrays["weight"]).sum()))
    return block, shard
