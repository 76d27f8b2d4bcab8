"""The rank layout of the mesh's axes, and each rank's rows of the
global batch.

The port of the JAX package's ``parallel/mesh.py``: ``make_mesh``
(``:33-58``) orders its axes (data, pipe, seq, model), row-major over
the devices. The port has one process per device, so a rank's place on
the axes follows from its world rank the same way (``rank_coords``):
for tensor parallelism 1, world rank = (d·P + p)·S + s. ``axis_ranks``
lists the world ranks of a rank's group along one axis, in the order of
that axis's coordinate.

The batch layout is the port of ``pad_batch_to`` and ``shard_batch``
(``:165-200``). Every rank builds the
same global host batch from the same sampler; ``pad_batch_to`` pads its
rows to a multiple of the world size by duplicating trailing rows, whose
``weight`` is 0, and ``shard_batch`` hands rank ``r`` its contiguous
block of rows (JAX's ``P("data")`` over a data axis of the world size).
Every other dimension keeps its global padded size, so the frames, the
relative lengths and the encoder lengths are what one process computes.
``BatchShard`` tells a rank which global rows it holds, for draws made
over the global batch (the recipe's augmentation) and for the global
loss denominator.

The rows follow the data coordinate: the ranks of one sequence or
pipeline group hold the same rows. Under a pipeline axis the batch pads
to a multiple of data·pipe, as the JAX ``shard_batch`` pads it, so each
data shard divides the default micro-batch count.
"""

from dataclasses import dataclass

import numpy as np

# make_mesh's axis order; the model (tensor-parallel) axis is the
# fastest-varying
AXES = ("data", "pipe", "seq", "model")


def _sizes(dp, pp=1, sp=1, tp=1):
    return {"data": dp, "pipe": pp, "seq": sp, "model": tp}


def rank_coords(rank, dp, pp=1, sp=1, tp=1):
    """{axis: coordinate} of world rank ``rank`` on a (data, pipe, seq,
    model) mesh of those sizes, row-major as ``make_mesh`` lays devices
    out."""
    sizes = _sizes(dp, pp, sp, tp)
    n = int(np.prod(list(sizes.values())))
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is not in a mesh of {n} ranks")
    coords = {}
    for axis in reversed(AXES):
        rank, coords[axis] = divmod(rank, sizes[axis])
    return {axis: coords[axis] for axis in AXES}


def axis_ranks(rank, axis, dp, pp=1, sp=1, tp=1):
    """The world ranks that share every coordinate of ``rank`` but
    ``axis``'s, in the order of that coordinate."""
    sizes = _sizes(dp, pp, sp, tp)
    coords = rank_coords(rank, dp, pp, sp, tp)
    out = []
    for i in range(sizes[axis]):
        c = dict(coords, **{axis: i})
        r = 0
        for a in AXES:
            r = r * sizes[a] + c[a]
        out.append(r)
    return out


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


def rank_rows(batch_arrays, rank, world_size, multiple=None):
    """(this rank's arrays, its ``BatchShard``) of a global batch:
    ``rank`` is the data coordinate and ``world_size`` the data axis's
    size; the batch pads to a multiple of ``multiple`` (default
    ``world_size``; data·pipe under a pipeline axis)."""
    size = len(np.asarray(batch_arrays["weight"]))
    padded = pad_batch_to(dict(batch_arrays, _row=np.arange(size)),
                          multiple or world_size)
    block = shard_batch(padded, rank, world_size)
    rows = block.pop("_row")
    start = rank * len(rows)
    shard = BatchShard(
        rows=rows, real=np.arange(start, start + len(rows)) < size,
        size=size,
        weight_total=float(np.asarray(batch_arrays["weight"]).sum()))
    return block, shard
