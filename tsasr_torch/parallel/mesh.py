"""The rank layout of the mesh's axes, and each rank's rows of the
global batch.

The port of the JAX package's ``parallel/mesh.py``: ``make_mesh``
(``:33-58``) orders its axes (data, pipe, seq, model), row-major over
the devices. The port has one process per device, so a rank's place on
the axes follows from its world rank the same way (``rank_coords``):
for tensor parallelism 1, world rank = (d·P + p)·S + s. ``axis_ranks``
lists the world ranks of a rank's group along one axis, in the order of
that axis's coordinate.

The tensor-parallel split rule is the port of ``_tp_spec``,
``tp_sharding_report`` and ``validate_tp_shardings`` (``:70-162``) over
the port's parameter names (``split_dim``, ``param_split_dims``,
``tp_sharding_report``, ``validate_tp_shardings``): Megatron pairs, the
first matrix of a pair split by its output dim (``ffn{1,2}.w1``,
``qkv_proj``, ``pointwise_in``), the second by its input dim
(``ffn{1,2}.w2``, every ``out_proj``, ``pointwise_out``), only where the
model axis divides that dim; every other leaf, and every leaf below two
dims, is replicated. A torch ``Linear`` weight is (out, in), the
transpose of a flax kernel, so the output dim is dim 0 here.

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

import re
from dataclasses import dataclass

import numpy as np

# make_mesh's axis order; the model (tensor-parallel) axis is the
# fastest-varying
AXES = ("data", "pipe", "seq", "model")


# every Conformer layer holds exactly this many split matrices:
# ffn{1,2}.w{1,2}, mha.{qkv_proj,out_proj}, conv.{pointwise_in,
# pointwise_out} (the JAX package's ``TP_KERNELS_PER_CONFORMER_LAYER``)
TP_KERNELS_PER_CONFORMER_LAYER = 8
# name fragments of the pairs' first (split by output) and second (split
# by input) matrices, the port's names of ``_tp_spec``'s
TP_OUTPUT_SPLIT = (".ffn1.w1.", ".ffn2.w1.", ".qkv_proj.", ".pointwise_in.")
TP_INPUT_SPLIT = (".ffn1.w2.", ".ffn2.w2.", ".out_proj.", ".pointwise_out.")
_LAYER_SCOPE = re.compile(r"(^|\.)((?:\w+\.)*layers\.\d+)(\.|$)")


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


def split_dim(name, shape, tp):
    """The dim of the port's parameter ``name`` (of ``shape``) that the
    model axis of ``tp`` ranks splits, or None where it is replicated:
    0 (the output dim) for a pair's first matrix, 1 (the input dim) for
    its second, where ``tp`` divides that dim."""
    if tp <= 1 or len(shape) < 2:
        return None
    key = "." + name.lower()
    if any(k in key for k in TP_OUTPUT_SPLIT) and shape[0] % tp == 0:
        return 0
    if any(k in key for k in TP_INPUT_SPLIT) and shape[1] % tp == 0:
        return 1
    return None


def param_split_dims(shapes, tp):
    """{name: ``split_dim``} of a ``{name: tensor or shape}`` dict (a
    whole model's ``state_dict``)."""
    return {name: split_dim(name, tuple(getattr(x, "shape", x)), tp)
            for name, x in shapes.items()}


def tp_sharding_report(splits):
    """(split names, replicated names) of ``param_split_dims``'s
    mapping."""
    sharded = [n for n, d in splits.items() if d is not None]
    replicated = [n for n, d in splits.items() if d is None]
    return sharded, replicated


def layer_scope(name):
    """The ``...layers.<i>`` scope ``name`` lies in, or None."""
    found = _LAYER_SCOPE.search(name)
    return found.group(2) if found else None


def validate_tp_shardings(splits, expected_layers=None):
    """Guard against name drift replicating split leaves without a word
    (the JAX ``validate_tp_shardings``): every ``layers.<i>`` scope of
    ``splits`` (``param_split_dims``) must hold exactly
    ``TP_KERNELS_PER_CONFORMER_LAYER`` split leaves, and there must be
    ``expected_layers`` scopes where that is given. Raises ValueError
    otherwise, or where no scope is found at all. Returns (split,
    replicated) names."""
    sharded, replicated = tp_sharding_report(splits)
    scopes = {layer_scope(n) for n in splits} - {None}
    if not scopes:
        raise ValueError(
            "a model axis was asked for but no Conformer 'layers.<i>' "
            "scope is in the parameter names: the split rule cannot apply")
    if expected_layers is not None and len(scopes) != expected_layers:
        raise ValueError(f"expected {expected_layers} Conformer layer "
                         f"scopes, found {len(scopes)}: {sorted(scopes)}")
    per_scope = dict.fromkeys(scopes, 0)
    for name in sharded:
        scope = layer_scope(name)
        if scope is not None:
            per_scope[scope] += 1
    bad = {s: n for s, n in per_scope.items()
           if n != TP_KERNELS_PER_CONFORMER_LAYER}
    if bad:
        raise ValueError(
            "tensor-parallel split drift: these Conformer layers do not "
            f"hold exactly {TP_KERNELS_PER_CONFORMER_LAYER} split "
            f"matrices (a renamed submodule?): {bad}")
    return sharded, replicated


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
