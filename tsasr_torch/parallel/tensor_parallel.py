"""Tensor parallelism: every Conformer layer's matrices split over the
ranks of the mesh's ``model`` axis.

The port of what the JAX package's ``parallel/mesh.py::_tp_spec`` and
GSPMD do together: JAX annotates the parameters and XLA inserts the
collectives; here each rank holds its shards (``shard_model``) and the
modules call the collectives explicitly, Megatron's two operators over
the model axis's group:

- ``copy_to_model``: the identity forward, an all-reduce of the
  cotangent in the backward, where a replicated activation enters a
  split matrix (each rank's shard sends back its part of the gradient);
- ``reduce_from_model``: an all-reduce forward, the identity backward,
  where a split matrix's partial products leave;
- ``reduce_both``: an all-reduce both ways, for the conv module's
  LayerNorm moments, which sum over the ranks' channels and whose
  cotangents each rank holds only its channels' part of.

Which modules split (``TP_SPLIT``, the leaves that must be split for
the module to run split), what a split module reads of its replicated
leaves (``TP_PARTS``, slices of whole leaves) and what it needs of the
axis's size (``check_tensor_parallel``, where it has one):

- ``FeedForward``: ``w1`` by its output rows, ``w2`` by its input
  columns; ``w1.bias`` read in the rank's slice, ``w2.bias`` added once
  after the all-reduce; the hidden's dropout mask is the rank's slice of
  the whole mask (``ops.dropout.dropout``'s ``part``);
- ``RelPosMHAXL``: ``qkv_proj`` by its output rows, laid out (H, 3·Dh),
  so a rank holds whole heads [h0, h0 + H/T); ``pos_proj``'s rows and
  ``pos_bias_u/v``'s heads read in the rank's slice; ``out_proj`` by its
  input columns; the scores keep the whole model's ``1/sqrt(d_model)``;
  the kernels count their dropout from ``h0``;
- ``ConvolutionModule``: ``pointwise_in`` split within each GLU half
  (``convert.shard_tensor``), so the GLU stays on the rank; the
  depthwise conv and ``norm_mid`` read the rank's channels, the
  LayerNorm's two moments all-reduced (``tp_layer_norm``);
  ``pointwise_out`` by its input columns;
- ``CrossAttention`` (``cross_attention`` injection): ``out_proj`` by its
  input columns; q, k and v stay whole on every rank.

Beside a sequence or pipeline axis (the JAX package's four-axis mesh,
whose ``shard_map``s take the encoder's parameters whole), the main
encoder's layers keep their shards as storage but run whole, at all H
heads, on leaves gathered over the model axis once a micro-batch
(``shard_model``'s ``gathered`` scope, ``gather_layers``: one
``all_gather`` of a flat buffer, ``_GatherLeaves``); every other split
module runs split as above.

A split leaf's gradient is its shard's (all-reduced over the data axis
and, beside a sequence or pipeline axis, over that axis: never over the
model axis); a ``TP_PARTS`` leaf's gradient on a rank holds its slice's
part, summed over the model axis; every other leaf's every rank computes
whole (``Brain.gradient_shares``). ``stats`` counts the model axis's
all-reduces, their bytes and the host seconds they took, and the
gathers likewise (``gathers``, ``gather_bytes``, ``gather_seconds``).
"""

import collections
import copy
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tsasr_torch.convert import gather_tensors, shard_tensor
from tsasr_torch.parallel.hop import all_gather
from tsasr_torch.parallel.mesh import param_split_dims, validate_tp_shardings
from tsasr_torch.utils.precision import cast, f32_or_wider

stats = collections.Counter()


def _all_reduce(x, axis):
    """The sum of ``x`` over ``axis``'s group, a new tensor."""
    t0 = time.perf_counter()
    out = x.contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    stats["all_reduces"] += 1
    stats["bytes"] += out.numel() * out.element_size()
    stats["seconds"] += time.perf_counter() - t0
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.axis), None


class _GatherLeaves(torch.autograd.Function):
    """The whole leaves of a rank's ``shards`` (``names`` and split
    ``dims`` alike), all-gathered over the model ``axis`` in one flat
    buffer and joined in rank order (``convert.gather_tensors``).

    The backward hands each shard the rank's slice of its whole leaf's
    cotangent (``convert.shard_tensor``) and sums nothing over the axis:
    every rank of the axis ran the same whole computation on the same
    rows with the same dropout masks, so each computed the same whole
    cotangent, and the slices of the axis's ranks together are it once."""

    @staticmethod
    def forward(ctx, names, dims, axis, *shards):
        t0 = time.perf_counter()
        ctx.meta = (names, dims, axis)
        flat = torch.cat([s.detach().reshape(-1) for s in shards])
        parts = [torch.split(p, [s.numel() for s in shards])
                 for p in all_gather(flat, axis)]
        stats["gathers"] += 1
        stats["gather_bytes"] += flat.numel() * flat.element_size() * (
            axis.size - 1)
        stats["gather_seconds"] += time.perf_counter() - t0
        return tuple(gather_tensors(name, [p[i].view_as(s) for p in parts],
                                    dim)
                     for i, (name, dim, s) in enumerate(zip(names, dims,
                                                            shards)))

    @staticmethod
    def backward(ctx, *grads):
        names, dims, axis = ctx.meta
        return (None, None, None,
                *(shard_tensor(name, g, dim, axis.index, axis.size)
                  for name, dim, g in zip(names, dims, grads)))


def copy_to_model(x, axis):
    """``x`` as is; its cotangent summed over ``axis`` (a size-1 axis
    is the identity both ways)."""
    return x if axis.size == 1 else _CopyToModel.apply(x, axis)


def reduce_from_model(x, axis):
    """``x`` summed over ``axis``; its cotangent as is."""
    return x if axis.size == 1 else _ReduceFromModel.apply(x, axis)


def reduce_both(x, axis):
    """``x`` summed over ``axis``, and its cotangent too."""
    return x if axis.size == 1 else _ReduceBoth.apply(x, axis)


def row_linear(layer, x, axis):
    """A ``Linear`` (``models.layers``) split by its input columns over
    ``axis`` on the rank's block ``x``: the partial products summed over
    the axis, then the bias, added once."""
    dt = layer.compute_dtype
    return reduce_from_model(F.linear(cast(x, dt), cast(layer.weight, dt)),
                             axis) + cast(layer.bias, dt)


def rank_slice(size, axis):
    """The rank's contiguous block of ``size`` along the model axis."""
    block = size // axis.size
    return slice(axis.index * block, (axis.index + 1) * block)


def tp_layer_norm(x, weight, bias, eps, width, axis, dtype):
    """LayerNorm over a last dim of ``width`` channels of which ``x``
    holds the rank's (``weight`` and ``bias`` its slices): the two
    moments, E[x] and E[x^2], summed over ``axis`` in one all-reduce,
    the variance E[x^2] - E[x]^2 (flax's, clamped at 0), all in f32 (or
    x's wider dtype) and rounded to the compute ``dtype`` once."""
    xf = x.to(f32_or_wider(x))
    moments = reduce_both(torch.stack([xf.sum(-1), (xf * xf).sum(-1)],
                                      dim=-1), axis) / width
    mean = moments[..., :1]
    var = torch.clamp(moments[..., 1:] - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.to(xf.dtype) \
        + bias.to(xf.dtype)
    return cast(y, dtype)


def _tp_modules(model):
    return [(name, m) for name, m in model.named_modules()
            if hasattr(type(m), "TP_SPLIT")]


def _join(prefix, leaf):
    return f"{prefix}.{leaf}" if prefix else leaf


def _in_scope(prefix, scopes):
    return any(prefix == s or prefix.startswith(s + ".") for s in scopes)


def shard_model(model, axis, gathered=()):
    """Split ``model``'s matrices over the model ``axis`` in place: each
    leaf the split rule names (``parallel.mesh.param_split_dims`` of the
    whole model) becomes this rank's shard, each module whose pair is
    split runs split (its ``tp`` set to ``axis``), except the modules
    under a ``gathered`` scope (module name prefixes: the main encoder's
    layers beside a sequence or pipeline axis), which keep their shards
    as storage and run whole on leaves ``gather_layers`` gathers (their
    ``tp_stored``: {leaf: split dim}). Raises where the rule splits a
    leaf no module can run split, or one leaf of a pair only
    (``validate_tp_shardings`` raises first on name drift). Returns
    {name: "split" | "part"} of the leaves a rank holds a shard of or
    reads a slice of (``gradient_shares``): a gathered module's shards
    are "split", and it reads no slice."""
    splits = param_split_dims(dict(model.named_parameters()), axis.size)
    validate_tp_shardings(splits)
    kinds = {}
    for prefix, module in _tp_modules(model):
        names = [_join(prefix, leaf) for leaf in module.TP_SPLIT]
        split = [splits.get(n) is not None for n in names]
        if not any(split):
            continue
        if not all(split):
            raise ValueError(f"{prefix}: the split rule splits "
                             f"{[n for n, s in zip(names, split) if s]} but "
                             f"not the rest of {names}")
        kinds.update({n: "split" for n in names})
        if _in_scope(prefix, gathered):
            module.tp_stored = {leaf: splits[n]
                                for leaf, n in zip(module.TP_SPLIT, names)}
            continue
        check = getattr(module, "check_tensor_parallel", None)
        if check is not None:
            check(axis.size)
        module.tp = axis
        kinds.update({_join(prefix, leaf): "part"
                      for leaf in module.TP_PARTS})
    stray = [n for n, d in splits.items()
             if d is not None and kinds.get(n) != "split"]
    if stray:
        raise ValueError(f"the split rule splits {stray}, which no module "
                         "runs split")
    with torch.no_grad():
        for name, dim in splits.items():
            if dim is None:
                continue
            owner, leaf = _owner(model, name)
            old = getattr(owner, leaf)
            setattr(owner, leaf, nn.Parameter(
                shard_tensor(name, old.detach(), dim, axis.index,
                             axis.size).clone(),
                requires_grad=old.requires_grad))
    model.tp_splits = splits
    return kinds


def _owner(model, name):
    prefix, _, leaf = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), leaf


def module_modes(model):
    """{name: "split" | "gathered" | "whole"} of ``model``'s modules that
    can run split: split over the model axis, whole on gathered leaves,
    or whole on whole leaves."""
    return {prefix: "split" if module.tp is not None
            else "gathered" if getattr(module, "tp_stored", None)
            else "whole"
            for prefix, module in _tp_modules(model)}


def gather_layers(encoder, layers, axis):
    """{i: {leaf name in ``encoder.layers[i]``: its whole tensor}} of the
    layers ``layers`` whose modules hold shards to run whole
    (``shard_model``'s ``gathered`` scope), all gathered over the model
    ``axis`` in one ``_GatherLeaves`` (differentiable: each shard gets
    its slice of the whole gradient); {} where none is stored split."""
    where, names, dims, shards = [], [], [], []
    for i in layers:
        for prefix, module in encoder.layers[i].named_modules():
            for leaf, dim in getattr(module, "tp_stored", {}).items():
                name = _join(prefix, leaf)
                where.append((i, name))
                names.append(name)
                dims.append(dim)
                shards.append(module.get_parameter(leaf))
    if not shards:
        return {}
    out = {}
    for (i, name), whole in zip(where, _GatherLeaves.apply(
            tuple(names), tuple(dims), axis, *shards)):
        out.setdefault(i, {})[name] = whole
    return out


def whole_copy(model, state_dict):
    """A copy of the sharded ``model`` with every module whole again,
    holding the whole ``state_dict`` (``convert.gather_state_dicts``):
    the evaluation model of a tensor-parallel run."""
    axes = {id(m.tp): m.tp for _, m in _tp_modules(model)
            if m.tp is not None}
    clone = copy.deepcopy(model, memo=dict(axes))
    for _, module in _tp_modules(clone):
        module.tp = None
        module.__dict__.pop("tp_stored", None)
    with torch.no_grad():
        for name, dim in getattr(model, "tp_splits", {}).items():
            if dim is not None:
                owner, leaf = _owner(clone, name)
                old = getattr(owner, leaf)
                setattr(owner, leaf, nn.Parameter(
                    torch.empty_like(state_dict[name], device=old.device),
                    requires_grad=old.requires_grad))
    if hasattr(clone, "tp_splits"):
        del clone.tp_splits
    clone.load_state_dict(state_dict)
    return clone


def gather_leaf(name, t, dim, axis):
    """The whole leaf ``name`` from a rank's shard ``t`` along ``dim``:
    all-gathered over the model ``axis`` and joined by
    ``convert.gather_tensors``, on every rank of the axis."""
    return gather_tensors(name, all_gather(t.detach().contiguous(), axis),
                          dim)


def gather_whole(tensors, splits, axis):
    """{name: whole tensor} of a rank's ``tensors`` ({name: its shard or
    whole leaf}) with ``splits`` ({name: dim or None}), on every rank of
    the model ``axis``. Every rank of the axis enters it with the same
    names in the same order."""
    return {name: t if splits.get(name) is None
            else gather_leaf(name, t, splits[name], axis)
            for name, t in tensors.items()}
