"""Activation blocks between the ranks of a sequence or pipeline axis.

The port's counterpart of what the JAX package's ``ppermute`` and
``psum`` do inside its ``shard_map``s (``parallel/seq_parallel.py:65-71``,
``pp_parallel.py:247,284-290``), over ``torch.distributed``:

- ``send`` / ``recv``: one block to or from a neighbour rank;
- ``NeighbourHop``: the autograd function of the sequence axis's halo,
  rank i's block to rank i + 1 of the axis (rank 0 receives zeros);
  its backward sends the cotangent the reverse way, as ``ppermute``
  transposes;
- ``all_gather``: every rank's tensor of the axis, on every rank;
- ``GatherBlocks``: the axis's blocks joined along a dimension on every
  rank; the backward hands each rank its own block's cotangent once;
- ``BroadcastFrom``: one rank's tensor on every rank of the axis; the
  backward keeps the source's cotangent and gives the others none.

The pipeline's stages hop their blocks with ``send`` / ``recv`` inside
their own autograd function (``parallel.pp_parallel``), whose backward
runs the schedule in reverse.

The transport follows the backend. NCCL moves CUDA tensors on the
device. Gloo's ``send`` / ``recv`` take CPU tensors only, so a CUDA
tensor between ranks that share a card over gloo is staged through a
pinned host buffer, explicitly, and so are the gathers and broadcasts
there; on the CPU nothing is staged. The compute stays where the
tensor is, and a transport that fails raises. ``stats`` counts the bytes
this rank sent and the host seconds its hops took (copies and waits
included), for the readings of ``chip_smoke.py``.
"""

import collections
import time

import torch
import torch.distributed as dist

stats = collections.Counter()


def reset_stats():
    stats.clear()


def _staged(tensor, group=None):
    """Whether ``tensor`` crosses through the host: a CUDA tensor on a
    gloo group."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(tensor):
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor, non_blocking=True)
    torch.cuda.current_stream(tensor.device).synchronize()
    return host


def _timed(fn):
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            stats["seconds"] += time.perf_counter() - t0
    return wrapped


class Sent:
    """An asynchronous send; ``wait()`` before the buffer may change."""

    def __init__(self, work, buffer):
        self.work, self.buffer = work, buffer

    def wait(self):
        self.work.wait()


def _send(tensor, dst):
    tensor = tensor.detach().contiguous()
    buffer = _to_host(tensor) if _staged(tensor) else tensor
    stats["bytes"] += tensor.numel() * tensor.element_size()
    stats["sends"] += 1
    return Sent(dist.isend(buffer, dst), buffer)


def _recv(shape, dtype, device, src):
    device = torch.device(device)
    staged = device.type == "cuda" and dist.get_backend() == "gloo"
    buffer = torch.empty(shape, dtype=dtype, pin_memory=staged,
                         device="cpu" if staged else device)
    dist.recv(buffer, src)
    return buffer.to(device, non_blocking=True) if staged else buffer


@_timed
def send(tensor, dst):
    """Start sending ``tensor`` to world rank ``dst``; returns a
    ``Sent``."""
    return _send(tensor, dst)


@_timed
def recv(shape, dtype, device, src):
    """A tensor of ``shape`` and ``dtype`` on ``device`` from world rank
    ``src``."""
    return _recv(shape, dtype, device, src)


@_timed
def exchange(tensor, dst, src):
    """Send ``tensor`` to ``dst`` (None: to nobody) and receive a tensor
    of its shape from ``src`` (None: zeros), both at once."""
    sent = _send(tensor, dst) if dst is not None else None
    got = _recv(tensor.shape, tensor.dtype, tensor.device, src) \
        if src is not None else torch.zeros_like(tensor)
    if sent is not None:
        sent.wait()
    return got


class NeighbourHop(torch.autograd.Function):
    """``x`` goes to the next rank of the axis (``dst``), and what the
    previous one (``src``) sent comes back, zeros where ``src`` is None.
    The backward sends the received block's cotangent to ``src`` and
    takes ``x``'s from ``dst``. Every rank of the axis calls it the same
    number of times in one order, so the backward's hops meet too."""

    @staticmethod
    def forward(ctx, x, src, dst):
        ctx.src, ctx.dst = src, dst
        return exchange(x, dst, src)

    @staticmethod
    def backward(ctx, grad):
        return exchange(grad.contiguous(), ctx.src, ctx.dst), None, None


def all_gather(x, axis):
    """The ``axis``' tensors ``x`` (one shape on every rank), in index
    order, on every rank; staged through the host for a CUDA tensor over
    gloo."""
    if _staged(x, axis.group):
        parts = [torch.empty(x.shape, dtype=x.dtype) for _ in axis.ranks]
        dist.all_gather(parts, _to_host(x), group=axis.group)
        return [p.to(x.device, non_blocking=True) for p in parts]
    parts = [torch.empty_like(x) for _ in axis.ranks]
    dist.all_gather(parts, x, group=axis.group)
    return parts


class GatherBlocks(torch.autograd.Function):
    """The ``axis``' blocks ``x`` joined along ``dim`` in index order, on
    every rank; the backward returns this rank's block of the
    cotangent."""

    @staticmethod
    @_timed
    def forward(ctx, x, axis, dim):
        ctx.index, ctx.dim, ctx.length = axis.index, dim, x.shape[dim]
        x = x.contiguous()
        stats["bytes"] += x.numel() * x.element_size() * (axis.size - 1)
        return torch.cat(all_gather(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        own = grad.narrow(ctx.dim, ctx.index * ctx.length, ctx.length)
        return own.contiguous(), None, None


class BroadcastFrom(torch.autograd.Function):
    """World rank ``src``'s ``x`` on every rank of ``axis``; the others
    pass any tensor as ``x`` (its autograd history is what their
    backward reaches) and give the ``shape`` and ``dtype`` to receive.
    The backward returns the cotangent on ``src`` and zeros of ``x``'s
    shape elsewhere: every rank's loss is the same, so the cotangent
    counts once."""

    @staticmethod
    @_timed
    def forward(ctx, x, axis, src, shape, dtype):
        ctx.source = axis.ranks[axis.index] == src
        ctx.like = (x.shape, x.dtype, x.device)
        if ctx.source:
            out = x.detach().contiguous()
            stats["bytes"] += out.numel() * out.element_size() * (
                axis.size - 1)
        else:
            out = torch.empty(shape, dtype=dtype, device=x.device)
        if _staged(out, axis.group):
            host = _to_host(out) if ctx.source else \
                torch.empty(shape, dtype=dtype, pin_memory=True)
            dist.broadcast(host, src, group=axis.group)
            if not ctx.source:
                out = host.to(x.device, non_blocking=True)
        else:
            dist.broadcast(out, src, group=axis.group)
        return out.clone() if ctx.source else out

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.like
        own = grad if ctx.source else torch.zeros(shape, dtype=dtype,
                                                  device=device)
        return own, None, None, None, None
