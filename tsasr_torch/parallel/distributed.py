"""Process-group helpers over ``torch.distributed``.

The port of the JAX package's ``parallel/distributed.py``. JAX runs one
process per host, joined by ``jax.distributed.initialize``; the port
runs one process per device (PyTorch's idiom), joined by
``init_process_group`` from the ``env://`` variables that
``python -m tsasr_torch.parallel.launch`` (or ``torchrun``) sets:
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``. Without them every helper is the one-process identity.

The device names the backend, and nothing falls back:

- ``cpu``: gloo;
- ``cuda``: ``cuda:{LOCAL_RANK}`` with NCCL; a rank whose local rank has
  no card raises (ranks are never wrapped onto a shared card);
- ``cuda:N``, given to every rank: the ranks share card N over gloo
  (NCCL refuses two ranks on one device; gloo all-reduces CUDA tensors
  through the host).

Process 0 is the main process: it writes the experiment's files
(``run_on_main``, then a barrier); ``all_gather_object`` merges the
ranks' evaluation results and ``broadcast_object`` hands process 0's
decisions (a checkpoint's name, the intra-epoch save by minutes) to all.

The ranks' layout over the mesh's axes (``Layout``, made by
``init_layout`` from the data, pipeline, sequence and tensor (model)
counts): each rank knows its coordinate on each axis
(``parallel.mesh.rank_coords``) and holds a process group for each axis
of size above 1, the data axis's when another axis is above 1 too (the
world otherwise). Every rank creates every group, in one order, as
``new_group`` requires.
"""

import logging
import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from tsasr_torch.parallel.mesh import axis_ranks, rank_coords

logger = logging.getLogger(__name__)

ENV_KEYS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_distributed():
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if is_distributed() else 0


def world_size():
    return dist.get_world_size() if is_distributed() else 1


def local_rank():
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def rank_device(device):
    """The torch device this rank runs on for ``device``: a bare ``cuda``
    in a launched run is ``cuda:{LOCAL_RANK}``, which must exist; any
    other device is itself."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or \
            "WORLD_SIZE" not in os.environ:
        return device
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = local_rank()
    if index >= n:
        raise RuntimeError(
            f"rank with LOCAL_RANK {index} asks for cuda:{index}, but this "
            f"host has {n} CUDA device(s); launch at most {n} ranks per "
            "node, or give every rank --device cuda:N to share card N "
            "over gloo")
    return torch.device("cuda", index)


def backend_for(device):
    """(backend, this rank's device) for ``device``: gloo on the CPU and
    for ranks that share a named card, NCCL for ``cuda``."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {str(device)!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} was asked for but CUDA "
                           "is not available; pass --device cpu to run the "
                           "ranks on the CPU")
    if device.index is not None:
        return "gloo", device
    return "nccl", rank_device(device)


def maybe_init_distributed(device="cuda"):
    """Join the process group the launcher announced, before anything
    touches a device; the backend follows ``device`` (``backend_for``).
    Does nothing without ``WORLD_SIZE`` in the environment or once
    joined. Returns whether this process is in a group. A rank that
    cannot join raises."""
    if is_distributed():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError(f"a launched run needs {missing} in its "
                           "environment (python -m "
                           "tsasr_torch.parallel.launch sets them)")
    backend, here = backend_for(device)
    if here.type == "cuda":
        torch.cuda.set_device(here)
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    logger.info("distributed: rank %d of %d on %s over %s", rank(),
                world_size(), here, backend)
    return True


def describe():
    """This process's place: its rank, the world size and the backend,
    and its coordinates when a model axis is above 1."""
    if not is_distributed():
        return "one process"
    place = f"rank {rank()} of {world_size()} over {dist.get_backend()}"
    here = layout()
    if here.model_ranks > 1:
        place += (f", data {here.data.index} of {here.dp}, pipe "
                  f"{here.pipe.index} of {here.pp}, seq {here.seq.index} "
                  f"of {here.sp}")
        if here.tp > 1:
            place += f", model {here.model.index} of {here.tp}"
    return place


def if_main_process():
    return rank() == 0


def run_on_main(func, args=None, kwargs=None, post_func=None,
                post_args=None, post_kwargs=None):
    """Run ``func`` on process 0, wait at a barrier, then run
    ``post_func`` on the other processes."""
    if if_main_process():
        func(*(args or ()), **(kwargs or {}))
    ddp_barrier()
    if not if_main_process() and post_func is not None:
        post_func(*(post_args or ()), **(post_kwargs or {}))


def ddp_barrier():
    """Wait for every process (nothing to wait for in one)."""
    if world_size() > 1:
        dist.barrier()


def all_gather_object(obj):
    """Every process's picklable ``obj``, in rank order."""
    if world_size() <= 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj, src=0):
    """Process ``src``'s picklable ``obj`` on every process."""
    if world_size() <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_reduce_sum(tensor, group=None):
    """Sum ``tensor`` over the processes of ``group`` (the world when
    None), in place; in a group of one the collective still runs (the
    identity)."""
    if is_distributed():
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: ``size``, this rank's
    ``index`` on it, the world ``ranks`` of its group in index order and
    the group (None: the world, or no collective at size 1)."""
    name: str
    size: int
    index: int
    ranks: tuple
    group: object = field(default=None, compare=False)

    def all_reduce_sum(self, tensor):
        """Sum ``tensor`` over the axis's group, in place (nothing to sum
        at size 1)."""
        if self.size > 1:
            all_reduce_sum(tensor, self.group)
        return tensor

    def neighbour(self, step):
        """The world rank ``step`` places along the axis, or None past
        either end."""
        i = self.index + step
        return self.ranks[i] if 0 <= i < self.size else None


@dataclass(frozen=True)
class Layout:
    """This rank's place on a (data, pipe, seq, model) mesh of
    ``dp·pp·sp·tp`` ranks: ``data``, ``pipe``, ``seq`` and ``model`` are
    its ``Axis`` on each."""
    dp: int
    pp: int
    sp: int
    data: Axis
    pipe: Axis
    seq: Axis
    tp: int = 1
    model: Axis = None

    @property
    def model_ranks(self):
        """Ranks of one data shard: they hold the same rows."""
        return self.pp * self.sp * self.tp

    @property
    def encoder_axis(self):
        """The axis the encoder is split over in TRAIN, as the JAX
        ``encode_predict`` routes it (``'seq'`` first, then ``'pipe'``),
        or None. A model axis beside it is live too: the encoder's layers
        run whole on leaves gathered over it, every other split module
        split (``parallel.tensor_parallel``)."""
        if self.sp > 1:
            return self.seq
        if self.pp > 1:
            return self.pipe
        return None


_LAYOUT = None
AXIS_NAMES = ("data", "pipe", "seq", "model")


def _axis_groups(name, counts, here):
    """Every group of axis ``name`` of a mesh of ``counts`` (dp, pp, sp,
    tp), each created on every rank in the same order; returns this
    rank's."""
    mine, made = None, set()
    for r in range(int(np.prod(counts))):
        ranks = tuple(axis_ranks(r, name, *counts))
        if ranks in made:
            continue
        made.add(ranks)
        group = dist.new_group(list(ranks))
        if here in ranks:
            mine = group
    return mine


def init_layout(dp, pp=1, sp=1, tp=1):
    """Make (and keep, for ``layout()``) this rank's ``Layout`` of a
    ``dp·pp·sp·tp``-rank run; a launched run creates its axes' groups
    here, on every rank alike. Raises unless the counts multiply to the
    world size."""
    global _LAYOUT
    n = world_size()
    counts = (dp, pp, sp, tp)
    if dp * pp * sp * tp != n:
        raise ValueError(f"data {dp} x pipe {pp} x seq {sp} x model {tp} "
                         f"ranks are not the world's {n}")
    here = rank()
    coords = rank_coords(here, *counts)
    axes = {}
    for name, size in zip(AXIS_NAMES, counts):
        group = None
        if size > 1 and is_distributed() and (name != "data"
                                              or pp * sp * tp > 1):
            group = _axis_groups(name, counts, here)
        axes[name] = Axis(name, size, coords[name],
                          tuple(axis_ranks(here, name, *counts)), group)
    _LAYOUT = Layout(dp, pp, sp, axes["data"], axes["pipe"], axes["seq"],
                     tp, axes["model"])
    return _LAYOUT


def layout():
    """The run's ``Layout``: the one ``init_layout`` made, else every
    rank on the data axis."""
    if _LAYOUT is not None and _LAYOUT.dp * _LAYOUT.model_ranks == \
            world_size():
        return _LAYOUT
    n, here = world_size(), rank()
    return Layout(n, 1, 1, Axis("data", n, here, tuple(range(n))),
                  Axis("pipe", 1, 0, (here,)), Axis("seq", 1, 0, (here,)),
                  1, Axis("model", 1, 0, (here,)))


def broadcast_module(module, src=0, group=None):
    """Give every process of ``group`` (the world when None)
    ``module``'s parameters and buffers as world rank ``src`` holds
    them: one broadcast of a flat buffer per dtype."""
    if world_size() <= 1 or (group is not None
                             and dist.get_world_size(group) <= 1):
        return
    groups = {}
    for t in module.state_dict(keep_vars=True).values():
        if torch.is_tensor(t) and t.numel():
            groups.setdefault(t.dtype, []).append(t)
    for dtype in sorted(groups, key=str):
        flat = torch.cat([t.detach().reshape(-1) for t in groups[dtype]])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        with torch.no_grad():
            for t in groups[dtype]:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
