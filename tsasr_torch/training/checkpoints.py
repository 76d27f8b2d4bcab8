"""Named-recoverable checkpointing with keep-N-best retention.

The port of the JAX package's ``training/checkpoints.py`` (after the
reference ``Checkpointer``,
``vendor/speechbrain/speechbrain/utils/checkpoints.py:405-1201``), with
the same directory layout and selection rules:

1. a registry of *named recoverables*, each saved/loaded through a hook;
2. checkpoint = directory ``CKPT+<timestamp>`` with one file per
   recoverable + ``CKPT.yaml`` (unixtime + custom keys, e.g. WER);
3. retention keyed on metrics: ``save_and_keep_only(min_keys=["WER"],
   num_to_keep=10)``;
4. ``recover_if_possible(min_key/max_key)`` picks newest / best;
5. ``end_of_epoch`` flag threaded to loaders so mid-epoch resume works.

Recoverable protocol (duck-typed, checked in this order):
- ``obj.save(path)`` + ``obj.load(path, end_of_epoch)``; or
- ``obj.save_position()`` + ``obj.load_position(state, end_of_epoch)``
  (loaders); or
- a state dict of tensors behind a getter + setter pair, wrapped in
  ``PytreeRecoverable`` (``torch.save``, and ``torch.load`` with
  ``weights_only=True``).

In a launched run (``parallel/distributed.py``) every process enters
``save_checkpoint``, ``delete_checkpoints`` and the recovery, as in the
JAX package: the checkpoint's name is process 0's timestamp, broadcast
to all; only process 0 writes and deletes files, and a barrier after
each ends it, so no process lists or recovers a half-written directory.
Every process holds the same state (the weights and the optimizer's, by
the all-reduced gradients), so process 0's is the checkpoint; a
recoverable whose state is split over the ranks (a tensor-parallel
Brain's) has ``prepare_save()``, which every process enters before
process 0 writes, to gather it.
"""

import json
import os
import shutil
import time

import numpy as np
import torch
import yaml

from tsasr_torch.parallel.distributed import (
    broadcast_object,
    ddp_barrier,
    if_main_process,
)

CKPT_PREFIX = "CKPT"
META_FILE = "CKPT.yaml"


def save_state(state, path):
    """``torch.save`` of a state dict, tensors moved to the CPU."""
    torch.save(_to_cpu(state), path)


def load_state(path):
    """A state dict written by ``save_state``, on the CPU; nothing but
    tensors and plain containers is unpickled."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _to_cpu(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_cpu(v) for v in value)
    return value


class PytreeRecoverable:
    """Adapter making a get/set state-dict pair checkpointable."""

    def __init__(self, getter, setter):
        self.getter = getter
        self.setter = setter

    def save(self, path):
        save_state(self.getter(), path)

    def load(self, path, end_of_epoch=True):
        self.setter(load_state(path))


class Checkpoint:
    """Handle to one on-disk checkpoint directory."""

    def __init__(self, path):
        self.path = path
        meta_path = os.path.join(path, META_FILE)
        with open(meta_path, encoding="utf-8") as f:
            self.meta = yaml.safe_load(f)

    @property
    def unixtime(self):
        return self.meta.get("unixtime", 0.0)

    def paramfile(self, name):
        return os.path.join(self.path, f"{name}.ckpt")

    def __repr__(self):
        return f"Checkpoint({self.path})"


class Checkpointer:
    """Registry + save/load/retention orchestration."""

    def __init__(self, checkpoints_dir, recoverables=None,
                 allow_partial_load=False):
        self.checkpoints_dir = str(checkpoints_dir)
        self.recoverables = {}
        self.allow_partial_load = allow_partial_load
        for name, obj in (recoverables or {}).items():
            self.add_recoverable(name, obj)

    def add_recoverable(self, name, obj):
        if not (hasattr(obj, "save") or hasattr(obj, "save_position")):
            raise TypeError(
                f"Recoverable '{name}' has neither save() nor "
                f"save_position(); wrap state dicts in PytreeRecoverable")
        self.recoverables[name] = obj

    # --------------------------------------------------------------- save
    def save_checkpoint(self, meta=None, name=None, end_of_epoch=True):
        """Save all recoverables into a new checkpoint dir; returns it.
        Every process enters; process 0 names and writes it."""
        if name is None:
            stamp = f"{broadcast_object(time.time()):.4f}".replace(".", "+")
            name = f"{CKPT_PREFIX}+{stamp}"
        path = os.path.join(self.checkpoints_dir, name)
        for obj in self.recoverables.values():
            if hasattr(obj, "prepare_save"):     # a collective: all enter
                obj.prepare_save()
        if if_main_process():
            self._write(path, meta, end_of_epoch)
        ddp_barrier()
        return Checkpoint(path)

    def _write(self, path, meta, end_of_epoch):
        os.makedirs(path, exist_ok=True)
        for rec_name, obj in self.recoverables.items():
            target = os.path.join(path, f"{rec_name}.ckpt")
            if hasattr(obj, "save"):
                obj.save(target)
            else:
                with open(target, "w", encoding="utf-8") as f:
                    json.dump(obj.save_position(), f)
        full_meta = {"unixtime": time.time(),
                     "end-of-epoch": bool(end_of_epoch)}
        full_meta.update(meta or {})
        with open(os.path.join(path, META_FILE), "w",
                  encoding="utf-8") as f:
            yaml.safe_dump(_plain(full_meta), f)

    def save_and_keep_only(self, meta=None, name=None, num_to_keep=1,
                           min_keys=None, max_keys=None,
                           keep_recent=False, end_of_epoch=True,
                           importance_key=None, ckpt_predicate=None):
        """Save, then delete all but the N best checkpoints per key.

        ``ckpt_predicate`` restricts which checkpoints are *candidates for
        deletion* (reference ``utils/checkpoints.py:892``): checkpoints it
        rejects are never deleted — e.g. intra-epoch saves pass
        ``lambda c: c.meta.get("unfinished_epoch")`` so end-of-epoch
        keep-N-best checkpoints survive.
        """
        ckpt = self.save_checkpoint(meta=meta, name=name,
                                    end_of_epoch=end_of_epoch)
        self.delete_checkpoints(num_to_keep=num_to_keep,
                                min_keys=min_keys, max_keys=max_keys,
                                keep_recent=keep_recent,
                                importance_key=importance_key,
                                ckpt_predicate=ckpt_predicate)
        return ckpt

    # --------------------------------------------------------------- find
    def list_checkpoints(self):
        if not os.path.isdir(self.checkpoints_dir):
            return []
        out = []
        for entry in sorted(os.listdir(self.checkpoints_dir)):
            path = os.path.join(self.checkpoints_dir, entry)
            if entry.startswith(CKPT_PREFIX) and \
                    os.path.isfile(os.path.join(path, META_FILE)):
                out.append(Checkpoint(path))
        return out

    def find_checkpoint(self, min_key=None, max_key=None,
                        importance_key=None):
        ckpts = self.list_checkpoints()
        if not ckpts:
            return None
        key_fn = _importance_fn(min_key, max_key, importance_key)
        return max(ckpts, key=key_fn)

    def find_checkpoints(self, min_key=None, max_key=None,
                         importance_key=None, max_num_checkpoints=None):
        ckpts = self.list_checkpoints()
        key_fn = _importance_fn(min_key, max_key, importance_key)
        ckpts.sort(key=key_fn, reverse=True)
        if max_num_checkpoints is not None:
            ckpts = ckpts[:max_num_checkpoints]
        return ckpts

    # --------------------------------------------------------------- load
    def load_checkpoint(self, checkpoint):
        end_of_epoch = checkpoint.meta.get("end-of-epoch", True)
        for name, obj in self.recoverables.items():
            source = checkpoint.paramfile(name)
            if not os.path.isfile(source):
                if self.allow_partial_load:
                    continue
                raise FileNotFoundError(
                    f"Checkpoint {checkpoint.path} is missing recoverable "
                    f"'{name}'")
            if hasattr(obj, "load"):
                obj.load(source, end_of_epoch=end_of_epoch)
            else:
                with open(source, encoding="utf-8") as f:
                    obj.load_position(json.load(f),
                                      end_of_epoch=end_of_epoch)
        return checkpoint

    def recover_if_possible(self, min_key=None, max_key=None,
                            importance_key=None):
        ckpt = self.find_checkpoint(min_key, max_key, importance_key)
        if ckpt is not None:
            self.load_checkpoint(ckpt)
        return ckpt

    # ------------------------------------------------------------- delete
    def delete_checkpoints(self, num_to_keep=1, min_keys=None,
                           max_keys=None, keep_recent=False,
                           importance_key=None, ckpt_predicate=None):
        """Keep the N best per key (plus optionally the N most recent).

        Only checkpoints accepted by ``ckpt_predicate`` (default: all) are
        candidates for deletion or ranking; the rest are untouchable.
        Every process enters; process 0 deletes.
        """
        if if_main_process():
            self._delete(num_to_keep, min_keys, max_keys, keep_recent,
                         importance_key, ckpt_predicate)
        ddp_barrier()

    def _delete(self, num_to_keep, min_keys, max_keys, keep_recent,
                importance_key, ckpt_predicate):
        ckpts = self.list_checkpoints()
        if ckpt_predicate is not None:
            ckpts = [c for c in ckpts if ckpt_predicate(c)]
        protected = set()
        key_fns = []
        if importance_key is not None:
            key_fns.append(importance_key)
        if keep_recent or not (min_keys or max_keys or importance_key):
            key_fns.append(_importance_fn(None, None, None))
        for key in (min_keys or []):
            key_fns.append(_importance_fn(key, None, None))
        for key in (max_keys or []):
            key_fns.append(_importance_fn(None, key, None))
        for key_fn in key_fns:
            ranked = sorted(ckpts, key=key_fn, reverse=True)
            protected.update(c.path for c in ranked[:num_to_keep])
        for ckpt in ckpts:
            if ckpt.path not in protected:
                shutil.rmtree(ckpt.path, ignore_errors=True)


def _importance_fn(min_key, max_key, importance_key):
    if importance_key is not None:
        return importance_key
    if min_key is not None:
        return lambda c: (-c.meta.get(min_key, float("inf")), c.unixtime)
    if max_key is not None:
        return lambda c: (c.meta.get(max_key, float("-inf")), c.unixtime)
    return lambda c: c.unixtime


def _plain(obj):
    """Convert numpy and torch scalars to plain Python for YAML."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (np.generic,)):
        return obj.item()
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    return obj


def average_checkpoints(checkpoints, name):
    """Average a recoverable's state dict across checkpoints (weight
    averaging; the reference's ``average_checkpoints``). Floating
    tensors are averaged; every other entry is taken from the first
    checkpoint."""
    loaded = [load_state(ckpt.paramfile(name)) for ckpt in checkpoints]

    def mean(*values):
        first = values[0]
        if isinstance(first, dict):
            return {k: mean(*(v[k] for v in values)) for k in first}
        if isinstance(first, torch.Tensor) and first.is_floating_point():
            return sum(values) / len(values)
        return first

    return mean(*loaded)
