"""Warm-start parameter transfer (distinct from resume).

Counterpart of the JAX package's ``utils/parameter_transfer.py``
(``Pretrainer``): collect parameter files into the experiment's save
folder, then load them into live objects. The recipe transfers only when
``model_path`` is set.

A parameter file here is one of the port's own: a checkpoint's
``brain.ckpt`` (its ``model`` entry), or a ``torch.save`` of a
``state_dict``. ``load_state_dict_into`` transfers the entries whose
name and shape match the module's and logs the rest, as flax's
``from_state_dict`` of a partial tree transfers what it can.

One difference from the JAX package: its recipe collects the file and
never loads it (``brain._pretrainer`` is set and read nowhere, and
``load_collected`` / ``load_pytree_into`` are never called), so a set
``model_path`` is ignored there. The port's recipe loads the collected
weights into the model after the Brain is built and before ``fit``; a
checkpoint that recovery then finds in the save folder takes precedence.
"""

import logging
import os
import shutil

import torch

logger = logging.getLogger(__name__)


class Pretrainer:
    """``paths`` maps a name to its source file or directory."""

    def __init__(self, collect_in="./model_checkpoints", paths=None):
        self.collect_in = collect_in
        self.paths = paths or {}
        self.collected = {}

    def collect_files(self):
        """Link (or, where linking fails, copy) each source into
        ``collect_in`` as ``<name>.ckpt``; a directory source resolves to
        its ``<name>.ckpt``."""
        os.makedirs(self.collect_in, exist_ok=True)
        for name, source in self.paths.items():
            if source is None:
                continue
            target = os.path.join(self.collect_in, f"{name}.ckpt")
            if os.path.isdir(source):
                candidate = os.path.join(source, f"{name}.ckpt")
                if os.path.isfile(candidate):
                    source = candidate
                else:
                    raise FileNotFoundError(
                        f"No {name}.ckpt inside directory {source}")
            if not os.path.isfile(source):
                raise FileNotFoundError(
                    f"Pretrained source not found: {source} (in offline "
                    f"environments HF hub fetching is unavailable)")
            if os.path.abspath(source) != os.path.abspath(target):
                try:
                    if os.path.lexists(target):
                        os.remove(target)
                    os.symlink(os.path.abspath(source), target)
                except OSError:
                    shutil.copy(source, target)
            self.collected[name] = target
        return self.collected

    def load_collected(self, modules):
        """Load each collected file into ``modules[name]``, a module."""
        for name in self.collected:
            if name in modules:
                self.load_state_dict_into(name, modules[name])

    def load_state_dict_into(self, name, module):
        """Load the collected file ``name`` into ``module`` in place: the
        entries whose name and shape match; the others, and the module's
        entries the file lacks, are logged. Returns the names loaded."""
        state = torch.load(self.collected[name], map_location="cpu",
                           weights_only=True)
        if isinstance(state, dict) and isinstance(state.get("model"), dict):
            state = state["model"]          # a checkpoint's brain.ckpt
        own = module.state_dict()
        taken = {k: v for k, v in state.items()
                 if k in own and tuple(v.shape) == tuple(own[k].shape)}
        skipped = sorted(set(state) - set(taken))
        missing = sorted(set(own) - set(taken))
        if not taken:
            raise ValueError(f"{self.collected[name]} holds no entry of "
                             f"{type(module).__name__}'s state_dict")
        with torch.no_grad():
            for key, value in taken.items():
                own[key].copy_(value)
        if skipped:
            logger.info("Warm start %s: %d entries without a match of name "
                        "and shape left out: %s", name, len(skipped),
                        ", ".join(skipped))
        if missing:
            logger.info("Warm start %s: %d entries of the model not in the "
                        "file keep their values: %s", name, len(missing),
                        ", ".join(missing))
        logger.info("Warm-started %s from %s (%d entries)", name,
                    self.collected[name], len(taken))
        return sorted(taken)
