"""Dynamic-item data pipeline: ``@takes`` / ``@provides`` + topological

The port's own copy of the JAX package's ``data/pipeline.py``, line for
line, with its imports pointed at ``tsasr_torch``.
evaluation.

Functional equivalent of the reference's pipeline system
(``vendor/speechbrain/speechbrain/utils/data_pipeline.py:198-521`` and the
DAG in ``utils/depgraph.py``): dynamic items declare what raw/derived keys
they consume and what they provide; evaluation resolves dependencies
lazily in topological order, supports generator-style multi-output items,
and only computes what the requested output keys need.

The implementation here is a fresh, compact design: a keyed DAG with
memoised depth-first evaluation (the reference builds an explicit
DependencyGraph class; we resolve on the fly with cycle detection).
"""

import inspect
from dataclasses import dataclass, field
from typing import Callable, Sequence


@dataclass
class DynamicItem:
    """A function from ``takes`` keys to one or more ``provides`` keys."""

    func: Callable
    takes: Sequence[str] = field(default_factory=tuple)
    provides: Sequence[str] = field(default_factory=tuple)

    @property
    def is_generator(self):
        return inspect.isgeneratorfunction(self.func)


def takes(*keys):
    """Decorator declaring the argument keys of a dynamic item."""

    def decorator(obj):
        if isinstance(obj, DynamicItem):
            obj.takes = tuple(keys)
            return obj
        return DynamicItem(func=obj, takes=tuple(keys))

    return decorator


def provides(*keys):
    """Decorator declaring the output keys of a dynamic item.

    With several keys the function may either return a tuple or be a
    generator yielding one output per key (the reference's generator
    convention, ``utils/data_pipeline.py:240-292``).
    """

    def decorator(obj):
        if isinstance(obj, DynamicItem):
            obj.provides = tuple(keys)
            return obj
        return DynamicItem(func=obj, provides=tuple(keys))

    return decorator


class DataPipeline:
    """Computes requested output keys from raw data + dynamic items."""

    def __init__(self, static_keys=(), dynamic_items=()):
        self.static_keys = list(static_keys)
        self._providers = {}          # key -> DynamicItem
        self._items = []
        self.output_keys = list(static_keys)
        for item in dynamic_items:
            self.add_dynamic_item(item)

    def add_dynamic_item(self, func, takes=None, provides=None):
        """Register a dynamic item (decorated or bare function + keys)."""
        if isinstance(func, DynamicItem):
            item = func
            if takes:
                item.takes = tuple(takes) if not isinstance(takes, str) \
                    else (takes,)
            if provides:
                item.provides = tuple(provides) \
                    if not isinstance(provides, str) else (provides,)
        else:
            if isinstance(takes, str):
                takes = (takes,)
            if isinstance(provides, str):
                provides = (provides,)
            item = DynamicItem(func=func, takes=tuple(takes or ()),
                               provides=tuple(provides or ()))
        if not item.provides:
            raise ValueError("Dynamic item must provide at least one key")
        for key in item.provides:
            if key in self._providers:
                raise ValueError(f"Duplicate provider for key: {key}")
            self._providers[key] = item
        self._items.append(item)

    def set_output_keys(self, keys):
        self.output_keys = list(keys)

    def compute_outputs(self, raw_data):
        """Evaluate the requested output keys for one example."""
        cache = dict(raw_data)
        in_progress = set()

        def resolve(key):
            if key in cache:
                return cache[key]
            if key not in self._providers:
                raise KeyError(
                    f"Key '{key}' is neither raw data nor provided by a "
                    f"dynamic item (raw keys: {sorted(raw_data)[:8]}...)")
            if key in in_progress:
                raise RuntimeError(f"Circular dependency at key '{key}'")
            item = self._providers[key]
            in_progress.update(item.provides)
            args = [resolve(k) for k in item.takes]
            if item.is_generator:
                values = list(item.func(*args))
                if len(values) != len(item.provides):
                    raise RuntimeError(
                        f"Generator item yielded {len(values)} values for "
                        f"{len(item.provides)} provided keys")
            elif len(item.provides) == 1:
                values = [item.func(*args)]
            else:
                values = list(item.func(*args))
            for k, v in zip(item.provides, values):
                cache[k] = v
            in_progress.difference_update(item.provides)
            return cache[key]

        return {key: resolve(key) for key in self.output_keys}

    def __call__(self, raw_data):
        return self.compute_outputs(raw_data)
