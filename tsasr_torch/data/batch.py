"""Batch collation: right-padding with relative lengths.

The port's own copy of the JAX package's ``data/batch.py`` (numpy only):
``PaddedBatch`` bundles per-key right-padded arrays with relative lengths
in (0, 1], gives attribute access by key and keeps the examples' order;
``pad_to_multiple`` rounds a padded length up to a multiple.
"""

from collections import namedtuple

import numpy as np

PaddedData = namedtuple("PaddedData", ["data", "lengths"])


def _round_up(n, multiple):
    if multiple is None or multiple <= 1:
        return n
    return -(-n // multiple) * multiple


def batch_pad_right(arrays, pad_to=None, value=0.0):
    """Right-pad a list of numpy arrays along axis 0 to a common length.

    Returns (stacked (B, L, ...), relative lengths (B,) float32 in (0,1]).
    """
    lengths = np.asarray([a.shape[0] for a in arrays], np.int64)
    target = max(int(lengths.max()), 1)
    if pad_to is not None:
        target = max(target, 1)
        target = _round_up(target, pad_to)
    rest = arrays[0].shape[1:]
    out = np.full((len(arrays), target) + rest, value,
                  dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    rel = (lengths / target).astype(np.float32)
    return out, rel


class PaddedBatch:
    """Collates example dicts: array values get padded + relative lengths;
    non-array values are collected into lists.

    Attribute access: ``batch.mixed_sig`` -> ``PaddedData(data, lengths)``
    for padded keys, plain list otherwise. Iteration yields per-key
    values in example order.
    """

    def __init__(self, examples, pad_to_multiple=None, padded_keys=None,
                 pad_values=None):
        if not examples:
            raise ValueError("Empty batch")
        self.__keys = list(examples[0].keys())
        self.__padded_keys = []
        pad_to_multiple = pad_to_multiple or {}
        pad_values = pad_values or {}
        if isinstance(pad_to_multiple, int):
            pad_to_multiple = {k: pad_to_multiple for k in self.__keys}
        for key in self.__keys:
            values = [ex[key] for ex in examples]
            should_pad = (padded_keys is not None and key in padded_keys) or \
                (padded_keys is None and isinstance(values[0], np.ndarray)
                 and values[0].ndim >= 1)
            if should_pad:
                values = [np.asarray(v) for v in values]
                data, rel = batch_pad_right(
                    values, pad_to=pad_to_multiple.get(key),
                    value=pad_values.get(key, 0.0))
                setattr(self, key, PaddedData(data, rel))
                self.__padded_keys.append(key)
            else:
                setattr(self, key, values)

    @property
    def batch_size(self):
        first = getattr(self, self.__keys[0])
        if isinstance(first, PaddedData):
            return first.data.shape[0]
        return len(first)

    def __len__(self):
        return self.batch_size

    def __contains__(self, key):
        return key in self.__keys

    def __iter__(self):
        return iter(getattr(self, key) for key in self.__keys)

    def keys(self):
        return list(self.__keys)

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__keys}
