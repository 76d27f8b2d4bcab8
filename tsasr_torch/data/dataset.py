"""Dynamic-item dataset: dict-of-dicts with lazy derived keys.

The port's own copy of the JAX package's ``data/dataset.py``, line for
line, with its imports pointed at ``tsasr_torch``.

Equivalent of the reference ``DynamicItemDataset``
(``vendor/speechbrain/speechbrain/dataio/dataset.py:21-465``):
``from_json`` / ``from_csv`` constructors with ``{DATA_ROOT}``-style
replacements, ``filtered_sorted`` (key_min_value / key_max_value /
key_test / sort_key / reverse / select_n), ``add_dynamic_item`` and
output-key selection. Examples are plain dicts; derived keys are computed
per access by a ``DataPipeline``.
"""

import contextlib
import csv as csv_module
import json

from tsasr_torch.data.pipeline import DataPipeline


class DynamicItemDataset:
    """A dataset of keyed examples with lazily-computed dynamic items."""

    def __init__(self, data, dynamic_items=(), output_keys=()):
        self.data = data
        self.data_ids = list(data.keys())
        static_keys = set()
        for entry in data.values():
            static_keys.update(entry.keys())
        if "id" in static_keys:
            raise ValueError("'id' is a reserved key (set from the dict key)")
        static_keys.add("id")
        self.pipeline = DataPipeline(static_keys=sorted(static_keys),
                                     dynamic_items=dynamic_items)
        if output_keys:
            self.pipeline.set_output_keys(output_keys)

    # ------------------------------------------------------- constructors
    @classmethod
    def from_json(cls, json_path, replacements=None, dynamic_items=(),
                  output_keys=()):
        """Load a {id: {key: value}} JSON manifest; string values get
        ``{KEY}`` placeholders substituted from ``replacements``."""
        with open(json_path, encoding="utf-8") as f:
            data = json.load(f)
        if replacements:
            data = _apply_replacements(data, replacements)
        return cls(data, dynamic_items, output_keys)

    @classmethod
    def from_csv(cls, csv_path, replacements=None, dynamic_items=(),
                 output_keys=()):
        """Load a CSV with an ID column (reference dataio CSV format)."""
        data = {}
        with open(csv_path, newline="", encoding="utf-8") as f:
            for row in csv_module.DictReader(f):
                data_id = row.pop("ID")
                if "duration" in row:
                    with contextlib.suppress(ValueError):
                        row["duration"] = float(row["duration"])
                data[data_id] = row
        if replacements:
            data = _apply_replacements(data, replacements)
        return cls(data, dynamic_items, output_keys)

    # ------------------------------------------------------------ access
    def __len__(self):
        return len(self.data_ids)

    def __getitem__(self, index):
        data_id = self.data_ids[index]
        raw = dict(self.data[data_id])
        raw["id"] = data_id
        return self.pipeline.compute_outputs(raw)

    def raw(self, index):
        """The raw (static) entry, without pipeline evaluation."""
        data_id = self.data_ids[index]
        return {"id": data_id, **self.data[data_id]}

    # ---------------------------------------------------------- mutation
    def add_dynamic_item(self, func, takes=None, provides=None):
        self.pipeline.add_dynamic_item(func, takes, provides)

    def set_output_keys(self, keys):
        self.pipeline.set_output_keys(keys)

    @contextlib.contextmanager
    def output_keys_as(self, keys):
        saved = list(self.pipeline.output_keys)
        self.pipeline.set_output_keys(keys)
        try:
            yield self
        finally:
            self.pipeline.set_output_keys(saved)

    # --------------------------------------------------------- filtering
    def filtered_sorted(self, key_min_value=None, key_max_value=None,
                        key_test=None, sort_key=None, reverse=False,
                        select_n=None):
        """Filter/sort by static keys; returns a *view-sharing* dataset
        with the same pipeline (reference semantics,
        ``dataio/dataset.py:238-322``)."""
        key_min_value = key_min_value or {}
        key_max_value = key_max_value or {}
        key_test = key_test or {}

        def keep(entry):
            for k, v in key_min_value.items():
                if entry[k] < v:
                    return False
            for k, v in key_max_value.items():
                if entry[k] > v:
                    return False
            for k, test in key_test.items():
                if not test(entry[k]):
                    return False
            return True

        ids = [i for i in self.data_ids if keep(self.data[i])]
        if sort_key is not None:
            ids.sort(key=lambda i: self.data[i][sort_key], reverse=reverse)
        if select_n is not None:
            ids = ids[:select_n]
        new = object.__new__(DynamicItemDataset)
        new.data = self.data
        new.data_ids = ids
        new.pipeline = self.pipeline
        return new


def _apply_replacements(data, replacements):
    def sub(value):
        if isinstance(value, str):
            for key, repl in replacements.items():
                value = value.replace("{" + key + "}", str(repl))
            return value
        if isinstance(value, list):
            return [sub(v) for v in value]
        if isinstance(value, dict):
            return {k: sub(v) for k, v in value.items()}
        return value

    return {data_id: sub(entry) for data_id, entry in data.items()}


def add_dynamic_item(datasets, func, takes=None, provides=None):
    """Register one dynamic item on several datasets (reference helper,
    ``dataio/dataset.py:451``). Decorated items carry their own keys."""
    for dataset in datasets:
        dataset.add_dynamic_item(func, takes, provides)


def set_output_keys(datasets, keys):
    for dataset in datasets:
        dataset.set_output_keys(keys)
