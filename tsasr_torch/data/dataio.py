"""dataio helpers: annotation loading + token/word utilities.

The port's own copy of the JAX package's ``data/dataio.py``, line for
line, with its imports pointed at ``tsasr_torch``.

Equivalents of the reference's ``dataio/dataio.py`` helper surface
(``load_data_json``/``load_data_csv`` with ``{KEY}`` replacements,
``merge_char``/``split_word``/``merge_csv_batch`` text utilities;
``read_audio`` lives in ``tsasr_torch.data.audio`` and ``length_to_mask``
in ``tsasr_torch.ops.masks``).
"""

import csv as csv_module
import json


def _replace(value, replacements):
    if isinstance(value, str):
        for key, repl in (replacements or {}).items():
            value = value.replace("{" + key + "}", str(repl))
        return value
    if isinstance(value, list):
        return [_replace(v, replacements) for v in value]
    if isinstance(value, dict):
        return {k: _replace(v, replacements) for k, v in value.items()}
    return value


def load_data_json(json_path, replacements=None):
    """{id: {key: value}} manifest with {KEY} placeholder substitution."""
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    return {k: _replace(v, replacements) for k, v in data.items()}


def load_data_csv(csv_path, replacements=None):
    """CSV with an ID column -> {id: row dict} (duration floats)."""
    data = {}
    with open(csv_path, newline="", encoding="utf-8") as f:
        for row in csv_module.DictReader(f):
            data_id = row.pop("ID")
            if "duration" in row:
                try:
                    row["duration"] = float(row["duration"])
                except ValueError:
                    pass
            data[data_id] = {k: _replace(v, replacements)
                             for k, v in row.items()}
    return data


def merge_char(sequences, space="_"):
    """[['a','b','_','c']] -> [['ab','c']] (char tokens -> words)."""
    out = []
    for seq in sequences:
        words = "".join(seq).split(space)
        out.append([w for w in words if w])
    return out


def split_word(sequences, space="_"):
    """[['ab','c']] -> [['a','b','_','c']] (words -> char tokens)."""
    out = []
    for seq in sequences:
        chars = []
        for i, word in enumerate(seq):
            if i > 0:
                chars.append(space)
            chars.extend(word)
        out.append(chars)
    return out


def merge_csv_batch(csv_paths, out_path):
    """Concatenate CSV manifests (shared header)."""
    rows = []
    fieldnames = None
    for path in csv_paths:
        with open(path, newline="", encoding="utf-8") as f:
            reader = csv_module.DictReader(f)
            fieldnames = fieldnames or reader.fieldnames
            rows.extend(reader)
    with open(out_path, "w", newline="", encoding="utf-8") as f:
        writer = csv_module.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)
    return out_path
