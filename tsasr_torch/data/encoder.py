"""Label encoders: categorical, text (bos/eos), and CTC variants.

The port's own copy of the JAX package's ``data/encoder.py`` (pure
Python; its save files are interchangeable with the JAX package's).

Reference surface: ``vendor/speechbrain/speechbrain/dataio/encoder.py``
(CategoricalEncoder :31-800, TextEncoder :804-1035, CTCTextEncoder
:1037-1174) — the label-to-index machinery SpeechBrain recipes use for
classification targets and character/phoneme inputs. Same semantics,
plain-Python implementation (a one-time host-side setup step):

- insertion-ordered label <-> index maps, ``update_from_iterable`` /
  ``update_from_didataset`` (optionally treating items as sequences);
- special labels: ``add_unk`` (encode fallback), TextEncoder's
  ``add_bos_eos`` (shared or distinct indices), CTCTextEncoder's
  ``add_blank``;
- ``encode_label/sequence`` + ``decode_ndim`` (recursive, any nesting);
- save/load round trip with an ``expect_len`` guard, and
  ``load_or_create`` for the train-once/load-everywhere recipe contract.
"""

import json
import os

DEFAULT_UNK = "<unk>"
DEFAULT_BOS = "<bos>"
DEFAULT_EOS = "<eos>"
DEFAULT_BLANK = "<blank>"


class CategoricalEncoder:
    """Insertion-ordered label <-> integer index bijection."""

    def __init__(self, starting_index=0):
        self.lab2ind = {}
        self.ind2lab = {}
        self.starting_index = starting_index
        self.unk_label = None

    def __len__(self):
        return len(self.lab2ind)

    def __contains__(self, label):
        return label in self.lab2ind

    # ------------------------------------------------------------- build
    def _next_index(self):
        index = self.starting_index
        while index in self.ind2lab:
            index += 1
        return index

    def add_label(self, label):
        if label in self.lab2ind:
            raise KeyError(f"Label already present: {label!r}")
        index = self._next_index()
        self.lab2ind[label] = index
        self.ind2lab[index] = label
        return index

    def ensure_label(self, label):
        if label in self.lab2ind:
            return self.lab2ind[label]
        return self.add_label(label)

    def insert_label(self, label, index):
        if label in self.lab2ind:
            raise KeyError(f"Label already present: {label!r}")
        index = int(index)
        if index in self.ind2lab:
            # shift the occupant to the next free slot (reference
            # enforce semantics: explicit index wins)
            other = self.ind2lab[index]
            del self.lab2ind[other]
            del self.ind2lab[index]
            self.lab2ind[label] = index
            self.ind2lab[index] = label
            self.lab2ind[other] = self._next_index()
            self.ind2lab[self.lab2ind[other]] = other
        else:
            self.lab2ind[label] = index
            self.ind2lab[index] = label

    def update_from_iterable(self, iterable, sequence_input=False):
        for item in iterable:
            if sequence_input:
                for label in item:
                    self.ensure_label(label)
            else:
                self.ensure_label(item)

    def update_from_didataset(self, didataset, output_key,
                              sequence_input=False):
        self.update_from_iterable(
            (item[output_key] for item in didataset),
            sequence_input=sequence_input)

    def add_unk(self, unk_label=DEFAULT_UNK):
        self.unk_label = unk_label
        return self.ensure_label(unk_label)

    def expect_len(self, expected_len):
        if len(self) != expected_len:
            raise RuntimeError(
                f"Encoder has {len(self)} labels, expected "
                f"{expected_len}")

    # ------------------------------------------------------------ encode
    def encode_label(self, label, allow_unk=True):
        try:
            return self.lab2ind[label]
        except KeyError:
            if allow_unk and self.unk_label is not None:
                return self.lab2ind[self.unk_label]
            raise

    def encode_sequence(self, sequence, allow_unk=True):
        return [self.encode_label(label, allow_unk) for label in sequence]

    def decode_ndim(self, x):
        """Recursively decode nested sequences of indices."""
        try:
            return [self.decode_ndim(item) for item in x]
        except TypeError:
            return self.ind2lab[int(x)]

    # -------------------------------------------------------------- save
    def save(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "lab2ind": [[str(k) if not isinstance(k, (str, int)) else k,
                         v] for k, v in self.lab2ind.items()],
            "starting_index": self.starting_index,
            "specials": self._specials(),
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, ensure_ascii=False, indent=2)

    def _specials(self):
        return {"unk_label": self.unk_label}

    def _restore_specials(self, specials):
        self.unk_label = specials.get("unk_label")

    def load(self, path):
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        self.lab2ind = {k: int(v) for k, v in payload["lab2ind"]}
        self.ind2lab = {v: k for k, v in self.lab2ind.items()}
        self.starting_index = payload["starting_index"]
        self._restore_specials(payload.get("specials", {}))

    def load_or_create(self, path, from_iterables=(),
                       sequence_input=False, output_key=None,
                       from_didatasets=(), special_labels=None):
        """Load if saved, otherwise build from the sources and save
        (the reference's fit-on-main/load-elsewhere contract)."""
        if os.path.exists(path):
            self.load(path)
            return self
        for iterable in from_iterables:
            self.update_from_iterable(iterable, sequence_input)
        for dataset in from_didatasets:
            self.update_from_didataset(dataset, output_key,
                                       sequence_input)
        for name, value in (special_labels or {}).items():
            getattr(self, f"add_{name}")(value)
        self.save(path)
        return self


class TextEncoder(CategoricalEncoder):
    """CategoricalEncoder + bos/eos handling (sequence inputs default)."""

    def __init__(self, starting_index=0):
        super().__init__(starting_index)
        self.bos_label = None
        self.eos_label = None

    def update_from_iterable(self, iterable, sequence_input=True):
        super().update_from_iterable(iterable, sequence_input)

    def update_from_didataset(self, didataset, output_key,
                              sequence_input=True):
        super().update_from_didataset(didataset, output_key,
                                      sequence_input)

    def add_bos_eos(self, bos_label=DEFAULT_BOS, eos_label=DEFAULT_EOS):
        """Distinct labels, or the same label for a shared index
        (reference :906-936)."""
        self.bos_label = bos_label
        self.eos_label = eos_label
        self.ensure_label(bos_label)
        if eos_label != bos_label:
            self.ensure_label(eos_label)

    def prepend_bos_label(self, x):
        return [self.lab2ind[self.bos_label]] + list(x)

    def append_eos_label(self, x):
        return list(x) + [self.lab2ind[self.eos_label]]

    def _specials(self):
        out = super()._specials()
        out.update({"bos_label": self.bos_label,
                    "eos_label": self.eos_label})
        return out

    def _restore_specials(self, specials):
        super()._restore_specials(specials)
        self.bos_label = specials.get("bos_label")
        self.eos_label = specials.get("eos_label")


class CTCTextEncoder(TextEncoder):
    """TextEncoder + blank handling (reference :1037-1174)."""

    def __init__(self, starting_index=0):
        super().__init__(starting_index)
        self.blank_label = None

    def add_blank(self, blank_label=DEFAULT_BLANK):
        self.blank_label = blank_label
        self.ensure_label(blank_label)

    def collapse_labels(self, x, merge_repeats=True):
        """Filter a label sequence like CTC output post-processing."""
        out, prev = [], None
        for label in x:
            if merge_repeats and label == prev:
                prev = label
                continue
            prev = label
            if label != self.blank_label:
                out.append(label)
        return out

    def collapse_indices_ndim(self, x, merge_repeats=True):
        blank_index = self.lab2ind.get(self.blank_label)
        out, prev = [], None
        for idx in x:
            if merge_repeats and idx == prev:
                prev = idx
                continue
            prev = idx
            if idx != blank_index:
                out.append(idx)
        return out

    def _specials(self):
        out = super()._specials()
        out["blank_label"] = self.blank_label
        return out

    def _restore_specials(self, specials):
        super()._restore_specials(specials)
        self.blank_label = specials.get("blank_label")
