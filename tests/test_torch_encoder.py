"""The port's label encoders (``tsasr_torch.data.encoder``) against the
JAX package's: every case of ``tests/test_encoder.py`` run on both
packages' classes, and the save files interchangeable (each package
writes the same JSON and loads the other's)."""

import importlib
import json

import pytest

PACKAGES = ["tsasr_tpu", "tsasr_torch"]


@pytest.fixture(params=PACKAGES)
def enc(request):
    return importlib.import_module(f"{request.param}.data.encoder")


def test_categorical_update_and_encode(enc):
    e = enc.CategoricalEncoder()
    e.update_from_iterable(["spk1", "spk2", "spk1", "spk3"])
    assert len(e) == 3
    assert e.encode_label("spk2") == 1
    assert e.encode_sequence(["spk3", "spk1"]) == [2, 0]
    assert e.decode_ndim([[0, 1], [2]]) == [["spk1", "spk2"], ["spk3"]]


def test_categorical_unk_fallback(enc):
    e = enc.CategoricalEncoder()
    e.update_from_iterable("abc")
    with pytest.raises(KeyError):
        e.encode_label("z")
    e.add_unk()
    assert e.encode_label("z") == e.lab2ind["<unk>"]


def test_categorical_insert_label_shifts_occupant(enc):
    e = enc.CategoricalEncoder()
    e.update_from_iterable(["a", "b"])
    e.insert_label("<blank>", 0)
    assert e.encode_label("<blank>") == 0
    assert len(e.lab2ind) == 3
    assert sorted(e.ind2lab) == [0, 1, 2]
    assert e.decode_ndim([e.encode_label("a")]) == ["a"]


def test_categorical_save_load_roundtrip(enc, tmp_path):
    e = enc.CategoricalEncoder()
    e.update_from_iterable(["x", "y"])
    e.add_unk()
    path = str(tmp_path / "enc.json")
    e.save(path)
    e2 = enc.CategoricalEncoder()
    e2.load(path)
    assert e2.lab2ind == e.lab2ind
    assert e2.unk_label == "<unk>"
    e2.expect_len(3)
    with pytest.raises(RuntimeError):
        e2.expect_len(4)


def test_categorical_load_or_create(enc, tmp_path):
    path = str(tmp_path / "enc.json")
    e = enc.CategoricalEncoder().load_or_create(
        path, from_iterables=[["a", "b"]], special_labels={"unk": "<unk>"})
    assert len(e) == 3
    e2 = enc.CategoricalEncoder().load_or_create(
        path, from_iterables=[["zzz"]])
    assert e2.lab2ind == e.lab2ind


def test_categorical_update_from_didataset(enc):
    data = [{"label": "cat"}, {"label": "dog"}, {"label": "cat"}]
    e = enc.CategoricalEncoder()
    e.update_from_didataset(data, "label")
    assert len(e) == 2


def test_text_sequence_default_and_bos_eos(enc):
    e = enc.TextEncoder()
    e.update_from_iterable([["h", "i"], ["h", "o"]])
    e.add_bos_eos()
    seq = e.encode_sequence(["h", "o"])
    assert e.prepend_bos_label(seq)[0] == e.lab2ind["<bos>"]
    assert e.append_eos_label(seq)[-1] == e.lab2ind["<eos>"]


def test_text_shared_bos_eos(enc):
    e = enc.TextEncoder()
    e.update_from_iterable([["a"]])
    e.add_bos_eos(bos_label="<s>", eos_label="<s>")
    assert len(e) == 2


def test_text_specials_survive_save(enc, tmp_path):
    e = enc.TextEncoder()
    e.update_from_iterable([["a", "b"]])
    e.add_bos_eos()
    path = str(tmp_path / "t.json")
    e.save(path)
    e2 = enc.TextEncoder()
    e2.load(path)
    assert e2.bos_label == "<bos>" and e2.eos_label == "<eos>"


def test_ctc_blank_and_collapse(enc):
    e = enc.CTCTextEncoder()
    e.update_from_iterable([["a", "b"]])
    e.add_blank()
    assert e.collapse_labels(
        ["a", "a", "<blank>", "b", "b", "<blank>"]) == ["a", "b"]
    ids = e.encode_sequence(["a", "a", "<blank>", "b"], allow_unk=False)
    assert e.decode_ndim(e.collapse_indices_ndim(ids)) == ["a", "b"]


def test_ctc_no_merge(enc):
    e = enc.CTCTextEncoder()
    e.update_from_iterable([["a"]])
    e.add_blank()
    assert e.collapse_labels(["a", "a"], merge_repeats=False) == ["a", "a"]


@pytest.mark.parametrize("name", ["CategoricalEncoder", "TextEncoder",
                                  "CTCTextEncoder"])
def test_save_files_are_interchangeable(tmp_path, name):
    """The same build in both packages writes the same JSON, and each
    loads the other's file to the same maps and specials."""
    mods = [importlib.import_module(f"{p}.data.encoder") for p in PACKAGES]
    built = []
    for mod in mods:
        e = getattr(mod, name)(starting_index=1)
        e.update_from_iterable([["q", "r"], ["r", "s"]], sequence_input=True)
        e.insert_label("<pad>", 0)
        e.add_unk()
        if name != "CategoricalEncoder":
            e.add_bos_eos()
        if name == "CTCTextEncoder":
            e.add_blank()
        built.append(e)
    paths = [str(tmp_path / f"{p}.json") for p in PACKAGES]
    for e, path in zip(built, paths):
        e.save(path)
    texts = [json.loads(open(p, encoding="utf-8").read()) for p in paths]
    assert texts[0] == texts[1]
    for mod, path in zip(mods, reversed(paths)):
        e = getattr(mod, name)()
        e.load(path)
        assert e.lab2ind == built[0].lab2ind
        assert e.ind2lab == built[0].ind2lab
        assert e._specials() == built[0]._specials()
