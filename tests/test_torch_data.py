"""The port's host data layer against the JAX package's, bit for bit.

Everything here is numpy or pure Python on both sides (no JAX compile
but a few eager ops on lengths), so every comparison is exact:

- the synthetic corpus: the port's maker writes the same files as the
  repo's ``tools/make_synthetic_dataset.py``;
- tokenizers: ``train_tokenizer`` for char, bpe and unigram gives the
  same pieces and the same ids; a char vocab too large raises, one too
  small truncates the characters, in both;
- the pipeline: ``prepare`` -> tokenizer -> ``dataio_prepare`` ->
  ``DynamicBatchSampler`` -> loader gives the same manifests, buckets,
  batch order, ids, padded arrays (``pad_to_multiple`` included) and
  ``target_words``; ``batch_to_arrays`` and the frame padding give the
  same lengths, and so the same frame and token counts the model and the
  loss use;
- the loader: an abandoned iterator leaves no live worker (thread and
  process modes), and ``save_position`` / ``load_position`` resume at
  the same batch in both packages;
- hparams: both scratch yamls give the same scalar values after the same
  overrides;
- ``ErrorRateStats.write_stats``: the same text for the same scores;
- checkpoints: keep-N-best on the same sequence of metas keeps the same
  set.
"""

import filecmp
import gc
import importlib
import io
import json
import multiprocessing
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import (CORPUS, JAX_YAML, REPO, TORCH_YAML,
                                load_yaml, overrides, package_pipeline)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset
    root = tmp_path_factory.mktemp("corpus")
    make_dataset(str(root), **CORPUS)
    return str(root)


def test_port_maker_writes_the_repo_tools_corpus(corpus, tmp_path):
    sys.path.insert(0, str(REPO))
    from tools.make_synthetic_dataset import make_dataset
    make_dataset(str(tmp_path), **CORPUS)
    listed = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*")
                    if p.is_file())
    assert listed == sorted(str(p.relative_to(corpus))
                            for p in Path(corpus).rglob("*") if p.is_file())
    match, mismatch, errors = filecmp.cmpfiles(corpus, tmp_path, listed,
                                               shallow=False)
    assert (mismatch, errors) == ([], []) and len(match) == len(listed)


# ------------------------------------------------------------ tokenizers
TEXTS = ["THE QUICK BROWN FOX", "JUMPS OVER A LAZY DOG", "AND RUNS FAR AWAY",
         "THE DOG RUNS HOME NOW", "A FOX AND A DOG", "QUICK QUICK BROWN"]


@pytest.mark.parametrize("model_type,vocab", [("char", 24), ("bpe", 40),
                                              ("unigram", 40)])
def test_train_tokenizer_matches_jax(model_type, vocab, tmp_path):
    from tsasr_torch.data.tokenizer import train_tokenizer
    from tsasr_tpu.data.tokenizer import train_tokenizer as jax_train
    tok = train_tokenizer(str(tmp_path / "t"), TEXTS, vocab, model_type)
    want = jax_train(str(tmp_path / "j"), TEXTS, vocab, model_type)
    assert tok.pieces == want.pieces
    for text in TEXTS + ["A BROWN ZEBRA"]:
        assert tok.encode_as_ids(text) == want.encode_as_ids(text)
        assert tok.encode_as_pieces(text) == want.encode_as_pieces(text)
    ids = [tok.encode_as_ids(t) for t in TEXTS]
    assert tok(ids, task="decode_from_list") == want(ids,
                                                     task="decode_from_list")
    # the saved file reloads to the same tokenizer in the other package
    name = f"{model_type}_{vocab}.json"
    assert (tmp_path / "t" / name).read_text() == \
        (tmp_path / "j" / name).read_text()


def test_char_vocab_too_large_raises_too_small_truncates():
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_tpu.data.tokenizer import CharTokenizer as JaxChar
    full = CharTokenizer.train(TEXTS)
    found = len(full.pieces)
    for cls in (CharTokenizer, JaxChar):
        with pytest.raises(ValueError, match="vocab_size"):
            cls.train(TEXTS, vocab_size=found + 1)
    small = CharTokenizer.train(TEXTS, vocab_size=found - 3)
    assert small.pieces == JaxChar.train(TEXTS, vocab_size=found - 3).pieces
    assert len(small.pieces) == found - 3
    dropped = sorted(set(full.pieces) - set(small.pieces))
    assert len(dropped) == 3
    for ch in dropped:        # the rarest characters, now unknown
        assert small.encode_as_ids(ch)[-1] == small.unk_id


# -------------------------------------------------------------- pipeline
@pytest.fixture(scope="module")
def both_pipelines(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("pipelines")
    return (package_pipeline("tsasr_torch", corpus, out / "torch"),
            package_pipeline("tsasr_tpu", corpus, out / "jax"))


def _loader(package, dataset, kwargs):
    return importlib.import_module(
        f"{package}.data.loader").SaveableDataLoader(dataset, **kwargs)


def assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for key in want.keys():
        g, w = getattr(got, key), getattr(want, key)
        if hasattr(w, "lengths"):
            assert g.data.dtype == w.data.dtype, key
            np.testing.assert_array_equal(g.data, w.data, err_msg=key)
            np.testing.assert_array_equal(g.lengths, w.lengths, err_msg=key)
        else:
            assert g == w, key


def test_manifests_and_tokenizer_match_jax(both_pipelines):
    (th, ttok, _, _), (jh, jtok, _, _) = both_pipelines
    for split in ("train", "valid", "test"):
        with open(th[f"{split}_json"]) as f, open(jh[f"{split}_json"]) as g:
            assert json.load(f) == json.load(g)
    assert ttok.pieces == jtok.pieces


@pytest.mark.parametrize("stage", ["train", "valid", "test"])
def test_buckets_batches_and_arrays_match_jax(both_pipelines, stage):
    """Every batch of every stage, bit for bit, with the yaml's
    ``pad_to_multiple`` (16000 samples, 16 tokens)."""
    (_, _, tsets, tkw), (_, _, jsets, jkw) = both_pipelines
    index = ("train", "valid", "test").index(stage)
    tsampler, jsampler = tkw[stage]["batch_sampler"], \
        jkw[stage]["batch_sampler"]
    np.testing.assert_array_equal(tsampler._boundaries, jsampler._boundaries)
    assert list(tsampler) == list(jsampler)
    got = list(_loader("tsasr_torch", tsets[index], tkw[stage]))
    want = list(_loader("tsasr_tpu", jsets[index], jkw[stage]))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
        assert g.mixed_sig.data.shape[1] % 16000 == 0
        assert g.tokens_bos.data.shape[1] % 16 == 0
        assert all(isinstance(t, list) for t in g.target_words)


def test_model_lengths_match_jax(both_pipelines):
    """``batch_to_arrays`` keeps the mixture's relative lengths in f64 in
    JAX and casts them to f32 in the port; JAX casts them to f32 on the
    device. The lengths the model and the loss take (frames after
    ``pad_feats_to`` and the 4x subsampling, tokens) agree exactly."""
    import jax.numpy as jnp
    from tsasr_torch.ops.features import pad_audio_to_frame_multiple
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    from tsasr_tpu.ops.features import \
        pad_audio_to_frame_multiple as jax_pad
    from tsasr_tpu.recipes.librispeechmix import TSASRBrain as JaxBrain

    (th, ttok, tsets, tkw), (jh, _, jsets, jkw) = both_pipelines
    tbrain = TSASRBrain.__new__(TSASRBrain)
    jbrain = JaxBrain.__new__(JaxBrain)
    tbrain.variant = jbrain.variant = "scratch"
    jbrain.speaker_encoder = None
    pad_to = th["pad_feats_to"]
    for stage, index in (("train", 0), ("valid", 1)):
        for tb, jb in zip(_loader("tsasr_torch", tsets[index], tkw[stage]),
                          _loader("tsasr_tpu", jsets[index], jkw[stage])):
            got, want = tbrain.batch_to_arrays(tb), jbrain.batch_to_arrays(jb)
            assert got.keys() == want.keys()
            for key in want:
                w = np.asarray(want[key])
                if w.dtype == np.float64:       # JAX casts on the device
                    w = w.astype(np.float32)
                np.testing.assert_array_equal(got[key], w, err_msg=key)
            for sig, rel in (("mixed_sig", "mixed_lens"),
                             ("enroll_sig", "enroll_lens")):
                twav, trel = pad_audio_to_frame_multiple(
                    torch.as_tensor(got[sig]), torch.as_tensor(got[rel]),
                    pad_to)
                jwav, jrel = jax_pad(jnp.asarray(want[sig]),
                                     jnp.asarray(want[rel]), pad_to)
                assert twav.shape == jwav.shape
                np.testing.assert_array_equal(trel.numpy(), np.asarray(jrel))
                frames = -(-(1 + twav.shape[1] // 160) // 4)
                np.testing.assert_array_equal(
                    torch.round(trel * frames).to(torch.int32).numpy(),
                    np.asarray(jnp.round(jrel * frames).astype(jnp.int32)))
            u = got["tokens"].shape[1]
            np.testing.assert_array_equal(
                torch.round(torch.as_tensor(got["tokens_lens"]) * u).numpy(),
                np.asarray(jnp.round(jnp.asarray(want["tokens_lens"]) * u)))


# ---------------------------------------------------------------- loader
def _live_workers():
    return threading.active_count(), len(multiprocessing.active_children())


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_abandoned_iterator_leaves_no_worker(both_pipelines, mode):
    (_, _, tsets, tkw), _ = both_pipelines
    kwargs = dict(tkw["train"], num_workers=2 if mode == "process" else 1,
                  worker_mode=mode)
    before = _live_workers()
    it = iter(_loader("tsasr_torch", tsets[0], kwargs))
    next(it)
    assert _live_workers() != before        # a worker is running
    it.close()
    del it
    gc.collect()
    deadline = time.time() + 10.0
    while _live_workers() != before and time.time() < deadline:
        time.sleep(0.05)
    assert _live_workers() == before


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_save_and_load_position_resume_like_jax(both_pipelines, mode):
    """Two batches in, the position is saved; a new loader of each
    package loads it mid-epoch and yields the rest, the same batches as
    the other package; an end-of-epoch position restarts the epoch."""
    (_, _, tsets, tkw), (_, _, jsets, jkw) = both_pipelines
    rest = {}
    for package, sets, kw in (("tsasr_torch", tsets, tkw),
                              ("tsasr_tpu", jsets, jkw)):
        kwargs = dict(kw["train"], num_workers=2 if mode == "process" else 1,
                      worker_mode=mode)
        first = _loader(package, sets[0], kwargs)
        it = iter(first)
        seen = [next(it), next(it)]
        position = first.save_position()
        it.close()
        assert position == {"num_batches_yielded": 2}
        resumed = _loader(package, sets[0], kwargs)
        resumed.load_position(position, end_of_epoch=False)
        rest[package] = list(resumed)
        full = list(_loader(package, sets[0], kwargs))
        assert [b.id for b in seen + rest[package]] == [b.id for b in full]
        restarted = _loader(package, sets[0], kwargs)
        restarted.load_position(position, end_of_epoch=True)
        assert len(list(restarted)) == len(full)
    assert len(rest["tsasr_torch"]) == len(rest["tsasr_tpu"]) > 0
    for g, w in zip(rest["tsasr_torch"], rest["tsasr_tpu"]):
        assert_batches_equal(g, w)


# --------------------------------------------------------------- hparams
def _scalars(hparams):
    def plain(v):
        return v is None or isinstance(v, (bool, int, float, str)) or (
            isinstance(v, (list, tuple, dict)) and all(
                plain(x) for x in (v.values() if isinstance(v, dict)
                                   else v)))
    return {k: v for k, v in hparams.items() if plain(v)}


def test_scratch_yamls_give_the_same_scalars(tmp_path):
    text = overrides("/data", tmp_path, 31) + "lr: 0.002\nbeam_size: 1\n"
    got = load_yaml("tsasr_torch", TORCH_YAML, text)
    want = load_yaml("tsasr_tpu", JAX_YAML, text)
    assert _scalars(got) == _scalars(want)
    assert got["lr"] == 0.002 and got["vocab_size"] == 31
    # the model config: every key the yaml passes, the same value
    tcfg, jcfg = got["model_config"], want["model_config"]
    for key in tcfg.__dataclass_fields__:
        if key in ("frontend_channels", "frontend_strides"):
            assert tuple(getattr(tcfg, key)) == tuple(getattr(jcfg, key))
        elif key == "dtype":             # torch's f32 and jnp's, by name
            assert str(tcfg.dtype) == f"torch.{np.dtype(jcfg.dtype)}"
        else:
            assert getattr(tcfg, key) == getattr(jcfg, key), key
    assert got["noam_scheduler"].n_warmup_steps == \
        want["noam_scheduler"].n_warmup_steps == 10000
    assert got["epoch_counter"].limit == want["epoch_counter"].limit == 100
    assert got["checkpointer"].checkpoints_dir == \
        want["checkpointer"].checkpoints_dir
    assert got["train_logger"].save_file == want["train_logger"].save_file


@pytest.mark.parametrize("key,value", [
    ("predictor_class", "lstm"), ("joiner_class", "sum"),
    ("remat", "true"), ("speaker_encoder_type", "ecapa"),
    ("encoder_class", "conformer")])
def test_unported_model_keys_raise(key, value, tmp_path):
    """The yaml's model keys that raised before they were ported: a
    ``*_class`` name that is not registered raises ``ValueError`` with
    the registered names, as the JAX registry does; ``remat`` and
    ``speaker_encoder_type: ecapa`` load and build their model."""
    text = overrides("/data", tmp_path, 31) + f"{key}: {value}\n"
    if key.endswith("_class"):
        with pytest.raises(ValueError, match=f"unknown {key[:-6]} class "
                           f"'{value}'; registered"):
            load_yaml("tsasr_torch", TORCH_YAML, text)
        return
    model = load_yaml("tsasr_torch", TORCH_YAML, text)["model"]
    if key == "remat":
        assert model.config.remat and model.encoder.remat
        assert model.speaker_encoder.remat
    else:
        from tsasr_torch.models.ecapa import ECAPA_TDNN
        assert isinstance(model.speaker_encoder, ECAPA_TDNN)
        assert model.speaker_frontend is None
        assert model.speaker_proj.in_features == 192


# --------------------------------------------------------------- metrics
def test_write_stats_text_matches_jax():
    from tsasr_torch.utils.metric_stats import ErrorRateStats
    from tsasr_tpu.utils.metric_stats import ErrorRateStats as JaxStats
    ids = ["a", "b", "c"]
    hyps = [["THE", "QUICK", "FOX"], [""], ["A", "LAZY", "DOG", "DOG"]]
    refs = [["THE", "QUICK", "BROWN", "FOX"], ["RUNS", "HOME"],
            ["A", "LAZY", "DOG"]]
    for split in (False, True):
        got, want = ErrorRateStats(split_tokens=split), \
            JaxStats(split_tokens=split)
        got.append(ids, hyps, refs)
        want.append(ids, hyps, refs)
        assert got.scores == want.scores
        assert got.summarize("error_rate") == want.summarize("error_rate")
        texts = []
        for stats in (got, want):
            buf = io.StringIO()
            stats.write_stats(buf)
            texts.append(buf.getvalue())
        assert texts[0] == texts[1] and texts[0].startswith("%WER")
        # the same scores handed to both writers
        fresh, jfresh = ErrorRateStats(), JaxStats()
        fresh.scores = jfresh.scores = want.scores
        bufs = [io.StringIO(), io.StringIO()]
        fresh.write_stats(bufs[0])
        jfresh.write_stats(bufs[1])
        assert bufs[0].getvalue() == bufs[1].getvalue()


# ----------------------------------------------------------- checkpoints
def test_keep_n_best_keeps_the_same_set(tmp_path):
    """The same sequence of saves (end-of-epoch WERs, an intra-epoch save
    with its predicate) leaves the same checkpoints in both packages, and
    both recover the same one."""
    from tsasr_torch.training.checkpoints import Checkpointer
    from tsasr_tpu.training.checkpoints import Checkpointer as JaxCkpt

    class Counter:
        def __init__(self):
            self.n = 0

        def save(self, path):
            Path(path).write_text(str(self.n))

        def load(self, path, end_of_epoch=True):
            self.n = int(Path(path).read_text())

    wers = [40.0, 35.5, 50.0, 35.5, 20.0, 60.0, 33.0]
    kept = {}
    for name, cls in (("torch", Checkpointer), ("jax", JaxCkpt)):
        counter = Counter()
        ckpt = cls(tmp_path / name, recoverables={"counter": counter})
        for i, wer in enumerate(wers):
            counter.n = i
            ckpt.save_and_keep_only(name=f"CKPT+{i:02d}",
                                    meta={"WER": wer, "unixtime_": i},
                                    min_keys=["WER"], num_to_keep=3)
            if i == 3:
                ckpt.save_and_keep_only(
                    name="CKPT+03b", meta={"unfinished_epoch": True},
                    end_of_epoch=False, num_to_keep=1,
                    importance_key=lambda c: c.unixtime,
                    ckpt_predicate=lambda c: c.meta.get(
                        "unfinished_epoch", False))
        kept[name] = sorted(os.path.basename(c.path)
                            for c in ckpt.list_checkpoints())
        counter.n = -1
        ckpt.recover_if_possible(min_key="WER")
        kept[name + "_best"] = counter.n
    assert kept["torch"] == kept["jax"]
    assert kept["torch_best"] == kept["jax_best"] == 4


def test_state_dict_recoverable_and_averaging(tmp_path):
    """``PytreeRecoverable`` round-trips a state dict through a
    checkpoint; ``average_checkpoints`` averages its floating tensors
    over checkpoints (exact: the mean of 1, 2 and 4 halves)."""
    from tsasr_torch.training.checkpoints import (Checkpointer,
                                                  PytreeRecoverable,
                                                  average_checkpoints)
    state = {}
    rec = PytreeRecoverable(lambda: state["w"],
                            lambda value: state.update(w=value))
    ckpt = Checkpointer(tmp_path, recoverables={"weights": rec})
    for i, scale in enumerate((1.0, 2.0, 4.0)):
        state["w"] = {"a": torch.full((3,), scale),
                      "n": torch.tensor(i), "nested": [torch.ones(2)]}
        ckpt.save_checkpoint(name=f"CKPT+{i}")
    state["w"] = None
    ckpt.recover_if_possible(importance_key=lambda c: -c.unixtime)
    assert torch.equal(state["w"]["a"], torch.full((3,), 1.0))
    mean = average_checkpoints(ckpt.list_checkpoints(), "weights")
    assert torch.equal(mean["a"], torch.full((3,), 7.0 / 3.0))
    assert int(mean["n"]) == 0 and torch.equal(mean["nested"][0],
                                               torch.ones(2))


def test_epoch_counter_with_stopper_matches_jax(tmp_path):
    from tsasr_torch.training.epoch_loop import EpochCounterWithStopper
    from tsasr_tpu.training.epoch_loop import \
        EpochCounterWithStopper as JaxStopper
    metrics = [5.0, 4.0, 4.5, 4.2, 3.9, 4.0, 4.1, 4.05, 4.3]
    runs = []
    for cls in (EpochCounterWithStopper, JaxStopper):
        counter = cls(limit=20, limit_to_stop=3, limit_warmup=1)
        seen = []
        for epoch, metric in zip(counter, metrics):
            seen.append(epoch)
            counter.update_metric(metric)
        counter.save(tmp_path / f"{cls.__module__}.json")
        runs.append((seen, (tmp_path / f"{cls.__module__}.json").read_text()))
    assert runs[0] == runs[1] and runs[0][0] == [1, 2, 3, 4, 5, 6, 7, 8]


def test_looped_loader_matches_jax(both_pipelines):
    """Nominal epochs of 7 batches over a loader of 20: the same batches,
    and the same saved position, in both packages."""
    (_, _, tsets, tkw), (_, _, jsets, jkw) = both_pipelines
    seen = []
    for package, sets, kw in (("tsasr_torch", tsets, tkw),
                              ("tsasr_tpu", jsets, jkw)):
        loader = importlib.import_module(f"{package}.data.loader")
        looped = loader.make_dataloader(sets[0], looped_nominal_epoch=7,
                                        **kw["train"])
        ids = [[b.id for b in looped] for _ in range(4)]
        seen.append((ids, looped.save_position()))
    assert seen[0] == seen[1]
    assert sum(len(epoch) for epoch in seen[0][0]) == 28
