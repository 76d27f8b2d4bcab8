"""The scratch recipe's experiment end to end on the CPU, and its first
TRAIN micro-batch against the JAX package.

- ``run_experiment(--device cpu)`` on a 1-layer model trains, validates,
  checkpoints and tests: the log, the WER file, ``hyperparams.yaml`` and
  ``env.log`` are written;
- a second run with more epochs recovers the checkpoint: the model, the
  optimizer's moments, the running gradient mean and the counters equal
  the saved ones bit for bit, and the dropout generator of the next
  micro-batch is the one an uninterrupted run draws; it then trains epoch
  2 to the same weights, bit for bit, as one run of 2 epochs;
- a checkpoint in the middle of an accumulation, restored before the
  optimizer exists, continues bit for bit;
- TEST runs the yaml's batched beam (beam 3 here, one utterance a
  batch); ``TSASRTranscriber.from_experiment`` on the run's folder,
  through ``transcribe_file``, gives the transcripts TEST recorded, as
  does the ``tsasr_torch.tools.transcribe`` CLI; ``average_checkpoints``
  of one checkpoint reproduces it bit for bit;
- without ``--device`` the experiment asks for the card, and raises on a
  host without one before writing anything; what is not ported (the
  parallel flags) raises, and so do a missing LM file and an unknown
  variant, before anything runs; the switches ported since (``--profile``,
  ``plot_*``, ``prompt_test``, ``model_path``) pass those checks and act
  by the time ``fit`` starts;
- ``model_path`` warm-starts a run from a checkpoint's weights bit for
  bit, and a run that finds its own checkpoint recovers that instead;
- the JAX model's initial parameters, converted, and the first TRAIN
  batch of each package's pipeline give both ``fit_batch``es the same
  loss (rtol 1e-5) and gradient norm (rtol 1e-4), dropout off.
"""

import os

import numpy as np
import pytest
import torch

from torch_port_helpers import (CORPUS, TORCH_YAML, corpus_vocab,
                                package_pipeline, split_as_files)

TEST_BEAM = 3

TINY_ARGS = ["--encoder_num_layers", "1", "--d_ffn", "64", "--d_model",
             "32", "--nhead", "4", "--decoder_neurons", "24",
             "--joint_dim", "48", "--beam_size", "3",
             # one utterance a TEST batch: a file transcribed alone then
             # sees what TEST saw (no padding to a longer neighbour)
             "--test_max_batch_length", "0.5",
             "--valid_search_freq", "1", "--noprogressbar",
             # 6 TRAIN micro-batches an epoch: at accumulation 4 an epoch
             # ends in the middle of an accumulation
             "--train_max_batch_length", "8.0"]


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_logging_restored():
    """Torch on one thread: these tests run thousands of small CPU ops,
    and beside other test processes a multi-threaded op's wait for all
    its threads costs more than the op (tens of times slower). The
    experiment points the root logger at its folder; the tests after
    these get it back as it was."""
    import logging
    from tsasr_torch.utils import logger
    root = logging.getLogger()
    level, threads = root.level, torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    while logger._handlers:
        handler = logger._handlers.pop()
        root.removeHandler(handler)
        handler.close()
    root.setLevel(level)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset
    root = tmp_path_factory.mktemp("corpus")
    make_dataset(str(root), **CORPUS)
    return str(root)


def argv(corpus, out, epochs, *extra):
    return [str(TORCH_YAML), "--data_folder", corpus, "--output_folder",
            str(out), "--device", "cpu", "--vocab_size",
            str(corpus_vocab(corpus)), "--num_epochs", str(epochs),
            *TINY_ARGS, *extra]


def snapshot(brain):
    """The train state a checkpoint holds, cloned."""
    opt = brain.optimizer.state_dict()["state"]
    brain.step, step = 1, brain.step        # the next micro-batch's draw
    draw = torch.rand(8, generator=brain.step_generator())
    brain.step = step
    return {
        "model": {k: v.clone() for k, v in brain.model.state_dict().items()},
        "moments": {k: {n: t.clone() for n, t in v.items()}
                    for k, v in opt.items()},
        "acc": [a.clone() for a in brain._acc],
        "counters": (brain.optimizer_step, brain.global_micro_step,
                     brain._mini_step, brain.nonfinite_count),
        "dropout_draw": draw,
    }


def assert_states_equal(got, want):
    assert got["counters"] == want["counters"]
    assert got["model"].keys() == want["model"].keys()
    for key in want["model"]:
        assert torch.equal(got["model"][key], want["model"][key]), key
    assert got["moments"].keys() == want["moments"].keys()
    for key, state in want["moments"].items():
        for name, value in state.items():
            assert torch.equal(got["moments"][key][name], value), (key, name)
    assert all(torch.equal(a, b) for a, b in zip(got["acc"], want["acc"]))


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """One folder trained for 1 epoch, then resumed for a 2nd; another
    trained for 2 epochs in one run. Records the state the resumed run
    starts epoch 2 from, and the one the uninterrupted run does."""
    from tsasr_torch.recipes.librispeechmix import TSASRBrain, run_experiment
    root = tmp_path_factory.mktemp("runs")
    starts, ends = [], []
    fit_train = TSASRBrain._fit_train

    def recording(self, train_set, epoch):
        if epoch == 2:
            starts.append(snapshot(self))
        fit_train(self, train_set, epoch)
        if epoch == 2:
            ends.append(snapshot(self))

    TSASRBrain._fit_train = recording
    try:
        first = run_experiment(argv=argv(corpus, root / "resumed", 1))
        saved = snapshot(first)
        log_after_first = (root / "resumed" / "train_log.txt").read_text()
        first_ckpts = [(c.path, dict(c.meta), sorted(os.listdir(c.path)))
                       for c in first.checkpointer.list_checkpoints()]
        second = run_experiment(argv=argv(corpus, root / "resumed", 2))
        straight = run_experiment(argv=argv(corpus, root / "straight", 2))
    finally:
        TSASRBrain._fit_train = fit_train
    return {"root": root, "corpus": corpus, "first": first, "saved": saved,
            "first_ckpts": first_ckpts,
            "log_after_first": log_after_first, "second": second,
            "resumed_start": starts[0], "resumed_end": ends[0],
            "straight": straight, "straight_start": starts[1],
            "straight_end": ends[1]}


def test_fit_writes_log_wer_file_and_checkpoint(runs):
    out = runs["root"] / "resumed"
    log = runs["log_after_first"]
    assert "epoch: 1" in log and "valid WER" in log
    assert "Epoch loaded: 1" in log
    wer = (out / "wer_test-clean-2mix.txt").read_text()
    assert wer.startswith("%WER") and "ALIGNMENTS" in wer
    for name in ("hyperparams.yaml", "env.log", "log.txt"):
        assert (out / name).exists(), name
    with open(out / "hyperparams.yaml") as f:
        assert "tsasr_torch.models.transducer.TSTransducer" in f.read()
    assert "torch:" in (out / "env.log").read_text()
    [(_, meta, files)] = runs["first_ckpts"]
    assert "WER" in meta and meta["end-of-epoch"]
    assert files == ["CKPT.yaml", "brain.ckpt", "counter.ckpt",
                     "dataloader.ckpt", "scheduler.ckpt"]
    assert all(p.device.type == "cpu"
               for p in runs["first"].model.parameters())
    from tsasr_torch.decoding import BatchedBeamSearcher
    beam = runs["first"]._beam
    assert isinstance(beam, BatchedBeamSearcher) and beam.lm_weight == 0
    assert (beam.beam_size, beam.nbest, beam.expand_beam) == (TEST_BEAM, 1,
                                                              2.3)
    # 6 micro-batches at accumulation 4: one update, two micro-batches
    # accumulated
    assert runs["saved"]["counters"] == (1, 6, 2, 0)


def test_second_run_recovers_the_saved_state_bit_for_bit(runs):
    """What the second run starts epoch 2 from is what the first saved
    (and what its checkpoint file holds), and what an uninterrupted run
    holds at the start of its epoch 2, dropout draw included."""
    from tsasr_torch.training.checkpoints import load_state
    got, saved = runs["resumed_start"], runs["saved"]
    assert_states_equal(got, saved)
    assert_states_equal(got, runs["straight_start"])
    assert torch.equal(got["dropout_draw"],
                       runs["straight_start"]["dropout_draw"])
    on_disk = load_state(os.path.join(runs["first_ckpts"][0][0],
                                      "brain.ckpt"))
    for key, value in on_disk["model"].items():
        assert torch.equal(value, saved["model"][key]), key
    assert on_disk["optimizer_step"] == saved["counters"][0]


def test_second_run_trains_epoch_two_like_one_run(runs):
    out = runs["root"] / "resumed"
    log = (out / "train_log.txt").read_text()
    assert log.startswith(runs["log_after_first"])
    added = log[len(runs["log_after_first"]):]
    assert "epoch: 2" in added and "epoch: 1" not in added
    assert "Epoch loaded: 2" in added
    assert "steps: 3 " in added
    resumed, straight = runs["resumed_end"], runs["straight_end"]
    assert resumed["counters"] == (3, 12, 0, 0)
    assert_states_equal(resumed, straight)
    assert len(runs["second"].checkpointer.list_checkpoints()) == 2


def test_checkpoint_inside_an_accumulation_resumes(corpus, tmp_path):
    """Six micro-batches at accumulation 4, a checkpoint, then two more:
    a Brain recovered from it before its optimizer exists (the optimizer
    state waits for ``init_optimizers``) ends where the original does."""
    from tsasr_torch.training.checkpoints import Checkpointer
    hparams, _, datasets, kwargs = package_pipeline(
        "tsasr_torch", corpus, tmp_path / "pipeline")
    from tsasr_torch.data.loader import SaveableDataLoader
    batches = list(SaveableDataLoader(datasets[0], **dict(
        kwargs["train"], batch_sampler=None, batch_size=1)))[:8]
    assert len(batches) == 8
    brains = [small_brain(hparams, Checkpointer(tmp_path / "ckpt"))
              for _ in range(2)]
    original, restored = brains
    for batch in batches[:6]:
        original.fit_batch(batch)
    original.checkpointer.save_checkpoint(end_of_epoch=False)
    assert restored.optimizer is None
    restored.checkpointer.recover_if_possible()
    assert restored.optimizer is None
    assert (restored._mini_step, restored.step) == (2, 6)
    for brain in brains:
        for batch in batches[6:]:
            brain.fit_batch(batch)
    assert restored.optimizer_step == original.optimizer_step == 2
    assert_states_equal(snapshot(restored), snapshot(original))


def small_brain(hparams, checkpointer=None, dropout=0.1):
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    from tsasr_torch.training.optimizers import make_adamw
    config = TSTransducerConfig(**SMALL_MODEL, dropout=dropout,
                                vocab_size=hparams["vocab_size"])
    model = TSTransducer(config).init_weights(seed=0)
    return TSASRBrain(
        modules={"model": model}, opt_class=make_adamw(lr=1e-2),
        hparams=dict(hparams, grad_accumulation_factor=4),
        run_opts={"device": "cpu"}, checkpointer=checkpointer,
        tokenizer=None)


SMALL_MODEL = dict(d_model=16, nhead=2, encoder_num_layers=1, d_ffn=32,
                   kernel_size=7, speaker_encoder_layers=1,
                   decoder_neurons=16, joint_dim=24,
                   frontend_channels=(8, 8))


def test_without_device_it_asks_for_the_card(corpus, tmp_path, monkeypatch):
    from tsasr_torch.recipes.librispeechmix import run_experiment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in argv(corpus, tmp_path / "out", 1)
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_experiment(argv=args)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("extra,match", [
    (["--data_parallel_count", "2"], "data_parallel_count"),
    (["--tensor_parallel_count", "2"], "tensor_parallel_count"),
    (["--sequence_parallel_count", "2"], "sequence_parallel_count"),
    (["--pipeline_parallel_count", "2"], "pipeline_parallel_count"),
])
def test_what_is_not_ported_raises_before_anything_runs(corpus, tmp_path,
                                                        extra, match):
    from tsasr_torch.recipes.librispeechmix import run_experiment
    with pytest.raises(NotImplementedError, match=match):
        run_experiment(argv=argv(corpus, tmp_path / "out", 1, *extra))
    assert not (tmp_path / "out").exists()


class _ReachedFit(Exception):
    pass


def _profiled(brain, train_set, valid_set, out):
    from tsasr_torch.utils.profiling import Profiler
    assert isinstance(brain.profiler, Profiler)
    assert brain.profiler.logdir == str(out / "profiler")
    assert brain.profiler.device.type == "cpu"


def _plotted_data(brain, train_set, valid_set, out):
    train_set[0]
    assert list((out / "images").glob("*/*_fbanks.png"))
    assert list((out / "images").glob("*/*_enrollment.wav"))


def _prompted(brain, train_set, valid_set, out):
    item = train_set[0]
    mixed, enroll = item["mixed_sig"], item["enroll_sig"]
    n = len(enroll)
    assert len(mixed) > 2 * n      # the yaml's prompt_mode: both ends
    assert np.array_equal(mixed[:n], enroll)
    assert np.array_equal(mixed[-n:], enroll)


def _warm_started(brain, train_set, valid_set, out):
    from tsasr_torch.training.checkpoints import load_state
    source = load_state(out.parent / "source.ckpt")["model"]
    for key, value in brain.model.state_dict().items():
        assert torch.equal(value, source[key]), key


def _one_batch(dataset):
    from tsasr_torch.data.loader import SaveableDataLoader
    return next(iter(SaveableDataLoader(dataset, batch_size=1)))


def _plotted_attentions(brain, train_set, valid_set, out):
    from tsasr_torch.utils.stage import Stage
    batch = _one_batch(valid_set)
    brain.on_stage_start(Stage.VALID, 1)
    brain.evaluate_batch(batch, Stage.VALID)
    assert list((out / "images").glob("*/attention/*_attention_01.png"))


def _collected_embeddings(brain, train_set, valid_set, out):
    from tsasr_torch.utils.stage import Stage
    batch = _one_batch(valid_set)
    brain.on_stage_start(Stage.VALID, 1)
    brain.evaluate_batch(batch, Stage.VALID)
    assert list(brain.all_speaker_embs) == list(batch.id)


def _recorded_grad_norm(brain, train_set, valid_set, out):
    batch = _one_batch(train_set)
    brain.on_fit_batch_end(batch, None, brain.fit_batch(batch), False)
    assert brain.grad_norm == [brain.last_grad_norm] and \
        np.isfinite(brain.last_grad_norm)


@pytest.mark.parametrize("extra,check", [
    (["--profile"], _profiled),
    (["--plot_data", "True", "--image_formats", "[png]"], _plotted_data),
    (["--prompt_test", "True"], _prompted),
    (["--model_path", "{source}"], _warm_started),
    (["--plot_attentions", "True", "--image_formats", "[png]"],
     _plotted_attentions),
    (["--plot_embeddings", "True"], _collected_embeddings),
    (["--plot_grad_norm", "True"], _recorded_grad_norm),
], ids=["profile", "plot_data", "prompt_test", "model_path",
        "plot_attentions", "plot_embeddings", "plot_grad_norm"])
def test_lifted_switches_pass_the_checks_and_run(runs, corpus, tmp_path,
                                                 monkeypatch, extra, check):
    """Each switch that raised before this slice ported it passes the
    checks before anything runs, and does its part by the time ``fit``
    starts (the run is stopped there): ``--profile`` hooks a CPU
    profiler, ``plot_data`` writes a loaded example's images and WAVs,
    ``prompt_test`` prompts the mixtures, ``model_path`` loads the
    source's weights; the others run on one batch (attention maps
    plotted, embeddings collected, a gradient norm recorded)."""
    from tsasr_torch.recipes.librispeechmix import TSASRBrain, run_experiment
    from tsasr_torch.training.checkpoints import load_state, save_state
    out = tmp_path / "out"
    source = tmp_path / "source.ckpt"
    save_state({"model": load_state(os.path.join(
        runs["first_ckpts"][0][0], "brain.ckpt"))["model"]}, source)
    extra = [a.format(source=source) for a in extra]

    def fit(self, epoch_counter, train_set, valid_set, **kwargs):
        check(self, train_set, valid_set, out)
        raise _ReachedFit

    monkeypatch.setattr(TSASRBrain, "fit", fit)
    with pytest.raises(_ReachedFit):
        run_experiment(argv=argv(corpus, out, 1, *extra))


def test_model_path_warm_starts_and_recovery_takes_precedence(runs,
                                                              tmp_path):
    """A run with ``model_path`` (the first run's checkpoint) starts from
    the source's weights bit for bit (JAX collects the file and never
    loads it) and trains one step; run again in its own folder, the
    recovered checkpoint wins over the warm start."""
    from tsasr_torch.recipes.librispeechmix import TSASRBrain, run_experiment
    from tsasr_torch.training.checkpoints import load_state
    source = os.path.join(runs["first_ckpts"][0][0], "brain.ckpt")
    want = load_state(source)["model"]
    out = tmp_path / "warm"
    first_steps = []
    fit_batch = TSASRBrain.fit_batch

    def recording(self, batch):
        if not first_steps:
            first_steps.append({k: v.clone() for k, v in
                                self.model.state_dict().items()})
        return fit_batch(self, batch)

    TSASRBrain.fit_batch = recording
    try:
        warm = run_experiment(argv=argv(
            runs["corpus"], out, 1, "--model_path", source,
            "--optimizer_step_limit", "1", "--grad_accumulation_factor",
            "1", "--test_splits", "[]"))
    finally:
        TSASRBrain.fit_batch = fit_batch
    assert os.path.realpath(out / "save" / "model.ckpt") == \
        os.path.realpath(source)
    [start] = first_steps
    assert start.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(start[key], value), key
    assert warm.optimizer_step == 1
    trained = {k: v.clone() for k, v in warm.model.state_dict().items()}
    assert any(not torch.equal(trained[k], want[k]) for k in want)

    again = run_experiment(argv=argv(
        runs["corpus"], out, 1, "--model_path", source, "--test_only",
        "--test_splits", "[]"))
    assert again.optimizer_step == 1
    for key, value in again.model.state_dict().items():
        assert torch.equal(value, trained[key]), key


def test_missing_lm_file_raises_before_anything_runs(corpus, tmp_path):
    """LM fusion runs at TEST, after training: a missing ``lm_path``
    raises first."""
    from tsasr_torch.recipes.librispeechmix import run_experiment
    with pytest.raises(FileNotFoundError, match="lm_path"):
        run_experiment(argv=argv(corpus, tmp_path / "out", 1, "--lm_weight",
                                 "0.5", "--lm_path", str(tmp_path / "lm")))
    assert not (tmp_path / "out").exists()


def test_other_variants_raise(corpus, tmp_path):
    """A variant the recipe does not have raises before anything runs
    (``none`` and ``pretrained``: ``tests/test_torch_variants.py``)."""
    from tsasr_torch.recipes.librispeechmix import run_experiment
    with pytest.raises(ValueError, match="variant 'ecapa'"):
        run_experiment("ecapa", argv=argv(corpus, tmp_path / "out", 1))
    assert not (tmp_path / "out").exists()


def test_first_train_batch_loss_matches_jax_fit_batch(corpus, tmp_path):
    """Each package's pipeline gives its first TRAIN batch (the same
    batch, ``tests/test_torch_data.py``); the JAX model's initial
    parameters are converted into the port's model; both ``fit_batch``es
    at dropout 0 give the same loss and gradient norm."""
    import jax
    from tsasr_torch.convert import params_from_flax
    from tsasr_torch.data.loader import SaveableDataLoader
    from tsasr_tpu.data.loader import SaveableDataLoader as JaxLoader
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    from tsasr_tpu.recipes.librispeechmix import TSASRBrain as JaxBrain
    from tsasr_tpu.training.optimizers import make_adamw as jax_adamw

    th, _, tsets, tkw = package_pipeline("tsasr_torch", corpus,
                                         tmp_path / "torch")
    jh, _, jsets, jkw = package_pipeline("tsasr_tpu", corpus,
                                         tmp_path / "jax")
    batch = next(iter(SaveableDataLoader(tsets[0], **tkw["train"])))
    jbatch = next(iter(JaxLoader(jsets[0], **jkw["train"])))
    assert batch.id == jbatch.id

    config = dict(SMALL_MODEL, dropout=0.0, vocab_size=th["vocab_size"])
    jhparams = {k: v for k, v in jh.items()
                if k not in ("model", "checkpointer", "epoch_counter")}
    jbrain = JaxBrain(modules={"model": JaxTransducer(JaxConfig(**config))},
                      opt_class=jax_adamw(lr=1e-3), hparams=jhparams,
                      run_opts={"grad_accumulation_factor": 1},
                      variant="scratch")
    # the init compiled: the eager init's values, in a fraction of the time
    jbrain._init_params = jax.jit(jbrain._init_params)
    jbrain._ensure_initialized()
    params = jax.tree.map(lambda x: np.array(x, np.float32), jbrain.params)
    jbrain.init_optimizers()
    jbrain._jit_train_step = jbrain._build_train_step()
    assert np.isnan(jbrain.fit_batch(jbatch))   # JAX reads it a step late
    want_loss = jbrain._flush_pending_loss()

    brain = small_brain(th, dropout=0.0)
    brain.model.load_state_dict(params_from_flax(params))
    brain.grad_accumulation_factor = 1
    loss = brain.fit_batch(batch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(brain.last_grad_norm, jbrain.last_grad_norm,
                               rtol=1e-4)
    assert brain.optimizer_step == jbrain.optimizer_step == 1


def test_test_only_recovers_and_tests(runs):
    """``--test_only`` trains nothing: it recovers the best checkpoint and
    runs TEST."""
    from tsasr_torch.recipes.librispeechmix import run_experiment
    out = runs["root"] / "straight"
    before = (out / "train_log.txt").read_text()
    brain = run_experiment(argv=argv(str(runs["corpus"]), out, 2,
                                     "--test_only"))
    added = (out / "train_log.txt").read_text()[len(before):]
    assert added.startswith("Epoch loaded: 2 - test loss")
    assert "epoch:" not in added
    assert brain.optimizer_step == 3 and "train_stats" not in vars(brain)


def test_entry_module_debug_run(corpus, tmp_path):
    """``python -m tsasr_torch.train_librispeechmix_scratch`` with
    ``--debug``: 2 batches of 2 epochs, checkpoints diverted to a
    temporary folder (the reference's debug mode), TEST written."""
    import subprocess
    import sys
    from torch_port_helpers import REPO
    res = subprocess.run(
        [sys.executable, "-m", "tsasr_torch.train_librispeechmix_scratch",
         *argv(corpus, tmp_path / "out", 5, "--debug")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    log = (tmp_path / "out" / "train_log.txt").read_text()
    assert "epoch: 2, " in log and "epoch: 3, " not in log
    assert "steps: 1 " in log          # 4 micro-batches in 2 epochs
    assert (tmp_path / "out" / "wer_test-clean-2mix.txt").exists()
    assert not list((tmp_path / "out" / "save").glob("CKPT+*"))


def test_intra_epoch_checkpoint_by_steps(corpus, tmp_path):
    """``--ckpt_interval_steps 1``: after the 4th micro-batch (the first
    update) an intra-epoch checkpoint holds the epoch's position; the
    end-of-epoch checkpoint does not delete it."""
    import json
    from tsasr_torch.recipes.librispeechmix import run_experiment
    from tsasr_torch.training.checkpoints import load_state
    brain = run_experiment(argv=argv(corpus, tmp_path / "out", 1,
                                     "--ckpt_interval_steps", "1"))
    ckpts = brain.checkpointer.list_checkpoints()
    [inner] = [c for c in ckpts if c.meta.get("unfinished_epoch")]
    assert not inner.meta["end-of-epoch"] and len(ckpts) == 2
    state = load_state(inner.paramfile("brain"))
    assert (state["step"], state["mini_step"], state["optimizer_step"]) \
        == (4, 0, 1)
    with open(inner.paramfile("dataloader")) as f:
        assert json.load(f) == {"num_batches_yielded": 4}


def recorded_transcripts(brain):
    """{utterance id: transcript} of the run's TEST, as its WER file
    records them."""
    return {d["key"]: " ".join(d["hyp_tokens"])
            for d in brain.wer_metric.scores}


@pytest.fixture(scope="module")
def split_files(runs, tmp_path_factory):
    """The TEST split's mixtures as files, beside the corpus's
    enrollments."""
    tmp = tmp_path_factory.mktemp("test_split")
    _, _, datasets, _ = package_pipeline("tsasr_torch", runs["corpus"],
                                         tmp / "pipeline")
    return split_as_files(datasets[2], str(tmp / "wavs"))


def test_from_experiment_reproduces_the_test_transcripts(runs, split_files):
    """The resumed run's folder, loaded at its beam (its best checkpoint
    on WER, its tokenizer, its yaml), transcribes each TEST file as TEST
    did."""
    from tsasr_torch.inference import TSASRTranscriber
    out = runs["root"] / "resumed"
    want = recorded_transcripts(runs["second"])
    assert set(want) == set(split_files) and len(want) >= 6
    assert all(key in (out / "wer_test-clean-2mix.txt").read_text()
               for key in want)
    tr = TSASRTranscriber.from_experiment(str(out), beam_size=TEST_BEAM,
                                          device="cpu")
    assert tr.pad_feats_to == 32 and tr.searcher.beam_size == TEST_BEAM
    assert tr.pad_to_multiple["mixed_sig"] == 16000
    got = {key: tr.transcribe_file(mix, enroll_path=enroll)
           for key, (mix, enroll) in split_files.items()}
    assert got == want
    assert any(want.values())


def test_average_of_one_checkpoint_reproduces_it(runs, tmp_path):
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.tools import average_checkpoints
    from tsasr_torch.training.checkpoints import load_state
    save = runs["root"] / "resumed" / "save"
    best = runs["second"].checkpointer.find_checkpoint(min_key="WER")
    average_checkpoints.main([str(save), "--num", "1", "--out",
                              str(tmp_path / "avg.ckpt")])
    got, want = (load_state(p) for p in (tmp_path / "avg.ckpt",
                                         best.paramfile("brain")))
    assert got.keys() == want.keys() and got["model"].keys() \
        == want["model"].keys()
    for key, value in want["model"].items():
        assert torch.equal(got["model"][key], value), key
    assert got["optimizer_step"] == want["optimizer_step"]
    tr = TSASRTranscriber.from_experiment(
        str(runs["root"] / "resumed"), ckpt_path=str(tmp_path / "avg.ckpt"),
        device="cpu")
    for key, value in tr.model.state_dict().items():
        assert torch.equal(value, want["model"][key]), key


def test_transcribe_cli_prints_one_json_line_per_file(runs, split_files):
    import json
    import subprocess
    import sys
    from torch_port_helpers import REPO
    from tsasr_torch.tools import transcribe
    want = recorded_transcripts(runs["second"])
    keys = sorted(split_files)[:2]
    enroll = split_files[keys[0]][1]
    res = subprocess.run(
        [sys.executable, "-m", "tsasr_torch.tools.transcribe",
         "--experiment", str(runs["root"] / "resumed"),
         *(split_files[k][0] for k in keys), "--enroll", enroll,
         "--beam_size", str(TEST_BEAM), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(line) for line in res.stdout.splitlines()]
    assert [line["file"] for line in lines] == [split_files[k][0]
                                                for k in keys]
    # the first file's own enrollment: TEST's transcript
    assert lines[0]["text"] == want[keys[0]]
    # the run's model is not causal: its kv_cache stream would not be the
    # offline encode (tests/test_torch_streaming.py streams causal ones)
    with pytest.raises(ValueError, match="causal"):
        transcribe.main(["--experiment", str(runs["root"] / "resumed"),
                         split_files[keys[0]][0], "--enroll", enroll,
                         "--streaming", "--device", "cpu"])
