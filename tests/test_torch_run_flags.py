"""The recipe's run flags and last switches in the port against the JAX
package, on the CPU at tiny sizes:

- ``utils.profiling``: ``schedule`` and the ``Profiler``'s start / stop
  sequence equal the JAX module's for several (wait, warmup, active,
  repeat) over steps 1-30, ``report_time`` gives its text; a CPU
  profiler writes a Chrome trace when its window closes and when
  ``stop()`` ends an open one (the JAX recipe never stops its
  profiler);
- ``TSTransducer.encode_with_attn`` against JAX's on the tiny model
  (fused attention on, the port's seeded weights carried into flax):
  the output and every layer's maps at the encoder tolerance of
  ``tests/test_torch_models.py``, 1e-4;
- ``_strip_enroll_transcripts`` equal to the JAX recipe's method, both
  called unbound on a namespace, for ``prepend``, ``append`` and both;
- ``Pretrainer.collect_files`` as JAX's on a file, a directory and a
  missing source;
- a tiny experiment with ``--profile``, ``prompt_test`` and every
  ``plot_*`` writes its trace, both WER files and its images;
- a bf16 ``kv_cache`` stream of the tiny causal model against JAX's
  bf16 ``encode_stream`` and the port's offline bf16 encode, at the
  model tolerance of ``tests/test_torch_bf16.py`` (2^-5 of max |enc|);
  the bf16 streamer's tokens against the offline bf16 greedy.
"""

import functools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY, TORCH_YAML, corpus_vocab
from tsasr_tpu.recipes.librispeechmix import TSASRBrain as JaxBrain
from tsasr_tpu.utils import parameter_transfer as jax_transfer
from tsasr_tpu.utils import profiling as jax_profiling
from tsasr_torch.convert import params_to_flax
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.recipes.librispeechmix import TSASRBrain
from tsasr_torch.utils import parameter_transfer, profiling

ENC_ATOL = 1e-4
MODEL_TOL = 2.0 ** -5


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_logging_restored():
    """Torch on one thread: beside other test processes a multi-threaded
    op's wait for all its threads costs more than the op. The experiment
    points the root logger at its folder; the tests after these get it
    back as it was."""
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


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("TSASR_ATTN_INTERPRET", "1")


# ------------------------------------------------------------ profiling
class _FakeTrace:
    """Stands in for ``torch.profiler.profile``: records start / stop."""

    def __init__(self, events, **kwargs):
        self.events = events

    def start(self):
        self.events.append("start")

    def stop(self):
        self.events.append("stop")

    def export_chrome_trace(self, path):
        pass


@pytest.mark.parametrize("wait,warmup,active,repeat", [
    (2, 2, 2, 1), (0, 0, 1, 0), (1, 0, 3, 2), (5, 1, 2, 3), (3, 2, 1, 0)])
def test_schedule_and_profiler_actions_match_jax(monkeypatch, tmp_path,
                                                 wait, warmup, active,
                                                 repeat):
    want_fn = jax_profiling.schedule(wait, warmup, active, repeat)
    got_fn = profiling.schedule(wait, warmup, active, repeat)
    assert [got_fn(s) for s in range(1, 31)] == \
        [want_fn(s) for s in range(1, 31)]

    jax_events, events = [], []
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda logdir: jax_events.append("start"))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: jax_events.append("stop"))
    monkeypatch.setattr(torch.profiler, "profile",
                        functools.partial(_FakeTrace, events))
    want = jax_profiling.Profiler(str(tmp_path / "jax"), want_fn)
    got = profiling.Profiler(str(tmp_path / "port"), got_fn, device="cpu")
    for step in range(1, 31):
        want.step()
        got.step()
        assert events == jax_events, step
    assert got.step_num == want.step_num == 30


def test_report_time_matches_jax():
    want, got = jax_profiling.Profiler("x"), profiling.Profiler(
        "x", device="cpu")
    for name, seconds in (("fit_batch", 0.25), ("evaluate_batch", 0.125),
                          ("fit_batch", 0.5), ("fit_batch", 1.0 / 3)):
        want.record(name, seconds)
        got.record(name, seconds)
    assert profiling.report_time(got) == jax_profiling.report_time(want)
    assert profiling.report_time(got).startswith(
        "evaluate_batch: 1 calls, total 0.12s, mean 125.0ms\n")
    assert profiling.report_memory("cpu") == \
        "no device memory stats available"


def test_cpu_profiler_writes_its_traces(tmp_path):
    """A window that closes writes its trace, with the annotated regions;
    ``stop()`` writes a window still open. The default device is the
    card, which raises without one."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            profiling.Profiler(str(tmp_path / "card"))
    prof = profiling.Profiler(str(tmp_path / "closed"),
                              profiling.schedule(1, 0, 2, 1), device="cpu")
    brain = profiling.profile(SimpleNamespace(
        device=torch.device("cpu"),
        fit_batch=lambda x: torch.ones(8) @ x,
        evaluate_batch=lambda x: (x * 2).sum()), prof)
    for _ in range(2):
        brain.fit_batch(torch.ones(8))
        brain.evaluate_batch(torch.ones(8))
    [closed] = prof.traces
    assert os.path.basename(closed) == "trace_steps_2-3.json"
    with open(closed) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"fit_batch", "evaluate_batch"} <= names

    open_prof = profiling.Profiler(str(tmp_path / "open"),
                                   profiling.schedule(1, 0, 5, 1),
                                   device="cpu")
    brain = profiling.profile(SimpleNamespace(
        device=torch.device("cpu"), fit_batch=lambda x: x + 1), open_prof)
    for _ in range(3):
        brain.fit_batch(torch.ones(4))
    assert open_prof.traces == []
    open_prof.stop()
    [written] = open_prof.traces
    with open(written) as f:
        assert "fit_batch" in {e.get("name") for e in
                               json.load(f)["traceEvents"]}
    assert [t.name for t in open_prof.step_times] == ["fit_batch"] * 3


# ------------------------------------------------------- encode_with_attn
def test_encode_with_attn_matches_jax(rng):
    """Every layer's maps come from the plain path (JAX turns its fused
    path off for them); the output matches JAX's and the port's fused
    ``encode``, and each map's rows sum to 1."""
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    model = TSTransducer(TSTransducerConfig(**TINY)).init_weights(seed=3)
    params = {"params": params_to_flax(model.state_dict())}
    feats = rng.normal(size=(2, 41, 80)).astype(np.float32)
    rel = np.array([1.0, 0.7], np.float32)
    spk = rng.normal(size=(2, 1, TINY["d_model"])).astype(np.float32)
    want, want_maps = jax.jit(functools.partial(
        JaxTransducer(JaxConfig(**TINY)).apply, method="encode_with_attn"))(
        params, jnp.asarray(feats), jnp.asarray(rel), jnp.asarray(spk))
    args = [torch.from_numpy(x) for x in (feats, rel, spk)]
    with torch.no_grad():
        got, maps = model.eval().encode_with_attn(*args)
        fused = model.encode(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ENC_ATOL)
    np.testing.assert_allclose(got.numpy(), fused.numpy(), rtol=0,
                               atol=ENC_ATOL)
    assert len(maps) == len(want_maps) == TINY["encoder_num_layers"]
    for got_map, want_map in zip(maps, want_maps):
        assert got_map.shape == (2, TINY["nhead"], 11, 11)
        np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map),
                                   rtol=0, atol=ENC_ATOL)
        np.testing.assert_allclose(got_map.sum(-1).numpy(), 1.0, atol=1e-5)


# ------------------------------------------------------------ prompt_test
@pytest.mark.parametrize("mode", [["prepend"], ["append"],
                                  ["prepend", "append"]])
def test_strip_enroll_transcripts_matches_jax(mode):
    hyps = [["the", "cat", "sat", "on", "it"], ["a", "b"], ["only"],
            ["x", "y", "z"]]
    ids = ["u1", "u2", "u3", "u4"]
    enrolls = {"u1": ["the", "cat"], "u2": ["a", "b", "c"], "u3": ["one"],
               "u4": []}
    brain = SimpleNamespace(hparams=SimpleNamespace(
        prompt_mode=mode, enroll_transcriptions=enrolls))
    want = JaxBrain._strip_enroll_transcripts(brain, ids, hyps)
    got = TSASRBrain._strip_enroll_transcripts(brain, ids, hyps)
    assert got == want
    if mode == ["prepend"]:
        assert got[1] == [""]      # nothing left: the empty-string guard


# --------------------------------------------------------------- model_path
def test_collect_files_matches_jax(tmp_path):
    """A file is linked in as ``<name>.ckpt``; a directory resolves to its
    ``<name>.ckpt``; a directory without it and a missing source raise the
    same ``FileNotFoundError``."""
    src = tmp_path / "src"
    src.mkdir()
    torch.save({"w": torch.ones(2)}, src / "model.ckpt")
    torch.save({"w": torch.ones(2)}, src / "weights.pt")
    empty = tmp_path / "empty"
    empty.mkdir()
    for source in (src / "weights.pt", src):
        results = []
        for name, module in (("jax", jax_transfer), ("port",
                                                     parameter_transfer)):
            collect_in = tmp_path / name / source.name
            got = module.Pretrainer(collect_in=str(collect_in),
                                    paths={"model": str(source)}
                                    ).collect_files()
            target = collect_in / "model.ckpt"
            assert got == {"model": str(target)}
            results.append(os.path.realpath(target))
        resolved = source if source.is_file() else source / "model.ckpt"
        assert results == [os.path.realpath(resolved)] * 2
    for source in (empty, tmp_path / "missing.ckpt"):
        messages = []
        for module in (jax_transfer, parameter_transfer):
            with pytest.raises(FileNotFoundError) as err:
                module.Pretrainer(collect_in=str(tmp_path / "c"),
                                  paths={"model": str(source)}
                                  ).collect_files()
            messages.append(str(err.value))
        assert messages[0] == messages[1]


# --------------------------------------------------------- the experiment
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset
    root = tmp_path_factory.mktemp("corpus")
    make_dataset(str(root), n_mix=4, n_speakers=2, utts_per_speaker=3,
                 min_dur=0.8, max_dur=1.2, encode_text=True)
    return str(root)


def test_profiled_prompted_plotted_experiment(corpus, tmp_path):
    """``--profile`` with ``prompt_test`` (prepend) and every ``plot_*``
    switch on a debug run (3 batches a stage): the trace of JAX's default
    schedule (its window: the 5th and 6th profiled calls, VALID's last
    two) is written, TEST writes the enrollments' WER file and the
    split's, and the images are there."""
    from tsasr_torch.recipes.librispeechmix import run_experiment
    out = tmp_path / "out"
    brain = run_experiment(argv=[
        str(TORCH_YAML), "--data_folder", corpus, "--output_folder",
        str(out), "--device", "cpu", "--vocab_size",
        str(corpus_vocab(corpus)), "--num_epochs", "1", "--debug",
        "--debug_epochs", "1", "--debug_batches", "3", "--noprogressbar",
        "--encoder_num_layers",
        "1", "--d_ffn", "32", "--d_model",
        "16", "--nhead", "2", "--decoder_neurons", "16", "--joint_dim",
        "16", "--beam_size", "1", "--train_max_batch_length", "0.5",
        "--valid_max_batch_length", "0.5", "--test_max_batch_length", "0.5",
        "--profile", "--profile_dir", str(tmp_path / "trace"),
        "--prompt_test", "True", "--prompt_mode", "[prepend]",
        "--plot_data", "True", "--plot_attentions", "True",
        "--plot_embeddings", "True", "--plot_grad_norm", "True",
        "--image_formats", "[png]", "--dataloader_workers", "0"])
    [trace] = brain.profiler.traces
    assert os.path.basename(trace) == "trace_steps_5-6.json"
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "evaluate_batch" in names
    assert [t.name for t in brain.profiler.step_times] == \
        ["fit_batch"] * 3 + ["evaluate_batch"] * 9
    for name in ("wer_enrollments.txt", "wer_test-clean-2mix.txt"):
        assert (out / name).read_text().startswith("%WER"), name
    assert set(brain.hparams.enroll_transcriptions) == \
        {d["key"] for d in brain.wer_metric.scores}
    images = out / "images"
    assert (images / "grad_norm.png").exists()
    assert (images / "embeddings.png").exists()
    assert list(images.glob("*/attention/*_attention_01.png"))
    # plot_data: each loaded example, 3 a stage and 2 TEST passes
    assert len(list(images.glob("*/*_waveform.png"))) == 12
    assert len(list(images.glob("*/*_enrollment.wav"))) == 12
    assert len(brain.grad_norm) == 3


# -------------------------------------------------------------- bf16 stream
def test_bf16_kv_stream_matches_jax_encode_stream(rng):
    """The tiny causal model in bf16 (its caches in bf16, as JAX's
    ``init_stream_state`` builds them) streamed in chunks of 4 feature
    frames against JAX's bf16 ``encode_stream`` chunk by chunk and
    against the port's offline bf16 encode; then the bf16 ``kv_cache``
    and ``reencode`` streamers, the former's tokens against the offline
    bf16 greedy on the same features through the plain attention path
    (where the stream's attention rounds)."""
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    from test_torch_streaming import CAUSAL, PIECES, draw_biases
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_torch.decoding import TransducerGreedySearcher
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.ops.features import Fbank
    bf16 = torch.bfloat16
    state = draw_biases(TSTransducer(TSTransducerConfig(**CAUSAL))
                        .init_weights(seed=0), seed=1).state_dict()
    model = TSTransducer(TSTransducerConfig(**CAUSAL, dtype=bf16)).eval()
    model.load_state_dict(state)
    params = {"params": params_to_flax(state)}
    jax_model = JaxTransducer(JaxConfig(**CAUSAL, dtype=jnp.bfloat16))
    feats = rng.normal(size=(1, 32, 80)).astype(np.float32)
    spk = torch.from_numpy(rng.normal(size=(1, 1, 32)).astype(
        np.float32)).to(bf16)
    jax_spk = jnp.asarray(spk.float().numpy()).astype(jnp.bfloat16)

    jax_state = jax_model.apply(params, 1, 16, method="init_stream_state")
    assert all(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(jax_state)
               if x.ndim > 1)
    stream = jax.jit(functools.partial(jax_model.apply,
                                       method="encode_stream"))
    with torch.no_grad():
        offline = model.encode(torch.from_numpy(feats), torch.ones(1), spk)
        port_state = model.init_stream_state(1, 16)
        outs, jax_outs = [], []
        for lo in range(0, 32, 4):
            out, port_state = model.encode_stream(
                torch.from_numpy(feats[:, lo:lo + 4]), port_state, spk)
            jax_out, jax_state = stream(params, jnp.asarray(
                feats[:, lo:lo + 4]), jax_state, jax_spk)
            outs.append(out)
            jax_outs.append(np.asarray(jax_out, np.float32))
    got = torch.cat(outs, 1)
    assert got.dtype == bf16 and all(
        c.dtype == bf16 for c in port_state["frontend"])
    assert port_state["encoder"][0]["attn"]["k"].dtype == bf16
    want = np.concatenate(jax_outs, 1)

    def err(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return np.abs(a - b).max() / np.abs(b).max()

    assert err(got.float(), want) <= MODEL_TOL
    assert err(got.float(), offline.float()) <= MODEL_TOL

    wav = (rng.normal(size=16000) * 0.1).astype(np.float32)
    tr = TSASRTranscriber(model, None, CharTokenizer(PIECES), device="cpu")
    kv = tr.streaming("kv_cache", speaker_embs=spk)
    for lo in range(0, len(wav), 4000):
        kv.accept_chunk(wav[lo:lo + 4000])
    kv.finalize()
    re = tr.streaming("reencode", speaker_embs=spk)
    partials = [re.accept_chunk(wav[lo:lo + 8000])
                for lo in range(0, len(wav), 8000)]
    assert re.finalize().startswith(partials[-1]) and re._tokens
    raw = Fbank(sample_rate=16000, n_fft=512, n_mels=80,
                win_length=32.0)(torch.from_numpy(wav)[None])
    for module in model.modules():
        if hasattr(module, "fused"):
            module.fused = False
    with torch.no_grad():
        enc = model.encode(raw[:, :raw.shape[1] // 4 * 4], torch.ones(1),
                           spk)
    hyps, _, _, _ = TransducerGreedySearcher(model, 0)(enc, torch.ones(1))
    assert kv._tokens == hyps[0] and kv._tokens
