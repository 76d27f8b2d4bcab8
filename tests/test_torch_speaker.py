"""The port's speaker-recognition surface against the JAX package's.

- ``Xvector``, ``CosineClassifier`` and a standalone ``ECAPA_TDNN`` on the
  port's seeded weights and BatchNorm statistics away from their
  defaults, carried into flax (``convert.head_params_to_flax``,
  ``ecapa_params_to_flax``) and back bit for bit: outputs within 1e-5
  (f32, a few dozen ops) on ragged lengths; the x-vector's noise draws
  from an explicit generator;
- ``SpeakerRecognition`` from each of its three factories (the WavLM
  checkpoint directory both packages read; an ECAPA; a transducer's
  scratch speaker branch, the JAX fused attention in interpret mode):
  embeddings within 1e-4 of max |e| (1e-5 absolute on the WavLM and
  ECAPA, through the Conformer branch 1e-4), cosine scores within 1e-6
  and the same decisions, ``encode_file`` / ``verify_files`` on WAV
  files;
- ``EncoderClassifier`` over an ECAPA and a cosine head: log-probs within
  1e-5, the same indices and decoded labels (``classify_batch`` and
  ``classify_file``);
- ``AccuracyStats`` and ``BinaryMetricStats`` (EER, minDCF, threshold)
  equal to JAX's on the same inputs;
- ``tools.eval_speaker_verification``: the ``wavlm`` backend prints the
  JAX tool's JSON line on the same trials and checkpoint directory, its
  scores file (6 decimals) within 2e-6; the ``ecapa`` backend reads the port's file
  that ``convert.save_ecapa_from_flax`` writes from the JAX tool's
  msgpack payload, and prints the JAX tool's line;
- each entry point asks for the card by default, and raises without it.
"""

import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import REPO, TINY, write_float_wav
from tsasr_tpu.models import ecapa as jax_ecapa
from tsasr_torch.convert import (ecapa_params_from_flax,
                                 ecapa_params_to_flax, head_params_from_flax,
                                 head_params_to_flax, params_to_flax,
                                 save_ecapa_from_flax)
from tsasr_torch.data.encoder import CategoricalEncoder
from tsasr_torch.inference import EncoderClassifier, SpeakerRecognition
from tsasr_torch.models import ecapa, wavlm
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.ops.features import Fbank
from tsasr_torch.utils.metric_stats import AccuracyStats, BinaryMetricStats

SR = 16000
ATOL = 1e-5
SCORE_ATOL = 1e-6
BRANCH_RTOL = 1e-4    # a Conformer speaker branch: frontend + 1 layer
WAVLM_TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=48, conv_dim=[8] * 7,
                  num_conv_pos_embeddings=16,
                  num_conv_pos_embedding_groups=4, num_buckets=20,
                  max_bucket_distance=40, tdnn_dim=[16, 16, 24],
                  tdnn_kernel=[3, 3, 1], tdnn_dilation=[1, 2, 1],
                  xvector_output_dim=12)
# JAX's own test size of the ECAPA (tests/test_torch_ecapa.py)
ECAPA_CONFIG = dict(channels=(16, 16, 16, 16, 48), lin_neurons=24)
XVECTOR_CONFIG = dict(in_channels=80, tdnn_channels=(16, 16, 16, 16, 40),
                      lin_neurons=12)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("TSASR_ATTN_INTERPRET", "1")


def perturbed(module, seed):
    """``module`` with every FrozenBatchNorm's statistics and affine away
    from their defaults, and its biases drawn."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, ecapa.FrozenBatchNorm):
                m.mean.normal_(0, 0.2, generator=gen)
                m.var.uniform_(0.5, 2.0, generator=gen)
                m.weight.uniform_(0.8, 1.2, generator=gen)
                m.bias.normal_(0, 0.1, generator=gen)
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.normal_(0, 0.1, generator=gen)
    return module.eval()


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def _same_state(got, want):
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def waves(rng, n, seconds=(1.0, 0.8, 0.65)):
    return [(rng.normal(size=int(s * SR)) * 0.1).astype(np.float32)
            for s in seconds[:n]]


def batch_of(wavs):
    L = max(len(w) for w in wavs)
    out = np.zeros((len(wavs), L), np.float32)
    for i, w in enumerate(wavs):
        out[i, :len(w)] = w
    return out, np.array([len(w) / L for w in wavs], np.float32)


# ----------------------------------------------------------------- models
@pytest.mark.parametrize("lengths", [False, True])
def test_xvector_matches_jax(rng, lengths):
    model = perturbed(ecapa.Xvector(ecapa.XvectorConfig(**XVECTOR_CONFIG)),
                      seed=1)
    variables = head_params_to_flax(model.state_dict())
    _same_state(head_params_from_flax(variables), model.state_dict())
    jax_model = jax_ecapa.Xvector(jax_ecapa.XvectorConfig(**XVECTOR_CONFIG))
    x = rng.normal(size=(3, 60, 80)).astype(np.float32)
    rel = np.array([1.0, 0.8, 0.55], np.float32) if lengths else None
    want = jax.jit(jax_model.apply)(variables, jnp.asarray(x),
                                    None if rel is None else jnp.asarray(rel))
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    None if rel is None else torch.from_numpy(rel))
    assert got.shape == (3, 1, 12)
    _close(got, want)
    with torch.no_grad():
        noisy = [model(torch.from_numpy(x), None,
                       torch.Generator().manual_seed(7)) for _ in range(2)]
        clean = model(torch.from_numpy(x))
    assert torch.equal(noisy[0], noisy[1]) and not torch.equal(noisy[0],
                                                               clean)
    # noise of scale 1e-5 on the mean, through the output Linear
    bound = 6e-5 * model.out.weight.abs().sum(dim=1).max().item()
    assert (noisy[0] - clean).abs().max().item() < bound


@pytest.mark.parametrize("lin_blocks,shape", [(0, (4, 24)), (2, (4, 1, 24))])
def test_cosine_classifier_matches_jax(rng, lin_blocks, shape):
    model = perturbed(ecapa.CosineClassifier(24, 7, lin_blocks=lin_blocks,
                                             lin_neurons=16), seed=2)
    variables = head_params_to_flax(model.state_dict())
    _same_state(head_params_from_flax(variables), model.state_dict())
    jax_model = jax_ecapa.CosineClassifier(7, lin_blocks=lin_blocks,
                                           lin_neurons=16)
    x = rng.normal(size=shape).astype(np.float32)
    want = jax.jit(jax_model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == shape[:-1] + (7,)
    _close(got, want)


@pytest.fixture(scope="module")
def ecapa_pair():
    """(the port's standalone ECAPA, seeded and perturbed; its flax
    variables; the JAX module)."""
    with torch.random.fork_rng():
        torch.manual_seed(3)
        model = ecapa.ECAPA_TDNN(ecapa.ECAPAConfig(**ECAPA_CONFIG))
    model = perturbed(model, seed=3)
    variables = ecapa_params_to_flax(model.state_dict())
    return model, variables, jax_ecapa.ECAPA_TDNN(
        jax_ecapa.ECAPAConfig(**ECAPA_CONFIG))


def test_standalone_ecapa_converts_both_ways(ecapa_pair, rng):
    model, variables, jax_model = ecapa_pair
    _same_state(ecapa_params_from_flax(variables), model.state_dict())
    x = rng.normal(size=(3, 50, 80)).astype(np.float32)
    rel = np.array([1.0, 0.7, 0.5], np.float32)
    want = jax.jit(jax_model.apply)(variables, jnp.asarray(x),
                                    jnp.asarray(rel))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(rel))
    _close(got, want, 1e-4 * np.abs(np.asarray(want)).max())


# ------------------------------------------------------ speaker recognition
@pytest.fixture(scope="module")
def wavlm_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("wavlm_tiny")
    model = wavlm.WavLMForXVector(wavlm.WavLMConfig.from_hf_dict(WAVLM_TINY))
    wavlm.save_pretrained_xvector(model.init_weights(seed=4), str(path))
    return str(path)


def jitted(recognition):
    """A JAX ``SpeakerRecognition`` whose ``embed_fn`` runs compiled: the
    same computation, which eager JAX runs op by op (minutes here)."""
    recognition.embed_fn = jax.jit(recognition.embed_fn)
    return recognition


@pytest.fixture
def jax_tools_jit(monkeypatch):
    """The JAX tool's recognizers built as ``jitted`` ones."""
    from tsasr_tpu.inference import speaker as jax_speaker
    init = jax_speaker.SpeakerRecognition.__init__

    def compiled(self, embed_fn, *args, **kwargs):
        init(self, jax.jit(embed_fn), *args, **kwargs)

    monkeypatch.setattr(jax_speaker.SpeakerRecognition, "__init__",
                        compiled)


@pytest.fixture(scope="module")
def recognizers(wavlm_dir, ecapa_pair):
    """{backend: (the port's SpeakerRecognition on the CPU, the JAX
    one, the tolerance of the embeddings relative to their max)}."""
    from tsasr_tpu.inference import SpeakerRecognition as JaxRecognition
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    from tsasr_tpu.ops import Fbank as JaxFbank
    fbank_kw = dict(sample_rate=SR, n_fft=512, n_mels=80, win_length=32.0)
    model, variables, jax_model = ecapa_pair
    scratch = dict(TINY, dropout=0.0, speaker_encoder_layers=1)
    tsasr = TSTransducer(TSTransducerConfig(**scratch)).init_weights(seed=5)
    tsasr_params = {"params": params_to_flax(tsasr.state_dict())}
    jax_tsasr = JaxTransducer(JaxConfig(**scratch))
    jax_fbank = JaxFbank(**fbank_kw)
    return {
        "wavlm": (SpeakerRecognition.from_wavlm(wavlm_dir, device="cpu"),
                  jitted(JaxRecognition.from_wavlm(wavlm_dir)), ATOL),
        "ecapa": (SpeakerRecognition.from_ecapa(model, Fbank(**fbank_kw),
                                                device="cpu"),
                  jitted(JaxRecognition.from_ecapa(jax_model, variables,
                                                   jax_fbank)), ATOL),
        "tsasr": (SpeakerRecognition.from_tsasr(tsasr.eval(),
                                                Fbank(**fbank_kw),
                                                device="cpu"),
                  jitted(JaxRecognition.from_tsasr(jax_tsasr, tsasr_params,
                                                   jax_fbank)),
                  BRANCH_RTOL)}


@pytest.mark.parametrize("backend", ["wavlm", "ecapa", "tsasr"])
def test_speaker_recognition_matches_jax(recognizers, rng, tmp_path,
                                         backend):
    port, jax_rec, rtol = recognizers[backend]
    wavs1, rel1 = batch_of(waves(rng, 3))
    wavs2, rel2 = batch_of(waves(rng, 3, (0.7, 1.1, 0.9)))
    want = np.asarray(jax_rec.encode_batch(wavs1, rel1))
    got = port.encode_batch(wavs1, rel1)
    assert got.shape == want.shape and got.dim() == 2
    _close(got, want, rtol * np.abs(want).max())
    scores, same = port.verify_batch(wavs1, wavs2, rel1, rel2)
    want_scores, want_same = jax_rec.verify_batch(wavs1, wavs2, rel1, rel2)
    assert scores.dtype == np.float64
    _close(scores, want_scores, SCORE_ATOL)
    np.testing.assert_array_equal(same, np.asarray(want_same))
    paths = []
    for i, w in enumerate(waves(rng, 2, (0.9, 1.2))):
        paths.append(str(tmp_path / f"{i}.wav"))
        write_float_wav(paths[-1], w, SR)
    emb = port.encode_file(paths[0])
    assert isinstance(emb, np.ndarray) and emb.ndim == 1
    _close(emb, jax_rec.encode_file(paths[0]), rtol * np.abs(emb).max())
    score, decision = port.verify_files(*paths)
    want_score, want_decision = jax_rec.verify_files(*paths)
    assert abs(score - want_score) <= SCORE_ATOL
    assert decision == want_decision


def test_factories_leave_the_callers_modules_as_they_were(ecapa_pair, rng):
    """``from_ecapa`` and ``from_tsasr`` move nothing and switch no mode:
    a model left in training mode keeps it, and embeds exactly as in eval
    mode (``extract_speaker`` is deterministic, the ECAPA's BatchNorms
    frozen)."""
    fbank = Fbank(sample_rate=SR, n_fft=512, n_mels=80, win_length=32.0)
    tsasr = TSTransducer(TSTransducerConfig(**dict(
        TINY, dropout=0.1, speaker_encoder_layers=1))).init_weights(seed=5)
    wavs, rel = batch_of(waves(rng, 3))
    for make, model in ((SpeakerRecognition.from_ecapa, ecapa_pair[0]),
                        (SpeakerRecognition.from_tsasr, tsasr)):
        model.train()
        sr = make(model, fbank, device="cpu")
        got = sr.encode_batch(wavs, rel)
        assert model.training
        model.eval()
        assert torch.equal(got, sr.encode_batch(wavs, rel))


def test_encoder_classifier_matches_jax(ecapa_pair, recognizers, rng,
                                        tmp_path):
    from tsasr_tpu.data.encoder import CategoricalEncoder as JaxEncoder
    from tsasr_tpu.inference import EncoderClassifier as JaxClassifier
    head = perturbed(ecapa.CosineClassifier(24, 5), seed=6)
    head_vars = head_params_to_flax(head.state_dict())
    jax_head = jax_ecapa.CosineClassifier(5)
    port_rec, jax_rec, _ = recognizers["ecapa"]
    labels = ["ann", "bob", "cy", "dee", "eve"]
    encoders = []
    for cls in (CategoricalEncoder, JaxEncoder):
        enc = cls()
        enc.update_from_iterable(labels)
        encoders.append(enc)
    port = EncoderClassifier(port_rec.embed_fn, encoders[0], head,
                             device="cpu")
    jax_cls = JaxClassifier(jax_rec.embed_fn, encoders[1],
                            lambda e: jax_head.apply(head_vars, e))
    wavs, rel = batch_of(waves(rng, 3))
    got = port.classify_batch(wavs, rel)
    want = jax_cls.classify_batch(wavs, rel)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    assert got[2].tolist() == np.asarray(want[2]).tolist()
    assert got[3] == want[3] and set(got[3]) <= set(labels)
    _close(port.encode_batch(wavs, rel), jax_cls.encode_batch(wavs, rel))
    path = str(tmp_path / "x.wav")
    write_float_wav(path, waves(rng, 1)[0], SR)
    got, want = port.classify_file(path), jax_cls.classify_file(path)
    _close(got[0], want[0])
    assert got[1] == pytest.approx(want[1], abs=ATOL)
    assert got[2:] == want[2:]


# ------------------------------------------------------------- metrics
def test_accuracy_stats_match_jax(rng):
    from tsasr_tpu.utils.metric_stats import AccuracyStats as JaxAccuracy
    stats = [AccuracyStats(), JaxAccuracy()]
    for _ in range(3):
        log_probs = rng.normal(size=(4, 6, 5))
        targets = rng.integers(0, 5, size=(4, 6))
        lengths = rng.uniform(0.3, 1.0, size=4)
        for s in stats:
            s.append(log_probs, targets, lengths)
            s.append(log_probs[:, :2], targets[:, :2])
    assert (stats[0].correct, stats[0].total) \
        == (stats[1].correct, stats[1].total)
    assert stats[0].summarize() == stats[1].summarize()
    assert stats[0].summarize("accuracy") == stats[1].summarize("accuracy")
    stats[0].clear()
    assert stats[0].total == 0


@pytest.mark.parametrize("n_pos,n_neg", [(30, 70), (1, 5), (0, 4)])
def test_binary_metric_stats_match_jax(rng, n_pos, n_neg):
    from tsasr_tpu.utils.metric_stats import \
        BinaryMetricStats as JaxBinary
    scores = np.concatenate([rng.normal(0.6, 0.2, n_pos),
                             rng.normal(0.2, 0.2, n_neg)])
    labels = np.array([1] * n_pos + [0] * n_neg)
    results = []
    for cls in (BinaryMetricStats, JaxBinary):
        s = cls()
        for i in range(0, len(scores), 7):
            s.append([f"t{j}" for j in range(i, min(i + 7, len(scores)))],
                     scores[i:i + 7], labels[i:i + 7])
        results.append((s.summarize(), s.ids))
    assert results[0] == results[1]
    if n_pos and n_neg:
        assert set(results[0][0]) == {"EER", "minDCF", "threshold"}


# ------------------------------------------------------------------ tool
def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_speaker_verification",
        REPO / "tools" / "eval_speaker_verification.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _trials(tmp_path, rng):
    """Four speakers' files (a speaker's two files share a voice: the
    same noise filtered alike) and a trial list of same and other
    pairs."""
    paths = {}
    for spk in range(4):
        colour = rng.normal(size=16)
        for take in range(2):
            w = np.convolve(rng.normal(size=int(0.8 * SR)), colour,
                            "same") * 0.05
            paths[spk, take] = str(tmp_path / f"s{spk}_{take}.wav")
            write_float_wav(paths[spk, take], w.astype(np.float32), SR)
    lines = [f"1 {paths[s, 0]} {paths[s, 1]}" for s in range(4)]
    lines += [f"0 {paths[s, 0]} {paths[(s + 1) % 4, 1]}" for s in range(4)]
    lines += ["malformed line"]
    trials = tmp_path / "trials.txt"
    trials.write_text("\n".join(lines) + "\n")
    return str(trials)


def _run_tool(main, argv, capsys, monkeypatch=None):
    if monkeypatch is None:
        main(argv)
    else:
        monkeypatch.setattr("sys.argv", ["eval_speaker_verification.py",
                                         *argv])
        main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_tool_wavlm_backend_prints_the_jax_line(
        wavlm_dir, tmp_path, rng, capsys, monkeypatch, jax_tools_jit):
    from tsasr_torch.tools import eval_speaker_verification as tool
    trials = _trials(tmp_path, rng)
    args = ["--trials", trials, "--backend", "wavlm", "--model_path",
            wavlm_dir]
    want = _run_tool(_jax_tool().main, args + ["--out",
                                               str(tmp_path / "jax.txt")],
                     capsys, monkeypatch)
    got = _run_tool(tool.main, args + ["--out", str(tmp_path / "port.txt"),
                                       "--device", "cpu"], capsys)
    assert got == want and got["trials"] == 8
    rows = [[line.split() for line in (tmp_path / f"{n}.txt").read_text()
             .splitlines()] for n in ("port", "jax")]
    assert [r[:3] for r in rows[0]] == [r[:3] for r in rows[1]]
    _close(np.array([float(r[3]) for r in rows[0]]),
           np.array([float(r[3]) for r in rows[1]]), 2e-6)


def test_eval_tool_ecapa_backend_reads_the_converted_payload(
        ecapa_pair, tmp_path, rng, capsys, monkeypatch, jax_tools_jit):
    """The JAX tool's msgpack payload (config + params + batch_stats) is
    restored and written as the port's file by ``save_ecapa_from_flax``;
    both tools print the same line."""
    import flax.serialization
    from tsasr_torch.tools import eval_speaker_verification as tool
    _, variables, _ = ecapa_pair
    payload = {"config": {"channels": list(ECAPA_CONFIG["channels"]),
                          "lin_neurons": ECAPA_CONFIG["lin_neurons"]},
               **variables}
    msgpack = tmp_path / "ecapa.msgpack"
    msgpack.write_bytes(flax.serialization.msgpack_serialize(payload))
    restored = flax.serialization.msgpack_restore(msgpack.read_bytes())
    save_ecapa_from_flax(restored, str(tmp_path / "ecapa.pt"))
    loaded = tool.load_ecapa(str(tmp_path / "ecapa.pt"), 80)
    assert tuple(loaded.config.channels) == ECAPA_CONFIG["channels"]
    trials = _trials(tmp_path, rng)
    want = _run_tool(_jax_tool().main, ["--trials", trials, "--backend",
                                        "ecapa", "--model_path",
                                        str(msgpack)], capsys, monkeypatch)
    got = _run_tool(tool.main, ["--trials", trials, "--backend", "ecapa",
                                "--model_path", str(tmp_path / "ecapa.pt"),
                                "--device", "cpu"], capsys)
    assert got == want


def test_entry_points_ask_for_the_card(wavlm_dir, ecapa_pair, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from tsasr_torch.tools import eval_speaker_verification as tool
    model = ecapa_pair[0]
    fbank = Fbank(sample_rate=SR, n_fft=512, n_mels=80, win_length=32.0)
    for make in (lambda: SpeakerRecognition.from_wavlm(wavlm_dir),
                 lambda: SpeakerRecognition.from_ecapa(model, fbank),
                 lambda: SpeakerRecognition.from_tsasr(
                     TSTransducer(TSTransducerConfig(**TINY)), fbank),
                 lambda: SpeakerRecognition(lambda w, r: w),
                 lambda: EncoderClassifier(lambda w, r: w),
                 lambda: tool.main(["--trials", str(tmp_path / "none.txt"),
                                    "--model_path", wavlm_dir])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
