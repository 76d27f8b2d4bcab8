"""Serving a ``pretrained`` model: the port's ``TSASRTranscriber`` with
the frozen WavLM conditioning, against the JAX recipe's TEST path.

- The parity target is JAX's TEST path, not JAX's transcriber: the
  enrollments padded as the loader pads them, ``JaxSpeakerEncoder.embed``
  on them, the JAX model's ``project_external_speaker`` and ``encode``
  with the enrollments' relative lengths. Pooled d-vectors and
  ``cross_attention`` frames, greedy and the batched beam: identical
  transcripts, the encoder output within 1e-4 (f32 on both sides through
  a 2-layer WavLM and a 2-layer Conformer).
- JAX's transcriber encodes the same model with no conditioning at all,
  so its encoder output is another (the port's decided deviation).
- The stream of a ``cross_attention`` model, ``scratch`` and
  ``pretrained``, conditioned by ``speaker_embedding`` of an enrollment
  that is not a whole number of seconds: the stream attends only the
  valid frames, and equals the offline encode that masks the padded
  ones (the ``reencode`` history within 1e-5: the same ops; the
  ``kv_cache`` tokens of a causal model identical to offline greedy).
- ``from_experiment`` on a ``pretrained`` experiment folder, pooled and
  ``cross_attention``, builds the recipe's frozen encoder; the tool's
  ``--streaming --enroll`` conditions the stream; a folder whose yaml
  records precision bf16 (as a ``--precision bf16`` run writes it) is
  served with every attention call in bf16; a ``torch_cache`` yaml, a missing
  checkpoint directory and the default device without CUDA raise.

The JAX fused attention runs in Pallas interpret mode; the JAX applies
are jitted, and no JAX init runs (``params_to_flax`` carries the port's
seeded weights).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (TINY, TORCH_YAML, load_yaml, overrides,
                                write_float_wav)
from tsasr_torch.convert import params_to_flax
from tsasr_torch.data.tokenizer import CharTokenizer
from tsasr_torch.inference import TSASRTranscriber
from tsasr_torch.models import attention, wavlm
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.ops.features import Fbank, input_normalization
from tsasr_torch.recipes.speaker_embeddings import FrozenSpeakerEncoder

PIECES = ["<unk>", "▁"] + list("abcdefghijklmnopqrstuvwxyz'")
SR = 16000
ENC_ATOL = 1e-4       # f32 both sides, WavLM + frontend + 2 layers
STREAM_ATOL = 1e-5    # the same port ops; masked keys against cut ones
# the yaml's shape quantization (conformer-t_wavlm.yaml)
PAD_TO_MULTIPLE = {"mixed_sig": 16000, "enroll_sig": 16000}
PAD_FEATS_TO = 32
# a tiny WavLM with the published CNN's 7 kernels and strides (320
# samples a frame), 12-dimensional d-vectors, hidden 32
WAVLM_TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=48, conv_dim=[8] * 7,
                  num_conv_pos_embeddings=16,
                  num_conv_pos_embedding_groups=4, num_buckets=20,
                  max_bucket_distance=40, tdnn_dim=[16, 16, 24],
                  tdnn_kernel=[3, 3, 1], tdnn_dilation=[1, 2, 1],
                  xvector_output_dim=12)
# the speaker input width of each injection: the d-vector's, or the
# first 24 of the WavLM's 32 hidden channels
MODES = {"cat": 12, "cross_attention": 24}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("TSASR_ATTN_INTERPRET", "1")


@pytest.fixture(scope="module")
def wavlm_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("wavlm_tiny")
    model = wavlm.WavLMForXVector(wavlm.WavLMConfig.from_hf_dict(WAVLM_TINY))
    wavlm.save_pretrained_xvector(model.init_weights(seed=3), str(path))
    return str(path)


def pretrained_config(mode, **extra):
    return dict(TINY, dropout=0.0, use_speaker_encoder=False,
                speaker_embedding_dim=MODES[mode], injection_mode=mode,
                **extra)


def port_model(config, seed=1):
    model = TSTransducer(TSTransducerConfig(**config)).init_weights(seed)
    with torch.no_grad():
        model.transducer_head.bias[0] -= 1.0
    return model.eval()


def transcriber(model, wavlm_dir, beam=1, **kwargs):
    """A ``pretrained`` transcriber on the CPU, padding as the yaml does
    unless ``kwargs`` say otherwise."""
    mode = model.config.injection_mode
    encoder = FrozenSpeakerEncoder(wavlm_dir,
                                   frame_level=mode == "cross_attention",
                                   embedding_dim=MODES[mode], device="cpu")
    kwargs = dict(dict(pad_to_multiple=PAD_TO_MULTIPLE,
                       pad_feats_to=PAD_FEATS_TO), **kwargs)
    return TSASRTranscriber(model, None, CharTokenizer(PIECES),
                            beam_size=beam, variant="pretrained",
                            speaker_encoder=encoder, device="cpu", **kwargs)


def padded(wavs, multiple):
    length = -(-max(len(w) for w in wavs) // multiple) * multiple
    batch = np.zeros((len(wavs), length), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
    return batch, np.array([len(w) / length for w in wavs], np.float32)


@pytest.fixture(scope="module")
def audio():
    """Two mixtures and two enrollments of ragged lengths, none a whole
    number of seconds but the first mixture."""
    rng = np.random.default_rng(5)
    wavs = [(rng.normal(size=n) * 0.1).astype(np.float32)
            for n in (16000, 11000)]
    enrolls = [(rng.normal(size=n) * 0.1).astype(np.float32)
               for n in (12000, 19000)]
    return wavs, enrolls


@pytest.fixture(scope="module")
def jax_side(wavlm_dir):
    """Per injection mode: the port's model, the JAX model and weights,
    and the JAX TEST path's encode (the features, padded to
    ``pad_feats_to`` frames when given; the frozen encoder; the
    projection; the encoder), compiled once."""
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    from tsasr_tpu.ops import Fbank as JaxFbank
    from tsasr_tpu.ops import input_normalization as jax_norm
    from tsasr_tpu.ops.features import \
        pad_audio_to_frame_multiple as jax_pad
    from tsasr_tpu.recipes.speaker_embeddings import JaxSpeakerEncoder
    fbank = JaxFbank(sample_rate=SR, n_fft=512, n_mels=80, win_length=32.0)
    sides = {}
    for mode, dim in MODES.items():
        config = pretrained_config(mode)
        model = port_model(config)
        jax_model = JaxTransducer(JaxConfig(**config))
        params = {"params": params_to_flax(model.state_dict())}
        encoder = JaxSpeakerEncoder(wavlm_dir,
                                    frame_level=mode == "cross_attention",
                                    embedding_dim=dim)

        def test_encode(params, wav, rel, enroll, erel, pad_feats_to,
                        jax_model=jax_model, encoder=encoder):
            if pad_feats_to:
                wav, rel = jax_pad(wav, rel, pad_feats_to, SR,
                                   float(fbank.config.hop_length))
            feats = jax_norm(fbank(wav), rel)
            speaker = jax_model.apply(
                params, encoder.embed(enroll, erel),
                method=jax_model.project_external_speaker)
            return jax_model.apply(params, feats, rel, speaker, erel,
                                   method=jax_model.encode)

        sides[mode] = (model, jax_model, params,
                       jax.jit(test_encode, static_argnums=5))
    return sides


@pytest.mark.parametrize("mode,beam", [("cat", 1), ("cat", 3),
                                       ("cross_attention", 1),
                                       ("cross_attention", 3)])
def test_transcripts_match_the_jax_test_path(jax_side, wavlm_dir, audio,
                                             mode, beam):
    from tsasr_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
    from tsasr_tpu.decoding import BatchedBeamSearcher as JaxBeam
    from tsasr_tpu.decoding import TransducerGreedySearcher as JaxGreedy
    model, jax_model, params, test_encode = jax_side[mode]
    wavs, enrolls = audio
    batch, rel = padded(wavs, PAD_TO_MULTIPLE["mixed_sig"])
    ebatch, erel = padded(enrolls, PAD_TO_MULTIPLE["enroll_sig"])
    want_enc = test_encode(params, jnp.asarray(batch), jnp.asarray(rel),
                           jnp.asarray(ebatch), jnp.asarray(erel),
                           PAD_FEATS_TO)
    searcher = JaxGreedy(jax_model, params) if beam == 1 else \
        JaxBeam(jax_model, params, beam_size=beam)
    hyps = searcher(want_enc, jnp.asarray(rel))[0]
    tokenizer = JaxTokenizer(PIECES)
    want = [" ".join(tokenizer.decode_ids_to_words(h)) for h in hyps]

    tr = transcriber(model, wavlm_dir, beam)
    got_enc, got_rel = tr.encode_batch(wavs, enrolls)
    np.testing.assert_array_equal(got_rel.numpy(), rel)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc),
                               rtol=0, atol=ENC_ATOL)
    got = tr.transcribe_batch(wavs, enrolls)
    assert got == want and all(got)


def test_jax_transcriber_encodes_a_pretrained_model_unconditioned(
        jax_side, wavlm_dir, audio):
    """The JAX transcriber builds no speaker embedding for ``pretrained``
    (``inference/transcriber.py::_encode_impl``): on the same inputs its
    encoder output is the unconditioned encode, not TEST's conditioned
    one, which the port's transcriber gives (no padding on either
    side)."""
    from tsasr_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
    from tsasr_tpu.inference import TSASRTranscriber as JaxTranscriber
    model, jax_model, params, test_encode = jax_side["cat"]
    wavs, enrolls = audio
    args = [jnp.asarray(x) for x in (*padded(wavs, 1), *padded(enrolls, 1))]
    jax_tr = JaxTranscriber(jax_model, params, JaxTokenizer(PIECES),
                            variant="pretrained")
    dropped = np.asarray(jax_tr._encode(params, *args))
    unconditioned = np.asarray(jax_tr._encode(params, *args[:2], None,
                                              None))
    conditioned = np.asarray(test_encode(params, *args, None))
    np.testing.assert_array_equal(dropped, unconditioned)
    assert np.abs(dropped - conditioned).max() > 1e-2
    port = transcriber(model, wavlm_dir, pad_to_multiple=None,
                       pad_feats_to=None)
    np.testing.assert_allclose(port.encode_batch(wavs, enrolls)[0].numpy(),
                               conditioned, rtol=0, atol=ENC_ATOL)


# ------------------------------------------------------------- streaming
def causal_cross_models(wavlm_dir):
    """A causal ``cross_attention`` model of each variant with its
    transcriber (the yaml's padding)."""
    common = dict(injection_mode="cross_attention", causal_encoder=True,
                  frontend_causal=True)
    scratch = port_model(dict(TINY, dropout=0.0, **common))
    pretrained = port_model(pretrained_config(
        "cross_attention", causal_encoder=True, frontend_causal=True))
    return {
        "scratch": TSASRTranscriber(
            scratch, None, CharTokenizer(PIECES),
            pad_to_multiple=PAD_TO_MULTIPLE, pad_feats_to=PAD_FEATS_TO,
            device="cpu"),
        "pretrained": transcriber(pretrained, wavlm_dir)}


@pytest.mark.parametrize("variant", ["scratch", "pretrained"])
def test_cross_attention_stream_attends_only_the_valid_frames(
        wavlm_dir, audio, variant):
    """An enrollment of 1.1875 s padded to 2 s (and the scratch
    features to 32 frames): ``speaker_embedding``
    keeps the ``round(rel * S)`` valid frames; the stream's offline
    re-encode with them equals the encode that masks the padded frames,
    which attending every frame does not; the kv_cache stream's tokens
    equal offline greedy on the same features."""
    from tsasr_torch.decoding import TransducerGreedySearcher
    tr = causal_cross_models(wavlm_dir)[variant]
    model = tr.model
    wav, enroll = audio[0][0], audio[1][1]
    spk = tr.speaker_embedding(enroll)
    with torch.inference_mode():
        frames, erel = tr._speaker([enroll])
    S = frames.shape[1]
    if variant == "pretrained":     # the waveform's padding alone
        assert erel.item() == len(enroll) / 32000
    assert spk.shape[1] == round(erel.item() * S) < S
    torch.testing.assert_close(spk, frames[:, :spk.shape[1]], rtol=0,
                               atol=0)
    ones = torch.ones(1)
    wav_t = torch.from_numpy(wav)[None]
    with torch.inference_mode():
        feats = input_normalization(tr.fbank(wav_t), ones)
        masked = model.encode(feats, ones, frames, erel)
        unmasked = model.encode(feats, ones, frames)
        streamed = tr.streaming("reencode", speaker_embs=spk)._encode(wav_t)
    np.testing.assert_allclose(streamed.numpy(), masked.numpy(), rtol=0,
                               atol=STREAM_ATOL)
    assert (unmasked - masked).abs().max().item() > 1e-3

    kv = tr.streaming("kv_cache", speaker_embs=spk)
    for lo in range(0, len(wav), 4000):
        kv.accept_chunk(wav[lo:lo + 4000])
    kv.finalize()
    raw = Fbank(sample_rate=SR, n_fft=512, n_mels=80,
                win_length=32.0)(wav_t)
    t4 = raw.shape[1] // 4 * 4
    with torch.inference_mode():
        enc = model.encode(raw[:, :t4], ones, frames, erel)
    hyps = TransducerGreedySearcher(model, 0)(enc, ones)[0]
    assert kv._tokens == hyps[0] and hyps[0]


# ---------------------------------------------------------- experiments
def pretrained_experiment(folder, wavlm_dir, mode="cat", seed=0, **extra):
    """A ``pretrained`` experiment folder as the recipe writes one (the
    wavlm yaml with the overrides, the tokenizer, one checkpoint), a
    causal model at the yaml's small widths."""
    from tsasr_torch.training.checkpoints import (Checkpointer,
                                                  PytreeRecoverable)
    from tsasr_torch.utils.hparams import dump_resolved_yaml
    path = TORCH_YAML.with_name("conformer-t_wavlm.yaml")
    values = dict(causal_encoder=True, frontend_padding="causal",
                  speaker_encoder_path=wavlm_dir,
                  speaker_embedding_dim=MODES[mode], injection_mode=mode,
                  **extra)
    text = overrides("/data", folder, len(PIECES), **values)
    dump_resolved_yaml(str(path), text, str(folder / "hyperparams.yaml"))
    hp = load_yaml("tsasr_torch", folder / "hyperparams.yaml",
                   "data_folder: /data\n")
    model = hp["model"].init_weights(seed)
    with torch.no_grad():
        model.transducer_head.bias[0] -= 1.0
    CharTokenizer(PIECES).save(
        str(folder / "save" / f"char_{len(PIECES)}.json"))
    Checkpointer(str(folder / "save"), {"brain": PytreeRecoverable(
        lambda: {"model": model.state_dict()}, None)}).save_checkpoint(
        meta={"WER": 50.0})
    return model


@pytest.mark.parametrize("mode", sorted(MODES))
def test_from_experiment_builds_the_recipes_frozen_encoder(
        tmp_path, wavlm_dir, audio, mode):
    """The folder's yaml decides the encoder (frames under
    cross_attention, speaker_embedding_dim wide) and the padding; the
    transcripts are the same model's served by hand."""
    model = pretrained_experiment(tmp_path, wavlm_dir, mode)
    tr = TSASRTranscriber.from_experiment(str(tmp_path), device="cpu")
    assert tr.variant == "pretrained"
    enc = tr.speaker_encoder
    assert enc.frame_level == (mode == "cross_attention")
    assert enc.embedding_dim == MODES[mode]
    assert {k: tr.pad_to_multiple[k] for k in PAD_TO_MULTIPLE} \
        == PAD_TO_MULTIPLE
    assert tr.pad_feats_to == PAD_FEATS_TO
    by_hand = transcriber(model.eval(), wavlm_dir)
    wavs, enrolls = audio
    got, want = (t.encode_batch(wavs, enrolls)[0]
                 for t in (tr, by_hand))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tr.transcribe_batch(wavs, enrolls) \
        == by_hand.transcribe_batch(wavs, enrolls)
    spk = tr.speaker_embedding(enrolls[0])
    assert spk.shape[0] == 1 and spk.shape[-1] == model.config.d_model
    assert (spk.shape[1] == 1) == (mode == "cat")


def test_transcribe_streaming_conditions_a_pretrained_stream(
        tmp_path, capsys, wavlm_dir, audio):
    """``transcribe --streaming --enroll`` on a causal ``pretrained``
    experiment gives the stream conditioned by ``speaker_embedding``;
    without ``--enroll`` it raises; the offline CLI line is
    ``transcribe_file``'s."""
    from tsasr_torch.tools import transcribe
    pretrained_experiment(tmp_path, wavlm_dir)
    mix, enroll = str(tmp_path / "mix.wav"), str(tmp_path / "enroll.wav")
    write_float_wav(mix, audio[0][0], SR)
    write_float_wav(enroll, audio[1][0], SR)
    tr = TSASRTranscriber.from_experiment(str(tmp_path), device="cpu")
    s = tr.streaming(speaker_embs=tr.speaker_embedding(audio[1][0]))
    for lo in range(0, len(audio[0][0]), SR):
        s.accept_chunk(audio[0][0][lo:lo + SR])
    want = s.finalize()
    args = ["--experiment", str(tmp_path), mix, "--device", "cpu"]
    transcribe.main(args + ["--streaming", "--enroll", enroll])
    assert json.loads(capsys.readouterr().out) == {"file": mix,
                                                   "text": want}
    with pytest.raises(ValueError, match="speaker_embs"):
        transcribe.main(args + ["--streaming"])
    transcribe.main(args + ["--enroll", enroll])
    assert json.loads(capsys.readouterr().out) == {
        "file": mix, "text": tr.transcribe_file(mix, enroll_path=enroll)}


def test_bf16_experiment_serves_in_bf16(tmp_path, wavlm_dir, audio,
                                        monkeypatch):
    """A folder whose yaml records precision bf16 is served by the model
    rebuilt in bf16 as the recipe does: every attention call of a request
    is bf16; the frozen WavLM stays f32 and the projection takes its
    output, as at TEST. The yaml's fp32 serves in f32."""
    for precision in ("fp32", "bf16"):
        (tmp_path / precision).mkdir()
        pretrained_experiment(tmp_path / precision, wavlm_dir,
                              fused_attention=True, precision=precision)
    assert TSASRTranscriber.from_experiment(
        str(tmp_path / "fp32"), device="cpu").model.config.dtype \
        == torch.float32
    tr = TSASRTranscriber.from_experiment(str(tmp_path / "bf16"),
                                          device="cpu")
    assert tr.model.config.dtype == torch.bfloat16
    dtypes = []
    fused = attention.fused_relpos_attention

    def recording(*args, **kwargs):
        dtypes.append(args[0].dtype)
        return fused(*args, **kwargs)

    monkeypatch.setattr(attention, "fused_relpos_attention", recording)
    wavs, enrolls = audio
    enc, _ = tr.encode_batch(wavs, enrolls)
    assert enc.dtype == torch.bfloat16 and torch.isfinite(enc).all()
    assert dtypes and set(dtypes) == {torch.bfloat16}
    assert next(tr.speaker_encoder.model.parameters()).dtype \
        == torch.float32
    with torch.inference_mode():
        spk = tr.speaker_encoder.embed(*(torch.from_numpy(x) for x in
                                         padded(enrolls, 16000)))
    assert spk.dtype == torch.float32


@pytest.mark.parametrize("values,error,match", [
    ({"speaker_encoder_backend": "torch_cache"}, NotImplementedError,
     "torch_cache"),
    ({"speaker_encoder_backend": "jax",
      "speaker_encoder_path": "missing_dir"}, FileNotFoundError,
     "speaker_encoder_path"),
])
def test_from_experiment_raises_as_the_recipe_does(tmp_path, wavlm_dir,
                                                   values, error, match):
    pretrained_experiment(tmp_path, wavlm_dir)
    text = (tmp_path / "hyperparams.yaml").read_text()
    for key, value in values.items():
        if key == "speaker_encoder_path":
            value = str(tmp_path / value)
            text = text.replace(f"{key}: {wavlm_dir}", f"{key}: {value}")
        else:
            text = text.replace(f"{key}: auto", f"{key}: {value}")
    (tmp_path / "hyperparams.yaml").write_text(text)
    with pytest.raises(error, match=match):
        TSASRTranscriber.from_experiment(str(tmp_path), device="cpu")


def test_the_default_device_asks_for_the_card(tmp_path, wavlm_dir):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    pretrained_experiment(tmp_path, wavlm_dir)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSASRTranscriber.from_experiment(str(tmp_path))
    model = port_model(pretrained_config("cat"))
    encoder = FrozenSpeakerEncoder(wavlm_dir, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSASRTranscriber(model, None, CharTokenizer(PIECES),
                         variant="pretrained", speaker_encoder=encoder)
    with pytest.raises(ValueError, match="speaker_encoder"):
        TSASRTranscriber(model, None, CharTokenizer(PIECES),
                         variant="pretrained", device="cpu")
