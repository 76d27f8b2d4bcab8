"""The whole serving slice: the JAX ``TSASRTranscriber`` (greedy, fused
attention in interpret mode) and the port's ``TSASRTranscriber`` on the
CPU, with the same weights, give the same transcripts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY, tiny_models
from tsasr_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
from tsasr_tpu.inference import TSASRTranscriber as JaxTranscriber
from tsasr_torch.data.tokenizer import CharTokenizer
from tsasr_torch.inference import TSASRTranscriber
from tsasr_torch.models.transducer import (TSTransducer,
                                           TSTransducerConfig,
                                           scratch_config)

PIECES = ["<unk>", "▁"] + list("abcdefghijklmnopqrstuvwxyz'")
RECIPE = "hparams/LibriSpeechMix/conformer-t_scratch.yaml"


def test_transcripts_identical_to_jax(rng, monkeypatch):
    """Two ragged mixtures with ragged enrollments. Transcripts must be
    identical; the encoder outputs agree to 1e-4 (f32 on both sides,
    through 3 Conformer layers and 2 frontends)."""
    monkeypatch.setenv("TSASR_ATTN_INTERPRET", "1")
    jax_model, params, model = tiny_models()
    wavs = [(rng.normal(size=n) * 0.1).astype(np.float32)
            for n in (16000, 11000)]
    enrolls = [(rng.normal(size=n) * 0.1).astype(np.float32)
               for n in (12000, 19000)]

    jax_tr = JaxTranscriber(jax_model, params, JaxTokenizer(PIECES))
    port = TSASRTranscriber(model, None, CharTokenizer(PIECES),
                            device="cpu")
    want = jax_tr.transcribe_batch(wavs, enrolls)
    got = port.transcribe_batch(wavs, enrolls)
    assert got == want
    assert all(got)

    batch = np.zeros((2, 16000), np.float32)
    ebatch = np.zeros((2, 19000), np.float32)
    for i, (w, e) in enumerate(zip(wavs, enrolls)):
        batch[i, :len(w)] = w
        ebatch[i, :len(e)] = e
    rel = np.array([1.0, 11000 / 16000], np.float32)
    erel = np.array([12000 / 19000, 1.0], np.float32)
    want_enc = jax_tr._encode(params, jnp.asarray(batch), jnp.asarray(rel),
                              jnp.asarray(ebatch), jnp.asarray(erel))
    got_enc, got_rel = port.encode_batch(wavs, enrolls)
    np.testing.assert_array_equal(got_rel.numpy(), rel)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc),
                               atol=1e-4)
    assert port.transcribe(wavs[1], enrolls[1]) \
        == jax_tr.transcribe(wavs[1], enrolls[1])


def test_scratch_config_matches_recipe_yaml():
    from tsasr_tpu.utils.hparams import load_hyperpyyaml

    with open(RECIPE) as f:
        hp = load_hyperpyyaml(f, overrides={"data_folder": "unused"},
                              overrides_must_match=False)
    recipe = hp["model_config"]
    config = scratch_config()
    for field in config.__dataclass_fields__:
        if field == "fused_attention":
            continue
        if field == "dtype":            # torch's f32 and jnp's, by name
            assert str(config.dtype) == f"torch.{np.dtype(recipe.dtype)}"
            continue
        assert getattr(config, field) == getattr(recipe, field), field
    assert config.fused_attention        # the slice runs the kernel
    assert recipe.speaker_encoder_type == "conformer"
    assert recipe.joint_mode == "sum" and not recipe.causal_encoder
    # the transcriber's feature defaults are the recipe's
    defaults = TSASRTranscriber.__init__.__defaults__
    names = TSASRTranscriber.__init__.__code__.co_varnames[4:]
    kw = dict(zip(names, defaults))
    for key in ("sample_rate", "n_fft", "n_mels", "win_length",
                "blank_index"):
        assert kw[key] == hp[key], key


def test_unported_options_raise(tmp_path):
    """Streaming a model with a speaker branch wants its speaker
    embedding (``tests/test_torch_streaming.py`` streams); beam search
    and LM fusion are ported (the batched beam, the LM loaded where the
    transcriber runs), and ``from_experiment`` wants an experiment
    folder."""
    from tsasr_torch.decoding import BatchedBeamSearcher
    from tsasr_torch.models.lm import RNNLM, RNNLMConfig, save_lm_checkpoint
    model = TSTransducer(TSTransducerConfig(**TINY)).init_weights(seed=0)
    tok = CharTokenizer(PIECES)
    port = TSASRTranscriber(model, None, tok, device="cpu")
    with pytest.raises(ValueError, match="speaker_embs"):
        port.streaming()
    with pytest.raises(FileNotFoundError):
        TSASRTranscriber.from_experiment(str(tmp_path / "exp"), device="cpu")
    assert isinstance(port.transcribe(np.zeros(8000, np.float32)), str)
    assert next(model.parameters()).device == torch.device("cpu")
    save_lm_checkpoint(RNNLM(RNNLMConfig(vocab_size=len(PIECES),
                                         embedding_dim=4, hidden_size=4,
                                         num_layers=1, dnn_neurons=4)),
                       tmp_path / "lm.ckpt")
    beam = TSASRTranscriber(model, None, tok, beam_size=4, device="cpu",
                            lm_path=str(tmp_path / "lm.ckpt"), lm_weight=0.5)
    assert isinstance(beam.searcher, BatchedBeamSearcher)
    assert (beam.searcher.beam_size, beam.searcher.lm_weight) == (4, 0.5)
    assert isinstance(beam.transcribe(np.zeros(8000, np.float32)), str)


def test_beam_transcripts_identical_to_jax(rng, monkeypatch):
    """The JAX transcriber at beam 4 (its batched beam, fused attention
    in interpret mode) and the port's, with the same weights: the same
    transcripts."""
    monkeypatch.setenv("TSASR_ATTN_INTERPRET", "1")
    jax_model, params, model = tiny_models()
    wavs = [(rng.normal(size=n) * 0.1).astype(np.float32)
            for n in (12000, 9000)]
    enrolls = [(rng.normal(size=n) * 0.1).astype(np.float32)
               for n in (10000, 14000)]
    want = JaxTranscriber(jax_model, params, JaxTokenizer(PIECES),
                          beam_size=4).transcribe_batch(wavs, enrolls)
    got = TSASRTranscriber(model, None, CharTokenizer(PIECES), beam_size=4,
                           device="cpu").transcribe_batch(wavs, enrolls)
    assert got == want and all(got)


def test_tokenizer_matches_jax(tmp_path):
    text = "hello  world it's a test"
    jax_tok = JaxTokenizer(PIECES)
    tok = CharTokenizer(PIECES)
    ids = jax_tok.encode_as_ids(text)
    assert tok.decode_ids(ids) == jax_tok.decode_ids(ids) == \
        "hello world it's a test"
    assert tok.decode_ids_to_words([]) == jax_tok.decode_ids_to_words([])
    jax_tok.save(str(tmp_path / "char_29.json"))
    loaded = CharTokenizer.load(str(tmp_path / "char_29.json"))
    assert loaded.pieces == PIECES and loaded.unk_id == 0
    assert loaded.decode_ids_to_words(ids) == ["hello", "world", "it's",
                                               "a", "test"]
