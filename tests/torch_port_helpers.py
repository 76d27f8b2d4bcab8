"""Shared pieces of the tests that hold ``tsasr_torch`` against
``tsasr_tpu``: one tiny model in both packages with the same weights,
and one synthetic corpus run through both packages' data pipelines.

The JAX model is initialised from a fixed key, its params go through
``tsasr_torch.convert.params_from_flax`` into the port's model, and both
then see the same numpy inputs. Both sides compute in f32, so a single
op agrees to about 1e-5 and the whole encoder to about 1e-4.
"""

import importlib
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from tsasr_torch.convert import params_from_flax

# The slice at a width the CPU runs in seconds: 2 mixture layers,
# 1 speaker layer, fused attention on.
TINY = dict(d_model=32, nhead=4, encoder_num_layers=2, d_ffn=64,
            kernel_size=7, speaker_encoder_layers=1, decoder_neurons=32,
            joint_dim=48, frontend_channels=(8, 8), fused_attention=True)


def tiny_models(seed=0):
    """(jax model, numpy param tree, port model in eval mode)."""
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)

    jax_model = JaxTransducer(JaxConfig(**TINY))
    feats = jnp.zeros((1, 41, 80), jnp.float32)
    rel = jnp.ones((1,), jnp.float32)
    params = jax_model.init(jax.random.PRNGKey(seed), feats, rel,
                            jnp.zeros((1, 2), jnp.int32), feats, rel)
    params = jax.tree.map(lambda x: np.array(x, np.float32), params)
    # a blank bias below the others so random weights emit some tokens
    params["params"]["transducer_head"]["bias"][0] -= 1.0
    torch_model = TSTransducer(TSTransducerConfig(**TINY)).eval()
    torch_model.load_state_dict(params_from_flax(params))
    return jax_model, params, torch_model


REPO = Path(__file__).resolve().parents[1]
TORCH_YAML = REPO / "tsasr_torch/hparams/LibriSpeechMix/conformer-t_scratch.yaml"
JAX_YAML = REPO / "hparams/LibriSpeechMix/conformer-t_scratch.yaml"
SPLITS = ("train-2mix", "dev-clean-2mix", "test-clean-2mix")
# the synthetic corpus of tests/test_integration.py, with the transcripts
# coded into the waveforms
CORPUS = dict(n_mix=6, n_speakers=3, utts_per_speaker=4, min_dur=0.8,
              max_dur=1.6, encode_text=True)
# a model small enough that loading a yaml builds it in milliseconds
SMALL = {"d_model": 16, "nhead": 2, "encoder_num_layers": 1, "d_ffn": 16,
         "decoder_neurons": 8, "joint_dim": 8}


def corpus_vocab(folder):
    """Characters of the corpus + 1, the char tokenizer's vocab size."""
    chars = set()
    for split in SPLITS:
        with open(os.path.join(folder, f"{split}.jsonl")) as f:
            for line in f:
                for text in json.loads(line)["texts"]:
                    chars.update("▁" + text.replace(" ", "▁"))
    return len(chars) + 1


def overrides(data_folder, out, vocab, **extra):
    """A yaml override string: ``SMALL``, the folders and the vocab."""
    values = dict(SMALL, data_folder=data_folder, output_folder=str(out),
                  vocab_size=vocab, **extra)
    return "".join(f"{k}: {json.dumps(v)}\n" for k, v in values.items())


def load_yaml(package, path, text):
    load = importlib.import_module(f"{package}.utils.hparams") \
        .load_hyperpyyaml
    with open(path) as f:
        return load(f, text)


def package_pipeline(package, corpus, out):
    """(hparams, tokenizer, datasets, {stage: loader kwargs}) of one
    package, from its own scratch yaml, prepare, tokenizer and dataio,
    as its ``run_experiment`` builds them."""
    recipe = importlib.import_module(f"{package}.recipes.librispeechmix")
    data = importlib.import_module(f"{package}.data")
    yaml_path = TORCH_YAML if package == "tsasr_torch" else JAX_YAML
    hparams = load_yaml(package, yaml_path,
                        overrides(corpus, out, corpus_vocab(corpus)))
    data.prepare_librispeechmix(corpus, hparams["save_folder"],
                                splits=hparams["splits"],
                                num_enrolls=hparams["num_enrolls"])
    texts = []
    for split in ("train", "valid", "test"):
        with open(hparams[f"{split}_json"], encoding="utf-8") as f:
            texts.extend(e["wrd"] for e in json.load(f).values())
    tokenizer = data.train_tokenizer(
        hparams["save_folder"], texts, hparams["vocab_size"],
        model_type=hparams["token_type"], unk_id=hparams["blank_index"])
    args = (hparams, tokenizer) if package == "tsasr_torch" \
        else (hparams, tokenizer, "scratch")
    datasets = recipe.dataio_prepare(*args)
    kwargs = {stage: recipe.build_dataloader_kwargs(hparams, ds, stage)
              for stage, ds in zip(("train", "valid", "test"), datasets)}
    return hparams, tokenizer, datasets, kwargs


# A transducer's predictor and joint in both packages, for the beams: the
# port's seeded weights carried into a flax tree (``params_to_flax``), so
# no JAX init runs; the encoder output is drawn, not computed.
DECODER = dict(d_model=16, nhead=2, encoder_num_layers=1, d_ffn=16,
               kernel_size=7, frontend_channels=(4, 4), injection_mode=None,
               use_speaker_encoder=False, decoder_neurons=24, joint_dim=20,
               dropout=0.0)
# the beams' vocabulary: blank/unk, the word boundary and ten letters
DECODER_PIECES = ["<unk>", "▁"] + list("abcdefghij")


def decoder_models(seed=0):
    """(jax model, {"params": flax tree}, port model in eval mode) over
    ``DECODER_PIECES``, the blank's bias lowered so random weights emit."""
    import torch
    from tsasr_torch.convert import params_to_flax
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig

    config = dict(DECODER, vocab_size=len(DECODER_PIECES))
    model = TSTransducer(TSTransducerConfig(**config)).init_weights(seed)
    with torch.no_grad():
        model.transducer_head.bias[0] -= 1.0
    params = {"params": params_to_flax(model.state_dict())}
    return JaxTransducer(JaxConfig(**config)), params, model.eval()


def encoder_output(batch=3, frames=14, seed=0):
    """A drawn (B, T, joint_dim) encoder output and relative lengths
    (the first full, the others shorter), as numpy."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(batch, frames, DECODER["joint_dim"]))
    rel = np.linspace(1.0, 0.5, batch)
    return enc.astype(np.float32), rel.astype(np.float32)


# f32 on both sides, one LSTM step and one joint per expansion
SCORE_ATOL = 1e-5


def assert_same_beams(got, want):
    """(tokens, lengths, normalized scores) of both packages: the same
    live hypotheses (scores above -1e20) with identical tokens, and
    their scores within SCORE_ATOL."""
    tokens, lengths, scores = (np.asarray(x) for x in got)
    w_tokens, w_lengths, w_scores = (np.asarray(x) for x in want)
    live = w_scores > -1e20
    np.testing.assert_array_equal(scores > -1e20, live)
    np.testing.assert_array_equal(np.where(live, lengths, 0),
                                  np.where(live, w_lengths, 0))
    np.testing.assert_array_equal(tokens[live], w_tokens[live])
    np.testing.assert_allclose(scores[live], w_scores[live], rtol=0,
                               atol=SCORE_ATOL)
    assert live[:, 0].all()


def write_float_wav(path, wav, sample_rate):
    """A 32-bit IEEE-float WAV: the port's ``read_audio`` (its native
    decoder) reads it back bit for bit, peaks above full scale included,
    which no PCM file holds."""
    import struct
    data = np.ascontiguousarray(wav, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, sample_rate, 4 * sample_rate, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 20 + len(fmt) + len(data))
                + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def split_as_files(dataset, folder, sample_rate=16000):
    """Each utterance of a TEST dataset as files: {id: (mixture WAV, the
    corpus's enrollment file)}. The mixture (mixed on the fly by the data
    pipeline) is written as a float WAV and must read back exactly."""
    from tsasr_torch.data.audio import read_audio
    os.makedirs(folder, exist_ok=True)
    files = {}
    for i in range(len(dataset)):
        item, raw = dataset[i], dataset.raw(i)
        path = os.path.join(folder, f"mix{i}.wav")
        write_float_wav(path, item["mixed_sig"], sample_rate)
        read, sr = read_audio(path)
        if sr != sample_rate or not np.array_equal(read, item["mixed_sig"]):
            raise RuntimeError(f"{path} does not read back exactly")
        files[item["id"]] = (path, raw["enroll_wav"])
    return files
