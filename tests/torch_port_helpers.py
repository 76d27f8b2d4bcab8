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
