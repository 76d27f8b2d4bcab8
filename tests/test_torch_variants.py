"""The ``none`` and ``pretrained`` recipes in the port, against the JAX
package where both run, and end to end on the CPU.

- one TRAIN micro-batch of each variant through ``TSASRBrain``
  (``compute_forward`` + ``compute_objectives``, the fused loss, dropout
  0) against the JAX ``TSASRBrain`` on the same weights (the port's
  seeded weights carried into flax by ``convert.params_to_flax``, so no
  JAX init runs): ``none`` without a speaker branch, ``pretrained`` with
  a tiny frozen WavLM from one checkpoint directory on both sides and
  its d-vectors through ``speaker_proj``. The loss within 1e-5, every
  gradient leaf within 1e-4 of its max |g| (as
  ``tests/test_torch_training.py``);
- external embeddings take precedence over enrollment features, and
  frame-level (B, S, E) embeddings condition a ``cross_attention``
  model, their padded frames masked;
- ``run_experiment("none")`` with ``--augment True`` trains, validates,
  tests and checkpoints, augmenting every TRAIN micro-batch and nothing
  else; a copy of its folder taken at its first intra-epoch checkpoint
  resumes to the same end-of-epoch state bit for bit;
  ``from_experiment`` transcribes with the ``none`` model;
- ``run_experiment("pretrained")`` with a seeded checkpoint directory and
  ``--augment True``: the WavLM stays frozen, outside the optimizer and
  the checkpoint; ``from_experiment`` loads the same frozen encoder and,
  through ``transcribe_file``, gives each TEST file the transcript TEST
  recorded (one utterance a TEST batch);
- the speaker backend resolves as the JAX recipe's; ``torch_cache`` (a
  hub id under ``auto``) and a missing directory raise before anything
  is written; ``cross_attention`` gets to training with frame-level
  embeddings.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import CORPUS, TINY, corpus_vocab
from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
from tsasr_tpu.recipes import librispeechmix as jax_recipe
from tsasr_tpu.utils.stage import Stage as JaxStage
from tsasr_torch.convert import params_to_flax
from tsasr_torch.data.batch import PaddedBatch
from tsasr_torch.data.tokenizer import CharTokenizer
from tsasr_torch.models import wavlm
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.recipes import librispeechmix
from tsasr_torch.recipes.speaker_embeddings import (FrozenSpeakerEncoder,
                                                    resolve_speaker_backend)
from tsasr_torch.training.brain import onednn_off_on_cpu
from tsasr_torch.utils.stage import Stage

PIECES = ["<unk>", "▁"] + list("abcdefghijklmnopqrstuvwxyz'")
HPARAMS = {"sample_rate": 16000, "n_fft": 512, "n_mels": 80,
           "win_length": 32, "augment": False, "blank_index": 0,
           "pad_feats_to": 32, "fused_joint_loss": True,
           "fused_loss_chunk": 3, "valid_search_freq": 1}
# a tiny WavLM with the published CNN's 7 kernels and strides (320
# samples a frame), 12-dimensional d-vectors
WAVLM_TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=48, conv_dim=[8] * 7,
                  num_conv_pos_embeddings=16,
                  num_conv_pos_embedding_groups=4, num_buckets=20,
                  max_bucket_distance=40, tdnn_dim=[16, 16, 24],
                  tdnn_kernel=[3, 3, 1], tdnn_dilation=[1, 2, 1],
                  xvector_output_dim=12)
MODELS = {
    "none": dict(TINY, dropout=0.0, injection_mode=None,
                 use_speaker_encoder=False),
    "pretrained": dict(TINY, dropout=0.0, use_speaker_encoder=False,
                       speaker_embedding_dim=12),
}
# the experiment at a width the CPU runs in seconds; 6 TRAIN
# micro-batches an epoch, accumulation 2
RUN_ARGS = ["--encoder_num_layers", "1", "--d_ffn", "64", "--d_model", "32",
            "--nhead", "4", "--decoder_neurons", "24", "--joint_dim", "48",
            "--beam_size", "1", "--valid_search_freq", "1",
            "--noprogressbar", "--train_max_batch_length", "8.0",
            "--grad_accumulation_factor", "2", "--augment", "True"]


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_logging_restored():
    """Torch on one thread (as ``tests/test_torch_experiment.py``), and
    the root logger back as it was after the experiments."""
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
def wavlm_dir(tmp_path_factory):
    """A tiny seeded WavLM x-vector checkpoint directory in HF names."""
    path = tmp_path_factory.mktemp("wavlm_tiny")
    model = wavlm.WavLMForXVector(wavlm.WavLMConfig.from_hf_dict(WAVLM_TINY))
    wavlm.save_pretrained_xvector(model.init_weights(seed=3), str(path))
    return str(path)


def make_batch(seed, n=2, samples=6000, tokens=5):
    rng = np.random.default_rng(seed)
    examples = []
    for b in range(n):
        toks = rng.integers(1, 29, size=tokens - b)
        examples.append({
            "id": f"utt{seed}-{b}",
            "mixed_sig": (rng.normal(size=samples - 1500 * b)
                          * 0.1).astype(np.float32),
            "enroll_sig": (rng.normal(size=5000 - 700 * b)
                           * 0.1).astype(np.float32),
            "tokens_bos": np.concatenate([[0], toks]).astype(np.int64),
            "tokens": toks.astype(np.int64),
            "target_words": ["".join(PIECES[t] for t in toks)]})
    return PaddedBatch(examples, padded_keys=["mixed_sig", "enroll_sig",
                                              "tokens_bos", "tokens"])


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("variant", sorted(MODELS))
def test_train_batch_matches_jax(variant, wavlm_dir):
    config = MODELS[variant]
    hparams = dict(HPARAMS)
    if variant == "pretrained":
        hparams.update(speaker_encoder_path=wavlm_dir,
                       speaker_encoder_backend="auto",
                       speaker_embedding_dim=12)
    model = TSTransducer(TSTransducerConfig(**config)).init_weights(seed=1)
    params = {"params": params_to_flax(model.state_dict())}
    assert ("speaker_proj" in params["params"]) == (variant != "none")
    assert "speaker_encoder" not in params["params"]
    brain = librispeechmix.TSASRBrain(
        modules={"model": model}, hparams=hparams,
        run_opts={"device": "cpu"}, variant=variant,
        tokenizer=CharTokenizer(PIECES))
    jbrain = jax_recipe.TSASRBrain(
        modules={"model": JaxTransducer(JaxConfig(**config))},
        hparams=hparams, variant=variant)
    assert (brain.speaker_encoder is None) == (variant == "none")
    assert (jbrain.speaker_encoder is None) == (variant == "none")

    batch = make_batch(2)
    arrays = jbrain.batch_to_arrays(batch)
    tensors = brain._put_batch(brain.batch_to_arrays(batch))
    assert set(tensors) == set(arrays)

    def loss_fn(p):
        preds = jbrain.compute_forward(p, arrays, JaxStage.TRAIN,
                                       jax.random.PRNGKey(0))
        return jbrain.compute_objectives(preds, arrays, JaxStage.TRAIN)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    names, leaves = zip(*brain.model.named_parameters())
    with onednn_off_on_cpu(brain.device):
        preds = brain.compute_forward(tensors, Stage.TRAIN,
                                      brain.step_generator())
        loss = brain.compute_objectives(preds, tensors, Stage.TRAIN)
        grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got, want = _flat(params_to_flax(dict(zip(names, grads)))), \
        _flat(want_grads["params"])
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-4 * np.abs(want[key]).max(),
                                   err_msg=key)


def test_external_embeddings_take_precedence():
    model = TSTransducer(TSTransducerConfig(
        **dict(TINY, dropout=0.0, speaker_embedding_dim=12))).init_weights(0)
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(2, 64, 80, generator=gen)
    rel = torch.tensor([1.0, 0.8])
    tokens = torch.tensor([[0, 3, 4], [0, 5, 0]])
    embs = torch.randn(2, 1, 12, generator=gen)
    # the model has a speaker encoder, so speaker_proj takes d_model
    assert model.speaker_proj.in_features == 32
    model = TSTransducer(TSTransducerConfig(
        **MODELS["pretrained"])).init_weights(0).eval()
    assert model.speaker_proj.in_features == 12
    with torch.no_grad():
        alone = model.encode_predict(feats, rel, tokens,
                                     external_speaker_embs=embs,
                                     enroll_rel_lens=rel)
        both = model.encode_predict(feats, rel, tokens, enroll_feats=feats,
                                    enroll_rel_lens=rel,
                                    external_speaker_embs=embs)
        other = model.encode_predict(feats, rel, tokens,
                                     external_speaker_embs=embs * 2)
    assert all(torch.equal(a, b) for a, b in zip(alone, both))
    assert not torch.equal(alone[0], other[0])
    # frame-level (B, S, E) embeddings condition a cross_attention model,
    # the frames past round(enroll_rel_lens * S) masked out
    cross = TSTransducer(TSTransducerConfig(**dict(
        MODELS["pretrained"], injection_mode="cross_attention")))
    cross = cross.init_weights(0).eval()
    frames = torch.randn(2, 5, 12, generator=gen)
    lens = torch.tensor([1.0, 0.6])
    moved = frames.clone()
    moved[1, 3:] += 1.0
    with torch.no_grad():
        enc = [cross.encode_predict(feats, rel, tokens,
                                    external_speaker_embs=f,
                                    enroll_rel_lens=lens)[0]
               for f in (frames, moved)]
        moved[1, 2] += 1.0
        seen = cross.encode_predict(feats, rel, tokens,
                                    external_speaker_embs=moved,
                                    enroll_rel_lens=lens)[0]
    assert enc[0].shape == (2, 16, TINY["joint_dim"])
    assert torch.equal(enc[0], enc[1])
    assert not torch.equal(enc[0][1], seen[1])
    assert torch.equal(enc[0][0], seen[0])


@pytest.mark.parametrize("backend,path,want", [
    ("auto", "checkpoint", "jax"),
    ("auto", "microsoft/wavlm-base-sv", "torch_cache"),
    ("auto", "", "torch_cache"),
    ("jax", "missing", "jax"),
    ("torch_cache", "checkpoint", "torch_cache"),
])
def test_speaker_backend_resolves_as_jax(wavlm_dir, tmp_path, backend, path,
                                         want):
    path = {"checkpoint": wavlm_dir,
            "missing": str(tmp_path / "missing")}.get(path, path)
    hparams = {"speaker_encoder_backend": backend,
               "speaker_encoder_path": path}
    assert resolve_speaker_backend(hparams) == want
    assert jax_recipe.resolve_speaker_backend(hparams) == want


# ------------------------------------------------------------ experiments
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset
    root = tmp_path_factory.mktemp("corpus")
    make_dataset(str(root), **CORPUS)
    return str(root)


def yaml_path(variant):
    from torch_port_helpers import REPO
    name = "wavlm" if variant == "pretrained" else variant
    return str(REPO / f"tsasr_torch/hparams/LibriSpeechMix/"
               f"conformer-t_{name}.yaml")


def argv(variant, corpus, out, *extra):
    return [yaml_path(variant), "--data_folder", corpus, "--output_folder",
            str(out), "--device", "cpu", "--vocab_size",
            str(corpus_vocab(corpus)), "--num_epochs", "1", *RUN_ARGS,
            *extra]


def train_state(brain):
    return {"model": {k: v.clone()
                      for k, v in brain.model.state_dict().items()},
            "moments": {k: {n: t.clone() for n, t in v.items()}
                        for k, v in
                        brain.optimizer.state_dict()["state"].items()},
            "counters": (brain.optimizer_step, brain.global_micro_step,
                         brain._mini_step)}


def assert_same_state(got, want):
    assert got["counters"] == want["counters"]
    assert got["model"].keys() == want["model"].keys()
    for key, value in want["model"].items():
        assert torch.equal(got["model"][key], value), key
    for key, state in want["moments"].items():
        for name, value in state.items():
            assert torch.equal(got["moments"][key][name], value), (key, name)


@pytest.fixture(scope="module")
def augmented_runs(corpus, tmp_path_factory, wavlm_dir):
    """The ``none`` experiment with augmentation on; a copy of its folder
    taken at its first intra-epoch checkpoint, resumed; the
    ``pretrained`` experiment. Records the augmentation calls per stage
    and each run's state at the end of TRAIN."""
    from tsasr_torch.recipes.librispeechmix import TSASRBrain, run_experiment
    root = tmp_path_factory.mktemp("variants")
    calls, ends = [], []
    patches = pytest.MonkeyPatch()
    for name in ("speed_perturb", "spec_augment"):
        fn = getattr(librispeechmix, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls.append((_name, brain_stage[0]))
            return _fn(*args, **kwargs)
        patches.setattr(librispeechmix, name, counted)
    brain_stage = [None]
    on_stage_start = TSASRBrain.on_stage_start
    fit_train = TSASRBrain._fit_train
    maybe_ckpt = TSASRBrain._maybe_intra_epoch_ckpt
    copied = []

    def stage_start(self, stage, epoch=None):
        brain_stage[0] = stage.name
        return on_stage_start(self, stage, epoch)

    def recording(self, train_set, epoch):
        fit_train(self, train_set, epoch)
        ends.append(train_state(self))

    def copy_first(self):
        maybe_ckpt(self)
        if not copied and self.optimizer_step == 1:
            out = root / "none"
            shutil.copytree(out, root / "resumed")
            copied.append((self.step, self.optimizer_step))

    patches.setattr(TSASRBrain, "on_stage_start", stage_start)
    patches.setattr(TSASRBrain, "_fit_train", recording)
    patches.setattr(TSASRBrain, "_maybe_intra_epoch_ckpt", copy_first)
    try:
        none = run_experiment("none", argv("none", corpus, root / "none",
                                           "--ckpt_interval_steps", "1"))
        none_calls = list(calls)
        resumed = run_experiment("none", argv("none", corpus,
                                              root / "resumed"))
        del calls[:]
        # TEST one utterance a batch: a file transcribed alone then sees
        # what TEST saw (its enrollment padded as in a batch of its own)
        pretrained = run_experiment("pretrained", argv(
            "pretrained", corpus, root / "pretrained",
            "--speaker_encoder_path", wavlm_dir,
            "--speaker_embedding_dim", "12",
            "--test_max_batch_length", "0.5"))
    finally:
        patches.undo()
    return {"root": root, "none": none, "none_calls": none_calls,
            "copied": copied, "resumed": resumed, "ends": ends,
            "pretrained": pretrained, "pretrained_calls": list(calls)}


def test_none_experiment_augments_every_train_micro_batch(augmented_runs):
    out = augmented_runs["root"] / "none"
    brain = augmented_runs["none"]
    log = (out / "train_log.txt").read_text()
    assert "epoch: 1" in log and "valid WER" in log
    assert "Epoch loaded: 1" in log
    assert (out / "wer_test-clean-2mix.txt").read_text().startswith("%WER")
    assert brain.model.speaker_proj is None \
        and brain.model.speaker_encoder is None
    assert brain.speaker_encoder is None
    calls = augmented_runs["none_calls"]
    assert calls == [("speed_perturb", "TRAIN"),
                     ("spec_augment", "TRAIN")] * 6
    # 6 micro-batches at accumulation 2
    assert augmented_runs["ends"][0]["counters"] == (3, 6, 0)


def test_augmented_run_resumes_inside_an_epoch_bit_for_bit(augmented_runs):
    """The copy taken after the first update (micro-batch 2) recovers that
    intra-epoch checkpoint and trains micro-batches 3-6 with the same
    draws: the end-of-TRAIN state equals the uninterrupted run's."""
    assert augmented_runs["copied"] == [(2, 1)]
    resumed = augmented_runs["resumed"]
    assert resumed._recovered_ckpt is not None
    straight_end, resumed_end = augmented_runs["ends"][:2]
    assert_same_state(resumed_end, straight_end)
    log = (augmented_runs["root"] / "resumed" / "train_log.txt").read_text()
    assert log.count("epoch: 1, ") == 1


def test_none_experiment_transcribes_from_its_folder(augmented_runs):
    from tsasr_torch.inference import TSASRTranscriber
    tr = TSASRTranscriber.from_experiment(
        str(augmented_runs["root"] / "none"), device="cpu")
    assert tr.variant == "none"
    wav = np.random.default_rng(0).normal(size=16000).astype(np.float32)
    enroll = np.random.default_rng(1).normal(size=8000).astype(np.float32)
    assert tr.transcribe(wav, enroll) == tr.transcribe(wav)


def test_pretrained_experiment_keeps_the_encoder_frozen(augmented_runs,
                                                       wavlm_dir):
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.training.checkpoints import load_state
    out = augmented_runs["root"] / "pretrained"
    brain = augmented_runs["pretrained"]
    assert isinstance(brain.speaker_encoder, FrozenSpeakerEncoder)
    _, loaded = wavlm.load_pretrained_xvector(wavlm_dir)
    for key, value in loaded.state_dict().items():
        assert torch.equal(brain.speaker_encoder.model.state_dict()[key],
                           value), key
    encoder_params = {id(p) for p in brain.speaker_encoder.model.parameters()}
    optimized = {id(p) for g in brain.optimizer.param_groups
                 for p in g["params"]}
    assert not encoder_params & optimized
    assert brain.model.speaker_proj.in_features == 12
    assert brain.model.speaker_encoder is None
    [ckpt] = brain.checkpointer.list_checkpoints()
    keys = load_state(ckpt.paramfile("brain"))["model"].keys()
    assert keys == brain.model.state_dict().keys()
    assert not any("wavlm" in k or "tdnn" in k for k in keys)
    assert augmented_runs["pretrained_calls"] == [
        ("speed_perturb", "TRAIN"), ("spec_augment", "TRAIN")] * 6
    assert (out / "wer_test-clean-2mix.txt").exists()
    # served, the folder loads the same frozen encoder, outside the model
    tr = TSASRTranscriber.from_experiment(str(out), device="cpu")
    for key, value in loaded.state_dict().items():
        assert torch.equal(tr.speaker_encoder.model.state_dict()[key],
                           value), key
    assert tr.model.state_dict().keys() == keys


def test_pretrained_experiment_transcribes_its_test_files_as_test_did(
        augmented_runs, tmp_path):
    """``from_experiment`` on the pretrained run's folder (its best
    checkpoint, tokenizer, yaml and frozen WavLM), through
    ``transcribe_file`` with each TEST mixture's enrollment file, gives
    the transcripts TEST recorded."""
    from torch_port_helpers import split_as_files
    from tsasr_torch.inference import TSASRTranscriber
    brain = augmented_runs["pretrained"]
    _, _, test_data = librispeechmix.dataio_prepare(vars(brain.hparams),
                                                    brain.tokenizer)
    files = split_as_files(test_data, str(tmp_path))
    want = {d["key"]: " ".join(d["hyp_tokens"])
            for d in brain.wer_metric.scores}
    assert set(want) == set(files) and len(want) >= 6
    tr = TSASRTranscriber.from_experiment(
        str(augmented_runs["root"] / "pretrained"), device="cpu")
    assert tr.variant == "pretrained" and not tr.speaker_encoder.frame_level
    got = {key: tr.transcribe_file(mix, enroll_path=enroll)
           for key, (mix, enroll) in files.items()}
    assert got == want
    assert any(want.values())


@pytest.mark.parametrize("extra,error,match", [
    ([], NotImplementedError, "transformers"),        # the yaml's hub id
    (["--speaker_encoder_backend", "torch_cache"], NotImplementedError,
     "torch_cache"),
    (["--speaker_encoder_backend", "jax", "--speaker_encoder_path",
      "missing_dir"], FileNotFoundError, "speaker_encoder_path"),
    (["--injection_mode", "cross_attention"], NotImplementedError,
     "injection_mode"),
])
def test_unported_speaker_paths_raise_before_anything_runs(
        corpus, tmp_path, wavlm_dir, monkeypatch, extra, error, match):
    if extra and extra[0] == "--injection_mode":
        # ported since: the run gets to training with the frozen encoder
        # giving frames (the first speaker_embedding_dim channels of the
        # last hidden state) to the cross-attention injection
        seen = {}

        def stop(brain, *args, **kwargs):
            seen["brain"] = brain
            raise KeyboardInterrupt

        monkeypatch.setattr(librispeechmix.TSASRBrain, "fit", stop)
        with pytest.raises(KeyboardInterrupt):
            librispeechmix.run_experiment("pretrained", argv(
                "pretrained", corpus, tmp_path / "out", *extra,
                "--speaker_encoder_path", wavlm_dir,
                "--speaker_embedding_dim", "24"))
        brain = seen["brain"]
        assert brain.model.encoder.speaker_attn is not None
        assert brain.model.speaker_proj.in_features == 24
        wav = torch.randn(2, 8000, generator=torch.Generator().manual_seed(0))
        frames = brain.speaker_encoder.embed(wav, torch.tensor([1.0, 0.5]))
        hidden = brain.speaker_encoder.model(wav, torch.tensor(
            [8000, 4000]))["hidden_states"][-1]
        assert frames.shape == (2, 24, 24) and hidden.shape[-1] == 32
        assert torch.equal(frames, hidden[..., :24])
        return
    with pytest.raises(error, match=match):
        librispeechmix.run_experiment("pretrained", argv(
            "pretrained", corpus, tmp_path / "out", *extra))
    assert not (tmp_path / "out").exists()


def test_yaml_copies_keep_the_jax_values():
    """The port's none and wavlm yamls hold the JAX yamls' keys and
    values, line for line, every class pointed at tsasr_torch (comments
    aside), plus the two lines of the model config that pass
    ``frontend_padding`` on as ``frontend_causal``, which the JAX yamls
    declare and never pass on."""
    from torch_port_helpers import REPO

    def values(path):
        lines = (REPO / path).read_text().replace(
            "tsasr_tpu", "tsasr_torch").splitlines()
        return [line.split(" #")[0].rstrip() for line in lines
                if line.strip() and not line.lstrip().startswith("#")]

    frontend_causal = [
        "    frontend_causal: "
        "!apply:tsasr_torch.models.frontend.causal_from_padding",
        "        padding: !ref <frontend_padding>"]
    for name in ("none", "wavlm"):
        port = values(f"tsasr_torch/hparams/LibriSpeechMix/conformer-t_"
                      f"{name}.yaml")
        i = port.index(frontend_causal[0])
        assert port[i:i + 2] == frontend_causal, name
        assert port[:i] + port[i + 2:] \
            == values(f"hparams/LibriSpeechMix/conformer-t_{name}.yaml"), \
            name
