"""The banded joint and loss in the port against the JAX package, a
``cross_attention`` stream, and the switched experiment end to end.

- ``band_centers`` gives the JAX function's integers exactly, ties
  (t * U / (T - 1) on a half) included;
- ``rnnt_loss_banded`` against the JAX function, a band that covers the
  lattice and a narrow one (one jitted JAX value-and-grad for both):
  the losses within 1e-5 relative, the gradients within 1e-4 of their
  max |g|; the covering band equals the full ``rnnt_loss`` (loss and
  gradients), the narrow one gives a loss no smaller;
- ``joint_logits_banded`` equals the full joint gathered at the band;
- a causal ``cross_attention`` model streams (``kv_cache``, the speaker
  frames of ``speaker_embedding``) to the offline greedy tokens;
- ``run_experiment`` with ``--speaker_encoder_type ecapa --remat True
  --joint_band_width 8`` trains (remat and the banded loss on the path),
  recovers its checkpoint for a second epoch, and tests; its folder
  transcribes through ``from_experiment``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CORPUS, TORCH_YAML, corpus_vocab
from tsasr_torch.data.tokenizer import CharTokenizer
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.ops.rnnt_loss import rnnt_loss
from tsasr_torch.ops.rnnt_loss_banded import band_centers, rnnt_loss_banded

jax_banded = importlib.import_module("tsasr_tpu.ops.rnnt_loss_banded")


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_logging_restored():
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


def test_band_centers_match_jax_with_ties():
    rng = np.random.default_rng(0)
    t_lens = np.concatenate([[3, 5, 9, 2, 1], rng.integers(1, 60, 20)])
    u_lens = np.concatenate([[3, 1, 7, 5, 0], rng.integers(0, 30, 20)])
    # t * u / (t_len - 1) on a half: 1 * 3 / 2, 2 * 1 / 4, 4 * 7 / 8, ...
    ties = [(t * u) / max(tl - 1, 1) % 1 == 0.5 for tl, u in
            zip(t_lens[:3], u_lens[:3]) for t in range(tl)]
    assert sum(ties) >= 3
    for T, W in ((60, 4), (64, 8), (60, 64), (60, 1)):
        want = np.asarray(jax_banded.band_centers(
            jnp.asarray(t_lens, jnp.int32), jnp.asarray(u_lens, jnp.int32),
            T, W))
        got = band_centers(torch.from_numpy(t_lens),
                           torch.from_numpy(u_lens), T, W)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def lattice(rng, B=3, T=12, U=5, V=7):
    logits = rng.normal(size=(B, T, U + 1, V)).astype(np.float32)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    t_lens = np.array([T, T - 3, T - 5], np.int32)
    u_lens = np.array([U, U - 2, U - 1], np.int32)
    return logits, labels, t_lens, u_lens


def band_of(full, centers, W):
    """(B, T, W, V) logits of the full (B, T, U+1, V) at the band."""
    idx = np.clip(centers[:, :, None] + np.arange(W), 0, full.shape[2] - 1)
    return np.take_along_axis(full, idx[..., None], axis=2)


def test_banded_loss_matches_jax_and_the_full_loss(rng):
    logits, labels, t_lens, u_lens = lattice(rng)
    T, U1 = logits.shape[1], logits.shape[2]
    bands = {}
    for W in (U1 + 2, 3):
        centers = np.asarray(band_centers(torch.from_numpy(t_lens),
                                          torch.from_numpy(u_lens), T, W))
        bands[W] = (band_of(logits, centers, W), centers)

    def jax_losses(*band_logits):
        return [jax_banded.rnnt_loss_banded(
            x, jnp.asarray(labels), jnp.asarray(bands[W][1]),
            jnp.asarray(t_lens), jnp.asarray(u_lens), reduction="sum")
            for x, W in zip(band_logits, bands)]

    inputs = [jnp.asarray(b[0]) for b in bands.values()]
    want, pullback = jax.vjp(jax.jit(jax_losses), *inputs)
    want_grads = jax.jit(pullback)([jnp.ones(()), jnp.ones(())])
    got = {}
    for (W, (x, centers)), w, wg in zip(bands.items(), want, want_grads):
        x = torch.from_numpy(x).requires_grad_(True)
        loss = rnnt_loss_banded(x, torch.from_numpy(labels),
                                torch.from_numpy(centers),
                                torch.from_numpy(t_lens),
                                torch.from_numpy(u_lens), reduction="sum")
        (grad,) = torch.autograd.grad(loss, x)
        np.testing.assert_allclose(loss.item(), float(w), rtol=1e-5)
        wg = np.asarray(wg)
        np.testing.assert_allclose(grad.numpy(), wg, rtol=0,
                                   atol=1e-4 * np.abs(wg).max())
        got[W] = (loss, grad, centers)

    full = torch.from_numpy(logits).requires_grad_(True)
    loss = rnnt_loss(full, torch.from_numpy(labels), torch.from_numpy(t_lens),
                     torch.from_numpy(u_lens), reduction="sum")
    (grad,) = torch.autograd.grad(loss, full)
    cover_loss, cover_grad, centers = got[U1 + 2]
    assert (centers == 0).all()
    np.testing.assert_allclose(cover_loss.item(), loss.item(), rtol=1e-5)
    # the covering band's columns past U repeat row U: their gradients
    # add up to the full lattice's row U
    want = grad.numpy()
    summed = cover_grad[:, :, :U1].numpy().copy()
    summed[:, :, U1 - 1] += cover_grad[:, :, U1:].sum(dim=2).numpy()
    np.testing.assert_allclose(summed, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    narrow = got[3][0].item()
    assert narrow >= loss.item() * (1 - 1e-6)


def test_joint_logits_banded_is_the_full_joint_at_the_band(rng):
    model = TSTransducer(TSTransducerConfig(
        d_model=16, nhead=2, encoder_num_layers=1, d_ffn=16, joint_dim=12,
        decoder_neurons=8, injection_mode=None, use_speaker_encoder=False,
        joint_mode="concat")).init_weights(0)
    enc = torch.from_numpy(rng.normal(size=(2, 9, 12)).astype(np.float32))
    dec = torch.from_numpy(rng.normal(size=(2, 6, 12)).astype(np.float32))
    centers = band_centers(torch.tensor([9, 6]), torch.tensor([5, 3]), 9, 4)
    with torch.no_grad():
        full = model.joint_logits(enc[:, :, None], dec[:, None])
        banded = model.joint_logits_banded(enc, dec, centers, 4)
    want = band_of(full.numpy(), centers.numpy(), 4)
    np.testing.assert_allclose(banded.numpy(), want, rtol=0, atol=1e-6)


def test_cross_attention_kv_cache_streams_to_offline_greedy():
    from tsasr_torch.decoding import TransducerGreedySearcher
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.ops.features import Fbank
    pieces = ["<unk>"] + list("abcdefg")
    model = TSTransducer(TSTransducerConfig(
        vocab_size=8, d_model=32, nhead=4, encoder_num_layers=2, d_ffn=64,
        kernel_size=7, speaker_encoder_layers=1, decoder_neurons=24,
        joint_dim=48, frontend_channels=(8, 8), dropout=0.0,
        fused_attention=True, causal_encoder=True, frontend_causal=True,
        injection_mode="cross_attention",
        injection_after=(-1, 1))).init_weights(seed=0)
    with torch.no_grad():
        model.transducer_head.bias[0] -= 1.5
    rng = np.random.default_rng(3)
    wav = (rng.normal(size=int(1.6 * 16000)) * 0.1).astype(np.float32)
    enroll = (rng.normal(size=16000) * 0.1).astype(np.float32)
    tr = TSASRTranscriber(model, None, CharTokenizer(pieces), device="cpu")
    spk = tr.speaker_embedding(enroll)
    assert spk.shape == (1, 26, 32)
    streamer = tr.streaming("kv_cache", speaker_embs=spk)
    chunk = len(wav) // 4
    for i in range(4):
        streamer.accept_chunk(wav[i * chunk:(i + 1) * chunk])
    streamer.accept_chunk(wav[4 * chunk:])
    streamer.finalize()
    feats = Fbank(sample_rate=16000, n_fft=512, n_mels=80,
                  win_length=32.0)(torch.from_numpy(wav)[None])
    T4 = feats.shape[1] // 4 * 4
    with torch.no_grad():
        enc = model.encode(feats[:, :T4], torch.ones(1), spk)
    hyps, _, _, _ = TransducerGreedySearcher(model, 0)(enc, torch.ones(1))
    assert streamer._tokens == hyps[0] and len(hyps[0]) >= 3


# -------------------------------------------------------------- experiment
SWITCHES = ["--speaker_encoder_type", "ecapa", "--remat", "True",
            "--joint_band_width", "8"]
RUN_ARGS = ["--encoder_num_layers", "1", "--d_ffn", "64", "--d_model", "32",
            "--nhead", "4", "--decoder_neurons", "24", "--joint_dim", "48",
            "--beam_size", "1", "--valid_search_freq", "1",
            "--noprogressbar", "--train_max_batch_length", "8.0",
            "--grad_accumulation_factor", "2", "--dropout", "0.1"]


def test_switched_experiment_trains_recovers_and_tests(tmp_path,
                                                       monkeypatch):
    from tsasr_torch.models import conformer
    from tsasr_torch.models.ecapa import ECAPA_TDNN
    from tsasr_torch.recipes import librispeechmix
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset
    corpus = str(tmp_path / "corpus")
    make_dataset(corpus, **CORPUS)
    calls = {"remat": 0, "banded": 0}

    def counting(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(conformer, "rematerialized",
                        counting("remat", conformer.rematerialized))
    monkeypatch.setattr(librispeechmix, "rnnt_loss_banded", counting(
        "banded", librispeechmix.rnnt_loss_banded))
    out = tmp_path / "out"

    def run(epochs):
        return librispeechmix.run_experiment(argv=[
            str(TORCH_YAML), "--data_folder", corpus, "--output_folder",
            str(out), "--device", "cpu", "--vocab_size",
            str(corpus_vocab(corpus)), "--num_epochs", str(epochs),
            *RUN_ARGS, *SWITCHES])

    first = run(1)
    assert isinstance(first.model.speaker_encoder, ECAPA_TDNN)
    assert not first._fused_loss_active()
    # 6 micro-batches of remat'd encoder layers; the banded loss at TRAIN,
    # VALID and TEST
    assert calls["remat"] == 6 and calls["banded"] > 6
    steps = first.optimizer_step
    second = run(2)
    assert second._recovered_ckpt is not None
    assert second.optimizer_step == 2 * steps == 6
    log = (out / "train_log.txt").read_text()
    assert "epoch: 1, " in log and "epoch: 2, " in log
    assert (out / "wer_test-clean-2mix.txt").read_text().startswith("%WER")
    stats = {k: v for k, v in second.model.state_dict().items()
             if k.startswith("speaker_encoder") and k.endswith(".var")}
    assert stats and all(torch.equal(v, torch.ones_like(v))
                         for v in stats.values())
    # the folder transcribes: the ECAPA branch and its statistics load
    from tsasr_torch.inference import TSASRTranscriber
    tr = TSASRTranscriber.from_experiment(str(out), device="cpu")
    assert isinstance(tr.model.speaker_encoder, ECAPA_TDNN)
    rng = np.random.default_rng(0)
    wav, enroll = (rng.normal(size=n).astype(np.float32) * 0.1
                   for n in (16000, 8000))
    assert isinstance(tr.transcribe(wav, enroll), str)
