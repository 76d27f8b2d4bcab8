"""The port's train-time augmentation against the JAX package's.

The two frameworks cannot share a random stream, so each test makes
JAX's draws with ``jax.random`` exactly as ``tsasr_tpu/ops/augment.py``
makes them from a key (``jax_spec_draws``, ``jax_speed_index``) and
hands them to the port's deterministic ``apply_*`` functions; the JAX
function runs on the same key.

- ``spec_augment`` (time warp, frequency and time masks) on random
  features, with the identity warp, an empty width range and
  ``replace_with_zero`` among the cases: 1e-6 absolute (the same f32 ops
  in the same order; the batch mean summed in another order);
- ``speed_perturb`` at each of the three speeds, and ``resample_device``
  alone: 1e-5 absolute on the waveform (a 34-tap f32 convolution summed
  in another order), the factor exactly;
- the port's own draws keep JAX's ranges (``c``, ``w``, ``max_pos``
  over the batch) and repeat with the generator's seed;
- the recipe's ``_mixture_features`` at TRAIN with ``augment`` on
  (speed, padding, Fbank, normalization, SpecAugment) against the JAX
  recipe's on one injected key: 1e-4 absolute, the features' own
  tolerance (``tests/test_torch_ops.py``), the relative lengths 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsasr_tpu.ops import augment as jax_augment
from tsasr_tpu.recipes.librispeechmix import TSASRBrain as JaxBrain
from tsasr_tpu.utils.stage import Stage as JaxStage
from tsasr_torch.ops import augment
from tsasr_torch.recipes import librispeechmix
from tsasr_torch.utils.stage import Stage

SPEEDS = (95, 100, 105)
SPEC_CASES = [
    # (B, T, F, keywords)
    (3, 60, 80, {}),
    (2, 90, 40, {"time_warp_window": 10, "freq_mask_width": (5, 12),
                 "time_mask_width": 30, "n_time_mask": 3}),
    (3, 10, 80, {}),                                # T - 5 <= 5: no warp
    (2, 50, 80, {"freq_mask_width": (4, 4)}),       # empty width range
    (3, 60, 80, {"replace_with_zero": True}),
    (2, 40, 80, {"time_warp": False, "time_mask": False}),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _widths(width):
    return (0, width) if isinstance(width, int) else tuple(width)


def jax_spec_draws(key, shape, time_warp=True, time_warp_window=5,
                   freq_mask=True, freq_mask_width=(0, 30), n_freq_mask=2,
                   time_mask=True, time_mask_width=(0, 20), n_time_mask=2,
                   replace_with_zero=False):
    """The draws ``jax_augment.spec_augment(x, key, ...)`` makes, in the
    port's ``draw_spec_augment`` form."""
    B, T, n_freq = shape
    k_warp, k_f, k_t = jax.random.split(key, 3)

    def masks(k, D, n, widths):
        lo, hi = _widths(widths)
        if hi <= lo:
            return None
        k1, k2 = jax.random.split(k)
        lengths = jax.random.randint(k1, (B, n, 1), lo, hi)
        max_pos = max(1, D - int(lengths.max()))
        pos = jax.random.randint(k2, (B, n, 1), 0, max_pos)
        return (torch.from_numpy(np.asarray(lengths, np.int64)),
                torch.from_numpy(np.asarray(pos, np.int64)))

    warp = None
    window = time_warp_window
    if time_warp and T - window > window:
        k1, k2 = jax.random.split(k_warp)
        c = int(jax.random.randint(k1, (), window, T - window))
        w = int(jax.random.randint(k2, (), c - window, c + window)) + 1
        warp = (c, w)
    return {"warp": warp,
            "freq": masks(k_f, n_freq, n_freq_mask, freq_mask_width)
            if freq_mask else None,
            "time": masks(k_t, T, n_time_mask, time_mask_width)
            if time_mask else None}


def jax_speed_index(key):
    return int(jax.random.randint(key, (), 0, len(SPEEDS)))


def key_for_speed(index):
    """A key whose speed draw is ``SPEEDS[index]``."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if jax_speed_index(key) == index:
            return key
    raise AssertionError(f"no key draws speed index {index}")


@pytest.mark.parametrize("B,T,F,kwargs", SPEC_CASES)
def test_spec_augment_matches_jax(B, T, F, kwargs):
    x = np.random.default_rng(T + F).normal(size=(B, T, F)).astype(
        np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_augment.spec_augment(jnp.asarray(x), key,
                                                   **kwargs))
        draws = jax_spec_draws(key, x.shape, **kwargs)
        got = augment.apply_spec_augment(
            torch.from_numpy(x), draws,
            kwargs.get("replace_with_zero", False)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        if draws["warp"] is None and draws["freq"] is None \
                and draws["time"] is None:
            assert np.array_equal(got, x)
        else:
            assert not np.array_equal(got, x)


def test_identity_cases_draw_nothing():
    gen = torch.Generator().manual_seed(0)
    assert augment.draw_time_warp(gen, 10, 5) is None
    assert augment.draw_masks(gen, 2, 80, 2, (4, 4)) is None
    draws = augment.draw_spec_augment(gen, (2, 10, 80),
                                      freq_mask_width=(3, 3),
                                      time_mask=False)
    assert draws == {"warp": None, "freq": None, "time": None}
    x = torch.randn(2, 10, 80, generator=gen)
    assert torch.equal(augment.apply_spec_augment(x, draws), x)


def test_port_draws_keep_jax_ranges_and_repeat():
    for seed in range(20):
        gen = torch.Generator().manual_seed(seed)
        c, w = augment.draw_time_warp(gen, 50, 5)
        assert 5 <= c < 45 and c - 5 + 1 <= w < c + 5 + 1
        lengths, pos = augment.draw_masks(gen, 4, 30, 2, (0, 20))
        assert lengths.shape == pos.shape == (4, 2, 1)
        assert (lengths >= 0).all() and (lengths < 20).all()
        assert (pos >= 0).all() \
            and (pos < max(1, 30 - int(lengths.max()))).all()
        assert 0 <= augment.draw_speed(gen, SPEEDS) < 3
    first = augment.draw_spec_augment(torch.Generator().manual_seed(7),
                                      (3, 60, 80))
    again = augment.draw_spec_augment(torch.Generator().manual_seed(7),
                                      (3, 60, 80))
    assert first["warp"] == again["warp"]
    for kind in ("freq", "time"):
        assert all(torch.equal(a, b) for a, b in zip(first[kind],
                                                     again[kind]))


@pytest.mark.parametrize("index", range(len(SPEEDS)))
def test_speed_perturb_matches_jax(index):
    rng = np.random.default_rng(index)
    wav = (rng.normal(size=(3, 4001)) * 0.1).astype(np.float32)
    key = key_for_speed(index)
    want, want_factor = jax_augment.speed_perturb(jnp.asarray(wav), key,
                                                  speeds=SPEEDS)
    got, factor = augment.apply_speed_perturb(torch.from_numpy(wav),
                                              SPEEDS[index])
    assert got.shape == wav.shape and factor.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert factor.item() == float(want_factor)
    if SPEEDS[index] == 95:             # fewer samples, zero-padded
        assert factor.item() < 1 and not got[:, -100:].any()
    elif SPEEDS[index] == 100:
        assert torch.equal(got, torch.from_numpy(wav))


@pytest.mark.parametrize("orig,new,length", [
    (100, 95, 4001), (100, 105, 3999), (16000, 8000, 1600)])
def test_resample_device_matches_jax(orig, new, length):
    wav = np.random.default_rng(length).normal(size=(2, length)).astype(
        np.float32)
    want = np.asarray(jax_augment.resample_device(jnp.asarray(wav), orig,
                                                  new))
    got = augment.resample_device(torch.from_numpy(wav), orig, new)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


HPARAMS = {"sample_rate": 16000, "n_fft": 512, "n_mels": 80,
           "win_length": 32, "augment": True, "blank_index": 0,
           "pad_feats_to": 32, "speeds": list(SPEEDS),
           "time_warp_window": 5, "freq_mask_width": 30,
           "time_mask_width": 20}


@pytest.mark.parametrize("index", range(len(SPEEDS)))
def test_mixture_features_at_train_match_jax(monkeypatch, index):
    """The JAX recipe splits its key into the speed draw's and
    SpecAugment's; the port's draws (``speed_perturb`` and
    ``spec_augment`` call the module's ``draw_*``) are replaced by
    those."""
    rng = np.random.default_rng(10 + index)
    lengths = (16000, 11000, 7000)
    wav = np.zeros((3, 16000), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.normal(size=n) * 0.1
    rel = np.asarray(lengths, np.float32) / 16000
    key = key_for_speed(index)

    jbrain = JaxBrain(modules={"model": None}, hparams=HPARAMS,
                      variant="none")
    want_feats, want_rel = jbrain._mixture_features(
        {"mixed_sig": wav, "mixed_lens": rel}, JaxStage.TRAIN, key)

    k_speed, rest = jax.random.split(key)
    k_spec, _ = jax.random.split(rest)
    monkeypatch.setattr(augment, "draw_speed",
                        lambda gen, speeds: jax_speed_index(k_speed))
    monkeypatch.setattr(
        augment, "draw_spec_augment",
        lambda gen, shape, **kw: jax_spec_draws(k_spec, shape, **kw))
    brain = librispeechmix.TSASRBrain(
        modules={"model": None}, hparams=HPARAMS,
        run_opts={"device": "cpu"}, variant="none")
    feats, got_rel = brain._mixture_features(
        {"mixed_sig": torch.from_numpy(wav),
         "mixed_lens": torch.from_numpy(rel)}, Stage.TRAIN)

    assert feats.shape == want_feats.shape
    np.testing.assert_allclose(got_rel.numpy(), np.asarray(want_rel),
                               rtol=1e-7)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats),
                               atol=1e-4, rtol=0)
    # VALID: no augmentation, the same features as augment off
    plain, _ = brain._mixture_features(
        {"mixed_sig": torch.from_numpy(wav),
         "mixed_lens": torch.from_numpy(rel)}, Stage.VALID)
    valid, _ = brain._features(torch.from_numpy(wav), torch.from_numpy(rel))
    assert torch.equal(plain, valid)
