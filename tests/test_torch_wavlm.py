"""The port's WavLM x-vector speaker encoder against the JAX package's.

- ``WavLMForXVector`` at the tiny config of ``tests/test_wavlm.py``, the
  JAX module's seeded weights carried over by
  ``convert.wavlm_params_from_flax``: embeddings, logits and every
  hidden state, with and without lengths, in three layouts (group norm
  and post-norm; layer norm, conv bias and pre-norm; no weighted layer
  sum). f32 through a few dozen ops on both sides: 1e-5 absolute.
- the relative-position buckets at the published widths, and the length
  formulas, equal to the JAX functions;
- an HF-named checkpoint directory written by the port's writer (both
  weight-norm namings): the port's loader gives the in-memory module's
  embeddings bit for bit, the JAX loader (``safetensors.numpy``) the
  same within 1e-5; ``pytorch_model.bin`` is read too;
- the port's safetensors reader and writer against the safetensors
  package, both ways;
- the frozen encoder of the recipe: frozen, on the CPU when asked,
  ceil lengths as the JAX ``JaxSpeakerEncoder``, whose embeddings it
  matches; a path that is no checkpoint directory raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsasr_tpu.models import wavlm as jax_wavlm
from tsasr_torch.convert import wavlm_params_from_flax
from tsasr_torch.models import wavlm
from tsasr_torch.recipes.speaker_embeddings import FrozenSpeakerEncoder
from tsasr_torch.utils import safetensors_io

ATOL = 1e-5
# tests/test_wavlm.py's small config, without HF's training-only keys
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=48, conv_dim=[8, 8], conv_kernel=[4, 3],
            conv_stride=[2, 2], conv_bias=False, feat_extract_norm="group",
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            num_buckets=20, max_bucket_distance=40,
            do_stable_layer_norm=False, use_weighted_layer_sum=True,
            tdnn_dim=[16, 16, 24], tdnn_kernel=[3, 3, 1],
            tdnn_dilation=[1, 2, 1], xvector_output_dim=12)
LAYOUTS = [
    {},
    {"do_stable_layer_norm": True, "feat_extract_norm": "layer",
     "conv_bias": True},
    {"use_weighted_layer_sum": False},
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pair(seed=0, **overrides):
    """(jax module, its variables, the port's module with the same
    weights)."""
    d = dict(TINY, **overrides)
    jcfg = jax_wavlm.WavLMConfig.from_hf_dict(d)
    jmodel = jax_wavlm.WavLMForXVector(jcfg)
    # compiled: the eager init's values, in a fraction of the time
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 640), jnp.float32))
    variables = jax.tree.map(lambda x: np.array(x, np.float32), variables)
    # non-trivial layer weights, gate constants and norms
    rng = np.random.default_rng(seed)
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        name = jax.tree_util.keystr(path)
        if any(s in name for s in ("layer_weights", "gru_rel_pos_const",
                                   "scale", "bias")):
            leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    model = wavlm.WavLMForXVector(wavlm.WavLMConfig.from_hf_dict(d)).eval()
    model.load_state_dict(wavlm_params_from_flax(variables))
    return jmodel, variables, model


def assert_outputs_close(got, want):
    for key in ("embeddings", "logits", "last_hidden_state"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), atol=ATOL,
                                   err_msg=key)
    assert len(got["hidden_states"]) == len(want["hidden_states"])
    for i, (g, w) in enumerate(zip(got["hidden_states"],
                                   want["hidden_states"])):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, err_msg=f"hidden state {i}")


@pytest.mark.parametrize("overrides", LAYOUTS)
def test_xvector_matches_jax_unmasked(overrides):
    jmodel, variables, model = pair(**overrides)
    x = np.random.default_rng(1).normal(0, 0.1, (2, 640)).astype(np.float32)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert_outputs_close(got, want)


@pytest.mark.parametrize("overrides", LAYOUTS[:2])
def test_xvector_matches_jax_with_lengths(overrides):
    """Unequal lengths: the key mask after the CNN and the masked mean
    and std over the valid TDNN frames."""
    jmodel, variables, model = pair(seed=3, **overrides)
    rng = np.random.default_rng(2)
    lengths = np.array([700, 512, 300], np.int64)
    x = rng.normal(0, 0.1, (3, 700)).astype(np.float32)
    x[1, 512:] = x[2, 300:] = 0.0
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x),
                                 jnp.asarray(lengths))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lengths))
    assert_outputs_close(got, want)


@pytest.mark.parametrize("num_buckets,max_distance,T", [
    (20, 40, 64), (320, 800, 1000)])
def test_relative_position_buckets_match_jax(num_buckets, max_distance, T):
    pos = np.arange(T)
    rel = pos[None, :] - pos[:, None]
    want = np.asarray(jax_wavlm._relative_positions_bucket(
        jnp.asarray(rel), num_buckets, max_distance))
    got = wavlm._relative_positions_bucket(torch.from_numpy(rel),
                                           num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lengths_match_jax():
    for d in (TINY, {}):
        jcfg = jax_wavlm.WavLMConfig.from_hf_dict(d)
        cfg = wavlm.WavLMConfig.from_hf_dict(d)
        for L in (320, 321, 400, 777, 80000, 80001):
            frames = cfg.feat_extract_output_length(L)
            assert frames == jcfg.feat_extract_output_length(L)
            assert cfg.tdnn_output_length(frames) \
                == jcfg.tdnn_output_length(frames)
        lengths = torch.tensor([320, 401, 777])
        assert cfg.feat_extract_output_length(lengths).tolist() == [
            jcfg.feat_extract_output_length(int(n)) for n in lengths]


def seeded_model(**overrides):
    cfg = wavlm.WavLMConfig.from_hf_dict(dict(TINY, **overrides))
    return wavlm.WavLMForXVector(cfg).init_weights(seed=5).eval()


def enrollments():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.1, (3, 900)).astype(np.float32)
    rel = np.array([1.0, 0.7, 0.45], np.float32)
    return x, rel


@pytest.mark.parametrize("naming", sorted(wavlm.WEIGHT_NORM_NAMES))
def test_checkpoint_read_by_both_loaders(tmp_path, naming):
    pytest.importorskip("safetensors")
    model = seeded_model()
    wavlm.save_pretrained_xvector(model, str(tmp_path), naming=naming)
    g_name, v_name = wavlm.WEIGHT_NORM_NAMES[naming]
    saved = safetensors_io.load_file(str(tmp_path / "model.safetensors"))
    assert g_name in saved and v_name in saved
    assert f"{wavlm.POS_CONV}.weight" not in saved

    x, rel = enrollments()
    lengths = torch.from_numpy(np.minimum(np.ceil(rel * 900), 900)
                               .astype(np.int64))
    config, loaded = wavlm.load_pretrained_xvector(str(tmp_path))
    assert config == model.config
    with torch.no_grad():
        want = model(torch.from_numpy(x), lengths)["embeddings"]
        got = loaded(torch.from_numpy(x), lengths)["embeddings"]
    assert torch.equal(got, want)
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key

    jcfg, variables = jax_wavlm.load_pretrained_xvector(str(tmp_path))
    out = jax.jit(jax_wavlm.WavLMForXVector(jcfg).apply)(
        variables, jnp.asarray(x), jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(np.asarray(out["embeddings"]), want.numpy(),
                               atol=ATOL)


def test_pytorch_model_bin_is_read(tmp_path):
    model = seeded_model(conv_bias=True, feat_extract_norm="layer")
    wavlm.save_pretrained_xvector(model, str(tmp_path),
                                  naming="parametrizations")
    sd = safetensors_io.load_file(str(tmp_path / "model.safetensors"))
    (tmp_path / "model.safetensors").unlink()
    torch.save(sd, tmp_path / "pytorch_model.bin")
    _, loaded = wavlm.load_pretrained_xvector(str(tmp_path))
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key


def test_safetensors_io_against_the_package(tmp_path):
    st_numpy = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    gen = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=gen),
               "b": torch.randn(7, generator=gen).double(),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "d": torch.randn(2, 2, generator=gen).half(),
               "empty": torch.zeros(0, 4)}
    ours = tmp_path / "ours.safetensors"
    safetensors_io.save_file(tensors, str(ours))
    theirs = st_numpy.load_file(str(ours))
    assert theirs.keys() == tensors.keys()
    for key, value in tensors.items():
        np.testing.assert_array_equal(theirs[key], value.numpy())
    written = tmp_path / "theirs.safetensors"
    st_torch.save_file(tensors, str(written), metadata={"format": "pt"})
    back = safetensors_io.load_file(str(written))
    for key, value in tensors.items():
        assert back[key].dtype == value.dtype and torch.equal(back[key],
                                                              value)


def test_frozen_encoder_matches_jax_speaker_encoder(tmp_path):
    """The recipe's frozen encoder: ceil lengths, (B, 1, E) embeddings
    equal to the model's, frozen parameters, the JAX encoder's
    embeddings on the same checkpoint; missing directories raise."""
    pytest.importorskip("safetensors")
    from tsasr_tpu.recipes.speaker_embeddings import JaxSpeakerEncoder
    model = seeded_model()
    wavlm.save_pretrained_xvector(model, str(tmp_path / "ckpt"))
    enc = FrozenSpeakerEncoder(str(tmp_path / "ckpt"), embedding_dim=12,
                               device="cpu")
    assert all(not p.requires_grad for p in enc.model.parameters())
    assert not enc.model.training
    x, rel = enrollments()
    got = enc.embed(torch.from_numpy(x), torch.from_numpy(rel))
    assert got.shape == (3, 1, 12) and not got.requires_grad
    lengths = torch.tensor([900, 630, 405])
    with torch.no_grad():
        want = model(torch.from_numpy(x), lengths)["embeddings"]
    assert torch.equal(got[:, 0], want)
    jenc = JaxSpeakerEncoder(str(tmp_path / "ckpt"), embedding_dim=12)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jax.jit(jenc.embed)(jnp.asarray(x), jnp.asarray(rel))),
        atol=ATOL)

    with pytest.raises(ValueError, match="speaker_embedding_dim"):
        FrozenSpeakerEncoder(str(tmp_path / "ckpt"), embedding_dim=16,
                             device="cpu")
    for missing in (tmp_path / "missing", "microsoft/wavlm-base-sv"):
        with pytest.raises(FileNotFoundError, match="speaker_encoder_path"):
            FrozenSpeakerEncoder(str(missing), device="cpu")
