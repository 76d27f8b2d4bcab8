"""The yaml's model switches in the port against the JAX package: the
injection modes, the concat joint, remat and the component registry.

- ``TSConformerEncoder`` with every ``injection_mode`` (``prod``,
  ``sum``, ``cat``, ``cross_attention``, None) after the layers
  ``(-1, 0)`` and ``(0, 2)``, the port's seeded weights carried into
  flax (``convert.params_to_flax``), so no JAX init runs: the forward
  within 1e-4 absolute (as ``test_encoder_with_cat_injection``), and for
  ``cross_attention`` the gradients of every parameter and of the speaker
  frames within 1e-4 of each leaf's max |g|, the speaker frames padded
  past their relative lengths;
- ``CrossAttention`` alone on padded keys (2e-5, one block);
- the ``concat`` joint: ``joint_logits`` and the recipe's unfused loss
  with its gradients, against the JAX model (its ``Joiner``);
- remat ``full`` and ``dots`` with dropout on and an explicit generator:
  the loss, every gradient and the generator's final state bit for bit
  equal to the step without remat, each layer run twice (forward and
  recompute);
- the registry: a registered name, a dotted path, an unknown name (a
  ``ValueError`` listing the registered names), and a yaml override
  that swaps the encoder for a registered subclass.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import REPO, SMALL, TINY, load_yaml
from tsasr_tpu.models import attention as jax_attention
from tsasr_tpu.models import conformer as jax_conformer
from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
from tsasr_torch.convert import params_to_flax
from tsasr_torch.models import registry
from tsasr_torch.models.conformer import TSConformerEncoder
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.ops.rnnt_loss import rnnt_loss

ENC = dict(TINY, dropout=0.0)
MODES = ("prod", "sum", "cat", "cross_attention", None)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def encoder_pair(mode, after):
    """(the port's seeded encoder, the JAX encoder, its params)."""
    model = TSTransducer(TSTransducerConfig(
        **dict(ENC, injection_mode=mode, injection_after=after)))
    model.init_weights(seed=3)
    if mode in ("prod", "sum", "cross_attention"):
        # non-zero biases, so a missed bias shows
        with torch.no_grad():
            for name, p in model.encoder.named_parameters():
                if name.endswith("bias"):
                    p.normal_(0, 0.1, generator=torch.Generator()
                              .manual_seed(len(name)))
    jax_encoder = jax_conformer.TSConformerEncoder(
        d_model=ENC["d_model"], nhead=ENC["nhead"],
        num_layers=ENC["encoder_num_layers"], d_ffn=ENC["d_ffn"],
        kernel_size=ENC["kernel_size"], injection_mode=mode,
        injection_after=after, fused_attention=True)
    params = {"params": params_to_flax(model.state_dict())["encoder"]}
    return model.encoder.eval(), jax_encoder, params


def speaker_inputs(rng, mode, B=2):
    D = ENC["d_model"]
    if mode == "cross_attention":
        return (rng.normal(size=(B, 7, D)).astype(np.float32),
                np.array([1.0, 0.6], np.float32))
    scale = 0.5 if mode == "prod" else 1.0
    return (1.0 + scale * rng.normal(size=(B, 1, D))).astype(np.float32), None


@pytest.mark.parametrize("after", [(-1, 0), (0, 2)])
@pytest.mark.parametrize("mode", MODES)
def test_encoder_injection_matches_jax(mode, after, rng):
    encoder, jax_encoder, params = encoder_pair(mode, after)
    src = rng.normal(size=(2, 11, 20, 8)).astype(np.float32)
    rel = np.array([1.0, 0.6], np.float32)
    spk, spk_rel = speaker_inputs(rng, mode)
    j_spk_rel = None if spk_rel is None else jnp.asarray(spk_rel)
    want = jax_encoder.apply(params, jnp.asarray(src), jnp.asarray(rel),
                             jnp.asarray(spk), j_spk_rel)
    t_spk_rel = None if spk_rel is None else torch.from_numpy(spk_rel)
    with torch.no_grad():
        got = encoder(torch.from_numpy(src), torch.from_numpy(rel),
                      torch.from_numpy(spk), speaker_embs_length=t_spk_rel)
    _close(got, want, 1e-4)
    if mode == "cross_attention":
        # frames past round(0.6 * 7) = 4 of the second row are masked
        moved = spk.copy()
        moved[1, 4:] += 3.0
        with torch.no_grad():
            again = encoder(torch.from_numpy(src), torch.from_numpy(rel),
                            torch.from_numpy(moved),
                            speaker_embs_length=t_spk_rel)
        assert torch.equal(got, again)


def test_cross_attention_gradients_match_jax(rng):
    encoder, jax_encoder, params = encoder_pair("cross_attention", (-1, 0))
    src = rng.normal(size=(2, 11, 20, 8)).astype(np.float32)
    rel = np.array([1.0, 0.6], np.float32)
    spk, spk_rel = speaker_inputs(rng, "cross_attention")
    weights = rng.normal(size=(2, 11, ENC["d_model"])).astype(np.float32)

    def jax_loss(p, s):
        out = jax_encoder.apply(p, jnp.asarray(src), jnp.asarray(rel), s,
                                jnp.asarray(spk_rel))
        return jnp.sum(out * weights)

    want_loss, (want_p, want_s) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1)))(params, jnp.asarray(spk))
    s = torch.from_numpy(spk).requires_grad_(True)
    loss = (encoder(torch.from_numpy(src), torch.from_numpy(rel), s,
                    speaker_embs_length=torch.from_numpy(spk_rel))
            * torch.from_numpy(weights)).sum()
    names, leaves = zip(*encoder.named_parameters())
    grads = torch.autograd.grad(loss, leaves + (s,))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = _flat(params_to_flax({f"encoder.{n}": g for n, g in
                                zip(names, grads[:-1])})["encoder"])
    want = _flat(jax.device_get(want_p)["params"])
    assert got.keys() == want.keys()
    assert any("speaker_attn" in k for k in got)
    for key in want:
        # the key bias's gradient is 0 in exact arithmetic (a softmax does
        # not see a shift shared by all keys): rounding noise on both
        # sides, held at the key kernel's scale
        scale = want[key.replace("k_proj/bias", "k_proj/kernel")]
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-4 * np.abs(scale).max(),
                                   err_msg=key)
    want_s = np.asarray(want_s)
    np.testing.assert_allclose(grads[-1].numpy(), want_s, rtol=0,
                               atol=1e-4 * np.abs(want_s).max())
    assert not grads[-1][1, 4:].any()           # masked frames get nothing


def test_cross_attention_block_on_padded_keys(rng):
    encoder, _, params = encoder_pair("cross_attention", (0,))
    block = jax_attention.CrossAttention(embed_dim=ENC["d_model"],
                                         num_heads=ENC["nhead"])
    q = rng.normal(size=(2, 9, ENC["d_model"])).astype(np.float32)
    kv = rng.normal(size=(2, 6, ENC["d_model"])).astype(np.float32)
    kpm = np.arange(6)[None, :] >= np.array([[6], [2]])
    want = block.apply({"params": params["params"]["speaker_attn"]},
                       jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kpm))
    got = encoder.speaker_attn(torch.from_numpy(q), torch.from_numpy(kv),
                               torch.from_numpy(kpm))
    _close(got, want, 2e-5)


# ------------------------------------------------------------ concat joint
def test_concat_joint_and_unfused_loss_match_jax(rng):
    config = dict(ENC, joint_mode="concat")
    model = TSTransducer(TSTransducerConfig(**config)).init_weights(seed=4)
    with torch.no_grad():
        model.joiner.joint_network.bias.normal_(
            0, 0.1, generator=torch.Generator().manual_seed(0))
    params = {"params": params_to_flax(model.state_dict())}
    assert "joint_network" in params["params"]["joiner"]
    jax_model = JaxTransducer(JaxConfig(**config))
    J = ENC["joint_dim"]
    enc, dec = (rng.normal(size=(2, 5, 1, J)).astype(np.float32),
                rng.normal(size=(2, 1, 4, J)).astype(np.float32))
    want = jax_model.apply(params, jnp.asarray(enc), jnp.asarray(dec),
                           method=jax_model.joint_logits)
    got = model.joint_logits(torch.from_numpy(enc), torch.from_numpy(dec))
    assert got.shape == (2, 5, 4, model.config.vocab_size)
    _close(got, want, 2e-5)

    # the recipe's unfused loss over the concat joint's full logits (the
    # module, not tsasr_tpu.ops.rnnt_loss, which a function shadows)
    jax_rnnt = importlib.import_module("tsasr_tpu.ops.rnnt_loss").rnnt_loss
    enc_out = rng.normal(size=(2, 6, J)).astype(np.float32)
    dec_out = rng.normal(size=(2, 4, J)).astype(np.float32)
    labels = np.array([[3, 5, 7], [2, 9, 0]], np.int32)
    t_lens, u_lens = np.array([6, 4]), np.array([3, 2])

    def jax_objective(p, e, d):
        logits = jax_model.apply(p, e[:, :, None], d[:, None],
                                 method=jax_model.joint_logits)
        return jax_rnnt(logits, jnp.asarray(labels), jnp.asarray(t_lens),
                        jnp.asarray(u_lens), reduction="mean")

    want_loss, want_grads = jax.jit(jax.value_and_grad(
        jax_objective, argnums=(0, 1, 2)))(params, jnp.asarray(enc_out),
                                          jnp.asarray(dec_out))
    e = torch.from_numpy(enc_out).requires_grad_(True)
    d = torch.from_numpy(dec_out).requires_grad_(True)
    loss = rnnt_loss(model.joint_logits(e[:, :, None], d[:, None]),
                     torch.from_numpy(labels), torch.from_numpy(t_lens),
                     torch.from_numpy(u_lens), reduction="mean")
    w = model.joiner.joint_network.weight
    got_w, got_e, got_d = torch.autograd.grad(loss, (w, e, d))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_w = np.asarray(
        want_grads[0]["params"]["joiner"]["joint_network"]["kernel"]).T
    for g, wnt in ((got_w, want_w), (got_e, want_grads[1]),
                   (got_d, want_grads[2])):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(g.numpy(), wnt, rtol=0,
                                   atol=1e-4 * np.abs(wnt).max())


# ------------------------------------------------------------------ remat
def counted(forward, calls):
    """``forward`` that notes each call (a recompute runs no hooks)."""
    def run(*args, **kwargs):
        calls.append(1)
        return forward(*args, **kwargs)
    return run


def remat_step(remat, policy="full", fused=True):
    """One train-mode forward + backward of a tiny encoder with dropout
    0.1 from an explicit generator; (output, grads, generator state,
    layer calls)."""
    torch.manual_seed(0)
    encoder = TSConformerEncoder(
        20, ENC["d_model"], ENC["nhead"], 2, ENC["d_ffn"],
        ENC["kernel_size"], dropout=0.1, dropout_bits=8,
        injection_mode="cross_attention", injection_after=(-1, 1),
        fused_attention=fused, remat=remat, remat_policy=policy)
    calls = []
    for layer in encoder.layers:
        layer.forward = counted(layer.forward, calls)
    gen = torch.Generator().manual_seed(7)
    data = torch.Generator().manual_seed(1)
    x = torch.randn(2, 13, 20, generator=data)
    spk = torch.randn(2, 5, ENC["d_model"], generator=data)
    out = encoder(x, torch.tensor([1.0, 0.7]), spk, deterministic=False,
                  generator=gen, speaker_embs_length=torch.tensor([1.0, 0.6]))
    (out ** 2).sum().backward()
    return out, [p.grad for p in encoder.parameters()], gen.get_state(), \
        len(calls)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_is_bit_for_bit(policy, fused):
    out, grads, state, calls = remat_step(False, fused=fused)
    r_out, r_grads, r_state, r_calls = remat_step(True, policy, fused)
    assert (calls, r_calls) == (2, 4)            # each layer recomputed
    assert torch.equal(out, r_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, r_grads))
    assert torch.equal(state, r_state)


def test_remat_off_while_streaming_and_without_grad(monkeypatch):
    from tsasr_torch.models import conformer
    wrapped = []

    def spy(fn, generator, policy="full"):
        wrapped.append(policy)
        return conformer.rematerialized.__wrapped__(fn, generator, policy)

    spy.__wrapped__ = conformer.rematerialized
    monkeypatch.setattr(conformer, "rematerialized", spy)
    model = TSTransducer(TSTransducerConfig(**dict(
        ENC, remat=True, remat_policy="dots", causal_encoder=True,
        frontend_causal=True))).init_weights(0).eval()
    feats = torch.randn(1, 16, 80, generator=torch.Generator().manual_seed(0))
    spk = torch.randn(1, 1, ENC["d_model"])
    model.encode_stream(feats, model.init_stream_state(1, 32), spk)
    with torch.no_grad():
        model.encode(feats, torch.ones(1), spk)
    assert wrapped == []
    model.encode(feats, torch.ones(1), spk).sum().backward()
    assert wrapped == ["dots"] * ENC["encoder_num_layers"]
    assert model.speaker_encoder.remat


# --------------------------------------------------------------- registry
@registry.register("encoder", "tiny_test_encoder")
class CountingEncoder(TSConformerEncoder):
    """A registered subclass: the built-in plus a call count."""

    def forward(self, *args, **kwargs):
        self.calls = getattr(self, "calls", 0) + 1
        return super().forward(*args, **kwargs)


def test_registry_resolves_names_and_paths():
    assert registry.resolve("encoder", None) is None
    assert registry.resolve("encoder", "tiny_test_encoder") is CountingEncoder
    assert "tiny_test_encoder" in registry.available("encoder")
    assert registry.resolve(
        "joiner", "tsasr_torch.models.transducer.Joiner").__name__ \
        == "Joiner"
    with pytest.raises(ValueError, match=r"unknown encoder class 'nope'; "
                       r"registered: \[.*'tiny_test_encoder'"):
        registry.resolve("encoder", "nope")
    with pytest.raises(ValueError, match="cannot import"):
        registry.resolve("predictor", "tsasr_torch.models.NoSuch")
    with pytest.raises(ValueError, match="registered"):
        TSTransducer(TSTransducerConfig(**dict(ENC, joiner_class="nope")))


def test_yaml_override_swaps_the_encoder(tmp_path):
    yaml = REPO / "tsasr_torch/hparams/LibriSpeechMix/conformer-t_scratch.yaml"
    values = dict(SMALL, data_folder="/data", output_folder=str(tmp_path),
                  vocab_size=11, encoder_class="tiny_test_encoder",
                  predictor_class="tsasr_torch.models.transducer.Predictor")
    hparams = load_yaml("tsasr_torch", yaml, "".join(
        f"{k}: {v}\n" for k, v in values.items()))
    model = hparams["model"].init_weights(0).eval()
    assert type(model.encoder) is CountingEncoder
    assert type(model.speaker_encoder) is TSConformerEncoder
    with torch.no_grad():
        model.encode(torch.zeros(1, 16, 80), torch.ones(1),
                     torch.zeros(1, 1, SMALL["d_model"]))
    assert model.encoder.calls == 1
