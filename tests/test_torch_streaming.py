"""Streaming transcription of causal models: tsasr_torch against
tsasr_tpu on the CPU, with the port's seeded weights carried into a flax
tree (``params_to_flax``, no JAX init). One causal model with a speaker
branch (2 mixture layers, 1 speaker layer, d_model 32, kernel 7) serves
the module. Tolerances as in ``test_torch_models.py``: 2e-5 for a single
block, 1e-4 through the encoder; token sequences must be identical.

The weights' biases are drawn at random, except the conv modules'
``norm_in`` and ``pointwise_in`` biases, which stay zero: the JAX
stream's conv cache runs them over its zero frames and matches the
offline encode only while they are zero
(``test_conv_cache_matches_offline_where_jax_does_not`` shows it with
them drawn too)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (JAX_YAML, TORCH_YAML, load_yaml, overrides,
                                write_float_wav)
from tsasr_torch.convert import params_from_flax, params_to_flax
from tsasr_torch.data.tokenizer import CharTokenizer
from tsasr_torch.inference import TSASRTranscriber
from tsasr_torch.inference.streaming import StreamingTranscriber
from tsasr_torch.models import attention
from tsasr_torch.models.frontend import ConvolutionFrontEnd
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.ops.features import Fbank, spectral_magnitude, stft
from tsasr_torch.ops.masks import lookahead_mask

CAUSAL = dict(vocab_size=8, d_model=32, nhead=4, encoder_num_layers=2,
              d_ffn=64, kernel_size=7, speaker_encoder_layers=1,
              decoder_neurons=24, joint_dim=48, frontend_channels=(8, 8),
              dropout=0.0, fused_attention=True, causal_encoder=True,
              frontend_causal=True)
PIECES = ["<unk>"] + list("abcdefg")
SR = 16000
BLOCK_ATOL = 2e-5
ENC_ATOL = 1e-4
FEAT_ATOL = 2e-3      # dB of magnitude ~100 from f32 sums over 512 samples
CONV_BIASES = ("conv.norm_in.bias", "conv.pointwise_in.bias")


class JitApply:
    """A flax model whose ``apply`` runs each method compiled: the JAX
    streamer calls ``apply`` op by op, and here a compile costs less than
    the eager ops. The computation is the same."""

    EAGER = ("init_stream_state", "predictor_initial_state")

    def __init__(self, module):
        self.module, self.fns = module, {}

    def __getattr__(self, name):
        return getattr(self.module, name)

    def apply(self, params, *args, method):
        name = method if isinstance(method, str) else method.__name__
        if name in self.EAGER:
            return self.module.apply(params, *args, method=name)
        if name not in self.fns:
            self.fns[name] = jax.jit(functools.partial(self.module.apply,
                                                       method=name))
        return self.fns[name](params, *args)


def draw_biases(model, seed, skip=CONV_BIASES):
    """Every bias and LayerNorm scale drawn around its init, but
    ``skip``; the blank's bias lowered so random weights emit."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(skip):
                continue
            if name.endswith(".bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif "norm" in name and name.endswith(".weight"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
        model.transducer_head.bias[0] -= 1.0
    return model


def both(config_kwargs, state_dict):
    """(jax model, {"params": tree}, port model in eval mode) for one
    config, the port's weights in both."""
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    model = TSTransducer(TSTransducerConfig(**config_kwargs)).eval()
    model.load_state_dict(state_dict)
    return (JaxTransducer(JaxConfig(**config_kwargs)),
            {"params": params_to_flax(state_dict)}, model)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: beside other test processes a multi-threaded
    op's wait for all its threads costs more than the op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    model = TSTransducer(TSTransducerConfig(**CAUSAL)).init_weights(seed=0)
    return both(CAUSAL, draw_biases(model, seed=1).state_dict())


@pytest.fixture(scope="module")
def jit_model(models):
    return JitApply(models[0])


@pytest.fixture(scope="module")
def jax_streamer_fns(models, jit_model, speaker):
    """The JAX streamer's ``_encode`` and ``_frames_to_feats`` compiled
    once for the module: they read only the model, the weights, the
    speaker embedding and the feature settings, the same in every
    streamer here."""
    from tsasr_tpu.inference.streaming import \
        StreamingTranscriber as JaxStreamer
    proto = JaxStreamer(jit_model, models[1], None, speaker_embs=speaker[1])
    return {"_encode": jax.jit(proto._encode),
            "_frames_to_feats": jax.jit(proto._frames_to_feats,
                                        static_argnums=1)}


@pytest.fixture(scope="module")
def audio():
    """1.6 s of a mixture and a 1 s enrollment (white noise keeps the
    fbank's range under the 80 dB clamp, so a chunk's features are the
    utterance's)."""
    rng = np.random.default_rng(3)
    return ((rng.normal(size=int(1.6 * SR)) * 0.1).astype(np.float32),
            (rng.normal(size=SR) * 0.1).astype(np.float32))


@pytest.fixture(scope="module")
def speaker(models, audio):
    """The enrollment's speaker embedding in both packages."""
    from tsasr_tpu.ops import Fbank as JaxFbank
    from tsasr_tpu.ops import input_normalization as jax_norm
    jax_model, params, model = models
    tr = TSASRTranscriber(model, None, CharTokenizer(PIECES), device="cpu")
    got = tr.speaker_embedding(audio[1])
    rel = jnp.ones(1)
    feats = jax_norm(JaxFbank(sample_rate=SR, n_fft=512, n_mels=80,
                              win_length=32.0)(jnp.asarray(audio[1])[None]),
                     rel)
    want = jax.jit(functools.partial(jax_model.apply,
                                     method="extract_speaker"))(
        params, feats, rel)
    return got, want


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("TSASR_ATTN_INTERPRET", "1")


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, atol):
    got, want = (x.detach() if torch.is_tensor(x) else x
                 for x in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# ------------------------------------------------------------- features
def test_uncentred_stft_and_raw_window_fbank(models, rng):
    """stft with and without centre padding, the power spectrum, and the
    streamer's fbank of a raw window (the kv_cache mode's features)."""
    from tsasr_tpu.inference.streaming import \
        StreamingTranscriber as JaxStreamer
    from tsasr_tpu.ops import features as jax_features
    jax_model, params, model = models
    x = _np(rng, 2, 3000) * 0.1
    for center in (True, False):
        re, im = stft(torch.from_numpy(x), 16000, 32.0, 10.0, 512, center)
        w_re, w_im = jax_features.stft(jnp.asarray(x), 16000, 32.0, 10.0,
                                       512, center=center)
        assert re.shape == w_re.shape == (2, 16 + 3 * center, 257)
        _close(re, w_re, 1e-4)
        _close(im, w_im, 1e-4)
        _close(spectral_magnitude(re, im),
               jax_features.spectral_magnitude(w_re, w_im), 1e-4)
    window = x[0, :(12 - 1) * 160 + 512]
    port = StreamingTranscriber(model, None, CharTokenizer(PIECES),
                                speaker_embs=torch.zeros(1, 1, 32),
                                device="cpu")
    jax_streamer = JaxStreamer(jax_model, params, None)
    got = port._frames_to_feats(window, 12)
    assert got.shape == (1, 12, 80)
    _close(got, jax_streamer._frames_to_feats(window, 12), FEAT_ATOL)


# ---------------------------------------------------------------- blocks
def test_causal_rel_shift_matches_jax(rng):
    """The plain path's shift zeroes the future triangle as JAX's does."""
    from tsasr_tpu.models.attention import _rel_shift as jax_shift
    x = _np(rng, 2, 3, 9, 17)
    for causal in (False, True):
        np.testing.assert_array_equal(
            attention._rel_shift(torch.from_numpy(x), 9, causal).numpy(),
            np.asarray(jax_shift(jnp.asarray(x), 9, causal)))


@pytest.mark.parametrize("streamed", [False, True])
def test_causal_frontend(models, rng, streamed):
    """Zero causal padding offline; streamed in 4-frame chunks against
    the JAX stream, and against the port's offline output."""
    from tsasr_tpu.models.frontend import ConvolutionFrontEnd
    _, params, model = models
    x = _np(rng, 2, 16, 80)
    jax_frontend = ConvolutionFrontEnd(out_channels=(8, 8), causal=True)
    variables = {"params": params["params"]["frontend"]}
    if not streamed:
        want = jax.jit(jax_frontend.apply)(variables, jnp.asarray(x))
        got = model.frontend(torch.from_numpy(x))
        assert got.shape == (2, 4, 20, 8)
        _close(got, want, BLOCK_ATOL)
        return
    caches = [torch.zeros(2, 2, 80, 1), torch.zeros(2, 2, 40, 8)]
    jax_caches = [jnp.asarray(c.numpy()) for c in caches]
    outs, jax_outs = [], []
    for lo in range(0, 16, 4):
        out, caches = model.frontend(torch.from_numpy(x[:, lo:lo + 4]),
                                     stream_caches=caches)
        jax_out, jax_caches = jax.jit(jax_frontend.apply)(
            variables, jnp.asarray(x[:, lo:lo + 4]),
            stream_caches=jax_caches)
        outs.append(out)
        jax_outs.append(jax_out)
    _close(torch.cat(outs, 1), np.concatenate(jax_outs, 1), BLOCK_ATOL)
    _close(torch.cat(outs, 1), model.frontend(torch.from_numpy(x)),
           BLOCK_ATOL)


@pytest.mark.parametrize("fused,context", [(False, 0), (True, 0),
                                           (False, 3), (True, 3)])
def test_causal_layer(models, rng, fused, context):
    """One causal layer with the lookahead mask and key padding, the
    bounded context on the plain and the fused path (the kernel's plain
    version here, JAX's Pallas kernel in interpret mode). Padded query
    rows whose every visible key is padding are left out: there the JAX
    fused path averages its tile's zero padding and its plain path the
    masked keys, and no valid frame reads them."""
    from tsasr_tpu.models.attention import rel_pos_encoding
    from tsasr_tpu.models.conformer import ConformerEncoderLayer
    from tsasr_torch.models.conformer import \
        ConformerEncoderLayer as PortLayer
    _, params, model = models
    B, T, D = 2, 13, CAUSAL["d_model"]
    x = _np(rng, B, T, D)
    kpm = np.arange(T)[None, :] >= np.array([[T], [T - 4]])
    layer = PortLayer(D, CAUSAL["d_ffn"], CAUSAL["nhead"], 7,
                      fused_attention=fused, causal=True,
                      att_context_size=context).eval()
    layer.load_state_dict(model.encoder.layers[0].state_dict())
    jax_layer = ConformerEncoderLayer(
        d_model=D, d_ffn=CAUSAL["d_ffn"], nhead=CAUSAL["nhead"],
        kernel_size=7, causal=True, att_context_size=context,
        fused_attention=fused, activation=jax.nn.leaky_relu)
    mask = lookahead_mask(T)
    want, _ = jax.jit(jax_layer.apply)(
        {"params": params["params"]["encoder"]["layer_0"]}, jnp.asarray(x),
        rel_pos_encoding(T, D), jnp.asarray(kpm), jnp.asarray(mask.numpy()))
    got, _ = layer(torch.from_numpy(x), attention.rel_pos_encoding(T, D),
                   torch.from_numpy(kpm), mask)
    hidden = mask.numpy()[None] | kpm[:, None, :]
    if context:
        pos = np.arange(T)
        hidden = hidden | (pos[:, None] - pos[None, :] >= context)[None]
    seen = ~hidden.all(-1)
    assert seen.sum() == 2 * T - 2 * bool(context)
    _close(got[torch.from_numpy(seen)], np.asarray(want)[seen], BLOCK_ATOL)


@pytest.mark.parametrize("context", [0, 3])
def test_kv_cache_attention_matches_jax(models, rng, context):
    """Two chunks of 4 frames through the KV-cache attention: outputs,
    probabilities over the visible keys, and the buffers."""
    from tsasr_tpu.models.attention import RelPosMHAXL
    _, params, model = models
    B, C, H, Dh = 2, 12, 4, 8
    mha = attention.RelPosMHAXL(32, 4, att_context_size=context).eval()
    mha.load_state_dict(model.encoder.layers[1].mha.state_dict())
    jax_mha = RelPosMHAXL(embed_dim=32, num_heads=4,
                          att_context_size=context)
    variables = {"params": params["params"]["encoder"]["layer_1"]["mha"]}
    cache = {"k": torch.zeros(B, C, H, Dh), "v": torch.zeros(B, C, H, Dh),
             "count": 0}
    jax_cache = {"k": jnp.zeros((B, C, H, Dh)), "v": jnp.zeros((B, C, H, Dh)),
                 "count": jnp.zeros((B,), jnp.int32)}
    for _ in range(2):
        x = _np(rng, B, 4, 32)
        (got, probs), cache = mha(torch.from_numpy(x), None, kv_cache=cache)
        (want, w_probs), jax_cache = jax.jit(jax_mha.apply)(
            variables, jnp.asarray(x), None, kv_cache=jax_cache)
        _close(got, want, BLOCK_ATOL)
        lo = cache["count"] - probs.shape[-1]
        _close(probs, np.asarray(w_probs)[..., lo:cache["count"]],
               BLOCK_ATOL)
        assert np.asarray(w_probs)[..., cache["count"]:].max() == 0
        _close(cache["k"], jax_cache["k"], BLOCK_ATOL)
        assert cache["count"] == int(jax_cache["count"][0])


def test_conv_cache_matches_offline_where_jax_does_not(models, rng):
    """With every conv bias drawn, the port's streamed conv module is the
    offline causal one (its cache holds GLU outputs, zeros at the start);
    JAX's cache holds inputs, whose zeros become LN bias -> pointwise ->
    GLU, so its stream departs from its own offline output."""
    from tsasr_tpu.models.conformer import ConvolutionModule
    _, params, model = models
    conv = model.encoder.layers[0].conv
    gen = torch.Generator().manual_seed(5)
    state = {k: v.clone() for k, v in conv.state_dict().items()}
    for key in ("norm_in.bias", "pointwise_in.bias"):
        state[key] = 0.3 * torch.randn(state[key].shape, generator=gen)
    port = type(conv)(32, 7, causal=True).eval()
    port.load_state_dict(state)
    jax_conv = ConvolutionModule(32, 7, causal=True,
                                 activation=jax.nn.leaky_relu)
    variables = {"params": params_to_flax(
        {f"encoder.layers.0.conv.{k}": v for k, v in state.items()}
    )["encoder"]["layer_0"]["conv"]}
    x = _np(rng, 2, 12, 32)
    offline = jax.jit(jax_conv.apply)(variables, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), offline, BLOCK_ATOL)
    cache, jax_cache = torch.zeros(2, 6, 32), jnp.zeros((2, 6, 32))
    outs, jax_outs = [], []
    for lo in range(0, 12, 4):
        out, cache = port(torch.from_numpy(x[:, lo:lo + 4]),
                          conv_cache=cache)
        jax_out, jax_cache = jax.jit(jax_conv.apply)(
            variables, jnp.asarray(x[:, lo:lo + 4]), conv_cache=jax_cache)
        outs.append(out)
        jax_outs.append(jax_out)
    _close(torch.cat(outs, 1), offline, BLOCK_ATOL)
    assert np.abs(np.concatenate(jax_outs, 1) - offline).max() > 1e-2


# --------------------------------------------------------------- encoder
def test_causal_params_convert_both_ways(models):
    """A causal model's flax tree has the non-causal one's names and
    shapes: ``params_from_flax`` carries it across unchanged."""
    jax_model, params, model = models
    feats = jnp.zeros((1, 16, 80))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), feats,
                            jnp.ones(1), jnp.zeros((1, 2), jnp.int32),
                            feats, jnp.ones(1))
    assert jax.tree.map(lambda s: s.shape, shapes["params"]) == \
        jax.tree.map(np.shape, params["params"])
    state = params_from_flax(params)
    assert state.keys() == model.state_dict().keys()
    for key, value in model.state_dict().items():
        assert torch.equal(state[key], value), key


@pytest.mark.parametrize("chunk", [4, 8])
def test_encode_stream_matches_jax_offline(models, speaker, rng, chunk):
    """The port's offline causal encode, and its stream in chunks of 4
    and 8 feature frames, against the JAX offline encode, with the cat
    injection of the enrollment's embedding."""
    jax_model, params, model = models
    feats = _np(rng, 1, 32, 80)
    spk, jax_spk = speaker
    want = jax.jit(functools.partial(jax_model.apply, method="encode"))(
        params, jnp.asarray(feats), jnp.ones(1), jax_spk)
    with torch.no_grad():
        offline = model.encode(torch.from_numpy(feats), torch.ones(1), spk)
        state = model.init_stream_state(1, 16)
        outs = []
        for lo in range(0, 32, chunk):
            out, state = model.encode_stream(
                torch.from_numpy(feats[:, lo:lo + chunk]), state, spk)
            outs.append(out)
    assert offline.shape == (1, 8, CAUSAL["joint_dim"])
    _close(offline, want, ENC_ATOL)
    _close(torch.cat(outs, 1), want, ENC_ATOL)
    assert state["encoder"][0]["attn"]["count"] == 8


def test_bounded_context_stream_matches_jax_offline(models, speaker, rng):
    """att_context_size 2: the bounded offline encode (fused path) in both
    packages, and the port's bounded stream, agree; unbounded differs."""
    _, _, model = models
    jax_model, params, bounded = both(dict(CAUSAL, att_context_size=2),
                                      model.state_dict())
    feats = _np(rng, 1, 24, 80)
    spk, jax_spk = speaker
    want = jax.jit(functools.partial(jax_model.apply, method="encode"))(
        params, jnp.asarray(feats), jnp.ones(1), jax_spk)
    with torch.no_grad():
        got = bounded.encode(torch.from_numpy(feats), torch.ones(1), spk)
        state = bounded.init_stream_state(1, 8)
        outs = []
        for lo in range(0, 24, 4):
            out, state = bounded.encode_stream(
                torch.from_numpy(feats[:, lo:lo + 4]), state, spk)
            outs.append(out)
        unbounded = model.encode(torch.from_numpy(feats), torch.ones(1), spk)
    _close(got, want, ENC_ATOL)
    _close(torch.cat(outs, 1), want, ENC_ATOL)
    assert (unbounded - got).abs().max() > 1e-3


# ------------------------------------------------------------ streamers
def _feed(streamer, wav, n_chunks):
    chunk = len(wav) // n_chunks
    partials = [streamer.accept_chunk(wav[i * chunk:(i + 1) * chunk])
                for i in range(n_chunks)]
    partials.append(streamer.accept_chunk(wav[n_chunks * chunk:]))
    return partials, streamer.finalize()


def _streamers(models, jit_model, speaker, fns, mode, **kwargs):
    """The port's streamer and JAX's on the same weights; the JAX one's
    features and encode run compiled (the same computation, ``fns``)."""
    from tsasr_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
    from tsasr_tpu.inference.streaming import \
        StreamingTranscriber as JaxStreamer
    _, params, model = models
    spk, jax_spk = speaker
    tr = TSASRTranscriber(model, None, CharTokenizer(PIECES), device="cpu")
    jax_streamer = JaxStreamer(jit_model, params, JaxTokenizer(PIECES),
                               speaker_embs=jax_spk, mode=mode, **kwargs)
    for name, fn in fns.items():
        setattr(jax_streamer, name, fn)
    return tr.streaming(mode, speaker_embs=spk, **kwargs), jax_streamer


def test_kv_cache_tokens_match_jax_and_offline_greedy(models, jit_model,
                                                      speaker, audio,
                                                      jax_streamer_fns):
    """kv_cache mode in 4 chunks and a tail: the same tokens and partial
    transcripts as the JAX streamer, and the port's offline greedy
    tokens on the same (unnormalized) features."""
    from tsasr_torch.decoding import TransducerGreedySearcher
    _, _, model = models
    port, jax_streamer = _streamers(models, jit_model, speaker,
                                    jax_streamer_fns, "kv_cache")
    partials, final = _feed(port, audio[0], 4)
    want_partials, want_final = _feed(jax_streamer, audio[0], 4)
    assert port._tokens == jax_streamer._tokens
    assert (partials, final) == (want_partials, want_final)
    assert len(port._tokens) >= 3

    feats = Fbank(sample_rate=SR, n_fft=512, n_mels=80,
                  win_length=32.0)(torch.from_numpy(audio[0])[None])
    T4 = feats.shape[1] // 4 * 4        # the stream drops the <4 tail
    with torch.no_grad():
        enc = model.encode(feats[:, :T4], torch.ones(1), speaker[0])
    hyps, _, _, _ = TransducerGreedySearcher(model, 0)(enc, torch.ones(1))
    assert port._tokens == hyps[0]


def test_reencode_tokens_match_jax(models, jit_model, speaker, audio,
                                   jax_streamer_fns):
    """reencode mode in 2 chunks: the same partials and final transcript
    as the JAX streamer; the final one starts with the last partial."""
    port, jax_streamer = _streamers(models, jit_model, speaker,
                                    jax_streamer_fns, "reencode")
    partials, final = _feed(port, audio[0], 2)
    assert (partials, final) == _feed(jax_streamer, audio[0], 2)
    assert port._tokens == jax_streamer._tokens
    assert final.startswith(partials[-1]) and port._tokens


def test_reencode_history_trims_whole_frames(models, jit_model, speaker,
                                            audio, jax_streamer_fns):
    """With max_history_seconds the port decodes every encoder frame
    once; the JAX streamer decodes the last decoded frame again after
    each trim (its window start is one frame late)."""
    port, jax_streamer = _streamers(models, jit_model, speaker,
                                    jax_streamer_fns, "reencode",
                                    max_history_seconds=0.5)
    decoded = {}
    for name, s in (("port", port), ("jax", jax_streamer)):
        greedy = s._greedy_frames

        def counting(frames, name=name, greedy=greedy):
            decoded[name] = decoded.get(name, 0) + frames.shape[1]
            return greedy(frames)

        s._greedy_frames = counting
        _feed(s, audio[0], 4)
    total = ConvolutionFrontEnd.output_length(1 + len(audio[0]) // 160)
    trims = port._dropped_samples // 640
    assert port._dropped_samples == jax_streamer._dropped_samples > 0
    assert decoded["port"] == total
    assert decoded["jax"] > total and trims > 0


def test_kv_overflow_and_missing_speaker_raise(models, speaker, audio):
    """A stream past kv_capacity_seconds raises (JAX overwrites the last
    slots); a model with a speaker branch without speaker_embs raises
    (JAX streams it unconditioned); kv_cache needs a causal model."""
    _, _, model = models
    tr = TSASRTranscriber(model, None, CharTokenizer(PIECES), device="cpu")
    with pytest.raises(ValueError, match="speaker_embs"):
        tr.streaming()
    small = tr.streaming(speaker_embs=speaker[0], kv_capacity_seconds=0.2)
    assert small.kv_capacity == 13
    with pytest.raises(RuntimeError, match="KV cache overflow"):
        small.accept_chunk(audio[0][:SR])
    offline = TSTransducer(TSTransducerConfig(**dict(
        CAUSAL, causal_encoder=False)))
    with pytest.raises(ValueError, match="causal"):
        StreamingTranscriber(offline, None, None, mode="kv_cache",
                             speaker_embs=speaker[0], device="cpu")


# ----------------------------------------------------------- the recipe
@pytest.mark.parametrize("padding,causal", [("same", False),
                                            ("causal", True),
                                            ("reflect", None)])
def test_frontend_padding_reaches_the_model(tmp_path, padding, causal):
    """The port's yamls pass frontend_padding on as frontend_causal; the
    JAX yaml drops it (its model stays reflect-padded)."""
    text = overrides("/data", tmp_path, 31, causal_encoder=True,
                     frontend_padding=padding)
    for name in ("scratch", "none", "wavlm"):
        path = TORCH_YAML.with_name(f"conformer-t_{name}.yaml")
        if causal is None:
            with pytest.raises(ValueError, match="frontend_padding"):
                load_yaml("tsasr_torch", path, text)
            continue
        hp = load_yaml("tsasr_torch", path, text)
        assert hp["model_config"].frontend_causal is causal
        assert all(b.causal is causal for b in hp["model"].frontend.blocks)
        assert hp["model"].encoder.layers[0].conv.causal
    if causal:
        jax_hp = load_yaml("tsasr_tpu", JAX_YAML, text)
        assert jax_hp["model_config"].causal_encoder
        assert not jax_hp["model_config"].frontend_causal


def _causal_experiment(folder, variant, seed=0):
    """An experiment folder as the recipe writes one (its yaml with the
    overrides, tokenizer, one checkpoint on WER) for a causal model at
    the yaml's small widths."""
    from tsasr_torch.training.checkpoints import (Checkpointer,
                                                  PytreeRecoverable)
    from tsasr_torch.utils.hparams import dump_resolved_yaml
    path = TORCH_YAML.with_name(f"conformer-t_{variant}.yaml")
    text = overrides("/data", folder, len(PIECES), causal_encoder=True,
                     frontend_padding="causal")
    dump_resolved_yaml(str(path), text, str(folder / "hyperparams.yaml"))
    hp = load_yaml("tsasr_torch", folder / "hyperparams.yaml",
                   "data_folder: /data\n")
    model = draw_biases(hp["model"].init_weights(seed), seed + 1)
    CharTokenizer(PIECES).save(
        str(folder / "save" / f"char_{len(PIECES)}.json"))
    Checkpointer(str(folder / "save"), {"brain": PytreeRecoverable(
        lambda: {"model": model.state_dict()}, None)}).save_checkpoint(
        meta={"WER": 50.0})


@pytest.mark.parametrize("variant", ["scratch", "none"])
def test_transcribe_streaming_on_a_causal_experiment(tmp_path, capsys,
                                                     audio, variant):
    """``from_experiment`` loads a causal experiment, and ``transcribe
    --streaming`` streams a file in 1 s chunks: with ``--enroll`` its
    embedding conditions a speaker-branch model, which raises without
    it."""
    import json
    from tsasr_torch.tools import transcribe
    _causal_experiment(tmp_path, variant)
    mix, enroll = str(tmp_path / "mix.wav"), str(tmp_path / "enroll.wav")
    write_float_wav(mix, audio[0], SR)
    write_float_wav(enroll, audio[1], SR)
    tr = TSASRTranscriber.from_experiment(str(tmp_path), device="cpu")
    assert tr.model.config.frontend_causal and tr.model.config.causal_encoder
    spk = tr.speaker_embedding(audio[1]) if variant == "scratch" else None
    s = tr.streaming(speaker_embs=spk)
    for lo in range(0, len(audio[0]), SR):
        s.accept_chunk(audio[0][lo:lo + SR])
    want = s.finalize()
    args = ["--experiment", str(tmp_path), mix, "--streaming", "--device",
            "cpu"]
    transcribe.main(args + ["--enroll", enroll])
    line = json.loads(capsys.readouterr().out)
    assert line == {"file": mix, "text": want}
    if variant == "scratch":
        with pytest.raises(ValueError, match="speaker_embs"):
            transcribe.main(args)
