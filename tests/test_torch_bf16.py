"""bf16 compute (``precision: bf16``) in ``tsasr_torch`` against
``tsasr_tpu`` at ``dtype=bfloat16``, on one tiny model with the port's
seeded weights carried to flax (``params_to_flax``, no JAX init), the
JAX applies jitted, torch on one thread.

Tolerances, each relative to the max |value| of the JAX side:

- a bf16 module's output (attention, conformer layer, frontend, LSTM,
  the fused loss and its gradients) within ``MODULE_TOL`` = 2^-6: four
  bf16 roundings of the largest value; the two frameworks round the
  same ops, but sum products and reductions in other orders, so an
  element can land an ulp apart and carry that through a few ops;
- the tiny transducer's encoder output and loss within ``MODEL_TOL`` =
  2^-5, through a dozen layers; against the f32 run of the same weights
  (the port's f32 model, which matches JAX f32 to 1e-4:
  ``tests/test_torch_training.py``), the port's bf16 error at most
  ``F32_RATIO`` = 2 times JAX's own bf16 error, plus ``F32_FLOOR`` =
  1e-3;
- the f32 parameter gradients as one vector, in relative L2 rather than
  relative to the max: a leaky_relu pre-activation within a bf16
  rounding of 0 takes the other slope in one run and not in the other
  (a kink flip, in either package, at places that differ between them
  and from f32), and one flip moves a whole row of an input gradient by
  5-9 % of a leaf's max, where it changes the vector's L2 little. Within
  ``MODEL_TOL`` of JAX, cosine at least ``GRAD_COSINE``, and against f32
  at most ``F32_RATIO`` times JAX's error plus ``GRAD_F32_FLOOR`` =
  2^-6: on three seeds of this model the two packages' L2 errors
  against f32 were 1.5-2.1e-2 (port) and 0.9-1.5e-2 (JAX), flips
  deciding which is larger.

The kernels' plain bf16 versions run against the JAX Pallas kernels in
interpret mode with bf16 operands, and the decoders against the JAX
decoders on bf16 log-probs: greedy on the model token for token where
the top-2 margin of every frame exceeds 4 bf16 ulps, and on exact ties,
which both decide for the lower token id; the batched beam on bf16 rows
on a grid where sums are exact, since JAX's batched beam sums its scores
in bf16 under a bf16 model (its weakly typed initial scores take the
log-probs' dtype in the scan) where the port sums in f32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from torch_port_helpers import (DECODER, DECODER_PIECES, TINY,
                                encoder_output)
from tsasr_tpu.decoding.beam_batched import \
    beam_search_batched as jax_beam_batched
from tsasr_tpu.decoding.greedy import greedy_decode as jax_greedy
from tsasr_tpu.models import attention as jax_attention
from tsasr_tpu.models import conformer as jax_conformer
from tsasr_tpu.models import frontend as jax_frontend
from tsasr_tpu.models import rnn as jax_rnn
from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
from tsasr_tpu.ops import attention_pallas as jax_pallas
from tsasr_tpu.ops.rnnt_loss_fused import \
    rnnt_loss_fused as jax_rnnt_loss_fused
from tsasr_torch.convert import params_to_flax
from tsasr_torch.decoding import (TransducerGreedySearcher,
                                  beam_search_batched, greedy_decode)
from tsasr_torch.kernels import relpos_attention as ra
from tsasr_torch.models import layers
from tsasr_torch.models.attention import RelPosMHAXL, rel_pos_encoding
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.ops.dropout import dropout, keep_mask
from tsasr_torch.ops.rnnt_loss_fused import rnnt_loss_fused
from tsasr_torch.training.brain import onednn_off_on_cpu
from tsasr_torch.utils.precision import compute_dtype

MODULE_TOL = 2.0 ** -6
MODEL_TOL = 2.0 ** -5
F32_RATIO, F32_FLOOR = 2.0, 1e-3
GRAD_COSINE, GRAD_F32_FLOOR = 0.999, 2.0 ** -6
BF16 = torch.bfloat16
CONFIG = dict(TINY, dropout=0.0)
D, H = CONFIG["d_model"], CONFIG["nhead"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("TSASR_ATTN_INTERPRET", "1")


def seeded(dtype, config=CONFIG, seed=0):
    """The port's model in ``dtype`` on seeded weights, every bias and
    LayerNorm scale drawn around its init, the blank's bias lowered."""
    model = TSTransducer(TSTransducerConfig(**config)).init_weights(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif "norm" in name and name.endswith(".weight"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
        model.transducer_head.bias[0] -= 1.0
    if dtype == torch.float32:
        return model.eval()
    other = TSTransducer(TSTransducerConfig(**config, dtype=dtype))
    other.load_state_dict(model.state_dict())
    return other.eval()


@pytest.fixture(scope="module")
def models():
    """(flax params, port f32 model, port bf16 model)."""
    m32 = seeded(torch.float32)
    return ({"params": params_to_flax(m32.state_dict())}, m32,
            seeded(BF16))


def jit_apply(module, method=None):
    return jax.jit(functools.partial(module.apply, method=method))


def rel_err(got, want):
    got, want = (x.detach().double().numpy() if torch.is_tensor(x)
                 else np.asarray(x, np.float64) for x in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_close(got, want, tol, what=""):
    err = rel_err(got, want)
    assert err <= tol, f"{what}: {err:.3e} of max |want| > {tol:.3e}"


def bf16_np(x):
    """numpy f32 values that bf16 holds exactly (inputs both sides read
    the same)."""
    return torch.from_numpy(x).to(BF16).float().numpy()


# ---------------------------------------------------------------- basics
def test_compute_dtype_and_the_f32_path():
    assert compute_dtype(None) == compute_dtype("fp32") == torch.float32
    assert compute_dtype("bf16") == BF16
    with pytest.raises(ValueError, match="fp16"):
        compute_dtype("fp16")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 8, generator=gen)
    for layer, plain in ((layers.Linear(8, 6), nn.Linear(8, 6)),
                         (layers.LayerNorm(8, eps=1e-6),
                          nn.LayerNorm(8, eps=1e-6)),
                         (layers.Conv1d(5, 5, 3, groups=5),
                          nn.Conv1d(5, 5, 3, groups=5))):
        plain.load_state_dict(layer.state_dict())
        assert torch.equal(layer(x), plain(x))      # f32: the torch layer
        layer.compute_dtype = BF16
        assert layer(x).dtype == BF16


@pytest.mark.parametrize("bits", [8, 32])
def test_dropout_masks_and_scaling_across_precisions(bits):
    """One generator state drops the same elements in f32 and bf16; the
    bf16 quotient is JAX's (x / bf16(1 - rate), rounded once)."""
    rate = 0.1
    x = torch.randn(4, 9, 33, generator=torch.Generator().manual_seed(1))
    want_keep = keep_mask(torch.Generator().manual_seed(7), 1 - rate,
                          x.shape, bits)
    outs = {}
    for dtype in (torch.float32, BF16):
        outs[dtype] = dropout(x.to(dtype), torch.Generator().manual_seed(7),
                              rate, bits)
        assert outs[dtype].dtype == dtype
        assert torch.equal(outs[dtype] != 0, want_keep)
    want = jnp.where(jnp.asarray(want_keep.numpy()),
                     jnp.asarray(x.to(BF16).float().numpy()).astype(
                         jnp.bfloat16) / (1.0 - rate), 0.0).astype(
                             jnp.bfloat16)
    np.testing.assert_array_equal(outs[BF16].float().numpy(),
                                  np.asarray(want, np.float32))


def test_f32_state_dict_drives_both_precisions(models):
    _, m32, m16 = models
    a, b = m32.state_dict(), m16.state_dict()
    assert a.keys() == b.keys()
    assert all(b[k].dtype == a[k].dtype == torch.float32 for k in a)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert m16.config.dtype == BF16 and m32.config.dtype == torch.float32


# ---------------------------------------------------------- the kernels
def attention_case(rng, B=2, heads=2, T=13, Dh=8):
    qu, qv, k, v = (bf16_np(rng.normal(size=(B, heads, T, Dh))
                            .astype(np.float32)) for _ in range(4))
    p = bf16_np(rng.normal(size=(heads, 2 * T - 1, Dh)).astype(np.float32))
    kp = np.where(np.arange(T)[None, :] < np.array([[T], [T - 4]])[:B],
                  0.0, -1e9).astype(np.float32)
    am = np.where(np.triu(np.ones((T, T)), 3) > 0, -1e9, 0.0).astype(
        np.float32)
    return qu, qv, k, v, p, kp, am


def test_kernel_plain_versions_match_jax_kernels(rng):
    """The plain bf16 forward against the JAX Pallas forward (interpret)
    and its jnp oracle, and the plain bf16 backward against the Pallas
    backward through the custom VJP, all with bf16 operands."""
    args = attention_case(rng)
    scale = 0.25
    do = bf16_np(rng.normal(size=args[0].shape).astype(np.float32))
    t = [torch.from_numpy(a) for a in args]
    t = [x.to(BF16) for x in t[:5]] + t[5:]
    got = ra.relpos_attention_fwd_bf16(*t, scale)
    grads = ra.relpos_attention_bwd_bf16(
        *t, torch.from_numpy(do).to(BF16), scale)
    assert got.dtype == BF16 and all(g.dtype == BF16 for g in grads)

    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in args[:5]] + \
        [jnp.asarray(a) for a in args[5:]]
    seed = jnp.zeros((), jnp.float32)

    def fused(qu, qv, k, v, p):
        return jax_pallas.fused_relpos_attention(qu, qv, k, v, p, j[5], j[6],
                                                 seed, scale, 0.0, True)

    want, vjp = jax.vjp(fused, *j[:5])
    want_grads = vjp(jnp.asarray(do).astype(jnp.bfloat16))
    oracle = jax_pallas.relpos_attention_reference(*j, scale)
    assert_close(got.float(), np.asarray(want, np.float32), MODULE_TOL, "out")
    assert_close(got.float(), np.asarray(oracle, np.float32), MODULE_TOL,
                 "oracle")
    for name, g, w in zip(("dqu", "dqv", "dk", "dv", "dp"), grads,
                          want_grads):
        assert_close(g.float(), np.asarray(w, np.float32), MODULE_TOL, name)


def test_wrapper_takes_the_bf16_plain_version_on_cpu(rng):
    """A bf16 CPU tensor goes to the plain bf16 version, whose autograd
    is its explicit backward; no kernel counts move; other dtypes raise
    on the card's checks."""
    args = attention_case(rng)
    leaves = [torch.from_numpy(a).to(BF16).requires_grad_()
              for a in args[:5]]
    masks = [torch.from_numpy(a) for a in args[5:]]
    before = (ra.bf16_launches, ra.bf16_bwd_launches)
    out = ra.fused_relpos_attention(*leaves, *masks, seed=5, scale=0.25,
                                    rate=0.1)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    out.backward(do.to(BF16))
    want = ra.relpos_attention_bwd_bf16(*[x.detach() for x in leaves],
                                        *masks, do, 0.25, 5, 0.1)
    assert all(torch.equal(x.grad, w) for x, w in zip(leaves, want))
    assert (ra.bf16_launches, ra.bf16_bwd_launches) == before
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ra._check(*[x.detach().half() for x in leaves], *masks)


# ------------------------------------------------------------ the modules
@pytest.mark.parametrize("fused", [False, True])
def test_attention_module(models, rng, fused):
    params, _, _ = models
    B, T = 2, 11
    x = bf16_np(rng.normal(size=(B, T, D)).astype(np.float32))
    kpm = np.arange(T)[None, :] >= np.array([[T], [T - 3]])
    module = jax_attention.RelPosMHAXL(embed_dim=D, num_heads=H,
                                       fused=fused, dtype=jnp.bfloat16)
    want, _ = jit_apply(module)(
        {"params": params["params"]["encoder"]["layer_0"]["mha"]},
        jnp.asarray(x, jnp.bfloat16),
        jax_attention.rel_pos_encoding(T, D, jnp.bfloat16),
        jnp.asarray(kpm))
    mha = RelPosMHAXL(D, H, fused=fused, dtype=BF16)
    mha.load_state_dict(models[2].encoder.layers[0].mha.state_dict())
    got, _ = mha(torch.from_numpy(x).to(BF16), rel_pos_encoding(T, D),
                 torch.from_numpy(kpm))
    assert got.dtype == BF16
    assert_close(got.float(), np.asarray(want, np.float32), MODULE_TOL)


def test_conformer_layer(models, rng):
    params, _, m16 = models
    B, T = 2, 13
    x = bf16_np(rng.normal(size=(B, T, D)).astype(np.float32))
    kpm = np.arange(T)[None, :] >= np.array([[T], [T - 4]])
    layer = jax_conformer.ConformerEncoderLayer(
        d_model=D, d_ffn=CONFIG["d_ffn"], nhead=H,
        kernel_size=CONFIG["kernel_size"], fused_attention=True,
        activation=jax.nn.leaky_relu, dtype=jnp.bfloat16)
    want, _ = jit_apply(layer)(
        {"params": params["params"]["encoder"]["layer_0"]},
        jnp.asarray(x, jnp.bfloat16),
        jax_attention.rel_pos_encoding(T, D, jnp.bfloat16), jnp.asarray(kpm))
    got, _ = m16.encoder.layers[0](torch.from_numpy(x).to(BF16),
                                   rel_pos_encoding(T, D, dtype=BF16),
                                   torch.from_numpy(kpm))
    assert got.dtype == BF16
    assert_close(got.float(), np.asarray(want, np.float32), MODULE_TOL)


def test_frontend(models, rng):
    params, _, m16 = models
    x = rng.normal(size=(2, 37, 80)).astype(np.float32)
    frontend = jax_frontend.ConvolutionFrontEnd(
        out_channels=CONFIG["frontend_channels"], dtype=jnp.bfloat16)
    want = jit_apply(frontend)({"params": params["params"]["frontend"]},
                               jnp.asarray(x))
    got = m16.frontend(torch.from_numpy(x))         # f32 features in
    assert got.dtype == BF16 and got.shape == (2, 10, 20, 8)
    assert_close(got.float(), np.asarray(want, np.float32), MODULE_TOL)


@pytest.mark.parametrize("method", ["__call__", "step"])
def test_lstm(models, rng, method):
    params, _, m16 = models
    B, V1, Hd = 3, CONFIG.get("vocab_size", 29) - 1, CONFIG["decoder_neurons"]
    lstm = jax_rnn.LSTM(hidden_size=Hd, in_features=V1, dtype=jnp.bfloat16)
    p = {"params": params["params"]["predictor"]["decoder"]}
    h0 = rng.normal(size=(1, B, Hd)).astype(np.float32)
    c0 = rng.normal(size=(1, B, Hd)).astype(np.float32)
    port = m16.predictor.decoder
    if method == "step":
        x = rng.normal(size=(B, V1)).astype(np.float32)
        want, (wh, wc) = jit_apply(lstm, "step")(
            p, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)))
        got, (h, c) = port.step(torch.from_numpy(x), (torch.from_numpy(h0),
                                                      torch.from_numpy(c0)))
    else:
        x = rng.normal(size=(B, 6, V1)).astype(np.float32)
        want, (wh, wc) = jit_apply(lstm)(p, jnp.asarray(x),
                                         (jnp.asarray(h0), jnp.asarray(c0)))
        got, (h, c) = port(torch.from_numpy(x), (torch.from_numpy(h0),
                                                 torch.from_numpy(c0)))
    for g, w in ((got, want), (h, wh), (c, wc)):
        assert g.dtype == BF16
        assert_close(g.float(), np.asarray(w, np.float32), MODULE_TOL)


def test_fused_loss_forward_and_gradients(models, rng):
    """bf16 enc and dec, f32 head parameters, the f32 lattice."""
    _, _, m16 = models
    B, T, U, J = 2, 9, 4, CONFIG["joint_dim"]
    enc = bf16_np(rng.normal(size=(B, T, J)).astype(np.float32))
    dec = bf16_np(rng.normal(size=(B, U + 1, J)).astype(np.float32))
    labels = rng.integers(1, 29, size=(B, U)).astype(np.int32)
    t_lens, u_lens = np.array([T, T - 3]), np.array([U, U - 1])
    w = m16.transducer_head.weight.detach().t().contiguous()
    b = m16.transducer_head.bias.detach()

    def jax_loss(enc, dec, w, b):
        return jax_rnnt_loss_fused(enc, dec, w, b, jnp.asarray(labels),
                                   jnp.asarray(t_lens), jnp.asarray(u_lens),
                                   chunk=4, use_pallas=False).sum()

    want, want_grads = jax.jit(jax.value_and_grad(jax_loss, (0, 1, 2, 3)))(
        jnp.asarray(enc, jnp.bfloat16), jnp.asarray(dec, jnp.bfloat16),
        jnp.asarray(w.numpy()), jnp.asarray(b.numpy()))
    leaves = [torch.from_numpy(enc).to(BF16).requires_grad_(),
              torch.from_numpy(dec).to(BF16).requires_grad_(),
              w.clone().requires_grad_(), b.clone().requires_grad_()]
    loss = rnnt_loss_fused(*leaves, torch.from_numpy(labels),
                           torch.from_numpy(t_lens), torch.from_numpy(u_lens),
                           chunk=4).sum()
    loss.backward()
    assert_close(loss.item(), float(want), MODULE_TOL, "loss")
    for name, leaf, g in zip(("enc", "dec", "w", "b"), leaves, want_grads):
        assert leaf.grad.dtype == leaf.dtype
        assert_close(leaf.grad.float(), np.asarray(g, np.float32),
                     MODULE_TOL, name)


# ------------------------------------------------------------- the model
def model_batch():
    rng = np.random.default_rng(11)
    bos = np.concatenate([np.zeros((2, 1), np.int64),
                          rng.integers(1, 29, size=(2, 5))], axis=1)
    return dict(feats=rng.normal(size=(2, 57, 80)).astype(np.float32),
                rel=np.array([1.0, 0.75], np.float32),
                enroll=rng.normal(size=(2, 41, 80)).astype(np.float32),
                enroll_rel=np.array([1.0, 0.8], np.float32),
                bos=bos, tokens=bos[:, 1:], u_lens=np.array([5, 4]))


def port_loss(model, batch):
    """(enc_out, loss, {name: grad}) of one fused-loss forward."""
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.zero_grad()
    with onednn_off_on_cpu("cpu"):
        enc, dec = model.encode_predict(t["feats"], t["rel"], t["bos"],
                                        t["enroll"], t["enroll_rel"])
        t_lens = torch.round(t["rel"] * enc.shape[1]).to(torch.int32)
        head = model.transducer_head
        loss = rnnt_loss_fused(enc, dec, head.weight.t(), head.bias,
                               t["tokens"], t_lens, t["u_lens"],
                               chunk=4).mean()
        loss.backward()
    return enc.detach().float(), loss.item(), {
        n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def model_runs():
    """The JAX bf16 model's and both port models' encoder output, loss
    and gradients on one batch, dropout off."""
    m32, m16 = seeded(torch.float32), seeded(BF16)
    params = {"params": params_to_flax(m32.state_dict())}
    jmodel = JaxTransducer(JaxConfig(**CONFIG, dtype=jnp.bfloat16))
    batch = model_batch()
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        enc, dec = jmodel.apply(p, b["feats"], b["rel"], b["bos"],
                                b["enroll"], b["enroll_rel"],
                                method="encode_predict")
        t_lens = jnp.round(b["rel"] * enc.shape[1]).astype(jnp.int32)
        head = p["params"]["transducer_head"]
        loss = jax_rnnt_loss_fused(enc, dec, head["kernel"], head["bias"],
                                   b["tokens"], t_lens, b["u_lens"], chunk=4,
                                   use_pallas=False).mean()
        return loss, enc

    (loss, enc), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    want = (np.asarray(enc, np.float32), float(loss),
            params_to_flat(grads["params"]))
    return want, port_loss(m32, batch), port_loss(m16, batch)


def params_to_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(params_to_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def port_grads_flat(grads):
    return params_to_flat(params_to_flax(grads))


def test_model_encoder_output_and_loss(model_runs):
    (w_enc, w_loss, _), (f_enc, f_loss, _), (enc, loss, _) = model_runs
    assert_close(enc, w_enc, MODEL_TOL, "enc")
    assert_close(loss, w_loss, MODEL_TOL, "loss")
    for got, want, f32 in ((enc, w_enc, f_enc), (loss, w_loss, f_loss)):
        assert rel_err(got, f32) <= F32_RATIO * rel_err(want, f32) \
            + F32_FLOOR


def test_model_parameter_gradients(model_runs):
    (_, _, w_grads), (_, _, f_grads), (_, _, grads) = model_runs
    got, f32 = port_grads_flat(grads), port_grads_flat(f_grads)
    assert got.keys() == w_grads.keys()
    assert all(g.dtype == torch.float32 for g in grads.values())
    keys = sorted(w_grads)
    got, want, f32 = (np.concatenate([np.ravel(d[k]).astype(np.float64)
                                      for k in keys])
                      for d in (got, w_grads, f32))

    def l2(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert l2(got, want) <= MODEL_TOL
    cosine = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cosine >= GRAD_COSINE
    assert l2(got, f32) <= F32_RATIO * l2(want, f32) + GRAD_F32_FLOOR


# ------------------------------------------------------------- decoding
def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def test_greedy_tokens_match_jax():
    """The decoder-sized bf16 model on a drawn encoder output: the same
    greedy tokens from both packages on every utterance whose top-2
    margin, on each frame the JAX search visits, exceeds 4 bf16 ulps or
    is an exact tie (both take the lower token id)."""
    from tsasr_tpu.decoding import TransducerGreedySearcher as JaxGreedy
    config = dict(DECODER, vocab_size=len(DECODER_PIECES))
    model = seeded(BF16, config)
    params = {"params": params_to_flax(model.state_dict())}
    jmodel = JaxTransducer(JaxConfig(**config, dtype=jnp.bfloat16))
    enc, rel = encoder_output(batch=6)
    enc = bf16_np(enc)
    jgreedy = JaxGreedy(jmodel, params)
    w_tokens = np.asarray(jgreedy._jitted(
        params, jnp.asarray(enc, jnp.bfloat16), jnp.asarray(rel))[0])
    predict = jit_apply(jmodel, "predict_step")
    joint = jit_apply(jmodel, "joint_logits")
    state = jmodel.apply(params, enc.shape[0],
                         method="predictor_initial_state")
    dec, state = predict(params, jnp.zeros(enc.shape[0], jnp.int32), state)
    clear = np.ones(enc.shape[0], bool)
    for t in range(enc.shape[1]):
        lp = np.asarray(jax.nn.log_softmax(joint(
            params, jnp.asarray(enc[:, t, None], jnp.bfloat16),
            dec[:, None])[:, 0]), np.float32)
        top2 = np.sort(lp, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        clear &= (margin > 4 * bf16_ulp(top2[:, 1])) | (margin == 0)
        tok = w_tokens[:, t]
        new_dec, new_state = predict(params, jnp.asarray(tok), state)
        emit = jnp.asarray(tok != 0)
        dec = jnp.where(emit[:, None], new_dec, dec)
        state = jax.tree.map(
            lambda n, o: jnp.where(emit[None, :, None], n, o), new_state,
            state)
    assert clear.sum() >= 3
    got = TransducerGreedySearcher(model)(torch.from_numpy(enc).to(BF16),
                                          torch.from_numpy(rel))
    want = jgreedy(jnp.asarray(enc, jnp.bfloat16), jnp.asarray(rel))
    assert all(got[0][b] == want[0][b] for b in np.flatnonzero(clear))
    assert any(got[0])


def grid_rows(rng, B, T, V):
    """bf16 log-prob rows on a grid of 1/2 in [-4, -0.5]: any sum of a
    few hundred of them is exact in bf16 as in f32 (JAX's batched beam
    sums its scores in bf16 under a bf16 model, the port in f32)."""
    return bf16_np(-0.5 * rng.integers(1, 9, size=(B, T, V))
                   .astype(np.float32))


@pytest.mark.parametrize("tie", [False, True])
def test_batched_beam_on_bf16_log_probs_matches_jax(rng, tie):
    """Both packages' batched beams over the same bf16 log-prob rows (the
    synthetic joint returns the frame's row): the same hypotheses, token
    for token, and the same scores. ``tie`` puts exact ties between
    tokens on every frame, which both decide for the lower token id."""
    B, T, V, K = 3, 6, 6, 3
    rows = grid_rows(rng, B, T, V)
    if tie:
        rows[:, :, 4] = rows[:, :, 2] = rows[:, :, 1:].max(-1)
    enc_t = torch.from_numpy(rows).to(BF16)
    enc_j = jnp.asarray(rows, jnp.bfloat16)

    def t_predict(tokens, state):
        return torch.zeros(tokens.shape[0], 4, dtype=BF16), state

    def j_predict(tokens, state):
        return jnp.zeros((tokens.shape[0], 4), jnp.bfloat16), state

    got = beam_search_batched(t_predict, lambda e, d: e,
                              (torch.zeros(1, B * K, 1),), enc_t,
                              beam_size=K)
    want = jax_beam_batched(j_predict, lambda e, d: e,
                            (jnp.zeros((1, B * K, 1)),), enc_j, beam_size=K)
    tokens, lengths, scores = (np.asarray(x.float() if x.is_floating_point()
                                          else x) for x in got)
    w_tokens, w_lengths, w_scores = (np.asarray(x, np.float32)
                                     if x.dtype == jnp.bfloat16
                                     else np.asarray(x) for x in want)
    np.testing.assert_array_equal(lengths, w_lengths)
    np.testing.assert_array_equal(tokens, w_tokens)
    # the normalized scores: the port divides in f32, JAX in bf16
    np.testing.assert_allclose(scores, w_scores, rtol=2.0 ** -8)


def test_bf16_ties_decide_alike_in_greedy():
    """Exact ties between tokens in bf16 log-probs: both packages' greedy
    searches take the lower token id."""
    V, T = 6, 5
    rows = np.full((1, T, V), -4.0, np.float32)
    rows[0, :, 0] = -3.0                        # blank
    rows[0, 1, [2, 4]] = -0.25                  # tie: 2 and 4
    rows[0, 3, [5, 3]] = -0.5                   # tie: 3 and 5
    rows = bf16_np(rows)

    def t_predict(tokens, state):
        return torch.zeros(tokens.shape[0], 4, dtype=BF16), state

    def j_predict(tokens, state):
        return jnp.zeros((tokens.shape[0], 4), jnp.bfloat16), state

    got, _, _ = greedy_decode(t_predict, lambda e, d: e,
                              (torch.zeros(1, 1, 1),),
                              torch.from_numpy(rows).to(BF16))
    want, _, _ = jax_greedy(j_predict, lambda e, d: e,
                            (jnp.zeros((1, 1, 1)),),
                            jnp.asarray(rows, jnp.bfloat16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 1] == 2 and got[0, 3] == 3


# ---------------------------------------------------------- the recipe
def served_dtype(folder):
    """The compute dtype ``from_experiment`` serves ``folder``'s run in."""
    from tsasr_torch.inference import TSASRTranscriber
    return TSASRTranscriber.from_experiment(
        str(folder), device="cpu").model.config.dtype


def test_bf16_experiment_checkpoint_resumes_in_f32(tmp_path, monkeypatch):
    """``--precision bf16`` through ``run_experiment`` on the CPU for one
    optimizer step (one micro-batch, no TEST): a bf16 model, f32
    parameters and AdamW state; its checkpoint is f32 and an f32 run
    resumes from it bit for bit and takes the next step."""
    from torch_port_helpers import CORPUS, TORCH_YAML, corpus_vocab
    from tsasr_torch.recipes.librispeechmix import TSASRBrain, run_experiment
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset
    corpus = tmp_path / "corpus"
    make_dataset(str(corpus), **dict(CORPUS, n_mix=4))
    out = tmp_path / "out"

    def argv(*extra):
        return [str(TORCH_YAML), "--data_folder", str(corpus),
                "--output_folder", str(out), "--device", "cpu",
                "--vocab_size", str(corpus_vocab(str(corpus))),
                "--encoder_num_layers", "1",
                "--d_ffn", "32", "--d_model", "16", "--nhead", "2",
                "--decoder_neurons", "16", "--joint_dim", "16",
                "--beam_size", "1", "--test_splits", "[]",
                "--grad_accumulation_factor", "1",
                "--noprogressbar", "--fused_attention", "True", *extra]

    brain = run_experiment(argv=argv("--precision", "bf16",
                                     "--optimizer_step_limit", "1"))
    assert brain.model.config.dtype == BF16 and brain.precision == "bf16"
    # the folder records the flag: it is served as it was trained
    assert served_dtype(out) == BF16
    assert brain.optimizer_step == 1
    assert all(p.dtype == torch.float32 for p in brain.model.parameters())
    assert all(v.dtype == torch.float32
               for s in brain.optimizer.state.values() for v in s.values()
               if torch.is_tensor(v) and v.is_floating_point())
    trained = {k: v.clone() for k, v in brain.model.state_dict().items()}

    starts = []
    fit_train = TSASRBrain._fit_train

    def recording(self, train_set, epoch):
        starts.append({k: v.clone() for k, v in
                       self.model.state_dict().items()})
        return fit_train(self, train_set, epoch)

    monkeypatch.setattr(TSASRBrain, "_fit_train", recording)
    resumed = run_experiment(argv=argv("--num_epochs", "2",
                                       "--optimizer_step_limit", "2"))
    assert resumed.model.config.dtype == torch.float32
    assert served_dtype(out) == torch.float32
    assert len(starts) == 1                         # epoch 2 only
    assert all(torch.equal(starts[0][k], trained[k]) for k in trained)
    assert resumed.optimizer_step == 2
    assert all(torch.isfinite(p).all() for p in resumed.model.parameters())


def test_streaming_a_bf16_model_raises(models):
    """A bf16 model's stream state, which raised until bf16 streaming was
    ported (``tests/test_torch_run_flags.py`` streams one against JAX):
    every cache in bf16, as the JAX ``init_stream_state`` builds them in
    the model's dtype, and its f32 twin's (the same state_dict) in f32;
    nothing raises."""
    _, m32, m16 = models
    for model, dtype in ((m16, BF16), (m32, torch.float32)):
        state = model.init_stream_state(1, 8)
        assert len(state["encoder"]) == CONFIG["encoder_num_layers"]
        caches = state["frontend"] + [c for layer in state["encoder"] for c
                                      in (layer["attn"]["k"],
                                          layer["attn"]["v"], layer["conv"])]
        assert all(c.dtype == dtype for c in caches)


def test_precision_config_raises_on_other_dtypes():
    with pytest.raises(ValueError, match="float16"):
        TSTransducerConfig(dtype=torch.float16)
    config = TSTransducerConfig(**CONFIG)
    assert dataclasses.replace(config, dtype=BF16).dtype == BF16
