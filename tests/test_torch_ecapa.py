"""The ECAPA-TDNN speaker branch and the frame-level WavLM features in the
port against the JAX package.

- the ECAPA blocks (TDNN, Res2Net, SE, attentive statistics pooling,
  SE-Res2Net) and the whole ``ECAPA_TDNN`` at JAX's own test size
  (channels 16, 16, 16, 16, 48; 24 embedding dimensions), on lengths
  below T and BatchNorm statistics away from their defaults, the port's
  seeded weights and statistics carried into flax (``params_to_flax``,
  ``batch_stats_to_flax``): 2e-5 a block, 1e-4 through the branch;
  ``params_from_flax`` brings the flax variables back bit for bit;
- the transducer with ``speaker_encoder_type: ecapa``: one TRAIN
  micro-batch through both recipes' ``TSASRBrain`` (the fused loss,
  dropout 0), the loss within 1e-5 and every gradient leaf within 1e-4
  of its max |g| (as ``tests/test_torch_training.py``); the step leaves
  the statistics where they were;
- the pinned deviation: JAX's gradient reaches every BatchNorm
  statistic (its train step differentiates the whole ``model.init``
  tree), while one port optimizer step leaves them bit for bit;
- ``FrozenSpeakerEncoder(frame_level=True)`` against the JAX
  ``JaxSpeakerEncoder(frame_level=True)`` on one seeded WavLM checkpoint
  directory: the first ``embedding_dim`` channels of the last hidden
  state, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY
from tsasr_tpu.models import ecapa as jax_ecapa
from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
from tsasr_tpu.recipes.librispeechmix import TSASRBrain as JaxBrain
from tsasr_tpu.utils.stage import Stage as JaxStage
from tsasr_torch.convert import (batch_stats_to_flax, params_from_flax,
                                 params_to_flax)
from tsasr_torch.data.tokenizer import CharTokenizer
from tsasr_torch.models.ecapa import FrozenBatchNorm
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.recipes.librispeechmix import TSASRBrain
from tsasr_torch.training import make_adamw
from tsasr_torch.training.brain import onednn_off_on_cpu
from tsasr_torch.utils.stage import Stage

from test_torch_training import HPARAMS, OPT, PIECES, _flat, make_batch

ECAPA = dict(TINY, dropout=0.0, speaker_encoder_type="ecapa",
             ecapa_channels=(16, 16, 16, 16, 48), ecapa_lin_neurons=24)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def seeded():
    """(the port's ECAPA transducer with non-default BatchNorm statistics
    and biases, its flax variables)."""
    model = TSTransducer(TSTransducerConfig(**ECAPA)).init_weights(seed=2)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for module in model.speaker_encoder.modules():
            if isinstance(module, FrozenBatchNorm):
                module.mean.normal_(0, 0.2, generator=gen)
                module.var.uniform_(0.5, 2.0, generator=gen)
                module.weight.uniform_(0.8, 1.2, generator=gen)
                module.bias.normal_(0, 0.1, generator=gen)
        for name, p in model.speaker_encoder.named_parameters():
            if name.endswith("conv.bias") or name.endswith("fc.bias"):
                p.normal_(0, 0.1, generator=gen)
    state = model.state_dict()
    variables = {"params": params_to_flax(state),
                 "batch_stats": batch_stats_to_flax(state)}
    return model.eval(), variables


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _part(variables, *path):
    out = {}
    for collection, tree in variables.items():
        for name in path:
            tree = tree.get(name, {})
        if tree:
            out[collection] = tree
    return out


def test_variables_come_back_bit_for_bit(seeded):
    model, variables = seeded
    assert set(variables["batch_stats"]) == {"speaker_encoder"}
    back = params_from_flax(variables)
    state = model.state_dict()
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)


def test_blocks_match_jax(seeded, rng):
    model, variables = seeded
    ecapa = model.speaker_encoder
    se_res2net = ecapa.blocks[1]
    rel = np.array([1.0, 0.75, 0.5], np.float32)
    cases = [  # (JAX block, its path, the port's, input width, lengths)
        (jax_ecapa.TDNNBlock(16, 5, 1), ("block_0",), ecapa.blocks[0], 80,
         False),
        (jax_ecapa.Res2NetBlock(16, 8, 3, 2), ("block_1", "res2net"),
         se_res2net.res2net, 16, False),
        (jax_ecapa.SEBlock(128, 16), ("block_1", "se"), se_res2net.se, 16,
         True),
        (jax_ecapa.SERes2NetBlock(16, 8, 128, 3, 2), ("block_1",),
         se_res2net, 16, True),
        (jax_ecapa.AttentiveStatisticsPooling(), ("asp",), ecapa.asp, 48,
         True)]
    for jax_block, path, block, width, lengths in cases:
        x = rng.normal(size=(3, 29, width)).astype(np.float32)
        args = (jnp.asarray(rel),) if lengths else ()
        want = jax.jit(jax_block.apply)(
            _part(variables, "speaker_encoder", *path), jnp.asarray(x), *args)
        args = (torch.from_numpy(rel),) if lengths else ()
        with torch.no_grad():
            got = block(torch.from_numpy(x).transpose(1, 2), *args)
        _close(got.transpose(1, 2), want, 2e-5)


def test_branch_matches_jax(seeded, rng):
    model, variables = seeded
    x = rng.normal(size=(3, 41, 80)).astype(np.float32)
    rel = np.array([1.0, 0.8, 0.45], np.float32)
    branch = jax_ecapa.ECAPA_TDNN(jax_ecapa.ECAPAConfig(
        input_size=80, channels=(16, 16, 16, 16, 48), lin_neurons=24))
    want = jax.jit(branch.apply)(_part(variables, "speaker_encoder"),
                                 jnp.asarray(x), jnp.asarray(rel))
    with torch.no_grad():
        got = model.speaker_encoder(torch.from_numpy(x), torch.from_numpy(rel))
        spk = model.extract_speaker(torch.from_numpy(x),
                                    torch.from_numpy(rel))
    assert got.shape == (3, 1, 24) and spk.shape == (3, 1, TINY["d_model"])
    _close(got, want, 1e-4)
    # the branch pools over time, so it cannot feed cross_attention
    with pytest.raises(ValueError, match="cross_attention"):
        TSTransducer(TSTransducerConfig(**dict(
            ECAPA, injection_mode="cross_attention")))


@pytest.fixture(scope="module")
def jax_step(seeded):
    """One TRAIN batch, and JAX's loss and its gradient with respect to
    the whole ``model.init`` tree, ``params`` and ``batch_stats``: the JAX
    recipe's ``_init_params`` returns the whole tree and its train step
    differentiates all of it (``training/brain.py``)."""
    _, variables = seeded
    jbrain = JaxBrain(modules={"model": JaxTransducer(JaxConfig(**ECAPA))},
                      hparams=HPARAMS, variant="scratch")
    batch = make_batch(3)
    arrays = jbrain.batch_to_arrays(batch)

    def loss_fn(v):
        preds = jbrain.compute_forward(v, arrays, JaxStage.TRAIN,
                                       jax.random.PRNGKey(1))
        return jbrain.compute_objectives(preds, arrays, JaxStage.TRAIN)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    return batch, loss, jax.device_get(grads)


def test_ecapa_transducer_trains_as_jax(seeded, jax_step):
    model, _ = seeded
    batch, want_loss, want_grads = jax_step
    torch_model = TSTransducer(TSTransducerConfig(**ECAPA))
    torch_model.load_state_dict(model.state_dict())
    stats = {k: v.clone() for k, v in torch_model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    brain = TSASRBrain(modules={"model": torch_model}, hparams=HPARAMS,
                       run_opts={"device": "cpu"},
                       tokenizer=CharTokenizer(PIECES))
    tensors = brain._put_batch(brain.batch_to_arrays(batch))
    names, leaves = zip(*brain.model.named_parameters())
    with onednn_off_on_cpu(brain.device):
        preds = brain.compute_forward(tensors, Stage.TRAIN,
                                      brain.step_generator())
        loss = brain.compute_objectives(preds, tensors, Stage.TRAIN)
        grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = _flat(params_to_flax(dict(zip(names, grads))))
    want = _flat(want_grads["params"])
    assert got.keys() == want.keys()
    for key in want:
        # the pooling attention's bias has a 0 gradient in exact
        # arithmetic (a softmax over time does not see a shift shared by
        # every frame): rounding noise on both sides, held at the scale
        # of the same conv's kernel
        scale = want[key.replace("['asp']['conv']['bias']",
                                 "['asp']['conv']['kernel']")]
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-4 * np.abs(scale).max(),
                                   err_msg=key)
    after = brain.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in stats.items())


def test_statistics_get_gradients_in_jax_and_stay_fixed_in_the_port(
        seeded, jax_step):
    """The port's pinned deviation (ROADMAP.md, section 3, item 15): JAX
    differentiates the ECAPA BatchNorm statistics with the weights, so
    its optimizer moves them (the clip norm counts them, AdamW's decay
    pulls the variances towards 0); the port keeps them fixed, as JAX's
    own "frozen-BN convention" comment intends. One port optimizer step
    (AdamW with weight decay) moves the weights and leaves every
    statistic bit for bit where it was."""
    model, variables = seeded
    batch, _, grads = jax_step
    stats = _flat(grads["batch_stats"])
    assert stats.keys() == _flat(variables["batch_stats"]).keys()
    assert all(np.abs(g).max() > 0 for g in stats.values())

    torch_model = TSTransducer(TSTransducerConfig(**ECAPA))
    torch_model.load_state_dict(model.state_dict())
    brain = TSASRBrain(modules={"model": torch_model},
                       opt_class=make_adamw(**OPT),
                       hparams=dict(HPARAMS, grad_accumulation_factor=1),
                       run_opts={"device": "cpu"},
                       tokenizer=CharTokenizer(PIECES))
    held = {f"{name}.{key}": buf for name, module in
            torch_model.named_modules() if isinstance(module,
                                                      FrozenBatchNorm)
            for key, buf in module.named_buffers()}
    before = {k: v.clone() for k, v in held.items()}
    weights = [p.detach().clone() for p in torch_model.parameters()]
    brain.fit_batch(batch)
    assert brain.optimizer_step == 1
    assert len(held) == len(stats)
    for key, buf in held.items():
        assert not buf.requires_grad and torch.equal(buf, before[key]), key
    assert any(not torch.equal(a, p) for a, p in
               zip(weights, torch_model.parameters()))


def test_frame_level_wavlm_matches_jax(tmp_path):
    pytest.importorskip("safetensors")
    from tsasr_tpu.recipes.speaker_embeddings import JaxSpeakerEncoder
    from tsasr_torch.models import wavlm
    from tsasr_torch.recipes.speaker_embeddings import FrozenSpeakerEncoder
    from test_torch_wavlm import enrollments, seeded_model

    wavlm.save_pretrained_xvector(seeded_model(), str(tmp_path / "ckpt"))
    enc = FrozenSpeakerEncoder(str(tmp_path / "ckpt"), frame_level=True,
                               embedding_dim=24, device="cpu")
    x, rel = enrollments()
    got = enc.embed(torch.from_numpy(x), torch.from_numpy(rel))
    jenc = JaxSpeakerEncoder(str(tmp_path / "ckpt"), frame_level=True,
                             embedding_dim=24)
    want = np.asarray(jax.jit(jenc.embed)(jnp.asarray(x), jnp.asarray(rel)))
    assert got.shape == want.shape and got.shape[-1] == 24
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="hidden states have 32"):
        FrozenSpeakerEncoder(str(tmp_path / "ckpt"), frame_level=True,
                             embedding_dim=40, device="cpu")
