"""The port's training slice against the JAX package on one tiny model
with the same (converted) weights and the same numpy batches, at dropout
0 (the two frameworks draw different random bits).

- ``TSASRBrain.compute_forward`` + ``compute_objectives``: the loss and
  every gradient leaf against ``jax.value_and_grad`` of the JAX
  ``TSASRBrain``'s, under the JAX names (``convert.params_to_flax``).
  f32 through a dozen ops: 1e-4 of each leaf's max |g|.
- four micro-batches at accumulation 2 with clipping on: the parameters
  after each optimizer step against the JAX ``_build_train_step``.
  The learning rate and weight decay are raised so an update's effect
  (~2.5e-3 per element) stands above the f32 tolerance, 2e-5. Adam
  scales each element by its own history, so an element whose two
  micro-batch gradients nearly cancel turns a 1e-6 relative gradient
  difference into a visible update difference: all elements within
  0.1 lr (2.5e-4), all but 1 in 1000 within 2e-5.
- a nonfinite micro-batch is skipped without advancing any counter;
- the Noam schedule's values, and the dropout keep rates."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY
from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
from tsasr_tpu.recipes.librispeechmix import TSASRBrain as JaxBrain
from tsasr_tpu.training.optimizers import make_adamw as jax_make_adamw
from tsasr_tpu.training.schedulers import NoamScheduler as JaxNoam
from tsasr_tpu.training.schedulers import noam_schedule as jax_noam
from tsasr_tpu.utils.stage import Stage as JaxStage
from tsasr_torch.convert import params_from_flax, params_to_flax
from tsasr_torch.data.batch import PaddedBatch
from tsasr_torch.data.tokenizer import CharTokenizer
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.ops.dropout import Dropout, keep_mask
from tsasr_torch.recipes.librispeechmix import TSASRBrain
from tsasr_torch.training import NoamScheduler, make_adamw, noam_schedule
from tsasr_torch.training.brain import onednn_off_on_cpu
from tsasr_torch.utils.stage import Stage

CONFIG = dict(TINY, dropout=0.0)
HPARAMS = {"sample_rate": 16000, "n_fft": 512, "n_mels": 80,
           "win_length": 32, "augment": False, "blank_index": 0,
           "pad_feats_to": 32, "fused_joint_loss": True,
           "fused_loss_chunk": 3, "valid_search_freq": 1}
OPT = dict(lr=1e-2, betas=(0.9, 0.98), eps=1e-8, weight_decay=0.5)
PIECES = ["<unk>", "▁"] + list("abcdefghijklmnopqrstuvwxyz'")


def make_batch(seed, n=2, samples=6000, tokens=5):
    """A PaddedBatch in the JAX recipe's form, ragged in every length."""
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


def _assert_trees_close(got, want, rel, absolute=0.0):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for key in want:
        tol = rel * np.abs(want[key]).max() + absolute
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0,
                                   err_msg=key)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: beside other test processes a multi-threaded
    op's wait for all its threads costs more than the op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side():
    model = JaxTransducer(JaxConfig(**CONFIG))
    brain = JaxBrain(modules={"model": model}, hparams=HPARAMS,
                     variant="scratch")
    arrays = brain.batch_to_arrays(make_batch(0))
    # compiled: the same values as the eager init, bit for bit, in a
    # quarter of the time
    params = jax.jit(brain._init_params)(jax.random.PRNGKey(0), arrays)
    params = jax.tree.map(lambda x: np.array(x, np.float32), params)
    return brain, params


def torch_brain(params, hparams=None, opt_class=None):
    model = TSTransducer(TSTransducerConfig(**CONFIG))
    model.load_state_dict(params_from_flax(params))
    return TSASRBrain(modules={"model": model}, opt_class=opt_class,
                      hparams=dict(HPARAMS, **(hparams or {})),
                      run_opts={"device": "cpu"},
                      tokenizer=CharTokenizer(PIECES))


def test_objectives_and_gradients_match_jax(jax_side):
    jbrain, params = jax_side
    batch = make_batch(1)
    arrays = jbrain.batch_to_arrays(batch)

    def loss_fn(p):
        preds = jbrain.compute_forward(p, arrays, JaxStage.TRAIN,
                                       jax.random.PRNGKey(1))
        return jbrain.compute_objectives(preds, arrays, JaxStage.TRAIN)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    brain = torch_brain(params)
    tensors = brain._put_batch(brain.batch_to_arrays(batch))
    names, leaves = zip(*brain.model.named_parameters())
    with onednn_off_on_cpu(brain.device):
        preds = brain.compute_forward(tensors, Stage.TRAIN,
                                      brain.step_generator())
        assert isinstance(preds[0], tuple)          # the fused loss path
        loss = brain.compute_objectives(preds, tensors, Stage.TRAIN)
        grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_trees_close(params_to_flax(dict(zip(names, grads))),
                        want_grads["params"], rel=1e-4)


def test_accumulated_clipped_steps_match_jax(jax_side):
    """4 micro-batches, accumulation 2, max_grad_norm small enough that
    both updates clip; the Noam warmup of 4 makes the two updates share
    lr(1) as optax's count does."""
    jbrain_proto, params = jax_side
    schedule = dict(grad_accumulation_factor=2, max_grad_norm=0.5)
    jbrain = JaxBrain(
        modules={"model": jbrain_proto.model},
        opt_class=jax_make_adamw(**OPT),
        hparams=dict(HPARAMS, noam_scheduler=JaxNoam(OPT["lr"], 4),
                     **schedule), variant="scratch")
    jbrain.params = jax.tree.map(jnp.asarray, params)
    jbrain.init_optimizers()
    step = jbrain._build_train_step()
    brain = torch_brain(params, dict(schedule,
                                     noam_scheduler=NoamScheduler(OPT["lr"],
                                                                  4)),
                        make_adamw(**OPT))
    names = [n for n, _ in brain.model.named_parameters()]
    jparams, jstate = jbrain.params, jbrain.opt_state
    for i in range(4):
        batch = make_batch(10 + i)
        arrays = jbrain._put_batch(jbrain.batch_to_arrays(batch))
        jparams, jstate, jloss, jnorm, finite = step(
            jparams, jstate, arrays, jax.random.PRNGKey(i))
        loss = brain.fit_batch(batch)
        assert bool(finite) and float(jnorm) > 0.5         # clipping is on
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        np.testing.assert_allclose(brain.last_grad_norm, float(jnorm),
                                   rtol=1e-4)
        assert brain.optimizer_step == (i + 1) // 2
        if i % 2 == 1:
            got = params_to_flax(dict(zip(names, (
                p.detach() for p in brain.model.parameters()))))
            want = jax.device_get(jparams)["params"]
            _assert_trees_close(got, want, rel=0.0, absolute=2.5e-4)
            diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
                _flat(got).values(), _flat(want).values())])
            assert np.mean(diffs > 2e-5) < 1e-3
    moved = max(np.abs(a - b).max() for a, b in zip(
        _flat(got).values(), _flat(params["params"]).values()))
    assert moved > 1e-3                       # the updates are not lost


def test_nonfinite_batch_is_skipped(jax_side):
    _, params = jax_side
    brain = torch_brain(params, {"grad_accumulation_factor": 2},
                        make_adamw(**OPT))
    before = [p.detach().clone() for p in brain.model.parameters()]
    bad = make_batch(20)
    bad.mixed_sig.data[0, 100] = np.nan
    brain.fit_batch(bad)
    assert (brain.nonfinite_count, brain.global_micro_step,
            brain.optimizer_step, brain._mini_step) == (1, 0, 0, 0)
    brain.fit_batch(make_batch(21))
    brain.fit_batch(make_batch(22))
    assert (brain.global_micro_step, brain.optimizer_step) == (2, 1)
    assert any(not torch.equal(a, p) for a, p in
               zip(before, brain.model.parameters()))
    brain.nonfinite_patience = 0
    with pytest.raises(ValueError, match="patience"):
        brain.fit_batch(bad)


def test_valid_batch_decodes_and_scores(jax_side):
    _, params = jax_side
    brain = torch_brain(params)
    brain.on_stage_start(Stage.VALID)
    loss = brain.evaluate_batch(make_batch(30), Stage.VALID)
    assert np.isfinite(loss)
    assert len(brain.last_hyps) == 2
    assert brain.valid_wer()["num_scored_sents"] == 2
    # TEST searches with the batched beam of the hparams' beam_size
    from tsasr_torch.decoding import BatchedBeamSearcher
    brain.hparams.beam_size, brain.hparams.expand_beam = 4, 2.3
    brain.on_stage_start(Stage.TEST)
    assert np.isfinite(brain.evaluate_batch(make_batch(30), Stage.TEST))
    assert isinstance(brain._beam, BatchedBeamSearcher)
    assert brain._beam.beam_size == 4 and len(brain.last_hyps) == 2


def test_joint_band_width_raises():
    """``joint_band_width`` raised here before the banded joint and loss
    were ported; it now trains and evaluates on the band, as the JAX
    recipe does: the fused loss is off, a narrow band steps at TRAIN and
    at VALID, and a band that covers the lattice gives the unbanded
    loss."""
    model = TSTransducer(TSTransducerConfig(**CONFIG)).init_weights(seed=0)

    def brain(**extra):
        return TSASRBrain(modules={"model": copy.deepcopy(model)},
                          opt_class=make_adamw(**OPT),
                          hparams=dict(HPARAMS, **extra),
                          run_opts={"device": "cpu"},
                          tokenizer=CharTokenizer(PIECES))

    full = brain().evaluate_batch(make_batch(40), Stage.VALID)
    covering = brain(joint_band_width=64)
    assert not covering._fused_loss_active()
    assert covering.evaluate_batch(make_batch(40), Stage.VALID) \
        == pytest.approx(full, rel=1e-5)
    narrow = brain(joint_band_width=2)
    # a band loses alignments, so its loss is no smaller
    assert narrow.evaluate_batch(make_batch(40), Stage.VALID) \
        >= full * (1 - 1e-6)
    assert np.isfinite(narrow.fit_batch(make_batch(40)))
    assert narrow.global_micro_step == 1


@pytest.mark.parametrize("step", [0, 1, 2, 500, 9999, 10000, 10001, 50000])
def test_noam_schedule_matches_jax(step):
    want = float(jax_noam(1e-3, 10000)(step))
    assert noam_schedule(1e-3, 10000)(step) == pytest.approx(want, rel=1e-6)
    mirror, jax_mirror = NoamScheduler(1e-3, 10000), JaxNoam(1e-3, 10000)
    for _ in range(3):
        assert mirror() == pytest.approx(jax_mirror(), rel=1e-12)


@pytest.mark.parametrize("bits,keep", [(8, 230 / 256), (16, 0.9), (32, 0.9)])
def test_keep_mask_rates(bits, keep):
    """Keep fraction within 4 sigma of the quantized keep probability."""
    gen = torch.Generator().manual_seed(bits)
    n = 200_000
    mask = keep_mask(gen, 0.9, (n,), bits)
    sigma = (keep * (1 - keep) / n) ** 0.5
    assert abs(mask.float().mean().item() - keep) < 4 * sigma
    x = torch.ones(1000)
    drop = Dropout(0.1, bits)
    assert torch.equal(drop(x), x)                          # deterministic
    y = drop(x, deterministic=False, generator=gen)
    assert torch.all((y == 0) | torch.isclose(y, torch.tensor(1 / 0.9)))
    with pytest.raises(ValueError, match="Generator"):
        drop(x, deterministic=False)
