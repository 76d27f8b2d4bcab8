"""The port's sequence and pipeline parallelism
(``tsasr_torch.parallel.{seq_parallel,pp_parallel,hop}``, the rank
layout of ``distributed`` and ``mesh``, the trainer's routing and
gradient rule) against the JAX package's and the one-process run, on
the CPU over gloo, at a tiny size (d_model 32, 4 heads, kernel 5,
``att_context_size`` 4, 2-4 layers, torch on one thread):

- ``required_halo``; the rank layout against ``make_mesh``'s devices
  for (D, P, S, T) in (2, 2, 1, 1), (2, 1, 2, 1), (1, 2, 2, 1),
  (2, 1, 1, 2), (1, 2, 1, 2), (1, 1, 2, 4), (2, 2, 1, 2), (2, 1, 2, 2);
  the
  ``pad_feats_to`` lcm;
- four gloo ranks, one launch, five layouts: S4 and D2 x S2 of a causal
  banded scratch model (``cat`` at 0), P4 with ``prod`` mid-stack and
  D2 x P2 with ``cat`` at -1 (also at ``n_micro`` 4 > P): each rank's
  encoder output against the port's plain ``encode`` (1e-6 of max |y|),
  each layout's first step (``fit_batch``) against the JAX recipe's
  unsharded step with the same weights (loss 1e-5 relative, each
  gradient leaf within 1e-4 of its max |g|) and the same on every rank;
  the JAX encoder's output (1e-5 of max |y|); JAX's ``sp_encoder_apply``
  and ``pp_encoder_apply`` once each on a 2-device mesh; with dropout
  on, the frontend's masks equal on the ranks of a sequence group and
  the encoder block's apart, the outputs finite;
- the raises JAX has: a non-causal or unbanded encoder on the sequence
  axis (the message names ``causal``), a halo past the block, mid-stack
  ``cat`` and layers the pipeline does not divide;
- the scratch entry module at D2 x S2 (four ranks) and the ``none`` one
  at P2 (two ranks) against one process at dropout 0: two epochs of
  fit, VALID greedy, TEST at beam 2; each micro-batch's and each
  epoch's train loss within 1e-5 relative, and a WER file naming every
  TEST utterance once;
- on the card (marker ``cuda``): the hop's host staging between two
  ranks sharing ``cuda:0`` over gloo, and the f32 and bf16 attention
  kernels against their plain versions at the first sequence rank's
  extended block, whose halo rows are fully masked queries.
"""

import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_ddp_helpers import PADDED_KEYS
from tsasr_torch.parallel import distributed
from tsasr_torch.parallel.mesh import axis_ranks, rank_coords

# the module imports no JAX, so its card tests run where JAX is absent
# (``--noconftest``); the JAX side is imported inside the CPU tests
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
YAMLS = REPO / "tsasr_torch/hparams/LibriSpeechMix"
TORCH_YAML = YAMLS / "conformer-t_scratch.yaml"
NONE_YAML = YAMLS / "conformer-t_none.yaml"
B_ENC = 8                   # the encoders' rows: n_micro 4 at D2 x P2
B_STEP = 5                  # the step's rows: odd, padded on most layouts

SP_CONFIG = dict(d_model=32, nhead=4, encoder_num_layers=2, d_ffn=64,
                 kernel_size=5, speaker_encoder_layers=1,
                 decoder_neurons=32, joint_dim=48, frontend_channels=(8, 8),
                 fused_attention=True, dropout=0.0, causal_encoder=True,
                 att_context_size=4, frontend_causal=True)
PP_PROD = dict(SP_CONFIG, encoder_num_layers=4, causal_encoder=False,
               att_context_size=0, frontend_causal=False,
               injection_mode="prod", injection_after=(0, 2))
PP_CAT = dict(PP_PROD, injection_mode="cat", injection_after=(-1,))
HPARAMS = {"sample_rate": 16000, "n_fft": 512, "n_mels": 80,
           "win_length": 32, "augment": False, "blank_index": 0,
           "pad_feats_to": 32, "fused_joint_loss": True,
           "fused_loss_chunk": 3, "valid_search_freq": 1,
           "grad_accumulation_factor": 1000, "seed": 3}
# (name, (D, P, S), config, the step?, n_micro of a second encode)
CASES = (("S4", (1, 1, 4), SP_CONFIG, True, None),
         ("D2S2", (2, 1, 2), SP_CONFIG, True, None),
         ("P4", (1, 4, 1), PP_PROD, True, None),
         ("D2P2", (2, 2, 1), PP_CAT, True, 4),
         ("D2S2_dropout", (2, 1, 2), dict(SP_CONFIG, dropout=0.1), False,
          None))


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_logging_restored():
    """Torch on one thread beside the other test processes; the
    experiments point the root logger at their folder, the tests after
    these get it back."""
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


def worker_env():
    """This process's environment for workers: no rank of its own, one
    torch thread, the repo and the tests importable."""
    env = {k: v for k, v in os.environ.items()
           if k not in distributed.ENV_KEYS}
    env.update(OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(TESTS),
                                           env.get("PYTHONPATH", "")]))
    return env


def launch(log_dir, nproc, *target):
    """``parallel.launch.launch`` of ``target`` from the repo's root;
    returns (its exit code, the workers' logs joined)."""
    from tsasr_torch.parallel.launch import launch as run
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        rc = run(list(map(str, target)), nproc, log_dir=str(log_dir),
                 env=worker_env())
    finally:
        os.chdir(cwd)
    return rc, "".join((log_dir / f"proc{i}.log").read_text()
                       for i in range(nproc))


# ------------------------------------------------------------- layout
@pytest.mark.parametrize("att,kernel", [(4, 5), (64, 31), (1, 1), (16, 3)])
def test_required_halo(att, kernel):
    from tsasr_torch.parallel.seq_parallel import required_halo
    from tsasr_tpu.parallel.seq_parallel import required_halo as jax_halo
    assert required_halo(att, kernel) == jax_halo(att, kernel)
    assert required_halo(64, 31) == 93


@pytest.mark.parametrize("dp,pp,sp,tp", [
    (2, 2, 1, 1), (2, 1, 2, 1), (1, 2, 2, 1), (2, 1, 1, 2), (1, 2, 1, 2),
    (1, 1, 2, 4), (2, 2, 1, 2), (2, 1, 2, 2)])
def test_rank_layout_is_make_mesh(dp, pp, sp, tp):
    """Device r of JAX's mesh sits where the port puts world rank r, and
    each axis's group lists the devices along that mesh axis (the model
    axis innermost)."""
    import jax
    from tsasr_tpu.parallel.mesh import make_mesh
    n = dp * pp * sp * tp
    mesh = make_mesh(dp=dp, tp=tp, sp=sp, pp=pp, devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    names = list(mesh.axis_names)
    np.testing.assert_array_equal(
        ids.reshape(-1), np.arange(n).reshape(
            [mesh.shape[a] for a in names]).reshape(-1))
    for r in range(n):
        where = dict(zip(names, (int(i[0]) for i in np.nonzero(ids == r))))
        coords = rank_coords(r, dp, pp, sp, tp)
        for axis in ("data", "pipe", "seq", "model"):
            assert coords[axis] == where.get(axis, 0), (r, axis)
            if axis in where:
                along = np.moveaxis(ids, names.index(axis), 0)
                index = tuple(where[a] for a in names if a != axis)
                assert axis_ranks(r, axis, dp, pp, sp, tp) == \
                    [int(x) for x in along[(slice(None),) + index]]
    with pytest.raises(ValueError, match="not in a mesh"):
        rank_coords(n, dp, pp, sp, tp)


@pytest.mark.parametrize("pad,strides,sp,want", [
    (32, (2, 2), 2, 32), (32, (2, 2), 16, 64), (None, (2, 2), 4, 16),
    (12, (2, 2), 4, 48), (1, (2, 3), 2, 12)])
def test_seq_parallel_pad_is_the_jax_lcm(pad, strides, sp, want):
    """The JAX recipe's ``math.lcm(pad_feats_to or 1, stride * sp)``."""
    from tsasr_torch.recipes.librispeechmix import seq_parallel_pad
    assert seq_parallel_pad(pad, strides, sp) == want == math.lcm(
        int(pad or 1), int(np.prod(strides)) * sp)


# ------------------------------------------------------------- raises
def encoder(**kwargs):
    from tsasr_torch.models.conformer import TSConformerEncoder
    values = dict(input_size=20, d_model=32, nhead=4, num_layers=2,
                  d_ffn=64, kernel_size=5, injection_mode="cat",
                  injection_after=(0,), causal=True, att_context_size=4)
    values.update(kwargs)
    return TSConformerEncoder(**values)


def axis(name, size):
    return distributed.Axis(name, size, 0, tuple(range(size)))


@pytest.mark.parametrize("causal,context", [(False, 4), (True, 0),
                                            (False, 0)])
def test_seq_parallel_needs_a_causal_banded_encoder(causal, context):
    import jax
    import jax.numpy as jnp
    from tsasr_torch.parallel.seq_parallel import sp_encoder_apply
    from tsasr_tpu.models.conformer import TSConformerEncoder as Jax
    from tsasr_tpu.parallel.mesh import make_mesh
    from tsasr_tpu.parallel.seq_parallel import sp_encoder_apply as jax_sp
    src = torch.zeros(2, 32, 20)
    with pytest.raises(ValueError, match="causal"):
        sp_encoder_apply(encoder(causal=causal, att_context_size=context),
                         src, torch.ones(2), axis("seq", 2))
    enc = Jax(d_model=16, nhead=2, num_layers=1, d_ffn=32, kernel_size=5,
              causal=causal, att_context_size=context, injection_mode=None)
    variables = {"params": {}}
    with pytest.raises(ValueError, match="causal"):
        jax_sp(enc, variables, jnp.zeros((2, 32, 20)), jnp.ones(2),
               make_mesh(dp=1, sp=2, devices=jax.devices()[:2]))


def test_seq_parallel_halo_must_fit_one_block():
    from tsasr_torch.parallel.seq_parallel import sp_encoder_apply
    # 16 frames over 4 ranks: blocks of 4 < the halo of 7
    with pytest.raises(ValueError, match="exceeds the per-rank block"):
        sp_encoder_apply(encoder(), torch.zeros(2, 16, 20), torch.ones(2),
                         axis("seq", 4))
    with pytest.raises(ValueError, match="must divide the seq axis"):
        sp_encoder_apply(encoder(), torch.zeros(2, 30, 20), torch.ones(2),
                         axis("seq", 4))


@pytest.mark.parametrize("layers,mode,after,match", [
    (2, "cat", (0,), "elementwise"), (2, "cross_attention", (1,),
                                     "elementwise"),
    (3, None, (0,), "divisible"), (4, "cat", (-1,), None),
    (4, "prod", (0, 2), None)])
def test_pipeline_raises_as_jax(layers, mode, after, match):
    from types import SimpleNamespace
    from tsasr_torch.parallel.pp_parallel import check_config
    from tsasr_tpu.parallel.pp_parallel import _check_config as jax_check
    enc = encoder(num_layers=layers, injection_mode=mode,
                  injection_after=after)
    jax_enc = SimpleNamespace(num_layers=layers, injection_mode=mode)
    if match is None:
        check_config(enc, 2, after)
        jax_check(jax_enc, 2, after)
        return
    with pytest.raises(ValueError, match=match):
        check_config(enc, 2, after)
    with pytest.raises(ValueError, match=match):
        jax_check(jax_enc, 2, after)


def test_seq_parallel_layers_take_the_fused_kernel(monkeypatch):
    """The port's sequence-parallel layers keep the encoder's
    ``fused_attention`` (one kernel call a layer); JAX's ``_sp_forward``
    builds its layers without it and runs the plain attention
    (``ROADMAP.md`` §3). One rank, whose halo is zeros, in process."""
    from tsasr_torch.models import attention
    from tsasr_torch.parallel.seq_parallel import sp_encoder_apply
    calls = []
    fused = attention.fused_relpos_attention

    def counted(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return fused(*args, **kwargs)

    monkeypatch.setattr(attention, "fused_relpos_attention", counted)
    enc = encoder(fused_attention=True, num_layers=3)
    with torch.no_grad():
        out = sp_encoder_apply(enc, torch.randn(2, 16, 20), torch.ones(2),
                               axis("seq", 1), torch.randn(2, 1, 32))
    assert out.shape == (2, 16, 32) and torch.isfinite(out).all()
    assert calls == [(2, 4, 16 + 7, 8)] * 3


@pytest.mark.parametrize("name", ["seq", "pipe"])
def test_remat_under_an_axis_is_the_step_without(name):
    """Each layer rematerialized (``remat``) on a one-rank axis, dropout
    on: the output and every gradient bit for bit those of the same step
    without remat (the per-block or per-layer-and-micro-batch generators
    replayed in the recompute)."""
    from tsasr_torch.parallel.pp_parallel import pp_encoder_apply
    from tsasr_torch.parallel.seq_parallel import sp_encoder_apply
    g = torch.Generator().manual_seed(3)
    src, spk = torch.randn(4, 16, 20, generator=g), torch.randn(4, 1, 32,
                                                                 generator=g)
    rel = torch.tensor([1.0, 0.75, 1.0, 0.5])
    results = []
    for remat in (False, True):
        torch.manual_seed(0)
        enc = encoder(remat=remat, dropout=0.1,
                      injection_mode="prod" if name == "pipe" else "cat",
                      injection_after=(0, 1) if name == "pipe" else (0,))
        gen = torch.Generator().manual_seed(7)
        if name == "seq":
            out = sp_encoder_apply(enc, src, rel, axis("seq", 1), spk,
                                   deterministic=False, generator=gen)
        else:
            out = pp_encoder_apply(enc, src, rel, axis("pipe", 1), spk,
                                   deterministic=False, generator=gen,
                                   n_micro=2)
        grads = torch.autograd.grad(
            (out * torch.linspace(-1, 1, out.numel()).view_as(out)).sum(),
            list(enc.parameters()), allow_unused=True)
        results.append((out.detach(), grads))
    (out, grads), (out_r, grads_r) = results
    assert torch.equal(out, out_r)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(grads, grads_r))


# ----------------------------------------------- four ranks, five layouts
MP_WORKER = textwrap.dedent("""
    import sys

    import torch

    from torch_ddp_helpers import PADDED_KEYS
    from tsasr_torch.data.batch import PaddedBatch
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    from tsasr_torch.ops import dropout
    from tsasr_torch.parallel import distributed
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    from tsasr_torch.training.brain import onednn_off_on_cpu

    torch.set_num_threads(1)
    assert distributed.maybe_init_distributed("cpu")
    spec = torch.load(sys.argv[1], weights_only=False)
    masks = []
    keep_mask = dropout.keep_mask

    def recorded(*args, **kwargs):
        masks.append(keep_mask(*args, **kwargs))
        return masks[-1]

    out = {}
    for name, counts, config, step, n_micro in spec["cases"]:
        layout = distributed.init_layout(*counts)
        model = TSTransducer(TSTransducerConfig(**config))
        model.load_state_dict(spec["states"][name])
        axis = layout.encoder_axis
        d, D = layout.data.index, layout.data.size
        rows = slice(d * len(spec["feats"]) // D,
                     (d + 1) * len(spec["feats"]) // D)
        feats, rel, enroll, erel = (spec[k][rows] for k in
                                    ("feats", "rel", "enroll", "erel"))
        encode = model.encode_seq_parallel if axis.name == "seq" \\
            else model.encode_pipeline
        res = {"layout": (d, layout.pipe.index, layout.seq.index)}
        train = config["dropout"] > 0
        with torch.set_grad_enabled(train), onednn_off_on_cpu("cpu"):
            spk, srel = model.speaker_condition(enroll, erel)
            gen = torch.Generator().manual_seed(5) if train else None
            masks.clear()
            dropout.keep_mask = recorded
            res["enc"] = encode(feats, rel, axis, spk, srel,
                                deterministic=not train, generator=gen)
            dropout.keep_mask = keep_mask
            res["masks"] = list(masks)
            if n_micro:
                res["enc_micro"] = encode(feats, rel, axis, spk, srel,
                                          n_micro=n_micro)
        res["enc"] = res["enc"].detach()
        if step:
            brain = TSASRBrain(modules={"model": model},
                               hparams=spec["hparams"],
                               run_opts={"device": "cpu"})
            assert brain.layout is layout
            res["loss"] = brain.fit_batch(PaddedBatch(
                spec["batch"], padded_keys=PADDED_KEYS))
            res["grads"] = [a.clone() for a in brain._acc]
            res["rows"] = brain.batch_shard.rows.tolist()
        out[name] = res
    torch.save(out, f"{sys.argv[2]}/rank{distributed.rank()}.pt")
    print(f"MP_OK rank={distributed.rank()}", flush=True)
""")


def make_batch(seed, n=B_STEP):
    """``n`` rows ragged in every length, long enough for blocks of 8
    encoder frames at S4 (the halo is 7)."""
    rng = np.random.default_rng(seed)
    examples = []
    for b in range(n):
        toks = rng.integers(1, 29, size=6 - b % 3)
        examples.append({
            "id": f"utt{seed}-{b}",
            "mixed_sig": (rng.normal(size=20000 - 1500 * b)
                          * 0.1).astype(np.float32),
            "enroll_sig": (rng.normal(size=9000 - 500 * b)
                           * 0.1).astype(np.float32),
            "tokens_bos": np.concatenate([[0], toks]).astype(np.int64),
            "tokens": toks.astype(np.int64), "target_words": ["x"]})
    return examples


def seeded_state(config):
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    return TSTransducer(TSTransducerConfig(**config)).init_weights(
        seed=0).state_dict()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """(the inputs, each rank's results by case)."""
    tmp = tmp_path_factory.mktemp("mp")
    g = torch.Generator().manual_seed(11)
    spec = {"cases": CASES, "hparams": HPARAMS, "batch": make_batch(0),
            "states": {name: seeded_state(cfg)
                       for name, _, cfg, _, _ in CASES},
            "feats": torch.randn(B_ENC, 128, 80, generator=g),
            "rel": torch.tensor([1.0, 0.8, 1.0, 0.6, 0.9, 1.0, 0.5, 0.7]),
            "enroll": torch.randn(B_ENC, 64, 80, generator=g),
            "erel": torch.tensor([1.0, 0.9, 0.7, 1.0, 0.8, 1.0, 0.6, 1.0])}
    torch.save(spec, tmp / "spec.pt")
    (tmp / "worker.py").write_text(MP_WORKER)
    rc, logs = launch(tmp / "logs", 4, tmp / "worker.py", tmp / "spec.pt",
                      tmp)
    assert rc == 0, logs[-4000:]
    return spec, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                  for r in range(4)]


def plain_encode(spec, config, rows=slice(None)):
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    model = TSTransducer(TSTransducerConfig(**config))
    name = next(n for n, _, c, _, _ in CASES if c == config)
    model.load_state_dict(spec["states"][name])
    with torch.no_grad():
        spk, srel = model.speaker_condition(spec["enroll"], spec["erel"])
        return model.encode(spec["feats"], spec["rel"], spk, srel)[rows]


def valid(spec, T):
    """(B, T, 1): the frames within each row's length (the rows past it
    are scratch in both computations, as JAX's tests take them)."""
    n = torch.round(spec["rel"] * T)
    return (torch.arange(T)[None, :] < n[:, None])[..., None]


def shard_rows(res, counts):
    d = res["layout"][0]
    return slice(d * B_ENC // counts[0], (d + 1) * B_ENC // counts[0])


@pytest.mark.parametrize("name", ["S4", "D2S2", "P4", "D2P2"])
def test_encoder_output_as_the_plain_encode(four_ranks, name):
    """Every rank's output, of its data shard's rows, within 1e-6 of max
    |y| of the port's plain ``encode`` on the valid frames; the second
    encode at n_micro 4 (D2 x P2) too."""
    spec, ranks = four_ranks
    _, counts, config, _, n_micro = next(c for c in CASES if c[0] == name)
    want = plain_encode(spec, config)
    mask = valid(spec, want.shape[1])
    scale = float(want.abs().max())
    for res in ranks:
        rows = shard_rows(res[name], counts)
        keys = ["enc"] + (["enc_micro"] if n_micro else [])
        for key in keys:
            got = res[name][key]
            assert got.shape == want[rows].shape
            err = float(((got - want[rows]) * mask[rows]).abs().max())
            assert err <= 1e-6 * scale, (name, key, err / scale)


JAX_STEPS = {}


def jax_brain(config):
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    from tsasr_tpu.recipes.librispeechmix import TSASRBrain as JaxBrain
    return JaxBrain(modules={"model": JaxTransducer(JaxConfig(**config))},
                    hparams=dict(HPARAMS), variant="scratch")


@pytest.mark.parametrize("name", ["S4", "D2S2", "P4", "D2P2"])
def test_first_step_as_the_jax_step(four_ranks, name):
    """The layout's all-reduced first-step gradient, the same on every
    rank, against the JAX recipe's unsharded step on the same five rows
    and weights: the loss within 1e-5 relative, each leaf within 1e-4 of
    its max |g|."""
    import jax
    from tsasr_torch.convert import params_to_flax
    from tsasr_tpu.utils.stage import Stage as JaxStage
    spec, ranks = four_ranks
    _, counts, config, _, _ = next(c for c in CASES if c[0] == name)
    for res in ranks[1:]:
        assert res[name]["loss"] == ranks[0][name]["loss"]
        assert all(torch.equal(a, b) for a, b in
                   zip(res[name]["grads"], ranks[0][name]["grads"]))
    rows = sorted({r for res in ranks for r in res[name]["rows"]})
    assert rows == list(range(B_STEP))
    jbrain = jax_brain(config)
    from tsasr_torch.data.batch import PaddedBatch
    arrays = jbrain._put_batch(jbrain.batch_to_arrays(
        PaddedBatch(spec["batch"], padded_keys=PADDED_KEYS)))
    state = spec["states"][name]
    params = {"params": params_to_flax(state)}

    def loss_fn(p):
        preds = jbrain.compute_forward(p, arrays, JaxStage.TRAIN,
                                       jax.random.PRNGKey(1))
        return jbrain.compute_objectives(preds, arrays, JaxStage.TRAIN)

    key = repr(sorted(config.items()))
    if key not in JAX_STEPS:       # S4 and D2S2 share one model
        JAX_STEPS[key] = jax.jit(jax.value_and_grad(loss_fn))(params)
    want_loss, want_grads = JAX_STEPS[key]
    got = dict(jax.tree_util.tree_flatten_with_path(params_to_flax(
        dict(zip(state, ranks[0][name]["grads"]))))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(
        want_grads["params"])[0])
    assert got.keys() == want.keys()
    np.testing.assert_allclose(ranks[0][name]["loss"], float(want_loss),
                               rtol=1e-5)
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[key]), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(key))


def jax_encode(spec, config, mesh=None):
    """The JAX model's encoder output on the spec's inputs with the
    port's seeded weights: ``encode``, or with a mesh the model's
    ``encode_seq_parallel`` / ``encode_pipeline``, jitted."""
    import jax
    import jax.numpy as jnp
    from tsasr_torch.convert import params_to_flax
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    name = next(n for n, _, c, _, _ in CASES if c == config)
    params = {"params": params_to_flax(spec["states"][name])}

    def run(model, feats, rel, enroll, erel):
        spk = model.extract_speaker(enroll, erel)
        if mesh is None:
            return model.encode(feats, rel, spk, erel)
        if "seq" in mesh.axis_names:
            return model.encode_seq_parallel(feats, rel, mesh, spk, erel)
        return model.encode_pipeline(feats, rel, mesh, spk, erel)

    inputs = [jnp.asarray(spec[k].numpy())
              for k in ("feats", "rel", "enroll", "erel")]
    model = JaxTransducer(JaxConfig(**config))
    out = jax.jit(lambda p, *x: model.apply(p, *x, method=run))(params,
                                                                  *inputs)
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("name", ["D2S2", "D2P2"])
def test_encoder_output_as_jax(four_ranks, name):
    """The ranks' outputs, joined over the data shards, within 1e-5 of
    max |y| of JAX's unsharded ``encode``, and of JAX's own sequence- /
    pipeline-parallel encode on a 2-device mesh (S2 / P2)."""
    import jax
    from tsasr_tpu.parallel.mesh import make_mesh
    spec, ranks = four_ranks
    _, counts, config, _, _ = next(c for c in CASES if c[0] == name)
    got = torch.cat([res[name]["enc"] for res in ranks
                     if res[name]["layout"][1:] == (0, 0)])
    mesh = make_mesh(dp=1, sp=counts[2], pp=counts[1],
                     devices=jax.devices()[:2])
    for want in (jax_encode(spec, config), jax_encode(spec, config, mesh)):
        mask = valid(spec, want.shape[1])
        err = float(((got - want) * mask).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


def test_seq_parallel_dropout_draws_per_block(four_ranks):
    """With dropout on, the ranks of a sequence group draw the frontend's
    masks alike and the encoder block's apart (the first mask over
    (B, T / S, d_model) is input_proj's); the outputs are finite."""
    spec, ranks = four_ranks
    block = 32 // 2
    for a, b in ((0, 1), (2, 3)):
        ma, mb = (ranks[r]["D2S2_dropout"]["masks"] for r in (a, b))
        assert len(ma) == len(mb) > 4
        first = next(i for i, m in enumerate(ma)
                     if tuple(m.shape[1:]) == (block, 32))
        assert first > 0
        assert all(torch.equal(x, y) for x, y in zip(ma[:first],
                                                     mb[:first]))
        assert not torch.equal(ma[first], mb[first])
        for r in (a, b):
            assert torch.isfinite(ranks[r]["D2S2_dropout"]["enc"]).all()


# -------------------------------------------------- through the recipe
EXPERIMENT_ARGS = ["--noprogressbar", "--num_epochs", "2", "--beam_size",
                   "2", "--valid_search_freq", "1", "--d_model", "32",
                   "--nhead", "4", "--d_ffn", "64", "--encoder_num_layers",
                   "2", "--kernel_size", "5", "--decoder_neurons", "24",
                   "--joint_dim", "48", "--dropout", "0.0", "--augment",
                   "False", "--device", "cpu"]
CAUSAL_ARGS = ["--causal_encoder", "True", "--att_context_size", "4",
               "--frontend_padding", "causal"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from torch_port_helpers import CORPUS
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset
    root = tmp_path_factory.mktemp("corpus")
    make_dataset(str(root), **CORPUS)
    return root


def epoch_losses(losses_in_order, log_text):
    """Each epoch's mean of its micro-batch losses (the count restarts
    at 1 each epoch)."""
    steps = [int(x) for x in re.findall(r"TRAIN micro-batch (\d+) loss",
                                        log_text)]
    epochs = []
    for step, loss in zip(steps, losses_in_order):
        if step == 1:
            epochs.append([])
        epochs[-1].append(loss)
    return [float(np.mean(e)) for e in epochs]


def parallel_against_one_process(variant, yaml, corpus, tmp, nproc, flags,
                                 extra=()):
    """The launched run (in the background) and the one-process run of
    the same arguments; returns both output folders."""
    from torch_port_helpers import corpus_vocab
    from tsasr_torch.recipes.librispeechmix import run_experiment
    args = [str(yaml), "--data_folder", str(corpus), "--vocab_size",
            str(corpus_vocab(corpus)), *EXPERIMENT_ARGS, *extra]
    one, many = tmp / "one", tmp / "many"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tsasr_torch.parallel.launch",
         "--nproc_per_node", str(nproc), "--log_dir", str(tmp / "logs"),
         "-m", f"tsasr_torch.train_librispeechmix_{variant}", *args,
         "--output_folder", str(many), *flags],
        cwd=REPO, env=worker_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        run_experiment(variant=variant,
                       argv=args + ["--output_folder", str(one)])
        out, _ = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-4000:]
    return one, many, out


def hold_against_one_process(one, many, logs):
    from test_torch_distributed import micro_batch_losses, wer_entries
    want_log = (one / "log.txt").read_text()
    want = micro_batch_losses(want_log)
    assert len(want) >= 4
    for name in logs:
        log = (many / name).read_text()
        got = micro_batch_losses(log)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(epoch_losses(got, log),
                                   epoch_losses(want, want_log), rtol=1e-5)
        assert "over gloo" in log
    assert len(epoch_losses(want, want_log)) == 2
    wer_one = wer_entries((one / "wer_test-clean-2mix.txt").read_text())
    wer_many = wer_entries((many / "wer_test-clean-2mix.txt").read_text())
    assert sorted(wer_many) == sorted(wer_one)


def test_seq_parallel_experiment_as_one_process(corpus, tmp_path):
    """D2 x S2: the scratch model, causal with a 4-frame context."""
    one, many, out = parallel_against_one_process(
        "scratch", TORCH_YAML, corpus, tmp_path, 4,
        ["--sequence_parallel_count", "2", "--data_parallel_count", "2"],
        CAUSAL_ARGS)
    hold_against_one_process(one, many, ["log.txt", "log_proc1.txt",
                                         "log_proc2.txt", "log_proc3.txt"])
    assert "rank 3 of 4 over gloo, data 1 of 2, pipe 0 of 1, seq 1 of 2" in \
        (many / "log_proc3.txt").read_text()


def test_pipeline_experiment_as_one_process(corpus, tmp_path):
    """P2: the none model, one layer a stage."""
    one, many, out = parallel_against_one_process(
        "none", NONE_YAML, corpus, tmp_path, 2,
        ["--pipeline_parallel_count", "2"])
    hold_against_one_process(one, many, ["log.txt", "log_proc1.txt"])
    assert "pipe 1 of 2" in (many / "log_proc1.txt").read_text()


# ------------------------------------------------------------- the card
HOP_WORKER = textwrap.dedent("""
    import sys

    import torch
    import torch.distributed as dist

    from tsasr_torch.parallel import distributed, hop

    assert distributed.maybe_init_distributed(sys.argv[1])
    n, r = distributed.world_size(), distributed.rank()
    axis = distributed.init_layout(1, 1, n).seq
    x = torch.full((2, 5, 3), float(r + 1), device="cuda:0",
                   requires_grad=True)
    halo = hop.NeighbourHop.apply(x, axis.neighbour(-1), axis.neighbour(1))
    joined = hop.GatherBlocks.apply(x * 2, axis, 1)
    sent = hop.BroadcastFrom.apply(x * 3, axis, n - 1, (2, 5, 3),
                                   torch.float32)
    assert halo.is_cuda and joined.is_cuda and sent.is_cuda
    assert joined.shape == (2, 5 * n, 3)
    assert torch.equal(halo, torch.full_like(x, float(r)))
    assert torch.equal(joined[:, -5:], torch.full_like(x, 2.0 * n))
    assert torch.equal(sent, torch.full_like(x, 3.0 * n))
    (halo.sum() + joined.sum() + sent.sum()).backward()
    # x's halo to the right neighbour: 1 there; the gather's own block:
    # 2; the broadcast's source: 3
    want = 2.0 + (1.0 if r < n - 1 else 0.0) + (3.0 if r == n - 1 else 0.0)
    assert torch.equal(x.grad, torch.full_like(x, want)), x.grad
    assert (hop.stats["bytes"] > 0) == (n > 1)
    print(f"HOP_OK rank={r} of {n} over {dist.get_backend()}", flush=True)
""")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_hop_stages_through_the_host_on_a_shared_card(cuda, tmp_path):
    """Two ranks sharing cuda:0 over gloo: the halo, the gather and the
    broadcast of CUDA tensors, forward and backward, through pinned host
    buffers; one rank over NCCL: the gather and the broadcast on the
    device (several cards over NCCL need a machine that has them)."""
    (tmp_path / "worker.py").write_text(HOP_WORKER)
    rc, logs = launch(tmp_path / "gloo", 2, tmp_path / "worker.py",
                      "cuda:0")
    assert rc == 0 and "HOP_OK rank=1 of 2 over gloo" in logs, logs[-3000:]
    rc, logs = launch(tmp_path / "nccl", 1, tmp_path / "worker.py", "cuda")
    assert rc == 0 and "HOP_OK rank=0 of 1 over nccl" in logs, logs[-3000:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_at_the_first_ranks_halo_matches_plain(cuda, dtype):
    """The first sequence rank's extended block at the card's phase
    (att_context_size 64, kernel 31: halo 93, a block of 104): the halo
    rows see no key. The kernel's output and gradients against the plain
    version's (f32: 1e-4 of max, bf16: 2^-7 / 2^-6), halo rows included."""
    from tsasr_torch.kernels import relpos_attention as ra
    B, H, Dh, halo, block = 2, 4, 64, 93, 104
    T = halo + block
    g = torch.Generator().manual_seed(T)
    qu, qv, k, v = (torch.randn(B, H, T, Dh, generator=g) for _ in range(4))
    p = torch.randn(H, 2 * T - 1, Dh, generator=g)
    pos = torch.arange(T) - halo
    lens = torch.tensor([block, block - 30])
    kp = torch.where((pos[None] < 0) | (pos[None] >= lens[:, None]),
                     -1e9, 0.0)
    hidden = (pos[None, :] > pos[:, None]) | \
        ((pos[:, None] - pos[None, :]) >= 64)
    am = torch.where(hidden, -1e9, 0.0)
    args = [x.to(cuda, dtype) for x in (qu, qv, k, v, p)] + \
        [kp.to(cuda), am.to(cuda)]
    do = torch.randn(B, H, T, Dh, generator=g).to(cuda, dtype)
    seed = torch.tensor([77], device=cuda)
    res = {}
    for name, fn in (("kernel", ra.fused_relpos_attention),
                     ("plain", ra.relpos_attention_reference)):
        leaves = [x.clone().requires_grad_(i < 5)
                  for i, x in enumerate(args)]
        out = fn(*leaves, seed=seed, scale=0.125, rate=0.0)
        res[name] = [out.detach(), *torch.autograd.grad(out, leaves[:5],
                                                        do)]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(zip(res["kernel"], res["plain"])):
        assert torch.isfinite(got).all()
        tol = 1e-4 if dtype == torch.float32 else \
            (2.0 ** -7 if i == 0 else 2.0 ** -6)
        err = ((got.double() - want.double()).abs().max()
               / want.double().abs().max().clamp(min=1.0)).item()
        assert err <= tol, (i, err)
    halo_rows = res["kernel"][0][:, :, :halo]
    assert torch.allclose(halo_rows.double(),
                          res["plain"][0][:, :, :halo].double(),
                          atol=tol, rtol=0)
