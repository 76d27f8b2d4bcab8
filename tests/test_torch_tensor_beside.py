"""Tensor parallelism beside the sequence and pipeline axes: the port's
four-axis mesh (``--tensor_parallel_count`` with
``--sequence_parallel_count`` / ``--pipeline_parallel_count``) against
the JAX package's and against the port's own S2 / P2 runs, on the CPU
over gloo, at the tiny configs of ``tests/test_torch_model_parallel.py``
(d_model 32, 4 heads, kernel 5, 2 + 1 layers causal banded for S, 4 with
``prod`` mid-stack for P; torch on one thread):

- the layout: every axis's groups made on every rank in one order, a
  rank's model group meeting its sequence, pipeline and data groups in
  itself alone, at (D, P, S, T) (1, 1, 2, 2), (1, 2, 1, 2), (2, 1, 2, 2);
- one launch of four ranks, whose first two ranks run S2 and last two
  P2 as two-rank worlds of their own before the four join: at S2·T2 and
  P2·T2 each module's mode (the encoder's layers whole on gathered
  leaves, the speaker encoder's split) and the attention's heads; the
  encoder output against JAX's unsharded ``encode`` and JAX's own
  ``encode_seq_parallel`` / ``encode_pipeline`` on ``make_mesh(dp=1,
  sp=2, tp=2)`` / ``(pp=2, tp=2)`` with ``param_shardings`` (1e-5 of max
  |y|); the first step at dropout 0 against JAX's unsharded step (loss
  1e-5 relative, each leaf 1e-4 of its max |g|); the model ranks' whole
  gradients at the gather equal before slicing; two micro-batches with
  dropout on against the port's S2 / P2 step (losses 1e-5 relative, the
  gathered gradients 2e-3 of each leaf's max, the weights and AdamW
  moments after the update); an S2 checkpoint recovered at S2·T2,
  written back bit for bit, trained on as S2 trains on;
- a finding on the reference: JAX's S2·T2 gradient scales the
  frontend's four conv kernels by T against its S2·T1 gradient, where
  the port's S2·T2 gradient is its S2 gradient (``ROADMAP.md`` §3 item
  23);
- the scratch entry module at S2·T2 through the launcher against one
  process (dropout 0): two epochs, VALID greedy, TEST at beam 2.
"""

import os
import textwrap

import numpy as np
import pytest
import torch

from test_torch_model_parallel import (B_ENC, CAUSAL_ARGS, PP_PROD,
                                       SP_CONFIG, TORCH_YAML,
                                       hold_against_one_process, jax_brain,
                                       launch, make_batch,
                                       parallel_against_one_process,
                                       seeded_state, valid)
from test_torch_model_parallel import HPARAMS as NO_UPDATE
from test_torch_tensor_parallel import (ADAMW, GRAD_REL, assert_grads_close,
                                        assert_updated_alike)
from torch_ddp_helpers import PADDED_KEYS

DROPOUT = 0.1
# (name, (D, P, S, T), config): the four-rank layouts, dropout 0 for the
# parity with JAX, dropout on for the step against the port's S2 / P2
FOUR = (("S2T2", (1, 1, 2, 2), SP_CONFIG),
        ("P2T2", (1, 2, 1, 2), PP_PROD),
        ("S2T2_dropout", (1, 1, 2, 2), dict(SP_CONFIG, dropout=DROPOUT)),
        ("P2T2_dropout", (1, 2, 1, 2), dict(PP_PROD, dropout=DROPOUT)))
# (name, (D, P, S, T), config, the four-rank run it is held against)
TWO = (("S2", (1, 1, 2, 1), dict(SP_CONFIG, dropout=DROPOUT),
        "S2T2_dropout"),
       ("P2", (1, 2, 1, 1), dict(PP_PROD, dropout=DROPOUT),
        "P2T2_dropout"))
UPDATE = dict(NO_UPDATE, grad_accumulation_factor=2)
# JAX's frontend conv kernels its S·T gradient scales by T
FRONTEND_CONVS = tuple(f"frontend/block_{b}/{conv}/kernel" for b in (0, 1)
                       for conv in ("conv_0", "residual_conv"))


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_logging_restored():
    """Torch on one thread beside the other test processes; the
    experiment points the root logger at its folder, the tests after it
    get it back."""
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


# ------------------------------------------------------------- layout
@pytest.mark.parametrize("counts", [(1, 1, 2, 2), (1, 2, 1, 2),
                                    (2, 1, 2, 2)])
def test_model_groups_do_not_collide(monkeypatch, counts):
    """``init_layout`` on each rank of the mesh: every rank creates the
    same groups in the same order; its model group is the model axis's
    ranks of ``make_mesh``'s order, and meets its data, pipeline and
    sequence groups in itself alone."""
    from tsasr_torch.parallel import distributed
    from tsasr_torch.parallel.mesh import axis_ranks
    n = int(np.prod(counts))
    orders = []
    monkeypatch.setattr(distributed, "is_distributed", lambda: True)
    monkeypatch.setattr(distributed, "world_size", lambda: n)
    monkeypatch.setattr(distributed, "_LAYOUT", None)
    for r in range(n):
        made = []
        monkeypatch.setattr(distributed, "rank", lambda: r)
        monkeypatch.setattr(distributed.dist, "new_group",
                            lambda ranks: made.append(tuple(ranks))
                            or tuple(ranks))
        layout = distributed.init_layout(*counts)
        orders.append(made)
        axes = [layout.data, layout.pipe, layout.seq, layout.model]
        for axis in axes:
            assert axis.ranks == tuple(axis_ranks(r, axis.name, *counts))
            assert axis.group == (axis.ranks if axis.size > 1 else None)
        for a in axes:
            for b in axes:
                if a is not b:
                    assert set(a.ranks) & set(b.ranks) == {r}
        assert layout.encoder_axis is (layout.seq if counts[2] > 1
                                       else layout.pipe)
        assert layout.model_ranks * layout.dp == n
    assert all(made == orders[0] for made in orders)
    assert len(set(orders[0])) == len(orders[0])


@pytest.mark.parametrize("remat", [False, True])
def test_stand_in_leaves_are_the_layers_own(remat):
    """``apply_layer`` with ``params`` standing in for the layer's split
    leaves (non-leaf tensors, as ``gather_layers`` gives them), dropout
    on, rematerialized or not: the output and every leaf's gradient bit
    for bit those of the layer on its own leaves without remat (the
    recompute reads the stand-ins, and replays the dropout draws)."""
    from test_torch_model_parallel import encoder
    from tsasr_torch.models.attention import rel_pos_encoding
    from tsasr_torch.ops.masks import lookahead_mask
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 12, 32, generator=g)
    weights = torch.randn(2, 12, 32, generator=g)
    kp = torch.arange(12)[None, :] >= torch.tensor([[12], [9]])
    results = []
    for stand_in in (False, True):
        torch.manual_seed(0)
        enc = encoder(num_layers=1, dropout=0.1, fused_attention=True,
                      remat=remat and stand_in)
        own = dict(enc.layers[0].named_parameters())
        split = {n: p * 1.0 for n, p in own.items()
                 if n.endswith(tuple(f"{m}.{leaf}" for m in (
                     "ffn1", "ffn2", "mha", "conv")
                     for leaf in ("w1.weight", "w2.weight",
                                  "qkv_proj.weight", "out_proj.weight",
                                  "pointwise_in.weight",
                                  "pointwise_out.weight")))}
        assert len(split) == 8
        out = enc.apply_layer(0, x, rel_pos_encoding(12, 32), kp,
                              lookahead_mask(12), False,
                              torch.Generator().manual_seed(7),
                              params=split if stand_in else None)
        grads = torch.autograd.grad((out * weights).sum(),
                                    list(own.values()))
        results.append((out.detach(), grads))
    (out, grads), (out_s, grads_s) = results
    assert torch.equal(out, out_s)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_s))


# ------------------------------------------------ four ranks, one launch
WORKER_HEAD = textwrap.dedent("""
    import os
    import sys

    import torch
    import torch.distributed as dist

    from torch_ddp_helpers import PADDED_KEYS
    from tsasr_torch.data.batch import PaddedBatch
    from tsasr_torch.models import attention
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    from tsasr_torch.parallel import distributed, tensor_parallel
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    from tsasr_torch.training.brain import _BrainState
    from tsasr_torch.training.checkpoints import Checkpointer
    from tsasr_torch.training.optimizers import make_adamw

    torch.set_num_threads(1)
    spec = torch.load(sys.argv[1], weights_only=False)
    here = int(os.environ["RANK"])
    out = {}

    def brain_of(config, state, hparams, checkpointer=None):
        model = TSTransducer(TSTransducerConfig(**config))
        model.load_state_dict(state)
        return TSASRBrain(modules={"model": model},
                          opt_class=make_adamw(**spec["adamw"]),
                          hparams=hparams, run_opts={"device": "cpu"},
                          checkpointer=checkpointer)

    def fit(brain, batch):
        return brain.fit_batch(PaddedBatch(batch, padded_keys=PADDED_KEYS))

    def two_steps(config, state):
        brain = brain_of(config, state, spec["update"])
        res = {"losses": [fit(brain, spec["batches"][0])]}
        res["acc"] = [a.clone() for a in _BrainState(brain)._state()["acc"]]
        res["losses"].append(fit(brain, spec["batches"][1]))
        res["state"] = _BrainState(brain)._state()
        res["numel"] = sum(p.numel() for p in brain._params())
        return res
""")
WORKER = WORKER_HEAD + textwrap.dedent("""
    # the first two ranks run S2, the last two P2, each pair its own world
    name, counts, config, _ = spec["two"][here // 2]
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{spec['ports'][here // 2]}",
        world_size=2, rank=here % 2)
    distributed.init_layout(*counts)
    out[name] = two_steps(config, spec["states"][name])
    if name == "S2":
        # a checkpoint an update and half an accumulation in, then the
        # micro-batch that completes the next update
        brain = brain_of(config, spec["states"][name], spec["update"],
                         Checkpointer(spec["ckpt_dir"]))
        for batch in (spec["batches"][1], spec["batches"][0],
                      spec["batches"][1]):
            fit(brain, batch)
        brain.checkpointer.save_checkpoint(name="CKPT+s2",
                                           end_of_epoch=False)
        out["s2_on"] = {"loss": fit(brain, spec["batches"][2]),
                        "state": _BrainState(brain)._state()}
    dist.destroy_process_group()

    # the four ranks
    assert distributed.maybe_init_distributed("cpu")
    for name, counts, config in spec["four"]:
        layout = distributed.init_layout(*counts)
        state = spec["states"][name]
        if config["dropout"] > 0:
            out[name] = two_steps(config, state)
            continue
        brain = brain_of(config, state, spec["no_update"])
        brain.init_optimizers()
        res = {"place": distributed.describe(),
               "modes": tensor_parallel.module_modes(brain.model),
               "wholes": [], "heads": set()}
        shard, fused = tensor_parallel.shard_tensor, \\
            attention.fused_relpos_attention

        def recorded(leaf, full, dim, index, size):
            res["wholes"].append((leaf, full.detach().clone()))
            return shard(leaf, full, dim, index, size)

        def counted(*args, **kwargs):
            res["heads"].add((args[0].shape[1], kwargs["h0"]))
            return fused(*args, **kwargs)

        tensor_parallel.shard_tensor = recorded
        attention.fused_relpos_attention = counted
        try:
            res["loss"] = fit(brain, spec["batches"][0])
        finally:
            tensor_parallel.shard_tensor = shard
            attention.fused_relpos_attention = fused
        res["grads"] = [a.clone()
                        for a in _BrainState(brain)._state()["acc"]]
        model = brain.model
        encode = model.encode_seq_parallel if layout.sp > 1 \\
            else model.encode_pipeline
        with torch.no_grad():
            spk, srel = model.speaker_condition(spec["enroll"],
                                                spec["erel"])
            res["enc"] = encode(spec["feats"], spec["rel"],
                                layout.encoder_axis, spk, srel,
                                model_axis=layout.model)
        out[name] = res

    # the S2 checkpoint recovered at S2·T2, written back, trained on
    layout = distributed.init_layout(1, 1, 2, 2)
    checkpointer = Checkpointer(spec["ckpt_dir"])
    brain = brain_of(spec["two"][0][2], spec["states"]["S2"],
                     spec["update"], checkpointer)
    brain.init_optimizers()
    assert checkpointer.recover_if_possible() is not None
    opt = brain.optimizer.state_dict()["state"]
    names = brain._param_names()
    res = {"params": {n: p.detach().clone()
                      for n, p in brain.model.named_parameters()},
           "moments": {names[i]: s["exp_avg_sq"].clone()
                       for i, s in opt.items()},
           "acc": [a.clone() for a in brain._acc],
           "mini_step": brain._mini_step}
    checkpointer.checkpoints_dir = spec["back_dir"]
    checkpointer.save_checkpoint(name="CKPT+back", end_of_epoch=False)
    res["loss"] = fit(brain, spec["batches"][2])
    res["state"] = _BrainState(brain)._state()
    out["ckpt"] = res
    out["model"] = layout.model.index
    torch.save(out, f"{sys.argv[2]}/rank{here}.pt")
    print(f"BESIDE_OK rank={here}", flush=True)
""")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """(the inputs, each rank's results by run)."""
    from tsasr_torch.parallel.launch import _free_port
    tmp = tmp_path_factory.mktemp("beside")
    g = torch.Generator().manual_seed(11)
    states = {name: seeded_state(config) for name, _, config in FOUR}
    states.update(S2=states["S2T2"], P2=states["P2T2"])
    ports = [_free_port()]
    while len(ports) < 2:
        ports = list({*ports, _free_port()})
    spec = {"four": FOUR, "two": TWO, "states": states,
            "update": UPDATE, "no_update": NO_UPDATE, "adamw": ADAMW,
            "batches": [make_batch(0), make_batch(1), make_batch(2)],
            "feats": torch.randn(B_ENC, 128, 80, generator=g),
            "rel": torch.tensor([1.0, 0.8, 1.0, 0.6, 0.9, 1.0, 0.5, 0.7]),
            "enroll": torch.randn(B_ENC, 64, 80, generator=g),
            "erel": torch.tensor([1.0, 0.9, 0.7, 1.0, 0.8, 1.0, 0.6, 1.0]),
            "ports": ports,
            "ckpt_dir": str(tmp / "ckpt"), "back_dir": str(tmp / "back")}
    torch.save(spec, tmp / "spec.pt")
    (tmp / "worker.py").write_text(WORKER)
    rc, logs = launch(tmp / "logs", 4, tmp / "worker.py", tmp / "spec.pt",
                      tmp)
    assert rc == 0, logs[-4000:]
    return spec, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                  for r in range(4)]


def config_of(name):
    return next(c for n, _, c in FOUR if n == name)


@pytest.mark.parametrize("name", ["S2T2", "P2T2"])
def test_modules_run_whole_on_gathered_leaves(four_ranks, name):
    """Each module's mode on every rank: the encoder's layers whole on
    leaves gathered over the model axis, the speaker encoder's layers
    split; the attention at H 4 from h0 0 in the encoder and, under the
    sequence axis, at H 2 from h0 2·model in the speaker encoder (whose
    layers the pipeline's batch also runs split)."""
    spec, ranks = four_ranks
    for r, res in enumerate(ranks):
        modes = res[name]["modes"]
        assert modes and all(
            mode == ("gathered" if key.startswith("encoder.layers.")
                     else "split")
            for key, mode in modes.items()), modes
        assert sum(key.startswith("speaker_encoder.layers.")
                   for key in modes) == 4
        assert res[name]["heads"] == {(4, 0), (2, 2 * res["model"])}
        assert f"model {res['model']} of 2" in res[name]["place"]


def jax_model(config):
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    return JaxTransducer(JaxConfig(**config))


def placed(state, mesh):
    """The port's weights as flax params, split by ``param_shardings`` on
    ``mesh`` where it has a model axis."""
    import jax
    from tsasr_torch.convert import params_to_flax
    from tsasr_tpu.parallel.mesh import param_shardings
    params = params_to_flax(state)
    if mesh is not None:
        params = jax.device_put(params, param_shardings(params, mesh))
    return {"params": params}


def mesh_of(counts):
    import jax
    from tsasr_tpu.parallel.mesh import make_mesh
    dp, pp, sp, tp = counts
    return make_mesh(dp=dp, pp=pp, sp=sp, tp=tp,
                     devices=jax.devices()[:dp * pp * sp * tp])


def run_encode(mesh):
    """The flax method: ``encode``, or with a mesh the model's
    ``encode_seq_parallel`` / ``encode_pipeline`` on it."""
    def run(model, feats, rel, enroll, erel):
        spk = model.extract_speaker(enroll, erel)
        if mesh is None:
            return model.encode(feats, rel, spk, erel)
        if "seq" in mesh.axis_names:
            return model.encode_seq_parallel(feats, rel, mesh, spk, erel)
        return model.encode_pipeline(feats, rel, mesh, spk, erel)
    return run


def jax_encode(config, state, inputs, mesh=None):
    import jax
    model = jax_model(config)
    out = jax.jit(lambda p, *x: model.apply(p, *x, method=run_encode(mesh)))(
        placed(state, mesh), *inputs)
    return torch.from_numpy(np.array(out))


def encode_inputs(spec):
    import jax.numpy as jnp
    return [jnp.asarray(spec[k].numpy())
            for k in ("feats", "rel", "enroll", "erel")]


@pytest.mark.parametrize("name", ["S2T2", "P2T2"])
def test_encoder_output_as_jax(four_ranks, name):
    """Every rank's output within 1e-5 of max |y| of JAX's unsharded
    ``encode`` and of JAX's own four-axis-mesh encode (the params split
    by ``param_shardings``, 4 of the 8 host devices), on the valid
    frames."""
    spec, ranks = four_ranks
    counts = next(c for n, c, _ in FOUR if n == name)
    inputs = encode_inputs(spec)
    for mesh in (None, mesh_of(counts)):
        want = jax_encode(config_of(name), spec["states"][name], inputs,
                          mesh)
        mask = valid(spec, want.shape[1])
        for res in ranks:
            got = res[name]["enc"]
            assert got.shape == want.shape
            err = float(((got - want) * mask).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (mesh, err)


JAX_STEPS = {}


@pytest.mark.parametrize("name", ["S2T2", "P2T2"])
def test_first_step_as_the_jax_step(four_ranks, name):
    """The first step's gradient at dropout 0, gathered from the shards,
    the same on every rank, against the JAX recipe's unsharded step on
    the same rows and weights: the loss within 1e-5 relative, each leaf
    within 1e-4 of its max |g|."""
    import jax
    from tsasr_torch.convert import params_to_flax
    from tsasr_torch.data.batch import PaddedBatch
    from tsasr_tpu.utils.stage import Stage as JaxStage
    spec, ranks = four_ranks
    for res in ranks[1:]:
        assert res[name]["loss"] == ranks[0][name]["loss"]
        assert all(torch.equal(a, b) for a, b in
                   zip(res[name]["grads"], ranks[0][name]["grads"]))
    config, state = config_of(name), spec["states"][name]
    jbrain = jax_brain(config)
    arrays = jbrain._put_batch(jbrain.batch_to_arrays(
        PaddedBatch(spec["batches"][0], padded_keys=PADDED_KEYS)))

    def loss_fn(p):
        preds = jbrain.compute_forward(p, arrays, JaxStage.TRAIN,
                                       jax.random.PRNGKey(1))
        return jbrain.compute_objectives(preds, arrays, JaxStage.TRAIN)

    if name not in JAX_STEPS:
        JAX_STEPS[name] = jax.jit(jax.value_and_grad(loss_fn))(
            {"params": params_to_flax(state)})
    want_loss, want_grads = JAX_STEPS[name]
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


@pytest.mark.parametrize("name", ["S2T2", "P2T2"])
def test_model_ranks_compute_equal_whole_gradients(four_ranks, name):
    """At the gather, the two model ranks of each sequence block or
    pipeline stage hold the same whole gradient of every gathered leaf,
    bit for bit, before each takes its slice: the encoder's 8 leaves a
    layer (a stage's own layers only)."""
    spec, ranks = four_ranks
    per_rank = 8 * config_of(name)["encoder_num_layers"] // (
        2 if name.startswith("P") else 1)
    for a, b in ((0, 1), (2, 3)):
        wa, wb = ranks[a][name]["wholes"], ranks[b][name]["wholes"]
        assert len(wa) == len(wb) == per_rank
        for (na, ga), (nb, gb) in zip(wa, wb):
            assert na == nb and torch.equal(ga, gb), na
            assert ga.abs().max() > 0, na


def one_process_names(config):
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    return [n for n, p in TSTransducer(TSTransducerConfig(**config))
            .named_parameters() if p.requires_grad]


@pytest.mark.parametrize("two", [t[0] for t in TWO])
def test_step_as_the_ports_own_axis(four_ranks, two):
    """Two micro-batches with dropout on at S2·T2 (P2·T2) against the
    port's S2 (P2) run: the losses within 1e-5 relative on every rank;
    the first micro-batch's gathered gradients within 2e-3 of each
    leaf's max; after the update the weights (``assert_updated_alike``)
    and AdamW's moments, whole on every rank; a rank holds fewer
    parameters than an S2 / P2 rank."""
    spec, ranks = four_ranks
    _, _, config, name = next(t for t in TWO if t[0] == two)
    want = ranks[0][two] if two == "S2" else ranks[2][two]
    hold_step([res[name] for res in ranks], want, config)
    assert all(res[name]["numel"] < want["numel"] for res in ranks)


def hold_step(runs, want, config):
    """Each rank's two-micro-batch step in ``runs`` against ``want``:
    the losses within 1e-5 relative, the first micro-batch's gathered
    gradients within 2e-3 of each leaf's max, after the update the
    weights and AdamW's moments."""
    names = one_process_names(config)
    state = want["state"]
    grads = [s["exp_avg"] for s in state["optimizer"]["state"].values()]
    for got in runs:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert_grads_close(got["acc"], want["acc"], names)
        assert got["state"]["model"].keys() == state["model"].keys()
        assert_updated_alike(got["state"]["model"], state["model"], grads,
                             names, ADAMW["lr"])
        for key in ("exp_avg", "exp_avg_sq"):
            assert_grads_close(
                [s[key] for s in got["state"]["optimizer"]["state"]
                 .values()],
                [s[key] for s in state["optimizer"]["state"].values()],
                names, 2 * GRAD_REL)


# ------------------------------------ the sequence and pipeline axes both
# (name, (D, P, S, T)): the sequence axis takes the encoder, as JAX routes
# it, and the pipeline axis's ranks compute copies
BOTH = (("P2S2", (1, 2, 2, 1)), ("P2S2T2", (1, 2, 2, 2)))
EIGHT_WORKER = WORKER_HEAD + textwrap.dedent("""
    config, state = spec["config"], spec["state"]
    name, counts = spec["both"][0]
    if here < 4:    # the first four ranks a world of their own
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{spec['port']}",
            world_size=4, rank=here)
        distributed.init_layout(*counts)
        out[name] = two_steps(config, state)
        dist.destroy_process_group()
    assert distributed.maybe_init_distributed("cpu")
    name, counts = spec["both"][1]
    distributed.init_layout(*counts)
    out[name] = two_steps(config, state)
    torch.save(out, f"{sys.argv[2]}/rank{here}.pt")
    print(f"BOTH_OK rank={here}", flush=True)
""")


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory, four_ranks):
    """Each rank's two micro-batches of the S2 model at dropout 0 (the
    rows padded for the pipeline axis draw other dropout masks) at P2·S2
    (the first four ranks) and P2·S2·T2 (all eight)."""
    from tsasr_torch.parallel.launch import _free_port
    tmp = tmp_path_factory.mktemp("both")
    spec, _ = four_ranks
    torch.save({"both": BOTH, "config": SP_CONFIG,
                "state": spec["states"]["S2"], "update": UPDATE,
                "adamw": ADAMW, "batches": spec["batches"],
                "port": _free_port()}, tmp / "spec.pt")
    (tmp / "worker.py").write_text(EIGHT_WORKER)
    rc, logs = launch(tmp / "logs", 8, tmp / "worker.py", tmp / "spec.pt",
                      tmp)
    assert rc == 0, logs[-4000:]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(8)]


@pytest.mark.parametrize("name", [b[0] for b in BOTH])
def test_sequence_beside_pipeline_steps_as_s2(four_ranks, eight_ranks,
                                              name):
    """S and P both above 1, with and without T: the encoder runs on the
    sequence axis and the pipeline axis's ranks compute copies of every
    gradient, which count once. Two micro-batches at dropout 0 equal one
    process's on every rank (``hold_step``)."""
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    from tsasr_torch.training.brain import _BrainState
    from tsasr_torch.training.optimizers import make_adamw
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    from tsasr_torch.data.batch import PaddedBatch
    spec, _ = four_ranks
    model = TSTransducer(TSTransducerConfig(**SP_CONFIG))
    model.load_state_dict(spec["states"]["S2"])
    brain = TSASRBrain(modules={"model": model},
                       opt_class=make_adamw(**ADAMW), hparams=dict(UPDATE),
                       run_opts={"device": "cpu"})
    want = {"losses": []}
    for i in range(2):
        want["losses"].append(brain.fit_batch(
            PaddedBatch(spec["batches"][i], padded_keys=PADDED_KEYS)))
        if i == 0:
            want["acc"] = [a.clone() for a in brain._acc]
    want["state"] = _BrainState(brain)._state()
    runs = [res[name] for res in eight_ranks if name in res]
    assert len(runs) == (4 if name == "P2S2" else 8)
    hold_step(runs, want, SP_CONFIG)


def test_s2_checkpoint_moves_to_s2_t2(four_ranks):
    """An S2 checkpoint (an update and half an accumulation in,
    intra-epoch) recovered at S2·T2: each rank holds its slices of the
    weights, of the AdamW moments and of the running mean; written back
    by the four ranks it is the S2 file, tensor for tensor; the next
    micro-batch on the recovered ranks is S2's."""
    from tsasr_torch.convert import shard_state_dict
    from tsasr_torch.parallel.mesh import param_split_dims
    from tsasr_torch.training.checkpoints import load_state
    spec, ranks = four_ranks
    one = load_state(os.path.join(spec["ckpt_dir"], "CKPT+s2",
                                  "brain.ckpt"))
    back = load_state(os.path.join(spec["back_dir"], "CKPT+back",
                                   "brain.ckpt"))

    def same(a, b):
        if torch.is_tensor(a):
            return torch.equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return a == b

    assert same(back, one)
    config = TWO[0][2]
    names = one_process_names(config)
    splits = param_split_dims(one["model"], 2)
    moments = {names[i]: s["exp_avg_sq"]
               for i, s in one["optimizer"]["state"].items()}
    want_on = ranks[0]["s2_on"]
    grads = [s["exp_avg"]
             for s in want_on["state"]["optimizer"]["state"].values()]
    for res in ranks:
        got, m = res["ckpt"], res["model"]
        want = shard_state_dict(one["model"], m, 2)
        assert all(torch.equal(p, want[n]) for n, p in got["params"].items())
        want = shard_state_dict(moments, m, 2, splits)
        assert all(torch.equal(v, want[n])
                   for n, v in got["moments"].items())
        want = shard_state_dict(dict(zip(names, one["acc"])), m, 2, splits)
        assert all(torch.equal(a, want[n])
                   for n, a in zip(names, got["acc"]))
        assert got["mini_step"] == 1
        np.testing.assert_allclose(got["loss"], want_on["loss"], rtol=1e-5)
        assert_updated_alike(got["state"]["model"],
                             want_on["state"]["model"], grads, names,
                             ADAMW["lr"])


# ------------------------------------------- the finding on the reference
def jax_square_grads(config, state, inputs, counts):
    """JAX's gradient of sum(enc^2) through ``encode_seq_parallel`` on
    the mesh of ``counts``, the params split by ``param_shardings``."""
    import jax
    import jax.numpy as jnp
    mesh = mesh_of(counts)
    model = jax_model(config)

    def loss(p):
        return jnp.sum(model.apply(p, *inputs,
                                   method=run_encode(mesh)) ** 2)
    grads = jax.jit(jax.grad(loss))(placed(state, mesh))["params"]
    return {jax.tree_util.keystr(k, simple=True, separator="/"):
            np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]}


def test_jax_four_axis_mesh_scales_the_frontend_convs_by_t(four_ranks):
    """JAX's S2·T2 gradient of sum(enc^2) (full-length rows, dropout 0)
    against its S2·T1 gradient: the frontend's four conv kernels come
    out T = 2 times (within 1e-4 of the doubled leaf's max), every other
    leaf within 1e-4 of its max; the port's S2·T2 gradient is its S2
    gradient on every leaf, those four included (``ROADMAP.md`` §3 item
    23: the port follows the unsharded gradient)."""
    import jax.numpy as jnp
    spec, ranks = four_ranks
    inputs = [jnp.asarray(spec["feats"].numpy()), jnp.ones(B_ENC),
              jnp.asarray(spec["enroll"].numpy()), jnp.ones(B_ENC)]
    state = spec["states"]["S2T2"]
    t2 = jax_square_grads(SP_CONFIG, state, inputs, (1, 1, 2, 2))
    t1 = jax_square_grads(SP_CONFIG, state, inputs, (1, 1, 2, 1))
    assert t2.keys() == t1.keys() and set(FRONTEND_CONVS) <= set(t2)
    for key, g1 in t1.items():
        factor = 2.0 if key in FRONTEND_CONVS else 1.0
        want = factor * g1
        err = np.abs(t2[key] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (key, err)
        if factor > 1:
            ratio = np.linalg.norm(t2[key]) / np.linalg.norm(g1)
            assert abs(ratio - 2.0) <= 1e-4, (key, ratio)
    names = one_process_names(SP_CONFIG)
    convs = [n for n in names if n.startswith("frontend.blocks.")
             and n.endswith(("conv.weight", "residual_conv.weight"))]
    assert len(convs) == 4
    got, want = ranks[0]["S2T2_dropout"]["acc"], ranks[0]["S2"]["acc"]
    assert_grads_close(got, want, names)
    for n in convs:
        i = names.index(n)
        ratio = float(got[i].norm() / want[i].norm())
        assert abs(ratio - 1.0) <= GRAD_REL, (n, ratio)


# -------------------------------------------------- through the recipe
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from torch_port_helpers import CORPUS
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset
    root = tmp_path_factory.mktemp("corpus")
    make_dataset(str(root), **CORPUS)
    return root


def test_s2_t2_experiment_as_one_process(corpus, tmp_path):
    """The scratch entry module at S2·T2 (causal, a 4-frame context,
    dropout 0) through ``python -m tsasr_torch.parallel.launch
    --nproc_per_node 4`` against one process: each micro-batch's and each
    epoch's loss within 1e-5 relative, the WER file naming every TEST
    utterance once, the ranks in the mesh's order, the encoder's layers
    gathered and the speaker encoder's split."""
    one, many, out = parallel_against_one_process(
        "scratch", TORCH_YAML, corpus, tmp_path, 4,
        ["--sequence_parallel_count", "2", "--tensor_parallel_count", "2"],
        CAUSAL_ARGS)
    logs = ["log.txt"] + [f"log_proc{r}.txt" for r in range(1, 4)]
    hold_against_one_process(one, many, logs)
    for r, (s, m) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        if r:
            assert (f"rank {r} of 4 over gloo, data 0 of 1, pipe 0 of 1, "
                    f"seq {s} of 2, model {m} of 2") in \
                (many / logs[r]).read_text()
    log = (many / "log.txt").read_text()
    # 2 mixture and 6 speaker encoder layers (the yaml's), 8 each; 4
    # modules a layer
    assert "tensor parallelism: 64 leaves split over the model axis of 2" \
        in log
    assert "beside the seq axis: 8 modules run whole on leaves gathered " \
        "over the model axis (encoder.layers), 24 split" in log
