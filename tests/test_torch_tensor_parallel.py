"""The port's tensor parallelism (``tsasr_torch.parallel.tensor_parallel``,
the split rule of ``parallel.mesh``, the shards of ``convert``, the
trainer's gradient rule, evaluation copy and checkpoints) against the
JAX package's ``parallel/mesh.py`` and the one-process run, on the CPU
over gloo, at a tiny size (d_model 32, 4 heads, d_ffn 64, 2 + 1 layers,
torch on one thread):

- the split rule names the leaves JAX's ``param_shardings`` splits, on
  the same seeded configs at T 2, 3 and 4 (the names carried across by
  ``convert``), 8 a layer scope; a renamed submodule raises;
- ``philox_keep_mask`` and the plain f32 / bf16 attention, forward and
  backward, at heads [h0, h0 + H/T) equal the whole launch's slice;
- four gloo ranks, one launch: D2 x T2 logits of the tiny model of the
  JAX package's ``tests/test_parallel.py`` on weights carried from JAX
  (1e-5 of its one-device value); a T4 step with dropout on (the fused
  attention's plain path counted from h0, ``cross_attention``, remat:
  the collectives recomputed, the masks replayed) and a
  D2 x T2 step, two micro-batches each, against the one-process step:
  the losses within 1e-5 relative, the first micro-batch's gathered
  gradients within 2e-3 of each leaf's max, the weights and moments
  after the AdamW update; a one-process checkpoint recovered at
  D2 x T2 (each rank's shards, moments and running mean its slices),
  written back bit for bit, and trained on as one process does;
- the scratch entry module through the launcher at D2 x T2 (dropout 0)
  and at T2 (dropout on) against one process: two epochs, VALID
  greedy, TEST at beam 2;
- T with S or P above 1 is accepted (``tests/test_torch_tensor_beside.py``
  runs it).
"""

import os
import textwrap

import numpy as np
import pytest
import torch

from torch_ddp_helpers import PADDED_KEYS
from test_torch_model_parallel import (TORCH_YAML, hold_against_one_process,
                                       launch, make_batch,
                                       parallel_against_one_process)

# the JAX package's tests/test_parallel.py::tiny_model
JAX_TINY = dict(vocab_size=8, encoder_num_layers=2, d_model=32, nhead=4,
                d_ffn=64, joint_dim=48, decoder_neurons=24, dropout=0.0,
                injection_mode=None, use_speaker_encoder=False)
SCRATCH = dict(d_model=32, nhead=4, encoder_num_layers=2, d_ffn=64,
               kernel_size=5, speaker_encoder_layers=1, decoder_neurons=32,
               joint_dim=48, frontend_channels=(8, 8), fused_attention=True,
               dropout=0.0, dropout_bits=8)
XATTN = dict(SCRATCH, injection_mode="cross_attention", dropout=0.1,
             remat=True)
HPARAMS = {"sample_rate": 16000, "n_fft": 512, "n_mels": 80,
           "win_length": 32, "augment": False, "blank_index": 0,
           "pad_feats_to": 32, "fused_joint_loss": True,
           "fused_loss_chunk": 3, "valid_search_freq": 1,
           "grad_accumulation_factor": 2, "seed": 3}
ADAMW = dict(lr=1e-3)
# (name, (D, P, S, T), config): two micro-batches from the seeded state
STEPS = (("T4", (1, 1, 1, 4), XATTN), ("D2T2", (2, 1, 1, 2), SCRATCH))
GRAD_REL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_model(config, state=None):
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    model = TSTransducer(TSTransducerConfig(**config))
    if state is None:
        return model.init_weights(seed=0)
    model.load_state_dict(state)
    return model


JAX_INITS = {}


def jax_params(config):
    """The JAX model and its seeded params (numpy), as
    ``tests/test_parallel.py`` makes them; the inputs too. Made once a
    config."""
    key = repr(sorted(config.items()))
    if key not in JAX_INITS:
        JAX_INITS[key] = _jax_params(config)
    return JAX_INITS[key]


def _jax_params(config):
    import jax
    import jax.numpy as jnp
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(4, 16, 80)).astype(np.float32)
    tokens_bos = rng.integers(0, 8, size=(4, 5)).astype(np.int32)
    model = JaxTransducer(JaxConfig(**config))
    args = [jnp.asarray(feats), jnp.ones(4), jnp.asarray(tokens_bos)]
    if config.get("injection_mode", "cat") is not None:
        args += [jnp.asarray(feats), jnp.ones(4)]
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *args)
    params = jax.tree.map(lambda x: np.array(x, np.float32), params)
    return model, params, feats, tokens_bos


# ------------------------------------------------------- the split rule
def jax_split_paths(params, tp):
    import jax
    from tsasr_tpu.parallel.mesh import (make_mesh, param_shardings,
                                         tp_sharding_report)
    mesh = make_mesh(dp=1, tp=tp, devices=jax.devices()[:tp])
    sharded, _ = tp_sharding_report(param_shardings(params["params"], mesh))
    return sorted(sharded)


def port_split_paths(state, tp):
    from tsasr_torch.convert import _flax_path
    from tsasr_torch.parallel.mesh import param_split_dims
    splits = param_split_dims(state, tp)
    return sorted("/".join(_flax_path(n)[0]) for n, d in splits.items()
                  if d is not None)


@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("name,config", [
    ("jax_tiny", JAX_TINY), ("scratch", SCRATCH), ("cross", XATTN)])
def test_split_leaves_are_jax_leaves(name, config, tp):
    """The port's split leaves on weights carried from JAX are the ones
    JAX's ``param_shardings`` splits; at T 2 and 4 every layer scope
    (the speaker encoder's too) holds 8, and ``cross_attention``'s
    ``out_proj`` is split outside them; at T 3 only the 96 ``qkv_proj``
    columns divide, and both validators raise."""
    import jax
    from tsasr_torch.convert import params_from_flax
    from tsasr_torch.parallel.mesh import (TP_KERNELS_PER_CONFORMER_LAYER,
                                           param_split_dims,
                                           validate_tp_shardings)
    from tsasr_tpu.parallel.mesh import make_mesh, param_shardings
    from tsasr_tpu.parallel.mesh import \
        validate_tp_shardings as jax_validate
    _, params, _, _ = jax_params(config)
    state = params_from_flax(params)
    got, want = port_split_paths(state, tp), jax_split_paths(params, tp)
    assert got == want and want
    splits = param_split_dims(state, tp)
    jax_shardings = param_shardings(
        params["params"], make_mesh(dp=1, tp=tp, devices=jax.devices()[:tp]))
    layers = config["encoder_num_layers"] + (
        config.get("speaker_encoder_layers", 6)
        if config.get("injection_mode", "cat") and
        config.get("use_speaker_encoder", True) else 0)
    if tp == 3:
        assert all(p.endswith("qkv_proj/kernel") for p in got)
        with pytest.raises(ValueError, match="drift"):
            validate_tp_shardings(splits)
        with pytest.raises(ValueError, match="drift"):
            jax_validate(jax_shardings)
        return
    sharded, _ = validate_tp_shardings(splits, expected_layers=layers)
    jax_validate(jax_shardings, expected_layers=layers)
    extra = 1 if config.get("injection_mode") == "cross_attention" else 0
    assert len(sharded) == layers * TP_KERNELS_PER_CONFORMER_LAYER + extra
    if extra:
        assert splits["encoder.speaker_attn.out_proj.weight"] == 1


def test_renamed_submodule_raises():
    """A Conformer layer whose ``ffn1.w1`` is renamed loses a split leaf:
    the validator and ``shard_model`` raise instead of replicating it."""
    from tsasr_torch.parallel import distributed
    from tsasr_torch.parallel.mesh import (param_split_dims,
                                           validate_tp_shardings)
    from tsasr_torch.parallel.tensor_parallel import shard_model
    model = port_model(SCRATCH)
    validate_tp_shardings(param_split_dims(model.state_dict(), 2))
    ffn = model.encoder.layers[1].ffn1
    ffn.fc_in = ffn.w1
    del ffn.w1
    with pytest.raises(ValueError, match="drift"):
        validate_tp_shardings(param_split_dims(model.state_dict(), 2))
    with pytest.raises(ValueError, match="drift"):
        shard_model(model, distributed.Axis("model", 2, 0, (0, 1)))


def test_shards_gather_back():
    """``shard_state_dict`` and ``gather_state_dicts`` are inverses at T
    2 and 4; ``pointwise_in``'s rank block holds its channels of each
    GLU half."""
    from tsasr_torch.convert import gather_state_dicts, shard_state_dict
    from tsasr_torch.parallel.mesh import param_split_dims
    state = port_model(SCRATCH).state_dict()
    for tp in (2, 4):
        splits = param_split_dims(state, tp)
        shards = [shard_state_dict(state, r, tp) for r in range(tp)]
        back = gather_state_dicts(shards, splits)
        assert back.keys() == state.keys()
        assert all(torch.equal(back[k], state[k]) for k in state)
        w = state["encoder.layers.0.conv.pointwise_in.weight"]
        block = shards[1]["encoder.layers.0.conv.pointwise_in.weight"]
        n = 32 // tp
        assert torch.equal(block, torch.cat([w[n:2 * n], w[32 + n:32 + 2 * n]]))


# ------------------------------------------- the kernels' heads from h0
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0,heads", [(0, 2), (2, 2), (1, 1), (3, 1)])
def test_plain_attention_from_h0_is_the_slice(dtype, h0, heads):
    """Heads [h0, h0 + n) of the plain attention with dropout, ``h0``
    given, equal those heads of the 4-head call: the keep mask, the
    output and the five gradients (p's summed over the batch per head)."""
    from tsasr_torch.kernels import relpos_attention as ra
    B, H, T, Dh, rate, seed = 2, 4, 13, 8, 0.2, 1234
    mask = ra.philox_keep_mask(seed, B, H, T, rate)
    part = ra.philox_keep_mask(seed, B, heads, T, rate, h0=h0)
    assert torch.equal(part, mask[:, h0:h0 + heads])
    g = torch.Generator().manual_seed(h0 * 10 + heads)
    qu, qv, k, v = (torch.randn(B, H, T, Dh, generator=g).to(dtype)
                    for _ in range(4))
    p = torch.randn(H, 2 * T - 1, Dh, generator=g).to(dtype)
    kp = torch.where(torch.arange(T)[None] >= torch.tensor([[T], [T - 4]]),
                     -1e9, 0.0)
    am = torch.zeros(T, T)
    do = torch.randn(B, H, T, Dh, generator=g).to(dtype)
    sl = slice(h0, h0 + heads)

    def run(tensors, grad_out, first):
        leaves = [t.clone().requires_grad_() for t in tensors]
        out = ra.relpos_attention_reference(*leaves, kp, am, 0.125, seed,
                                            rate, h0=first)
        return [out.detach(), *torch.autograd.grad(out, leaves, grad_out)]

    whole = run([qu, qv, k, v, p], do, 0)
    got = run([x[:, sl] for x in (qu, qv, k, v)] + [p[sl]], do[:, sl], h0)
    for i, (a, b) in enumerate(zip(got, whole)):
        want = b[sl] if i == 5 else b[:, sl]
        scale = want.double().abs().max().item()
        err = (a.double() - want.double()).abs().max().item()
        assert err <= 1e-6 * scale, (i, err / scale)


# ------------------------------------------------ four ranks, one launch
TP_WORKER = textwrap.dedent("""
    import sys

    import torch

    from torch_ddp_helpers import PADDED_KEYS
    from tsasr_torch.data.batch import PaddedBatch
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    from tsasr_torch.parallel import distributed, tensor_parallel
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    from tsasr_torch.training.brain import _BrainState
    from tsasr_torch.training.checkpoints import Checkpointer
    from tsasr_torch.training.optimizers import make_adamw

    torch.set_num_threads(1)
    assert distributed.maybe_init_distributed("cpu")
    spec = torch.load(sys.argv[1], weights_only=False)
    out = {}

    def model_of(config, state):
        model = TSTransducer(TSTransducerConfig(**config))
        model.load_state_dict(state)
        return model

    def brain_of(config, state, checkpointer=None):
        return TSASRBrain(modules={"model": model_of(config, state)},
                          opt_class=make_adamw(**spec["adamw"]),
                          hparams=spec["hparams"],
                          run_opts={"device": "cpu"},
                          checkpointer=checkpointer)

    def fit(brain, batch):
        return brain.fit_batch(PaddedBatch(batch, padded_keys=PADDED_KEYS))

    # D2 x T2: the JAX tiny model's logits on the rank's data rows
    layout = distributed.init_layout(2, 1, 1, 2)
    model = model_of(spec["jax_config"], spec["jax_state"])
    kinds = tensor_parallel.shard_model(model, layout.model)
    rows = slice(2 * layout.data.index, 2 * layout.data.index + 2)
    with torch.no_grad():
        logits, _ = model(spec["feats"][rows], torch.ones(2),
                          spec["tokens_bos"][rows])
    out["jax"] = {"logits": logits, "model": layout.model.index,
                  "data": layout.data.index}

    # two micro-batches (an update after the second) of each layout
    for name, counts, config in spec["steps"]:
        layout = distributed.init_layout(*counts)
        brain = brain_of(config, spec["states"][name])
        res = {"losses": [fit(brain, spec["batches"][0])]}
        res["acc"] = [a.clone() for a in _BrainState(brain)._state()["acc"]]
        res["losses"].append(fit(brain, spec["batches"][1]))
        res["norm"] = brain.last_grad_norm
        res["state"] = _BrainState(brain)._state()
        res["bytes"] = sum(p.numel() for p in brain._params())
        out[name] = res

    # a one-process checkpoint recovered at D2 x T2, written back, then
    # trained on
    layout = distributed.init_layout(2, 1, 1, 2)
    checkpointer = Checkpointer(spec["ckpt_dir"])
    brain = brain_of(spec["ckpt_config"], spec["state"], checkpointer)
    brain.init_optimizers()
    assert checkpointer.recover_if_possible() is not None
    opt = brain.optimizer.state_dict()["state"]
    names = brain._param_names()
    res = {"model": layout.model.index,
           "params": {n: p.detach().clone()
                      for n, p in brain.model.named_parameters()},
           "moments": {names[i]: s["exp_avg_sq"].clone()
                       for i, s in opt.items()},
           "acc": [a.clone() for a in brain._acc],
           "mini_step": brain._mini_step}
    checkpointer.checkpoints_dir = spec["back_dir"]
    checkpointer.save_checkpoint(name="CKPT+back", end_of_epoch=False)
    res["loss"] = fit(brain, spec["batches"][0])
    res["state"] = _BrainState(brain)._state()
    out["ckpt"] = res
    torch.save(out, f"{sys.argv[2]}/rank{distributed.rank()}.pt")
    print(f"TP_OK rank={distributed.rank()}", flush=True)
""")


def one_process_brain(config, state=None, checkpointer=None):
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    from tsasr_torch.training.optimizers import make_adamw
    return TSASRBrain(modules={"model": port_model(config, state)},
                      opt_class=make_adamw(**ADAMW), hparams=dict(HPARAMS),
                      run_opts={"device": "cpu"}, checkpointer=checkpointer)


def fit(brain, batch):
    from tsasr_torch.data.batch import PaddedBatch
    return brain.fit_batch(PaddedBatch(batch, padded_keys=PADDED_KEYS))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """(the inputs, the one-process checkpoint's brain state, each rank's
    results)."""
    from tsasr_torch.convert import params_from_flax
    from tsasr_torch.training.checkpoints import Checkpointer
    tmp = tmp_path_factory.mktemp("tp")
    jax_model, params, feats, tokens_bos = jax_params(JAX_TINY)
    state = port_model(SCRATCH).state_dict()
    batches = [make_batch(0, 3), make_batch(1, 3)]
    # the one-process checkpoint: an update, then half an accumulation
    ckpt_dir, back_dir = tmp / "ckpt", tmp / "back"
    brain = one_process_brain(SCRATCH, state, Checkpointer(ckpt_dir))
    for batch in (batches[1], batches[0], batches[1]):
        fit(brain, batch)
    brain.checkpointer.save_checkpoint(name="CKPT+one", end_of_epoch=False)
    spec = {"jax_config": JAX_TINY, "jax_state": params_from_flax(params),
            "feats": torch.from_numpy(feats),
            "tokens_bos": torch.from_numpy(tokens_bos).long(),
            "steps": STEPS, "state": state, "batches": batches,
            "states": {name: port_model(config).state_dict()
                       for name, _, config in STEPS},
            "hparams": HPARAMS, "adamw": ADAMW, "ckpt_config": SCRATCH,
            "ckpt_dir": str(ckpt_dir), "back_dir": str(back_dir)}
    torch.save(spec, tmp / "spec.pt")
    (tmp / "worker.py").write_text(TP_WORKER)
    rc, logs = launch(tmp / "logs", 4, tmp / "worker.py", tmp / "spec.pt",
                      tmp)
    assert rc == 0, logs[-4000:]
    spec.update(jax=(jax_model, params))
    return spec, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                  for r in range(4)]


def test_logits_as_jax_at_d2_t2(four_ranks):
    """The D2 x T2 logits of ``tests/test_parallel.py``'s tiny model, on
    weights carried from JAX, within 1e-5 of JAX's one device (of its max
    |logit|), the two model ranks of a data shard alike, and the loss
    sum(logits^2) within 1e-5 relative."""
    import jax.numpy as jnp
    spec, ranks = four_ranks
    jax_model, params = spec["jax"]
    want, _ = jax_model.apply(params, jnp.asarray(spec["feats"].numpy()),
                              jnp.ones(4),
                              jnp.asarray(spec["tokens_bos"].numpy()))
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    loss = 0.0
    for res in ranks:
        got = res["jax"]["logits"].double().numpy()
        d = res["jax"]["data"]
        np.testing.assert_allclose(got, want[2 * d:2 * d + 2], rtol=0,
                                   atol=1e-5 * scale)
        if res["jax"]["model"] == 0:
            loss += float((got ** 2).sum())
        else:
            mate = next(r for r in ranks if r["jax"]["data"] == d
                        and r["jax"]["model"] == 0)
            assert torch.equal(res["jax"]["logits"], mate["jax"]["logits"])
    np.testing.assert_allclose(loss, float((want ** 2).sum()), rtol=1e-5)


ONE_STEPS = {}


def one_process_step(name, config, spec):
    """(losses, first micro-batch's gradients, the state after the
    update) of the one-process brain on the spec's two micro-batches."""
    if name not in ONE_STEPS:
        from tsasr_torch.training.brain import _BrainState
        brain = one_process_brain(config, spec["states"][name])
        losses = [fit(brain, spec["batches"][0])]
        acc = [a.clone() for a in brain._acc]
        losses.append(fit(brain, spec["batches"][1]))
        ONE_STEPS[name] = (losses, acc, _BrainState(brain)._state(),
                           brain._param_names())
    return ONE_STEPS[name]


def assert_grads_close(got, want, names, rel=GRAD_REL):
    """Each leaf within ``rel`` of its max |g|; a softmax's shift-invariant
    bias (the cross-attention's ``k_proj.bias``, zero in exact
    arithmetic) at its weight's gradient scale."""
    scales = dict(zip(names, (w.abs().max().item() for w in want)))
    for n, g, w in zip(names, got, want):
        scale = scales[n.replace("k_proj.bias", "k_proj.weight")]
        err = (g - w).abs().max().item()
        assert err <= rel * scale or scale == 0 and err == 0, \
            (n, err, scale)


def assert_updated_alike(got, want, grads, names, lr):
    """The weights after an AdamW update: AdamW's update m / (sqrt(v) +
    eps) moves by about |dg| / |g| with the gradient, so where |g| is at
    least 1e-3 of its leaf's max (gradients that agree within 1e-5 of
    it) the two agree within 1e-2 lr and an f32 rounding of the weight;
    elsewhere each moves less than lr (``k_proj.bias``'s leaf max is its
    weight's, as in ``assert_grads_close``)."""
    scales = dict(zip(names, (g.abs().max() for g in grads)))
    for n, g in zip(names, grads):
        delta = (got[n] - want[n]).abs()
        steady = g.abs() >= 1e-3 * scales[n.replace("k_proj.bias",
                                                    "k_proj.weight")]
        tol = 1e-2 * lr + 2.0 ** -23 * want[n].abs()
        assert (delta <= tol)[steady].all(), (n, delta.max().item())
        assert (delta <= 2 * lr).all(), n


@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_step_as_one_process(four_ranks, name):
    """Each layout's two micro-batches (T4 with dropout on, D2 x T2 at 0)
    against one process: the losses within 1e-5 relative, on every rank;
    the first micro-batch's gathered gradients within 2e-3 of each
    leaf's max; after the update the weights (``assert_updated_alike``)
    and AdamW's moments (2e-3 of max), whole on every rank; a rank holds
    fewer parameters than one process."""
    spec, ranks = four_ranks
    _, counts, config = next(s for s in STEPS if s[0] == name)
    losses, acc, state, names = one_process_step(name, config, spec)
    whole = sum(p.numel() for p in state["model"].values())
    for res in ranks:
        np.testing.assert_allclose(res[name]["losses"], losses, rtol=1e-5)
        assert_grads_close(res[name]["acc"], acc, names)
        got = res[name]["state"]
        assert got["model"].keys() == state["model"].keys()
        grads = [s["exp_avg"] for s in state["optimizer"]["state"].values()]
        assert_updated_alike(got["model"], state["model"], grads, names,
                             ADAMW["lr"])
        for key in ("exp_avg", "exp_avg_sq"):
            assert_grads_close(
                [s[key] for s in got["optimizer"]["state"].values()],
                [s[key] for s in state["optimizer"]["state"].values()],
                names, 2 * GRAD_REL)
        assert res[name]["bytes"] < whole


def test_checkpoint_moves_between_tensor_counts(four_ranks):
    """A one-process checkpoint (an update and half an accumulation
    made, intra-epoch) recovered at D2 x T2: each rank holds its slices of the
    weights, of the AdamW moments and of the running mean; written back
    by the four ranks it is the one-process file, tensor for tensor; the
    next micro-batch (the update) on the recovered ranks is one
    process's on the recovered brain."""
    from tsasr_torch.convert import shard_state_dict
    from tsasr_torch.parallel.mesh import param_split_dims
    from tsasr_torch.training.checkpoints import Checkpointer, load_state
    spec, ranks = four_ranks
    one = load_state(os.path.join(spec["ckpt_dir"], "CKPT+one",
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
    splits = param_split_dims(one["model"], 2)
    names = one_process_brain(SCRATCH)._param_names()
    moments = {names[i]: s["exp_avg_sq"]
               for i, s in one["optimizer"]["state"].items()}
    for res in ranks:
        r = res["ckpt"]["model"]
        want = shard_state_dict(one["model"], r, 2)
        assert all(torch.equal(p, want[n])
                   for n, p in res["ckpt"]["params"].items())
        want = shard_state_dict(moments, r, 2, splits)
        assert all(torch.equal(m, want[n])
                   for n, m in res["ckpt"]["moments"].items())
        want = shard_state_dict(dict(zip(names, one["acc"])), r, 2, splits)
        assert all(torch.equal(a, want[n]) for n, a in
                   zip(names, res["ckpt"]["acc"]))
        assert res["ckpt"]["mini_step"] == 1
    # the written-back checkpoint resumes at T 1
    brain = one_process_brain(SCRATCH, spec["state"],
                              Checkpointer(spec["back_dir"]))
    brain.init_optimizers()
    brain.checkpointer.recover_if_possible()
    loss = fit(brain, spec["batches"][0])
    state = brain.checkpointer.recoverables["brain"]._state()
    grads = [s["exp_avg"] for s in state["optimizer"]["state"].values()]
    for res in ranks:
        np.testing.assert_allclose(res["ckpt"]["loss"], loss, rtol=1e-5)
        assert_updated_alike(res["ckpt"]["state"]["model"], state["model"],
                             grads, names, ADAMW["lr"])


# -------------------------------------------------- through the recipe
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from torch_port_helpers import CORPUS
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset
    root = tmp_path_factory.mktemp("corpus")
    make_dataset(str(root), **CORPUS)
    return root


@pytest.mark.parametrize("layout,nproc,flags,dropout,place", [
    ("D2T2", 4, ["--data_parallel_count", "2"], "0.0",
     "rank 3 of 4 over gloo, data 1 of 2, pipe 0 of 1, seq 0 of 1, "
     "model 1 of 2"),
    ("T2", 2, [], "0.1",
     "rank 1 of 2 over gloo, data 0 of 1, pipe 0 of 1, seq 0 of 1, "
     "model 1 of 2")])
def test_tensor_parallel_experiment_as_one_process(corpus, tmp_path, layout,
                                                    nproc, flags, dropout,
                                                    place):
    """The scratch entry module at D2 x T2 (dropout 0: the data shards
    draw apart) and at T2 with dropout on (one data shard draws as one
    process), against one process: each micro-batch's and each epoch's
    loss within 1e-5 relative, the WER file naming every TEST utterance
    once, each rank's place on the axes."""
    one, many, out = parallel_against_one_process(
        "scratch", TORCH_YAML, corpus, tmp_path, nproc,
        ["--tensor_parallel_count", "2", *flags], ["--dropout", dropout])
    logs = ["log.txt"] + [f"log_proc{r}.txt" for r in range(1, nproc)]
    hold_against_one_process(one, many, logs)
    assert place in (many / logs[-1]).read_text()
    # 2 mixture and 6 speaker encoder layers (the yaml's), 8 each
    assert "tensor parallelism: 64 leaves split over the model axis of 2" \
        in (many / "log.txt").read_text()


@pytest.mark.parametrize("counts", [(1, 1, 2, 2), (1, 2, 1, 2),
                                    (2, 1, 2, 2)])
def test_tensor_beside_sequence_or_pipeline_is_accepted(monkeypatch,
                                                        counts):
    """``check_parallel_counts`` returns (D, P, S, T) for T beside S or P
    (JAX's four-axis mesh), D given or left to the world size."""
    from tsasr_torch.training import experiment
    dp, pp, sp, tp = counts
    monkeypatch.setattr(experiment, "world_size", lambda: dp * pp * sp * tp)
    opts = {"tensor_parallel_count": tp, "pipeline_parallel_count": pp,
            "sequence_parallel_count": sp}
    assert experiment.check_parallel_counts(opts) == counts
    assert experiment.check_parallel_counts(
        dict(opts, data_parallel_count=dp)) == counts
    with pytest.raises(NotImplementedError, match="world size"):
        experiment.check_parallel_counts(
            dict(opts, data_parallel_count=dp + 1))
