"""The port's data parallelism (``tsasr_torch.parallel``) against the
JAX package's, on the CPU over gloo.

- ``DistributedSamplerWrapper`` and the data axis's batch layout
  (``pad_batch_to``, ``shard_batch``, ``rank_rows``) against JAX's, its
  layout against the contiguous blocks of a ``make_mesh(dp=2)``;
- the launcher: two workers join, gather payloads of unequal size,
  broadcast, see a file written under ``run_on_main`` after its barrier,
  print ``[p0]`` / ``[p1]`` lines; a failing worker ends the other and
  its exit code comes back;
- two gloo ranks against one process on one global batch of 5 rows (a
  zero-weight duplicate padded in) of a tiny scratch model at dropout 0:
  with augmentation on, the all-reduced gradient within 1e-6 of each
  leaf's max |g| and the loss within 1e-6 relative; with it off, the
  same against the JAX recipe's loss on a ``make_mesh(dp=2)`` at
  ``tests/test_torch_training.py``'s tolerances (loss 1e-5 relative,
  gradients 1e-4 of max |g|); a NaN in one rank's rows makes both ranks
  skip; rank 1's dropout draws are not rank 0's, the augmentation's are,
  and at one process every draw is the one-process formula's;
- the scratch experiment through the launcher on two ranks against one
  process (augmentation on, dropout 0): each micro-batch's loss, the
  hypotheses, the TEST WER file with each utterance once and each rank's
  log its own shard, one checkpoint, and a two-rank ``--test_only`` run
  reproducing the WER file;
- ``parse_arguments``' parallel counts (the data, pipeline and
  sequence counts multiply to the world size; the tensor count raises
  above 1), and what raises instead of falling back.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from torch_ddp_helpers import CONFIG, HPARAMS, PADDED_KEYS, fit, step_brain
from torch_port_helpers import CORPUS, TORCH_YAML, corpus_vocab
from tsasr_torch.data.batch import PaddedBatch
from tsasr_torch.parallel import distributed
from tsasr_torch.parallel.mesh import pad_batch_to, rank_rows, shard_batch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
B = 5                   # odd: the second rank's block ends in a duplicate
NAN_ROW = 4             # a row of rank 1's block


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_logging_restored():
    """Torch on one thread beside the other test processes; the
    experiment points the root logger at its folder, the tests after
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
               PYTHONPATH=os.pathsep.join([REPO, TESTS,
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


# ------------------------------------------------------------- layouts
@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("n_items", [0, 1, 2, 5, 6, 7, 11])
def test_sampler_shards_match_jax(n_items, world):
    from tsasr_torch.data import DistributedSamplerWrapper
    from tsasr_tpu.data.sampler import DistributedSamplerWrapper as Jax
    batches = [[i, 100 + i] for i in range(n_items)]
    shards = []
    for rank in range(world):
        got = DistributedSamplerWrapper(batches, rank, world)
        want = Jax(batches, rank, world)
        assert list(got) == list(want)
        assert len(got) == len(want)
        shards.append(list(got))
    assert {b[0] for shard in shards for b in shard} == set(range(n_items))


@pytest.mark.parametrize("rows", [1, 4, 5])
def test_rank_rows_are_the_jax_mesh_blocks(rows):
    import jax
    from tsasr_tpu.parallel.mesh import make_mesh
    from tsasr_tpu.parallel.mesh import pad_batch_to as jax_pad
    from tsasr_tpu.parallel.mesh import shard_batch as jax_shard
    rng = np.random.default_rng(rows)
    arrays = {"x": rng.normal(size=(rows, 3, 2)).astype(np.float32),
              "tokens": rng.integers(0, 9, size=(rows, 4)),
              "weight": np.ones(rows, np.float32)}
    padded = pad_batch_to(arrays, 2)
    want = jax_pad(arrays, 2)
    assert padded.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(padded[key], want[key])
    n = len(padded["weight"])
    assert padded["weight"].sum() == rows and not padded["weight"][rows:].any()
    mesh = make_mesh(dp=2, devices=jax.devices()[:2])
    on_mesh = jax_shard(arrays, mesh)
    for rank in range(2):
        block = shard_batch(padded, rank, 2)
        held, shard = rank_rows(arrays, rank, 2)
        for key in arrays:
            device = mesh.devices[rank, 0]
            [piece] = [s.data for s in on_mesh[key].addressable_shards
                       if s.device == device]
            np.testing.assert_array_equal(block[key], np.asarray(piece))
            np.testing.assert_array_equal(held[key], block[key])
        start = rank * n // 2
        np.testing.assert_array_equal(
            arrays["x"][shard.rows], padded["x"][start:start + n // 2])
        assert list(shard.real) == [start + i < rows for i in range(n // 2)]
        assert shard.size == rows and shard.weight_total == rows
    with pytest.raises(ValueError, match="pad_batch_to"):
        shard_batch({"x": np.zeros((3, 1))}, 0, 2)


# ------------------------------------------------------------ launcher
COLLECTIVES_WORKER = textwrap.dedent("""
    import os
    import sys
    import time

    from tsasr_torch.parallel import distributed

    assert distributed.maybe_init_distributed("cpu")
    rank, world = distributed.rank(), distributed.world_size()
    got = distributed.all_gather_object({"rank": rank,
                                         "payload": "x" * (10 + 7 * rank)})
    assert [g["rank"] for g in got] == list(range(world)), got
    assert [len(g["payload"]) for g in got] == [10 + 7 * r
                                               for r in range(world)]
    assert distributed.broadcast_object(f"from {rank}") == "from 0"
    path = sys.argv[1]

    def write():
        time.sleep(0.5)           # the other rank waits at the barrier
        with open(path, "w") as f:
            f.write("written by the main process")

    distributed.run_on_main(write)
    assert open(path).read() == "written by the main process"
    print(f"DIST_OK rank={rank} world={world}", flush=True)
    if len(sys.argv) > 2:
        if rank == 1:
            sys.exit(int(sys.argv[2]))
        time.sleep(300)           # ended by the launcher
""")


def test_launcher_joins_gathers_and_propagates_a_failure(tmp_path):
    """One launch: both ranks pass their checks, then rank 1 exits with 3
    while rank 0 sleeps; the launcher ends rank 0 and returns 3."""
    worker = tmp_path / "worker.py"
    worker.write_text(COLLECTIVES_WORKER)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tsasr_torch.parallel.launch",
         "--nproc_per_node", "2", "--log_dir", str(tmp_path / "logs"),
         str(worker), str(tmp_path / "main.txt"), "3"],
        cwd=REPO, env=worker_env(), capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 3, proc.stdout[-3000:]
    assert time.perf_counter() - t0 < 120       # rank 0 did not sleep on
    assert "[p0] DIST_OK rank=0 world=2" in proc.stdout
    assert "[p1] DIST_OK rank=1 world=2" in proc.stdout
    assert "DIST_OK rank=1" in (tmp_path / "logs" / "proc1.log").read_text()


def test_launcher_needs_a_target():
    from tsasr_torch.parallel import launch as launcher
    with pytest.raises(SystemExit):
        launcher.main(["--nproc_per_node", "2"])
    assert launcher._split(["--nproc_per_node", "2", "--log_dir=x", "-m",
                            "pkg.mod", "--device", "cpu"]) == (
        ["--nproc_per_node", "2", "--log_dir=x"],
        ["-m", "pkg.mod", "--device", "cpu"])


# ----------------------------------------------------------- gradients
def make_batch(seed, n=B, nan_row=None):
    """A PaddedBatch of ``n`` rows ragged in every length; ``nan_row``
    puts a NaN into that row's mixture."""
    rng = np.random.default_rng(seed)
    examples = []
    for b in range(n):
        toks = rng.integers(1, 29, size=6 - b % 3)
        mixed = (rng.normal(size=6000 - 700 * b) * 0.1).astype(np.float32)
        if b == nan_row:
            mixed[100] = np.nan
        examples.append({
            "id": f"utt{seed}-{b}", "mixed_sig": mixed,
            "enroll_sig": (rng.normal(size=5000 - 500 * b)
                           * 0.1).astype(np.float32),
            "tokens_bos": np.concatenate([[0], toks]).astype(np.int64),
            "tokens": toks.astype(np.int64), "target_words": ["x"]})
    return examples


STEP_WORKER = textwrap.dedent("""
    import sys

    import torch

    from torch_ddp_helpers import fit, step_brain
    from tsasr_torch.parallel import distributed

    torch.set_num_threads(1)
    assert distributed.maybe_init_distributed("cpu")
    spec = torch.load(sys.argv[1], weights_only=False)
    out = {}
    for name, augment, dtype in (("f64", True, torch.float64),
                                 ("f32", False, torch.float32)):
        brain = step_brain(spec["state"], augment, dtype)
        loss, grads = fit(brain, spec["batch"], dtype)
        out[name] = {"loss": loss, "grads": grads,
                     "rows": brain.batch_shard.rows.tolist()}
    brain = step_brain(spec["state"], False)
    loss, _ = fit(brain, spec["nan_batch"])
    out["nan"] = {"loss": loss, "nonfinite": brain.nonfinite_count,
                  "micro_steps": brain.global_micro_step}
    brain.step = 1
    out["draws"] = {stream: torch.rand(8, generator=brain.step_generator(
        stream)) for stream in (0, 1)}
    torch.save(out, f"{sys.argv[2]}/rank{distributed.rank()}.pt")
    print(f"STEP_OK rank={distributed.rank()}", flush=True)
""")


def assert_leaves_close(got, want, rel):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=rel * float(w.abs().max()))


@pytest.fixture(scope="module")
def two_rank_step(tmp_path_factory):
    """(the weights and batches, the two gloo ranks' results)."""
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    from tsasr_torch.ops.augment import draw_speed
    tmp = tmp_path_factory.mktemp("step")
    state = TSTransducer(TSTransducerConfig(**CONFIG)).init_weights(
        seed=0).state_dict()
    spec = {"state": state, "batch": make_batch(0),
            "nan_batch": make_batch(1, nan_row=NAN_ROW)}
    torch.save(spec, tmp / "spec.pt")
    worker = tmp / "worker.py"
    worker.write_text(STEP_WORKER)
    rc, logs = launch(tmp / "logs", 2, worker, tmp / "spec.pt", tmp)
    assert rc == 0, logs[-4000:]
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    # the seed's augmentation resamples: its speed is not 100
    brain = step_brain(state, True)
    brain.step = 1
    assert draw_speed(brain.step_generator(1), (95, 100, 105)) != 1
    return spec, ranks


def test_two_ranks_step_as_one_process_with_augmentation(two_rank_step):
    """In f64: in f32 the split of the row sums alone moves a gradient
    leaf by more than 1e-6 of its max (a 1x1 convolution's weight,
    1.4e-6 here; the f32 step against f64 differs by 2.9e-6), so f32 is
    held at the f32 tolerance."""
    spec, ranks = two_rank_step
    for name, augment, dtype, rel in (("f64", True, torch.float64, 1e-6),
                                      ("f32", False, torch.float32, 1e-4)):
        loss, grads = fit(step_brain(spec["state"], augment, dtype),
                          spec["batch"], dtype)
        for got in ranks:
            np.testing.assert_allclose(got[name]["loss"], loss,
                                       rtol=rel / 10 if name == "f32"
                                       else rel)
            assert_leaves_close(got[name]["grads"], grads, rel)
        assert ranks[0][name]["rows"] == [0, 1, 2]
        assert ranks[1][name]["rows"] == [3, 4, 0]  # a zero-weight copy


def test_two_ranks_step_as_the_jax_dp2_mesh(two_rank_step):
    import jax
    from tsasr_torch.convert import params_to_flax
    from tsasr_tpu.models.transducer import TSTransducer as JaxTransducer
    from tsasr_tpu.models.transducer import TSTransducerConfig as JaxConfig
    from tsasr_tpu.parallel.mesh import make_mesh
    from tsasr_tpu.recipes.librispeechmix import TSASRBrain as JaxBrain
    from tsasr_tpu.utils.stage import Stage as JaxStage

    spec, ranks = two_rank_step
    jbrain = JaxBrain(modules={"model": JaxTransducer(JaxConfig(**CONFIG))},
                      hparams=dict(HPARAMS, augment=False),
                      variant="scratch",
                      mesh=make_mesh(dp=2, devices=jax.devices()[:2]))
    arrays = jbrain._put_batch(jbrain.batch_to_arrays(
        PaddedBatch(spec["batch"], padded_keys=PADDED_KEYS)))
    assert arrays["weight"].shape == (B + 1,)
    params = {"params": params_to_flax(spec["state"])}

    def loss_fn(p):
        preds = jbrain.compute_forward(p, arrays, JaxStage.TRAIN,
                                       jax.random.PRNGKey(1))
        return jbrain.compute_objectives(preds, arrays, JaxStage.TRAIN)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    names = list(spec["state"])
    flat = dict(jax.tree_util.tree_flatten_with_path(
        params_to_flax(dict(zip(names, ranks[0]["f32"]["grads"]))))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(
        want_grads["params"])[0])
    assert flat.keys() == want.keys()
    np.testing.assert_allclose(ranks[0]["f32"]["loss"], float(want_loss),
                               rtol=1e-5)
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(flat[key]), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(key))


def test_a_nan_in_one_ranks_rows_skips_on_both(two_rank_step):
    spec, ranks = two_rank_step
    brain = step_brain(spec["state"], False)
    loss, _ = fit(brain, spec["nan_batch"])
    assert not np.isfinite(loss) and brain.nonfinite_count == 1
    for got in ranks:
        assert not np.isfinite(got["nan"]["loss"])
        assert got["nan"]["nonfinite"] == 1
        assert got["nan"]["micro_steps"] == 0


def test_dropout_draws_fold_in_the_rank_and_nothing_else(two_rank_step):
    spec, ranks = two_rank_step
    assert not torch.equal(ranks[0]["draws"][0], ranks[1]["draws"][0])
    assert torch.equal(ranks[0]["draws"][1], ranks[1]["draws"][1])
    # one process: the formula of the one-process Brain, bit for bit
    brain = step_brain(spec["state"], False)
    for step, opt_step, stream in ((1, 0, 0), (3, 2, 0), (2, 5, 1)):
        brain.step, brain.optimizer_step = step, opt_step
        entropy = [HPARAMS["seed"], opt_step * 131071 + step]
        key = np.random.SeedSequence(entropy + [stream] if stream
                                     else entropy)
        gen = torch.Generator().manual_seed(
            int(key.generate_state(1, np.uint64)[0] >> 1))
        assert torch.equal(torch.rand(8, generator=brain.step_generator(
            stream)), torch.rand(8, generator=gen))
    brain.step, brain.optimizer_step = 1, 0
    assert torch.equal(ranks[0]["draws"][1],
                       torch.rand(8, generator=brain.step_generator(1)))


# ---------------------------------------------------------- experiment
EXPERIMENT_ARGS = ["--encoder_num_layers", "1", "--d_ffn", "32",
                   "--d_model", "16", "--nhead", "2",
                   "--decoder_neurons", "16", "--joint_dim", "24",
                   "--beam_size", "1", "--valid_search_freq", "1",
                   "--noprogressbar", "--num_epochs", "1",
                   # 2 TRAIN micro-batches, 1 optimizer step
                   "--num_buckets", "1", "--train_max_batch_length", "12.0",
                   # one utterance a TEST batch: 12 batches, 6 a rank
                   "--test_max_batch_length", "0.5",
                   "--grad_accumulation_factor", "2",
                   "--augment", "True", "--dropout", "0.0",
                   "--device", "cpu"]


def micro_batch_losses(log_text):
    return [float(x) for x in re.findall(
        r"TRAIN micro-batch \d+ loss (\S+)", log_text)]


def decoded(log_text, stage="TEST"):
    return [key for keys in re.findall(rf"{stage} decoded (\[.*\])",
                                       log_text)
            for key in json.loads(keys.replace("'", '"'))]


def wer_entries(text):
    """{utterance key: its alignment block} of a WER file."""
    entries = {}
    for block in text.split("=" * 80)[2:]:
        lines = block.strip().splitlines()
        if lines:
            key = lines[0].split(",")[0]
            assert key not in entries, f"{key} listed twice"
            entries[key] = "\n".join(lines)
    return entries


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset
    root = tmp_path_factory.mktemp("corpus")
    make_dataset(str(root), **CORPUS)
    return root


def test_two_rank_experiment_as_one_process(corpus, tmp_path):
    from tsasr_torch.recipes.librispeechmix import run_experiment
    args = [str(TORCH_YAML), "--data_folder", str(corpus), "--vocab_size",
            str(corpus_vocab(corpus)), *EXPERIMENT_ARGS]
    one, two = tmp_path / "one", tmp_path / "two"
    brain = run_experiment(argv=args + ["--output_folder", str(one)])
    assert brain.optimizer_step >= 1
    rc, out = launch(tmp_path / "logs", 2, "-m",
                     "tsasr_torch.train_librispeechmix_scratch", *args,
                     "--output_folder", two, "--data_parallel_count", 2)
    assert rc == 0, out[-4000:]
    logs = [(two / name).read_text() for name in ("log.txt",
                                                  "log_proc1.txt")]
    want = micro_batch_losses((one / "log.txt").read_text())
    assert len(want) >= 2
    for log in logs:
        np.testing.assert_allclose(micro_batch_losses(log), want, rtol=1e-5)
        assert "rank" in log and "over gloo" in log
    # TEST: each rank decoded its own shard, the WER file names each
    # utterance once, and it holds the one-process run's hypotheses
    wer_one = wer_entries((one / "wer_test-clean-2mix.txt").read_text())
    wer_two = (two / "wer_test-clean-2mix.txt").read_text()
    shards = [decoded(log) for log in logs]
    assert not set(shards[0]) & set(shards[1])
    assert sorted(shards[0] + shards[1]) == sorted(wer_one)
    assert wer_entries(wer_two) == wer_one
    hyps = [entry.splitlines()[3] for entry in wer_one.values()]
    assert any(h.strip(" ;<eps>") for h in hyps)        # not all empty
    assert wer_two.splitlines()[0] == \
        (one / "wer_test-clean-2mix.txt").read_text().splitlines()[0]
    assert not (two / "log_proc0.txt").exists()
    assert len(list((two / "save").glob("CKPT+*"))) == 1
    # a two-rank --test_only run recovers the checkpoint and reproduces
    # the WER file
    (two / "wer_test-clean-2mix.txt").rename(two / "first_wer.txt")
    rc, out = launch(tmp_path / "test_only_logs", 2, "-m",
                     "tsasr_torch.train_librispeechmix_scratch", *args,
                     "--output_folder", two, "--test_only")
    assert rc == 0, out[-4000:]
    assert (two / "wer_test-clean-2mix.txt").read_text() == \
        (two / "first_wer.txt").read_text()


# --------------------------------------------------------------- flags
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("flag,value,ok", [
    ("data_parallel_count", "same", True),
    ("data_parallel_count", "other", False),
    ("tensor_parallel_count", 1, True),
    ("tensor_parallel_count", 2, False),
    ("sequence_parallel_count", 1, True),
    ("sequence_parallel_count", 2, False),
    ("pipeline_parallel_count", 1, True),
    ("pipeline_parallel_count", 2, False),
])
def test_parallel_counts(monkeypatch, world, flag, value, ok):
    """The counts must multiply to the world size: a sequence, pipeline
    or tensor count of 2 takes both ranks of a world of 2 (the data count
    then defaults to 1) and has no room in a world of 1."""
    from tsasr_torch.training import experiment
    monkeypatch.setattr(experiment, "world_size", lambda: world)
    if value == "same":
        value = world
    elif value == "other":
        value = 3 - world
    if flag in ("sequence_parallel_count", "pipeline_parallel_count",
                "tensor_parallel_count") and value == 2:
        ok = world == 2
    argv = [str(TORCH_YAML), f"--{flag}", str(value)]
    if ok:
        _, run_opts, _ = experiment.parse_arguments(argv)
        assert run_opts[flag] == value
        counts = dict(zip(("data_parallel_count",
                           "pipeline_parallel_count",
                           "sequence_parallel_count",
                           "tensor_parallel_count"),
                          experiment.check_parallel_counts(run_opts)))
        assert np.prod(list(counts.values())) == world
        assert counts.get(flag, value) == value
    else:
        with pytest.raises(NotImplementedError, match="world size"):
            experiment.parse_arguments(argv)


def test_nothing_falls_back(monkeypatch):
    for key in distributed.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert distributed.rank_device("cuda") == torch.device("cuda")
    assert distributed.maybe_init_distributed("cpu") is False
    # a launched rank whose local rank has no card
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="has 1 CUDA device"):
        distributed.backend_for("cuda")
    assert distributed.backend_for("cuda:0") == ("gloo",
                                                 torch.device("cuda:0"))
    assert distributed.backend_for("cpu") == ("gloo", torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.backend_for("cuda") == ("nccl",
                                               torch.device("cuda:1"))
    # a rank missing what it needs to join
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        distributed.maybe_init_distributed("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.backend_for("cuda")
