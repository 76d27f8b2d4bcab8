"""Experiment CLI + directory management.

The port of the JAX package's ``training/experiment.py``, the
reference's CLI layer (``core.py:55-410``):
- ``parse_arguments``: run-opt flags (device/debug/precision/ckpt
  intervals/grad accumulation/...) are parsed; every *unknown*
  ``--key value`` pair becomes a YAML override so anything in the hparams
  file is overridable from the command line (``core.py:396-410``);
- ``create_experiment_directory``: experiment dir with the resolved
  hyperparams file, a copy of the invoking script, ``log.txt`` wired to
  an excepthook for crash forensics, and ``env.log`` with the
  environment snapshot (``core.py:55-131``).

The flags are the JAX package's. ``--device`` is the torch device
(``cuda`` unless given, which raises without a card; ``cpu`` to run on
the host). ``--precision bf16`` builds the model in bf16 (the recipe).
``--profile`` traces training and evaluation with ``torch.profiler``
into ``--profile_dir`` (the recipe's ``<output_folder>/profiler`` unless
given; ``utils/profiling.py``).

Parallelism: ``parse_arguments`` first joins the process group a
launcher announced (``python -m tsasr_torch.parallel.launch``, or
``torchrun``; ``parallel/distributed.py``), one process per device, its
backend named by ``--device``. ``--data_parallel_count`` (D),
``--pipeline_parallel_count`` (P), ``--sequence_parallel_count`` (S)
and ``--tensor_parallel_count`` (T) must multiply to the world size (D
defaults to what the other three leave of it); the rank layout and the
axes' process groups are then made (``distributed.init_layout``); T
above 1 runs beside P or S above 1 as JAX's four-axis mesh runs it. One
process driving several devices, as JAX's does, raises
``NotImplementedError``. The experiment directory is made by process 0
behind a barrier; process 0 logs to ``log.txt``, the others to
``log_proc{rank}.txt``.
"""

import argparse
import logging
import os
import shutil
import sys

import yaml

from tsasr_torch.parallel.distributed import (
    if_main_process,
    init_layout,
    is_distributed,
    maybe_init_distributed,
    rank,
    run_on_main,
    world_size,
)
from tsasr_torch.utils.hparams import dump_resolved_yaml
from tsasr_torch.utils.logger import (
    get_environment_description,
    setup_logging,
)

logger = logging.getLogger(__name__)

RUN_OPT_FLAGS = [
    ("--debug", {"action": "store_true", "default": None,
                 "help": "Tiny run: debug_batches/debug_epochs only"}),
    ("--debug_batches", {"type": int, "default": None}),
    ("--debug_epochs", {"type": int, "default": None}),
    ("--device", {"type": str, "default": None,
                  "help": "torch device: cuda (the default), cuda:N or "
                  "cpu"}),
    ("--precision", {"type": str, "default": None,
                     "choices": ["fp32", "bf16"]}),
    ("--noprogressbar", {"action": "store_true", "default": None}),
    ("--grad_accumulation_factor", {"type": int, "default": None}),
    ("--optimizer_step_limit", {"type": int, "default": None}),
    ("--ckpt_interval_minutes", {"type": float, "default": None}),
    ("--ckpt_interval_steps", {"type": int, "default": None}),
    ("--max_grad_norm", {"type": float, "default": None}),
    ("--nonfinite_patience", {"type": int, "default": None}),
    ("--test_only", {"action": "store_true", "default": None}),
    ("--data_parallel_count", {"type": int, "default": None,
                               "help": "devices on the data axis"}),
    ("--tensor_parallel_count", {"type": int, "default": None,
                                 "help": "devices on the model axis"}),
    ("--sequence_parallel_count", {"type": int, "default": None,
                                   "help": "devices on the seq (time) "
                                   "axis"}),
    ("--pipeline_parallel_count", {"type": int, "default": None,
                                   "help": "devices on the pipe (layer) "
                                   "axis"}),
    ("--profile", {"action": "store_true", "default": None,
                   "help": "capture a profiler trace of training"}),
    ("--profile_dir", {"type": str, "default": None}),
]


def parse_arguments(arg_list=None):
    """Returns (hparams_file, run_opts dict, overrides yaml string).

    Joins the launched process group first (``maybe_init_distributed``,
    on the backend ``--device`` names), then lays its ranks out over the
    data, pipeline, sequence and model axes (``init_layout``). Raises
    ``NotImplementedError`` for counts that do not multiply to the world
    size."""
    if arg_list is None:
        arg_list = sys.argv[1:]
    parser = argparse.ArgumentParser(description="tsasr_torch experiment")
    parser.add_argument("hparams_file", type=str,
                        help="HyperPyYAML hparams file")
    for flag, kwargs in RUN_OPT_FLAGS:
        parser.add_argument(flag, **kwargs)
    known, unknown = parser.parse_known_args(arg_list)
    run_opts = {k: v for k, v in vars(known).items()
                if k != "hparams_file" and v is not None}
    maybe_init_distributed(run_opts.get("device", "cuda"))
    counts = check_parallel_counts(run_opts)
    if is_distributed():
        init_layout(*counts)
    check_precision(run_opts.get("precision"))
    overrides = _unknown_to_overrides(unknown)
    return known.hparams_file, run_opts, overrides


def check_parallel_counts(run_opts):
    """(D, P, S, T) of ``run_opts``, the data, pipeline, sequence and
    tensor counts; raises unless D·P·S·T is this run's world size (D,
    when not given, is what P·S·T leave of it)."""
    tp = run_opts.get("tensor_parallel_count") or 1
    pp = run_opts.get("pipeline_parallel_count") or 1
    sp = run_opts.get("sequence_parallel_count") or 1
    world = world_size()
    dp = run_opts.get("data_parallel_count")
    if dp is None:
        dp = max(world // (pp * sp * tp), 1)
    if dp * pp * sp * tp != world:
        raise NotImplementedError(
            f"--data_parallel_count {dp} x --pipeline_parallel_count {pp} x "
            f"--sequence_parallel_count {sp} x --tensor_parallel_count {tp} "
            f"is not this run's world size {world}: the port runs one "
            f"process per device; launch {dp * pp * sp * tp} ranks with "
            "python -m tsasr_torch.parallel.launch --nproc_per_node "
            f"{dp * pp * sp * tp}")
    return dp, pp, sp, tp


def check_precision(precision):
    """Raise unless ``precision`` is fp32, bf16 or unset."""
    if precision not in (None, "fp32", "bf16"):
        raise ValueError(f"precision {precision!r} is not fp32 or bf16")


def _unknown_to_overrides(unknown):
    """['--lr', '3e-4', '--augment=True'] -> YAML override string."""
    pairs = {}
    i = 0
    while i < len(unknown):
        arg = unknown[i]
        if not arg.startswith("--"):
            raise ValueError(f"Unexpected positional argument: {arg}")
        if "=" in arg:
            key, value = arg[2:].split("=", 1)
            i += 1
        else:
            key = arg[2:]
            if i + 1 >= len(unknown):
                raise ValueError(f"Override flag --{key} missing a value")
            value = unknown[i + 1]
            i += 2
        pairs[key] = yaml.safe_load(value)
    return yaml.safe_dump(pairs) if pairs else ""


def create_experiment_directory(experiment_directory,
                                hyperparams_to_save=None, overrides=None,
                                log_config=None, save_env_desc=True):
    """Create the experiment dir (main process), wire logging/excepthook."""

    def _create():
        os.makedirs(experiment_directory, exist_ok=True)
        if hyperparams_to_save is not None:
            dump_resolved_yaml(
                hyperparams_to_save, overrides,
                os.path.join(experiment_directory, "hyperparams.yaml"))
        script = os.path.realpath(sys.argv[0])
        if os.path.isfile(script):
            shutil.copy(script, experiment_directory)
        if save_env_desc:
            with open(os.path.join(experiment_directory, "env.log"),
                      "w") as f:
                f.write(get_environment_description())

    run_on_main(_create)
    # the other processes log to their own file and keep the console for
    # warnings
    main = if_main_process()
    log_file = os.path.join(experiment_directory,
                            "log.txt" if main else f"log_proc{rank()}.txt")
    setup_logging(log_file,
                  console_level=logging.INFO if main else logging.WARNING)
    sys.excepthook = _make_excepthook(log_file)
    if main:
        logger.info("Beginning experiment!")
        logger.info("Experiment folder: %s", experiment_directory)
    else:
        logger.info("Worker process %d of %d ready", rank(), world_size())


def _make_excepthook(log_file):
    def excepthook(exc_type, exc_value, exc_traceback):
        import traceback
        try:
            with open(log_file, "a") as f:
                f.write("\nException:\n")
                traceback.print_exception(exc_type, exc_value,
                                          exc_traceback, file=f)
        except OSError:     # the experiment's folder is gone
            pass
        sys.__excepthook__(exc_type, exc_value, exc_traceback)

    return excepthook
