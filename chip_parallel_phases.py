"""The data parallel and model parallel phases of ``chip_smoke.py``
alone, as its ``main`` runs them, timed on the card: the kernels built,
the experiment's synthetic corpus, the model parallel one-process runs,
``phase_ddp`` with the model parallel runs in its launch, then
``model_parallel_hold``. Prints the two phases' seconds on a line
starting ``PHASES``, then ``PARALLEL_PHASES_OK``; exits 1 without a
card.

Run from a tree's root: ``python3 chip_parallel_phases.py``. To compare
two commits on one card, unpack each with ``git archive`` into a folder
that ``.gitignore`` lists, copy this file into both, and run each from
its own root, in turns, in one call (the two phases take ~3-5 minutes,
the whole ``chip_smoke.py`` ~8-13)."""
import sys
import tempfile
import time
from pathlib import Path


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_parallel_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from tsasr_torch import native
    from tsasr_torch.kernels import _build
    from tsasr_torch.kernels import relpos_attention as ra
    from tsasr_torch.kernels import rnnt_lattice as rl
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    t0 = time.perf_counter()
    native.build()
    _build.build([ra.SOURCE, ra.BWD_SOURCE, rl.SOURCE])
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="tsasr_corpus_") as tmp:
        corpus = Path(tmp) / "corpus"
        make_dataset(str(corpus), **cs.EXPERIMENT_CORPUS)
        corpus = cs.cut_corpus(corpus, Path(tmp) / "eval_cut",
                               {cs.EXPERIMENT_SPLITS[1]: cs.EVAL_MIXTURES,
                                cs.EXPERIMENT_SPLITS[2]: cs.EVAL_MIXTURES})
        with tempfile.TemporaryDirectory(prefix="tsasr_mp_") as mp_tmp:
            mp_tmp = Path(mp_tmp)
            t1 = time.perf_counter()
            ones, runs = cs.model_parallel_runs(device, mp_tmp)
            _, by_run = cs.phase_ddp(device, card, corpus, also=runs)
            t2 = time.perf_counter()
            launches = cs.model_parallel_hold(device, card, mp_tmp, ones,
                                              by_run)
            t3 = time.perf_counter()
    cs.log(f"PHASES ddp + model parallel {t3 - t1:.1f} s (the one-process "
           f"runs and phase_ddp {t2 - t1:.1f}, the holds {t3 - t2:.1f}); "
           f"launches {launches} [{card}]")
    print("PARALLEL_PHASES_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
