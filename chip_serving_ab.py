#!/usr/bin/env python3
"""Time the serving path of versions of tsasr_torch against each other on
one CUDA card.

Run from the root of a checkout:

    python3 chip_serving_ab.py old=path/to/old head=. \\
        --order old,head,head,old,old,head,head,old

Each NAME=DIR is a directory that holds a ``tsasr_torch`` package (an
older one unpacked with ``git archive <commit> tsasr_torch | tar -x -C
DIR``). Each entry of the order runs in a process of its own, which
imports only that tree's package (its kernels built into DIR/build on
first use), builds the scratch recipe's model at full width with the
seed-0 weights, and answers ``chip_smoke.py``'s three requests (8
mixtures of 4, 8 and 12 s, 5 s enrollments) through
``TSASRTranscriber.transcribe_batch``: once to warm up, then REPS times
each, on the host clock (to a synchronize), and once more under
``torch.profiler`` for the card's busy time. It prints the card, one
line per process, then per request each version's medians in the order
run, and exits 1 if the versions' weights differ or a process fails.
"""

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS = 5


def worker(tree):
    """One version's serving times, as one JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(tree).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import tsasr_torch
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.models.transducer import TSTransducer, scratch_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = TSTransducer(scratch_config()).init_weights(seed=cs.SEED)
    weights = hashlib.sha256(b"".join(
        p.detach().contiguous().numpy().tobytes()
        for p in model.parameters())).hexdigest()[:12]
    tr = TSASRTranscriber(model, None, CharTokenizer(cs.PIECES),
                          device="cuda")
    requests = cs.make_requests(np.random.default_rng(cs.SEED))
    texts = [tr.transcribe_batch(*r) for r in requests]    # warm-up
    torch.cuda.synchronize()
    host, device = {}, {}
    for seconds, req in zip(cs.REQUEST_SECONDS, requests):
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            tr.transcribe_batch(*req)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        host[seconds] = times
        device[seconds] = sum(cs.device_ms_by_kernel(
            lambda: tr.transcribe_batch(*req), reps=1).values())
    return {"package": str(Path(tsasr_torch.__file__).parent),
            "weights": weights, "host_ms": host, "device_ms": device,
            "texts": hashlib.sha256(json.dumps(texts).encode())
            .hexdigest()[:12]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("versions", nargs="*", metavar="NAME=DIR")
    parser.add_argument("--order", help="comma-separated names, e.g. "
                        "a,b,b,a (default: each version once)")
    parser.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    if not args.versions or not all("=" in v for v in args.versions):
        parser.error("give versions as NAME=DIR")
    versions = dict(v.split("=", 1) for v in args.versions)
    order = args.order.split(",") if args.order else list(versions)
    if set(order) - set(versions):
        parser.error(f"--order names {set(order) - set(versions)}, which "
                     "are not given")
    for name, tree in versions.items():
        if not (Path(tree) / "tsasr_torch" / "__init__.py").exists():
            parser.error(f"{name}: no tsasr_torch package in {tree}")

    import torch
    if not torch.cuda.is_available():
        print("chip_serving_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    card = cs.card_line()
    print(card, flush=True)

    runs = []
    for name in order:
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", versions[name]],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"{name}: exited {proc.returncode}\n{proc.stderr[-3000:]}")
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((name, run))
        print(f"{name} ({run['package']}): weights {run['weights']}, "
              f"transcripts {run['texts']}; " + "; ".join(
                  f"{s} s host median {statistics.median(v):.1f} ms "
                  f"(min {min(v):.1f}), device {run['device_ms'][s]:.2f} ms"
                  for s, v in run["host_ms"].items()), flush=True)

    print(f"ms per request, host median / device, in the order run "
          f"({card}):")
    for s in runs[0][1]["host_ms"]:
        print(f"  {s} s: " + "; ".join(
            f"{name} {statistics.median(run['host_ms'][s]):.1f} / "
            f"{run['device_ms'][s]:.2f}" for name, run in runs))
    if len({run["weights"] for _, run in runs}) != 1:
        print("the versions' weights differ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
