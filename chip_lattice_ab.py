#!/usr/bin/env python3
"""Time versions of the RNN-T lattice kernels against each other on one
CUDA card.

Run from the root of a checkout:

    python3 chip_lattice_ab.py parent=old/rnnt_lattice.cu \\
        change=tsasr_torch/csrc/rnnt_lattice.cu --order parent,change,change,parent

Each NAME=PATH is a version of ``tsasr_torch/csrc/rnnt_lattice.cu`` (its
headers are taken from ``tsasr_torch/csrc``). Every version is built with
the port's ``nvcc`` flags into ``build/lattice_ab/``, all at once, and
loaded through its C entries. On the same inputs (``chip_smoke.py``'s
``LATTICES``, from its seed) each version's resident, alpha slab and beta
slab kernels are timed on the profiler's device time (the median of
three windows) and on CUDA events, the versions in the order given (in turns,
so that a drift of the card shows), and every
result is held against the plain lattice in f64 at ``lattice_rtol``. It
prints the card, one line per version, kernel and shape, then the device
times side by side, and exits 1 if a version errs.
"""

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def build(versions):
    """name -> ctypes library of each version, built in parallel."""
    from tsasr_torch.kernels import _build
    out = ROOT / "build" / "lattice_ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, src in versions.items():
        lib = out / f"lib{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        regs = [ln.split("Used")[1].split(",")[0].strip()
                for ln in log.splitlines() if "registers" in ln]
        print(f"{name}: built, registers per kernel {regs}", flush=True)
        libs[name] = bind(ctypes.CDLL(str(lib)))
    return libs


def bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = {"resident": lib.rnnt_lattice_resident,
           "alpha": lib.rnnt_lattice_alpha_slab,
           "beta": lib.rnnt_lattice_beta_slab}
    fns["resident"].argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
    fns["alpha"].argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
    fns["beta"].argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("versions", nargs="+", metavar="NAME=PATH")
    parser.add_argument("--order", help="comma-separated names, e.g. "
                        "a,b,b,a (default: each version once)")
    args = parser.parse_args()
    if not all("=" in v for v in args.versions):
        parser.error("each version is NAME=PATH")
    versions = dict(v.split("=", 1) for v in args.versions)
    order = args.order.split(",") if args.order else list(versions)
    if set(order) - set(versions):
        parser.error(f"--order names {set(order) - set(versions)}, which "
                     "are not given")

    import torch
    if not torch.cuda.is_available():
        print("chip_lattice_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tsasr_torch.kernels import rnnt_lattice as rl

    libs = build(versions)
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(cs.SEED + 11)
    cases = []
    for kind, b, t, u1 in cs.LATTICES:
        lattice = cs.lattice_case(b, t, u1, gen, device)
        want = rl.rnnt_lattice_reference(*cs.as_f64(lattice))
        cases.append((kind, b, t, u1, lattice, want,
                      cs.lattice_rtol(want[0], t, u1)))

    times, failed = {}, False
    for name in order:
        fns = libs[name]
        for kind, b, t, u1, lattice, want, rtol in cases:
            ptrs = [x.data_ptr() for x in lattice]
            loss = torch.full((b,), float("nan"), device=device)
            dlpb, dlpl = (torch.full_like(lattice[0], float("nan"))
                          for _ in range(2))
            outs = [loss.data_ptr(), dlpb.data_ptr(), dlpl.data_ptr()]
            if kind == "resident":
                calls = {"resident": lambda: fns["resident"](
                    *ptrs, *outs, b, t, u1, stream)}
            else:
                alpha = torch.empty_like(lattice[0])
                logz = torch.empty(b, device=device)
                calls = {"alpha": lambda: fns["alpha"](
                             *ptrs, alpha.data_ptr(), logz.data_ptr(),
                             outs[0], b, t, u1, stream),
                         "beta": lambda: fns["beta"](
                             *ptrs, alpha.data_ptr(), logz.data_ptr(),
                             *outs[1:], b, t, u1, stream)}
            for fn in calls.values():
                if fn() != 0:
                    raise RuntimeError(f"{name}: a {kind} launch failed")
            torch.cuda.synchronize()
            err = cs.lattice_err((loss, dlpb, dlpl), want, rtol)
            failed |= not err <= 1.0
            shape = f"B{b} T{t} U+1 {u1}"
            for kernel, fn in calls.items():
                events = cs.cuda_ms(fn, reps=20, rounds=5)
                # the median of 3 profiler windows: a window can drop
                # events (reads low) or catch a slow spell (reads high)
                ms = statistics.median(
                    sum(cs.device_ms_by_kernel(fn).values())
                    for _ in range(3))
                times.setdefault((kernel, shape), {}).setdefault(
                    name, []).append((ms, events))
                print(f"{name} {kernel} {shape}: device {ms:.4f} ms "
                      f"({ms * 1e3 / t:.3f} us a row), CUDA events "
                      f"{events:.4f} ms, {kind} err/tol against f64 "
                      f"{err:.3g}", flush=True)
    print(f"device ms (CUDA events ms) in the order run ({card}):")
    for (kernel, shape), by_name in times.items():
        print(f"  {kernel} {shape}: " + "; ".join(
            f"{n} " + " / ".join(f"{d:.4f} ({e:.4f})" for d, e in v)
            for n, v in by_name.items()))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
