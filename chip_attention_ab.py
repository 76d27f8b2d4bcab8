#!/usr/bin/env python3
"""Time versions of the bf16 rel-pos attention forward against each other
on one CUDA card.

Run from the root of a checkout:

    git show <commit>:tsasr_torch/csrc/relpos_attention_fwd.cu \\
        > build/attention_ab/parent.cu
    python3 chip_attention_ab.py parent=build/attention_ab/parent.cu \\
        change=tsasr_torch/csrc/relpos_attention_fwd.cu \\
        --order parent,change,change,parent

Each NAME=PATH is a version of ``tsasr_torch/csrc/relpos_attention_fwd.cu``
(its headers are taken from ``tsasr_torch/csrc``): the parent's, the
change, or an edited copy under ``build/`` (another shape of the resident
kernel, for a sweep). Every version is built with the port's ``nvcc`` flags into
``build/attention_ab/``, all at once, and its C entry
``relpos_attention_fwd_bf16`` is called directly. On the same inputs
(``chip_smoke.py``'s ``bf16_case``, key padding, from its seed) at B8 H4
T101 / 208 / 408, B6 T208 and B3 T408 (Dh 64), dropout 0 and 0.1, each
version's forward (statistics written, as in training) is timed on the
profiler's device time (the median of three windows that saw it) and on
CUDA events, the versions in the order given (in turns, so that a drift
of the card shows), and held against the plain bf16 version at
``chip_smoke.BF16_FWD_TOL`` of its max |o|. SDPA in bf16, given the
pre-shifted bias, is timed once a shape as the yardstick. It prints the
card, one line per version and case, then the device times side by side
with each version's ratio to the first, and exits 1 if a version errs.
"""

import argparse
import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = ((8, 101), (8, 208), (8, 408), (6, 208), (3, 408))
RATES = (0.0, 0.1)


def build(versions):
    """name -> the ctypes library of each version, built in parallel."""
    from tsasr_torch.kernels import _build
    out = ROOT / "build" / "attention_ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, src in versions.items():
        lib = out / f"lib{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(lib), str(src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        print(f"{name}: built", flush=True)
        for ln in log.splitlines():
            if "fwd_bf16" in ln or "registers" in ln or "spill" in ln:
                print(f"  {ln.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        fn = libs[name].relpos_attention_fwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_uint, ctypes.c_float,
                                               ctypes.c_void_p] + \
            [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return libs


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("versions", nargs="+", metavar="NAME=PATH")
    parser.add_argument("--order", help="comma-separated names, e.g. "
                        "a,b,b,a (default: each version once)")
    args = parser.parse_args()
    if not all("=" in v for v in args.versions):
        parser.error("each version is NAME=PATH")
    versions = {name: Path(path) for name, path in
                (v.split("=", 1) for v in args.versions)}
    order = args.order.split(",") if args.order else list(versions)
    if set(order) - set(versions):
        parser.error(f"--order names {set(order) - set(versions)}, which "
                     "are not given")

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tsasr_torch.kernels import relpos_attention as ra

    libs = build(versions)
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / math.sqrt(cs.H * cs.DH)
    gen = torch.Generator().manual_seed(cs.SEED + 24)
    seed_t = torch.tensor([2024], device=device)
    cases = []
    for b, t in SHAPES:
        a16 = cs.bf16_case(t, "key padding", gen, device, b)
        qu, qv, k, v, p, kp, am = a16
        bias = (ra.rel_shift(torch.einsum("bhtd,hsd->bhts", qv, p), t)
                * scale + am + kp[:, None, None, :]).to(torch.bfloat16)
        sdpa = cs.device_ms_median(lambda: F.scaled_dot_product_attention(
            qu, k, v, attn_mask=bias, scale=scale))
        bound_ms, _ = cs.attention_bf16_bound(b, cs.H, t, cs.DH)
        for rate in RATES:
            want = ra.relpos_attention_fwd_bf16(*a16, scale, seed_t, rate)
            cases.append((f"B{b} H{cs.H} T{t} Dh{cs.DH} dropout {rate}",
                          a16, rate, want, sdpa, bound_ms))

    times, failed = {}, False
    for name in order:
        fn = libs[name].relpos_attention_fwd_bf16
        for label, a16, rate, want, sdpa, bound_ms in cases:
            b, h, t, dh = a16[0].shape
            thresh, keep_scale = ra._dropout_args(rate)
            out = torch.full_like(a16[0], float("nan"))
            stats = torch.empty(b, h, t, 2, device=device)
            ptrs = [x.data_ptr() for x in a16] + [out.data_ptr(),
                                                  stats.data_ptr()]
            seed = seed_t.data_ptr() if rate > 0.0 else 0

            def call():
                return fn(*ptrs, thresh, keep_scale, seed, b, h, t, dh,
                          scale, stream)

            if call() != 0:
                raise RuntimeError(f"{name}: the launch at {label} failed")
            torch.cuda.synchronize()
            err = ((out.double() - want.double()).abs().max()
                   / want.double().abs().max()).item()
            if not err <= cs.BF16_FWD_TOL:
                failed = True
            events = cs.cuda_ms(call, reps=30, rounds=5)
            # the median of 3 profiler windows: a window can drop events
            # (reads low), see none, or catch a slow spell (reads high)
            ms = cs.device_ms_median(call)
            times.setdefault(label, {}).setdefault(name, []).append(ms)
            print(f"{name} {label}: device {ms:.4f} ms, CUDA events "
                  f"{events:.4f} ms, err {err:.3g} of max |o| (tol "
                  f"{cs.BF16_FWD_TOL:.3g}); SDPA bf16 device {sdpa:.4f} ms, "
                  f"bound {bound_ms:.5f} ms", flush=True)
    first = order[0]
    print(f"device ms in the order run, each version's mean over its turns "
          f"and the first version's mean over it ({card}):")
    for label, by_name in times.items():
        base = statistics.mean(by_name[first])
        sdpa = next(c[4] for c in cases if c[0] == label)
        print(f"  {label}: " + "; ".join(
            f"{n} " + " / ".join(f"{d:.4f}" for d in v)
            + f" ({base / statistics.mean(v):.2f}x)"
            for n, v in by_name.items()) + f"; SDPA bf16 {sdpa:.4f}")
    if failed:
        print("a version erred past the tolerance", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
