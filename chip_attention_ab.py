#!/usr/bin/env python3
"""Time versions of the bf16 rel-pos attention forward, or with
``--backward`` its backward, against each other on one CUDA card.

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

With ``--backward`` each NAME=PATH is a version of
``tsasr_torch/csrc/relpos_attention_bwd.cu`` (``git show
<commit>:tsasr_torch/csrc/relpos_attention_bwd.cu >
build/attention_ab/parent_bwd.cu``) and its ``relpos_attention_bwd_bf16``
is timed the same way, from the statistics of the port's own bf16
forward, its scratch sized by the version's own C query
(``relpos_attention_bwd_bf16_scratch_floats``, or
``relpos_attention_bwd_dp_part_floats`` where a version has no other),
each gradient held against the plain bf16 backward at
``chip_smoke.BF16_BWD_TOL`` of its max |g|; the yardstick is SDPA's bf16
backward on device time, its forward outside the window. Each line also
gives one more window's device time by kernel (a backward's passes).
"""

import argparse
import ctypes
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = ((8, 101), (8, 208), (8, 408), (6, 208), (3, 408))
RATES = (0.0, 0.1)


# the entries end with h0, the launch's first head (0 here); a version
# whose entries end at the stream leaves that trailing int unread (the
# x86-64 C calling convention), so older sources time alike
FWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_uint, ctypes.c_float,
                                        ctypes.c_void_p] + \
    [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_uint, ctypes.c_float] + \
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int]


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
            if "bf16" in ln or "16_kernel" in ln or "registers" in ln \
                    or "spill" in ln:
                print(f"  {ln.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def kernel_name(key):
    """A profiler key's kernel function name, without its namespace and
    arguments."""
    found = re.search(r"(\w+_kernel)", key)
    return found.group(1) if found else key


def entry(lib, name, argtypes, restype=ctypes.c_int):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def forward_call(lib, case, scale, stream):
    """(call, outputs) of a forward version on ``case``."""
    import torch
    from tsasr_torch.kernels import relpos_attention as ra
    fn = entry(lib, "relpos_attention_fwd_bf16", FWD_ARGTYPES)
    a16, rate, seed_t = case["args"], case["rate"], case["seed"]
    b, h, t, dh = a16[0].shape
    thresh, keep_scale = ra._dropout_args(rate)
    out = torch.full_like(a16[0], float("nan"))
    stats = torch.empty(b, h, t, 2, device=out.device)
    ptrs = [x.data_ptr() for x in a16] + [out.data_ptr(), stats.data_ptr()]
    seed = seed_t.data_ptr() if rate > 0.0 else 0
    return (lambda: fn(*ptrs, thresh, keep_scale, seed, b, h, t, dh, scale,
                       stream, 0)), [out]


def backward_call(lib, case, scale, stream):
    """(call, gradients) of a backward version on ``case``: its scratch
    sized by its own query."""
    import torch
    from tsasr_torch.kernels import relpos_attention as ra
    fn = entry(lib, "relpos_attention_bwd_bf16", BWD_ARGTYPES)
    query = next(q for q in ("relpos_attention_bwd_bf16_scratch_floats",
                             "relpos_attention_bwd_dp_part_floats")
                 if hasattr(lib, q))
    size = entry(lib, query, [ctypes.c_int] * 4, ctypes.c_longlong)
    a16, rate, seed_t = case["args"], case["rate"], case["seed"]
    b, h, t, dh = a16[0].shape
    thresh, keep_scale = ra._dropout_args(rate)
    grads = [torch.full_like(a16[0], float("nan")) for _ in range(4)] + [
        torch.full_like(a16[4], float("nan"))]
    scratch = torch.empty(size(b, h, t, dh), device=a16[0].device)
    delta = torch.empty(b, h, t, device=a16[0].device)
    ptrs = ([x.data_ptr() for x in a16] + [case["stats"].data_ptr(),
                                           case["do"].data_ptr()])
    seed = seed_t.data_ptr() if rate > 0.0 else 0
    outs = [delta.data_ptr()] + [g.data_ptr() for g in grads[:4]] + [
        scratch.data_ptr(), grads[4].data_ptr()]
    return (lambda: fn(*ptrs, seed, thresh, keep_scale, *outs, b, h, t, dh,
                       scale, stream, 0)), grads


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("versions", nargs="+", metavar="NAME=PATH")
    parser.add_argument("--order", help="comma-separated names, e.g. "
                        "a,b,b,a (default: each version once)")
    parser.add_argument("--backward", action="store_true",
                        help="versions of relpos_attention_bwd.cu: time "
                        "their bf16 backward")
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
    what = "backward" if args.backward else "forward"
    tol = cs.BF16_BWD_TOL if args.backward else cs.BF16_FWD_TOL
    of = "|g|" if args.backward else "|o|"
    call = backward_call if args.backward else forward_call
    cases = []
    for b, t in SHAPES:
        a16 = cs.bf16_case(t, "key padding", gen, device, b)
        qu, qv, k, v, p, kp, am = a16
        bias = (ra.rel_shift(torch.einsum("bhtd,hsd->bhts", qv, p), t)
                * scale + am + kp[:, None, None, :]).to(torch.bfloat16)
        do = torch.randn(b, cs.H, t, cs.DH, generator=gen).to(device).to(
            torch.bfloat16)
        if args.backward:
            sdpa = cs.device_ms_median(cs.sdpa_backward(qu, k, v, bias, scale,
                                                        do))
            bound_ms, _ = cs.attention_bf16_bwd_bound(b, cs.H, t, cs.DH)
            _, stats, _ = ra._launch_fwd(*a16, seed_t, scale, 0.0, True)
        else:
            sdpa = cs.device_ms_median(lambda: F.scaled_dot_product_attention(
                qu, k, v, attn_mask=bias, scale=scale))
            bound_ms, _ = cs.attention_bf16_bound(b, cs.H, t, cs.DH)
            stats = None
        for rate in RATES:
            if args.backward:
                want = ra.relpos_attention_bwd_bf16(*a16, do, scale, seed_t,
                                                    rate)
            else:
                want = [ra.relpos_attention_fwd_bf16(*a16, scale, seed_t,
                                                     rate)]
            cases.append(dict(
                label=f"B{b} H{cs.H} T{t} Dh{cs.DH} dropout {rate}",
                args=a16, rate=rate, seed=seed_t, do=do, stats=stats,
                want=want, sdpa=sdpa, bound_ms=bound_ms))

    times, failed = {}, False
    for name in order:
        for case in cases:
            run, got = call(libs[name], case, scale, stream)
            if run() != 0:
                raise RuntimeError(f"{name}: the launch at {case['label']} "
                                   "failed")
            torch.cuda.synchronize()
            err = max(((g.double() - w.double()).abs().max()
                       / w.double().abs().max().clamp(min=1e-30)).item()
                      for g, w in zip(got, case["want"]))
            if not err <= tol:
                failed = True
            events = cs.cuda_ms(run, reps=30, rounds=5)
            # the median of 3 profiler windows: a window can drop events
            # (reads low), see none, or catch a slow spell (reads high)
            ms = cs.device_ms_median(run)
            times.setdefault(case["label"], {}).setdefault(name, []).append(
                ms)
            # one more window, by kernel: the passes of a backward
            passes = ", ".join(
                f"{kernel_name(k)} {v:.4f}"
                for k, v in sorted(cs.device_ms_seen(run).items()))
            print(f"{name} {what} {case['label']}: device {ms:.4f} ms "
                  f"({passes}), CUDA events {events:.4f} ms, err {err:.3g} "
                  f"of max {of} (tol {tol:.3g}); SDPA bf16 {what} device "
                  f"{case['sdpa']:.4f} ms, bound {case['bound_ms']:.5f} ms",
                  flush=True)
    first = order[0]
    print(f"{what} device ms in the order run, each version's mean over its "
          f"turns and the first version's mean over it ({card}):")
    for case in cases:
        by_name = times[case["label"]]
        base = statistics.mean(by_name[first])
        print(f"  {case['label']}: " + "; ".join(
            f"{n} " + " / ".join(f"{d:.4f}" for d in v)
            + f" ({base / statistics.mean(v):.2f}x)"
            for n, v in by_name.items()) + f"; SDPA bf16 {case['sdpa']:.4f}")
    if failed:
        print("a version erred past the tolerance", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
