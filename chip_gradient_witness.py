#!/usr/bin/env python3
"""Explain the worst gradient leaves of ``chip_smoke.py``'s dropout-0 check.

Run from the root of a checkout on one CUDA card:
``python3 chip_gradient_witness.py``. It rebuilds the check's full-width
model and micro-batch and runs it three ways: with every kernel, with
every kernel forced to its plain version (f32), and on the plain versions
in f64. It prints

1. for each of the micro-batch's 18 attention calls, the forward
   kernel's and the plain f32 version's largest error against f64;
2. for the worst leaf of "kernels vs plain f32" and of "plain f32 vs
   f64", when it is a Linear layer's weight: the share of the leaf's
   difference held by one output unit, the frame where that unit's
   output gradient differs most between the two runs, the two gradients
   there, and the unit's pre-activation in both runs. A pre-activation
   within rounding of 0 whose two gradients differ by the factor 100
   is one element that landed on the two sides of leaky_relu's kink
   (slope 0.01): a rounding effect of f32, not a kernel fault.
"""

import contextlib
import statistics
import sys
from pathlib import Path


def capture(brain, module_name):
    """Forward hook on ``module_name``: its output and the output's
    gradient in the next run."""
    got = {}

    def hook(module, inputs, out):
        got["z"] = out.detach()
        out.register_hook(lambda g: got.__setitem__("u", g.detach()))

    return got, brain.model.get_submodule(module_name).register_forward_hook(
        hook)


def main(device="cuda"):
    import torch
    if not torch.cuda.is_available():
        print("chip_gradient_witness: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs
    from tsasr_torch.kernels import relpos_attention as ra
    from tsasr_torch.models import attention as attention_mod
    from tsasr_torch.models.transducer import scratch_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda":
        print(cs.card_line())
    _, batch, _ = cs.training_batches()
    det = cs.make_brain(scratch_config(dropout=0.0), device)
    wide = cs.wide_brain(device)
    runs = {"kernels": (det, contextlib.nullcontext, None),
            "plain f32": (det, cs.plain_kernels, None),
            "f64": (wide, cs.plain_kernels, torch.float64)}

    # 1. the attention calls' inputs, recorded on the plain f32 run
    calls = []

    def record(*args, seed, scale, rate, h0=0):
        calls.append(([x.detach().clone() for x in args], scale))
        return ra.relpos_attention_reference(*args, scale, seed, rate, h0)

    grads = {}
    for name, (brain, ctx, dtype) in runs.items():
        with ctx():
            if name == "plain f32":
                saved, attention_mod.fused_relpos_attention = \
                    attention_mod.fused_relpos_attention, record
            try:
                grads[name] = cs.loss_and_grads(brain, batch, dtype)[1]
            finally:
                if name == "plain f32":
                    attention_mod.fused_relpos_attention = saved
    for n, (args, scale) in enumerate(calls):
        want = ra.relpos_attention_reference(*[x.double() for x in args],
                                             scale)
        kernel = ra.fused_relpos_attention(*args, seed=0, scale=scale,
                                           rate=0.0)
        plain = ra.relpos_attention_reference(*args, scale)
        print(f"attention call {n} (T{args[0].shape[2]}): max abs err "
              f"against f64: forward kernel "
              f"{(kernel.double() - want).abs().max().item():.3g}, plain "
              f"f32 {(plain.double() - want).abs().max().item():.3g}")

    # 2. the worst leaves
    names = [n for n, _ in det.model.named_parameters()]
    for a, b in (("kernels", "plain f32"), ("plain f32", "f64")):
        errs = cs.leaf_errors(grads[a], grads[b])
        leaf = names[errs.index(max(errs))]
        print(f"{a} vs {b}: worst leaf {leaf} {max(errs):.3g} of its max "
              f"|g|, median leaf {statistics.median(errs):.3g}")
        module_name, kind = leaf.rsplit(".", 1)
        module = det.model.get_submodule(module_name)
        if kind != "weight" or not isinstance(module, torch.nn.Linear):
            print("  not a Linear layer's weight: no breakdown")
            continue
        seen = {}
        for name in (a, b):
            brain, ctx, dtype = runs[name]
            got, handle = capture(brain, module_name)
            try:
                with ctx():
                    g = cs.loss_and_grads(brain, batch, dtype)[1]
            finally:
                handle.remove()
            seen[name] = (g[names.index(leaf)].double(), got)
        diff = seen[a][0] - seen[b][0]
        unit = int(diff.abs().amax(1).argmax())
        share = (diff[unit].norm() / diff.norm()).item()
        ua = seen[a][1]["u"][..., unit].double()
        ub = seen[b][1]["u"][..., unit].double()
        flat = int((ua - ub).abs().argmax())
        frame = divmod(flat, ua.shape[1])
        za = seen[a][1]["z"][..., unit][frame].item()
        zb = seen[b][1]["z"][..., unit][frame].item()
        print(f"  output unit {unit} holds {share:.4f} of the difference's "
              f"L2 norm; at (utterance, frame) {frame} its output gradient "
              f"is {ua[frame].item():.6g} ({a}) vs {ub[frame].item():.6g} "
              f"({b}), ratio {ua[frame].item() / ub[frame].item():.4g}; "
              f"pre-activation {za:.6g} ({a}) vs {zb:.6g} ({b})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
