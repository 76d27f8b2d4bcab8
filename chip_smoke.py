#!/usr/bin/env python3
"""Drive tsasr_torch on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it exits non-zero without a card, outside a
checkout, or when any phase fails. Phases:

1. card and build: the card's name and power limit, then ``nvcc`` builds
   every CUDA source of the port from ``tsasr_torch/csrc``, all at once;
   the attention forward and the backward's dq, dkv and dp passes must
   hold TF32 tensor-core instructions (``cuobjdump -sass``), their bf16
   variants' passes bf16 ones;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it, with its time, the
   plain version's time, one PyTorch library call's time where one
   computes the same function, and the card's bound: the attention
   forward (at the serving and the training shapes, dropout 0 and 0.1,
   Philox masks bit-identical), the attention backward, and the RNN-T
   lattice kernels (resident and slab, also against the plain version
   in f64, the beta slab kernel also alone, each variant's repeats and
   the two variants at one shape bit for bit); device times
   (``torch.profiler``) beside the CUDA-event times, for the lattice
   kernels also in us per row;
3. the serving path at the scratch recipe's full width (random weights
   from a seed): ``TSASRTranscriber(device="cuda")`` answers 3 requests
   (8 mixtures of 4 s, 8 s and 12 s, 5 s enrollments); every request
   must launch the attention kernel once per Conformer layer (18), and
   the encoder output must match the same model with attention forced
   to the plain version; the same requests again at the recipe's TEST
   beam (``beam_size=15``, the batched beam), the card's search held
   against the same searcher on the CPU over the card's encoder output
   (``beam_agreement``), once more with a seeded RNN-LM at weight 0.3,
   and the exact beam on one 4 s utterance;
4. one training step of the scratch recipe at full width through
   ``TSASRBrain.fit_batch``: 8 micro-batches (6 x 8 s and 3 x 16 s in
   turn, 5 s enrollments, dropout 0.1 with 8-bit masks, accumulation 4,
   so 2 optimizer steps), with every kernel's launches counted per
   micro-batch; at dropout 0 one micro-batch's loss and gradients
   against the same model with every kernel forced to its plain
   version (loosely only where a leaky_relu kink flip can reach, as the
   f64 run places it, the joint's inside the fused loss included), and
   a profile of a 6 x 8 s and of a 3 x 16 s micro-batch;
   then one VALID batch through ``evaluate_batch``;
5. the scratch recipe's experiment at full width through
   ``run_experiment`` (``tsasr_torch/hparams/LibriSpeechMix/
   conformer-t_scratch.yaml``, the CUDA attention kernels on) on a
   synthetic corpus whose waveforms carry their transcripts as a tone
   code (mixtures up to ~6 s): prepare, the tokenizer, dynamic batching
   through the loader, 2 optimizer steps (8 micro-batches at
   accumulation 4), VALID with greedy search and a checkpoint, TEST at
   the yaml's batched beam 15; every TRAIN micro-batch and every VALID
   and TEST batch must launch the kernels its shapes imply; a second run
   with 2 epochs must recover the checkpoint bit for bit and go on from
   its optimizer step, its TEST one utterance a batch with an n-gram LM
   of the train transcripts (``tsasr_torch.tools.train_ngram_lm``), on
   the split's first RESUMED_TEST_MIXTURES mixtures; the run's folder
   through ``TSASRTranscriber.from_experiment`` and ``transcribe_file``
   must give TEST's transcripts (EXPERIMENT_FILES of its files); then
   each kernel is
   held against its plain version on the inputs the two runs gave it,
   one call per shape (the attention forward and, at TRAIN, backward
   with the path's dropout; the lattice on the route the path took; T
   128 must be among them); the host-clock ms
   of each micro-batch through the loader, the wait on the loader and
   VALID's and TEST's wall times are printed;
6. the ``none`` and ``pretrained`` recipes (``phase_variants``):
   speed perturbation at each speed and SpecAugment (warp, frequency and
   time masks) on a 6 x 8 s batch on the card against the CPU with the
   same draws; the frozen WavLM x-vector model at its published widths
   (seeded) on 6 x 5 s enrollments, card against CPU, then written as an
   HF checkpoint directory and loaded by ``FrozenSpeakerEncoder`` bit for
   bit; then each variant through ``run_experiment`` with its yaml copy,
   ``--fused_attention True --augment True``, on the same corpus, 2
   optimizer steps, VALID greedy, TEST at beam 1; with deterministic
   algorithms on, a ``pretrained`` run's folder copied at its
   intra-epoch checkpoint resumes to the uninterrupted run's state bit
   for bit; every batch launches what its
   shapes imply (12 attention layers), and each kernel is held against
   its plain version on the runs' tensors; ms per micro-batch through
   the loader, the WavLM's share, VALID and TEST wall times and the
   augmentation's device time are printed;
7. streaming transcription (``phase_streaming``) of the scratch model
   made causal (``causal_encoder``, ``frontend_causal``), seeded: first
   the attention kernels on the lookahead mask and on lookahead + an
   ``att_context_size`` band of 64 against their plain versions (T 101
   and 208, forward and backward); then one 12 s mixture with a 5 s
   enrollment: the offline encode (18 attention launches) against the
   plain path, ``encode_stream`` in chunks of 100 and 32 feature frames
   against it, the same with ``att_context_size`` 64, the ``kv_cache``
   streamer's tokens against offline greedy on unnormalized features and
   against the same streamer on the CPU, the ``reencode`` streamer's
   final transcript against its last partial, ms per chunk (host clock
   and, under the profiler, device time and launches) and the real-time
   factor at 1 s and 0.32 s chunks, and a stream past its KV capacity,
   which must raise; then the scratch yaml through ``run_experiment``
   with ``--causal_encoder True --frontend_padding causal`` (2 optimizer
   steps, VALID greedy, TEST at beam 1, launches per batch as the
   shapes imply), ``transcribe --streaming --enroll`` on 3 of its TEST
   files against the same stream from ``from_experiment``, and each
   kernel against its plain version on the run's own tensors;
8. bf16 compute (``phase_bf16``, the recipe's ``--precision bf16``):
   the bf16 variants of both attention kernels must hold bf16
   tensor-core instructions (HMMA ... BF16); each against its plain bf16
   version (forward within 2^-7 of max |o|, backward within 2^-6 of max
   |g|) and no further from f64 than 1.5 times the plain version, at T
   101, 208 and 408 on key-padding, causal and causal + band-64 masks,
   dropout 0.1, and the forward's long route at its first T; their
   times beside the f32 kernels' (in turns), the plain versions', SDPA's
   in bf16 and the bound at the bf16 peak (in a fresh process);
   ``fit_batch`` at full width in f32 and bf16 in turns on the same
   weights and batches (host ms, device time and launches under the
   profiler, ``max_memory_allocated``); the full-width model in bf16
   against f32 at dropout 0 (loss within 2e-2, gradient cosine 0.99 or
   more); the scratch yaml through ``run_experiment`` with ``--precision
   bf16 --fused_attention True`` (2 optimizer steps, VALID greedy, TEST
   at beam 15; every batch launches the bf16 kernels as its shapes imply
   and no f32 attention kernel), then the bf16 kernels on the run's own
   tensors;
9. the yamls' model switches (``phase_switches``) at the scratch
   recipe's full width: for each of the injection modes prod, sum and
   cross_attention, ``injection_after`` [-1, 0, 6], the ECAPA speaker
   branch, the concat joint, a band of 64 and a covering band, one
   dropout-0 6 x 8 s micro-batch with the kernels against every kernel
   forced to its plain version (loss within 1e-5, gradients by the
   training phase's rule, the kink set placed in f64 for each), its host
   and device ms, launches and own peak memory; a covering band against
   the full loss, band 64 on 3 x 16 s no smaller than it and the banded
   loss's launches and device time; remat full and dots bit for bit
   against the step without remat (dropout 0.1, deterministic
   algorithms), and remat full's own peak memory on 3 x 16 s below the
   step's without it; the pretrained recipe with cross_attention (the
   frozen WavLM's frames, card against CPU, and one fit_batch); the
   scratch yaml through ``run_experiment`` with ``--speaker_encoder_type
   ecapa --remat True`` and with ``--injection_mode cross_attention
   --joint_band_width 64`` (2 optimizer steps, VALID greedy, TEST at beam
   2, every batch launching what its shapes imply, then
   ``from_experiment`` on the TEST files); a causal cross_attention model
   streaming with kv_cache to the offline greedy tokens; then each kernel
   against its plain version on the phase's own tensors;
10. the recipe's run flags and last switches (``phase_run_flags``) at
   the scratch recipe's full width on the same corpus: (a) the scratch
   yaml through ``tsasr_torch.train_librispeechmix_scratch`` with
   ``--profile --profile_dir build/run_flags_profile``, ``prompt_test``
   (prepend), 5 optimizer steps at accumulation 1, VALID greedy, TEST at
   beam 1 in two passes: JAX's default schedule's trace (the last TRAIN
   micro-batch and the first VALID batch) must name ``fit_batch``,
   ``evaluate_batch`` and the CUDA attention and lattice kernels,
   ``report_time`` and ``report_memory`` are printed, both WER files
   written and no stripped hypothesis keeps its enrollment's words;
   (b) a run with ``model_path`` set to (a)'s checkpoint: its model
   before the first step equals the source bit for bit, then one step;
   (c) ``encode_with_attn`` on 6 x 8 s within the encoder tolerance of
   ``encode`` with the kernel, every row over unmasked keys summing to
   1; (d) the causal model in bf16 streaming a 12 s mixture in 1 s
   chunks, ``encode_stream`` against the offline bf16 encode, each
   replayed ``kv_cache`` decision within a fixed logit gap of the
   offline bf16 greedy's argmax (the tokens against it, and the plain
   path in the stream's chunking with no cache against the whole
   sequence, printed), ``reencode`` on the bf16 kernel, ms, device ms
   and launches a chunk beside the f32 stream's in turns; then each
   kernel against its plain version on the phase's own tensors, (d)'s
   bf16 attention calls at the bf16 tolerance;
11. data parallelism (``phase_ddp``): the scratch yaml at full width
   on the same corpus (VALID and TEST cut to 12 and 6 mixtures), 2
   optimizer steps of 2 micro-batches at dropout 0 under deterministic
   algorithms, VALID and TEST greedy: (a) in place; (b) through
   ``python -m tsasr_torch.parallel.launch --nproc_per_node 1`` on
   ``cuda`` over NCCL: its losses, launches and WER file (a)'s, its first
   step's gradient within 1e-6 of each leaf's max |g|; (c) two ranks
   sharing ``cuda:0`` over gloo (``--data_parallel_count 2``): each
   loss within 1e-5 relative of (a)'s, the first step's gradient by the
   training phase's rule (the kink set placed by plain f64 runs of its
   micro-batches, the f32 noise floor below the tolerance and rank 0's
   unreduced gradient above it), a TEST WER file naming each utterance
   once from disjoint shards; (c') two ranks ``--test_only``
   reproducing it; every batch launches what its shapes imply and each
   rank holds its kernels against their plain versions (the ranks are
   ``chip_smoke.py --ddp_worker DIR ARGS``); ms per micro-batch, the
   all-reduce's ms (CUDA events) and bytes, the device-busy share of a
   profiled micro-batch and audio-s/s of two ranks against one;
12. a small model on the card against the same model on the CPU:
   serving encoder output (the CPU side twice, each hash logged with the
   host CPU's model and torch's thread count), and 2 optimizer steps of
   training at dropout 0.

The line before the last is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

import collections
import concurrent.futures
import contextlib
import hashlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
B, H, DH = 8, 4, 64
# encoder frames of a 4 s, 5 s, 8 s and 12 s input (serving path), and
# a 60 s one beyond the JAX kernel's 128-frame gate
ATTN_T = (101, 126, 201, 301, 1501)
# (B, T) of the training micro-batches, 6 x 8 s and 3 x 16 s
FWD_TRAIN_SHAPES = ((6, 208), (3, 408))
# encoder frames of the training batches: 4 s at pad_feats_to 32 (104),
# the 128-frame JAX gate, 8 s (208) and 16 s (408)
BWD_T = (101, 128, 208, 408)
# the backward at the training path's dropout rate, at the 8 s and 16 s
# training shapes
BWD_DROPOUT_T = (208, 408)
ATTN_ATOL = 1e-4     # f32 on both sides, sums in another order
ENC_ATOL = 2e-4      # the same, compounded over 18 layers
SMALL_ATOL = 1e-4
REQUEST_SECONDS = (4, 8, 12)
# the recipe's TEST beam, and the card's beam against the same search on
# the CPU over the card's encoder output (beam_agreement): the best
# tokens must be identical where the card's top two distinct hypotheses
# are more than BEAM_MARGIN apart in normalized score, and the best
# normalized scores within BEAM_SCORE_ATOL (f32 on both sides: sums of a
# few hundred log-probs over the length)
BEAM_SIZE = 15
BEAM_MARGIN = 1e-4
BEAM_SCORE_ATOL = 1e-4
LM_WEIGHT = 0.3
ENROLL_SECONDS = 5
SAMPLE_RATE = 16000
LAYERS_PER_REQUEST = 18
# (name, B, T, U+1): bench.py's step, the 8 s and 16 s training batches,
# reports/rnnt_slab_tpu_r5.json's long lattice, and a ~55 s utterance
LATTICES = (("resident", 6, 208, 129), ("resident", 96, 104, 61),
            ("slab", 3, 408, 241), ("slab", 8, 832, 298),
            ("slab", 1, 1375, 801))
# training micro-batches: (utterances, seconds); 48 s of audio each,
# under the recipe's train_max_batch_length of 50 s
TRAIN_BATCHES = ((6, 8), (3, 16))
MICRO_BATCHES = 8
CHARS_PER_SECOND = 15
# per leaf, of its max |g|: the dropout-0 micro-batch with kernels
# against the same model on the plain versions, between the f32 noise
# floor (the plain model in f32 against itself in f64) and a planted
# fault (dp not summed over the batch), both read in every run. A
# pre-activation that f32 rounds to the other side of leaky_relu's kink
# moves its gradient 100-fold (chip_gradient_witness.py shows one): the
# elements such a flip can move are held at GRAD_ATOL_REL, every other
# one at GRAD_TIGHT_REL (check_gradients).
GRAD_ATOL_REL = 1e-2
# Held tight, on an H100 (PERF.md): the worst element read 9.5e-4
# (kernels vs plain f32) and 9.9e-4 (plain f32 vs f64), each one a kink
# flip can move by less than half this tolerance; the worst leaf that
# is no kink site's own weight, 5.9e-4 (encoder.layers.0.mha.pos_proj.
# weight); the planted fault, 1.03
GRAD_TIGHT_REL = 2e-3
# |z| in f64 within which f32 may put a pre-activation on the kink's
# other side: above the f32 error of every pre-activation (at most
# 5.7e-5, at the frontend's LayerNorms, on the same runs; logged in every
# run, and a flip outside fails the check). The elements held loosely
# (kink_bounds) are at most this share of all.
KINK_Z = 3e-4
KINK_LOOSE_SHARE = 1e-2
# The small model's first-step gradients on the card may be this many
# times as far from f64 as the CPU's f32 ones are (worst leaf against
# worst leaf), and at most this share of its elements is held loosely
# (phase_small)
SMALL_NOISE_GATE = 4
SMALL_LOOSE_SHARE = 1e-2
# H100 SXM peaks (NVIDIA data sheet), used for the bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# f32-accurate products on the tensor cores: 3xTF32 runs three TF32
# products (495 TFLOP/s dense) for each f32 one
PEAK_TF32X3_FLOP_PER_S = 495e12 / 3
# the H100's dense bf16 tensor-core peak (NVIDIA's data sheet, SXM, 700 W)
PEAK_BF16_FLOP_PER_S = 989e12
PIECES = ["<unk>", "▁"] + list("abcdefghijklmnopqrstuvwxyz'")
HPARAMS = {"sample_rate": 16000, "n_fft": 512, "n_mels": 80,
           "win_length": 32, "augment": False, "blank_index": 0,
           "pad_feats_to": 32, "fused_joint_loss": True,
           "fused_loss_chunk": 8, "valid_search_freq": 1,
           "grad_accumulation_factor": 4, "max_grad_norm": 5.0, "seed": 0}


def log(msg):
    print(msg, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=30, rounds=5):
    """Median over rounds of the mean time of ``reps`` back-to-back calls
    (CUDA events; inputs stay in L2 as on the serving path)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(n_bytes, flops, flop_rate=PEAK_F32_FLOP_PER_S):
    """Least time (ms) and what bounds it: bytes at the memory rate or
    operations at ``flop_rate`` (by default the f32 rate outside the
    tensor cores, where the lattice kernels compute; the attention
    kernels pass the 3xTF32 rate)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(b, h, t, dh):
    """Forward: each input read once, the output written once; the three
    (T x T x Dh) products plus ~6 ops per score. The kernel runs the
    products on the tensor cores in 3xTF32, so the least time for
    f32-accurate products is at the 3xTF32 rate."""
    n_bytes = 4 * (5 * b * h * t * dh + h * (2 * t - 1) * dh + b * t + t * t)
    return bound(n_bytes, 6 * b * h * t * t * dh + 6 * b * h * t * t,
                 PEAK_TF32X3_FLOP_PER_S)


def attention_bwd_bound(b, h, t, dh):
    """Backward: read q_u, q_v, k, v, out, do, p, the row statistics and
    the masks,
    write dq_u, dq_v, dk, dv and dp; the scores' two products, do.v, and
    the four gradient products (2 T^2 Dh each), ~10 ops per score. The
    kernel runs every product on the tensor cores in 3xTF32, so the
    least time for f32-accurate products is at the 3xTF32 rate."""
    n_bytes = 4 * (10 * b * h * t * dh + 2 * h * (2 * t - 1) * dh
                   + 2 * b * h * t + b * t + t * t)
    return bound(n_bytes, 16 * b * h * t * t * dh + 10 * b * h * t * t,
                 PEAK_TF32X3_FLOP_PER_S)


def lattice_bound(kind, valid_cells, all_cells):
    """Bytes: read both lattices over the cells the lengths cover, write
    both gradients everywhere; the slab alpha kernel writes alpha (4 B a
    cell) that the beta kernel reads back. ~30 f32 ops per cell and pass
    (scans, logaddexp, exp). The T-long serial chain is not counted."""
    if kind == "resident":
        return bound(8 * valid_cells + 8 * all_cells, 60 * valid_cells)
    if kind == "alpha":
        return bound(12 * valid_cells, 30 * valid_cells)
    return bound(12 * valid_cells + 8 * all_cells, 30 * valid_cells)


def tensor_core_check(name, passes, kind="TF32"):
    """Count the tensor-core instructions of type ``kind`` (HMMA ...
    TF32, or BF16) of each kernel function of the built
    ``csrc/<name>.cu`` in its SASS; fail if one of ``passes`` has
    none."""
    from tsasr_torch.kernels import _build
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line and kind in line:
            counts[fn] += 1
    for pas in passes:
        found = {f: n for f, n in counts.items() if pas in f}
        log(f"  {name} {pas}: HMMA {kind} instructions per instance "
            f"{sorted(found.values())}")
        if not found or min(found.values()) == 0:
            raise RuntimeError(f"{pas} runs no {kind} tensor-core "
                               "instruction")


def attention_case(t, band, gen, device, b=B):
    import torch
    qu, qv, k, v = (torch.randn(b, H, t, DH, generator=gen)
                    for _ in range(4))
    p = torch.randn(H, 2 * t - 1, DH, generator=gen)
    lens = torch.randint(max(1, t // 2), t + 1, (b,), generator=gen)
    lens[0] = t
    kp = torch.where(torch.arange(t)[None] < lens[:, None], 0.0, -1e9)
    am = torch.zeros(t, t)
    if band:
        far = (torch.arange(t)[:, None] - torch.arange(t)[None]).abs() > 16
        am = torch.where(far, -1e9, 0.0)
    return [x.to(device) for x in (qu, qv, k, v, p, kp, am)]


def phase_attention_fwd(device):
    import torch
    import torch.nn.functional as F
    from tsasr_torch.kernels import relpos_attention as ra

    scale = 1.0 / math.sqrt(H * DH)
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    shapes = [(B, t, band) for t in ATTN_T for band in (False, True)]
    shapes += [(b, t, False) for b, t in FWD_TRAIN_SHAPES]
    for b, t, band in shapes:
        args = attention_case(t, band, gen, device, b)
        got = ra.fused_relpos_attention(*args, seed=0, scale=scale, rate=0.0)
        torch.cuda.synchronize()
        want = ra.relpos_attention_reference(*args, scale)
        err = (got - want).abs().max().item()
        name = (f"kernel relpos_attention_fwd B{b} H{H} T{t} Dh{DH} "
                f"{'banded mask' if band else 'key padding'}")
        if not (err <= ATTN_ATOL and torch.isfinite(got).all()):
            raise RuntimeError(f"{name}: max abs err {err} > {ATTN_ATOL}")
        if band:
            log(f"{name}: max_abs_err {err:.3g} (atol {ATTN_ATOL})")
            continue
        qu, qv, k, v, p, kp, am = args
        # yardstick: SDPA given the pre-shifted positional bias plus
        # the masks; computing that bias is outside its time
        bias = (ra.rel_shift(torch.einsum("bhtd,hsd->bhts", qv, p), t)
                * scale + am + kp[:, None, None, :])

        def kernel():
            ra.fused_relpos_attention(*args, seed=0, scale=scale, rate=0.0)

        def plain():
            ra.relpos_attention_reference(*args, scale)

        def sdpa():
            F.scaled_dot_product_attention(qu, k, v, attn_mask=bias,
                                           scale=scale)

        ms, plain_ms, lib_ms = (cuda_ms(fn) for fn in (kernel, plain, sdpa))
        # the same on the card's clock: at these sizes the host's launches
        # can outlast the device work
        dev = [sum(device_ms_by_kernel(fn).values()) or None
               for fn in (kernel, plain, sdpa)]
        bound_ms, bound_by = attention_bound(b, H, t, DH)
        rows.append(dict(B=b, T=t, err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, device_ms=dev[0],
                         plain_device_ms=dev[1], library_device_ms=dev[2],
                         bound_ms=bound_ms, bound_by=bound_by))
        dev_line = ("device time (profiler): kernel {:.4f} ms, plain {:.4f} "
                    "ms, SDPA {:.4f} ms".format(*dev) if all(dev) else
                    "device time: the profiler saw none (not measured)")
        log(f"{name}: max_abs_err {err:.3g} (atol {ATTN_ATOL}: f32 on both "
            f"sides, sums in another order); CUDA "
            f"events: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
            f"{lib_ms:.4f} ms (excluding the bias computation); {dev_line}; "
            f"bound {bound_ms:.4f} ms by {bound_by} (3xTF32)")

    # dropout 0.1 at the 8 s training shape: the same Philox mask on both
    # sides, and the kernels' mask bit-identical to the plain one
    t, rate = 208, 0.1
    args = attention_case(t, False, gen, device)
    seed = torch.tensor([12345], device=device)
    got = ra.fused_relpos_attention(*args, seed=seed, scale=scale, rate=rate)
    want = ra.relpos_attention_reference(*args, scale, seed, rate)
    err = (got - want).abs().max().item()
    masks_equal = torch.equal(ra.dropout_mask_cuda(seed, B, H, t, rate,
                                                   device),
                              ra.philox_keep_mask(seed, B, H, t, rate,
                                                  device))
    keep = ra.philox_keep_mask(seed, B, H, t, rate, device).float().mean()
    ms = cuda_ms(lambda: ra.fused_relpos_attention(
        *args, seed=seed, scale=scale, rate=rate))
    log(f"kernel relpos_attention_fwd B{B} H{H} T{t} Dh{DH} dropout {rate}: "
        f"max_abs_err {err:.3g} (atol {ATTN_ATOL}), masks bit-identical "
        f"{masks_equal}, keep fraction {keep.item():.5f}; kernel {ms:.4f} ms")
    if not (err <= ATTN_ATOL and masks_equal):
        raise RuntimeError("relpos_attention_fwd with dropout disagrees with "
                           "its plain version")
    return rows


def attention_grad_errors(args, do, seed, scale, rate):
    """The backward kernels' five gradients against autograd through the
    plain version: (max abs err, max err of each gradient's max |g|
    clamped at 1, and a line with the kernels' and the plain f32
    version's errors against the plain version in f64). Raises above
    ATTN_ATOL."""
    import torch
    from tsasr_torch.kernels import relpos_attention as ra
    grads = {}
    for name, fn, dtype in (
            ("kernel", ra.fused_relpos_attention, torch.float32),
            ("plain", ra.relpos_attention_reference, torch.float32),
            ("f64", ra.relpos_attention_reference, torch.float64)):
        leaves = [x.to(dtype).requires_grad_(i < 5)
                  for i, x in enumerate(args)]
        out = fn(*leaves, seed=seed, scale=scale, rate=rate)
        grads[name] = torch.autograd.grad(out, leaves[:5], do.to(dtype))
    pairs = list(zip(grads["kernel"], grads["plain"]))
    abs_err = max((a - b).abs().max().item() for a, b in pairs)
    rel_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1.0))
                  .item() for a, b in pairs)
    if not rel_err <= ATTN_ATOL:
        raise RuntimeError(f"relpos_attention_bwd {tuple(args[0].shape)} "
                           f"rate {rate}: err {rel_err} of max |g| > "
                           f"{ATTN_ATOL}")
    wide = (f"against f64, of each gradient's max |g|: kernels "
            f"{max(leaf_errors(grads['kernel'], grads['f64'])):.3g}, "
            f"plain f32 "
            f"{max(leaf_errors(grads['plain'], grads['f64'])):.3g}")
    return abs_err, rel_err, wide


def phase_attention_bwd(device):
    import torch
    import torch.nn.functional as F
    from tsasr_torch.kernels import relpos_attention as ra

    scale = 1.0 / math.sqrt(H * DH)
    gen = torch.Generator().manual_seed(SEED + 7)
    rows = []
    for t in BWD_T:
        args = attention_case(t, False, gen, device)
        do = torch.randn(B, H, t, DH, generator=gen).to(device)
        err, rel_err, wide = attention_grad_errors(args, do, 0, scale,
                                                   0.0)

        # kernel: the backward launch alone, from the forward's out and
        # row statistics
        out, stats, _ = ra._launch_fwd(*args, 0, scale, 0.0, want_stats=True)
        ms = cuda_ms(lambda: ra._launch_bwd(*args, out, stats, do, None,
                                            scale, 0.0))
        leaves = [x.clone().requires_grad_(i < 5) for i, x in enumerate(args)]
        plain_out = ra.relpos_attention_reference(*leaves, scale)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            plain_out, leaves[:5], do, retain_graph=True), reps=10)
        # yardstick: SDPA forward + backward given the pre-shifted bias,
        # minus its forward
        qu, qv, k, v, p, kp, am = args
        bias = (ra.rel_shift(torch.einsum("bhtd,hsd->bhts", qv, p), t)
                * scale + am + kp[:, None, None, :])
        sq, sk, sv = (x.clone().requires_grad_() for x in (qu, k, v))

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=bias,
                                               scale=scale)
            torch.autograd.grad(o, (sq, sk, sv), do)

        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=bias, scale=scale))
        lib_ms = cuda_ms(sdpa_fwd_bwd, reps=10) - fwd_ms

        # the same three on the card's clock: the host's launch overhead
        # can outlast the device work of autograd and SDPA at these sizes
        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(sq, sk, sv, attn_mask=bias,
                                               scale=scale)

        passes = device_ms_by_kernel(lambda: ra._launch_bwd(
            *args, out, stats, do, None, scale, 0.0))
        dev = {"plain": device_ms_by_kernel(lambda: torch.autograd.grad(
                   plain_out, leaves[:5], do, retain_graph=True)),
               "sdpa": device_ms_by_kernel(sdpa_fwd_bwd),
               "sdpa_fwd": device_ms_by_kernel(sdpa_fwd)}
        if passes and all(dev.values()):
            total = {k: sum(v.values()) for k, v in dev.items()}
            by_pass = ", ".join(
                f"{name} {sum(ms for k, ms in passes.items() if name in k):.4f}"
                for name in ("rows_kernel", "dq_kernel", "dkv_kernel",
                             "dp_kernel", "dp_sum"))
            dev_line = (
                f"; device time (profiler): kernel "
                f"{sum(passes.values()):.4f} ms ({by_pass}), plain "
                f"(autograd) {total['plain']:.4f} ms, SDPA backward "
                f"{total['sdpa'] - total['sdpa_fwd']:.4f} ms")
        else:
            dev_line = "; device time: the profiler saw none (not measured)"
        bound_ms, bound_by = attention_bwd_bound(B, H, t, DH)
        rows.append(dict(T=t, err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        log(f"kernel relpos_attention_bwd B{B} H{H} T{t} Dh{DH}: max_abs_err "
            f"{err:.3g}, err {rel_err:.3g} of each gradient's max |g| (tol "
            f"{ATTN_ATOL}: f32, sums in other orders, dp summed over the "
            f"batch in a second pass); kernel {ms:.4f} ms, plain (autograd) "
            f"{plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms (fwd+bwd "
            f"minus fwd, given the bias), bound {bound_ms:.4f} ms by "
            f"{bound_by}; {wide}{dev_line}")

    # the training path's dropout: the mask regenerated in the backward
    rate = 0.1
    seed = torch.tensor([4242], device=device)
    for t in BWD_DROPOUT_T:
        args = attention_case(t, False, gen, device)
        do = torch.randn(B, H, t, DH, generator=gen).to(device)
        err, rel_err, wide = attention_grad_errors(args, do, seed, scale,
                                                   rate)
        log(f"kernel relpos_attention_bwd B{B} H{H} T{t} Dh{DH} dropout "
            f"{rate}: max_abs_err {err:.3g}, err {rel_err:.3g} of each "
            f"gradient's max |g| (tol {ATTN_ATOL}, the same Philox mask on "
            f"both sides); {wide}")
    return rows


def lattice_rtol(loss, t, u1):
    """A gradient is exp(alpha + lp + beta - logZ): its exponent is a
    difference of f32 sums of magnitude ~|logZ| = loss, whose rounding
    errors add up like a random walk over a path's T + U steps."""
    return max(1e-4, 2 * math.sqrt(t + u1) * loss.abs().max().item()
               * 2.0 ** -24)


def lattice_case(b, t, u1, gen, device):
    """Log-prob lattices of random logits over the recipe's 29 tokens,
    lengths 0.6-1.0 of the padded ones, the first utterance full."""
    import torch
    from tsasr_torch.ops.rnnt_loss import _gather_label_blank_logprobs
    V = 29
    lpb, lpl = [], []
    for _ in range(b):   # one utterance at a time bounds the logits' size
        logits = torch.randn(1, t, u1, V, generator=gen).to(device)
        labels = torch.randint(1, V, (1, u1 - 1), generator=gen).to(device)
        x, y = _gather_label_blank_logprobs(torch.log_softmax(logits, -1),
                                            labels, 0)
        lpb.append(x)
        lpl.append(y)
    frac = 0.6 + 0.4 * torch.rand(b, generator=gen)
    frac[0] = 1.0
    t_lens = torch.clamp(torch.round(frac * t), 1, t).int()
    u_lens = torch.clamp(torch.round(frac * (u1 - 1)), 0, u1 - 1).int()
    return (torch.cat(lpb), torch.cat(lpl), t_lens.to(device),
            u_lens.to(device))


def as_f64(args):
    return [x.double() if x.is_floating_point() else x for x in args]


def lattice_err(got, want, rtol):
    """The worst of |got - want| / (1e-4 + rtol |want|) over the outputs
    (1 is the tolerance), in f64."""
    return max(((g.double() - w.double()).abs()
                / (1e-4 + rtol * w.double().abs())).max().item()
               for g, w in zip(got, want))


def phase_lattice(device, card):
    """Each lattice kernel against its plain version in f32 and in f64
    (the beta slab also alone, given the alpha slab kernel's alpha and
    logZ), then timed on CUDA events and on the profiler's device time,
    with us per row (T rows of the chain) beside the bound and the card;
    resident and slab against each other, and the resident kernel's
    repeats bit for bit."""
    import torch
    from tsasr_torch.kernels import rnnt_lattice as rl

    gen = torch.Generator().manual_seed(SEED + 11)
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for kind, b, t, u1 in LATTICES:
        args = lattice_case(b, t, u1, gen, device)
        lpb, lpl, t_lens, u_lens = args
        got = rl.rnnt_lattice(*args, variant=kind)
        torch.cuda.synchronize()
        want = rl.rnnt_lattice_reference(*args)
        want64 = rl.rnnt_lattice_reference(*as_f64(args))
        rtol = lattice_rtol(want64[0], t, u1)
        errs = {"f32": lattice_err(got, want, rtol),
                "f64": lattice_err(got, want64, rtol)}
        abs_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        finite = all(torch.isfinite(g).all() for g in got)
        valid = int(((t_lens.long()) * (u_lens.long() + 1)).sum())
        cells = b * t * u1
        shape = f"B{b} T{t} U+1 {u1}"
        plain_ms = cuda_ms(lambda: rl.rnnt_lattice_reference(*args),
                           reps=1, rounds=3)
        if kind == "resident":
            timed = {"resident": lambda: rl.rnnt_lattice(
                *args, variant="resident")}
        else:
            fns = rl._kernels()
            alpha = torch.empty_like(lpb)
            logz = torch.empty(b, device=device)
            loss = torch.empty(b, device=device)
            dlpb, dlpl = torch.empty_like(lpb), torch.empty_like(lpl)
            ptrs = (lpb.data_ptr(), lpl.data_ptr(), t_lens.data_ptr(),
                    u_lens.data_ptr())

            timed = {"alpha": lambda: fns["alpha"](
                         *ptrs, alpha.data_ptr(), logz.data_ptr(),
                         loss.data_ptr(), b, t, u1, stream),
                     "beta": lambda: fns["beta"](
                         *ptrs, alpha.data_ptr(), logz.data_ptr(),
                         dlpb.data_ptr(), dlpl.data_ptr(), b, t, u1,
                         stream)}
            timed["alpha"]()
            timed["beta"]()
            torch.cuda.synchronize()
            beta64 = rl.rnnt_beta_reference(*as_f64(args), alpha.double(),
                                            logz.double())
            errs["beta alone, f64"] = lattice_err((dlpb, dlpl), beta64, rtol)
        if not (max(errs.values()) <= 1.0 and finite):
            raise RuntimeError(f"rnnt_lattice {kind} {shape}: err/tol "
                               f"{errs}")
        log(f"kernel rnnt_lattice {kind} {shape}: max_abs_err {abs_err:.3g} "
            f"against f32, err/tol "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (rtol {rtol:.2g} + atol 1e-4: f32 row scans in another "
            f"order, see lattice_rtol), loss {got[0][0].item():.2f}; plain "
            f"{plain_ms:.3f} ms")
        for name, fn in timed.items():
            ms = cuda_ms(fn, reps=10, rounds=3)
            dev = sum(device_ms_by_kernel(fn).values()) or None
            bound_ms, bound_by = lattice_bound(name, valid, cells)
            rows.setdefault(name, dict(
                shape=shape, ms=ms, device_ms=dev, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, err=abs_err))
            dev_txt = (f"device {dev:.4f} ms ({dev * 1e3 / t:.3f} us per "
                       f"row)" if dev else "device time: the profiler saw "
                       "none (not measured)")
            log(f"  {name} kernel {shape}: CUDA events {ms:.4f} ms "
                f"({ms * 1e3 / t:.3f} us per row), {dev_txt}, bound "
                f"{bound_ms:.4f} ms by {bound_by} ({card})")

    # both variants forced at a shape both admit: each against the f64
    # plain version, and their own agreement. Both chains take K = 8 at
    # U+1 129 in both variants and run the same arithmetic (the beta
    # slab's text and its copy in the resident kernel), so the loss and
    # both gradients agree bit for bit; within twice the tolerance is
    # what each variant's own error allows
    args = lattice_case(6, 208, 129, gen, device)
    res = rl.rnnt_lattice(*args, variant="resident")
    slab = rl.rnnt_lattice(*args, variant="slab")
    want64 = rl.rnnt_lattice_reference(*as_f64(args))
    rtol = lattice_rtol(want64[0], 208, 129)
    e_res, e_slab = (lattice_err(x, want64, rtol) for x in (res, slab))
    agree = max(((r.double() - s.double()).abs()
                 / (2 * (1e-4 + rtol * w.abs()))).max().item()
                for r, s, w in zip(res, slab, want64))
    bits = [torch.equal(r, s) for r, s in zip(res, slab)]
    log(f"rnnt_lattice resident vs slab at B6 T208 U+1 129 (alpha and beta "
        f"chains at K = {rl.resident_cols(208, 129)} in both): err/tol "
        f"against f64 resident {e_res:.3g}, slab {e_slab:.3g}; "
        f"{agree:.3g} of twice the tolerance; bit-identical: loss "
        f"{bits[0]}, dlpb {bits[1]}, dlpl {bits[2]}")
    if max(e_res, e_slab, agree) > 1.0 or not all(bits):
        raise RuntimeError("the lattice variants disagree")
    # no atomics and a fixed order of every sum: the same bits each time
    slab_args = lattice_case(3, 408, 241, gen, device)
    for variant, case, shape in (("resident", args, "B6 T208 U+1 129"),
                                 ("slab", slab_args, "B3 T408 U+1 241")):
        first = rl.rnnt_lattice(*case, variant=variant)
        repeats = [rl.rnnt_lattice(*case, variant=variant) for _ in range(3)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, f) for rep in repeats
                   for a, f in zip(rep, first))
        log(f"rnnt_lattice {variant} at {shape}: 3 repeats bit-identical "
            f"to the first: {same}")
        if not same:
            raise RuntimeError(f"the {variant} lattice kernels' repeats "
                               "differ")
    return rows


def make_requests(rng):
    import numpy as np

    def batch(seconds):
        n = seconds * SAMPLE_RATE
        lens = [n] + [int(n * f) for f in rng.uniform(0.6, 1.0, B - 1)]
        return [(rng.normal(size=m) * 0.1).astype(np.float32) for m in lens]

    return [(batch(s), batch(ENROLL_SECONDS)) for s in REQUEST_SECONDS]


def set_fused(model, fused):
    from tsasr_torch.models.attention import RelPosMHAXL
    for module in model.modules():
        if isinstance(module, RelPosMHAXL):
            module.fused = fused


def reset_counts():
    from tsasr_torch.kernels import relpos_attention as ra
    from tsasr_torch.kernels import rnnt_lattice as rl
    ra.launches = ra.bwd_launches = 0
    ra.bf16_launches = ra.bf16_bwd_launches = ra.bf16_long_launches = 0
    rl.resident_launches = rl.alpha_slab_launches = 0
    rl.beta_slab_launches = 0


def read_counts():
    from tsasr_torch.kernels import relpos_attention as ra
    from tsasr_torch.kernels import rnnt_lattice as rl
    return {"relpos_attention_fwd": ra.launches,
            "relpos_attention_bwd": ra.bwd_launches,
            "rnnt_lattice_resident": rl.resident_launches,
            "rnnt_lattice_alpha_slab": rl.alpha_slab_launches,
            "rnnt_lattice_beta_slab": rl.beta_slab_launches}


def read_bf16_counts():
    """``read_counts`` and the bf16 attention kernels' counts (the
    forward's resident route and its long route apart)."""
    from tsasr_torch.kernels import relpos_attention as ra
    return dict(read_counts(), relpos_attention_fwd_bf16=ra.bf16_launches,
                relpos_attention_fwd_bf16_long=ra.bf16_long_launches,
                relpos_attention_bwd_bf16=ra.bf16_bwd_launches)


def phase_serving(device, card):
    import numpy as np
    import torch
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.models.frontend import ConvolutionFrontEnd
    from tsasr_torch.models.transducer import TSTransducer, scratch_config

    config = scratch_config()
    model = TSTransducer(config).init_weights(seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    tr = TSASRTranscriber(model, None, CharTokenizer(PIECES),
                          device=str(device))
    log(f"serving: scratch config d_model {config.d_model}, "
        f"{config.encoder_num_layers}+{config.speaker_encoder_layers} "
        f"layers, {n_params} params, fused_attention "
        f"{config.fused_attention}, device {tr.device}")
    requests = make_requests(np.random.default_rng(SEED))
    tr.transcribe_batch(*requests[0])          # warm-up, not counted
    torch.cuda.synchronize()

    reset_counts()
    results = []
    for (wavs, enrolls), seconds in zip(requests, REQUEST_SECONDS):
        before = read_counts()["relpos_attention_fwd"]
        t0 = time.perf_counter()
        texts = tr.transcribe_batch(wavs, enrolls)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        results.append((read_counts()["relpos_attention_fwd"] - before, dt,
                        texts))
    counts = read_counts()

    for (n, dt, texts), (wavs, _), seconds in zip(results, requests,
                                                  REQUEST_SECONDS):
        audio = sum(len(w) for w in wavs) / SAMPLE_RATE
        log(f"request {B} x {seconds} s: {dt * 1e3:.1f} ms, "
            f"{audio / dt:.1f} audio-s/s, {n} attention launches "
            f"[{card}]")
        if n != LAYERS_PER_REQUEST:
            raise RuntimeError(f"request launched the attention kernel {n} "
                               f"times, expected {LAYERS_PER_REQUEST}")
        if len(texts) != B or not all(set(x) <= set("".join(PIECES[2:])
                                                     + " ") for x in texts):
            raise RuntimeError(f"bad transcripts {texts!r}")

    for (wavs, enrolls), seconds, (_, dt, texts) in zip(
            requests, REQUEST_SECONDS, results):
        t0 = time.perf_counter()
        enc, _ = tr.encode_batch(wavs, enrolls)
        torch.cuda.synchronize()
        enc_dt = time.perf_counter() - t0
        set_fused(tr.model, False)
        plain, _ = tr.encode_batch(wavs, enrolls)
        plain_texts = tr.transcribe_batch(wavs, enrolls)
        set_fused(tr.model, True)
        t_out = ConvolutionFrontEnd.output_length(
            1 + seconds * SAMPLE_RATE // 160)
        if tuple(enc.shape) != (B, t_out, config.joint_dim) \
                or not torch.isfinite(enc).all():
            raise RuntimeError(f"encoder output {tuple(enc.shape)} is not "
                               f"finite or not ({B}, {t_out}, "
                               f"{config.joint_dim})")
        err = (enc - plain).abs().max().item()
        same = sum(a == b for a, b in zip(texts, plain_texts))
        log(f"encoder {seconds} s: features + speaker + encoder "
            f"{enc_dt * 1e3:.1f} ms of the request's {dt * 1e3:.1f} ms, "
            f"the rest is greedy search over {t_out} frames; kernel vs "
            f"plain attention max_abs_err {err:.3g} (atol {ENC_ATOL}: f32, "
            f"18 layers of reordered sums), max |enc| "
            f"{enc.abs().max().item():.3g}; {same}/{B} transcripts identical")
        if err > ENC_ATOL:
            raise RuntimeError(f"encoder differs from the plain path by "
                               f"{err} > {ENC_ATOL}")
    return counts


def beam_agreement(searcher, cpu_searcher, enc, rel):
    """The card's batched beam against the same search on the CPU over
    the card's encoder output: per utterance, the best tokens must be
    identical where the card's top two live hypotheses (two different
    token sequences: the beam keeps a sequence reached by two alignments
    twice, nearly tied) are more than BEAM_MARGIN apart in normalized
    score, and where the best tokens are identical their normalized
    scores within BEAM_SCORE_ATOL. Returns (utterances held to identical
    tokens, utterances with identical best tokens, worst best-score
    error, worst score error over the sequences both sides hold, the
    card's top-two gaps)."""
    import torch
    got = [x.cpu() for x in searcher.decode(enc, rel)]
    want = cpu_searcher.decode(enc.cpu(), rel.cpu())
    held = same = 0
    best_err = common_err = 0.0
    gaps = []

    def ranked(tokens, lengths, norm, b):
        """{token sequence: its best normalized score}, best first."""
        out = {}
        for k in range(tokens.shape[1]):
            if norm[b, k] > -1e20:
                out.setdefault(tuple(tokens[b, k, :lengths[b, k]].tolist()),
                               norm[b, k].item())
        return out

    for b in range(enc.shape[0]):
        hyps, w_hyps = ranked(*got, b), ranked(*want, b)
        scores = list(hyps.values())
        gap = scores[0] - scores[1] if len(scores) > 1 else math.inf
        gaps.append(gap)
        best = next(iter(hyps))
        if best == next(iter(w_hyps)):
            same += 1
            best_err = max(best_err, abs(hyps[best] - w_hyps[best]))
        elif gap > BEAM_MARGIN:
            raise RuntimeError(f"utterance {b}: the card's best hypothesis "
                               f"({gap:.3g} above its second) is not the "
                               "CPU's")
        held += gap > BEAM_MARGIN
        common = hyps.keys() & w_hyps.keys()
        common_err = max([common_err] + [abs(hyps[h] - w_hyps[h])
                                         for h in common])
    if best_err > BEAM_SCORE_ATOL or not all(
            torch.isfinite(x).all() for x in (got[2], want[2])):
        raise RuntimeError(f"best normalized scores differ by {best_err} > "
                           f"{BEAM_SCORE_ATOL}")
    return held, same, best_err, common_err, gaps


def profile_request(tr, request, seconds, card):
    """Where one beam request's time goes: device time by kernel from
    ``torch.profiler`` and the device's busy share of the wall time (the
    profiler's own overhead included)."""
    wall_ms, events = profiled(lambda: tr.transcribe_batch(*request))
    if not events:
        log("profile: the profiler saw no device time (not measured)")
        return
    busy_ms = sum(device_us(e) for e in events) / 1e3
    launches = sum(e.count for e in events)
    log(f"profile beam {BEAM_SIZE} request {B} x {seconds} s: wall "
        f"{wall_ms:.1f} ms with the profiler on, device busy {busy_ms:.1f} "
        f"ms ({100 * busy_ms / wall_ms:.1f} %), {launches} kernel launches "
        f"[{card}]")
    for e in sorted(events, key=device_us, reverse=True)[:6]:
        log(f"  {device_us(e) / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}")


def phase_serving_beam(device, card):
    """The three requests again through ``TSASRTranscriber(beam_size=15)``
    (the batched beam): host-clock ms per request and 18 attention
    launches each, then the card's search against the same searcher on
    the CPU over the card's encoder output (``beam_agreement``); once
    more with a seeded RNN-LM in the port's checkpoint format at
    lm_weight 0.3; the exact beam on one 4 s utterance. One 8 s request
    is profiled."""
    import copy
    import tempfile
    import numpy as np
    import torch
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_torch.decoding import (BatchedBeamSearcher,
                                      TransducerBeamSearcher)
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.models.lm import (RNNLM, RNNLMConfig,
                                       load_lm_checkpoint, make_lm_step_fn,
                                       save_lm_checkpoint)
    from tsasr_torch.models.transducer import TSTransducer, scratch_config

    model = TSTransducer(scratch_config()).init_weights(seed=SEED)
    tr = TSASRTranscriber(model, None, CharTokenizer(PIECES),
                          beam_size=BEAM_SIZE, device=str(device))
    cpu_model = copy.deepcopy(tr.model).cpu()
    requests = make_requests(np.random.default_rng(SEED))
    tr.transcribe_batch(*requests[0])          # warm-up, not counted
    torch.cuda.synchronize()
    reset_counts()
    for (wavs, enrolls), seconds in zip(requests, REQUEST_SECONDS):
        before = read_counts()["relpos_attention_fwd"]
        t0 = time.perf_counter()
        texts = tr.transcribe_batch(wavs, enrolls)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = read_counts()["relpos_attention_fwd"] - before
        t1 = time.perf_counter()
        enc, rel = tr.encode_batch(wavs, enrolls)
        torch.cuda.synchronize()
        enc_dt = time.perf_counter() - t1
        log(f"beam {BEAM_SIZE} request {B} x {seconds} s: {dt * 1e3:.1f} ms "
            f"(features + speaker + encoder {enc_dt * 1e3:.1f} ms, the rest "
            f"the batched beam over {enc.shape[1]} frames), "
            f"{sum(len(w) for w in wavs) / SAMPLE_RATE / dt:.1f} "
            f"audio-s/s, {n} attention launches [{card}]")
        if n != LAYERS_PER_REQUEST:
            raise RuntimeError(f"request launched the attention kernel {n} "
                               f"times, expected {LAYERS_PER_REQUEST}")
        if len(texts) != B or not all(set(x) <= set("".join(PIECES[2:])
                                                     + " ") for x in texts):
            raise RuntimeError(f"bad transcripts {texts!r}")
        t1 = time.perf_counter()
        held, same, best_err, common_err, gaps = beam_agreement(
            tr.searcher, BatchedBeamSearcher(cpu_model, beam_size=BEAM_SIZE),
            enc, rel)
        log(f"  card vs CPU search on the card's encoder output: best "
            f"tokens identical {same}/{B}, held to identical (top-two gap > "
            f"{BEAM_MARGIN}) {held}/{B}, gaps min {min(gaps):.3g}; best "
            f"normalized score max_abs_err {best_err:.3g} (atol "
            f"{BEAM_SCORE_ATOL}), hypotheses both hold {common_err:.3g} "
            f"({time.perf_counter() - t1:.1f} s)")
    profile_request(tr, requests[1], REQUEST_SECONDS[1], card)

    with tempfile.TemporaryDirectory(prefix="tsasr_lm_") as tmp:
        lm_path = str(Path(tmp) / "rnnlm.ckpt")
        save_lm_checkpoint(RNNLM(RNNLMConfig(vocab_size=len(PIECES)))
                           .init_weights(seed=SEED), lm_path)
        fused = TSASRTranscriber(tr.model, None, CharTokenizer(PIECES),
                                 beam_size=BEAM_SIZE, lm_path=lm_path,
                                 lm_weight=LM_WEIGHT, device=str(device))
        cpu_lm = load_lm_checkpoint(lm_path, "cpu")
    wavs, enrolls = requests[0]
    fused.transcribe_batch(wavs, enrolls)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = fused.transcribe_batch(wavs, enrolls)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    changed = sum(a != b for a, b in zip(
        texts, tr.transcribe_batch(wavs, enrolls)))
    enc, rel = fused.encode_batch(wavs, enrolls)
    held, same, best_err, common_err, gaps = beam_agreement(
        fused.searcher, BatchedBeamSearcher(
            cpu_model, beam_size=BEAM_SIZE,
            lm_step_fn=make_lm_step_fn(cpu_lm), lm_weight=LM_WEIGHT,
            lm_initial_state_fn=cpu_lm.initial_state), enc, rel)
    log(f"beam {BEAM_SIZE} + RNN-LM (seed {SEED}, port checkpoint, weight "
        f"{LM_WEIGHT}) request {B} x {REQUEST_SECONDS[0]} s: "
        f"{dt * 1e3:.1f} ms [{card}]; card vs CPU: best tokens identical "
        f"{same}/{B}, held {held}/{B}, best score max_abs_err "
        f"{best_err:.3g}, both-held {common_err:.3g}; {changed}/{B} "
        f"transcripts changed by the LM")

    exact = TransducerBeamSearcher(tr.model, 0, beam_size=BEAM_SIZE, nbest=1)
    t0 = time.perf_counter()
    hyps, score, _, _ = exact(enc[:1], rel[:1])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    batched, _, _, _ = tr.searcher(enc[:1], rel[:1])
    log(f"exact beam {BEAM_SIZE} on one {REQUEST_SECONDS[0]} s utterance "
        f"({enc.shape[1]} frames): {dt:.2f} s [{card}], {len(hyps[0])} "
        f"tokens, exp score {score:.3g}; the batched beam's best "
        f"{'identical' if hyps == batched else 'differs'}")
    if not (hyps and all(0 < t < len(PIECES) for t in hyps[0])
            and math.isfinite(score)):
        raise RuntimeError(f"the exact beam gave {hyps!r}, {score}")
    return read_counts()


def make_train_batch(rng, n, seconds, ids=None):
    """A PaddedBatch in the JAX recipe's form: n mixtures of up to
    ``seconds`` (lengths 0.6-1.0, the first full), 5 s enrollments, random
    character transcripts at ~15 chars/s with tokens padded to 16."""
    import numpy as np
    from tsasr_torch.data.batch import PaddedBatch, PaddedData

    fracs = np.concatenate([[1.0], rng.uniform(0.6, 1.0, n - 1)])
    examples = []
    for i, frac in enumerate(fracs):
        m = int(seconds * SAMPLE_RATE * frac)
        e = int(ENROLL_SECONDS * SAMPLE_RATE * rng.uniform(0.6, 1.0))
        n_tok = max(1, int(round(CHARS_PER_SECOND * seconds * frac)))
        tokens = rng.integers(1, len(PIECES), size=n_tok)
        words = "".join(PIECES[t] for t in tokens).split("▁")
        examples.append({
            "id": (ids or "utt") + f"{i}",
            "mixed_sig": (rng.normal(size=m) * 0.1).astype(np.float32),
            "enroll_sig": (rng.normal(size=e) * 0.1).astype(np.float32),
            "tokens": tokens.astype(np.int64),
            "target_words": [w for w in words if w] or [""]})
    batch = PaddedBatch(examples, pad_to_multiple={"tokens": 16},
                        padded_keys=["mixed_sig", "enroll_sig", "tokens"])
    tok = batch.tokens
    batch.tokens_bos = PaddedData(np.concatenate(
        [np.zeros((len(examples), 1), np.int64), tok.data], 1), tok.lengths)
    return batch


def training_batches():
    """The training phase's batches: the main path's micro-batches, the
    dropout-0 gradient check's and the VALID one."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    train = [make_train_batch(rng, *TRAIN_BATCHES[i % 2], ids=f"m{i}-")
             for i in range(MICRO_BATCHES)]
    check = make_train_batch(rng, *TRAIN_BATCHES[0], ids="d-")
    valid = make_train_batch(rng, *TRAIN_BATCHES[0], ids="v-")
    return train, check, valid


def make_brain(config, device, hparams=None, model=None):
    """A brain over ``model``, by default ``config``'s model on seeded
    weights."""
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_torch.models.transducer import TSTransducer
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    from tsasr_torch.training import NoamScheduler, make_adamw

    hp = dict(HPARAMS, **(hparams or {}))
    hp.setdefault("noam_scheduler", NoamScheduler(1e-3, 10000))
    model = model or TSTransducer(config).init_weights(seed=SEED)
    return TSASRBrain(modules={"model": model},
                      opt_class=make_adamw(1e-3, (0.9, 0.98), 1e-8, 0.01),
                      hparams=hp, run_opts={"device": str(device)},
                      tokenizer=CharTokenizer(PIECES))


@contextlib.contextmanager
def plain_kernels():
    """Context: the model's attention and lattice calls take their plain
    versions on the card (for the comparison runs only)."""
    from tsasr_torch.kernels import relpos_attention as ra
    from tsasr_torch.kernels import rnnt_lattice as rl
    from tsasr_torch.models import attention as attention_mod
    from tsasr_torch.ops import rnnt_loss as loss_mod
    from tsasr_torch.ops import rnnt_loss_fused as fused_mod

    saved = (attention_mod.fused_relpos_attention, fused_mod.rnnt_lattice,
             loss_mod.rnnt_lattice)
    attention_mod.fused_relpos_attention = \
        lambda *a, seed, scale, rate: ra.relpos_attention_reference(
            *a, scale, seed, rate)
    fused_mod.rnnt_lattice = loss_mod.rnnt_lattice = \
        rl.rnnt_lattice_reference
    try:
        yield
    finally:
        (attention_mod.fused_relpos_attention, fused_mod.rnnt_lattice,
         loss_mod.rnnt_lattice) = saved


@contextlib.contextmanager
def planted_fault():
    """Context: the attention backward's dp is not summed over the batch
    (it is the first utterance's share alone), a fault the gradient check
    must catch."""
    from tsasr_torch.kernels import relpos_attention as ra

    real = ra._launch_bwd

    def faulty(q_u, q_v, k, v, p, kp_add, am_add, out, stats, do, seed_t,
               scale, rate):
        *grads, _ = real(q_u, q_v, k, v, p, kp_add, am_add, out, stats, do,
                         seed_t, scale, rate)
        *_, dp = real(q_u[:1], q_v[:1], k[:1], v[:1], p, kp_add[:1],
                      am_add, out[:1], stats[:1], do[:1], seed_t, scale, rate)
        return (*grads, dp)

    ra._launch_bwd = faulty
    try:
        yield
    finally:
        ra._launch_bwd = real


def wide_brain(device, config=None, hparams=None, model=None):
    """The dropout-0 full-width brain (of ``config``, by default the
    scratch recipe's) with its weights (the same as ``make_brain``'s, or
    a copy of ``model``'s) and its features in f64, for the plain
    versions."""
    import copy
    from tsasr_torch.models.transducer import scratch_config
    brain = make_brain(config or scratch_config(dropout=0.0), device,
                       hparams, model and copy.deepcopy(model))
    brain.model.double()
    brain.fbank.double()
    return brain


def batch_arrays(brain, batch, dtype=None):
    """The micro-batch's arrays on the brain's device, the float ones
    cast to ``dtype`` if given."""
    arrays = brain._put_batch(brain.batch_to_arrays(batch))
    if dtype is not None:
        arrays = {k: v.to(dtype) if v.is_floating_point() else v
                  for k, v in arrays.items()}
    return arrays


def loss_and_grads(brain, batch, dtype=None, retain=False):
    """Loss and every parameter's gradient of one TRAIN micro-batch. With
    ``dtype``, the float inputs are cast to it and it is the default
    dtype for the run (an f64 run of ``wide_brain``); ``retain`` keeps
    the graph for a second differentiation."""
    import torch
    from tsasr_torch.training.brain import onednn_off_on_cpu
    from tsasr_torch.utils.stage import Stage
    arrays = batch_arrays(brain, batch, dtype)
    params = [p for p in brain.model.parameters()]
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype or saved)
    try:
        with onednn_off_on_cpu(brain.device):
            loss = brain.compute_objectives(
                brain.compute_forward(arrays, Stage.TRAIN, None), arrays,
                Stage.TRAIN)
            return loss.detach(), torch.autograd.grad(
                loss, params, retain_graph=retain)
    finally:
        torch.set_default_dtype(saved)


def leaf_errors(got, want):
    """Per gradient leaf: max |got - want| over max |want|, in f64."""
    return [((g.double() - w.double()).abs().max()
             / w.double().abs().max().clamp(min=1e-30)).item()
            for g, w in zip(got, want)]


def kink_sites(model):
    """Modules whose output goes straight into leaky_relu, by name: each
    FFN's first Linear, each conv module's mid LayerNorm, each frontend
    block's LayerNorm, with the kind of each. (The joint's leaky_relu runs
    inside the fused loss, out of a hook's reach: ``joint_kink_bounds``
    recomputes its pre-activations.)"""
    from tsasr_torch.models.conformer import ConvolutionModule, FeedForward
    from tsasr_torch.models.frontend import ConvBlock
    kinds = {FeedForward: ("w1", "FFN"), ConvolutionModule: ("norm_mid",
                                                             "conv"),
             ConvBlock: ("norm", "frontend")}
    return {f"{name}.{kinds[type(m)][0]}": kinds[type(m)][1]
            for name, m in model.named_modules() if type(m) in kinds}


@contextlib.contextmanager
def pre_activation_hooks(model, fn):
    """Context: ``fn((site, call), module, x, z)`` sees the input x and
    the output z (the pre-activation) of every kink site in each forward
    (``call`` counts the site's calls)."""
    calls = collections.Counter()

    def hook(site):
        def run(module, inputs, out):
            key = (site, calls[site])
            calls[site] += 1
            fn(key, module, inputs[0], out)
        return run

    handles = [model.get_submodule(site).register_forward_hook(hook(site))
               for site in kink_sites(model)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def kink_bounds(seen):
    """Per parameter name, how far the f32 rounding of a pre-activation
    to the other side of the kink could move each element's gradient at
    most: a flip at pre-activation z changes dL/dz by 0.99 |da| (da the
    gradient of the activation's output: dL/dz over the slope), and the
    producing module's weight and bias gradients take it times |x| (a
    Linear's input; a LayerNorm's normalized input) and times 1. Summed
    over every pre-activation within KINK_Z of the kink, in f64, so no
    two flips cancel. ``seen``: (site, module, x, z, near, dL/dz) of the
    f64 run."""
    import torch
    import torch.nn.functional as F

    bounds = {}
    for site, module, x, z, near, g in seen:
        d = torch.where(near, 0.99 * g.abs() / torch.where(z > 0, 1.0, 0.01),
                        0.0)
        if isinstance(module, torch.nn.Linear):
            d = d.reshape(-1, d.shape[-1])
            w = d.T @ x.abs().reshape(-1, x.shape[-1])
            b = d.sum(0)
        else:
            n = F.layer_norm(x, module.normalized_shape, eps=module.eps)
            lead = tuple(range(d.dim() - len(module.normalized_shape)))
            w = (d * n.abs()).sum(lead)
            b = d.sum(lead)
        for name, bound in ((f"{site}.weight", w), (f"{site}.bias", b)):
            bounds[name] = bounds.get(name, 0.0) + bound
    return bounds


# the Linears whose outputs the joint sums, enc_out and dec_out
JOINT_PRODUCERS = ("encoder_proj", "predictor.decoder_proj")


@contextlib.contextmanager
def joint_producers(model, store):
    """Context: ``store[name] = (input, output)`` of each of
    ``JOINT_PRODUCERS`` in each forward, detached."""
    def keep(name):
        def run(module, inputs, out):
            store[name] = (inputs[0].detach(), out.detach())
        return run

    handles = [model.get_submodule(name).register_forward_hook(keep(name))
               for name in JOINT_PRODUCERS]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def joint_pre_activations(store):
    """The joint's pre-activations enc[:, :, None] + dec[:, None] over the
    (B, T, U+1, J) lattice, from ``joint_producers``' store."""
    enc = store["encoder_proj"][1]
    dec = store["predictor.decoder_proj"][1]
    return enc[:, :, None, :] + dec[:, None, :, :]


def joint_kink_bounds(brain, batch, store):
    """``kink_bounds`` for the joint's leaky_relu inside the fused loss, in
    a plain f64 recomputation of the f64 run's joint: the pre-activations
    z = enc + dec over the lattice, the head, the log-softmax, the plain
    lattice's gradients, and the fused backward's dL/dlogits and dL/dh
    (h = leaky_relu(z)). A flip at z within KINK_Z changes dL/dz by 0.99
    |dL/dh|: encoder_proj's gradients take its sum over U+1 times |x|
    and 1, predictor.decoder_proj's its sum over T; the flip moves h by
    0.99 |z|, which the head's weight gradient takes times |dL/dlogits|.
    Returns (bounds by parameter name, z, near the kink, inside the
    lattice)."""
    import torch
    import torch.nn.functional as F
    from tsasr_torch.kernels import rnnt_lattice as rl
    from tsasr_torch.ops.rnnt_loss import (_gather_label_blank_logprobs,
                                           _logprob_grads)

    arrays = batch_arrays(brain, batch, torch.float64)
    (enc_in, _), (dec_in, _) = (store[n] for n in JOINT_PRODUCERS)
    z = joint_pre_activations(store)
    _, T, U1, _ = z.shape
    _, rel = brain._features(arrays["mixed_sig"], arrays["mixed_lens"])
    t_lens = torch.round(rel * T).to(torch.int32)
    labels = arrays["tokens"]
    u_lens = torch.round(arrays["tokens_lens"] * labels.shape[1]
                         ).to(torch.int32)
    head = brain.model.transducer_head
    blank = brain.hparams.blank_index
    lp = torch.log_softmax(F.leaky_relu(z, 0.01) @ head.weight.t()
                           + head.bias, dim=-1)
    _, dlpb, dlpl = rl.rnnt_lattice_reference(
        *_gather_label_blank_logprobs(lp, labels, blank), t_lens, u_lens)
    weight = arrays["weight"]
    share = (weight / weight.sum().clamp(min=1.0))[:, None, None]
    dlogits = _logprob_grads(lp, dlpb * share, dlpl * share, labels, blank)
    near = z.abs() < KINK_Z
    delta = torch.where(near, 0.99 * (dlogits @ head.weight).abs(), 0.0)
    d_enc = delta.sum(2).flatten(0, 1)
    d_dec = delta.sum(1).flatten(0, 1)
    moved_h = torch.where(near, 0.99 * z.abs(), 0.0).flatten(0, 2)
    inside = ((torch.arange(T, device=z.device)[None, :, None]
               < t_lens[:, None, None])
              & (torch.arange(U1, device=z.device)[None, None, :]
                 <= u_lens[:, None, None]))
    return {
        "encoder_proj.weight": d_enc.T @ enc_in.abs().flatten(0, 1),
        "encoder_proj.bias": d_enc.sum(0),
        "predictor.decoder_proj.weight":
            d_dec.T @ dec_in.abs().flatten(0, 1),
        "predictor.decoder_proj.bias": d_dec.sum(0),
        "transducer_head.weight":
            dlogits.abs().flatten(0, 2).T @ moved_h,
    }, z, near, inside[..., None].expand_as(z)


@contextlib.contextmanager
def joiner_capture(model, store, grads=False):
    """Context, for a joint outside the fused loss (the ``concat`` joint,
    a band): ``store["z"]`` the pre-activation of the joiner's
    leaky_relu in each forward (enc + dec, or ``joint_network``'s
    output), detached. With ``grads`` (the f64 run) also what
    ``joiner_kink_bounds`` needs: the joint producers' inputs and
    outputs, the joint's input x (concat), dL/dh at the joiner's output,
    dL/dlogits at the head's, and the pre-activation z_abs taken with
    |joint_network| (enc + dec itself for the sum), which stays in the
    graph from enc_out and dec_out."""
    import torch
    import torch.nn.functional as F

    def on_joiner(module, inputs, h):
        enc, dec = inputs
        x = None
        if module.joint_network is None:
            z = z_abs = enc + dec
        else:
            shape = torch.broadcast_shapes(enc.shape[:-1], dec.shape[:-1])
            x = torch.cat([enc.expand(*shape, -1), dec.expand(*shape, -1)],
                          dim=-1)
            z = module.joint_network(x)
            z_abs = F.linear(x, module.joint_network.weight.abs())
        store["z"] = z.detach()
        if grads:
            store["x"] = None if x is None else x.detach()
            store["z_abs"] = z_abs
            h.register_hook(lambda g: store.__setitem__("dh", g.detach()))

    def on_head(module, inputs, logits):
        logits.register_hook(
            lambda g: store.__setitem__("dlogits", g.detach()))

    def on_producer(name):
        def run(module, inputs, out):
            store[name] = (inputs[0].detach(), out)
        return run

    handles = [model.joiner.register_forward_hook(on_joiner)]
    if grads:
        handles.append(model.transducer_head.register_forward_hook(on_head))
        handles += [model.get_submodule(n).register_forward_hook(
            on_producer(n)) for n in JOINT_PRODUCERS]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def joiner_kink_bounds(store):
    """``joint_kink_bounds`` for a joint outside the fused loss, from the
    f64 run's ``joiner_capture(grads=True)`` store: a flip at z within
    KINK_Z changes dL/dz by delta = 0.99 |dL/dh|; enc_out's and
    dec_out's gradients take delta through |joint_network| (the band's
    gather summed back by autograd), the producers' weights times |x|
    and their biases times 1, ``joint_network``'s weight delta times
    the joint's |x|, and the head's weight 0.99 |z| times |dL/dlogits|.
    Returns (bounds by parameter name, z, near the kink, where the loss
    sees the cell: dL/dh != 0)."""
    import torch
    z = store["z"]
    near = z.abs() < KINK_Z
    delta = torch.where(near, 0.99 * store["dh"].abs(), 0.0)
    (enc_in, enc_out), (dec_in, dec_out) = (store[n]
                                            for n in JOINT_PRODUCERS)
    d_enc, d_dec = torch.autograd.grad(store["z_abs"], (enc_out, dec_out),
                                       grad_outputs=delta)
    moved_h = torch.where(near, 0.99 * z.abs(), 0.0).flatten(0, 2)
    bounds = {
        "encoder_proj.weight": d_enc.flatten(0, 1).T
        @ enc_in.abs().flatten(0, 1),
        "encoder_proj.bias": d_enc.sum((0, 1)),
        "predictor.decoder_proj.weight": d_dec.flatten(0, 1).T
        @ dec_in.abs().flatten(0, 1),
        "predictor.decoder_proj.bias": d_dec.sum((0, 1)),
        "transducer_head.weight":
            store["dlogits"].abs().flatten(0, 2).T @ moved_h,
    }
    if store["x"] is not None:
        bounds["joiner.joint_network.weight"] = delta.flatten(0, 2).T \
            @ store["x"].abs().flatten(0, 2)
        bounds["joiner.joint_network.bias"] = delta.sum((0, 1, 2))
    return bounds, z, near, store["dh"] != 0


# leaves whose gradient is 0 in exact arithmetic (a softmax does not see
# a shift shared by all its inputs: the key bias of the cross-attention,
# the bias of ECAPA's pooling attention): both runs give rounding noise,
# held at the scale of the same layer's weight gradient
ZERO_GRADIENT_LEAVES = ("speaker_attn.k_proj.bias", "asp.conv.bias")


def scale_leaves(names):
    """Per leaf, the index of the leaf whose max |g| scales its error."""
    return [names.index(n[:-len("bias")] + "weight")
            if n.endswith(ZERO_GRADIENT_LEAVES) else i
            for i, n in enumerate(names)]


def held_errors(got, want, masks, held, scales=None):
    """Per leaf: max |got - want| over the elements where the mask is
    ``held``, of the leaf's max |want| (0 where it holds none), or of
    ``want[scales[i]]``'s, in f64."""
    import torch
    scales = scales or range(len(want))
    return [(torch.where(m == held, (g.double() - w.double()).abs(), 0.0)
             .max() / want[j].double().abs().max().clamp(min=1e-30)).item()
            for g, w, m, j in zip(got, want, masks, scales)]


def check_gradients(device, batch, config=None, hparams=None, fault=True,
                    loss_rtol=1e-4, name="6 x 8 s"):
    """At dropout 0, one micro-batch's loss and gradients with every
    kernel against the same model with every kernel forced to its plain
    version. Two more readings place the tolerances: the f32 noise floor
    (the plain model in f32 against the same model, weights and batch in
    f64) and, with ``fault``, a planted fault (dp not summed over the
    batch). ``config`` / ``hparams``: the model and the recipe's keys
    (by default the scratch recipe's at dropout 0).

    The elements held loosely are decided from the plain f64 run alone:
    forward hooks find the pre-activations within KINK_Z of leaky_relu's
    kink, and an element whose gradient a flip of them could move by
    more than half of GRAD_TIGHT_REL of its leaf's max |g| (kink_bounds)
    is held at GRAD_ATOL_REL, every other one at GRAD_TIGHT_REL. The f32
    runs' pre-activations are read against f64's: a sign flip outside
    the kink set fails the check, since its premise would not hold.
    The joint's leaky_relu is placed the same way from a plain f64
    recomputation of its pre-activations inside the fused loss
    (``joint_kink_bounds``), or from the f64 run's own joint where the
    loss is not fused (``joiner_kink_bounds``). An ECAPA speaker branch
    (ReLU kinks) runs before any kernel: its output must be the same in
    both f32 runs, so no flip there. Returns (the f32 brain, the
    readings)."""
    import torch
    from tsasr_torch.models.ecapa import ECAPA_TDNN
    from tsasr_torch.models.transducer import scratch_config

    config = config or scratch_config(dropout=0.0)
    det = make_brain(config, device, hparams)
    fused = det._fused_loss_active()
    kinds = kink_sites(det.model)
    z64, near, seen = {}, {}, []

    def capture(key, module, x, z):
        z64[key] = z.detach()
        near[key] = z.detach().abs() < KINK_Z
        z.register_hook(lambda g: seen.append(
            (key[0], module, x.detach(), z64[key], near[key], g.detach())))

    z_err = {}

    def compare(run):
        z_err[run] = {"flips": 0, "outside": 0}

        def read(key, module, x, z):
            want = z64[key]
            acc = z_err[run]
            kind = kinds[key[0]]
            acc[kind] = max(acc.get(kind, 0.0), (z.detach().double() - want)
                            .abs().max().item())
            flips = (z.detach() > 0) != (want > 0)
            acc["flips"] += int(flips.sum())
            acc["outside"] += int((flips & ~near[key]).sum())
        return read

    def joint_capture(model, store, grads=False):
        return joint_producers(model, store) if fused \
            else joiner_capture(model, store, grads)

    def compare_joint(run, store):
        """The f32 run's joint pre-activations against f64's, where the
        loss sees them."""
        z = (joint_pre_activations(store) if fused else store["z"]).double()
        flips = ((z > 0) != (z64j > 0)) & inside_j
        acc = z_err[run]
        acc["joint"] = torch.where(inside_j, (z - z64j).abs(), 0.0
                                   ).max().item()
        acc["flips"] += int(flips.sum())
        acc["outside"] += int((flips & ~near_j).sum())

    store = {}
    with plain_kernels():
        reset_counts()
        wide = wide_brain(device, config, hparams, det.model)
        speaker = []
        hook = det.model.speaker_encoder.register_forward_hook(
            lambda m, i, out: speaker.append(out.detach())) \
            if isinstance(det.model.speaker_encoder, ECAPA_TDNN) else None
        with pre_activation_hooks(wide.model, capture), \
                joint_capture(wide.model, store, grads=True):
            loss_w, grads_w = loss_and_grads(wide, batch, torch.float64,
                                             retain=not fused)
        joint_bounds, z64j, near_j, inside_j = \
            joint_kink_bounds(wide, batch, store) if fused \
            else joiner_kink_bounds(store)
        store = {}
        if any(read_counts().values()):
            raise RuntimeError("the f64 run launched a kernel")
        with pre_activation_hooks(det.model, compare("plain")), \
                joint_capture(det.model, store):
            loss_p, grads_p = loss_and_grads(det, batch)
        compare_joint("plain", store)
        if any(read_counts().values()):
            raise RuntimeError("the plain run launched a kernel")
    with pre_activation_hooks(det.model, compare("kernels")), \
            joint_capture(det.model, store):
        kernels = {}
        host_ms, peak_gib = own_peak(device, lambda: kernels.update(
            zip(("loss", "grads"), loss_and_grads(det, batch))))
        loss_k, grads_k = kernels["loss"], kernels["grads"]
    compare_joint("kernels", store)
    del store
    used = read_counts()
    if hook is not None:
        hook.remove()
        if not torch.equal(speaker[0], speaker[1]):
            raise RuntimeError("the ECAPA branch differs between the plain "
                               "and the kernels run")
    grads_f = None
    if fault:
        with planted_fault():
            _, grads_f = loss_and_grads(det, batch)
    torch.cuda.synchronize()
    names = [n for n, _ in det.model.named_parameters()]
    if any(not torch.equal(a.double(), b) for a, b in zip(
            det.model.parameters(), wide.model.parameters())):
        raise RuntimeError("the f64 model's weights are not the f32 ones")
    del wide
    bounds = kink_bounds(seen)
    for key, bound in joint_bounds.items():
        bounds[key] = bounds.get(key, 0.0) + bound
    n_near_joint = int((near_j & inside_j).sum())
    n_joint = int(inside_j.sum())
    del z64j, near_j, inside_j
    loose = [(bounds[n] > 0.5 * GRAD_TIGHT_REL * w.abs().max())
             if n in bounds else torch.zeros_like(w, dtype=torch.bool)
             for n, w in zip(names, grads_w)]
    n_loose = sum(int(m.sum()) for m in loose)
    n_all = sum(m.numel() for m in loose)
    n_near = sum(int(m.sum()) for m in near.values())
    n_pre = sum(m.numel() for m in near.values())

    scales = scale_leaves(names)

    def reading(got, want):
        """(worst tight-held, worst loosely held, line)."""
        tight = held_errors(got, want, loose, False, scales)
        slack = held_errors(got, want, loose, True, scales)
        worst = max(tight)
        return worst, max(slack), (
            f"held tight: worst leaf {names[tight.index(worst)]} "
            f"{worst:.3g}, median {statistics.median(tight):.3g}; held "
            f"loosely: worst {max(slack):.3g}")

    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    check, check_loose, check_line = reading(grads_k, grads_p)
    floor, floor_loose, floor_line = reading(grads_p, grads_w)
    _, _, kernel_line = reading(grads_k, grads_w)
    log(f"dropout 0, {name}, {len(names)} gradient leaves, each error of "
        f"the leaf's max |g|: kernels {used} vs plain: loss "
        f"{loss_k.item():.5f} vs {loss_p.item():.5f} (rel err "
        f"{loss_err:.3g}, tol {loss_rtol}), {check_line} (tol "
        f"{GRAD_TIGHT_REL} tight, {GRAD_ATOL_REL} loosely)")
    log(f"  held loosely: {n_loose} of {n_all} elements (cap "
        f"{KINK_LOOSE_SHARE:.2%}), those whose gradient a flip of the "
        f"{n_near} of {n_pre} pre-activations within |z| < {KINK_Z} of the "
        f"kink in f64 ({len(kinds)} sites), or of the {n_near_joint} of "
        f"the joint's {n_joint} the loss sees (encoder_proj, "
        f"predictor.decoder_proj, transducer_head"
        f"{'' if fused else ', joiner'}), could move by more "
        f"than {0.5 * GRAD_TIGHT_REL:.3g} of the leaf's max |g|")
    log("  pre-activations against f64, max abs err by site: " + "; ".join(
        f"{run} f32 " + ", ".join(f"{k} {v[k]:.3g}" for k in v
                                  if k not in ("flips", "outside"))
        + f"; {v['flips']} on the kink's other side, {v['outside']} of "
        f"them outside |z| < {KINK_Z}" for run, v in z_err.items()))
    log(f"  f32 noise floor, plain f32 vs plain f64 (loss "
        f"{loss_w.item():.5f}): {floor_line}")
    log(f"  kernels f32 vs plain f64: {kernel_line}")
    fault_err = None
    if fault:
        fault_err, _, fault_line = reading(grads_f, grads_p)
        log(f"  planted fault (dp not summed over the batch) vs plain: "
            f"{fault_line}")
    if (loss_err > loss_rtol or check > GRAD_TIGHT_REL
            or check_loose > GRAD_ATOL_REL):
        raise RuntimeError(f"the training step ({name}) with kernels "
                           "differs from the plain version")
    if not floor < GRAD_TIGHT_REL or floor_loose > GRAD_ATOL_REL or (
            fault and not GRAD_TIGHT_REL < fault_err):
        raise RuntimeError(f"the gradient tolerance {GRAD_TIGHT_REL} is not "
                           f"between the f32 noise floor {floor:.3g} and "
                           f"the planted fault {fault_err}")
    if n_loose > KINK_LOOSE_SHARE * n_all or any(
            v["outside"] for v in z_err.values()):
        raise RuntimeError("the kink set does not place the f32 outliers: "
                           f"{n_loose} elements held loosely, flips "
                           f"{z_err}")
    return det, {"loss_err": loss_err, "grad_err": check,
                 "grad_err_loose": check_loose, "floor": floor,
                 "loose": n_loose, "launches": used, "host_ms": host_ms,
                 "peak_gib": peak_gib, "loss": loss_k.item()}


def device_us(e):
    """A kernel total's device time (us)."""
    return e.self_device_time_total


KernelTotal = collections.namedtuple(
    "KernelTotal", "key count self_device_time_total")


def profiled(fn):
    """(wall ms, the device's kernels) of one call of ``fn`` under
    ``torch.profiler`` tracing the device only (CUPTI), the profiler on:
    the kernels by name (``KernelTotal``: launches and device us), read
    from the profiler's raw events. The event tree that ``key_averages``
    builds took 2-4.5 s at 12,000 launches on the card's host, the window
    itself 0.3-0.5 s, and a CPU trace beside the device's 0.2 s more."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    totals = collections.defaultdict(lambda: [0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            totals[e.name()][0] += 1
            totals[e.name()][1] += e.duration_ns()
    return wall_ms, [KernelTotal(k, n, ns / 1e3)
                     for k, (n, ns) in totals.items()]


def device_ms_by_kernel(fn, reps=10):
    """Device time (ms) per call of ``fn``, by kernel, from
    ``torch.profiler`` (CUPTI): what the card spends, without the host's
    launch overhead that CUDA-event timing of back-to-back calls includes
    when the host issues them slower than the card runs them. A kernel's
    time per call is its mean time per launch seen, times its launches
    per call (those seen over ``reps`` calls, rounded): a window that
    drops a launch's event does not read low."""
    import torch

    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            fn()

    return {e.key: device_us(e) / 1e3 / e.count * max(1, round(e.count
                                                               / reps))
            for e in profiled(calls)[1]}


def profile_micro_batch(brain, batch, card):
    """Where the time of one micro-batch's forward + backward goes: device
    time by kernel from ``torch.profiler`` (CUPTI), the lattice kernels'
    share of it, and the device's busy share of the wall time (the
    profiler's own overhead included)."""
    wall_ms, events = profiled(lambda: loss_and_grads(brain, batch))
    if not events:
        log("profile: the profiler saw no device time (not measured)")
        return
    busy_ms = sum(device_us(e) for e in events) / 1e3
    ours = ("relpos", "dq_kernel", "dkv_kernel", "dp_kernel", "rows_kernel",
            "dp_sum", "rnnt_")
    ours_ms = sum(device_us(e) for e in events
                  if any(k in e.key for k in ours)) / 1e3
    n, samples = batch.mixed_sig.data.shape
    log(f"profile {n} x {samples / SAMPLE_RATE:.0f} s forward + backward "
        f"(dropout 0): wall {wall_ms:.1f} "
        f"ms with the profiler on, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.0f} %), {sum(e.count for e in events)} "
        f"kernel launches, the port's own kernels {ours_ms:.1f} ms "
        f"[{card}]")
    for e in sorted(events, key=device_us, reverse=True)[:12]:
        log(f"  {device_us(e) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    by_kernel = ", ".join(
        f"{name} {sum(device_us(e) for e in events if name in e.key) / 1e3:.2f}"
        f" ms x{sum(e.count for e in events if name in e.key)}"
        for name in ("relpos_attention_fwd_kernel", "rows_kernel",
                     "dq_kernel", "dkv_kernel", "dp_kernel", "dp_sum",
                     "rnnt_resident", "rnnt_alpha_slab", "rnnt_beta_slab"))
    lattice_ms = sum(device_us(e) for e in events if "rnnt_" in e.key) / 1e3
    log(f"  the port's kernels: {by_kernel}; the lattice kernels "
        f"{lattice_ms:.3f} ms, {100 * lattice_ms / busy_ms:.2f} % of the "
        f"device time")


def phase_training(device, card):
    import torch
    from tsasr_torch.models.transducer import scratch_config
    from tsasr_torch.utils.stage import Stage

    config = scratch_config()
    brain = make_brain(config, device)
    brain.init_optimizers()
    batches, check_batch, valid = training_batches()
    log(f"training: scratch config, dropout {config.dropout} at "
        f"{config.dropout_bits} bits, accumulation "
        f"{brain.grad_accumulation_factor}, fused joint loss chunk "
        f"{HPARAMS['fused_loss_chunk']}; micro-batches "
        + ", ".join(f"{b.mixed_sig.data.shape[0]} x "
                    f"{b.mixed_sig.data.shape[1] / SAMPLE_RATE:.0f} s "
                    f"(U+1 {b.tokens_bos.data.shape[1]})"
                    for b in batches[:2]))
    start = [p.detach().clone() for p in brain.model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    total, times, per_batch = {}, [], []
    for i, batch in enumerate(batches):
        before = read_counts()
        t0 = time.perf_counter()
        loss = brain.fit_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = read_counts()
        n = {k: after[k] - before[k] for k in after}
        per_batch.append(n)
        slab = i % 2 == 1
        want = {"relpos_attention_fwd": LAYERS_PER_REQUEST,
                "relpos_attention_bwd": LAYERS_PER_REQUEST,
                "rnnt_lattice_resident": 0 if slab else 1,
                "rnnt_lattice_alpha_slab": 1 if slab else 0,
                "rnnt_lattice_beta_slab": 1 if slab else 0}
        changed = any(not torch.equal(p, s) for p, s in
                      zip(brain.model.parameters(), start))
        log(f"micro-batch {i + 1}: loss {loss:.4f}, grad norm "
            f"{brain.last_grad_norm:.4f}, {times[-1] * 1e3:.1f} ms, "
            f"optimizer steps {brain.optimizer_step}, params changed "
            f"{changed}, launches {n}")
        if not (math.isfinite(loss) and math.isfinite(brain.last_grad_norm)):
            raise RuntimeError(f"micro-batch {i + 1} is not finite")
        if n != want:
            raise RuntimeError(f"micro-batch {i + 1} launched {n}, expected "
                               f"{want}")
        if changed != (i + 1 >= brain.grad_accumulation_factor):
            raise RuntimeError(f"parameters changed={changed} after "
                               f"micro-batch {i + 1}")
    counts = read_counts()
    if brain.optimizer_step != MICRO_BATCHES // brain.grad_accumulation_factor:
        raise RuntimeError(f"{brain.optimizer_step} optimizer steps")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    audio = [b.mixed_sig.data.shape[0] * b.mixed_sig.data.shape[1]
             / SAMPLE_RATE for b in batches]
    warm = times[2:]                    # the first of each shape warms up
    step_ms = [sum(times[k:k + 4]) * 1e3 for k in range(0, MICRO_BATCHES, 4)]
    for (n, s), k in zip(TRAIN_BATCHES, (0, 1)):
        shape_ms = [t * 1e3 for j, t in enumerate(times)
                    if j % 2 == k and j >= 2]
        log(f"train micro-batch {n} x {s} s (fwd+bwd+accumulate, warm): "
            f"median {statistics.median(shape_ms):.1f} ms, "
            f"{n * s / statistics.median(shape_ms) * 1e3:.1f} "
            f"padded audio-s/s [{card}]")
    log(f"train: ms per optimizer step (4 micro-batches) "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} (the first includes "
        f"warm-up); training {sum(audio[2:]) / sum(warm):.1f} padded "
        f"audio-s/s over the warm micro-batches; max_memory_allocated "
        f"{peak:.2f} GiB [{card}]")

    # dropout 0: kernels against every kernel forced to its plain version
    det, _ = check_gradients(device, check_batch)
    profile_micro_batch(det, check_batch, card)
    profile_micro_batch(det, batches[1], card)    # 3 x 16 s: the slab pair

    # VALID: one batch of 6 x 8 s, loss and greedy hypotheses
    brain.on_stage_start(Stage.VALID)
    t0 = time.perf_counter()
    vloss = brain.evaluate_batch(valid, Stage.VALID)
    torch.cuda.synchronize()
    vdt = time.perf_counter() - t0
    wer = brain.valid_wer()
    hyps = brain.last_hyps
    log(f"VALID 6 x 8 s: loss {vloss:.4f}, {vdt * 1e3:.1f} ms with greedy "
        f"search, WER {wer['WER']:.1f} over {wer['num_scored_sents']} "
        f"utterances (random weights), first hypothesis "
        f"{' '.join(hyps[0])[:60]!r} [{card}]")
    if not (math.isfinite(vloss) and len(hyps) == 6
            and wer["num_scored_sents"] == 6):
        raise RuntimeError("VALID failed")
    return counts


EXPERIMENT_YAML = "tsasr_torch/hparams/LibriSpeechMix/conformer-t_scratch.yaml"
# six speakers of eight utterances, 24 mixtures a split: each split has
# 48 target utterances of 2-6 s (max_dur 4.5: mixtures of 5 s and more
# in every split, so T 128 and 152 are on the path) in 18-19 dynamic
# batches for VALID and TEST
EXPERIMENT_CORPUS = dict(n_speakers=6, utts_per_speaker=8, n_mix=24,
                         encode_text=True, seed=SEED, max_dur=4.5)
EXPERIMENT_SPLITS = ("train-2mix", "dev-clean-2mix", "test-clean-2mix")
# the TEST files the scratch experiment transcribes from its folder
EXPERIMENT_FILES = 8
# the resumed run's TEST (beam 15 + the n-gram, one utterance a batch):
# the split's first 8 mixtures, 16 utterances (the first run's TEST takes
# all 24)
RESUMED_TEST_MIXTURES = 8


def corpus_vocab(folder):
    """Characters of the corpus + 1: the char tokenizer's vocab size."""
    chars = set()
    for split in EXPERIMENT_SPLITS:
        with open(Path(folder) / f"{split}.jsonl") as f:
            for line in f:
                for text in json.loads(line)["texts"]:
                    chars.update("▁" + text.replace(" ", "▁"))
    return len(chars) + 1


def train_state(brain):
    """The state a checkpoint holds, cloned to the host."""
    return {
        "params": [p.detach().cpu().clone()
                   for p in brain.model.parameters()],
        "moments": [{k: v.detach().cpu().clone() for k, v in st.items()}
                    for st in brain.optimizer.state_dict()["state"].values()],
        "counters": (brain.optimizer_step, brain.global_micro_step,
                     brain._mini_step)}


def same_state(a, b):
    import torch
    return (a["counters"] == b["counters"]
            and len(a["params"]) == len(b["params"])
            and all(torch.equal(x, y) for x, y in zip(a["params"],
                                                      b["params"]))
            and len(a["moments"]) == len(b["moments"])
            and all(x.keys() == y.keys()
                    and all(torch.equal(x[k], y[k]) for k in x)
                    for x, y in zip(a["moments"], b["moments"])))


@contextlib.contextmanager
def counted_batches(brain_class, on_card, layers=LAYERS_PER_REQUEST,
                    bf16=False, lattice=True, train_forward=1):
    """Checks every ``fit_batch`` and ``evaluate_batch`` of the Brains
    built inside: each must launch what its shapes imply (the attention
    forward once per Conformer layer, ``layers`` of them, ``train_forward``
    times at TRAIN (2: remat's recompute), the backward once per layer at
    TRAIN, the lattice once: resident, or the slab pair; none without
    ``lattice``, the banded loss's plain row scan). Yields the
    per-stage launch totals and batch counts, and host-clock readings:
    per TRAIN micro-batch the seconds since the stage began or the last
    micro-batch ended (the loader's ``next()`` and the loop's
    bookkeeping: ``loader_wait_s``) and the seconds in ``fit_batch``;
    per VALID and TEST stage the seconds from its start to the end of
    its last batch. ``bf16``: the attention launches are the bf16
    kernels', and the f32 attention kernels must launch none."""
    from tsasr_torch.kernels.rnnt_lattice import resident_fits
    from tsasr_torch.models.frontend import ConvolutionFrontEnd
    totals = collections.defaultdict(collections.Counter)
    timings = collections.defaultdict(list)
    clock = {}
    fit, evaluate = brain_class.fit_batch, brain_class.evaluate_batch
    stage_start = brain_class.on_stage_start

    def expect(batch, train):
        L = batch.mixed_sig.data.shape[1]
        hop = SAMPLE_RATE // 100
        frames = 1 + L // hop
        frames = -(-frames // 32) * 32                  # pad_feats_to
        t = ConvolutionFrontEnd.output_length(frames)
        u1 = batch.tokens_bos.data.shape[1]
        resident = resident_fits(t, u1)
        want = {"relpos_attention_fwd": layers * (train_forward if train
                                                  else 1),
                "relpos_attention_bwd": layers if train else 0,
                "rnnt_lattice_resident": int(lattice and resident),
                "rnnt_lattice_alpha_slab": int(lattice and not resident),
                "rnnt_lattice_beta_slab": int(lattice and not resident)}
        if bf16:
            want["relpos_attention_fwd_bf16"] = want["relpos_attention_fwd"]
            want["relpos_attention_fwd_bf16_long"] = 0    # T <= 3264
            want["relpos_attention_bwd_bf16"] = want["relpos_attention_bwd"]
            want["relpos_attention_fwd"] = want["relpos_attention_bwd"] = 0
        return want

    count = read_bf16_counts if bf16 else read_counts

    def started(self, stage, *args, **kwargs):
        out = stage_start(self, stage, *args, **kwargs)
        clock["start"] = clock["last"] = time.perf_counter()
        if stage.name != "TRAIN":
            timings[f"{stage.name.lower()}_s"].append(0.0)
        return out

    def checked(run, stage, train):
        def wrapper(self, batch, *args):
            t0 = time.perf_counter()
            before = count()
            out = run(self, batch, *args)
            after = count()
            t1 = time.perf_counter()
            n = {k: after[k] - before[k] for k in after}
            want = expect(batch, train) if on_card else \
                {k: 0 for k in after}
            name = stage(args)
            if n != want:
                raise RuntimeError(
                    f"{name} batch {totals[name]['batches'] + 1} of shape "
                    f"{tuple(batch.mixed_sig.data.shape)} launched {n}, "
                    f"expected {want}")
            totals[name].update(n)
            totals[name]["batches"] += 1
            if train:
                timings["loader_wait_s"].append(t0 - clock["last"])
                timings["fit_batch_s"].append(t1 - t0)
            else:
                timings[f"{name.lower()}_s"][-1] = t1 - clock["start"]
            clock["last"] = time.perf_counter()
            return out
        return wrapper

    brain_class.fit_batch = checked(fit, lambda args: "TRAIN", True)
    brain_class.evaluate_batch = checked(
        evaluate, lambda args: args[0].name, False)
    brain_class.on_stage_start = started
    try:
        yield totals, timings
    finally:
        brain_class.fit_batch, brain_class.evaluate_batch = fit, evaluate
        brain_class.on_stage_start = stage_start


@contextlib.contextmanager
def captured_kernel_calls():
    """Keeps a detached copy of the inputs of the first call of each
    shape that the model gives the attention and lattice wrappers while
    inside; the calls go on to the wrappers, so their launches count as
    the path's. Yields {"attention": {(shape, rate, train): (args, seed,
    scale)}, "lattice": {(B, T, U+1): args}}; ``causal`` in the attention
    key says the call's mask hides the future (a causal encoder's)."""
    import torch
    from tsasr_torch.models import attention
    from tsasr_torch.ops import rnnt_loss, rnnt_loss_fused
    seen = {"attention": {}, "lattice": {}}
    fused, lattice = (attention.fused_relpos_attention,
                      rnnt_loss_fused.rnnt_lattice)

    def copy(x):
        return x.detach().clone() if torch.is_tensor(x) else x

    def attention_call(*args, seed, scale, rate):
        train = torch.is_grad_enabled() and any(
            x.requires_grad for x in args[:5])
        am = args[6]
        causal = am.shape[0] > 1 and bool(am[0, -1] != 0)
        key = (tuple(args[0].shape), rate, train, causal)
        if key not in seen["attention"]:
            seen["attention"][key] = ([copy(x) for x in args], copy(seed),
                                      scale)
        return fused(*args, seed=seed, scale=scale, rate=rate)

    def lattice_call(*args):
        seen["lattice"].setdefault(tuple(args[0].shape),
                                   [copy(x) for x in args])
        return lattice(*args)

    attention.fused_relpos_attention = attention_call
    rnnt_loss.rnnt_lattice = rnnt_loss_fused.rnnt_lattice = lattice_call
    try:
        yield seen
    finally:
        attention.fused_relpos_attention = fused
        rnnt_loss.rnnt_lattice = rnnt_loss_fused.rnnt_lattice = lattice


def check_path_kernels(seen):
    """Each call captured on the experiment's path (one per shape) again
    through the kernel's wrapper, against the plain version on the same
    tensors: the attention forward within ATTN_ATOL of the output's max
    |o| clamped at 1 (dropout at the path's seed and rate: the same
    Philox mask on both sides), at TRAIN also the backward
    (``attention_grad_errors``, a random upstream gradient), and the
    lattice on the route the path took, against the plain version in f32
    and in f64 within ``lattice_rtol``. Returns the worst of each."""
    import torch
    from tsasr_torch.kernels import relpos_attention as ra
    from tsasr_torch.kernels import rnnt_lattice as rl

    gen = torch.Generator().manual_seed(SEED + 13)
    worst = {"fwd": 0.0, "bwd": 0.0, "lattice": 0.0}
    for (shape, rate, train, _), (args, seed, scale) in \
            seen["attention"].items():
        with torch.no_grad():
            got = ra.fused_relpos_attention(*args, seed=seed, scale=scale,
                                            rate=rate)
            want = ra.relpos_attention_reference(*args, scale, seed, rate)
        err = ((got - want).abs().max()
               / want.abs().max().clamp(min=1.0)).item()
        if not (err <= ATTN_ATOL and torch.isfinite(got).all()):
            raise RuntimeError(f"relpos_attention_fwd at the experiment's "
                               f"{shape} rate {rate}: err {err} of max |o| "
                               f"> {ATTN_ATOL}")
        worst["fwd"] = max(worst["fwd"], err)
        if train:
            do = torch.randn(got.shape, generator=gen).to(got.device)
            _, rel_err, _ = attention_grad_errors(args, do, seed, scale,
                                                  rate)
            worst["bwd"] = max(worst["bwd"], rel_err)
    for (b, t, u1), args in seen["lattice"].items():
        got = rl.rnnt_lattice(*args)
        want64 = rl.rnnt_lattice_reference(*as_f64(args))
        rtol = lattice_rtol(want64[0], t, u1)
        err = max(lattice_err(got, rl.rnnt_lattice_reference(*args), rtol),
                  lattice_err(got, want64, rtol))
        if not (err <= 1.0 and all(torch.isfinite(g).all() for g in got)):
            raise RuntimeError(f"rnnt_lattice at the experiment's B{b} T{t} "
                               f"U+1 {u1}: err/tol {err}")
        worst["lattice"] = max(worst["lattice"], err)
    return worst


def write_float_wav(path, wav, sample_rate):
    """A 32-bit IEEE-float WAV, which the port's ``read_audio`` (its
    native decoder) reads back bit for bit, peaks above full scale
    included."""
    import struct
    import numpy as np
    data = np.ascontiguousarray(wav, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, sample_rate, 4 * sample_rate, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 20 + len(fmt) + len(data))
                + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def transcribe_test_split(brain, out, folder, device, card, beam=BEAM_SIZE,
                          layers=LAYERS_PER_REQUEST, limit=None):
    """The experiment folder through ``TSASRTranscriber.from_experiment``
    at ``beam`` (the best checkpoint on WER, the tokenizer, the run's
    LM), each TEST mixture written as a file that reads back exactly and
    transcribed by ``transcribe_file`` with its enrollment file: each
    transcript must be the one the run's TEST recorded (one utterance a
    batch there, so each saw what a file alone sees), each file
    launching the attention kernel once per Conformer layer
    (``layers``). ``limit``: only the first that many TEST files."""
    import numpy as np
    import torch
    from tsasr_torch.data.audio import read_audio
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.recipes.librispeechmix import dataio_prepare

    _, _, test_data = dataio_prepare(vars(brain.hparams), brain.tokenizer)
    folder.mkdir()
    files = {}
    for i in range(min(limit or len(test_data), len(test_data))):
        item = test_data[i]
        path = str(folder / f"mix{i}.wav")
        write_float_wav(path, item["mixed_sig"], SAMPLE_RATE)
        if not np.array_equal(read_audio(path)[0], item["mixed_sig"]):
            raise RuntimeError(f"{path} does not read back exactly")
        files[item["id"]] = (path, test_data.raw(i)["enroll_wav"])
    want = {d["key"]: " ".join(d["hyp_tokens"])
            for d in brain.wer_metric.scores if d["key"] in files}
    tr = TSASRTranscriber.from_experiment(str(out), beam_size=beam,
                                          device=str(device))
    before = read_counts()["relpos_attention_fwd"]
    t0 = time.perf_counter()
    got = {key: tr.transcribe_file(mix, enroll_path=enroll)
           for key, (mix, enroll) in files.items()}
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = read_counts()["relpos_attention_fwd"] - before
    same = sum(got.get(k) == v for k, v in want.items())
    lm = brain.hparams.lm_path
    lm_weight = getattr(tr.searcher, "lm_weight", 0.0)
    log(f"experiment from_experiment (beam {beam}, LM "
        f"{lm and Path(lm).name} at weight {lm_weight}) + transcribe_file "
        f"over the "
        f"{len(files)} TEST files: {dt:.2f} s, {n} attention launches; "
        f"{same}/{len(want)} transcripts identical to the run's TEST "
        f"[{card}]")
    if got != want or n != layers * len(files) * (device.type == "cuda"):
        raise RuntimeError("from_experiment + transcribe_file did not "
                           "reproduce the run's TEST transcripts")


def phase_experiment(device, card, corpus):
    """The scratch experiment on ``corpus`` twice in one output folder: 1
    epoch cut at 2 optimizer steps, then 2 epochs, which recover the
    first's checkpoint, with TEST at the yaml's batched beam 15, in the
    second run with an n-gram LM of the corpus's train transcripts
    (``tsasr_torch.tools.train_ngram_lm``) and one utterance a TEST
    batch; then ``transcribe_test_split``; then every kernel at each
    shape the two runs gave it, on the tensors they gave it, against its
    plain version."""
    import shutil
    import tempfile
    import torch
    from tsasr_torch.recipes.librispeechmix import TSASRBrain, run_experiment
    from tsasr_torch.tools import train_ngram_lm

    root = Path(__file__).resolve().parent
    on_card = device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="tsasr_experiment_") as tmp:
        out = Path(tmp) / "out"

        def argv(epochs, step_limit, *extra, data=corpus):
            args = [str(root / EXPERIMENT_YAML), "--data_folder",
                    str(data), "--output_folder", str(out),
                    "--fused_attention", "True",
                    "--valid_search_freq", "1", "--noprogressbar",
                    "--vocab_size", str(corpus_vocab(corpus)),
                    "--num_epochs", str(epochs),
                    "--optimizer_step_limit", str(step_limit), *extra]
            # the card is the default device: only a rehearsal names one
            return args if on_card else args + ["--device", str(device)]

        resumed_from = []
        fit_train = TSASRBrain._fit_train

        def recording(self, train_set, epoch):
            if not resumed_from:
                resumed_from.append((epoch, train_state(self)))
            return fit_train(self, train_set, epoch)

        reset_counts()
        t0 = time.perf_counter()
        with captured_kernel_calls() as seen, \
                counted_batches(TSASRBrain, on_card) as (first_counts,
                                                         timings):
            first = run_experiment(argv=argv(1, 2))
        first_s = time.perf_counter() - t0
        saved = train_state(first)
        model = first.model
        config = model.config
        n_params = sum(p.numel() for p in model.parameters())
        log_text = (out / "train_log.txt").read_text()
        wer_text = (out / "wer_test-clean-2mix.txt").read_text()
        ckpts = first.checkpointer.list_checkpoints()
        log(f"experiment: run_experiment at d_model {config.d_model}, "
            f"{config.encoder_num_layers}+{config.speaker_encoder_layers} "
            f"layers, d_ffn {config.d_ffn}, {n_params} params, "
            f"fused_attention {config.fused_attention}, on "
            f"{next(model.parameters()).device}; {first_s:.1f} s; batches "
            + ", ".join(f"{k} {v['batches']}"
                        for k, v in first_counts.items())
            + f"; optimizer steps {first.optimizer_step}; checkpoints "
            f"{len(ckpts)}")
        for line in log_text.splitlines():
            log(f"  train_log: {line}")
        if on_card and next(model.parameters()).device.type != "cuda":
            raise RuntimeError("the experiment did not run on the card")
        if not re.search(r"^epoch: 1, .* valid WER: ", log_text, re.M):
            raise RuntimeError("train_log.txt has no epoch line with a "
                               "valid WER")
        if not wer_text.startswith("%WER") or not ckpts:
            raise RuntimeError("no WER file or no checkpoint")
        if first.optimizer_step != 2 or \
                first_counts["TRAIN"]["batches"] != 8:
            raise RuntimeError("the step limit did not stop TRAIN at 2 "
                               "optimizer steps, 8 micro-batches")
        wait = [t * 1e3 for t in timings["loader_wait_s"]]
        step = [t * 1e3 for t in timings["fit_batch_s"]]
        through = [a + b for a, b in zip(wait, step)]
        log(f"experiment TRAIN through the loader: ms per micro-batch "
            f"(loader wait, i.e. next() and the loop's bookkeeping, + "
            f"fit_batch) "
            + ", ".join(f"{x:.1f}" for x in through)
            + f"; warm median {statistics.median(through[2:]):.1f} ms; "
            f"loader wait ms " + ", ".join(f"{x:.2f}" for x in wait)
            + f" (median {statistics.median(wait):.2f}, max "
            f"{max(wait):.2f}) [{card}]")
        log(f"experiment VALID wall {timings['valid_s'][0]:.2f} s over "
            f"{first_counts['VALID']['batches']} batches, TEST wall "
            f"{timings['test_s'][0]:.2f} s over "
            f"{first_counts['TEST']['batches']} batches (the yaml's batched "
            f"beam {first._beam.beam_size}; PR 10's greedy search: "
            f"1.90-2.20 s over 17) [{card}]")
        if not (first._beam.beam_size == BEAM_SIZE
                and type(first._beam).__name__ == "BatchedBeamSearcher"):
            raise RuntimeError(f"TEST searched with {first._beam!r}")
        del first, model

        # an n-gram LM of the train transcripts over the run's tokenizer
        lm_data, arpa = Path(tmp) / "lm_data", Path(tmp) / "corpus.arpa"
        lm_data.mkdir()
        shutil.copy(corpus / "train-2mix.jsonl", lm_data)
        train_ngram_lm.main([
            "--data_folder", str(lm_data), "--tokenizer",
            str(out / "save" / f"char_{corpus_vocab(corpus)}.json"),
            "--out", str(arpa)])

        TSASRBrain._fit_train = recording
        try:
            t0 = time.perf_counter()
            with captured_kernel_calls() as seen_again, \
                    counted_batches(TSASRBrain, on_card) as (
                        second_counts, second_timings):
                second = run_experiment(argv=argv(
                    2, 4, "--lm_path", str(arpa), "--lm_weight",
                    str(LM_WEIGHT), "--test_max_batch_length", "0.5",
                    data=cut_corpus(corpus, Path(tmp) / "resumed_corpus", {
                        EXPERIMENT_SPLITS[2]: RESUMED_TEST_MIXTURES})))
            second_s = time.perf_counter() - t0
        finally:
            TSASRBrain._fit_train = fit_train
        counts = read_counts()
        epoch, start = resumed_from[0]
        added = (out / "train_log.txt").read_text()[len(log_text):]
        recovered = second._recovered_ckpt
        with open(Path(recovered.path) / "counter.ckpt") as f:
            loaded_epoch = json.load(f)["current"]
        steps = re.search(r"^epoch: 2, .*steps: (\d+) ", added, re.M)
        log(f"experiment resumed: {second_s:.1f} s; started at epoch "
            f"{epoch} from optimizer step {start['counters'][0]} "
            f"(saved {saved['counters'][0]}), state bit-identical "
            f"{same_state(start, saved)}; epoch 2 ended at "
            f"{steps and steps.group(1)} steps; TEST loaded the best "
            f"checkpoint on WER, epoch {loaded_epoch}")
        for line in added.splitlines():
            log(f"  train_log: {line}")
        if epoch != 2 or not same_state(start, saved):
            raise RuntimeError("the second run did not recover the saved "
                               "state bit for bit")
        if not steps or steps.group(1) != "4" \
                or f"Epoch loaded: {loaded_epoch}" not in added:
            raise RuntimeError("the second run did not go on from the "
                               "checkpoint")
        log(f"experiment resumed TEST wall {second_timings['test_s'][0]:.2f} "
            f"s over {second_counts['TEST']['batches']} batches of one "
            f"utterance (batched beam {second._beam.beam_size} + the "
            f"n-gram, weight {second._beam.lm_weight}) [{card}]")
        if second._beam.lm_weight != LM_WEIGHT:
            raise RuntimeError("the resumed run's TEST fused no LM")
        # half of the resumed TEST's files: the depth of this path is cut
        # so the whole script keeps to its time budget
        transcribe_test_split(second, out, Path(tmp) / "test_wavs", device,
                              card, limit=EXPERIMENT_FILES)
        path_counts = read_counts()
        del second
    by_batch = {k: sum(c[k] for c in (*first_counts.values(),
                                      *second_counts.values()))
                for k in counts}
    if by_batch != counts:
        raise RuntimeError(f"launches {counts} outside the batches' "
                           f"{by_batch}")
    for kind in seen:
        for key, args in seen_again[kind].items():
            seen[kind].setdefault(key, args)
    worst = check_path_kernels(seen)
    frames = sorted({shape[2] for shape, *_ in seen["attention"]})
    train_frames = sorted({shape[2] for shape, _, train, _ in seen["attention"]
                           if train})
    long = sorted(k for k in seen["lattice"] if k[1] >= 128)
    if max(frames) < 128:
        raise RuntimeError(f"no mixture of 5 s or more on the path: T "
                           f"{frames}")
    log(f"experiment kernels against their plain versions on the path's "
        f"own inputs, one call per shape: attention forward at "
        f"{len(seen['attention'])} shapes (T {frames}), worst err "
        f"{worst['fwd']:.3g} of max |o| (atol {ATTN_ATOL}); backward at "
        f"{sum(train for _, _, train, _ in seen['attention'])} TRAIN shapes "
        f"(T {train_frames}; dropout as on the path), worst "
        f"{worst['bwd']:.3g} of max |g| "
        f"(atol {ATTN_ATOL}); lattice at {len(seen['lattice'])} shapes (B, "
        f"T, U+1: {sorted(seen['lattice'])}; at T 128 and more: {long}), "
        f"worst err/tol {worst['lattice']:.3g} (lattice_rtol, f32 and "
        f"f64)")
    return path_counts


VARIANT_YAMLS = {
    "none": "tsasr_torch/hparams/LibriSpeechMix/conformer-t_none.yaml",
    "pretrained": "tsasr_torch/hparams/LibriSpeechMix/conformer-t_wavlm.yaml"}
# neither variant has a speaker branch: the mixture encoder's 12 layers
VARIANT_LAYERS = 12
# augmentation on the card against the same port code on the CPU, with
# the same draws, on a 6 x 8 s batch (lengths 0.6-1.0, the first full).
# Bounds set before the first run: the waveform (|x| < 1) within 1e-5
# (a 34-tap f32 convolution summed in another order); the features
# (normalized, O(1)) within 1e-5 (the same elementwise f32 ops; the
# batch mean of the fill summed in another order). A mask or warp
# placed one frame off moves features by O(1).
AUG_BATCH = (6, 8)
AUG_WAVE_ATOL = 1e-5
AUG_FEAT_ATOL = 1e-5
# the frozen WavLM on 6 enrollments of 5 s at these length fractions,
# card against CPU: max |e| error over max |e| within 1e-4 (f32 through
# a 7-layer CNN and 12 layers of 768, TF32 off on the card)
WAVLM_ENROLL_FRACS = (1.0, 0.9, 0.8, 0.7, 0.6, 0.5)
WAVLM_RTOL = 1e-4
# None: WavLMConfig()'s published widths (a CPU rehearsal narrows it)
WAVLM_CONFIG = None


def augmentation_checks(device, card, spec_kwargs, speeds):
    """Speed perturbation at each speed and SpecAugment (the warp, the
    frequency masks, the time masks, then the whole) on the card against
    the same functions on the CPU with the same draws; the device time of
    each. Returns the worst errors and the times."""
    import numpy as np
    import torch
    from tsasr_torch.ops import augment
    from tsasr_torch.ops.features import (Fbank, input_normalization,
                                          pad_audio_to_frame_multiple)

    rng = np.random.default_rng(SEED + 21)
    n, seconds = AUG_BATCH
    L = seconds * SAMPLE_RATE
    fracs = np.concatenate([[1.0], rng.uniform(0.6, 1.0, n - 1)])
    wav = (rng.normal(size=(n, L)) * 0.1).astype(np.float32)
    for i, frac in enumerate(fracs):
        wav[i, int(L * frac):] = 0.0
    cpu_wav = torch.from_numpy(wav)
    card_wav = cpu_wav.to(device)
    rel = torch.from_numpy(fracs.astype(np.float32)).to(device)
    errors, times = {}, {}
    for speed in speeds:
        got, factor = augment.apply_speed_perturb(card_wav, speed)
        want, want_factor = augment.apply_speed_perturb(cpu_wav, speed)
        errors[f"speed {speed}"] = (got.cpu() - want).abs().max().item()
        if not (errors[f"speed {speed}"] <= AUG_WAVE_ATOL
                and factor.item() == want_factor.item()
                and torch.isfinite(got).all()):
            raise RuntimeError(f"speed {speed} on the card: waveform err "
                               f"{errors[f'speed {speed}']} (atol "
                               f"{AUG_WAVE_ATOL}), factor {factor.item()} "
                               f"vs {want_factor.item()}")
        if speed != 100:
            times[f"speed {speed}"] = sum(device_ms_by_kernel(
                lambda: augment.apply_speed_perturb(card_wav, speed),
                reps=5).values())

    # the features of the 95 % batch, made as the recipe makes them
    wav95, factor = augment.apply_speed_perturb(card_wav, min(speeds))
    fbank = Fbank(sample_rate=SAMPLE_RATE, n_fft=512, n_mels=80,
                  win_length=32.0).to(device)
    w, r = pad_audio_to_frame_multiple(
        wav95, torch.clamp(rel * factor, max=1.0), 32, SAMPLE_RATE,
        float(fbank.hop_length))
    feats = input_normalization(fbank(w), r)
    cpu_feats = feats.cpu()
    draws = augment.draw_spec_augment(torch.Generator().manual_seed(SEED),
                                      tuple(feats.shape), **spec_kwargs)
    if draws["warp"] is None or draws["freq"] is None \
            or draws["time"] is None:
        raise RuntimeError(f"the yaml's SpecAugment draws {draws} leave a "
                           "part out")
    zero = spec_kwargs["replace_with_zero"]
    parts = {
        "warp": lambda x: augment.apply_time_warp(x, *draws["warp"]),
        "freq masks": lambda x: augment.apply_masks(x, draws["freq"], 2,
                                                    x.mean()),
        "time masks": lambda x: augment.apply_masks(x, draws["time"], 1,
                                                    x.mean()),
        "spec_augment": lambda x: augment.apply_spec_augment(x, draws,
                                                             zero)}
    for name, fn in parts.items():
        got = fn(feats)
        errors[name] = (got.cpu() - fn(cpu_feats)).abs().max().item()
        if not (errors[name] <= AUG_FEAT_ATOL and torch.isfinite(got).all()):
            raise RuntimeError(f"{name} on the card: err {errors[name]} "
                               f"(atol {AUG_FEAT_ATOL})")
        times[name] = sum(device_ms_by_kernel(lambda: fn(feats),
                                              reps=5).values())
    log(f"variants augmentation, card vs CPU on the same draws, "
        f"{n} x {seconds} s (features {tuple(feats.shape)}, warp "
        f"c, w = {draws['warp']}): worst errors "
        + ", ".join(f"{k} {v:.3g}" for k, v in errors.items())
        + f" (atol {AUG_WAVE_ATOL} waveform, {AUG_FEAT_ATOL} features); "
        f"device ms per call " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in times.items())
        + f" [{card}]")
    return errors, times


def wavlm_flops(config, batch, samples):
    """Multiply-adds x 2 of one WavLM x-vector forward over ``batch``
    inputs of ``samples`` samples, by shapes: the CNN, the feature
    projection, the positional conv, the layers' projections, scores and
    FFN, the projector and the TDNN (norms, softmax and the head's
    vectors left out)."""
    flops, length, c_in = 0, samples, 1
    for c_out, k, s in zip(config.conv_dim, config.conv_kernel,
                           config.conv_stride):
        length = (length - k) // s + 1
        flops += 2 * length * c_out * c_in * k
        c_in = c_out
    E, T = config.hidden_size, length
    flops += 2 * T * c_in * E
    flops += 2 * T * E * (E // config.num_conv_pos_embedding_groups) \
        * config.num_conv_pos_embeddings
    flops += config.num_hidden_layers * (
        2 * T * (4 * E * E + 2 * E * config.intermediate_size)
        + 4 * T * T * E)
    flops += 2 * T * E * config.tdnn_dim[0]
    c_in = config.tdnn_dim[0]
    for c_out, k in zip(config.tdnn_dim, config.tdnn_kernel):
        T -= k - 1
        flops += 2 * T * c_out * c_in * k
        c_in = c_out
    return batch * flops


def wavlm_checks(device, card, folder):
    """The frozen WavLM x-vector model at ``WAVLM_CONFIG`` (the published
    widths) on seeded weights: the card against the CPU on 6 enrollments
    of 5 s with unequal lengths, its time per call; then a checkpoint
    directory in HF names (``config.json`` + ``model.safetensors`` from
    the port's writer), which ``FrozenSpeakerEncoder`` loads: its
    embeddings must equal the in-memory module's bit for bit. Returns the
    directory and the readings."""
    import numpy as np
    import torch
    from tsasr_torch.models.wavlm import (WavLMConfig, WavLMForXVector,
                                          save_pretrained_xvector)
    from tsasr_torch.recipes.speaker_embeddings import FrozenSpeakerEncoder

    config = WAVLM_CONFIG or WavLMConfig()
    model = WavLMForXVector(config).init_weights(seed=SEED).eval()
    n_params = sum(p.numel() for p in model.parameters())
    L = ENROLL_SECONDS * SAMPLE_RATE
    rng = np.random.default_rng(SEED + 22)
    lengths = np.array([int(L * f) for f in WAVLM_ENROLL_FRACS])
    wav = (rng.normal(size=(len(lengths), L)) * 0.1).astype(np.float32)
    for i, n in enumerate(lengths):
        wav[i, n:] = 0.0
    cpu_args = (torch.from_numpy(wav), torch.from_numpy(lengths))
    t0 = time.perf_counter()
    with torch.no_grad():
        want = model(*cpu_args)["embeddings"]
    cpu_s = time.perf_counter() - t0
    model.to(device)
    card_args = tuple(x.to(device) for x in cpu_args)
    with torch.no_grad():
        got = model(*card_args)["embeddings"]
        ms = cuda_ms(lambda: model(*card_args), reps=3, rounds=3)
        device_ms = sum(device_ms_by_kernel(lambda: model(*card_args),
                                            reps=3).values())
    err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    flops = wavlm_flops(config, len(lengths), L)
    log(f"variants WavLM x-vector at hidden {config.hidden_size}, "
        f"{config.num_hidden_layers} layers, conv {config.conv_dim[0]} x "
        f"{len(config.conv_dim)}, TDNN {config.tdnn_dim[-1]}, "
        f"{n_params} params (seed {SEED}), 6 x {ENROLL_SECONDS} s "
        f"enrollments: card vs CPU max |e| error {err:.3g} of max |e| "
        f"{want.abs().max().item():.3g} (rtol {WAVLM_RTOL}); "
        f"{ms:.2f} ms per call (events), device {device_ms:.2f} ms; "
        f"{flops:.3g} FLOP by shapes, {flops / device_ms / 1e9:.1f} "
        f"TFLOP/s of device time "
        f"({flops * 1e3 / device_ms / PEAK_F32_FLOP_PER_S:.1%} of the f32 "
        f"peak); the CPU {cpu_s:.2f} s [{card}]")
    if not (err <= WAVLM_RTOL and torch.isfinite(got).all()):
        raise RuntimeError(f"WavLM embeddings on the card: err {err} > "
                           f"{WAVLM_RTOL}")

    t0 = time.perf_counter()
    save_pretrained_xvector(model, str(folder))
    encoder = FrozenSpeakerEncoder(str(folder),
                                   embedding_dim=config.xvector_output_dim,
                                   device=device)
    load_s = time.perf_counter() - t0
    rel = card_args[1].to(torch.float32) / L
    embedded = encoder.embed(card_args[0], rel)
    with torch.no_grad():
        ceil_lengths = torch.clamp(torch.ceil(rel * L), max=L).to(
            torch.int64)
        direct = model(card_args[0], ceil_lengths)["embeddings"][:, None]
    same = torch.equal(embedded, direct)
    size = sum(f.stat().st_size for f in folder.iterdir())
    log(f"variants WavLM checkpoint directory ({size} bytes; written and "
        f"loaded in {load_s:.2f} s): "
        f"FrozenSpeakerEncoder's embeddings bit-identical to the in-memory "
        f"module's {same}")
    if not same:
        raise RuntimeError("the checkpoint directory did not reproduce the "
                           "in-memory WavLM's embeddings bit for bit")
    del model, encoder
    return {"wavlm_ms": ms, "wavlm_device_ms": device_ms, "wavlm_err": err}


@contextlib.contextmanager
def deterministic_algorithms(on):
    """Context: with ``on``, cuDNN's deterministic algorithms and
    ``torch.use_deterministic_algorithms`` (warning, not raising, where an
    operation has no deterministic version). On the card the training
    step is otherwise not reproducible bit for bit: a cuDNN convolution
    backward may sum in another order from one run to the next (the
    frontend's first-block biases read 1e-14 apart after 2 steps). Yields
    the set of the warnings' first lines."""
    import warnings
    import torch
    warned = set()
    if not on:
        yield warned
        return
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield warned
        warned.update(str(w.message).splitlines()[0] for w in caught
                      if "deterministic" in str(w.message))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = cudnn


@contextlib.contextmanager
def timed_embeds(on_card):
    """Times every TRAIN call of ``FrozenSpeakerEncoder.embed`` (those with
    gradients on) made inside: CUDA events around it on the card, no
    sync added, read after the run. Yields a list to which ``ms()`` gives
    the times."""
    import torch
    from tsasr_torch.recipes.speaker_embeddings import FrozenSpeakerEncoder
    embed = FrozenSpeakerEncoder.embed
    marks = []

    def timed(self, *args):
        if not torch.is_grad_enabled():
            return embed(self, *args)
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = embed(self, *args)
            end.record()
            marks.append((start, end))
        else:
            t0 = time.perf_counter()
            out = embed(self, *args)
            marks.append((t0, time.perf_counter()))
        return out

    def ms():
        if on_card:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in marks]
        return [(b - a) * 1e3 for a, b in marks]

    FrozenSpeakerEncoder.embed = timed
    try:
        yield ms
    finally:
        FrozenSpeakerEncoder.embed = embed


def phase_variants(device, card, corpus):
    """The ``none`` and ``pretrained`` recipes through their entry points
    at full width: augmentation and the frozen WavLM each on the card
    against the CPU, a seeded WavLM checkpoint directory, then
    ``run_experiment`` of each variant with the port's yaml copy,
    ``--fused_attention True --augment True``, on ``corpus``, 2 optimizer
    steps, VALID greedy and TEST at ``--beam_size 1`` (the scratch run
    covers beam 15); these two runs give the readings. Then, with
    deterministic algorithms on, another ``pretrained`` run takes an
    intra-epoch checkpoint after its first update; a copy of its folder
    taken there resumes, and its end-of-TRAIN state must equal the
    uninterrupted run's bit for bit with augmentation on. Every batch
    launches what its shapes imply; each kernel is then held against its
    plain version on the runs' own tensors. Returns the launch counts of
    the path."""
    import shutil
    import torch
    from tsasr_torch.recipes import librispeechmix as recipe
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    from tsasr_torch.utils.hparams import load_hyperpyyaml

    root = Path(__file__).resolve().parent
    on_card = device.type == "cuda"
    with open(root / VARIANT_YAMLS["none"]) as f:
        yaml_hp = load_hyperpyyaml(f, {"data_folder": str(corpus)})
    spec_kwargs = recipe.specaugment_kwargs(yaml_hp)
    speeds = recipe.speed_perturb_kwargs(yaml_hp)["speeds"]
    del yaml_hp
    augmentation_checks(device, card, spec_kwargs, speeds)

    with tempfile.TemporaryDirectory(prefix="tsasr_variants_") as tmp:
        tmp = Path(tmp)
        (tmp / "wavlm").mkdir()
        wavlm = wavlm_checks(device, card, tmp / "wavlm")

        def argv(variant, out, *extra):
            args = [str(root / VARIANT_YAMLS[variant]), "--data_folder",
                    str(corpus), "--output_folder", str(out),
                    "--fused_attention", "True", "--augment", "True",
                    "--valid_search_freq", "1", "--noprogressbar",
                    "--vocab_size", str(corpus_vocab(corpus)),
                    "--num_epochs", "1", "--optimizer_step_limit", "2",
                    "--beam_size", "1", *extra]
            if variant == "pretrained":
                args += ["--speaker_encoder_path", str(tmp / "wavlm")]
            return args if on_card else args + ["--device", str(device)]

        ends, copied = [], []
        fit_train = TSASRBrain._fit_train
        maybe_ckpt = TSASRBrain._maybe_intra_epoch_ckpt

        def recording(self, train_set, epoch):
            fit_train(self, train_set, epoch)
            ends.append(train_state(self))

        def copy_first(self):
            maybe_ckpt(self)
            out = Path(self.hparams.output_folder)
            if not copied and self.optimizer_step == 1 \
                    and out.name == "uninterrupted":
                shutil.copytree(out, tmp / "resumed")
                copied.append(self.step)

        runs, nondeterministic = {}, set()
        reset_counts()
        TSASRBrain._fit_train = recording
        TSASRBrain._maybe_intra_epoch_ckpt = copy_first
        try:
            with captured_kernel_calls() as seen:
                for name, variant, extra in (
                        ("none", "none", ()),
                        ("pretrained", "pretrained", ()),
                        ("uninterrupted", "pretrained",
                         ("--ckpt_interval_steps", "1", "--test_splits",
                          "[]")),
                        ("resumed", "pretrained", ("--test_splits", "[]"))):
                    t0 = time.perf_counter()
                    with counted_batches(TSASRBrain, on_card,
                                         VARIANT_LAYERS) as (
                                counts, timings), \
                            timed_embeds(on_card) as embed_ms, \
                            deterministic_algorithms(
                                name in ("uninterrupted", "resumed")) as (
                                warned):
                        brain = recipe.run_experiment(
                            variant, argv(variant, tmp / name, *extra))
                    nondeterministic.update(warned)
                    runs[name] = {
                        "brain": brain, "counts": counts,
                        "timings": timings, "embed_ms": embed_ms(),
                        "s": time.perf_counter() - t0,
                        "log": (tmp / name / "train_log.txt").read_text()}
        finally:
            TSASRBrain._fit_train = fit_train
            TSASRBrain._maybe_intra_epoch_ckpt = maybe_ckpt
        path_counts = read_counts()

        for name in ("none", "pretrained"):
            run = runs[name]
            brain, counts, timings = run["brain"], run["counts"], \
                run["timings"]
            config = brain.model.config
            through = [(a + b) * 1e3 for a, b in zip(
                timings["loader_wait_s"], timings["fit_batch_s"])]
            step_ms = [t * 1e3 for t in timings["fit_batch_s"]]
            embed = run["embed_ms"]
            log(f"variants {name}: run_experiment at d_model "
                f"{config.d_model}, {config.encoder_num_layers} layers, "
                f"injection {config.injection_mode}, speaker encoder "
                f"{type(brain.speaker_encoder).__name__}, "
                f"{sum(p.numel() for p in brain.model.parameters())} "
                f"trained params, on "
                f"{next(brain.model.parameters()).device}; {run['s']:.1f} "
                f"s; batches " + ", ".join(
                    f"{k} {v['batches']}" for k, v in counts.items())
                + f"; optimizer steps {brain.optimizer_step}; cut: 2 "
                f"optimizer steps, VALID greedy, TEST at beam 1 (the "
                f"scratch run covers beam 15)")
            for line in run["log"].splitlines():
                log(f"  train_log: {line}")
            log(f"variants {name} TRAIN through the loader: ms per "
                f"micro-batch " + ", ".join(f"{x:.1f}" for x in through)
                + f"; warm median {statistics.median(through[2:]):.1f} ms"
                + (f"; the frozen WavLM's share of fit_batch (CUDA events "
                   f"around embed, {statistics.median(embed):.2f} ms "
                   f"median): {sum(embed) / sum(step_ms):.3f}"
                   if embed else "")
                + f"; VALID wall {timings['valid_s'][0]:.2f} s over "
                f"{counts['VALID']['batches']} batches, TEST wall "
                f"{timings['test_s'][0]:.2f} s over "
                f"{counts['TEST']['batches']} batches (greedy) [{card}]")
            if brain.optimizer_step != 2 or counts["TRAIN"]["batches"] != 8:
                raise RuntimeError(f"{name}: the step limit did not stop "
                                   "TRAIN at 2 optimizer steps")
            if not re.search(r"^epoch: 1, .* valid WER: ", run["log"], re.M) \
                    or not (tmp / name / "wer_test-clean-2mix.txt").exists():
                raise RuntimeError(f"{name}: no epoch line with a valid WER "
                                   "or no WER file")
            if on_card and next(brain.model.parameters()).device.type \
                    != "cuda":
                raise RuntimeError(f"{name} did not run on the card")
            if (name == "pretrained") != bool(embed) or len(embed) not in (
                    0, 8):
                raise RuntimeError(f"{name}: {len(embed)} frozen encoder "
                                   "calls at TRAIN")
            train = counts["TRAIN"]
            if on_card and not (train["relpos_attention_fwd"]
                                and train["relpos_attention_bwd"]
                                and train["rnnt_lattice_resident"]):
                raise RuntimeError(f"{name}: the attention forward, backward "
                                   f"or the resident lattice was not "
                                   f"launched at TRAIN: {dict(train)}")

        resumed = runs["resumed"]["brain"]
        same = len(ends) == 4 and same_state(ends[3], ends[2])
        log(f"variants pretrained, deterministic algorithms on (cuDNN "
            f"deterministic): a run of 2 optimizer steps and a copy of its "
            f"folder taken at its intra-epoch checkpoint after micro-batch "
            f"{copied}, resumed: "
            f"{runs['resumed']['counts']['TRAIN']['batches']} micro-batches "
            f"trained, to optimizer step {resumed.optimizer_step}; "
            f"end-of-TRAIN state bit-identical to the uninterrupted run's "
            f"{same} ({runs['uninterrupted']['s']:.1f} + "
            f"{runs['resumed']['s']:.1f} s); operations without a "
            f"deterministic version: {sorted(nondeterministic) or 'none'}")
        if copied != [4] or resumed.optimizer_step != 2 \
                or runs["resumed"]["counts"]["TRAIN"]["batches"] != 4:
            raise RuntimeError("the copy did not resume from its intra-epoch "
                               "checkpoint")
        if not same:
            diffs = [(i, (a - b).abs().max().item()) for i, (a, b) in
                     enumerate(zip(ends[3]["params"], ends[2]["params"]))
                     if not torch.equal(a, b)]
            raise RuntimeError(f"the resumed run's state differs from the "
                               f"uninterrupted run's: counters "
                               f"{ends[3]['counters']} vs "
                               f"{ends[2]['counters']}, params (index, max "
                               f"|diff|) {diffs[:5]} of {len(diffs)}")
        by_batch = {k: sum(c[k] for run in runs.values()
                           for c in run["counts"].values())
                    for k in path_counts}
        del runs, resumed, brain
    if by_batch != path_counts:
        raise RuntimeError(f"launches {path_counts} outside the batches' "
                           f"{by_batch}")
    worst = check_path_kernels(seen)
    frames = sorted({shape[2] for shape, *_ in seen["attention"]})
    log(f"variants kernels against their plain versions on the runs' own "
        f"inputs, one call per shape: attention forward at "
        f"{len(seen['attention'])} shapes (T {frames}), worst err "
        f"{worst['fwd']:.3g} of max |o| (atol {ATTN_ATOL}); backward at "
        f"{sum(train for _, _, train, _ in seen['attention'])} TRAIN shapes, "
        f"worst {worst['bwd']:.3g} of max |g| (atol {ATTN_ATOL}); lattice "
        f"at {len(seen['lattice'])} shapes, worst err/tol "
        f"{worst['lattice']:.3g}; launches on the variants' path "
        f"{path_counts}")
    return path_counts


# ------------------------------------------------------------- streaming
# one mixture of this many seconds (5 s enrollment) streams through a
# causal scratch model
STREAM_SECONDS = 12
# encode_stream in chunks of this many feature frames (1 s and 0.32 s)
STREAM_FEATURE_CHUNKS = (100, 32)
# the bounded model's att_context_size (encoder frames, 2.56 s)
STREAM_CONTEXT = 64
# streamed against offline, of the offline output's max |enc|: f32 on
# both sides through 12 layers, the stream's attention in cuBLAS products
# where the offline encode runs the kernel (3xTF32)
STREAM_RTOL = 1e-4
# kv_cache timed at these chunk lengths (s); reencode's 1 s chunks read at
# these seconds of history
KV_CHUNK_SECONDS = (1.0, 0.32)
REENCODE_AT = (4, 8, 12)
# a kv_cache stream whose buffers hold this many seconds must raise past it
OVERFLOW_SECONDS = 2.0
# TEST files of the causal run that ``transcribe --streaming`` takes
STREAM_FILES = 3
# T of the kernels' checks on causal masks: a 4 s and an 8 s encoder
MASK_T = (101, 208)


def causal_am(t, context=0):
    """A causal encoder's ``am_add``: the lookahead mask, and with
    ``context`` the band of ``att_context_size`` as well."""
    import torch
    pos = torch.arange(t)
    hidden = pos[None, :] > pos[:, None]
    if context:
        hidden = hidden | ((pos[:, None] - pos[None, :]) >= context)
    return torch.where(hidden, -1e9, 0.0)


def causal_mask_checks(device):
    """The attention kernels on a causal model's masks against their
    plain versions: the lookahead mask, and lookahead + the
    ``att_context_size`` band, at MASK_T (B8 H4 Dh64, key padding; row 0
    sees one key, most of a row is fill, with the band some padded rows
    see none). The forward at dropout 0 within ATTN_ATOL of max |o|, the
    backward at the training's dropout 0.1 within ATTN_ATOL of each
    gradient's max |g| (``attention_grad_errors``; its reading against
    f64 is wide on the band's rows that see no key, where f64 keeps the
    scores under the -1e9 fill that f32 rounds away)."""
    import torch
    from tsasr_torch.kernels import relpos_attention as ra

    scale = 1.0 / math.sqrt(H * DH)
    gen = torch.Generator().manual_seed(SEED + 21)
    seed = torch.tensor([2024], device=device)
    for t in MASK_T:
        for context in (0, STREAM_CONTEXT):
            args = attention_case(t, False, gen, device)
            args[6] = causal_am(t, context).to(device)
            got = ra.fused_relpos_attention(*args, seed=0, scale=scale,
                                            rate=0.0)
            want = ra.relpos_attention_reference(*args, scale)
            err = ((got - want).abs().max()
                   / want.abs().max().clamp(min=1.0)).item()
            do = torch.randn(got.shape, generator=gen).to(device)
            _, grad_err, wide = attention_grad_errors(args, do, seed, scale,
                                                      0.1)
            name = (f"B{B} H{H} T{t} Dh{DH} lookahead"
                    + (f" + band {context}" if context else "") + " mask")
            log(f"kernel relpos_attention {name}, key padding: forward err "
                f"{err:.3g} of max |o|, backward (dropout 0.1) "
                f"{grad_err:.3g} of max |g| (atol {ATTN_ATOL}); {wide}")
            if not (err <= ATTN_ATOL and torch.isfinite(got).all()):
                raise RuntimeError(f"relpos_attention_fwd on the {name}: "
                                   f"err {err} > {ATTN_ATOL}")


def encode_in_chunks(model, feats, chunk, spk):
    """``encode_stream`` over ``feats`` (1, T, n_mels) in chunks of
    ``chunk`` frames (the last one shorter), T a multiple of 4."""
    import torch
    state = model.init_stream_state(1, feats.shape[1] // 4 + 8,
                                    feats.device)
    outs = []
    for lo in range(0, feats.shape[1], chunk):
        out, state = model.encode_stream(feats[:, lo:lo + chunk], state, spk)
        outs.append(out)
    return torch.cat(outs, dim=1)


def rel_err(got, want):
    """max |got - want| of max |want|."""
    return ((got - want).abs().max() / want.abs().max()).item()


def stream_chunks(streamer, wav, seconds, sync, per_chunk=None):
    """Feed ``wav`` in chunks of ``seconds``, then finalize; returns (the
    host-clock ms of each chunk, each partial, the final transcript).
    ``per_chunk()`` is read after each chunk and listed too."""
    n = int(round(seconds * SAMPLE_RATE))
    times, partials, reads = [], [], []
    for lo in range(0, len(wav), n):
        t0 = time.perf_counter()
        partials.append(streamer.accept_chunk(wav[lo:lo + n]))
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        if per_chunk:
            reads.append(per_chunk())
    final = streamer.finalize()
    sync()
    return times, partials, final, reads


def streaming_experiment(device, card, corpus, tmp):
    """The scratch yaml through ``run_experiment`` as a causal model
    (``--causal_encoder True --frontend_padding causal``, the kernels on),
    2 optimizer steps, VALID greedy, TEST at beam 1; every batch launches
    what its shapes imply, and the attention calls are captured (the
    mixture encoder's with the lookahead mask). Then ``transcribe
    --streaming --enroll`` on STREAM_FILES TEST files, each against the
    same stream built from ``from_experiment`` directly. Returns the
    captured calls."""
    import contextlib
    import io
    import numpy as np
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.recipes.librispeechmix import (TSASRBrain,
                                                    dataio_prepare,
                                                    run_experiment)
    from tsasr_torch.tools import transcribe

    root = Path(__file__).resolve().parent
    on_card = device.type == "cuda"
    out = tmp / "causal"
    args = [str(root / EXPERIMENT_YAML), "--data_folder", str(corpus),
            "--output_folder", str(out), "--fused_attention", "True",
            "--causal_encoder", "True", "--frontend_padding", "causal",
            "--valid_search_freq", "1", "--noprogressbar",
            "--vocab_size", str(corpus_vocab(corpus)), "--num_epochs", "1",
            "--optimizer_step_limit", "2", "--beam_size", "1"]
    if not on_card:
        args += ["--device", str(device)]
    t0 = time.perf_counter()
    with captured_kernel_calls() as seen, \
            counted_batches(TSASRBrain, on_card) as (counts, timings):
        brain = run_experiment(argv=args)
    run_s = time.perf_counter() - t0
    config = brain.model.config
    log_text = (out / "train_log.txt").read_text()
    through = [(a + b) * 1e3 for a, b in zip(timings["loader_wait_s"],
                                             timings["fit_batch_s"])]
    log(f"streaming: causal run_experiment (causal_encoder "
        f"{config.causal_encoder}, frontend_causal {config.frontend_causal}"
        f" from --frontend_padding causal, fused_attention "
        f"{config.fused_attention}) at d_model {config.d_model}, "
        f"{config.encoder_num_layers}+{config.speaker_encoder_layers} "
        f"layers, on {next(brain.model.parameters()).device}; {run_s:.1f} s;"
        f" batches " + ", ".join(f"{k} {v['batches']}"
                                 for k, v in counts.items())
        + f"; optimizer steps {brain.optimizer_step}; TRAIN ms per "
        f"micro-batch through the loader " + ", ".join(
            f"{x:.1f}" for x in through)
        + f", warm median {statistics.median(through[2:]):.1f}; VALID "
        f"wall {timings['valid_s'][0]:.2f} s, TEST wall "
        f"{timings['test_s'][0]:.2f} s (beam 1) [{card}]")
    for line in log_text.splitlines():
        log(f"  train_log: {line}")
    if not (config.causal_encoder and config.frontend_causal):
        raise RuntimeError("the run's model is not causal")
    if brain.optimizer_step != 2 or counts["TRAIN"]["batches"] != 8 \
            or not re.search(r"^epoch: 1, .* valid WER: ", log_text, re.M):
        raise RuntimeError("the causal run did not train 2 optimizer steps "
                           "and validate")
    if on_card and not any(causal and train
                           for _, _, train, causal in seen["attention"]):
        raise RuntimeError("no attention call at TRAIN had the lookahead "
                           "mask")

    _, _, test_data = dataio_prepare(vars(brain.hparams), brain.tokenizer)
    del brain
    (tmp / "stream_wavs").mkdir()
    tr = TSASRTranscriber.from_experiment(str(out), device=str(device))
    same = 0
    for i in range(STREAM_FILES):
        item = test_data[i]
        mix = str(tmp / "stream_wavs" / f"mix{i}.wav")
        write_float_wav(mix, item["mixed_sig"], SAMPLE_RATE)
        enroll = test_data.raw(i)["enroll_wav"]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            transcribe.main(["--experiment", str(out), mix, "--streaming",
                             "--enroll", enroll]
                            + ([] if on_card else ["--device", str(device)]))
        got = json.loads(printed.getvalue())["text"]
        streamer = tr.streaming(speaker_embs=tr.speaker_embedding(
            transcribe.read_resampled(enroll, SAMPLE_RATE)))
        _, _, want, _ = stream_chunks(streamer, np.asarray(
            item["mixed_sig"], np.float32), 1.0, lambda: None)
        same += got == want
        log(f"  transcribe --streaming --enroll {Path(enroll).name} "
            f"{item['id']} ({len(item['mixed_sig']) / SAMPLE_RATE:.2f} s): "
            f"{got!r}; the same stream from from_experiment: "
            f"{'identical' if got == want else repr(want)}")
    if same != STREAM_FILES:
        raise RuntimeError("transcribe --streaming differs from the stream "
                           "of from_experiment")
    return seen


def phase_streaming(device, card, corpus):
    """Streaming transcription of the scratch recipe's model made causal
    (``causal_encoder``, ``frontend_causal``, fused attention; seeded)
    on one STREAM_SECONDS mixture with a 5 s enrollment: (a) the offline
    encode launches the attention kernel 18 times and matches the plain
    path; (b) ``encode_stream`` in chunks of 100 and 32 feature frames
    matches it; (c) the same with att_context_size 64; (d) the kv_cache
    streamer's tokens equal offline greedy on unnormalized features and
    the same streamer's on the CPU; (e) the reencode streamer's final
    transcript starts with its last partial; (f) timings; (g) a stream
    past kv_capacity_seconds raises; (h) a causal ``run_experiment`` and
    ``transcribe --streaming``. The kernels are held on causal masks
    before, and on the run's own tensors after, the main path. Returns
    the path's launch counts."""
    import copy
    import numpy as np
    import torch
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_torch.decoding import TransducerGreedySearcher
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.models.transducer import TSTransducer, scratch_config
    from tsasr_torch.ops.features import input_normalization

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    causal_mask_checks(device)

    rng = np.random.default_rng(SEED + 3)
    wav = (rng.normal(size=STREAM_SECONDS * SAMPLE_RATE) * 0.1
           ).astype(np.float32)
    enroll = (rng.normal(size=ENROLL_SECONDS * SAMPLE_RATE) * 0.1
              ).astype(np.float32)
    config = scratch_config(causal_encoder=True, frontend_causal=True)
    model = TSTransducer(config).init_weights(seed=SEED)
    tr = TSASRTranscriber(model, None, CharTokenizer(PIECES),
                          device=str(device))
    ones = torch.ones(1, device=device)
    fwd = lambda: read_counts()["relpos_attention_fwd"]  # noqa: E731
    tr.encode_batch([wav], [enroll])          # warm-up, not counted
    sync()

    reset_counts()
    with torch.inference_mode():
        # (a) the offline causal encode, kernels against plain
        t0 = time.perf_counter()
        enc, _ = tr.encode_batch([wav], [enroll])
        sync()
        enc_ms = (time.perf_counter() - t0) * 1e3
        n_offline = fwd()
        set_fused(tr.model, False)
        plain, _ = tr.encode_batch([wav], [enroll])
        set_fused(tr.model, True)
        err = (enc - plain).abs().max().item()
        peak = enc.abs().max().item()
        log(f"streaming: causal scratch model ({config.encoder_num_layers}"
            f"+{config.speaker_encoder_layers} layers, d_model "
            f"{config.d_model}); (a) offline encode of {STREAM_SECONDS} s "
            f"+ {ENROLL_SECONDS} s enrollment: {enc_ms:.1f} ms, "
            f"{n_offline} attention launches, shape {tuple(enc.shape)}; "
            f"kernels vs plain max_abs_err {err:.3g} (atol {ENC_ATOL}), max "
            f"|enc| {peak:.3g} [{card}]")
        if n_offline != LAYERS_PER_REQUEST * on_card or err > ENC_ATOL \
                or not torch.isfinite(enc).all():
            raise RuntimeError("the causal offline encode failed its check")

        # (b) encode_stream against (a)'s offline encode
        spk = tr.speaker_embedding(enroll)
        feats = input_normalization(tr.fbank(
            torch.from_numpy(wav)[None].to(device)), ones)
        t4 = feats.shape[1] // 4 * 4
        n_enc = t4 // 4
        for chunk in STREAM_FEATURE_CHUNKS:
            streamed = encode_in_chunks(tr.model, feats[:, :t4], chunk, spk)
            err = rel_err(streamed, enc[:, :n_enc])
            log(f"streaming (b) encode_stream in chunks of {chunk} feature "
                f"frames, {n_enc} frames: err {err:.3g} of max |enc| "
                f"(rtol {STREAM_RTOL})")
            if streamed.shape != enc[:, :n_enc].shape or err > STREAM_RTOL:
                raise RuntimeError(f"encode_stream in chunks of {chunk} "
                                   f"differs from the offline encode: {err}")

        # (c) a bounded context: its offline encode, kernels against plain,
        # and its stream
        bounded = TSTransducer(scratch_config(
            causal_encoder=True, frontend_causal=True,
            att_context_size=STREAM_CONTEXT))
        bounded.load_state_dict(tr.model.state_dict())
        bounded = bounded.to(device).eval()
        before = fwd()
        enc_b = bounded.encode(feats, ones, spk)
        n_bounded = fwd() - before
        set_fused(bounded, False)
        err_plain = (enc_b - bounded.encode(feats, ones, spk)
                     ).abs().max().item()
        errs = [rel_err(encode_in_chunks(bounded, feats[:, :t4], chunk, spk),
                        enc_b[:, :n_enc])
                for chunk in STREAM_FEATURE_CHUNKS]
        moved = rel_err(enc_b, enc)
        log(f"streaming (c) att_context_size {STREAM_CONTEXT}: offline "
            f"{n_bounded} attention launches, kernels vs plain "
            f"max_abs_err {err_plain:.3g} (atol {ENC_ATOL}); encode_stream "
            f"in chunks of {STREAM_FEATURE_CHUNKS}: err "
            + ", ".join(f"{e:.3g}" for e in errs)
            + f" of max |enc| (rtol {STREAM_RTOL}); against the unbounded "
            f"encode {moved:.3g}")
        if n_bounded != config.encoder_num_layers * on_card \
                or err_plain > ENC_ATOL or max(errs) > STREAM_RTOL \
                or moved < 1e-3:
            raise RuntimeError("the bounded-context encode failed its check")
        del bounded, enc_b

        # (d) kv_cache tokens against offline greedy (unnormalized
        # features) and against the CPU
        raw = tr.fbank(torch.from_numpy(wav)[None].to(device))
        t4_raw = raw.shape[1] // 4 * 4
        offline_tokens = TransducerGreedySearcher(tr.model, 0)(
            tr.model.encode(raw[:, :t4_raw], ones, spk), ones)[0][0]
    kv = tr.streaming("kv_cache", speaker_embs=spk)
    before = fwd()
    kv_times, kv_partials, kv_final, _ = stream_chunks(kv, wav, 1.0, sync)
    kv_tokens = list(kv._tokens)
    cpu_model = copy.deepcopy(tr.model).cpu()
    cpu_tr = TSASRTranscriber(cpu_model, None, tr.tokenizer, device="cpu")
    cpu_kv = cpu_tr.streaming("kv_cache", speaker_embs=spk.cpu())
    stream_chunks(cpu_kv, wav, 1.0, lambda: None)
    log(f"streaming (d) kv_cache in 1 s chunks: {len(kv_tokens)} tokens; "
        f"offline greedy on the unnormalized features ({t4_raw} frames): "
        f"identical {kv_tokens == offline_tokens}; the same streamer on the "
        f"CPU: identical {kv_tokens == cpu_kv._tokens}; final "
        f"{kv_final[:60]!r}")
    if not kv_tokens or kv_tokens != offline_tokens \
            or kv_tokens != cpu_kv._tokens or fwd() != before:
        raise RuntimeError("kv_cache tokens differ from offline greedy or "
                           "from the CPU's (or the stream launched the "
                           "offline kernel)")
    del cpu_model, cpu_tr, cpu_kv

    # (e) reencode: each 1 s chunk re-encodes the history (12 launches)
    rs = tr.streaming("reencode", speaker_embs=spk)
    start = fwd()
    re_times, re_partials, re_final, re_reads = stream_chunks(
        rs, wav, 1.0, sync, fwd)
    re_launches = [b - a for a, b in zip([start] + re_reads[:-1], re_reads)]
    log(f"streaming (e) reencode in 1 s chunks: {len(rs._tokens)} tokens, "
        f"attention launches per chunk {sorted(set(re_launches))}; the "
        f"final transcript starts with the last partial "
        f"{re_final.startswith(re_partials[-1])}")
    if not re_final.startswith(re_partials[-1]) or not rs._tokens \
            or set(re_launches) != {config.encoder_num_layers * on_card}:
        raise RuntimeError("reencode streaming failed its check")

    # (f) timings: kv_cache at 1 s and 0.32 s chunks, then once more
    # under the profiler for the device time and the launches
    for seconds in KV_CHUNK_SECONDS:
        kv.reset()
        times, _, _, _ = stream_chunks(kv, wav, seconds, sync)
        tokens_same = kv._tokens == kv_tokens
        line = (f"streaming (f) kv_cache {seconds} s chunks over "
                f"{STREAM_SECONDS} s: host ms per chunk median "
                f"{statistics.median(times):.2f} (max {max(times):.2f}, "
                f"first {times[0]:.2f}); real-time factor "
                f"{sum(times) / 1e3 / STREAM_SECONDS:.4f}; tokens as at 1 s "
                f"{tokens_same}")
        if on_card:
            kv.reset()
            wall_ms, events = profiled(
                lambda: stream_chunks(kv, wav, seconds, sync))
            busy = sum(device_us(e) for e in events) / 1e3
            launches = sum(e.count for e in events)
            line += (f"; under the profiler: wall {wall_ms:.1f} ms, device "
                     f"busy {busy:.2f} ms ({100 * busy / wall_ms:.1f} %), "
                     f"{busy / len(times):.3f} ms and "
                     f"{launches / len(times):.0f} kernel launches per "
                     f"chunk")
        log(line + f" [{card}]")
        if not tokens_same:
            raise RuntimeError(f"kv_cache at {seconds} s chunks gave other "
                               "tokens than at 1 s")
    log("streaming (f) reencode 1 s chunks: host ms per chunk at "
        + ", ".join(f"{s} s of history {re_times[s - 1]:.2f}"
                    for s in REENCODE_AT)
        + f"; real-time factor {sum(re_times) / 1e3 / STREAM_SECONDS:.4f} "
        f"[{card}]")

    # (g) a stream past its KV capacity raises
    small = tr.streaming("kv_cache", speaker_embs=spk,
                         kv_capacity_seconds=OVERFLOW_SECONDS)
    try:
        stream_chunks(small, wav, 1.0, sync)
    except RuntimeError as e:
        if "KV cache overflow" not in str(e):
            raise
        log(f"streaming (g) kv_capacity_seconds {OVERFLOW_SECONDS} "
            f"({small.kv_capacity} frames): raised after "
            f"{small._feat_frames_done / 100:.2f} s of features: {e}")
    else:
        raise RuntimeError("a stream past its KV capacity did not raise")
    del kv, rs, small, tr, model

    # (h) a causal run through run_experiment, transcribe --streaming
    with tempfile.TemporaryDirectory(prefix="tsasr_streaming_") as tmp:
        seen = streaming_experiment(device, card, corpus, Path(tmp))
    path_counts = read_counts()
    worst = check_path_kernels(seen)
    causal = sorted({(shape[2], train) for shape, _, train, causal in
                     seen["attention"] if causal})
    log(f"streaming kernels against their plain versions on the causal "
        f"run's own inputs, one call per shape: attention forward at "
        f"{len(seen['attention'])} shapes, with the lookahead mask at (T, "
        f"TRAIN) {causal}, worst err {worst['fwd']:.3g} of max |o|; "
        f"backward worst {worst['bwd']:.3g} of max |g| (atol {ATTN_ATOL}); "
        f"lattice at {len(seen['lattice'])} shapes, worst err/tol "
        f"{worst['lattice']:.3g}; launches on the streaming path "
        f"{path_counts}")
    return path_counts


# ------------------------------------------------------------------ bf16
# the bf16 kernels at the serving and training lengths, on each mask the
# paths give them
BF16_T = (101, 208, 408)
BF16_MASKS = ("key padding", "causal", "causal band 64")
# the bf16 kernels' times: the forward at B8 at BF16_T and at the
# training buckets' own batches (6 x 8 s, 3 x 16 s), the backward at B8
# at the buckets' lengths (the script's time budget)
BF16_TIME_SHAPES = tuple((B, t) for t in BF16_T) + ((6, 208), (3, 408))
BF16_BWD_TIME_T = (208, 408)
BF16_RATE = 0.1
# a bf16 kernel against its plain bf16 version on the same inputs: both
# round at the JAX kernels' points, but sum in other orders, so a value
# near a rounding boundary lands an ulp apart (one ulp at the top of the
# range is at most 2^-7 of max |o|)
BF16_FWD_TOL = 2.0 ** -7          # of max |o|
BF16_BWD_TOL = 2.0 ** -6          # of each gradient's max |g|
# and against the same function in f64: no worse than the plain version
BF16_F64_RATIO = 1.5
# the full-width model in bf16 against f32 on the same weights, dropout 0
BF16_LOSS_RTOL = 2e-2
BF16_GRAD_COSINE = 0.99
BF16_TURNS = 2                    # micro-batches per precision and shape


def attention_bf16_bound(b, h, t, dh):
    """The bf16 forward: bf16 operands and output, f32 masks; the three
    products at the bf16 tensor-core peak (plus ~6 ops per score)."""
    n_bytes = (2 * (5 * b * h * t * dh + h * (2 * t - 1) * dh)
               + 4 * (b * t + t * t))
    return bound(n_bytes, 6 * b * h * t * t * dh + 6 * b * h * t * t,
                 PEAK_BF16_FLOP_PER_S)


def attention_bf16_bwd_bound(b, h, t, dh):
    """The bf16 backward: read q_u, q_v, k, v, do and p in bf16, the row
    statistics and the masks in f32; write dq_u, dq_v, dk, dv and dp in
    bf16; 16 B H T^2 Dh of products at the bf16 peak (plus ~10 ops per
    score)."""
    n_bytes = (2 * (9 * b * h * t * dh + 2 * h * (2 * t - 1) * dh)
               + 4 * (2 * b * h * t + b * t + t * t))
    return bound(n_bytes, 16 * b * h * t * t * dh + 10 * b * h * t * t,
                 PEAK_BF16_FLOP_PER_S)


def bf16_case(t, mask, gen, device, b=B):
    """``attention_case`` with bf16 operands and the f32 masks of
    ``mask``: key padding only, or the causal lookahead, or lookahead
    and an ``att_context_size`` band of 64."""
    import torch
    args = attention_case(t, False, gen, device, b)
    if mask != "key padding":
        args[6] = causal_am(t, 64 if "band" in mask else 0).to(device)
    return [x.to(torch.bfloat16) for x in args[:5]] + args[5:]


def bf16_attention_errors(args, do, seed, scale, rate, what,
                          backward=True):
    """A bf16 kernel pair on ``args`` against the plain bf16 version and
    the same function in f64: the forward within BF16_FWD_TOL of the
    plain max |o| and each gradient within BF16_BWD_TOL of its max |g|,
    and the kernels' error against f64 at most BF16_F64_RATIO times the
    plain version's. Returns (forward err, worst gradient err, worst
    kernel / plain ratio against f64); ``backward`` False checks the
    forward alone."""
    import torch
    from tsasr_torch.kernels import relpos_attention as ra
    res = {}
    for name, fn, dtype in (
            ("kernel", ra.fused_relpos_attention, None),
            ("plain", ra.relpos_attention_reference, None),
            ("f64", ra.relpos_attention_reference, torch.float64)):
        leaves = [(x if dtype is None else x.to(dtype)).requires_grad_(
                      backward and i < 5) for i, x in enumerate(args)]
        with torch.set_grad_enabled(backward):
            out = fn(*leaves, seed=seed, scale=scale, rate=rate)
        grads = torch.autograd.grad(out, leaves[:5], do if dtype is None
                                    else do.to(dtype)) if backward else ()
        res[name] = [out.detach(), *grads]

    def err(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp(min=1e-30)).item()

    names = ("out", "dq_u", "dq_v", "dk", "dv", "dp")[:len(res["kernel"])]
    worst_fwd = worst_bwd = worst_ratio = 0.0
    for i, name in enumerate(names):
        k, p, f = res["kernel"][i], res["plain"][i], res["f64"][i]
        e_kp, e_kf, e_pf = err(k, p), err(k, f), err(p, f)
        tol = BF16_FWD_TOL if i == 0 else BF16_BWD_TOL
        if not (e_kp <= tol and torch.isfinite(k).all()):
            raise RuntimeError(f"{what} {name}: err {e_kp:.3g} of the plain "
                               f"bf16 version's max > {tol:.3g}")
        if e_kf > BF16_F64_RATIO * e_pf + 1e-7:
            raise RuntimeError(f"{what} {name}: err against f64 {e_kf:.3g} "
                               f"> {BF16_F64_RATIO} x the plain version's "
                               f"{e_pf:.3g}")
        if i == 0:
            worst_fwd = e_kp
        else:
            worst_bwd = max(worst_bwd, e_kp)
        worst_ratio = max(worst_ratio, e_kf / max(e_pf, 1e-30))
    return worst_fwd, worst_bwd, worst_ratio


def bf16_kernel_checks(device):
    """(a) each bf16 kernel against its plain bf16 version and f64, the
    forward and the backward, dropout 0.1, on each of BF16_MASKS at each
    of BF16_T (B8 H4 Dh64), then the forward's long route
    (``bf16_long_route_check``, whose result it returns)."""
    import torch
    scale = 1.0 / math.sqrt(H * DH)
    gen = torch.Generator().manual_seed(SEED + 21)
    seed = torch.tensor([2024], device=device)
    for t in BF16_T:
        for mask in BF16_MASKS:
            args = bf16_case(t, mask, gen, device)
            do = torch.randn(B, H, t, DH, generator=gen).to(device).to(
                torch.bfloat16)
            what = f"bf16 kernels B{B} H{H} T{t} Dh{DH} {mask}"
            fwd, bwd, ratio = bf16_attention_errors(args, do, seed, scale,
                                                    BF16_RATE, what)
            log(f"{what} dropout {BF16_RATE}: forward err {fwd:.3g} of max "
                f"|o| (tol {BF16_FWD_TOL:.3g}), backward worst {bwd:.3g} "
                f"of max |g| (tol {BF16_BWD_TOL:.3g}), against f64 at most "
                f"{ratio:.3f} x the plain bf16 version's error (limit "
                f"{BF16_F64_RATIO})")
    return bf16_long_route_check(device, gen, seed, scale)


def bf16_long_route_check(device, gen, seed, scale):
    """The bf16 forward's long route (the two-pass kernel) at the
    smallest T that takes it, B1 H4 Dh64, key padding, dropout 0.1, and
    the backward through it, held as ``bf16_kernel_checks`` holds the
    resident route; one launch counted on the long route and none on the
    resident one. Returns that T, the forward's error and the long
    route's launches there."""
    import torch
    from tsasr_torch.kernels import relpos_attention as ra
    t = ra.bf16_fwd_max_t(DH) + 1
    args = bf16_case(t, "key padding", gen, device, b=1)
    do = torch.randn(1, H, t, DH, generator=gen).to(device).to(
        torch.bfloat16)
    what = f"bf16 kernels, the forward's long route, B1 H{H} T{t} Dh{DH}"
    before = (ra.bf16_launches, ra.bf16_long_launches)
    fwd, bwd, ratio = bf16_attention_errors(args, do, seed, scale,
                                            BF16_RATE, what)
    launched = (ra.bf16_launches - before[0],
                ra.bf16_long_launches - before[1])
    log(f"{what} key padding dropout {BF16_RATE}: forward err {fwd:.3g} of "
        f"max |o| (tol {BF16_FWD_TOL:.3g}), backward worst {bwd:.3g} of max "
        f"|g| (tol {BF16_BWD_TOL:.3g}), against f64 at most {ratio:.3f} x "
        f"the plain bf16 version's error (limit {BF16_F64_RATIO}); "
        f"launches resident / long {launched}")
    if device.type == "cuda" and launched != (0, 1):
        raise RuntimeError(f"T{t} launched resident / long {launched}, "
                           "expected (0, 1)")
    del args, do
    torch.cuda.empty_cache()
    return {"T": t, "err": fwd, "launches": launched[1]}


def device_ms_seen(fn, tries=12):
    """``device_ms_by_kernel`` again when a profiler window saw no device
    event (a process that has opened many windows loses events: see
    ``bf16_kernel_times_apart``); {} after ``tries`` empty windows."""
    for _ in range(tries):
        seen = device_ms_by_kernel(fn)
        if seen:
            return seen
    return {}


def device_ms_median(fn, windows=3, tries=12):
    """The median over ``windows`` profiler windows that saw a device
    event of ``fn``'s device time per call (ms, its kernels summed), up
    to ``tries`` windows opened; raises if fewer saw one."""
    seen = []
    for _ in range(tries):
        ms = sum(device_ms_seen(fn, tries=1).values())
        if ms > 0:
            seen.append(ms)
            if len(seen) == windows:
                return statistics.median(seen)
    raise RuntimeError(f"{len(seen)} of {tries} profiler windows saw a "
                       "device event")


def bf16_kernel_times(device, card):
    """(b1) the bf16 kernels at BF16_TIME_SHAPES (H4 Dh64, key padding,
    dropout 0): CUDA events and profiler device time (the median of three
    windows that saw the kernel), the f32 kernels on the same values in
    turns (bf16, f32, f32, bf16), the plain bf16 versions, SDPA in bf16
    given the pre-shifted bias, and the bound at the bf16 peak; the
    backward at B8 and BF16_BWD_TIME_T only. Returns (forward rows,
    backward rows)."""
    import torch
    import torch.nn.functional as F
    from tsasr_torch.kernels import relpos_attention as ra
    scale = 1.0 / math.sqrt(H * DH)
    gen = torch.Generator().manual_seed(SEED + 22)
    fwd_rows, bwd_rows = [], []
    for n, t in BF16_TIME_SHAPES:
        a16 = bf16_case(t, "key padding", gen, device, n)
        a32 = [x.float() for x in a16[:5]] + a16[5:]
        qu, qv, k, v, p, kp, am = a16
        bias = (ra.rel_shift(torch.einsum("bhtd,hsd->bhts", qv, p), t)
                * scale + am + kp[:, None, None, :]).to(torch.bfloat16)
        with torch.no_grad():
            err = ((ra.fused_relpos_attention(*a16, seed=0, scale=scale,
                                              rate=0.0).double()
                    - ra.relpos_attention_reference(*a16, scale).double())
                   .abs().max().item())

        def fwd(args):
            return lambda: ra._launch_fwd(*args, 0, scale, 0.0, False)

        turns = [cuda_ms(fn) for fn in (fwd(a16), fwd(a32), fwd(a32),
                                        fwd(a16))]
        ms = (turns[0] + turns[3]) / 2
        plain_ms = cuda_ms(lambda: ra.relpos_attention_reference(*a16,
                                                                 scale))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qu, k, v, attn_mask=bias, scale=scale))
        dev = [device_ms_median(fn)
               for fn in (fwd(a16), fwd(a32), lambda: (
                   F.scaled_dot_product_attention(qu, k, v, attn_mask=bias,
                                                  scale=scale)))]
        bound_ms, bound_by = attention_bf16_bound(n, H, t, DH)
        fwd_rows.append(dict(B=n, T=t, err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, device_ms=dev[0],
                             library_device_ms=dev[2], bound_ms=bound_ms,
                             bound_by=bound_by))
        log(f"kernel relpos_attention_fwd_bf16 B{n} H{H} T{t} Dh{DH}: "
            f"CUDA events bf16 {turns[0]:.4f} / {turns[3]:.4f} ms, f32 "
            f"{turns[1]:.4f} / {turns[2]:.4f} ms (in turns), plain bf16 "
            f"{plain_ms:.4f} ms, SDPA bf16 {lib_ms:.4f} ms (given the "
            f"bias); device time (profiler) bf16 {dev[0]:.4f} ms, f32 "
            f"{dev[1]:.4f} ms, SDPA {dev[2]:.4f} ms; bound {bound_ms:.5f} ms "
            f"by {bound_by} (bf16 peak); max_abs_err {err:.3g} [{card}]")
        if n != B or t not in BF16_BWD_TIME_T:
            continue

        do16 = torch.randn(B, H, t, DH, generator=gen).to(device).to(
            torch.bfloat16)
        do32 = do16.float()
        outs = {}
        for name, args in (("bf16", a16), ("f32", a32)):
            outs[name] = ra._launch_fwd(*args, 0, scale, 0.0, True)[:2]
        grads = []
        for fn in (ra.fused_relpos_attention, ra.relpos_attention_reference):
            leaves = [x.clone().requires_grad_(i < 5)
                      for i, x in enumerate(a16)]
            out = fn(*leaves, seed=0, scale=scale, rate=0.0)
            grads.append(torch.autograd.grad(out, leaves[:5], do16))
        berr = max((a.double() - b.double()).abs().max().item()
                   for a, b in zip(*grads))

        def bwd(args, name, do):
            out, stats = outs[name]
            return lambda: ra._launch_bwd(*args, out, stats, do, None,
                                          scale, 0.0)

        turns = [cuda_ms(fn) for fn in (bwd(a16, "bf16", do16),
                                        bwd(a32, "f32", do32),
                                        bwd(a32, "f32", do32),
                                        bwd(a16, "bf16", do16))]
        bms = (turns[0] + turns[3]) / 2
        plain_bwd_ms = cuda_ms(lambda: ra.relpos_attention_bwd_bf16(
            *a16, do16, scale), reps=10)
        sq, sk, sv = (x.clone().requires_grad_() for x in (qu, k, v))

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=bias,
                                               scale=scale)
            torch.autograd.grad(o, (sq, sk, sv), do16)

        with torch.no_grad():
            sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=bias, scale=scale))
        lib_bwd_ms = cuda_ms(sdpa_fwd_bwd, reps=10) - sdpa_fwd_ms
        passes = device_ms_seen(bwd(a16, "bf16", do16))
        passes32 = device_ms_seen(bwd(a32, "f32", do32))
        by_pass = ", ".join(
            f"{name} {sum(v for k, v in passes.items() if name in k):.4f}"
            for name in ("dq16_kernel<64, 4, true>",
                         "dq16_kernel<64, 4, false>", "dkv16_kernel",
                         "dp16_kernel", "dp16_sum_kernel"))
        bbound, bby = attention_bf16_bwd_bound(B, H, t, DH)
        bwd_rows.append(dict(T=t, err=berr, ms=bms, plain_ms=plain_bwd_ms,
                             library_ms=lib_bwd_ms,
                             device_ms=sum(passes.values()) or None,
                             bound_ms=bbound, bound_by=bby))
        log(f"kernel relpos_attention_bwd_bf16 B{B} H{H} T{t} Dh{DH}: CUDA "
            f"events bf16 {turns[0]:.4f} / {turns[3]:.4f} ms, f32 "
            f"{turns[1]:.4f} / {turns[2]:.4f} ms (in turns), plain bf16 "
            f"backward {plain_bwd_ms:.4f} ms, SDPA bf16 backward "
            f"{lib_bwd_ms:.4f} ms (fwd+bwd minus fwd, given the bias); "
            f"device time (profiler) bf16 {sum(passes.values()):.4f} ms "
            f"(delta, dq, dkv, dp, dp sum: {by_pass}), f32 "
            f"{sum(passes32.values()):.4f} ms; bound {bbound:.5f} ms by "
            f"{bby} (bf16 peak); max_abs_err {berr:.3g} [{card}]")
    return fwd_rows, bwd_rows


def bf16_times_worker(out):
    """``chip_smoke.py --bf16_times OUT``: ``bf16_kernel_times`` on the
    card in a process of its own, its rows written to OUT as JSON."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fwd_rows, bwd_rows = bf16_kernel_times(torch.device("cuda"), card_line())
    Path(out).write_text(json.dumps({"fwd": fwd_rows, "bwd": bwd_rows}))
    return 0


def bf16_kernel_times_apart():
    """``bf16_kernel_times`` in a fresh process (the kernels built
    already): a process loses profiler events the more windows it has
    opened (a count, not a clock: 10-call windows saw 10, 9, 7, 5, ...
    of their launches, then 0 or 10 in turn, with or without idle time
    around them), so deep into a whole run of this script small windows
    see none, while a fresh process sees every one. Its log lines are
    passed on."""
    with tempfile.TemporaryDirectory(prefix="tsasr_bf16_times_") as tmp:
        out = Path(tmp) / "rows.json"
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--bf16_times",
             str(out)], capture_output=True, text=True, timeout=600)
        sys.stdout.write(res.stdout)
        sys.stdout.flush()
        if res.returncode != 0:
            raise RuntimeError(f"the bf16 times worker exited "
                               f"{res.returncode}:\n{res.stderr[-4000:]}")
        rows = json.loads(out.read_text())
    return rows["fwd"], rows["bwd"]


def precision_brains(device):
    """Two full-width scratch brains, f32 and bf16, on the same seeded
    weights; no optimizer step within the accumulation window."""
    import torch
    from tsasr_torch.models.transducer import scratch_config
    brains = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        brains[name] = make_brain(scratch_config(dtype=dtype), device,
                                  {"grad_accumulation_factor": 1000})
        brains[name].init_optimizers()
    for a, b in zip(brains["f32"].model.parameters(),
                    brains["bf16"].model.parameters()):
        if not torch.equal(a, b):
            raise RuntimeError("the bf16 and f32 brains' weights differ")
    return brains


def bf16_fit_batches(device, card, batches, brains):
    """(b2) ``fit_batch`` at full width in bf16 and f32 in turns (f32,
    bf16, bf16, f32 on each shape) on the same weights and batches:
    host ms per micro-batch, the device time and launches under the
    profiler, ``max_memory_allocated``; every bf16 micro-batch launches
    the bf16 kernels once per layer and no f32 attention kernel."""
    import torch
    order = ("f32", "bf16", "bf16", "f32")
    summary = {}
    for (n, seconds), batch in zip(TRAIN_BATCHES, batches):
        for name in ("f32", "bf16"):                 # warm up each
            brains[name].fit_batch(batch)
        torch.cuda.synchronize()
        ms = collections.defaultdict(list)
        for name in order:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = read_bf16_counts()
            t0 = time.perf_counter()
            loss = brains[name].fit_batch(batch)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            # the process's peak, and the micro-batch's own above what
            # was live before it (both brains, earlier phases' leftovers)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            own = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            after = read_bf16_counts()
            got = {k: after[k] - before[k] for k in after if after[k] !=
                   before[k]}
            sfx = "_bf16" if name == "bf16" else ""
            want_attn = {f"relpos_attention_fwd{sfx}": LAYERS_PER_REQUEST,
                         f"relpos_attention_bwd{sfx}": LAYERS_PER_REQUEST}
            if device.type != "cuda":
                want_attn = {}
            if {k: v for k, v in got.items() if "attention" in k} != \
                    want_attn or not math.isfinite(loss):
                raise RuntimeError(f"{name} fit_batch {n} x {seconds} s: "
                                   f"loss {loss}, launches {got}")
            summary.setdefault((n, seconds, name), {}).update(
                peak_gib=peak, own_gib=own)
        for name in ("f32", "bf16"):
            wall, events = profiled(lambda: brains[name].fit_batch(batch))
            dev_ms = sum(device_us(e) for e in events) / 1e3
            launches = sum(e.count for e in events)
            row = summary[(n, seconds, name)]
            row.update(ms=ms[name], device_ms=dev_ms, launches=launches)
            log(f"fit_batch {n} x {seconds} s {name}: host ms "
                + " / ".join(f"{x:.1f}" for x in ms[name])
                + f" (in turns f32, bf16, bf16, f32); under the profiler "
                f"device {dev_ms:.1f} ms of {wall:.1f} ms wall, {launches} "
                f"kernel launches; max_memory_allocated "
                f"{row['peak_gib']:.2f} GiB, {row['own_gib']:.2f} GiB above "
                f"what was live before the micro-batch [{card}]")
    return summary


def bf16_model_check(batch, brains):
    """(c) the full-width scratch model in bf16 against f32 on the same
    weights and micro-batch, dropout 0 (the brains' dropout turned off):
    the loss within BF16_LOSS_RTOL and the gradient (all leaves as one
    vector) at cosine BF16_GRAD_COSINE or more."""
    import torch
    from tsasr_torch.ops.dropout import Dropout
    for brain in brains.values():
        for module in brain.model.modules():
            if isinstance(module, Dropout):
                module.rate = 0.0
    res = {name: loss_and_grads(brain, batch)
           for name, brain in brains.items()}
    (l32, g32), (l16, g16) = res["f32"], res["bf16"]
    if any(g.dtype != torch.float32 for g in g16):
        raise RuntimeError("the bf16 model's gradients are not f32")
    v32 = torch.cat([g.double().flatten() for g in g32])
    v16 = torch.cat([g.double().flatten() for g in g16])
    cosine = (v32 @ v16 / (v32.norm() * v16.norm())).item()
    rel = abs(l16.item() - l32.item()) / abs(l32.item())
    l2 = ((v16 - v32).norm() / v32.norm()).item()
    log(f"full-width model bf16 against f32, dropout 0, one 6 x 8 s "
        f"micro-batch: loss {l16.item():.4f} against {l32.item():.4f} "
        f"(rel {rel:.3g}, limit {BF16_LOSS_RTOL}), gradient cosine "
        f"{cosine:.5f} (limit {BF16_GRAD_COSINE}), relative L2 {l2:.4f}, "
        f"worst leaf "
        f"{max(leaf_errors(g16, g32)):.3g} of its max |g|")
    if not (rel <= BF16_LOSS_RTOL and cosine >= BF16_GRAD_COSINE):
        raise RuntimeError("the bf16 model disagrees with the f32 model")


def bf16_experiment(device, card, corpus):
    """(d) the scratch yaml through ``run_experiment`` with ``--precision
    bf16 --fused_attention True``: 2 optimizer steps, VALID greedy, TEST
    at the yaml's batched beam 15; every batch launches the bf16 kernels
    as its shapes imply and no f32 attention kernel; then the bf16
    kernels against their plain versions (and f64) on the run's own
    tensors, one call per shape. Returns the launch counts."""
    import tempfile
    import torch
    from tsasr_torch.recipes.librispeechmix import TSASRBrain, run_experiment
    root = Path(__file__).resolve().parent
    on_card = device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="tsasr_bf16_") as tmp:
        args = [str(root / EXPERIMENT_YAML), "--data_folder", str(corpus),
                "--output_folder", str(Path(tmp) / "out"),
                "--fused_attention", "True", "--precision", "bf16",
                "--valid_search_freq", "1", "--noprogressbar",
                "--vocab_size", str(corpus_vocab(corpus)),
                "--num_epochs", "1", "--optimizer_step_limit", "2"]
        if not on_card:
            args += ["--device", str(device)]
        t0 = time.perf_counter()
        with captured_kernel_calls() as seen, \
                counted_batches(TSASRBrain, on_card, bf16=True) as (
                    counts, timings):
            brain = run_experiment(argv=args)
        run_s = time.perf_counter() - t0
        run_counts = read_bf16_counts()
        by_batch = {k: sum(c.get(k, 0) for c in counts.values())
                    for k in run_counts}
        if by_batch != run_counts:
            raise RuntimeError(f"launches {run_counts} outside the bf16 "
                               f"run's batches {by_batch}")
        model = brain.model
        if model.config.dtype != torch.bfloat16 or any(
                p.dtype != torch.float32 for p in model.parameters()):
            raise RuntimeError("the bf16 run's model is not bf16 on f32 "
                               "parameters")
        if brain.optimizer_step != 2 or counts["TRAIN"]["batches"] != 8:
            raise RuntimeError("the bf16 run did not take 2 optimizer steps")
        if not (brain._beam.beam_size == BEAM_SIZE
                and type(brain._beam).__name__ == "BatchedBeamSearcher"):
            raise RuntimeError(f"the bf16 TEST searched with {brain._beam!r}")
        wer = (Path(tmp) / "out" / "wer_test-clean-2mix.txt").read_text()
        if not wer.startswith("%WER"):
            raise RuntimeError("the bf16 run wrote no WER file")
        through = [(a + b) * 1e3 for a, b in zip(timings["loader_wait_s"],
                                                 timings["fit_batch_s"])]
        log(f"bf16 experiment: {run_s:.1f} s; batches "
            + ", ".join(f"{k} {v['batches']}" for k, v in counts.items())
            + "; launches " + ", ".join(
                f"{k} {dict((n, c) for n, c in v.items() if c)}"
                for k, v in counts.items()))
        log(f"bf16 experiment TRAIN through the loader: ms per micro-batch "
            + ", ".join(f"{x:.1f}" for x in through)
            + f"; warm median {statistics.median(through[2:]):.1f} ms; "
            f"VALID wall {timings['valid_s'][0]:.2f} s over "
            f"{counts['VALID']['batches']} batches (greedy), TEST wall "
            f"{timings['test_s'][0]:.2f} s over {counts['TEST']['batches']} "
            f"batches (batched beam {BEAM_SIZE}) [{card}]")
        del brain, model
    gen = torch.Generator().manual_seed(SEED + 23)
    worst = {"fwd": 0.0, "bwd": 0.0, "ratio": 0.0}
    for (shape, rate, train, _), (args, seed, scale) in \
            seen["attention"].items():
        if args[0].dtype != torch.bfloat16:
            raise RuntimeError(f"the bf16 run gave the attention "
                               f"{args[0].dtype} operands at {shape}")
        do = torch.randn(shape, generator=gen).to(args[0].device).to(
            torch.bfloat16)
        fwd, bwd, ratio = bf16_attention_errors(
            args, do, seed, scale, rate, f"bf16 kernels at the run's {shape} "
            f"rate {rate}", backward=train)
        worst["fwd"] = max(worst["fwd"], fwd)
        worst["ratio"] = max(worst["ratio"], ratio)
        if train:
            worst["bwd"] = max(worst["bwd"], bwd)
    lattice = check_path_kernels({"attention": {}, "lattice": seen["lattice"]})
    frames = sorted({shape[2] for shape, *_ in seen["attention"]})
    log(f"bf16 experiment kernels against their plain bf16 versions on the "
        f"run's own inputs, one call per shape: attention at "
        f"{len(seen['attention'])} shapes (T {frames}), forward worst "
        f"{worst['fwd']:.3g} of max |o| (tol {BF16_FWD_TOL:.3g}), backward "
        f"worst {worst['bwd']:.3g} of max |g| (tol {BF16_BWD_TOL:.3g}), "
        f"against f64 at most {worst['ratio']:.3f} x the plain version's "
        f"error; lattice at {len(seen['lattice'])} shapes on f32 log-probs "
        f"of the bf16 joint, worst err/tol {lattice['lattice']:.3g}")
    return run_counts


def phase_bf16(device, card, corpus):
    """bf16 compute (the recipe's ``precision: bf16``): (a) the bf16
    kernels against their plain versions and f64; (b) their times
    beside the f32 kernels', SDPA's and the bound, and ``fit_batch`` in
    bf16 and f32 in turns; (c) the full-width model in bf16 against f32;
    (d) the bf16 recipe run. The bf16 kernels' launch counts come from
    (b)'s ``fit_batch`` runs and (d), the counts set to 0 before each."""
    import torch
    t0 = time.perf_counter()
    marks = []

    def mark(name):
        marks.append(f"{name} {time.perf_counter() - t0:.1f} s")

    long_route = bf16_kernel_checks(device)
    mark("kernel checks")
    fwd_rows, bwd_rows = bf16_kernel_times_apart() \
        if device.type == "cuda" else bf16_kernel_times(device, card)
    mark("kernel times")
    batches, check_batch, _ = training_batches()
    brains = precision_brains(device)
    mark("brains")
    reset_counts()
    bf16_fit_batches(device, card, batches[:2], brains)
    fit_counts = read_bf16_counts()
    mark("fit_batch turns")
    bf16_model_check(check_batch, brains)
    del brains
    torch.cuda.empty_cache()
    mark("bf16 vs f32")
    reset_counts()
    run_counts = bf16_experiment(device, card, corpus)
    mark("recipe run")
    counts = {k: {"fit_batch": fit_counts[k], "experiment": run_counts[k]}
              for k in ("relpos_attention_fwd_bf16",
                        "relpos_attention_bwd_bf16")}
    log(f"bf16 kernels' launches on the bf16 paths: {counts}; phase "
        f"{time.perf_counter() - t0:.1f} s (done at: {', '.join(marks)})")
    torch.cuda.empty_cache()
    return fwd_rows, bwd_rows, counts, long_route


# ------------------------------------------------------ the model switches
# The yamls' model switches at the scratch recipe's full width, each in
# one dropout-0 micro-batch of 6 x 8 s, kernels against every kernel
# forced to its plain version (check_gradients' rule, the loss within
# SWITCH_LOSS_RTOL): (name, model config keys, recipe keys). The
# covering band's width is set to the batch's U+1.
SWITCHES = (
    ("injection_mode prod", {"injection_mode": "prod"}, {}),
    ("injection_mode sum", {"injection_mode": "sum"}, {}),
    ("injection_mode cross_attention",
     {"injection_mode": "cross_attention"}, {}),
    ("injection_after [-1, 0, 6]", {"injection_after": (-1, 0, 6)}, {}),
    ("speaker_encoder_type ecapa", {"speaker_encoder_type": "ecapa"}, {}),
    ("joint_mode concat", {"joint_mode": "concat"}, {}),
    ("joint_band_width 64", {}, {"joint_band_width": 64}),
    ("joint_band_width covering", {}, {"joint_band_width": None}),
)
SWITCH_LOSS_RTOL = 1e-5
SWITCH_BAND = 64
# the two switched experiments: TEST at this beam, one utterance a batch
SWITCH_BEAM = 2
SWITCH_CORPUS = dict(EXPERIMENT_CORPUS, n_mix=4)
SWITCH_RUNS = (
    # (name, CLI switches, attention layers, lattice kernels, TRAIN
    # forwards per layer: remat recomputes each layer once)
    ("ecapa + remat", ["--speaker_encoder_type", "ecapa", "--remat",
                       "True"], 12, True, 2),
    ("cross_attention + band 64", ["--injection_mode", "cross_attention",
                                   "--joint_band_width",
                                   str(SWITCH_BAND)], 18, False, 1),
)
SWITCH_STREAM_SECONDS = 6


def remat_step(brain, batch):
    """One TRAIN micro-batch's loss and gradients with dropout on, drawn
    from the brain's step generator: (loss, grads, the generator's state
    after)."""
    import torch
    from tsasr_torch.training.brain import onednn_off_on_cpu
    from tsasr_torch.utils.stage import Stage
    arrays = batch_arrays(brain, batch)
    gen = brain.step_generator()
    with onednn_off_on_cpu(brain.device):
        loss = brain.compute_objectives(
            brain.compute_forward(arrays, Stage.TRAIN, gen), arrays,
            Stage.TRAIN)
        grads = torch.autograd.grad(loss, list(brain.model.parameters()))
    return loss.detach(), grads, gen.get_state()


def own_peak(device, fn):
    """(host ms, the call's own peak memory in GiB above what was
    allocated before it) of ``fn()``."""
    import torch
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)
    sync()
    before = torch.cuda.memory_allocated() if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30 \
        if device.type == "cuda" else 0.0
    return ms, peak


def device_reading(fn):
    """(device ms, kernel launches) of one call of ``fn`` under the
    profiler."""
    _, events = profiled(fn)
    return (sum(device_us(e) for e in events) / 1e3,
            sum(e.count for e in events))


def switch_cases(device, card, batch, counts):
    """Item 1: each switch kernels against plain, with its host ms,
    device ms, launches and own peak memory."""
    import torch
    from tsasr_torch.models.transducer import scratch_config
    u1 = batch.tokens_bos.data.shape[1]
    for name, keys, recipe in SWITCHES:
        t0 = time.perf_counter()
        covering = recipe.get("joint_band_width", 0) is None
        banded = "joint_band_width" in recipe
        if covering:
            recipe = {"joint_band_width": u1}
        det, r = check_gradients(
            device, batch, scratch_config(dropout=0.0, **keys), recipe,
            fault=False, loss_rtol=SWITCH_LOSS_RTOL,
            name=f"{name}, 6 x 8 s")
        # a banded loss's row loop traces ~10^5 launches (~15 s a trace):
        # band_checks reads band 64's loss alone on 3 x 16 s, so neither
        # band's whole micro-batch is traced here (the phase's budget)
        reading = "device time and launches not measured (band_checks " \
            "reads the banded loss)" if banded else "device {:.1f} ms " \
            "and {} kernel launches under the profiler".format(
                *device_reading(lambda: loss_and_grads(det, batch)))
        counts.update(read_counts())
        log(f"switches {name}: fit_batch forward + backward host "
            f"{r['host_ms']:.1f} ms, {reading}, the "
            f"micro-batch's own peak {r['peak_gib']:.2f} GiB; loss "
            f"{r['loss']:.4f}, kernels vs plain loss {r['loss_err']:.3g} "
            f"rel, gradients {r['grad_err']:.3g} tight / "
            f"{r['grad_err_loose']:.3g} loose of max |g| ({r['loose']} "
            f"held loosely; f32 floor {r['floor']:.3g}); the case "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        del det
        if device.type == "cuda":
            torch.cuda.empty_cache()


def band_checks(device, card, short, long, counts):
    """Item 2: a covering band against the full loss (the same encoder
    output, so no kink can flip between them: every element held at
    GRAD_TIGHT_REL); band 64 on 3 x 16 s no smaller than the full loss;
    the banded loss's own launches and device time."""
    import torch
    from tsasr_torch.models.transducer import scratch_config
    from tsasr_torch.utils.stage import Stage
    u1 = short.tokens_bos.data.shape[1]
    reset_counts()
    # one brain; the recipe reads joint_band_width at each call
    band = make_brain(scratch_config(dropout=0.0), device)
    loss_f, grads_f = loss_and_grads(band, short)
    loss_l, _ = loss_and_grads(band, long)
    band.hparams.joint_band_width = u1
    loss_c, grads_c = loss_and_grads(band, short)
    err = abs(loss_c.item() - loss_f.item()) / abs(loss_f.item())
    grad_err = max(leaf_errors(grads_c, grads_f))
    band.hparams.joint_band_width = SWITCH_BAND
    arrays = batch_arrays(band, long)
    logits, enc_out, rel = band.compute_forward(arrays, Stage.TRAIN, None)
    logits = logits.detach().requires_grad_(True)

    def banded():
        loss = band.compute_objectives((logits, enc_out, rel), arrays,
                                       Stage.TRAIN)
        loss.backward()
        return loss

    out = {}
    device_ms, launches = device_reading(
        lambda: out.setdefault("loss", banded()))
    loss_b = out["loss"].item()
    counts.update(read_counts())
    log(f"switches band: covering band (W = U+1 = {u1}) vs the full "
        f"(fused) loss on 6 x 8 s: loss {loss_c.item():.5f} vs "
        f"{loss_f.item():.5f} (rel err {err:.3g}, tol {SWITCH_LOSS_RTOL}), "
        f"gradients worst leaf {grad_err:.3g} of max |g| (tol "
        f"{GRAD_TIGHT_REL}); band {SWITCH_BAND} on 3 x 16 s (logits "
        f"{tuple(logits.shape)}): loss {loss_b:.4f} >= full "
        f"{loss_l.item():.4f}; the banded loss forward + backward "
        f"{launches} kernel launches, device {device_ms:.2f} ms under the "
        f"profiler [{card}]")
    if err > SWITCH_LOSS_RTOL or grad_err > GRAD_TIGHT_REL \
            or not loss_b >= loss_l.item() * (1 - SWITCH_LOSS_RTOL):
        raise RuntimeError("the banded loss failed its check")
    return {"banded_device_ms": device_ms, "banded_launches": launches}


def remat_checks(device, card, short, long, counts):
    """Item 3: at dropout 0.1 under deterministic algorithms, remat full
    and dots give the step without remat bit for bit (loss, every
    gradient, the generator's final state); on 3 x 16 s the
    micro-batch's own peak memory, host and device ms of each."""
    import torch
    from tsasr_torch.models.transducer import scratch_config
    policies = (None, "full", "dots")
    brain = make_brain(scratch_config(), device)
    encoders = (brain.model.encoder, brain.model.speaker_encoder)

    def remat(policy):
        """The brain with remat at ``policy`` (None: off), as a config of
        ``remat`` / ``remat_policy`` builds it."""
        for encoder in encoders:
            encoder.remat, encoder.remat_policy = policy is not None, \
                policy or "full"
        return brain

    reset_counts()
    with deterministic_algorithms(True):
        steps = {p: remat_step(remat(p), short) for p in policies}
        loss, grads, state = steps[None]
        same = {p: (torch.equal(steps[p][0], loss)
                    and all(torch.equal(a, b)
                            for a, b in zip(steps[p][1], grads))
                    and torch.equal(steps[p][2], state))
                for p in policies[1:]}
        del steps
        readings = {}
        for p in policies:
            ms, peak = own_peak(device, lambda: remat_step(remat(p), long))
            readings[p] = (ms, peak) + device_reading(
                lambda: remat_step(remat(p), long))
    counts.update(read_counts())
    log(f"switches remat, dropout 0.1, deterministic algorithms: full and "
        f"dots vs no remat on 6 x 8 s, loss, every gradient and the "
        f"generator's final state bit-identical {same}; 3 x 16 s "
        + "; ".join(f"{p or 'no remat'}: host {ms:.1f} ms, device "
                    f"{dev:.1f} ms, {n} launches, own peak {peak:.2f} GiB"
                    for p, (ms, peak, dev, n) in readings.items())
        + f" [{card}]")
    if not all(same.values()):
        raise RuntimeError("remat is not bit for bit the step without it")
    if device.type == "cuda" and \
            not readings["full"][1] < readings[None][1]:
        raise RuntimeError("remat full did not lower the micro-batch's own "
                           "peak memory")
    return readings


def pretrained_cross_attention(device, card, batch, tmp, counts):
    """Item 4: the pretrained recipe with cross_attention: the frozen
    WavLM at WAVLM_CONFIG (the published widths) gives frame-level
    features, card against CPU; one fit_batch."""
    import torch
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_torch.models.transducer import TSTransducer, scratch_config
    from tsasr_torch.models.wavlm import (WavLMConfig, WavLMForXVector,
                                          save_pretrained_xvector)
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    from tsasr_torch.recipes.speaker_embeddings import FrozenSpeakerEncoder
    from tsasr_torch.training import NoamScheduler, make_adamw

    wavlm = WAVLM_CONFIG or WavLMConfig()
    folder = tmp / "wavlm"
    save_pretrained_xvector(WavLMForXVector(wavlm).init_weights(seed=SEED),
                            str(folder))
    dim = min(512, wavlm.hidden_size)
    hparams = dict(HPARAMS, speaker_encoder_path=str(folder),
                   speaker_encoder_backend="jax", speaker_embedding_dim=dim,
                   injection_mode="cross_attention",
                   noam_scheduler=NoamScheduler(1e-3, 10000))
    model = TSTransducer(scratch_config(
        use_speaker_encoder=False, speaker_embedding_dim=dim,
        injection_mode="cross_attention")).init_weights(seed=SEED)
    brain = TSASRBrain(modules={"model": model},
                       opt_class=make_adamw(1e-3, (0.9, 0.98), 1e-8, 0.01),
                       hparams=hparams, run_opts={"device": str(device)},
                       variant="pretrained", tokenizer=CharTokenizer(PIECES))
    arrays = batch_arrays(brain, batch)
    frames = brain.speaker_encoder.embed(arrays["enroll_sig"],
                                         arrays["enroll_lens"])
    cpu = FrozenSpeakerEncoder(str(folder), frame_level=True,
                               embedding_dim=dim, device="cpu")
    want = cpu.embed(arrays["enroll_sig"].cpu(), arrays["enroll_lens"].cpu())
    err = ((frames.cpu() - want).abs().max() / want.abs().max()).item()
    reset_counts()
    step = {}
    ms, peak = own_peak(device, lambda: step.setdefault(
        "loss", brain.fit_batch(batch)))
    loss = step["loss"]
    n = read_counts()
    counts.update(n)
    log(f"switches pretrained + cross_attention: frozen WavLM (hidden "
        f"{wavlm.hidden_size}, {wavlm.num_hidden_layers} layers) frames "
        f"{tuple(frames.shape)}, the first {dim} channels of the last "
        f"hidden state, card vs CPU max err {err:.3g} of max |f| (rtol "
        f"{WAVLM_RTOL}); fit_batch 6 x 8 s: loss {loss:.4f}, {ms:.1f} ms, "
        f"own peak {peak:.2f} GiB, launches {n} [{card}]")
    if err > WAVLM_RTOL or frames.shape[-1] != dim \
            or n["relpos_attention_fwd"] != VARIANT_LAYERS * (
                device.type == "cuda") or not math.isfinite(loss):
        raise RuntimeError("the pretrained cross_attention step failed")
    del brain, cpu


def switched_experiments(device, card, tmp, counts):
    """Item 5: the scratch yaml through ``run_experiment`` with the
    switches of SWITCH_RUNS, 2 optimizer steps, VALID greedy, TEST at
    SWITCH_BEAM one utterance a batch; every batch launches what its
    shapes imply; then the TEST files through ``from_experiment``."""
    from tsasr_torch.recipes.librispeechmix import TSASRBrain, run_experiment
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset
    root = Path(__file__).resolve().parent
    on_card = device.type == "cuda"
    corpus = tmp / "switch_corpus"
    make_dataset(str(corpus), **SWITCH_CORPUS)
    for i, (name, switches, layers, lattice, forwards) in \
            enumerate(SWITCH_RUNS):
        out = tmp / f"switch_run{i}"
        args = [str(root / EXPERIMENT_YAML), "--data_folder", str(corpus),
                "--output_folder", str(out), "--fused_attention", "True",
                "--valid_search_freq", "1", "--noprogressbar",
                "--vocab_size", str(corpus_vocab(corpus)),
                "--num_epochs", "1", "--optimizer_step_limit", "2",
                "--grad_accumulation_factor", "1",
                "--train_max_batch_length", "20.0",
                "--beam_size", str(SWITCH_BEAM),
                "--test_max_batch_length", "0.5", *switches]
        if not on_card:
            args += ["--device", str(device)]
        reset_counts()
        t0 = time.perf_counter()
        with counted_batches(TSASRBrain, on_card, layers, lattice=lattice,
                             train_forward=forwards) as (totals, timings):
            brain = run_experiment(argv=args)
        run_s = time.perf_counter() - t0
        log_text = (out / "train_log.txt").read_text()
        through = [(a + b) * 1e3 for a, b in zip(timings["loader_wait_s"],
                                                 timings["fit_batch_s"])]
        log(f"switches experiment {name}: {run_s:.1f} s; batches "
            + ", ".join(f"{k} {v['batches']}" for k, v in totals.items())
            + f"; optimizer steps {brain.optimizer_step}; ms per TRAIN "
            f"micro-batch " + ", ".join(f"{x:.1f}" for x in through)
            + f"; VALID {timings['valid_s'][0]:.2f} s, TEST "
            f"{timings['test_s'][0]:.2f} s (beam {SWITCH_BEAM}) [{card}]")
        if brain.optimizer_step != 2 or not re.search(
                r"^epoch: 1, .* valid WER: ", log_text, re.M) or not (
                out / "wer_test-clean-2mix.txt").read_text().startswith(
                "%WER"):
            raise RuntimeError(f"the {name} experiment did not train, "
                               "validate and test")
        transcribe_test_split(brain, out, tmp / f"switch_wavs{i}", device,
                              card, beam=SWITCH_BEAM, layers=layers)
        counts.update(read_counts())
        del brain


def cross_attention_stream(device, card, counts):
    """Item 6: a causal cross_attention model (seeded, full width)
    streams with kv_cache, the enrollment's speaker frames injected, to
    the offline greedy tokens on the unnormalized features."""
    import numpy as np
    import torch
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_torch.decoding import TransducerGreedySearcher
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.models.transducer import TSTransducer, scratch_config
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)
    rng = np.random.default_rng(SEED + 37)
    wav = (rng.normal(size=SWITCH_STREAM_SECONDS * SAMPLE_RATE) * 0.1
           ).astype(np.float32)
    enroll = (rng.normal(size=ENROLL_SECONDS * SAMPLE_RATE) * 0.1
              ).astype(np.float32)
    model = TSTransducer(scratch_config(
        causal_encoder=True, frontend_causal=True,
        injection_mode="cross_attention")).init_weights(seed=SEED)
    tr = TSASRTranscriber(model, None, CharTokenizer(PIECES),
                          device=str(device))
    reset_counts()
    ones = torch.ones(1, device=device)
    with torch.inference_mode():
        spk = tr.speaker_embedding(enroll)
        raw = tr.fbank(torch.from_numpy(wav)[None].to(device))
        t4 = raw.shape[1] // 4 * 4
        offline = TransducerGreedySearcher(tr.model, 0)(
            tr.model.encode(raw[:, :t4], ones, spk), ones)[0][0]
    kv = tr.streaming("kv_cache", speaker_embs=spk)
    times, _, final, _ = stream_chunks(kv, wav, 1.0, sync)
    counts.update(read_counts())
    log(f"switches streaming: causal cross_attention model, speaker frames "
        f"{tuple(spk.shape)}; kv_cache in 1 s chunks over "
        f"{SWITCH_STREAM_SECONDS} s: {len(kv._tokens)} tokens, offline "
        f"greedy identical {kv._tokens == offline}; host ms per chunk "
        f"median {statistics.median(times):.2f}; final {final[:40]!r} "
        f"[{card}]")
    if not kv._tokens or kv._tokens != offline:
        raise RuntimeError("the cross_attention kv_cache stream differs from "
                           "offline greedy")


def phase_switches(device, card):
    """The yamls' model switches at the scratch recipe's full width:
    (1) each of SWITCHES, kernels against plain; (2) the band; (3) remat;
    (4) pretrained + cross_attention; (5) two switched experiments; (6)
    a cross_attention stream. Each kernel is then held against its plain
    version on the tensors this path gave it. Returns the path's launch
    counts."""
    import tempfile
    import numpy as np
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 31)
    short = make_train_batch(rng, 6, 8, ids="sw-")
    long = make_train_batch(rng, 3, 16, ids="sl-")
    counts = collections.Counter()
    with captured_kernel_calls() as seen, \
            tempfile.TemporaryDirectory(prefix="tsasr_switches_") as tmp:
        tmp = Path(tmp)
        switch_cases(device, card, short, counts)
        for part, args in ((band_checks, (short, long)),
                           (remat_checks, (short, long)),
                           (pretrained_cross_attention, (short, tmp)),
                           (switched_experiments, (tmp,)),
                           (cross_attention_stream, ())):
            t0 = time.perf_counter()
            part(device, card, *args, counts)
            log(f"switches {part.__name__}: {time.perf_counter() - t0:.1f} "
                "s")
    path_counts = {k: counts[k] for k in read_counts()}
    worst = check_path_kernels(seen)
    log(f"switches kernels against their plain versions on the phase's own "
        f"inputs, one call per shape: attention at "
        f"{len(seen['attention'])} shapes, worst fwd {worst['fwd']:.3g} of "
        f"max |o|, bwd {worst['bwd']:.3g} of max |g| (atol {ATTN_ATOL}); "
        f"lattice at {len(seen['lattice'])} shapes "
        f"({sorted(seen['lattice'])}), worst err/tol "
        f"{worst['lattice']:.3g}; the phase's launches {path_counts}; "
        f"{time.perf_counter() - t_start:.1f} s")
    return path_counts


# ------------------------------------------------------------ run flags
RUN_FLAGS_STEPS = 5           # optimizer steps of (a), at accumulation 1
# JAX's default profiler schedule (wait 2, warmup 2, active 2): its window
# is the 5th and 6th profiled calls, so (a)'s 5 TRAIN micro-batches put
# the last of them and the first VALID batch in the trace
RUN_FLAGS_WINDOW = "trace_steps_5-6.json"
ATTN_BATCH = (6, 8)           # (c): 6 x 8 s
ROW_SUM_ATOL = 1e-5
# (d): the bf16 stream against the offline bf16 encode, at the model
# tolerance of tests/test_torch_bf16.py (2^-5 of max |enc|): the stream's
# attention rounds its scores to bf16 as the plain path does, the
# offline encode's bf16 kernel keeps them in f32
BF16_STREAM_RTOL = 2.0 ** -5
# (d): each replayed decision of the bf16 kv_cache stream at most this
# far (in logits) below the offline bf16 argmax at the same predictor
# state: twice the worst recorded on an H100 80GB HBM3 at 700 W (0.03125,
# two bf16 ulps of a logit in [2, 4), at 14 of 300 frames), where the
# offline bf16 logits' own largest error against the f32 twin's read
# 0.0358 (chip_smoke.py, phase_run_flags)
STREAM_DECISION_GAP = 2.0 ** -4
BF16_STREAM_TURNS = ("f32", "bf16", "bf16", "f32")


TRACE_KERNELS = (("attention fwd", ("relpos_attention_fwd",)),
                 ("attention bwd", ("dq_kernel", "dkv_kernel", "dp_kernel",
                                    "rows_kernel", "dp_sum")),
                 ("lattice", ("rnnt_",)))


def trace_summary(path):
    """A Chrome trace's event names and what it holds: the calls and
    wall ms of the ``fit_batch`` and ``evaluate_batch`` regions, the
    device's kernel launches and their summed time (busy ms), and that
    time for the port's kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    regions = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e.get("name") in ("fit_batch", "evaluate_batch"):
            regions[e["name"]].append(e.get("dur", 0) / 1e3)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = {label: sum(e.get("dur", 0) for e in kernels
                       if any(k in e.get("name", "") for k in keys)) / 1e3
            for label, keys in TRACE_KERNELS}
    return ({e.get("name", "") for e in events}, dict(regions),
            len(kernels), sum(e.get("dur", 0) for e in kernels) / 1e3, ours)


def profiled_prompted_run(device, card, corpus, out, trace_dir):
    """(a) The scratch yaml through its entry module with ``--profile``,
    ``prompt_test`` (prepend), RUN_FLAGS_STEPS optimizer steps at
    accumulation 1, VALID greedy and TEST at beam 1 (two passes); every
    batch launches what its shapes imply. Returns (the Brain, its launch
    counts by stage)."""
    from tsasr_torch import train_librispeechmix_scratch as entry
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    from tsasr_torch.utils.profiling import report_memory, report_time

    root = Path(__file__).resolve().parent
    on_card = device.type == "cuda"
    args = [str(root / EXPERIMENT_YAML), "--data_folder", str(corpus),
            "--output_folder", str(out), "--fused_attention", "True",
            "--valid_search_freq", "1", "--noprogressbar",
            "--vocab_size", str(corpus_vocab(corpus)), "--num_epochs", "1",
            "--optimizer_step_limit", str(RUN_FLAGS_STEPS),
            "--grad_accumulation_factor", "1", "--beam_size", "1",
            "--profile", "--profile_dir", str(trace_dir),
            "--prompt_test", "True", "--prompt_mode", "[prepend]"]
    if not on_card:
        args += ["--device", str(device)]
    brains, stripped = [], []
    fit_start, strip = TSASRBrain.on_fit_start, \
        TSASRBrain._strip_enroll_transcripts

    def started(self):
        brains.append(self)
        return fit_start(self)

    def stripping(self, ids, words):
        got = strip(self, ids, words)
        stripped.extend(zip(ids, words, got))
        return got

    TSASRBrain.on_fit_start = started
    TSASRBrain._strip_enroll_transcripts = stripping
    t0 = time.perf_counter()
    try:
        with counted_batches(TSASRBrain, on_card) as (counts, timings):
            entry.main(args)
    finally:
        TSASRBrain.on_fit_start = fit_start
        TSASRBrain._strip_enroll_transcripts = strip
    run_s = time.perf_counter() - t0
    [brain] = brains
    prof = brain.profiler
    log(f"run flags (a): the scratch yaml through "
        f"tsasr_torch.train_librispeechmix_scratch with --profile "
        f"--prompt_test True --prompt_mode [prepend], {run_s:.1f} s; "
        f"batches " + ", ".join(f"{k} {v['batches']}"
                                for k, v in counts.items())
        + f"; optimizer steps {brain.optimizer_step}; traces "
        f"{[Path(t).name for t in prof.traces]} [{card}]")
    for line in report_time(prof).splitlines():
        log(f"  report_time: {line} (profiled host clock)")
    log(f"  report_memory: {report_memory(device)}")
    if brain.optimizer_step != RUN_FLAGS_STEPS \
            or counts["TRAIN"]["batches"] != RUN_FLAGS_STEPS:
        raise RuntimeError("the profiled run did not take its steps")
    if [Path(t).name for t in prof.traces] != [RUN_FLAGS_WINDOW]:
        raise RuntimeError(f"traces {prof.traces}, expected one "
                           f"{RUN_FLAGS_WINDOW}")
    names, regions, launches, busy, ours = trace_summary(prof.traces[0])
    want = ["fit_batch", "evaluate_batch"]
    if on_card:
        want += ["relpos_attention_fwd_kernel", "dq_kernel", "dkv_kernel",
                 "dp_kernel", "rnnt_"]
    missing = [w for w in want if not any(w in n for n in names)]
    size = Path(prof.traces[0]).stat().st_size
    log(f"run flags (a) trace {RUN_FLAGS_WINDOW}: {len(names)} distinct "
        f"event names, {size / 2**20:.1f} MiB; names the regions and "
        f"kernels {sorted(set(want) - set(missing))}; missing {missing}")
    wall = sum(sum(v) for v in regions.values())
    log(f"run flags (a) trace summary: regions "
        + ", ".join(f"{k} {len(v)} x {sum(v):.1f} ms"
                    for k, v in sorted(regions.items()))
        + f" (profiled host clock); {launches} kernel launches, device busy "
        f"{busy:.1f} ms ({100 * busy / max(wall, 1e-9):.1f} % of the "
        f"regions' wall); the port's kernels "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in ours.items())
        + f" [{card}]")
    if missing:
        raise RuntimeError(f"the trace does not name {missing}")
    for name in ("wer_enrollments.txt", "wer_test-clean-2mix.txt"):
        if not (out / name).read_text().startswith("%WER"):
            raise RuntimeError(f"{name} was not written")
    enrolls = brain.hparams.enroll_transcriptions
    kept = [key for key, words, got in stripped
            if got != (words[len(enrolls[key]):] or [""])]
    began = sum(words[:len(enrolls[key])] == enrolls[key]
                for key, words, _ in stripped)
    final = {d["key"]: d["hyp_tokens"] for d in brain.wer_metric.scores}
    log(f"run flags (a) prompt_test: {len(enrolls)} enrollments transcribed "
        f"(wer_enrollments.txt), {len(stripped)} prompted hypotheses "
        f"stripped of their enrollment's words ({began} began with them); "
        f"any that kept the prefix: {kept}")
    if kept or len(stripped) != len(enrolls) or any(
            final[key] != got for key, _, got in stripped):
        raise RuntimeError("prompt_test's second pass kept an enrollment "
                           "prefix, or its WER file is not the stripped "
                           "pass")
    return brain, counts


def warm_started_run(device, card, corpus, out, source):
    """(b) A run with ``model_path`` = ``source``: before its first step
    the model equals the source's weights bit for bit; it trains one
    step. Returns its launch counts by stage."""
    import torch
    from tsasr_torch.recipes.librispeechmix import TSASRBrain, run_experiment
    from tsasr_torch.training.checkpoints import load_state

    root = Path(__file__).resolve().parent
    on_card = device.type == "cuda"
    args = [str(root / EXPERIMENT_YAML), "--data_folder", str(corpus),
            "--output_folder", str(out), "--fused_attention", "True",
            "--noprogressbar", "--vocab_size", str(corpus_vocab(corpus)),
            "--num_epochs", "1", "--optimizer_step_limit", "1",
            "--grad_accumulation_factor", "1", "--test_splits", "[]",
            "--model_path", str(source)]
    if not on_card:
        args += ["--device", str(device)]
    want = load_state(source)["model"]
    first = []
    fit_batch = TSASRBrain.fit_batch

    def recording(self, batch):
        if not first:
            first.append({k: v.detach().cpu().clone()
                          for k, v in self.model.state_dict().items()})
        return fit_batch(self, batch)

    TSASRBrain.fit_batch = recording
    t0 = time.perf_counter()
    try:
        with counted_batches(TSASRBrain, on_card) as (counts, _):
            brain = run_experiment(argv=args)
    finally:
        TSASRBrain.fit_batch = fit_batch
    same = first[0].keys() == want.keys() and all(
        torch.equal(first[0][k], v) for k, v in want.items())
    moved = any(not torch.equal(v.detach().cpu(), want[k])
                for k, v in brain.model.state_dict().items())
    log(f"run flags (b) model_path = (a)'s checkpoint "
        f"({Path(source).parent.name}/brain.ckpt), new output folder: "
        f"{time.perf_counter() - t0:.1f} s; the model before the first "
        f"step equals the source bit for bit {same} ({len(want)} entries); "
        f"optimizer steps {brain.optimizer_step}, the weights moved {moved}")
    if not same or brain.optimizer_step != 1 or not moved:
        raise RuntimeError("the warm start did not load the source bit for "
                           "bit, or did not train its step")
    return counts


def attention_maps_check(device, card):
    """(c) ``encode_with_attn`` of the full-width scratch model (fused
    attention on) on a 6 x 8 s batch: its output within ENC_ATOL of
    ``encode`` with the kernel (which launches it once a mixture layer),
    every attention row over unmasked keys summing to 1 within
    ROW_SUM_ATOL, the maps from the plain path (no launch)."""
    import numpy as np
    import torch
    from tsasr_torch.models.transducer import TSTransducer, scratch_config
    from tsasr_torch.ops.features import Fbank, input_normalization

    rng = np.random.default_rng(SEED + 41)
    model = TSTransducer(scratch_config()).init_weights(seed=SEED)
    model = model.to(device).eval()
    fbank = Fbank(sample_rate=SAMPLE_RATE, n_fft=512, n_mels=80,
                  win_length=32.0).to(device)
    n, seconds = ATTN_BATCH
    lens = np.array([1.0] + list(rng.uniform(0.6, 1.0, n - 1)))
    wav = torch.from_numpy((rng.normal(size=(n, seconds * SAMPLE_RATE))
                            * 0.1).astype(np.float32)).to(device)
    rel = torch.from_numpy(lens.astype(np.float32)).to(device)
    enroll = torch.from_numpy((rng.normal(size=(n, ENROLL_SECONDS
                                                * SAMPLE_RATE)) * 0.1
                               ).astype(np.float32)).to(device)
    ones = torch.ones(n, device=device)
    with torch.inference_mode():
        feats = input_normalization(fbank(wav), rel)
        spk = model.extract_speaker(input_normalization(fbank(enroll), ones),
                                    ones)
        before = read_counts()["relpos_attention_fwd"]
        enc = model.encode(feats, rel, spk)
        launches = read_counts()["relpos_attention_fwd"] - before
        got, maps = model.encode_with_attn(feats, rel, spk)
        plain = read_counts()["relpos_attention_fwd"] - before - launches
        err = (got - enc).abs().max().item()
        T = maps[0].shape[-1]
        keys = torch.arange(T, device=device)[None] < torch.round(
            rel * T)[:, None]                                  # (B, T)
        row_err = max((m.sum(-1) - 1).abs().max().item() for m in maps)
        leaked = max(m.masked_fill(keys[:, None, None], 0).abs().max().item()
                     for m in maps)
    log(f"run flags (c) encode_with_attn on {n} x {seconds} s: "
        f"{len(maps)} maps of {tuple(maps[0].shape)}; against encode with "
        f"the kernel ({launches} launches) max_abs_err {err:.3g} (atol "
        f"{ENC_ATOL}); rows over unmasked keys sum to 1 within "
        f"{row_err:.3g} (atol {ROW_SUM_ATOL}); probability on masked keys "
        f"{leaked:.3g}; attention launches of encode_with_attn {plain} "
        f"[{card}]")
    on_card = device.type == "cuda"
    if len(maps) != model.config.encoder_num_layers or err > ENC_ATOL \
            or row_err > ROW_SUM_ATOL or leaked > 0 or plain \
            or launches != model.config.encoder_num_layers * on_card:
        raise RuntimeError("encode_with_attn failed its check")


def forced_logits(model, enc, decisions=None, blank=0):
    """The joint's logits (T, V), f32, of each frame of ``enc`` (1, T, J)
    as greedy search meets them (at most one token a frame, the
    streamer's rule), the predictor fed ``decisions`` (one token or the
    blank a frame) or its own argmax. Returns (logits, decisions)."""
    import torch
    dev = enc.device
    with torch.inference_mode():
        state = model.predictor_initial_state(1, dev)
        dec, state = model.predict_step(torch.tensor([blank], device=dev),
                                        state)
        rows, made = [], []
        for t in range(enc.shape[1]):
            logits = model.joint_logits(enc[:, t][:, None, :],
                                        dec[:, None, :])[0, 0]
            tok = int(torch.argmax(logits)) if decisions is None \
                else decisions[t]
            rows.append(logits.float())
            made.append(tok)
            if tok != blank:
                dec, state = model.predict_step(
                    torch.tensor([tok], device=dev), state)
    return torch.stack(rows), made


def bf16_stream_checks(device, card):
    """(d) The causal full-width scratch model in bf16 (its stream caches
    in bf16) and its f32 twin on a STREAM_SECONDS mixture with a 5 s
    enrollment: the streams and offline encodes of ``bf16_streams``, with
    every attention call they make captured (one per shape) and then held
    against its plain version on its own tensors (``hold_stream_kernels``);
    then ms, device ms and launches a chunk of the f32 and the bf16
    kv_cache streams in turns, outside the capture. Returns (the bf16
    reencode stream's launch counts, the captured calls' worst errors)."""
    import numpy as np
    import torch
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.models.transducer import TSTransducer, scratch_config

    rng = np.random.default_rng(SEED + 43)
    wav = (rng.normal(size=STREAM_SECONDS * SAMPLE_RATE) * 0.1
           ).astype(np.float32)
    enroll = (rng.normal(size=ENROLL_SECONDS * SAMPLE_RATE) * 0.1
              ).astype(np.float32)
    state = TSTransducer(scratch_config(
        causal_encoder=True, frontend_causal=True)).init_weights(
        seed=SEED).state_dict()
    trs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = TSTransducer(scratch_config(
            causal_encoder=True, frontend_causal=True, dtype=dtype))
        model.load_state_dict(state)
        trs[name] = TSASRTranscriber(model, None, CharTokenizer(PIECES),
                                     device=str(device))
    with captured_kernel_calls() as seen:
        counts, spk = bf16_streams(device, card, trs, wav, enroll)
    held = hold_stream_kernels(seen, card)
    stream_turns(device, card, trs, wav, spk)
    return counts, held


def bf16_streams(device, card, trs, wav, enroll):
    """``encode_stream`` of the bf16 model in 100-frame chunks against the
    offline bf16 causal encode (the bf16 kernel) within BF16_STREAM_RTOL,
    and against the plain path; the kv_cache streamer (1 s chunks) on the
    offline greedy of the same unnormalized features: each of its
    decisions, replayed, within STREAM_DECISION_GAP of the offline bf16
    argmax at the same predictor state; the witness of the stream's
    difference (the plain path in the stream's chunking with no cache,
    against the whole-sequence plain path); reencode, which runs the
    bf16 attention forward kernel once a mixture layer a chunk. Returns
    (the reencode stream's launch counts, the speaker embeddings)."""
    import torch
    from tsasr_torch.decoding import TransducerGreedySearcher

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tr = trs["bf16"]
    model = tr.model
    layers = model.config.encoder_num_layers
    bf16_fwd = lambda: read_bf16_counts()[  # noqa: E731
        "relpos_attention_fwd_bf16"]
    ones = torch.ones(1, device=device)
    with torch.inference_mode():
        spk = {k: t.speaker_embedding(enroll) for k, t in trs.items()}
        raw = tr.fbank(torch.from_numpy(wav)[None].to(device))
        t4 = raw.shape[1] // 4 * 4
        before = bf16_fwd()
        offline = model.encode(raw[:, :t4], ones, spk["bf16"])
        n_offline = bf16_fwd() - before
        streamed = encode_in_chunks(model, raw[:, :t4], 100, spk["bf16"])
        set_fused(model, False)
        plain = model.encode(raw[:, :t4], ones, spk["bf16"])
        set_fused(model, True)
        f32 = trs["f32"].model.encode(raw[:, :t4], ones, spk["f32"])
        err = rel_err(streamed.float(), offline.float())
        err_plain = rel_err(streamed.float(), plain.float())
        err_f32 = rel_err(offline.float(), f32)
    log(f"run flags (d) causal scratch model in bf16 "
        f"({layers}+{model.config.speaker_encoder_layers} layers, caches "
        f"{model.init_stream_state(1, 1)['encoder'][0]['attn']['k'].dtype}):"
        f" encode_stream in 100-frame chunks of {t4} frames against the "
        f"offline bf16 encode ({n_offline} bf16 kernel launches): err "
        f"{err:.3g} of max |enc| (rtol {BF16_STREAM_RTOL}); against the "
        f"offline plain path {err_plain:.3g}; offline bf16 against f32 "
        f"{err_f32:.3g} [{card}]")
    if streamed.dtype != torch.bfloat16 or err > BF16_STREAM_RTOL \
            or n_offline != layers * on_card:
        raise RuntimeError("the bf16 stream left the offline bf16 encode")

    reset_counts()
    kv = tr.streaming("kv_cache", speaker_embs=spk["bf16"])
    chunk_feats, chunk_enc = [], []
    to_feats, encode_stream = kv._frames_to_feats, model.encode_stream

    def features(window, n):
        chunk_feats.append(to_feats(window, n))
        return chunk_feats[-1]

    def encoded(*args, **kwargs):
        out, new_state = encode_stream(*args, **kwargs)
        chunk_enc.append(out)
        return out, new_state

    kv._frames_to_feats, model.encode_stream = features, encoded
    try:
        stream_chunks(kv, wav, 1.0, sync)
    finally:
        kv._frames_to_feats = to_feats
        del model.encode_stream
    kv_tokens = list(kv._tokens)
    n_kv = bf16_fwd()
    # the offline greedy on the stream's own features (its STFT of each
    # chunk's window): bf16 through the kernel and through the plain path,
    # and the f32 twin; and the witness: the plain path in the stream's
    # chunking with no cache at all, each chunk's frames from an encode
    # of the features up to the chunk's end (the same values for a causal
    # model), which differs from the whole-sequence plain encode only in
    # the lengths the GEMMs and convolutions are given
    ends = list(itertools.accumulate(f.shape[1] for f in chunk_feats))
    with torch.inference_mode():
        feats = torch.cat(chunk_feats, dim=1)
        stream_enc = torch.cat(chunk_enc, dim=1)
        greedy = TransducerGreedySearcher(model, 0)
        kernel_enc = model.encode(feats, ones, spk["bf16"])
        offline_tokens = greedy(kernel_enc, ones)[0][0]
        set_fused(model, False)
        plain_enc = model.encode(feats, ones, spk["bf16"])
        plain_tokens = greedy(plain_enc, ones)[0][0]
        chunked_enc = torch.cat(
            [model.encode(feats[:, :hi], ones, spk["bf16"])[:, lo // 4:hi // 4]
             for lo, hi in zip([0] + ends[:-1], ends)], dim=1)
        chunked_tokens = greedy(chunked_enc, ones)[0][0]
        set_fused(model, True)
        f32_enc = trs["f32"].model.encode(feats, ones, spk["f32"])
        f32_tokens = TransducerGreedySearcher(trs["f32"].model, 0)(
            f32_enc, ones)[0][0]
    witness = rel_err(chunked_enc.float(), plain_enc.float())
    err_kv = rel_err(stream_enc.float(), plain_enc.float())
    # each frame's decision of the stream, replayed, against the offline
    # bf16 logits at the same predictor state: the stream's token must be
    # within STREAM_DECISION_GAP of the offline argmax (the offline bf16
    # logits' own error against the f32 twin's is printed beside it)
    stream_logits, decisions = forced_logits(model, stream_enc)
    offline_logits, _ = forced_logits(model, kernel_enc, decisions)
    f32_logits, _ = forced_logits(trs["f32"].model, f32_enc, decisions)
    own = (offline_logits - f32_logits).abs().max().item()
    gap = (offline_logits.max(-1).values - offline_logits.gather(
        1, torch.tensor(decisions, device=device)[:, None])[:, 0])
    parted = int((gap > 0).sum())
    worst_gap = gap.max().item()
    replayed = [d for d in decisions if d != 0] == kv_tokens
    reset_counts()
    rs = tr.streaming("reencode", speaker_embs=spk["bf16"])
    start = bf16_fwd()
    _, re_partials, re_final, re_reads = stream_chunks(rs, wav, 1.0, sync,
                                                       bf16_fwd)
    re_launches = [b - a for a, b in zip([start] + re_reads[:-1], re_reads)]
    counts = read_bf16_counts()

    def agree(a, b):
        return (f"{sum(x == y for x, y in zip(a, b))}/"
                f"{max(len(a), len(b))}")

    log(f"run flags (d) bf16 kv_cache in 1 s chunks: {len(kv_tokens)} "
        f"tokens over {len(decisions)} frames ({feats.shape[1]} feature "
        f"frames); tokens agreeing in place with the offline greedy on the "
        f"same features: bf16 kernel {agree(kv_tokens, offline_tokens)}, "
        f"bf16 plain path {agree(kv_tokens, plain_tokens)}, f32 "
        f"{agree(kv_tokens, f32_tokens)}; the offline bf16 kernel's own "
        f"against f32 {agree(offline_tokens, f32_tokens)} and against the "
        f"plain path {agree(offline_tokens, plain_tokens)}; the stream's "
        f"decisions replayed {replayed}: {parted} frames where it is not "
        f"the offline bf16 argmax, the worst {worst_gap:.4g} below it "
        f"(bound {STREAM_DECISION_GAP}; the offline bf16 logits' largest "
        f"error against the f32 twin's {own:.4g}); bf16 kernel launches "
        f"of the stream {n_kv}; reencode: {len(rs._tokens)} tokens, bf16 "
        f"attention launches per chunk {sorted(set(re_launches))}, the "
        f"final transcript starts with the last partial "
        f"{re_final.startswith(re_partials[-1])} [{card}]")
    log(f"run flags (d) witness, the bf16 plain path in the kv_cache "
        f"stream's chunking ({len(ends)} chunks) with no cache, against "
        f"the whole-sequence plain path: err {witness:.3g} of max |enc|, "
        f"greedy tokens agreeing in place "
        f"{agree(chunked_tokens, plain_tokens)}; the kv_cache stream "
        f"against the whole-sequence plain path {err_kv:.3g}, against the "
        f"chunked one {rel_err(stream_enc.float(), chunked_enc.float()):.3g}"
        f", its tokens agreeing with the chunked one's "
        f"{agree(kv_tokens, chunked_tokens)} [{card}]")
    if not kv_tokens or not replayed or worst_gap > STREAM_DECISION_GAP \
            or n_kv or set(re_launches) != {layers * on_card} \
            or not re_final.startswith(re_partials[-1]):
        raise RuntimeError("the bf16 streams failed their check")
    return counts, spk


def hold_stream_kernels(seen, card):
    """Each attention call captured in (d) (one per shape) again through
    the kernel's wrapper, against its plain version on the same tensors:
    the bf16 forward by ``bf16_attention_errors`` (within BF16_FWD_TOL of
    the plain max |o|, and no further from f64 than BF16_F64_RATIO times
    the plain version), the f32 twin's by ``check_path_kernels``. Returns
    the worst of each."""
    import torch
    calls = seen["attention"]
    bf16 = {k: v for k, v in calls.items()
            if v[0][0].dtype == torch.bfloat16}
    if not any(causal for _, _, _, causal in bf16):
        raise RuntimeError("(d) captured no causal bf16 attention call")
    worst = {"bf16_fwd": 0.0, "bf16_f64_ratio": 0.0}
    for (shape, rate, train, causal), (args, seed, scale) in bf16.items():
        if train:
            raise RuntimeError(f"a stream asked the bf16 attention at "
                               f"{shape} for a gradient")
        fwd, _, ratio = bf16_attention_errors(
            args, None, seed, scale, rate, f"the bf16 attention forward at "
            f"(d)'s {shape}{' causal' if causal else ''}", backward=False)
        worst["bf16_fwd"] = max(worst["bf16_fwd"], fwd)
        worst["bf16_f64_ratio"] = max(worst["bf16_f64_ratio"], ratio)
    f32 = check_path_kernels({"attention": {
        k: v for k, v in calls.items() if k not in bf16}, "lattice": {}})
    worst["f32_fwd"] = f32["fwd"]
    frames = sorted({shape[2] for shape, *_ in bf16})
    log(f"run flags (d) kernels against their plain versions on the "
        f"streams' and encodes' own inputs, one call per shape: the bf16 "
        f"attention forward at {len(bf16)} shapes (T {frames}), worst "
        f"{worst['bf16_fwd']:.3g} of max |o| (tol {BF16_FWD_TOL:.3g}), "
        f"against f64 at most {worst['bf16_f64_ratio']:.3f} x the plain "
        f"version's error; the f32 forward at {len(calls) - len(bf16)} "
        f"shapes, worst {f32['fwd']:.3g} of max |o| (atol {ATTN_ATOL}) "
        f"[{card}]")
    return worst


def stream_turns(device, card, trs, wav, spk):
    """ms, device ms and launches a chunk of the f32 and the bf16 kv_cache
    streams (1 s chunks), in the turns of BF16_STREAM_TURNS."""
    import torch
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    streams = {k: t.streaming("kv_cache", speaker_embs=spk[k])
               for k, t in trs.items()}
    readings = collections.defaultdict(list)
    for turn, name in enumerate(BF16_STREAM_TURNS):
        s = streams[name]
        s.reset()
        times, _, _, _ = stream_chunks(s, wav, 1.0, sync)
        line = (f"{name} host ms a chunk median "
                f"{statistics.median(times):.2f}")
        # the device reading at each precision's first turn only: it does
        # not drift as the host clock does, and a profiled stream costs
        # seconds
        if on_card and name not in BF16_STREAM_TURNS[:turn]:
            s.reset()
            _, events = profiled(lambda: stream_chunks(s, wav, 1.0, sync))
            busy = sum(device_us(e) for e in events) / 1e3
            line += (f", device {busy / len(times):.3f} ms and "
                     f"{sum(e.count for e in events) / len(times):.0f} "
                     f"launches a chunk")
        readings[name].append(line)
    log("run flags (d) kv_cache 1 s chunks in turns "
        f"{'/'.join(BF16_STREAM_TURNS)}: " + "; ".join(
            line for name in BF16_STREAM_TURNS[:2] for line in readings[name])
        + f" [{card}]")


def phase_run_flags(device, card, corpus):
    """The recipe's run flags and last switches at the scratch recipe's
    full width: (a) the scratch yaml through its entry module with
    ``--profile``, ``prompt_test``; (b) a warm start from (a)'s
    checkpoint; (c) ``encode_with_attn``; (d) a bf16 causal model
    streaming. Every kernel the path launched is then held against its
    plain version on the tensors it gave it, one call per shape: (a) to
    (c) by ``check_path_kernels``, (d) by ``hold_stream_kernels``. Returns the launch counts
    of the f32 and the bf16 kernels."""
    import torch
    t0 = time.perf_counter()
    marks = []

    def mark(name):
        marks.append(f"{name} {time.perf_counter() - t0:.1f} s")

    root = Path(__file__).resolve().parent
    counts = collections.Counter()
    with captured_kernel_calls() as seen, \
            tempfile.TemporaryDirectory(prefix="tsasr_run_flags_") as tmp:
        tmp = Path(tmp)
        trace_dir = root / "build" / "run_flags_profile"
        if trace_dir.exists():
            for old in trace_dir.glob("*.json"):
                old.unlink()
        reset_counts()
        brain, _ = profiled_prompted_run(device, card, corpus, tmp / "a",
                                         trace_dir)
        source = brain.checkpointer.find_checkpoint(
            min_key="WER").paramfile("brain")
        del brain
        mark("(a)")
        warm_started_run(device, card, corpus, tmp / "b", source)
        mark("(b)")
        attention_maps_check(device, card)
        mark("(c)")
        counts.update(read_bf16_counts())
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reset_counts()
    stream_counts, stream_worst = bf16_stream_checks(device, card)
    counts.update(stream_counts)
    mark("(d)")
    worst = check_path_kernels(seen)
    log(f"run flags kernels against their plain versions on the phase's own "
        f"inputs, one call per shape: (a)-(c) attention at "
        f"{len(seen['attention'])} shapes, worst fwd {worst['fwd']:.3g} of "
        f"max |o|, bwd {worst['bwd']:.3g} of max |g| (atol {ATTN_ATOL}); "
        f"lattice at {len(seen['lattice'])} shapes, worst err/tol "
        f"{worst['lattice']:.3g}; (d) bf16 attention forward worst "
        f"{stream_worst['bf16_fwd']:.3g} of max |o| (tol "
        f"{BF16_FWD_TOL:.3g}), f32 forward {stream_worst['f32_fwd']:.3g}; "
        f"the phase's launches {dict(counts)}; "
        f"{time.perf_counter() - t0:.1f} s (done at: {', '.join(marks)})")
    return dict(counts)


# data parallelism (phase_ddp): the scratch yaml at full width, one
# process in place against the launcher's one NCCL rank and two gloo
# ranks sharing the card
DDP_STEPS = 2                 # optimizer steps, at accumulation 2
DDP_ACCUMULATION = 2
# the debug cut of TEST: the split's first 6 mixtures, 12 utterances of
# one a batch, so two ranks decode 6 batches each, greedy (the beam has
# its own phases); VALID's: its first 12 mixtures, in dynamic batches
DDP_TEST_MIXTURES = 6
DDP_VALID_MIXTURES = 12
DDP_LOSS_RTOL = 1e-5
DDP_GRAD_NCCL = 1e-6          # of each leaf's max |g|: (b) against (a)
# (c) against (a), of each leaf's max |g|: the training phase's rule
# (GRAD_TIGHT_REL, the kink set at GRAD_ATOL_REL), since splitting the
# row sums moves the frontend's convolution gradients past 1e-4 in f32
# (up to 2.9e-4 with no kink in reach, on an H100 80GB HBM3 at 700 W);
# the elements past this are counted and printed
DDP_GRAD_SPLIT = 1e-4
DDP_PROFILED = 4              # the micro-batch each run profiles
DDP_LAUNCH_TIMEOUT = 300
# appended to every run's arguments (a CPU rehearsal narrows the model)
DDP_OVERRIDES = []


def cut_corpus(corpus, folder, cut):
    """``corpus`` with each split named in ``cut`` cut to its first that
    many mixtures (the speakers' folders linked, not copied)."""
    folder.mkdir()
    for entry in Path(corpus).iterdir():
        if entry.suffix == ".jsonl":
            lines = entry.read_text().splitlines(keepends=True)
            lines = lines[:cut.get(entry.stem, len(lines))]
            (folder / entry.name).write_text("".join(lines))
        else:
            (folder / entry.name).symlink_to(entry.resolve())
    return folder


def ddp_args(corpus, out, device, *extra):
    """The scratch yaml's arguments of one phase_ddp run."""
    root = Path(__file__).resolve().parent
    return [str(root / EXPERIMENT_YAML), "--data_folder", str(corpus),
            "--output_folder", str(out), "--fused_attention", "True",
            "--valid_search_freq", "1", "--noprogressbar",
            "--vocab_size", str(corpus_vocab(corpus)), "--num_epochs", "1",
            "--dropout", "0.0",
            "--grad_accumulation_factor", str(DDP_ACCUMULATION),
            "--optimizer_step_limit", str(DDP_STEPS),
            "--test_max_batch_length", "0.5", "--beam_size", "1",
            "--device", device, *extra,
            *DDP_OVERRIDES]


def ddp_run(result_dir, argv, keep=None, hold=True):
    """One run of the scratch entry module with ``argv`` in this process,
    alone or as a launched rank: every batch launches what its shapes
    imply, the kernels it launched are then held against their plain
    versions on its own tensors. Records each micro-batch's loss, host
    ms, loader wait and audio seconds, the all-reduce's ms (CUDA events)
    and bytes, a profile of micro-batch DDP_PROFILED (device busy), the
    TEST batches it decoded, its launches; rank 0 saves the first
    optimizer step's accumulated gradient as ``grad.pt``. ``keep`` (a
    dict) receives the Brain, a copy of its model before the first step
    and the first step's micro-batches; ``hold=False`` leaves the kernels
    unchecked (a run that another repeats bit for bit). Returns the
    record, also written as ``rank{r}.json``."""
    import torch
    from tsasr_torch import train_librispeechmix_scratch as entry
    from tsasr_torch.parallel import distributed
    from tsasr_torch.recipes.librispeechmix import TSASRBrain

    result_dir = Path(result_dir)
    record = collections.defaultdict(list)
    brains, reduce_events, local = [], [], []
    patched = {name: getattr(TSASRBrain, name) for name in
               ("on_fit_start", "_update", "evaluate_batch_extra")}
    all_reduce = distributed.all_reduce_sum

    def started(self):
        brains.append(self)
        return patched["on_fit_start"](self)

    def update(self, params):
        if self.optimizer_step == 0 and distributed.if_main_process():
            torch.save([a.detach().cpu() for a in self._acc],
                       result_dir / "grad.pt")
            if local:
                # the planted fault: rank 0's rows alone, unreduced
                mean = sum(local) / len(local)
                torch.save([part.view_as(a) for part, a in zip(
                    torch.split(mean, [a.numel() for a in self._acc]),
                    self._acc)], result_dir / "grad_local.pt")
        return patched["_update"](self, params)

    def decoded(self, batch, arrays, predictions, stage):
        if stage.name == "TEST":
            record["test_keys"].extend(batch.id)
        return patched["evaluate_batch_extra"](self, batch, arrays,
                                               predictions, stage)

    def timed_all_reduce(tensor):
        if tensor.numel() >= 1024 and len(local) < DDP_ACCUMULATION and \
                distributed.world_size() > 1 and distributed.rank() == 0:
            local.append(tensor.detach().cpu().clone())
        if tensor.numel() < 1024 or not tensor.is_cuda:
            if tensor.numel() >= 1024:
                t0 = time.perf_counter()
                all_reduce(tensor)
                record["allreduce_host_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
                record["allreduce_bytes"] = tensor.numel() * \
                    tensor.element_size()
                return tensor
            return all_reduce(tensor)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        all_reduce(tensor)
        end.record()
        reduce_events.append((start, end))
        record["allreduce_bytes"] = tensor.numel() * tensor.element_size()
        return tensor

    on_card = argv[argv.index("--device") + 1].startswith("cuda")
    t0 = time.perf_counter()
    with captured_kernel_calls() as seen:
        with counted_batches(TSASRBrain, on_card) as (counts, timings):
            fit = TSASRBrain.fit_batch      # counted_batches' wrapper

            def fit_batch(self, batch):
                n = len(record["losses"]) + 1
                if keep is not None and n <= DDP_ACCUMULATION:
                    if n == 1:
                        import copy
                        keep["model0"] = copy.deepcopy(self.model)
                    keep.setdefault("batches", []).append(batch)
                seconds = float((batch.mixed_sig.lengths
                                 * batch.mixed_sig.data.shape[1]).sum()
                                / SAMPLE_RATE)
                record["audio_s"].append(seconds)
                if n == DDP_PROFILED and self.device.type == "cuda":
                    out = []
                    wall, events = profiled(lambda: out.append(
                        fit(self, batch)))
                    record["profiled"] = {
                        "wall_ms": wall,
                        "device_ms": sum(device_us(e) for e in events) / 1e3,
                        "launches": sum(e.count for e in events)}
                    loss = out[0]
                else:
                    loss = fit(self, batch)
                record["losses"].append(loss)
                return loss

            TSASRBrain.fit_batch = fit_batch
            TSASRBrain.on_fit_start = started
            TSASRBrain._update = update
            TSASRBrain.evaluate_batch_extra = decoded
            distributed.all_reduce_sum = timed_all_reduce
            try:
                with deterministic_algorithms(True):
                    entry.main(argv)
            finally:
                for name, fn in patched.items():
                    setattr(TSASRBrain, name, fn)
                TSASRBrain.fit_batch = fit
                distributed.all_reduce_sum = all_reduce
        launches = read_counts()
        [brain] = brains
        if keep is not None:
            keep["brain"] = brain
        if on_card:
            torch.cuda.synchronize()
        record["seconds"] = time.perf_counter() - t0
        worst = check_path_kernels(seen) if hold else None
    record.update(
        rank=distributed.rank(), world=distributed.world_size(),
        place=distributed.describe(), device=str(brain.device),
        launches=launches, worst=worst,
        batches={k: v["batches"] for k, v in counts.items()},
        fit_ms=[t * 1e3 for t in timings["fit_batch_s"]],
        wait_ms=[t * 1e3 for t in timings["loader_wait_s"]],
        allreduce_ms=[s.elapsed_time(e) for s, e in reduce_events],
        shapes={"attention": len(seen["attention"]),
                "lattice": sorted(seen["lattice"])},
        optimizer_step=brain.optimizer_step)
    record = dict(record)
    (result_dir / f"rank{record['rank']}.json").write_text(
        json.dumps(record))
    return record


def ddp_worker(result_dir, argv):
    """``chip_smoke.py --ddp_worker DIR ARGS``: a launched rank's
    ``ddp_run`` (the launcher starts one per rank)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    record = ddp_run(result_dir, argv)
    log(f"ddp worker rank {record['rank']} of {record['world']} done: "
        f"{record['place']} on {record['device']}, {record['seconds']:.1f} s")
    return 0


def ddp_launch(result_dir, nproc, argv):
    """The scratch yaml on ``nproc`` ranks through ``python -m
    tsasr_torch.parallel.launch``, each rank a ``ddp_worker``; returns
    the ranks' records and the launch's wall seconds."""
    import os
    root = Path(__file__).resolve().parent
    result_dir.mkdir(parents=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tsasr_torch.parallel.launch",
         "--nproc_per_node", str(nproc), "--log_dir",
         str(result_dir / "logs"), str(root / "chip_smoke.py"),
         "--ddp_worker", str(result_dir), *argv],
        cwd=root, env=env, capture_output=True, text=True,
        timeout=DDP_LAUNCH_TIMEOUT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-6000:], file=sys.stderr)
        raise RuntimeError(f"the {nproc}-rank launch exited "
                           f"{proc.returncode}")
    return [json.loads((result_dir / f"rank{r}.json").read_text())
            for r in range(nproc)], seconds


def ddp_f64_step(keep):
    """The first optimizer step's gradient (the mean of
    ``keep["batches"]``' gradients) in plain f64 on the weights before
    the step, and the elements held loosely by check_gradients' rule:
    those whose gradient a flip of a pre-activation within KINK_Z of
    leaky_relu's kink (the joint's inside the fused loss too) could move
    by more than half of GRAD_TIGHT_REL of the leaf's max |g|. Returns
    (the f64 gradient and the masks by leaf, on the CPU, the
    pre-activations near the kink, all of them)."""
    import copy
    import torch
    from tsasr_torch.recipes.librispeechmix import TSASRBrain
    brain = keep["brain"]
    wide = TSASRBrain(modules={"model": copy.deepcopy(keep["model0"])},
                      hparams=dict(vars(brain.hparams)),
                      run_opts={"device": str(brain.device)},
                      variant=brain.variant, tokenizer=brain.tokenizer)
    wide.model.double()
    wide.fbank.double()
    bounds, counted, step = {}, [0, 0], None
    n = len(keep["batches"])
    with plain_kernels():
        for batch in keep["batches"]:
            seen, store = [], {}

            def capture(key, module, x, z):
                near = z.detach().abs() < KINK_Z
                counted[0] += int(near.sum())
                counted[1] += near.numel()
                z.register_hook(lambda g: seen.append(
                    (key[0], module, x.detach(), z.detach(), near,
                     g.detach())))

            with pre_activation_hooks(wide.model, capture), \
                    joint_producers(wide.model, store):
                _, grads = loss_and_grads(wide, batch, torch.float64)
            step = [g.cpu() / n for g in grads] if step is None else \
                [a + g.cpu() / n for a, g in zip(step, grads)]
            joint, _, near_j, inside_j = joint_kink_bounds(wide, batch, store)
            counted[0] += int((near_j & inside_j).sum())
            counted[1] += int(inside_j.sum())
            for name, bound in [*kink_bounds(seen).items(), *joint.items()]:
                bounds[name] = bounds.get(name, 0.0) + bound.cpu() / n
            del seen, store, grads
    names = [n for n, _ in wide.model.named_parameters()]
    del wide
    loose = [(bounds[n] > 0.5 * GRAD_TIGHT_REL * w.abs().max())
             if n in bounds else torch.zeros_like(w, dtype=torch.bool)
             for n, w in zip(names, step)]
    return step, loose, counted[0], counted[1]


def ddp_grad_errors(got, want, loose, names):
    """(worst error of the tightly held elements, of the loosely held
    ones, bit for bit, the elements past DDP_GRAD_SPLIT by leaf): each of
    the leaf's max |want|."""
    import torch
    scales = scale_leaves(names)
    tight = held_errors(got, want, loose, False, scales)
    slack = held_errors(got, want, loose, True, scales)
    over = []
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g.double() - w.double()).abs() / w.double().abs().max(
        ).clamp(min=1e-30)
        past = int((err > DDP_GRAD_SPLIT).sum())
        if past:
            over.append((past, f"{names[i]} {past} of {w.numel()} (max "
                         f"{err.max().item():.3g}, "
                         f"{int((loose[i] & (err > DDP_GRAD_SPLIT)).sum())} "
                         "in the kink set)"))
    same = len(got) == len(want) and all(
        torch.equal(g, w) for g, w in zip(got, want))
    over.sort(key=lambda x: -x[0])
    line = (f"{sum(n for n, _ in over)} elements in {len(over)} leaves, "
            "most in " + "; ".join(t for _, t in over[:4])) if over \
        else "none"
    return max(tight), max(slack), same, line


def ddp_readings(name, rec, card):
    """One run's timing lines."""
    warm = slice(1, DDP_PROFILED - 1)     # not the first, not the profiled
    through = [a + b for a, b in zip(rec["fit_ms"], rec["wait_ms"])]
    audio = sum(rec["audio_s"][warm]) / max(sum(through[warm]) / 1e3, 1e-9)
    reduce_ms = rec.get("allreduce_ms") or []
    prof = rec.get("profiled")
    busy = (f"device busy {prof['device_ms']:.1f} of {prof['wall_ms']:.1f} "
            f"ms wall ({100 * prof['device_ms'] / prof['wall_ms']:.1f} %, "
            f"{prof['launches']} launches; micro-batch {DDP_PROFILED}, "
            "the profiler on)" if prof else "device busy not measured")
    log(f"ddp {name}: {rec['place']} on {rec['device']}: ms per micro-batch "
        f"through the loader " + ", ".join(f"{x:.1f}" for x in through)
        + f" (fit_batch " + ", ".join(f"{x:.1f}" for x in rec["fit_ms"])
        + f"); audio-s/s {audio:.1f} over micro-batches 2-"
        f"{DDP_PROFILED - 1}; all-reduce "
        + (", ".join(f"{x:.2f}" for x in reduce_ms) + " ms (events)"
           if reduce_ms else "none on the card")
        + f" of {rec.get('allreduce_bytes', 0) / 1e6:.1f} MB; {busy}; "
        f"the run {rec['seconds']:.1f} s [{card}]")
    return audio


def phase_ddp(device, card, corpus):
    """Data-parallel training and evaluation of the scratch yaml at full
    width, 2 optimizer steps of 2 micro-batches at dropout 0, VALID
    greedy, TEST greedy on a debug cut of its split: (a) one
    process in place; (b) the launcher's one rank on ``cuda`` over NCCL;
    (c) two ranks sharing ``cuda:0`` over gloo, then (c') two ranks
    ``--test_only``. (b) must give (a)'s losses and WER file and its first
    step's gradient within DDP_GRAD_NCCL; (c) each loss within
    DDP_LOSS_RTOL, the gradient by the training phase's rule
    (GRAD_TIGHT_REL, the kink set of ``ddp_f64_step`` at GRAD_ATOL_REL;
    the f32 noise floor, (a) against plain f64, below it and a planted
    fault, rank 0's rows unreduced, above it), a TEST WER file naming
    every utterance once from disjoint shards, which (c') reproduces. Every run's batches launch what their shapes imply and
    each rank holds its kernels against their plain versions. Returns
    the launch counts of all runs."""
    import torch
    on_card = device.type == "cuda"
    counts = collections.Counter()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tsasr_ddp_") as tmp:
        tmp = Path(tmp)
        # VALID's and TEST's first DDP_VALID_MIXTURES, DDP_TEST_MIXTURES
        data = cut_corpus(corpus, tmp / "corpus", {
            EXPERIMENT_SPLITS[1]: DDP_VALID_MIXTURES,
            EXPERIMENT_SPLITS[2]: DDP_TEST_MIXTURES})
        (tmp / "a").mkdir()
        reset_counts()
        keep = {}
        # (b) repeats (a) bit for bit and holds its kernels
        one = ddp_run(tmp / "a", ddp_args(data, tmp / "a" / "out",
                                          str(device)), keep, hold=False)
        counts.update(one["launches"])
        want = torch.load(tmp / "a" / "grad.pt", weights_only=True)
        t_kink = time.perf_counter()
        step64, loose, n_near, n_pre = ddp_f64_step(keep)
        t_kink = time.perf_counter() - t_kink
        names = [n for n, _ in keep["model0"].named_parameters()]
        del keep
        if on_card:
            torch.cuda.empty_cache()
        [nccl], nccl_s = ddp_launch(tmp / "b", 1, ddp_args(
            data, tmp / "b" / "out", "cuda" if on_card else "cpu"))
        [c0, c1], gloo_s = ddp_launch(tmp / "c", 2, ddp_args(
            data, tmp / "c" / "out", "cuda:0" if on_card else "cpu",
            "--data_parallel_count", "2"))
        wer_c = (tmp / "c" / "out" / "wer_test-clean-2mix.txt").read_text()
        (tmp / "c" / "out" / "wer_test-clean-2mix.txt").rename(
            tmp / "c" / "first_wer.txt")
        test_only, test_only_s = ddp_launch(tmp / "c2", 2, ddp_args(
            data, tmp / "c" / "out", "cuda:0" if on_card else "cpu",
            "--test_only"))
        wer_again = (tmp / "c" / "out" /
                     "wer_test-clean-2mix.txt").read_text()
        for rec in (nccl, c0, c1, *test_only):
            counts.update(rec["launches"])
        errs = {name: ddp_grad_errors(torch.load(
                    tmp / path, weights_only=True), want, loose, names)
                for name, path in (("b", "b/grad.pt"), ("c", "c/grad.pt"),
                                   ("fault", "c/grad_local.pt"))}
        errs["floor"] = ddp_grad_errors(want, step64, loose, names)
        del step64
        wer_a = (tmp / "a" / "out" / "wer_test-clean-2mix.txt").read_text()
        wer_b = (tmp / "b" / "out" / "wer_test-clean-2mix.txt").read_text()
        del want
    n_loose = sum(int(m.sum()) for m in loose)
    n_all = sum(m.numel() for m in loose)
    keys = [block.split(",")[0] for block in
            wer_c.split("=" * 80)[2:] if block.strip()]
    n_test = 2 * DDP_TEST_MIXTURES
    shards = [set(c0["test_keys"]), set(c1["test_keys"])]
    loss_err = max(abs(x - y) / abs(y) for rec in (c0, c1)
                   for x, y in zip(rec["losses"], one["losses"]))
    log(f"ddp: the scratch yaml at full width, {DDP_STEPS} optimizer steps "
        f"of {DDP_ACCUMULATION} micro-batches (dropout 0, the yaml's "
        f"augmentation, deterministic algorithms), VALID greedy, TEST "
        f"greedy on {n_test} utterances; runs (a) in place "
        f"{one['seconds']:.1f} s, (b) 1 rank {nccl_s:.1f} s, (c) 2 ranks "
        f"{gloo_s:.1f} s, (c') 2 ranks --test_only {test_only_s:.1f} s "
        f"(launches: process start, imports, the run and its kernel "
        f"checks)")
    log(f"ddp losses: (a) {one['losses']}; (b) {nccl['losses']}; (c) "
        f"{c0['losses']} / {c1['losses']} (worst (c) vs (a) {loss_err:.3g} "
        f"relative, tol {DDP_LOSS_RTOL})")
    log(f"ddp first-step gradient: held loosely {n_loose} of {n_all} "
        f"elements (cap {KINK_LOOSE_SHARE:.2%}), those a flip of the "
        f"{n_near} of {n_pre} pre-activations within |z| < {KINK_Z} of "
        f"leaky_relu's kink in the plain f64 runs of its {DDP_ACCUMULATION} "
        f"micro-batches could move by more than {0.5 * GRAD_TIGHT_REL:.3g} "
        f"of the leaf's max |g|; the f64 runs took {t_kink:.1f} s")
    for name, what, tol in (
            ("b", "(b) vs (a)", f"{DDP_GRAD_NCCL} both"),
            ("c", "(c) vs (a)", f"{GRAD_TIGHT_REL} tight, {GRAD_ATOL_REL} "
             "loosely"),
            ("floor", "the f32 noise floor, (a) vs plain f64",
             f"below {GRAD_TIGHT_REL} tight"),
            ("fault", "a planted fault, (c) rank 0's rows unreduced vs (a)",
             f"above {GRAD_TIGHT_REL} tight")):
        tight, slack, same, over = errs[name]
        log(f"ddp first-step gradient, {what}, of each leaf's max |g|: held "
            f"tight worst {tight:.3g}, loosely {slack:.3g} (tol {tol}); bit "
            f"for bit {same}; past {DDP_GRAD_SPLIT}: {over}")
    log(f"ddp TEST: (c) WER file {len(keys)} entries, {len(set(keys))} "
        f"distinct of {n_test}; shards {len(shards[0])} + {len(shards[1])}, "
        f"shared {sorted(shards[0] & shards[1])}; (c') --test_only WER file "
        f"equal {wer_again == wer_c}; (b) WER file equal to (a)'s "
        f"{wer_b == wer_a}")
    audio = {}
    for name, rec in (("(a) in place", one), ("(b) NCCL, 1 rank", nccl),
                      ("(c) gloo, rank 0 of 2 on one card", c0),
                      ("(c) gloo, rank 1 of 2 on one card", c1)):
        audio[name] = ddp_readings(name, rec, card)
    log(f"ddp audio-s/s two ranks on one card / one rank: "
        f"{audio['(c) gloo, rank 0 of 2 on one card'] / audio['(b) NCCL, 1 rank']:.2f}"
        f" x [{card}]")
    log(f"ddp kernels of (a): batches {one['batches']}, launches "
        f"{one['launches']}, as (b)'s, which holds them")
    for rec in (nccl, c0, c1, *test_only):
        log(f"ddp kernels of {rec['place']} "
            f"({'test_only' if rec in test_only else 'train'}): "
            f"batches {rec['batches']}, launches {rec['launches']}; against "
            f"their plain versions on its own tensors: attention at "
            f"{rec['shapes']['attention']} shapes, worst fwd "
            f"{rec['worst']['fwd']:.3g} / bwd {rec['worst']['bwd']:.3g} of "
            f"max (atol {ATTN_ATOL}); lattice at "
            f"{len(rec['shapes']['lattice'])} shapes, worst err/tol "
            f"{rec['worst']['lattice']:.3g}")
    failures = []
    if one["losses"] != nccl["losses"] or wer_b != wer_a or \
            one["launches"] != nccl["launches"]:
        failures.append("(b)'s losses, WER file or launches are not (a)'s")
    if errs["b"][0] > DDP_GRAD_NCCL or errs["b"][1] > DDP_GRAD_NCCL:
        failures.append("(b)'s gradient is not (a)'s")
    if errs["c"][0] > GRAD_TIGHT_REL or errs["c"][1] > GRAD_ATOL_REL \
            or loss_err > DDP_LOSS_RTOL:
        failures.append("(c)'s gradient or losses are not (a)'s")
    if not errs["floor"][0] < GRAD_TIGHT_REL < errs["fault"][0] or \
            errs["floor"][1] > GRAD_ATOL_REL:
        failures.append("the tolerance is not between the f32 noise floor "
                        "and the planted fault")
    if n_loose > KINK_LOOSE_SHARE * n_all:
        failures.append(f"{n_loose} elements held loosely")
    if sorted(keys) != sorted(set(keys)) or len(keys) != n_test or \
            shards[0] & shards[1] or len(shards[0] | shards[1]) != n_test:
        failures.append("(c)'s TEST is not every utterance once from "
                        "disjoint shards")
    if wer_again != wer_c:
        failures.append("(c')'s --test_only did not reproduce the WER file")
    steps = {rec["optimizer_step"] for rec in (one, nccl, c0, c1)}
    if steps != {DDP_STEPS} or len(one["losses"]) != \
            DDP_STEPS * DDP_ACCUMULATION:
        failures.append(f"optimizer steps {steps}")
    if not {nccl["place"], c0["place"]} >= {
            "rank 0 of 1 over nccl" if on_card else "rank 0 of 1 over gloo",
            "rank 0 of 2 over gloo"}:
        failures.append(f"backends {nccl['place']}, {c0['place']}")
    if failures:
        raise RuntimeError("phase_ddp: " + "; ".join(failures))
    log(f"ddp phase: {time.perf_counter() - t0:.1f} s; launches {dict(counts)}")
    return dict(counts)


def phase_small(device):
    """A small model on the card (kernels) against the CPU (plain):
    serving encoder output, then 2 optimizer steps of training."""
    import numpy as np
    import torch
    from tsasr_torch.data.tokenizer import CharTokenizer
    from tsasr_torch.inference import TSASRTranscriber
    from tsasr_torch.models.transducer import TSTransducer, scratch_config
    from tsasr_torch.training import NoamScheduler

    config = scratch_config(d_model=64, encoder_num_layers=2, d_ffn=128,
                            speaker_encoder_layers=1, decoder_neurons=64,
                            joint_dim=64, frontend_channels=(16, 16),
                            dropout=0.0)
    rng = np.random.default_rng(SEED + 1)
    wavs = [(rng.normal(size=n) * 0.1).astype(np.float32)
            for n in (16000, 12000)]
    enrolls = [(rng.normal(size=n) * 0.1).astype(np.float32)
               for n in (20000, 15000)]
    outs = {}
    # the CPU side twice in this process: a hash that moves between the
    # two is this run's, one that moves only across runs is the host's
    for run, dev in (("cpu", "cpu"), ("cpu again", "cpu"),
                     ("card", str(device))):
        model = TSTransducer(config).init_weights(seed=SEED)
        tr = TSASRTranscriber(model, None, CharTokenizer(PIECES), device=dev)
        enc, _ = tr.encode_batch(wavs, enrolls)
        outs[run] = (enc.cpu(), tr.transcribe_batch(wavs, enrolls))
    err = (outs["cpu"][0] - outs["card"][0]).abs().max().item()
    # a short hash of each side's encoder output: across runs it shows
    # which side moved when the error does
    digest = {run: hashlib.sha256(enc.contiguous().numpy().tobytes())
              .hexdigest()[:12] for run, (enc, _) in outs.items()}
    log(f"small model: card (kernel) vs CPU (plain) encoder max_abs_err "
        f"{err:.3g} (atol {SMALL_ATOL}); encoder sha256 CPU "
        f"{digest['cpu']} then {digest['cpu again']} (twice in this "
        f"process), card {digest['card']}; host CPU {host_cpu()!r}, torch "
        f"threads {torch.get_num_threads()}; transcripts identical: "
        f"{outs['cpu'][1] == outs['card'][1]}")
    if err > SMALL_ATOL:
        raise RuntimeError(f"card and CPU differ by {err} > {SMALL_ATOL}")

    batches = [make_train_batch(np.random.default_rng(SEED + 5 + i), 2, 1,
                                ids=f"s{i}-") for i in range(4)]
    hparams = {"grad_accumulation_factor": 2,
               "noam_scheduler": NoamScheduler(1e-3, 4)}
    runs = []
    for dev in ("cpu", str(device)):
        brain = make_brain(config, dev, hparams)
        grads = step_gradients(brain)
        losses = [brain.fit_batch(b) for b in batches]
        runs.append((losses, [p.detach().cpu() for p in
                              brain.model.parameters()],
                     brain.optimizer_step, grads))
    (l_cpu, p_cpu, s_cpu, g_cpu), (l_gpu, p_gpu, s_gpu, g_gpu) = runs
    names = [n for n, _ in brain.model.named_parameters()]
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_gpu))
    # the gradients Adam is given, per step and leaf, of the leaf's max |g|
    grad_err = max(max(leaf_errors(b, a)) for a, b in zip(g_cpu, g_gpu))

    # Adam's first step moves an element by lr(1) g / (|g| + eps): where g
    # is within f32 rounding of 0 (or of eps), rounding decides that step.
    # The first step's gradient in f64 on the CPU, from the weights both
    # runs start from, says where: the CPU's f32 error against it (its
    # worst leaf) sets how far the card's may be, and an element is held
    # loosely iff an error that large could move its first step by half
    # the parameter tolerance. The CPU alone decides which elements those
    # are; their share is capped.
    g64 = first_step_f64(config, hparams, batches[:2])
    cpu_noise = max(leaf_errors(g_cpu[0], g64))
    card_noise = leaf_errors(g_gpu[0], g64)
    gate = SMALL_NOISE_GATE * cpu_noise
    lr1 = NoamScheduler(1e-3, 4).as_schedule_fn()(1)
    param_tol = 0.1 * lr1
    loose = loosely_held(g64, gate, brain.optimizer.param_groups[0]["eps"],
                         0.5 * param_tol / lr1)
    diffs = [(a - b).abs() for a, b in zip(p_cpu, p_gpu)]
    param_err = max(torch.where(f, 0.0, d).max().item()
                    for f, d in zip(loose, diffs))
    # two Adam steps of at most lr(1) each on either side
    loose_tol = 4 * lr1 + param_tol
    loose_err = max(torch.where(f, d, 0.0).max().item()
                    for f, d in zip(loose, diffs))
    n_loose = sum(int(f.sum()) for f in loose)
    n_all = sum(p.numel() for p in p_cpu)
    moved = max((a - b).abs().max().item() for a, b in zip(
        p_cpu, TSTransducer(config).init_weights(seed=SEED).parameters()))
    witness = "none"
    if n_loose:
        k, i = max(((k, int((d * f).argmax())) for k, (d, f) in
                    enumerate(zip(diffs, loose)) if f.any()),
                   key=lambda x: diffs[x[0]].flatten()[x[1]].item())
        witness = (
            f"{names[k]}[{i}] {diffs[k].flatten()[i].item():.3g} apart, "
            f"first-step gradient f64 {g64[k].flatten()[i].item():.5g}, CPU "
            f"{g_cpu[0][k].flatten()[i].item():.5g}, card "
            f"{g_gpu[0][k].flatten()[i].item():.5g} (leaf max |g| f64 "
            f"{g64[k].abs().max().item():.4g}; clipped, as Adam gets it)")
    log(f"small model training, 4 micro-batches of 2 x 1 s, accumulation "
        f"2, {s_gpu} optimizer steps: card vs CPU losses rel err "
        f"{loss_err:.3g} (tol 1e-4), step gradients {grad_err:.3g} of each "
        f"leaf's max |g| (tol {GRAD_ATOL_REL})")
    log(f"  first-step gradients against f64 on the CPU, of each leaf's "
        f"max |g|: CPU f32 worst leaf {cpu_noise:.3g}, card worst leaf "
        f"{max(card_noise):.3g} ({names[card_noise.index(max(card_noise))]};"
        f" tol {gate:.3g}, {SMALL_NOISE_GATE} x the CPU's), median "
        f"{statistics.median(card_noise):.3g}")
    log(f"  params max_abs_err {param_err:.3g} (tol {param_tol:.3g}, a tenth"
        f" of one update; params moved up to {moved:.3g}); held loosely, "
        f"their first Adam step within rounding: {n_loose} of {n_all} "
        f"(cap {SMALL_LOOSE_SHARE:.0%}), max_abs_err {loose_err:.3g} (tol "
        f"{loose_tol:.3g}), the farthest {witness}")
    if (loss_err > 1e-4 or grad_err > GRAD_ATOL_REL
            or max(card_noise) > gate or param_err > param_tol
            or loose_err > loose_tol or n_loose > SMALL_LOOSE_SHARE * n_all
            or not s_cpu == s_gpu == 2):
        raise RuntimeError("small-model training differs between the card "
                           "and the CPU")


def host_cpu():
    """The host CPU as /proc/cpuinfo names it (model name, vendor, family,
    model and stepping, or an Arm core's implementer and part), the
    machine type, the number of CPUs, whether AVX-512 is offered and a
    hash of the feature flags: the CPU side's f32 kernels follow the
    features the library finds."""
    import os
    import platform
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    flags = fields.get("flags", fields.get("Features", ""))
    name = "; ".join(f"{key} {fields[key]}" for key in (
        "model name", "vendor_id", "cpu family", "model", "stepping",
        "CPU implementer", "CPU part") if key in fields)
    return (f"{name or 'no model in /proc/cpuinfo'} ({platform.machine()}, "
            f"{os.cpu_count()} CPUs, avx512f "
            f"{'avx512f' in flags.split()}, flags sha256 "
            f"{hashlib.sha256(flags.encode()).hexdigest()[:8]})")


def step_gradients(brain):
    """A list that gets, at each optimizer step of ``brain``, the
    gradients the optimizer is given (clipped; copied to the CPU), through
    the optimizer's step pre-hook."""
    brain.init_optimizers()
    grads = []
    brain.optimizer.register_step_pre_hook(
        lambda opt, args, kwargs: grads.append(
            [p.grad.detach().cpu().clone() for g in opt.param_groups
             for p in g["params"]]))
    return grads


def first_step_f64(config, hparams, batches):
    """The gradients of the first optimizer step (the mean over
    ``batches`` at the initial weights, clipped as ``Brain`` clips), with
    the model, its features and the batches in f64 on the CPU."""
    import torch
    from tsasr_torch.training.brain import global_norm

    brain = make_brain(config, "cpu", hparams)
    brain.model.double()
    brain.fbank.double()
    grads = [loss_and_grads(brain, b, torch.float64)[1] for b in batches]
    mean = [sum(g) / len(g) for g in zip(*grads)]
    norm = float(global_norm(mean))
    clip = min(1.0, float(brain.max_grad_norm) / norm)
    return [g * clip for g in mean]


def loosely_held(g64, gate, eps, spread):
    """Per leaf, a bool mask of the elements whose first AdamW step, lr
    times g / (|g| + eps), can move by more than ``spread`` lr when the
    f64 gradient ``g`` is off by ``gate`` of the leaf's max |g|. Elements
    whose gradient is exactly 0 (no path reaches them) stay held."""
    import torch

    def step(x):
        return x / (x.abs() + eps)

    masks = []
    for g in g64:
        d = gate * g.abs().max()
        moves = torch.maximum((step(g + d) - step(g)).abs(),
                              (step(g - d) - step(g)).abs())
        masks.append((moves > spread) & (g != 0))
    return masks


def kernel_entry(name, source, replaces, launches, by_path, row, shape):
    """One kernel's entry; every number is from this run's row at
    ``shape``."""
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "launches_by_path": by_path, "max_abs_err": row["err"],
             "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row.get("library_ms"), "shape": shape}
    for key in ("device_ms", "library_device_ms"):
        if key in row:
            entry[key] = row[key]
    return entry


def main():
    if sys.argv[1:2] == ["--ddp_worker"]:
        return ddp_worker(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--bf16_times"]:
        return bf16_times_worker(sys.argv[2])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "tsasr_torch" / "__init__.py").exists():
        print(f"chip_smoke: no tsasr_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from tsasr_torch import native
    from tsasr_torch.kernels import _build
    from tsasr_torch.kernels import relpos_attention as ra
    from tsasr_torch.kernels import rnnt_lattice as rl
    from tsasr_torch.tools.make_synthetic_dataset import make_dataset

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    t_start = t0 = time.perf_counter()
    # the data loader's host decoder (g++) builds beside the kernels
    # (nvcc), so the experiment's loader waits are not its build
    host = concurrent.futures.ThreadPoolExecutor(1).submit(native.build)
    _build.build([ra.SOURCE, ra.BWD_SOURCE, rl.SOURCE])
    log(f"build: {time.perf_counter() - t0:.1f} s; host decoder "
        f"{host.result().name}")
    for name, entry in _build.build_log.items():
        for line in entry["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
    tensor_core_check(ra.SOURCE, ("relpos_attention_fwd_kernel",))
    tensor_core_check(ra.BWD_SOURCE, ("dq_kernel", "dkv_kernel",
                                      "dp_kernel"))
    tensor_core_check(ra.SOURCE, ("relpos_attention_fwd_bf16_resident_kernel",
                                  "relpos_attention_fwd_bf16_two_pass_kernel"),
                      "BF16")
    tensor_core_check(ra.BWD_SOURCE, ("dq16_kernel", "dkv16_kernel",
                                      "dp16_kernel"), "BF16")

    fwd_rows = phase_attention_fwd(device)
    bwd_rows = phase_attention_bwd(device)
    lattice_rows = phase_lattice(device, card)
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")
    serving = phase_serving(device, card)
    serving_beam = phase_serving_beam(device, card)
    training = phase_training(device, card)
    with tempfile.TemporaryDirectory(prefix="tsasr_corpus_") as tmp:
        # one synthetic corpus for the scratch experiment and the variants
        corpus = Path(tmp) / "corpus"
        make_dataset(str(corpus), **EXPERIMENT_CORPUS)
        experiment = phase_experiment(device, card, corpus)
        log(f"experiment phase done at {time.perf_counter() - t_start:.1f} "
            "s")
        variants = phase_variants(device, card, corpus)
        log(f"variants phase done at {time.perf_counter() - t_start:.1f} s")
        streaming = phase_streaming(device, card, corpus)
        log(f"streaming phase done at {time.perf_counter() - t_start:.1f} "
            "s")
        bf16_fwd, bf16_bwd, bf16_counts, bf16_long = phase_bf16(
            device, card, corpus)
        log(f"bf16 phase done at {time.perf_counter() - t_start:.1f} s")
        run_flags = phase_run_flags(device, card, corpus)
        log(f"run flags phase done at {time.perf_counter() - t_start:.1f} "
            "s")
        ddp = phase_ddp(device, card, corpus)
        log(f"ddp phase done at {time.perf_counter() - t_start:.1f} s")
    switches = phase_switches(device, card)
    log(f"switches phase done at {time.perf_counter() - t_start:.1f} s")
    phase_small(device)
    log(f"all phases done at {time.perf_counter() - t_start:.1f} s")

    def paths(name):
        return {"serving": serving[name],
                "serving_beam": serving_beam[name],
                "training": training[name],
                "experiment": experiment[name],
                "variants": variants[name],
                "streaming": streaming[name],
                "switches": switches[name],
                "run_flags": run_flags[name],
                "ddp": ddp[name]}

    fwd, bwd = fwd_rows[0], next(r for r in bwd_rows if r["T"] == 208)
    kernels = [
        kernel_entry("relpos_attention_fwd",
                     "tsasr_torch/csrc/relpos_attention_fwd.cu",
                     "tsasr_tpu/ops/attention_pallas.py:128",
                     sum(paths("relpos_attention_fwd").values()),
                     paths("relpos_attention_fwd"), fwd,
                     f"B{fwd['B']} H{H} T{fwd['T']} Dh{DH} f32"),
        kernel_entry("relpos_attention_bwd",
                     "tsasr_torch/csrc/relpos_attention_bwd.cu",
                     "tsasr_tpu/ops/attention_pallas.py:143",
                     sum(paths("relpos_attention_bwd").values()),
                     paths("relpos_attention_bwd"), bwd,
                     f"B{B} H{H} T{bwd['T']} Dh{DH} f32"),
    ]
    for name, key, line in (
            ("rnnt_lattice_resident", "resident", 112),
            ("rnnt_lattice_alpha_slab", "alpha", 195),
            ("rnnt_lattice_beta_slab", "beta", 256)):
        row = lattice_rows[key]
        kernels.append(kernel_entry(
            name, "tsasr_torch/csrc/rnnt_lattice.cu",
            f"tsasr_tpu/ops/rnnt_loss_pallas.py:{line}",
            sum(paths(name).values()), paths(name), row,
            row["shape"] + " f32"))
    for name, rows, t in (("relpos_attention_fwd_bf16", bf16_fwd, 101),
                          ("relpos_attention_bwd_bf16", bf16_bwd, 208)):
        row = next(r for r in rows if r["T"] == t)
        line = 128 if "fwd" in name else 143
        by_path = dict(bf16_counts[name], run_flags=run_flags[name],
                       ddp=ddp.get(name, 0))
        kernels.append(kernel_entry(
            name, f"tsasr_torch/csrc/relpos_attention_{name[17:20]}.cu",
            f"tsasr_tpu/ops/attention_pallas.py:{line}",
            sum(by_path.values()), by_path, row,
            f"B{B} H{H} T{t} Dh{DH} bf16"))
        if "fwd" in name:
            # the resident route's launches above; the long route (the
            # two-pass kernel) from T > 3264 at Dh 64, launched by the
            # kernel checks alone
            kernels[-1]["long_route"] = {
                "from_T": bf16_long["T"],
                "launches_in_checks": bf16_long["launches"],
                "max_abs_err": bf16_long["err"]}
    for entry in kernels:
        if entry["launches"] < 1:
            raise RuntimeError(f"{entry['name']} was not launched on the "
                               "main path")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
