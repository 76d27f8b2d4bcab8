"""Profiling: ``torch.profiler`` traces around Brain loops.

Counterpart of the JAX package's ``utils/profiling.py``: the same
warmup-aware schedule around ``fit_batch`` / ``evaluate_batch``, a named
region per call, and time / memory reports. Where the JAX profiler
writes xplane traces, this one writes a Chrome trace per active window
(``trace_steps_<first>-<last>.json`` in ``logdir``), which Perfetto
(``ui.perfetto.dev``) or ``chrome://tracing`` opens.

Usage::

    profiler = Profiler(logdir, schedule_fn=schedule(wait=5, active=3),
                        device="cuda")
    brain = profile(brain, profiler)     # hooks fit_batch/evaluate_batch
    ... brain.fit(...)
    profiler.stop()                       # writes a window still open
    report_time(profiler)

The profiler records the host's operators always and the card's kernels
when its ``device`` is CUDA (the default, which raises without a card);
``device="cpu"`` records the host alone. With CUDA activity on, an
eager step of thousands of small launches takes visibly longer on the
host clock: compare profiled host times only with profiled ones.

One difference from the JAX package: the JAX recipe never stops its
profiler, so a run whose last profiled step falls inside the active
window leaves that trace open. ``stop`` ends an open window and writes
its trace, and the recipe calls it after ``fit`` and after TEST.
"""

import functools
import logging
import os
import time
from dataclasses import dataclass

import torch

from tsasr_torch.device import resolve_device

logger = logging.getLogger(__name__)


def schedule(wait=2, warmup=2, active=2, repeat=1):
    """Step -> action mapping, mirroring torch.profiler.schedule
    semantics: skip ``wait``, warm up ``warmup``, record ``active``,
    repeat (0: without end)."""
    cycle = wait + warmup + active

    def fn(step):
        if repeat and step >= cycle * repeat:
            return "none"
        pos = step % cycle
        if pos < wait:
            return "none"
        if pos < wait + warmup:
            return "warmup"
        return "active"

    return fn


@dataclass
class _StepTime:
    name: str
    seconds: float


class Profiler:
    """Scheduled ``torch.profiler`` capture + wall-clock accounting.
    ``traces`` lists the files written so far."""

    def __init__(self, logdir="profiler_logs", schedule_fn=None,
                 device="cuda"):
        self.logdir = logdir
        self.schedule_fn = schedule_fn or schedule()
        self.device = resolve_device(device)
        self.step_num = 0
        self.step_times = []
        self.traces = []
        self._prof = None
        self._first = None

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def step(self):
        """Advance one step; starts/stops the trace per the schedule."""
        self.step_num += 1
        action = self.schedule_fn(self.step_num)
        if action == "active" and self._prof is None:
            os.makedirs(self.logdir, exist_ok=True)
            self._prof = torch.profiler.profile(
                activities=self._activities(),
                profile_memory=True)
            self._prof.start()
            self._first = self.step_num + 1
            logger.info("profiler: trace started at step %d -> %s",
                        self.step_num, self.logdir)
        elif action != "active" and self._prof is not None:
            self._write()
            logger.info("profiler: trace stopped at step %d",
                        self.step_num)

    def stop(self):
        """End an open window and write its trace; a window that no call
        has run in yet ends without a file. The schedule goes on: its next
        active step opens a new window."""
        if self._prof is None:
            return
        if self.step_num < self._first:
            self._prof.stop()
            self._prof = None
            return
        self._write()
        logger.info("profiler: trace stopped by stop() at step %d",
                    self.step_num)

    def _write(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        path = os.path.join(
            self.logdir, f"trace_steps_{self._first}-{self.step_num}.json")
        self._prof.export_chrome_trace(path)
        self.traces.append(path)
        self._prof = None

    def record(self, name, seconds):
        self.step_times.append(_StepTime(name, seconds))

    def annotate(self, name):
        """Context manager adding a named region to the trace."""
        return torch.profiler.record_function(name)


def profile(brain, profiler=None, logdir="profiler_logs"):
    """Hook a Brain's hot methods with timing + scheduled tracing (the
    JAX ``profile``); without ``profiler``, one on the Brain's device."""
    if profiler is None:
        profiler = Profiler(logdir, device=brain.device)
    brain.profiler = profiler
    for method in ("fit_batch", "evaluate_batch"):
        if not hasattr(brain, method):
            continue
        original = getattr(brain, method)

        @functools.wraps(original)
        def wrapped(*args, __orig=original, __name=method, **kwargs):
            start = time.perf_counter()
            with profiler.annotate(__name):
                out = __orig(*args, **kwargs)
            profiler.record(__name, time.perf_counter() - start)
            profiler.step()
            return out

        setattr(brain, method, wrapped)
    return brain


def report_time(profiler, file=None):
    """Aggregate per-method wall-clock (the JAX ``report_time``'s text)."""
    from collections import defaultdict
    totals = defaultdict(float)
    counts = defaultdict(int)
    for st in profiler.step_times:
        totals[st.name] += st.seconds
        counts[st.name] += 1
    lines = []
    for name in sorted(totals):
        mean_ms = 1000 * totals[name] / counts[name]
        lines.append(f"{name}: {counts[name]} calls, total "
                     f"{totals[name]:.2f}s, mean {mean_ms:.1f}ms")
    text = "\n".join(lines)
    if file is not None:
        print(text, file=file)
    return text


def report_memory(device="cuda", file=None):
    """The card's allocated memory now and at its peak
    (``torch.cuda.memory_stats`` of ``device``); a CPU device has no
    such statistics."""
    device = resolve_device(device)
    text = "no device memory stats available"
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        used = stats.get("allocated_bytes.all.current", 0) / 2**20
        peak = stats.get("allocated_bytes.all.peak", 0) / 2**20
        text = f"{device}: {used:.1f} MiB in use, peak {peak:.1f} MiB"
    if file is not None:
        print(text, file=file)
    return text
