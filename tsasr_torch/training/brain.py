"""The Brain: one training step and one evaluation step.

Counterpart of the JAX package's ``training/brain.py`` for the pieces a
training step needs. The JAX step is one jitted program; here it is
eager PyTorch with the same semantics:

- gradients of ``grad_accumulation_factor`` micro-batches are averaged
  (``optax.MultiSteps``' running mean); on the last one the mean is
  clipped at global norm ``max_grad_norm`` with optax's formula
  (``g`` if ``|g| < max`` else ``g / |g| * max``, not
  ``clip_grad_norm_``'s ``+1e-6``), then the optimizer steps with the
  learning rate the schedule gives its update count;
- a micro-batch with a nonfinite loss or gradient norm is skipped: no
  micro-step, optimizer step or schedule count advances
  (``brain.py:266-281,357-366`` of the JAX package);
- dropout draws from one ``torch.Generator`` per micro-batch on the
  model's device, seeded from (seed, optimizer step, micro-batch count)
  as the JAX ``fit_batch`` folds its key.

Subclasses provide ``batch_to_arrays``, ``compute_forward`` and
``compute_objectives``. Entry points run on ``device="cuda"`` unless
``run_opts`` asks for the CPU. There is no epoch loop, checkpointing or
data loading yet.
"""

import contextlib
import logging
from types import SimpleNamespace

import numpy as np
import torch

from tsasr_torch.device import resolve_device
from tsasr_torch.utils.stage import Stage

logger = logging.getLogger(__name__)

DEFAULT_RUN_OPTS = {
    "device": "cuda",
    "grad_accumulation_factor": 1,
    "max_grad_norm": 5.0,
    "nonfinite_patience": 3,
}


@contextlib.contextmanager
def onednn_off_on_cpu(device):
    """Context for a training forward + backward: on the CPU it turns
    oneDNN off, whose convolution backward in PyTorch 2.13's CPU build
    corrupts the heap on the frontend's strided convolutions (about every
    other step aborts); PyTorch's own CPU convolutions do not. Elsewhere
    it does nothing."""
    if torch.device(device).type != "cpu":
        yield
        return
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved


def global_norm(tensors):
    """sqrt(sum of squares) over a list of tensors (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t) for t in tensors]))


class Brain:
    """Training orchestrator over ``modules["model"]``.

    opt_class : optimizer factory ``(params) -> torch.optim.Optimizer``
        (``training.optimizers.make_adamw``).
    hparams : plain dict, read as attributes; ``noam_scheduler`` (a
        ``NoamScheduler``) sets the learning rate of every update.
    run_opts : overrides of ``DEFAULT_RUN_OPTS`` (hparams override the
        defaults, run_opts override both).
    """

    def __init__(self, modules=None, opt_class=None, hparams=None,
                 run_opts=None):
        self.opt_class = opt_class
        self.hparams = SimpleNamespace(**(hparams or {}))
        resolved = dict(DEFAULT_RUN_OPTS)
        for key in resolved:
            if hparams and key in hparams:
                resolved[key] = hparams[key]
        for key, value in (run_opts or {}).items():
            if value is not None:
                resolved[key] = value
        for key, value in resolved.items():
            setattr(self, key, value)
        self.device = resolve_device(self.device)
        self.modules = SimpleNamespace(**(modules or {}))
        self.model = getattr(self.modules, "model", None)
        if self.model is not None:
            self.model.to(self.device)
        self.seed = int(getattr(self.hparams, "seed", 0))
        self.optimizer = None
        self.step = 0                   # micro-batches seen by fit_batch
        self.global_micro_step = 0      # micro-batches that counted
        self.optimizer_step = 0         # optimizer updates
        self.nonfinite_count = 0
        self.last_grad_norm = float("nan")
        self._acc = None                # running mean of micro-batch grads
        self._mini_step = 0

    # ================================================== subclass surface
    def compute_forward(self, batch, stage, generator):
        """Forward: batch dict -> predictions."""
        raise NotImplementedError

    def compute_objectives(self, predictions, batch, stage):
        """Predictions + batch -> scalar loss."""
        raise NotImplementedError

    def batch_to_arrays(self, batch):
        """PaddedBatch -> dict of numpy arrays."""
        raise NotImplementedError

    def evaluate_batch_extra(self, batch, arrays, predictions, stage):
        """Per-eval-batch hook (decoding, metrics)."""

    # ========================================================= optimizer
    def _params(self):
        return [p for p in self.model.parameters() if p.requires_grad]

    def init_optimizers(self):
        if self.opt_class is not None and self.optimizer is None:
            self.optimizer = self.opt_class(self._params())

    def _lr_schedule(self):
        sched = getattr(self.hparams, "noam_scheduler", None)
        if sched is not None and getattr(self.hparams, "enable_scheduler",
                                         True):
            return sched.as_schedule_fn()
        return None

    def current_lr(self):
        sched = self._lr_schedule()
        if sched is None:
            return getattr(self.opt_class, "base_lr", 0.0)
        return float(sched(max(self.optimizer_step, 1)))

    # ============================================================ steps
    def step_generator(self):
        """The dropout generator of the current micro-batch."""
        key = np.random.SeedSequence(
            [self.seed, self.optimizer_step * 131071 + self.step])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(key.generate_state(1, np.uint64)[0] >> 1))
        return gen

    def _put_batch(self, arrays):
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in arrays.items()}

    def fit_batch(self, batch):
        """Forward, backward and accumulation of one micro-batch; every
        ``grad_accumulation_factor``-th counted micro-batch also updates
        the parameters. Returns the micro-batch's loss (nonfinite when the
        micro-batch was skipped)."""
        if self.optimizer is None:
            self.init_optimizers()
        arrays = self._put_batch(self.batch_to_arrays(batch))
        self.step += 1
        self.model.train()
        params = self._params()
        with onednn_off_on_cpu(self.device):
            loss = self.compute_objectives(
                self.compute_forward(arrays, Stage.TRAIN,
                                     self.step_generator()),
                arrays, Stage.TRAIN)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        grad_norm = global_norm(grads)
        self.last_grad_norm = float(grad_norm)
        loss_value = loss.item()
        if not (np.isfinite(loss_value) and np.isfinite(self.last_grad_norm)):
            self.nonfinite_count += 1
            logger.warning("Nonfinite batch %d skipped (loss=%s grad_norm=%s,"
                           " patience %d/%d)", self.step, loss_value,
                           self.last_grad_norm, self.nonfinite_count,
                           self.nonfinite_patience)
            if self.nonfinite_count > self.nonfinite_patience:
                raise ValueError("Loss is not finite and patience is "
                                 "exhausted")
            return loss_value
        self._accumulate(grads)
        self.global_micro_step += 1
        if self._mini_step == int(self.grad_accumulation_factor):
            self._update(params)
        return loss_value

    @torch.no_grad()
    def _accumulate(self, grads):
        if self._acc is None:
            self._acc = [torch.zeros_like(g) for g in grads]
        n = self._mini_step + 1
        for acc, g in zip(self._acc, grads):
            acc.add_((g - acc) / n)
        self._mini_step = n

    @torch.no_grad()
    def _update(self, params):
        norm = global_norm(self._acc)
        max_norm = float(self.max_grad_norm)
        clip = torch.where(norm < max_norm, torch.ones_like(norm),
                           max_norm / norm)
        sched = self._lr_schedule()
        if sched is not None:
            # the schedule sees the count of updates made so far (optax's
            # inner count, from 0)
            for group in self.optimizer.param_groups:
                group["lr"] = float(sched(self.optimizer_step))
        for p, acc in zip(params, self._acc):
            p.grad = acc * clip
        self.optimizer.step()
        for p, acc in zip(params, self._acc):
            p.grad = None
            acc.zero_()
        self._mini_step = 0
        self.optimizer_step += 1
        sched_mirror = getattr(self.hparams, "noam_scheduler", None)
        if sched_mirror is not None:
            sched_mirror.n_steps = self.optimizer_step
            sched_mirror.current_lr = self.current_lr()

    def evaluate_batch(self, batch, stage):
        """Loss of one evaluation batch (dropout off), then the
        ``evaluate_batch_extra`` hook."""
        arrays = self._put_batch(self.batch_to_arrays(batch))
        self.model.eval()
        with torch.no_grad():
            predictions = self.compute_forward(arrays, stage, None)
            loss = self.compute_objectives(predictions, arrays, stage)
        self.evaluate_batch_extra(batch, arrays, predictions, stage)
        return float(loss)
