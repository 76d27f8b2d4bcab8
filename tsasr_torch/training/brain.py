"""The Brain: the fit/evaluate loop over eager training steps.

Counterpart of the JAX package's ``training/brain.py``. The JAX step is
one jitted program; here it is eager PyTorch with the same semantics:

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
  as the JAX ``fit_batch`` folds its key (``step_generator``; other
  streams of it, on the CPU, serve the recipe's augmentation).

The loop is the JAX package's: ``fit`` runs the epochs of
``epoch_counter`` (TRAIN micro-batches through a ``SaveableDataLoader``,
then VALID), with ``debug`` / ``debug_batches`` / ``debug_epochs``,
``optimizer_step_limit``, ``test_only`` and intra-epoch checkpoints by
minutes or optimizer steps; ``evaluate`` recovers the best checkpoint and
runs TEST. A ``Checkpointer`` gets the recoverables ``brain`` (model,
optimizer, the running gradient mean and the counters), ``scheduler``
and ``counter``, then ``dataloader`` just before recovery, in the JAX
order. The loss is read synchronously (``loss.item()``), not one step
late as in JAX.

Subclasses provide ``batch_to_arrays``, ``compute_forward`` and
``compute_objectives``. Entry points run on ``device="cuda"`` unless
``run_opts`` asks for the CPU. ``precision`` (fp32 | bf16) is the
model's compute dtype, which the recipe builds the model with: the
parameters, their gradients, the running gradient mean and the AdamW
state are f32 either way, so the step (clip, AdamW, Noam) is the same.

Data parallelism (a launched run, ``parallel/distributed.py``), with the
JAX package's semantics (its ``recipes/librispeechmix.py:645-666``):

- TRAIN: every rank draws the same global batch from the same sampler;
  ``fit_batch`` takes the rank's contiguous block of its rows, padded to
  a multiple of the world size by zero-weight duplicates
  (``parallel/mesh.py``), and keeps the batch as ``batch_shard`` for the
  recipe (the global loss denominator, draws over the global batch).
  Each rank's loss is its rows' ``sum(w l)`` over the global
  ``max(sum(w), 1)``, so the sum of the ranks' gradients, one
  ``all_reduce`` of a flat buffer per micro-batch (JAX's ``psum``), is
  the global batch's gradient; the loss and the nonfinite flag ride a
  second, small ``all_reduce``, so every rank skips the same
  micro-batches. Accumulation, clipping, AdamW and Noam are unchanged.
  In a group of one the two collectives still run (the identity);
- the weights are broadcast from rank 0 once they are set: at the start
  of ``fit`` (after the init, a warm start or a recovery) and after
  TEST's recovery;
- dropout folds the rank into the step generator when the world has
  more than one rank; at one rank every draw is the one-process draw;
- VALID / TEST: each rank evaluates its own shard of the batches (the
  recipe's loaders) with no collective inside a batch; the stage's loss
  is merged as a mean weighted by batch counts (``_merge_eval_loss``);
- checkpoints: rank 0 names, writes and deletes them
  (``Checkpointer``), and decides the intra-epoch save by minutes; the
  progress bars are rank 0's.

Sequence and pipeline parallelism (``layout``, the run's
``parallel.distributed.Layout``; the JAX package's ``'seq'`` and
``'pipe'`` mesh axes), with the weights replicated on every rank:

- the rows follow the data coordinate (``rank_rows`` with the data
  axis's index and size, padded to a multiple of data·pipe): the ranks
  of one data shard hold the same rows, and dropout folds the data index
  alone into the step generator, so their whole computations draw alike;
- in TRAIN the subclass hands ``layout`` to the model, which splits the
  encoder over the sequence or pipeline axis;
- the gradient counts each parameter once: a gradient the ranks of the
  encoder's axis compute in parts (``MODEL_PARALLEL_PARTIAL`` of the
  model) is summed over them, one that every rank of a data shard
  computes whole is averaged over them (a pipeline axis beside the
  sequence axis computes copies: the encoder takes the sequence axis,
  as JAX routes it), and either is then summed over
  the data axis: one ``all_reduce`` of the flat buffer over the world
  after each gradient is divided by the ranks of its data shard that
  hold a copy of it (``gradient_shares``); the loss likewise;
- VALID and TEST stay rank-local, sharded over all ranks as above.

Tensor parallelism (``layout.tp`` above 1, the JAX package's ``'model'``
axis; ``parallel.tensor_parallel``), with JAX's semantics:

- the model is split once, before the optimizer is made
  (``_ensure_sharded``, JAX's ``_ensure_initialized``): each rank holds
  its shards of the split matrices (``parallel.mesh.param_split_dims``,
  checked by ``validate_tp_shardings``) and the whole other leaves, and
  the optimizer its shards' AdamW moments; the ranks of one data shard
  draw dropout alike, each split activation taking its slice of the
  whole mask;
- the gradient: a split leaf's shard is summed over the data axis
  alone, a whole leaf that each rank reads a slice of is summed over
  the model axis, one every rank computes whole averaged over it
  (``gradient_shares``); the clip norm counts each shard once and each
  whole leaf once (``_global_norm``);
- beside a sequence or pipeline axis (JAX's four-axis mesh), the
  encoder's layers keep their shards but run whole on leaves gathered
  over the model axis once a micro-batch (``MODEL_PARALLEL_GATHERED``
  of the model), the speaker branch runs split; one rule gives each
  gradient its share over both axes, and the shards are summed over
  every axis but the model's;
- under a model axis each shard is broadcast over every axis but the
  model's;
- checkpoints hold the whole model, moments and running mean included:
  every rank gathers before process 0 writes (``_BrainState``), and a
  recovery splits them again, so a checkpoint of any tensor count
  resumes at any other;
- VALID and TEST run a whole copy of the model on each rank's own shard
  of the batches, its weights gathered once per version of them
  (``_eval_model``, JAX's ``_get_eval_params``).
"""

import contextlib
import logging
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from tsasr_torch.convert import shard_tensor
from tsasr_torch.data.loader import LoopedLoader, SaveableDataLoader
from tsasr_torch.device import resolve_device
from tsasr_torch.parallel import distributed, tensor_parallel
from tsasr_torch.parallel.mesh import rank_rows, tp_sharding_report
from tsasr_torch.training.checkpoints import load_state, save_state
from tsasr_torch.utils.stage import Stage

logger = logging.getLogger(__name__)

DEFAULT_RUN_OPTS = {
    "debug": False,
    "debug_batches": 2,
    "debug_epochs": 2,
    "device": "cuda",
    "precision": "fp32",            # fp32 | bf16
    "noprogressbar": False,
    "grad_accumulation_factor": 1,
    "optimizer_step_limit": None,
    "ckpt_interval_minutes": 0,
    "ckpt_interval_steps": 0,
    "max_grad_norm": 5.0,
    "nonfinite_patience": 3,
    "test_only": False,
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
    checkpointer : ``training.checkpoints.Checkpointer`` or None.
    """

    def __init__(self, modules=None, opt_class=None, hparams=None,
                 run_opts=None, checkpointer=None):
        self.opt_class = opt_class
        self.hparams = SimpleNamespace(**(hparams or {}))
        self.checkpointer = checkpointer
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
        self.avg_train_loss = 0.0
        self._acc = None                # running mean of micro-batch grads
        self._mini_step = 0
        self._resume_step = 0           # self.step a recovered epoch resumes
        self._restored_opt_state = None  # recovered before the optimizer
        self._recovered_ckpt = None     # the checkpoint TEST evaluates
        self.batch_shard = None         # the rank's rows of a TRAIN batch
        self.layout = distributed.layout()
        self._shares = None             # gradient_shares, once
        self._tp_kinds = None           # shard_model's, once split
        self._weights_version = 0       # moves on each time they change
        self._eval_copy = None          # the whole model VALID/TEST run
        self._eval_version = None
        self._last_ckpt_time = time.time()
        if self.checkpointer is not None:
            self.checkpointer.add_recoverable("brain", _BrainState(self))
            sched = getattr(self.hparams, "noam_scheduler", None)
            if sched is not None and hasattr(sched, "save"):
                self.checkpointer.add_recoverable("scheduler", sched)
            counter = getattr(self.hparams, "epoch_counter", None)
            if counter is not None and hasattr(counter, "save"):
                self.checkpointer.add_recoverable("counter", counter)

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

    def on_stage_start(self, stage, epoch=None):
        pass

    def on_stage_end(self, stage, stage_loss, epoch=None):
        pass

    def on_fit_start(self):
        pass

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        """After each TRAIN micro-batch (the JAX hook's arguments;
        ``outputs`` is None there too)."""

    def on_evaluate_start(self, max_key=None, min_key=None):
        if self.checkpointer is not None:
            # the recovered checkpoint stays visible to subclasses: the
            # "Epoch loaded" line reports the epoch whose weights are
            # evaluated (keep-best may pick an earlier one than the last)
            self._recovered_ckpt = self.checkpointer.recover_if_possible(
                min_key=min_key, max_key=max_key)
            if self._recovered_ckpt is not None:
                self._broadcast_weights()

    def _broadcast_weights(self):
        """Every rank's weights as rank 0 holds them; under a model axis
        each rank's shard as the first rank that holds the same slice
        (over the data, pipeline and sequence axes in turn) holds it."""
        if self.layout.tp == 1:
            distributed.broadcast_module(self.model)
            return
        for axis in self._shard_axes():
            distributed.broadcast_module(self.model, axis.ranks[0],
                                         axis.group)

    def _shard_axes(self):
        """The axes whose ranks hold the same slices of the split leaves:
        every axis but the model's, where above one rank."""
        layout = self.layout
        return [axis for axis in (layout.data, layout.pipe, layout.seq)
                if axis.size > 1]

    # ========================================================= optimizer
    def _params(self):
        return [p for p in self.model.parameters() if p.requires_grad]

    def _param_names(self):
        return [n for n, p in self.model.named_parameters()
                if p.requires_grad]

    def _ensure_sharded(self):
        """Under a model axis, split the model over it once, the weights
        as they stand (the init or a warm start): each rank keeps its
        shards (``parallel.tensor_parallel.shard_model``)."""
        if self.layout.tp == 1 or self._tp_kinds is not None:
            return
        gathered = () if self.layout.encoder_axis is None else \
            getattr(self.model, "MODEL_PARALLEL_GATHERED", ())
        self._tp_kinds = tensor_parallel.shard_model(
            self.model, self.layout.model, gathered)
        sharded, replicated = tp_sharding_report(self.model.tp_splits)
        logger.info("tensor parallelism: %d leaves split over the model "
                    "axis of %d, %d whole", len(sharded), self.layout.tp,
                    len(replicated))
        if gathered:
            modes = tensor_parallel.module_modes(self.model)
            logger.info(
                "beside the %s axis: %d modules run whole on leaves "
                "gathered over the model axis (%s), %d split",
                self.layout.encoder_axis.name,
                sum(m == "gathered" for m in modes.values()),
                ", ".join(gathered),
                sum(m == "split" for m in modes.values()))
        logger.debug("split leaves: %s", sharded)

    def _split_flags(self):
        """Per trainable parameter, whether the rank holds a shard of it."""
        kinds = self._tp_kinds or {}
        return [kinds.get(n) == "split" for n in self._param_names()]

    def init_optimizers(self):
        self._ensure_sharded()
        if self.opt_class is not None and self.optimizer is None:
            self.optimizer = self.opt_class(self._params())
            if self._restored_opt_state is not None:
                # a checkpoint loaded before the optimizer existed: its
                # moments go onto the new optimizer instead of being lost
                self.optimizer.load_state_dict(self._restored_opt_state)
                self._restored_opt_state = None

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
    def step_generator(self, stream=0):
        """A generator of the current micro-batch. Stream 0, on the
        model's device, draws dropout; another stream is apart from it and
        on the CPU (the recipe's augmentation draws from stream 1). Each is
        seeded from (seed, optimizer step, micro-batch count), so a
        recovered run draws what an uninterrupted one does. Over more
        than one data shard, stream 0 also folds in the data index, so
        the shards' rows draw apart and the ranks of one shard alike; the
        other streams draw for the global batch, the same on every
        rank."""
        entropy = [self.seed, self.optimizer_step * 131071 + self.step]
        if stream:
            entropy.append(stream)
        elif self.layout.dp > 1:
            entropy += [0, self.layout.data.index]
        key = np.random.SeedSequence(entropy)
        gen = torch.Generator(device=self.device if stream == 0 else "cpu")
        gen.manual_seed(int(key.generate_state(1, np.uint64)[0] >> 1))
        return gen

    def _put_batch(self, arrays):
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in arrays.items()}

    def _rank_arrays(self, batch):
        """The host arrays of this rank's rows of ``batch`` (all of them
        in one process); sets ``batch_shard``."""
        arrays = self.batch_to_arrays(batch)
        self.batch_shard = None
        if distributed.world_size() > 1:
            data = self.layout.data
            arrays, self.batch_shard = rank_rows(
                arrays, data.index, data.size, data.size * self.layout.pp)
        return arrays

    def fit_batch(self, batch):
        """Forward, backward and accumulation of one micro-batch; every
        ``grad_accumulation_factor``-th counted micro-batch also updates
        the parameters. Returns the micro-batch's loss (nonfinite when the
        micro-batch was skipped); in a launched run the global batch's,
        on every rank."""
        if self.optimizer is None:
            self.init_optimizers()
        arrays = self._put_batch(self._rank_arrays(batch))
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
        if distributed.is_distributed():
            grads, loss_value, finite = self._all_reduce(grads, loss)
        else:
            self.last_grad_norm = float(self._global_norm(grads))
            loss_value = loss.item()
            finite = np.isfinite(loss_value) and \
                np.isfinite(self.last_grad_norm)
        if not finite:
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

    def gradient_shares(self):
        """Per trainable parameter, 1 / the ranks of a data shard that
        hold a copy of its gradient (None with no model axis). A gradient
        is summed over the ranks that computed parts of it, averaged over
        the ranks that computed it whole, and never summed across the
        model axis where each rank holds a different slice:

        - over the encoder's axis: a leaf of ``MODEL_PARALLEL_PARTIAL``'s
          modules comes in parts (each rank's block or stage), any other
          whole on every rank: 1 or 1 / its size;
        - over the model axis: a split leaf's shard is the rank's slice
          (run split, or whole on gathered leaves) and a leaf a split
          module reads a slice of comes in parts: 1; any other leaf
          every rank computes whole: 1 / T;
        - over the ranks of a data shard on neither axis (the pipeline
          axis beside the sequence axis, which the encoder does not
          use): every leaf a copy, 1 / their count.

        The product of the three. The shards are then summed over every
        axis but the model's, every other leaf over the world
        (``_all_reduce``)."""
        layout = self.layout
        if layout.model_ranks == 1:
            return None
        if self._shares is None:
            axis = layout.encoder_axis
            enc = 1 if axis is None else axis.size
            partial = getattr(self.model, "MODEL_PARALLEL_PARTIAL", ())
            kinds = self._tp_kinds or {}
            copies = layout.model_ranks // (enc * layout.tp)
            self._shares = [
                (1.0 if name.split(".")[0] in partial else 1.0 / enc)
                * (1.0 if name in kinds else 1.0 / layout.tp) / copies
                for name in self._param_names()]
        return self._shares

    @torch.no_grad()
    def _all_reduce(self, grads, loss):
        """Sum the ranks' gradients, one ``all_reduce`` of a flat buffer,
        then their losses and nonfinite flags, a second one; returns
        (the summed gradients, the global loss, whether every rank's
        micro-batch is finite), the same on every rank. Under a model
        axis each gradient is first divided by the copies of it a data
        shard holds (``gradient_shares``), and the loss by the shard's
        ranks; a rank's shards are summed over the ranks that hold the
        same slices (every axis but the model's), the rest over the
        world."""
        shares = self.gradient_shares()
        if shares is not None:
            grads = [g * share for g, share in zip(grads, shares)]
            loss = loss / self.layout.model_ranks
        split = self._split_flags()
        whole = [g for g, s in zip(grads, split) if not s]
        shards = [g for g, s in zip(grads, split) if s]
        whole = _flat_all_reduce(whole, distributed.all_reduce_sum)
        if shards:      # a rank's shards: never over the model axis
            shards = _flat_all_reduce(shards, self._shard_all_reduce)
        parts = iter(whole), iter(shards)
        grads = [next(parts[s]) for s in split]
        grad_norm = self._global_norm(grads)
        dtype = torch.promote_types(loss.dtype, torch.float32)
        stats = torch.stack([loss.detach().to(dtype),
                             (~torch.isfinite(grad_norm)).to(dtype)])
        distributed.all_reduce_sum(stats)
        loss_value, nonfinite = stats.tolist()
        self.last_grad_norm = float(grad_norm)
        return grads, loss_value, np.isfinite(loss_value) and nonfinite == 0

    def _shard_all_reduce(self, flat):
        """``flat`` summed over every axis but the model's, in place."""
        for axis in self._shard_axes():
            axis.all_reduce_sum(flat)
        return flat

    def _global_norm(self, tensors):
        """``global_norm`` of the whole model's gradients from a rank's
        (``tensors``, in parameter order): under a model axis each
        shard's squared norm is summed over the axis, each whole leaf's
        counted once."""
        split = self._split_flags()
        if not any(split):
            return global_norm(tensors)
        norms = torch.stack([torch.linalg.vector_norm(t) for t in tensors])
        flags = torch.tensor(split, device=norms.device)
        sq_split = self.layout.model.all_reduce_sum(
            (norms[flags] ** 2).sum().reshape(1))
        return torch.sqrt(sq_split[0] + (norms[~flags] ** 2).sum())

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
        norm = self._global_norm(self._acc)
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
        self._weights_version += 1
        sched_mirror = getattr(self.hparams, "noam_scheduler", None)
        if sched_mirror is not None:
            sched_mirror.n_steps = self.optimizer_step
            sched_mirror.current_lr = self.current_lr()

    def _eval_model(self):
        """The model VALID and TEST run: the model, or under a model axis
        its whole copy (``tensor_parallel.whole_copy``), its weights
        gathered over the axis once per version of them (every rank
        enters together)."""
        if self.layout.tp == 1:
            return self.model
        self._ensure_sharded()
        if self._eval_copy is None or \
                self._eval_version != self._weights_version:
            state = tensor_parallel.gather_whole(
                self.model.state_dict(), self.model.tp_splits,
                self.layout.model)
            if self._eval_copy is None:
                self._eval_copy = tensor_parallel.whole_copy(self.model,
                                                             state)
            else:
                self._eval_copy.load_state_dict(state)
            self._eval_version = self._weights_version
        return self._eval_copy

    @contextlib.contextmanager
    def _evaluating(self):
        """``self.model`` is ``_eval_model()`` inside."""
        trained, self.model = self.model, self._eval_model()
        try:
            yield
        finally:
            self.model = trained

    def evaluate_batch(self, batch, stage):
        """Loss of one evaluation batch (dropout off), then the
        ``evaluate_batch_extra`` hook."""
        self.batch_shard = None
        arrays = self._put_batch(self.batch_to_arrays(batch))
        with self._evaluating():
            return self._evaluate_batch(batch, arrays, stage)

    def _evaluate_batch(self, batch, arrays, stage):
        self.model.eval()
        with torch.no_grad():
            predictions = self.compute_forward(arrays, stage, None)
            loss = self.compute_objectives(predictions, arrays, stage)
        self.evaluate_batch_extra(batch, arrays, predictions, stage)
        return float(loss)

    # =========================================================== fitting
    @staticmethod
    def _update_average(loss, avg_loss, n):
        """Running mean after the ``n``-th value (nonfinite ones skipped)."""
        if np.isfinite(loss):
            avg_loss -= avg_loss / n
            avg_loss += loss / n
        return avg_loss

    def _progress(self, iterable, desc):
        if self.noprogressbar or not distributed.if_main_process():
            return iterable
        try:
            from tqdm import tqdm
        except ImportError:
            return iterable
        return tqdm(iterable, dynamic_ncols=True, desc=desc)

    def fit(self, epoch_counter, train_set, valid_set=None,
            train_loader_kwargs=None, valid_loader_kwargs=None):
        """Train over ``epoch_counter``'s epochs; each is a TRAIN pass
        over ``train_set`` and a VALID pass over ``valid_set``."""
        if not isinstance(train_set, (SaveableDataLoader, LoopedLoader)):
            train_set = SaveableDataLoader(train_set,
                                           **(train_loader_kwargs or {}))
        if valid_set is not None and not isinstance(
                valid_set, (SaveableDataLoader, LoopedLoader)):
            valid_set = SaveableDataLoader(valid_set,
                                           **(valid_loader_kwargs or {}))
        self.train_loader = train_set
        self.on_fit_start()
        self.init_optimizers()
        if self.debug and self.checkpointer is not None and \
                not getattr(self, "_debug_ckpt_diverted", False):
            # debug runs checkpoint into a throwaway dir (reference
            # core.py:670-685), rank 0's
            self.checkpointer.checkpoints_dir = distributed.broadcast_object(
                tempfile.mkdtemp(prefix="tsasr_debug_ckpt_")
                if distributed.if_main_process() else None)
            self._debug_ckpt_diverted = True
        if self.checkpointer is not None:
            self.checkpointer.add_recoverable("dataloader", train_set)
            self.checkpointer.recover_if_possible()
        # the weights as rank 0 set them: the init, a warm start, a recovery
        self._broadcast_weights()
        if self.test_only:
            logger.info("test_only: skipping training")
            return
        for epoch in epoch_counter:
            self._fit_train(train_set, epoch)
            self._fit_valid(valid_set, epoch)
            if self.debug and epoch >= self.debug_epochs:
                logger.info("Debug mode: stopping after %d epochs", epoch)
                break
            if self.optimizer_step_limit is not None and \
                    self.optimizer_step >= self.optimizer_step_limit:
                logger.info("Reached optimizer step limit (%d)",
                            self.optimizer_step_limit)
                break

    def _fit_train(self, train_set, epoch):
        self.on_stage_start(Stage.TRAIN, epoch)
        if hasattr(train_set, "set_epoch"):
            train_set.set_epoch(epoch)
        # a mid-epoch recovery resumes the count of the epoch's batches,
        # so the dropout draws go on as in an uninterrupted epoch
        self.step, self._resume_step = self._resume_step, 0
        self.avg_train_loss = 0.0
        bar = self._progress(train_set, f"Epoch {epoch}")
        iterator = iter(bar)
        n = 0
        for batch in iterator:
            should_step = ((self.global_micro_step + 1)
                           % int(self.grad_accumulation_factor)) == 0
            loss = self.fit_batch(batch)
            logger.debug("TRAIN micro-batch %d loss %r", self.step, loss)
            self.on_fit_batch_end(batch, None, loss, should_step)
            n += 1
            self.avg_train_loss = self._update_average(
                loss, self.avg_train_loss, n)
            if bar is not train_set:
                bar.set_postfix(train_loss=f"{self.avg_train_loss:.3f}")
            self._maybe_intra_epoch_ckpt()
            if self.debug and self.step >= self.debug_batches:
                break
            if self.optimizer_step_limit is not None and \
                    self.optimizer_step >= self.optimizer_step_limit:
                break
        if hasattr(iterator, "close"):
            iterator.close()        # reaps the loader's prefetch workers
        self.on_stage_end(Stage.TRAIN, self.avg_train_loss, epoch)
        self.step = 0

    def _maybe_intra_epoch_ckpt(self):
        if self.checkpointer is None:
            return
        by_minutes = self.ckpt_interval_minutes and (
            time.time() - self._last_ckpt_time
            >= self.ckpt_interval_minutes * 60)
        by_steps = self.ckpt_interval_steps and \
            self.optimizer_step > 0 and \
            self.optimizer_step % self.ckpt_interval_steps == 0 and \
            (self.step % self.grad_accumulation_factor) == 0
        if self.ckpt_interval_minutes and distributed.world_size() > 1:
            # wall clocks drift across processes, and a save is entered
            # by all: rank 0 decides
            by_minutes = distributed.broadcast_object(bool(by_minutes))
        if by_minutes or by_steps:
            # only intra-epoch checkpoints compete for deletion: the
            # end-of-epoch keep-N-best set is untouchable (reference
            # core.py:1241-1257 passes the same ckpt_predicate)
            self.checkpointer.save_and_keep_only(
                meta={"unfinished_epoch": True}, end_of_epoch=False,
                num_to_keep=1,
                importance_key=lambda c: c.unixtime,
                ckpt_predicate=lambda c: c.meta.get(
                    "unfinished_epoch", False))
            self._last_ckpt_time = time.time()

    def _eval_loop(self, dataset, stage, desc):
        avg_loss = 0.0
        self.step = 0
        for batch in self._progress(dataset, desc):
            self.step += 1
            loss = self.evaluate_batch(batch, stage)
            avg_loss = self._update_average(loss, avg_loss, self.step)
            if self.debug and self.step >= self.debug_batches:
                break
        avg_loss = self._merge_eval_loss(avg_loss, self.step)
        self.step = 0
        return avg_loss

    @staticmethod
    def _merge_eval_loss(avg_loss, n_batches):
        """The ranks' average losses over their own shards, merged as a
        mean weighted by their batch counts."""
        if distributed.world_size() <= 1:
            return avg_loss
        rows = distributed.all_gather_object([float(avg_loss),
                                              int(n_batches)])
        total = sum(n for _, n in rows)
        return (sum(loss * n for loss, n in rows) / total
                if total else avg_loss)

    def _fit_valid(self, valid_set, epoch):
        if valid_set is None:
            return
        self.on_stage_start(Stage.VALID, epoch)
        avg_loss = self._eval_loop(valid_set, Stage.VALID, "Valid")
        self.on_stage_end(Stage.VALID, avg_loss, epoch)

    def evaluate(self, test_set, max_key=None, min_key=None,
                 test_loader_kwargs=None):
        """Recover the best checkpoint by ``min_key`` / ``max_key`` and
        run TEST over ``test_set``; returns the average loss."""
        if not isinstance(test_set, (SaveableDataLoader, LoopedLoader)):
            test_set = SaveableDataLoader(test_set,
                                          **(test_loader_kwargs or {}))
        self._ensure_sharded()
        self.on_evaluate_start(max_key=max_key, min_key=min_key)
        self.on_stage_start(Stage.TEST, epoch=None)
        avg_loss = self._eval_loop(test_set, Stage.TEST, "Test")
        self.on_stage_end(Stage.TEST, avg_loss, epoch=None)
        return avg_loss


def _flat_all_reduce(tensors, reduce):
    """``tensors`` summed by ``reduce`` (an in-place all-reduce of one
    tensor) as one flat buffer; the sums in order."""
    if not tensors:
        return []
    flat = reduce(torch.cat([t.reshape(-1) for t in tensors]))
    return [part.view_as(t) for part, t in
            zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


class _BrainState:
    """Checkpoint adapter for the Brain's train state: the model's and
    the optimizer's state dicts, the running mean of the accumulated
    gradients with its micro-step (an intra-epoch checkpoint can land in
    the middle of an accumulation), and the counters, with the epoch's
    batch count of an intra-epoch checkpoint. The dropout generator is
    derived from the seed and the counters, so restoring them restores
    the random draws too.

    Under a model axis the state is the whole model's: every rank enters
    ``prepare_save`` (the Checkpointer calls it before process 0 writes),
    which gathers the shards of the weights, of their AdamW moments and
    of the running mean; ``load`` splits a whole state again, so the
    file is a one-process checkpoint either way."""

    def __init__(self, brain):
        self.brain = brain
        self._prepared = None

    def prepare_save(self):
        state = self._state()
        self._prepared = state if distributed.if_main_process() else None

    def _split_leaves(self, model, acc, optimizer, leaf):
        """(model, acc, optimizer) states with each split leaf's weight,
        running mean and AdamW moments replaced by ``leaf(name, tensor,
        dim)``; as they are without a model axis."""
        brain = self.brain
        if brain._tp_kinds is None:
            return model, acc, optimizer
        splits, names = brain.model.tp_splits, brain._param_names()

        def fn(name, t):
            dim = splits.get(name)
            return t if dim is None else leaf(name, t, dim)

        model = {n: fn(n, t) for n, t in model.items()}
        if acc is not None:
            acc = [fn(n, a) for n, a in zip(names, acc)]
        if optimizer is not None:
            optimizer = dict(optimizer, state={
                i: {k: fn(names[int(i)], v) if torch.is_tensor(v) and v.dim()
                    else v for k, v in entry.items()}     # moments, not steps
                for i, entry in optimizer["state"].items()})
        return model, acc, optimizer

    def _state(self):
        brain = self.brain
        optimizer = brain.optimizer.state_dict() \
            if brain.optimizer is not None else brain._restored_opt_state
        axis = brain.layout.model
        model, acc, optimizer = self._split_leaves(
            brain.model.state_dict(), brain._acc, optimizer,
            lambda name, t, dim: tensor_parallel.gather_leaf(name, t, dim,
                                                             axis))
        return {
            "model": model,
            "optimizer": optimizer,
            "acc": acc,
            "mini_step": brain._mini_step,
            "step": brain.step,
            "optimizer_step": brain.optimizer_step,
            "global_micro_step": brain.global_micro_step,
            "nonfinite_count": brain.nonfinite_count,
        }

    def save(self, path):
        state = self._prepared if self._prepared is not None \
            else self._state()
        self._prepared = None
        save_state(state, path)

    def load(self, path, end_of_epoch=True):
        brain = self.brain
        brain._ensure_sharded()
        state = load_state(path)
        axis = brain.layout.model
        model, acc, optimizer = self._split_leaves(
            state["model"], state["acc"], state["optimizer"],
            lambda name, t, dim: shard_tensor(name, t, dim, axis.index,
                                              axis.size).clone())
        brain.model.load_state_dict(model)
        if optimizer is not None:
            if brain.optimizer is not None:
                brain.optimizer.load_state_dict(optimizer)
            else:
                brain._restored_opt_state = optimizer
        brain._acc = None if acc is None else \
            [a.to(brain.device) for a in acc]
        brain._mini_step = int(state["mini_step"])
        brain.optimizer_step = int(state["optimizer_step"])
        brain.global_micro_step = int(state["global_micro_step"])
        brain.nonfinite_count = int(state["nonfinite_count"])
        brain.step = brain._resume_step = \
            0 if end_of_epoch else int(state["step"])
        brain._weights_version += 1
