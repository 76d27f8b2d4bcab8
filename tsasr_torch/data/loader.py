"""Data loading: prefetching loader with checkpointable iterator position.

The port's own copy of the JAX package's ``data/loader.py``, with its
imports pointed at ``tsasr_torch`` and CUDA where JAX was named.

Equivalent of the reference's loading stack
(``vendor/speechbrain/speechbrain/dataio/dataloader.py``):
- ``SaveableDataLoader`` (:256-335): the number of batches already yielded
  this epoch is saved with a checkpoint and skipped on resume (mid-epoch
  elastic resume). The reference patches torch's
  ``_BaseDataLoaderIter``; here the loader owns its iterator so the
  position is a first-class field.
- ``LoopedLoader`` (:338-411): infinite cycling with nominal epoch length.
- ``make_dataloader``: picks collation and wraps samplers.

Prefetch runs on a background thread (decode + mixing are
numpy/IO-dominated and overlap well with device steps); the batch queue
is bounded to keep host memory flat.

``worker_mode="process"`` instead forks ``num_workers`` OS processes
that evaluate dataset items (decode + mixture synthesis + tokenize —
the per-utterance, numpy-only work) while the parent collates — the
host equivalent of torch DataLoader's worker processes
(``vendor/speechbrain/speechbrain/dataio/dataloader.py`` inherits
them). Batch n is always evaluated by worker ``n % num_workers`` and
reassembled in order, so the batch stream is bit-identical to the
serial loader and ``save_position`` / mid-epoch resume semantics are
unchanged. The measured scaling model (``tools/probe_input_pipeline.py
--split_timing``) is rate(C) = 1/(t_item/C + t_collate): item
evaluation parallelizes across cores, collation stays in the parent.
Fork-safety: workers must never touch CUDA; the item pipeline is
numpy-only by construction (``data/{mixing,dataio,audio}.py``).
"""

import multiprocessing
import pickle
import queue
import threading

from tsasr_torch.data.batch import PaddedBatch


class SaveableDataLoader:
    """Iterates batches of collated examples; resumable mid-epoch."""

    def __init__(self, dataset, batch_size=1, batch_sampler=None,
                 sampler=None, collate_fn=None, drop_last=False,
                 num_workers=0, prefetch=2, pad_to_multiple=None,
                 worker_mode="thread", mp_context="fork"):
        if worker_mode not in ("thread", "process"):
            raise ValueError(
                f"worker_mode must be 'thread' or 'process', "
                f"got {worker_mode!r}")
        self.dataset = dataset
        self.collate_fn = collate_fn or (
            lambda ex: PaddedBatch(ex, pad_to_multiple=pad_to_multiple))
        self.batch_sampler = batch_sampler
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self.mp_context = mp_context
        self.prefetch = max(1, prefetch)
        self._speechbrain_recovery_skip_to = None
        self._num_batches_yielded = 0

    # ------------------------------------------------------------ batches
    def _batch_indices(self):
        if self.batch_sampler is not None:
            yield from self.batch_sampler
            return
        order = list(self.sampler) if self.sampler is not None \
            else range(len(self.dataset))
        batch = []
        for idx in order:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        n = len(self.dataset)
        if self.sampler is not None:
            n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _make_batch(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        skip = self._speechbrain_recovery_skip_to or 0
        self._speechbrain_recovery_skip_to = None
        self._num_batches_yielded = skip

        def gen():
            for n, indices in enumerate(self._batch_indices()):
                if n < skip:
                    continue
                yield self._make_batch(indices)

        if self.num_workers > 0 and self.worker_mode == "process":
            iterator = self._process_iter(skip)
        elif self.num_workers > 0:
            iterator = _prefetch_iter(gen(), self.prefetch)
        else:
            iterator = gen()
        try:
            for batch in iterator:
                self._num_batches_yielded += 1
                yield batch
        finally:
            # an abandoned epoch closes its prefetch or worker iterator
            # now, not when the collector reaches its frame
            iterator.close()
        self._num_batches_yielded = 0

    def _process_iter(self, skip):
        """Fork ``num_workers`` item-evaluation processes; collate in
        the parent. Deterministic: batch n is evaluated by worker
        ``n % W`` and consumed in order, so the stream equals the
        serial loader's exactly (resume counts stay valid)."""
        # "fork" inherits the dataset zero-copy but is unsafe from a
        # multithreaded parent (CUDA runtime threads): configure process
        # mode BEFORE first device use, or pass mp_context="forkserver"
        # (requires a picklable dataset). The per-worker first-payload
        # deadline below fails a fork deadlock fast instead of hanging.
        ctx = multiprocessing.get_context(self.mp_context)
        batches = [list(ix) for ix in self._batch_indices()]
        W = min(self.num_workers, max(1, len(batches) - skip))
        out_qs = [ctx.Queue(maxsize=self.prefetch) for _ in range(W)]
        procs = [
            ctx.Process(
                target=_item_worker,
                args=(self.dataset, batches, skip, wid, W, out_qs[wid]),
                daemon=True)
            for wid in range(W)
        ]
        for p in procs:
            p.start()
        produced = [False] * W
        try:
            for n in range(skip, len(batches)):
                wid = (n - skip) % W
                # A fork-inherited-lock deadlock manifests as a worker
                # that never produces its FIRST payload; 120 s is ample
                # for one batch of numpy work. Later stalls get the
                # long deadline (the item pipeline can legitimately be
                # slow on huge batches).
                deadline = 120.0 if not produced[wid] else 600.0
                waited = 0.0
                while True:
                    try:
                        got_n, payload = out_qs[wid].get(timeout=5.0)
                        produced[wid] = True
                        break
                    except queue.Empty:
                        if not procs[wid].is_alive():
                            raise RuntimeError(
                                f"loader worker {wid} died "
                                f"(exitcode {procs[wid].exitcode})")
                        waited += 5.0
                        if waited >= deadline:
                            # forked children of a multithreaded parent
                            # can (rarely) deadlock on inherited locks;
                            # fail loudly instead of hanging training
                            raise RuntimeError(
                                f"loader worker {wid} produced nothing "
                                f"for {waited:.0f}s (batch {n}) — "
                                "likely a fork deadlock; restart with "
                                "worker_mode='thread' or num_workers=0")
                if isinstance(payload, BaseException):
                    raise payload
                if got_n != n:  # pragma: no cover - internal invariant
                    raise RuntimeError(
                        f"loader worker {wid} returned batch {got_n}, "
                        f"expected {n}")
                yield self.collate_fn(payload)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5.0)

    # --------------------------------------------------------- checkpoint
    def save_position(self):
        """Checkpoint hook payload: batches consumed this epoch."""
        return {"num_batches_yielded": self._num_batches_yielded}

    def load_position(self, state, end_of_epoch=True):
        if not end_of_epoch and state and state.get("num_batches_yielded"):
            self._speechbrain_recovery_skip_to = \
                state["num_batches_yielded"]

    def set_epoch(self, epoch):
        for s in (self.batch_sampler, self.sampler):
            if s is not None and hasattr(s, "set_epoch"):
                s.set_epoch(epoch)


def _item_worker(dataset, batches, skip, wid, W, out_q):
    """Process-worker loop: evaluate this worker's share of batches
    (every W-th starting at skip+wid) and ship the item dicts to the
    parent. Must never touch CUDA (forked child)."""
    try:
        for n in range(skip + wid, len(batches), W):
            out_q.put((n, [dataset[i] for i in batches[n]]))
    except BaseException as e:  # propagate into the parent's iterator
        # Queue.put pickles in a background feeder thread, so an
        # unpicklable exception would NOT raise here — it would kill
        # the feeder and the parent would only see "worker died".
        # Pre-validate picklability and fall back to a string carrier.
        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(
                f"{type(e).__name__}: {e} (in loader worker {wid})")
        out_q.put((-1, e))


def _prefetch_iter(source, depth):
    """Background-thread prefetch of an iterator.

    The worker must DIE when the consumer abandons the generator
    (``debug_batches`` breaks out mid-epoch; tests drop iterators):
    a plain blocking ``q.put`` would park the thread forever on the
    full queue, leaking one thread + the dataset it references per
    abandoned iterator. Every put is therefore guarded by a stop event
    that the generator's ``finally`` sets on close/GC.
    """
    q = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def guarded_put(item):
        """Put unless/until the consumer is gone; True if delivered."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in source:
                if not guarded_put(item):
                    # the consumer is gone: run the source's cleanup
                    source.close()
                    return
            guarded_put(_END)
        except BaseException as e:  # propagate into consumer
            guarded_put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class LoopedLoader:
    """Infinitely cycles a loader; epochs are nominal lengths.

    Used when training by step count rather than dataset passes
    (reference ``dataio/dataloader.py:338-411``).
    """

    def __init__(self, loader, epoch_length):
        self.loader = loader
        self.epoch_length = int(epoch_length)
        self.step = 0
        self.total_steps = 0
        self._iterator = None

    def __iter__(self):
        if self._iterator is None:
            self._iterator = iter(self.loader)
        self.step = 0
        return self

    def __next__(self):
        if self.step >= self.epoch_length:
            raise StopIteration
        self.step += 1
        self.total_steps += 1
        try:
            return next(self._iterator)
        except StopIteration:
            self._iterator = iter(self.loader)
            return next(self._iterator)

    def __len__(self):
        return self.epoch_length

    def save_position(self):
        return {"step": self.step, "total_steps": self.total_steps}

    def load_position(self, state, end_of_epoch=True):
        self.total_steps = state.get("total_steps", 0)
        if not end_of_epoch:
            self.step = state.get("step", 0)


def make_dataloader(dataset, stage="train", looped_nominal_epoch=None,
                    **loader_kwargs):
    """Build a loader the way the reference Brain does
    (``core.py:812-880``): PaddedBatch collation by default, optional
    looped wrapping for nominal epochs."""
    loader = SaveableDataLoader(dataset, **loader_kwargs)
    if looped_nominal_epoch is not None:
        return LoopedLoader(loader, looped_nominal_epoch)
    return loader
