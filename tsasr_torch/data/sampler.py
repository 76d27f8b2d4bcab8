"""Samplers: dynamic length-bucketed batching + reproducible sampling.

The port's own copy of the JAX package's ``data/sampler.py``, with its
imports pointed at ``tsasr_torch``.

Equivalents of the reference sampler suite
(``vendor/speechbrain/speechbrain/dataio/sampler.py``):
- ``DynamicBatchSampler`` (:306-700): length-bucketed batches where bucket
  boundaries come from quantile-warping a fitted lognormal length
  distribution, each bucket holds ``max_batch_length / boundary`` examples
  (capped by ``max_batch_ex``), with epoch-seeded shuffling and
  random/ascending/descending batch ordering.
- ``ReproducibleRandomSampler`` (:30) / ``ReproducibleWeightedRandomSampler``
  (:112): seed + epoch deterministic sampling.
- ``DistributedSamplerWrapper`` (:705-741): shards any (batch) sampler
  across ranks, padding by duplication — used for both train and eval
  sharding (the eval-side dedup happens at metric merge, as in the
  reference recipe).
- ``ConcatDatasetBatchSampler`` (:188) and ``BalancingDataSampler`` (:743).

Implementation is numpy-only (no torch): these run on the host, feeding
the training step on the card.
"""

import bisect

import numpy as np


class ReproducibleRandomSampler:
    """Deterministic permutation sampler: seed + epoch."""

    def __init__(self, data_source, seed=563375142, epoch=0):
        self.data_source = data_source
        self.seed = int(seed)
        self.epoch = int(epoch)

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        return iter(rng.permutation(len(self.data_source)).tolist())

    def __len__(self):
        return len(self.data_source)


class ReproducibleWeightedRandomSampler:
    """Deterministic weighted sampling with replacement: seed + epoch."""

    def __init__(self, weights, num_samples, replacement=True,
                 seed=129491412, epoch=0):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = int(num_samples)
        self.replacement = replacement
        self.seed = int(seed)
        self.epoch = int(epoch)

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        p = self.weights / self.weights.sum()
        idx = rng.choice(len(self.weights), size=self.num_samples,
                         replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


def _lognormal_boundaries(lengths, num_buckets):
    """Bucket boundaries by quantile-warping a fitted lognormal.

    Same statistical idea as the reference
    (``dataio/sampler.py:498-527``): fit a lognormal to the observed
    lengths and place boundaries at equally-spaced quantiles, which gives
    fine boundaries where examples are dense.
    """
    lengths = np.asarray(lengths, np.float64)
    logs = np.log(np.maximum(lengths, 1e-9))
    mu, sigma = logs.mean(), max(logs.std(), 1e-6)
    qs = np.linspace(0, 1, num_buckets + 1)[1:-1]
    # lognormal ppf via the normal quantile function
    from scipy.stats import norm
    bounds = np.exp(mu + sigma * norm.ppf(qs))
    lo, hi = lengths.min(), lengths.max()
    bounds = np.clip(bounds, lo, hi)
    return np.unique(np.concatenate([bounds, [hi]]))


class DynamicBatchSampler:
    """Length-bucketed dynamic batching: each batch's total padded length
    stays under ``max_batch_length`` seconds (or whatever unit
    ``length_func`` returns)."""

    def __init__(self, dataset, max_batch_length, num_buckets=None,
                 length_func=None, shuffle=True, batch_ordering="random",
                 max_batch_ex=None, bucket_boundaries=None, seed=42,
                 epoch=0, drop_last=False):
        self.dataset = dataset
        self.max_batch_length = float(max_batch_length)
        self.shuffle = shuffle
        self.batch_ordering = batch_ordering
        self.max_batch_ex = max_batch_ex or np.inf
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.drop_last = drop_last
        if length_func is None:
            length_func = lambda entry: entry["duration"]  # noqa: E731

        self._lengths = np.asarray([
            float(length_func(self._raw(i))) for i in range(len(dataset))])
        if bucket_boundaries is not None:
            self._boundaries = np.asarray(sorted(bucket_boundaries),
                                          np.float64)
        else:
            num_buckets = num_buckets or max(1, int(np.sqrt(len(dataset))))
            self._boundaries = _lognormal_boundaries(self._lengths,
                                                     num_buckets)
        # per-bucket example capacity: batch is full when adding one more
        # example of this bucket's max length would exceed max_batch_length
        self._bucket_capacity = np.maximum(
            1, (self.max_batch_length // np.maximum(self._boundaries, 1e-9))
            .astype(np.int64))
        self._batches = None

    def _raw(self, i):
        if hasattr(self.dataset, "raw"):
            return self.dataset.raw(i)
        return self.dataset[i]

    def set_epoch(self, epoch):
        self.epoch = int(epoch)
        self._batches = None

    def _generate(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        order = np.arange(len(self._lengths))
        if self.shuffle:
            order = rng.permutation(order)
        buckets = [[] for _ in range(len(self._boundaries))]
        batches = []
        for idx in order:
            length = self._lengths[idx]
            b = bisect.bisect_left(self._boundaries, length)
            b = min(b, len(self._boundaries) - 1)
            buckets[b].append(int(idx))
            cap = min(self._bucket_capacity[b], self.max_batch_ex)
            if len(buckets[b]) >= cap:
                batches.append(buckets[b])
                buckets[b] = []
        if not self.drop_last:
            for bucket in buckets:
                if bucket:
                    batches.append(bucket)
        if self.batch_ordering == "random":
            perm = rng.permutation(len(batches))
            batches = [batches[i] for i in perm]
        elif self.batch_ordering in ("ascending", "descending"):
            batches.sort(
                key=lambda batch: max(self._lengths[i] for i in batch),
                reverse=self.batch_ordering == "descending")
        else:
            raise ValueError(f"batch_ordering={self.batch_ordering}")
        return batches

    def __iter__(self):
        if self._batches is None:
            self._batches = self._generate()
        return iter(self._batches)

    def __len__(self):
        if self._batches is None:
            self._batches = self._generate()
        return len(self._batches)


class DistributedSamplerWrapper:
    """Shard a sampler or batch-sampler across ranks.

    Rank r takes elements r, r+world, r+2*world, ...; the tail is padded
    by duplication so every rank sees the same count (duplicates are
    deduplicated at metric-merge time, reference recipe behavior).
    """

    def __init__(self, sampler, rank=0, world_size=1):
        self.sampler = sampler
        self.rank = int(rank)
        self.world_size = int(world_size)

    def set_epoch(self, epoch):
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __iter__(self):
        items = list(self.sampler)
        if not items:
            return iter(())
        total = -(-len(items) // self.world_size) * self.world_size
        padded = items + items[: total - len(items)]
        return iter(padded[self.rank::self.world_size])

    def __len__(self):
        return -(-len(self.sampler) // self.world_size)


class ConcatDatasetBatchSampler:
    """Round-robin batches drawing a fixed sub-batch from each dataset
    (reference ``dataio/sampler.py:188``-style)."""

    def __init__(self, samplers, batch_sizes, epoch=0):
        if len(samplers) != len(batch_sizes):
            raise ValueError("samplers and batch_sizes must align")
        self.samplers = samplers
        self.batch_sizes = batch_sizes
        self.offsets = np.cumsum([0] + [len(s) for s in samplers])[:-1]
        self.set_epoch(epoch)

    def set_epoch(self, epoch):
        for s in self.samplers:
            if hasattr(s, "set_epoch"):
                s.set_epoch(epoch)

    def __iter__(self):
        iterators = [iter(s) for s in self.samplers]
        while True:
            batch = []
            try:
                for it, bs, off in zip(iterators, self.batch_sizes,
                                       self.offsets):
                    batch.extend(int(off) + next(it) for _ in range(bs))
            except StopIteration:
                return
            yield batch

    def __len__(self):
        return min(len(s) // bs
                   for s, bs in zip(self.samplers, self.batch_sizes))


class BalancingDataSampler(ReproducibleWeightedRandomSampler):
    """Oversample so a key's classes appear equally often
    (reference ``dataio/sampler.py:743``-style)."""

    def __init__(self, dataset, key, num_samples=None, replacement=True,
                 seed=563375142, epoch=0):
        values = []
        for i in range(len(dataset)):
            entry = dataset.raw(i) if hasattr(dataset, "raw") else dataset[i]
            values.append(entry[key])
        uniques, counts = np.unique(values, return_counts=True)
        freq = dict(zip(uniques.tolist(), counts.tolist()))
        weights = np.asarray([1.0 / freq[v] for v in values])
        super().__init__(weights, num_samples or len(dataset), replacement,
                         seed, epoch)
