"""The port's prefetching loader releases what an abandoned epoch holds.

A consumer that stops mid-epoch (``debug_batches``, a test that drops
its iterator) closes the loader's iterator. The loader then closes its
prefetch iterator itself, and the prefetch thread closes its source on
the way out, so the source's cleanup runs at once. Neither waits for the
interpreter to collect a frame: here the test holds a reference that
would keep each of them alive.
"""

import threading

from tsasr_torch.data import loader as loader_module
from tsasr_torch.data.loader import SaveableDataLoader, _prefetch_iter

# the prefetch thread polls its stop event every 0.1 s
CLOSE_TIMEOUT_S = 5.0


class Sampler:
    """Batches of one index; sets ``closed`` when its iterator's
    cleanup runs."""

    def __init__(self, n):
        self.n = n
        self.closed = threading.Event()

    def __iter__(self):
        try:
            for i in range(self.n):
                yield [i]
        finally:
            self.closed.set()


def test_abandoned_loader_closes_its_prefetch_iterator(monkeypatch):
    """The consumer closes the loader's iterator after one batch of 20:
    the loader closes the prefetch iterator (held alive here by the
    test), whose thread closes the source, whose cleanup runs the
    sampler's."""
    held = []

    class Held:
        def __init__(self, it):
            self.it, self.closed = it, False
            held.append(self)

        def __iter__(self):
            return self

        def __next__(self):
            return next(self.it)

        def close(self):
            self.closed = True
            self.it.close()

    monkeypatch.setattr(loader_module, "_prefetch_iter",
                        lambda source, depth: Held(_prefetch_iter(source,
                                                                  depth)))
    sampler = Sampler(20)
    loader = SaveableDataLoader(list(range(20)), batch_sampler=sampler,
                                collate_fn=lambda items: items,
                                num_workers=1, prefetch=2)
    it = iter(loader)
    assert next(it) == [0]
    it.close()
    assert held and held[0].closed
    assert sampler.closed.wait(CLOSE_TIMEOUT_S)
    assert loader._num_batches_yielded == 1


def test_prefetch_thread_closes_its_source_when_the_consumer_is_gone():
    """A source the test still holds: once the consumer closes the
    prefetch iterator, the thread's next undelivered put ends it, and
    it closes the source."""
    closed = threading.Event()

    def source():
        try:
            yield from range(100)
        finally:
            closed.set()

    src = source()
    it = _prefetch_iter(src, 1)
    assert next(it) == 0
    it.close()
    assert closed.wait(CLOSE_TIMEOUT_S)
    assert src.gi_frame is None


def test_a_whole_epoch_still_yields_every_batch_and_resets_the_count():
    sampler = Sampler(5)
    loader = SaveableDataLoader(list(range(5)), batch_sampler=sampler,
                                collate_fn=lambda items: items,
                                num_workers=1)
    assert list(loader) == [[i] for i in range(5)]
    assert sampler.closed.is_set() and loader._num_batches_yielded == 0
