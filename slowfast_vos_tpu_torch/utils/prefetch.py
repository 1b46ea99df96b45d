"""Bounded background prefetch for host-side data pipelines.

The port's copy of `slowfast_vos_tpu/utils/prefetch.py`. One background
thread runs the host iterator (PNG/JPEG decode, augmentation, window
packing) ahead of the consumer into a bounded queue, so host work overlaps
the device's steps, the overlap that `torch.utils.data.DataLoader(num_workers
> 0)` gives the reference's vendored script and that its own drivers
forfeit (`code/train.py:66-67`).

* ONE producer thread, bounded queue: iteration order and any stateful RNG
  draw sequence inside the iterator are exactly those of the serial loop
  (the OSVOS dataset's shared `np.random.Generator` advances in the same
  order).
* Items are HOST data (numpy); device placement stays in the consumer
  thread.
* Exceptions raised by the iterator propagate to the consumer at the point
  of `next()`, not into a dead thread.
* `close()` (also `__exit__`) unblocks and joins the producer even when the
  consumer abandons iteration early, so no thread leaks across epochs. The
  producer is a module-level function holding no reference to the
  PrefetchIterator, so an abandoned iterator stays garbage-collectible and
  `__del__` signals the producer to exit as a best-effort backstop.
* The producer checks the stop flag BEFORE advancing the source iterator, so
  `close()` never triggers (or waits on) one more decode than was consumed.
* Tracer spans (`utils/profiling.py::TRACER`): the producer's
  `prefetch.put_wait` (each put, blocked while the queue is full), the
  consumer's `prefetch.get_wait` (each get, blocked while it is empty);
  counter `prefetch.empty_gets` (gets that found the queue empty).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

from slowfast_vos_tpu_torch.utils.profiling import TRACER

T = TypeVar("T")

_DONE = object()


def _produce(it: Iterator, q: queue.Queue, stop: threading.Event) -> None:
    """Producer loop. Module-level on purpose: a bound method would make the
    thread keep the PrefetchIterator alive, defeating the GC backstop."""

    def put(payload) -> bool:
        # Blocking put that aborts when the consumer closed the iterator.
        with TRACER.span("prefetch.put_wait"):
            while not stop.is_set():
                try:
                    q.put(payload, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

    try:
        while not stop.is_set():
            try:
                item = next(it)
            except StopIteration:
                put((_DONE, None))
                return
            if not put((item, None)):
                return
    except BaseException as exc:  # re-raised in the consumer thread
        put((_DONE, exc))


class PrefetchIterator(Iterator[T]):
    """Iterate `iterable` on a background thread, `depth` items ahead."""

    def __init__(self, iterable: Iterable[T], depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._finished = False
        self._thread = threading.Thread(
            target=_produce, args=(iter(iterable), self._q, self._stop), daemon=True
        )
        self._thread.start()

    def __iter__(self) -> "PrefetchIterator[T]":
        return self

    def __next__(self) -> T:
        if self._finished:
            raise StopIteration
        if TRACER.on and self._q.empty():
            TRACER.count("prefetch.empty_gets")
        with TRACER.span("prefetch.get_wait"):
            item, exc = self._q.get()
        if item is _DONE:
            self._finished = True
            self._thread.join()
            if exc is not None:
                raise exc
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer and reclaim the thread (idempotent)."""
        self._stop.set()
        while True:  # drain so a blocked put observes _stop promptly
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join()
        self._finished = True

    def __enter__(self) -> "PrefetchIterator[T]":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def __del__(self):
        # Best-effort backstop (explicit close() preferred): signal the
        # producer so it exits within one put timeout. Reachable because the
        # producer thread holds (it, q, stop), never `self`. No join here:
        # __del__ may run on an arbitrary thread during interpreter teardown,
        # and on a half-built instance `_stop` may be missing.
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()


def prefetch(iterable: Iterable[T], depth: int = 2) -> PrefetchIterator[T]:
    """`for batch in prefetch(gen()):`: decode the next `depth` items while
    the consumer computes. Always `close()` (or use as a context manager)
    when abandoning iteration early."""
    return PrefetchIterator(iterable, depth)
