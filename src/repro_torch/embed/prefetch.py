"""Async double-buffered minibatch prefetcher: twin of
``repro/embed/prefetch.py``.

``data/pipeline.py`` samples on the host (numpy); the step runs on the
device. Without overlap the step waits for sampling every iteration. :class:`PrefetchIterator`
moves the producer onto a daemon thread behind a bounded queue
(``depth`` slots — ``depth=2`` is classic double buffering): while the
consumer steps batch ``i``, the thread is already sampling batches
``i+1..i+depth``.

The producer thread only builds host batches: moving a batch to the card
stays on the consumer's thread (``consume``, applied to each batch as
``__next__`` hands it out; the train CLI passes its move to the device).

Determinism: the wrapped iterator is consumed by exactly one thread in
order and the queue preserves order, so the consumed sequence equals the
non-prefetched sequence element for element under a fixed seed (pinned
by test). Exceptions in the producer propagate to the consumer at the
failing position; ``close()`` (idempotent, also called by the train
loop's ``finally``) stops the thread without draining the stream.

``stats()`` exposes the overlap evidence the bench and tests assert on:
``max_occupancy`` (batches that were ready and waiting — >= 1 means the
producer genuinely ran ahead) and ``ready_hits`` (consumer arrivals that
did not block).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

_SENTINEL = object()


class PrefetchIterator:
    """Wrap ``source`` in a background producer with ``depth`` buffered
    batches. Iterate it exactly like the source; call :meth:`close` when
    abandoning it early (the train loop does)."""

    # the train loop keys its finally-close on this (plain generators
    # also have .close(), which it must NOT call)
    is_prefetcher = True

    def __init__(self, source: Iterator, depth: int = 2,
                 consume: Optional[Callable[[Any], Any]] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._source = source
        self._consume = consume
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._error = None
        self.produced = 0
        self.consumed = 0
        self.max_occupancy = 0
        self.ready_hits = 0
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        try:
            for item in self._source:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
                self.produced += 1
            self._q.put(_SENTINEL)
        except BaseException as exc:  # propagate to the consumer
            self._error = exc
            try:
                self._q.put(_SENTINEL, timeout=0.05)
            except queue.Full:
                pass

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        occ = self._q.qsize()
        if occ > self.max_occupancy:
            self.max_occupancy = occ
        if occ > 0:
            self.ready_hits += 1
        item = self._q.get()
        if item is _SENTINEL:
            self._stop.set()
            if self._error is not None:
                raise self._error
            raise StopIteration
        self.consumed += 1
        return item if self._consume is None else self._consume(item)

    def close(self) -> None:
        """Stop the producer thread (idempotent; safe mid-stream)."""
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def stats(self) -> Dict[str, int]:
        return {"produced": self.produced, "consumed": self.consumed,
                "max_occupancy": self.max_occupancy,
                "ready_hits": self.ready_hits, "depth": self.depth}
