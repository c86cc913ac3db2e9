"""Host data pipeline (port of ``repro.data.pipeline``): background
prefetch with exact checkpoint-resume.

Batches are pure functions of (seed, step), so resuming at step N replays
the identical stream.  A worker thread prefetches ``depth`` batches ahead so
host-side generation (and the host-to-device copy, when ``make_batch``
makes one) overlaps the step on the card.  Lookahead and finite streams
come with the port's pipelining slice, which reads them.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Iterator, Tuple

__all__ = ["Prefetcher"]


class Prefetcher:
    """Wrap ``make_batch(step) -> dict`` with background prefetch from ``start_step``.

    Iteration yields ``(step, batch)`` in order.  An exception in
    ``make_batch`` re-raises in the consumer, in stream order.  ``close()``
    stops and *joins* the worker (a drain-only shutdown races with a worker
    that refills after the drain, leaking a blocked daemon thread per
    trainer run).
    """

    def __init__(self, make_batch: Callable[[int], Dict], start_step: int = 0, depth: int = 2):
        self.make_batch = make_batch
        self.depth = max(1, depth)
        self._buf: "collections.deque" = collections.deque()
        self._cv = threading.Condition()
        self._err: Exception | None = None
        self._stop = False
        self._start = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._start
        while True:
            with self._cv:
                while len(self._buf) >= self.depth and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
            try:
                batch = self.make_batch(step)
            except Exception as e:  # surface in consumer, in stream order
                with self._cv:
                    self._err = e
                    self._cv.notify_all()
                return
            with self._cv:
                if self._stop:
                    return
                self._buf.append((step, batch))
                self._cv.notify_all()
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> Tuple[int, Dict]:
        with self._cv:
            while not self._buf and self._err is None and not self._stop:
                self._cv.wait()
            if self._buf:
                item = self._buf.popleft()
                self._cv.notify_all()  # free a slot for the worker
                return item
            if self._err is not None:
                raise self._err
            raise StopIteration  # prefetcher closed

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        # bounded join: the worker is a daemon, so if it is wedged inside a
        # blocking make_batch we must not hang the caller (often a `finally:`
        # with the real exception in flight) — it dies with the process.
        self._thread.join(timeout=10.0)
        with self._cv:
            self._buf.clear()
