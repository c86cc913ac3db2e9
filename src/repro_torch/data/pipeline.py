"""Host data pipeline (port of ``repro.data.pipeline``): background
prefetch with exact checkpoint-resume.

Batches are pure functions of (seed, step), so resuming at step N replays
the identical stream.  A worker thread prefetches ``depth`` batches ahead so
host-side generation (and the host-to-device copy, when ``make_batch``
makes one) overlaps the step on the card.  Because batches are made ahead
anyway, the ids of future batches are known before their step runs (the
BagPipe observation, arXiv 2202.12429): ``lookahead(k)`` shows the next k
batches without consuming them, which is how the pipelined trainer plans a
group's cache movement ahead.  ``make_batch`` may end a finite stream by
raising ``StopIteration``.

Under ranks (a ``data > 1`` mesh) each rank's prefetcher makes its data
replica's slice of every batch (``HybridMesh.data_slice``), so
``lookahead(k)`` shows the replica's slices of the next k batches; the
sharded plan gathers the window's ids over the data axis, as it gathers
the batch's.  Every replica must peek the same k (the gather is a
collective): the batches are pure functions of (seed, step), so every
replica's stream ends at the same step.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Iterator, List, Tuple

__all__ = ["Prefetcher"]


class Prefetcher:
    """Wrap ``make_batch(step) -> dict`` with background prefetch from ``start_step``.

    Iteration yields ``(step, batch)`` in order; ``lookahead(k)`` peeks the
    batches the next k ``__next__`` calls would return.  ``close()`` stops
    and *joins* the worker (a drain-only shutdown races with a worker that
    refills after the drain, leaking a blocked daemon thread per trainer
    run).

    End of stream: ``make_batch`` raising ``StopIteration`` ends a finite
    stream cleanly; the buffered batches stay consumable, then iteration
    stops and ``lookahead`` returns what remains.  Any other exception
    re-raises in the consumer, in stream order.
    """

    def __init__(self, make_batch: Callable[[int], Dict], start_step: int = 0, depth: int = 2):
        self.make_batch = make_batch
        self.depth = max(1, depth)
        self._buf: "collections.deque" = collections.deque()
        self._cv = threading.Condition()
        self._err: Exception | None = None
        self._done = False  # the producer ended the stream (StopIteration)
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
            except StopIteration:  # the clean end of a finite stream
                with self._cv:
                    self._done = True
                    self._cv.notify_all()
                return
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

    @property
    def exhausted(self) -> bool:
        """True once the producer has ended the stream (batches may still
        be buffered)."""
        with self._cv:
            return self._done

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> Tuple[int, Dict]:
        with self._cv:
            while not self._buf and self._err is None and not self._done and not self._stop:
                self._cv.wait()
            if self._buf:
                item = self._buf.popleft()
                self._cv.notify_all()  # free a slot for the worker
                return item
            if self._err is not None:
                raise self._err
            raise StopIteration  # stream ended or prefetcher closed

    def lookahead(self, k: int) -> List[Tuple[int, Dict]]:
        """The next ``k`` (step, batch) pairs, not consumed.

        A batch not made yet blocks the call; a list shorter than ``k``
        always means the stream ended (possibly empty); a producer error
        raises here once fewer than ``k`` batches remain; peeking a closed
        prefetcher whose stream had not ended raises ``RuntimeError``.
        Needs ``k <= depth``."""
        if k <= 0:
            return []
        if k > self.depth:
            raise ValueError(f"lookahead({k}) exceeds prefetch depth {self.depth}")
        with self._cv:
            while len(self._buf) < k and self._err is None and not self._done and not self._stop:
                self._cv.wait()
            if len(self._buf) < k:
                if self._err is not None:
                    raise self._err
                if self._stop and not self._done:
                    raise RuntimeError("lookahead on a closed Prefetcher")
            return [self._buf[i] for i in range(min(k, len(self._buf)))]

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
