"""Cross-request batch aggregation.

Reference: index/impl/gpu/gamma_index_ivfpq_gpu.cc:52,557-640 — the GPU
path runs a dedicated search thread that dequeues up to kMaxBatch=200
concurrently-submitted queries, groups them by compatible parameters
(nprobe), runs ONE batched device search, and notifies the waiting
callers.  SURVEY §2.8 calls this the closest in-repo model for this
design: device throughput comes from batch width, so N concurrent
1-query callers must become one [N, d] dispatch, not N serialized ones.

Mechanics here: callers `submit(key, fn, queries)` and block on an event;
a dispatcher thread drains every pending entry whose `key` matches the
head entry (same field / params / penalty snapshot), concatenates their
query rows, calls `fn` ONCE on the stacked batch, splits the results
back, and wakes the callers.  While one batch runs on the device, new
arrivals queue up and coalesce into the next — the natural pipelining the
reference gets from its queue, with no artificial wait window.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

MAX_BATCH_ROWS = 256       # reference kMaxBatch=200 (gpu.cc:52)


class _Entry:
    __slots__ = ("key", "fn", "q", "event", "result", "error")

    def __init__(self, key, fn, q):
        self.key = key
        self.fn = fn
        self.q = q
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class BatchAggregator:
    def __init__(self, max_batch_rows: int = MAX_BATCH_ROWS):
        self.max_batch_rows = max_batch_rows
        self._cv = threading.Condition()
        self._pending: List[_Entry] = []
        self._stop = False
        self._paused = False          # test hook: hold dispatch
        self._thread: Optional[threading.Thread] = None
        # observability
        self.batches_run = 0
        self.requests_served = 0

    # ---- caller side ----

    def submit(self, key: Tuple, fn: Callable[[np.ndarray], Any],
               queries: np.ndarray):
        """Block until this request's slice of a coalesced batch is done.
        `fn(stacked_queries) -> (dists [B, k], docids [B, k])` must be
        row-independent so slices are exact per-request results."""
        e = _Entry(key, fn, np.asarray(queries))
        with self._cv:
            if self._stop:        # shutting down: degrade to direct call
                return fn(e.q)
            if self._thread is None:
                self._thread = threading.Thread(target=self._run,
                                                daemon=True)
                self._thread.start()
            self._pending.append(e)
            self._cv.notify()
        e.event.wait()
        if e.error is not None:
            raise e.error
        return e.result

    # ---- dispatcher ----

    def _take_group(self) -> List[_Entry]:
        head = self._pending[0]
        group = [head]
        rows = head.q.shape[0]
        rest = []
        for e in self._pending[1:]:
            if (e.key == head.key
                    and rows + e.q.shape[0] <= self.max_batch_rows):
                group.append(e)
                rows += e.q.shape[0]
            else:
                rest.append(e)
        self._pending = rest
        return group

    def _run(self) -> None:
        while True:
            with self._cv:
                while (self._paused or not self._pending) \
                        and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                group = self._take_group()
            try:
                if len(group) == 1:
                    d, i = group[0].fn(group[0].q)
                    group[0].result = (d, i)
                else:
                    q = np.concatenate([e.q for e in group], axis=0)
                    d, i = group[0].fn(q)
                    off = 0
                    for e in group:
                        b = e.q.shape[0]
                        e.result = (d[off: off + b], i[off: off + b])
                        off += b
                self.batches_run += 1
                self.requests_served += len(group)
            except BaseException as ex:   # propagate to every waiter
                for e in group:
                    e.error = ex
            finally:
                for e in group:
                    e.event.set()

    # ---- control ----

    def pause(self) -> None:
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            drained, self._pending = self._pending, []
            self._cv.notify()
        for e in drained:         # never leave a caller blocked forever
            e.error = RuntimeError("batch aggregator stopped")
            e.event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
