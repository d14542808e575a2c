"""Dynamic request batching for the serving layer.

The HTTP server is threaded (`serve/server.py`); without coalescing, N
concurrent vectorize-bearing requests (`process-by-ids`, manual-data
validation, user-vector refreshes) each run their own device batch — N
small MXU launches instead of one large one. ``DynamicBatcher`` is the
TF-Serving-style leader/follower fix: the first thread to arrive becomes
the leader, waits up to ``max_wait_ms`` for followers (or until
``max_batch`` rows accumulate), runs the wrapped batch function ONCE on the
union, and hands each caller its slice.

The reference has no equivalent (single uvicorn worker, synchronous torch
calls); this is the serving-throughput half of the power-of-2 compile
buckets already applied inside ``model_vectorizer`` — coalesced batches
fill bigger buckets instead of many tiny ones.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

import numpy as np


class DynamicBatcher:
    """Wrap ``fn(list[T]) -> np.ndarray`` (row i of the output corresponds
    to input i) so concurrent ``submit`` calls share device batches.

    Thread-safe; callable like the original function. ``stats()`` reports
    the coalescing ratio for observability.
    """

    def __init__(self, fn: Callable[[list], np.ndarray], *,
                 max_batch: int = 1024, max_wait_ms: float = 2.0):
        self._fn = fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._lock = threading.Lock()
        self._pending: list[dict] = []       # {items, done(Event), out, err}
        self._leader_active = False
        self._calls = 0                      # underlying fn invocations
        self._requests = 0                   # submit() invocations
        self._rows = 0

    # make the batcher a drop-in replacement for the wrapped fn
    def __call__(self, items: Sequence) -> np.ndarray:
        return self.submit(items)

    def submit(self, items: Sequence) -> np.ndarray:
        items = list(items)
        if not items:
            return np.zeros((0,), np.float32)
        req = {"items": items, "done": threading.Event(), "out": None,
               "err": None}
        with self._lock:
            self._pending.append(req)
            self._requests += 1
            self._rows += len(items)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        if lead:
            self._lead()
        req["done"].wait()
        if req["err"] is not None:
            raise req["err"]
        return req["out"]

    def _lead(self) -> None:
        # Collect followers until the window closes or the batch fills.
        deadline = time.monotonic() + self.max_wait_s
        while True:
            with self._lock:
                n = sum(len(r["items"]) for r in self._pending)
            if n >= self.max_batch or time.monotonic() >= deadline:
                break
            time.sleep(min(0.0005, self.max_wait_s / 4))
        with self._lock:
            batch, self._pending = self._pending, []
            self._leader_active = False
        # Run outside the lock: new arrivals elect the next leader while the
        # device is busy with this batch.
        all_items = [it for r in batch for it in r["items"]]
        try:
            out = self._fn(all_items)
            self._calls += 1
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            for r in batch:
                r["err"] = e
                r["done"].set()
            return
        s = 0
        for r in batch:
            k = len(r["items"])
            r["out"] = np.asarray(out[s:s + k])
            s += k
            r["done"].set()

    def stats(self) -> dict:
        with self._lock:
            calls = max(self._calls, 1)
            return {"requests": self._requests, "batch_calls": self._calls,
                    "rows": self._rows,
                    "avg_rows_per_call": self._rows / calls,
                    "coalesce_ratio": self._requests / calls}
