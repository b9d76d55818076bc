"""Background-thread batch prefetcher (port of
``unigen_tpu/data/prefetch.py``).

The reference overlaps host preprocessing with device compute via torch
DataLoader workers (train.py:368-376). Here a small thread pool drains the
batch source ahead of the training loop so VAE/text encode + host image work
overlap the (asynchronously launched) device step. Bounded queue -> bounded memory.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional


class Prefetcher:
    """Wrap an iterable of batches with N worker threads and a bounded queue.

    map_fn (optional) runs inside the workers — put host-side preprocessing
    (decode/resize/normalize, e.g. data/native.py calls) there.
    """

    _DONE = object()

    def __init__(self, source: Iterable, *, depth: int = 4, workers: int = 1,
                 map_fn: Optional[Callable[[Any], Any]] = None):
        self._source = iter(source)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._map = map_fn or (lambda x: x)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wait_s = 0.0           # consumer time blocked on an empty queue
        self._got = 0                # batches delivered
        self._threads = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(workers)]
        self._live = len(self._threads)
        for t in self._threads:
            t.start()

    def stats(self) -> dict:
        """Input-boundness accounting: ``wait_s`` is the cumulative consumer
        time spent blocked on an empty queue (the training loop was starved
        by the host pipeline), ``batches`` the deliveries. starvation
        fraction over a timed window = wait_s_delta / window_wall."""
        return {"wait_s": self._wait_s, "batches": self._got}

    def _next_item(self):
        with self._lock:
            return next(self._source)

    def _work(self):
        while not self._stop.is_set():
            try:
                item = self._next_item()
            except StopIteration:
                break
            except Exception as e:  # surface errors to the consumer
                self._q.put(e)
                break
            try:
                self._q.put(self._map(item))
            except Exception as e:
                self._q.put(e)
                break
        with self._lock:
            self._live -= 1
            if self._live == 0:
                self._q.put(self._DONE)

    def __iter__(self) -> Iterator:
        import time
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                t0 = time.perf_counter()
                item = self._q.get()
                self._wait_s += time.perf_counter() - t0
            if item is self._DONE:
                return
            if isinstance(item, Exception):
                raise item
            self._got += 1
            yield item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
