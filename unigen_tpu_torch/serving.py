"""Micro-batching request server (port of ``unigen_tpu/serving.py``).

Requests enqueue per-sample input dicts; a worker thread collects up to
``batch_size`` requests (waiting at most ``max_wait_ms`` once the first
request of a batch arrived), pads the tail by repeating the first request's
tensors (pad outputs are discarded), concatenates along axis 0, runs
``run_batch``, copies each output leaf to the host once, splits it back per
request and resolves each request's Future.

Usage, the FLUX pipeline as the JAX package serves it:
    pipe = UniGenFluxPipeline(cfg, params, vae_params=vae, ...)   # on CUDA
    srv = MicroBatchServer(lambda x: pipe.generate(**x, num_inference_steps=4),
                           batch_size=2)
    fut = srv.submit(prompt_embeds=e, pooled=p, cond_pooled=cp,
                     control_pixels=px)             # each leading dim 1
    image = fut.result()[0]                         # uint8 [H, W, 3]
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from unigen_tpu_torch.utils import tree_leaves_with_path, tree_map


@dataclass
class _Request:
    inputs: Dict[str, Any]
    future: Future
    n: int                      # samples in this request (leading-dim size)


@dataclass
class ServerStats:
    batches: int = 0
    requests: int = 0
    samples: int = 0
    padded_samples: int = 0

    @property
    def wasted_pad_fraction(self) -> float:
        total = self.samples + self.padded_samples
        return self.padded_samples / total if total else 0.0


class MicroBatchServer:
    """Pads-and-batches requests into a fixed-size program call.

    run_batch: dict of tensors (leading dim == the dispatched size) -> a
        tensor or a nested dict/list/tuple of tensors with that leading dim.
    batch_size: the largest program batch.
    batch_sizes: optional ascending ladder of program sizes; each dispatch
        pads only up to the smallest size that fits the collected requests.
    max_wait_ms: the longest the worker holds an incomplete batch after its
        first request arrived; 0 flushes at once.
    """

    def __init__(self, run_batch: Callable[[Dict[str, Any]], Any],
                 batch_size: int = 8, max_wait_ms: float = 50.0,
                 batch_sizes: Optional[List[int]] = None):
        assert batch_size >= 1
        self._run = run_batch
        if batch_sizes is not None:
            assert batch_sizes, "batch_sizes must be non-empty"
            self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
            batch_size = self.batch_sizes[-1]
        else:
            self.batch_sizes = (batch_size,)
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.stats = ServerStats()
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        self._close_lock = threading.Lock()      # orders submit() vs close()
        self._carry: Optional[_Request] = None   # did not fit the last batch
        self._shutdown = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ client

    def submit(self, **inputs) -> Future:
        """Enqueue one request. Every array shares one leading dim (usually
        1); the Future resolves to the request's slice of the output."""
        sizes = {k: np.shape(v)[0] for k, v in inputs.items()
                 if hasattr(v, "shape") and len(v.shape) > 0}
        n = next(iter(sizes.values()), 1)
        assert all(s == n for s in sizes.values()), \
            f"inconsistent leading dims: {sizes}"
        assert n <= self.batch_size, \
            f"request of {n} samples exceeds batch_size={self.batch_size}"
        fut: Future = Future()
        # the closed-check and the enqueue are one atomic section vs close()
        with self._close_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._q.put(_Request(inputs, fut, n))
        return fut

    def close(self, *, drain: bool = True):
        """Stop the worker. With drain=True pending requests complete first;
        otherwise queued, undispatched requests are cancelled."""
        with self._close_lock:
            self._closed = True
        if not drain:
            while True:
                try:
                    r = self._q.get_nowait()
                except queue.Empty:
                    break
                if r is not None:
                    r.future.cancel()
        self._q.put(None)
        self._worker.join()

    # ------------------------------------------------------------ worker

    def _collect(self) -> Optional[List[_Request]]:
        """Block for the first request, then fill up to batch_size for at
        most max_wait. None = shutdown. A request that does not fit is held
        in ``self._carry`` and heads the next batch (FIFO kept)."""
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            first = self._q.get()
            if first is None:
                return None
        batch, filled = [first], first.n
        t_end = time.monotonic() + self.max_wait
        while filled < self.batch_size:
            timeout = t_end - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._shutdown = True   # dispatch this batch, then exit
                break
            if filled + nxt.n > self.batch_size:
                self._carry = nxt
                break
            batch.append(nxt)
            filled += nxt.n
        return batch

    def _loop(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            try:
                self._dispatch(batch)
            except Exception as e:  # resolve the batch's futures with the error
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
            if self._shutdown and self._carry is None:
                return

    def _dispatch(self, batch: List[_Request]):
        filled = sum(r.n for r in batch)
        target = next(b for b in self.batch_sizes if b >= filled)
        pad = target - filled
        keys = batch[0].inputs.keys()
        assert all(r.inputs.keys() == keys for r in batch), \
            "all requests must carry the same input names"

        def cat(k):
            parts = [torch.as_tensor(r.inputs[k]) for r in batch]
            if pad:
                parts.append(parts[0][:1].repeat_interleave(pad, dim=0))
            return torch.cat(parts)

        out = self._run({k: cat(k) for k in keys})
        self.stats.batches += 1
        self.stats.requests += len(batch)
        self.stats.samples += filled
        self.stats.padded_samples += pad

        # one device->host copy per leaf, then host-side slicing
        out = tree_map(lambda t: t.detach().cpu(), out)
        leaves = [leaf for _, leaf in tree_leaves_with_path(out)]
        assert leaves and all(leaf.shape[0] == target for leaf in leaves), \
            "run_batch must preserve the leading batch dim"
        off = 0
        for r in batch:
            sl = slice(off, off + r.n)
            if not r.future.done():
                r.future.set_result(tree_map(lambda leaf: leaf[sl], out))
            off += r.n
