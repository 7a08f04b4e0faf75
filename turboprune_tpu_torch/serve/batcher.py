"""DynamicBatcher — micro-batching queue between callers and the engine
(a copy of ``turboprune_tpu/serve/batcher.py``: plain Python and numpy).

Requests (each a [k, H, W, C] float array, k >= 1) land on a BOUNDED queue
(backpressure: a full queue rejects with QueueFullError so the HTTP layer
can answer 503 instead of building an unbounded backlog). One worker thread
drains it: a batch opens when the first request is picked up and flushes
when either ``max_batch`` rows are waiting or ``max_wait_ms`` has elapsed
since the batch opened — the classic deadline/size dynamic-batching policy.
The concatenated rows go through ``engine.predict`` (which pads to the
warmed bucket) and each caller's Future receives exactly its own rows
back.

The JAX package's replica pool (micro-batches round-robin over several
engines) serves the fleet and is not ported: the flush runs inline in the
worker thread.

Graceful shutdown: ``drain(deadline_s)`` stops admitting work (new submits
are rejected like a full queue), waits until every already-accepted request
has been answered or the deadline passes, then closes. SIGTERM handling in
run_server_torch.py goes through this, so a rolling restart answers its
in-flight requests instead of dropping them.

Latency recorded per request is submit -> result (queue wait + batching
wait + padded forward), i.e. what a caller actually experiences.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np


class QueueFullError(RuntimeError):
    """Bounded request queue is full (or draining) — shed load (HTTP 503)."""


class _Request:
    __slots__ = ("images", "future", "t_submit")

    def __init__(self, images: np.ndarray, future: Future, t_submit: float):
        self.images = images
        self.future = future
        self.t_submit = t_submit


class DynamicBatcher:
    def __init__(
        self,
        engine,
        *,
        max_batch: int = 128,
        max_wait_ms: float = 5.0,
        queue_depth: int = 256,
        metrics=None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.metrics = metrics
        self._queue: queue.Queue[_Request] = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        # Event, not a bare bool: set on the shutdown path, read by every
        # submitter thread — an Event makes the write visible immediately.
        self._draining = threading.Event()
        self._outstanding = 0  # guarded-by: _outstanding_lock
        self._outstanding_lock = threading.Lock()
        # Admission barrier: submit() enqueues under this lock after
        # re-checking _draining; close() takes it (after stopping the
        # worker) around the straggler-fail sweep. Without it a submitter
        # that passed the draining check could land a request in the queue
        # AFTER the sweep — accepted, but never answered.
        self._admit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "DynamicBatcher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="turboprune-batcher", daemon=True
            )
            self._thread.start()
        return self

    def drain(self, deadline_s: float = 10.0) -> dict:
        """Graceful shutdown: reject new submits, answer everything already
        accepted (queued or mid-flush) within ``deadline_s``, then close.
        Returns {"drained": bool, "unanswered": n} — unanswered requests
        past the deadline get the close-time RuntimeError."""
        self._draining.set()
        deadline = time.perf_counter() + max(0.0, float(deadline_s))
        while time.perf_counter() < deadline:
            with self._outstanding_lock:
                n = self._outstanding
            if n == 0:
                break
            time.sleep(0.005)
        with self._outstanding_lock:
            unanswered = self._outstanding
        self.close()
        return {"drained": unanswered == 0, "unanswered": unanswered}

    def close(self, timeout: float = 5.0) -> None:
        self._draining.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        # Fail any stragglers instead of leaving callers blocked forever.
        # Under _admit_lock: a submitter mid-admission finishes (its request
        # lands before the sweep and is failed here); any submitter arriving
        # after the sweep re-checks _draining under the lock and sheds.
        with self._admit_lock:
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                self._finish(req, error=RuntimeError("batcher closed"))

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    # ------------------------------------------------------------- clients
    def submit(self, images: np.ndarray) -> Future:
        """Enqueue one request; returns a Future resolving to its logits.
        Raises QueueFullError when the bounded queue is at capacity or the
        batcher is draining."""
        if self._draining.is_set() or self._stop.is_set():
            if self.metrics:
                self.metrics.inc("rejected_total")
            raise QueueFullError("batcher is draining — shed load")
        x = np.asarray(images, np.float32)
        if x.ndim == len(self.engine.input_shape):
            x = x[None]
        if (
            x.ndim != len(self.engine.input_shape) + 1
            or x.shape[1:] != self.engine.input_shape
            or x.shape[0] == 0
        ):
            raise ValueError(
                f"expected [k, {', '.join(map(str, self.engine.input_shape))}]"
                f" with k >= 1, got {x.shape}"
            )
        req = _Request(x, Future(), time.perf_counter())
        with self._admit_lock:
            # Re-check under the admission lock: once close() has swept the
            # queue (it holds this lock to do so), every later submitter
            # must see _draining set here and shed instead of enqueueing
            # into a dead queue.
            if self._draining.is_set() or self._stop.is_set():
                if self.metrics:
                    self.metrics.inc("rejected_total")
                raise QueueFullError("batcher is draining — shed load")
            with self._outstanding_lock:
                self._outstanding += 1
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                with self._outstanding_lock:
                    self._outstanding -= 1
                if self.metrics:
                    self.metrics.inc("rejected_total")
                raise QueueFullError(
                    f"request queue full ({self._queue.maxsize} pending)"
                ) from None
        if self.metrics:
            self.metrics.inc("requests_total")
            self.metrics.set_gauge("queue_depth", self._queue.qsize())
        return req.future

    # -------------------------------------------------------------- worker
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            rows = first.images.shape[0]
            deadline = time.perf_counter() + self.max_wait_s
            while rows < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                batch.append(nxt)
                rows += nxt.images.shape[0]
            if self.metrics:
                self.metrics.set_gauge("queue_depth", self._queue.qsize())
            self._flush(batch, rows)

    def _finish(self, req: _Request, result=None, error=None) -> None:
        if error is not None:
            req.future.set_exception(error)
        else:
            req.future.set_result(result)
        with self._outstanding_lock:
            self._outstanding -= 1

    def _flush(self, batch: list[_Request], rows: int) -> None:
        images = (
            batch[0].images
            if len(batch) == 1
            else np.concatenate([r.images for r in batch])
        )
        try:
            logits = self.engine.predict(images)
        except Exception as e:  # surface to every caller, keep serving
            if self.metrics:
                self.metrics.inc("errors_total", len(batch))
            for req in batch:
                self._finish(req, error=e)
            return
        done = time.perf_counter()
        offset = 0
        for req in batch:
            k = req.images.shape[0]
            self._finish(req, result=logits[offset : offset + k])
            offset += k
            if self.metrics:
                self.metrics.observe_latency_ms((done - req.t_submit) * 1e3)
        if self.metrics:
            self.metrics.observe_batch(rows)
