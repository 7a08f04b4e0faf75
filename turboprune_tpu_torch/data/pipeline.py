"""Streaming input pipeline (port of ``turboprune_tpu/data/pipeline.py``):
one instrumented prefetch engine for the host-fed loaders (.tpk today).

``PrefetchEngine`` is the JAX package's, as it is: a three-stage pipeline,
decode, transfer and compute all in flight at once:

  decode    N pool workers execute zero-arg decode tasks; at most ``depth``
            tasks are in flight (a bounded ring — memory stays bounded no
            matter how far the consumer falls behind)
  transfer  one thread consumes decoded host batches IN SUBMIT ORDER,
            groups them (``group`` consecutive batches per call — the
            chunked train path stacks K batches into one [K, B, ...] device
            batch), applies the caller's ``transfer`` function, and feeds a
            bounded output queue
  consumer  the training loop pulls device-resident batches off the queue

Contract:
  * results come out in task-submission order, whatever the worker count
  * a task (or transfer) exception is re-raised to the consumer on its
    next pull, with the worker's original traceback attached
  * ``close()`` is idempotent, joins the transfer thread, cancels pending
    decode tasks, and never deadlocks — even when the consumer abandons
    the iterator mid-epoch
  * ``stats()`` reports per-stage wall time so a run can say whether an
    epoch was decode-bound (``decode_wait_s``), transfer-bound
    (``transfer_wait_s``) or compute-bound (``consumer_wait_s``)

Bounded-memory guarantee: decoded-but-unconsumed batches never exceed
``depth`` (futures ring) + ``depth`` (output queue) + ``group`` (held by
the transfer stage while assembling one call).

The transfer stage is PyTorch's idiom for host-to-device input
(``DeviceTransfer``): the decoded uint8 batch sits in a pinned host buffer
(``HostBuffers``), ``copy_(non_blocking=True)`` moves it on a side CUDA
stream, the ImageNet normalisation runs there in float32, and an event is
recorded that the consumer's stream waits on before its first use of the
batch (``stream_batches``). A host buffer goes back to its pool with that
event and is handed out again only once the event has completed, so no
copy ever reads a buffer that is being refilled. On a CPU device the same
code does a plain copy.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

from .augment import IMAGENET_MEAN, IMAGENET_STD, normalize_uint8

DecodeTask = Callable[[], Any]
TransferFn = Callable[[list], list]
# Called with a decoded host batch and the event after which the copy from
# it is complete (None: already complete), when the transfer is enqueued.
Recycle = Callable[[tuple, Optional[torch.cuda.Event]], None]

_DONE = object()


class _Failure:
    """A worker/transfer exception crossing the thread boundary."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchEngine:
    """Bounded multi-stage prefetch (see module docstring).

    ``tasks``     iterable of zero-arg callables returning one host batch.
                  Executed on ``workers`` pool threads, at most ``depth``
                  in flight; results are consumed in submission order.
    ``transfer``  called on the transfer thread with a list of ``group``
                  consecutive decoded batches (the final group may be
                  shorter); returns a LIST of items to emit downstream.
    """

    def __init__(
        self,
        tasks: Iterable[DecodeTask],
        transfer: TransferFn,
        *,
        depth: int = 4,
        workers: int = 1,
        group: int = 1,
        name: str = "pipeline",
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        self._tasks = iter(tasks)
        self._transfer = transfer
        self._depth = depth
        self._group = group
        self._out: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False  # guarded-by: _lock
        self._finished = False  # guarded-by: _lock
        self._lock = threading.Lock()
        self._stats = {  # guarded-by: _lock
            "batches_decoded": 0,
            "items_emitted": 0,
            "decode_wait_s": 0.0,
            "transfer_wait_s": 0.0,
            "backpressure_s": 0.0,
            "consumer_wait_s": 0.0,
        }
        self._meta = {"depth": depth, "workers": workers, "group": group}
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix=f"{name}-decode"
        )
        self._ring: deque = deque()
        self._fill_ring()
        self._thread = threading.Thread(
            target=self._run_transfer, name=f"{name}-transfer", daemon=True
        )
        self._thread.start()

    # --------------------------------------------------------------- decode
    def _fill_ring(self) -> None:
        """Keep up to ``depth`` decode tasks in flight."""
        while len(self._ring) < self._depth:
            try:
                task = next(self._tasks)
            except StopIteration:
                return
            self._ring.append(self._pool.submit(task))

    # ------------------------------------------------------------- transfer
    def _run_transfer(self) -> None:
        try:
            while not self._stop.is_set():
                batches = []
                while len(batches) < self._group and self._ring:
                    fut = self._ring.popleft()
                    self._fill_ring()  # refill BEFORE blocking on fut
                    t0 = time.perf_counter()
                    batches.append(fut.result())
                    self._bump("decode_wait_s", time.perf_counter() - t0)
                    self._bump("batches_decoded", 1)
                    if self._stop.is_set():
                        return
                if not batches:
                    break  # tasks exhausted
                t0 = time.perf_counter()
                items = self._transfer(batches)
                self._bump("transfer_wait_s", time.perf_counter() - t0)
                for item in items:
                    if not self._put(item):
                        return
                    self._bump("items_emitted", 1)
            if not self._stop.is_set():
                self._put(_DONE)
        # graftlint: disable=broad-except -- thread boundary: ANY decode/transfer failure must cross to the consumer thread and re-raise there with its original traceback, not die silently in a daemon thread
        except BaseException as e:
            for fut in self._ring:
                fut.cancel()
            self._put(_Failure(e))

    def _put(self, item) -> bool:
        """Queue.put that stays responsive to close(); returns False when
        the engine was stopped while waiting (consumer gone)."""
        t0 = time.perf_counter()
        while not self._stop.is_set():
            try:
                self._out.put(item, timeout=0.05)
                self._bump("backpressure_s", time.perf_counter() - t0)
                return True
            except queue.Full:
                continue
        return False

    def _bump(self, key: str, delta) -> None:
        with self._lock:
            self._stats[key] += delta

    # ------------------------------------------------------------- consumer
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        with self._lock:
            finished = self._finished
        if finished:
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            try:
                item = self._out.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._out.empty():
                    # The transfer thread always enqueues _DONE or _Failure
                    # before exiting; reaching here means it was killed
                    # abnormally (interpreter teardown) — fail loudly
                    # rather than block forever.
                    with self._lock:
                        self._finished = True
                    raise RuntimeError(
                        "prefetch pipeline transfer thread died without "
                        "signalling completion"
                    ) from None
        self._bump("consumer_wait_s", time.perf_counter() - t0)
        if item is _DONE:
            with self._lock:
                self._finished = True
            raise StopIteration
        if isinstance(item, _Failure):
            with self._lock:
                self._finished = True
            self.close()
            if isinstance(item.exc, StopIteration):
                # A StopIteration raised inside __next__ would silently end
                # the epoch early — surface it as a hard error instead.
                raise RuntimeError(
                    "decode task raised StopIteration"
                ) from item.exc
            raise item.exc  # original worker traceback rides on the exc
        return item

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Stop the pipeline and join its threads. Idempotent; safe to call
        with the transfer thread blocked on a full output queue or on an
        in-flight decode (pending tasks are cancelled, running ones are
        waited out)."""
        # Check-then-act under the lock: the consumer's failure path, the
        # generator's finally, and __del__ can all race into close(); only
        # one of them may run the join/shutdown sequence.
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._finished = True
        self._stop.set()
        # Unblock a transfer thread stuck in _put (bounded queue full).
        while True:
            try:
                self._out.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=60.0)
        for fut in self._ring:
            fut.cancel()
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "PrefetchEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover — GC backstop only
        try:
            self.close()
        # graftlint: disable=broad-except -- interpreter-teardown backstop: close() during GC may find modules already torn down; the deterministic path is the explicit close() in stream_batches
        except Exception:
            pass

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Per-stage wall-time snapshot (see module docstring for the
        stage semantics)."""
        with self._lock:
            out = dict(self._stats)
        out.update(self._meta)
        return out


# --------------------------------------------------------- host buffers
class HostBuffers:
    """Reusable host buffers for decoded batches: (images uint8, labels
    int32) CPU tensors of one shape, pinned when the batches go to a CUDA
    device. ``acquire`` hands out a buffer whose last copy to the device has
    completed (or a new one); ``release`` takes one back together with the
    event after which its copy is complete. A buffer is never handed out, or
    dropped, while a copy from it may still be in flight: it stays in the
    pool until its event has completed. Thread-safe (decode workers acquire,
    the transfer thread releases)."""

    def __init__(self, images_shape: tuple, pin: bool):
        self.images_shape = tuple(images_shape)
        self.pin = pin
        self.allocated = 0  # guarded-by: _lock
        self._free: deque = deque()  # guarded-by: _lock; (images, labels, event)
        self._lock = threading.Lock()

    def acquire(self) -> tuple[torch.Tensor, torch.Tensor]:
        with self._lock:
            for i, (images, labels, event) in enumerate(self._free):
                if event is None or event.query():
                    del self._free[i]
                    return images, labels
            self.allocated += 1
        return (
            torch.empty(self.images_shape, dtype=torch.uint8, pin_memory=self.pin),
            torch.empty(self.images_shape[:1], dtype=torch.int32, pin_memory=self.pin),
        )

    def release(self, batch: tuple, event: Optional[torch.cuda.Event]) -> None:
        images, labels = batch
        with self._lock:
            self._free.append((images, labels, event))


# ------------------------------------------------------------ transfer fns
class DeviceTransfer:
    """Decoded host batches -> normalised device batches.

    ``__call__(batches, stacked)`` copies each (uint8 images NHWC, integer
    labels) host batch to ``device`` — into one [K, B, H, W, C] tensor when
    ``stacked`` — normalises the images to float32 with the ImageNet mean
    and std and widens the labels to int64 (what the loss takes). On CUDA
    all of it runs on a side stream (``copy_(non_blocking=True)`` from
    pinned memory, then the normalisation), and the returned item carries
    the event recorded after it; the result tensors are marked as used by
    the consumer's stream (the stream current where this object was made),
    so the allocator does not hand their memory to the side stream again
    before the consumer is done with them. ``recycle`` gets each host batch
    back with that event. On a CPU device: the same copies, no stream, no
    event."""

    def __init__(self, device: str | torch.device, recycle: Optional[Recycle] = None):
        self.device = torch.device(device)
        self.recycle = recycle
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.consumer = torch.cuda.current_stream(self.device) if self.cuda else None

    def __call__(self, batches: list, stacked: bool):
        """One item ``(images, labels, event)`` from ``batches``."""
        if self.cuda:
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                images, labels = self.normalize(*self.copy(batches, stacked))
                images.record_stream(self.consumer)
                labels.record_stream(self.consumer)
                event = torch.cuda.Event()
                event.record(self.stream)
        else:
            images, labels = self.normalize(*self.copy(batches, stacked))
            event = None
        if self.recycle is not None:
            for batch in batches:
                self.recycle(batch, event)
        return images, labels, event

    def copy(self, batches: list, stacked: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """The host batches' uint8 images and labels as they are, on the
        device (on the current stream: the caller picks it)."""
        host = [(torch.as_tensor(x), torch.as_tensor(y)) for x, y in batches]
        lead = (len(host),) if stacked else ()
        images = torch.empty(lead + tuple(host[0][0].shape), dtype=torch.uint8,
                             device=self.device)
        labels = torch.empty(lead + tuple(host[0][1].shape), dtype=host[0][1].dtype,
                             device=self.device)
        if stacked:
            for k, (x, y) in enumerate(host):
                images[k].copy_(x, non_blocking=True)
                labels[k].copy_(y, non_blocking=True)
        else:
            (x, y), = host
            images.copy_(x, non_blocking=True)
            labels.copy_(y, non_blocking=True)
        return images, labels

    @staticmethod
    def normalize(images: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """uint8 images -> float32 with the ImageNet mean and std; labels
        -> int64."""
        return normalize_uint8(images, IMAGENET_MEAN, IMAGENET_STD), labels.long()


def make_batch_transfer(transfer: DeviceTransfer) -> TransferFn:
    """Per-batch transfer: each decoded host batch becomes one device batch."""

    def per_batch(batches: list) -> list:
        return [transfer([b], stacked=False) for b in batches]

    return per_batch


def make_chunk_transfer(chunk_steps: int, transfer: DeviceTransfer) -> TransferFn:
    """Chunked transfer: ``chunk_steps`` host batches become ONE [K, B, ...]
    device batch (one output tensor, one normalisation, one event; K
    copies into its slices) for the chunked train path. A short tail group
    (epoch length not divisible by K) degrades to per-batch items, so the
    consumer sees at most two shapes."""
    per_batch = make_batch_transfer(transfer)

    def chunked(batches: list) -> list:
        if len(batches) == chunk_steps and chunk_steps > 1:
            return [transfer(batches, stacked=True)]
        return per_batch(batches)

    return chunked


def stream_batches(
    tasks: Iterable[DecodeTask],
    *,
    depth: int,
    workers: int,
    chunk: int = 1,
    name: str = "pipeline",
    stats_sink: Optional[Callable[[dict], None]] = None,
    device: str | torch.device = "cuda",
    recycle: Optional[Recycle] = None,
):
    """Generator driving a PrefetchEngine for one epoch: yields device
    batches ``(images, labels)`` (stacked [K, B, ...] chunks when
    ``chunk > 1``), each after the consumer's stream was made to wait for
    its transfer's event; guarantees the engine is closed when the consumer
    stops early (generator ``close()`` lands in the ``finally``), and hands
    the final stage-time stats to ``stats_sink``."""
    transfer = DeviceTransfer(device, recycle)
    fn = (make_chunk_transfer(chunk, transfer) if chunk > 1
          else make_batch_transfer(transfer))
    engine = PrefetchEngine(
        tasks, fn, depth=depth, workers=workers, group=chunk, name=name
    )
    try:
        for images, labels, event in engine:
            if event is not None:
                transfer.consumer.wait_event(event)
            yield images, labels
    finally:
        engine.close()
        if stats_sink is not None:
            stats_sink(engine.stats())

