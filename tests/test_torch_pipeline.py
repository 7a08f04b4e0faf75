"""The port's streaming pipeline (turboprune_tpu_torch/data/pipeline.py):
the PrefetchEngine contract of the JAX package's tests/test_pipeline.py
(order under parallel workers, the depth bound, worker and transfer errors
re-raised with their traceback, close() on early exit, grouping and the
short tail, the stats keys), the host buffers' reuse rule, the .tpk
loader's chunked epoch against its per-batch one, and a harness epoch on
the chunked path against the per-batch path, bit for bit, on the CPU."""

import threading
import time
import traceback

import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.data.native import TpkImageLoader, write_tpk_raw
from turboprune_tpu_torch.data.pipeline import (
    DeviceTransfer,
    HostBuffers,
    PrefetchEngine,
    make_chunk_transfer,
    stream_batches,
)
from turboprune_tpu_torch.harness import PruningHarness

_IDENTITY = lambda batches: list(batches)  # noqa: E731 — per-batch passthrough


def _tasks(values, delay=0.0, counter=None, lock=None):
    def make(v):
        def task():
            if counter is not None:
                with lock:
                    counter[0] += 1
            if delay:
                time.sleep(delay)
            return v

        return task

    return [make(v) for v in values]


def test_order_is_kept_under_parallel_workers():
    """Later tasks finishing first (4 workers, reverse-staggered sleeps)
    still come out in submission order."""
    n = 24

    def make(i):
        def task():
            time.sleep(0.001 * ((n - i) % 5))
            return i

        return task

    with PrefetchEngine([make(i) for i in range(n)], _IDENTITY, depth=6, workers=4) as engine:
        assert list(engine) == list(range(n))


def test_depth_bounds_the_decoded_batches():
    """A stalled consumer stops the decode at depth (ring) + depth (queue)
    + group (transfer stage), and the epoch still completes after."""
    counter, lock = [0], threading.Lock()
    depth = 2
    with PrefetchEngine(_tasks(range(100), counter=counter, lock=lock), _IDENTITY,
                        depth=depth, workers=2) as engine:
        time.sleep(0.5)  # the consumer does not pull
        assert counter[0] <= 2 * depth + 1, counter[0]
        assert list(engine) == list(range(100))


def test_worker_error_reaches_the_consumer_with_its_traceback():
    def exploding_decode():
        raise ValueError("decode exploded mid-epoch")

    engine = PrefetchEngine(_tasks([0, 1]) + [exploding_decode] + _tasks([3, 4]),
                            _IDENTITY, depth=2, workers=2)
    got = []
    with pytest.raises(ValueError, match="decode exploded") as excinfo:
        for item in engine:
            got.append(item)
    assert got == [0, 1]  # everything before the failure arrives intact
    exc = excinfo.value
    assert "exploding_decode" in "".join(
        traceback.format_exception(type(exc), exc, exc.__traceback__))
    assert not engine._thread.is_alive()


def test_transfer_error_reaches_the_consumer():
    def bad_transfer(batches):
        raise RuntimeError("transfer stage failed")

    engine = PrefetchEngine(_tasks(range(4)), bad_transfer, depth=2)
    with pytest.raises(RuntimeError, match="transfer stage failed"):
        list(engine)
    engine.close()


def test_close_on_early_exit_joins_and_is_idempotent():
    """Abandoning the epoch with the output queue full and decodes in
    flight: close() returns promptly, joins the transfer thread, shuts the
    pool, and a second close() is a no-op."""
    engine = PrefetchEngine(_tasks(range(200), delay=0.002), _IDENTITY, depth=2, workers=2)
    got = [next(engine), next(engine)]
    t0 = time.perf_counter()
    engine.close()
    engine.close()
    assert time.perf_counter() - t0 < 10.0
    assert got == [0, 1]
    assert not engine._thread.is_alive()
    with pytest.raises(RuntimeError):
        engine._pool.submit(lambda: None)


def test_stream_batches_closes_on_break_and_moves_batches():
    """stream_batches closes its engine when the consumer stops early,
    hands the stats to the sink, and yields normalised float32 images and
    int64 labels on the device (the CPU here)."""
    stats_box = []

    def make(i):
        def task():
            time.sleep(0.002)
            return np.full((2, 4, 4, 3), i, np.uint8), np.full((2,), i, np.int32)

        return task

    gen = stream_batches([make(i) for i in range(50)], depth=2, workers=1,
                         stats_sink=stats_box.append, device="cpu")
    images, labels = next(gen)
    gen.close()
    assert len(stats_box) == 1 and stats_box[0]["items_emitted"] >= 1
    assert images.dtype == torch.float32 and labels.dtype == torch.int64
    want = (0 / 255.0 - torch.tensor([0.485, 0.456, 0.406])) / torch.tensor([0.229, 0.224, 0.225])
    torch.testing.assert_close(images[0, 0, 0], want, rtol=0, atol=1e-6)
    assert labels.tolist() == [0, 0]


def test_grouping_short_tail_and_chunk_transfer():
    """group=K hands the transfer K consecutive batches and then the short
    tail; make_chunk_transfer stacks a full group into one [K, B, ...]
    batch and sends a short one per batch."""
    seen = []

    def transfer(batches):
        seen.append(len(batches))
        return [tuple(batches)]

    with PrefetchEngine(_tasks(range(10)), transfer, depth=4, workers=3, group=4) as engine:
        assert list(engine) == [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9)]
    assert seen == [4, 4, 2]

    chunked = make_chunk_transfer(3, DeviceTransfer("cpu"))
    batches = [(np.full((2, 4, 4, 3), i, np.uint8), np.full((2,), i, np.int32))
               for i in range(3)]
    ((images, labels, event),) = chunked(batches)
    assert images.shape == (3, 2, 4, 4, 3) and labels.shape == (3, 2) and event is None
    assert labels[:, 0].tolist() == [0, 1, 2]
    tail = chunked(batches[:2])
    assert [item[0].dim() for item in tail] == [4, 4]


def test_stats_keys_and_accounting():
    with PrefetchEngine(_tasks(range(8), delay=0.002), _IDENTITY, depth=2,
                        workers=2) as engine:
        assert len(list(engine)) == 8
    stats = engine.stats()
    assert stats["batches_decoded"] == 8 and stats["items_emitted"] == 8
    for key in ("decode_wait_s", "transfer_wait_s", "consumer_wait_s", "backpressure_s"):
        assert stats[key] >= 0.0
    assert (stats["depth"], stats["workers"], stats["group"]) == (2, 2, 1)


class _Event:
    """Stands in for a CUDA event whose copy completes when ``done``."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_host_buffer_is_reused_only_after_its_copy_completed():
    pool = HostBuffers((2, 4, 4, 3), pin=False)
    a = pool.acquire()
    assert a[0].shape == (2, 4, 4, 3) and a[1].shape == (2,) and a[1].dtype == torch.int32
    event = _Event()
    pool.release(a, event)
    b = pool.acquire()  # a's copy is in flight: a new buffer
    assert b[0].data_ptr() != a[0].data_ptr() and pool.allocated == 2
    event.done = True
    c = pool.acquire()  # now a comes back
    assert c[0].data_ptr() == a[0].data_ptr() and pool.allocated == 2
    pool.release(b, None)  # copied synchronously (a CPU device)
    assert pool.acquire()[0].data_ptr() == b[0].data_ptr()


@pytest.fixture(scope="module")
def tpk_train(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("pipeline_tpk") / "train.tpk"
    return write_tpk_raw(path, rng.integers(0, 256, size=(48, 8, 8, 3), dtype=np.uint8),
                         rng.integers(0, 4, size=(48,)).astype(np.int32))


def test_iter_chunks_gives_the_batches_of_iter(tpk_train):
    """Epoch 0 per batch against epoch 0 in chunks of 4 (6 batches: one
    chunk and a tail of 2 single batches), and capped at 3 batches (one
    chunk of 2, one single): the same images and labels, bit for bit."""
    def loader():
        return TpkImageLoader(tpk_train, total_batch_size=8, train=True, image_size=8,
                              seed=3, device="cpu")

    flat = list(loader())
    items = list(loader().iter_chunks(4))
    assert [i[0].dim() for i in items] == [5, 4, 4]
    unstacked = [b for x, y in items
                 for b in (zip(x.unbind(0), y.unbind(0)) if x.dim() == 5 else [(x, y)])]
    assert len(flat) == len(unstacked) == 6
    for (fx, fy), (cx, cy) in zip(flat, unstacked):
        assert torch.equal(fx, cx) and torch.equal(fy, cy)
    capped = list(loader().iter_chunks(2, max_batches=3))
    assert [i[0].dim() for i in capped] == [5, 4]
    assert torch.equal(capped[1][0], flat[2][0])


def test_harness_chunked_epoch_sums_equal_the_per_batch_epoch(tpk_train, tmp_path):
    """One epoch of ResNet-18 (cifar10_imp, fp32) over the .tpk through the
    harness, with scan_chunk_steps=4 (a chunk of 4, then 2 single batches)
    and with 1: the same batches reach the step, so the metric sums and the
    trained weights are equal bit for bit; the epoch's row carries the
    pipeline's stage times."""
    rng = np.random.default_rng(1)
    val = write_tpk_raw(tmp_path / "val.tpk",
                        rng.integers(0, 256, size=(12, 8, 8, 3), dtype=np.uint8),
                        rng.integers(0, 4, size=(12,)).astype(np.int32))
    out = {}
    for chunk in (4, 1):
        cfg = compose("cifar10_imp", [
            f"experiment_params.base_dir={tmp_path}",
            "dataset_params.dataloader_type=tpk",
            f"dataset_params.tpk_train_path={tpk_train}",
            f"dataset_params.tpk_val_path={val}",
            "dataset_params.total_batch_size=8",
            "dataset_params.image_size=8",
            "dataset_params.num_classes=4",
            f"dataset_params.scan_chunk_steps={chunk}",
            "experiment_params.training_precision=float32",
        ])
        h = PruningHarness(cfg, ("p", str(tmp_path / f"expt{chunk}")), device="cpu")
        h.setup_level(1)
        seen = []
        step = h._train_step

        def counted(state, batch, step=step, seen=seen):
            seen.append(batch[0].clone())
            return step(state, batch)

        h._train_step = counted
        row = h.train_epoch()
        out[chunk] = (row, seen, {k: v.clone() for k, v in h.state.model.state_dict().items()})
    (row4, seen4, state4), (row1, seen1, state1) = out[4], out[1]
    assert len(seen4) == len(seen1) == 6
    assert all(torch.equal(a, b) for a, b in zip(seen4, seen1))
    for key in ("train_loss", "train_acc"):
        assert row4[key] == row1[key], key
    assert all(torch.equal(state4[k], v) for k, v in state1.items())
    for row in (row4, row1):
        assert {"decode_wait_s", "transfer_wait_s", "consumer_wait_s"} <= set(row)
