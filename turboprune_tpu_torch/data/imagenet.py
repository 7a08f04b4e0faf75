"""ImageNet from an ImageFolder of JPEGs (port of
``turboprune_tpu/data/imagenet.py``), without grain.

The JAX package reads ``<data_root_dir>/{train,val}/<class>/*.JPEG`` with
grain: raw bytes from ``ImageFolderSource``, Pillow decode and crop in
grain's worker processes, batches to the device by the prefetch engine.
The port keeps that source and those crops (the same Pillow code) and
rebuilds grain's stream itself, bit for bit:

- **train** is one persistent, endless, shuffled stream. Stream position
  ``i`` reads record ``shuffled_positions(i)`` (grain's global shuffle,
  ``index_shuffle.py``, a new permutation every pass of ``n`` records) and
  draws its crop and flip from ``np.random.Generator(np.random.Philox(
  key=seed + i))``, grain's per-record RNG. An epoch is a window of
  exactly ``len(self) = n // batch`` whole batches off that stream, so an
  epoch's boundary drifts off the pass's by the remainder of each pass,
  as in the JAX loader's ``_raw_batches``. ``drop_remainder``: no partial
  batch is ever formed.
- **eval** is sequential: an epoch is one pass over the ``n`` records in
  order, its last batch padded to the full batch with label -1
  (``padding.py``).

The stream's position is its whole state: ``get_stream_state`` /
``set_stream_state`` carry it in a few bytes together with the loader's
fingerprint (split dir, n, batch, seed), and a blob of another loader
raises. The mid-level slot stores it (``utils/checkpoint.py``).

Decode runs in ``num_workers`` worker processes of a
``torch.utils.data.DataLoader`` over ``StreamDataset`` (map-style, indexed
by (stream position, record)) with a batch sampler that walks the stream.
The workers are persistent for the run (``persistent_workers``). The
train stream's iterator runs on from one epoch into the next, so the
workers decode the next epoch's first batches while an epoch ends; an
epoch that does not start where the iterator stands (after a cut epoch or
a restored stream state) re-arms it at its first position. They are
forked (``mp_context``): ``spawn``/``forkserver`` start fresh interpreters
that import torch again (in a trained process on an 8-core H100 machine,
2 forkserver workers gave their first batch after 16.9 s, 2 forked ones
after 1.6 s, 16 forked ones after 5.3 s: ``chip_smoke.py``'s
``imagenet_folder`` phase). A forked worker runs only Pillow and numpy and
touches no CUDA state; the loader starts its workers before the epoch's
prefetch threads. Batches come back as
``uint8`` NHWC images and int32 labels, pinned by the DataLoader's pinning
thread when the device is CUDA, and reach the device through the prefetch
engine (``pipeline.stream_batches``, ``workers=1``: the stream is serial
and its order is the order of the stream), which normalises on the device.
A worker that dies or raises surfaces as an exception in the consumer
(DataLoader's own detection, carried across by the engine).
"""

from __future__ import annotations

import hashlib
import io
import struct
from pathlib import Path
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from .index_shuffle import shuffled_positions
from .native import process_count
from .padding import pad_eval_batch
from .pipeline import stream_batches

DEFAULT_CROP_RATIO = 224 / 256  # reference dataset.py:30
IMAGE_SIZE = 224
_EXTS = {".jpeg", ".jpg", ".png"}
_STATE_MAGIC = b"TPIF"
_STATE = struct.Struct(">4sQI16s")  # magic, position, pass seed, fingerprint


def _index_image_folder(split_dir: Path) -> tuple[list[str], list[int], list[str]]:
    """(paths, labels, class_names) for an ImageFolder split; classes sorted
    by name (torchvision/FFCV writer convention)."""
    classes = sorted(d.name for d in split_dir.iterdir() if d.is_dir())
    paths: list[str] = []
    labels: list[int] = []
    for idx, cls in enumerate(classes):
        for p in sorted((split_dir / cls).iterdir()):
            if p.suffix.lower() in _EXTS:
                paths.append(str(p))
                labels.append(idx)
    if not paths:
        raise FileNotFoundError(f"no images under {split_dir}")
    return paths, labels, classes


class ImageFolderSource:
    """Random access over an ImageFolder split: ``source[i]`` is
    (file bytes, label), so decoding happens in the worker processes."""

    def __init__(self, split_dir: str):
        self._split_dir = str(split_dir)
        self.paths, self.labels, self.classes = _index_image_folder(Path(split_dir))

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i) -> tuple[bytes, int]:
        with open(self.paths[i], "rb") as f:
            return f.read(), self.labels[i]

    def __repr__(self) -> str:
        # Stable (no object id): it names the source in stream fingerprints.
        return (
            f"ImageFolderSource({self._split_dir!r}, n={len(self.paths)}, "
            f"classes={len(self.classes)})"
        )


def _decode_rgb(data: bytes):
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    return img.convert("RGB")


def random_resized_crop(
    img, rng: np.random.Generator, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)
):
    """torchvision-style RandomResizedCrop (FFCV's
    RandomResizedCropRGBImageDecoder implements the same sampling)."""
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = int(rng.integers(0, w - cw + 1))
            y = int(rng.integers(0, h - ch + 1))
            return img.resize((size, size), Image.BILINEAR, box=(x, y, x + cw, y + ch))
    # fallback: center crop of the largest valid aspect-clamped region
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x, y = (w - cw) // 2, (h - ch) // 2
    return img.resize((size, size), Image.BILINEAR, box=(x, y, x + cw, y + ch))


def center_crop(img, size: int, crop_ratio: float = DEFAULT_CROP_RATIO):
    """FFCV CenterCropRGBImageDecoder semantics: crop ``crop_ratio *
    min_side`` centered, then resize to ``size``."""
    from PIL import Image

    w, h = img.size
    c = int(round(crop_ratio * min(w, h)))
    x, y = (w - c) // 2, (h - c) // 2
    return img.resize((size, size), Image.BILINEAR, box=(x, y, x + c, y + c))


def train_transform(data: bytes, rng: np.random.Generator, image_size: int) -> np.ndarray:
    """The train record's pixels: RandomResizedCrop, then a flip with
    probability 1/2, both from the record's ``rng``."""
    img = random_resized_crop(_decode_rgb(data), rng, image_size)
    if rng.uniform() < 0.5:
        img = img.transpose(0)  # PIL FLIP_LEFT_RIGHT == 0
    return np.asarray(img, np.uint8)


def eval_transform(data: bytes, image_size: int) -> np.ndarray:
    return np.asarray(center_crop(_decode_rgb(data), image_size), np.uint8)


class StreamDataset(torch.utils.data.Dataset):
    """Map-style dataset over the stream: ``ds[(position, key)]`` is record
    ``key`` decoded and cropped as the stream's ``position`` draws it
    (train: the crop and flip from ``Philox(key=seed + position)``; eval:
    the center crop), as (uint8 HWC array, label)."""

    def __init__(self, source: ImageFolderSource, train: bool, seed: int, image_size: int):
        self.source = source
        self.train = train
        self.seed = seed
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, item: tuple[int, int]) -> tuple[np.ndarray, int]:
        position, key = item
        data, label = self.source[key]
        if self.train:
            rng = np.random.Generator(np.random.Philox(key=self.seed + position))
            return train_transform(data, rng, self.image_size), label
        return eval_transform(data, self.image_size), label


class _Batches(torch.utils.data.Sampler):
    """The DataLoader's batch sampler: each pass iterates what the loader
    last set in ``batches`` (lists of (stream position, record) pairs;
    for the train stream an endless iterator)."""

    def __init__(self):
        self.batches: Iterable[list[tuple[int, int]]] = ()

    def __iter__(self):
        return iter(self.batches)


def _train_stream(n: int, b: int, per_epoch: int, seed: int,
                  start: int) -> Iterator[list[tuple[int, int]]]:
    """The train stream's batches of ``b`` from position ``start`` on,
    endless, as (position, record) pairs over ``n`` records; an epoch's
    worth (``per_epoch`` batches) shuffled at a time. A plain function: the
    DataLoader's iterator holds this generator, and a generator of the
    loader's would make a reference cycle, whose collection stops the
    workers only by timeouts."""
    span = max(per_epoch, 1) * b
    while True:
        positions = start + np.arange(span, dtype=np.int64)
        pairs = list(zip(positions.tolist(), (shuffled_positions(positions, n, seed) % n).tolist()))
        yield from (pairs[i:i + b] for i in range(0, span, b))
        start += span


def _collate(samples: list) -> tuple[torch.Tensor, torch.Tensor]:
    images = torch.from_numpy(np.stack([img for img, _ in samples]))
    labels = torch.tensor([label for _, label in samples], dtype=torch.int32)
    return images, labels


class ImageFolderLoader:
    """One split of an ImageFolder as the JAX package's ``GrainImageLoader``
    reads it (see the module docstring), one process only.

    ``batch_scope = "host"``: a batch is this process's. ``resumable_epochs
    = False``: the epoch counter does not fix the data order; the stream
    position does (``get_stream_state``). ``__iter__`` and
    ``iter_chunks(chunk, max_batches)`` are ``TpkImageLoader``'s contract,
    so the harness's chunked path takes this loader too."""

    batch_scope = "host"
    resumable_epochs = False

    def __init__(
        self,
        split_dir: str,
        total_batch_size: int,
        train: bool,
        num_workers: int = 16,
        seed: int = 0,
        prefetch_depth: int = 4,
        image_size: int = IMAGE_SIZE,
        device: str | torch.device = "cuda",
        mp_context: str = "fork",
    ):
        process_count("the ImageFolder loader")
        if not 0 <= seed < 2**32:
            raise ValueError(f"seed must be a 32-bit unsigned integer, got {seed}")
        self.source = ImageFolderSource(split_dir)
        self.batch_size = total_batch_size
        self.train = train
        self.num_workers = num_workers
        self.seed = seed
        self.prefetch_depth = prefetch_depth
        self.image_size = image_size
        self.device = torch.device(device)
        self.epoch = 0
        self.position = 0  # the train stream's next position
        self.last_pipeline_stats: Optional[dict] = None
        self.dataset = StreamDataset(self.source, train, seed, image_size)
        self._sampler = _Batches()
        # The train stream's DataLoader iterator runs on across epochs (its
        # workers decode the next epoch's first batches while this one
        # ends); ``_it_position`` is the position of the next batch it
        # yields. An epoch that starts elsewhere (a cut epoch, a restored
        # stream state) re-arms it at the epoch's first position.
        self._it: Optional[Iterator] = None
        self._it_position = -1
        self._loader = torch.utils.data.DataLoader(
            self.dataset,
            batch_sampler=self._sampler,
            num_workers=num_workers,
            collate_fn=_collate,
            pin_memory=self.device.type == "cuda",
            persistent_workers=num_workers > 0,
            multiprocessing_context=mp_context if num_workers > 0 else None,
        )
        n = len(self.source)
        self._fingerprint = hashlib.sha256(
            f"{self.source!r}|{n}|{total_batch_size}|{seed}".encode()).digest()[:16]

    def __len__(self) -> int:
        """Train: whole batches per epoch (drop remainder); eval: batches
        of one pass, the last one padded."""
        n = len(self.source)
        return n // self.batch_size if self.train else -(-n // self.batch_size)

    @property
    def num_classes(self) -> int:
        return len(self.source.classes)

    # -------------------------------------------------------- stream state
    def get_stream_state(self) -> bytes:
        """The train stream's position, its pass's shuffle seed and this
        loader's fingerprint, packed."""
        pass_seed = (self.seed + self.position // len(self.source)) % 2**32
        return _STATE.pack(_STATE_MAGIC, self.position, pass_seed, self._fingerprint)

    def set_stream_state(self, blob: bytes) -> None:
        """Continue at the position in ``blob``; a blob of another loader
        (split, size, batch or seed) raises ``ValueError``."""
        if len(blob) != _STATE.size:
            raise ValueError(f"stream state of {len(blob)} bytes, expected {_STATE.size}")
        magic, position, pass_seed, fingerprint = _STATE.unpack(blob)
        if magic != _STATE_MAGIC or fingerprint != self._fingerprint:
            raise ValueError(
                "stream state belongs to another loader (split dir, size, batch "
                "or seed differ)")
        if pass_seed != (self.seed + position // len(self.source)) % 2**32:
            raise ValueError("stream state is inconsistent (pass seed)")
        self.position = position

    # ---------------------------------------------------------------- epoch
    def _next_batch(self):
        images, labels = pad_eval_batch(*next(self._it), self.batch_size)
        self._it_position += self.batch_size
        if self.device.type == "cuda" and not images.is_pinned():
            images, labels = images.pin_memory(), labels.pin_memory()
        return images, labels

    def raw_batches(self, max_batches: Optional[int] = None):
        """(tasks, n) for one epoch: ``n`` zero-argument tasks, each
        returning the next host batch (uint8 NHWC images, int32 labels;
        eval's last batch padded), in stream order. Advances the epoch
        counter and the train stream's position past the epoch."""
        self.epoch += 1
        count = len(self) if max_batches is None else min(len(self), max_batches)
        if self.train:
            start = self.position
            self.position += count * self.batch_size
            if self._it is None or self._it_position != start:
                self._sampler.batches = _train_stream(len(self.source), self.batch_size,
                                                      len(self), self.seed, start)
                self._it, self._it_position = iter(self._loader), start
        else:
            n, b = len(self.source), self.batch_size
            pairs = [(i, i) for i in range(min(count * b, n))]
            self._sampler.batches = [pairs[i:i + b] for i in range(0, len(pairs), b)]
            self._it = iter(self._loader)
        return (self._next_batch for _ in range(count)), count

    def close(self) -> None:
        """Stop the worker processes now (they stop with the loader
        anyway); a later epoch starts new ones."""
        shutdown = getattr(self._it, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()
        self._it, self._it_position = None, -1
        self._loader._iterator = None

    def _set_stats(self, stats: dict) -> None:
        self.last_pipeline_stats = stats

    def _stream(self, max_batches: Optional[int], chunk: int):
        tasks, n = self.raw_batches(max_batches)
        if n == 0:
            return
        yield from stream_batches(
            tasks,
            depth=max(self.prefetch_depth, chunk),
            workers=1,  # the stream is serial: its order is the stream's
            chunk=chunk,
            name="imagefolder",
            stats_sink=self._set_stats,
            device=self.device,
        )

    def __iter__(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """Device batches (float32 NHWC images normalised on the device,
        int64 labels) for one epoch."""
        return self._stream(None, 1)

    def iter_chunks(
        self, chunk: int, max_batches: Optional[int] = None
    ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """One epoch as stacked [K, B, ...] device chunks; a tail of fewer
        than K batches comes out as plain [B, ...] batches. The same
        batches, in the same order, as ``__iter__``."""
        return self._stream(max_batches, chunk)


GrainImageLoader = ImageFolderLoader  # the JAX package's name for it


class ImageNetLoaders:
    """Train/val pair over ``<data_root_dir>/{train,val}`` (the reference's
    FFCVImagenet, dataset.py:347-430)."""

    def __init__(
        self,
        data_root_dir: str,
        total_batch_size: int,
        num_workers: int = 16,
        seed: int = 0,
        image_size: int = IMAGE_SIZE,
        prefetch_depth: int = 4,
        device: str | torch.device = "cuda",
    ):
        root = Path(data_root_dir)
        common = dict(num_workers=num_workers, seed=seed, image_size=image_size,
                      prefetch_depth=prefetch_depth, device=device)
        self.train_loader = ImageFolderLoader(str(root / "train"), total_batch_size,
                                              train=True, **common)
        self.test_loader = ImageFolderLoader(str(root / "val"), total_batch_size,
                                             train=False, **common)
        if self.train_loader.source.classes != self.test_loader.source.classes:
            raise ValueError(
                "train/ and val/ class directories differ — label indices "
                "would silently misalign between training and evaluation"
            )
        self.num_classes = self.train_loader.num_classes

    def close(self) -> None:
        self.train_loader.close()
        self.test_loader.close()
