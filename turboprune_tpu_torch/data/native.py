"""Native packed-dataset loader (port of ``turboprune_tpu/data/native.py``):
a ctypes binding of the port's reader, ``csrc/tpkdata.cpp``.

A ``.tpk`` file holds either fixed-size raw uint8 samples (mode 0,
CIFAR-style) or JPEG blobs with an offset table (mode 1, ImageNet-style),
behind a 32-byte header ``<IIQIIII`` (magic "TPKD", version 1, n, mode, h,
w, c) and an int32 label per sample. The C++ reader memory-maps it and, on
a thread pool, copies raw samples or decodes JPEGs, crops them
(torchvision's RandomResizedCrop and flip for training, a ratio center crop
for evaluation) and resizes them bilinearly, with no Python per sample.
Its train crops are a pure function of (seed, index), and the loader's
epoch order of (seed, epoch), so the port reads the same batches as the
JAX package, bit for bit, and its epoch counter is its whole stream state.

The reader is compiled at first use (``build_reader``) with g++ into
``build/`` at the root of the checkout, keyed by a hash of the source and
the flags; ``native/`` is the JAX package's and is never written. The JPEG
decoder is built in when the compiler finds ``<jpeglib.h>`` (and links
libjpeg); a build without it reads raw files and refuses a JPEG file at
open, naming the missing header.

Python owns: writing files (``write_tpk_raw``, ``write_tpk_jpegs``,
``pack_imagefolder``), the epoch shuffle, the host's shard, and handing
batches to the device through the prefetch engine (``pipeline.py``). Each
process reads the strided shard of its (data rank, data size):
``make_shard(n, pid, nproc)``, which ``TpkImageLoader`` takes from
``shard=`` (the mesh's data axis) or, without it, from the process's index
and count; a world of one process reads the whole file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
from functools import partial
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..parallel.multihost import is_primary, process_count, process_index, sync_hosts
from .padding import pad_eval_batch_host
from .pipeline import HostBuffers, stream_batches

_MAGIC = 0x444B5054  # "TPKD"
_HEADER = struct.Struct("<IIQIIII")  # magic, version, n, mode, h, w, c
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tpkdata.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")
JPEG_FLAGS = ("-DTPK_WITH_JPEG=1",)
JPEG_LIBS = ("-ljpeg",)
_EXTS = {".jpeg", ".jpg", ".png"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock


class ReaderBuildError(RuntimeError):
    """g++ is missing or refused the reader's source."""


# ----------------------------------------------------------------- build
def jpeg_header_found(cxx: str = "g++") -> bool:
    """Whether ``cxx`` finds ``<jpeglib.h>`` on its include path."""
    try:
        proc = subprocess.run(
            [cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
            input="#include <jpeglib.h>\n", capture_output=True, text=True,
        )
    except FileNotFoundError as e:
        raise ReaderBuildError(f"{cxx} not found: the .tpk reader is compiled at first use") from e
    return proc.returncode == 0


def reader_flags(with_jpeg: bool) -> tuple[tuple, tuple]:
    """(compile flags, libraries) of the reader's build."""
    if with_jpeg:
        return CXX_FLAGS + JPEG_FLAGS, JPEG_LIBS
    return CXX_FLAGS, ()


def reader_path(with_jpeg: bool) -> Path:
    """Where the build lives: keyed by the source and the flags."""
    flags, libs = reader_flags(with_jpeg)
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags + libs).encode())
    return BUILD_DIR / f"libtpkdata-{h.hexdigest()[:16]}.so"


def build_reader(cxx: str = "g++") -> Path:
    """Compile ``csrc/tpkdata.cpp`` unless its keyed build exists: with the
    JPEG decoder when ``cxx`` finds ``<jpeglib.h>``, else without. Written
    to a temp file and renamed, so a concurrent loader never sees half a
    library; a failed compile raises ``ReaderBuildError`` with g++'s
    stderr."""
    with_jpeg = jpeg_header_found(cxx)
    out = reader_path(with_jpeg)
    if out.exists():
        return out
    flags, libs = reader_flags(with_jpeg)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *flags, "-o", tmp, str(SOURCE), *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise ReaderBuildError(
                f"{cxx} failed ({proc.returncode}) on {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_reader()))
            lib.tpk_open.restype = ctypes.c_void_p
            lib.tpk_open.argtypes = [ctypes.c_char_p]
            lib.tpk_close.argtypes = [ctypes.c_void_p]
            lib.tpk_num_samples.restype = ctypes.c_int64
            lib.tpk_num_samples.argtypes = [ctypes.c_void_p]
            for f in (lib.tpk_mode, lib.tpk_height, lib.tpk_width, lib.tpk_channels):
                f.restype = ctypes.c_int32
                f.argtypes = [ctypes.c_void_p]
            lib.tpk_has_jpeg.restype = ctypes.c_int
            lib.tpk_has_jpeg.argtypes = []
            # Buffers are passed as addresses (numpy's ctypes.data or a
            # tensor's data_ptr()), so every pointer is a c_void_p.
            lib.tpk_read_raw_batch.restype = ctypes.c_int
            lib.tpk_read_raw_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.tpk_decode_batch.restype = ctypes.c_int
            lib.tpk_decode_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_uint64, ctypes.c_double,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ]
            _lib = lib
        return _lib


def reader_has_jpeg() -> bool:
    """Whether the reader built here decodes JPEG (mode 1) files."""
    return bool(_load_lib().tpk_has_jpeg())


# --------------------------------------------------------------- writers
def write_tpk_raw(path: str | Path, images: np.ndarray, labels: np.ndarray) -> Path:
    """Fixed-size uint8 NHWC samples (mode 0)."""
    images = np.ascontiguousarray(images, np.uint8)
    labels = np.ascontiguousarray(labels, np.int32)
    n, h, w, c = images.shape
    path = Path(path)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, 1, n, 0, h, w, c))
        f.write(labels.tobytes())
        f.write(images.tobytes())
    return path


def write_tpk_jpegs(path: str | Path, blobs: Sequence[bytes], labels: np.ndarray) -> Path:
    """Variable-size JPEG blobs with an offset table (mode 1)."""
    labels = np.ascontiguousarray(labels, np.int32)
    n = len(blobs)
    if labels.shape != (n,):
        raise ValueError(f"{n} blobs but labels of shape {labels.shape}")
    offsets = np.zeros(n + 1, np.uint64)
    offsets[1:] = np.cumsum([len(b) for b in blobs])
    path = Path(path)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, 1, n, 1, 0, 0, 0))
        f.write(labels.tobytes())
        f.write(offsets.tobytes())
        for b in blobs:
            f.write(b)
    return path


def index_image_folder(split_dir: Path) -> tuple[list[str], list[int], list[str]]:
    """(paths, labels, class_names) of an ImageFolder split; classes sorted
    by name, files sorted within a class (the torchvision and FFCV writer
    convention; a copy of the JAX package's ``_index_image_folder``)."""
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


def pack_imagefolder(split_dir: str | Path, out_path: str | Path) -> Path:
    """Pack an ImageFolder split's image files into a JPEG .tpk (the
    counterpart of FFCV's .beton-writing step)."""
    paths, labels, _classes = index_image_folder(Path(split_dir))
    blobs = [Path(p).read_bytes() for p in paths]
    return write_tpk_jpegs(out_path, blobs, np.asarray(labels, np.int32))


# ---------------------------------------------------------------- reader
class TpkFile:
    """An open .tpk file. ``read_raw`` (mode 0) and ``decode`` (mode 1)
    return numpy arrays, or, given ``out=(images, labels)`` (CPU uint8 and
    int32 tensors of the batch's shape, pinned or not), write straight into
    them through their ``data_ptr()`` and return them."""

    def __init__(self, path: str | Path):
        self._lib = _load_lib()
        self._handle = self._lib.tpk_open(str(path).encode())
        if not self._handle:
            raise OSError(f"cannot open tpk file: {path}")
        self.path = Path(path)
        self.num_samples = int(self._lib.tpk_num_samples(self._handle))
        self.mode = int(self._lib.tpk_mode(self._handle))
        self.height = int(self._lib.tpk_height(self._handle))
        self.width = int(self._lib.tpk_width(self._handle))
        self.channels = int(self._lib.tpk_channels(self._handle))
        if self.mode == 1 and not self._lib.tpk_has_jpeg():
            self.close()
            raise RuntimeError(
                f"{path} holds JPEG samples (mode 1), but the .tpk reader was built "
                "without its JPEG decoder: the compiler found no <jpeglib.h> (the "
                "libjpeg development header). Install it and delete build/libtpkdata-*.so, "
                "or pack the data as raw samples (write_tpk_raw)"
            )

    def close(self) -> None:
        if self._handle:
            self._lib.tpk_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except (AttributeError, TypeError, OSError):
            # Interpreter shutdown: the ctypes lib / globals may already be
            # torn down. Anything else should not be silenced.
            pass

    def sample_shape(self, out_size: int = 0) -> tuple[int, int, int]:
        """(H, W, C) of one sample as read (mode 0) or decoded at
        ``out_size`` (mode 1)."""
        if self.mode == 0:
            return self.height, self.width, self.channels
        return out_size, out_size, 3

    def _outputs(self, n: int, shape: tuple, out):
        if out is None:
            images = np.empty((n, *shape), np.uint8)
            labels = np.empty(n, np.int32)
            return (images, labels), images.ctypes.data, labels.ctypes.data
        images, labels = out
        for t, dtype, want in ((images, torch.uint8, (n, *shape)), (labels, torch.int32, (n,))):
            if (t.device.type != "cpu" or t.dtype != dtype or tuple(t.shape) != want
                    or not t.is_contiguous()):
                raise ValueError(
                    f"out tensor must be a contiguous CPU {dtype} of shape {want}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        return (images, labels), images.data_ptr(), labels.data_ptr()

    def read_raw(self, indices: np.ndarray, nthreads: int = 0, out=None):
        """Raw samples at ``indices``. ``nthreads=0`` = auto
        (min(16, cpu_count)); the loaders pass ``dataset_params.tpk_nthreads``."""
        nthreads = _resolve_nthreads(nthreads)
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        result, images, labels = self._outputs(n, self.sample_shape(), out)
        rc = self._lib.tpk_read_raw_batch(
            self._handle, indices.ctypes.data, n, images, labels, nthreads)
        if rc:
            raise RuntimeError(f"tpk_read_raw_batch failed (rc={rc}) on {self.path}")
        return result

    def decode(
        self,
        indices: np.ndarray,
        out_size: int,
        train: bool,
        seed: int = 0,
        center_crop_ratio: float = 224 / 256,
        nthreads: int = 0,
        out=None,
    ):
        """JPEG samples at ``indices``, decoded, cropped and resized to
        ``out_size`` (train: RandomResizedCrop and flip from (seed, index);
        eval: the center crop of ``center_crop_ratio`` of the short side)."""
        nthreads = _resolve_nthreads(nthreads)
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        result, images, labels = self._outputs(n, self.sample_shape(out_size), out)
        rc = self._lib.tpk_decode_batch(
            self._handle, indices.ctypes.data, n, out_size, 1 if train else 0,
            ctypes.c_uint64(seed), center_crop_ratio, images, labels, nthreads)
        if rc:
            raise RuntimeError(f"tpk_decode_batch failed (rc={rc}) on {self.path}")
        return result


def _resolve_nthreads(nthreads: int) -> int:
    return nthreads or min(16, os.cpu_count() or 1)


def make_shard(n: int, pid: int, nproc: int) -> np.ndarray:
    """Strided per-process shard (process p takes samples p, p+nproc, ...):
    every sample belongs to exactly one shard, and shard sizes differ by at
    most one."""
    return np.arange(pid, n, nproc, dtype=np.int64)


class TpkImageLoader:
    """Epoch iterator over a .tpk: native decode, the process's shard,
    normalisation on the device — the FFCV ``Loader`` contract: train =
    shuffled + drop_last, eval = sequential + keep last (padded with label
    -1 to the full batch, on the host in the decode task).

    The epoch's order is ``default_rng(seed + epoch).permutation(shard)``
    and its decode seed ``seed * 1_000_003 + epoch``, as in the JAX package,
    so the ``epoch`` counter (which the mid-level slot restores) is the
    loader's whole state. ``batch_scope = "host"``: in a world of W
    processes rank p reads the strided shard ``make_shard(n, p, W)`` in
    batches of ``total_batch_size / W`` (which must divide); the train
    length is the steps every rank can take, the eval length the largest
    shard's batches, the shorter shards padded, so the ranks' steps line
    up. ``shard`` = (index, count) replaces (p, W): the mesh's (data rank,
    data size), so the ranks of one ring read the same rows. Batches are
    decoded into reusable host buffers
    (pinned for a CUDA device) and reach ``device`` through the prefetch
    engine (``pipeline.stream_batches``); ``last_pipeline_stats`` holds the
    engine's stage times of the latest epoch."""

    batch_scope = "host"

    def __init__(
        self,
        path: str | Path,
        total_batch_size: int,
        train: bool,
        image_size: int = 224,
        seed: int = 0,
        nthreads: int = 0,
        prefetch_depth: int = 4,
        decode_workers: int = 2,
        device: str | torch.device = "cuda",
        shard: Optional[tuple[int, int]] = None,
    ):
        self.file = TpkFile(path)
        index, nproc = shard or (process_index(), process_count())
        if total_batch_size % nproc:
            raise ValueError(
                f"total_batch_size={total_batch_size} not divisible by the "
                f"{nproc} processes of the world")
        self.batch_size = total_batch_size // nproc
        self._nproc = nproc
        self.train = train
        self.image_size = image_size
        self.seed = seed
        self.nthreads = _resolve_nthreads(nthreads)
        self.prefetch_depth = prefetch_depth
        self.decode_workers = decode_workers
        self.device = torch.device(device)
        self.epoch = 0
        self.last_pipeline_stats: Optional[dict] = None
        self._shard = make_shard(self.file.num_samples, index, nproc)
        self.buffers = HostBuffers(
            (self.batch_size, *self.file.sample_shape(image_size)),
            pin=self.device.type == "cuda")

    def __len__(self) -> int:
        """Train: the steps every process can take (drop-last); eval: the
        batches of the largest shard, the last one padded."""
        if self.train:
            return (self.file.num_samples // self._nproc) // self.batch_size
        max_shard = -(-self.file.num_samples // self._nproc)
        return -(-max_shard // self.batch_size)

    def decode_batch(self, order: np.ndarray, b: int, epoch: int):
        """Batch ``b`` of an epoch's ``order`` into a host buffer:
        (uint8 images [B, H, W, C], int32 labels [B]) CPU tensors."""
        idx = order[b * self.batch_size : (b + 1) * self.batch_size]
        n = len(idx)
        images, labels = self.buffers.acquire()
        out = (images[:n], labels[:n])
        if self.file.mode == 1:
            self.file.decode(idx, self.image_size, self.train,
                             seed=self.seed * 1_000_003 + epoch,
                             nthreads=self.nthreads, out=out)
        else:
            self.file.read_raw(idx, nthreads=self.nthreads, out=out)
        if not self.train:
            pad_eval_batch_host(images, labels, n)
        return images, labels

    def epoch_tasks(self, max_batches: Optional[int] = None):
        """(decode tasks, n) for one epoch; advances the epoch counter."""
        epoch = self.epoch
        self.epoch += 1
        order = self._shard
        if self.train:
            order = np.random.default_rng(self.seed + epoch).permutation(order)
        n = len(self)
        if max_batches is not None:
            n = min(n, max_batches)
        return (partial(self.decode_batch, order, b, epoch) for b in range(n)), n

    def _set_stats(self, stats: dict) -> None:
        self.last_pipeline_stats = stats

    def _stream(self, max_batches: Optional[int], chunk: int):
        tasks, n = self.epoch_tasks(max_batches)
        if n == 0:
            return
        yield from stream_batches(
            tasks,
            depth=max(self.prefetch_depth, chunk),
            workers=self.decode_workers,
            chunk=chunk,
            name="tpk",
            stats_sink=self._set_stats,
            device=self.device,
            recycle=self.buffers.release,
        )

    def __iter__(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """Device batches (float32 NHWC images, int64 labels) for one epoch:
        ``decode_workers`` concurrent C++ decode calls (each ``nthreads``
        threads, the GIL released), then the transfer stage, so decode,
        host-to-device copies and device compute overlap."""
        return self._stream(None, 1)

    def iter_chunks(
        self, chunk: int, max_batches: Optional[int] = None
    ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """One epoch as stacked [K, B, ...] device chunks (K = ``chunk``);
        a tail of fewer than K batches comes out as plain [B, ...] batches.
        The same batches, in the same order, as ``__iter__``."""
        return self._stream(max_batches, chunk)


class TpkLoaders:
    """Train/val pair over packed .tpk files (``dataset_params.dataloader_type:
    tpk``): ``tpk_train_path`` / ``tpk_val_path``, or
    ``<data_root_dir>/{train,val}.tpk``. With ``auto_pack``, a missing file is
    packed first from the ImageFolder split ``<data_root_dir>/{train,val}``
    (by the primary, written to a temp file and renamed; every rank waits
    at ``sync_hosts`` for it)."""

    def __init__(
        self,
        data_root_dir: str,
        total_batch_size: int,
        num_classes: int,
        image_size: int = 224,
        seed: int = 0,
        nthreads: int = 0,
        prefetch_depth: int = 4,
        decode_workers: int = 2,
        train_path: str = "",
        val_path: str = "",
        auto_pack: bool = False,
        device: str | torch.device = "cuda",
        shard: Optional[tuple[int, int]] = None,
    ):
        root = Path(data_root_dir)
        train_tpk = Path(train_path) if train_path else root / "train.tpk"
        val_tpk = Path(val_path) if val_path else root / "val.tpk"
        if auto_pack:
            self._maybe_pack(root / "train", train_tpk)
            self._maybe_pack(root / "val", val_tpk)
        for p in (train_tpk, val_tpk):
            if not p.exists():
                raise FileNotFoundError(
                    f"tpk file not found: {p} — set dataset_params.tpk_*_path "
                    "or tpk_auto_pack: true with ImageFolder splits under "
                    "data_root_dir"
                )
        common = dict(total_batch_size=total_batch_size, image_size=image_size, seed=seed,
                      nthreads=nthreads, prefetch_depth=prefetch_depth,
                      decode_workers=decode_workers, device=device, shard=shard)
        self.train_loader = TpkImageLoader(train_tpk, train=True, **common)
        self.test_loader = TpkImageLoader(val_tpk, train=False, **common)
        self.num_classes = num_classes

    @staticmethod
    def _maybe_pack(split_dir: Path, tpk_path: Path) -> None:
        # Every rank reaches the barrier, whatever its own view of the
        # files: a rank that skipped it would hang the others.
        if is_primary() and not tpk_path.exists() and split_dir.is_dir():
            tmp = tpk_path.with_suffix(".tpk.tmp")
            pack_imagefolder(split_dir, tmp)
            os.replace(tmp, tpk_path)
        sync_hosts(f"tpk_pack:{tpk_path.name}")
