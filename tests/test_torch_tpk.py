"""The port's .tpk reader and loader (turboprune_tpu_torch/data/native.py,
csrc/tpkdata.cpp) against the JAX package's (turboprune_tpu/data/native.py,
native/tpkdata.cpp). Both readers run the same C++ on the same files, so
everything uint8 must match bit for bit: the files the writers produce,
raw reads, JPEG decodes (train crops and flips from (seed, index), eval
center crops, and the DCT-scaled decode of large sources), the shards and
two epochs of each loader. Normalised batches: within 1e-6 (both compute
(x / 255 - mean) / std in fp32; XLA and torch may round the division
differently, measured 2.4e-7)."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_fixtures import jpeg_blobs, one_torch_thread, write_image_folder  # noqa: F401
from turboprune_tpu.data import native as jnative
from turboprune_tpu_torch.data import native

REPO = Path(__file__).resolve().parents[1]
NORM_TOL = 1e-6


@pytest.fixture(scope="module")
def raw_data():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(20, 8, 8, 3), dtype=np.uint8)
    labels = rng.integers(0, 5, size=(20,)).astype(np.int32)
    return images, labels


@pytest.fixture(scope="module")
def jpeg_tpk(tmp_path_factory):
    """Ten small JPEGs (64 x 48) and two at ImageNet-like sizes (500 x 375,
    375 x 500), which the reader decodes at a reduced DCT scale."""
    blobs = jpeg_blobs(10, seed=1) + jpeg_blobs(2, ((500, 375), (375, 500)), seed=2)
    labels = np.random.default_rng(3).integers(0, 3, size=(12,)).astype(np.int32)
    path = native.write_tpk_jpegs(tmp_path_factory.mktemp("tpk") / "jpeg.tpk", blobs, labels)
    return path, blobs, labels


@pytest.mark.parametrize("mode", ["raw", "jpeg"])
def test_writers_give_the_jax_package_bytes(tmp_path, raw_data, jpeg_tpk, mode):
    if mode == "raw":
        ours = native.write_tpk_raw(tmp_path / "p.tpk", *raw_data)
        theirs = jnative.write_tpk_raw(tmp_path / "j.tpk", *raw_data)
    else:
        _, blobs, labels = jpeg_tpk
        ours = native.write_tpk_jpegs(tmp_path / "p.tpk", blobs, labels)
        theirs = jnative.write_tpk_jpegs(tmp_path / "j.tpk", blobs, labels)
    assert ours.read_bytes() == theirs.read_bytes()


def test_read_raw_matches_jax_and_fills_given_tensors(tmp_path, raw_data):
    path = native.write_tpk_raw(tmp_path / "raw.tpk", *raw_data)
    f, jf = native.TpkFile(path), jnative.TpkFile(path)
    assert (f.num_samples, f.mode, f.height, f.width, f.channels) == (20, 0, 8, 8, 3)
    idx = np.array([5, 0, 19, 7, 7], np.int64)
    want_x, want_y = jf.read_raw(idx, nthreads=3)
    got_x, got_y = f.read_raw(idx, nthreads=3)
    out = (torch.zeros(5, 8, 8, 3, dtype=torch.uint8), torch.zeros(5, dtype=torch.int32))
    got = f.read_raw(idx, nthreads=2, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    for x, y in ((got_x, got_y), (out[0].numpy(), out[1].numpy())):
        np.testing.assert_array_equal(x, want_x)
        np.testing.assert_array_equal(y, want_y)
    np.testing.assert_array_equal(got_x, raw_data[0][idx])
    with pytest.raises(ValueError, match="contiguous CPU"):
        f.read_raw(idx, out=(out[0][:, :, :4], out[1]))
    with pytest.raises(RuntimeError, match="rc=1"):
        f.read_raw(np.array([25], np.int64))
    f.close()
    jf.close()


@pytest.mark.parametrize("policy", ["train", "eval", "large"])
def test_decode_matches_jax_bit_for_bit(jpeg_tpk, policy):
    """Train: RandomResizedCrop + flip seeded by (seed, index), whatever the
    thread count; eval: the 224/256 center crop; large: the two
    ImageNet-sized sources, whose crops are >= 2x the output and so decode
    at 1/2, 1/4 or 1/8 scale."""
    path, _, labels = jpeg_tpk
    f, jf = native.TpkFile(path), jnative.TpkFile(path)
    idx = np.array([10, 11, 10], np.int64) if policy == "large" else np.arange(10)
    train = policy != "eval"
    for seed, nthreads in ((7, 4), (7, 1), (8, 3)):
        want_x, want_y = jf.decode(idx, 32, train=train, seed=seed, nthreads=nthreads)
        got_x, got_y = f.decode(idx, 32, train=train, seed=seed, nthreads=nthreads)
        np.testing.assert_array_equal(got_x, want_x)
        np.testing.assert_array_equal(got_y, labels[idx])
        out = (torch.empty(len(idx), 32, 32, 3, dtype=torch.uint8),
               torch.empty(len(idx), dtype=torch.int32))
        f.decode(idx, 32, train=train, seed=seed, nthreads=nthreads, out=out)
        np.testing.assert_array_equal(out[0].numpy(), want_x)
    if train:  # another seed, other crops
        assert not np.array_equal(f.decode(idx, 32, True, seed=7)[0],
                                  f.decode(idx, 32, True, seed=8)[0])
    f.close()
    jf.close()


def test_make_shard_matches_jax():
    for n, nproc in [(11, 2), (11, 3), (20, 4), (7, 8), (5, 1)]:
        shards = [native.make_shard(n, p, nproc) for p in range(nproc)]
        for p, s in enumerate(shards):
            np.testing.assert_array_equal(s, jnative.make_shard(n, p, nproc))
        assert sorted(int(i) for s in shards for i in s) == list(range(n))


def _host_epoch(tasks):
    return [tuple(np.asarray(a) for a in task()) for task in tasks]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_loader_epochs_match_jax(jpeg_tpk, train):
    """Two epochs of each loader at batch 4 over 12 samples (train: 3
    shuffled batches; eval: 3 in order, none short): the decoded uint8
    batches and labels of the decode tasks bit for bit; the normalised
    device batches within 1e-6. Then eval at batch 5, whose last batch is
    padded with zero images and label -1 on the host."""
    path, _, _ = jpeg_tpk
    for batch in (4, 5) if not train else (4,):
        kw = dict(total_batch_size=batch, train=train, image_size=24, seed=5, nthreads=2)
        ours = native.TpkImageLoader(path, device="cpu", **kw)
        theirs = jnative.TpkImageLoader(path, **kw)
        assert len(ours) == len(theirs)
        for epoch in range(2):
            tasks, n = ours.epoch_tasks()
            jtasks, jn = theirs._epoch_tasks()
            assert n == jn == len(ours)
            for (x, y), (jx, jy) in zip(_host_epoch(tasks), _host_epoch(jtasks), strict=True):
                np.testing.assert_array_equal(x, jx)
                np.testing.assert_array_equal(y, jy)
            if not train and batch == 5:
                assert (y[2:] == -1).all() and not x[2:].any()
        ours.epoch = theirs.epoch = 0
        for epoch in range(2):
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == len(ours)
            for (x, y), (jx, jy) in zip(got, want):
                assert x.dtype == torch.float32 and y.dtype == torch.int64
                np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=NORM_TOL)
                np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        assert ours.epoch == theirs.epoch == 2
        assert ours.last_pipeline_stats["batches_decoded"] == len(ours)


def test_pack_imagefolder_matches_jax(tmp_path):
    split = write_image_folder(tmp_path / "train", classes=("b", "a", "c"), per_class=2)
    (split / "a" / "notes.txt").write_text("not an image")
    ours = native.pack_imagefolder(split, tmp_path / "p.tpk")
    theirs = jnative.pack_imagefolder(split, tmp_path / "j.tpk")
    assert ours.read_bytes() == theirs.read_bytes()
    assert native.index_image_folder(split)[2] == ["a", "b", "c"]
    f = native.TpkFile(ours)
    assert (f.num_samples, f.mode) == (6, 1)
    with pytest.raises(FileNotFoundError):
        native.index_image_folder(split / "a")


def _native_dir_state() -> dict:
    # libtpkdata.so is the JAX package's own build output (its make),
    # which other test files may write at any time: left out.
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in (REPO / "native").iterdir() if p.name != "libtpkdata.so"}


def test_reader_builds_into_build_dir_keyed_by_its_hash():
    before = _native_dir_state()
    with_jpeg = native.jpeg_header_found()
    path = native.build_reader()
    assert path == native.reader_path(with_jpeg)
    assert path.parent == REPO / "build" and path.exists()
    assert path.name.startswith("libtpkdata-") and len(path.stem) == len("libtpkdata-") + 16
    assert native.reader_path(True) != native.reader_path(False)  # the flags are in the key
    assert native.reader_has_jpeg() == with_jpeg
    assert _native_dir_state() == before


def test_build_without_jpeg_header_reads_raw_and_refuses_jpeg(
        tmp_path, monkeypatch, raw_data, jpeg_tpk):
    """The build a machine without <jpeglib.h> gets: raw files read as
    before; a JPEG file is refused at open, naming the missing header."""
    before = _native_dir_state()
    build_dir = tmp_path / "build"
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native, "jpeg_header_found", lambda cxx="g++": False)
    monkeypatch.setattr(native, "_lib", None)
    path = native.build_reader()
    assert [p.name for p in build_dir.iterdir()] == [path.name]  # no temp left
    assert not native.reader_has_jpeg()
    raw = native.write_tpk_raw(tmp_path / "raw.tpk", *raw_data)
    got, _ = native.TpkFile(raw).read_raw(np.arange(20))
    np.testing.assert_array_equal(got, raw_data[0])
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        native.TpkFile(jpeg_tpk[0])
    assert _native_dir_state() == before
    assert os.path.basename(path).startswith("libtpkdata-")
