"""The ImageFolder loader of the port (``turboprune_tpu_torch/data/
imagenet.py``) against the JAX package's grain loader: grain's compiled
index shuffle, the Pillow crops, and whole train and eval batches (uint8
and labels) bit for bit, with the JAX side run as ``tests/test_data.py``
runs it (``num_workers=0``). The split is tiny (13 training images at
batch 4, so every pass leaves a remainder; 7 for evaluation), the images
32 x 32."""

import numpy as np
import pytest
import torch

from torch_port_fixtures import jpeg_blobs, one_torch_thread, write_image_folder  # noqa: F401
from turboprune_tpu_torch.data import create_loaders
from turboprune_tpu_torch.data import imagenet as timg
from turboprune_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD, normalize_uint8
from turboprune_tpu_torch.data.index_shuffle import index_shuffle, shuffled_positions

SIZE = 32
BATCH = 4
# ImageNet-like sizes and one thin image whose crops often fall back.
SIZES = ((64, 48), (48, 64), (120, 20))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagefolder")
    write_image_folder(root / "train", ("n01", "n02", "n03"), 5, SIZES, seed=0)
    (root / "train" / "n03" / "4.jpeg").unlink()  # 13 training images
    write_image_folder(root / "val", ("n01", "n02", "n03"), 3, SIZES, seed=1)
    (root / "val" / "n01" / "2.jpeg").unlink()  # 7 for evaluation
    (root / "val" / "n02" / "2.jpeg").unlink()
    return root


def port_loader(split, train, folder, workers=0, seed=3):
    return timg.ImageFolderLoader(str(folder / split), BATCH, train=train, num_workers=workers,
                                  seed=seed, image_size=SIZE, device="cpu")


def jax_loader(split, train, folder, seed=3):
    from turboprune_tpu.data.imagenet import GrainImageLoader

    return GrainImageLoader(str(folder / split), BATCH, train=train, num_workers=0, seed=seed,
                            image_size=SIZE)


def host_epoch(loader, max_batches=None):
    tasks, _ = loader.raw_batches(max_batches)
    return [(images.numpy(), labels.numpy()) for images, labels in (t() for t in tasks)]


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == np.uint8 and gi.shape == (BATCH, SIZE, SIZE, 3)
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_array_equal(gl, np.asarray(wl))


def test_index_shuffle_equals_grains_compiled_module():
    from grain._src.python.experimental.index_shuffle.python import index_shuffle_module

    for max_index in (1, 2, 15, 16, 17, 255, 256, 257, 1000, 65535, 65536, 100003, 1281166):
        idx = np.unique(np.concatenate([np.arange(min(1000, max_index + 1)),
                                        np.arange(max(0, max_index - 999), max_index + 1)]))
        for seed in (0, 1, 7, 2**31 - 1, 2**32 - 1):
            want = [index_shuffle_module.index_shuffle(int(i), max_index=max_index, seed=seed,
                                                       rounds=4) for i in idx]
            np.testing.assert_array_equal(index_shuffle(idx, max_index, seed),
                                          np.asarray(want, np.uint64), err_msg=f"{max_index} {seed}")
    # A pass is a permutation, and a stream's later passes reshuffle.
    n = 1000
    keys = shuffled_positions(np.arange(3 * n), n, seed=5)
    for e in range(3):
        assert sorted(keys[e * n:(e + 1) * n] - e * n) == list(range(n))
    assert not np.array_equal(keys[:n], keys[n:2 * n] - n)


def test_crops_and_flip_equal_the_jax_functions():
    from turboprune_tpu.data import imagenet as jimg

    # The thin image always takes random_resized_crop's fallback branch.
    blobs = jpeg_blobs(3, ((500, 375), (375, 500), (1000, 10)), seed=2)
    for b, data in enumerate(blobs):
        img_t, img_j = timg._decode_rgb(data), jimg._decode_rgb(data)
        np.testing.assert_array_equal(np.asarray(img_t), np.asarray(img_j))
        np.testing.assert_array_equal(np.asarray(timg.center_crop(img_t, 64)),
                                      np.asarray(jimg.center_crop(img_j, 64)))
        for s in range(6):
            rng_t = np.random.Generator(np.random.Philox(key=s))
            rng_j = np.random.Generator(np.random.Philox(key=s))
            got = timg.train_transform(data, rng_t, 64)
            want = np.asarray(jimg.random_resized_crop(img_j, rng_j, 64), np.uint8)
            if rng_j.uniform() < 0.5:
                want = want[:, ::-1]
            np.testing.assert_array_equal(got, want, err_msg=f"image {b}, key {s}")
    assert timg.DEFAULT_CROP_RATIO == jimg.DEFAULT_CROP_RATIO


def test_train_batches_equal_grain_over_three_epochs(folder):
    port, ref = port_loader("train", True, folder), jax_loader("train", True, folder)
    for _ in range(3):  # 13 = 3 x 4 + 1: each epoch's window drifts by one
        assert_batches_equal(host_epoch(port), list(ref._raw_batches()))
    assert port.position == 3 * 3 * BATCH


def test_eval_batches_padded_equal_grain(folder):
    port, ref = port_loader("val", False, folder), jax_loader("val", False, folder)
    for _ in range(2):
        got, want = host_epoch(port), list(ref._raw_batches())
        assert_batches_equal(got, want)
        assert list(got[-1][1]) == [2, 2, 2, -1]  # 7 = 4 + 3: one padded row
        assert not got[-1][0][-1].any()


def test_len_and_classes_of_both_splits(folder):
    for split, train in (("train", True), ("val", False)):
        port, ref = port_loader(split, train, folder), jax_loader(split, train, folder)
        assert len(port) == len(ref)
        assert port.num_classes == ref.num_classes == 3
        assert repr(port.source) == repr(ref.source)
    assert (len(port_loader("train", True, folder)), len(port_loader("val", False, folder))) == (3, 2)


def test_stream_state_round_trip_replays_the_same_batches(folder):
    first = port_loader("train", True, folder)
    host_epoch(first)
    blob = first.get_stream_state()
    assert len(blob) == 32
    want = [host_epoch(first) for _ in range(2)]
    resumed = port_loader("train", True, folder)
    resumed.set_stream_state(blob)
    for w in want:
        assert_batches_equal(host_epoch(resumed), w)
    # A cut epoch (max_batches) moves the stream by the batches it took,
    # and the next epoch starts there, whatever the workers had decoded.
    cut, ref = port_loader("train", True, folder, workers=2), port_loader("train", True, folder)
    host_epoch(cut, max_batches=2)
    assert cut.position == 2 * BATCH
    ref.position = 2 * BATCH
    assert_batches_equal(host_epoch(cut), host_epoch(ref))


def test_a_stream_state_of_another_loader_raises(folder):
    blob = port_loader("train", True, folder).get_stream_state()
    for other in (port_loader("train", True, folder, seed=4), port_loader("val", True, folder),
                  timg.ImageFolderLoader(str(folder / "train"), 2, True, 0, 3, image_size=SIZE,
                                         device="cpu")):
        with pytest.raises(ValueError, match="another loader"):
            other.set_stream_state(blob)
    with pytest.raises(ValueError):
        port_loader("train", True, folder).set_stream_state(blob[:-1])


def test_two_workers_give_the_batches_of_none(folder):
    zero, two = port_loader("train", True, folder), port_loader("train", True, folder, workers=2)
    for _ in range(2):  # the persistent workers are re-armed for the second epoch
        assert_batches_equal(host_epoch(two), host_epoch(zero))
    assert_batches_equal(host_epoch(port_loader("val", False, folder, workers=2)),
                         host_epoch(port_loader("val", False, folder)))


def test_device_batches_are_the_normalised_host_batches(folder):
    from turboprune_tpu.data.imagenet import _normalize_device

    host = host_epoch(port_loader("train", True, folder))
    chunked = list(port_loader("train", True, folder).iter_chunks(2))
    assert [tuple(x.shape[:2]) for x, _ in chunked] == [(2, BATCH), (BATCH, SIZE)]
    per_batch = list(port_loader("train", True, folder))
    images = torch.cat([chunked[0][0].flatten(0, 1), chunked[1][0]])
    labels = torch.cat([chunked[0][1].flatten(), chunked[1][1]])
    for k, (img, lbl) in enumerate(per_batch):
        assert img.dtype == torch.float32 and lbl.dtype == torch.int64
        want = normalize_uint8(torch.from_numpy(host[k][0]), IMAGENET_MEAN, IMAGENET_STD)
        torch.testing.assert_close(img, want, rtol=0, atol=1e-6)
        torch.testing.assert_close(img, torch.from_numpy(np.array(
            _normalize_device(host[k][0]))), rtol=0, atol=1e-6)
        torch.testing.assert_close(images[k * BATCH:(k + 1) * BATCH], img, rtol=0, atol=0)
        assert lbl.tolist() == host[k][1].tolist() == labels[k * BATCH:(k + 1) * BATCH].tolist()


def test_a_worker_that_fails_surfaces_in_the_consumer(folder, tmp_path):
    bad = tmp_path / "train"
    write_image_folder(bad, ("n01",), 4, SIZES, seed=5)
    (bad / "n01" / "9.jpeg").write_bytes(b"not a jpeg")
    loader = timg.ImageFolderLoader(str(bad), 5, True, num_workers=2, seed=0,
                                    image_size=SIZE, device="cpu")
    with pytest.raises(Exception, match="cannot identify image file"):
        list(loader)


def test_create_loaders_builds_the_pair_and_refuses_mismatched_classes(folder, tmp_path):
    from turboprune_tpu_torch.config import compose

    cfg = compose("imagenet_imp", [f"dataset_params.data_root_dir={folder}",
                                   "dataset_params.total_batch_size=4",
                                   "dataset_params.num_workers=0",
                                   f"dataset_params.image_size={SIZE}"])
    loaders = create_loaders(cfg, "cpu")
    assert isinstance(loaders.train_loader, timg.GrainImageLoader)
    assert loaders.train_loader.train and not loaders.test_loader.train
    assert (loaders.train_loader.num_workers, loaders.num_classes) == (0, 3)
    assert loaders.train_loader.resumable_epochs is False
    write_image_folder(tmp_path / "train", ("n01", "n02"), 1, SIZES)
    write_image_folder(tmp_path / "val", ("n01", "n09"), 1, SIZES)
    with pytest.raises(ValueError, match="class directories differ"):
        timg.ImageNetLoaders(str(tmp_path), 2, num_workers=0, device="cpu")
