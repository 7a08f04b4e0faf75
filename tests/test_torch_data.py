"""The port's data layer (turboprune_tpu_torch/data/) against the JAX
package's. Synthetic data, the CIFAR files as read, and the deterministic
transforms (normalisation, reflect padding, the crop and the cutout at
given offsets, the altflip) must match exactly;
the random draws come from torch generators, which give other numbers than
jax.random from the same seed, so those are checked for their structure."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from turboprune_tpu.data import augment as jax_augment
from turboprune_tpu.data.cifar import load_cifar_arrays as jax_load_cifar_arrays
from turboprune_tpu.data.synthetic import synthetic_arrays as jax_synthetic_arrays
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.data import augment, create_loaders
from turboprune_tpu_torch.data.cifar import (
    CifarLoaders,
    DeviceCifarLoader,
    cache_cifar_npz,
    load_cifar_arrays,
)
from turboprune_tpu_torch.data.synthetic import SyntheticLoaders, synthetic_arrays


@pytest.mark.parametrize("task", ["easy", "hard"])
def test_synthetic_arrays_are_byte_identical(task):
    x, y = synthetic_arrays(12, 32, 10, seed=3, task=task, snr=1.5)
    jx, jy = jax_synthetic_arrays(12, 32, 10, seed=3, task=task, snr=1.5)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()


def _uint8_images(n=3, h=6, w=5, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)


def test_normalize_and_reflect_pad_are_exact():
    x = _uint8_images()
    got = augment.normalize_uint8(torch.from_numpy(x), augment.CIFAR10_MEAN, augment.CIFAR10_STD)
    want = jax_augment.normalize_uint8(
        jnp.asarray(x), jax_augment.CIFAR10_MEAN, jax_augment.CIFAR10_STD)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # H != W and C = 3: a pad of the last two dims (W and C in NHWC) would
    # give another shape.
    padded = augment.pad_reflect(got, 2)
    assert padded.shape == (3, 10, 9, 3)
    assert np.array_equal(padded.numpy(), np.asarray(jax_augment.pad_reflect(want, 2)))


def test_crop_equals_dynamic_slice_at_fixed_offsets():
    padded = np.random.default_rng(1).normal(size=(6, 8, 8, 3)).astype(np.float32)
    sy = np.array([0, 4, 2, 1, 4, 3])
    sx = np.array([4, 0, 2, 3, 1, 0])
    got = augment.crop_at(torch.from_numpy(padded), torch.from_numpy(sy),
                          torch.from_numpy(sx), 4)
    want = jax.vmap(
        lambda img, y, x: jax.lax.dynamic_slice(img, (y, x, 0), (4, 4, 3))
    )(jnp.asarray(padded), jnp.asarray(sy), jnp.asarray(sx))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_altflip_flips_the_whole_set_on_odd_epochs():
    base = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 5, 5, 3)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    kw = dict(crop_size=5, flip=True, translate=0)
    for epoch in range(4):
        out = augment.augment_epoch(base, g, epoch, **kw)
        want = jax_augment.augment_epoch(
            jnp.asarray(base.numpy()), jax.random.PRNGKey(0), jnp.asarray(epoch),
            altflip=True, **kw)
        assert np.array_equal(out.numpy(), np.asarray(want))
        assert torch.equal(out, base.flip(2) if epoch % 2 else base)


def test_random_crop_is_a_shifted_window_of_the_padded_image():
    padded = augment.pad_reflect(torch.arange(2 * 4 * 4 * 1, dtype=torch.float32)
                                 .reshape(2, 4, 4, 1), 2)
    out = augment.batch_translate_crop(padded, torch.Generator().manual_seed(3), 4)
    for i in range(2):
        windows = [padded[i, y:y + 4, x:x + 4] for y in range(5) for x in range(5)]
        assert any(torch.equal(out[i], w) for w in windows)


def test_train_shuffle_is_a_permutation_and_seeded():
    n = 12
    images = _uint8_images(n, 4, 4, seed=4)
    labels = np.arange(n, dtype=np.int32)  # label = row id
    loader = DeviceCifarLoader(images, labels, 4, train=True, aug={}, seed=5, device="cpu")
    base = augment.normalize_uint8(torch.from_numpy(images), augment.CIFAR10_MEAN,
                                   augment.CIFAR10_STD)
    orders = []
    for _ in range(2):
        seen = [(x, y) for x, y in loader]
        ids = torch.cat([y for _, y in seen])
        assert sorted(ids.tolist()) == list(range(n))
        for x, y in seen:
            assert torch.equal(x, base[y])
        orders.append(ids.tolist())
    assert orders[0] != orders[1]  # a fresh permutation each epoch
    again = DeviceCifarLoader(images, labels, 4, train=True, aug={}, seed=5, device="cpu")
    assert torch.cat([y for _, y in again]).tolist() == orders[0]


def test_eval_batches_pad_with_minus_one():
    loaders = SyntheticLoaders("CIFAR10", batch_size=4, image_size=8, num_classes=10,
                               num_train=8, num_test=10, seed=0, device="cpu")
    batches = list(loaders.test_loader)
    assert len(batches) == 3
    x, y = batches[-1]
    assert x.shape == (4, 8, 8, 3) and y.tolist()[2:] == [-1, -1]
    assert not x[2:].any()
    _, want = synthetic_arrays(10, 8, 10, seed=1)
    assert torch.cat([b[1] for b in batches])[:10].tolist() == want.tolist()
    train = list(loaders.train_loader)
    assert len(train) == 2 and all(b[0].shape == (4, 8, 8, 3) for b in train)


def _write_pickles(root, dataset, seed=0):
    """A tiny set in the CIFAR python-pickle layout: CIFAR-10's five train
    batches and test batch, or CIFAR-100's train and test files (rows of
    3 x 32 x 32 uint8 planes, labels as lists)."""
    rng = np.random.default_rng(seed)
    if dataset == "CIFAR10":
        d = root / "cifar-10-batches-py"
        files = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
        key = b"labels"
    else:
        d = root / "cifar-100-python"
        files = ["train", "test"]
        key = b"fine_labels"
    d.mkdir(parents=True)
    for i, name in enumerate(files):
        n = 3 + i
        entry = {
            b"data": rng.integers(0, 256, size=(n, 3 * 32 * 32), dtype=np.uint8),
            key: rng.integers(0, 10, size=n).tolist(),
        }
        with open(d / name, "wb") as f:
            pickle.dump(entry, f)


@pytest.mark.parametrize("dataset", ["CIFAR10", "CIFAR100"])
def test_load_cifar_arrays_is_byte_identical(tmp_path, dataset):
    _write_pickles(tmp_path, dataset)
    got = load_cifar_arrays(str(tmp_path), dataset)
    want = jax_load_cifar_arrays(str(tmp_path), dataset)
    for (x, y), (jx, jy) in zip(got, want):
        assert x.dtype == jx.dtype == np.uint8 and y.dtype == jy.dtype == np.int32
        assert x.shape[1:] == (32, 32, 3)
        assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
    # The npz cache comes first, and the JAX package reads it alike.
    cache = tmp_path / "cache"
    cache_cifar_npz(str(cache), dataset, *got)
    for (x, y), (jx, jy) in zip(load_cifar_arrays(str(cache), dataset),
                                jax_load_cifar_arrays(str(cache), dataset)):
        assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()


def test_missing_cifar_names_synthetic(tmp_path):
    with pytest.raises(FileNotFoundError, match="dataloader_type: synthetic"):
        load_cifar_arrays(str(tmp_path), "CIFAR10")


def test_cutout_is_exact_at_the_jax_offsets():
    images = np.random.default_rng(6).normal(size=(5, 9, 7, 3)).astype(np.float32)
    key, size = jax.random.PRNGKey(4), 3
    want = jax_augment.batch_cutout(jnp.asarray(images), key, size)
    ky, kx = jax.random.split(key)  # the offsets the JAX package drew
    cy = jax.random.randint(ky, (5, 1, 1, 1), 0, 9 - size + 1)
    cx = jax.random.randint(kx, (5, 1, 1, 1), 0, 7 - size + 1)
    got = augment.cutout_at(torch.from_numpy(images), torch.from_numpy(np.array(cy)),
                            torch.from_numpy(np.array(cx)), size)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_random_flips_and_cutout_per_image():
    """altflip=False flips each image or not, afresh each epoch; cutout
    zeroes one size x size square per image."""
    base = torch.from_numpy(np.random.default_rng(7).normal(size=(16, 6, 6, 3))
                            .astype(np.float32)) + 10.0  # no zero before cutout
    g = torch.Generator().manual_seed(1)
    flipped = [augment.augment_epoch(base, g, e, crop_size=6, flip=True, translate=0,
                                     altflip=False) for e in range(2)]
    for out in flipped:
        is_flip = [bool(torch.equal(o, b.flip(1))) for o, b in zip(out, base)]
        assert all(torch.equal(o, b.flip(1)) or torch.equal(o, b)
                   for o, b in zip(out, base))
        assert 0 < sum(is_flip) < 16
    assert not torch.equal(flipped[0], flipped[1])
    cut = augment.augment_epoch(base, g, 0, crop_size=6, flip=False, translate=0, cutout=2)
    zero = (cut == 0).all(-1)
    assert zero.sum((1, 2)).tolist() == [4] * 16
    for z in zero:
        ys, xs = z.nonzero(as_tuple=True)
        assert int(ys.max() - ys.min()) == 1 and int(xs.max() - xs.min()) == 1
    torch.testing.assert_close(cut[~zero], base[~zero], rtol=0, atol=0)


def test_cifar_loaders_and_create_loaders_on_local_files(tmp_path):
    _write_pickles(tmp_path, "CIFAR10")
    (_, _), (test_x, test_y) = load_cifar_arrays(str(tmp_path), "CIFAR10")
    cfg = compose("cifar10_imp", [f"dataset_params.data_root_dir={tmp_path}",
                                  "dataset_params.total_batch_size=4"])
    loaders = create_loaders(cfg, "cpu")
    assert isinstance(loaders, CifarLoaders) and loaders.num_classes == 10
    train = loaders.train_loader
    assert len(train) == 25 // 4 and train.altflip and train.aug == {"flip": True, "translate": 2}
    assert all(x.shape == (4, 32, 32, 3) for x, _ in train)
    labels = torch.cat([y for _, y in loaders.test_loader])
    assert labels.tolist() == test_y.tolist()  # in order: 8 rows, 2 batches
    loader = DeviceCifarLoader(test_x, test_y, 4, train=True, aug={"cutout": 3, "flip": True},
                               altflip=False, seed=0, device="cpu")
    assert next(iter(loader))[0].shape == (4, 32, 32, 3)
    with pytest.raises(ValueError, match="Unrecognized aug"):
        DeviceCifarLoader(test_x, test_y, 4, train=True, aug={"mixup": 1}, device="cpu")
