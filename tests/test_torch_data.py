"""The port's data layer (turboprune_tpu_torch/data/) against the JAX
package's. Synthetic data and the deterministic transforms (normalisation,
reflect padding, the crop at given offsets, the altflip) must match exactly;
the random draws come from torch generators, which give other numbers than
jax.random from the same seed, so those are checked for their structure."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from turboprune_tpu.data import augment as jax_augment
from turboprune_tpu.data.synthetic import synthetic_arrays as jax_synthetic_arrays
from turboprune_tpu_torch.data import augment
from turboprune_tpu_torch.data.cifar import DeviceCifarLoader
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
