"""Shared inputs for the port's parity tests (tests/test_torch_*.py): a
tiny JAX DeiT (depth 2, embed 32, 2 heads, image 32, patch 16, 10 classes),
its params and masks as numpy trees, and seeded images. Every input is made
with numpy from a seed and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboprune_tpu.models.vit import VisionTransformer as JaxViT
from turboprune_tpu.ops import masking as jax_masking

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread for the module: at these sizes more
    threads cost more than they give, and under several test workers they
    contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(num_classes=10, patch_size=16, embed_dim=32, depth=2, num_heads=2)
IMAGE = 32


def jax_deit(attention_impl="flash", distilled=False, dtype=jnp.float32):
    return JaxViT(
        **TINY, distilled=distilled, dtype=dtype, attention_impl=attention_impl
    )


def seeded_params(model, image=IMAGE, seed=0):
    """numpy params for a flax ``model``, seeded normals at the shapes of
    its param tree. ``jax.eval_shape`` gives the tree without compiling an
    init (a 12-block init compiles for many seconds on the CPU). Call it
    with the dense attention: the flash param tree is the same."""
    shapes = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, image, image, 3)), train=False
        )
    )["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=s.shape).astype(np.float32)
        if "scale" in name:  # LayerNorm scale around 1
            return (1.0 + 0.1 * x).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if "kernel" in name else 50
        return (x / np.sqrt(max(fan_in, 1))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_params(distilled=False, seed=0):
    """numpy params of the tiny DeiT."""
    return seeded_params(jax_deit("dense", distilled), seed=seed)


def jax_masks(params, seed=0, keep=0.7):
    """Random masks (bool at every kernel, None elsewhere) as numpy."""
    rng = np.random.default_rng(seed)
    ones = jax_masking.make_masks(params)
    return jax.tree.map(
        lambda m: None if m is None else rng.random(m.shape) < keep,
        ones,
        is_leaf=lambda x: x is None,
    )


def images(n=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, IMAGE, IMAGE, 3)).astype(
        np.float32
    )


def seeded_variables(model, image, seed=0):
    """numpy ``{"params", "batch_stats"}`` for a flax CNN ``model`` at an
    ``image`` x ``image`` input: seeded normals at the shapes of its
    variable tree (BatchNorm scale near 1, biases and running means near
    0, running variances in [1, 1.4), kernels scaled by 1 / sqrt(fan_in))."""
    shapes = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, image, image, 3)), train=False
        )
    )
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=s.shape).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * x).astype(np.float32)
        if "'var'" in name:
            return (1.0 + 0.1 * np.abs(x)).astype(np.float32)
        if "'mean'" in name or "bias" in name:
            return (0.1 * x).astype(np.float32)
        return (x / np.sqrt(int(np.prod(s.shape[:-1])))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jpeg_blobs(n, sizes=((64, 48),), seed=0, quality=90):
    """``n`` distinct JPEG files as bytes, encoded with Pillow from seeded
    images: smooth colour fields (random low-resolution images upsampled
    bilinearly) with a little noise, of (width, height) ``sizes`` taken in
    turn (ImageNet-like sizes such as (500, 375) and (375, 500) take the
    reader's DCT-scaled decode)."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    blobs = []
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        low = rng.integers(0, 256, size=(max(2, h // 16), max(2, w // 16), 3), dtype=np.uint8)
        arr = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR), np.int16)
        arr = np.clip(arr + rng.integers(-8, 9, size=arr.shape), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
        blobs.append(buf.getvalue())
    return blobs


def write_image_folder(root, classes=("a", "b"), per_class=3, sizes=((64, 48),), seed=0):
    """An ImageFolder split under ``root`` (``root/<class>/<i>.jpeg``) of
    ``jpeg_blobs``; returns ``root``."""
    from pathlib import Path

    root = Path(root)
    blobs = jpeg_blobs(len(classes) * per_class, sizes, seed)
    for c, cls in enumerate(classes):
        (root / cls).mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            (root / cls / f"{i}.jpeg").write_bytes(blobs[c * per_class + i])
    return root
