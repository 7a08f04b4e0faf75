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


def run_once(tmp_path_factory, name: str, produce):
    """``produce(root)`` computed once per test session, by whichever
    worker asks first. Under pytest-xdist each worker's base temp dir lies
    in one directory of the session: the first worker to ask runs
    ``produce`` there under a file lock and saves its result with
    ``torch.save``; the others wait on the lock and load it, so a module's
    expensive runs are not repeated on every worker its tests land on.
    Without xdist it runs in a temp dir of its own. ``produce`` writes its
    files under ``root`` and returns a picklable result; tests only read
    them."""
    import fcntl
    import os
    import shutil

    if "PYTEST_XDIST_WORKER" not in os.environ:
        return produce(tmp_path_factory.mktemp(name))
    session = tmp_path_factory.getbasetemp().parent
    root = session / f"run_once_{name}"
    result = root / "result.pt"
    with open(session / f"run_once_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not result.exists():
            if root.exists():  # a run that raised half way
                shutil.rmtree(root)
            root.mkdir()
            out = produce(root)
            torch.save(out, root / "result.tmp")
            os.replace(root / "result.tmp", result)
            return out
    return torch.load(result, weights_only=False)


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


def spawn_world(suite: str, root, beside=None, nproc: int = 2, timeout: float = 300.0) -> tuple:
    """Run ``tests/torch_port_dp_worker.py <suite> <root>`` as a world of
    ``nproc`` gloo processes on localhost, each joined through the port's
    ``initialize_distributed`` from torchrun's variables (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), and ``beside()`` in
    this process while they run. Returns (each rank's results, read from
    ``result_<rank>.pt``, and what ``beside`` returned). Every worker has a
    wall limit: a deadlock fails the test instead of hanging the suite."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    worker = Path(__file__).parent / "torch_port_dp_worker.py"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(nproc),
               OMP_NUM_THREADS="1", PYTHONPATH=str(worker.parents[1]))
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), suite, str(root)],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            cwd=str(worker.parents[1]),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for r in range(nproc)
    ]
    outs = []
    try:
        made = beside() if beside is not None else None
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"world {suite!r} timed out after {timeout} s (deadlock?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r, p in enumerate(procs):
        path = Path(root) / f"result_{r}.pt"
        assert p.returncode == 0 and path.exists(), (
            f"rank {r} of world {suite!r} failed (rc={p.returncode})\n{outs[r][-6000:]}")
        results.append(torch.load(path, weights_only=False))
    return results, made
