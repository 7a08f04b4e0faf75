"""Multi-process coordination (port of ``turboprune_tpu/parallel/multihost.py``).

The port runs one process per GPU, as ``torchrun --nproc_per_node=N``
launches it: ``initialize_distributed`` joins the ``torch.distributed``
world from the launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``). Without that environment
the process is a world of one, and every function here is a no-op where the
JAX function is one.

State is replicated: every rank prunes from the same state with the same
seeded generators, so the masks agree by construction.
``check_state_equality`` asserts it once per level (per-leaf moments
computed on the device, then an exact content digest), and
``assert_width_agreement`` asserts that every rank derived the same
compaction before any model is re-instantiated at other widths. Writes of
shared files happen on the primary (rank 0) followed by ``sync_hosts``.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
from typing import Any, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

# The launcher's variables; RANK and WORLD_SIZE mark a launched world.
LAUNCH_ENV = ("RANK", "WORLD_SIZE")
# How long a collective or the world's rendezvous may wait before it raises.
TIMEOUT = datetime.timedelta(minutes=10)


def is_distributed() -> bool:
    """True once this process has joined a world (of any size)."""
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(
    backend: Optional[str] = None, device: str | torch.device = "cuda"
) -> torch.device:
    """Join the world the launcher made; returns the device this process
    runs on. Call it before anything touches CUDA.

    Without ``RANK``/``WORLD_SIZE`` in the environment this is a world of
    one: nothing is joined and ``device`` comes back as given. Otherwise the
    process joins over ``backend`` (default ``nccl`` for a CUDA device,
    ``gloo`` for the CPU; ``gloo`` also carries CUDA tensors, which lets
    several ranks share one card) and, on CUDA, binds ``cuda:LOCAL_RANK``.
    A ``LOCAL_RANK`` beyond the visible cards raises; a world that fails to
    form raises."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available — pass "
            "device='cpu' to run the plain PyTorch path on the CPU"
        )
    if not all(k in os.environ for k in LAUNCH_ENV):
        return dev
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if not 0 <= local_rank < count:
            raise RuntimeError(
                f"LOCAL_RANK={local_rank} but {count} CUDA device(s) are visible: "
                "launch at most one process per card on each node"
            )
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if not is_distributed():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=TIMEOUT,
            **({"device_id": dev} if dev.type == "cuda" and backend in (None, "nccl") else {}),
        )
    return dev


def destroy_distributed() -> None:
    """Leave the world, if this process joined one."""
    if is_distributed():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_primary() -> bool:
    """Rank 0: the one that logs, makes the experiment dir and writes."""
    return process_index() == 0


def say(msg: str) -> None:
    """A console line, from the primary only."""
    if is_primary():
        print(msg, flush=True)


def broadcast_object(obj: Any) -> Any:
    """Rank 0's JSON-serializable ``obj`` on every rank (as JSON gives it
    back: tuples become lists)."""
    if process_count() == 1:
        return obj
    box = [json.dumps(obj) if is_primary() else None]
    dist.broadcast_object_list(box, src=0)
    return json.loads(box[0])


def _all_gather(obj: Any) -> list:
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, torch.Tensor]]:
    """(path, tensor) of every tensor leaf of nested dicts, lists and
    tuples, dict keys in sorted order; None leaves are skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, torch.as_tensor(tree)


def tree_fingerprint(tree: Any) -> str:
    """Deterministic sha256 of every tensor leaf's path and bytes."""
    h = hashlib.sha256()
    for path, leaf in _leaves(tree):
        h.update("/".join(path).encode())
        flat = leaf.detach().reshape(-1).contiguous().cpu()
        h.update(flat.view(torch.uint8).numpy().tobytes() if flat.numel() else b"")
    return h.hexdigest()


def tree_moments(tree: Any) -> np.ndarray:
    """Per-leaf [sum, sum of squares] in fp32, computed on the leaves'
    device: an [L, 2] array is all that reaches the host. Ranks holding
    equal state run the same reduction and get equal moments."""
    rows = []
    for _, leaf in _leaves(tree):
        xf = leaf.detach().float()
        rows.append(torch.stack([xf.sum(), (xf * xf).sum()]).cpu())
    return torch.stack(rows).numpy() if rows else np.zeros((0, 2), np.float32)


def check_state_equality(tree: Any, what: str = "state", exact: bool = False) -> None:
    """Raise unless every rank holds the same ``tree``.

    The per-leaf moments are gathered and compared bit for bit
    (``equal_nan``: ranks that all went NaN alike have not diverged from
    each other); when they differ, the message names the first differing
    leaf. Moments cannot see a divergence that permutes elements within a
    leaf, so ``exact=True`` also gathers ``tree_fingerprint``'s digest (a
    full device-to-host copy: the driver pays it once per level)."""
    if process_count() == 1:
        return
    all_m = _all_gather(tree_moments(tree))
    ref = all_m[0]
    for i, other in enumerate(all_m):
        if ref.shape != other.shape:
            raise RuntimeError(
                f"{what} diverged across hosts: host 0 has {len(ref)} leaves, "
                f"host {i} has {len(other)}."
            )
        if not np.array_equal(ref, other, equal_nan=True):
            bad = int(np.argwhere((ref != other).any(axis=-1))[0][0])
            raise RuntimeError(
                f"{what} diverged across hosts: host 0 != host {i} "
                f"(first differing leaf index {bad}). Replicated pruning "
                "requires identical PRNG keys on every host."
            )
    if exact:
        all_d = _all_gather(tree_fingerprint(tree))
        for i, other in enumerate(all_d):
            if other != all_d[0]:
                raise RuntimeError(
                    f"{what} diverged across hosts: host 0 != host {i} "
                    "(exact content-hash mismatch despite equal per-leaf "
                    "moments — an element-permuting divergence)."
                )


def assert_width_agreement(signature: Any, what: str = "compact-train") -> None:
    """Raise unless every rank derived the same compaction decision
    (``signature``: any JSON-serializable encoding of it). Every rank must
    call this, also when it compacts nothing: it is itself a collective.
    Ranks that went on with different widths would deadlock in the first
    gradient all-reduce with mismatched buffers."""
    if process_count() == 1:
        return
    digest = hashlib.sha256(json.dumps(signature, sort_keys=True, default=str).encode()).hexdigest()
    all_d = _all_gather(digest)
    for i, other in enumerate(all_d):
        if other != all_d[0]:
            raise RuntimeError(
                f"{what} width signature diverged across hosts: host 0 != "
                f"host {i} (this host's signature: {signature!r}). "
                "Re-instantiating would compile divergent shapes; replicated "
                "pruning requires identical masks on every host."
            )


def sync_hosts(name: str = "barrier") -> None:
    """Barrier across the world (``name`` says which, for the reader of a
    hang). Gathers a small object rather than ``dist.barrier``, which under
    NCCL would guess a device for each rank."""
    if process_count() > 1:
        names = _all_gather(name)
        if any(n != name for n in names):
            raise RuntimeError(f"sync_hosts: ranks met at different barriers {names}")
