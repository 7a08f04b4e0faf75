"""Data parallelism across processes (port of the data axis of
``turboprune_tpu/parallel/``): the launched world, its mesh of ranks, the
gradient and metric all-reduces, and the cross-rank agreement checks.
Sequence parallelism on the ``model`` axis (JAX ``parallel/ring.py``) is
ROADMAP.md queue A, item 13b."""

from .mesh import (
    Mesh,
    all_reduce_sums,
    average_gradients,
    broadcast_module,
    create_mesh,
    local_batchnorm,
    set_batchnorm_group,
    shard_batch,
)
from .multihost import (
    assert_width_agreement,
    broadcast_object,
    check_state_equality,
    destroy_distributed,
    initialize_distributed,
    is_distributed,
    is_primary,
    process_count,
    process_index,
    say,
    sync_hosts,
    tree_fingerprint,
    tree_moments,
)

__all__ = [
    "Mesh",
    "all_reduce_sums",
    "assert_width_agreement",
    "average_gradients",
    "broadcast_module",
    "broadcast_object",
    "check_state_equality",
    "create_mesh",
    "destroy_distributed",
    "initialize_distributed",
    "is_distributed",
    "is_primary",
    "local_batchnorm",
    "process_count",
    "process_index",
    "say",
    "set_batchnorm_group",
    "shard_batch",
    "sync_hosts",
    "tree_fingerprint",
    "tree_moments",
]
