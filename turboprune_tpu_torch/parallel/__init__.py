"""Parallelism across processes (port of ``turboprune_tpu/parallel/``):
the launched world, its (data, model) mesh of ranks, the gradient and
metric all-reduces over the data axis, ring attention over the model axis
(sequence parallelism, ``ring.py``), and the cross-rank agreement
checks."""

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
from .ring import ring_attention, ring_shift

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
    "ring_attention",
    "ring_shift",
    "say",
    "set_batchnorm_group",
    "shard_batch",
    "sync_hosts",
    "tree_fingerprint",
    "tree_moments",
]
