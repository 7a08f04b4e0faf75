"""Fleet serving: multi-checkpoint tenancy from one process (port of
``turboprune_tpu/serve/fleet/``).

registry.py   ModelRegistry — scan experiment dirs, id every saved level,
              resolve request routing (latest / dense / pinned)
engine.py     FleetEngine — per-model engine+batcher+labelled-metrics
              stacks behind one door, LRU weight paging, replica lanes
aot_cache.py  AOTExecutableCache — inductor's compiled artifacts per
              (graph, plan, bucket) on disk, so a restart loads instead of
              compiling

Configured by ``serve.fleet`` (conf/serve/fleet.yaml); HTTP front-end is
the same InferenceServer (serve/server.py) with routing on the request's
``model`` field.
"""

from .aot_cache import AOTExecutableCache, open_cache
from .engine import FleetEngine
from .registry import ModelRegistry, ModelSpec, UnknownModelError

__all__ = [
    "AOTExecutableCache",
    "FleetEngine",
    "ModelRegistry",
    "ModelSpec",
    "UnknownModelError",
    "open_cache",
]
