"""Model registry — the fleet's map from model ids to checkpoints (a copy
of ``turboprune_tpu/serve/fleet/registry.py`` over the port's checkpoints).

Scans one or more experiment directories (each written by
run_experiment_torch.py: ``expt_config.yaml`` + ``checkpoints/model_level_{L}``)
and assigns every saved level a stable model id: ``level_{L}`` for a
single-experiment fleet, ``{dirname}/level_{L}`` when serving several
experiments from one process. The scan is metadata-only — checkpoints are
NOT loaded here; the fleet engine pages weights in lazily on first request.

Routing: a request names a model id, or omits it and gets the configured
default route — ``latest`` (highest level of the first experiment, i.e. the
sparsest/cheapest artifact of the IMP run), ``dense`` (level 0), or
``pinned`` (an explicit id from config). Unknown ids raise
``UnknownModelError``, which the HTTP layer answers as 404 with the list of
known ids — fail loud, never silently serve the wrong weights.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

ROUTE_CHOICES = ("latest", "dense", "pinned")


class UnknownModelError(KeyError):
    """Requested model id is not in the registry (HTTP 404)."""

    def __str__(self) -> str:  # KeyError would re-quote the message
        return self.args[0] if self.args else ""


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    model_id: str
    expt_dir: Path
    level: int


class ModelRegistry:
    def __init__(self, expt_dirs: Sequence[str | Path]):
        dirs = [Path(d) for d in expt_dirs]
        if not dirs:
            raise ValueError("ModelRegistry needs at least one experiment dir")
        self.expt_dirs = dirs
        self.specs: dict[str, ModelSpec] = {}
        self._scan()

    def _scan(self) -> None:
        from ...utils.checkpoint import ExperimentCheckpoints

        multi = len(self.expt_dirs) > 1
        for d in self.expt_dirs:
            if not (d / "expt_config.yaml").exists():
                raise FileNotFoundError(
                    f"{d}/expt_config.yaml not found — is {d} an experiment "
                    "dir written by run_experiment_torch.py?"
                )
            levels = ExperimentCheckpoints(d).saved_levels()
            if not levels:
                raise FileNotFoundError(
                    f"no model_level_* checkpoints under {d}/checkpoints"
                )
            for lvl in levels:
                model_id = (
                    f"{d.name}/level_{lvl}" if multi else f"level_{lvl}"
                )
                if model_id in self.specs:
                    raise ValueError(
                        f"duplicate model id {model_id!r} — experiment dirs "
                        "sharing a basename cannot be served together; "
                        "rename one"
                    )
                self.specs[model_id] = ModelSpec(
                    model_id=model_id, expt_dir=d, level=lvl
                )

    # -------------------------------------------------------------- lookup
    def ids(self) -> list[str]:
        return list(self.specs)

    def __len__(self) -> int:
        return len(self.specs)

    def get(self, model_id: str) -> ModelSpec:
        spec = self.specs.get(model_id)
        if spec is None:
            raise UnknownModelError(
                f"unknown model {model_id!r}; known: {sorted(self.specs)}"
            )
        return spec

    def default_id(
        self, default_route: str = "latest", pinned_model: str = ""
    ) -> str:
        """Resolve the no-model-field route to a concrete id."""
        if default_route == "pinned":
            return self.get(pinned_model).model_id
        if default_route not in ROUTE_CHOICES:
            raise ValueError(
                f"unknown default route {default_route!r}; "
                f"choose from {ROUTE_CHOICES}"
            )
        first = self.expt_dirs[0]
        prefix = f"{first.name}/" if len(self.expt_dirs) > 1 else ""
        levels = sorted(
            s.level for s in self.specs.values() if s.expt_dir == first
        )
        lvl = levels[-1] if default_route == "latest" else levels[0]
        return f"{prefix}level_{lvl}"

    def resolve(
        self,
        requested: Optional[str],
        *,
        default_route: str = "latest",
        pinned_model: str = "",
    ) -> ModelSpec:
        if requested:
            return self.get(requested)
        return self.get(self.default_id(default_route, pinned_model))
