"""InferenceEngine — pruned-checkpoint forward over padded batch buckets
(port of ``turboprune_tpu/serve/engine.py``, masked backend).

Loads an experiment-dir checkpoint (``model_level_{L}`` or a role like
``model_init``) next to the experiment's own ``expt_config.yaml`` snapshot,
so a served checkpoint can never be paired with the wrong architecture.
A checkpoint's batch_stats (a ResNet's BatchNorm running statistics) load
with its params, and the model serves in eval mode on them. Masks are folded into the weights ONCE at load time (``w * m`` is exact),
so per-request forwards skip the mask multiply. A request for n rows is
padded up to the smallest bucket >= n (split at the largest bucket), so the
device only ever sees the configured batch shapes; ``warmup()`` runs every
bucket once before traffic arrives. Where the JAX engine counts compile
cache hits and misses, this one counts each bucket's first run and its warm
runs.

The sparse backends (compaction, N:M, the planner) are a later slice of
the port: ``backend`` other than ``masked`` and ``compact=True`` raise.
"""

from __future__ import annotations

import bisect
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models import create_model
from ..ops import masking
from ..utils.checkpoint import ExperimentCheckpoints, model_state_dict, restore_model_tree
from ..utils.device import resolve_device
from ..utils.experiment import load_config

DEFAULT_BUCKETS = (1, 8, 32, 128)

PRECISION_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}

# The JAX engine's backend knob. Only the masked-dense backend is ported.
BACKENDS = ("masked", "compact", "nm", "auto", "mixed")


class InferenceEngine:
    """Bucketed, mask-folded forward over a loaded checkpoint.

    ``predict`` is thread-safe: the model is read-only after load and every
    forward runs under ``torch.inference_mode``."""

    def __init__(
        self,
        model: nn.Module,
        state_dict: dict,
        masks: dict,
        *,
        input_shape: Sequence[int],
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        metrics=None,
        level: Optional[int] = None,
        source: str = "",
        compact: bool = False,
        backend: Optional[str] = None,
        device: str | torch.device = "cuda",
    ):
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        if backend is None:
            backend = "compact" if compact else "masked"
        if backend not in BACKENDS:
            raise ValueError(f"unknown serving backend {backend!r}")
        if backend != "masked":
            raise NotImplementedError(
                f"serving backend {backend!r} is part of the sparse-execution "
                "slice of the port (ROADMAP.md, queue A: compaction, N:M and "
                "the planner), not yet ported — serve with backend='masked'"
            )
        self.backend = backend
        self.device = resolve_device(device)
        self.input_shape = tuple(int(d) for d in input_shape)
        self.metrics = metrics
        self.level = level
        self.source = source
        self.density = masking.overall_density(masks)
        # Fold once: pruned weights become literal zeros in the served
        # model, so forwards never multiply by the mask.
        model.load_state_dict(masking.apply_masks(state_dict, masks))
        self.model = model.to(self.device).eval()
        self.num_classes = int(getattr(model, "num_classes", 0)) or None
        self._warm: set[int] = set()  # guarded-by: _warm_lock
        self._warm_lock = threading.Lock()

    # ------------------------------------------------------------- warmup
    def _note_run(self, bucket: int, seconds: float) -> None:
        with self._warm_lock:
            first = bucket not in self._warm
            self._warm.add(bucket)
        if self.metrics:
            if first:
                self.metrics.bucket_first_run()
                self.metrics.inc("first_run_seconds_total", seconds)
            else:
                self.metrics.bucket_warm()

    def warmup(self) -> None:
        """Run every bucket once (first runs counted; later traffic then
        finds every bucket warm)."""
        for b in self.buckets:
            self._predict_chunk(np.zeros((b, *self.input_shape), np.float32))

    @property
    def warmed_buckets(self) -> tuple[int, ...]:
        with self._warm_lock:
            return tuple(sorted(self._warm))

    # ----------------------------------------------------------- inference
    def predict(self, images: np.ndarray) -> np.ndarray:
        """Logits for a [n, H, W, C] float batch (or one [H, W, C] image),
        any n >= 1. Pads to the bucket internally; returns exactly n rows of
        float32 logits — padded rows never leak (rows are independent)."""
        x = np.asarray(images, np.float32)
        if x.ndim == len(self.input_shape):
            x = x[None]
        if x.ndim != len(self.input_shape) + 1 or x.shape[1:] != self.input_shape:
            raise ValueError(
                f"expected images of shape [n, {', '.join(map(str, self.input_shape))}]"
                f" (or one unbatched image), got {x.shape}"
            )
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        max_b = self.buckets[-1]
        outs = [
            self._predict_chunk(x[off : off + max_b])
            for off in range(0, n, max_b)
        ]
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def _predict_chunk(self, chunk: np.ndarray) -> np.ndarray:
        k = chunk.shape[0]
        bucket = self.buckets[bisect.bisect_left(self.buckets, k)]
        if bucket > k:
            pad = np.zeros((bucket - k, *self.input_shape), np.float32)
            chunk = np.concatenate([chunk, pad])
            if self.metrics:
                self.metrics.inc("padded_rows_total", bucket - k)
        t0 = time.perf_counter()
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            logits = self.model(x).float().cpu().numpy()
        self._note_run(bucket, time.perf_counter() - t0)
        return logits[:k]

    def info(self) -> dict:
        return {
            "level": self.level,
            "density": round(float(self.density), 6),
            "backend": self.backend,
            "buckets": list(self.buckets),
            "warmed_buckets": list(self.warmed_buckets),
            "input_shape": list(self.input_shape),
            "num_classes": self.num_classes,
            "source": self.source,
            "device": str(self.device),
        }

    # -------------------------------------------------------- construction
    @classmethod
    def from_experiment(
        cls,
        expt_dir: str | Path,
        *,
        level: Optional[int] = None,
        role: str = "",
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        metrics=None,
        precision: Optional[str] = None,
        compact: bool = False,
        backend: Optional[str] = None,
        device: str | torch.device = "cuda",
    ) -> "InferenceEngine":
        """Build from an experiment directory.

        ``level=None`` / ``level=-1`` serves the highest saved
        ``model_level_{L}``; ``role`` (e.g. ``model_init``) overrides level.
        ``precision`` overrides the experiment's training_precision for the
        serving forward (default: serve with the training dtype)."""
        dev = resolve_device(device)
        expt_dir = Path(expt_dir)
        cfg = load_config(expt_dir)
        dp = cfg.dataset_params
        dtype = PRECISION_DTYPES[
            precision or cfg.experiment_params.training_precision
        ]
        model = create_model(
            cfg.model_params.model_name,
            num_classes=dp.num_classes,
            dataset_name=dp.dataset_name,
            compute_dtype=dtype,
            # Single-device serving: ring maps to the param-identical dense
            # attention inside the model.
            attention_impl=cfg.model_params.attention_impl,
            image_size=dp.image_size,
        )
        ckpts = ExperimentCheckpoints(expt_dir)
        if role:
            path = ckpts.model_path(role)
            level = None
        else:
            if level is None or level < 0:
                saved = ckpts.saved_levels()
                if not saved:
                    raise FileNotFoundError(
                        f"no model_level_* checkpoints under "
                        f"{ckpts.checkpoints_dir}"
                    )
                level = saved[-1]
            path = ckpts.level_path(level)
        if not path.exists():
            raise FileNotFoundError(f"checkpoint {path} does not exist")
        restored = restore_model_tree(path)
        return cls(
            model,
            model_state_dict(restored),
            restored["masks"],
            input_shape=(dp.image_size, dp.image_size, 3),
            buckets=buckets,
            metrics=metrics,
            level=level,
            source=str(path),
            compact=compact,
            backend=backend,
            device=dev,
        )
