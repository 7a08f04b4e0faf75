"""Persistent on-disk cache of compiled serving forwards (the port's
counterpart of ``turboprune_tpu/serve/fleet/aot_cache.py``).

A bucket's forward is built by ``torch.compile`` (inductor on CUDA). The
trace (dynamo) is cheap and runs in every process; the expensive part is
inductor's code generation and the Triton kernels' compile. This cache
keeps what inductor produced for one bucket, as the bytes
``torch.compiler.save_cache_artifacts()`` returns after the build, in one
file per key. A later process hands an entry's bytes to
``torch.compiler.load_cache_artifacts()`` before it compiles: inductor's
own caches then hold the graph and its kernels, and the compile becomes a
cache hit (``serve/engine.py`` counts only the compiles that still ran,
from inductor's FX-graph cache misses and bypasses).

Keying: the key hashes the semantic identity of the computation — the
traced FX graph's fingerprint (its code and its inputs' shapes and dtypes),
the execution-plan signature (compacted widths / N:M plan / masked), and
the batch bucket. The environment (torch version, CUDA version, device
name) is stored in the entry's header and CHECKED at load: a mismatch is a
"bypass" (the entry is ignored and the next store overwrites it with the
current environment's build), never a crash and never a wrong hit.
Unreadable or truncated entries are quarantined (renamed
``*.quarantined``) and counted, so one corrupt file costs one cold compile.

An entry is bytes, never a pickle of Python objects: a magic word, the
header's length, the header as JSON (format, environment, payload length
and digest), then the payload. Writes are atomic (tmp file + rename), so
processes sharing a cache directory never read a torn entry.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
from pathlib import Path
from typing import Any, Optional

import torch

_FORMAT_VERSION = 1
_SUFFIX = ".tpac"
_MAGIC = b"TPAC"
_HEADER_LEN = struct.Struct("<I")

# Load statuses (also the counter keys, exported via stats()).
HIT = "hit"
MISS = "miss"
BYPASS = "bypass"
CORRUPT = "corrupt"


def _env_meta(device: torch.device) -> dict:
    """What a compiled artifact is only valid under."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {
        "format": _FORMAT_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "device": name,
    }


class AOTExecutableCache:
    """Directory of compiled-forward artifacts; thread-safe, shared
    fleet-wide."""

    def __init__(self, cache_dir: str | Path):
        self.dir = Path(cache_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._counters = {HIT: 0, MISS: 0, BYPASS: 0, CORRUPT: 0, "stores": 0}
        # guarded-by: _lock. key -> {"plan_kind", "bucket"} for every key
        # minted in this process: which plan and bucket each entry holds.
        self._key_meta: dict = {}

    # --------------------------------------------------------------- keying
    @staticmethod
    def fingerprint(graph_module, example_inputs) -> str:
        """Fingerprint of a dynamo-traced forward: the FX graph's code and
        its inputs' shapes, strides and dtypes."""
        spec = [
            (tuple(t.shape), tuple(t.stride()), str(t.dtype))
            if isinstance(t, torch.Tensor) else repr(t)
            for t in example_inputs
        ]
        text = graph_module.code + "\n" + repr(spec)
        return hashlib.sha256(text.encode()).hexdigest()

    def make_key(
        self,
        *,
        graph_fingerprint: str,
        plan_signature: Any = ("masked",),
        bucket: int = 0,
    ) -> str:
        blob = json.dumps(
            {
                "graph": graph_fingerprint,
                "plan": repr(plan_signature),
                "bucket": int(bucket),
            },
            sort_keys=True,
        )
        key = hashlib.sha256(blob.encode()).hexdigest()[:40]
        kind = (
            str(plan_signature[0])
            if isinstance(plan_signature, (tuple, list)) and plan_signature
            else repr(plan_signature)
        )
        with self._lock:
            self._key_meta[key] = {"plan_kind": kind, "bucket": int(bucket)}
        return key

    def key_meta(self) -> dict:
        """Snapshot of the key ledger: key -> {plan_kind, bucket} for every
        key minted via make_key in this process."""
        with self._lock:
            return {k: dict(v) for k, v in self._key_meta.items()}

    def _path(self, key: str) -> Path:
        return self.dir / f"{key}{_SUFFIX}"

    # ---------------------------------------------------------------- load
    def load(self, key: str, device: torch.device) -> tuple[Optional[bytes], str]:
        """Returns ``(payload_or_None, status)`` with status one of
        hit/miss/bypass/corrupt. Never raises on a bad entry."""
        path = self._path(key)
        try:
            blob = path.read_bytes()
        except FileNotFoundError:
            return None, self._count(MISS)
        try:
            meta, payload = _decode(blob)
        except ValueError:
            self._quarantine(path)
            return None, self._count(CORRUPT)
        env = _env_meta(device)
        if any(meta.get("env", {}).get(k) != v for k, v in env.items()):
            # Built by another torch / CUDA / card: inductor's artifacts are
            # not portable across those, so ignore it; the caller compiles
            # and store() overwrites with this environment's build.
            return None, self._count(BYPASS)
        return payload, self._count(HIT)

    # --------------------------------------------------------------- store
    def store(self, key: str, payload: bytes, device: torch.device) -> None:
        """Write one entry atomically."""
        header = json.dumps({
            "env": _env_meta(device),
            "payload_len": len(payload),
            "sha256": hashlib.sha256(payload).hexdigest(),
        }, sort_keys=True).encode()
        path = self._path(key)
        tmp = path.with_suffix(f".tmp.{os.getpid()}.{threading.get_ident()}")
        tmp.write_bytes(_MAGIC + _HEADER_LEN.pack(len(header)) + header + payload)
        os.replace(tmp, path)
        with self._lock:
            self._counters["stores"] += 1

    # ------------------------------------------------------------ plumbing
    def _count(self, status: str) -> str:
        with self._lock:
            self._counters[status] = self._counters.get(status, 0) + 1
        return status

    def _quarantine(self, path: Path) -> None:
        try:
            os.replace(path, path.with_suffix(".quarantined"))
        except OSError:
            pass  # already moved by a racing loader, or dir went away

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
        out["entries"] = len(list(self.dir.glob(f"*{_SUFFIX}")))
        out["quarantined"] = len(list(self.dir.glob("*.quarantined")))
        out["dir"] = str(self.dir)
        return out


def _decode(blob: bytes) -> tuple[dict, bytes]:
    """(header, payload) of an entry; ValueError when it is not a whole,
    intact entry of this format."""
    n = len(_MAGIC) + _HEADER_LEN.size
    if len(blob) < n or blob[: len(_MAGIC)] != _MAGIC:
        raise ValueError("not a cache entry")
    (header_len,) = _HEADER_LEN.unpack(blob[len(_MAGIC):n])
    try:
        meta = json.loads(blob[n:n + header_len])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"unreadable header: {e}") from None
    if not isinstance(meta, dict):
        raise ValueError("header is not an object")
    payload = blob[n + header_len:]
    if (len(payload) != meta.get("payload_len")
            or hashlib.sha256(payload).hexdigest() != meta.get("sha256")):
        raise ValueError("truncated or altered payload")
    return meta, payload


def open_cache(cache_dir: str | Path | None) -> Optional[AOTExecutableCache]:
    """'' / None disables the persistent layer (in-memory buckets only)."""
    if not cache_dir:
        return None
    return AOTExecutableCache(cache_dir)
