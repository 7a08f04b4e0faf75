"""Stdlib HTTP front-end for the inference engine (port of
``turboprune_tpu/serve/server.py``, single-model serving).

Endpoints:
  POST /predict   {"instances": [[H][W][C] floats, ...]}
                  (one image or a [n, H, W, C] nested list)
                  -> {"logits": ..., "classes": ..., "model_level": ...,
                      "density": ...}
  GET  /healthz   engine/checkpoint info + queue depth (200 = ready)
  GET  /metrics   Prometheus text exposition (serve/metrics.py)

ThreadingHTTPServer gives one thread per connection; all of them funnel
into the shared DynamicBatcher, which is where concurrency turns into
batched device forwards. Backpressure surfaces as HTTP 503 (bounded queue
full). A request naming a "model" is a 404: routing between models is the
fleet, which is not ported yet (a ``serve.fleet`` config raises).

Graceful shutdown: ``graceful_shutdown()`` stops accepting connections,
then DRAINS the batcher — every accepted request is answered within the
configured deadline — before the socket closes. run_server_torch.py wires
this to SIGTERM.
"""

from __future__ import annotations

import json
import threading
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..config.schema import ConfigError
from .batcher import DynamicBatcher, QueueFullError
from .engine import InferenceEngine
from .metrics import ServeMetrics


class UnknownModelError(KeyError):
    """The request routed to a model this server does not host (HTTP 404)."""

    def __str__(self) -> str:  # KeyError would repr-quote the message
        return str(self.args[0]) if self.args else ""


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "turboprune-serve-torch"

    # server is the InferenceServer below.
    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass  # access logs off; metrics carry the signal

    def _send_json(self, code: int, obj: dict, headers: dict = ()) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in dict(headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, ctype: str) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - stdlib casing
        if self.path == "/healthz":
            self._send_json(200, self.server.health())
        elif self.path == "/metrics":
            self._send_text(
                200,
                self.server.metrics.render_prometheus(),
                "text/plain; version=0.0.4",
            )
        else:
            self._send_json(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):  # noqa: N802 - stdlib casing
        if self.path != "/predict":
            self._send_json(404, {"error": f"unknown path {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"{}")
            instances = body["instances"]
            model = str(body.get("model", "") or "")
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(
                400, {"error": f"expected JSON body with 'instances': {e!r}"}
            )
            return
        try:
            arr = np.asarray(instances, dtype=np.float32)
        except (ValueError, TypeError) as e:
            self._send_json(400, {"error": f"non-numeric instances: {e!r}"})
            return
        try:
            future, meta = self.server.route(arr, model)
        except UnknownModelError as e:
            self._send_json(404, {"error": str(e)})
            return
        except ValueError as e:  # wrong shape / empty batch
            self._send_json(400, {"error": str(e)})
            return
        except QueueFullError as e:
            self._send_json(
                503, {"error": str(e)}, headers={"Retry-After": "1"}
            )
            return
        try:
            logits = future.result(timeout=self.server.request_timeout_s)
        except FutureTimeoutError:
            self._send_json(
                504,
                {"error": f"inference timed out after "
                          f"{self.server.request_timeout_s}s"},
            )
            return
        except Exception as e:  # engine/batcher failure — keep serving
            self._send_json(500, {"error": repr(e)[:400]})
            return
        self._send_json(
            200,
            {
                "logits": logits.tolist(),
                "classes": np.argmax(logits, axis=-1).tolist(),
                **meta,
            },
        )


class InferenceServer(ThreadingHTTPServer):
    """HTTP server owning one engine and its batcher."""

    daemon_threads = True

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_batch: int = 128,
        max_wait_ms: float = 5.0,
        queue_depth: int = 256,
        request_timeout_s: float = 30.0,
        drain_timeout_s: float = 10.0,
        metrics: Optional[ServeMetrics] = None,
    ):
        self.engine = engine
        self.request_timeout_s = float(request_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.metrics = metrics or engine.metrics or ServeMetrics()
        self.batcher = DynamicBatcher(
            engine,
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            queue_depth=queue_depth,
            metrics=self.metrics,
        ).start()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._close_lock = threading.Lock()
        try:
            super().__init__((host, port), _Handler)
        except OSError:
            self.batcher.close()  # the socket failed: stop the worker too
            raise

    @property
    def port(self) -> int:
        return self.server_address[1]

    def route(self, arr: np.ndarray, model: str = ""):
        """Submit one request; returns (future, response-metadata)."""
        if model:
            raise UnknownModelError(
                f"this server hosts a single model (level "
                f"{self.engine.level}); 'model' routing needs serve.fleet, "
                "which turboprune_tpu_torch does not serve yet"
            )
        return self.batcher.submit(arr), {
            "model_level": self.engine.level,
            "density": round(float(self.engine.density), 6),
        }

    def health(self) -> dict:
        return {
            "status": "ok",
            "queue_depth": self.batcher.queue_depth,
            **self.engine.info(),
        }

    def start_background(self) -> "InferenceServer":
        """serve_forever on a daemon thread (tests / embedding)."""
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self.serve_forever, name="turboprune-http", daemon=True
            )
            self._thread.start()
        return self

    def graceful_shutdown(self, drain_timeout_s: Optional[float] = None):
        """Stop accepting, answer in-flight within the deadline, close.
        Safe to call from any thread EXCEPT the one running serve_forever
        (shutdown() handshakes with it). Returns the drain report."""
        timeout = (
            self.drain_timeout_s
            if drain_timeout_s is None
            else float(drain_timeout_s)
        )
        self.shutdown()  # stop serve_forever wherever it is running
        if self._thread is not None:
            self._thread.join(5.0)
        report = self.batcher.drain(deadline_s=timeout)
        self._server_close_once()
        return report

    def _server_close_once(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self.server_close()

    def close(self) -> None:
        # shutdown() blocks on serve_forever's exit handshake — only safe
        # when OUR background thread is running it.
        if self._thread is not None and self._thread.is_alive():
            self.shutdown()
            self._thread.join(5.0)
        self.batcher.close()
        self._server_close_once()


def build_server(
    cfg,
    expt_dir: str = "",
    metrics: Optional[ServeMetrics] = None,
    device: str = "cuda",
) -> InferenceServer:
    """Compose an InferenceServer from a MainConfig with the serve group
    (conf/serve.yaml). The engine runs on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    sc = cfg.serve
    if sc is None:
        raise ConfigError(
            "config has no serve group — compose with conf/serve.yaml or "
            "add '+serve=default'"
        )
    if sc.fleet is not None:
        raise ConfigError(
            "serve.fleet: fleet serving is not yet ported to "
            "turboprune_tpu_torch (ROADMAP.md) — serve one experiment dir "
            "with serve=default"
        )
    target = expt_dir or sc.expt_dir
    if not target:
        raise ConfigError(
            "no experiment dir: pass --expt-dir or set serve.expt_dir"
        )
    metrics = metrics or ServeMetrics()
    engine = InferenceEngine.from_experiment(
        target,
        level=sc.checkpoint_level,
        role=sc.checkpoint_role,
        buckets=tuple(sc.batch_buckets),
        metrics=metrics,
        compact=sc.compact,
        device=device,
    )
    if sc.warmup:
        engine.warmup()
    return InferenceServer(
        engine,
        host=sc.host,
        port=sc.port,
        max_batch=sc.max_batch,
        max_wait_ms=sc.max_wait_ms,
        queue_depth=sc.queue_depth,
        request_timeout_s=sc.request_timeout_s,
        drain_timeout_s=sc.drain_timeout_s,
        metrics=metrics,
    )
