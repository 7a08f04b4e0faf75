#!/usr/bin/env python
"""Serve pruned TurboPrune checkpoints over HTTP with the PyTorch/CUDA port
(turboprune_tpu_torch).

Usage:
    python run_server_torch.py --expt-dir experiments/<dir> [serve.port=8080 ...]
    python run_server_torch.py --device cpu --expt-dir experiments/<dir>
    python run_server_torch.py --config-name serve serve=fleet \
        "serve.fleet.expt_dirs=[experiments/<dir>]"   # every level, one process

The serve group composes Hydra-style from conf/serve/ (see conf/serve.yaml);
the model architecture and input geometry come from the experiment dir's own
expt_config.yaml snapshot. The experiment dir holds checkpoints in the
port's format (turboprune_tpu_torch/utils/checkpoint.py). The engine runs on
CUDA unless --device cpu is given; without CUDA, --device cuda fails instead
of falling back to the CPU.

Endpoints:
    POST /predict   {"instances": [[H][W][C] floats, ...], "model": "level_3"}
                    ("model" routes within a fleet; omit for the default)
    GET  /healthz   checkpoint level/density, buckets, queue depth
                    (fleet: one row per registered model)
    GET  /metrics   Prometheus text (latency histogram, throughput,
                    queue depth, compile/AOT-cache hit/miss; fleet series
                    are labelled by model id)

SIGTERM triggers a graceful shutdown: the listener stops, already-accepted
requests are answered for up to serve.drain_timeout_s, then the process
exits.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--config-name",
        default="serve",
        help="top-level config under conf/ (default: serve)",
    )
    parser.add_argument(
        "--config-path", default=None, help="alternate config root directory"
    )
    parser.add_argument(
        "--expt-dir",
        default="",
        help="experiment directory to serve (overrides serve.expt_dir)",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="torch device for the forward: cuda (default) or cpu",
    )
    parser.add_argument(
        "overrides",
        nargs="*",
        help="dotted overrides like serve.port=8080 serve.max_batch=64",
    )
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])

    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.serve import build_server

    cfg = compose(args.config_name, args.overrides, args.config_path)
    server = build_server(cfg, expt_dir=args.expt_dir, device=args.device)
    host, port = server.server_address[:2]
    if server.fleet is not None:
        info = server.fleet.info()
        models = ", ".join(sorted(info["models"]))
        print(
            f"serving fleet of {len(info['models'])} models on {args.device} "
            f"(default={info['default_model']}, "
            f"resident<={info['max_resident_models']})\n"
            f"  models: {models}\n"
            f"  POST http://{host}:{port}/predict "
            f'{{"instances": ..., "model": "<id>"}}   '
            f"GET /healthz   GET /metrics",
            flush=True,
        )
    else:
        info = server.engine.info()
        print(
            f"serving {info['source']} on {info['device']}\n"
            f"  level={info['level']} density={info['density']} "
            f"backend={info['backend']} buckets={info['buckets']} "
            f"compiled={info['compiled_buckets']}\n"
            f"  POST http://{host}:{port}/predict   "
            f"GET /healthz   GET /metrics",
            flush=True,
        )

    def _on_sigterm(signum, frame):
        # shutdown() handshakes with the serve_forever loop running on THIS
        # (main) thread — calling it inline here would deadlock, so the
        # drain runs on its own thread while serve_forever unwinds below.
        print("\nSIGTERM: draining in-flight requests", flush=True)
        threading.Thread(
            target=server.graceful_shutdown,
            name="turboprune-drain",
            daemon=True,
        ).start()

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nshutting down", flush=True)
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
