#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (turboprune_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. build   compile the hand-written kernel of the served path from the
           source in this checkout.
2. kernels hold each kernel against its plain PyTorch version at the
           shapes the served path gives it, and time kernel, plain version,
           the nearest PyTorch library call and the card's bound.
3. slice   write a DeiT-Small/16 @ 224 experiment dir (seeded init; level
           1 magnitude-pruned to density 0.2), start the port's HTTP server
           on it, answer concurrent /predict requests, read /healthz and
           /metrics, check that every forward launched the flash kernel once
           per encoder block, and hold the served logits against the same
           checkpoint's forward with plain dense attention.

Prints the card (nvidia-smi name and power limit), a ``kernels`` JSON line,
and as the last line ``{"ok": true, "device": {...}}``. Needs one CUDA card;
without one it exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# H100 SXM data-sheet peaks (NVIDIA), dense, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

# Served shape of the flash kernel at the largest bucket: 128 images x 6
# heads, 197 tokens padded to 256, head_dim 64.
SERVED_BH, SERVED_SEQ, SERVED_VALID, HEAD_DIM = 128 * 6, 256, 197, 64
# Tolerances of kernel vs plain version. fp32: both accumulate in fp32, in
# other orders (tests/test_flash.py's 1e-5; measured 2.4e-7 on an H100).
# bf16: o is rounded to bf16 after fp32 sums taken in other orders, so the
# two may differ by an ulp of the element (a rounding flip); p is rounded to
# bf16 too, and where the two sides' fp32 p straddle a rounding boundary the
# flip moves o by up to ~2^-8 * p/l * |v| whatever o's own size. So the limit
# is 2 bf16 ulps of each element's magnitude, magnitudes below 0.1 (a typical
# |o| at these inputs) taken as 0.1: 9.8e-4 for |o| < 0.125, 7.8e-3 for
# |o| in [0.5, 1), 1.6e-2 for |o| in [1, 2). Measured on an H100 before this
# limit: max |o - plain| 1.95e-3 at max |o| 1.44.
FP32_TOL = 1e-5
BF16_ULPS = 2
BF16_MIN_MAG = 0.1
LSE_TOL = 1e-4
# Served bf16 logits vs the plain dense-attention bf16 forward of the same
# checkpoint: the two round scores and probabilities at different places
# (dense materialises bf16 scores and probabilities, flash keeps the scores
# in fp32), and the differences travel through 12 blocks. The first run on
# an H100 measured 0.027 at logits up to 3.8; 0.1 keeps ~4x of margin while
# staying far below a wrong attention (which moves logits by O(1)).
LOGIT_ATOL = 0.1
DEPTH = 12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# The one kernel of the served path, for the kernels line.
K1 = {
    "name": "flash_fwd",
    "route": "cuda",
    "source": "turboprune_tpu_torch/csrc/flash_fwd.cu",
    "replaces": "turboprune_tpu/ops/flash.py:65",
}


# ---------------------------------------------------------------- phase 1
def phase_build() -> None:
    from turboprune_tpu_torch.ops import build

    # The build is keyed by a hash of the source and flags, so what loads
    # is what this checkout's source compiles to.
    t0 = time.perf_counter()
    build.load("flash_fwd")
    log(f"build flash_fwd: {time.perf_counter() - t0:.2f} s (nvcc sm_90a) -> "
        f"{build.library_path('flash_fwd').name}")


# ---------------------------------------------------------------- phase 2
def _call_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` from an idle stream, the host's
    work in the call included: CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _stream_ms(fn, reps: int, rounds: int = 5, warmup: int = 3) -> float:
    """Time per call of ``fn`` with the stream kept full: ``reps`` calls
    back to back between one pair of CUDA events, median over ``rounds``.
    The host's work in each call overlaps the device's earlier calls, so
    this is device time while the host issues calls faster than the device
    runs them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _flash_inputs(bh, seq, n_valid, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (
        torch.randn(bh, seq, HEAD_DIM, device="cuda", generator=g).to(dtype)
        for _ in range(3)
    )
    valid = (torch.arange(seq, device="cuda") < n_valid).float()[None]
    return q, k, v, valid


def flash_bound_ms(bh, seq, n_valid, dtype_name) -> tuple[float, str]:
    """Least time for the function on these inputs, the larger of: the
    bytes that must move over HBM bandwidth (q, the valid rows of k and v
    and the validity row read once; o and lse written once: a masked key's
    p is exactly 0, so its k and v rows need not be read) and the
    operations the valid keys need (QK^T and PV) over the peak rate."""
    esize = 4 if dtype_name == "float32" else 2
    nbytes = (2 * bh * seq + 2 * bh * n_valid) * HEAD_DIM * esize + bh * seq * 4 + seq * 4
    flops = 4.0 * bh * seq * n_valid * HEAD_DIM
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_tol(dt: str, ref):
    """The limit on |o - plain|: FP32_TOL in fp32; in bf16, per element,
    BF16_ULPS ulps of max(|o|, BF16_MIN_MAG)."""
    import torch

    if dt == "float32":
        return torch.full_like(ref, FP32_TOL, dtype=torch.float32)
    # frexp: |x| = m * 2^e with m in [0.5, 1); bf16 keeps 8 significant
    # bits, so its ulp there is 2^(e-8).
    _, e = torch.frexp(ref.float().abs().clamp_min(BF16_MIN_MAG))
    return BF16_ULPS * torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from turboprune_tpu_torch.ops.flash import flash_attention_plain, flash_fwd_cuda

    cases = [
        ("float32", SERVED_BH, SERVED_SEQ, SERVED_VALID),
        ("bfloat16", SERVED_BH, SERVED_SEQ, SERVED_VALID),
        ("float32", 6, 384, 301),  # small, ragged: the last key tile is partial
        ("bfloat16", 6, 384, 301),
    ]
    worst = {}
    with torch.no_grad():
        for i, (dt, bh, seq, nv) in enumerate(cases):
            q, k, v, valid = _flash_inputs(bh, seq, nv, getattr(torch, dt), seed=i)
            o, lse = flash_fwd_cuda(q, k, v, valid, 1.0 / 8.0)
            ro, rlse = flash_attention_plain(q, k, v, valid, 1.0 / 8.0)
            torch.cuda.synchronize()
            diff = (o.float() - ro.float()).abs()
            err_o = diff.max().item()
            share = (diff / _kernel_tol(dt, ro)).max().item()
            err_l = (lse - rlse).abs().max().item()
            finite = bool(torch.isfinite(o.float()).all())
            log(f"kernel flash_fwd {dt} [{bh},{seq},{HEAD_DIM}] valid={nv}: "
                f"max|o-plain|={err_o:.3e} (max|o| {ro.float().abs().max().item():.4f}; "
                f"worst element at {share:.3f} of its limit: "
                + ("1e-5" if dt == "float32"
                   else f"{BF16_ULPS} bf16 ulps of max(|o|, {BF16_MIN_MAG:g})")
                + f") max|lse-plain|={err_l:.3e} (tol {LSE_TOL:g}) finite={finite}")
            if not (finite and share <= 1.0 and err_l <= LSE_TOL):
                raise AssertionError(f"flash_fwd disagrees with its plain version ({dt})")
            if (bh, seq) == (SERVED_BH, SERVED_SEQ):
                worst[dt] = err_o

        # Timing at the served shape in the served dtype (bf16).
        q, k, v, valid = _flash_inputs(SERVED_BH, SERVED_SEQ, SERVED_VALID, torch.bfloat16, 9)
        scale = 1.0 / 8.0
        mask = (valid[0] > 0)[None, None, :]  # [1, 1, S] -> (N, L, S)

        def kernel():
            return flash_fwd_cuda(q, k, v, valid, scale)

        def plain():
            return flash_attention_plain(q, k, v, valid, scale)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

        ms = _stream_ms(kernel, reps=50)
        plain_ms = _stream_ms(plain, reps=10)
        library_ms = _stream_ms(library, reps=50)
        call_ms = _call_ms(kernel, reps=50)
        _, prof_ms, _ = _device_busy_ms(kernel, reps=20)
        lib_err = (library().float() - kernel()[0].float()).abs().max().item()
    bound_ms, bound_by = flash_bound_ms(SERVED_BH, SERVED_SEQ, SERVED_VALID, "bfloat16")
    log(f"time flash_fwd bf16 [{SERVED_BH},{SERVED_SEQ},{HEAD_DIM}] valid={SERVED_VALID}: "
        f"kernel {ms:.4f} ms per launch (50 back to back, median of 5 rounds; "
        f"torch.profiler kernel time {prof_ms:.4f} ms; one call from an idle "
        f"stream, host work included, {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {library_ms:.4f} ms (|sdpa-kernel| {lib_err:.2e}), "
        f"bound {bound_ms:.4f} ms by {bound_by} "
        f"({bound_ms / ms * 100:.1f}% of bound)")
    return {
        "max_abs_err": worst["bfloat16"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------- phase 3
def write_experiment(expt_dir: Path, seed: int = 0) -> dict:
    """DeiT-Small/16 @ 224 (full published width, 12 blocks), seeded init:
    level 0 with all-ones masks, level 1 with global magnitude masks at
    density 0.2."""
    import torch

    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.models import create_model
    from turboprune_tpu_torch.ops import masking
    from turboprune_tpu_torch.utils import ExperimentCheckpoints, save_config

    cfg = compose(
        "imagenet_er_balanced",
        ["model_params=mp_deit_small", "model_params.attention_impl=flash"],
    )
    dp = cfg.dataset_params
    assert (dp.image_size, dp.num_classes) == (224, 1000), dp
    assert cfg.experiment_params.training_precision == "bfloat16"
    save_config(expt_dir, cfg)
    model = create_model(
        cfg.model_params.model_name, dp.num_classes, dp.dataset_name,
        image_size=dp.image_size,
    )
    model.init_weights(torch.Generator().manual_seed(seed))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ones = masking.make_masks(model)
    scores = {p: state[masking.state_key(p)].abs() * m for p, m in ones.items()}
    pruned = masking.global_threshold_mask(scores, ones, 0.2)
    ckpts = ExperimentCheckpoints(expt_dir)
    ckpts.save_level(0, {"params": state, "masks": ones, "batch_stats": {}})
    ckpts.save_level(1, {"params": state, "masks": pruned, "batch_stats": {}})
    n_params = sum(v.numel() for v in state.values())
    density = masking.overall_density(pruned)
    log(f"experiment: {cfg.model_params.model_name} {n_params} params, "
        f"attention_impl=flash, level 1 density {density:.6f}")
    if abs(density - 0.2) > 1e-4:
        raise AssertionError(f"level 1 density {density} is not 0.2")
    return {"state": state, "masks": pruned, "cfg": cfg}


def _post(url: str, body: bytes) -> tuple[int, dict, float]:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        out = json.loads(resp.read())
        return resp.status, out, (time.perf_counter() - t0) * 1e3


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=60) as resp:
        if resp.status != 200:
            raise AssertionError(f"GET {url} -> {resp.status}")
        return resp.read().decode()


def _device_busy_ms(fn, reps: int = 3) -> tuple[float, float, list]:
    """Sum of device kernel time per call of ``fn`` from torch.profiler,
    the part spent in the flash kernel, and the five kernels that took the
    most device time as (name, ms per call). Zeros when the profiler
    records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = k1 = 0.0
    by_kernel = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += t
            by_kernel.append((e.key[:60], t / reps / 1e3))
            if "flash_fwd_kernel" in e.key:
                k1 += t
    top = sorted(by_kernel, key=lambda kv: -kv[1])[:5]
    return total / reps / 1e3, k1 / reps / 1e3, top


def phase_slice() -> dict:
    import torch

    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.models import create_model
    from turboprune_tpu_torch.ops import masking
    from turboprune_tpu_torch.ops.flash import flash_fwd_cuda
    from turboprune_tpu_torch.serve import build_server

    rng = np.random.default_rng(0)
    sizes = (1, 5, 40)
    requests = [rng.normal(size=(n, 224, 224, 3)).astype(np.float32) for n in sizes]
    bodies = [json.dumps({"instances": x.tolist()}).encode() for x in requests]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_expt_") as tmp:
        expt = write_experiment(Path(tmp))
        serve_cfg = compose("serve", ["serve.port=0"])
        assert serve_cfg.serve.batch_buckets == [1, 8, 32, 128]

        # ---- the main path, with the kernel's count at 0 just before it
        flash_fwd_cuda.launches = 0
        t0 = time.perf_counter()
        server = build_server(serve_cfg, expt_dir=tmp, device="cuda")
        startup_s = time.perf_counter() - t0
        try:
            server.start_background()
            base = f"http://127.0.0.1:{server.port}"
            with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
                results = list(pool.map(lambda b: _post(f"{base}/predict", b), bodies))
            health = json.loads(_get(f"{base}/healthz"))
            metrics_text = _get(f"{base}/metrics")
        finally:
            drain = server.graceful_shutdown(drain_timeout_s=30)
        launches = flash_fwd_cuda.launches
        # ---- end of the main path
        engine = server.engine
        m = engine.metrics
        forwards = int(m.counter("bucket_first_runs_total") + m.counter("bucket_warm_runs_total"))
        log(f"serve: startup (load + warmup of {list(engine.buckets)}) {startup_s:.2f} s; "
            f"forwards {forwards}; launches {launches}; drain {drain}")
        for (code, body, ms), n in zip(results, sizes):
            log(f"request of {n} images: HTTP {code}, {ms:.1f} ms client-side "
                f"(JSON encode/decode included)")
            if code != 200:
                raise AssertionError(f"/predict of {n} images -> {code}")
        log(f"metrics: p50 {m.latency_quantile_ms(0.5):.2f} ms, p99 "
            f"{m.latency_quantile_ms(0.99):.2f} ms (batcher submit -> result), "
            f"batches {int(m.counter('batches_total'))}, images {int(m.counter('images_total'))}")
        if health.get("status") != "ok" or health.get("level") != 1:
            raise AssertionError(f"/healthz: {health}")
        if "turboprune_serve_requests_total 3" not in metrics_text:
            raise AssertionError("/metrics does not count the 3 requests")
        if not drain["drained"]:
            raise AssertionError(f"drain left requests unanswered: {drain}")
        if launches == 0:
            raise AssertionError("flash_fwd never launched on the main path")
        if launches != DEPTH * forwards:
            raise AssertionError(
                f"flash_fwd launched {launches} times for {forwards} "
                f"forwards; expected {DEPTH} per forward"
            )

        # ---- the served logits against plain dense attention, same weights
        served = [np.asarray(body["logits"], np.float32) for _, body, _ in results]
        for logits, n in zip(served, sizes):
            if logits.shape != (n, 1000) or not np.isfinite(logits).all():
                raise AssertionError(f"served logits {logits.shape} not finite [n, 1000]")
        dense = create_model(
            "deit_small_patch16_224", 1000, "ImageNet",
            compute_dtype=torch.bfloat16, attention_impl="dense", image_size=224,
        )
        dense.load_state_dict(masking.apply_masks(expt["state"], expt["masks"]))
        dense = dense.cuda().eval()
        with torch.inference_mode():
            ref = [dense(torch.from_numpy(x).cuda()).float().cpu().numpy() for x in requests]
        err = max(float(np.abs(a - b).max()) for a, b in zip(served, ref))
        scale = max(float(np.abs(b).max()) for b in ref)
        ref_all, got_all = np.concatenate(ref), np.concatenate(served)
        top2 = np.sort(ref_all, axis=1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_ATOL
        agree = np.argmax(got_all, 1) == np.argmax(ref_all, 1)
        log(f"served vs dense-attention bf16 logits: max abs diff {err:.4f} "
            f"(tol {LOGIT_ATOL}, max |logit| {scale:.3f}); top-1 agrees on "
            f"{int(agree.sum())}/{len(agree)} rows, {int(decided.sum())} rows with a "
            f"top-2 margin > 2*tol all agree: {bool(agree[decided].all())}")
        if err > LOGIT_ATOL or not agree[decided].all():
            raise AssertionError("served logits disagree with the dense-attention forward")

        # ---- per-bucket forward time (outside the counted main path)
        per_bucket = {}
        for b in engine.buckets:
            x = rng.normal(size=(b, 224, 224, 3)).astype(np.float32)
            xt = torch.from_numpy(x).cuda()
            with torch.inference_mode():
                flash_ms = _call_ms(lambda: engine.model(xt), reps=10)
                dense_ms = _call_ms(lambda: dense(xt), reps=10)
            t_pred = []
            for _ in range(5):
                t1 = time.perf_counter()
                engine.predict(x)
                t_pred.append((time.perf_counter() - t1) * 1e3)
            busy_ms, k1_ms, top = _device_busy_ms(lambda: engine.model(xt))
            per_bucket[b] = (flash_ms, dense_ms, statistics.median(t_pred))
            log(f"bucket {b}: served forward {flash_ms:.3f} ms (CUDA events around "
                f"one call, host work included; dense-attention forward "
                f"{dense_ms:.3f} ms); engine.predict "
                f"{statistics.median(t_pred):.3f} ms host-side incl. copies; "
                + (f"device busy {busy_ms:.3f} ms per forward (idle "
                   f"{max(0.0, 1 - busy_ms / flash_ms) * 100:.1f}%), flash_fwd "
                   f"kernels {k1_ms:.3f} ms of it ({k1_ms / DEPTH:.4f} ms per "
                   f"launch)" if busy_ms else
                   "device busy time not measured (the profiler saw no device activity)"))
            if top:
                log(f"bucket {b} top device kernels (ms per forward): "
                    + "; ".join(f"{name} {ms:.3f}" for name, ms in top))
    return {"launches": launches, "per_bucket": per_bucket}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    phase_build()
    timing = phase_kernels()
    slice_out = phase_slice()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s on {card}")
    row = {
        **K1,
        "launches": slice_out["launches"],
        **{key: timing[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
