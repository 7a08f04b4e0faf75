#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (turboprune_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. build    compile every hand-written kernel (csrc/flash_fwd.cu: K1,
            csrc/flash_bwd.cu: K2 and K3) from the sources in this checkout,
            one nvcc per source, started together, and print ptxas's
            registers and spills per kernel.
2. kernels  hold each kernel against its plain PyTorch version at the
            shapes its main path gives it (K1: the served and the training
            forward; K2/K3: the training backward, fed K1's o and lse) and
            at a small ragged shape (K1 also on a validity row with holes
            and a dead key block, and on one with no valid key), print K1's
            blocks per SM, and time
            kernel, plain version, the nearest PyTorch library calls
            (scaled_dot_product_attention with a boolean mask, and its
            flash backend on the valid tokens alone) and the card's bound;
            K1 at the served and at the training shape.
3. slice    write a DeiT-Small/16 @ 224 experiment dir (seeded init; level
            1 magnitude-pruned to density 0.2), start the port's HTTP server
            on it, answer concurrent /predict requests, read /healthz and
            /metrics, check that every forward launched the flash kernel
            once per encoder block, and hold the served logits against the
            same checkpoint's forward with plain dense attention.
4. train    run_experiment_torch's main: two IMP levels (density 1.0, then
            0.8 by global magnitude with a rewind to model_init) of a
            DeiT-Small/16 @ 224 with flash attention at batch 256 in bf16 on
            synthetic data; check the levels, densities, monotone masks,
            finite losses and that K1 ran in every forward and K2/K3 in
            every backward; hold one step's parameter gradients against the
            dense-attention model's autograd (fp32 small batch, bf16 batch
            256), and show on the same batch that bf16 flash's large
            per-tensor distances are drow's residue (they vanish with drow
            from the unrounded o; flash_backward_plain reproduces them);
            time a step and read its device time with the profiler.
5. resnet   conf/cifar10_imp.yaml as shipped (ResNet-18, CIFAR stem, bf16,
            batch 512) at CIFAR-10's sizes on synthetic data, one epoch a
            level: two IMP levels through run_experiment_torch's main (the
            densities, monotone masks, the rewind of params and BatchNorm
            statistics to model_init bit for bit, evaluations on the
            running statistics, no K1/K2/K3 launch); cifar10_er_erk and
            cifar10_er_snip pruned at init to density 0.1; one fp32 train
            step on the card against the CPU with TF32 off; the bf16 step's
            time, device busy share, top kernels and FLOP bound; the trained
            level 1 served and held against the eval forward.
6. resume   conf/cifar10_imp.yaml as shipped, 3 epochs of 4 steps a level,
            the mid-level slot saved every epoch, through
            run_experiment_torch's main: two uninterrupted runs (a, a'),
            a run preempted right after its level-1, epoch-0 slot save
            (its header and config hash checked), and its resume: the
            restored state equal to the saved one bit for bit (params,
            BatchNorm statistics, masks, momentum, step, loader epoch), the
            end state equal to run a's (or within twice a' - a where cuDNN
            is not deterministic run to run), every epoch in the level CSV,
            no slot left; the slot's bytes, save and restore times.
7. cyclic   run_cyclic_training_experiment_torch's main on DeiT-Small/16 @
            224 with flash attention, 4 cycles a level (ct_constant_4), two
            levels: the cycle column, each cycle's per-step lr equal to a
            fresh schedule from step 0, finite losses, densities 1.0 / 0.8,
            model_init saved before the first step, and K1/K2/K3 launched
            12 times per forward / backward.
8. compile  model_params.use_compile=true (the masked forward, loss and
            metric sums under torch.compile(fullgraph=True), inductor with
            CUDA graphs; K1-K3 as torch.library custom ops inside them):
            cifar10_imp as the resnet phase runs it, with its checks plus no
            recompile at level 1, no CUDA-graph skip and no K1-K3 launch;
            compile seconds, img/s, the step's time, device busy share and
            time by kind beside the eager numbers; one bf16 step's gradient
            against eager's (both against fp32) and one fp32 step beside the
            CPU and float64; then the train phase's DeiT with flash,
            compiled: K1/K2/K3 counted by the profiler (12 per forward /
            backward over the run, and per replayed step), the step's time
            and device work against eager, one bf16 step's gradient against
            eager's.

9. imagenet conf/imagenet_imp_tpk.yaml (ResNet-50 at 224, 1000 classes, bf16)
            fed by the native .tpk loader through the prefetch engine
            (runs between cyclic and compile): build the reader
            (csrc/tpkdata.cpp, g++) and print what the machine offers it
            (jpeglib.h, libjpeg, Pillow, grain, cores, disk); measure the
            peak memory at batch 64 and 128 and take the largest of 512,
            256, 128 that fits; pack .tpk files from seeded JPEGs (raw
            samples where the reader has no JPEG decoder, said on its own
            line); the host's decode rate at 224; one device batch against
            the reader's CPU read of its indices (uint8 bit for bit,
            normalised within 1e-6); two IMP levels of 8 steps through
            run_experiment_torch's main (densities, rewind, finite losses,
            no K1/K2/K3 launch); the same batches with scan_chunk_steps 8
            and 1 (device hashes); per epoch the fed img/s beside
            synthetic data's, the pipeline's waits, H2D per batch, the idle
            share and the peak memory; the step's time by kind.
10. imagenet_folder  conf/imagenet_imp.yaml and imagenet_er_balanced.yaml as
            shipped (dataloader_type grain: Pillow decode in 16 forked
            DataLoader workers, grain's order; runs after imagenet) from an
            ImageFolder of the imagenet phase's JPEGs symlinked over 1000
            class directories: the host decode rate at 224 by worker count
            and the workers' start-up (fork, and forkserver beside it); a
            device batch against the port's CPU decode of the same stream
            positions; two IMP levels of 8 steps at the imagenet phase's
            batch (densities, rewind, finite losses, no K1/K2/K3 launch) and
            per epoch the fed img/s beside that phase's synthetic img/s, the
            waits and the idle share; imagenet_er_balanced at its density;
            tier 1 of the mid-level slot (a preempted run resumed on the
            uninterrupted run's batches, device hashes); model_params=mp_vgg16
            and mp_densenet121 at the batch their measured peak memory allows:
            two levels of 4 steps, the step's time, busy time by kind, FLOP
            bound and peak memory.

Prints the card (nvidia-smi name and power limit), a ``kernels`` JSON line,
and as the last line ``{"ok": true, "device": {...}}``. Needs one CUDA card;
without one it exits non-zero.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# H100 SXM data-sheet peaks (NVIDIA), dense, at the 700 W limit. fp32 is the
# CUDA cores' rate (no TF32); 16-bit is the tensor cores'.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

# Served shape of the flash kernel at the largest bucket: 128 images x 6
# heads, 197 tokens padded to 256, head_dim 64.
SERVED_BH, SERVED_SEQ, SERVED_VALID, HEAD_DIM = 128 * 6, 256, 197, 64
HEADS = 6
# Tolerances of kernel vs plain version. fp32: both accumulate in fp32, in
# other orders (tests/test_flash.py's 1e-5; measured 2.4e-7 on an H100).
# bf16: o is rounded to bf16 after fp32 sums taken in other orders, so the
# two may differ by an ulp of the element (a rounding flip); p is rounded to
# bf16 too, and where the two sides' fp32 p straddle a rounding boundary the
# flip moves o by up to ~2^-8 * p/l * |v| whatever o's own size. So the limit
# is 2 bf16 ulps of each element's magnitude, magnitudes below 0.1 (a typical
# |o| at these inputs) taken as 0.1: 9.8e-4 for |o| < 0.125, 7.8e-3 for
# |o| in [0.5, 1), 1.6e-2 for |o| in [1, 2). Measured on an H100 before this
# limit: max |o - plain| 1.95e-3 at max |o| 1.44 (served shape); at the
# training shape, twice the elements, the worst element differs by exactly
# 2 ulps (3.9e-3 at |o| in [0.25, 0.5)), at the limit.
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

# Training shape of the backward kernels: 256 images x 6 heads, 197 tokens
# padded to 256, head_dim 64.
TRAIN_BH = 256 * 6
# Tolerances of K2/K3 vs their plain versions. Both sides get the same
# inputs, lse and drow and keep p and ds in fp32; they differ in the order
# of fp32 sums and, for 16-bit inputs, in the kernels' split of p and ds
# into 16-bit hi + lo terms for the tensor cores (each kept to 2^-16 of its
# value in bf16; tests/test_torch_flash_split.py holds the emulated split
# within 2^-15 of each gradient's norm), ~1e-6 relative at most. fp32:
# 1e-5 absolute (K1's limit). bf16: each gradient is rounded once to bf16,
# so the two may differ by a rounding flip: 2 bf16 ulps of max(|g|, 1e-3),
# the floor keeping the limit above the fp32 noise where |g| is tiny.
BWD_FP32_TOL = 1e-5
BWD_BF16_MIN_MAG = 1e-3

# The train phase: DeiT-Small/16 @ 224 at the DeiT recipe's 256 images per
# GPU, composed from conf/; only the data is cut (synthetic, 1 epoch/level).
TRAIN_OVERRIDES = [
    "model_params=mp_deit_small",
    "model_params.attention_impl=flash",
    "dataset_params.dataloader_type=synthetic",
    "dataset_params.total_batch_size=256",
    "dataset_params.synthetic_num_train=1024",
    "dataset_params.synthetic_num_test=512",
    "experiment_params.epochs_per_level=1",
    "pruning_params.target_sparsity=0.2",
]
TRAIN_STEPS = 2 * (1024 // 256)       # two levels of one epoch
EVAL_BATCHES = 2 * (512 // 256)
# One train step's parameter gradients, flash (K1/K2/K3) vs the plain
# dense-attention autograd, same weights, masks and batch. fp32 at batch 8:
# per tensor ||g_flash - g_dense|| / ||g_dense|| <= 1e-3. The two differ
# only in summation order and softmax arithmetic (~1e-7 per value), but the
# query and key projections' gradients partly cancel across tokens
# (sum_tokens dK = 0: the softmax is invariant to a shift shared by a row's
# scores), which amplifies that noise relative to their norm (a run on an
# H100: median 5.5e-7, worst 1.9e-4 at block9.attn.query.weight); a wrong
# backward moves them by O(1). The key biases' exact gradient is zero,
# so both sides hold rounding noise there: flash's is checked to stay below
# 1e-2 of its block's query-bias gradient instead. bf16 at batch 256: each
# gradient is held against the fp32 dense-attention gradient of the same
# batch, since a ratio between two bf16 paths that round at different
# places says little. Flash computes drow from the bf16-rounded o, as the
# TPU kernels do (and FlashAttention-2), so each row of ds sums to
# scale * dO . (P V - o), a residue of o's rounding that is systematic along
# the row: dq picks it up times the row's mean key. Where the keys share a
# large common part (the deep blocks of a randomly initialised ViT, whose
# tokens are nearly alike) that residue dominates the small query and key
# projection gradients: the first run on an H100 measured flash 1.78 (dense
# bf16 0.14) of the fp32 gradient's norm at block11.attn.query.weight, and
# the key biases (exact gradient zero) at up to 0.99 of their block's
# query-bias gradient, while K2/K3 agree with their plain versions to a
# bf16 ulp. Per-tensor ratios there measure that residue, not the kernels.
# So the limits on the step's own gradient are on the whole gradient and on
# the typical tensor: ||G_flash - G_fp32|| over all parameters <= 2 x dense
# bf16's + 1e-3 x ||G_fp32||, and the median over tensors of
# ||g - g_fp32|| / ||g_fp32|| at most twice dense bf16's (a wrong backward
# kernel moves the attention gradients, and through the residual stream
# every earlier block's, by O(1)). The worst tensors are reported.
# The cause is then shown on the same weights and batch, and the per-tensor
# limit applied where the residue is gone: with drow from the unrounded
# attention output (K1, K2, K3 unchanged) every tensor but the key biases
# is within 0.25 of its fp32 gradient's norm (dense bf16 reaches 0.18 at
# block11.attn.query.bias from the rounding of its inputs; an H100 run
# measured 0.059) and the key biases within 0.1 of their block's query bias
# (measured 0.011); and flash_backward_plain, the TPU recurrence, fed the
# same bf16 o reproduces block 11's distances to 5% (measured exactly) with
# a median per-tensor distance from the K2/K3 gradient <= 1e-2 (measured
# 1.7e-3: the two round dq, dk, dv to bf16 with a flip here and there).
GRAD_FP32_BATCH = 8
GRAD_FP32_TOL = 1e-3
KEY_BIAS_RATIO = 1e-2
GRAD_BF16_FACTOR = 2.0
GRAD_BF16_FLOOR = 1e-3
GRAD_BF16_TENSOR_TOL = 0.25
GRAD_BF16_KEY_BIAS = 0.1
GRAD_BF16_REPRO = 0.05
GRAD_BF16_PLAIN_MEDIAN = 1e-2
# The tensors where a run on an H100 saw the bf16 residue largest.
RESIDUE_TENSORS = ("block11.attn.query.weight", "block11.attn.key.weight")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# The kernels of the served and trained paths, for the kernels line.
K1 = {
    "name": "flash_fwd",
    "route": "cuda",
    "source": "turboprune_tpu_torch/csrc/flash_fwd.cu",
    "replaces": "turboprune_tpu/ops/flash.py:65",
}
K2 = {
    "name": "flash_bwd_dq",
    "route": "cuda",
    "source": "turboprune_tpu_torch/csrc/flash_bwd.cu",
    "replaces": "turboprune_tpu/ops/flash.py:128",
}
K3 = {
    "name": "flash_bwd_dkv",
    "route": "cuda",
    "source": "turboprune_tpu_torch/csrc/flash_bwd.cu",
    "replaces": "turboprune_tpu/ops/flash.py:152",
}
SOURCES = ("flash_fwd", "flash_bwd")


# ---------------------------------------------------------------- phase 1
def phase_build() -> None:
    from turboprune_tpu_torch.ops import build

    # Each build is keyed by a hash of its source, the shared headers and
    # the flags, so what loads is what this checkout's sources compile to.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        list(pool.map(build.build, SOURCES))
    for name in SOURCES:
        build.load(name)
        log(f"build {name}: -> {build.library_path(name).name}")
        for k in build.ptxas_report(name):
            stores, loads = k["spill"] or (None, None)
            log(f"ptxas {name} {k['kernel']}: {k['registers']} registers, "
                f"spill stores {stores} B, spill loads {loads} B")
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, {len(SOURCES)} "
        "sources in parallel)")


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


def _validity_row(seq, n_valid):
    """The key-validity row [1, seq]: the first ``n_valid`` keys, or a named
    row that reaches K1's skipping of dead keys: "holes" (every fifth key
    invalid, a dead 16-key group inside the first 128-key block, a second
    block with no valid key, the last block valid up to key 349) or "none"
    (no valid key: o = 0 and the TPU's lse = -1e30)."""
    import torch

    keys = torch.arange(seq, device="cuda")
    if n_valid == "holes":
        keep = ((keys % 5 != 2) & ~((keys >= 32) & (keys < 48))
                & ~((keys >= 128) & (keys < 256)) & (keys < 350))
    elif n_valid == "none":
        keep = torch.zeros(seq, dtype=torch.bool, device="cuda")
    else:
        keep = keys < n_valid
    return keep.float()[None]


def _flash_inputs(bh, seq, n_valid, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (
        torch.randn(bh, seq, HEAD_DIM, device="cuda", generator=g).to(dtype)
        for _ in range(3)
    )
    return q, k, v, _validity_row(seq, n_valid)


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


def _sdpa_flash_ms(q, k, v, n_valid, scale, do=None) -> dict:
    """A time yardstick only: scaled_dot_product_attention restricted to its
    flash backend, on the valid tokens alone ([b, heads, n_valid, D], no
    mask; padded rows are not computed, so its output is not the kernels'
    function). Device time of the forward ("fwd") and, given the upstream
    gradient ``do``, of the backward from a retained graph ("bwd"); None
    where the backend refuses these inputs, with the reason in "why"."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def valid_rows(t):
        return t.reshape(-1, HEADS, t.shape[1], HEAD_DIM)[:, :, :n_valid].contiguous()

    ql, kl, vl = (valid_rows(t).detach() for t in (q, k, v))
    out = {"fwd": None, "bwd": None, "why": ""}
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION), torch.no_grad():
            out["fwd"] = _stream_ms(
                lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale), reps=50)
        if do is not None:
            ql, kl, vl = (t.requires_grad_() for t in (ql, kl, vl))
            dol = valid_rows(do)
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION), torch.enable_grad():
                o = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
                out["bwd"] = _stream_ms(
                    lambda: torch.autograd.grad(o, (ql, kl, vl), dol, retain_graph=True),
                    reps=20)
    except RuntimeError as e:  # no flash kernel for these inputs on this build
        out["why"] = str(e).splitlines()[0][:200]
    return out


def _flash_yardstick(times: dict, which: str) -> str:
    """The log text of one _sdpa_flash_ms time ("fwd" or "bwd")."""
    label = ("forward" if which == "fwd" else "backward (dq, dk, dv)")
    if times[which] is None:
        return (f"SDPA flash backend {label} on the valid tokens not measured "
                f"({times['why'] or 'not asked'})")
    return (f"SDPA flash backend {label} on the valid tokens, no mask, "
            f"{times[which]:.4f} ms")


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

    from turboprune_tpu_torch.ops import flash
    from turboprune_tpu_torch.ops.flash import flash_attention_plain, flash_fwd_cuda

    for dt in ("bfloat16", "float16", "float32"):
        n = flash.flash_fwd_blocks_per_sm(getattr(torch, dt), torch.device("cuda"))
        log(f"occupancy flash_fwd {dt}: {n} blocks of 4 warps per SM ({4 * n} warps)")
    main_shapes = ((SERVED_BH, SERVED_SEQ), (TRAIN_BH, SERVED_SEQ))
    cases = [
        ("float32", SERVED_BH, SERVED_SEQ, SERVED_VALID),
        ("bfloat16", SERVED_BH, SERVED_SEQ, SERVED_VALID),
        ("float32", TRAIN_BH, SERVED_SEQ, SERVED_VALID),  # the training forward
        ("bfloat16", TRAIN_BH, SERVED_SEQ, SERVED_VALID),
        ("float32", 6, 384, 301),  # small, ragged: the last key tile is partial
        ("bfloat16", 6, 384, 301),
        ("float32", 96, 384, "holes"),  # dead groups and a dead key block
        ("bfloat16", 96, 384, "holes"),
        ("bfloat16", 96, 256, "none"),  # no valid key at all
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
            if nv == "none" and (o.any() or not bool((lse == flash.NEG_BIG).all())):
                raise AssertionError("flash_fwd with no valid key: o must be 0, lse -1e30")
            if (bh, seq) in main_shapes:
                worst[dt] = max(worst.get(dt, 0.0), err_o)

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
        prof_ms = _device_busy_ms(kernel, reps=20)[1]["flash_fwd_kernel"]
        lib_err = (library().float() - kernel()[0].float()).abs().max().item()
        sdpa_flash = _sdpa_flash_ms(q, k, v, SERVED_VALID, scale)

        # K1 at the training shape, where most of its launches are.
        tq, tk, tv, tvalid = _flash_inputs(TRAIN_BH, SERVED_SEQ, SERVED_VALID, torch.bfloat16, 8)
        tmask = (tvalid[0] > 0)[None, None, :]
        train_ms = _stream_ms(lambda: flash_fwd_cuda(tq, tk, tv, tvalid, scale), reps=20)
        train_lib_ms = _stream_ms(
            lambda: F.scaled_dot_product_attention(tq, tk, tv, attn_mask=tmask, scale=scale),
            reps=20)
        train_flash = _sdpa_flash_ms(tq, tk, tv, SERVED_VALID, scale)
        del tq, tk, tv
    bound_ms, bound_by = flash_bound_ms(SERVED_BH, SERVED_SEQ, SERVED_VALID, "bfloat16")
    log(f"time flash_fwd bf16 [{SERVED_BH},{SERVED_SEQ},{HEAD_DIM}] valid={SERVED_VALID}: "
        f"kernel {ms:.4f} ms per launch (50 back to back, median of 5 rounds; "
        f"torch.profiler kernel time {prof_ms:.4f} ms; one call from an idle "
        f"stream, host work included, {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {library_ms:.4f} ms (|sdpa-kernel| {lib_err:.2e}), "
        f"{_flash_yardstick(sdpa_flash, 'fwd')}, "
        f"bound {bound_ms:.4f} ms by {bound_by} "
        f"({bound_ms / ms * 100:.1f}% of bound)")
    t_bound, t_by = flash_bound_ms(TRAIN_BH, SERVED_SEQ, SERVED_VALID, "bfloat16")
    log(f"time flash_fwd bf16 [{TRAIN_BH},{SERVED_SEQ},{HEAD_DIM}] valid={SERVED_VALID} "
        f"(the training forward): kernel {train_ms:.4f} ms per launch (20 back to back, "
        f"median of 5 rounds), scaled_dot_product_attention {train_lib_ms:.4f} ms, "
        f"{_flash_yardstick(train_flash, 'fwd')}, bound {t_bound:.4f} ms by {t_by} "
        f"({t_bound / train_ms * 100:.1f}% of bound)")
    return {
        "max_abs_err": worst["bfloat16"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library_flash_ms": sdpa_flash["fwd"],
    }


def bwd_bound_ms(kernel: str, bh, seq, n_valid, dtype_name,
                 split: bool = False) -> tuple[float, str, str]:
    """Least time for K2 ("dq") or K3 ("dkv") on these inputs, the larger
    of: the bytes that must move over HBM bandwidth (q and dO, the valid
    rows of k and v, lse, drow and the validity row read once; dq, or dk
    and dv, written once: a masked key's p and ds are exactly 0) and the
    operations the valid keys need over the peak rate of their type.
    s = q k^T and dp = dO v^T take 16-bit operands on the tensor cores
    (fp32 CUDA cores for fp32 inputs). The products with an fp32 operand
    (p or ds; one for K2, ds k; two for K3, p^T dO and ds^T q) run, as this
    design runs them, on the fp32 CUDA cores; with ``split`` (16-bit inputs
    only) each runs instead as two tensor-core products, p or ds split into
    bf16 hi + lo terms: the card's bound for a design that keeps p and ds
    near fp32. Returns (ms, bound_by, precision note)."""
    esize = 4 if dtype_name == "float32" else 2
    rows = bh * seq * HEAD_DIM * esize
    reads = 2 * rows + 2 * bh * n_valid * HEAD_DIM * esize + 2 * bh * seq * 4 + seq * 4
    writes = rows if kernel == "dq" else 2 * rows
    product = 2.0 * bh * seq * n_valid * HEAD_DIM
    fp32_products = 1 if kernel == "dq" else 2
    t_bytes = (reads + writes) / HBM_BYTES_PER_S * 1e3
    if split:
        t_ops = (2 + 2 * fp32_products) * product / PEAK_FLOPS[dtype_name] * 1e3
        note = (f"{2 + 2 * fp32_products} products at "
                f"{PEAK_FLOPS[dtype_name] / 1e12:g} TFLOP/s, fp32 operands split hi + lo")
    else:
        t_ops = (2 * product / PEAK_FLOPS[dtype_name]
                 + fp32_products * product / PEAK_FLOPS["float32"]) * 1e3
        note = (f"2 products at {PEAK_FLOPS[dtype_name] / 1e12:g} TFLOP/s + "
                f"{fp32_products} fp32-operand at {PEAK_FLOPS['float32'] / 1e12:g}")
    if t_bytes >= t_ops:
        return t_bytes, "bytes", note
    return t_ops, "operations", note


def _bwd_tol(dt: str, ref):
    """The limit on |g - plain| for K2/K3 (see BWD_* above)."""
    import torch

    if dt == "float32":
        return torch.full_like(ref, BWD_FP32_TOL, dtype=torch.float32)
    _, e = torch.frexp(ref.float().abs().clamp_min(BWD_BF16_MIN_MAG))
    return BF16_ULPS * torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)


def _bwd_inputs(bh, seq, n_valid, dtype, seed):
    """q, k, v, the validity row, dO, and the forward's o and lse from K1,
    as the training path hands them to K2/K3 (K1 is held against its plain
    version at these shapes in phase 2; kernel and plain backward read the
    same o and lse)."""
    import torch

    from turboprune_tpu_torch.ops.flash import flash_fwd_cuda

    q, k, v, valid = _flash_inputs(bh, seq, n_valid, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    do = torch.randn(bh, seq, HEAD_DIM, device="cuda", generator=g).to(dtype)
    o, lse = flash_fwd_cuda(q, k, v, valid, 1.0 / 8.0)
    return q, k, v, valid, do, o, lse


def phase_backward_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from turboprune_tpu_torch.ops import flash

    scale = 1.0 / 8.0
    cases = [
        ("float32", TRAIN_BH, SERVED_SEQ, SERVED_VALID),
        ("bfloat16", TRAIN_BH, SERVED_SEQ, SERVED_VALID),
        ("float32", 6, 384, 301),  # small, ragged: the last key tile is partial
        ("bfloat16", 6, 384, 301),
    ]
    worst = {"dq": {}, "dkv": {}}
    with torch.no_grad():
        for i, (dt, bh, seq, nv) in enumerate(cases):
            q, k, v, valid, do, o, lse = _bwd_inputs(bh, seq, nv, getattr(torch, dt), 10 + i)
            drow = flash.row_correction(o, do)
            got = {
                "dq": (flash.flash_bwd_dq_cuda(q, k, v, valid, do, lse, drow, scale),),
                "dkv": flash.flash_bwd_dkv_cuda(q, k, v, valid, do, lse, drow, scale),
            }
            ref = {
                "dq": (flash.flash_bwd_dq_plain(q, k, v, valid, do, lse, drow, scale),),
                "dkv": flash.flash_bwd_dkv_plain(q, k, v, valid, do, lse, drow, scale),
            }
            torch.cuda.synchronize()
            for kern in ("dq", "dkv"):
                for name, a, b in zip(("dq",) if kern == "dq" else ("dk", "dv"),
                                      got[kern], ref[kern]):
                    diff = (a.float() - b.float()).abs()
                    err = diff.max().item()
                    share = (diff / _bwd_tol(dt, b)).max().item()
                    finite = bool(torch.isfinite(a.float()).all())
                    log(f"kernel flash_bwd_{kern} {dt} [{bh},{seq},{HEAD_DIM}] valid={nv}: "
                        f"max|{name}-plain|={err:.3e} (max|{name}| "
                        f"{b.float().abs().max().item():.4f}; worst element at "
                        f"{share:.3f} of its limit: "
                        + (f"{BWD_FP32_TOL:g}" if dt == "float32" else
                           f"{BF16_ULPS} bf16 ulps of max(|g|, {BWD_BF16_MIN_MAG:g})")
                        + f") finite={finite}")
                    if not (finite and share <= 1.0 and a.dtype == b.dtype):
                        raise AssertionError(
                            f"flash_bwd_{kern} disagrees with its plain version ({dt}, {name})")
                    if (bh, seq) == (TRAIN_BH, SERVED_SEQ) and dt == "bfloat16":
                        worst[kern][name] = err

        # Timing at the training shape in the training dtype (bf16).
        q, k, v, valid, do, o, lse = _bwd_inputs(
            TRAIN_BH, SERVED_SEQ, SERVED_VALID, torch.bfloat16, 19)
        drow = flash.row_correction(o, do)
        calls = {
            "dq": (lambda: flash.flash_bwd_dq_cuda(q, k, v, valid, do, lse, drow, scale),
                   lambda: flash.flash_bwd_dq_plain(q, k, v, valid, do, lse, drow, scale)),
            "dkv": (lambda: flash.flash_bwd_dkv_cuda(q, k, v, valid, do, lse, drow, scale),
                    lambda: flash.flash_bwd_dkv_plain(q, k, v, valid, do, lse, drow, scale)),
        }
        times = {}
        for kern, (kernel, plain) in calls.items():
            ms = _stream_ms(kernel, reps=20)
            plain_ms = _stream_ms(plain, reps=5)
            prof = _device_busy_ms(kernel, reps=10)[1][f"flash_bwd_{kern}_kernel"]
            times[kern] = (ms, plain_ms, prof)

    # The library's yardstick: one backward of scaled_dot_product_attention
    # (dq, dk and dv together) from a retained graph, same inputs.
    mask = (valid[0] > 0)[None, None, :]
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=scale)

    def library():
        return torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)

    library_ms = _stream_ms(library, reps=20)
    lib_grads = library()
    dq_k = flash.flash_bwd_dq_cuda(q, k, v, valid, do, lse, drow, scale)
    lib_err = (lib_grads[0].float() - dq_k.float()).abs().max().item()
    del out, lib_grads
    sdpa_flash = _sdpa_flash_ms(q, k, v, SERVED_VALID, scale, do=do)

    rows = {}
    for kern, meta in (("dq", K2), ("dkv", K3)):
        ms, plain_ms, prof = times[kern]
        # The kernels run p and ds split on the tensor cores: their bound is
        # the split one; the fp32-core bound of PR 2's design is logged beside.
        bound_ms, bound_by, note = bwd_bound_ms(
            kern, TRAIN_BH, SERVED_SEQ, SERVED_VALID, "bfloat16", split=True)
        cc_ms, cc_by, cc_note = bwd_bound_ms(
            kern, TRAIN_BH, SERVED_SEQ, SERVED_VALID, "bfloat16")
        log(f"time flash_bwd_{kern} bf16 [{TRAIN_BH},{SERVED_SEQ},{HEAD_DIM}] "
            f"valid={SERVED_VALID}: kernel {ms:.4f} ms per launch (20 back to back, "
            f"median of 5 rounds; torch.profiler kernel time {prof:.4f} ms), plain "
            f"{plain_ms:.4f} ms, scaled_dot_product_attention backward (dq, dk, dv) "
            f"{library_ms:.4f} ms (|sdpa dq - kernel dq| {lib_err:.2e}), "
            f"{_flash_yardstick(sdpa_flash, 'bwd')}; tensor-core bound "
            f"{bound_ms:.4f} ms by {bound_by} ({note}; {bound_ms / ms * 100:.1f}% of "
            f"bound); fp32-core bound {cc_ms:.4f} ms by {cc_by} ({cc_note}; "
            f"{cc_ms / ms * 100:.1f}% of it)")
        rows[kern] = {
            "max_abs_err": max(worst[kern].values()),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "library_flash_ms": sdpa_flash["bwd"],
        }
    k2k3 = times["dq"][0] + times["dkv"][0]
    log(f"time K2+K3 bf16 [{TRAIN_BH},{SERVED_SEQ},{HEAD_DIM}]: {k2k3:.4f} ms; "
        f"scaled_dot_product_attention backward with a boolean mask {library_ms:.4f} ms "
        f"({library_ms / k2k3:.2f}x K2+K3); "
        + (f"SDPA flash backend backward on the valid tokens {sdpa_flash['bwd']:.4f} ms "
           f"({sdpa_flash['bwd'] / k2k3:.2f}x K2+K3)" if sdpa_flash["bwd"] is not None
           else "SDPA flash backend backward not measured"))
    return rows


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


KERNEL_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def _device_busy_ms(
    fn, reps: int = 3, inference: bool = True, top: int | None = 5,
    counts: dict | None = None,
) -> tuple[float, dict, list]:
    """Sum of device kernel time per call of ``fn`` from torch.profiler,
    the part spent in each of the port's kernels (by name), and the ``top``
    kernels (all with None) that took the most device time as (name, ms
    per call). Zeros when the profiler records no device activity. With
    ``counts``, fills it with the launches of each of the port's kernels
    over the ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    mode = torch.inference_mode() if inference else torch.enable_grad()
    with mode, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    ours = dict.fromkeys(KERNEL_NAMES, 0.0)
    by_kernel = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += t
            by_kernel.append((e.key[:60], t / reps / 1e3))
            for name in KERNEL_NAMES:
                if name in e.key:
                    ours[name] += t / reps / 1e3
                    if counts is not None:
                        counts[name] = counts.get(name, 0) + e.count
    ranked = sorted(by_kernel, key=lambda kv: -kv[1])[:top]
    return total / reps / 1e3, ours, ranked


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
            busy_ms, ours, top = _device_busy_ms(lambda: engine.model(xt))
            k1_ms = ours["flash_fwd_kernel"]
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


# ---------------------------------------------------------------- phase 4
def _mag_ladder(level0: dict, level1: dict, density: float = 0.8) -> tuple[bool, str]:
    """Whether level 1's masks are exactly global magnitude's at ``density``
    on level 0's checkpoint (``prune_mag``: keep the scores above the k-th
    smallest, k = int((1 - density) N), so weights tied with the threshold
    go too: the density is 0.8 to 1/N plus the ties), and a note of the
    weights kept and the ties."""
    import torch

    from turboprune_tpu_torch.pruning.criteria import prune_mag

    want = prune_mag(level0["params"], level0["masks"], density)
    got = level1["masks"]
    exact = want.keys() == got.keys() and all(
        torch.equal(want[p].cpu(), got[p].cpu()) for p in want)
    n = sum(m.numel() for m in got.values())
    kept = sum(int(m.sum()) for m in got.values())
    k = int((1 - density) * n)
    return exact, (f"global magnitude's masks on level 0's weights exactly: {exact} ({kept} of "
                   f"{n} kept; {n - k - kept} pruned past k = {k}, tied with the threshold)")


def _read_csv(path: Path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _grads(model, masks, images, labels, forward=None) -> dict:
    """Parameter gradients of one train step's loss (the masked forward,
    summed fp32 cross entropy over the batch size), by autograd through
    ``forward``: ``train_forward`` eagerly, or its compiled version."""
    import torch

    from turboprune_tpu_torch.train import train_forward

    model.train()
    params = dict(model.named_parameters())
    loss = (forward or train_forward)(model, masks, images, labels)["loss"]
    # Copies: a compiled step's gradients live in its CUDA-graph memory.
    return {n: g.clone() for n, g in zip(params, torch.autograd.grad(loss, list(params.values())))}


@contextlib.contextmanager
def _flash_backward(variant: str):
    """Swap the flash_fwd op's registered backward, for the bf16 gradient
    diagnosis only (after the counted main path): "fp32_o" runs K2/K3 with
    drow from the unrounded attention output (softmax(s) v in fp32, from
    the same bf16 q, k, v) instead of the bf16 o; "plain" runs
    flash_backward_plain, the TPU recurrence in torch ops, on the same bf16
    o and lse."""
    from turboprune_tpu_torch.ops import flash

    def backward(ctx, do, _dlse):
        q, k, v, kv_valid, o, lse = ctx.saved_tensors
        if variant == "plain":
            dq, dk, dv = flash.flash_backward_plain(
                q, k, v, kv_valid, o, lse, do, ctx.scale, *ctx.blocks)
        else:
            o32, _ = flash.flash_attention_plain(
                q.float(), k.float(), v.float(), kv_valid, ctx.scale)
            drow = flash.row_correction(o32, do)
            dq = flash.flash_bwd_dq_cuda(q, k, v, kv_valid, do, lse, drow, ctx.scale)
            dk, dv = flash.flash_bwd_dkv_cuda(q, k, v, kv_valid, do, lse, drow, ctx.scale)
        return dq, dk, dv, None, None, None, None

    flash.flash_fwd.register_autograd(backward, setup_context=flash._flash_fwd_setup)
    try:
        yield
    finally:
        flash.flash_fwd.register_autograd(flash._flash_fwd_backward,
                                          setup_context=flash._flash_fwd_setup)


def _rel(a: dict, b: dict) -> dict:
    """Per tensor ||a - b|| / ||b||."""
    return {n: ((a[n] - b[n]).norm() / b[n].norm()).item() for n in b}


def _whole_rel(g: dict, ref: dict) -> float:
    """||G - G_ref|| / ||G_ref|| over all parameters."""
    num = math.sqrt(sum((g[n].float() - ref[n].float()).norm().item() ** 2 for n in ref))
    return num / math.sqrt(sum(ref[n].float().norm().item() ** 2 for n in ref))


def _check_fp32_grads(flash: dict, dense: dict) -> None:
    key_bias = [n for n in dense if n.endswith("attn.key.bias")]
    rel = {n: r for n, r in _rel(flash, dense).items() if n not in key_bias}
    worst = max(rel, key=rel.get)
    kb = max((flash[n].norm() / flash[n.replace(".key.", ".query.")].norm()).item()
             for n in key_bias)
    finite = all(bool(g.isfinite().all()) for g in flash.values())
    log(f"grads float32 batch {GRAD_FP32_BATCH}, flash vs dense attention: {len(rel)} "
        f"tensors, ||g_flash - g_dense|| / ||g_dense|| median "
        f"{statistics.median(rel.values()):.3e}, worst {rel[worst]:.3e} at {worst} "
        f"(limit {GRAD_FP32_TOL:g}); flash key-bias / query-bias gradient norm worst "
        f"{kb:.3e} (limit {KEY_BIAS_RATIO:g}); finite={finite}")
    if not finite or rel[worst] > GRAD_FP32_TOL or kb > KEY_BIAS_RATIO:
        raise AssertionError("fp32 flash gradients disagree with dense attention")


def _check_bf16_grads(flash: dict, dense: dict, ref: dict, batch: int) -> None:
    rel_f, rel_d, rel_fd = _rel(flash, ref), _rel(dense, ref), _rel(flash, dense)
    med_f, med_d = statistics.median(rel_f.values()), statistics.median(rel_d.values())

    all_f, all_d = _whole_rel(flash, ref), _whole_rel(dense, ref)
    limit = GRAD_BF16_FACTOR * all_d + GRAD_BF16_FLOOR
    key_bias = [n for n in ref if n.endswith("attn.key.bias")]
    worst = sorted((n for n in rel_f if n not in key_bias), key=rel_f.get)[-3:][::-1]
    kb = [(flash[n].float().norm() / flash[n.replace(".key.", ".query.")].float().norm()).item()
          for n in key_bias]
    finite = all(bool(g.isfinite().all()) for g in flash.values())
    log(f"grads bfloat16 batch {batch} against the fp32 dense gradient: whole gradient "
        f"||G - G_fp32|| / ||G_fp32|| flash {all_f:.3e}, dense bf16 {all_d:.3e} (flash's "
        f"limit {limit:.3e}); per tensor ||g - g_fp32|| / ||g_fp32|| median flash "
        f"{med_f:.3e}, dense bf16 {med_d:.3e} (flash's limit {GRAD_BF16_FACTOR:g} x "
        f"dense's); flash vs dense bf16 ||g_flash - g_dense|| / ||g_dense|| median "
        f"{statistics.median(rel_fd.values()):.3e}; worst tensors but the key biases "
        "(flash / dense bf16): "
        + "; ".join(f"{n} {rel_f[n]:.3e} / {rel_d[n]:.3e}" for n in worst)
        + f"; flash key-bias / query-bias gradient norm median {statistics.median(kb):.3e}, "
        f"max {max(kb):.3e}; finite={finite}")
    if not finite or all_f > limit or med_f > GRAD_BF16_FACTOR * med_d:
        raise AssertionError("bf16 flash gradients disagree with the fp32 gradient")


DIAGNOSIS_LABELS = {
    "flash": "flash (K2/K3, drow from the bf16 o)",
    "fp32_o": "flash, drow from the unrounded o (K2/K3)",
    "plain": "flash, flash_backward_plain (drow from the bf16 o)",
    "dense": "dense bf16",
}


def _check_bf16_cause(variants: dict, ref: dict) -> None:
    """Show where the bf16 flash gradient's large per-tensor distances come
    from: the same weights and batch through variants of the backward (see
    the GRAD_* notes above). Logs for each variant the distance
    ||g - g_fp32|| / ||g_fp32|| of block 11's query and key projections,
    of its worst tensor (the key biases aside) and of the whole gradient,
    and the largest key-bias / query-bias gradient norm ratio; then holds
    the drow-from-the-unrounded-o gradient to the per-tensor limits and
    flash_backward_plain's gradient to K2/K3's."""
    key_bias = [n for n in ref if n.endswith("attn.key.bias")]
    rel, kb, worst = {}, {}, {}
    for label, g in variants.items():
        rel[label] = _rel(g, ref)
        whole = _whole_rel(g, ref)
        worst[label] = max((n for n in rel[label] if n not in key_bias), key=rel[label].get)
        kb[label] = max((g[n].norm() / g[n.replace(".key.", ".query.")].norm()).item()
                        for n in key_bias)
        log(f"grads bfloat16 diagnosis, {DIAGNOSIS_LABELS[label]}: ||g - g_fp32|| / "
            "||g_fp32|| " + "; ".join(f"{n} {rel[label][n]:.3e}" for n in RESIDUE_TENSORS)
            + f"; worst {rel[label][worst[label]]:.3e} at {worst[label]}; median "
            f"{statistics.median(rel[label].values()):.3e}; whole gradient {whole:.3e}; "
            f"key-bias / query-bias max {kb[label]:.3e}")
    rel_kp = _rel(variants["flash"], variants["plain"])
    repro = max(abs(rel["plain"][n] / rel["flash"][n] - 1) for n in RESIDUE_TENSORS)
    log(f"grads bfloat16 K2/K3 vs flash_backward_plain inside the step: "
        f"||g_K - g_plain|| / ||g_plain|| median {statistics.median(rel_kp.values()):.3e} "
        f"(limit {GRAD_BF16_PLAIN_MEDIAN:g}), max {max(rel_kp.values()):.3e} at "
        f"{max(rel_kp, key=rel_kp.get)}; block 11's distances reproduced to "
        f"{repro:.3e} (limit {GRAD_BF16_REPRO:g}); drow from the unrounded o: worst "
        f"tensor {rel['fp32_o'][worst['fp32_o']]:.3e} (limit {GRAD_BF16_TENSOR_TOL:g}), "
        f"key-bias / query-bias {kb['fp32_o']:.3e} (limit {GRAD_BF16_KEY_BIAS:g})")
    if (rel["fp32_o"][worst["fp32_o"]] > GRAD_BF16_TENSOR_TOL
            or kb["fp32_o"] > GRAD_BF16_KEY_BIAS
            or repro > GRAD_BF16_REPRO
            or statistics.median(rel_kp.values()) > GRAD_BF16_PLAIN_MEDIAN):
        raise AssertionError("the bf16 flash gradient's distances are not drow's residue")


def phase_train() -> dict:
    import torch

    import run_experiment_torch
    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.data.augment import CIFAR10_MEAN, CIFAR10_STD, normalize_uint8
    from turboprune_tpu_torch.data.synthetic import synthetic_arrays
    from turboprune_tpu_torch.harness import PruningHarness
    from turboprune_tpu_torch.models import create_model
    from turboprune_tpu_torch.ops import flash, masking
    from turboprune_tpu_torch.utils import ExperimentCheckpoints

    counters = (flash.flash_fwd_cuda, flash.flash_bwd_dq_cuda, flash.flash_bwd_dkv_cuda)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as base:
        overrides = TRAIN_OVERRIDES + [f"experiment_params.base_dir={base}"]
        # ---- the main path, with every count at 0 just before it
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        rc = run_experiment_torch.main(
            ["--device", "cuda", "--config-name=imagenet_imp", *overrides])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        # ---- end of the main path
        log(f"train: run_experiment_torch main -> {rc} in {wall_s:.1f} s "
            f"(data generation, init, checkpoints included); launches {launches}")
        if rc != 0:
            raise AssertionError(f"run_experiment_torch main returned {rc}")
        (expt,) = [d for d in Path(base).iterdir() if d.is_dir()]
        summary_csv = next((expt / "metrics").glob("*_summary.csv"))
        summary = _read_csv(summary_csv)
        rows = [r for lvl in (0, 1) for r in _read_csv(
            expt / "metrics" / "level_wise_metrics" / f"level_{lvl}_metrics.csv")]
        for r in rows:
            log(f"train level {r['level']} epoch {r['epoch']}: train_loss "
                f"{float(r['train_loss']):.4f} test_loss {float(r['test_loss']):.4f} "
                f"train_acc {float(r['train_acc']):.2f}% sparsity "
                f"{float(r['sparsity']):.4f}% {float(r['samples_per_sec']):.1f} img/s "
                f"(epoch {float(r['epoch_seconds']):.2f} s)")
        losses = [float(r[k]) for r in rows for k in ("train_loss", "test_loss")]
        if [int(r["level"]) for r in summary] != [0, 1] or len(rows) != 2:
            raise AssertionError(f"expected levels 0 and 1, got {summary}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite loss in {losses}")
        ckpts = ExperimentCheckpoints(expt)
        if not (ckpts.has_model("model_init")
                and (ckpts.optimizer_path("optimizer_init") / "optimizer.pt").exists()):
            raise AssertionError("model_init / optimizer_init were not saved")
        level0, level1 = ckpts.load_level(0), ckpts.load_level(1)
        d0 = masking.overall_density(level0["masks"])
        d1 = masking.overall_density(level1["masks"])
        n = masking.num_prunable(level1["masks"])
        monotone = all(bool((level1["masks"][p] <= level0["masks"][p]).all())
                       for p in level0["masks"])
        exact, ladder = _mag_ladder(level0, level1)
        log(f"train: level densities {d0:.6f} / {d1:.6f} over {n} prunable weights; "
            f"masks monotone {monotone}; {ladder}")
        if d0 != 1.0 or not exact or not monotone:
            raise AssertionError("level densities or masks are wrong")
        expect = {"flash_fwd_cuda": DEPTH * (TRAIN_STEPS + EVAL_BATCHES),
                  "flash_bwd_dq_cuda": DEPTH * TRAIN_STEPS,
                  "flash_bwd_dkv_cuda": DEPTH * TRAIN_STEPS}
        if launches != expect:
            raise AssertionError(f"kernel launches {launches}, expected {expect}")

        # ---- gradients against dense attention, level 1's weights and masks
        cfg = compose("imagenet_imp", overrides)
        x, y = synthetic_arrays(256, 224, 1000, seed=7)
        images = normalize_uint8(torch.from_numpy(x).cuda(), CIFAR10_MEAN, CIFAR10_STD)
        labels = torch.from_numpy(y).long().cuda()
        masks = {p: m.cuda() for p, m in level1["masks"].items()}

        def grads_of(impl, dtype, batch):
            model = create_model(cfg.model_params.model_name, 1000, "ImageNet",
                                 compute_dtype=dtype, attention_impl=impl, image_size=224)
            model.load_state_dict(level1["params"])
            return _grads(model.cuda(), masks, images[:batch], labels[:batch])

        _check_fp32_grads(grads_of("flash", torch.float32, GRAD_FP32_BATCH),
                          grads_of("dense", torch.float32, GRAD_FP32_BATCH))
        ref32 = grads_of("dense", torch.float32, 256)
        flash16 = grads_of("flash", torch.bfloat16, 256)
        dense16 = grads_of("dense", torch.bfloat16, 256)
        _check_bf16_grads(flash16, dense16, ref32, 256)
        # ---- the cause of flash's bf16 per-tensor distances, same batch
        with _flash_backward("fp32_o"):
            flash16_o32 = grads_of("flash", torch.bfloat16, 256)
        with _flash_backward("plain"):
            flash16_plain = grads_of("flash", torch.bfloat16, 256)
        _check_bf16_cause({"flash": flash16, "fp32_o": flash16_o32,
                           "plain": flash16_plain, "dense": dense16}, ref32)
        del ref32, flash16, dense16, flash16_o32, flash16_plain

        # ---- step time and device time, outside the counted main path,
        # with the dense-attention model's step beside it as a yardstick
        steps = {}
        for impl in ("flash", "dense"):
            harness = PruningHarness(
                compose("imagenet_imp", overrides + [
                    f"model_params.attention_impl={impl}",
                    "dataset_params.synthetic_num_train=256",
                    "dataset_params.synthetic_num_test=256"]),
                ("", str(Path(base) / f"timing_{impl}")), device="cuda")
            harness.setup_level(1)
            batch = next(iter(harness.loaders.train_loader))

            def step(harness=harness, batch=batch):
                return harness._train_step(harness.state, batch)

            steps[impl] = step
        step_ms = _call_ms(steps["flash"], reps=5, warmup=2)
        dense_ms = _call_ms(steps["dense"], reps=5, warmup=2)
        busy_ms, ours, top = _device_busy_ms(steps["flash"], reps=3, inference=False)
        dense_busy_ms = _device_busy_ms(steps["dense"], reps=3, inference=False)[0]
    ours_ms = sum(ours.values())
    log(f"train step (DeiT-Small/16 @ 224, batch 256, bf16, flash): {step_ms:.3f} ms "
        "(CUDA events around one step, host work included, median of 5; "
        f"dense-attention step {dense_ms:.3f} ms, device busy {dense_busy_ms:.3f} ms; "
        f"flash / dense {step_ms / dense_ms:.3f} by step time"
        + (f", {busy_ms / dense_busy_ms:.3f} by device busy" if dense_busy_ms else "")
        + "); "
        + (f"device busy {busy_ms:.3f} ms per step (idle "
           f"{max(0.0, 1 - busy_ms / step_ms) * 100:.1f}%); K1+K2+K3 "
           f"{ours_ms:.3f} ms = {ours_ms / busy_ms * 100:.1f}% of it ("
           + ", ".join(f"{k} {v:.3f}" for k, v in ours.items()) + " ms)"
           if busy_ms else
           "device busy time not measured (the profiler saw no device activity)"))
    if top:
        log("train step top device kernels (ms per step): "
            + "; ".join(f"{name} {ms:.3f}" for name, ms in top))
    return {"launches": launches, "step_ms": step_ms, "busy_ms": busy_ms}


# ---------------------------------------------------------------- phase 5
# The ResNet path: conf/cifar10_imp.yaml as shipped (ResNet-18 with the
# CIFAR stem, 11.17M parameters, bf16, batch 512, SGD lr 0.2, triangular
# schedule) at CIFAR-10's own 50,000 / 10,000 images. Cut: synthetic data,
# one epoch per level (150 shipped), two levels (32 reach 0.999).
RESNET_OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "dataset_params.synthetic_num_train=50000",
    "dataset_params.synthetic_num_test=10000",
    "experiment_params.epochs_per_level=1",
]
RESNET_BATCH = 512
RESNET_STEPS = 50000 // RESNET_BATCH     # 97 steps per level
# The card against the CPU, one fp32 train step of the full model at batch
# 32 with TF32 off: both compute the same fp32 convolutions in other
# summation orders (~1e-6 relative per value), which the train-mode
# BatchNorm passes on. Logits and updated running statistics: within 1e-4
# of their largest magnitude. Gradients: a BatchNorm in train mode gives
# its input a gradient that sums to zero over the batch, so the gradients
# of the BatchNorm biases and scales before it are small sums of large
# terms, and fp32 rounding moves them by ~1e-3 of their norm: on the CPU
# the fp32 gradient of this model lies 1.5e-3 (median over tensors) and
# up to 6.7e-3 (a BatchNorm bias) from its float64 gradient, and the first
# run on an H100 measured 1.4e-3 card vs CPU at layer3_0.BatchNorm_0.bias.
# So each tensor's card gradient is held to the float64 gradient computed
# on the CPU: within 1e-3 of its norm plus twice the CPU fp32 gradient's
# own distance (the card as exact as the CPU); the whole gradient, card
# against CPU, within 1e-3 of its norm. A wrong layer moves them by O(1).
# The compiled step (inductor) is a third fp32 implementation of the same
# sums, in its own order: the same limits, each tensor's noise taken as
# the larger of the CPU's and the eager card's distance from float64 (the
# compiled step as exact as eager fp32 on either device). With the masks
# of a compiled run's level 1, layer3_0.BatchNorm_0.bias lay 1.79e-3 from
# float64 eager on an H100, 1.90e-3 compiled there, 4.7e-4 on the CPU.
# One draw of that noise says little: a tensor's fp32 distance from
# float64 is ~1e-6 or ~1e-3 by whether rounding tips a pre-activation near
# zero across a ReLU, so it moves by 1e3 with the order of the same sums
# (layer4_1.BatchNorm_0.bias on the CPU: 1.2e-6, 9.2e-4, 3.3e-3, 4.5e-3
# over four orders of one batch). Over 15 mask sets on an H100
# (card_cpu_noise.py) the one-draw rule failed the compiled step on 2 and
# the eager card, held to it in the compiled step's place, on 3; the whole
# gradient lay more than 1e-3 from the CPU's on 13 compiled and 12 eager.
# So the compiled step's noise, per tensor and for the whole gradient, is
# the largest over CARD_CPU_ORDERS orders of the batch (the batch and fixed
# permutations of it: the same sums in other orders) on each device; its
# whole gradient is held to float64 like each tensor; and it runs on the
# eager resnet phase's level-1 masks, which are the same in every run.
CARD_CPU_BATCH = 32
CARD_CPU_REL = 1e-4
CARD_CPU_GRAD = 1e-3
CARD_CPU_ORDERS = 4
# Served bf16 logits against the harness's eval forward of the same level-1
# checkpoint on the same images: both run the same bf16 convolutions on
# the same weights (the engine folds w * m once; the eval forward
# multiplies it in each time, the same values) at the same batch shape,
# though cuDNN may pick other algorithms for the two calls; limit: two
# bf16 ulps (2^-7) of the largest logit, at least of 1.
SERVE_BUCKET = 128
SERVE_RTOL = 2.0 ** -7


class _Recorder:
    """Records, from inside the driver's run, each level's starting
    parameters and statistics, that every evaluation ran in eval mode and
    left the running statistics as they were, dynamo's graph count at the
    end of each level, and the wall time of the first train step and of
    each evaluation (a compiled run compiles in its first of each)."""

    def __init__(self):
        self.starts = {}
        self.evals = []
        self.graphs = {}
        self.first_step_s = None
        self.eval_s = []

    def harness_cls(self):
        import torch
        from torch._dynamo.utils import counters

        from turboprune_tpu_torch.harness import PruningHarness

        recorder = self

        class Harness(PruningHarness):
            def train_one_level(self, epochs_per_level, level):
                recorder.starts[level] = {
                    k: v.detach().cpu().clone()
                    for k, v in self.state.model.state_dict().items()}
                out = super().train_one_level(epochs_per_level, level)
                recorder.graphs[level] = counters["stats"]["unique_graphs"]
                return out

            def setup_level(self, epochs):
                super().setup_level(epochs)
                step = self._train_step

                def timed(state, batch):
                    if recorder.first_step_s is not None:
                        return step(state, batch)
                    t0 = time.perf_counter()
                    out = step(state, batch)
                    torch.cuda.synchronize()
                    recorder.first_step_s = time.perf_counter() - t0
                    return out

                self._train_step = timed

            def evaluate(self):
                before = [b.clone() for b in self.state.model.buffers()]
                t0 = time.perf_counter()
                out = super().evaluate()
                recorder.eval_s.append(time.perf_counter() - t0)
                same = all(bool((a == b).all())
                           for a, b in zip(before, self.state.model.buffers()))
                recorder.evals.append((not self.state.model.training, same))
                return out

        return Harness


def _run_config(name: str, overrides: list, recorder=None) -> tuple[int, Path, float]:
    """run_experiment_torch's main on ``name``; with a recorder, the driver
    builds the recorder's harness (the same PruningHarness, instrumented)."""
    from unittest import mock

    import torch

    import run_experiment_torch
    from turboprune_tpu_torch import driver

    base = overrides[-1].split("=", 1)[1]
    before = set(Path(base).iterdir()) if Path(base).exists() else set()
    patch = (mock.patch.object(driver, "PruningHarness", recorder.harness_cls())
             if recorder else contextlib.nullcontext())
    t0 = time.perf_counter()
    with patch:
        rc = run_experiment_torch.main(["--device", "cuda", f"--config-name={name}", *overrides])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (expt,) = set(Path(base).iterdir()) - before
    return rc, expt, wall


def _model_macs(model, image: int) -> int:
    """Multiply-accumulates of one image's forward: every convolution
    (output size x input channels x kernel area) and every dense layer."""
    import torch

    macs = []

    def conv_hook(module, args, out):
        macs.append(out[0].numel() * module.in_channels * module.weight[0, 0].numel())

    def fc_hook(module, args, out):
        macs.append(module.in_features * module.out_features)

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    hooks += [m.register_forward_hook(fc_hook) for m in model.modules()
              if isinstance(m, torch.nn.Linear)]
    model.eval()
    with torch.no_grad():
        model(torch.zeros(1, image, image, 3, device=next(model.parameters()).device))
    for h in hooks:
        h.remove()
    return sum(macs)


def _kernel_kind(name: str) -> str:
    """convolution (cuDNN's kernels), reduction, elementwise or other, by
    the kernel's name; inductor's Triton kernels by their prefix (pointwise,
    or a reduction, looped or persistent), before their fused op names."""
    low = name.lower()
    if low.startswith("triton_poi"):
        return "elementwise"
    if low.startswith(("triton_red", "triton_per")):
        return "reduction"
    if any(k in low for k in ("fprop", "dgrad", "wgrad", "conv", "xmma", "cutlass",
                              "implicit", "gemm", "cudnn")):
        return "convolution"
    if "reduce" in low:
        return "reduction"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def _card_vs_cpu(masks: dict, compiled: bool = False) -> None:
    """One fp32 train step's logits, updated running statistics and
    gradients of the full ResNet-18 at batch 32, on the card and on the
    CPU, from the same weights (seed), masks and batch; TF32 off; the
    float64 gradient on the CPU as the reference. With ``compiled``, the
    card also runs the compiled step (inductor, CUDA graphs), held to the
    same limits, each tensor's noise and the whole gradient's taken over
    ``CARD_CPU_ORDERS`` orders of the batch on the CPU and the eager card,
    its whole gradient held to float64, and against the eager card step."""
    import copy

    import torch

    from turboprune_tpu_torch.data.augment import CIFAR10_MEAN, CIFAR10_STD, normalize_uint8
    from turboprune_tpu_torch.data.synthetic import synthetic_arrays
    from turboprune_tpu_torch.models import create_model
    from turboprune_tpu_torch.train import compile_forward, mark_buffers_static, train_forward

    x, y = synthetic_arrays(CARD_CPU_BATCH, 32, 10, seed=11)
    images = normalize_uint8(torch.from_numpy(x), CIFAR10_MEAN, CIFAR10_STD)
    labels = torch.from_numpy(y).long()
    cpu = create_model("resnet18", 10, "CIFAR10").init_weights(torch.Generator().manual_seed(0))
    exact = copy.deepcopy(cpu).double()
    for module in exact.modules():
        if hasattr(module, "dtype"):
            module.dtype = torch.float64
    # The head casts its input to fp32; in float64 it takes the float64 pool.
    exact.fc.forward = lambda z, fc=exact.fc: torch.nn.functional.linear(
        z.double(), fc.weight, fc.bias)
    runs = [("cpu", cpu, "cpu", torch.float32, train_forward),
            ("cuda", copy.deepcopy(cpu).cuda(), "cuda", torch.float32, train_forward)]
    if compiled:
        model = copy.deepcopy(cpu).cuda()
        mark_buffers_static(model)
        runs.append(("cuda compiled", model, "cuda", torch.float32,
                     compile_forward(train_forward, torch.device("cuda"))))
    runs.append(("float64", exact, "cpu", torch.float64, train_forward))
    out = {}
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, model, dev, dtype, forward in runs:
            model.train()
            params = dict(model.named_parameters())
            res = forward(model, {p: v.to(dev) for p, v in masks.items()},
                          images.to(dev, dtype), labels.to(dev))
            grads = torch.autograd.grad(res["loss"], list(params.values()))
            out[name] = (res["logits"].cpu().double(),
                         {k: v.cpu().double() for k, v in model.named_buffers()},
                         {k: g.cpu().double() for k, g in zip(params, grads)})
        # The fp32 noise of the eager routes in other orders of the batch
        # (their running statistics are read above and move on here).
        reordered = {"cpu": [], "cuda": []}
        if compiled:
            for i in range(1, CARD_CPU_ORDERS):
                perm = torch.randperm(CARD_CPU_BATCH, generator=torch.Generator().manual_seed(i))
                for name, model, dev, dtype, forward in runs[:2]:
                    params = dict(model.named_parameters())
                    res = forward(model, {p: v.to(dev) for p, v in masks.items()},
                                  images[perm].to(dev, dtype), labels[perm].to(dev))
                    grads = torch.autograd.grad(res["loss"], list(params.values()))
                    reordered[name].append({k: g.cpu().double() for k, g in zip(params, grads)})
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, bc, gc), (_, _, g64) = out["cpu"], out["float64"]

    def dist(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def flat(g):
        return torch.cat([v.reshape(-1) for v in g.values()])

    cpu64 = {k: max(dist(g[k], g64[k]) for g in [gc] + reordered["cpu"]) for k in g64}
    eager64 = {k: max(dist(g[k], g64[k]) for g in [out["cuda"][2]] + reordered["cuda"])
               for k in g64}
    # The compiled step's whole gradient: from float64 within 1e-3 of its
    # norm plus twice the eager routes' largest distance over the orders.
    whole_noise = max(dist(flat(g), flat(g64)) for g in
                      [gc, out["cuda"][2]] + reordered["cpu"] + reordered["cuda"])
    whole_limit = CARD_CPU_GRAD + 2 * whole_noise
    failed = []
    # Each route with the noise it is held to. The compile phase holds the
    # compiled step only: the eager card is held in the resnet phase, on
    # the same masks.
    routes = {"cuda": cpu64}
    if compiled:
        routes = {"cuda compiled": {k: max(cpu64[k], eager64[k]) for k in g64}}
    for route, noise in routes.items():
        lg, bg, gg = out[route]
        logit_err = float((lg - lc).abs().max() / lc.abs().max())
        stat_err = max(float((bg[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                       for k, v in bc.items())
        card_cpu = {k: dist(gg[k], g) for k, g in gc.items()}
        whole = dist(flat(gg), flat(gc))
        whole64 = dist(flat(gg), flat(g64))
        whole_ok = whole <= CARD_CPU_GRAD if route == "cuda" else whole64 <= whole_limit
        card64 = {k: dist(gg[k], g) for k, g in g64.items()}
        excess = {k: card64[k] - (CARD_CPU_GRAD + 2 * noise[k]) for k in g64}
        worst = max(card_cpu, key=card_cpu.get)
        tight = max(excess, key=excess.get)
        log(f"resnet {route} vs cpu: one fp32 train step of ResNet-18 (full width) at batch "
            f"{CARD_CPU_BATCH}, TF32 off for this check (cudnn.allow_tf32 and "
            "cuda.matmul.allow_tf32 False; PyTorch's cuDNN default is on): logits "
            f"{logit_err:.3e} of their largest (limit {CARD_CPU_REL}), running statistics "
            f"{stat_err:.3e} (limit {CARD_CPU_REL}); gradients {route} vs cpu: whole "
            f"{whole:.3e} of its norm ("
            + (f"limit {CARD_CPU_GRAD}" if route == "cuda" else
               f"from float64 {whole64:.3e}, limit 1e-3 + 2 x {whole_noise:.3e}, the eager "
               f"routes' largest over {CARD_CPU_ORDERS} orders, = {whole_limit:.3e}")
            + "), per tensor median "
            f"{statistics.median(card_cpu.values()):.3e}, worst {card_cpu[worst]:.3e} at {worst}; "
            f"from the float64 gradient: {route} median {statistics.median(card64.values()):.3e}, "
            f"cpu fp32 median {statistics.median(cpu64.values()):.3e}; closest to the per-tensor "
            f"limit (1e-3 + 2 x {'cpu' if route == 'cuda' else 'max(cpu, eager card)'}'s"
            f"{'' if route == 'cuda' else f', each the largest over {CARD_CPU_ORDERS} orders of the batch'}): "
            f"{tight} {route} {card64[tight]:.3e}, cpu {cpu64[tight]:.3e}, eager card "
            f"{eager64[tight]:.3e}")
        if (logit_err > CARD_CPU_REL or stat_err > CARD_CPU_REL or not whole_ok
                or excess[tight] > 0):
            failed.append(route)
    if compiled:
        (le, _, ge), (lk, _, gk) = out["cuda"], out["cuda compiled"]
        logit_err = float((lk - le).abs().max() / le.abs().max())
        whole = dist(flat(gk), flat(ge))
        log(f"resnet compiled vs eager (card, fp32, batch {CARD_CPU_BATCH}): logits "
            f"{logit_err:.3e} of their largest (limit {CARD_CPU_REL}), whole gradient "
            f"{whole:.3e} of its norm (limit {2 * whole_limit:.3e}: each within "
            f"{whole_limit:.3e} of float64)")
        if logit_err > CARD_CPU_REL or whole > 2 * whole_limit:
            failed.append("compiled vs eager")
    if failed:
        raise AssertionError(f"the card's fp32 ResNet step disagrees with the CPU's: {failed}")


def _check_imp_run(tag: str, expt: Path, recorder: _Recorder,
                   steps: int = RESNET_STEPS) -> tuple[list, dict]:
    """The checks of a two-level cifar10_imp run: finite losses, densities
    1.0 / 0.8 to 1/N, monotone masks, level 1 starting from model_init in
    params and batch_stats bit for bit, and two evaluations in eval mode
    that left the running statistics untouched. Returns (CSV rows, the
    level-1 checkpoint)."""
    import torch

    from turboprune_tpu_torch.ops import masking
    from turboprune_tpu_torch.utils import ExperimentCheckpoints, model_state_dict

    rows = [r for lvl in (0, 1) for r in _read_csv(
        expt / "metrics" / "level_wise_metrics" / f"level_{lvl}_metrics.csv")]
    for r in rows:
        log(f"{tag} level {r['level']}: train_loss {float(r['train_loss']):.4f} "
            f"test_loss {float(r['test_loss']):.4f} test_acc {float(r['test_acc']):.2f}% "
            f"{float(r['samples_per_sec']):.1f} img/s over the epoch "
            f"({steps} steps, {float(r['epoch_seconds']):.2f} s)")
    losses = [float(r[k]) for r in rows for k in ("train_loss", "test_loss")]
    if len(rows) != 2 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"expected two levels of finite losses, got {losses}")
    ckpts = ExperimentCheckpoints(expt)
    init, level0, level1 = (ckpts.load_model("model_init"), ckpts.load_level(0),
                            ckpts.load_level(1))
    d0, d1 = (masking.overall_density(level0["masks"]),
              masking.overall_density(level1["masks"]))
    n = masking.num_prunable(level1["masks"])
    monotone = all(bool((level1["masks"][p] <= level0["masks"][p]).all())
                   for p in level0["masks"])
    start = recorder.starts[1]
    rewound = {k: bool(torch.equal(start[k], v)) for k, v in model_state_dict(init).items()}
    stats = [k for k in init["batch_stats"]]
    exact, ladder = _mag_ladder(level0, level1)
    log(f"{tag}: densities {d0:.6f} / {d1:.6f} over {n} prunable weights (ladder "
        f"1.0 / 0.8; {ladder}); masks monotone {monotone}; level 1 starts from model_init "
        f"bit for bit: {sum(rewound[k] for k in init['params'])}/{len(init['params'])} "
        f"params, {sum(rewound[k] for k in stats)}/{len(stats)} batch_stats; "
        f"evaluations in eval mode, running statistics untouched: {recorder.evals}")
    if (d0 != 1.0 or not exact or not monotone or not all(rewound.values())
            or len(recorder.evals) != 2 or not all(a and b for a, b in recorder.evals)):
        raise AssertionError(f"{tag}: IMP densities, masks, rewind or eval mode are wrong")
    return rows, level1


def phase_resnet() -> dict:
    import torch

    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.harness import PruningHarness
    from turboprune_tpu_torch.ops import flash, masking
    from turboprune_tpu_torch.pruning import erk_densities
    from turboprune_tpu_torch.serve import InferenceEngine
    from turboprune_tpu_torch.train import masked_forward
    from turboprune_tpu_torch.utils import ExperimentCheckpoints, model_state_dict

    counters = (flash.flash_fwd_cuda, flash.flash_bwd_dq_cuda, flash.flash_bwd_dkv_cuda)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resnet_") as base:
        # ---- IMP: the main path, with every count at 0 just before it
        recorder = _Recorder()
        overrides = RESNET_OVERRIDES + ["pruning_params.target_sparsity=0.2",
                                        f"experiment_params.base_dir={base}/imp"]
        for c in counters:
            c.launches = 0
        rc, expt, imp_wall = _run_config("cifar10_imp", overrides, recorder)
        launches = {c.__name__: c.launches for c in counters}
        # ---- end of the main path
        log(f"resnet imp: run_experiment_torch main --config-name=cifar10_imp -> {rc} in "
            f"{imp_wall:.1f} s (data generation, init, checkpoints included); K1/K2/K3 "
            f"launches {launches} (the ResNet path runs none of them)")
        if rc != 0 or any(launches.values()):
            raise AssertionError(f"cifar10_imp returned {rc}, launches {launches}")
        rows, level1 = _check_imp_run("resnet imp", expt, recorder)

        # ---- prune at init: ER-ERK and SNIP, one level at density 0.1
        for name in ("cifar10_er_erk", "cifar10_er_snip"):
            over = RESNET_OVERRIDES + ["experiment_params.max_steps_per_epoch=4",
                                       f"experiment_params.base_dir={base}/{name}"]
            for c in counters:
                c.launches = 0
            rc, pexpt, wall = _run_config(name, over)
            launches = {c.__name__: c.launches for c in counters}
            pinit = ExperimentCheckpoints(pexpt).load_model("model_init")
            masks = pinit["masks"]
            n = masking.num_prunable(masks)
            density = masking.overall_density(masks)
            if name == "cifar10_er_erk":
                per_layer = erk_densities(masks, 0.1)
                worst = max(
                    abs(int(m.sum()) - m.numel() * per_layer[p])
                    / math.sqrt(m.numel() * per_layer[p] * (1 - per_layer[p]) or 1.0)
                    for p, m in masks.items())
                ok = abs(density - 0.1) * n <= 4 * math.sqrt(n * 0.09) and worst <= 4
                detail = (f"{abs(density - 0.1) * n / math.sqrt(n * 0.09):.2f} sigma overall, "
                          f"worst layer {worst:.2f} sigma from its erk_densities value")
            else:
                untouched = all(bool((v == (1.0 if k.endswith(".var") else 0.0)).all())
                                for k, v in pinit["batch_stats"].items())
                ok = abs(density - 0.1) <= 1.0 / n and untouched
                detail = (f"exact to 1/N {abs(density - 0.1) <= 1.0 / n}; every BatchNorm "
                          f"buffer as initialised after the scoring: {untouched}")
            log(f"resnet {name}: main -> {rc} in {wall:.1f} s; density {density:.6f} over "
                f"{n} ({detail}); K1/K2/K3 launches {launches}")
            if rc != 0 or not ok or any(launches.values()):
                raise AssertionError(f"{name}: wrong density or statistics")

        # ---- the card against the CPU, fp32, TF32 off
        _card_vs_cpu(level1["masks"])

        # ---- the bf16 train step at batch 512
        harness = PruningHarness(
            compose("cifar10_imp", RESNET_OVERRIDES[:1] + [
                "dataset_params.synthetic_num_train=512",
                "dataset_params.synthetic_num_test=512",
                f"experiment_params.base_dir={base}/timing"]),
            ("", str(Path(base) / "timing")), device="cuda")
        harness.setup_level(1)
        batch = next(iter(harness.loaders.train_loader))

        def step():
            return harness._train_step(harness.state, batch)

        step_ms = _call_ms(step, reps=5, warmup=2)
        busy_ms, _, kernels = _device_busy_ms(step, reps=3, inference=False, top=None)
        top = kernels[:5]
        kinds = _kinds(kernels)
        macs = _model_macs(harness.state.model, 32)
        flops = 3 * 2 * macs * RESNET_BATCH
        bound_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        log(f"resnet train step (ResNet-18 CIFAR, batch {RESNET_BATCH}, bf16): {step_ms:.3f} ms "
            "(CUDA events around one step, host work included, median of 5); "
            + (f"device busy {busy_ms:.3f} ms per step (torch.profiler, 3 steps), idle "
               f"{max(0.0, 1 - busy_ms / step_ms) * 100:.1f}%; " if busy_ms else
               "device busy time not measured (the profiler saw no device activity); ")
            + f"FLOP bound {flops / 1e12:.3f} TFLOP ({macs / 1e9:.4f} GMAC per image x 2 x 3 x "
            f"{RESNET_BATCH}) = {bound_ms:.3f} ms at 989 TFLOP/s bf16 dense, "
            f"{bound_ms / step_ms * 100:.1f}% of the step"
            + (f", {bound_ms / busy_ms * 100:.1f}% of the busy time" if busy_ms else ""))
        if top:
            log("resnet train step top device kernels (ms per step): "
                + "; ".join(f"{name} {ms:.3f}" for name, ms in top))
            log(f"resnet train step device time by kind (ms per step): {_kinds_line(kinds)}")

        # ---- serve the trained level 1 and hold it against the eval forward
        engine = InferenceEngine.from_experiment(expt, level=1, buckets=(SERVE_BUCKET,),
                                                 device="cuda")
        model = harness.state.model
        model.load_state_dict(model_state_dict(level1))
        images = harness.loaders.test_loader._base[:SERVE_BUCKET]
        model.eval()
        with torch.no_grad():
            want = masked_forward(model, {p: m.cuda() for p, m in level1["masks"].items()},
                                  images).float().cpu().numpy()
        x = images.cpu().numpy()
        got = engine.predict(x)
        err = float(np.abs(got - want).max())
        limit = SERVE_RTOL * max(1.0, float(np.abs(want).max()))
        fwd_busy, _, _ = _device_busy_ms(lambda: engine.predict(x), reps=3)
        top1 = float((got.argmax(-1) == want.argmax(-1)).mean())
        log(f"resnet serve: level {engine.level} (density {engine.density:.4f}) bucket "
            f"{SERVE_BUCKET}, eval mode on the running statistics {not engine.model.training}: "
            f"max |served - eval forward| {err:.3e} at logits up to "
            f"{float(np.abs(want).max()):.3f} (limit {limit:.3e}), top-1 agreement {top1:.3f}; "
            f"forward device time {fwd_busy:.3f} ms (torch.profiler, 3 forwards)")
        if engine.model.training or err > limit:
            raise AssertionError("served ResNet disagrees with the eval forward")
    log(f"resnet phase: {time.perf_counter() - t_phase:.1f} s")
    return {"step_ms": step_ms, "busy_ms": busy_ms, "kinds": kinds, "wall_s": imp_wall,
            "img_s": [float(r["samples_per_sec"]) for r in rows], "masks": level1["masks"]}


# ---------------------------------------------------------------- phase 6
# Resume: conf/cifar10_imp.yaml as shipped (ResNet-18, CIFAR stem, bf16,
# batch 512, SGD lr 0.2, triangular schedule). Cut: synthetic data, 8,192 /
# 2,048 images, 3 epochs of at most 4 steps a level, two levels; the slot
# saved after every epoch.
RESUME_OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "dataset_params.synthetic_num_train=8192",
    "dataset_params.synthetic_num_test=2048",
    "experiment_params.epochs_per_level=3",
    "experiment_params.checkpoint_every_epochs=1",
    "experiment_params.max_steps_per_epoch=4",
    "pruning_params.target_sparsity=0.2",
]
RESUME_EPOCH_STEPS = 4
FULL_EPOCH_STEPS = 50000 // RESNET_BATCH


def _train_snapshot(harness) -> dict:
    """The state a resume must give back, on the CPU: params and BatchNorm
    statistics, masks, SGD momentum, the level's step, the loader's epoch."""
    s = harness.state
    return {
        "state": {k: v.detach().cpu().clone() for k, v in s.model.state_dict().items()},
        "masks": {p: m.cpu().clone() for p, m in s.masks.items()},
        "momentum": {i: st["momentum_buffer"].cpu().clone()
                     for i, st in s.optimizer.state_dict()["state"].items()},
        "step": s.step,
        "loader_epoch": harness.loaders.train_loader.epoch,
    }


def _snapshot_diff(a: dict, b: dict) -> dict:
    """Which parts of two snapshots differ, and the L2 distance of their
    params and statistics."""
    import torch

    dist = math.sqrt(sum(float((a["state"][k].double() - v.double()).pow(2).sum())
                         for k, v in b["state"].items()))
    return {
        "state_equal": all(torch.equal(a["state"][k], v) for k, v in b["state"].items()),
        "masks_equal": all(torch.equal(a["masks"][p], m) for p, m in b["masks"].items()),
        "momentum_equal": a["momentum"].keys() == b["momentum"].keys() and all(
            torch.equal(a["momentum"][i], m) for i, m in b["momentum"].items()),
        "step_equal": a["step"] == b["step"],
        "loader_epoch_equal": a["loader_epoch"] == b["loader_epoch"],
        "l2": dist,
    }


def phase_resume() -> dict:
    import io
    from unittest import mock

    import torch

    import run_experiment_torch
    from turboprune_tpu_torch import driver
    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.harness import PruningHarness
    from turboprune_tpu_torch.ops import flash
    from turboprune_tpu_torch.utils import config_fingerprint

    counters = (flash.flash_fwd_cuda, flash.flash_bwd_dq_cuda, flash.flash_bwd_dkv_cuda)
    t_phase = time.perf_counter()
    rec: dict = {"save_ms": [], "harness": None}

    class Recorded(PruningHarness):
        """Times each slot save; keeps the harness for its end state."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            rec["harness"] = self
            save = self.ckpts.save_mid_level

            def timed_save(level, epoch, state, meta):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                save(level, epoch, state, meta)
                rec["save_ms"].append((time.perf_counter() - t0) * 1e3)
                self.after_save(level, epoch, state)

            self.ckpts.save_mid_level = timed_save

        def after_save(self, level, epoch, state):
            pass

    class Preempted(Recorded):
        """Dies right after the level-1, epoch-0 slot save."""

        def after_save(self, level, epoch, state):
            if (level, epoch) == (1, 0):
                rec["at_save"] = _train_snapshot(self)
                rec["slot_bytes"] = (self.ckpts.mid_level_path() / "model.pt").stat().st_size
                raw = io.BytesIO()  # the same tree, masks as raw bools
                torch.save({**state.model_tree(), "optimizer": state.optimizer.state_dict(),
                            "step": state.step, "tag": 0}, raw)
                rec["raw_bytes"] = raw.getbuffer().nbytes
                rec["mask_bytes"] = sum(m.numel() for m in state.masks.values())
                raise KeyboardInterrupt("simulated preemption after the level-1, epoch-0 save")

    class Resumed(Recorded):
        def _enter_mid_level(self, level):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entered = super()._enter_mid_level(level)
            torch.cuda.synchronize()
            rec["restore_ms"] = (time.perf_counter() - t0) * 1e3
            rec["entered"] = entered
            rec["after_restore"] = _train_snapshot(self)
            return entered

    def main_with(harness_cls, base, extra=()):
        with mock.patch.object(driver, "PruningHarness", harness_cls):
            return run_experiment_torch.main(
                ["--device", "cuda", "--config-name=cifar10_imp", *RESUME_OVERRIDES,
                 f"experiment_params.base_dir={base}", *extra])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as base:
        ends, dirs = {}, {}
        # ---- the main path, with every count at 0 just before it
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        for run in ("a", "a2"):
            if main_with(Recorded, f"{base}/{run}") != 0:
                raise AssertionError(f"uninterrupted run {run} failed")
            ends[run] = _train_snapshot(rec["harness"])
            (dirs[run],) = Path(f"{base}/{run}").iterdir()
        save_ms = list(rec["save_ms"])
        try:
            main_with(Preempted, f"{base}/b")
        except KeyboardInterrupt:
            pass
        else:
            raise AssertionError("run b was not preempted")
        (dirs["b"],) = Path(f"{base}/b").iterdir()
        meta = rec["harness"].ckpts.peek_mid_level()
        want_hash = config_fingerprint(compose("cifar10_imp", RESUME_OVERRIDES + [
            f"experiment_params.base_dir={base}/b"]))
        log(f"resume preempted run: slot header level {meta['level']} epoch {meta['epoch']}, "
            f"config hash {meta['config_hash']} (config_fingerprint {want_hash}), loader "
            f"epoch {meta['train_loader_epoch']}, {len(meta['level_rows'])} level row(s)")
        if (meta["level"], meta["epoch"]) != (1, 0) or meta["config_hash"] != want_hash:
            raise AssertionError(f"slot header {meta}")
        rc = main_with(Resumed, f"{base}/b", [
            "experiment_params.resume_experiment=true",
            f"experiment_params.resume_experiment_stuff.resume_expt_name={dirs['b'].name}",
            "experiment_params.resume_experiment_stuff.resume_level=1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        # ---- end of the main path
        ends["r"] = _train_snapshot(rec["harness"])
        log(f"resume: 4 runs of run_experiment_torch main (a, a', b preempted, b resumed) "
            f"in {wall:.1f} s; resumed -> {rc}, re-entered level 1 at epoch "
            f"{rec['entered'][0]}; K1/K2/K3 launches {launches} (the ResNet path runs none)")
        if rc != 0 or rec["entered"][0] != 1 or any(launches.values()):
            raise AssertionError("the resume did not re-enter level 1 at epoch 1")

        restored = _snapshot_diff(rec["after_restore"], rec["at_save"])
        log(f"resume restore against the state at the save: {restored}")
        if restored["l2"] != 0.0 or not all(v for k, v in restored.items() if k != "l2"):
            raise AssertionError("the restore is not the saved state bit for bit")

        noise = _snapshot_diff(ends["a2"], ends["a"])
        end = _snapshot_diff(ends["r"], ends["a"])
        deterministic = noise["state_equal"]
        log(f"resume end state, resumed b against uninterrupted a: {end}; a' against a "
            f"(cuDNN's run-to-run noise): {noise}; "
            + ("cuDNN's algorithms were deterministic run to run here" if deterministic else
               "cuDNN's algorithms are NOT deterministic run to run here: the resumed run is "
               "held within twice a' - a"))
        if not (end["masks_equal"] and end["step_equal"] and end["loader_epoch_equal"]):
            raise AssertionError("resumed masks, step or loader epoch differ from run a")
        if not (end["state_equal"] or end["l2"] <= 2 * noise["l2"]):
            raise AssertionError(f"resumed end state {end['l2']} from run a, noise {noise['l2']}")

        for run in ("a", "b"):
            rows = _read_csv(dirs[run] / "metrics" / "level_wise_metrics" / "level_1_metrics.csv")
            epochs = [int(r["epoch"]) for r in rows]
            left = [p.name for p in (dirs[run] / "checkpoints").iterdir()
                    if p.name.startswith("mid_level")]
            log(f"resume run {run}: level-1 CSV epochs {epochs}, mid-level files left {left}")
            if epochs != [0, 1, 2] or left:
                raise AssertionError(f"run {run}: epochs {epochs}, slot files {left}")
        rows = _read_csv(dirs["a"] / "metrics" / "level_wise_metrics" / "level_0_metrics.csv")
        epoch_s = statistics.median(float(r["epoch_seconds"]) for r in rows)
        save = statistics.median(save_ms)
        full_epoch_s = epoch_s / RESUME_EPOCH_STEPS * FULL_EPOCH_STEPS
        log(f"resume slot: {rec['slot_bytes']} bytes on disk ({rec['mask_bytes']} mask bits "
            f"packed to {sum((m.numel() + 7) // 8 for m in rec['at_save']['masks'].values())} "
            f"bytes); the same tree with raw bool masks {rec['raw_bytes']} bytes; save "
            f"{save:.1f} ms (median of {len(save_ms)} in runs a and a': device to host, "
            f"torch.save, header), restore {rec['restore_ms']:.1f} ms (torch.load, "
            f"load_state_dict, to the card); a save is {save / 1e3 / epoch_s * 100:.1f}% of "
            f"this run's {RESUME_EPOCH_STEPS}-step epoch ({epoch_s:.3f} s, train only) and "
            f"{save / 1e3 / full_epoch_s * 100:.2f}% of a {FULL_EPOCH_STEPS}-step epoch at its "
            f"step rate ({full_epoch_s:.2f} s)")
    log(f"resume phase: {time.perf_counter() - t_phase:.1f} s")
    return {"save_ms": save, "restore_ms": rec["restore_ms"], "slot_bytes": rec["slot_bytes"]}


# ---------------------------------------------------------------- phase 7
# The cyclic driver: DeiT-Small/16 @ 224 at its published width, flash
# attention, batch 256, 4 cycles of 1 epoch a level (ct_constant_4), two
# steps an epoch (so each cycle's lr shows its warm-up: 0.2 x lr, then lr),
# 256 test images; the ladder [1.0, 0.8].
CYCLIC_ARGS = [
    "--config-name=imagenet_imp",
    "cyclic_training=ct_constant_4",
    "model_params=mp_deit_small",
    "model_params.attention_impl=flash",
    "dataset_params.dataloader_type=synthetic",
    "dataset_params.total_batch_size=256",
    "dataset_params.synthetic_num_train=1024",
    "dataset_params.synthetic_num_test=256",
    "experiment_params.epochs_per_level=4",
    "experiment_params.max_steps_per_epoch=2",
    "pruning_params.target_sparsity=0.2",
]
CYCLES = 4
CYCLIC_STEPS = 2 * CYCLES * 2           # two levels, 2 steps a cycle


def phase_cyclic() -> dict:
    from unittest import mock

    import torch

    import run_cyclic_training_experiment_torch
    from turboprune_tpu_torch import driver
    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.harness import CyclicPruningHarness
    from turboprune_tpu_torch.ops import flash, masking
    from turboprune_tpu_torch.train import create_schedule
    from turboprune_tpu_torch.utils import MODEL_INIT, ExperimentCheckpoints

    counters = (flash.flash_fwd_cuda, flash.flash_bwd_dq_cuda, flash.flash_bwd_dkv_cuda)
    rec: dict = {"cycles": [], "steps": 0, "evals": 0, "init_before_step": None}

    class Recorded(CyclicPruningHarness):
        """Records each cycle's budget and per-step lr, the eval batches,
        and whether model_init was on disk at the first step."""

        def setup_level(self, epochs):
            super().setup_level(epochs)
            cycle = {"epochs": epochs, "steps_per_epoch": self.steps_per_epoch, "lrs": []}
            rec["cycles"].append(cycle)
            step = self._train_step

            def recorded(state, batch):
                if rec["init_before_step"] is None:
                    rec["init_before_step"] = self.ckpts.has_model(MODEL_INIT)
                out = step(state, batch)
                cycle["lrs"].append(state.optimizer.param_groups[0]["lr"])
                rec["steps"] += 1
                return out

            self._train_step = recorded

        def evaluate(self):
            rec["evals"] += len(self.loaders.test_loader)
            return super().evaluate()

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cyclic_") as base:
        # ---- the main path, with every count at 0 just before it
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(driver, "CyclicPruningHarness", Recorded):
            rc = run_cyclic_training_experiment_torch.main(
                ["--device", "cuda", *CYCLIC_ARGS, f"experiment_params.base_dir={base}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        # ---- end of the main path
        log(f"cyclic: run_cyclic_training_experiment_torch main -> {rc} in {wall:.1f} s; "
            f"{rec['steps']} train steps, {rec['evals']} eval batches; launches {launches}")
        if rc != 0:
            raise AssertionError(f"cyclic main returned {rc}")
        (expt,) = list(Path(base).iterdir())
        op = compose("imagenet_imp", CYCLIC_ARGS[1:]).optimizer_params
        # Level 0 builds one optimizer before its cycles, for the init saves.
        cycles = rec["cycles"][1:]
        bad_lr = []
        for i, cycle in enumerate(cycles):
            schedule = create_schedule(op.scheduler_type, base_lr=op.lr, epochs=cycle["epochs"],
                                       steps_per_epoch=cycle["steps_per_epoch"],
                                       warmup_fraction=op.warmup_fraction)
            want = [schedule(s) for s in range(cycle["epochs"] * cycle["steps_per_epoch"])]
            if cycle["lrs"] != want:
                bad_lr.append((i, cycle["lrs"], want))
        log(f"cyclic lr per cycle (level 0 then 1): "
            + "; ".join(str(c["lrs"]) for c in cycles)
            + f"; each equal to a fresh create_schedule from step 0: {not bad_lr}")
        if len(cycles) != 2 * CYCLES or bad_lr or rec["cycles"][0]["lrs"]:
            raise AssertionError(f"cycle learning rates {bad_lr or rec['cycles']}")
        for level in (0, 1):
            rows = _read_csv(expt / "metrics" / "level_wise_metrics" / f"level_{level}_metrics.csv")
            got = sorted({int(r["cycle"]) for r in rows})
            losses = [float(r[k]) for r in rows for k in ("train_loss", "test_loss")]
            log(f"cyclic level {level}: cycles {got}, train_loss "
                + ", ".join(f"{float(r['train_loss']):.4f}" for r in rows))
            if got != list(range(CYCLES)) or not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"level {level}: cycles {got}, losses {losses}")
        ckpts = ExperimentCheckpoints(expt)
        level0, level1 = ckpts.load_level(0), ckpts.load_level(1)
        d0, d1 = (masking.overall_density(level0["masks"]),
                  masking.overall_density(level1["masks"]))
        n = masking.num_prunable(level1["masks"])
        exact, ladder = _mag_ladder(level0, level1)
        log(f"cyclic densities {d0:.6f} / {d1:.6f} over {n} ({ladder}); model_init on disk "
            f"before the first step: {rec['init_before_step']}")
        if d0 != 1.0 or not exact or not rec["init_before_step"]:
            raise AssertionError("cyclic densities or the model_init save are wrong")
        expect = {"flash_fwd_cuda": DEPTH * (rec["steps"] + rec["evals"]),
                  "flash_bwd_dq_cuda": DEPTH * rec["steps"],
                  "flash_bwd_dkv_cuda": DEPTH * rec["steps"]}
        if rec["steps"] != CYCLIC_STEPS or launches != expect:
            raise AssertionError(f"kernel launches {launches}, expected {expect}")
    log(f"cyclic phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


# ---------------------------------------------------------------- phase 8
# The compiled step (model_params.use_compile=true): the masked forward, the
# loss and the metric sums under torch.compile(fullgraph=True), inductor with
# CUDA graphs, the backward from AOTAutograd, the optimizer step eager.
# ResNet-18: cifar10_imp as the resnet phase runs it (the same cuts), plus
# use_compile. DeiT-Small/16: the train phase's configuration, plus
# use_compile (2 levels of 4 steps, 2 eval batches a level).
COMPILE_RESNET_OVERRIDES = RESNET_OVERRIDES + ["pruning_params.target_sparsity=0.2",
                                               "model_params.use_compile=true"]
COMPILE_TRAIN_OVERRIDES = TRAIN_OVERRIDES + ["model_params.use_compile=true"]
# One bf16 step, compiled against eager, from the same weights on the same
# batch: inductor fuses the casts and reorders the reductions, so the two
# round at other places. Each is held to the fp32 gradient of the same
# step: the compiled one within twice the eager one's distance, plus 1e-3
# of the fp32 gradient's norm, the fp32 noise of a train-mode BatchNorm's
# scale and bias gradients (~1e-3 of their norm against
# float64); the median over tensors within twice eager's.
GRAD_COMPILED_FACTOR = 2.0
GRAD_COMPILED_FLOOR = 1e-3
PROFILED_STEPS = 3


def _check_compiled_grads(tag: str, compiled: dict, eager: dict, ref: dict) -> None:
    """The bf16 compiled step's gradient against the fp32 one, as the eager
    bf16 step's is (GRAD_COMPILED_* above)."""
    w_c, w_e = _whole_rel(compiled, ref), _whole_rel(eager, ref)
    m_c = statistics.median(_rel(compiled, ref).values())
    m_e = statistics.median(_rel(eager, ref).values())
    limit = GRAD_COMPILED_FACTOR * w_e + GRAD_COMPILED_FLOOR
    finite = all(bool(g.isfinite().all()) for g in compiled.values())
    log(f"{tag} grads bfloat16 compiled vs eager, against the fp32 gradient: whole "
        f"||G - G_fp32|| / ||G_fp32|| compiled {w_c:.3e}, eager {w_e:.3e} (compiled's limit "
        f"{limit:.3e}); per tensor median compiled {m_c:.3e}, eager {m_e:.3e} (limit "
        f"{GRAD_COMPILED_FACTOR:g} x eager's); compiled vs eager whole "
        f"{_whole_rel(compiled, eager):.3e}; finite={finite}")
    if not finite or w_c > limit or m_c > GRAD_COMPILED_FACTOR * m_e:
        raise AssertionError(f"{tag}: the compiled bf16 gradient disagrees with eager's")


def _compile_stages(top: int = 8) -> str:
    """The ``top`` largest of dynamo's and inductor's timed compile stages
    so far in this process, in seconds summed over every compile."""
    from torch._dynamo.utils import compile_times

    names, values = compile_times(repr="csv", aggregate=True)
    stages = sorted(zip(names, map(float, values)), key=lambda kv: -kv[1])[:top]
    return "; ".join(f"{name} {sec:.1f}" for name, sec in stages)


def _kinds(kernels: list) -> dict:
    """Device ms per step and kernel names by kind (``_kernel_kind``)."""
    kinds: dict = {}
    for name, ms in kernels:
        kind = kinds.setdefault(_kernel_kind(name), [0.0, 0])
        kind[0] += ms
        kind[1] += 1
    return kinds


def _kinds_line(kinds: dict) -> str:
    return "; ".join(f"{k} {ms:.3f} ({n} kernel names)"
                     for k, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]))


def phase_compile(resnet_eager: dict, train_eager: dict) -> dict:
    import torch
    from torch._dynamo.utils import counters
    from torch.profiler import ProfilerActivity, profile

    import run_experiment_torch
    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.data.augment import CIFAR10_MEAN, CIFAR10_STD, normalize_uint8
    from turboprune_tpu_torch.data.synthetic import synthetic_arrays
    from turboprune_tpu_torch.harness import PruningHarness
    from turboprune_tpu_torch.models import create_model
    from turboprune_tpu_torch.ops import flash, masking
    from turboprune_tpu_torch.train import mark_buffers_static
    from turboprune_tpu_torch.utils import ExperimentCheckpoints

    cuda = torch.device("cuda")
    launch_counters = (flash.flash_fwd_cuda, flash.flash_bwd_dq_cuda, flash.flash_bwd_dkv_cuda)
    skips_before = counters["inductor"]["cudagraph_skips"]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_compile_") as base:
        # ---- ResNet-18 IMP, compiled: the main path, counts at 0 just before
        recorder = _Recorder()
        for c in launch_counters:
            c.launches = 0
        rc, expt, wall = _run_config(
            "cifar10_imp", COMPILE_RESNET_OVERRIDES + [f"experiment_params.base_dir={base}/imp"],
            recorder)
        launches = {c.__name__: c.launches for c in launch_counters}
        # ---- end of the main path
        skips = counters["inductor"]["cudagraph_skips"] - skips_before
        log(f"compile resnet imp: run_experiment_torch main --config-name=cifar10_imp "
            f"model_params.use_compile=true -> {rc} in {wall:.1f} s (compiles, data "
            f"generation, init, checkpoints included; the eager resnet phase's run "
            f"{resnet_eager['wall_s']:.1f} s); K1/K2/K3 launches {launches}; dynamo graphs "
            f"after level 0 {recorder.graphs.get(0)}, after level 1 {recorder.graphs.get(1)}; "
            f"inductor cudagraph skips {skips}")
        if (rc != 0 or any(launches.values()) or skips
                or recorder.graphs.get(1) != recorder.graphs.get(0)):
            raise AssertionError("compiled cifar10_imp: rc, launches, a recompile at level 1 "
                                 "or a CUDA-graph skip")
        rows, level1 = _check_imp_run("compile resnet imp", expt, recorder)
        img_s = [float(r["samples_per_sec"]) for r in rows]
        log(f"compile resnet seconds: first train step {recorder.first_step_s:.2f} s (dynamo "
            f"and inductor compile of forward and backward, CUDA-graph warm-up included), "
            f"evaluations {', '.join(f'{t:.2f}' for t in recorder.eval_s)} s (the first "
            f"compiles the eval graph); img/s per IMP epoch compiled "
            f"{img_s[0]:.1f} (compiles included) / {img_s[1]:.1f}, eager "
            + " / ".join(f"{v:.1f}" for v in resnet_eager["img_s"]))

        log(f"compile resnet compile seconds by stage (torch._dynamo compile_times, summed, "
            f"largest first): {_compile_stages()}")

        # ---- the compiled bf16 step at batch 512: time and device work
        harness = PruningHarness(
            compose("cifar10_imp", RESNET_OVERRIDES[:1] + [
                "dataset_params.synthetic_num_train=512",
                "dataset_params.synthetic_num_test=512",
                "model_params.use_compile=true",
                f"experiment_params.base_dir={base}/timing"]),
            ("", str(Path(base) / "timing")), device="cuda")
        harness.setup_level(1)
        batch = next(iter(harness.loaders.train_loader))

        def step():
            return harness._train_step(harness.state, batch)

        step_ms = _call_ms(step, reps=5, warmup=3)
        busy_ms, _, kernels = _device_busy_ms(step, reps=PROFILED_STEPS, inference=False,
                                              top=None)
        kinds = _kinds(kernels)
        idle = max(0.0, 1 - busy_ms / step_ms) * 100 if busy_ms else float("nan")
        e = resnet_eager
        log(f"compile resnet train step (ResNet-18 CIFAR, batch {RESNET_BATCH}, bf16): "
            f"{step_ms:.3f} ms (CUDA events around one step, host work included, median of 5; "
            f"eager {e['step_ms']:.3f}); device busy {busy_ms:.3f} ms per step (torch.profiler, "
            f"{PROFILED_STEPS} replayed steps; eager {e['busy_ms']:.3f}), idle {idle:.1f}% "
            f"(eager {max(0.0, 1 - e['busy_ms'] / e['step_ms']) * 100:.1f}%); "
            f"{RESNET_BATCH / step_ms * 1e3:.0f} img/s by step time")
        log(f"compile resnet train step device time by kind (ms per step): {_kinds_line(kinds)}; "
            f"eager: {_kinds_line(e['kinds'])}")
        if kernels:
            log("compile resnet train step top device kernels (ms per step): "
                + "; ".join(f"{name} {ms:.3f}" for name, ms in kernels[:5]))

        # ---- one step compiled against eager: bf16 at batch 512 ...
        weights = {k: v.detach().clone() for k, v in harness.state.model.state_dict().items()}
        masks = {p: m.to(cuda) for p, m in level1["masks"].items()}

        def resnet(dtype):
            model = create_model("resnet18", 10, "CIFAR10", compute_dtype=dtype).to(cuda)
            model.load_state_dict(weights)
            return model

        ref = _grads(resnet(torch.float32), masks, *batch)
        eager16 = _grads(resnet(torch.bfloat16), masks, *batch)
        model = resnet(torch.bfloat16)
        mark_buffers_static(model)
        compiled16 = _grads(model, masks, *batch, forward=harness._train_forward)
        _check_compiled_grads(f"compile resnet batch {RESNET_BATCH}", compiled16, eager16, ref)
        del ref, eager16, compiled16, model, harness
        # ... and fp32 at batch 32 beside the CPU and float64, TF32 off
        _card_vs_cpu(resnet_eager["masks"], compiled=True)

        # ---- DeiT-Small/16 with flash, compiled: the main path, counts at 0;
        # the profiler counts the kernels' launches (CUDA-graph replays run no
        # Python, so the wrappers' counters see eager, warm-up and recording
        # calls only)
        for c in launch_counters:
            c.launches = 0
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rc = run_experiment_torch.main(
                ["--device", "cuda", "--config-name=imagenet_imp", *COMPILE_TRAIN_OVERRIDES,
                 f"experiment_params.base_dir={base}/deit"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in launch_counters}
        # ---- end of the main path
        device_launches = {name: sum(ev.count for ev in prof.key_averages()
                                     if name in ev.key
                                     and ev.device_type == torch.autograd.DeviceType.CUDA)
                           for name in KERNEL_NAMES}
        del prof
        skips = counters["inductor"]["cudagraph_skips"] - skips_before
        expect = dict(zip(KERNEL_NAMES, (DEPTH * (TRAIN_STEPS + EVAL_BATCHES),
                                         DEPTH * TRAIN_STEPS, DEPTH * TRAIN_STEPS)))
        log(f"compile deit: run_experiment_torch main --config-name=imagenet_imp (DeiT-Small/16, "
            f"flash, batch 256, use_compile) -> {rc} in {wall:.1f} s (compiles included); "
            f"kernel launches on the device (torch.profiler) {device_launches} (expected "
            f"{expect}: 12 per forward, {TRAIN_STEPS} steps and {EVAL_BATCHES} eval batches); "
            f"the wrappers' counters {launches} (eager, warm-up and recording calls); "
            f"cudagraph skips {skips}")
        if rc != 0 or device_launches != expect or skips:
            raise AssertionError("compiled DeiT: rc, kernel launches or a CUDA-graph skip")
        log(f"compile deit compile seconds by stage (since the process began): "
            f"{_compile_stages()}")
        (dexpt,) = [d for d in (Path(base) / "deit").iterdir() if d.is_dir()]
        ckpts = ExperimentCheckpoints(dexpt)
        level0, dlevel1 = ckpts.load_level(0), ckpts.load_level(1)
        d0 = masking.overall_density(level0["masks"])
        d1 = masking.overall_density(dlevel1["masks"])
        n = masking.num_prunable(dlevel1["masks"])
        losses = [float(r[k]) for lvl in (0, 1) for r in _read_csv(
            dexpt / "metrics" / "level_wise_metrics" / f"level_{lvl}_metrics.csv")
            for k in ("train_loss", "test_loss")]
        exact, ladder = _mag_ladder(level0, dlevel1)
        log(f"compile deit: densities {d0:.6f} / {d1:.6f} over {n} ({ladder}); losses {losses}")
        if d0 != 1.0 or not exact or not all(map(math.isfinite, losses)):
            raise AssertionError("compiled DeiT: densities or losses are wrong")

        # ---- the compiled DeiT step: time, device work, launches per replay
        harness = PruningHarness(
            compose("imagenet_imp", COMPILE_TRAIN_OVERRIDES + [
                "dataset_params.synthetic_num_train=256",
                "dataset_params.synthetic_num_test=256"]),
            ("", str(Path(base) / "deit_timing")), device="cuda")
        harness.setup_level(1)
        batch = next(iter(harness.loaders.train_loader))

        def deit_step():
            return harness._train_step(harness.state, batch)

        deit_ms = _call_ms(deit_step, reps=5, warmup=3)
        per_replay: dict = {}
        deit_busy, ours, top = _device_busy_ms(deit_step, reps=PROFILED_STEPS, inference=False,
                                               counts=per_replay)
        t = train_eager
        log(f"compile deit train step (DeiT-Small/16 @ 224, batch 256, bf16, flash): "
            f"{deit_ms:.3f} ms (CUDA events, median of 5; eager {t['step_ms']:.3f}); device "
            f"busy {deit_busy:.3f} ms per step ({PROFILED_STEPS} replayed steps; eager "
            f"{t['busy_ms']:.3f}, compiled / eager {deit_busy / t['busy_ms']:.3f}), idle "
            f"{max(0.0, 1 - deit_busy / deit_ms) * 100:.1f}% (eager "
            f"{max(0.0, 1 - t['busy_ms'] / t['step_ms']) * 100:.1f}%); "
            f"{256 / deit_ms * 1e3:.0f} img/s by step time; K1+K2+K3 "
            f"{sum(ours.values()):.3f} ms; launches in {PROFILED_STEPS} replayed steps "
            f"{per_replay}")
        if top:
            log("compile deit train step top device kernels (ms per step): "
                + "; ".join(f"{name} {ms:.3f}" for name, ms in top))
        if per_replay != dict.fromkeys(KERNEL_NAMES, DEPTH * PROFILED_STEPS):
            raise AssertionError(f"K1/K2/K3 per replayed step {per_replay}, expected "
                                 f"{DEPTH} each")

        # ---- one DeiT step compiled against eager, level 1's weights and
        # masks, the train phase's batch
        cfg = compose("imagenet_imp", COMPILE_TRAIN_OVERRIDES)
        x, y = synthetic_arrays(256, 224, 1000, seed=7)
        images = normalize_uint8(torch.from_numpy(x).to(cuda), CIFAR10_MEAN, CIFAR10_STD)
        labels = torch.from_numpy(y).long().to(cuda)
        masks = {p: m.to(cuda) for p, m in dlevel1["masks"].items()}

        def deit(impl, dtype):
            model = create_model(cfg.model_params.model_name, 1000, "ImageNet",
                                 compute_dtype=dtype, attention_impl=impl, image_size=224)
            model.load_state_dict(dlevel1["params"])
            return model.to(cuda)

        ref = _grads(deit("dense", torch.float32), masks, images, labels)
        eager16 = _grads(deit("flash", torch.bfloat16), masks, images, labels)
        compiled16 = _grads(deit("flash", torch.bfloat16), masks, images, labels,
                            forward=harness._train_forward)
        _check_compiled_grads("compile deit batch 256", compiled16, eager16, ref)
        del ref, eager16, compiled16, harness
    from torch._inductor.async_compile import shutdown_compile_workers

    shutdown_compile_workers()
    log(f"compile phase: {time.perf_counter() - t_phase:.1f} s")
    return {"device_launches": device_launches}


# ---------------------------------------------------------------- phase 9
# ImageNet fed by the .tpk loader: conf/imagenet_imp_tpk.yaml as shipped
# (ResNet-50 with the ImageNet stem at 224 x 224, 1000 classes, bf16, SGD lr
# 0.2, triangular schedule, IMP, scan_chunk_steps 8, prefetch_depth 4,
# decode_workers 2). Cut: the data (seeded images the phase packs itself),
# one epoch of 8 steps a level, two levels, and the batch where the card's
# memory forces it: the shipped 512 is the global batch of the reference's
# 8 GPUs, so the phase measures the peak at 64 and 128 and runs the largest
# of 512, 256 and 128 whose predicted peak, the prefetch queue's device
# batches included, stays within 90% of the card's memory.
IMAGENET_STEPS = 8
IMAGENET_BATCHES = (512, 256, 128)
IMAGENET_PROBE = (64, 128)
IMAGENET_MEMORY_SHARE = 0.9
IMAGENET_DISTINCT = 16
IMAGENET_SIZES = ((500, 375), (375, 500))   # ImageNet's most common shapes
IMAGENET_NORM_TOL = 1e-6                     # normalised batch vs the CPU's
IMAGENET_RATE_BATCHES = 2                    # batches per host decode-rate reading


def _probe_answers() -> list[str]:
    """What the card's machine offers the .tpk reader and the grain loader."""
    import importlib.util
    import os
    import shutil

    from turboprune_tpu_torch.data import native

    ld = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
    libs = [line.strip().split(" ")[0] for line in ld.splitlines() if "jpeg" in line]
    try:
        import PIL

        pil = f"Pillow {PIL.__version__}"
    except ImportError:
        pil = "no Pillow"
    grain = importlib.util.find_spec("grain") is not None
    disk = shutil.disk_usage(tempfile.gettempdir())
    return [
        f"/usr/include/jpeglib.h exists: {Path('/usr/include/jpeglib.h').exists()}; "
        f"g++ finds <jpeglib.h>: {native.jpeg_header_found()}",
        f"ldconfig -p | grep jpeg: {libs or 'nothing'}",
        f"import PIL: {pil}; import grain: {'works' if grain else 'no module named grain'}",
        f"nproc {os.cpu_count()}; {tempfile.gettempdir()}: {disk.free / 1e9:.1f} GB free "
        f"of {disk.total / 1e9:.1f} GB",
    ]


def _imagenet_jpegs(seed: int = 0) -> list[bytes]:
    """IMAGENET_DISTINCT JPEGs encoded with Pillow from seeded images at
    ImageNet's common sizes: smooth colour fields with a little noise."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    blobs = []
    for i in range(IMAGENET_DISTINCT):
        w, h = IMAGENET_SIZES[i % len(IMAGENET_SIZES)]
        low = rng.integers(0, 256, size=(h // 16, w // 16, 3), dtype=np.uint8)
        arr = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR), np.int16)
        arr = np.clip(arr + rng.integers(-8, 9, size=arr.shape), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=90)
        blobs.append(buf.getvalue())
    return blobs


def _raw_images(blobs: list, n: int, size: int = 224) -> np.ndarray:
    """``n`` raw samples from the JPEGs: each decoded by Pillow, its center
    square resized to ``size``, taken in turn, with the sample's index
    written into its first two bytes so that no two samples are alike."""
    import io

    from PIL import Image

    base = []
    for blob in blobs:
        img = Image.open(io.BytesIO(blob)).convert("RGB")
        w, h = img.size
        s = min(w, h)
        box = ((w - s) // 2, (h - s) // 2, (w - s) // 2 + s, (h - s) // 2 + s)
        base.append(np.asarray(img.resize((size, size), Image.BILINEAR, box=box), np.uint8))
    images = np.stack([base[i % len(base)] for i in range(n)])
    images[:, 0, 0, 0] = np.arange(n) % 256
    images[:, 0, 0, 1] = np.arange(n) // 256 % 256
    return images


def _u8_hash(images) -> "torch.Tensor":
    """A hash of a normalised batch's uint8 images, on the device: each
    pixel recovered exactly from its normalised value, then a weighted
    sum (int64) over positions."""
    import torch

    from turboprune_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD

    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    u8 = torch.round((images * std + mean) * 255.0).to(torch.int64).flatten()
    weights = torch.arange(u8.numel(), device=images.device) % 65521 + 1
    return (u8 * weights).sum()


def _busy_ms(prof) -> float:
    """Device busy time of a profiled window: the union of its kernels'
    intervals (both streams; copies and fills left out)."""
    import torch

    spans = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "Memcpy" not in e.name and "Memset" not in e.name):
            spans.append((e.time_range.start, e.time_range.end))
    busy, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy / 1e3


class _FeedRecorder(_Recorder):
    """``_Recorder`` plus, for each train step, a hash of its batch's uint8
    images (kept on the device until the run ends) and, with ``profiled``,
    for each train epoch, its device busy time from torch.profiler, the
    device time of its host-to-device copies (CUDA events around each
    ``DeviceTransfer.copy``, on the transfer's stream) and its peak
    memory."""

    def __init__(self, profiled: bool = True):
        super().__init__()
        self.profiled = profiled
        self.hashes = []
        self.epochs = []
        self.harness = None

    def harness_cls(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        base = super().harness_cls()
        recorder = self

        class Harness(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                recorder.harness = self

            def setup_level(self, epochs):
                super().setup_level(epochs)
                step = self._train_step

                def hashed(state, batch):
                    recorder.hashes.append(_u8_hash(batch[0]))
                    return step(state, batch)

                self._train_step = hashed

            def train_epoch(self):
                if not recorder.profiled:
                    row = super().train_epoch()
                    recorder.epochs.append(row)
                    return row
                from unittest import mock

                from turboprune_tpu_torch.data.pipeline import DeviceTransfer

                copies = []
                copy = DeviceTransfer.copy

                def timed_copy(transfer, batches, stacked):
                    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    a.record()
                    out = copy(transfer, batches, stacked)
                    b.record()
                    copies.append((a, b, len(batches)))
                    return out

                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with mock.patch.object(DeviceTransfer, "copy", timed_copy), profile(
                        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    row = super().train_epoch()
                    torch.cuda.synchronize()
                recorder.epochs.append({
                    **row, "busy_ms": _busy_ms(prof),
                    "h2d_ms": sum(a.elapsed_time(b) for a, b, _ in copies),
                    "h2d_batches": sum(n for _, _, n in copies),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
                return row

        return Harness


def _imagenet_overrides(train, val, batch, base, extra=()) -> list:
    """The only overrides of the phase's runs (``_run_config`` reads the
    base dir from the last)."""
    return [f"dataset_params.tpk_train_path={train}", f"dataset_params.tpk_val_path={val}",
            "dataset_params.tpk_auto_pack=false", "experiment_params.epochs_per_level=1",
            f"experiment_params.max_steps_per_epoch={IMAGENET_STEPS}",
            "pruning_params.target_sparsity=0.2", f"dataset_params.total_batch_size={batch}",
            *extra, f"experiment_params.base_dir={base}"]


def _peak_gb(batches: tuple, base: str, config: str = "imagenet_imp_tpk",
             extra: tuple = ()) -> dict:
    """Peak device memory of two eager train steps at each of ``batches``
    (``config``'s model, optimizer and step, bf16; slices of one synthetic
    batch)."""
    import gc

    import torch

    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.harness import PruningHarness

    n = max(batches)
    cfg = compose(config, [
        *extra, "dataset_params.dataloader_type=synthetic", f"dataset_params.total_batch_size={n}",
        f"dataset_params.synthetic_num_train={n}", f"dataset_params.synthetic_num_test={n}",
        f"experiment_params.base_dir={base}"])
    harness = PruningHarness(cfg, ("", f"{base}/probe"), device="cuda")
    harness.setup_level(1)
    images, labels = next(iter(harness.loaders.train_loader))
    peaks = {}
    for b in batches:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            harness._train_step(harness.state, (images[:b], labels[:b]))
        torch.cuda.synchronize()
        peaks[b] = torch.cuda.max_memory_allocated() / 1e9
    del harness, images, labels
    gc.collect()
    torch.cuda.empty_cache()
    return peaks


def _prefetch_gb(batch: int, cfg) -> float:
    """Device bytes the chunked prefetch can hold: the output queue's
    ``max(prefetch_depth, K)`` chunks, one in the transfer stage and one
    with the consumer, each K batches of fp32 images."""
    dp = cfg.dataset_params
    k = dp.scan_chunk_steps
    chunks = max(dp.prefetch_depth, k) + 2
    return chunks * k * batch * dp.image_size ** 2 * 3 * 4 / 1e9


def phase_imagenet(card: str) -> dict:
    import torch

    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.data import native
    from turboprune_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD, normalize_uint8
    from turboprune_tpu_torch.data.pipeline import DeviceTransfer
    from turboprune_tpu_torch.ops import flash

    t_phase = time.perf_counter()
    counters = (flash.flash_fwd_cuda, flash.flash_bwd_dq_cuda, flash.flash_bwd_dkv_cuda)
    # ---- build the reader from the checkout's source; the machine's answers
    t0 = time.perf_counter()
    lib = native.build_reader()
    has_jpeg = native.reader_has_jpeg()
    log(f"imagenet build: g++ csrc/tpkdata.cpp -> build/{lib.name} in "
        f"{time.perf_counter() - t0:.2f} s; JPEG decoder built in: {has_jpeg}")
    for line in _probe_answers():
        log(f"imagenet probe: {line}")
    cfg = compose("imagenet_imp_tpk", [])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_imagenet_") as base:
        # ---- the batch: the peak at 64 and 128, then the largest that fits
        peaks = _peak_gb(IMAGENET_PROBE, base)
        (b0, p0), (b1, p1) = sorted(peaks.items())
        per_image = (p1 - p0) / (b1 - b0)
        total = torch.cuda.get_device_properties(0).total_memory / 1e9
        predicted = {b: p0 + per_image * (b - b0) + _prefetch_gb(b, cfg)
                     for b in IMAGENET_BATCHES}
        fits = [b for b in IMAGENET_BATCHES if predicted[b] <= IMAGENET_MEMORY_SHARE * total]
        log("imagenet memory: peak of two eager bf16 ResNet-50 train steps "
            + ", ".join(f"{p:.2f} GB at batch {b}" for b, p in peaks.items())
            + f" ({per_image * 1e3:.1f} MB per image); predicted with the prefetch queue "
            + ", ".join(f"{predicted[b]:.1f} GB at {b}" for b in IMAGENET_BATCHES)
            + f" of the card's {total:.1f} GB (limit {IMAGENET_MEMORY_SHARE:.0%}) on {card}")
        if not fits:
            raise AssertionError("no batch of 512, 256, 128 fits the card")
        batch = fits[0]
        log(f"imagenet batch: {batch} (shipped: {cfg.dataset_params.total_batch_size}, the "
            f"global batch of 8 GPUs)")

        # ---- pack: JPEG .tpk files (ImageFolder val, repeated train), and
        # raw ones, which the training reads where the reader has no JPEG
        blobs = _imagenet_jpegs()
        n_train = (IMAGENET_STEPS + 1) * batch
        n_val = batch + batch // 2
        root = Path(base) / "data"
        for i, blob in enumerate(blobs):
            d = root / "val" / f"n{i % 2:08d}"
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{i}.JPEG").write_bytes(blob)
        t0 = time.perf_counter()
        labels = np.random.default_rng(1).integers(0, 1000, size=n_train).astype(np.int32)
        jpeg_train = native.write_tpk_jpegs(root / "train.tpk",
                                            [blobs[i % len(blobs)] for i in range(n_train)],
                                            labels)
        jpeg_val = native.pack_imagefolder(root / "val", root / "val.tpk")
        raw_train = native.write_tpk_raw(root / "train_raw.tpk", _raw_images(blobs, n_train),
                                         labels)
        raw_val = native.write_tpk_raw(
            root / "val_raw.tpk", _raw_images(blobs[::-1], n_val),
            np.random.default_rng(2).integers(0, 1000, size=n_val).astype(np.int32))
        log(f"imagenet pack: {len(blobs)} distinct JPEGs at {IMAGENET_SIZES} "
            f"({sum(map(len, blobs)) / len(blobs) / 1e3:.1f} kB each): train.tpk {n_train} "
            f"samples ({jpeg_train.stat().st_size / 1e6:.1f} MB), val.tpk (pack_imagefolder) "
            f"{len(blobs)}; raw at 224: {n_train} / {n_val} samples "
            f"({raw_train.stat().st_size / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s")
        train, val = (jpeg_train, jpeg_val) if has_jpeg else (raw_train, raw_val)
        if not has_jpeg:
            try:
                native.TpkFile(jpeg_train)
            except RuntimeError as e:
                refused = "jpeglib.h" in str(e)
            else:
                refused = False
            log("imagenet: JPEG decode was NOT run on the card: the reader was built "
                "without its JPEG decoder (no <jpeglib.h> on this machine); opening a "
                f"JPEG .tpk raises naming the header: {refused}; the training reads the "
                "raw .tpk")
            if not refused:
                raise AssertionError("a JPEG .tpk opened by a reader without JPEG")

        # ---- the host's decode rate at 224
        rate_idx = np.arange(IMAGENET_RATE_BATCHES * batch)
        rates = []
        f = native.TpkFile(train)
        for policy in ("train", "eval") if has_jpeg else ("raw",):
            for nthreads in (1, 0):
                t0 = time.perf_counter()
                if has_jpeg:
                    f.decode(rate_idx, 224, policy == "train", seed=1, nthreads=nthreads)
                else:
                    f.read_raw(rate_idx, nthreads=nthreads)
                dt = time.perf_counter() - t0
                rates.append(f"{policy} nthreads {nthreads or native._resolve_nthreads(0)}: "
                             f"{len(rate_idx) / dt:.0f} img/s")
        log(f"imagenet host decode rate at 224 ({'JPEG' if has_jpeg else 'raw read'}, "
            f"{len(rate_idx)} samples a reading): " + "; ".join(rates) + f" on {card}")

        # ---- a device batch against the reader's CPU read of its indices
        loader = native.TpkImageLoader(train, batch, train=True, image_size=224, seed=0,
                                       device="cuda")
        order = np.random.default_rng(0).permutation(
            native.make_shard(loader.file.num_samples, 0, 1))[:batch]
        ref_x, ref_y = (f.decode(order, 224, True, seed=0) if has_jpeg else f.read_raw(order))
        tasks, _ = loader.epoch_tasks()
        host = next(tasks)()
        u8, y8 = DeviceTransfer("cuda").copy([host], stacked=False)
        loader.epoch = 0
        stream = iter(loader)
        x, y = next(stream)
        stream.close()
        ref_norm = normalize_uint8(torch.from_numpy(ref_x), IMAGENET_MEAN, IMAGENET_STD)
        norm_err = float((x.cpu() - ref_norm).abs().max())
        same_u8 = bool(torch.equal(u8.cpu(), torch.from_numpy(ref_x)))
        same_y = bool(torch.equal(y8.cpu(), torch.from_numpy(ref_y))
                      and torch.equal(y.cpu(), torch.from_numpy(ref_y).long()))
        same_hash = int(_u8_hash(x)) == int(_u8_hash(ref_norm.cuda()))
        log(f"imagenet loader vs reader: epoch 0's first batch ({batch} samples) as uint8 on "
            f"the card equal to TpkFile's CPU read of the same indices: {same_u8}; labels: "
            f"{same_y}; normalised max |card - CPU| {norm_err:.2e} (limit "
            f"{IMAGENET_NORM_TOL:g}); uint8 recovered from it hashes alike: {same_hash}")
        if not (same_u8 and same_y and same_hash) or norm_err > IMAGENET_NORM_TOL:
            raise AssertionError("the loader's device batch differs from the reader's")
        del loader, x, y, u8, y8

        # ---- the main path: imagenet_imp_tpk, chunked as shipped, counts at 0 before
        rec = _FeedRecorder()
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rc, expt, wall = _run_config("imagenet_imp_tpk",
                                     _imagenet_overrides(train, val, batch, f"{base}/tpk"), rec)
        launches = {c.__name__: c.launches for c in counters}
        # ---- end of the main path
        run_peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"imagenet tpk: run_experiment_torch main --config-name=imagenet_imp_tpk -> {rc} "
            f"in {wall:.1f} s at batch {batch} (chunks of "
            f"{cfg.dataset_params.scan_chunk_steps}); K1/K2/K3 launches {launches} (the "
            "ResNet path runs none of them)")
        if rc != 0 or any(launches.values()):
            raise AssertionError(f"imagenet_imp_tpk returned {rc}, launches {launches}")
        _check_imp_run("imagenet tpk", expt, rec, IMAGENET_STEPS)
        del rec.harness

        # ---- chunked against unchunked, and against synthetic data
        flat = _FeedRecorder(profiled=False)
        rc1, _, wall1 = _run_config("imagenet_imp_tpk", _imagenet_overrides(
            train, val, batch, f"{base}/flat", ["dataset_params.scan_chunk_steps=1"]), flat)
        del flat.harness
        synth = _FeedRecorder()
        rc2, _, wall2 = _run_config("imagenet_imp_tpk", _imagenet_overrides(
            train, val, batch, f"{base}/synthetic", [
                "dataset_params.dataloader_type=synthetic",
                f"dataset_params.synthetic_num_train={IMAGENET_STEPS * batch}",
                f"dataset_params.synthetic_num_test={n_val}"]), synth)
        hashes = [int(h) for h in rec.hashes]
        same = hashes == [int(h) for h in flat.hashes]
        log(f"imagenet chunked vs unchunked: {len(hashes)} batches reached the step, each "
            f"with the same uint8 images (device hashes) with scan_chunk_steps "
            f"{cfg.dataset_params.scan_chunk_steps} and 1: {same}; "
            f"{len(set(hashes))} distinct; runs -> {rc1} in {wall1:.1f} s (not profiled), "
            f"synthetic -> {rc2} in {wall2:.1f} s")
        if rc1 or rc2 or not same or len(hashes) != 2 * IMAGENET_STEPS:
            raise AssertionError("chunked and unchunked epochs fed other batches")
        for level, (a, b, s) in enumerate(zip(rec.epochs, flat.epochs, synth.epochs)):
            wall_ms = a["epoch_seconds"] * 1e3
            log(f"imagenet epoch L{level} (batch {batch}, {IMAGENET_STEPS} steps): fed "
                f"{a['samples_per_sec']:.1f} img/s (tpk, chunks of "
                f"{cfg.dataset_params.scan_chunk_steps}), {b['samples_per_sec']:.1f} "
                f"(scan_chunk_steps 1), synthetic {s['samples_per_sec']:.1f} "
                f"({a['samples_per_sec'] / s['samples_per_sec']:.3f}x); waits decode "
                f"{a['decode_wait_s']:.3f} s, transfer {a['transfer_wait_s']:.3f} s, "
                f"consumer {a['consumer_wait_s']:.3f} s of the epoch's {wall_ms / 1e3:.3f} s; "
                f"H2D {a['h2d_ms'] / a['h2d_batches']:.3f} ms per batch ({a['h2d_batches']} "
                f"batches copied, CUDA events); device busy {a['busy_ms']:.1f} ms, idle "
                f"{max(0.0, 1 - a['busy_ms'] / wall_ms) * 100:.1f}% (synthetic "
                f"{max(0.0, 1 - s['busy_ms'] / (s['epoch_seconds'] * 1e3)) * 100:.1f}%; "
                f"torch.profiler); peak {a['peak_gb']:.2f} GB (synthetic "
                f"{s['peak_gb']:.2f}) on {card}")

        # ---- where a step's time goes (the synthetic run's harness and batch)
        harness = synth.harness
        step_batch = next(iter(harness.loaders.train_loader))

        def step():
            return harness._train_step(harness.state, step_batch)

        step_ms = _call_ms(step, reps=3, warmup=1)
        busy_ms, _, kernels = _device_busy_ms(step, reps=2, inference=False, top=None)
        kinds = _kinds(kernels)
        macs = _model_macs(harness.state.model, 224)
        bound_ms = 3 * 2 * macs * batch / PEAK_FLOPS["bfloat16"] * 1e3
        log(f"imagenet train step (ResNet-50, 224, batch {batch}, bf16, eager): {step_ms:.3f} ms "
            f"(CUDA events, median of 3), device busy {busy_ms:.3f} ms (torch.profiler, 2 "
            f"steps), FLOP bound {bound_ms:.3f} ms ({macs / 1e9:.4f} GMAC per image x 2 x 3 x "
            f"{batch} at 989 TFLOP/s); by kind: {_kinds_line(kinds)}; peak of the run "
            f"{run_peak:.2f} GB on {card}")
        synthetic = [(e["samples_per_sec"], max(0.0, 1 - e["busy_ms"] / (e["epoch_seconds"] * 1e3)))
                     for e in synth.epochs]
        del synth.harness, harness, step_batch
    log(f"imagenet phase: {time.perf_counter() - t_phase:.1f} s")
    return {"batch": batch, "synthetic": synthetic, "step_ms": step_ms}


# ---------------------------------------------------------------- phase 10
# conf/imagenet_imp.yaml and imagenet_er_balanced.yaml as shipped
# (dataloader_type: grain, 16 DataLoader workers, ResNet-50 at 224, bf16,
# scan_chunk_steps 8) from an ImageFolder of real JPEGs: the 16 seeded
# JPEGs of the imagenet phase, symlinked into (8 + 1) x batch train paths
# over 1000 class directories and a val split of 1.5 batches. Every batch
# the card trains on is decoded by Pillow in the loader's workers.
FOLDER_RATE_WORKERS = (1, 8, 16)
FOLDER_RATE_BATCH = 64              # each batch is one worker's: 3 per worker a reading
FOLDER_RESUME_BATCH = 64            # the resume trio's batch (its checks are exact)
FOLDER_MODEL_STEPS = 4
FOLDER_MODEL_BATCHES = (256, 128, 64)
FOLDER_MODEL_PROBE = (32, 64)
FOLDER_MODELS = ("mp_vgg16", "mp_densenet121")


def _image_folder(root: Path, blobs: list, n_train: int, n_val: int, classes: int = 1000):
    """ImageFolder splits under ``root``: ``classes`` class directories in
    each, ``n_train`` / ``n_val`` paths dealt over them in turn, each a
    symlink to one of ``blobs`` (written once under ``root/jpegs``)."""
    src = root / "jpegs"
    src.mkdir(parents=True)
    files = []
    for i, blob in enumerate(blobs):
        files.append(src / f"{i}.JPEG")
        files[-1].write_bytes(blob)
    for split, n in (("train", n_train), ("val", n_val)):
        for c in range(classes):
            (root / split / f"n{c:08d}").mkdir(parents=True)
        for j in range(n):
            (root / split / f"n{j % classes:08d}" / f"{j:07d}.JPEG").symlink_to(
                files[(j * 7 + (split == "val")) % len(files)])


def _folder_overrides(data, batch, base, extra=(), steps=IMAGENET_STEPS) -> list:
    """The only overrides of the phase's runs (``_run_config`` reads the
    base dir from the last); the IMP runs add the ladder [1.0, 0.8]."""
    return [f"dataset_params.data_root_dir={data}", "experiment_params.epochs_per_level=1",
            f"experiment_params.max_steps_per_epoch={steps}",
            f"dataset_params.total_batch_size={batch}", *extra,
            f"experiment_params.base_dir={base}"]


IMP_LADDER = "pruning_params.target_sparsity=0.2"


def _folder_rates(train_dir: Path, card: str) -> None:
    """Host decode rate at 224 (RandomResizedCrop and flip, Pillow in the
    loader's worker processes, collate, pinning) by worker count, after
    the first batch, and the workers' start-up (the time to that first
    batch: forking the workers, then one batch's decode by one of them),
    forked as shipped; and the start-up of 2 workers forked and started by
    forkserver (which imports torch anew in each)."""
    from turboprune_tpu_torch.data.imagenet import ImageFolderLoader

    def reading(workers, n, ctx="fork"):
        loader = ImageFolderLoader(str(train_dir), FOLDER_RATE_BATCH, True,
                                   num_workers=workers, seed=0, device="cuda", mp_context=ctx)
        t0 = time.perf_counter()
        tasks, count = loader.raw_batches(n)
        first = None
        for task in tasks:
            task()
            first = first or time.perf_counter() - t0
        dt = time.perf_counter() - t0
        loader.close()
        rate = (count - 1) * FOLDER_RATE_BATCH / (dt - first) if count > 1 else None
        return first, rate, count

    out = []
    for workers in FOLDER_RATE_WORKERS:
        first, rate, count = reading(workers, max(4, 3 * workers))
        out.append(f"{workers} worker(s): {rate:.0f} img/s after the first of {count} batches "
                   f"(first batch after {first:.2f} s)")
    starts = [f"{ctx} {reading(2, 1, ctx)[0]:.2f} s" for ctx in ("fork", "forkserver")]
    log(f"imagenet_folder host decode rate at 224 (batches of {FOLDER_RATE_BATCH}: Pillow "
        "decode, RandomResizedCrop, flip, collate, pin): " + "; ".join(out)
        + f"; {os.cpu_count()} cores; 2 workers' first batch (start-up): " + ", ".join(starts)
        + f" on {card}")


def _folder_batch_check(train_dir: Path, batch: int) -> None:
    """A device batch against the port's own CPU decode of the same stream
    positions: uint8 bit for bit, normalised within IMAGENET_NORM_TOL."""
    import torch

    from turboprune_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD, normalize_uint8
    from turboprune_tpu_torch.data.imagenet import ImageFolderLoader
    from turboprune_tpu_torch.data.index_shuffle import shuffled_positions
    from turboprune_tpu_torch.data.pipeline import DeviceTransfer

    loader = ImageFolderLoader(str(train_dir), batch, True, num_workers=16, seed=0, device="cuda")
    n = len(loader.source)
    positions = np.arange(batch)
    keys = shuffled_positions(positions, n, 0) % n
    items = [loader.dataset[(int(p), int(k))] for p, k in zip(positions, keys)]
    ref_x = torch.from_numpy(np.stack([img for img, _ in items]))
    ref_y = torch.tensor([y for _, y in items])
    tasks, _ = loader.raw_batches(1)
    host = next(tasks)()
    pinned = bool(host[0].is_pinned())
    u8, y8 = DeviceTransfer("cuda").copy([host], stacked=False)
    loader.position = 0
    stream = iter(loader)
    x, y = next(stream)
    stream.close()
    loader.close()
    ref_norm = normalize_uint8(ref_x, IMAGENET_MEAN, IMAGENET_STD)
    norm_err = float((x.cpu() - ref_norm).abs().max())
    same_u8 = bool(torch.equal(u8.cpu(), ref_x))
    same_y = bool(torch.equal(y8.cpu().long(), ref_y) and torch.equal(y.cpu(), ref_y))
    same_hash = int(_u8_hash(x)) == int(_u8_hash(ref_norm.cuda()))
    log(f"imagenet_folder loader vs CPU decode: stream positions 0..{batch - 1} (pinned host "
        f"batch: {pinned}) as uint8 on the card equal to StreamDataset's decode of the same "
        f"positions in this process: {same_u8}; labels: {same_y}; normalised max |card - CPU| "
        f"{norm_err:.2e} (limit {IMAGENET_NORM_TOL:g}); uint8 recovered hashes alike: "
        f"{same_hash}")
    if not (same_u8 and same_y and same_hash and pinned) or norm_err > IMAGENET_NORM_TOL:
        raise AssertionError("the ImageFolder loader's device batch differs from the CPU decode")


def _folder_resume(data: Path, base: str) -> None:
    """Tier 1 of the mid-level slot on the card: imagenet_imp (ResNet-50) at
    batch FOLDER_RESUME_BATCH, 2 epochs of 2 steps a level, the slot every
    epoch, 4 workers a split (forking 16 into this large process takes
    ~0.3 s each, and the check is of the stream, not of the decode rate);
    an uninterrupted run, a run preempted right after its level-1, epoch-0
    save, and its resume. The resumed run's batches (device hashes) equal
    the uninterrupted run's from the same epoch on."""
    from unittest import mock

    import run_experiment_torch
    from turboprune_tpu_torch import driver

    overrides = [f"dataset_params.data_root_dir={data}", "experiment_params.epochs_per_level=2",
                 "experiment_params.max_steps_per_epoch=2",
                 "experiment_params.checkpoint_every_epochs=1", IMP_LADDER,
                 f"dataset_params.total_batch_size={FOLDER_RESUME_BATCH}",
                 "dataset_params.num_workers=4"]
    runs: dict = {}
    tiers: list = []

    def harness_cls(name, preempt=False):
        from turboprune_tpu_torch.harness import PruningHarness

        class Harness(PruningHarness):
            def setup_level(self, epochs):
                super().setup_level(epochs)
                step = self._train_step

                def hashed(state, batch):
                    runs.setdefault(name, []).append(int(_u8_hash(batch[0])))
                    return step(state, batch)

                self._train_step = hashed

            def _save_mid_level(self, level, epoch, max_test_acc):
                super()._save_mid_level(level, epoch, max_test_acc)
                if preempt and (level, epoch) == (1, 0):
                    raise KeyboardInterrupt("simulated preemption after the level-1 save")

            def _restore_train_stream(self, mid, level):
                tiers.append(super()._restore_train_stream(mid, level))
                return tiers[-1]

        return Harness

    def main_with(name, base_dir, extra=(), preempt=False):
        with mock.patch.object(driver, "PruningHarness", harness_cls(name, preempt)):
            return run_experiment_torch.main(["--device", "cuda", "--config-name=imagenet_imp",
                                              *overrides, f"experiment_params.base_dir={base_dir}",
                                              *extra])

    t0 = time.perf_counter()
    walls = {}
    if main_with("a", f"{base}/a") != 0:
        raise AssertionError("the uninterrupted run failed")
    walls["a"] = time.perf_counter() - t0
    try:
        main_with("b", f"{base}/b", preempt=True)
    except KeyboardInterrupt:
        pass
    else:
        raise AssertionError("run b was not preempted")
    walls["b"] = time.perf_counter() - t0 - sum(walls.values())
    (expt,) = Path(f"{base}/b").iterdir()
    blob = (expt / "checkpoints" / "mid_level_stream_0").read_bytes()
    rc = main_with("r", f"{base}/b", [
        "experiment_params.resume_experiment=true",
        f"experiment_params.resume_experiment_stuff.resume_expt_name={expt.name}",
        "experiment_params.resume_experiment_stuff.resume_level=1"])
    walls["r"] = time.perf_counter() - t0 - sum(walls.values())
    a, b, r = runs["a"], runs["b"], runs["r"]
    # a: 2 levels x 2 epochs x 2 steps; b stopped after level 1's first epoch.
    same = rc == 0 and b == a[:6] and r == a[6:] and len(a) == 8
    log(f"imagenet_folder resume (tier 1): imagenet_imp at batch {FOLDER_RESUME_BATCH}, 4 "
        f"workers, 2 epochs of 2 steps a level: the slot's stream blob {len(blob)} bytes (tag "
        f"{int.from_bytes(blob[:8], 'big')}); the resume took tier {tiers}; resumed -> {rc}; "
        f"the preempted run's {len(b)} batches and the resumed run's {len(r)} equal the "
        f"uninterrupted run's {len(a)} (device hashes): {same}; seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    if not same or tiers != ["stream"]:
        raise AssertionError("the resumed run did not see the uninterrupted run's batches")


def _folder_model(model: str, data: Path, base: str, card: str) -> None:
    """``imagenet_imp model_params=<model>`` on the folder: the batch from
    the measured peak memory, two IMP levels of FOLDER_MODEL_STEPS steps,
    then one train step's time, device busy time by kind, FLOP bound and
    the run's peak memory."""
    import gc

    import torch

    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.ops import flash

    counters = (flash.flash_fwd_cuda, flash.flash_bwd_dq_cuda, flash.flash_bwd_dkv_cuda)
    extra = (f"model_params={model}",)
    cfg = compose("imagenet_imp", list(extra))
    name = cfg.model_params.model_name
    torch.cuda.empty_cache()
    peaks = _peak_gb(FOLDER_MODEL_PROBE, base, "imagenet_imp", extra)
    (b0, p0), (b1, p1) = sorted(peaks.items())
    per_image = (p1 - p0) / (b1 - b0)
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    predicted = {b: p0 + per_image * (b - b0) + _prefetch_gb(b, cfg) for b in FOLDER_MODEL_BATCHES}
    fits = [b for b in FOLDER_MODEL_BATCHES if predicted[b] <= IMAGENET_MEMORY_SHARE * total]
    log(f"imagenet_folder {name} memory: peak of two eager bf16 train steps "
        + ", ".join(f"{p:.2f} GB at batch {b}" for b, p in peaks.items())
        + f" ({per_image * 1e3:.1f} MB per image); predicted with the prefetch queue "
        + ", ".join(f"{predicted[b]:.1f} GB at {b}" for b in FOLDER_MODEL_BATCHES)
        + f" of {total:.1f} GB (limit {IMAGENET_MEMORY_SHARE:.0%}) -> batch "
        + f"{fits[0] if fits else None} on {card}")
    if not fits:
        raise AssertionError(f"no batch of {FOLDER_MODEL_BATCHES} fits {name}")
    batch = fits[0]
    rec = _FeedRecorder(profiled=False)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rc, expt, wall = _run_config("imagenet_imp", _folder_overrides(
        data, batch, f"{base}/{name}", [*extra, IMP_LADDER], steps=FOLDER_MODEL_STEPS), rec)
    launches = {c.__name__: c.launches for c in counters}
    run_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"imagenet_folder {name}: run_experiment_torch main --config-name=imagenet_imp "
        f"model_params={model} -> {rc} in {wall:.1f} s at batch {batch}, 2 levels of "
        f"{FOLDER_MODEL_STEPS} steps; K1/K2/K3 launches {launches}")
    if rc != 0 or any(launches.values()):
        raise AssertionError(f"{name} returned {rc}, launches {launches}")
    _check_imp_run(f"imagenet_folder {name}", expt, rec, FOLDER_MODEL_STEPS)
    harness = rec.harness
    # The step's time does not depend on the pixels: a batch made on the
    # card spares restarting the loader's workers (the run closed them).
    gen = torch.Generator(device="cuda").manual_seed(0)
    step_batch = (torch.randn(batch, 224, 224, 3, device="cuda", generator=gen),
                  torch.randint(0, 1000, (batch,), device="cuda", generator=gen))

    def step():
        return harness._train_step(harness.state, step_batch)

    step_ms = _call_ms(step, reps=3, warmup=1)
    busy_ms, _, kernels = _device_busy_ms(step, reps=2, inference=False, top=None)
    macs = _model_macs(harness.state.model, 224)
    bound_ms = 3 * 2 * macs * batch / PEAK_FLOPS["bfloat16"] * 1e3
    bn = sum(m.mean.numel() for m in harness.state.model.modules() if hasattr(m, "mean"))
    log(f"imagenet_folder {name} train step (224, batch {batch}, bf16, eager): {step_ms:.3f} ms "
        f"(CUDA events, median of 3), device busy {busy_ms:.3f} ms (torch.profiler, 2 steps), "
        f"idle {max(0.0, 1 - busy_ms / step_ms) * 100:.1f}%, FLOP bound {bound_ms:.3f} ms "
        f"({macs / 1e9:.4f} GMAC per image x 2 x 3 x {batch} at 989 TFLOP/s); by kind: "
        f"{_kinds_line(_kinds(kernels))}; {bn} BatchNorm channels; peak of the run "
        f"{run_peak:.2f} GB on {card}")
    del rec.harness, harness, step_batch
    gc.collect()
    torch.cuda.empty_cache()


def phase_imagenet_folder(card: str, imagenet: dict) -> dict:
    import torch

    from turboprune_tpu_torch.ops import flash

    t_phase = time.perf_counter()
    counters = (flash.flash_fwd_cuda, flash.flash_bwd_dq_cuda, flash.flash_bwd_dkv_cuda)
    batch = imagenet["batch"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_folder_") as base:
        data = Path(base) / "data"
        n_train, n_val = (IMAGENET_STEPS + 1) * batch, batch + batch // 2
        t0 = time.perf_counter()
        _image_folder(data, _imagenet_jpegs(), n_train, n_val)
        log(f"imagenet_folder data: {IMAGENET_DISTINCT} seeded JPEGs at {IMAGENET_SIZES} "
            f"(quality 90) symlinked into {n_train} train / {n_val} val paths over 1000 class "
            f"directories in {time.perf_counter() - t0:.1f} s")
        _folder_rates(data / "train", card)
        _folder_batch_check(data / "train", batch)

        # ---- the main path: imagenet_imp as shipped, counts at 0 before
        rec = _FeedRecorder()
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rc, expt, wall = _run_config("imagenet_imp", _folder_overrides(
            data, batch, f"{base}/imp", [IMP_LADDER]), rec)
        launches = {c.__name__: c.launches for c in counters}
        # ---- end of the main path
        log(f"imagenet_folder imp: run_experiment_torch main --config-name=imagenet_imp -> {rc} "
            f"in {wall:.1f} s at batch {batch} (grain's loader: 16 DataLoader workers, chunks "
            f"of 8); K1/K2/K3 launches {launches} (the ResNet path runs none of them)")
        if rc != 0 or any(launches.values()):
            raise AssertionError(f"imagenet_imp returned {rc}, launches {launches}")
        _check_imp_run("imagenet_folder imp", expt, rec, IMAGENET_STEPS)
        if len(set(int(h) for h in rec.hashes)) != 2 * IMAGENET_STEPS:
            raise AssertionError("imagenet_imp fed repeated batches")
        for level, (a, (s_rate, s_idle)) in enumerate(zip(rec.epochs, imagenet["synthetic"])):
            wall_ms = a["epoch_seconds"] * 1e3
            log(f"imagenet_folder epoch L{level} (batch {batch}, {IMAGENET_STEPS} steps): fed "
                f"{a['samples_per_sec']:.1f} img/s from JPEGs, synthetic "
                f"{s_rate:.1f} (the imagenet phase, same batch; "
                f"{a['samples_per_sec'] / s_rate:.3f}x); waits decode "
                f"{a['decode_wait_s']:.3f} s, transfer {a['transfer_wait_s']:.3f} s, consumer "
                f"{a['consumer_wait_s']:.3f} s of the epoch's {wall_ms / 1e3:.3f} s; H2D "
                f"{a['h2d_ms'] / a['h2d_batches']:.3f} ms per batch; device busy "
                f"{a['busy_ms']:.1f} ms, idle {max(0.0, 1 - a['busy_ms'] / wall_ms) * 100:.1f}% "
                f"(synthetic {s_idle * 100:.1f}%; torch.profiler); peak {a['peak_gb']:.2f} GB "
                f"on {card}")
        del rec.harness

        # ---- imagenet_er_balanced as shipped, at its density
        for c in counters:
            c.launches = 0
        rc, expt, wall = _run_config("imagenet_er_balanced", _folder_overrides(
            data, batch, f"{base}/er", steps=4))
        from turboprune_tpu_torch.ops import masking
        from turboprune_tpu_torch.utils import ExperimentCheckpoints

        masks = ExperimentCheckpoints(expt).load_level(0)["masks"]
        density = masking.overall_density(masks)
        rows = _read_csv(expt / "metrics" / "level_wise_metrics" / "level_0_metrics.csv")
        finite = all(math.isfinite(float(r[k])) for r in rows for k in ("train_loss", "test_loss"))
        launches = {c.__name__: c.launches for c in counters}
        log(f"imagenet_folder er_balanced: run_experiment_torch main "
            f"--config-name=imagenet_er_balanced -> {rc} in {wall:.1f} s (4 steps at batch "
            f"{batch}); density {density:.4f} (target 0.1, Bernoulli masks at the balanced "
            f"allocation); finite losses {finite}; K1/K2/K3 launches {launches}")
        if rc or not finite or abs(density - 0.1) > 0.005 or any(launches.values()):
            raise AssertionError("imagenet_er_balanced failed its checks")

        _folder_resume(data, base)
        for model in FOLDER_MODELS:
            _folder_model(model, data, base, card)
    log(f"imagenet_folder phase: {time.perf_counter() - t_phase:.1f} s")
    return {"batch": batch}


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
    bwd_timing = phase_backward_kernels()
    slice_out = phase_slice()
    train_out = phase_train()
    resnet_out = phase_resnet()
    phase_resume()
    cyclic_out = phase_cyclic()
    imagenet_out = phase_imagenet(card)
    phase_imagenet_folder(card, imagenet_out)
    compile_out = phase_compile(resnet_out, train_out)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s on {card}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_flash_ms")
    # Launches on the main paths: K1 in every forward, served, trained,
    # trained in cycles and trained compiled; K2/K3 in every training
    # backward. The wrappers count the eager paths; the profiler counts the
    # compiled one, whose CUDA-graph replays run no Python.
    compiled = dict(zip(("flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda"),
                        (compile_out["device_launches"][k] for k in KERNEL_NAMES)))
    trained = {k: train_out["launches"][k] + cyclic_out["launches"][k] + compiled[k]
               for k in train_out["launches"]}
    rows = [
        {**K1, "launches": slice_out["launches"] + trained["flash_fwd_cuda"],
         **{k: timing[k] for k in keys}},
        {**K2, "launches": trained["flash_bwd_dq_cuda"],
         **{k: bwd_timing["dq"][k] for k in keys}},
        {**K3, "launches": trained["flash_bwd_dkv_cuda"],
         **{k: bwd_timing["dkv"][k] for k in keys}},
    ]
    print(json.dumps({"kernels": rows}), flush=True)
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
