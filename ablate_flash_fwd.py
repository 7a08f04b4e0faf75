#!/usr/bin/env python3
"""Ablations of the 16-bit flash forward kernel K1 on one NVIDIA card.

    python3 ablate_flash_fwd.py [variant ...]

Each variant is turboprune_tpu_torch/csrc/flash_fwd.cu with one textual
patch. It either takes one piece of work out of the kernel (a product, a
load, a store), puts back an earlier form of a step (the select-based mask,
the IEEE division, two blocks per SM), or swaps the full-precision expf for
the fast one. Every variant is compiled with ops/build.py's nvcc flags into
build/ablate/ (one nvcc each, all started together). K1's bf16 time per
launch is then measured at the training shape [1536, 256, 64] with 1, 197
and 256 valid keys (a prefix), in two rounds, all in one process: device
time of 20 launches back to back between one pair of CUDA events, median of
5. A variant that removes work computes a wrong result: these are times,
not kernels, and none of them is used by the port. Prints the card, each
variant's ptxas registers and spills, and its times. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from turboprune_tpu_torch.ops import build

SOURCE = build.CSRC_DIR / "flash_fwd.cu"
OUT_DIR = build.BUILD_DIR / "ablate"
BH, SEQ, VALID_COUNTS = 256 * 6, 256, (1, 197, 256)


def _exp_lines(fmt: str) -> list[tuple[str, str]]:
    rows = [(0, 0), (1, 0), (2, 1), (3, 1)]  # (element, row of mn)
    return [(f"s[j][{e}] = expf(s[j][{e}] - mn{r});", fmt.format(e=e, r=r, v=e % 2))
            for e, r in rows]


# name -> (what it shows, [(text in the source, replacement), ...])
VARIANTS = {
    "base": ("the kernel as built", []),
    "select_mask": (
        "mask by two selects (score and p), as first written",
        [(f"s[j][{e}] = fmaf(s[j][{e}], scale, b{e % 2});",
          f"s[j][{e}] = (ok{e % 2} >> (2 * j)) & 1u ? s[j][{e}] * scale : NEG_BIG;")
         for e in range(4)]
        + _exp_lines("s[j][{e}] = (ok{v} >> (2 * j)) & 1u ? expf(s[j][{e}] - mn{r}) : 0.0f;"),
    ),
    "ieee_div": (
        "o = acc / l by 32 IEEE divisions a thread",
        [("quotient(acc[j][0], ls0, r0), quotient(acc[j][1], ls0, r0)",
          "acc[j][0] / ls0, acc[j][1] / ls0"),
         ("quotient(acc[j][2], ls1, r1), quotient(acc[j][3], ls1, r1)",
          "acc[j][2] / ls1, acc[j][3] / ls1")],
    ),
    "two_blocks_per_sm": (
        "launch bounds for 2 blocks (8 warps) per SM",
        [("__launch_bounds__(THREADS, 3)", "__launch_bounds__(THREADS, 2)")],
    ),
    "fast_exp": (
        "__expf instead of the full-precision expf (not the TPU's numerics)",
        _exp_lines("s[j][{e}] = __expf(s[j][{e}] - mn{r});"),
    ),
    "no_qk_mma": (
        "S = q k^T's mma.sync left out (ldmatrix kept)",
        [("      flash::mma16816<T>(s[2 * nj], a, b[0], b[1]);\n"
          "      flash::mma16816<T>(s[2 * nj + 1], a, b[2], b[3]);\n", "")],
    ),
    "no_pv_mma": (
        "PV's mma.sync left out (ldmatrix kept)",
        [("      flash::mma16816<T>(acc[2 * dn], a, b[0], b[1]);\n"
          "      flash::mma16816<T>(acc[2 * dn + 1], a, b[2], b[3]);\n", "")],
    ),
    "no_kv_load": (
        "no K/V copies into shared memory",
        [("k + base + (size_t)i * KT * D, ng)", "k + base + (size_t)i * KT * D, 0)"),
         ("v + base + (size_t)i * KT * D, ng)", "v + base + (size_t)i * KT * D, 0)")],
    ),
    "no_q_load": (
        "no q copy into shared memory",
        [("  copy_rows_async<T>(Qs, q + base + (size_t)q0 * D, QT / 16);", "")],
    ),
    "no_o_store": (
        "no o stores to device memory (lse kept)",
        [("    *reinterpret_cast<uint4*>(og + r * D + ch * 8) =",
          "    if (ch < 0) *reinterpret_cast<uint4*>(og + r * D + ch * 8) =")],
    ),
}


def patched(name: str, source: str | None = None) -> str:
    """The source of variant ``name``; raises if a patch no longer applies."""
    text = SOURCE.read_text() if source is None else source
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise ValueError(f"ablation {name}: {old!r} is not in flash_fwd.cu exactly once")
        text = text.replace(old, new)
    return text


def _compile(name: str) -> tuple[str, Path, list]:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = OUT_DIR / f"{name}.cu", OUT_DIR / f"lib{name}.so"
    src.write_text(patched(name))
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(lib),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise build.KernelBuildError(f"nvcc failed on ablation {name}:\n{proc.stderr}")
    kernels = [k for k in build.parse_ptxas(proc.stdout + proc.stderr)
               if "fp32" not in k["kernel"]]
    return name, lib, kernels


def _stream_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    import torch

    for _ in range(3):
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


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_flash_fwd: CUDA is not available", file=sys.stderr)
        return 2
    names = argv or list(VARIANTS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = list(pool.map(_compile, names))

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(BH, SEQ, 64, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    o = torch.empty_like(q)
    lse = torch.empty(BH, SEQ, 1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    libs = {}
    for name, path, _ in built:
        lib = ctypes.CDLL(str(path))
        lib.flash_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                                  + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        if lib.flash_fwd_prepare() != 0:
            raise RuntimeError(f"flash_fwd_prepare failed for ablation {name}")
        libs[name] = lib
    for rnd in range(2):
        for name, _, kernels in built:
            lib, times = libs[name], []
            for n_valid in VALID_COUNTS:
                valid = (torch.arange(SEQ, device="cuda") < n_valid).float()[None]

                def launch(lib=lib, valid=valid):
                    err = lib.flash_fwd(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        valid.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                        BH, SEQ, 64, 0.125, stream)
                    if err:
                        raise RuntimeError(f"ablation {name}: launch failed ({err})")

                times.append(f"valid={n_valid} {_stream_ms(launch):.4f} ms")
            regs = ", ".join(f"{kk['registers']} registers, spill {kk['spill']}"
                             for kk in kernels if "bfloat16" in kk["kernel"])
            print(f"round {rnd} {name}: {'; '.join(times)} ({regs}; "
                  f"{VARIANTS[name][0]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
