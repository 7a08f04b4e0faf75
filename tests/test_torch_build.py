"""The kernel builds' cache key (turboprune_tpu_torch/ops/build.py): a
build is keyed by its source, every shared header beside it and the
flags, so an edit to a header the kernels include rebuilds them instead of
loading a stale library. Checked on copies of csrc/ (no nvcc needed). Also:
every ablation of ablate_flash_fwd.py still patches csrc/flash_fwd.cu."""

import shutil

import pytest

import ablate_flash_fwd
from turboprune_tpu_torch.ops import build


def test_library_path_follows_the_shared_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["flash_common.cuh", "flash_mma.cuh"]
    before = {name: build.library_path(name, csrc) for name in ("flash_fwd", "flash_bwd")}
    assert before == {name: build.library_path(name) for name in before}

    header = csrc / "flash_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name, csrc) for name in before}
    assert all(after[name] != before[name] for name in before)

    # A new header counts too; an edit to one kernel's source moves only
    # that kernel's key.
    (csrc / "extra.cuh").write_text("#pragma once\n")
    moved = {name: build.library_path(name, csrc) for name in before}
    assert all(moved[name] != after[name] for name in before)
    src = csrc / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("flash_fwd", csrc) != moved["flash_fwd"]
    assert build.library_path("flash_bwd", csrc) == moved["flash_bwd"]


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z19flash_bwd_dq_kernelI13__nv_bfloat16EvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z19flash_bwd_dq_kernelI13__nv_bfloat16EvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_Z24flash_bwd_dq_kernel_fp32PKf' for 'sm_90a'
ptxas info    : Function properties for _Z24flash_bwd_dq_kernel_fp32PKf
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 424 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    assert build.parse_ptxas(PTXAS) == [
        {"kernel": "_Z19flash_bwd_dq_kernelI13__nv_bfloat16EvPKT_", "registers": 168,
         "spill": (0, 0)},
        {"kernel": "_Z24flash_bwd_dq_kernel_fp32PKf", "registers": 255, "spill": (12, 16)},
    ]
    assert build.report_path(build.library_path("flash_bwd")).name.endswith(".ptxas.txt")


@pytest.mark.parametrize("variant", ablate_flash_fwd.VARIANTS)
def test_every_ablation_patches_the_kernel_source(variant):
    source = ablate_flash_fwd.SOURCE.read_text()
    assert (ablate_flash_fwd.patched(variant, source) == source) == (variant == "base")


def test_an_ablation_that_no_longer_applies_raises():
    with pytest.raises(ValueError, match="exactly once"):
        ablate_flash_fwd.patched("ieee_div", "")
