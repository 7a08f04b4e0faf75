"""The kernel builds' cache key (turboprune_tpu_torch/ops/build.py): a
build is keyed by its source, every shared header beside it and the
flags, so an edit to a header the kernels include rebuilds them instead of
loading a stale library. Checked on copies of csrc/ (no nvcc needed)."""

import shutil

from turboprune_tpu_torch.ops import build


def test_library_path_follows_the_shared_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["flash_common.cuh"]
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
