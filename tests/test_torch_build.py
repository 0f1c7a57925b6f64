"""The kernel build's cache key, on the CPU (no nvcc needed).

A kernel's library is found by a hash of its source, the shared headers in
csrc/ and the flags. Editing a shared header must give every kernel a new
library path, or a stale library built from the old header would load.
"""
import shutil

import pytest

from lightgbm_torch.ops import build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setenv("LIGHTGBM_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return src


def test_every_kernel_has_a_source():
    for name in build.KERNELS:
        assert (build.CSRC / (name + ".cu")).is_file(), name
    assert set(build.KERNELS) == {"hist_window", "scan_pair", "root_hist",
                                  "split_pass", "seg_hist", "scan_blocks",
                                  "level_pass", "level_seg_hist",
                                  "grow_step", "valid_walk", "renew_leaf",
                                  "rank_grad", "cat_scan", "bag", "predict",
                                  "leaf_sums"}


@pytest.mark.parametrize("name", build.KERNELS)
def test_editing_a_header_changes_the_target(csrc_copy, name):
    before = build._target(name)
    assert before == build._target(name)          # stable
    assert before.parent == csrc_copy.parent / "build"
    header = csrc_copy / "payload_hist.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build._target(name) != before


def test_a_new_header_changes_the_target(csrc_copy):
    before = build._target("seg_hist")
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert build._target("seg_hist") != before


def test_editing_a_source_changes_only_its_target(csrc_copy):
    before = {n: build._target(n) for n in build.KERNELS}
    src = csrc_copy / "seg_hist.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: build._target(n) for n in build.KERNELS}
    assert [n for n in build.KERNELS if after[n] != before[n]] == ["seg_hist"]
