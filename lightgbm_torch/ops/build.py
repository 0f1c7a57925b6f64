"""Builds the port's CUDA kernels from the sources in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. A
library is built on first use, from the sources in the checkout only, into
a build directory keyed by a hash of the source, every shared header
(``csrc/*.cuh``) and the flags; a later process reuses it. Several kernels
are built in parallel, one ``nvcc`` per source, by :func:`build`.

The build directory is ``.cache/lightgbm_torch`` at the root of the
checkout, or ``$LIGHTGBM_TORCH_BUILD_DIR``. ``nvcc`` is found on ``PATH``
or under ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

from ..utils.log import LightGBMError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("hist_window", "scan_pair", "root_hist", "split_pass", "seg_hist",
           "scan_blocks", "level_pass", "level_seg_hist", "grow_step",
           "valid_walk", "renew_leaf", "rank_grad", "cat_scan", "bag",
           "predict", "leaf_sums")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("LIGHTGBM_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / ".cache" / "lightgbm_torch"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise LightGBMError("nvcc not found on PATH or under $CUDA_HOME/bin: "
                        "the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    """The library path of `name`: keyed by its source, every header in
    csrc/ (a kernel may include any of them) and the flags, so a change
    to a shared header rebuilds every kernel."""
    h = hashlib.sha256((CSRC / (name + ".cu")).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / ("%s-%s.so" % (name, h.hexdigest()[:16]))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together. Returns name -> library
    path. Raises with nvcc's output if any build fails."""
    names = list(KERNELS if names is None else names)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(".so.tmp%d" % os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (n + ".cu"))]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        out[n].with_suffix(".log").write_bytes(log)
        if p.returncode != 0:
            failed.append("%s:\n%s" % (n, log.decode(errors="replace")))
        else:
            os.replace(tmp, out[n])    # atomic: concurrent builders agree
    if failed:
        raise LightGBMError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (with ptxas register and shared-memory use) of the
    last build of `name`, or '' when it was built by another process."""
    log = _target(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""
