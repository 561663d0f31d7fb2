"""Build the port's CUDA sources into shared libraries at first use.

Each source under `pano_nerf_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into `build/pano_nerf_tpu_torch/` at the repository root
and loaded with `ctypes`. The library name carries a hash of the source
and of the shared headers (`csrc/*.cuh`), so an edited source or header is
rebuilt and a stale library is never loaded. Nothing
is compiled when a module is imported: the first launch on a CUDA tensor
builds, and a machine without `nvcc` raises there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pano_nerf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# Compiler output (ptxas register/spill report) and build seconds, by source.
BUILD_LOGS: Dict[str, Tuple[str, float]] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1((CSRC / source).read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


class PendingBuild(NamedTuple):
    source: str
    proc: subprocess.Popen
    tmp: Path
    start: float


def start_build(source: str) -> Optional[PendingBuild]:
    """Start compiling `source` unless its library is already built.

    Returns the running compiler, or None when nothing needs building.
    Several sources can be started together and awaited with
    `finish_build`, so their compiles run in parallel.
    """
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    start = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return PendingBuild(source, proc, tmp, start)


def finish_build(pending: Optional[PendingBuild]) -> None:
    """Wait for a build from `start_build`; raise with its log if it failed."""
    if pending is None:
        return
    log, _ = pending.proc.communicate()
    seconds = time.perf_counter() - pending.start
    if pending.proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {pending.source} "
                           f"(exit {pending.proc.returncode}):\n{log}")
    os.replace(pending.tmp, library_path(pending.source))
    BUILD_LOGS[pending.source] = (log, seconds)


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library compiled from `source`."""
    lib = _LIBS.get(source)
    if lib is None:
        finish_build(start_build(source))
        lib = ctypes.CDLL(str(library_path(source)))
        _LIBS[source] = lib
    return lib
