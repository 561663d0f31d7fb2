"""Build the port's CUDA sources into shared libraries at first use.

Each source under `pano_nerf_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into `build/pano_nerf_tpu_torch/` at the repository root
and loaded with `ctypes`. A source may be built more than once with
different preprocessor definitions (`defines`, e.g. `("NERF_NDC=1",)`),
each into a library of its own. The library name carries the definitions
and a hash of the source, the shared headers (`csrc/*.cuh`), the flags and
the definitions, so an edited source or header is rebuilt and a stale
library is never loaded. Nothing
is compiled when a module is imported: the first launch on a CUDA tensor
builds, and a machine without `nvcc` raises there.

`load_host_library` builds a host C++ source of `csrc/` (the EXR decoder,
`exr_decode.cc`) with `g++` the same way, for `data/io_exr.py`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pano_nerf_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
GXX_LIBS = ("-lz",)   # the EXR decoder inflates with zlib
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
# Every (source, defines) asked of `load_library`, so a caller can see
# which builds a run used (chip_smoke.py clears and reads it).
LOADED: set = set()
# Compiler output (ptxas register/spill report) and build seconds, by
# library (`build_name`).
BUILD_LOGS: Dict[str, Tuple[str, float]] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build_name(source: str, defines: Sequence[str] = ()) -> str:
    """The source's stem and its definitions: `fused_mlp_nerf_ndc1`."""
    tags = [d.replace("=", "").lower() for d in defines]
    return "_".join([Path(source).stem] + tags)


def library_path(source: str, defines: Sequence[str] = ()) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + tuple(f"-D{d}" for d in defines))
    digest = hashlib.sha1((CSRC / source).read_bytes() + headers
                          + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"{build_name(source, defines)}_{digest}.so"


class PendingBuild(NamedTuple):
    source: str
    defines: Tuple[str, ...]
    proc: subprocess.Popen
    tmp: Path
    start: float


def start_build(source: str, defines: Sequence[str] = ()
                ) -> Optional[PendingBuild]:
    """Start compiling `source` with the preprocessor definitions
    `defines` unless its library is already built.

    Returns the running compiler, or None when nothing needs building.
    Several builds can be started together and awaited with
    `finish_build`, so their compiles run in parallel.
    """
    defines = tuple(defines)
    out = library_path(source, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
           str(tmp), str(CSRC / source)]
    start = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return PendingBuild(source, defines, proc, tmp, start)


def finish_build(pending: Optional[PendingBuild]) -> None:
    """Wait for a build from `start_build`; raise with its log if it failed."""
    if pending is None:
        return
    log, _ = pending.proc.communicate()
    seconds = time.perf_counter() - pending.start
    name = build_name(pending.source, pending.defines)
    if pending.proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} "
                           f"(exit {pending.proc.returncode}):\n{log}")
    os.replace(pending.tmp, library_path(pending.source, pending.defines))
    BUILD_LOGS[name] = (log, seconds)


def load_library(source: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load the library compiled from `source` with
    the preprocessor definitions `defines`."""
    key = (source, tuple(defines))
    LOADED.add(key)
    lib = _LIBS.get(key)
    if lib is None:
        finish_build(start_build(source, key[1]))
        lib = ctypes.CDLL(str(library_path(source, key[1])))
        _LIBS[key] = lib
    return lib


def load_host_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the host C++ source `source` of csrc/
    with g++ (`GXX_FLAGS`, linked against `GXX_LIBS`) into BUILD_DIR (the
    name carries a hash of the source and the flags). Raises RuntimeError
    when the build fails, with the compiler's output."""
    key = (source, ("host",))
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    flags = GXX_FLAGS + GXX_LIBS
    digest = hashlib.sha1((CSRC / source).read_bytes()
                          + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"{Path(source).stem}_host_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        gxx = shutil.which("g++") or "g++"
        cmd = [gxx, *GXX_FLAGS, str(CSRC / source), "-o", str(tmp),
               *GXX_LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(f"g++ failed on {source}: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {source} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LIBS[key] = lib
    return lib
