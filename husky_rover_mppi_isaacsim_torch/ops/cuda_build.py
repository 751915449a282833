"""Build a source of this package into a shared library and load it.

Sources in ``husky_rover_mppi_isaacsim_torch/csrc`` have a plain C interface.
The CUDA ones are compiled with ``nvcc`` for ``sm_90a`` (:func:`build`), the
host runtime ``husky_native.cpp`` with ``g++`` (:func:`build_host`), at first
use into ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), under a name keyed by a hash of the source, the local
headers it includes (``#include "..."``, such as ``csrc/hopper_common.cuh``)
and the flags, and loaded with ctypes. Each build writes a file of its own process and
renames it into place, so that a concurrent loader never sees a partial
library. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

from ..core import trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# -fmad=false: no FMA contraction, so the kernels round every operation as
# the eager torch versions do (no fast math either: true division, IEEE
# sqrtf, the CUDA library's cosf/sinf); a fused multiply-add is written out
# as __fmaf_rn / __fma_rn where the plain version forms one.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the host runtime's flags, those of the JAX package's native build
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
HOST_CXX = "g++"


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # build time, 0.0 when the cached library was loaded
    log: str        # nvcc's output, ptxas register and spill report included


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_bytes(src: Path, seen: set[Path] | None = None) -> bytes:
    """``src`` followed by every local header it includes (``#include
    "..."``, found beside the including file), recursively, each once."""
    seen = set() if seen is None else seen
    src = src.resolve()
    seen.add(src)
    text = src.read_bytes()
    out = [text]
    for name in _LOCAL_INCLUDE.findall(text):
        header = (src.parent / name.decode()).resolve()
        if header not in seen and header.is_file():
            out.append(source_bytes(header, seen))
    return b"".join(out)


def _build_cached(src: Path, compiler, flags) -> BuiltLibrary:
    """Compile ``src`` with ``compiler()`` and ``flags`` unless a library of
    the same source, local headers and flags is built, then load it."""
    key = hashlib.sha256(source_bytes(src) + " ".join(flags).encode())
    out = BUILD_DIR / f"lib{src.stem}_{key.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        exe = compiler()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        with trace.span("cuda_build.build"):
            proc = subprocess.run([exe, *flags, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        trace.count("cuda_build.builds")
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{Path(exe).name} failed on {src.name}:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)


def build(source_name: str) -> BuiltLibrary:
    """Compile the CUDA source ``csrc/<source_name>`` with nvcc (unless a
    library of the same source and flags is already built) and load it."""
    return _build_cached(CSRC / source_name, _nvcc, NVCC_FLAGS)


def _host_cxx() -> str:
    found = shutil.which(HOST_CXX)
    if found is None:
        raise RuntimeError(f"{HOST_CXX} not found: the host runtime needs a C++17 compiler")
    return found


def build_host(source_name: str) -> BuiltLibrary:
    """Compile the host C++ source ``csrc/<source_name>`` with g++ (unless a
    library of the same source and flags is already built) and load it."""
    return _build_cached(CSRC / source_name, _host_cxx, HOST_FLAGS)
