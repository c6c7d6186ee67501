"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  On first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
the package's ``_build/`` directory (listed in ``.gitignore``) and loaded
with ``ctypes``; no PyTorch headers are compiled, so a build takes seconds.
The library's file name carries a hash of the source and the flags, so an
edited source is never served by a stale build.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """A loaded kernel library and how it was built."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    ptxas: tuple          # the '-Xptxas -v' register / shared-memory lines


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin, then PATH, then the toolkit's
    default install prefix."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _ptxas_lines(log: str) -> tuple:
    return tuple(line.strip() for line in log.splitlines()
                 if re.search(r"ptxas info\s*: (Used|Compiling)", line))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> KernelLibrary:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed building {src.name} "
                               f"(exit {proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib=ctypes.CDLL(str(out)), path=out,
                         build_seconds=seconds, ptxas=_ptxas_lines(log))
