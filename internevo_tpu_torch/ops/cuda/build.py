"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` source is compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes``.  The library's file name carries the
hash of its source and of the shared headers (``csrc/*.cuh``), so an edited
source or header is rebuilt and an unchanged one is loaded from
``internevo_tpu_torch/build/``.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return nvcc


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # whichever the source includes
        h.update(header.name.encode() + header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless its hashed library exists.  Returns the
    library path and the compiler's output (``-Xptxas -v`` register and
    shared-memory report; empty when the library was already built)."""
    lib = library_path(source)
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """Build if needed and load the library of ``csrc/<source>`` (once per process)."""
    lib = _loaded.get(source)
    if lib is None:
        path, _ = build(source)
        lib = ctypes.CDLL(str(path))
        _loaded[source] = lib
    return lib
