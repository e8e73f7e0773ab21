"""Native (C++) host parsing of tokenized ``.bin`` files (port of
``internevo_tpu/native/__init__.py``; the source, ``fastpack.cpp``, is the
JAX package's).

The library is compiled with g++ on first use into ``internevo_tpu_torch/
build/`` (gitignored), under a name that carries the source's hash, and
loaded with ctypes; nothing is built at import, and nothing next to the
source.  Where no compiler is found every entry point takes the JAX
package's numpy/json path (``python_parse_tokens_line``,
``python_build_meta``), which ``tests/test_torch_data.py`` holds equal to
the native one.  This is host parsing, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("fastpack.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    return BUILD_DIR / f"fastpack-{hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(SOURCE)],
                                   check=True, capture_output=True)
                    os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(str(so))
            lib.parse_tokens.restype = ctypes.c_long
            lib.parse_tokens.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                         ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
            lib.build_meta.restype = ctypes.c_long
            lib.build_meta.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                       ctypes.POINTER(ctypes.c_int64),
                                       ctypes.POINTER(ctypes.c_int64), ctypes.c_long]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
    return _lib


def python_parse_tokens_line(line: bytes) -> np.ndarray:
    return np.asarray(json.loads(line)["tokens"], np.int32)


def parse_tokens_line(line: bytes) -> np.ndarray:
    """{"tokens": [...]} line -> int32 array (native, else json)."""
    lib = _load()
    if lib is not None:
        max_out = max(16, len(line) // 2)
        out = np.empty(max_out, np.int32)
        n = lib.parse_tokens(line, len(line), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_out)
        if n >= 0:
            return out[:n].copy()
    return python_parse_tokens_line(line)


def python_build_meta(buf: bytes) -> np.ndarray:
    meta = []
    pos = 0
    for line in buf.splitlines(keepends=True):
        stripped = line.strip()
        if stripped:
            meta.append((pos, len(json.loads(stripped)["tokens"])))
        pos += len(line)
    return np.asarray(meta, np.int64).reshape(-1, 2)


def build_meta_from_bytes(buf: bytes) -> np.ndarray:
    """Whole .bin contents -> (rows, 2) int64 array of (offset, token_count)."""
    lib = _load()
    if lib is not None:
        max_rows = buf.count(b"\n") + 2
        offsets = np.empty(max_rows, np.int64)
        counts = np.empty(max_rows, np.int64)
        rows = lib.build_meta(buf, len(buf), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                              counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_rows)
        if rows >= 0:
            return np.stack([offsets[:rows], counts[:rows]], axis=1)
    return python_build_meta(buf)


def prepare_meta_fast(bin_path: str) -> None:
    """Build the .bin.meta next to the data file (native build_meta)."""
    with open(bin_path, "rb") as f:
        buf = f.read()
    meta = build_meta_from_bytes(buf)
    with open(bin_path + ".meta", "wb") as f:
        np.save(f, meta)


def native_available() -> bool:
    return _load() is not None
