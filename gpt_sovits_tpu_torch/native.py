"""The native batch reader: ctypes bindings for csrc/gsvt_io.cc (the port's
copy of native/gsvt_io.cc), with the JAX package's signatures and results
(gpt_sovits_tpu/native/__init__.py).

The library is built with g++ (or $CXX) on first use into
``build/native/libgsvt_io-<hash>.so`` at the repository root, a directory
that .gitignore lists, as ops/build.py builds the CUDA kernels; the hash
covers the source and the flags. Where no compiler is found or the build
fails, `load()` returns None and the datasets read with Python
(train/data.py)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "gsvt_io.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _target() -> Path:
    h = hashlib.sha1(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libgsvt_io-{h}.so"


def _build(out: Path) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("clang++")
    if not cxx:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)], check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        return False
    os.replace(tmp, out)  # another process's finished build is as good
    return True


def load() -> Optional[ctypes.CDLL]:
    """The native library, built first if needed, or None (the Python path
    applies)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _target()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.gsvt_wav_batch.restype = ctypes.c_int
        lib.gsvt_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.gsvt_npy_batch.restype = ctypes.c_int
        lib.gsvt_npy_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def _paths_arr(paths: list[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def wav_batch(paths: list[str], max_len: int, *, n_threads: int = 8):
    """Parallel WAV decode -> (out (n, max_len) f32 zero-padded, lengths,
    srs, status), status non-zero for a file that failed. None if the
    native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(paths)
    out = np.zeros((n, max_len), np.float32)
    lengths = np.zeros(n, np.int64)
    srs = np.zeros(n, np.int32)
    status = np.zeros(n, np.int32)
    lib.gsvt_wav_batch(
        _paths_arr(paths), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_len,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    return out, lengths, srs, status


def npy_batch(paths: list[str], max_rows: int, cols: int, *, n_threads: int = 8):
    """Parallel f32/f16 .npy decode -> (out (n, max_rows, cols) f32, rows,
    status). None if the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(paths)
    out = np.zeros((n, max_rows, cols), np.float32)
    rows = np.zeros(n, np.int64)
    status = np.zeros(n, np.int32)
    lib.gsvt_npy_batch(
        _paths_arr(paths), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_rows, cols,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    return out, rows, status
