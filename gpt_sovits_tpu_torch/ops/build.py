"""Build the CUDA sources in ``csrc/`` with nvcc on first use and load them
with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own, all nvcc processes started
together, into ``build/kernels/lib<name>-<hash>.so`` at the repository root
(a directory that .gitignore lists). The hash covers the source and the
flags, so an edited source is rebuilt and an unchanged one is reused. The
sources have plain C interfaces (no PyTorch headers), which keeps a build at
seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # per source: nvcc's output (ptxas register / spill report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _target(src: Path) -> Path:
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{h}.so"


def build_all(names=None) -> float:
    """Compile every source (or the given stems) that is not built yet, in
    parallel. Returns the seconds spent; raises with nvcc's output on failure."""
    srcs = sorted(CSRC.glob("*.cu")) if names is None else [CSRC / f"{n}.cu" for n in names]
    todo = [s for s in srcs if not _target(s).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        out = _target(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def loaded(name: str) -> ctypes.CDLL | None:
    """The library for ``csrc/<name>.cu`` if this process has loaded it."""
    return _LIBS.get(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        src = CSRC / f"{name}.cu"
        build_all([name])
        lib = ctypes.CDLL(str(_target(src)))
        _LIBS[name] = lib
    return lib
