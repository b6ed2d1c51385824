"""Build the port's CUDA kernel with nvcc and load it with ctypes.

`kernels/csrc/ssa_window.cu` compiles into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds). The library
lands in `build/kernels/` at the repository root, named by a digest of
the source and the flags, so an edited source is rebuilt and a stale
library is never loaded. The build runs at first use and raises if nvcc
fails. ptxas's register and spill report is kept beside the library as
`<library>.log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssa_window.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the kernel source."""


def build_dir() -> Path:
    """`build/kernels/` at the repository root (listed in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernel is built from kernels/csrc at first use")


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{SOURCE.stem}-{digest}.so"


def build() -> Path:
    """Compile the kernel library unless it is built already; returns
    its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"kernel build failed: {SOURCE.name}: nvcc "
                               f"exit {proc.returncode}\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builds agree
    return out


def load() -> ctypes.CDLL:
    """The built kernel library, compiled at first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def build_log() -> str:
    """ptxas's report for the built library ('' before the first build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""
