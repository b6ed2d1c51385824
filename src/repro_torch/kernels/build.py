"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `kernels/csrc/*.cu` compiles into ONE shared library with a plain
C interface (no PyTorch headers, so a build takes seconds) in one nvcc
call (`--threads 0` lets nvcc run its compilation steps in parallel).
The library lands in `build/kernels/` at the repository root, named by
a digest of every file under `csrc/` (sources and the shared header) and
the flags, so an edited source is rebuilt and a stale library is never
loaded. The build runs at first use and raises if nvcc fails. ptxas's
register and spill report is kept beside the library as
`<library>.log`.

`load_network` does the same for one generated source
(`kernels/netgen.py`): the library `libssa_net-<digest>.so`, named by
a digest of the source, `csrc/ssa_common.cuh` (the one header it
includes) and the flags, is built at most once and loaded at most once
a process (an in-process cache by the same digest). Its `.compiles`
counts nvcc runs, `.hits` the calls that needed none.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--threads", "0")

_lib: ctypes.CDLL | None = None
_net_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def build_dir() -> Path:
    """`build/kernels/` at the repository root (listed in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from kernels/csrc at first use")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return build_dir() / f"libssa_kernels-{h.hexdigest()[:16]}.so"


def _nvcc(out: Path, srcs, *flags) -> Path:
    """Compile `srcs` into the library `out` unless it is there; ptxas's
    report lands beside it. The library is written under a temporary
    name and renamed, so processes that build it at once agree."""
    if out.exists():
        return out
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp),
                           *map(str, srcs)],
                          capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"kernel build failed: nvcc exit "
                               f"{proc.returncode}\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builds agree
    return out


def build() -> Path:
    """Compile the kernel library unless it is built already; returns
    its path."""
    return _nvcc(library_path(), sources())


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


@functools.cache
def _network_digest_base():
    """The flags and `ssa_common.cuh`, the part of every generated
    kernel's digest that is not its source (read once a process)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / "ssa_common.cuh").read_bytes() + b"\0")
    return h


def network_library_path(source: str) -> Path:
    """Where the library of one generated kernel source lives."""
    h = _network_digest_base().copy()
    h.update(source.encode())
    return build_dir() / f"libssa_net-{h.hexdigest()[:16]}.so"


def load_network(source: str) -> ctypes.CDLL:
    """The library of a generated kernel source (`netgen.window_source`),
    compiled at first use: from this process's cache, else from
    `build/kernels/`, else built there by nvcc."""
    out = network_library_path(source)
    lib = _net_libs.get(out.name)
    if lib is not None:
        load_network.hits += 1
        return lib
    if out.exists():
        load_network.hits += 1
    else:
        cu = out.with_suffix(".cu")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.parent / f"{cu.name}.{os.getpid()}.tmp"
        tmp.write_text(source)
        os.replace(tmp, cu)
        _nvcc(out, [cu], "-I", str(CSRC))
        load_network.compiles += 1
    lib = _net_libs[out.name] = ctypes.CDLL(str(out))
    return lib


load_network.compiles = 0
load_network.hits = 0
