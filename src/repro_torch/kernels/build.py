"""Build the CUDA kernels under ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``build/kernels/<name>-<digest>.so`` at the repository root, where the digest
covers the source and the flags, so an edited source is rebuilt.  The
libraries are loaded with ``ctypes``.  Nothing is compiled when this module is
imported: machines without ``nvcc`` (the CPU test runs) import it freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["KERNELS", "NVCC_FLAGS", "BUILD_LOG", "build", "compile_sources", "jobs",
           "library", "load"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("rmsnorm", "flash_attention", "mamba_scan", "a2a_pack", "flash_attention_bwd",
           "rmsnorm_bwd")
# -Xptxas -v: registers, shared memory and spills of every kernel, kept in
# BUILD_LOG for the record of a run
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_NVCC_TIMEOUT_S = 600

#: compiler output of each source built by this process, by kernel name
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels cannot be built"
    )


def _target(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def jobs(names=KERNELS) -> dict[str, tuple[Path, Path]]:
    """The ``name: (source, library)`` build job of every named kernel whose
    library is missing, for :func:`compile_sources`."""
    return {n: (SRC_DIR / f"{n}.cu", _target(n)) for n in names if not _target(n).exists()}


def build(names=KERNELS) -> None:
    """Compile every named source whose library is missing.  Raises with the
    compiler's output if any build fails."""
    compile_sources(jobs(names))


def compile_sources(jobs: dict[str, tuple[Path, Path]]) -> None:
    """Compile each ``name: (source, library)`` job, one ``nvcc`` per source,
    all started together; the compiler's output goes to ``BUILD_LOG[name]``.
    Raises with the compiler's output if any build fails."""
    if not jobs:
        return
    nvcc = _nvcc()
    procs = {}
    for n, (src, target) in jobs.items():
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp, target)
    errors = []
    for n, (proc, tmp, target) in procs.items():
        try:
            out, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\n(nvcc killed after {_NVCC_TIMEOUT_S} s)"
        BUILD_LOG[n] = out
        if proc.returncode == 0:
            os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"{jobs[n][0].name}: nvcc exited {proc.returncode}\n{out}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))


def load(path: Path, signatures: dict) -> ctypes.CDLL:
    """Load a built library; ``signatures`` maps each C function to
    ``(restype, argtypes)``."""
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = load(_target(name), signatures)
    return lib
