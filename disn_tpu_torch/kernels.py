"""nvcc builds of the port's CUDA sources (csrc/*.cu).

Each source is compiled for sm_90a at first use into ``build/kernels/``
under the repository root, as a shared library with a plain C interface
that the wrappers load with ctypes. The library is named by a hash of the
source and the flags; the compiler's register and shared-memory report is
kept beside it as ``<lib>.log``. A failed build raises.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCKS: dict[str, threading.Lock] = {}   # one per library: builds of
_LOCKS_GUARD = threading.Lock()          # different sources run together


def build_lock(name: str) -> threading.Lock:
    """The lock that serialises the builds of one library across threads."""
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(name, threading.Lock())


def nvcc_build(name: str, defines: tuple[str, ...] = (),
               src: Path | None = None) -> Path:
    """Compile csrc/<name>.cu, or the source `src` (another checkout's, for
    a comparison), with `defines` (once per hash of the source and the
    flags) and return the library's path."""
    src = CSRC / f"{name}.cu" if src is None else Path(src)
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    with build_lock(lib.name):
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = (os.environ.get("NVCC") or shutil.which("nvcc")
                or "/usr/local/cuda/bin/nvcc")
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib
