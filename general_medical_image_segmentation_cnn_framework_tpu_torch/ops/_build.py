"""Build the package's CUDA sources into a shared library at first use.

``nvcc`` compiles ``csrc/<name>.cu`` for ``sm_90a`` into a library with a
plain C interface, which ``ctypes`` loads. The library goes into ``build/``
at the repository root, named by a hash of the source and the flags, so an
edit rebuilds and an unchanged tree reuses it. A failed build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and load it. The compiler's
    report (registers, shared memory, spills) is kept beside the library
    as ``<library>.log``."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
        lib.with_suffix(".so.log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return ctypes.CDLL(str(lib))
