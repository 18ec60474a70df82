"""Build the package's CUDA sources into a shared library at first use.

``nvcc`` compiles ``csrc/<name>.cu`` for ``sm_90a`` into a library with a
plain C interface, which ``ctypes`` loads. The library goes into ``build/``
at the repository root, named by a hash of the source, the ``csrc`` headers
it includes (directly or through another header) and the flags, so an edit
of any of them rebuilds and an unchanged tree reuses it. A failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _sources(src: Path) -> list:
    """``src`` and every file of its directory that it includes with
    quotes, directly or through another included file, in a fixed order."""
    found, todo = {src}, [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_bytes()):
            dep = src.parent / name.decode()
            if dep.is_file() and dep not in found:
                found.add(dep)
                todo.append(dep)
    return sorted(found)


def digest(src: Path) -> str:
    """Hash of ``src``, the headers it includes and the nvcc flags."""
    h = hashlib.sha256()
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{digest(CSRC / f'{name}.cu')}.so"


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
    lib = _library(name)
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


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def report(name: str) -> list:
    """Per kernel of the built ``csrc/<name>.cu``, from the compiler's report
    kept beside the library: (mangled name, registers per thread, static
    shared-memory bytes, spill-store bytes, spill-load bytes)."""
    rows, current, spills = [], None, (0, 0)
    for line in _library(name).with_suffix(".so.log").read_text().splitlines():
        if m := _ENTRY.search(line):
            current, spills = m.group(1), (0, 0)
        elif (m := _SPILLS.search(line)) and current:
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := _USED.search(line)) and current:
            rows.append((current, int(m.group(1)), int(m.group(2) or 0), *spills))
            current = None
    return rows


def count_launch(wrapper) -> None:
    """One more on ``wrapper.launches`` for a kernel launched now. A launch
    recorded into a CUDA graph under capture runs only when the graph is
    replayed, past the wrapper, so it is not counted here
    (``ops/epoch_scan.EpochScan`` counts its replays)."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1
