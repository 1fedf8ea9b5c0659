"""Build a hand-written CUDA source into a shared library and load it.

Each kernel source under ``repro_torch/kernels/**/csrc/`` exposes a plain C
interface.  ``load`` compiles it with ``nvcc`` for Hopper (``sm_90a``) into
``build/kernels/`` at the repository root, at first use, and opens it with
``ctypes``.  The library's name carries a hash of the source, of every
header it includes with ``#include "..."`` (followed through the headers
they include, found beside the including file or in ``INCLUDE_DIR``) and
of the flags, so an edited source or header is rebuilt and a stale
library is never loaded.  ``INCLUDE_DIR`` (``kernels/csrc``) holds the
headers the kernel packages share; it is passed to nvcc with ``-I``.

Nothing is built when a module is imported: the CPU tests import every
module, and a machine without ``nvcc`` must be able to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)

# one lock per library, so that builds of different sources overlap
_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
#: per library: (seconds nvcc took, 0.0 when reused; ptxas report)
build_info: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def included_headers(source: Path) -> list:
    """Every header ``source`` includes with ``#include "..."``, and the
    headers those include, each once, in the order first met; resolved as
    nvcc does, beside the including file first, then in ``INCLUDE_DIR``.
    A header found in neither raises."""
    found, todo = [], [source]
    while todo:
        src = todo.pop(0)
        for m in _INCLUDE.finditer(src.read_bytes()):
            rel = m.group(1).decode()
            path = next((d / rel for d in (src.parent, INCLUDE_DIR)
                         if (d / rel).is_file()), None)
            if path is None:
                raise FileNotFoundError(f"{src}: header {rel} not found")
            path = path.resolve()
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def source_tag(source: Path) -> str:
    """The hash a library's name carries: of the source, every header it
    includes (``included_headers``) and the flags."""
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in included_headers(source))
    return hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]


def load(name: str, source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content) and return the loaded library."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        tag = source_tag(source)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"lib{name}-{tag}.so"
        seconds, report = 0.0, ""
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
                 str(source)],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            report = proc.stderr
            os.replace(tmp, out)
        build_info[name] = (seconds, report)
        _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]
