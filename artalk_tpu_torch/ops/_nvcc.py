"""Build a source of ``csrc/`` into a shared library and load it.

A CUDA source (``.cu``) is compiled with nvcc for sm_90a, a host source
(``.cpp``) with the host compiler, C++17; either goes into ``_build/`` beside
the package at first use, named by a hash of its source and the headers it
includes, so an edited source is rebuilt and an unchanged one is reused. The
libraries have a plain C interface and are bound with ``ctypes.CDLL``, whose
calls run without the interpreter lock.

Server threads can launch a kernel first at the same time: each source has a
per-process lock (``library_lock``), which a kernel's loader holds from its
check of the loaded library until it has set it, and the compiler writes to
a temporary file named by the process and the thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

_LOCKS_GUARD = threading.Lock()
_LOCKS: Dict[Path, threading.RLock] = {}


def library_lock(source: Path) -> threading.RLock:
    """The process's lock of one source's build and load (reentrant: a
    loader holds it around ``build_library``, which takes it too)."""
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(Path(source), threading.RLock())


def build_library(source: Path, headers: Sequence[Path] = ()) -> Tuple[ctypes.CDLL, float, str]:
    """Compile ``source`` (unless a library of the same sources exists) and
    load it. Returns (library, seconds spent, ptxas report: registers, shared
    memory and spills per kernel and ptxas's performance warnings, empty for a
    host source or when the library was reused)."""
    t0 = time.perf_counter()
    digest = hashlib.sha256()
    for path in (source, *headers):
        digest.update(path.read_bytes())
    lib_path = BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"
    report = ""
    with library_lock(source):
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
            if source.suffix == ".cpp":
                cmd = [shutil.which("c++") or "g++", "-std=c++17", "-O3", "-shared", "-fPIC"]
            else:
                cmd = [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc",
                       "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                       "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
            cmd += ["-I", str(CSRC), "-o", str(tmp), str(source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{cmd[0]} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
            report = "\n".join(line for line in proc.stderr.splitlines()
                               if "registers" in line or "spill" in line
                               or "Performance" in line)
        lib = ctypes.CDLL(str(lib_path))
    return lib, time.perf_counter() - t0, report
