"""The port's native libraries: each built, bound and counted in one place.

A wrapper declares its library once, as a ``Library``: the source, the
headers it includes, the compiler flags, the ctypes signatures of its entry
points and, for a CUDA library, the name its kernel's launches are counted
under. ``Library.get()`` builds it at first use and returns the loaded
library with its signatures bound. A CUDA source (``.cu``) is compiled with
nvcc for sm_90a, a host source (``.cpp``) with the host compiler (C++17
unless the declaration gives its own flags); either goes into ``_build/``
beside the package, named by a hash of its source and headers, so an edited
source is rebuilt and an unchanged one is reused. A failed build raises
RuntimeError (OSError when there is no compiler). The libraries have a plain
C interface and are loaded with ``ctypes.CDLL``, whose calls run without the
interpreter lock.

Server threads can launch a kernel first at the same time: each source has a
per-process lock (``library_lock``), held from the check of the loaded
library until it is set, and the compiler writes to a temporary file named by
the process and the thread.

Launches are counted process-wide, outside the metrics registry:
``Library.count`` adds to the counter and ``launches()`` reads it. Its keys,
listed at 0 from the declaration on, are one per kernel and below a kernel
``<kernel>/<part>``: the block stacks' launches by pack (``f32``, ``bf16``,
``int8``) and their folded products (``folded``), the sort's CUDA launches
(``cuda``). Readers take differences of two reads.
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
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
HOST_FLAGS = ("-std=c++17", "-O3")

_LOCKS_GUARD = threading.Lock()
_LOCKS: Dict[Path, threading.RLock] = {}
_COUNT_LOCK = threading.Lock()
_LAUNCHES: Dict[str, int] = {}
_LIBRARIES: List["Library"] = []


def library_lock(source: Path) -> threading.RLock:
    """The process's lock of one source's build and load (reentrant: a
    loader holds it around ``build_library``, which takes it too)."""
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(Path(source), threading.RLock())


def build_library(source: Path, headers: Sequence[Path] = (),
                  flags: Optional[Sequence[str]] = None) -> Tuple[ctypes.CDLL, float, str]:
    """Compile ``source`` (unless a library of the same sources exists) and
    load it. ``flags`` replace a host source's default ``HOST_FLAGS``.
    Returns (library, seconds spent, ptxas report: registers, shared memory
    and spills per kernel and ptxas's performance warnings, empty for a host
    source or when the library was reused)."""
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
                cmd = [shutil.which("c++") or "g++", *(HOST_FLAGS if flags is None else flags),
                       "-shared", "-fPIC"]
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


class Library:
    """One native library as its wrapper declares it.

    ``functions`` maps each entry point to (restype, argtypes). ``kernel``
    names the kernel whose launches the wrapper counts (None for a host
    library), ``parts`` the ``<kernel>/<part>`` keys it counts besides.
    ``report`` holds ptxas's report of this process's build of it (empty
    when the library was reused)."""

    def __init__(self, source: Path, functions: Mapping[str, Tuple[Any, Sequence[Any]]], *,
                 headers: Sequence[Path] = (), flags: Optional[Sequence[str]] = None,
                 kernel: Optional[str] = None, parts: Sequence[str] = ()):
        self.source, self.headers, self.flags = Path(source), tuple(headers), flags
        self.functions = dict(functions)
        self.kernel = kernel
        self.report = ""
        self._loaded: Optional[ctypes.CDLL] = None
        if kernel is not None:
            for part in (None, *parts):
                self.count(part, 0)
        _LIBRARIES.append(self)

    def load(self) -> float:
        """Build (or reuse) and load the library and bind its entry points.
        Returns the seconds spent, 0.0 when it was already loaded."""
        with library_lock(self.source):
            if self._loaded is not None:
                return 0.0
            lib, seconds, self.report = build_library(self.source, self.headers, self.flags)
            for name, (restype, argtypes) in self.functions.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, list(argtypes)
            self._loaded = lib
            return seconds

    def get(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        if self._loaded is None:
            self.load()
        return self._loaded

    def count(self, part: Optional[str] = None, n: int = 1) -> None:
        """Add ``n`` launches under the kernel's key, or ``<kernel>/<part>``."""
        key = self.kernel if part is None else f"{self.kernel}/{part}"
        with _COUNT_LOCK:
            _LAUNCHES[key] = _LAUNCHES.get(key, 0) + n


def launches() -> Dict[str, int]:
    """The launch counter's current counts, by key (see the module's doc)."""
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def kernel_libraries() -> List[Library]:
    """The declared libraries that hold a kernel: the seven CUDA libraries
    (``ops/__init__.py`` imports their wrappers)."""
    return [lib for lib in _LIBRARIES if lib.kernel is not None]
