"""Hand-written kernels of the port and their build.

Each ``*.cu`` file here has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``); the host flood ``watershed_host.cpp`` (the port's
copy of ``native/watershed.cpp``) is compiled by ``g++`` with the flags of
``native/Makefile``.  Libraries go into ``build/`` at the repository root on
first use and are loaded with ``ctypes``.  The library name carries a hash
of the source, the headers it includes and the compiler's flags, so an
edited source or header is rebuilt and a stale library is never loaded.
Nothing is built or imported when a module of the port is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR.parents[1] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# native/Makefile's CXXFLAGS, unchanged: GCC's default -ffp-contract=fast
# fuses the compact-watershed priority's multiply-add under -march=native,
# and other flags can break ties differently, so only these give labels
# bit-identical to the JAX package's host flood
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


FLAGS = {"nvcc": NVCC_FLAGS, "g++": GXX_FLAGS}


def _executable(compiler: str) -> str:
    if compiler == "nvcc":
        return nvcc_path()
    found = shutil.which(compiler)
    if found is None:
        raise RuntimeError(f"{compiler} not found on PATH")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(source: str) -> list[Path]:
    """``csrc/<source>`` and the headers beside it that it includes with
    quotes, transitively."""
    seen, todo = [], [CSRC_DIR / source]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            header = path.parent / name.decode()
            if header.exists():
                todo.append(header)
    return seen


def library_path(source: str, compiler: str = "nvcc") -> Path:
    """Where the shared library of ``csrc/<source>`` is built by
    ``compiler`` (``"nvcc"`` or ``"g++"``): the name hashes the source, the
    ``csrc/`` headers it includes and the flags."""
    h = hashlib.sha1()
    for path in _sources(source):
        h.update(path.read_bytes())
    h.update(" ".join((compiler, *FLAGS[compiler])).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build(source: str, compiler: str = "nvcc") -> tuple[Path, float]:
    """Compile ``csrc/<source>`` with ``compiler`` unless its library is
    already built.

    Returns ``(path, seconds spent compiling)``.  The compiler's output is
    raised with the error when the build fails."""
    out = library_path(source, compiler)
    if out.exists():
        return out, 0.0
    exe = _executable(compiler)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [exe, *FLAGS[compiler], "-o", tmp, str(CSRC_DIR / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{compiler} failed on {source} ({proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0


def build_all(kernels) -> None:
    """Build and load every kernel of ``kernels`` at once: one ``nvcc`` per
    source, all started together (each waits in a thread on its compiler)."""
    from concurrent.futures import ThreadPoolExecutor

    kernels = list(kernels)
    with ThreadPoolExecutor(max_workers=max(1, len(kernels))) as pool:
        for fut in [pool.submit(k.function) for k in kernels]:
            fut.result()


def aligned16(t):
    """``t``, or a copy of it in a fresh allocation (which is aligned) where
    ``t`` does not start on a 16-byte boundary, as a view at an odd element
    offset may not: the kernels' 16-byte copies need aligned rows."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


class LaunchCount:
    """The launches of one wrapper of a kernel: ``launches`` is a plain
    integer that the wrapper raises by one each time it launches the kernel,
    so a run can show which path it took, and ``route_launches`` counts them
    by the path the kernel's C entry point picks, where it picks one."""

    def __init__(self, routes: tuple = ()):
        self.launches = 0
        self.route_launches = dict.fromkeys(routes, 0)
        # data replicas launch from threads of their own
        self._lock = threading.Lock()

    def add(self, route: str | None = None) -> None:
        """One launch, on the path ``route`` (None for a kernel of one path)."""
        with self._lock:
            self.launches += 1
            if route is not None:
                self.route_launches[route] += 1


class CudaKernel(LaunchCount):
    """One kernel library: built and loaded at first use, with the launch
    count of its main wrapper.

    ``source`` names a file in ``csrc/``; an absolute path builds a source
    from elsewhere (another commit's copy, say) the same way.  A second
    wrapper of the same kernel keeps its own :class:`LaunchCount`."""

    def __init__(self, source: str, symbol: str, argtypes: list, routes: tuple = ()):
        super().__init__(routes)
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.build_seconds = 0.0
        self._fn = None

    def function(self):
        """The loaded C entry point, building the library if needed."""
        if self._fn is None:
            path, self.build_seconds = build(self.source)
            fn = getattr(ctypes.CDLL(str(path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


class HostLibrary:
    """A host C++ library built by ``g++`` and loaded at first use.

    ``functions`` maps each C symbol to its ``argtypes``; every symbol
    returns a C ``int``.  Loading takes a lock, since tile workers may ask
    for it at once.  ``ctypes`` releases the GIL for the length of a call."""

    def __init__(self, source: str, functions: dict):
        self.source = source
        self.functions = functions
        self.build_seconds = 0.0
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, self.build_seconds = build(self.source, compiler="g++")
                lib = ctypes.CDLL(str(path))
                for name, argtypes in self.functions.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib
