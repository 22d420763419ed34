"""Hand-written CUDA kernels of the port and their build.

Each ``*.cu`` file here has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/`` at the repository root on first use,
then loaded with ``ctypes``.  The library name carries a hash of the source,
so an edited kernel is rebuilt and a stale library is never loaded.  Nothing
is built or imported when a module of the port is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR.parents[1] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


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


def library_path(source: str) -> Path:
    """Where the shared library of ``csrc/<source>`` is built."""
    digest = hashlib.sha1((CSRC_DIR / source).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: str) -> tuple[Path, float]:
    """Compile ``csrc/<source>`` unless its library is already built.

    Returns ``(path, seconds spent compiling)``.  The compiler's output is
    raised with the error when the build fails."""
    out = library_path(source)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} ({proc.returncode}):\n"
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


class CudaKernel:
    """One kernel library: built and loaded at first use, with a launch count.

    ``launches`` is a plain integer that the wrapper raises by one each time
    it launches the kernel, so a run can show which path it took."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
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
