"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use (or all together by
``build_all``) with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded with
``ctypes``.  No PyTorch headers are included, so a build takes seconds.
Libraries go to ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}  # guarded-by: _load_lock
# Live nodes launch from several threads; the first launch of each builds
# and loads its library once, not once a thread (a build's partial file is
# named by the process).
_load_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install.  Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists; the
    ptxas report goes beside it as ``.ptxas.txt``.  Raises with nvcc's
    output if the compile fails.  Returns the library's path."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(partial), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed: {name}: nvcc exited {proc.returncode}\n"
            f"{proc.stdout}"
        )
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout)
    # Rename into place so a concurrent loader never sees half a file.
    os.replace(partial, lib)
    return lib


def build_all(names) -> dict:
    """Build several sources at once, one ``nvcc`` for each, all started
    together; returns {name: library path}.  Raises the first failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib
