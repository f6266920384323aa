"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under ``dqgp_tpu_torch/csrc/`` compiles on first use into a
shared library with a plain C interface, for ``sm_90a`` (Hopper). The
library lands in ``dqgp_tpu_torch/build/`` (ignored by git), named by a hash
of the source, every other file of ``csrc/`` (the shared headers, and the
sources that a translation unit of further instantiations includes) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. A failed compile raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels "
        "are built from source at first use")


def build(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless a build of these exact bytes exists.

    Returns (library path, compiler log); the log holds ptxas's register and
    shared-memory report when a compile ran, and is empty on reuse."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for other in sorted(CSRC_DIR.glob("*.cu*")):
        if other != src:
            digest.update(other.read_bytes())
    lib = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``."""
    lib_path, _ = build(source)
    return ctypes.CDLL(str(lib_path))
