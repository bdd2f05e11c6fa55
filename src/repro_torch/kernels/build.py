"""Build a CUDA source of ``csrc/`` into a shared library with ``nvcc``.

Route (b) of the port: a plain C interface, compiled for ``sm_90a`` and
loaded with ``ctypes``. The library is built on first use into
``<repo>/build`` (listed in ``.gitignore``), once per source content and
flags; ptxas's register and shared memory report is kept beside it as
``<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_library",
           "load_library", "check_launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source with the CUDA toolkit")


def build_library(source: Path) -> Path:
    """Compile ``source`` into ``build/<stem>-<hash>.so`` unless that file
    exists, and return its path."""
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"{source.stem}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                             capture_output=True, text=True)
        lib.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {source.name}:\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load_library(source: Path, launch: str, argtypes: list):
    """Build ``source`` and load it with ``ctypes``: ``launch`` is its C
    launch function (returning a CUDA error code) with ``argtypes``, and
    ``<stem>_error_string`` turns a code into text."""
    lib = ctypes.CDLL(str(build_library(source)))
    fn = getattr(lib, launch)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{source.stem}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check_launch(lib, source: Path, code: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = getattr(lib, f"{source.stem}_error_string")(code).decode()
        raise RuntimeError(f"{source.stem} kernel launch failed: {msg}")
