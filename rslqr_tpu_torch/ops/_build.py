"""Build and load the CUDA kernels of ``csrc/schur_kernels.cu``.

``nvcc`` compiles the source into a shared library with a plain C interface,
which ``ctypes`` loads; no PyTorch headers are involved, so a build takes
seconds. The library lands in ``rslqr_tpu_torch/_build/`` (git-ignored)
under a name that carries a hash of the source and the flags, so a changed
source rebuilds and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "schur_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"schur_kernels_{digest}.so"


def build(extra_flags=()) -> Path:
    """Compile the kernels unless the library for this source exists.
    ``extra_flags`` (for example ``("-Xptxas", "-v")``) force a fresh
    compile whose compiler output is printed."""
    out = library_path()
    if out.exists() and not extra_flags:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if extra_flags:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every C entry point's types."""
    lib = ctypes.CDLL(str(build()))
    P, PP, I = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int
    sigs = {
        "rslqr_rhs_update_level": [P] * 7 + [I] * 5 + [P],
        "rslqr_schur_update_level": [P] * 3 + [PP] * 4 + [P] * 2 + [PP]
        + [I] * 7 + [P],
        "rslqr_schur_update_pair": [P] * 3 + [PP] * 4 + [P, PP, P, P, PP]
        + [I] * 7 + [P],
        "rslqr_leaf_schur_level0": [P] * 5 + [PP] + [P] * 2 + [PP] * 4
        + [I] * 5 + [P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = I
    lib.rslqr_error_string.argtypes = [I]
    lib.rslqr_error_string.restype = ctypes.c_char_p
    return lib
