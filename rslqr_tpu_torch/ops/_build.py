"""Build and load the CUDA kernels of ``csrc/*.cu``.

``nvcc`` compiles each source into an object, all sources at once in
parallel processes, and links the objects into one shared library with a
plain C interface, which ``ctypes`` loads; no PyTorch headers are involved,
so a build takes seconds. Objects and library land in
``rslqr_tpu_torch/_build/`` (git-ignored) under names that carry a hash of
their sources, the shared headers (``HEADERS``) and the flags, so a changed
source rebuilds and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (
    _PKG / "csrc" / "schur_kernels.cu",
    _PKG / "csrc" / "planes_kernels.cu",
    _PKG / "csrc" / "flagged_kernels.cu",
    _PKG / "csrc" / "plu_kernels.cu",
    _PKG / "csrc" / "flat_kernels.cu",
    _PKG / "csrc" / "probe_kernels.cu",
)
# Included by the small-block sources (schur_kernels.cu, flat_kernels.cu).
HEADERS = (_PKG / "csrc" / "small_blocks.cuh",
           _PKG / "csrc" / "row_groups.cuh",
           _PKG / "csrc" / "leaf_rows.cuh")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def _digest(*parts: bytes) -> str:
    return hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]


def _flags() -> bytes:
    return " ".join(NVCC_FLAGS).encode()


def _headers() -> bytes:
    return b"\0".join(h.read_bytes() for h in HEADERS)


def object_path(source: Path) -> Path:
    digest = _digest(source.read_bytes(), _headers(), _flags())
    return BUILD_DIR / f"{source.stem}_{digest}.o"


def library_path() -> Path:
    digest = _digest(*(s.read_bytes() for s in SOURCES), _headers(),
                     _flags())
    return BUILD_DIR / f"rslqr_kernels_{digest}.so"


def _run(procs) -> None:
    """Wait for every ``(cmd, Popen, tmp)``; raise with the compiler's
    output on the first failure, after all have ended."""
    failed = []
    for cmd, proc, tmp in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}\n{err}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        elif out or err:
            print(out + err)
    if failed:
        raise RuntimeError("\n".join(failed))


def _tmp(suffix: str) -> str:
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    return tmp


def build(extra_flags=()) -> Path:
    """Compile the kernels unless the library for these sources exists.
    ``extra_flags`` (for example ``("-Xptxas", "-v")``) force a fresh
    compile whose compiler output is printed."""
    out = library_path()
    if out.exists() and not extra_flags:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for src in SOURCES:
        obj = object_path(src)
        if obj.exists() and not extra_flags:
            continue
        tmp = _tmp(".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((cmd, proc, tmp, obj))
    _run([(cmd, proc, tmp) for cmd, proc, tmp, _ in jobs])
    for *_, tmp, obj in jobs:
        os.replace(tmp, obj)
    tmp = _tmp(".so")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
           *(str(object_path(s)) for s in SOURCES)]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True), tmp)])
    os.replace(tmp, out)
    return out


def ptxas_report(source: Path) -> str:
    """Compile one source with ``-Xptxas -v`` (registers, shared memory and
    spills of each kernel) and return the compiler's report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp(".o")
    try:
        out = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", tmp,
             str(source)], capture_output=True, text=True, check=True)
    finally:
        os.unlink(tmp)
    return out.stdout + out.stderr


def ptxas_kernels(report: str) -> dict:
    """``{mangled kernel name: (registers, stack bytes, spill store bytes,
    spill load bytes)}`` from a :func:`ptxas_report`."""
    out, name, frame = {}, None, (0, 0, 0)
    for line in report.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ")[1].strip()
            frame = (0, 0, 0)
        elif "bytes stack frame" in line and name:
            frame = tuple(int(w) for w in re.findall(r"(\d+) bytes", line))
        elif "Used " in line and " registers" in line and name:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[name] = (regs, *frame)
            name = None
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every C entry point's types."""
    lib = ctypes.CDLL(str(build()))
    P, PP, I = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int
    PI, FL = ctypes.POINTER(ctypes.c_int), ctypes.c_float
    sigs = {
        # csrc/schur_kernels.cu
        "rslqr_rhs_update_level": [P] * 7 + [I] * 5 + [P],
        "rslqr_schur_update_level": [P] * 3 + [PP] * 4 + [P] * 2 + [PP]
        + [I] * 10 + [P],
        "rslqr_schur_update_pair": [P] * 3 + [PP] * 4 + [P, PP, P, P, PP]
        + [I] * 10 + [P],
        "rslqr_leaf_schur_level0": [P] * 5 + [PP] + [P] * 2 + [PP] * 4
        + [I] * 8 + [P],
        # csrc/planes_kernels.cu
        "rslqr_pgemm": [P] * 3 + [I] * 4 + [P],
        "rslqr_schur_update_planes": [P] * 3 + [I] * 7 + [P],
        "rslqr_pchol": [P] * 2 + [I] * 2 + [P],
        "rslqr_pcho_solve": [P] * 2 + [I] * 3 + [P],
        "rslqr_schur3_update_planes": [P] * 7 + [I] * 6 + [P],
        # csrc/flagged_kernels.cu
        "rslqr_pgemm_flagged": [P] * 6 + [I] * 8 + [FL, I, I, PI, P],
        # csrc/plu_kernels.cu
        "rslqr_plu_solve_multi": [P, P, PP, PP, PI] + [I] * 3 + [P],
        # csrc/flat_kernels.cu
        "rslqr_flat_rhs_update_level": [P] * 7 + [I] * 5 + [P],
        "rslqr_flat_schur_update_level": [P] * 3 + [PP] * 4 + [P] * 2 + [PP]
        + [I] * 10 + [P],
        "rslqr_flat_leaf_schur_level0": [P] * 5 + [PP] + [P] * 2 + [PP] * 4
        + [I] * 8 + [P],
        # csrc/probe_kernels.cu
        "rslqr_pgemm_ib": [P] * 3 + [I] * 6 + [P],
        "rslqr_fma_peak": [P] * 2 + [I] * 2 + [P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = I
    lib.rslqr_error_string.argtypes = [I]
    lib.rslqr_error_string.restype = ctypes.c_char_p
    return lib
