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
    _PKG / "csrc" / "bf16_kernels.cu",
)
# Included by the small-block sources (schur_kernels.cu, flat_kernels.cu,
# bf16_kernels.cu).
HEADERS = (_PKG / "csrc" / "small_blocks.cuh",
           _PKG / "csrc" / "row_groups.cuh",
           _PKG / "csrc" / "leaf_rows.cuh",
           _PKG / "csrc" / "bf16_rows.cuh")
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


def _run(procs, echo: bool = True) -> list:
    """Wait for every ``(cmd, Popen, tmp)``; raise with the compiler's
    output on the first failure, after all have ended. Returns each
    compiler's output (printed where ``echo``)."""
    failed, outs = [], []
    for cmd, proc, tmp in procs:
        out, err = proc.communicate()
        outs.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}\n{err}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        elif (out or err) and echo:
            print(out + err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def _tmp(suffix: str) -> str:
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    return tmp


def build(extra_flags=(), reports: dict = None) -> Path:
    """Compile the kernels unless the library for these sources exists.
    ``extra_flags`` (for example ``("-Xptxas", "-v")``) force a fresh
    compile whose compiler output is printed, or, given ``reports``, put
    in it by source file name (with ``-Xptxas -v``: a :func:`ptxas_report`
    of each source, from the one compile the library is built from)."""
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
    outs = _run([(cmd, proc, tmp) for cmd, proc, tmp, _ in jobs],
                echo=reports is None)
    if reports is not None:
        reports.update({Path(cmd[-1]).name: o
                        for (cmd, *_), o in zip(jobs, outs)})
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


def sass_counts(library: Path) -> dict:
    """``{mangled kernel name: SASS instructions}`` of a built library, from
    ``cuobjdump -sass`` (the toolkit's, beside ``nvcc``)."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m[1]
            out[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            out[name] += 1
    return out


_P, _PP, _PI = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
               ctypes.POINTER(ctypes.c_int))
_I, _FL, _LL = ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# Every C entry point's argument types (the last one the CUDA stream);
# each returns an int error code.
SIGNATURES = {
    # csrc/schur_kernels.cu
    "rslqr_rhs_update_level": [_P] * 7 + [_I] * 6 + [_P],
    "rslqr_schur_update_level": [_P] * 3 + [_PP] * 4 + [_P] * 2 + [_PP]
    + [_I] * 10 + [_P],
    "rslqr_schur_update_pair": [_P] * 3 + [_PP] * 4 + [_P, _PP, _P, _P, _PP]
    + [_I] * 10 + [_P],
    "rslqr_leaf_schur_level0": [_P] * 5 + [_PP] + [_P] * 2 + [_PP] * 4
    + [_I] * 8 + [_P],
    # csrc/bf16_kernels.cu
    "rslqr_schur_update_level_bf16": [_P] * 3 + [_PP] * 4 + [_P] * 2 + [_PP]
    + [_I] * 11 + [_LL, _P],
    "rslqr_schur_update_pair_bf16": [_P] * 3 + [_PP] * 4
    + [_P, _PP, _P, _P, _PP] + [_I] * 11 + [_LL, _P],
    "rslqr_leaf_schur_level0_bf16": [_P] * 5 + [_PP] + [_P] * 2 + [_PP] * 4
    + [_I] * 9 + [_LL, _P],
    # csrc/planes_kernels.cu
    "rslqr_pgemm": [_P] * 3 + [_I] * 4 + [_P],
    "rslqr_schur_update_planes": [_P] * 3 + [_I] * 7 + [_P],
    "rslqr_pchol": [_P] * 2 + [_I] * 2 + [_P],
    "rslqr_pcho_solve": [_P] * 2 + [_I] * 3 + [_P],
    "rslqr_schur3_update_planes": [_P] * 7 + [_I] * 6 + [_P],
    "rslqr_schur3_update_levels": [_P] * 3 + [_PP] * 4 + [_I] * 7 + [_P],
    # csrc/flagged_kernels.cu
    "rslqr_pgemm_flagged": [_P] * 6 + [_I] * 8 + [_FL, _I, _I, _PI, _P],
    # csrc/plu_kernels.cu
    "rslqr_plu_solve_multi": [_P, _PP, _PP, _PI] + [_I] * 3 + [_P],
    # csrc/flat_kernels.cu
    "rslqr_flat_rhs_update_level": [_P] * 7 + [_I] * 5 + [_P],
    "rslqr_flat_schur_update_level": [_P] * 3 + [_PP] * 4 + [_P] * 2 + [_PP]
    + [_I] * 10 + [_P],
    "rslqr_flat_leaf_schur_level0": [_P] * 5 + [_PP] + [_P] * 2 + [_PP] * 4
    + [_I] * 8 + [_P],
    # csrc/probe_kernels.cu
    "rslqr_pgemm_ib": [_P] * 3 + [_I] * 6 + [_P],
    "rslqr_fma_peak": [_P] * 2 + [_I] * 2 + [_P],
}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every C entry point's types."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = _I
    lib.rslqr_error_string.argtypes = [_I]
    lib.rslqr_error_string.restype = ctypes.c_char_p
    return lib
