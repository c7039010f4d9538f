"""Build the native host-runtime extension (_rslqr_native).

Usage: ``python setup.py build_ext --inplace`` (see rslqr_tpu/native.py for
the loader with pure-Python fallback when the extension is absent).
"""

from setuptools import Extension, setup

setup(
    name="rslqr-tpu",
    version="0.1.0",
    packages=[
        "rslqr_tpu", "rslqr_tpu.ops", "rslqr_tpu.parallel",
        "rslqr_tpu_torch", "rslqr_tpu_torch.ops", "rslqr_tpu_torch.parallel",
    ],
    ext_modules=[
        Extension(
            "_rslqr_native",
            sources=["csrc/rslqr_native.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-Wall"],
            language="c++",
            # Installs proceed without a C++ toolchain (pure-Python fallback
            # in rslqr_tpu/native.py) — the reference's "internal routines
            # by default, faster backends when available" stance.
            optional=True,
        )
    ],
)
