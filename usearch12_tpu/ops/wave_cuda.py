"""The CUDA kernels of the device DP (ops/cuda/wave_fwd.cu), built with
nvcc for sm_90a into <repo>/build at first use and called through XLA's
FFI: the forward pass and the traceback, with the same results as
wavefront_nw._make_forward and _make_traceback; the traceback tensor
between them is pair-major, tb[w, p, u]."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..device import REPO_ROOT

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda",
                   "wave_fwd.cu")
FWD, TRACE = "usearch_wave_fwd", "usearch_wave_trace"
_lib = []


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA DP kernel is built "
                           "from ops/cuda/wave_fwd.cu at first use")
    return nvcc


def build() -> str:
    """Path of the shared library, compiled if the source changed."""
    import jax
    with open(SRC, "rb") as f:
        key = hashlib.sha1(f.read() + jax.__version__.encode()).hexdigest()
    out_dir = os.path.join(REPO_ROOT, "build")
    so = os.path.join(out_dir, f"wave_fwd-{key[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "--fmad=false", "-shared",
           "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(), "-o", tmp,
           SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + r.stderr[-4000:])
    os.replace(tmp, so)
    return so


def register() -> None:
    """Load the library and register its FFI target (once)."""
    if _lib:
        return
    import jax
    lib = ctypes.cdll.LoadLibrary(build())
    for name, fn in ((FWD, lib.WaveFwd), (TRACE, lib.WaveTrace)):
        jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(fn),
                                    platform="CUDA")
    _lib.append(lib)


def make_forward(n_words: int, W: int):
    """Un-jitted forward pass with _make_forward's signature (n_run is
    unused: each warp runs its own pair's la + lb steps)."""
    import jax
    import jax.numpy as jnp
    register()

    def run(a, b, geo, term, scal, n_run):
        P = a.shape[0]
        call = jax.ffi.ffi_call(
            FWD, (jax.ShapeDtypeStruct((n_words, P, W + 1), jnp.int32),
                  jax.ShapeDtypeStruct((3, P), jnp.float32)))
        return call(a, b, geo, term, scal, W=np.int32(W))

    return run


def make_traceback(n_words: int, W: int, n_ops: int):
    """Un-jitted traceback with _make_traceback's signature and results
    (n_run is unused: each thread walks its own pair's path)."""
    import jax
    import jax.numpy as jnp
    register()

    def run(tb, geo, fin, n_run):
        P = geo.shape[1]
        call = jax.ffi.ffi_call(
            TRACE, (jax.ShapeDtypeStruct((P,), jnp.float32),
                    jax.ShapeDtypeStruct((P, n_ops // 4), jnp.uint8)))
        return call(tb, geo, fin, W=np.int32(W))

    return run
