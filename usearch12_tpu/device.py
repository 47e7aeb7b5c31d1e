"""The one device gate, and where device state lives on disk.

Every device path (the batch engine's DP, SINTAX boots, CSR ranking, the
mesh commands) asks `gate` whether it may run.  Auto mode engages the
device only on JAX's GPU backend.  A forcing flag (-engine_device,
-sintax_device, -device_rank) means the work must run on the device: on
the GPU, or on XLA's CPU backend when JAX_PLATFORMS=cpu was set
explicitly (how the tests drive the device code); anything else exits
non-zero.

JAX's persistent compilation cache lives where JAX_COMPILATION_CACHE_DIR
says; without it, at one fixed path inside the checkout, so that every
run of this checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os
from typing import Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")
PERF_CACHE = os.path.join(REPO_ROOT, ".device_perf.json")


def cpu_explicit() -> bool:
    """JAX_PLATFORMS names the CPU backend alone."""
    return os.environ.get("JAX_PLATFORMS", "").strip() == "cpu"


def backend() -> str:
    """JAX's default backend ("gpu", "cpu", ...)."""
    import jax
    return jax.default_backend()


def device_kind() -> str:
    import jax
    return jax.devices()[0].device_kind


def gate(flag: str, forced: bool) -> Optional[str]:
    """None when the device may run; else why not (auto mode).  With
    `forced`, a backend that may not run the device path exits."""
    plat = backend()
    if plat == "gpu" or (forced and plat == "cpu" and cpu_explicit()):
        enable_compile_cache()
        return None
    if forced:
        raise SystemExit(f"-{flag}: the device path needs a GPU (JAX "
                         f"backend is {plat!r}; JAX_PLATFORMS=cpu runs it "
                         "on XLA's CPU backend)")
    return f"backend {plat}"


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def enable_compile_cache() -> None:
    """Point JAX's persistent compilation cache at compile_cache_dir()
    (JAX reads JAX_COMPILATION_CACHE_DIR itself when it is set)."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
