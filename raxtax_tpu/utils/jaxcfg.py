"""JAX runtime configuration and the one device decision of the classifier.

Centralizes process-wide JAX settings so the CLI, the benchmark and the
smoke check agree:

- :func:`setup_jax` — the persistent compilation cache. The device pipeline
  jits several large programs (postings fold, significance compaction, exact
  scan) whose first compile costs seconds to minutes per shape bucket.
- :func:`kernel_route` — which implementation a hand-kernel job runs: the
  compiled Pallas-Triton kernel on a GPU, the plain jnp version everywhere
  else (the CPU runs only the tests), and the Pallas interpreter only when a
  caller passes ``interpret=True`` itself. No path falls back after a kernel
  error: a kernel that fails to compile on the GPU fails the run.
"""

from __future__ import annotations

import os
from pathlib import Path

_DONE = False

#: compile-cache directory when ``JAX_COMPILATION_CACHE_DIR`` is unset: a
#: fixed path inside the checkout (listed in .gitignore), so the cache key
#: is stable from run to run
DEFAULT_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def setup_jax() -> None:
    """Idempotent process-wide JAX setup (persistent compilation cache).

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left alone; otherwise the cache goes to :data:`DEFAULT_CACHE_DIR`.
    """
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


def platform() -> str:
    """Platform of JAX's default device ("gpu", "cpu", ...)."""
    import jax

    return jax.devices()[0].platform


def kernel_route(interpret: bool = False) -> str:
    """Implementation of a hand-kernel job: "interpret" (Pallas interpreter,
    only on request), "triton" (compiled Pallas-Triton kernel, on a GPU) or
    "jnp" (the plain version XLA compiles, everywhere else)."""
    if interpret:
        return "interpret"
    return "triton" if platform() == "gpu" else "jnp"


def resolve_backend(backend: str) -> str:
    """The engine backend "auto" stands for: the planes pipeline ("pallas")
    on a GPU, the dense bit-matmul ("xla") elsewhere."""
    if backend != "auto":
        return backend
    return "pallas" if platform() == "gpu" else "xla"


def require_gpu(what: str) -> None:
    """Raise unless JAX's default device is a GPU (measurement entry points
    never fall back to the CPU)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"{what} needs a GPU; JAX found {devs[0].platform} devices "
            f"({devs[0].device_kind})"
        )
