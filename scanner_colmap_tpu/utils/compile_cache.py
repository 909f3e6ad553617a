"""Placement of JAX's persistent compilation cache.

Every entry point (the pipeline CLI, the smoke test, the benchmarks and the
tools) calls `enable_compile_cache` before its first compile, so all of them
share one cache and none sets its own directory.

- When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
  module sets nothing.
- Otherwise the cache lives under a fixed ``<repo>/.jax_cache``, in one
  subdirectory per host CPU: XLA:CPU executables are compiled for the
  features of the CPU that built them, and a copy of the repository run on
  another machine must not load them. The directory is part of what a later
  run must find again, so it never depends on a temporary name, a process
  id or the time.
"""

from __future__ import annotations

import hashlib
import os
import platform

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def host_cpu_tag() -> str:
    """Architecture plus a digest of the CPU model and feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            info = sorted({line.strip() for line in f
                           if line.startswith(("model name", "flags"))})
    except OSError:   # not Linux
        info = [platform.processor()]
    digest = hashlib.sha1("\n".join(info).encode()).hexdigest()[:12]
    return f"{platform.machine()}-{digest}"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    path = os.path.join(REPO_CACHE_DIR, host_cpu_tag())
    jax.config.update("jax_compilation_cache_dir", path)
    return path
