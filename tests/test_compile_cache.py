"""The one place that points JAX's persistent compilation cache."""

import os

import jax
import pytest

from scanner_colmap_tpu.utils import compile_cache


@pytest.mark.parametrize("env_dir", [None, "/some/where/else"])
def test_enable_compile_cache(monkeypatch, env_dir):
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            # one subdirectory of <repo>/.jax_cache per host CPU, the same
            # on every call
            assert os.path.dirname(path) == compile_cache.REPO_CACHE_DIR
            assert compile_cache.REPO_CACHE_DIR.endswith(".jax_cache")
            assert path == compile_cache.enable_compile_cache()
            assert os.path.basename(path) == compile_cache.host_cpu_tag()
            assert jax.config.jax_compilation_cache_dir == path
        else:
            # JAX reads the variable itself; the helper sets nothing
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
            assert compile_cache.enable_compile_cache() == env_dir
            assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
