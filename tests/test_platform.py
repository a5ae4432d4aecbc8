"""The platform module's choices, the persistent compile cache's
placement, and what the serving path imports."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest

from qrag_tpu import platform
from qrag_tpu.utils import compilation_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def backend(monkeypatch):
    def set_backend(name):
        monkeypatch.setattr(platform.jax, "default_backend", lambda: name)

    return set_backend


@pytest.mark.parametrize(
    "name,n,d,dtype,route",
    [
        ("gpu", 1_000_064, 768, jnp.bfloat16, "triton"),
        ("gpu", 384, 64, jnp.bfloat16, "triton"),
        ("gpu", 1_000_064, 768, jnp.float32, "xla"),  # f32 scan: XLA at HIGHEST
        ("gpu", 1_000_064, 100, jnp.bfloat16, "xla"),  # d does not tile
        ("gpu", 1000, 768, jnp.bfloat16, "xla"),  # N does not tile
        ("cpu", 1_000_064, 768, jnp.bfloat16, "xla"),  # never interpret
    ],
)
def test_scan_route(backend, name, n, d, dtype, route):
    backend(name)
    assert platform.scan_route(n, d, dtype) == route


@pytest.mark.parametrize(
    "name,dtype", [("gpu", jnp.bfloat16), ("cpu", jnp.float32)]
)
def test_compute_dtype(backend, name, dtype):
    backend(name)
    assert platform.compute_dtype() == dtype
    assert platform.on_gpu() is (name == "gpu")


def test_cache_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compilation_cache.cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert str(os.getpid()) not in path
    assert not path.startswith(os.path.realpath(os.environ.get("TMPDIR", "/tmp")))
    # the same path in every process: it is part of the cache key
    out = subprocess.run(
        [sys.executable, "-c",
         "from qrag_tpu.utils.compilation_cache import cache_dir; print(cache_dir())"],
        capture_output=True, text=True, cwd=REPO,
        env={k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"},
    )
    assert out.stdout.strip() == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_honours_env_and_sets_no_other_path(monkeypatch, backend, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compilation_cache.cache_dir() == str(tmp_path)
    backend("gpu")
    before = jax.config.jax_compilation_cache_dir
    min_time = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        assert compilation_cache.enable_compilation_cache() is True
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_time)


def test_cache_stays_off_on_cpu(backend):
    backend("cpu")
    before = jax.config.jax_compilation_cache_dir
    assert compilation_cache.enable_compilation_cache() is False
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_default_path_applied_on_gpu(monkeypatch, backend):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compilation_cache.os, "makedirs", lambda *a, **k: None)
    backend("gpu")
    before = jax.config.jax_compilation_cache_dir
    min_time = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        compilation_cache.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == compilation_cache.DEFAULT_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_time)


_BLOCKER = textwrap.dedent(
    """
    import sys
    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("pydantic", "orbax", "torch", "triton"):
                raise ImportError("blocked: " + name)
    sys.meta_path.insert(0, _Block())
    import importlib
    importlib.import_module(sys.argv[1])
    print("imported", sys.argv[1])
    """
)


@pytest.mark.parametrize(
    "module",
    [
        "qrag_tpu.serving.http_app",
        "qrag_tpu.engine",
        "qrag_tpu.index",
        "qrag_tpu.ops.bounded_topk",
        "qrag_tpu.reranker",
    ],
)
def test_main_path_imports_without_optional_packages(module):
    """The serving path needs only jax, numpy, scipy, optax, chex,
    einops and the standard library: it imports with pydantic and
    orbax (and the packages the GPU machine lacks) blocked."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER, module],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"imported {module}" in out.stdout
