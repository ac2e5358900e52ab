"""The persistent compile cache lives where JAX_COMPILATION_CACHE_DIR says,
else at the fixed <checkout>/.jax_cache — never a temporary or per-process
path (the directory is part of the cache key, so a moving one never hits)."""
import os
import subprocess
import sys
import tempfile
import time

import pytest

from xframe_tpu.library import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# compiles one fresh program after enable() and prints the cache directory
# it returned, the one JAX used, and the entries the compile added there
_CHILD = r"""
import os, sys, jax
jax.config.update("jax_platforms", "cpu")
from xframe_tpu.library.compile_cache import enable
path = enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
ls = lambda: set(os.listdir(path)) if os.path.isdir(path) else set()
before = ls()
tag = float(sys.argv[1])
jax.jit(lambda x: x * tag + 0.5)(jax.numpy.ones(3)).block_until_ready()
print(path)
print(jax.config.jax_compilation_cache_dir)
print(",".join(sorted(ls() - before)))
"""


def _run_child(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    tag = 1.0 + (time.time_ns() % 10 ** 9) / 10 ** 9   # a program never seen
    out = subprocess.run([sys.executable, "-c", _CHILD, repr(tag)], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    path, used, added = out.stdout.splitlines()[-3:]
    return path, used, {e for e in added.split(",") if e}


@pytest.mark.parametrize("env_set", [True, False],
                         ids=["env_var_set", "env_var_unset"])
def test_compiled_entries_land_in_the_one_cache_dir(tmp_path, env_set):
    """The compiled entry lands in JAX_COMPILATION_CACHE_DIR when it is set
    (and not in the checkout's directory), else in <checkout>/.jax_cache."""
    env_dir = str(tmp_path / "cache") if env_set else None
    want = env_dir or compile_cache.DEFAULT_DIR
    path, used, added = _run_child(env_dir)
    assert path == used == want
    assert added, "no compiled entry landed in the cache directory"
    if env_set:
        default = set(os.listdir(compile_cache.DEFAULT_DIR)) \
            if os.path.isdir(compile_cache.DEFAULT_DIR) else set()
        assert not added & default


def test_default_cache_dir_is_fixed_and_not_temporary(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.cache_dir()
    assert d == os.path.join(ROOT, ".jax_cache")
    assert os.path.isabs(d)
    assert not d.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in d
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/srv/cache/jax")
    assert compile_cache.cache_dir() == "/srv/cache/jax"
