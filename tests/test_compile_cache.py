"""The compile-cache helper (utils/compile_cache.py): the environment
variable wins and no other directory is set in code; otherwise the
cache goes to the fixed <repo>/.jax_cache."""

import os
import subprocess
import sys

from raytracingproject_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROBE = ("import jax\n"
          "from raytracingproject_tpu.utils.compile_cache import "
          "enable_compile_cache\n"
          "print(enable_compile_cache())\n"
          "print(jax.config.jax_compilation_cache_dir)\n")


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV_VAR}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env[compile_cache.ENV_VAR] = env_dir
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


def test_default_dir_is_repo_jax_cache():
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    assert _probe(None) == [compile_cache.DEFAULT_DIR] * 2


def test_env_var_is_honoured(tmp_path):
    d = str(tmp_path / "cache")
    assert _probe(d) == [d, d]


def test_cache_dir_follows_env(monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_VAR, "/elsewhere")
    assert compile_cache.cache_dir() == "/elsewhere"
    monkeypatch.delenv(compile_cache.ENV_VAR)
    assert compile_cache.cache_dir() == compile_cache.DEFAULT_DIR
