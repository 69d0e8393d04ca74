"""Where the persistent compile cache goes (utils/compile_cache.py).

Each case runs in a fresh interpreter configured for a platform (the GPU
as on the card, or the CPU): the package enables the cache at import,
before any backend starts, so no GPU is needed to see the decision."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, jax, gym_anm_tpu
from gym_anm_tpu.utils.compile_cache import DEFAULT_DIR, enable_persistent_cache
print(json.dumps({"first": enable_persistent_cache(), "second": enable_persistent_cache(),
                  "config": jax.config.jax_compilation_cache_dir, "default": DEFAULT_DIR}))
"""


def _run(code, env_dir, cwd, platform="cuda"):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS=platform, PYTHONPATH=ROOT)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r


def _probe(env_dir, cwd, platform="cuda"):
    r = _run(_PROBE, env_dir, cwd, platform)
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("from_env", [True, False])
def test_cache_directory(from_env, tmp_path):
    env_dir = str(tmp_path / "user_cache") if from_env else None
    # Run from an unrelated directory: the default must not follow the cwd.
    got = _probe(env_dir, cwd=str(tmp_path))
    assert got["first"] == got["second"] == got["config"]
    if from_env:
        assert got["config"] == env_dir
        # The user's setting is used as it is: not even created here.
        assert not os.path.exists(env_dir)
    else:
        assert got["config"] == got["default"] == os.path.join(ROOT, ".jax_cache")
        assert os.path.isdir(got["config"])
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_cache_off_on_cpu(tmp_path):
    """On the CPU backend (the tests) the package sets no cache directory."""
    got = _probe(None, cwd=str(tmp_path), platform="cpu")
    assert got["first"] is None and got["second"] is None
    assert not got["config"]


_RELOAD = """
import jax, jax.numpy as jnp
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
print(float(jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((64, 64))).sum()))
"""


def test_cpu_cache_reload_reports_machine_mismatch(tmp_path):
    """Why the CPU opt-out exists: XLA:CPU reloads a cached executable
    with an error that it was built for other machine features than the
    host's ("could lead to ... SIGILL"), even on the host that wrote it.
    If this stops holding, the opt-out in compile_cache.py can go."""
    cache = str(tmp_path / "cache")
    first = _run(_RELOAD, cache, str(tmp_path), platform="cpu")
    assert os.listdir(cache), "the first run cached nothing"
    second = _run(_RELOAD, cache, str(tmp_path), platform="cpu")
    assert second.stdout == first.stdout
    assert "SIGILL" not in first.stderr
    assert "SIGILL" in second.stderr
