"""Where importing the package puts JAX's persistent compile cache: the
directory ``JAX_COMPILATION_CACHE_DIR`` names when it is set (the package
then sets nothing), otherwise ``<checkout>/.jax_cache``, which git
ignores."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = (
    "import jax; jax.config.update('jax_platforms', 'cpu'); "
    "import retrocapture_tpu; print(jax.config.jax_compilation_cache_dir)"
)


@pytest.mark.parametrize("env_dir", [True, False], ids=["env-set", "env-unset"])
def test_compile_cache_placement(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = str(REPO)  # run from elsewhere: the path is fixed
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "x")
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, cwd=str(tmp_path), timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    got = r.stdout.strip().splitlines()[-1]
    if env_dir:
        assert got == str(tmp_path / "x")
    else:
        assert Path(got) == REPO / ".jax_cache"
        ignored = (REPO / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignored
