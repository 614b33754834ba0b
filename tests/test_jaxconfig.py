"""The persistent compilation cache rule (utils/jaxconfig.py):
JAX_COMPILATION_CACHE_DIR when set, else the fixed <repo>/.jax_cache."""
import os
import subprocess
import sys

import pytest

from meshclust2_tpu.utils.jaxconfig import REPO_CACHE_DIR, compilation_cache_dir

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_repo_cache_dir_is_fixed_inside_the_checkout():
    assert REPO_CACHE_DIR == os.path.join(_REPO, ".jax_cache")
    assert compilation_cache_dir({}) == REPO_CACHE_DIR
    assert compilation_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"
    with open(os.path.join(_REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("env_dir", [None, "cache_from_env"])
def test_ensure_compilation_cache(env_dir, tmp_path):
    """In a fresh process, ensure_compilation_cache leaves JAX on the
    directory the environment names, and sets the repo one otherwise."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    want = REPO_CACHE_DIR
    if env_dir is not None:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("from meshclust2_tpu.utils.jaxconfig import "
            "ensure_compilation_cache as e; e(); import jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == want
