"""Where the persistent XLA compilation cache goes
(kaldi_decoder_tpu/utils/compile_cache.py)."""

import os
import subprocess
import sys

import pytest

from kaldi_decoder_tpu.utils.compile_cache import compile_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}
    assert compile_cache_dir(env) == "/somewhere/else"


def test_default_is_fixed_checkout_path():
    assert compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")


# Runs in a fresh process: enables the cache (with the checkout pointed at
# a temp dir), compiles one program and lists where entries landed.
_PROBE = r"""
import pathlib, sys
sys.path.insert(0, sys.argv[1])
from kaldi_decoder_tpu.utils import compile_cache
compile_cache.CHECKOUT = pathlib.Path(sys.argv[2])
print("DIR", compile_cache.enable_compile_cache())
import jax, jax.numpy as jnp
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.jit(lambda x: jnp.cos(x) * 3)(jnp.arange(5.0)).block_until_ready()
"""


@pytest.mark.parametrize("env_set", [True, False])
def test_entries_land_only_in_chosen_dir(tmp_path, env_set):
    checkout, env_dir = tmp_path / "checkout", tmp_path / "env_cache"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, REPO, str(checkout)],
        env=env, capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    want, other = (
        (env_dir, checkout / ".jax_cache") if env_set
        else (checkout / ".jax_cache", env_dir)
    )
    assert f"DIR {want}" in out
    assert any(want.iterdir()), "no cache entry written"
    assert not other.exists()
