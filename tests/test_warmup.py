"""Cold-start control (pyloo_tpu.warmup): AOT warmup + compilation cache.

The warmup contract: after pl.warmup(geometry), a real loo_streaming call
with the same geometry must not trace/compile the heavy chunk-step programs
again (only the user's own generator).  Verified by counting retraces of the
module-level jitted chunk steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import importlib

import pyloo_tpu as pl
from pyloo_tpu import streaming as streaming_mod

# `pl.warmup` is the function; the module is shadowed by the export
warmup_mod = importlib.import_module("pyloo_tpu.warmup")

N_OBS, N_DRAWS = 512, 200


def _cache_sizes():
    """(_accumulate_chunk, _mixture_chunk) jit cache entry counts."""
    return (
        streaming_mod._accumulate_chunk._cache_size(),
        streaming_mod._mixture_chunk._cache_size(),
    )


def test_warmup_precompiles_chunk_programs():
    res = pl.warmup(N_OBS, N_DRAWS, chunk_size=128, dtype=jnp.float64)
    assert res["chunk_size"] == 128
    before = _cache_sizes()

    ll = jnp.asarray(
        np.random.default_rng(0).normal(-1, 0.5, size=(N_OBS, N_DRAWS))
    )
    out = pl.loo_streaming(
        lambda idx: ll[idx], N_OBS, N_DRAWS, chunk_size=128,
        dtype=jnp.float64,
    )
    assert np.isfinite(float(out["elpd_loo"]))
    # the heavy chunk-step programs were already compiled by warmup: the
    # real call must not have added cache entries
    assert _cache_sizes() == before


def test_warmup_matches_unwarmed_result():
    ll = np.random.default_rng(1).normal(-1, 0.5, size=(200, 64))
    dev = jnp.asarray(ll)
    ref = pl.loo_streaming(
        lambda idx: dev[idx], 200, 64, chunk_size=64, dtype=jnp.float64,
        pointwise=True,
    )
    pl.warmup(200, 64, chunk_size=64, dtype=jnp.float64, pointwise=True)
    res = pl.loo_streaming(
        lambda idx: dev[idx], 200, 64, chunk_size=64, dtype=jnp.float64,
        pointwise=True,
    )
    assert res["elpd_loo"] == ref["elpd_loo"]
    np.testing.assert_array_equal(
        np.asarray(res.loo_i), np.asarray(ref.loo_i)
    )


@pytest.mark.parametrize("kwargs", [
    {"method": "sis"},
    {"mixture": True},
    {"source": True},
    {"pointwise": True},
])
def test_warmup_variants_run(kwargs):
    res = pl.warmup(256, 50, chunk_size=64, dtype=jnp.float64, **kwargs)
    assert res["wall_s"] > 0
    assert res["n_draws"] == 50


def test_warmup_resolves_default_geometry():
    # no chunk_size: must resolve the same geometry loo_streaming would
    res = pl.warmup(1000, 40, dtype=jnp.float64)
    expected, _ = streaming_mod._resolve_chunk(
        None, 1000, 40, jnp.dtype(jnp.float64), None
    )
    assert res["chunk_size"] == expected


@pytest.fixture
def fresh_cache_state(monkeypatch):
    """Run ``_apply_compilation_cache`` as if for the first time, and put
    JAX's cache settings back afterwards."""
    monkeypatch.setattr(warmup_mod, "_cache_applied", False)
    monkeypatch.delenv("PYLOO_TPU_COMPILE_CACHE", raising=False)
    names = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
    )
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_cache_env_dir_sets_nothing(fresh_cache_state, monkeypatch, tmp_path):
    # JAX reads JAX_COMPILATION_CACHE_DIR itself; the package must not
    # point the cache anywhere else
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    updates = []
    monkeypatch.setattr(
        jax.config, "update", lambda name, val: updates.append(name)
    )
    assert warmup_mod._apply_compilation_cache()
    assert updates == []


def test_cache_env_dir_survives_import(tmp_path):
    import subprocess
    import sys

    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "env"))
    code = "import jax, pyloo_tpu; print(jax.config.jax_compilation_cache_dir)"
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, check=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path / "env")


def test_cache_default_dir_is_in_checkout(fresh_cache_state, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert warmup_mod._apply_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        repo, ".jax_cache"
    )
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("how", ["env", "rcparam"])
def test_cache_mode_off(fresh_cache_state, monkeypatch, how):
    if how == "env":
        monkeypatch.setenv("PYLOO_TPU_COMPILE_CACHE", "off")
    else:
        monkeypatch.setitem(
            pl.rcParams._store, "device.compilation_cache", "off"
        )
    before = jax.config.jax_compilation_cache_dir
    assert not warmup_mod._apply_compilation_cache()
    assert not warmup_mod._cache_applied
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_mode_on_sets_jax_config(fresh_cache_state, monkeypatch):
    monkeypatch.setenv("PYLOO_TPU_COMPILE_CACHE", "on")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert warmup_mod._apply_compilation_cache()
    cache_dir = warmup_mod._DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == cache_dir
    assert os.path.isdir(cache_dir)
    # idempotent
    assert warmup_mod._apply_compilation_cache()


def test_rcparam_validation():
    with pytest.raises(ValueError):
        pl.rcParams["device.compilation_cache"] = "sometimes"
    assert pl.rcParams["device.compilation_cache"] in ("auto", "on", "off")
