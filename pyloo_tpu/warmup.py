"""Cold-start control: persistent compilation cache + AOT warmup.

The reference is a NumPy library with no compile step; the one axis where a
JIT rebuild is *worse* out of the box is first-call latency (XLA compiles of
the fused PSIS programs take seconds).  Two mitigations live here:

1. :func:`_apply_compilation_cache` — wires JAX's persistent compilation
   cache according to ``rcParams["device.compilation_cache"]``: the
   directory ``JAX_COMPILATION_CACHE_DIR`` names when it is set, else
   ``.jax_cache`` in the checkout.
2. :func:`warmup` — compiles the streaming estimator's device programs for a
   given data geometry by pushing one synthetic chunk through the real code
   path.  The heavy programs (``_accumulate_chunk`` and friends) are
   module-level jits keyed on shapes + statics, so the user's first real
   call then only compiles their own log-likelihood generator.  Call it at
   service startup / notebook top, before the data arrives.
"""

from __future__ import annotations

import logging
import os
import time
import warnings

import jax
import jax.numpy as jnp

from .rcparams import rcParams

__all__ = ["warmup"]

_log = logging.getLogger(__name__)
_cache_applied = False


# Fixed cache location inside the checkout: the path is part of the cache
# key, so a directory that moves between runs never hits.
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _apply_compilation_cache() -> bool:
    """Configure the persistent XLA compilation cache once per process.

    Returns True when the cache is enabled.  Controlled by
    ``rcParams["device.compilation_cache"]`` (or the
    ``PYLOO_TPU_COMPILE_CACHE`` environment variable, read at import):
    "off" leaves it alone, "on" and "auto" enable it.  When
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads the directory
    from it and nothing is set here; otherwise the cache lives in
    ``<checkout>/.jax_cache``.
    """
    global _cache_applied
    if _cache_applied:
        return True
    mode = os.environ.get("PYLOO_TPU_COMPILE_CACHE", "").lower() or rcParams[
        "device.compilation_cache"
    ]
    if mode == "off":
        return False
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(_DEFAULT_CACHE_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE_DIR)
            # cache everything that took a noticeable compile; the fused
            # PSIS programs take seconds
            jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
            jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        except Exception as err:  # pragma: no cover - read-only checkout
            _log.warning("could not enable the XLA compilation cache: %s", err)
            return False
    _cache_applied = True
    return True


class _ZeroSource:
    """Minimal in-memory chunk source (read_rows protocol) for warmup."""

    def __init__(self, n_obs, n_draws):
        self.n_obs = n_obs
        self.n_draws = n_draws

    def read_rows(self, start, n_rows):
        import numpy as np

        base = np.arange(n_rows, dtype=np.float64)[:, None] * 1e-3
        sweep = np.arange(self.n_draws, dtype=np.float64)[None, :] * 1e-4
        return -1.0 - base - sweep


def warmup(
    n_obs: int,
    n_draws: int,
    *,
    chunk_size: int | None = None,
    dtype=None,
    method: str = "psis",
    reff: float = 1.0,
    pointwise: bool = False,
    mixture: bool = False,
    mesh=None,
    source: bool = False,
) -> dict:
    """Pre-compile the streaming LOO programs for a data geometry.

    Runs one synthetic chunk through :func:`pyloo_tpu.loo_streaming` with
    exactly the chunk geometry a real ``(n_obs, n_draws)`` sweep would
    resolve, so XLA compiles (and the persistent cache stores) the fused
    score/accumulate programs ahead of the data.  The first real call then
    pays only the compile of the user's own log-likelihood generator.

    Statics that key the compiled programs and therefore must match the
    later call: ``n_draws``, ``chunk_size`` (or the default geometry derived
    from ``n_obs``), ``dtype`` (or ``rcParams['device.precision']``),
    ``method``, ``reff`` (through the tail length), ``pointwise``,
    ``mixture``, and the mesh shape.  Set ``source=True`` when the real data
    will arrive through a disk-backed source (``loo_from_file`` /
    ``NpyLogLik``), whose chunks are shipped from the host instead of
    generated on the device.

    Returns a dict with the resolved geometry and the warmup wall time.

    Example
    -------
    >>> pl.warmup(1_000_000, 4000, dtype=jnp.float32)   # at service startup
    >>> pl.loo_streaming(my_log_lik, 1_000_000, 4000, dtype=jnp.float32)
    """
    from .streaming import _resolve_chunk, loo_streaming

    _apply_compilation_cache()

    if dtype is None:
        dtype = jnp.dtype(rcParams["device.precision"])
    else:
        dtype = jnp.dtype(dtype)
    chunk_size, _ = _resolve_chunk(chunk_size, n_obs, n_draws, dtype, mesh)

    t0 = time.perf_counter()
    if source:
        src = _ZeroSource(chunk_size, n_draws)
        fn = src
    else:
        def fn(idx):  # deterministic, non-constant rows; no RNG programs
            base = -1.0 - idx.astype(dtype)[:, None] * dtype.type(1e-3)
            sweep = jnp.arange(n_draws, dtype=dtype)[None, :] * dtype.type(1e-4)
            return base - sweep

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # mixture advisory, degenerate-k etc.
        loo_streaming(
            fn,
            chunk_size,  # one chunk: compiles everything, executes once
            n_draws,
            reff=reff,
            chunk_size=chunk_size,
            pointwise=pointwise,
            method=method,
            mixture=mixture,
            dtype=dtype,
            mesh=mesh,
        )
    wall = time.perf_counter() - t0
    return {
        "chunk_size": chunk_size,
        "n_draws": n_draws,
        "dtype": str(dtype),
        "method": method,
        "pointwise": pointwise,
        "mixture": mixture,
        "source": source,
        "wall_s": wall,
        "compilation_cache": _cache_applied,
    }
