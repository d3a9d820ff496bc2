"""Streaming PSIS-LOO for datasets too large to materialize.

The reference workflow (reference ``pyloo/loo.py:41-127``) requires the full
``(n_obs, n_draws)`` log-likelihood in memory — 320 GB at 1e7 x 4000 — which
caps it well below production scale.  On an accelerator the natural design
is the opposite: the *model* lives on device, and the log-likelihood is a pure
function of the observation index, evaluated chunk by chunk through one
jitted per-chunk step (a host loop of async dispatches chained by a
device-resident carry) that fuses evaluation with the PSIS-LOO score kernel
and keeps only O(chunk) live memory.  Nothing crosses the host boundary until
the final scalars (or the optional ``(n_obs,)`` pointwise arrays).

``loo_streaming(log_lik_fn, ...)`` therefore accepts a *traceable* callback::

    def log_lik_fn(obs_idx):          # (chunk,) int32 observation indices
        return ...                    # (chunk, n_draws) log-likelihood

closing over device-resident posterior draws / covariates, and returns the
same :class:`~pyloo_tpu.elpd.ELPDData` as :func:`pyloo_tpu.loo`.
"""

from __future__ import annotations

import warnings
import weakref
import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ._common import good_k_threshold, resolve_scale
from .base import ISMethod
from .containers import DataArray
from .elpd import ELPDData
from .ops import tail_length
from .ops.loo_kernels import (
    loo_scores_psis,
    loo_scores_psis_fast,
    loo_scores_sis,
    loo_scores_tis,
)
from .rcparams import rcParams

__all__ = [
    "loo_streaming",
    "loo_subsample_streaming",
    "e_loo_streaming",
    "waic_streaming",
    "loo_predictive_metric_streaming",
    "loo_group_streaming",
    "loo_score_streaming",
    "loo_compare_streaming",
    "loo_approximate_posterior_streaming",
    "clear_streaming_cache",
]


def _mesh_sharding(mesh):
    if mesh is None:
        return None
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P("obs", None))


# Compiled chunk-generator programs, keyed WEAKLY on the user's callback so
# a dropped callable releases its program and every device buffer the jitted
# closure captured (an lru_cache would pin them for process lifetime).
_GEN_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def clear_streaming_cache(log_lik_fn=None) -> None:
    """Drop memoized streaming chunk-generator programs.

    ``loo_streaming`` / ``loo_subsample_streaming`` memoize the compiled
    generator on the identity of ``log_lik_fn``.  If arrays *captured* by
    that callable change in place (or its globals are rebound), the cached
    program would keep computing from the stale baked-in constants — call
    this (optionally with the specific callable) to force a re-trace.
    """
    if log_lik_fn is None:
        _GEN_CACHE.clear()
    else:
        _GEN_CACHE.pop(log_lik_fn, None)


def _is_chunk_source(obj) -> bool:
    """Disk-backed chunk sources (e.g. :class:`pyloo_tpu.io.NpyLogLik`)."""
    return not callable(obj) and hasattr(obj, "read_rows")


def _source_program(src, chunk_size, n_obs, dtype_str, sharding):
    """Host-side chunk generator over a disk-backed source.

    Same contract as the jitted generator: ``gen(c) -> (chunk, n_draws)``
    device array for chunk index ``c``, tail rows padded (the accumulators
    mask them).  The read happens on the host — overlapped with the device's
    previous chunk by the source's prefetcher — and ships via one
    ``device_put`` per chunk.
    """
    if n_obs > src.n_obs:
        raise ValueError(
            f"n_obs ({n_obs}) exceeds the {src.n_obs} rows in the chunk"
            " source"
        )
    dtype = jnp.dtype(dtype_str)

    def gen(c):
        arr = src.read_rows(int(c) * chunk_size, chunk_size)
        arr = arr.astype(dtype, copy=False)
        if sharding is not None:
            return jax.device_put(arr, sharding)
        return jax.device_put(arr)

    return gen


def _gen_program(log_lik_fn, chunk_size, n_obs, dtype_str, sharding):
    """Jitted chunk generator, memoized on the user's function object.

    Keying on ``log_lik_fn``'s identity (plus the chunk geometry) means
    repeated streaming calls with the same model reuse one compiled
    generator; a closure re-created per call would recompile it every time.
    The flip side: a second call with the *same function object* whose
    captured arrays were mutated returns stale results — see
    :func:`clear_streaming_cache`.  Callables that cannot be weak-referenced
    (e.g. bound methods) are simply not cached.
    """
    if _is_chunk_source(log_lik_fn):
        return _source_program(
            log_lik_fn, chunk_size, n_obs, dtype_str, sharding
        )
    geom_key = (chunk_size, n_obs, dtype_str, sharding)
    try:
        per_fn = _GEN_CACHE.get(log_lik_fn)
        if per_fn is None:
            per_fn = {}
            _GEN_CACHE[log_lik_fn] = per_fn
    except TypeError:
        per_fn = None
    if per_fn is not None and geom_key in per_fn:
        return per_fn[geom_key]

    dtype = jnp.dtype(dtype_str)
    kwargs = {} if sharding is None else {"out_shardings": sharding}

    # Trace the callback ONCE here and hoist every closure-captured array
    # into a runtime argument.  Jitting the closure directly would bake the
    # arrays into the program as literal HLO constants — a 1M x 32 design
    # matrix plus its response vector becomes a ~140 MB serialized module —
    # which multiplies compile latency and re-ships the data at every
    # compile.
    def _traceable(i):
        return jnp.asarray(log_lik_fn(i))

    closed = jax.make_jaxpr(_traceable)(
        np.zeros((chunk_size,), np.int32)
    )
    consts = list(closed.consts)
    jaxpr = closed.jaxpr

    @partial(jax.jit, **kwargs)
    def gen_param(c, consts):
        start = c * chunk_size
        idx = start + jnp.arange(chunk_size, dtype=jnp.int32)
        idx = jnp.minimum(idx, n_obs - 1)
        (ll,) = jax.core.eval_jaxpr(jaxpr, consts, idx)
        return ll.astype(dtype)

    # the cache VALUE references only the jaxpr and the captured arrays,
    # never the callback object itself, so the weak KEY stays collectable;
    # the arrays are pinned exactly as long as the callback that owns them
    def gen(c):
        return gen_param(c, consts)

    # introspection hooks for the cold-start regression tests: the jitted
    # program and the hoisted constants (tests lower `gen.program` and
    # assert the serialized module stays small)
    gen.program = gen_param
    gen.consts = consts

    if per_fn is not None:
        per_fn[geom_key] = gen
    return gen


def _resolve_chunk(chunk_size, n_obs, n_draws, dtype, mesh, budget=(2 << 30)):
    """Final chunk geometry: ``(chunk_size, n_chunks)``.

    An explicit ``chunk_size`` is clamped to ``n_obs`` and rounded DOWN to
    the mesh multiple (historical behavior, also what checkpoint geometry
    was written with).  The auto size used to be the raw ``budget`` bytes of
    ``(chunk, n_draws)`` payload, which leaves the last chunk ragged — up to
    a full chunk of padded rows is wasted compute (7% of the 1M x 4000
    sweep at the 2 GB default).  It now picks the minimal chunk count the
    budget allows and splits the sweep evenly across it, rounding up to the
    multiple, so padding is < multiple rows total.
    """
    multiple = 8 if mesh is None else int(np.lcm(8, mesh.devices.size))
    if chunk_size is None:
        cap = max(budget // (n_draws * dtype.itemsize), 8)
        cap = int(min(cap, n_obs))
        n_chunks = -(-n_obs // cap)
        chunk_size = -(-n_obs // n_chunks)  # even split within the budget
        chunk_size = -(-chunk_size // multiple) * multiple
    else:
        chunk_size = int(min(chunk_size, n_obs))
        chunk_size = max(multiple, chunk_size - chunk_size % multiple)
    return chunk_size, -(-n_obs // chunk_size)


def _kernel_for(method, tail_max, dtype):
    if method == ISMethod.PSIS:
        if dtype == jnp.float32:
            return partial(loo_scores_psis_fast, tail_max=tail_max)
        return partial(loo_scores_psis, tail_max=tail_max)
    if method == ISMethod.SIS:
        return loo_scores_sis
    return loo_scores_tis


# Module-level jitted per-chunk step: scoring + running-sum accumulation.
# Deliberately NOT a closure inside loo_streaming — the jit cache keys on
# (shapes, dtypes, statics), so every loo_streaming call with the same chunk
# geometry reuses one compiled program instead of re-tracing and re-compiling
# the (expensive) score kernel per call.  Only the user's log_lik_fn is
# compiled per call.
def _accum_after_scores(carry, valid, outs, adj, method):
    """Shared accumulation body (traced inside a jitted chunk step)."""
    if len(outs) == 4:  # float32 PSIS fast path: per-row degeneracy flag
        elpd_i, diag, lppd_i, degen = outs
        carry = dict(
            carry,
            n_degen=carry["n_degen"]
            + jnp.sum(degen & valid, dtype=jnp.int32),
        )
    else:
        elpd_i, diag, lppd_i = outs
    if adj is not None:  # Jacobian adjustment, already in elpd units
        elpd_i = elpd_i + adj

    # accumulate in the widest available dtype: float32 running sums lose
    # ~7 digits over 1e7 observations (the per-chunk cast fuses into the sum)
    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    elpd_m = jnp.where(valid, elpd_i, 0.0).astype(acc)
    carry = dict(
        carry,
        sum_e=carry["sum_e"] + jnp.sum(elpd_m),
        sum_e2=carry["sum_e2"] + jnp.sum(elpd_m * elpd_m),
        sum_lppd=carry["sum_lppd"]
        + jnp.sum(jnp.where(valid, lppd_i, 0.0).astype(acc)),
    )
    if method == ISMethod.PSIS:
        k = jnp.where(valid, diag, -jnp.inf)
        carry["n_bad"] = carry["n_bad"] + jnp.sum(
            k > carry["good_k"], dtype=jnp.int32
        )
        carry["k_max"] = jnp.maximum(carry["k_max"], jnp.max(k))
    else:
        carry["diag_min"] = jnp.minimum(
            carry["diag_min"], jnp.min(jnp.where(valid, diag, jnp.inf))
        )
    return carry, elpd_i, diag


@partial(jax.jit, static_argnames=("method", "tail_max"))
def _accumulate_chunk(ll, c, n_obs, carry, adj=None, *, method, tail_max):
    chunk = ll.shape[0]
    idx = c * chunk + jnp.arange(chunk, dtype=jnp.int32)
    valid = idx < n_obs
    outs = _kernel_for(method, tail_max, ll.dtype)(ll)
    return _accum_after_scores(carry, valid, outs, adj, method)


# Mix-IS-LOO chunk step (Silva & Zanella 2022; reference pyloo/loo.py:252-284).
# The mixture normalizer log_norm = logsumexp_i(-c_i) couples observations,
# but it is a pure logsumexp reduction over the obs axis — a running scalar
# carry — so the estimator streams in ONE pass: per chunk accumulate the
# normalizer plus the sums of log_obs_i (and its square, for the SE), then
# close with elpd_i = log_norm - log_obs_i.
@jax.jit
def _mixture_chunk(ll, c, n_obs, carry, adj=None):
    from .ops.lse import logsumexp

    chunk, S = ll.shape
    idx = c * chunk + jnp.arange(chunk, dtype=jnp.int32)
    valid = idx < n_obs
    c_i = logsumexp(-ll, axis=1)
    log_obs = logsumexp(-ll - c_i[:, None], axis=1)
    if adj is not None:
        # elpd_i = log_norm - log_obs (+ adj): fold the Jacobian adjustment
        # into the per-obs term so the closing patch stays log_norm - buf
        log_obs = log_obs - adj
    lppd_i = logsumexp(ll, axis=1, b_inv=S)

    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    chunk_ln = logsumexp(jnp.where(valid, -c_i, -jnp.inf).astype(acc), axis=0)
    lo = jnp.where(valid, log_obs, 0.0).astype(acc)
    carry = dict(
        carry,
        log_norm=jnp.logaddexp(carry["log_norm"], chunk_ln),
        sum_lo=carry["sum_lo"] + jnp.sum(lo),
        sum_lo2=carry["sum_lo2"] + jnp.sum(lo * lo),
        sum_lppd=carry["sum_lppd"]
        + jnp.sum(jnp.where(valid, lppd_i, 0.0).astype(acc)),
    )
    return carry, log_obs, jnp.zeros_like(log_obs)


@jax.jit
def _gather_cols(ll, idx):
    """Post-generator draw reindex (importance-resampled columns).

    Applied to the cached generator's output rather than baked into a
    per-call wrapper closure, so the generator memoization on the user's
    ``log_lik_fn`` identity stays warm across calls.
    """
    return jnp.take(ll, idx, axis=1)


@jax.jit
def _write_chunk(buf, vals, start):
    return jax.lax.dynamic_update_slice(buf, vals, (start,))


# Checkpoint file format version.  Bump when the payload layout changes
# incompatibly; extend ``_COMPATIBLE_CHECKPOINT_VERSIONS`` (with a migration
# in ``_load_checkpoint`` if needed) to keep older files resumable.
# Version history:
#   0 — pre-versioning files (no ``format_version`` entry); same layout as 1.
#   1 — explicit version stamp added.
CHECKPOINT_FORMAT_VERSION = 1
_COMPATIBLE_CHECKPOINT_VERSIONS = frozenset({0, 1})


def _save_checkpoint(path, geometry, chunk, carry, buf_e, buf_d):
    """Atomically persist the streaming state (SURVEY §5 checkpoint/resume).

    The carry is a handful of scalars; the optional pointwise buffers are
    ``(n_chunks * chunk_size,)`` arrays.  The device fetch synchronizes the
    dispatch pipeline — that is the cost of a checkpoint.
    """
    import os

    host_carry = jax.device_get(carry)
    payload = {f"carry_{k}": np.asarray(v) for k, v in host_carry.items()}
    payload["chunk"] = np.asarray(chunk)
    payload["format_version"] = np.asarray(CHECKPOINT_FORMAT_VERSION)
    for k, v in geometry.items():
        payload[f"geom_{k}"] = np.asarray(v)
    if buf_e is not None:
        payload["buf_e"] = np.asarray(jax.device_get(buf_e))
        payload["buf_d"] = np.asarray(jax.device_get(buf_d))
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)


def _load_checkpoint(path, geometry):
    """Load a streaming checkpoint; None if absent.  Raises on geometry
    mismatch (resuming a different problem silently would corrupt results)."""
    import os

    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        # files written before CHECKPOINT_FORMAT_VERSION existed carry no
        # stamp; their layout is identical to version 1, so they load as
        # version 0
        version = int(z["format_version"]) if "format_version" in z.files \
            else 0
        if version not in _COMPATIBLE_CHECKPOINT_VERSIONS:
            if version > CHECKPOINT_FORMAT_VERSION:
                raise ValueError(
                    f"Checkpoint {path!r} has format version {version}, newer"
                    f" than this library's {CHECKPOINT_FORMAT_VERSION}."
                    " Upgrade pyloo_tpu, or delete the file to restart."
                )
            raise ValueError(
                f"Checkpoint {path!r} has unsupported format version"
                f" {version} and no migration is available. Delete the file"
                " to restart from chunk 0."
            )
        for k, v in geometry.items():
            # a missing key means the file was written by an older library
            # version (or a different entry point): same remediation as a
            # value mismatch, never a raw KeyError
            if f"geom_{k}" not in z.files:
                raise ValueError(
                    f"Checkpoint {path!r} has no recorded {k} (written by an"
                    f" older version?), but this run has {k}={v}. Delete the"
                    " file or fix the arguments."
                )
            got = z[f"geom_{k}"]
            if str(got) != str(np.asarray(v)):
                raise ValueError(
                    f"Checkpoint {path!r} was written for {k}={got}, but this"
                    f" run has {k}={v}. Delete the file or fix the arguments."
                )
        out = {
            "chunk": int(z["chunk"]),
            "carry": {
                k[len("carry_"):]: z[k] for k in z.files
                if k.startswith("carry_")
            },
        }
        if "buf_e" in z.files:
            out["buf_e"] = z["buf_e"]
            out["buf_d"] = z["buf_d"]
    return out


def loo_streaming(
    log_lik_fn,
    n_obs: int,
    n_draws: int,
    *,
    reff: float = 1.0,
    chunk_size: int | None = None,
    pointwise: bool = False,
    method: str | ISMethod = "psis",
    mixture: bool = False,
    jacobian_fn=None,
    scale: str | None = None,
    dtype=None,
    mesh=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 64,
    on_chunk=None,
    _column_gather=None,
):
    """LOO-CV over ``n_obs`` observations whose log-likelihood is computed
    on device by ``log_lik_fn`` — no (n_obs, n_draws) matrix is ever built.

    ``_column_gather`` (internal) is an ``(n_draws,)`` int draw-reindex
    applied to each generated chunk on device; its CRC is recorded in the
    checkpoint geometry so a resume with a different reindex is rejected.

    Parameters
    ----------
    log_lik_fn : callable
        Traceable function mapping a ``(chunk,)`` int32 array of observation
        indices to the ``(chunk, n_draws)`` log-likelihood of those
        observations.  It runs under ``jit``; close over device arrays, not
        Python state.  The compiled generator is memoized on this object's
        identity: repeated calls with the same callable are fully warm, but
        if you mutate the arrays it closes over, call
        :func:`clear_streaming_cache` first (or pass a fresh callable).
    n_obs, n_draws : int
        Dataset extent.  ``n_draws`` must be at least 2.
    reff : float
        Relative MCMC efficiency (reference ``pyloo/loo.py:115``).
    chunk_size : int, optional
        Rows per loop step.  The default takes the smallest chunk count
        that keeps each chunk's log-likelihood under ~2 GB and splits the
        sweep evenly across it (no ragged padded last chunk), rounded to a
        multiple of 8 (and of the mesh size when ``mesh`` is given).  A
        checkpoint resume must use the chunk size its file was written
        with — pass it explicitly when upgrading across versions.
    pointwise : bool
        Also return per-observation ``loo_i`` / diagnostics (adds an
        ``(n_obs,)`` device buffer and one host fetch).
    method : {"psis", "sis", "tis"}
        Importance sampling method (reference ``pyloo/loo.py:96``).
    mixture : bool
        Compute Mix-IS-LOO (Silva & Zanella 2022) for draws from a mixture
        of leave-one-out posteriors (reference ``pyloo/loo.py:252-284``).
        The mixture normalizer couples observations, but it is a pure
        logsumexp reduction over the obs axis, so the estimator still
        streams in one pass with a running-scalar carry.  ``method`` is
        ignored (no importance weights are formed) and the diagnostic is
        zero, as in :func:`pyloo_tpu.loo`.
    jacobian_fn : callable, optional
        Traceable ``(chunk,) int32 -> (chunk,)`` function returning the
        Jacobian adjustment for a response-variable transformation
        (reference ``pyloo/loo.py:414-439``), in the units of the scaled
        pointwise elpd — the streamed analogue of :func:`pyloo_tpu.loo`'s
        ``jacobian`` array.  Applied per chunk before accumulation, so
        totals, SEs and pointwise values all reflect the adjustment.
    scale : {"log", "negative_log", "deviance"}, optional
    dtype : optional
        Computation dtype; defaults to ``rcParams["device.precision"]``.
        float32 uses the compact fast PSIS kernel, float64 the exact one.
    mesh : jax.sharding.Mesh, optional
        Mesh with an ``"obs"`` axis; each chunk's rows are sharded across it.
    checkpoint_path : str, optional
        Persist the device-resident carry (and the pointwise buffers, when
        ``pointwise=True``) to this file every ``checkpoint_every`` chunks,
        atomically.  If the file already exists and its geometry matches,
        the run RESUMES from the saved chunk — preemption-safe
        billion-observation sweeps.  Each save synchronizes the pipeline,
        so size ``checkpoint_every`` to several seconds of work.  The file
        is removed on successful completion.  Files are stamped with
        ``CHECKPOINT_FORMAT_VERSION``; incompatible versions raise a
        ``ValueError`` naming the remedy instead of resuming silently.
    checkpoint_every : int
        Chunks between checkpoint saves (default 64).
    on_chunk : callable, optional
        Progress hook ``on_chunk(next_chunk_index, n_chunks)`` invoked
        after each chunk's dispatch (host side, does not synchronize).

    Returns
    -------
    ELPDData with the same rows as :func:`pyloo_tpu.loo`.
    """
    method = ISMethod(method.lower() if isinstance(method, str) else method)
    scale, scale_value = resolve_scale(scale)
    if n_draws < 2:
        raise ValueError("PSIS requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")

    if dtype is None:
        dtype = jnp.dtype(rcParams["device.precision"])
    else:
        dtype = jnp.dtype(dtype)

    chunk_size, n_chunks = _resolve_chunk(
        chunk_size, n_obs, n_draws, dtype, mesh, budget=(2 << 30)
    )

    tail_max = tail_length(n_draws, reff)

    # only the (cheap, user-model) generation step compiles per generator;
    # the score/accumulate step is the module-level cached _accumulate_chunk.
    # The generator program itself is memoized on the user's function object
    # so REPEATED loo_streaming calls are fully warm (a fresh closure per
    # call would re-pay the generator compile every time).
    gen = _gen_program(
        log_lik_fn, chunk_size, n_obs, str(dtype), _mesh_sharding(mesh)
    )

    good_k = good_k_threshold(n_draws)
    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    zero = jnp.zeros((), acc)
    if mixture:
        warnings.warn(
            "Mix-IS-LOO requires a model that is sampled from a mixture of"
            " leave-one-out posteriors. Ensure the log-likelihood generator"
            " passed to `loo_streaming` comes from a model that is sampled"
            " from such a distribution.",
            UserWarning,
            stacklevel=2,
        )
        init = {
            "log_norm": jnp.asarray(-jnp.inf, acc),
            "sum_lo": zero,
            "sum_lo2": zero,
            "sum_lppd": zero,
        }
    else:
        init = {"sum_e": zero, "sum_e2": zero, "sum_lppd": zero}
        if method == ISMethod.PSIS:
            init["good_k"] = jnp.asarray(good_k, dtype)
            init["n_bad"] = jnp.zeros((), jnp.int32)
            init["k_max"] = jnp.asarray(-jnp.inf, dtype)
            if dtype == jnp.float32:
                init["n_degen"] = jnp.zeros((), jnp.int32)
        else:
            init["diag_min"] = jnp.asarray(jnp.inf, dtype)

    # A host loop of *async* dispatches chained by the device-resident carry;
    # nothing is fetched until the end, so dispatch overhead pipelines under
    # the chunk compute.  No buffer donation: donating the carry across
    # sharded steps deadlocked the CPU-mesh collectives (an all_gather
    # rendezvous lost a participant), and the per-step copies it would save
    # are tiny next to the chunk work.
    carry = init
    n_obs_dev = jnp.asarray(n_obs, jnp.int32)
    buf_e = buf_d = None
    if pointwise:
        buf_e = jnp.zeros((n_chunks * chunk_size,), dtype)
        buf_d = jnp.zeros((n_chunks * chunk_size,), dtype)

    if checkpoint_path is not None and checkpoint_every < 1:
        raise ValueError("checkpoint_every must be a positive chunk count")
    col_idx = None
    if _column_gather is not None:
        col_idx = jnp.asarray(np.asarray(_column_gather), jnp.int32)

    geometry = dict(
        n_obs=n_obs, n_draws=n_draws, chunk_size=chunk_size,
        method=method.value, dtype=str(dtype), pointwise=int(pointwise),
        scale=scale, mixture=int(mixture),
        jacobian=int(jacobian_fn is not None),
        colgather=(
            0 if _column_gather is None
            else zlib.crc32(
                np.ascontiguousarray(_column_gather, np.int64).tobytes()
            )
        ),
    )

    jac_gen = None
    if jacobian_fn is not None:
        # adjustments arrive in scaled-elpd units; store them in raw elpd
        # units so they fold into the standard accumulators (scale_value is
        # one of {1, -1, -2}: the division is exact)
        def _jac_program(ci):
            idx = ci * chunk_size + jnp.arange(chunk_size, dtype=jnp.int32)
            vals = jacobian_fn(jnp.minimum(idx, n_obs - 1))
            return jnp.asarray(vals, dtype) / scale_value

        jac_gen = jax.jit(_jac_program)
    start_chunk = 0
    if checkpoint_path is not None:
        loaded = _load_checkpoint(checkpoint_path, geometry)
        if loaded is not None:
            start_chunk = loaded["chunk"]
            carry = {k: jnp.asarray(v) for k, v in loaded["carry"].items()}
            if pointwise:
                buf_e = jnp.asarray(loaded["buf_e"])
                buf_d = jnp.asarray(loaded["buf_d"])

    for c in range(start_chunk, n_chunks):
        ci = jnp.asarray(c, jnp.int32)
        ll = gen(ci)
        if col_idx is not None:
            ll = _gather_cols(ll, col_idx)
        adj = jac_gen(ci) if jac_gen is not None else None
        if mixture:
            carry, elpd_i, diag = _mixture_chunk(
                ll, ci, n_obs_dev, carry, adj
            )
        else:
            carry, elpd_i, diag = _accumulate_chunk(
                ll, ci, n_obs_dev, carry, adj,
                method=method, tail_max=tail_max,
            )
        if pointwise:
            start = jnp.asarray(c * chunk_size, jnp.int32)
            buf_e = _write_chunk(buf_e, elpd_i, start)
            buf_d = _write_chunk(buf_d, diag.astype(dtype), start)
        if checkpoint_path is not None and (c + 1) % checkpoint_every == 0:
            _save_checkpoint(
                checkpoint_path, geometry, c + 1, carry,
                buf_e if pointwise else None,
                buf_d if pointwise else None,
            )
        if on_chunk is not None:
            on_chunk(c + 1, n_chunks)
    out = jax.device_get(carry)
    if checkpoint_path is not None:
        import contextlib
        import os

        with contextlib.suppress(OSError):
            os.remove(checkpoint_path)
    elpd_i_host = diag_host = None
    if pointwise:
        elpd_i_host = np.asarray(jax.device_get(buf_e))[:n_obs]
        diag_host = np.asarray(jax.device_get(buf_d))[:n_obs]

    if mixture:
        # elpd_i = log_norm - log_obs_i, so the sums close in terms of the
        # accumulated sum_lo / sum_lo2 and the final normalizer.
        log_norm = float(out["log_norm"])
        sum_lo = float(out["sum_lo"])
        sum_lo2 = float(out["sum_lo2"])
        sum_e = n_obs * log_norm - sum_lo
        sum_e2 = n_obs * log_norm**2 - 2.0 * log_norm * sum_lo + sum_lo2
    else:
        sum_e = float(out["sum_e"])
        sum_e2 = float(out["sum_e2"])
    lppd = float(out["sum_lppd"])
    var_e = max(sum_e2 / n_obs - (sum_e / n_obs) ** 2, 0.0)

    warn_mg = False
    n_degenerate = int(out.get("n_degen", 0))
    if n_degenerate:
        warnings.warn(
            f"The float32 fast path left {n_degenerate} observations"
            " unsmoothed because their generalized Pareto fit was degenerate"
            " (sigma <= 0). Recompute with dtype=float64 for reference-exact"
            " handling of these observations.",
            UserWarning,
            stacklevel=2,
        )
    if mixture:
        pass  # no importance weights were formed, so no IS diagnostics
    elif method == ISMethod.PSIS:
        if int(out["n_bad"]) > 0:
            warnings.warn(
                "Estimated shape parameter of Pareto distribution is greater"
                f" than {good_k:.2f} for {int(out['n_bad'])} observations."
                " This indicates that importance sampling may be unreliable"
                " because the marginal posterior and LOO posterior are very"
                " different.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True
    else:
        min_ess = float(out["diag_min"])
        if min_ess < n_draws * 0.1:
            warnings.warn(
                f"Low effective sample size detected (minimum ESS:"
                f" {min_ess:.1f}). This indicates that the importance sampling"
                " approximation may be unreliable. Consider using PSIS which"
                " is more robust to such cases.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True

    loo_lppd = scale_value * sum_e
    loo_lppd_se = abs(scale_value) * float((n_obs * var_e) ** 0.5)
    p_loo = lppd - loo_lppd / scale_value
    # matches loo(): sqrt of the population variance of the *scaled* loo_i
    p_loo_se = abs(scale_value) * float(np.sqrt(var_e))
    looic = -2 * loo_lppd
    looic_se = 2 * loo_lppd_se

    from .loo import _assemble

    loo_lppd_i = diagnostic = None
    if pointwise:
        if mixture:
            # the buffers hold log_obs_i (the normalizer closes only after
            # the full pass); diag_host is already all zeros
            elpd_i_host = log_norm - elpd_i_host
        loo_lppd_i = DataArray(
            scale_value * elpd_i_host, ("obs",), name="loo_i"
        )
        diagnostic = DataArray(
            diag_host,
            ("obs",),
            name="pareto_k" if mixture or method == ISMethod.PSIS else "ess",
        )

    result = _assemble(
        mixture, loo_lppd, loo_lppd_se, p_loo, p_loo_se, n_draws, n_obs,
        warn_mg, scale, looic, looic_se,
        loo_lppd_i=loo_lppd_i, diagnostic=diagnostic,
        method=method,
        good_k=good_k if mixture or method == ISMethod.PSIS else None,
    )
    result.fast_path_degenerate = n_degenerate
    if mixture and jac_gen is not None:
        # parity with loo(): its jacobian block re-derives these rows
        # unconditionally (loo.py:277-280), appending them to the mixture
        # layout in this order
        result["p_loo"] = p_loo
        result["p_loo_se"] = p_loo_se
        result["looic"] = looic
        result["looic_se"] = looic_se
    return result


@jax.jit
def _lpd_chunk(ll):
    from .ops.lse import logsumexp

    return logsumexp(ll, axis=1, b_inv=ll.shape[1])


def loo_subsample_streaming(
    log_lik_fn,
    n_obs: int,
    n_draws: int,
    observations=400,
    *,
    estimator: str = "diff_srs",
    elpd_loo_approximation=None,
    reff: float = 1.0,
    chunk_size: int | None = None,
    pointwise: bool = False,
    scale: str | None = None,
    dtype=None,
    mesh=None,
    seed: int | None = None,
):
    """Subsampled LOO (reference ``pyloo/loo_subsample.py:120-539``) where the
    log-likelihood is computed on device by ``log_lik_fn`` — never
    materialized for the full dataset.

    The cheap per-observation approximation (the LPD, computed by streaming
    ``log_lik_fn`` chunk by chunk) ranks/weights all ``n_obs`` observations;
    exact PSIS-LOO then runs on the ``observations``-sized subsample only
    (one ``log_lik_fn`` call), and the chosen survey estimator
    (diff_srs / hh_pps / srs) produces the population elpd with a
    subsampling SE.  Pass ``elpd_loo_approximation`` (an ``(n_obs,)``
    array, e.g. a PLPD computed from posterior means) to skip the streamed
    LPD pass.

    ``log_lik_fn`` is memoized on object identity exactly as in
    :func:`loo_streaming`; see :func:`clear_streaming_cache` if its captured
    arrays change between calls.

    Returns ELPDData with the same rows as :func:`pyloo_tpu.loo_subsample`.
    To support :func:`pyloo_tpu.update_subsample`, the result retains
    ``log_lik_fn`` (pinning its compiled generator and captured device
    buffers) and the ``(n_obs,)`` approximation vector — the streaming
    analogue of the reference storing the full data on the result
    (``loo_subsample.py:593-605``).  ``del result.estimates.stream``
    releases both if you will not update.
    """
    from .constants import EstimatorMethod
    from .estimators import (
        SimpleRandomSamplingEstimator,
        SubsampleIndices,
        compute_sampling_probabilities,
        get_estimator,
        subsample_indices,
    )
    from .ops.loo_kernels import waic_scores  # noqa: F401  (parity with loo_subsample imports)

    if estimator is None:
        estimator = "diff_srs"
    try:
        est_method = EstimatorMethod(estimator.lower())
    except ValueError:
        raise ValueError(
            f"Invalid estimator '{estimator}'. "
            f"Must be one of: {', '.join(m.value for m in EstimatorMethod)}"
        )
    scale, scale_value = resolve_scale(scale)
    if n_draws < 2:
        raise ValueError("PSIS requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")
    if dtype is None:
        dtype = jnp.dtype(rcParams["device.precision"])
    else:
        dtype = jnp.dtype(dtype)

    if isinstance(observations, (int, np.integer)):
        if observations <= 0 or observations > n_obs:
            raise ValueError(
                f"Number of observations must be between 1 and {n_obs}, "
                f"got {observations}"
            )
    elif isinstance(observations, np.ndarray):
        if not np.issubdtype(observations.dtype, np.integer):
            raise TypeError("observations array must contain integers")
        if observations.min() < 0 or observations.max() >= n_obs:
            raise ValueError(
                f"Observation indices must be between 0 and {n_obs - 1}, "
                f"got range [{observations.min()}, {observations.max()}]"
            )
    else:
        raise TypeError(
            "observations must be an integer or an array of integers"
        )

    chunk_size, n_chunks = _resolve_chunk(
        chunk_size, n_obs, n_draws, dtype, mesh, budget=(2 << 30)
    )

    gen = _gen_program(
        log_lik_fn, chunk_size, n_obs, str(dtype), _mesh_sharding(mesh)
    )

    # -- cheap approximation for every observation (streamed LPD) -----------
    if elpd_loo_approximation is not None:
        elpd_loo_approx = np.asarray(elpd_loo_approximation, np.float64).ravel()
        if elpd_loo_approx.shape[0] != n_obs:
            raise ValueError(
                f"elpd_loo_approximation must have length {n_obs}, "
                f"got {elpd_loo_approx.shape[0]}"
            )
    else:
        buf = jnp.zeros((n_chunks * chunk_size,), dtype)
        for c in range(n_chunks):
            ci = jnp.asarray(c, jnp.int32)
            buf = _write_chunk(
                buf, _lpd_chunk(gen(ci)), jnp.asarray(c * chunk_size, jnp.int32)
            )
        elpd_loo_approx = np.asarray(jax.device_get(buf), np.float64)[:n_obs]

    # -- draw the subsample ---------------------------------------------------
    if isinstance(observations, np.ndarray):
        indices = SubsampleIndices(
            idx=observations, m_i=np.ones_like(observations)
        )
    else:
        rng = np.random.default_rng(seed) if seed is not None else None
        indices = subsample_indices(
            estimator=est_method.value,
            elpd_loo_approximation=elpd_loo_approx,
            observations=int(observations),
            rng=rng,
        )

    # -- exact PSIS-LOO on the m sampled rows (one generator call; disk
    # sources serve the scattered indices through their random-access path)
    if _is_chunk_source(log_lik_fn):
        ll_sample = np.asarray(
            log_lik_fn.gather_rows(np.asarray(indices.idx)), np.float64
        )
    else:
        ll_sample = np.asarray(
            jax.device_get(log_lik_fn(jnp.asarray(indices.idx, jnp.int32))),
            np.float64,
        )
    m_tail = tail_length(n_draws, reff)
    elpd_sample, diagnostic, _ = loo_scores_psis(
        jnp.asarray(ll_sample), m_tail
    )
    loo_lppd_i = scale_value * np.asarray(elpd_sample)
    diagnostic = np.asarray(diagnostic)

    # -- population estimates (identical to loo_subsample) -------------------
    estimator_impl = get_estimator(est_method.value)
    p_loo_values = np.var(ll_sample, axis=1)

    if est_method == EstimatorMethod.HH_PPS:
        z = compute_sampling_probabilities(elpd_loo_approx)
        z_sample = z[indices.idx]
        estimates = estimator_impl.estimate(
            z=z_sample, m_i=indices.m_i, y=loo_lppd_i, N=n_obs
        )
        p_loo_estimates = estimator_impl.estimate(
            z=z_sample, m_i=indices.m_i, y=p_loo_values, N=n_obs
        )
    elif est_method == EstimatorMethod.SRS:
        estimates = estimator_impl.estimate(y=loo_lppd_i, N=n_obs)
        p_loo_estimates = estimator_impl.estimate(y=p_loo_values, N=n_obs)
    else:  # diff_srs
        estimates = estimator_impl.estimate(
            y_approx=elpd_loo_approx, y=loo_lppd_i, y_idx=indices.idx
        )
        p_loo_estimates = SimpleRandomSamplingEstimator().estimate(
            y=p_loo_values, N=n_obs
        )

    # the difference estimator's variance estimates can come out negative on
    # small subsamples; clamp at zero so se stays a number (reference leaves
    # this unguarded and leaks NaN)
    p_loo = p_loo_estimates.y_hat
    p_loo_se = np.sqrt(max(p_loo_estimates.hat_v_y, 0.0))
    p_loo_subsampling_se = np.sqrt(max(p_loo_estimates.v_y_hat, 0.0))
    se = np.sqrt(max(estimates.hat_v_y, 0.0))
    subsampling_se = np.sqrt(max(estimates.v_y_hat, 0.0))
    looic = -2 * estimates.y_hat
    looic_se = 2 * se
    looic_subsamp_se = 2 * subsampling_se

    good_k = good_k_threshold(n_draws)
    max_k = np.nanmax(diagnostic) if not np.all(np.isnan(diagnostic)) else 0
    warn_mg = False
    if est_method == EstimatorMethod.SRS:
        # mirror loo_subsample: the reference treats SRS diagnostics as
        # ESS-like (loo_subsample.py:454-464)
        min_ess = float(np.min(diagnostic))
        if min_ess < n_draws * 0.1:
            warnings.warn(
                f"Low effective sample size detected (minimum ESS: {min_ess:.1f}). This"
                " indicates that the importance sampling approximation may be"
                " unreliable. Consider using PSIS which is more robust to such cases.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True
    elif max_k > good_k:
        n_high_k = int(np.sum(diagnostic > good_k))
        warnings.warn(
            "Estimated shape parameter of Pareto distribution is greater than"
            f" {good_k:.2f} for {n_high_k} observations. This indicates that"
            " importance sampling may be unreliable because the marginal"
            " posterior and LOO posterior are very different.",
            UserWarning,
            stacklevel=2,
        )
        warn_mg = True

    rows = [
        ("elpd_loo", estimates.y_hat),
        ("se", se),
        ("p_loo", p_loo),
        ("p_loo_se", p_loo_se),
        ("p_loo_subsampling_se", p_loo_subsampling_se),
        ("n_samples", n_draws),
        ("n_data_points", n_obs),
        ("warning", warn_mg),
    ]
    if pointwise:
        loo_lppd_i_full = np.full(n_obs, np.nan)
        loo_lppd_i_full[indices.idx] = loo_lppd_i
        rows.append(("loo_i", DataArray(loo_lppd_i_full, name="loo_i")))
    rows += [
        ("scale", scale),
        ("good_k", good_k),
        ("subsampling_SE", subsampling_se),
        ("subsample_size", len(indices.idx)),
        ("looic", looic),
        ("looic_se", looic_se),
        ("looic_subsamp_se", looic_subsamp_se),
    ]
    if pointwise:
        rows.append(("pareto_k", diagnostic))
    rows.append(("method", "loo_subsample"))

    result = ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
    result.estimates = estimates
    result.estimates.loo_approximation = (
        "custom" if elpd_loo_approximation is not None else "lpd"
    )
    result.estimates.estimator = est_method.value
    result.estimates.indices = indices
    # stored stream parameters let update_subsample() re-dispatch through
    # the generator interface; the (n_obs,) approximation is reused so the
    # update only streams the new subsample chunk
    result.estimates.stream = dict(
        log_lik_fn=log_lik_fn, n_obs=n_obs, n_draws=n_draws,
        elpd_loo_approximation=elpd_loo_approx, reff=reff,
        chunk_size=chunk_size, dtype=dtype, mesh=mesh,
    )
    return result


@jax.jit
def _waic_chunk(ll, c, n_obs, carry):
    """Per-chunk WAIC accumulation: fused lppd/variance kernel + running
    sums of the (unscaled) pointwise WAIC, its square, p_waic, and the
    var > 0.4 failure count (reference ``pyloo/waic.py:137-154``)."""
    from .ops.loo_kernels import waic_scores

    chunk = ll.shape[0]
    idx = c * chunk + jnp.arange(chunk, dtype=jnp.int32)
    valid = idx < n_obs
    lppd_i, vars_lpd = waic_scores(ll)
    waic_u = lppd_i - vars_lpd  # scale applied on host at the end

    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    w = jnp.where(valid, waic_u, 0.0).astype(acc)
    carry = dict(
        carry,
        sum_w=carry["sum_w"] + jnp.sum(w),
        sum_w2=carry["sum_w2"] + jnp.sum(w * w),
        sum_p=carry["sum_p"]
        + jnp.sum(jnp.where(valid, vars_lpd, 0.0).astype(acc)),
        n_high_var=carry["n_high_var"]
        + jnp.sum((vars_lpd > 0.4) & valid, dtype=jnp.int32),
    )
    return carry, waic_u, vars_lpd


def waic_streaming(
    log_lik_fn,
    n_obs: int,
    n_draws: int,
    *,
    chunk_size: int | None = None,
    pointwise: bool = False,
    scale: str | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """WAIC (:func:`pyloo_tpu.waic`) over ``n_obs`` observations whose
    log-likelihood is computed on device by ``log_lik_fn`` — the
    ``(n_obs, n_draws)`` matrix is never materialized.

    Same generator contract and identity-keyed memoization as
    :func:`loo_streaming`; same result rows as :func:`pyloo_tpu.waic`
    (reference ``pyloo/waic.py:16-207``).
    """
    scale, scale_value = resolve_scale(scale)
    if n_draws < 2:
        raise ValueError("WAIC requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")
    if dtype is None:
        dtype = jnp.dtype(rcParams["device.precision"])
    else:
        dtype = jnp.dtype(dtype)

    chunk_size, n_chunks = _resolve_chunk(
        chunk_size, n_obs, n_draws, dtype, mesh, budget=(2 << 30)
    )

    gen = _gen_program(
        log_lik_fn, chunk_size, n_obs, str(dtype), _mesh_sharding(mesh)
    )

    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    zero = jnp.zeros((), acc)
    carry = {
        "sum_w": zero,
        "sum_w2": zero,
        "sum_p": zero,
        "n_high_var": jnp.zeros((), jnp.int32),
    }
    n_obs_dev = jnp.asarray(n_obs, jnp.int32)
    buf_w = None
    if pointwise:
        buf_w = jnp.zeros((n_chunks * chunk_size,), dtype)

    for c in range(n_chunks):
        ci = jnp.asarray(c, jnp.int32)
        carry, waic_u, _vars = _waic_chunk(gen(ci), ci, n_obs_dev, carry)
        if pointwise:
            buf_w = _write_chunk(
                buf_w, waic_u.astype(dtype), jnp.asarray(c * chunk_size, jnp.int32)
            )
        if on_chunk is not None:
            on_chunk(c + 1, n_chunks)

    out = jax.device_get(carry)
    sum_w = float(out["sum_w"])
    sum_w2 = float(out["sum_w2"])
    p_waic = float(out["sum_p"])
    var_w = max(sum_w2 / n_obs - (sum_w / n_obs) ** 2, 0.0)

    warn_mg = int(out["n_high_var"]) > 0
    if warn_mg:
        warnings.warn(
            "For one or more samples the posterior variance of the log"
            " predictive densities exceeds 0.4. This could be indication of"
            " WAIC starting to fail.",
            UserWarning,
            stacklevel=2,
        )

    waic_sum = scale_value * sum_w
    waic_se = abs(scale_value) * float((n_obs * var_w) ** 0.5)

    rows = [
        ("elpd_waic", waic_sum),
        ("se", waic_se),
        ("p_waic", p_waic),
        ("n_samples", n_draws),
        ("n_data_points", n_obs),
        ("warning", warn_mg),
    ]
    if pointwise:
        waic_i = scale_value * np.asarray(
            jax.device_get(buf_w), np.float64
        )[:n_obs]
        if np.allclose(waic_i, waic_i.flat[0]):
            warnings.warn(
                "The point-wise WAIC is the same with the sum WAIC, please"
                " double check the Observed RV in your model to make sure it"
                " returns element-wise logp.",
                UserWarning,
                stacklevel=2,
            )
        rows.append(("waic_i", DataArray(waic_i, ("obs",), name="waic_i")))
    rows.append(("scale", scale))
    return ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])


# Module-level jitted per-chunk expectation step (same caching rationale as
# _accumulate_chunk: one compiled program per (shape, kind, tail) geometry).
@partial(jax.jit, static_argnames=("kind", "tail_max", "probs"))
def _eloo_chunk(ll, x, *, kind, tail_max, probs):
    from .ops.expectations import (
        khat_batch,
        weighted_mean_batch,
        weighted_quantile_batch,
        weighted_variance_batch,
    )
    from .ops.psis import psislw_batch

    log_ratios = -ll
    lw, _ = psislw_batch(log_ratios, tail_max)
    if kind == "mean":
        value = weighted_mean_batch(x, lw)
    elif kind in ("variance", "sd"):
        value = weighted_variance_batch(x, lw)
        if kind == "sd":
            value = jnp.sqrt(value)
    else:
        value = weighted_quantile_batch(x, lw, jnp.asarray(probs))
    if kind == "quantile":
        k = khat_batch(log_ratios, log_ratios, use_h=False)
    else:
        h = x**2 if kind in ("variance", "sd") else x
        k = khat_batch(h, log_ratios, use_h=True)
    return value, k


def _min_ss_vectorized(k):
    """Vectorized reference ``_pareto_min_ss`` (e_loo.py:393-398)."""
    out = np.full(np.shape(k), np.inf)
    m = ~np.isnan(k) & (k < 1)
    out[m] = 10.0 ** (1.0 / (1.0 - np.maximum(0.0, k[m])))
    return out


def _convergence_rate_vectorized(k, n_samples):
    """Vectorized reference ``_pareto_convergence_rate`` (e_loo.py:406-426).

    Piecewise: NaN -> 0, k < 0 -> 1, k > 1 -> 0, k == 1/2 -> 1 - 1/log(n),
    0 < k < 1 -> the finite-n rate clamped at 0, else (k in {0, 1}) -> 1.
    """
    k = np.asarray(k, dtype=np.float64)
    n = float(n_samples)
    out = np.ones(k.shape)
    out[np.isnan(k)] = 0.0
    out[k > 1] = 0.0
    half = k == 0.5
    out[half] = 1.0 - 1.0 / np.log(n)
    mid = (k > 0) & (k < 1) & ~half
    km = k[mid]
    num = (
        2.0 * (km - 1.0) * n ** (2.0 * km + 1.0)
        + (1.0 - 2.0 * km) * n ** (2.0 * km)
        + n**2
    )
    den = (n - 1.0) * (n - n ** (2.0 * km))
    out[mid] = np.maximum(0.0, num / den)
    return out


def e_loo_streaming(
    log_lik_fn,
    x_fn,
    n_obs: int,
    n_draws: int,
    *,
    type: str = "mean",
    probs=None,
    reff: float = 1.0,
    chunk_size: int | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """Weighted LOO expectations (:func:`pyloo_tpu.e_loo`) for datasets too
    large to materialize ``(n_obs, n_draws)`` matrices.

    The reference's ``e_loo`` (``pyloo/e_loo.py:56-263``) needs both the
    h-sample matrix and the smoothed-weight matrix in memory.  Here both are
    pure functions of the observation index, evaluated chunk by chunk: each
    chunk's rows get PSIS-smoothed weights, the requested expectation, and
    the function-specific Pareto-k diagnostic in one jitted step, and only
    the ``(n_obs,)`` results ever exist.

    Parameters
    ----------
    log_lik_fn : callable
        Traceable ``(chunk,) int32 -> (chunk, n_draws)`` log-likelihood
        (same contract and identity-keyed memoization as
        :func:`loo_streaming`).
    x_fn : callable
        Traceable ``(chunk,) int32 -> (chunk, n_draws)`` h(theta) samples
        whose expectation is taken (e.g. posterior-predictive draws).
    n_obs, n_draws : int
        Dataset extent.
    type : {"mean", "variance", "sd", "quantile"}
    probs : float or sequence, required for ``type="quantile"``.
    reff : float
        Relative MCMC efficiency (sizes the smoothed tail).
    chunk_size, dtype, mesh, on_chunk
        As in :func:`loo_streaming`.

    Returns
    -------
    ExpectationResult
        ``value`` is an ``(n_obs,)`` DataArray (``(n_obs, n_probs)`` for
        quantiles); ``pareto_k`` / ``min_ss`` / ``khat_threshold`` /
        ``convergence_rate`` match :func:`pyloo_tpu.e_loo` semantics.
    """
    from .e_loo import ExpectationResult, _pareto_khat_threshold

    if type not in ("mean", "variance", "sd", "quantile"):
        raise ValueError("type must be 'mean', 'variance', 'sd' or 'quantile'")
    probs_tuple = None
    if type == "quantile":
        if probs is None:
            raise ValueError("probs must be provided for quantile calculation")
        probs_arr = np.atleast_1d(np.asarray(probs, dtype=np.float64))
        if not np.all((probs_arr > 0) & (probs_arr < 1)):
            raise ValueError("probs must be between 0 and 1")
        probs_tuple = tuple(float(p) for p in probs_arr)
    elif probs is not None:
        raise ValueError("probs is only valid for type='quantile'")
    if n_draws < 2:
        raise ValueError("PSIS requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")

    if dtype is None:
        dtype = jnp.dtype(rcParams["device.precision"])
    else:
        dtype = jnp.dtype(dtype)

    # two resident (chunk, S) tensors per step (log-lik and h)
    chunk_size, n_chunks = _resolve_chunk(
        chunk_size, n_obs, n_draws, dtype, mesh, budget=(1 << 30)
    )

    tail_max = tail_length(n_draws, reff)
    sharding = _mesh_sharding(mesh)
    gen_ll = _gen_program(log_lik_fn, chunk_size, n_obs, str(dtype), sharding)
    gen_x = _gen_program(x_fn, chunk_size, n_obs, str(dtype), sharding)

    n_cols = len(probs_tuple) if type == "quantile" else None
    if n_cols is None:
        buf_v = jnp.zeros((n_chunks * chunk_size,), dtype)
    else:
        buf_v = jnp.zeros((n_chunks * chunk_size, n_cols), dtype)
    buf_k = jnp.zeros((n_chunks * chunk_size,), dtype)

    for c in range(n_chunks):
        ci = jnp.asarray(c, jnp.int32)
        value, k = _eloo_chunk(
            gen_ll(ci), gen_x(ci),
            kind=type, tail_max=tail_max, probs=probs_tuple,
        )
        start = jnp.asarray(c * chunk_size, jnp.int32)
        if n_cols is None:
            buf_v = _write_chunk(buf_v, value.astype(dtype), start)
        else:
            buf_v = jax.lax.dynamic_update_slice(
                buf_v, value.astype(dtype), (start, jnp.int32(0))
            )
        buf_k = _write_chunk(buf_k, k.astype(dtype), start)
        if on_chunk is not None:
            on_chunk(c + 1, n_chunks)

    value_host = np.asarray(jax.device_get(buf_v))[:n_obs]
    k_host = np.asarray(jax.device_get(buf_k), np.float64)[:n_obs]

    k_da = DataArray(k_host, ("obs",), name="pareto_k")
    if n_cols is None:
        value_da = DataArray(value_host, ("obs",), name=type)
    else:
        value_da = DataArray(
            value_host,
            ("obs", "quantile"),
            {"quantile": np.asarray(probs_tuple)},
            name=type,
        )
    return ExpectationResult(
        value=value_da,
        pareto_k=k_da,
        min_ss=DataArray(_min_ss_vectorized(k_host), ("obs",)),
        khat_threshold=DataArray(
            np.full(n_obs, _pareto_khat_threshold(n_draws)), ("obs",)
        ),
        convergence_rate=DataArray(
            _convergence_rate_vectorized(k_host, n_draws), ("obs",)
        ),
    )


def loo_predictive_metric_streaming(
    log_lik_fn,
    x_fn,
    y,
    n_obs: int,
    n_draws: int,
    *,
    metric: str = "mae",
    r_eff: float = 1.0,
    chunk_size: int | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """LOO predictive point metric (:func:`pyloo_tpu.loo_predictive_metric`,
    reference ``pyloo/loo_predictive_metric.py:22-231``) for datasets too
    large to materialize: the PSIS-weighted LOO predictive mean streams
    through :func:`e_loo_streaming`, then the metric and its SE are the same
    closed-form host arithmetic as the in-memory path.

    ``x_fn`` generates the posterior-predictive samples
    (``(chunk,) int32 -> (chunk, n_draws)``); ``y`` is the length-``n_obs``
    observed vector (host-resident — 8 bytes/obs).
    """
    from .loo_predictive_metric import (
        _accuracy,
        _balanced_accuracy,
        _mae,
        _mse,
        _rmse,
    )

    y = np.asarray(y).ravel()
    if len(y) != n_obs:
        raise ValueError(
            f"Length of y ({len(y)}) must match n_obs ({n_obs})"
        )
    scorers = {
        "mae": _mae,
        "mse": _mse,
        "rmse": _rmse,
        "acc": _accuracy,
        "balanced_acc": _balanced_accuracy,
    }
    if metric not in scorers:
        raise ValueError(
            f"Invalid metric: {metric}. Must be one of: 'mae', 'mse', 'rmse',"
            " 'acc', 'balanced_acc'"
        )
    pred = e_loo_streaming(
        log_lik_fn,
        x_fn,
        n_obs,
        n_draws,
        type="mean",
        reff=r_eff,
        chunk_size=chunk_size,
        dtype=dtype,
        mesh=mesh,
        on_chunk=on_chunk,
    )
    pred_loo = np.asarray(pred.value.values, np.float64)
    return scorers[metric](y, pred_loo)


@jax.jit
def _logo_chunk(ll, seg, carry):
    """Scatter-add one chunk's rows into the per-group running sums.

    Padded rows of ragged final chunks carry segment id ``n_groups`` (the
    overflow row of the carry) so they never contaminate a real group.
    """
    return carry + jax.ops.segment_sum(
        ll.astype(carry.dtype), seg, num_segments=carry.shape[0]
    )


def loo_group_streaming(
    log_lik_fn,
    group_ids,
    n_obs: int,
    n_draws: int,
    *,
    reff: float = 1.0,
    pointwise: bool = False,
    scale: str | None = None,
    method="psis",
    chunk_size: int | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """Leave-one-group-out CV (:func:`pyloo_tpu.loo_group`, reference
    ``pyloo/loo_group.py:19-379``) where the per-observation log-likelihood
    is computed on device chunk by chunk and scatter-added into the
    ``(n_groups, n_draws)`` group matrix — the ``(n_obs, n_draws)`` matrix
    never exists.  The group-level IS step and result assembly are shared
    with the in-memory path.

    ``group_ids`` is the length-``n_obs`` host vector of group labels;
    the only device-resident state is the group matrix itself, so LOGO over
    1e8 observations aggregated into a few thousand groups is a
    one-chip problem.
    """
    from .loo_group import _logo_result

    scale, scale_value = resolve_scale(scale)
    if n_draws < 2:
        raise ValueError("LOGO requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")
    group_ids = np.asarray(group_ids).ravel()
    if len(group_ids) != n_obs:
        raise ValueError(
            f"Length of group_ids ({len(group_ids)}) must match the number"
            f" of observations ({n_obs})."
        )
    unique_groups, group_index = np.unique(group_ids, return_inverse=True)
    n_groups = len(unique_groups)

    try:
        method = (
            method if isinstance(method, ISMethod) else ISMethod(method.lower())
        )
    except ValueError:
        valid_methods = ", ".join(m.value for m in ISMethod)
        raise ValueError(
            f"Invalid method '{method}'. Must be one of: {valid_methods}"
        )
    if method != ISMethod.PSIS:
        warnings.warn(
            f"Using {method.value.upper()} for LOGO computation. Note that"
            " PSIS is the recommended method as it is typically more"
            " efficient and reliable.",
            UserWarning,
            stacklevel=2,
        )

    if dtype is None:
        dtype = jnp.dtype(rcParams["device.precision"])
    else:
        dtype = jnp.dtype(dtype)
    chunk_size, n_chunks = _resolve_chunk(
        chunk_size, n_obs, n_draws, dtype, mesh, budget=(2 << 30)
    )

    gen = _gen_program(
        log_lik_fn, chunk_size, n_obs, str(dtype), _mesh_sharding(mesh)
    )

    # segment ids, padded with the overflow group for the ragged tail
    seg_host = np.full(n_chunks * chunk_size, n_groups, np.int32)
    seg_host[:n_obs] = group_index.astype(np.int32)

    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    carry = jnp.zeros((n_groups + 1, n_draws), acc)
    for c in range(n_chunks):
        ci = jnp.asarray(c, jnp.int32)
        seg = jnp.asarray(seg_host[c * chunk_size : (c + 1) * chunk_size])
        carry = _logo_chunk(gen(ci), seg, carry)
        if on_chunk is not None:
            on_chunk(c + 1, n_chunks)

    group_ll = np.asarray(jax.device_get(carry), np.float64)[:n_groups]
    return _logo_result(
        group_ll, unique_groups, n_draws, reff, scale, scale_value,
        method, pointwise,
    )


@partial(jax.jit, static_argnames=("tail_max", "scale"))
def _crps_chunk(ll, x, x2, y, perms, *, tail_max, scale):
    """Pointwise (S)CRPS for one chunk: PSIS-weighted E|X-y| plus the
    permutation-averaged E|X-X'| under the joint two-sample weights
    (reference ``pyloo/loo_score.py:277-346``).  ``perms`` is ``(P, S)``;
    the P loop unrolls at trace time (P is small)."""
    from .ops.expectations import weighted_mean_batch
    from .ops.psis import psislw_batch

    lw, k = psislw_batch(-ll, tail_max)
    EXy = weighted_mean_batch(jnp.abs(x - y[:, None]), lw)
    EXX = jnp.zeros_like(EXy)
    for p in range(perms.shape[0]):
        perm = perms[p]
        joint = -ll - ll[:, perm]
        jlw, _ = psislw_batch(joint, tail_max)
        EXX = EXX + weighted_mean_batch(jnp.abs(x - x2[:, perm]), jlw)
    EXX = EXX / perms.shape[0]
    if scale:
        score = -EXy / EXX - 0.5 * jnp.log(EXX)
    else:
        score = 0.5 * EXX - EXy
    return score, k


def loo_score_streaming(
    log_lik_fn,
    x_fn,
    x2_fn,
    y,
    n_obs: int,
    n_draws: int,
    *,
    permutations: int = 1,
    reff: float = 1.0,
    scale: bool = False,
    seed: int | None = None,
    chunk_size: int | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """LOO-CRPS / LOO-SCRPS (:func:`pyloo_tpu.loo_score`, reference
    ``pyloo/loo_score.py:48-274``) for datasets too large to materialize.

    ``x_fn`` / ``x2_fn`` generate the two independent predictive sample sets
    (``(chunk,) int32 -> (chunk, n_draws)``, same contract as
    ``log_lik_fn``); ``y`` is the length-``n_obs`` observed vector.  The
    draw permutations pairing x with x2 are host-drawn once and shared by
    every chunk — identical semantics (and, at equal ``seed``, identical
    permutations) to the in-memory path, so results match it exactly.

    Returns :class:`~pyloo_tpu.loo_score.LooScoreResult` with the pointwise
    scores and Pareto-k diagnostics as ``(n_obs,)`` arrays.
    """
    from .loo_score import LooScoreResult

    if n_draws < 2:
        raise ValueError("PSIS requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")
    if permutations < 1:
        raise ValueError("permutations must be a positive integer")
    y = np.asarray(y).ravel()
    if len(y) != n_obs:
        raise ValueError(
            f"Length of y ({len(y)}) must match n_obs ({n_obs})"
        )

    if dtype is None:
        dtype = jnp.dtype(rcParams["device.precision"])
    else:
        dtype = jnp.dtype(dtype)
    # three resident (chunk, S) tensors per step
    chunk_size, n_chunks = _resolve_chunk(
        chunk_size, n_obs, n_draws, dtype, mesh, budget=(700 << 20)
    )

    tail_max = tail_length(n_draws, reff)
    sharding = _mesh_sharding(mesh)
    gen_ll = _gen_program(log_lik_fn, chunk_size, n_obs, str(dtype), sharding)
    gen_x = _gen_program(x_fn, chunk_size, n_obs, str(dtype), sharding)
    gen_x2 = _gen_program(x2_fn, chunk_size, n_obs, str(dtype), sharding)

    rng = np.random.default_rng(seed)
    perms = jnp.asarray(
        np.stack([rng.permutation(n_draws) for _ in range(permutations)]),
        jnp.int32,
    )
    y_pad = np.zeros(n_chunks * chunk_size, np.float64)
    y_pad[:n_obs] = y

    buf_s = jnp.zeros((n_chunks * chunk_size,), dtype)
    buf_k = jnp.zeros((n_chunks * chunk_size,), dtype)
    for c in range(n_chunks):
        ci = jnp.asarray(c, jnp.int32)
        yc = jnp.asarray(
            y_pad[c * chunk_size : (c + 1) * chunk_size], dtype
        )
        score, k = _crps_chunk(
            gen_ll(ci), gen_x(ci), gen_x2(ci), yc, perms,
            tail_max=tail_max, scale=scale,
        )
        start = jnp.asarray(c * chunk_size, jnp.int32)
        buf_s = _write_chunk(buf_s, score.astype(dtype), start)
        buf_k = _write_chunk(buf_k, k.astype(dtype), start)
        if on_chunk is not None:
            on_chunk(c + 1, n_chunks)

    score_pw = np.asarray(jax.device_get(buf_s), np.float64)[:n_obs]
    pareto_k = np.asarray(jax.device_get(buf_k), np.float64)[:n_obs]

    score_value = float(score_pw.mean())
    score_se = float(score_pw.std() / np.sqrt(score_pw.size))
    estimates = np.array(
        [(score_value, score_se)], dtype=[("Estimate", float), ("SE", float)]
    )[0]
    result = LooScoreResult(estimates=estimates, pointwise=score_pw)

    good_k = good_k_threshold(n_draws)
    result.pareto_k = pareto_k
    result.good_k = good_k
    if np.any(pareto_k > good_k):
        n_high_k = int(np.sum(pareto_k > good_k))
        warnings.warn(
            "Estimated shape parameter of Pareto distribution is greater than"
            f" {good_k:.2f} for {n_high_k} observations. This indicates that"
            " importance sampling may be unreliable because the marginal"
            " posterior and LOO posterior are very different.",
            UserWarning,
            stacklevel=2,
        )
        result.warning = True
    else:
        result.warning = False
    return result


def loo_compare_streaming(
    compare_dict,
    n_obs: int,
    n_draws: int,
    *,
    ic: str = "loo",
    method: str = "stacking",
    b_samples: int = 1000,
    alpha: float = 1,
    seed=None,
    reff: float = 1.0,
    is_method: str | ISMethod = "psis",
    scale: str | None = None,
    chunk_size: int | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """Model comparison (:func:`pyloo_tpu.loo_compare`, reference
    ``pyloo/compare.py:23-264``) where each model's log-likelihood is
    streamed — no model ever materializes its ``(n_obs, n_draws)`` matrix.

    ``compare_dict`` maps model names to chunk generators (the
    ``(chunk,) int32 -> (chunk, n_draws)`` contract of
    :func:`loo_streaming`) or to precomputed pointwise
    :class:`~pyloo_tpu.elpd.ELPDData` results, mixed freely.  Every
    generator entry is scored by :func:`loo_streaming` with
    ``pointwise=True`` — only the ``(n_obs,)`` pointwise elpd vector per
    model is kept, so comparing K models at 1e7 observations holds
    K * n_obs floats instead of K * n_obs * n_draws — and the assembled
    results are ranked and weighted by the standard machinery (stacking /
    BB-pseudo-BMA / pseudo-BMA, pairwise ``elpd_diff`` and ``dse`` from
    the pointwise vectors).  Results are identical to materializing each
    matrix and calling ``loo_compare({name: loo(..., pointwise=True)})``.

    Parameters
    ----------
    compare_dict : dict
        ``{name: log_lik_fn or ELPDData}`` with at least two entries.
    n_obs, n_draws : int
        Dataset extent shared by every generator entry (precomputed
        entries are validated against it).
    ic : {"loo", "waic"}
        Information criterion: generator entries are scored by
        :func:`loo_streaming` or :func:`waic_streaming` respectively
        (``reff`` / ``is_method`` apply to LOO only).
    method, b_samples, alpha, seed
        Weighting options, as :func:`pyloo_tpu.loo_compare`.
    reff, is_method, scale, chunk_size, dtype, mesh
        Streaming-LOO options applied to every generator entry, as
        :func:`loo_streaming` (``is_method`` is its ``method``).
    on_chunk : callable, optional
        Progress hook ``on_chunk(name, next_chunk_index, n_chunks)``.

    Returns
    -------
    pandas.DataFrame ordered best-to-worst, as :func:`loo_compare`.
    """
    from .compare import loo_compare

    if not isinstance(compare_dict, dict):
        raise TypeError("compare_dict must be a dictionary")
    if len(compare_dict) < 2:
        raise ValueError("You must specify at least two models for comparison")
    if ic not in ("loo", "waic"):
        raise ValueError("ic must be 'loo' or 'waic'")

    elpds = {}
    for name, entry in compare_dict.items():
        if isinstance(entry, ELPDData):
            if entry["n_data_points"] != n_obs:
                raise ValueError(
                    f"Precomputed ELPDData for model '{name}' has"
                    f" {entry['n_data_points']} observations; expected"
                    f" {n_obs}."
                )
            elpds[name] = entry
            continue
        hook = None
        if on_chunk is not None:
            hook = partial(on_chunk, name)
        if ic == "waic":
            elpds[name] = waic_streaming(
                entry,
                n_obs,
                n_draws,
                chunk_size=chunk_size,
                pointwise=True,
                scale=scale,
                dtype=dtype,
                mesh=mesh,
                on_chunk=hook,
            )
        else:
            elpds[name] = loo_streaming(
                entry,
                n_obs,
                n_draws,
                reff=reff,
                chunk_size=chunk_size,
                pointwise=True,
                method=is_method,
                scale=scale,
                dtype=dtype,
                mesh=mesh,
                on_chunk=hook,
            )
    return loo_compare(
        elpds,
        ic=ic,
        method=method,
        b_samples=b_samples,
        alpha=alpha,
        seed=seed,
        scale=scale,
    )


def loo_approximate_posterior_streaming(
    log_lik_fn,
    log_p,
    log_q,
    n_obs: int,
    n_draws: int,
    *,
    reff: float = 1.0,
    chunk_size: int | None = None,
    pointwise: bool = False,
    method: str | ISMethod = "psis",
    resample_method: str = "psis",
    seed: int | None = None,
    scale: str | None = None,
    dtype=None,
    mesh=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 64,
    on_chunk=None,
):
    """LOO-CV with a posterior-approximation correction
    (:func:`pyloo_tpu.loo_approximate_posterior`, reference
    ``pyloo/loo_approximate_posterior.py:20-434``) over a streamed
    log-likelihood.

    ``log_p`` (target) and ``log_q`` (proposal) are length-``n_draws``
    vectors at the proposal draws.  The draw-level importance resampling
    (:func:`pyloo_tpu.importance_resample`) runs once on the host —
    identical indices to the in-memory path at equal ``seed`` — and the
    reindex is applied to each generated chunk on device, *after* the
    memoized generator, so repeated calls with the same ``log_lik_fn``
    stay warm.  All other options behave as :func:`loo_streaming`.
    Checkpointing requires an explicit ``seed`` (the resample must be
    reproducible on resume); the resampled indices' CRC is recorded in the
    checkpoint geometry, so a resume whose resample differs is rejected
    instead of silently mixing two draw sets.

    Returns the same :class:`~pyloo_tpu.elpd.ELPDData` as
    :func:`loo_approximate_posterior`, including the
    ``approximate_posterior`` attribute.
    """
    from .loo_approximate_posterior import (
        _validated_resample_indices,
        _warn_non_psis,
    )

    method_is = ISMethod(method.lower() if isinstance(method, str) else method)
    if method_is != ISMethod.PSIS:
        _warn_non_psis(method_is)
    if checkpoint_path is not None and seed is None:
        raise ValueError(
            "checkpoint_path requires an explicit seed: the draw resample"
            " must be reproducible for a resumed run to be consistent."
        )

    log_p, log_q, indices = _validated_resample_indices(
        log_p, log_q, method=resample_method, seed=seed, n_draws=n_draws
    )

    result = loo_streaming(
        log_lik_fn,
        n_obs,
        n_draws,
        _column_gather=indices,
        reff=reff,
        chunk_size=chunk_size,
        pointwise=pointwise,
        method=method_is,
        scale=scale,
        dtype=dtype,
        mesh=mesh,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        on_chunk=on_chunk,
    )
    result.approximate_posterior = {"log_p": log_p, "log_q": log_q}
    return result
