"""Pareto smoothed importance sampling — public API.

Equivalent of reference ``pyloo/psis.py:25-111`` (``psislw``) over the batched
device kernel in :mod:`pyloo_tpu.ops.psis`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from .base import ISMethod, as_sample_matrix, compute_importance_weights

__all__ = ["psislw", "psislw_compact", "CompactWeights", "ImportanceSamplingResult"]


@dataclass(frozen=True)
class ImportanceSamplingResult:
    """Bundle of everything an importance-sampling pass produced.

    Mirrors the result container the reference exposes from ``psis.py`` so
    downstream code (moment matching, resampling) can consume either library
    interchangeably.

    Attributes
    ----------
    samples : np.ndarray
        The (possibly resampled) posterior draws the weights refer to.
    log_weights : np.ndarray
        Smoothed, truncated, self-normalized log importance weights.
    pareto_k : np.ndarray or float or None
        GPD shape diagnostic(s); ``None`` for methods without one (SIS/TIS).
    warnings : list of str
        Human-readable diagnostics accumulated while computing the weights.
    method : str or None
        Name of the importance-sampling method that produced the weights.
    """

    samples: np.ndarray
    log_weights: np.ndarray
    pareto_k: np.ndarray | float | None = None
    warnings: list[str] = field(default_factory=list)
    method: str | None = "psis"


def psislw(log_weights, reff: float = 1.0):
    """Pareto smoothed importance sampling (PSIS).

    Parameters
    ----------
    log_weights : DataArray or (..., S) array-like
        Log importance weights; the ``__sample__`` dimension (or last axis for
        plain arrays) indexes posterior draws.
    reff : float, default 1
        Relative MCMC efficiency ``ess / S``; sizes the smoothed tail.

    Returns
    -------
    lw_out
        Smoothed, truncated and self-normalized log weights.
    kss
        Estimated shape parameter k of the generalized Pareto distribution,
        per observation (``inf`` when fewer than 5 tail samples exist).

    References
    ----------
    Vehtari et al. (2024). Pareto smoothed importance sampling. JMLR 25(72).
    """
    lw, k = compute_importance_weights(log_weights, method=ISMethod.PSIS, reff=reff)
    if hasattr(k, "rename"):
        k = k.rename("pareto_shape")
    return lw, k


class CompactWeights(NamedTuple):
    """Scatter-free PSIS weights: a per-row scalar plus an O(M) tail patch.

    The full smoothed log-weight matrix never materializes; it is recoverable
    elementwise as

        lw[b, s] = raw[b, s] - log_norm[b]     for s not in tail_idx[b]
        lw[b, tail_idx[b, j]] = tail_lw[b, j]  for every slot j

    ``densify(raw)`` reconstructs the dense matrix (for parity checks);
    ``weighted_mean(h, raw)`` computes ``E[h]`` under the smoothed weights in
    one pass over the raw matrix plus an M-column correction — the lazy-
    consumer form for e_loo / moment-matching at scale.
    """

    log_norm: np.ndarray  # (B,)
    tail_idx: np.ndarray  # (B, M) int32
    tail_lw: np.ndarray  # (B, M)
    xcutoff: np.ndarray  # (B,) tail cutoff in the shifted (x - rowmax) domain
    pareto_k: np.ndarray  # (B,)

    def densify(self, raw_log_weights):
        """Materialize the full (B, S) smoothed log-weight matrix."""
        raw = np.asarray(raw_log_weights)
        lw = raw - np.asarray(self.log_norm)[:, None]
        rows = np.arange(raw.shape[0])[:, None]
        lw[rows, np.asarray(self.tail_idx)] = np.asarray(self.tail_lw)
        return lw

    def weighted_mean(self, h, raw_log_weights):
        """``E[h]`` per row under the smoothed weights, without densifying."""
        from .ops.psis import compact_weighted_mean

        return np.asarray(
            compact_weighted_mean(
                h,
                raw_log_weights,
                self.log_norm,
                self.tail_idx,
                self.tail_lw,
                self.xcutoff,
            )
        )

    def weighted_moments(self, h, raw_log_weights):
        """``(E[h], Var[h])`` per row, scatter-free.

        Variance is the unbiased weighted form ``(E[h^2]-E[h]^2)/(1-sum w^2)``
        clamped at 0, matching :func:`pyloo_tpu.e_loo`'s variance semantics
        (reference ``pyloo/e_loo.py:518-531``); constant-``h`` and
        single-dominant-weight rows return exactly 0.
        """
        from .ops.psis import compact_weighted_moments

        mean, var = compact_weighted_moments(
            h,
            raw_log_weights,
            self.log_norm,
            self.tail_idx,
            self.tail_lw,
            self.xcutoff,
        )
        return np.asarray(mean), np.asarray(var)

    def weighted_sd(self, h, raw_log_weights):
        """Weighted standard deviation per row (sqrt of ``weighted_moments``)."""
        _, var = self.weighted_moments(h, raw_log_weights)
        return np.sqrt(var)

    def weighted_quantile(self, h, raw_log_weights, probs, *,
                          chunk_rows: int = 8192):
        """Interpolated weighted quantiles per row (``(B, n_probs)``).

        Quantiles need each row's full sorted ``h`` regardless of the weight
        representation, so this densifies the smoothed log-weights one
        row-chunk at a time (peak extra memory ``chunk_rows x S``) and runs
        the same device kernel :func:`pyloo_tpu.e_loo` uses — values are
        identical to the dense path for every chunking.
        """
        import jax.numpy as jnp

        from .ops.expectations import weighted_quantile_batch

        h = np.asarray(h)
        raw = np.asarray(raw_log_weights)
        probs = np.atleast_1d(np.asarray(probs, dtype=np.float64))
        n_rows = raw.shape[0]
        out = np.empty((n_rows, probs.size))
        tail_idx = np.asarray(self.tail_idx)
        tail_lw = np.asarray(self.tail_lw)
        log_norm = np.asarray(self.log_norm)
        for s0 in range(0, n_rows, chunk_rows):
            sl = slice(s0, min(s0 + chunk_rows, n_rows))
            lw = raw[sl] - log_norm[sl, None]
            rows = np.arange(lw.shape[0])[:, None]
            lw[rows, tail_idx[sl]] = tail_lw[sl]
            out[sl] = np.asarray(
                weighted_quantile_batch(
                    jnp.asarray(h[sl]), jnp.asarray(lw), probs
                )
            )
        return out


def psislw_compact(log_weights, reff: float = 1.0) -> CompactWeights:
    """PSIS without materializing the smoothed matrix.

    Same smoothing semantics as :func:`psislw` (identical tail membership,
    GPD fit, tie handling, NaN poisoning and normalization), but the result
    is returned in the compact form described by :class:`CompactWeights`:
    ``B x (2M + 2)`` numbers instead of ``B x S`` — the smoothed row differs
    from the raw row only at the <= M tail positions, so everything else is
    one scalar shift per row.

    Parameters
    ----------
    log_weights : DataArray or (..., S) array-like
        Raw log importance weights (same contract as :func:`psislw`).
    reff : float, default 1
        Relative MCMC efficiency; sizes the smoothed tail.

    Notes
    -----
    Observation dims are flattened into the leading axis of every output
    (reshape with the caller's obs shape to restore).  Designed for
    streaming/expectation consumers: ``e_loo``-style weighted means cost one
    pass over the raw matrix plus an M-column gather, and the raw matrix can
    be regenerated chunk-by-chunk instead of held alongside a smoothed copy.
    """
    from .ops import tail_length
    from .ops.psis import psislw_compact_batch

    matrix, n_samples, _ = as_sample_matrix(log_weights)
    if n_samples < 2:
        raise ValueError(
            "importance sampling requires at least 2 draws per observation,"
            f" got {n_samples}"
        )
    m_tail = tail_length(n_samples, reff)
    log_norm, tail_idx, tail_lw, xcutoff, khat = psislw_compact_batch(
        matrix, m_tail
    )
    return CompactWeights(
        np.asarray(log_norm),
        np.asarray(tail_idx),
        np.asarray(tail_lw),
        np.asarray(xcutoff),
        np.asarray(khat),
    )
