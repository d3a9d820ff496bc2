"""Vectorized Pareto-smoothed / truncated / standard importance sampling kernels.

Batched redesign of the reference per-observation kernels
(``pyloo/psis.py:114-231``, ``pyloo/sis.py:86-106``, ``pyloo/tis.py:91-120``):

* The reference runs a Python loop over observations, each doing a full
  ``argsort`` over S draws plus a Zhang-Stephens GPD fit.  Here the whole
  ``(n_obs, S)`` batch is processed in one jitted call.
* Only the top ``M+1`` draws per row are needed (the candidate tail plus the
  cutoff order statistic), so ``lax.top_k`` replaces the O(S log S) sort with
  an O(S·logM)-ish selection; ``M = ceil(min(S/5, 3*sqrt(S/reff)))`` is a
  *static* compile-time constant (reference ``pyloo/psis.py:89``).
* The variable-length tail (strict ``x > xcutoff`` with ties, reference
  ``pyloo/psis.py:139``) is handled with masks over a fixed ``M``-slot buffer,
  never with dynamic shapes, so XLA fuses the elementwise work.
* The Zhang-Stephens empirical-Bayes GPD fit (reference ``pyloo/psis.py:163-208``)
  is vectorized across rows; the candidate-``b`` grid is scanned with
  ``lax.scan`` to bound peak device memory at ``O(n_obs · M)`` per step.

All math follows Vehtari, Simpson, Gelman, Yao, Gabry (2024), "Pareto smoothed
importance sampling", JMLR 25(72), and Zhang & Stephens (2009).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .lse import logsumexp

__all__ = [
    "tail_length",
    "psislw_batch",
    "sislw_batch",
    "tislw_batch",
    "gpdfit",
    "gpinv",
]

_PRIOR_BS = 3.0
_PRIOR_K = 10.0


def tail_length(n_samples: int, reff: float = 1.0) -> int:
    """Static maximum tail size M = ceil(min(S/5, 3*sqrt(S/reff)))."""
    return int(math.ceil(min(n_samples / 5.0, 3.0 * math.sqrt(n_samples / reff))))


def _cutoffmin(dtype) -> float:
    """log of the smallest positive normal float64 (reference uses float tiny)."""
    return float(np.log(np.finfo(np.float64).tiny))


# ---------------------------------------------------------------------------
# Generalized Pareto fit (batched, masked)
# ---------------------------------------------------------------------------


def _softplus(t):
    """log(1 + exp(t)), stable for all t."""
    return jnp.maximum(t, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(t)))


def _log1mexp(t):
    """log(1 - exp(t)) for t <= 0, stable near both ends (NaN for t > 0)."""
    log2 = jnp.asarray(math.log(2.0), dtype=t.dtype)
    return jnp.where(
        t > -log2,
        jnp.log(-jnp.expm1(jnp.minimum(t, 0.0))),
        jnp.log1p(-jnp.exp(t)),
    ) + jnp.where(t > 0, jnp.nan, 0.0)


def _signed_add(sign_a, log_a, sign_b, log_b):
    """Add two signed-log numbers: returns (sign, log|a + b|)."""
    hi = jnp.maximum(log_a, log_b)
    lo = jnp.minimum(log_a, log_b)
    same = sign_a == sign_b
    mag = jnp.where(
        same,
        hi + jnp.log1p(jnp.exp(lo - hi)),
        hi + _log1mexp(lo - hi),
    )
    # -inf + -inf: both zero
    mag = jnp.where(jnp.isneginf(hi), -jnp.inf, mag)
    sign = jnp.where(same, sign_a, jnp.where(log_a >= log_b, sign_a, sign_b))
    return sign, mag


def _log1p_negby(sign_b, log_by):
    """log(1 - b*y) given b*y in signed-log form (sign_b, log|b*y|).

    sign_b < 0 (so -b*y > 0): softplus(log|b*y|).
    sign_b > 0: log(1 - |b*y|), NaN when |b*y| >= 1 — identical failure
    semantics to direct log1p.
    """
    return jnp.where(sign_b < 0, _softplus(log_by), _log1mexp(log_by))


def _gpdfit_batch(log_ary, n, log_quart=None, log_last=None):
    """Zhang-Stephens empirical-Bayes GPD fit, vectorized over rows.

    Range-safe formulation: exceedances enter as *logarithms* and every
    intermediate (the candidate-``b`` grid, the posterior-mean ``b``, the
    scale) is carried in signed-log form.  The direct formulation overflows
    float32's exponent range (values beyond ~1e±38 flush); exceedance
    dynamic ranges of e^±100 are routine for heavy-tailed weights.  Algebraically identical to the reference fit
    (``pyloo/psis.py:163-208``): same grid, same profile likelihood, same
    posterior-mean b, same k shrinkage.

    Parameters
    ----------
    log_ary : (B, M) array
        Log of the exceedances per row in ANY order (the profile likelihood
        only takes masked means); invalid slots hold ``-inf`` (exceedance 0).
    n : (B,) int array
        Number of valid exceedances per row.
    log_quart, log_last : (B,) arrays, optional
        Log of the first-quartile and maximum exceedance order statistics.
        When omitted, ``log_ary`` must be ascending left-aligned and they are
        gathered from it (callers on the hot path pass them and skip the
        gathers).

    Returns
    -------
    k : (B,) array
        Shrunk shape estimate.
    sign_sigma, log_sigma : (B,) arrays
        Scale estimate in signed-log form (``sigma = sign * exp(log)``).
    """
    B, M = log_ary.shape
    dtype = log_ary.dtype
    eps = jnp.finfo(dtype).eps
    nf = n.astype(dtype)

    m_max = 30 + int(math.isqrt(M))
    m_est = (30.0 + jnp.floor(jnp.sqrt(nf))).astype(dtype)  # (B,)
    grid = jnp.arange(1, m_max + 1, dtype=dtype)  # (m_max,)
    grid_valid = grid[None, :] <= m_est[:, None]  # (B, m_max)

    # order statistics entering the b-grid: first quartile and the maximum
    if log_quart is None:
        q_idx = jnp.clip((n + 2) // 4 - 1, 0, M - 1)
        log_quart = jnp.take_along_axis(log_ary, q_idx[:, None], axis=1)[:, 0]
    if log_last is None:
        log_last = jnp.take_along_axis(
            log_ary, jnp.clip(n - 1, 0, M - 1)[:, None], axis=1
        )[:, 0]

    # b_i = 1/y_max + c_i / (3 * y_quart) with c_i = 1 - sqrt(m_est/(i-0.5));
    # c_i < 0 always (i <= m_est), so the second term is negative.
    c = 1.0 - jnp.sqrt(m_est[:, None] / (grid[None, :] - 0.5))  # (B, m_max) < 0
    log_term2 = jnp.log(-c) - jnp.log(jnp.asarray(_PRIOR_BS, dtype)) - log_quart[:, None]
    sign_b, log_b = _signed_add(
        jnp.ones((B, 1), dtype),
        -log_last[:, None] * jnp.ones_like(c),
        -jnp.ones_like(c),
        log_term2,
    )  # (B, m_max)
    # Grid slots beyond m_est (rows whose tail is shorter than the static
    # budget) have c > 0, so log(-c) above is NaN.  They carry zero posterior
    # weight, but NaN beats the -inf masking in the signed-log sums below
    # (-inf + NaN = NaN); pin them to a harmless finite candidate instead.
    sign_b = jnp.where(grid_valid, sign_b, jnp.ones((), dtype))
    log_b = jnp.where(grid_valid, log_b, jnp.zeros((), dtype))

    def profile_loglik(_, cols):
        s_col, l_col = cols  # (B,) each
        # masked mean over the row's exceedances of log1p(-b * y); invalid
        # slots have log_ary = -inf so their contribution is exactly 0
        terms = _log1p_negby(s_col[:, None], l_col[:, None] + log_ary)
        return None, jnp.sum(terms, axis=1) / nf

    _, k_cols = jax.lax.scan(profile_loglik, None, (sign_b.T, log_b.T))
    k_grid = k_cols.T  # (B, m_max)

    # marginal posterior weight of each candidate (log scale), then softmax;
    # log(-(b/k)) = log|b| - log|k| when b and k have opposite signs (always
    # true for feasible candidates), NaN otherwise — matching the reference.
    log_neg_b_over_k = jnp.where(
        sign_b * jnp.sign(k_grid) < 0,
        log_b - jnp.log(jnp.abs(k_grid)),
        jnp.nan,
    )
    len_scale = nf[:, None] * (log_neg_b_over_k - k_grid - 1.0)
    len_scale = jnp.where(grid_valid, len_scale, -jnp.inf)
    ls_max = jnp.max(len_scale, axis=1, keepdims=True)
    w = jnp.where(grid_valid, jnp.exp(len_scale - ls_max), 0.0)
    w = w / jnp.sum(w, axis=1, keepdims=True)
    # prune negligible candidates exactly like the reference (psis.py:194-198)
    w = jnp.where(w >= 10.0 * eps, w, 0.0)
    w = w / jnp.sum(w, axis=1, keepdims=True)

    # posterior mean b in signed-log form: sum of positive and negative parts
    logw = jnp.where(w > 0, jnp.log(w), -jnp.inf)
    wb = logw + log_b
    pos = jnp.where(sign_b > 0, wb, -jnp.inf)
    neg = jnp.where(sign_b < 0, wb, -jnp.inf)
    pos_max = jnp.max(pos, axis=1)
    neg_max = jnp.max(neg, axis=1)
    log_pos = jnp.where(
        jnp.isneginf(pos_max),
        -jnp.inf,
        pos_max + jnp.log(jnp.sum(jnp.exp(pos - pos_max[:, None]), axis=1)),
    )
    log_neg = jnp.where(
        jnp.isneginf(neg_max),
        -jnp.inf,
        neg_max + jnp.log(jnp.sum(jnp.exp(neg - neg_max[:, None]), axis=1)),
    )
    sign_bp, log_bp = _signed_add(
        jnp.ones((B,), dtype), log_pos, -jnp.ones((B,), dtype), log_neg
    )

    k_post = (
        jnp.sum(_log1p_negby(sign_bp[:, None], log_bp[:, None] + log_ary), axis=1)
        / nf
    )
    # sigma = -k/b: positive when k and b have opposite signs
    sign_sigma = -jnp.sign(k_post) * sign_bp
    log_sigma = jnp.log(jnp.abs(k_post)) - log_bp

    # Degenerate fits: the posterior-mean b is a mixed-sign weighted sum, and
    # when it cancels to ~0 both k and sigma = -k/b become 0/0 noise (in
    # float32 the noise can even flip sigma's sign, which poisons the row
    # downstream).  Detect severe cancellation against the total magnitude
    # sum(w*|b|) and substitute the exact b -> 0 limit of the GPD: the
    # exponential distribution with k = 0, sigma = mean(exceedance).
    log_absw_b = jnp.logaddexp(log_pos, log_neg)
    cancelled = log_bp < log_absw_b + jnp.log(jnp.asarray(256.0, dtype) * eps)
    ary_max = jnp.max(log_ary, axis=1)
    safe_max = jnp.where(jnp.isfinite(ary_max), ary_max, 0.0)
    log_mean_z = (
        safe_max
        + jnp.log(jnp.sum(jnp.exp(log_ary - safe_max[:, None]), axis=1))
        - jnp.log(jnp.where(nf == 0, 1.0, nf))
    )
    k_post = jnp.where(cancelled, 0.0, k_post)
    sign_sigma = jnp.where(cancelled, jnp.ones((), dtype), sign_sigma)
    log_sigma = jnp.where(cancelled, log_mean_z, log_sigma)

    k_post = (nf * k_post + _PRIOR_K * 0.5) / (nf + _PRIOR_K)
    return k_post, sign_sigma, log_sigma


def _candidate_grid_y(y, nf, y_quart, y_last):
    """Zhang-Stephens candidate grid from LINEAR exceedances.

    Returns ``(b, grid_valid)``: the (B, m_max) candidate grid and its
    per-row validity mask (reference ``psis.py:184-188``).
    """
    dtype = y.dtype
    M = y.shape[1]
    m_max = 30 + int(math.isqrt(M))
    m_est = (30.0 + jnp.floor(jnp.sqrt(nf))).astype(dtype)
    grid = jnp.arange(1, m_max + 1, dtype=dtype)
    grid_valid = grid[None, :] <= m_est[:, None]

    # b_i = 1/y_max + c_i / (prior_bs * y_quart), c_i = 1 - sqrt(m_est/(i-.5))
    c = 1.0 - jnp.sqrt(m_est[:, None] / (grid[None, :] - 0.5))
    b = 1.0 / y_last[:, None] + c / (_PRIOR_BS * y_quart[:, None])
    b = jnp.where(grid_valid, b, 1.0)  # harmless pin beyond the row's grid
    return b, grid_valid


def _linear_candidate_grid(log_ary, n, log_quart, log_last):
    """Shared precomputation for the linear-domain fit: exceedances and b grid.

    Returns ``(y, nf, b, grid_valid)`` with ``y`` the (B, M) linear
    exceedances (invalid slots exactly 0), ``b`` the (B, m_max) candidate
    grid and ``grid_valid`` its per-row validity mask.
    """
    B, M = log_ary.shape
    dtype = log_ary.dtype
    nf = n.astype(dtype)

    y = jnp.exp(log_ary)  # invalid slots: exp(-inf) = 0 -> log1p term 0
    if log_quart is None:
        q_idx = jnp.clip((n + 2) // 4 - 1, 0, M - 1)
        log_quart = jnp.take_along_axis(log_ary, q_idx[:, None], axis=1)[:, 0]
    if log_last is None:
        log_last = jnp.take_along_axis(
            log_ary, jnp.clip(n - 1, 0, M - 1)[:, None], axis=1
        )[:, 0]
    y_quart = jnp.exp(log_quart)
    y_last = jnp.exp(log_last)
    b, grid_valid = _candidate_grid_y(y, nf, y_quart, y_last)
    return y, nf, b, grid_valid


# Renormalized-product profile scan.  The profile log-likelihood
# sum_j log1p(-b*y_j) collapses to ONE float64 ``log`` per row per candidate
# by taking the log of the PRODUCT of the (strictly positive) factors
# 1 - b*y_j, accumulated as a pairwise tree whose partials are kept inside
# [2^-30, 2^30] by exact power-of-two rescaling with an integer shift count,
# so it stays in range even for a float64 with float32's exponent range.
# Written for hardware where a float64 transcendental costs far more than a
# multiply; whether it still pays on native IEEE float64 is open.
_RENORM_HI = 2.0**30
_RENORM_LO = 2.0**-30
# exact powers of two: rescaling multiplies are exact.  Both directions are
# MULTIPLIES (no division), and the ``where`` evaluates both branches for
# every element.
_RENORM_SCALE = 2.0**60
_RENORM_INV = 2.0**-60
_LOG_RENORM_SCALE = 60.0 * math.log(2.0)


def _renorm(v, sh, steps=1):
    """Rescale positive ``v`` toward [2^-30, 2^30] by exact powers of two.

    ``sh`` counts applied rescales (``v_true = v * _RENORM_SCALE**-sh``).
    The rescale is ONE f64 multiply by a constant selected among
    {2^-60, 1, 2^60} — exact in every case, and half the cost of computing
    both branch products.  Zeros and NaNs pass through: a true zero keeps
    collecting shift decrements, but its final ``log`` is -inf regardless.
    """
    one = jnp.ones((), v.dtype)
    for _ in range(steps):
        hi = v > _RENORM_HI
        lo = v < _RENORM_LO
        v = v * jnp.where(hi, _RENORM_INV, jnp.where(lo, _RENORM_SCALE, one))
        sh = sh + lo.astype(jnp.int32) - hi.astype(jnp.int32)
    return v, sh


def _log_prod_terms(y, b_col):
    """``sum_j log(1 - b*y_j)`` per row via a renormalized product tree.

    Invalid slots of ``y`` are exactly 0 (factor ``1 - b*0 == 1``, an exact
    no-op).  Each multiply carries <= eps relative error and the closing log
    turns those multiplicative errors additive: |error| <= ~2M*eps absolute
    on the log — the same class as the reference's own rounding of the
    term-by-term ``log1p`` sum, and with NO possible cancellation (all
    factors are positive), so unlike pair-merged ``log1p`` rewrites this
    needs no data-dependent accuracy guard and is safe under ``vmap``.
    Leaf magnitude bound: every caller reaches this scan through the
    deep-tail guard (``_LINEAR_FIT_MIN_LOG_QUART``: the quartile exceedance
    satisfies ``y_quart >= e^-60 = 2^-86.6``), the exceedances are
    max-shifted (``y <= 1``), and the Zhang-Stephens grid gives
    ``|b| <= 1/y_last + |c|/(3 y_quart) <= (1 + 11/3) * 2^86.6 < 2^89``
    (|c| < sqrt(2 m_max) <= 11 for every supported tail length), so
    positive leaves lie in ``[2^-54, 1 + 2^89]`` — ONE 2^60 rescale lands
    either end inside [2^-31, 2^30] (hi side: (2^30, 2^89] -> (2^-30, 2^29];
    lo side: [2^-54, 2^-30) -> [2^6, 2^30)), after which one step per tree
    level keeps every partial in band, exactly as before.  The former wide
    ladder (2^360 steps) is unreachable under the guard and was pure
    per-element cost in the scan's hot loop.  Rows the
    guard exempts (n <= 4, khat = inf upstream) may carry inf/NaN anchors;
    those poison only their own row, exactly as before.  Negative leaves
    (infeasible candidates, ``b*y > 1``) end in a NaN/invalid ``log`` —
    matching the reference's NaN from ``log1p`` — under either ladder.
    Interior products of two in-range partials lie in [2^-60, 2^60] and
    need one step.  Odd level widths carry their last column to the next
    level unmultiplied — no power-of-two padding.
    """
    t = 1.0 - b_col[:, None] * y
    sh = jnp.zeros(t.shape, jnp.int32)
    t, sh = _renorm(t, sh, steps=1)
    while t.shape[1] > 1:
        h = t.shape[1] // 2
        odd = t.shape[1] - 2 * h
        tn = t[:, :h] * t[:, h : 2 * h]
        shn = sh[:, :h] + sh[:, h : 2 * h]
        if odd:
            tn = jnp.concatenate([tn, t[:, 2 * h :]], axis=1)
            shn = jnp.concatenate([shn, sh[:, 2 * h :]], axis=1)
        t, sh = _renorm(tn, shn)
    return jnp.log(t[:, 0]) - sh[:, 0].astype(t.dtype) * _LOG_RENORM_SCALE


def _linear_b_post(y, nf, b, valid, product=False):
    """Posterior-mean b over a candidate set (reference ``psis.py:186-205``).

    ``b`` is (B, C) candidates with validity mask ``valid``; the profile
    log-likelihood is scanned column-by-column to bound peak memory at
    O(B*M) per step.  Invalid candidates carry exactly zero weight.

    ``product=True`` evaluates each candidate's profile log-likelihood as
    the log of a renormalized product (:func:`_log_prod_terms`): one f64
    transcendental per row per candidate instead of M.
    """
    dtype = y.dtype
    eps = jnp.finfo(dtype).eps
    nf_safe = jnp.where(nf == 0, 1.0, nf)

    if product:

        def profile_loglik(_, b_col):
            return None, _log_prod_terms(y, b_col) / nf_safe

    else:

        def profile_loglik(_, b_col):
            terms = jnp.log1p(-b_col[:, None] * y)
            return None, jnp.sum(terms, axis=1) / nf_safe

    _, k_cols = jax.lax.scan(profile_loglik, None, b.T, unroll=4)
    k_grid = k_cols.T  # (B, m_max)

    len_scale = nf[:, None] * (jnp.log(-(b / k_grid)) - k_grid - 1.0)
    len_scale = jnp.where(valid, len_scale, -jnp.inf)
    ls_max = jnp.max(len_scale, axis=1, keepdims=True)
    w = jnp.where(valid, jnp.exp(len_scale - ls_max), 0.0)
    w = w / jnp.sum(w, axis=1, keepdims=True)
    # prune negligible candidates exactly like the reference (psis.py:194-198)
    w = jnp.where(w >= 10.0 * eps, w, 0.0)
    w = w / jnp.sum(w, axis=1, keepdims=True)
    return jnp.sum(w * b, axis=1)


def _linear_fit_close(y, nf, b_post, product=False):
    """Final k/sigma from the posterior-mean b (reference ``psis.py:200-207``).

    ``product=True`` evaluates the closing profile sum as a renormalized
    product too (:func:`_log_prod_terms`).
    """
    nf_safe = jnp.where(nf == 0, 1.0, nf)
    if product:
        k_post = _log_prod_terms(y, b_post) / nf_safe
    else:
        k_post = jnp.sum(jnp.log1p(-b_post[:, None] * y), axis=1) / nf_safe
    sign_sigma = jnp.sign(-k_post / b_post)
    log_sigma = jnp.log(jnp.abs(k_post)) - jnp.log(jnp.abs(b_post))
    k_post = (nf * k_post + _PRIOR_K * 0.5) / (nf + _PRIOR_K)
    return k_post, sign_sigma, log_sigma


# Deep-tail guard for the linear f64 fit.  With max-shifted exceedances
# (log_ary <= 0, so y_max <= 1) the linear pipeline's extreme magnitudes are
# bounded by the QUARTILE anchor alone: y_quart underflows for
# log_quart < ~-87 on a float64 with float32's exponent range (b grid
# -> inf -> NaN k), and the candidate products reach ~40 * y_max/y_quart,
# which overflows the same range for log_quart < ~-84 (and full-range IEEE
# f64 for log_quart < ~-705 — the linear fit NaNs on CPU too, measured).
# -60 leaves a wide margin on the narrow range; batches beyond it take
# the signed-log fit, which is domain-unbounded and agrees with the linear
# fit to ~1e-14 where both are defined.
_LINEAR_FIT_MIN_LOG_QUART = -60.0


def _gpdfit_batch_linear(log_ary, n, log_quart=None, log_last=None, product=False):
    """Reference-verbatim Zhang-Stephens fit in LINEAR domain (f64 path).

    Requires ``log_ary <= 0``: exceedances of max-shifted log weights are
    always <= 1 (reference ``psis.py:125-141`` operates on exactly such
    values), so ``exp`` cannot overflow even with float32's exponent
    range — the signed-log machinery of
    :func:`_gpdfit_batch` exists for float32 and for unbounded general
    inputs, and costs ~3-4 transcendentals per grid element where this
    costs one ``log1p``.  Formula-for-formula the reference fit
    (``psis.py:163-208``): same candidate grid, same profile likelihood,
    same posterior-mean b, same k shrinkage.

    Deep tails (quartile exceedance below ``e**-60``) route the whole batch
    to the signed-log fit via a runtime ``lax.cond`` — the linear pipeline
    under/overflows there (see ``_LINEAR_FIT_MIN_LOG_QUART``); ordinary
    batches run the linear branch bit-for-bit as before.

    Same signature/returns as :func:`_gpdfit_batch`; ``product=True`` opts
    the profile-likelihood scans (grid AND closing pass) into the
    renormalized-product evaluation (:func:`_log_prod_terms`) — uniformly
    accurate (error ~M*eps absolute, no cancellation), vmap-safe, and one
    transcendental per candidate instead of M.
    """
    B, M = log_ary.shape
    if log_quart is None:
        q_idx = jnp.clip((n + 2) // 4 - 1, 0, M - 1)
        log_quart = jnp.take_along_axis(log_ary, q_idx[:, None], axis=1)[:, 0]
    if log_last is None:
        log_last = jnp.take_along_axis(
            log_ary, jnp.clip(n - 1, 0, M - 1)[:, None], axis=1
        )[:, 0]

    def linear_fit(_):
        y, nf, b, grid_valid = _linear_candidate_grid(
            log_ary, n, log_quart, log_last
        )
        b_post = _linear_b_post(y, nf, b, grid_valid, product=product)
        return _linear_fit_close(y, nf, b_post, product=product)

    def signed_log_fit(_):
        return _gpdfit_batch(log_ary, n, log_quart=log_quart, log_last=log_last)

    # rows with <= 4 exceedances never smooth (khat = inf upstream) and can
    # carry -inf anchors — they must not force the fallback; NaN anchors
    # compare False and do (the signed-log fit handles them gracefully)
    in_range = jnp.where(n > 4, log_quart >= _LINEAR_FIT_MIN_LOG_QUART, True)
    return jax.lax.cond(jnp.all(in_range), linear_fit, signed_log_fit, None)


def _gpdfit_from_y(y, nf, y_quart, y_last, product=False):
    """Reference-verbatim Zhang-Stephens fit over LINEAR exceedances.

    ``y`` is (B, M) descending linear exceedances with invalid slots exactly
    0 — the reference's own working representation
    (``exp(x_tail) - exp(cutoff)``, ``psis.py:139-150``), so no log-domain
    round trip at all.  Returns ``(k_post, sigma)`` with sigma LINEAR
    (reference ``psis.py:205-208``: ``sigma = -k_post/b_post`` before the
    prior shrinkage of k).
    """
    b, grid_valid = _candidate_grid_y(y, nf, y_quart, y_last)
    b_post = _linear_b_post(y, nf, b, grid_valid, product=product)
    nf_safe = jnp.where(nf == 0, 1.0, nf)
    if product:
        k_post = _log_prod_terms(y, b_post) / nf_safe
    else:
        k_post = jnp.sum(jnp.log1p(-b_post[:, None] * y), axis=1) / nf_safe
    sigma = -k_post / b_post
    k_post = (nf * k_post + _PRIOR_K * 0.5) / (nf + _PRIOR_K)
    return k_post, sigma


# NOTE — two rejected designs for speeding the f64 profile scan, kept for
# the record: (1) a certificate-pruned candidate scan (float32 prescan
# bounding which candidates can survive the reference's ``w >= 10*eps``
# threshold) died because ~40 of the 43 candidates genuinely survive on
# light-tailed data, so the exact fallback fired on essentially every
# realistic batch; (2) a pair-merged ``log1p(-p)+log1p(-q) = log((1-p)(1-q))``
# scan halved the transcendental count but needed a data-dependent accuracy
# guard (catastrophic cancellation when both pair members approach the
# boundary) and a ``lax.cond`` fallback that broke under vmap.  The
# renormalized product tree (:func:`_log_prod_terms`) strictly dominates
# both: one transcendental per candidate, no guard, no cond.


# NOTE — rejected design: a float32 rescaled-linear product-tree fit
# (exceedances divided by the row max so the whole Zhang-Stephens scan runs
# in f32 linear arithmetic via _log_prod_terms, with a lax.cond fallback to
# the signed-log scan for quartile-to-max spans beyond e^60).  It matched
# the signed-log fit only to ~5e-3 on k, and where float32 transcendentals
# are cheap the tree's renormalization ladder (~6 where-selects per leaf)
# costs more than the ~4 transcendentals per element it removes.  Keep
# float32 on the signed-log scan.


def _gpdfit_dispatch(log_exceed, n_tail, log_quart, log_last, product=False):
    """Pick the fit for max-shifted PSIS exceedances (log values <= 0).

    float64 -> the reference-verbatim linear fit (one transcendental per
    element); float32 -> the signed-log fit (robust to exp underflow below
    ~e^-88 — see the rejected-design note above).  ``product`` only affects the
    float64 fit's profile-likelihood evaluation.
    """
    if log_exceed.dtype == jnp.dtype(jnp.float64):
        return _gpdfit_batch_linear(
            log_exceed,
            n_tail,
            log_quart=log_quart,
            log_last=log_last,
            product=product,
        )
    return _gpdfit_batch(
        log_exceed, n_tail, log_quart=log_quart, log_last=log_last
    )


def gpdfit(ary):
    """Fit a GPD to a 1-D (or batched, trailing-axis) ascending sample array.

    Convenience entry point over :func:`_gpdfit_batch` for full (unmasked)
    rows; mirrors reference ``pyloo/psis.py:163-208``.
    """
    ary = jnp.asarray(ary)
    squeeze = ary.ndim == 1
    if squeeze:
        ary = ary[None, :]
    n = jnp.full((ary.shape[0],), ary.shape[1], dtype=jnp.int32)
    k, sign_sigma, log_sigma = _gpdfit_batch(jnp.log(ary), n)
    sigma = sign_sigma * jnp.exp(log_sigma)
    if squeeze:
        return k[0], sigma[0]
    return k, sigma


def _gpinv_masked(probs, kappa, sigma, valid):
    """Inverse GPD CDF at plotting positions, batched with per-row params.

    probs: (B, M) in (0, 1) where ``valid``; kappa, sigma: (B,).
    Reference semantics (``pyloo/psis.py:211-231``): ``sigma <= 0`` poisons the
    row with NaN; near-zero kappa uses the exponential-distribution limit.
    """
    dtype = probs.dtype
    eps = jnp.finfo(dtype).eps
    kap = kappa[:, None]
    log1m = jnp.log1p(-jnp.where(valid, probs, 0.5))
    small_kappa = jnp.abs(kap) < eps
    # guard the division for the small-kappa branch
    safe_kap = jnp.where(small_kappa, 1.0, kap)
    q = jnp.where(small_kappa, -log1m, jnp.expm1(-safe_kap * log1m) / safe_kap)
    q = q * sigma[:, None]
    q = jnp.where(sigma[:, None] > 0, q, jnp.nan)
    return q


def gpinv(probs, kappa, sigma):
    """Inverse GPD CDF for a single parameter pair (host-convenience)."""
    was_1d = np.ndim(probs) == 1
    probs = jnp.atleast_2d(jnp.asarray(probs))
    kap = jnp.full((probs.shape[0],), kappa, dtype=probs.dtype)
    sig = jnp.full((probs.shape[0],), sigma, dtype=probs.dtype)
    ok = (probs > 0) & (probs < 1)
    q = _gpinv_masked(probs, kap, sig, ok)
    q = jnp.where(ok, q, jnp.nan)
    # exact edge handling (probs == 0 / 1), matching psis.py:228-230
    q = jnp.where(probs == 0, 0.0, q)
    upper = jnp.where(kap >= 0, jnp.inf, -sig / jnp.where(kap == 0, 1.0, kap))
    q = jnp.where(probs == 1, upper[:, None] * jnp.ones_like(q), q)
    q = jnp.where(sig[:, None] > 0, q, jnp.nan)
    return q[0] if was_1d else q


# ---------------------------------------------------------------------------
# PSIS
# ---------------------------------------------------------------------------


def _smoothed_tail_desc(tail_vals, xcutoff, tail_max: int):
    """Shared element-level tail smoothing in descending top-k layout.

    Unlike the scatter-free SUM kernels (``loo_kernels._psis_tail_scores``),
    this emits per-ELEMENT smoothed values, so it replicates the reference's
    stable-ascending-argsort plotting positions within tied runs
    (``pyloo/psis.py:152-156``).

    Returns ``(smoothed_desc, slot_valid, n_tail, k, smooth_ok)`` where
    ``smoothed_desc`` is NaN-poisoned on sigma <= 0 fits (reference ``gpinv``
    semantics) and NOT yet truncated at zero.
    """
    dtype = tail_vals.dtype
    B = tail_vals.shape[0]

    in_tail = tail_vals > xcutoff[:, None]  # strict, preserves tie semantics
    n_tail = jnp.sum(in_tail.astype(jnp.int32), axis=1)  # (B,)

    # exceedances carried as logs in DESCENDING layout (the order the top-k
    # already provides): log(exp(x) - exp(xcutoff)) = x + log1mexp(xcutoff-x).
    # The GPD fit only needs masked sums plus two single-element order
    # statistics, and the ascending plotting position of descending slot d is
    # (n - d - 0.5)/n, so no (B, M) gathers are needed.  The log-domain form
    # survives float32's exponent range.
    slot = jnp.arange(tail_max, dtype=jnp.int32)
    slot_valid = slot[None, :] < n_tail[:, None]
    gap = jnp.minimum(xcutoff[:, None] - tail_vals, 0.0)  # <= 0 for valid slots
    log_exceed = jnp.where(slot_valid, tail_vals + _log1mexp(gap), -jnp.inf)

    # ascending index q_idx maps to descending index n - 1 - q_idx
    q_idx = jnp.clip((n_tail + 2) // 4 - 1, 0, tail_max - 1)
    q_desc = jnp.clip(n_tail - 1 - q_idx, 0, tail_max - 1)
    log_quart = jnp.take_along_axis(log_exceed, q_desc[:, None], axis=1)[:, 0]
    log_last = log_exceed[:, 0]

    k, sign_sigma, log_sigma = _gpdfit_dispatch(
        log_exceed, n_tail, log_quart, log_last, product=True
    )

    # inverse-CDF smoothing at plotting positions, in log space:
    # smoothed = log(sigma * qGPD(p; k) + exp(xcutoff))
    #
    # Plotting positions must replicate the reference's STABLE ASCENDING
    # argsort (psis.py:152-156): within a run of tied tail values, the
    # element at the lower original index gets the lower position.  top_k is
    # stable in the opposite direction (ties ordered by increasing original
    # index as the descending slot grows), so the ascending rank of slot d is
    # (n - 1 - run_end) + (d - run_start) — the plain n - 1 - d for distinct
    # values, reversed within each tied run.
    nf = n_tail.astype(dtype)
    eps = jnp.finfo(dtype).eps
    is_run_start = jnp.concatenate(
        [
            jnp.ones((B, 1), bool),
            tail_vals[:, 1:] != tail_vals[:, :-1],
        ],
        axis=1,
    )
    is_run_end = jnp.concatenate(
        [
            tail_vals[:, 1:] != tail_vals[:, :-1],
            jnp.ones((B, 1), bool),
        ],
        axis=1,
    )
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_run_start, slot[None, :], -1), axis=1
    )
    run_end = jax.lax.associative_scan(
        jnp.minimum,
        jnp.where(is_run_end, slot[None, :], tail_max),
        axis=1,
        reverse=True,
    )
    asc_rank = (n_tail[:, None] - 1 - run_end) + (slot[None, :] - run_start)
    probs = (asc_rank.astype(dtype) + 0.5) / jnp.where(nf == 0, 1.0, nf)[:, None]
    probs = jnp.where(slot_valid, probs, 0.5)
    log1m_p = jnp.log1p(-jnp.where(slot_valid, probs, 0.5))
    u = -k[:, None] * log1m_p  # sign(u) == sign(k); expm1(u)/k > 0 always
    abs_u = jnp.abs(u)
    log_abs_expm1 = jnp.where(u >= 0, u, 0.0) + _log1mexp(-abs_u)
    log_q = jnp.where(
        jnp.abs(k)[:, None] < eps,
        jnp.log(-log1m_p),
        log_abs_expm1 - jnp.log(jnp.abs(k))[:, None],
    )
    smoothed_desc = jnp.logaddexp(log_sigma[:, None] + log_q, xcutoff[:, None])
    # sigma <= 0 poisons the row with NaN, matching reference gpinv semantics
    smoothed_desc = jnp.where(sign_sigma[:, None] > 0, smoothed_desc, jnp.nan)

    smooth_ok = (n_tail > 4) & jnp.isfinite(k)
    return smoothed_desc, slot_valid, n_tail, k, smooth_ok


@partial(jax.jit, static_argnames=("tail_max",))
def psislw_batch(log_weights, tail_max: int):
    """Pareto-smooth a batch of log-weight rows.

    Parameters
    ----------
    log_weights : (B, S) array
        Raw log importance weights, one row per observation.
    tail_max : int
        Static tail budget M (from :func:`tail_length`).

    Returns
    -------
    lw : (B, S) array
        Smoothed, truncated-at-zero, logsumexp-normalized log weights.
    khat : (B,) array
        Pareto shape diagnostic; ``inf`` where the tail had <= 4 exceedances.
    """
    x = jnp.asarray(log_weights)
    dtype = x.dtype
    B, S = x.shape
    cutoff_floor = jnp.asarray(_cutoffmin(dtype), dtype=dtype)

    x = x - jnp.max(x, axis=1, keepdims=True)

    # candidate tail: the top M draws; the (M+1)-th largest is the cutoff
    vals, idx = jax.lax.top_k(x, tail_max + 1)  # descending, (B, M+1)
    xcutoff = jnp.maximum(vals[:, tail_max], cutoff_floor)  # (B,)

    tail_vals = vals[:, :tail_max]
    tail_idx = idx[:, :tail_max]
    smoothed_desc, slot_valid, n_tail, k, smooth_ok = _smoothed_tail_desc(
        tail_vals, xcutoff, tail_max
    )

    # scatter the smoothed tail back to original positions
    keep_orig = jnp.take_along_axis(x, tail_idx, axis=1)
    use_smoothed = slot_valid & smooth_ok[:, None]
    scatter_vals = jnp.where(use_smoothed, smoothed_desc, keep_orig)
    rows = jnp.arange(B)[:, None]
    x = x.at[rows, tail_idx].set(scatter_vals)

    # truncate at zero (only when smoothing ran), then self-normalize
    x = jnp.where(smooth_ok[:, None] & (x > 0), 0.0, x)
    x = x - logsumexp(x, axis=1, keepdims=True)

    khat = jnp.where(n_tail <= 4, jnp.inf, k)
    return x, khat


@partial(jax.jit, static_argnames=("tail_max",))
def psislw_compact_batch(log_weights, tail_max: int):
    """Scatter-free PSIS: identical weights to :func:`psislw_batch`, but the
    ``(B, S)`` smoothed matrix is never materialized.

    The smoothed row differs from the raw row only at the <= M tail
    positions, so the full weights decompose into a per-row scalar plus an
    ``O(M)`` correction:

        lw[b, s] = log_weights[b, s] - log_norm[b]      for s not in tail_idx
        lw[b, tail_idx[b, j]] = tail_lw[b, j]           for every slot j

    (the second line also holds for slots beyond the strict tail — they
    carry the first line's value — so consumers may apply all M overrides
    unconditionally).

    Returns
    -------
    log_norm : (B,) array
        Row normalizer: ``raw - log_norm`` is the final log weight off-tail.
    tail_idx : (B, M) int32
        Column indices of the top-M candidate tail, descending by value.
    tail_lw : (B, M) array
        Final (smoothed, truncated, normalized) log weights at ``tail_idx``.
    khat : (B,) array
        Same diagnostic as :func:`psislw_batch`.

    Memory: ``B x (2M + 2)`` instead of ``B x S`` — 7.4x smaller at the
    canonical S=4000 (M=269), and the correction can be applied lazily by
    streaming consumers (e_loo expectations, moment-matching re-weights)
    without a second full-size matrix.
    """
    x_raw = jnp.asarray(log_weights)
    dtype = x_raw.dtype
    B, S = x_raw.shape
    cutoff_floor = jnp.asarray(_cutoffmin(dtype), dtype=dtype)

    C1 = jnp.max(x_raw, axis=1)
    x = x_raw - C1[:, None]

    vals, idx = jax.lax.top_k(x, tail_max + 1)
    xcutoff = jnp.maximum(vals[:, tail_max], cutoff_floor)

    tail_vals = vals[:, :tail_max]
    tail_idx = idx[:, :tail_max]
    smoothed_desc, slot_valid, n_tail, k, smooth_ok = _smoothed_tail_desc(
        tail_vals, xcutoff, tail_max
    )

    use_smoothed = slot_valid & smooth_ok[:, None]
    scatter_vals = jnp.where(use_smoothed, smoothed_desc, tail_vals)
    scatter_vals = jnp.where(
        smooth_ok[:, None] & (scatter_vals > 0), 0.0, scatter_vals
    )

    # normalizer without the scatter: elements strictly above the cutoff are
    # exactly the valid tail slots, so the row's logsumexp splits into the
    # value-masked non-tail mass plus the (possibly smoothed) valid slots
    m1 = jnp.take_along_axis(vals, n_tail[:, None], axis=1)[:, 0]
    m1s = jnp.where(jnp.isfinite(m1), m1, 0.0)
    nontail_mask = x <= xcutoff[:, None]
    log_ntl = m1s + jnp.log(
        jnp.sum(jnp.where(nontail_mask, jnp.exp(x - m1s[:, None]), 0.0), axis=1)
    )
    lse_valid = logsumexp(
        jnp.where(slot_valid, scatter_vals, -jnp.inf), axis=1
    )
    denom = jnp.logaddexp(log_ntl, lse_valid)

    log_norm = C1 + denom
    tail_lw = scatter_vals - denom[:, None]
    khat = jnp.where(n_tail <= 4, jnp.inf, k)
    # cutoff stays in the SHIFTED domain (x - rowmax): consumers re-shift and
    # compare there, reproducing the selection's membership bit-exactly —
    # adding the row max back would re-round and flip boundary elements
    return log_norm, tail_idx, tail_lw, xcutoff, khat


@jax.jit
def compact_weighted_mean(h, log_weights, log_norm, tail_idx, tail_lw, xcutoff):
    """``E[h]`` per row under compact PSIS weights, scatter-free.

    One pass over the raw ``(B, S)`` matrix restricted BY VALUE to the
    non-tail (shifted ``x <= xcutoff``; strict-``>`` defines tail membership,
    so the value mask selects exactly the unsmoothed positions), plus the
    smoothed contributions of the <= M strict-tail slots:

        E_b = sum_{x <= cutoff} h exp(raw - log_norm)
            + sum_{j: x[idx_j] > cutoff} h[idx_j] exp(tail_lw_j)

    An include-then-subtract form would cancel catastrophically: the raw
    unsmoothed tail can exceed the smoothed normalizer by many orders of
    magnitude (that excess is what PSIS smoothing removes), amplifying
    float64 eps to ~1e-6 relative error.  Every term here is bounded by the
    normalized weights instead.  The membership comparison runs in the
    shifted domain (``raw - rowmax``, the identical subtraction the
    selection kernel performed) so boundary elements — the cutoff order
    statistic itself — never flip sides from re-rounding.
    """
    h = jnp.asarray(h)
    lw = jnp.asarray(log_weights)
    x = lw - jnp.max(lw, axis=1, keepdims=True)  # bit-identical to the kernel
    nontail = x <= xcutoff[:, None]
    base = jnp.where(nontail, jnp.exp(lw - log_norm[:, None]), 0.0)
    e = jnp.sum(h * base, axis=1)
    x_at = jnp.take_along_axis(x, tail_idx, axis=1)
    h_at = jnp.take_along_axis(h, tail_idx, axis=1)
    valid = x_at > xcutoff[:, None]
    corr = jnp.sum(jnp.where(valid, h_at * jnp.exp(tail_lw), 0.0), axis=1)
    out = e + corr
    # NaN-poisoned rows (sigma <= 0 fits) must stay NaN — the masks above
    # would otherwise silently drop every term and return 0
    return jnp.where(jnp.isnan(log_norm), jnp.nan, out)


@jax.jit
def compact_weighted_moments(h, log_weights, log_norm, tail_idx, tail_lw, xcutoff):
    """(mean, unbiased variance) of ``h`` under compact PSIS weights.

    Same masked-by-value evaluation as :func:`compact_weighted_mean` (see its
    docstring for why include-then-subtract is numerically forbidden), fused
    so the three row sums the variance needs — ``E[h]``, ``E[h^2]`` and
    ``sum(w^2)`` — share one pass over the raw matrix and one tail gather.

    Variance semantics match :func:`..expectations.weighted_variance_batch`
    (reference ``pyloo/e_loo.py:518-531``): ``(E[h^2]-E[h]^2)/(1-sum w^2)``
    clamped at 0, with constant-``h`` rows and single-dominant-weight rows
    returning exactly 0.
    """
    h = jnp.asarray(h)
    lw = jnp.asarray(log_weights)
    x = lw - jnp.max(lw, axis=1, keepdims=True)  # bit-identical to the kernel
    nontail = x <= xcutoff[:, None]
    w_base = jnp.where(nontail, jnp.exp(lw - log_norm[:, None]), 0.0)
    x_at = jnp.take_along_axis(x, tail_idx, axis=1)
    h_at = jnp.take_along_axis(h, tail_idx, axis=1)
    w_tail = jnp.where(x_at > xcutoff[:, None], jnp.exp(tail_lw), 0.0)

    mean = jnp.sum(h * w_base, axis=1) + jnp.sum(h_at * w_tail, axis=1)
    mean_sq = jnp.sum(h**2 * w_base, axis=1) + jnp.sum(h_at**2 * w_tail, axis=1)
    w_sum_sq = jnp.sum(w_base**2, axis=1) + jnp.sum(w_tail**2, axis=1)

    var = (mean_sq - mean**2) / (1.0 - w_sum_sq)
    var = jnp.maximum(var, 0.0)
    constant = jnp.all(jnp.isclose(h, h[:, :1]), axis=1)
    degenerate = jnp.isclose(w_sum_sq, 1.0)
    var = jnp.where(constant | degenerate, 0.0, var)
    poisoned = jnp.isnan(log_norm)
    return (
        jnp.where(poisoned, jnp.nan, mean),
        jnp.where(poisoned, jnp.nan, var),
    )


# ---------------------------------------------------------------------------
# SIS / TIS
# ---------------------------------------------------------------------------


@jax.jit
def sislw_batch(log_weights):
    """Standard IS: normalize rows; diagnostic is ESS = 1/sum(w^2).

    Reference ``pyloo/sis.py:86-106``.
    """
    x = jnp.asarray(log_weights)
    x = x - jnp.max(x, axis=1, keepdims=True)
    x = x - logsumexp(x, axis=1, keepdims=True)
    ess = 1.0 / jnp.sum(jnp.exp(x) ** 2, axis=1)
    return x, ess


@jax.jit
def tislw_batch(log_weights):
    """Truncated IS (Ionides 2008): cap at log(Z-bar) + 0.5*log(S), renormalize.

    Reference ``pyloo/tis.py:91-120``.
    """
    x = jnp.asarray(log_weights)
    S = x.shape[1]
    x = x - jnp.max(x, axis=1, keepdims=True)
    log_z = logsumexp(x, axis=1, keepdims=True) - jnp.log(
        jnp.asarray(S, dtype=x.dtype)
    )
    cap = log_z + 0.5 * jnp.log(jnp.asarray(S, dtype=x.dtype))
    x = jnp.minimum(x, cap)
    x = x - logsumexp(x, axis=1, keepdims=True)
    ess = 1.0 / jnp.sum(jnp.exp(x) ** 2, axis=1)
    return x, ess
