"""Fused per-observation LOO score kernels.

One jitted program per method computes, from a raw log-likelihood block,
everything ``loo()`` needs per observation: the IS-weighted elpd, the
diagnostic, and the in-sample lppd.  This fuses what the reference computes
in three separate ufunc passes over the data (reference ``pyloo/loo.py:286-337``)
into a single read of the ``(n_obs, S)`` tensor.

Two PSIS variants share one scoring core (:func:`_psis_tail_scores`):

* ``loo_scores_psis`` — the REFERENCE-EXACT path (float64 semantics:
  NaN-poisoning ``gpinv`` on sigma <= 0, strict-``>`` tie membership,
  reference ``pyloo/psis.py:114-231``).  Selection uses the exact f64
  segmented cascade directly on the float64 rows, and the GPD fit runs the
  reference-verbatim LINEAR-domain formulas
  (:func:`~pyloo_tpu.ops.psis._gpdfit_batch_linear` — exceedances of
  max-shifted weights are <= 1, so the linear pipeline cannot overflow).
* ``loo_scores_psis_fast`` — the float32 throughput path (segmented
  cascade); diverges from the reference only on fit degeneracies
  (sigma <= 0 rows keep their unsmoothed tail) and reports those rows in a
  fourth per-row ``degenerate`` output.

Both are scatter-free.  Identity making this possible: with
``x = -ll - C`` (C the row max of ``-ll``), every non-tail element satisfies
``x_smoothed + ll = -C`` exactly, so

    lse(x_s + ll) = -C + log((S - n_tail) + sum_tail exp(s_j - x_j))
    lse(x_s)      = log(sum_nontail exp(x) + sum_tail exp(s_j))

and the elpd closes over the ``(B, M)`` compacted tail — no scatter back
into the ``(B, S)`` array, no full sort.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .lse import logsumexp
from .selection import topk_vals_desc
from .psis import (
    _LINEAR_FIT_MIN_LOG_QUART,
    _gpdfit_batch,
    _gpdfit_from_y,
    _log1mexp,
    sislw_batch,
    tislw_batch,
)

__all__ = [
    "loo_scores_psis",
    "loo_scores_psis_fast",
    "loo_scores_sis",
    "loo_scores_tis",
    "mixture_scores",
    "waic_scores",
]

_CUTOFF_FLOOR = float(np.log(np.finfo(np.float64).tiny))


def _psis_tail_scores(
    tail_vals, xcutoff, log_ntl, C, S: int, *, exact: bool, product: bool = False
):
    """Fused GPD fit + smoothing + elpd reductions over the compacted tail.

    Parameters
    ----------
    tail_vals : (B, M) array
        Descending shifted top-M values (the candidate tail, cutoff slot
        excluded).
    xcutoff : (B,) array
        Tail cutoff: ``max((M+1)-th order statistic, log(float64 tiny))``
        (reference ``pyloo/psis.py:89-90``).
    log_ntl : (B,) array
        ``log sum_{x <= xcutoff} exp(x)`` over the full shifted row (the
        non-tail mass, complementary to the strict-``>`` tail membership).
    C : (B,) array
        Row max of the raw ``x = -log_lik``.
    S : int
        Full row width (draw count).
    exact : bool (static)
        True: reference semantics — rows whose GPD fit yields sigma <= 0
        are NaN-poisoned exactly like reference ``gpinv``
        (``pyloo/psis.py:211-231``).  False: throughput semantics — those
        rows keep their unsmoothed tail and are flagged in ``degenerate``.

    Returns
    -------
    (elpd_i, khat, degenerate) : ((B,), (B,), (B,) bool)
    """
    dtype = tail_vals.dtype
    M = tail_vals.shape[1]
    in_tail = tail_vals > xcutoff[:, None]  # strict, preserves tie semantics
    n_tail = jnp.sum(in_tail.astype(jnp.int32), axis=1)
    nf = n_tail.astype(dtype)

    # everything stays in DESCENDING layout: the GPD fit takes masked sums
    # (order-free) plus two single-element order statistics, and the plotting
    # position of descending slot d is (n - d - 0.5)/n — no (B, M) gathers.
    # Tie note: within a run of equal tail values the reference assigns
    # ascending plotting positions by stable argsort order; the multiset of
    # smoothed values over the run is permutation-invariant, so every SUM
    # below (and hence elpd) is identical — order only matters for
    # element-level weights, which this scatter-free kernel never emits.
    slot = jnp.arange(M, dtype=jnp.int32)
    slot_valid = slot[None, :] < n_tail[:, None]

    # ascending index q_idx maps to descending index n - 1 - q_idx
    q_idx = jnp.clip((n_tail + 2) // 4 - 1, 0, M - 1)
    q_desc = jnp.clip(n_tail - 1 - q_idx, 0, M - 1)
    eps = jnp.finfo(dtype).eps
    nf_safe = jnp.where(nf == 0, 1.0, nf)
    # plotting positions: 1 - p_d == (slot + 0.5)/n exactly, so log1p(-p)
    # decomposes into log(slot + 0.5) - log(n) — M shared constants plus ONE
    # f64 log per row instead of M log1p per row (the reference's
    # term-by-term form, psis.py:216-218, deviates only at eps per element).
    # Invalid slots keep a probs->0.5 pin.
    log_slot = jnp.log(slot.astype(dtype) + 0.5)
    log1m_p = jnp.where(
        slot_valid,
        log_slot[None, :] - jnp.log(nf_safe)[:, None],
        jnp.asarray(np.log(0.5), dtype),
    )

    def _log_domain_smooth(_):
        # LOG domain end to end — float32's only option (linear weights
        # underflow below e^-88 in f32, which would zero out exactly the
        # heavy tails PSIS exists to smooth), and float64's deep-tail
        # fallback (the linear pipeline under/overflows once the quartile
        # exceedance leaves the representable range — see
        # ``_LINEAR_FIT_MIN_LOG_QUART``).
        gap = jnp.minimum(xcutoff[:, None] - tail_vals, 0.0)
        log_exceed = jnp.where(slot_valid, tail_vals + _log1mexp(gap), -jnp.inf)
        log_quart = jnp.take_along_axis(log_exceed, q_desc[:, None], axis=1)[
            :, 0
        ]
        # the signed-log fit directly: identical to _gpdfit_dispatch for
        # float32, and for float64 this branch IS the deep-tail fallback —
        # routing through the dispatch would nest a second (dead) linear
        # fit + cond into the compiled program for nothing
        k, sign_sigma, log_sigma = _gpdfit_batch(
            log_exceed, n_tail, log_quart=log_quart, log_last=log_exceed[:, 0]
        )
        u = -k[:, None] * log1m_p
        abs_u = jnp.abs(u)
        log_abs_expm1 = jnp.where(u >= 0, u, 0.0) + _log1mexp(-abs_u)
        log_q = jnp.where(
            jnp.abs(k)[:, None] < eps,
            jnp.log(-log1m_p),
            log_abs_expm1 - jnp.log(jnp.abs(k))[:, None],
        )
        smoothed = jnp.logaddexp(log_sigma[:, None] + log_q, xcutoff[:, None])
        smoothed = jnp.minimum(smoothed, 0.0)  # truncate weights at exp(0)
        return k, smoothed, sign_sigma > 0

    if dtype == jnp.dtype(jnp.float64):
        # Reference-verbatim LINEAR pipeline (psis.py:138-157): exceedances
        # ``exp(x_tail) - exp(cutoff)``, linear Zhang-Stephens fit, linear
        # gpinv, one closing log per element.  Max-shifted tails are <= 1 so
        # nothing overflows, and intermediate expm1 overflow (heavy k) only
        # produces values the final 0-truncation clamps exactly like the
        # reference's own ``x[x > 0] = 0``.  Beyond the parity argument this
        # is the cheap form: 2 transcendentals per element against ~5 for
        # the log-domain branch.
        def _linear_smooth(_):
            expxcutoff = jnp.exp(xcutoff)
            y = jnp.where(
                slot_valid, jnp.exp(tail_vals) - expxcutoff[:, None], 0.0
            )
            y_quart = jnp.take_along_axis(y, q_desc[:, None], axis=1)[:, 0]
            k, sigma = _gpdfit_from_y(y, nf, y_quart, y[:, 0], product=product)
            # reference _gpinv (psis.py:211-231): probs strictly inside (0,1).
            # sigma/k enter as ONE per-row factor instead of an (B, M)
            # elementwise f64 divide; the single extra rounding
            # (x*(sigma/k) vs sigma*(x/k)) is ~1 ulp, far inside the 1e-12
            # parity budget.
            sig_over_k = sigma / jnp.where(k == 0, 1.0, k)
            q_lin = jnp.where(
                jnp.abs(k)[:, None] < eps,
                sigma[:, None] * -log1m_p,
                sig_over_k[:, None] * jnp.expm1(-k[:, None] * log1m_p),
            )
            smoothed = jnp.minimum(jnp.log(q_lin + expxcutoff[:, None]), 0.0)
            return k, smoothed, sigma > 0

        # Deep-tail guard: when the quartile exceedance sits below e^-60,
        # the linear pipeline loses the fit to exp underflow on an f64 with
        # float32's exponent range, and IEEE f64 itself overflows beyond
        # ~705 nats.  One gather + one log1mexp per ROW decides the branch;
        # ordinary batches run the linear pipeline bit-for-bit.
        q_tail = jnp.take_along_axis(tail_vals, q_desc[:, None], axis=1)[:, 0]
        log_quart_row = q_tail + _log1mexp(jnp.minimum(xcutoff - q_tail, 0.0))
        in_range = jnp.where(
            n_tail > 4, log_quart_row >= _LINEAR_FIT_MIN_LOG_QUART, True
        )
        k, smoothed, sigma_pos = jax.lax.cond(
            jnp.all(in_range), _linear_smooth, _log_domain_smooth, None
        )
    else:
        k, smoothed, sigma_pos = _log_domain_smooth(None)

    would_smooth = (n_tail > 4) & jnp.isfinite(k)
    degenerate = would_smooth & ~sigma_pos
    if exact:
        # reference gpinv semantics: sigma <= 0 poisons the row with NaN
        smoothed = jnp.where(sigma_pos[:, None], smoothed, jnp.nan)
        smooth_ok = would_smooth
    else:
        # throughput-path divergence: degenerate fits (a float32 artifact;
        # the same rows are clean in float64) keep the unsmoothed tail
        smooth_ok = would_smooth & sigma_pos
    s_vals = jnp.where(smooth_ok[:, None], smoothed, tail_vals)

    # Row reductions, all in log domain.  Two pitfalls make the "obvious"
    # exp-space forms wrong (caught by TestFastPathAdversarial):
    #   * sum(exp(x)) - sum(exp(tail)) cancels catastrophically when the tail
    #     carries ~all of the exp mass (heavy-tail rows) — the non-tail mass
    #     must be summed directly under the x <= xcutoff mask (done by the
    #     caller, who owns the full row).
    #   * exp(s - x) overflows float32 whenever the cutoff sits below
    #     ~-88, so the tail ratio sum runs as a max-shifted logsumexp.
    lse_s = logsumexp(jnp.where(slot_valid, s_vals, -jnp.inf), axis=1)
    denom = jnp.logaddexp(log_ntl, lse_s)

    d = jnp.where(slot_valid, s_vals - tail_vals, -jnp.inf)
    dm = jnp.max(d, axis=1)
    dms = jnp.where(jnp.isfinite(dm), dm, 0.0)
    lse_d = dms + jnp.log(jnp.sum(jnp.exp(d - dms[:, None]), axis=1))
    numer = jnp.logaddexp(jnp.log(S - nf), lse_d)
    elpd_i = -C + numer - denom

    khat = jnp.where(n_tail <= 4, jnp.inf, k)
    return elpd_i, khat, degenerate


def _nontail_mass(x, xcutoff, m1=None):
    """log sum over {x <= xcutoff} of exp(x), max-shifted (full-row pass).

    ``m1``, the largest element of the masked set, can be supplied from the
    compact selection output (it is the ``(n_tail+1)``-th order statistic) to
    skip the full-row masked-max pass.
    """
    nontail_mask = x <= xcutoff[:, None]
    if m1 is None:
        m1 = jnp.max(jnp.where(nontail_mask, x, -jnp.inf), axis=1)
    m1s = jnp.where(jnp.isfinite(m1), m1, 0.0)
    return m1s + jnp.log(
        jnp.sum(jnp.where(nontail_mask, jnp.exp(x - m1s[:, None]), 0.0), axis=1)
    )


@partial(jax.jit, static_argnames=("tail_max",))
def loo_scores_psis(log_lik, tail_max: int):
    """(B, S) log-lik -> (elpd_i, pareto_k, lppd_i), reference-exact.

    Semantics match reference ``pyloo/psis.py:114-231`` driven through
    ``pyloo/loo.py:286-337``: strict-``>`` tie membership, float64-tiny
    cutoff floor, NaN poisoning of sigma <= 0 fits.
    """
    x_raw = -log_lik
    B, S = x_raw.shape
    dtype = x_raw.dtype
    M = tail_max
    cutoff_floor = jnp.asarray(_CUTOFF_FLOOR, dtype)

    # Selection stays in float64 (the f32-proxy ``topk_hybrid_f64`` adds a
    # gather and a certificate pass and is kept only as a library utility).
    # It runs on the UNSHIFTED rows (comparisons are shift-invariant) so the
    # (B, S) f64 subtraction never materializes: the max-shift is applied to
    # the compact (B, M+1) winners — per-element the identical ``x - C1``
    # operation, hence bit-identical values — and fuses into the single
    # non-tail logsumexp pass over the full row.  The row max is the top-1
    # winner, so no separate full-row max pass either.
    vals_raw = topk_vals_desc(x_raw, M + 1)
    C1 = vals_raw[:, 0]
    vals = vals_raw - C1[:, None]

    xcutoff = jnp.maximum(vals[:, M], cutoff_floor)
    # the largest non-tail element is the (n_tail+1)-th order statistic,
    # available from the compact winners — no full-row masked-max pass
    n_tail = jnp.sum((vals[:, :M] > xcutoff[:, None]).astype(jnp.int32), axis=1)
    m1 = jnp.take_along_axis(vals, n_tail[:, None], axis=1)[:, 0]
    # Full-row pass ONE: non-tail exp mass and the row minimum as sibling
    # reductions of a single read of the (B, S) block.  The minimum IS the
    # lppd's max-shift (max(log_lik) == -min(x) exactly — negation is
    # exact), so the logsumexp below needs no max pass of its own; the
    # three full-row passes of the naive form (masked mass, max, exp-sum)
    # become two.
    log_ntl = _nontail_mass(x_raw - C1[:, None], xcutoff, m1)
    row_min = jnp.min(x_raw, axis=1)
    # Full-row pass TWO: the lppd exp-sum under the precomputed shift.
    ll_max = jnp.where(jnp.isfinite(row_min), -row_min, 0.0)
    lppd_i = (
        jnp.log(jnp.sum(jnp.exp(log_lik - ll_max[:, None]), axis=1))
        + ll_max
        - jnp.log(jnp.asarray(S, dtype))
    )
    elpd_i, khat, _ = _psis_tail_scores(
        vals[:, :M], xcutoff, log_ntl, C1, S, exact=True, product=True
    )
    return elpd_i, khat, lppd_i


def _fast_prepass(log_lik, k: int):
    """Selection and full-row reductions of the float32 fast path.

    Returns ``(vals, C1, xcutoff, log_ntl, lppd_i)``: the descending top-``k``
    of the max-shifted ``x = -log_lik - C1``, the row max ``C1`` of
    ``-log_lik``, the tail cutoff ``max(vals[:, k-1], log(float64 tiny))``,
    the non-tail mass ``log sum_{x <= xcutoff} exp(x)`` and the in-sample
    lppd, all ``(B,)`` except ``vals``.
    """
    x_raw = -log_lik
    S = x_raw.shape[1]
    C1 = jnp.max(x_raw, axis=1)
    x = x_raw - C1[:, None]
    vals = topk_vals_desc(x, k)  # descending (B, k), exact
    xcutoff = jnp.maximum(vals[:, k - 1], jnp.asarray(_CUTOFF_FLOOR, x.dtype))
    log_ntl = _nontail_mass(x, xcutoff)
    lppd_i = logsumexp(log_lik, axis=1, b_inv=S)
    return vals, C1, xcutoff, log_ntl, lppd_i


@partial(jax.jit, static_argnames=("tail_max",))
def loo_scores_psis_fast(log_lik, tail_max: int):
    """Scatter-free PSIS-LOO scores over compact top-k arrays (fast path).

    Returns ``(elpd_i, pareto_k, lppd_i, degenerate)``, all ``(B,)``;
    ``degenerate`` flags rows whose float32 GPD fit produced sigma <= 0 and
    therefore kept their UNSMOOTHED tail (the reference — and the exact
    float64 path — would NaN-poison those rows instead; the flag lets
    callers surface the divergence).

    Tail selection is the exact segmented ``approx_max_k`` cascade
    (:func:`~pyloo_tpu.ops.selection.topk_vals_desc`); intended for the
    float32 throughput path.
    """
    M = tail_max
    vals, C1, xcutoff, log_ntl, lppd_i = _fast_prepass(log_lik, M + 1)
    elpd_i, khat, degenerate = _psis_tail_scores(
        vals[:, :M], xcutoff, log_ntl, C1, log_lik.shape[1], exact=False,
        product=True,
    )
    return elpd_i, khat, lppd_i, degenerate


@jax.jit
def loo_scores_sis(log_lik):
    S = log_lik.shape[1]
    lw, ess = sislw_batch(-log_lik)
    elpd_i = logsumexp(lw + log_lik, axis=1)
    lppd_i = logsumexp(log_lik, axis=1, b_inv=S)
    return elpd_i, ess, lppd_i


@jax.jit
def loo_scores_tis(log_lik):
    S = log_lik.shape[1]
    lw, ess = tislw_batch(-log_lik)
    elpd_i = logsumexp(lw + log_lik, axis=1)
    lppd_i = logsumexp(log_lik, axis=1, b_inv=S)
    return elpd_i, ess, lppd_i


@jax.jit
def mixture_scores(log_lik):
    """Mix-IS-LOO elpd per observation (Silva & Zanella 2022, App. A.2).

    Reference ``pyloo/loo.py:252-284``: with per-observation mixture constant
    c_i = logsumexp_s(-ll_is), elpd_i = logsumexp_i(-c_i) -
    logsumexp_s(-ll_is - c_i).
    """
    S = log_lik.shape[1]
    c = logsumexp(-log_lik, axis=1)  # per observation, (B,)
    log_norm = logsumexp(-c, axis=0)  # global over observations
    log_obs = logsumexp(-log_lik - c[:, None], axis=1)
    elpd_i = log_norm - log_obs
    lppd_i = logsumexp(log_lik, axis=1, b_inv=S)
    return elpd_i, lppd_i


@jax.jit
def waic_scores(log_lik):
    """(B, S) log-lik -> (lppd_i, p_waic_i) for WAIC (reference waic.py:137-146).

    The reference takes the population variance over draws (xarray ``var``
    default ddof=0).
    """
    S = log_lik.shape[1]
    lppd_i = logsumexp(log_lik, axis=1, b_inv=S)
    p_waic_i = jnp.var(log_lik, axis=1, ddof=0)
    return lppd_i, p_waic_i
