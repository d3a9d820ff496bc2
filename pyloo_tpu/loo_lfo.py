"""Approximate leave-future-out cross-validation (LFO-CV) for time series.

A capability the reference does not ship (its scope ends at exchangeable
LOO; see ``/root/reference/pyloo/__init__.py``): M-step-ahead predictive
assessment for time-ordered observations, following Bürkner, Gabry &
Vehtari (2020), *Approximate leave-future-out cross-validation for Bayesian
time series models* — the PSIS-forward scheme of R's ``loo`` ecosystem.

For each target index ``i >= L`` the quantity estimated is

    elpd_i = log p(y_{i:i+M-1} | y_{0:i-1})

using importance weights on draws from the most recent (re)fit at history
``i*``: the log importance ratio for target ``i`` is the summed
log-likelihood of the observations ``i*..i-1`` that entered the data after
the fit.  Ratios are Pareto-smoothed; when the shape diagnostic exceeds
``k_threshold`` and a model ``wrapper`` is supplied, the model is refit on
``y_{0:i-1}`` and the sweep continues from there (the target at a refit
point uses the new draws directly — an *exact* predictive contribution).

accelerator-native structure: within one fit block, the ratio rows for every
remaining target come from one cumulative sum over the future
log-likelihood matrix (host-deterministic float64 — see
:func:`_block_scores`), and all their PSIS fits run as one batched device
kernel call (:func:`pyloo_tpu.psislw`) — the host only orchestrates refits.
"""

from __future__ import annotations

import warnings
from typing import Any

import jax.numpy as jnp
import numpy as np

from ._common import clean_log_likelihood, compute_reff, good_k_threshold, resolve_scale
from .containers import DataArray
from .elpd import ELPDData
from .ops.lse import logsumexp
from .psis import psislw
from .rcparams import rcParams
from .utils import get_log_likelihood, to_inference_data

__all__ = ["loo_lfo"]


def _block_scores(ll_f: np.ndarray, t_max: int, m: int, reff: float):
    """Batched 1-fit-block LFO scores.

    ``ll_f``: (n_future, S) log-likelihood of observations ``i*..N-1`` under
    the fit at history ``i*``.  Returns ``(elpd, ks)`` for targets
    ``t = 0..t_max-1`` (``t`` = offset from ``i*``).

    The ratio and joint-window sums are accumulated on the host in
    sequential float64 — PSIS tail membership uses strict value comparisons,
    so the accumulation order must be deterministic (a parallel-scan cumsum
    reorders roundoff and can flip tied tail members), and the M-step joint
    is built by direct row adds rather than a cumsum difference (which
    cancels catastrophically for long series).  All targets' PSIS fits then
    run as ONE batched device call.
    """
    ll64 = np.asarray(ll_f, dtype=np.float64)
    s = ll64.shape[1]
    cum = np.cumsum(ll64, axis=0)  # sequential: cum[j] = ((r0+r1)+...)+rj
    # joint log-lik of the M-step-ahead window starting at offset t
    joint = ll64[:t_max].copy()
    for j in range(1, m):
        joint += ll64[j : j + t_max]

    elpd = np.empty(t_max)
    ks = np.zeros(t_max)
    # t = 0: draws come from the exact conditioning set — uniform weights
    elpd[0] = float(logsumexp(jnp.asarray(joint[0]))) - np.log(s)
    if t_max > 1:
        ratios = cum[: t_max - 1]  # row t-1 = sum of rows 0..t-1 = ratio for t
        lw, k = psislw(ratios, reff=reff)
        elpd[1:] = np.asarray(
            logsumexp(jnp.asarray(lw) + jnp.asarray(joint[1:]), axis=1)
        )
        ks[1:] = np.asarray(k)
    return elpd, ks


def loo_lfo(
    data=None,
    L: int | None = None,
    *,
    M: int = 1,
    var_name: str | None = None,
    wrapper=None,
    k_threshold: float | None = None,
    scale: str | None = None,
    reff: float | None = None,
    pointwise: bool | None = None,
    sample_kwargs: dict | None = None,
) -> ELPDData:
    """Approximate leave-future-out cross-validation for time series.

    Parameters
    ----------
    data : InferenceData-convertible, optional
        Posterior **fit on the first L observations only**, carrying a
        log-likelihood group evaluated at **all** N time-ordered
        observations.  Ignored when ``wrapper`` is given (the wrapper is
        refit on the first ``L`` observations instead).
    L : int
        Minimum history length: the first predicted observation is index
        ``L`` (0-based), conditioned on observations ``0..L-1``.
    M : int, default 1
        Predict the joint density of the next ``M`` observations
        (M-step-ahead; ``M=1`` is standard 1-SAP).
    var_name : str, optional
        Log-likelihood variable when several are stored.
    wrapper : JAXModelWrapper, optional
        Enables exact refits whenever a target's Pareto k̂ exceeds
        ``k_threshold``; without it, high-k̂ targets keep their (possibly
        unreliable) PSIS value and a warning summarizes them.
    k_threshold : float, optional
        Refit / reliability threshold; defaults to
        ``min(1 - 1/log10(S), 0.7)``.
    scale : str, optional
        "log" (default), "negative_log", or "deviance".
    reff : float, optional
        Relative MCMC efficiency; computed from the posterior when absent.
    pointwise : bool, optional
        Include per-target ``lfo_i`` and diagnostics (defaults to
        ``rcParams["stats.ic_pointwise"]``).
    sample_kwargs : dict, optional
        Forwarded to ``wrapper.sample_posterior`` at every refit.

    Returns
    -------
    ELPDData
        Rows ``elpd_lfo``/``se``/``lfoic``/... plus per-target values and
        Pareto k̂ when ``pointwise``; ``n_refits``/``refit_indices`` record
        where exact refits happened.
    """
    if L is None:
        raise TypeError("loo_lfo requires the minimum history length L")
    if M < 1:
        raise ValueError(f"M must be >= 1, got {M}")
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise
    scale, scale_value = resolve_scale(scale)

    if wrapper is not None:
        return _lfo_wrapper(
            wrapper, L, M, k_threshold, scale, scale_value, pointwise,
            sample_kwargs or {}, reff,
        )
    if data is None:
        raise TypeError("loo_lfo requires `data` (or a model `wrapper`)")

    inference_data = to_inference_data(data)
    log_likelihood = get_log_likelihood(inference_data, var_name=var_name)
    log_likelihood = log_likelihood.stack(__sample__=("chain", "draw"))
    log_likelihood = clean_log_likelihood(log_likelihood, context="LFO")
    n_samples = log_likelihood.shape[-1]
    matrix = np.asarray(log_likelihood.values, dtype=np.float64).reshape(
        -1, n_samples
    )  # (N, S), obs axis in time order
    n_obs = matrix.shape[0]
    _validate_horizon(L, M, n_obs)
    reff = compute_reff(inference_data, reff, n_samples)
    k_threshold = good_k_threshold(n_samples) if k_threshold is None else k_threshold

    t_max = n_obs - M - L + 1
    elpd, ks = _block_scores(matrix[L:], t_max, M, reff)

    n_high = int(np.sum(ks > k_threshold))
    warn = n_high > 0
    if warn:
        warnings.warn(
            f"{n_high} of {t_max} LFO targets have Pareto k estimates above "
            f"{k_threshold:.2f}; their importance-sampling approximation may be "
            "unreliable. Pass a model `wrapper` to loo_lfo to refit at these "
            "points.",
            UserWarning,
            stacklevel=2,
        )
    return _lfo_result(
        elpd, ks, np.array([], dtype=int), n_samples, L, M, scale, scale_value,
        k_threshold, pointwise, warn,
    )


def _lfo_wrapper(
    wrapper, L, M, k_threshold, scale, scale_value, pointwise, sample_kwargs,
    reff=None,
):
    n_obs = wrapper.n_obs
    _validate_horizon(L, M, n_obs)
    n_targets = n_obs - M - L + 1
    elpd = np.empty(n_targets)
    ks = np.zeros(n_targets)
    refit_at: list[int] = []
    n_samples = None

    try:
        i_star = L
        while i_star <= n_obs - M:
            # (re)fit on observations 0..i_star-1 of the ORIGINAL data
            # (a prior refit left the wrapper holding a shorter history)
            wrapper.reset_data()
            selected, _ = wrapper.select_observations(np.arange(i_star))
            wrapper.set_data(selected)
            idata_fit = wrapper.sample_posterior(**sample_kwargs)
            ll_f = wrapper.log_likelihood_i(np.arange(i_star, n_obs), idata_fit)
            ll_f = np.asarray(ll_f, dtype=np.float64)
            s_fit = ll_f.shape[0] * ll_f.shape[1]
            n_samples = s_fit if n_samples is None else n_samples
            reff_fit = reff if reff is not None else compute_reff(
                idata_fit, None, s_fit
            )
            ll_f = ll_f.reshape(s_fit, -1).T  # (n_future, S)

            t_max = n_obs - M - i_star + 1
            e_blk, k_blk = _block_scores(ll_f, t_max, M, reff_fit)
            if k_threshold is None:
                k_threshold = good_k_threshold(s_fit)

            bad = np.nonzero(k_blk > k_threshold)[0]
            accept = int(bad[0]) if bad.size else t_max
            off = i_star - L
            elpd[off : off + accept] = e_blk[:accept]
            ks[off : off + accept] = k_blk[:accept]
            if accept == t_max:
                break
            refit_at.append(i_star + accept)  # next block starts here (t=0 exact)
            i_star += accept
    finally:
        wrapper.reset_data()

    return _lfo_result(
        elpd, ks, np.asarray(refit_at, dtype=int), n_samples, L, M, scale,
        scale_value, k_threshold, pointwise, warn=False,
    )


def _validate_horizon(L, M, n_obs):
    if not 1 <= L <= n_obs - M:
        raise ValueError(
            f"L must satisfy 1 <= L <= n_obs - M ({n_obs - M}), got L={L}"
        )


def _lfo_result(
    elpd, ks, refit_indices, n_samples, L, M, scale, scale_value, k_threshold,
    pointwise, warn,
):
    n_targets = elpd.shape[0]
    lfo_i = DataArray(
        scale_value * elpd,
        ("target",),
        {"target": np.arange(L, L + n_targets)},
        "lfo_i",
    )
    elpd_lfo = float(lfo_i.values.sum())
    se = float((n_targets * np.var(lfo_i.values)) ** 0.5)

    rows: list[tuple[str, Any]] = [
        ("elpd_lfo", elpd_lfo),
        ("se", se),
        ("n_samples", n_samples),
        ("n_data_points", n_targets),
        ("L", L),
        ("M", M),
        ("n_refits", len(refit_indices)),
        ("warning", warn),
    ]
    if pointwise:
        rows.append(("lfo_i", lfo_i))
        rows.append(("refit_indices", refit_indices))
    rows += [
        ("scale", scale),
        ("lfoic", -2 * elpd_lfo),
        ("lfoic_se", 2 * se),
    ]
    if pointwise:
        rows += [("pareto_k", ks), ("good_k", k_threshold)]
    return ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
