"""Split moment matching: half-forward / half-inverse transformed draws.

Capability-equivalent to reference ``pyloo/split_moment_match.py:22-263``:
the first S/2 draws get the accumulated affine transform, the last S/2 its
inverse; the proposal becomes the deterministic two-component mixture; both
the LOO and the full-posterior weights are re-smoothed.

The transform algebra and the mixture denominator are the jitted device ops
:func:`pyloo_tpu.ops.moment_match.split_transform_halves` and
:func:`pyloo_tpu.ops.moment_match.split_mixture_log_weights` — one code path
shared with the batched device moment-match program.  Only the model
callbacks (log_prob / log_lik) and the tiny P x P inverse/determinant stay
host-side.
"""

from __future__ import annotations

from typing import Callable, Literal

import jax.numpy as jnp
import numpy as np

from .base import ISMethod, compute_importance_weights
from .helpers import (
    _initialize_array,
    compute_updated_r_eff,
    extract_log_likelihood_for_observation,
    log_lik_i_upars,
    log_prob_upars,
)
from .models.wrapper import JAXModelWrapper
from .ops.moment_match import split_mixture_log_weights, split_transform_halves

__all__ = ["loo_moment_match_split"]


def _eval_halves(model, fwd, inv, i, log_prob_fn, log_lik_fn, kwargs):
    """Evaluate log p(draws) on both half-transformed matrices and the
    pointwise log-lik of observation ``i`` on the forward one, through
    whichever model interface is in play (wrapper or user callables)."""
    if isinstance(model, JAXModelWrapper):
        lp_fwd = log_prob_upars(model, fwd)
        lp_inv = log_prob_upars(model, inv)
        ll = log_lik_i_upars(model, fwd, pointwise=True)
        ll_i = extract_log_likelihood_for_observation(ll, i)
        return lp_fwd, lp_inv, ll_i
    if log_prob_fn is None or log_lik_fn is None:
        raise ValueError(
            "When not using JAXModelWrapper, you must provide the following"
            " functions: log_prob_upars_fn and log_lik_i_upars_fn"
        )
    lp_fwd = log_prob_fn(model, upars=fwd, **kwargs)
    lp_inv = log_prob_fn(model, upars=inv, **kwargs)
    ll_i = log_lik_fn(model, upars=fwd, i=i, **kwargs)
    if hasattr(ll_i, "flatten"):
        ll_i = ll_i.flatten()
    return lp_fwd, lp_inv, ll_i


def loo_moment_match_split(
    model,
    upars: np.ndarray,
    cov: bool,
    total_shift: np.ndarray,
    total_scaling: np.ndarray,
    total_mapping: np.ndarray,
    i: int,
    r_eff_i: float,
    log_prob_upars_fn: Callable | None = None,
    log_lik_i_upars_fn: Callable | None = None,
    method: Literal["psis", "sis", "tis"] | ISMethod = "psis",
    verbose: bool = False,
    **kwargs,
):
    """Split-transform importance weights for observation ``i``.

    Returns a dict with ``lwi`` / ``lwfi`` / ``log_liki`` / ``r_eff_i``.
    """
    upars = np.asarray(upars)
    S, dim = upars.shape
    S_half = S // 2

    total_shift = _initialize_array(total_shift, np.zeros, dim)
    total_scaling = _initialize_array(total_scaling, np.ones, dim)
    total_mapping = _initialize_array(total_mapping, np.eye, dim)

    # the device program needs the inverse map; P x P is host-trivial
    mapping_inv = np.linalg.inv(total_mapping) if cov else np.eye(dim)
    half_fwd, half_inv = split_transform_halves(
        jnp.asarray(upars, jnp.float64),
        jnp.asarray(total_shift, jnp.float64),
        jnp.asarray(total_scaling, jnp.float64),
        jnp.asarray(total_mapping, jnp.float64),
        jnp.asarray(mapping_inv, jnp.float64),
        use_cov=bool(cov),
    )
    upars_trans_half = np.asarray(half_fwd)
    upars_trans_half_inv = np.asarray(half_inv)

    log_prob_half_trans, log_prob_half_trans_inv, log_liki_half = _eval_halves(
        model,
        upars_trans_half,
        upars_trans_half_inv,
        i,
        log_prob_upars_fn,
        log_lik_i_upars_fn,
        kwargs,
    )
    log_liki_half = np.asarray(log_liki_half, dtype=np.float64)

    # inverse-map Jacobian: log|d inv / d u| = -sum log scaling - log|det M|
    log_jac = float(
        np.sum(np.log(total_scaling)) + np.log(np.abs(np.linalg.det(total_mapping)))
    )
    lwi_half = np.asarray(
        split_mixture_log_weights(
            jnp.asarray(log_liki_half, jnp.float64),
            jnp.asarray(log_prob_half_trans, jnp.float64),
            jnp.asarray(log_prob_half_trans_inv, jnp.float64) - log_jac,
        )
    )

    lwi_half, _ = compute_importance_weights(lwi_half, method=method, reff=r_eff_i)
    lwi_half = np.asarray(lwi_half)

    # full-posterior ("f") weights: add the log-lik back, guard non-finites
    lr = lwi_half + log_liki_half
    lr[np.isnan(lr) | (np.isinf(lr) & (lr > 0))] = -np.inf
    lwfi_half, _ = compute_importance_weights(lr, method=method, reff=r_eff_i)

    if isinstance(model, JAXModelWrapper):
        r_eff_i = compute_updated_r_eff(model, i, log_liki_half, S_half, r_eff_i)

    return {
        "lwi": lwi_half,
        "lwfi": np.asarray(lwfi_half),
        "log_liki": log_liki_half,
        "r_eff_i": r_eff_i,
    }
