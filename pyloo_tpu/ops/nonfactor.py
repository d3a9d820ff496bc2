"""Conditional log-likelihood kernels for non-factorized MVN / MVT models.

Batched replacement for the reference per-draw Python loop
(``pyloo/loo_nonfactor.py:466-557``): draws are a vmapped batch axis, and the
Student-t quadratic form uses the rank-1 identity

    beta_{-i} = (y-mu)^T P (y-mu) - g_i^2 / P_ii,   g = P (y-mu)

(from expanding Proposition 3 of Bürkner, Gabry, Vehtari 2021), turning the
reference's O(N * N^2) per-draw per-observation deletion loop into one
batched einsum.

Covariance inputs go through a batched Cholesky factorization (SURVEY §7
Phase 7) rather than ``inv``: with ``cov = L L^T`` and ``Linv = L^{-1}``,

    g      = Linv^T (Linv r)          (two triangular applications)
    P_ii   = sum_k Linv[k, i]^2       (squared column norms of Linv)
    r^T P r = || Linv r ||^2          (exactly nonnegative, unlike r^T g)

which is cheaper (one factorization + one triangular solve against I versus
an LU inverse), numerically stabler near singularity, and keeps the
reference's failure semantics for free — a non-PD draw yields NaN rows from
``cholesky``, detected and mapped to ``-inf`` exactly like the reference's
``LinAlgError`` branch (``loo_nonfactor.py:470-481``).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

# float32 products on the GPU run in TF32 unless asked otherwise; these are
# statistical quantities, so every product keeps full precision
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["mvn_conditional_loglik", "mvt_conditional_loglik"]


def _precision_terms(y, mu, cov=None, prec=None):
    """r, g = P r, diag(P), and r^T P r per draw; NaN marks singular draws."""
    r = y[None, :] - mu  # (S, N)
    if prec is not None:
        g = jnp.einsum("sij,sj->si", prec, r, precision=_HIGHEST)
        cbar = jnp.diagonal(prec, axis1=1, axis2=2)  # (S, N)
        quad = jnp.einsum("si,si->s", r, g, precision=_HIGHEST)
        return r, g, cbar, quad
    S, N = r.shape
    chol = jnp.linalg.cholesky(cov)  # (S, N, N); NaN rows when not PD
    eye = jnp.broadcast_to(jnp.eye(N, dtype=r.dtype), (S, N, N))
    linv = jax.lax.linalg.triangular_solve(
        chol, eye, left_side=True, lower=True
    )  # L^{-1}
    lr = jnp.einsum("sij,sj->si", linv, r, precision=_HIGHEST)  # L^{-1} r
    # L^{-T} L^{-1} r = P r
    g = jnp.einsum("ski,sk->si", linv, lr, precision=_HIGHEST)
    cbar = jnp.einsum(
        "ski,ski->si", linv, linv, precision=_HIGHEST
    )  # diag(P)
    # ||L^{-1} r||^2 = r^T P r
    quad = jnp.einsum("si,si->s", lr, lr, precision=_HIGHEST)
    return r, g, cbar, quad


@jax.jit
def mvn_conditional_loglik(y, mu, cov=None, prec=None):
    """(S, N) conditional leave-one-out log-densities for a joint MVN.

    log p(y_i | y_-i, theta_s) = -0.5 log 2pi + 0.5 log Pbar_ii
    - 0.5 g_i^2 / Pbar_ii.  Singular covariance draws give -inf rows
    (reference semantics, loo_nonfactor.py:470-481).
    """
    r, g, cbar, _ = _precision_terms(y, mu, cov, prec)
    eps = jnp.finfo(g.dtype).eps
    bad = ~(cbar > 0)  # catches NaN as well as non-positive diagonals
    cbar_safe = jnp.where(bad, eps, cbar)
    ll = (
        -0.5 * jnp.log(2 * jnp.pi)
        + 0.5 * jnp.log(cbar_safe)
        - 0.5 * g**2 / cbar_safe
    )
    ll = jnp.where(bad, -jnp.inf, ll)
    # singular factorization -> non-finite entries anywhere in the row
    row_ok = jnp.all(jnp.isfinite(g) | bad, axis=1, keepdims=True)
    return jnp.where(row_ok, ll, -jnp.inf)


@jax.jit
def mvt_conditional_loglik(y, mu, df, cov=None, prec=None):
    """(S, N) conditional LOO log-densities for a joint multivariate-t.

    Conditional is a Student-t with df+N-1 degrees of freedom, location
    y_i - g_i/Pbar_ii and scale^2 (df + beta_-i)/(df+N-1)/Pbar_ii.
    """
    N = y.shape[0]
    r, g, cbar, quad = _precision_terms(y, mu, cov, prec)
    eps = jnp.finfo(g.dtype).eps
    bad = ~(cbar > 0)
    cbar_safe = jnp.where(bad, eps, cbar)

    beta = quad[:, None] - g**2 / cbar_safe  # (S, N) rank-1 identity

    cond_df = df[:, None] + N - 1  # (S, 1)
    resid = g / cbar_safe  # y_i - cond_loc
    cond_scale = (df[:, None] + beta) / (df[:, None] + N - 1) / cbar_safe

    ll = (
        gammaln((cond_df + 1) / 2)
        - gammaln(cond_df / 2)
        - 0.5 * jnp.log(cond_df * jnp.pi * cond_scale)
        - ((cond_df + 1) / 2)
        * jnp.log1p(resid**2 / (cond_scale * cond_df))
    )
    invalid = (
        bad
        | ~jnp.isfinite(beta)
        | ~(cond_scale > 0)
        | (df[:, None] <= 0)
        | ~jnp.isfinite(g)
    )
    return jnp.where(invalid, -jnp.inf, ll)
