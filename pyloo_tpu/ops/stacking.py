"""On-device stacking-weight solver.

Stacking weights (Yao, Vehtari, Simpson, Gelman 2018) maximize
``sum_n log(sum_k w_k exp(elpd_nk))`` over the simplex — exactly the MLE of
mixture proportions with fixed components, so the EM fixed point

    w_k <- mean_n( w_k p_nk / sum_j w_j p_nj )

is monotone, simplex-preserving, and jit-compiles to one matmul per
iteration.  This scales the solve to million-observation pointwise matrices
on device, where the reference's scipy SLSQP host loop
(``pyloo/compare.py:477-536``) would round-trip the data every iteration.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# float32 products on the GPU run in TF32 unless asked otherwise; these are
# statistical quantities, so every product keeps full precision
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["stacking_weights_em"]


@partial(jax.jit, static_argnames=("max_iters",))
def _em_solve(exp_elpds, max_iters: int, tol: float):
    N, K = exp_elpds.shape

    def body(state):
        w, _, it = state
        denom = jnp.dot(exp_elpds, w, precision=_HIGHEST)  # (N,)
        resp = exp_elpds * (w[None, :] / denom[:, None])  # responsibilities
        w_new = jnp.mean(resp, axis=0)
        w_new = w_new / jnp.sum(w_new)
        delta = jnp.max(jnp.abs(w_new - w))
        return w_new, delta, it + 1

    def cond(state):
        _, delta, it = state
        return (delta > tol) & (it < max_iters)

    w0 = jnp.full((K,), 1.0 / K, dtype=exp_elpds.dtype)
    w, _, iters = jax.lax.while_loop(cond, body, (w0, jnp.inf, 0))
    return w, iters


def stacking_weights_em(pointwise_elpds, max_iters: int = 5000, tol: float = 1e-14):
    """Solve for stacking weights on device.

    Parameters
    ----------
    pointwise_elpds : (n_obs, n_models) array
        Pointwise elpd values on the log scale.

    Returns
    -------
    (n_models,) ndarray of simplex weights.
    """
    x = jnp.asarray(pointwise_elpds)
    x = x - jnp.max(x, axis=1, keepdims=True)
    w, _ = _em_solve(jnp.exp(x), max_iters, tol)
    return w
