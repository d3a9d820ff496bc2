"""Device-resident batched moment matching for the wrapper path.

Device-batched realization of SURVEY §7 Phase 5 (reference greedy loop:
``pyloo/loo_moment_match.py:384-561``): instead of a host loop that pays a
device round-trip per transform per observation, ALL bad observations run
simultaneously as one jitted program — the affine transforms are
``(n_bad, S, P)`` batched linear algebra, the PSIS re-fit reuses the batched
kernel, and the greedy accept/continue control flow is a ``lax.while_loop``
vmapped over the bad-observation axis (lanes that finish early coast).

Semantics replicate the host loop (``pyloo_tpu.loo_moment_match``) exactly:

* one while-pass tries shift, then shift-and-scale, then (optionally)
  shift-and-cov, each computed from the CURRENT (possibly just-updated)
  draws; a transform is accepted iff it strictly lowers Pareto k;
* the loop leaves when a full pass accepts nothing, k falls to the
  threshold, or the accepted-transform count passes ``max_iters``;
* Cholesky failure inside the covariance transform degrades to the
  identity mapping (host: caught ``LinAlgError``; here: NaN detection);
* any numerical failure in a candidate simply loses the ``k_new < k``
  comparison (host: per-transform ``try/except`` skip).

Tail length must be shared by every lane of one program (it is a static
shape), so the caller groups bad observations by their integer
``tail_length(S, r_eff_i)`` and launches one program per group — in
practice one or two groups, since r_eff varies little within a posterior.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .psis import psislw_batch

# float32 products on the GPU run in TF32 unless asked otherwise; these are
# statistical quantities, so every product keeps full precision
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "batched_moment_match",
    "split_transform_halves",
    "split_mixture_log_weights",
]


@partial(jax.jit, static_argnames=("use_cov",))
def split_transform_halves(upars, shift, scaling, mapping, mapping_inv, *, use_cov):
    """Split-MM draw matrices: forward transform on the first S/2 draws,
    inverse transform on the last S/2 (capability of reference
    ``pyloo/split_moment_match.py:141-161``, realized as one fused device
    program instead of host NumPy copies).

    The accumulated affine map is ``u -> (u - m) * scaling @ mapping.T + m +
    shift`` with ``m`` the draw mean; its inverse uses ``mapping_inv``
    (computed host-side: a tiny P x P inverse).

    Returns ``(half_fwd, half_inv)``: each is ``upars`` with one half
    replaced by the transformed draws.
    """
    S = upars.shape[0]
    half = S // 2
    mean = jnp.mean(upars, axis=0)
    centered = upars - mean[None, :]
    fwd = centered * scaling[None, :]
    if use_cov:
        fwd = jnp.matmul(fwd, mapping.T, precision=_HIGHEST)
    fwd = fwd + (shift + mean)[None, :]
    inv = centered
    if use_cov:
        inv = jnp.matmul(inv, mapping_inv.T, precision=_HIGHEST)
    inv = inv / scaling[None, :] + (mean - shift)[None, :]
    row = jnp.arange(S)[:, None]
    half_fwd = jnp.where(row < half, fwd, upars)
    half_inv = jnp.where(row < half, upars, inv)
    return half_fwd, half_inv


@jax.jit
def split_mixture_log_weights(log_liki, log_prob_fwd, log_prob_inv_adj):
    """Deterministic two-component-mixture importance log-weights.

    The proposal is the 50/50 mixture of the forward- and inverse-
    transformed halves, so the unnormalized log-weight of draw s is
    ``-log p(y_i|s) + log p(s) - log(p_fwd(s) + p_inv(s))`` (the mixture 1/2
    cancels in PSIS normalization).  ``log_prob_inv_adj`` must already carry
    the inverse map's Jacobian correction.  ``jnp.logaddexp`` supplies the
    stable evaluation of the mixture denominator in every ordering
    (capability of reference ``pyloo/split_moment_match.py:220-242``).
    NaN / +inf weights collapse to -inf, matching the host fallbacks.
    """
    lwi = -log_liki + log_prob_fwd - jnp.logaddexp(log_prob_fwd, log_prob_inv_adj)
    bad = jnp.isnan(lwi) | (lwi == jnp.inf)
    return jnp.where(bad, -jnp.inf, lwi)


def _plain_cov(x):
    """np.cov(x, rowvar=False) with default ddof=1."""
    S = x.shape[0]
    xm = x - jnp.mean(x, axis=0)
    return jnp.matmul(xm.T, xm, precision=_HIGHEST) / (S - 1)


def _weighted_cov(x, w):
    """np.cov(x, rowvar=False, aweights=w) semantics (ddof=1 analogue)."""
    v1 = jnp.sum(w)
    v2 = jnp.sum(w * w)
    mu = jnp.sum(w[:, None] * x, axis=0) / v1
    xm = x - mu
    return jnp.matmul((w[:, None] * xm).T, xm, precision=_HIGHEST) / (
        v1 - v2 / v1
    )


def _transform(uparsi, lwi, kind: int):
    """One affine moment-matching transform of a single draw matrix.

    kind 0: weighted-mean shift; 1: + marginal-scale; 2: + covariance via
    the Cholesky map L_w L^-1 (reference ``loo_moment_match.py:814-914``,
    with the documented orientation fix — see the host implementations in
    :mod:`pyloo_tpu.loo_moment_match`, which this must mirror exactly).

    Returns (upars_new, shift, scaling, mapping).
    """
    S, P = uparsi.shape
    w = jnp.exp(lwi)
    mean_original = jnp.mean(uparsi, axis=0)
    mean_weighted = jnp.sum(w[:, None] * uparsi, axis=0)
    shift = mean_weighted - mean_original
    eye = jnp.eye(P, dtype=uparsi.dtype)
    ones = jnp.ones((P,), uparsi.dtype)

    if kind == 0:
        return uparsi + shift[None, :], shift, ones, eye

    if kind == 1:
        mii = jnp.sum(w[:, None] * uparsi**2, axis=0) - mean_weighted**2
        mii = mii * S / (S - 1)
        scaling = jnp.sqrt(mii / jnp.var(uparsi, axis=0))
        new = (uparsi - mean_original[None, :]) * scaling[None, :] + (
            mean_weighted[None, :]
        )
        return new, shift, scaling, eye

    covv = _plain_cov(uparsi)
    wcovv = _weighted_cov(uparsi, w)
    chol1 = jnp.linalg.cholesky(wcovv)
    chol2 = jnp.linalg.cholesky(covv)
    # chol1 @ chol2^{-1} via a triangular solve: no explicit inverse, the
    # numerically tighter form.
    mapping = jax.lax.linalg.triangular_solve(
        chol2, chol1, left_side=False, lower=True
    )
    # host parity: np.linalg.cholesky raises on non-PD -> identity mapping;
    # jnp returns NaNs instead, detected here
    ok = jnp.all(jnp.isfinite(mapping))
    mapping = jnp.where(ok, mapping, eye)
    new = (
        jnp.matmul(
            uparsi - mean_original[None, :], mapping.T, precision=_HIGHEST
        )
        + mean_weighted[None, :]
    )
    return new, shift, ones, mapping


@partial(
    jax.jit,
    static_argnames=(
        "log_prob_fn", "log_lik_col_fn", "tail_max", "max_iters", "use_cov",
    ),
)
def batched_moment_match(
    upars,
    obs_idx,
    orig_log_prob,
    log_liki0,
    lwi0,
    ki0,
    k_threshold,
    *,
    log_prob_fn,
    log_lik_col_fn,
    tail_max: int,
    max_iters: int,
    use_cov: bool,
):
    """Greedy moment matching for every bad observation, on device.

    Parameters
    ----------
    upars : (S, P) array
        Unconstrained posterior draws (shared starting point).
    obs_idx : (n_bad,) int32
        Observation indices with k above the threshold.
    orig_log_prob : (S,)
        Log joint density of the ORIGINAL draws.
    log_liki0 : (n_bad, S)
        Log likelihood of each bad observation at the original draws.
    lwi0 : (n_bad, S)
        Initial smoothed normalized log weights per bad observation.
    ki0 : (n_bad,)
        Initial Pareto k per bad observation.
    k_threshold : float
    log_prob_fn : callable (static)
        Traceable ``(S, P) -> (S,)`` log joint density.
    log_lik_col_fn : callable (static)
        Traceable ``((S, P), i) -> (S,)`` log likelihood of observation i.
    tail_max : int (static)
        Shared PSIS tail budget for this group (host groups by r_eff).

    Returns
    -------
    dict with per-observation finals: ``lwi``, ``ki``, ``kfi``,
    ``log_liki``, ``total_shift``, ``total_scaling``, ``total_mapping``,
    ``n_accepted`` (= iterind - 1), ``reached_max``.
    """
    S, P = upars.shape
    dtype = upars.dtype

    def psis_row(lr):
        lw, k = psislw_batch(lr[None, :], tail_max)
        return lw[0], k[0]

    kinds = (0, 1, 2) if use_cov else (0, 1)

    def one_obs(i_obs, log_liki, lwi, ki):
        st = dict(
            upars=upars,
            lwi=lwi,
            ki=ki,
            kfi=jnp.zeros((), dtype),
            log_liki=log_liki,
            total_shift=jnp.zeros((P,), dtype),
            total_scaling=jnp.ones((P,), dtype),
            total_mapping=jnp.eye(P, dtype=dtype),
            iterind=jnp.ones((), jnp.int32),
            progressing=jnp.ones((), bool),
        )

        def try_kind(st, kind):
            new_upars, shift, scaling, mapping = _transform(
                st["upars"], st["lwi"], kind
            )
            log_prob_new = log_prob_fn(new_upars)
            log_liki_new = log_lik_col_fn(new_upars, i_obs)
            lr = -log_liki_new + log_prob_new - orig_log_prob
            lr = jnp.where(jnp.isnan(lr), -jnp.inf, lr)
            lwi_new, ki_new = psis_row(lr)
            full_lr = log_prob_new - orig_log_prob
            full_lr = jnp.where(jnp.isnan(full_lr), -jnp.inf, full_lr)
            _, kfi_new = psis_row(full_lr)

            accept = ki_new < st["ki"]  # NaN candidates lose (host: skip)

            def upd(new, old):
                return jnp.where(accept, new, old)

            return dict(
                st,
                upars=upd(new_upars, st["upars"]),
                lwi=upd(lwi_new, st["lwi"]),
                ki=upd(ki_new, st["ki"]),
                kfi=upd(kfi_new, st["kfi"]),
                log_liki=upd(log_liki_new, st["log_liki"]),
                total_shift=upd(st["total_shift"] + shift, st["total_shift"]),
                total_scaling=upd(
                    st["total_scaling"] * scaling, st["total_scaling"]
                ),
                total_mapping=upd(
                    jnp.matmul(
                        mapping, st["total_mapping"], precision=_HIGHEST
                    ),
                    st["total_mapping"],
                ),
                iterind=st["iterind"] + accept.astype(jnp.int32),
                progressing=st["progressing"] | accept,
            )

        def cond(st):
            return (
                (st["iterind"] <= max_iters)
                & (st["ki"] > k_threshold)
                & st["progressing"]
            )

        def body(st):
            st = dict(st, progressing=jnp.zeros((), bool))
            for kind in kinds:
                st = try_kind(st, kind)
            return st

        st = jax.lax.while_loop(cond, body, st)
        return dict(
            lwi=st["lwi"],
            ki=st["ki"],
            kfi=st["kfi"],
            log_liki=st["log_liki"],
            total_shift=st["total_shift"],
            total_scaling=st["total_scaling"],
            total_mapping=st["total_mapping"],
            n_accepted=st["iterind"] - 1,
            reached_max=st["iterind"] > max_iters,
        )

    return jax.vmap(one_obs)(obs_idx, log_liki0, lwi0, ki0)
