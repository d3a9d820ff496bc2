"""All K fold refits as ONE vmapped device program (SURVEY §7 Phase 6).

The reference's K-fold loop refits serially: K full MCMC runs one after the
other, each a deepcopy of the wrapper plus a ``pm.sample`` call (reference
``pyloo/loo_kfold.py:607-672``).  On the device the K training sets are just one
more batch axis: equal-sized folds give identically-shaped training
subsets, so one jitted program runs warmup + sampling for all
``K x chains`` trajectories simultaneously and evaluates every fold's
held-out log-likelihood — the entire K-fold refit pipeline is a single
device dispatch instead of K sequential sampler invocations.

Eligibility is decided by the caller (:func:`pyloo_tpu.loo_kfold.loo_kfold`):
equal fold sizes, the default HMC algorithm, no custom sampler, no
per-observation parameter shapes (``model.builder is None``), and
``save_fits=False`` (per-fold InferenceData defeats the point of never
leaving the device).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .hmc import _run_chains

__all__ = ["kfold_refit_batched"]


def kfold_refit_batched(
    model,
    train_idx: np.ndarray,
    val_idx: np.ndarray,
    *,
    draws: int = 1000,
    tune: int = 1000,
    chains: int = 4,
    seed: int = 0,
    num_leapfrog: int = 32,
    target_accept: float = 0.8,
):
    """Refit all folds at once; return held-out elpd contributions.

    Parameters
    ----------
    model : Model
        The functional model (full data; per-fold subsets are gathered from
        ``model.obs_keys`` with the index matrices).
    train_idx : (K, n_train) int array
    val_idx : (K, n_val) int array

    Returns
    -------
    elpd : (K, n_val) ndarray
        ``log mean_s p(y_i | theta_s)`` over each fold's posterior draws.
    accept : (K,) ndarray
        Mean post-warmup acceptance per fold (sanity diagnostic).
    """
    K, _ = train_idx.shape
    static_data = {
        k: v for k, v in model.data.items() if k not in model.obs_keys
    }
    obs_train = {
        k: jnp.asarray(np.asarray(model.data[k])[train_idx])
        for k in model.obs_keys
    }
    obs_val = {
        k: jnp.asarray(np.asarray(model.data[k])[val_idx])
        for k in model.obs_keys
    }
    D = model.flat_dim
    S = chains * draws
    q0 = jnp.zeros((D,), jnp.float64)
    fold_keys = jax.random.split(jax.random.PRNGKey(seed), K)

    def one_fold(tr, va, key_k):
        k_init, k_run = jax.random.split(key_k)
        init_q = q0[None, :] + jax.random.normal(k_init, (chains, D)) * 0.5
        data_tr = {**static_data, **tr}

        def potential(q):
            return -model.logp(model.unravel(q), data_tr)

        dr, accs = _run_chains(
            potential, init_q, k_run, tune, draws, num_leapfrog,
            target_accept,
        )  # (C, T, D)
        flat = dr.reshape(S, D)
        data_va = {**static_data, **va}
        ll = jax.vmap(
            lambda q: model.log_lik(model.unravel(q), data_va)
        )(flat)  # (S, n_val)
        m = jnp.max(ll, axis=0)
        ms = jnp.where(jnp.isfinite(m), m, 0.0)
        elpd = (
            ms
            + jnp.log(jnp.sum(jnp.exp(ll - ms[None, :]), axis=0))
            - jnp.log(jnp.asarray(S, ll.dtype))
        )
        return elpd, jnp.mean(accs)

    run = jax.jit(lambda tr, va, ks: jax.vmap(one_fold)(tr, va, ks))
    elpd, acc = run(obs_train, obs_val, fold_keys)
    return np.asarray(elpd), np.asarray(acc)
