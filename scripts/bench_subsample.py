"""Benchmark: loo_subsample on 1M synthetic observations (BASELINE config #4).

Scales the wells logistic-regression posterior to 1M observations: draws
posterior coefficient samples once, synthesizes 1M covariate rows, builds the
(1M, S) log-likelihood in chunks, and times the full loo_subsample workflow
(PLPD approximation over all N + exact PSIS on the subsample + difference /
Hansen-Hurwitz estimation).

Run:  python scripts/bench_subsample.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import pyloo_tpu as pl

N_OBS = 1_000_000
S = 1000  # 2 chains x 500 draws


def build_idata(seed=0):
    """Posterior for a 3-coefficient logistic model + synthetic 1M-obs log-lik."""
    rng = np.random.default_rng(seed)
    beta_true = np.array([0.34, -0.9, 0.46])  # ~ wells fit
    betas = beta_true[None, None, :] + rng.normal(0, 0.03, size=(2, 500, 3))

    X = np.column_stack(
        [
            np.ones(N_OBS, dtype=np.float32),
            rng.exponential(0.5, size=N_OBS).astype(np.float32),
            rng.gamma(2.0, 1.0, size=N_OBS).astype(np.float32),
        ]
    )
    p = 1 / (1 + np.exp(-(X @ beta_true)))
    y = (rng.uniform(size=N_OBS) < p).astype(np.float32)

    @jax.jit
    def ll_chunk(Xc, yc, B):
        eta = Xc @ B.T  # (chunk, S)
        return (yc[:, None] * eta - jnp.logaddexp(0.0, eta)).T  # (S, chunk)

    B = jnp.asarray(betas.reshape(-1, 3), dtype=jnp.float32)
    chunks = []
    step = 125_000
    for start in range(0, N_OBS, step):
        chunk = np.asarray(
            ll_chunk(
                jnp.asarray(X[start : start + step]),
                jnp.asarray(y[start : start + step]),
                B,
            )
        )
        chunks.append(chunk)
    ll = np.concatenate(chunks, axis=1).reshape(2, 500, N_OBS)
    return pl.from_dict(
        posterior={"beta": betas}, log_likelihood={"obs": ll}
    )


def main():
    """On-device methodology: the covariates (16 MB) live on device and the
    (1M, S) log-likelihood is a pure function evaluated chunk by chunk via
    ``loo_subsample_streaming`` — the recorded wall measures the LIBRARY
    (LPD sweep over all N + exact PSIS on the m-row subsample + estimator),
    not the transfer of a materialized 4 GB idata."""
    import warnings

    warnings.simplefilter("ignore")
    rng = np.random.default_rng(0)
    beta_true = np.array([0.34, -0.9, 0.46])
    betas = beta_true[None, None, :] + rng.normal(0, 0.03, size=(2, 500, 3))
    X = np.column_stack(
        [
            np.ones(N_OBS, dtype=np.float32),
            rng.exponential(0.5, size=N_OBS).astype(np.float32),
            rng.gamma(2.0, 1.0, size=N_OBS).astype(np.float32),
        ]
    )
    p = 1 / (1 + np.exp(-(X @ beta_true)))
    y = (rng.uniform(size=N_OBS) < p).astype(np.float32)

    t0 = time.perf_counter()
    X_dev = jnp.asarray(X)
    y_dev = jnp.asarray(y)
    B_dev = jnp.asarray(betas.reshape(-1, 3), dtype=jnp.float32)
    jax.block_until_ready((X_dev, y_dev, B_dev))
    ship_s = time.perf_counter() - t0

    def log_lik_fn(idx):
        eta = X_dev[idx] @ B_dev.T  # (chunk, S)
        return y_dev[idx][:, None] * eta - jnp.logaddexp(0.0, eta)

    results = {}
    for estimator in ("diff_srs", "hh_pps"):
        kw = dict(
            observations=1000, estimator=estimator, reff=1.0,
            dtype=jnp.float32, seed=0,
        )
        # warm (compiles), then timed
        sub = pl.loo_subsample_streaming(log_lik_fn, N_OBS, S, **kw)
        t0 = time.perf_counter()
        sub = pl.loo_subsample_streaming(
            log_lik_fn, N_OBS, S, **dict(kw, seed=1)
        )
        wall = time.perf_counter() - t0
        results[estimator] = {
            "wall_s": round(wall, 2),
            "elpd": round(float(sub["elpd_loo"]), 1),
            "subsampling_SE": round(float(sub["subsampling_SE"]), 2),
        }

    print(
        json.dumps(
            {
                "metric": "loo_subsample_1M_obs_wall_s",
                "value": results["diff_srs"]["wall_s"],
                "unit": "s",
                "detail": {
                    "n_obs": N_OBS,
                    "n_draws": S,
                    "covariate_ship_s": round(ship_s, 1),
                    **results,
                    "methodology": (
                        "log-likelihood generated on device"
                        " (loo_subsample_streaming)"
                    ),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
