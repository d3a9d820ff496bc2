"""Streaming PSIS-LOO at 1e7 observations on one GPU.

The (n_obs, n_draws) log-likelihood would be 320 GB at float64 (160 GB f32)
— unmaterializable for the reference workflow. Here the model (a logistic
regression with 4000 posterior draws, 50 features) lives on device and
``loo_streaming`` evaluates + scores it chunk by chunk inside one jitted
fori_loop; peak memory is one 2 GB chunk. Nothing crosses to the host but
the final scalars.

Run: python scripts/bench_streaming.py [n_obs]
"""

import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

import pyloo_tpu as pl

N_OBS = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
N_DRAWS, N_FEAT = 4000, 50


def main():
    dev = jax.devices()[0]
    key = jax.random.PRNGKey(0)
    kb, kx = jax.random.split(key)

    def make_log_lik(beta):
        def log_lik_fn(idx):
            # covariates are generated on device per chunk (keyed by the
            # chunk's first index) — in production this is a gather from
            # resident data
            kc = jax.random.fold_in(kx, idx[0])
            X = jax.random.normal(kc, (idx.shape[0], N_FEAT), jnp.float32)
            y = (
                jax.random.uniform(
                    jax.random.fold_in(kc, 1), (idx.shape[0], 1)
                )
                < 0.5
            )
            logits = X @ beta.T  # (chunk, N_DRAWS) on the MXU
            return jnp.where(
                y, jax.nn.log_sigmoid(logits), jax.nn.log_sigmoid(-logits)
            )

        return log_lik_fn

    chunk = 131_072
    # three runs with distinct model parameters: the first pays the compile
    # (the score/accumulate program is cached at module level, so later
    # loo_streaming calls recompile only the cheap generator); the later
    # runs are warm, with inputs that differ.  Report the last (warm) run.
    walls = []
    for salt in (0, 1, 2):
        kb_s = jax.random.fold_in(kb, salt)
        beta = 0.05 * jax.random.normal(kb_s, (N_DRAWS, N_FEAT), jnp.float32)
        log_lik_fn = make_log_lik(beta)

        t0 = time.perf_counter()
        res = pl.loo_streaming(
            log_lik_fn, N_OBS, N_DRAWS, chunk_size=chunk, dtype=jnp.float32
        )
        elpd = float(res["elpd_loo"])  # host fetch = sync
        walls.append(time.perf_counter() - t0)
    wall = walls[-1]

    print(
        json.dumps(
            {
                "metric": "streaming_psis_obs_per_sec_4k_draws",
                "value": round(N_OBS / wall, 1),
                "unit": "obs/s",
                "vs_baseline": round(N_OBS / wall / 1e4, 2),
                "detail": {
                    "n_obs": N_OBS,
                    "n_draws": N_DRAWS,
                    "wall_s": round(wall, 3),
                    "cold_wall_s": round(walls[0], 3),
                    "elpd": elpd,
                    "se": float(res["se"]),
                    "p_loo": float(res["p_loo"]),
                    "device": str(dev),
                    "ll_bytes_equivalent": N_OBS * N_DRAWS * 4,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
