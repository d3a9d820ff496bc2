"""Benchmark: non-factorized MVN/MVT conditional LOO at scale.

Per-draw work is one N x N Cholesky + triangular solve against I (O(N^3)),
batched over a draw chunk on device; S=1000 draws are streamed in chunks
sized to HBM (a (chunk, N, N) f64 covariance stack plus its factor and
L^-1).  The reference loops draws in Python and additionally pays an
O(N * N^2) per-observation deletion loop for Student-t
(loo_nonfactor.py:519-557).

Run on a GPU:  python scripts/bench_nonfactor.py
"""

import json
import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from pyloo_tpu.ops.nonfactor import mvn_conditional_loglik, mvt_conditional_loglik

S_TOTAL = 120


def bench_case(N, chunk, model, seed=0, near_singular=False, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(N, N)) / np.sqrt(N)
    base = jnp.asarray(A @ A.T + np.eye(N), dtype)
    y = jnp.asarray(
        rng.multivariate_normal(np.zeros(N), np.asarray(base)), dtype
    )
    mu = jnp.asarray(rng.normal(0, 0.05, size=(chunk, N)), dtype)
    jitter = jnp.asarray(np.abs(rng.normal(0, 0.01, size=(chunk,))), dtype)

    if model == "mvn":
        def chunk_fn(salt):
            covs = base[None] + (jitter + salt)[:, None, None] * jnp.eye(
                N, dtype=dtype
            )
            ll = mvn_conditional_loglik(y, mu, cov=covs)
            return jnp.sum(jnp.where(jnp.isfinite(ll), ll, 0.0))
    else:
        df = jnp.asarray(rng.uniform(3, 10, size=(chunk,)), dtype)

        def chunk_fn(salt):
            covs = base[None] + (jitter + salt)[:, None, None] * jnp.eye(
                N, dtype=dtype
            )
            ll = mvt_conditional_loglik(y, mu, df, cov=covs)
            return jnp.sum(jnp.where(jnp.isfinite(ll), ll, 0.0))

    fn = jax.jit(chunk_fn)
    _ = float(fn(jnp.zeros((), dtype)))  # compile + warm
    n_chunks = S_TOTAL // chunk
    t0 = time.perf_counter()
    acc = jnp.zeros((), dtype)
    for i in range(n_chunks):
        acc = acc + fn(jnp.asarray(i * 1e-9, dtype))
    _ = float(acc)
    wall = time.perf_counter() - t0
    return {
        "N": N,
        "S": S_TOTAL,
        "chunk": chunk,
        "model": model,
        "dtype": str(jnp.dtype(dtype)),
        "near_singular": near_singular,
        "wall_s": round(wall, 2),
        "draws_per_sec": round(S_TOTAL / wall, 1),
    }


def main():
    print(f"device={jax.devices()[0]}", flush=True)
    rows = []
    # N ladder: the blocked batched factorization emits a module that
    # grows with N (f64 N=3000 -> ~72 MB)
    for N, chunk, dtype in (
        (2000, 8, jnp.float64),
        (2000, 40, jnp.float32),
        (3000, 24, jnp.float32),
    ):
        for model in ("mvn", "student_t"):
            r = bench_case(N, chunk, model, dtype=dtype)
            print(json.dumps(r), flush=True)
            rows.append(r)
    print(json.dumps({"metric": "nonfactor_bench", "rows": rows}))


if __name__ == "__main__":
    main()
