"""Sub-stage breakdown of the exact-path fit + smoothing (62.5k x 191).

Times, on the attached GPU, each piece of the linear-domain pipeline that
``_psis_tail_scores(exact=True, product=True)`` runs on the compact tail:

  * the exp that turns shifted tails into linear exceedances,
  * the Zhang-Stephens candidate scan (``_linear_b_post``: 43 candidates,
    renormalized-product profile likelihood),
  * one ``_log_prod_terms`` evaluation (a single candidate column),
  * the gpinv smoothing block (expm1 + closing log),
  * the closing elpd reductions (two masked logsumexps over the tail),
  * the full ``_psis_tail_scores`` for reference.

Run: python scripts/profile_fit_stages.py
"""

import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from jax import lax

from pyloo_tpu.ops import tail_length
from pyloo_tpu.ops.loo_kernels import _psis_tail_scores
from pyloo_tpu.ops.psis import (
    _candidate_grid_y,
    _linear_b_post,
    _log_prod_terms,
    _log1mexp,
)

B = 62_500
S = 4000
M = tail_length(S, 1.0)  # 190
N_ITERS = 4


def timeit(name, fn, *args):
    for _ in range(2):
        jax.block_until_ready(fn(*args, jnp.float64(0.0)))
    best = float("inf")
    for _rep in range(2):
        t0 = time.perf_counter()
        acc = None
        for i in range(N_ITERS):
            out = fn(*args, jnp.float64(i + 1) * 1e-9)
            leaf = jax.tree_util.tree_leaves(out)[0]
            acc = leaf if acc is None else acc + leaf
        jax.block_until_ready(acc)
        best = min(best, (time.perf_counter() - t0) / N_ITERS)
    print(f"{name:40s} {best*1e3:9.1f} ms   {B/best/1e3:9.1f}k rows/s",
          flush=True)
    return best


def salted(x, salt):
    return lax.dynamic_update_slice(x, x[:64] + salt, (0, 0))


def main():
    print(f"device={jax.devices()[0]}  tails={B}x{M}", flush=True)
    key = jax.random.PRNGKey(0)
    # descending shifted tail values in [-8, 0] (realistic PSIS tails),
    # plus a cutoff just below each row's smallest tail value
    u = jax.random.uniform(key, (B, M), dtype=jnp.float64, minval=-8.0, maxval=0.0)
    tail = jnp.sort(u, axis=1, descending=True)
    jax.block_until_ready(tail)
    xcut = tail[:, -1] - 0.05
    n_tail = jnp.full((B,), M, jnp.int32)
    nf = n_tail.astype(jnp.float64)
    log_ntl = jnp.full((B,), 3.0, jnp.float64)
    C = jnp.zeros((B,), jnp.float64)

    q_idx = jnp.clip((n_tail + 2) // 4 - 1, 0, M - 1)
    q_desc = jnp.clip(n_tail - 1 - q_idx, 0, M - 1)

    @jax.jit
    def to_linear(t, salt):
        ts = salted(t, salt)
        y = jnp.exp(ts) - jnp.exp(xcut)[:, None]
        return jnp.sum(y)

    @jax.jit
    def grid_scan(t, salt):
        ts = salted(t, salt)
        y = jnp.exp(ts) - jnp.exp(xcut)[:, None]
        y_quart = jnp.take_along_axis(y, q_desc[:, None], axis=1)[:, 0]
        b, valid = _candidate_grid_y(y, nf, y_quart, y[:, 0])
        b_post = _linear_b_post(y, nf, b, valid, product=True)
        return jnp.sum(b_post)

    @jax.jit
    def one_prod(t, salt):
        ts = salted(t, salt)
        y = jnp.exp(ts) - jnp.exp(xcut)[:, None]
        return jnp.sum(_log_prod_terms(y, -0.3 * jnp.ones((B,), jnp.float64)))

    @jax.jit
    def smooth_only(t, salt):
        ts = salted(t, salt)
        k = jnp.full((B,), 0.6, jnp.float64)
        sigma = jnp.full((B,), 0.8, jnp.float64)
        slot = jnp.arange(M, dtype=jnp.int32)
        log_slot = jnp.log(slot.astype(jnp.float64) + 0.5)
        log1m_p = log_slot[None, :] - jnp.log(nf)[:, None]
        expxcutoff = jnp.exp(xcut)
        sig_over_k = sigma / k
        q_lin = sig_over_k[:, None] * jnp.expm1(-k[:, None] * log1m_p)
        smoothed = jnp.minimum(jnp.log(q_lin + expxcutoff[:, None]), 0.0)
        return jnp.sum(smoothed) + jnp.sum(ts[:, :1])

    @jax.jit
    def closing_reductions(t, salt):
        ts = salted(t, salt)
        s_vals = ts * 0.99  # stand-in smoothed values
        lse_s = jnp.max(s_vals, axis=1) + jnp.log(
            jnp.sum(jnp.exp(s_vals - jnp.max(s_vals, axis=1)[:, None]), axis=1)
        )
        d = s_vals - ts
        dm = jnp.max(d, axis=1)
        lse_d = dm + jnp.log(jnp.sum(jnp.exp(d - dm[:, None]), axis=1))
        return jnp.sum(lse_s) + jnp.sum(lse_d)

    @jax.jit
    def full_tail_scores(t, salt):
        ts = salted(t, salt)
        e, k, d = _psis_tail_scores(
            ts, xcut, log_ntl, C, S, exact=True, product=True
        )
        return jnp.sum(e) + jnp.sum(k)

    timeit("exp to linear exceedances", to_linear, tail)
    timeit("candidate scan (_linear_b_post)", grid_scan, tail)
    timeit("single _log_prod_terms column", one_prod, tail)
    timeit("gpinv smoothing block", smooth_only, tail)
    timeit("closing elpd reductions", closing_reductions, tail)
    timeit("FULL _psis_tail_scores", full_tail_scores, tail)


if __name__ == "__main__":
    main()
