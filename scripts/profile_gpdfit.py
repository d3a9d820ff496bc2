"""Split profile of the exact PSIS kernel: selection vs GPD fit vs smoothing.

Run on a GPU:  python scripts/profile_gpdfit.py
"""

import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from pyloo_tpu.ops import tail_length
from pyloo_tpu.ops.loo_kernels import _psis_tail_scores
from pyloo_tpu.ops.psis import _gpdfit_batch, _gpdfit_batch_linear, _log1mexp
from pyloo_tpu.ops.selection import topk_vals_desc

CHUNK = 62_500
S = 4000
M = tail_length(S, 1.0)
N_ITERS = 4


def timeit(name, fn, *args):
    out = fn(*args, jnp.float64(0.0))
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    acc = None
    for i in range(N_ITERS):
        out = fn(*args, jnp.float64(i) * 1e-9)
        leaf = jax.tree_util.tree_leaves(out)[0]
        acc = leaf if acc is None else acc + leaf
    jax.block_until_ready(acc)
    dt = (time.perf_counter() - t0) / N_ITERS
    print(f"{name:38s} {dt*1e3:9.1f} ms/chunk", flush=True)
    return dt


def main():
    print(f"device={jax.devices()[0]}  chunk={CHUNK}x{S}  M={M}", flush=True)
    key = jax.random.PRNGKey(0)
    for attempt in range(6):
        try:
            base32 = 1.5 * jax.random.normal(key, (CHUNK, S), dtype=jnp.float32)
            _ = float(base32[0, 0])
            break
        except Exception as e:
            if "RESOURCE_EXHAUSTED" not in str(e) or attempt == 5:
                raise
            print("alloc retry", flush=True)
            time.sleep(30)

    # precompute the tail (descending, shifted) once, f64
    @jax.jit
    def make_tail(x32, salt):
        x = -(x32.astype(jnp.float64) + salt)
        C = jnp.max(x, axis=1)
        xs = x - C[:, None]
        vals = jax.lax.top_k(xs, M + 1)[0]
        xcut = jnp.maximum(vals[:, M], jnp.asarray(-744.44, jnp.float64))
        slot = jnp.arange(M, dtype=jnp.int32)
        tail_vals = vals[:, :M]
        n_tail = jnp.sum((tail_vals > xcut[:, None]).astype(jnp.int32), 1)
        slot_valid = slot[None, :] < n_tail[:, None]
        gap = jnp.minimum(xcut[:, None] - tail_vals, 0.0)
        log_exceed = jnp.where(
            slot_valid, tail_vals + _log1mexp(gap), -jnp.inf
        )
        return vals, xcut, log_exceed, n_tail, C

    vals, xcut, log_exceed, n_tail, C = jax.block_until_ready(
        make_tail(base32, jnp.float64(0.0))
    )

    @jax.jit
    def sel_only(x32, salt):
        x = -(x32.astype(jnp.float64) + salt)
        C = jnp.max(x, axis=1)
        vals = jax.lax.top_k(x - C[:, None], M + 1)[0]
        return jnp.sum(vals)

    @jax.jit
    def sel_cascade(x32, salt):
        x = -(x32.astype(jnp.float64) + salt)
        C = jnp.max(x, axis=1)
        vals = topk_vals_desc(x - C[:, None], M + 1)
        return jnp.sum(vals)

    @jax.jit
    def fit_only(le, nt, salt):
        k, ss, ls = _gpdfit_batch(le + salt, nt)
        return jnp.sum(k) + jnp.sum(ss) + jnp.sum(ls)

    @jax.jit
    def fit_linear(le, nt, salt):
        k, ss, ls = _gpdfit_batch_linear(le + salt, nt)
        return jnp.sum(k) + jnp.sum(ss) + jnp.sum(ls)

    @jax.jit
    def tail_scores(v, xc, ln, c, salt):
        e, k, d = _psis_tail_scores(
            v[:, :M] + salt, xc, ln, c, S, exact=True
        )
        return jnp.sum(e) + jnp.sum(k)

    timeit("selection f64 top_k (+max,shift)", sel_only, base32)
    timeit("selection f64 cascade (+max,shift)", sel_cascade, base32)
    timeit("gpdfit_batch signed-log (B, M)", fit_only, log_exceed, n_tail)
    timeit("gpdfit_batch LINEAR (B, M)", fit_linear, log_exceed, n_tail)
    log_ntl = jnp.zeros((CHUNK,), jnp.float64)
    timeit("_psis_tail_scores (fit+smooth+red)", tail_scores, vals, xcut,
           log_ntl, C)


if __name__ == "__main__":
    main()
