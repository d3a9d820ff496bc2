"""Stage breakdown of the exact float64 path.

Residents are pre-cast to f64 and salted via a 64-row dynamic_update_slice
so no cast/salt artifact lands in any timed stage.
Run on a GPU: python scripts/profile_exact.py
"""

import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from jax import lax

from pyloo_tpu.ops import tail_length
from pyloo_tpu.ops.loo_kernels import (
    _nontail_mass,
    _psis_tail_scores,
    loo_scores_psis,
)
from pyloo_tpu.ops.lse import logsumexp
from pyloo_tpu.ops.selection import topk_vals_desc

CHUNK = 62_500
S = 4000
M = tail_length(S, 1.0)
N_ITERS = 4


def timeit(name, fn, *args):
    # two warm-up calls: compile, then one steady-state call
    for _ in range(2):
        out = fn(*args, jnp.float64(0.0))
        jax.block_until_ready(out)
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
    dt = best
    print(f"{name:36s} {dt*1e3:9.1f} ms/chunk   {CHUNK/dt/1e3:9.1f}k obs/s",
          flush=True)
    return dt


def salted(x, salt):
    return lax.dynamic_update_slice(x, x[:64] + salt, (0, 0))


def main():
    print(f"device={jax.devices()[0]}  chunk={CHUNK}x{S}  M={M}", flush=True)
    key = jax.random.PRNGKey(0)
    for attempt in range(6):
        try:
            base32 = 1.5 * jax.random.normal(key, (CHUNK, S), dtype=jnp.float32)
            base = base32.astype(jnp.float64)
            del base32
            _ = float(base[0, 0])
            break
        except Exception as e:
            if "RESOURCE_EXHAUSTED" not in str(e) or attempt == 5:
                raise
            print(f"alloc retry {attempt + 1}: {str(e)[:80]}", flush=True)
            time.sleep(30)

    @jax.jit
    def full_exact(x, salt):
        e, k, l = loo_scores_psis(-salted(x, salt), M)
        return jnp.sum(e) + jnp.sum(k) + jnp.sum(l)

    @jax.jit
    def sel_only(x, salt):
        xr = salted(x, salt)
        C = jnp.max(xr, axis=1)
        vals = topk_vals_desc(xr, M + 1) - C[:, None]
        return jnp.sum(vals)

    @jax.jit
    def sel_plus_nontail(x, salt):
        xr = salted(x, salt)
        C = jnp.max(xr, axis=1)
        vals = topk_vals_desc(xr, M + 1) - C[:, None]
        xcutoff = jnp.maximum(vals[:, M], -700.0)
        n_tail = jnp.sum((vals[:, :M] > xcutoff[:, None]).astype(jnp.int32), 1)
        m1 = jnp.take_along_axis(vals, n_tail[:, None], axis=1)[:, 0]
        return jnp.sum(_nontail_mass(xr - C[:, None], xcutoff, m1))

    @jax.jit
    def sel_plus_fit(x, salt):
        xr = salted(x, salt)
        C = jnp.max(xr, axis=1)
        vals = topk_vals_desc(xr, M + 1) - C[:, None]
        xcutoff = jnp.maximum(vals[:, M], -700.0)
        e, k, d = _psis_tail_scores(
            vals[:, :M], xcutoff, jnp.zeros((CHUNK,), jnp.float64), C, S,
            exact=True, product=True,
        )
        return jnp.sum(e) + jnp.sum(k)

    @jax.jit
    def lppd(x, salt):
        return jnp.sum(logsumexp(-salted(x, salt), axis=1, b_inv=S))

    t_sel = timeit("selection (unshifted cascade)", sel_only, base)
    t_nt = timeit("selection + nontail pass", sel_plus_nontail, base)
    t_fit = timeit("selection + paired fit/smooth", sel_plus_fit, base)
    t_lppd = timeit("lppd f64 logsumexp pass", lppd, base)
    t_full = timeit("FULL exact loo_scores_psis", full_exact, base)
    print(f"  -> nontail alone ~{(t_nt - t_sel)*1e3:.0f} ms, "
          f"fit/smooth alone ~{(t_fit - t_sel)*1e3:.0f} ms, "
          f"lppd {t_lppd*1e3:.0f} ms, sel {t_sel*1e3:.0f} ms", flush=True)
    print(f"projected 1M-obs wall: {1e6 / CHUNK * t_full:.2f} s", flush=True)


if __name__ == "__main__":
    main()
