"""No-U-Turn Sampler in JAX: iterative tree building, vmapped chains.

The reference relies on PyMC's NUTS through ``pm.sample`` (reference
``pyloo/wrapper/pymc/pymc.py:383-457``).  This is an accelerator-native
re-implementation of multinomial NUTS (Hoffman & Gelman 2014; multinomial
state sampling and generalized stopping per Betancourt 2017) built for
XLA's compilation model:

* the recursive tree of the textbook algorithm is replaced by an
  *iterative* doubling loop (cf. Phan, Pradhan & Jankowiak 2019): each
  doubling integrates ``2^depth`` leapfrog steps in a bounded
  ``fori_loop``;
* within-subtree U-turn checks use a checkpoint array indexed by subtree
  level: when leaf ``m`` satisfies ``m % 2^j == 0`` its state is written to
  slot ``j``, so at leaf ``n`` (with ``t`` trailing one-bits) slot ``j``
  holds exactly the left edge of the size-``2^j`` subtree ending at ``n``
  for every ``j <= t`` — the complete set of balanced-tree U-turn pairs;
* chains are a vmap batch; warmup adapts the step size by dual averaging
  on the per-trajectory mean Metropolis statistic (Stan's ``accept_stat``)
  and a diagonal mass matrix by Welford accumulation, exactly as in
  ``hmc.py``.

Divergences (energy error > 1000) and max-depth saturation are tracked and
returned as sampler statistics.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["sample_nuts"]

_DIVERGENCE = 1000.0


class _DAState(NamedTuple):
    log_eps: jnp.ndarray
    log_eps_avg: jnp.ndarray
    h_sum: jnp.ndarray
    mu: jnp.ndarray
    count: jnp.ndarray


def _count_trailing_ones(n, bits: int = 16):
    """Number of trailing 1-bits of int32 ``n`` (bounded unrolled loop).

    ``bits`` must be at least the position of the highest bit ``n`` can carry
    (the leapfrog counter is bounded by ``2^max_depth``, so callers pass
    ``max_depth``); inspecting too few bits would silently skip
    within-subtree U-turn checks for deep subtrees.
    """
    t = jnp.zeros((), jnp.int32)
    going = jnp.ones((), jnp.bool_)
    for j in range(bits):
        bit = jnp.bitwise_and(jnp.right_shift(n, j), 1) == 1
        going = going & bit
        t = t + jnp.where(going, 1, 0)
    return t


def _is_turning(inv_mass, q_minus, p_minus, q_plus, p_plus):
    dq = q_plus - q_minus
    return (jnp.dot(dq, inv_mass * p_minus) < 0.0) | (
        jnp.dot(dq, inv_mass * p_plus) < 0.0
    )


def _nuts_trajectory(
    potential_fn, grad_fn, q0, eps, inv_mass, key, max_depth: int
):
    """One NUTS draw from ``q0``.  Returns (q_new, accept_stat, depth,
    diverged)."""
    D = q0.shape[0]
    k_mom, k_tree = jax.random.split(key)
    p0 = jax.random.normal(k_mom, (D,)) / jnp.sqrt(inv_mass)
    h0 = potential_fn(q0) + 0.5 * jnp.sum(inv_mass * p0**2)

    def leapfrog(q, p, direction):
        e = direction * eps
        p = p - 0.5 * e * grad_fn(q)
        q = q + e * inv_mass * p
        p = p - 0.5 * e * grad_fn(q)
        return q, p

    # trajectory state
    # endpoints: (q-, p-, q+, p+); proposal + total log weight; flags
    state = dict(
        q_minus=q0, p_minus=p0, q_plus=q0, p_plus=p0,
        q_prop=q0, log_w=-h0,
        depth=jnp.zeros((), jnp.int32),
        turning=jnp.zeros((), jnp.bool_),
        diverged=jnp.zeros((), jnp.bool_),
        alpha_sum=jnp.zeros(()), n_alpha=jnp.zeros(()),
        key=k_tree,
    )

    def build_subtree(state, depth):
        """Integrate 2^depth leaves from the chosen endpoint; returns the
        subtree summary (its own endpoints handled in the caller frame)."""
        key, k_dir, k_inner = jax.random.split(state["key"], 3)
        direction = jnp.where(
            jax.random.uniform(k_dir) < 0.5, -1.0, 1.0
        ).astype(q0.dtype)
        q_edge = jnp.where(direction > 0, state["q_plus"], state["q_minus"])
        p_edge = jnp.where(direction > 0, state["p_plus"], state["p_minus"])

        n_leaves = jnp.left_shift(jnp.int32(1), depth)  # 2^depth

        ckpt_q = jnp.zeros((max_depth + 1, D), q0.dtype)
        ckpt_p = jnp.zeros((max_depth + 1, D), q0.dtype)

        sub0 = dict(
            q=q_edge, p=p_edge,
            q_first=q_edge, p_first=p_edge,
            q_prop=q_edge, log_w=-jnp.inf,
            turning=jnp.zeros((), jnp.bool_),
            diverged=jnp.zeros((), jnp.bool_),
            alpha_sum=jnp.zeros(()), n_alpha=jnp.zeros(()),
            ckpt_q=ckpt_q, ckpt_p=ckpt_p,
            key=k_inner,
        )

        def leaf_step(m, sub):
            stop = sub["turning"] | sub["diverged"]

            q, p = leapfrog(sub["q"], sub["p"], direction)
            h = potential_fn(q) + 0.5 * jnp.sum(inv_mass * p**2)
            h = jnp.where(jnp.isfinite(h), h, jnp.inf)
            diverged = (h - h0) > _DIVERGENCE
            log_w_leaf = -h

            # multinomial proposal update within the subtree
            key, k_acc = jax.random.split(sub["key"])
            log_w_new = jnp.logaddexp(sub["log_w"], log_w_leaf)
            p_take = jnp.exp(log_w_leaf - log_w_new)
            take = jax.random.uniform(k_acc) < p_take
            q_prop = jnp.where(take, q, sub["q_prop"])

            alpha = jnp.minimum(1.0, jnp.exp(jnp.minimum(h0 - h, 0.0)))

            # checkpoint slots: leaf m is the left edge of every subtree of
            # size 2^j with m % 2^j == 0
            ckpt_q, ckpt_p = sub["ckpt_q"], sub["ckpt_p"]
            write_all = jnp.arange(max_depth + 1)
            m_mod = jnp.bitwise_and(
                m, jnp.left_shift(jnp.int32(1), write_all) - 1
            )
            writable = m_mod == 0  # m % 2^j == 0 per slot j
            ckpt_q = jnp.where(writable[:, None], q[None, :], ckpt_q)
            ckpt_p = jnp.where(writable[:, None], p[None, :], ckpt_p)

            # U-turn checks for every balanced subtree ending at leaf m
            t_ones = _count_trailing_ones(m, max_depth)
            js = jnp.arange(1, max_depth + 1)
            active = js <= t_ones

            def check_one(j_active, cq, cp):
                return j_active & _is_turning(
                    inv_mass,
                    jnp.where(direction > 0, cq, q),
                    jnp.where(direction > 0, cp, p),
                    jnp.where(direction > 0, q, cq),
                    jnp.where(direction > 0, p, cp),
                )

            turns = jax.vmap(check_one)(
                active, ckpt_q[1:], ckpt_p[1:]
            )
            turning = jnp.any(turns)

            first = m == 0
            new = dict(
                q=q, p=p,
                q_first=jnp.where(first, q, sub["q_first"]),
                p_first=jnp.where(first, p, sub["p_first"]),
                q_prop=q_prop, log_w=log_w_new,
                turning=sub["turning"] | turning,
                diverged=sub["diverged"] | diverged,
                alpha_sum=sub["alpha_sum"] + alpha,
                n_alpha=sub["n_alpha"] + 1.0,
                ckpt_q=ckpt_q, ckpt_p=ckpt_p,
                key=key,
            )
            # freeze once stopped (remaining iterations are no-ops)
            return jax.tree.map(
                lambda n_, o: jnp.where(stop, o, n_), new, sub
            )

        sub = jax.lax.fori_loop(0, n_leaves, leaf_step, sub0)
        return sub, direction, key

    def doubling_cond(state):
        return (
            (state["depth"] < max_depth)
            & ~state["turning"]
            & ~state["diverged"]
        )

    def doubling_body(state):
        sub, direction, key = build_subtree(state, state["depth"])

        sub_ok = ~(sub["turning"] | sub["diverged"])

        # progressive multinomial merge of the subtree proposal
        key, k_acc = jax.random.split(key)
        log_w_total = jnp.logaddexp(state["log_w"], sub["log_w"])
        p_take = jnp.exp(sub["log_w"] - log_w_total)
        take = sub_ok & (jax.random.uniform(k_acc) < p_take)
        q_prop = jnp.where(take, sub["q_prop"], state["q_prop"])
        log_w = jnp.where(sub_ok, log_w_total, state["log_w"])

        # extend the trajectory endpoint in the chosen direction
        q_minus = jnp.where(
            (direction < 0) & sub_ok, sub["q"], state["q_minus"]
        )
        p_minus = jnp.where(
            (direction < 0) & sub_ok, sub["p"], state["p_minus"]
        )
        q_plus = jnp.where(
            (direction > 0) & sub_ok, sub["q"], state["q_plus"]
        )
        p_plus = jnp.where(
            (direction > 0) & sub_ok, sub["p"], state["p_plus"]
        )

        whole_turn = _is_turning(inv_mass, q_minus, p_minus, q_plus, p_plus)

        return dict(
            q_minus=q_minus, p_minus=p_minus,
            q_plus=q_plus, p_plus=p_plus,
            q_prop=q_prop, log_w=log_w,
            depth=state["depth"] + 1,
            turning=sub["turning"] | (sub_ok & whole_turn),
            diverged=state["diverged"] | sub["diverged"],
            alpha_sum=state["alpha_sum"] + sub["alpha_sum"],
            n_alpha=state["n_alpha"] + sub["n_alpha"],
            key=key,
        )

    out = jax.lax.while_loop(doubling_cond, doubling_body, state)
    accept_stat = out["alpha_sum"] / jnp.maximum(out["n_alpha"], 1.0)
    return out["q_prop"], accept_stat, out["depth"], out["diverged"]


@partial(
    jax.jit,
    static_argnames=("potential_fn", "num_warmup", "num_samples", "max_depth"),
)
def _run_chains(
    potential_fn,
    init_q,
    key,
    num_warmup: int,
    num_samples: int,
    max_depth: int,
    target_accept: float,
):
    C, D = init_q.shape
    grad_fn = jax.grad(potential_fn)
    total = num_warmup + num_samples
    adapt_end = num_warmup
    mm_lo, mm_hi = int(num_warmup * 0.25), int(num_warmup * 0.85)

    def one_chain(q0, chain_key):
        eps0 = jnp.asarray(0.1, dtype=q0.dtype)
        da0 = _DAState(
            log_eps=jnp.log(eps0),
            log_eps_avg=jnp.log(eps0),
            h_sum=jnp.asarray(0.0),
            mu=jnp.log(10.0 * eps0),
            count=jnp.asarray(0.0),
        )
        welford0 = (jnp.zeros(D), jnp.zeros(D), jnp.asarray(0.0))

        def step(carry, inputs):
            q, da, welford, inv_mass = carry
            t, step_key = inputs
            in_adapt = t < adapt_end
            eps = jnp.where(
                in_adapt, jnp.exp(da.log_eps), jnp.exp(da.log_eps_avg)
            )

            q, accept_stat, depth, diverged = _nuts_trajectory(
                potential_fn, grad_fn, q, eps, inv_mass, step_key, max_depth
            )

            gamma, t0, kappa = 0.05, 10.0, 0.75
            count = da.count + 1.0
            h_sum = da.h_sum + (target_accept - accept_stat)
            log_eps = da.mu - jnp.sqrt(count) / gamma * h_sum / (count + t0)
            w = count ** (-kappa)
            log_eps_avg = w * log_eps + (1.0 - w) * da.log_eps_avg
            da_new = _DAState(log_eps, log_eps_avg, h_sum, da.mu, count)
            da = jax.tree.map(
                lambda new, old: jnp.where(in_adapt, new, old), da_new, da
            )

            in_mm = (t >= mm_lo) & (t < mm_hi)
            mean, m2, n = welford
            n1 = n + 1.0
            delta = q - mean
            mean1 = mean + delta / n1
            m21 = m2 + delta * (q - mean1)
            welford = (
                jnp.where(in_mm, mean1, mean),
                jnp.where(in_mm, m21, m2),
                jnp.where(in_mm, n1, n),
            )
            mean_f, m2_f, n_f = welford
            var = m2_f / jnp.maximum(n_f - 1.0, 1.0)
            var = jnp.where(n_f > 2.0, var, jnp.ones(D))
            inv_mass = jnp.where(t == mm_hi, var, inv_mass)

            # adopting the mass matrix changes the optimal step size, so the
            # dual-averaging state restarts there (Stan's windowed scheme):
            # keep exploring from the current log_eps, drop the history
            restart = t == mm_hi
            da = _DAState(
                log_eps=da.log_eps,
                log_eps_avg=jnp.where(restart, da.log_eps, da.log_eps_avg),
                h_sum=jnp.where(restart, 0.0, da.h_sum),
                mu=jnp.where(restart, jnp.log(10.0) + da.log_eps, da.mu),
                count=jnp.where(restart, 0.0, da.count),
            )

            return (q, da, welford, inv_mass), (
                q, accept_stat, depth, diverged
            )

        keys = jax.random.split(chain_key, total)
        ts = jnp.arange(total)
        _, (qs, accs, depths, divs) = jax.lax.scan(
            step, (q0, da0, welford0, jnp.ones(D)), (ts, keys)
        )
        return (
            qs[num_warmup:],
            accs[num_warmup:],
            depths[num_warmup:],
            divs[num_warmup:],
        )

    chain_keys = jax.random.split(key, C)
    return jax.vmap(one_chain)(init_q, chain_keys)


def sample_nuts(
    logp_fn: Callable,
    init: np.ndarray,
    *,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_chains: int = 4,
    max_depth: int = 8,
    target_accept: float = 0.8,
    seed: int = 0,
    full_stats: bool = False,
):
    """Sample from ``exp(logp_fn(q))`` with multinomial NUTS.

    Parameters mirror :func:`pyloo_tpu.models.hmc.sample_hmc`; ``max_depth``
    bounds the trajectory at ``2^max_depth`` leapfrog steps.

    Returns ``(draws, accept_rate)`` — or, with ``full_stats=True``,
    ``(draws, accept_rate, stats)`` where ``stats`` carries per-draw
    ``accept_stat`` / ``tree_depth`` / ``diverging`` arrays (C, T).
    """
    if not 1 <= max_depth <= 30:
        raise ValueError(
            f"max_depth must be in [1, 30] (leaf counter is int32), got {max_depth}"
        )
    init = np.asarray(init, dtype=np.float64)
    key = jax.random.PRNGKey(seed)
    if init.ndim == 1:
        k_init, key = jax.random.split(key)
        jitter = jax.random.normal(k_init, (num_chains, init.size)) * 0.5
        init_q = jnp.asarray(init)[None, :] + jitter
    else:
        init_q = jnp.asarray(init)
        num_chains = init_q.shape[0]

    def potential(q):
        return -logp_fn(q)

    draws, accs, depths, divs = _run_chains(
        potential, init_q, key, num_warmup, num_samples, max_depth,
        target_accept,
    )
    accept = float(np.mean(np.asarray(accs)))
    if full_stats:
        stats = {
            "accept_stat": np.asarray(accs),
            "tree_depth": np.asarray(depths),
            "diverging": np.asarray(divs),
        }
        return np.asarray(draws), accept, stats
    return np.asarray(draws), accept
