"""ChEES-HMC: adaptive trajectory lengths without NUTS's dynamic trees.

Implements Hoffman, Radul & Sountsov (2021), "An adaptive-MCMC scheme for
setting trajectory lengths in Hamiltonian Monte Carlo" (AISTATS): maximize
the Change in the Estimator of the Expected Square (ChEES) criterion

    ChEES = 1/4 E[ (||q' - E q'||^2 - ||q - E q||^2)^2 ]

by Adam on log trajectory time, with per-iteration halton-jittered lengths.
This is the accelerator-native answer to NUTS: every chain runs the *same* number of
leapfrog steps per iteration (SIMD lockstep, one jitted program), whereas
NUTS's per-chain dynamic tree building serializes on the slowest chain and
defeats batching.  Cross-chain expectations come free because chains are a
batch dimension.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["sample_chees"]


class _AdamState(NamedTuple):
    m: jnp.ndarray
    v: jnp.ndarray
    count: jnp.ndarray


def _halton(i, base=2):
    """Radical-inverse (van der Corput) sequence value for index i (traced)."""
    # 16 binary digits is plenty for jitter purposes
    result = jnp.zeros_like(i, dtype=jnp.float64)
    f = 0.5
    x = i
    for _ in range(16):
        result = result + f * (x % 2)
        x = x // 2
        f = f * 0.5
    return result


@partial(
    jax.jit,
    static_argnames=("potential_fn", "num_warmup", "num_samples", "max_leapfrog"),
)
def _run(
    potential_fn,
    init_q,
    key,
    num_warmup: int,
    num_samples: int,
    max_leapfrog: int,
    target_accept: float,
    step_size_jitter: float,
):
    C, D = init_q.shape
    grad_fn = jax.grad(potential_fn)
    total = num_warmup + num_samples
    mm_lo, mm_hi = int(num_warmup * 0.25), int(num_warmup * 0.85)

    def leapfrog_all(q, p, eps, inv_mass, n_steps):
        """n_steps of leapfrog for all chains in lockstep (while_loop).

        ``eps`` is per-chain (C,): every chain takes the SAME number of steps
        (SIMD lockstep preserved) with its own step size, so trajectory
        lengths decorrelate across chains without breaking batching.
        """

        def body(state):
            i, q, p = state
            g = jax.vmap(grad_fn)(q)
            p = p - 0.5 * eps[:, None] * g
            q = q + eps[:, None] * inv_mass[None, :] * p
            g = jax.vmap(grad_fn)(q)
            p = p - 0.5 * eps[:, None] * g
            return i + 1, q, p

        def cond(state):
            return state[0] < n_steps

        _, q, p = jax.lax.while_loop(cond, body, (jnp.asarray(0), q, p))
        return q, p

    def step(carry, inputs):
        (q, log_eps, log_eps_avg, h_sum, da_count, mu_da,
         log_T, adam, welford, inv_mass) = carry
        t, step_key = inputs
        k_mom, k_acc, k_eps = jax.random.split(step_key, 3)

        in_adapt = t < num_warmup
        eps = jnp.where(in_adapt, jnp.exp(log_eps), jnp.exp(log_eps_avg))

        # halton-jittered trajectory time; shared across chains (lockstep)
        h = _halton(t + 1)
        traj_time = h * jnp.exp(log_T)
        n_steps = jnp.clip(
            jnp.ceil(traj_time / eps).astype(jnp.int32), 1, max_leapfrog
        )
        # per-chain multiplicative step-size jitter (uniform in
        # [1-j, 1+j] around the adapted base): breaks the exact resonance a
        # single shared step size can hit on near-periodic orbits, and
        # decorrelates chains for the cross-chain ChEES expectation.  The
        # step COUNT stays shared, so chains remain one lockstep program.
        u = jax.random.uniform(k_eps, (C,))
        eps_c = eps * (1.0 + step_size_jitter * (2.0 * u - 1.0))

        p = jax.random.normal(k_mom, (C, D)) / jnp.sqrt(inv_mass)[None, :]
        pot0 = jax.vmap(potential_fn)(q)
        h0 = pot0 + 0.5 * jnp.sum(inv_mass[None, :] * p**2, axis=1)
        q_new, p_new = leapfrog_all(q, p, eps_c, inv_mass, n_steps)
        pot1 = jax.vmap(potential_fn)(q_new)
        h1 = pot1 + 0.5 * jnp.sum(inv_mass[None, :] * p_new**2, axis=1)
        log_accept = jnp.where(jnp.isfinite(h1), h0 - h1, -jnp.inf)
        accept_prob = jnp.minimum(1.0, jnp.exp(jnp.minimum(log_accept, 0.0)))
        accept = jax.random.uniform(k_acc, (C,)) < accept_prob
        q_next = jnp.where(accept[:, None], q_new, q)

        # --- ChEES gradient for log T (paper eq. 6, accept-prob weighted) ---
        q_bar = jnp.mean(q, axis=0)
        q_new_bar = jnp.mean(q_new, axis=0)
        dsq = (
            jnp.sum((q_new - q_new_bar[None, :]) ** 2, axis=1)
            - jnp.sum((q - q_bar[None, :]) ** 2, axis=1)
        )
        proj = jnp.sum((q_new - q_new_bar[None, :]) * p_new, axis=1)
        per_chain = dsq * proj * h  # d/d logT via the jitter factor
        w = accept_prob
        grad_chees = jnp.sum(w * per_chain) / jnp.maximum(jnp.sum(w), 1e-6)
        # ascend the criterion: Adam on log T with normalized gradient
        g = -grad_chees  # minimize negative
        b1, b2, lr = 0.9, 0.95, 0.025
        m = b1 * adam.m + (1 - b1) * g
        v = b2 * adam.v + (1 - b2) * g**2
        count = adam.count + 1.0
        m_hat = m / (1 - b1**count)
        v_hat = v / (1 - b2**count)
        log_T_new = log_T - lr * m_hat / (jnp.sqrt(v_hat) + 1e-8)
        # keep trajectories realizable
        log_T_new = jnp.clip(
            log_T_new,
            jnp.log(jnp.exp(log_eps)),
            jnp.log(max_leapfrog * jnp.exp(log_eps)),
        )
        log_T = jnp.where(in_adapt, log_T_new, log_T)
        adam = _AdamState(
            jnp.where(in_adapt, m, adam.m),
            jnp.where(in_adapt, v, adam.v),
            jnp.where(in_adapt, count, adam.count),
        )

        # --- dual averaging for eps (mean accept across chains) ---
        gamma, t0, kappa = 0.05, 10.0, 0.75
        da_count = da_count + 1.0
        h_sum = h_sum + (target_accept - jnp.mean(accept_prob))
        log_eps_prop = mu_da - jnp.sqrt(da_count) / gamma * h_sum / (da_count + t0)
        wda = da_count ** (-kappa)
        log_eps_avg_prop = wda * log_eps_prop + (1.0 - wda) * log_eps_avg
        log_eps = jnp.where(in_adapt, log_eps_prop, log_eps)
        log_eps_avg = jnp.where(in_adapt, log_eps_avg_prop, log_eps_avg)

        # --- pooled Welford for the diagonal mass matrix ---
        mean, m2, n = welford
        in_mm = (t >= mm_lo) & (t < mm_hi)
        flat = q_next  # (C, D); treat chains as extra samples
        n1 = n + C
        delta = flat - mean[None, :]
        mean1 = mean + jnp.sum(delta, axis=0) / n1
        m21 = m2 + jnp.sum(delta * (flat - mean1[None, :]), axis=0)
        welford = (
            jnp.where(in_mm, mean1, mean),
            jnp.where(in_mm, m21, m2),
            jnp.where(in_mm, n1, n),
        )
        mean_f, m2_f, n_f = welford
        var = m2_f / jnp.maximum(n_f - 1.0, 1.0)
        var = jnp.where(n_f > 2.0, var, jnp.ones(D))
        inv_mass = jnp.where(t == mm_hi, var, inv_mass)

        carry = (
            q_next, log_eps, log_eps_avg, h_sum, da_count, mu_da,
            log_T, adam, welford, inv_mass,
        )
        return carry, (q_next, accept_prob, n_steps)

    eps0 = 0.1
    carry0 = (
        init_q,
        jnp.log(eps0),
        jnp.log(eps0),
        jnp.asarray(0.0),
        jnp.asarray(0.0),
        jnp.log(10 * eps0),
        jnp.log(1.0),  # initial trajectory time 1.0
        _AdamState(jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(0.0)),
        (jnp.zeros(D), jnp.zeros(D), jnp.asarray(0.0)),
        jnp.ones(D),
    )
    keys = jax.random.split(key, total)
    ts = jnp.arange(total)
    _, (qs, accs, steps) = jax.lax.scan(step, carry0, (ts, keys))
    # (total, C, D) -> post-warmup (C, T, D)
    draws = jnp.swapaxes(qs[num_warmup:], 0, 1)
    return draws, accs[num_warmup:], steps[num_warmup:]


def sample_chees(
    logp_fn: Callable,
    init: np.ndarray,
    *,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_chains: int = 16,
    max_leapfrog: int = 512,
    target_accept: float = 0.75,
    step_size_jitter: float = 0.2,
    seed: int = 0,
):
    """Sample with ChEES-adapted HMC (shared adaptive trajectory length).

    Same contract as :func:`pyloo_tpu.models.hmc.sample_hmc`; returns
    ``(draws (C, T, D), mean_accept)``.

    The ChEES criterion is a cross-chain expectation, so its gradient is
    noisy at few chains — the default is 16 chains (the paper uses up to
    128; chains are a batch dimension on the device, so more chains cost little).
    ``step_size_jitter`` (fraction, default 0.2) draws each chain's step
    size uniformly in ``eps * [1-j, 1+j]`` per iteration while keeping the
    leapfrog step count shared across chains.
    """
    if not 0.0 <= step_size_jitter < 1.0:
        raise ValueError(
            f"step_size_jitter must be in [0, 1), got {step_size_jitter}"
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

    draws, accs, steps = _run(
        potential, init_q, key, num_warmup, num_samples, max_leapfrog,
        target_accept, step_size_jitter,
    )
    return np.asarray(draws), float(np.mean(np.asarray(accs)))
