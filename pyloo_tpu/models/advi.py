"""Automatic differentiation variational inference (mean-field / full-rank).

Capability-equivalent to the reference's ADVI support surface
(``pyloo/wrapper/pymc/utils.py:37-216``: approximation-parameter extraction,
``compute_log_p`` / ``compute_log_q`` / ``compute_log_weights``) — but
accelerator-native: the ELBO is maximized with optax Adam under the reparameterization
trick, fully jitted, with vmapped Monte-Carlo gradients.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..containers import DataArray, Dataset, InferenceData
from .wrapper import Model

__all__ = ["ADVI", "ADVIResult", "compute_log_weights"]


@dataclass
class ADVIResult:
    """Variational fit artifacts.

    ``mean`` and either ``log_sigma`` (mean-field) or ``L`` (full-rank
    Cholesky factor) parameterize the Gaussian q; ``elbo_trace`` records
    optimization progress.
    """

    method: str
    mean: np.ndarray
    log_sigma: np.ndarray | None
    L: np.ndarray | None
    elbo_trace: np.ndarray
    model: Model
    idata: InferenceData | None = None
    warnings: list = field(default_factory=list)


class ADVI:
    """Mean-field or full-rank Gaussian variational approximation."""

    def __init__(self, model: Model, method: Literal["meanfield", "fullrank"] = "meanfield"):
        if method not in ("meanfield", "fullrank"):
            raise ValueError("method must be 'meanfield' or 'fullrank'")
        self.model = model
        self.method = method
        self.result: ADVIResult | None = None

    def fit(
        self,
        n: int = 10_000,
        learning_rate: float = 1e-2,
        mc_samples: int = 8,
        seed: int = 0,
        draws: int = 1000,
        chains: int = 1,
        compute_log_likelihood: bool = True,
    ) -> ADVIResult:
        """Maximize the ELBO and sample the fitted q."""
        model = self.model
        D = model.flat_dim
        fullrank = self.method == "fullrank"

        def unpack(params):
            mean = params["mean"]
            if fullrank:
                tril = params["tril"]
                L = jnp.zeros((D, D)).at[jnp.tril_indices(D)].set(tril)
                # softplus-positive diagonal for identifiability
                diag = jax.nn.softplus(jnp.diag(L)) + 1e-8
                L = L.at[jnp.diag_indices(D)].set(diag)
                return mean, L
            return mean, jnp.exp(params["log_sigma"])

        def sample_q(params, eps):
            mean, scale = unpack(params)
            if fullrank:
                return mean + eps @ scale.T
            return mean + eps * scale

        def log_q(params, z):
            mean, scale = unpack(params)
            if fullrank:
                diff = z - mean
                sol = jax.scipy.linalg.solve_triangular(scale, diff.T, lower=True).T
                logdet = jnp.sum(jnp.log(jnp.diag(scale)))
                return (
                    -0.5 * jnp.sum(sol**2, axis=-1)
                    - logdet
                    - 0.5 * D * jnp.log(2 * jnp.pi)
                )
            return jnp.sum(
                -0.5 * ((z - mean) / scale) ** 2
                - jnp.log(scale)
                - 0.5 * jnp.log(2 * jnp.pi),
                axis=-1,
            )

        def neg_elbo(params, key):
            eps = jax.random.normal(key, (mc_samples, D))
            z = sample_q(params, eps)
            logp = jax.vmap(model.logp_flat)(z)
            return -(jnp.mean(logp) + _entropy(params))

        def _entropy(params):
            mean, scale = unpack(params)
            if fullrank:
                return jnp.sum(jnp.log(jnp.diag(scale))) + 0.5 * D * (
                    1 + jnp.log(2 * jnp.pi)
                )
            return jnp.sum(jnp.log(scale)) + 0.5 * D * (1 + jnp.log(2 * jnp.pi))

        if fullrank:
            tril0 = jnp.zeros(D * (D + 1) // 2)
            params = {"mean": jnp.zeros(D), "tril": tril0}
        else:
            params = {"mean": jnp.zeros(D), "log_sigma": jnp.full(D, -1.0)}

        optimizer = optax.adam(learning_rate)
        opt_state = optimizer.init(params)

        @jax.jit
        def step(params, opt_state, key):
            loss, grads = jax.value_and_grad(neg_elbo)(params, key)
            updates, opt_state = optimizer.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        key = jax.random.PRNGKey(seed)
        trace = np.empty(n)
        for it in range(n):
            key, sub = jax.random.split(key)
            params, opt_state, loss = step(params, opt_state, sub)
            trace[it] = float(loss)

        mean, scale = unpack(params)
        mean = np.asarray(mean)
        record: list = []
        if not np.all(np.isfinite(trace[-10:])):
            record.append("ELBO not finite at the end of optimization")

        # sample q
        key, sub = jax.random.split(key)
        total = draws * chains
        eps = jax.random.normal(sub, (total, D))
        flat = np.asarray(sample_q(params, eps)).reshape(chains, draws, D)

        idata = self._assemble_idata(flat, compute_log_likelihood)
        self.result = ADVIResult(
            method=self.method,
            mean=mean,
            log_sigma=None if fullrank else np.log(np.asarray(scale)),
            L=np.asarray(scale) if fullrank else None,
            elbo_trace=trace,
            model=self.model,
            idata=idata,
            warnings=record,
        )
        self._params = params
        self._log_q_fn = log_q
        return self.result

    def _assemble_idata(self, flat_draws, compute_log_likelihood):
        model = self.model
        unravel_v = jax.vmap(jax.vmap(model.unravel))
        upars = unravel_v(jnp.asarray(flat_draws))
        constrained = (
            jax.vmap(jax.vmap(model.constrain))(upars)
            if model.constrain is not None
            else upars
        )
        posterior = {
            name: DataArray(
                np.asarray(values),
                ("chain", "draw")
                + tuple(f"{name}_dim_{i}" for i in range(values.ndim - 2)),
                name=name,
            )
            for name, values in constrained.items()
        }
        groups = {
            "posterior": Dataset(posterior),
            "sample_stats": Dataset(
                {"_flat_draws": DataArray(flat_draws, ("chain", "draw", "flat_param"))}
            ),
        }
        if compute_log_likelihood:
            ll = jax.jit(jax.vmap(jax.vmap(lambda q: model.log_lik_flat(q))))(
                jnp.asarray(flat_draws)
            )
            groups["log_likelihood"] = Dataset(
                {"obs": DataArray(np.asarray(ll), ("chain", "draw", "obs_id"))}
            )
        return InferenceData(**groups)

    # -- densities for loo_approximate_posterior ----------------------------
    def compute_log_p(self) -> np.ndarray:
        """True log joint at the variational draws."""
        result = self._require_fit()
        flat = result.idata.sample_stats._flat_draws.values.reshape(
            -1, self.model.flat_dim
        )
        fn = jax.jit(jax.vmap(lambda q: self.model.logp_flat(q)))
        return np.asarray(fn(jnp.asarray(flat)))

    def compute_log_q(self) -> np.ndarray:
        """Variational log density at the variational draws."""
        result = self._require_fit()
        flat = result.idata.sample_stats._flat_draws.values.reshape(
            -1, self.model.flat_dim
        )
        return np.asarray(self._log_q_fn(self._params, jnp.asarray(flat)))

    def _require_fit(self) -> ADVIResult:
        if self.result is None:
            raise RuntimeError("Call fit() before computing densities")
        return self.result


def compute_log_weights(approx, scale: bool = False) -> np.ndarray:
    """log_p - log_q at the approximation's draws (optionally normalized).

    Mirrors reference ``wrapper/pymc/utils.py:175-216``.
    """
    log_p = approx.compute_log_p() if hasattr(approx, "compute_log_p") else approx.compute_logp()
    log_q = approx.compute_log_q() if hasattr(approx, "compute_log_q") else approx.compute_logq()
    lw = log_p - log_q
    if scale:
        m = lw.max()
        lw = lw - (m + np.log(np.sum(np.exp(lw - m))))
    return lw
