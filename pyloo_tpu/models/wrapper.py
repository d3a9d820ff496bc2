"""Functional model description and posterior fitting.

The accelerator-native counterpart of the reference's PyMC coupling: a model is a
pair of pure functions (unconstrained log joint, pointwise log likelihood)
over a flat parameter vector, plus metadata to name/reshape/constrain draws.
Everything downstream (HMC, Laplace, ADVI, refitting workflows) composes from
these functions with ``jax.grad``/``vmap``/``jit``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..containers import DataArray, Dataset, InferenceData
from .hmc import sample_hmc

__all__ = ["Model", "fit", "idata_from_flat_draws", "JAXModelWrapper"]


@dataclass(frozen=True)
class Model:
    """A Bayesian model as pure functions of a flat unconstrained vector.

    Attributes
    ----------
    name : str
    data : dict
        Arrays the likelihood depends on; the observation-indexed entries are
        listed in ``obs_keys`` so workflows (k-fold, reloo) can subset them.
    param_shapes : dict[str, tuple]
        Layout of the flat unconstrained vector, in insertion order.
    logp : callable ``(params_dict, data) -> scalar``
        Unnormalized log joint in unconstrained space (including Jacobian
        terms for any transformed parameter).
    log_lik : callable ``(params_dict, data) -> (n_obs,)``
        Pointwise log likelihood in unconstrained space.
    constrain : callable ``(params_dict) -> dict``, optional
        Maps unconstrained draws to named constrained posterior variables.
    obs_keys : tuple of str
        Keys of ``data`` indexed by observation (subsettable).
    """

    name: str
    data: dict
    param_shapes: dict
    logp: Callable
    log_lik: Callable
    constrain: Callable | None = None
    obs_keys: tuple = ()
    # rebuilds the model for new data — required when parameter shapes track
    # the number of observations (e.g. per-observation random effects)
    builder: Callable | None = None

    @property
    def flat_dim(self) -> int:
        return int(sum(np.prod(s, dtype=int) for s in self.param_shapes.values()))

    @property
    def n_obs(self) -> int:
        return int(np.asarray(self.data[self.obs_keys[0]]).shape[0])

    def unravel(self, q):
        """Flat vector -> dict of named unconstrained parameters."""
        out = {}
        i = 0
        for name, shape in self.param_shapes.items():
            size = int(np.prod(shape, dtype=int))
            out[name] = q[i : i + size].reshape(shape)
            i += size
        return out

    def ravel(self, params: dict):
        return jnp.concatenate(
            [jnp.ravel(jnp.asarray(params[name])) for name in self.param_shapes]
        )

    def logp_flat(self, q, data=None):
        return self.logp(self.unravel(q), self.data if data is None else data)

    def log_lik_flat(self, q, data=None):
        return self.log_lik(self.unravel(q), self.data if data is None else data)

    def with_data(self, **updates) -> "Model":
        new_data = dict(self.data)
        new_data.update(updates)
        if self.builder is not None:
            return self.builder(new_data)
        return replace(self, data=new_data)

    def subset_observations(self, keep_idx) -> "Model":
        """Model restricted to the observations in ``keep_idx``."""
        keep_idx = np.asarray(keep_idx)
        updates = {k: np.asarray(self.data[k])[keep_idx] for k in self.obs_keys}
        return self.with_data(**updates)


def fit(
    model: Model,
    *,
    draws: int = 1000,
    tune: int = 1000,
    chains: int | None = None,
    seed: int = 0,
    compute_log_likelihood: bool = True,
    init: np.ndarray | None = None,
    algorithm: str = "hmc",
    **hmc_kwargs,
) -> InferenceData:
    """Sample the model's posterior and assemble results.

    ``algorithm="hmc"`` (default) uses static-trajectory adaptive HMC;
    ``algorithm="nuts"`` the iterative multinomial No-U-Turn sampler
    (:mod:`pyloo_tpu.models.nuts`);
    ``algorithm="chees"`` uses ChEES-adapted trajectory lengths
    (:mod:`pyloo_tpu.models.chees`) — the SIMD-friendly alternative to NUTS.

    ``chains`` defaults per algorithm: 4 for HMC/NUTS, 16 for ChEES — the
    ChEES trajectory-length gradient is a cross-chain expectation and is
    noisy at few chains (the paper runs up to 128; chains are a batch
    dimension on the device, so more cost little).  Pass ``chains=`` explicitly to
    override.

    Returns an :class:`InferenceData` with ``posterior`` (constrained,
    named), ``log_likelihood`` and ``observed_data`` groups — the same shape
    contract as the reference's ``pm.sample(idata_kwargs={"log_likelihood":
    True})`` output.
    """
    data = model.data

    def logp_q(q):
        return model.logp(model.unravel(q), data)

    q0 = np.zeros(model.flat_dim) if init is None else init
    if chains is None:
        chains = 16 if algorithm == "chees" else 4
    if algorithm == "chees":
        from .chees import sample_chees

        draws_flat, accept = sample_chees(
            logp_q,
            q0,
            num_warmup=tune,
            num_samples=draws,
            num_chains=chains,
            seed=seed,
            **hmc_kwargs,
        )
    elif algorithm == "hmc":
        draws_flat, accept = sample_hmc(
            logp_q,
            q0,
            num_warmup=tune,
            num_samples=draws,
            num_chains=chains,
            seed=seed,
            **hmc_kwargs,
        )
    elif algorithm == "nuts":
        from .nuts import sample_nuts

        draws_flat, accept = sample_nuts(
            logp_q,
            q0,
            num_warmup=tune,
            num_samples=draws,
            num_chains=chains,
            seed=seed,
            **hmc_kwargs,
        )
    else:
        raise ValueError(
            f"Unknown algorithm {algorithm!r}; use 'hmc', 'nuts' or 'chees'"
        )  # (C, T, D)
    return idata_from_flat_draws(
        model,
        draws_flat,
        accept=accept,
        compute_log_likelihood=compute_log_likelihood,
    )


def idata_from_flat_draws(
    model: Model,
    draws_flat,
    *,
    accept: float = 1.0,
    compute_log_likelihood: bool = True,
) -> InferenceData:
    """Assemble an :class:`InferenceData` from flat unconstrained draws.

    ``draws_flat`` is ``(chains, draws, flat_dim)`` in the model's flat
    parameter order.  Shared by :func:`fit` and by exact samplers (e.g. the
    grid-exact eight-schools generator in ``scripts/make_example_data.py``)
    so every posterior source produces the same group contract.
    """
    draws_flat = np.asarray(draws_flat)
    C, T, D = draws_flat.shape

    unravel_v = jax.vmap(jax.vmap(model.unravel))
    upars = unravel_v(jnp.asarray(draws_flat))
    constrained = (
        jax.vmap(jax.vmap(lambda u: model.constrain(u)))(upars)
        if model.constrain is not None
        else upars
    )
    posterior = {
        name: DataArray(
            np.asarray(values),
            ("chain", "draw") + tuple(f"{name}_dim_{i}" for i in range(values.ndim - 2)),
            name=name,
        )
        for name, values in constrained.items()
    }

    groups = {
        "posterior": Dataset(posterior),
        "sample_stats": Dataset(
            {
                "accept_rate": DataArray(
                    np.full((C, T), accept), ("chain", "draw")
                ),
                # raw flat unconstrained draws: powers refit workflows
                # (log_likelihood_i, moment matching) without inversion
                "_flat_draws": DataArray(
                    draws_flat, ("chain", "draw", "flat_param")
                ),
            }
        ),
        "observed_data": Dataset(
            {
                k: DataArray(
                    np.asarray(v),
                    tuple(
                        f"{k}_dim_{i}" for i in range(np.asarray(v).ndim)
                    ),
                    name=k,
                )
                for k, v in model.data.items()
                if k in model.obs_keys
            }
        ),
    }

    if compute_log_likelihood:
        ll = jax.jit(
            jax.vmap(jax.vmap(lambda q: model.log_lik_flat(q)))
        )(jnp.asarray(draws_flat))
        groups["log_likelihood"] = Dataset(
            {
                "obs": DataArray(
                    np.asarray(ll), ("chain", "draw", "obs_id"), name="obs"
                )
            }
        )

    return InferenceData(**groups)


class JAXModelWrapper:
    """Standardized access to a fitted functional model.

    Capability-equivalent to the reference ``PyMCWrapper``
    (``pyloo/wrapper/pymc/pymc.py:32-807``): data selection/mutation,
    posterior refitting, per-observation log-likelihood on held-out data, and
    constrained<->unconstrained transforms — over :class:`Model`'s pure
    functions instead of a PyTensor graph.
    """

    def __init__(self, model: Model, idata: InferenceData | None = None, *,
                 sample_kwargs: dict | None = None):
        if not isinstance(model, Model):
            raise TypeError(
                "JAXModelWrapper requires a pyloo_tpu Model (pure jittable"
                " logp/log_lik functions), got"
                f" {type(model).__module__}.{type(model).__name__}. PyTensor"
                "/PyMC graphs cannot run on the device — port the model's logp to a"
                " jittable function (see pyloo_tpu.models.examples for"
                " templates)."
            )
        self.model = model
        self.idata = idata
        self.sample_kwargs = dict(sample_kwargs or {})
        self._original_data = {
            k: np.asarray(model.data[k]).copy() for k in model.data
        }
        for v in self._original_data.values():
            v.setflags(write=False)

    # -- introspection ------------------------------------------------------
    @property
    def observed_data(self):
        return {k: np.asarray(self.model.data[k]) for k in self.model.obs_keys}

    @property
    def n_obs(self):
        return self.model.n_obs

    def get_observed_name(self):
        return "y" if "y" in self.model.obs_keys else self.model.obs_keys[0]

    def get_variable_names(self):
        """Names of the model's (unconstrained) parameters."""
        return list(self.model.param_shapes)

    def get_shapes(self):
        """Unconstrained parameter shapes by name."""
        return dict(self.model.param_shapes)

    def get_observed_data(self):
        """The primary observed-response array (first obs key named 'y' if
        present, else the first obs key)."""
        key = self.get_observed_name()
        return np.asarray(self.model.data[key])

    # -- data mutation ------------------------------------------------------
    def select_observations(self, indices):
        """Split data into (selected, remaining) per-observation subsets."""
        n = self.n_obs
        idx = np.arange(n)[indices] if isinstance(indices, slice) else np.atleast_1d(
            np.asarray(indices)
        )
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"observation indices out of range [0, {n})")
        mask = np.zeros(n, dtype=bool)
        mask[idx] = True
        selected = {k: np.asarray(self.model.data[k])[mask] for k in self.model.obs_keys}
        remaining = {k: np.asarray(self.model.data[k])[~mask] for k in self.model.obs_keys}
        return selected, remaining

    def set_data(self, new_data: dict):
        self.model = self.model.with_data(**new_data)

    def reset_data(self):
        self.model = self.model.with_data(
            **{k: v.copy() for k, v in self._original_data.items()}
        )

    # -- refitting ----------------------------------------------------------
    def sample_posterior(self, **kwargs) -> InferenceData:
        """Refit the model's posterior on its current data.

        A ``sampler`` entry in ``sample_kwargs`` (or ``kwargs``) supplies a
        custom sample function ``sampler(model, **opts) -> InferenceData`` —
        e.g. an exact conjugate sampler or an external MCMC engine — and is
        inherited by refit workflows (k-fold folds, reloo) because they
        propagate ``sample_kwargs`` to the per-fold wrappers.
        """
        opts = dict(self.sample_kwargs)
        opts.update(kwargs)
        sampler = opts.pop("sampler", None)
        if sampler is not None:
            return sampler(self.model, **opts)
        return fit(self.model, **opts)

    def log_likelihood_i(self, holdout_data, idata: InferenceData):
        """Log-lik of held-out observation(s) under a refitted posterior.

        ``holdout_data`` maps obs_keys to the held-out slices; an integer /
        index array selects the corresponding rows of the wrapper's
        *original* data (the reference's ``log_likelihood_i(idx, idata)``
        calling convention, ``pyloo/wrapper/pymc/pymc.py:271-381``).
        Returns an array (chain, draw, n_holdout).
        """
        if not isinstance(holdout_data, dict):
            idx = np.atleast_1d(np.asarray(holdout_data))
            holdout_data = {
                k: self._original_data[k][idx] for k in self.model.obs_keys
            }
        model_i = self.model.with_data(**holdout_data)
        draws = self._flat_draws(idata)
        if model_i.flat_dim != draws.shape[-1]:
            raise ValueError(
                f"model for held-out data has {model_i.flat_dim} unconstrained"
                f" parameters but the posterior draws have {draws.shape[-1]};"
                " per-observation parameters cannot be scored on held-out"
                " observations — marginalize them in log_lik or use a"
                " fixed-dimension model"
            )
        ll = jax.jit(
            jax.vmap(jax.vmap(lambda q: model_i.log_lik_flat(q)))
        )(jnp.asarray(draws))
        return np.asarray(ll)

    @staticmethod
    def _flat_draws(idata):
        """(chain, draw, flat_dim) unconstrained draws stored by :func:`fit`."""
        ss = getattr(idata, "sample_stats", None)
        if ss is not None and "_flat_draws" in ss:
            return ss._flat_draws.values
        raise ValueError(
            "InferenceData does not carry flat unconstrained draws; produce "
            "it with pyloo_tpu.models.fit / JAXModelWrapper.sample_posterior"
        )

    # -- transforms ---------------------------------------------------------
    def get_unconstrained_parameters(self):
        """Posterior draws as a (chain*draw, flat_dim) unconstrained matrix."""
        v = self._flat_draws(self.idata)
        return v.reshape(-1, v.shape[-1])

    def get_constrained_parameters(self):
        """Posterior draws as named constrained arrays (chain, draw, ...)."""
        return {
            name: var.values
            for name, var in self.idata.posterior.data_vars.items()
        }
