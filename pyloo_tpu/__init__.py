"""pyloo_tpu: accelerator-native PSIS-LOO cross-validation (JAX/XLA).

A from-scratch rebuild of the capabilities of ``pyloo`` (the Python twin of R's
``loo`` package) designed for accelerators: every per-observation kernel is batched,
jit-compiled, and shardable over a device mesh; the reference's per-row Python
loops are replaced by single fused XLA programs.
"""

import logging

# float64 on device: the statistical kernels default to reference-parity
# precision (NumPy float64); the float32 fast path is opt-in through
# rcParams["device.precision"].
import jax as _jax

_jax.config.update("jax_enable_x64", True)

if not logging.root.handlers:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        force=True,
    )

from .base import ISMethod, compute_importance_weights
from . import compare as _compare_module
from .compare import loo_compare, loo_model_weights

# arviz-style callable: ``pl.compare({...})``.  Rather than shadowing the
# ``pyloo_tpu.compare`` submodule with the function (which would break
# ``import pyloo_tpu.compare as c`` and ``pyloo_tpu.compare.loo_compare``),
# the submodule is made callable: calling it forwards to ``loo_compare``,
# so both the az-style callable and the module path work.
import types as _types


class _CallableCompareModule(_types.ModuleType):
    """Module type for ``pyloo_tpu.compare`` that forwards calls to loo_compare."""

    def __call__(self, *args, **kwargs):
        return self.loo_compare(*args, **kwargs)


_compare_module.__class__ = _CallableCompareModule
compare = _compare_module
from .containers import DataArray, Dataset, InferenceData
from .data import load_example_data
from .e_loo import ExpectationResult, compute_pareto_k, e_loo, k_hat
from .elpd import ELPDData
from .loo import loo
from .loo_approximate_posterior import importance_resample, loo_approximate_posterior
from .diagnostics import (
    loo_pit,
    mcse_loo,
    relative_eff,
    pareto_k_ids,
    pareto_k_table,
    pareto_k_values,
    psis_ess_values,
)
from .generic_elpd import elpd
from .loo_group import loo_group
from .loo_lfo import loo_lfo
from .loo_i import loo_i
from .helpers import (
    ParameterConverter,
    ShiftAndCovResult,
    ShiftAndScaleResult,
    ShiftResult,
    UpdateQuantitiesResult,
    compute_updated_r_eff,
    extract_log_likelihood_for_observation,
    log_lik_i_upars,
    log_prob_upars,
)
from .loo_moment_match import loo_moment_match
from .split_moment_match import loo_moment_match_split
from .loo_kfold import (
    _kfold_split_grouped,
    _kfold_split_random,
    _kfold_split_stratified,
    loo_kfold,
)
from .reloo import reloo
from .models import ADVI, JAXModelWrapper, Laplace, Model, PyMCWrapper

# `PyMCWrapper` (reference pyloo/__init__.py:70) accepts BOTH a live
# ``pm.Model`` (compiled onto the device through PyTensor's JAX backend, see
# pyloo_tpu/models/pymc_adapter.py) and a native functional Model.
from .loo_nonfactor import loo_nonfactor
from .plots import (
    compare_plot,
    influence_plot,
    loo_difference_plot,
    loo_pit_plot,
    loo_plot,
    plot_compare,
    plot_khat,
    plot_influence,
    plot_loo,
    plot_loo_difference,
    plot_loo_pit,
)
from .loo_predictive_metric import MetricResult, loo_predictive_metric
from .loo_score import LooScoreResult, crps, loo_score, scrps
from .loo_subsample import loo_subsample, update_subsample
from .io import NpyLogLik, loo_from_file, waic_from_file
from .streaming import (
    clear_streaming_cache,
    e_loo_streaming,
    loo_approximate_posterior_streaming,
    loo_compare_streaming,
    loo_group_streaming,
    loo_predictive_metric_streaming,
    loo_score_streaming,
    loo_streaming,
    loo_subsample_streaming,
    waic_streaming,
)
from .psis import CompactWeights, psislw, psislw_compact
from .rcparams import rcParams
from .sis import sislw
from .tis import tislw
from .ingest import (
    convert_foreign,
    from_cmdstan,
    from_cmdstanpy,
    from_netcdf,
    from_numpyro,
    save_netcdf,
)
from .utils import from_dict, get_log_likelihood, to_inference_data
from .warmup import warmup
from .warmup import _apply_compilation_cache as _pyloo_apply_compilation_cache

# Persistent XLA compilation cache (rcParams["device.compilation_cache"]):
# configured at import — JAX reads the setting lazily at first compile, so
# this costs nothing and never initializes a backend.
_pyloo_apply_compilation_cache()
from .waic import waic

__version__ = "0.5.0"

__all__ = [
    "ISMethod",
    "compute_importance_weights",
    "DataArray",
    "Dataset",
    "InferenceData",
    "ELPDData",
    "loo",
    "loo_compare",
    "compare",
    "plot_khat",
    "loo_model_weights",
    "clear_streaming_cache",
    "e_loo_streaming",
    "NpyLogLik",
    "loo_from_file",
    "waic_from_file",
    "loo_streaming",
    "loo_subsample",
    "loo_subsample_streaming",
    "waic_streaming",
    "loo_predictive_metric_streaming",
    "loo_group_streaming",
    "loo_score_streaming",
    "loo_compare_streaming",
    "loo_approximate_posterior_streaming",
    "update_subsample",
    "elpd",
    "loo_group",
    "loo_lfo",
    "loo_pit",
    "mcse_loo",
    "pareto_k_ids",
    "pareto_k_table",
    "pareto_k_values",
    "psis_ess_values",
    "relative_eff",
    "loo_i",
    "loo_kfold",
    "_kfold_split_random",
    "_kfold_split_stratified",
    "_kfold_split_grouped",
    "reloo",
    "JAXModelWrapper",
    "PyMCWrapper",
    "Model",
    "Laplace",
    "ADVI",
    "loo_moment_match",
    "loo_moment_match_split",
    "ParameterConverter",
    "ShiftAndCovResult",
    "ShiftAndScaleResult",
    "ShiftResult",
    "UpdateQuantitiesResult",
    "log_lik_i_upars",
    "log_prob_upars",
    "compute_updated_r_eff",
    "extract_log_likelihood_for_observation",
    "loo_nonfactor",
    "loo_plot",
    "influence_plot",
    "loo_difference_plot",
    "plot_loo",
    "plot_compare",
    "compare_plot",
    "plot_influence",
    "plot_loo_difference",
    "plot_loo_pit",
    "loo_pit_plot",
    "loo_predictive_metric",
    "MetricResult",
    "loo_score",
    "crps",
    "scrps",
    "LooScoreResult",
    "loo_approximate_posterior",
    "importance_resample",
    "waic",
    "e_loo",
    "ExpectationResult",
    "compute_pareto_k",
    "k_hat",
    "psislw",
    "psislw_compact",
    "CompactWeights",
    "sislw",
    "tislw",
    "rcParams",
    "convert_foreign",
    "from_dict",
    "from_cmdstan",
    "from_cmdstanpy",
    "from_netcdf",
    "from_numpyro",
    "save_netcdf",
    "get_log_likelihood",
    "to_inference_data",
    "warmup",
    "load_example_data",
]
