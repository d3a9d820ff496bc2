"""Model bridge: JAX-native samplers, wrappers, and example models.

The reference integrates with PyMC (reference ``pyloo/wrapper/pymc/``); this
package provides the capability-equivalent accelerator-native stack: pure-function
log-density models, an adaptive HMC sampler (vmapped chains, scan over
steps), variational fits (Laplace/ADVI), and a wrapper protocol powering
refit-based workflows (reloo, k-fold CV, moment matching).
"""

from .advi import ADVI, ADVIResult, compute_log_weights
from .hmc import sample_hmc
from .nuts import sample_nuts
from .laplace import Laplace, LaplaceVIResult
from .examples import (
    eight_schools_centered,
    eight_schools_noncentered,
    roaches_model,
    wells_model,
)
from .wrapper import JAXModelWrapper, Model
from .pymc_adapter import PyMCWrapper, PyTensorJaxBridge, from_pymc

__all__ = [
    "sample_hmc",
    "sample_nuts",
    "ADVI",
    "ADVIResult",
    "Laplace",
    "LaplaceVIResult",
    "compute_log_weights",
    "eight_schools_centered",
    "eight_schools_noncentered",
    "roaches_model",
    "wells_model",
    "JAXModelWrapper",
    "PyMCWrapper",
    "PyTensorJaxBridge",
    "from_pymc",
    "Model",
]
