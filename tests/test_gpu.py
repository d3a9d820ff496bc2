"""The PSIS kernels on the GPU against the NumPy oracle (marked ``gpu``).

They skip without a card; ``chip_smoke.py`` covers the same ground at full
size.  Run on a machine with a GPU::

    PYLOO_TESTS_ON_GPU=1 python -m pytest -m gpu tests/
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import logsumexp

from pyloo_tpu.ops import tail_length
from pyloo_tpu.ops.loo_kernels import loo_scores_psis, loo_scores_psis_fast

from .oracle import psis_row

pytestmark = pytest.mark.gpu


def _oracle(ll):
    out = [psis_row(-row) for row in ll]
    elpd = np.array([logsumexp(lw + row) for (lw, _), row in zip(out, ll)])
    return elpd, np.array([k for _, k in out])


@pytest.fixture(scope="module")
def ll():
    rng = np.random.default_rng(0)
    ll = rng.normal(-1.0, 0.8, size=(512, 4000))
    ll[7] = -np.abs(rng.standard_t(2, size=4000)) * 3  # heavy tail
    return ll


def test_exact_kernel_on_gpu(gpu, ll):
    e, k, _ = loo_scores_psis(jnp.asarray(ll), tail_length(4000, 1.0))
    e_ref, k_ref = _oracle(ll)
    np.testing.assert_allclose(np.asarray(e), e_ref, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(k), k_ref, atol=1e-6)


def test_fast_kernel_on_gpu(gpu, ll):
    ll32 = ll.astype(np.float32)
    e, k, _, _ = loo_scores_psis_fast(
        jnp.asarray(ll32), tail_length(4000, 1.0)
    )
    e_ref, k_ref = _oracle(ll32.astype(np.float64))
    np.testing.assert_allclose(np.asarray(e, np.float64), e_ref, rtol=2e-3)
    np.testing.assert_allclose(np.asarray(k, np.float64), k_ref, atol=1e-3)
