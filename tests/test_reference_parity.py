"""Parity against the ACTUAL reference kernels (not the oracle).

These tests import the reference's pure-NumPy numerics from
``/root/reference/pyloo`` (via ``tests/refloader.py``, which stubs the
missing xarray/arviz imports) and assert near-bitwise (<= 1e-12 relative)
agreement with this package's device kernels in float64 on CPU.

Covers: ``_psislw`` (smoothed log weights + khat), ``_gpdfit``, ``_gpinv``,
``_sislw``, ``_tislw`` (reference psis.py:114-231, sis.py:86-106,
tis.py:91-120), and the survey estimators (estimators/difference.py,
srs.py, hansen_hurwitz.py) — on random matrices spanning light and heavy
tails plus the bundled centered_eight dataset.
"""

import numpy as np
import pytest

import pyloo_tpu as pl
from pyloo_tpu.estimators import (
    DifferenceEstimator,
    HansenHurwitzEstimator,
    SimpleRandomSamplingEstimator,
)
from pyloo_tpu.ops.psis import gpdfit, gpinv

from .refloader import load_reference_module

ref_psis = load_reference_module("psis")
ref_sis = load_reference_module("sis")
ref_tis = load_reference_module("tis")
ref_diff = load_reference_module("estimators/difference")
ref_hh = load_reference_module("estimators/hansen_hurwitz")
ref_srs = load_reference_module("estimators/srs")

ATOL = 1e-12
RTOL = 1e-12


def _reference_psislw(log_weights, reff=1.0):
    """Row-wise reference PSIS exactly as reference psislw() drives _psislw
    (psis.py:78-92): same cutoff index and cutoff floor."""
    lw = np.asarray(log_weights, dtype=np.float64)
    S = lw.shape[-1]
    cutoff_ind = -int(np.ceil(min(S / 5.0, 3 * (S / reff) ** 0.5))) - 1
    cutoffmin = np.log(np.finfo(float).tiny)
    out_lw = np.empty_like(lw)
    out_k = np.empty(lw.shape[:-1])
    for i in range(lw.shape[0]):
        out_lw[i], out_k[i] = ref_psis._psislw(
            lw[i].copy(), cutoff_ind=cutoff_ind, cutoffmin=cutoffmin
        )
    return out_lw, out_k


def _weight_cases(rng):
    """Log-weight matrices spanning light, moderate, and heavy tails."""
    return {
        "normal": rng.normal(size=(40, 1000)),
        "scaled_normal": 2.5 * rng.normal(size=(40, 1000)) - 3.0,
        "student_t3": rng.standard_t(3, size=(32, 1200)),
        "cauchy_tail": rng.standard_cauchy(size=(24, 800)) * 0.5,
        "small_s": rng.normal(size=(16, 120)),
    }


class TestPsislwParity:
    @pytest.mark.parametrize(
        "case", ["normal", "scaled_normal", "student_t3", "cauchy_tail", "small_s"]
    )
    @pytest.mark.parametrize("reff", [1.0, 0.7, 2.0])
    def test_random_matrices(self, rng, case, reff):
        lw_in = _weight_cases(rng)[case]
        ref_lw, ref_k = _reference_psislw(lw_in, reff=reff)
        got_lw, got_k = pl.psislw(lw_in, reff=reff)
        got_lw, got_k = np.asarray(got_lw), np.asarray(got_k)
        np.testing.assert_allclose(got_k, ref_k, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_lw, ref_lw, rtol=RTOL, atol=ATOL)

    def test_centered_eight(self):
        # The bundled draws contain MCMC rejection duplicates (tied rows of the
        # log-likelihood).  The reference assigns plotting positions to tied
        # tail values in np.argsort's UNSTABLE quicksort order, which no rule
        # can replicate; tied elements are identical inputs, so any consistent
        # assignment is equivalent.  We use stable-ascending order and assert
        # the well-defined properties: khat parity, per-element parity on all
        # untied draws, and exact multiset parity of the smoothed weights.
        idata = pl.load_example_data("centered_eight")
        ll = idata.log_likelihood["obs"].stack(__sample__=("chain", "draw"))
        lw_in = -np.asarray(ll.values, dtype=np.float64)
        for reff in (1.0, 0.82):
            ref_lw, ref_k = _reference_psislw(lw_in, reff=reff)
            got_lw, got_k = pl.psislw(lw_in, reff=reff)
            got_lw = np.asarray(got_lw)
            np.testing.assert_allclose(np.asarray(got_k), ref_k, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(
                np.sort(got_lw, axis=1), np.sort(ref_lw, axis=1), rtol=RTOL, atol=1e-13
            )
            for i in range(lw_in.shape[0]):
                vals, counts = np.unique(lw_in[i], return_counts=True)
                untied = ~np.isin(lw_in[i], vals[counts > 1])
                assert untied.mean() > 0.5  # the comparison must have teeth
                np.testing.assert_allclose(
                    got_lw[i, untied], ref_lw[i, untied], rtol=RTOL, atol=1e-13
                )

    def test_tied_tail_values_stable_ascending(self, rng):
        # Codify our tie semantics: within a run of tied tail values the
        # element at the LOWER original index gets the LOWER plotting
        # position, exactly what the reference would produce with a stable
        # ascending sort.  Verify against the reference run with its unstable
        # argsort on an input where ties sit in sorted order already (then
        # quicksort's permutation is identity and the orders coincide).
        S = 400
        base = np.sort(rng.normal(size=S))  # ascending -> argsort is identity
        dup = base.copy()
        dup[-20:-10] = dup[-10]  # a tied run inside the tail, in order
        lw_in = dup[None, :]
        ref_lw, ref_k = _reference_psislw(lw_in)
        got_lw, got_k = pl.psislw(lw_in)
        np.testing.assert_allclose(np.asarray(got_k), ref_k, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(got_lw), ref_lw, rtol=RTOL, atol=1e-13)

    def test_short_tail_inf_k(self, rng):
        # S small enough that the tail has <= 4 members -> k = inf both sides
        lw_in = rng.normal(size=(6, 12))
        ref_lw, ref_k = _reference_psislw(lw_in)
        got_lw, got_k = pl.psislw(lw_in)
        assert np.all(np.isinf(ref_k)) and np.all(np.isinf(np.asarray(got_k)))
        np.testing.assert_allclose(np.asarray(got_lw), ref_lw, rtol=RTOL, atol=ATOL)


class TestGpdfitParity:
    @pytest.mark.parametrize("n", [5, 17, 50, 191, 500])
    @pytest.mark.parametrize("gen", ["exponential", "pareto", "lognormal"])
    def test_random_exceedances(self, rng, n, gen):
        z = {
            "exponential": rng.exponential(2.0, size=n),
            "pareto": rng.pareto(2.5, size=n) + 1e-3,
            "lognormal": rng.lognormal(0.0, 1.5, size=n),
        }[gen]
        z = np.sort(z)
        ref_k, ref_sigma = ref_psis._gpdfit(z)
        got_k, got_sigma = gpdfit(z)
        np.testing.assert_allclose(float(got_k), ref_k, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(got_sigma), ref_sigma, rtol=1e-10, atol=1e-12)


class TestGpinvParity:
    @pytest.mark.parametrize("kappa", [-0.7, -1e-20, 0.0, 1e-20, 0.3, 1.2])
    @pytest.mark.parametrize("sigma", [0.5, 2.0])
    def test_interior_and_edges(self, kappa, sigma):
        probs = np.array([0.0, 1e-8, 0.25, 0.5, 0.999, 1.0])
        ref = ref_psis._gpinv(probs.copy(), kappa, sigma)
        got = np.asarray(gpinv(probs, kappa, sigma))
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)

    def test_nonpositive_sigma_poisons(self):
        probs = np.array([0.1, 0.5, 0.9])
        ref = ref_psis._gpinv(probs.copy(), 0.3, -1.0)
        got = np.asarray(gpinv(probs, 0.3, -1.0))
        assert np.all(np.isnan(ref)) and np.all(np.isnan(got))


class TestSisTisParity:
    def test_sis(self, rng):
        lw_in = rng.standard_t(3, size=(30, 700))
        got_lw, got_ess = pl.sislw(lw_in)
        for i in range(lw_in.shape[0]):
            ref_lw, ref_ess = ref_sis._sislw(lw_in[i].copy())
            np.testing.assert_allclose(
                np.asarray(got_lw)[i], ref_lw, rtol=RTOL, atol=ATOL
            )
            np.testing.assert_allclose(
                float(np.asarray(got_ess)[i]), ref_ess, rtol=RTOL, atol=ATOL
            )

    def test_tis(self, rng):
        lw_in = rng.standard_t(3, size=(30, 700))
        got_lw, got_ess = pl.tislw(lw_in)
        for i in range(lw_in.shape[0]):
            ref_lw, ref_ess = ref_tis._tislw(lw_in[i].copy(), lw_in.shape[1])
            np.testing.assert_allclose(
                np.asarray(got_lw)[i], ref_lw, rtol=RTOL, atol=ATOL
            )
            np.testing.assert_allclose(
                float(np.asarray(got_ess)[i]), ref_ess, rtol=RTOL, atol=ATOL
            )


class TestEstimatorParity:
    def test_srs(self, rng):
        y = rng.normal(-3.0, 1.2, size=120)
        ref = ref_srs.srs_estimate(y=y, N=5000)
        got = SimpleRandomSamplingEstimator().estimate(y=y, N=5000)
        np.testing.assert_allclose(got.y_hat, ref.y_hat, rtol=RTOL)
        np.testing.assert_allclose(got.v_y_hat, ref.v_y_hat, rtol=RTOL)
        np.testing.assert_allclose(got.hat_v_y, ref.hat_v_y, rtol=RTOL)

    def test_diff_srs(self, rng):
        N, m = 800, 90
        y_approx = rng.normal(-2.0, 1.0, size=N)
        idx = rng.choice(N, size=m, replace=False)
        y = y_approx[idx] + rng.normal(0.0, 0.1, size=m)
        ref = ref_diff.diff_srs_estimate(
            elpd_loo_i=y, elpd_loo_approximation=y_approx, sample_indices=idx
        )
        got = DifferenceEstimator().estimate(y_approx=y_approx, y=y, y_idx=idx)
        np.testing.assert_allclose(got.y_hat, ref.y_hat, rtol=RTOL)
        np.testing.assert_allclose(got.v_y_hat, ref.v_y_hat, rtol=RTOL)
        np.testing.assert_allclose(got.hat_v_y, ref.hat_v_y, rtol=RTOL)

    def test_hansen_hurwitz_normalized_sample(self, rng):
        # Our HH estimator intentionally skips the reference's z-renormalization
        # over the sample (a documented reference bug for partial samples).
        # When z already sums to 1 over the sample the renormalization is a
        # no-op, so the two implementations must agree exactly there.
        m = 60
        z = rng.uniform(0.5, 2.0, size=m)
        z = z / z.sum()
        m_i = rng.integers(1, 4, size=m)
        y = rng.normal(-2.0, 1.0, size=m)
        ref = ref_hh.hansen_hurwitz_estimate(z=z, m_i=m_i, y=y, N=m)
        got = HansenHurwitzEstimator().estimate(z=z, m_i=m_i, y=y, N=m)
        np.testing.assert_allclose(got.y_hat, ref.y_hat, rtol=RTOL)
        np.testing.assert_allclose(got.v_y_hat, ref.v_y_hat, rtol=RTOL)
        np.testing.assert_allclose(got.hat_v_y, ref.hat_v_y, rtol=RTOL)

    def test_compute_sampling_probabilities(self, rng):
        elpd_approx = rng.normal(-4.0, 2.0, size=300)
        from pyloo_tpu.estimators import compute_sampling_probabilities

        ref = ref_hh.compute_sampling_probabilities(elpd_approx.copy())
        got = compute_sampling_probabilities(elpd_approx)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


class TestFusedLooScoresParity:
    """The fused exact LOO kernel (hybrid f32-proxy selection, scatter-free
    elpd identity) against the reference pipeline: elpd_i derived by driving
    reference ``_psislw`` per row and summing the smoothed weights exactly as
    reference ``loo()`` does (``pyloo/loo.py:286-324``)."""

    def _reference_scores(self, ll, reff=1.0):
        from scipy.special import logsumexp as sp_lse

        ref_lw, ref_k = _reference_psislw(-ll, reff=reff)
        elpd_i = sp_lse(ref_lw + ll, axis=1)
        lppd_i = sp_lse(ll, axis=1, b=np.full_like(ll, 1.0 / ll.shape[1]))
        return elpd_i, ref_k, lppd_i

    @pytest.mark.parametrize(
        "case,shape",
        [
            ("normal", (40, 1000)),
            ("student_t3", (24, 1500)),
            ("cauchy_tail", (16, 4000)),
            ("narrow", (12, 260)),  # below the hybrid width: plain top_k
        ],
    )
    def test_matches_reference(self, rng, case, shape):
        import jax.numpy as jnp

        from pyloo_tpu.ops import tail_length
        from pyloo_tpu.ops.loo_kernels import loo_scores_psis

        gens = {
            "normal": lambda: rng.normal(-1, 0.7, size=shape),
            "student_t3": lambda: -np.abs(rng.standard_t(3, size=shape)) - 0.5,
            "cauchy_tail": lambda: -np.abs(rng.standard_cauchy(size=shape)),
            "narrow": lambda: rng.normal(-2, 1.1, size=shape),
        }
        ll = np.asarray(gens[case](), dtype=np.float64)
        m = tail_length(shape[1], 1.0)
        e, k, lp = loo_scores_psis(jnp.asarray(ll), m)
        e_ref, k_ref, lp_ref = self._reference_scores(ll)
        np.testing.assert_allclose(np.asarray(k), k_ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(e), e_ref, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(np.asarray(lp), lp_ref, rtol=1e-12, atol=1e-12)

    def test_ties_and_duplicate_draws(self, rng):
        """MCMC rejection duplicates: heavy exact ties through the hybrid."""
        import jax.numpy as jnp

        from pyloo_tpu.ops import tail_length
        from pyloo_tpu.ops.loo_kernels import loo_scores_psis

        ll = rng.normal(-1, 0.8, size=(12, 1200))
        keep = rng.integers(0, 1200, size=1200)  # bootstrap-duplicate draws
        ll = np.asarray(ll[:, keep], dtype=np.float64)
        m = tail_length(1200, 1.0)
        e, k, lp = loo_scores_psis(jnp.asarray(ll), m)
        e_ref, k_ref, lp_ref = self._reference_scores(ll)
        np.testing.assert_allclose(np.asarray(k), k_ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(e), e_ref, rtol=1e-12, atol=1e-12)

    def test_short_tail_and_constant_rows(self, rng):
        import jax.numpy as jnp

        from pyloo_tpu.ops import tail_length
        from pyloo_tpu.ops.loo_kernels import loo_scores_psis

        ll = np.asarray(rng.normal(-1, 0.5, size=(4, 1000)))
        ll[0] = -2.0  # constant row: k = inf, elpd = lpd
        ll[1, :5] = -40.0  # extreme outliers shrink the exceed tail
        m = tail_length(1000, 1.0)
        e, k, lp = loo_scores_psis(jnp.asarray(ll), m)
        e_ref, k_ref, lp_ref = self._reference_scores(ll)
        np.testing.assert_allclose(np.asarray(k), k_ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(e), e_ref, rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("reff", [0.7, 2.0])
    def test_reff_variants(self, rng, reff):
        import jax.numpy as jnp

        from pyloo_tpu.ops import tail_length
        from pyloo_tpu.ops.loo_kernels import loo_scores_psis

        ll = np.asarray(rng.normal(-1, 0.9, size=(16, 2000)))
        m = tail_length(2000, reff)
        e, k, lp = loo_scores_psis(jnp.asarray(ll), m)
        e_ref, k_ref, lp_ref = self._reference_scores(ll, reff=reff)
        np.testing.assert_allclose(np.asarray(k), k_ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(e), e_ref, rtol=1e-12, atol=1e-12)


class TestLinearFitExtremes:
    """The float64 linear-domain fit must track the reference even where
    exceedances reach the subnormal floor (tail spread ~ 700+ nats)."""

    def test_extreme_tail_spread(self, rng):
        import jax.numpy as jnp

        from pyloo_tpu.ops import tail_length
        from pyloo_tpu.ops.loo_kernels import loo_scores_psis

        ll = np.asarray(rng.normal(-1, 0.4, size=(6, 1200)))
        # rows whose tail spans hundreds of nats: exceedances near the
        # float64 subnormal floor after the max shift
        ll[0, :40] = -np.linspace(0, 700, 40) - 1.0
        ll[1, :200] = -np.linspace(0, 740, 200) - 1.0
        ll[2, :5] = -800.0  # mass far below the cutoff floor
        m = tail_length(1200, 1.0)
        e, k, lp = loo_scores_psis(jnp.asarray(ll), m)

        from scipy.special import logsumexp as sp_lse

        ref_lw, ref_k = _reference_psislw(-ll)
        e_ref = sp_lse(ref_lw + ll, axis=1)
        np.testing.assert_allclose(np.asarray(k), ref_k, rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(np.asarray(e), e_ref, rtol=1e-11, atol=1e-11)

    def test_guard_boundary_spread(self, rng):
        """Tail spread just inside the linear fit's deep-tail guard.

        Places the quartile exceedance at ~e^-59 (the guard routes batches
        below e^-60 to the signed-log fit), which drives the Zhang-Stephens
        candidate grid to |b| ~ e^60 and the product-scan leaf factors
        ``1 - b*y`` to ~2^87 — the top of the renormalization ladder's
        proven [2^-54, 2^89] leaf range.  Pins the 2-step ladder against
        the reference at the worst admissible magnitude.
        """
        import jax.numpy as jnp

        from pyloo_tpu.ops import tail_length
        from pyloo_tpu.ops.loo_kernels import loo_scores_psis

        S = 1000
        m = tail_length(S, 1.0)  # 95
        ll = np.asarray(rng.normal(-5, 0.1, size=(4, S)))
        for r, top_spread in enumerate((50.0, 57.0, 58.5, 59.0)):
            # ~3/4 of the tail sits top_spread nats below the row max (the
            # quartile anchor), the top quarter spreads up to the max
            ll[r, : 3 * m // 4] = (
                -top_spread - 1.0 - rng.uniform(0, 0.2, size=3 * m // 4)
            )
            ll[r, 3 * m // 4 : m] = -np.linspace(
                0.0, top_spread - 1.0, m - 3 * m // 4
            )
        ll = -ll  # build as weights, feed as log-lik
        e, k, lp = loo_scores_psis(jnp.asarray(ll), m)

        from scipy.special import logsumexp as sp_lse

        ref_lw, ref_k = _reference_psislw(-ll)
        e_ref = sp_lse(ref_lw + ll, axis=1)
        np.testing.assert_allclose(np.asarray(k), ref_k, rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(np.asarray(e), e_ref, rtol=1e-11, atol=1e-11)


class TestKhatTailOrderingDivergence:
    """Pin the DOCUMENTED divergence from the reference on e_loo's k_hat.

    The reference feeds a *descending* tail slice whose last element is an
    exact zero into ``_gpdfit`` (/root/reference/pyloo/e_loo.py:350-357):
    the ``1/ary[-1]`` term is infinite, every candidate log1p argument is
    NaN-poisoned, and the empirical-Bayes fit collapses to the prior
    constant ``5/(tail_len+10)`` regardless of the data.  This package
    implements the intended diagnostic (exceedances over the
    (tail_len+1)-th order statistic, ascending — matching R `loo`'s
    posterior::pareto_khat contract).  See docs/API.md "k_hat divergence".
    """

    TAIL = 20

    @pytest.fixture
    def heavy_lr(self):
        rng = np.random.default_rng(42)
        return rng.standard_t(df=3, size=1000)

    def test_reference_collapses_to_prior_constant(self, heavy_lr):
        ref_eloo = load_reference_module("e_loo")
        with np.errstate(divide="ignore", invalid="ignore"):
            k_ref = ref_eloo.k_hat(None, heavy_lr, self.TAIL)
        # heavy t(3) ratios: the true tail index is ~1.4, but the reference
        # reports the data-independent prior mean
        assert k_ref == pytest.approx(5.0 / (self.TAIL + 10), abs=1e-15)

    def test_repo_matches_ascending_oracle(self, heavy_lr):
        from pyloo_tpu.ops.expectations import khat_batch

        # independent oracle: reference's own _gpdfit on CORRECTLY ordered
        # exceedances over the (tail_len+1)-th largest order statistic
        r = np.exp(heavy_lr - heavy_lr.max())
        s = np.sort(r)
        exceed = s[-self.TAIL:] - s[-(self.TAIL + 1)]
        k_oracle, _ = ref_psis._gpdfit(np.ascontiguousarray(exceed))

        k_repo = float(
            np.asarray(
                khat_batch(
                    heavy_lr[None, :],
                    heavy_lr[None, :],
                    tail_len=self.TAIL,
                    use_h=False,
                )
            )[0]
        )
        np.testing.assert_allclose(k_repo, k_oracle, rtol=1e-10)
        # and it is far from the reference's collapsed constant
        assert abs(k_repo - 5.0 / (self.TAIL + 10)) > 1.0
