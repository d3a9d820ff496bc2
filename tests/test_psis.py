"""PSIS/SIS/TIS kernel tests: invariants + parity against the scalar oracle."""

import numpy as np
import pytest
from numpy.testing import assert_allclose

import pyloo_tpu as pl
from pyloo_tpu.ops import gpdfit, gpinv, psislw_batch, tail_length

from .oracle import fit_gpd_zhang_stephens, gpd_quantile, psis_matrix, sis_row, tis_row


def make_log_weights(rng, n_obs=8, n_samples=1000, scale=1.0, heavy=False):
    if heavy:
        # heavy-tailed raw weights drive high Pareto k
        return rng.standard_t(df=2, size=(n_obs, n_samples)) * scale
    return rng.normal(size=(n_obs, n_samples)) * scale


class TestPsisParity:
    @pytest.mark.parametrize("n_samples", [100, 500, 2000])
    @pytest.mark.parametrize("reff", [1.0, 0.7, 0.3])
    def test_matches_oracle(self, rng, n_samples, reff):
        lw = make_log_weights(rng, n_obs=16, n_samples=n_samples)
        got_lw, got_k = pl.psislw(lw, reff=reff)
        want_lw, want_k = psis_matrix(lw, reff=reff)
        assert_allclose(np.asarray(got_lw), want_lw, rtol=1e-9, atol=1e-9)
        assert_allclose(np.asarray(got_k), want_k, rtol=1e-9, atol=1e-9)

    def test_matches_oracle_heavy_tails(self, rng):
        lw = make_log_weights(rng, n_obs=32, n_samples=800, scale=3.0, heavy=True)
        got_lw, got_k = pl.psislw(lw)
        want_lw, want_k = psis_matrix(lw)
        assert_allclose(np.asarray(got_lw), want_lw, rtol=1e-8, atol=1e-8)
        assert_allclose(np.asarray(got_k), want_k, rtol=1e-8, atol=1e-8)

    def test_multidim_obs(self, rng):
        lw = rng.normal(size=(3, 5, 400))
        got_lw, got_k = pl.psislw(lw)
        want_lw, want_k = psis_matrix(lw.reshape(-1, 400))
        assert_allclose(np.asarray(got_lw).reshape(-1, 400), want_lw, atol=1e-9)
        assert_allclose(np.asarray(got_k).ravel(), want_k, atol=1e-9)


class TestPsisInvariants:
    def test_weights_normalize(self, rng):
        lw = make_log_weights(rng)
        smoothed, k = pl.psislw(lw)
        totals = np.exp(np.asarray(smoothed)).sum(axis=1)
        assert_allclose(totals, 1.0, rtol=1e-12)

    def test_smoothing_changes_tail(self, rng):
        lw = make_log_weights(rng, n_obs=1, n_samples=1000)
        smoothed, k = pl.psislw(lw)
        norm_only = lw[0] - lw[0].max()
        norm_only -= np.log(np.exp(norm_only).sum())
        assert not np.allclose(np.asarray(smoothed)[0], norm_only)

    def test_constant_weights_k_inf(self):
        lw = np.zeros((2, 500))
        smoothed, k = pl.psislw(lw)
        assert np.all(np.isinf(np.asarray(k)))
        assert_allclose(np.asarray(smoothed), np.full((2, 500), -np.log(500)))

    def test_tiny_sample_k_inf(self, rng):
        # with S=10 the tail budget is ceil(10/5)=2 <= 4 exceedances
        lw = rng.normal(size=(3, 10))
        smoothed, k = pl.psislw(lw)
        assert np.all(np.isinf(np.asarray(k)))

    def test_dataarray_roundtrip(self, rng):
        values = rng.normal(size=(4, 250, 8))
        da = pl.DataArray(
            values,
            ("chain", "draw", "school"),
            {"school": np.array([f"s{i}" for i in range(8)])},
        )
        lw, k = pl.psislw(da)
        assert lw.dims == ("school", "__sample__")
        assert k.dims == ("school",)
        flat = values.transpose(2, 0, 1).reshape(8, -1)
        want_lw, want_k = psis_matrix(flat)
        assert_allclose(lw.values, want_lw, atol=1e-9)
        assert_allclose(k.values, want_k, atol=1e-9)


class TestGpdFit:
    def test_against_oracle(self, rng):
        for n in [5, 20, 117, 400]:
            sample = np.sort(rng.gamma(2.0, 1.0, size=n))
            k_got, s_got = gpdfit(sample)
            k_want, s_want = fit_gpd_zhang_stephens(sample)
            assert_allclose(float(k_got), k_want, rtol=1e-10)
            assert_allclose(float(s_got), s_want, rtol=1e-10)

    def test_recovers_known_shape(self, rng):
        # draws from a GPD with k=0.4, sigma=1: estimate should be close
        u = rng.uniform(size=4000)
        sample = np.sort(np.expm1(-0.4 * np.log1p(-u)) / 0.4)
        k_got, s_got = gpdfit(sample)
        assert abs(float(k_got) - 0.4) < 0.05
        assert abs(float(s_got) - 1.0) < 0.1


class TestGpinv:
    @pytest.mark.parametrize("kappa", [-1.0, -0.3, 0.0, 0.3, 1.0])
    @pytest.mark.parametrize("sigma", [0.5, 1.0, 3.0])
    def test_matches_oracle(self, kappa, sigma):
        probs = np.linspace(0.01, 0.99, 50)
        got = np.asarray(gpinv(probs, kappa, sigma))
        want = gpd_quantile(probs, kappa, sigma)
        assert_allclose(got, want, rtol=1e-12)

    def test_edge_probs(self):
        probs = np.array([0.0, 0.5, 1.0])
        got = np.asarray(gpinv(probs, 0.5, 1.0))
        assert got[0] == 0.0
        assert np.isinf(got[2])
        got_neg = np.asarray(gpinv(probs, -0.5, 1.0))
        assert_allclose(got_neg[2], 2.0)  # upper endpoint -sigma/kappa

    def test_nonpositive_sigma_nan(self):
        got = np.asarray(gpinv(np.array([0.1, 0.9]), 0.5, -1.0))
        assert np.all(np.isnan(got))


class TestSisTis:
    def test_sis_matches_oracle(self, rng):
        lw = make_log_weights(rng, n_obs=6, n_samples=300)
        got_lw, got_ess = pl.sislw(lw)
        for i in range(6):
            want_lw, want_ess = sis_row(lw[i])
            assert_allclose(np.asarray(got_lw)[i], want_lw, atol=1e-10)
            assert_allclose(float(np.asarray(got_ess)[i]), want_ess, rtol=1e-10)

    def test_tis_matches_oracle(self, rng):
        lw = make_log_weights(rng, n_obs=6, n_samples=300, scale=2.0)
        got_lw, got_ess = pl.tislw(lw)
        for i in range(6):
            want_lw, want_ess = tis_row(lw[i])
            assert_allclose(np.asarray(got_lw)[i], want_lw, atol=1e-10)
            assert_allclose(float(np.asarray(got_ess)[i]), want_ess, rtol=1e-10)

    def test_ess_bounds(self, rng):
        lw = make_log_weights(rng, n_obs=10, n_samples=500)
        _, ess = pl.sislw(lw)
        ess = np.asarray(ess)
        assert np.all(ess > 0) and np.all(ess <= 500)


class TestShardedExecution:
    def test_multi_device_matches_single(self, rng):
        import jax

        from pyloo_tpu.ops import psislw_batch, tail_length
        from pyloo_tpu.parallel import apply_rowwise, obs_mesh

        assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"
        lw = make_log_weights(rng, n_obs=37, n_samples=600)  # non-divisible B
        m = tail_length(600, 1.0)
        kern = lambda b: psislw_batch(b, m)
        sharded = apply_rowwise(kern, lw, mesh=obs_mesh())
        single = apply_rowwise(kern, lw, mesh=None)
        assert_allclose(np.asarray(sharded[0]), np.asarray(single[0]), atol=1e-12)
        assert_allclose(np.asarray(sharded[1]), np.asarray(single[1]), atol=1e-12)

    def test_chunked_matches_whole(self, rng):
        from pyloo_tpu.ops import psislw_batch, tail_length
        from pyloo_tpu.parallel import apply_rowwise

        lw = make_log_weights(rng, n_obs=50, n_samples=200)
        m = tail_length(200, 1.0)
        kern = lambda b: psislw_batch(b, m)
        whole = apply_rowwise(kern, lw, mesh=None)
        chunked = apply_rowwise(kern, lw, mesh=None, chunk_bytes=200 * 8 * 7)
        assert_allclose(np.asarray(whole[0]), np.asarray(chunked[0]), atol=1e-12)
        assert_allclose(np.asarray(whole[1]), np.asarray(chunked[1]), atol=1e-12)


class TestFastPath:
    def test_fast_kernel_matches_exact_f64(self, rng):
        import jax.numpy as jnp

        from pyloo_tpu.ops.loo_kernels import (
            loo_scores_psis,
            loo_scores_psis_fast,
        )

        ll = rng.normal(-1, 0.8, size=(48, 1200))
        m = tail_length(1200, 1.0)
        e, k, l = loo_scores_psis(jnp.asarray(ll), m)
        ef, kf, lf, _dg = loo_scores_psis_fast(jnp.asarray(ll), m)
        assert_allclose(np.asarray(e), np.asarray(ef), rtol=1e-12)
        assert_allclose(np.asarray(k), np.asarray(kf), rtol=1e-12)
        assert_allclose(np.asarray(l), np.asarray(lf), rtol=1e-12)

    def test_loo_float32_fast_path(self, rng):
        import pyloo_tpu as pl

        ll = rng.normal(-1, 0.5, size=(2, 300, 40))
        idata = pl.from_dict(
            posterior={"mu": rng.normal(size=(2, 300))},
            log_likelihood={"obs": ll},
        )
        r64 = pl.loo(idata, pointwise=True, reff=1.0)
        pl.rcParams["device.precision"] = "float32"
        try:
            r32 = pl.loo(idata, pointwise=True, reff=1.0)
        finally:
            pl.rcParams["device.precision"] = "float64"
        assert_allclose(r32["elpd_loo"], r64["elpd_loo"], rtol=1e-4)
        assert_allclose(
            r32.pareto_k.values, r64.pareto_k.values, atol=2e-3
        )


@pytest.mark.parametrize("n_draws", [4000])
def test_bench_scale_parity(rng, n_draws):
    """BASELINE tolerance at the benchmark draw count (S=4000, float64)."""
    lw = rng.normal(size=(24, n_draws)) * 1.2
    got_lw, got_k = pl.psislw(lw)
    want_lw, want_k = psis_matrix(lw)
    assert_allclose(np.asarray(got_lw), want_lw, rtol=1e-8, atol=1e-8)
    assert_allclose(np.asarray(got_k), want_k, rtol=1e-8, atol=1e-8)


class TestFastPathAdversarial:
    """Fast-vs-exact agreement on the inputs that break naive f32 kernels.

    The float32 throughput path documents one semantic divergence (rows whose
    GPD fit degenerates to sigma <= 0 keep the unsmoothed tail instead of the
    reference's NaN poisoning); everywhere else it must track the float64
    exact path within float32 conditioning.  Reference gpinv semantics:
    ``pyloo/psis.py:211-231``.
    """

    @staticmethod
    def _both(ll64):
        import jax.numpy as jnp

        from pyloo_tpu.ops.loo_kernels import (
            loo_scores_psis,
            loo_scores_psis_fast,
        )

        m = tail_length(ll64.shape[1], 1.0)
        e, k, l = loo_scores_psis(jnp.asarray(ll64, jnp.float64), m)
        ef, kf, lf, _dg = loo_scores_psis_fast(
            jnp.asarray(ll64, jnp.float32), m
        )
        return (
            np.asarray(e),
            np.asarray(k),
            np.asarray(l),
            np.asarray(ef, dtype=np.float64),
            np.asarray(kf, dtype=np.float64),
            np.asarray(lf, dtype=np.float64),
        )

    @staticmethod
    def _fast_equals_exact_f64(ll64):
        """In float64 the fast kernel must reproduce the exact kernel."""
        import jax.numpy as jnp

        from pyloo_tpu.ops.loo_kernels import (
            loo_scores_psis,
            loo_scores_psis_fast,
        )

        m = tail_length(ll64.shape[1], 1.0)
        e, k, l = loo_scores_psis(jnp.asarray(ll64, jnp.float64), m)
        ef, kf, lf, _dg = loo_scores_psis_fast(jnp.asarray(ll64, jnp.float64), m)
        finite = np.isfinite(np.asarray(k))
        assert_allclose(
            np.asarray(ef)[finite],
            np.asarray(e)[finite],
            rtol=1e-10,
            atol=1e-12,
        )
        assert_allclose(
            np.asarray(kf)[finite],
            np.asarray(k)[finite],
            rtol=1e-10,
            atol=1e-12,
        )
        assert np.array_equal(
            np.isinf(np.asarray(kf)), np.isinf(np.asarray(k))
        )
        assert_allclose(np.asarray(lf), np.asarray(l), rtol=1e-12)

    def test_heavy_tails(self, rng):
        # log-ratios with k ~ 0.7-1.2: importance weights from a Cauchy-ish
        # proposal mismatch; exactly the regime PSIS exists for
        z = rng.standard_t(df=2, size=(64, 2000))
        ll = -np.abs(z) * 3.0
        self._fast_equals_exact_f64(ll)
        e, k, l, ef, kf, lf = self._both(ll)
        assert_allclose(ef, e, rtol=5e-4, atol=5e-4)
        assert_allclose(kf, k, atol=5e-3)

    def test_near_degenerate_tail(self, rng):
        # tail values nearly identical: sigma -> 0 fit degeneracy candidate
        ll = rng.normal(0, 1e-6, size=(32, 1000))
        ll[:, :300] += rng.normal(0, 1e-4, size=(32, 300))
        self._fast_equals_exact_f64(ll)

    def test_constant_rows(self):
        ll = np.full((8, 500), -1.3)
        e, k, l, ef, kf, lf = self._both(ll)
        assert np.all(np.isinf(k)) and np.all(np.isinf(kf))
        assert_allclose(ef, e, rtol=1e-6)
        assert_allclose(lf, l, rtol=1e-6)

    def test_single_outlier_rows(self, rng):
        # one dominating draw: tail has <= 4 distinct exceedances -> k = inf
        ll = rng.normal(-1, 0.1, size=(16, 800))
        ll[:, 0] = 40.0
        e, k, l, ef, kf, lf = self._both(ll)
        assert np.array_equal(np.isinf(k), np.isinf(kf))
        assert_allclose(ef, e, rtol=1e-3, atol=1e-3)

    def test_huge_dynamic_range(self, rng):
        # raw weights spanning e^300: breaks any non-log-domain f32 fit
        ll = rng.normal(0, 1, size=(32, 1500)) * 100.0
        self._fast_equals_exact_f64(ll)
        e, k, l, ef, kf, lf = self._both(ll)
        assert np.all(np.isfinite(ef))
        assert_allclose(kf, k, atol=2e-2)

    def test_tie_heavy_rows(self, rng):
        # quantized log-lik: many exact ties around the cutoff (strict-> ties
        # excluded from the tail, reference psis.py:139)
        ll = np.round(rng.normal(-1, 0.5, size=(24, 1000)) * 8) / 8.0
        self._fast_equals_exact_f64(ll)
        e, k, l, ef, kf, lf = self._both(ll)
        assert_allclose(ef, e, rtol=1e-3, atol=1e-3)
        assert np.array_equal(np.isinf(k), np.isinf(kf))

    def test_nan_rows_via_loo(self, rng):
        # NaNs are replaced upstream (-1e10 + warning, reference loo.py:218)
        import pyloo_tpu as pl

        ll = rng.normal(-1, 0.5, size=(2, 400, 30))
        ll[0, 5, 3] = np.nan
        idata = pl.from_dict(
            posterior={"mu": rng.normal(size=(2, 400))},
            log_likelihood={"obs": ll},
        )
        pl.rcParams["device.precision"] = "float32"
        try:
            with pytest.warns(UserWarning, match="NaN"):
                r32 = pl.loo(idata, pointwise=True, reff=1.0)
        finally:
            pl.rcParams["device.precision"] = "float64"
        assert np.isfinite(r32["elpd_loo"])

    def test_mixed_scales_across_rows(self, rng):
        ll = rng.normal(-1, 0.5, size=(40, 1200))
        ll[::3] *= 50.0
        ll[1::3] *= 1e-3
        self._fast_equals_exact_f64(ll)
        e, k, l, ef, kf, lf = self._both(ll)
        finite = np.isfinite(k)
        assert_allclose(kf[finite], k[finite], atol=2e-2)


class TestProductScanFit:
    """The renormalized-product float64 profile scan (``product=True``).

    ``loo_scores_psis`` enables it (one f64 transcendental per candidate
    instead of one per tail element); these pin that the product form
    matches the term-by-term scan to the same class of deviation the
    sequential scan itself shows against the reference (sum-order
    conditioning of the Zhang-Stephens posterior mean), including on the
    degenerate and extreme-spread tails that broke the earlier pair-merged
    rewrite (the product of positive factors cannot cancel, and the
    power-of-two renormalization keeps partials in range even under a
    float32-exponent-range f64 emulation).
    """

    S = 1200

    def _fit_inputs(self, ll):
        import jax.numpy as jnp

        M = tail_length(ll.shape[1], 1.0)
        floor = np.log(np.finfo(np.float64).tiny)
        x = -ll
        x = x - x.max(axis=1, keepdims=True)
        vals = np.sort(x, axis=1)[:, ::-1][:, : M + 1]
        cutoff = np.maximum(vals[:, M], floor)
        tail_vals = vals[:, :M]
        n = (tail_vals > cutoff[:, None]).sum(1).astype(np.int32)
        with np.errstate(divide="ignore", invalid="ignore"):
            le = np.where(
                tail_vals > cutoff[:, None],
                tail_vals
                + np.log1p(-np.exp(np.minimum(cutoff[:, None] - tail_vals, 0))),
                -np.inf,
            )
        q_idx = np.clip((n + 2) // 4 - 1, 0, M - 1)
        q_desc = np.clip(n - 1 - q_idx, 0, M - 1)
        lq = np.take_along_axis(le, q_desc[:, None], axis=1)[:, 0]
        return (
            jnp.asarray(le),
            jnp.asarray(n),
            jnp.asarray(lq),
            jnp.asarray(le[:, 0]),
        )

    def _both(self, ll):
        from pyloo_tpu.ops.psis import _gpdfit_batch_linear

        la, n, lq, llast = self._fit_inputs(ll)
        k0, s0, g0 = _gpdfit_batch_linear(la, n, lq, llast, product=False)
        k1, s1, g1 = _gpdfit_batch_linear(la, n, lq, llast, product=True)
        live = np.asarray(n) > 4
        return (live,) + tuple(map(np.asarray, (k0, s0, g0, k1, s1, g1)))

    def _assert_close(self, ll, atol):
        live, k0, s0, g0, k1, s1, g1 = self._both(ll)
        if not live.any():
            return
        for a, b in ((k0, k1), (g0, g1)):
            d = np.abs(a - b)[live]
            both_nan = (np.isnan(a) & np.isnan(b))[live]
            assert np.max(np.where(both_nan, 0.0, d)) <= atol
        assert np.array_equal(s0[live], s1[live], equal_nan=True)

    @pytest.mark.parametrize(
        "kind",
        [
            "normal",
            "t3",
            "tinyvar",
            "ties",
            "lognormal",
            "odd_m",
            "degenerate",
            "extreme_spread",
        ],
    )
    def test_product_matches_sequential(self, rng, kind):
        S = self.S
        if kind == "normal":
            ll = rng.normal(-1, 1.5, size=(96, S))
        elif kind == "t3":
            ll = rng.standard_t(3, size=(96, S))
        elif kind == "tinyvar":
            ll = rng.normal(0, 1e-8, size=(96, S))
        elif kind == "ties":
            ll = np.round(rng.normal(-1, 2, size=(96, S)) * 4) / 4
        elif kind == "lognormal":
            ll = -np.exp(2 * rng.normal(size=(96, S)))
        elif kind == "odd_m":  # non-pow2 tail budget -> zero-padded slots
            ll = rng.normal(size=(96, 901))
        elif kind == "degenerate":
            # near-equal tails (the pair-merge killer: factors all ~0 there)
            ll = np.full((48, S), -2.0)
            ll[:, :6] = rng.normal(size=(48, 6))
        else:  # extreme spread: tail exceedances span ~100 nats, so the
            # grid's negative candidates make leaf factors ~e^90 — exercises
            # the multi-step leaf renormalization
            ll = 50.0 * rng.normal(size=(64, S))
        # the bound is the sequential scan's OWN sum-order deviation class
        # vs the reference (measured 3e-12 on t3); the product tree's error
        # is ~2*P*eps absolute on the profile sum, far below it
        self._assert_close(ll, atol=5e-12)

    def test_exact_path_end_to_end_unchanged_class(self, rng):
        """loo_scores_psis (paired) vs a sequential-fit replica at 1e-12 on
        realistic data — the contract the reference-parity suite pins."""
        import jax.numpy as jnp

        from pyloo_tpu.ops.loo_kernels import loo_scores_psis

        ll = rng.normal(-1, 1.5, size=(64, self.S))
        M = tail_length(self.S, 1.0)
        e, k, l = map(np.asarray, loo_scores_psis(jnp.asarray(ll), M))
        lw, kb = psislw_batch(jnp.asarray(-ll), M)
        e_ref = np.asarray(
            pl.psislw(-ll)[0]
        )  # smoke: public API path agrees with kernel weights
        elpd_ref = np.log(np.sum(np.exp(np.asarray(lw) + ll), axis=1))
        assert_allclose(e, elpd_ref, rtol=0, atol=1e-10)
        assert_allclose(k, np.asarray(kb), rtol=0, atol=5e-12)


class TestFastPathHeavyTails:
    """End-to-end roundoff-class agreement of the float32 fast scores with
    the float64 exact scores on heavy-tailed data (pins the fast path's
    GPD-fit accuracy contract at the kernel level)."""

    S = 1000

    def test_fast_scores_roundoff_close_to_exact(self, rng):
        import jax.numpy as jnp

        from pyloo_tpu.ops.loo_kernels import (
            loo_scores_psis,
            loo_scores_psis_fast,
        )

        ll = 2.0 * rng.standard_t(3, size=(300, self.S)) - 1.0
        M = tail_length(self.S, 1.0)
        e64, k64, _ = map(np.asarray, loo_scores_psis(jnp.asarray(ll), M))
        e32, k32, _, dg = map(
            np.asarray,
            loo_scores_psis_fast(jnp.asarray(ll, jnp.float32), M),
        )
        ok = ~np.asarray(dg)
        assert_allclose(e32[ok], e64[ok], rtol=1e-4, atol=1e-4)
        fin = ok & np.isfinite(k64) & np.isfinite(k32)
        assert_allclose(k32[fin], k64[fin], rtol=0, atol=2e-3)


class TestDeepTailFallback:
    """The f64 linear GPD fit must route deep/wide tails to the signed-log
    fit: exceedances of rows whose tail sits ~90+ nats below the row max
    underflow the linear pipeline on a float64 with float32's exponent
    range, and spreads beyond ~705 nats NaN even full-range IEEE f64."""

    def test_psislw_deep_rows_match_oracle(self):
        import jax.numpy as jnp

        rng = np.random.default_rng(7)
        b, s = 8, 1000
        lw_np = rng.normal(0.0, 1.0, size=(b, s))
        lw_np[:2] = rng.standard_t(2, size=(2, s)) * 2.0  # ranges ~180-230
        lw_got, k_got = pl.psislw(jnp.asarray(lw_np, jnp.float64))
        lw_want, k_want = psis_matrix(lw_np)
        assert np.isfinite(np.asarray(k_got)[:2]).all()
        assert_allclose(np.asarray(lw_got), lw_want, rtol=0, atol=1e-10)
        fin = np.isfinite(k_want)
        assert_allclose(np.asarray(k_got)[fin], k_want[fin], rtol=0, atol=1e-10)

    def test_linear_fit_falls_back_finite_at_any_scale(self):
        # pre-fix: NaN on CPU beyond ~705 nats of tail spread; the signed-log
        # fallback must agree with the linear fit where both are defined and
        # stay finite everywhere
        import jax.numpy as jnp

        from pyloo_tpu.ops.psis import _gpdfit_batch, _gpdfit_batch_linear

        rng = np.random.default_rng(0)
        for scale in (1.0, 40.0, 120.0, 400.0):
            lw = np.sort(rng.standard_t(2, size=(4, 191)) * scale, axis=1)
            lw = lw - lw.max(axis=1, keepdims=True) - 0.01
            la = jnp.asarray(lw, jnp.float64)
            n = jnp.full((4,), 191, jnp.int32)
            k1, s1, ls1 = _gpdfit_batch_linear(la, n, product=True)
            k2, s2, ls2 = _gpdfit_batch(la, n)
            assert np.isfinite(np.asarray(k1)).all(), scale
            assert_allclose(np.asarray(k1), np.asarray(k2), rtol=0, atol=2e-13)
            assert_allclose(np.asarray(ls1), np.asarray(ls2), rtol=0, atol=2e-13)

    def test_exact_kernel_deep_row_finite(self, rng):
        import jax.numpy as jnp

        from pyloo_tpu.ops.loo_kernels import loo_scores_psis

        ll = rng.normal(-1, 0.5, size=(32, 2000))
        ll[5] = rng.standard_t(2, size=2000) * 8.0 - 30.0  # deep tail row
        M = tail_length(2000, 1.0)
        e, k, lp = map(
            np.asarray, loo_scores_psis(jnp.asarray(ll, jnp.float64), M)
        )
        lw_o, k_o = psis_matrix(-ll)
        elpd_o = np.array(
            [np.logaddexp.reduce(lw_o[i] + ll[i]) for i in range(32)]
        )
        assert np.isfinite(e).all()
        assert_allclose(e, elpd_o, rtol=0, atol=1e-9)
        fin = np.isfinite(k_o)
        assert_allclose(k[fin], k_o[fin], rtol=0, atol=1e-10)

    def test_vmapped_psislw_batch_with_deep_rows(self):
        # moment matching vmaps psislw_batch; the lax.cond must degrade to a
        # select there without error
        import jax
        import jax.numpy as jnp

        rng = np.random.default_rng(3)
        lw = rng.normal(size=(3, 4, 500))
        lw[0, 0] = rng.standard_t(2, size=500) * 2.0
        out_lw, out_k = jax.vmap(
            lambda m: psislw_batch(m, tail_length(500, 1.0))
        )(jnp.asarray(lw, jnp.float64))
        assert np.isfinite(np.asarray(out_k)).all()
        flat_lw, flat_k = psislw_batch(
            jnp.asarray(lw.reshape(12, 500), jnp.float64), tail_length(500, 1.0)
        )
        assert_allclose(
            np.asarray(out_lw).reshape(12, 500),
            np.asarray(flat_lw),
            rtol=0,
            atol=1e-10,
        )
