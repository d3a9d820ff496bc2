"""loo_streaming must reproduce loo() exactly on materialized data."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

import pyloo_tpu as pl

N_OBS, N_DRAWS = 103, 500  # deliberately not a multiple of any chunk size


@pytest.fixture(scope="module")
def ll_matrix(rng_module):
    return rng_module.normal(-1.2, 0.6, size=(N_OBS, N_DRAWS))


@pytest.fixture(scope="module")
def rng_module():
    return np.random.default_rng(11)


def _fn(ll_dev):
    def log_lik_fn(idx):
        return ll_dev[idx]

    return log_lik_fn


def _loo_reference(ll, **kw):
    idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pl.loo(idata, reff=1.0, **kw)


@pytest.mark.parametrize("chunk", [16, 64, 200])
def test_matches_loo_exact(ll_matrix, chunk):
    ll_dev = jnp.asarray(ll_matrix)
    res = pl.loo_streaming(
        _fn(ll_dev), N_OBS, N_DRAWS, chunk_size=chunk, dtype=jnp.float64
    )
    ref = _loo_reference(ll_matrix)
    for key in ("elpd_loo", "se", "p_loo", "p_loo_se", "looic", "looic_se"):
        assert_allclose(res[key], ref[key], rtol=1e-9, err_msg=key)
    assert res["n_samples"] == N_DRAWS
    assert res["n_data_points"] == N_OBS
    assert res["good_k"] == ref["good_k"]


def test_pointwise_matches(ll_matrix):
    ll_dev = jnp.asarray(ll_matrix)
    res = pl.loo_streaming(
        _fn(ll_dev), N_OBS, N_DRAWS, chunk_size=32, pointwise=True,
        dtype=jnp.float64,
    )
    ref = _loo_reference(ll_matrix, pointwise=True)
    assert_allclose(res.loo_i.values, ref.loo_i.values, rtol=1e-9)
    assert_allclose(res.pareto_k.values, ref.pareto_k.values, rtol=1e-7)
    assert res.loo_i.values.shape == (N_OBS,)


def test_fast_f32_path_close(ll_matrix):
    ll_dev = jnp.asarray(ll_matrix, jnp.float32)
    res = pl.loo_streaming(
        _fn(ll_dev), N_OBS, N_DRAWS, chunk_size=64, dtype=jnp.float32
    )
    ref = _loo_reference(ll_matrix)
    assert_allclose(res["elpd_loo"], ref["elpd_loo"], rtol=5e-5)
    assert_allclose(res["p_loo"], ref["p_loo"], atol=5e-3)


def test_scale_deviance(ll_matrix):
    ll_dev = jnp.asarray(ll_matrix)
    res = pl.loo_streaming(
        _fn(ll_dev), N_OBS, N_DRAWS, scale="deviance", dtype=jnp.float64
    )
    ref = _loo_reference(ll_matrix, scale="deviance")
    for key in ("elpd_loo", "se", "p_loo", "p_loo_se"):
        assert_allclose(res[key], ref[key], rtol=1e-9, err_msg=key)
    assert res["scale"] == "deviance"


@pytest.mark.parametrize("method", ["sis", "tis"])
def test_sis_tis_methods(ll_matrix, method):
    ll_dev = jnp.asarray(ll_matrix)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = pl.loo_streaming(
            _fn(ll_dev), N_OBS, N_DRAWS, method=method, pointwise=True,
            dtype=jnp.float64,
        )
        ref = _loo_reference(ll_matrix, method=method, pointwise=True)
    assert_allclose(res["elpd_loo"], ref["elpd_loo"], rtol=1e-9)
    assert_allclose(res.ess.values, ref.ess.values, rtol=1e-9)


def test_mesh_sharded_streaming(ll_matrix):
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:8]), axis_names=("obs",))
    ll_dev = jnp.asarray(ll_matrix)
    res = pl.loo_streaming(
        _fn(ll_dev), N_OBS, N_DRAWS, chunk_size=40, mesh=mesh,
        dtype=jnp.float64,
    )
    ref = _loo_reference(ll_matrix)
    assert_allclose(res["elpd_loo"], ref["elpd_loo"], rtol=1e-9)


def test_on_the_fly_model_never_materializes(rng_module):
    # model-backed ll: logistic regression with device-resident draws;
    # streaming result must equal loo() on the explicitly materialized matrix
    n, d, s = 257, 5, 400
    X = rng_module.normal(size=(n, d))
    y = (rng_module.random(n) < 0.5).astype(np.float64)
    beta = rng_module.normal(scale=0.3, size=(s, d))
    Xd, yd, bd = jnp.asarray(X), jnp.asarray(y), jnp.asarray(beta)

    def log_lik_fn(idx):
        logits = Xd[idx] @ bd.T  # (chunk, s)
        return yd[idx, None] * jax.nn.log_sigmoid(logits) + (
            1 - yd[idx, None]
        ) * jax.nn.log_sigmoid(-logits)

    ll = np.asarray(log_lik_fn(jnp.arange(n)))
    res = pl.loo_streaming(log_lik_fn, n, s, chunk_size=96, dtype=jnp.float64)
    ref = _loo_reference(ll)
    assert_allclose(res["elpd_loo"], ref["elpd_loo"], rtol=1e-9)
    assert_allclose(res["se"], ref["se"], rtol=1e-9)


def test_validation():
    fn = lambda idx: jnp.zeros((idx.shape[0], 1))
    with pytest.raises(ValueError, match="at least 2 draws"):
        pl.loo_streaming(fn, 10, 1)
    with pytest.raises(ValueError, match="n_obs"):
        pl.loo_streaming(fn, 0, 100)
    with pytest.raises(ValueError):
        pl.loo_streaming(fn, 10, 100, method="bogus")


def test_high_khat_warns(rng_module):
    # heavy-tailed importance ratios (t, df<2) -> k above threshold
    ll = -rng_module.standard_t(df=1.2, size=(24, 300)) * 2
    ll_dev = jnp.asarray(ll)
    with pytest.warns(UserWarning, match="Pareto"):
        res = pl.loo_streaming(_fn(ll_dev), 24, 300, dtype=jnp.float64)
    assert bool(res["warning"])


class TestSubsampleStreaming:
    @pytest.fixture(scope="class")
    def big(self):
        rng = np.random.default_rng(5)
        n, s = 2000, 400
        ll = rng.normal(-1.0, 0.5, size=(n, s))
        return n, s, ll, jnp.asarray(ll)

    def test_fixed_indices_match_loo_subsample(self, big):
        n, s, ll, ll_dev = big
        idx = np.arange(0, n, 5)  # fixed subsample: estimator randomness off
        res = pl.loo_subsample_streaming(
            lambda i: ll_dev[i], n, s, observations=idx, dtype=jnp.float64,
            pointwise=True,
        )
        idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = pl.loo_subsample(
                idata, observations=idx, loo_approximation="lpd", reff=1.0,
                pointwise=True,
            )
        for key in (
            "elpd_loo", "se", "p_loo", "p_loo_se", "subsampling_SE",
            "looic", "looic_se", "looic_subsamp_se",
        ):
            assert_allclose(res[key], ref[key], rtol=1e-9, err_msg=key)
        assert res["subsample_size"] == ref["subsample_size"] == len(idx)
        assert_allclose(
            res.loo_i.values[idx], np.asarray(ref.loo_i.values).ravel()[idx],
            rtol=1e-9,
        )

    def test_diff_srs_estimate_close_to_full(self, big):
        n, s, ll, ll_dev = big
        res = pl.loo_subsample_streaming(
            lambda i: ll_dev[i], n, s, observations=500, seed=7,
            dtype=jnp.float64,
        )
        idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            full = pl.loo(idata, reff=1.0)
        z = abs(res["elpd_loo"] - full["elpd_loo"]) / max(
            res["subsampling_SE"], 1e-12
        )
        assert z < 4.0, (res["elpd_loo"], full["elpd_loo"], res["subsampling_SE"])

    def test_hh_pps_estimator(self, big):
        n, s, ll, ll_dev = big
        res = pl.loo_subsample_streaming(
            lambda i: ll_dev[i], n, s, observations=400, estimator="hh_pps",
            seed=11, dtype=jnp.float64,
        )
        assert np.isfinite(res["elpd_loo"])
        assert res["subsampling_SE"] > 0
        assert res["method"] == "loo_subsample"

    def test_precomputed_approximation(self, big):
        n, s, ll, ll_dev = big
        from scipy.special import logsumexp as sp

        lpd = sp(ll, axis=1) - np.log(s)
        r1 = pl.loo_subsample_streaming(
            lambda i: ll_dev[i], n, s, observations=np.arange(100),
            elpd_loo_approximation=lpd, dtype=jnp.float64,
        )
        r2 = pl.loo_subsample_streaming(
            lambda i: ll_dev[i], n, s, observations=np.arange(100),
            dtype=jnp.float64,
        )
        assert_allclose(r1["elpd_loo"], r2["elpd_loo"], rtol=1e-9)

    def test_validation(self, big):
        n, s, ll, ll_dev = big
        fn = lambda i: ll_dev[i]
        with pytest.raises(ValueError, match="Invalid estimator"):
            pl.loo_subsample_streaming(fn, n, s, estimator="bogus")
        with pytest.raises(ValueError, match="between 1 and"):
            pl.loo_subsample_streaming(fn, n, s, observations=0)
        with pytest.raises(ValueError, match="Observation indices"):
            pl.loo_subsample_streaming(
                fn, n, s, observations=np.array([0, n])
            )
        with pytest.raises(ValueError, match="must have length"):
            pl.loo_subsample_streaming(
                fn, n, s, observations=10,
                elpd_loo_approximation=np.zeros(5),
            )
        with pytest.raises(TypeError, match="integer"):
            pl.loo_subsample_streaming(fn, n, s, observations=2.5)


class TestGeneratorCache:
    """The chunk-generator memoization contract (weakref cache + clear hook)."""

    def test_clear_forces_retrace_after_captured_state_change(self):
        rng = np.random.default_rng(3)
        ll_a = jnp.asarray(rng.normal(-1, 0.5, (64, 40)))
        ll_b = ll_a + 1.0
        state = [ll_a]

        def fn(i):
            return state[0][i]

        r_a = pl.loo_streaming(fn, 64, 40, chunk_size=32)
        state[0] = ll_b  # mutate captured-by-reference state
        r_stale = pl.loo_streaming(fn, 64, 40, chunk_size=32)
        # documented behavior: identity-keyed cache serves the stale program
        assert_allclose(r_stale["elpd_loo"], r_a["elpd_loo"], rtol=1e-12)
        pl.clear_streaming_cache(fn)
        r_fresh = pl.loo_streaming(fn, 64, 40, chunk_size=32)
        assert abs(r_fresh["elpd_loo"] - r_a["elpd_loo"]) > 1.0

    def test_dropped_callable_releases_cache_entry(self):
        import gc

        from pyloo_tpu.streaming import _GEN_CACHE

        ll = jnp.asarray(np.random.default_rng(4).normal(-1, 0.5, (32, 24)))

        def fn(i):
            return ll[i]

        pl.loo_streaming(fn, 32, 24, chunk_size=16)
        assert fn in _GEN_CACHE
        n_before = len(_GEN_CACHE)
        del fn
        gc.collect()
        assert len(_GEN_CACHE) < n_before

    def test_clear_all(self):
        ll = jnp.asarray(np.random.default_rng(5).normal(-1, 0.5, (32, 24)))

        def fn(i):
            return ll[i]

        pl.loo_streaming(fn, 32, 24, chunk_size=16)
        pl.clear_streaming_cache()
        from pyloo_tpu.streaming import _GEN_CACHE

        assert fn not in _GEN_CACHE


class TestCheckpointResume:
    """Preemption-safe streaming (SURVEY §5 checkpoint/resume)."""

    def _data(self, seed=9, n=96, s=50):
        ll = jnp.asarray(np.random.default_rng(seed).normal(-1, 0.6, (n, s)))
        return ll, n, s

    def test_resume_matches_clean_run(self, tmp_path):
        ll, n, s = self._data()
        fn = lambda i: ll[i]
        clean = pl.loo_streaming(fn, n, s, chunk_size=16, pointwise=True)

        ckpt = str(tmp_path / "stream.ckpt.npz")

        class Preempt(Exception):
            pass

        def die_at_4(c, n_chunks):
            if c == 4:
                raise Preempt()

        with pytest.raises(Preempt):
            pl.loo_streaming(
                fn, n, s, chunk_size=16, pointwise=True,
                checkpoint_path=ckpt, checkpoint_every=2, on_chunk=die_at_4,
            )
        import os

        assert os.path.exists(ckpt)  # saved at chunk 4 before the "preemption"

        resumed = pl.loo_streaming(
            fn, n, s, chunk_size=16, pointwise=True,
            checkpoint_path=ckpt, checkpoint_every=2,
        )
        assert_allclose(resumed["elpd_loo"], clean["elpd_loo"], rtol=1e-14)
        assert_allclose(resumed["se"], clean["se"], rtol=1e-12)
        assert_allclose(
            resumed.loo_i.values, clean.loo_i.values, rtol=1e-14
        )
        assert_allclose(
            resumed.pareto_k.values, clean.pareto_k.values, rtol=1e-12
        )
        assert not os.path.exists(ckpt)  # removed on completion

    def test_geometry_mismatch_rejected(self, tmp_path):
        ll, n, s = self._data()
        fn = lambda i: ll[i]
        ckpt = str(tmp_path / "stream.ckpt.npz")

        def die_at_2(c, n_chunks):
            if c == 2:
                raise RuntimeError("stop")

        with pytest.raises(RuntimeError):
            pl.loo_streaming(
                fn, n, s, chunk_size=16,
                checkpoint_path=ckpt, checkpoint_every=1, on_chunk=die_at_2,
            )
        with pytest.raises(ValueError, match="was written for"):
            pl.loo_streaming(
                fn, n, s, chunk_size=32, checkpoint_path=ckpt
            )

    def test_progress_hook(self):
        ll, n, s = self._data()
        seen = []
        pl.loo_streaming(
            lambda i: ll[i], n, s, chunk_size=16,
            on_chunk=lambda c, total: seen.append((c, total)),
        )
        assert seen == [(i + 1, 6) for i in range(6)]


class TestELooStreaming:
    """e_loo_streaming == e_loo on materialized data (chunked, ragged)."""

    B, S = 57, 400  # 57 forces a ragged final chunk at chunk_size 16

    def _data(self):
        rng = np.random.default_rng(23)
        ll = rng.normal(-1.0, 0.7, size=(self.B, self.S))
        x = rng.normal(2.0, 1.5, size=(self.B, self.S))
        llj, xj = jnp.asarray(ll), jnp.asarray(x)
        return ll, x, (lambda i: llj[i]), (lambda i: xj[i])

    def _expected(self, ll, x, kind, probs=None):
        from pyloo_tpu.containers import DataArray

        lw, _ = pl.psislw(-ll)
        return pl.e_loo(
            DataArray(x, ("obs", "__sample__")),
            log_weights=DataArray(np.asarray(lw), ("obs", "__sample__")),
            log_ratios=DataArray(-ll, ("obs", "__sample__")),
            type=kind,
            probs=probs,
        )

    @pytest.mark.parametrize("kind", ["mean", "variance", "sd"])
    def test_matches_e_loo(self, kind):
        ll, x, ll_fn, x_fn = self._data()
        got = pl.e_loo_streaming(
            ll_fn, x_fn, self.B, self.S, type=kind, chunk_size=16,
            dtype=jnp.float64,
        )
        exp = self._expected(ll, x, kind)
        assert_allclose(got.value.values, np.asarray(exp.value.values),
                        rtol=1e-9)
        assert_allclose(got.pareto_k.values, np.asarray(exp.pareto_k.values),
                        rtol=1e-9)
        assert_allclose(got.min_ss.values, np.asarray(exp.min_ss.values),
                        rtol=1e-9)
        assert_allclose(got.khat_threshold.values,
                        np.asarray(exp.khat_threshold.values), rtol=1e-12)
        assert_allclose(got.convergence_rate.values,
                        np.asarray(exp.convergence_rate.values), rtol=1e-9)

    def test_quantile_matches_e_loo(self):
        ll, x, ll_fn, x_fn = self._data()
        probs = [0.1, 0.5, 0.9]
        got = pl.e_loo_streaming(
            ll_fn, x_fn, self.B, self.S, type="quantile", probs=probs,
            chunk_size=16, dtype=jnp.float64,
        )
        exp = self._expected(ll, x, "quantile", probs=probs)
        assert got.value.values.shape == (self.B, 3)
        assert_allclose(got.value.values, np.asarray(exp.value.values),
                        rtol=1e-9)
        assert_allclose(got.pareto_k.values, np.asarray(exp.pareto_k.values),
                        rtol=1e-9)

    def test_single_chunk_equals_chunked(self):
        ll, x, ll_fn, x_fn = self._data()
        a = pl.e_loo_streaming(ll_fn, x_fn, self.B, self.S, chunk_size=16,
                               dtype=jnp.float64)
        b = pl.e_loo_streaming(ll_fn, x_fn, self.B, self.S,
                               chunk_size=self.B, dtype=jnp.float64)
        assert_allclose(a.value.values, b.value.values, rtol=1e-12)
        assert_allclose(a.pareto_k.values, b.pareto_k.values, rtol=1e-12)

    def test_validation(self):
        ll, x, ll_fn, x_fn = self._data()
        with pytest.raises(ValueError, match="type must be"):
            pl.e_loo_streaming(ll_fn, x_fn, self.B, self.S, type="median")
        with pytest.raises(ValueError, match="probs must be provided"):
            pl.e_loo_streaming(ll_fn, x_fn, self.B, self.S, type="quantile")
        with pytest.raises(ValueError, match="between 0 and 1"):
            pl.e_loo_streaming(ll_fn, x_fn, self.B, self.S, type="quantile",
                               probs=[0.5, 1.5])
        with pytest.raises(ValueError, match="only valid for"):
            pl.e_loo_streaming(ll_fn, x_fn, self.B, self.S, type="mean",
                               probs=[0.5])
        with pytest.raises(ValueError, match="at least 2 draws"):
            pl.e_loo_streaming(ll_fn, x_fn, self.B, 1)

    def test_progress_hook_and_mesh(self):
        from pyloo_tpu.parallel import obs_mesh

        ll, x, ll_fn, x_fn = self._data()
        seen = []
        with obs_mesh() as mesh:
            got = pl.e_loo_streaming(
                ll_fn, x_fn, self.B, self.S, chunk_size=16, mesh=mesh,
                dtype=jnp.float64,
                on_chunk=lambda c, t: seen.append((c, t)),
            )
        exp = self._expected(ll, x, "mean")
        assert_allclose(got.value.values, np.asarray(exp.value.values),
                        rtol=1e-9)
        assert seen and seen[-1][0] == seen[-1][1]


class TestWaicStreaming:
    """waic_streaming == waic() on materialized data."""

    def _waic_reference(self, ll, **kw):
        idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pl.waic(idata, **kw)

    @pytest.mark.parametrize("chunk", [16, 103])
    def test_matches_waic(self, ll_matrix, chunk):
        ll_dev = jnp.asarray(ll_matrix)
        res = pl.waic_streaming(
            _fn(ll_dev), N_OBS, N_DRAWS, chunk_size=chunk, dtype=jnp.float64
        )
        ref = self._waic_reference(ll_matrix)
        for key in ("elpd_waic", "se", "p_waic"):
            assert_allclose(res[key], ref[key], rtol=1e-9, err_msg=key)
        assert res["n_samples"] == N_DRAWS
        assert res["n_data_points"] == N_OBS
        assert res["scale"] == ref["scale"]

    def test_pointwise_and_scale(self, ll_matrix):
        ll_dev = jnp.asarray(ll_matrix)
        res = pl.waic_streaming(
            _fn(ll_dev), N_OBS, N_DRAWS, chunk_size=32, pointwise=True,
            scale="deviance", dtype=jnp.float64,
        )
        ref = self._waic_reference(ll_matrix, pointwise=True, scale="deviance")
        assert_allclose(res["waic_i"].values,
                        np.asarray(ref["waic_i"].values).ravel(), rtol=1e-9)
        assert_allclose(res["elpd_waic"], ref["elpd_waic"], rtol=1e-9)

    def test_high_variance_warns(self, rng_module):
        n, s = 24, 200
        ll = rng_module.normal(0.0, 2.0, size=(n, s))  # var >> 0.4
        ll_dev = jnp.asarray(ll)
        with pytest.warns(UserWarning, match="exceeds 0.4"):
            res = pl.waic_streaming(
                _fn(ll_dev), n, s, chunk_size=8, dtype=jnp.float64
            )
        assert res["warning"]

    def test_validation(self):
        with pytest.raises(ValueError, match="at least 2 draws"):
            pl.waic_streaming(lambda i: None, 10, 1)
        with pytest.raises(ValueError, match="n_obs must be positive"):
            pl.waic_streaming(lambda i: None, 0, 10)


class TestPredictiveMetricStreaming:
    """loo_predictive_metric_streaming == loo_predictive_metric."""

    def _setup(self, binary=False):
        rng = np.random.default_rng(31)
        B, S = 61, 300
        ll = rng.normal(-1.0, 0.6, size=(B, S))
        if binary:
            x = rng.uniform(0, 1, size=(B, S))
            y = (rng.uniform(size=B) < 0.5).astype(float)
        else:
            x = rng.normal(1.0, 2.0, size=(B, S))
            y = rng.normal(1.0, 2.0, size=B)
        return B, S, ll, x, y

    @pytest.mark.parametrize("metric", ["mae", "mse", "rmse"])
    def test_matches_in_memory(self, metric):
        B, S, ll, x, y = self._setup()
        idata = pl.from_dict(
            log_likelihood={"obs": ll.T[None]},
            posterior_predictive={"obs": x.T[None]},
        )
        ref = pl.loo_predictive_metric(idata, y, metric=metric)
        llj, xj = jnp.asarray(ll), jnp.asarray(x)
        got = pl.loo_predictive_metric_streaming(
            lambda i: llj[i], lambda i: xj[i], y, B, S, metric=metric,
            chunk_size=16, dtype=jnp.float64,
        )
        assert_allclose(got["estimate"], ref["estimate"], rtol=1e-9)
        assert_allclose(got["se"], ref["se"], rtol=1e-9)

    @pytest.mark.parametrize("metric", ["acc", "balanced_acc"])
    def test_binary_metrics(self, metric):
        B, S, ll, x, y = self._setup(binary=True)
        idata = pl.from_dict(
            log_likelihood={"obs": ll.T[None]},
            posterior_predictive={"obs": x.T[None]},
        )
        ref = pl.loo_predictive_metric(idata, y, metric=metric)
        llj, xj = jnp.asarray(ll), jnp.asarray(x)
        got = pl.loo_predictive_metric_streaming(
            lambda i: llj[i], lambda i: xj[i], y, B, S, metric=metric,
            chunk_size=16, dtype=jnp.float64,
        )
        assert_allclose(got["estimate"], ref["estimate"], rtol=1e-9)
        assert_allclose(got["se"], ref["se"], rtol=1e-9)

    def test_validation(self):
        with pytest.raises(ValueError, match="must match n_obs"):
            pl.loo_predictive_metric_streaming(
                lambda i: None, lambda i: None, np.zeros(5), 10, 100
            )
        with pytest.raises(ValueError, match="Invalid metric"):
            pl.loo_predictive_metric_streaming(
                lambda i: None, lambda i: None, np.zeros(10), 10, 100,
                metric="mape",
            )


class TestLogoStreaming:
    """loo_group_streaming == loo_group() on materialized data."""

    def _setup(self):
        rng = np.random.default_rng(41)
        B, S, G = 97, 300, 11  # ragged chunks at 16; uneven group sizes
        ll = rng.normal(-1.0, 0.5, size=(B, S))
        gids = rng.integers(0, G, size=B)
        return B, S, ll, gids

    def _logo_reference(self, ll, gids, **kw):
        idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pl.loo_group(idata, gids, reff=1.0, **kw)

    @pytest.mark.parametrize("chunk", [16, 97])
    def test_matches_loo_group(self, chunk):
        B, S, ll, gids = self._setup()
        llj = jnp.asarray(ll)
        res = pl.loo_group_streaming(
            _fn(llj), gids, B, S, chunk_size=chunk, dtype=jnp.float64,
            pointwise=True,
        )
        ref = self._logo_reference(ll, gids, pointwise=True)
        for key in ("elpd_logo", "se", "p_logo", "p_logo_se", "logoic"):
            assert_allclose(res[key], ref[key], rtol=1e-9, err_msg=key)
        assert_allclose(res["logo_i"].values, ref["logo_i"].values, rtol=1e-9)
        assert_allclose(res["pareto_k"], ref["pareto_k"], rtol=1e-9)
        assert res["n_groups"] == ref["n_groups"]

    def test_string_group_labels(self):
        B, S, ll, gids = self._setup()
        labels = np.array(["g%02d" % g for g in gids])
        llj = jnp.asarray(ll)
        res = pl.loo_group_streaming(
            _fn(llj), labels, B, S, chunk_size=32, dtype=jnp.float64,
            pointwise=True,
        )
        ref = self._logo_reference(ll, labels, pointwise=True)
        assert_allclose(res["elpd_logo"], ref["elpd_logo"], rtol=1e-9)
        assert list(res["logo_i"].coords["group"]) == list(
            ref["logo_i"].coords["group"]
        )

    def test_mesh_sharded(self):
        from pyloo_tpu.parallel import obs_mesh

        B, S, ll, gids = self._setup()
        llj = jnp.asarray(ll)
        with obs_mesh() as mesh:
            res = pl.loo_group_streaming(
                _fn(llj), gids, B, S, chunk_size=16, mesh=mesh,
                dtype=jnp.float64,
            )
        ref = self._logo_reference(ll, gids)
        assert_allclose(res["elpd_logo"], ref["elpd_logo"], rtol=1e-9)

    def test_sis_warns(self):
        B, S, ll, gids = self._setup()
        llj = jnp.asarray(ll)
        with pytest.warns(UserWarning, match="PSIS is the recommended"):
            pl.loo_group_streaming(
                _fn(llj), gids, B, S, method="sis", dtype=jnp.float64
            )

    def test_validation(self):
        with pytest.raises(ValueError, match="must match the number"):
            pl.loo_group_streaming(lambda i: None, np.zeros(5), 10, 100)
        with pytest.raises(ValueError, match="Invalid method"):
            pl.loo_group_streaming(
                lambda i: None, np.zeros(10), 10, 100, method="tjs"
            )


class TestLooScoreStreaming:
    """loo_score_streaming == loo_score at the same seed."""

    def _setup(self):
        rng = np.random.default_rng(51)
        B, S = 53, 240
        ll = rng.normal(-1.0, 0.5, size=(B, S))
        x = rng.normal(0.5, 1.2, size=(B, S))
        x2 = rng.normal(0.5, 1.2, size=(B, S))
        y = rng.normal(0.5, 1.2, size=B)
        return B, S, ll, x, x2, y

    def _reference(self, ll, x, x2, y, **kw):
        idata = pl.from_dict(
            log_likelihood={"obs": ll.T[None]},
            posterior_predictive={"obs": x.T[None], "obs2": x2.T[None]},
            observed_data={"obs": y},
            dims={"obs": ["obs_id"], "obs2": ["obs_id"]},
        )
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pl.loo_score(
                idata, x_var="obs", x2_var="obs2", pointwise=True,
                reff=1.0, **kw,
            )

    @pytest.mark.parametrize("scale,perms", [(False, 1), (True, 1), (False, 3)])
    def test_matches_loo_score(self, scale, perms):
        B, S, ll, x, x2, y = self._setup()
        ref = self._reference(ll, x, x2, y, scale=scale, permutations=perms,
                              seed=7)
        llj, xj, x2j = jnp.asarray(ll), jnp.asarray(x), jnp.asarray(x2)
        got = pl.loo_score_streaming(
            lambda i: llj[i], lambda i: xj[i], lambda i: x2j[i], y, B, S,
            scale=scale, permutations=perms, seed=7, chunk_size=16,
            dtype=jnp.float64,
        )
        assert_allclose(got.pointwise, ref.pointwise, rtol=1e-9)
        assert_allclose(got.estimates["Estimate"], ref.estimates["Estimate"],
                        rtol=1e-9)
        assert_allclose(got.estimates["SE"], ref.estimates["SE"], rtol=1e-9)
        assert_allclose(got.pareto_k,
                        np.asarray(ref.pareto_k.values
                                   if hasattr(ref.pareto_k, "values")
                                   else ref.pareto_k).ravel(), rtol=1e-9)

    def test_validation(self):
        f = lambda i: None
        with pytest.raises(ValueError, match="must match n_obs"):
            pl.loo_score_streaming(f, f, f, np.zeros(4), 10, 100)
        with pytest.raises(ValueError, match="permutations must be"):
            pl.loo_score_streaming(f, f, f, np.zeros(10), 10, 100,
                                   permutations=0)


class TestLooCompareStreaming:
    """loo_compare_streaming == loo_compare over materialized matrices."""

    def _setup(self):
        rng = np.random.default_rng(83)
        B, S = 61, 220
        ll_a = rng.normal(-1.0, 0.5, size=(B, S))
        ll_b = ll_a + rng.normal(-0.05, 0.15, size=(B, S))
        return B, S, ll_a, ll_b

    def _reference_compare(self, named_lls, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            elpds = {
                name: _loo_reference(ll, pointwise=True)
                for name, ll in named_lls.items()
            }
            return pl.loo_compare(elpds, **kw)

    @pytest.mark.parametrize("method", ["stacking", "bb-pseudo-bma",
                                        "pseudo-bma"])
    def test_matches_loo_compare(self, method):
        B, S, ll_a, ll_b = self._setup()
        ref = self._reference_compare(
            {"a": ll_a, "b": ll_b}, method=method, seed=3
        )
        aj, bj = jnp.asarray(ll_a), jnp.asarray(ll_b)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = pl.loo_compare_streaming(
                {"a": lambda i: aj[i], "b": lambda i: bj[i]}, B, S,
                method=method, seed=3, chunk_size=16, dtype=jnp.float64,
            )
        assert list(got.index) == list(ref.index)
        for col in ("rank", "elpd_loo", "p_loo", "elpd_diff", "weight",
                    "se", "dse"):
            assert_allclose(
                got[col].to_numpy(dtype=float),
                ref[col].to_numpy(dtype=float),
                rtol=1e-7, atol=1e-12, err_msg=col,
            )

    def test_mixed_precomputed_entries(self):
        B, S, ll_a, ll_b = self._setup()
        precomputed = _loo_reference(ll_a, pointwise=True)
        bj = jnp.asarray(ll_b)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = pl.loo_compare_streaming(
                {"a": precomputed, "b": lambda i: bj[i]}, B, S,
                chunk_size=32, dtype=jnp.float64,
            )
            ref = self._reference_compare({"a": ll_a, "b": ll_b})
        assert_allclose(got["elpd_loo"].to_numpy(dtype=float),
                        ref["elpd_loo"].to_numpy(dtype=float), rtol=1e-9)
        assert_allclose(got["dse"].to_numpy(dtype=float),
                        ref["dse"].to_numpy(dtype=float), rtol=1e-7)

    def test_progress_hook_names_models(self):
        B, S, ll_a, ll_b = self._setup()
        aj, bj = jnp.asarray(ll_a), jnp.asarray(ll_b)
        seen = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pl.loo_compare_streaming(
                {"a": lambda i: aj[i], "b": lambda i: bj[i]}, B, S,
                chunk_size=32, dtype=jnp.float64,
                on_chunk=lambda name, c, n: seen.append((name, c, n)),
            )
        assert {name for name, _, _ in seen} == {"a", "b"}
        assert all(n == 2 for _, _, n in seen)

    def test_validation(self):
        f = lambda i: None
        with pytest.raises(TypeError, match="must be a dictionary"):
            pl.loo_compare_streaming([f, f], 10, 100)
        with pytest.raises(ValueError, match="at least two models"):
            pl.loo_compare_streaming({"a": f}, 10, 100)
        B, S, ll_a, _ = self._setup()
        pre = _loo_reference(ll_a, pointwise=True)
        with pytest.raises(ValueError, match="observations; expected"):
            pl.loo_compare_streaming({"a": pre, "b": f}, B + 1, S)


class TestLooApproximatePosteriorStreaming:
    """Streamed approximate-posterior LOO == in-memory path at equal seed."""

    def _setup(self):
        rng = np.random.default_rng(29)
        B, S = 57, 260
        ll = rng.normal(-1.1, 0.5, size=(B, S))
        log_q = rng.normal(-3.0, 0.7, size=S)
        log_p = log_q + rng.normal(0.0, 0.3, size=S)
        return B, S, ll, log_p, log_q

    def _reference(self, ll, log_p, log_q, **kw):
        idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pl.loo_approximate_posterior(
                idata, log_p, log_q, reff=1.0, **kw
            )

    @pytest.mark.parametrize("resample_method", ["psis", "psir", "sis"])
    def test_matches_in_memory(self, resample_method):
        B, S, ll, log_p, log_q = self._setup()
        ref = self._reference(
            ll, log_p, log_q, pointwise=True,
            resample_method=resample_method, seed=17,
        )
        llj = jnp.asarray(ll)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = pl.loo_approximate_posterior_streaming(
                lambda i: llj[i], log_p, log_q, B, S, pointwise=True,
                resample_method=resample_method, seed=17, chunk_size=16,
                dtype=jnp.float64,
            )
        for key in ("elpd_loo", "se", "p_loo", "looic"):
            assert_allclose(got[key], ref[key], rtol=1e-9, err_msg=key)
        assert_allclose(got.loo_i.values, ref.loo_i.values.ravel(),
                        rtol=1e-9)
        assert_allclose(got.pareto_k.values, ref.pareto_k.values.ravel(),
                        rtol=1e-7)
        assert got.approximate_posterior["log_p"] is not None

    def test_non_psis_method_warns(self):
        B, S, ll, log_p, log_q = self._setup()
        llj = jnp.asarray(ll)
        with pytest.warns(UserWarning, match="recommended method"):
            pl.loo_approximate_posterior_streaming(
                lambda i: llj[i], log_p, log_q, B, S, method="sis",
                seed=3, chunk_size=32, dtype=jnp.float64,
            )

    def test_validation(self):
        f = lambda i: None
        with pytest.raises(ValueError, match="same length"):
            pl.loo_approximate_posterior_streaming(
                f, np.zeros(5), np.zeros(6), 10, 5
            )
        with pytest.raises(ValueError, match="must match n_draws"):
            pl.loo_approximate_posterior_streaming(
                f, np.zeros(5), np.zeros(5), 10, 100
            )


class TestMixtureStreaming:
    """loo_streaming(mixture=True) == loo(mixture=True): the normalizer is a
    pure obs-axis logsumexp, so Mix-IS-LOO streams in one pass."""

    def _setup(self):
        rng = np.random.default_rng(67)
        B, S = 71, 190
        return B, S, rng.normal(-0.9, 0.6, size=(B, S))

    @pytest.mark.parametrize("chunk", [16, 48, 200])
    def test_matches_loo_mixture(self, chunk):
        B, S, ll = self._setup()
        idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = pl.loo(idata, reff=1.0, mixture=True, pointwise=True)
        llj = jnp.asarray(ll)
        with pytest.warns(UserWarning, match="mixture of"):
            got = pl.loo_streaming(
                lambda i: llj[i], B, S, mixture=True, pointwise=True,
                chunk_size=chunk, dtype=jnp.float64,
            )
        assert list(got.index) == list(ref.index)
        assert_allclose(got["elpd_loo"], ref["elpd_loo"], rtol=1e-9)
        # pointwise mixture elpds are constant by construction (reference
        # loo.py:274-275: log_obs_weights == 0 identically), so the ref se
        # is pure rounding noise — compare absolutely
        assert_allclose(got["se"], ref["se"], atol=1e-10)
        assert_allclose(got.loo_i.values, ref.loo_i.values.ravel(),
                        rtol=1e-9)
        assert np.all(got.pareto_k.values == 0.0)
        assert "p_loo" not in got.index and "looic" not in got.index

    def test_summary_only(self):
        B, S, ll = self._setup()
        llj = jnp.asarray(ll)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = pl.loo_streaming(
                lambda i: llj[i], B, S, mixture=True, chunk_size=32,
                dtype=jnp.float64,
            )
            idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
            ref = pl.loo(idata, reff=1.0, mixture=True)
        assert_allclose(got["elpd_loo"], ref["elpd_loo"], rtol=1e-9)
        assert got["n_data_points"] == B


class TestJacobianStreaming:
    """loo_streaming(jacobian_fn=...) == loo(jacobian=...)."""

    def _setup(self):
        rng = np.random.default_rng(41)
        B, S = 59, 210
        ll = rng.normal(-1.0, 0.5, size=(B, S))
        jac = rng.normal(0.0, 0.3, size=B)
        return B, S, ll, jac

    @pytest.mark.parametrize("scale", ["log", "deviance"])
    def test_matches_loo_jacobian(self, scale):
        B, S, ll, jac = self._setup()
        idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = pl.loo(idata, reff=1.0, pointwise=True, jacobian=jac,
                         scale=scale)
        llj, jj = jnp.asarray(ll), jnp.asarray(jac)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = pl.loo_streaming(
                lambda i: llj[i], B, S, pointwise=True, chunk_size=16,
                jacobian_fn=lambda i: jj[i], scale=scale,
                dtype=jnp.float64,
            )
        for key in ("elpd_loo", "se", "p_loo", "p_loo_se", "looic",
                    "looic_se"):
            assert_allclose(got[key], ref[key], rtol=1e-9, err_msg=key)
        assert_allclose(got.loo_i.values, ref.loo_i.values.ravel(),
                        rtol=1e-9)

    def test_mixture_jacobian(self):
        B, S, ll, jac = self._setup()
        idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = pl.loo(idata, reff=1.0, pointwise=True, mixture=True,
                         jacobian=jac)
        llj, jj = jnp.asarray(ll), jnp.asarray(jac)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = pl.loo_streaming(
                lambda i: llj[i], B, S, pointwise=True, mixture=True,
                chunk_size=24, jacobian_fn=lambda i: jj[i],
                dtype=jnp.float64,
            )
        assert_allclose(got["elpd_loo"], ref["elpd_loo"], rtol=1e-9)
        assert_allclose(got["se"], ref["se"], rtol=1e-7)
        assert_allclose(got.loo_i.values, ref.loo_i.values.ravel(),
                        rtol=1e-9)


class TestUpdateStreamedSubsample:
    """update_subsample() re-dispatches streamed results through the
    generator interface, reusing the stored (n_obs,) approximation."""

    def test_update_matches_direct_call(self):
        rng = np.random.default_rng(59)
        n, s = 1500, 300
        ll = rng.normal(-1.0, 0.5, size=(n, s))
        ll_dev = jnp.asarray(ll)
        fn = lambda i: ll_dev[i]
        idx0 = np.arange(0, n, 7)
        idx1 = np.arange(0, n, 3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            first = pl.loo_subsample_streaming(
                fn, n, s, observations=idx0, dtype=jnp.float64,
                pointwise=True,
            )
            updated = pl.update_subsample(first, observations=idx1)
            direct = pl.loo_subsample_streaming(
                fn, n, s, observations=idx1, dtype=jnp.float64,
                pointwise=True,
            )
        for key in ("elpd_loo", "se", "subsampling_SE", "p_loo", "looic"):
            assert_allclose(updated[key], direct[key], rtol=1e-12,
                            err_msg=key)
        assert updated["subsample_size"] == len(idx1)
        assert "loo_i" in updated.index

    def test_update_larger_random_subsample(self):
        rng = np.random.default_rng(61)
        n, s = 900, 250
        ll = rng.normal(-1.0, 0.5, size=(n, s))
        ll_dev = jnp.asarray(ll)
        fn = lambda i: ll_dev[i]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            first = pl.loo_subsample_streaming(
                fn, n, s, observations=100, seed=1, dtype=jnp.float64,
            )
            updated = pl.update_subsample(first, observations=400, seed=2)
        assert updated["subsample_size"] == 400
        # bigger subsample -> smaller subsampling SE (typical draw)
        assert updated["subsampling_SE"] < first["subsampling_SE"] * 2
        assert np.isfinite(updated["elpd_loo"])


class TestMixtureCheckpointResume:
    """The mixture carry (running-logsumexp normalizer) survives
    checkpoint/resume, and a mixture checkpoint cannot resume a
    non-mixture run."""

    def test_mixture_resume_matches_clean(self, tmp_path):
        import os

        ll = jnp.asarray(
            np.random.default_rng(9).normal(-1, 0.6, (96, 50))
        )
        fn = lambda i: ll[i]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            clean = pl.loo_streaming(
                fn, 96, 50, chunk_size=16, pointwise=True, mixture=True,
                dtype=jnp.float64,
            )
        ckpt = str(tmp_path / "mix.ckpt.npz")

        class Preempt(Exception):
            pass

        def die_at_4(c, n_chunks):
            if c == 4:
                raise Preempt()

        with pytest.raises(Preempt), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pl.loo_streaming(
                fn, 96, 50, chunk_size=16, pointwise=True, mixture=True,
                dtype=jnp.float64, checkpoint_path=ckpt,
                checkpoint_every=2, on_chunk=die_at_4,
            )
        assert os.path.exists(ckpt)
        # a mixture checkpoint must not resume a non-mixture run
        with pytest.raises(ValueError, match="was written for"), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pl.loo_streaming(
                fn, 96, 50, chunk_size=16, pointwise=True,
                dtype=jnp.float64, checkpoint_path=ckpt,
            )
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            resumed = pl.loo_streaming(
                fn, 96, 50, chunk_size=16, pointwise=True, mixture=True,
                dtype=jnp.float64, checkpoint_path=ckpt,
                checkpoint_every=2,
            )
        assert_allclose(resumed["elpd_loo"], clean["elpd_loo"], rtol=1e-14)
        assert_allclose(resumed.loo_i.values, clean.loo_i.values,
                        rtol=1e-14)
        assert not os.path.exists(ckpt)


class TestCompareStreamingWaic:
    """loo_compare_streaming(ic='waic') == loo_compare over waic()."""

    def test_matches_waic_compare(self):
        rng = np.random.default_rng(97)
        B, S = 49, 180
        ll_a = rng.normal(-1.0, 0.5, size=(B, S))
        ll_b = ll_a + rng.normal(-0.05, 0.15, size=(B, S))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            elpds = {}
            for name, ll in (("a", ll_a), ("b", ll_b)):
                idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
                elpds[name] = pl.waic(idata, pointwise=True)
            ref = pl.loo_compare(elpds, ic="waic", seed=5)
        aj, bj = jnp.asarray(ll_a), jnp.asarray(ll_b)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = pl.loo_compare_streaming(
                {"a": lambda i: aj[i], "b": lambda i: bj[i]}, B, S,
                ic="waic", seed=5, chunk_size=16, dtype=jnp.float64,
            )
        assert list(got.index) == list(ref.index)
        for col in ("elpd_waic", "p_waic", "elpd_diff", "weight", "se",
                    "dse"):
            assert_allclose(got[col].to_numpy(dtype=float),
                            ref[col].to_numpy(dtype=float),
                            rtol=1e-7, atol=1e-12, err_msg=col)

    def test_bad_ic_rejected(self):
        f = lambda i: None
        with pytest.raises(ValueError, match="ic must be"):
            pl.loo_compare_streaming({"a": f, "b": f}, 10, 100, ic="kfold")


class TestReviewFixes:
    """Regression tests for the round-3 self-review findings."""

    def test_old_checkpoint_missing_key_gives_value_error(self, tmp_path):
        import os

        ll = jnp.asarray(np.random.default_rng(1).normal(-1, 0.5, (64, 40)))
        fn = lambda i: ll[i]
        ckpt = str(tmp_path / "old.ckpt.npz")

        def die_at_2(c, n):
            if c == 2:
                raise RuntimeError("stop")

        with pytest.raises(RuntimeError):
            pl.loo_streaming(fn, 64, 40, chunk_size=16, checkpoint_path=ckpt,
                             checkpoint_every=1, on_chunk=die_at_2,
                             dtype=jnp.float64)
        # simulate a file written by an older version: strip a geometry key
        with np.load(ckpt) as z:
            payload = {k: z[k] for k in z.files if k != "geom_mixture"}
        np.savez(ckpt, **payload)
        with pytest.raises(ValueError, match="no recorded mixture"):
            pl.loo_streaming(fn, 64, 40, chunk_size=16,
                             checkpoint_path=ckpt, dtype=jnp.float64)
        os.remove(ckpt)

    def test_checkpoint_format_version_stamped_and_checked(self, tmp_path):
        import os

        from pyloo_tpu.streaming import CHECKPOINT_FORMAT_VERSION

        ll = jnp.asarray(np.random.default_rng(7).normal(-1, 0.5, (64, 40)))
        fn = lambda i: ll[i]
        ckpt = str(tmp_path / "ver.ckpt.npz")

        def die_at_2(c, n):
            if c == 2:
                raise RuntimeError("stop")

        with pytest.raises(RuntimeError):
            pl.loo_streaming(fn, 64, 40, chunk_size=16, checkpoint_path=ckpt,
                             checkpoint_every=1, on_chunk=die_at_2,
                             dtype=jnp.float64)
        with np.load(ckpt) as z:
            assert int(z["format_version"]) == CHECKPOINT_FORMAT_VERSION
            payload = {k: z[k] for k in z.files}

        # a version-0 file (no stamp, same layout) still resumes
        np.savez(ckpt, **{k: v for k, v in payload.items()
                          if k != "format_version"})
        res_v0 = pl.loo_streaming(fn, 64, 40, chunk_size=16,
                                  checkpoint_path=ckpt, dtype=jnp.float64)
        ref = pl.loo_streaming(fn, 64, 40, chunk_size=16, dtype=jnp.float64)
        assert_allclose(res_v0["elpd_loo"], ref["elpd_loo"], rtol=1e-12)

        # a future version is rejected with the upgrade remedy
        payload["format_version"] = np.asarray(CHECKPOINT_FORMAT_VERSION + 1)
        np.savez(ckpt, **payload)
        with pytest.raises(ValueError, match="newer"):
            pl.loo_streaming(fn, 64, 40, chunk_size=16,
                             checkpoint_path=ckpt, dtype=jnp.float64)
        os.remove(ckpt)

    def test_approx_streaming_keeps_generator_cache_warm(self):
        from pyloo_tpu.streaming import _GEN_CACHE

        ll = jnp.asarray(np.random.default_rng(2).normal(-1, 0.5, (48, 60)))
        fn = lambda i: ll[i]
        rng = np.random.default_rng(3)
        log_q = rng.normal(-2, 0.5, size=60)
        log_p = log_q + rng.normal(0, 0.2, size=60)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pl.loo_approximate_posterior_streaming(
                fn, log_p, log_q, 48, 60, seed=5, chunk_size=16,
                dtype=jnp.float64,
            )
        # the ORIGINAL callable is the memoization key (the draw gather is
        # applied post-generator), so repeated calls stay warm
        assert fn in _GEN_CACHE

    def test_approx_streaming_checkpoint_requires_seed(self, tmp_path):
        fn = lambda i: None
        with pytest.raises(ValueError, match="requires an explicit seed"):
            pl.loo_approximate_posterior_streaming(
                fn, np.zeros(10), np.zeros(10), 20, 10,
                checkpoint_path=str(tmp_path / "x.npz"),
            )

    def test_approx_streaming_resume_rejects_different_resample(
        self, tmp_path
    ):
        ll = jnp.asarray(np.random.default_rng(4).normal(-1, 0.5, (64, 50)))
        fn = lambda i: ll[i]
        rng = np.random.default_rng(5)
        log_q = rng.normal(-2, 0.5, size=50)
        log_p = log_q + rng.normal(0, 0.2, size=50)
        ckpt = str(tmp_path / "ap.ckpt.npz")

        def die_at_2(c, n):
            if c == 2:
                raise RuntimeError("stop")

        with pytest.raises(RuntimeError), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pl.loo_approximate_posterior_streaming(
                fn, log_p, log_q, 64, 50, seed=7, chunk_size=16,
                checkpoint_path=ckpt, checkpoint_every=1, on_chunk=die_at_2,
                dtype=jnp.float64,
            )
        with pytest.raises(ValueError, match="colgather"), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pl.loo_approximate_posterior_streaming(
                fn, log_p, log_q, 64, 50, seed=8, chunk_size=16,
                checkpoint_path=ckpt, dtype=jnp.float64,
            )

    def test_mixture_jacobian_row_layout_matches_loo(self):
        rng = np.random.default_rng(6)
        B, S = 40, 80
        ll = rng.normal(-1.0, 0.5, size=(B, S))
        jac = rng.normal(0, 0.2, size=B)
        idata = pl.from_dict(log_likelihood={"obs": ll.T[None]})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = pl.loo(idata, reff=1.0, pointwise=True, mixture=True,
                         jacobian=jac)
            llj, jj = jnp.asarray(ll), jnp.asarray(jac)
            got = pl.loo_streaming(
                lambda i: llj[i], B, S, pointwise=True, mixture=True,
                jacobian_fn=lambda i: jj[i], chunk_size=16,
                dtype=jnp.float64,
            )
        assert list(got.index) == list(ref.index)
        for key in ("p_loo", "p_loo_se", "looic", "looic_se"):
            assert_allclose(got[key], ref[key], rtol=1e-9, err_msg=key)


class TestFloat32StreamingParity:
    """The float32 streaming path (chunked generator + fast PSIS kernel)
    against in-memory ``pl.loo`` at float32 precision on the same rows:
    same kernel, so per-row values agree to float32 rounding whatever the
    chunking, ragged last chunk included."""

    @pytest.mark.parametrize(
        "b,s,chunk", [(200, 600, 128), (203, 4000, 64), (64, 2500, 64)]
    )
    def test_streaming_matches_in_memory(self, rng_module, b, s, chunk):
        ll = rng_module.normal(-1.0, 0.9, size=(b, s))
        ll[5] = -np.abs(rng_module.standard_t(2, size=s)) * 3  # heavy tail
        ll32 = ll.astype(np.float32)
        ll_dev = jnp.asarray(ll32)
        res = pl.loo_streaming(
            lambda i: ll_dev[i], b, s, chunk_size=chunk,
            dtype=jnp.float32, pointwise=True,
        )
        saved = pl.rcParams["device.precision"]
        pl.rcParams["device.precision"] = "float32"
        try:
            ref = _loo_reference(ll32.astype(np.float64), pointwise=True)
        finally:
            pl.rcParams["device.precision"] = saved
        assert_allclose(
            np.asarray(res.loo_i.values),
            np.asarray(ref.loo_i.values),
            rtol=1e-6,
            atol=1e-6,
        )
        assert_allclose(
            np.asarray(res.pareto_k.values),
            np.asarray(ref.pareto_k.values),
            rtol=0,
            atol=1e-5,
        )
        for key in ("elpd_loo", "p_loo", "se"):
            assert_allclose(res[key], ref[key], rtol=1e-6, err_msg=key)


class TestResolveChunk:
    """Default chunk sizing splits the sweep evenly (no ragged padded tail)."""

    def test_even_split_at_budget(self):
        from pyloo_tpu.streaming import _resolve_chunk

        c, n = _resolve_chunk(None, 1_000_000, 4000, jnp.dtype(jnp.float32), None)
        assert (c, n) == (125_000, 8)  # 8 x 2 GB, zero padding
        # padding never exceeds the rounding multiple
        for n_obs in (103, 999, 1_048_576, 7):
            c, n = _resolve_chunk(None, n_obs, 500, jnp.dtype(jnp.float64), None)
            assert n * c - n_obs < 8
            assert c * 500 * 8 <= (2 << 30) + 8 * 500 * 8

    def test_explicit_size_unchanged(self):
        from pyloo_tpu.streaming import _resolve_chunk

        c, n = _resolve_chunk(100, 1000, 50, jnp.dtype(jnp.float64), None)
        assert (c, n) == (96, 11)  # historical round-down semantics

    def test_mesh_multiple(self):
        from jax.sharding import Mesh

        from pyloo_tpu.streaming import _resolve_chunk

        devs = np.asarray(jax.devices()[:8])
        mesh = Mesh(devs, ("obs",))
        c, n = _resolve_chunk(None, 1000, 100, jnp.dtype(jnp.float64), mesh)
        assert c % 8 == 0
        assert n * c - 1000 < 8


class TestGeneratorConstantHoisting:
    """Cold-start guard: the chunk generator's HLO must NOT carry
    closure-captured data arrays as literal constants (a 1M x 32 design
    matrix baked in makes a ~126 MB module that dominates first-call
    compile)."""

    def _make_fn(self, n_obs, n_draws, n_feat=16):
        rng = np.random.default_rng(0)
        xw = jnp.asarray(rng.normal(size=(n_obs, n_feat)).astype(np.float32))
        beta = jnp.asarray(
            rng.normal(size=(n_draws, n_feat)).astype(np.float32)
        )

        def log_lik_fn(idx):
            return xw[idx] @ beta.T

        return log_lik_fn, xw, beta

    def test_hlo_stays_small(self):
        from pyloo_tpu.streaming import _gen_program

        n_obs, n_draws, chunk = 50_000, 64, 1000
        fn, xw, beta = self._make_fn(n_obs, n_draws)
        data_bytes = xw.nbytes + beta.nbytes  # ~3.2 MB
        gen = _gen_program(fn, chunk, n_obs, "float32", None)
        lowered = gen.program.lower(jnp.asarray(0, jnp.int32), gen.consts)
        proto = lowered.compiler_ir("hlo").as_serialized_hlo_module_proto()
        # the arrays must be parameters, not baked constants: the module
        # must be orders of magnitude smaller than the data it consumes
        assert len(proto) < data_bytes / 10, (
            f"HLO module is {len(proto)} bytes for {data_bytes} bytes of"
            " closure data — constants are being baked again"
        )
        assert len(gen.consts) == 2  # both arrays hoisted

    def test_hoisted_generator_matches_direct_eval(self):
        from pyloo_tpu.streaming import _gen_program, clear_streaming_cache

        n_obs, n_draws, chunk = 2048, 32, 256
        fn, _, _ = self._make_fn(n_obs, n_draws)
        clear_streaming_cache(fn)
        gen = _gen_program(fn, chunk, n_obs, "float32", None)
        got = np.asarray(gen(jnp.asarray(3, jnp.int32)))
        want = np.asarray(fn(jnp.arange(3 * chunk, 4 * chunk)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
