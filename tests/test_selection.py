"""Exactness of the segmented top-k cascade against lax.top_k."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from pyloo_tpu.ops.selection import topk_vals_desc


@pytest.mark.parametrize(
    "shape,k",
    [
        ((7, 4000), 191),   # bench shape: G=4 cascade
        ((5, 4001), 191),   # ragged: needs -inf padding
        ((3, 2500), 100),   # non-multiple of segment width
        ((4, 1999), 191),   # below cascade threshold -> single stage
        ((2, 300), 40),     # small
        ((2, 64), 64),      # k == s -> full sort
        ((6, 8192), 499),   # wide, k just under segment/2
    ],
)
def test_matches_lax_topk(rng, shape, k):
    x = jnp.asarray(rng.normal(size=shape), jnp.float32)
    got = topk_vals_desc(x, k)
    want, _ = jax.lax.top_k(x, k)
    assert got.shape == (*shape[:-1], k)
    assert_allclose(np.asarray(got), np.asarray(want), rtol=0)


def test_ties_and_infs(rng):
    # duplicated values and -inf entries: the value multiset must match
    x = np.full((3, 4000), -np.inf, dtype=np.float32)
    x[0, :50] = 1.0  # fewer finite values than k
    x[1] = rng.integers(0, 5, size=4000)  # heavy ties
    x[2] = rng.normal(size=4000)
    got = np.asarray(topk_vals_desc(jnp.asarray(x), 191))
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 191)[0])
    assert_allclose(got, want, rtol=0)


def test_float64_path(rng):
    x = jnp.asarray(rng.normal(size=(4, 4000)), jnp.float64)
    got = topk_vals_desc(x, 191)
    want, _ = jax.lax.top_k(x, 191)
    assert got.dtype == jnp.float64
    assert_allclose(np.asarray(got), np.asarray(want), rtol=0)


def test_fast_kernel_unchanged_by_cascade(rng):
    # the fast LOO kernel must produce identical scores with the cascade
    # selection as with single-stage selection (exactness end-to-end)
    from pyloo_tpu.ops import tail_length
    from pyloo_tpu.ops.loo_kernels import loo_scores_psis, loo_scores_psis_fast

    ll = jnp.asarray(rng.normal(-1, 0.7, size=(64, 4000)), jnp.float32)
    m = tail_length(4000, 1.0)
    e_fast, k_fast, l_fast, _dg = loo_scores_psis_fast(ll, m)
    e_ref, k_ref, l_ref = loo_scores_psis(ll.astype(jnp.float64), m)
    assert_allclose(np.asarray(e_fast), np.asarray(e_ref), rtol=2e-4)
    assert_allclose(np.asarray(k_fast), np.asarray(k_ref), atol=2e-3)


def test_degenerate_gpd_fit_stays_finite():
    # Logistic-model chunk that historically produced a row whose GPD fit
    # cancels to b ~ 0 in float32 (sigma = -k/b becomes 0/0 noise).  The fit
    # must take the exponential limit (k=0, sigma=mean(z)) and the fast
    # kernel must stay finite and close to the exact float64 path.
    import jax

    from pyloo_tpu.ops import tail_length
    from pyloo_tpu.ops.loo_kernels import loo_scores_psis, loo_scores_psis_fast

    key = jax.random.PRNGKey(0)
    kb, kx = jax.random.split(key)
    beta = 0.05 * jax.random.normal(
        jax.random.fold_in(kb, 1), (400, 50), jnp.float32
    )
    kc = jax.random.fold_in(kx, 0)
    X = jax.random.normal(kc, (65536, 50), jnp.float32)
    y = jax.random.uniform(jax.random.fold_in(kc, 1), (65536, 1)) < 0.5
    logits = X @ beta.T
    ll = jnp.where(
        y, jax.nn.log_sigmoid(logits), jax.nn.log_sigmoid(-logits)
    )
    m = tail_length(400, 1.0)
    e, k, _, _dg = loo_scores_psis_fast(ll, m)
    assert bool(jnp.all(jnp.isfinite(e))), "fast kernel produced non-finite elpd"

    # spot-check parity on a subsample against the exact float64 kernel
    sub = ll[::512].astype(jnp.float64)
    e64, _, _ = loo_scores_psis(sub, m)
    assert_allclose(
        np.asarray(e[::512], np.float64), np.asarray(e64), rtol=2e-3
    )


def _prepass_oracle(ll, k):
    """NumPy float64 oracle of ``_fast_prepass``'s full-row quantities."""
    x_raw = -np.asarray(ll, np.float64)
    c = x_raw.max(axis=1)
    x = x_raw - c[:, None]
    vals = -np.sort(-x, axis=1)[:, :k]
    xc = np.maximum(vals[:, k - 1], np.log(np.finfo(np.float64).tiny))
    mask = x <= xc[:, None]
    m1 = np.max(np.where(mask, x, -np.inf), axis=1)
    m1 = np.where(np.isfinite(m1), m1, 0.0)
    with np.errstate(divide="ignore", over="ignore"):
        ntl = m1 + np.log(
            np.sum(np.where(mask, np.exp(x - m1[:, None]), 0.0), axis=1)
        )
    lmax = (-x_raw).max(axis=1)
    lppd = (
        lmax + np.log(np.exp(-x_raw - lmax[:, None]).sum(axis=1))
        - np.log(x_raw.shape[1])
    )
    return vals, c, xc, ntl, lppd


class TestFastPrepass:
    """The float32 fast path's selection and full-row reductions
    (``loo_kernels._fast_prepass``): exact top-k, row max, non-tail mass and
    lppd logsumexp against a float64 oracle."""

    @staticmethod
    def _heavy(rng, b, s):
        ll = rng.normal(-1, 0.8, size=(b, s))
        ll[min(3, b - 1)] = -np.abs(rng.standard_t(2, size=s)) * 3
        return ll

    @staticmethod
    def _cauchy_and_constant(rng, b, s):
        ll = rng.normal(-1, 0.8, size=(b, s))
        ll[0] = -np.abs(rng.standard_cauchy(size=s)) * 5  # heavy tail
        ll[1] = -2.0  # constant row
        return ll

    @pytest.mark.parametrize(
        "make,b,s,k",
        [
            ("heavy", 16, 2000, 192),
            ("normal", 9, 2000, 191),
            ("normal", 9, 4097, 100),  # ragged cascade segments
            pytest.param("normal", 9, 8000, 270, marks=pytest.mark.slow),
            ("cauchy_const", 8, 2000, 192),
            pytest.param("heavy", 4, 65_536, 769, marks=pytest.mark.slow),
        ],
    )
    def test_prepass_matches_oracle(self, rng, make, b, s, k):
        from pyloo_tpu.ops.loo_kernels import _fast_prepass

        if make == "heavy":
            ll = self._heavy(rng, b, s)
        elif make == "cauchy_const":
            ll = self._cauchy_and_constant(rng, b, s)
        else:
            ll = rng.normal(-1, 0.8, size=(b, s))
        ll32 = np.asarray(ll, np.float32)
        vals, c1, xc, log_ntl, lppd = jax.jit(
            _fast_prepass, static_argnums=1
        )(jnp.asarray(ll32), k)
        w_vals, w_c, w_xc, w_ntl, w_lppd = _prepass_oracle(ll32, k)
        assert vals.shape == (b, k) and vals.dtype == jnp.float32
        # the max and the selected values are exact: x - C is one f32
        # rounding of the same operands in both
        assert_allclose(np.asarray(c1), w_c, rtol=0)
        w_vals32 = (-ll32 - (-ll32).max(axis=1)[:, None])
        w_vals32 = -np.sort(-w_vals32, axis=1)[:, :k]
        _assert_same_vals(vals, w_vals32)
        assert_allclose(np.asarray(xc), w_xc, rtol=1e-6, atol=1e-6)
        assert_allclose(np.asarray(log_ntl), w_ntl, rtol=2e-6, atol=2e-6)
        assert_allclose(np.asarray(lppd), w_lppd, rtol=2e-6, atol=2e-6)


class TestXlaSelectionEnvelope:
    """Property battery for ``topk_vals_desc`` across row widths and k:
    single-stage and cascade selection, ragged segment padding, k at the
    boundaries {1, 255, 256, 257, 512}, ties, infinities and ragged
    batches."""

    @pytest.mark.parametrize(
        "s,k",
        [
            (200, 1),       # trivial k
            (256, 191),
            (300, 255),
            (512, 256),
            (2000, 191),    # cascade threshold, single stage
            (4096, 256),    # cascade, 4 exact segments
            (4097, 100),    # cascade, ragged last segment
            pytest.param(8000, 270, marks=pytest.mark.slow),
            pytest.param(8192, 512, marks=pytest.mark.slow),
            pytest.param(16000, 191, marks=pytest.mark.slow),
            pytest.param(16384, 257, marks=pytest.mark.slow),
            (513, 512),     # k one short of the width
        ],
    )
    def test_random_shapes(self, rng, s, k):
        x = jnp.asarray(rng.normal(size=(9, s)), jnp.float32)  # ragged B
        got = topk_vals_desc(x, k)
        _assert_same_vals(got, _topk_want(x, k))

    @pytest.mark.parametrize(
        "s,k,stages",
        [
            (64, 64, 0),          # k == s: one full sort
            (1999, 191, 1),       # below the cascade width
            (4000, 192, 2),       # default PSIS tail at 4000 draws
            (8000, 270, 2),
            (16384, 256, 2),
            (32768, 512, 2),
            (65536, 769, 2),      # segment width scales with k
            (65536, 1024, 2),
            (4000, 1025, 1),      # k too large for two segments
            (100_000, 950, 2),
        ],
    )
    def test_cascade_plan(self, s, k, stages):
        """Which selection ``topk_vals_desc`` traces for (S, k): the number
        of ``approx_max_k`` stages, or a full sort when k == S."""
        jaxpr = jax.make_jaxpr(lambda x: topk_vals_desc(x, k))(
            jax.ShapeDtypeStruct((4, s), jnp.float32)
        )
        text = str(jaxpr)  # nested jits print inline
        assert text.count("approx_top_k[") == stages
        assert ("sort[" in text) == (stages == 0)
        assert jaxpr.out_avals[0].shape == (4, k)

    @pytest.mark.parametrize("s", [1000, 4000])
    def test_ties_crossing_segment_boundaries(self, rng, s):
        # tie runs spanning segment boundaries (the cascade's 1000-wide
        # segments at s=4000) and a full-row tie
        x = np.full((8, s), -1.0, np.float32)
        for start in range(200, s, 1000):
            x[:, start:start + 100] = 2.0
        x[:, s // 2:s // 2 + 20] = 3.0
        x[:, s - 240:s - 220] = 2.0
        x[:, 960:1040] = 1.5  # across the first 1000-wide segment edge
        x += rng.normal(size=x.shape).astype(np.float32) * 1e-3
        x[2, :] = 5.0
        xj = jnp.asarray(x)
        _assert_same_vals(topk_vals_desc(xj, 256), _topk_want(xj, 256))

    @pytest.mark.parametrize("s", [2000, 4000])
    def test_inf_and_allequal_rows(self, rng, s):
        x = np.asarray(rng.normal(size=(10, s)), np.float32)
        x[0, :] = -np.inf
        x[1, :100] = np.inf
        x[2, :] = 0.0
        x[3, ::2] = -np.inf            # alternating -inf
        x[4, :3] = np.float32(3.4e38)  # near f32 max
        x[5, :] = 0.25                 # full-row tie
        xj = jnp.asarray(x)
        _assert_same_vals(topk_vals_desc(xj, 191), _topk_want(xj, 191))

    @pytest.mark.parametrize("b", [1, 2, 7, 32, 33])
    def test_ragged_batch(self, rng, b):
        x = jnp.asarray(rng.normal(size=(b, 4001)), jnp.float32)
        _assert_same_vals(topk_vals_desc(x, 200), _topk_want(x, 200))


class TestTopkWithIdx:
    """Index-tracking cascade: values exact, indices point at those values."""

    @pytest.mark.parametrize(
        "shape,k",
        [
            ((7, 4000), 256),
            ((5, 4001), 191),
            ((3, 2500), 100),
            ((2, 300), 40),  # below cascade threshold -> lax.top_k
        ],
    )
    def test_values_and_index_consistency(self, rng, shape, k):
        from pyloo_tpu.ops.selection import topk_with_idx

        x = jnp.asarray(rng.normal(size=shape), jnp.float32)
        vals, idx = topk_with_idx(x, k)
        want, _ = jax.lax.top_k(x, k)
        assert_allclose(np.asarray(vals), np.asarray(want), rtol=0)
        gathered = jnp.take_along_axis(x, idx, axis=-1)
        assert_allclose(np.asarray(gathered), np.asarray(vals), rtol=0)
        # indices must be distinct per row
        for row in np.asarray(idx):
            assert len(set(row.tolist())) == k


class TestHybridF64:
    """Exact f64 top-k via f32-proxy selection + certificate."""

    @pytest.mark.parametrize("s", [1000, 4000, 4001])
    def test_random_exact_and_certified(self, rng, s):
        from pyloo_tpu.ops.selection import topk_hybrid_f64

        x = jnp.asarray(rng.normal(size=(16, s)))
        vals, ok = topk_hybrid_f64(x, 191)
        want, _ = jax.lax.top_k(x, 191)
        assert bool(jnp.all(ok))
        assert_allclose(np.asarray(vals), np.asarray(want), rtol=0)

    def test_sub_f32_resolution_spread_is_exact(self, rng):
        """f64-distinct values inside one f32 ulp, away from the boundary."""
        from pyloo_tpu.ops.selection import topk_hybrid_f64

        x = rng.normal(size=(4, 2000))
        # top block far above everything, mutually within 1e-12
        x[:, :50] = 10.0 + rng.uniform(0, 1e-12, size=(4, 50))
        x = jnp.asarray(x)
        vals, ok = topk_hybrid_f64(x, 100)
        want, _ = jax.lax.top_k(x, 100)
        assert bool(jnp.all(ok))
        assert_allclose(np.asarray(vals), np.asarray(want), rtol=0)

    def test_constant_rows_certified(self):
        from pyloo_tpu.ops.selection import topk_hybrid_f64

        x = jnp.zeros((3, 2000), jnp.float64)
        vals, ok = topk_hybrid_f64(x, 100)
        assert bool(jnp.all(ok))
        assert_allclose(np.asarray(vals), 0.0, rtol=0)

    def test_adversarial_boundary_tie_flagged(self, rng):
        """> PAD f64-distinct values in one f32 tie class AT the boundary:
        the certificate must refuse (ok=False) rather than silently err."""
        from pyloo_tpu.ops.selection import topk_hybrid_f64

        x = np.asarray(rng.normal(size=(2, 2000)) - 10.0)
        # 400 values all rounding to f32(1.0), f64-distinct, straddling the
        # k=100 boundary
        x[0, :400] = 1.0 + rng.uniform(0, 1e-9, size=400)
        x = jnp.asarray(x)
        vals, ok = topk_hybrid_f64(x, 100)
        ok = np.asarray(ok)
        assert not ok[0]
        assert ok[1]

    def test_exact_kernel_falls_back_on_adversarial_rows(self, rng):
        """End-to-end: loo_scores_psis stays exact when the certificate
        fails, via the full-width f64 fallback branch."""
        import warnings as _w

        from pyloo_tpu.ops import tail_length
        from pyloo_tpu.ops.loo_kernels import loo_scores_psis
        from pyloo_tpu.ops.psis import psislw_batch
        from pyloo_tpu.ops.lse import logsumexp

        ll = np.asarray(rng.normal(-1, 0.6, size=(8, 2000)))
        ll[0, :400] = -1.0 - rng.uniform(0, 1e-9, size=400)
        m = tail_length(2000, 1.0)
        llj = jnp.asarray(ll)
        e, k, l = loo_scores_psis(llj, m)
        lw, k_ref = psislw_batch(-llj, m)
        e_ref = logsumexp(lw + llj, axis=1)
        assert_allclose(np.asarray(e), np.asarray(e_ref), rtol=1e-11, atol=1e-12)
        assert_allclose(np.asarray(k), np.asarray(k_ref), rtol=1e-11)

    def test_minus_inf_rows(self, rng):
        from pyloo_tpu.ops.selection import topk_hybrid_f64

        x = np.full((2, 2000), -np.inf)
        x[0, :30] = rng.normal(size=30)
        x = jnp.asarray(x)
        vals, ok = topk_hybrid_f64(x, 100)
        want, _ = jax.lax.top_k(x, 100)
        got, expect = np.asarray(vals), np.asarray(want)
        assert_allclose(got[np.asarray(ok)], expect[np.asarray(ok)], rtol=0)


def _topk_want(x, k):
    """lax.top_k values with -inf/NaN-tolerant comparison helper."""
    want = jax.lax.top_k(x, k)[0]
    return np.asarray(want)


def _assert_same_vals(got, want):
    got, want = np.asarray(got), np.asarray(want)
    both_nan = np.isnan(got) & np.isnan(want)
    both_ninf = np.isneginf(got) & np.isneginf(want)
    eq = (got == want) | both_nan | both_ninf
    assert eq.all(), f"mismatch at {np.argwhere(~eq)[:5]}"


class TestLargeSEnvelope:
    """S > 32768 regime: the k-adaptive exact cascade."""

    @pytest.mark.slow
    def test_topk_wide_large_k(self, rng):
        x = jnp.asarray(rng.normal(size=(3, 34_000)), jnp.float32)
        _assert_same_vals(topk_vals_desc(x, 600), _topk_want(x, 600))

    def test_cascade_adapts_to_large_k(self, rng):
        # k = 769 with fixed 1000-wide segments used to degrade to a
        # full-width single-stage sort; the width now scales with k and the
        # result stays exact
        x = jnp.asarray(rng.normal(size=(6, 70_000)), jnp.float32)
        got = topk_vals_desc(x, 769)
        _assert_same_vals(got, _topk_want(x, 769))
