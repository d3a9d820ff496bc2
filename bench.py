"""Benchmark: PSIS throughput at 4000 draws (the BASELINE.json north star).

Runs the fused PSIS-LOO scoring kernel (tail selection, GPD fit, inverse-CDF
smoothing, weighted elpd/lppd reductions) over 1M observations x 4000 draws
in float32 and prints one JSON line.  It runs only on a GPU, and the line
records the device (platform, ``device_kind``, count) and the card's name
and power limit as nvidia-smi reports them.

The baseline is the reference's per-observation NumPy loop (argsort +
Zhang-Stephens fit per row, /root/reference/pyloo/psis.py:114-160), ~1e4
rows/sec on one CPU core (SURVEY.md §6 cost model).

Run:  python bench.py            (from the repository root, on a GPU)
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from chip_smoke import gpu_identity, require_gpu  # noqa: E402
from pyloo_tpu.ops import tail_length  # noqa: E402
from pyloo_tpu.ops.loo_kernels import loo_scores_psis_fast  # noqa: E402

N_DRAWS = 4000
TOTAL_OBS = 1_000_000
CHUNK = 125_000  # 125k x 4000 f32 = 2 GB per input chunk
N_RESIDENT = 2  # device-resident base chunks (4 GB)
REFERENCE_OBS_PER_SEC = 1.0e4  # SURVEY.md §6: 1e3-1e4 rows/s; generous end


def bench_streaming_api(dev):
    """End-to-end public API at 1M x 4000: loo_streaming over a synthetic
    on-device logistic-regression posterior (the product path, not the
    kernel)."""
    from pyloo_tpu.streaming import loo_streaming

    n_feat = 32
    key = jax.random.PRNGKey(7)
    beta = 0.3 * jax.random.normal(key, (N_DRAWS, n_feat), jnp.float32)
    kx, ky = jax.random.split(key)
    xw = jax.random.normal(kx, (TOTAL_OBS, n_feat), jnp.float32) * 0.5
    yw = (jax.random.uniform(ky, (TOTAL_OBS,)) < 0.5).astype(jnp.float32)
    _ = float(beta[0, 0]) + float(xw[0, 0])  # materialize

    def log_lik_fn(idx):
        x = xw[idx]  # (chunk, n_feat)
        # full-precision product: float32 inputs would otherwise run in TF32
        eta = jnp.dot(x, beta.T, precision=jax.lax.Precision.HIGHEST)
        y = yw[idx][:, None]
        return y * eta - jnp.logaddexp(0.0, eta)

    # chunk_size divides TOTAL_OBS exactly (five 200k-row chunks)
    kw = dict(dtype=jnp.float32, chunk_size=200_000)
    # Cold-start protocol: pl.warmup() AOT-compiles the heavy chunk-step
    # programs at startup (the documented production pattern), so the
    # "cold" first real call pays only the user-generator compile.
    import pyloo_tpu as pl

    t0 = time.perf_counter()
    pl.warmup(TOTAL_OBS, N_DRAWS, **kw)
    warmup_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = loo_streaming(log_lik_fn, TOTAL_OBS, N_DRAWS, **kw)
    cold_wall = time.perf_counter() - t0
    # headline: best of 2 warm calls
    wall = float("inf")
    for _rep in range(2):
        t0 = time.perf_counter()
        r = loo_streaming(log_lik_fn, TOTAL_OBS, N_DRAWS, **kw)
        wall = min(wall, time.perf_counter() - t0)
    return wall, cold_wall, warmup_wall, float(r["elpd_loo"])


def bench_draw_sweep():
    """Fast-kernel throughput across draw counts: S=1000/2000, 8000 draws
    = 4 chains x 2000, 16000, 32768/65536 (tail k > 512, where the cascade's
    segment width scales with k) and 100000."""
    sweep = {}
    for s in (1000, 2000, 8000, 16000, 32768, 65536, 100_000):
        rows = max(1024, min(CHUNK, (CHUNK * N_DRAWS) // s))
        m = tail_length(s, 1.0)
        x = 1.5 * jax.random.normal(
            jax.random.PRNGKey(s), (rows, s), dtype=jnp.float32
        )
        _ = float(x[0, 0])

        @jax.jit
        def smooth_s(chunk, salt):
            e, k, l, _d = loo_scores_psis_fast(-(chunk + salt), m)
            return jnp.sum(e)

        _ = float(smooth_s(x, jnp.float32(0.0)))
        t0 = time.perf_counter()
        acc = jnp.zeros((), jnp.float32)
        for i in range(4):
            acc = acc + smooth_s(x, jnp.float32(i) * jnp.float32(1e-6))
        _ = float(acc)
        dt = (time.perf_counter() - t0) / 4
        _stage(f"draw sweep S={s}: {rows / dt:.0f} obs/s")
        sweep[f"S={s}"] = {
            "rows": rows,
            "tail": m + 1,
            "obs_per_sec": round(rows / dt, 1),
        }
        del x
    return sweep


from functools import partial as _partial  # noqa: E402


@_partial(jax.jit, static_argnums=(2,))
def _smooth_k_summary(chunk, salt, m):
    """Scored chunk -> (sum elpd, sum finite k, count finite k)."""
    e, k, l, _d = loo_scores_psis_fast(-(chunk + salt), m)
    fin = jnp.isfinite(k)
    return jnp.sum(e), jnp.sum(jnp.where(fin, k, 0.0)), jnp.sum(fin)


def bench_heavy_tail():
    """Smoothing-heavy regime with CONTROLLED tail index.

    Log-weights are exact GPD(sigma=1, xi=k) variates — ``w = (e^{kT}-1)/k``
    with ``T ~ Exp(1)``, computed in log space — so the PSIS tail
    exceedances are GPD with the SAME k (threshold stability), every row is
    continuous (no degenerate ties), and k-hat must land near k.  Each
    regime ASSERTS its own honesty: >=95% of rows take the full
    GPD-fit + inverse-CDF path and mean finite k-hat sits within 0.15 of
    the target (the CPU-validated estimator band at tail~=223).  Reference
    behavior being matched: /root/reference/pyloo/psis.py:139-158."""
    rows, s = CHUNK, N_DRAWS
    m = tail_length(s, 1.0)
    out = {}
    for k_true in (0.7, 1.0, 1.5):
        key = jax.random.PRNGKey(int(k_true * 10))
        t = jax.random.exponential(key, (rows, s), jnp.float32)
        kt = jnp.float32(k_true) * t
        x = kt + jnp.log1p(-jnp.exp(-kt)) - jnp.log(jnp.float32(k_true))
        _ = float(x[0, 0])

        e0, k0, n0 = _smooth_k_summary(x, jnp.float32(0.0), m)
        _ = float(e0 + k0 + n0)
        # best of 2 timed reps
        dt = float("inf")
        for rep in range(2):
            t0 = time.perf_counter()
            acc = jnp.zeros((), jnp.float32)
            ksum = jnp.zeros((), jnp.float32)
            nfin = jnp.zeros((), jnp.float32)
            for i in range(4):
                e, kv, nf = _smooth_k_summary(
                    x, jnp.float32(4 * rep + i) * jnp.float32(1e-6), m
                )
                acc, ksum, nfin = acc + e, ksum + kv, nfin + nf
            _ = float(acc)
            dt = min(dt, (time.perf_counter() - t0) / 4)
        n_fin = float(nfin)
        mean_k = float(ksum) / max(n_fin, 1.0)
        frac_nonfinite = 1.0 - n_fin / (4 * rows)
        honest = bool(frac_nonfinite < 0.05 and abs(mean_k - k_true) < 0.15)
        if not honest:
            _stage(
                f"heavy tail k={k_true}: DISHONEST measurement"
                f" (mean_khat={mean_k:.3f}, frac_nonfinite="
                f"{frac_nonfinite:.4f}) — regime missed its target band"
            )
        out[f"k={k_true}"] = {
            "rows": rows,
            "n_draws": s,
            "target_khat": k_true,
            "mean_finite_khat": round(mean_k, 4),
            "frac_k_nonfinite": round(frac_nonfinite, 4),
            "obs_per_sec": round(rows / dt, 1),
            "measures_smoothing_path": honest,
        }
        del x, t, kt
    return out


def bench_exact_f64(base):
    """Exact float64 PSIS path (selection + scatter parity kernel).

    Residents are cast to f64 once outside the timed region; the salt
    perturbs only the first 64 rows via ``dynamic_update_slice``, so every
    timed call sees distinct inputs without an f64 arithmetic pass.
    """
    from jax import lax

    from pyloo_tpu.ops.loo_kernels import loo_scores_psis

    m_tail = tail_length(N_DRAWS, 1.0)
    half = CHUNK // 2  # 2 GB f64 chunks
    base64 = [c[:half].astype(jnp.float64) for c in base]
    _ = [float(c[0, 0]) for c in base64]  # materialize outside the timing

    @jax.jit
    def smooth64(chunk, salt):
        salted = lax.dynamic_update_slice(chunk, chunk[:64] + salt, (0, 0))
        e, k, l = loo_scores_psis(-salted, m_tail)
        return jnp.sum(e)

    _ = float(smooth64(base64[0], jnp.float64(0.0)))  # compile
    n_iters = TOTAL_OBS // half
    # best of 2 reps with distinct salts
    dt = float("inf")
    for rep in range(2):
        t0 = time.perf_counter()
        acc = jnp.zeros((), jnp.float64)
        for i in range(n_iters):
            acc = acc + smooth64(
                base64[i % N_RESIDENT],
                jnp.float64(rep * n_iters + i + 1) * 1e-6,
            )
        _ = float(acc)
        dt = min(dt, time.perf_counter() - t0)
    del base64
    return dt


def bench_nonfactor():
    """Non-factorized MVN LOO at scale.

    The reference is O(N * N^2) per draw per observation
    (/root/reference/pyloo/loo_nonfactor.py:519-522) — ~hours at N=2048.
    This path is the batched Cholesky + rank-1 kernel
    (pyloo_tpu/ops/nonfactor.py): one factorization + triangular solve per
    draw, vmapped over the draw axis.  N=2048 observations, S=32 draws of a
    dense (N, N) covariance (f64: ~1 GB per (S, N, N) tensor).
    """
    from pyloo_tpu.ops.nonfactor import mvn_conditional_loglik
    from pyloo_tpu.ops.loo_kernels import loo_scores_psis_fast as _fast

    n, s_draws = 2048, 32
    key = jax.random.PRNGKey(5)
    k1, k2, k3 = jax.random.split(key, 3)
    # well-conditioned SPD covariances: A A^T / n + 2 I, jittered per draw
    a = jax.random.normal(k1, (s_draws, n, 64), jnp.float32)
    cov = (
        jnp.einsum(
            "sik,sjk->sij", a, a, precision=jax.lax.Precision.HIGHEST
        ) / 64
        + 2.0 * jnp.eye(n, dtype=jnp.float32)[None]
    )
    mu = 0.1 * jax.random.normal(k2, (s_draws, n), jnp.float32)
    y = jnp.asarray(jax.random.normal(k3, (n,), jnp.float32))
    _ = float(cov[0, 0, 0]) + float(mu[0, 0]) + float(y[0])

    m_tail = tail_length(s_draws, 1.0)

    @jax.jit
    def nonfactor_loo(y_, mu_, cov_):
        ll = mvn_conditional_loglik(y_, mu_, cov=cov_)  # (S, N)
        e, k, l, _d = _fast(-ll.T.astype(jnp.float32), m_tail)
        return jnp.sum(e), jnp.max(k)

    e0, k0 = nonfactor_loo(y, mu, cov)
    _ = float(e0 + k0)  # compile + warm
    t0 = time.perf_counter()
    acc = jnp.zeros((), jnp.float32)
    for i in range(4):
        acc = acc + nonfactor_loo(y + jnp.float32(i) * 1e-6, mu, cov)[0]
    _ = float(acc)
    dt = (time.perf_counter() - t0) / 4
    try:
        stats = jax.devices()[0].memory_stats() or {}
        peak_hbm_gb = round(stats.get("peak_bytes_in_use", 0) / 2**30, 2)
    except Exception:
        peak_hbm_gb = None
    del a, cov, mu
    return {
        "n_obs": n,
        "n_draws": s_draws,
        "wall_s_per_call": round(dt, 3),
        "obs_per_sec": round(n / dt, 1),
        "peak_hbm_gb": peak_hbm_gb,
        "elpd_sum": round(float(e0), 1),
        "note": (
            "batched-Cholesky MVN conditional LOO; reference per-draw loop"
            " is O(N*N^2) per draw (loo_nonfactor.py:519-522)"
        ),
    }


def _stage(msg):
    """Stage progress on stderr (stdout is reserved for the JSON line) so a
    timeout leaves a record of where the time went."""
    print(f"[bench +{time.perf_counter() - _T_START:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


_T_START = time.perf_counter()


def _sanitize(obj):
    """Strict-JSON guard: json.dumps would emit bare Infinity/NaN literals
    (invalid JSON) for non-finite floats; stringify them instead."""
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, float) and (obj != obj or obj in (float("inf"), float("-inf"))):
        return str(obj)
    return obj

def main():
    device = require_gpu()
    card = gpu_identity()
    dev = jax.devices()[0]
    _stage(f"backend up: {dev} ({card})")
    m_tail = tail_length(N_DRAWS, 1.0)
    n_chunks = TOTAL_OBS // CHUNK

    base = [
        1.5
        * jax.random.normal(
            jax.random.PRNGKey(i), (CHUNK, N_DRAWS), dtype=jnp.float32
        )
        for i in range(N_RESIDENT)
    ]
    jax.block_until_ready(base)

    @jax.jit
    def smooth(chunk, salt):
        elpd_i, k, lppd_i, _degen = loo_scores_psis_fast(-(chunk + salt), m_tail)
        return jnp.sum(elpd_i), jnp.sum(k), jnp.sum(lppd_i)

    zero = jnp.zeros((), jnp.float32)
    _stage("f32 kernel: compiling")
    e, k, l = smooth(base[0], zero)  # compile + warm
    _ = float(e + k + l)

    # best of 2 reps with distinct salts
    wall = float("inf")
    for rep in range(2):
        t0 = time.perf_counter()
        acc = jnp.zeros((), jnp.float32)
        ksum = jnp.zeros((), jnp.float32)
        for i in range(n_chunks):
            salt = jnp.float32(rep * n_chunks + i) * jnp.float32(1e-6)
            e, kv, l = smooth(base[i % N_RESIDENT], salt)
            acc = acc + e
            ksum = ksum + kv
        total = float(acc)  # single d2h fetch synchronizes everything
        wall = min(wall, time.perf_counter() - t0)
    mean_khat = float(ksum) / TOTAL_OBS
    obs_per_sec = TOTAL_OBS / wall

    _stage(f"f32 salted loop done ({wall:.2f}s); streaming API bench")
    api_wall, api_cold_wall, api_warmup_wall, api_elpd = bench_streaming_api(dev)
    _stage(
        f"streaming API done (warm {api_wall:.2f}s cold {api_cold_wall:.2f}s"
        f" warmup {api_warmup_wall:.2f}s); f64 bench"
    )
    f64_wall = bench_exact_f64(base)
    del base
    _stage(f"f64 done ({f64_wall:.2f}s); draw sweep")
    draw_sweep = bench_draw_sweep()
    _stage("draw sweep done; heavy tail")
    heavy_tail = bench_heavy_tail()
    _stage("heavy tail done; nonfactor MVN")
    nonfactor = bench_nonfactor()
    _stage("nonfactor done")

    # Headline = the public API path (loo_streaming): log-likelihood
    # evaluation + PSIS scoring + reductions for 1M x 4000 on one card, the
    # WARM call (compile excluded, chunk-generator program memoized).  The
    # salted kernel loop (detail) times the score kernel alone.
    result = {
        "metric": "loo_1m_x_4k_draws_obs_per_sec",
        "value": round(TOTAL_OBS / api_wall, 1),
        "unit": "obs/s",
        "vs_baseline": round(TOTAL_OBS / api_wall / REFERENCE_OBS_PER_SEC, 2),
        "device": dict(device, nvidia_smi=card),
        "detail": {
            "total_obs": TOTAL_OBS,
            "n_draws": N_DRAWS,
            "api_loo_streaming_wall_s": round(api_wall, 3),
            "api_loo_streaming_cold_wall_s": round(api_cold_wall, 3),
            "api_warmup_wall_s": round(api_warmup_wall, 3),
            "api_loo_streaming_elpd": round(api_elpd, 1),
            "metric_note": (
                "headline is the warm 2nd loo_streaming call (generator"
                " memoized); pl.warmup() precompiles the chunk programs"
                " (api_warmup_wall_s), so cold_wall is first-call latency"
                " after warmup (generator compile only)"
            ),
            "dtype": "float32",
            "kernel_salted_loop_obs_per_sec": round(obs_per_sec, 1),
            "kernel_salted_loop_wall_s": round(wall, 3),
            "mean_khat": round(mean_khat, 4),
            "exact_f64_wall_s": round(f64_wall, 3),
            "exact_f64_obs_per_sec": round(TOTAL_OBS / f64_wall, 1),
            "fast_kernel_draw_sweep": draw_sweep,
            "heavy_tail_bench": heavy_tail,
            "nonfactor": nonfactor,
        },
    }
    print(json.dumps(_sanitize(result)))


if __name__ == "__main__":
    main()
