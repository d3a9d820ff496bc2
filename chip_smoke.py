"""Smoke run of the PSIS-LOO main path on a GPU, checked against a reference.

Drives the public entry points once at the size of a real deployment
(1,000,000 observations x 4,000 draws, i.e. 4 chains x 1,000) and compares
2,048 seeded rows of every large phase with ``tests/oracle.psis_row``, an
independent NumPy float64 PSIS:

1. ``pl.loo`` on the bundled eight-schools posterior, float64, against the
   reference README's numbers, plus ``pl.loo_compare`` when pandas imports;
2. ``pl.loo_streaming`` in float32 over an on-device logistic-regression
   generator (``pl.warmup`` first, then one cold and two warm calls);
3. the same in float64, the reference-exact path;
4. ``pl.loo`` on a host ``(4, 1000, 100_000)`` float64 array;
5. ``pl.loo_from_file`` on a ``(100_000, 4000)`` float32 ``.npy``.

Every phase prints one JSON line with its wall times, which are reported and
never asserted.  A failed comparison or a phase that raises ends the run
with a non-zero exit code and no ``ok`` line.  The last line, after every
phase passed, is ``{"ok": true, "device": {...}}``.

Usage, from the repository root, one process per card::

    python chip_smoke.py              # the default phases on one GPU
    python chip_smoke.py --four       # only the multi-device path, 4 GPUs
    python chip_smoke.py --rehearse   # every phase at toy size, any device

Without a GPU the run stops at once with a non-zero exit code, except under
``--rehearse``, whose last line is never ``"ok": true``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from scipy.special import logsumexp

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances against the oracle.  float64: the only slack is summation
# order on the device.  float32: elpd_i as tests/test_selection.py holds the
# f32 kernel to; k-hat to 1e-3, ten times finer than the 0.01 at which k-hat
# is reported and read against 0.7, and about 300 times the worst f32 error
# seen on the CPU (3.0e-6 over 1,024 rows of this generator).
F64_ELPD_RTOL, F64_K_ATOL = 1e-9, 1e-6
F32_ELPD_RTOL, F32_K_ATOL = 2e-3, 1e-3
F32_TOTAL_RTOL = 1e-4
# multi-device against one device of the same process
FOUR_F64_RTOL, FOUR_F32_RTOL = 1e-10, 1e-5

# eight schools, centered: the reference README's loo() output
EIGHT_SCHOOLS = {"elpd_loo": -30.78, "se": 1.34, "p_loo": 0.95}


class SmokeFailure(RuntimeError):
    """A comparison against the reference failed."""


def gpu_identity() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them.

    Runs in a child process and never touches JAX.
    """
    cmd = [
        "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({type(err).__name__})"
    if out.returncode != 0:
        return f"nvidia-smi unavailable (exit {out.returncode})"
    return out.stdout.strip()


def require_gpu(allow_other: bool = False) -> dict:
    """The device report, or exit non-zero when JAX's device is no GPU."""
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu" and not allow_other:
        print(
            f"{os.path.basename(sys.argv[0])}: no GPU, JAX's first device"
            f" is {dev.platform} ({dev.device_kind})",
            file=sys.stderr,
        )
        sys.exit(2)
    return {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


class LogisticPosterior:
    """Seeded logistic-regression posterior held on the device.

    ``n_draws`` coefficient draws over ``n_feat`` features and ``n_obs``
    binary observations; the log-likelihood of observation i under draw s is
    ``y_i eta_is - log(1 + exp(eta_is))`` with ``eta = x beta^T``.
    """
    def __init__(self, n_obs, n_draws, seed, n_feat=32):
        kb, kx, ky = jax.random.split(jax.random.PRNGKey(seed), 3)
        self.beta = 0.3 * jax.random.normal(kb, (n_draws, n_feat), jnp.float32)
        self.x = 0.5 * jax.random.normal(kx, (n_obs, n_feat), jnp.float32)
        self.y = (jax.random.uniform(ky, (n_obs,)) < 0.5).astype(jnp.float32)

    def log_lik_fn(self, dtype):
        """Traceable ``(chunk,) -> (chunk, n_draws)`` generator in ``dtype``.

        The product is pinned to full precision so that float32 inputs do
        not run in TF32: the comparison then tests PSIS, not the matmul.
        """
        x, y, beta_t = self.x, self.y, self.beta.T

        def log_lik_fn(idx):
            eta = jnp.dot(
                x[idx].astype(dtype), beta_t.astype(dtype),
                precision=lax.Precision.HIGHEST,
            )
            yy = y[idx][:, None].astype(dtype)
            return yy * eta - jnp.logaddexp(0.0, eta)

        return log_lik_fn

    def host_rows(self, idx):
        """Those rows' log-likelihood recomputed in NumPy float64."""
        beta = np.asarray(self.beta, np.float64)
        x = np.asarray(self.x[idx], np.float64)
        y = np.asarray(self.y[idx], np.float64)
        eta = x @ beta.T
        return y[:, None] * eta - np.logaddexp(0.0, eta)


def oracle(ll_rows):
    """Per-row (elpd_i, k-hat) of ``tests.oracle.psis_row`` at r_eff = 1."""
    from tests.oracle import psis_row

    elpd = np.empty(len(ll_rows))
    khat = np.empty(len(ll_rows))
    for i, row in enumerate(ll_rows):
        lw, khat[i] = psis_row(-row)
        elpd[i] = logsumexp(lw + row)
    return elpd, khat


def compare_rows(res, idx, ref, elpd_rtol, k_atol) -> dict:
    """Max errors of a pointwise result's rows ``idx`` against the oracle."""
    elpd = np.asarray(res.loo_i.values, np.float64)[idx]
    khat = np.asarray(res.pareto_k.values, np.float64)[idx]
    e_ref, k_ref = ref
    err_e = float(np.max(np.abs(elpd - e_ref) / np.abs(e_ref)))
    err_k = float(np.max(np.abs(khat - k_ref)))
    return {
        "rows": len(idx),
        "max_rel_elpd_i": err_e, "elpd_rtol": elpd_rtol,
        "max_abs_khat": err_k, "khat_atol": k_atol,
        "passed": bool(err_e <= elpd_rtol and err_k <= k_atol),
    }


def sample_rows(n_obs, n_rows, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n_obs, size=min(n_rows, n_obs), replace=False))


def peak_bytes() -> int | None:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# -- default phases ---------------------------------------------------------


def phase_bundled():
    import pyloo_tpu as pl

    idata = pl.load_example_data("centered_eight")
    res, cold = timed(pl.loo, idata, pointwise=True)
    res, warm = timed(pl.loo, idata, pointwise=True)
    got = {k: float(res[k]) for k in EIGHT_SCHOOLS}
    khat_max = float(np.max(np.asarray(res.pareto_k.values)))
    fields = {"cold_s": cold, "warm_s": warm, **got, "max_khat": khat_max}
    try:
        import pandas  # noqa: F401
    except ImportError:
        fields["compare"] = "skipped: pandas not installed"
    else:
        other = pl.loo(
            pl.load_example_data("non_centered_eight"), pointwise=True
        )
        table, t_cmp = timed(
            pl.loo_compare, {"centered": res, "non_centered": other}
        )
        fields["compare_s"] = t_cmp
        fields["compare_elpd_diff"] = [float(v) for v in table["elpd_diff"]]
        check(
            len(table) == 2 and np.all(np.isfinite(table["elpd_loo"])),
            "loo_compare table",
        )
    emit("bundled", **fields)
    for key, want in EIGHT_SCHOOLS.items():
        check(abs(got[key] - want) <= 0.01, f"eight schools {key}: {got[key]}")
    check(khat_max < 0.7, f"eight schools max k-hat {khat_max}")


def phase_streamed(post, dtype, n_obs, n_draws, idx, ref):
    import pyloo_tpu as pl

    f32 = jnp.dtype(dtype) == jnp.float32
    fn = post.log_lik_fn(dtype)
    kw = dict(dtype=dtype, pointwise=True)
    _, t_warmup = timed(pl.warmup, n_obs, n_draws, **kw)
    res, cold = timed(pl.loo_streaming, fn, n_obs, n_draws, **kw)
    warm = [timed(pl.loo_streaming, fn, n_obs, n_draws, **kw)[1] for _ in "ab"]
    cmp = compare_rows(
        res, idx, ref,
        F32_ELPD_RTOL if f32 else F64_ELPD_RTOL,
        F32_K_ATOL if f32 else F64_K_ATOL,
    )
    emit(
        f"streamed_{jnp.dtype(dtype).name}",
        n_obs=n_obs, n_draws=n_draws, warmup_s=t_warmup, cold_s=cold,
        warm_s=warm, elpd_loo=float(res["elpd_loo"]),
        p_loo=float(res["p_loo"]), oracle=cmp, peak_bytes=peak_bytes(),
    )
    check(cmp["passed"], f"streamed {jnp.dtype(dtype).name} vs oracle")
    return res


def host_array(post, n_obs, n_draws, chains=4):
    """``(chains, draws, n_obs)`` float64 log-likelihood on the host.

    Evaluated op by op: a jit of the generator would bake the posterior's
    arrays into the program as constants.
    """
    ll = post.log_lik_fn(jnp.float64)(jnp.arange(n_obs, dtype=jnp.int32))
    return np.asarray(ll.T.reshape(chains, n_draws // chains, n_obs))


def phase_host(arr, idx, ref):
    import pyloo_tpu as pl

    idata, t_dict = timed(pl.from_dict, log_likelihood={"obs": arr})
    res, cold = timed(pl.loo, idata, pointwise=True, reff=1.0)
    res, warm = timed(pl.loo, idata, pointwise=True, reff=1.0)
    cmp = compare_rows(res, idx, ref, F64_ELPD_RTOL, F64_K_ATOL)
    emit(
        "host_resident", shape=list(arr.shape), gbytes=arr.nbytes / 1e9,
        from_dict_s=t_dict, cold_s=cold, warm_s=warm,
        elpd_loo=float(res["elpd_loo"]), oracle=cmp,
        peak_bytes=peak_bytes(),
    )
    check(cmp["passed"], "host-resident loo vs oracle")


def phase_disk(post, n_obs, n_draws, idx, work_dir):
    import pyloo_tpu as pl
    from pyloo_tpu._native import load_library

    fn = post.log_lik_fn(jnp.float32)
    rows = np.asarray(fn(jnp.arange(n_obs, dtype=jnp.int32)))
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, f"loglik_{n_obs}x{n_draws}_f32.npy")
    _, t_write = timed(np.save, path, rows)
    # the oracle reads the very values on disk, widened to float64
    ref = oracle(rows[idx].astype(np.float64))
    del rows
    try:
        res, cold = timed(pl.loo_from_file, path, pointwise=True)
        res, warm = timed(pl.loo_from_file, path, pointwise=True)
    finally:
        os.remove(path)
    reader = "native" if load_library() is not None else "numpy fallback"
    cmp = compare_rows(res, idx, ref, F64_ELPD_RTOL, F64_K_ATOL)
    emit(
        "disk_resident", shape=[n_obs, n_draws], write_s=t_write,
        cold_s=cold, warm_s=warm, reader=reader,
        elpd_loo=float(res["elpd_loo"]), oracle=cmp,
        peak_bytes=peak_bytes(),
    )
    check(cmp["passed"], "loo_from_file vs oracle")


def run_default(sizes, seed, work_dir):
    n_obs, n_draws = sizes["stream"]
    n_host = sizes["host_obs"]
    phase_bundled()

    post = LogisticPosterior(n_obs, n_draws, seed)
    idx = sample_rows(n_obs, sizes["oracle_rows"], seed)
    ref = oracle(post.host_rows(idx))
    r32 = phase_streamed(post, jnp.float32, n_obs, n_draws, idx, ref)
    r64 = phase_streamed(post, jnp.float64, n_obs, n_draws, idx, ref)
    e32, e64 = float(r32["elpd_loo"]), float(r64["elpd_loo"])
    rel = abs(e32 - e64) / abs(e64)
    emit("totals_f32_vs_f64", elpd_loo_f32=e32, elpd_loo_f64=e64,
         rel=rel, rtol=F32_TOTAL_RTOL)
    check(rel <= F32_TOTAL_RTOL, "float32 elpd_loo total vs float64")
    del r32, r64

    host_idx = sample_rows(n_host, sizes["oracle_rows"], seed + 1)
    arr = host_array(post, n_host, n_draws)
    phase_host(arr, host_idx, oracle(post.host_rows(host_idx)))
    del arr
    phase_disk(post, n_host, n_draws, host_idx, work_dir)


# -- the multi-device path ----------------------------------------------------


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def four_streaming(post, mesh, n_obs, n_draws):
    import pyloo_tpu as pl

    for dtype, rtol in ((jnp.float32, FOUR_F32_RTOL),
                        (jnp.float64, FOUR_F64_RTOL)):
        fn = post.log_lik_fn(dtype)
        kw = dict(dtype=dtype, pointwise=True)
        one, t_one = timed(pl.loo_streaming, fn, n_obs, n_draws, **kw)
        _, t_one_w = timed(pl.loo_streaming, fn, n_obs, n_draws, **kw)
        many, t_many = timed(
            pl.loo_streaming, fn, n_obs, n_draws, mesh=mesh, **kw
        )
        _, t_many_w = timed(
            pl.loo_streaming, fn, n_obs, n_draws, mesh=mesh, **kw
        )
        totals = {
            k: _rel(float(many[k]), float(one[k]))
            for k in ("elpd_loo", "p_loo", "se")
        }
        a = np.asarray(many.loo_i.values)
        b = np.asarray(one.loo_i.values)
        pw = float(np.max(np.abs(a - b) / np.abs(b)))
        emit(
            f"four_streamed_{jnp.dtype(dtype).name}", n_obs=n_obs,
            n_draws=n_draws, one_device_s=[t_one, t_one_w],
            mesh_s=[t_many, t_many_w], rel_totals=totals,
            max_rel_elpd_i=pw, rtol=rtol,
        )
        check(
            max(totals.values()) <= rtol and pw <= rtol,
            f"mesh vs one device, {jnp.dtype(dtype).name} streaming",
        )


def four_host(post, n_obs, n_draws):
    import pyloo_tpu as pl

    arr = host_array(post, n_obs, n_draws)
    idata = pl.from_dict(log_likelihood={"obs": arr})
    out, times = {}, {}
    saved = pl.rcParams["device.auto_shard"]
    try:
        for shard in (False, True):
            pl.rcParams["device.auto_shard"] = shard
            out[shard], times[shard] = timed(
                pl.loo, idata, pointwise=True, reff=1.0
            )
    finally:
        pl.rcParams["device.auto_shard"] = saved
    a = np.asarray(out[True].loo_i.values)
    b = np.asarray(out[False].loo_i.values)
    pw = float(np.max(np.abs(a - b) / np.abs(b)))
    tot = _rel(float(out[True]["elpd_loo"]), float(out[False]["elpd_loo"]))
    emit(
        "four_host_auto_shard", shape=list(arr.shape),
        unsharded_s=times[False], sharded_s=times[True],
        rel_elpd_loo=tot, max_rel_elpd_i=pw, rtol=FOUR_F64_RTOL,
    )
    check(tot <= FOUR_F64_RTOL and pw <= FOUR_F64_RTOL, "auto_shard parity")


def four_nonfactor(n, s, seed):
    import pyloo_tpu as pl

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    a = jax.random.normal(k1, (s, n, 64), jnp.float64)
    cov = jnp.einsum(
        "sik,sjk->sij", a, a, precision=lax.Precision.HIGHEST
    ) / 64 + 2.0 * jnp.eye(n)[None]
    mu = 0.1 * jax.random.normal(k2, (s, n), jnp.float64)
    y = jax.random.normal(k3, (n,), jnp.float64)
    idata = pl.from_dict(
        posterior={"mu": np.asarray(mu)[None], "cov": np.asarray(cov)[None]},
        observed_data={"y": np.asarray(y)},
    )
    out, times = {}, {}
    saved = pl.rcParams["device.auto_shard"]
    try:
        for shard in (False, True):
            pl.rcParams["device.auto_shard"] = shard
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out[shard], times[shard] = timed(
                    pl.loo_nonfactor, idata, pointwise=True, reff=1.0
                )
    finally:
        pl.rcParams["device.auto_shard"] = saved
    a_pw = np.asarray(out[True].loo_i.values)
    b_pw = np.asarray(out[False].loo_i.values)
    pw = float(np.max(np.abs(a_pw - b_pw) / np.abs(b_pw)))
    tot = _rel(float(out[True]["elpd_loo"]), float(out[False]["elpd_loo"]))
    emit(
        "four_nonfactor", n_obs=n, n_draws=s, unsharded_s=times[False],
        sharded_s=times[True], rel_elpd_loo=tot, max_rel_elpd_i=pw,
        rtol=FOUR_F64_RTOL,
    )
    check(tot <= FOUR_F64_RTOL and pw <= FOUR_F64_RTOL, "nonfactor parity")


def run_four(sizes, seed):
    from pyloo_tpu.parallel import obs_mesh

    devices = jax.devices()
    check(len(devices) >= 4, f"--four needs 4 devices, found {len(devices)}")
    mesh = obs_mesh(devices[:4])
    n_obs, n_draws = sizes["four_stream"]
    post = LogisticPosterior(n_obs, n_draws, seed)
    four_streaming(post, mesh, n_obs, n_draws)
    four_host(post, sizes["host_obs"], n_draws)
    four_nonfactor(*sizes["nonfactor"], seed)


SIZES = {
    "stream": (1_000_000, 4000),
    "host_obs": 100_000,
    "oracle_rows": 2048,
    "four_stream": (4_000_000, 4000),
    "nonfactor": (2048, 32),
}
REHEARSAL_SIZES = {
    "stream": (4096, 256),
    "host_obs": 2048,
    "oracle_rows": 128,
    "four_stream": (8192, 256),
    "nonfactor": (64, 8),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device path, on four devices")
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on any device; never prints ok")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work-dir", default=os.path.join(REPO, ".chip_smoke"),
                    help="where the disk phase writes its .npy")
    args = ap.parse_args(argv)

    device = require_gpu(allow_other=args.rehearse)

    print(gpu_identity(), flush=True)  # name, power limit
    print(f"device_kind: {device['kind']}  platform: {device['platform']}"
          f"  count: {device['count']}", flush=True)
    print(f"jax: {jax.__version__}", flush=True)
    try:
        import pandas
        print(f"pandas: {pandas.__version__}", flush=True)
    except ImportError:
        print("pandas: not installed", flush=True)

    import pyloo_tpu  # noqa: F401  (enables float64 before any array exists)

    sizes = REHEARSAL_SIZES if args.rehearse else SIZES
    t0 = time.perf_counter()
    if args.four:
        run_four(sizes, args.seed)
        device["count"] = 4
    else:
        run_default(sizes, args.seed, args.work_dir)
    emit("done", total_s=time.perf_counter() - t0)
    if args.rehearse:
        print(json.dumps({"ok": False, "rehearsal": True, "device": device}))
    else:
        print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
