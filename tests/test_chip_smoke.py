"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
``--rehearse`` mode drives every phase at toy size against the oracle."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(args, tmp_path, n_devices=1, timeout=600):
    flags = " ".join(
        f for f in os.environ.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    count = f"--xla_force_host_platform_device_count={n_devices}"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=f"{flags} {count}")
    return subprocess.run(
        [sys.executable, SCRIPT, *args, "--work-dir", str(tmp_path)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=timeout,
    )


def _json_lines(stdout):
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_refuses_to_run_without_gpu(tmp_path, args):
    out = _run(args, tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_rehearsal_runs_every_phase(tmp_path):
    out = _run(["--rehearse"], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = _json_lines(out.stdout)
    phases = [d.get("phase") for d in lines[:-1]]
    assert phases == [
        "bundled", "streamed_float32", "streamed_float64",
        "totals_f32_vs_f64", "host_resident", "disk_resident", "done",
    ]
    for d in lines:
        if "oracle" in d:
            assert d["oracle"]["passed"], d
    assert lines[-1] == {
        "ok": False, "rehearsal": True,
        "device": {"platform": "cpu", "kind": "cpu", "count": 1},
    }
    # the disk phase cleans up the file it wrote
    assert not any(p.suffix == ".npy" for p in tmp_path.iterdir())


def test_rehearsal_four_devices(tmp_path):
    out = _run(["--rehearse", "--four"], tmp_path, n_devices=4)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = _json_lines(out.stdout)
    assert [d.get("phase") for d in lines[:-1]] == [
        "four_streamed_float32", "four_streamed_float64",
        "four_host_auto_shard", "four_nonfactor", "done",
    ]
    assert lines[-1]["ok"] is False and lines[-1]["device"]["count"] == 4


class TestHelpers:
    """The comparison helpers the phases gate on, in process."""

    @pytest.fixture(scope="class")
    def smoke(self):
        sys.path.insert(0, REPO)
        import chip_smoke

        return chip_smoke

    def _result(self, elpd, khat):
        import pyloo_tpu as pl

        return type("R", (), {
            "loo_i": pl.DataArray(np.asarray(elpd), ("obs",)),
            "pareto_k": pl.DataArray(np.asarray(khat), ("obs",)),
        })()

    @pytest.mark.parametrize(
        "shift_e,shift_k,passed",
        [(0.0, 0.0, True), (2e-9, 0.0, False), (0.0, 2e-6, False)],
    )
    def test_compare_rows_tolerances(self, smoke, shift_e, shift_k, passed):
        e_ref = np.array([-1.0, -0.5, -2.0])
        k_ref = np.array([0.1, 0.4, 0.6])
        res = self._result(
            e_ref * (1 + shift_e), k_ref + shift_k
        )
        cmp = smoke.compare_rows(
            res, np.arange(3), (e_ref, k_ref),
            smoke.F64_ELPD_RTOL, smoke.F64_K_ATOL,
        )
        assert cmp["passed"] is passed

    def test_check_raises(self, smoke):
        with pytest.raises(smoke.SmokeFailure):
            smoke.check(False, "boom")
        smoke.check(True, "fine")

    def test_host_rows_match_device_generator(self, smoke):
        import jax.numpy as jnp

        post = smoke.LogisticPosterior(64, 40, seed=3)
        idx = np.array([0, 7, 63])
        dev = np.asarray(post.log_lik_fn(jnp.float64)(jnp.asarray(idx)))
        np.testing.assert_allclose(post.host_rows(idx), dev, rtol=1e-13)

    def test_oracle_matches_exact_kernel(self, smoke, rng):
        import jax.numpy as jnp

        from pyloo_tpu.ops import tail_length
        from pyloo_tpu.ops.loo_kernels import loo_scores_psis

        ll = rng.normal(-1.0, 0.7, size=(6, 500))
        e_ref, k_ref = smoke.oracle(ll)
        e, k, _ = loo_scores_psis(jnp.asarray(ll), tail_length(500, 1.0))
        np.testing.assert_allclose(np.asarray(e), e_ref, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(k), k_ref, atol=1e-12)
