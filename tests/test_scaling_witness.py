"""Machine-checked multi-chip scaling witness (pyloo_tpu.parallel.witness).

Result parity across mesh sizes says nothing about how a sharded step
scales.  These tests assert the scaling properties *statically* on the
compiled, SPMD-partitioned HLO:

(a) the ONLY cross-device ops in a sharded LOO step are scalar all-reduces
    (the final elpd/SE/p_loo/k reductions) — no all-gather, all-to-all,
    collective-permute, or tensor-shaped all-reduce at any mesh size;
(b) per-device FLOPs and instruction counts are constant at constant
    per-device work (weak scaling is flat by construction, not by timing);
(c) per-device FLOPs shrink ~1/mesh at constant total work (strong scaling).

A negative control proves the census actually detects violations.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyloo_tpu.ops import tail_length
from pyloo_tpu.ops.loo_kernels import (
    loo_scores_psis,
    loo_scores_sis,
)
from pyloo_tpu.parallel.witness import (
    assert_scalar_only_collectives,
    collective_census,
    compiled_flops,
)

MESH_SIZES = (1, 2, 4, 8)
S = 128
M_TAIL = tail_length(S, 1.0)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), axis_names=("obs",))


def _compile(step, n_rows, mesh, dtype=jnp.float64):
    shard = NamedSharding(mesh, P("obs", None))
    repl = NamedSharding(mesh, P())
    arg = jax.ShapeDtypeStruct((n_rows, S), dtype, sharding=shard)
    return jax.jit(step, out_shardings=repl).lower(arg).compile()


def _loo_step(ll):
    elpd_i, khat, lppd_i = loo_scores_psis(ll, M_TAIL)
    n = ll.shape[0]
    elpd = jnp.sum(elpd_i)
    se = jnp.sqrt(n * jnp.var(elpd_i))
    p_loo = jnp.sum(lppd_i) - elpd
    return elpd, se, p_loo, jnp.max(khat)


def _sis_step(ll):
    elpd_i, ess, lppd_i = loo_scores_sis(ll)
    return jnp.sum(elpd_i), jnp.min(ess), jnp.sum(lppd_i)


@pytest.mark.parametrize("step", [_loo_step, _sis_step], ids=["psis", "sis"])
def test_weak_scaling_witness(step):
    # constant per-device rows; growing mesh
    per_dev = 64
    flops, lines, censuses = [], [], []
    for ms in MESH_SIZES:
        comp = _compile(step, per_dev * ms, _mesh(ms))
        censuses.append(assert_scalar_only_collectives(comp))
        flops.append(compiled_flops(comp))
        lines.append(comp.as_text().count("\n"))

    # mesh=1 has no collectives at all
    assert censuses[0] == {}
    # every multi-device census is scalar all-reduces only (already asserted
    # shape-wise above); the reduction count must not grow with the mesh
    n_reduces = {len(c.get("all-reduce", [])) for c in censuses[1:]}
    assert len(n_reduces) == 1, f"all-reduce count varies with mesh: {censuses}"

    # per-device FLOPs constant at constant per-device work (the scalar
    # all-reduce combiner adds O(outputs) flops, nothing shape-dependent)
    assert all(f is not None for f in flops)
    base = flops[0]
    for ms, f in zip(MESH_SIZES[1:], flops[1:]):
        assert abs(f - base) <= max(64.0, 1e-4 * base), (
            f"mesh={ms}: per-device flops {f} != mesh=1 {base}"
        )
    # instruction count essentially constant (collective ops add a handful)
    for ms, n in zip(MESH_SIZES[1:], lines[1:]):
        assert abs(n - lines[0]) <= 32, (
            f"mesh={ms}: {n} HLO lines vs {lines[0]} at mesh=1"
        )


def test_strong_scaling_witness():
    # constant TOTAL rows; per-device flops must shrink ~1/mesh
    total = 512
    flops = []
    for ms in MESH_SIZES:
        comp = _compile(_loo_step, total, _mesh(ms))
        assert_scalar_only_collectives(comp)
        flops.append(compiled_flops(comp))
    assert all(f is not None for f in flops)
    for ms, f in zip(MESH_SIZES[1:], flops[1:]):
        expect = flops[0] / ms
        assert f <= expect * 1.15 + 64, (
            f"mesh={ms}: per-device flops {f} not ~1/{ms} of {flops[0]}"
        )


def test_streaming_chunk_step_witness():
    # the loo_streaming per-chunk program under a mesh: sharded chunk in,
    # replicated scalar carry out -> scalar all-reduces only
    from pyloo_tpu.streaming import _accumulate_chunk
    from pyloo_tpu.base import ISMethod

    ms = 8
    mesh = _mesh(ms)
    shard = NamedSharding(mesh, P("obs", None))
    repl = NamedSharding(mesh, P())
    chunk = 64 * ms
    zero = jnp.zeros((), jnp.float64)
    carry = {
        "sum_e": zero, "sum_e2": zero, "sum_lppd": zero,
        "good_k": jnp.asarray(0.7, jnp.float64),
        "n_bad": jnp.zeros((), jnp.int32),
        "k_max": jnp.asarray(-jnp.inf, jnp.float64),
    }
    ll_arg = jax.ShapeDtypeStruct((chunk, S), jnp.float64, sharding=shard)
    carry_arg = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(
            x.shape, x.dtype, sharding=NamedSharding(mesh, P())
        ),
        carry,
    )
    row_vec = NamedSharding(mesh, P("obs"))
    out_shardings = (
        jax.tree_util.tree_map(lambda _: repl, carry),  # carry: replicated
        row_vec,                                        # elpd_i: row-sharded
        row_vec,                                        # diag:   row-sharded
    )
    comp = (
        jax.jit(
            _accumulate_chunk,
            static_argnames=("method", "tail_max"),
            out_shardings=out_shardings,
        )
        .lower(
            ll_arg,
            jax.ShapeDtypeStruct((), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32),
            carry_arg,
            method=ISMethod.PSIS,
            tail_max=M_TAIL,
        )
        .compile()
    )
    census = assert_scalar_only_collectives(comp)
    assert census, "multi-device chunk step must reduce the carry scalars"


def test_witness_detects_violations():
    # negative control at the COMPILED-HLO level: a shard_map with an
    # explicit vector psum compiles to an all-reduce over f64[rows] — a
    # non-scalar collective the witness must reject.  (GSPMD-annotated
    # programs are not usable as the control: the partitioner may replicate
    # the whole program and satisfy the sharding at the runtime boundary,
    # leaving no in-module collective at all.)  This also pins the parser
    # against real backend output — ranked shapes carry {layout} suffixes
    # (f64[256]{0}) which an earlier parser version failed to match,
    # passing the witness exactly when it should fail.
    ms = 4
    mesh = _mesh(ms)
    shard = NamedSharding(mesh, P("obs", None))

    def body(ll):  # per-device block
        elpd_i, khat, lppd_i = loo_scores_psis(ll, M_TAIL)
        return jax.lax.psum(elpd_i, "obs")  # vector all-reduce: violation

    f = jax.shard_map(body, mesh=mesh, in_specs=P("obs", None), out_specs=P())
    arg = jax.ShapeDtypeStruct((64 * ms, S), jnp.float64, sharding=shard)
    comp = jax.jit(f).lower(arg).compile()
    census = collective_census(comp)
    assert census.get("all-reduce"), f"expected a vector all-reduce: {census}"
    assert any(s != "f64[]" for s in census["all-reduce"])
    with pytest.raises(AssertionError, match="non-scalar"):
        assert_scalar_only_collectives(comp)


def test_census_shape_parsing():
    class FakeCompiled:
        def as_text(self):
            return (
                "%ar = f64[] all-reduce(f64[] %a), replica_groups={}\n"
                "%t = (f32[], s32[]) all-reduce(f32[] %b, s32[] %c)\n"
                "%ag = f64[8,16]{1,0} all-gather(f64[2,16]{1,0} %d), dims={0}\n"
                "%ars = f64[] all-reduce-start(f64[] %e)\n"
                "%lay = f64[256]{0} all-reduce(f64[256]{0} %f)\n"
                "%tl = (f64[4]{0}, s32[]) all-to-all(f64[4]{0} %g, s32[] %h)\n"
            )

    census = collective_census(FakeCompiled())
    assert census["all-reduce"] == ["f64[]", "f32[]", "s32[]", "f64[]", "f64[256]"]
    assert census["all-gather"] == ["f64[8,16]"]
    assert census["all-to-all"] == ["f64[4]", "s32[]"]
    with pytest.raises(AssertionError):
        assert_scalar_only_collectives(FakeCompiled())
