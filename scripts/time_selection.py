"""Time what XLA makes of the float32 tail selection on the GPU.

At 1,000,000 observations x 4,000 draws float32, held on the device as eight
125,000-row chunks (the streaming path's chunk geometry), this times:

* ``max`` — one plain reduction over every element (a full read);
* ``cascade`` — ``topk_vals_desc``, the segmented ``approx_max_k`` cascade;
* ``lax.top_k`` — one top-k over the full row;
* ``loo_scores_psis_fast`` — the whole float32 PSIS kernel.

Each time is the median of 5 passes over all chunks, each pass ending in
``block_until_ready``.  It also prints the sort and custom-call instructions
of each optimized HLO module, which show how the selection was lowered.

Run from the repository root on a GPU: ``python scripts/time_selection.py``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import gpu_identity, require_gpu  # noqa: E402

N_OBS, N_DRAWS, CHUNK, REPS = 1_000_000, 4000, 125_000, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def main() -> int:
    device = require_gpu()
    import jax
    import jax.numpy as jnp

    import pyloo_tpu  # noqa: F401
    from pyloo_tpu.ops import tail_length
    from pyloo_tpu.ops.loo_kernels import loo_scores_psis_fast
    from pyloo_tpu.ops.selection import topk_vals_desc

    print(gpu_identity(), flush=True)  # name, power limit
    m = tail_length(N_DRAWS, 1.0)
    k = m + 1
    chunks = [
        1.5 * jax.random.normal(
            jax.random.PRNGKey(i), (CHUNK, N_DRAWS), jnp.float32
        )
        for i in range(N_OBS // CHUNK)
    ]
    jax.block_until_ready(chunks)
    full_read_s = N_OBS * N_DRAWS * 4 / HBM_BYTES_PER_S
    variants = {
        "max": jax.jit(lambda x: jnp.max(x, axis=1)),
        "cascade": jax.jit(lambda x: topk_vals_desc(x, k)),
        "lax.top_k": jax.jit(lambda x: jax.lax.top_k(x, k)[0]),
        "loo_scores_psis_fast": jax.jit(lambda x: loo_scores_psis_fast(x, m)),
    }
    for name, fn in variants.items():
        hlo = fn.lower(chunks[0]).compile().as_text()
        lowered = sorted({
            line.split("=", 1)[1].strip()[:160]
            for line in hlo.splitlines()
            if " sort(" in line or "custom-call(" in line
        })
        jax.block_until_ready(fn(chunks[0]))
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready([fn(c) for c in chunks])
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        print(json.dumps({
            "variant": name, "rows": N_OBS, "draws": N_DRAWS, "k": k,
            "median_s": med, "times_s": times,
            "full_read_floor_s": full_read_s,
            "x_floor": med / full_read_s, "sort_and_custom_calls": lowered,
        }), flush=True)
    print(json.dumps({"device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
