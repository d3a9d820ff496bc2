"""Observation-axis sharding helpers.

Every per-observation kernel in :mod:`pyloo_tpu.ops` is embarrassingly
parallel over rows, so a single 1-D mesh over all addressable devices with
``P("obs", None)`` row sharding is the canonical layout (SURVEY.md §5).
Draw-axis sharding is used only by ``loo_nonfactor`` (cross-observation
coupling, sharded over draws instead).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..rcparams import rcParams

__all__ = ["obs_mesh", "obs_sharding", "replicated_sharding", "apply_rowwise"]

# Row budget per kernel invocation when falling back to host-side chunking on
# a single device: bounds peak HBM at roughly chunk * S * itemsize * ~4 live
# buffers.  131072 rows x 4000 draws x 8 B ~= 4 GiB of input per chunk.
_DEFAULT_CHUNK_BYTES = 2 << 30


def obs_mesh(devices: Sequence[jax.Device] | None = None) -> Mesh | None:
    """A 1-D ("obs",) mesh over all addressable devices; None when single."""
    devices = list(devices) if devices is not None else jax.devices()
    if len(devices) <= 1:
        return None
    return Mesh(np.asarray(devices), axis_names=("obs",))


def obs_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (observations) across the mesh; replicate the draw axis."""
    return NamedSharding(mesh, P("obs", None))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _ceil_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def apply_rowwise(
    kernel: Callable,
    rows,
    *,
    n_outputs: int = 2,
    mesh: Mesh | None = None,
    chunk_bytes: int = _DEFAULT_CHUNK_BYTES,
):
    """Run a jitted row-parallel kernel over a (B, S) array at any scale.

    * multi-device (an explicit ``mesh``, or every visible device when
      ``rcParams["device.auto_shard"]`` is on): pad B to a multiple of the
      mesh size, place the input with ``P("obs", None)`` and make one
      sharded call — XLA keeps every reduction local to a row, so no
      collectives are emitted at all;
    * single device: chunk the batch on host to bound peak HBM, letting
      successive dispatches pipeline (the next chunk's transfer overlaps the
      current chunk's compute).

    ``kernel`` maps ``(chunk, S) -> tuple`` of per-row outputs whose leading
    dimension is the chunk size.
    """
    rows = jnp.asarray(rows)
    B, S = rows.shape
    if mesh is None and rcParams["device.auto_shard"]:
        mesh = obs_mesh()

    if mesh is not None:
        n_dev = math.prod(mesh.devices.shape)
        padded = _ceil_to(max(B, n_dev), n_dev)
        if padded != B:
            rows = jnp.pad(rows, ((0, padded - B), (0, 0)))
        rows = jax.device_put(rows, obs_sharding(mesh))
        outs = kernel(rows)
        if not isinstance(outs, tuple):
            outs = (outs,)
        return tuple(o[:B] for o in outs)

    row_bytes = S * rows.dtype.itemsize
    chunk = max(1, chunk_bytes // max(row_bytes, 1))
    if chunk >= B:
        outs = kernel(rows)
        return outs if isinstance(outs, tuple) else (outs,)

    pieces: list[list] = [[] for _ in range(n_outputs)]
    for start in range(0, B, chunk):
        block = rows[start : start + chunk]
        n_valid = block.shape[0]
        if n_valid != chunk:
            # pad the ragged tail chunk so the jitted kernel compiles once
            block = jnp.pad(block, ((0, chunk - n_valid), (0, 0)))
        outs = kernel(block)
        if not isinstance(outs, tuple):
            outs = (outs,)
        for buf, o in zip(pieces, outs):
            buf.append(o[:n_valid])
    return tuple(jnp.concatenate(buf, axis=0) for buf in pieces)
