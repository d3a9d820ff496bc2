"""Exact top-k row selection.

``jax.lax.top_k`` and single-stage ``approx_max_k`` select over the FULL row
width.  When the backend lowers top-k to a sort whose cost per element grows
with the sorted width, an exact segmented cascade does less work:

  stage 1: top-k within each of G segments of width S/G
  stage 2: top-k of the concatenated G*k per-segment winners

Exactness: every global top-k element is a top-k element of its own segment,
so the union of per-segment winners is a superset of the global top-k.
``approx_max_k`` runs with ``recall_target=1.0``, so each stage is exact on
every backend, whether or not it has an approximate lowering.

Values-only: the cascade does not track original column indices (stage-2
indices point into the stage-1 winner array), which is exactly what the
scatter-free fast LOO kernel consumes.  Index-returning callers
(``psislw_batch``'s scatter path) keep single-stage selection.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["topk_vals_desc", "topk_with_idx", "topk_hybrid_f64"]

# Segment width for the first cascade stage: four segments at the default
# S=4000 draws; rows narrower than _MIN_CASCADE_WIDTH or k too close to the
# segment width fall back to single-stage selection.
_SEGMENT_WIDTH = 1000
_MIN_CASCADE_WIDTH = 2000


def topk_vals_desc(x, k: int):
    """Exact top-k values of each row of ``x``, descending.  (B, S) -> (B, k).

    Equivalent to ``jax.lax.top_k(x, k)[0]``, computed by the segmented
    ``approx_max_k`` cascade on rows wide enough for it to shrink the width.
    """
    s = x.shape[-1]
    if k == s:
        return jnp.sort(x, axis=-1, descending=True)
    # the segment must hold at least 2k so stage 1 shrinks the width; for
    # large k (e.g. the PSIS tail at S > 29k draws: k = 3*sqrt(S)+1 > 500)
    # the fixed 1000-wide segments would silently degrade to a full-width
    # single-stage sort — scale the width with k instead
    seg_width = max(_SEGMENT_WIDTH, 2 * k)
    if s < max(_MIN_CASCADE_WIDTH, 2 * seg_width):
        return _single(x, k)

    g = max(s // seg_width, 2)
    seg = -(-s // g)  # ceil; pad the ragged tail with -inf
    pad = g * seg - s
    if pad:
        fill = jnp.full(x.shape[:-1] + (pad,), -jnp.inf, dtype=x.dtype)
        x = jnp.concatenate([x, fill], axis=-1)
    xs = x.reshape(x.shape[:-1] + (g, seg))
    winners = _single(xs, min(k, seg))
    return _single(winners.reshape(x.shape[:-1] + (g * min(k, seg),)), k)


def _single(x, k: int):
    vals, _ = jax.lax.approx_max_k(x, k, recall_target=1.0)
    return vals


def topk_with_idx(x, k: int):
    """Exact top-k values AND source indices per row, descending.

    Like ``jax.lax.top_k`` but routed through the segmented cascade on wide
    rows (stage-2 winner indices are composed back to global column indices
    with one narrow gather).  Tie note: which member of a run of equal
    values is returned is unspecified (``lax.top_k`` picks the lowest
    index); values are exact either way.
    """
    s = x.shape[-1]
    if k == s or s < _MIN_CASCADE_WIDTH or _SEGMENT_WIDTH < 2 * k:
        return jax.lax.top_k(x, k)

    g = max(s // _SEGMENT_WIDTH, 2)
    seg = -(-s // g)
    pad = g * seg - s
    if pad:
        fill = jnp.full(x.shape[:-1] + (pad,), -jnp.inf, dtype=x.dtype)
        x = jnp.concatenate([x, fill], axis=-1)
    xs = x.reshape(x.shape[:-1] + (g, seg))
    kk = min(k, seg)
    w_vals, w_idx = jax.lax.approx_max_k(xs, kk, recall_target=1.0)
    offs = (jnp.arange(g, dtype=w_idx.dtype) * seg)[
        (None,) * (x.ndim - 1) + (slice(None), None)
    ]
    w_gidx = (w_idx + offs).reshape(x.shape[:-1] + (g * kk,))
    v2, i2 = jax.lax.approx_max_k(
        w_vals.reshape(x.shape[:-1] + (g * kk,)), k, recall_target=1.0
    )
    idx = jnp.take_along_axis(w_gidx, i2, axis=-1)
    return v2, idx


# Extra proxy-selection slots beyond k: the float32 tie class straddling the
# selection boundary must fit in this margin (else the row falls back to
# full-width float64 selection — see ``topk_hybrid_f64``).
_HYBRID_PAD = 64


def topk_hybrid_f64(xs, k: int):
    """Exact descending top-k of float64 rows at float32 selection speed.

    Selection only needs the *order*, and float32 rounding is monotone:
    selecting ``k + PAD`` candidates on the f32 proxy, gathering their true
    f64 values, and re-selecting top-k among the narrow candidates gives
    bit-identical values whenever the proxy tie class at the selection
    boundary either fits in the padding or is f64-constant.

    Returns ``(vals, ok)``: ``vals`` is ``(B, k)`` f64 descending; ``ok``
    is ``(B,)`` bool, True where the selection is PROVABLY exact.  Rows
    with ``ok == False`` (adversarial: > PAD f64-distinct values inside one
    f32 ulp exactly at the boundary) must be recomputed with
    ``lax.top_k(xs, k)``.

    Proof sketch: with ``t`` the smallest selected proxy, every true top-k
    element has proxy >= t (if its proxy were < t, the >= k elements with
    proxy >= t would all strictly exceed it in f64 by monotonicity).
    Elements with proxy > t are all selected; so the selection can only
    miss top-k members from the proxy tie class at ``t``, and then only if
    the tie class overflows the padding with f64-distinct values.
    """
    B, S = xs.shape
    cap = min(k + _HYBRID_PAD, S)
    proxy = xs.astype(jnp.float32)
    if cap == S:
        vals = jnp.sort(xs, axis=-1, descending=True)[:, :k]
        return vals, jnp.ones((B,), bool)
    pv, pidx = topk_with_idx(proxy, cap)
    # ragged-row padding can be selected when a row holds > S - cap ``-inf``
    # entries; those candidate indices point past S and must gather -inf,
    # not a clamped real value
    cand = jnp.take_along_axis(
        xs, pidx, axis=1, mode="fill", fill_value=-jnp.inf
    )  # (B, cap) f64
    vals = jax.lax.top_k(cand, k)[0]

    t = pv[:, cap - 1]  # smallest selected proxy
    n_gt = jnp.sum((proxy > t[:, None]).astype(jnp.int32), axis=1)
    n_eq = jnp.sum((proxy == t[:, None]).astype(jnp.int32), axis=1)
    tie = proxy == t[:, None]
    tie_max = jnp.max(jnp.where(tie, xs, -jnp.inf), axis=1)
    tie_min = jnp.min(jnp.where(tie, xs, jnp.inf), axis=1)
    ok = (
        (n_gt >= k)  # boundary tie class entirely below the top-k
        | (n_gt + n_eq <= cap)  # whole tie class selected
        | (tie_max == tie_min)  # tie class f64-constant: any choice exact
    )
    return vals, ok
