"""Top-k helpers (smaller-is-better convention everywhere).

Replaces the reference's per-thread heaps + critical-section merge
(gamma_index_ivfpq.cc:848-866, faiss heap_replace_top in ivfpq.h:574-600)
with `jax.lax.top_k` reductions.

`select_min_k` is the ONE candidate-selection primitive of the wide
scans (dense mirror scan, gathered-list scans, sharded bodies, HNSW
graph build): every caller that picks recall_num candidates out of a
wide distance row goes through it, so the selection policy is decided
in one place (the measurement behind the choice is in PERF.md).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from gamma_tpu.ops.distances import BIG

# Widest candidate row select_min_k sorts exactly; wider rows go through
# the strided chunk-min prefilter (_chunkmin_topk).
EXACT_SELECT_MAX_WIDTH = 1 << 14
# chunk-min prefilter bin count: the exact phase-2 top-k runs over this
# many bin winners per row.  Fixed, so position p always lands in bin
# p % CHUNK_SELECT_BINS whatever the row's padded width: the same data
# selects the same candidates before and after a capacity change.
CHUNK_SELECT_BINS = 1 << 14


def topk_min(dists: jnp.ndarray, ids: jnp.ndarray, k: int):
    """Top-k smallest along the last axis.  Returns (vals, ids).
    If k exceeds the candidate count, results are padded with (BIG, -1)."""
    size = dists.shape[-1]
    k_eff = min(k, size)
    neg_vals, idx = jax.lax.top_k(-dists, k_eff)
    out_ids = jnp.take_along_axis(ids, idx, axis=-1)
    vals = -neg_vals
    if k_eff < k:
        pad = [(0, 0)] * (vals.ndim - 1) + [(0, k - k_eff)]
        vals = jnp.pad(vals, pad, constant_values=BIG)
        out_ids = jnp.pad(out_ids, pad, constant_values=-1)
    return vals, out_ids


def _chunkmin_topk(flat: jnp.ndarray, rn: int) -> Tuple[jnp.ndarray,
                                                        jnp.ndarray]:
    """Near-exact wide top-k: chunk-min prefilter (one pass over the row)
    + EXACT top-rn over the L = CHUNK_SELECT_BINS bin winners.

    The bins are STRIDED, not contiguous: bin c holds flat elements
    {c, c+L, c+2L, ...}.  A query's true top-k concentrate inside one
    or two hot inverted lists (adjacent slots of one probe block in the
    probe-major flatten), and two slots of the same probed list sit
    < cap <= L apart — a strided bin can never hold both, so same-list
    near-ties survive phase 1 by construction.  Two true neighbours are
    lost to each other only when their positions differ by a multiple
    of L.  Phase 2 is an exact top-rn over the L bin winners +
    post-selection recovery of within-bin offsets."""
    b, width = flat.shape
    ell = CHUNK_SELECT_BINS
    g = -(-width // ell)
    padded = flat
    if g * ell != width:
        padded = jnp.pad(flat, ((0, 0), (0, g * ell - width)),
                         constant_values=BIG)
    cmin = jnp.min(padded.reshape(b, g, ell), axis=1)  # [B, L] one pass
    k_eff = min(rn, ell)
    nd, pos = jax.lax.top_k(-cmin, k_eff)
    # within-bin winner offsets recovered POST-selection: gather the
    # k_eff selected bins' g candidates ([B, g, rn] — trivial) from the
    # UNPADDED row, so the padded copy feeds only the min pass
    cand = (pos.astype(jnp.int32)[:, None, :]
            + ell * jnp.arange(g, dtype=jnp.int32)[None, :, None])
    sel = jnp.take_along_axis(
        flat, jnp.minimum(cand, width - 1).reshape(b, -1),
        axis=1).reshape(b, g, k_eff)
    sel = jnp.where(cand < width, sel, BIG)              # [B, g, rn]
    j = jnp.argmin(sel, axis=1).astype(jnp.int32)        # [B, rn]
    ridx = j * ell + pos.astype(jnp.int32)
    return -nd, ridx


def select_min_k(dist: jnp.ndarray, k: int
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The k smallest entries of each row of `dist` [B, n], ascending.
    → (vals [B, k] f32, idx [B, k] i32).  Rows up to
    EXACT_SELECT_MAX_WIDTH are selected exactly (lax.top_k); wider rows
    by the strided chunk-min prefilter, which keeps a true candidate
    unless a smaller one shares its bin.  Slots beyond the row (k > n,
    or bins that ran out) come back as (BIG, -1)."""
    n = dist.shape[-1]
    if n <= EXACT_SELECT_MAX_WIDTH:
        nd, idx = jax.lax.top_k(-dist, min(k, n))
        vals = -nd
    else:
        vals, idx = _chunkmin_topk(dist, k)
    idx = jnp.where(idx < n, idx, -1).astype(jnp.int32)
    if vals.shape[-1] < k:
        pad = [(0, 0)] * (vals.ndim - 1) + [(0, k - vals.shape[-1])]
        vals = jnp.pad(vals, pad, constant_values=BIG)
        idx = jnp.pad(idx, pad, constant_values=-1)
    return vals, idx


def merge_topk(d1, i1, d2, i2, k: int):
    """Merge two (dist, id) top-k sets along the last axis."""
    d = jnp.concatenate([d1, d2], axis=-1)
    i = jnp.concatenate([i1, i2], axis=-1)
    return topk_min(d, i, k)


def mask_invalid(dists: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Push masked entries to +BIG so top-k never selects them."""
    return jnp.where(valid, dists, BIG)
