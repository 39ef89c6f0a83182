"""Brute-force scan: exact top-k with fused validity penalty.

Reference: GammaFLATIndex (index/impl/gamma_index_flat.cc:118-300) —
OpenMP-parallel L2/IP scan with per-vid filter + score-range checks.
Here: one matmul per corpus chunk + running top-k merge under a
`lax.fori_loop`; the penalty gather replaces the IsValid callback and the
score-range check becomes a post-filter on the final k.

The FLAT contract is exact distances, so every matmul here runs at
`Precision.HIGHEST` (full f32; the GPU default would be TF32).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gamma_tpu.ops.distances import pairwise_l2, pairwise_ip, BIG
from gamma_tpu.ops.topk import topk_min, merge_topk

_EXACT = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("k", "metric", "chunk"))
def flat_search(vectors: jnp.ndarray, vec_norms: jnp.ndarray,
                queries: jnp.ndarray, penalty: jnp.ndarray,
                dist_range: jnp.ndarray = None,
                *, k: int, metric: str = "l2", chunk: int = 131072):
    """Exact search.

    vectors  [N_cap, d]  (bf16 or f32; rows beyond live docs are masked
                          via penalty=BIG)
    vec_norms[N_cap]     precomputed ||x||^2 (f32; ignored for IP)
    queries  [B, d]
    penalty  [N_cap]     0 = valid, BIG = masked
    dist_range [2] f32, optional — fused score-range filter: candidates
             with raw distance outside [lo, hi] are masked IN the scan
             (reference: IsSimilarScoreValid inside the scanner,
             gamma_index_ivfpq.h:574-601), so the top-k fills with valid
             hits instead of post-filtering below k.
    → (dists [B, k] f32, ids [B, k] i32); masked slots come back with
      dist >= BIG and id of whatever padding slot — callers drop them.
    """
    n = vectors.shape[0]
    b = queries.shape[0]
    chunk = min(chunk, n)
    nchunks = -(-n // chunk)

    def scan_chunk(ci, carry):
        best_d, best_i = carry
        # dynamic_slice clamps out-of-range starts; clamp explicitly and
        # mask rows that a previous chunk already covered so ids stay
        # unique across chunks.
        start = jnp.minimum(ci * chunk, n - chunk)
        v = jax.lax.dynamic_slice_in_dim(vectors, start, chunk, axis=0)
        vn = jax.lax.dynamic_slice_in_dim(vec_norms, start, chunk, axis=0)
        pen = jax.lax.dynamic_slice_in_dim(penalty, start, chunk, axis=0)
        if metric == "ip":
            d = -pairwise_ip(queries, v, precision=_EXACT)
        else:
            d = pairwise_l2(queries, v, vn, precision=_EXACT)
        if dist_range is not None:
            out = (d < dist_range[0]) | (d > dist_range[1])
            d = jnp.where(out, BIG, d)
        ids = start + jnp.arange(chunk, dtype=jnp.int32)
        dup = ids < ci * chunk
        d = jnp.minimum(d + pen[None, :] + jnp.where(dup, BIG, 0.0)[None, :],
                        BIG)
        cd, cidx = topk_min(d, jnp.broadcast_to(ids[None, :], d.shape), k)
        return merge_topk(best_d, best_i, cd, cidx, k)

    init = (jnp.full((b, k), BIG, jnp.float32),
            jnp.full((b, k), jnp.int32(-1)))
    if nchunks == 1:
        return scan_chunk(0, init)
    return jax.lax.fori_loop(0, nchunks, scan_chunk, init)


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _stream_chunk(rows, rnorms, pen, start, best_d, best_i, queries,
                  dist_range=None, *, k: int, metric: str):
    if metric == "ip":
        d = -pairwise_ip(queries, rows, precision=_EXACT)
    else:
        d = pairwise_l2(queries, rows, rnorms, precision=_EXACT)
    if dist_range is not None:
        d = jnp.where((d < dist_range[0]) | (d > dist_range[1]), BIG, d)
    d = jnp.minimum(d + pen[None, :], BIG)
    ids = start + jnp.arange(rows.shape[0], dtype=jnp.int32)
    cd, cidx = topk_min(d, jnp.broadcast_to(ids[None, :], d.shape), k)
    return merge_topk(best_d, best_i, cd, cidx, k)


def flat_search_streaming(host, n, queries, pen_doc, dist_range=None,
                          *, k: int, metric: str = "l2",
                          chunk: int = 65536):
    """Exact scan over a HOST-resident corpus (disk tier: no device
    mirror, reference vector/rocksdb_raw_vector.cc): stream fixed-shape
    chunks through the device and merge a running top-k.  `host` is any
    row-sliceable float32 array-like (np.memmap included)."""
    b = queries.shape[0]
    best_d = jnp.full((b, k), BIG, jnp.float32)
    best_i = jnp.full((b, k), jnp.int32(-1))
    if n <= 0:
        return best_d, best_i
    # quantize the compiled chunk shape to a fixed ladder: chunk = n
    # exactly would force a fresh XLA compile per corpus size (the
    # untrained disk-tier path searches after every add)
    q = 1024
    while q < n and q < chunk:
        q *= 4
    chunk = min(chunk, q)
    pen_np = np.asarray(pen_doc)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        rows_np = np.zeros((chunk, host.shape[1]), np.float32)
        rows_np[: e - s] = host[s:e]
        pen_c = np.full((chunk,), BIG, np.float32)
        m = pen_np[s: min(e, pen_np.size)]
        pen_c[: m.size] = m
        best_d, best_i = _stream_chunk(
            jnp.asarray(rows_np),
            jnp.asarray(np.sum(rows_np.astype(np.float64) ** 2,
                               axis=1).astype(np.float32)),
            jnp.asarray(pen_c), jnp.int32(s), best_d, best_i, queries,
            dist_range, k=k, metric=metric)
    return best_d, best_i
