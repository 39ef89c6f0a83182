"""On-device k-means (Lloyd's algorithm).

The reference delegates coarse-centroid + PQ-codebook training to
faiss::IndexIVFPQ::train (gamma_index_ivfpq.cc:346, k-means on CPU/BLAS).
Here we own it: each Lloyd iteration is two matmuls — the assignment
(n x d x k distance matrix, chunked over n to bound memory) and the
centroid update (one-hot^T @ x).  The whole training loop runs under one
jit with `lax.fori_loop`, so XLA pipelines chunk DMA with compute.

Batched variant (`kmeans_batched`) vmaps over independent subspaces — this
is how PQ trains all M codebooks simultaneously instead of faiss's
sequential per-subquantizer loop.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from gamma_tpu.ops.distances import pairwise_l2, l2_norms
from gamma_tpu.utils.devmem import scaled_budget


def _pad_rows(x: jnp.ndarray, multiple: int) -> Tuple[jnp.ndarray, int]:
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    return x, n


def _assign_chunked(x: jnp.ndarray, cents: jnp.ndarray, chunk: int) -> jnp.ndarray:
    """argmin_k ||x - c_k||^2, chunked over rows; x must be row-padded."""
    cn = l2_norms(cents)
    n = x.shape[0]

    def one_chunk(xc):
        d = pairwise_l2(xc, cents, cn)
        return jnp.argmin(d, axis=-1).astype(jnp.int32)

    xs = x.reshape(n // chunk, chunk, x.shape[1])
    return jax.lax.map(one_chunk, xs).reshape(n)


def _update_centroids(x, assign, k, old_cents):
    """sums via one-hot matmul; empty clusters keep their centroid."""
    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)       # [n, k]
    sums = jax.lax.dot_general(
        onehot, x.astype(jnp.float32),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )                                                            # [k, d]
    counts = jnp.sum(onehot, axis=0)                             # [k]
    safe = jnp.maximum(counts, 1.0)[:, None]
    new = sums / safe
    return jnp.where(counts[:, None] > 0, new, old_cents), counts


def _rebalance(cents, counts):
    """Split the biggest clusters into the smallest slots (a
    generalization of faiss Clustering's empty-cluster split): the j-th
    smallest-count slot moves to the j-th biggest cluster's centroid
    with a tiny symmetric split perturbation, when the donor holds >3x
    the victim's mass and >2x the mean.

    Why not empties only: a random-subset init leaves ~e^-rate of the
    data's natural modes with NO centroid; their mass piles onto a
    neighbor whose list grows to several times the mean (22.9k vs the
    4.9k mean at the 10M bench geometry — blowing up the posting cap,
    the SQ8 sidecar, and the cap_eff watermark trim), while NO slot is
    ever empty (redundant slots keep ~half a mode each).  Pairing
    smallest-with-biggest relocates exactly those redundant slots.
    Victim/donor prefixes are disjoint: at most k/2 slots can exceed
    2x the mean."""
    k = counts.shape[0]
    eps = 1e-3
    mean = jnp.mean(counts)
    asc = jnp.argsort(counts)                    # victims: smallest first
    desc = asc[::-1]                             # donors: biggest first
    vcount = jnp.take(counts, asc)
    dcount = jnp.take(counts, desc)
    ok = ((dcount > 3.0 * jnp.maximum(vcount, 1.0)) & (dcount > 2.0 * mean)
          | ((vcount <= 0) & (dcount > 3.0)))
    donor_cents = jnp.take(cents, desc, axis=0)
    # asc/desc are FULL permutations — scatter masks + one replacement
    # scatter, never two full .at[perm].set passes (the second would
    # rewrite every slot with pre-split values and undo the first)
    vmask = jnp.zeros((k,), jnp.bool_).at[asc].set(ok)
    dmask = jnp.zeros((k,), jnp.bool_).at[desc].set(ok)
    vrepl = jnp.zeros_like(cents).at[asc].add(
        jnp.where(ok[:, None], donor_cents * (1.0 + eps), 0.0))
    cents = jnp.where(dmask[:, None], cents * (1.0 - eps), cents)
    cents = jnp.where(vmask[:, None], vrepl, cents)
    return cents


# Full [n, k] distance matrix budget for the FLAT assignment, written
# for a 16 GiB device (utils/devmem.scaled_budget): under it the whole
# Lloyd loop is two plain matmuls per iteration, which compiles far
# faster than the chunked lax.map formulation (train latency at the
# SIFT1M train geometry is compile-dominated).
FLAT_DIST_BYTES = 5 << 30


@functools.partial(jax.jit,
                   static_argnames=("k", "iters", "chunk", "rebalance"))
def kmeans_fit(x: jnp.ndarray, init: jnp.ndarray, *, k: int,
               iters: int = 10, chunk: int = 4096, rebalance: int = 2):
    """Run `iters` Lloyd iterations from `init` [k, d].  Returns
    (centroids [k, d] f32, counts [k] f32).

    Rows of x beyond the caller's true count must be pre-masked by the
    caller (we train on exactly what we're given); x is padded internally
    to the chunk size with zero rows that are excluded via a weight mask.

    `rebalance` extra rounds split the biggest clusters into the
    smallest slots (see _rebalance) and re-Lloyd — this bounds the
    longest inverted list (= the posting cap and the per-probe scan
    cost) near the mean instead of several multiples of it.
    """
    xf = x.astype(jnp.float32)
    flat = x.shape[0] * k * 4 <= scaled_budget(FLAT_DIST_BYTES)
    xp, n_true = _pad_rows(xf, 8 if flat else chunk)
    n_pad = xp.shape[0]
    row_valid = (jnp.arange(n_pad) < n_true)

    def assign_to(cents):
        if flat:
            d = pairwise_l2(xp, cents, l2_norms(cents))
            return jnp.argmin(d, axis=-1).astype(jnp.int32)
        return _assign_chunked(xp, cents, chunk)

    def lloyd(cents):
        # poison padded rows to a virtual cluster by masking the one-hot
        assign = jnp.where(row_valid, assign_to(cents), -1)
        return _update_centroids(xp, assign, k, cents)

    cents = jax.lax.fori_loop(0, iters,
                              lambda _, c: lloyd(c)[0],
                              init.astype(jnp.float32))

    def reb_body(_, cents):
        c, counts = lloyd(cents)
        c = _rebalance(c, counts)
        c, _ = lloyd(c)
        return c

    if rebalance and k > 1:
        cents = jax.lax.fori_loop(0, rebalance, reb_body, cents)
    assign = jnp.where(row_valid, assign_to(cents), -1)
    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
    counts = jnp.sum(onehot, axis=0)
    return cents, counts


def kmeans(x, k: int, *, iters: int = 10, seed: int = 0,
           chunk: int = 4096, rebalance: int = 2):
    """Convenience wrapper: random-subset init (same policy as faiss) then fit."""
    n = x.shape[0]
    key = jax.random.PRNGKey(seed)
    perm = jax.random.permutation(key, n)
    init = jnp.take(x, perm[:k], axis=0).astype(jnp.float32)
    if k > n:  # degenerate; tile
        reps = -(-k // n)
        init = jnp.tile(x.astype(jnp.float32), (reps, 1))[:k]
    return kmeans_fit(x, init, k=k, iters=iters, chunk=chunk,
                      rebalance=rebalance)


# ---------------- batched (PQ) variant ----------------

@functools.partial(jax.jit, static_argnames=("k", "iters", "chunk"))
def kmeans_batched_fit(xs: jnp.ndarray, inits: jnp.ndarray, *, k: int,
                       iters: int = 10, chunk: int = 4096):
    """vmapped kmeans over a leading batch axis: xs [M, n, dsub],
    inits [M, k, dsub] → (centroids [M, k, dsub], counts [M, k]).

    rebalance=0: codebook training wants distortion-optimal centroids;
    list-length balance (the _rebalance motivation) has no meaning for
    PQ code assignments."""

    def one(x, init):
        return kmeans_fit(x, init, k=k, iters=iters, chunk=chunk,
                          rebalance=0)

    return jax.vmap(one)(xs, inits)
