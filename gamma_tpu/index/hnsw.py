"""HNSW-equivalent: a batched navigable neighbor-graph index.

Reference: index/impl/hnswlib/gamma_index_hnswlib.{h,cc} — vendored
hnswlib graph ANN over MemoryRawVector with per-query efSearch.

Design substitution (documented): hnswlib's insert-time hierarchical graph
construction is a pointer-chasing, inherently sequential algorithm with no
efficient accelerator mapping.  This equivalent keeps the capability
contract (graph ANN, efSearch/efConstruction/nlinks knobs, realtime adds,
markDelete semantics) but re-derives both phases as batched matmul work:

  * BUILD: a kNN graph from a chunked self-join (one [chunk x d x N]
    matmul per chunk + topk.select_min_k), then α-pruned
    (Vamana/DiskANN-style relative-neighborhood pruning — the batched
    analog of hnswlib's `getNeighborsByHeuristic2`), all on device.
  * SEARCH: multi-entry beam search with a FIXED iteration count — each
    step gathers the beam's neighbor lists, scores candidates with one
    batched contraction, dedups by id-sort, and keeps the best efSearch
    via top-k.  HNSW's upper layers are replaced by a strided
    entry-point sample (one small matmul) serving the same purpose:
    dropping the beam near the target basin.
  * REALTIME: the graph covers vids [0, n_nodes); newer vids up to the
    store's flushed count are covered by a fused flat scan over the tail,
    merged into the beam results — search-during-insert stays exact while
    graph rebuilds happen in batches (growth-triggered, amortized
    O(N log N)-ish total work).  Deletes tombstone via the penalty array
    (hnswlib markDelete analog): edges through deleted nodes remain
    navigable.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gamma_tpu.config import MetricType, SearchParams
from gamma_tpu.index.model import RetrievalModel
from gamma_tpu.index.registry import register_model
from gamma_tpu.ops.distances import (BIG, l2_norms, pairwise_dist,
                                     pairwise_l2)
from gamma_tpu.ops.flat_scan import flat_search
from gamma_tpu.ops.topk import merge_topk, select_min_k
from gamma_tpu.vector.raw_store import RawVectorStore

NODE_PAD = 8192
BUILD_CHUNK = 4096
# inner (corpus) axis of the kNN self-join is tiled so the distance
# transient stays [BUILD_CHUNK, INNER_CHUNK] f32 = 1 GB regardless of N
# (the untiled [BUILD_CHUNK, N] tile is 160 GB at 10M rows)
INNER_CHUNK = 65536
# above this node count, growth rebuilds are INCREMENTAL (kNN of the new
# rows only + reverse-edge patch) instead of a full O(N²d) re-run
INCR_THRESHOLD = 262144
# above this corpus size, the kNN graph builds from a CLUSTERED partition
# self-join (two overlapping kmeans partitions, exact kNN inside each
# cluster) instead of the exact all-pairs join: O(N·capm·d) vs O(N²d) —
# at 5M rows the exact join is ~6 PFLOP (hours); the clustered build is
# ~20 TFLOP (minutes).  hnswlib's insert-time construction is likewise
# approximate.
CLUSTER_BUILD_N = 300_000
CLUSTER_TARGET = 3072       # mean rows per cluster
CLUSTER_CAP_X = 2.0         # member-slot headroom over the mean


def _ceil(n: int, q: int) -> int:
    return -(-n // q) * q


@functools.partial(jax.jit,
                   static_argnames=("r", "metric", "n_chunks", "n_inner",
                                    "ic"))
def _build_knn(x, norms, valid_pen, row0, *, r, metric, n_chunks,
               n_inner, ic):
    """Exact kNN of x[row0 : row0 + n_chunks*BUILD_CHUNK) against ALL of
    x [N_pad, d] (N_pad = n_inner*ic), both axes tiled with a running
    top-k merge so no [chunk, N] transient materializes (the untiled
    form is 160 GB at 10M rows).  valid_pen [N_pad] poisons padding
    rows.  → links [rows, r] i32."""

    def one(ci):
        s = row0 + ci * BUILD_CHUNK
        xc = jax.lax.dynamic_slice_in_dim(x, s, BUILD_CHUNK, axis=0)
        rows = s + jnp.arange(BUILD_CHUNK, dtype=jnp.int32)[:, None]

        def inner(ii, carry):
            bd, bi = carry
            t = ii * ic
            xi = jax.lax.dynamic_slice_in_dim(x, t, ic, axis=0)
            ni = jax.lax.dynamic_slice_in_dim(norms, t, ic)
            pi = jax.lax.dynamic_slice_in_dim(valid_pen, t, ic)
            d = pairwise_dist(xc, xi, metric,
                              None if metric == "ip" else ni)
            d = d + pi[None, :]
            ids = t + jnp.arange(ic, dtype=jnp.int32)
            d = jnp.where(ids[None, :] == rows, BIG, d)   # drop self
            vals, idx = select_min_k(d, r + 1)
            return merge_topk(bd, bi, vals,
                              jnp.take(ids, jnp.maximum(idx, 0)), r + 1)

        init = (jnp.full((BUILD_CHUNK, r + 1), BIG, jnp.float32),
                jnp.full((BUILD_CHUNK, r + 1), -1, jnp.int32))
        vals, idx = jax.lax.fori_loop(0, n_inner, inner, init)
        vals, idx = vals[:, :r], idx[:, :r]
        return jnp.where(vals >= BIG, -1, idx).astype(jnp.int32)

    return jax.lax.map(one, jnp.arange(n_chunks)).reshape(-1, r)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _assign_top2(x, cents, cnorms, *, chunk=8192):
    """Top-2 cluster assignment per row, chunked.  → [N_pad, 2] i32."""
    def one(xc):
        d = pairwise_l2(xc.astype(jnp.float32), cents, cnorms)
        _, idx = jax.lax.top_k(-d, 2)
        return idx.astype(jnp.int32)

    return jax.lax.map(
        one, x.reshape(-1, chunk, x.shape[1])).reshape(-1, 2)


@functools.partial(jax.jit, static_argnames=("ncl", "capm"))
def _group_members(assign, valid, *, ncl, capm):
    """Invert row→cluster into member lists [ncl, capm] i32 (-1 pad);
    rows past a cluster's capm slots are dropped (they still appear as
    members of their OTHER partition's cluster)."""
    n = assign.shape[0]
    li = jnp.where(valid, assign, ncl).astype(jnp.int32)
    order = jnp.argsort(li, stable=True).astype(jnp.int32)
    sl = jnp.take(li, order)
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), sl[1:] != sl[:-1]])
    run_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    rank = idx - run_start
    members = jnp.full((ncl + 1, capm), -1, jnp.int32)
    members = members.at[jnp.minimum(sl, ncl), rank].set(
        order, mode="drop")          # rank >= capm → OOB column, dropped
    return members[:ncl]


@functools.partial(jax.jit, static_argnames=("r", "metric", "ncl"))
def _cluster_pass(x, norms, members, *, r, metric, ncl):
    """Exact kNN inside each cluster: one [capm, capm] self-join per
    cluster, results scattered back by global row id.
    → (vals [N_pad, r+1] f32, ids [N_pad, r+1] i32)."""
    n_pad = x.shape[0]
    capm = members.shape[1]

    def body(ci, carry):
        gv, gi = carry
        mlist = jax.lax.dynamic_slice_in_dim(members, ci, 1, axis=0)[0]
        msafe = jnp.maximum(mlist, 0)
        rows = jnp.take(x, msafe, axis=0)
        nr = jnp.take(norms, msafe)
        d = pairwise_dist(rows, rows, metric,
                          None if metric == "ip" else nr)
        d = d + jnp.where(mlist < 0, BIG, 0.0)[None, :]
        ii = jnp.arange(capm, dtype=jnp.int32)
        d = jnp.where(ii[None, :] == ii[:, None], BIG, d)   # drop self
        vals, idx = select_min_k(d, r + 1)
        gids = jnp.take(mlist, jnp.maximum(idx, 0))
        gids = jnp.where(vals >= BIG, -1, gids)
        vals = jnp.minimum(vals, BIG)
        tgt = jnp.where(mlist < 0, 0x40000000, mlist)
        gv = gv.at[tgt].set(vals, mode="drop")
        gi = gi.at[tgt].set(gids, mode="drop")
        return gv, gi

    init = (jnp.full((n_pad, r + 1), BIG, jnp.float32),
            jnp.full((n_pad, r + 1), -1, jnp.int32))
    return jax.lax.fori_loop(0, ncl, body, init)


@functools.partial(jax.jit, static_argnames=("r",))
def _merge_dedup(v1, i1, v2, i2, *, r):
    """Merge two candidate sets per row, dedup by id, keep best r."""
    av = jnp.concatenate([v1, v2], axis=1)
    ai = jnp.concatenate([i1, i2], axis=1)
    order = jnp.argsort(ai, axis=1)
    si = jnp.take_along_axis(ai, order, axis=1)
    sv = jnp.take_along_axis(av, order, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((ai.shape[0], 1), bool), si[:, 1:] == si[:, :-1]],
        axis=1)
    sv = jnp.where(dup | (si < 0), BIG, sv)
    nv, sel = jax.lax.top_k(-sv, r)
    nv = -nv
    out_i = jnp.take_along_axis(si, sel, axis=1)
    return jnp.where(nv >= BIG, -1, out_i).astype(jnp.int32), nv


@jax.jit
def _patch_reverse(links, new_ids, new_out, slots):
    """Insert each new node into ONE reverse slot of every out-neighbor
    (device scatter; collisions overwrite — bounded degree, recency-
    biased, the batched analog of hnswlib's capped bidirectional
    connect).  new_out [m, r] are the new nodes' out-links; slots [m]
    picks the reverse column per new node."""
    m, r = new_out.shape
    dst = jnp.where(new_out >= 0, new_out, 0x40000000).reshape(-1)
    src = jnp.broadcast_to(new_ids[:, None], (m, r)).reshape(-1)
    col = jnp.broadcast_to(slots[:, None], (m, r)).reshape(-1)
    return links.at[dst, col].set(src, mode="drop")


@functools.partial(jax.jit, static_argnames=("alpha",))
def _alpha_prune(nbr_vecs, nbr_ids, nbr_dists, *, alpha=1.2):
    """Vamana-style pruning, batched over nodes: drop neighbor j if a
    kept closer neighbor i satisfies alpha^2 * d2(i, j) < d2(node, j).
    Pruned entries become -1 (order preserved, closest first)."""
    r = nbr_ids.shape[1]
    diff = nbr_vecs[:, :, None, :] - nbr_vecs[:, None, :, :]
    dnn = jnp.sum(diff * diff, axis=-1)                  # [n, r, r]

    def body(j, keep):
        dom = keep & (dnn[:, :, j] * (alpha * alpha)
                      < nbr_dists[:, j][:, None])
        alive = jnp.logical_not(jnp.any(dom, axis=1))
        alive = alive & (nbr_ids[:, j] >= 0)
        return keep.at[:, j].set(alive)

    keep0 = jnp.zeros(nbr_ids.shape, bool).at[:, 0].set(
        nbr_ids[:, 0] >= 0)
    keep = jax.lax.fori_loop(1, r, body, keep0)
    return jnp.where(keep, nbr_ids, -1)


@functools.partial(
    jax.jit, static_argnames=("ef", "k", "iters", "metric", "entry_stride",
                              "fanout"))
def _beam_search(vectors, vec_norms, links, queries, penalty,
                 *, ef, k, iters, metric, entry_stride, fanout=8):
    """Batched BEST-FIRST beam search with expansion flags — the batched
    form of hnswlib's searchBaseLayer: per step, only the `fanout` best
    UNEXPANDED beam entries expand (gather their neighbor lists + one
    batched scoring contraction); an expanded flag rides every beam slot
    so dedup keeps the expanded copy and no node is ever re-expanded.
    An earlier variant re-gathered and re-scored ALL ef*width candidates
    every step ([B, ef*44, d] f32 gather + [B, ~2900] sort x16 iters) —
    the flagged form does ~7x less gather and sort work per step AND
    explores more nodes (486 -> several-k QPS at 200k nodes, measured
    in bench.py's secondary section)."""
    b = queries.shape[0]

    entries = jnp.arange(0, vectors.shape[0], entry_stride,
                         dtype=jnp.int32)
    ed = pairwise_dist(queries, vectors[::entry_stride], metric,
                       None if metric == "ip"
                       else vec_norms[::entry_stride])
    ed = ed + penalty[::entry_stride][None, :]
    m = min(ef, entries.shape[0])
    nd, eidx = jax.lax.top_k(-ed, m)
    beam_d = -nd
    beam_i = jnp.where(beam_d >= BIG, -1, jnp.take(entries, eidx))
    if m < ef:
        beam_d = jnp.pad(beam_d, ((0, 0), (0, ef - m)),
                         constant_values=BIG)
        beam_i = jnp.pad(beam_i, ((0, 0), (0, ef - m)),
                         constant_values=-1)
    beam_x = jnp.zeros((b, ef), jnp.int32)          # 1 = expanded

    qf = queries.astype(jnp.float32)
    qn = jnp.sum(qf * qf, axis=-1, keepdims=True)
    rows = jnp.arange(b, dtype=jnp.int32)[:, None]

    def step(_, carry):
        beam_d, beam_i, beam_x = carry
        # pick the fanout best unexpanded live entries
        sel_d = jnp.where((beam_x > 0) | (beam_i < 0), BIG, beam_d)
        _, sel = jax.lax.top_k(-sel_d, fanout)                  # [B, F]
        sel_i = jnp.take_along_axis(beam_i, sel, axis=1)
        sel_dead = jnp.take_along_axis(sel_d, sel, axis=1) >= BIG
        beam_x = beam_x.at[rows, sel].set(1)
        nbrs = jnp.take(links, jnp.maximum(sel_i, 0), axis=0)
        nbrs = jnp.where((sel_i[..., None] >= 0)
                         & ~sel_dead[..., None], nbrs, -1)
        cand = nbrs.reshape(b, -1)                       # [B, F*width]
        safe = jnp.maximum(cand, 0)
        vecs = jnp.take(vectors, safe, axis=0).astype(jnp.float32)
        if metric == "ip":
            cd = -jnp.einsum("bd,bcd->bc", qf, vecs,
                             preferred_element_type=jnp.float32)
        else:
            cd = (qn - 2.0 * jnp.einsum(
                "bd,bcd->bc", qf, vecs,
                preferred_element_type=jnp.float32)
                + jnp.take(vec_norms, safe))
        cd = jnp.minimum(cd + jnp.take(penalty, safe), BIG)
        cd = jnp.where(cand < 0, BIG, cd)
        alld = jnp.concatenate([beam_d, cd], axis=1)
        alli = jnp.concatenate([beam_i, cand], axis=1)
        allx = jnp.concatenate(
            [beam_x, jnp.zeros(cd.shape, jnp.int32)], axis=1)
        # dedup: sort by (id, expanded-first) so the kept copy of a
        # duplicated id is the EXPANDED one (else it would re-expand)
        key = jnp.where(alli < 0, jnp.int32(0x7fffffff),
                        alli * 2 + (1 - allx))
        order = jnp.argsort(key, axis=1)
        si = jnp.take_along_axis(alli, order, axis=1)
        sd = jnp.take_along_axis(alld, order, axis=1)
        sx = jnp.take_along_axis(allx, order, axis=1)
        dup = jnp.concatenate(
            [jnp.zeros((b, 1), bool), si[:, 1:] == si[:, :-1]], axis=1)
        sd = jnp.where(dup, BIG, sd)
        nd2, sel2 = jax.lax.top_k(-sd, ef)
        nd2 = -nd2
        ni = jnp.where(nd2 >= BIG, -1,
                       jnp.take_along_axis(si, sel2, axis=1))
        nx = jnp.where(nd2 >= BIG, 0,
                       jnp.take_along_axis(sx, sel2, axis=1))
        return nd2, ni, nx

    beam_d, beam_i, _ = jax.lax.fori_loop(
        0, iters, step, (beam_d, beam_i, beam_x))
    out_d = beam_d[:, :k]
    return out_d, jnp.where(out_d >= BIG, -1, beam_i[:, :k])


@register_model("HNSW")
class HNSWIndex(RetrievalModel):
    model_name = "HNSW"
    penalty_space = "row"

    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(raw_store, params)
        p = params or {}
        self.nlinks = int(p.get("nlinks", 32))          # hnswlib M*2
        self.ef_construction = int(p.get("efConstruction", 64))
        self.ef_search_default = int(p.get("efSearch", 64))
        self.beam_fanout = int(p.get("beam_fanout", 8))
        self.beam_iters = p.get("beam_iters")   # None = auto from ef
        self.alpha = float(p.get("alpha", 1.2))
        mt = str(p.get("metric_type", "L2")).upper()
        self.default_metric = (MetricType.INNER_PRODUCT
                               if mt in ("IP", "INNERPRODUCT",
                                         "INNER_PRODUCT")
                               else MetricType.L2)
        # link width = out-edges + reverse edges + long-range edges.
        # Reverse edges make the graph undirected (no in-degree-0 nodes;
        # hnswlib also keeps bidirectional links).  Long-range random
        # edges connect the components a pure kNN graph leaves isolated
        # on clustered data — the role of HNSW's upper layers (measured:
        # without them, recall saturates at the probability that an
        # entry point lands in the query's cluster).
        self.n_reverse = max(4, self.nlinks // 2)
        self.n_long = max(4, self.nlinks // 8)
        width = self.nlinks + self.n_reverse + self.n_long
        self.links = jnp.full((NODE_PAD, width), -1, jnp.int32)
        self.n_nodes = 0        # graph covers vids [0, n_nodes)

    def trained(self) -> bool:
        return True             # graph ANN has no offline training phase

    def train(self, x) -> None:
        pass

    def _grow_links(self, need: int) -> None:
        cap = self.links.shape[0]
        if need <= cap:
            return
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        self.links = jnp.pad(self.links, ((0, new_cap - cap), (0, 0)),
                             constant_values=-1)

    def _padded_corpus(self, end: int):
        """Device corpus padded for the tiled self-join: n_pad is a
        multiple of the inner chunk ic (= min(INNER_CHUNK, padded end))."""
        ic = min(INNER_CHUNK, _ceil(max(end, BUILD_CHUNK), BUILD_CHUNK))
        n_pad = _ceil(max(end, BUILD_CHUNK), ic)
        x = jnp.zeros((n_pad, self.store.d), self.store.device.dtype)
        x = jax.lax.dynamic_update_slice(
            x, self.store.device[: min(end, self.store.device.shape[0])],
            (0, 0))
        norms = jnp.pad(self.store.device_norms[:end],
                        (0, n_pad - end))
        valid_pen = jnp.where(jnp.arange(n_pad) < end, 0.0, BIG
                              ).astype(jnp.float32)
        return x, norms, valid_pen, n_pad, ic

    def _clustered_knn(self, x, norms, end: int, metric: str
                       ) -> jnp.ndarray:
        """Approximate kNN graph from two overlapping kmeans partitions:
        each row's candidates are the exact kNN inside its top-1 and
        top-2 clusters, merged + deduped.  O(N·capm·d) — the only build
        that finishes at multi-million rows (exact is O(N²d))."""
        from gamma_tpu.ops import kmeans as km
        r = self.nlinks
        ncl = max(64, _ceil(end, CLUSTER_TARGET) // CLUSTER_TARGET)
        capm = _ceil(min(16384, int(CLUSTER_CAP_X * end / ncl) + 64), 128)
        stride = max(1, end // min(end, 48 * ncl))
        sample = x[:end:stride].astype(jnp.float32)
        cents, _ = km.kmeans(sample, ncl, iters=4, seed=end)
        cnorms = l2_norms(cents)
        n_pad = x.shape[0]
        chunk = n_pad
        for c in (8192, 4096, 2048, 1024, 512, 256, 128):
            if n_pad % c == 0:
                chunk = c
                break
        assign2 = _assign_top2(x, cents, cnorms, chunk=chunk)  # [n_pad, 2]
        valid = jnp.arange(n_pad) < end
        passes = []
        for pi in range(2):
            members = _group_members(assign2[:, pi], valid,
                                     ncl=ncl, capm=capm)
            passes.append(_cluster_pass(x, norms, members,
                                        r=r, metric=metric, ncl=ncl))
        ids, _ = _merge_dedup(passes[0][0], passes[0][1],
                              passes[1][0], passes[1][1], r=r)
        return ids

    def _knn_out_links(self, x, norms, valid_pen, n_pad, ic, row0: int,
                       end: int, metric: str) -> jnp.ndarray:
        """α-pruned out-links for rows [row0, end) (row0 chunk-aligned)."""
        if end > CLUSTER_BUILD_N and row0 == 0:
            links = self._clustered_knn(x, norms, end, metric)
        else:
            n_chunks = _ceil(end - row0, BUILD_CHUNK) // BUILD_CHUNK
            links = _build_knn(x, norms, valid_pen, jnp.int32(row0),
                               r=self.nlinks, metric=metric,
                               n_chunks=n_chunks, n_inner=n_pad // ic,
                               ic=ic)
        if self.alpha > 1.0 and metric == "l2":
            # prune in chunks to bound the [c, r, r] intermediate
            pruned = []
            for s in range(0, end - row0, BUILD_CHUNK):
                e = min(end - row0, s + BUILD_CHUNK)
                ids = links[s:e]
                node = jax.lax.dynamic_slice_in_dim(
                    x, row0 + s, e - s, axis=0).astype(jnp.float32)
                nbr = jnp.take(x, jnp.maximum(ids, 0),
                               axis=0).astype(jnp.float32)
                nd = jnp.sum((node[:, None, :] - nbr) ** 2, axis=-1)
                nd = jnp.where(ids >= 0, nd, BIG)
                pruned.append(_alpha_prune(nbr, ids, nd,
                                           alpha=self.alpha))
            links = jnp.concatenate(pruned, axis=0)
        return links[: end - row0]

    def _bulk_build(self, end: int) -> None:
        metric = ("ip" if self.default_metric == MetricType.INNER_PRODUCT
                  else "l2")
        x, norms, valid_pen, n_pad, ic = self._padded_corpus(end)
        links = self._knn_out_links(x, norms, valid_pen, n_pad, ic,
                                    0, end, metric)
        # reverse edges (undirected graph: no in-degree-0 nodes)
        out_np = np.asarray(links[:end])
        r = self.nlinks
        src = np.repeat(np.arange(end, dtype=np.int32), r)
        dst = out_np.reshape(-1)
        ok = dst >= 0
        src, dst = src[ok], dst[ok]
        # nodes nobody lists (in-degree 0) get priority for the capped
        # reverse slots of their own out-neighbors
        indeg = np.bincount(dst, minlength=end)
        stranded = indeg[src] == 0
        order = np.lexsort((~stranded, dst))
        src, dst = src[order], dst[order]
        starts = np.zeros(dst.size, np.int64)
        bnd = np.flatnonzero(np.diff(dst)) + 1
        starts[bnd] = bnd
        np.maximum.accumulate(starts, out=starts)
        rank = np.arange(dst.size) - starts
        keep = rank < self.n_reverse
        rev = np.full((end, self.n_reverse), -1, np.int32)
        rev[dst[keep], rank[keep]] = src[keep]
        # long-range edges: a random permutation per slot (deterministic)
        lrng = np.random.default_rng(end)
        longe = np.stack([lrng.permutation(end).astype(np.int32)
                          for _ in range(self.n_long)], axis=1)
        longe[longe == np.arange(end, dtype=np.int32)[:, None]] = -1
        full = np.concatenate([out_np, rev, longe], axis=1)
        # final sweep: force-link any node still unreferenced
        for _ in range(4):
            indeg = np.bincount(full[full >= 0].ravel(), minlength=end)
            left = np.flatnonzero(indeg == 0)
            if left.size == 0:
                break
            for t, j in enumerate(left):
                nbrs = out_np[j][out_np[j] >= 0]
                if nbrs.size == 0:
                    continue
                i = int(nbrs[t % nbrs.size])
                full[i, r + (t % self.n_reverse)] = j
        self._grow_links(end)
        self.links = self.links.at[:end].set(jnp.asarray(full))
        self.n_nodes = end

    def _incremental_build(self, end: int) -> None:
        """Merge rows [n_nodes, end) into the existing graph WITHOUT the
        full O(N²d) re-run (hnswlib likewise inserts incrementally):
        kNN of the new rows against the whole corpus gives their
        out-links; each new node is then scattered into one reverse slot
        of every out-neighbor so old nodes can reach it."""
        metric = ("ip" if self.default_metric == MetricType.INNER_PRODUCT
                  else "l2")
        row0 = (self.n_nodes // BUILD_CHUNK) * BUILD_CHUNK
        x, norms, valid_pen, n_pad, ic = self._padded_corpus(end)
        out = self._knn_out_links(x, norms, valid_pen, n_pad, ic,
                                  row0, end, metric)       # [m, r]
        m = end - row0
        r = self.nlinks
        # long-range edges keep the small-world shortcuts for new rows
        lrng = np.random.default_rng(end)
        longe = lrng.integers(0, end, size=(m, self.n_long)).astype(
            np.int32)
        ids_np = np.arange(row0, end, dtype=np.int32)
        longe[longe == ids_np[:, None]] = -1
        rev = np.full((m, self.n_reverse), -1, np.int32)
        full = jnp.concatenate(
            [out, jnp.asarray(rev), jnp.asarray(longe)], axis=1)
        self._grow_links(end)
        self.links = self.links.at[row0:end].set(full)
        new_ids = jnp.asarray(ids_np)
        slots = jnp.asarray(r + (ids_np % self.n_reverse))
        self.links = _patch_reverse(self.links, new_ids, out, slots)
        self.n_nodes = end

    def add(self, x, vids: np.ndarray, docids: np.ndarray) -> None:
        """Growth-triggered batch rebuild; the tail between rebuilds is
        covered by the fused flat scan in search()."""
        hi = int(np.max(vids)) + 1 if len(vids) else 0
        # only the rebuild EXTENT is clamped to the flushed device mirror;
        # the watermark must advance unconditionally or the pump loop
        # (`while indexed_count < store.n`) livelocks when docs land
        # between flush_device() and the pump.  Rows in [flushed, hi) are
        # covered at search time by the flat tail scan once they flush.
        build_hi = min(hi, self.store.flushed)
        if build_hi > max(4 * self.nlinks, int(self.n_nodes * 1.25)):
            if build_hi > CLUSTER_BUILD_N:
                # at multi-100k scale a FULL clustered rebuild is
                # O(N·capm·d) — cheaper than exact new-vs-all and keeps
                # graph quality; amortized over 1.25x growth steps
                self._bulk_build(build_hi)
            elif self.n_nodes >= INCR_THRESHOLD:
                self._incremental_build(build_hi)
            else:
                self._bulk_build(build_hi)
        self.indexed_count = max(self.indexed_count, hi)

    def delete(self, vids) -> None:
        pass   # deletes arrive via the penalty array (markDelete analog)

    def search(self, queries, penalty_by_row, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        metric = self.metric_name(sp, self.default_metric)
        flushed = self.store.flushed
        if self.n_nodes < max(4 * self.nlinks, 256):
            d, rows = flat_search(self.store.device,
                                  self.store.device_norms, queries,
                                  penalty_by_row, dist_range,
                                  k=k, metric=metric)
            return d, rows, rows
        ef = max(int(sp.ef_search or self.ef_search_default), k)
        cap = min(self.links.shape[0], self.store.device.shape[0])
        pen = penalty_by_row
        if pen.shape[0] < cap:
            pen = jnp.pad(pen, (0, cap - pen.shape[0]),
                          constant_values=BIG)
        else:
            pen = pen[:cap]
        # graph rows only; the tail is handled by the flat merge below
        pen_graph = jnp.where(jnp.arange(cap) < self.n_nodes, pen, BIG)
        # entry density scales with ef: enough samples that every basin
        # of attraction gets one.  This bounds recall: on clustered data
        # the beam converges inside whatever basins the entries hit, so
        # recall@10 saturates at ~P(an entry lands in the query's
        # cluster) — about 1 - e^-2 = 0.865 at 2048 entries over a
        # 1024-cluster 200k corpus.  The entry phase is one small
        # matmul (~4 MB of strided rows), negligible next to the
        # beam's per-step neighbor gathers, so sample densely: 8192
        # entries puts the miss probability at e^-8 ~ 3e-4.
        stride = max(1, self.n_nodes // max(8192, 16 * ef))
        # best-first with visited flags: total expansions = iters*fanout;
        # ~1.5x ef expansions matches hnswlib's convergence point (its
        # loop pops until the candidate heap's best exceeds the ef-th
        # result), plus a log(N) floor so deep basins stay reachable
        fanout = self.beam_fanout
        iters = (int(self.beam_iters) if self.beam_iters
                 else max(int(np.ceil(np.log2(max(self.n_nodes, 2)))) - 4,
                          (3 * ef) // (2 * fanout) + 2))
        d, ids = _beam_search(
            self.store.device[:cap], self.store.device_norms[:cap],
            self.links[:cap], queries, pen_graph, ef=ef, k=k,
            iters=iters, metric=metric, entry_stride=stride,
            fanout=fanout)
        if flushed > self.n_nodes:
            # realtime tail: exact scan of [n_nodes, flushed)
            tail_pen = jnp.where(jnp.arange(cap) >= self.n_nodes, pen,
                                 BIG)
            td, tids = flat_search(self.store.device[:cap],
                                   self.store.device_norms[:cap],
                                   queries, tail_pen, dist_range,
                                   k=k, metric=metric)
            d, ids = merge_topk(d, ids, td, tids, k)
        return d, ids, ids

    # ---- persistence ----

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, f"{self.store.name}.hnsw.npz"),
                 links=np.asarray(self.links[: self.n_nodes]),
                 n_nodes=np.array(self.n_nodes))

    def load(self, path: str) -> int:
        f = os.path.join(path, f"{self.store.name}.hnsw.npz")
        if not os.path.exists(f):
            return 0
        z = np.load(f)
        n = int(z["n_nodes"])
        self._grow_links(max(n, 1))
        if n:
            self.links = self.links.at[:n].set(jnp.asarray(z["links"]))
        self.n_nodes = n
        self.indexed_count = n
        return n

    def mem_bytes(self) -> int:
        return int(self.links.size * 4)
