"""Multi-chip sharding of inverted lists over a jax mesh.

This replaces the reference's multi-GPU path
(index/impl/gpu/gamma_index_ivfpq_gpu.cc:588-601 — faiss::IndexShards over
devices with a host-side merge) and, above it, Vearch's partition-server
sharding (benchs/README.md cluster section).  Instead of host merges, the
inverted lists, coarse centroids, and raw vectors are sharded over a mesh
axis ("l") and the merge rides collectives inside one jit (XLA hands them
to NCCL on GPUs):

  1. local coarse assign        — each shard scores queries against its own
                                  centroid shard (one matmul)
  2. global probe selection     — all_gather of per-shard top-nprobe coarse
                                  distances (tiny: [B, S*nprobe] f32) → the
                                  global nprobe-th distance is the selection
                                  threshold; each shard scans only its own
                                  lists that pass it (≤ local_probe each)
  3. local ADC scan + top-R     — identical math to the single-chip kernel,
                                  over [B, local_probe, cap] candidates
  4. collective merge           — all_gather of (dist, docid, vid) triples
                                  [B, S*R] → top-R (replaces the reference's
                                  OMP critical-section heap merge,
                                  gamma_index_ivfpq.cc:848-866)
  5. distributed exact rerank   — raw vectors are row-sharded on the same
                                  axis; each shard contributes its rows and
                                  a psum reassembles [B, R, d] for the
                                  exact-distance top-k

A second mesh axis ("q") shards the query batch (data parallelism); all
collectives above run only over "l", so adding "q" costs nothing.

Exactness: step 2 guarantees every globally-selected list is scanned as
long as no single shard owns more than `local_probe` of the global
top-nprobe lists.  With lists hashed across shards the default
local_probe = min(nprobe, 2*ceil(nprobe/S)+2) makes overflow vanishingly
rare; local_probe=nprobe restores the exact single-chip result.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gamma_tpu.ops import pq as pq_ops
from gamma_tpu.ops.distances import BIG, pairwise_ip, pairwise_l2
from gamma_tpu.ops.topk import select_min_k, topk_min
from gamma_tpu.ops.ivf_scan import _select_late, list_bias, sq_raw_dist_xla
from gamma_tpu.realtime.invert_index import IVFState

LIST_AXIS = "l"    # inverted lists + raw-vector rows sharded over this
QUERY_AXIS = "q"   # query batch sharded over this


def shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def build_mesh(n_list_shards: int, n_query_shards: int = 1,
               devices=None) -> Mesh:
    """A (q, l) mesh over the first n_query_shards * n_list_shards
    devices.  The shape follows the algorithm alone: the cards of one
    host are joined all to all, so no device order is preferred."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    need = n_list_shards * n_query_shards
    assert devices.size >= need, (
        f"mesh {n_query_shards}x{n_list_shards} needs {need} devices, "
        f"have {devices.size}")
    grid = devices[:need].reshape(n_query_shards, n_list_shards)
    return Mesh(grid, (QUERY_AXIS, LIST_AXIS))


class ShardedIVFPQ(NamedTuple):
    """Device-sharded index: lists (axis 0) and raw rows over LIST_AXIS."""

    state: IVFState            # codes/vids/docids sharded on axis 0
    centroids: jnp.ndarray     # [nlist_pad, d] sharded on axis 0
    cent_norms: jnp.ndarray    # [nlist_pad]
    codebooks: pq_ops.PQCodebooks   # replicated
    raw: jnp.ndarray           # [V_pad, d] row-sharded on axis 0
    v_per_shard: int           # static: raw rows per shard


def _pad_axis0(x: np.ndarray, size: int, fill=0) -> np.ndarray:
    if x.shape[0] == size:
        return x
    pad = np.full((size - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


def shard_ivfpq(mesh: Mesh, state: IVFState, centroids, cent_norms,
                codebooks: pq_ops.PQCodebooks, raw,
                cap_eff: int = 0) -> ShardedIVFPQ:
    """Distribute a single-chip index over the mesh.  Lists and raw rows
    are padded to a multiple of the shard count and split contiguously:
    shard i owns lists [i*L_loc, (i+1)*L_loc) and rows
    [i*V_loc, (i+1)*V_loc).  docids/vids stay GLOBAL ids.

    cap_eff (the caller's live-watermark ladder, IVFPQIndex._cap_eff)
    trims the sharded posting arrays to the live width ONCE at shard
    time — the per-shard scan, bias, and select then never touch the
    posting cap's ~3x presize slack."""
    s = mesh.shape[LIST_AXIS]
    nlist = int(state.nlist)
    l_pad = -(-nlist // s) * s
    v = int(np.asarray(raw).shape[0])
    v_pad = -(-v // s) * s

    codes_np = np.asarray(state.codes)
    vids_np = np.asarray(state.vids)
    docids_np = np.asarray(state.docids)
    if cap_eff and cap_eff < vids_np.shape[1]:
        codes_np = codes_np[:, :cap_eff]
        vids_np = vids_np[:, :cap_eff]
        docids_np = docids_np[:, :cap_eff]

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    row = P(LIST_AXIS)
    st = IVFState(
        codes=put(_pad_axis0(codes_np, l_pad),
                  P(LIST_AXIS, None, None)),
        vids=put(_pad_axis0(vids_np, l_pad, -1),
                 P(LIST_AXIS, None)),
        docids=put(_pad_axis0(docids_np, l_pad, -1),
                   P(LIST_AXIS, None)),
        lens=put(_pad_axis0(np.asarray(state.lens), l_pad), row),
    )
    cents = _pad_axis0(np.asarray(centroids, np.float32), l_pad)
    # padded centroid rows must never win coarse assign
    if l_pad > nlist:
        cents[nlist:] = 1e18
    cnorms = np.sum(cents.astype(np.float64) ** 2, axis=-1
                    ).astype(np.float32)
    cb = pq_ops.PQCodebooks(
        put(np.asarray(codebooks.codebooks), P()),
        put(np.asarray(codebooks.cb_norms), P()))
    raw_np = _pad_axis0(np.asarray(raw), v_pad)
    return ShardedIVFPQ(
        state=st,
        centroids=put(cents, P(LIST_AXIS, None)),
        cent_norms=put(cnorms, row),
        codebooks=cb,
        raw=put(raw_np, P(LIST_AXIS, None)),
        v_per_shard=v_pad // s,
    )


# ----------------------------------------------------------------------
# per-shard search body (runs inside shard_map)
# ----------------------------------------------------------------------

def _local_ivfpq_search(codes, vids, docids, lens, cents_l, cnorms_l,
                        cb, cb_norms, queries, penalty, live_n, raw_l,
                        queries_raw,
                        *, nprobe, local_probe, recall_num, k, metric,
                        rerank, v_per_shard,
                        use_validity=False, packed=False,
                        by_residual=True):
    codebooks = pq_ops.PQCodebooks(cb, cb_norms)
    l_loc = cents_l.shape[0]
    cap = codes.shape[1]
    m = min(nprobe, l_loc)
    p_loc = min(local_probe, m)

    # 1. local coarse distances
    if metric == "ip":
        dloc = -pairwise_ip(queries, cents_l)
    else:
        dloc = pairwise_l2(queries, cents_l, cnorms_l)
    local_ids = jnp.broadcast_to(
        jnp.arange(l_loc, dtype=jnp.int32)[None, :], dloc.shape)
    ld, lids = topk_min(dloc, local_ids, m)          # ascending

    # 2. global probe threshold (tiny all_gather)
    all_d = jax.lax.all_gather(ld, LIST_AXIS, axis=1, tiled=True)
    n_glob = min(nprobe, all_d.shape[1])
    gd, _ = topk_min(all_d, jnp.zeros_like(all_d, jnp.int32), n_glob)
    thr = gd[:, n_glob - 1]                          # nprobe-th smallest
    sel_d = ld[:, :p_loc]
    sel_ids = lids[:, :p_loc]
    sel_ok = sel_d <= thr[:, None]

    # 3. ADC scan of the selected local lists.  The per-(list, slot)
    # mask bias (in-length, tombstone, validity-or-penalty —
    # ops/ivf_scan.list_bias) is computed once over the LOCAL lists; ids
    # materialize late (after select) so no [B, P, cap] i32 gathers
    # exist on this path.
    bias_l = list_bias(docids, lens, cap,
                       penalty=penalty, live_n=live_n if use_validity
                       else None)
    codes_g = jnp.take(codes, sel_ids, axis=0)   # [B, P, cap, W]
    if packed:
        codes_g = pq_ops.unpack_nibbles(codes_g)
    if metric == "ip":
        lut = -pq_ops.ip_lut(codebooks, queries)     # [B, M, ksub]
        lut = jnp.broadcast_to(lut[:, None],
                               (lut.shape[0], p_loc) + lut.shape[1:])
        base = sel_d[..., None] if by_residual else 0.0  # -q.c
    elif by_residual:
        probed = jnp.take(cents_l, sel_ids, axis=0)  # [B, P, d]
        residual = queries.astype(jnp.float32)[:, None, :] - probed
        lut = pq_ops.l2_lut(codebooks, residual)
        base = 0.0
    else:
        lut = pq_ops.l2_lut(codebooks, queries)      # [B, M, ksub]
        lut = jnp.broadcast_to(lut[:, None],
                               (lut.shape[0], p_loc) + lut.shape[1:])
        base = 0.0
    dist = (pq_ops.adc_scan(lut, codes_g) + base
            + jnp.take(bias_l, sel_ids, axis=0))
    dist = dist + jnp.where(sel_ok, 0.0, BIG)[..., None]
    dist = jnp.minimum(dist, BIG)
    rd, rdoc, rvid = _select_late(dist, sel_ids, docids, vids, cap,
                                  recall_num)

    # 4. collective top-k merge (replaces OMP critical heap merge)
    rd = jax.lax.all_gather(rd, LIST_AXIS, axis=1, tiled=True)
    rdoc = jax.lax.all_gather(rdoc, LIST_AXIS, axis=1, tiled=True)
    rvid = jax.lax.all_gather(rvid, LIST_AXIS, axis=1, tiled=True)
    md, sel = topk_min(rd, jnp.broadcast_to(
        jnp.arange(rd.shape[1], dtype=jnp.int32)[None, :], rd.shape),
        recall_num)
    mdoc = jnp.take_along_axis(rdoc, sel, axis=1)
    mvid = jnp.take_along_axis(rvid, sel, axis=1)

    if not rerank:
        return md[:, :k], mdoc[:, :k], mvid[:, :k]

    # 5. distributed exact rerank — owner-computes + DISTANCE psum: each
    # candidate row lives on exactly one shard (contiguous row split);
    # that owner computes the exact distance locally and every other
    # shard contributes 0, so psumming the [B, R] distances reassembles
    # the exact result with d x less interconnect traffic than psumming the
    # [B, R, d] candidate rows (52 MB → 0.4 MB per step at B=1024,
    # R=100, d=128).  Rerank runs in the UNROTATED space (raw rows are
    # unrotated); with OPQ `queries` is rotated → use queries_raw.
    my = jax.lax.axis_index(LIST_AXIS)
    local_idx = mvid - my * v_per_shard
    in_range = (local_idx >= 0) & (local_idx < v_per_shard) & (mvid >= 0)
    rows_l = jnp.take(raw_l, jnp.clip(local_idx, 0, v_per_shard - 1),
                      axis=0).astype(jnp.float32)
    qf = queries_raw.astype(jnp.float32)[:, None, :]
    if metric == "ip":
        exact_l = -jnp.sum(qf * rows_l, axis=-1)
    else:
        diff = qf - rows_l
        exact_l = jnp.sum(diff * diff, axis=-1)
    exact = jax.lax.psum(jnp.where(in_range, exact_l, 0.0), LIST_AXIS)
    exact = jnp.where((md >= BIG) | (mvid < 0), BIG, exact)
    ed, eidx = topk_min(exact, jnp.broadcast_to(
        jnp.arange(md.shape[1], dtype=jnp.int32)[None, :], exact.shape), k)
    fdoc = jnp.take_along_axis(mdoc, eidx, axis=1)
    fvid = jnp.take_along_axis(mvid, eidx, axis=1)
    dead = ed >= BIG
    return ed, jnp.where(dead, -1, fdoc), jnp.where(dead, -1, fvid)


def sharded_ivfpq_search_fn(mesh: Mesh, *, nprobe: int, recall_num: int,
                            k: int, metric: str = "l2",
                            rerank: bool = True,
                            local_probe: Optional[int] = None,
                            v_per_shard: int,
                            use_validity: bool = False,
                            packed: bool = False,
                            by_residual: bool = True):
    """Build the jitted sharded search step for a fixed geometry.

    Returned fn: (sharded: ShardedIVFPQ, queries [B, d], penalty [N_cap])
    → (dists [B, k], docids [B, k], vids [B, k]), replicated over "l",
    sharded over "q".  Queries must be pre-sharded (or replicated) on the
    mesh; B must divide by the "q" axis size.
    """
    s = mesh.shape[LIST_AXIS]
    if local_probe is None:
        local_probe = min(nprobe, 2 * (-(-nprobe // s)) + 2)

    body = functools.partial(
        _local_ivfpq_search, nprobe=nprobe, local_probe=local_probe,
        recall_num=recall_num, k=k, metric=metric, rerank=rerank,
        v_per_shard=v_per_shard,
        use_validity=use_validity, packed=packed,
        by_residual=by_residual)

    lists3 = P(LIST_AXIS, None, None)
    lists2 = P(LIST_AXIS, None)
    lists1 = P(LIST_AXIS)
    rep = P()
    qrow = P(QUERY_AXIS, None)
    fn = shard_map(
        body, mesh,
        in_specs=(lists3, lists2, lists2, lists1,       # state
                  lists2, lists1,                       # centroids
                  rep, rep,                             # codebooks
                  qrow, rep, rep,                # queries, penalty, live_n
                  lists2,                               # raw rows
                  qrow),                                # queries_raw
        out_specs=(qrow, qrow, qrow))

    @jax.jit
    def search(sharded: ShardedIVFPQ, queries, penalty, queries_raw=None,
               live_n=0):
        st = sharded.state
        qr = queries if queries_raw is None else queries_raw
        return fn(st.codes, st.vids, st.docids, st.lens,
                  sharded.centroids, sharded.cent_norms,
                  sharded.codebooks.codebooks, sharded.codebooks.cb_norms,
                  queries, penalty, jnp.int32(live_n), sharded.raw, qr)

    return search


# ----------------------------------------------------------------------
# sharded residual-SQ8 capacity scan (no rerank: exact distances to the
# dequantized points come straight out of the list scan, so the
# collective merge is the LAST step — no psum reassembly of raw candidate rows)
# ----------------------------------------------------------------------

class ShardedIVFSQ(NamedTuple):
    """Capacity-tier serving snapshot: posting ids + SQ8 sidecar sharded
    over LIST_AXIS; the dequant affine (scale/off) is replicated."""

    vids: jnp.ndarray          # [nlist_pad, cap] i32, sharded axis 0
    docids: jnp.ndarray        # [nlist_pad, cap] i32, sharded axis 0
    lens: jnp.ndarray          # [nlist_pad] i32
    sq_codes: jnp.ndarray      # [nlist_pad, cap, d_pad] u8
    sq_norms: jnp.ndarray      # [nlist_pad, cap] f32
    sq_scale: jnp.ndarray      # [d] f32, replicated
    sq_off: jnp.ndarray        # [d] f32, replicated
    centroids: jnp.ndarray     # [nlist_pad, d] f32, sharded axis 0
    cent_norms: jnp.ndarray    # [nlist_pad] f32


def shard_ivfsq(mesh: Mesh, state: IVFState, centroids, cent_norms,
                sq_codes, sq_norms, sq_scale, sq_off,
                cap_eff: int = 0) -> ShardedIVFSQ:
    """Distribute the SQ8 capacity tier over the mesh (same contiguous
    list split as shard_ivfpq; docids/vids stay global)."""
    s = mesh.shape[LIST_AXIS]
    nlist = int(state.nlist)
    l_pad = -(-nlist // s) * s

    vids = np.asarray(state.vids)
    docids = np.asarray(state.docids)
    codes = np.asarray(sq_codes)
    norms = np.asarray(sq_norms)
    # effective width: the caller's ladder watermark, never wider than
    # the sidecar's own allocation (which may already be ladder-trimmed
    # below the 3x-slack posting cap)
    eff = min(cap_eff or codes.shape[1], codes.shape[1])
    if eff < vids.shape[1]:
        vids = vids[:, :eff]
        docids = docids[:, :eff]
    if eff < codes.shape[1]:
        codes = codes[:, :eff]
        norms = norms[:, :eff]

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    cents = _pad_axis0(np.asarray(centroids, np.float32), l_pad)
    if l_pad > nlist:
        cents[nlist:] = 1e18          # padded lists never win coarse
    cnorms = np.sum(cents.astype(np.float64) ** 2, axis=-1
                    ).astype(np.float32)
    return ShardedIVFSQ(
        vids=put(_pad_axis0(vids, l_pad, -1), P(LIST_AXIS, None)),
        docids=put(_pad_axis0(docids, l_pad, -1), P(LIST_AXIS, None)),
        lens=put(_pad_axis0(np.asarray(state.lens), l_pad),
                 P(LIST_AXIS)),
        sq_codes=put(_pad_axis0(codes, l_pad), P(LIST_AXIS, None, None)),
        sq_norms=put(_pad_axis0(norms, l_pad), P(LIST_AXIS, None)),
        sq_scale=put(np.asarray(sq_scale, np.float32), P()),
        sq_off=put(np.asarray(sq_off, np.float32), P()),
        centroids=put(cents, P(LIST_AXIS, None)),
        cent_norms=put(cnorms, P(LIST_AXIS)),
    )


def _local_ivfsq_search(vids, docids, lens, sq_codes, sq_norms,
                        sq_scale, sq_off, cents_l, cnorms_l,
                        queries, penalty, live_n,
                        *, nprobe, local_probe, k, metric,
                        use_validity=False):
    l_loc = cents_l.shape[0]
    cap = vids.shape[1]
    m = min(nprobe, l_loc)
    p_loc = min(local_probe, m)

    # 1-2. local coarse + global probe threshold (as _local_ivfpq_search)
    if metric == "ip":
        dloc = -pairwise_ip(queries, cents_l)
    else:
        dloc = pairwise_l2(queries, cents_l, cnorms_l)
    local_ids = jnp.broadcast_to(
        jnp.arange(l_loc, dtype=jnp.int32)[None, :], dloc.shape)
    ld, lids = topk_min(dloc, local_ids, m)
    all_d = jax.lax.all_gather(ld, LIST_AXIS, axis=1, tiled=True)
    n_glob = min(nprobe, all_d.shape[1])
    gd, _ = topk_min(all_d, jnp.zeros_like(all_d, jnp.int32), n_glob)
    thr = gd[:, n_glob - 1]
    sel_d = ld[:, :p_loc]
    sel_ids = lids[:, :p_loc]
    sel_ok = sel_d <= thr[:, None]

    # 3. exact SQ8 scan of the selected local lists (full distance —
    # the centroid term is folded in by sq_raw_dist_xla); ids
    # materialize late — no [B, P, cap] i32 gathers on this path
    bias_l = list_bias(docids, lens, cap,
                       penalty=penalty, live_n=live_n if use_validity
                       else None)
    dist = (sq_raw_dist_xla(sq_codes, sq_norms, sq_scale, sq_off,
                            cents_l, sel_ids, queries, metric=metric)
            + jnp.take(bias_l, sel_ids, axis=0))
    dist = dist + jnp.where(sel_ok, 0.0, BIG)[..., None]
    dist = jnp.minimum(dist, BIG)

    # 4. local top-k, then ONE collective merge — distances are
    # already exact, so k (not recall_num) rides the interconnect and
    # nothing is re-read afterwards
    rd, rdoc, rvid = _select_late(dist, sel_ids, docids, vids, cap, k)
    rd_g = jax.lax.all_gather(rd, LIST_AXIS, axis=1, tiled=True)
    rdoc_g = jax.lax.all_gather(rdoc, LIST_AXIS, axis=1, tiled=True)
    rvid_g = jax.lax.all_gather(rvid, LIST_AXIS, axis=1, tiled=True)
    md, sel = topk_min(rd_g, jnp.broadcast_to(
        jnp.arange(rd_g.shape[1], dtype=jnp.int32)[None, :], rd_g.shape),
        k)
    mdoc = jnp.take_along_axis(rdoc_g, sel, axis=1)
    mvid = jnp.take_along_axis(rvid_g, sel, axis=1)
    dead = md >= BIG
    return md, jnp.where(dead, -1, mdoc), jnp.where(dead, -1, mvid)


def sharded_ivfsq_search_fn(mesh: Mesh, *, nprobe: int, k: int,
                            metric: str = "l2",
                            local_probe: Optional[int] = None,
                            use_validity: bool = False):
    """Jitted sharded SQ8 capacity search for a fixed geometry.

    Returned fn: (sharded: ShardedIVFSQ, queries [B, d], penalty [N_cap])
    → (dists [B, k], docids [B, k], vids [B, k]).  Queries sharded over
    "q"; penalty doc-aligned and replicated."""
    s = mesh.shape[LIST_AXIS]
    if local_probe is None:
        local_probe = min(nprobe, 2 * (-(-nprobe // s)) + 2)

    body = functools.partial(
        _local_ivfsq_search, nprobe=nprobe, local_probe=local_probe,
        k=k, metric=metric, use_validity=use_validity)

    lists3 = P(LIST_AXIS, None, None)
    lists2 = P(LIST_AXIS, None)
    lists1 = P(LIST_AXIS)
    rep = P()
    qrow = P(QUERY_AXIS, None)
    fn = shard_map(
        body, mesh,
        in_specs=(lists2, lists2, lists1,            # vids/docids/lens
                  lists3, lists2, rep, rep,          # sq sidecar
                  lists2, lists1,                    # centroids
                  qrow, rep, rep),            # queries, penalty, live_n
        out_specs=(qrow, qrow, qrow))

    @jax.jit
    def search(sharded: ShardedIVFSQ, queries, penalty, live_n=0):
        return fn(sharded.vids, sharded.docids, sharded.lens,
                  sharded.sq_codes, sharded.sq_norms,
                  sharded.sq_scale, sharded.sq_off,
                  sharded.centroids, sharded.cent_norms,
                  queries, penalty, jnp.int32(live_n))

    return search


# ----------------------------------------------------------------------
# sharded DENSE scan (reconstruction mirror row-sharded over "l")
# ----------------------------------------------------------------------

class ShardedDense(NamedTuple):
    """Dense-mode serving snapshot: recon + raw rows sharded over "l"."""

    recon: jnp.ndarray        # [R_pad, d] sharded axis 0
    recon_norms: jnp.ndarray  # [R_pad]
    raw: jnp.ndarray          # [R_pad, d] sharded axis 0 (rerank source)
    rows_per_shard: int


def shard_dense(mesh: Mesh, recon, recon_norms, recon_valid,
                raw) -> ShardedDense:
    """Row-shard the dense-scan state.  recon_valid folds into the norms
    (adding BIG poisons padded/tombstoned rows)."""
    s = mesh.shape[LIST_AXIS]
    recon_np = np.asarray(recon)
    rows = recon_np.shape[0]
    r_pad = -(-rows // s) * s
    norms = (np.asarray(recon_norms, np.float32)
             + np.asarray(recon_valid, np.float32))
    raw_np = np.asarray(raw)
    raw_pad = np.zeros((r_pad, raw_np.shape[1]), raw_np.dtype)
    raw_pad[: min(rows, raw_np.shape[0])] = raw_np[:rows][:r_pad]

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    return ShardedDense(
        recon=put(_pad_axis0(recon_np, r_pad), P(LIST_AXIS, None)),
        recon_norms=put(_pad_axis0(norms, r_pad, np.float32(BIG)),
                        P(LIST_AXIS)),
        raw=put(raw_pad, P(LIST_AXIS, None)),
        rows_per_shard=r_pad // s,
    )


def sharded_dense_search_fn(mesh: Mesh, *, recall_num: int, k: int,
                            metric: str = "l2", rerank: bool = True,
                            rows_per_shard: int):
    """Dense scan over row-sharded reconstructions: local matmul scan +
    local select_min_k, collective merge, psum-gathered exact rerank.
    Queries sharded over "q".  penalty is vid-aligned and row-sharded
    over "l"."""

    def body(recon_l, bias_l, raw_l, queries, queries_raw):
        # bias_l = norms + validity + penalty pre-fused into ONE [R]
        # operand (built by `search` below as a tiny sharded kernel): a
        # single broadcast keeps the matmul → select chain from
        # materializing the [B, R] distance tile twice (see
        # ops/dense_scan.py)
        my = jax.lax.axis_index(LIST_AXIS)
        qf = queries.astype(jnp.float32)
        scale = -1.0 if metric == "ip" else -2.0
        cross = jax.lax.dot_general(
            (scale * qf).astype(recon_l.dtype), recon_l,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        dist = cross + bias_l[None, :]
        r = max(recall_num, k)
        rd, lidx = select_min_k(dist, r)
        lidx = jnp.maximum(lidx, 0)       # padding slots stay at BIG
        if metric != "ip":
            # the per-query ||q||² constant is rank-neutral — add it
            # AFTER selection (identical across shards, so the merged
            # values stay comparable)
            rd = rd + jnp.sum(qf * qf, -1, keepdims=True)
        rd = jnp.minimum(rd, BIG)
        gids = my * rows_per_shard + lidx
        rd_g = jax.lax.all_gather(rd, LIST_AXIS, axis=1, tiled=True)
        gid_g = jax.lax.all_gather(gids, LIST_AXIS, axis=1, tiled=True)
        md, sel = topk_min(rd_g, gid_g, r)
        if not rerank:
            out = md[:, :k]
            return out, jnp.where(out >= BIG, -1, sel[:, :k])
        # owner-computes exact rerank + DISTANCE psum (each candidate row
        # lives on one shard; psumming [B, R] masked distances replaces
        # psumming [B, R, d] rows — d x less interconnect traffic)
        local_idx = sel - my * rows_per_shard
        in_range = (local_idx >= 0) & (local_idx < rows_per_shard)
        rows = jnp.take(raw_l, jnp.clip(local_idx, 0, rows_per_shard - 1),
                        axis=0).astype(jnp.float32)
        qr = queries_raw.astype(jnp.float32)[:, None, :]
        if metric == "ip":
            exact_l = -jnp.sum(qr * rows, axis=-1)
        else:
            diff = qr - rows
            exact_l = jnp.sum(diff * diff, axis=-1)
        exact = jax.lax.psum(jnp.where(in_range, exact_l, 0.0), LIST_AXIS)
        exact = jnp.where(md >= BIG, BIG, exact)
        ed, eidx = topk_min(exact, jnp.broadcast_to(
            jnp.arange(r, dtype=jnp.int32)[None, :], exact.shape), k)
        evid = jnp.take_along_axis(sel, eidx, axis=1)
        return ed, jnp.where(ed >= BIG, -1, evid)

    rows2 = P(LIST_AXIS, None)
    qrow = P(QUERY_AXIS, None)
    fn = shard_map(body, mesh,
                   in_specs=(rows2, P(LIST_AXIS), rows2, qrow, qrow),
                   out_specs=(qrow, qrow))

    @jax.jit
    def search(sharded: ShardedDense, queries, penalty, queries_raw):
        # fold norms + penalty into one [R] bias (a tiny sharded kernel)
        # so the body's scan chain stays fused end-to-end
        if metric == "ip":
            bias = jnp.minimum(penalty, BIG)
        else:
            bias = jnp.minimum(sharded.recon_norms + penalty, BIG)
        return fn(sharded.recon, bias, sharded.raw, queries, queries_raw)

    return search


# ----------------------------------------------------------------------
# sharded brute-force (FLAT over row-sharded corpus)
# ----------------------------------------------------------------------

def sharded_flat_search_fn(mesh: Mesh, *, k: int, metric: str = "l2",
                           v_per_shard: int):
    """Exact search over a row-sharded corpus: local scan + collective
    merge."""

    def body(raw_l, norms_l, queries, penalty_l):
        my = jax.lax.axis_index(LIST_AXIS)
        # exact contract, as the single-device FLAT scan
        hp = jax.lax.Precision.HIGHEST
        if metric == "ip":
            d = -pairwise_ip(queries, raw_l, precision=hp)
        else:
            d = pairwise_l2(queries, raw_l, norms_l, precision=hp)
        d = jnp.minimum(d + penalty_l[None, :], BIG)
        gids = (my * v_per_shard
                + jnp.arange(v_per_shard, dtype=jnp.int32))
        ld, lid = topk_min(d, jnp.broadcast_to(gids[None, :], d.shape), k)
        ld = jax.lax.all_gather(ld, LIST_AXIS, axis=1, tiled=True)
        lid = jax.lax.all_gather(lid, LIST_AXIS, axis=1, tiled=True)
        return topk_min(ld, lid, k)

    lists2 = P(LIST_AXIS, None)
    qrow = P(QUERY_AXIS, None)
    fn = shard_map(body, mesh,
                   in_specs=(lists2, P(LIST_AXIS), qrow, P(LIST_AXIS)),
                   out_specs=(qrow, qrow))
    return jax.jit(fn)


# ----------------------------------------------------------------------
# data-parallel k-means (sharded training step)
# ----------------------------------------------------------------------

def sharded_kmeans_fit(mesh: Mesh, x, init, *, k: int, iters: int = 10):
    """Lloyd iterations with the train set row-sharded over the FULL mesh
    (both axes): each device assigns its rows and psums partial
    (sums, counts).  The device-count analog of the reference handing
    training to faiss on one host (gamma_index_ivfpq.cc:346)."""
    n_dev = mesh.devices.size
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    n_pad = -(-n // n_dev) * n_dev
    xp = _pad_axis0(x, n_pad)
    valid = (np.arange(n_pad) < n).astype(np.float32)
    axes = (QUERY_AXIS, LIST_AXIS)

    def body(x_l, w_l, cents):
        def one_iter(_, c):
            cn = jnp.sum(c * c, axis=-1)
            a = jnp.argmin(pairwise_l2(x_l, c, cn), axis=-1)
            onehot = jax.nn.one_hot(a, k, dtype=jnp.float32) * w_l[:, None]
            sums = jax.lax.dot_general(
                onehot, x_l, dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            sums = jax.lax.psum(sums, axes)
            counts = jax.lax.psum(jnp.sum(onehot, axis=0), axes)
            new = sums / jnp.maximum(counts, 1.0)[:, None]
            return jnp.where(counts[:, None] > 0, new, c)

        cents = jax.lax.fori_loop(0, iters, one_iter, cents)
        cn = jnp.sum(cents * cents, axis=-1)
        a = jnp.argmin(pairwise_l2(x_l, cents, cn), axis=-1)
        onehot = jax.nn.one_hot(a, k, dtype=jnp.float32) * w_l[:, None]
        counts = jax.lax.psum(jnp.sum(onehot, axis=0), axes)
        return cents, counts

    rows = P((QUERY_AXIS, LIST_AXIS), None)
    rows1 = P((QUERY_AXIS, LIST_AXIS))
    fn = shard_map(body, mesh, in_specs=(rows, rows1, P()),
                   out_specs=(P(), P()))
    put = functools.partial(jax.device_put)
    xs = jax.device_put(xp, NamedSharding(mesh, rows))
    ws = jax.device_put(valid, NamedSharding(mesh, rows1))
    ci = jax.device_put(np.asarray(init, np.float32),
                        NamedSharding(mesh, P()))
    return jax.jit(fn)(xs, ws, ci)
