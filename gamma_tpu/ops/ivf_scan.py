"""IVFPQ / IVFFlat / binary-IVF search — the money path.

Reference: GammaIVFPQIndex::search_preassigned + GammaIVFPQScanner
(gamma_index_ivfpq.cc:701-890, gamma_index_ivfpq.h:403-418,574-601): per
query, assign to nprobe coarse cells, build ADC LUTs, scan each cell's
posting list with tombstone + IsValid checks, heap the best recall_num,
then optionally rerank exactly with raw vectors (compute_dis, .cc:642-697).

Pipeline (one jit, fixed shapes):
  1. coarse assign     — (B x d x nlist) matmul + top_k(nprobe)
  2. LUT build         — einsum over [B, P, M, dsub] x [M, ksub, dsub]
  3. list gather       — leading-axis gather of whole padded lists
                         (contiguous DMA, unlike per-element gathers)
  4. ADC + fused mask  — take_along_axis over the ksub axis, + penalty
                         gather by docid (deletes + filters in one add)
  5. top-recall_num    — topk.select_min_k over the flattened candidates
  6. exact rerank      — gather raw vectors by vid, exact L2/IP, top-k

Smaller-is-better everywhere; IP scores are negated.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from gamma_tpu.ops import pq as pq_ops
from gamma_tpu.ops.distances import pairwise_l2, pairwise_ip, BIG
from gamma_tpu.ops.topk import select_min_k, topk_min
from gamma_tpu.realtime.invert_index import IVFState
from gamma_tpu.utils.devmem import scaled_budget


def coarse_assign(queries: jnp.ndarray, centroids: jnp.ndarray,
                  cent_norms: jnp.ndarray, nprobe: int, metric: str
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """→ (coarse_dists [B, P], list_ids [B, P])."""
    if metric == "ip":
        d = -pairwise_ip(queries, centroids)
    else:
        d = pairwise_l2(queries, centroids, cent_norms)
    ids = jnp.broadcast_to(
        jnp.arange(centroids.shape[0], dtype=jnp.int32)[None, :], d.shape)
    return topk_min(d, ids, nprobe)


def _gather_lists(state: IVFState, list_ids: jnp.ndarray):
    """Gather whole padded lists for each (query, probe)."""
    codes_g = jnp.take(state.codes, list_ids, axis=0)    # [B, P, cap, W] u8
    vids_g = jnp.take(state.vids, list_ids, axis=0)      # [B, P, cap]
    docids_g = jnp.take(state.docids, list_ids, axis=0)  # [B, P, cap]
    lens_g = jnp.take(state.lens, list_ids, axis=0)      # [B, P]
    return codes_g, vids_g, docids_g, lens_g


def _candidate_mask_penalty(docids_g, lens_g, cap, penalty):
    # docid >= 0 must be explicit: take mode="fill" does NOT fill
    # negative indices — they wrap (CLAUDE.md invariant), so a
    # tombstoned slot (docid -1) would read penalty[-1] and survive.
    # (The ADC path re-masked tombstones at rerank via recon_valid;
    # the no-rerank SQ8 path has only this mask.)
    pos = jnp.arange(cap, dtype=jnp.int32)
    ok = (pos[None, None, :] < lens_g[..., None]) & (docids_g >= 0)
    pen = jnp.take(penalty, docids_g, mode="fill", fill_value=BIG)
    return jnp.where(ok, pen, BIG)


def _candidate_mask_validity(docids_g, lens_g, cap, live_n):
    """Unfiltered-query mask WITHOUT the doc-space penalty gather (a
    random gather of B x P x cap indices).  Validity is fully decidable
    from gathered state: in-length, not tombstoned (docid >= 0), and
    below the engine's live watermark."""
    pos = jnp.arange(cap, dtype=jnp.int32)
    in_len = pos[None, None, :] < lens_g[..., None]
    ok = in_len & (docids_g >= 0) & (docids_g < live_n)
    return jnp.where(ok, 0.0, BIG)


def list_bias(docids, lens, cap, penalty=None, live_n=None):
    """Per-(list, slot) additive bias [nlist, cap] f32 folding the
    in-length, tombstone, and validity (or doc-space penalty) masks.

    This is the posting-layout analog of the dense scan's pre-fused
    bias operand: computed ONCE over nlist*cap slots per call instead
    of per (query, probe, slot), it replaces the two [B, P, cap] i32
    gathers + the per-candidate penalty gather (B*P*cap random indices)
    of the _candidate_mask_* path — at batch 512 / nprobe 64 that is
    ~16x fewer penalty lookups."""
    pos = jnp.arange(cap, dtype=jnp.int32)[None, :]
    ok = (pos < lens[:, None]) & (docids >= 0)
    if live_n is not None:
        ok = ok & (docids < live_n)
        return jnp.where(ok, 0.0, BIG)
    pen = jnp.take(penalty, docids, mode="fill", fill_value=BIG)
    return jnp.where(ok, pen, BIG)


def _trim_state(state: IVFState, cap_eff: int) -> IVFState:
    """Slice the posting state to the live-watermark ladder width.
    Exact: lens never exceed the caller's watermark, so slots past it
    are dead padding (callers pass ladder(max_len), see IVFPQIndex
    ._cap_eff)."""
    if not cap_eff or cap_eff >= state.cap:
        return state
    return state._replace(codes=state.codes[:, :cap_eff],
                          vids=state.vids[:, :cap_eff],
                          docids=state.docids[:, :cap_eff])


def _select_late(dist, list_ids, docids, vids, cap, recall_num):
    """Candidate select with LATE id materialization: top-k runs on the
    distances alone (topk.select_min_k over the probe-major [B, P*cap]
    flatten) and doc/vid ids are recovered for only the selected
    positions — replacing the two [B, P, cap] i32 gathers (and their
    flatten + take_along_axis) with [B, R] lookups."""
    b, p = list_ids.shape

    def _ids_from(ridx):
        # ridx indexes the [P*cap] flatten: probe-major, slot-minor
        ridx = jnp.maximum(ridx, 0)
        pidx = ridx // cap
        slot = ridx % cap
        lst = jnp.take_along_axis(list_ids, pidx, axis=1)     # [B, R]
        lin = lst * cap + slot
        rdoc = jnp.take(docids.reshape(-1), lin)
        rvid = jnp.take(vids.reshape(-1), lin)
        return rdoc, rvid

    rd, ridx = select_min_k(dist.reshape(b, -1), recall_num)
    rdoc, rvid = _ids_from(ridx)
    dead = rd >= BIG
    return rd, jnp.where(dead, -1, rdoc), jnp.where(dead, -1, rvid)


def _select_candidates(dist, docids_g, vids_g, recall_num):
    """Select over a [B, P, cap] scan whose ids were already gathered.
    Keeps the PROBE-MAJOR flatten: within a list, positions are
    insertion-ordered (not distance-ordered), so a hot list's true
    neighbours never share a strided select bin."""
    b = dist.shape[0]
    rd, ridx = select_min_k(dist.reshape(b, -1), recall_num)
    ridx = jnp.maximum(ridx, 0)
    rdoc = jnp.take_along_axis(docids_g.reshape(b, -1), ridx, axis=1)
    rvid = jnp.take_along_axis(vids_g.reshape(b, -1), ridx, axis=1)
    # re-poison: masked candidates keep BIG dist and -1 ids
    dead = rd >= BIG
    return rd, jnp.where(dead, -1, rdoc), jnp.where(dead, -1, rvid)


def _rerank(queries, rd, rdoc, rvid, raw_vectors, penalty, k, metric,
            dist_range=None):
    """Exact rerank of recall_num candidates with raw vectors
    (reference: compute_dis, gamma_index_ivfpq.cc:642-697)."""
    rows = jnp.take(raw_vectors, rvid, axis=0, mode="fill",
                    fill_value=0).astype(jnp.float32)        # [B, R, d]
    return rerank_rows(queries, rd, rdoc, rvid, rows, k=k, metric=metric,
                       dist_range=dist_range)


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def rerank_rows(queries, rd, rdoc, rvid, rows, dist_range=None,
                *, k: int, metric: str = "l2"):
    """Exact rerank against PRE-GATHERED candidate rows [B, R, d] — the
    disk-tier path uploads candidates fetched from the host store
    (reference: rocksdb_raw_vector.cc GetVector during compute_dis)."""
    rows = rows.astype(jnp.float32)
    qf = queries.astype(jnp.float32)[:, None, :]
    if metric == "ip":
        exact = -jnp.sum(qf * rows, axis=-1)
    else:
        diff = qf - rows
        exact = jnp.sum(diff * diff, axis=-1)
    exact = jnp.where(rd >= BIG, BIG, exact)
    if dist_range is not None:
        exact = jnp.where((exact < dist_range[0])
                          | (exact > dist_range[1]), BIG, exact)
    ed, eidx = topk_min(exact, jnp.broadcast_to(
        jnp.arange(rd.shape[1], dtype=jnp.int32)[None, :], exact.shape), k)
    fdoc = jnp.take_along_axis(rdoc, eidx, axis=1)
    fvid = jnp.take_along_axis(rvid, eidx, axis=1)
    dead = ed >= BIG
    return ed, jnp.where(dead, -1, fdoc), jnp.where(dead, -1, fvid)


@functools.partial(
    jax.jit,
    static_argnames=("nprobe", "recall_num", "k", "metric", "rerank",
                     "cap_eff"))
def ivfpq_search(state: IVFState,
                 centroids: jnp.ndarray,      # [nlist, d] f32
                 cent_norms: jnp.ndarray,     # [nlist] f32
                 codebooks: pq_ops.PQCodebooks,
                 queries: jnp.ndarray,        # [B, d] (pre-rotated if OPQ)
                 penalty: jnp.ndarray,        # [N_cap] f32
                 raw_vectors: jnp.ndarray,    # [V_cap, d] (bf16/f32)
                 queries_raw: Optional[jnp.ndarray] = None,
                 dist_range: Optional[jnp.ndarray] = None,   # [2] f32
                 live_n: Optional[jnp.ndarray] = None,       # scalar i32
                 *, nprobe: int, recall_num: int, k: int,
                 metric: str = "l2", rerank: bool = True,
                 cap_eff: int = 0):
    """→ (dists [B, k] f32, docids [B, k] i32, vids [B, k] i32).
    Masked/empty slots return dist >= BIG and ids = -1.

    cap_eff (static) trims the scan to the live list-length watermark
    ladder: the posting state presizes to ~3x fill to avoid regrowth
    compiles, so scanning the full cap pays 2-3x dead slots through the
    scan, the bias, and the select."""
    state = _trim_state(state, cap_eff)
    cd, list_ids = coarse_assign(queries, centroids, cent_norms,
                                 nprobe, metric)
    bias_l = list_bias(state.docids, state.lens, state.cap,
                       penalty=penalty, live_n=live_n)    # [nlist, cap]
    if metric == "ip":
        # score = q.c + q.decode(residual code); dist = -score
        lut = -pq_ops.ip_lut(codebooks, queries)          # [B, M, ksub]
        lut = jnp.broadcast_to(lut[:, None], (lut.shape[0], nprobe) +
                               lut.shape[1:])
        base = cd[..., None]                              # -q.c
    else:
        probed_cents = jnp.take(centroids, list_ids, axis=0)  # [B, P, d]
        residual = queries.astype(jnp.float32)[:, None, :] - probed_cents
        lut = pq_ops.l2_lut(codebooks, residual)          # [B, P, M, ksub]
        base = 0.0
    codes_g = jnp.take(state.codes, list_ids, axis=0)
    raw_dist = pq_ops.adc_scan(lut, codes_g) + base       # [B, P, cap]
    dist = _masked_dist(raw_dist, jnp.take(bias_l, list_ids, axis=0),
                        dist_range)
    rd, rdoc, rvid = _select_late(dist, list_ids, state.docids,
                                  state.vids, state.cap, recall_num)
    if not rerank:
        return topk_like(rd, rdoc, rvid, k)
    # rerank compares against UNROTATED raw rows — with OPQ the caller
    # must pass the unrotated queries or distances mix two spaces
    qr = queries if queries_raw is None else queries_raw
    return _rerank(qr, rd, rdoc, rvid, raw_vectors, penalty, k, metric,
                   dist_range)


def _masked_dist(raw_dist, bias, dist_range):
    """Fold the per-slot mask bias into the scanned distances; with a
    score range, out-of-range candidates are masked too (reference:
    IsSimilarScoreValid inside the scanner, gamma_index_ivfpq.h:574-601
    — the recall heap fills with in-range candidates only).  The range
    tests the raw, unmasked distance."""
    dist = raw_dist + bias
    if dist_range is not None:
        dist = jnp.where((raw_dist < dist_range[0])
                         | (raw_dist > dist_range[1]), BIG, dist)
    return jnp.minimum(dist, BIG)


def topk_like(rd, rdoc, rvid, k):
    if k == rd.shape[1]:
        return rd, rdoc, rvid
    return rd[:, :k], rdoc[:, :k], rvid[:, :k]


@functools.partial(
    jax.jit,
    static_argnames=("nprobe", "recall_num", "k", "metric", "rerank",
                     "by_residual", "cap_eff"))
def ivfpqfs_search(state: IVFState,           # codes packed [nlist,cap,M/2]
                   centroids: jnp.ndarray,
                   cent_norms: jnp.ndarray,
                   codebooks: pq_ops.PQCodebooks,   # ksub = 16
                   queries: jnp.ndarray,      # [B, d] (pre-rotated if OPQ)
                   penalty: jnp.ndarray,
                   raw_vectors: jnp.ndarray,
                   queries_raw: Optional[jnp.ndarray] = None,
                   dist_range: Optional[jnp.ndarray] = None,
                   live_n: Optional[jnp.ndarray] = None,     # scalar i32
                   *, nprobe: int, recall_num: int, k: int,
                   metric: str = "l2", rerank: bool = True,
                   by_residual: bool = True, cap_eff: int = 0):
    """FastScan search: 4-bit PQ with packed codes.

    by_residual=False is the reference's layout (4-bit PQ of the RAW
    rotated vector, gamma_index_ivfpqfs.cc:146 — the AVX2 shuffle wants
    one LUT per query).  by_residual=True (our default) quantizes the
    residual like 8-bit IVFPQ, avoiding the recall penalty of
    by_residual=false at nlist≈2k.  Same fused mask / score range /
    recall heap / exact-rerank contract as ivfpq_search (incl. cap_eff
    watermark trimming)."""
    state = _trim_state(state, cap_eff)
    cd, list_ids = coarse_assign(queries, centroids, cent_norms,
                                 nprobe, metric)
    bias_l = list_bias(state.docids, state.lens, state.cap,
                       penalty=penalty, live_n=live_n)    # [nlist, cap]
    codes_g = pq_ops.unpack_nibbles(jnp.take(state.codes, list_ids, axis=0))
    if metric == "ip":
        lut = -pq_ops.ip_lut(codebooks, queries)          # [B, M, 16]
        raw_dist = pq_ops.adc_scan(lut[:, None], codes_g)
        if by_residual:
            raw_dist = raw_dist + cd[..., None]           # -q·c term
    elif by_residual:
        probed = jnp.take(centroids, list_ids, axis=0)    # [B, P, d]
        residual = queries.astype(jnp.float32)[:, None, :] - probed
        lut = pq_ops.l2_lut(codebooks, residual)          # [B, P, M, 16]
        raw_dist = pq_ops.adc_scan(lut, codes_g)
    else:
        lut = pq_ops.l2_lut(codebooks, queries)           # [B, M, 16]
        raw_dist = pq_ops.adc_scan(lut[:, None], codes_g)
    dist = _masked_dist(raw_dist, jnp.take(bias_l, list_ids, axis=0),
                        dist_range)
    rd, rdoc, rvid = _select_late(dist, list_ids, state.docids,
                                  state.vids, state.cap, recall_num)
    if not rerank:
        return topk_like(rd, rdoc, rvid, k)
    qr = queries if queries_raw is None else queries_raw
    return _rerank(qr, rd, rdoc, rvid, raw_vectors, penalty, k, metric,
                   dist_range)


def sq_raw_dist_xla(sq_codes, sq_norms, sq_scale, sq_off, centroids,
                    list_ids, queries, *, metric: str = "l2"):
    """Residual-SQ8 scan distances [B, P, cap] to the dequantized points
    (ops/sq.py) of the probed lists.  The dequantization is folded into
    the query side,

        q.x = (q*scale).code + q.off + q.c_list,

    so the per-candidate work is one multiply-add reduction over the
    gathered u8 codes in f32 (no [B, P, cap, d] float copy of the codes
    is formed)."""
    qf = queries.astype(jnp.float32)
    d = qf.shape[1]
    hp = jax.lax.Precision.HIGHEST
    cg = jnp.take(sq_codes, list_ids, axis=0)[..., :d]   # [B, P, cap, d]
    qs = qf * sq_scale[None, :]
    qx = jnp.sum(qs[:, None, None, :] * cg.astype(jnp.float32), axis=-1)
    q_off = jnp.dot(qf, sq_off, precision=hp)             # [B]
    q_cent = jnp.einsum("bd,bpd->bp", qf,
                        jnp.take(centroids, list_ids, axis=0),
                        precision=hp)                     # [B, P]
    qx = qx + (q_off[:, None] + q_cent)[..., None]
    if metric == "ip":
        return -qx
    nrm_g = jnp.take(sq_norms, list_ids, axis=0)
    qn = jnp.sum(qf * qf, axis=-1)
    return qn[:, None, None] - 2.0 * qx + nrm_g


@functools.partial(
    jax.jit,
    static_argnames=("nprobe", "k", "metric", "cap_eff", "recall_num",
                     "rerank"))
def ivfsq_search(state: IVFState,             # posting ids/lens (codes unused)
                 sq_codes: jnp.ndarray,       # [nlist, cap, d_pad] u8
                 sq_norms: jnp.ndarray,       # [nlist, cap] f32
                 sq_scale: jnp.ndarray,       # [d] f32
                 sq_off: jnp.ndarray,         # [d] f32
                 centroids: jnp.ndarray,      # [nlist, d] f32
                 cent_norms: jnp.ndarray,     # [nlist] f32
                 queries: jnp.ndarray,        # [B, d] (pre-rotated if OPQ)
                 penalty: jnp.ndarray,        # [N_cap] f32
                 dist_range: Optional[jnp.ndarray] = None,   # [2] f32
                 live_n: Optional[jnp.ndarray] = None,       # scalar i32
                 raw_vectors: Optional[jnp.ndarray] = None,  # [V, d]
                 queries_raw: Optional[jnp.ndarray] = None,
                 *, nprobe: int, k: int, metric: str = "l2",
                 cap_eff: int = 0, recall_num: int = 0,
                 rerank: bool = False):
    """Residual-SQ8 capacity search (ops/sq.py): scan distances are
    EXACT distances to the int8-dequantized points, so top-k is
    selected directly — no recall_num heap, no exact-rerank row gather
    (the reference's compute_dis re-read, gamma_index_ivfpq.cc:642-697).

    cap_eff (static) slices the scan to the live capacity watermark:
    lists never exceed max(lens), so slots beyond it are dead padding
    that would still cost gather/mask/select work.
    → (dists [B, k] f32, docids [B, k] i32, vids [B, k] i32)."""
    # scan width: the ladder watermark, never wider than either the
    # posting cap or the sidecar's own width (the sidecar is allocated
    # at ladder(max_len), usually NARROWER than the 3x-slack posting
    # cap; older dumps may still carry a full-cap sidecar).  Slots past
    # max(lens) are dead, so trimming is exact.
    cap = state.cap
    sq_cap = sq_codes.shape[1]
    eff = min(cap, sq_cap, cap_eff or sq_cap)
    if eff < sq_cap:
        sq_codes = sq_codes[:, :eff]
        sq_norms = sq_norms[:, :eff]
    if eff < cap:
        state = state._replace(vids=state.vids[:, :eff],
                               docids=state.docids[:, :eff])
    cap = eff
    cd, list_ids = coarse_assign(queries, centroids, cent_norms,
                                 nprobe, metric)
    bias_l = list_bias(state.docids, state.lens, cap,
                       penalty=penalty, live_n=live_n)    # [nlist, cap]
    raw_dist = sq_raw_dist_xla(sq_codes, sq_norms, sq_scale, sq_off,
                               centroids, list_ids, queries, metric=metric)
    dist = _masked_dist(raw_dist, jnp.take(bias_l, list_ids, axis=0),
                        dist_range)
    if not rerank:
        return _select_late(dist, list_ids, state.docids, state.vids,
                            cap, k)
    # optional exact rerank: SQ8 distances are exact to the QUANTIZED
    # point, which misranks near-ties at 10M density.  Selecting a top-R
    # candidate set and reranking against the store mirror recovers the
    # dense tier's ordering at ~R rows of gather per query.
    rn = max(recall_num or 8 * k, k)
    rd, rdoc, rvid = _select_late(dist, list_ids, state.docids,
                                  state.vids, cap, rn)
    qr = queries if queries_raw is None else queries_raw
    return _rerank(qr, rd, rdoc, rvid, raw_vectors, penalty, k, metric,
                   dist_range)


# ---------------------------------------------------------------------
# IVFFlat: codes are bf16 raw vectors stored as bytes in the same state
# (reference: gamma_index_ivfflat.{h,cc} — full vectors as "codes")
# ---------------------------------------------------------------------

# Payload-gather transient budget for the exact-scan models, written for
# a 16 GiB device (utils/devmem.scaled_budget): the [Bc, P, cap, W] u8
# gather materializes before the distance fusion, and at batch 1024 x
# nprobe 64 x cap 781 x 256 B the full-batch gather alone is 13 GB.
FLAT_GATHER_BYTES = 1 << 30


def _batched_exact_scan(queries, chunk_fn, per_query_bytes):
    """Run chunk_fn over query chunks sized to the gather budget.
    chunk_fn: [Bc, d] -> (rd [Bc, k], rdoc, rvid).  The chunk axis is a
    lax.map (sequential) so only one chunk's gather transient is live at
    a time; for small geometries this degenerates to one direct call."""
    b = queries.shape[0]
    budget = scaled_budget(FLAT_GATHER_BYTES)
    bc = max(1, min(b, budget // max(per_query_bytes, 1)))
    if bc >= 8:
        bc = (bc // 8) * 8
    if bc >= b:
        return chunk_fn(queries)
    nchunk = -(-b // bc)
    pad = nchunk * bc - b
    qpad = jnp.pad(queries, ((0, pad), (0, 0))) if pad else queries
    out = jax.lax.map(chunk_fn, qpad.reshape(nchunk, bc, -1))
    return jax.tree.map(
        lambda t: t.reshape(nchunk * bc, *t.shape[2:])[:b], out)


@functools.partial(
    jax.jit, static_argnames=("nprobe", "k", "metric", "d", "cap_eff"))
def ivfflat_search(state: IVFState, centroids, cent_norms, queries,
                   penalty, dist_range=None, *, nprobe: int, k: int,
                   d: int, metric: str = "l2", cap_eff: int = 0):
    """Exact-distance IVF scan: posting payload = bf16 vector bytes.
    Distances are exact to the stored bf16 rows (f32 arithmetic)."""
    state = _trim_state(state, cap_eff)
    cap, w = state.codes.shape[1], state.codes.shape[2]

    def _chunk(qc):
        cd, list_ids = coarse_assign(qc, centroids, cent_norms,
                                     nprobe, metric)
        codes_g, vids_g, docids_g, lens_g = _gather_lists(state, list_ids)
        bcq = codes_g.shape[0]
        vecs = jax.lax.bitcast_convert_type(
            codes_g.reshape(bcq, nprobe, cap, d, 2), jnp.bfloat16
        ).reshape(bcq, nprobe, cap, d).astype(jnp.float32)
        qf = qc.astype(jnp.float32)
        if metric == "ip":
            raw_dist = -jnp.sum(qf[:, None, None, :] * vecs, axis=-1)
        else:
            diff = qf[:, None, None, :] - vecs
            raw_dist = jnp.sum(diff * diff, axis=-1)
        dist = _masked_dist(
            raw_dist, _candidate_mask_penalty(docids_g, lens_g, cap,
                                              penalty), dist_range)
        return _select_candidates(dist, docids_g, vids_g, k)

    # gather transient per query: codes bytes + the f32 vecs expansion
    per_q = nprobe * cap * (w + 4 * d)
    return _batched_exact_scan(queries, _chunk, per_q)


# ---------------------------------------------------------------------
# Binary IVF: Hamming distance over packed bits
# (reference: gamma_index_binary_ivf.{h,cc})
# ---------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("nprobe", "k"))
def binary_ivf_search(state: IVFState, centroids_bits: jnp.ndarray,
                      query_codes: jnp.ndarray, penalty: jnp.ndarray,
                      *, nprobe: int, k: int):
    """centroids_bits [nlist, W] u8, query_codes [B, W] u8.
    Coarse + fine are Hamming via XOR + population_count."""
    def hamming(a, b):
        # a [..., W], b [n, W] → [..., n]
        x = jnp.bitwise_xor(a[..., None, :], b[None, :, :])
        return jnp.sum(jax.lax.population_count(x).astype(jnp.int32),
                       axis=-1)

    cap, w = state.codes.shape[1], state.codes.shape[2]

    def _chunk(qc):
        cdist = hamming(qc, centroids_bits).astype(jnp.float32)
        ids = jnp.broadcast_to(
            jnp.arange(centroids_bits.shape[0], dtype=jnp.int32)[None, :],
            cdist.shape)
        _, list_ids = topk_min(cdist, ids, nprobe)
        codes_g, vids_g, docids_g, lens_g = _gather_lists(state, list_ids)
        x = jnp.bitwise_xor(codes_g, qc[:, None, None, :])
        if w % 4 == 0:
            # popcount i32 words, not bytes: 4x fewer VPU ops and a 4x
            # smaller [B, P, cap, *] i32 intermediate
            x = jax.lax.bitcast_convert_type(
                x.reshape(*x.shape[:-1], w // 4, 4), jnp.int32)
        dist = jnp.sum(jax.lax.population_count(x).astype(jnp.int32),
                       axis=-1).astype(jnp.float32)
        dist = dist + _candidate_mask_penalty(docids_g, lens_g, cap,
                                              penalty)
        dist = jnp.minimum(dist, BIG)
        return _select_candidates(dist, docids_g, vids_g, k)

    # transient per query: xor/popcount intermediates dominate (u8 + i32)
    per_q = nprobe * cap * (2 * w + 8)
    return _batched_exact_scan(query_codes, _chunk, per_q)
