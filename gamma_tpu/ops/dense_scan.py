"""Dense scan — the matmul execution of the ADC coarse pass.

Why this exists: the reference's hot loop is the ADC LUT scan
(gamma_index_ivfpq.h:403-418 — `dis = dis0 + Σ_m LUT[m][code[m]]`), a
scalar gather-accumulate that SIMD CPUs do well.  But the ADC distance
IS an exact L2 against the PQ reconstruction:

    dis0 + Σ_m ||r_m - cb[m, code_m]||²  =  ||q - (c_list + recon)||²

so scanning a bf16 reconstruction matrix with one (B × d × N) matmul
(bf16 operands, f32 accumulation) computes the same values the
reference's scanner produces, on the matrix units.  Memory trades
2 bytes/dim (vs M bytes/vector for codes); while the mirror fits its
device budget (index/ivfpq.DENSE_BYTES_BUDGET) this is the default mode,
beyond it the gathered-list path (ops/ivf_scan.py) takes over — the
engine picks automatically.

Candidate selection is ops/topk.select_min_k over the [B, N] scores,
followed by exact rerank over raw vectors, mirroring the reference's
recall_num-coarse-heap → rerank pipeline (gamma_index_ivfpq.cc:642-697).
nprobe does not reduce work in a dense scan (the matmul touches every
row); the scan behaves as nprobe = nlist, a strict recall superset of any
nprobe setting.  nprobe keeps its pruning role in the gathered and
sharded paths.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gamma_tpu.ops.distances import BIG
from gamma_tpu.ops.topk import select_min_k


@functools.partial(
    jax.jit,
    static_argnames=("recall_num", "k", "metric", "rerank"))
def dense_scan_search_fast(recon: jnp.ndarray,   # [N_cap, d] bf16
                           bias: jnp.ndarray,    # [N_cap] f32 (see below)
                           queries: jnp.ndarray,      # [B, d] pre-rotated
                           queries_raw: jnp.ndarray,  # [B, d] unrotated
                           raw: jnp.ndarray,          # [V_cap, d] rerank
                           live_n: jnp.ndarray,       # i32 scalar watermark
                           *, recall_num: int, k: int, metric: str = "l2",
                           rerank: bool = True):
    """Unfiltered dense scan → (dists [B, k] f32, vids [B, k] i32).

    The general path (dense_scan_search) builds its selection score from
    TWO broadcast [N] operands (norms + penalty), which can make XLA
    materialize the [B, N] f32 distance tensor twice.  For UNFILTERED
    requests (the engine passes
    validity_n, mirroring the gather path's fast form) candidate
    validity is decidable from mirror state alone, so the model folds
    norms + slot validity into ONE maintained `bias` array:

        l2: bias = recon_norms + recon_valid   (dead rows ≈ +BIG)
        ip: bias = recon_valid

    and the selection score is a single matmul + one broadcast:

        l2: s = (-2 q)·recon + bias    (ranks like the true distance;
                                        the per-query ||q||² constant is
                                        added AFTER selection — exact)
        ip: s = (-q)·recon + bias

    (the reference's analogous fast form: the IsValid bitmap test fused
    in the scanner hot loop, gamma_index_ivfpq.h:578-600)."""
    if metric == "ip":
        q2 = (-queries).astype(recon.dtype)
    else:
        q2 = (-2.0 * queries).astype(recon.dtype)
    cross = jax.lax.dot_general(
        q2, recon, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)
    s = cross + bias[None, :]
    r = max(recall_num, k)
    rd, rvid = select_min_k(s, r)
    if metric != "ip":
        qf = queries.astype(jnp.float32)
        qn = jnp.sum(qf * qf, axis=-1, keepdims=True)
        rd = rd + qn
    # live watermark applied POST-selection (keeps the scan fused).  On
    # the engine path rows past the watermark are rows the pump indexed
    # AFTER this request snapshotted validity_n — fully committed docs
    # (the reference would return them), so masking them here is a
    # snapshot-semantics choice and they can only crowd the recall_num
    # candidate pool during that one-flush lag window.  A standalone
    # caller passing a watermark far below the indexed count can see
    # fewer than k results — use the penalty path for that.
    rd = jnp.where(rvid >= live_n, BIG, rd)
    if not rerank:
        return rd[:, :k], jnp.where(rd[:, :k] >= BIG, -1, rvid[:, :k])

    qr = queries_raw.astype(jnp.float32)
    rows = jnp.take(raw, jnp.maximum(rvid, 0), axis=0).astype(jnp.float32)
    if metric == "ip":
        exact = -jnp.sum(qr[:, None, :] * rows, axis=-1)
    else:
        diff = qr[:, None, :] - rows
        exact = jnp.sum(diff * diff, axis=-1)
    exact = jnp.where((rd >= BIG) | (rvid < 0), BIG, exact)
    nd, sel = jax.lax.top_k(-exact, k)
    ed = -nd
    evid = jnp.take_along_axis(rvid, sel, axis=1)
    return ed, jnp.where(ed >= BIG, -1, evid)


@functools.partial(
    jax.jit,
    static_argnames=("recall_num", "k", "metric", "rerank"))
def dense_scan_search(recon: jnp.ndarray,        # [N_cap, d] bf16
                      recon_norms: jnp.ndarray,  # [N_cap] f32
                      queries: jnp.ndarray,      # [B, d] (pre-rotated)
                      penalty: jnp.ndarray,      # [N_cap] f32, vid-aligned
                      raw: jnp.ndarray,          # [V_cap, d] rerank source
                      queries_raw: jnp.ndarray,  # [B, d] unrotated (rerank)
                      dist_range: jnp.ndarray = None,  # [2] f32 optional
                      *, recall_num: int, k: int, metric: str = "l2",
                      rerank: bool = True):
    """→ (dists [B, k] f32, vids [B, k] i32).  vid-order scan: `penalty`
    carries deletes + filters + not-yet-published rows as +BIG.

    With OPQ, `queries` is rotated to match `recon`'s space while
    `queries_raw`/`raw` stay unrotated — the rotation is orthogonal, so
    exact distances agree between the two spaces.

    dist_range fuses the score-range filter into candidate selection AND
    the exact rerank (reference: IsSimilarScoreValid in the scanner,
    gamma_index_ivfpq.h:574-601) so top-k fills with in-range hits."""
    qf = queries.astype(jnp.float32)
    r = max(recall_num, k)
    if dist_range is None:
        # filtered-but-unranged: fold norms + penalty into ONE [N]
        # operand behind an optimization barrier (without it XLA may
        # inline the add back into the scan and materialize the [B, N]
        # distance tensor twice; see the fast form's docstring).  The
        # per-query ||q||² constant is added after selection
        # (rank-neutral, exact).
        scale = -1.0 if metric == "ip" else -2.0
        cross = jax.lax.dot_general(
            (scale * qf).astype(recon.dtype), recon,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        if metric == "ip":
            bias = jax.lax.optimization_barrier(
                jnp.minimum(penalty, BIG))
        else:
            bias = jax.lax.optimization_barrier(
                jnp.minimum(recon_norms + penalty, BIG))
        rd, rvid = select_min_k(cross + bias[None, :], r)
        if metric != "ip":
            rd = rd + jnp.sum(qf * qf, axis=-1, keepdims=True)
    else:
        # score-range requests need the raw (penalty-free) distance per
        # candidate to range-mask BEFORE selection so top-k fills with
        # in-range hits (reference: IsSimilarScoreValid in the scanner,
        # gamma_index_ivfpq.h:574-601) — keep the two-operand form
        cross = jax.lax.dot_general(
            queries.astype(recon.dtype), recon,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        if metric == "ip":
            raw_dist = -cross
        else:
            qn = jnp.sum(qf * qf, axis=-1, keepdims=True)
            raw_dist = qn - 2.0 * cross + recon_norms[None, :]
        dist = raw_dist + penalty[None, :]
        out = (raw_dist < dist_range[0]) | (raw_dist > dist_range[1])
        dist = jnp.where(out, BIG, dist)
        dist = jnp.minimum(dist, BIG)
        rd, rvid = select_min_k(dist, r)
    if not rerank:
        return rd[:, :k], jnp.where(rd[:, :k] >= BIG, -1, rvid[:, :k])

    qr = queries_raw.astype(jnp.float32)
    rows = jnp.take(raw, jnp.maximum(rvid, 0), axis=0).astype(jnp.float32)
    if metric == "ip":
        exact = -jnp.sum(qr[:, None, :] * rows, axis=-1)
    else:
        diff = qr[:, None, :] - rows
        exact = jnp.sum(diff * diff, axis=-1)
    exact = jnp.where((rd >= BIG) | (rvid < 0), BIG, exact)
    if dist_range is not None:
        exact = jnp.where((exact < dist_range[0])
                          | (exact > dist_range[1]), BIG, exact)
    nd, sel = jax.lax.top_k(-exact, k)
    ed = -nd
    evid = jnp.take_along_axis(rvid, sel, axis=1)
    return ed, jnp.where(ed >= BIG, -1, evid)
