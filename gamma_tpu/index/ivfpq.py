"""IVFPQ — the flagship model.

Reference: index/impl/gamma_index_ivfpq.{h,cc} (2011 LoC over faiss
IndexIVFPQ + RTInvertIndex).  Capability contract kept:
  * coarse quantizer over ncentroids cells         (Init .cc:119-214)
  * PQ codes over residuals, nsubvector x nbits    (Add .cc:424-512)
  * train-set clamp [nlist*39, nlist*256]          (.cc:281-296)
  * realtime posting lists w/ tombstone updates    (RTInvertIndex)
  * search = assign → ADC scan w/ fused filters →
    recall_num heap → exact rerank                 (.cc:514-890)
  * brute-force fallback when untrained or
    request.brute_force_search                     (.cc:529-537)

Substitutions (documented deviations):
  * the HNSW coarse-quantizer option (ivfpq.cc:146-156) is replaced by
    flat assign — one (B x d x nlist) matmul instead of a graph
    traversal for nlist <= ~64k;
  * OPQ rotation is a matmul prologue (applied to both the stored
    residual path at encode time and to queries);
  * training is on-device k-means (ops/kmeans.py) instead of faiss CPU;
  * TWO scan modes (reference has one):
      - "dense"  (default while the mirror fits device memory): the ADC
        distance equals the exact L2 against the PQ reconstruction
        c_list + decode(code), so the coarse pass is one matmul over a
        bf16 reconstruction mirror + candidate select (see
        ops/dense_scan.py); behaves as nprobe = nlist (strict recall
        superset).
      - "gather" (capacity mode): the literal gathered-list ADC scan
        (ops/ivf_scan.py) keeping the M-bytes/vector footprint; used when
        reconstructions would not fit device memory, and by the sharded
        path.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gamma_tpu.config import IVFPQParams, MetricType, SearchParams
from gamma_tpu.index.model import RetrievalModel
from gamma_tpu.index.registry import register_model
from gamma_tpu.ops import ivf_scan, kmeans as km, pq as pq_ops
from gamma_tpu.ops.sq import encode_sq, train_sq
from gamma_tpu.ops.dense_scan import (dense_scan_search,
                                      dense_scan_search_fast)
from gamma_tpu.ops.distances import BIG, l2_norms, pairwise_l2
from gamma_tpu.ops.flat_scan import flat_search
from gamma_tpu.realtime import invert_index as rt
from gamma_tpu.utils.devmem import device_of, scaled_budget
from gamma_tpu.vector.raw_store import RawVectorStore

TRAIN_MIN_PER_LIST = 39     # faiss/gamma clamp (ivfpq.cc:281-296)
TRAIN_MAX_PER_LIST = 256
# PQ/SQ codebook training subsample: ksub=256 codewords per subspace
# need ~512 points each; past 128k rows the extra data only slows the
# 12-iteration batched kmeans (the coarse quantizer still sees the
# full clamped train set)
PQ_TRAIN_MAX_ROWS = 131072
RECON_ROW_PAD = 8192        # reconstruction-mirror growth quantum
# Device-memory budgets, written for a 16 GiB device and scaled to the
# device holding the index (utils/devmem.scaled_budget).
# auto mode: dense while the bf16 reconstruction mirror stays under this
DENSE_BYTES_BUDGET = 8 << 30
# residual-SQ8 gather payload (ops/sq.py): maintained while its padded
# [nlist, cap, d] sidecar stays under this; beyond it the gather tier
# falls back to the M-byte ADC scan (the extreme-capacity format)
SQ_BYTES_BUDGET = 6 << 30


@functools.partial(jax.jit, static_argnames=("d_pad", "has_rot"))
def _sq_encode_batch(xp, rot, cents, assign, scale, off, *, d_pad: int,
                     has_rot: bool):
    """Residual-SQ8 encode of a padded ingest batch (ops/sq.py):
    rotate → take coarse rows for the batch's EXISTING assignment →
    int8-quantize the residual.  → (codes [n_pad, d_pad] u8,
    norms [n_pad] f32)."""
    xf = xp.astype(jnp.float32)
    if has_rot:
        xf = xf @ rot
    coarse = jnp.take(cents, jnp.clip(assign, 0, cents.shape[0] - 1),
                      axis=0)
    return encode_sq(xf, scale, off, coarse, d_pad=d_pad, residual=True)


@jax.jit
def _sq_append(sq_codes, sq_norms, assign, positions, vids, codes, norms):
    """Scatter a placed batch into the SQ8 sidecar (same (list, pos)
    slots as the posting append; -1 padding remapped — scatter
    mode="drop" does not drop negative indices, they wrap)."""
    li = jnp.where(vids < 0, 0x40000000, assign)
    pos = jnp.where(positions < 0, 0x40000000, positions)
    return (sq_codes.at[li, pos].set(codes, mode="drop"),
            sq_norms.at[li, pos].set(norms, mode="drop"))


@functools.partial(jax.jit, static_argnames=("lb", "has_rot"))
def _sq_block_residuals(store_rows, vids, lens, cents, rot, start, *,
                        lb: int, has_rot: bool):
    """Residuals for a block of `lb` lists read back from the raw store
    (the scale-fit pass of build_sq_sidecar).  → (res [lb*cap, d] f32,
    live [lb*cap] bool)."""
    vb = jax.lax.dynamic_slice_in_dim(vids, start, lb, axis=0)
    lensb = jax.lax.dynamic_slice_in_dim(lens, start, lb, axis=0)
    cb = jax.lax.dynamic_slice_in_dim(cents, start, lb, axis=0)
    idx = jnp.clip(vb, 0, store_rows.shape[0] - 1).reshape(-1)
    xf = jnp.take(store_rows, idx, axis=0).astype(jnp.float32)
    if has_rot:
        xf = xf @ rot
    cap = vb.shape[1]
    res = xf - jnp.repeat(cb, cap, axis=0)
    pos = jnp.arange(cap, dtype=jnp.int32)[None, :]
    live = ((vb >= 0) & (pos < lensb[:, None])).reshape(-1)
    return res, live


@functools.partial(jax.jit, static_argnames=("d_pad", "lb", "has_rot"),
                   donate_argnums=(0, 1))
def _sq_block_encode(sq_codes, sq_norms, store_rows, vids, cents, rot,
                     scale, off, start, *, d_pad: int, lb: int,
                     has_rot: bool):
    """Encode one block of `lb` lists into the (donated) sidecar: the
    post-hoc build path never exposes these buffers to searches until
    the final publish, so donation is safe — without it each block
    update would copy the full multi-GB sidecar.  Dead slots (vids < 0
    / beyond lens) encode garbage rows, matching the ingest path's
    stale-data-at-dead-slots behavior (scans mask by length/validity)."""
    vb = jax.lax.dynamic_slice_in_dim(vids, start, lb, axis=0)
    cb = jax.lax.dynamic_slice_in_dim(cents, start, lb, axis=0)
    idx = jnp.clip(vb, 0, store_rows.shape[0] - 1).reshape(-1)
    xf = jnp.take(store_rows, idx, axis=0).astype(jnp.float32)
    if has_rot:
        xf = xf @ rot
    cap = vb.shape[1]
    coarse = jnp.repeat(cb, cap, axis=0)
    codes, norms = encode_sq(xf, scale, off, coarse, d_pad=d_pad,
                             residual=True)
    sq_codes = jax.lax.dynamic_update_slice_in_dim(
        sq_codes, codes.reshape(lb, cap, d_pad), start, axis=0)
    sq_norms = jax.lax.dynamic_update_slice_in_dim(
        sq_norms, norms.reshape(lb, cap), start, axis=0)
    return sq_codes, sq_norms


@jax.jit
def _recon_append(recon, recon_norms, recon_bias, vids, rows, row_norms):
    # negative (padding) vids must become positive out-of-bounds before
    # the scatter: mode="drop" does not drop negatives — they wrap
    vids = jnp.where(vids < 0, 0x40000000, vids)
    recon = recon.at[vids].set(rows, mode="drop")
    recon_norms = recon_norms.at[vids].set(row_norms, mode="drop")
    recon_bias = recon_bias.at[vids].set(row_norms, mode="drop")
    return recon, recon_norms, recon_bias


@jax.jit
def _valid_set(valid, vids, value):
    vids = jnp.where(vids < 0, 0x40000000, vids)
    return valid.at[vids].set(value, mode="drop")


@jax.jit
def _recon_commit(recon, recon_norms, recon_valid, recon_bias,
                  vids, rows, row_norms):
    """Mirror-only half of the ingest commit (big-corpus path): with
    buffer donation off by design (in-flight searches hold snapshots),
    a single fused commit holds TWO generations of codes AND recon
    simultaneously — at 10M rows that transient alone is ~4 GB.
    Splitting mirror and posting-state commits halves the
    peak; ordering mirror first keeps search correct between the two
    (rows become valid in the mirror before they are published in the
    posting lists — realtime semantics allow either)."""
    vids_s = jnp.where(vids < 0, 0x40000000, vids)
    recon = recon.at[vids_s].set(rows, mode="drop")
    recon_norms = recon_norms.at[vids_s].set(row_norms, mode="drop")
    recon_valid = recon_valid.at[vids_s].set(0.0, mode="drop")
    recon_bias = recon_bias.at[vids_s].set(row_norms, mode="drop")
    return recon, recon_norms, recon_valid, recon_bias


# split the commit once the mirror outgrows this (one extra dispatch per
# add-batch, ~ms, vs a 2x-mirror transient in HBM)
SPLIT_COMMIT_BYTES = 1 << 30


@functools.partial(jax.jit, static_argnames=("nlist",))
def _place_batch(lens, assign, vids, *, nlist: int):
    """Device-side slot placement (the device re-derivation of
    HostPlacer.place / the reference's atomic retrieve_idx_pos_ cursor
    bump, realtime_mem_data.cc:279-302): sort the batch by list, rank
    within equal-list runs, offset by the CURRENT device lens.  Because
    lens live in device state and the batch is placed on device, the
    ingest path needs NO assignment readback and NO host placement.

    Padding rows (vids < 0) place into list `nlist` (out-of-bounds →
    dropped by the commit scatters) and do not count toward lens.
    → (positions [n_pad] i32, new_lens [nlist] i32, need scalar i32)."""
    n = assign.shape[0]
    li = jnp.where(vids < 0, nlist, assign).astype(jnp.int32)
    lens_ext = jnp.concatenate([lens, jnp.zeros((1,), lens.dtype)])
    order = jnp.argsort(li, stable=True)
    sl = li[order]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sl[1:] != sl[:-1]])
    run_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    ranks = idx - run_start
    pos_sorted = lens_ext[sl] + ranks
    positions = jnp.zeros((n,), jnp.int32).at[order].set(pos_sorted)
    counts = jnp.zeros((nlist,), lens.dtype).at[
        jnp.minimum(li, nlist - 1)].add(
        jnp.where(li < nlist, 1, 0).astype(lens.dtype))
    new_lens = lens + counts
    return positions, new_lens, jnp.max(new_lens)


@jax.jit
def _commit_placed(state, recon, recon_norms, recon_valid, recon_bias,
                   assign, positions, codes, vids, docids, new_lens,
                   rows, row_norms):
    """Fused commit for device-placed batches: posting append + mirror
    scatter in one dispatch (small-mirror path)."""
    li = jnp.where(vids < 0, 0x40000000, assign)
    state = rt.append(state, li, positions, codes, vids, docids,
                      new_lens)
    vids_s = jnp.where(vids < 0, 0x40000000, vids)
    recon = recon.at[vids_s].set(rows, mode="drop")
    recon_norms = recon_norms.at[vids_s].set(row_norms, mode="drop")
    recon_valid = recon_valid.at[vids_s].set(0.0, mode="drop")
    recon_bias = recon_bias.at[vids_s].set(row_norms, mode="drop")
    return state, recon, recon_norms, recon_valid, recon_bias


@jax.jit
def _append_placed(state, assign, positions, codes, vids, docids,
                   new_lens):
    li = jnp.where(vids < 0, 0x40000000, assign)
    return rt.append(state, li, positions, codes, vids, docids,
                     new_lens)


@functools.partial(jax.jit, static_argnames=("d", "has_rot", "recon_dtype"))
def _encode_full(x, cents, cnorms, cb, cb_norms, rot, *, d, has_rot,
                 recon_dtype=jnp.bfloat16):
    """Fused ingest step: rotate → coarse assign → residual PQ encode →
    reconstruct (for the dense-scan mirror).  One compile per batch shape.
    Reference splits this across OPQ apply + quantizer->assign + pq
    compute_codes (gamma_index_ivfpq.cc:424-512).

    recon norms are computed from the STORED (dtype-rounded) recon so the
    dense scan's ||q||² - 2q·y + ||y||² is the exact distance to the
    quantized point — inconsistent norms add an error comparable to the
    rounding itself."""
    xf = x.astype(jnp.float32)
    if has_rot:
        xf = xf @ rot
    assign = _assign_chunked(xf, cents, cnorms, chunk=16384)
    coarse = jnp.take(cents, assign, axis=0)
    pq = pq_ops.PQCodebooks(cb, cb_norms)
    codes = pq_ops.encode_pq(pq, xf - coarse)
    recon = (coarse + pq_ops.decode_pq(pq, codes)[:, :d]
             ).astype(recon_dtype)
    return (assign.astype(jnp.int32), codes, recon,
            l2_norms(recon.astype(jnp.float32)))


def _pad_quantum(n: int) -> int:
    """Pad add-batches to a small set of shapes to bound recompiles."""
    q = 1024
    while q < n and q < 65536:
        q *= 2
    return -(-n // q) * q


def _assign_chunked(x: jnp.ndarray, cents: jnp.ndarray,
                    cent_norms: jnp.ndarray, chunk: int = 4096):
    n = x.shape[0]
    pad = (-n) % chunk
    xp = jnp.pad(x, ((0, pad), (0, 0))) if pad else x

    def one(xc):
        d = pairwise_l2(xc, cents, cent_norms)
        return jnp.argmin(d, axis=-1).astype(jnp.int32)

    out = jax.lax.map(one, xp.reshape(-1, chunk, x.shape[1]))
    return out.reshape(-1)[:n]


@register_model("IVFPQ")
class IVFPQIndex(RetrievalModel):
    _dump_suffix = "ivfpq"
    # capacity-tier payload default; FastScan/ScaNN override to "pq"
    # (their whole point is the sub-byte/anisotropic code format)
    _sq_payload_default = "sq8"
    # posting-code layout (the sharded scan body needs these statically:
    # FastScan packs two 4-bit entries per byte and may code the raw
    # rotated vector instead of the residual)
    packed_codes = False
    by_residual = True

    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(raw_store, params)
        self.p = IVFPQParams.from_dict(params)
        self.d = raw_store.d
        self._trained = False
        self.centroids: Optional[jnp.ndarray] = None      # [nlist, d]
        self.cent_norms: Optional[jnp.ndarray] = None
        self.pq: Optional[pq_ops.PQCodebooks] = None
        self.opq_rot: Optional[jnp.ndarray] = None         # [d, d] or None
        init_cap = max(64, self.p.bucket_init_size)
        self.state = rt.init_state(self.p.ncentroids, init_cap,
                                   self._code_width())
        self.placer = rt.HostPlacer(self.p.ncentroids, init_cap)
        # dense-mode reconstruction mirror, vid-indexed.  float32 recon
        # removes the bf16 rounding from candidate selection (bf16 adds a
        # +-0.4% relative coordinate error whose distance perturbation can
        # exceed neighbor gaps in dense corpora) at 2x mirror memory and
        # ~half the scan matmul rate.
        rd = str((params or {}).get("recon_dtype", "bfloat16"))
        self.recon_dtype = jnp.float32 if rd == "float32" else jnp.bfloat16
        # disk-tier stores (RocksDB analog) hold no dense mirror: codes
        # stay the only HBM-resident per-vector state and the exact rerank
        # reads candidates through from the host store
        self.keep_recon = raw_store.tier != "disk"
        self._pending_place: List[Tuple] = []
        rows0 = RECON_ROW_PAD if self.keep_recon else 8
        self.recon = jnp.zeros((rows0, self.d), self.recon_dtype)
        self.recon_norms = jnp.zeros((rows0,), jnp.float32)
        self.recon_valid = jnp.full((rows0,), BIG, jnp.float32)
        # norms + validity fused into one array: the unfiltered dense
        # scan selects from `(-2q)·recon + bias` — a single broadcast
        # operand (two can force a 2x [B, N] materialization)
        self.recon_bias = jnp.full((rows0,), BIG, jnp.float32)
        # residual-SQ8 gather payload (ops/sq.py): slot-aligned
        # int8 sidecar + exact f32 norms; allocated at train time, grown
        # with the posting state, dropped past SQ_BYTES_BUDGET
        self.sq_payload = (self.p.gather_payload
                           or type(self)._sq_payload_default)
        self.sq_codes: Optional[jnp.ndarray] = None   # [nlist, cap, d_pad]
        self.sq_norms: Optional[jnp.ndarray] = None   # [nlist, cap]
        self.sq_scale: Optional[jnp.ndarray] = None   # [d]
        self.sq_off: Optional[jnp.ndarray] = None
        self._max_len = 0          # live list-length watermark (host)

    def _code_width(self) -> int:
        """Posting-payload bytes per vector (FastScan overrides: packed
        nibbles are nsubvector/2 bytes)."""
        return self.p.nsubvector

    # ---- training ----

    def trained(self) -> bool:
        return self._trained

    def clamp_train_set(self, x) -> np.ndarray:
        """Clamp to nlist*TRAIN_MAX_PER_LIST rows.  Accepts host arrays
        (random subsample) or device arrays (strided slice — clamping
        must not drag the set back through the host)."""
        nlist = self.p.ncentroids
        n = x.shape[0]
        hi = nlist * TRAIN_MAX_PER_LIST
        if n <= hi:
            return x
        if isinstance(x, jax.Array) and not isinstance(x, np.ndarray):
            sel = jnp.asarray(
                np.linspace(0, n - 1, hi).astype(np.int32))
            return jnp.take(x, sel, axis=0)
        rng = np.random.default_rng(0)
        return x[rng.choice(n, hi, replace=False)]

    @staticmethod
    def _pq_train_rows(residuals: jnp.ndarray) -> jnp.ndarray:
        """Device-side strided subsample for the PQ/SQ codebook fit."""
        n = residuals.shape[0]
        if n <= PQ_TRAIN_MAX_ROWS:
            return residuals
        sel = jnp.asarray(
            np.linspace(0, n - 1, PQ_TRAIN_MAX_ROWS).astype(np.int32))
        return jnp.take(residuals, sel, axis=0)

    def train(self, x: np.ndarray, coarse=None) -> None:
        """`coarse=(centroids[, cent_norms])` seeds the coarse quantizer
        and skips its k-means: production systems share ONE coarse
        quantizer across index variants over the same corpus (the
        reference's GPU path likewise clones the CPU twin's trained
        quantizer rather than retraining, gamma_index_ivfpq_gpu.cc).
        The provided centroids must live in THIS model's rotated space —
        only share between models with identical OPQ settings.

        `x` may be a DEVICE array (any float dtype): the train set then
        never round-trips the host, and a caller holding a bf16 mirror
        (vector/raw_store.py device tier) ships HALF the bytes of an f32
        host set."""
        if isinstance(x, jax.Array) and not isinstance(x, np.ndarray):
            x0 = self.clamp_train_set(x)          # device, unrotated
            xd = x0.astype(jnp.float32)
        else:
            x0 = self.clamp_train_set(np.asarray(x, np.float32))
            xd = jnp.asarray(x0)
        if self.p.has_opq:
            self.opq_rot = self._train_opq_init(xd)
            xd = xd @ self.opq_rot
        if coarse is not None:
            cents = jnp.asarray(coarse[0])
            self.centroids = cents
            self.cent_norms = (jnp.asarray(coarse[1])
                               if len(coarse) > 1 and coarse[1] is not None
                               else l2_norms(cents))
        else:
            cents, _ = km.kmeans(xd, self.p.ncentroids, iters=10, seed=0,
                                 rebalance=self.p.train_rebalance)
            self.centroids = cents
            self.cent_norms = l2_norms(cents)
        assign = _assign_chunked(xd, cents, self.cent_norms)
        residuals = xd - jnp.take(cents, assign, axis=0)
        res_sub = self._pq_train_rows(residuals)
        self.pq = pq_ops.train_pq(res_sub, self.p.nsubvector,
                                  nbits=self.p.nbits_per_idx, iters=12)
        if self.p.has_opq:
            self._refine_opq(xd, residuals)
        if self.sq_payload == "sq8":
            if self.p.has_opq:
                # OPQ refinement changed the rotation — re-derive
                # FINAL-rotation residuals for the SQ8 range fit
                xr = self._rotate(jnp.asarray(x0).astype(jnp.float32))
                a = _assign_chunked(xr, self.centroids, self.cent_norms)
                self._sq_init(self._pq_train_rows(
                    xr - jnp.take(self.centroids, a, axis=0)))
            else:
                # no rotation: the PQ-training residuals ARE the
                # final-space residuals (saves a full assignment pass)
                self._sq_init(res_sub)
        self._trained = True

    # ---- residual-SQ8 gather payload (ops/sq.py) ----

    @property
    def _sq_d_pad(self) -> int:
        return -(-self.d // 128) * 128        # lane-aligned code width

    @property
    def sq_active(self) -> bool:
        return self.sq_codes is not None

    def _sq_budget(self) -> int:
        return scaled_budget(SQ_BYTES_BUDGET, device_of(self.state.codes))

    def _sq_init(self, residuals: jnp.ndarray) -> None:
        self.sq_scale, self.sq_off = train_sq(residuals)
        nlist = self.state.nlist
        # sidecar capacity tracks the LADDER (ladder(max_len), not the
        # posting cap): the posting state presizes to ~3x fill to avoid
        # regrowth compiles, but at 128 B/slot the sidecar paying that
        # slack cost ~1.7 GB of dead device memory at the 10M geometry —
        # and a full-cap sidecar also forces an in-jit [nlist, cap_eff]
        # slice COPY on every scan
        ce = self._sq_ladder(max(self._max_len, 1))
        if nlist * ce * (self._sq_d_pad + 4) > self._sq_budget():
            self._sq_drop("init")
            return
        self.sq_codes = jnp.zeros((nlist, ce, self._sq_d_pad), jnp.uint8)
        self.sq_norms = jnp.zeros((nlist, ce), jnp.float32)

    def _sq_drop(self, why: str) -> None:
        if self.sq_codes is not None or why == "init":
            import logging
            logging.getLogger("gamma_tpu").warning(
                "SQ8 gather payload dropped (%s): sidecar would exceed "
                "%d MB — gather tier falls back to the ADC scan",
                why, self._sq_budget() >> 20)
        self.sq_codes = None
        self.sq_norms = None

    def _sq_grow(self, need: int) -> None:
        """Grow the sidecar so every live slot (< `need`) is writable.
        Target = ladder(need) clipped to the posting cap; scatters past
        the sidecar width would DROP silently (mode=\"drop\"), so the add
        path must call this BEFORE _sq_append whenever need exceeds the
        current sidecar width."""
        if self.sq_codes is None:
            return
        target = self._sq_ladder(need)
        cur = self.sq_codes.shape[1]
        if target <= cur:
            return
        nlist = self.state.nlist
        if nlist * target * (self._sq_d_pad + 4) > self._sq_budget():
            self._sq_drop("grow")
            return
        pad = target - cur
        self.sq_codes = jnp.pad(self.sq_codes, ((0, 0), (0, pad), (0, 0)))
        self.sq_norms = jnp.pad(self.sq_norms, ((0, 0), (0, pad)))

    def _sq_ladder(self, need: int) -> int:
        """Geometric (~25%) ladder step covering `need` slots, quantized
        to 256 and clipped to the posting cap.  Finer than powers of two
        on purpose: at the 10M geometry a balanced max_len (~10k) under
        a pow2 ladder jumps to 16384 — past the posting cap — and the
        watermark trim never fires; 25% steps bound both the dead-slot
        scan overshoot and the number of distinct compiled shapes
        (~18 steps to 16k)."""
        ce = 256
        while ce < need:
            ce = max(ce + 256, -(-int(ce * 1.25) // 256) * 256)
        return min(ce, self.state.cap)

    def _cap_eff(self) -> int:
        """Static scan capacity for the gather tier: the smallest
        power-of-two ladder step covering the live list-length watermark
        (bounds compiled shapes; dead capacity beyond it would still
        cost gather/mask/select work — ~4x at typical fill)."""
        return self._sq_ladder(self._max_len)

    def build_sq_sidecar(self, sample_rows: int = 262_144) -> bool:
        """Post-hoc residual-SQ8 sidecar build from the posting state +
        device raw store — capacity-tier PROMOTION: a deployment that
        ingested with the sidecar disabled (gather_payload="pq"), or that
        dropped it past the byte budget, switches to the exact-SQ8 gather
        tier without re-ingesting.  The 10M bench uses this to avoid ever
        holding the dense mirror AND the sidecar simultaneously (reference
        scale story: benchs/README.md "recalls of SIFT10M").

        Fits scale/off on live residuals when not already fitted, then
        encodes list blocks straight from the device store with donated
        sidecar updates (single-generation in HBM).  Returns True when the
        sidecar is active afterwards."""
        assert self._trained, "build_sq_sidecar before train"
        with self.mutate_lock:
            nlist = self.state.nlist
            # ladder capacity, not the posting cap: lists never exceed
            # max(lens), so slots past ladder(max_len) are dead padding —
            # at the 10M geometry the 3x-slack posting cap would cost the
            # sidecar ~1.7 GB of dead device memory plus an in-jit slice
            # copy per scan
            cap = self._cap_eff()
            d_pad = self._sq_d_pad
            self.sq_payload = "sq8"
            if nlist * cap * (d_pad + 4) > self._sq_budget():
                self._sq_drop("build")
                return False
            rot = (self.opq_rot if self.opq_rot is not None
                   else jnp.zeros((0, 0), jnp.float32))
            has_rot = self.opq_rot is not None
            vids_ce = (self.state.vids if cap == self.state.cap
                       else self.state.vids[:, :cap])
            # block size bounds the f32 row gather to ~64 MB
            lb = max(1, min(nlist, (64 << 20) // max(1, cap * self.d * 4)))
            if self.sq_scale is None:
                chunks, got = [], 0
                for s in range(0, nlist - lb + 1, lb):
                    res, live = _sq_block_residuals(
                        self.store.device, vids_ce,
                        self.state.lens, self.centroids, rot,
                        jnp.int32(s), lb=lb, has_rot=has_rot)
                    r = np.asarray(res)[np.asarray(live)]
                    chunks.append(r)
                    got += r.shape[0]
                    if got >= sample_rows:
                        break
                samp = np.concatenate(chunks)[:sample_rows]
                if samp.shape[0] == 0:
                    self._sq_drop("build")
                    return False
                self.sq_scale, self.sq_off = train_sq(jnp.asarray(samp))
            sq_codes = jnp.zeros((nlist, cap, d_pad), jnp.uint8)
            sq_norms = jnp.zeros((nlist, cap), jnp.float32)
            # dynamic_slice clamps the final partial block to nlist-lb:
            # the overlapped lists re-encode to identical values
            starts = list(range(0, nlist - lb + 1, lb))
            if not starts or starts[-1] + lb < nlist:
                starts.append(nlist - lb)
            for s in starts:
                sq_codes, sq_norms = _sq_block_encode(
                    sq_codes, sq_norms, self.store.device, vids_ce,
                    self.centroids, rot, self.sq_scale, self.sq_off,
                    jnp.int32(s), d_pad=d_pad, lb=lb, has_rot=has_rot)
            self.sq_codes, self.sq_norms = sq_codes, sq_norms
            return True

    def _train_opq_init(self, x: jnp.ndarray) -> jnp.ndarray:
        """OPQ rotation init: PCA-orthonormal basis (reference trains a
        faiss OPQMatrix; full alternating refinement lands with
        _refine_opq).  Deterministic, d x d orthogonal."""
        xc = x - jnp.mean(x, axis=0, keepdims=True)
        cov = (xc.T @ xc).astype(jnp.float32)
        _, vecs = jnp.linalg.eigh(cov)
        return vecs[:, ::-1].astype(jnp.float32)   # descending eigenvalue

    def _refine_opq(self, x: jnp.ndarray, residuals: jnp.ndarray,
                    iters: int = 4) -> None:
        """Alternating OPQ refinement: encode/decode under current rotation,
        then procrustes-solve R = argmin ||xR - decode(encode(xR))||."""
        R = self.opq_rot
        for _ in range(iters):
            codes = pq_ops.encode_pq(self.pq, residuals)
            recon = pq_ops.decode_pq(self.pq, codes)[:, : self.d]
            # procrustes: R = UV^T from SVD of X^T Y
            m = (x.T @ recon).astype(jnp.float32)
            u, _, vt = jnp.linalg.svd(m, full_matrices=False)
            R = (u @ vt).astype(jnp.float32)
            xr = x @ R
            assign = _assign_chunked(xr, self.centroids, self.cent_norms)
            residuals = xr - jnp.take(self.centroids, assign, axis=0)
            self.pq = pq_ops.train_pq(residuals, self.p.nsubvector,
                                      nbits=self.p.nbits_per_idx, iters=6)
        self.opq_rot = R

    # ---- realtime add / update / delete ----

    def _rotate(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.opq_rot is not None:
            return (x.astype(jnp.float32) @ self.opq_rot)
        return x

    def _pad_batch(self, x) -> jnp.ndarray:
        """Pad a host or device batch to the shape quantum (bounds the
        number of distinct compiled shapes)."""
        n = x.shape[0]
        n_pad = _pad_quantum(n)
        if isinstance(x, jnp.ndarray):
            return (jnp.pad(x, ((0, n_pad - n), (0, 0)))
                    if n_pad != n else x)
        xp_np = np.zeros((n_pad, self.d), np.float32)
        xp_np[:n] = x
        return jnp.asarray(xp_np)

    def _encode_core(self, xp: jnp.ndarray):
        """Model-specific encode jit over a PADDED device batch.
        Subclasses (FastScan, ScaNN) override just this."""
        return _encode_full(
            xp, self.centroids, self.cent_norms,
            self.pq.codebooks, self.pq.cb_norms,
            self.opq_rot if self.opq_rot is not None
            else jnp.zeros((0, 0), jnp.float32),
            d=self.d, has_rot=self.opq_rot is not None,
            recon_dtype=self.recon_dtype)

    def _encode_device(self, x):
        """Encode with all outputs left ON DEVICE (the ingest fast path
        never reads the assignment back to host).
        → (assign [n_pad] i32, codes [n_pad, M] u8, recon [n_pad, d],
           recon_norms [n_pad] f32)."""
        return self._encode_core(self._pad_batch(x))

    def encode_batch(self, x: np.ndarray
                     ) -> Tuple[np.ndarray, jnp.ndarray, jnp.ndarray,
                                jnp.ndarray]:
        """One fused jit: rotate → assign → residual-encode → reconstruct.
        Rows are padded to a shape quantum (device outputs stay padded;
        the np list_ids are sliced back to n).  `x` may be a DEVICE array
        (e.g. the raw store's bf16 mirror) — the ingest path uses this to
        avoid re-uploading vectors over the host link.
        → (list_ids np [n], codes [n_pad, M] u8, recon bf16 [n_pad, d],
           recon_norms f32 [n_pad])."""
        assign, codes, recon, rnorms = self._encode_device(x)
        n = x.shape[0]
        return np.asarray(assign)[:n], codes, recon, rnorms

    def _grow_recon(self, need_rows: int) -> None:
        cap = self.recon.shape[0]
        if need_rows <= cap:
            return
        # the mirror will eventually cover every stored row — jump straight
        # there so growth (a new shape → a fresh compile) happens once
        from gamma_tpu.utils.growth import grow_rows
        need_rows = max(need_rows, self.store.n)
        new_cap = grow_rows(cap, need_rows, quantum=RECON_ROW_PAD)
        pad = new_cap - cap
        self.recon = jnp.pad(self.recon, ((0, pad), (0, 0)))
        self.recon_norms = jnp.pad(self.recon_norms, (0, pad))
        self.recon_valid = jnp.pad(self.recon_valid, (0, pad),
                                   constant_values=BIG)
        self.recon_bias = jnp.pad(self.recon_bias, (0, pad),
                                  constant_values=BIG)

    def add(self, x: np.ndarray, vids: np.ndarray,
            docids: np.ndarray) -> None:
        """Device-resident ingest: encode → place → commit all run on
        device, with the batch's slot assignment computed against the
        LIVE device lens (_place_batch) — no assignment readback, no
        host placement (the old path cost 3-4 host round trips per
        chunk).  The only host sync is the exact `need` scalar that
        gates capacity growth (the reference's ExtendBucketMem decision,
        realtime_mem_data.cc:152-188).  The host vid→(list,pos) map is
        refreshed LAZILY from the retained device arrays the first time
        delete/compact/status needs it (_drain_place)."""
        assert self._trained, "IVFPQ.add before train"
        import time as _time
        n = x.shape[0]
        if n == 0:
            return
        _t = {}
        _t0 = _time.perf_counter()
        xp = self._pad_batch(x)
        assign, codes, recon, rnorms = self._encode_core(xp)
        _t["encode"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        n_pad = codes.shape[0]
        idp = np.full((2, n_pad), -1, np.int64)
        idp[0, :n] = vids
        idp[1, :n] = docids
        idp = idp.astype(np.int32)
        idp_d = jnp.asarray(idp)
        vids_d, docids_d = idp_d[0], idp_d[1]
        _t["upload"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        positions, new_lens, need_d = _place_batch(
            self.state.lens, assign, vids_d, nlist=self.p.ncentroids)
        need = int(need_d)          # the one host sync on the add path
        if need > self.state.cap:
            # bounded overshoot, not pow2 (utils/growth.py): list state
            # carries codes + ids + the SQ8 sidecar — doubling a large
            # cap wastes up to 2x device memory and evicted the sidecar
            # past its byte budget at the 10M geometry
            from gamma_tpu.utils.growth import grow_rows
            new_cap = grow_rows(self.state.cap, need, quantum=1024)
            if new_cap > self.p.bucket_max_size:
                # bucket_max_size is a sizing hint (reference caps lists
                # there); clamping below `need` would silently drop the
                # overflow scatters, so grow anyway and say so
                import logging
                logging.getLogger("gamma_tpu").warning(
                    "list capacity %d exceeds bucket_max_size %d",
                    new_cap, self.p.bucket_max_size)
            # positions stay valid across growth: they depend on lens,
            # not cap
            self.state = rt.grow(self.state, new_cap)
            self.placer.cap = new_cap
        self._max_len = max(self._max_len, need)
        # sidecar growth is NEED-based (ladder(max_len)), decoupled from
        # posting-cap growth: scatters beyond the sidecar width drop
        # silently, so this must precede _sq_append
        self._sq_grow(need)
        _t["place"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        if self.sq_active:
            # SQ8 sidecar scatter BEFORE the posting publish: a search
            # between the two sees consistent state either way (rows
            # become scannable only once the posting entry lands)
            sqc, sqn = _sq_encode_batch(
                xp, self.opq_rot if self.opq_rot is not None
                else jnp.zeros((0, 0), jnp.float32),
                self.centroids, assign, self.sq_scale, self.sq_off,
                d_pad=self._sq_d_pad, has_rot=self.opq_rot is not None)
            self.sq_codes, self.sq_norms = _sq_append(
                self.sq_codes, self.sq_norms, assign, positions, vids_d,
                sqc, sqn)
        _t["sq"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        if self.keep_recon:
            self._grow_recon(int(np.max(vids)) + 1)
            big = (self.recon.nbytes + self.state.codes.nbytes
                   > SPLIT_COMMIT_BYTES)
            if big:
                (self.recon, self.recon_norms, self.recon_valid,
                 self.recon_bias) = _recon_commit(
                    self.recon, self.recon_norms, self.recon_valid,
                    self.recon_bias, vids_d, recon, rnorms)
                self.state = _append_placed(self.state, assign, positions,
                                            codes, vids_d, docids_d,
                                            new_lens)
            else:
                (self.state, self.recon, self.recon_norms,
                 self.recon_valid, self.recon_bias) = _commit_placed(
                    self.state, self.recon, self.recon_norms,
                    self.recon_valid, self.recon_bias, assign, positions,
                    codes, vids_d, docids_d, new_lens, recon, rnorms)
        else:
            self.state = _append_placed(self.state, assign, positions,
                                        codes, vids_d, docids_d, new_lens)
        _t["commit"] = _time.perf_counter() - _t0
        self.last_add_timings = _t
        # host placer map refreshed lazily: retain the device assignment
        # until something (delete/compact/dump) needs host (list, pos).
        # Start the host copies NOW (non-blocking) so the eventual drain
        # pays no per-batch round trip, and bound the retained batches
        # (add-only workloads would otherwise accumulate forever).
        try:
            assign.copy_to_host_async()
            positions.copy_to_host_async()
        except AttributeError:      # non-jax arrays in tests
            pass
        self._pending_place.append(
            (np.asarray(vids, dtype=np.int64).copy(), n, assign,
             positions))
        if len(self._pending_place) >= 512:
            self._drain_place()
        # watermark = highest vid pumped + 1; update re-adds of old vids
        # must not inflate it past fresh rows (pump skips them otherwise)
        self.indexed_count = max(self.indexed_count,
                                 int(np.max(vids)) + 1)

    def _drain_place(self) -> None:
        """Materialize pending device placements into the host placer
        (ordered; one readback per pending batch, amortized across all
        the adds since the last drain)."""
        if not self._pending_place:
            return
        pend, self._pending_place = self._pending_place, []
        for vids_h, n, assign_d, pos_d in pend:
            li = np.asarray(assign_d)[:n].astype(np.int32)
            ps = np.asarray(pos_d)[:n].astype(np.int32)
            self.placer.register(li, ps, vids_h)

    def delete(self, vids: np.ndarray) -> None:
        vids = np.asarray(vids, dtype=np.int64)
        if vids.size == 0:
            return
        self._drain_place()          # host map must cover pending adds
        ls, ps = self.placer.locate(vids)
        live = ls >= 0
        if live.any():
            self.state = rt.tombstone(
                self.state,
                jnp.asarray(ls[live], jnp.int32),
                jnp.asarray(ps[live], jnp.int32))
            self.placer.mark_deleted(vids[live])
            if self.keep_recon:
                dv = jnp.asarray(vids[live], jnp.int32)
                self.recon_valid = _valid_set(self.recon_valid, dv, BIG)
                self.recon_bias = _valid_set(self.recon_bias, dv, BIG)

    def compact(self, threshold: float = 0.3) -> None:
        """Reclaim tombstoned slots when ≥30% dead (reference policy:
        realtime_mem_data.cc:373-377)."""
        self._drain_place()
        if self.placer.deleted_fraction() < threshold:
            return
        if self.sq_active:
            self.state, (self.sq_codes, self.sq_norms) = \
                rt.compact_state_with(
                    self.state, (self.sq_codes, self.sq_norms))
        else:
            self.state = rt.compact_state(self.state)
        lens_np = np.asarray(self.state.lens)
        self._max_len = int(lens_np.max(initial=0))
        self.placer.resync_after_compact(
            np.asarray(self.state.docids), np.asarray(self.state.vids),
            lens_np)

    # ---- search ----

    def _live_n_scalar(self, validity_n) -> jnp.ndarray:
        """Device scalar for the live watermark, cached by value — a
        fresh jnp.int32 per call is a host→device upload on the search
        hot path."""
        c = getattr(self, "_live_n_cache", None)
        v = int(validity_n)
        if c is None or c[0] != v:
            c = (v, jnp.int32(v))
            self._live_n_cache = c
        return c[1]

    def _dense_penalty(self, penalty: jnp.ndarray) -> jnp.ndarray:
        """Vid-align the doc-aligned penalty and fold in slot validity."""
        cap = self.recon.shape[0]
        if self.store.vid_mgr.multi:
            v2d = np.full(cap, -1, np.int32)
            src = self.store.vid_mgr._vid2doc
            m = min(cap, src.size)
            v2d[:m] = src[:m]
            pen = jnp.take(penalty, jnp.asarray(v2d), mode="fill",
                           fill_value=BIG)
        elif penalty.shape[0] >= cap:
            pen = penalty[:cap]
        else:
            pen = jnp.pad(penalty, (0, cap - penalty.shape[0]),
                          constant_values=BIG)
        return pen + self.recon_valid

    def release_recon(self) -> None:
        """Drop the dense reconstruction mirror and serve gather-only —
        the capacity-tier operating point (a beyond-HBM deployment never
        holds the [N, d] mirror; the SQ8 sidecar / ADC codes are the
        scan payload).  Frees ~N*d*recon_dtype bytes of device memory;
        irreversible
        until a dump/load rebuilds the mirror."""
        with self.mutate_lock:
            self.keep_recon = False
            self.recon = jnp.zeros((8, self.d), self.recon_dtype)
            self.recon_norms = jnp.zeros((8,), jnp.float32)
            self.recon_valid = jnp.full((8,), BIG, jnp.float32)
            self.recon_bias = jnp.full((8,), BIG, jnp.float32)

    def scan_mode(self, sp: SearchParams) -> str:
        if not self.keep_recon:
            return "gather"        # disk tier: no dense mirror exists
        mode = sp.scan_mode or self.p.scan_mode
        if mode == "auto":
            mirror_bytes = (self.recon.size * self.recon.dtype.itemsize
                            + self.recon_norms.size * 4
                            + self.recon_valid.size * 4)
            budget = scaled_budget(DENSE_BYTES_BUDGET,
                                   device_of(self.recon))
            mode = "dense" if mirror_bytes <= budget else "gather"
        if mode == "dense" and self.store.released:
            # XLA clamps the dense scan's row gathers, so a released
            # mirror would return silently wrong distances
            raise RuntimeError(
                "dense scan requested but the raw store's device mirror "
                "was released (release_device); call store.flush_device()"
                " to re-mirror or search in gather mode")
        return mode

    def _brute_fallback(self, queries, penalty, k, metric, dist_range):
        """Brute-force fallback (reference: ivfpq.cc:529-537); the disk
        tier streams the host corpus (no device mirror)."""
        if self.store.tier == "disk":
            from gamma_tpu.ops.flat_scan import flat_search_streaming
            d, rows = flat_search_streaming(
                self.store.header(0, self.store.n), self.store.n,
                queries, penalty, dist_range, k=k, metric=metric)
        else:
            # align the doc-space penalty to the mirror's row capacity
            # (they grow on independent quanta)
            cap = self.store.device.shape[0]
            if penalty.shape[0] < cap:
                penalty = jnp.pad(penalty, (0, cap - penalty.shape[0]),
                                  constant_values=BIG)
            elif penalty.shape[0] > cap:
                penalty = penalty[:cap]
            d, rows = flat_search(self.store.device,
                                  self.store.device_norms,
                                  queries, penalty, dist_range,
                                  k=k, metric=metric)
        return d, rows, rows

    def _gather_exec(self, fn, q, queries, penalty, sp: SearchParams,
                     k: int, recall_num: int, metric: str, dist_range,
                     nprobe: int, validity_n=None):
        """Run a gather-mode scan fn; on the disk tier the exact rerank
        happens OUTSIDE the jit against host-fetched candidate rows
        (reference: rocksdb_raw_vector.cc GetVector in compute_dis).

        validity_n (set by the engine for UNFILTERED requests) switches
        the in-scan mask to the gather-free validity form (no doc-space
        penalty gather)."""
        live_n = (None if validity_n is None
                  else self._live_n_scalar(validity_n))
        if self.store.tier != "disk":
            # in-jit rerank gathers rows by vid from the device mirror;
            # a released mirror would rerank against clamped row 0
            assert not (sp.has_rank and self.store.released), (
                "gather rerank needs the device mirror but it was "
                "released; flush_device() or search with has_rank=False")
            return fn(self.state, self.centroids, self.cent_norms, self.pq,
                      q, penalty, self.store.device, queries, dist_range,
                      live_n,
                      nprobe=nprobe, recall_num=recall_num, k=k,
                      metric=metric, rerank=sp.has_rank,
                      cap_eff=self._cap_eff())
        rn = max(recall_num, k)
        rd, rdoc, rvid = fn(
            self.state, self.centroids, self.cent_norms, self.pq,
            q, penalty, self.store.device, queries, dist_range,
            live_n,
            nprobe=nprobe, recall_num=rn, k=rn, metric=metric,
            rerank=False, cap_eff=self._cap_eff())
        if not sp.has_rank:
            return rd[:, :k], rdoc[:, :k], rvid[:, :k]
        rows = self.store.get_padded(np.asarray(rvid))      # [B, R, d]
        return ivf_scan.rerank_rows(queries, rd, rdoc, rvid,
                                    jnp.asarray(rows), dist_range,
                                    k=k, metric=metric)

    def search(self, queries, penalty, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        metric = self.metric_name(sp, self.p.metric_type)
        if not self._trained:
            return self._brute_fallback(queries, penalty, k, metric,
                                        dist_range)
        recall_num = max(sp.recall_num, k)
        q = self._rotate(queries)
        if self.scan_mode(sp) == "dense":
            if (validity_n is not None and dist_range is None
                    and not self.store.vid_mgr.multi):
                # unfiltered fast path: norms+validity pre-fused into
                # recon_bias so the scan is one matmul + one broadcast
                # feeding the candidate select
                # (multi-vid stores keep the doc-aligned penalty path —
                # the watermark lives in doc space)
                bias = (self.recon_valid if metric == "ip"
                        else self.recon_bias)
                d, vids = dense_scan_search_fast(
                    self.recon, bias, q, queries, self.store.device,
                    self._live_n_scalar(validity_n),
                    recall_num=recall_num, k=k, metric=metric,
                    rerank=sp.has_rank)
            else:
                d, vids = dense_scan_search(
                    self.recon, self.recon_norms, q,
                    self._dense_penalty(penalty), self.store.device,
                    queries, dist_range,
                    recall_num=recall_num, k=k, metric=metric,
                    rerank=sp.has_rank)
            if self.store.vid_mgr.multi:
                v_np = np.asarray(vids)
                docids = np.where(
                    v_np < 0, -1,
                    self.store.vid_mgr.vid2doc(np.maximum(v_np, 0)))
                return np.asarray(d), docids, v_np
            return d, vids, vids
        nprobe = min(sp.nprobe or self.p.nprobe, self.p.ncentroids)
        if self.sq_active:
            # residual-SQ8 exact scan: top-k straight out of the select,
            # no recall heap, no rerank row gather (ops/sq.py).
            # sp.sq_rerank opts into an exact-rerank stage against the
            # store mirror (recovers the SQ8 near-tie misrank at 10M
            # density) — it needs the
            # mirror resident, so a released mirror falls back to the
            # rerank-free scan rather than reranking against garbage.
            live_n = (None if validity_n is None
                      else self._live_n_scalar(validity_n))
            do_rr = (sp.sq_rerank and sp.has_rank
                     and self.store.tier != "disk"
                     and not self.store.released)
            d_out, docs, vids = ivf_scan.ivfsq_search(
                self.state, self.sq_codes, self.sq_norms, self.sq_scale,
                self.sq_off, self.centroids, self.cent_norms, q, penalty,
                dist_range, live_n,
                self.store.device if do_rr else None,
                queries if do_rr else None,
                nprobe=nprobe, k=k, metric=metric,
                cap_eff=self._cap_eff(),
                recall_num=recall_num if do_rr else 0, rerank=do_rr)
            return d_out, docs, vids
        return self._gather_exec(ivf_scan.ivfpq_search, q, queries,
                                 penalty, sp, k, recall_num, metric,
                                 dist_range, nprobe,
                                 validity_n=validity_n)

    # ---- persistence (reference: gamma_index_io.cc "ilar" format) ----

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        f = os.path.join(path, f"{self.store.name}.{self._dump_suffix}.npz")
        if not self._trained:
            np.savez(f, trained=np.array(0))
            return
        extra = {}
        if self.sq_active:
            extra = dict(sq_codes=np.asarray(self.sq_codes),
                         sq_norms=np.asarray(self.sq_norms),
                         sq_scale=np.asarray(self.sq_scale),
                         sq_off=np.asarray(self.sq_off))
        np.savez(
            f,
            trained=np.array(1),
            centroids=np.asarray(self.centroids),
            codebooks=np.asarray(self.pq.codebooks),
            opq_rot=(np.asarray(self.opq_rot)
                     if self.opq_rot is not None else np.zeros(0)),
            codes=np.asarray(self.state.codes),
            vids=np.asarray(self.state.vids),
            docids=np.asarray(self.state.docids),
            lens=np.asarray(self.state.lens),
            indexed_count=np.array(self.indexed_count),
            **extra,
        )

    def load(self, path: str) -> int:
        f = os.path.join(path, f"{self.store.name}.{self._dump_suffix}.npz")
        if not os.path.exists(f):
            return 0
        z = np.load(f)
        if int(z["trained"]) == 0:
            return 0
        self.centroids = jnp.asarray(z["centroids"])
        self.cent_norms = l2_norms(self.centroids)
        cb = jnp.asarray(z["codebooks"])
        self.pq = pq_ops.PQCodebooks(cb, jnp.sum(cb * cb, axis=-1))
        rot = z["opq_rot"]
        self.opq_rot = jnp.asarray(rot) if rot.size else None
        self.state = rt.IVFState(
            jnp.asarray(z["codes"]), jnp.asarray(z["vids"]),
            jnp.asarray(z["docids"]), jnp.asarray(z["lens"]))
        self.placer = rt.HostPlacer(self.state.nlist, self.state.cap)
        self.placer.resync_after_compact(
            z["docids"], z["vids"], z["lens"])
        self._pending_place = []     # pre-load placements are stale
        self.indexed_count = int(z["indexed_count"])
        self._max_len = int(np.asarray(z["lens"]).max(initial=0))
        if "sq_codes" in z.files and self.sq_payload == "sq8":
            self.sq_codes = jnp.asarray(z["sq_codes"])
            self.sq_norms = jnp.asarray(z["sq_norms"])
            self.sq_scale = jnp.asarray(z["sq_scale"])
            self.sq_off = jnp.asarray(z["sq_off"])
        else:
            # older dump without the sidecar: gather tier uses the ADC
            # scan until a retrain/rebuild
            self.sq_codes = self.sq_norms = None
        self._trained = True
        self._rebuild_recon()
        return self.indexed_count

    def _rebuild_recon(self) -> None:
        """Regenerate the dense-scan reconstruction mirror from the codes
        (the reference likewise rebuilds precomputed tables on load rather
        than storing them, gamma_index_ivfpq.cc:1032-1034)."""
        if not self.keep_recon:
            return
        vids_np = np.asarray(self.state.vids)
        codes_np = np.asarray(self.state.codes)
        nlist, cap = vids_np.shape
        lists = np.repeat(np.arange(nlist, dtype=np.int32), cap)
        vflat = vids_np.reshape(-1)
        cflat = codes_np.reshape(-1, codes_np.shape[-1])
        live = vflat >= 0
        if not live.any():
            return
        lists, vflat, cflat = lists[live], vflat[live], cflat[live]
        self._grow_recon(int(vflat.max()) + 1)
        chunk = 262144
        for s in range(0, vflat.size, chunk):
            e = min(vflat.size, s + chunk)
            coarse = jnp.take(self.centroids,
                              jnp.asarray(lists[s:e]), axis=0)
            rec = (coarse + pq_ops.decode_pq(
                self.pq, jnp.asarray(cflat[s:e]))[:, : self.d]
            ).astype(self.recon_dtype)
            vd = jnp.asarray(vflat[s:e], jnp.int32)
            self.recon, self.recon_norms, self.recon_bias = _recon_append(
                self.recon, self.recon_norms, self.recon_bias, vd,
                rec, l2_norms(rec.astype(jnp.float32)))
            self.recon_valid = _valid_set(self.recon_valid, vd, 0.0)

    def mem_bytes(self) -> int:
        m = self.state.mem_bytes()
        m += self.recon.size * self.recon.dtype.itemsize + self.recon_norms.size * 4
        m += self.recon_valid.size * 4 + self.recon_bias.size * 4
        if self.sq_active:
            m += self.sq_codes.size + self.sq_norms.size * 4
        if self.centroids is not None:
            m += self.centroids.size * 4
        if self.pq is not None:
            m += self.pq.codebooks.size * 4
        return int(m)
