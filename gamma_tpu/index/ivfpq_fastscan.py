"""IVFPQ FastScan — 4-bit PQ with packed codes and a ksub=16 scan kernel.

Reference: index/impl/gamma_index_ivfpqfs.{h,cc} — faiss IndexIVFPQFastScan
under the gamma realtime layer.  Capability contract kept:
  * nbits_per_idx is forced to 4 (ivfpqfs.cc:209 "only support 4 now");
  * codes are packed two-per-byte (BlockInvertedLists stores bbs*M2/2
    bytes per block, ivfpqfs.cc:149) — posting payload is M/2 bytes;
  * same realtime add/update/delete/compact + dump/load surface.

Documented deviation: the reference forces by_residual=false
(ivfpqfs.cc:146) because its AVX2 shuffle wants ONE 16-entry LUT per
query; that costs ~2 recall points at nlist≈2k.  Here by_residual
defaults to TRUE: the gather scan builds one LUT per (query, probed
list) from the residuals either way.  Set params {"by_residual": false}
for the reference layout.

Substitutions:
  * the reference's bbs=32 AVX2 register blocking (vpshufb over 16-entry
    LUTs) becomes the XLA LUT gather-sum over unpacked nibbles
    (ops/ivf_scan.ivfpqfs_search);
  * dense scan mode is inherited unchanged — the reconstruction mirror is
    decode(code), plus the coarse centroid when by_residual.

Defaults follow the reference: nsubvector=64 (d/2 at SIFT dims), so the
code budget is 32 B/vec — the same as IVFPQ M=32 x 8 bit — with ~8x less
scan ALU work at some recall cost (recovered by the exact rerank).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gamma_tpu.config import SearchParams
from gamma_tpu.index.ivfpq import IVFPQIndex, _assign_chunked
from gamma_tpu.index.registry import register_model
from gamma_tpu.ops import ivf_scan, kmeans as km, pq as pq_ops
from gamma_tpu.ops.distances import l2_norms
from gamma_tpu.ops.flat_scan import flat_search
from gamma_tpu.vector.raw_store import RawVectorStore


@functools.partial(jax.jit, static_argnames=("d", "has_rot", "recon_dtype",
                                             "by_residual"))
def _encode_fastscan(x, cents, cnorms, cb, cb_norms, rot, *, d, has_rot,
                     recon_dtype=jnp.bfloat16, by_residual=True):
    """Fused ingest: rotate → coarse assign → 4-bit PQ → pack nibbles →
    reconstruct for the dense mirror.  by_residual=True quantizes the
    residual (our default); False keeps the reference's raw-vector layout
    (gamma_index_ivfpqfs.cc:146)."""
    xf = x.astype(jnp.float32)
    if has_rot:
        xf = xf @ rot
    assign = _assign_chunked(xf, cents, cnorms, chunk=16384)
    pq = pq_ops.PQCodebooks(cb, cb_norms)
    if by_residual:
        coarse = jnp.take(cents, assign, axis=0)
        codes = pq_ops.encode_pq(pq, xf - coarse)      # [n, M] 0..15
        recon = (coarse + pq_ops.decode_pq(pq, codes)[:, :d]
                 ).astype(recon_dtype)
    else:
        codes = pq_ops.encode_pq(pq, xf)
        recon = pq_ops.decode_pq(pq, codes)[:, :d].astype(recon_dtype)
    packed = (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(jnp.uint8)
    return (assign.astype(jnp.int32), packed, recon,
            l2_norms(recon.astype(jnp.float32)))


@register_model("IVFPQ_FASTSCAN")
class IVFPQFastScanIndex(IVFPQIndex):
    _dump_suffix = "ivfpqfs"
    # packed 4-bit codes ARE this model's capacity payload; the SQ8
    # sidecar would never be scanned (search overrides the gather path)
    _sq_payload_default = "pq"
    packed_codes = True      # sharded scan body unpacks in-register

    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        p = dict(params or {})
        # reference forces 4-bit codes (ivfpqfs.cc:209) and defaults M to
        # a finer split than 8-bit PQ (IVFPQFastScanModelParams)
        p["nbits_per_idx"] = 4
        p.setdefault("nsubvector", 64)
        if int(p["nsubvector"]) % 2:
            raise ValueError("IVFPQ_FASTSCAN requires even nsubvector "
                             "(codes pack two 4-bit entries per byte)")
        # deviation from the reference's forced by_residual=false
        # (ivfpqfs.cc:146): residual coding recovers ~2 recall points at
        # nlist≈2k; the gather scan builds per-(query, list) LUTs anyway
        self.by_residual = bool(p.get("by_residual", True))
        super().__init__(raw_store, p)

    def _code_width(self) -> int:
        return self.p.nsubvector // 2

    # ---- training: PQ on the rotated vector, not the residual ----

    def train(self, x: np.ndarray, coarse=None) -> None:
        if self.by_residual:
            # residual 4-bit PQ trains exactly like 8-bit IVFPQ
            # (nbits_per_idx=4 is already forced in params); `coarse`
            # seeds a shared coarse quantizer (see IVFPQIndex.train)
            super().train(x, coarse=coarse)
            return
        if isinstance(x, jax.Array) and not isinstance(x, np.ndarray):
            xd = self.clamp_train_set(x).astype(jnp.float32)
        else:
            xd = jnp.asarray(
                self.clamp_train_set(np.asarray(x, np.float32)))
        if self.p.has_opq:
            self.opq_rot = self._train_opq_init(xd)
            xd = xd @ self.opq_rot
        if coarse is not None:
            cents = jnp.asarray(coarse[0])
            self.centroids = cents
            self.cent_norms = (jnp.asarray(coarse[1])
                               if len(coarse) > 1 and coarse[1] is not None
                               else l2_norms(cents))
            self.pq = pq_ops.train_pq(self._pq_train_rows(xd),
                                      self.p.nsubvector, nbits=4,
                                      iters=12)
            if self.p.has_opq:
                self._refine_opq_fs(xd)
            self._trained = True
            return
        cents, _ = km.kmeans(xd, self.p.ncentroids, iters=10, seed=0)
        self.centroids = cents
        self.cent_norms = l2_norms(cents)
        self.pq = pq_ops.train_pq(self._pq_train_rows(xd),
                                  self.p.nsubvector, nbits=4, iters=12)
        if self.p.has_opq:
            self._refine_opq_fs(xd)
        self._trained = True

    def _refine_opq_fs(self, x: jnp.ndarray, iters: int = 4) -> None:
        """Procrustes OPQ refinement against the non-residual decode."""
        R = self.opq_rot
        for _ in range(iters):
            codes = pq_ops.encode_pq(self.pq, x)
            recon = pq_ops.decode_pq(self.pq, codes)[:, : self.d]
            m = (x.T @ recon).astype(jnp.float32)
            u, _, vt = jnp.linalg.svd(m, full_matrices=False)
            R = (u @ vt).astype(jnp.float32)
            x = x @ R
            self.pq = pq_ops.train_pq(x, self.p.nsubvector,
                                      nbits=4, iters=6)
        self.opq_rot = R

    # ---- ingest ----

    def _encode_core(self, xp):
        return _encode_fastscan(
            xp, self.centroids, self.cent_norms,
            self.pq.codebooks, self.pq.cb_norms,
            self.opq_rot if self.opq_rot is not None
            else jnp.zeros((0, 0), jnp.float32),
            d=self.d, has_rot=self.opq_rot is not None,
            recon_dtype=self.recon_dtype, by_residual=self.by_residual)

    # ---- search ----

    def search(self, queries, penalty, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        metric = self.metric_name(sp, self.p.metric_type)
        if not self._trained:
            return self._brute_fallback(queries, penalty, k, metric,
                                        dist_range)
        recall_num = max(sp.recall_num, k)
        q = self._rotate(queries)
        if self.scan_mode(sp) == "dense":
            return super().search(queries, penalty, sp, k, dist_range,
                                  validity_n=validity_n)
        nprobe = min(sp.nprobe or self.p.nprobe, self.p.ncentroids)
        # _gather_exec routes the disk tier's rerank through the host
        # read-through path instead of the (absent) device mirror
        fn = functools.partial(ivf_scan.ivfpqfs_search,
                               by_residual=self.by_residual)
        return self._gather_exec(fn, q, queries,
                                 penalty, sp, k, recall_num, metric,
                                 dist_range, nprobe,
                                 validity_n=validity_n)

    # ---- persistence ----

    def _rebuild_recon(self) -> None:
        """Mirror rebuild from packed codes: decode(unpack(code)), plus
        the coarse centroid when by_residual."""
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
        from gamma_tpu.index.ivfpq import _recon_append, _valid_set
        chunk = 262144
        for s in range(0, vflat.size, chunk):
            e = min(vflat.size, s + chunk)
            codes = pq_ops.unpack_nibbles(jnp.asarray(cflat[s:e]))
            rec = pq_ops.decode_pq(self.pq, codes)[:, : self.d]
            if self.by_residual:
                rec = rec + jnp.take(self.centroids,
                                     jnp.asarray(lists[s:e]), axis=0)
            rec = rec.astype(self.recon_dtype)
            vd = jnp.asarray(vflat[s:e], jnp.int32)
            self.recon, self.recon_norms, self.recon_bias = _recon_append(
                self.recon, self.recon_norms, self.recon_bias, vd,
                rec, l2_norms(rec.astype(jnp.float32)))
            self.recon_valid = _valid_set(self.recon_valid, vd, 0.0)
