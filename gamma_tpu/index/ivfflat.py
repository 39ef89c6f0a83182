"""IVFFlat: IVF cells with full vectors as the posting payload.

Reference: index/impl/gamma_index_ivfflat.{h,cc} — faiss IndexIVFFlat with
realtime lists; the scanner computes exact L2/IP per posting
(ivfflat.h:31-77).  Here the payload is bf16 vector bytes stored in the
same IVFState container; the scan bitcasts back and computes exact
distances on the VPU (ops/ivf_scan.ivfflat_search).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gamma_tpu.config import IVFPQParams, MetricType, SearchParams
from gamma_tpu.index.model import RetrievalModel
from gamma_tpu.index.registry import register_model
from gamma_tpu.ops import ivf_scan, kmeans as km
from gamma_tpu.ops.distances import l2_norms
from gamma_tpu.ops.flat_scan import flat_search
from gamma_tpu.realtime import invert_index as rt
from gamma_tpu.vector.raw_store import RawVectorStore
from gamma_tpu.index.ivfpq import _assign_chunked, TRAIN_MAX_PER_LIST
from gamma_tpu.utils.growth import grow_rows, ladder_256


@jax.jit
def _to_bf16_bytes(x: jnp.ndarray) -> jnp.ndarray:
    b = x.astype(jnp.bfloat16)
    u8 = jax.lax.bitcast_convert_type(b, jnp.uint8)    # [n, d, 2]
    return u8.reshape(x.shape[0], -1)


@register_model("IVFFLAT")
class IVFFlatIndex(RetrievalModel):
    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(raw_store, params)
        p = dict(params or {})
        p.setdefault("ncentroids", 256)   # reference default for ivfflat
        self.p = IVFPQParams.from_dict(p)
        self.d = raw_store.d
        self._trained = False
        self.centroids = None
        self.cent_norms = None
        init_cap = max(64, self.p.bucket_init_size)
        self.state = rt.init_state(self.p.ncentroids, init_cap, self.d * 2)
        self.placer = rt.HostPlacer(self.p.ncentroids, init_cap)
        self._max_len = 0          # live list-length watermark (host)

    def trained(self) -> bool:
        return self._trained

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        hi = self.p.ncentroids * TRAIN_MAX_PER_LIST
        if x.shape[0] > hi:
            x = x[np.random.default_rng(0).choice(x.shape[0], hi,
                                                  replace=False)]
        cents, _ = km.kmeans(jnp.asarray(x), self.p.ncentroids, iters=10)
        self.centroids = cents
        self.cent_norms = l2_norms(cents)
        self._trained = True

    def add(self, x: np.ndarray, vids: np.ndarray,
            docids: np.ndarray) -> None:
        assert self._trained
        if x.shape[0] == 0:
            return
        xd = jnp.asarray(x, jnp.float32)
        list_ids = np.asarray(
            _assign_chunked(xd, self.centroids, self.cent_norms))
        codes = _to_bf16_bytes(xd)
        need = self.placer.required_cap(list_ids)
        if need > self.state.cap:
            new_cap = grow_rows(self.state.cap, need, quantum=1024)
            self.state = rt.grow(self.state, new_cap)
            self.placer.cap = new_cap
        self._max_len = max(self._max_len, need)
        positions, new_lens = self.placer.place(list_ids, vids)
        self.state = rt.append(
            self.state, jnp.asarray(list_ids, jnp.int32),
            jnp.asarray(positions, jnp.int32), codes,
            jnp.asarray(vids, jnp.int32), jnp.asarray(docids, jnp.int32),
            jnp.asarray(new_lens, jnp.int32))
        # watermark = highest vid pumped + 1; update re-adds of old vids
        # must not inflate it past fresh rows (pump skips them otherwise)
        self.indexed_count = max(self.indexed_count,
                                 int(np.max(vids)) + 1)

    def delete(self, vids: np.ndarray) -> None:
        vids = np.asarray(vids, np.int64)
        if vids.size == 0:
            return
        ls, ps = self.placer.locate(vids)
        live = ls >= 0
        if live.any():
            self.state = rt.tombstone(
                self.state, jnp.asarray(ls[live], jnp.int32),
                jnp.asarray(ps[live], jnp.int32))
            self.placer.mark_deleted(vids[live])

    def compact(self, threshold: float = 0.3) -> None:
        if self.placer.deleted_fraction() < threshold:
            return
        self.state = rt.compact_state(self.state)
        lens_np = np.asarray(self.state.lens)
        self._max_len = int(lens_np.max(initial=0))
        self.placer.resync_after_compact(
            np.asarray(self.state.docids), np.asarray(self.state.vids),
            lens_np)

    def search(self, queries, penalty, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        metric = self.metric_name(sp, self.p.metric_type)
        if not self._trained:
            d, rows = flat_search(self.store.device, self.store.device_norms,
                                  queries, penalty, dist_range,
                                  k=k, metric=metric)
            return d, rows, rows
        nprobe = min(sp.nprobe or max(1, self.p.ncentroids // 16),
                     self.p.ncentroids)
        return ivf_scan.ivfflat_search(
            self.state, self.centroids, self.cent_norms, queries, penalty,
            dist_range, nprobe=nprobe, k=k, d=self.d, metric=metric,
            cap_eff=ladder_256(max(self._max_len, 1), self.state.cap))

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        f = os.path.join(path, f"{self.store.name}.ivfflat.npz")
        if not self._trained:
            np.savez(f, trained=np.array(0))
            return
        np.savez(f, trained=np.array(1),
                 centroids=np.asarray(self.centroids),
                 codes=np.asarray(self.state.codes),
                 vids=np.asarray(self.state.vids),
                 docids=np.asarray(self.state.docids),
                 lens=np.asarray(self.state.lens),
                 indexed_count=np.array(self.indexed_count))

    def load(self, path: str) -> int:
        f = os.path.join(path, f"{self.store.name}.ivfflat.npz")
        if not os.path.exists(f):
            return 0
        z = np.load(f)
        if int(z["trained"]) == 0:
            return 0
        self.centroids = jnp.asarray(z["centroids"])
        self.cent_norms = l2_norms(self.centroids)
        self.state = rt.IVFState(
            jnp.asarray(z["codes"]), jnp.asarray(z["vids"]),
            jnp.asarray(z["docids"]), jnp.asarray(z["lens"]))
        self.placer = rt.HostPlacer(self.state.nlist, self.state.cap)
        self.placer.resync_after_compact(z["docids"], z["vids"], z["lens"])
        self._max_len = int(np.asarray(z["lens"]).max(initial=0))
        self.indexed_count = int(z["indexed_count"])
        self._trained = True
        return self.indexed_count

    def mem_bytes(self) -> int:
        m = self.state.mem_bytes()
        if self.centroids is not None:
            m += self.centroids.size * 4
        return int(m)
