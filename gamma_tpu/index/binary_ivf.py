"""Binary IVF: Hamming-distance retrieval over packed bit codes.

Reference: index/impl/gamma_index_binary_ivf.{h,cc} — faiss IndexBinaryIVF
(vectors of dimension/8 bytes, Hamming metric) with realtime lists.

Input contract deviation (documented): the reference ingests pre-binarized
uint8 vectors; this engine's ingest path carries float vectors, so the
model binarizes by sign (bit = x > 0) at train/add/search time.  Users
with native binary data pass ±1 floats and get exact parity.  Hamming
distance = XOR + `lax.population_count` in one fused XLA reduction — no scalar
loops.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gamma_tpu.config import IVFPQParams, SearchParams
from gamma_tpu.index.model import RetrievalModel
from gamma_tpu.index.registry import register_model
from gamma_tpu.ops import ivf_scan, kmeans as km
from gamma_tpu.ops.distances import l2_norms, BIG
from gamma_tpu.realtime import invert_index as rt
from gamma_tpu.vector.raw_store import RawVectorStore
from gamma_tpu.index.ivfpq import _assign_chunked, TRAIN_MAX_PER_LIST


def pack_bits_np(x: np.ndarray) -> np.ndarray:
    """float [n, d] → packed sign bits u8 [n, ceil(d/8)] (little-endian
    within a byte, matching np.packbits(bitorder='little'))."""
    bits = (np.asarray(x) > 0)
    return np.packbits(bits, axis=-1, bitorder="little")


@register_model("BINARYIVF")
class BinaryIVFIndex(RetrievalModel):
    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(raw_store, params)
        p = dict(params or {})
        p.setdefault("ncentroids", 256)
        self.p = IVFPQParams.from_dict(p)
        self.d = raw_store.d
        self.width = -(-self.d // 8)
        self._trained = False
        self.centroid_bits = None        # [nlist, width] u8
        self._cent_f = None              # float centroids for assignment
        self._cent_norms = None
        init_cap = max(64, self.p.bucket_init_size)
        self.state = rt.init_state(self.p.ncentroids, init_cap, self.width)
        self.placer = rt.HostPlacer(self.p.ncentroids, init_cap)

    def trained(self) -> bool:
        return self._trained

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        hi = self.p.ncentroids * TRAIN_MAX_PER_LIST
        if x.shape[0] > hi:
            x = x[np.random.default_rng(0).choice(x.shape[0], hi,
                                                  replace=False)]
        # k-means in sign space: cluster the ±1 embedding of the bits so
        # centroids binarize faithfully (reference trains k-means on the
        # binary vectors' float lift inside faiss).
        signs = np.where(x > 0, 1.0, -1.0).astype(np.float32)
        cents, _ = km.kmeans(jnp.asarray(signs), self.p.ncentroids,
                             iters=10)
        self._cent_f = cents
        self._cent_norms = l2_norms(cents)
        self.centroid_bits = jnp.asarray(pack_bits_np(np.asarray(cents)))
        self._trained = True

    def _assign(self, x: np.ndarray) -> np.ndarray:
        signs = jnp.asarray(np.where(np.asarray(x) > 0, 1.0, -1.0),
                            jnp.float32)
        return np.asarray(
            _assign_chunked(signs, self._cent_f, self._cent_norms))

    def add(self, x: np.ndarray, vids: np.ndarray,
            docids: np.ndarray) -> None:
        assert self._trained
        if x.shape[0] == 0:
            return
        x = np.asarray(x, np.float32)   # bit packing is host-side
        list_ids = self._assign(x)
        codes = jnp.asarray(pack_bits_np(x))
        need = self.placer.required_cap(list_ids)
        if need > self.state.cap:
            new_cap = self.state.cap
            while new_cap < need:
                new_cap *= 2
            self.state = rt.grow(self.state, new_cap)
            self.placer.cap = new_cap
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

    def search(self, queries, penalty, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        # Hamming distances live in a different score space; the score
        # range stays a post-filter for binary codes (engine handles it).
        assert self._trained, "BINARYIVF requires training before search"
        qbits = jnp.asarray(pack_bits_np(np.asarray(queries)))
        nprobe = min(sp.nprobe or max(1, self.p.ncentroids // 16),
                     self.p.ncentroids)
        return ivf_scan.binary_ivf_search(
            self.state, self.centroid_bits, qbits, penalty,
            nprobe=nprobe, k=k)

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        f = os.path.join(path, f"{self.store.name}.bivf.npz")
        if not self._trained:
            np.savez(f, trained=np.array(0))
            return
        np.savez(f, trained=np.array(1),
                 cent_f=np.asarray(self._cent_f),
                 codes=np.asarray(self.state.codes),
                 vids=np.asarray(self.state.vids),
                 docids=np.asarray(self.state.docids),
                 lens=np.asarray(self.state.lens),
                 indexed_count=np.array(self.indexed_count))

    def load(self, path: str) -> int:
        f = os.path.join(path, f"{self.store.name}.bivf.npz")
        if not os.path.exists(f):
            return 0
        z = np.load(f)
        if int(z["trained"]) == 0:
            return 0
        self._cent_f = jnp.asarray(z["cent_f"])
        self._cent_norms = l2_norms(self._cent_f)
        self.centroid_bits = jnp.asarray(pack_bits_np(z["cent_f"]))
        self.state = rt.IVFState(
            jnp.asarray(z["codes"]), jnp.asarray(z["vids"]),
            jnp.asarray(z["docids"]), jnp.asarray(z["lens"]))
        self.placer = rt.HostPlacer(self.state.nlist, self.state.cap)
        self.placer.resync_after_compact(z["docids"], z["vids"], z["lens"])
        self.indexed_count = int(z["indexed_count"])
        self._trained = True
        return self.indexed_count

    def mem_bytes(self) -> int:
        return int(self.state.mem_bytes())
