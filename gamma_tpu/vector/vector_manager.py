"""VectorManager: per-field raw stores + per-(field, model) indexes.

Reference: vector/vector_manager.{h,cc} — creates RawVectors and
RetrievalModels from TableInfo (CreateVectorTable:34-201), pumps new /
updated vectors into indexes in batches (AddRTVecsToIndex:280-382,
batch=1000, ≤20000 updates/cycle), dispatches multi-vector-query searches
and merges by docid (Search:433-617).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from gamma_tpu.config import SearchParams, TableInfo, VectorInfo
from gamma_tpu.index import create_model
from gamma_tpu.index.model import RetrievalModel
from gamma_tpu.vector.raw_store import RawVectorStore

RT_BATCH = 8192          # indexer pump batch (reference uses 1000 on CPU;
                         # the device amortizes launches better with bigger steps)
MAX_UPDATES_PER_CYCLE = 20000   # reference: vector_manager.cc:366


class VectorManager:
    def __init__(self, root_path: str = ""):
        self.root_path = root_path
        self.stores: Dict[str, RawVectorStore] = {}
        # index name "<field>_<model>" → model  (reference keys the same way)
        self.indexes: Dict[str, RetrievalModel] = {}
        self._lock = threading.Lock()
        # pending update queue: (field, vid, docid) — drained by the pump
        self._updated: List[Tuple[str, int, int]] = []

    # ---- creation (reference: CreateVectorTable, vector_manager.cc:34) ----

    def create_vector_table(self, table: TableInfo,
                            persist_dir: Optional[str] = None) -> None:
        for vi in table.vectors:
            import jax.numpy as jnp
            dd = str(vi.store_param.get("device_dtype", "bfloat16"))
            # fp8 = the in-memory compression tier (reference: GammaZFP
            # block compression of stored vectors, storage/compress/) —
            # halves the HBM mirror vs bf16 at ~6% per-element rounding,
            # recovered by recall_num headroom in the exact rerank
            dtypes = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                      "float8": jnp.float8_e4m3fn,
                      "float8_e4m3": jnp.float8_e4m3fn}
            # host_dtype=float16 = in-memory compression of the HOST
            # store (reference: GammaZFP fixed-rate compression,
            # vector/gamma_zfp.cc) — halves RAM/memmap footprint; reads
            # upcast to f32 for the exact rerank
            hd = str(vi.store_param.get("host_dtype", "float32"))
            import numpy as _np
            # compress: "zstd" → native zstd block compression of the
            # persisted vector segments (reference compressor_zfp.h
            # role); any other truthy value keeps the legacy
            # zlib-compressed whole-corpus checkpoints
            comp = vi.store_param.get("compress", False)
            store = RawVectorStore(
                vi.name, vi.dimension,
                store_type=vi.store_type,
                device_dtype=dtypes.get(dd, jnp.bfloat16),
                host_dtype=(_np.float16 if hd in ("float16", "f16")
                            else _np.float32),
                root_path=os.path.join(self.root_path, "vectors"),
                compress_dumps=bool(comp) and comp != "zstd",
                compress_blocks=comp == "zstd",
            )
            if persist_dir is not None:
                store.attach_persist(persist_dir)
            self.stores[vi.name] = store
            if not vi.is_index:
                continue
            for i, rt_name in enumerate(table.retrieval_types):
                if (store.tier == "disk" and rt_name.upper() not in
                        ("IVFPQ", "IVFPQ_FASTSCAN", "VEARCH", "SCANN")):
                    raise ValueError(
                        f"store_type=RocksDB/Disk supports the IVFPQ "
                        f"family only (codes in HBM + read-through "
                        f"rerank); got {rt_name}")
                params = (table.retrieval_params[i]
                          if i < len(table.retrieval_params) else {})
                model = create_model(rt_name, store, params)
                # field recorded ON the model: parsing it back out of the
                # dict key is ambiguous for model names with underscores
                # (IVFPQ_FASTSCAN)
                model.field = vi.name
                self.indexes[f"{vi.name}_{rt_name.upper()}"] = model

    def index_for(self, field: str, model_name: Optional[str] = None
                  ) -> Optional[RetrievalModel]:
        if model_name:
            return self.indexes.get(f"{field}_{model_name.upper()}")
        for m in self.indexes.values():
            if m.field == field:
                return m
        return None

    # ---- ingest ----

    def add_to_store(self, field: str, rows: np.ndarray,
                     docid: int) -> np.ndarray:
        store = self.stores[field]
        vids = store.add(rows)
        multi = rows.ndim == 2 and rows.shape[0] > 1
        if multi and not store.vid_mgr.multi:
            store.vid_mgr.multi = True
        store.vid_mgr.note(docid, vids)
        return vids

    def queue_update(self, field: str, vid: int, docid: int) -> None:
        with self._lock:
            self._updated.append((field, vid, docid))

    # ---- indexer pump (reference: AddRTVecsToIndex) ----

    def add_rt_vecs_to_index(self) -> int:
        """Move stored-but-unindexed vectors into every trained index, in
        RT_BATCH chunks; then drain the update queue.  Returns vectors
        pumped."""
        moved = 0
        for model in self.indexes.values():
            if not model.trained():
                continue
            store = self.stores[model.field]
            while model.indexed_count < store.n:
                start = model.indexed_count
                end = min(start + RT_BATCH, store.n)
                # prefer the already-uploaded device mirror (bf16) so the
                # pump never re-ships vectors over the host link
                rows = (store.device_rows(start, end)
                        if end <= store.flushed
                        else store.header(start, end))
                vids = np.arange(start, end, dtype=np.int64)
                docids = store.vid_mgr.vid2doc(vids)
                with model.mutate_lock:
                    model.add(rows, vids, docids)
                moved += end - start
        # updates: tombstone + re-add (reference: Update drain :340-366)
        with self._lock:
            updates, self._updated = (self._updated[:MAX_UPDATES_PER_CYCLE],
                                      self._updated[MAX_UPDATES_PER_CYCLE:])
        if updates:
            by_field: Dict[str, List[Tuple[int, int]]] = {}
            for field, vid, docid in updates:
                by_field.setdefault(field, []).append((vid, docid))
            for field, pairs in by_field.items():
                vids = np.array([p[0] for p in pairs], dtype=np.int64)
                docids = np.array([p[1] for p in pairs], dtype=np.int64)
                rows = self.stores[field].get(vids)
                for model in self.indexes.values():
                    if model.field == field and model.trained():
                        # only re-add vids already indexed
                        sel = vids < model.indexed_count
                        if sel.any():
                            with model.mutate_lock:
                                model.update(vids[sel], rows[sel],
                                             docids[sel])
        return moved

    def min_indexed_num(self) -> int:
        counts = [m.indexed_count for m in self.indexes.values()]
        return min(counts) if counts else 0

    def delete(self, field_vids: Dict[str, np.ndarray]) -> None:
        for field, vids in field_vids.items():
            for model in self.indexes.values():
                if model.field == field:
                    with model.mutate_lock:
                        model.delete(vids)

    def compact_if_needed(self) -> None:
        for m in self.indexes.values():
            with m.mutate_lock:
                m.compact()

    # ---- persistence (reference: Dump/Load vector_manager.cc:731-804) ----

    def dump(self, path: str) -> None:
        for store in self.stores.values():
            store.dump(path)
        for m in self.indexes.values():
            m.dump(path)

    def load(self, path: str) -> int:
        """Returns the min vector count across fields (load-truncate
        consistency, reference: vector_manager.cc:761-804)."""
        counts = []
        for store in self.stores.values():
            counts.append(store.load(path))
        for m in self.indexes.values():
            m.load(path)
        return min(counts) if counts else 0

    # ---- incremental native persistence ----

    def flush_storage(self) -> None:
        for store in self.stores.values():
            store.flush_storage()

    def sync_storage(self) -> None:
        for store in self.stores.values():
            store.sync_storage()

    def load_persist(self, limits: Dict[str, int], index_dir: str) -> int:
        """Restore raw vectors from native segments + indexes from the
        committed index dump.  Returns min vector count."""
        counts = []
        for name, store in self.stores.items():
            counts.append(store.load_persist(limits.get(name, 0)))
        for m in self.indexes.values():
            m.load(index_dir)
        return min(counts) if counts else 0

    def close_storage(self) -> None:
        for store in self.stores.values():
            store.close_persist()

    def mem_bytes(self) -> Tuple[int, int]:
        v = sum(s.mem_bytes() for s in self.stores.values())
        i = sum(m.mem_bytes() for m in self.indexes.values())
        return int(v), int(i)
