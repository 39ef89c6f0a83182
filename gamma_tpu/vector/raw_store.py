"""Raw vector store: host master + device mirror.

Reference: vector/raw_vector.{h,cc} + memory_raw_vector / mmap_raw_vector —
a segmented store with an in-RAM tier and disk persistence, plus
`VIDMgr` mapping vid↔docid when docs carry multiple vectors per field
(vector/raw_vector_common.h:44-147).

Host/device split:
  * HOST master: one grow-by-doubling numpy array (f32) — the source of
    truth for persistence, GetVector, and training gathers.  `Mmap`
    store_type backs it with a disk memmap instead of RAM.
  * DEVICE mirror: a [cap, d] bf16 (or f32) jnp array used by flat scans
    and exact rerank; appended via donated dynamic_update_slice flushes,
    capacity-doubled like the inverted lists.

The device mirror is versioned and immutable — searches hold whatever
snapshot they started with (gamma gets this with segment pointers +
atomic counters; we get it from functional updates).
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gamma_tpu.ops.distances import l2_norms


@jax.jit
def _device_append(dev: jnp.ndarray, norms: jnp.ndarray,
                   rows: jnp.ndarray, start: jnp.ndarray):
    # norms are computed from the rows AS STORED (bf16 mirror): the
    # norm-expansion distance qn - 2 q.v + ||v||^2 is then the exact
    # (f32) distance to the quantized point.  Mixing f32-of-host norms
    # with bf16 rows adds a 2 x.delta cross-term whose noise is ~4x the
    # consistent form's and flips near-tie rankings (measured: 59/2560
    # HNSW top-10 misses at the 200k secondary geometry, all of them
    # scored-but-misranked near-ties).
    dev = jax.lax.dynamic_update_slice(dev, rows, (start, jnp.int32(0)))
    row_norms = jnp.sum(jnp.square(rows.astype(jnp.float32)), axis=1)
    norms = jax.lax.dynamic_update_slice(norms, row_norms, (start,))
    return dev, norms


@jax.jit
def _device_update_rows(dev: jnp.ndarray, norms: jnp.ndarray,
                        vids: jnp.ndarray, rows: jnp.ndarray):
    vids = jnp.where(vids < 0, 0x40000000, vids)   # negatives wrap, not drop
    dev = dev.at[vids].set(rows, mode="drop")
    row_norms = jnp.sum(jnp.square(rows.astype(jnp.float32)), axis=1)
    norms = norms.at[vids].set(row_norms, mode="drop")
    return dev, norms


class VIDMgr:
    """vid↔docid maps (identity when each doc has exactly one vector)."""

    def __init__(self, multi_vids: bool = False):
        self.multi = multi_vids
        self._vid2doc = np.zeros(0, dtype=np.int64)
        self._doc_first_vid = np.zeros(0, dtype=np.int64)

    def note(self, docid: int, vids: np.ndarray) -> None:
        if not self.multi:
            return
        hi = int(vids.max()) + 1
        if hi > self._vid2doc.size:
            grown = np.full(max(hi, 2 * self._vid2doc.size + 1024), -1,
                            dtype=np.int64)
            grown[: self._vid2doc.size] = self._vid2doc
            self._vid2doc = grown
        if docid >= self._doc_first_vid.size:
            grown = np.full(max(docid + 1, 2 * self._doc_first_vid.size
                                + 1024), -1, dtype=np.int64)
            grown[: self._doc_first_vid.size] = self._doc_first_vid
            self._doc_first_vid = grown
        self._vid2doc[vids] = docid
        if self._doc_first_vid[docid] < 0:
            self._doc_first_vid[docid] = int(vids.min())

    def vid2doc(self, vids: np.ndarray) -> np.ndarray:
        if not self.multi:
            return np.asarray(vids)
        return self._vid2doc[np.asarray(vids)]

    def doc2vid(self, docid: int) -> int:
        if not self.multi:
            return docid
        return int(self._doc_first_vid[docid])

    def doc_vids(self, docid: int) -> np.ndarray:
        """ALL vids of a doc (store.add assigns a doc's vids contiguously,
        so they are the run of _vid2doc == docid from the first vid)."""
        if not self.multi:
            return np.array([docid], dtype=np.int64)
        first = int(self._doc_first_vid[docid])
        if first < 0:
            return np.zeros(0, dtype=np.int64)
        end = first
        while end < self._vid2doc.size and self._vid2doc[end] == docid:
            end += 1
        return np.arange(first, end, dtype=np.int64)


class RawVectorStore:
    def __init__(self, name: str, dimension: int, *,
                 store_type: str = "MemoryOnly",
                 root_path: str = "",
                 device_dtype=jnp.bfloat16,
                 host_dtype=np.float32,
                 init_cap: int = 8192,
                 multi_vids: bool = False,
                 compress_dumps: bool = False,
                 compress_blocks: bool = False):
        self.name = name
        self.d = dimension
        if store_type == "RocksDB":     # reference cold tier → disk tier
            store_type = "Disk"
        self.store_type = store_type
        self.root_path = root_path
        self.device_dtype = device_dtype
        # in-memory compression of the HOST store (reference: GammaZFP
        # fixed-rate compression of stored vectors, vector/gamma_zfp.cc):
        # float16 halves RAM/memmap footprint; reads upcast to f32 at the
        # rerank so candidate ordering stays f32-exact over the stored
        # (rounded) values
        self.host_dtype = np.dtype(host_dtype)
        # zlib-compressed checkpoints (the reference's optional zstd/zfp
        # block compression, storage/compress/)
        self.compress_dumps = compress_dumps
        # zstd block compression of the native vector segments
        # (store_param {"compress": "zstd"} — the reference's
        # compressor_zfp.h vector-block role)
        self.compress_blocks = compress_blocks
        self.n = 0                       # number of vectors (vids) stored
        self._flushed = 0                # rows mirrored to device
        # mirror dropped by release_device(): consumers that gather rows
        # from `device` (dense scan, in-jit rerank) must check this —
        # XLA clamps out-of-bounds gathers, so a released mirror returns
        # silently wrong rows rather than failing
        self.released = False
        self._lock = threading.Lock()
        self.vid_mgr = VIDMgr(multi_vids)

        self._host_cap = init_cap
        self._host = self._alloc_host(init_cap)
        # disk tier (reference: vector/rocksdb_raw_vector.cc — vectors
        # live beyond RAM, read through on demand): NO device mirror; the
        # memmap + OS page cache is the master, scans run over PQ codes in
        # HBM and the exact rerank uploads just the gathered candidates.
        cap = 8 if self.tier == "disk" else init_cap
        self.device = jnp.zeros((cap, dimension), device_dtype)
        self.device_norms = jnp.zeros((cap,), jnp.float32)
        self._persist = None          # see attach_persist()
        # disk tier: row-block LRU in front of the memmap (reference:
        # storage/lru_cache.h:332; resizable at runtime via SetConfig)
        self._row_cache = None
        if self.tier == "disk":
            from gamma_tpu.utils.lru import BlockLRU
            self._row_cache = BlockLRU(
                lambda s, e: self._host[s:e],
                row_bytes=self.host_dtype.itemsize * dimension,
                capacity_bytes=64 << 20)

    # ---- incremental native persistence (reference: StorageManager +
    # AsyncWriter; dump becomes sync + marker) ----

    def attach_persist(self, directory: str) -> None:
        from gamma_tpu.storage.native_backend import VectorPersist
        self._persist = VectorPersist(directory, self.name, self.d,
                                      dtype=self.host_dtype,
                                      compress=self.compress_blocks)

    def flush_storage(self) -> int:
        """Append host rows not yet in the native segments (called at
        flush; appends are memcpys into the mmap, synced by the native
        writer thread)."""
        if self._persist is None:
            return 0
        with self._lock:
            start, end = len(self._persist), self.n
            if end > start:
                self._persist.append(self._host[start:end])
            return max(0, end - start)

    def sync_storage(self) -> None:
        if self._persist is not None:
            self._persist.sync()

    def load_persist(self, limit: int) -> int:
        """Restore rows from native segments (truncated to limit)."""
        if self._persist is None:
            return 0
        n = min(limit, len(self._persist))
        self._persist.truncate(n)
        if n <= 0:
            return 0
        self.n = 0
        self._flushed = 0
        self.add(self._persist.read(0, n))
        self.flush_device()
        return n

    def close_persist(self) -> None:
        if self._persist is not None:
            self._persist.close()
            self._persist = None

    # ---- host tier ----

    @property
    def tier(self) -> str:
        """"ram" (MemoryOnly/Mmap: full device mirror) or "disk"
        (RocksDB-analog: no device mirror, rerank reads through)."""
        return "disk" if self.store_type == "Disk" else "ram"

    def _alloc_host(self, cap: int) -> np.ndarray:
        if self.store_type in ("Mmap", "Disk") and self.root_path:
            os.makedirs(self.root_path, exist_ok=True)
            path = os.path.join(self.root_path, f"{self.name}.vec")
            return np.lib.format.open_memmap(
                path, mode="w+", dtype=self.host_dtype,
                shape=(cap, self.d))
        return np.zeros((cap, self.d), dtype=self.host_dtype)

    def _grow_host(self, need: int) -> None:
        new_cap = self._host_cap
        while new_cap < need:
            new_cap *= 2
        if self.store_type in ("Mmap", "Disk") and self.root_path:
            # open_memmap(mode="w+") truncates the inode the live memmap
            # still backs — grow via a sibling file, then replace
            path = os.path.join(self.root_path, f"{self.name}.vec")
            tmp = path + ".grow"
            fresh = np.lib.format.open_memmap(
                tmp, mode="w+", dtype=self.host_dtype,
                shape=(new_cap, self.d))
            fresh[: self.n] = self._host[: self.n]
            fresh.flush()
            del self._host
            os.replace(tmp, path)
            self._host = np.lib.format.open_memmap(path, mode="r+")
        else:
            fresh = self._alloc_host(new_cap)
            fresh[: self.n] = self._host[: self.n]
            self._host = fresh
        self._host_cap = new_cap

    # ---- public API (mirrors RawVector Add/Update/GetVector/Gets) ----

    def add(self, rows: np.ndarray) -> np.ndarray:
        """Append rows [n, d]; returns assigned vids."""
        rows = np.asarray(rows, dtype=np.float32).reshape(-1, self.d)
        with self._lock:
            start = self.n
            need = start + rows.shape[0]
            if need > self._host_cap:
                self._grow_host(need)
            self._host[start:need] = rows
            self.n = need
            return np.arange(start, need, dtype=np.int64)

    def update(self, vids: np.ndarray, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.float32).reshape(-1, self.d)
        vids = np.asarray(vids, dtype=np.int64)
        with self._lock:
            self._host[vids] = rows
            if self._row_cache is not None:
                self._row_cache.invalidate(vids // self._row_cache.block_rows)
            if self._persist is not None:
                persisted = len(self._persist)
                for i, v in enumerate(vids):
                    if v < persisted:   # newer rows append at next flush
                        self._persist.update(int(v), rows[i])
            flushed_mask = vids < self._flushed
            if flushed_mask.any():
                vv = vids[flushed_mask]
                rr = rows[flushed_mask].astype(self.device_dtype)
                self.device, self.device_norms = _device_update_rows(
                    self.device, self.device_norms,
                    jnp.asarray(vv, jnp.int32), jnp.asarray(rr))

    def get(self, vids: np.ndarray) -> np.ndarray:
        return self._host[np.asarray(vids, dtype=np.int64)].astype(
            np.float32)

    def get_padded(self, vids: np.ndarray) -> np.ndarray:
        """Gather rows by vid with negative/out-of-range ids clamped to a
        valid row (callers mask those slots by distance) — the disk-tier
        rerank fetch (reference: rocksdb_raw_vector.cc GetVector), read
        through the row-block LRU when one is attached."""
        v = np.asarray(vids, dtype=np.int64)
        v = np.clip(v, 0, max(self.n - 1, 0))
        cache = self._row_cache
        if cache is None:
            return self._host[v]
        flat = v.reshape(-1)
        out = np.empty((flat.size, self.d), np.float32)
        bs = cache.block_rows
        blocks = flat // bs
        for b in np.unique(blocks):
            m = blocks == b
            if (int(b) + 1) * bs <= self.n:      # full block: cacheable
                out[m] = cache.get(int(b))[flat[m] - int(b) * bs]
            else:                                # growing tail: direct
                out[m] = self._host[flat[m]]
        return out.reshape(v.shape + (self.d,))

    def set_cache_bytes(self, capacity_bytes: int) -> None:
        if self._row_cache is not None:
            self._row_cache.set_capacity(capacity_bytes)

    def cache_mem_bytes(self) -> int:
        return self._row_cache.mem_bytes() if self._row_cache else 0

    def header(self, start: int, end: int) -> np.ndarray:
        """Zero-copy span of the host tier (GetVectorHeader analog)."""
        return self._host[start:end]

    # ---- device mirror ----

    def flush_device(self, pad_chunk: int = 1024) -> int:
        """Mirror any host rows not yet on device.  Padded to pad_chunk to
        bound the number of distinct jit shapes.  Returns rows flushed."""
        if self.tier == "disk":
            return 0                  # no mirror: rerank reads through
        with self._lock:
            start, end = self._flushed, self.n
            if end <= start:
                return 0
            cap = self.device.shape[0]
            if end > cap:
                from gamma_tpu.utils.growth import grow_rows
                new_cap = grow_rows(cap, end)
                self.device = jnp.pad(
                    self.device, ((0, new_cap - cap), (0, 0)))
                self.device_norms = jnp.pad(
                    self.device_norms, (0, new_cap - cap))
                cap = new_cap
            count = end - start
            padded = -(-count // pad_chunk) * pad_chunk
            padded = min(padded, cap - start)
            rows_np = np.zeros((padded, self.d), dtype=np.float32)
            rows_np[:count] = self._host[start:end]
            rows = jnp.asarray(rows_np, self.device_dtype)
            self.device, self.device_norms = _device_append(
                self.device, self.device_norms, rows, jnp.int32(start))
            self._flushed = end
            self.released = False        # mirror is current again
            return count

    @property
    def flushed(self) -> int:
        return self._flushed

    def release_device(self) -> None:
        """Drop the HBM mirror (capacity tier: once an exact-code
        sidecar serves the scan, the dense mirror is dead HBM — 2.6 GB
        at the 10M bench geometry).  The host tier remains the master;
        a later flush_device() re-mirrors everything from it."""
        if self.tier == "disk":
            return
        with self._lock:
            self.device = jnp.zeros((8, self.d), self.device_dtype)
            self.device_norms = jnp.zeros((8,), jnp.float32)
            self._flushed = 0
            self.released = True

    def device_rows(self, start: int, end: int) -> jnp.ndarray:
        """Device-resident rows [start, end) from the mirror — lets the
        ingest path encode without re-uploading over the host link.
        Caller must ensure end <= flushed."""
        assert end <= self._flushed
        return jax.lax.dynamic_slice_in_dim(self.device, start,
                                            end - start, axis=0)

    def mem_bytes(self) -> int:
        host = (0 if self.store_type in ("Mmap", "Disk")
                else self._host.nbytes)
        dev = self.device.size * self.device.dtype.itemsize
        return int(host + dev + self.device_norms.nbytes)

    # ---- checkpoint (reference: io/raw_vector_io.{h,cc}) ----

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        fz = os.path.join(path, f"{self.name}.rawvec.npz")
        f = os.path.join(path, f"{self.name}.rawvec.npy")
        if self.compress_dumps:
            np.savez_compressed(fz, x=self._host[: self.n])
            other = f
        else:
            np.save(f, self._host[: self.n])
            other = fz
        if os.path.exists(other):   # no stale sibling-format checkpoint
            os.unlink(other)

    def load(self, path: str) -> int:
        fz = os.path.join(path, f"{self.name}.rawvec.npz")
        f = os.path.join(path, f"{self.name}.rawvec.npy")
        if os.path.exists(fz):
            data = np.load(fz)["x"]
        elif os.path.exists(f):
            data = np.load(f)
        else:
            return 0
        self.n = 0
        self._flushed = 0
        self.add(data)
        self.flush_device()
        return data.shape[0]
