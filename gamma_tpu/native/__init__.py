"""ctypes bindings for libgamma_host — the native host runtime.

The C++ library (native/gamma_host.cc) provides the host-side storage
engine (mmap segments + async-sync writer thread), the file-backed bitmap,
and the sharded key→docid map — the host-side equivalents of the
reference's StorageManager/AsyncWriter (storage/), BitmapManager (util/),
and libcuckoo map (table/table.h:185).

Every wrapper has a pure-Python fallback (`available() == False`) so the
package works where the .so has not been built; `build()` compiles it
in-place with g++ (native/build.sh; the library is a build output and is
not committed).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SO = os.path.join(_REPO, "native", "libgamma_host.so")
_BUILD_ERROR = ""


def build() -> bool:
    global _BUILD_ERROR
    try:
        subprocess.run([os.path.join(_REPO, "native", "build.sh")],
                       check=True, capture_output=True, text=True)
        return _load() is not None
    except subprocess.CalledProcessError as exc:
        _BUILD_ERROR = (exc.stderr or exc.stdout or str(exc)).strip()
    except Exception as exc:
        _BUILD_ERROR = repr(exc)
    return False


def build_error() -> str:
    """Why the last build() failed ("" if it has not failed)."""
    return _BUILD_ERROR


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_SO):
        return None
    lib = ctypes.CDLL(_SO)
    c = ctypes.c_char_p
    i64 = ctypes.c_int64
    vp = ctypes.c_void_p
    sig = {
        "gsm_open": ([c, c, i64, i64, i64], vp),
        "gsm_size": ([vp], i64),
        "gsm_add": ([vp, ctypes.c_void_p, i64], i64),
        "gsm_get_range": ([vp, i64, i64, ctypes.c_void_p], ctypes.c_int),
        "gsm_update": ([vp, i64, ctypes.c_void_p], ctypes.c_int),
        "gsm_add_str": ([vp, c, i64], i64),
        "gsm_get_str": ([vp, i64, ctypes.c_char_p, i64], i64),
        "gsm_get_strs": ([vp, ctypes.c_void_p, i64, ctypes.c_void_p,
                          i64, ctypes.c_void_p], i64),
        "gsm_add_strs": ([vp, ctypes.c_void_p, ctypes.c_void_p, i64,
                          ctypes.c_void_p], ctypes.c_int),
        "gsm_sync": ([vp], ctypes.c_int),
        "gsm_truncate": ([vp, i64], ctypes.c_int),
        "gsm_close": ([vp], None),
        "gbm_open": ([c, i64], vp),
        "gbm_set": ([vp, i64], ctypes.c_int),
        "gbm_unset": ([vp, i64], ctypes.c_int),
        "gbm_test": ([vp, i64], ctypes.c_int),
        "gbm_count": ([vp], i64),
        "gbm_fill_bytes": ([vp, ctypes.c_void_p, i64], ctypes.c_int),
        "gbm_sync": ([vp], ctypes.c_int),
        "gbm_close": ([vp], None),
        "gzb_open": ([c, c, i64, i64, i64], vp),
        "gzb_rows": ([vp], i64),
        "gzb_add": ([vp, ctypes.c_void_p, i64], ctypes.c_int),
        "gzb_get": ([vp, i64, i64, ctypes.c_void_p], ctypes.c_int),
        "gzb_update": ([vp, i64, ctypes.c_void_p], ctypes.c_int),
        "gzb_truncate": ([vp, i64], ctypes.c_int),
        "gzb_sync": ([vp], ctypes.c_int),
        "gzb_comp_bytes": ([vp], i64),
        "gzb_set_cache_blocks": ([vp, i64], ctypes.c_int),
        "gzb_cache_stats": ([vp, ctypes.c_void_p], i64),
        "gzb_close": ([vp], None),
        "gkm_new": ([], vp),
        "gkm_free": ([vp], None),
        "gkm_put": ([vp, c, i64, i64], i64),
        "gkm_get": ([vp, c, i64], i64),
        "gkm_del": ([vp, c, i64], i64),
        "gkm_size": ([vp], i64),
        "gkm_dump": ([vp, c], ctypes.c_int),
        "gkm_load": ([vp, c], ctypes.c_int),
    }
    for name, (argtypes, restype) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeStorage:
    """Append-only segmented store of fixed-size items + string heap."""

    def __init__(self, directory: str, name: str, item_size: int,
                 segment_items: int = 500_000,
                 str_bytes_per_seg: int = 64 << 20):
        lib = _load()
        if lib is None:
            raise RuntimeError("libgamma_host.so not built")
        self._lib = lib
        os.makedirs(directory, exist_ok=True)
        self.item_size = item_size
        self._h = lib.gsm_open(directory.encode(), name.encode(),
                               item_size, segment_items, str_bytes_per_seg)
        if not self._h:
            raise RuntimeError("gsm_open failed")

    def __len__(self) -> int:
        return int(self._lib.gsm_size(self._h))

    def add(self, items: np.ndarray) -> int:
        items = np.ascontiguousarray(items)
        assert items.nbytes % self.item_size == 0
        n = items.nbytes // self.item_size
        return int(self._lib.gsm_add(
            self._h, items.ctypes.data_as(ctypes.c_void_p), n))

    def get_range(self, start: int, count: int,
                  dtype=np.uint8) -> np.ndarray:
        out = np.empty(count * self.item_size, np.uint8)
        rc = self._lib.gsm_get_range(
            self._h, start, count, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise IndexError(f"get_range({start},{count})")
        return out.view(dtype)

    def update(self, idx: int, item: np.ndarray) -> None:
        item = np.ascontiguousarray(item)
        assert item.nbytes == self.item_size
        if self._lib.gsm_update(
                self._h, idx, item.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise IndexError(f"update({idx})")

    def add_str(self, s: bytes) -> int:
        return int(self._lib.gsm_add_str(self._h, s, len(s)))

    def get_str(self, handle: int) -> bytes:
        buf = ctypes.create_string_buffer(256)
        n = self._lib.gsm_get_str(self._h, handle, buf, 256)
        if n < 0:
            raise IndexError(f"get_str({handle})")
        if n <= 256:
            return buf.raw[:n]
        buf = ctypes.create_string_buffer(int(n))
        self._lib.gsm_get_str(self._h, handle, buf, n)
        return buf.raw[:n]

    def get_strs(self, handles: np.ndarray) -> list:
        """Batch string read: ONE native crossing for a whole column
        (per-row get_str costs a Python call per row — minutes at 10M)."""
        handles = np.ascontiguousarray(handles, np.int64)
        n = handles.size
        if n == 0:
            return []
        lens = np.empty(n, np.int64)
        cap = max(4096, 16 * n)
        for _ in range(2):
            out = np.empty(cap, np.uint8)
            need = self._lib.gsm_get_strs(
                self._h, handles.ctypes.data_as(ctypes.c_void_p), n,
                out.ctypes.data_as(ctypes.c_void_p), cap,
                lens.ctypes.data_as(ctypes.c_void_p))
            if need <= cap:
                break
            cap = int(need)
        ends = np.cumsum(np.maximum(lens, 0))
        starts = ends - np.maximum(lens, 0)
        blob = out.tobytes()
        return [blob[starts[i]:ends[i]] if lens[i] >= 0 else b""
                for i in range(n)]

    def add_strs(self, strs: list) -> np.ndarray:
        """Batch string append → int64 handles (one native crossing)."""
        n = len(strs)
        if n == 0:
            return np.empty(0, np.int64)
        lens = np.asarray([len(s) for s in strs], np.int64)
        buf = np.frombuffer(b"".join(strs), np.uint8)
        if buf.size == 0:
            buf = np.zeros(1, np.uint8)
        handles = np.empty(n, np.int64)
        rc = self._lib.gsm_add_strs(
            self._h, buf.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p), n,
            handles.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError("gsm_add_strs failed")
        return handles

    def sync(self) -> None:
        self._lib.gsm_sync(self._h)

    def truncate(self, n_items: int) -> None:
        self._lib.gsm_truncate(self._h, n_items)

    def close(self) -> None:
        if self._h:
            self._lib.gsm_close(self._h)
            self._h = None


class ZBlockStorage:
    """zstd block-compressed row store (reference: storage/compress/
    compressor_zstd.h + the Block/LRUCache read path, storage/block.h:36,
    storage/lru_cache.h:332).  Rows append into a raw tail; full blocks
    seal as immutable zstd frames; point updates overlay; reads
    decompress whole blocks through a native LRU."""

    def __init__(self, directory: str, name: str, row_bytes: int,
                 rows_per_block: int = 4096, cache_blocks: int = 32):
        lib = _load()
        if lib is None:
            raise RuntimeError("libgamma_host.so not built")
        self._lib = lib
        os.makedirs(directory, exist_ok=True)
        self.row_bytes = row_bytes
        self._h = lib.gzb_open(directory.encode(), name.encode(),
                               row_bytes, rows_per_block, cache_blocks)
        if not self._h:
            raise RuntimeError("gzb_open failed")

    def __len__(self) -> int:
        return int(self._lib.gzb_rows(self._h))

    def add(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows)
        assert rows.nbytes % self.row_bytes == 0
        n = rows.nbytes // self.row_bytes
        if n and self._lib.gzb_add(
                self._h, rows.ctypes.data_as(ctypes.c_void_p), n) != 0:
            raise RuntimeError("gzb_add failed")

    def get_range(self, start: int, count: int,
                  dtype=np.uint8) -> np.ndarray:
        out = np.empty(count * self.row_bytes, np.uint8)
        if self._lib.gzb_get(
                self._h, start, count,
                out.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise IndexError(f"gzb_get({start},{count})")
        return out.view(dtype)

    def update(self, idx: int, row: np.ndarray) -> None:
        row = np.ascontiguousarray(row)
        assert row.nbytes == self.row_bytes
        if self._lib.gzb_update(
                self._h, idx, row.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise IndexError(f"gzb_update({idx})")

    def truncate(self, n_rows: int) -> None:
        self._lib.gzb_truncate(self._h, n_rows)

    def sync(self) -> None:
        self._lib.gzb_sync(self._h)

    def comp_bytes(self) -> int:
        return int(self._lib.gzb_comp_bytes(self._h))

    def set_cache_blocks(self, n: int) -> None:
        self._lib.gzb_set_cache_blocks(self._h, n)

    def cache_stats(self) -> tuple:
        misses = ctypes.c_int64(0)
        hits = self._lib.gzb_cache_stats(self._h, ctypes.byref(misses))
        return int(hits), int(misses.value)

    def close(self) -> None:
        if self._h:
            self._lib.gzb_close(self._h)
            self._h = None


class NativeBitmap:
    def __init__(self, path: str, nbits: int = 500_000_000):
        lib = _load()
        if lib is None:
            raise RuntimeError("libgamma_host.so not built")
        self._lib = lib
        self._h = lib.gbm_open(path.encode(), nbits)
        if not self._h:
            raise RuntimeError("gbm_open failed")

    def set(self, bit: int) -> None:
        self._lib.gbm_set(self._h, bit)

    def unset(self, bit: int) -> None:
        self._lib.gbm_unset(self._h, bit)

    def test(self, bit: int) -> bool:
        return bool(self._lib.gbm_test(self._h, bit))

    def count(self) -> int:
        return int(self._lib.gbm_count(self._h))

    def as_bool_array(self, nbits: int) -> np.ndarray:
        out = np.zeros(nbits, np.uint8)
        self._lib.gbm_fill_bytes(
            self._h, out.ctypes.data_as(ctypes.c_void_p), nbits)
        return out.astype(bool)

    def sync(self) -> None:
        self._lib.gbm_sync(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.gbm_close(self._h)
            self._h = None


class NativeKeyMap:
    """Concurrent key(str/bytes) → docid map (libcuckoo analog)."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("libgamma_host.so not built")
        self._lib = lib
        self._h = lib.gkm_new()

    @staticmethod
    def _k(key) -> bytes:
        if isinstance(key, bytes):
            return key
        return str(key).encode()

    def put(self, key, docid: int) -> int:
        k = self._k(key)
        return int(self._lib.gkm_put(self._h, k, len(k), docid))

    def get(self, key) -> int:
        k = self._k(key)
        return int(self._lib.gkm_get(self._h, k, len(k)))

    def delete(self, key) -> int:
        k = self._k(key)
        return int(self._lib.gkm_del(self._h, k, len(k)))

    def __len__(self) -> int:
        return int(self._lib.gkm_size(self._h))

    def dump(self, path: str) -> None:
        self._lib.gkm_dump(self._h, path.encode())

    def load(self, path: str) -> None:
        self._lib.gkm_load(self._h, path.encode())

    def close(self) -> None:
        if self._h:
            self._lib.gkm_free(self._h)
            self._h = None
