"""Hybrid-search filter index.

Reference: table/field_range_index.{h,cc} (MultiFieldsRangeIndex) — a
concurrent B-tree per indexed field mapping values → adaptive
sparse/dense posting bitmaps, with async writes and bitmap AND/OR/NOT
composition (Search:1015-1115, Intersect:1117-1200).

Device re-derivation: there is no B-tree.  Numeric predicates are
evaluated directly over device-mirrored columns inside the search step
(a [N] compare is a trivially-vectorized VPU pass, far cheaper than tree
walks at device memory bandwidth), producing the fused penalty array.  Term (string)
filters keep a host inverted map term→docid list; term predicates compose
into a boolean mask uploaded only when present.

The write path stays off the query critical path like the reference's
async field-index worker (field_range_index.cc:901-989): device column
mirrors are refreshed by the engine's flush step, not per-doc.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from gamma_tpu.api.request import RangeFilter, TermFilter
from gamma_tpu.config import DataType
from gamma_tpu.ops import penalty as pen_ops
from gamma_tpu.table.table import Table


class TermPostings:
    """One term's posting list: a sorted-unique int64 array plus a small
    append buffer merged lazily (the reference keeps adaptive bitmaps,
    field_range_index.cc; Python `set[int]` costs ~100 B/entry — this is
    8 B/entry, and `mem_bytes` stops undercounting)."""

    __slots__ = ("_arr", "_buf", "_removed")

    def __init__(self):
        self._arr = _EMPTY_IDS
        self._buf: List[int] = []
        self._removed: Optional[set] = None

    def add(self, docid: int) -> None:
        self._buf.append(docid)

    def discard(self, docid: int) -> None:
        if self._removed is None:
            self._removed = set()
        self._removed.add(docid)

    def _merge(self) -> None:
        if self._buf:
            self._arr = np.unique(np.concatenate(
                [self._arr, np.asarray(self._buf, np.int64)]))
            self._buf = []
        if self._removed:
            rm = np.fromiter(self._removed, np.int64,
                             count=len(self._removed))
            keep = ~np.isin(self._arr, rm)
            self._arr = self._arr[keep]
            self._removed = None

    def ids(self) -> np.ndarray:
        self._merge()
        return self._arr

    def set_ids(self, arr: np.ndarray) -> None:
        self._arr = np.asarray(arr, np.int64)
        self._buf = []
        self._removed = None

    def __len__(self) -> int:
        self._merge()
        return int(self._arr.size)

    def mem_bytes(self) -> int:
        return (self._arr.nbytes + 8 * len(self._buf)
                + (100 * len(self._removed) if self._removed else 0))


_EMPTY_IDS = np.empty(0, np.int64)


class MultiFieldsRangeIndex:
    # cache at most this many device term masks per field (the hottest
    # terms by posting size); the rest build sparsely at query time
    TERM_CACHE_LIMIT = 64

    def __init__(self, table: Table):
        self.table = table
        self._lock = threading.Lock()
        self.numeric_fields: List[str] = []
        self.term_fields: List[str] = []
        # device mirrors of numeric columns, refreshed on flush
        self._device_cols: Dict[str, jnp.ndarray] = {}
        self._device_rows = 0
        # term postings: field → term → TermPostings (sorted int64 ids)
        self._postings: Dict[str, Dict[str, TermPostings]] = {}
        # incrementally-maintained device masks for hot terms
        # (reference maintains posting bitmaps at WRITE time off the
        # query path, field_range_index.cc:901-989): (field, term) →
        # uint8 [rows]; additions scatter deltas at flush, removals
        # (updates) force a rebuild
        self._term_cache: Dict[Tuple[str, str], jnp.ndarray] = {}
        self._term_pending: Dict[Tuple[str, str], List[int]] = {}
        self._term_rebuild: set = set()

    # ---- schema (reference: AddField, field_range_index.cc:1202-1217) ----

    def add_field(self, name: str, data_type: DataType) -> None:
        with self._lock:
            if data_type == DataType.STRING:
                self.term_fields.append(name)
                self._postings[name] = {}
            else:
                self.numeric_fields.append(name)

    # ---- writes ----

    def add_doc(self, docid: int, fields: Dict) -> None:
        """Index term fields for one doc.  Numeric fields need no per-doc
        work — the column itself is the index."""
        for name in self.term_fields:
            v = fields.get(name)
            if v is None:
                continue
            for term in str(v).split("\x01"):
                if not term:
                    continue
                self._postings[name].setdefault(
                    term, TermPostings()).add(docid)
                key = (name, term)
                if key in self._term_cache:
                    self._term_pending.setdefault(key, []).append(docid)

    def update_doc(self, docid: int, fields: Dict) -> None:
        """Re-index term fields for an updated doc: the OLD term's
        posting must drop the docid (reference: field-index Delete+Add on
        update) or the doc keeps matching its previous term.  Must be
        called BEFORE table.update (reads the old value)."""
        for name in self.term_fields:
            if name not in fields:
                continue
            old = self.table.heaps[name].get(docid)
            for term in old.split("\x01"):
                if not term:
                    continue
                post = self._postings[name].get(term)
                if post is not None:
                    post.discard(docid)
                    key = (name, term)
                    if key in self._term_cache:
                        self._term_rebuild.add(key)
        self.add_doc(docid, fields)

    def delete_doc(self, docid: int) -> None:
        # deletes are handled by the global validity penalty; postings may
        # keep stale docids harmlessly (they're masked by validity).
        pass

    def rebuild(self, table: Table) -> None:
        """Bulk-rebuild term postings from the table after a restore —
        one pass over each string heap instead of a get_doc dict per doc
        (reference re-adds docs one at a time, gamma_engine.cc:1251-1256;
        this is the vectorized equivalent).  Numeric fields need nothing:
        the column itself is the index."""
        n = table.n
        with self._lock:
            self._term_cache.clear()
            self._term_pending.clear()
            self._term_rebuild.clear()
            for name in self.term_fields:
                lists: Dict[str, List[int]] = {}
                vals = table.heaps[name].get_all(n)
                for docid, v in enumerate(vals):
                    if not v:
                        continue
                    if "\x01" in v:
                        for term in v.split("\x01"):
                            if term:
                                lists.setdefault(term, []).append(docid)
                    else:
                        lists.setdefault(v, []).append(docid)
                postings: Dict[str, TermPostings] = {}
                for term, ids in lists.items():
                    tp = TermPostings()
                    # docids arrive in ascending order — already sorted
                    tp.set_ids(np.asarray(ids, np.int64))
                    postings[term] = tp
                self._postings[name] = postings

    def flush_device(self, pad_chunk: int = 4096,
                     dirty: Optional[List[int]] = None) -> None:
        """Refresh device mirrors of numeric columns (engine calls this on
        its ingest flush; queries between flushes see the last mirror,
        same freshness model as the reference's async index worker).
        Incremental: only rows beyond the previous mirror plus rows dirtied
        by updates travel over the host link.  `dirty` is the batch of
        updated docids (the engine takes table.take_dirty() once and
        shares it with the persistence flush)."""
        n = self.table.n
        rows = -(-max(n, 1) // pad_chunk) * pad_chunk
        if dirty is None:
            dirty = self.table.take_dirty()
        if rows != self._device_rows or not self._device_cols:
            for name in self.numeric_fields:
                col = np.zeros(rows, dtype=np.float32)
                col[:n] = self.table.column(name).astype(np.float32)
                self._device_cols[name] = jnp.asarray(col)
            self._device_rows = rows
            self._mirrored = n
            return
        start = getattr(self, "_mirrored", 0)
        if n > start:
            pad = -(-(n - start) // 1024) * 1024
            idx = np.arange(start, start + pad, dtype=np.int64)
            # padded tail must be DROPPED, not clamped (clamping writes a
            # zero over the last real row); scatter mode="drop" discards
            # positive out-of-bounds indices
            idx[n - start:] = 0x40000000
            for name in self.numeric_fields:
                vals = np.zeros(pad, np.float32)
                vals[: n - start] = self.table.column(name)[
                    start:n].astype(np.float32)
                self._device_cols[name] = self._device_cols[name].at[
                    jnp.asarray(idx)].set(jnp.asarray(vals),
                                          mode="drop")
            self._mirrored = n
        if dirty:
            didx = np.asarray([d for d in dirty if d < n], np.int64)
            if didx.size:
                for name in self.numeric_fields:
                    vals = self.table.column(name)[didx].astype(np.float32)
                    self._device_cols[name] = self._device_cols[name].at[
                        jnp.asarray(didx)].set(jnp.asarray(vals))
        self._refresh_term_masks()

    # ---- device term masks (maintained off the query path) ----

    @staticmethod
    def _pad_ids(ids: np.ndarray) -> jnp.ndarray:
        """Pad an index array to a pow2 quantum (bounded jit shapes);
        padding becomes a large positive OOB index the scatter drops
        (mode="drop" does NOT drop negatives — they wrap)."""
        q = 1024
        while q < ids.size:
            q *= 2
        out = np.full(q, 0x40000000, np.int64)
        out[: ids.size] = ids
        return jnp.asarray(out)

    def _build_term_mask(self, field: str, term: str,
                         rows: int) -> jnp.ndarray:
        post = self._postings.get(field, {}).get(term)
        ids = _EMPTY_IDS if post is None else post.ids()
        ids = ids[ids < rows]
        mask = jnp.zeros((rows,), jnp.uint8)
        if ids.size:
            mask = mask.at[self._pad_ids(ids)].set(1, mode="drop")
        return mask

    def _refresh_term_masks(self) -> None:
        """Keep device masks for the hottest terms current: scatter
        pending additions; rebuild terms with removals; (re)admit the
        largest postings up to TERM_CACHE_LIMIT per field.  Runs at
        flush, off the query critical path (reference: async field-index
        worker, field_range_index.cc:901-989)."""
        rows = self._device_rows
        if rows == 0:
            return
        threshold = max(1024, rows // 256)
        wanted = set()
        for field in self.term_fields:
            post = self._postings.get(field, {})
            hot = sorted(((len(s), t) for t, s in post.items()
                          if len(s) >= threshold), reverse=True)
            wanted.update((field, t)
                          for _, t in hot[: self.TERM_CACHE_LIMIT])
        for key in list(self._term_cache):
            if key not in wanted:
                del self._term_cache[key]
                self._term_pending.pop(key, None)
                self._term_rebuild.discard(key)
        for key in wanted:
            cached = self._term_cache.get(key)
            if (cached is None or cached.shape[0] != rows
                    or key in self._term_rebuild):
                self._term_cache[key] = self._build_term_mask(
                    key[0], key[1], rows)
                self._term_pending.pop(key, None)
                self._term_rebuild.discard(key)
            elif self._term_pending.get(key):
                ids = np.asarray(
                    [d for d in self._term_pending.pop(key) if d < rows],
                    np.int64)
                if ids.size:
                    self._term_cache[key] = self._term_cache[key].at[
                        self._pad_ids(ids)].set(1, mode="drop")

    def term_penalties(self, term_filters: Sequence[TermFilter]
                       ) -> List[jnp.ndarray]:
        """Per-filter device penalty arrays [rows] — hot terms read the
        incrementally-maintained device mask (zero host work); cold terms
        scatter their posting ids (O(postings) upload, not O(N)).
        Freshness: docs added since the last flush are masked by the
        validity penalty anyway, so mask staleness is invisible; an
        updated doc's term change lands at the next flush (the
        reference's async-worker window)."""
        out = []
        rows = self._device_rows
        for tf in term_filters:
            pens = []
            for term in tf.terms():
                cached = self._term_cache.get((tf.field, term))
                if cached is not None and cached.shape[0] == rows:
                    mask = cached
                else:
                    mask = self._build_term_mask(tf.field, term, rows)
                pens.append(pen_ops.mask_penalty(mask))
            if not pens:
                out.append(jnp.full((max(rows, 1),), np.float32(3.0e38)))
                continue
            if tf.is_union == 0:            # AND across terms
                pen = pens[0]
                for p in pens[1:]:
                    pen = jnp.minimum(pen + p, np.float32(3.0e38))
            else:                           # OR across terms
                pen = pens[0]
                for p in pens[1:]:
                    pen = jnp.minimum(pen, p)
                if tf.is_union == 2:        # NOT: invert the OR
                    pen = jnp.where(pen > 0, 0.0,
                                    np.float32(3.0e38)).astype(jnp.float32)
            out.append(pen)
        return out

    # ---- query (reference: Search/Intersect :1015-1200) ----

    def term_mask(self, term_filters: Sequence[TermFilter],
                  n: int) -> Optional[np.ndarray]:
        """Boolean mask over [0, n) from term filters (AND across filters;
        union/intersection across terms within one filter per is_union)."""
        if not term_filters:
            return None
        mask = np.ones(n, dtype=bool)
        for tf in term_filters:
            postings = self._postings.get(tf.field, {})
            terms = tf.terms()
            # is_union: 1 = OR across terms, 0 = AND, 2 = NOT (exclude
            # docs matching any term) — FilterOperator
            # field_range_index.h:23
            if tf.is_union == 0:
                m = np.ones(n, dtype=bool)
                for t in terms:
                    mt = np.zeros(n, dtype=bool)
                    post = postings.get(t)
                    if post is not None and len(post):
                        arr = post.ids()
                        mt[arr[arr < n]] = True
                    m &= mt
            else:
                m = np.zeros(n, dtype=bool)
                for t in terms:
                    post = postings.get(t)
                    if post is not None and len(post):
                        arr = post.ids()
                        m[arr[arr < n]] = True
                if tf.is_union == 2:
                    m = ~m
            mask &= m
        return mask

    def range_penalties(self, range_filters: Sequence[RangeFilter]
                        ) -> List[jnp.ndarray]:
        """Per-filter penalty arrays over the device column mirrors."""
        out = []
        for rf in range_filters:
            col = self._device_cols.get(rf.field)
            if col is None:
                # field not mirrored yet (no flush): fail CLOSED — a
                # filter that cannot be evaluated must not admit docs
                out.append(jnp.full((max(self._device_rows, 1),),
                                    np.float32(3.0e38)))
                continue
            out.append(pen_ops.range_penalty(
                col, rf.lower_value, rf.upper_value,
                include_lower=rf.include_lower,
                include_upper=rf.include_upper))
        return out

    def matching_docids(self, range_filters: Sequence[RangeFilter],
                        term_filters: Sequence[TermFilter],
                        n: int) -> np.ndarray:
        """Docids in [0, n) matching ALL filters — evaluated against the
        filter index (device column mirrors + term postings), NOT a host
        column scan (the reference routes DelDocByQuery through
        MultiFieldsRangeIndex::Search, field_range_index.cc:1015-1115).
        Call flush_device() first for read-your-writes freshness; rows
        beyond the last mirror flush fall back to host evaluation, as do
        filters on fields that were never mirrored (non-indexed fields).
        Numeric comparisons on mirrored fields use the same f32 device
        semantics the search path's fused filters use."""
        mask = np.ones(n, dtype=bool)
        if n == 0:
            return np.empty(0, np.int64)
        mirrored = min(getattr(self, "_mirrored", 0),
                       self._device_rows, n)
        dev_pen = None
        for rf in range_filters or ():
            col = self._device_cols.get(rf.field)
            if col is not None and mirrored > 0:
                p = pen_ops.range_penalty(
                    col, rf.lower_value, rf.upper_value,
                    include_lower=rf.include_lower,
                    include_upper=rf.include_upper)
                dev_pen = p if dev_pen is None else dev_pen + p
                lo, hi = mirrored, n       # host tail only
            else:
                lo, hi = 0, n              # never mirrored: host fallback
            if hi > lo:
                cv = self.table.column(rf.field)[lo:hi].astype(np.float64)
                ok = (cv >= rf.lower_value if rf.include_lower
                      else cv > rf.lower_value)
                ok &= (cv <= rf.upper_value if rf.include_upper
                       else cv < rf.upper_value)
                mask[lo:hi] &= ok
        if dev_pen is not None:
            mask[:mirrored] &= np.asarray(dev_pen[:mirrored]) == 0.0
        tm = self.term_mask(term_filters or (), n)
        if tm is not None:
            mask &= tm
        return np.flatnonzero(mask)

    @property
    def device_rows(self) -> int:
        return self._device_rows

    def mem_bytes(self) -> int:
        m = sum(c.size * 4 for c in self._device_cols.values())
        for field, post in self._postings.items():
            for t, tp in post.items():
                m += tp.mem_bytes() + len(t)
        return int(m)
