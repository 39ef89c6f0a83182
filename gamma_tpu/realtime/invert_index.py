"""Real-time inverted lists as padded dense device tensors.

This re-derives gamma's lock-free realtime core (realtime/realtime_mem_data
.{h,cc}) on an immutable-tensor substrate:

  reference mechanism                      → device mechanism
  ---------------------------------------------------------------------
  per-bucket malloc'd code/vid arrays      → codes[nlist, cap, M] u8,
                                             vids/docids[nlist, cap] i32
  atomic retrieve_idx_pos_ publish cursor  → lens[nlist] i32 inside an
    (realtime_mem_data.cc:279-302)           immutable pytree; "publish" =
                                             swapping the Python ref to a
                                             new state version
  ExtendBucketMem copy + 1s-delayed free   → capacity-doubling realloc; the
    (realtime_mem_data.cc:152-188,426-474)   old version is GC'd when the
                                             last in-flight search drops it
  tombstone bit 63 of vid (kDelIdxMask)    → docids entry set to -1 via a
                                             single-element scatter
  vid_bucket_no_pos_ atomic map            → host-side numpy vid→(list,pos)
                                             (single-writer control plane)
  CompactBucket at ≥30% deleted            → vmapped stable-partition jit
                                             (compact_state)

Placement is decided on the HOST (the engine mirrors `lens` in numpy and
assigns (list, pos) before launching the scatter) so device appends are
pure scatters with precomputed indices — no device-side atomics needed,
and the host map stays exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class IVFState(NamedTuple):
    """One shard of inverted lists.  code_width is M for PQ codes, d (as
    bf16 pairs) for IVFFlat-style raw codes, or d/8 for binary codes —
    the scan op, not this container, interprets the bytes."""

    codes: jnp.ndarray     # [nlist, cap, code_width] u8
    vids: jnp.ndarray      # [nlist, cap] i32  (-1 = empty/tombstone)
    docids: jnp.ndarray    # [nlist, cap] i32  (-1 = empty/tombstone)
    lens: jnp.ndarray      # [nlist] i32 — published lengths

    @property
    def nlist(self) -> int:
        return self.codes.shape[0]

    @property
    def cap(self) -> int:
        return self.codes.shape[1]

    @property
    def code_width(self) -> int:
        return self.codes.shape[2]

    def mem_bytes(self) -> int:
        return (self.codes.size + self.vids.size * 4 +
                self.docids.size * 4 + self.lens.size * 4)


def init_state(nlist: int, cap: int, code_width: int) -> IVFState:
    return IVFState(
        codes=jnp.zeros((nlist, cap, code_width), jnp.uint8),
        vids=jnp.full((nlist, cap), -1, jnp.int32),
        docids=jnp.full((nlist, cap), -1, jnp.int32),
        lens=jnp.zeros((nlist,), jnp.int32),
    )


@jax.jit
def append(state: IVFState, list_ids: jnp.ndarray, positions: jnp.ndarray,
           codes: jnp.ndarray, vids: jnp.ndarray,
           docids: jnp.ndarray, new_lens: jnp.ndarray) -> IVFState:
    """Scatter a batch of entries at host-assigned (list, pos) slots and
    publish the new lens.  Padding rows use list_id = -1 → dropped.

    NOTE: scatter mode="drop" only drops OUT-OF-BOUNDS indices; negative
    indices wrap like numpy and would silently corrupt the last list, so
    -1 padding is remapped to a positive out-of-bounds sentinel first.
    """
    li = jnp.where(list_ids < 0, 0x40000000, list_ids)
    pos = jnp.where(positions < 0, 0x40000000, positions)
    return IVFState(
        codes=state.codes.at[li, pos].set(codes, mode="drop"),
        vids=state.vids.at[li, pos].set(vids, mode="drop"),
        docids=state.docids.at[li, pos].set(docids, mode="drop"),
        lens=new_lens,
    )


@jax.jit
def tombstone(state: IVFState, list_ids: jnp.ndarray,
              positions: jnp.ndarray) -> IVFState:
    """Mark entries dead (update/delete path).  Scan masks docid < 0.
    Lens are unchanged — the slot is reclaimed at compaction."""
    li = jnp.where(list_ids < 0, 0x40000000, list_ids)
    pos = jnp.where(positions < 0, 0x40000000, positions)
    return state._replace(
        vids=state.vids.at[li, pos].set(-1, mode="drop"),
        docids=state.docids.at[li, pos].set(-1, mode="drop"),
    )


def grow(state: IVFState, new_cap: int) -> IVFState:
    """Capacity-doubling reallocation (analog of ExtendBucketMem).  Runs as
    a pad; the caller publishes the returned state."""
    assert new_cap > state.cap
    pad = new_cap - state.cap
    return IVFState(
        codes=jnp.pad(state.codes, ((0, 0), (0, pad), (0, 0))),
        vids=jnp.pad(state.vids, ((0, 0), (0, pad)), constant_values=-1),
        docids=jnp.pad(state.docids, ((0, 0), (0, pad)), constant_values=-1),
        lens=state.lens,
    )


@jax.jit
def compact_state(state: IVFState) -> IVFState:
    """Stable-partition every list so live entries are dense
    (analog of CompactBucket, realtime_mem_data.cc:119-150)."""
    cap = state.cap
    positions = jnp.arange(cap, dtype=jnp.int32)

    def one_list(codes_l, vids_l, docids_l, len_l):
        live = (docids_l >= 0) & (positions < len_l)
        # stable order: live entries first, original order preserved
        order = jnp.argsort(jnp.where(live, positions, cap + positions))
        return (codes_l[order],
                jnp.where(live[order], vids_l[order], -1),
                jnp.where(live[order], docids_l[order], -1),
                jnp.sum(live).astype(jnp.int32))

    codes, vids, docids, lens = jax.vmap(one_list)(
        state.codes, state.vids, state.docids, state.lens)
    return IVFState(codes, vids, docids, lens)


@jax.jit
def compact_state_with(state: IVFState, extras: Tuple[jnp.ndarray, ...]
                       ) -> Tuple[IVFState, Tuple[jnp.ndarray, ...]]:
    """compact_state plus sidecar arrays (leading dims [nlist, cap_e, ...])
    permuted by the SAME per-list order — used for the SQ8 payload that
    must stay slot-aligned with the posting lists.  An extra may be
    NARROWER than the posting cap (the SQ8 sidecar is allocated at
    ladder(max_len)): every live slot sits below its width, so the
    order prefix covers them; dead tail entries clamp to garbage that
    scans mask by length/validity."""
    cap = state.cap
    positions = jnp.arange(cap, dtype=jnp.int32)

    def one_list(codes_l, vids_l, docids_l, len_l, extras_l):
        live = (docids_l >= 0) & (positions < len_l)
        order = jnp.argsort(jnp.where(live, positions, cap + positions))
        return (codes_l[order],
                jnp.where(live[order], vids_l[order], -1),
                jnp.where(live[order], docids_l[order], -1),
                jnp.sum(live).astype(jnp.int32),
                tuple(e[jnp.clip(order[: e.shape[0]], 0, e.shape[0] - 1)]
                      for e in extras_l))

    codes, vids, docids, lens, extras_out = jax.vmap(one_list)(
        state.codes, state.vids, state.docids, state.lens, extras)
    return IVFState(codes, vids, docids, lens), extras_out


# ----------------------------------------------------------------------
# Host-side placement (single-writer control plane)
# ----------------------------------------------------------------------

class HostPlacer:
    """Mirrors lens in numpy, assigns (list, pos) slots, and keeps the
    vid→(list, pos) map (analog of vid_bucket_no_pos_,
    realtime_mem_data.h global vid map)."""

    def __init__(self, nlist: int, cap: int):
        self.nlist = nlist
        self.cap = cap
        self.lens = np.zeros(nlist, dtype=np.int32)
        self.deleted = np.zeros(nlist, dtype=np.int32)   # per-list tombstones
        self._vid_list = np.full(1024, -1, dtype=np.int32)
        self._vid_pos = np.full(1024, -1, dtype=np.int32)

    def _ensure_vid(self, max_vid: int) -> None:
        if max_vid >= self._vid_list.size:
            new = max(max_vid + 1, self._vid_list.size * 2)
            for name in ("_vid_list", "_vid_pos"):
                old = getattr(self, name)
                arr = np.full(new, -1, dtype=np.int32)
                arr[: old.size] = old
                setattr(self, name, arr)

    def required_cap(self, list_ids: np.ndarray) -> int:
        """Max list length if this batch were placed now."""
        if list_ids.size == 0:
            return int(self.lens.max(initial=0))
        add = np.bincount(list_ids, minlength=self.nlist)
        return int((self.lens + add).max())

    def place(self, list_ids: np.ndarray, vids: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Assign positions for a batch; updates lens and the vid map.
        Returns (positions, new_lens)."""
        list_ids = np.asarray(list_ids, dtype=np.int32)
        vids = np.asarray(vids, dtype=np.int64)
        positions = np.empty_like(list_ids)
        order = np.argsort(list_ids, kind="stable")
        sl = list_ids[order]
        # rank within equal-list runs
        boundaries = np.flatnonzero(np.diff(sl)) + 1
        starts = np.zeros(len(sl), dtype=np.int64)
        starts[boundaries] = boundaries
        np.maximum.accumulate(starts, out=starts)
        ranks = np.arange(len(sl)) - starts
        positions[order] = self.lens[sl] + ranks
        np.add.at(self.lens, list_ids, 1)
        if vids.size:
            self._ensure_vid(int(vids.max()))
            self._vid_list[vids] = list_ids
            self._vid_pos[vids] = positions
        return positions.astype(np.int32), self.lens.copy()

    def register(self, list_ids: np.ndarray, positions: np.ndarray,
                 vids: np.ndarray) -> None:
        """Record placements computed ON DEVICE (_place_batch): update
        lens and the vid map without re-deriving positions.  Batches
        must be registered in add order."""
        list_ids = np.asarray(list_ids, dtype=np.int32)
        vids = np.asarray(vids, dtype=np.int64)
        np.add.at(self.lens, list_ids, 1)
        if vids.size:
            self._ensure_vid(int(vids.max()))
            self._vid_list[vids] = list_ids
            self._vid_pos[vids] = np.asarray(positions, dtype=np.int32)

    def locate(self, vids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        vids = np.asarray(vids, dtype=np.int64)
        self._ensure_vid(int(vids.max(initial=0)))
        return self._vid_list[vids].copy(), self._vid_pos[vids].copy()

    def mark_deleted(self, vids: np.ndarray) -> None:
        ls, _ = self.locate(vids)
        ls = ls[ls >= 0]
        if ls.size:
            np.add.at(self.deleted, ls, 1)

    def deleted_fraction(self) -> float:
        total = int(self.lens.sum())
        if total == 0:
            return 0.0
        return float(self.deleted.sum()) / total

    def resync_after_compact(self, docids_np: np.ndarray,
                             vids_np: np.ndarray,
                             lens_np: np.ndarray) -> None:
        """Rebuild the vid map from device arrays after compaction."""
        self.lens = lens_np.astype(np.int32).copy()
        self.deleted[:] = 0
        self._vid_list[:] = -1
        self._vid_pos[:] = -1
        nlist, cap = vids_np.shape
        live = vids_np >= 0
        ls, ps = np.nonzero(live)
        vv = vids_np[ls, ps]
        self._ensure_vid(int(vv.max(initial=0)))
        self._vid_list[vv] = ls.astype(np.int32)
        self._vid_pos[vv] = ps.astype(np.int32)
