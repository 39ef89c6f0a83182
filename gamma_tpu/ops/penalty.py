"""Validity "penalty" arrays — how deletes + hybrid filters fuse into scans.

The reference threads an `IsValid(docid)` callback (deleted-bitmap test +
range-filter bitmap test) into the innermost ADC loop
(gamma_index_ivfpq.h:574-601) and builds those bitmaps with a B-tree range
index (table/field_range_index.cc:1015-1200).

Re-derivation: validity is a single f32 array `penalty[N_cap]`
where 0.0 = valid and BIG = masked.  Scans gather `penalty[docid]` and add
it to the distance, so filtered search costs one extra gather — no
candidate lists ever reach the host.  The array is produced on device from:
  * a persistent validity array (0 for live docids, BIG for deleted /
    never-written slots), maintained incrementally by the engine;
  * numeric range predicates evaluated on device field columns;
  * an optional host-provided term-filter mask (u8).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from gamma_tpu.ops.distances import BIG


def init_validity(cap: int) -> jnp.ndarray:
    """All slots start masked; engine zeroes slots as docs are added."""
    return jnp.full((cap,), BIG, dtype=jnp.float32)


@jax.jit
def mark_live(validity: jnp.ndarray, docids: jnp.ndarray) -> jnp.ndarray:
    return validity.at[docids].set(0.0, mode="drop")


@jax.jit
def mark_deleted(validity: jnp.ndarray, docids: jnp.ndarray) -> jnp.ndarray:
    return validity.at[docids].set(BIG, mode="drop")


@functools.partial(jax.jit, static_argnames=("include_lower", "include_upper"))
def range_penalty(col: jnp.ndarray, lower, upper,
                  include_lower: bool = True,
                  include_upper: bool = True) -> jnp.ndarray:
    """Penalty from one numeric range predicate over a device column."""
    c = col.astype(jnp.float32)
    lo = jnp.float32(lower)
    hi = jnp.float32(upper)
    ok_lo = c >= lo if include_lower else c > lo
    ok_hi = c <= hi if include_upper else c < hi
    return jnp.where(ok_lo & ok_hi, 0.0, BIG)


@jax.jit
def mask_penalty(mask_u8: jnp.ndarray) -> jnp.ndarray:
    """Host-provided boolean mask (term filters) → penalty."""
    return jnp.where(mask_u8 > 0, 0.0, BIG)


def combine(parts: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """AND-combine penalties (sum; BIG saturates well below f32 max)."""
    out = parts[0]
    for p in parts[1:]:
        out = jnp.minimum(out + p, BIG)
    return out
