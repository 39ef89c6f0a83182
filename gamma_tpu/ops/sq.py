"""Residual SQ8: per-dimension int8 scalar quantization of IVF residuals.

The capacity tier's gather payload (index/ivfpq.py): an int8 code per
dimension stored IN SLOT ORDER next to each inverted list's PQ codes,
plus the exact f32 norm of every dequantized point, so the list scan
(ops/ivf_scan.sq_raw_dist_xla) computes exact distances to the
quantized points and selects top-k with no rerank row gather:

    x_d  ~  off_d + scale_d * c_d                    (c = u8 code)
    q.x  =  (q*scale).c  +  q.off
    ||q - x||^2 = ||q||^2 - 2 q.x + ||x||^2
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def train_sq(x: jnp.ndarray, eps: float = 1e-8
             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-dimension affine range fit over a train set → (scale[d],
    off[d]) f32 with x ~ off + scale * c, c in [0, 255].

    Pass RESIDUALS (x - coarse centroid) for the residual coding used by
    the capacity tier: the residual range is ~5-10x smaller than the
    global range, shrinking quantization noise ~25-100x."""
    xf = x.astype(jnp.float32)
    # clip the fit range at the 0.05/99.95 percentiles: a min/max fit
    # lets a handful of outlier rows inflate the step for EVERY row.
    # Rows outside the clipped range clamp in encode_sq — rare, and
    # their norms stay exact, so only their own distances blur.
    lo = jnp.percentile(xf, 0.05, axis=0)
    hi = jnp.percentile(xf, 99.95, axis=0)
    scale = jnp.maximum(hi - lo, eps) / 255.0
    return scale, lo


@functools.partial(jax.jit, static_argnames=("d_pad", "residual"))
def encode_sq(x: jnp.ndarray, scale: jnp.ndarray, off: jnp.ndarray,
              coarse: Optional[jnp.ndarray] = None,
              *, d_pad: int, residual: bool = False
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """→ (codes [n, d_pad] u8, norms [n] f32).  With residual=True,
    `coarse` is the per-row coarse centroid and the CODE quantizes
    x - coarse; norms are always the exact ||dequant-point||^2 of the
    FULL point so scan distances are exact distances to the quantized
    point.  Padding dims encode as 0 and are never read by the scan."""
    xf = x.astype(jnp.float32)
    base = coarse.astype(jnp.float32) if residual else 0.0
    r = xf - base
    c = jnp.clip(jnp.round((r - off[None, :]) / scale[None, :]),
                 0.0, 255.0)
    deq = base + off[None, :] + scale[None, :] * c
    norms = jnp.sum(deq * deq, axis=-1)
    codes = c.astype(jnp.uint8)
    d = codes.shape[1]
    if d != d_pad:
        codes = jnp.pad(codes, ((0, 0), (0, d_pad - d)))
    return codes, norms
