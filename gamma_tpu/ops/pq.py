"""Product quantization: train / encode / decode / LUT build.

Reference: faiss::ProductQuantizer as used by GammaIVFPQIndex
(gamma_index_ivfpq.cc:424-512 encode, ivfpq.h:86-349 query LUTs).  Device
re-derivation:
  * training = ONE vmapped k-means over all M subspaces at once
    (kmeans_batched_fit), not M sequential CPU k-means;
  * encode = batched matmul distances + argmin per subspace;
  * LUTs are built per (query, probed-list) residual with a single
    einsum over [*, M, dsub] x [M, ksub, dsub].

Dimension d is padded up to a multiple of M by zero-extension when
indivisible (reference pads similarly, ivfpq.cc:130-141); zeros contribute
nothing to L2/IP so recall is unaffected.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gamma_tpu.ops import kmeans as km


class PQCodebooks(NamedTuple):
    codebooks: jnp.ndarray    # [M, ksub, dsub] f32
    # squared norms of codebook entries, precomputed: [M, ksub] f32
    cb_norms: jnp.ndarray

    @property
    def M(self) -> int:
        return self.codebooks.shape[0]

    @property
    def ksub(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def d_padded(self) -> int:
        return self.M * self.dsub


def padded_dim(d: int, M: int) -> int:
    return -(-d // M) * M


def pad_to_subspaces(x: jnp.ndarray, M: int) -> jnp.ndarray:
    """Zero-pad the feature dim so it divides evenly into M subspaces."""
    d = x.shape[-1]
    dp = padded_dim(d, M)
    if dp != d:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, dp - d)]
        x = jnp.pad(x, pad)
    return x


def split_subspaces(x: jnp.ndarray, M: int) -> jnp.ndarray:
    """[..., d_padded] → [..., M, dsub]."""
    dp = x.shape[-1]
    return x.reshape(x.shape[:-1] + (M, dp // M))


def train_pq(x: jnp.ndarray, M: int, *, nbits: int = 8, iters: int = 12,
             seed: int = 0, chunk: int = 4096) -> PQCodebooks:
    """Train M codebooks of 2^nbits centroids each on x [n, d]."""
    ksub = 1 << nbits
    xp = pad_to_subspaces(jnp.asarray(x, jnp.float32), M)
    sub = split_subspaces(xp, M)                       # [n, M, dsub]
    sub = jnp.transpose(sub, (1, 0, 2))                # [M, n, dsub]
    n = sub.shape[1]
    key = jax.random.PRNGKey(seed)
    if n >= ksub:
        perm = jax.random.permutation(key, n)[:ksub]
        inits = sub[:, perm, :]
    else:
        reps = -(-ksub // n)
        inits = jnp.tile(sub, (1, reps, 1))[:, :ksub, :]
        inits = inits + 1e-5 * jax.random.normal(key, inits.shape)
    cents, _ = km.kmeans_batched_fit(sub, inits, k=ksub, iters=iters,
                                     chunk=chunk)
    norms = jnp.sum(cents * cents, axis=-1)
    return PQCodebooks(cents, norms)


@functools.partial(jax.jit, static_argnames=("chunk",))
def encode_pq(pq: PQCodebooks, x: jnp.ndarray, *, chunk: int = 4096) -> jnp.ndarray:
    """x [n, d] → codes u8 [n, M] (nearest codebook entry per subspace)."""
    M = pq.M
    xp = pad_to_subspaces(jnp.asarray(x, jnp.float32), M)
    sub = split_subspaces(xp, M)                      # [n, M, dsub]
    n = sub.shape[0]
    padn = (-n) % chunk
    if padn:
        sub = jnp.concatenate(
            [sub, jnp.zeros((padn, M, pq.dsub), jnp.float32)], axis=0)

    def one_chunk(s):                                  # s: [chunk, M, dsub]
        # dist[c, m, k] = ||s - cb||^2 ; cross term via batched matmul
        cross = jnp.einsum("cmd,mkd->cmk", s, pq.codebooks,
                           preferred_element_type=jnp.float32)
        sn = jnp.sum(s * s, axis=-1)                   # [chunk, M]
        dist = sn[:, :, None] - 2.0 * cross + pq.cb_norms[None, :, :]
        return jnp.argmin(dist, axis=-1).astype(jnp.uint8)

    sub = sub.reshape(-1, chunk, M, pq.dsub)
    codes = jax.lax.map(one_chunk, sub).reshape(-1, M)
    return codes[:n]


@jax.jit
def decode_pq(pq: PQCodebooks, codes: jnp.ndarray) -> jnp.ndarray:
    """codes u8 [n, M] → reconstructed vectors [n, d_padded] f32."""
    # gather per subspace: codebooks[m, codes[:, m]] — leading-axis gathers
    def one(cb_m, codes_m):
        return jnp.take(cb_m, codes_m.astype(jnp.int32), axis=0)

    rec = jax.vmap(one, in_axes=(0, 1), out_axes=1)(pq.codebooks, codes)
    return rec.reshape(codes.shape[0], pq.d_padded)


def l2_lut(pq: PQCodebooks, residuals: jnp.ndarray) -> jnp.ndarray:
    """ADC lookup tables for L2: residuals [..., d] →
    LUT [..., M, ksub] with LUT[m, k] = ||r_m - cb[m, k]||^2."""
    residuals = pad_to_subspaces(residuals, pq.M)
    sub = split_subspaces(residuals.astype(jnp.float32), pq.M)  # [..., M, dsub]
    cross = jnp.einsum("...md,mkd->...mk", sub, pq.codebooks,
                       preferred_element_type=jnp.float32)
    rn = jnp.sum(sub * sub, axis=-1)                            # [..., M]
    return rn[..., None] - 2.0 * cross + pq.cb_norms


def ip_lut(pq: PQCodebooks, queries: jnp.ndarray) -> jnp.ndarray:
    """ADC tables for inner product: LUT[m, k] = q_m . cb[m, k]."""
    queries = pad_to_subspaces(queries, pq.M)
    sub = split_subspaces(queries.astype(jnp.float32), pq.M)
    return jnp.einsum("...md,mkd->...mk", sub, pq.codebooks,
                      preferred_element_type=jnp.float32)


def unpack_nibbles(packed: jnp.ndarray) -> jnp.ndarray:
    """[..., W] u8 packed → [..., 2W] u8 codes in 0..15 (lo nibble first)."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    return jnp.stack([lo, hi], axis=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))


def adc_scan(lut: jnp.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """Sum LUT entries selected by codes.

    lut:   [..., M, ksub] f32
    codes: [..., C, M]    u8   (same leading dims as lut)
    → dist [..., C] f32  where dist[c] = sum_m lut[m, codes[c, m]]
    """
    idx = jnp.swapaxes(codes.astype(jnp.int32), -1, -2)   # [..., M, C]
    picked = jnp.take_along_axis(lut, idx, axis=-1)       # [..., M, C]
    return jnp.sum(picked, axis=-2)
