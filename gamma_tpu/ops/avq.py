"""Anisotropic vector quantization (ScaNN-style score-aware PQ training).

Reference role: index/impl/scann/ — the reference vendors Google's ScaNN
as the VEARCH retrieval type; its core technique is the anisotropic
quantization loss of "Accelerating Large-Scale Inference with Anisotropic
Vector Quantization" (Guo et al., 2020): for MIPS, reconstruction error
PARALLEL to the datapoint hurts inner-product ranking more than
orthogonal error, so the k-means objective is
    l(x, c) = h_par * ||P_x (x-c)||^2 + h_orth * ||(I-P_x)(x-c)||^2
            = h_orth * ||x-c||^2 + (h_par - h_orth) * (x_hat . (x-c))^2
with x_hat the ORIGINAL datapoint direction (kept when quantizing
residuals).

Re-derivation, applied per PQ subspace (the official ScaNN
coordinate-descends subspaces under the full-vector loss; the per-
subspace direction is the standard simplification and keeps every step a
batched matmul):
  * assignment: one [n, ksub] matmul for ||x-c||^2 plus one for x_hat.c;
  * update: per-centroid closed form — A_k c = b_k with
      A_k = h_orth * n_k * I + (h_par - h_orth) * sum x_hat x_hat^T
      b_k = h_par * sum x        (h_orth = 1)
    solved as a vmapped batch of [dsub, dsub] systems on device.

eta = h_par / h_orth follows the paper's threshold rule:
eta(T) = (d-1) * T^2 / (1 - T^2), default T = 0.2.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from gamma_tpu.ops import pq as pq_ops


def eta_from_threshold(t: float, d: int) -> float:
    """Guo et al. Theorem 3.2 weighting for score threshold T."""
    t2 = min(max(t * t, 1e-6), 0.99)
    return (d - 1) * t2 / (1.0 - t2)


def _aniso_cost(x, xhat, cents, eta: float):
    """x/xhat [n, dsub], cents [ksub, dsub] → loss [n, ksub]."""
    d2 = (jnp.sum(x * x, 1)[:, None] - 2.0 * x @ cents.T
          + jnp.sum(cents * cents, 1)[None, :])
    par = (jnp.sum(xhat * x, 1)[:, None] - xhat @ cents.T) ** 2
    return d2 + (eta - 1.0) * par


@functools.partial(jax.jit, static_argnames=("eta",))
def _aniso_assign(x, xhat, cents, *, eta: float):
    return jnp.argmin(_aniso_cost(x, xhat, cents, eta),
                      axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("ksub", "eta"))
def _aniso_update(x, xhat, assign, *, ksub: int, eta: float):
    """Closed-form weighted centroid update (batched dsub x dsub solves)."""
    n, dsub = x.shape
    onehot = jax.nn.one_hot(assign, ksub, dtype=jnp.float32)  # [n, ksub]
    counts = jnp.sum(onehot, axis=0)                          # [ksub]
    b = eta * (onehot.T @ x)                                  # [ksub, dsub]
    outer = jnp.einsum("nk,ni,nj->kij", onehot, xhat, xhat)
    eye = jnp.eye(dsub, dtype=jnp.float32)
    A = (counts[:, None, None] * eye[None]
         + (eta - 1.0) * outer
         + 1e-6 * eye[None])
    cents = jax.vmap(jnp.linalg.solve)(A, b)
    return cents, counts


def _split_dirs(x: jnp.ndarray, dirs: jnp.ndarray, M: int):
    sub = pq_ops.split_subspaces(
        pq_ops.pad_to_subspaces(jnp.asarray(x, jnp.float32), M), M)
    dsub = pq_ops.split_subspaces(
        pq_ops.pad_to_subspaces(jnp.asarray(dirs, jnp.float32), M), M)
    xhat = dsub / jnp.maximum(
        jnp.linalg.norm(dsub, axis=-1, keepdims=True), 1e-12)
    return sub, xhat


def train_avq(x: jnp.ndarray, M: int, *, dirs: Optional[jnp.ndarray] = None,
              nbits: int = 8, eta: Optional[float] = None,
              threshold: float = 0.2, iters: int = 10,
              seed: int = 0) -> pq_ops.PQCodebooks:
    """Train anisotropic PQ codebooks on x [n, d].  `dirs` carries the
    datapoint directions the loss is anisotropic about (defaults to x;
    pass the ORIGINAL rotated vectors when x holds residuals).
    Initialization = plain PQ k-means, then anisotropic Lloyd steps."""
    ksub = 1 << nbits
    d = x.shape[-1]
    if eta is None:
        eta = eta_from_threshold(threshold, d)
    if dirs is None:
        dirs = x
    base = pq_ops.train_pq(x, M, nbits=nbits, iters=6, seed=seed)
    sub, xhat = _split_dirs(x, dirs, M)

    cbs = []
    for m in range(M):
        xm, xhm = sub[:, m], xhat[:, m]
        cents = base.codebooks[m]
        for _ in range(iters):
            assign = _aniso_assign(xm, xhm, cents, eta=float(eta))
            new, counts = _aniso_update(xm, xhm, assign,
                                        ksub=ksub, eta=float(eta))
            cents = jnp.where(counts[:, None] > 0, new, cents)
        cbs.append(cents)
    cb = jnp.stack(cbs)                                  # [M, ksub, dsub]
    return pq_ops.PQCodebooks(cb, jnp.sum(cb * cb, axis=-1))


@functools.partial(jax.jit, static_argnames=("M", "eta", "chunk"))
def encode_avq(pq: pq_ops.PQCodebooks, x: jnp.ndarray, dirs: jnp.ndarray,
               *, M: int, eta: float, chunk: int = 4096) -> jnp.ndarray:
    """Anisotropic-loss encoding (the indexing-time counterpart of the
    training assignment) → codes u8 [n, M]."""
    sub, xhat = _split_dirs(x, dirs, M)
    n = sub.shape[0]
    padn = (-n) % chunk
    if padn:
        z = jnp.zeros((padn,) + sub.shape[1:], jnp.float32)
        sub = jnp.concatenate([sub, z], axis=0)
        xhat = jnp.concatenate([xhat, z], axis=0)

    def one_chunk(args):
        s, h = args                                 # [chunk, M, dsub]
        def per_m(xm, hm, cm):
            return jnp.argmin(_aniso_cost(xm, hm, cm, eta), axis=1)
        a = jax.vmap(per_m, in_axes=(1, 1, 0), out_axes=1)(
            s, h, pq.codebooks)
        return a.astype(jnp.uint8)

    codes = jax.lax.map(one_chunk,
                        (sub.reshape(-1, chunk, M, sub.shape[-1]),
                         xhat.reshape(-1, chunk, M, sub.shape[-1])))
    return codes.reshape(-1, M)[:n]
