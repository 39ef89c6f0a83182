"""Pairwise distance primitives — all matmuls.

Reference hot loops these replace: the coarse-quantizer scan
(gamma_index_ivfpq.cc:549 quantizer->search) and the brute-force flat scan
(gamma_index_flat.cc:118-300).  Both are (nq x d x N) matmuls with the L2
norm-expansion trick.

Precision: with the default `precision=None` XLA picks the matmul
precision, which on an NVIDIA GPU is TF32 for f32 operands (~10-bit
mantissa).  That is fine where the result only ranks candidates (coarse
assign, k-means, the bf16 dense cross term); callers whose contract is
exact distances (the FLAT scan) pass `jax.lax.Precision.HIGHEST`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# "+inf" that survives arithmetic without NaNs; a plain float so it can be
# a static jaxpr parameter (e.g. gather fill_value)
BIG = 3.0e38


def l2_norms(x: jnp.ndarray) -> jnp.ndarray:
    """Row-wise squared L2 norms, f32."""
    xf = x.astype(jnp.float32)
    return jnp.sum(xf * xf, axis=-1)


def pairwise_l2(q: jnp.ndarray, x: jnp.ndarray,
                x_norms: jnp.ndarray | None = None,
                precision=None) -> jnp.ndarray:
    """Squared L2 distances [nq, n] via ||q||^2 - 2 q.x + ||x||^2.

    Accumulates in f32 regardless of input dtype.
    """
    qf = q.astype(jnp.float32)
    cross = jax.lax.dot_general(
        q, x,
        dimension_numbers=(((q.ndim - 1,), (x.ndim - 1,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )
    if x_norms is None:
        x_norms = l2_norms(x)
    qn = jnp.sum(qf * qf, axis=-1, keepdims=True)
    d = qn - 2.0 * cross + x_norms[None, :]
    return jnp.maximum(d, 0.0)


def pairwise_ip(q: jnp.ndarray, x: jnp.ndarray,
                precision=None) -> jnp.ndarray:
    """Inner products [nq, n] (higher = better)."""
    return jax.lax.dot_general(
        q, x,
        dimension_numbers=(((q.ndim - 1,), (x.ndim - 1,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )


def pairwise_dist(q, x, metric: str, x_norms=None) -> jnp.ndarray:
    """Distance where smaller is always better (IP is negated)."""
    if metric == "ip":
        return -pairwise_ip(q, x)
    return pairwise_l2(q, x, x_norms)
