"""Card-only checks (marker `gpu`; skipped where JAX has no GPU).

Run on a machine with an NVIDIA GPU:
    GAMMA_TESTS_ON_GPU=1 python -m pytest -m gpu tests/test_gpu.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gamma_tpu.ops.flat_scan import flat_search
from gamma_tpu.ops.topk import select_min_k


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_flat_scan_exact_on_gpu(gpu, metric):
    """The FLAT scan pins Precision.HIGHEST: its distances agree with
    float64 to f32 rounding.  At the GPU's default (TF32, ~10-bit
    mantissa) the cross term alone would err by ~1e-3 relative."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20_000, 128)).astype(np.float32)
    q = rng.normal(size=(64, 128)).astype(np.float32)
    with jax.default_device(gpu):
        d, ids = flat_search(jnp.asarray(x), jnp.asarray((x ** 2).sum(1)),
                             jnp.asarray(q), jnp.zeros(20_000), k=10,
                             metric=metric)
    d, ids = np.asarray(d, np.float64), np.asarray(ids)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "ip":
        ref = -np.einsum("bd,bkd->bk", q64, x64[ids])
    else:
        ref = ((x64[ids] - q64[:, None, :]) ** 2).sum(-1)
    # norm-expansion L2 in f32: |err| ~ eps32 * (||q||^2 + ||x||^2)
    scale = (q64 ** 2).sum(1)[:, None] + (x64[ids] ** 2).sum(-1)
    assert np.max(np.abs(d - ref) / scale) < 1e-5


@pytest.mark.gpu
def test_select_min_k_on_gpu(gpu):
    """The wide select compiled for the card keeps the exact top-k of a
    random row (no two winners share a strided bin here)."""
    rng = np.random.default_rng(1)
    s = rng.normal(size=(64, 1 << 20)).astype(np.float32)
    with jax.default_device(gpu):
        vals, idx = select_min_k(jnp.asarray(s), 100)
    vals, idx = np.asarray(vals), np.asarray(idx)
    np.testing.assert_array_equal(vals, np.take_along_axis(s, idx, 1))
    exact = np.sort(s, axis=1)[:, :10]
    np.testing.assert_array_equal(vals[:, :10], exact)
