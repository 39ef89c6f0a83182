"""Test config.

The suite runs on the CPU backend with 8 virtual devices (set before jax
is imported), so the sharding tests run anywhere.  The GPU path is
exercised end to end by `python chip_smoke.py` on the card.  Tests that
need the card carry the `gpu` marker and take the `gpu` fixture, which
skips them here; on a machine with a GPU run them with

    GAMMA_TESTS_ON_GPU=1 python -m pytest -m gpu tests/
"""

import os

ON_GPU = os.environ.get("GAMMA_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    # a jax imported before this file ran captured the environment
    # already; update its config too
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped elsewhere")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none.  Decided
    here, at run time, so every worker collects the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (GAMMA_TESTS_ON_GPU=1 on the "
                    "card)")
    return devs[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def make_blobs(rng, n, d, n_clusters=32, scale=0.15):
    """Synthetic clustered corpus — SIFT-like geometry for ANN tests."""
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + scale * rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


@pytest.fixture(scope="session")
def corpus_small(rng):
    return make_blobs(rng, 2000, 32)


@pytest.fixture(scope="session")
def corpus_medium(rng):
    return make_blobs(rng, 20000, 64, n_clusters=64)
