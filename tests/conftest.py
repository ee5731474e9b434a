"""Test config: run on a virtual 8-device CPU mesh unless the caller picks a
platform (``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` runs the
GPU-marked tests on a card).

Must set env vars BEFORE jax is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_low_rank_movie(rank, dims, rng=None, noise=0.0):
    """Exactly rank-``rank`` (T, d1, d2) movie from a spatial x temporal outer
    product (same construction as the reference test fixture,
    reference test/test_pmd.py:7-11), optional additive noise."""
    rng = rng or np.random.default_rng(0)
    t, d1, d2 = dims
    # PMD's rank test keeps components that are smooth in space AND time
    # (real calcium/voltage signals are); white factors would be correctly
    # rejected as noise, so smooth both factors.
    spatial = rng.random((d1, d2, rank))
    for _ in range(4):
        spatial = 0.2 * (
            spatial
            + np.roll(spatial, 1, 0) + np.roll(spatial, -1, 0)
            + np.roll(spatial, 1, 1) + np.roll(spatial, -1, 1)
        )
    spatial = spatial.reshape(d1 * d2, rank)
    temporal = rng.random((rank, t))
    for _ in range(3):
        temporal = 0.5 * temporal + 0.25 * (
            np.roll(temporal, 1, 1) + np.roll(temporal, -1, 1)
        )
    movie = (spatial @ temporal).T.reshape((t, d1, d2))
    if noise:
        movie = movie + noise * rng.standard_normal(movie.shape)
    return movie.astype(np.float32)
