"""Device mesh helpers for the PMD pipeline.

The parallelism structure of PMD (see SURVEY.md §5/§7 and BASELINE.json
north star):

- The FOV block grid is embarrassingly parallel -> shard the leading
  ``n_blocks`` axis of every batched per-block tensor over the mesh
  ("blocks" axis). Collectives are needed only when per-block panels are
  combined into global-pixel-space quantities (overlap-add / Gram products)
  — a single ``psum``.
- The streaming temporal regression is data-parallel over frames -> shard
  the frames axis ("blocks" axis reused; zero cross-chip traffic, final
  concat on host).

The reference has no distributed code at all (single-device host loops,
reference SURVEY §5); this module is the device-mesh replacement.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BLOCK_AXIS = "blocks"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = BLOCK_AXIS) -> Mesh:
    """1-D mesh over all (or the first n) local devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def block_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (n_blocks) axis."""
    return NamedSharding(mesh, P(BLOCK_AXIS))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the trailing frames axis of a (pixels, frames) chunk."""
    return NamedSharding(mesh, P(None, BLOCK_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
