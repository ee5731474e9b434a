"""Multi-host (``jax.distributed``) plumbing for the PMD pipeline.

The pipeline's multi-host execution model (docs/ARCHITECTURE.md §multi-host):

- **statistics pass** — each process streams its own contiguous stripe of
  WHOLE stats chunks from shared storage; additive accumulators combine in
  one tiny cross-host allgather (loader._initialize_normalizers).
- **thresholds / init load / factorized SVD / final reformat** — duplicated
  per host. All are deterministic functions of the (shared) seed and the
  (identical) statistics images, so every host computes the same values;
  duplicating beats distributing for these stages because their inputs are
  small and the collective to broadcast results would cost more than the
  recompute (thresholds: a seeded Monte-Carlo; fsvd: Gram matrices of at
  most a few thousand columns).
- **block stage** — sharded over the HOST-SPANNING mesh: the init movie is
  replicated (each host already holds an identical copy from its own init
  load), block starts/keys shard over the mesh's block axis, and each
  batch's outputs are gathered back so every host holds the full panel set
  (``replicate_block_outputs``). Cross-host traffic per batch = the output
  panels only.
- **V regression** — frames-parallel per-host stripes with a final global
  assembly (loader.v_projection), then replicated to every host
  (``replicate_frame_sharded``) so the final reformat and the returned
  PMDArray are ordinary host-local objects.

The reference has no distributed code at all (SURVEY.md §5); this module is
the JAX equivalent of a multi-node input + compute fan-out.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from localmd_tpu.parallel.mesh import BLOCK_AXIS


def process_count() -> int:
    return getattr(jax, "process_count", lambda: 1)()


def is_multihost() -> bool:
    return process_count() > 1


def validate_multihost_mesh(mesh: Optional[Mesh]) -> None:
    """Fail FAST on a misconfigured ``jax.distributed`` run.

    A 2-process run without a host-spanning mesh previously streamed the
    whole stats pass, ran the full block stage and factorized SVD, streamed
    its V stripe — and only THEN crashed in the global V assembly
    (hours wasted on a real multi-host run). Raise before any
    streaming instead.
    """
    n_proc = process_count()
    if n_proc <= 1:
        return
    if mesh is None:
        raise ValueError(
            f"This is a {n_proc}-process jax.distributed run, but no mesh "
            "was passed to localmd_decomposition. Multi-host runs need a "
            "host-spanning mesh over ALL global devices, e.g. "
            "Mesh(np.asarray(jax.devices()), ('blocks',)). Single-host "
            "meshes or mesh=None only work with jax.process_count() == 1."
        )
    mesh_procs = {d.process_index for d in mesh.devices.flat}
    if len(mesh_procs) != n_proc:
        raise ValueError(
            f"mesh spans processes {sorted(mesh_procs)} but this run has "
            f"{n_proc} processes. Every process must participate: build the "
            "mesh from jax.devices() (the GLOBAL device list), not "
            "jax.local_devices()."
        )
    if mesh.devices.size % n_proc != 0:
        raise ValueError(
            f"mesh size {mesh.devices.size} is not divisible by the "
            f"process count {n_proc}; per-host stripes would be ragged."
        )


def host_local_to_global(mesh: Mesh, spec: P, full_array, shard_axis: int = 0):
    """A GLOBAL array from an array that every process holds in FULL
    (identical copies — the pipeline's init movie, block starts, keys).

    For a sharded ``spec`` each process contributes only the
    ``shard_axis``-stripe its own devices address; the identical full
    copies guarantee consistency. Single-process: returns the input placed
    as a sharded global array.
    """
    from jax.experimental import multihost_utils

    if not is_multihost():
        return jax.device_put(
            full_array, jax.sharding.NamedSharding(mesh, spec)
        )
    if spec == P():
        return multihost_utils.host_local_array_to_global_array(
            full_array, mesh, spec
        )
    # sharded: slice this host's contiguous stripe of shard_axis
    n_proc = process_count()
    n = full_array.shape[shard_axis]
    if n % n_proc:
        raise ValueError(
            f"axis {shard_axis} ({n}) not divisible by process count"
        )
    per = n // n_proc
    h = jax.process_index()
    idx = [slice(None)] * full_array.ndim
    idx[shard_axis] = slice(h * per, (h + 1) * per)
    local = full_array[tuple(idx)]
    return multihost_utils.host_local_array_to_global_array(local, mesh, spec)


def replicate_block_outputs(mesh: Mesh, *arrays) -> tuple:
    """Gather block-axis-sharded GLOBAL arrays to identical host-local full
    arrays on every process (the block stage's per-batch outputs).

    Single-process: just converts to host-backed jnp arrays.
    """
    from jax.experimental import multihost_utils

    if not is_multihost():
        return tuple(jnp.asarray(a) for a in arrays)
    out = []
    for a in arrays:
        local = multihost_utils.global_array_to_host_local_array(
            a, mesh, P(BLOCK_AXIS)
        )
        gathered = multihost_utils.process_allgather(
            np.asarray(local), tiled=True
        )
        out.append(jnp.asarray(gathered))
    return tuple(out)


def replicate_frame_sharded(v: jax.Array) -> jnp.ndarray:
    """A host-local full copy of a frames-axis-sharded global (r, T) array
    (the assembled V) on every process.

    The per-process stripes are jax's ceil-division shards: equal width
    except the tail, so stripes are zero-padded to the shard width, tiled-
    allgathered along the frame axis, and trimmed back to T.
    """
    from jax.experimental import multihost_utils

    if not is_multihost():
        return jnp.asarray(v)
    r, t = v.shape
    n_proc = process_count()
    shard = -(-t // n_proc)
    h = jax.process_index()
    lo, hi = min(h * shard, t), min((h + 1) * shard, t)
    # this process's addressable columns, in order
    cols = []
    for s in sorted(v.addressable_shards, key=lambda s: s.index[1].start or 0):
        cols.append(np.asarray(s.data))
    local = (
        np.concatenate(cols, axis=1)
        if cols
        else np.zeros((r, 0), np.float32)
    )
    assert local.shape[1] == hi - lo, (local.shape, lo, hi)
    if local.shape[1] < shard:
        local = np.concatenate(
            [local, np.zeros((r, shard - local.shape[1]), local.dtype)], axis=1
        )
    gathered = multihost_utils.process_allgather(
        np.ascontiguousarray(local.T), tiled=True
    )  # (n_proc * shard, r)
    return jnp.asarray(gathered[:t].T)


def agree_int_min(value: int) -> int:
    """The cross-process MINIMUM of a host-local int: every process must use
    the same block batch size (a per-host memory_stats difference would
    otherwise produce divergent global dispatch shapes — a deadlock)."""
    from jax.experimental import multihost_utils

    if not is_multihost():
        return int(value)
    vals = multihost_utils.process_allgather(np.asarray([value]))
    return int(np.min(vals))
