"""Worker process for the REAL multi-host fan-out tests (test_multihost.py).

Each worker is one ``jax.distributed`` process with 4 local virtual CPU
devices (8 global across 2 processes). Two modes:

``vreg`` — loads the shared fixture, runs the distributed stats pass (whole-
chunk per-host stripes + allgather) and the streaming V regression over a
host-spanning mesh — the documented multi-host input pipeline
(docs/ARCHITECTURE.md §multi-host): ``partition_chunks_for_host`` /
``partition_ranges_for_host`` stripes -> process-local V columns ->
``jax.make_array_from_process_local_data`` assembly — and asserts its OWN
addressable shards of the assembled global array match the single-process
reference columns bit-for-bit (V columns are frame-independent, so the
differing per-host chunk boundaries cannot change them). Stats images are
compared to f32 tolerance: the chunk PARTITION matches the single-host loop
exactly (whole chunks), but per-host partial sums associate differently.

``pipeline`` — first asserts the mesh-less fail-fast (a 2-process
``localmd_decomposition`` without a host-spanning mesh must raise BEFORE any
streaming), then runs the FULL pipeline end-to-end over the host-spanning
8-device mesh and compares the final reconstruction, rank, and statistics
images against the single-process reference in the fixture.

Usage: python tests/_multihost_worker.py <mode> <coordinator> <num_procs>
       <pid> <fixture.npz> <out.json>
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def run_vreg(fx, out_path, pid):
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from localmd_tpu.blocksparse import BlockSparseMatrix
    from localmd_tpu.loader import PMDLoader
    from localmd_tpu.ops.tiling import BlockGrid
    from localmd_tpu.parallel.mesh import BLOCK_AXIS

    movie = fx["movie"]
    d1, d2 = movie.shape[1], movie.shape[2]
    grid = BlockGrid(d1, d2, (int(fx["b1"]), int(fx["b2"])))
    u = BlockSparseMatrix(
        jnp.asarray(fx["panels"]),
        jnp.asarray(grid.rows),
        d1 * d2,
        jnp.asarray(fx["dense_basis"]),
    )
    p = jnp.asarray(fx["p"])
    v_ref = fx["v_ref"]

    # Both processes read the same "shared storage" (the fixture movie);
    # each streams only its own stripe of WHOLE stats chunks
    # (partition_chunks_for_host): T=320 with frame_constant=128 gives 3
    # chunks — host 0 takes two, host 1 one — the UNALIGNED case where the
    # old mid-chunk frame split materially shifted the Welch noise.
    loader = PMDLoader(
        movie, background_rank=0, seed=0,
        batch_size=int(fx["batch_size"]),
        frame_constant=int(fx["frame_constant"]),
    )
    # identical chunk partition; float association differs once a host
    # holds >1 chunk -> f32-tolerance, not bit, comparison
    np.testing.assert_allclose(
        np.asarray(loader.mean_img), fx["mean_img"], rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(loader.std_img), fx["std_img"], rtol=1e-5, atol=1e-6
    )
    mesh = Mesh(np.asarray(jax.devices()), (BLOCK_AXIS,))
    v = loader.v_projection(u, p, mesh=mesh)

    assert v.shape == tuple(v_ref.shape), (v.shape, v_ref.shape)
    shards = v.addressable_shards
    assert len(shards) == 4  # this process's devices only
    checked_cols = 0
    for shard in shards:
        sl = shard.index[1]
        np.testing.assert_array_equal(np.asarray(shard.data), v_ref[:, sl])
        checked_cols += int(np.asarray(shard.data).shape[1])

    with open(out_path, "w") as f:
        json.dump(
            {
                "ok": True,
                "pid": pid,
                "checked_cols": checked_cols,
                "global_shape": [int(x) for x in v.shape],
                "stats_checked": True,
            },
            f,
        )


def run_pipeline(fx, out_path, pid):
    from jax.sharding import Mesh

    from localmd_tpu import localmd_decomposition
    from localmd_tpu.parallel.mesh import BLOCK_AXIS

    movie = fx["movie"]
    kw = dict(
        frame_range=int(fx["frame_range"]),
        max_components=int(fx["max_components"]),
        background_rank=int(fx["background_rank"]),
        temporal_avg_factor=int(fx["temporal_avg_factor"]),
        sim_iters=int(fx["sim_iters"]),
        seed=0,
    )
    blocks = (int(fx["b1"]), int(fx["b2"]))

    # 1) fail FAST: a multi-host run without a host-spanning mesh must raise
    #    at entry, before any streaming
    failed_fast = False
    try:
        localmd_decomposition(movie, blocks, **kw)
    except ValueError as e:
        failed_fast = "host-spanning mesh" in str(e)
    assert failed_fast, "mesh-less 2-process run did not fail fast"

    # ... and a local-devices-only mesh must be rejected too
    local_only = False
    try:
        localmd_decomposition(
            movie, blocks,
            mesh=Mesh(np.asarray(jax.local_devices()), (BLOCK_AXIS,)),
            **kw,
        )
    except ValueError as e:
        local_only = "GLOBAL device list" in str(e)
    assert local_only, "local-devices mesh was not rejected"

    # 2) the FULL pipeline over the host-spanning 8-device mesh
    mesh = Mesh(np.asarray(jax.devices()), (BLOCK_AXIS,))
    pmd = localmd_decomposition(movie, blocks, mesh=mesh, **kw)

    np.testing.assert_allclose(
        np.asarray(pmd.mean_img), fx["mean_ref"], rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(pmd.var_img), fx["std_ref"], rtol=1e-5, atol=1e-6
    )
    recon = pmd[:, :, :]
    ref = fx["recon_ref"]
    assert recon.shape == ref.shape, (recon.shape, ref.shape)
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(recon / scale, ref / scale, atol=2e-4)

    with open(out_path, "w") as f:
        json.dump(
            {
                "ok": True,
                "pid": pid,
                "rank": int(pmd.rank),
                "rank_ref": int(fx["rank_ref"]),
                "failfast_checked": True,
            },
            f,
        )


def main() -> None:
    mode, coordinator, num_procs, pid, fixture_path, out_path = sys.argv[1:7]
    num_procs, pid = int(num_procs), int(pid)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_procs,
        process_id=pid,
    )
    assert jax.process_count() == num_procs
    assert len(jax.devices()) == 4 * num_procs

    fx = np.load(fixture_path)
    if mode == "vreg":
        run_vreg(fx, out_path, pid)
    elif mode == "pipeline":
        run_pipeline(fx, out_path, pid)
    else:
        raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    main()
