"""REAL multi-process fan-out tests.

Everything else in the suite simulates multi-host by patching
``jax.process_count``; these tests launch TWO actual ``jax.distributed``
processes (CPU backend, 4 virtual devices each, coordinator on localhost).

- ``test_two_process_v_regression_fan_out`` — the distributed statistics
  pass (whole-chunk per-host stripes, UNALIGNED with the frame shard
  boundary) + the streaming V regression over a host-spanning 8-device
  mesh: per-stripe V columns assemble into ONE global frames-sharded array
  via ``jax.make_array_from_process_local_data`` with zero cross-host V
  bytes; each process's addressable shards match the single-process
  reference bit-for-bit.
- ``test_two_process_full_pipeline`` — ``localmd_decomposition`` END TO END
  in two real processes over the host-spanning mesh (block stage sharded
  across hosts, thresholds/fsvd replicated per host, V stripes assembled
  then replicated), compared against a single-process run on the same
  8-device mesh. Also asserts the mesh-less / local-mesh fail-fast raises
  BEFORE any streaming.
"""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from localmd_tpu.blocksparse import BlockSparseMatrix
from localmd_tpu.loader import PMDLoader
from localmd_tpu.ops.tiling import BlockGrid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_workers(mode, fixture, tmp_path, timeout=420):
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {
        **os.environ,
        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
    }
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"ok-{mode}-{pid}.json"
        outs.append(out)
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER, mode, coordinator, "2", str(pid),
                 str(fixture), str(out)],
                env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        )
    logs = []
    for proc in procs:
        try:
            stdout, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for kill in procs:
                kill.kill()
            pytest.fail("multi-host worker timed out (coordinator hang?)")
        logs.append(stdout.decode(errors="replace"))
    for pid, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"worker {pid} failed:\n{log}"
    return [json.loads(out.read_text()) for out in outs]


@pytest.mark.slow
def test_two_process_v_regression_fan_out(tmp_path, rng):
    t, d1, d2 = 320, 20, 20
    b1 = b2 = 10
    batch_size = 64  # V chunks; host frame-stripe boundary (160) splits one
    # 3 stats chunks over 2 hosts: host 0 gets two WHOLE chunks, host 1 one
    # (the unaligned case where a mid-chunk split would shift Welch noise)
    frame_constant = 128

    movie = (rng.standard_normal((t, d1, d2)) + 4).astype(np.float32)
    grid = BlockGrid(d1, d2, (b1, b2))
    panels = rng.standard_normal(
        (grid.n_blocks, grid.pixels_per_block, 3)
    ).astype(np.float32)
    dense_basis = np.zeros((d1 * d2, 1), np.float32)
    u = BlockSparseMatrix(
        jnp.asarray(panels), jnp.asarray(grid.rows), d1 * d2,
        jnp.asarray(dense_basis),
    )
    p = rng.standard_normal((u.shape[1], 5)).astype(np.float32)

    # single-process reference, same chunk sizes as the workers' stripes
    loader = PMDLoader(
        movie, background_rank=0, seed=0, batch_size=batch_size,
        frame_constant=frame_constant,
    )
    v_ref = np.asarray(loader.v_projection(u, jnp.asarray(p)))
    assert v_ref.shape == (5, t)

    fixture = tmp_path / "fixture.npz"
    np.savez(
        fixture, movie=movie, panels=panels, dense_basis=dense_basis,
        p=p, v_ref=v_ref, b1=b1, b2=b2, batch_size=batch_size,
        frame_constant=frame_constant,
        mean_img=np.asarray(loader.mean_img),
        std_img=np.asarray(loader.std_img),
    )

    results = _launch_workers("vreg", fixture, tmp_path)
    total_cols = 0
    for pid, result in enumerate(results):
        assert result["ok"] and result["pid"] == pid
        assert result["global_shape"] == [5, t]
        total_cols += result["checked_cols"]
    # the two processes' addressable shards tile the full frames axis
    assert total_cols == t


@pytest.mark.slow
def test_two_process_full_pipeline(tmp_path, rng):
    """localmd_decomposition end-to-end in TWO real jax.distributed
    processes: block stage sharded over the host-spanning mesh, stats and V
    distributed, thresholds/fsvd replicated — output matches a
    single-process run on the same 8-device mesh."""
    from localmd_tpu import localmd_decomposition
    from localmd_tpu.parallel.mesh import make_mesh

    t, d1, d2 = 320, 20, 20
    kw = dict(
        frame_range=320, max_components=4, background_rank=1,
        temporal_avg_factor=4, sim_iters=15, seed=0,
    )
    low = (rng.random((d1 * d2, 5)) @ rng.random((5, t))).T
    movie = (low.reshape(t, d1, d2) + rng.standard_normal((t, d1, d2))).astype(
        np.float32
    )

    # single-process reference on the SAME 8-device mesh (identical shard
    # shapes -> identical block programs; fsvd runs unsharded under
    # multi-host, so the comparison carries a small f32-association tol)
    pmd = localmd_decomposition(movie, (10, 10), mesh=make_mesh(8), **kw)
    recon_ref = pmd[:, :, :]

    fixture = tmp_path / "fixture.npz"
    np.savez(
        fixture, movie=movie, b1=10, b2=10, recon_ref=recon_ref,
        rank_ref=pmd.rank, mean_ref=np.asarray(pmd.mean_img),
        std_ref=np.asarray(pmd.var_img), **kw,
    )

    results = _launch_workers("pipeline", fixture, tmp_path, timeout=600)
    for pid, result in enumerate(results):
        assert result["ok"] and result["pid"] == pid
        assert result["failfast_checked"]
        assert result["rank"] == result["rank_ref"], result
