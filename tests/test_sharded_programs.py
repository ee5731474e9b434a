"""Each mesh-sharded phase is one cached program: a repeated call with the
same shapes traces and compiles nothing, and its result matches the
single-device path. Runs on four of the virtual CPU devices."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localmd_tpu.blocksparse import BlockSparseMatrix
from localmd_tpu.ops.tiling import BlockGrid, flatten_fov, flatten_image
from localmd_tpu.parallel.mesh import make_mesh

TRACE_EVENT = "/jax/core/compile/jaxpr_trace_duration"
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


@contextlib.contextmanager
def _count_compiles():
    counts = {"traces": 0, "compiles": 0}

    def listen(event, duration_secs, **kwargs):
        if event == TRACE_EVENT:
            counts["traces"] += 1
        elif event == COMPILE_EVENT:
            counts["compiles"] += 1

    jax.monitoring.register_event_duration_secs_listener(listen)
    try:
        yield counts
    finally:
        jax.monitoring.unregister_event_duration_listener(listen)


def _blocksparse(rng, grid, slots=3):
    n, p = grid.n_blocks, grid.pixels_per_block
    return BlockSparseMatrix(
        panels=jnp.asarray(rng.standard_normal((n, p, slots)).astype(np.float32)),
        rows=jnp.asarray(grid.rows),
        n_pixels=grid.d1 * grid.d2,
        dense_basis=jnp.asarray(
            rng.standard_normal((grid.d1 * grid.d2, 2)).astype(np.float32)
        ),
    )


def _gram(rng, mesh):
    from localmd_tpu.parallel.sharded import sharded_gram_quadratic

    u = _blocksparse(rng, BlockGrid(20, 20, (8, 8)))   # 16 blocks
    right = jnp.asarray(rng.standard_normal((u.shape[1], 6)).astype(np.float32))

    def sharded():
        return sharded_gram_quadratic(
            mesh, u.panels, u.rows, u.dense_basis, right, u.n_pixels
        )

    return sharded, lambda: u.gram_quadratic(right), 1e-2


def _vproj_chunk(rng, mesh):
    from localmd_tpu.parallel.sharded import sharded_v_projection_chunk

    u = _blocksparse(rng, BlockGrid(24, 16, (12, 8)))
    p_mat = jnp.asarray(rng.standard_normal((u.shape[1], 5)).astype(np.float32))
    chunk = flatten_fov(jnp.asarray(
        rng.standard_normal((24, 16, 16)).astype(np.float32)))
    mean = flatten_image(jnp.asarray(rng.standard_normal((24, 16)).astype(np.float32)))
    std = flatten_image(jnp.asarray((0.5 + rng.random((24, 16))).astype(np.float32)))

    def sharded():
        return sharded_v_projection_chunk(
            mesh, u.panels, u.rows, u.dense_basis, p_mat, chunk, mean, std
        )

    def single():
        x = (chunk - mean[:, None]) / std[:, None]
        return p_mat.T @ u.rmatmul(x)

    return sharded, single, 1e-3


def _vproj_kernel(rng, mesh):
    from localmd_tpu.loader import _sharded_v_projection_kernel, _v_projection_kernel

    raw = jnp.asarray(rng.integers(0, 4000, size=(16, 20, 12)).astype(np.uint16))
    a = jnp.asarray((rng.standard_normal((240, 9)) * 0.01).astype(np.float32))
    c = jnp.asarray(rng.standard_normal(9).astype(np.float32))
    return (
        lambda: _sharded_v_projection_kernel(a, c, raw, "F", mesh),
        lambda: _v_projection_kernel(a, c, raw, "F"),
        1e-4,
    )


def _window0(rng, mesh):
    from localmd_tpu.engine import window0_chunk_step
    from localmd_tpu.parallel.sharded import sharded_window0_chunk_step

    data = jnp.asarray(rng.standard_normal((24, 16, 80)).astype(np.float32))
    starts = jnp.asarray(BlockGrid(24, 16, (8, 8)).starts[:12])
    keys = jax.random.split(jax.random.PRNGKey(0), 12)
    args = (8, 8, 3, 4, 2)

    def recon(out):
        acc, counts, v = out
        return jnp.einsum("npr,nrt->npt", acc, v), counts

    def sharded():
        return recon(sharded_window0_chunk_step(
            mesh, data, starts, keys, *args, 1e9, 1e9, 1, t_used=80))

    def single():
        return recon(window0_chunk_step(
            data, starts, keys, *args, 1e9, 1e9, 1, t_used=80))

    return sharded, single, 1e-4


def _windowed(rng, mesh):
    from localmd_tpu.engine import windowed_pmd_batched

    blocks = jnp.asarray(rng.standard_normal((8, 8, 8, 160)).astype(np.float32))
    key = jax.random.PRNGKey(3)

    def run(m):
        res = windowed_pmd_batched(blocks, key, 80, 3, 1e9, 1e9, 1, 4, 2, mesh=m)
        return jnp.einsum("npr,nrt->npt", res.spatial, res.temporal), res.counts

    return lambda: run(mesh), lambda: run(None), 1e-4


PHASES = {
    "gram_quadratic": _gram,
    "v_projection_chunk": _vproj_chunk,
    "v_projection_kernel": _vproj_kernel,
    "window0_chunk_step": _window0,
    "windowed_pmd": _windowed,
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_sharded_phase_reuses_its_program(rng, phase):
    mesh = make_mesh(4)
    sharded, single, atol = PHASES[phase](rng, mesh)
    first = jax.block_until_ready(sharded())
    with _count_compiles() as counts:
        again = jax.block_until_ready(sharded())
    assert counts == {"traces": 0, "compiles": 0}
    for a, b in zip(jax.tree.leaves(first), jax.tree.leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    want = single()
    for got, ref in zip(jax.tree.leaves(first), jax.tree.leaves(want)):
        ref = np.asarray(ref, np.float64)
        scale = max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(np.asarray(got, np.float64) / scale,
                                   ref / scale, atol=atol)
