"""shard_map'd phases of the PMD pipeline.

Three SPMD phases (see mesh.py for the parallelism map):

1. ``sharded_block_decomposition`` — the windowed per-block engine with the
   patch batch sharded over the mesh's block axis. Pure data parallelism:
   the init movie is replicated, each chip extracts + decomposes its own
   patches; NO collectives inside.
2. ``sharded_v_projection_chunk`` — frames-axis data parallelism for the
   streaming temporal regression; NO collectives (the host concatenates
   chunk results).
3. ``sharded_gram_quadratic`` — right.T (U.T U) right with U's panels
   sharded over blocks: each chip scatter-adds its panels' contribution to
   Z = U @ right, one ``psum`` combines the overlap seams, then the (m, m)
   product is computed on the local m-shard. This is the only place the
   block-overlap structure induces cross-chip traffic.

Each phase is one ``jax.jit`` program keyed on its mesh and static
arguments, so a repeated call with the same shapes reuses the compiled
program; an eagerly applied ``shard_map`` would retrace and recompile its
body on every call.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import Array
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map

from localmd_tpu.parallel.mesh import BLOCK_AXIS


def _mm(a, b):
    return jnp.matmul(a, b, preferred_element_type=jnp.float32)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "b1", "b2", "max_rank", "temporal_avg_factor",
        "spatial_avg_factor", "max_consecutive_failures", "spatial_denoiser",
        "temporal_denoiser", "t_used",
    ),
)
def sharded_window0_chunk_step(
    mesh: Mesh,
    data: Array,
    starts: Array,
    keys: Array,
    b1: int,
    b2: int,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_threshold,
    temporal_threshold,
    max_consecutive_failures: int,
    spatial_denoiser=None,
    temporal_denoiser=None,
    t_used: int = 0,
) -> Tuple[Array, Array, Array]:
    """The fused single-window chunk step (gather -> decompose -> pack ->
    project) with the block axis sharded over the mesh. ``data`` is
    replicated; each chip processes its own patches — no collectives.

    ``starts``/``keys`` first dim must be divisible by the mesh size.
    """
    from localmd_tpu.engine import identity, window0_chunk_step

    sden = spatial_denoiser if spatial_denoiser is not None else identity
    tden = temporal_denoiser if temporal_denoiser is not None else identity

    def local(data_r, starts_l, keys_l, sthr, tthr):
        return window0_chunk_step(
            data_r, starts_l, keys_l, b1, b2, max_rank, temporal_avg_factor,
            spatial_avg_factor, sthr, tthr, max_consecutive_failures,
            sden, tden, t_used,
        )

    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(BLOCK_AXIS), P(BLOCK_AXIS), P(), P()),
        out_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(BLOCK_AXIS)),
        check_vma=False,
    )
    return f(
        data,
        starts,
        keys,
        jnp.asarray(spatial_threshold, jnp.float32),
        jnp.asarray(temporal_threshold, jnp.float32),
    )


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "n_windows", "window_length", "max_rank",
        "temporal_avg_factor", "spatial_avg_factor",
        "max_consecutive_failures", "spatial_denoiser", "temporal_denoiser",
    ),
)
def sharded_windowed_pmd(
    mesh: Mesh,
    patches: Array,
    keys_all: Array,
    spatial_threshold: Array,
    temporal_threshold: Array,
    *,
    n_windows: int,
    window_length: int,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    max_consecutive_failures: int,
    spatial_denoiser=None,
    temporal_denoiser=None,
) -> Tuple[Array, Array, Array]:
    """The multi-window incremental-basis loop with the block axis sharded.

    Each chip runs the whole window while_loop on its own patch shard; the
    early-stop ("every block full") and zero-count-fallback predicates are
    ``pmin``'d across the mesh inside the loop so all chips stay in lockstep.
    Replaces the reference's serial host block loop over ``windowed_pmd``
    (decomposition.py:410-525) for the multi-window (voltage) configuration.

    ``patches``: (n, b1, b2, t), n divisible by the mesh size.
    ``keys_all``: (n_windows, n, 2) per-(window, block) keys.
    """
    from localmd_tpu.engine import _windowed_loop_impl, identity

    local = partial(
        _windowed_loop_impl,
        n_windows=n_windows,
        window_length=window_length,
        max_rank=max_rank,
        temporal_avg_factor=temporal_avg_factor,
        spatial_avg_factor=spatial_avg_factor,
        max_consecutive_failures=max_consecutive_failures,
        spatial_denoiser=spatial_denoiser if spatial_denoiser is not None else identity,
        temporal_denoiser=temporal_denoiser if temporal_denoiser is not None else identity,
        axis_name=BLOCK_AXIS,
    )
    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(None, BLOCK_AXIS), P(), P()),
        out_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(BLOCK_AXIS)),
        check_vma=False,
    )
    return f(patches, keys_all, spatial_threshold, temporal_threshold)


@partial(jax.jit, static_argnames=("mesh", "local_fn"))
def sharded_block_decomposition(
    mesh: Mesh,
    local_fn: Callable[[Array, Array], Tuple[Array, Array, Array]],
    patches: Array,
    keys: Array,
) -> Tuple[Array, Array, Array]:
    """Run a batched per-block kernel with the block axis sharded.

    Args:
        local_fn: (patches_shard (nb_local, b1, b2, t), keys_shard) ->
            (u, decisions, v) — e.g. a partial of single_block_md_batched.
        patches: (n_blocks, b1, b2, t), n_blocks divisible by mesh size.
        keys: (n_blocks, 2).
    """
    f = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS)),
        out_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(BLOCK_AXIS)),
        check_vma=False,
    )
    return f(patches, keys)


@partial(jax.jit, static_argnames=("mesh",))
def sharded_v_projection_chunk(
    mesh: Mesh,
    panels: Array,
    rows: Array,
    dense_basis: Array,
    p_matrix: Array,
    chunk_flat: Array,
    mean_flat: Array,
    std_flat: Array,
) -> Array:
    """V chunk = P^T U^T standardize(X) with the frame axis sharded.

    ``chunk_flat``: (d, t_c) raw frames, F-order flattened. U (panels/rows/
    dense_basis) and P are replicated; each chip handles t_c / n_dev frames.
    """

    def local(chunk_l, panels_r, rows_r, bg_r, p_r, mean_r, std_r):
        x = (chunk_l - mean_r[:, None]) / std_r[:, None]
        gathered = x[rows_r]                              # (n, p, t_l)
        block_part = _mm(jnp.swapaxes(panels_r, -1, -2), gathered)
        block_part = block_part.reshape(-1, x.shape[1])
        bg_part = _mm(bg_r.T, x)
        utx = jnp.concatenate([block_part, bg_part], axis=0)
        return _mm(p_r.T, utx)                            # (r', t_l)

    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, BLOCK_AXIS), P(), P(), P(), P(), P(), P()),
        out_specs=P(None, BLOCK_AXIS),
        check_vma=False,
    )
    return f(chunk_flat, panels, rows, dense_basis, p_matrix, mean_flat, std_flat)


@partial(jax.jit, static_argnames=("mesh", "n_pixels", "col_chunk"))
def sharded_gram_quadratic(
    mesh: Mesh,
    panels: Array,
    rows: Array,
    dense_basis: Array,
    right: Array,
    n_pixels: int,
    col_chunk: int = 1024,
) -> Array:
    """Symmetrized right.T (U.T U) right with block panels sharded, in
    bounded per-chip memory.

    Column-chunked pixel-sharded formulation: for each ``col_chunk``-column
    slice of ``right``, every chip scatter-adds its local blocks'
    contribution to that slice of Z = U @ right, a ``psum_scatter`` over the
    block axis both combines the pyramid-overlap seams AND leaves each chip
    holding only its PIXEL shard of the slice; the replicated background
    term is added post-scatter on the local pixel shard. The (m, m) result
    is then one ``psum`` of the pixel-sharded Z^T Z.

    Per-chip peak: (n_pixels/n_dev) x m accumulator + one n_pixels x
    col_chunk staging slice — versus the full n_pixels x m buffer the naive
    psum formulation replicates on every chip (~10 GB at a 1024^2 FOV with
    m ~ 2.6k; this version needs ~1.3 GB + 4 MB x col_chunk on 8 chips and
    scales down with mesh size).
    """
    n_blocks, _, slots = panels.shape
    m = right.shape[1]
    n_dev = mesh.devices.size
    p_pad = ((n_pixels + n_dev - 1) // n_dev) * n_dev
    shard_rows = p_pad // n_dev
    k_bg = dense_basis.shape[1]
    bg_pad = dense_basis
    if p_pad != n_pixels:
        bg_pad = jnp.concatenate(
            [dense_basis, jnp.zeros((p_pad - n_pixels, k_bg), dense_basis.dtype)]
        )
    spans = [(c, min(c + col_chunk, m)) for c in range(0, m, col_chunk)]

    def local(panels_l, rows_l, bg_r, right_r):
        nb_l = panels_l.shape[0]
        axis_idx = jax.lax.axis_index(BLOCK_AXIS)
        col_start = axis_idx * (nb_l * slots)
        right_l = jax.lax.dynamic_slice(
            right_r, (col_start, 0), (nb_l * slots, m)
        ).reshape(nb_l, slots, m)
        right_bg = right_r[n_blocks * slots :]
        flat_rows = rows_l.reshape(-1)

        z_shard = jnp.zeros((shard_rows, m), dtype=jnp.float32)
        for c0, c1 in spans:
            contrib = _mm(panels_l, right_l[:, :, c0:c1])  # (nb_l, p, mc)
            zc = jnp.zeros((p_pad, c1 - c0), dtype=contrib.dtype)
            zc = zc.at[flat_rows].add(contrib.reshape(-1, c1 - c0))
            # combine overlap seams AND shard by pixels in one collective
            zc = jax.lax.psum_scatter(
                zc, BLOCK_AXIS, scatter_dimension=0, tiled=True
            )                                              # (shard_rows, mc)
            # background columns are replicated: add only THIS chip's pixel
            # rows (a pre-scatter add would be summed n_dev times)
            bg_shard = jax.lax.dynamic_slice(
                bg_r, (axis_idx * shard_rows, 0), (shard_rows, k_bg)
            )
            zc = zc + _mm(bg_shard, right_bg[:, c0:c1])
            z_shard = jax.lax.dynamic_update_slice(z_shard, zc, (0, c0))
        quad = jax.lax.psum(_mm(z_shard.T, z_shard), BLOCK_AXIS)
        return quad

    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    quad = f(panels, rows, bg_pad, right)
    return 0.5 * (quad + quad.T)
