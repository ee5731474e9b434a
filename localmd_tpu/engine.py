"""Batched per-block PMD decomposition engine.

This is the FLOP-dominant core. The reference runs one jit per (block,
window) from a serial Python loop (reference decomposition.py:790-838,
windowed_pmd at 410-525). Here the entire overlapping patch grid is processed
as a single batched program per window:

- ``single_block_md_batched``     — reference ``single_block_md``
  (decomposition.py:236-330) over a leading block axis.
- ``single_residual_block_md_batched`` — reference ``single_residual_block_md``
  (decomposition.py:334-387), with the already-extracted basis zero-padded to
  a fixed slot count so shapes stay static.
- ``pack_components``             — masked, compile-friendly replacement for
  the host-side boolean compaction (decomposition.py:501-515): kept
  components are routed into per-block accumulator slots with a one-hot
  assignment matmul (a scatter expressed as a matmul).
- ``windowed_pmd_batched``        — the incremental-basis temporal-window loop
  (decomposition.py:410-525) with all blocks advancing together.
- ``threshold_heuristic``         — the Monte-Carlo noise calibration
  (decomposition.py:102-189) as a few vmapped batches instead of 250 serial
  host iterations.

All pixel flattening is F-order via :mod:`localmd_tpu.ops.tiling` helpers.
"""

from __future__ import annotations

import threading
from functools import lru_cache as functools_lru_cache, partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from localmd_tpu.ops.linalg import (
    batched_truncated_random_svd,
    cholesky_qr2,
    svd_gram_left,
)
from localmd_tpu.ops.pooling import downsample_average_pooling
from localmd_tpu.ops.roughness import (
    evaluate_fitness,
    filter_by_failures,
    spatial_roughness_stat,
    temporal_roughness_stat,
)
from localmd_tpu.ops.tiling import flatten_fov, unflatten_fov
from localmd_tpu.utils.device import ambient_device


def _mm(a: Array, b: Array) -> Array:
    return jnp.matmul(a, b, preferred_element_type=jnp.float32)


def _bin_consecutive(x: Array, factor: int) -> Array:
    """Average consecutive groups of ``factor`` frames: (..., t) -> (..., t//factor).

    Matches the reference's F-order reshape + mean over the middle axis
    (decomposition.py:283-290): frame k lands in bin k // factor.
    """
    *lead, t = x.shape
    return jnp.mean(x.reshape(*lead, t // factor, factor), axis=-1)


def identity(x: Array) -> Array:
    return x


# ---------------------------------------------------------------------------
# Per-block kernels (batched over the leading block axis)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(2, 3, 4, 7, 8))
def single_block_md_batched(
    blocks: Array,
    keys: Array,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_threshold: Array | float,
    temporal_threshold: Array | float,
    spatial_denoiser: Callable = identity,
    temporal_denoiser: Callable = identity,
) -> Tuple[Array, Array, Array]:
    """First-window decomposition of every block at once.

    Args:
        blocks: (n, b1, b2, t) standardized patches; t divisible by
            temporal_avg_factor; max_rank + 10 <= t // temporal_avg_factor.
        keys: (n, 2) per-block PRNG keys for the rSVD sketches.
        spatial_denoiser / temporal_denoiser: same per-block signatures as the
            reference ((frames, b1, b2) -> same; (traces, t) -> same); applied
            via vmap over blocks.

    Returns:
        u: (n, b1*b2, max_rank) F-order-flattened orthonormal spatial bases.
        decisions: (n, max_rank) int32 raw fitness decisions.
        v: (n, max_rank, t) temporal components (singular values folded in).
    """
    n, b1, b2, t = blocks.shape

    down = downsample_average_pooling(blocks, spatial_avg_factor)
    down_flat = flatten_fov(down)                              # (n, p', t)
    down_avg = _bin_consecutive(down_flat, temporal_avg_factor)

    u_coarse = batched_truncated_random_svd(down_avg, keys, max_rank)[0]
    v_coarse = _mm(jnp.swapaxes(u_coarse, -1, -2), down_flat)  # (n, r, t)
    v_coarse = jax.vmap(temporal_denoiser)(v_coarse)
    # v_basis only needs to be SOME orthonormal basis of v_coarse's row space:
    # every step downstream of it (spatial projection -> orthonormalize ->
    # final canonical SVD) is invariant to a rotation of this basis, so the
    # cheaper CholeskyQR2 (two Gram matmuls + triangular solves) replaces
    # the Gram-SVD and its batched 30x30 eigh. The one exception:
    # a non-identity spatial_denoiser acts per-component on images defined BY
    # this basis, so reference SVD semantics are kept in that case.
    if spatial_denoiser is identity:
        v_basis = jnp.swapaxes(
            cholesky_qr2(jnp.swapaxes(v_coarse, -1, -2)), -1, -2
        )                                                      # (n, r, t) orthonormal rows
    else:
        v_basis = svd_gram_left(v_coarse)[2]                   # (n, r, t) orthonormal rows

    blocks_flat = flatten_fov(blocks)                          # (n, p, t)
    spatial_proj = _mm(blocks_flat, jnp.swapaxes(v_basis, -1, -2))  # (n, p, r)

    # Spatial denoiser operates on (r, b1, b2) component frames per block.
    proj_img = unflatten_fov(spatial_proj, b1, b2)             # (n, b1, b2, r)
    proj_img = jax.vmap(lambda im: spatial_denoiser(jnp.moveaxis(im, -1, 0)))(proj_img)
    spatial_proj = flatten_fov(jnp.moveaxis(proj_img, 1, -1))  # back to (n, p, r)

    # Same invariance argument: only span(u_final) matters until the final
    # SVD two lines below rotates it into canonical singular vectors, so an
    # orthonormalization replaces the second Gram-SVD unconditionally (no
    # per-component op sits between here and the final SVD).
    u_final = cholesky_qr2(spatial_proj)                       # (n, p, r) orthonormal
    v_new = _mm(jnp.swapaxes(u_final, -1, -2), blocks_flat)    # (n, r, t)
    v_left, v_sing, v_right = svd_gram_left(v_new)
    u_final = _mm(u_final, v_left)
    v_final = v_sing[..., :, None] * v_right                   # (n, r, t)

    u_img = unflatten_fov(u_final, b1, b2)                     # (n, b1, b2, r)
    decisions = evaluate_fitness(
        jnp.moveaxis(u_img, -1, 1), v_final, spatial_threshold, temporal_threshold
    )
    return u_final, decisions, v_final


@partial(jax.jit, static_argnums=(3, 4))
def single_residual_block_md_batched(
    blocks: Array,
    existing: Array,
    keys: Array,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_threshold: Array | float,
    temporal_threshold: Array | float,
) -> Tuple[Array, Array, Array]:
    """Extract further components orthogonal to each block's existing basis.

    ``existing``: (n, b1*b2, S) zero-padded accumulated bases — zero slots
    project out nothing, so no masking is needed.
    """
    n, b1, b2, t = blocks.shape
    blocks_flat = flatten_fov(blocks)
    coeff = _mm(jnp.swapaxes(existing, -1, -2), blocks_flat)   # (n, S, t)
    resid = blocks_flat - _mm(existing, coeff)

    resid_avg = _bin_consecutive(resid, temporal_avg_factor)
    u = batched_truncated_random_svd(resid_avg, keys, max_rank)[0]
    v = _mm(jnp.swapaxes(u, -1, -2), resid)

    u_img = unflatten_fov(u, b1, b2)
    decisions = evaluate_fitness(
        jnp.moveaxis(u_img, -1, 1), v, spatial_threshold, temporal_threshold
    )
    return u, decisions, v


@partial(jax.jit, static_argnums=(4,))
def pack_components(
    u_new: Array,
    decisions: Array,
    acc: Array,
    counts: Array,
    max_consecutive_failures: int,
) -> Tuple[Array, Array]:
    """Route kept components into per-block accumulator slots (masked).

    Applies the consecutive-failure filter, then writes each kept component of
    block b into slot ``counts[b] + (rank among kept)`` via a one-hot
    assignment matmul. Components overflowing the slot budget are dropped
    (reference ``remaining_components`` cap, decomposition.py:505-515).

    Args:
        u_new: (n, p, r) candidate components.
        decisions: (n, r) raw fitness decisions.
        acc: (n, p, S) accumulator (zero-padded).
        counts: (n,) current kept counts.

    Returns:
        (updated acc, updated counts).
    """
    acc, counts, _ = _pack_components_route(
        u_new, None, decisions, acc, counts, max_consecutive_failures
    )
    return acc, counts


def _pack_components_route(
    u_new: Array,
    v_new: Optional[Array],
    decisions: Array,
    acc: Array,
    counts: Array,
    max_consecutive_failures: int,
) -> Tuple[Array, Array, Optional[Array]]:
    """pack_components core; optionally routes temporal components through
    the SAME one-hot. With ``acc`` starting from zero, the routed temporal
    slots equal ``acc^T @ X`` exactly when ``v_new = u_new^T @ X`` — the
    algebraic shortcut that lets the single-window chunk step skip the
    whole-patch temporal-projector matmul (reference
    decomposition.py:390-407 semantics preserved up to the zero singular
    value rows, which project to exact zeros instead of f32 noise)."""
    slots = acc.shape[-1]
    keep = filter_by_failures(decisions > 0, max_consecutive_failures)
    target = counts[:, None] + jnp.cumsum(keep, axis=-1) - 1     # (n, r)
    valid = keep & (target < slots)
    onehot = (
        valid[..., None]
        & (target[..., None] == jnp.arange(slots)[None, None, :])
    ).astype(u_new.dtype)                                        # (n, r, S)
    acc = acc + _mm(u_new, onehot)
    counts = counts + jnp.sum(valid, axis=-1)
    v_fit = None
    if v_new is not None:
        v_fit = _mm(jnp.swapaxes(onehot, -1, -2), v_new)         # (n, S, t)
    return acc, counts, v_fit


@jax.jit
def temporal_projector_batched(spatial: Array, blocks_flat: Array) -> Array:
    """(n, p, S)^T @ (n, p, t) -> (n, S, t). Reference get_temporal_projector
    (decomposition.py:390-407) batched."""
    return _mm(jnp.swapaxes(spatial, -1, -2), blocks_flat)


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 10, 11, 12, 13))
def window0_chunk_step(
    data: Array,
    starts: Array,
    keys: Array,
    b1: int,
    b2: int,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_threshold: Array | float,
    temporal_threshold: Array | float,
    max_consecutive_failures: int,
    spatial_denoiser: Callable = identity,
    temporal_denoiser: Callable = identity,
    t_used: int = 0,
) -> Tuple[Array, Array, Array]:
    """Whole single-window block pipeline for one chunk of blocks as ONE
    compiled program: patch gather -> two-stage decomposition -> failure
    filter + masked packing -> temporal projection.

    Fusing the stage chain into one program keeps the dispatch count (and
    the number of distinct programs to compile) low.

    Args:
        data: (d1, d2, t) standardized, background-filtered init movie.
        starts: (n, 2) patch offsets for this chunk (padded to fixed n).
        keys: (n, 2) per-block PRNG keys.

    Returns:
        (acc (n, b1*b2, max_rank), counts (n,), v_fit (n, max_rank, t)).
    """
    from localmd_tpu.ops.tiling import extract_patches

    patches = extract_patches(data, starts, b1, b2)
    if t_used and t_used < patches.shape[-1]:
        # temporal-average crop applied per patch so the caller never has to
        # materialize a cropped copy of the whole init movie
        patches = patches[..., :t_used]
    u, decisions, v = single_block_md_batched(
        patches, keys, max_rank, temporal_avg_factor, spatial_avg_factor,
        spatial_threshold, temporal_threshold, spatial_denoiser, temporal_denoiser,
    )
    n = patches.shape[0]
    acc = jnp.zeros((n, b1 * b2, max_rank), dtype=patches.dtype)
    counts = jnp.zeros((n,), dtype=jnp.int32)
    # v == u^T @ patches_flat row-for-row (s folded into vt; zero-s rows
    # are exact zeros), so routing it through the packing one-hot IS the
    # temporal projector acc^T @ X — without re-reading the patch tensor.
    acc, counts, v_fit = _pack_components_route(
        u, v, decisions, acc, counts, max_consecutive_failures
    )
    return acc, counts, v_fit


@partial(jax.jit, static_argnums=(4, 5, 6, 9, 10, 11))
def _md_pack_step(
    window: Array,
    keys: Array,
    acc: Array,
    counts: Array,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_threshold: Array | float,
    temporal_threshold: Array | float,
    max_consecutive_failures: int,
    spatial_denoiser: Callable = identity,
    temporal_denoiser: Callable = identity,
) -> Tuple[Array, Array]:
    """Window-0 decomposition + failure filter + packing as ONE program."""
    u, decisions, _ = single_block_md_batched(
        window, keys, max_rank, temporal_avg_factor, spatial_avg_factor,
        spatial_threshold, temporal_threshold, spatial_denoiser, temporal_denoiser,
    )
    return pack_components(u, decisions, acc, counts, max_consecutive_failures)


# ---------------------------------------------------------------------------
# Windowed decomposition driver
# ---------------------------------------------------------------------------

def _fallback_rerun(
    window: Array,
    keys: Array,
    u_r: Array,
    dec_r: Array,
    is_zero: Array,
    n_zero: Array,
    fallback_cap: int,
    *,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_threshold,
    temporal_threshold,
    spatial_denoiser: Callable,
    temporal_denoiser: Callable,
) -> Tuple[Array, Array]:
    """Re-run the FULL two-stage kernel for zero-count blocks only
    (reference decomposition.py:476-488), replacing their residual-kernel
    results.

    Three tiers selected on device: no zero blocks -> no-op; up to
    ``fallback_cap`` zeros -> gather the zero blocks to a compacted
    fixed-size subset, run the full kernel there, scatter back (one
    straggler costs a cap-sized kernel, not a whole-batch one); more zeros
    than the capacity -> all-blocks kernel with per-block selection.
    """
    n = window.shape[0]

    def _no_fallback(args):
        return args

    def _gathered_fallback(args):
        u_prev, dec_prev = args
        # stable sort: zero-count blocks first, in index order
        order = jnp.argsort(jnp.logical_not(is_zero))
        idx = order[:fallback_cap]
        u_f, dec_f, _ = single_block_md_batched(
            window[idx], keys[idx], max_rank, temporal_avg_factor,
            spatial_avg_factor, spatial_threshold, temporal_threshold,
            spatial_denoiser, temporal_denoiser,
        )
        sel = is_zero[idx]
        u_new = u_prev.at[idx].set(jnp.where(sel[:, None, None], u_f, u_prev[idx]))
        dec_new = dec_prev.at[idx].set(jnp.where(sel[:, None], dec_f, dec_prev[idx]))
        return u_new, dec_new

    def _full_fallback(args):
        u_prev, dec_prev = args
        u_f, dec_f, _ = single_block_md_batched(
            window, keys, max_rank, temporal_avg_factor, spatial_avg_factor,
            spatial_threshold, temporal_threshold,
            spatial_denoiser, temporal_denoiser,
        )
        return (
            jnp.where(is_zero[:, None, None], u_f, u_prev),
            jnp.where(is_zero[:, None], dec_f, dec_prev),
        )

    if fallback_cap >= n:
        return jax.lax.cond(n_zero > 0, _full_fallback, _no_fallback, (u_r, dec_r))
    branch = jnp.where(n_zero == 0, 0, jnp.where(n_zero <= fallback_cap, 1, 2))
    return jax.lax.switch(
        branch, [_no_fallback, _gathered_fallback, _full_fallback], (u_r, dec_r)
    )


class WindowedPMDResult(NamedTuple):
    spatial: Array    # (n, p, max_rank) zero-padded accumulated bases
    counts: Array     # (n,) kept components per block
    temporal: Array   # (n, max_rank, t) projection of full block onto basis


def _windowed_loop_impl(
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
    spatial_denoiser: Callable,
    temporal_denoiser: Callable,
    axis_name: Optional[str],
) -> Tuple[Array, Array, Array]:
    """The full windowed decomposition as ONE traced program.

    Window 0 runs the two-stage kernel; subsequent windows run inside a
    ``lax.while_loop`` whose condition is the device-side "every block full"
    check (the round-1 implementation pulled ``counts`` to host every window —
    one blocking device->host sync per window). Blocks still holding zero components
    re-run the full kernel (reference decomposition.py:476-488) on a
    COMPACTED fixed-capacity subset (gather zero-count blocks -> full kernel
    -> scatter back), so one straggler block costs a ``n/8``-block kernel
    per window, not a whole-batch one; more stragglers than the capacity
    fall through to the all-blocks branch.

    With ``axis_name`` (shard_map over the block axis), the early-stop and
    zero-count predicates are ``pmin``'d across shards so every device takes
    the same branch; everything else is pure block data parallelism.
    """
    n, b1, b2, t = patches.shape
    p = b1 * b2
    acc = jnp.zeros((n, p, max_rank), dtype=patches.dtype)
    counts = jnp.zeros((n,), dtype=jnp.int32)

    win0 = jax.lax.dynamic_slice_in_dim(patches, 0, window_length, axis=3)
    acc, counts = _md_pack_step(
        win0, keys_all[0], acc, counts, max_rank, temporal_avg_factor,
        spatial_avg_factor, spatial_threshold, temporal_threshold,
        max_consecutive_failures, spatial_denoiser, temporal_denoiser,
    )

    def _global_min(c):
        m = jnp.min(c)
        if axis_name is not None:
            m = jax.lax.pmin(m, axis_name)
        return m

    def cond_fn(state):
        w, _acc, counts = state
        return (w < n_windows) & (_global_min(counts) < max_rank)

    # Static capacity of the gathered fallback tier: blocks still holding
    # zero components re-run the FULL two-stage kernel (reference
    # decomposition.py:476-488), but on a compacted subset of this size —
    # one straggler block must not re-pay the full kernel for the whole
    # batch on every subsequent window. NOTE the failure filter keeps every
    # block's first component even when it fails the fitness test
    # (reference evaluation.py:210-218), so counts >= 1 after window 0 and
    # this fallback is a reference-parity safety net, not a hot path.
    fallback_cap = max(1, n // 8)

    def body_fn(state):
        w, acc, counts = state
        start = jnp.minimum(w * window_length, t - window_length)  # tail snap
        window = jax.lax.dynamic_slice_in_dim(patches, start, window_length, axis=3)
        keys = keys_all[w]
        u, dec, _ = single_residual_block_md_batched(
            window, acc, keys, max_rank, temporal_avg_factor,
            spatial_threshold, temporal_threshold,
        )
        is_zero = counts == 0
        n_zero = jnp.sum(is_zero.astype(jnp.int32))
        if axis_name is not None:
            # all shards must take the SAME branch; size for the worst shard
            n_zero = jax.lax.pmax(n_zero, axis_name)
        u, dec = _fallback_rerun(
            window, keys, u, dec, is_zero, n_zero, fallback_cap,
            max_rank=max_rank, temporal_avg_factor=temporal_avg_factor,
            spatial_avg_factor=spatial_avg_factor,
            spatial_threshold=spatial_threshold,
            temporal_threshold=temporal_threshold,
            spatial_denoiser=spatial_denoiser,
            temporal_denoiser=temporal_denoiser,
        )
        acc, counts = pack_components(
            u, dec, acc, counts, max_consecutive_failures
        )
        return (w + 1, acc, counts)

    if n_windows > 1:
        _, acc, counts = jax.lax.while_loop(
            cond_fn, body_fn, (jnp.int32(1), acc, counts)
        )
    temporal = temporal_projector_batched(acc, flatten_fov(patches))
    return acc, counts, temporal


@functools_lru_cache(maxsize=None)
def _windowed_loop_jit(
    n_windows: int,
    window_length: int,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    max_consecutive_failures: int,
    spatial_denoiser: Callable,
    temporal_denoiser: Callable,
):
    return jax.jit(
        partial(
            _windowed_loop_impl,
            n_windows=n_windows,
            window_length=window_length,
            max_rank=max_rank,
            temporal_avg_factor=temporal_avg_factor,
            spatial_avg_factor=spatial_avg_factor,
            max_consecutive_failures=max_consecutive_failures,
            spatial_denoiser=spatial_denoiser,
            temporal_denoiser=temporal_denoiser,
            axis_name=None,
        )
    )


def effective_window_length(window_length: int, t: int, temporal_avg_factor: int) -> int:
    """The window length actually used by the windowed loop: clamped to the
    movie and rounded down to a multiple of the binning factor
    (_bin_consecutive reshapes (t // f, f); an indivisible window would
    error deep in jit)."""
    window_length = min(window_length, t)
    return max(
        temporal_avg_factor,
        (window_length // temporal_avg_factor) * temporal_avg_factor,
    )


def window_keys(key: Array, n_windows: int, n_blocks: int) -> Array:
    """(n_windows, n_blocks, 2) per-(window, block) PRNG keys, split in the
    same sequence the round-1 host loop used (window w's sub-key is the w-th
    sequential split), so results are reproducible across implementations."""
    keys = []
    for _ in range(n_windows):
        key, sub = jax.random.split(key)
        keys.append(jax.random.split(sub, n_blocks))
    return jnp.stack(keys, axis=0)


def windowed_pmd_batched(
    blocks: Array,
    key: Array,
    window_length: int,
    max_rank: int,
    spatial_threshold: float,
    temporal_threshold: float,
    max_consecutive_failures: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_denoiser: Callable = identity,
    temporal_denoiser: Callable = identity,
    mesh=None,
) -> WindowedPMDResult:
    """Windowed blockwise PMD over ALL blocks simultaneously.

    Reference semantics (decomposition.py:410-525): split the T frames into
    windows of ``window_length`` (tail window snapped flush to the end); the
    first window — or any block still holding zero components — runs the full
    two-stage decomposition; later windows extract residual components against
    the accumulated basis; stop early once every block is full.

    The whole loop is one compiled program (see ``_windowed_loop_impl``).
    With ``mesh`` (1-D jax.sharding.Mesh), the block axis is shard_map'd over
    the mesh; ``n`` must be divisible by the mesh size.
    """
    n, b1, b2, t = blocks.shape
    window_length = effective_window_length(window_length, t, temporal_avg_factor)
    n_windows = len(range(0, t, window_length))
    # ``key`` is either a single PRNG key (split per (window, block) here) or
    # precomputed (n_windows, n, 2) keys — the pipeline pre-splits one key
    # per (window, block) over the GLOBAL block grid so results don't depend
    # on how blocks were chunked into batches (seeded reproducibility).
    keys_all = key if key.ndim == 3 else window_keys(key, n_windows, n)
    if keys_all.shape[:2] != (n_windows, n):
        raise ValueError(
            f"precomputed keys shape {keys_all.shape[:2]} != {(n_windows, n)}"
        )
    sthr = jnp.asarray(spatial_threshold, jnp.float32)
    tthr = jnp.asarray(temporal_threshold, jnp.float32)

    if mesh is not None:
        from localmd_tpu.parallel.sharded import sharded_windowed_pmd

        acc, counts, temporal = sharded_windowed_pmd(
            mesh, blocks, keys_all, sthr, tthr,
            n_windows=n_windows, window_length=window_length,
            max_rank=max_rank, temporal_avg_factor=temporal_avg_factor,
            spatial_avg_factor=spatial_avg_factor,
            max_consecutive_failures=max_consecutive_failures,
            spatial_denoiser=spatial_denoiser,
            temporal_denoiser=temporal_denoiser,
        )
    else:
        fn = _windowed_loop_jit(
            n_windows, window_length, max_rank, temporal_avg_factor,
            spatial_avg_factor, max_consecutive_failures,
            spatial_denoiser, temporal_denoiser,
        )
        acc, counts, temporal = fn(blocks, keys_all, sthr, tthr)
    return WindowedPMDResult(spatial=acc, counts=counts, temporal=temporal)


# ---------------------------------------------------------------------------
# Threshold calibration (Monte-Carlo on pure noise)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _rank_simulation_batch(
    keys: Array, d1: int, d2: int, t: int, num_comps: int
) -> Tuple[Array, Array]:
    """Roughness stats of a rank-``num_comps`` rSVD of iid N(0,1) blocks.

    Reference ``rank_simulation`` + ``decomposition_no_normalize_approx``
    (decomposition.py:76-131), vmapped over simulation draws.
    """

    def _one(key):
        k_noise, k_svd = jax.random.split(key)
        noise = jax.random.normal(k_noise, (d1, d2, t))
        flat = flatten_fov(noise)
        u, s, vt = batched_truncated_random_svd(
            flat[None], k_svd[None], num_comps
        )
        u, s, vt = u[0], s[0], vt[0]
        v = s[:, None] * vt
        u_img = unflatten_fov(u, d1, d2)
        sp = spatial_roughness_stat(jnp.moveaxis(u_img, -1, 0))
        tp = temporal_roughness_stat(v)
        return sp, tp

    return jax.vmap(_one)(keys)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7))
def _threshold_kernel(
    key: Array,
    d1: int,
    d2: int,
    t: int,
    num_comps: int,
    n_batches: int,
    sim_batch: int,
    iters: int = 0,
    percentile: Array | float = 5.0,
) -> Tuple[Array, Array]:
    """All Monte-Carlo batches + the percentile reduction as ONE program
    (memory bounded by ``sim_batch`` noise blocks at a time via lax.map).

    Batches are whole ``sim_batch``-sized (one compiled shape), but the
    percentile is taken over exactly the first ``iters`` draws — matching
    the reference's exact iteration count (decomposition.py:176-181)."""
    batch_keys = jax.random.split(key, n_batches * sim_batch).reshape(
        n_batches, sim_batch, 2
    )

    def one_batch(ks):
        return _rank_simulation_batch(ks, d1, d2, t, num_comps)

    sp, tp = jax.lax.map(one_batch, batch_keys)
    n_used = iters if iters else n_batches * sim_batch
    return (
        jnp.percentile(sp.ravel()[:n_used], percentile),
        jnp.percentile(tp.ravel()[:n_used], percentile),
    )


# Memoizes (device-scalar) thresholds per exact argument set, including the
# PRNG key VALUE: the Monte-Carlo is a pure function of its inputs, so a
# seeded rerun (warm bench pass, notebook re-execution, resumed experiment)
# need not re-pay ~0.15 s of simulated rSVDs. A random key (key=None without
# a seeded make_key) never hits the cache.
_threshold_cache: dict = {}
_THRESHOLD_CACHE_MAX = 64
# Mutations are locked: plane-parallel volumetric runs call
# threshold_heuristic from several threads (reads stay lock-free — a miss
# just recomputes).
_threshold_cache_lock = threading.Lock()


def threshold_heuristic(
    dimensions: Tuple[int, int, int],
    num_comps: int = 1,
    iters: int = 250,
    percentile_threshold: float = 5.0,
    key: Optional[Array] = None,
    sim_batch: int = 32,
    as_device: bool = False,
    cache_token=None,
) -> Tuple[float, float]:
    """Spatial/temporal roughness cutoffs from a noise-null Monte-Carlo.

    Simulates in whole ``sim_batch``-sized batches (one program shape) but
    takes the percentile over exactly ``iters`` draws, matching the
    reference's iteration count; everything runs in a single compiled
    program — the reference runs 250 serial host iterations with
    per-iteration key transfers (decomposition.py:171-189).

    With ``as_device`` the thresholds are returned as device scalars: the
    downstream block kernels take them as traced arguments, so the pipeline
    never blocks on a device->host round trip between the simulation and the
    block stage.
    """
    if key is None:
        from localmd_tpu.utils import make_key

        key = make_key()
    d1, d2, t = dimensions
    n_batches = max(1, -(-iters // sim_batch))
    # The key's identity in the cache: a host-side ``cache_token`` when the
    # caller knows one (the pipeline derives its key deterministically from
    # an integer seed — pulling the 8-byte key value would cost a full
    # device->host round trip on the critical path), else the key bytes.
    # The ambient matmul precision is part of the cache key: the simulated
    # rSVD results genuinely differ between default (bf16/TF32-class
    # products on accelerators) and "highest" precision, and a stale
    # cross-precision hit would silently
    # break the seeded-determinism contract.
    try:
        precision_token = str(jax.config.jax_default_matmul_precision)
    except AttributeError:  # config name drift across jax versions
        precision_token = ""
    key_token = (
        ("token", cache_token)
        if cache_token is not None
        else np.asarray(key).tobytes()
    )
    # The ambient default device is part of the key too: plane-parallel
    # volumetric runs pin each plane to its own device, and a cached
    # device-scalar threshold committed to chip A cannot feed chip B's
    # block programs.
    device_token = str(ambient_device())
    cache_key = (
        d1, d2, t, num_comps, n_batches, sim_batch, iters,
        float(percentile_threshold), key_token,
        precision_token, jax.default_backend(), device_token,
    )
    cached = _threshold_cache.get(cache_key)
    if cached is not None:
        s_thr, t_thr = cached
    else:
        s_thr, t_thr = _threshold_kernel(
            key, d1, d2, t, num_comps, n_batches, sim_batch, iters,
            percentile_threshold,
        )
        with _threshold_cache_lock:
            if len(_threshold_cache) >= _THRESHOLD_CACHE_MAX:
                _threshold_cache.pop(next(iter(_threshold_cache)), None)
            _threshold_cache[cache_key] = (s_thr, t_thr)
    if as_device:
        return s_thr, t_thr
    return float(s_thr), float(t_thr)
