"""FOV tiling: overlapping block grid, pyramid blend weights, patch gather /
overlap-add scatter, and explicit F/C-order flattening helpers.

Design vs the reference's host-side tiling
(reference decomposition.py:695-853):

- The block grid (50% overlap + tail blocks) is computed once on the host as
  static metadata (`BlockGrid`); everything derived from it — patch start
  offsets, global pixel row ids per block — is a static array baked into the
  compiled program.
- Patch extraction is a vmapped ``dynamic_slice`` producing the whole
  ``(n_blocks, b1, b2, T)`` batch in one program (the reference slices numpy
  per block in a Python loop, decomposition.py:793-796).
- Overlap-add of per-block images is a single XLA scatter-add over
  precomputed row ids (the reference round-trips through Python lists and
  scipy COO, decomposition.py:818-843).
- The entire factorization is F-order flattened (pixel id = i + j*d1,
  reference decomposition.py:88 etc.); JAX is C-order, so F-order semantics
  are encoded here ONCE as explicit transposes (SURVEY.md hard-parts note).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array


def _default_device_token():
    """Hashable identity of the ambient jax default device (None when unset).

    Used to key per-device caches of uploaded grid constants: volumetric
    plane-parallel runs place each plane's pipeline on its own device via
    ``jax.default_device``, and buffers committed to one device cannot feed
    programs placed on another.
    """
    from localmd_tpu.utils.device import ambient_device

    return ambient_device()


# ---------------------------------------------------------------------------
# F-order flatten helpers (single source of truth for pixel ordering)
# ---------------------------------------------------------------------------

def flatten_fov(x: Array, order: str = "F") -> Array:
    """Flatten (..., d1, d2, T) -> (..., d1*d2, T) with the given pixel order.

    F-order pixel id = i + j*d1 (column-major over the FOV), matching the
    reference factorization layout.
    """
    *batch, d1, d2, t = x.shape
    if order == "F":
        x = jnp.swapaxes(x, -3, -2)  # (..., d2, d1, T)
    return x.reshape(*batch, d1 * d2, t)


def unflatten_fov(x: Array, d1: int, d2: int, order: str = "F") -> Array:
    """Inverse of :func:`flatten_fov`: (..., d1*d2, T) -> (..., d1, d2, T)."""
    *batch, _, t = x.shape
    if order == "F":
        x = x.reshape(*batch, d2, d1, t)
        return jnp.swapaxes(x, -3, -2)
    return x.reshape(*batch, d1, d2, t)


def flatten_image(x: Array, order: str = "F") -> Array:
    """Flatten (..., d1, d2) -> (..., d1*d2) with the given pixel order."""
    *batch, d1, d2 = x.shape
    if order == "F":
        x = jnp.swapaxes(x, -2, -1)
    return x.reshape(*batch, d1 * d2)


def unflatten_image(x: Array, d1: int, d2: int, order: str = "F") -> Array:
    *batch, _ = x.shape
    if order == "F":
        x = x.reshape(*batch, d2, d1)
        return jnp.swapaxes(x, -2, -1)
    return x.reshape(*batch, d1, d2)


# ---------------------------------------------------------------------------
# Grid construction
# ---------------------------------------------------------------------------

def _dim_starts(extent: int, block: int, overlap: int) -> List[int]:
    """Start offsets along one dim: stride (block - overlap) plus a tail block
    flush with the edge (reference decomposition.py:723-739)."""
    starts = list(range(0, extent - block + 1, block - overlap))
    if starts[-1] != extent - block and extent - block != 0:
        starts.append(extent - block)
    return starts


def update_block_sizes(
    blocks: Tuple[int, int], fov_shape: Tuple[int, int], min_block_value: int = 10
) -> List[int]:
    """Clamp user block sizes to the FOV (reference decomposition.py:572-613)."""
    if blocks[0] < min_block_value or blocks[1] < min_block_value:
        raise ValueError(
            f"Block dimensions must be at least {min_block_value}, got {blocks}"
        )
    return [min(blocks[0], fov_shape[0]), min(blocks[1], fov_shape[1])]


def check_fov_size(fov_dims: Tuple[int, int], min_allowed_value: int = 10) -> None:
    """Reference decomposition.py:616-634."""
    for k in fov_dims:
        if k < min_allowed_value:
            raise ValueError(
                f"FOV dimension {k} is below the minimum of {min_allowed_value}"
            )


def pyramid_weights(b1: int, b2: int, dtype=np.float32) -> np.ndarray:
    """Center-weighted blending pyramid for overlap-add.

    Closed form of the reference's quadrant-mirrored construction
    (reference decomposition.py:742-750): w[i, j] = 1 + min(i, b1-1-i, j,
    b2-1-j). Identical for even block sizes; additionally well-defined for odd
    sizes (where the reference's flipud mirror would shape-error).
    """
    i = np.arange(b1)[:, None]
    j = np.arange(b2)[None, :]
    ramp = np.minimum(
        np.minimum(i, b1 - 1 - i), np.minimum(j, b2 - 1 - j)
    )
    return (1.0 + ramp).astype(dtype)


@dataclass(frozen=True)
class BlockGrid:
    """Static description of the overlapping patch tiling of one FOV."""

    d1: int
    d2: int
    block_sizes: Tuple[int, int]
    order: str = "F"
    starts: np.ndarray = field(init=False)        # (n_blocks, 2) int32
    rows: np.ndarray = field(init=False)          # (n_blocks, b1*b2) int32 global pixel ids
    weights: np.ndarray = field(init=False)       # (b1, b2) pyramid weights
    cumulative_weights: np.ndarray = field(init=False)  # (d1, d2) summed weights

    def __post_init__(self):
        b1, b2 = self.block_sizes
        overlap = (int(np.ceil(b1 / 2)), int(np.ceil(b2 / 2)))
        s1 = _dim_starts(self.d1, b1, overlap[0])
        s2 = _dim_starts(self.d2, b2, overlap[1])
        starts = np.array([(k, j) for k in s1 for j in s2], dtype=np.int32)
        object.__setattr__(self, "starts", starts)

        # Global pixel row ids per block. The GLOBAL id follows `order`
        # (reference sparse_indices grid, decomposition.py:752); the flatten
        # WITHIN the block is always F — that is the engine's internal panel
        # row layout (engine.py flatten_fov), and only the panel-row <->
        # global-id pairing matters downstream.
        # One broadcasted op over (n_blocks, b1*b2): panel row m holds local
        # pixel (i, j) = (m % b1, m // b1) (the within-block F-order flatten).
        # The per-block Python loop this replaces cost >1 s of host time per
        # pipeline run at 512x512 / 32x32 (961 blocks).
        m = np.arange(b1 * b2, dtype=np.int64)
        i_loc = m % b1
        j_loc = m // b1
        gi = starts[:, 0:1].astype(np.int64) + i_loc[None, :]
        gj = starts[:, 1:2].astype(np.int64) + j_loc[None, :]
        rows = gi + gj * self.d1 if self.order == "F" else gi * self.d2 + gj
        object.__setattr__(self, "rows", rows.astype(np.int32))

        w = pyramid_weights(b1, b2)
        object.__setattr__(self, "weights", w)
        cum = np.zeros((self.d1, self.d2), dtype=np.float64)
        for (k, j) in starts:
            cum[k : k + b1, j : j + b2] += w
        object.__setattr__(self, "cumulative_weights", cum.astype(np.float32))

    @property
    def n_blocks(self) -> int:
        return len(self.starts)

    @property
    def pixels_per_block(self) -> int:
        return self.block_sizes[0] * self.block_sizes[1]

    def device_constants(self):
        """Device copies of the per-run constant arrays, uploaded once and
        cached on the instance: (weights_flat (p,), cum_flat (d,), rows (N,p),
        starts (N,2)). ``weights_flat`` flattens the PANEL row layout (always
        F within a block); ``cum_flat`` follows the grid's global ``order``.
        Combined with :func:`block_grid` memoization, repeated runs of the
        same configuration skip both grid construction and these host->device
        transfers.

        Cached PER default device: plane-parallel volumetric runs place each
        plane's pipeline on its own chip via ``jax.default_device``, and a
        buffer committed to chip A cannot feed a program placed on chip B.
        """
        cache = getattr(self, "_device_constants", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_device_constants", cache)
        tok = _default_device_token()
        cached = cache.get(tok)
        if cached is None:
            w = jnp.asarray(flatten_image(jnp.asarray(self.weights), "F"))
            c = jnp.asarray(
                flatten_image(jnp.asarray(self.cumulative_weights), self.order)
            )
            r = jnp.asarray(self.rows)
            s = jnp.asarray(self.starts)
            cached = (w, c, r, s)
            cache[tok] = cached
        return cached

    def cell_geometry(self):
        """``(n1, n2, h1, h2)`` when the grid is *regular*: even blocks,
        exact half-overlap stride, no snapped tail start. Every pairwise
        block overlap is then a whole number of ``(h1, h2)`` cells and the
        grid supports the banded-Gram / cell-dot fast paths
        (:mod:`localmd_tpu.blocksparse`). ``None`` otherwise. Host-side
        metadata only (no device sync); cached on the instance."""
        cached = getattr(self, "_cell_geometry", None)
        if cached is not None:
            return None if cached == "none" else cached
        b1, b2 = self.block_sizes
        geom = None
        if b1 % 2 == 0 and b2 % 2 == 0:
            h1, h2 = b1 // 2, b2 // 2
            s1 = sorted({int(s) for s in self.starts[:, 0]})
            s2 = sorted({int(s) for s in self.starts[:, 1]})
            n1, n2 = len(s1), len(s2)
            if (
                len(self.starts) == n1 * n2
                and s1 == [i * h1 for i in range(n1)]
                and s2 == [j * h2 for j in range(n2)]
                and (n1 - 1) * h1 + b1 == self.d1
                and (n2 - 1) * h2 + b2 == self.d2
            ):
                geom = (n1, n2, h1, h2)
        object.__setattr__(
            self, "_cell_geometry", geom if geom is not None else "none"
        )
        return geom

    def cosets(self):
        """Partition the block grid into disjoint 'cosets' for a gather- and
        scatter-free overlap-add (see ``blocksparse._coset_matmul``).

        Along one dim, starts advance by ``stride = floor(b/2)``; taking every
        ``k_c = ceil(b/stride)``-th start (k_c=2 for even b, 3 for odd) gives a
        UNIFORM sub-grid whose blocks are pairwise disjoint, and the snapped
        tail start (spacing irregular) forms its own singleton group. The 2-D
        cosets are the cross products (<= (k_c+1)^2 of them); within a coset,
        placing block windows into the FOV is a pure pad + transpose + reshape
        — XLA's scatter-add serializes overlapping row updates, while the
        coset form moves only whole sequential tiles.

        Returns a cached tuple of ``(block_ids (nc1*nc2,) np.int32,
        (nc1, nc2, st1, st2, a1, a2))`` — counts, within-coset strides and
        origin offsets per FOV dim.
        """
        cached = getattr(self, "_cosets", None)
        if cached is not None:
            return cached
        b1, b2 = self.block_sizes

        def dim_groups(extent, b):
            o = int(np.ceil(b / 2))
            s = _dim_starts(extent, b, o)
            stride = b - o
            # regular prefix = arithmetic progression; the snapped tail (if
            # appended) breaks the spacing and becomes a singleton group
            n_reg = len(s)
            if len(s) >= 2 and s[-1] - s[-2] != stride:
                n_reg -= 1
            k_c = 1 if stride <= 0 else -(-b // stride)
            groups = []
            for r in range(min(k_c, n_reg)):
                idx = list(range(r, n_reg, k_c))
                st = max(stride * k_c, b)
                groups.append((idx, s[idx[0]], st, len(idx)))
            if n_reg != len(s):
                groups.append(([len(s) - 1], s[-1], b, 1))
            return groups, len(s)

        g1, _ = dim_groups(self.d1, b1)
        g2, n2 = dim_groups(self.d2, b2)
        out = []
        for idx1, a1, st1, nc1 in g1:
            for idx2, a2, st2, nc2 in g2:
                ids = np.array(
                    [i1 * n2 + i2 for i1 in idx1 for i2 in idx2], np.int32
                )
                out.append((ids, (nc1, nc2, st1, st2, a1, a2)))
        cached = tuple(out)
        object.__setattr__(self, "_cosets", cached)
        return cached

    def coset_info(self):
        """Device-uploaded coset metadata for ``BlockSparseMatrix.matmul`` /
        ``rmatmul``: ``(block-id arrays (device), static metas, d1, d2,
        order, inv)`` where ``inv`` maps block id -> row in the
        coset-order concatenation (``concat(ids)[inv] == arange``, used to
        un-permute rmatmul panel results). Uploaded once per grid and
        cached per default device (like :meth:`device_constants`)."""
        cache = getattr(self, "_coset_info", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_coset_info", cache)
        tok = _default_device_token()
        cached = cache.get(tok)
        if cached is None:
            cs = self.cosets()
            concat_ids = np.concatenate([ids for ids, _ in cs])
            inv = np.empty_like(concat_ids)
            inv[concat_ids] = np.arange(len(concat_ids), dtype=concat_ids.dtype)
            cached = (
                tuple(jnp.asarray(ids) for ids, _ in cs),
                tuple(meta for _, meta in cs),
                self.d1,
                self.d2,
                self.order,
                jnp.asarray(inv),
            )
            cache[tok] = cached
        return cached


@lru_cache(maxsize=8)
def block_grid(d1: int, d2: int, block_sizes: Tuple[int, int], order: str = "F") -> BlockGrid:
    """Memoized :class:`BlockGrid` constructor — the grid is pure static
    metadata, so repeated pipeline runs of one configuration reuse it.

    Memoized grids also hold device buffers once :meth:`device_constants` /
    :meth:`coset_info` run (row map + pyramid weights: ~20 MB of HBM at a
    1024^2/40x40 grid), so the cache is small (8 configs) and evictable:
    call :func:`clear_block_grid_cache` to release the HBM when sweeping
    many FOV/block configurations in one process."""
    return BlockGrid(d1, d2, block_sizes, order)


def clear_block_grid_cache() -> None:
    """Drop all memoized grids (and with them their cached device constants
    and coset metadata, freeing the pinned HBM). Safe at any time: in-flight
    pipelines keep their own references alive."""
    block_grid.cache_clear()


# ---------------------------------------------------------------------------
# Patch gather / overlap-add scatter (device ops)
# ---------------------------------------------------------------------------

def extract_patches(data: Array, starts: Array, b1: int, b2: int) -> Array:
    """Gather overlapping patches: data (d1, d2, T) + starts (n, 2)
    -> (n, b1, b2, T).

    Implemented as ONE pixel-row gather over the C-order-flattened FOV:
    XLA lowers a vmapped 3-D ``dynamic_slice`` to a general gather, while a
    flat row-take moves the same bytes as full-row copies (not measured on
    the H100).
    """
    d1, d2, t = data.shape
    n = starts.shape[0]
    rows = (starts[:, 0:1, None] + jnp.arange(b1)[None, :, None]) * d2 + (
        starts[:, 1:2, None] + jnp.arange(b2)[None, None, :]
    )
    flat = data.reshape(d1 * d2, t)
    return jnp.take(flat, rows.reshape(-1), axis=0).reshape(n, b1, b2, t)


def overlap_add(
    panels: Array, rows: Array, n_pixels: int
) -> Array:
    """Scatter-add per-block panels into a global pixel-indexed array.

    panels: (n_blocks, p, k); rows: (n_blocks, p) global pixel ids.
    Returns (n_pixels, k) with overlapping contributions summed.
    """
    k = panels.shape[-1]
    flat_vals = panels.reshape(-1, k)
    flat_rows = rows.reshape(-1)
    out = jnp.zeros((n_pixels, k), dtype=panels.dtype)
    return out.at[flat_rows].add(flat_vals)
