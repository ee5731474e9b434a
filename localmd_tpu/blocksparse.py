"""Device-side blocked-sparse spatial matrix ``U``.

The reference assembles its global spatial basis as a scipy COO matrix built
from Python lists (reference decomposition.py:818-843) and then does sparse
CPU matmuls (``u.T.dot(u)``, BCOO products) for the factorized SVD and the
streaming temporal regression (reference decomposition.py:974-981,
pmd_loader.py:327). Here we exploit the *known* block structure instead:

``U`` is stored as dense per-block panels ``(n_blocks, p, S)`` (p = pixels
per block, S = component slots, zero-padded past each block's kept rank)
plus a static row-id map ``(n_blocks, p)``, and an extra dense column block
for the global low-rank background basis. Every product we need is then a
batched dense matmul plus one gather or scatter-add:

- ``U @ X``   : gather X rows per block -> batched matmul -> scatter-add.
- ``U.T @ Y`` : gather Y rows per block -> batched (S,p)x(p,m) matmul.
- ``right.T (U.T U) right`` : composition of the two, column-chunked, never
  materializing the (R, R) Gram matrix.

Zero-padded slots are exact zero columns: they contribute nothing to any
product and surface as zero eigenvalues that the factorized-SVD stage drops,
exactly like the reference's ``eig_vals > 0`` cut
(reference decomposition.py:988-990). Columns are compacted only at scipy-CSR
export time (serialization parity with the reference .npz convention).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

import scipy.sparse

from localmd_tpu.capabilities import resolve


def _mm(a: Array, b: Array) -> Array:
    return jnp.matmul(a, b, preferred_element_type=jnp.float32)


# Budget for the (blocks, p, m) batched-matmul intermediate; the block axis
# is chunked so this is never exceeded (a 1024^2 FOV with 2.6k blocks and a
# 1k-frame right-hand side would otherwise materialize ~17 GB). Scaled to
# the device: HBM/16 with a 1 GiB floor (utils.device.transient_budget_bytes)
# — a fixed 1 GiB would leave dispatch count on the table on 95 GB chips.


# test/debug override: a number here pins the budget (None = device-scaled)
_INTERMEDIATE_BUDGET_BYTES = None


def _intermediate_budget() -> int:
    if _INTERMEDIATE_BUDGET_BYTES is not None:
        return _INTERMEDIATE_BUDGET_BYTES
    from localmd_tpu.utils import transient_budget_bytes

    return transient_budget_bytes()


def _block_group_size(p: int, m: int) -> int:
    return max(8, int(_intermediate_budget() // (p * m * 4)))


@partial(jax.jit, donate_argnums=(0,))
def _matmul_accum(out: Array, panels: Array, rows: Array, x_block: Array) -> Array:
    """out (n_pixels, m) += scatter(panels (g, p, S) @ x_block (g, S, m))."""
    contrib = _mm(panels, x_block)                       # (g, p, m)
    return out.at[rows.reshape(-1)].add(contrib.reshape(-1, contrib.shape[-1]))


def _coset_tile(contrib: Array, meta, b1: int, b2: int) -> Array:
    """One coset's (nc1*nc2, b1*b2, m) F-order panel contributions as a
    contiguous (h, w, m) image tile (blocks within a coset are pairwise
    disjoint on a uniform sub-grid; see BlockGrid.cosets)."""
    nc1, nc2, st1, st2, _, _ = meta
    m = contrib.shape[-1]
    # F-order panel row r = i + j*b1 -> (j, i) image axes
    c = contrib.reshape(nc1, nc2, b2, b1, m)
    c = jnp.transpose(c, (0, 3, 1, 2, 4))          # (nc1, b1, nc2, b2, m)
    if st1 > b1 or st2 > b2:
        # odd block sizes: sub-grid stride exceeds the block, pad the gaps
        # (even blocks have st == b and skip the copy)
        c = jnp.pad(c, ((0, 0), (0, st1 - b1), (0, 0), (0, st2 - b2), (0, 0)))
    c = c.reshape(nc1 * st1, nc2 * st2, m)
    h = (nc1 - 1) * st1 + b1
    w = (nc2 - 1) * st2 + b2
    return c[:h, :w]


@partial(jax.jit, static_argnums=(4, 5, 6), donate_argnums=(0,))
def _coset_accum(
    canvas: Array, panels: Array, x_block: Array, idx: Array, meta,
    b1: int, b2: int,
) -> Array:
    """canvas (d1, d2, m) += one coset's placed panel contributions.

    XLA's scatter-add serializes overlapping per-row updates; the coset
    form touches only sequential whole tiles (transpose/reshape/pad/add),
    because blocks within one coset are disjoint. One jit call PER COSET
    with a donated canvas keeps peak transient memory to a single coset's
    chain instead of letting the scheduler hold all cosets' intermediates
    live at once (a fused all-cosets variant ran out of device memory at
    1024^2 alongside a device-resident movie). Not measured on the H100
    against the scatter-add form."""
    d1, d2 = canvas.shape[0], canvas.shape[1]
    a1, a2 = meta[4], meta[5]
    tile = _coset_tile(
        _mm(jnp.take(panels, idx, axis=0), jnp.take(x_block, idx, axis=0)),
        meta, b1, b2,
    )
    h, w = tile.shape[0], tile.shape[1]
    return canvas + jnp.pad(tile, ((a1, d1 - a1 - h), (a2, d2 - a2 - w), (0, 0)))


@partial(jax.jit, static_argnums=(3,), donate_argnums=(0,))
def _flatten_write_cols(out: Array, canvas: Array, s: Array, order: str) -> Array:
    """out[:, s:s+mc] = flatten_fov(canvas) with a donated output buffer
    (no concat spike: the column-chunked matmul would otherwise hold both
    the chunk list and its concatenation alive)."""
    from localmd_tpu.ops.tiling import flatten_fov

    return jax.lax.dynamic_update_slice(
        out, flatten_fov(canvas, order), (jnp.int32(0), s)
    )


# Banded-Gram fast path for ``gram_quadratic`` on REGULAR grids (even
# blocks, exact half-overlap, no snapped tail; see BlockGrid.cell_geometry):
# same-coset blocks are disjoint, so U^T U is block-banded — a block
# overlaps only its <=8 grid neighbors, and every overlap region is a whole
# number of (h1, h2) cells. right^T (U^T U) right then reduces to batched
# (S, S)-class products over blocks and neighbor offsets, with no (d, m)
# canvas, no scatter and no gather. "auto" reads the backend's row of
# localmd_tpu.capabilities.FAST_PATHS (the CPU row keeps the canvas path so
# golden/parity numerics are byte-stable); True/False force it.
BANDED_GRAM = "auto"


def _banded_gram_enabled() -> bool:
    return resolve(BANDED_GRAM, "banded_gram")


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _banded_gram_quad(
    panels: Array, right: Array, bg: Array, rows: Array,
    n1: int, n2: int, h1: int, h2: int,
) -> Array:
    """right^T (U^T U) right via the block-banded Gram structure.

    panels: (g, p, S) with p F-order within the block (i + j*b1);
    right: (g*S + K_bg, m); bg: (d, K_bg) dense background columns;
    rows: (g, p) global pixel ids (used only for the bg coupling gather).
    """
    g, p, s_slots = panels.shape
    m = right.shape[1]
    nb = g * s_slots
    xb = right[:nb].reshape(g, s_slots, m)
    xg = right[nb:]
    # cell split: p -> (b2, b1) = (j, i) -> (jc, jr, ic, ir)
    cells = panels.reshape(n1, n2, 2, h2, 2, h1, s_slots)
    xgrid = xb.reshape(n1, n2, s_slots, m)

    # diagonal: per-block full-panel Gram (same-coset off-diagonals vanish)
    gd = jnp.einsum("gps,gpt->gst", panels, panels,
                    preferred_element_type=jnp.float32)
    y = jnp.einsum("gst,gtm->gsm", gd, xb,
                   preferred_element_type=jnp.float32)
    quad = jnp.einsum("gsm,gsn->mn", xb, y,
                      preferred_element_type=jnp.float32)

    # neighbor terms, one per offset (transpose added once at the end):
    #   dj=+1 : my jc=1 cells vs their jc=0 (overlap = right/left halves)
    #   di=+1 : my ic=1 vs their ic=0
    #   di=+1, dj=+1 : my corner (1, 1) cell vs their (0, 0)
    #   di=+1, dj=-1 : my (jc=0, ic=1) vs their (jc=1, ic=0)
    def pair_term(lhs_cells, rhs_cells, lhs_x, rhs_x):
        if lhs_cells.shape[0] == 0 or lhs_cells.shape[1] == 0:
            # single-row/column grids have no neighbors along this offset
            return jnp.zeros((m, m), jnp.float32)
        lw = lhs_cells.reshape(
            lhs_cells.shape[0], lhs_cells.shape[1], -1, s_slots
        )
        rw = rhs_cells.reshape(
            rhs_cells.shape[0], rhs_cells.shape[1], -1, s_slots
        )
        gq = jnp.einsum("IJps,IJpt->IJst", lw, rw,
                        preferred_element_type=jnp.float32)
        yy = jnp.einsum("IJst,IJtm->IJsm", gq, rhs_x,
                        preferred_element_type=jnp.float32)
        return jnp.einsum("IJsm,IJsn->mn", lhs_x, yy,
                          preferred_element_type=jnp.float32)

    c = cells
    cross = (
        pair_term(c[:, :-1, 1], c[:, 1:, 0], xgrid[:, :-1], xgrid[:, 1:])
        + pair_term(c[:-1, :, :, :, 1], c[1:, :, :, :, 0],
                    xgrid[:-1], xgrid[1:])
        + pair_term(c[:-1, :-1, 1, :, 1], c[1:, 1:, 0, :, 0],
                    xgrid[:-1, :-1], xgrid[1:, 1:])
        + pair_term(c[:-1, 1:, 0, :, 1], c[1:, :-1, 1, :, 0],
                    xgrid[:-1, 1:], xgrid[1:, :-1])
    )
    quad = quad + cross + cross.T

    if bg.shape[1]:
        gathered = jnp.take(bg, rows.reshape(-1), axis=0).reshape(g, p, -1)
        ub = jnp.einsum("gps,gpk->gsk", panels, gathered,
                        preferred_element_type=jnp.float32).reshape(nb, -1)
        cb = _mm(_mm(right[:nb].T, ub), xg)
        quad = quad + cb + cb.T + _mm(xg.T, _mm(_mm(bg.T, bg), xg))
    return 0.5 * (quad + quad.T)


# Coset-view V-projection fast path: V = P^T (U~^T X) computed by
# contracting block pixels against coset VIEWS of each raw (t, d1, d2)
# chunk — a reshape, not a gather — so the (d, r') dense canvas a = U @ P
# of the folded-projector path never exists. Regular grids only
# (BlockGrid.cell_geometry). Same flag semantics as BANDED_GRAM.
COSET_VPROJ = "auto"


def _coset_vproj_enabled() -> bool:
    return resolve(COSET_VPROJ, "coset_vproj")


def coset_vproj_eligible(u) -> bool:
    """Whether :meth:`PMDLoader.v_projection` will route through the coset
    chunk kernel for this spatial matrix. Shared by the dispatch site and
    the pipeline's stage warmer (mirror discipline: see aot.py)."""
    return (
        isinstance(u, BlockSparseMatrix)
        and u.cell_geom is not None
        and _coset_vproj_enabled()
    )


@partial(jax.jit, static_argnums=(2, 3, 4))
def build_vproj_cells(
    panels: Array, rows: Array, fov: Tuple[int, int], order: str,
    geom: Tuple[int, int, int, int],
    bg: Array, std_flat: Array, mean_flat: Array,
):
    """One-time per-``v_projection`` operand build for the cell chunk
    kernel: the std-folded panels and background basis PACKED into one
    per-cell matrix ``m_cell`` (nc1, nc2, h1*h2, 4*S + K_bg), plus the
    mean-correction vector ``q = U~^T mean`` (the mixing matrix folds in
    per chunk — it does not exist yet when this is dispatched).

    Needs nothing from the factorized-SVD chain, so the pipeline fires it
    right after U is assembled: the build then overlaps the
    blocking counts pull and the projector chain instead of sitting on the
    V-regression critical path.

    Cell packing: on the regular grid every (h1, h2) cell is covered by
    exactly 4 blocks (one per corner role (a, b)); stacking those panel
    slices — and the background columns — along one 4*S + K_bg axis lets
    the whole U~^T X contract as ONE canonical batched dot per chunk
    instead of four strided coset-view dots."""
    from localmd_tpu.ops.tiling import unflatten_fov

    d1, d2 = fov
    n1, n2, h1, h2 = geom
    nc1, nc2 = n1 + 1, n2 + 1
    g, pp, s_slots = panels.shape
    k_bg = bg.shape[1]
    inv_std = (1.0 / std_flat)[rows]                       # (g, p)
    pan_t = panels * inv_std[:, :, None]
    # panel p-axis is F-order within the block (i + j*b1): split
    # (b2, b1) = (j, i) into cells (jc, jr, ic, ir)
    pan6 = pan_t.reshape(n1, n2, 2, h2, 2, h1, s_slots)
    # slab-per-corner, edge-padded to the cell grid, then ONE concat along
    # the packed axis: interior ``.at[slice].set`` writes lower to
    # scatters, pad+concat to plain copies
    slabs = []
    for a in (0, 1):            # corner along dim1 (i)
        for b in (0, 1):        # corner along dim2 (j)
            part = pan6[:, :, b, :, a, :, :]               # (n1,n2,jr,ir,S)
            part = jnp.swapaxes(part, 2, 3)                # (n1,n2,ir,jr,S)
            part = part.reshape(n1, n2, h1 * h2, s_slots)
            slabs.append(
                jnp.pad(part, ((a, 1 - a), (b, 1 - b), (0, 0), (0, 0)))
            )
    if k_bg:
        bg_img = unflatten_fov(bg / std_flat[:, None], d1, d2, order)
        bg_cells = bg_img.reshape(nc1, h1, nc2, h2, k_bg)
        bg_cells = jnp.swapaxes(bg_cells, 1, 2).reshape(
            nc1, nc2, h1 * h2, k_bg
        )
        slabs.append(bg_cells)
    m_cell = jnp.concatenate(slabs, axis=-1)
    q_blocks = jnp.einsum(
        "gps,gp->gs", pan_t, mean_flat[rows],
        preferred_element_type=jnp.float32,
    ).reshape(-1)
    q_bg = _mm(bg.T, (mean_flat / std_flat)[:, None])[:, 0]
    q = jnp.concatenate([q_blocks, q_bg])
    return m_cell, q


@partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def coset_vproj_chunk(
    m_cell: Array, q: Array, p: Array, raw: Array,
    n1: int, n2: int, h1: int, h2: int, s_slots: int,
) -> Array:
    """V columns of one raw (t, d1, d2) chunk: P^T (U~^T X) - P^T q.

    One space-to-depth reshape of the chunk into (cell, pixel, t) layout,
    one canonical batched dot against the packed per-cell panel matrix
    (blocks' 4 corner roles + background columns share the contraction),
    then corner-slice adds to reassemble per-block rows. No patch gather,
    no (d, r') canvas, no strided dot operands."""
    t = raw.shape[0]
    nc1, nc2 = n1 + 1, n2 + 1
    x = raw.astype(jnp.float32).reshape(t, nc1, h1, nc2, h2)
    xc = jnp.transpose(x, (1, 3, 2, 4, 0)).reshape(nc1, nc2, h1 * h2, t)
    y = jax.lax.dot_general(
        m_cell, xc, (((2,), (2,)), ((0, 1), (0, 1))),
        preferred_element_type=jnp.float32,
    )                                                      # (nc1,nc2,CK,t)
    s = s_slots
    # block (g1, g2)'s corner (a, b) contribution lives at cell
    # (g1 + a, g2 + b), slot band (2a + b) * S
    w = (
        y[0:n1, 0:n2, 0 * s : 1 * s]
        + y[0:n1, 1:, 1 * s : 2 * s]
        + y[1:, 0:n2, 2 * s : 3 * s]
        + y[1:, 1:, 3 * s : 4 * s]
    )
    w_blocks = w.reshape(n1 * n2 * s, t)
    if m_cell.shape[-1] > 4 * s:
        w_bg = jnp.sum(y[:, :, 4 * s :, :], axis=(0, 1))   # (K_bg, t)
        w_full = jnp.concatenate([w_blocks, w_bg], axis=0)
    else:
        w_full = w_blocks
    pq = _mm(p.T, q[:, None])                              # (r', 1) tiny
    return _mm(p.T, w_full) - pq


@jax.jit
def _rmatmul_group(panels: Array, rows: Array, y: Array) -> Array:
    """(n_pixels, m) -> (g, S, m) via gather + batched panel^T matmul."""
    gathered = y[rows]                                   # (g, p, m)
    return _mm(jnp.swapaxes(panels, -1, -2), gathered)   # (g, S, m)


@dataclass
class BlockSparseMatrix:
    """U = [block panels | dense background basis], shape (n_pixels, R).

    R = n_blocks * slots + dense_basis.shape[1]. Column j of block b lives at
    global index b * slots + j; background columns follow at the end
    (mirroring the reference's ``hstack([u, spatial_bg])``,
    decomposition.py:929-930).
    """

    panels: Array            # (n_blocks, p, S) float32
    rows: Array              # (n_blocks, p) int32 global pixel ids
    n_pixels: int
    dense_basis: Array       # (n_pixels, K) float32 (background; K >= 0)
    # Optional geometry (set by the pipeline): block offsets and (b1, b2)
    # block shape, used by ROI slicing to bound its canvas.
    starts: Optional[Array] = None
    block_shape: Optional[Tuple[int, int]] = None
    # Optional coset placement info (BlockGrid.coset_info()): routes
    # ``matmul``'s overlap-add through disjoint-coset pad/transpose/reshape
    # instead of an XLA scatter-add.
    coset_info: Optional[tuple] = None
    # Optional regular-grid cell geometry (BlockGrid.cell_geometry()):
    # (n1, n2, h1, h2) enables the banded-Gram fast path of
    # ``gram_quadratic``. None disables it (irregular grids, manual tests).
    cell_geom: Optional[Tuple[int, int, int, int]] = None

    @property
    def n_blocks(self) -> int:
        return self.panels.shape[0]

    @property
    def slots(self) -> int:
        return self.panels.shape[2]

    @property
    def n_block_cols(self) -> int:
        return self.n_blocks * self.slots

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_pixels, self.n_block_cols + self.dense_basis.shape[1])

    # -- products -----------------------------------------------------------

    def matmul(self, x: Array) -> Array:
        """U @ x for x of shape (R, m) -> (n_pixels, m). The block axis is
        chunked so the (g, p, m) intermediate stays within budget; the
        accumulator buffer is donated between chunks (no copies)."""
        x = jnp.asarray(x)
        nb = self.n_block_cols
        m = x.shape[-1]
        x_block = x[:nb].reshape(self.n_blocks, self.slots, m)
        if self.coset_info is not None and self.block_shape is not None:
            idxs, metas, d1, d2, order, _ = self.coset_info
            b1, b2 = self.block_shape
            # chunk COLUMNS so one chunk's canvas + single-coset transients
            # (~4 FOV-column-chunk-sized buffers) stay within budget
            mc = max(
                32, int(_intermediate_budget() // (self.n_pixels * 4 * 4))
            )

            def accumulate_canvas(x_cols: Array) -> Array:
                canvas = jnp.zeros((d1, d2, x_cols.shape[-1]), jnp.float32)
                for idx, meta in zip(idxs, metas):
                    canvas = _coset_accum(
                        canvas, self.panels, x_cols, idx, meta, b1, b2
                    )
                return canvas

            if m <= mc:
                from localmd_tpu.ops.tiling import flatten_fov

                out = flatten_fov(accumulate_canvas(x_block), order)
            else:
                out = jnp.zeros((self.n_pixels, m), dtype=jnp.float32)
                for s in range(0, m, mc):
                    out = _flatten_write_cols(
                        out,
                        accumulate_canvas(x_block[:, :, s : s + mc]),
                        jnp.int32(s),
                        order,
                    )
            if self.dense_basis.shape[1]:
                out = out + _mm(self.dense_basis, x[nb:])
            return out
        g = _block_group_size(self.panels.shape[1], m)
        out = jnp.zeros((self.n_pixels, m), dtype=jnp.float32)
        if g >= self.n_blocks:
            out = _matmul_accum(out, self.panels, self.rows, x_block)
        else:
            n_pad = ((self.n_blocks + g - 1) // g) * g
            for s in range(0, n_pad, g):
                e = min(s + g, self.n_blocks)
                if e - s < g:
                    # pad the tail group with zero panels (scatter of zeros
                    # into row 0 is harmless) to keep one compiled shape
                    pad = g - (e - s)
                    panels_g = jnp.concatenate(
                        [self.panels[s:e], jnp.zeros((pad,) + self.panels.shape[1:],
                                                     self.panels.dtype)], axis=0)
                    rows_g = jnp.concatenate(
                        [self.rows[s:e], jnp.zeros((pad, self.rows.shape[1]),
                                                   self.rows.dtype)], axis=0)
                    x_g = jnp.concatenate(
                        [x_block[s:e], jnp.zeros((pad, self.slots, m), x.dtype)],
                        axis=0)
                else:
                    panels_g, rows_g, x_g = (
                        self.panels[s:e], self.rows[s:e], x_block[s:e]
                    )
                out = _matmul_accum(out, panels_g, rows_g, x_g)
        if self.dense_basis.shape[1]:
            out = out + _mm(self.dense_basis, x[nb:])
        return out

    def rmatmul(self, y: Array) -> Array:
        """U.T @ y for y of shape (n_pixels, m) -> (R, m), block-chunked to
        bound the (g, p, m) gather intermediate.

        Stays on the gather path: reads do not pay the serialization
        penalty that scatter-add writes do, so the coset slice/transpose
        extraction (inverse of ``matmul``'s placement) has nothing to win
        here. Not measured on the H100."""
        y = jnp.asarray(y)
        m = y.shape[-1]
        g = _block_group_size(self.panels.shape[1], m)
        if g >= self.n_blocks:
            block_part = _rmatmul_group(self.panels, self.rows, y)
            block_part = block_part.reshape(self.n_block_cols, -1)
        else:
            parts = []
            n_pad = ((self.n_blocks + g - 1) // g) * g
            for s in range(0, n_pad, g):
                e = min(s + g, self.n_blocks)
                if e - s < g:
                    pad = g - (e - s)
                    panels_g = jnp.concatenate(
                        [self.panels[s:e], jnp.zeros((pad,) + self.panels.shape[1:],
                                                     self.panels.dtype)], axis=0)
                    rows_g = jnp.concatenate(
                        [self.rows[s:e], jnp.zeros((pad, self.rows.shape[1]),
                                                   self.rows.dtype)], axis=0)
                    parts.append(
                        _rmatmul_group(panels_g, rows_g, y)[: e - s]
                    )
                else:
                    parts.append(
                        _rmatmul_group(self.panels[s:e], self.rows[s:e], y)
                    )
            block_part = jnp.concatenate(parts, axis=0).reshape(
                self.n_block_cols, -1
            )
        if self.dense_basis.shape[1]:
            bg_part = _mm(self.dense_basis.T, y)
            return jnp.concatenate([block_part, bg_part], axis=0)
        return block_part

    def gram_matmul(self, x: Array, col_chunk: Optional[int] = None) -> Array:
        """(U.T U) @ x without forming the Gram matrix; optionally chunked
        over columns of x to bound the (n_pixels, chunk) intermediate."""
        m = x.shape[1]
        if col_chunk is None or m <= col_chunk:
            return self.rmatmul(self.matmul(x))
        outs = []
        for s in range(0, m, col_chunk):
            outs.append(self.rmatmul(self.matmul(x[:, s : s + col_chunk])))
        return jnp.concatenate(outs, axis=1)

    def banded_gram_ready(self, m: int) -> bool:
        """Whether ``gram_quadratic`` at ``m`` right-hand columns will take
        the banded fast path. Shared with the pipeline's stage warmer so the
        warmed program and the dispatched program cannot drift."""
        if self.cell_geom is None or not _banded_gram_enabled():
            return False
        # transient bound: the (g, S, m)-class einsum intermediates plus
        # the (g, p, K_bg) background gather
        k_bg = self.dense_basis.shape[1]
        need = 4 * (
            3 * self.n_block_cols * m
            + self.n_blocks * self.panels.shape[1] * max(k_bg, 1)
        )
        return need <= _intermediate_budget()

    def gram_quadratic(self, right: Array, col_chunk: Optional[int] = None) -> Array:
        """Symmetrized right.T (U.T U) right, shape (m, m).

        Computed as Z^T Z with Z = U @ right when the (n_pixels, m) canvas
        fits one pass: mathematically identical to right^T (U^T (U right)),
        but skips the rmatmul re-gather of the canvas back to panel rows.
        Column-chunked calls (m > col_chunk, the no-prune long-T regime)
        keep the gram_matmul form, whose per-chunk intermediates stay
        (n_pixels, col_chunk) without needing cross-chunk Z products.
        """
        m = right.shape[1]
        if self.banded_gram_ready(m):
            return _banded_gram_quad(
                self.panels, jnp.asarray(right), self.dense_basis,
                self.rows, *self.cell_geom,
            )
        if col_chunk is None or m <= col_chunk:
            z = self.matmul(right)
            g = _mm(z.T, z)
        else:
            g = _mm(right.T, self.gram_matmul(right, col_chunk=col_chunk))
        return 0.5 * (g + g.T)

    # -- export / import ------------------------------------------------------

    def to_csr(self, counts: np.ndarray) -> Tuple[scipy.sparse.csr_matrix, np.ndarray]:
        """Compact to a scipy CSR matrix, dropping unused slots.

        ``counts``: (n_blocks,) kept components per block. Returns the CSR
        matrix of shape (n_pixels, sum(counts) + K) and the map from compacted
        column id -> padded global column id (for compacting R alongside).
        """
        counts = np.asarray(counts, dtype=np.int64)
        panels = np.asarray(self.panels)
        rows = np.asarray(self.rows)
        col_map = []
        data_parts, row_parts, col_parts = [], [], []
        col_cursor = 0
        for b in range(self.n_blocks):
            c = int(counts[b])
            if c == 0:
                continue
            panel = panels[b, :, :c]                    # (p, c)
            r = np.repeat(rows[b], c)
            cols = np.tile(np.arange(col_cursor, col_cursor + c), panels.shape[1])
            data_parts.append(panel.reshape(-1))
            row_parts.append(r)
            col_parts.append(cols)
            col_map.extend(b * self.slots + j for j in range(c))
            col_cursor += c
        k_bg = int(self.dense_basis.shape[1])
        n_cols = col_cursor + k_bg
        if data_parts:
            coo = scipy.sparse.coo_matrix(
                (
                    np.concatenate(data_parts),
                    (np.concatenate(row_parts), np.concatenate(col_parts)),
                ),
                shape=(self.n_pixels, col_cursor),
            )
        else:
            coo = scipy.sparse.coo_matrix((self.n_pixels, 0))
        if k_bg:
            bg = scipy.sparse.coo_matrix(np.asarray(self.dense_basis))
            full = scipy.sparse.hstack([coo, bg]).tocsr()
            col_map.extend(self.n_block_cols + j for j in range(k_bg))
        else:
            full = coo.tocsr()
        return full, np.asarray(col_map, dtype=np.int64)
